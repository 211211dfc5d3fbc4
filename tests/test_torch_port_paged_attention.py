"""Port parity: the fused paged-attention decode op.

``horovod_tpu_torch.ops.paged_attention`` against the JAX package's
``paged_attention_decode`` on the same numpy-seeded inputs.  The JAX side
runs its Pallas kernel in interpret mode with the per-block reduction
order pinned (``HOROVOD_PAGED_ATTN_IMPL=pallas``,
``HOROVOD_PAGED_ATTN_CHUNK=1``), as its own tests do; the port's CPU
tensors take its plain version, which reads the same variable and walks
the table in the kernel's order.  Its default, one pass over the whole
table, and a ragged walk are held against the JAX package's blockwise
XLA stand-in under the same ``HOROVOD_PAGED_ATTN_CHUNK`` and against the
walk.  The CUDA kernel itself is held against
the plain version on the card in ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops.paged_attention import \
    paged_attention_decode as jax_paged_attention_decode
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import paged_attention as pa

#: The reference's ops-level fp32 contract of the fused path
#: (tests/test_serve.py): within 1e-4 of dense attention.
FUSED_TOL = 1e-4
#: Port plain version vs the JAX Pallas kernel, fp32, same per-block
#: online-softmax order: only the dot products' summation order differs.
PARITY_ATOL = 1e-6


def _case(G, seed, *, B=5, Hkv=2, D=16, NB=12, BS=8, maxb=4,
          dtype=np.float32):
    """Random q/pools, distinct live blocks per row, positions that
    straddle block edges, and one padded (trash) row."""
    rng = np.random.default_rng(seed)
    Hq = Hkv * G
    q = rng.standard_normal((B, 1, Hq, D)).astype(dtype)
    pool_k = rng.standard_normal((NB, BS, Hkv, D)).astype(dtype)
    pool_v = rng.standard_normal((NB, BS, Hkv, D)).astype(dtype)
    tables = np.zeros((B, maxb), np.int32)
    pos = np.zeros((B,), np.int32)
    live_pos = [5, 7, 8, 26, 31, 15, 16]
    for i in range(B - 1):          # the last row stays trash: pos 0
        pos[i] = live_pos[i % len(live_pos)]
        nblk = pos[i] // BS + 1
        tables[i, :nblk] = rng.permutation(np.arange(1, NB))[:nblk]
    return q, pool_k, pool_v, tables, pos


def _dense_reference(q, pool_k, pool_v, tables, pos):
    """Gather each row's K/V and run plain masked attention in numpy."""
    B, _, Hq, D = q.shape
    Hkv = pool_k.shape[2]
    G = Hq // Hkv
    out = np.zeros((B, Hq, D), np.float64)
    for i in range(B):
        ks = pool_k[tables[i]].reshape(-1, Hkv, D)[:pos[i] + 1]
        vs = pool_v[tables[i]].reshape(-1, Hkv, D)[:pos[i] + 1]
        qi = q[i, 0].reshape(Hkv, G, D).astype(np.float64)
        s = np.einsum("hgd,khd->hgk", qi, ks) / np.sqrt(D)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out[i] = np.einsum("hgk,khd->hgd", p, vs).reshape(Hq, D)
    return out


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_matches_jax_pallas_kernel_and_dense(monkeypatch, G):
    q, pk, pv, tables, pos = _case(G, seed=10 + G)
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_CHUNK", "1")
    ref = np.asarray(jax_paged_attention_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(pos)))
    got = pa.paged_attention_decode(*_torch(q, pk, pv, tables, pos)).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=PARITY_ATOL)
    dense = _dense_reference(q, pk, pv, tables, pos)
    for out in (got, ref):
        np.testing.assert_allclose(out[:, 0], dense, rtol=0, atol=FUSED_TOL)
    assert pa.launches == 0          # CPU tensors never launch the kernel


def test_plain_bf16_rounds_like_the_reference(monkeypatch):
    """bf16 q/pools: the plain version and the JAX kernel both round the
    probabilities to bf16 before the PV product and return bf16; they
    agree within one bf16 ULP of max(1, |out|)."""
    q, pk, pv, tables, pos = _case(4, seed=3)
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_CHUNK", "1")
    ref = np.asarray(jax_paged_attention_decode(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, pk, pv)),
        jnp.asarray(tables), jnp.asarray(pos)), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, pk, pv))
    got = pa.paged_attention_decode(tq, tk, tv, *_torch(tables, pos))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.maximum(1.0,
                                                              np.abs(ref)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", ["", "3"])
def test_default_pass_matches_the_jax_package(monkeypatch, chunk, dtype):
    """The default pass (the whole table at once) and a ragged walk of 3
    columns a step against the JAX package's stand-in under the same
    ``HOROVOD_PAGED_ATTN_CHUNK`` (its blockwise XLA path, the off-TPU
    default): fp32 within ``PARITY_ATOL``, bf16 within one bf16 ULP of
    max(1, |out|)."""
    arrays = _case(4, seed=33)
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_IMPL", "xla")
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_CHUNK", chunk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_paged_attention_decode(
        *(jnp.asarray(a, jdt) for a in arrays[:3]),
        *(jnp.asarray(a) for a in arrays[3:])), np.float32)
    q, pk, pv, tables, pos = _torch(*arrays)
    got = pa.paged_attention_decode(q.to(tdt), pk.to(tdt), pv.to(tdt),
                                    tables, pos)
    assert got.shape == q.shape and got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARITY_ATOL)
    else:
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.maximum(
            1.0, np.abs(ref)))
    assert pa.launches == 0


@pytest.mark.parametrize("chunk", ["", "3"])
def test_default_pass_matches_the_walk(monkeypatch, chunk):
    """The default (one pass over the whole table) and a ragged walk of 3
    columns a step (its tail padded with trash block 0) equal the
    per-block walk within the reference's fp32 bound of the fused path
    (1e-4)."""
    args = _torch(*_case(4, seed=21))
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_CHUNK", "1")
    walk = pa.paged_attention_decode(*args)
    monkeypatch.setenv("HOROVOD_PAGED_ATTN_CHUNK", chunk)
    got = pa.paged_attention_decode(*args)
    assert got.shape == walk.shape and got.dtype == walk.dtype
    np.testing.assert_allclose(got.numpy(), walk.numpy(), rtol=0,
                               atol=FUSED_TOL)
    assert pa.launches == 0


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    """The device decides: a tensor off the CPU goes to the CUDA kernel's
    wrapper, which raises on what it cannot run — never to the plain
    version."""
    def plain(*args):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(pa, "_decode_blockwise", plain)
    q, pk, pv, tables, pos = _torch(*_case(2, seed=1))
    meta = [t.to("meta") for t in (q, pk, pv, tables, pos)]
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_decode(*meta)
    assert pa.launches == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing toolchain is an error naming nvcc, not a fallback."""
    assert "paged_attention" in _build.sources()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["paged_attention"])
    with pytest.raises(KeyError):
        _build.build(["no_such_kernel"])
