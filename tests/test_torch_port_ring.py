"""Port parity: ring attention, Ulysses and the ragged allgather
(``parallel/ring_attention.py``, ``ops/ragged.py``).

The port on 2 and 4 gloo ranks (this file run as a script per rank,
``_rank_main``) against ``horovod_tpu.parallel.ring_attention`` under
``shard_map`` on the conftest's CPU mesh of the same size, on the inputs
of ``tests/test_ring_attention.py`` (``_rand_qkv``), fp32; outputs within
2e-5 and the gradients of ``sum(out²)`` within 5e-5 (that file's
tolerances):

* the ring, causal (a hop whose KV shard comes after the query shard is
  killed by an lse of -inf: no NaN, no gradient) and not; Ulysses;
* the dense blockwise hop where the reference takes it too (a KV shard
  longer than the query shard), counted by ``fallback_count()`` and
  warned once;
* the flash ring at the reference's flash shapes (S_loc 128, D 64)
  against dense causal attention (2e-4, gradients 2e-3: that test's);
* ``ragged_allgather`` and ``compact`` against the reference's.

In one process: the hop merge (``merge_hops``) against attention over the
union of the two key sets, and a killed hop's zero cotangents.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL, GRAD_TOL = 2e-5, 5e-5
FLASH_OUT_TOL, FLASH_GRAD_TOL = 2e-4, 2e-3
FALLBACK = "ring attention hop uses the dense online-softmax path"

# name: (kind, shape kwargs of _rand_qkv, causal, seed)
CASES = {
    "ring_causal": ("ring", dict(), True, 0),
    "ring_noncausal": ("ring", dict(H=4, Hkv=4), False, 1),
    "ulysses": ("ulysses", dict(H=8, Hkv=4), True, 2),
    "ring_long_kv": ("ring", dict(B=1, S=32, H=4, Hkv=2, D=8), True, 3),
    "ring_flash": ("ring", dict(B=1, S=None, H=4, Hkv=2, D=64), True, 11),
}


def _shape(kw, n):
    kw = dict(dict(B=2, S=32, H=8, Hkv=4, D=16), **kw)
    if kw["S"] is None:
        kw["S"] = 128 * n
    return kw


def _rand_qkv(n, kw, seed, long_kv=False):
    """``tests/test_ring_attention.py``'s inputs as numpy; with
    ``long_kv`` k and v twice as long as q."""
    import jax

    kw = _shape(kw, n)
    ks = jax.random.split(jax.random.key(seed), 3)
    B, S, H, Hkv, D = kw["B"], kw["S"], kw["H"], kw["Hkv"], kw["D"]
    Sk = 2 * S if long_kv else S
    q = jax.random.normal(ks[0], (B, S, H, D), np.float32)
    k = jax.random.normal(ks[1], (B, Sk, Hkv, D), np.float32)
    v = jax.random.normal(ks[2], (B, Sk, Hkv, D), np.float32)
    return [np.asarray(t) for t in (q, k, v)]


def _rank_main(src: str, dst: str) -> None:
    """One rank: every case on a ``seq`` mesh of the whole world (this
    rank's shards of q, k, v), then the ragged allgather on a ``data``
    mesh.  OUT: each case's output shard and gradient shards, the fallback
    count it moved and the warnings it raised; the ragged results."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops.ragged import (bucket_rows, compact,
                                              pad_rows, ragged_allgather)
    from horovod_tpu_torch.parallel.ring_attention import (ring_attention,
                                                           ulysses_attention)

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    data = np.load(src)
    out = {}
    mesh = hvd.build_mesh({"seq": n})
    for name, (kind, _, causal, _) in CASES.items():
        shards = []
        for t in "qkv":
            full = torch.from_numpy(data[f"{name}.{t}"])
            step = full.shape[1] // n
            shards.append(full[:, r * step:(r + 1) * step].clone()
                          .requires_grad_(True))
        fn = ring_attention if kind == "ring" else ulysses_attention
        before = fa.fallback_count()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with hvd.use_mesh(mesh):
                o = fn(*shards, axis_name="seq", causal=causal)
                o2 = fn(*shards, axis_name="seq", causal=causal)
        (o ** 2).sum().backward()
        out[name + ".out"] = o.detach().numpy()
        out[name + ".same_twice"] = np.array(torch.equal(o, o2))
        for t, s in zip("qkv", shards):
            out[f"{name}.d{t}"] = s.grad.numpy()
        out[name + ".fallbacks"] = np.array(fa.fallback_count() - before)
        out[name + ".warnings"] = np.array(
            sum(FALLBACK in str(w.message) for w in caught))
    # ragged: rank r has r + 3 rows
    data_mesh = hvd.build_mesh({"data": n})
    rows = np.arange((r + 3) * 4, dtype=np.float32).reshape(r + 3, 4) + r
    padded, valid = pad_rows(rows, bucket_rows(n + 2))
    gathered, sizes = ragged_allgather(torch.from_numpy(padded), valid,
                                       axis_name="data", mesh=data_mesh)
    out["ragged.gathered"] = gathered.numpy()
    out["ragged.sizes"] = sizes.numpy()
    out["ragged.compact"] = compact(gathered, sizes)
    np.savez(dst.format(rank=hvd.rank()), **out)
    assert "jax" not in sys.modules
    hvd.shutdown()


def _reference(n, name, q, k, v):
    """The reference's output and the gradients of sum(out²) under
    shard_map on ``n`` devices (the dense causal attention for
    ``ring_flash``, as its own test holds it)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.models.llama import causal_attention
    from horovod_tpu.parallel.ring_attention import (ring_attention,
                                                     ulysses_attention)

    kind, _, causal, _ = CASES[name]
    if name == "ring_flash":
        def loss(q, k, v):
            return jnp.sum(causal_attention(q, k, v) ** 2)
        out = causal_attention(q, k, v)
        return [np.asarray(t) for t in
                (out, *jax.grad(loss, argnums=(0, 1, 2))(q, k, v))]
    fn = functools.partial(ring_attention if kind == "ring"
                           else ulysses_attention, axis_name="seq",
                           causal=causal)
    mesh = build_mesh({"seq": n}, devices=jax.devices()[:n])
    spec = P(None, "seq", None, None)

    def sharded(f, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 3,
                                     out_specs=outs, check_vma=False))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) ** 2)
    out = sharded(fn, spec)(q, k, v)
    grads = sharded(jax.grad(loss, argnums=(0, 1, 2)), (spec,) * 3)(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


def _ragged_reference(n):
    import jax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.ops.ragged import (bucket_rows, compact, pad_rows,
                                        ragged_allgather)

    cap = bucket_rows(n + 2)
    blocks, counts = [], []
    for r in range(n):
        rows = np.arange((r + 3) * 4, dtype=np.float32).reshape(r + 3, 4) + r
        padded, valid = pad_rows(rows, cap)
        blocks.append(padded)
        counts.append(valid)
    mesh = build_mesh({"data": n}, devices=jax.devices()[:n])
    fn = jax.jit(jax.shard_map(
        lambda x, c: ragged_allgather(x, c[0], axis_name="data"), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=(P(), P()),
        check_vma=False))
    gathered, sizes = fn(np.concatenate(blocks),
                         np.asarray(counts, np.int32))
    return np.asarray(gathered), np.asarray(sizes), compact(gathered, sizes)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of 2 and 4 ranks started together; the references computed
    while they run.  {n: (inputs, references, [rank outputs])}."""
    from test_torch_port_parallel_step import rank_world

    tmp = tmp_path_factory.mktemp("ring")
    inputs, worlds = {}, {}
    for n in (2, 4):
        inputs[n] = {name: _rand_qkv(n, kw, seed, name == "ring_long_kv")
                     for name, (_, kw, _, seed) in CASES.items()}
        np.savez(tmp / f"in{n}.npz", **{f"{name}.{t}": a for name, qkv in
                                        inputs[n].items()
                                        for t, a in zip("qkv", qkv)})
        worlds[n] = rank_world(__file__, n, str(tmp / f"in{n}.npz"),
                               str(tmp / f"out{n}_{{rank}}.npz"))
    with worlds[2], worlds[4]:
        refs = {n: {name: _reference(n, name, *inputs[n][name])
                    for name in CASES} for n in (2, 4)}
        for n in (2, 4):
            refs[n]["ragged"] = _ragged_reference(n)
        results = {}
        for n in (2, 4):
            worlds[n].wait(timeout_s=240)
            results[n] = [np.load(tmp / f"out{n}_{r}.npz") for r in range(n)]
    return {n: (inputs[n], refs[n], results[n]) for n in (2, 4)}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_attention_matches_the_reference(worlds, n, name):
    _, refs, ranks = worlds[n]
    out_tol, grad_tol = ((FLASH_OUT_TOL, FLASH_GRAD_TOL)
                         if name == "ring_flash" else (OUT_TOL, GRAD_TOL))
    got = [np.concatenate([rk[f"{name}.{t}"] for rk in ranks], axis=1)
           for t in ("out", "dq", "dk", "dv")]
    for g, want, t in zip(got, refs[name], ("out", "dq", "dk", "dv")):
        assert np.isfinite(g).all(), t          # killed hops give no NaN
        tol = out_tol if t == "out" else grad_tol
        np.testing.assert_allclose(g, want, atol=tol, rtol=tol,
                                   err_msg=f"{name} {t}")
    assert all(bool(rk[name + ".same_twice"]) for rk in ranks)


@pytest.mark.parametrize("n", [2, 4])
def test_only_the_long_kv_ring_falls_back_and_warns_once(worlds, n):
    _, _, ranks = worlds[n]
    for rk in ranks:
        for name in CASES:
            want = 2 if name == "ring_long_kv" else 0   # two calls each
            assert int(rk[name + ".fallbacks"]) == want, name
            assert int(rk[name + ".warnings"]) == min(want, 1), name


@pytest.mark.parametrize("n", [2, 4])
def test_ragged_allgather_matches_the_reference(worlds, n):
    _, refs, ranks = worlds[n]
    gathered, sizes, compacted = refs["ragged"]
    for rk in ranks:
        np.testing.assert_array_equal(rk["ragged.gathered"], gathered)
        np.testing.assert_array_equal(rk["ragged.sizes"], sizes)
        np.testing.assert_array_equal(rk["ragged.compact"], compacted)


def test_ragged_host_helpers_match_the_reference():
    from horovod_tpu.ops import ragged as jr
    from horovod_tpu_torch.ops import ragged as tr

    for n in (0, 1, 8, 9, 100, 1024, 1025):
        assert tr.bucket_rows(n) == jr.bucket_rows(n)
        assert tr.bucket_rows(n, min_bucket=2) == jr.bucket_rows(
            n, min_bucket=2)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for a, b in zip(tr.pad_rows(x, 8), jr.pad_rows(x, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceed the bucket capacity"):
        tr.pad_rows(x, 4)


def _attention_parts(seed=0, B=1, S=24, H=4, D=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g)
    k = torch.randn(B, 2 * S, H, D, generator=g)
    v = torch.randn(B, 2 * S, H, D, generator=g)
    return q, k, v


def test_hop_merge_equals_attention_over_both_key_sets():
    from horovod_tpu_torch.models.llama import attend
    from horovod_tpu_torch.ops.flash_attention import flash_attention_lse
    from horovod_tpu_torch.parallel.ring_attention import merge_hops

    q, k, v = _attention_parts()
    S = q.shape[1]
    oa, la = flash_attention_lse(q, k[:, :S], v[:, :S], causal=False)
    ob, lb = flash_attention_lse(q, k[:, S:], v[:, S:], causal=False)
    got, lse = merge_hops(oa, la, ob, lb)
    want = attend(q, k, v, torch.ones(1, 1, 1, S, 2 * S, dtype=torch.bool))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=1e-5,
                               atol=1e-5)


def test_a_killed_hop_adds_nothing_and_takes_no_gradient():
    from horovod_tpu_torch.ops.flash_attention import flash_attention_lse
    from horovod_tpu_torch.parallel.ring_attention import merge_hops

    q, k, v = _attention_parts(seed=1)
    S = q.shape[1]
    oa, la = flash_attention_lse(q, k[:, :S], v[:, :S], causal=True)
    ob = torch.randn(oa.shape).requires_grad_(True)
    lb = torch.full(la.shape, float("-inf")).requires_grad_(True)
    out, lse = merge_hops(oa.detach(), la.detach(), ob, lb)
    assert torch.equal(out, oa.detach()) and torch.equal(lse, la.detach())
    (out.sum() + lse.sum()).backward()
    assert torch.equal(ob.grad, torch.zeros_like(ob))
    assert torch.equal(lb.grad, torch.zeros_like(lb))


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
