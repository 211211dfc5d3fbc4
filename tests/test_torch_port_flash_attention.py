"""Port parity: flash attention forward and backward.

The port's ``ops/flash_attention.py`` (its plain versions: the tensors
lie on the CPU) against the JAX package's Pallas kernels, run in
interpret mode as the JAX package's own tests run them on the CPU.  The
same numpy-seeded inputs and cotangents go to both; the tolerances are
the reference's own (tests/test_flash_attention.py): fp32 out and lse
2e-5, fp32 grads 5e-4, bf16 3e-2.  Only the summation order differs
(the port walks 64-key tiles, the reference up to 512), and in bf16 the
kernels round P and dS at the same points.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": (2e-5, 5e-4), "bfloat16": (3e-2, 3e-2)}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, S, Hq, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D),
              (B, Hq, S)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = _DT[dtype]
    j = [jnp.asarray(a, jdt) for a in arrs[:4]] + [jnp.asarray(arrs[4])]
    t = [torch.from_numpy(a).to(tdt) for a in arrs[:4]] + \
        [torch.from_numpy(arrs[4])]
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _torch_grads(fn, q, k, v, loss):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    loss(out).backward()
    return out, (q.grad, k.grad, v.grad)


CASES = [
    # (B, S, Hq, Hkv, D, causal, dtype)
    (2, 256, 8, 2, 64, True, "float32"),
    (1, 384, 8, 2, 64, False, "float32"),
    (1, 200, 8, 2, 64, True, "float32"),
    (1, 200, 4, 2, 16, False, "float32"),
    (1, 256, 8, 2, 16, True, "float32"),
    (2, 256, 8, 2, 64, True, "bfloat16"),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,dtype", CASES)
def test_out_and_grads_match_jax(B, S, Hq, Hkv, D, causal, dtype):
    (jq, jk, jv, jg, _), (tq, tk, tv, tg, _) = _inputs(
        B, S, Hq, Hkv, D, dtype, seed=S + D + Hq)
    out_tol, grad_tol = TOL[dtype]

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    jout = jfa.flash_attention(jq, jk, jv, causal=causal)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tout, tgrads = _torch_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        tq, tk, tv, lambda o: (o.float() * tg.float()).sum())

    assert tout.dtype == _DT[dtype][1] and tout.shape == (B, S, Hq, D)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=out_tol,
                               rtol=out_tol)
    for name, a, b in zip("qkv", jgrads, tgrads):
        assert b.dtype == _DT[dtype][1]
        np.testing.assert_allclose(_np(b), _np(a), atol=grad_tol,
                                   rtol=grad_tol, err_msg=f"d{name}")


@pytest.mark.parametrize("S,D,causal", [(256, 64, True), (384, 16, False)])
def test_lse_and_its_cotangent_match_jax(S, D, causal):
    """flash_attention_lse: out, lse [B, H, S], and grads through both
    outputs (the lse cotangent folds into delta)."""
    (jq, jk, jv, jg, jgl), (tq, tk, tv, tg, tgl) = _inputs(
        1, S, 8, 2, D, "float32", seed=7 + S)

    def jloss(q, k, v):
        out, lse = jfa.flash_attention_lse(q, k, v, causal=causal)
        return jnp.sum(out * jg) + jnp.sum(lse * jgl)

    jout, jlse = jfa.flash_attention_lse(jq, jk, jv, causal=causal)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    q, k, v = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    tout, tlse = tfa.flash_attention_lse(q, k, v, causal=causal)
    ((tout * tg).sum() + (tlse * tgl).sum()).backward()

    assert tlse.shape == (1, 8, S) and tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(tout), _np(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=2e-5, rtol=2e-5)
    for name, a, b in zip("qkv", jgrads, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(_np(b), _np(a), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


def test_plain_versions_counted_and_kernels_not_launched():
    (_, _, _, _, _), (tq, tk, tv, tg, _) = _inputs(1, 96, 4, 2, 64,
                                                   "float32", seed=3)
    tfa.reset_launches()
    q = tq.clone().requires_grad_(True)
    (tfa.flash_attention(q, tk, tv) * tg).sum().backward()
    assert tfa.plain_calls == {"flash_fwd": 1, "flash_bwd_dq": 1,
                               "flash_bwd_dkv": 1}
    assert tfa.launches == dict.fromkeys(tfa.launches, 0)
    assert tfa.fallback_count() == 0


def test_unported_sidebands_raise_on_every_device():
    (_, _, _, _, _), (tq, tk, tv, _, _) = _inputs(1, 64, 4, 2, 64,
                                                  "float32", seed=4)
    mask = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(tq, tk, tv, key_padding_mask=mask)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(tq, tk, tv, segment_ids=mask.long())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention_fn(tq, tk, tv, mask[:, None, None, :])
    with pytest.raises(ValueError, match="multiple"):
        kv3 = torch.zeros((1, 64, 3, 64))
        tfa.flash_attention(tq, kv3, kv3)
    assert tfa.flash_lse_supported(200, 96)
    # D > 128 has no CUDA kernel: the gate says no for the card, yes for
    # the plain versions, which run it.
    assert not tfa.flash_lse_supported(64, 256)
    assert not tfa.flash_lse_supported(64, 256, device="cuda")
    assert tfa.flash_lse_supported(64, 256, device="cpu")
    wide = [torch.cat([t] * 4, -1) for t in (tq, tk, tv)]
    assert tfa.flash_attention_lse(*wide)[0].shape == (1, 64, 4, 256)
