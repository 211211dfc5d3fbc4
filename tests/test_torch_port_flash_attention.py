"""Port parity: flash attention forward and backward.

The port's ``ops/flash_attention.py`` (its plain versions: the tensors
lie on the CPU) against the JAX package's Pallas kernels, run in
interpret mode as the JAX package's own tests run them on the CPU.  The
same numpy-seeded inputs and cotangents go to both; the tolerances are
the reference's own (tests/test_flash_attention.py): fp32 out and lse
2e-5, fp32 grads 5e-4, bf16 3e-2.  Only the summation order differs
(the port walks 64-key tiles, the reference up to 512), and in bf16 the
kernels round P and dS at the same points.  Packed rows (``segment_ids``)
are held the same way; the reference pads a ragged S with a fresh
trailing segment, the port masks the tail.
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


def _segments(B, S, mean, seed):
    """[B, S] int32 ids of packed documents (Poisson lengths, as the
    packed-pretraining example draws them)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, doc = 0, 0
        while pos < S:
            n = max(1, int(rng.poisson(mean)))
            seg[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


def _long_segments():
    """Row 0: documents of 150 and 106 tokens (query tiles from row 192
    start their keys at 150: the kernel skips key tiles 0 and 1); row 1:
    10, 246 (tiles from row 64 skip tile 0)."""
    seg = np.zeros((2, 256), np.int32)
    seg[0, 150:] = 1
    seg[1, 10:] = 1
    return seg


SEG_CASES = [
    # (case, B, S, Hq, Hkv, D, dtype)
    ("gqa", 2, 256, 8, 2, 64, "float32"),
    ("ragged", 1, 200, 4, 2, 64, "float32"),
    ("bf16", 2, 256, 8, 2, 64, "bfloat16"),
    ("skip", 2, 256, 4, 2, 64, "float32"),
]


@pytest.mark.parametrize("case,B,S,Hq,Hkv,D,dtype", SEG_CASES)
def test_segment_ids_out_and_grads_match_jax(case, B, S, Hq, Hkv, D, dtype):
    (jq, jk, jv, jg, _), (tq, tk, tv, tg, _) = _inputs(
        B, S, Hq, Hkv, D, dtype, seed=11 + S + Hq)
    seg = _long_segments() if case == "skip" else _segments(
        B, S, 40 if S > 200 else 30, seed=S)
    out_tol, grad_tol = TOL[dtype]

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True,
                                  segment_ids=jnp.asarray(seg))
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    jout = jfa.flash_attention(jq, jk, jv, causal=True,
                               segment_ids=jnp.asarray(seg))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tfa.reset_launches()
    tout, tgrads = _torch_grads(
        lambda q, k, v: tfa.flash_attention(
            q, k, v, causal=True, segment_ids=torch.from_numpy(seg)),
        tq, tk, tv, lambda o: (o.float() * tg.float()).sum())
    assert tfa.plain_calls == dict.fromkeys(tfa.plain_calls, 1)

    assert tout.dtype == _DT[dtype][1] and tout.shape == (B, S, Hq, D)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=out_tol,
                               rtol=out_tol)
    for name, a, b in zip("qkv", jgrads, tgrads):
        np.testing.assert_allclose(_np(b), _np(a), atol=grad_tol,
                                   rtol=grad_tol, err_msg=f"d{name}")


def test_segment_starts_match_jax():
    """Starts of each position's run; an id that recurs after a gap is a
    new segment (row 1: 0 0 1 1 0 0 2)."""
    ids = np.array([[0, 0, 0, 1, 1, 2, 3], [0, 0, 1, 1, 0, 0, 2],
                    [5, 5, 5, 5, 5, 5, 5]], np.int32)
    want = np.asarray(jfa._segment_starts(jnp.asarray(ids)))
    got = tfa._segment_starts(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), [0, 0, 2, 2, 4, 4, 6])


def test_segment_attention_fn_matches_flash_attention():
    """The model seam for packed rows computes the starts once and gives
    what ``flash_attention(segment_ids=)`` gives, out and grads, bit for
    bit; it refuses a key-padding mask and ids of another [B, S]."""
    (_, _, _, _, _), (tq, tk, tv, tg, _) = _inputs(2, 256, 8, 2, 64,
                                                   "float32", seed=21)
    seg = torch.from_numpy(_segments(2, 256, 40, seed=5))
    fn = tfa.segment_attention_fn(seg)
    loss = lambda o: (o * tg).sum()
    want, wgrads = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=True, segment_ids=seg), tq, tk, tv, loss)
    got, ggrads = _torch_grads(fn, tq, tk, tv, loss)
    assert torch.equal(got, want)
    for a, b in zip(ggrads, wgrads):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        fn(tq, tk, tv, torch.ones((2, 1, 1, 256), dtype=torch.bool))
    with pytest.raises(ValueError, match="do not match"):
        fn(tq[:1], tk[:1], tv[:1])


def test_unported_sidebands_raise_on_every_device():
    """The key-padding sideband is still refused (it comes with BERT);
    segments raise where the reference raises: with causal=False and
    together with a key-padding mask."""
    (_, _, _, _, _), (tq, tk, tv, _, _) = _inputs(1, 64, 4, 2, 64,
                                                  "float32", seed=4)
    mask = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(tq, tk, tv, key_padding_mask=mask)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        tfa.flash_attention(tq, tk, tv, causal=False,
                            segment_ids=mask.long())
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        tfa.flash_attention(tq, tk, tv, key_padding_mask=mask,
                            segment_ids=mask.long())
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
