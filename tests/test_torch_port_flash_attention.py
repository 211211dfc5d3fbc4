"""Port parity: flash attention forward and backward.

The port's ``ops/flash_attention.py`` (its plain versions: the tensors
lie on the CPU) against the JAX package's Pallas kernels, run in
interpret mode as the JAX package's own tests run them on the CPU.  The
same numpy-seeded inputs and cotangents go to both; the tolerances are
the reference's own (tests/test_flash_attention.py): fp32 out and lse
2e-5, fp32 grads 5e-4, bf16 3e-2.  Only the summation order differs
(the port walks its kernels' tiles: 128-key forward steps, 64-key dQ
steps and 64-row dK/dV query tiles in bf16, 64-key steps and 32-row
tiles in fp32; the reference up to 512), and in bf16 the kernels round
P and dS at the same points.  Packed rows (``segment_ids``)
are held the same way; the reference pads a ragged S with a fresh
trailing segment, the port masks the tail.  Key-padding masks (the
additive key-bias sideband) are held on the reference's own cases
(tests/test_flash_attention.py:221-291, :348-397) and a few more, on the
rows whose query position is valid (a query row whose every key is
masked is undefined in both packages).
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


def _key_mask(B, S, case):
    """bool [B, S] key-padding masks: per-row lengths, or (``hole``) a
    ragged tail plus a run of masked keys in the middle that spans a
    64-key tile edge."""
    pos = np.arange(S)[None, :]
    if case == "hole":
        mask = pos < np.array([S, S - 37])[:B, None]
        mask[:, 50:140] = False
        return mask
    lengths = {"lengths": [S, 100], "prefix": [192], "ragged": [S, 160],
               "empty_row": [0, 150]}.get(case, [S, 100, 231, 64][:B])
    return pos < np.array(lengths)[:, None]


KPM_CASES = [
    # (case, B, S, Hq, Hkv, D, causal, dtype): the reference's lengths
    # [256, 100] (D 128), 192 of 256, D 64, S 200 off the tile, the
    # [B, 1, 1, S] seam; then D 16 padded, GQA, a hole, bf16, causal with
    # a mask, and a batch row with no valid key.
    ("lengths", 2, 256, 2, 2, 128, False, "float32"),
    ("prefix", 1, 256, 2, 2, 128, False, "float32"),
    ("d64", 2, 256, 2, 2, 64, False, "float32"),
    ("ragged", 2, 200, 2, 2, 64, False, "float32"),
    ("seam", 2, 256, 2, 2, 64, False, "float32"),
    ("d16", 2, 200, 4, 2, 16, False, "float32"),
    ("gqa", 2, 256, 4, 2, 64, False, "float32"),
    ("hole", 2, 256, 4, 2, 64, False, "float32"),
    ("bf16", 2, 256, 4, 2, 64, False, "bfloat16"),
    ("causal", 2, 256, 4, 2, 64, True, "float32"),
    ("empty_row", 2, 256, 2, 2, 64, False, "float32"),
]


@pytest.mark.parametrize("case,B,S,Hq,Hkv,D,causal,dtype", KPM_CASES)
def test_key_padding_mask_out_and_grads_match_jax(case, B, S, Hq, Hkv, D,
                                                  causal, dtype):
    (jq, jk, jv, jg, _), (tq, tk, tv, tg, _) = _inputs(
        B, S, Hq, Hkv, D, dtype, seed=31 + S + D + Hq)
    mask = _key_mask(B, S, case)
    # Cotangent zero on rows whose query is padding (and on a row with no
    # valid key, undefined in both packages): compare the valid rows.
    rows = mask & mask.any(axis=1, keepdims=True)
    w = rows[:, :, None, None].astype(np.float32)
    out_tol, grad_tol = TOL[dtype]

    if case == "seam":
        def jfn(q, k, v):
            return jfa.flash_attention_fn(q, k, v,
                                          jnp.asarray(mask)[:, None, None])

        def tfn(q, k, v):
            return tfa.flash_attention_fn(
                q, k, v, torch.from_numpy(mask)[:, None, None])
    else:
        def jfn(q, k, v):
            return jfa.flash_attention(q, k, v, causal=causal,
                                       key_padding_mask=jnp.asarray(mask))

        def tfn(q, k, v):
            return tfa.flash_attention(
                q, k, v, causal=causal,
                key_padding_mask=torch.from_numpy(mask))

    def jloss(q, k, v):
        out = jfn(q, k, v).astype(jnp.float32)
        return jnp.sum(out * jg.astype(jnp.float32) * w)

    jout = jfn(jq, jk, jv)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tfa.reset_launches()
    tout, tgrads = _torch_grads(
        tfn, tq, tk, tv,
        lambda o: (o.float() * tg.float() * torch.from_numpy(w)).sum())
    assert tfa.plain_calls == dict.fromkeys(tfa.plain_calls, 1)

    assert tout.dtype == _DT[dtype][1] and tout.shape == (B, S, Hq, D)
    assert bool(torch.isfinite(tout).all())
    np.testing.assert_allclose(_np(tout)[rows], _np(jout)[rows],
                               atol=out_tol, rtol=out_tol)
    for name, a, b in zip("qkv", jgrads, tgrads):
        assert b.dtype == _DT[dtype][1]
        np.testing.assert_allclose(_np(b), _np(a), atol=grad_tol,
                                   rtol=grad_tol, err_msg=f"d{name}")


def test_key_bias_is_the_references():
    """0 for an attended key, -1e30 for a masked one, fp32 [B, S]; the
    mask may come as [B, S] or [B, 1, 1, S]."""
    mask = torch.tensor([[True, False, True], [False, False, True]])
    q = torch.zeros((2, 3, 1, 64))
    for m in (mask, mask[:, None, None]):
        bias = tfa._key_bias(tfa._key_mask(m, q))
        assert bias.dtype == torch.float32
        np.testing.assert_array_equal(
            bias.numpy(), np.where(mask.numpy(), 0.0, -1e30).astype(
                np.float32))


def test_key_padding_mask_shapes():
    """[B, S] and [B, 1, 1, S] masks run on both entry points; any other
    shape raises NotImplementedError, as the reference's adapter does, and
    a mask of another [B, S] raises."""
    (_, _, _, _, _), (tq, tk, tv, _, _) = _inputs(1, 64, 4, 2, 64,
                                                  "float32", seed=4)
    mask = torch.ones((1, 64), dtype=torch.bool)
    assert tfa.flash_attention(tq, tk, tv, causal=False,
                               key_padding_mask=mask).shape == tq.shape
    assert tfa.flash_attention_fn(tq, tk, tv, mask[:, None, None, :]).shape \
        == tq.shape
    with pytest.raises(NotImplementedError, match="key-padding masks"):
        tfa.flash_attention(tq, tk, tv, causal=False,
                            key_padding_mask=torch.ones((1, 1, 64, 64),
                                                        dtype=torch.bool))
    with pytest.raises(ValueError, match="does not match"):
        tfa.flash_attention(tq, tk, tv, causal=False,
                            key_padding_mask=mask[:, :32])


def test_unported_sidebands_raise_on_every_device():
    """What the reference refuses stays refused: segments with
    causal=False and together with a key-padding mask, a [B, H, S, S]
    mask at the seam, KV heads that do not divide the query heads; and
    D > 128 has no CUDA kernel."""
    (_, _, _, _, _), (tq, tk, tv, _, _) = _inputs(1, 64, 4, 2, 64,
                                                  "float32", seed=4)
    mask = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        tfa.flash_attention(tq, tk, tv, causal=False,
                            segment_ids=mask.long())
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        tfa.flash_attention(tq, tk, tv, key_padding_mask=mask,
                            segment_ids=mask.long())
    with pytest.raises(NotImplementedError, match="key-padding masks"):
        tfa.flash_attention_fn(tq, tk, tv,
                               torch.ones((1, 4, 64, 64), dtype=torch.bool))
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


# ---------------------------------------------------------------------------
# The plain versions at each kernel's tiles
# ---------------------------------------------------------------------------

#: (forward tiles, dQ tiles, dK/dV tiles) of the bf16 (Hopper) and fp32
#: kernels.
NEW_TILES = tuple(t[torch.bfloat16] for t in (tfa.FWD_TILES, tfa.DQ_TILES,
                                              tfa.DKV_TILES))
OLD_TILES = tuple(t[torch.float32] for t in (tfa.FWD_TILES, tfa.DQ_TILES,
                                             tfa.DKV_TILES))


def _sidebands(case, B, S):
    """(segment ids or None, bool key mask or None) as numpy: packed rows
    with a boundary inside a 128-row tile (and one on a 64-row edge), or
    a key mask with a hole across the 64- and 128-key tile edges."""
    if case == "packed":
        ids = np.zeros((B, S), np.int32)
        for bd in (64, 100, 150, 200):
            ids[:, bd:] += 1
        return ids, None
    if case == "holed":
        mask = np.arange(S)[None, :] < np.array([S, S - 37])[:B, None]
        mask[:, 50:140] = False
        return None, mask
    return None, None


def _plain(tq, tk, tv, tg, causal, ids, mask, tiles):
    """out, lse, (dq, dk, dv) of the plain forward, dQ and dK/dV at
    ``tiles`` = (forward tiles, dQ tiles, dK/dV tiles); dout is ``tg``,
    zero on rows whose query is padding."""
    D = tq.shape[-1]
    seg = None if ids is None else tfa._segment_starts(torch.from_numpy(ids))
    bias = None if mask is None else tfa._key_bias(torch.from_numpy(mask))
    if mask is not None:
        tg = tg * torch.from_numpy(mask)[:, :, None, None].to(tg.dtype)
    out, lse = tfa._fwd_blockwise(tq, tk, tv, causal, D ** -0.5, seg, bias,
                                  tiles=tiles[0])
    delta = (tg.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tg, lse, delta, causal, D ** -0.5, seg, bias)
    dq = tfa._bwd_dq_blockwise(*args, tiles=tiles[1])
    dk, dv = tfa._bwd_dkv_blockwise(*args, tiles=tiles[2])
    return out, lse, (dq, dk, dv)


TILE_CASES = [
    # (case, B, S, Hq, Hkv, D, causal, dtype): S on both sides of the
    # 128-row tile and the 64-row one, D 64 and 128, G 1 and 4, causal and
    # bidirectional, packed rows and a holed key mask.
    ("dense", 1, 333, 4, 1, 128, True, "float32"),
    ("dense", 2, 129, 4, 4, 64, False, "float32"),
    ("dense", 1, 127, 4, 4, 64, True, "float32"),
    ("dense", 1, 128, 4, 1, 64, True, "float32"),
    ("dense", 2, 256, 8, 2, 64, True, "bfloat16"),
    ("packed", 2, 256, 4, 1, 64, True, "float32"),
    ("holed", 2, 200, 4, 2, 128, False, "float32"),
    # dQ's 64-key steps: S on both sides of 64, D 128 with S % 4 != 0,
    # packed rows at D 128 and a holed mask with G 4.
    ("dense", 1, 63, 4, 1, 64, True, "float32"),
    ("dense", 2, 65, 4, 4, 128, False, "float32"),
    ("dense", 1, 199, 8, 2, 128, True, "float32"),
    ("packed", 1, 333, 4, 2, 128, True, "float32"),
    ("holed", 2, 256, 8, 2, 64, False, "float32"),
]


@pytest.mark.parametrize("case,B,S,Hq,Hkv,D,causal,dtype", TILE_CASES)
def test_plain_versions_at_the_hopper_tiles_match_jax(case, B, S, Hq, Hkv, D,
                                                      causal, dtype):
    """The plain forward, dQ and dK/dV walking the bf16 kernels' tiles
    (128-row query blocks and 128-key steps; 128-row query blocks and
    64-key steps; 128-key blocks and 64-row query tiles) against the JAX
    package, out on the valid rows and dQ, dK, dV, at the reference's
    tolerances."""
    (jq, jk, jv, jg, _), (tq, tk, tv, tg, _) = _inputs(
        B, S, Hq, Hkv, D, dtype, seed=41 + S + D)
    ids, mask = _sidebands(case, B, S)
    rows = np.ones((B, S), bool) if mask is None else mask
    w = rows[:, :, None, None].astype(np.float32)
    kwargs = {"causal": causal}
    if ids is not None:
        kwargs["segment_ids"] = jnp.asarray(ids)
    if mask is not None:
        kwargs["key_padding_mask"] = jnp.asarray(mask)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, **kwargs).astype(jnp.float32)
        return jnp.sum(out * jg.astype(jnp.float32) * w)

    jout = jfa.flash_attention(jq, jk, jv, **kwargs)
    jdq, jdk, jdv = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, _, (dq, dk, dv) = _plain(tq, tk, tv, tg, causal, ids, mask,
                                  NEW_TILES)
    out_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(_np(out)[rows], _np(jout)[rows],
                               atol=out_tol, rtol=out_tol)
    for name, a, b in (("dq", jdq, dq), ("dk", jdk, dk), ("dv", jdv, dv)):
        assert b.dtype == _DT[dtype][1]
        np.testing.assert_allclose(_np(b), _np(a), atol=grad_tol,
                                   rtol=grad_tol, err_msg=name)


ACROSS_CASES = [
    # (case, B, S, Hq, Hkv, D, causal, dtype)
    ("dense", 1, 1, 4, 4, 64, True, "bfloat16"),
    ("dense", 1, 127, 4, 1, 128, True, "bfloat16"),
    ("dense", 2, 129, 4, 4, 64, False, "bfloat16"),
    ("dense", 1, 333, 8, 2, 128, True, "bfloat16"),
    ("packed", 2, 333, 4, 1, 64, True, "bfloat16"),
    ("holed", 2, 256, 4, 2, 64, False, "bfloat16"),
    ("dense", 1, 333, 8, 2, 64, True, "float32"),
    ("packed", 1, 256, 4, 4, 128, True, "float32"),
    ("holed", 2, 200, 4, 1, 64, False, "float32"),
]


@pytest.mark.parametrize("case,B,S,Hq,Hkv,D,causal,dtype", ACROSS_CASES)
def test_plain_versions_agree_across_tiles(case, B, S, Hq, Hkv, D, causal,
                                           dtype):
    """The plain versions at the bf16 kernels' tiles against themselves at
    the fp32 kernels' (the tiles every kernel had before): the same
    function, other online-softmax steps and summation orders.  bf16 out
    within 2 ulps of max(1, |ref|), dQ, dK and dV within 3e-2 of each
    tensor's largest; fp32 out and lse 2e-5, grads 5e-4 — today's
    tolerances."""
    _, (tq, tk, tv, tg, _) = _inputs(B, S, Hq, Hkv, D, dtype, seed=S + Hq)
    ids, mask = _sidebands(case, B, S)
    rows = torch.ones((B, S), dtype=torch.bool) if mask is None \
        else torch.from_numpy(mask)
    new = _plain(tq, tk, tv, tg, causal, ids, mask, NEW_TILES)
    old = _plain(tq, tk, tv, tg, causal, ids, mask, OLD_TILES)
    out_n, out_o = new[0].float()[rows], old[0].float()[rows]
    lse_n = new[1].transpose(1, 2)[rows]
    lse_o = old[1].transpose(1, 2)[rows]
    if dtype == "float32":
        torch.testing.assert_close(out_n, out_o, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse_n, lse_o, rtol=2e-5, atol=2e-5)
        for a, b in zip(new[2], old[2]):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)
    else:
        assert bool(((out_n - out_o).abs()
                     <= 2.0 ** -7 * out_o.abs().clamp(min=1.0)).all())
        assert float((lse_n - lse_o).abs().max()) <= 1e-3
        for a, b in zip(new[2], old[2]):
            a, b = a.float(), b.float()
            assert float((a - b).abs().max()) <= 3e-2 * float(b.abs().max())


def test_plain_versions_default_to_each_dtypes_kernel_tiles():
    """Without ``tiles`` the plain versions walk the tiles of the kernel
    the dtype runs: bit for bit the explicit call."""
    for dtype, tiles in (("bfloat16", NEW_TILES), ("float32", OLD_TILES)):
        _, (tq, tk, tv, tg, _) = _inputs(1, 200, 4, 2, 64, dtype, seed=9)
        scale = 64 ** -0.5
        out, lse = tfa._fwd_blockwise(tq, tk, tv, True, scale)
        out_t, lse_t = tfa._fwd_blockwise(tq, tk, tv, True, scale,
                                          tiles=tiles[0])
        assert torch.equal(out, out_t) and torch.equal(lse, lse_t)
        delta = (tg.float() * out.float()).sum(-1).transpose(1, 2)
        args = (tq, tk, tv, tg, lse, delta.contiguous(), True, scale)
        assert torch.equal(tfa._bwd_dq_blockwise(*args),
                           tfa._bwd_dq_blockwise(*args, tiles=tiles[1]))
        for a, b in zip(tfa._bwd_dkv_blockwise(*args),
                        tfa._bwd_dkv_blockwise(*args, tiles=tiles[2])):
            assert torch.equal(a, b)
