"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips with a reason where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so on a GPU machine
without JAX it runs on its own::

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import generation
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, *, B, Hkv, G, D, BS, maxb, seed):
    """Random pools, distinct live blocks per row, block-edge positions and
    a trailing padded row (pos 0, all-trash table)."""
    rng = np.random.default_rng(seed)
    nb = B * maxb + 1
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D),
                                             np.float32))
    pk = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    pv = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    edges = [0, BS - 1, BS, maxb * BS - 1, 3 * BS // 2, 2 * BS + 1]
    pos = np.zeros((B,), np.int32)
    tables = np.zeros((B, maxb), np.int32)
    for i in range(B - 1):
        pos[i] = edges[i % len(edges)]
        live = pos[i] // BS + 1
        tables[i, :live] = rng.permutation(np.arange(1, nb))[:live]
    return ([t.to(dev, dtype) for t in (q, pk, pv)]
            + [torch.from_numpy(a).to(dev) for a in (tables, pos)])


def _agree(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    else:   # 2 bf16 ULPs of max(1, |ref|)
        assert bool(((got - ref).abs()
                     <= 2.0 ** -7 * ref.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype,Hkv,G,D,BS", [
    (torch.float32, 2, 2, 16, 16),
    (torch.bfloat16, 8, 4, 128, 16),
    (torch.float32, 3, 1, 64, 8),
    (torch.bfloat16, 1, 32, 256, 32),     # > 48 KiB of shared memory
])
def test_kernel_matches_plain_version(dev, dtype, Hkv, G, D, BS):
    args = _case(dev, dtype, B=7, Hkv=Hkv, G=G, D=D, BS=BS, maxb=8,
                 seed=D + G)
    before = pa.launches
    got = pa.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    _agree(got, pa._decode_blockwise(*args), dtype)


#: (Hkv, G, D, dtype): the paged decode's groups, head dims and dtypes.
DECODE_GROUPS = [(8, 1, 128, torch.bfloat16), (4, 2, 64, torch.bfloat16),
                 (8, 4, 128, torch.bfloat16), (2, 8, 64, torch.bfloat16),
                 (2, 4, 128, torch.float32), (1, 8, 64, torch.float32)]


@pytest.mark.parametrize("Hkv,G,D,dtype", DECODE_GROUPS)
def test_decode_kernel_at_range_and_page_edges(dev, Hkv, G, D, dtype):
    """One launch a call against the plain version with each row's pos on
    a page or range edge: 0, BS - 1, BS, a range's last token and the
    next one, two ranges' end, and the table's last slot (maxb·BS - 1),
    beside a padded row (pos 0, all-trash table)."""
    BS, maxb = 16, 40
    R = pa.range_tokens()
    edges = [0, BS - 1, BS, R - 1, R, 2 * R - 1, maxb * BS - 1]
    B = len(edges) + 1
    rng = np.random.default_rng(G * D + Hkv)
    nb = B * maxb + 1
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D), np.float32))
    pk = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    pv = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    pos = np.zeros((B,), np.int32)
    tables = np.zeros((B, maxb), np.int32)
    for i, p in enumerate(edges):
        pos[i] = p
        tables[i, :p // BS + 1] = rng.permutation(np.arange(1, nb))[
            :p // BS + 1]
    args = ([t.to(dev, dtype) for t in (q, pk, pv)]
            + [torch.from_numpy(a).to(dev) for a in (tables, pos)])
    before = pa.launches
    got = pa.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    _agree(got, pa._decode_blockwise(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_row_alone_and_beside_batch_mates_is_bitwise_equal(dev,
                                                                   dtype):
    """A row's output depends on its own pos and the table width alone:
    decoded alone and as row 3 of 8 (longer, shorter and padded
    batch-mates), the bits agree; so do two calls."""
    args = _case(dev, dtype, B=8, Hkv=8, G=4, D=128, BS=16, maxb=64,
                 seed=11)
    q, pk, pv, tables, pos = args
    pos[3] = 700   # 6 ranges of 128, the last partial
    tables[3, :pos[3] // 16 + 1] = torch.arange(
        1, int(pos[3]) // 16 + 2, dtype=torch.int32, device=dev)
    full = pa.paged_attention_decode(q, pk, pv, tables, pos)
    again = pa.paged_attention_decode(q, pk, pv, tables, pos)
    alone = pa.paged_attention_decode(q[3:4].contiguous(), pk, pv,
                                      tables[3:4].contiguous(),
                                      pos[3:4].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    assert torch.equal(full[3:4], alone)
    _agree(alone, pa._decode_blockwise(q[3:4], pk, pv, tables[3:4],
                                       pos[3:4]), dtype)


def test_kernel_rejects_what_it_cannot_run(dev):
    q, pk, pv, tables, pos = _case(dev, torch.float32, B=2, Hkv=2, G=2,
                                   D=16, BS=16, maxb=4, seed=0)
    with pytest.raises(TypeError):
        pa.paged_attention_decode(q.half(), pk.half(), pv.half(), tables,
                                  pos)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_decode(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), pk, pv, tables, pos)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention_decode(q[..., :8].contiguous(),
                                  pk[..., :8].contiguous(),
                                  pv[..., :8].contiguous(), tables, pos)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_decode(q, pk, pv, tables.long(), pos)


def test_fused_decode_step_tracks_oracle_on_the_card(dev):
    """The whole decode step through the kernel against the gather
    oracle, bf16 tiny model: logits within 4 bf16 ULPs at logit scale."""
    cfg = LlamaConfig.tiny()
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev))
    shape = (cfg.num_layers, 17, 4, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    pv = torch.zeros_like(pk)
    prompt = torch.arange(1, 10, device=dev)[None]
    table = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32,
                         device=dev)
    logits, _, _ = generation.paged_prefill(model, torch.cat(
        [prompt, prompt.new_zeros((1, 3))], 1), pk, pv, table,
        prompt_len=9, cache_len=32)
    tok = logits.argmax(-1)
    tables = table[None].clone()
    pos = torch.tensor([9], dtype=torch.int32, device=dev)
    before = pa.launches
    lf, _, _ = generation.paged_decode_step(model, tok, pk, pv, tables, pos,
                                            fused=True)
    assert pa.launches == before + cfg.num_layers
    lo, _, _ = generation.paged_decode_step(model, tok, pk, pv, tables, pos)
    assert float((lf.float() - lo.float()).abs().max()) < 0.125


# ---------------------------------------------------------------------------
# flash attention: hvd_flash_fwd / hvd_flash_bwd_dq / hvd_flash_bwd_dkv
# ---------------------------------------------------------------------------

def _flash_inputs(dev, dtype, B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype) for s in shapes]


def _flash_agree(got, ref, dtype, grad, floor=0.0):
    """fp32: the reference's 2e-5 (out) / 5e-4 (grads).  bf16: out within
    2 bf16 ULPs of max(1, |ref|); grads within 3e-2 of each tensor's max
    (dS is rounded to bf16 before two products, so errors scale with the
    tensor, not the element), or within ``floor`` where that max is 0."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        tol = 5e-4 if grad else 2e-5
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    elif grad:
        assert float((got - ref).abs().max()) <= \
            max(3e-2 * float(ref.abs().max()), floor)
    else:
        assert bool(((got - ref).abs()
                     <= 2.0 ** -7 * ref.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,D,causal", [
    (torch.bfloat16, 2, 256, 8, 2, 128, True),
    (torch.bfloat16, 1, 200, 4, 2, 64, False),
    (torch.bfloat16, 1, 333, 4, 4, 128, True),
    (torch.float32, 1, 200, 4, 2, 64, True),
    (torch.float32, 2, 130, 4, 1, 128, False),
])
def test_flash_kernels_match_plain_versions(dev, dtype, B, S, Hq, Hkv, D,
                                            causal):
    q, k, v, do = _flash_inputs(dev, dtype, B, S, Hq, Hkv, D, seed=S + D)
    scale = D ** -0.5
    fa.reset_launches()
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, causal, scale)
    _flash_agree(out, ref_out, dtype, grad=False)
    torch.testing.assert_close(lse.cpu(), ref_lse.cpu(), rtol=1e-5,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, ref_lse, delta.contiguous(), causal, scale)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    _flash_agree(dq, fa._bwd_dq_blockwise(*args), dtype, grad=True)
    for got, ref in zip((dk, dv), fa._bwd_dkv_blockwise(*args)):
        _flash_agree(got, ref, dtype, grad=True)
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


def test_flash_autograd_runs_the_kernels_and_pads_head_dim(dev):
    """D 96 through the wrapper: zero-padded to 128 with the true scale;
    every kernel launched once, no plain version called."""
    q, k, v, do = _flash_inputs(dev, torch.float32, 1, 200, 4, 2, 96, 5)
    grads = []
    for path in ("kernel", "plain"):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        if path == "plain":
            xs = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
        fa.reset_launches()
        out = fa.flash_attention(*xs, causal=True)
        (out * do.to(out.device)).sum().backward()
        if path == "kernel":
            torch.cuda.synchronize()
            assert fa.launches == dict.fromkeys(fa.launches, 1)
            assert fa.plain_calls == dict.fromkeys(fa.plain_calls, 0)
        grads.append([out] + [t.grad for t in xs])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.cpu(), ref, rtol=5e-4, atol=5e-4)


def test_flash_kernels_reject_what_they_cannot_run(dev):
    q, k, v, _ = _flash_inputs(dev, torch.float32, 1, 64, 4, 2, 64, 0)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    assert not fa.flash_lse_supported(64, 256, device=dev)
    assert fa.flash_lse_supported(64, 128, device=dev)
    with pytest.raises(ValueError, match="head dim 256"):
        fa.flash_attention(*[torch.cat([t] * 4, -1) for t in (q, k, v)])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k.cpu(), v, True, 0.125)


def _starts(B, S, mean, seed):
    """int32 [B, S] segment starts of Poisson-length packed documents,
    with one boundary on a 64-row tile edge and one inside a tile."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S), np.int64)
    for b in range(B):
        pos, doc = 0, 0
        while pos < S:
            n = max(1, int(rng.poisson(mean)))
            ids[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    ids[0, 64:] += 1000          # a boundary on a tile edge
    ids[0, 100:] += 1000         # and one inside a tile
    return fa._segment_starts(torch.from_numpy(ids))


@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,D,mean", [
    (torch.bfloat16, 2, 512, 8, 2, 128, 120),
    (torch.bfloat16, 1, 333, 4, 4, 64, 40),
    (torch.float32, 2, 200, 4, 2, 64, 30),
    (torch.float32, 1, 130, 4, 1, 128, 500),
])
def test_flash_kernels_with_segments_match_plain_versions(dev, dtype, B, S,
                                                          Hq, Hkv, D, mean):
    """The three kernels with segment starts (the kv_first skip, the dK/dV
    query-tile cap) against their plain versions, which mask instead."""
    q, k, v, do = _flash_inputs(dev, dtype, B, S, Hq, Hkv, D, seed=S + 1)
    seg = _starts(B, S, mean, seed=S).to(dev)
    scale = D ** -0.5
    fa.reset_launches()
    out, lse = fa.flash_fwd(q, k, v, True, scale, seg)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, True, scale, seg)
    _flash_agree(out, ref_out, dtype, grad=False)
    torch.testing.assert_close(lse.cpu(), ref_lse.cpu(), rtol=1e-5,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, ref_lse, delta.contiguous(), True, scale, seg)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    _flash_agree(dq, fa._bwd_dq_blockwise(*args), dtype, grad=True)
    for got, ref in zip((dk, dv), fa._bwd_dkv_blockwise(*args)):
        _flash_agree(got, ref, dtype, grad=True)
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


# ---------------------------------------------------------------------------
# The bf16 forward and dK/dV main loops (wgmma, TMA, 128-row tiles)
# ---------------------------------------------------------------------------

def _holed(B, S):
    """bool [B, S]: the last row ragged (37 keys short, when S allows) and
    a run of masked keys across the 64- and 128-key tile edges."""
    mask = torch.ones((B, S), dtype=torch.bool)
    if S > 64:
        mask[-1, S - 37:] = False
        mask[:, S // 4 - 20:S // 4 + 70] = False
    return mask


HOPPER_CASES = [
    # (S, D, G, causal, kind): S around the 128-row tile (and the 64-row
    # one, dQ's key step), D 64 and 128, G 1 and 4, causal and
    # bidirectional; packed rows with boundaries inside a 128-row tile; a
    # key mask with holes.
    (1, 64, 1, True, "dense"),
    (1, 128, 4, False, "dense"),
    (63, 128, 1, True, "dense"),
    (64, 64, 4, False, "dense"),
    (65, 128, 4, True, "dense"),
    (65, 64, 1, False, "holed"),
    (130, 128, 4, True, "packed"),
    (127, 64, 4, True, "dense"),
    (127, 128, 1, False, "dense"),
    (128, 64, 1, False, "dense"),
    (128, 128, 4, True, "dense"),
    (129, 64, 4, False, "dense"),
    (129, 128, 1, True, "dense"),
    (333, 64, 1, True, "dense"),
    (333, 128, 4, False, "dense"),
    (2048, 128, 4, True, "dense"),
    (333, 64, 4, True, "packed"),
    (333, 128, 1, True, "packed"),
    (2048, 128, 4, True, "packed"),
    (333, 64, 1, False, "holed"),
    (333, 128, 4, False, "holed"),
    (512, 64, 1, False, "holed"),
    (256, 64, 4, True, "holed"),
]


@pytest.mark.parametrize("S,D,G,causal,kind", HOPPER_CASES)
def test_hopper_flash_kernels_cover_their_tile_edges(dev, S, D, G, causal,
                                                     kind):
    """bf16 forward, dQ and dK/dV against their plain versions across the
    tiles' edges (out and lse on the valid rows, the cotangent zero on the
    others); dQ and dK/dV are bitwise the same on a second run (no
    atomics)."""
    B = 1 if S > 1000 else 2
    Hkv = 2
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, S, G * Hkv, Hkv, D,
                                seed=S + D + G)
    seg = bias = None
    rows = torch.ones((B, S), dtype=torch.bool, device=dev)
    if kind == "packed":
        seg = _starts(B, S, 120, seed=S).to(dev)
    elif kind == "holed":
        rows = _holed(B, S).to(dev)
        bias = fa._key_bias(rows)
        do = do * rows[:, :, None, None].to(do.dtype)
    scale = D ** -0.5
    fa.reset_launches()
    out, lse = fa.flash_fwd(q, k, v, causal, scale, seg, bias)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, causal, scale, seg, bias)
    _flash_agree(out[rows], ref_out[rows], torch.bfloat16, grad=False)
    torch.testing.assert_close(lse.transpose(1, 2)[rows].cpu(),
                               ref_lse.transpose(1, 2)[rows].cpu(),
                               rtol=1e-5, atol=1e-3)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, ref_lse, delta.contiguous(), causal, scale, seg,
            bias)
    dq = fa.flash_bwd_dq(*args)
    dq2 = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    dk2, dv2 = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    # With one key dS = P·(dP − delta) is 0 in exact arithmetic; the kernels
    # leave fp32 rounding of dP − delta (~1e-6), so S 1 needs a floor.
    floor = 1e-5 if S == 1 else 0.0
    _flash_agree(dq, fa._bwd_dq_blockwise(*args), torch.bfloat16, grad=True,
                 floor=floor)
    for got, ref in zip((dk, dv), fa._bwd_dkv_blockwise(*args)):
        _flash_agree(got, ref, torch.bfloat16, grad=True, floor=floor)
    assert torch.equal(dq, dq2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}


@pytest.mark.parametrize("D,masked", [(16, False), (96, False), (16, True),
                                      (96, True)])
def test_hopper_flash_pads_head_dims_in_bf16(dev, D, masked):
    """bf16 D 16 and 96 through the autograd wrapper (zero-padded to 64
    and 128 with the true scale) on the card against the same call on the
    CPU's plain versions: out and the three grads."""
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 2, 200, 8, 2, D, D)
    mask = _holed(2, 200).to(dev) if masked else None
    if masked:
        do = do * mask[:, :, None, None].to(do.dtype)
    got = []
    for path in ("kernel", "plain"):
        xs = [t.detach().clone() for t in (q, k, v)]
        m = mask
        if path == "plain":
            xs = [t.cpu() for t in xs]
            m = None if mask is None else mask.cpu()
        xs = [t.requires_grad_(True) for t in xs]
        fa.reset_launches()
        out = fa.flash_attention(*xs, causal=not masked, key_padding_mask=m)
        (out.float() * do.to(out.device).float()).sum().backward()
        if path == "kernel":
            torch.cuda.synchronize()
            assert fa.launches == dict.fromkeys(fa.launches, 1)
        rows = torch.ones(out.shape[:2], dtype=torch.bool) if m is None \
            else m.cpu()
        got.append([out.cpu()[rows]] + [t.grad.cpu() for t in xs])
    _flash_agree(got[0][0], got[1][0], torch.bfloat16, grad=False)
    for a, b in zip(got[0][1:], got[1][1:]):
        _flash_agree(a, b, torch.bfloat16, grad=True)


# ---------------------------------------------------------------------------
# RMSNorm: hvd_rms_fwd / hvd_rms_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,H,xdt,ydt", [
    (4096, 4096, torch.bfloat16, torch.bfloat16),
    (1000, 4096, torch.float32, torch.float32),
    (37, 100, torch.float32, torch.float32),
    (64, 100, torch.bfloat16, torch.bfloat16),
    (300, 768, torch.bfloat16, torch.float32),
    (5, 20000, torch.float32, torch.bfloat16),
])
def test_rms_kernels_match_plain_versions(dev, R, H, xdt, ydt):
    """Forward: bf16 y within one bf16 ulp of |y| (both round nearly the
    same fp32 value once; the statistic's sum order differs), fp32 y and
    rstd within rel 1e-5.
    Backward: dx within 2e-2 of its max (bf16) or 1e-5 (fp32), the
    partials and their sum within rel 1e-4."""
    from horovod_tpu_torch.ops import rms_norm as rn

    rng = np.random.default_rng(R + H)
    x = torch.from_numpy(rng.standard_normal((R, H), np.float32)).to(dev, xdt)
    dy = torch.from_numpy(rng.standard_normal((R, H), np.float32)).to(dev, ydt)
    scale = torch.from_numpy(rng.standard_normal(H).astype(np.float32)
                             + 1.0).to(dev)
    rn.reset_launches()
    y, rstd = rn.rms_fwd(x, scale, 1e-5, ydt)
    dx, parts = rn.rms_bwd(x, scale, rstd, dy)
    torch.cuda.synchronize()
    assert rn.launches == {"rms_fwd": 1, "rms_bwd": 1}
    ry, rr = rn._fwd_rows(x, scale, 1e-5, ydt)
    rdx, rparts = rn._bwd_rows(x, scale, rstd, dy)
    assert y.dtype == ydt and dx.dtype == xdt
    torch.testing.assert_close(rstd, rr, rtol=1e-5, atol=1e-5)
    ulp = 2.0 ** -7 if ydt == torch.bfloat16 else 1e-5
    d = (y.float() - ry.float()).abs()
    assert bool((d <= ulp * ry.float().abs() + 1e-6).all()), float(d.max())
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-5
    assert float((dx.float() - rdx.float()).abs().max()) <= \
        tol * float(rdx.float().abs().max())
    assert parts.shape == rparts.shape
    torch.testing.assert_close(parts, rparts, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(parts.sum(0), rparts.sum(0), rtol=1e-4,
                               atol=1e-3)


def test_rms_norm_autograd_runs_the_kernels(dev):
    """rms_norm on CUDA tensors: one launch each way, no plain call, dx in
    x's dtype and dscale in the scale's."""
    from horovod_tpu_torch.ops import rms_norm as rn

    x = torch.randn((2, 33, 512), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    scale = torch.ones(512, device=dev, requires_grad=True)
    rn.reset_launches()
    rn.rms_norm(x, scale).float().square().sum().backward()
    torch.cuda.synchronize()
    assert rn.launches == {"rms_fwd": 1, "rms_bwd": 1}
    assert rn.plain_calls == {"rms_fwd": 0, "rms_bwd": 0}
    assert x.grad.dtype == torch.bfloat16 and scale.grad.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        rn.rms_fwd(x.detach(), scale.detach().cpu(), 1e-5, torch.bfloat16)


@pytest.mark.parametrize("R,H,xdt,ydt", [
    (1, 4096, torch.bfloat16, torch.bfloat16),     # R 1: one CTA, one row
    (100, 8192, torch.bfloat16, torch.bfloat16),   # R < CTAs; widest ring
    (100, 8200, torch.bfloat16, torch.bfloat16),   # one chunk past: 2 passes
    (131, 8192, torch.float32, torch.float32),     # fp32 ring, 3 stages
    (131, 8200, torch.float32, torch.float32),
    (133, 8192, torch.float32, torch.bfloat16),    # 2-row blocks, mixed
    (300, 4104, torch.bfloat16, torch.bfloat16),   # 8 chunks, the last part
    (7, 1032, torch.bfloat16, torch.float32),      # 2 chunks, the last part
    (4096, 4096, torch.bfloat16, torch.bfloat16),  # the training shape
    (5, 24, torch.float32, torch.float32),         # a tiny ring row
])
def test_rms_bwd_ring_edges_match_plain_and_repeat(dev, R, H, xdt, ydt):
    """The backward at the ring's edges (H 8192, its widest row, and 8200,
    one 8-column step past it, which takes the two-pass kernel; R 1 and R
    below the CTA count; bf16, fp32 and mixed; partial 1024-column chunks):
    dx within 2e-2 (bf16) / 1e-5 (fp32) of its max, the partials one per
    block of block_rows(R) rows and within rel 1e-4, and a second run
    bitwise equal to the first (fixed-order sums, no atomics)."""
    from horovod_tpu_torch.ops import rms_norm as rn

    rng = np.random.default_rng(R * 7 + H)
    x = torch.from_numpy(rng.standard_normal((R, H), np.float32)).to(dev, xdt)
    dy = torch.from_numpy(rng.standard_normal((R, H), np.float32)).to(dev, ydt)
    scale = torch.from_numpy(rng.standard_normal(H).astype(np.float32)
                             + 1.0).to(dev)
    rstd = rn._fwd_rows(x, scale, 1e-5, xdt)[1]
    rn.reset_launches()
    dx, parts = rn.rms_bwd(x, scale, rstd, dy)
    dx2, parts2 = rn.rms_bwd(x, scale, rstd, dy)
    torch.cuda.synchronize()
    assert rn.launches["rms_bwd"] == 2 and rn.plain_calls["rms_bwd"] == 0
    rows = rn.block_rows(R)
    assert parts.shape == (-(-R // rows), H) and dx.dtype == xdt
    assert parts.shape[0] <= rn.TARGET_BLOCKS
    rdx, rparts = rn._bwd_rows(x, scale, rstd, dy)
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-5
    assert float((dx.float() - rdx.float()).abs().max()) <= \
        tol * float(rdx.float().abs().max())
    torch.testing.assert_close(parts, rparts, rtol=1e-4, atol=1e-4)
    assert torch.equal(dx, dx2) and torch.equal(parts, parts2)


# ---------------------------------------------------------------------------
# flash attention with the key-bias sideband (key padding)
# ---------------------------------------------------------------------------

def _key_mask(B, S, seed, hole):
    """bool [B, S]: row 0 whole, the others ragged (at least S/3 keys);
    ``hole`` also masks a run of keys across a 64-key tile edge."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(S // 3, S + 1, B)
    lengths[0] = S
    mask = np.arange(S)[None, :] < lengths[:, None]
    if hole:
        mask[:, S // 4:S // 4 + 70] = False
    return torch.from_numpy(mask)


@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,D,causal,hole", [
    (torch.bfloat16, 4, 512, 12, 12, 64, False, False),   # BERT-base heads
    (torch.bfloat16, 2, 333, 4, 2, 128, False, True),
    (torch.bfloat16, 2, 256, 4, 2, 64, True, False),
    (torch.float32, 2, 200, 4, 2, 64, False, True),
    (torch.float32, 1, 130, 4, 1, 128, False, False),
])
def test_flash_kernels_with_key_bias_match_plain_versions(dev, dtype, B, S,
                                                          Hq, Hkv, D, causal,
                                                          hole):
    """The three kernels with the key bias against their plain versions on
    the rows whose query is valid (the cotangent is zero elsewhere)."""
    q, k, v, do = _flash_inputs(dev, dtype, B, S, Hq, Hkv, D, seed=S + 2)
    mask = _key_mask(B, S, S, hole).to(dev)
    bias = fa._key_bias(mask)
    do = do * mask[:, :, None, None].to(dtype)
    scale = D ** -0.5
    fa.reset_launches()
    out, lse = fa.flash_fwd(q, k, v, causal, scale, None, bias)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, causal, scale, None, bias)
    _flash_agree(out[mask], ref_out[mask], dtype, grad=False)
    torch.testing.assert_close(lse.transpose(1, 2)[mask].cpu(),
                               ref_lse.transpose(1, 2)[mask].cpu(),
                               rtol=1e-5,
                               atol=1e-5 if dtype == torch.float32 else 1e-3)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, ref_lse, delta.contiguous(), causal, scale, None,
            bias)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    _flash_agree(dq, fa._bwd_dq_blockwise(*args), dtype, grad=True)
    for got, ref in zip((dk, dv), fa._bwd_dkv_blockwise(*args)):
        _flash_agree(got, ref, dtype, grad=True)
    assert fa.launches == dict.fromkeys(fa.launches, 1)
    assert fa.key_bias_launches == dict.fromkeys(fa.launches, 1)


def test_flash_autograd_with_key_padding_runs_the_kernels(dev):
    """flash_attention_fn with a [B, 1, 1, S] mask on CUDA tensors:
    bidirectional, every kernel launched once with the key bias, no plain
    version called; D 96 padded to 128."""
    q, k, v, do = _flash_inputs(dev, torch.float32, 2, 200, 4, 2, 96, 6)
    mask = _key_mask(2, 200, 1, hole=True).to(dev)
    do = do * mask[:, :, None, None]
    grads = []
    for path in ("kernel", "plain"):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        m = mask
        if path == "plain":
            xs = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
            m = mask.cpu()
        fa.reset_launches()
        out = fa.flash_attention_fn(*xs, m[:, None, None, :])
        (out * do.to(out.device)).sum().backward()
        if path == "kernel":
            torch.cuda.synchronize()
            assert fa.key_bias_launches == dict.fromkeys(fa.launches, 1)
            assert fa.plain_calls == dict.fromkeys(fa.plain_calls, 0)
        grads.append([out[m.to(out.device)]] + [t.grad for t in xs])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.cpu(), ref, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# 1x1 convolution with BatchNorm statistics: hvd_conv_bn_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,K,C", [
    (200704, 512, 128),   # ResNet-50's stage-2 1x1 at batch 256 (the spike)
    (1000, 512, 128),     # a ragged N
    (802816, 256, 64),    # stage-1 reduce: half a column block
    (200704, 512, 256),   # stage-3 reduce: two column blocks
    (333, 72, 40),        # K and C off the kernel's tiles
    (1, 8, 8),
])
def test_conv_bn_stats_kernel_matches_plain_version(dev, N, K, C):
    """y within one bf16 ulp of the plain version's plus 1e-5 of the sum
    of its products' magnitudes (both round an fp32 sum of exact bf16
    products once, but the tensor cores and cuBLAS accumulate in other
    orders and alignments, which moves a y that cancels to near zero by
    more than its own ulp); Σy and Σy²
    within 1e-5 of Σ|y| and Σy² (fp32 sums of N terms in other orders:
    per-thread running sums of ~1,500 rows, then the CTA and the G
    partials, against cuBLAS's and torch.sum's orders)."""
    from horovod_tpu_torch.ops import conv_bn_stats as cbs

    gen = torch.Generator(device=dev).manual_seed(N + K + C)
    x = torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((K, C), generator=gen, device=dev)).to(
        torch.bfloat16)
    cbs.reset_launches()
    y, s1, s2 = cbs.conv_stats(x, w)
    torch.cuda.synchronize()
    assert cbs.launches == {"conv_bn_stats": 1}
    assert cbs.plain_calls == {"conv_bn_stats": 0}
    assert y.shape == (N, C) and y.dtype == torch.bfloat16
    ry, r1, r2 = cbs._conv_stats_rows(x, w)
    d = (y.float() - ry.float()).abs()
    mag = x.float().abs() @ w.float().abs()
    assert bool((d <= 2.0 ** -7 * ry.float().abs() + 1e-5 * mag).all()), \
        float(d.max())
    y32 = x.float() @ w.float()
    assert float((s1 - r1).abs().max()) <= 1e-5 * float(
        y32.abs().sum(0).max())
    assert bool(((s2 - r2).abs() <= 1e-5 * r2).all())
    _, mean, var = cbs.conv_bn_stats(x, w)
    torch.testing.assert_close(mean, r1 / N, rtol=0, atol=1e-5)
    torch.testing.assert_close(var, r2 / N - (r1 / N) ** 2, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("C", [8, 64, 120, 136, 256])
@pytest.mark.parametrize("K", [16, 72, 512, 576, 640])
@pytest.mark.parametrize("N", [1, 127, 128, 129])
def test_conv_bn_stats_tile_edges_match_plain_and_repeat(dev, N, K, C):
    """B7 at its tiles' edges: N around one 128-row tile, K from one
    16-step to MAX_K (4, 3 and 2 ring stages at K 512, 576 and 640; 72 a
    partial 64-k chunk), C inside, at and past 128-channel column blocks.
    y and Σy at the tolerances of the test above; Σy² within 1e-5 of
    itself plus what y's own e = 1e-5·Σ_k|x_k·w_k| term allows each of
    its terms (2·|y|·e + e²: with one row, Σy² is one y², and a y that
    cancels to near zero moves by more than its ulp, as the y tolerance
    says); a
    second run bitwise equal to the first (fixed-order sums, no
    atomics)."""
    from horovod_tpu_torch.ops import conv_bn_stats as cbs

    gen = torch.Generator(device=dev).manual_seed(N * 1000 + K + C)
    x = torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((K, C), generator=gen, device=dev)).to(
        torch.bfloat16)
    cbs.reset_launches()
    y, s1, s2 = cbs.conv_stats(x, w)
    y2, t1, t2 = cbs.conv_stats(x, w)
    torch.cuda.synchronize()
    assert cbs.launches == {"conv_bn_stats": 2}
    assert y.shape == (N, C) and y.dtype == torch.bfloat16
    ry, r1, r2 = cbs._conv_stats_rows(x, w)
    d = (y.float() - ry.float()).abs()
    mag = x.float().abs() @ w.float().abs()
    assert bool((d <= 2.0 ** -7 * ry.float().abs() + 1e-5 * mag).all()), \
        float(d.max())
    y32 = x.float() @ w.float()
    assert float((s1 - r1).abs().max()) <= 1e-5 * float(
        y32.abs().sum(0).max())
    slack = (2e-5 * y32.abs() * mag + 1e-10 * mag * mag).sum(0)
    assert bool(((s2 - r2).abs() <= 1e-5 * r2 + slack).all()), \
        float(((s2 - r2).abs() / (1e-5 * r2 + slack)).max())
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.parametrize("N,K,C", [(200704, 512, 128), (802816, 256, 64)])
def test_conv_bn_stats_sums_repeat_bitwise_at_full_size(dev, N, K, C):
    """Across every persistent CTA: two runs give the same y, Σy and Σy²
    bit for bit."""
    from horovod_tpu_torch.ops import conv_bn_stats as cbs

    gen = torch.Generator(device=dev).manual_seed(N + K)
    x = torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((K, C), generator=gen, device=dev)).to(
        torch.bfloat16)
    a = cbs.conv_stats(x, w)
    b = cbs.conv_stats(x, w)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_conv_bn_stats_rejects_what_it_cannot_run(dev):
    from horovod_tpu_torch.ops import conv_bn_stats as cbs

    x = torch.randn((64, 64), device=dev).to(torch.bfloat16)
    w = torch.randn((64, 16), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cbs.conv_stats(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        cbs.conv_stats(x.t(), w)
    with pytest.raises(ValueError, match="shared memory"):
        cbs.conv_stats(torch.zeros((4, 1024), dtype=torch.bfloat16,
                                   device=dev),
                       torch.zeros((1024, 8), dtype=torch.bfloat16,
                                   device=dev))


def test_conv_bn_spike_check_on_the_card(dev):
    """The spike counterpart's own check at its shape: the kernel against
    F.conv2d + fp32 statistics, the reference spike's tolerances."""
    from horovod_tpu_torch.experiments import conv_bn_spike

    conv_bn_spike.check(*conv_bn_spike.make_inputs(dev))


# ---------------------------------------------------------------------------
# The eager engine's staging of CUDA tensors (runtime/staging.py)
# ---------------------------------------------------------------------------

ENGINE_DTYPES = [torch.uint8, torch.int8, torch.int16, torch.int32,
                 torch.int64, torch.float16, torch.float32, torch.float64,
                 torch.bool, torch.bfloat16]


@pytest.fixture
def engine(dev, monkeypatch):
    """The port's engine at size 1 (enqueued directly: the eager ops are
    identities at size 1, the engine itself still runs its collectives)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.runtime.engine import get_engine

    for name in (basics._RANK_ENV + basics._SIZE_ENV + basics._LOCAL_RANK_ENV
                 + basics._LOCAL_SIZE_ENV + ("HOROVOD_COORDINATOR",)):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cuda")
    yield get_engine()
    hvd.shutdown()


def _seeded(dtype, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen).bool()
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape,
                         generator=gen).to(dtype)


def _bits(t):
    return bytes(t.detach().cpu().contiguous().view(torch.uint8).numpy())


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("dtype", ENGINE_DTYPES)
def test_staging_every_dtype_matches_the_cpu_path(engine, dev, dtype,
                                                  contiguous):
    """A CUDA tensor (contiguous or a transposed view) staged through the
    pinned pool, through the engine and back gives the bytes its CPU copy
    gives through the same engine."""
    from horovod_tpu_torch.runtime import staging

    x = _seeded(dtype, (37, 24), 5).to(dev)
    if not contiguous:
        x = x.t()
    (host, lease), = staging.to_host([x])
    assert host.is_pinned() and _bits(host) == _bits(x)
    name = f"stage.{dtype}.{contiguous}"
    got = engine.synchronize(engine.enqueue_allreduce(host, name=name))
    back = staging.to_device(got, lease, x.device)
    want = engine.synchronize(engine.enqueue_allreduce(
        x.cpu().contiguous(), name=name + ".cpu"))
    assert back.device == x.device and _bits(back) == _bits(want)


def test_staging_waits_on_the_ready_event(engine, dev):
    """Staged right behind a GEMM that writes the tensor on the current
    stream, the host copy holds the GEMM's result, not the NaNs before it."""
    from horovod_tpu_torch.runtime import staging

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(4096, 4096, generator=gen, device=dev)
    b = torch.randn(4096, 4096, generator=gen, device=dev)
    x = torch.full((4096, 4096), float("nan"), device=dev)
    torch.cuda.synchronize()
    torch.matmul(a, b, out=x)
    (host, lease), = staging.to_host([x])
    assert torch.isfinite(host).all()
    torch.cuda.synchronize()
    assert _bits(host) == _bits(x)
    staging.pool().give(lease)


def test_staging_a_batch_waits_for_every_gather(engine, dev):
    """One ``to_host`` call stages a contiguous tensor and two transposed
    views, each written by a GEMM on the current stream just before: the
    gathers that make the views contiguous are queued after the first
    tensor, and the side stream must wait for all of them.  A long GEMM
    on a stream of higher priority holds the SMs meanwhile, so a gather
    starts late while the copy engine does not, and the blocks the
    gathers land in held NaNs before.  The host copies and their
    allreduce through the engine match, bit for bit, the CPU path of the
    same tensors."""
    from horovod_tpu_torch.runtime import staging

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(4096, 4096, generator=gen, device=dev)
    b = torch.randn(4096, 4096, generator=gen, device=dev)
    # bf16: cuBLAS's Hopper GEMM fills an SM's registers, so no gather
    # block fits beside it.
    big = torch.randn(16384, 16384, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    scaled = [b * (i + 1) for i in range(3)]
    outs = [torch.full((4096, 4096), float("nan"), device=dev)
            for _ in range(3)]
    busy = torch.cuda.Stream(priority=-1)   # its blocks go first

    def views():
        return [outs[0], outs[1].t(), outs[2].t()]

    # Warm-up: the pool holds pinned buffers of these sizes, and the
    # gather's and the hog's kernels are loaded.  A first allocation or
    # launch may wait for the card, which would hide the race.
    with torch.cuda.stream(busy):
        torch.matmul(big, big)
    for _, lease in staging.to_host(views()):
        staging.pool().give(lease)
    torch.cuda.synchronize()
    for _ in range(2):
        stale = [torch.full((4096, 4096), float("nan"), device=dev)
                 for _ in range(2)]
        torch.cuda.synchronize()
        del stale           # their blocks take the gathers' outputs
        for o, bi in zip(outs, scaled):
            torch.matmul(a, bi, out=o)
        busy.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(busy):
            hog = torch.matmul(big, big)
        staged = staging.to_host(views())
        torch.cuda.synchronize()
        del hog
        for t, (host, lease) in zip(views(), staged):
            assert torch.isfinite(host).all() and _bits(host) == _bits(t)
            got = engine.synchronize(engine.enqueue_allreduce(host))
            want = engine.synchronize(engine.enqueue_allreduce(
                t.cpu().contiguous()))
            assert _bits(got) == _bits(want)
            staging.pool().give(lease)


def test_staging_copies_under_the_tensors_device_guard(engine, dev,
                                                       monkeypatch):
    """Every staging copy runs under ``torch.cuda.device(t.device)`` and on
    that device's streams, whatever the current device is.  One card
    cannot show a fault across devices, so the guard's use is checked
    directly: ``torch.cuda.device`` and ``current_stream`` are wrapped,
    and each guard staging enters and each stream it asks for must be the
    tensor's device's."""
    from horovod_tpu_torch.runtime import staging

    entered, asked = [], []
    real_current = torch.cuda.current_stream

    class guard(torch.cuda.device):     # torch checks isinstance against it
        def __init__(self, d):
            if d is not None:           # None: torch's own calls
                entered.append(torch.device("cuda", d) if isinstance(d, int)
                               else torch.device(d))
            super().__init__(d)

    def current_stream(device=None):
        if device is not None:      # None: torch's own calls
            asked.append(torch.device(device))
        return real_current(device)

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    x = torch.arange(12, dtype=torch.float32, device=dev)
    (host, lease), = staging.to_host([x])
    back = staging.to_device(host, lease, x.device)
    torch.cuda.synchronize()
    assert len(entered) >= 3 and len(asked) >= 2
    assert all(d.index == x.device.index for d in entered + asked)
    assert staging.pool().stream(x.device).device == x.device
    assert torch.equal(back, x)


def test_result_copy_runs_on_the_callers_stream(engine, dev):
    """The host-to-device copy of a result is ordered on the caller's
    current stream; its pinned buffer returns to the pool behind it."""
    from horovod_tpu_torch.runtime import staging

    x = torch.randn(1 << 20, device=dev)
    (host, lease), = staging.to_host([x])
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        back = staging.to_device(host, lease, x.device)
        y = back * 2
    side.synchronize()
    assert torch.equal(y, x * 2)


def test_pinned_pool_reuses_its_buffers(engine, dev):
    from horovod_tpu_torch.runtime import staging

    x = torch.randn(3, 1000, device=dev)
    before = staging.stats()
    for _ in range(4):
        (host, lease), = staging.to_host([x])
        staging.to_device(host, lease, x.device)
        torch.cuda.synchronize()
    after = staging.stats()
    assert after["pinned_allocs"] - before["pinned_allocs"] <= 1
    assert after["pinned_reuses"] - before["pinned_reuses"] >= 3
    assert after["d2h_copies"] - before["d2h_copies"] == 4
    assert after["h2d_copies"] - before["h2d_copies"] == 4
    assert after["d2h_bytes"] - before["d2h_bytes"] == 4 * x.numel() * 4
