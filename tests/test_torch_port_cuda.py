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


def _flash_agree(got, ref, dtype, grad):
    """fp32: the reference's 2e-5 (out) / 5e-4 (grads).  bf16: out within
    2 bf16 ULPs of max(1, |ref|); grads within 3e-2 of each tensor's max
    (dS is rounded to bf16 before two products, so errors scale with the
    tensor, not the element)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        tol = 5e-4 if grad else 2e-5
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    elif grad:
        assert float((got - ref).abs().max()) <= \
            3e-2 * float(ref.abs().max())
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
