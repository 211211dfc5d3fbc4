"""Flash attention, forward and backward, on the ``[B, S, H, D]`` layout.

Counterpart of ``horovod_tpu/ops/flash_attention.py`` (FlashAttention-2:
an fp32 online softmax over key tiles, so the ``[S, S]`` score matrix
never exists; the backward recomputes probabilities from the saved
log-sum-exp, dQ in one pass over key tiles and dK/dV in another over
query tiles).  The public surface is the reference's:
:func:`flash_attention`, :func:`flash_attention_fn`,
:func:`flash_attention_lse`, :func:`flash_lse_supported` and
:func:`fallback_count`.

Three functions, each with two implementations chosen by the tensors'
device:

* on CUDA tensors, the hand-written Hopper kernels of
  ``csrc/flash_attention.cu`` (``hvd_flash_fwd``, ``hvd_flash_bwd_dq``,
  ``hvd_flash_bwd_dkv``; built with nvcc at first use by ``ops/_build.py``)
  — or an exception, never a quiet fallback;
* on CPU tensors, the plain PyTorch versions :func:`_fwd_blockwise`,
  :func:`_bwd_dq_blockwise` and :func:`_bwd_dkv_blockwise`, which walk the
  kernels' tiles in the kernels' order with the kernels' roundings.  The
  CPU tests hold them against the JAX package's Pallas kernels, and
  ``chip_smoke.py`` holds the CUDA kernels against them on the card.

A ``torch.autograd.Function`` ties them together; ``delta = rowsum(dO·O)
- g_lse`` is plain PyTorch, as XLA computes it outside the reference's
kernels.  Differences from the reference, none of which changes a
result beyond fp32 reassociation: GQA is native (query head ``h`` reads KV
head ``h // G``; K/V are never repeated, and dK/dV sum the group in fp32
inside the kernel); a sequence off the tile is masked in the kernel, not
padded to 128; lse is ``[B, H, S]``, not sublane-replicated.  Head dims
other than 64 and 128 are zero-padded to the next multiple of 64 with the
true ``1/sqrt(D)`` threaded through as ``sm_scale``, as the reference
does.  On CUDA tensors D is at most 128 (the kernels' widest tile; a
wider head raises, and :func:`flash_lse_supported` says so); the plain
versions take any D.

:data:`launches` counts kernel launches per kernel (CUDA path only) and
:data:`plain_calls` the plain versions' calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "flash_attention_fn", "flash_attention_lse",
           "flash_lse_supported", "fallback_count", "launches",
           "plain_calls", "reset_launches"]

_NEG_INF = -1e30   # the reference kernels' mask value and initial max
_TINY = 1e-30      # the reference's floor on the softmax denominator

#: The kernels' tiles: query rows per CTA and keys per step (forward and
#: dQ), query rows per step of the dK/dV kernel.  The plain versions walk
#: the same tiles, so both skip the same causal tiles.
BLOCK_M = 64
BLOCK_N = 64
BLOCK_Q_DKV = 32

_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)

#: Kernel launches by kernel name (plain integers, reset by
#: :func:`reset_launches`).
launches = dict.fromkeys(_KERNELS, 0)
#: Calls of each kernel's plain PyTorch version.
plain_calls = dict.fromkeys(_KERNELS, 0)

_ROADMAP = ("not ported yet (ROADMAP.md Queue B, 'flash key-padding and "
            "segment sidebands')")
_fns = {}


def reset_launches() -> None:
    for name in _KERNELS:
        launches[name] = 0
        plain_calls[name] = 0


def fallback_count() -> int:
    """Times a composing caller chose a non-kernel attention path.  No
    such caller (ring attention, ...) is ported yet, so this stays 0;
    :func:`flash_attention` itself always runs the kernels."""
    return 0


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, Hkv, G, S, D] (G = H // Hkv)."""
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, S, D).float()


def _kv(x: torch.Tensor) -> torch.Tensor:
    """[B, S, Hkv, D] -> fp32 [B, Hkv, S, D]."""
    return x.permute(0, 2, 1, 3).float()


def _rows(x: torch.Tensor, B: int, S: int, H: int, D: int) -> torch.Tensor:
    """[B, Hkv, G, S, D] (or [B, Hkv, S, D]) -> contiguous [B, S, H, D]."""
    return x.reshape(B, H, S, D).permute(0, 2, 1, 3).contiguous()


def _causal_first_row(k0: int) -> int:
    """First query row whose tile reaches key tile starting at ``k0``: tile
    i walks key tiles j < ceil((i+1)·BLOCK_M / BLOCK_N)."""
    return (k0 // BLOCK_M) * BLOCK_M


def _scores(qf, kf, r0, k0, k1, causal, sm_scale):
    """Masked fp32 scores [B, Hkv, G, S-r0, k1-k0], scaled after the dot."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf[..., r0:, :],
                     kf[:, :, k0:k1]) * sm_scale
    if causal:
        rows = torch.arange(r0, qf.shape[3], device=qf.device)
        cols = torch.arange(k0, k1, device=qf.device)
        s = torch.where(rows[:, None] >= cols[None, :], s, _NEG_INF)
    return s


def _fwd_blockwise(q, k, v, causal: bool, sm_scale: float):
    """Plain version of ``hvd_flash_fwd``: (out [B, S, Hq, D] in q.dtype,
    lse [B, Hq, S] fp32).  Online softmax over BLOCK_N-key tiles; rows of
    query tiles the causal loop bound excludes are not touched.  P is
    rounded to v.dtype before P·V."""
    plain_calls["flash_fwd"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf, kf, vf = _heads(q, Hkv), _kv(k), _kv(v)
    m = torch.full(qf.shape[:-1], _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, BLOCK_N):
        k1 = min(S, k0 + BLOCK_N)
        r0 = _causal_first_row(k0) if causal else 0
        s = _scores(qf, kf, r0, k0, k1, causal, sm_scale)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new[..., None])
        l[..., r0:] = l[..., r0:] * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                          vf[:, :, k0:k1])
        acc[..., r0:, :] = acc[..., r0:, :] * alpha[..., None] + pv
        m[..., r0:] = m_new
    lc = torch.clamp(l, min=_TINY)
    out = _rows((acc / lc[..., None]).to(q.dtype), B, S, Hq, D)
    lse = (m + torch.log(lc)).reshape(B, Hq, S)
    return out, lse


def _bwd_dq_blockwise(q, k, v, dout, lse, delta, causal: bool,
                      sm_scale: float):
    """Plain version of ``hvd_flash_bwd_dq``: dq [B, S, Hq, D] in q.dtype.
    dS = P·(dO·Vᵀ − delta)·scale, rounded to k.dtype before dS·K."""
    plain_calls["flash_bwd_dq"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf, dof, kf, vf = _heads(q, Hkv), _heads(dout, Hkv), _kv(k), _kv(v)
    lse = lse.reshape(B, Hkv, Hq // Hkv, S)
    delta = delta.reshape(B, Hkv, Hq // Hkv, S)
    dq = torch.zeros_like(qf)
    for k0 in range(0, S, BLOCK_N):
        k1 = min(S, k0 + BLOCK_N)
        r0 = _causal_first_row(k0) if causal else 0
        s = _scores(qf, kf, r0, k0, k1, causal, sm_scale)
        p = torch.exp(s - lse[..., r0:, None])
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof[..., r0:, :],
                          vf[:, :, k0:k1])
        ds = (p * (dp - delta[..., r0:, None]) * sm_scale).to(k.dtype)
        dq[..., r0:, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds.float(),
                                        kf[:, :, k0:k1])
    return _rows(dq.to(q.dtype), B, S, Hq, D)


def _bwd_dkv_blockwise(q, k, v, dout, lse, delta, causal: bool,
                       sm_scale: float):
    """Plain version of ``hvd_flash_bwd_dkv``: (dk, dv) [B, S, Hkv, D] in
    k/v's dtype.  For each query head of the group, then each
    BLOCK_Q_DKV-row query tile, every key tile at or left of the diagonal
    accumulates dV += Pᵀ·dO (P rounded to dout.dtype) and dK += dSᵀ·Q (dS
    rounded to q.dtype), in fp32 across the whole group."""
    plain_calls["flash_bwd_dkv"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf, dof, kf, vf = _heads(q, Hkv), _heads(dout, Hkv), _kv(k), _kv(v)
    lse = lse.reshape(B, Hkv, G, S)
    delta = delta.reshape(B, Hkv, G, S)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for gi in range(G):
        for q0 in range(0, S, BLOCK_Q_DKV):
            q1 = min(S, q0 + BLOCK_Q_DKV)
            # Key tile j walks query tiles from floor(j·BLOCK_N / BLOCK_Q),
            # so this query tile reaches key tiles j < ceil((q0 +
            # BLOCK_Q) / BLOCK_N).
            kv_end = S
            if causal:
                kv_end = min(S, -(-(q0 + BLOCK_Q_DKV) // BLOCK_N) * BLOCK_N)
            qt, dot = qf[:, :, gi, q0:q1], dof[:, :, gi, q0:q1]
            s = torch.einsum("bhqd,bhkd->bhqk", qt, kf[:, :, :kv_end])
            s = s * sm_scale
            if causal:
                rows = torch.arange(q0, q1, device=q.device)
                cols = torch.arange(kv_end, device=q.device)
                s = torch.where(rows[:, None] >= cols[None, :], s, _NEG_INF)
            p = torch.exp(s - lse[:, :, gi, q0:q1, None])
            dv[:, :, :kv_end] += torch.einsum(
                "bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dot)
            dp = torch.einsum("bhqd,bhkd->bhqk", dot, vf[:, :, :kv_end])
            ds = (p * (dp - delta[:, :, gi, q0:q1, None]) * sm_scale
                  ).to(q.dtype)
            dk[:, :, :kv_end] += torch.einsum("bhqk,bhqd->bhkd",
                                              ds.float(), qt)
    return (_rows(dk.to(k.dtype), B, S, Hkv, D),
            _rows(dv.to(v.dtype), B, S, Hkv, D))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from horovod_tpu_torch.ops import _build

        fn = getattr(_build.load("flash_attention"), "hvd_" + name)
        n_ptr = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name, q, k, v, *rest):
    tensors = (q, k, v) + rest
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                         "the CUDA device")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, S, Hq, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_KERNEL_HEAD_DIMS} "
                         "(the wrappers pad D up to 128)")
    if B * max(Hq, k.shape[2]) > 65535:
        raise ValueError(f"{name}: B * H = {B * Hq} exceeds the grid's "
                         "65535")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")


def _launch(name, ptrs, q, k, causal, sm_scale):
    B, S, Hq, D = q.shape
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], B, S, Hq, k.shape[2], D,
                 float(sm_scale), int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    launches[name] += 1


def _fwd_cuda(q, k, v, causal, sm_scale):
    _check_cuda("flash_fwd", q, k, v)
    B, S, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, out, lse), q, k, causal, sm_scale)
    return out, lse


def _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, sm_scale):
    _check_cuda("flash_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, dout, lse, delta, dq), q, k, causal,
            sm_scale)
    return dq


def _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, sm_scale):
    _check_cuda("flash_bwd_dkv", q, k, v, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), q, k,
            causal, sm_scale)
    return dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_fwd(q, k, v, causal, sm_scale):
    """(out, lse) — the kernel on CUDA tensors, the plain version on CPU."""
    if _on_cpu(q):
        return _fwd_blockwise(q, k, v, causal, sm_scale)
    return _fwd_cuda(q, k, v, causal, sm_scale)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale):
    if _on_cpu(q):
        return _bwd_dq_blockwise(q, k, v, dout, lse, delta, causal,
                                 sm_scale)
    return _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, sm_scale)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale):
    if _on_cpu(q):
        return _bwd_dkv_blockwise(q, k, v, dout, lse, delta, causal,
                                  sm_scale)
    return _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, sm_scale)


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """(out, lse) with the backward kernels; the lse cotangent folds into
    delta (dL/ds = p·(dp − delta + g_lse)), so both outputs differentiate
    through the same two kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = (torch.zeros_like(out) if dout is None
                else dout.to(out.dtype).contiguous())
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q [B, S, Hq, D] and k/v "
                         f"[B, S, Hkv, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads not a multiple "
                         f"of {k.shape[2]} kv heads")


def _attend(q, k, v, causal, sm_scale):
    """(out, lse): D off {64, 128} is zero-padded to the next multiple of
    64 (zero dims change no score) with the true head dim's scale kept as
    ``sm_scale``; autograd slices the grads back.  D > 128 raises on
    CUDA tensors."""
    _check_shapes(q, k, v)
    D = q.shape[-1]
    if D > _KERNEL_HEAD_DIMS[-1] and not _on_cpu(q):
        raise ValueError(f"flash_attention: head dim {D} > "
                         f"{_KERNEL_HEAD_DIMS[-1]} has no CUDA kernel yet "
                         "(flash_lse_supported gives False for it)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if D not in _KERNEL_HEAD_DIMS:
        pad = (0, -D % 64)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    out, lse = _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            bool(causal), float(sm_scale))
    return out[..., :D], lse


def flash_attention(q, k, v, *, causal: bool = True, key_padding_mask=None,
                    segment_ids=None, _sm_scale: Optional[float] = None):
    """Flash attention on q [B, S, Hq, D], k/v [B, S, Hkv, D] (Hq a
    multiple of Hkv); returns [B, S, Hq, D] in q's dtype.  Any S (the
    kernels mask the tail); D up to 128 on CUDA tensors (padded as
    above), any D on CPU tensors.
    ``key_padding_mask`` and ``segment_ids`` raise ``NotImplementedError``
    on every device: their kernel sidebands are not ported yet."""
    if key_padding_mask is not None:
        raise NotImplementedError("flash_attention: key_padding_mask is "
                                  + _ROADMAP)
    if segment_ids is not None:
        raise NotImplementedError("flash_attention: segment_ids is "
                                  + _ROADMAP)
    return _attend(q, k, v, causal, _sm_scale)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        _sm_scale: Optional[float] = None):
    """``(out [B, S, Hq, D], lse [B, Hq, S] fp32)``; both outputs are
    differentiable (the lse cotangent folds into the backward's delta).
    Wider than the reference's surface: the kernels mask a ragged S, so
    S need not be a multiple of 128."""
    return _attend(q, k, v, causal, _sm_scale)


def flash_lse_supported(S: int, D: int, device=None) -> bool:
    """Whether :func:`flash_attention_lse` runs these shapes on ``device``
    (``None`` means the card, where the port's entry points run): every
    S >= 1 (the reference's S % 128 == 0 is a TPU tiling rule the kernels
    here do not have), and D <= 128 on the card, any D >= 1 on the CPU."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    return S >= 1 and D >= 1 and (on_cpu or D <= _KERNEL_HEAD_DIMS[-1])


def flash_attention_fn(q, k, v, mask=None, **kwargs):
    """Adapter for the model's ``attention_fn`` seam: causal flash
    attention.  A ``mask`` (the reference's key-padding form) raises
    ``NotImplementedError`` until the key-padding sideband is ported."""
    if mask is not None:
        raise NotImplementedError("flash_attention_fn: a key-padding mask "
                                  "is " + _ROADMAP)
    return flash_attention(q, k, v, causal=True, **kwargs)
