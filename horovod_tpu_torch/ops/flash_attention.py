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
  kernels' tiles in the kernels' order with the kernels' roundings (but
  the reference's ``exp``, where the bf16 kernels take 2^x of log2-unit
  scores: a few fp32 ulps of P apart).  The CPU tests
  hold them against the JAX package's Pallas kernels, and
  ``chip_smoke.py`` holds the CUDA kernels against them on the card.

A ``torch.autograd.Function`` ties them together; ``delta = rowsum(dO·O)
- g_lse`` is plain PyTorch, as XLA computes it outside the reference's
kernels, and so are the two sidebands the kernels read, each ``[B, S]``
and not the reference's ``[B, 8, S]`` replica: the segment starts of
packed rows (:func:`_segment_starts`, a cummax over run boundaries; int32,
query row r attends keys ``[start[r], r]``) and the additive key bias of
a key-padding mask (:func:`_key_bias`; fp32, 0 for a valid key and -1e30
for a masked one, added to every score after the scale and the causal
mask, as the reference adds its ``bias_ref``).  A query row whose every
key is masked gives undefined output, as in the reference.
Differences from the reference, none of which changes a result beyond
fp32 reassociation: GQA is native (query head ``h`` reads KV
head ``h // G``; K/V are never repeated, and dK/dV sum the group in fp32
inside the kernel); a sequence off the tile is masked in the kernel, not
padded to 128 (a packed row is not padded with a fresh trailing segment
either); lse is ``[B, H, S]``, not sublane-replicated.  Head dims
other than 64 and 128 are zero-padded to the next multiple of 64 with the
true ``1/sqrt(D)`` threaded through as ``sm_scale``, as the reference
does.  On CUDA tensors D is at most 128 (the kernels' widest tile; a
wider head raises, and :func:`flash_lse_supported` says so); the plain
versions take any D.

:data:`launches` counts kernel launches per kernel (CUDA path only),
:data:`key_bias_launches` those of them that carried the key bias, and
:data:`plain_calls` the plain versions' calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes
import math
import threading
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "flash_attention_fn", "flash_attention_lse",
           "flash_lse_supported", "fallback_count", "launches",
           "key_bias_launches", "plain_calls", "reset_launches"]

_NEG_INF = -1e30   # the reference kernels' mask value and initial max
_TINY = 1e-30      # the reference's floor on the softmax denominator

#: The kernels' tiles, by input dtype (bf16 runs the Hopper wgmma kernels,
#: fp32 the FMA ones).  The plain versions walk the same tiles, so both
#: skip the same causal tiles and take the online softmax's steps (and
#: dQ's sums) at the same keys.  Forward and dQ: (query rows per work
#: item, keys per step); dK/dV: (keys per work item, query rows per step).
FWD_TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
DQ_TILES = {torch.bfloat16: (128, 64), torch.float32: (64, 64)}
DKV_TILES = {torch.bfloat16: (128, 64), torch.float32: (64, 32)}

_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)

#: Kernel launches by kernel name (plain integers, reset by
#: :func:`reset_launches`).
launches = dict.fromkeys(_KERNELS, 0)
#: The launches that carried the key bias.
key_bias_launches = dict.fromkeys(_KERNELS, 0)
#: Calls of each kernel's plain PyTorch version.
plain_calls = dict.fromkeys(_KERNELS, 0)

_fns = {}
_fallbacks: dict = {}
_fallbacks_lock = threading.Lock()


def reset_launches() -> None:
    for name in _KERNELS:
        launches[name] = 0
        key_bias_launches[name] = 0
        plain_calls[name] = 0


def fallback_count() -> int:
    """Times a composing caller chose a non-kernel attention path (ring
    attention's dense blockwise hop on CPU tensors,
    ``parallel/ring_attention.py``),
    summed over every reason; :func:`flash_attention` itself always runs
    the kernels.  The reference counts each traced fallback; an eager
    caller counts each call."""
    with _fallbacks_lock:
        return sum(_fallbacks.values())


def _note_fallback(reason: str) -> None:
    """Count a non-kernel path taken for ``reason``; warn once a reason."""
    with _fallbacks_lock:
        first = reason not in _fallbacks
        _fallbacks[reason] = _fallbacks.get(reason, 0) + 1
    if first:
        warnings.warn("flash kernel not used: " + reason, RuntimeWarning,
                      stacklevel=3)


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


def _tiles(table, dtype):
    """The tiles of ``table`` (FWD_TILES, DQ_TILES or DKV_TILES) for
    inputs of ``dtype``; any dtype without a bf16 kernel walks the fp32
    kernel's."""
    return table.get(dtype, table[torch.float32])


def _causal_first_row(k0: int, block_m: int) -> int:
    """First query row whose tile reaches the key tile starting at ``k0``:
    query tile i walks the key tiles j < ceil((i+1)·block_m / block_n)."""
    return (k0 // block_m) * block_m


def _mask(s, q0, q1, k0, k1, causal, seg, bias=None):
    """Scores s [B, Hkv, (G,) q1-q0, k1-k0] with the masked pairs at -1e30:
    keys after the query (causal) and keys before the query's segment
    start (``seg`` [B, S] int32, or None); then the key bias (``bias``
    [B, S] fp32, or None) added, after the causal mask, as the reference
    adds it.  Vectorised over B, so each batch row takes its own segment
    bounds and key bias."""
    cols = torch.arange(k0, k1, device=s.device)
    keep = None
    if causal:
        rows = torch.arange(q0, q1, device=s.device)
        keep = rows[:, None] >= cols[None, :]
    if seg is not None:
        st = cols >= seg[:, q0:q1, None]              # [B, q1-q0, k1-k0]
        st = st[:, None] if s.dim() == 4 else st[:, None, None]
        keep = st if keep is None else keep & st
    if keep is not None:
        s = torch.where(keep, s, _NEG_INF)
    if bias is not None:
        kb = bias[:, k0:k1]
        s = s + (kb[:, None, None] if s.dim() == 4 else kb[:, None, None, None])
    return s


def _scores(qf, kf, r0, k0, k1, causal, sm_scale, seg, bias=None):
    """Masked fp32 scores [B, Hkv, G, S-r0, k1-k0], scaled after the dot."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf[..., r0:, :],
                     kf[:, :, k0:k1]) * sm_scale
    return _mask(s, r0, qf.shape[3], k0, k1, causal, seg, bias)


def _fwd_blockwise(q, k, v, causal: bool, sm_scale: float, seg=None,
                   bias=None, tiles=None):
    """Plain version of ``hvd_flash_fwd``: (out [B, S, Hq, D] in q.dtype,
    lse [B, Hq, S] fp32).  Online softmax over block_n-key tiles; rows of
    query tiles the causal loop bound excludes are not touched.  P is
    rounded to v.dtype before P·V.  ``tiles``: (block_m, block_n), by
    default the kernel's for q's dtype (:data:`FWD_TILES`).

    With segment starts ``seg``, the key tiles the kernel skips below a
    query tile's first start are masked here instead.  That gives the same
    bits: until a row meets its first valid key its running max stays at
    -1e30, and the first valid tile's ``alpha = exp(-1e30 - m)`` is exactly
    0, which wipes what the masked tiles added to l and acc.  The key bias
    ``bias`` ([B, S] fp32, or None) masks no tile: every tile is walked."""
    plain_calls["flash_fwd"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    block_m, block_n = tiles or _tiles(FWD_TILES, q.dtype)
    qf, kf, vf = _heads(q, Hkv), _kv(k), _kv(v)
    m = torch.full(qf.shape[:-1], _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, block_n):
        k1 = min(S, k0 + block_n)
        r0 = _causal_first_row(k0, block_m) if causal else 0
        s = _scores(qf, kf, r0, k0, k1, causal, sm_scale, seg, bias)
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
                      sm_scale: float, seg=None, bias=None, tiles=None):
    """Plain version of ``hvd_flash_bwd_dq``: dq [B, S, Hq, D] in q.dtype.
    dS = P·(dO·Vᵀ − delta)·scale, rounded to k.dtype before dS·K, summed
    over block_n-key steps in key order; rows of query tiles the causal
    loop bound excludes are not touched.  A masked pair has P = exp(-1e30
    - lse) = 0, so the tiles the kernel skips below a segment start add
    exact zeros here.  ``tiles``: (block_m, block_n), by default the
    kernel's for q's dtype (:data:`DQ_TILES`)."""
    plain_calls["flash_bwd_dq"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf, dof, kf, vf = _heads(q, Hkv), _heads(dout, Hkv), _kv(k), _kv(v)
    lse = lse.reshape(B, Hkv, Hq // Hkv, S)
    delta = delta.reshape(B, Hkv, Hq // Hkv, S)
    block_m, block_n = tiles or _tiles(DQ_TILES, q.dtype)
    dq = torch.zeros_like(qf)
    for k0 in range(0, S, block_n):
        k1 = min(S, k0 + block_n)
        r0 = _causal_first_row(k0, block_m) if causal else 0
        s = _scores(qf, kf, r0, k0, k1, causal, sm_scale, seg, bias)
        p = torch.exp(s - lse[..., r0:, None])
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof[..., r0:, :],
                          vf[:, :, k0:k1])
        ds = (p * (dp - delta[..., r0:, None]) * sm_scale).to(k.dtype)
        dq[..., r0:, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds.float(),
                                        kf[:, :, k0:k1])
    return _rows(dq.to(q.dtype), B, S, Hq, D)


def _bwd_dkv_blockwise(q, k, v, dout, lse, delta, causal: bool,
                       sm_scale: float, seg=None, bias=None, tiles=None):
    """Plain version of ``hvd_flash_bwd_dkv``: (dk, dv) [B, S, Hkv, D] in
    k/v's dtype.  For each query head of the group, then each
    block_q-row query tile, every key block at or left of the diagonal
    accumulates dV += Pᵀ·dO (P rounded to dout.dtype) and dK += dSᵀ·Q (dS
    rounded to q.dtype), in fp32 across the whole group.  With segment
    starts, the query tiles the kernel skips past the last row that sees a
    key block are masked here (P = 0: exact zeros).  ``tiles``: (block_n
    keys per CTA, block_q query rows per step), by default the kernel's
    for q's dtype (:data:`DKV_TILES`)."""
    plain_calls["flash_bwd_dkv"] += 1
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    block_n, block_q = tiles or _tiles(DKV_TILES, q.dtype)
    qf, dof, kf, vf = _heads(q, Hkv), _heads(dout, Hkv), _kv(k), _kv(v)
    lse = lse.reshape(B, Hkv, G, S)
    delta = delta.reshape(B, Hkv, G, S)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for gi in range(G):
        for q0 in range(0, S, block_q):
            q1 = min(S, q0 + block_q)
            # Key block j walks query tiles from floor(j·block_n /
            # block_q), so this query tile reaches key blocks j <
            # ceil((q0 + block_q) / block_n).
            kv_end = S
            if causal:
                kv_end = min(S, -(-(q0 + block_q) // block_n) * block_n)
            qt, dot = qf[:, :, gi, q0:q1], dof[:, :, gi, q0:q1]
            s = torch.einsum("bhqd,bhkd->bhqk", qt, kf[:, :, :kv_end])
            s = _mask(s * sm_scale, q0, q1, 0, kv_end, causal, seg, bias)
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
        n_ptr = {"flash_fwd": 7, "flash_bwd_dq": 9, "flash_bwd_dkv": 10}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name, seg, bias, q, k, v, *rest):
    tensors = (q, k, v) + rest + tuple(t for t in (seg, bias)
                                       if t is not None)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                         "the CUDA device")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if seg is not None and (seg.dtype != torch.int32
                            or seg.shape != q.shape[:2]):
        raise TypeError(f"{name}: segment starts must be int32 [B, S], got "
                        f"{seg.dtype} {tuple(seg.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != q.shape[:2]):
        raise TypeError(f"{name}: the key bias must be float32 [B, S], got "
                        f"{bias.dtype} {tuple(bias.shape)}")
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


def _launch(name, ptrs, seg, bias, q, k, causal, sm_scale):
    B, S, Hq, D = q.shape
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs],
                 *[None if t is None else t.data_ptr() for t in (seg, bias)],
                 B, S, Hq, k.shape[2], D, float(sm_scale), int(causal),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    launches[name] += 1
    if bias is not None:
        key_bias_launches[name] += 1


def _fwd_cuda(q, k, v, causal, sm_scale, seg=None, bias=None):
    _check_cuda("flash_fwd", seg, bias, q, k, v)
    B, S, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, out, lse), seg, bias, q, k, causal,
            sm_scale)
    return out, lse


def _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, sm_scale, seg=None,
                 bias=None):
    _check_cuda("flash_bwd_dq", seg, bias, q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, dout, lse, delta, dq), seg, bias, q, k,
            causal, sm_scale)
    return dq


def _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, sm_scale, seg=None,
                  bias=None):
    _check_cuda("flash_bwd_dkv", seg, bias, q, k, v, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), seg, bias,
            q, k, causal, sm_scale)
    return dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_fwd(q, k, v, causal, sm_scale, seg=None, bias=None):
    """(out, lse) — the kernel on CUDA tensors, the plain version on CPU.
    ``seg``: optional int32 [B, S] segment starts (packed causal rows);
    ``bias``: optional fp32 [B, S] additive key bias (key padding)."""
    if _on_cpu(q):
        return _fwd_blockwise(q, k, v, causal, sm_scale, seg, bias)
    return _fwd_cuda(q, k, v, causal, sm_scale, seg, bias)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale, seg=None,
                 bias=None):
    if _on_cpu(q):
        return _bwd_dq_blockwise(q, k, v, dout, lse, delta, causal,
                                 sm_scale, seg, bias)
    return _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, sm_scale, seg,
                        bias)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale, seg=None,
                  bias=None):
    if _on_cpu(q):
        return _bwd_dkv_blockwise(q, k, v, dout, lse, delta, causal,
                                  sm_scale, seg, bias)
    return _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, sm_scale, seg,
                         bias)


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """(out, lse) with the backward kernels; the lse cotangent folds into
    delta (dL/ds = p·(dp − delta + g_lse)), so both outputs differentiate
    through the same two kernels.  The sidebands ``seg`` (segment starts)
    and ``bias`` (key bias), each a tensor or None, are not
    differentiable: the bias encodes a constant mask, and the reference
    gives it a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, seg, bias, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, seg, bias)
        ctx.save_for_backward(q, k, v, out, lse, seg, bias)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, g_lse):
        q, k, v, out, lse, seg, bias = ctx.saved_tensors
        dout = (torch.zeros_like(out) if dout is None
                else dout.to(out.dtype).contiguous())
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.sm_scale, seg,
                bias)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


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


def _segment_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids (contiguous runs) -> [B, S] int32 index of each
    position's segment start, by a cummax over run boundaries: a new run
    starts wherever the id changes, so an id that recurs after a gap is a
    new segment."""
    B, S = segment_ids.shape
    pos = torch.arange(S, dtype=torch.int32, device=segment_ids.device)
    change = torch.ones((B, S), dtype=torch.bool, device=segment_ids.device)
    change[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.where(change, pos, torch.zeros_like(pos))
    return torch.cummax(starts, dim=1).values.contiguous()


def _key_mask(mask, q) -> torch.Tensor:
    """A key-padding mask as bool [B, S] (True = attend): given as [B, S]
    or in the encoder's [B, 1, 1, S] form; any other shape raises, as the
    reference's adapter does."""
    B, S = q.shape[:2]
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        mask = mask[:, 0, 0, :]
    elif mask.dim() != 2:
        raise NotImplementedError(
            "flash attention supports key-padding masks ([B, S] or "
            f"[B, 1, 1, S]); got shape {tuple(mask.shape)} — use the dense "
            "attention path for richer mask structures")
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"flash_attention: key-padding mask "
                         f"{tuple(mask.shape)} does not match [B, S] = "
                         f"{(B, S)}")
    return mask.to(device=q.device, dtype=torch.bool)


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    """The kernels' additive key bias from a bool [B, S] mask: fp32, 0
    where a key is attended and -1e30 where it is masked, as the reference
    builds it (``flash_attention.py:749``)."""
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    return bias.masked_fill_(~mask, _NEG_INF)


def _attend(q, k, v, causal, sm_scale, seg=None, bias=None):
    """(out, lse): D off {64, 128} is zero-padded to the next multiple of
    64 (zero dims change no score) with the true head dim's scale kept as
    ``sm_scale``; autograd slices the grads back.  D > 128 raises on
    CUDA tensors.  ``seg``: int32 [B, S] segment starts, or None;
    ``bias``: fp32 [B, S] key bias, or None."""
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
                            seg, bias, bool(causal), float(sm_scale))
    return out[..., :D], lse


def flash_attention(q, k, v, *, causal: bool = True, key_padding_mask=None,
                    segment_ids=None, _sm_scale: Optional[float] = None):
    """Flash attention on q [B, S, Hq, D], k/v [B, S, Hkv, D] (Hq a
    multiple of Hkv); returns [B, S, Hq, D] in q's dtype.  Any S (the
    kernels mask the tail); D up to 128 on CUDA tensors (padded as
    above), any D on CPU tensors.

    ``key_padding_mask``: optional bool [B, S] (or [B, 1, 1, S]; True =
    attend to that key) — BERT-style padding, through an O(S) additive
    key-bias sideband; with ``causal=False`` (bidirectional) as BERT uses
    it, or causal.  A query row whose every key is masked gives undefined
    output, as in the reference: callers must not consume such rows.
    ``segment_ids``: optional [B, S] integer ids of contiguous packed
    sequences (causal only, exclusive with the padding mask): each query
    attends only within its own segment — block-diagonal causal attention
    for packed pretraining, through an O(S) sideband of segment starts,
    with the fully masked tiles skipped."""
    if segment_ids is not None:
        if not causal:
            raise NotImplementedError(
                "segment_ids implies packed causal attention; bidirectional"
                " segment masking is not supported")
        if key_padding_mask is not None:
            raise NotImplementedError(
                "segment_ids and key_padding_mask are mutually exclusive "
                "(mark padding as its own trailing segment instead)")
    seg = bias = None
    if segment_ids is not None:
        _check_segments(segment_ids, q)
        seg = _segment_starts(segment_ids.to(q.device))
    elif key_padding_mask is not None:
        bias = _key_bias(_key_mask(key_padding_mask, q))
    return _attend(q, k, v, causal, _sm_scale, seg, bias)[0]


def _check_segments(segment_ids, q):
    if tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(f"flash_attention: segment_ids "
                         f"{tuple(segment_ids.shape)} do not match "
                         f"[B, S] = {tuple(q.shape[:2])}")


def segment_attention_fn(segment_ids):
    """The model's ``attention_fn`` for packed rows: what
    ``flash_attention(q, k, v, causal=True, segment_ids=segment_ids)``
    computes, with the segment starts computed once here and shared by
    every layer that calls it."""
    starts = _segment_starts(segment_ids)

    def fn(q, k, v, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "segment_ids and key_padding_mask are mutually exclusive "
                "(mark padding as its own trailing segment instead)")
        _check_segments(starts, q)
        return _attend(q, k, v, True, None, starts.to(q.device))[0]
    return fn


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
    """Adapter for the model's ``attention_fn`` seam.  ``mask`` follows
    the model zoo's convention (a [B, 1, 1, S] or [B, S] key-padding mask,
    True = attend; what ``BertEncoder`` passes): with a mask the attention
    is bidirectional and key-masked (BERT semantics); without one it is
    causal (decoder semantics) — so a bidirectional caller with nothing to
    mask passes an all-ones mask.  Other mask shapes raise
    ``NotImplementedError``, as in the reference."""
    if mask is None:
        return flash_attention(q, k, v, causal=True, **kwargs)
    return flash_attention(q, k, v, causal=False, key_padding_mask=mask,
                           **kwargs)
