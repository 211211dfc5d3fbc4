"""Fused RMSNorm, forward and backward.

Counterpart of ``horovod_tpu/ops/rms_norm.py``: ``y = x·rstd·scale`` over
the last dim with fp32 statistics and an fp32 scale, the result in
``out_dtype``; the backward recomputes ``x̂ = x·rstd`` from the saved
rstd and gives ``dx = rstd·(dy·s − x̂·mean_H(dy·s·x̂))`` plus one partial
``Σ dy·x̂`` per row block, which the caller sums (a plain ``torch.sum``,
as the reference's ``jnp.sum`` outside its kernel).

Two kernels, each with two implementations chosen by the tensors' device:

* on CUDA tensors, the hand-written Hopper kernels of ``csrc/rms_norm.cu``
  (``hvd_rms_fwd``, ``hvd_rms_bwd``; built with nvcc at first use by
  ``ops/_build.py``) — or an exception, never a quiet fallback;
* on CPU tensors, the plain PyTorch versions :func:`_fwd_rows` and
  :func:`_bwd_rows`, which walk the backward kernel's row blocks in its
  order.  The CPU tests hold them against the JAX package's Pallas
  kernels, and ``chip_smoke.py`` holds the CUDA kernels against them.

Wider than the reference: its kernel runs only for ``H % 128 == 0`` and
``R % 8 == 0`` (plain XLA math otherwise); these kernels take any R and
any H (a row off the 16-byte vector width is read element by element),
so no shape gives way quietly to the plain version.  rstd is an fp32
``[R]``, not the reference's sublane-replicated ``[8, R]``.

:data:`launches` counts kernel launches (CUDA path only) and
:data:`plain_calls` the plain versions' calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["rms_norm", "launches", "plain_calls", "reset_launches",
           "block_rows"]

_KERNELS = ("rms_fwd", "rms_bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Row blocks of the backward: about two per SM of an H100 (132 SMs), so
#: the grid fills the card and the partial dscale stays ~264 x H floats.
TARGET_BLOCKS = 264
#: Widest row the kernels take: the backward keeps one fp32 partial per
#: column in shared memory.
MAX_H = 48 * 1024

#: Kernel launches by kernel name (plain integers, reset by
#: :func:`reset_launches`).
launches = dict.fromkeys(_KERNELS, 0)
#: Calls of each kernel's plain PyTorch version.
plain_calls = dict.fromkeys(_KERNELS, 0)

_fns = {}


def reset_launches() -> None:
    for name in _KERNELS:
        launches[name] = 0
        plain_calls[name] = 0


def block_rows(R: int) -> int:
    """Rows per block of the backward (each block writes one partial)."""
    return max(1, -(-R // TARGET_BLOCKS))


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _fwd_rows(x: torch.Tensor, scale: torch.Tensor, eps: float,
              out_dtype: torch.dtype):
    """Plain version of ``hvd_rms_fwd``: (y [R, H] in out_dtype, rstd [R]
    fp32) from x [R, H] and scale [H]."""
    plain_calls["rms_fwd"] += 1
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1) + eps)
    y = (x32 * rstd[:, None] * scale.float()).to(out_dtype)
    return y, rstd


def _bwd_rows(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
              dy: torch.Tensor):
    """Plain version of ``hvd_rms_bwd``: (dx [R, H] in x.dtype, partials
    [n_blocks, H] fp32), one partial ``Σ dy·x̂`` per block of
    :func:`block_rows` rows, in the kernel's block order."""
    plain_calls["rms_bwd"] += 1
    R, H = x.shape
    x32, dy32 = x.float(), dy.float()
    xhat = x32 * rstd[:, None]
    dys = dy32 * scale.float()
    m = (dys * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[:, None] * (dys - xhat * m)).to(x.dtype)
    rows = block_rows(R)
    parts = torch.stack([(dy32[r0:r0 + rows] * xhat[r0:r0 + rows]).sum(0)
                         for r0 in range(0, R, rows)])
    return dx, parts


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from horovod_tpu_torch.ops import _build

        fn = getattr(_build.load("rms_norm"), "hvd_" + name)
        n_ptr = {"rms_fwd": 4, "rms_bwd": 6}[name]
        n_int = {"rms_fwd": 2, "rms_bwd": 3}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_float] if name == "rms_fwd" else [])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name, *tensors):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                         "the CUDA device")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    H = tensors[0].shape[-1]
    if H > MAX_H:
        raise ValueError(f"{name}: H = {H} exceeds the kernels' {MAX_H}")


def _launch(name, ptrs, ints, dev, *extra):
    fn = _kernel(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], *ints, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    launches[name] += 1


def _fwd_cuda(x, scale, eps, out_dtype):
    _check_cuda("rms_fwd", x, scale)
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES \
            or scale.dtype != torch.float32:
        raise TypeError(f"rms_fwd: x and out must be float32/bfloat16 and "
                        f"scale float32, got {x.dtype}, {out_dtype}, "
                        f"{scale.dtype}")
    R, H = x.shape
    y = torch.empty((R, H), dtype=out_dtype, device=x.device)
    rstd = torch.empty((R,), dtype=torch.float32, device=x.device)
    _launch("rms_fwd", (x, scale, y, rstd), (R, H), x.device, float(eps),
            _DTYPES[x.dtype], _DTYPES[out_dtype])
    return y, rstd


def _bwd_cuda(x, scale, rstd, dy):
    _check_cuda("rms_bwd", x, scale, rstd, dy)
    if x.dtype not in _DTYPES or dy.dtype not in _DTYPES \
            or scale.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError(f"rms_bwd: x and dy must be float32/bfloat16, scale "
                        f"and rstd float32, got {x.dtype}, {dy.dtype}, "
                        f"{scale.dtype}, {rstd.dtype}")
    R, H = x.shape
    rows = block_rows(R)
    dx = torch.empty_like(x)
    parts = torch.empty((-(-R // rows), H), dtype=torch.float32,
                        device=x.device)
    _launch("rms_bwd", (x, scale, rstd, dy, dx, parts), (R, H, rows),
            x.device, _DTYPES[x.dtype], _DTYPES[dy.dtype])
    return dx, parts


def rms_fwd(x, scale, eps, out_dtype):
    """(y, rstd) — the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return _fwd_rows(x, scale, eps, out_dtype)
    return _fwd_cuda(x, scale, eps, out_dtype)


def rms_bwd(x, scale, rstd, dy):
    """(dx, partials) — the kernel on CUDA tensors, the plain version on
    CPU."""
    if x.device.type == "cpu":
        return _bwd_rows(x, scale, rstd, dy)
    return _bwd_cuda(x, scale, rstd, dy)


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    """y from x [R, H] and scale [H]; saves x, scale and the fp32 rstd
    [R]; the backward gives dx in x's dtype and dscale in scale's."""

    @staticmethod
    def forward(ctx, x, scale, eps, out_dtype):
        s32 = scale.float().contiguous()
        y, rstd = rms_fwd(x, s32, eps, out_dtype)
        ctx.save_for_backward(x, s32, rstd)
        ctx.scale_dtype = scale.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s32, rstd = ctx.saved_tensors
        dx, parts = rms_bwd(x, s32, rstd, dy.contiguous())
        return dx, parts.sum(dim=0).to(ctx.scale_dtype), None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMS-normalise ``x`` [..., H] over its last dim and multiply by
    ``scale`` [H].  Statistics in fp32; output in ``out_dtype`` (default
    ``x.dtype``).  Differentiable in ``x`` and ``scale``."""
    out_dtype = out_dtype or x.dtype
    H = x.shape[-1]
    if scale.shape != (H,):
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} does not "
                         f"match H = {H}")
    lead = x.shape[:-1]
    y = _RMSNorm.apply(x.reshape(-1, H).contiguous(), scale, float(eps),
                       out_dtype)
    return y.reshape(*lead, H)
