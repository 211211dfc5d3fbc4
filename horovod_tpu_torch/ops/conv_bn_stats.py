"""A 1x1 convolution with its BatchNorm statistics in one kernel.

Counterpart of ``experiments/pallas_conv_bn_spike.py``'s
``pallas_conv_stats``: ``y = x · w`` over rows of channels (an NHWC
activation viewed as ``x [N, K]``, the 1x1 kernel as ``w [K, C]``), the
products accumulated in fp32 and ``y`` stored bf16, with the per-channel
``Σy`` and ``Σy²`` of the unrounded fp32 ``y`` over every row; then
``mean = Σy / N`` and ``var = Σy² / N − mean²``, as the spike returns
them.  Nothing on the reference's ResNet path calls it (its convolutions
are XLA's); the port's spike counterpart,
``experiments/conv_bn_spike.py``, runs it.

One kernel with two implementations chosen by the tensors' device:

* on CUDA tensors, the hand-written Hopper kernel of
  ``csrc/conv_bn_stats.cu`` (``hvd_conv_bn_stats``: warp-specialised
  ``wgmma`` fed by TMA, one persistent CTA per SM; built with nvcc at
  first use by ``ops/_build.py``), which writes one fp32 partial of each
  sum per row CTA that :func:`conv_stats` adds up — or an exception,
  never a quiet fallback;
* on CPU tensors, the plain PyTorch version :func:`_conv_stats_rows`
  (an fp32 product, ``y`` rounded to bf16, the sums from the fp32 ``y``).
  The CPU tests hold it against the Pallas kernel in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernel against it.

Shapes, on either device: bf16 ``x [N, K]`` and ``w [K, C]`` with N ≥ 1,
K and C multiples of 8, and K ≤ :data:`MAX_K` (the kernel keeps a
``[K, 128]`` column block of ``w`` in shared memory).  Anything else
raises.  :data:`launches` counts kernel launches (CUDA path only) and
:data:`plain_calls` the plain version's calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = ["conv_bn_stats", "conv_stats", "launches", "plain_calls",
           "reset_launches", "MAX_K", "grid_rows"]

_NAME = "conv_bn_stats"
#: Rows per CTA tile and channels per column block of the kernel.
TILE_ROWS, BLOCK_COLS = 128, 128
#: Largest K: the [K, 128] bf16 column block of w, at least two 16 KB
#: stages of the x ring and the two 16 KB y staging tiles must fit in a
#: CTA's 227 KB of shared memory (``stages_for`` in
#: ``csrc/conv_bn_stats.cu``: 4 stages up to K 512, 3 up to 576, 2 up to
#: 640).
MAX_K = 640

#: Kernel launches (a plain integer per kernel, reset by
#: :func:`reset_launches`).
launches = {_NAME: 0}
#: Calls of the plain PyTorch version.
plain_calls = {_NAME: 0}

_fn = []
_sms = {}


def reset_launches() -> None:
    launches[_NAME] = 0
    plain_calls[_NAME] = 0


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"conv_bn_stats: x [N, K] and w [K, C] expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv_bn_stats: x and w must be bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    N, (K, C) = x.shape[0], w.shape
    if N < 1:
        raise ValueError("conv_bn_stats: the statistics of no rows are "
                         "undefined")
    if K % 8 or C % 8:
        raise ValueError(f"conv_bn_stats: K ({K}) and C ({C}) must be "
                         "multiples of 8 (rows of 16 bytes)")
    if K > MAX_K:
        raise ValueError(f"conv_bn_stats: K = {K} exceeds {MAX_K}: the "
                         "kernel's [K, 128] column block of w must fit in "
                         "shared memory")


def grid_rows(N: int, C: int, sms: int) -> int:
    """Row CTAs of the kernel: about one CTA per SM over all column
    blocks, at most one per 128-row tile.  Each writes one partial."""
    blocks = -(-C // BLOCK_COLS)
    return max(1, min(-(-N // TILE_ROWS), sms // blocks))


# ---------------------------------------------------------------------------
# Plain version (CPU tensors; the reference the kernel is held to)
# ---------------------------------------------------------------------------

def _conv_stats_rows(x: torch.Tensor, w: torch.Tensor):
    """Plain version of ``hvd_conv_bn_stats``: (y [N, C] bf16, Σy [C],
    Σy² [C] fp32) from an fp32 product of the bf16 inputs, y rounded once
    to bf16, the sums taken over the fp32 y."""
    plain_calls[_NAME] += 1
    y = x.float() @ w.float()
    return y.to(torch.bfloat16), y.sum(0), (y * y).sum(0)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _kernel():
    if not _fn:
        from horovod_tpu_torch.ops import _build

        fn = _build.load(_NAME).hvd_conv_bn_stats
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _cuda(x: torch.Tensor, w: torch.Tensor):
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("conv_bn_stats: the CUDA kernel needs x and w on "
                         "the CUDA device")
    if x.device != w.device:
        raise ValueError("conv_bn_stats: x and w on different devices")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv_bn_stats: x and w must be contiguous "
                             "and 16-byte aligned")
    N, (K, C) = x.shape[0], w.shape
    dev = x.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    G = grid_rows(N, C, _sms[dev])
    y = torch.empty((N, C), dtype=torch.bfloat16, device=dev)
    parts = torch.empty((2, G, C), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), parts.data_ptr(),
                 N, K, C, G, stream)
    if err != 0:
        raise RuntimeError(f"conv_bn_stats kernel launch failed (error {err})")
    launches[_NAME] += 1
    s = parts.sum(dim=1)
    return y, s[0], s[1]


def conv_stats(x: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [N, C] bf16, Σy [C] fp32, Σy² [C] fp32) of ``x [N, K] · w [K,
    C]`` — the kernel on CUDA tensors, the plain version on CPU."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _conv_stats_rows(x, w)
    return _cuda(x, w)


def conv_bn_stats(x: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, var): the 1x1 convolution ``x [N, K] · w [K, C]`` in bf16
    and the BatchNorm statistics of its fp32 result over the N rows,
    ``mean = Σy / N``, ``var = Σy² / N − mean²`` (fp32 [C] each), as the
    spike's ``pallas_conv_stats`` returns them."""
    y, s1, s2 = conv_stats(x, w)
    n = x.shape[0]
    mean = s1 / n
    return y, mean, s2 / n - mean * mean
