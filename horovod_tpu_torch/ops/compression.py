"""Gradient compression: cast for the reduction, cast back after.

Counterpart of ``horovod_tpu/ops/compression.py``.  ``Compression.none``,
``fp16`` and ``bf16`` are the reference's frontend casts.  The wire-level
compressors (``wire_fp16``/``wire_bf16``/``wire_int8``/``wire_fp8``) leave
the tensor as it is and ask the eager engine for that wire format: the
engine quantizes on send and dequantizes, reduces and requantizes on the
ring with per-chunk scales (``runtime/eager.py``; fp32 payloads only).  On
the ``torch.distributed`` path of ``make_train_step`` they are identities,
as on the reference's traced path.  ``topk`` needs the sparse plane
(``runtime/sparse.py``), which is not ported (ROADMAP.md Queue A): it
raises.
"""

from __future__ import annotations

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "WireCompressor", "Compression"]


class Compressor:
    """Interface for compressing and decompressing a tensor."""

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context) for decompress."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        """Returns the decompressed tensor."""
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default no-op compression."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """Cast floating-point gradients to float16 for the reduction."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating-point gradients to bfloat16 for the reduction."""

    wire_dtype = torch.bfloat16


class WireCompressor(Compressor):
    """Wire-level compression: the tensor stays as it is in user code
    (identity compress/decompress) and the engine carries it in
    ``engine_wire_dtype``."""

    engine_wire_dtype: str = "fp32"

    @classmethod
    def compress(cls, tensor):
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor


def _wire(dtype: str):
    return type(f"_Wire{dtype.upper()}", (WireCompressor,),
                {"engine_wire_dtype": dtype})


class Compression:
    """Registry of compression algorithms (reference compression.py)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    wire_fp16 = _wire("fp16")
    wire_bf16 = _wire("bf16")
    wire_int8 = _wire("int8")
    wire_fp8 = _wire("fp8")

    @staticmethod
    def topk(ratio=None, error_feedback: bool = True):
        raise NotImplementedError(
            "Compression.topk needs the sparse plane (runtime/sparse.py), "
            "which is not ported yet (ROADMAP.md Queue A)")
