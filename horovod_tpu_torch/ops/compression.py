"""Gradient compression: cast for the reduction, cast back after.

Counterpart of ``horovod_tpu/ops/compression.py``.  ``Compression.none``,
``fp16`` and ``bf16`` are the reference's frontend casts.  The wire-level
compressors (``wire_fp16``/``wire_bf16``/``wire_int8``/``wire_fp8``) and
``topk`` belong to the reference's eager native engine, which is not
ported (ROADMAP.md Queue A, items A1-A2): they raise when used.
"""

from __future__ import annotations

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "Compression"]

_ENGINE = ("needs the eager native engine, which is not ported yet "
           "(ROADMAP.md Queue A, A1-A2)")


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


class _EngineCompressor(Compressor):
    name = "wire compression"

    @classmethod
    def compress(cls, tensor):
        raise NotImplementedError(f"Compression.{cls.name} {_ENGINE}")


def _engine_only(name: str):
    return type(f"_{name}", (_EngineCompressor,), {"name": name})


class Compression:
    """Registry of compression algorithms (reference compression.py)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    wire_fp16 = _engine_only("wire_fp16")
    wire_bf16 = _engine_only("wire_bf16")
    wire_int8 = _engine_only("wire_int8")
    wire_fp8 = _engine_only("wire_fp8")

    @staticmethod
    def topk(ratio=None, error_feedback: bool = True):
        raise NotImplementedError(f"Compression.topk {_ENGINE}")
