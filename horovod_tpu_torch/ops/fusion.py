"""Tensor fusion: many small tensors reduced as few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py``, with the same bucketing
rule: tensors are grouped by dtype, keep their order within a dtype, fill
a bucket up to ``HOROVOD_FUSION_THRESHOLD`` bytes (default 64 MiB, the
reference's), and a bucket never mixes dtypes; 0 means one tensor per
bucket.  Where the reference flattens at trace time and lets XLA fuse the
copies, here a bucket of several tensors is ``torch.cat`` of their
flattened views, one collective runs over it, and the result is sliced
back (views of the reduced buffer).  A bucket of one tensor is handed to
the collective as it is.  ``HOROVOD_FUSION_REPORT=1`` prints each
distinct plan once, to stderr.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["DEFAULT_FUSION_THRESHOLD", "fusion_threshold_bytes",
           "FusionPlan", "plan_fusion", "fuse_apply"]

#: 64 MiB, the reference's default.
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` in bytes; 0 disables fusion."""
    value = os.environ.get("HOROVOD_FUSION_THRESHOLD")
    if value is None or value == "":
        return DEFAULT_FUSION_THRESHOLD
    return int(value)


@dataclass(frozen=True)
class _Bucket:
    dtype: torch.dtype
    indices: Tuple[int, ...]          # positions in the input list
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @property
    def nbytes(self) -> int:
        return sum(self.sizes) * self.dtype.itemsize


@dataclass(frozen=True)
class FusionPlan:
    buckets: Tuple[_Bucket, ...]
    n_leaves: int


def plan_fusion(tensors: Sequence[torch.Tensor],
                threshold_bytes: Optional[int] = None) -> FusionPlan:
    """Group tensors into same-dtype buckets of at most
    ``threshold_bytes`` (a tensor larger than that is a bucket alone)."""
    if threshold_bytes is None:
        threshold_bytes = fusion_threshold_bytes()
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    buckets: List[_Bucket] = []
    for dtype, idxs in by_dtype.items():
        cur: List[int] = []
        cur_bytes = 0
        for i in idxs:
            nbytes = tensors[i].numel() * dtype.itemsize
            if cur and threshold_bytes > 0 and \
                    cur_bytes + nbytes > threshold_bytes:
                buckets.append(_bucket(dtype, cur, tensors))
                cur, cur_bytes = [], 0
            if threshold_bytes == 0:
                buckets.append(_bucket(dtype, [i], tensors))
                continue
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(_bucket(dtype, cur, tensors))
    return FusionPlan(buckets=tuple(buckets), n_leaves=len(tensors))


def _bucket(dtype, idxs: List[int], tensors) -> _Bucket:
    shapes = tuple(tuple(tensors[i].shape) for i in idxs)
    sizes = tuple(tensors[i].numel() for i in idxs)
    return _Bucket(dtype=dtype, indices=tuple(idxs), sizes=sizes,
                   shapes=shapes)


_reported_plans: set = set()


def _maybe_report(plan: FusionPlan) -> None:
    if os.environ.get("HOROVOD_FUSION_REPORT", "0") in ("", "0"):
        return
    key = tuple((str(b.dtype), b.sizes) for b in plan.buckets)
    if key in _reported_plans:
        return
    _reported_plans.add(key)
    print(f"horovod_tpu_torch fusion: {plan.n_leaves} tensors -> "
          f"{len(plan.buckets)} fused collective(s)", file=sys.stderr)
    for n, b in enumerate(plan.buckets):
        print(f"  bucket {n}: {len(b.indices)} x "
              f"{str(b.dtype).replace('torch.', '')}, {sum(b.sizes)} "
              f"elements ({b.nbytes / 2**20:.2f} MiB)", file=sys.stderr)


def fuse_apply(tensors: Sequence[torch.Tensor],
               fn: Callable[[torch.Tensor], torch.Tensor],
               threshold_bytes: Optional[int] = None,
               plan: Optional[FusionPlan] = None) -> List[torch.Tensor]:
    """``[fn(t) for t in tensors]`` for an elementwise-safe collective
    ``fn``, with one ``fn`` call per fused bucket instead of one per
    tensor.  ``plan`` reuses a plan made for tensors of the same shapes
    and dtypes."""
    tensors = list(tensors)
    if not tensors:
        return []
    if plan is None:
        plan = plan_fusion(tensors, threshold_bytes)
    _maybe_report(plan)
    out: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
    for bucket in plan.buckets:
        if len(bucket.indices) == 1:
            i = bucket.indices[0]
            out[i] = fn(tensors[i])
            continue
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket.indices])
        reduced = fn(flat)
        for i, piece, shape in zip(bucket.indices,
                                   reduced.split(bucket.sizes),
                                   bucket.shapes):
            out[i] = piece.view(shape)
    return out
