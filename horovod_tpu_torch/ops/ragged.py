"""Ragged (per-rank variable dim-0) allgather over a mesh axis.

Counterpart of ``horovod_tpu/ops/ragged.py``: the "pad-to-max + size
sideband" recipe.  Every rank carries a buffer padded to a common row
capacity (:func:`bucket_rows`, :func:`pad_rows`) and a count of valid
rows; :func:`ragged_allgather` gathers both over the axis's group (one
allgather each, ``parallel/comm.py``) with the invalid rows zeroed, and
:func:`compact` drops the padding on the host.  The eager engine's
``allgather`` needs none of this (it negotiates the true sizes).
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import default_mesh

__all__ = ["bucket_rows", "pad_rows", "ragged_allgather", "compact"]


def bucket_rows(n: int, *, min_bucket: int = 8) -> int:
    """Smallest power of two >= n (and >= min_bucket): the row capacity to
    pad to, so varying raggedness meets a handful of shapes."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()


def pad_rows(x, capacity: int):
    """Zero-pad dim 0 of host array ``x`` to ``capacity`` rows; returns
    ``(padded, n_valid)``."""
    x = np.asarray(x)
    n = x.shape[0]
    if n > capacity:
        raise ValueError(f"{n} rows exceed the bucket capacity {capacity}")
    pad = np.zeros((capacity - n,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


def ragged_allgather(x_padded: torch.Tensor, n_valid, *,
                     axis_name: str = "data", mesh=None):
    """Gather every rank's padded buffer [cap, ...] and its valid row
    count over ``axis_name`` of ``mesh`` (default: the default mesh).
    Returns ``(gathered [N, cap, ...], sizes [N] int32)`` with the invalid
    rows zeroed, so sums over the buffer are already right (divide means
    by ``sizes.sum()``)."""
    axis = comm.axis_group(mesh if mesh is not None else default_mesh(),
                           axis_name)
    cap = x_padded.shape[0]
    mask = (torch.arange(cap, device=x_padded.device) < int(n_valid)).to(
        x_padded.dtype).reshape((cap,) + (1,) * (x_padded.dim() - 1))
    gathered = comm._all_gather((x_padded * mask)[None], axis, 0)
    sizes = comm._all_gather(torch.tensor(
        [int(n_valid)], dtype=torch.int32, device=x_padded.device), axis, 0)
    return gathered, sizes


def compact(gathered, sizes) -> np.ndarray:
    """Host-side: only the valid rows of each rank's block, concatenated."""
    gathered = np.asarray(gathered)
    sizes = np.asarray(sizes)
    return np.concatenate(
        [gathered[i, : sizes[i]] for i in range(gathered.shape[0])], axis=0)
