"""Top-k sparse allreduce with error feedback over the engine's allgathers.

Counterpart of ``horovod_tpu/runtime/sparse.py`` (Deep Gradient
Compression, Lin et al. 2018): each rank sends only its ``k``
largest-magnitude entries and adds everything it did not send into a
per-tensor residual, which joins the next call's tensor, so small
entries are delayed, never lost.  The selected ``(indices, values)`` ride
two allgathers of the engine; every rank then adds the gathered entries
into a dense output.

Everything stays on the tensor's device: the fp32 residual, the
selection, the residual update and the scatter-add.  Only the ``k``
indices (int32 while the tensor has fewer than 2**31 entries) and values
go through the engine; a CUDA tensor's are staged through pinned memory
(``runtime/staging.py``).  The same code runs on CPU tensors, and there
it is the plain version of the card's path.

* **Residual lifecycle.**  Each residual is stamped with the membership
  epoch it was accumulated under; after an elastic resize or an abort
  recovery the next call starts it from zeros.
* **Selection.**  ``|v|`` descending, ties broken by a seeded permutation
  of the positions (``HOROVOD_TOPK_SEED``, default 0), smallest rank
  first.  The reference picks its candidates with ``np.argpartition``
  and only orders them by that rule, so where entries tie at the k-th
  magnitude numpy's introselect decides which of them go; the port
  applies the rule to every entry (ROADMAP.md Queue C).  On inputs
  without such ties both select, order and send the same entries.
* **Sum.**  The reference adds the gathered entries in fp64 in rank
  order (``np.add.at``), divides by the world size and rounds to fp32.
  The port adds them in passes, the p-th contribution to each position
  in the p-th pass (a position appears at most once per pass), so each
  position's fp64 sum is taken in rank order at any world size, as
  numpy's.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runtime import engine_or_none
from horovod_tpu_torch.runtime.engine import note_sparse_allreduce

__all__ = ["sparse_allreduce_topk", "select_topk", "reset_residuals",
           "residual_norm", "default_topk_ratio"]


def default_topk_ratio() -> float:
    """The HOROVOD_SPARSE_TOPK env default (fraction of entries sent)."""
    raw = os.environ.get("HOROVOD_SPARSE_TOPK", "")
    try:
        v = float(raw) if raw else 0.01
    except ValueError:
        v = 0.01
    return min(1.0, max(1e-6, v))


#: name -> (epoch, fp32 residual on the tensor's device).
_RESIDUALS: Dict[str, Tuple[int, torch.Tensor]] = {}
_LOCK = threading.Lock()

_TIE_PERM_CACHE: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _tie_perm(n: int, device: torch.device) -> torch.Tensor:
    """``np.random.default_rng(seed).permutation(n)`` as int32 on
    ``device``, cached per (seed, n, device): the largest leaves have tens
    of millions of entries."""
    seed = int(os.environ.get("HOROVOD_TOPK_SEED", "0") or 0)
    key = (seed, n, str(device))
    perm = _TIE_PERM_CACHE.get(key)
    if perm is None:
        host = np.random.default_rng(seed).permutation(n).astype(np.int32)
        perm = torch.from_numpy(host).to(device)
        if len(_TIE_PERM_CACHE) > 64:
            _TIE_PERM_CACHE.clear()
        _TIE_PERM_CACHE[key] = perm
    return perm


def reset_residuals(name: Optional[str] = None) -> None:
    """Drop error-feedback residuals (all of them, or one tensor's)."""
    with _LOCK:
        if name is None:
            _RESIDUALS.clear()
        else:
            _RESIDUALS.pop(name, None)


def residual_norm(name: str) -> float:
    """L2 norm of a tensor's current residual (0.0 when there is none)."""
    with _LOCK:
        entry = _RESIDUALS.get(name)
    return float(torch.linalg.vector_norm(entry[1])) if entry else 0.0


def select_topk(v: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The ``k`` entries of the flat fp32 ``v`` to send: (int64 positions,
    fp32 values), ordered by ``|v|`` descending, then by the seeded
    permutation ascending.  Both keys go into one int64 per entry: the bits
    of ``|v|`` (order-preserving for non-negative floats) above 31 bits of
    reversed permutation rank, so one ``torch.topk`` over distinct keys
    selects and orders at once, on any device."""
    n = v.numel()
    if k >= n:
        sel = torch.arange(n, device=v.device)
    else:
        key = v.abs().view(torch.int32).to(torch.int64)
        key.bitwise_left_shift_(31).add_((1 << 31) - 1)
        key.sub_(_tie_perm(n, v.device))
        sel = torch.topk(key, k, sorted=True).indices
    return sel, v[sel]


def _add_in_rank_order(n: int, idx: torch.Tensor, val: torch.Tensor
                       ) -> torch.Tensor:
    """fp64 ``zeros(n)`` plus ``val`` at ``idx``, each position's entries
    added in their order in ``idx`` (``np.add.at``'s order).  Pass p adds
    every position's p-th entry, so no pass repeats a position."""
    out = torch.zeros(n, dtype=torch.float64, device=val.device)
    if idx.numel() == 0:
        return out
    order = torch.sort(idx, stable=True).indices
    ids = idx[order]
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    pos = torch.arange(ids.numel(), device=ids.device)
    start = torch.where(first, pos, torch.zeros_like(pos)).cummax(0).values
    occurrence = torch.empty_like(pos)
    occurrence[order] = pos - start
    val64 = val.to(torch.float64)
    for p in range(int(occurrence.max()) + 1):
        this = occurrence == p
        out.index_add_(0, idx[this], val64[this])
    return out


def sparse_allreduce_topk(tensor: torch.Tensor, *, name: str,
                          ratio: Optional[float] = None,
                          error_feedback: bool = True,
                          average: bool = True) -> torch.Tensor:
    """Dense in, dense out: the top-k sparse sum (or mean) of ``tensor``
    across ranks, fp32, on its device and in its shape.  ``name`` keys
    the residual and the allgathers' rendezvous, so it is required."""
    eng = engine_or_none()
    arr = tensor.detach().to(torch.float32)
    shape = arr.shape
    flat = arr.reshape(-1)
    n = flat.numel()
    if n == 0:
        return arr.clone()
    if ratio is None:
        ratio = default_topk_ratio()
    k = max(1, min(n, int(round(n * ratio))))
    # A world of one keeps the selection and the residual: the same code
    # path at any size.
    epoch = eng.epoch() if eng is not None else 0
    with _LOCK:
        entry = _RESIDUALS.get(name) if error_feedback else None
    if (entry is not None and entry[0] == epoch and entry[1].numel() == n
            and entry[1].device == flat.device):
        v = flat + entry[1]
    else:
        # First use, feedback off, or a residual of another epoch or size.
        v = flat.clone()
    sel, vals = select_topk(v, k)
    if error_feedback:
        residual = v.clone()
        residual[sel] = 0.0
        with _LOCK:
            _RESIDUALS[name] = (epoch, residual)
    # k may differ per rank (callers may pass different ratios): the
    # allgather negotiates each rank's dim 0.
    wire_idx = sel.to(torch.int32) if n < (1 << 31) else sel
    if eng is not None:
        from horovod_tpu_torch.runtime import mpi_ops

        h_idx = mpi_ops.allgather_async(wire_idx, name=f"{name}.topk_idx")
        h_val = mpi_ops.allgather_async(vals, name=f"{name}.topk_val")
        idx_all, val_all = mpi_ops._drain([h_idx, h_val])
        world = basics.size()
    else:
        idx_all, val_all, world = wire_idx, vals, 1
    out = _add_in_rank_order(n, idx_all, val_all)
    if average:
        out.div_(torch.full((), world, dtype=torch.float64,
                            device=out.device))
    note_sparse_allreduce()
    return out.to(torch.float32).reshape(shape)
