"""Per-tensor wire-dtype policy driven by gradient statistics.

Counterpart of ``horovod_tpu/runtime/wire_policy.py``.  The engine can
carry each fp32 allreduce in its own wire format (``wire_dtype``); this
module chooses it per gradient leaf from rolling statistics:

* every leaf keeps a rolling (EWMA) abs-max and RMS of its gradient;
* 0/1-D leaves (biases, norms, scalars) and leaves below
  ``HOROVOD_WIRE_POLICY_MIN_ELEMS`` elements always stay ``fp32``;
* large multi-dim fp32 leaves switch to ``int8`` once more than
  ``HOROVOD_WIRE_POLICY_WARMUP`` steps were seen and ``abs_max / rms``
  stays within ``HOROVOD_WIRE_POLICY_RATIO`` (per-chunk scales absorb a
  smooth range; a spiky leaf would lose its outliers, so it keeps the
  default);
* non-fp32 payloads get no decision (the engine only compresses fp32).

The statistics are per rank, so two ranks can disagree the step a leaf
crosses the threshold: the callers stamp these wires advisory (the
coordinator commits the first value it sees).

The statistics are taken on the gradients' device: for each leaf that
needs them, its abs-max and the fp32-rounded mean of its fp32 squares
(summed in fp64), all leaves of one call read back with one copy per
device.  The EWMA and the decision are Python floats, as the reference's.
The reference sums its squares in fp32 pairwise (``np.mean``); the two
means differ by a few fp32 ulps, so only a leaf sitting at the ratio
could be decided differently (ROADMAP.md Queue C).

Enable with ``HOROVOD_WIRE_POLICY=1`` (the hook-form optimizer and the
JAX form's engine route pick it up), or pass a :class:`WirePolicy`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["WirePolicy", "policy_enabled", "default_policy",
           "reset_default_policy", "leaf_statistics"]


def _env_int(name: str, dflt: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else dflt
    except ValueError:
        return dflt


def _env_float(name: str, dflt: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else dflt
    except ValueError:
        return dflt


def policy_enabled(environ=os.environ) -> bool:
    return environ.get("HOROVOD_WIRE_POLICY", "") not in ("", "0")


def leaf_statistics(tensors: Sequence[torch.Tensor]) -> List[tuple]:
    """``(abs_max, mean of squares)`` of each fp32 tensor as Python floats,
    computed on the tensors' devices and read back with one copy per
    device.  The mean is the fp32 rounding of the fp64 sum of the fp32
    squares over the element count."""
    out: List[Optional[tuple]] = [None] * len(tensors)
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.numel() == 0:
            out[i] = (0.0, 0.0)
        else:
            by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        rows = []
        for i in idx:
            t = tensors[i].detach()
            rows.append(torch.stack([
                t.abs().amax().to(torch.float64),
                torch.sum(t.square(), dtype=torch.float64) / t.numel()]))
        host = torch.stack(rows).cpu().numpy()
        for i, (a, m) in zip(idx, host):
            out[i] = (float(a), float(np.float32(m)))
    return out


class _LeafStats:
    __slots__ = ("abs_max", "rms", "steps")

    def __init__(self):
        self.abs_max = 0.0
        self.rms = 0.0
        self.steps = 0


class WirePolicy:
    """Deterministic per-leaf wire-dtype rule over rolling statistics.

    :meth:`observe_and_choose_many` updates each leaf's rolling abs-max
    and RMS and returns the wire dtypes to stamp (``"int8"``, ``"fp32"``,
    or ``None`` = the engine default): pure functions of the observed
    history, to be stamped advisory."""

    def __init__(self, *, min_elems: Optional[int] = None,
                 ratio: Optional[float] = None,
                 warmup: Optional[int] = None,
                 decay: float = 0.9):
        self.min_elems = (_env_int("HOROVOD_WIRE_POLICY_MIN_ELEMS", 65536)
                          if min_elems is None else int(min_elems))
        self.ratio = (_env_float("HOROVOD_WIRE_POLICY_RATIO", 64.0)
                      if ratio is None else float(ratio))
        self.warmup = (_env_int("HOROVOD_WIRE_POLICY_WARMUP", 3)
                       if warmup is None else int(warmup))
        self.decay = float(decay)
        self._stats: Dict[str, _LeafStats] = {}
        #: name -> last stamped wire ("int8"/"fp32"/None); observability.
        self.decisions: Dict[str, Optional[str]] = {}

    def needs_statistics(self, tensor: torch.Tensor) -> bool:
        """Whether the leaf's decision reads its statistics (a large
        multi-dim fp32 leaf); every other leaf is decided by its shape and
        dtype alone."""
        return (tensor.dtype == torch.float32 and tensor.dim() > 1
                and tensor.numel() >= self.min_elems)

    def _fixed(self, name: str, tensor: torch.Tensor) -> Optional[str]:
        # Non-fp32 payloads are never wire-compressed: no bookkeeping.
        # Norm/bias/scalar and small leaves are pinned to fp32, whatever
        # the global HOROVOD_WIRE_DTYPE says.
        wire = "fp32" if tensor.dtype == torch.float32 else None
        self.decisions[name] = wire
        return wire

    def choose(self, name: str, abs_max: float, mean_square: float
               ) -> Optional[str]:
        """Fold one step's statistics of a large multi-dim fp32 leaf into
        its rolling values and decide its wire."""
        st = self._stats.get(name)
        if st is None:
            st = self._stats[name] = _LeafStats()
        r = math.sqrt(mean_square)
        if st.steps == 0:
            st.abs_max, st.rms = abs_max, r
        else:
            st.abs_max = self.decay * st.abs_max + (1 - self.decay) * abs_max
            st.rms = self.decay * st.rms + (1 - self.decay) * r
        st.steps += 1
        wire: Optional[str] = None
        if (st.steps > self.warmup and st.rms > 0.0
                and st.abs_max / st.rms <= self.ratio):
            # Smooth and embedding/projection-shaped: the per-chunk-scaled
            # int8 wire quarters its bytes.
            wire = "int8"
        self.decisions[name] = wire
        return wire

    def observe_and_choose_many(self, names: Sequence[str],
                                tensors: Sequence[torch.Tensor]
                                ) -> List[Optional[str]]:
        """One step's decisions for many leaves, their statistics read back
        together."""
        need = [i for i, t in enumerate(tensors)
                if self.needs_statistics(t)]
        stats = dict(zip(need, leaf_statistics([tensors[i] for i in need])))
        return [self.choose(n, *stats[i]) if i in stats
                else self._fixed(n, t)
                for i, (n, t) in enumerate(zip(names, tensors))]

    def observe_and_choose(self, name: str, tensor: torch.Tensor
                           ) -> Optional[str]:
        """One leaf's decision (its own readback)."""
        return self.observe_and_choose_many([name], [tensor])[0]

    def reset(self) -> None:
        self._stats.clear()
        self.decisions.clear()


_DEFAULT: Optional[WirePolicy] = None


def default_policy() -> WirePolicy:
    """The process-wide policy instance (env-configured)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = WirePolicy()
    return _DEFAULT


def reset_default_policy() -> None:
    """Drop the accumulated statistics (they describe the model, so an
    engine restart keeps them)."""
    global _DEFAULT
    _DEFAULT = None
