"""The comparison that decides ``correct``.

The program's first steps are held against the reference's
(``reference/train.py``) by these numbers, each against its limit from
``limits/<workload>.json``:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first averaged gradient, as the optimizer got it, by
  the worst leaf: |program's norm − reference's norm| over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same, of each parameter's change after the steps,
  over the elements whose first reference gradient is at least a
  thousandth of the median leaf's root-mean-square gradient: an element
  whose gradient is nought but for rounding (a key's bias under softmax)
  moves under Adam by round-off alone (:func:`change_norms`);
* ``stats_gap``: the same, of each running statistic's change;
* ``grad_gap_median``, ``change_gap_median``: the median over the leaves
  of the same per-leaf gaps, for a cell whose worst leaf is the noise of
  its compute precision (ResNet-50's first BatchNorm bias, whose fp32
  gradient nearly cancels: bf16 compute reads it several times larger in
  the program and in the reference alike);
* ``window_nonfinite``: the window's losses that are not finite (limit 0).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

#: An element whose first reference gradient is under this share of the
#: median leaf's root-mean-square gradient is left out of ``change_gap``.
QUIET_GRADIENT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's gap of per-leaf norms, as the module says (inf where
    the program's norm is missing or not finite)."""
    if not ref:
        return {}
    median = statistics.median(ref.values())
    out = {}
    for n, r in ref.items():
        got = prog.get(n, math.nan)
        denom = max(r, median)
        gap = (abs(got - r) / denom if denom > 0
               else (0.0 if got == 0 else math.inf))
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]
             ) -> Tuple[float, Optional[str]]:
    """(worst gap, its leaf) of per-leaf norms."""
    gaps = leaf_gaps(prog, ref)
    if not gaps:
        return 0.0, None
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]
                    ) -> Tuple[float, Optional[str]]:
    """(the median of the per-leaf gaps, the leaf nearest it)."""
    gaps = leaf_gaps(prog, ref)
    if not gaps:
        return 0.0, None
    mid = statistics.median(gaps.values())
    return mid, min(gaps, key=lambda n: abs(gaps[n] - mid))


def change_norms(prog: Dict[str, "torch.Tensor"],
                 ref: Dict[str, "torch.Tensor"],
                 ref_grads: Dict[str, "torch.Tensor"]):
    """(program's, reference's) norms of each leaf's change, over the
    elements whose first reference gradient is not quiet."""
    import torch

    rms = statistics.median(float(g.double().norm()) / g.numel() ** 0.5
                            for g in ref_grads.values())
    out_p, out_r = {}, {}
    for n, d in ref.items():
        keep = ref_grads[n].abs() >= QUIET_GRADIENT * rms
        got = prog[n].to(d.device)
        out_p[n] = float(torch.where(keep, got, 0).double().norm())
        out_r[n] = float(torch.where(keep, d, 0).double().norm())
    return out_p, out_r


def numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """Each compared number with the leaf or step that sets it."""
    gaps = [abs(p - r) / abs(r) if r else math.inf
            for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(p) for p in prog["losses"]):
        gaps.append(math.inf)
    worst = max(gaps)
    out = {"loss_gap": {"value": worst, "at": f"step {gaps.index(worst) + 1}"}}
    for name, key in (("grad_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        for suffix, gap in (("", leaf_gap), ("_median", median_leaf_gap)):
            value, where = gap(prog[key], ref[key])
            out[name + suffix] = {"value": value, "at": where}
    if ref["stats_change_norms"]:
        s, where = leaf_gap(prog["stats_change_norms"],
                            ref["stats_change_norms"])
        out["stats_gap"] = {"value": s, "at": where}
    return out


def judge(found: Dict[str, dict], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over every limited number; a
    number that is missing or not finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = found.get(name, {}).get("value", math.nan)
        ok = math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": limit}
    return correct, checks
