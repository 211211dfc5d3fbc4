"""Seeded coordinate-descent-with-doubling over log-scaled knob ranges.

Counterpart of ``horovod_tpu/autotune/search.py``: the same schedule for
the same space and seed.

The schedule is **score-independent**: which knob is swept when, and
which ladder values it tries, are fully determined by ``(space, seed)``
— scores only pick the winner once a knob's ladder completes, after
which later knobs are swept with the winner held in place (the
coordinate-descent part).  That makes the trial sequence reproducible
for a fixed ``HOROVOD_AUTOTUNE_SEED`` (the tests assert it against the
reference's), while the noisy live measurements can only affect which values get
*committed*, never which get *tried*.

Ladders are doublings across a log-scaled range (the Horovod
``ParameterManager`` insight, arXiv:1802.05799 §5: these knobs act
multiplicatively, so linear grids waste trials at the top of the range).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["ladder", "CoordinateSearch"]


def ladder(lo: int, hi: int) -> List[int]:
    """Doubling ladder [lo, 2lo, 4lo, ..] clipped to hi (hi included)."""
    out = []
    v = int(lo)
    while v < int(hi):
        out.append(v)
        v *= 2
    out.append(int(hi))
    return out


class CoordinateSearch:
    """One pass of coordinate descent over ``space``.

    ``space`` maps knob name -> ladder of candidate values; ``base`` is
    the starting config (knobs missing from ``space`` are never touched).
    ``propose()`` yields the next trial config (base with exactly one
    knob swept) or ``None`` once the schedule is exhausted or
    ``max_trials`` is hit; ``observe(score)`` reports the last trial's
    score (``None`` = trial discarded — e.g. the window timed out — it
    can never win its ladder).
    """

    def __init__(self, space: Dict[str, Sequence[int]], seed: int = 0,
                 base: Optional[Dict[str, int]] = None,
                 max_trials: Optional[int] = None):
        self.space = {k: list(v) for k, v in space.items() if v}
        self.seed = int(seed)
        self.base: Dict[str, int] = dict(base or {})
        for k, vals in self.space.items():
            self.base.setdefault(k, vals[0])
        self.max_trials = max_trials
        # Knob order is the seeded part; ladders run in ascending order.
        self._order = sorted(self.space)
        random.Random(self.seed).shuffle(self._order)
        self._schedule: List[Tuple[str, int]] = [
            (k, v) for k in self._order for v in self.space[k]
        ]
        if max_trials is not None:
            self._schedule = self._schedule[:max(0, int(max_trials))]
        self._idx = 0            # next schedule entry to propose
        self._awaiting = False   # propose() called, observe() pending
        self._knob_scores: Dict[str, List[Tuple[int, Optional[float]]]] = {
            k: [] for k in self.space
        }
        self.trials = 0
        # Score MEASURED AT the current best point: the winning trial of
        # the most recently completed ladder ran with every earlier
        # winner already fixed in base, so its config IS `best`.  A max
        # over all trials would generally belong to a DIFFERENT config
        # (an earlier ladder's winner before later knobs moved) — a
        # throughput the committed config never achieved.
        self.best_score: Optional[float] = None

    # -- schedule introspection (tests assert determinism on this) --

    def planned_schedule(self) -> List[Tuple[str, int]]:
        """The full (knob, value) trial sequence — fixed by (space, seed),
        independent of any observed score."""
        return list(self._schedule)

    # -- driving --

    @property
    def converged(self) -> bool:
        return self._idx >= len(self._schedule) and not self._awaiting

    @property
    def best(self) -> Dict[str, int]:
        """The current coordinate-descent point: every completed knob at
        its ladder winner, the rest at base."""
        return dict(self.base)

    def propose(self) -> Optional[Dict[str, int]]:
        if self._awaiting:
            raise RuntimeError("observe() the previous trial first")
        if self._idx >= len(self._schedule):
            return None
        knob, value = self._schedule[self._idx]
        self._awaiting = True
        cfg = dict(self.base)
        cfg[knob] = value
        return cfg

    def observe(self, score: Optional[float]) -> None:
        if not self._awaiting:
            raise RuntimeError("no trial pending")
        knob, value = self._schedule[self._idx]
        self._awaiting = False
        self._idx += 1
        self.trials += 1
        self._knob_scores[knob].append((value, score))
        # Ladder complete for this knob (next entry sweeps another knob,
        # or the schedule ends): fix the winner into the base so later
        # knobs are swept around it.  All-discarded ladders keep base
        # (and leave best_score alone — nothing was measured there).
        done = (self._idx >= len(self._schedule)
                or self._schedule[self._idx][0] != knob)
        if done:
            scored = [(v, s) for v, s in self._knob_scores[knob]
                      if s is not None]
            if scored:
                winner, winner_score = max(scored, key=lambda vs: vs[1])
                self.base[knob] = winner
                self.best_score = winner_score
