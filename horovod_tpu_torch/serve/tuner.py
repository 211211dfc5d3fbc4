"""Serve-plane autotuning: the scheduler's live knobs under the same
seeded coordinate-descent machinery the engine tuner uses.

Counterpart of ``horovod_tpu/serve/tuner.py``: the same space, schedule
and scoring.  On the card every decode width is a captured CUDA graph,
and ``ladder(1, max_batch)`` may propose a width that is no power of two
(the scheduler then replays the next pow2 graph); the scheduler builds
every width the ladder can reach before the first window, so no trial's
window pays a capture.

The engine autotuner (``autotune/``) searches data-plane knobs
scored on bus bandwidth; the serve tuner reuses its
:class:`~horovod_tpu_torch.autotune.search.CoordinateSearch` over the
scheduler's live-tunable knobs — ``max_batch`` (decode batch width) and
``prefill_waves`` (admissions per step) — scored on *tokens/sec* over
fixed-step windows of real traffic.  Trials apply atomically between
scheduler steps (the scheduler reads its knobs once per step), the
schedule is deterministic for a fixed ``HOROVOD_SERVE_AUTOTUNE_SEED``,
and the search commits the best point at convergence or at the trial
cap.  ``stats()["tune_trials"]`` counts completed trials; committed
values show up in ``stats()["config"]``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from horovod_tpu_torch.autotune.search import CoordinateSearch, ladder
from horovod_tpu_torch.serve.config import ServeConfig

__all__ = ["ServeTuner"]


class ServeTuner:
    """Drives trial windows from the scheduler's own step loop —
    ``on_step()`` is called after every decode step, so an idle replica
    never burns a trial on an empty window."""

    def __init__(self, scheduler, cfg: ServeConfig):
        self._sched = scheduler
        self._window_steps = cfg.autotune_window_steps
        space = {
            "max_batch": ladder(1, max(1, cfg.max_batch)),
            "prefill_waves": ladder(1, max(1, cfg.prefill_waves * 4)),
        }
        base = {"max_batch": cfg.max_batch,
                "prefill_waves": cfg.prefill_waves}
        self.search = CoordinateSearch(space, seed=cfg.autotune_seed,
                                       base=base,
                                       max_trials=cfg.autotune_max_trials)
        self.trials = 0
        #: one {"config", "score"} per finished trial (tokens/s of its
        #: window; None for a window without time), as the engine
        #: tuner's ``trace``
        self.trace: List[dict] = []
        self.committed: Optional[Dict[str, int]] = None
        self._active = False
        self._steps = 0
        self._t0 = 0.0
        self._tokens0 = 0

    def _apply(self, cfg: Dict[str, int]) -> None:
        self._sched.max_batch = int(cfg["max_batch"])
        self._sched.prefill_waves = int(cfg["prefill_waves"])

    def stats(self) -> dict:
        """The tuner's stats surface (merged into scheduler stats):
        trial progress plus the serve counters its windows are scored
        against — tokens throughput and the prefix-cache/fused-kernel
        instruments, so a trial log can attribute a window's score."""
        kv = self._sched.kv
        hits, misses = kv.prefix_hits, kv.prefix_misses
        return {
            "tune_trials": self.trials,
            "tune_committed": int(self.committed is not None),
            "tune_window_steps": self._window_steps,
            "tune_prefix_hit_rate": (hits / (hits + misses)
                                     if hits + misses else 0.0),
            "tune_fused_attn_steps": self._sched._c["fused_attn_steps"],
        }

    def on_step(self) -> None:
        if self.committed is not None:
            return
        if not self._active:
            trial = self.search.propose()
            if trial is None:
                self.committed = dict(self.search.best)
                self._apply(self.committed)
                return
            self._apply(trial)
            self._active = True
            self._steps = 0
            self._t0 = time.monotonic()
            self._tokens0 = self._sched._c["tokens_streamed"]
            return
        self._steps += 1
        if self._steps < self._window_steps:
            return
        dt = time.monotonic() - self._t0
        tokens = self._sched._c["tokens_streamed"] - self._tokens0
        score = tokens / dt if dt > 0 else None
        self.trace.append({"config": {"max_batch": self._sched.max_batch,
                                      "prefill_waves":
                                      self._sched.prefill_waves},
                           "score": score})
        self.search.observe(score)
        self.trials = self.search.trials
        self._active = False
