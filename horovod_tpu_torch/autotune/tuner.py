"""The online autotuner: coordinator-driven knob search over the live
data plane.

Counterpart of ``horovod_tpu/autotune/tuner.py``, driving the port's
engine through its binding (``runtime/engine.py``: ``autotune_set``,
``stats_delta``).

One daemon thread on the coordinator (rank 0), started by
``basics.init()`` under ``HOROVOD_AUTOTUNE=1``:

* it proposes a trial config through the native ``horovod_autotune_set``
  C API — the engine broadcasts it in the next cycle's **epoch-stamped
  TUNE frame**, and every rank applies it atomically between negotiation
  cycles (a TUNE from a dead incarnation is dropped by the engine's
  structural stale-epoch rejection, like any other control frame);
* it scores each trial from ``stats_delta`` counter windows — bus
  bandwidth over a **fixed-bytes** window of allreduce traffic, so fast
  configs are not penalized with shorter measurements;
* the trial schedule is a seeded coordinate descent
  (:mod:`horovod_tpu_torch.autotune.search`) — deterministic for a fixed
  ``HOROVOD_AUTOTUNE_SEED``;
* on convergence it commits the best config (one final TUNE with the
  commit flag), persists it to ``HOROVOD_AUTOTUNE_STATE_FILE``, and
  keeps watching: a **sustained** regression (several consecutive
  completed windows far below the committed score) restarts the search.

All of it is observation + between-cycle knob flips: a trial can be slow
but never wrong.  Every rank applies a TUNE in the same cycle, so the ranks
reduce alike under every trial; a changed fusion threshold regroups a
reduction, which may move a sum by its rounding against an untuned run.

``startup_probe`` handles the two knobs a TUNE frame cannot reach —
``HOROVOD_NUM_CHANNELS`` / ``HOROVOD_CHANNEL_DRIVERS`` require
(re)wiring — with a short collective micro-probe reusing the bench sweep
machinery (shutdown + re-init per candidate, rank 0's verdict broadcast
through the engine itself).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.autotune.search import CoordinateSearch, ladder
from horovod_tpu_torch.autotune.store import load_state, save_state

__all__ = ["Autotuner", "start_autotuner", "stop_autotuner", "get_tuner",
           "startup_probe", "default_space"]


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


def default_space(num_channels: int,
                  priority_bands: int = 0) -> Dict[str, List[int]]:
    """Log-scaled ladders for the live-tunable knobs.  The wave ladder is
    bounded by the committed channel fan-out (waves cannot exceed it).
    ``HOROVOD_AUTOTUNE_KNOBS`` (comma list) restricts which knobs are
    swept — tests and short runs use it to keep schedules short.

    The WIRE DTYPE knob (fp32=0, fp16=1, int8=3 — WireDtype codes) only
    joins the sweep under ``HOROVOD_AUTOTUNE_WIRE=1``: unlike every
    other knob it changes NUMERICS (compressed wires are value-lossy by
    design), so the tuner flipping it silently under a training job
    would violate the bit-exactness default.  When enabled, trials are
    scored on the same busbw counters as everything else — and since
    ``allreduce_bytes`` counts LOGICAL (pre-compression) payload, the
    score is automatically the EFFECTIVE bus bandwidth: logical bytes
    over wall time, exactly what compression is supposed to improve."""
    space: Dict[str, List[int]] = {
        "chunk_bytes": ladder(64 << 10, 4 << 20),
        "fusion_threshold": ladder(8 << 20, 128 << 20),
        "cycle_time_ms": [1, 2, 4, 8],
        "wave_width": ladder(1, max(1, num_channels)),
        # Size-based algorithm crossover: 0 (star path off) plus a log
        # ladder around the default 32 KB — the latency/bandwidth
        # crossover is host-dependent, which is exactly why it's a knob.
        "algo_threshold": [0] + ladder(8 << 10, 256 << 10),
    }
    # Per-band fusion-threshold LADDER (priority scheduling): with
    # HOROVOD_PRIORITY_BANDS committed on, each band's bucket size is
    # its own coordinate — urgent bands typically want SMALL buckets
    # (dispatch sooner), bulk bands big ones (amortize) — so the model's
    # bucket sizes are LEARNED instead of one-size-fits-all.
    # HOROVOD_AUTOTUNE_LADDER_BANDS caps how many leading bands get a
    # dimension (default 2; bands past the ladder share the global
    # fusion threshold).
    if priority_bands > 0:
        nb = _env_int("HOROVOD_AUTOTUNE_LADDER_BANDS", 2)
        for b in range(max(0, min(8, nb))):
            space[f"fusion_ladder_{b}"] = ladder(1 << 20, 64 << 20)
    only = os.environ.get("HOROVOD_AUTOTUNE_KNOBS", "")
    keep = {k.strip() for k in only.split(",") if k.strip()}
    if os.environ.get("HOROVOD_AUTOTUNE_WIRE", "") not in ("", "0") or \
            "wire_dtype" in keep:
        space["wire_dtype"] = [0, 1, 3]
    if keep:
        space = {k: v for k, v in space.items() if k in keep}
    return space


#: Committed config of the last converged search in this process: an
#: in-place elastic resize restarts the tuner (shutdown + re-init), and
#: the new incarnation re-applies this under the new epoch instead of
#: re-searching — the state file is the cross-process equivalent.
_LAST_COMMITTED: Optional[Dict[str, int]] = None
_LAST_SCORE: Optional[float] = None


class Autotuner(threading.Thread):
    """See the module docstring.  Public observability (read from the
    main thread, e.g. by tests and ``chip_smoke.py``):

    * ``trace`` — list of ``{"config", "score"}`` per finished trial;
    * ``committed`` — the committed config dict (None mid-search);
    * ``converged`` — True once committed;
    * ``epoch`` — the membership epoch the tuner is operating under.
    """

    def __init__(self, engine):
        super().__init__(name="hvd-autotune", daemon=True)
        self._eng = engine
        self._lib = engine.lib
        self._stop_evt = threading.Event()
        self.seed = _env_int("HOROVOD_AUTOTUNE_SEED", 0)
        self.window_bytes = _env_int("HOROVOD_AUTOTUNE_WINDOW_BYTES",
                                     64 << 20)
        self.max_trials = _env_int("HOROVOD_AUTOTUNE_MAX_TRIALS", 32)
        self.trial_timeout = _env_int("HOROVOD_AUTOTUNE_TRIAL_TIMEOUT_SEC",
                                      30)
        self.reprobe_ratio = _env_float("HOROVOD_AUTOTUNE_REPROBE_RATIO",
                                        0.5)
        self.reprobe_windows = _env_int("HOROVOD_AUTOTUNE_REPROBE_WINDOWS",
                                        3)
        self.state_file = os.environ.get("HOROVOD_AUTOTUNE_STATE_FILE", "")
        self.trace: List[dict] = []
        self.committed: Optional[Dict[str, int]] = None
        self.committed_score: Optional[float] = None
        self.epoch: int = 0
        self._converged = threading.Event()
        self.planned: List[tuple] = []

    # -- public surface ----------------------------------------------------

    @property
    def converged(self) -> bool:
        return self._converged.is_set()

    def wait_converged(self, timeout: Optional[float] = None) -> bool:
        return self._converged.wait(timeout)

    def stop(self) -> None:
        self._stop_evt.set()

    # -- engine liveness / plumbing ---------------------------------------

    def _alive(self) -> bool:
        if self._stop_evt.is_set():
            return False
        try:
            if not self._lib.horovod_is_initialized():
                return False
            return self._eng.abort_reason() == ""
        except Exception:
            return False

    def _sleep(self, sec: float) -> None:
        self._stop_evt.wait(sec)

    def _apply(self, cfg: Dict[str, int], commit: bool) -> bool:
        """Queue a TUNE and wait until it has APPLIED (tune_trials moved)
        so the scoring window never starts under the previous config.

        The wait has no timer of its own: TUNE application is not
        traffic-dependent (QueueTune wakes the cycle loop, an idle
        heartbeat carries the frame), so the only things that can delay
        it are the engine's own stalls — and those end in the engine's
        failure detectors firing (`_alive` goes false) or an epoch move.
        A private deadline here would misread a legitimately slow cycle
        (a big collective may hold the loop up to the socket timeout) as
        failure and restart the whole search, unbounding the trial count
        and breaking the deterministic-schedule contract."""
        before = self._lib.horovod_tune_trials()
        epoch0 = self._eng.epoch()
        # Per-band fusion ladder rides as a positional array (band b's
        # threshold; 0 = leave that band unchanged).
        ladder_keys = sorted(
            (k for k in cfg if k.startswith("fusion_ladder_")),
            key=lambda k: int(k.rsplit("_", 1)[1]))
        fusion_ladder = None
        if ladder_keys:
            nb = max(int(k.rsplit("_", 1)[1]) for k in ladder_keys) + 1
            fusion_ladder = [0] * nb
            for k in ladder_keys:
                fusion_ladder[int(k.rsplit("_", 1)[1])] = int(cfg[k])
        ok = self._eng.autotune_set(
            chunk_bytes=cfg.get("chunk_bytes", 0),
            fusion_threshold=cfg.get("fusion_threshold", 0),
            cycle_time_ms=cfg.get("cycle_time_ms", 0),
            wave_width=cfg.get("wave_width", 0),
            algo_threshold=cfg.get("algo_threshold", -1),
            wire_dtype=cfg.get("wire_dtype", -1),
            priority_bands=cfg.get("priority_bands", -1),
            fusion_ladder=fusion_ladder,
            commit=commit)
        if not ok:
            return False
        while self._alive() and self._eng.epoch() == epoch0:
            if self._lib.horovod_tune_trials() > before:
                return True
            self._sleep(0.002)
        return False

    def _score_window(self) -> Optional[float]:
        """Bus bandwidth (bytes/s) over the next fixed-bytes window of
        allreduce traffic; None when the window never filled (idle world,
        wedged trial, epoch change) — the trial is discarded, the engine
        keeps cycling, nothing wedges."""
        base = self._eng.stats()
        epoch0 = self._eng.epoch()
        deadline = time.monotonic() + self.trial_timeout
        while self._alive() and time.monotonic() < deadline:
            if self._eng.epoch() != epoch0:
                return None  # resized mid-window: measurement is garbage
            delta = self._eng.stats_delta(base)
            if delta["allreduce_bytes"] >= self.window_bytes:
                bw = delta["allreduce_bus_bw_bytes_per_sec"]
                return bw if bw > 0 else None
            self._sleep(0.01)
        return None

    # -- the search --------------------------------------------------------

    def run(self) -> None:  # noqa: C901 — one explicit state machine
        try:
            self.epoch = self._eng.epoch()
            warm = self._warm_config()
            if warm is not None:
                if self._apply(warm, commit=True):
                    self.committed = dict(warm)
                    self.committed_score = _LAST_SCORE
                    self._converged.set()
                    self._monitor()
                return
            while self._alive():
                if self._search_once():
                    self._monitor()
                    return
        except Exception:
            # A tuner bug must never take the training process down; the
            # engine simply keeps running its current config.
            import traceback
            traceback.print_exc()

    def _warm_config(self) -> Optional[Dict[str, int]]:
        if os.environ.get("HOROVOD_AUTOTUNE_FORCE_SEARCH", "") not in \
                ("", "0"):
            return None
        warm = None
        state = load_state(self.state_file)
        if state is not None:
            global _LAST_SCORE
            _LAST_SCORE = state.get("score")
            warm = dict(state["committed"])
        elif _LAST_COMMITTED is not None:
            warm = dict(_LAST_COMMITTED)
        if warm is not None and \
                os.environ.get("HOROVOD_AUTOTUNE_WIRE", "") in ("", "0"):
            # A persisted wire dtype is NUMERICS-changing and only ever
            # entered the search under the HOROVOD_AUTOTUNE_WIRE opt-in;
            # a warm restart without that opt-in must not silently put
            # the new job on a lossy wire.
            warm.pop("wire_dtype", None)
        if warm is not None:
            # The band width is never swept (ordering semantics belong
            # to the user's env), and a LIVE flip races enqueue-time
            # priority stamping across ranks for one step — a state
            # file carrying priority_bands (hand-edited; the store's
            # sanitizer admits the key for the ladder's sake) must not
            # re-apply it mid-run.  The env knob is the only way in.
            warm.pop("priority_bands", None)
        return warm or None

    def _search_once(self) -> bool:
        """One full search under the current epoch.  Returns True when it
        committed; False when the epoch moved underneath it (the caller
        restarts the search under the new epoch)."""
        self.epoch = self._eng.epoch()
        cfg_now = self._eng.stats()["config"]
        base = {k: int(v) for k, v in cfg_now.items()
                if k in ("chunk_bytes", "fusion_threshold",
                         "cycle_time_ms", "wave_width", "algo_threshold")}
        space = default_space(cfg_now["num_channels"],
                              int(cfg_now.get("priority_bands", 0)))
        for k in space:
            # Ladder dims start from the global fusion threshold (the
            # engine's effective per-band value when unset).
            if k.startswith("fusion_ladder_"):
                base.setdefault(k, int(cfg_now["fusion_threshold"]))
        if "wire_dtype" in space:
            # Only when the wire knob is actually swept does it join the
            # base/committed config (config reports it as a NAME; the
            # TUNE frame and the ladder use the WireDtype code).  Keeping
            # it out otherwise preserves the invariant that a committed
            # config compares equal to stats()["config"] key-for-key.
            from horovod_tpu_torch.runtime.engine import WIRE_DTYPES
            base["wire_dtype"] = WIRE_DTYPES.get(
                cfg_now.get("wire_dtype", "fp32"), 0)
        search = CoordinateSearch(space, seed=self.seed, base=base,
                                  max_trials=self.max_trials)
        self.planned = search.planned_schedule()
        while self._alive():
            if self._eng.epoch() != self.epoch:
                return False  # world resized: restart under the new epoch
            cfg = search.propose()
            if cfg is None:
                break
            if not self._apply(cfg, commit=False):
                # Engine gone -> True (stop quietly); epoch moved -> False
                # (the caller restarts the search under the new epoch).
                return self._alive() is False
            score = self._score_window()
            search.observe(score)
            self.trace.append({"config": dict(cfg), "score": score})
        if not self._alive():
            return True  # stop requested; don't loop
        committed = search.best
        if self._apply(committed, commit=True):
            global _LAST_COMMITTED, _LAST_SCORE
            self.committed = dict(committed)
            self.committed_score = search.best_score
            _LAST_COMMITTED = dict(committed)
            _LAST_SCORE = search.best_score
            save_state(self.state_file, committed, search.best_score,
                       self.seed,
                       wiring={
                           "num_channels":
                               self._eng.stats()["config"]["num_channels"],
                           "channel_drivers":
                               self._eng.stats()["config"]
                               ["channel_drivers"],
                       })
            self._converged.set()
        return True

    def _monitor(self) -> None:
        """Post-commit regression watch: several consecutive COMPLETED
        windows below reprobe_ratio x the baseline re-open the search
        (workload or host conditions changed); idle/timed-out windows
        never count — an idle trainer is not a regression.

        The baseline is an EWMA over the monitor's own non-regressing
        windows, seeded from the FIRST completed one — not from the
        search's best trial score, which is a max over noisy windows (a
        peak, not a typical value: loopback busbw on a loaded host
        swings well over 2x), and never ratcheted to a maximum: a
        transient fast window nudges it up a fraction and later normal
        windows pull it back, so noise cannot inflate the baseline until
        ordinary throughput reads as a phantom regression and the tuner
        churns full searches through live training."""
        bad = 0
        baseline: Optional[float] = None
        while self._alive():
            if self._eng.epoch() != self.epoch:
                # Resized world: re-assert the committed config under the
                # new epoch (the engine re-read env defaults at re-init).
                # The old baseline is void — busbw scales with the size.
                self.epoch = self._eng.epoch()
                if self.committed is not None:
                    self._apply(self.committed, commit=True)
                bad = 0
                baseline = None
                continue
            score = self._score_window()
            if score is None:
                bad = 0
                continue
            if baseline is None or baseline <= 0:
                baseline = score
                self.committed_score = score
                continue
            if score < self.reprobe_ratio * baseline:
                # Regressing windows only count — folding them into the
                # EWMA would decay the baseline toward the regressed
                # level and mask a persistent shift.
                bad += 1
            else:
                bad = 0
                baseline += 0.2 * (score - baseline)
                self.committed_score = baseline
            if bad >= self.reprobe_windows:
                self._converged.clear()
                self.committed = None
                bad = 0
                baseline = None
                while self._alive():
                    if self._search_once():
                        break
                if not self.converged:
                    return


# -- process-wide lifecycle (driven by basics.init/shutdown) ---------------

_TUNER: Optional[Autotuner] = None
_TUNER_LOCK = threading.Lock()


def start_autotuner(engine) -> Autotuner:
    """Start (or restart) the coordinator's tuner thread; returns it."""
    global _TUNER
    with _TUNER_LOCK:
        if (_TUNER is not None and _TUNER.is_alive()
                and not _TUNER._stop_evt.is_set()):
            return _TUNER
        _TUNER = Autotuner(engine)
        _TUNER.start()
        return _TUNER


def stop_autotuner(timeout: float = 5.0) -> None:
    global _TUNER
    with _TUNER_LOCK:
        tuner = _TUNER
    if tuner is None:
        return
    tuner.stop()
    tuner.join(timeout)


def get_tuner() -> Optional[Autotuner]:
    """The live (or last) Autotuner of this process — rank 0 only."""
    return _TUNER


# -- startup micro-probe (wiring-time knobs) -------------------------------

def startup_probe(candidates=None, nbytes: int = 4 << 20,
                  iters: int = 4) -> Dict[str, int]:
    """Collective: EVERY rank must call this, before training starts.

    Measures allreduce bus bandwidth at each candidate
    ``(num_channels, channel_drivers)`` wiring — 0 = auto — via
    shutdown + re-init per candidate, then re-wires the world with rank
    0's winner (its verdict is broadcast through the engine, so every
    rank re-inits with the same env and the rendezvous cannot split).

    The probe's tensors are torch tensors on the device ``hvd.init``
    bound this rank to (``hvd.device()``: the rank's card, or the CPU),
    and each re-init keeps that device and the process group's backend:
    a job's gradients live there, so the probe takes their path, the
    staging of a CUDA tensor through pinned host memory included.  The
    score is the engine ring's bus bandwidth (``stats_delta``), which the
    wiring moves; the staging around it is the same at every candidate."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.runtime import eager
    from horovod_tpu_torch.runtime.engine import get_engine

    eng = get_engine()
    if candidates is None:
        candidates = [(1, 0), (2, 0), (4, 0)]
    dev = basics.device()
    backend = dist.get_backend() if dist.is_initialized() else None
    # The online tuner must not mutate knobs mid-probe; and if a
    # candidate re-init fails mid-probe, the exception must not leave
    # the env pinned to the failing candidate — a caller that catches
    # and re-inits would silently wire a fan-out the user never chose.
    saved = {k: os.environ.get(k)
             for k in ("HOROVOD_NUM_CHANNELS", "HOROVOD_CHANNEL_DRIVERS")}
    os.environ["HOROVOD_AUTOTUNE_SUSPEND"] = "1"
    try:
        x = torch.ones(max(1, nbytes // 4), dtype=torch.float32, device=dev)
        scores = []
        for ch, dr in candidates:
            os.environ["HOROVOD_NUM_CHANNELS"] = str(ch) if ch else ""
            os.environ["HOROVOD_CHANNEL_DRIVERS"] = str(dr) if dr else ""
            basics.shutdown()
            basics.init(device=dev, backend=backend)
            eager.allreduce(x, op=eager.Sum, name="autotune.probe.warm")
            before = eng.stats()
            for _ in range(iters):
                eager.allreduce(x, op=eager.Sum, name="autotune.probe.t")
            scores.append(
                eng.stats_delta(before)["allreduce_bus_bw_bytes_per_sec"])
        best = max(range(len(scores)), key=scores.__getitem__)
        pick = eager.broadcast(
            torch.tensor(list(candidates[best]), dtype=torch.int64),
            root_rank=0, name="autotune.probe.pick")
        ch, dr = int(pick[0]), int(pick[1])
    except BaseException:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        raise
    finally:
        os.environ.pop("HOROVOD_AUTOTUNE_SUSPEND", None)
    os.environ["HOROVOD_NUM_CHANNELS"] = str(ch) if ch else ""
    os.environ["HOROVOD_CHANNEL_DRIVERS"] = str(dr) if dr else ""
    basics.shutdown()
    basics.init(device=dev, backend=backend)   # the tuner restarts here
    return {"num_channels": ch, "channel_drivers": dr}
