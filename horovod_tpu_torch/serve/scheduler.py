"""Continuous (iteration-level) batching over the paged KV cache.

The Orca insight: scheduling decisions happen at *decode-step*
granularity, not request granularity — a new sequence joins the running
batch the moment it is funded and prefilled, and a finished sequence
frees its slot (and blocks) without draining the batch.  Phases are
separated: each scheduler step runs at most ``prefill_waves`` prompt
prefills (one whole prompt per forward) and then ONE batched decode
step for every running sequence, so a long prompt never stalls
in-flight decodes for more than one wave.

Admission control is block-funded: a sequence is admitted only when the
paged pool can fund its whole prompt (all-or-nothing); a sequence whose
decode needs a new block from an exhausted pool triggers preemption —
the *youngest* running sequence is evicted back to the wait queue
(blocks recycled) and later resumes by recomputing its prefix
(prompt + tokens generated so far becomes its new prompt).  Greedy
decoding makes the recompute reproduce the identical continuation;
temperature sampling stays preemption-stable because sample keys are
derived from (request seed, absolute position), not from how many times
the sequence was scheduled.  (One caveat, same risk class as the
cache-length effect documented in ``models/generation.py``: the resume
token comes from the prefill program where the uninterrupted run used
the decode program — bit-identical on the CI target, asserted by the
preemption parity tests, but revalidate on new backends.)

Thread model: ``run()`` owns the model; ``submit``/``cancel``/``stats``
are thread-safe and non-blocking.  Token events are delivered through
the per-request ``emit`` callback FROM THE SCHEDULER THREAD — the
server wraps it with ``loop.call_soon_threadsafe``.

The port's counterpart of ``horovod_tpu/serve/scheduler.py``, with the
same policy, counters and events.  Two reference features need planes
that are not ported yet and raise instead: live weight swaps
(``swap_weights`` needs the checkpoint push codec) and the serve
autotuner (``HOROVOD_SERVE_AUTOTUNE=1`` needs ``autotune.search``).
Every event still carries ``weight_epoch`` (always 0 here), so clients
of the reference protocol read the same frames.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ModelRunner
from horovod_tpu_torch.serve.kv_cache import PagedKVCache

__all__ = ["Request", "Scheduler"]


@dataclass
class Request:
    id: str
    prompt: List[int]
    max_tokens: int
    temperature: float = 0.0
    seed: int = 0


@dataclass
class _Seq:
    """One live sequence: the request plus its generation state."""

    req: Request
    emit: Callable[[dict], None]
    sid: int
    out: List[int] = field(default_factory=list)
    preemptions: int = 0
    cancelled: bool = False

    @property
    def prefix(self) -> List[int]:
        """What a (re)prefill must run: prompt + everything generated."""
        return self.req.prompt + self.out

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.max_tokens


def _sample(logits: np.ndarray, temperature: float, seed: int,
            pos: int) -> int:
    """Greedy argmax at temperature<=0; otherwise categorical with a key
    derived from (seed, position) so a preempted-and-recomputed sequence
    resamples the SAME token at the same position."""
    if temperature <= 0:
        return int(np.argmax(logits))
    x = logits.astype(np.float64) / float(temperature)
    x -= x.max()
    p = np.exp(x)
    p /= p.sum()
    rng = np.random.default_rng([seed & 0x7FFFFFFF, pos])
    return int(rng.choice(len(p), p=p))


class Scheduler:
    """Continuous-batching scheduler over one :class:`ModelRunner`."""

    def __init__(self, runner: ModelRunner, serve_cfg: ServeConfig):
        if serve_cfg.autotune:
            raise NotImplementedError(
                "HOROVOD_SERVE_AUTOTUNE=1: the serve autotuner needs "
                "autotune.search, which is not ported yet")
        self.runner = runner
        self.cfg = serve_cfg
        # The allocator view may be tighter than the runner's physical
        # pool (smaller HOROVOD_SERVE_KV_BLOCKS than the runner was
        # built with) but never wider — block ids must stay in range.
        self.kv = PagedKVCache(
            min(runner.num_blocks, serve_cfg.kv_blocks + 1),
            runner.block_size, runner.max_blocks_per_seq,
            prefix_cache=bool(serve_cfg.prefix_cache))
        # Live-tunable knobs (read once per step so a mid-step change
        # cannot tear a batch).
        self.max_batch = serve_cfg.max_batch
        self.prefill_waves = serve_cfg.prefill_waves

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._new: deque = deque()
        self._cancelled: set = set()
        self._stop = False
        # Stamped on every token/done event, as in the reference; no
        # weight swap is ported, so it stays 0.
        self._weight_epoch = 0
        self._waiting: deque[_Seq] = deque()
        self._running: List[_Seq] = []
        self._next_sid = 1
        self._t0 = time.monotonic()
        # Liveness heartbeat: stamped every loop iteration (idle waits
        # included), so a scheduler thread wedged inside a step — a hung
        # model call — is distinguishable from a merely idle one.  The
        # server's pong carries its age; the reference's router probe
        # treats a stale heartbeat like a dead replica.
        self.last_beat = time.monotonic()
        # Counters (cumulative; stats() snapshots them).
        self._c = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "requests_rejected": 0,
            "requests_cancelled": 0,
            "preemptions": 0,
            "prefills": 0,
            "decode_steps": 0,
            "decode_seq_steps": 0,
            "tokens_streamed": 0,
            "weight_swaps": 0,
            "fused_attn_steps": 0,
            "prefill_tokens_saved": 0,
        }

    # -- thread-safe API --

    def submit(self, req: Request, emit: Callable[[dict], None]) -> None:
        with self._wake:
            self._new.append((req, emit))
            self._c["requests_submitted"] += 1
            self._wake.notify()

    def cancel(self, rid: str) -> None:
        with self._wake:
            self._cancelled.add(rid)
            self._wake.notify()

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify()

    def swap_weights(self, epoch: int, frames: list,
                     timeout: float = 60.0) -> dict:
        """Live weight push: needs the checkpoint plane's wire codec,
        which is not ported yet."""
        raise NotImplementedError("live weight swaps are not ported yet "
                                  "(they come with the checkpoint plane)")

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._c)
            queue_depth = len(self._waiting) + len(self._new)
            running = len(self._running)
        elapsed = max(1e-9, time.monotonic() - self._t0)
        out = dict(c)
        out["queue_depth"] = queue_depth
        out["running"] = running
        out["batch_occupancy"] = (
            c["decode_seq_steps"] / c["decode_steps"]
            if c["decode_steps"] else 0.0)
        out["tokens_per_sec"] = c["tokens_streamed"] / elapsed
        out["weight_epoch"] = self._weight_epoch
        out.update(self.kv.stats())
        out["tune_trials"] = 0
        out["config"] = {
            "max_batch": self.max_batch,
            "prefill_waves": self.prefill_waves,
            "block_size": self.kv.block_size,
            "kv_blocks": self.kv.capacity_blocks,
            "max_model_len": self.cfg.max_model_len,
            "model": self.cfg.model,
            "autotune": 0,
            "fused_attn": int(self.runner.fused_attn),
            "prefix_cache": int(self.kv.prefix_cache),
            "checkpoint_step": self.runner.checkpoint_step,
        }
        return out

    def metrics_counters(self) -> dict:
        """The small numeric counter set the replica piggybacks on pong
        frames; the router sums it across replicas for the ``serve``
        /metrics mount (``horovod_serve_*`` gauges)."""
        with self._lock:
            return {
                "prefix_hits": self.kv.prefix_hits,
                "prefix_misses": self.kv.prefix_misses,
                "prefix_evictions": self.kv.prefix_evictions,
                "cow_forks": self.kv.cow_forks,
                "fused_attn_steps": self._c["fused_attn_steps"],
                "prefill_tokens_saved": self._c["prefill_tokens_saved"],
            }

    # -- scheduler thread --

    def run(self) -> None:
        """Loop until :meth:`stop`; call from a dedicated thread."""
        while True:
            with self._wake:
                self.last_beat = time.monotonic()
                if self._stop:
                    self._drain_all_locked()
                    return
                if not (self._new or self._waiting or self._running
                        or self._cancelled):
                    self._wake.wait(timeout=0.05)
                    continue
            self.step()

    def step(self) -> None:
        """One scheduling iteration: intake, admission+prefill waves,
        one batched decode step.  The liveness heartbeat is stamped at
        every PHASE boundary (not just per loop pass): a long-but-
        progressing step — a first-use kernel build lives inside one
        decode call — keeps beating between phases, while a genuinely
        wedged phase freezes the beat."""
        self.last_beat = time.monotonic()
        self._intake()
        self._apply_cancellations()
        max_batch = max(1, int(self.max_batch))
        for _ in range(max(1, int(self.prefill_waves))):
            self.last_beat = time.monotonic()
            if len(self._running) >= max_batch or not self._waiting:
                break
            if not self._admit_and_prefill():
                break  # head-of-line sequence not fundable yet
        self.last_beat = time.monotonic()
        self._decode(max_batch)

    # -- internals (scheduler thread only) --

    def _intake(self) -> None:
        with self._lock:
            fresh = list(self._new)
            self._new.clear()
        for req, emit in fresh:
            total = len(req.prompt) + req.max_tokens
            reason = None
            if not req.prompt:
                reason = "empty prompt"
            elif req.max_tokens < 1:
                reason = f"max_tokens must be >= 1, got {req.max_tokens}"
            elif (total > self.cfg.max_model_len
                    or not self.kv.fits_model(total)):
                # Report the BINDING cap: length limit or pool size,
                # whichever is smaller.
                cap = min(self.cfg.max_model_len,
                          min(self.kv.max_blocks_per_seq,
                              self.kv.capacity_blocks)
                          * self.kv.block_size)
                reason = (f"request needs {total} cache slots; the "
                          f"model/pool cap is {cap}")
            if reason is not None:
                self._c["requests_rejected"] += 1
                emit({"event": "error", "id": req.id,
                      "error": f"{reason} (unservable, rejected)"})
                continue
            seq = _Seq(req=req, emit=emit, sid=self._next_sid)
            self._next_sid += 1
            self._waiting.append(seq)

    def _apply_cancellations(self) -> None:
        with self._lock:
            if not self._cancelled:
                return
            gone = self._cancelled
            self._cancelled = set()
        for seq in list(self._running):
            if seq.req.id in gone:
                self._running.remove(seq)
                self.kv.free(seq.sid)
                self._finish(seq, cancelled=True)
        for seq in list(self._waiting):
            if seq.req.id in gone:
                self._waiting.remove(seq)
                self._finish(seq, cancelled=True)

    def _admit_and_prefill(self) -> bool:
        """Fund + prefill the head of the wait queue; False when it
        cannot be funded right now (admission control refusal)."""
        seq = self._waiting[0]
        prefix = seq.prefix
        # Prefix-cache aware funding: leading blocks whose chained
        # content hash matches cached ones are shared (refcounted) and
        # only the non-shared suffix is funded and prefilled; a resumed
        # preemption hits its own earlier blocks the same way.  With
        # caching off this is plain allocate + full prefill, byte-for-
        # byte the old path.
        shared = self.kv.allocate_prefix(seq.sid, prefix)
        if shared is None:
            return False
        self._waiting.popleft()
        start = shared * self.kv.block_size
        logits = self.runner.prefill(
            prefix, self.kv.table(seq.sid), start=start)
        # Publish the full blocks AFTER the prefill wrote them, so a
        # later hit always shares blocks that really hold the K/V.
        self.kv.register_prefix(seq.sid, prefix)
        self._c["prefills"] += 1
        self._c["prefill_tokens_saved"] += start
        tok = _sample(logits, seq.req.temperature, seq.req.seed,
                      len(prefix))
        self._emit_token(seq, tok)
        if seq.done:
            self.kv.free(seq.sid)
            self._finish(seq)
        else:
            self._running.append(seq)
        return True

    def _decode(self, max_batch: int) -> None:
        if not self._running:
            return
        group = self._running[:max_batch]
        # Fund one more slot per sequence, preempting the youngest
        # running sequences when the pool runs dry.
        funded: List[_Seq] = []
        for seq in list(group):
            if seq not in self._running:
                continue  # preempted as a victim earlier in this loop
            pos = len(seq.prefix) - 1  # position of the last token
            # This step writes K/V at `pos`, so pos+1 slots fund it.
            while not self.kv.append_slot(seq.sid, pos + 1):
                victim = self._pick_victim(exclude=funded + [seq])
                if victim is None:
                    break
                self._preempt(victim)
                if victim in group:
                    group.remove(victim)
            else:
                funded.append(seq)
                continue
            # No victim left and still unfundable: the sequence itself
            # yields back to the queue (cannot happen while another
            # running sequence holds blocks — _pick_victim would have
            # found it).
            self._preempt(seq)
            if seq in group:
                group.remove(seq)
        if not funded:
            return
        tokens = [s.out[-1] for s in funded]
        pos = [len(s.prefix) - 1 for s in funded]
        tables = [self.kv.table_array(s.sid, self.runner.max_blocks_per_seq)
                  for s in funded]
        logits = self.runner.decode(tokens, tables, pos)
        self._c["decode_steps"] += 1
        self._c["decode_seq_steps"] += len(funded)
        if self.runner.fused_attn:
            self._c["fused_attn_steps"] += 1
        for i, seq in enumerate(funded):
            tok = _sample(logits[i], seq.req.temperature, seq.req.seed,
                          pos[i] + 1)
            self._emit_token(seq, tok)
            if seq.done:
                self._running.remove(seq)
                self.kv.free(seq.sid)
                self._finish(seq)

    def _pick_victim(self, exclude: Sequence[_Seq]) -> Optional[_Seq]:
        """Preemption policy: evict the YOUNGEST running sequence (vLLM's
        recompute preemption) — it has the least cached work to redo."""
        for seq in reversed(self._running):
            if seq not in exclude:
                return seq
        return None

    def _preempt(self, seq: _Seq) -> None:
        if seq in self._running:
            self._running.remove(seq)
        self.kv.free(seq.sid)
        seq.preemptions += 1
        self._c["preemptions"] += 1
        # Front of the queue: it arrived before anything still waiting.
        self._waiting.appendleft(seq)

    def _emit_token(self, seq: _Seq, tok: int) -> None:
        index = len(seq.out)
        seq.out.append(tok)
        self._c["tokens_streamed"] += 1
        seq.emit({"event": "token", "id": seq.req.id, "token": tok,
                  "index": index, "weight_epoch": self._weight_epoch})

    def _finish(self, seq: _Seq, cancelled: bool = False) -> None:
        if cancelled:
            self._c["requests_cancelled"] += 1
            seq.emit({"event": "cancelled", "id": seq.req.id})
            return
        self._c["requests_completed"] += 1
        seq.emit({"event": "done", "id": seq.req.id, "tokens": seq.out,
                  "preemptions": seq.preemptions,
                  "weight_epoch": self._weight_epoch})

    def _drain_all_locked(self) -> None:
        """On stop: fail whatever is still queued so no caller hangs."""
        for seq in list(self._running) + list(self._waiting):
            seq.emit({"event": "error", "id": seq.req.id,
                      "error": "replica shutting down"})
        for req, emit in self._new:
            emit({"event": "error", "id": req.id,
                  "error": "replica shutting down"})
        self._running.clear()
        self._waiting.clear()
        self._new.clear()
