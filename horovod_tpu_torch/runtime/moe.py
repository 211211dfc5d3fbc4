"""Expert-parallel MoE training plane: dispatch and combine over the
engine's variable-split alltoall.

Counterpart of ``horovod_tpu/runtime/moe.py`` (Shazeer et al.'s sparsely
gated MoE, GShard's dispatch/combine), on tensors of the layer's device:

* **gating**: a replicated router projects each token to expert logits;
  full softmax, top-k by a stable sort (ties toward the lower expert id),
  gate weight = the chosen expert's probability;
* **dispatch**: each kept (token, slot) assignment is a row
  ``[features.., expert_id]`` sent to the expert's owner rank by one
  variable-split alltoall, named ``moe.*`` and enqueued at priority 0;
* **capacity**: an expert takes at most ``capacity = ceil(cf * topk *
  tokens / experts)`` rows, first come in global token order (each rank
  sends its contiguous shard in token order and the alltoall lays rows
  out in source-rank order); the rest return zeros and are counted into
  the engine's ``moe_tokens_dropped``;
* **combine**: the outputs return by the alltoall with the transposed
  splits (this rank's receive counts, from an equal-split exchange of the
  send counts), and each token adds ``gate * expert_out`` slot by slot.

**World-size invariance.**  A step at any world size gives, bit for bit,
what ``MoeLayer(..., world=(0, 1))`` gives on the whole batch.  The
reference gets this from row-at-a-time numpy.  A batched library call can
pick its kernel, and so a row's rounding, by the batch's extent, which
differs between a rank's shard and the whole batch; so the port gives
every such call the same shape at every world size:

* per-token work (the gate's ``x @ wg``, softmax and sums, ``d_gates``,
  the router's ``dlogits @ wg.T``) runs on chunks of ``ROW_CHUNK`` rows
  that line up with global token positions (a shard that starts inside
  a chunk is padded in front), so a token sits at the same row of a chunk
  of the same shape at every world size;
* each expert's kept rows fill a buffer of ``min(capacity, tokens *
  topk)`` rows in arrival order, the same buffer at every world size, and
  its MLP and gradients are GEMMs over that buffer;
* the router gradient is one GEMM of the allgathered inputs and
  ``dlogits``, the reference's;
* a token's gradient adds its slots in slot order.

Against the reference's numpy the results agree within fp32 rounding
(different summation orders; ROADMAP.md Queue C).  The expert gradients
are GEMMs over the padded buffer where the reference adds row by row.

``router_params()`` are replicated and ``expert_params()`` rank-local: an
optimizer reduces the first and never the second.
"""

from __future__ import annotations

import math
import os
import threading
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.runtime.engine import note_moe_dispatch

__all__ = ["MoeLayer", "moe_experts_default", "moe_capacity_factor_default",
           "moe_topk_default", "moe_capacity", "moe_stats",
           "reset_moe_stats", "ROW_CHUNK"]

#: Rows per chunk of the per-token work (see the module docstring).
ROW_CHUNK = 256


def moe_experts_default(world_size: int = 1) -> int:
    """``HOROVOD_MOE_EXPERTS``: the global expert count, by default (and at
    least) the world size, so every rank owns an expert."""
    raw = os.environ.get("HOROVOD_MOE_EXPERTS", "")
    try:
        n = int(raw) if raw.strip() else int(world_size)
    except ValueError:
        n = int(world_size)
    return max(int(world_size), n)


def moe_capacity_factor_default() -> float:
    """``HOROVOD_MOE_CAPACITY_FACTOR``: slack on the perfect-balance
    per-expert budget, default 1.25 (GShard's); 0 drops every token."""
    raw = os.environ.get("HOROVOD_MOE_CAPACITY_FACTOR", "")
    try:
        return max(0.0, float(raw)) if raw.strip() else 1.25
    except ValueError:
        return 1.25


def moe_topk_default() -> int:
    """``HOROVOD_MOE_TOPK``: experts per token, default 2, at least 1."""
    raw = os.environ.get("HOROVOD_MOE_TOPK", "")
    try:
        return max(1, int(raw)) if raw.strip() else 2
    except ValueError:
        return 2


def moe_capacity(total_tokens: int, n_experts: int, topk: int,
                 capacity_factor: float) -> int:
    """The per-expert row budget ``ceil(cf * topk * tokens / experts)``."""
    return int(math.ceil(capacity_factor * topk * total_tokens
                         / max(1, n_experts)))


# The plane's slice of stats(): dispatches (cumulative), and the current
# capacity factor and expert count (gauges).  moe_tokens_dropped lives in
# the engine.
_STATS_LOCK = threading.Lock()
_DISPATCHES = 0
_CAPACITY_FACTOR = 0.0
_EXPERTS = 0


def moe_stats() -> dict:
    with _STATS_LOCK:
        return {"moe_dispatches": _DISPATCHES,
                "moe_capacity_factor": _CAPACITY_FACTOR,
                "moe_experts": _EXPERTS}


def reset_moe_stats() -> None:
    """Zero the plane's counters and gauges (the engine's
    ``moe_tokens_dropped`` lasts the process)."""
    global _DISPATCHES, _CAPACITY_FACTOR, _EXPERTS
    with _STATS_LOCK:
        _DISPATCHES = 0
        _CAPACITY_FACTOR = 0.0
        _EXPERTS = 0


def _note_dispatch(capacity_factor: float, experts: int) -> None:
    global _DISPATCHES, _CAPACITY_FACTOR, _EXPERTS
    with _STATS_LOCK:
        _DISPATCHES += 1
        _CAPACITY_FACTOR = float(capacity_factor)
        _EXPERTS = int(experts)


def _by_chunks(fn, tensors, offset: int):
    """``fn`` over chunks of ``ROW_CHUNK`` rows of ``tensors`` (equal
    row counts), chunk boundaries at global row multiples of ROW_CHUNK
    (``offset``: the global index of row 0); zero rows pad each chunk.
    Returns ``fn``'s outputs with the shard's rows."""
    rows = tensors[0].shape[0]
    lead = offset % ROW_CHUNK
    n = -(-(lead + rows) // ROW_CHUNK)
    padded = []
    for t in tensors:
        buf = t.new_zeros((n * ROW_CHUNK,) + tuple(t.shape[1:]))
        buf[lead:lead + rows] = t
        padded.append(buf)
    outs = [fn(*(b[c * ROW_CHUNK:(c + 1) * ROW_CHUNK] for b in padded))
            for c in range(n)]
    return [torch.cat(parts)[lead:lead + rows] for parts in zip(*outs)]


class MoeLayer:
    """One expert-parallel MoE layer: a replicated top-k router and a
    contiguous block of two-layer ReLU MLP experts on each rank.

    Every rank builds the layer with the same arguments; all experts are
    drawn from one seeded stream (numpy's, as the reference's) and each
    rank keeps its block, so the union is the reference layer's set.
    ``world=(0, 1)`` is the single-rank dense-gated reference.  The
    parameters live on ``device`` (default: ``hvd.init()``'s device, or
    the current CUDA device; the CPU only when asked for).

    >>> layer = MoeLayer(d_model=16, d_hidden=32, device="cpu")
    >>> y, cache = layer.forward(x_shard)          # x: [T_local, d]
    >>> dx = layer.backward(dy_shard, cache)       # accumulates grads
    >>> layer.apply_grads(lr=0.1)                  # SGD, zeroes grads
    """

    #: Per-process construction counter: two layers get distinct names.
    _instances = 0

    def __init__(self, d_model: int, d_hidden: Optional[int] = None, *,
                 n_experts: Optional[int] = None, topk: Optional[int] = None,
                 capacity_factor: Optional[float] = None, seed: int = 0,
                 name: str = "moe", wire_dtype: Optional[str] = None,
                 world: Optional[Tuple[int, int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if world is None:
            world = ((basics.rank(), basics.size())
                     if basics.is_initialized() else (0, 1))
        if device is None and basics.is_initialized():
            device = basics.device()
        self.device = resolve_device(device)
        self.rank, self.size = int(world[0]), int(world[1])
        self.d_model = int(d_model)
        self.d_hidden = (int(d_hidden) if d_hidden is not None
                         else 2 * self.d_model)
        self.n_experts = (moe_experts_default(self.size)
                          if n_experts is None else int(n_experts))
        if self.n_experts % self.size != 0:
            raise ValueError(
                f"n_experts {self.n_experts} must be divisible by the "
                f"world size {self.size} (contiguous expert blocks per "
                "rank)")
        self.experts_per_rank = self.n_experts // self.size
        self.topk = moe_topk_default() if topk is None else max(1, int(topk))
        if self.topk > self.n_experts:
            raise ValueError(f"topk {self.topk} > n_experts "
                             f"{self.n_experts}")
        self.capacity_factor = (moe_capacity_factor_default()
                                if capacity_factor is None
                                else max(0.0, float(capacity_factor)))
        self.wire_dtype = wire_dtype
        self.name = f"{name}.{MoeLayer._instances}"
        MoeLayer._instances += 1
        self._dispatches = 0

        rng = np.random.RandomState(seed)
        scale1 = np.float32(1.0 / math.sqrt(self.d_model))
        scale2 = np.float32(1.0 / math.sqrt(self.d_hidden))
        wg = (rng.standard_normal((self.d_model, self.n_experts))
              .astype(np.float32) * scale1)
        full_w1 = (rng.standard_normal(
            (self.n_experts, self.d_model, self.d_hidden))
            .astype(np.float32) * scale1)
        full_w2 = (rng.standard_normal(
            (self.n_experts, self.d_hidden, self.d_model))
            .astype(np.float32) * scale2)
        lo = self.rank * self.experts_per_rank
        hi = lo + self.experts_per_rank
        self.expert_lo = lo
        self.wg = self._param(wg)
        self.w1 = self._param(full_w1[lo:hi])
        self.w2 = self._param(full_w2[lo:hi])
        self.b1 = torch.zeros((self.experts_per_rank, self.d_hidden),
                              device=self.device)
        self.b2 = torch.zeros((self.experts_per_rank, self.d_model),
                              device=self.device)
        self.zero_grads()

    def _param(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- parameter views for optimizer composition --

    def router_params(self) -> List[torch.Tensor]:
        """Replicated parameters: reduce their grads across ranks."""
        return [self.wg]

    def expert_params(self) -> List[torch.Tensor]:
        """This rank's expert block: never reduce their grads."""
        return [self.w1, self.b1, self.w2, self.b2]

    def zero_grads(self) -> None:
        self.g_wg = torch.zeros_like(self.wg)
        self.g_w1 = torch.zeros_like(self.w1)
        self.g_b1 = torch.zeros_like(self.b1)
        self.g_w2 = torch.zeros_like(self.w2)
        self.g_b2 = torch.zeros_like(self.b2)

    def owner(self, expert: int) -> int:
        """The rank owning ``expert`` (contiguous blocks)."""
        return int(expert) // self.experts_per_rank

    # -- the wire --

    def _engine(self):
        if self.size == 1:
            return None
        from horovod_tpu_torch.runtime import engine_or_none

        eng = engine_or_none() if basics.is_initialized() else None
        if eng is None:
            raise RuntimeError(
                "MoeLayer built for a multi-rank world but no engine is "
                "running")
        return eng

    def _alltoall(self, payload: torch.Tensor, splits: List[int],
                  tag: str) -> torch.Tensor:
        """One engine alltoall at priority 0, named ``moe.*``; an identity
        at world size 1."""
        if self._engine() is None:
            return payload.clone()
        from horovod_tpu_torch.runtime import eager

        return eager.alltoall(
            payload, name=f"moe.{self.name}.{tag}.{self._dispatches}",
            splits=splits, wire_dtype=self.wire_dtype, priority=0)

    def _exchange_counts(self, counts: List[int], tag: str) -> List[int]:
        """An equal-split int64 alltoall of the send counts: this rank's
        column of the size matrix, the return alltoall's splits."""
        if self._engine() is None:
            return list(counts)
        from horovod_tpu_torch.runtime import eager

        col = eager.alltoall(
            torch.tensor(counts, dtype=torch.int64).reshape(self.size, 1),
            name=f"moe.{self.name}.{tag}.counts.{self._dispatches}",
            priority=0)
        return [int(v) for v in col.reshape(-1).tolist()]

    def _allgather(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        if self._engine() is None:
            return t
        from horovod_tpu_torch.runtime import eager

        return eager.allgather(
            t, name=f"moe.{self.name}.router.{tag}.{self._dispatches}")

    # -- the gate --

    def _gate_rows(self, x: torch.Tensor):
        logits = x @ self.wg
        m = logits.amax(dim=1, keepdim=True)
        ex = torch.exp(logits - m)
        return (ex / ex.sum(dim=1, keepdim=True),)

    def gate(self, x: torch.Tensor, offset: int = 0):
        """Full softmax over the expert logits, stable top-k (ties toward
        the lower expert id), gate weight = the chosen probability.
        ``offset``: the global index of ``x``'s first token.  Returns
        ``(probs [T,E], topk_idx [T,k] int64, gates [T,k])``."""
        probs, = _by_chunks(self._gate_rows, [x], offset)
        topk_idx = torch.sort(-probs, dim=1, stable=True).indices[
            :, :self.topk]
        return probs, topk_idx, probs.gather(1, topk_idx)

    # -- forward --

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One MoE forward over this rank's contiguous batch shard ``x
        [T_local, d_model]``: ``(y, cache)``, ``cache`` for
        :meth:`backward`.  Over-capacity assignments contribute zero and
        are counted into ``moe_tokens_dropped``."""
        x = x.detach().to(self.device, torch.float32).contiguous()
        if x.dim() != 2 or x.shape[1] != self.d_model:
            raise ValueError(
                f"expected x [tokens, {self.d_model}], got "
                f"{tuple(x.shape)}")
        t_local, k_slots, d = x.shape[0], self.topk, self.d_model
        offset = self.rank * t_local
        probs, topk_idx, gates = self.gate(x, offset)

        # Assignments ordered (dest rank, token, slot): each dest's block
        # in local token order, so an expert sees global token order.
        experts = topk_idx.reshape(-1)
        dest = torch.div(experts, self.experts_per_rank,
                         rounding_mode="floor")
        order = torch.sort(dest, stable=True).indices
        counts = torch.bincount(dest, minlength=self.size).tolist()
        tok = torch.div(order, k_slots, rounding_mode="floor")
        slot = order % k_slots
        payload = torch.cat([x[tok], experts[order].to(torch.float32)
                             .unsqueeze(1)], dim=1)

        recv_counts = self._exchange_counts(counts, "fwd")
        recv = self._alltoall(payload, counts, "dispatch")

        # Expert side: capacity first come in arrival (= global token)
        # order: a row's place among its expert's rows is a running count.
        capacity = moe_capacity(t_local * self.size, self.n_experts,
                                self.topk, self.capacity_factor)
        rows = min(capacity, t_local * self.size * k_slots)
        local_e = recv[:, d].to(torch.int64) - self.expert_lo
        onehot = torch.nn.functional.one_hot(local_e, self.experts_per_rank)
        place = (onehot.cumsum(0) * onehot).sum(1) - 1
        kept = place < capacity
        dropped = int((~kept).sum())
        ke, kp = local_e[kept], place[kept]
        buf = x.new_zeros((self.experts_per_rank, rows, d))
        buf[ke, kp] = recv[kept, :d]
        h_pre, outs = [], []
        for e in range(self.experts_per_rank):
            pre = buf[e] @ self.w1[e] + self.b1[e]
            h_pre.append(pre)
            outs.append(torch.relu(pre) @ self.w2[e] + self.b2[e])
        out = x.new_zeros((recv.shape[0], d))
        if rows:
            out[kept] = torch.stack(outs)[ke, kp]

        note_moe_dispatch(dropped)
        self._dispatches += 1
        _note_dispatch(self.capacity_factor, self.n_experts)

        back = self._alltoall(out, recv_counts, "combine")

        # Combine: gate * expert_out, added slot by slot.
        expert_out = x.new_zeros((t_local, k_slots, d))
        expert_out[tok, slot] = back
        y = x.new_zeros((t_local, d))
        for k in range(k_slots):
            y += gates[:, k:k + 1] * expert_out[:, k]
        cache = {"x": x, "probs": probs, "topk_idx": topk_idx,
                 "gates": gates, "tok": tok, "slot": slot,
                 "counts": counts, "recv_counts": recv_counts,
                 "recv": recv, "kept": kept, "local_e": local_e,
                 "place": place, "buf": buf, "h_pre": h_pre,
                 "expert_out": expert_out, "dropped": dropped,
                 "offset": offset}
        return y, cache

    # -- backward --

    @staticmethod
    def _router_rows(wg_t, dy, expert_out, probs, topk_idx):
        d_gates = (dy.unsqueeze(1) * expert_out).sum(dim=2)
        d_probs = torch.zeros_like(probs).scatter_(1, topk_idx, d_gates)
        inner = (d_probs * probs).sum(dim=1, keepdim=True)
        dlogits = probs * (d_probs - inner)
        return dlogits, dlogits @ wg_t

    def backward(self, dy: torch.Tensor, cache: dict) -> torch.Tensor:
        """The vjp of :meth:`forward`: adds the expert grads (rank-local)
        and the router grad (from allgathered inputs and ``dlogits``, the
        reference's one GEMM at every world size) into ``g_*``; returns
        ``dx [T_local, d_model]``."""
        dy = dy.detach().to(self.device, torch.float32).contiguous()
        x, tok, slot = cache["x"], cache["tok"], cache["slot"]
        gates, expert_out = cache["gates"], cache["expert_out"]
        t_local, d = x.shape

        # Into each expert output row: gate * dy[token], along the
        # forward's routing; rows back-propagate on their owner.
        d_out = gates[tok, slot].unsqueeze(1) * dy[tok]
        recv_d = self._alltoall(d_out, cache["counts"], "bwd.dispatch")
        kept, buf = cache["kept"], cache["buf"]
        ke, kp = cache["local_e"][kept], cache["place"][kept]
        g_buf = torch.zeros_like(buf)
        g_buf[ke, kp] = recv_d[kept]
        dx_buf = torch.zeros_like(buf)
        for e, pre in enumerate(cache["h_pre"]):
            g = g_buf[e]
            self.g_w2[e] += torch.relu(pre).T @ g
            self.g_b2[e] += g.sum(dim=0)
            dh = torch.where(pre > 0, g @ self.w2[e].T,
                             torch.zeros((), device=pre.device))
            self.g_w1[e] += buf[e].T @ dh
            self.g_b1[e] += dh.sum(dim=0)
            dx_buf[e] = dh @ self.w1[e].T
        dx_rows = x.new_zeros((cache["recv"].shape[0], d))
        dx_rows[kept] = dx_buf[ke, kp]
        back = self._alltoall(dx_rows, cache["recv_counts"], "bwd.combine")

        slots = x.new_zeros((t_local, self.topk, d))
        slots[tok, slot] = back
        dx = x.new_zeros((t_local, d))
        for k in range(self.topk):
            dx += slots[:, k]

        # Router vjp through the full softmax: dP is sparse on the chosen
        # entries; dlogits = P * (dP - sum(dP * P)).
        wg_t = self.wg.T.contiguous()
        dlogits, dx_router = _by_chunks(
            lambda *rows: self._router_rows(wg_t, *rows),
            [dy, expert_out, cache["probs"], cache["topk_idx"]],
            cache["offset"])
        dx += dx_router
        x_full = self._allgather(x, "agx")
        dl_full = self._allgather(dlogits, "agdl")
        self.g_wg += x_full.T @ dl_full
        return dx

    def apply_grads(self, lr: float) -> None:
        """Plain SGD on the router and the owned experts, then zero the
        grads.  The router grad is already the global batch's, so every
        rank applies the same bytes."""
        lr = float(np.float32(lr))
        for p, g in ((self.wg, self.g_wg), (self.w1, self.g_w1),
                     (self.b1, self.g_b1), (self.w2, self.g_w2),
                     (self.b2, self.g_b2)):
            p -= lr * g
        self.zero_grads()
