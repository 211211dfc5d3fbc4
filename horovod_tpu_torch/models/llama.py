"""Llama-family decoder-only transformer, dense and MoE (PyTorch).

Counterpart of ``horovod_tpu/models/llama.py``; the parity tests hold its
logits against the flax model on the same weights.  The math is the
reference's, op for op where it matters for the bits:

* RMSNorm statistics in fp32, the scale multiplied in fp32, the result
  cast to the compute dtype.
* RoPE on interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` in fp32 —
  not the rotate-half layout.
* GQA with the query heads grouped ``[Hkv, G]``; attention logits are
  the cache-dtype product cast to fp32, masked with ``finfo(fp32).min``,
  softmaxed in fp32 and cast back to the value dtype before the PV
  product.
* SwiGLU with one fused ``[H, 2F]`` gate+up projection split in halves,
  ``silu`` written as ``x * sigmoid(x)`` (two roundings, as in jax).
* Logits in ``logits_dtype`` (bf16 by default).

Weights are stored in the dtype they are computed in (the reference
keeps fp32 params and casts them at every use, which gives the same
values): projections and the embedding in ``dtype``, the head in
``logits_dtype``, norm scales in fp32.  ``models/convert.py`` builds them
(seeded, or from the JAX package's parameter tree).

Every parameter trains (``requires_grad``); the serving entry points of
``models/generation.py`` run under ``torch.no_grad()``.  Attention is a
seam, as in the reference: ``attention_fn(q, k, v)`` on [B, S, H, D]
tensors, :func:`causal_attention` by default, ``ops.flash_attention.
flash_attention_fn`` for training.

``fused_rmsnorm`` runs every RMSNorm through ``ops.rms_norm`` (the
RMSNorm kernels, forward and backward; the same math and parameters).

``num_experts > 1`` replaces each layer's SwiGLU with :class:`MoEBlock`,
the reference's top-k routed experts.  The reference computes every
expert on a masked copy of every token (its dense einsum dispatch); the
masked rows add exact zeros, so :func:`expert_ffn` runs each expert only
over the tokens routed to it and computes the same function.

A model placed on a mesh (``parallel/api.py`` ``shard_params``) holds
only its rank's block of each parameter, and its modules' ``placement``
(``parallel/placement.py``; None on one rank) names the axes of the
tensor-, expert- and fsdp-axis collectives (``parallel/comm.py``) in
their forward.  Unplaced, every axis is None and each collective returns
its input, so one rank runs the same ops as before any placement.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.rms_norm import rms_norm
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import AXIS_EXPERT
from horovod_tpu_torch.parallel.placement import UNPLACED

__all__ = ["LlamaConfig", "LlamaModel", "RMSNorm", "SwiGLU", "MoEBlock",
           "LlamaLayer", "LlamaAttention", "rope_freqs", "apply_rope",
           "causal_attention", "expert_ffn", "top_k_route"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 11008
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    num_experts: int = 1          # >1 enables MoE
    experts_per_token: int = 2
    dtype: torch.dtype = torch.bfloat16
    logits_dtype: torch.dtype = torch.bfloat16
    fused_rmsnorm: bool = False   # the RMSNorm kernels (ops/rms_norm.py)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                           num_heads=32, num_kv_heads=8,
                           intermediate_size=14336, max_seq_len=8192,
                           rope_theta=500000.0)

    @staticmethod
    def tiny(num_experts: int = 1) -> "LlamaConfig":
        """CI-sized config for tests, dry runs, and compile checks."""
        return LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, intermediate_size=128,
                           max_seq_len=256, num_experts=num_experts)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class RMSNorm(nn.Module):
    """fp32 statistics and scale, the result in ``dtype``; ``fused``
    runs ``ops.rms_norm.rms_norm`` (its kernels) on the same parameter."""

    def __init__(self, hidden: int, eps: float, dtype: torch.dtype,
                 device=None, fused: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.fused = fused
        self.scale = nn.Parameter(
            torch.ones(hidden, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return rms_norm(x, self.scale, eps=self.eps, out_dtype=self.dtype)
        x32 = x.float()
        x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                                + self.eps)
        return (x32 * self.scale).to(self.dtype)


def rope_freqs(head_dim: int, seq_len: int, theta: float, offset: int = 0,
               device=None):
    """cos/sin tables [S, head_dim/2] in fp32, positions offset..offset+S."""
    t = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    return rope_at(head_dim, t, theta)


def rope_at(head_dim: int, positions: torch.Tensor, theta: float):
    """cos/sin [N, head_dim/2] at the given positions — the same fp32 ops
    as :func:`rope_freqs`, so prefill and decode positions agree bitwise."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., ::2], x[..., 1::2]).  x: [B, S, H, D]; cos/sin
    [S, D/2] (shared by the batch) or [B, S, D/2] (per row)."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """GQA attention with the reference's rounding.

    q: [B, Sq, Hq, D]; k/v: [B, T, Hkv, D]; mask: bool, broadcastable to
    [B, 1, 1, Sq, T] (True = attend).  The score product runs in the
    cache dtype and is then cast to fp32 (in bf16 the scores round to
    bf16 before the ``/ sqrt(D)``), masked with ``finfo(fp32).min``,
    softmaxed in fp32 and cast to ``v.dtype`` before the PV product.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def causal_attention(q, k, v):
    """Default causal attention, fp32 logits, GQA-aware.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq % Hkv == 0.
    """
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    return attend(q, k, v, mask)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        self.config = cfg
        self.attention_fn = attention_fn
        D = cfg.head_dim
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.wq = nn.Linear(cfg.hidden_size, cfg.num_heads * D, **kw)
        self.wk = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * D, **kw)
        self.wv = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * D, **kw)
        self.wo = nn.Linear(cfg.num_heads * D, cfg.hidden_size, **kw)

    placement = None

    def _local_heads(self, pl) -> bool:
        """Whether each rank attends over its own heads: every projection
        split over ``tensor`` and both head counts divisible by it.
        Otherwise a split projection is gathered whole first."""
        cfg = self.config
        return (pl.tensor is not None
                and all(pl.tensor_at(lin.weight, 0) is not None
                        for lin in (self.wq, self.wk, self.wv))
                and cfg.num_heads % pl.tensor.size == 0
                and cfg.num_kv_heads % pl.tensor.size == 0)

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """Projections of x [B, S, H] with RoPE applied to q and k (this
        rank's heads where :meth:`_local_heads`)."""
        pl = self.placement or UNPLACED
        B, S, _ = x.shape
        local = self._local_heads(pl)
        cols = [pl.tensor_at(lin.weight, 0) for lin in (self.wq, self.wk,
                                                        self.wv)]
        x_tp = comm.copy_to(x, pl.tensor if any(cols) else None)

        def proj(lin, col):
            y = F.linear(x if col is None else x_tp, pl.weight(lin.weight))
            if not local:
                y = comm.gather(y, col, -1)
            return y.reshape(B, S, -1, self.config.head_dim)
        q, k, v = (proj(lin, c) for lin, c in zip((self.wq, self.wk,
                                                   self.wv), cols))
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(self, x, cos, sin):
        pl = self.placement or UNPLACED
        B, S, _ = x.shape
        q, k, v = self.qkv(x, cos, sin)
        out = self.attention_fn(q, k, v).reshape(B, S, -1)
        row = pl.tensor_at(self.wo.weight, 1)
        if not self._local_heads(pl):
            out = comm.split(out, row, -1)
        return comm.reduce_from(F.linear(out, pl.weight(self.wo.weight)),
                                row)


class SwiGLU(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        # Fused gate+up: one [H, 2F] matmul.
        self.w_gate_up = nn.Linear(cfg.hidden_size,
                                   2 * cfg.intermediate_size, **kw)
        self.w_down = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    placement = None

    def forward(self, x):
        pl = self.placement or UNPLACED
        col, widen, narrow, row = pl.swiglu(self.w_gate_up.weight,
                                            self.w_down.weight)
        h = F.linear(comm.copy_to(x, col), pl.weight(self.w_gate_up.weight))
        gate, up = torch.chunk(comm.gather(h, widen, -1), 2, dim=-1)
        a = comm.split(gate * torch.sigmoid(gate) * up, narrow, -1)
        return comm.reduce_from(F.linear(a, pl.weight(self.w_down.weight)),
                                row)


def top_k_route(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest of ``probs`` along the last
    dim, the lower index first among equal values — ``jax.lax.top_k``'s
    order, which ``torch.topk`` does not promise: a stable sort of
    ``-probs``."""
    sel = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return probs.gather(-1, sel), sel


def expert_ffn(x: torch.Tensor, combine: torch.Tensor, w_gate_up: torch.Tensor,
               w_down: torch.Tensor, *, widen=None, narrow=None,
               reduce=()) -> torch.Tensor:
    """``sum_e combine[..., e] * SwiGLU_e(x)`` over the experts of
    ``w_gate_up`` [E, H, 2F] and ``w_down`` [E, F, H] (``combine``'s
    columns, [B, S, E], aligned with them).  Expert ``e`` runs only over
    the tokens whose ``combine`` weight is nonzero (the reference's
    ``sel_mask``; its masked rows contribute exact zeros); the weighted
    outputs are summed in fp32 and cast once, as an einsum accumulates.
    Under a placement (:meth:`Placement.swiglu`), the gate/up product is
    gathered over ``widen`` and the activation split over ``narrow``, and
    the fp32 sum is summed over the ``reduce`` axes (each None or a
    ``comm`` axis)."""
    B, S, H = x.shape
    xf = x.reshape(B * S, H)
    cf = combine.reshape(B * S, -1)
    pairs = torch.nonzero((cf != 0).t())          # (expert, row), by expert
    counts = torch.bincount(pairs[:, 0], minlength=cf.shape[1]).tolist()
    y = torch.zeros((B * S, H), dtype=torch.float32, device=x.device)
    for e, rows in enumerate(torch.split(pairs[:, 1], counts)):
        if rows.numel() == 0:
            continue
        h = comm.gather(xf[rows] @ w_gate_up[e], widen, -1)
        gate, up = torch.chunk(h, 2, dim=-1)
        ye = comm.split(gate * torch.sigmoid(gate) * up, narrow, -1) \
            @ w_down[e]
        y = y.index_add(0, rows, ye.float() * cf[rows, e, None].float())
    y = comm.reduce_from(y, reduce)
    return y.to(x.dtype).reshape(B, S, H)


class MoEBlock(nn.Module):
    """Top-k routed mixture of SwiGLU experts: the reference's ``MoEBlock``
    (an fp32 router on x cast to fp32, softmax, top-k, the k weights
    renormalised and cast to ``dtype`` as the combine weights), with the
    expert weights in its layout and names: ``w_gate_up`` [E, H, 2F],
    ``w_down`` [E, F, H]."""

    placement = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        E, H, F_ = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = nn.Linear(H, E, bias=False, device=device,
                                dtype=torch.float32)
        self.w_gate_up = nn.Parameter(torch.empty(E, H, 2 * F_,
                                                  dtype=cfg.dtype,
                                                  device=device))
        self.w_down = nn.Parameter(torch.empty(E, F_, H, dtype=cfg.dtype,
                                               device=device))

    def route(self, x: torch.Tensor, router_weight=None) -> torch.Tensor:
        """The combine weights [B, S, E] in ``dtype``: each token's top-k
        experts' renormalised probabilities, zero elsewhere."""
        cfg = self.config
        w = self.router.weight if router_weight is None else router_weight
        probs = torch.softmax(F.linear(x.float(), w), dim=-1)
        weights, sel = top_k_route(probs, cfg.experts_per_token)
        weights = weights / weights.sum(dim=-1, keepdim=True)
        return torch.zeros(probs.shape, dtype=cfg.dtype,
                           device=x.device).scatter(-1, sel,
                                                    weights.to(cfg.dtype))

    def forward(self, x):
        pl = self.placement or UNPLACED
        combine = self.route(x, pl.weight(self.router.weight))
        col, widen, narrow, row = pl.swiglu(self.w_gate_up, self.w_down)
        # Each expert rank runs its own experts' columns of the combine;
        # their parts (and the row-split partial sums) are summed over the
        # axes the output leaves by.
        ep = pl.expert if pl.dim(self.w_gate_up, AXIS_EXPERT) == 0 else None
        n_local = self.w_gate_up.shape[0]
        e0 = ep.index * n_local if ep else 0
        c = comm.copy_to(combine, [ep, row])[..., e0:e0 + n_local]
        return expert_ffn(comm.copy_to(x, [ep, col]), c,
                          pl.weight(self.w_gate_up), pl.weight(self.w_down),
                          widen=widen, narrow=narrow, reduce=[ep, row])


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        self.is_moe = cfg.num_experts > 1
        self.norm_attn = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                 device, cfg.fused_rmsnorm)
        self.attn = LlamaAttention(cfg, device, attention_fn)
        self.norm_mlp = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                device, cfg.fused_rmsnorm)
        if cfg.num_experts > 1:
            self.moe = MoEBlock(cfg, device)
        else:
            self.mlp = SwiGLU(cfg, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm_attn(x), cos, sin)
        ffn = self.moe if self.is_moe else self.mlp
        return x + ffn(self.norm_mlp(x))


class LlamaModel(nn.Module):
    """The Llama decoder.  ``forward(input_ids)`` returns logits [B, S, V]
    in ``logits_dtype``; ``models/generation.py`` runs the same weights
    (dense configs) with a KV cache."""

    placement = None

    def __init__(self, cfg: LlamaConfig, device=None,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        self.config = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                    device=device, dtype=cfg.dtype)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device, attention_fn)
                                    for _ in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                              device, cfg.fused_rmsnorm)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 device=device, dtype=cfg.logits_dtype)

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, state: Dict[str, torch.Tensor],
                        attention_fn: Callable = causal_attention
                        ) -> "LlamaModel":
        """Wrap ready tensors (``convert.init_params`` /
        ``convert.params_from_jax``) without allocating a second copy:
        the module is built on the meta device and the tensors assigned
        (as trainable parameters)."""
        model = cls(cfg, device="meta", attention_fn=attention_fn)
        model.load_state_dict(state, strict=True, assign=True)
        return model

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embedding; with its rows split over ``tensor``, each
        rank looks up its own rows (zeros for the others' ids) and the
        parts are summed over the axis."""
        pl = self.placement or UNPLACED
        w = pl.weight(self.tok_emb.weight)
        vocab = pl.tensor_at(self.tok_emb.weight, 0)
        if vocab is None:
            return F.embedding(ids, w)
        rows = w.shape[0]
        local = ids - vocab.index * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), w) \
            * inside[..., None].to(w.dtype)
        return comm.reduce_from(x, vocab)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and output projection in ``logits_dtype``; with the
        head's columns split over ``tensor``, the logits are gathered whole
        over it."""
        pl = self.placement or UNPLACED
        x = self.norm_f(x).to(self.config.logits_dtype)
        vocab = pl.tensor_at(self.lm_head.weight, 0)
        logits = F.linear(comm.copy_to(x, vocab),
                          pl.weight(self.lm_head.weight))
        return comm.gather(logits, vocab, -1)

    def forward(self, input_ids: torch.Tensor, *,
                positions_offset: int = 0) -> torch.Tensor:
        cfg = self.config
        x = self.embed(input_ids)
        cos, sin = rope_freqs(cfg.head_dim, input_ids.shape[1],
                              cfg.rope_theta, offset=positions_offset,
                              device=input_ids.device)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.head(x)
