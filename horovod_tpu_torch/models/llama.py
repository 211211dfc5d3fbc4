"""Llama-family decoder-only transformer, dense path (PyTorch).

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
``num_experts > 1`` (MoE) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.rms_norm import rms_norm

__all__ = ["LlamaConfig", "LlamaModel", "RMSNorm", "SwiGLU", "LlamaLayer",
           "LlamaAttention", "rope_freqs", "apply_rope", "causal_attention"]


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
    num_experts: int = 1          # >1 is MoE: not ported yet
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


def _require_dense(cfg: LlamaConfig) -> None:
    if cfg.num_experts > 1:
        raise NotImplementedError("the port supports dense (non-MoE) "
                                  "configs only; MoEBlock is not ported yet "
                                  "(ROADMAP.md Queue A item 5)")


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

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """Projections of x [B, S, H] with RoPE applied to q and k."""
        cfg = self.config
        B, S, _ = x.shape
        D = cfg.head_dim
        q = self.wq(x).reshape(B, S, cfg.num_heads, D)
        k = self.wk(x).reshape(B, S, cfg.num_kv_heads, D)
        v = self.wv(x).reshape(B, S, cfg.num_kv_heads, D)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(self, x, cos, sin):
        B, S, _ = x.shape
        q, k, v = self.qkv(x, cos, sin)
        out = self.attention_fn(q, k, v)
        return self.wo(out.reshape(B, S, -1))


class SwiGLU(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        # Fused gate+up: one [H, 2F] matmul.
        self.w_gate_up = nn.Linear(cfg.hidden_size,
                                   2 * cfg.intermediate_size, **kw)
        self.w_down = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        gate, up = torch.chunk(self.w_gate_up(x), 2, dim=-1)
        return self.w_down(gate * torch.sigmoid(gate) * up)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        self.norm_attn = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                 device, cfg.fused_rmsnorm)
        self.attn = LlamaAttention(cfg, device, attention_fn)
        self.norm_mlp = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                device, cfg.fused_rmsnorm)
        self.mlp = SwiGLU(cfg, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm_attn(x), cos, sin)
        return x + self.mlp(self.norm_mlp(x))


class LlamaModel(nn.Module):
    """The dense Llama decoder.  ``forward(input_ids)`` returns logits
    [B, S, V] in ``logits_dtype``; ``models/generation.py`` runs the same
    weights with a KV cache."""

    def __init__(self, cfg: LlamaConfig, device=None,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        _require_dense(cfg)
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

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and output projection in ``logits_dtype``."""
        x = self.norm_f(x)
        return F.linear(x.to(self.config.logits_dtype), self.lm_head.weight)

    def forward(self, input_ids: torch.Tensor, *,
                positions_offset: int = 0) -> torch.Tensor:
        cfg = self.config
        x = self.tok_emb(input_ids)
        cos, sin = rope_freqs(cfg.head_dim, input_ids.shape[1],
                              cfg.rope_theta, offset=positions_offset,
                              device=input_ids.device)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.head(x)
