"""BERT encoder family (PyTorch).

Counterpart of ``horovod_tpu/models/bert.py``; the parity tests hold its
logits and gradients against the flax model on the same weights
(``models/convert.py``).  The math is the reference's:

* **Parameters are fp32 and computation runs in ``cfg.dtype``** (bf16 by
  default), as flax's ``param_dtype`` (fp32) and ``dtype=`` give it: every
  ``Dense`` casts its kernel, bias and input to ``dtype`` at each use, and
  the embedding tables are read in ``dtype``.  So the gradients are fp32
  and an optimizer steps the fp32 parameters directly, with no
  ``MasterWeights`` — unlike the port's Llama, whose weights are stored in
  bf16.
* One fused ``[H, 3H]`` QKV projection, its output read as
  ``[B, S, 3, heads, D]`` (q, k, v major).
* LayerNorm as flax's ``nn.LayerNorm(dtype=float32)``: statistics, scale
  and bias in fp32, eps 1e-6 (flax's default, not HF's 1e-12), the result
  cast back to ``dtype`` by the caller.  It runs as ``F.layer_norm`` on
  the fp32 input, which computes the variance as E[(x - E[x])²] where
  flax's ``use_fast_variance`` takes E[x²] - E[x]²: the two differ by fp32
  rounding (≲1e-6 relative at these widths), which the fp32 parity tests
  absorb at 2e-4 on hidden states and 1e-4 on logits.
* ``nn.gelu`` is the tanh approximation (``F.gelu(approximate="tanh")``),
  computed in fp32 and rounded to ``dtype`` once; jax on the CPU rounds
  each of its ops to bf16, an ulp apart on ~40 % of the outputs.
* Embeddings: token + position (+ token type) rows in ``dtype``, summed in
  ``dtype`` in that order, LayerNorm'd in fp32 and cast back.  Rows are
  gathered from the fp32 table and cast (the same values as gathering
  from the cast table; the table's gradient is summed in fp32, where the
  reference sums it in ``dtype``).  ``type_emb`` exists only if the
  parameters have it: the reference creates it only when ``init`` saw
  ``token_type_ids``.
* The MLM head is tied to the token embedding: ``h`` in ``dtype`` times
  the cast table, cast to fp32, plus the fp32 ``mlm_bias`` — fp32
  ``[B, S, V]`` logits.  The table's gradient sums both uses.
* The NSP head is a ``Dense(2)`` in fp32 on the first position.
* Dropout is active only with ``train=True`` and then needs an explicit
  ``torch.Generator`` on the activations' device (the reference's
  ``dropout`` rng); its bits are not the reference's.

Attention is a seam: ``attention_fn(q, k, v, mask)`` on ``[B, S, heads,
D]`` tensors with a ``[B, 1, 1, S]`` key mask (True = attend) or None;
:func:`dot_product_attention` by default, ``ops.flash_attention.
flash_attention_fn`` for the flash kernels (bidirectional with a mask,
causal without one).

A model placed on a mesh (``parallel/api.py`` ``shard_params``) holds
only its rank's block of each parameter, and its modules' ``placement``
(``parallel/placement.py``; None on one rank) names the axes of the
collectives (``parallel/comm.py``) in their forward, as in
``models/llama.py``: every weight is gathered over ``fsdp`` for its use;
``qkv``, ``mlp_in`` and ``mlm_transform`` are column-parallel and
``proj`` and ``mlp_out`` row-parallel over ``tensor``; the attention runs
on each rank's heads (on every head, from the gathered ``qkv`` product,
where the heads do not divide ``tensor``); ``mlm_transform``'s output is
gathered before ``mlm_ln``, which needs the whole H; the token table is
split on its vocabulary, so the lookup sums the ranks' rows and the tied
head's logits are gathered whole; the LayerNorms and ``nsp`` are
replicated.  Dropout draws on whole activations only, so ranks of one
``tensor`` group given generators in the same state draw the same bits.
Unplaced, every axis is None and each collective returns its input, so
one rank runs the same ops as before any placement.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.placement import UNPLACED

__all__ = ["BertConfig", "BertEncoder", "BertForPretraining", "BertLayer",
           "SelfAttention", "dot_product_attention", "LN_EPS"]

#: flax ``nn.LayerNorm``'s default epsilon.
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        """CI-sized config for tests and dry runs."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, max_position=128)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dot_product_attention(q, k, v, mask=None):
    """Default attention: softmax(QKᵀ/√d)V with fp32 logits.  q, k, v:
    [B, S, H, D]; ``mask`` broadcastable to [B, H, Sq, Sk] (True = attend)
    or None (every key).  The product runs in the inputs' dtype and is
    cast to fp32 (in bf16 the scores round to bf16 first, as in the
    reference), masked with ``finfo(fp32).min``, softmaxed in fp32 and cast
    to ``v.dtype`` before the PV product."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: identity unless ``train``; then keep each
    element with probability 1 - rate, scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train=True runs dropout, which needs an explicit "
                         "torch.Generator (generator=)")
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dense(nn.Linear):
    """flax ``nn.Dense(features, dtype=compute_dtype)``: an fp32 weight
    ``[out, in]`` and bias, cast with the input to ``compute_dtype`` at
    every use.  Placed, it is column-parallel where its weight's
    dimension 0 is split over ``tensor`` (the input through
    ``comm.copy_to``, this rank's part of the bias) and row-parallel where
    dimension 1 is (the partial sums through ``comm.reduce_from``, the
    bias added once after)."""

    placement = None

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, bias=True, device=device,
                         dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pl = self.placement or UNPLACED
        dt = self.compute_dtype
        w = pl.weight(self.weight).to(dt)
        row = pl.tensor_at(self.weight, 1)
        if row is not None:
            return comm.reduce_from(F.linear(x.to(dt), w), row) \
                + self.bias.to(dt)
        x = comm.copy_to(x, pl.tensor_at(self.weight, 0))
        return F.linear(x.to(dt), w,
                        pl.column_part(self.bias, self.weight).to(dt))


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=compute_dtype)``: an fp32 table read in
    ``compute_dtype``; :meth:`attend` is the tied output projection.
    With its rows split over ``tensor``, each rank looks up its own rows
    (zeros for the others' ids), the parts summed over the axis, and
    :meth:`attend` gives this rank's columns of the logits."""

    placement = None

    def __init__(self, num: int, features: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__(num, features, device=device, dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pl = self.placement or UNPLACED
        w = pl.weight(self.weight)
        vocab = pl.tensor_at(self.weight, 0)
        if vocab is None:
            return F.embedding(ids, w).to(self.compute_dtype)
        rows = w.shape[0]
        local = ids - vocab.index * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), w) \
            * inside[..., None].to(w.dtype)
        return comm.reduce_from(x, vocab).to(self.compute_dtype)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        pl = self.placement or UNPLACED
        dt = self.compute_dtype
        h = comm.copy_to(h, pl.tensor_at(self.weight, 0))
        return F.linear(h.to(dt), pl.weight(self.weight).to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 in, fp32 out, eps 1e-6."""

    def __init__(self, hidden: int, device=None):
        super().__init__(hidden, eps=LN_EPS, device=device,
                         dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class SelfAttention(nn.Module):
    placement = None

    def __init__(self, cfg: BertConfig, device=None,
                 attention_fn: Callable = dot_product_attention):
        super().__init__()
        self.config = cfg
        self.attention_fn = attention_fn
        H = cfg.hidden_size
        self.qkv = Dense(H, 3 * H, cfg.dtype, device)     # fused QKV
        self.proj = Dense(H, H, cfg.dtype, device)

    def forward(self, x, mask=None, *, train: bool = False, generator=None):
        """Where ``qkv``'s ``tensor`` block holds this rank's heads of q, k
        and v, the attention runs on them; where it is split otherwise,
        the product is gathered whole, every head attends, and the slice
        of the output the row-parallel ``proj`` reads is kept."""
        cfg = self.config
        pl = self.placement or UNPLACED
        B, S, _ = x.shape
        col = pl.tensor_at(self.qkv.weight, 0)
        local = self.qkv.weight in pl.parts
        qkv = self.qkv(x)
        if not local:
            qkv = comm.gather(qkv, col, -1)
        q, k, v = qkv.reshape(B, S, 3, -1, cfg.head_dim).unbind(2)
        out = self.attention_fn(q, k, v, mask).reshape(B, S, -1)
        if not local:
            out = comm.split(out, pl.tensor_at(self.proj.weight, 1), -1)
        out = self.proj(out)
        return dropout(out, cfg.dropout_rate, train, generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None,
                 attention_fn: Callable = dot_product_attention):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.attention = SelfAttention(cfg, device, attention_fn)
        self.ln_attn = LayerNorm(H, device)
        self.mlp_in = Dense(H, cfg.intermediate_size, cfg.dtype, device)
        self.mlp_out = Dense(cfg.intermediate_size, H, cfg.dtype, device)
        self.ln_mlp = LayerNorm(H, device)

    def forward(self, x, mask=None, *, train: bool = False, generator=None):
        cfg = self.config
        y = self.attention(x, mask, train=train, generator=generator)
        x = self.ln_attn(x + y).to(cfg.dtype)
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        y = dropout(y, cfg.dropout_rate, train, generator)
        return self.ln_mlp(x + y).to(cfg.dtype)


class BertEncoder(nn.Module):
    """Embeddings and the layer stack.  ``type_emb=False`` builds it
    without the token-type table (the reference's tree when ``init`` saw
    no ``token_type_ids``); passing ids to such an encoder raises."""

    def __init__(self, cfg: BertConfig, device=None,
                 attention_fn: Callable = dot_product_attention,
                 type_emb: bool = True):
        super().__init__()
        self.config = cfg
        H, dt = cfg.hidden_size, cfg.dtype
        self.tok_emb = Embed(cfg.vocab_size, H, dt, device)
        self.pos_emb = Embed(cfg.max_position, H, dt, device)
        self.type_emb = (Embed(cfg.type_vocab_size, H, dt, device)
                         if type_emb else None)
        self.ln_emb = LayerNorm(H, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device, attention_fn)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, train: bool = False, generator=None):
        cfg = self.config
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = self.tok_emb(input_ids) + self.pos_emb(pos)[None]
        if token_type_ids is not None:
            if self.type_emb is None:
                raise ValueError("token_type_ids given, but the parameters "
                                 "have no type_emb table")
            x = x + self.type_emb(token_type_ids)
        x = self.ln_emb(x).to(cfg.dtype)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, mask, train=train, generator=generator)
        return x

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """Project hidden states onto the (tied) token-embedding table."""
        return self.tok_emb.attend(h)


class BertForPretraining(nn.Module):
    """Encoder + MLM head (output projection tied to the token embedding)
    + NSP head.  ``forward`` returns (mlm_logits fp32 [B, S, V],
    nsp_logits fp32 [B, 2])."""

    def __init__(self, cfg: BertConfig, device=None,
                 attention_fn: Callable = dot_product_attention,
                 type_emb: bool = True):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.encoder = BertEncoder(cfg, device, attention_fn, type_emb)
        self.mlm_transform = Dense(H, H, cfg.dtype, device)
        self.mlm_ln = LayerNorm(H, device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 dtype=torch.float32,
                                                 device=device))
        self.nsp = Dense(H, 2, torch.float32, device)

    @classmethod
    def from_state_dict(cls, cfg: BertConfig, state: Dict[str, torch.Tensor],
                        attention_fn: Callable = dot_product_attention
                        ) -> "BertForPretraining":
        """Wrap ready tensors (``convert.init_params`` /
        ``convert.params_from_jax``) without allocating a second copy; the
        encoder has ``type_emb`` exactly when ``state`` does."""
        model = cls(cfg, device="meta", attention_fn=attention_fn,
                    type_emb="encoder.type_emb.weight" in state)
        model.load_state_dict(state, strict=True, assign=True)
        return model

    placement = None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, train: bool = False, generator=None):
        cfg = self.config
        pl = self.placement or UNPLACED
        x = self.encoder(input_ids, token_type_ids, attention_mask,
                         train=train, generator=generator)
        h = F.gelu(self.mlm_transform(x), approximate="tanh")
        h = comm.gather(h, pl.tensor_at(self.mlm_transform.weight, 0), -1)
        h = self.mlm_ln(h).to(cfg.dtype)
        vocab = pl.tensor_at(self.encoder.tok_emb.weight, 0)
        mlm_logits = self.encoder.attend(h).float() \
            + comm.split(self.mlm_bias, vocab, 0)
        nsp_logits = self.nsp(x[:, 0])
        return comm.gather(mlm_logits, vocab, -1), nsp_logits
