"""Autoregressive decoding with a KV cache for the Llama family (PyTorch).

Counterpart of ``horovod_tpu/models/generation.py``: the same functions
with the same math, over the port's :class:`LlamaModel` instead of a flax
parameter tree, run eagerly (there is no jit to fill).

* Contiguous cache: :func:`prefill`, :func:`decode_step`,
  :func:`generate` over caches ``[L, B, T, Hkv, D]``.
* Paged cache (the serving data path): :func:`paged_prefill`,
  :func:`paged_prefill_suffix`, :func:`paged_decode_step` over pools
  ``[L, NB, BS, Hkv, D]`` and per-sequence block tables.  Physical block
  0 is the trash block: padded rows and unfunded table entries point at
  it; it is written by padded rows and never read by a live one, so
  duplicate table entries only ever point at it.

The attention oracle keeps the reference's rounding exactly: the score
product runs in the cache dtype and is then cast to fp32 (in bf16 the
scores round to bf16 before ``/ sqrt(D)``), masked with
``finfo(fp32).min``, softmaxed in fp32 and cast to the value dtype before
the PV product.  RoPE at per-sequence positions (:func:`rope_at`) is the
same fp32 ops as the prefill tables.

**In place.**  Where the reference returns new arrays (its jitted
callers donate the pools), the port writes K/V into the caches and pools
it was given — ``index_put_`` on the pool, slice assignment on a
contiguous cache — and returns those same tensors.  A caller that needs
the old pool contents clones them first.

MoE configs are not supported here (dense decode path only).
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.models.llama import (LlamaModel, _require_dense,
                                            attend, rope_at, rope_freqs)
from horovod_tpu_torch.ops.paged_attention import paged_attention_decode

__all__ = ["prefill", "decode_step", "generate", "paged_prefill",
           "paged_prefill_suffix", "paged_decode_step"]


def _attend(q, k, v, *, q_pos, k_len: int):
    """q: [B,Sq,Hq,D]; k/v: [B,T,Hkv,D] (cache, only [:k_len] valid);
    ``q_pos``: [Sq] global positions."""
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < k_len)
    return attend(q, k, v, mask)


def _attend_b(q, k, v, *, q_pos, k_len):
    """:func:`_attend` with per-sequence positions: q [B,1,Hq,D];
    ``q_pos``/``k_len`` [B]."""
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = (k_pos[None, :] <= q_pos[:, None]) & \
        (k_pos[None, :] < k_len[:, None])                      # [B, T]
    return attend(q, k, v, mask[:, None, None, None, :])


def _layer(lp, x, cache_k, cache_v, *, pos0: int, k_len: int):
    """One decoder layer over x [B,S,H], writing K/V at [pos0, pos0+S) of
    this layer's cache [B,T,Hkv,D] in place."""
    cfg = lp.attn.config
    B, S, _ = x.shape
    cos, sin = rope_freqs(cfg.head_dim, S, cfg.rope_theta, offset=pos0,
                          device=x.device)
    q, k, v = lp.attn.qkv(lp.norm_attn(x), cos, sin)
    cache_k[:, pos0:pos0 + S] = k
    cache_v[:, pos0:pos0 + S] = v
    q_pos = torch.arange(S, device=x.device) + pos0
    out = _attend(q, cache_k, cache_v, q_pos=q_pos, k_len=k_len)
    x = x + lp.attn.wo(out.reshape(B, S, -1))
    return x + lp.mlp(lp.norm_mlp(x))


def _forward(model: LlamaModel, ids, caches_k, caches_v, *, pos0: int,
             k_len: int):
    x = model.tok_emb(ids)
    for i, lp in enumerate(model.layers):
        x = _layer(lp, x, caches_k[i], caches_v[i], pos0=pos0, k_len=k_len)
    return model.head(x), caches_k, caches_v


@torch.no_grad()
def prefill(model: LlamaModel, prompt_ids: torch.Tensor, *, cache_len: int):
    """Run the prompt [B, S0] through the model once, returning
    (last-position logits [B, V], (cache_k, cache_v)) with caches sized
    ``cache_len`` (>= S0 + tokens to generate)."""
    cfg = model.config
    _require_dense(cfg)
    B, S0 = prompt_ids.shape
    shape = (cfg.num_layers, B, cache_len, cfg.num_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=cfg.dtype, device=prompt_ids.device)
    cv = torch.zeros(shape, dtype=cfg.dtype, device=prompt_ids.device)
    logits, ck, cv = _forward(model, prompt_ids, ck, cv, pos0=0, k_len=S0)
    return logits[:, -1], (ck, cv)


@torch.no_grad()
def decode_step(model: LlamaModel, token: torch.Tensor, cache, *, pos: int):
    """One token [B] in, next-position logits [B, V] out; ``pos`` is the
    token's global position.  The cache is updated in place."""
    ck, cv = cache
    logits, ck, cv = _forward(model, token[:, None], ck, cv, pos0=pos,
                              k_len=pos + 1)
    return logits[:, -1], (ck, cv)


@torch.no_grad()
def generate(model: LlamaModel, prompt_ids: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, S0].

    ``temperature == 0`` is greedy argmax; otherwise softmax sampling at
    the given temperature from ``generator`` (required).  Returns
    [B, max_new_tokens].  ``cache_len`` pins the physical KV length
    (default ``S0 + max_new_tokens``); the serving stack attends
    ``max_model_len`` slots on every forward, so pass that value for the
    serve-equivalent reference.
    """
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    B, S0 = prompt_ids.shape
    if cache_len is None:
        cache_len = S0 + max_new_tokens
    if cache_len < S0 + max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < prompt + new tokens "
                         f"{S0 + max_new_tokens}")

    def pick(logits):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(prompt_ids.dtype)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt_ids.dtype)

    logits, cache = prefill(model, prompt_ids, cache_len=cache_len)
    toks = [pick(logits)]
    # Step i consumes the token at global position S0+i and produces the
    # token for position S0+i+1.
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(model, toks[-1], cache, pos=S0 + i)
        toks.append(pick(logits))
    return torch.stack(toks, dim=1)


def _paged_layer(lp, x, pk, pv, tables, *, pos, fused: bool):
    """One decoder layer over one decode token per sequence.

    x: [B, 1, H]; pk/pv: this layer's pool [NB, BS, Hkv, D] (written in
    place at each row's ``pos`` slot); tables: [B, MAXB] int32; pos: [B]
    int32.  Attends via the gather + :func:`_attend_b` oracle, or via the
    fused paged-attention op when ``fused``."""
    cfg = lp.attn.config
    B, S, _ = x.shape
    bs = pk.shape[1]
    cos, sin = rope_at(cfg.head_dim, pos, cfg.rope_theta)
    q, k, v = lp.attn.qkv(lp.norm_attn(x), cos[:, None], sin[:, None])
    blk = torch.gather(tables, 1, (pos // bs)[:, None].long())[:, 0].long()
    off = (pos % bs).long()
    pk[blk, off] = k[:, 0]
    pv[blk, off] = v[:, 0]
    if fused:
        out = paged_attention_decode(q, pk, pv, tables, pos)
    else:
        maxb = tables.shape[1]
        idx = tables.long()
        ck = pk[idx].reshape(B, maxb * bs, cfg.num_kv_heads, cfg.head_dim)
        cv = pv[idx].reshape(B, maxb * bs, cfg.num_kv_heads, cfg.head_dim)
        out = _attend_b(q, ck, cv, q_pos=pos, k_len=pos + 1)
    x = x + lp.attn.wo(out.reshape(B, S, -1))
    return x + lp.mlp(lp.norm_mlp(x))


@torch.no_grad()
def paged_decode_step(model: LlamaModel, tokens, pool_k, pool_v, tables,
                      pos, *, fused: bool = False):
    """One decode step for a batch of independent sequences over the
    paged pool.

    tokens: [B] current token per sequence; pool_k/pool_v:
    [L, NB, BS, Hkv, D]; tables: [B, MAXB] int32 block tables (unused
    tail entries and padded rows point at trash block 0); pos: [B] int32
    global position of each token.  Returns (next-position logits
    [B, V], pool_k, pool_v), the pools updated in place.  A padded row
    (pos 0, all-trash table) produces garbage logits the caller discards.

    ``fused`` selects the fused paged-attention op (the CUDA kernel on
    the card) instead of the gather oracle: equivalent within the
    documented tolerance, argmax-stable, not bitwise identical.
    """
    x = model.tok_emb(tokens[:, None])
    for i, lp in enumerate(model.layers):
        x = _paged_layer(lp, x, pool_k[i], pool_v[i], tables, pos=pos,
                         fused=fused)
    return model.head(x)[:, -1], pool_k, pool_v


@torch.no_grad()
def paged_prefill(model: LlamaModel, prompt_ids, pool_k, pool_v, table, *,
                  prompt_len: int, cache_len: Optional[int] = None,
                  start_blk: int = 0):
    """Prefill one sequence's (padded) prompt into its pool blocks.

    prompt_ids: [1, S_pad] with S_pad a multiple of the block size;
    table: [cache_len/BS] physical block ids (unfunded tail = trash 0).
    Returns (logits at the last prompt position [1, V], pool_k, pool_v).
    ``cache_len`` (default S_pad) is the physical length of the
    temporary contiguous cache the prompt attends over; the serving
    engine pins it to ``max_model_len``.

    ``start_blk`` > 0 is the prefix-cache hit path: the first
    ``start_blk`` table blocks already hold this prompt's K/V,
    ``prompt_ids`` is the padded suffix starting at ``start_blk * BS``,
    the contiguous cache is seeded by gathering the whole table, and only
    blocks ``>= start_blk`` are written back (copy-on-write).
    """
    cfg = model.config
    _require_dense(cfg)
    B, S_pad = prompt_ids.shape
    bs = pool_k.shape[2]
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if cache_len is None:
        cache_len = S_pad
    nb = cache_len // bs
    table = table.long()
    if start_blk == 0:
        shape = (L, B, cache_len, Hkv, D)
        ck = torch.zeros(shape, dtype=cfg.dtype, device=prompt_ids.device)
        cv = torch.zeros(shape, dtype=cfg.dtype, device=prompt_ids.device)
        logits, ck, cv = _forward(model, prompt_ids, ck, cv, pos0=0,
                                  k_len=prompt_len)
        pool_k[:, table] = ck[:, 0].reshape(L, nb, bs, Hkv, D)
        pool_v[:, table] = cv[:, 0].reshape(L, nb, bs, Hkv, D)
        return logits[:, prompt_len - 1], pool_k, pool_v
    start = start_blk * bs
    ck = pool_k[:, table].reshape(L, cache_len, Hkv, D)[:, None]
    cv = pool_v[:, table].reshape(L, cache_len, Hkv, D)[:, None]
    logits, ck, cv = _forward(model, prompt_ids, ck, cv, pos0=start,
                              k_len=prompt_len)
    tail = table[start_blk:]
    pool_k[:, tail] = ck[:, 0, start:].reshape(L, nb - start_blk, bs, Hkv, D)
    pool_v[:, tail] = cv[:, 0, start:].reshape(L, nb - start_blk, bs, Hkv, D)
    return logits[:, prompt_len - 1 - start], pool_k, pool_v


@torch.no_grad()
def paged_prefill_suffix(model: LlamaModel, prompt_ids, pool_k, pool_v,
                         table, *, prompt_len: int, start: int,
                         cache_len: int):
    """The prefix-cache hit path at any block-aligned ``start``
    (``0 < start < prompt_len``): the same math as :func:`paged_prefill`
    with ``start_blk = start / BS``, but the WHOLE table is written back.
    Positions below ``start`` pass through untouched from the gather
    seed, so every shared block is rewritten with exactly its own bytes
    (copy-on-write safe).  The caller guarantees
    ``start + S_pad <= cache_len``."""
    cfg = model.config
    _require_dense(cfg)
    bs = pool_k.shape[2]
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    nb = cache_len // bs
    if start + prompt_ids.shape[1] > cache_len:
        raise ValueError(f"suffix [{start}, {start + prompt_ids.shape[1]}) "
                         f"overruns the cache length {cache_len}")
    table = table.long()
    ck = pool_k[:, table].reshape(L, cache_len, Hkv, D)[:, None]
    cv = pool_v[:, table].reshape(L, cache_len, Hkv, D)[:, None]
    logits, ck, cv = _forward(model, prompt_ids, ck, cv, pos0=start,
                              k_len=prompt_len)
    pool_k[:, table] = ck[:, 0].reshape(L, nb, bs, Hkv, D)
    pool_v[:, table] = cv[:, 0].reshape(L, nb, bs, Hkv, D)
    return logits[:, prompt_len - 1 - start], pool_k, pool_v
