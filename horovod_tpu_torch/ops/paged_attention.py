"""Fused paged-attention decode: attend K/V straight through the block
table — no gather, no contiguous staging.

Counterpart of ``horovod_tpu/ops/paged_attention.py``.  The serving data
path keeps each layer's KV cache as a pool of fixed-size blocks
``[NB, BS, Hkv, D]`` plus a per-sequence table of physical block ids; the
gather oracle (``models/generation.py``) copies every sequence's blocks
into a contiguous view first.  This op walks the table instead, with an
fp32 online softmax over the live slots ``k_pos <= pos`` (one decode
token per sequence collapses the oracle's causal and length masks into
that one predicate).

Two implementations of one function, chosen by the tensors' device:

* on a CUDA tensor, the hand-written Hopper kernel
  ``csrc/paged_attention.cu`` (built with nvcc at first use,
  ``ops/_build.py``; one launch a call, which merges each row's token
  ranges itself) — or an exception, never a quiet fallback;
* on a CPU tensor, :func:`_decode_blockwise`, the plain PyTorch version:
  a masked fp32 online softmax over the table, by default in one pass
  over the whole table, and block by block under
  ``HOROVOD_PAGED_ATTN_CHUNK=1`` (the JAX package's variable, read the
  same way; the kernel takes the softmax of each range of slots and
  merges the ranges: the same function, summed in another order).  The
  CPU tests hold the walk against the JAX package's Pallas kernel and the
  one pass against the walk, and ``chip_smoke.py`` holds the CUDA kernel
  against the plain version on the card.

Both are numerically equivalent to the gather oracle, not bitwise: the
online softmax re-associates the reduction over keys (the reference's
contract: fp32 within 1e-4 of dense attention; through the bf16 model,
logits within 4 bf16 ULPs and argmax-stable).

:data:`launches` counts the kernel's launches (CUDA path only), so a run
can show that its decode steps went through the kernel.  Under a CUDA
graph capture a call records its launch into the graph instead
(:data:`captured`); the graph's owner adds the launches it holds to
:data:`launches` at every replay (:func:`count_replay`), where the kernel
really runs.
"""

from __future__ import annotations

import ctypes
import os

import torch

__all__ = ["paged_attention_decode", "launches", "captured", "count_replay",
           "range_tokens", "reset_launches"]

_NEG_INF = -1e30   # the reference kernel's mask value

#: Number of times the CUDA kernel ran: eager calls plus the launches
#: replayed from CUDA graphs (plain integer, reset by
#: :func:`reset_launches`).
launches = 0
#: Launches recorded into CUDA graphs while capturing (they run at replay).
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_fn = None
#: Per device: the kernel's int32 counters of finished ranges, one per
#: (sequence, KV head), zero between calls (the kernel's last range of a
#: row resets its own).  Kept allocated, so a captured CUDA graph can
#: replay the decode; a grown buffer keeps the old one alive for graphs
#: that captured it.
_counters = {}


def reset_launches() -> None:
    global launches
    launches = 0


def count_replay(n: int) -> None:
    """One replay of a CUDA graph that captured ``n`` launches of the
    kernel: they ran now."""
    global launches
    launches += n


def _chunk_cols(maxb: int) -> int:
    """Table columns folded into one online-softmax iteration of
    :func:`_decode_blockwise`: the whole table by default (one gather,
    one masked softmax: per-block dispatch, not flops, is the CPU's
    cost), ``HOROVOD_PAGED_ATTN_CHUNK`` columns where set (``1``: the
    per-block walk), as the JAX package's stand-in reads it."""
    raw = os.environ.get("HOROVOD_PAGED_ATTN_CHUNK", "").strip()
    if not raw:
        return maxb
    return max(1, min(int(raw), maxb))


def _decode_blockwise(q, pool_k, pool_v, tables, pos):
    """Online-softmax walk over the table, :func:`_chunk_cols` columns a
    step (by default one step over the whole table).

    q: [B, 1, Hq, D]; pool_k/pool_v: [NB, BS, Hkv, D]; tables: [B, MAXB]
    int32; pos: [B].  Returns [B, 1, Hq, D] in ``q.dtype``.  Scores are
    fp32 products of the stored values (bf16 x bf16 is exact in fp32),
    probabilities are rounded to ``v.dtype`` before the PV product, as in
    the kernel.  A walk of more than one step reads ``pos`` on the host
    and stops after the longest row's last live chunk: the chunks past it
    are fully masked, contribute exactly zero, and block 0 is live for
    every row, so the result is the full-table walk's bit for bit.  The
    one-step default reads nothing back.
    """
    B, _, Hq, D = q.shape
    BS, Hkv = pool_k.shape[1], pool_k.shape[2]
    G = Hq // Hkv
    maxb = tables.shape[1]
    C = _chunk_cols(maxb)
    nchunks = -(-maxb // C)
    tables = tables.long()
    if nchunks * C != maxb:
        # A ragged tail reads trash block 0: every padded column's slots
        # lie past MAXB*BS > pos, so the mask kills them.
        tables = torch.cat([tables, tables.new_zeros(
            (B, nchunks * C - maxb))], dim=1)
    if nchunks > 1:
        nchunks = min(nchunks, int(pos.max()) // (C * BS) + 1)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qg = q.reshape(B, Hkv, G, D).float()
    m = torch.full((B, Hkv, G), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    slots = torch.arange(C * BS, device=q.device)
    for j in range(nchunks):
        bids = tables[:, j * C:(j + 1) * C]
        kb = pool_k[bids].reshape(B, C * BS, Hkv, D).float()
        vb = pool_v[bids].reshape(B, C * BS, Hkv, D)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kb) * scale
        live = (j * C * BS + slots)[None, :] <= pos[:, None]   # [B, C*BS]
        s = torch.where(live[:, None, None, :], s, _NEG_INF)
        new_m = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgk,bkhd->bhgd", p.to(vb.dtype).float(), vb.float())
        m = new_m
    out = (acc / l[..., None]).to(q.dtype)
    return out.reshape(B, 1, Hq, D)


def _kernel_fn():
    global _fn
    if _fn is None:
        from horovod_tpu_torch.ops import _build

        fn = _build.load("paged_attention").hvd_paged_attention_decode
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def range_tokens() -> int:
    """Table slots one CTA of the kernel takes: each row's table is cut
    into ranges of this many slots, which the kernel merges in range
    order; ranges past a row's pos exit at once."""
    from horovod_tpu_torch.ops import _build

    return _build.load("paged_attention").hvd_paged_attention_range_tokens()


def _check(q, pool_k, pool_v, tables, pos):
    if not all(t.is_cuda for t in (q, pool_k, pool_v, tables, pos)):
        raise ValueError("paged_attention_decode: the CUDA kernel needs "
                         "every tensor on the CUDA device")
    if len({t.device for t in (q, pool_k, pool_v, tables, pos)}) != 1:
        raise ValueError("paged_attention_decode: tensors on different "
                         "devices")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or \
            pool_v.dtype != q.dtype:
        raise TypeError(f"paged_attention_decode: q/pools must share one "
                        f"dtype of float32/bfloat16, got {q.dtype}, "
                        f"{pool_k.dtype}, {pool_v.dtype}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention_decode: tables and pos must be "
                        "int32")
    if q.dim() != 4 or q.shape[1] != 1 or pool_k.dim() != 4 or \
            pool_v.shape != pool_k.shape:
        raise ValueError(f"paged_attention_decode: bad shapes q "
                         f"{tuple(q.shape)}, pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)}")
    B, _, Hq, D = q.shape
    _, BS, Hkv, Dk = pool_k.shape
    if Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention_decode: head dim {D} (pool "
                         f"{Dk}) not in {_HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"paged_attention_decode: {Hq} query heads not a "
                         f"multiple of {Hkv} kv heads")
    if BS < 1 or BS & (BS - 1):
        raise ValueError(f"paged_attention_decode: block size {BS} is not "
                         "a power of two")
    if tables.dim() != 2 or tables.shape[0] != B or tables.shape[1] < 1 \
            or pos.shape != (B,):
        raise ValueError(f"paged_attention_decode: tables "
                         f"{tuple(tables.shape)} / pos {tuple(pos.shape)} "
                         f"do not match batch {B}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("tables", tables), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_decode: {name} is not "
                             "contiguous")
        if name in ("q", "pool_k", "pool_v") and t.data_ptr() % 16:
            raise ValueError(f"paged_attention_decode: {name} is not "
                             "16-byte aligned")


def _range_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device`` that outlive the
    call (a fresh ``torch.zeros`` would be a second launch).  They are
    allocated outside a capture, by the eager run that precedes it: a
    buffer allocated inside would belong to the graph's private pool, and
    its zeroing would be captured."""
    kept = _counters.setdefault(device, [])
    if not kept or kept[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention_decode: no range counters for this width "
                "before the capture; run the call once outside it first")
        kept.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return kept[-1]


def _decode_cuda(q, pool_k, pool_v, tables, pos):
    global launches, captured
    _check(q, pool_k, pool_v, tables, pos)
    B, _, Hq, D = q.shape
    _, BS, Hkv, _ = pool_k.shape
    G = Hq // Hkv
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits = -(-tables.shape[1] * BS // range_tokens())
    # The partials of rows with more than one live range, which the same
    # launch reads back to merge them.
    part_ml = torch.empty((B, Hkv, splits, G, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, Hkv, splits, G, D), dtype=torch.float32,
                           device=q.device)
    counters = _range_counters(q.device, B * Hkv)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(),
                 counters.data_ptr(), B, Hkv, G, D, BS, tables.shape[1],
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed "
                           f"(error {err})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def paged_attention_decode(q, pool_k, pool_v, tables, pos):
    """Fused paged attention for one decode step.

    q: [B, 1, Hq, D] query (this step's token, post-RoPE, in the cache
    dtype); pool_k/pool_v: one layer's pool [NB, BS, Hkv, D] with the
    step's K/V already written at each row's ``pos`` slot; tables:
    [B, MAXB] int32 physical block ids (every id < NB; unused entries and
    padded rows point at trash block 0); pos: [B] int32 global position
    per row.  Returns [B, 1, Hq, D] in ``q.dtype``.

    CPU tensors take the plain version; anything else takes the CUDA
    kernel, which raises on what it cannot run.
    """
    if q.device.type == "cpu":
        return _decode_blockwise(q, pool_k, pool_v, tables, pos)
    return _decode_cuda(q, pool_k, pool_v, tables, pos)
