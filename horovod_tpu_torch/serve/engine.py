"""The replica's model execution engine: paged prefill/decode on a device.

Counterpart of ``horovod_tpu/serve/engine.py``.  Owns the model weights
and the physical KV block pool, and exposes the two host-level calls the
scheduler drives:

* ``prefill(prompt, table)`` — one sequence's prompt through the model
  in a single batched pass, K/V scattered into its funded blocks;
  returns the last-position logits.
* ``decode(tokens, tables, pos)`` — one token for every running
  sequence in a single batched step over the paged pool.

The geometry is the reference's: power-of-two padding buckets (prompt
span for prefill, batch width for decode), padded batch rows pointing at
the trash block, and every forward attending a physical cache of exactly
``max_blocks_per_seq * block_size`` slots.  Eager PyTorch has no jit to
key on those buckets; they keep the shapes the kernels see identical to
the reference's.  The pools are updated in place (the reference donates
them to its jitted programs).

Weights are seeded from ``HOROVOD_SERVE_PARAM_SEED`` on the target
device (``models/convert.init_params``): every port replica with the
same seed serves identical weights, but not the JAX replica's (different
generators).  ``HOROVOD_SERVE_CHECKPOINT`` needs the checkpoint plane,
which is not ported yet, and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.generation import (paged_decode_step,
                                                 paged_prefill,
                                                 paged_prefill_suffix)
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.serve.config import ServeConfig, _pow2_at_least
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK

__all__ = ["ModelRunner", "build_model_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model_config(serve_cfg: ServeConfig) -> LlamaConfig:
    """Resolve HOROVOD_SERVE_MODEL/_DTYPE into a LlamaConfig."""
    builder = getattr(LlamaConfig, serve_cfg.model, None)
    if builder is None:
        raise ValueError(f"unknown serve model {serve_cfg.model!r} "
                         "(no LlamaConfig builder of that name)")
    cfg = builder()
    if serve_cfg.dtype:
        dt = _DTYPES.get(serve_cfg.dtype)
        if dt is None:
            raise ValueError(f"unsupported HOROVOD_SERVE_DTYPE "
                             f"{serve_cfg.dtype!r}")
        cfg = dataclasses.replace(cfg, dtype=dt, logits_dtype=dt)
    return cfg


class ModelRunner:
    """Paged-KV model execution for one replica, on one device.

    ``device`` defaults to the CUDA device and raises without one; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, serve_cfg: ServeConfig, device=None):
        if serve_cfg.checkpoint:
            raise NotImplementedError(
                "HOROVOD_SERVE_CHECKPOINT: checkpoint restore is not ported "
                "yet (it comes with the checkpoint plane); unset it to "
                "serve seeded weights")
        self.device = resolve_device(device)
        self.serve_cfg = serve_cfg
        self.model_cfg = build_model_config(serve_cfg)
        mcfg = self.model_cfg
        self.model = LlamaModel.from_state_dict(
            mcfg, init_params(mcfg, serve_cfg.param_seed, self.device))
        #: manifest step the params came from (None = seeded params)
        self.checkpoint_step = None
        self.block_size = serve_cfg.block_size
        self.max_blocks_per_seq = serve_cfg.max_blocks_per_seq
        #: pool blocks INCLUDING the reserved trash block 0
        self.num_blocks = serve_cfg.kv_blocks + 1
        shape = (mcfg.num_layers, self.num_blocks, self.block_size,
                 mcfg.num_kv_heads, mcfg.head_dim)
        self.pool_k = torch.zeros(shape, dtype=mcfg.dtype, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=mcfg.dtype, device=self.device)
        #: fused paged-attention decode (HOROVOD_SERVE_FUSED_ATTN)
        self.fused_attn = bool(serve_cfg.fused_attn)

    @property
    def cache_len(self) -> int:
        """The pinned physical cache length every forward attends."""
        return self.max_blocks_per_seq * self.block_size

    def _ints(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    # -- host API --

    def warmup(self, max_tokens: int = 0) -> int:
        """Run every bucket steady-state serving will use once — each
        pow2 decode batch width up to ``max_batch`` and each pow2 prefill
        span up to ``max_tokens`` (0 = the ``HOROVOD_SERVE_WARMUP``
        knob), plus the prefix-hit suffix path when prefix caching is on
        — so the kernel build and cuBLAS's first-call set-up land before
        the replica takes traffic.  Every K/V write goes to the trash
        block.  Returns the number of buckets run."""
        cap = int(max_tokens) or self.serve_cfg.warmup_tokens
        if cap <= 0:
            return 0
        runs = 0
        tbl = np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)
        b = 1
        while True:
            zeros = np.zeros((b,), np.int32)
            self.decode(zeros.tolist(), [tbl] * b, zeros.tolist())
            runs += 1
            if b >= self.serve_cfg.max_batch:
                break
            b *= 2
        s = self.block_size
        top = min(_pow2_at_least(cap, self.block_size), self.cache_len)
        while s <= top:
            self.prefill([0] * s, [])
            runs += 1
            if self.serve_cfg.prefix_cache and \
                    self.block_size + s <= self.cache_len:
                self.prefill([0] * (self.block_size + s), [],
                             start=self.block_size)
                runs += 1
            s *= 2
        return runs

    def prefill(self, prompt: Sequence[int], table: Sequence[int],
                *, start: int = 0) -> np.ndarray:
        """Prompt (len S0 >= 1) through the model; ``table`` must fund
        ceil(S0/block_size) blocks.  Returns fp32 last-position logits
        [V].

        ``start`` (block-aligned, < S0) is the prefix-cache hit path:
        the first ``start`` positions' K/V already sit in the table's
        shared leading blocks, so only the suffix is computed."""
        s0 = len(prompt)
        cache_len = self.cache_len
        if start % self.block_size or not 0 <= start < s0:
            raise ValueError(f"start {start} not block-aligned in [0, {s0})")
        # Pow2 bucket of the computed span, clipped to the pinned cache.
        s_pad = min(_pow2_at_least(s0 - start, self.block_size),
                    cache_len - start)
        prompt_pad = np.zeros((1, s_pad), np.int32)
        prompt_pad[0, :s0 - start] = np.asarray(prompt[start:], np.int32)
        tbl = np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)
        tbl[:len(table)] = np.asarray(table, np.int32)
        ids = self._ints(prompt_pad).long()
        if start:
            logits, _, _ = paged_prefill_suffix(
                self.model, ids, self.pool_k, self.pool_v, self._ints(tbl),
                prompt_len=s0, start=start, cache_len=cache_len)
        else:
            logits, _, _ = paged_prefill(
                self.model, ids, self.pool_k, self.pool_v, self._ints(tbl),
                prompt_len=s0, cache_len=cache_len)
        return logits[0].float().cpu().numpy()

    def decode(self, tokens: Sequence[int], tables: Sequence[np.ndarray],
               pos: Sequence[int]) -> np.ndarray:
        """One token per running sequence; ``tables[i]`` is a
        [max_blocks_per_seq] int32 array.  Returns fp32 logits [B, V]."""
        b = len(tokens)
        b_pad = _pow2_at_least(b, 1)
        toks = np.zeros((b_pad,), np.int32)
        toks[:b] = np.asarray(tokens, np.int32)
        tbls = np.full((b_pad, self.max_blocks_per_seq), TRASH_BLOCK,
                       np.int32)
        for i, t in enumerate(tables):
            tbls[i] = t
        ps = np.zeros((b_pad,), np.int32)
        ps[:b] = np.asarray(pos, np.int32)
        logits, _, _ = paged_decode_step(
            self.model, self._ints(toks).long(), self.pool_k, self.pool_v,
            self._ints(tbls), self._ints(ps), fused=self.fused_attn)
        return logits[:b].float().cpu().numpy()
