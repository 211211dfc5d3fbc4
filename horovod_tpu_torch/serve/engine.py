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
``max_blocks_per_seq * block_size`` slots.  The pools are updated in
place (the reference donates them to its jitted programs).

The decode step is one program per pow2 width (:meth:`ModelRunner.
_decode_fn`, the counterpart of the reference's jitted ``_decode_fn``):
static int32 inputs fed by one host-to-device copy from pinned staging,
the ``paged_decode_step`` body, and a static fp32 logits output read back
by one device-to-host copy into pinned memory.  On CUDA the body is
captured once into a CUDA graph, after one eager warm-up run on the
capture stream, at :meth:`ModelRunner.warmup` or at the width's first
use, and every later step of that width is a replay.  On the CPU the same
body runs eagerly on the same buffers.  A capture or replay error
raises; there is no eager fallback on the card.  Prefill stays eager, one
bucket per pow2 span.  ``compilations`` counts the programs as the
reference counts its jit compilations: a decode program per width (a
graph captured on CUDA; ``captures`` counts those alone) and a prefill
program per bucket.

Weights are seeded from ``HOROVOD_SERVE_PARAM_SEED`` on the target
device (``models/convert.init_params``): every port replica with the
same seed serves identical weights, but not the JAX replica's (different
generators).  With ``HOROVOD_SERVE_CHECKPOINT=<dir>`` they are the newest
complete checkpoint's ``params`` slot instead, in the JAX package's flax
paths and layout (a JAX trainer's ``jax_capture`` or the port's), through
``models/convert.params_from_jax`` and cast to the model's dtype; a torn
or absent checkpoint, a missing ``params`` slot or leaf, or a shape
mismatch raises (never seeded weights in their place).  A checkpoint of
fewer layers than ``HOROVOD_SERVE_MODEL`` names (a depth cut of it, at
its widths) is served at its own depth.

A live weight push (:meth:`ModelRunner.apply_weights`, called by the
scheduler at a step boundary) copies the pushed leaves INTO the model's
parameters: the decode graphs read those tensors' storage, so they are
neither reallocated nor recaptured (``captures`` does not move).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.models.convert import (init_params, jax_paths,
                                              params_from_jax)
from horovod_tpu_torch.models.generation import (paged_decode_step,
                                                 paged_prefill,
                                                 paged_prefill_suffix)
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops import paged_attention, rms_norm
from horovod_tpu_torch.serve.config import ServeConfig, _pow2_at_least
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK

__all__ = ["ModelRunner", "build_model_config",
           "serve_collective_priority", "SERVE_DECODE_BAND"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The band serve-plane collectives stamp: 0 = most urgent, so decode
#: traffic preempts bulk gradient fusion when a replica shares an engine
#: world with training.
SERVE_DECODE_BAND = 0


def serve_collective_priority(environ=None) -> Optional[int]:
    """Priority the serve engine stamps on its collectives, or None when
    stamping does not apply (no engine world, or priority bands off).

    Only meaningful under ``HOROVOD_SERVE_ENGINE=1`` (the replica is an
    engine world) with ``HOROVOD_PRIORITY_BANDS>0``; serve decode then
    always takes band :data:`SERVE_DECODE_BAND`.
    """
    env = os.environ if environ is None else environ
    if env.get("HOROVOD_SERVE_ENGINE") != "1":
        return None
    try:
        bands = int(env.get("HOROVOD_PRIORITY_BANDS", "0") or "0")
    except ValueError:
        bands = 0
    return SERVE_DECODE_BAND if bands > 0 else None


def build_model_config(serve_cfg: ServeConfig) -> LlamaConfig:
    """Resolve HOROVOD_SERVE_MODEL/_DTYPE into a LlamaConfig.

    The served model's norms run through ``ops/rms_norm.py``
    (``fused_rmsnorm``): on the card its kernel reduces each row in one
    CTA in a fixed order, so a decoded row's bits depend on the row alone,
    never on how many rows share its step.  PyTorch's eager mean picks its
    reduction split by the row count, and on the card a row decoded at
    width 1 and at width 8 then parts now and then by one bf16 rounding of
    a norm, which lets a stream's tokens depend on its batch-mates.  On
    the CPU the norms' plain version is the eager math itself."""
    builder = getattr(LlamaConfig, serve_cfg.model, None)
    if builder is None:
        raise ValueError(f"unknown serve model {serve_cfg.model!r} "
                         "(no LlamaConfig builder of that name)")
    cfg = dataclasses.replace(builder(), fused_rmsnorm=True)
    if serve_cfg.dtype:
        dt = _DTYPES.get(serve_cfg.dtype)
        if dt is None:
            raise ValueError(f"unsupported HOROVOD_SERVE_DTYPE "
                             f"{serve_cfg.dtype!r}")
        cfg = dataclasses.replace(cfg, dtype=dt, logits_dtype=dt)
    return cfg


class _DecodeProgram:
    """The decode step at one pow2 batch width.

    Static buffers, allocated once: ``inputs`` on the device holds the
    block tables, tokens and positions ([width, MAXB] + [width] + [width]
    int32), filled by one copy from ``staging`` (pinned on CUDA); the body
    writes fp32 ``logits`` [width, V], read back by one copy into
    ``host_logits`` (pinned on CUDA).  On CUDA the body is a captured CUDA
    graph; on the CPU it runs eagerly on the same buffers.
    """

    def __init__(self, runner: "ModelRunner", width: int):
        self.runner = runner
        self.width = width
        dev = runner.device
        self.cuda = dev.type == "cuda"
        maxb = runner.max_blocks_per_seq
        n = width * (maxb + 2)
        self.staging = torch.empty(n, dtype=torch.int32, pin_memory=self.cuda)
        self.inputs = torch.zeros(n, dtype=torch.int32, device=dev)
        self.tables = self.inputs[:width * maxb].view(width, maxb)
        self.tokens = self.inputs[width * maxb:width * (maxb + 1)]
        self.pos = self.inputs[width * (maxb + 1):]
        stage = self.staging.numpy()
        self._stage_tables = stage[:width * maxb].reshape(width, maxb)
        self._stage_tokens = stage[width * maxb:width * (maxb + 1)]
        self._stage_pos = stage[width * (maxb + 1):]
        vocab = runner.model_cfg.vocab_size
        self.logits = torch.empty((width, vocab), dtype=torch.float32,
                                  device=dev)
        self.host_logits = (torch.empty((width, vocab), dtype=torch.float32,
                                        pin_memory=True)
                            if self.cuda else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: paged-decode kernel launches the graph holds (one a layer when
        #: the decode is fused), and RMSNorm kernel launches by name (two a
        #: layer and the final norm)
        self.kernel_launches = 0
        self.norm_launches: Dict[str, int] = {}

    def body(self) -> None:
        """The step on the static buffers: what the graph captures."""
        r = self.runner
        logits, _, _ = paged_decode_step(
            r.model, self.tokens.long(), r.pool_k, r.pool_v, self.tables,
            self.pos, fused=r.fused_attn)
        self.logits.copy_(logits)

    def capture(self) -> None:
        """One eager run of the body on the capture stream (PyTorch's
        warm-up before a capture: it allocates the kernel's counters and
        cuBLAS's workspace outside the graph), then the capture."""
        r = self.runner
        stream = r.capture_stream
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(r.device))
        with torch.cuda.stream(stream):
            self.body()
        torch.cuda.current_stream(r.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = paged_attention.captured
        norms = dict(rms_norm.captured)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.body()
        self.kernel_launches = paged_attention.captured - before
        self.norm_launches = {k: v - norms[k]
                              for k, v in rms_norm.captured.items()}
        self.graph = graph
        r.captures += 1
        r.capture_seconds += time.perf_counter() - t0

    def run(self, tokens: Sequence[int], tables: Sequence[np.ndarray],
            pos: Sequence[int]) -> np.ndarray:
        b = len(tokens)
        self._stage_tables[:] = TRASH_BLOCK
        for i, t in enumerate(tables):
            self._stage_tables[i] = t
        self._stage_tokens[:] = 0
        self._stage_tokens[:b] = np.asarray(tokens, np.int32)
        self._stage_pos[:] = 0
        self._stage_pos[:b] = np.asarray(pos, np.int32)
        self.inputs.copy_(self.staging, non_blocking=self.cuda)
        if not self.cuda:
            self.body()
            return self.logits[:b].numpy().copy()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        paged_attention.count_replay(self.kernel_launches)
        rms_norm.count_replay(self.norm_launches)
        self.host_logits.copy_(self.logits, non_blocking=True)
        torch.cuda.current_stream(self.runner.device).synchronize()
        return self.host_logits[:b].numpy().copy()


class ModelRunner:
    """Paged-KV model execution for one replica, on one device.

    ``device`` defaults to the CUDA device and raises without one; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, serve_cfg: ServeConfig, device=None):
        self.device = resolve_device(device)
        self.serve_cfg = serve_cfg
        self.model_cfg = build_model_config(serve_cfg)
        #: manifest step the params came from (None = seeded params)
        self.checkpoint_step = None
        if serve_cfg.checkpoint:
            # Sets model_cfg's depth to the checkpoint's.
            params = self._restore_checkpoint(serve_cfg.checkpoint)
        else:
            params = init_params(self.model_cfg, serve_cfg.param_seed,
                                 self.device)
        mcfg = self.model_cfg
        self.model = LlamaModel.from_state_dict(mcfg, params)
        self.block_size = serve_cfg.block_size
        self.max_blocks_per_seq = serve_cfg.max_blocks_per_seq
        #: pool blocks INCLUDING the reserved trash block 0
        self.num_blocks = serve_cfg.kv_blocks + 1
        shape = (mcfg.num_layers, self.num_blocks, self.block_size,
                 mcfg.num_kv_heads, mcfg.head_dim)
        self.pool_k = torch.zeros(shape, dtype=mcfg.dtype, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=mcfg.dtype, device=self.device)
        #: fused paged-attention decode (HOROVOD_SERVE_FUSED_ATTN) —
        #: static per runner, baked into every decode program.
        self.fused_attn = bool(serve_cfg.fused_attn)
        self._decode_fns: Dict[int, _DecodeProgram] = {}
        self._prefill_buckets: set = set()
        #: programs built: decode widths and prefill buckets
        self.compilations = 0
        #: CUDA graphs captured (decode widths on the card) and the
        #: seconds their warm-up runs and captures took
        self.captures = 0
        self.capture_seconds = 0.0
        self.capture_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

    def _restore_checkpoint(self, directory: str) -> Dict[str, torch.Tensor]:
        """The newest complete checkpoint's ``params`` slot as the port's
        state dict on the device, in the model's dtypes.  Raises on a
        torn or absent checkpoint, a missing ``params`` slot or leaf, or
        a geometry mismatch: serving random weights silently is worse
        than not starting."""
        from horovod_tpu_torch.checkpoint import (CheckpointError,
                                                  CheckpointLoader)
        from horovod_tpu_torch.checkpoint.loader import as_tensor

        loader = CheckpointLoader(directory)
        try:
            if "params" not in loader.slot_names():
                raise CheckpointError(
                    f"checkpoint step {loader.step} in {directory} has "
                    f"no 'params' slot (slots: {loader.slot_names()}) — "
                    "was it written by a trainer capture?")
            saved = set(loader.replicated_paths())
            depth = len({p.split(".")[1] for p in saved
                         if p.startswith("params.layer_")})
            if 0 < depth < self.model_cfg.num_layers:
                self.model_cfg = dataclasses.replace(self.model_cfg,
                                                     num_layers=depth)
            tree: dict = {}
            for path in jax_paths(self.model_cfg):
                if path not in saved:
                    raise CheckpointError(
                        f"checkpoint step {loader.step} has no value for "
                        f"'{path}'")
                arr = loader.read_replicated(path)
                # A bf16 leaf the JAX package wrote reloads as |V2.
                node = tree
                *keys, leaf = path.split(".")[1:]
                for key in keys:
                    node = node.setdefault(key, {})
                node[leaf] = as_tensor(arr, self.model_cfg.dtype).float() \
                    .numpy() if arr.dtype.kind == "V" else arr
            params = params_from_jax(tree, self.model_cfg, self.device)
            self.checkpoint_step = loader.step
            return params
        except ValueError as e:
            raise CheckpointError(
                f"checkpoint step {loader.step} in {directory} does not "
                f"fit the served model: {e}") from e
        finally:
            loader.close()

    def apply_weights(self, by_path: Dict[str, np.ndarray]) -> int:
        """Copy pushed leaves (``decode_leaves`` output: reference flax
        paths under ``w.params.``, ``[in, out]`` layout, fp32) into the
        model's parameters in place, cast to their dtypes; returns the
        number of leaves applied.  ``w.params.<layer>.mlp.w_gate.kernel``
        / ``w_up.kernel`` ([H, F]) land in their half of the fused
        ``w_gate_up``.  Every leaf is shape-checked before any is
        written; a mismatch raises ``ValueError``.  On the card the
        copies run on the current stream after the capture stream's work
        and are synchronised before this returns."""
        named = dict(self.model.named_parameters())
        layout = jax_paths(self.model_cfg)
        plan = []
        for path, arr in by_path.items():
            if not path.startswith("w."):
                continue
            key = path[2:]
            half = None
            if key not in layout:
                for suffix, h in ((".w_gate.kernel", 0), (".w_up.kernel", 1)):
                    if key.endswith(suffix):
                        fused = key[:-len(suffix)] + ".w_gate_up.kernel"
                        if fused in layout:
                            key, half = fused, h
                if half is None:
                    continue            # a leaf the model does not have
            name, kind = layout[key]
            dst = named[name].detach()
            if half is not None:
                f = dst.shape[0] // 2
                dst = dst[half * f:(half + 1) * f]
            want = tuple(dst.t().shape) if kind in (
                "dense", "head", "router") else tuple(dst.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"weights push leaf '{path}' has shape "
                    f"{tuple(arr.shape)}, replica expects {want} — pushed "
                    "model does not match the serving model")
            plan.append((dst, kind, arr))
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(
                self.capture_stream)
        with torch.no_grad():
            for dst, kind, arr in plan:
                src = torch.from_numpy(np.ascontiguousarray(arr))
                dst.copy_(src.t() if kind in ("dense", "head", "router")
                          else src)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return len(plan)

    @property
    def cache_len(self) -> int:
        """The pinned physical cache length every forward attends."""
        return self.max_blocks_per_seq * self.block_size

    def _ints(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    # -- program caches --

    def _decode_fn(self, b_pad: int) -> _DecodeProgram:
        """The decode program of one pow2 width, built at first use."""
        fn = self._decode_fns.get(b_pad)
        if fn is None:
            fn = _DecodeProgram(self, b_pad)
            self._decode_fns[b_pad] = fn
            self.compilations += 1
        return fn

    def _prefill_bucket(self, key) -> None:
        """Count a prefill bucket's first use, keyed as the reference keys
        its prefill programs."""
        if key not in self._prefill_buckets:
            self._prefill_buckets.add(key)
            self.compilations += 1

    # -- host API --

    def warmup(self, max_tokens: int = 0) -> int:
        """Build the programs steady-state serving will need — every pow2
        decode width up to ``max_batch`` (each captured into its CUDA
        graph on the card) and every pow2 prefill span up to
        ``max_tokens`` (0 = the ``HOROVOD_SERVE_WARMUP`` knob), plus the
        prefix-hit suffix path when prefix caching is on — so captures,
        the kernel build and cuBLAS's first-call set-up land before the
        replica takes traffic.  Every K/V write goes to the trash block.
        Returns the number of programs built."""
        cap = int(max_tokens) or self.serve_cfg.warmup_tokens
        if cap <= 0:
            return 0
        before = self.compilations
        self.warm_decode_widths()
        s = self.block_size
        top = min(_pow2_at_least(cap, self.block_size), self.cache_len)
        while s <= top:
            self.prefill([0] * s, [])
            if self.serve_cfg.prefix_cache and \
                    self.block_size + s <= self.cache_len:
                self.prefill([0] * (self.block_size + s), [],
                             start=self.block_size)
            s *= 2
        return self.compilations - before

    def warm_decode_widths(self) -> int:
        """Build (on the card: capture) the decode program of every pow2
        width up to ``max_batch`` that is not built yet, K/V writes to the
        trash block; returns how many were built.  The serve tuner's
        trials then never pay a capture inside a scoring window."""
        before = self.compilations
        tbl = np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)
        b = 1
        while True:
            if b not in self._decode_fns:
                zeros = [0] * b
                self.decode(zeros, [tbl] * b, zeros)
            if b >= self.serve_cfg.max_batch:
                break
            b *= 2
        return self.compilations - before

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
        s_pad = _pow2_at_least(s0 - start, self.block_size)
        if start and start + s_pad <= cache_len:
            self._prefill_bucket(("sfx", s_pad))
        else:
            s_pad = min(s_pad, cache_len - start)
            self._prefill_bucket(s_pad if start == 0 else
                                 (s_pad, start // self.block_size))
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
        [max_blocks_per_seq] int32 array.  Returns fp32 logits [B, V] on
        the host."""
        return self._decode_fn(_pow2_at_least(len(tokens), 1)).run(
            tokens, tables, pos)
