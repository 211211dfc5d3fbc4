#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel of the port from ``horovod_tpu_torch/csrc``
(one nvcc per source, all started together) and, beside them, the eager
engine from ``horovod_tpu_torch/cpp`` (g++), then:

1. device    — ``nvidia-smi`` name and power limit, torch device, build s;
2. kernels   — each kernel against its plain PyTorch version on the card
               at the main path's shapes (stated tolerances), with its
               median time, its bound, the plain version's time and one
               PyTorch library call's time as a yardstick: the paged
               decode; the three flash-attention kernels (forward, dQ,
               dK/dV) at the training shape and at ragged, fp32 and
               padded-head-dim shapes, with packed segment starts at
               the packed training shape and a ragged fp32 shape, and
               with the key-padding bias at BERT-base's shape (bf16,
               bidirectional, B 32 x S 512, 12 heads of 64, the BERT
               batch's lengths), a holed fp32 mask and a padded D 16; and
               at ``bench --model llama``'s shape (bf16, B 8 x S 2048, 8
               heads of 128, no GQA, causal);
               SDPA's backward is timed as the kernels are, a graph
               replay (forward and backward captured as one graph, less
               the forward), with the backend SDPA chose; the flash
               timing lines carry ptxas's registers and spills of the
               kernel and its grid's CTAs per SM;
   rms_kernels — the RMSNorm forward and backward at the packed training
               shape (R 4096, H 4096, bf16), a ragged fp32 R, an
               off-tile H and both sides of the backward's ring (H 8192
               and 8200); the backward timed alone and with the sum of
               its partials, F.rms_norm's backward as a graph replay;
   conv_bn_kernels — the 1x1 convolution with BatchNorm statistics at the
               spike's shape (ResNet-50's stage-2 1x1, x [200704, 512] ·
               w [512, 128], bf16), a ragged N, half a column block (C 64)
               and two (C 256), K and C off the tiles, K at MAX_K (640);
               with F.conv2d alone (channels-last bf16) as its library
               time and F.conv2d plus the fp32 statistics beside it;
   conv_bn_spike — the spike's three chained arms (``experiments/
               conv_bn_spike``: kernel, library, conv_only; 12 dependent
               iterations a call) and its check: B7's launches;
3. serve     — the port's serving replica (``ModelRunner`` + ``Scheduler``
               + ``ReplicaServer``, driven through ``ServeClient`` over
               TCP) on Llama-3-8B at its published widths (bf16, 32
               layers, seeded random weights) with the fused
               paged-attention decode: 8 concurrent requests, a shared
               256-token prefix; launch counts prove every decode layer
               went through the kernel;
4. oracle    — fused decode against the gather oracle on the same pools
               at full width, plus batch invariance: a row decoded alone
               and beside batch-mates through ``ModelRunner.decode`` must
               agree bit for bit; and each of the 8 served streams
               against its own offline ``generate`` at the pinned cache
               length (how many part from it, and where);
   profile   — where a batch-8 decode step's time goes (host wall time,
               device busy time and top kernels from torch.profiler);
5. train     — with the replica freed: the data-parallel training step
               (``hvd.init()`` over NCCL, ``make_train_step``,
               ``DistributedOptimizer`` over ``MasterWeights(AdamW)``,
               flash attention, ``softmax_cross_entropy``) on Llama-3-8B
               at its published widths cut to 4 layers, B 2 x S 2048,
               seeded weights:
   train_oracle — first, one forward and backward at B 1 through the
               kernels against the dense ``causal_attention`` on the same
               weights;
               then 3 warm-up and 10 timed steps on a fixed batch (the
               loss must fall; launch counts prove every layer's
               attention went through the three kernels);
6. train_packed — with the train phase's optimizer freed: packed-sequence
               pretraining (the ``examples/llama_packed_pretraining``
               recipe): the same widths and cut, ``fused_rmsnorm=True``
               (the RMSNorm kernels), flash attention with
               ``segment_ids`` and the loss masked at document
               boundaries, B 2 x S 2048 packed with documents of mean
               length 300:
   train_packed_oracle — first, at B 1 on the same weights: the segment
               kernels against the dense ``attend`` with the
               block-diagonal causal mask, and the fused model's logits
               against the unfused model's;
               then 3 warm-up and 10 timed steps (the loss must fall;
               launch counts prove every norm went through the RMSNorm
               kernels and every layer's attention through the three
               flash kernels with segments);
7. train_bert — BERT pretraining (the ``examples/bert_pretraining_fsdp``
               pieces: ``build_mesh({"data": 1, "fsdp": -1})``,
               ``shard_params``, AdamW, ``pretraining_loss``) on BERT-base
               at its published widths and full depth (12 layers, fp32
               parameters, bf16 compute), the flash seam (bidirectional,
               key bias), B 32 x S 512 padded as BERT's phase-2 data:
   bert_oracle — first, at B 8 on the same weights: loss, gradients and
               MLM logits through the flash seam against the dense
               ``dot_product_attention``;
               then 3 warm-up and 10 timed steps (the loss must fall;
               launch counts prove every layer's attention went through
               the three kernels, each launch with the key bias);
8. train_resnet — ResNet-50 data-parallel training through
               ``horovod_tpu_torch.bench``'s step (bench.py's headline):
               bf16, B 256 x 224², ``DistributedOptimizer(SGD 0.01,
               momentum 0.9)``, ``make_train_step`` (running statistics averaged);
               3 warm-up and 10 timed steps on a fixed batch (the loss
               must fall and the running statistics move), then one
               eval-mode forward, which must use the running statistics;
9. bench_llama — ``bench.py --model llama`` through
               ``horovod_tpu_torch.bench.llama_result`` at its full config
               (vocab 32000, hidden 1024, 16 layers, 8 heads of 128, FFN
               4096, B 8 x S 2048, bf16 weights, ``MasterWeights(AdamW)``):
               every bench key; the loss must fall and each layer's
               attention go through the three flash kernels (48 launches a
               step, no plain call);
10. engine   — the eager native engine on CUDA tensors: two ranks on the one
               card (this script, ``--engine-worker RANK``, started by the
               phase; no torch.distributed collective runs): ResNet-50's
               161 gradients (25,557,032 fp32 values) through
               ``grouped_allreduce`` bitwise against their host copies and
               timed, one 256 MiB allreduce, the ``wire_bf16`` wire within
               its envelope, allgather / broadcast / reducescatter /
               alltoall on bf16 and int64 tensors against a host
               computation, allreduce Sum and Average on fp32, bf16 and
               int64 bitwise against the host copies, and the ready event
               (an allreduce enqueued right behind the GEMM that writes its
               input); staging and engine times, the plane, the pinned pool;
11. train_profile, train_packed_profile, train_bert_profile,
               train_resnet_profile, bench_llama_profile — where one step
               of each goes
               (torch.profiler), after every phase was timed: once the
               profiler has traced a step, the process launches kernels
               more slowly; then train_packed_vs_train, the device time
               the packed step saves, by kernel group; and the key-bias
               kernels' ``kernel_time_kpm`` lines with train_bert's
               launches.  The ResNet profile also gives the forward device
               time of the three stage-2 1x1 512→128 convolutions and of
               the BatchNorms beside them: the spike's question inside the
               real step;
               and the flash kernels' ``kernel_time_bench`` lines with
               bench_llama's launches a step;
12. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Each phase prints one JSON line; any failed check raises (exit != 0) and
no result line is printed.  Without a CUDA device it exits 2 at once.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import bench
from horovod_tpu_torch.examples import bert_pretraining_fsdp as bert_example
from horovod_tpu_torch.examples.llama_packed_pretraining import (
    boundary_mask, make_packed_batch, packed_lm_loss)
from horovod_tpu_torch.experiments import conv_bn_spike
from horovod_tpu_torch.models.bert import BertConfig, dot_product_attention
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.generation import (generate, paged_decode_step,
                                                 paged_prefill)
from horovod_tpu_torch.models.llama import (LlamaConfig, LlamaModel, RMSNorm,
                                            attend, causal_attention)
from horovod_tpu_torch.common import native_build
from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import conv_bn_stats as cbs
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import paged_attention as pa
from horovod_tpu_torch.ops import rms_norm as rn
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.mixed_precision import MasterWeights
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.runtime import staging
from horovod_tpu_torch.runtime.engine import get_engine
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ModelRunner
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK
from horovod_tpu_torch.serve.scheduler import Scheduler
from horovod_tpu_torch.serve.server import ReplicaServer, ServeClient

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s
#: by input type (bf16 on tensor cores; fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: The reference's end-to-end fused-vs-oracle bound (tests/test_serve.py
#: FUSED_LOGIT_TOL): 4 bf16 ULPs at logit scale [4, 8).
FUSED_LOGIT_TOL = 0.125
L2_FLUSH_BYTES = 256 << 20   # > the 50 MB L2: kernels start cold

SERVE_ENV = {
    "HOROVOD_SERVE_MODEL": "llama3_8b",
    "HOROVOD_SERVE_FUSED_ATTN": "1",
    "HOROVOD_SERVE_MAX_MODEL_LEN": "2048",
    "HOROVOD_SERVE_BLOCK_SIZE": "16",
    "HOROVOD_SERVE_MAX_BATCH": "8",
    "HOROVOD_SERVE_PREFIX_CACHE": "1",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median time of one call between CUDA events, each call starting with
    a cold L2 (a 256 MiB buffer is rewritten before it, outside the timed
    span).  The span includes whatever host time the call spends before
    its kernels reach the card."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_events(prof):
    """(kernels, annotations): the profiler's device-side averages, split
    into what ran on the card and the user ranges drawn over it (an
    optimizer's ``step`` shows as one), which must not count as busy
    time twice."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    ranges = [e for e in events if getattr(e, "is_user_annotation", False)]
    return [e for e in events if e not in ranges], ranges


def autograd_graph_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """:func:`graph_ms` of ``fn`` that records or runs autograd: warmed up
    on a side stream and captured whole, forward and backward in one
    graph (PyTorch's recipe for whole-network capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters, flush)


def graph_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """:func:`cuda_ms` of a CUDA-graph replay of ``fn``: device time only,
    no host work inside the span."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters, flush)


# ---------------------------------------------------------------------------
# phase 2: paged_attention_decode against its plain version
# ---------------------------------------------------------------------------

def decode_case(B, Hkv, G, D, BS, maxb, nb, pos, trash_rows, dtype, seed,
                dev):
    """q/pools/tables/pos on the card: distinct random live blocks per row,
    trash (block 0) past each row's pos, all-trash tables for
    ``trash_rows`` (pos 0, as the engine pads a batch)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hkv * G, D), generator=gen, device=dev).to(dtype)
    pk = torch.randn((nb, BS, Hkv, D), generator=gen, device=dev).to(dtype)
    pv = torch.randn((nb, BS, Hkv, D), generator=gen, device=dev).to(dtype)
    tables = np.full((B, maxb), TRASH_BLOCK, np.int32)
    for i in range(B):
        if i in trash_rows:
            continue
        live = pos[i] // BS + 1
        tables[i, :live] = rng.permutation(np.arange(1, nb))[:live]
    return (q, pk, pv, torch.from_numpy(tables).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def decode_bound(q, pk, tables, pos):
    """(bound_ms, bound_by): the larger of the bytes the decode must move
    (q read and out written once, each row's live K and V slots and live
    table entries read once, pos read once) over HBM bandwidth, and its
    operations (scores + PV, 4 per query element per live slot) over the
    card's peak for the input type."""
    B, _, Hq, D = q.shape
    BS, Hkv = pk.shape[1], pk.shape[2]
    live = torch.clamp(pos.long() + 1, max=tables.shape[1] * BS)
    n_live = int(live.sum())
    n_blocks = int(((live + BS - 1) // BS).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + n_live * Hkv * D * 2 * pk.element_size()
              + 4 * n_blocks + 4 * B)
    ops = 4 * Hq * D * n_live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_yardstick(q, pk, pv, tables, pos):
    """One library call computing the same attention on gathered K/V:
    ``scaled_dot_product_attention`` over the whole table with a
    ``k_pos <= pos`` mask (the port never calls it)."""
    B, _, Hq, D = q.shape
    BS, Hkv = pk.shape[1], pk.shape[2]
    T = tables.shape[1] * BS
    idx = tables.long()
    k = pk[idx].reshape(B, T, Hkv, D).transpose(1, 2)
    v = pv[idx].reshape(B, T, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    v = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qh = q.transpose(1, 2).contiguous()                    # [B, Hq, 1, D]
    mask = (torch.arange(T, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_kernels(dev, flush, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    llama = dict(Hkv=8, G=4, D=128, BS=16, maxb=128, nb=513,
                 dtype=torch.bfloat16)
    cases = [
        dict(B=1, pos=[2047], trash_rows=(), **llama),
        dict(B=3, pos=[15, 16, 0], trash_rows=(2,), **llama),
        dict(B=8, pos=[2047, 1087, 600, 320, 100, 0, 16, 0],
             trash_rows=(7,), **llama),
        dict(B=4, pos=[0, 15, 16, 100], trash_rows=(), Hkv=2, G=2, D=16,
             BS=16, maxb=8, nb=40, dtype=torch.float32),
    ]
    max_err = 0.0
    timed = None
    for i, c in enumerate(cases):
        args = decode_case(c["B"], c["Hkv"], c["G"], c["D"], c["BS"],
                           c["maxb"], c["nb"], c["pos"], c["trash_rows"],
                           c["dtype"], seed + i, dev)
        got = pa.paged_attention_decode(*args)
        torch.cuda.synchronize()
        ref = pa._decode_blockwise(*args)
        check(tuple(got.shape) == tuple(args[0].shape)
              and got.dtype == c["dtype"], f"case {i}: output shape/dtype")
        g, r = got.float(), ref.float()
        check(bool(torch.isfinite(g).all()), f"case {i}: non-finite output")
        err = float((g - r).abs().max())
        if c["dtype"] == torch.float32:
            tol_ok = err <= 1e-5
            tol = "atol 1e-5"
        else:
            tol_ok = bool(((g - r).abs()
                           <= 2.0 ** -7 * torch.clamp(r.abs(), min=1.0)).all())
            tol = "|d| <= 2^-7 * max(1, |ref|)"
        emit("kernel_check", kernel="paged_attention_decode", case=i,
             B=c["B"], Hq=c["Hkv"] * c["G"], Hkv=c["Hkv"], D=c["D"],
             BS=c["BS"], maxb=c["maxb"], pos=c["pos"],
             dtype=str(c["dtype"]).replace("torch.", ""), max_abs_err=err,
             tolerance=tol, ok=tol_ok)
        check(tol_ok, f"case {i}: kernel disagrees with its plain version "
                      f"(max |d| {err})")
        max_err = max(max_err, err)
        if c["B"] == 8:
            timed = args
    q, pk, pv, tables, pos = timed
    kernel = lambda: pa.paged_attention_decode(*timed)  # noqa: E731
    ms = graph_ms(kernel, 50, flush)
    call_ms = cuda_ms(kernel, 50, flush)
    plain_ms = cuda_ms(lambda: pa._decode_blockwise(*timed), 10, flush)
    library_ms = graph_ms(sdpa_yardstick(*timed), 50, flush)
    bound_ms, bound_by = decode_bound(q, pk, tables, pos)
    # The grid: a CTA per (range of the kernel's slots, kv head, row), those
    # with a live token, and one launch (the merge is inside it).
    tokens = pa.range_tokens()
    slots = tables.shape[1] * pk.shape[1]
    splits = -(-slots // tokens)
    n_live = torch.clamp(pos.long() + 1, max=slots)
    grid = {"ctas": pk.shape[2] * q.shape[0] * splits, "splits": splits,
            "live_ctas": pk.shape[2] * int((-(-n_live // tokens)).sum()),
            "range_tokens": tokens, "launches_a_call": 1}
    entry = {"name": "paged_attention_decode", "route": "cuda",
             "source": "horovod_tpu_torch/csrc/paged_attention.cu",
             "replaces": "horovod_tpu/ops/paged_attention.py:176",
             "launches": None, "max_abs_err": max_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    emit("kernel_time", **entry, call_ms=call_ms, grid=grid,
         timed_shape={"B": 8, "Hq": 32, "Hkv": 8, "D": 128, "BS": 16,
                      "maxb": 128, "pos": [int(p) for p in pos.tolist()],
                      "dtype": "bfloat16"})
    return entry


# ---------------------------------------------------------------------------
# phase 2: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

#: (name, kernel wrapper, plain version, TPU kernel it replaces).
FLASH_KERNELS = (
    ("flash_fwd", fa.flash_fwd, fa._fwd_blockwise,
     "horovod_tpu/ops/flash_attention.py:113"),
    ("flash_bwd_dq", fa.flash_bwd_dq, fa._bwd_dq_blockwise,
     "horovod_tpu/ops/flash_attention.py:272"),
    ("flash_bwd_dkv", fa.flash_bwd_dkv, fa._bwd_dkv_blockwise,
     "horovod_tpu/ops/flash_attention.py:329"),
)
#: The training shape: Llama-3-8B's heads at B 2 x S 2048.
FLASH_TRAIN_SHAPE = dict(B=2, S=2048, Hq=32, Hkv=8, D=128)


def flash_inputs(dev, dtype, B, S, Hq, Hkv, D, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                          (B, S, Hq, D))]


def flash_within(got, ref, dtype, grad):
    """(ok, max |d|, tolerance).  fp32: the reference's own tolerances
    (tests/test_flash_attention.py): out 2e-5, grads 5e-4, abs + rel.
    bf16 out: |d| <= 2^-7 * max(1, |ref|), two bf16 ULPs of the larger of
    1 and the value (both sides round the fp32 result once; P is rounded
    to bf16 before P.V in both, but products sum in other orders).  bf16
    grads: |d| <= 3e-2 * max |ref| of the tensor (the reference's bf16
    bound): dS is rounded to bf16 before two products, so the error
    scales with the tensor, not the element."""
    g, r = got.detach().float(), ref.float()
    d = (g - r).abs()
    err = float(d.max())
    if not bool(torch.isfinite(g).all()):
        return False, err, "finite"
    if dtype == torch.float32:
        tol = 5e-4 if grad else 2e-5
        return bool((d <= tol + tol * r.abs()).all()), err, \
            f"|d| <= {tol} + {tol} * |ref|"
    if grad:
        return err <= 3e-2 * float(r.abs().max()), err, \
            "|d| <= 3e-2 * max|ref|"
    return bool((d <= 2.0 ** -7 * r.abs().clamp(min=1.0)).all()), err, \
        "|d| <= 2^-7 * max(1, |ref|)"


def flash_case_check(dev, case, seed):
    """Each kernel (through its wrapper) against its plain version on the
    same CUDA tensors; the backward kernels get the plain forward's lse
    and delta.  ``case["seg"]``: int32 [B, S] segment starts, or absent;
    ``case["mask"]``: bool [B, S] key-padding mask (the kernels get its
    key bias), or absent — then out and lse are held on the rows whose
    query is valid, and the cotangent is zero on the others.  Returns
    {kernel name: max |d|}."""
    dtype, causal = case["dtype"], case["causal"]
    shape = {k: case[k] for k in ("B", "S", "Hq", "Hkv", "D")}
    q, k, v, do = flash_inputs(dev, dtype, seed=seed, **shape)
    seg = case.get("seg")
    seg = None if seg is None else seg.to(dev)
    rows = bias = None
    if case.get("mask") is not None:
        rows = case["mask"].to(dev)
        bias = fa._key_bias(rows)
        do = do * rows[:, :, None, None].to(dtype)
    scale = shape["D"] ** -0.5
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, causal, scale, seg, bias)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    bwd_args = (q, k, v, do, ref_lse, delta.contiguous(), causal, scale, seg,
                bias)
    errs = {}
    for name, kernel, plain, _ in FLASH_KERNELS:
        args = (q, k, v, causal, scale, seg, bias) if name == "flash_fwd" \
            else bwd_args
        got = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        if name == "flash_fwd":
            # lse: fp32 on both sides; 1e-3 absolute is ~1e-4 relative at
            # the lse's scale (log S + max score).
            got_lse, ref_lse_ = got[1].transpose(1, 2), ref[1].transpose(1, 2)
            out, ref_o = got[0], ref[0]
            if rows is not None:
                got_lse, ref_lse_ = got_lse[rows], ref_lse_[rows]
                out, ref_o = out[rows], ref_o[rows]
            d_lse = float((got_lse - ref_lse_).abs().max())
            check(d_lse <= 1e-3, f"{name}: lse |d| {d_lse}")
            pairs = [(out, ref_o)]
        elif name == "flash_bwd_dq":
            pairs = [(got, ref)]
        else:
            pairs = list(zip(got, ref))
        results = [flash_within(g, r, dtype, grad=name != "flash_fwd")
                   for g, r in pairs]
        ok = all(r[0] for r in results)
        errs[name] = max(r[1] for r in results)
        emit("kernel_check", kernel=name, case=case["case"], **shape,
             causal=causal, dtype=str(dtype).replace("torch.", ""),
             segments=None if seg is None else n_segments(seg),
             masked_keys=None if rows is None else int((~rows).sum()),
             max_abs_err=errs[name], tolerance=results[0][2], ok=ok)
        check(ok, f"{name} case {case['case']}: kernel disagrees with its "
                  f"plain version (max |d| {errs[name]})")
    return errs


def flash_padded_check(dev, seed, case="c", B=1, D=96, mask=None):
    """Case (c): D 96 (or another D off 64/128) through the autograd
    wrapper, which zero-pads to the next multiple of 64 and keeps the true
    1/sqrt(D); held against the plain versions on the same padding, out
    and all three grads (fp32 tolerances).  Causal, or with a bool [B, S]
    ``mask`` bidirectional with the key bias (out on the valid query
    rows; zero cotangent on the others)."""
    S, causal = 200, mask is None
    q, k, v, do = flash_inputs(dev, torch.float32, B, S, 4, 2, D, seed)
    bias = rows = None
    if mask is not None:
        rows = mask.to(dev)
        bias = fa._key_bias(rows)
        do = do * rows[:, :, None, None]
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*xs, causal=causal, key_padding_mask=rows)
    out.backward(do)
    torch.cuda.synchronize()
    pad = [F.pad(t, (0, -D % 64)) for t in (q, k, v, do)]
    scale = D ** -0.5
    ref_out, lse = fa._fwd_blockwise(*pad[:3], causal, scale, None, bias)
    delta = (pad[3] * ref_out).sum(-1).transpose(1, 2).contiguous()
    args = (*pad, lse, delta, causal, scale, None, bias)
    ref_dq = fa._bwd_dq_blockwise(*args)
    ref_dk, ref_dv = fa._bwd_dkv_blockwise(*args)
    if rows is not None:
        out, ref_out = out[rows], ref_out[rows]
    errs = {}
    for name, got, ref in (("flash_fwd", out, ref_out),
                           ("flash_bwd_dq", xs[0].grad, ref_dq),
                           ("flash_bwd_dkv", xs[1].grad, ref_dk),
                           ("flash_bwd_dkv", xs[2].grad, ref_dv)):
        ok, err, tol = flash_within(got, ref[..., :D], torch.float32,
                                    grad=name != "flash_fwd")
        errs[name] = max(errs.get(name, 0.0), err)
        check(ok, f"{name} case {case} (D {D} padded): max |d| {err}")
    for name, err in errs.items():
        emit("kernel_check", kernel=name, case=case, B=B, S=S, Hq=4, Hkv=2,
             D=D, causal=causal, dtype="float32",
             masked_keys=None if rows is None else int((~rows).sum()),
             max_abs_err=err,
             tolerance="fp32 out 2e-5, grads 5e-4 (abs + rel)", ok=True)
    return errs


def n_segments(seg: torch.Tensor) -> int:
    """Documents in a batch of segment starts (one per run)."""
    pos = torch.arange(seg.shape[1], device=seg.device)
    return int((seg == pos).sum())


def attn_pairs(B, S, Hq, causal, seg=None, mask=None) -> int:
    """(query, key) pairs the attention computes: the causal triangle
    (B·Hq·S(S+1)/2), S² without causality, with segment starts the sum
    of each row's live keys r − start[r] + 1 — the block-diagonal
    triangles — or with a key-padding mask (bool [B, S], bidirectional)
    every query against the valid keys: what this run's data needs."""
    if seg is not None:
        pos = torch.arange(S, device=seg.device)
        return Hq * int((pos - seg + 1).sum())
    if mask is not None:
        return Hq * S * int(mask.sum())
    return B * Hq * (S * (S + 1) // 2 if causal else S * S)


def flash_bound(name, B, S, Hq, Hkv, D, causal, seg=None, mask=None):
    """(bound_ms, bound_by) at bf16: the larger of the bytes each input is
    read and each output written once over HBM bandwidth, and the tensor-
    core operations the live pairs need (2·D per query-key pair and
    product: 2 products forward; dQ 3, the scores recomputed; dK/dV 4)."""
    pairs = attn_pairs(B, S, Hq, causal, seg, mask)
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    q_bytes, kv_bytes, row_bytes = B * S * Hq * D * 2, B * S * Hkv * D * 2, \
        B * Hq * S * 4
    nbytes = {"flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
              "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
              "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
              }[name] + (0 if seg is None and mask is None else 4 * B * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * D * products * pairs / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: Each flash wrapper's bf16 kernel (ptxas's name for it), query or key
#: rows per work item, and the heads its grid spans.
FLASH_GRIDS = {"flash_fwd": ("fwd_bf16", 128, "Hq"),
               "flash_bwd_dq": ("bwd_dq_bf16", 128, "Hq"),
               "flash_bwd_dkv": ("bwd_dkv_bf16", 128, "Hkv")}


def flash_grid(name, B, S, Hq, Hkv, D):
    """The bf16 kernel's grid at a shape: work items (row blocks of a
    head), CTAs launched and the card's SMs.  The Hopper kernels fit one
    CTA on an SM and launch one per SM, each walking several items, when
    there are 4 items an SM or more (else one an item)."""
    _, rows, heads = FLASH_GRIDS[name]
    items = B * {"Hq": Hq, "Hkv": Hkv}[heads] * -(-S // rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    persistent = items >= 4 * sms
    ctas = sms if persistent else items
    return {"items": items, "ctas": ctas, "sms": sms,
            "items_per_cta": items / ctas}


def ptxas_entry(name, D, kind):
    """ptxas's report of the bf16 kernel of wrapper ``name`` at head dim D
    and sideband kind (0 dense, 1 segments, 2 key bias), from the build
    log: registers, spill stores and loads (bytes), and any other line
    that names it (a wgmma serialisation note)."""
    pat = re.compile(rf"\d{FLASH_GRIDS[name][0]}ILi{D}ELi{kind}EE")
    log = _build.build_log("flash_attention").splitlines()
    rep, cur = {"notes": []}, False
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = bool(pat.search(m.group(1)))
            continue
        if pat.search(line) and "Function properties" not in line:
            rep["notes"].append(line.strip())
        if not cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep["spill_stores"], rep["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep["registers"] = int(m[1])
    return rep


def ragged_starts(S: int) -> torch.Tensor:
    """int32 [1, S] starts with boundaries on a 64-row tile edge (64),
    inside a tile (100) and at 150."""
    ids = torch.zeros((1, S), dtype=torch.int64)
    for b in (64, 100, 150):
        ids[:, b:] += 1
    return fa._segment_starts(ids)


def flash_times(dev, flush, seed, seg=None, mask=None,
                shape=FLASH_TRAIN_SHAPE, causal=True):
    """Each kernel's time (CUDA-graph replay, cold L2) at ``shape``, its
    plain version's, its bound, and the library yardstick: SDPA (KV heads
    expanded) forward, and its backward, which computes dQ, dK and dV
    together (the port never calls it) — with is_causal (flash backend),
    with segments a boolean block-diagonal causal mask (SDPA has no
    packed-causal mode), or with a key-padding ``mask`` (bool [B, S]; the
    kernels get its key bias) SDPA's boolean [B, 1, 1, S] key mask."""
    q, k, v, do = flash_inputs(dev, torch.bfloat16, seed=seed, **shape)
    scale = shape["D"] ** -0.5
    bias = None if mask is None else fa._key_bias(mask)
    out, lse = fa.flash_fwd(q, k, v, causal, scale, seg, bias)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse, delta, causal, scale, seg, bias)
    G = shape["Hq"] // shape["Hkv"]
    qh = q.transpose(1, 2).detach().requires_grad_(True)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    doh = do.transpose(1, 2)
    if mask is not None:
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 attn_mask=mask[:, None, None, :],
                                 is_causal=causal)
    elif seg is None:
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 is_causal=True)
    else:
        pos = torch.arange(shape["S"], device=dev)
        mask = (pos[:, None] >= pos[None, :]) & \
            (seg[:, :, None] == seg[:, None, :])
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 attn_mask=mask[:, None])
    with torch.no_grad():
        lib_fwd_ms = graph_ms(lambda: sdpa(qh, kh, vh), 20, flush)
    backend = sdpa(qh, kh, vh).grad_fn.name()
    # SDPA's backward as the kernels are timed (graph replay, cold L2): the
    # forward and backward captured as one graph, less the forward alone
    # with grad (which also saves what the backward reads).
    fwd_grad_ms = autograd_graph_ms(lambda: sdpa(qh, kh, vh), 20, flush)
    both_ms = autograd_graph_ms(lambda: torch.autograd.grad(
        sdpa(qh, kh, vh), (qh, kh, vh), doh), 20, flush)
    lib_bwd_ms = both_ms - fwd_grad_ms
    times = {}
    for name, kernel, plain, _ in FLASH_KERNELS:
        args = (q, k, v, causal, scale, seg, bias) if name == "flash_fwd" \
            else bwd_args
        bound_ms, bound_by = flash_bound(name, causal=causal, seg=seg,
                                         mask=mask, **shape)
        times[name] = {
            "ms": graph_ms(lambda: kernel(*args), 20, flush),
            "plain_ms": cuda_ms(lambda: plain(*args), 3, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd_ms if name == "flash_fwd" else lib_bwd_ms,
            "library_backend": backend,
            "library_fwd_bwd_ms": both_ms, "library_fwd_grad_ms": fwd_grad_ms,
            "grid": flash_grid(name, **shape)}
    return times


def holed_mask(B, S) -> torch.Tensor:
    """bool [B, S]: ragged tails (the last row 37 keys short) and a run of
    masked keys in the middle, across a 64-key tile edge — the function
    takes any mask, not only a suffix."""
    mask = torch.arange(S)[None, :] < torch.tensor([S] * (B - 1)
                                                   + [S - 37])[:, None]
    mask[:, 50:140] = False
    return mask


#: BERT-base's attention at train_bert's shape: B 32 x S 512, 12 heads of
#: 64 (no GQA), bidirectional.
FLASH_KPM_SHAPE = dict(B=32, S=512, Hq=12, Hkv=12, D=64)
#: bench --model llama's attention: B 8 x S 2048, 8 heads of 128, causal.
FLASH_BENCH_SHAPE = dict(B=8, S=2048, Hq=8, Hkv=8, D=128)


def phase_flash_kernels(dev, flush, seed):
    """The flash cases and times.  Returns (kernels-line entries, the
    key-bias times at (a_kpm), which train_bert's launches complete, and
    the times at the bench's shape (a_bench), which bench_llama's
    complete)."""
    packed = packed_starts(seed)
    bert_mask = bert_batch(seed).attention_mask.bool()
    cases = [
        dict(case="a", dtype=torch.bfloat16, causal=True, **FLASH_TRAIN_SHAPE),
        dict(case="b", dtype=torch.float32, causal=True, B=1, S=200, Hq=4,
             Hkv=2, D=64),
        dict(case="b", dtype=torch.float32, causal=False, B=1, S=200, Hq=4,
             Hkv=2, D=64),
        dict(case="a_packed", dtype=torch.bfloat16, causal=True, seg=packed,
             **FLASH_TRAIN_SHAPE),
        dict(case="b_packed", dtype=torch.float32, causal=True, B=1, S=200,
             Hq=4, Hkv=2, D=64, seg=ragged_starts(200)),
        dict(case="a_kpm", dtype=torch.bfloat16, causal=False,
             mask=bert_mask, **FLASH_KPM_SHAPE),
        dict(case="b_kpm", dtype=torch.float32, causal=False, B=2, S=200,
             Hq=4, Hkv=2, D=64, mask=holed_mask(2, 200)),
    ]
    max_err = {name: 0.0 for name, *_ in FLASH_KERNELS}
    for i, case in enumerate(cases):
        for name, err in flash_case_check(dev, case, seed + 10 + i).items():
            max_err[name] = max(max_err[name], err)
    for name, err in flash_padded_check(dev, seed + 20).items():
        max_err[name] = max(max_err[name], err)
    for name, err in flash_padded_check(dev, seed + 21, case="c_kpm", B=2,
                                        D=16,
                                        mask=holed_mask(2, 200)).items():
        max_err[name] = max(max_err[name], err)
    bench_err = flash_case_check(dev, dict(case="a_bench",
                                           dtype=torch.bfloat16, causal=True,
                                           **FLASH_BENCH_SHAPE), seed + 22)
    for name, err in bench_err.items():
        max_err[name] = max(max_err[name], err)

    shape = FLASH_TRAIN_SHAPE
    dense = flash_times(dev, flush, seed)
    seg = packed.to(dev)
    packed_times = flash_times(dev, flush, seed, seg)
    pairs_dense = attn_pairs(causal=True, **{k: shape[k]
                                             for k in ("B", "S", "Hq")})
    pairs_packed = attn_pairs(causal=True, seg=seg,
                              **{k: shape[k] for k in ("B", "S", "Hq")})
    entries = []
    for name, _, _, replaces in FLASH_KERNELS:
        entry = {"name": name, "route": "cuda",
                 "source": "horovod_tpu_torch/csrc/flash_attention.cu",
                 "replaces": replaces, "launches": None,
                 "max_abs_err": max_err[name], **dense[name]}
        emit("kernel_time", **entry,
             ptxas=ptxas_entry(name, shape["D"], 0),
             library_call="scaled_dot_product_attention forward, is_causal"
             if name == "flash_fwd" else
             "scaled_dot_product_attention backward (dQ, dK, dV together)",
             timed_shape={**shape, "causal": True, "dtype": "bfloat16"})
        p = packed_times[name]
        emit("kernel_time_packed", name=name, **p,
             ptxas=ptxas_entry(name, shape["D"], 1),
             dense_ms=dense[name]["ms"], ms_ratio=p["ms"] / dense[name]["ms"],
             pairs=pairs_packed, dense_pairs=pairs_dense,
             pairs_ratio=pairs_packed / pairs_dense,
             segments=n_segments(seg), mean_doc=PACKED_MEAN_DOC,
             library_call="scaled_dot_product_attention with the boolean "
             "block-diagonal causal mask" + (" (backward: dQ, dK, dV)"
                                             if name != "flash_fwd" else ""),
             timed_shape={**shape, "causal": True, "dtype": "bfloat16",
                          "packed": True})
        entries.append(entry)
    mask = bert_mask.to(dev)
    kpm = flash_times(dev, flush, seed, mask=mask, shape=FLASH_KPM_SHAPE,
                      causal=False)
    for name in kpm:
        kpm[name].update(
            max_abs_err=max_err[name], dense_ms=dense[name]["ms"],
            ptxas=ptxas_entry(name, FLASH_KPM_SHAPE["D"], 2),
            pairs=attn_pairs(causal=False, mask=mask,
                             **{k: FLASH_KPM_SHAPE[k]
                                for k in ("B", "S", "Hq")}),
            masked_keys=int((~mask).sum()),
            library_call="scaled_dot_product_attention with the boolean "
            "[B, 1, 1, S] key mask" + (" (backward: dQ, dK, dV)"
                                       if name != "flash_fwd" else ""),
            timed_shape={**FLASH_KPM_SHAPE, "causal": False,
                         "dtype": "bfloat16", "key_bias": True})
    at_bench = flash_times(dev, flush, seed, shape=FLASH_BENCH_SHAPE)
    for name in at_bench:
        at_bench[name].update(
            max_abs_err=bench_err[name], dense_ms=dense[name]["ms"],
            ptxas=ptxas_entry(name, FLASH_BENCH_SHAPE["D"], 0),
            pairs=attn_pairs(causal=True, **{k: FLASH_BENCH_SHAPE[k]
                                             for k in ("B", "S", "Hq")}),
            library_call="scaled_dot_product_attention forward, is_causal"
            if name == "flash_fwd" else
            "scaled_dot_product_attention backward (dQ, dK, dV together)",
            timed_shape={**FLASH_BENCH_SHAPE, "causal": True,
                         "dtype": "bfloat16"})
    return entries, kpm, at_bench


# ---------------------------------------------------------------------------
# phase 2: the RMSNorm kernels against their plain versions
# ---------------------------------------------------------------------------

RMS_EPS = 1e-5
#: (case, R, H, x dtype, y/dy dtype): the packed training shape (R = B·S
#: rows of Llama-3-8B's hidden 4096, bf16), a ragged fp32 R, off-tile H,
#: and the backward's dispatch line: H 8192, the ring's widest row, and
#: 8200, one step past it (the two-pass kernel), with fewer rows than CTAs.
RMS_CASES = (
    ("path", 4096, 4096, torch.bfloat16, torch.bfloat16),
    ("ragged", 1000, 4096, torch.float32, torch.float32),
    ("off_tile_h", 64, 100, torch.bfloat16, torch.bfloat16),
    ("off_tile_h", 37, 100, torch.float32, torch.float32),
    ("ring_widest", 100, 8192, torch.bfloat16, torch.bfloat16),
    ("past_ring", 100, 8200, torch.float32, torch.float32),
)


def rms_inputs(dev, R, H, xdt, ydt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, H), generator=gen, device=dev).to(xdt)
    dy = torch.randn((R, H), generator=gen, device=dev).to(ydt)
    scale = 1.0 + 0.1 * torch.randn((H,), generator=gen, device=dev)
    return x, scale, dy


def rms_bound(name, R, H, xdt, ydt):
    """(bound_ms, bound_by): bytes each input is read and each output
    written once (forward: x, scale → y, rstd; backward: x, scale, rstd,
    dy → dx and the fp32 dscale [H] — the kernel's per-block partials are
    its own choice, not the function's output) over HBM bandwidth,
    against ~4 (forward) and ~10 (backward) fp32 operations an element
    over the 67 TFLOP/s of fp32 outside the tensor cores."""
    xs, ys = torch.finfo(xdt).bits // 8, torch.finfo(ydt).bits // 8
    if name == "rms_fwd":
        nbytes, ops = R * H * (xs + ys) + 4 * H + 4 * R, 4 * R * H
    else:
        nbytes = R * H * (2 * xs + ys) + 4 * H + 4 * R + 4 * H
        ops = 10 * R * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_rms_kernels(dev, flush, seed):
    """B4/B5 against their plain versions: bf16 y within one bf16 ulp of
    |y| (both round nearly the same fp32 value once; the statistic sums in
    another order), fp32 y and rstd within rel 1e-5; dx within 2e-2 of its
    max (bf16; fp32 1e-5); dscale (the summed partials) within rel 1e-4
    of its max.  Then times at the path's shape."""
    max_err = {"rms_fwd": 0.0, "rms_bwd": 0.0}
    timed = None
    for i, (case, R, H, xdt, ydt) in enumerate(RMS_CASES):
        x, scale, dy = rms_inputs(dev, R, H, xdt, ydt, seed + 30 + i)
        y, rstd = rn.rms_fwd(x, scale, RMS_EPS, ydt)
        dx, parts = rn.rms_bwd(x, scale, rstd, dy)
        torch.cuda.synchronize()
        ry, rr = rn._fwd_rows(x, scale, RMS_EPS, ydt)
        rdx, rparts = rn._bwd_rows(x, scale, rstd, dy)
        d_y = (y.float() - ry.float()).abs()
        y_rel = 2.0 ** -7 if ydt == torch.bfloat16 else 1e-5
        ok_fwd = (y.dtype == ydt and bool(torch.isfinite(y).all())
                  and bool((d_y <= y_rel * ry.float().abs()).all())
                  and bool(torch.allclose(rstd, rr, rtol=1e-5, atol=0)))
        dx_tol = 2e-2 if xdt == torch.bfloat16 else 1e-5
        err_dx = float((dx.float() - rdx.float()).abs().max())
        ds, rds = parts.sum(0), rparts.sum(0)
        err_ds = float((ds - rds).abs().max())
        ok_bwd = (dx.dtype == xdt and parts.shape == rparts.shape
                  and bool(torch.isfinite(dx).all())
                  and err_dx <= dx_tol * float(rdx.float().abs().max())
                  and err_ds <= 1e-4 * float(rds.abs().max()))
        dts = {"x": str(xdt).replace("torch.", ""),
               "y": str(ydt).replace("torch.", "")}
        emit("kernel_check", kernel="rms_fwd", case=case, R=R, H=H, **dts,
             max_abs_err=float(d_y.max()),
             tolerance=f"|d| <= {y_rel:g} * |y|; rstd rel 1e-5", ok=ok_fwd)
        emit("kernel_check", kernel="rms_bwd", case=case, R=R, H=H, **dts,
             max_abs_err=err_dx, dscale_max_abs_err=err_ds,
             tolerance=f"dx |d| <= {dx_tol:g} * max|dx|; dscale "
                       "|d| <= 1e-4 * max|dscale|", ok=ok_bwd)
        check(ok_fwd, f"rms_fwd case {case}: kernel disagrees with its "
                      f"plain version (max |d| {float(d_y.max())})")
        check(ok_bwd, f"rms_bwd case {case}: kernel disagrees with its "
                      f"plain version (dx {err_dx}, dscale {err_ds})")
        max_err["rms_fwd"] = max(max_err["rms_fwd"], float(d_y.max()))
        max_err["rms_bwd"] = max(max_err["rms_bwd"], err_dx)
        if case == "path":
            timed = (x, scale, dy, rstd)

    x, scale, dy, rstd = timed
    R, H = x.shape
    # Library yardstick: F.rms_norm with the scale in x's dtype (with an
    # fp32 weight it does not take its fused kernel); backward by autograd
    # for x and the weight, timed as SDPA's backward is (graph replay, cold
    # L2): forward and backward captured as one graph, less the forward
    # alone with grad.  The port never calls it.
    w = scale.to(x.dtype)
    with torch.no_grad():
        lib_fwd_ms = graph_ms(lambda: F.rms_norm(x, (H,), w, RMS_EPS), 50,
                              flush)
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_fwd_grad_ms = autograd_graph_ms(
        lambda: F.rms_norm(xl, (H,), wl, RMS_EPS), 50, flush)
    lib_fwd_bwd_ms = autograd_graph_ms(lambda: torch.autograd.grad(
        F.rms_norm(xl, (H,), wl, RMS_EPS), (xl, wl), dy), 50, flush)
    lib_bwd_ms = lib_fwd_bwd_ms - lib_fwd_grad_ms
    # What streaming the same bytes costs under the same convention: one
    # elementwise call that reads each input once and writes one output
    # (forward: x -> [R, H]; backward: x, dy -> [R, H]).
    out = torch.empty_like(x)
    same_bytes = {"rms_fwd": graph_ms(lambda: torch.neg(x, out=out), 50,
                                      flush),
                  "rms_bwd": graph_ms(lambda: torch.add(x, dy, out=out), 50,
                                      flush)}
    del out
    runs = {"rms_fwd": (lambda: rn.rms_fwd(x, scale, RMS_EPS, x.dtype),
                        lambda: rn._fwd_rows(x, scale, RMS_EPS, x.dtype),
                        lib_fwd_ms, "horovod_tpu/ops/rms_norm.py:46"),
            "rms_bwd": (lambda: rn.rms_bwd(x, scale, rstd, dy),
                        lambda: rn._bwd_rows(x, scale, rstd, dy),
                        lib_bwd_ms, "horovod_tpu/ops/rms_norm.py:55")}
    entries = []
    for name, (kernel, plain, lib_ms, replaces) in runs.items():
        bound_ms, bound_by = rms_bound(name, R, H, x.dtype, dy.dtype)
        entry = {"name": name, "route": "cuda",
                 "source": "horovod_tpu_torch/csrc/rms_norm.cu",
                 "replaces": replaces, "launches": None,
                 "max_abs_err": max_err[name],
                 "ms": graph_ms(kernel, 50, flush),
                 "plain_ms": cuda_ms(plain, 10, flush), "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms}
        extra = {"same_bytes_ms": same_bytes[name],
                 "same_bytes_call": "torch.neg(x)" if name == "rms_fwd"
                 else "torch.add(x, dy)"}
        if name == "rms_bwd":
            # The function's whole output: dx and dscale [H], the kernel
            # and the sum of its per-block partials in one graph.
            extra["ms_with_sum"] = graph_ms(
                lambda: rn.rms_bwd(x, scale, rstd, dy)[1].sum(0), 50, flush)
            extra.update(partials=-(-R // rn.block_rows(R)),
                         library_fwd_bwd_ms=lib_fwd_bwd_ms,
                         library_fwd_grad_ms=lib_fwd_grad_ms)
        emit("kernel_time", **entry, **extra,
             library_call="torch.nn.functional.rms_norm (bf16 weight)" + (
                 " backward (dx, dweight), graph replay of forward + "
                 "backward less the forward with grad"
                 if name == "rms_bwd" else ""),
             timed_shape={"R": R, "H": H, "x": "bfloat16", "y": "bfloat16",
                          "scale": "float32",
                          "row_block": rn.block_rows(R)})
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# phase 2: the conv + BatchNorm-statistics kernel against its plain version
# ---------------------------------------------------------------------------

#: (case, N, K, C): ResNet-50's 1x1 convolutions at batch 256 — the
#: spike's stage-2 shape, the stage-1 reduce (C 64: half of the kernel's
#: 128-channel column block) and the stage-3 reduce (C 256: two blocks) —
#: a ragged N, K and C off the kernel's tiles, and MAX_K (the x ring at
#: its shallowest, 2 stages, beside w's 160 KB column block).
CONV_BN_CASES = (
    ("spike", 200704, 512, 128),
    ("ragged", 1000, 512, 128),
    ("stage1_reduce", 802816, 256, 64),
    ("stage3_reduce", 200704, 512, 256),
    ("off_tile", 333, 72, 40),
    ("max_k", 4099, 640, 136),
)


def conv_bn_bound(N, K, C):
    """(bound_ms, bound_by): x and w read once, y (bf16) and the two fp32
    [C] sums written once, over HBM bandwidth, against the product's 2·N·K·C
    bf16 tensor-core operations plus the sums' 3·N·C fp32 ones."""
    nbytes = 2 * (N * K + K * C + N * C) + 2 * 4 * C
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * N * K * C / PEAK_OPS_PER_S[torch.bfloat16]
             + 3 * N * C / PEAK_OPS_PER_S[torch.float32]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_conv_bn_kernels(dev, flush, x2d, w2d, seed):
    """B7 against its plain version at every case: y within one bf16 ulp
    plus 1e-5 of the sum of its products' magnitudes (|d| <= 2^-7·|y| +
    1e-5·Σ_k |x_k·w_k|: both round an fp32 sum of exact bf16 products once,
    but the tensor cores and cuBLAS's fp32 GEMM accumulate in other orders
    and alignments, which moves a y that cancels to near zero by more than
    its own ulp); Σy within 1e-5 of the largest Σ|y| and
    Σy² within 1e-5 relative (fp32 sums of N terms in other orders); mean
    and var as the spike derives them.  Then times at the spike's shape:
    the kernel's wrapper (launch and the sum of its partials), its plain
    version, F.conv2d alone on channels-last bf16 (the conv_only arm: what
    the kernel must match while also producing the statistics) and
    F.conv2d with the fp32 statistics (the library arm)."""
    max_err = 0.0
    for i, (case, N, K, C) in enumerate(CONV_BN_CASES):
        if case == "spike":
            x, w = x2d, w2d
        else:
            gen = torch.Generator(device=dev).manual_seed(seed + 40 + i)
            x = torch.randn((N, K), generator=gen, device=dev).to(
                torch.bfloat16)
            w = (0.05 * torch.randn((K, C), generator=gen, device=dev)).to(
                torch.bfloat16)
        y, s1, s2 = cbs.conv_stats(x, w)
        torch.cuda.synchronize()
        ry, r1, r2 = cbs._conv_stats_rows(x, w)
        d = (y.float() - ry.float()).abs()
        err = float(d.max())
        mag = x.float().abs() @ w.float().abs()
        y_ok = (y.shape == (N, C) and bool(torch.isfinite(y).all())
                and bool((d <= 2.0 ** -7 * ry.float().abs()
                          + 1e-5 * mag).all()))
        del mag
        abs_sum = float((x.float() @ w.float()).abs().sum(0).max())
        d1 = float((s1 - r1).abs().max())
        d2 = float(((s2 - r2).abs() / r2).max())
        mean, rmean = s1 / N, r1 / N
        var, rvar = s2 / N - mean * mean, r2 / N - rmean * rmean
        ok = y_ok and d1 <= 1e-5 * abs_sum and d2 <= 1e-5
        emit("kernel_check", kernel="conv_bn_stats", case=case, N=N, K=K,
             C=C, dtype="bfloat16", max_abs_err=err,
             sum_abs_err=d1, sum_sq_rel_err=d2,
             mean_max_abs_err=float((mean - rmean).abs().max()),
             var_max_rel_err=float(((var - rvar).abs() / rvar).max()),
             tolerance="y |d| <= 2^-7 |y| + 1e-5 sum_k |x_k w_k|; sum |d| "
                       "<= 1e-5 * max sum|y|; sum of squares rel 1e-5",
             ok=ok)
        check(ok, f"conv_bn_stats case {case}: kernel disagrees with its "
                  f"plain version (y {err}, sums {d1}, {d2})")
        max_err = max(max_err, err)
        del x, w, y, ry
    N, K = x2d.shape
    C = w2d.shape[1]
    x4d, w4d = conv_bn_spike._nchw(x2d), conv_bn_spike._oihw(w2d)
    bound_ms, bound_by = conv_bn_bound(N, K, C)
    entry = {"name": "conv_bn_stats", "route": "cuda",
             "source": "horovod_tpu_torch/csrc/conv_bn_stats.cu",
             "replaces": "experiments/pallas_conv_bn_spike.py:39",
             "launches": None, "max_abs_err": max_err,
             "ms": graph_ms(lambda: cbs.conv_stats(x2d, w2d), 50, flush),
             "plain_ms": cuda_ms(lambda: cbs._conv_stats_rows(x2d, w2d), 10,
                                 flush),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": graph_ms(lambda: F.conv2d(x4d, w4d), 50, flush)}
    library_stats_ms = graph_ms(
        lambda: conv_bn_spike.library_conv_stats(x2d, w2d), 50, flush)
    emit("kernel_time", **entry, library_stats_ms=library_stats_ms,
         library_call="F.conv2d 1x1, channels-last bf16 (conv only)",
         library_stats_call="F.conv2d, then the fp32 mean and E[y^2] - "
                            "mean^2 over N, H, W",
         grid_rows=cbs.grid_rows(N, C, torch.cuda.get_device_properties(
             dev).multi_processor_count),
         timed_shape={"N": N, "K": K, "C": C, "dtype": "bfloat16"})
    return entry


def phase_conv_bn_spike(x2d, w2d):
    """The spike's question on the card: its check, then its three arms,
    each 12 dependent steps a call (median of 3 after 2 warm-up calls, host
    clock to a synchronising read), with B7's launch count reset just
    before the kernel arm and read just after."""
    conv_bn_spike.check(x2d, w2d)
    arms = conv_bn_spike.arms(x2d)
    out = {}
    for name in ("kernel", "library", "conv_only"):
        if name == "kernel":
            cbs.reset_launches()
        dt = conv_bn_spike.time_it(arms[name], w2d)
        if name == "kernel":
            launches = cbs.launches["conv_bn_stats"]
            plain = cbs.plain_calls["conv_bn_stats"]
        out[name] = {"ms": dt * 1e3,
                     "tflops": conv_bn_spike.FLOPS / dt / 1e12}
    calls = (2 + 3) * conv_bn_spike.REPEATS
    emit("conv_bn_spike", shape={"B": conv_bn_spike.B, "H": conv_bn_spike.H,
                                 "W": conv_bn_spike.W, "K": conv_bn_spike.K,
                                 "C": conv_bn_spike.C},
         repeats=conv_bn_spike.REPEATS, arms=out,
         kernel_vs_library=out["library"]["ms"] / out["kernel"]["ms"],
         kernel_vs_conv_only=out["conv_only"]["ms"] / out["kernel"]["ms"],
         check="kernel vs library: mean 2e-2, y 5e-2 (the spike's)",
         kernel_launches=launches, plain_calls=plain)
    check(launches == calls and plain == 0,
          f"conv_bn_spike: {launches} kernel launches (want {calls}), "
          f"{plain} plain calls")
    return launches


# ---------------------------------------------------------------------------
# phase 3: the serving replica on llama3_8b
# ---------------------------------------------------------------------------

def _serve_thread(sched, holder, started):
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)

    async def amain():
        server = ReplicaServer(sched)
        holder["port"] = await server.start("127.0.0.1", 0)
        started.set()
        await server.serve_until_shutdown()

    loop.run_until_complete(amain())
    loop.close()


def serve_requests(vocab, seed):
    """8 requests: prompts 64-1024 tokens, three sharing a 256-token
    prefix, 32-64 new tokens each."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 256).tolist()
    specs = [(None, 64, 32), ("shared", 64, 48), (None, 512, 64),
             ("shared", 200, 40), (None, 1024, 56), ("shared", 17, 33),
             (None, 128, 64), (None, 700, 45)]
    reqs = []
    for i, (kind, n, new) in enumerate(specs):
        tail = rng.integers(0, vocab, n).tolist()
        reqs.append((f"r{i}", (head + tail) if kind else tail, new))
    return reqs


def phase_serve(dev, seed):
    cfg = ServeConfig.from_env(dict(SERVE_ENV,
                                    HOROVOD_SERVE_PARAM_SEED=str(seed)))
    t0 = time.monotonic()
    runner = ModelRunner(cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    mcfg = runner.model_cfg
    t0 = time.monotonic()
    buckets = runner.warmup(max_tokens=1024)
    warmup_s = time.monotonic() - t0

    decode_ms = []
    inner_decode = runner.decode

    def timed_decode(*args, **kwargs):
        t = time.perf_counter()
        out = inner_decode(*args, **kwargs)     # returns host logits: synced
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    runner.decode = timed_decode
    sched = Scheduler(runner, cfg)
    sched_thread = threading.Thread(target=sched.run, daemon=True)
    sched_thread.start()
    holder, started = {}, threading.Event()
    srv = threading.Thread(target=_serve_thread,
                           args=(sched, holder, started), daemon=True)
    srv.start()
    check(started.wait(60), "replica server did not start")
    cli = ServeClient("127.0.0.1", holder["port"], timeout=60)
    reqs = serve_requests(mcfg.vocab_size, seed)

    pa.reset_launches()
    t_submit = {}
    t0 = time.monotonic()
    for rid, prompt, new in reqs:
        t_submit[rid] = time.monotonic()
        cli.start_generate(rid, prompt, new)
    results = {rid: cli.collect(rid, timeout=600) for rid, _, _ in reqs}
    wall = time.monotonic() - t0
    launches = pa.launches
    stats = cli.stats()

    ttft, n_tokens = [], 0
    for rid, prompt, new in reqs:
        evs = results[rid]
        check(evs[-1]["event"] == "done", f"{rid} ended with {evs[-1]}")
        toks = evs[-1]["tokens"]
        check(len(toks) == new, f"{rid}: {len(toks)} of {new} tokens")
        check(all(0 <= t < mcfg.vocab_size for t in toks),
              f"{rid}: token out of range")
        first = next(e for e in evs if e["event"] == "token")
        ttft.append((first["_recv_ts"] - t_submit[rid]) * 1e3)
        n_tokens += len(toks)
    steps = stats["decode_steps"]
    check(stats["batch_occupancy"] > 1, "no continuous-batching overlap")
    check(stats["prefix_hits"] > 0, "the shared prefix never hit")
    check(stats["kv_blocks_in_use"] == 0, "KV blocks leaked")
    check(stats["fused_attn_steps"] == steps, "a decode step skipped fusion")
    check(launches == mcfg.num_layers * steps,
          f"kernel launches {launches} != layers x decode steps "
          f"{mcfg.num_layers} x {steps}")
    emit("serve", model=cfg.model, layers=mcfg.num_layers,
         hidden=mcfg.hidden_size, vocab=mcfg.vocab_size,
         dtype=str(mcfg.dtype).replace("torch.", ""), requests=len(reqs),
         tokens=n_tokens, wall_s=wall, tokens_per_s=n_tokens / wall,
         ttft_ms_p50=statistics.median(ttft), ttft_ms_max=max(ttft),
         decode_step_ms_p50=statistics.median(decode_ms),
         decode_step_ms_max=max(decode_ms), decode_steps=steps,
         kernel_launches=launches, batch_occupancy=stats["batch_occupancy"],
         prefix_hits=stats["prefix_hits"],
         prefill_tokens_saved=stats["prefill_tokens_saved"],
         preemptions=stats["preemptions"],
         kv_blocks_in_use=stats["kv_blocks_in_use"], init_s=init_s,
         warmup_s=warmup_s, warmup_buckets=buckets,
         peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    cli.shutdown()
    srv.join(timeout=30)
    check(not srv.is_alive(), "replica server did not shut down")
    cli.close()
    sched.stop()
    sched_thread.join(timeout=30)
    check(not sched_thread.is_alive(), "scheduler thread did not stop")
    runner.decode = inner_decode
    return runner, launches, [(rid, prompt, results[rid][-1]["tokens"])
                              for rid, prompt, _ in reqs]


# ---------------------------------------------------------------------------
# phase 4: fused decode against the gather oracle at full width
# ---------------------------------------------------------------------------

def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def phase_oracle(runner, served, seed):
    model, dev = runner.model, runner.device
    bs, maxb = runner.block_size, runner.max_blocks_per_seq
    rng = np.random.default_rng(seed + 1)
    vocab = runner.model_cfg.vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (300, 77)]
    tables = np.full((2, maxb), TRASH_BLOCK, np.int32)
    nxt = 1
    steps = 4
    for i, p in enumerate(prompts):
        need = -(-(len(p) + steps) // bs)
        tables[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
    toks = []
    for i, p in enumerate(prompts):
        s_pad = -(-len(p) // bs) * bs
        ids = torch.zeros((1, s_pad), dtype=torch.long, device=dev)
        ids[0, :len(p)] = torch.tensor(p, device=dev)
        logits, _, _ = paged_prefill(
            model, ids, runner.pool_k, runner.pool_v,
            torch.from_numpy(tables[i]).to(dev), prompt_len=len(p),
            cache_len=runner.cache_len)
        toks.append(int(logits[0].float().argmax()))
    tbl = torch.from_numpy(tables).to(dev)
    max_d, bound_used, flips, decided = 0.0, FUSED_LOGIT_TOL, 0, 0
    for step in range(steps):
        pos = torch.tensor([len(p) + step for p in prompts],
                           dtype=torch.int32, device=dev)
        tok = torch.tensor(toks, dtype=torch.long, device=dev)
        # Fused first, then the oracle overwrites the same slots: the
        # sequence continues on the oracle's K/V.
        lf, _, _ = paged_decode_step(model, tok, runner.pool_k,
                                     runner.pool_v, tbl, pos, fused=True)
        lo, _, _ = paged_decode_step(model, tok, runner.pool_k,
                                     runner.pool_v, tbl, pos)
        lf, lo = lf.float(), lo.float()
        check(bool(torch.isfinite(lf).all()), "fused logits not finite")
        bound = max(FUSED_LOGIT_TOL, 4 * bf16_ulp(float(lo.abs().max())))
        bound_used = max(bound_used, bound)
        max_d = max(max_d, float((lf - lo).abs().max()))
        top2 = lo.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > bound
        decided += int(sure.sum())
        flips += int(((lf.argmax(-1) != lo.argmax(-1)) & sure).sum())
        toks = lo.argmax(-1).tolist()
    check(max_d <= bound_used, f"fused vs oracle max |dlogit| {max_d} > "
                               f"{bound_used}")
    check(flips == 0, f"{flips} argmax flips where the margin > bound")

    # Batch invariance: one row decoded alone, then padded to 8 rows, at
    # its last funded position (a position past its table would write its
    # K/V to the trash block, where the padded rows write theirs).
    row = {"tok": toks[0], "pos": len(prompts[0]) + steps - 1,
           "table": tables[0]}
    inv = {}
    for fused in (False, True):
        outs = []
        for width in (1, 8):
            t = np.zeros((width,), np.int64)
            t[0] = row["tok"]
            p = np.zeros((width,), np.int32)
            p[0] = row["pos"]
            tb = np.full((width, maxb), TRASH_BLOCK, np.int32)
            tb[0] = row["table"]
            lg, _, _ = paged_decode_step(
                model, torch.from_numpy(t).to(dev), runner.pool_k,
                runner.pool_v, torch.from_numpy(tb).to(dev),
                torch.from_numpy(p).to(dev), fused=fused)
            outs.append(lg[0].float())
        inv["fused" if fused else "oracle"] = {
            "bitwise_equal": bool(torch.equal(outs[0], outs[1])),
            "max_abs_diff": float((outs[0] - outs[1]).abs().max())}

    # Batch composition: a row through ModelRunner.decode alone (width 1)
    # and beside batch-mates (the other sequence and trash rows, width
    # max_batch) must give the same logits bit for bit, as a served stream
    # may not depend on who else is served.  Each call rewrites the rows'
    # own last funded K/V slots with the same values.
    trash = np.full((maxb,), TRASH_BLOCK, np.int32)
    width = runner.serve_cfg.max_batch
    last = [row["pos"], len(prompts[1]) + steps - 1]
    alone = runner.decode([toks[0]], [tables[0]], [last[0]])
    mates = runner.decode(toks + [1] * (width - 2),
                          [tables[0], tables[1]] + [trash] * (width - 2),
                          last + [0] * (width - 2))
    composition_bitwise = bool(np.array_equal(alone[0], mates[0]))
    check(composition_bitwise, "a decoded row's logits depend on its "
                               "batch-mates")

    # Every served stream vs its own contiguous-cache generate at the
    # pinned cache length, on the same card (the reference's contract:
    # docs/serving.md:172-181): the first index where they part, or the
    # stream's length where they agree throughout.  generate's path is not
    # the server's (a prefill at the prompt's own length, dense attention
    # over a contiguous cache, width 1), so on the card the two may part
    # where the greedy margin is below their rounding difference.
    agree = {}
    for rid, prompt, served_toks in served:
        ids = torch.tensor([prompt], dtype=torch.long, device=dev)
        offline = generate(model, ids, max_new_tokens=len(served_toks),
                           cache_len=runner.cache_len)[0].tolist()
        agree[rid] = next((i for i, (a, b) in
                           enumerate(zip(offline, served_toks)) if a != b),
                          len(served_toks))
    lengths = {rid: len(toks) for rid, _, toks in served}
    divergent = {rid: i for rid, i in agree.items() if i < lengths[rid]}
    emit("oracle", steps=steps, rows=len(prompts),
         max_abs_dlogit=max_d, bound=bound_used,
         argmax_decided=decided, argmax_flips=flips,
         batch_width_1_vs_8=inv,
         row_alone_vs_with_mates_bitwise=composition_bitwise,
         served_streams=len(served),
         served_tokens=sum(lengths.values()),
         served_vs_offline_generate_tokens_agree=agree,
         divergent_streams=len(divergent),
         first_divergent_index=divergent)


def phase_profile(runner):
    """Where one decode step's time goes at batch 8: host wall time of
    ``ModelRunner.decode`` against the device time of its kernels
    (``torch.profiler``), the top kernels by device time, and the idle
    share of the card."""
    from torch.profiler import ProfilerActivity, profile

    maxb = runner.max_blocks_per_seq
    table = np.arange(1, maxb + 1, dtype=np.int32)      # one long row
    width, pos, reps = 8, 1000, 5
    args = ([1] * width, [table] * width, [pos] * width)
    runner.decode(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.decode(*args)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            runner.decode(*args)
    kernels, _ = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", batch=width, pos=pos, fused=runner.fused_attn,
         step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms,
         kernels_per_step=sum(e.count for e in kernels) / reps,
         top=[{"name": e.key[:80],
               "ms_per_step": e.self_device_time_total / 1e3 / reps,
               "calls_per_step": e.count / reps} for e in top])


# ---------------------------------------------------------------------------
# phase 5: the data-parallel training step on llama3_8b widths, 4 layers
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4           # of 32: AdamW state for 8.03 B params is 128 GB
TRAIN_B, TRAIN_S = 2, 2048
WARMUP_STEPS, TIMED_STEPS = 3, 10
#: train_oracle bounds: bf16 model, and the oracle rounds its scores to
#: bf16 before the softmax (worth ~0.09 at logit scale in the serving
#: oracle), so loss and gradients differ by bf16 noise, not by method.
ORACLE_LOSS_TOL = 0.02
ORACLE_GRAD_REL_L2_TOL = 5e-2
#: Packed documents' mean length: the reference example's full setting.
PACKED_MEAN_DOC = 300


def lm_loss(model, tokens):
    logits = model(tokens[:, :-1])
    return softmax_cross_entropy(logits, tokens[:, 1:])


def set_attention(model, fn):
    for layer in model.layers:
        layer.attn.attention_fn = fn


def packed_batch(vocab, seed):
    """The packed training batch: (tokens [B, S+1], segment ids [B, S])
    from ``make_packed_batch``, CPU tensors."""
    return make_packed_batch(np.random.default_rng(seed + 3), vocab,
                             TRAIN_B, TRAIN_S, PACKED_MEAN_DOC)


def packed_starts(seed):
    """Segment starts of the packed training batch (int32 [B, S], CPU)."""
    return fa._segment_starts(
        packed_batch(LlamaConfig.llama3_8b().vocab_size, seed)[1])


def grad_rel_l2(model, got, want):
    """Per-parameter relative L2 error of the gradients ``got`` against
    ``want`` (lists in ``model.parameters()`` order): (worst name, worst,
    median)."""
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30)) for a, b in zip(got, want)]
    names = [n for n, _ in model.named_parameters()]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return names[worst], rel[worst], statistics.median(rel)


def phase_train_oracle(model, tokens):
    """One forward and backward at B 1 through the flash kernels and
    through the dense ``causal_attention`` (fp32 scores, 0.5 GB a layer),
    on the same weights, before the optimizer exists."""
    params = list(model.parameters())
    runs = {}
    for name, fn in (("flash", fa.flash_attention_fn),
                     ("dense", causal_attention)):
        set_attention(model, fn)
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens[:1])
        loss.backward()
        runs[name] = (float(loss.detach()),
                      [p.grad.detach().clone() for p in params])
    set_attention(model, fa.flash_attention_fn)
    model.zero_grad(set_to_none=True)
    lf, ld = runs["flash"][0], runs["dense"][0]
    worst_name, worst, median = grad_rel_l2(model, runs["flash"][1],
                                            runs["dense"][1])
    emit("train_oracle", batch=1, seq=TRAIN_S, loss_flash=lf, loss_dense=ld,
         loss_abs_diff=abs(lf - ld), loss_tol=ORACLE_LOSS_TOL,
         grad_rel_l2_max=worst, grad_rel_l2_worst=worst_name,
         grad_rel_l2_median=median, grad_rel_l2_tol=ORACLE_GRAD_REL_L2_TOL)
    check(math.isfinite(lf) and abs(lf - ld) <= ORACLE_LOSS_TOL,
          f"train_oracle: loss {lf} vs dense {ld}")
    check(worst <= ORACLE_GRAD_REL_L2_TOL,
          f"train_oracle: {worst_name} grad rel L2 {worst}")
    del runs


def make_step(model, loss_fn):
    """(optimizer, step): ``DistributedOptimizer(MasterWeights(AdamW))`` —
    optax.adamw's defaults, as ``bench.py --model llama`` uses them — and
    ``make_train_step``."""
    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=1e-4))
    return opt, hvd.make_train_step(model, loss_fn, opt)


def timed_steps(step, batch, dev):
    """WARMUP_STEPS, then TIMED_STEPS each timed on the host clock to a
    ``synchronize()``, with the launch counters and peak memory reset in
    between.  Returns (losses, step ms, flash launches, flash plain calls,
    RMSNorm launches, RMSNorm plain calls)."""
    losses = [float(step(batch)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    rn.reset_launches()
    step_ms = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    return (losses, step_ms, dict(fa.launches), dict(fa.plain_calls),
            dict(rn.launches), dict(rn.plain_calls))


def step_metrics(cfg, step_ms, flops, dev):
    p50 = statistics.median(step_ms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    return dict(model="llama3_8b", layers=cfg.num_layers,
                layers_published=32, hidden=cfg.hidden_size,
                heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                ffn=cfg.intermediate_size, vocab=cfg.vocab_size,
                batch=TRAIN_B, seq=TRAIN_S, world_size=hvd.size(),
                backend=torch.distributed.get_backend(),
                optimizer="DistributedOptimizer(MasterWeights(AdamW lr 3e-4))",
                warmup_steps=WARMUP_STEPS, steps=TIMED_STEPS,
                step_ms_p50=p50, step_ms_max=max(step_ms), step_ms=step_ms,
                tokens_per_s=TRAIN_B * TRAIN_S / (p50 / 1e3),
                flops_per_step=flops, mfu=flops / (p50 / 1e3) / 989e12,
                peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                nvidia_smi_after=smi)


def check_training(name, losses, launches, expected, plain_calls):
    check(all(math.isfinite(x) for x in losses),
          f"{name}: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    for kernel, n in launches.items():
        check(n == expected[kernel], f"{name}: {kernel} launches {n} != "
                                     f"{expected[kernel]}")
    check(not any(plain_calls.values()),
          f"{name}: a plain version ran on the main path: {plain_calls}")


def build_model(cfg, seed, attention_fn):
    """Llama at ``cfg`` with seeded weights on the card."""
    return LlamaModel.from_state_dict(cfg, init_params(cfg, seed),
                                      attention_fn=attention_fn)


def phase_train(dev, seed):
    """The dense training step, timed.  Returns the flash launches and what
    its profile needs to rebuild it: (cfg, attention_fn, loss_fn,
    batch)."""
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=TRAIN_LAYERS)
    hvd.init()
    t0 = time.monotonic()
    model = build_model(cfg, seed, fa.flash_attention_fn)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))).to(dev)
    phase_train_oracle(model, tokens)
    torch.cuda.empty_cache()

    opt, step = make_step(model, lm_loss)
    losses, step_ms, launches, plain_calls, _, _ = timed_steps(step, tokens,
                                                               dev)
    plan = opt.last_plan
    emit("train", **step_metrics(cfg, step_ms, bench.llama_flops_per_step(
        cfg, TRAIN_B, TRAIN_S), dev), params=n_params, losses=losses,
         fused_buckets=len(plan.buckets),
         fused_bytes=sum(b.nbytes for b in plan.buckets),
         fused_tensors=sum(len(b.indices) for b in plan.buckets),
         kernel_launches=launches, plain_calls=plain_calls, init_s=init_s)
    check_training("train", losses, launches,
                   dict.fromkeys(launches, cfg.num_layers * TIMED_STEPS),
                   plain_calls)
    return launches, (cfg, fa.flash_attention_fn, lm_loss, tokens)


# ---------------------------------------------------------------------------
# phase 6: packed-sequence pretraining with the fused RMSNorm
# ---------------------------------------------------------------------------

def set_fused_norms(model, fused: bool) -> None:
    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.fused = fused


def phase_train_packed_oracle(model, tokens, seg):
    """At B 1 on the same weights, before the optimizer exists: (1) loss
    and gradients through the segment kernels against the dense ``attend``
    with the mask ``causal & same segment`` (train_oracle's bounds); (2)
    the fused model's loss and gradients against the unfused model's
    (same bounds: this holds the RMSNorm backward kernel and the dscale
    sum of its partials against autograd of the plain norm); (3) the
    fused model's logits against the unfused model's, within 4 bf16 ULPs
    at logit scale (at least 0.125, the serving oracle's bound), the
    argmax equal wherever the unfused top-2 margin exceeds it."""
    params = list(model.parameters())
    starts = fa._segment_starts(seg)
    pos = torch.arange(seg.shape[1], device=seg.device)
    mask = ((pos[:, None] >= pos[None, :])
            & (starts[:, :, None] == starts[:, None, :]))[:, None, None]
    runs = {}
    for name in ("flash", "dense", "unfused"):
        model.zero_grad(set_to_none=True)
        if name == "dense":
            set_attention(model, lambda q, k, v: attend(q, k, v, mask))
            logits = model(tokens[:, :-1])
            loss = softmax_cross_entropy(logits, tokens[:, 1:],
                                         where=boundary_mask(seg))
            del logits
        else:
            set_fused_norms(model, name == "flash")
            loss = packed_lm_loss(model, (tokens, seg))
        loss.backward()
        set_fused_norms(model, True)
        runs[name] = (float(loss.detach()),
                      [p.grad.detach().clone() for p in params])
    model.zero_grad(set_to_none=True)
    lf, ld, lu = (runs[n][0] for n in ("flash", "dense", "unfused"))
    worst_name, worst, median = grad_rel_l2(model, runs["flash"][1],
                                            runs["dense"][1])
    n_worst_name, n_worst, n_median = grad_rel_l2(model, runs["flash"][1],
                                                  runs["unfused"][1])
    del runs
    with torch.no_grad():
        packed_lm_loss(model, (tokens, seg))      # binds the segments
        fused = model(tokens[:, :-1]).float()
        set_fused_norms(model, False)
        plain = model(tokens[:, :-1]).float()
        set_fused_norms(model, True)
    d_logit = float((fused - plain).abs().max())
    bound = max(FUSED_LOGIT_TOL, 4 * bf16_ulp(float(plain.abs().max())))
    top2 = plain.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > bound
    flips = int(((fused.argmax(-1) != plain.argmax(-1)) & sure).sum())
    del fused, plain, top2
    emit("train_packed_oracle", batch=1, seq=int(seg.shape[1]),
         segments=n_segments(starts), loss_flash=lf, loss_dense=ld,
         loss_abs_diff=abs(lf - ld), loss_tol=ORACLE_LOSS_TOL,
         grad_rel_l2_max=worst, grad_rel_l2_worst=worst_name,
         grad_rel_l2_median=median, grad_rel_l2_tol=ORACLE_GRAD_REL_L2_TOL,
         loss_unfused=lu, fused_vs_unfused_loss_abs_diff=abs(lf - lu),
         fused_vs_unfused_grad_rel_l2_max=n_worst,
         fused_vs_unfused_grad_rel_l2_worst=n_worst_name,
         fused_vs_unfused_grad_rel_l2_median=n_median,
         fused_vs_unfused_max_abs_dlogit=d_logit, dlogit_bound=bound,
         argmax_decided=int(sure.sum()), argmax_flips=flips)
    check(math.isfinite(lf) and abs(lf - ld) <= ORACLE_LOSS_TOL,
          f"train_packed_oracle: loss {lf} vs dense {ld}")
    check(worst <= ORACLE_GRAD_REL_L2_TOL,
          f"train_packed_oracle: {worst_name} grad rel L2 {worst}")
    check(abs(lf - lu) <= ORACLE_LOSS_TOL,
          f"train_packed_oracle: fused loss {lf} vs unfused {lu}")
    check(n_worst <= ORACLE_GRAD_REL_L2_TOL,
          f"train_packed_oracle: fused vs unfused {n_worst_name} grad rel "
          f"L2 {n_worst}")
    check(d_logit <= bound and flips == 0,
          f"train_packed_oracle: fused vs unfused logits |d| {d_logit} "
          f"(bound {bound}), {flips} argmax flips")


def phase_train_packed(dev, seed):
    """Packed pretraining with the fused RMSNorm, timed.  Returns the
    RMSNorm launches and what its profile needs to rebuild it."""
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=TRAIN_LAYERS,
                              fused_rmsnorm=True)
    tokens, seg = (t.to(dev) for t in packed_batch(cfg.vocab_size, seed))
    # packed_lm_loss binds each batch's segments to every layer before its
    # forward, so the model is built with the plain causal flash seam.
    attention_fn = fa.flash_attention_fn
    t0 = time.monotonic()
    model = build_model(cfg, seed, attention_fn)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    phase_train_packed_oracle(model, tokens[:1], seg[:1])
    torch.cuda.empty_cache()

    opt, step = make_step(model, packed_lm_loss)
    losses, step_ms, launches, plain_calls, rms_launches, rms_plain = \
        timed_steps(step, (tokens, seg), dev)
    starts = fa._segment_starts(seg)
    valid = boundary_mask(seg)
    # Each document's own causal triangle (attn_pairs) in the FLOP count.
    flops = bench.llama_flops_per_step(
        cfg, TRAIN_B, TRAIN_S, attn_pairs(TRAIN_B, TRAIN_S, cfg.num_heads,
                                          True, starts))
    emit("train_packed", **step_metrics(cfg, step_ms, flops, dev),
         fused_rmsnorm=True,
         mean_doc=PACKED_MEAN_DOC, segments=n_segments(starts),
         loss_tokens=int(valid.sum()),
         attention_pairs_vs_causal=attn_pairs(TRAIN_B, TRAIN_S, 1, True,
                                              starts)
         / attn_pairs(TRAIN_B, TRAIN_S, 1, True), losses=losses,
         kernel_launches={**launches, **rms_launches},
         plain_calls={**plain_calls, **rms_plain}, init_s=init_s)
    expected = {**dict.fromkeys(launches, cfg.num_layers * TIMED_STEPS),
                **dict.fromkeys(rms_launches, (2 * cfg.num_layers + 1)
                                * TIMED_STEPS)}
    check_training("train_packed", losses, {**launches, **rms_launches},
                   expected, {**plain_calls, **rms_plain})
    return rms_launches, (cfg, attention_fn, packed_lm_loss, (tokens, seg))


def llama_factory(seed, cfg, attention_fn, loss_fn):
    """A profile's ``build``: the Llama phases' model and step, afresh."""
    def build():
        model = build_model(cfg, seed, attention_fn)
        return (model, *make_step(model, loss_fn))
    return build


def phase_train_profile(phase, build, batch, labels=None):
    """Where one training step's time goes: host wall time against the
    device time of its kernels (torch.profiler), the top kernels, device
    time by kernel group, and the idle share of the card.  ``build()``
    makes the model, optimizer and step afresh (a timed phase frees its
    own before the next, which needs the memory), and ``batch=None`` takes
    the one ``build`` leaves in ``build.batch``; the first step, which
    creates the optimizer's state, is an untraced warm step.
    ``labels(model)``: opens named ranges in the model and returns their
    names; each range's forward device time is reported."""
    from torch.profiler import ProfilerActivity, profile

    model, opt, step = build()
    if batch is None:
        batch = build.batch
    names = labels(model) if labels else ()
    step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    kernels, ranges = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    by_group = {}
    for e in kernels:
        g = kernel_group(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total / 1e3
    ranges_fwd = {}
    for name in names:
        ms, calls, groups = range_kernels(prof, name)
        check(ms > 0, f"{phase}: no device time inside range {name}")
        ranges_fwd[name] = {"device_ms": ms, "calls": calls,
                            "by_group_ms": groups}
    emit(phase, step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms,
         kernels_per_step=sum(e.count for e in kernels),
         by_group_ms=by_group, labelled_forward=ranges_fwd,
         ranges=[{"name": e.key[:60], "ms": e.device_time_total / 1e3}
                 for e in ranges],
         top=[{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
               "calls": e.count} for e in top])
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return {e.key: e.self_device_time_total / 1e3 for e in kernels}


#: Kernel groups of a training step's profile, by a substring of the
#: kernel's name (first match wins).
KERNEL_GROUPS = (("flash", ("fwd_bf16", "bwd_dq_bf16", "bwd_dkv_bf16")),
                 ("rms_norm", ("rms_fwd_kernel", "rms_bwd_kernel",
                               "rms_bwd_ring")),
                 ("layer_norm", ("layer_norm",)),
                 ("conv", ("fprop", "dgrad", "wgrad", "conv")),
                 ("gemm", ("nvjet", "gemm", "cutlass", "sm90_")),
                 ("optimizer", ("multi_tensor_apply",)),
                 ("nccl", ("nccl",)),
                 ("reduce", ("reduce_kernel",)),
                 ("elementwise", ("elementwise", "copy", "fill")))


def kernel_group(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def compare_profiles(train, packed):
    """Device ms of one packed step minus one train step, by kernel group
    and by kernel (the largest changes): what the packed path saves."""
    groups = {}
    for name in set(train) | set(packed):
        g = kernel_group(name)
        d = packed.get(name, 0.0) - train.get(name, 0.0)
        groups[g] = groups.get(g, 0.0) + d
    by_name = sorted(((packed.get(n, 0.0) - train.get(n, 0.0), n)
                      for n in set(train) | set(packed)))
    emit("train_packed_vs_train", device_ms_delta=sum(groups.values()),
         by_group_ms_delta=groups,
         train_by_group_ms={g: sum(v for n, v in train.items()
                                   if kernel_group(n) == g) for g in groups},
         largest_savings=[{"name": n[:90], "ms": d} for d, n in by_name[:8]],
         largest_additions=[{"name": n[:90], "ms": d}
                            for d, n in by_name[::-1][:4]])


# ---------------------------------------------------------------------------
# phase 7: BERT pretraining on BERT-base, the flash seam with the key bias
# ---------------------------------------------------------------------------

BERT_B, BERT_S = 32, 512
#: google-research/bert create_pretraining_data.py: short_seq_prob,
#: masked_lm_prob, max_predictions_per_seq at S 512.
BERT_SHORT_SEQ_PROB, BERT_MLM_PROB, BERT_MAX_PREDICTIONS = 0.1, 0.15, 80
BERT_MASK_ID = 103              # [MASK] in BERT's uncased 30522 vocabulary
BERT_ORACLE_B = 8
BERT_LR = 1e-4                  # the example's default


def bert_batch(seed) -> bert_example.BertBatch:
    """The fixed, seeded B 32 x S 512 pretraining batch (CPU tensors), drawn
    as google-research/bert's create_pretraining_data.py makes phase-2
    data: 90 % of rows fill all 512 positions, 10 % (short_seq_prob 0.1)
    take a length uniform in [2, 512] and are padded; each row's tokens
    split into sentence A and B (token types 0/1) at a uniform point;
    15 % of its valid tokens (at most 80) are MLM targets, of which 80 %
    are replaced by [MASK], 10 % by a random token and 10 % kept; NSP
    labels are random."""
    rng = np.random.default_rng(seed + 4)
    V = BertConfig.base().vocab_size
    B, S = BERT_B, BERT_S
    lengths = np.where(rng.random(B) < BERT_SHORT_SEQ_PROB,
                       rng.integers(2, S + 1, B), S)
    pos = np.arange(S)[None, :]
    valid = pos < lengths[:, None]
    labels = rng.integers(0, V, (B, S))
    ids = np.where(valid, labels, 0)
    split = rng.integers(1, np.maximum(lengths, 2))
    types = (valid & (pos >= split[:, None])).astype(np.int64)
    targets = np.zeros((B, S), bool)
    for b in range(B):
        n = min(BERT_MAX_PREDICTIONS,
                max(1, int(round(lengths[b] * BERT_MLM_PROB))))
        targets[b, rng.choice(lengths[b], n, replace=False)] = True
    roll = rng.random((B, S))
    ids = np.where(targets & (roll < 0.8), BERT_MASK_ID, ids)
    ids = np.where(targets & (roll >= 0.8) & (roll < 0.9),
                   rng.integers(0, V, (B, S)), ids)
    nsp = rng.integers(0, 2, B)
    t = torch.from_numpy
    return bert_example.BertBatch(t(ids), t(labels), t(targets), t(nsp),
                                  t(valid.astype(np.int64)), t(types))


def set_bert_attention(model, fn) -> None:
    for layer in model.encoder.layers:
        layer.attention.attention_fn = fn


def phase_bert_oracle(model, batch):
    """At B 8 on the same weights, before the first step: the
    example's loss and its gradients through the flash seam (the three
    kernels with the key bias) against the dense ``dot_product_attention``
    (which rounds its scores to bf16, as the reference's does), and the
    MLM logits at the valid positions: max |d| and argmax agreement.
    train_oracle's bounds: loss 0.02, gradient relative L2 0.05."""
    params = list(model.parameters())
    runs, logits = {}, {}
    valid = batch.attention_mask.bool()
    for name, fn in (("flash", fa.flash_attention_fn),
                     ("dense", dot_product_attention)):
        set_bert_attention(model, fn)
        model.zero_grad(set_to_none=True)
        loss = bert_example.pretraining_loss(model, batch)
        loss.backward()
        runs[name] = (float(loss.detach()),
                      [p.grad.detach().clone() for p in params])
        with torch.no_grad():
            logits[name] = model(batch.input_ids, batch.token_type_ids,
                                 batch.attention_mask)[0][valid]
    set_bert_attention(model, fa.flash_attention_fn)
    model.zero_grad(set_to_none=True)
    lf, ld = runs["flash"][0], runs["dense"][0]
    worst_name, worst, median = grad_rel_l2(model, runs["flash"][1],
                                            runs["dense"][1])
    del runs
    d_logit = float((logits["flash"] - logits["dense"]).abs().max())
    agree = float((logits["flash"].argmax(-1)
                   == logits["dense"].argmax(-1)).float().mean())
    finite = bool(torch.isfinite(logits["flash"]).all())
    del logits
    emit("bert_oracle", model="bert_base", batch=int(valid.shape[0]),
         seq=int(valid.shape[1]), valid_positions=int(valid.sum()),
         loss_flash=lf, loss_dense=ld, loss_abs_diff=abs(lf - ld),
         loss_tol=ORACLE_LOSS_TOL, grad_rel_l2_max=worst,
         grad_rel_l2_worst=worst_name, grad_rel_l2_median=median,
         grad_rel_l2_tol=ORACLE_GRAD_REL_L2_TOL,
         mlm_logits_max_abs_diff=d_logit, mlm_argmax_agreement=agree)
    check(finite, "bert_oracle: flash MLM logits not finite")
    check(math.isfinite(lf) and abs(lf - ld) <= ORACLE_LOSS_TOL,
          f"bert_oracle: loss {lf} vs dense {ld}")
    check(worst <= ORACLE_GRAD_REL_L2_TOL,
          f"bert_oracle: {worst_name} grad rel L2 {worst}")


def bert_flops(cfg, batch) -> int:
    """6 x (the encoder layers' params + the tied head's V·H +
    mlm_transform) x B·S + 3 x the attention forward: two products of
    2·D FLOPs per (query, valid key) pair, head and layer."""
    H, F_ = cfg.hidden_size, cfg.intermediate_size
    per_layer = 4 * H * H + 2 * H * F_ + 9 * H + F_   # weights, biases, LNs
    dense = cfg.num_layers * per_layer + cfg.vocab_size * H + H * H + H
    B, S = batch.input_ids.shape
    pairs = attn_pairs(B, S, cfg.num_heads, False,
                       mask=batch.attention_mask.bool())
    return 6 * dense * B * S + 3 * cfg.num_layers * 4 * cfg.head_dim * pairs


def bert_factory(seed, cfg, mesh):
    """train_bert's model, optimizer and step (the example's ``build``):
    BERT-base weights seeded with a token-type table, the flash seam."""
    def build():
        state = init_params(cfg, seed, token_types=True)
        model, opt = bert_example.build(cfg, state, mesh, BERT_LR,
                                        fa.flash_attention_fn)
        return model, opt, hvd.make_train_step(
            model, bert_example.pretraining_loss, opt)
    return build


def phase_train_bert(dev, seed):
    """BERT pretraining, timed.  Returns its flash launches and what its
    profile needs to rebuild it: (build, batch)."""
    cfg = BertConfig.base()
    hvd.init()
    mesh = build_mesh({"data": 1, "fsdp": -1})
    batch = bert_batch(seed).to(dev)
    build = bert_factory(seed, cfg, mesh)
    t0 = time.monotonic()
    model, opt, step = build()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    # The oracle's rows: the padded ones first, so its batch is ragged.
    order = torch.argsort(batch.attention_mask.sum(1).cpu(), stable=True)
    phase_bert_oracle(model, batch.rows(order[:BERT_ORACLE_B].to(dev)))
    torch.cuda.empty_cache()

    losses, step_ms, launches, plain_calls, _, _ = timed_steps(step, batch,
                                                               dev)
    bias_launches = dict(fa.key_bias_launches)
    p50 = statistics.median(step_ms)
    valid = batch.attention_mask.bool()
    flops = bert_flops(cfg, batch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit("train_bert", model="bert_base", layers=cfg.num_layers,
         layers_published=12, hidden=cfg.hidden_size, heads=cfg.num_heads,
         head_dim=cfg.head_dim, ffn=cfg.intermediate_size,
         vocab=cfg.vocab_size, max_position=cfg.max_position,
         type_vocab=cfg.type_vocab_size, params=n_params,
         param_dtype="float32", compute_dtype="bfloat16", batch=BERT_B,
         seq=BERT_S, valid_tokens=int(valid.sum()),
         short_rows=int((valid.sum(1) < BERT_S).sum()),
         mlm_targets=int(batch.mask_positions.sum()),
         mesh={"data": 1, "fsdp": 1}, world_size=hvd.size(),
         backend=torch.distributed.get_backend(),
         optimizer=f"DistributedOptimizer(AdamW lr {BERT_LR}, wd 1e-4)",
         warmup_steps=WARMUP_STEPS, steps=TIMED_STEPS, step_ms_p50=p50,
         step_ms_max=max(step_ms), step_ms=step_ms,
         sequences_per_s=BERT_B / (p50 / 1e3),
         tokens_per_s=BERT_B * BERT_S / (p50 / 1e3),
         valid_tokens_per_s=int(valid.sum()) / (p50 / 1e3),
         flops_per_step=flops, mfu=flops / (p50 / 1e3) / 989e12,
         peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         losses=losses, kernel_launches=launches,
         key_bias_launches=bias_launches, plain_calls=plain_calls,
         init_s=init_s, nvidia_smi_after=smi)
    check_training("train_bert", losses, launches,
                   dict.fromkeys(launches, cfg.num_layers * TIMED_STEPS),
                   plain_calls)
    check(bias_launches == launches,
          f"train_bert: launches without the key bias: {bias_launches} of "
          f"{launches}")
    del model, opt, step
    return launches, (build, batch)


# ---------------------------------------------------------------------------
# phase 8: ResNet-50 data-parallel training, bench.py's headline step
# ---------------------------------------------------------------------------

RESNET_B, RESNET_SIZE = 256, 224
#: The stage-2 bottlenecks whose 1x1 reduce is 512 -> 128 at 28 x 28 (the
#: spike's shape): blocks 1-3 of the second stage, 4-6 counting from 0.
RESNET_SPIKE_BLOCKS = (4, 5, 6)


def resnet_factory(seed):
    """train_resnet's model, optimizer and step, afresh: the bench's
    ``make_step_and_state`` on ResNet-50 (bf16) at B 256 x 224²; the
    bench's fixed batch is left in ``build.batch``."""
    def build():
        step, model, opt, build.batch = bench.make_step_and_state(
            ResNetConfig.resnet50(), RESNET_B, RESNET_SIZE, seed=seed)
        return model, opt, step
    return build


def resnet_eval_check(model, images):
    """One eval-mode forward on 8 images, which must use the running
    statistics: its logits do not depend on the batch (one image alone
    gives its row within bf16 noise, 5e-2 of the largest |logit|) and
    move when every running variance is taken 4x (each BatchNorm then
    scales by about a half: by more than 10x that noise).  Returns the
    numbers."""
    norms = [m for m in model.modules() if hasattr(m, "var")]
    with torch.no_grad():
        ev8 = model(images[:8]).float()
        ev1 = model(images[:1]).float()
        for m in norms:
            m.var.mul_(4.0)
        moved = model(images[:8]).float()
        for m in norms:
            m.var.div_(4.0)
    top = float(ev8.abs().max())
    batch_diff = float((ev1[0] - ev8[0]).abs().max())
    stats_diff = float((moved - ev8).abs().max())
    check(bool(torch.isfinite(ev8).all()) and ev8.shape == (8, 1000),
          "train_resnet: eval logits not finite or misshapen")
    check(batch_diff <= 5e-2 * top,
          f"train_resnet: eval logits depend on the batch ({batch_diff} of "
          f"{top}): not the running statistics")
    check(stats_diff > 10 * max(batch_diff, 1e-6 * top),
          f"train_resnet: eval logits ignore the running statistics "
          f"({stats_diff} vs {batch_diff})")
    return {"logit_max": top, "one_vs_batch_max_abs_diff": batch_diff,
            "var_x4_max_abs_diff": stats_diff}


def phase_train_resnet(dev, seed):
    """ResNet-50 training through the bench's step, timed.  Returns what
    its profile needs: (build, batch)."""
    hvd.init()
    cfg = ResNetConfig.resnet50()
    build = resnet_factory(seed)
    t0 = time.monotonic()
    model, opt, step = build()
    batch = build.batch
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    probe = model.blocks[RESNET_SPIKE_BLOCKS[0]].norms[0]
    mean0, var0 = probe.mean.clone(), probe.var.clone()
    losses, step_ms, _, _, _, _ = timed_steps(step, batch, dev)
    moved = (float((probe.mean - mean0).abs().max()),
             float((probe.var - var0).abs().max()))
    evl = resnet_eval_check(model, batch[0])
    p50 = statistics.median(step_ms)
    flops = bench.model_flops_per_step(cfg, RESNET_SIZE, RESNET_B)
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit("train_resnet", model="resnet50", params=n_params,
         param_dtype="float32", compute_dtype="bfloat16", batch=RESNET_B,
         image_size=RESNET_SIZE, world_size=hvd.size(),
         backend=torch.distributed.get_backend(),
         optimizer="DistributedOptimizer(SGD lr 0.01, momentum 0.9)",
         buffers=len(buffers),
         buffer_bytes=sum(b.numel() * b.element_size() for b in buffers),
         warmup_steps=WARMUP_STEPS, steps=TIMED_STEPS, step_ms_p50=p50,
         step_ms_max=max(step_ms), step_ms=step_ms,
         images_per_s=RESNET_B / (p50 / 1e3), flops_per_step=flops,
         mfu=flops / (p50 / 1e3) / 989e12,
         peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         losses=losses, running_stats_moved={"mean": moved[0],
                                             "var": moved[1]},
         eval_check=evl, init_s=init_s, nvidia_smi_after=smi)
    check(all(math.isfinite(x) for x in losses),
          f"train_resnet: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"train_resnet: loss did not fall: "
                                  f"{losses}")
    check(moved[0] > 0 and moved[1] > 0,
          "train_resnet: the running statistics did not move")
    del model, opt, step
    return build, batch


# ---------------------------------------------------------------------------
# phase 9: bench.py --model llama through horovod_tpu_torch.bench
# ---------------------------------------------------------------------------

def smi_now() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def phase_bench_llama(dev):
    """``bench --model llama`` at its full config through the bench's own
    function (``bench.llama_result``), with the launch counters reset just
    before and read just after.  Returns the flash launches a step."""
    hvd.init()
    cfg = bench.llama_config()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    rn.reset_launches()
    result = bench.llama_result()
    launches, plain_calls = dict(fa.launches), dict(fa.plain_calls)
    steps = result["warmup_steps"] + result["steps"]
    emit("bench_llama", **result, steps_run=steps,
         launches_per_step={k: v / steps for k, v in launches.items()},
         kernel_launches=launches, plain_calls=plain_calls,
         rms_norm_launches=dict(rn.launches),
         peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         nvidia_smi_after=smi_now())
    check(result["device"] == torch.cuda.get_device_name(dev),
          "bench_llama: not on the card")
    check(all(launches.get(name, 0) > 0 for name, *_ in FLASH_KERNELS),
          f"bench_llama: a flash kernel was not launched: {launches}")
    check_training("bench_llama", result["losses"], launches,
                   dict.fromkeys(launches, cfg.num_layers * steps),
                   plain_calls)
    return {k: v // steps for k, v in launches.items()}


def bench_llama_factory():
    """bench_llama's model, optimizer and step, afresh; the bench's fixed
    batch is left in ``build.batch``."""
    def build():
        step, model, opt, build.batch = bench.make_llama_step(
            bench.llama_config(), 8, 2048)
        return model, opt, step
    return build


# ---------------------------------------------------------------------------
# phase 10: the eager native engine on CUDA tensors, two ranks on one card
# ---------------------------------------------------------------------------

ENGINE_RANKS = 2
ENGINE_TIMEOUT_S = 300
ENGINE_ITERS = 5
ENGINE_BIG_VALUES = 64 << 20          # one fp32 tensor of 256 MiB
#: tests/test_compression.py's envelope for the bf16 wire: max |out -
#: fp32 result| / max |fp32 result|.
WIRE_BF16_TOL = 2e-2
#: Rows each rank sends each rank in the alltoall: uneven, one of them 0.
A2A_SPLITS = ((1, 3), (2, 0))


def free_port() -> int:
    """A free port whose + 64 (the torch group's rendezvous) is free too."""
    while True:
        with socket.socket() as s, socket.socket() as t:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            try:
                t.bind(("127.0.0.1", port + 64))
            except OSError:
                continue
            return port


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and bytes(a.view(torch.uint8).numpy())
            == bytes(b.view(torch.uint8).numpy()))


def host_input(rank, dtype, shape):
    """Rank ``rank``'s seeded input, made on the host (every rank can make
    every rank's, for the expected results)."""
    gen = torch.Generator().manual_seed(7000 + rank)
    if dtype == torch.int64:
        return torch.randint(-1000, 1000, shape, generator=gen)
    return torch.randn(shape, generator=gen).to(dtype)


def engine_checks(dev, rank, size):
    """Allgather (ragged), broadcast from rank 1, reducescatter and
    alltoall (uneven splits) on bf16 and int64 tensors on ``dev`` against a
    host computation; allreduce Sum and Average of fp32, bf16 and int64
    against the same call on the tensor's host copy, bit for bit."""
    done = []
    for dtype in (torch.bfloat16, torch.int64):
        name = str(dtype).replace("torch.", "")
        xs = [host_input(r, dtype, (r + 2, 3)) for r in range(size)]
        got = hvd.allgather(xs[rank].to(dev), name=f"ag.{name}")
        check(got.device == dev and bitwise_equal(got, torch.cat(xs)),
              f"engine: allgather {name}")
        xs = [host_input(r, dtype, (4, 3)) for r in range(size)]
        got = hvd.broadcast(xs[rank].to(dev), 1, name=f"bc.{name}")
        check(got.device == dev and bitwise_equal(got, xs[1]),
              f"engine: broadcast {name}")
        xs = [host_input(r, dtype, (5, 4)) for r in range(size)]
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        rows = torch.tensor_split(total, size)[rank]
        got = hvd.reducescatter(xs[rank].to(dev), name=f"rs.{name}")
        check(got.device == dev and bitwise_equal(got, rows),
              f"engine: reducescatter {name}")
        xs = [host_input(r, dtype, (sum(A2A_SPLITS[r]), 2))
              for r in range(size)]
        want = torch.cat([torch.split(xs[j], list(A2A_SPLITS[j]))[rank]
                          for j in range(size)])
        got = hvd.alltoall(xs[rank].to(dev), name=f"a2a.{name}",
                           splits=A2A_SPLITS[rank])
        check(got.device == dev and bitwise_equal(got, want),
              f"engine: alltoall {name}")
        done += [f"allgather.{name}", f"broadcast.{name}",
                 f"reducescatter.{name}", f"alltoall.{name}"]
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        name = str(dtype).replace("torch.", "")
        x = host_input(rank, dtype, (1000,))
        for op in (hvd.Sum, hvd.Average):
            got = hvd.allreduce(x.to(dev), op=op, name=f"ar.{name}.{op.value}")
            want = hvd.allreduce(x, op=op, name=f"ar.{name}.{op.value}.host")
            check(got.device == dev and bitwise_equal(got, want),
                  f"engine: allreduce {name} {op.value} on {dev} differs from "
                  "the host copy's")
            done.append(f"allreduce.{name}.{op.value}")
    return done


def engine_worker(rank: int, device: str) -> dict:
    """One rank of the engine phase.  Returns its measurements; any failed
    check raises."""
    hvd.init(device=device)
    dev, size, eng = hvd.device(), hvd.size(), get_engine()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {"rank": hvd.rank(), "size": size, "device": str(dev)}

    # ResNet-50's gradient set: 161 fp32 tensors, seeded per rank.
    shapes = [p.shape for p in ResNet(ResNetConfig.resnet50(),
                                      device="meta").parameters()]
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    grads = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    n_values = sum(g.numel() for g in grads)
    check(len(grads) == 161 and n_values == 25_557_032,
          f"engine: ResNet-50 has {len(grads)} tensors, {n_values} values")
    got = hvd.grouped_allreduce(grads, name="rn50")
    host = hvd.grouped_allreduce([g.cpu() for g in grads], name="rn50.host")
    check(all(a.device == dev and bitwise_equal(a, b)
              for a, b in zip(got, host)),
          "engine: grouped allreduce on the card differs from the host "
          "copies'")
    st0, eg0 = staging.stats(), eng.stats()
    walls = []
    for _ in range(ENGINE_ITERS):
        sync()
        t = time.perf_counter()
        hvd.grouped_allreduce(grads, name="rn50")
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    st1, eg1 = staging.stats(), eng.stats()
    ar_ns = eg1["allreduce_ns"] - eg0["allreduce_ns"]
    ar_bytes = eg1["allreduce_bytes"] - eg0["allreduce_bytes"]
    out["grouped_allreduce"] = {
        "tensors": len(grads), "values": n_values, "bytes": 4 * n_values,
        "iters": ENGINE_ITERS, "wall_ms": walls,
        "wall_ms_median": statistics.median(walls),
        "d2h_ms": (st1["d2h_ms"] - st0["d2h_ms"]) / ENGINE_ITERS,
        "h2d_ms": (st1["h2d_ms"] - st0["h2d_ms"]) / ENGINE_ITERS,
        "engine_allreduce_ms": ar_ns / 1e6 / ENGINE_ITERS,
        "bus_gb_per_s": ar_bytes * 2 * (size - 1) / size / ar_ns
        if ar_ns else None,
        "responses": (eg1["responses"] - eg0["responses"]) / ENGINE_ITERS,
        "pinned_allocs_timed": st1["pinned_allocs"] - st0["pinned_allocs"],
        "bitwise_vs_host": True}

    # One 256 MiB fp32 tensor, for bandwidth.
    big = torch.randn(ENGINE_BIG_VALUES, generator=gen, device=dev)
    check(bitwise_equal(hvd.allreduce(big, name="big"),
                        hvd.allreduce(big.cpu(), name="big.host")),
          "engine: 256 MiB allreduce on the card differs from the host's")
    st0, eg0 = staging.stats(), eng.stats()
    walls = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        hvd.allreduce(big, name="big")
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    st1, eg1 = staging.stats(), eng.stats()
    ar_ns = eg1["allreduce_ns"] - eg0["allreduce_ns"]
    ar_bytes = eg1["allreduce_bytes"] - eg0["allreduce_bytes"]
    out["big_allreduce"] = {
        "bytes": 4 * ENGINE_BIG_VALUES, "wall_ms": walls,
        "wall_ms_median": statistics.median(walls),
        "d2h_ms": (st1["d2h_ms"] - st0["d2h_ms"]) / 3,
        "h2d_ms": (st1["h2d_ms"] - st0["h2d_ms"]) / 3,
        "engine_allreduce_ms": ar_ns / 1e6 / 3,
        "bus_gb_per_s": ar_bytes * 2 * (size - 1) / size / ar_ns
        if ar_ns else None}
    del big

    # wire_bf16 on the gradient set, against the fp32 result.
    c0 = eng.stats()["wire_bf16_count"]
    wired = hvd.grouped_allreduce(grads, name="rn50.wire_bf16",
                                  compression=hvd.Compression.wire_bf16)
    ref = torch.cat([h.reshape(-1) for h in host])
    err = float((torch.cat([w.reshape(-1).cpu() for w in wired]) - ref)
                .abs().max() / ref.abs().max())
    out["wire_bf16"] = {"rel_err": err, "tol": WIRE_BF16_TOL,
                        "responses": eng.stats()["wire_bf16_count"] - c0}
    check(err < WIRE_BF16_TOL and out["wire_bf16"]["responses"] > 0,
          f"engine: wire_bf16 error {err}")

    out["checked"] = engine_checks(dev, rank, size)

    # The ready event: enqueue right behind a GEMM (fp32, ~1 ms once warm)
    # that writes the input.
    a = torch.randn(4096, 4096, generator=gen, device=dev)
    b = torch.randn(4096, 4096, generator=gen, device=dev)
    x = torch.matmul(a, b)
    x.fill_(float("nan"))
    sync()
    t0 = torch.cuda.Event(enable_timing=True) if on_card else None
    t1 = torch.cuda.Event(enable_timing=True) if on_card else None
    if on_card:
        t0.record()
    torch.matmul(a, b, out=x)
    if on_card:
        t1.record()
    first = hvd.synchronize(hvd.allreduce_async(x, name="ready"))
    sync()
    again = hvd.allreduce(x, name="ready.synced")
    check(bool(torch.isfinite(first).all()) and bitwise_equal(first, again),
          "engine: an allreduce enqueued behind a GEMM read its input early")
    # A batch behind GEMMs: a contiguous tensor and two transposed views,
    # whose gathers queue after the first tensor's.
    outs = [torch.full((4096, 4096), float("nan"), device=dev)
            for _ in range(3)]
    sync()
    for i, o in enumerate(outs):
        torch.matmul(a, b * (i + 1), out=o)
    batch = [outs[0], outs[1].t(), outs[2].t()]
    got = hvd.grouped_allreduce(batch, name="ready.batch")
    sync()
    want = hvd.grouped_allreduce([t.cpu() for t in batch],
                                 name="ready.batch.cpu")
    check(all(bool(torch.isfinite(g).all()) and bitwise_equal(g.cpu(), w)
              for g, w in zip(got, want)),
          "engine: a grouped allreduce behind GEMMs read a view early")
    out["ready_event"] = {"gemm_ms": t0.elapsed_time(t1) if on_card else None,
                          "batch_of_views": True, "ok": True}

    st, pool = eng.stats(), staging.stats()
    out["plane"] = {"shm_enabled": st["config"]["shm_enabled"],
                    "shm_bytes_tx": st["shm_bytes_tx"],
                    "data_bytes_tx": st["data_bytes_tx"],
                    "num_channels": st["config"]["num_channels"],
                    "fusion_threshold": st["config"]["fusion_threshold"],
                    "topology": st["topology"]}
    out["pinned_pool"] = {k: pool[k] for k in (
        "pinned_allocs", "pinned_alloc_bytes", "pinned_reuses",
        "d2h_copies", "h2d_copies")}
    hvd.shutdown()
    return out


def phase_engine():
    """Two ranks of the eager engine on the one card, each a process of
    this script (``--engine-worker RANK``) on cuda:0.  No torch.distributed
    collective runs (NCCL refuses two ranks on one device; the group is
    created lazily).  Any worker's failure or timeout fails the phase.
    ``HOROVOD_SHM_DISABLE`` alone of the caller's ``HOROVOD_*`` variables
    reaches the workers; their output goes to files, so no worker blocks
    on a full pipe while another is waited on."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    shm_disable = os.environ.get("HOROVOD_SHM_DISABLE", "0")
    env.update(HOROVOD_SIZE=str(ENGINE_RANKS),
               HOROVOD_LOCAL_SIZE=str(ENGINE_RANKS),
               HOROVOD_COORDINATOR=f"127.0.0.1:{port}",
               HOROVOD_SHM_DISABLE=shm_disable)
    logs = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    files = [(open(os.path.join(logs, f"rank{r}.out"), "w+"),
              open(os.path.join(logs, f"rank{r}.err"), "w+"))
             for r in range(ENGINE_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--engine-worker",
         str(r)], env=dict(env, HOROVOD_RANK=str(r),
                           HOROVOD_LOCAL_RANK=str(r)),
        stdout=files[r][0], stderr=files[r][1], text=True)
        for r in range(ENGINE_RANKS)]
    t0 = time.monotonic()

    def tail(r, n=4000):
        files[r][1].seek(0)
        return files[r][1].read()[-n:]

    try:
        # Poll all workers together: the first to fail ends the phase
        # with its own error, not with its peer's hang.
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                check(p.poll() in (None, 0), f"engine rank {r} exited "
                                             f"{p.returncode}:\n{tail(r)}")
            if time.monotonic() - t0 > ENGINE_TIMEOUT_S:
                raise RuntimeError(
                    f"chip_smoke check failed: engine ranks "
                    f"{[r for r, p in enumerate(procs) if p.poll() is None]}"
                    f" timed out after {ENGINE_TIMEOUT_S} s:\n"
                    + "\n".join(tail(r, 2000) for r in range(ENGINE_RANKS)))
            time.sleep(0.2)
        results = []
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"engine rank {r} exited "
                                     f"{p.returncode}:\n{tail(r)}")
            files[r][0].seek(0)
            results.append(json.loads(files[r][0].read().strip()
                                      .splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()
        shutil.rmtree(logs, ignore_errors=True)
    shm = shutil.disk_usage("/dev/shm")
    emit("engine", ranks=ENGINE_RANKS, wall_s=time.monotonic() - t0,
         dev_shm_bytes=shm.total, dev_shm_free_bytes=shm.free,
         shm_disable=shm_disable, per_rank=results,
         nvidia_smi_after=smi_now())


def label_forward(module, name):
    """Open a profiler range ``name`` around ``module``'s forward."""
    inner = module.forward

    def forward(*args, **kwargs):
        with torch.profiler.record_function(name):
            return inner(*args, **kwargs)

    module.forward = forward


def label_spike_layers(model):
    """Label the three stage-2 1x1 512 -> 128 convolutions and the
    BatchNorms beside them; returns the labels."""
    for i in RESNET_SPIKE_BLOCKS:
        label_forward(model.blocks[i].convs[0], "spike_conv")
        label_forward(model.blocks[i].norms[0], "spike_bn")
    return ("spike_conv", "spike_bn")


def range_kernels(prof, name):
    """Device time of the kernels launched inside every CPU range
    ``name`` (the forward: backward kernels run on autograd's thread,
    outside it): (ms, calls, {kernel group: ms})."""
    total, calls, groups = 0.0, 0, {}

    def walk(e):
        nonlocal total
        for k in e.kernels:
            ms = k.duration / 1e3
            total += ms
            g = kernel_group(k.name)
            groups[g] = groups.get(g, 0.0) + ms
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type.name == "CPU":
            calls += 1
            walk(e)
    return total, calls, groups


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of weights, requests and kernel inputs")
    # One rank of the engine phase, started by the phase itself.
    parser.add_argument("--engine-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    if args.engine_worker is not None:
        print(json.dumps(engine_worker(args.engine_worker, "cuda:0")),
              flush=True)
        return 0
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # The engine (g++) builds beside the kernels (one nvcc each).
    engine_build = {}

    def build_engine():
        t = time.monotonic()
        try:
            engine_build["lib"] = str(native_build.build())
        except Exception as e:  # noqa: BLE001 -- raised after the join
            engine_build["error"] = e
        engine_build["s"] = time.monotonic() - t

    engine_thread = threading.Thread(target=build_engine)
    engine_thread.start()
    build_s = _build.build()
    engine_thread.join()
    if "error" in engine_build:
        raise engine_build["error"]
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if re.search(r"registers|spill", ln)]
             for name in _build.sources()}
    emit("device", nvidia_smi=smi, torch_device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         engine_build_s=engine_build["s"], engine_lib=engine_build["lib"],
         kernels=sorted(_build.sources()), ptxas=ptxas)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    entry = phase_kernels(dev, flush, args.seed)
    flash_entries, kpm_times, bench_times = phase_flash_kernels(dev, flush,
                                                                args.seed)
    rms_entries = phase_rms_kernels(dev, flush, args.seed)
    x2d, w2d = conv_bn_spike.make_inputs(dev, args.seed)
    conv_entry = phase_conv_bn_kernels(dev, flush, x2d, w2d, args.seed)
    conv_entry["launches"] = phase_conv_bn_spike(x2d, w2d)
    del flush, x2d, w2d
    torch.cuda.reset_peak_memory_stats(dev)
    # Serving runs before training: once torch.profiler has traced the
    # training step, the process launches kernels more slowly, and a serve
    # phase after it measured 18-30 % fewer tokens/s with the same device
    # time (PERF.md, Findings).  The decode profile runs after serving;
    # both training phases are timed before either is profiled.
    runner, launches, served = phase_serve(dev, args.seed)
    entry["launches"] = launches
    phase_oracle(runner, served, args.seed)
    phase_profile(runner)
    del runner, served               # training needs the memory
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train = phase_train(dev, args.seed)
    for e in flash_entries:
        e["launches"] = train_launches[e["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    rms_launches, packed = phase_train_packed(dev, args.seed)
    for e in rms_entries:
        e["launches"] = rms_launches[e["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches, (bert_build, bert_data) = phase_train_bert(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_build, resnet_data = phase_train_resnet(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    bench_launches = phase_bench_llama(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_engine()
    compare_profiles(
        phase_train_profile("train_profile",
                            llama_factory(args.seed, *train[:3]), train[3]),
        phase_train_profile("train_packed_profile",
                            llama_factory(args.seed, *packed[:3]),
                            packed[3]))
    phase_train_profile("train_bert_profile", bert_build, bert_data)
    phase_train_profile("train_resnet_profile", resnet_build, resnet_data,
                        labels=label_spike_layers)
    phase_train_profile("bench_llama_profile", bench_llama_factory(), None)
    for name, t in kpm_times.items():
        emit("kernel_time_kpm", name=name, launches=bert_launches[name], **t)
    for name, t in bench_times.items():
        emit("kernel_time_bench", name=name,
             launches_per_step=bench_launches[name], **t)
    hvd.shutdown()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in
                                  [entry] + flash_entries + rms_entries
                                  + [conv_entry]]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
