#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel of the port from ``horovod_tpu_torch/csrc``
(one nvcc per source, all started together), then:

1. device    — ``nvidia-smi`` name and power limit, torch device, build s;
2. kernels   — each kernel against its plain PyTorch version on the card
               at the main path's shapes (stated tolerances), with its
               median time, its bound, the plain version's time and one
               PyTorch library call's time as a yardstick: the paged
               decode, and the three flash-attention kernels (forward,
               dQ, dK/dV) at the training shape and at ragged, fp32 and
               padded-head-dim shapes;
3. serve     — the port's serving replica (``ModelRunner`` + ``Scheduler``
               + ``ReplicaServer``, driven through ``ServeClient`` over
               TCP) on Llama-3-8B at its published widths (bf16, 32
               layers, seeded random weights) with the fused
               paged-attention decode: 8 concurrent requests, a shared
               256-token prefix; launch counts prove every decode layer
               went through the kernel;
4. oracle    — fused decode against the gather oracle on the same pools
               at full width, plus what holds of batch invariance;
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
   train_profile — where one step's time goes (torch.profiler);
6. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Each phase prints one JSON line; any failed check raises (exit != 0) and
no result line is printed.  Without a CUDA device it exits 2 at once.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.generation import (generate, paged_decode_step,
                                                 paged_prefill)
from horovod_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                            causal_attention)
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import paged_attention as pa
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.mixed_precision import MasterWeights
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
    ranges_ms = {}
    chosen = pa.RANGE_TOKENS
    for tokens in (64, 128, 256):
        pa.RANGE_TOKENS = tokens
        ranges_ms[tokens] = graph_ms(kernel, 50, flush)
    pa.RANGE_TOKENS = chosen
    plain_ms = cuda_ms(lambda: pa._decode_blockwise(*timed), 10, flush)
    library_ms = graph_ms(sdpa_yardstick(*timed), 50, flush)
    bound_ms, bound_by = decode_bound(q, pk, tables, pos)
    entry = {"name": "paged_attention_decode", "route": "cuda",
             "source": "horovod_tpu_torch/csrc/paged_attention.cu",
             "replaces": "horovod_tpu/ops/paged_attention.py:176",
             "launches": None, "max_abs_err": max_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    emit("kernel_time", **entry, call_ms=call_ms,
         range_tokens=chosen, ms_by_range_tokens=ranges_ms,
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
    and delta.  Returns {kernel name: max |d|}."""
    dtype, causal = case["dtype"], case["causal"]
    shape = {k: case[k] for k in ("B", "S", "Hq", "Hkv", "D")}
    q, k, v, do = flash_inputs(dev, dtype, seed=seed, **shape)
    scale = shape["D"] ** -0.5
    ref_out, ref_lse = fa._fwd_blockwise(q, k, v, causal, scale)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    bwd_args = (q, k, v, do, ref_lse, delta.contiguous(), causal, scale)
    errs = {}
    for name, kernel, plain, _ in FLASH_KERNELS:
        args = (q, k, v, causal, scale) if name == "flash_fwd" else bwd_args
        got = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        if name == "flash_fwd":
            # lse: fp32 on both sides; 1e-3 absolute is ~1e-4 relative at
            # the lse's scale (log S + max score).
            d_lse = float((got[1] - ref[1]).abs().max())
            check(d_lse <= 1e-3, f"{name}: lse |d| {d_lse}")
            pairs = [(got[0], ref[0])]
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
             max_abs_err=errs[name], tolerance=results[0][2], ok=ok)
        check(ok, f"{name} case {case['case']}: kernel disagrees with its "
                  f"plain version (max |d| {errs[name]})")
    return errs


def flash_padded_check(dev, seed):
    """Case (c): D 96 through the autograd wrapper, which zero-pads to 128
    and keeps the true 1/sqrt(96); held against the plain versions on the
    same padding, out and all three grads (fp32 tolerances)."""
    q, k, v, do = flash_inputs(dev, torch.float32, 1, 200, 4, 2, 96, seed)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*xs, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    pad = [F.pad(t, (0, 32)) for t in (q, k, v, do)]
    scale = 96 ** -0.5
    ref_out, lse = fa._fwd_blockwise(*pad[:3], True, scale)
    delta = (pad[3] * ref_out).sum(-1).transpose(1, 2).contiguous()
    args = (*pad, lse, delta, True, scale)
    ref_dq = fa._bwd_dq_blockwise(*args)
    ref_dk, ref_dv = fa._bwd_dkv_blockwise(*args)
    errs = {}
    for name, got, ref in (("flash_fwd", out, ref_out),
                           ("flash_bwd_dq", xs[0].grad, ref_dq),
                           ("flash_bwd_dkv", xs[1].grad, ref_dk),
                           ("flash_bwd_dkv", xs[2].grad, ref_dv)):
        ok, err, tol = flash_within(got, ref[..., :96], torch.float32,
                                    grad=name != "flash_fwd")
        errs[name] = max(errs.get(name, 0.0), err)
        check(ok, f"{name} case c (D 96 padded): max |d| {err}")
    for name, err in errs.items():
        emit("kernel_check", kernel=name, case="c", B=1, S=200, Hq=4, Hkv=2,
             D=96, causal=True, dtype="float32", max_abs_err=err,
             tolerance="fp32 out 2e-5, grads 5e-4 (abs + rel)", ok=True)
    return errs


def flash_bound(name, B, S, Hq, Hkv, D, causal):
    """(bound_ms, bound_by) at bf16: the larger of the bytes each input is
    read and each output written once over HBM bandwidth, and the tensor-
    core operations the causal triangle needs (2·D per query-key pair and
    product: 2 products forward; dQ 3, the scores recomputed; dK/dV 4)."""
    pairs = B * Hq * (S * (S + 1) // 2 if causal else S * S)
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    q_bytes, kv_bytes, row_bytes = B * S * Hq * D * 2, B * S * Hkv * D * 2, \
        B * Hq * S * 4
    nbytes = {"flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
              "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
              "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
              }[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * D * products * pairs / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_flash_kernels(dev, flush, seed):
    cases = [
        dict(case="a", dtype=torch.bfloat16, causal=True, **FLASH_TRAIN_SHAPE),
        dict(case="b", dtype=torch.float32, causal=True, B=1, S=200, Hq=4,
             Hkv=2, D=64),
        dict(case="b", dtype=torch.float32, causal=False, B=1, S=200, Hq=4,
             Hkv=2, D=64),
    ]
    max_err = {name: 0.0 for name, *_ in FLASH_KERNELS}
    for i, case in enumerate(cases):
        for name, err in flash_case_check(dev, case, seed + 10 + i).items():
            max_err[name] = max(max_err[name], err)
    for name, err in flash_padded_check(dev, seed + 20).items():
        max_err[name] = max(max_err[name], err)

    # Times at the training shape (a).
    shape = FLASH_TRAIN_SHAPE
    q, k, v, do = flash_inputs(dev, torch.bfloat16, seed=seed, **shape)
    scale = shape["D"] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse, delta, True, scale)
    # Library yardstick: SDPA (flash backend) on [B, H, S, D] views with
    # the KV heads expanded, forward with is_causal; for dQ and dK/dV its
    # backward, which computes the pair at once (the port never calls it).
    G = shape["Hq"] // shape["Hkv"]
    qh = q.transpose(1, 2).detach().requires_grad_(True)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    doh = do.transpose(1, 2)
    with torch.no_grad():
        sdpa_fwd_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 20, flush)
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), doh, retain_graph=True), 10, flush)
    entries = []
    for name, kernel, plain, replaces in FLASH_KERNELS:
        args = (q, k, v, True, scale) if name == "flash_fwd" else bwd_args
        ms = graph_ms(lambda: kernel(*args), 20, flush)
        plain_ms = cuda_ms(lambda: plain(*args), 3, flush)
        bound_ms, bound_by = flash_bound(name, causal=True, **shape)
        entry = {"name": name, "route": "cuda",
                 "source": "horovod_tpu_torch/csrc/flash_attention.cu",
                 "replaces": replaces, "launches": None,
                 "max_abs_err": max_err[name], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by,
                 "library_ms": sdpa_fwd_ms if name == "flash_fwd"
                 else sdpa_bwd_ms}
        emit("kernel_time", **entry,
             library_call="scaled_dot_product_attention forward, is_causal"
             if name == "flash_fwd" else
             "scaled_dot_product_attention backward (dQ, dK, dV together)",
             timed_shape={**shape, "causal": True, "dtype": "bfloat16"})
        entries.append(entry)
    return entries


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
    first = reqs[0]
    return runner, launches, (first[1], results[first[0]][-1]["tokens"])


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

    # Batch invariance: one row decoded alone, then padded to 8 rows.
    row = {"tok": toks[0], "pos": len(prompts[0]) + steps,
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

    # Served stream vs the contiguous-cache generate on the same card.
    prompt, served_toks = served
    ids = torch.tensor([prompt], dtype=torch.long, device=dev)
    offline = generate(model, ids, max_new_tokens=len(served_toks),
                       cache_len=runner.cache_len)[0].tolist()
    agree = next((i for i, (a, b) in enumerate(zip(offline, served_toks))
                  if a != b), len(served_toks))
    emit("oracle", steps=steps, rows=len(prompts),
         max_abs_dlogit=max_d, bound=bound_used,
         argmax_decided=decided, argmax_flips=flips,
         batch_width_1_vs_8=inv, served_vs_offline_generate_tokens_agree=agree,
         served_tokens=len(served_toks))


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


def lm_loss(model, tokens):
    logits = model(tokens[:, :-1])
    return softmax_cross_entropy(logits, tokens[:, 1:])


def train_flops(cfg, B, S):
    """6 x (non-embedding params + lm_head) x tokens + 3 x the attention
    forward (two causal products of 2 x S^2/2 x D per head and layer)."""
    D, H = cfg.head_dim, cfg.hidden_size
    per_layer = (H * cfg.num_heads * D * 2 + H * cfg.num_kv_heads * D * 2
                 + 3 * H * cfg.intermediate_size + 2 * H)
    dense = cfg.num_layers * per_layer + H + cfg.vocab_size * H
    attn_fwd = cfg.num_layers * 4 * B * cfg.num_heads * S * S // 2 * D
    return 6 * dense * B * S + 3 * attn_fwd


def set_attention(model, fn):
    for layer in model.layers:
        layer.attn.attention_fn = fn


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
    (lf, gf), (ld, gd) = runs["flash"], runs["dense"]
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30)) for a, b in zip(gf, gd)]
    names = [n for n, _ in model.named_parameters()]
    worst = max(range(len(rel)), key=rel.__getitem__)
    emit("train_oracle", batch=1, seq=TRAIN_S, loss_flash=lf, loss_dense=ld,
         loss_abs_diff=abs(lf - ld), loss_tol=ORACLE_LOSS_TOL,
         grad_rel_l2_max=rel[worst], grad_rel_l2_worst=names[worst],
         grad_rel_l2_median=statistics.median(rel),
         grad_rel_l2_tol=ORACLE_GRAD_REL_L2_TOL)
    check(math.isfinite(lf) and abs(lf - ld) <= ORACLE_LOSS_TOL,
          f"train_oracle: loss {lf} vs dense {ld}")
    check(rel[worst] <= ORACLE_GRAD_REL_L2_TOL,
          f"train_oracle: {names[worst]} grad rel L2 {rel[worst]}")
    del runs, gf, gd


def phase_train(dev, seed):
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=TRAIN_LAYERS)
    hvd.init()
    t0 = time.monotonic()
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, seed),
                                       attention_fn=fa.flash_attention_fn)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))).to(dev)
    phase_train_oracle(model, tokens)
    torch.cuda.empty_cache()

    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=1e-4))
    step = hvd.make_train_step(model, lm_loss, opt)
    losses = [float(step(tokens)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    step_ms = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    launches = dict(fa.launches)
    plain_calls = dict(fa.plain_calls)
    plan = opt.last_plan
    p50 = statistics.median(step_ms)
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit("train", model="llama3_8b", layers=cfg.num_layers,
         layers_published=32, hidden=cfg.hidden_size, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, ffn=cfg.intermediate_size,
         vocab=cfg.vocab_size, params=n_params, batch=TRAIN_B, seq=TRAIN_S,
         world_size=hvd.size(), backend=torch.distributed.get_backend(),
         optimizer="DistributedOptimizer(MasterWeights(AdamW lr 3e-4))",
         warmup_steps=WARMUP_STEPS, steps=TIMED_STEPS,
         step_ms_p50=p50, step_ms_max=max(step_ms), step_ms=step_ms,
         tokens_per_s=TRAIN_B * TRAIN_S / (p50 / 1e3),
         flops_per_step=flops, mfu=flops / (p50 / 1e3) / 989e12,
         peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         losses=losses, fused_buckets=len(plan.buckets),
         fused_bytes=sum(b.nbytes for b in plan.buckets),
         fused_tensors=sum(len(b.indices) for b in plan.buckets),
         kernel_launches=launches, plain_calls=plain_calls, init_s=init_s,
         nvidia_smi_after=smi)
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, n in launches.items():
        check(n == cfg.num_layers * TIMED_STEPS,
              f"{name} launches {n} != layers x steps "
              f"{cfg.num_layers} x {TIMED_STEPS}")
    check(not any(plain_calls.values()),
          f"a plain version ran on the main path: {plain_calls}")
    phase_train_profile(step, tokens)
    return launches, (model, opt, step)


def phase_train_profile(step, tokens):
    """Where one training step's time goes: host wall time against the
    device time of its kernels (torch.profiler), the top kernels, and the
    idle share of the card."""
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    step(tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(tokens)
        torch.cuda.synchronize()
    kernels, ranges = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit("train_profile", step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms,
         kernels_per_step=sum(e.count for e in kernels),
         ranges=[{"name": e.key[:60], "ms": e.device_time_total / 1e3}
                 for e in ranges],
         top=[{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
               "calls": e.count} for e in top])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of weights, requests and kernel inputs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if re.search(r"registers|spill", ln)]
             for name in _build.sources()}
    emit("device", nvidia_smi=smi, torch_device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         kernels=sorted(_build.sources()), ptxas=ptxas)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    entry = phase_kernels(dev, flush, args.seed)
    flash_entries = phase_flash_kernels(dev, flush, args.seed)
    del flush
    torch.cuda.reset_peak_memory_stats(dev)
    # Serving runs before training: once torch.profiler has traced the
    # training step, the process launches kernels more slowly, and a serve
    # phase after it measured 18-30 % fewer tokens/s with the same device
    # time (PERF.md, Findings).  The decode profile runs after serving.
    runner, launches, served = phase_serve(dev, args.seed)
    entry["launches"] = launches
    phase_oracle(runner, served, args.seed)
    phase_profile(runner)
    del runner, served               # training needs the memory
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, trained = phase_train(dev, args.seed)
    for e in flash_entries:
        e["launches"] = train_launches[e["name"]]
    del trained
    hvd.shutdown()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in [entry] + flash_entries]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
