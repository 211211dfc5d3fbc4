#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel of the port from ``horovod_tpu_torch/csrc``
(one nvcc per source, all started together) and, beside them, the eager
engine from ``horovod_tpu_torch/cpp`` (g++), then:

1. device    — ``nvidia-smi`` name and power limit, torch device, build s
               (and ``import_cache``, before the fleet: the s of one import
               of every module into the bytecode cache that the processes
               the script starts share);
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
               paged-attention decode, every decode step a replay of the
               width's CUDA graph (4 captured at warm-up: widths 1, 2, 4,
               8): 8 concurrent requests, a shared 256-token prefix;
               launch counts (per replay) prove every decode layer went
               through the kernel, and every norm of every decode step
               and prefill through the RMSNorm kernel (the served model's
               norms, whose rows do not depend on their batch-mates);
4. oracle    — fused decode against the gather oracle on the same pools
               at full width, plus batch invariance: a row decoded alone
               and beside batch-mates through ``ModelRunner.decode`` must
               agree bit for bit; and each of the 8 served streams
               against its own offline ``generate`` at the pinned cache
               length (how many part from it, and where);
   serve_graph — each decode graph against the eager step: widths 1, 2,
               4 and 8 at the kernel table's positions, logits and written
               K/V bit for bit on the same inputs and pools;
   serve_tune — the same runner under the serve tuner
               (``HOROVOD_SERVE_AUTOTUNE=1``, windows of 16 decode steps,
               6 trials at most): 16 streams of 64-512-token prompts that
               share no prefix, 96 new tokens each, greedy; the tuner
               commits, ``captures`` does not move, B6 runs 32 launches a
               replay, and every stream's tokens equal an untuned
               scheduler's on the same runner and requests; each window's
               tokens/s;
   profile   — where a batch-8 decode step's time goes (host wall time,
               device busy time and top kernels from torch.profiler), for
               the graph step and the eager step on the same inputs, and
               the graph's replay alone between CUDA events;
   fleet     — with the replica freed: ``python -m horovod_tpu_torch.run
               --serve --replicas 2 --device cuda`` (Llama-3-8B as in
               serve, both replicas on the one card), driven by
               ``bench_serve.run_load``: 16 requests of 64-512 random
               tokens, 32 new tokens each, Poisson arrivals at 4/s; then
               the same plan with replica 1 killed at its 10th decode step
               and relaunched (``--restart-on-failure 1``): every request
               completes, some are requeued, each request's tokens equal
               the fault-free run's, the router exits 0, and no replica
               process, listen socket or /dev/shm entry is left; the
               router serves ``HOROVOD_METRICS_PORT``, whose ``"serve"``
               mount, read every 0.1 s, shows 2 replicas alive, then 1
               while replica 1 is dead and 2 after its relaunch, with
               request counters equal to the router's final stats;
5. train     — with the fleet gone: the data-parallel training step
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
9b. collectives — the device plane (``ops/collective_ops.py``) in this
               process's NCCL world of one (the group ``train`` built),
               through the frontend's names in a step's context: every
               call of ``parallel``'s ``collectives`` part below returns
               its input bit for bit, with no call on the wire and no
               engine response; wall ms p50 and max of each;
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
10b. keras_core — the Keras frontend's core, which needs neither Keras nor
               TensorFlow (neither is on the card's machine), in the same
               two ranks at the end of their engine work:
               ``keras.impl.average_tensors`` (the torch backend's branch of
               ``allreduce_gradients``) on CUDA gradient batches, the Keras
               MNIST example's 8 tensors and ResNet-50's 161 (102 MB),
               with compression none, fp16 and bf16: each result bitwise
               the mean of the host copies (of their wire casts, cast
               back), every input unchanged, device and dtype kept, the
               median call within tests/tf_worker.py's cycle bound (n // 2
               for n tensors); ``broadcast_tensors`` of CUDA variables from
               rank 0 (rank 1 ends bitwise rank 0's); the metric path's
               ``allreduce`` of a float returns the mean as a float; no
               ``keras``, ``tensorflow`` or ``jax`` in ``sys.modules``:
               wall ms p50 and max of 10 calls of each batch and
               compression, D2H and H2D ms, responses and cycles a call;
10c. engine_bench — the engine bench's sweep bodies
               (``horovod_tpu_torch.bench_engine.measure``) on seeded CUDA
               tensors, two ranks on the one card (``--engine-bench-worker
               RANK``): allreduce at 4 KB, 1 MB, 16 MB and 64 MB on four
               planes (4 and 1 channels, TCP and shm), reducescatter and
               alltoall at 16 MB on the default plane, the small-allreduce
               latency, and the fp32 / fp16 / int8 wires at 1 MB: each
               point's bus GB/s from the engine's own counters, the wall
               ms of a call with its staging, D2H and H2D ms, each result
               bitwise its host copy's and moving the same bytes a call;
               the wire byte ratios the same on both ranks;
11. engine_train — the engine-driven optimizers (``torch_frontend``)
               training ``bench_llama``'s model at its widths cut to 2
               layers (ENGINE_TRAIN_LAYERS; the full 16 train in
               ``autotune``) in two worlds of two ranks of the engine on
               the one card that run side by side (``--train-worker
               RANK``, through ``run_ranks``, the engine phase's
               launcher; ENGINE_TRAIN_WORLDS), B 4 x S 2048 each, the rows of the bench's
               ``default_rng(0)`` batch, weights broadcast from rank 0 by
               ``torch_frontend.broadcast_parameters``; four parts, 2
               warm-up and 5 timed steps each: ``hook`` (the hook form
               over ``MasterWeights(AdamW)``; ``synchronize()``'s wait
               after the backward), ``zero1`` (``sharded=True``, AdamW on
               the bf16 model), ``fsdp`` (``fsdp=True``, a unit a layer and one more) and
               ``local_sgd`` (the hook form, ``local_sgd_steps=4``, 8
               steps); each checks that its loss falls, the ranks'
               parameters agree bit for bit (an allgather of
               per-tensor digests; for local SGD right after steps 4 and
               8 only, with 2 syncs counted), 6 flash launches a step and
               no plain call, and a bitwise anchor at 2 layers: the hook
               step against ``grouped_allreduce`` of the same gradients
               and the same inner step, ZeRO-1 (fp32, SGD) against the
               unsharded flat step, FSDP (fp32, SGD) against the dense
               replicated loop; one line per part with step ms, tokens/s,
               peak memory, the engine's and the staging's counters a
               step; then three parts of the sparse plane: ``topk`` (the
               hook form with ``Compression.topk(0.01)``: a sparse
               allreduce a leaf a step, D2H bytes under 5 % of ``hook``'s, the
               first step's selection, residual and output bitwise
               against the CPU's on 11 leaves of every shape, one step
               split into selection, allgathers and scatter, and a 2-layer
               anchor against ``hvd.allreduce(topk)`` of the same
               gradients), ``local_sgd_topk`` (H 4, the masters' deltas
               top-k'd: 2 syncs of a sparse allreduce a leaf) and ``policy``
               (``HOROVOD_WIRE_POLICY=1`` on an fp32 copy with AdamW: the
               leaves sent int8, every 0/1-D leaf fp32,
               ``wire_int8_count`` growing, the card's statistics against
               the CPU's with the same decisions);
12. engine_moe — ``runtime/moe.MoeLayer`` at bench_llama's widths (d 1024,
               FFN 4096, 8 experts, top-2, capacity factor 1.25) on two
               ranks of the engine on the card (``--moe-worker RANK``),
               16 384 tokens, 3 steps of forward, backward and
               ``apply_grads``: every rank's y, dx, router and expert
               grads and updated parameters bitwise against the
               world-of-one layer on the whole batch, drops equal to its
               count; each dispatch's and combine's ms, alltoall bytes,
               peak memory;
13. train_moe — MoE in the model: Mixtral-8x7B's published widths
               (vocab 32000, hidden 4096, 32 heads and 8 KV heads of 128,
               FFN 14336, 8 experts, top-2, rope_theta 1e6) cut to 2
               layers (3.16 B parameters), bf16, seeded weights, through
               ``make_parallel_train_step`` on a mesh whose axes are all
               1 (``MasterWeights(AdamW 3e-4)``, flash attention), B 1 x
               S 4096:
   moe_oracle — first, layer 0's routed MoE block against the dense
               masked einsum (the reference's dispatch) on the same card
               tensors, output and gradients;
               then 3 warm-up and 10 timed steps (the loss must fall;
               B1-B3 launch once a layer a step; no fallback): step ms,
               tokens/s, MFU over the active parameters, peak memory,
               each expert's tokens;
14. parallel — the parallelism families on two ranks sharing the card
               (``--parallel-worker RANK`` through ``run_ranks``, a gloo
               group: the families' collectives stage through host
               memory): ``bench_llama``'s widths at 2 layers, fp32, SGD,
               B 2 x S 2048, 3 steps of each part: ``tensor`` (tensor 2),
               ``expert`` (expert 2, 8 experts, top-2), ``seq_ring`` and
               ``seq_ulysses`` (seq 2), ``pipe`` (pipe 2, 2
               microbatches); each rank's losses and parameters against
               a world of one on the same rank and seeds (loss rtol
               1e-4, parameters within 1e-4), the ranks' losses equal,
               B1-B3 launches as the part's schedule gives (the ring: 2
               hops x 2 layers a step), no fallback; step ms, the bytes
               that cross between ranks and the bytes staged a step;
               then, in the same two ranks, the ``collectives`` part:
               the device plane through the frontend's names in a step's
               context at the sizes of models the repo runs: ResNet-50's
               161 fp32 gradients through ``grouped_allreduce``,
               ``bench_llama``'s activations (4 x 2048 x 1024 bf16 a rank)
               through ``allgather`` and ``reducescatter`` on axes 0 and
               1, ``engine_moe``'s dispatch buffer (16 384 x 1024 bf16)
               through ``alltoall``, ``broadcast`` from rank 1 (bf16,
               int64), every ``ReduceOp`` on 1 Mi fp32 and int32 values,
               the backward of ``allgather`` and ``alltoall``: each
               result bitwise the host's arithmetic on every rank's host
               copy, the ranks' replicated results equal, no engine
               response; wall ms p50 and max of 5 calls, wire and staged
               bytes, calls; and ``make_train_step`` of the 2-layer model
               whose loss gathers every rank's loss through
               ``hvd.allgather`` (3 SGD steps, each rank its row) against
               the world of one (loss rtol 1e-4, leaves within 1e-3 of
               their update), 2 device-plane calls and no engine
               response a step;
14b. parallel_zoo — the reference's sharding rules on BERT and ResNet
               through ``shard_params`` and ``make_parallel_train_step``
               on two ranks sharing the card (``--parallel-zoo-worker
               RANK``, gloo), fp32 (TF32 off), SGD 0.05, 3 steps a part:
               ``bert_tensor`` (tensor 2) and ``bert_fsdp`` (fsdp 2,
               placed by hand) on BERT-base at its published widths and
               depth (12 layers), the flash seam, ``train_bert``'s first 4
               rows (S 512, its key mask), ``train=False``;
               ``resnet_tensor`` and ``resnet_fsdp`` (BatchNorm over the
               global batch, 4 rows a rank) on ResNet-50 at 224², 1000
               classes, global B 8, train mode, each block's last
               BatchNorm scale at 0.1; each part against the world of one
               on the same rank, seeds and global batch (loss rtol 1e-4,
               each leaf within 1e-3 of the world of one's own update,
               the running statistics within 1e-5 of their scale; for
               ResNet, whose ReLUs and max-pool ties flip under rounding,
               a leaf may also be off by up to twice the farthest that 4
               runs of the world of one with one ulp of weight noise land
               from it), the ranks' losses equal, B1-B3 12 launches a
               step in the BERT parts, none plain, no fallback; the
               models' sizes, step ms, the bytes that cross between ranks
               and the bytes staged a step, collectives a step, peak
               memory, the noise floor;
15. ckpt    — the weight plane on CUDA state: ``bench_llama``'s model at
               its widths cut to 2 of its 16 layers (CKPT_LAYERS) under
               the hook form's ZeRO-1 (AdamW 3e-4,
               fp32 masters) on two ranks of the card (``--ckpt-worker
               RANK``), B 4 x S 2048 each: step 1 and its save (the
               writer's pinned buffers are made), step 2, ``save()``
               through the async writer and step 3 at once; the written
               masters, moments and params against clones taken before
               step 3 bit for bit (the snapshot race), no ``|V2`` leaf; a
               restore at world 2 into a fresh model and optimizer and
               step 3 rerun from it, each bitwise; then this process
               restores at world 1 (resliced through ``shard_bounds``)
               and holds every leaf to the written bytes: bytes written,
               ``save()``'s stall, the D2H ms and GB/s, write + fsync +
               commit ms, restore ms at each world, B1-B3 launches;
16. ckpt_kill — ``python -m horovod_tpu_torch.run -np 2
               --restart-on-failure 1 --checkpoint-dir D`` over this
               script's ``--kill-worker`` (bench_llama's widths at 2
               layers, ``MasterWeights(AdamW)``, gradients averaged by
               the engine, ``run_elastic`` with the env-configured writer
               every 2 steps, 8 steps), without and, side by side with
               that run, with ``HOROVOD_FAULT_INJECT=1:5:ckpt-kill`` (rank 1 killed
               between the halves of its step-6 shard write): no manifest
               names the torn step, the relaunched world enters at the
               survivors' last commit, the final digest equals the clean
               run's, the launcher exits 0, no ``/dev/shm`` entry leaks:
               relaunch-to-first-step s, steps redone;
17. serve_weights — a checkpoint of seeded Llama-3-8B weights cut to 2
               layers (1.49 B parameters, fp32 on disk) written by the
               JAX-form capture; a replica serving it behind the router
               (``run --serve --serve-model D``, started while this
               process restores the same checkpoint), 8 streams of 960 new
               tokens (a pool of 1024 blocks), and mid-stream
               a partial push (layer 0's q and o on the int8 wire, every
               norm scale) through ``WeightPusher``: every stream requeued
               once and finished at full length on the new epoch, a
               replayed stale epoch acked unapplied; in this process a
               runner restored from the checkpoint, its weights equal to
               the written ones, each width's decode graph bitwise equal
               to a fresh eager runner's step after the restore and after
               the same push copied in place (``captures`` unchanged):
               restore s, push MB, swap ms, requeued, tokens/s before and
               after;
18. observe — ``engine_train``'s hook part (bench_llama's widths cut to
               4 of its 16 layers (OBSERVE_LAYERS), bf16, B 4 x S 2048 a
               rank, 2 warm-up and 8 timed steps) on two
               ranks sharing the card (``--observe-worker RANK``), plain,
               then with the timeline on every rank, telemetry every
               cycle, the flight recorder and rank 0's metrics endpoint:
               during a quiet hold after the last step this process times
               a scrape of ``/json`` and ``/metrics`` and runs ``run
               --status``; fleet totals equal the ranks' summed
               ``stats()``, the stall counter's TYPE line and the
               per-rank series are there, the merged timeline's flows all
               resolve (sinks after their sources, none before 0), the
               hook form's gradient names are its spans, the ranks'
               parameters are bitwise equal, 4 launches of each of B1-B3
               a step; step ms off and on, timeline MB and events a step,
               scrape ms; then the stall inspector (rank 1 withholds a
               4 MB CUDA tensor 3 s under ``HOROVOD_STALL_WARNING_SEC=1``:
               1-5 warnings and one escalation dump naming it) and the
               flight recorder (``HOROVOD_FAULT_INJECT=1:6:exit`` with
               CUDA tensors in flight: the postmortem names rank 1, last
               committed cycle >= 1);
    autotune — the same part under ``HOROVOD_AUTOTUNE=1`` (chunk,
               fusion threshold and cycle time; seed 7; 256 MiB windows;
               the whole 16-trial schedule): 3 steps at the default
               config, the search while training goes on, 3 steps at the
               committed config; the executed schedule is the planned
               one, both ranks hold the committed knobs, the loss falls,
               the ranks' parameters are equal; trials, the committed
               config, bus GB/s (``stats_delta``) and step ms before and
               after (no gain is claimed);
19. zoo     — the rest of the model zoo, the training sugar and the
               examples, each example's ``main(argv)`` driven in this
               process on the card at its own sizes: ``flax_mnist_advanced``
               (2 epochs through ``training.fit`` with the broadcast,
               metric-average and warmup callbacks: the loss falls, epoch
               2's accuracy >= 0.9, the lr ends at lr · n);
               ``jax_mnist_estimator`` twice on one ``--model-dir`` (the
               second warm-starts at epoch 4 with eval metrics within
               1e-6); ``jax_word2vec`` at ``SkipGramModel``'s default
               widths (vocab 50 000 × 128, B 128, 8 negatives, Adagrad,
               400 steps: the loss falls; ms a step);
               ``jax_imagenet_resnet50`` (bf16, B 64 × 224², ``--compression
               bf16``, 256 images: epoch 1, then a run that resumes from
               its checkpoint and trains epoch 2); ``torch_mnist`` and
               ``torch_synthetic_benchmark`` (the hook form; img/s);
               ``torch_imagenet_resnet50`` on two ranks sharing the card
               through ``python -m horovod_tpu_torch.run -np 2`` (train,
               then resume); and ``MnistConvNet`` and ``SkipGramModel``
               forwards on the card against the CPU, fp32, TF32 off
               (within 1e-5 of the largest value): each part's wall s,
               steps/s and checks in one line;
20. train_profile, train_packed_profile, train_bert_profile,
               train_resnet_profile, bench_llama_profile,
               train_moe_profile — where one step of each goes
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
21. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

``parallel`` runs side by side with ``ckpt``, and ``parallel_zoo`` with
``ckpt_kill``: each of these phases works in processes it starts, each
world on a coordinator port of its own.  Each phase prints one JSON line
(``script_s``: seconds since the script started); any failed check
raises (exit != 0) and
no result line is printed.  Without a CUDA device it exits 2 at once.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import importlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import bench, bench_serve, timeline, torch_frontend
from horovod_tpu_torch.checkpoint import (CheckpointLoader, CheckpointWriter,
                                          jax_capture, latest_manifest,
                                          torch_capture, torch_restore)
from horovod_tpu_torch.checkpoint import manifest as ckpt_manifest
from horovod_tpu_torch.checkpoint.push import (WeightPusher, decode_leaves,
                                               encode_leaves)
from horovod_tpu_torch.examples import bert_pretraining_fsdp as bert_example
from horovod_tpu_torch.examples.llama_packed_pretraining import (
    boundary_mask, make_packed_batch, packed_lm_loss)
from horovod_tpu_torch.experiments import conv_bn_spike
from horovod_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                           dot_product_attention)
from horovod_tpu_torch.models.convert import (init_params, jax_paths,
                                              params_to_jax)
from horovod_tpu_torch.models.generation import (generate, paged_decode_step,
                                                 paged_prefill)
from horovod_tpu_torch.models.llama import (LlamaConfig, LlamaModel, RMSNorm,
                                            attend, causal_attention)
from horovod_tpu_torch.common import native_build
from horovod_tpu_torch.common.launch import TORCH_PORT_OFFSET, free_port
from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig
from horovod_tpu_torch.monitor import postmortem
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import conv_bn_stats as cbs
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import paged_attention as pa
from horovod_tpu_torch.ops import rms_norm as rn
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.mixed_precision import MasterWeights
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.api import (make_parallel_train_step,
                                            shard_params)
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.runtime import staging
from horovod_tpu_torch.runtime.engine import HorovodInternalError, get_engine
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ModelRunner, build_model_config
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK
from horovod_tpu_torch.serve.scheduler import Request, Scheduler
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


#: The script's start: each phase line carries the seconds since it
#: (``script_s``), so the lines give each phase's share of the time limit.
SCRIPT_T0 = time.monotonic()


_EMIT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase,
                       "script_s": time.monotonic() - SCRIPT_T0, **fields})
    with _EMIT_LOCK:        # whole lines, also from phases run side by side
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def side_by_side(*calls) -> list:
    """Run each of ``calls`` (a callable of no argument) in a thread of its
    own and return their results in order, once every one has ended; the
    first exception raised in any of them is raised here.  For phases
    whose work is in processes they start, so that two such phases share
    the card's host instead of waiting for each other."""
    results, errors = [None] * len(calls), [None] * len(calls)

    def run(i):
        try:
            results[i] = calls[i]()
        except BaseException as e:  # noqa: BLE001 -- raised after the join
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


_PORTS_LOCK = threading.Lock()
_PORTS_HANDED: set = set()


def distinct_port() -> int:
    """A free port (``free_port``: it and the port TORCH_PORT_OFFSET above
    it) that no earlier launch of this script was handed, so launches
    that start side by side never pick the same one."""
    with _PORTS_LOCK:
        while True:
            port = free_port()
            pair = {port, port + TORCH_PORT_OFFSET}
            if not pair & _PORTS_HANDED:
                _PORTS_HANDED.update(pair)
                return port


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
    check(runner.captures == 4, f"{runner.captures} decode graphs captured "
                                "at warm-up, not 4 (widths 1, 2, 4, 8)")

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
    rn.reset_launches()
    t_submit = {}
    t0 = time.monotonic()
    for rid, prompt, new in reqs:
        t_submit[rid] = time.monotonic()
        cli.start_generate(rid, prompt, new)
    results = {rid: cli.collect(rid, timeout=600) for rid, _, _ in reqs}
    wall = time.monotonic() - t0
    launches = pa.launches
    norm_launches, norm_plain = rn.launches["rms_fwd"], \
        rn.plain_calls["rms_fwd"]
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
    # Every decode step is a graph replay, which runs the layers' kernel
    # launches it captured (counted per replay).
    check(runner.captures == 4, "a decode width was captured while serving")
    check(launches == mcfg.num_layers * steps,
          f"kernel launches {launches} != layers x decode steps "
          f"{mcfg.num_layers} x {steps}")
    # Every norm of every decode replay and prefill ran the RMSNorm
    # kernel (two a layer and the final one a forward).
    norms_per_forward = 2 * mcfg.num_layers + 1
    check(norm_plain == 0 and norm_launches
          == norms_per_forward * (steps + stats["prefills"]),
          f"RMSNorm launches {norm_launches} (plain {norm_plain}) != "
          f"{norms_per_forward} x (decode steps {steps} + prefills "
          f"{stats['prefills']})")
    emit("serve", model=cfg.model, layers=mcfg.num_layers,
         hidden=mcfg.hidden_size, vocab=mcfg.vocab_size,
         dtype=str(mcfg.dtype).replace("torch.", ""), requests=len(reqs),
         tokens=n_tokens, wall_s=wall, tokens_per_s=n_tokens / wall,
         ttft_ms_p50=statistics.median(ttft), ttft_ms_max=max(ttft),
         decode_step_ms_p50=statistics.median(decode_ms),
         decode_step_ms_max=max(decode_ms), decode_steps=steps,
         kernel_launches=launches, rms_fwd_launches=norm_launches,
         batch_occupancy=stats["batch_occupancy"],
         prefix_hits=stats["prefix_hits"],
         prefill_tokens_saved=stats["prefill_tokens_saved"],
         preemptions=stats["preemptions"],
         kv_blocks_in_use=stats["kv_blocks_in_use"], init_s=init_s,
         warmup_s=warmup_s, warmup_programs=buckets,
         graphs_captured=runner.captures,
         capture_s=runner.capture_seconds,
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


#: The kernel table's decode positions (PERF.md section 6), a row each.
GRAPH_POS = [2047, 1087, 600, 320, 100, 0, 16, 0]


def graph_rows(runner, width, seed):
    """``width`` live rows at GRAPH_POS: tokens, [maxb] tables, positions.
    Rows read shared blocks below their last one; each last block (where
    the row's K/V is written) is a row's own, so no two rows write one
    slot."""
    bs, maxb = runner.block_size, runner.max_blocks_per_seq
    shared = runner.num_blocks - 1 - 8
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, runner.model_cfg.vocab_size, width).tolist()
    pos = GRAPH_POS[:width]
    tables = []
    for i, p in enumerate(pos):
        t = np.full((maxb,), TRASH_BLOCK, np.int32)
        last = p // bs
        t[:last] = 1 + np.arange(last) % shared
        t[last] = 1 + shared + i
        tables.append(t)
    return tokens, tables, pos


def eager_decode(runner, tokens, tables, pos, model=None):
    """``ModelRunner.decode`` without its graph: the same padding, the
    ``paged_decode_step`` body run eagerly (on ``model``, default the
    runner's, over the runner's pools), fp32 logits to the host."""
    dev, maxb = runner.device, runner.max_blocks_per_seq
    width = 1 << max(0, len(tokens) - 1).bit_length()
    t = np.zeros((width,), np.int64)
    t[:len(tokens)] = tokens
    tb = np.full((width, maxb), TRASH_BLOCK, np.int32)
    tb[:len(tables)] = tables
    p = np.zeros((width,), np.int32)
    p[:len(pos)] = pos
    logits, _, _ = paged_decode_step(
        model or runner.model, torch.from_numpy(t).to(dev), runner.pool_k,
        runner.pool_v, torch.from_numpy(tb).to(dev),
        torch.from_numpy(p).to(dev), fused=runner.fused_attn)
    return logits[:len(tokens)].float().cpu().numpy()


def phase_serve_graph(runner, seed):
    """The decode graph of each width against the eager step: at widths
    1, 2, 4 and 8, on the same inputs and pools (random K/V), the graph's
    logits and the K/V it writes must equal ``paged_decode_step``'s bit
    for bit."""
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    for pool in (runner.pool_k, runner.pool_v):
        pool[:, 1:].normal_(generator=gen)
    rows = {}
    for width in (1, 2, 4, 8):
        tokens, tables, pos = graph_rows(runner, width, seed + width)
        k0, v0 = runner.pool_k.clone(), runner.pool_v.clone()
        got = runner.decode(tokens, tables, pos)
        gk, gv = runner.pool_k.clone(), runner.pool_v.clone()
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)
        want = eager_decode(runner, tokens, tables, pos)
        check(bool(np.isfinite(got).all()), f"width {width}: graph logits "
                                            "not finite")
        rows[width] = {
            "logits_bitwise": bool(np.array_equal(got, want)),
            "max_abs_diff": float(np.abs(got - want).max()),
            "kv_bitwise": bool(torch.equal(gk, runner.pool_k)
                               and torch.equal(gv, runner.pool_v))}
        del k0, v0, gk, gv
    emit("serve_graph", widths=rows, pos=GRAPH_POS,
         graphs_captured=runner.captures,
         capture_s=runner.capture_seconds,
         graph_kernel_launches={w: runner._decode_fn(w).kernel_launches
                                for w in (1, 2, 4, 8)})
    for width, r in rows.items():
        check(r["logits_bitwise"] and r["kv_bitwise"],
              f"width {width}: the decode graph is not the eager step bit "
              f"for bit (max |dlogit| {r['max_abs_diff']})")
    check(runner.captures == 4, "serve_graph captured another graph")


def step_profile(step, reps):
    """(host wall ms, device busy ms, kernels) a step of ``step``."""
    from torch.profiler import ProfilerActivity, profile

    step()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
    kernels, _ = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return wall_ms, busy_ms, kernels


def phase_profile(runner):
    """Where one decode step's time goes at batch 8: host wall time of
    ``ModelRunner.decode`` (the graph replay with its copies) against the
    device time of its kernels (``torch.profiler``), the top kernels by
    device time and the idle share of the card; the same for the eager
    step on the same inputs; and the graph's replay alone between CUDA
    events."""
    maxb = runner.max_blocks_per_seq
    table = np.arange(1, maxb + 1, dtype=np.int32)      # one long row
    width, pos, reps = 8, 1000, 5
    args = ([1] * width, [table] * width, [pos] * width)
    wall_ms, busy_ms, kernels = step_profile(
        lambda: runner.decode(*args), reps)
    eager_wall, eager_busy, eager_kernels = step_profile(
        lambda: eager_decode(runner, *args), reps)
    graph = runner._decode_fn(width).graph
    span_ms = cuda_ms(graph.replay, 20, torch.empty(
        L2_FLUSH_BYTES, dtype=torch.uint8, device=runner.device))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", batch=width, pos=pos, fused=runner.fused_attn,
         step_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms,
         kernels_per_step=sum(e.count for e in kernels) / reps,
         graph_replay_ms=span_ms,
         eager_step_wall_ms=eager_wall, eager_device_busy_ms=eager_busy,
         eager_idle_share=1.0 - eager_busy / eager_wall,
         eager_kernels_per_step=sum(e.count for e in eager_kernels) / reps,
         top=[{"name": e.key[:80],
               "ms_per_step": e.self_device_time_total / 1e3 / reps,
               "calls_per_step": e.count / reps} for e in top])


# ---------------------------------------------------------------------------
# phase 4b: the router fleet on llama3_8b
# ---------------------------------------------------------------------------

FLEET_REQUESTS, FLEET_RATE_HZ, FLEET_NEW_TOKENS = 16, 4.0, 32
#: Replica 1's decode step at which the fault run kills it: early in its
#: first requests' 32 tokens, so it owes requests when it dies.
FLEET_FAULT_STEP = 10
FLEET_TIMEOUT_S = 300


def serve_mount(mport: int) -> dict:
    """The router's ``"serve"`` mount, read from ``/json``."""
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/json",
                                timeout=10) as resp:
        return json.loads(resp.read().decode())["serve"]


def _sample_mount(mport: int, samples: list, stop: threading.Event):
    """Read the mount every 0.1 s until ``stop``; (s since start, its
    dict) appended."""
    t0 = time.monotonic()
    while not stop.is_set():
        try:
            samples.append((time.monotonic() - t0, serve_mount(mport)))
        except (OSError, ValueError):
            pass
        stop.wait(0.1)


def fleet_run(env, plan, restart, wait_ready):
    """One ``run.py --serve --replicas 2 --device cuda`` fleet driven by
    ``bench_serve.run_load``, its router serving the metrics endpoint
    (``HOROVOD_METRICS_PORT``), whose ``"serve"`` mount is sampled every
    0.1 s; returns (aggregate, records, log, router exit code, failures,
    mount).  ``wait_ready``: how many READY lines replica 1 must print
    before the fleet is shut down (and then both replicas must read
    alive on the mount)."""
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()
    mport = distinct_port()
    proc, port, log = bench_serve.start_fleet(
        2, device="cuda", env=dict(env, HOROVOD_METRICS_PORT=str(mport)),
        restart=restart, timeout=FLEET_TIMEOUT_S)
    cli, samples, stop = None, [], threading.Event()
    sampler = threading.Thread(target=_sample_mount,
                               args=(mport, samples, stop), daemon=True)
    sampler.start()
    mount = {"port": mport}
    try:
        cli, records, agg = bench_serve.run_load(port, plan,
                                                 timeout=FLEET_TIMEOUT_S)
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while time.monotonic() < deadline and sum(
                "[replica 1] SERVE_REPLICA_READY" in ln
                for ln in list(log)) < wait_ready:
            time.sleep(0.5)
        while time.monotonic() < deadline and (
                not samples or samples[-1][1]["replicas_alive"] != 2):
            time.sleep(0.1)
        stop.set()
        sampler.join(timeout=30)
        mount["final"] = serve_mount(mport)
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=10) as resp:
            mount["prom"] = [ln for ln in resp.read().decode().splitlines()
                             if "horovod_serve_" in ln
                             and not ln.startswith("# HELP")]
    finally:
        stop.set()
        rc = bench_serve.stop_fleet(proc, cli, timeout=120)
    alive = []
    for t, sample in samples:
        if not alive or alive[-1][1] != sample["replicas_alive"]:
            alive.append((round(t, 2), sample["replicas_alive"]))
    mount.update(samples=len(samples), replicas_alive=alive,
                 metrics_ready=any(f"SERVE_METRICS_READY port={mport}" in ln
                                   for ln in log))
    failures = bench_serve.leaks({proc.pid}, shm_before, [port, mport])
    bench_serve.kill_fleet(proc)        # whatever leaked goes now
    return agg, records, list(log), rc, failures, mount


def replica_times(log):
    """The replicas' SERVE_REPLICA_TIMES lines, in order."""
    out = []
    for ln in log:
        m = re.search(r"SERVE_REPLICA_TIMES replica=(\d+) init_sec=([\d.]+) "
                      r"captures=(\d+) capture_sec=([\d.]+)", ln)
        if m:
            out.append({"replica": int(m.group(1)),
                        "init_s": float(m.group(2)),
                        "captures": int(m.group(3)),
                        "capture_s": float(m.group(4))})
    return out


def phase_fleet(seed):
    """The router fleet (``python -m horovod_tpu_torch.run --serve
    --replicas 2 --device cuda``) on Llama-3-8B, both replicas on the one
    card, under ``bench_serve.run_load``'s open-loop Poisson load; then
    the same plan with replica 1 killed mid-stream and relaunched."""
    env = dict(SERVE_ENV, HOROVOD_SERVE_PARAM_SEED=str(seed),
               HOROVOD_SERVE_WARMUP="512")
    vocab = build_model_config(ServeConfig.from_env(env)).vocab_size
    plan = bench_serve.make_plan(
        FLEET_REQUESTS, FLEET_RATE_HZ, seed=seed, vocab=vocab,
        prompt_lo=64, prompt_hi=512, max_tokens_lo=FLEET_NEW_TOKENS,
        max_tokens_hi=FLEET_NEW_TOKENS)
    runs, mounts = {}, {}
    for name, extra, restart, ready in (
            ("clean", {}, 0, 1),
            ("fault", {"HOROVOD_FAULT_INJECT":
                       f"1:{FLEET_FAULT_STEP}:exit"}, 1, 2)):
        agg, records, log, rc, failures, mount = fleet_run(
            dict(env, **extra), plan, restart, ready)
        runs[name] = (agg, records, log, rc, failures)
        mounts[name] = mount
        keep = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99",
                "req_latency_ms_p50", "req_latency_ms_p99",
                "batch_occupancy", "completed", "requests", "requeued",
                "tokens", "wall_s", "preemptions", "prefix_hits",
                "fused_attn_steps", "kv_blocks_in_use_final")
        emit("fleet", run=name, replicas=2, device="cuda:0 (both)",
             rate_hz=FLEET_RATE_HZ, new_tokens=FLEET_NEW_TOKENS,
             prompt_tokens=[64, 512], router_rc=rc,
             router=agg["router"], replica_times=replica_times(log),
             replica1_ready=sum("[replica 1] SERVE_REPLICA_READY" in ln
                                for ln in log),
             leaks=failures, metrics_mount=mount,
             **{k: agg[k] for k in keep})
    clean, fault = runs["clean"], runs["fault"]
    for name, (agg, records, log, rc, failures) in runs.items():
        check(agg["completed"] == FLEET_REQUESTS,
              f"fleet {name}: {agg['completed']} of {FLEET_REQUESTS} "
              f"requests completed\n" + "".join(log[-30:]))
        check(rc == 0, f"fleet {name}: router exited {rc}")
        check(not failures, f"fleet {name}: {failures}")
        check(agg["kv_blocks_in_use_final"] == 0,
              f"fleet {name}: KV blocks in use after the run")
        check(agg["fused_attn_steps"] > 0, f"fleet {name}: no fused step")
    for name, want in (("clean", [2]), ("fault", [2, 1, 2])):
        mount, router = mounts[name], runs[name][0]["router"]
        check(mount["metrics_ready"]
              and [a for _, a in mount["replicas_alive"]] == want,
              f"fleet {name}: the mount read replicas_alive "
              f"{mount['replicas_alive']}, not {want}")
        final = mount["final"]
        check(all(final[k] == router[k] for k in (
            "completed", "requeued", "replica_deaths", "failed")),
              f"fleet {name}: mount {final} disagrees with the router's "
              f"stats {router}")
        check("# TYPE horovod_serve_completed counter" in mount["prom"]
              and "horovod_serve_replicas_alive 2" in mount["prom"],
              f"fleet {name}: /metrics serve gauges {mount['prom']}")
    check(clean[0]["requeued"] == 0, "the fault-free fleet requeued")
    check(fault[0]["requeued"] > 0, "replica 1 died owing no request")
    check(sum("[replica 1] SERVE_REPLICA_READY" in ln for ln in fault[2])
          == 2, "replica 1 was not relaunched once")
    differ = [rid for rid, rec in clean[1].items()
              if rec["tokens"] != fault[1][rid]["tokens"]]
    check(not differ, f"requests {differ} streamed other tokens after the "
                      "requeue than in the fault-free run")


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


#: The Keras MNIST example's gradients (``examples/keras_mnist.py``: two
#: 5x5 convolutions and two dense layers, kernels and biases in Keras's
#: layouts), fp32.
KERAS_MNIST_SHAPES = ((5, 5, 1, 10), (10,), (5, 5, 10, 20), (20,),
                      (320, 50), (50,), (50, 10), (10,))
KERAS_CORE_ITERS = 10
#: Compression -> the wire dtype ``keras/impl.py`` casts to.
KERAS_WIRES = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16}


def keras_inputs(kind: str, rank: int, dev, shapes) -> list:
    """Rank ``rank``'s seeded tensors of one keras_core batch, made on the
    card (every rank can make every rank's, for the expected results)."""
    seed = {"keras_mnist": 2000, "resnet50": 1000, "variables": 3000}[kind]
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    return [torch.randn(sh, generator=gen, device=dev) for sh in shapes]


def keras_core_checks(dev, rank: int, size: int, eng, rn50_shapes) -> dict:
    """The Keras frontend's core on the card, with neither Keras nor
    TensorFlow: ``impl.average_tensors`` (the torch backend's branch of
    ``allreduce_gradients``) on the Keras MNIST model's 8 gradients and
    ResNet-50's 161, with compression none, fp16 and bf16, each result
    bitwise the mean of the host copies (of their wire casts, cast back),
    the inputs unchanged, device and dtype kept, within the reference's
    cycle bound; ``broadcast_tensors`` of CUDA variables from rank 0; the
    metric path's ``allreduce`` of a float.  Times 10 calls of each
    batch and compression."""
    from horovod_tpu_torch.keras import allreduce as metric_allreduce
    from horovod_tpu_torch.keras.impl import (average_tensors,
                                              broadcast_tensors)

    t_start = time.monotonic()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"batches": {}}
    for kind, shapes in (("keras_mnist", KERAS_MNIST_SHAPES),
                         ("resnet50", rn50_shapes)):
        grads = keras_inputs(kind, rank, dev, shapes)
        before = [g.cpu() for g in grads]
        hosts = [[g.cpu() for g in keras_inputs(kind, r, dev, shapes)]
                 for r in range(size)]
        n = len(grads)
        for comp, wire in KERAS_WIRES.items():
            name = f"keras.{kind}.{comp}"
            got = average_tensors(grads, name, comp)
            for i, (g, b) in enumerate(zip(got, before)):
                ws = [h[i] if wire is None else h[i].to(wire) for h in hosts]
                total = ws[0]
                for w in ws[1:]:
                    total = total + w
                want = (total / torch.full((), size, dtype=total.dtype)
                        ).to(b.dtype)
                check(g.device == dev and g.dtype == b.dtype
                      and bitwise_equal(g, want),
                      f"keras_core: {kind} {comp} tensor {i} differs from "
                      "the host mean")
            check(all(bitwise_equal(g, b) for g, b in zip(grads, before)),
                  f"keras_core: {kind} {comp} changed an input")
            st0, eg0 = staging.stats(), eng.stats()
            walls, cycles = [], []
            for _ in range(KERAS_CORE_ITERS):
                c0 = eng.stats()["cycles"]
                sync()
                t = time.perf_counter()
                average_tensors(grads, name, comp)
                sync()
                walls.append((time.perf_counter() - t) * 1e3)
                cycles.append(eng.stats()["cycles"] - c0)
            st1, eg1 = staging.stats(), eng.stats()
            # tests/tf_worker.py:178's bound, <= n // 2 negotiation cycles
            # for a batch of n (per-tensor calls take >= n), on the median
            # call: the engine wakes at each enqueue, so where the ranks'
            # enqueue loops meet a cycle varies from call to call.
            check(statistics.median(cycles) <= n // 2,
                  f"keras_core: {kind} {comp} took {cycles} cycles a call")
            out["batches"][name] = {
                "tensors": n, "values": sum(g.numel() for g in grads),
                "wire_bytes": sum(g.numel() for g in grads)
                * (4 if wire is None else 2),
                "cycles": cycles, "cycle_bound": n // 2,
                "wall_ms_p50": statistics.median(walls),
                "wall_ms_max": max(walls), "wall_ms": walls,
                "d2h_ms": (st1["d2h_ms"] - st0["d2h_ms"]) / KERAS_CORE_ITERS,
                "h2d_ms": (st1["h2d_ms"] - st0["h2d_ms"]) / KERAS_CORE_ITERS,
                "responses_per_call": (eg1["responses"] - eg0["responses"])
                / KERAS_CORE_ITERS,
                "bitwise_vs_host": True}
        del grads, before, hosts

    # Variables broadcast from rank 0: every rank ends with rank 0's bits.
    mine = keras_inputs("variables", rank, dev, KERAS_MNIST_SHAPES)
    kept = [v.cpu() for v in mine]
    root = [v.cpu() for v in keras_inputs("variables", 0, dev,
                                          KERAS_MNIST_SHAPES)]
    got = broadcast_tensors(mine, 0, "keras.bcast.variables")
    check(all(g.device == dev and bitwise_equal(g, r)
              for g, r in zip(got, root)),
          "keras_core: broadcast variables differ from rank 0's")
    check(all(bitwise_equal(v, k) for v, k in zip(mine, kept)),
          "keras_core: broadcast changed an input")

    mean = metric_allreduce(float(rank) + 0.25, name="keras.metric")
    want = sum(r + 0.25 for r in range(size)) / size
    check(isinstance(mean, float) and mean == want,
          f"keras_core: metric allreduce gave {mean!r}, not {want}")
    loaded = sorted(m for m in ("keras", "tensorflow", "jax")
                    if m in sys.modules)
    check(not loaded, f"keras_core: {loaded} imported")
    out.update(broadcast_ok=True, metric_mean=mean,
               keras_core_s=time.monotonic() - t_start)
    return out


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
    del a, b, x, outs, batch, got, want, first, again
    out["keras_core"] = keras_core_checks(dev, rank, size, eng, shapes)
    hvd.shutdown()
    return out


def run_ranks(flag: str, phase: str, timeout_s: float, extra=(),
              env_extra=None, rank_env=None, exit_codes=None) -> list:
    """Start this script once per rank (``flag RANK`` and ``extra``, every
    rank on cuda:0) and return each rank's last stdout line, parsed.  No
    torch.distributed collective runs in them (NCCL refuses two ranks on
    one device; the group is created lazily).  Any rank's failure or
    timeout fails the phase.  ``HOROVOD_SHM_DISABLE`` alone of the
    caller's ``HOROVOD_*`` variables reaches the ranks, with
    ``env_extra`` and ``rank_env[r]`` laid over; their output goes to
    files, so no rank blocks on a full pipe while another is waited on.
    ``exit_codes[r]`` is a rank's expected exit code other than 0 (an
    injected death); such a rank's result is None."""
    port = distinct_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(HOROVOD_SIZE=str(ENGINE_RANKS),
               HOROVOD_LOCAL_SIZE=str(ENGINE_RANKS),
               HOROVOD_COORDINATOR=f"127.0.0.1:{port}",
               HOROVOD_SHM_DISABLE=os.environ.get("HOROVOD_SHM_DISABLE", "0"))
    env.update(env_extra or {})
    want = {r: (exit_codes or {}).get(r, 0) for r in range(ENGINE_RANKS)}
    logs = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    files = [(open(os.path.join(logs, f"rank{r}.out"), "w+"),
              open(os.path.join(logs, f"rank{r}.err"), "w+"))
             for r in range(ENGINE_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), *extra],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_LOCAL_RANK=str(r),
                 **(rank_env or {}).get(r, {})),
        stdout=files[r][0], stderr=files[r][1], text=True)
        for r in range(ENGINE_RANKS)]
    t0 = time.monotonic()

    def tail(r, n=4000):
        files[r][1].seek(0)
        return files[r][1].read()[-n:]

    try:
        # Poll all ranks together: the first to fail ends the phase with
        # its own error, not with its peer's hang.
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                check(p.poll() in (None, want[r]),
                      f"{phase} rank {r} exited {p.returncode}:\n{tail(r)}")
            if time.monotonic() - t0 > timeout_s:
                raise RuntimeError(
                    f"chip_smoke check failed: {phase} ranks "
                    f"{[r for r, p in enumerate(procs) if p.poll() is None]}"
                    f" timed out after {timeout_s} s:\n"
                    + "\n".join(tail(r, 2000) for r in range(ENGINE_RANKS)))
            time.sleep(0.2)
        results = []
        for r, p in enumerate(procs):
            check(p.returncode == want[r], f"{phase} rank {r} exited "
                                           f"{p.returncode}:\n{tail(r)}")
            if want[r]:
                results.append(None)
                continue
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
    return results


def phase_engine():
    """Two ranks of the eager engine on the one card, each a process of
    this script (``--engine-worker RANK``) on cuda:0."""
    t0 = time.monotonic()
    results = run_ranks("--engine-worker", "engine", ENGINE_TIMEOUT_S)
    keras_core = [r.pop("keras_core") for r in results]
    shm = shutil.disk_usage("/dev/shm")
    emit("engine", ranks=ENGINE_RANKS, wall_s=time.monotonic() - t0,
         dev_shm_bytes=shm.total, dev_shm_free_bytes=shm.free,
         shm_disable=os.environ.get("HOROVOD_SHM_DISABLE", "0"),
         per_rank=results, nvidia_smi_after=smi_now())
    emit("keras_core", ranks=ENGINE_RANKS, iters=KERAS_CORE_ITERS,
         nvidia_smi=smi_now(), per_rank=keras_core)


# ---------------------------------------------------------------------------
# phase 10c: the engine bench's sweep bodies (horovod_tpu_torch.bench_engine)
# on CUDA tensors, two ranks on the one card
# ---------------------------------------------------------------------------

ENGINE_BENCH_TIMEOUT_S = 240
#: The allreduce points: the bench's sizes from 4 KB to 64 MB.
ENGINE_BENCH_SIZES = (("4KB", 4 << 10), ("1MB", 1 << 20),
                      ("16MB", 16 << 20), ("64MB", 64 << 20))
#: The planes: four channels and one, each on TCP and on shm (the
#: bench's ``allreduce_bus_bw_mb_s``, ``_1ch`` and ``_shm`` keys, and the
#: one-channel shm plane between them).
ENGINE_BENCH_PLANES = (
    ("tcp_ch4", {"HOROVOD_NUM_CHANNELS": "4", "HOROVOD_SHM_DISABLE": "1"}),
    ("tcp_ch1", {"HOROVOD_NUM_CHANNELS": "1", "HOROVOD_SHM_DISABLE": "1"}),
    ("shm_ch4", {"HOROVOD_NUM_CHANNELS": "4", "HOROVOD_SHM_DISABLE": "0"}),
    ("shm_ch1", {"HOROVOD_NUM_CHANNELS": "1", "HOROVOD_SHM_DISABLE": "0"}))
#: The reducescatter, alltoall and wire points' size.
ENGINE_BENCH_RS_BYTES, ENGINE_BENCH_WIRE_BYTES = 16 << 20, 1 << 20
#: The grouped points: 161 tensors (ResNet-50's gradient count) of 1 Ki
#: fp32 values, through one grouped allreduce and one allreduce a tensor,
#: then ResNet-50's own 161 gradients grouped beside one tensor of their
#: 25 557 032 values: a call's cost per tensor against its cost per byte.
ENGINE_BENCH_GROUP_VALUES, ENGINE_BENCH_GROUP_ITERS = 1024, 5


def engine_bench_point(be, kind, x, iters, name, wire_dtype=None,
                       want=None) -> dict:
    """One sweep point of the bench (``bench_engine.measure``) on the CUDA
    tensor ``x``, its last result held bitwise against the same call on
    a host copy of ``x`` and, where given, against ``want`` (the plain
    host sum of every rank's input); returns the point's figures and both
    sides' ``data_bytes_tx``."""
    m = be.measure(kind, x, iters, name=name, wire_dtype=wire_dtype)
    host = be.measure(kind, x.cpu(), 1, name=f"{name}.host",
                      wire_dtype=wire_dtype)
    check(m["out"].device == x.device and bitwise_equal(m["out"],
                                                        host["out"]),
          f"engine_bench: {name} on the card differs from the host copy's")
    check(want is None or bitwise_equal(m["out"], want),
          f"engine_bench: {name} differs from the host sum of the ranks' "
          "inputs")
    check(m["tx"] % iters == 0 and m["tx"] // iters == host["tx"],
          f"engine_bench: {name} moved {m['tx']} bytes in {iters} calls "
          f"on the card, {host['tx']} a call on the host")
    return {"kind": kind, "bytes": x.numel() * x.element_size(),
            "iters": iters, "bus_gb_per_s": m["bus_mb_s"] / 1e3,
            "wall_ms": m["wall_ms"], "engine_ms": m["engine_ms"],
            "d2h_ms": m["d2h_ms"], "h2d_ms": m["h2d_ms"],
            "tx_per_call": host["tx"], "bitwise_vs_host": True,
            "bitwise_vs_host_sum": want is not None}


def engine_bench_inputs(seed, shapes, size, dev):
    """Every rank's seeded fp32 inputs of one point (rank r's from
    ``seed + r``), made on the card: ``(card tensors of each rank, their
    plain host sum in rank order)``."""
    every = []
    for r in range(size):
        gen = torch.Generator(device=dev).manual_seed(seed + r)
        every.append([torch.randn(sh, generator=gen, device=dev)
                      for sh in shapes])
    sums = [host_sum([xs[i].cpu() for xs in every])
            for i in range(len(shapes))]
    return every, sums


def engine_bench_group(hvd_, eng, name, xs, want, grouped) -> dict:
    """``ENGINE_BENCH_GROUP_ITERS`` averages of the tensors ``xs``: one
    ``grouped_allreduce`` a call, or (``grouped`` false) one ``allreduce``
    a tensor, each waited for before the next.  The results are held
    bitwise against the host copies' and against ``want`` (the plain host
    sums) over the world's size.  Returns the wall ms of a call (the card
    synchronized before and after), the engine's allreduce ms, D2H and
    H2D ms, negotiation cycles and responses, each per call."""
    size = hvd_.size()
    sync = (torch.cuda.synchronize if xs[0].device.type == "cuda"
            else (lambda: None))

    def call(ts, tag):
        if grouped:
            return hvd_.grouped_allreduce(ts, name=f"{name}{tag}")
        return [hvd_.allreduce(t, name=f"{name}{tag}.{i}")
                for i, t in enumerate(ts)]

    got = call(xs, "")
    host = call([x.cpu() for x in xs], ".host")
    div = torch.full((), size, dtype=torch.float32)
    check(all(g.device == x.device and bitwise_equal(g, h)
              and bitwise_equal(g, w / div)
              for g, h, w, x in zip(got, host, want, xs)),
          f"engine_bench: {name} differs from the host copies' or from "
          "the host mean of the ranks' inputs")
    st0, eg0 = staging.stats(), eng.stats()
    walls = []
    for _ in range(ENGINE_BENCH_GROUP_ITERS):
        sync()
        t = time.perf_counter()
        call(xs, "")
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    st1, eg1 = staging.stats(), eng.stats()
    n = ENGINE_BENCH_GROUP_ITERS
    return {"tensors": len(xs), "bytes": sum(4 * x.numel() for x in xs),
            "grouped": grouped, "iters": n, "wall_ms": walls,
            "wall_ms_median": statistics.median(walls),
            "engine_ms": (eg1["allreduce_ns"] - eg0["allreduce_ns"]) / 1e6 / n,
            "d2h_ms": (st1["d2h_ms"] - st0["d2h_ms"]) / n,
            "h2d_ms": (st1["h2d_ms"] - st0["h2d_ms"]) / n,
            "cycles": (eg1["cycles"] - eg0["cycles"]) / n,
            "responses": (eg1["responses"] - eg0["responses"]) / n,
            "bitwise_vs_host": True, "bitwise_vs_host_mean": True}


def engine_bench_worker(rank: int, device: str) -> dict:
    """One rank of the engine_bench phase: the bench's allreduce sweep on
    four planes, reducescatter and alltoall at 16 MB, the small-allreduce
    latency and the fp16 / int8 wires at 1 MB, on seeded CUDA tensors;
    every point bitwise against its host copy's and moving the same bytes
    a call.  Any failed check raises."""
    from horovod_tpu_torch import bench_engine as be

    be._DEVICE = device
    t0 = time.monotonic()
    hvd_, eng = be._engine_setup()
    dev, size = hvd_.device(), hvd_.size()
    gen = torch.Generator(device=dev).manual_seed(2000 + rank)
    out = {"rank": rank, "size": size, "device": str(dev), "points": {}}
    pts = out["points"]
    seed = 3000
    for plane, env in ENGINE_BENCH_PLANES:
        os.environ.update(env)
        be._reinit(hvd_)
        cfg = eng.stats()["config"]
        check(cfg["shm_enabled"] == (env["HOROVOD_SHM_DISABLE"] == "0")
              and cfg["num_channels"] == int(env["HOROVOD_NUM_CHANNELS"]),
              f"engine_bench: plane {plane} came up as {cfg}")
        for label, nbytes in ENGINE_BENCH_SIZES:
            seed += 16
            every, (want,) = engine_bench_inputs(seed, [(nbytes // 4,)],
                                                 size, dev)
            pts[f"allreduce.{plane}.{label}"] = engine_bench_point(
                be, "allreduce", every[rank][0], be._iters(nbytes),
                f"eb.{plane}.{label}", want=want)
            del every
    for k in ("HOROVOD_NUM_CHANNELS", "HOROVOD_SHM_DISABLE"):
        os.environ.pop(k, None)
    be._reinit(hvd_)       # the default plane, the bench's RS and A2A keys
    n = ENGINE_BENCH_RS_BYTES // 4 // size * size
    for kind in ("reducescatter", "alltoall"):
        x = torch.randn(n, generator=gen, device=dev)
        pts[f"{kind}.default.16MB"] = engine_bench_point(
            be, kind, x, be._iters(ENGINE_BENCH_RS_BYTES), f"eb.{kind}")
    out["small_latency_ms"] = be._lat_ms("eb.lat")
    every, (want,) = engine_bench_inputs(
        seed + 16, [(ENGINE_BENCH_WIRE_BYTES // 4,)], size, dev)
    tx = {}
    for wd in ("fp32", "fp16", "int8"):
        pt = engine_bench_point(be, "allreduce", every[rank][0],
                                be._iters(ENGINE_BENCH_WIRE_BYTES),
                                f"eb.wire.{wd}", wire_dtype=wd,
                                want=want if wd == "fp32" else None)
        pts[f"allreduce.wire_{wd}.1MB"] = pt
        tx[wd] = pt["tx_per_call"]
    out["wire_bytes_ratio"] = {wd: tx[wd] / tx["fp32"]
                               for wd in ("fp16", "int8")}
    # Per tensor against per byte, on the default plane: 161 small
    # tensors grouped and one by one; ResNet-50's 161 gradients grouped
    # and the same values as one tensor.
    groups = out["grouped"] = {}
    every, want = engine_bench_inputs(
        seed + 32, [(ENGINE_BENCH_GROUP_VALUES,)] * 161, size, dev)
    for grouped in (True, False):
        groups["161x4KB." + ("grouped" if grouped else "one_by_one")] = \
            engine_bench_group(hvd_, eng, "eb.small", every[rank], want,
                               grouped)
    shapes = [p.shape for p in ResNet(ResNetConfig.resnet50(),
                                      device="meta").parameters()]
    every, want = engine_bench_inputs(seed + 48, shapes, size, dev)
    groups["rn50.grouped"] = engine_bench_group(
        hvd_, eng, "eb.rn50", every[rank], want, True)
    flat = torch.cat([x.reshape(-1) for x in every[rank]])
    del every
    groups["rn50.one_tensor"] = engine_bench_group(
        hvd_, eng, "eb.rn50flat", [flat],
        [torch.cat([w.reshape(-1) for w in want])], False)
    check(groups["rn50.grouped"]["bytes"] == 4 * 25_557_032
          == groups["rn50.one_tensor"]["bytes"],
          "engine_bench: ResNet-50's gradients are not 25 557 032 values")
    del flat, want
    out["staging"] = {k: v for k, v in staging.stats().items()
                      if k.startswith("pinned")}
    hvd_.shutdown()
    out["wall_s"] = time.monotonic() - t0
    return out


def phase_engine_bench():
    """The engine bench's sweep bodies on two ranks sharing the card
    (``--engine-bench-worker RANK``)."""
    t0 = time.monotonic()
    results = run_ranks("--engine-bench-worker", "engine_bench",
                        ENGINE_BENCH_TIMEOUT_S)
    check(results[0]["wire_bytes_ratio"] == results[1]["wire_bytes_ratio"],
          "engine_bench: the ranks' wire byte ratios differ")
    emit("engine_bench", ranks=ENGINE_RANKS, wall_s=time.monotonic() - t0,
         per_rank=results, nvidia_smi_after=smi_now())


# ---------------------------------------------------------------------------
# phase 11: the engine-driven optimizers, training bench_llama's model on
# two ranks of the eager engine on the one card
# ---------------------------------------------------------------------------

TRAIN_RANKS_TIMEOUT_S = 900
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
#: engine_train's depth: bench_llama's widths cut from 16 layers to 2
#: (the anchors' depth), to keep the whole script well inside its time
#: limit (the autotune phase trains the full 16).
ENGINE_TRAIN_LAYERS = 2
LOCAL_SGD_H, LOCAL_SGD_STEPS = 4, 8
#: The anchors' depth (bench_llama's widths).
ANCHOR_LAYERS = 2
#: SGD of the ZeRO-1 and FSDP anchors (tests/sharded_worker.py's).
ANCHOR_SGD = dict(lr=0.05, momentum=0.9)


def param_digest(params) -> torch.Tensor:
    """[P, 2] int64 on the card: each tensor's bits summed plainly and
    weighted by position, to tell ranks' parameters apart."""
    rows = []
    for p in params:
        bits = p.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[p.element_size()]).long()
        pos = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
        rows.append(torch.stack([bits.sum(), (bits * pos).sum()]))
    return torch.stack(rows)


def ranks_agree(params, name: str) -> bool:
    """Whether every rank's ``params`` are bitwise equal (an allgather of
    the digests)."""
    every = hvd.allgather(param_digest(params).unsqueeze(0), name=name)
    return bool((every == every[:1]).all())


def grad_snapshots(named):
    """Clone each gradient as its post-accumulate hook fires.  Registered
    before an optimizer's hooks, so it sees the local gradient."""
    snap = {}
    for n, p in named:
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: snap.__setitem__(n, p.grad.detach().clone()))
    return snap


def time_calls(obj, method: str, into: list, sync) -> None:
    """Wrap ``obj.method`` (on the instance) so each call's wall ms, from
    a device sync before it to one after it, lands in ``into``."""
    inner = getattr(obj, method)

    def timed(*args, **kwargs):
        sync()
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        sync()
        into.append((time.perf_counter() - t) * 1e3)
        return out

    setattr(obj, method, timed)


def bits_equal(xs, ys) -> bool:
    return all(bitwise_equal(x, y) for x, y in zip(xs, ys))


class TrainPart:
    """One part's timed run: step wall, the engine's and the staging's
    counter deltas, peak memory and the flash launches, with the counts
    reset just before the timed steps and read just after."""

    def __init__(self, dev, tokens_per_step):
        self.dev, self.tokens = dev, tokens_per_step
        self.losses, self.walls, self.agree = [], [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, step, n_warmup, n_timed, params, name, before_timed=None,
            after_step=None):
        """``step() -> loss`` n_warmup + n_timed times; after each, whether
        the ranks' ``params`` agree, then ``after_step(i)``."""
        for i in range(n_warmup + n_timed):
            if i == n_warmup:
                self.sync()
                fa.reset_launches()
                self.eng0, self.st0 = get_engine().stats(), staging.stats()
                if before_timed is not None:
                    before_timed()
            self.sync()
            t = time.perf_counter()
            loss = step()
            self.sync()
            if i >= n_warmup:
                self.walls.append((time.perf_counter() - t) * 1e3)
            self.losses.append(loss.item())
            self.agree.append(ranks_agree(params(), f"{name}.agree.{i}"))
            if after_step is not None:
                after_step(i)
        self.launches = dict(fa.launches)
        self.plain = dict(fa.plain_calls)
        self.eng1, self.st1 = get_engine().stats(), staging.stats()

    def report(self, n_layers, **extra) -> dict:
        n = len(self.walls)
        eng = {k: (self.eng1[k] - self.eng0[k]) / n for k in (
            "responses", "tensors", "allreduce_ns", "allreduce_bytes",
            "reducescatter_ns", "reducescatter_bytes", "data_bytes_tx",
            "sharded_steps", "local_sgd_syncs", "sparse_count",
            "wire_int8_count")}
        p50 = statistics.median(self.walls)
        on_card = self.dev.type == "cuda"
        out = {"step_ms": self.walls, "step_ms_p50": p50,
               "step_ms_max": max(self.walls),
               "tokens_per_s_rank": self.tokens / (p50 / 1e3),
               "tokens_per_s_both": ENGINE_RANKS * self.tokens / (p50 / 1e3),
               "losses": self.losses, "ranks_agree": self.agree,
               "peak_mem_gib": torch.cuda.max_memory_allocated(self.dev)
               / 2 ** 30 if on_card else None,
               "engine_per_step": eng,
               "d2h_ms_per_step":
               (self.st1["d2h_ms"] - self.st0["d2h_ms"]) / n,
               "d2h_bytes_per_step":
               (self.st1["d2h_bytes"] - self.st0["d2h_bytes"]) / n,
               "h2d_ms_per_step":
               (self.st1["h2d_ms"] - self.st0["h2d_ms"]) / n,
               "flash_launches_per_step": {k: v / n for k, v in
                                           self.launches.items()},
               "flash_plain_calls": self.plain}
        if on_card:
            check(all(v == n_layers * n for v in self.launches.values())
                  and not any(self.plain.values()),
                  f"engine_train: flash launches {self.launches}, plain "
                  f"calls {self.plain} in {n} steps of {n_layers} layers")
        out.update(extra)
        return out


def train_model(cfg, dev, seed=0):
    """bench_llama's model (``init_params(cfg, seed)``), broadcast from
    rank 0 through the hook-form frontend's engine broadcast."""
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, seed, dev),
                                       attention_fn=fa.flash_attention_fn)
    torch_frontend.broadcast_parameters(model.state_dict(), root_rank=0)
    return model


def masterweights(model):
    return MasterWeights(model.parameters(), torch.optim.AdamW,
                         lr=bench.LLAMA_LR, **bench.LLAMA_ADAMW)


def free_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def part_hook(cfg, batch, dev) -> dict:
    """The hook form over MasterWeights(AdamW): the gradients' allreduces
    enqueued from the backward; ``synchronize()``'s wait after the
    backward ended is timed."""
    model = train_model(cfg, dev)
    opt = torch_frontend.DistributedOptimizer(
        masterweights(model), named_parameters=model.named_parameters())
    part = TrainPart(dev, batch.numel() - batch.shape[0])
    # synchronize()'s wait once the backward has ended on the device.
    waits = []
    time_calls(opt, "synchronize", waits, part.sync)

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, TRAIN_TIMED, model.parameters, "hook",
             before_timed=waits.clear)
    out = part.report(cfg.num_layers, sync_wait_ms=waits,
                      sync_wait_ms_p50=statistics.median(waits))
    del model, opt
    free_memory()

    # Anchor at 2 layers: the hook-form step equals the same gradients
    # through hvd.grouped_allreduce and the same inner step, bit for bit.
    cfg2 = dataclasses.replace(cfg, num_layers=ANCHOR_LAYERS)
    model = train_model(cfg2, dev)
    twin = LlamaModel.from_state_dict(
        cfg2, {k: v.detach().clone() for k, v in model.state_dict().items()},
        attention_fn=fa.flash_attention_fn)
    named = list(model.named_parameters())
    snap = grad_snapshots(named)
    opt = torch_frontend.DistributedOptimizer(masterweights(model),
                                              named_parameters=named)
    ref = masterweights(twin)
    for i in range(2):
        opt.zero_grad()
        bench.llama_loss_fn(model, batch).backward()
        opt.step()
        reduced = hvd.grouped_allreduce([snap[n] for n, _ in named],
                                        name=f"anchor.hook.{i}")
        for p, g in zip(twin.parameters(), reduced):
            p.grad = g
        ref.step()
        check(bits_equal(model.parameters(), twin.parameters())
              and bits_equal(opt.masters, ref.masters),
              f"engine_train hook: step {i} differs from grouped_allreduce "
              "and the same inner step")
    out["anchor"] = {"layers": ANCHOR_LAYERS, "steps": 2, "bitwise": True}
    return out


def part_zero1(cfg, batch, dev) -> dict:
    """ZeRO-1 on the bf16 model: fp32 master shards and AdamW state for
    half the parameters on each rank."""
    model = train_model(cfg, dev)
    opt = torch_frontend.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=bench.LLAMA_LR,
                          **bench.LLAMA_ADAMW), sharded=True)
    part = TrainPart(dev, batch.numel() - batch.shape[0])
    # The step's halves: the engine counts no allgather time.
    rs_ms, ag_ms = [], []
    time_calls(opt.sharder, "reduce_grads", rs_ms, part.sync)
    time_calls(opt.sharder, "gather_updates", ag_ms, part.sync)

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, TRAIN_TIMED, model.parameters, "zero1",
             before_timed=lambda: (rs_ms.clear(), ag_ms.clear()))
    n = sum(p.numel() for p in model.parameters())
    # Unsharded: fp32 masters and AdamW's m and v, 12 bytes a value.
    half = 12 * n / ENGINE_RANKS
    state = opt.state_bytes()
    check(abs(state - half) <= 12 + 4,
          f"engine_train zero1: state_bytes {state} is not half of "
          f"{12 * n}")
    out = part.report(cfg.num_layers, state_bytes=state,
                      unsharded_state_bytes=12 * n,
                      reducescatter_wall_ms=rs_ms, allgather_wall_ms=ag_ms)
    del model, opt
    free_memory()

    # Anchor at 2 layers in fp32 with SGD (tests/sharded_worker.py): the
    # sharded step equals the unsharded flat step, bit for bit.
    cfg2 = dataclasses.replace(cfg, num_layers=ANCHOR_LAYERS,
                               dtype=torch.float32,
                               logits_dtype=torch.float32)
    model = train_model(cfg2, dev)
    params = list(model.parameters())
    opt = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(params, **ANCHOR_SGD), sharded=True)
    flat = torch.nn.Parameter(torch.cat([p.detach().reshape(-1)
                                         for p in params]))
    flat_opt = torch.optim.SGD([flat], **ANCHOR_SGD)
    for i in range(2):
        opt.zero_grad()
        bench.llama_loss_fn(model, batch).backward()
        grads = torch.cat([p.grad.reshape(-1) for p in params])
        opt.step()
        flat.grad = hvd.allreduce(grads, name=f"anchor.zero1.{i}")
        flat_opt.step()
        check(bitwise_equal(torch.cat([p.detach().reshape(-1)
                                       for p in params]), flat.detach()),
              f"engine_train zero1: step {i} differs from the unsharded "
              "flat step")
    out["anchor"] = {"layers": ANCHOR_LAYERS, "dtype": "float32",
                     "steps": 2, "bitwise": True}
    return out


def fsdp_groups(model):
    """One param group per decoder layer, and one for the embedding, the
    final norm and the head: 17 units at bench_llama's depth."""
    rest = [p for n, p in model.named_parameters()
            if not n.startswith("layers.")]
    return ([{"params": rest}]
            + [{"params": list(layer.parameters())}
               for layer in model.layers])


def part_fsdp(cfg, batch, dev) -> dict:
    """FSDP units: each unit's reducescatter fires from the backward's
    hooks; the masters return through the band-0 gather pipeline."""
    from horovod_tpu_torch.runtime.fsdp import fsdp_stats, reset_fsdp_stats

    reset_fsdp_stats()
    model = train_model(cfg, dev)
    opt = torch_frontend.DistributedOptimizer(
        torch.optim.AdamW(fsdp_groups(model), lr=bench.LLAMA_LR,
                          **bench.LLAMA_ADAMW), fsdp=True)
    check(opt.plane.n_units == cfg.num_layers + 1,
          f"engine_train fsdp: {opt.plane.n_units} units")
    part = TrainPart(dev, batch.numel() - batch.shape[0])
    # In step(): the wait for each unit's reducescatter (enqueued from
    # the backward) and each unit's gather.
    wait_ms, gather_ms = [], []
    time_calls(opt.plane, "wait_grads", wait_ms, part.sync)
    time_calls(opt.plane, "gather", gather_ms, part.sync)

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, TRAIN_TIMED, model.parameters, "fsdp",
             before_timed=lambda: (wait_ms.clear(), gather_ms.clear()))
    out = part.report(cfg.num_layers, units=opt.plane.n_units,
                      state_bytes=opt.state_bytes(),
                      rs_wait_ms_per_step=sum(wait_ms) / TRAIN_TIMED,
                      gather_ms_per_step=sum(gather_ms) / TRAIN_TIMED,
                      **fsdp_stats())
    del model, opt
    free_memory()

    # Anchor at 2 layers in fp32 (tests/fsdp_worker.py): the step equals
    # the dense replicated loop (each unit's flat gradient allreduced,
    # the same SGD on the flat vector), bit for bit.
    cfg2 = dataclasses.replace(cfg, num_layers=ANCHOR_LAYERS,
                               dtype=torch.float32,
                               logits_dtype=torch.float32)
    model = train_model(cfg2, dev)
    groups = fsdp_groups(model)
    named = list(model.named_parameters())
    snap = grad_snapshots(named)
    name_of = {id(p): n for n, p in named}
    opt = torch_frontend.DistributedOptimizer(
        torch.optim.SGD(groups, **ANCHOR_SGD), fsdp=True)
    flats = [torch.nn.Parameter(torch.cat([p.detach().reshape(-1)
                                           for p in g["params"]]))
             for g in groups]
    flat_opts = [torch.optim.SGD([f], **ANCHOR_SGD) for f in flats]
    for i in range(2):
        opt.zero_grad()
        bench.llama_loss_fn(model, batch).backward()
        check(all(p.grad is None for p in model.parameters()),
              "engine_train fsdp: a unit's gradients outlived its "
              "reduction")
        opt.step()
        for gi, (g, f, fo) in enumerate(zip(groups, flats, flat_opts)):
            f.grad = hvd.allreduce(torch.cat(
                [snap[name_of[id(p)]].reshape(-1) for p in g["params"]]),
                name=f"anchor.fsdp.{i}.{gi}")
            fo.step()
            check(bitwise_equal(torch.cat([p.detach().reshape(-1)
                                           for p in g["params"]]),
                                f.detach()),
                  f"engine_train fsdp: step {i} unit {gi} differs from "
                  "the dense replicated loop")
    out["anchor"] = {"layers": ANCHOR_LAYERS, "dtype": "float32",
                     "steps": 2, "bitwise": True}
    return out


def part_local_sgd(cfg, batch, dev) -> dict:
    """The hook form with ``local_sgd_steps=4`` over MasterWeights(AdamW):
    8 steps, the ranks' models equal right after steps 4 and 8 only."""
    model = train_model(cfg, dev)
    opt = torch_frontend.DistributedOptimizer(
        masterweights(model), named_parameters=model.named_parameters(),
        local_sgd_steps=LOCAL_SGD_H)
    part = TrainPart(dev, batch.numel() - batch.shape[0])

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, 0, LOCAL_SGD_STEPS, model.parameters, "local_sgd")
    synced = [(i + 1) % LOCAL_SGD_H == 0 for i in range(LOCAL_SGD_STEPS)]
    check(part.agree == synced,
          f"engine_train local_sgd: ranks agree after {part.agree}, want "
          f"{synced}")
    syncs = part.eng1["local_sgd_syncs"] - part.eng0["local_sgd_syncs"]
    check(opt._local_sgd.sync_count == syncs == 2,
          f"engine_train local_sgd: {opt._local_sgd.sync_count} syncs "
          f"({syncs} counted by the engine)")
    out = part.report(cfg.num_layers, syncs=syncs,
                      anchor={"agree_after": synced})
    del model, opt
    free_memory()
    return out


TOPK_RATIO = 0.01
#: Rows the first top-k step holds against the CPU: the embedding, the
#: head, the final norm and every leaf of the first layer (every shape of
#: the model).
TOPK_CHECK = ("tok_emb", "lm_head", "norm_f", "layers.0.")
#: The wire statistics' bound against the CPU's (``runtime/wire_policy``):
#: abs-max exact, the mean of squares within a relative 1e-6.
POLICY_MEAN_RTOL = 1e-6


def topk_checked(name: str) -> bool:
    return name.startswith(TOPK_CHECK)


def topk_first_step_check(named, snap, k_of) -> dict:
    """The first top-k step's local gradients (no residual yet) through
    the port's function on the card and on the CPU: selection, residual
    and output bit for bit, and the output equal to what the hook form
    wrote into ``.grad``.  Both ranks run it (its allgathers are
    collectives).  Returns how many leaves had ties at the k-th
    magnitude, and the largest tie."""
    from horovod_tpu_torch.runtime import sparse

    ties, largest = 0, 0
    for n, p in sorted(named):
        if not topk_checked(n):
            continue
        g = snap[n]
        v = g.float().reshape(-1)
        k = k_of(v.numel())
        sel_d, val_d = sparse.select_topk(v, k)
        sel_c, val_c = sparse.select_topk(v.cpu(), k)
        kth = v.abs()[sel_d[-1]]
        tied = int((v.abs() == kth).sum())
        ties += tied > 1
        largest = max(largest, tied)
        out_d = sparse.sparse_allreduce_topk(g, name=f"chk.dev.{n}",
                                             ratio=TOPK_RATIO)
        out_c = sparse.sparse_allreduce_topk(g.cpu(), name=f"chk.cpu.{n}",
                                             ratio=TOPK_RATIO)
        res_hook = sparse._RESIDUALS[n][1]
        res_d = sparse._RESIDUALS[f"chk.dev.{n}"][1]
        res_c = sparse._RESIDUALS[f"chk.cpu.{n}"][1]
        check(bitwise_equal(sel_d, sel_c) and bitwise_equal(val_d, val_c)
              and bitwise_equal(res_d, res_c)
              and bitwise_equal(res_hook, res_c)
              and bitwise_equal(out_d, out_c)
              and bitwise_equal(p.grad, out_c.to(p.grad.dtype)),
              f"engine_train topk: {n}: the card's selection, residual or "
              "output differs from the CPU's")
        for tag in ("dev", "cpu"):
            sparse.reset_residuals(f"chk.{tag}.{n}")
    return {"leaves_checked": sum(topk_checked(n) for n, _ in named),
            "leaves_with_boundary_ties": ties, "largest_tie": largest}


def part_topk(cfg, batch, dev, hook) -> dict:
    """The hook form over MasterWeights(AdamW) with
    ``Compression.topk(0.01)``: each gradient's k entries through two
    allgathers, in ``synchronize()``; ``hook`` is the hook part's report
    (its D2H bytes a step)."""
    from horovod_tpu_torch.runtime import mpi_ops, sparse

    sparse.reset_residuals()
    model = train_model(cfg, dev)
    named = list(model.named_parameters())
    snap = grad_snapshots(named)
    opt = torch_frontend.DistributedOptimizer(
        masterweights(model), named_parameters=named,
        compression=hvd.Compression.topk(TOPK_RATIO))
    part = TrainPart(dev, batch.numel() - batch.shape[0])
    first = {}

    def k_of(n):
        return max(1, min(n, int(round(n * TOPK_RATIO))))

    def after_step(i):
        if i == 0:
            first.update(topk_first_step_check(named, snap, k_of))

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, TRAIN_TIMED, model.parameters, "topk",
             after_step=after_step)
    out = part.report(cfg.num_layers, first_step_vs_cpu=first)
    per_step = out["engine_per_step"]["sparse_count"]
    check(per_step == len(named),
          f"engine_train topk: {per_step} sparse allreduces a step, want "
          f"{len(named)}")
    if dev.type == "cuda":      # the CPU stages nothing
        ratio = out["d2h_bytes_per_step"] / hook["d2h_bytes_per_step"]
        check(ratio < 0.05, f"engine_train topk: D2H bytes a step are "
              f"{ratio:.4f} of the hook part's")
        out["d2h_bytes_vs_hook"] = ratio
    # One more step, its top-k work split: the selection, the allgathers
    # (staging and wire) and the scatter-add, each between device syncs.
    shares = {"select": [], "gather_enqueue": [], "gather_wait": [],
              "scatter": [], "sparse_allreduce": []}
    originals = {}
    for obj, method, key in ((sparse, "select_topk", "select"),
                             (mpi_ops, "allgather_async", "gather_enqueue"),
                             (mpi_ops, "_drain", "gather_wait"),
                             (sparse, "_add_in_rank_order", "scatter"),
                             (sparse, "sparse_allreduce_topk",
                              "sparse_allreduce")):
        originals[(obj, method)] = getattr(obj, method)
        time_calls(obj, method, shares[key], part.sync)
    part.sync()
    t = time.perf_counter()
    step()
    part.sync()
    wall = (time.perf_counter() - t) * 1e3
    for (obj, method), fn in originals.items():
        setattr(obj, method, fn)
    out["split_step"] = {"step_ms": wall, **{
        f"{k}_ms": sum(v) for k, v in shares.items()},
        "calls": {k: len(v) for k, v in shares.items()}}
    del model, opt, snap, named
    free_memory()

    # Anchor at 2 layers: the hook-form step equals hvd.allreduce(topk) of
    # the same gradient snapshots, in name order, and the same inner step.
    sparse.reset_residuals()
    cfg2 = dataclasses.replace(cfg, num_layers=ANCHOR_LAYERS)
    model = train_model(cfg2, dev)
    twin = LlamaModel.from_state_dict(
        cfg2, {k: v.detach().clone() for k, v in model.state_dict().items()},
        attention_fn=fa.flash_attention_fn)
    named = list(model.named_parameters())
    snap = grad_snapshots(named)
    opt = torch_frontend.DistributedOptimizer(
        masterweights(model), named_parameters=named,
        compression=hvd.Compression.topk(TOPK_RATIO))
    ref = masterweights(twin)
    twin_params = dict(twin.named_parameters())
    for i in range(2):
        opt.zero_grad()
        bench.llama_loss_fn(model, batch).backward()
        opt.step()
        for n, _ in sorted(named):
            twin_params[n].grad = hvd.allreduce(
                snap[n], name=f"anchor.topk.{n}",
                compression=hvd.Compression.topk(TOPK_RATIO))
        ref.step()
        check(bits_equal(model.parameters(), twin.parameters())
              and bits_equal(opt.masters, ref.masters),
              f"engine_train topk: step {i} differs from hvd.allreduce(topk)"
              " of the same gradients and the same inner step")
    out["anchor"] = {"layers": ANCHOR_LAYERS, "steps": 2, "bitwise": True}
    sparse.reset_residuals()
    return out


def part_local_sgd_topk(cfg, batch, dev) -> dict:
    """The hook form with ``local_sgd_steps=4`` and
    ``Compression.topk(0.01)`` over MasterWeights(AdamW): each sync ships
    every master's delta as its k largest entries."""
    from horovod_tpu_torch.runtime import sparse

    sparse.reset_residuals()
    model = train_model(cfg, dev)
    opt = torch_frontend.DistributedOptimizer(
        masterweights(model), named_parameters=model.named_parameters(),
        local_sgd_steps=LOCAL_SGD_H,
        compression=hvd.Compression.topk(TOPK_RATIO))
    part = TrainPart(dev, batch.numel() - batch.shape[0])

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, 0, LOCAL_SGD_STEPS, model.parameters, "local_sgd_topk")
    synced = [(i + 1) % LOCAL_SGD_H == 0 for i in range(LOCAL_SGD_STEPS)]
    check(part.agree == synced,
          f"engine_train local_sgd_topk: ranks agree after {part.agree}, "
          f"want {synced}")
    syncs = part.eng1["local_sgd_syncs"] - part.eng0["local_sgd_syncs"]
    sparse_n = part.eng1["sparse_count"] - part.eng0["sparse_count"]
    leaves = len(opt.masters)
    check(opt._local_sgd.sync_count == syncs == 2
          and sparse_n == 2 * leaves,
          f"engine_train local_sgd_topk: {opt._local_sgd.sync_count} syncs "
          f"({syncs} counted by the engine), {sparse_n} sparse allreduces "
          f"for {leaves} leaves")
    out = part.report(cfg.num_layers, syncs=syncs, sparse_per_sync=leaves,
                      anchor={"agree_after": synced})
    del model, opt
    sparse.reset_residuals()
    free_memory()
    return out


def part_policy(cfg, batch, dev) -> dict:
    """``HOROVOD_WIRE_POLICY=1``: the hook form over AdamW on an fp32 copy
    of the model (the policy acts on fp32 gradients only; the fp32 flash
    kernels run).  Each step, the local gradients' statistics on the card
    and on the CPU feed two shadow policies that must decide alike."""
    from horovod_tpu_torch.runtime import wire_policy as wp

    os.environ["HOROVOD_WIRE_POLICY"] = "1"
    wp.reset_default_policy()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                logits_dtype=torch.float32)
    try:
        model = train_model(cfg32, dev)
        named = list(model.named_parameters())
        snap = grad_snapshots(named)
        opt = torch_frontend.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=bench.LLAMA_LR,
                              **bench.LLAMA_ADAMW), named_parameters=named)
    finally:
        del os.environ["HOROVOD_WIRE_POLICY"]
    policy = opt._wire_policy
    check(policy is wp.default_policy(), "engine_train policy: no policy")
    shadow = {"dev": wp.WirePolicy(), "cpu": wp.WirePolicy()}
    worst = {"abs_max": 0.0, "mean_square_rel": 0.0}

    def after_step(i):
        names = [n for n, _ in named]
        grads = [snap[n] for n in names]
        need = [policy.needs_statistics(g) for g in grads]
        dev_stats = wp.leaf_statistics([g for g, x in zip(grads, need) if x])
        cpu_stats = wp.leaf_statistics([g.cpu() for g, x in zip(grads, need)
                                        if x])
        for (ad, md), (ac, mc) in zip(dev_stats, cpu_stats):
            worst["abs_max"] = max(worst["abs_max"], abs(ad - ac))
            worst["mean_square_rel"] = max(worst["mean_square_rel"],
                                           abs(md - mc) / max(mc, 1e-45))
        decided = {k: shadow[k].observe_and_choose_many(
            names, [g if k == "dev" else g.cpu() for g in grads])
            for k in shadow}
        check(decided["dev"] == decided["cpu"]
              and shadow["dev"].decisions == policy.decisions,
              f"engine_train policy: step {i}: the card's and the CPU's "
              "statistics decide differently")

    part = TrainPart(dev, batch.numel() - batch.shape[0])

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, TRAIN_TIMED, model.parameters, "policy",
             after_step=after_step)
    check(worst["abs_max"] == 0.0
          and worst["mean_square_rel"] <= POLICY_MEAN_RTOL,
          f"engine_train policy: statistics off the CPU's by {worst}")
    shapes = {n: p.dim() for n, p in named}
    int8 = sorted(n for n, w in policy.decisions.items() if w == "int8")
    fp32 = sorted(n for n, w in policy.decisions.items() if w == "fp32")
    check(all(policy.decisions[n] == "fp32" for n, d in shapes.items()
              if d <= 1), "engine_train policy: a 0/1-D leaf left fp32")
    grew = part.eng1["wire_int8_count"] - part.eng0["wire_int8_count"]
    check(int8 and grew > 0,
          f"engine_train policy: {len(int8)} int8 leaves, "
          f"wire_int8_count grew by {grew}")
    out = part.report(cfg.num_layers, dtype="float32", int8_leaves=int8,
                      fp32_leaves=fp32,
                      default_leaves=sorted(n for n, w in
                                            policy.decisions.items()
                                            if w is None),
                      statistics_vs_cpu=worst)
    del model, opt, snap
    wp.reset_default_policy()
    free_memory()
    return out


def rank_batch(cfg, rank: int, size: int, dev) -> torch.Tensor:
    """This rank's rows of the bench's ``default_rng(0)`` batch of 8
    sequences of 2048 (+1) tokens (fewer where ``cfg`` is shorter)."""
    rows = 8 // size
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2049 if cfg.max_seq_len >= 2048
                            else cfg.max_seq_len + 1), dtype=np.int32)
    return torch.from_numpy(tokens[rank * rows:(rank + 1) * rows]).long() \
        .to(dev)


#: engine_train's parts in two worlds of two ranks that run side by side
#: (``topk`` reads the ``hook`` part's report, so they share a world).
ENGINE_TRAIN_WORLDS = (("hook", "topk", "local_sgd_topk"),
                       ("zero1", "fsdp", "local_sgd", "policy"))


def train_worker(rank: int, device: str, cfg=None, names=None) -> dict:
    """One rank of the engine_train phase: bench_llama's model (``cfg``,
    default ``bench.llama_config()`` at ENGINE_TRAIN_LAYERS) at B 4 x S
    2048, this rank's 4 rows
    of the bench's ``default_rng(0)`` batch of 8, through the parts
    ``names`` (default all, in order).  Each part's failed check raises."""
    hvd.init(device=device)
    dev = hvd.device()
    cfg = cfg or dataclasses.replace(bench.llama_config(),
                                     num_layers=ENGINE_TRAIN_LAYERS)
    batch = rank_batch(cfg, rank, hvd.size(), dev)
    out = {"rank": hvd.rank(), "size": hvd.size(), "device": str(dev),
           "batch": list(batch.shape), "layers": cfg.num_layers}
    t0 = time.monotonic()
    parts = (("hook", part_hook), ("zero1", part_zero1),
             ("fsdp", part_fsdp), ("local_sgd", part_local_sgd),
             ("topk", lambda *a: part_topk(*a, hook=out["hook"])),
             ("local_sgd_topk", part_local_sgd_topk),
             ("policy", part_policy))
    for name, part in parts:
        if names is not None and name not in names:
            continue
        t = time.monotonic()
        out[name] = part(cfg, batch, dev)
        out[name]["part_s"] = time.monotonic() - t
        # The optimizers' hooks hold their optimizer in a reference cycle
        # with the parameters: collect a part's models before the next.
        free_memory()
        losses = out[name]["losses"]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"engine_train {name}: the loss did not fall: {losses}")
        if not name.startswith("local_sgd"):
            check(all(out[name]["ranks_agree"]),
                  f"engine_train {name}: ranks' parameters differ: "
                  f"{out[name]['ranks_agree']}")
    out["wall_s"] = time.monotonic() - t0
    hvd.shutdown()
    return out


def phase_engine_train():
    """bench_llama's model trained by the engine-driven optimizers, on two
    ranks of the eager engine on the one card: the hook form, ZeRO-1,
    FSDP units, local SGD and the sparse plane, in two worlds of two ranks
    side by side (ENGINE_TRAIN_WORLDS).  Prints one line per part."""
    t0 = time.monotonic()
    worlds = side_by_side(*(
        functools.partial(run_ranks, "--train-worker", "engine_train",
                          TRAIN_RANKS_TIMEOUT_S,
                          extra=("--train-parts", ",".join(names)))
        for names in ENGINE_TRAIN_WORLDS))
    smi = smi_now()
    for part in ("hook", "zero1", "fsdp", "local_sgd", "topk",
                 "local_sgd_topk", "policy"):
        world = next(i for i, names in enumerate(ENGINE_TRAIN_WORLDS)
                     if part in names)
        results = worlds[world]
        emit("engine_train", part=part, ranks=ENGINE_RANKS, world=world,
             layers=results[0]["layers"], batch_per_rank=results[0]["batch"],
             per_rank=[r[part] for r in results], nvidia_smi_after=smi)
    emit("engine_train", part="phase", wall_s=time.monotonic() - t0,
         worker_wall_s=[[r["wall_s"] for r in w] for w in worlds])


# ---------------------------------------------------------------------------
# phase 12: the expert-parallel MoE layer over the engine's variable-split
# alltoall, two ranks on the one card
# ---------------------------------------------------------------------------

MOE_TIMEOUT_S = 300
#: bench_llama's widths: d_model 1024, FFN 4096; 8 experts, top-2, GShard's
#: capacity factor; 16 384 tokens (8 192 a rank).
MOE_TOKENS, MOE_D, MOE_H = 16384, 1024, 4096
MOE_EXPERTS, MOE_TOPK, MOE_CF = 8, 2, 1.25
MOE_STEPS, MOE_LR = 3, 0.1


def moe_batch(dev):
    """Seeded tokens and a learnable target (a fixed linear map of them),
    made on the card, the same on every rank."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(MOE_TOKENS, MOE_D, device=dev, generator=gen)
    a = torch.randn(MOE_D, MOE_D, device=dev, generator=gen) \
        * (0.5 / math.sqrt(MOE_D))
    return x, x @ a


def moe_worker(rank: int, device: str) -> dict:
    """One rank of engine_moe: 3 steps of forward, backward and
    ``apply_grads`` of its shard, each held bit for bit against the
    world-of-one layer on the whole batch (which every rank runs, so that
    each checks its own rows and experts)."""
    from horovod_tpu_torch.runtime import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=device)
    dev, size = hvd.device(), hvd.size()
    x, tgt = moe_batch(dev)
    rows = MOE_TOKENS // size
    sh = slice(rank * rows, (rank + 1) * rows)
    kw = dict(n_experts=MOE_EXPERTS, topk=MOE_TOPK, capacity_factor=MOE_CF,
              seed=0)
    moe.reset_moe_stats()
    lay = moe.MoeLayer(MOE_D, MOE_H, **kw)
    ref = moe.MoeLayer(MOE_D, MOE_H, world=(0, 1), **kw)
    check(lay.device == dev and lay.size == size == ENGINE_RANKS,
          f"engine_moe: layer on {lay.device} at size {lay.size}")
    lo, epr = lay.expert_lo, lay.experts_per_rank
    a2a, inner = {}, lay._alltoall

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(payload, splits, tag):
        sync()
        t = time.perf_counter()
        out = inner(payload, splits, tag)
        sync()
        a2a.setdefault(tag, []).append((time.perf_counter() - t) * 1e3)
        return out

    lay._alltoall = timed
    eng = get_engine()
    s0 = eng.stats()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(MOE_STEPS):
        sync()
        t0 = time.perf_counter()
        d0 = eng.stats()["moe_tokens_dropped"]
        y, c = lay.forward(x[sh])
        sync()
        t1 = time.perf_counter()
        d1 = eng.stats()["moe_tokens_dropped"]
        dx = lay.backward((y - tgt[sh]) / MOE_TOKENS, c)
        sync()
        t2 = time.perf_counter()
        yr, cr = ref.forward(x)
        dxr = ref.backward((yr - tgt) / MOE_TOKENS, cr)
        block = int(((~cr["kept"]) & (cr["local_e"] >= lo)
                     & (cr["local_e"] < lo + epr)).sum())
        check(bitwise_equal(y, yr[sh]) and bitwise_equal(dx, dxr[sh])
              and bitwise_equal(lay.g_wg, ref.g_wg)
              and all(bitwise_equal(getattr(lay, g),
                                    getattr(ref, g)[lo:lo + epr])
                      for g in ("g_w1", "g_b1", "g_w2", "g_b2")),
              f"engine_moe: step {i}: rank {rank}'s y, dx or grads differ "
              "from the world-of-one layer's")
        check(c["dropped"] == block == d1 - d0,
              f"engine_moe: step {i}: {c['dropped']} dropped, the world of "
              f"one drops {block} of this rank's experts, the engine counted "
              f"{d1 - d0}")
        sync()
        t3 = time.perf_counter()
        lay.apply_grads(MOE_LR)
        sync()
        t4 = time.perf_counter()
        ref.apply_grads(MOE_LR)
        check(bitwise_equal(lay.wg, ref.wg)
              and all(bitwise_equal(p, q[lo:lo + epr]) for p, q in
                      zip(lay.expert_params(), ref.expert_params())),
              f"engine_moe: step {i}: updated parameters differ")
        steps.append({"forward_ms": (t1 - t0) * 1e3,
                      "backward_ms": (t2 - t1) * 1e3,
                      "apply_ms": (t4 - t3) * 1e3,
                      "dropped": c["dropped"],
                      "dropped_world_of_one": cr["dropped"],
                      "loss_sum": float(((y - tgt[sh]) ** 2).sum())})
    s1 = eng.stats()
    out = {"rank": rank, "tokens": rows, "capacity": moe.moe_capacity(
        MOE_TOKENS, MOE_EXPERTS, MOE_TOPK, MOE_CF),
        "experts_owned": [lo, lo + epr], "steps": steps,
        "step_ms": [st["forward_ms"] + st["backward_ms"] + st["apply_ms"]
                    for st in steps],
        "alltoall_ms": a2a,
        "alltoall_bytes_per_step": (s1["alltoall_bytes"]
                                    - s0["alltoall_bytes"]) / MOE_STEPS,
        "alltoall_ns_per_step": (s1["alltoall_ns"] - s0["alltoall_ns"])
        / MOE_STEPS,
        "moe_dispatches": s1["moe_dispatches"],
        "moe_experts": s1["moe_experts"],
        "moe_capacity_factor": s1["moe_capacity_factor"],
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if on_card else None,
        "bitwise_vs_world_of_one": True}
    hvd.shutdown()
    return out


def phase_engine_moe():
    """The MoE layer at bench_llama's widths on two ranks of the engine on
    the one card (``--moe-worker RANK``)."""
    t0 = time.monotonic()
    results = run_ranks("--moe-worker", "engine_moe", MOE_TIMEOUT_S)
    drops = [[r["steps"][i]["dropped"] for r in results]
             for i in range(MOE_STEPS)]
    check(all(sum(d) == results[0]["steps"][i]["dropped_world_of_one"]
              for i, d in enumerate(drops)),
          f"engine_moe: drops {drops} do not sum to the world of one's")
    emit("engine_moe", ranks=ENGINE_RANKS, tokens=MOE_TOKENS,
         d_model=MOE_D, d_hidden=MOE_H, experts=MOE_EXPERTS, topk=MOE_TOPK,
         capacity_factor=MOE_CF, per_rank=results,
         wall_s=time.monotonic() - t0, nvidia_smi_after=smi_now())


# ---------------------------------------------------------------------------
# phase 13: MoE in the model at Mixtral-8x7B's widths, through
# make_parallel_train_step on a mesh of one
# ---------------------------------------------------------------------------

#: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
#: config.json), depth cut 32 -> 2; seeded weights.
MIXTRAL_LAYERS = 2
MIXTRAL_CFG = LlamaConfig(vocab_size=32000, hidden_size=4096,
                          num_layers=MIXTRAL_LAYERS, num_heads=32,
                          num_kv_heads=8, intermediate_size=14336,
                          max_seq_len=32768, rope_theta=1e6, rms_eps=1e-5,
                          num_experts=8, experts_per_token=2)
MOE_B, MOE_S = 1, 4096
#: The routed MoE block against the dense masked einsum (the reference's
#: dispatch) on the same bf16 tensors: the same products per routed row in
#: other GEMM shapes.  Measured on the H100 at these shapes: y bitwise,
#: the gradients at most 1.6e-4 relative L2 (PERF.md); the bound is about
#: 10x that, so a fault on a small share of the routed rows shows.
MOE_ORACLE_REL_L2_TOL = 2e-3


def moe_dense_oracle(moe, x):
    """The reference's ``MoEBlock`` body in torch: every expert on a masked
    copy of every token (``einsum("bsh,bse->ebsh")``), then the combine."""
    combine = moe.route(x)
    sel = (combine != 0).to(x.dtype)
    xe = torch.einsum("bsh,bse->ebsh", x, sel)
    gate, up = torch.chunk(torch.einsum("ebsh,ehf->ebsf", xe,
                                        moe.w_gate_up), 2, dim=-1)
    ye = torch.einsum("ebsf,efh->ebsh", gate * torch.sigmoid(gate) * up,
                      moe.w_down)
    return torch.einsum("ebsh,bse->bsh", ye, combine)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp(min=1e-30))


def phase_moe_oracle(model, dev, seed):
    """Layer 0's MoE block, routed, against the dense masked einsum on the
    same CUDA tensors: output and the gradients of x, the router and both
    expert weights, for a seeded x [1, 4096, 4096] and cotangent."""
    moe = model.layers[0].moe
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    x0 = torch.randn(MOE_B, MOE_S, MIXTRAL_CFG.hidden_size, device=dev,
                     generator=gen).to(MIXTRAL_CFG.dtype)
    cot = torch.randn(x0.shape, device=dev, generator=gen).to(x0.dtype)
    params = [moe.router.weight, moe.w_gate_up, moe.w_down]
    runs = {}
    for name, fn in (("routed", moe), ("dense", lambda x: moe_dense_oracle(
            moe, x))):
        x = x0.clone().requires_grad_(True)
        y = fn(x)
        grads = torch.autograd.grad(y, [x] + params, cot)
        runs[name] = [y.detach()] + [g.detach() for g in grads]
        del y, grads, x
        torch.cuda.empty_cache()
    names = ("y", "dx", "d_router", "d_w_gate_up", "d_w_down")
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, runs["routed"],
                                                runs["dense"])}
    counts = (moe.route(x0) != 0).sum(dim=(0, 1)).tolist()
    emit("moe_oracle", tokens=MOE_B * MOE_S, rel_l2=errs,
         tol=MOE_ORACLE_REL_L2_TOL, expert_tokens=counts)
    for n, e in errs.items():
        check(math.isfinite(e) and e <= MOE_ORACLE_REL_L2_TOL,
              f"moe_oracle: {n} rel L2 {e} > {MOE_ORACLE_REL_L2_TOL}")
    del runs
    torch.cuda.empty_cache()


def moe_flops_per_step(cfg, batch, seq) -> int:
    """``bench.llama_flops_per_step`` over the ACTIVE parameters: the
    attention, the router and top-k experts' SwiGLU a token (k x F), plus
    the head; and 3 x the causal attention forward."""
    active = dataclasses.replace(
        cfg, intermediate_size=cfg.experts_per_token * cfg.intermediate_size)
    return (bench.llama_flops_per_step(active, batch, seq)
            + 6 * cfg.num_layers * cfg.hidden_size * cfg.num_experts
            * batch * seq)


def expert_token_counts(model, tokens):
    """Tokens routed to each expert, per layer, for ``tokens``' inputs
    (one no-grad forward)."""
    counts = []

    def hook(mod, args, _out):
        counts.append((mod.route(args[0]) != 0).sum(dim=(0, 1)).tolist())
    handles = [layer.moe.register_forward_hook(hook)
               for layer in model.layers]
    with torch.no_grad():
        model(tokens[:, :-1])
    for h in handles:
        h.remove()
    return counts


def moe_factory(seed):
    """A profile's ``build`` for train_moe: model, optimizer and step."""
    def build():
        model = build_model(MIXTRAL_CFG, seed, fa.flash_attention_fn)
        opt, step = make_moe_step(model)
        return model, opt, step
    return build


def make_moe_step(model):
    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=1e-4))
    mesh = build_mesh({"data": 1, "fsdp": 1, "expert": 1, "tensor": 1})
    return opt, make_parallel_train_step(model, opt, mesh)


def phase_train_moe(dev, seed):
    """Mixtral-8x7B's widths at depth 2 trained through
    ``make_parallel_train_step`` on a mesh whose axes are all 1: bf16,
    ``MasterWeights(AdamW 3e-4)``, flash attention, B 1 x S 4096; the MoE
    oracle first, then 3 warm-up and 10 timed steps.  Returns the flash
    launches and the batch (for the profile)."""
    cfg = MIXTRAL_CFG
    hvd.init()
    t0 = time.monotonic()
    model = build_model(cfg, seed, fa.flash_attention_fn)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 5)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_B, MOE_S + 1))).to(dev)
    phase_moe_oracle(model, dev, seed)
    opt, step = make_moe_step(model)
    fallbacks = fa.fallback_count()
    losses, step_ms, launches, plain_calls, _, _ = timed_steps(step, tokens,
                                                               dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    counts = expert_token_counts(model, tokens)
    p50 = statistics.median(step_ms)
    flops = moe_flops_per_step(cfg, MOE_B, MOE_S)
    emit("train_moe", model="mixtral_8x7b", layers=cfg.num_layers,
         layers_published=32, hidden=cfg.hidden_size, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, ffn=cfg.intermediate_size,
         vocab=cfg.vocab_size, experts=cfg.num_experts,
         experts_per_token=cfg.experts_per_token, rope_theta=cfg.rope_theta,
         batch=MOE_B, seq=MOE_S, params=n_params,
         optimizer="make_parallel_train_step(DistributedOptimizer("
                   "MasterWeights(AdamW lr 3e-4)))",
         warmup_steps=WARMUP_STEPS, steps=TIMED_STEPS, step_ms_p50=p50,
         step_ms_max=max(step_ms), step_ms=step_ms,
         tokens_per_s=MOE_B * MOE_S / (p50 / 1e3), flops_per_step=flops,
         mfu=flops / (p50 / 1e3) / 989e12,
         mfu_formula="(6 x (attention + router + top-2 experts' SwiGLU per "
                     "layer + head) x tokens + 3 x causal attention forward)"
                     " / (step s x 989e12)",
         peak_mem_gib=peak, losses=losses, expert_tokens=counts,
         kernel_launches=launches, plain_calls=plain_calls,
         fallbacks=fa.fallback_count() - fallbacks, init_s=init_s,
         nvidia_smi_after=smi_now())
    check_training("train_moe", losses, launches,
                   dict.fromkeys(launches, cfg.num_layers * TIMED_STEPS),
                   plain_calls)
    check(fa.fallback_count() == fallbacks, "train_moe: a fallback ran")
    del model, opt, step
    return launches, tokens


# ---------------------------------------------------------------------------
# phase 14: the parallelism families on two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

PARALLEL_TIMEOUT_S = 900
PARALLEL_PARTS = ("tensor", "expert", "seq_ring", "seq_ulysses", "pipe")
PAR_B, PAR_S, PAR_STEPS, PAR_LR = 2, 2048, 3, 0.05
#: fp32 throughout; a part differs from the world of one by the order of
#: its sums (partial products summed over ranks, hops merged by lse), so
#: by fp32 roundings.  The loss is held relative to itself; each parameter
#: leaf by ||p - p_one|| / ||p_one - p0||, its error relative to the world
#: of one's own update of it, so a leaf a part steps wrongly or not at all
#: shows however small the step.
PAR_LOSS_RTOL, PAR_PARAM_REL = 1e-4, 1e-3


def parallel_cfg(part):
    """``bench_llama``'s widths at 2 layers, fp32; the expert part with 8
    experts, top-2."""
    return dataclasses.replace(
        bench.llama_config(), num_layers=2, dtype=torch.float32,
        logits_dtype=torch.float32,
        num_experts=8 if part == "expert" else 1)


def world_of_one(cfg, seed, tokens):
    """The plain model's SGD steps on this rank alone (the flash kernels):
    (losses, state dict after the steps, {leaf: (||update||, max |update|)}
    for the steps' update of each leaf)."""
    model = LlamaModel.from_state_dict(
        cfg, init_params(cfg, seed, tokens.device),
        attention_fn=fa.flash_attention_fn)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
    losses = []
    for _ in range(PAR_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    update = {k: (float((v - start[k]).norm()),
                  float((v - start[k]).abs().max())) for k, v in state.items()}
    return losses, state, update


def parallel_part(part, cfg, seed, tokens):
    """One family's steps: (losses, {name: whole parameter}, step ms,
    flash launches, comm counters a step)."""
    from horovod_tpu_torch.parallel.pipeline import (
        init_pipelined_llama, make_pipelined_llama_train_step)
    from horovod_tpu_torch.parallel.placement import full_state_dict
    from horovod_tpu_torch.parallel.seq import (
        make_context_parallel_train_step)

    axis = {"tensor": "tensor", "expert": "expert", "pipe": "pipe"}.get(
        part, "seq")
    mesh = build_mesh({axis: hvd.size()})
    state = init_params(cfg, seed, tokens.device)
    if part == "pipe":
        model = init_pipelined_llama(cfg, state, 2,
                                     mesh=mesh,
                                     attention_fn=fa.flash_attention_fn)
        opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
        run = make_pipelined_llama_train_step(cfg, opt, mesh,
                                              n_microbatches=2)
    else:
        model = LlamaModel.from_state_dict(cfg, state,
                                           attention_fn=fa.flash_attention_fn)
        if part.startswith("seq"):
            opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
            run = make_context_parallel_train_step(
                cfg, opt, mesh, attention=part[len("seq_"):])
        else:
            shard_params(model, mesh)
            opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
            gspmd = make_parallel_train_step(model, opt, mesh)

            def run(_model, _inputs, _targets):
                return gspmd(tokens)
    fa.reset_launches()
    comm.reset_stats()
    losses, step_ms = [], []
    for _ in range(PAR_STEPS):
        t = time.perf_counter()
        loss = float(run(model, tokens[:, :-1], tokens[:, 1:]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
    per_step = {k: v / PAR_STEPS for k, v in comm.stats.items()}
    # The kernels on the card; their plain versions on a CPU rehearsal.
    launches = dict(fa.launches if tokens.is_cuda else fa.plain_calls)
    if part == "pipe":
        params = {model.global_name(n): p.detach()
                  for n, p in model.named_parameters()}
    elif part.startswith("seq"):
        params = {n: p.detach() for n, p in model.named_parameters()}
    else:
        params = full_state_dict(model)
    return losses, params, step_ms, launches, per_step


# ---------------------------------------------------------------------------
# collectives: the device plane (ops/collective_ops.py), the collectives a
# loss function calls inside the step; in the parallel phase's two gloo
# ranks and in this process's NCCL world of one
# ---------------------------------------------------------------------------

COLL_ITERS = 5
#: bench_llama's activations a rank: B 4 x S 2048 rows of hidden 1024.
COLL_ACT_SHAPE = (4 * 2048, 1024)
#: engine_moe's dispatch buffer: 16 384 tokens of hidden 1024.
COLL_A2A_SHAPE = (16384, 1024)
#: Each ReduceOp's input: 1 Mi values.
COLL_OP_VALUES = 1 << 20


def host_sum(xs):
    """The ranks' tensors summed in rank order, in fp32 for a half type,
    rounded once: the device plane's arithmetic, on the host."""
    acc = (torch.float32 if xs[0].dtype in (torch.float16, torch.bfloat16)
           else xs[0].dtype)
    out = xs[0].to(acc)
    for x in xs[1:]:
        out = out + x.to(acc)
    return out.to(xs[0].dtype)


def coll_inputs(seed, dtype, shape, size):
    """Every rank's seeded input, made on the host (rank r's from seed +
    r): fp32 or bf16 normals, int32 in [-1000, 1000), int64 as
    ``host_input``'s."""
    out = []
    for r in range(size):
        gen = torch.Generator().manual_seed(seed + r)
        if dtype in (torch.int32, torch.int64):
            out.append(torch.randint(-1000, 1000, shape, generator=gen,
                                     dtype=dtype))
        else:
            out.append(torch.randn(shape, generator=gen).to(dtype))
    return out


def coll_call(name, fn, want, dev, size, into: dict) -> None:
    """``fn()`` on the card, its result (a tensor or a list) bitwise
    ``want`` and on ``dev``; then ``COLL_ITERS`` timed calls: wall ms p50
    and max, and ``comm``'s counters a call; a digest of the result, which
    ranks holding the same result compare."""
    got = fn()
    got_l = got if isinstance(got, (list, tuple)) else [got]
    want_l = want if isinstance(want, (list, tuple)) else [want]
    check(len(got_l) == len(want_l) and all(
        a.device == dev and bitwise_equal(a, b)
        for a, b in zip(got_l, want_l)),
        f"collectives: {name} at world {size} differs from the host's "
        "arithmetic")
    digest = hashlib.sha1()
    for t in got_l:
        digest.update(t.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    del got, got_l
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    comm.reset_stats()
    walls = []
    for _ in range(COLL_ITERS):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    into[name] = dict(p50_ms=statistics.median(walls), max_ms=max(walls),
                      wire_bytes=comm.stats["wire_bytes"] / COLL_ITERS,
                      staged_bytes=comm.stats["staged_bytes"] / COLL_ITERS,
                      calls=comm.stats["calls"] / COLL_ITERS,
                      digest=digest.hexdigest(), bitwise_vs_host=True)


def collectives_checks(dev, rank: int, size: int) -> dict:
    """Every device-plane collective at the sizes of the models the repo
    runs, on ``dev``, through the frontend's names in the context
    ``make_train_step`` gives its loss function (the default group, the
    step's data axis): each result bitwise the host's arithmetic on every
    rank's host copy; per call, wall ms p50 and max, wire and staged
    bytes, calls.  Any failed check raises; no engine response may run,
    and nothing falls back to the CPU."""
    from horovod_tpu_torch.ops import collective_ops as cops
    from horovod_tpu_torch.runtime import engine_or_none

    eng = engine_or_none()
    responses = eng.stats()["responses"] if eng is not None else 0
    with cops.in_step(comm.world_axis()):
        out = _collectives_calls(dev, rank, size, cops)
    return out


def _collectives_calls(dev, rank: int, size: int, cops) -> dict:
    out = {}
    root = 1 % size

    def call(name, fn, want):
        coll_call(name, fn, want, dev, size, out)

    # ResNet-50's 161 fp32 gradients, averaged in fused buckets.
    shapes = [p.shape for p in ResNet(ResNetConfig.resnet50(),
                                      device="meta").parameters()]
    per_rank = [coll_inputs(100 + 10 * i, torch.float32, sh, size)
                for i, sh in enumerate(shapes)]
    grads = [xs[rank].to(dev) for xs in per_rank]
    want = [host_sum(xs) / size for xs in per_rank]
    del per_rank
    check(len(grads) == 161 and sum(g.numel() for g in grads)
          == 25_557_032, "collectives: ResNet-50's gradient set")
    call("grouped_allreduce_rn50", lambda: hvd.grouped_allreduce(grads),
         want)
    out["grouped_allreduce_rn50"]["bytes"] = 4 * 25_557_032
    del grads, want
    # bench_llama's activations: allgather and reducescatter, axes 0, 1.
    xs = coll_inputs(200, torch.bfloat16, COLL_ACT_SHAPE, size)
    x = xs[rank].to(dev)
    total = host_sum(xs)
    for ax in (0, 1):
        call(f"allgather_act_ax{ax}",
             lambda ax=ax: hvd.allgather(x, axis=ax), torch.cat(xs, ax))
        call(f"reducescatter_act_ax{ax}",
             lambda ax=ax: hvd.reducescatter(x, scatter_axis=ax),
             torch.chunk(total, size, ax)[rank])
    # engine_moe's dispatch buffer through the all-to-all.
    xs = coll_inputs(300, torch.bfloat16, COLL_A2A_SHAPE, size)
    x = xs[rank].to(dev)
    call("alltoall_moe", lambda: hvd.alltoall(x),
         torch.cat([torch.chunk(xs[j], size, 0)[rank]
                    for j in range(size)]))
    # The backward of allgather (a reduce-scatter of the cotangents) and
    # of alltoall (the inverse exchange), bf16, forward and backward a call.
    xs = coll_inputs(400, torch.bfloat16, COLL_ACT_SHAPE, size)
    cots = coll_inputs(500, torch.bfloat16,
                       (size * COLL_ACT_SHAPE[0], COLL_ACT_SHAPE[1]), size)
    x, cot = xs[rank].to(dev), cots[rank].to(dev)

    def gather_grad():
        leaf = x.detach().requires_grad_(True)
        hvd.allgather(leaf).backward(cot)
        return leaf.grad
    call("allgather_backward", gather_grad,
         torch.chunk(host_sum(cots), size, 0)[rank])
    cots = coll_inputs(600, torch.bfloat16, COLL_ACT_SHAPE, size)
    cot = cots[rank].to(dev)

    def a2a_grad():
        leaf = x.detach().requires_grad_(True)
        hvd.alltoall(leaf).backward(cot)
        return leaf.grad
    call("alltoall_backward", a2a_grad,
         torch.cat([torch.chunk(cots[j], size, 0)[rank]
                    for j in range(size)]))
    del xs, cots, x, cot
    # broadcast from rank 1 (rank 0 at a world of one).
    for dtype in (torch.bfloat16, torch.int64):
        xs = coll_inputs(700, dtype, COLL_ACT_SHAPE, size)
        x = xs[rank].to(dev)
        call(f"broadcast_{str(dtype)[6:]}",
             lambda x=x: hvd.broadcast(x, root), xs[root])
    # every ReduceOp on fp32 and int32.
    for dtype in (torch.float32, torch.int32):
        xs = coll_inputs(800, dtype, (COLL_OP_VALUES,), size)
        x = xs[rank].to(dev)
        prod = xs[0]
        for y in xs[1:]:
            prod = prod * y
        wants = {cops.Sum: host_sum(xs), cops.Average: host_sum(xs) / size,
                 cops.Min: torch.stack(xs).amin(0),
                 cops.Max: torch.stack(xs).amax(0), cops.Product: prod}
        for op, w in wants.items():
            call(f"allreduce_{op.value}_{str(dtype)[6:]}",
                 lambda op=op, x=x: hvd.allreduce(x, op=op), w)
    return out


def collectives_train(cfg, seed, tokens, ref) -> dict:
    """``hvd.make_train_step`` of the model (``parallel_cfg``) whose loss
    gathers every rank's mean token loss through ``hvd.allgather`` (the
    device plane; its backward a reduce-scatter) and averages them: each
    rank steps its rows of ``tokens``, 3 SGD steps, against the world of
    one's (``ref``: losses, state) on the whole batch.  No engine
    response may run in the steps."""
    from horovod_tpu_torch.runtime import engine_or_none

    rank, size = hvd.rank(), hvd.size()
    rows = tokens.shape[0] // size
    mine = tokens[rank * rows:(rank + 1) * rows]
    model = LlamaModel.from_state_dict(
        cfg, init_params(cfg, seed, tokens.device),
        attention_fn=fa.flash_attention_fn)
    opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)

    def loss_fn(model, batch):
        local = lm_loss(model, batch)
        return hvd.allgather(local.reshape(1)).mean()

    step = hvd.make_train_step(model, loss_fn, opt)
    eng = engine_or_none()
    responses = eng.stats()["responses"] if eng else 0
    comm.reset_stats()
    losses, walls = [], []
    for _ in range(PAR_STEPS):
        t = time.perf_counter()
        losses.append(float(step(mine)))
        walls.append((time.perf_counter() - t) * 1e3)
    calls = comm.stats["calls"]
    moved = (eng.stats()["responses"] - responses) if eng else 0
    ref_losses, ref_state, update = ref
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    rel = {n: float((p.detach().float() - ref_state[n].float()).norm())
           / max(update[n][0], 1e-30) for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    check(loss_err <= PAR_LOSS_RTOL,
          f"collectives train: losses {losses} vs {ref_losses}")
    check(rel[worst] <= PAR_PARAM_REL,
          f"collectives train: {worst} off the world of one by "
          f"{rel[worst]} of its update")
    check(calls >= 2 * PAR_STEPS and moved == 0,
          f"collectives train: {calls} device-plane calls and {moved} "
          "engine responses in the steps")
    return dict(losses=losses, world_of_one_losses=ref_losses,
                loss_rel_err=loss_err, param_rel_err=rel[worst],
                param_rel_worst=worst, step_ms=walls,
                device_plane_calls_per_step=calls / PAR_STEPS,
                engine_responses=moved)


def phase_collectives_one(dev) -> None:
    """The device plane in this process's world of one (the NCCL group
    the training phases built): every call returns its input's value."""
    t0 = time.monotonic()
    out = collectives_checks(dev, hvd.rank(), hvd.size())
    emit("collectives", world=hvd.size(),
         backend=torch.distributed.get_backend(), calls=out,
         wall_s=time.monotonic() - t0)


def parallel_worker(rank: int, device: str) -> dict:
    """One rank of the parallel phase: each family on a mesh of both ranks
    (gloo, the card shared), held against the world of one on this rank.
    Each part's failed check raises."""
    hvd.init(device=device, backend="gloo")
    dev = hvd.device()
    seed = 7
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, parallel_cfg("tensor").vocab_size, (PAR_B, PAR_S + 1))).to(dev)
    refs = {}
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "backend": torch.distributed.get_backend()}
    expected = {"tensor": 2, "expert": 2, "seq_ring": 4, "seq_ulysses": 2,
                "pipe": 2}
    for part in PARALLEL_PARTS:
        cfg = parallel_cfg(part)
        if cfg.num_experts not in refs:
            refs[cfg.num_experts] = world_of_one(cfg, seed, tokens)
            out[f"world_of_one_update_E{cfg.num_experts}"] = \
                refs[cfg.num_experts][2]
        ref_losses, ref_state, update = refs[cfg.num_experts]
        fallbacks = fa.fallback_count()
        losses, params, step_ms, launches, per_step = parallel_part(
            part, cfg, seed, tokens)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                          ref_losses))
        rel = {n: float((p.float() - ref_state[n].float()).norm())
               / max(update[n][0], 1e-30) for n, p in params.items()}
        worst = max(rel, key=rel.get)
        param_err = max(float((p.float() - ref_state[n].float()).abs().max())
                        for n, p in params.items())
        out[part] = dict(losses=losses, world_of_one_losses=ref_losses,
                         loss_rel_err=loss_err, param_max_abs_err=param_err,
                         param_rel_err=rel[worst], param_rel_worst=worst,
                         param_rel_by_leaf=rel,
                         params_compared=len(params), step_ms=step_ms,
                         kernel_launches=launches,
                         fallbacks=fa.fallback_count() - fallbacks,
                         wire_bytes_per_step=per_step["wire_bytes"],
                         staged_bytes_per_step=per_step["staged_bytes"],
                         collectives_per_step=per_step["calls"])
        check(loss_err <= PAR_LOSS_RTOL,
              f"parallel {part}: losses {losses} vs {ref_losses}")
        check(rel[worst] <= PAR_PARAM_REL,
              f"parallel {part}: {worst} off the world of one by "
              f"{rel[worst]} of its update (norm, max abs {update[worst]}); "
              f"by leaf {rel}")
        check(all(n == expected[part] * PAR_STEPS
                  for n in launches.values()),
              f"parallel {part}: flash launches {launches}")
        check(fa.fallback_count() == fallbacks,
              f"parallel {part}: a fallback ran")
        del params
        free_memory()
    t0 = time.monotonic()
    out["collectives"] = collectives_checks(dev, hvd.rank(), hvd.size())
    out["collectives_train"] = collectives_train(
        parallel_cfg("tensor"), seed, tokens, refs[1])
    out["collectives_s"] = time.monotonic() - t0
    hvd.shutdown()
    return out


def phase_parallel():
    """The five parts on two ranks of the card; the ranks' losses must be
    equal."""
    t0 = time.monotonic()
    results = run_ranks("--parallel-worker", "parallel", PARALLEL_TIMEOUT_S)
    smi = smi_now()
    for part in PARALLEL_PARTS:
        per_rank = [r[part] for r in results]
        check(per_rank[0]["losses"] == per_rank[1]["losses"],
              f"parallel {part}: ranks' losses differ: "
              f"{[r['losses'] for r in per_rank]}")
        # Every leaf held on some rank (a pipe rank holds its stage's).
        leaves = results[0][f"world_of_one_update_E"
                            f"{parallel_cfg(part).num_experts}"]
        held = set().union(*(r["param_rel_by_leaf"] for r in per_rank))
        check(held == set(leaves),
              f"parallel {part}: leaves held {sorted(held)} of "
              f"{sorted(leaves)}")
        emit("parallel", part=part, ranks=ENGINE_RANKS,
             backend=results[0]["backend"], batch=PAR_B, seq=PAR_S,
             steps=PAR_STEPS, loss_rtol=PAR_LOSS_RTOL,
             param_rel=PAR_PARAM_REL, per_rank=per_rank,
             nvidia_smi_after=smi)
    for key in sorted(k for k in results[0] if k.startswith("world_of_one")):
        emit("parallel", part=key, update_norm_max_abs_by_leaf=results[0][key])
    # The replicated results equal across the ranks (a reduce-scatter's,
    # an all-to-all's and a gathered input's gradient are each rank's own).
    for name, call in results[0]["collectives"].items():
        if name.startswith(("grouped", "allgather_act", "broadcast",
                            "allreduce")):
            check(call["digest"] == results[1]["collectives"][name]["digest"],
                  f"collectives: ranks' {name} results differ")
    check(results[0]["collectives_train"]["losses"]
          == results[1]["collectives_train"]["losses"],
          "collectives train: ranks' losses differ")
    emit("parallel", part="collectives", ranks=ENGINE_RANKS,
         backend=results[0]["backend"],
         per_rank=[{k: r[k] for k in ("collectives", "collectives_train",
                                       "collectives_s")} for r in results],
         nvidia_smi_after=smi)
    emit("parallel", part="phase", wall_s=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# phase 14b: parallel_zoo: BERT-base and ResNet-50 placed by the rules
# (tensor, and fsdp by hand) through make_parallel_train_step on two ranks
# ---------------------------------------------------------------------------

PARALLEL_ZOO_TIMEOUT_S = 600
PARALLEL_ZOO_PARTS = ("bert_tensor", "bert_fsdp", "resnet_tensor",
                      "resnet_fsdp")
PZOO_BERT_B, PZOO_RESNET_B, PZOO_RESNET_HW = 4, 8, 224
PZOO_LAST_SCALE = 0.1
#: ResNet's world-of-one runs with one ulp of weight noise, and how many
#: times the farthest of them from the world of one a leaf of the placed
#: run may be, where that exceeds PAR_PARAM_REL (see parallel_zoo_worker).
PZOO_NOISE_RUNS, PZOO_FLOOR_FACTOR = 4, 2.0
#: Running statistics against the world of one, each BatchNorm's buffer
#: as ||got - want|| over its scale (:func:`stats_scale`).
PZOO_STATS_REL = 1e-5


def stats_scale(name: str, buffers: dict) -> torch.Tensor:
    """What a running statistic's error is measured against: a variance
    against itself, a mean against the standard deviation beside it (a
    mean after a convolution sits near zero, where its own norm would
    measure rounding against nothing)."""
    if name.endswith(".var"):
        return buffers[name]
    return buffers[name[:-len("mean")] + "var"].sqrt()


def pzoo_model(family: str, dev):
    """(model, global batch, loss_fn): BERT-base at its published widths
    and depth, fp32, the flash seam, ``train_bert``'s first 4 rows (its
    key mask and token types), ``train=False``; or ResNet-50 at 224², 1000
    classes, fp32, train mode, B 8 of seeded images.  The same weights
    and batch on every rank."""
    if family == "bert":
        cfg = dataclasses.replace(BertConfig.base(), dtype=torch.float32)
        model = BertForPretraining.from_state_dict(
            cfg, init_params(cfg, 7, dev), fa.flash_attention_fn)
        batch = bert_batch(7).rows(slice(0, PZOO_BERT_B)).to(dev)
        return model, batch, bert_example.pretraining_loss
    cfg = ResNetConfig.resnet50(dtype=torch.float32)
    state = init_params(cfg, 7, dev)
    # Each block's zero-initialised last BatchNorm scale at 0.1: the main
    # paths move from the first step, so every leaf's update is far above
    # fp32's resolution of it (from zero some move by ~3 ulps in 3 steps,
    # which no bound relative to the update can hold), and the steps stay
    # well-conditioned (at 1.0, one ulp of noise on the weights moves the
    # second step's loss by ~1 %: no two fp32 runs agree).
    for k, v in state.items():
        if k.endswith(".scale") and not v.any():
            v.fill_(PZOO_LAST_SCALE)
    model = ResNet.from_state_dict(cfg, state)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((PZOO_RESNET_B, PZOO_RESNET_HW, PZOO_RESNET_HW, 3))
    y = rng.integers(0, cfg.num_classes, PZOO_RESNET_B)
    batch = (torch.from_numpy(x.astype(np.float32)).to(dev),
             torch.from_numpy(y).to(dev))

    def loss_fn(model, batch):
        return softmax_cross_entropy(model(batch[0], train=True), batch[1])
    return model, batch, loss_fn


def pzoo_world_of_one(family: str, dev, noise_seed=None):
    """The plain model's SGD steps on this rank alone, on the global
    batch: (losses, parameters and buffers after the steps, {leaf:
    ||update||}).  ``noise_seed``: first multiply each weight by 1 + 1e-7
    · N(0, 1) (about one fp32 ulp), a run that differs from the plain one
    by rounding only."""
    model, batch, loss_fn = pzoo_model(family, dev)
    if noise_seed is not None:
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                              device=dev))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
    losses = []
    for _ in range(PAR_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    params = {k: v.detach() for k, v in model.named_parameters()}
    update = {k: float((v - start[k]).norm()) for k, v in params.items()}
    buffers = {k: v.detach().clone() for k, v in model.named_buffers()}
    del model, opt, start
    free_memory()
    return losses, params, buffers, update


def pzoo_off(params, buffers, ref) -> tuple:
    """(each leaf's ||got - want|| / ||want's update||, the running
    statistics' error over their scale) against one world of one."""
    _, ref_params, ref_buffers, update = ref
    rel = {n: float((p - ref_params[n]).norm()) / max(update[n], 1e-30)
           for n, p in params.items()}
    stats = [float((b - ref_buffers[n]).norm())
             / float(stats_scale(n, ref_buffers).norm())
             for n, b in buffers.items()]
    return rel, max(stats, default=0.0)


def pzoo_sizes() -> dict:
    """Each family's parameter count and fp32 bytes (the meta device:
    nothing allocated)."""
    out = {}
    for family, model in (
            ("bert", BertForPretraining(dataclasses.replace(
                BertConfig.base(), dtype=torch.float32), device="meta")),
            ("resnet", ResNet(ResNetConfig.resnet50(dtype=torch.float32),
                              device="meta"))):
        n = sum(p.numel() for p in model.parameters())
        out[family] = {"params": n, "param_gb_fp32": 4 * n / 1e9}
    return out


def pzoo_part(part: str, dev) -> dict:
    """One part's steps on a mesh of both ranks: the placement, the
    parallel step's losses and ms, the flash launches, the collectives'
    counters a step, peak memory; the whole parameters and buffers."""
    from horovod_tpu_torch.parallel.placement import full_state_dict

    family, axis = part.split("_")
    mesh = build_mesh({axis: hvd.size()})
    model, batch, loss_fn = pzoo_model(family, dev)
    if family == "bert":
        batch = batch.over(hvd.size() if axis == "fsdp" else 1)
    shard_params(model, mesh)
    split = {n: p.shape for n, p in model.named_parameters()
             if model.placement.specs.get(p)
             and any(model.placement.specs[p])}
    opt = torch.optim.SGD(model.parameters(), lr=PAR_LR)
    step = make_parallel_train_step(model, opt, mesh, loss_fn=loss_fn)
    card = dev.type == "cuda"
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    comm.reset_stats()
    losses, step_ms = [], []
    for _ in range(PAR_STEPS):
        t = time.perf_counter()
        losses.append(float(step(batch)))
        step_ms.append((time.perf_counter() - t) * 1e3)
    # The kernels on the card; their plain versions on a CPU rehearsal.
    out = dict(losses=losses, step_ms=step_ms,
               kernel_launches=dict(fa.launches if card else fa.plain_calls),
               plain_calls=dict(fa.plain_calls) if card else {},
               params_split=len(split),
               params_split_bytes_here=4 * sum(math.prod(s)
                                               for s in split.values()),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if card else None,
               **{k + "_per_step": v / PAR_STEPS
                  for k, v in comm.stats.items()})
    params = full_state_dict(model)
    buffers = {k: v.detach().clone() for k, v in model.named_buffers()}
    del model, opt, step
    free_memory()
    return out, params, buffers


def parallel_zoo_worker(rank: int, device: str) -> dict:
    """One rank of the parallel_zoo phase: each part on a mesh of both
    ranks (gloo, the card shared), held against the world of one on this
    rank (fp32, TF32 off).  Each part's failed check raises."""
    hvd.init(device=device, backend="gloo")
    dev = hvd.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "backend": torch.distributed.get_backend()}
    for family in ("bert", "resnet"):
        # The world of one's parameters stay on the card through its
        # family's parts (BERT-base 0.44 GB, ResNet-50 0.10 GB, fp32); a
        # ResNet's also in PZOO_NOISE_RUNS runs that differ from it by one
        # ulp of weight noise: its ReLUs and max-pool ties flip under
        # rounding, and such runs part from it by up to a few % of some
        # small leaves' 3-step updates, above PAR_PARAM_REL (BERT's GELU
        # has no kink: its bound is PAR_PARAM_REL alone).
        refs = [pzoo_world_of_one(family, dev)]
        if family == "resnet":
            refs += [pzoo_world_of_one(family, dev, seed)
                     for seed in range(PZOO_NOISE_RUNS)]
        # Each leaf's (and the statistics') fp32 floor: the farthest a
        # run that differs from the world of one by rounding lands from it.
        noise = [pzoo_off(r[1], r[2], refs[0]) for r in refs[1:]]
        floor = {n: max((o[0][n] for o in noise), default=0.0)
                 for n in refs[0][1]}
        stats_floor = max((o[1] for o in noise), default=0.0)
        for part in PARALLEL_ZOO_PARTS:
            if not part.startswith(family):
                continue
            fallbacks = fa.fallback_count()
            res, params, buffers = pzoo_part(part, dev)
            ref_losses = refs[0][0]
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(res["losses"], ref_losses))
            rel, stats = pzoo_off(params, buffers, refs[0])
            bound = {n: max(PAR_PARAM_REL, PZOO_FLOOR_FACTOR * floor[n])
                     for n in rel}
            over = {n: (rel[n], bound[n]) for n in rel if rel[n] > bound[n]}
            worst = max(rel, key=rel.get)
            stats_bound = max(PZOO_STATS_REL, PZOO_FLOOR_FACTOR * stats_floor)
            res.update(world_of_one_losses=ref_losses, loss_rel_err=loss_err,
                       param_rel_err=rel[worst], param_rel_worst=worst,
                       param_rel_bound_worst=bound[worst],
                       noise_floor_param_rel=max(floor.values()),
                       leaves_over_1e3=sum(v > PAR_PARAM_REL
                                           for v in rel.values()),
                       params_compared=len(params), stats_rel_err=stats,
                       stats_bound=stats_bound, stats_compared=len(buffers),
                       fallbacks=fa.fallback_count() - fallbacks)
            out[part] = res
            check(len(params) == len(refs[0][1]),
                  f"parallel_zoo {part}: {len(params)} leaves of "
                  f"{len(refs[0][1])}")
            check(loss_err <= PAR_LOSS_RTOL,
                  f"parallel_zoo {part}: losses {res['losses']} vs "
                  f"{ref_losses}")
            check(not over, f"parallel_zoo {part}: leaves off the world of "
                            f"one beyond their bound (rel, bound): {over}")
            check(stats <= stats_bound,
                  f"parallel_zoo {part}: running statistics off by "
                  f"{stats} (bound {stats_bound})")
            want = 12 * PAR_STEPS if family == "bert" else 0
            check(all(n == want for n in res["kernel_launches"].values())
                  and not any(res["plain_calls"].values()),
                  f"parallel_zoo {part}: flash launches "
                  f"{res['kernel_launches']}, plain {res['plain_calls']}")
            check(res["fallbacks"] == 0, f"parallel_zoo {part}: a fallback "
                                         "ran")
            del params, buffers
            free_memory()
        del refs
        free_memory()
    hvd.shutdown()
    return out


def phase_parallel_zoo():
    """The four parts on two ranks of the card; the ranks' losses must be
    equal."""
    t0 = time.monotonic()
    results = run_ranks("--parallel-zoo-worker", "parallel_zoo",
                        PARALLEL_ZOO_TIMEOUT_S)
    smi = smi_now()
    emit("parallel_zoo", part="sizes", **pzoo_sizes(),
         bert_batch=[PZOO_BERT_B, BERT_S],
         resnet_batch=[PZOO_RESNET_B, PZOO_RESNET_HW, PZOO_RESNET_HW, 3],
         peak_gb_by_part={p: [r[p]["peak_gb"] for r in results]
                          for p in PARALLEL_ZOO_PARTS})
    for part in PARALLEL_ZOO_PARTS:
        per_rank = [r[part] for r in results]
        check(per_rank[0]["losses"] == per_rank[1]["losses"],
              f"parallel_zoo {part}: ranks' losses differ: "
              f"{[r['losses'] for r in per_rank]}")
        emit("parallel_zoo", part=part, ranks=ENGINE_RANKS,
             backend=results[0]["backend"], steps=PAR_STEPS, lr=PAR_LR,
             loss_rtol=PAR_LOSS_RTOL, param_rel=PAR_PARAM_REL,
             stats_rel=PZOO_STATS_REL, per_rank=per_rank,
             nvidia_smi_after=smi)
    emit("parallel_zoo", part="phase", wall_s=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# phase 15: the weight plane: sharded async checkpoints of CUDA state,
# bench_llama's model under ZeRO-1 on two ranks of the card
# ---------------------------------------------------------------------------

CKPT_TIMEOUT_S = 600
#: ckpt's depth: bench_llama's widths cut from 16 layers to 2, to keep the
#: whole script inside its limit.
CKPT_LAYERS = 2


def ckpt_config():
    return dataclasses.replace(bench.llama_config(), num_layers=CKPT_LAYERS)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def zero_optimizer(model):
    """The hook form's ZeRO-1 over bench_llama's AdamW: fp32 master shards
    and moments of a bf16 model."""
    return torch_frontend.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=bench.LLAMA_LR,
                          **bench.LLAMA_ADAMW), sharded=True)


def zero_leaves(opt, model) -> dict:
    """Every tensor a ZeRO-1 checkpoint holds, by its checkpoint name:
    the model's state, this rank's master shards, their AdamW state."""
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    for gi, g in enumerate(opt._groups):
        out[f"zero.master.{gi}"] = g["master"]
        inner = opt._shard_opt.param_groups[gi]["params"][0]
        for key, val in opt._shard_opt.state.get(inner, {}).items():
            out[f"zero.opt.{gi}.{key}"] = val
    return out


def leaves_equal(got: dict, want: dict) -> list:
    """The names whose tensors differ (values and dtype, bit for bit)."""
    return sorted(k for k in want if not (
        got[k].dtype == want[k].dtype
        and torch.equal(got[k].detach().cpu(), want[k].detach().cpu())))


def written_equal(loader, leaves: dict, opt) -> list:
    """The names whose written bytes differ from ``leaves`` (this rank's
    window of the sharded vectors; bf16 model leaves against their fp32
    upcast; the AdamW step against the zero_scalars entry)."""
    bad = []
    for name, t in leaves.items():
        if name.startswith("model."):
            got = loader.read_replicated(name)
            want = t.detach().float().cpu().numpy()
        elif name.startswith("zero.opt.") and t.dim() == 0:
            _, _, gi, key = name.split(".", 3)
            got = loader.read_replicated(f"zero_scalars.{gi}.{key}")
            want = np.asarray(t.item())
        else:
            sh = opt._groups[int(name.split(".")[2])]["sharder"]
            got = loader.read_flat(name, sh.offset, sh.count)
            want = t.detach().cpu().numpy()
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            bad.append(name)
    return bad


def ckpt_worker(rank: int, device: str, directory: str) -> dict:
    """One rank of the ckpt phase: bench_llama's model at B 4 x S 2048
    (this rank's 4 rows of the bench's batch of 8), ZeRO-1; step 1 and
    its save (the pinned buffers are made), step 2, ``save()`` of step 2
    through the async writer and step 3 at once;
    the written bytes against the pre-step-3 clones; a restore at world 2
    into a fresh model and optimizer against them; step 3 rerun from the
    restore against the uninterrupted step 3."""
    hvd.init(device=device)
    dev = hvd.device()
    cfg = ckpt_config()
    rows = 8 // hvd.size()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2049), dtype=np.int32)
    batch = torch.from_numpy(tokens[rank * rows:(rank + 1) * rows]).long() \
        .to(dev)
    model = train_model(cfg, dev)
    opt = zero_optimizer(model)

    def step(model, opt):
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    fa.reset_launches()
    step(model, opt)
    # The save of step 1 makes the writer's pinned buffers (its stall is
    # their allocation); the measured save, of step 2, reuses them.
    writer = CheckpointWriter(directory, meta={"model": "bench_llama"})
    writer.save(1, *torch_capture(opt, model, 1))
    first_stall_ms = writer.last_stall_ms
    writer.wait(timeout=CKPT_TIMEOUT_S)
    step(model, opt)
    sync(dev)
    launches = {k: v / 2 for k, v in fa.launches.items()}
    plain = dict(fa.plain_calls)
    check(dev.type != "cuda" or (
        all(v == cfg.num_layers for v in launches.values())
        and not any(plain.values())),
        f"ckpt: flash launches a step {launches}, plain calls {plain}")
    pre = {k: v.detach().clone() for k, v in zero_leaves(opt, model).items()}
    st, sh = torch_capture(opt, model, 2)
    d2h_bytes = sum(t.numel() * t.element_size() for t in
                    list(st["model"].values()) + [v[0] for v in sh.values()])
    sync(dev)
    writer.save(2, st, sh)
    stall_ms = writer.last_stall_ms
    # Step 3 right behind save(): its in-place updates of the params,
    # masters and moments must not reach the snapshot.
    step(model, opt)
    writer.wait(timeout=CKPT_TIMEOUT_S)
    writer.close()
    # Rank 0 writes the manifest after the commit barrier, so the other
    # ranks' wait() can return before it: read only once rank 0's has.
    hvd.allreduce(torch.zeros(1, device=dev), name="ckpt.committed")
    after = {k: v.detach().clone()
             for k, v in zero_leaves(opt, model).items()}
    loader = CheckpointLoader(directory)
    check(loader.step == 2 and loader.world_size == hvd.size(),
          f"ckpt: manifest step {loader.step} world {loader.world_size}")
    bad = written_equal(loader, pre, opt)
    check(not bad, f"ckpt: written bytes differ from the pre-step-3 "
                   f"values (the snapshot raced the step): {bad[:5]}")
    void = [(r, k) for r in range(loader.world_size)
            for k in loader._shard_npz(r).files
            if loader._shard_npz(r)[k].dtype.kind == "V"]
    check(not void, f"ckpt: |V2 leaves written: {void[:5]}")
    del model, opt, st, sh
    free_memory()

    # Restore at world 2 into a model of other weights and a fresh
    # optimizer, then rerun step 3.
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 1, dev),
                                       attention_fn=fa.flash_attention_fn)
    opt = zero_optimizer(model)
    sync(dev)
    t = time.perf_counter()
    restored = torch_restore(opt, model, loader)
    sync(dev)
    restore_ms = (time.perf_counter() - t) * 1e3
    loader.close()
    check(restored == 2, f"ckpt: restored step {restored}")
    bad = leaves_equal(zero_leaves(opt, model), pre)
    check(not bad, f"ckpt: world-2 restore differs at {bad[:5]}")
    step(model, opt)
    bad = leaves_equal(zero_leaves(opt, model), after)
    check(not bad, f"ckpt: step 3 from the restore differs from the "
                   f"uninterrupted step 3 at {bad[:5]}")
    out = {"rank": hvd.rank(), "size": hvd.size(), "batch": list(batch.shape),
           "bytes_written": writer.last_bytes, "d2h_bytes": d2h_bytes,
           "save_stall_ms": stall_ms, "first_save_stall_ms": first_stall_ms,
           "snapshot_d2h_ms": writer.last_snapshot_ms,
           "snapshot_gb_per_s": d2h_bytes / writer.last_snapshot_ms / 1e6
           if writer.last_snapshot_ms else None,
           "write_fsync_commit_ms": writer.last_write_ms,
           "write_phases_ms": writer.last_phases,
           "restore_ms_world2": restore_ms,
           "flash_launches_per_step": launches,
           "leaves": len(pre), "snapshot_bitwise": True,
           "restore_world2_bitwise": True, "rerun_step3_bitwise": True}
    del model, opt
    free_memory()
    hvd.shutdown()
    return out


def phase_ckpt(dev):
    """Two ranks of the card checkpoint bench_llama's ZeRO-1 state
    (``--ckpt-worker``); this process restores it at world 1, resliced
    through shard_bounds, and holds every leaf to the written bytes."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.monotonic()
        results = run_ranks("--ckpt-worker", "ckpt", CKPT_TIMEOUT_S,
                            extra=("--ckpt-dir", directory))
        cfg = ckpt_config()
        model = LlamaModel.from_state_dict(
            cfg, init_params(cfg, 1, dev), attention_fn=fa.flash_attention_fn)
        opt = zero_optimizer(model)
        check(opt.sharder.size == 1, "ckpt: world-1 restore not at world 1")
        loader = CheckpointLoader(directory)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        restored = torch_restore(opt, model, loader)
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t) * 1e3
        check(restored == 2, f"ckpt: world-1 restore of step {restored}")
        bad = written_equal(loader, zero_leaves(opt, model), opt)
        check(not bad, f"ckpt: world-1 restore differs at {bad[:5]}")
        loader.close()
        emit("ckpt", ranks=ENGINE_RANKS, model="bench_llama",
             params=sum(p.numel() for p in model.parameters()),
             per_rank=results, restore_ms_world1=restore_ms,
             restore_world1_bitwise=True, wall_s=time.monotonic() - t0,
             nvidia_smi_after=smi_now())
        del model, opt
        free_memory()
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: elastic recovery through the launcher: a shard write torn by
# the ckpt-kill fault, the relaunch, and the resume
# ---------------------------------------------------------------------------

KILL_LAYERS, KILL_STEPS, KILL_B, KILL_S = 2, 8, 2, 2048
KILL_TIMEOUT_S = 420


def kill_batch(step: int, rank: int, vocab: int, dev) -> torch.Tensor:
    """Rank ``rank``'s rows of step ``step``'s batch (the same on every
    incarnation, so a redone step computes the same)."""
    tokens = np.random.default_rng(1000 + step).integers(
        0, vocab, (2 * KILL_B, KILL_S + 1), dtype=np.int32)
    return torch.from_numpy(tokens[rank * KILL_B:(rank + 1) * KILL_B]) \
        .long().to(dev)


def kill_worker(device: str = "cuda:0") -> None:
    """One rank under ``python -m horovod_tpu_torch.run``: bench_llama's
    widths at KILL_LAYERS layers, MasterWeights(AdamW), gradients averaged
    by the engine, under ``run_elastic`` with the env-configured writer
    (``HOROVOD_CHECKPOINT_DIR``, every 2 steps), committing each step."""
    from horovod_tpu_torch.elastic import ElasticState, run_elastic
    from horovod_tpu_torch.runtime.engine import HorovodInternalError

    hvd.init(device=device, backend="gloo")
    dev = hvd.device()
    cfg = dataclasses.replace(bench.llama_config(), num_layers=KILL_LAYERS)
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev),
                                       attention_fn=fa.flash_attention_fn)
    mw = masterweights(model)
    # AdamW's state made now (what its first step makes), so the elastic
    # state holds it from the start.
    for m in mw.masters:
        mw.inner.state[m] = {"step": torch.tensor(0.0),
                             "exp_avg": torch.zeros_like(m),
                             "exp_avg_sq": torch.zeros_like(m)}
    params = list(model.parameters())
    state = ElasticState(params=dict(model.named_parameters()),
                         masters=list(mw.masters),
                         opt={str(i): mw.inner.state[m]
                              for i, m in enumerate(mw.masters)}, step=0)
    writer = CheckpointWriter(meta={"model": "bench_llama_2l"})
    fa.reset_launches()
    steps_run = [0]

    def train(state):
        print(f"CKPT_KILL_ENTER rank={hvd.rank()} step={state.step}",
              flush=True)
        while state.step < KILL_STEPS:
            s = state.step + 1
            print(f"CKPT_KILL_BEGIN rank={hvd.rank()} step={s}", flush=True)
            model.zero_grad(set_to_none=True)
            loss = bench.llama_loss_fn(
                model, kill_batch(s, hvd.rank(), cfg.vocab_size, dev))
            loss.backward()
            steps_run[0] += 1
            grads = hvd.grouped_allreduce([p.grad for p in params],
                                          name="kill.grads")
            for p, g in zip(params, grads):
                p.grad = g
            mw.step()
            state.step = s
            state.commit()
            print(f"CKPT_KILL_STEP rank={hvd.rank()} step={s} "
                  f"loss={loss.item():.6f}", flush=True)
            try:
                # Each checkpoint committed before the next step (the
                # writer is latest-wins: with a write longer than a step,
                # queued saves would be dropped and the fault would land
                # on another step).  A peer that died mid-write fails the
                # barrier: the step's collective reports it.
                if writer.maybe_save(s, state):
                    writer.wait(timeout=KILL_TIMEOUT_S)
            except HorovodInternalError:
                pass

    run_elastic(train, state)
    writer.close()
    digest = hashlib.sha256()
    for t in params + list(mw.masters):
        digest.update(t.detach().contiguous().view(torch.uint8).cpu()
                      .numpy().tobytes())
    launches = dict(fa.launches)
    check(dev.type != "cuda" or (
        all(v == KILL_LAYERS * steps_run[0] for v in launches.values())
        and not any(fa.plain_calls.values())),
        f"ckpt_kill: flash launches {launches} in {steps_run[0]} steps")
    print(f"CKPT_KILL_OK rank={hvd.rank()} step={state.step} "
          f"last_commit={writer.last_committed_step} steps_run="
          f"{steps_run[0]} digest={digest.hexdigest()[:16]}", flush=True)
    hvd.shutdown()


def kill_run(directory: str, fault: bool, worker=None) -> dict:
    """One launcher run of the kill worker (``worker``: its command,
    default this script's ``--kill-worker``); its output lines stamped on
    arrival, the launcher's exit code."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(HOROVOD_CHECKPOINT_INTERVAL_STEPS="2",
               HOROVOD_FAULT_TIMEOUT_SEC="5",
               HOROVOD_ELASTIC_BACKOFF_SEC="0.5",
               HOROVOD_SHM_DISABLE=os.environ.get("HOROVOD_SHM_DISABLE", "0"))
    if fault:
        env["HOROVOD_FAULT_INJECT"] = "1:5:ckpt-kill"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
           "--restart-on-failure", "1" if fault else "0",
           "--coordinator", f"127.0.0.1:{distinct_port()}",
           "--checkpoint-dir", directory, "--",
           *(worker or [sys.executable, os.path.abspath(__file__),
                        "--kill-worker"])]
    port = int(cmd[cmd.index("--coordinator") + 1].rsplit(":", 1)[1])
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: [
        lines.append((time.monotonic() - t0, ln.rstrip("\n")))
        for ln in iter(proc.stdout.readline, "")], daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=KILL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise RuntimeError("chip_smoke check failed: ckpt_kill launcher "
                           "timed out:\n" + "\n".join(
                               ln for _, ln in lines[-40:]))
    reader.join(timeout=30)
    return {"rc": rc, "lines": lines, "wall_s": time.monotonic() - t0,
            "port": port}


def _kill_events(lines, tag):
    """[(t, incarnation-ordered (rank, step))] of a worker line kind."""
    out = []
    for t, ln in lines:
        m = re.search(rf"{tag} rank=(\d+) step=(\d+)", ln)
        if m:
            out.append((t, int(m.group(1)), int(m.group(2))))
    return out


def phase_ckpt_kill(worker=None):
    """``python -m horovod_tpu_torch.run -np 2 --restart-on-failure 1
    --checkpoint-dir D`` over the kill worker, without and with
    ``HOROVOD_FAULT_INJECT=1:5:ckpt-kill`` (rank 1 SIGKILLed between the
    halves of its step-6 shard write).  The two runs go side by side
    (each its own coordinator, directory and ranks)."""
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()

    def one(name):
        directory = tempfile.mkdtemp(prefix=f"chip_smoke_kill_{name}_")
        try:
            run = kill_run(directory, fault=name == "fault", worker=worker)
            run["manifests"] = ckpt_manifest.list_manifest_steps(directory)
            run["torn_tmp"] = os.path.exists(
                ckpt_manifest.shard_file(directory, 6, 1, 2) + ".tmp")
            found = latest_manifest(directory)
            run["latest"] = found[1] if found else None
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        return run

    runs = dict(zip(("clean", "fault"), side_by_side(
        lambda: one("clean"), lambda: one("fault"))))
    for name, run in runs.items():
        text = "\n".join(ln for _, ln in run["lines"])
        check(run["rc"] == 0, f"ckpt_kill {name}: launcher exited "
                              f"{run['rc']}:\n{text[-4000:]}")
        run["oks"] = re.findall(
            r"CKPT_KILL_OK rank=(\d+) step=(\d+) last_commit=(-?\d+) "
            r"steps_run=(\d+) digest=([0-9a-f]+)", text)
        check(len(run["oks"]) == 2, f"ckpt_kill {name}: "
                                    f"{len(run['oks'])} ranks finished")
    time.sleep(2)
    shm_after = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()
    clean, fault = runs["clean"], runs["fault"]
    digests = {ok[4] for r in runs.values() for ok in r["oks"]}
    lines = fault["lines"]
    kill = [t for t, ln in lines if "FAULT INJECT: ckpt-kill at step" in ln]
    check(len(kill) == 1, f"ckpt_kill: {len(kill)} kill lines")
    t_kill = kill[0]
    steps = _kill_events(lines, "CKPT_KILL_STEP")
    begins = _kill_events(lines, "CKPT_KILL_BEGIN")
    enters = _kill_events(lines, "CKPT_KILL_ENTER")
    reentry = [s for t, r, s in enters if t > t_kill]
    t_reenter = min((t for t, r, s in enters if t > t_kill), default=t_kill)
    # Rank 0's last commit before the world re-entered (its step line may
    # reach the launcher after the kill's), and the furthest step begun.
    committed = max(s for t, r, s in steps if t < t_reenter and r == 0)
    started = max(s for t, r, s in begins if t < t_reenter)
    relaunched_first = min((t for t, r, s in steps if t > t_kill and r == 1),
                           default=None)
    durable_at_kill = max(range(2, committed, 2), default=-1)
    check(fault["manifests"] and 6 not in fault["manifests"],
          f"ckpt_kill: a manifest names the torn step: {fault['manifests']}")
    check(fault["torn_tmp"], "ckpt_kill: no torn step-6 tmp left on disk")
    check(fault["latest"] == KILL_STEPS and clean["latest"] == KILL_STEPS,
          f"ckpt_kill: newest durable steps {fault['latest']} / "
          f"{clean['latest']}")
    check(len(reentry) == 2 and set(reentry) == {committed},
          f"ckpt_kill: the relaunched world entered at {reentry}, not at "
          f"the last commit {committed}")
    check(committed >= durable_at_kill, "ckpt_kill: resumed behind the "
                                        "last durable checkpoint")
    check(len(digests) == 1, f"ckpt_kill: final digests differ between "
                             f"the runs and ranks: {digests}")
    check(relaunched_first is not None, "ckpt_kill: the relaunched rank "
                                        "never stepped")
    # The engine names its segments by its coordinator's port: those of
    # another world that runs beside this phase are that world's.
    own = {f"hvd{r['port']}_" for r in runs.values()}
    with _PORTS_LOCK:
        others = tuple({f"hvd{p}_" for p in _PORTS_HANDED} - own)
    leaked = sorted(n for n in shm_after - shm_before
                    if not n.startswith(others))
    check(not leaked, f"ckpt_kill: /dev/shm entries leaked: {leaked}")
    emit("ckpt_kill", ranks=2, layers=KILL_LAYERS, steps=KILL_STEPS,
         batch_per_rank=[KILL_B, KILL_S], interval=2,
         fault="1:5:ckpt-kill", killed_at_save_of_step=6,
         manifests=fault["manifests"], last_commit_before_kill=committed,
         durable_step_at_kill=durable_at_kill, reentry_step=committed,
         committed_steps_lost=0, steps_redone=started - committed,
         relaunch_to_first_step_s=relaunched_first - t_kill,
         digest=digests.pop(), wall_s_clean=clean["wall_s"],
         wall_s_fault=fault["wall_s"],
         stamps_s={name: {
             "first_enter": min((t for t, _, _ in _kill_events(
                 r["lines"], "CKPT_KILL_ENTER")), default=None),
             "first_step": min((t for t, _, _ in _kill_events(
                 r["lines"], "CKPT_KILL_STEP")), default=None),
             "last_step": max((t for t, _, _ in _kill_events(
                 r["lines"], "CKPT_KILL_STEP")), default=None)}
             for name, r in runs.items()},
         steps_run_fault=[int(ok[3]) for ok in fault["oks"]],
         dev_shm_leaked=leaked)


# ---------------------------------------------------------------------------
# phase 17: a replica serving a checkpoint at Llama-3-8B widths, and a live
# weight push through the router into its captured decode graphs
# ---------------------------------------------------------------------------

SW_LAYERS = 2
SW_TIMEOUT_S = 600
#: The push's cap: the serve protocol's line limit (both packages'
#: readers take 1 << 26 bytes a line).
LINE_LIMIT = 1 << 26


def sw_push_tree(seeded: dict, cfg) -> dict:
    """The partial push: layer 0's q and o projections times 1.5 and
    every norm scale times 1.1, from the seeded weights, in the JAX
    package's paths and layout (fp32)."""
    full = params_to_jax(seeded, cfg)["params"]
    tree = {"layer_0": {"attn": {
        k: {"kernel": full["layer_0"]["attn"][k]["kernel"] * np.float32(1.5)}
        for k in ("wq", "wo")}}}
    tree["norm_f"] = {"scale": full["norm_f"]["scale"] * np.float32(1.1)}
    for i in range(cfg.num_layers):
        for norm in ("norm_attn", "norm_mlp"):
            tree.setdefault(f"layer_{i}", {})[norm] = {
                "scale": full[f"layer_{i}"][norm]["scale"] * np.float32(1.1)}
    return {"params": tree}


def expected_after_push(seeded: dict, cfg, by_path: dict) -> dict:
    """The seeded state dict with the decoded pushed leaves in their
    places, cast to the model's dtypes (what a fresh runner on the swapped
    weights holds)."""
    out = {k: v.clone() for k, v in seeded.items()}
    layout = jax_paths(cfg)
    for path, arr in by_path.items():
        name, kind = layout[path[2:]]
        src = torch.from_numpy(arr)
        if kind in ("dense", "head", "router"):
            src = src.t()
        out[name].copy_(src)
    return out


def graph_vs_eager(runner, model, seed) -> dict:
    """Each width's decode graph (over the runner's weights) against the
    eager step of ``model`` on the same inputs and pools: logits bit for
    bit; B6's launches counted per replay."""
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    for pool in (runner.pool_k, runner.pool_v):
        pool[:, 1:].normal_(generator=gen)
    rows = {}
    for width in (1, 2, 4, 8):
        tokens, tables, pos = graph_rows(runner, width, seed + width)
        k0, v0 = runner.pool_k.clone(), runner.pool_v.clone()
        before = pa.launches
        got = runner.decode(tokens, tables, pos)
        replay_launches = pa.launches - before
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)
        want = eager_decode(runner, tokens, tables, pos, model=model)
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)
        rows[width] = {"bitwise": bool(np.array_equal(got, want)),
                       "max_abs_diff": float(np.abs(got - want).max()),
                       "b6_launches": replay_launches}
        del k0, v0
    return rows


#: New tokens of each serve_weights stream, and the phase's KV pool
#: (blocks of 16): 8 streams of at most 512 + 960 tokens fit without a
#: preemption.  At a 2-layer model's pace (~180 tokens/s a stream with
#: the RMSNorm kernel) the streams run ~5 s, well past the push's
#: ~1.7-3 s (encode, send, decode) that must land while they do.
SW_NEW_TOKENS, SW_KV_BLOCKS = 960, 1024


def sw_requests(vocab, seed):
    """8 requests of 64-512 prompt tokens and SW_NEW_TOKENS new tokens
    each."""
    rng = np.random.default_rng(seed + 7)
    return [(f"w{i}", rng.integers(0, vocab, int(n)).tolist(),
             SW_NEW_TOKENS) for i, n in enumerate(rng.integers(64, 513, 8))]


def phase_serve_weights(dev, seed):
    """A checkpoint of seeded Llama-3-8B weights cut to SW_LAYERS layers,
    written by the JAX-form capture; a replica serving it behind the
    router (``run --serve --serve-model DIR``) and a live push mid-stream
    through ``WeightPusher``; in this process, a runner restored from the
    same checkpoint holds its graphs against fresh eager runners before
    and after the same push."""
    env = dict(SERVE_ENV, HOROVOD_SERVE_PARAM_SEED=str(seed),
               HOROVOD_SERVE_KV_BLOCKS=str(SW_KV_BLOCKS))
    cfg = dataclasses.replace(build_model_config(ServeConfig.from_env(env)),
                              num_layers=SW_LAYERS)
    directory = tempfile.mkdtemp(prefix="chip_smoke_serve_ckpt_")
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()
    proc, starter, fleet = None, None, {}
    try:
        seeded = init_params(cfg, seed, dev)
        seeded_model = LlamaModel.from_state_dict(cfg, seeded)
        n_params = sum(t.numel() for t in seeded.values())
        t = time.monotonic()
        st, sh = jax_capture(None, seeded_model, 0)
        model_name = ServeConfig.from_env(env).model
        w = CheckpointWriter(directory, meta={"model": model_name})
        w.save(0, st, sh)
        w.wait(timeout=SW_TIMEOUT_S)
        w.close()
        write_s = time.monotonic() - t
        ckpt_bytes = w.last_bytes
        del st, sh

        # The replica behind the router starts (and restores the
        # checkpoint) while this process restores it too.
        def start_fleet():
            t = time.monotonic()
            try:
                fleet["got"] = bench_serve.start_fleet(
                    1, device=dev.type,
                    env=dict(env, HOROVOD_SERVE_WARMUP="512"),
                    timeout=SW_TIMEOUT_S,
                    extra_args=("--serve-model", directory))
            except BaseException as e:  # noqa: BLE001 -- raised on join
                fleet["error"] = e
            fleet["s"] = time.monotonic() - t

        starter = threading.Thread(target=start_fleet, daemon=True)
        starter.start()

        # In this process: the runner restored from the checkpoint.
        renv = dict(env, HOROVOD_SERVE_CHECKPOINT=directory)
        t = time.monotonic()
        runner = ModelRunner(ServeConfig.from_env(renv), device=dev)
        sync(dev)
        restore_s = time.monotonic() - t
        check(runner.model_cfg.num_layers == SW_LAYERS
              and runner.checkpoint_step == 0,
              f"serve_weights: restored {runner.model_cfg.num_layers} "
              f"layers of step {runner.checkpoint_step}")
        bad = leaves_equal(runner.model.state_dict(), seeded)
        check(not bad, f"serve_weights: restored weights differ at {bad}")
        runner.warmup(max_tokens=64)
        graphs = 4 if dev.type == "cuda" else 0
        check(runner.captures == graphs, f"serve_weights: {runner.captures} "
                                         "graphs captured at warm-up")
        before = graph_vs_eager(runner, seeded_model, seed)

        # The replica behind the router.
        tree = sw_push_tree(seeded, cfg)
        frames = encode_leaves(tree, wire="int8")
        line_bytes = len(json.dumps({"op": "weights", "frames": frames,
                                     "epoch": 1}))
        check(line_bytes < LINE_LIMIT, f"serve_weights: the push line is "
                                       f"{line_bytes} bytes")
        check({f["wire"] for f in frames} == {"int8", "fp32"},
              f"serve_weights: wires {({f['wire'] for f in frames})}")
        starter.join()
        if "error" in fleet:
            raise fleet["error"]
        proc, port, log = fleet.pop("got")
        fleet_start_s = fleet["s"]
        check(any("serving checkpoint step 0" in ln for ln in log),
              "serve_weights: the router did not serve the checkpoint")
        cli = ServeClient("127.0.0.1", port, timeout=SW_TIMEOUT_S)
        reqs = sw_requests(cfg.vocab_size, seed)
        t0 = time.monotonic()
        for rid, prompt, new in reqs:
            cli.start_generate(rid, prompt, new)
        # The push lands once every stream is decoding.
        deadline = time.monotonic() + SW_TIMEOUT_S
        while time.monotonic() < deadline:
            with cli._qlock:
                seen = [sum(e["event"] == "token" for e in cli._queues[rid])
                        for rid, _, _ in reqs]
            if min(seen) >= 8:
                break
            time.sleep(0.05)
        check(min(seen) >= 8, f"serve_weights: streams {seen} before push")
        pusher = WeightPusher("127.0.0.1", port, timeout=SW_TIMEOUT_S)
        t_push = time.monotonic()
        ack = pusher.push(tree, wire="int8")
        t_ack = time.monotonic()
        stale = pusher.push(tree, epoch=1, wire="int8")
        pusher.close()
        results = {rid: cli.collect(rid, timeout=SW_TIMEOUT_S)
                   for rid, _, _ in reqs}
        wall = time.monotonic() - t0
        stats = cli.stats()
        sched = stats["replicas"][0]["scheduler"]
        check(ack["epoch"] == 1 and len(ack["replicas"]) == 1
              and ack["replicas"][0]["applied"],
              f"serve_weights: push not applied: {ack}")
        check(not stale["replicas"][0]["applied"]
              and sched["weight_swaps"] == 1 and sched["weight_epoch"] == 1,
              f"serve_weights: the stale replay was applied: {stale}, "
              f"{sched['weight_swaps']} swaps")
        requeued = {}
        toks_before = toks_after = 0
        for rid, prompt, new in reqs:
            evs = results[rid]
            rq = [e for e in evs if e["event"] == "requeued"]
            # A stream still running at the swap restarts once, on the new
            # epoch; one that finished before it stays on epoch 0.
            check(evs[-1]["event"] == "done" and len(evs[-1]["tokens"])
                  == new and len(rq) <= 1
                  and all(e.get("reason") == "weights" for e in rq)
                  and evs[-1]["weight_epoch"] == len(rq),
                  f"serve_weights: {rid} ended {evs[-1]['event']} with "
                  f"{len(evs[-1].get('tokens', []))} tokens at epoch "
                  f"{evs[-1].get('weight_epoch')}, requeued {rq}")
            requeued[rid] = len(rq)
            for e in evs:
                if e["event"] != "token":
                    continue
                if e["_recv_ts"] < t_push:
                    toks_before += 1
                elif e["_recv_ts"] > t_ack:
                    toks_after += 1
        check(ack["replicas"][0]["restarted"] == sum(requeued.values()) > 0,
              f"serve_weights: {ack['replicas'][0]['restarted']} streams "
              f"restarted, {sum(requeued.values())} requeued")
        check(sched["fused_attn_steps"] == sched["decode_steps"]
              and sched["config"]["checkpoint_step"] == 0,
              "serve_weights: a replica step skipped the fused kernel, or "
              "the replica served no checkpoint")
        t_last = max(e["_recv_ts"] for evs in results.values() for e in evs)
        first = min(e["_recv_ts"] for evs in results.values() for e in evs
                    if e["event"] == "token")
        rc = bench_serve.stop_fleet(proc, cli, timeout=120)
        proc = None
        check(rc == 0, f"serve_weights: router exited {rc}")

        # The same push into this process's runner: in place, under its
        # captured graphs.
        by_path = decode_leaves(frames)
        t = time.perf_counter()
        applied = runner.apply_weights(by_path)
        swap_ms_here = (time.perf_counter() - t) * 1e3
        check(applied == len(frames), f"serve_weights: {applied} leaves "
                                      f"applied of {len(frames)}")
        check(runner.captures == graphs,
              "serve_weights: a graph was recaptured")
        expected = expected_after_push(seeded, cfg, by_path)
        bad = leaves_equal(runner.model.state_dict(), expected)
        check(not bad, f"serve_weights: swapped weights differ at {bad}")
        fresh = LlamaModel.from_state_dict(cfg, expected)
        after = graph_vs_eager(runner, fresh, seed + 100)
        for when, rows in (("restore", before), ("swap", after)):
            for width, r in rows.items():
                check(r["bitwise"] and r["b6_launches"] == (
                    SW_LAYERS if dev.type == "cuda" else 0),
                      f"serve_weights: after the {when}, width {width}'s "
                      f"graph is not the fresh eager step: {r}")
        check(runner.captures == graphs,
              "serve_weights: a graph was recaptured")
        emit("serve_weights", model=model_name, layers=SW_LAYERS,
             params=n_params, checkpoint_bytes=ckpt_bytes,
             checkpoint_write_s=write_s, restore_s=restore_s,
             fleet_start_s=fleet_start_s, fleet_started_beside_restore=True,
             replica_times=replica_times(log), requests=len(reqs),
             push_leaves=len(frames), push_line_mb=line_bytes / 2 ** 20,
             push_wire="int8", push_round_trip_s=t_ack - t_push,
             swap_ms_replica=sched["weight_swap_ms"],
             swap_ms_in_process=swap_ms_here,
             requeued=sum(requeued.values()),
             restarted=ack["replicas"][0]["restarted"],
             stale_epoch_applied=stale["replicas"][0]["applied"],
             tokens_per_s_before=toks_before / max(1e-9, t_push - first),
             tokens_per_s_after=toks_after / max(1e-9, t_last - t_ack),
             wall_s=wall, graph_vs_eager_after_restore=before,
             graph_vs_eager_after_swap=after,
             graphs_captured=runner.captures,
             replica_decode_steps=sched["decode_steps"],
             nvidia_smi_after=smi_now())
        del runner, fresh, seeded_model, seeded, expected
        free_memory()
    finally:
        if starter is not None:
            starter.join()
            if "got" in fleet:
                proc = fleet["got"][0]
        if proc is not None:
            bench_serve.kill_fleet(proc)
        shutil.rmtree(directory, ignore_errors=True)
    shm_after = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()
    check(not (shm_after - shm_before), "serve_weights: /dev/shm leaked")


# ---------------------------------------------------------------------------
# phase 18: observability and tuning on the card: the timeline, the
# metrics endpoint and run --status, the stall inspector, the flight
# recorder's postmortem, the engine autotuner and the serve tuner
# ---------------------------------------------------------------------------

OBS_STEPS = 8
OBS_TIMEOUT_S = 600
#: The plain and on runs' depth: bench_llama's widths cut from 16 layers
#: to 4, to keep the whole script inside its limit (autotune trains 16).
OBSERVE_LAYERS = 4
#: Fleet totals against the sum of the ranks' stats() on these counters.
OBS_SUM_KEYS = ("data_bytes_tx", "data_bytes_rx", "allreduce_bytes",
                "tensors", "responses")
#: The stall part: how long rank 1 withholds its tensor, at a warning
#: interval of 1 s; and its tensor (4 MB).
STALL_HOLD_S, STALL_VALUES = 3.0, 1 << 20
#: The flight-recorder part: rank 1 exits at its 6th enqueue, the second
#: of the second group of 4 CUDA tensors of 1 MB.
FAULT_SPEC, FAULT_TENSORS, FAULT_VALUES = "1:6:exit", 4, 1 << 18
#: The autotune part: the knobs swept, its seed, window and cap (16 =
#: the whole schedule of these three knobs), and the steps timed at the
#: default config before the search and at the committed one after it.
#: The tuner starts suspended (rank 0 starts it after the default
#: steps), and its post-commit watch never re-opens the search inside
#: this short run.
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_SUSPEND": "1",
                "HOROVOD_AUTOTUNE_KNOBS":
                "chunk_bytes,fusion_threshold,cycle_time_ms",
                "HOROVOD_AUTOTUNE_SEED": "7",
                "HOROVOD_AUTOTUNE_WINDOW_BYTES": str(256 << 20),
                "HOROVOD_AUTOTUNE_MAX_TRIALS": "16",
                "HOROVOD_AUTOTUNE_TRIAL_TIMEOUT_SEC": "30",
                "HOROVOD_AUTOTUNE_REPROBE_WINDOWS": str(1 << 30)}
AUTOTUNE_TIMED, AUTOTUNE_MAX_SEARCH_STEPS = 3, 40


def _write_json(path: str, obj) -> None:
    """Atomic (tmp + rename), so a reader never sees half a file."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _wait_file(path: str, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _hook_training(cfg, dev):
    """bench_llama's model under the hook form over MasterWeights(AdamW):
    (model, optimizer, step)."""
    model = train_model(cfg, dev)
    named = list(model.named_parameters())
    opt = torch_frontend.DistributedOptimizer(masterweights(model),
                                              named_parameters=named)
    return model, opt, named


def _quiet_stats(dev) -> dict:
    """A barrier, a quiet 1.5 s in which the fleet table's telemetry
    settles, then this rank's counters."""
    hvd.allreduce(torch.zeros(4, device=dev), name="obs.quiet")
    time.sleep(1.5)
    st = get_engine().stats()
    return {**{k: st[k] for k in OBS_SUM_KEYS},
            "telem_bytes_tx": st["telem_bytes_tx"],
            "stall_warnings": st["stall_warnings"],
            "flight_events": st["flight_events"],
            "flight_dumps": st["flight_dumps"], "config": st["config"]}


def observe_train(rank: int, dev, cfg, batch, mode: str,
                  directory: str) -> dict:
    """``engine_train``'s hook part, OBS_STEPS timed steps, plain or with
    the observability planes on (the env says which); then the quiet
    counters, and with the planes on a hold until the parent has scraped
    the endpoint (``ready.<rank>`` out, ``release`` in)."""
    model, opt, named = _hook_training(cfg, dev)
    part = TrainPart(dev, batch.numel() - batch.shape[0])

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss

    part.run(step, TRAIN_WARMUP, OBS_STEPS, model.parameters, f"obs.{mode}")
    out = part.report(cfg.num_layers)
    check(all(math.isfinite(x) for x in out["losses"])
          and out["losses"][-1] < out["losses"][0],
          f"observe {mode}: the loss did not fall: {out['losses']}")
    check(all(out["ranks_agree"]),
          f"observe {mode}: ranks' parameters differ: {out['ranks_agree']}")
    out = {k: out[k] for k in ("step_ms", "step_ms_p50", "step_ms_max",
                               "losses", "ranks_agree",
                               "flash_launches_per_step",
                               "engine_per_step")}
    out["steps_in_all"] = TRAIN_WARMUP + OBS_STEPS
    out["grad_names"] = [n for n, _ in named]
    out["quiet"] = _quiet_stats(dev)
    del model, opt
    free_memory()
    if mode == "on":
        _write_json(os.path.join(directory, f"ready.{rank}"), out["quiet"])
        check(_wait_file(os.path.join(directory, "release"), 300),
              "observe: the parent never released the hold")
    return out


def observe_stall(rank: int, dev) -> dict:
    """Rank 1 withholds ``stall.cuda`` (a CUDA tensor) STALL_HOLD_S under
    ``HOROVOD_STALL_WARNING_SEC=1``; rank 0's engine warns, counts,
    mirrors each warning into the flight recorder, and dumps once."""
    x = torch.full((STALL_VALUES,), float(rank + 1), device=dev)
    if rank == 1:
        time.sleep(STALL_HOLD_S)
    t = time.perf_counter()
    got = hvd.synchronize(hvd.allreduce_async(x, average=False,
                                              name="stall.cuda"))
    waited = time.perf_counter() - t
    check(got.device == dev and bool((got == 3.0).all()),
          "observe stall: the withheld allreduce is wrong")
    st = get_engine().stats()
    return {"waited_s": waited, "stall_warnings": st["stall_warnings"],
            "flight_events": st["flight_events"],
            "flight_dumps": st["flight_dumps"]}


def observe_fault(rank: int, dev) -> dict:
    """Grouped allreduces of CUDA tensors until ``HOROVOD_FAULT_INJECT``
    kills rank 1 mid-group (this rank never returns); rank 0's collective
    fails, its engine aborts and dumps the flight recorder."""
    xs = [torch.full((FAULT_VALUES,), float(i), device=dev)
          for i in range(FAULT_TENSORS)]
    try:
        for i in range(40):
            hvd.grouped_allreduce(xs, name="fault.group")
    except HorovodInternalError as e:
        st = get_engine().stats()
        return {"aborted": True, "groups_done": i, "error": str(e)[:300],
                "flight_dumps": st["flight_dumps"]}
    raise RuntimeError("observe fault: no abort came")


def observe_autotune(rank: int, dev, cfg, batch) -> dict:
    """The hook part under the engine autotuner: AUTOTUNE_TIMED steps at
    the default config, then the tuner (started on rank 0 once the
    suspension set at init is lifted) runs its search while training
    goes on, then AUTOTUNE_TIMED steps at the committed config."""
    from horovod_tpu_torch.autotune import (CoordinateSearch, default_space,
                                            start_autotuner)

    eng = get_engine()
    model, opt, named = _hook_training(cfg, dev)
    losses = []

    def step():
        opt.zero_grad()
        loss = bench.llama_loss_fn(model, batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(n):
        walls, s0 = [], eng.stats()
        for _ in range(n):
            sync()
            t = time.perf_counter()
            step()
            sync()
            walls.append((time.perf_counter() - t) * 1e3)
        d = eng.stats_delta(s0)
        return {"step_ms": walls, "step_ms_p50": statistics.median(walls),
                "bus_gb_s": d["allreduce_bus_bw_bytes_per_sec"] / 1e9,
                "allreduce_mb": d["allreduce_bytes"] / 1e6,
                "config": {k: d["config"][k] for k in (
                    "chunk_bytes", "fusion_threshold", "cycle_time_ms")}}

    step()                                       # warm-up
    check(eng.stats()["tune_trials"] == 0,
          "observe autotune: a TUNE frame came while suspended")
    before = timed(AUTOTUNE_TIMED)
    os.environ.pop("HOROVOD_AUTOTUNE_SUSPEND")
    tuner = start_autotuner(eng) if rank == 0 else None
    keep, search_steps = 1, 0
    t0 = time.monotonic()
    while keep:
        step()
        search_steps += 1
        if rank == 0:
            keep = int(not tuner.converged
                       and search_steps < AUTOTUNE_MAX_SEARCH_STEPS)
        keep = int(hvd.broadcast(torch.tensor([keep], dtype=torch.int8),
                                 root_rank=0, name="at.ctl")[0])
    search_s = time.monotonic() - t0
    keys = ("chunk_bytes", "fusion_threshold", "cycle_time_ms")
    committed = torch.full((len(keys),), -1, dtype=torch.int64)
    out = {"search_steps": search_steps, "search_s": search_s,
           "before": before, "losses": losses}
    if rank == 0:
        check(tuner.converged and tuner.committed is not None,
              f"observe autotune: no commit in {search_steps} steps")
        st = eng.stats()
        planned = CoordinateSearch(
            default_space(st["config"]["num_channels"],
                          st["config"]["priority_bands"]),
            seed=int(AUTOTUNE_ENV["HOROVOD_AUTOTUNE_SEED"]),
            max_trials=int(AUTOTUNE_ENV["HOROVOD_AUTOTUNE_MAX_TRIALS"])
        ).planned_schedule()
        check(tuner.planned == planned
              and len(tuner.trace) == len(planned)
              and all(t["config"][k] == v
                      for (k, v), t in zip(planned, tuner.trace)),
              "observe autotune: the executed schedule is not the planned "
              "one")
        committed = torch.tensor([tuner.committed[k] for k in keys],
                                 dtype=torch.int64)
        out.update(trials=len(tuner.trace), committed=tuner.committed,
                   committed_score_gb_s=(tuner.committed_score or 0) / 1e9,
                   trial_scores_gb_s=[
                       None if t["score"] is None else t["score"] / 1e9
                       for t in tuner.trace],
                   planned=[list(p) for p in planned])
    committed = hvd.broadcast(committed, root_rank=0, name="at.committed")
    out["after"] = timed(AUTOTUNE_TIMED)
    cfg_now = eng.stats()["config"]
    check(all(cfg_now[k] == int(v) for k, v in zip(keys, committed)),
          f"observe autotune: rank {rank}'s config {cfg_now} is not the "
          f"committed {committed.tolist()}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"observe autotune: the loss did not fall: {losses}")
    check(ranks_agree(model.parameters(), "at.agree"),
          "observe autotune: ranks' parameters differ")
    out["tune_trials"] = eng.stats()["tune_trials"]
    out["config_after"] = {k: cfg_now[k] for k in keys}
    del model, opt
    free_memory()
    return out


def observe_worker(rank: int, device: str, mode: str, directory: str,
                   cfg=None) -> dict:
    """One rank of the observe and autotune phases; ``mode`` is ``plain``,
    ``on``, ``stall``, ``fault`` or ``autotune``."""
    hvd.init(device=device)
    dev = hvd.device()
    cfg = cfg or bench.llama_config()
    if mode in ("plain", "on"):
        cfg = dataclasses.replace(cfg, num_layers=OBSERVE_LAYERS)
    out = {"rank": hvd.rank(), "mode": mode, "device": str(dev)}
    t0 = time.monotonic()
    if mode in ("plain", "on"):
        out.update(observe_train(rank, dev, cfg,
                                 rank_batch(cfg, rank, hvd.size(), dev),
                                 mode, directory))
    elif mode == "stall":
        out.update(observe_stall(rank, dev))
    elif mode == "fault":
        out.update(observe_fault(rank, dev))
    else:
        out.update(observe_autotune(rank, dev, cfg,
                                    rank_batch(cfg, rank, hvd.size(), dev)))
    out["wall_s"] = time.monotonic() - t0
    hvd.shutdown()
    return out


def _obs_scrape(directory: str, mport: int, into: dict) -> None:
    """The parent's side of the ``on`` run: once both ranks are quiet and
    holding, time one scrape of ``/json`` and of ``/metrics`` and run
    ``run --status`` against the endpoint; then release the ranks."""
    try:
        if not all(_wait_file(os.path.join(directory, f"ready.{r}"),
                              OBS_TIMEOUT_S) for r in range(ENGINE_RANKS)):
            into["error"] = "the ranks never reached their hold"
            return
        base = f"http://127.0.0.1:{mport}"
        for path in ("/json", "/metrics"):
            t = time.perf_counter()
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                into[path] = resp.read().decode()
            into[f"{path}_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        status = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "--status",
             f"127.0.0.1:{mport}"], capture_output=True, text=True,
            timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
        into["status"] = {"rc": status.returncode, "stdout": status.stdout,
                          "stderr": status.stderr[-2000:],
                          "s": time.perf_counter() - t}
    except Exception as e:  # noqa: BLE001 -- checked by the phase
        into["error"] = repr(e)
    finally:
        _write_json(os.path.join(directory, "release"), {})


def phase_observe() -> None:
    """``engine_train``'s hook part on two ranks sharing the card, plain
    and then with the timeline on every rank, telemetry every cycle, the
    flight recorder and rank 0's metrics endpoint; then the stall
    inspector and the flight recorder's postmortem on CUDA tensors."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    t0 = time.monotonic()
    try:
        _phase_observe(directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    emit("observe", part="phase", wall_s=time.monotonic() - t0)


def _phase_observe(directory: str) -> None:
    smi = smi_now()
    plain = run_ranks("--observe-worker", "observe_plain", OBS_TIMEOUT_S,
                      extra=("--obs-mode", "plain", "--obs-dir", directory))
    tl = os.path.join(directory, "timeline.json")
    mport = distinct_port()
    scrape: dict = {}
    scraper = threading.Thread(target=_obs_scrape,
                               args=(directory, mport, scrape))
    scraper.start()
    try:
        on = run_ranks(
            "--observe-worker", "observe_on", OBS_TIMEOUT_S,
            extra=("--obs-mode", "on", "--obs-dir", directory),
            env_extra={"HOROVOD_TIMELINE": tl,
                       "HOROVOD_TIMELINE_ALL_RANKS": "1",
                       "HOROVOD_TELEMETRY_CYCLES": "1",
                       "HOROVOD_FLIGHT_RECORDER_DIR": directory},
            rank_env={0: {"HOROVOD_METRICS_PORT": str(mport)}})
    finally:
        _write_json(os.path.join(directory, "release"), {})
        scraper.join(timeout=150)
    check("error" not in scrape, f"observe: scrape failed: "
                                 f"{scrape.get('error')}")
    payload = json.loads(scrape["/json"])
    prom = scrape["/metrics"]
    fleet = payload["fleet"]
    quiet = [r["quiet"] for r in on]
    sums = {k: sum(q[k] for q in quiet) for k in OBS_SUM_KEYS}
    check(fleet.get("ranks_reporting") == ENGINE_RANKS
          and all(fleet["totals"][k] == sums[k] for k in OBS_SUM_KEYS),
          f"observe: fleet totals {fleet.get('totals')} != the ranks' "
          f"sums {sums}")
    check("# TYPE horovod_stall_warnings_total counter" in prom
          and re.search(r'^horovod_fleet_data_bytes_tx\{rank="1",', prom,
                        re.M) is not None,
          "observe: /metrics lacks the stall counter or the per-rank "
          "series")
    status = scrape["status"]
    check(status["rc"] == 0 and "ranks reporting 2" in status["stdout"]
          and "row rank 1" in status["stdout"],
          f"observe: run --status failed: {status}")
    files = [tl, tl + ".rank1"]
    check(all(os.path.exists(f) for f in files),
          f"observe: timeline files missing: {os.listdir(directory)}")
    merged = timeline.merge_traces(files)
    nsrc, nsink, unresolved = timeline.check_flows(merged)
    sources = {e["id"]: e["ts"] for e in merged if e.get("ph") == "s"}
    late = [e["id"] for e in merged
            if e.get("ph") == "f" and e["ts"] < sources.get(e["id"], -1)]
    check(nsrc > 0 and nsink == 2 * nsrc and not unresolved
          and all(e.get("ts", 0) >= 0 for e in merged) and not late,
          f"observe: flows {nsrc} sources, {nsink} sinks, unresolved "
          f"{unresolved[:5]}, sinks before their source {late[:5]}")
    names = {str(e.get("name", "")) for e in merged} | {
        str(e.get("args", {}).get("name", "")) for e in merged}
    missing = [g for g in on[0]["grad_names"]
               if not any(g in n for n in names)]
    check(not missing, f"observe: gradients not in the timeline: "
                       f"{missing[:5]}")
    steps = on[0]["steps_in_all"]
    tl_bytes = sum(os.path.getsize(f) for f in files)
    for r in range(ENGINE_RANKS):
        emit("observe", part="train", rank=r,
             step_ms_off=plain[r]["step_ms"], step_ms_on=on[r]["step_ms"],
             step_ms_p50_off=plain[r]["step_ms_p50"],
             step_ms_p50_on=on[r]["step_ms_p50"],
             step_ms_max_off=plain[r]["step_ms_max"],
             step_ms_max_on=on[r]["step_ms_max"],
             overhead_p50=on[r]["step_ms_p50"] / plain[r]["step_ms_p50"]
             - 1.0,
             flash_launches_per_step=on[r]["flash_launches_per_step"],
             ranks_agree=on[r]["ranks_agree"],
             telem_bytes_tx=on[r]["quiet"]["telem_bytes_tx"],
             losses_on=on[r]["losses"], nvidia_smi=smi)
    emit("observe", part="timeline", files=len(files),
         timeline_mb=tl_bytes / 1e6, timeline_mb_per_step=tl_bytes / 1e6
         / steps, events=len(merged), events_per_step=len(merged) / steps,
         steps_in_all=steps, flow_sources=nsrc, flow_sinks=nsink,
         unresolved=len(unresolved), grad_names=len(on[0]["grad_names"]))
    emit("observe", part="scrape", json_ms=scrape["/json_ms"],
         metrics_ms=scrape["/metrics_ms"], json_bytes=len(scrape["/json"]),
         metrics_bytes=len(prom), status_s=status["s"],
         fleet_totals={k: fleet["totals"][k] for k in OBS_SUM_KEYS},
         per_rank_sums=sums, ranks_reporting=fleet["ranks_reporting"])

    # The stall inspector on CUDA tensors.
    stall_dir = os.path.join(directory, "stall")
    os.makedirs(stall_dir)
    stall = run_ranks("--observe-worker", "observe_stall", OBS_TIMEOUT_S,
                      extra=("--obs-mode", "stall", "--obs-dir", stall_dir),
                      env_extra={"HOROVOD_STALL_WARNING_SEC": "1",
                                 "HOROVOD_FLIGHT_RECORDER_DIR": stall_dir})
    dump = json.loads(open(os.path.join(stall_dir,
                                        "flightrec.rank0.json")).read())
    named = [e for e in dump["events"]
             if e["kind"] == "stall" and "stall.cuda" in e["text"]]
    check(1 <= stall[0]["stall_warnings"] <= 5
          and stall[0]["flight_dumps"] == 1 and named
          and "escalation" in dump["reason"]
          and "stall.cuda" in dump["reason"],
          f"observe stall: {stall[0]}, reason {dump['reason']!r}, "
          f"{len(named)} stall events name the tensor")
    emit("observe", part="stall", hold_s=STALL_HOLD_S, warning_sec=1,
         tensor_mb=STALL_VALUES * 4 / 1e6, per_rank=stall,
         dump_reason=dump["reason"], stall_events=len(named))

    # The flight recorder: rank 1 dies with CUDA tensors in flight.
    fault_dir = os.path.join(directory, "fault")
    os.makedirs(fault_dir)
    fault = run_ranks("--observe-worker", "observe_fault", OBS_TIMEOUT_S,
                      extra=("--obs-mode", "fault", "--obs-dir", fault_dir),
                      env_extra={"HOROVOD_FAULT_INJECT": FAULT_SPEC,
                                 "HOROVOD_FAULT_TIMEOUT_SEC": "6",
                                 "HOROVOD_TELEMETRY_CYCLES": "1",
                                 "HOROVOD_FLIGHT_RECORDER_DIR": fault_dir},
                      exit_codes={1: 41})
    report = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.monitor.postmortem",
         fault_dir, "--world-size", str(ENGINE_RANKS)],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    verdict = postmortem.analyze(postmortem.load_dumps(fault_dir),
                                 world_size=ENGINE_RANKS)
    check(fault[0]["aborted"] and report.returncode == 0
          and "rank 1 is the culprit" in report.stdout
          and verdict["culprit"] == 1 and verdict["missing_ranks"] == [1]
          and verdict["last_committed_cycle"] >= 1,
          f"observe fault: {fault[0]}, postmortem rc {report.returncode}:"
          f"\n{report.stdout[-3000:]}{report.stderr[-2000:]}")
    emit("observe", part="fault", spec=FAULT_SPEC, rank0=fault[0],
         culprit=verdict["culprit"], votes=verdict["votes"],
         missing_ranks=verdict["missing_ranks"],
         last_committed_cycle=verdict["last_committed_cycle"],
         report_head=report.stdout.splitlines()[:4])


def phase_autotune() -> None:
    """The hook part under ``HOROVOD_AUTOTUNE=1`` on two ranks sharing the
    card: the schedule run, the commit on every rank, the loss falling
    and the ranks' parameters equal; bus GB/s and step ms at the default
    config and at the committed one (no gain is claimed)."""
    t0 = time.monotonic()
    res = run_ranks("--observe-worker", "autotune", OBS_TIMEOUT_S,
                    extra=("--obs-mode", "autotune", "--obs-dir", "-"),
                    env_extra=AUTOTUNE_ENV)
    r0 = res[0]
    emit("autotune", knobs=AUTOTUNE_ENV["HOROVOD_AUTOTUNE_KNOBS"],
         seed=int(AUTOTUNE_ENV["HOROVOD_AUTOTUNE_SEED"]),
         window_mb=int(AUTOTUNE_ENV["HOROVOD_AUTOTUNE_WINDOW_BYTES"]) / 2**20,
         trials=r0["trials"], planned=r0["planned"],
         committed=r0["committed"],
         trial_scores_gb_s=r0["trial_scores_gb_s"],
         committed_score_gb_s=r0["committed_score_gb_s"],
         search_steps=r0["search_steps"], search_s=r0["search_s"],
         per_rank=[{k: r[k] for k in ("before", "after", "tune_trials",
                                      "config_after", "losses", "wall_s")}
                   for r in res],
         wall_s=time.monotonic() - t0, nvidia_smi=smi_now())


#: The serve tuner's run: 16 streams of 64-512-token prompts that share
#: no prefix, 96 new tokens each, greedy; windows of 16 decode steps, 6
#: trials at most.
TUNE_STREAMS, TUNE_NEW_TOKENS = 16, 96
TUNE_WINDOW_STEPS, TUNE_MAX_TRIALS = 16, 6


def serve_tune_requests(vocab: int, seed: int):
    rng = np.random.default_rng(seed + 15)
    return [Request(id=f"t{i}",
                    prompt=rng.integers(0, vocab, int(rng.integers(
                        64, 513))).tolist(), max_tokens=TUNE_NEW_TOKENS)
            for i in range(TUNE_STREAMS)]


def serve_streams(runner, cfg, reqs, timeout_s=600):
    """Every request through a fresh ``Scheduler`` at once; returns
    ({id: tokens}, the scheduler's stats, its tuner, wall s)."""
    sched = Scheduler(runner, cfg)
    done, lock, events = threading.Event(), threading.Lock(), {}

    def emit_for(rid):
        def emit_ev(ev):
            if ev["event"] in ("done", "error", "cancelled"):
                with lock:
                    events[rid] = ev
                    if len(events) == len(reqs):
                        done.set()
        return emit_ev

    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    t0 = time.monotonic()
    for req in reqs:
        sched.submit(req, emit_for(req.id))
    finished = done.wait(timeout_s)
    wall = time.monotonic() - t0
    sched.stop()
    thread.join(timeout=30)
    check(finished and not thread.is_alive(),
          f"serve_tune: {len(events)} of {len(reqs)} streams finished")
    bad = {rid: ev for rid, ev in events.items() if ev["event"] != "done"}
    check(not bad, f"serve_tune: streams failed: {bad}")
    return ({rid: ev["tokens"] for rid, ev in events.items()},
            sched.stats(), sched._tuner, wall)


def phase_serve_tune(runner, seed: int) -> None:
    """The ``serve`` phase's runner (every pow2 graph captured) under the
    serve tuner: its trials run over the captured graphs, and every
    stream's tokens equal an untuned scheduler's on the same requests."""
    reqs = serve_tune_requests(runner.model_cfg.vocab_size, seed)
    captures = runner.captures
    base = runner.serve_cfg
    plain_tokens, plain_stats, _, plain_wall = serve_streams(runner, base,
                                                             reqs)
    tuned_cfg = dataclasses.replace(
        base, autotune=1, autotune_window_steps=TUNE_WINDOW_STEPS,
        autotune_max_trials=TUNE_MAX_TRIALS)
    pa.reset_launches()
    tokens, stats, tuner, wall = serve_streams(runner, tuned_cfg, reqs)
    launches = pa.launches
    layers, steps = runner.model_cfg.num_layers, stats["decode_steps"]
    check(stats["tune_trials"] > 0 and tuner.committed is not None,
          f"serve_tune: {stats['tune_trials']} trials, committed "
          f"{tuner.committed}")
    check(runner.captures == captures,
          f"serve_tune: captures moved {captures} -> {runner.captures}")
    check(launches == layers * steps,
          f"serve_tune: B6 launches {launches} != layers x decode steps "
          f"{layers} x {steps}")
    check(stats["preemptions"] == 0 and plain_stats["preemptions"] == 0,
          "serve_tune: a stream was preempted")
    differ = [r.id for r in reqs if tokens[r.id] != plain_tokens[r.id]]
    check(not differ, f"serve_tune: streams {differ} differ from the "
                      "untuned scheduler's")
    n_tokens = sum(len(t) for t in tokens.values())
    emit("serve_tune", streams=len(reqs), new_tokens=TUNE_NEW_TOKENS,
         prompt_tokens=[len(r.prompt) for r in reqs],
         window_steps=TUNE_WINDOW_STEPS, max_trials=TUNE_MAX_TRIALS,
         trials=stats["tune_trials"], committed=tuner.committed,
         windows=[{"config": t["config"], "tokens_per_s": t["score"]}
                  for t in tuner.trace],
         tokens_per_s=n_tokens / wall, tokens_per_s_untuned=n_tokens
         / plain_wall, decode_steps=steps, decode_steps_untuned=
         plain_stats["decode_steps"], b6_launches=launches,
         captures=runner.captures, streams_equal=True,
         nvidia_smi=smi_now())


# ---------------------------------------------------------------------------
# phase 19: the rest of the model zoo, the training sugar and the examples,
# driven through each example's main(argv) on the card
# ---------------------------------------------------------------------------

#: flax_mnist_advanced's second epoch must reach this accuracy (chance is
#: 0.1; the classes are separable blobs).
ZOO_MNIST_ACC_MIN = 0.9
#: The estimator's warm-started eval metrics against the first run's.
ZOO_WARM_START_TOL = 1e-6
#: fp32 forwards on the card (TF32 off) against the CPU: max |d| over the
#: largest |value|.
ZOO_FWD_REL = 1e-5
#: The two-rank hook-form ResNet-50 run: its launcher's time limit, and
#: the device both ranks share.
ZOO_RANKS_TIMEOUT_S = 300
ZOO_HOOK_DEVICE = "cuda:0"
#: ``jax_word2vec`` at SkipGramModel's default widths.
ZOO_W2V_ARGS = ("--vocab", "50000", "--embedding", "128", "--batch-size",
                "128", "--negatives", "8", "--steps", "400")
#: The ResNet-50 examples' cut: a small synthetic set at 224².
ZOO_RESNET_ARGS = ("--n-train", "256", "--n-val", "128")
ZOO_HOOK_RESNET_ARGS = ("--n-train", "128", "--n-val", "64")


def run_example(name: str, argv) -> tuple:
    """``main(argv)`` of ``horovod_tpu_torch.examples.<name>`` in this
    process (``hvd.init()`` ran already), its stdout captured: (result,
    stdout, wall s up to a synchronised device)."""
    mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    buf = io.StringIO()
    t = time.monotonic()
    with contextlib.redirect_stdout(buf):
        out = mod.main(list(argv))
    torch.cuda.synchronize()
    text = buf.getvalue()
    check(text.rstrip().endswith("done"), f"zoo {name}: no 'done' in "
                                          f"{text[-500:]!r}")
    return out, text, time.monotonic() - t


def zoo_part(name, wall, steps, checks: dict, **info) -> dict:
    """One part's line: wall s, steps, steps/s, its ``checks`` (each must
    hold) and ``info``."""
    failed = [k for k, ok in checks.items() if not ok]
    check(not failed, f"zoo {name}: checks failed: {failed} ({info})")
    return {"wall_s": wall, "steps": steps,
            "steps_per_s": steps / wall if steps else None,
            "checks": {k: bool(v) for k, v in checks.items()}, **info}


def zoo_forwards(dev) -> dict:
    """``MnistConvNet`` and ``SkipGramModel`` (default widths) forwards on
    the card against the CPU on the same weights and inputs, fp32, TF32
    off: max |d| over the largest |value|."""
    from horovod_tpu_torch.models import MnistConvNet, SkipGramModel, \
        nce_loss

    gen = torch.Generator().manual_seed(19)
    x = torch.randn(64, 28, 28, 1, generator=gen)
    ids = [torch.randint(0, 50000, s, generator=gen)
           for s in ((128,), (128,), (128, 8))]
    mnist = MnistConvNet(dtype=torch.float32, device="cpu")
    skipgram = SkipGramModel(device="cpu")
    cases = {
        "mnist_convnet": (mnist, lambda m, d: m(x.to(d))),
        "skipgram_nce_loss": (skipgram, lambda m, d: nce_loss(
            m, *(i.to(d) for i in ids))),
        "skipgram_candidate_logits": (skipgram, lambda m, d:
                                      m.candidate_logits(m(ids[0].to(d)),
                                                         ids[2].to(d)))}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        with torch.no_grad():
            for name, (ref_model, fwd) in cases.items():
                ref = fwd(ref_model, "cpu")
                got = fwd(copy.deepcopy(ref_model).to(dev), dev).cpu()
                rel = float((got - ref).abs().max() / ref.abs().max())
                check(rel <= ZOO_FWD_REL, f"zoo forwards {name}: {rel} > "
                                          f"{ZOO_FWD_REL}")
                out[name] = rel
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return out


def zoo_hook_resnet(directory: str) -> dict:
    """``torch_imagenet_resnet50`` on two ranks sharing the card through
    ``python -m horovod_tpu_torch.run -np 2`` (the hook form's gradients
    through the engine; no torch.distributed collective runs): a first
    run trains epoch 1, a second resumes at epoch 1 and trains epoch 2."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for epochs in (1, 2):
        t = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
             "--", sys.executable, "-m",
             "horovod_tpu_torch.examples.torch_imagenet_resnet50",
             "--device", ZOO_HOOK_DEVICE, "--epochs", str(epochs),
             "--checkpoint-dir", directory, *ZOO_HOOK_RESNET_ARGS],
            env=env, capture_output=True, text=True,
            timeout=ZOO_RANKS_TIMEOUT_S)
        check(proc.returncode == 0, f"zoo torch_imagenet_resnet50 "
                                    f"(epochs {epochs}) exited "
                                    f"{proc.returncode}:\n"
                                    f"{proc.stdout[-2000:]}"
                                    f"{proc.stderr[-3000:]}")
        runs.append((proc.stdout, time.monotonic() - t))
    (first, wall1), (second, wall2) = runs
    steps = int(ZOO_HOOK_RESNET_ARGS[1]) // 2 // 32
    return zoo_part(
        "torch_imagenet_resnet50", wall1 + wall2, 2 * steps,
        {"done_both_runs": first.count("done") == 2
         and second.count("done") == 2,
         "epoch1_trained": "epoch 1: train_loss=" in first,
         "resumed": "resuming from epoch 1" in second,
         "epoch2_trained": "epoch 2: train_loss=" in second},
        ranks=2, batch=32, image=224, steps_per_rank_per_epoch=steps,
        wall_s_per_run=[wall1, wall2],
        epoch_lines=[ln for ln in (first + second).splitlines()
                     if "train_loss=" in ln])


def phase_zoo(dev) -> None:
    """The nine example counterparts' card paths (seven in this process,
    already ``hvd.init()``-ed on cuda:0; the hook-form ResNet-50 on two
    ranks), the model zoo's forwards against the CPU, one JSON line."""
    t0 = time.monotonic()
    parts = {}
    n = hvd.num_chips()

    out, _, wall = run_example("flax_mnist_advanced", ["--epochs", "2"])
    logs = out["logs"]
    parts["flax_mnist_advanced"] = zoo_part(
        "flax_mnist_advanced", wall, 2 * (4096 // 64),
        {"loss_falls": logs[1]["loss"] < logs[0]["loss"],
         "accuracy_above_min": logs[1]["accuracy"] >= ZOO_MNIST_ACC_MIN,
         "lr_is_lr_times_n": out["lr"] == 0.01 * n},
        logs=logs, accuracy_min=ZOO_MNIST_ACC_MIN, lr=out["lr"], n=n)
    del out

    model_dir = tempfile.mkdtemp(prefix="chip_smoke_zoo_est_")
    try:
        first, _, wall1 = run_example("jax_mnist_estimator",
                                      ["--model-dir", model_dir])
        second, _, wall2 = run_example("jax_mnist_estimator",
                                       ["--model-dir", model_dir])
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    m1, m2 = first["metrics"], second["metrics"]
    parts["jax_mnist_estimator"] = zoo_part(
        "jax_mnist_estimator", wall1, 4 * ((4096 - 4096 // 5) // 64),
        {"warm_started": second["start_epoch"] == 4,
         "metrics_equal": set(m1) == set(m2) and all(
             abs(m1[k] - m2[k]) <= ZOO_WARM_START_TOL for k in m1),
         "accuracy_above_min": m1["accuracy"] >= ZOO_MNIST_ACC_MIN},
        metrics=m1, warm_metrics=m2, warm_wall_s=wall2,
        warm_start_epoch=second["start_epoch"])

    out, _, wall = run_example("jax_word2vec", ZOO_W2V_ARGS)
    losses = out["losses"]
    head, tail = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    parts["jax_word2vec"] = zoo_part(
        "jax_word2vec", wall, len(losses),
        {"loss_falls": tail < head,
         "finite": bool(np.isfinite(losses).all())},
        vocab=50000, embedding=128, batch=128, negatives=8,
        step_ms=out["step_ms"], loss_first20=head, loss_last20=tail)
    del out
    gc.collect()

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_zoo_resnet_")
    argv = ["--compression", "bf16", "--checkpoint-dir", ckpt_dir,
            *ZOO_RESNET_ARGS]
    try:
        first, _, wall1 = run_example("jax_imagenet_resnet50",
                                      argv + ["--epochs", "1"])
        second, text, wall2 = run_example("jax_imagenet_resnet50",
                                          argv + ["--epochs", "2"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    logs = first["logs"] + second["logs"]
    steps = int(ZOO_RESNET_ARGS[1]) // 64
    parts["jax_imagenet_resnet50"] = zoo_part(
        "jax_imagenet_resnet50", wall1 + wall2, 2 * steps,
        {"finite": len(logs) == 2 and bool(np.isfinite(
            [lg["loss"] for lg in logs]).all()),
         "resumed": "resuming from epoch 1" in text
         and second["start_epoch"] == 1},
        batch=64, image=224, compression="bf16", steps_per_epoch=steps,
        wall_s_per_run=[wall1, wall2], logs=logs,
        val_acc=second["val_acc"])
    gc.collect()
    torch.cuda.empty_cache()

    out, _, wall = run_example("torch_mnist", [])
    parts["torch_mnist"] = zoo_part(
        "torch_mnist", wall, 4 * (4096 // 64),
        {"loss_falls": out["losses"][-1] < out["losses"][0]},
        losses=out["losses"])

    out, text, wall = run_example("torch_synthetic_benchmark", [])
    line = [ln for ln in text.splitlines() if ln.startswith("Img/sec")]
    parts["torch_synthetic_benchmark"] = zoo_part(
        "torch_synthetic_benchmark", wall, 3 * 4 + 1,
        {"printed": bool(line), "positive": out["img_sec_mean"] > 0},
        img_sec_mean=out["img_sec_mean"], img_sec_conf=out["img_sec_conf"],
        img_sec_line=line)

    hook_dir = tempfile.mkdtemp(prefix="chip_smoke_zoo_hook_")
    try:
        parts["torch_imagenet_resnet50"] = zoo_hook_resnet(hook_dir)
    finally:
        shutil.rmtree(hook_dir, ignore_errors=True)

    t = time.monotonic()
    rel = zoo_forwards(dev)
    parts["forwards"] = zoo_part("forwards", time.monotonic() - t, 0, {},
                                 rel_err=rel, tolerance=ZOO_FWD_REL)
    emit("zoo", parts=parts, wall_s=time.monotonic() - t0,
         nvidia_smi=smi_now())


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


#: What the bytecode cache is filled with: every module of the port but
#: the ones that import Keras or TensorFlow (``tf/``, ``keras/callbacks``;
#: neither package is on the card's machine), and this script.
WARM_IMPORTS = ("import importlib, os, pkgutil, horovod_tpu_torch\n"
                "SKIP = ('horovod_tpu_torch.tf', "
                "'horovod_tpu_torch.keras.callbacks')\n"
                "def walk(path, prefix):\n"
                "    for m in pkgutil.iter_modules(path, prefix):\n"
                "        if m.name in SKIP:\n"
                "            continue\n"
                "        mod = importlib.import_module(m.name)\n"
                "        if m.ispkg:\n"
                "            walk(mod.__path__, m.name + '.')\n"
                "walk(horovod_tpu_torch.__path__, 'horovod_tpu_torch.')\n"
                "import chip_smoke\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of weights, requests and kernel inputs")
    # One rank of the engine phase, started by the phase itself.
    parser.add_argument("--engine-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    # One rank of the engine_bench phase.
    parser.add_argument("--engine-bench-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    # One rank of the engine_train phase, and the parts its world runs.
    parser.add_argument("--train-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    parser.add_argument("--train-parts", default=None,
                        help=argparse.SUPPRESS)
    # One rank of the engine_moe phase.
    parser.add_argument("--moe-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    # One rank of the parallel phase.
    parser.add_argument("--parallel-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    # One rank of the parallel_zoo phase.
    parser.add_argument("--parallel-zoo-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    # One rank of the ckpt phase, and its checkpoint directory.
    parser.add_argument("--ckpt-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    parser.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    # One rank of the ckpt_kill phase (started by the launcher).
    parser.add_argument("--kill-worker", action="store_true",
                        help=argparse.SUPPRESS)
    # One rank of the observe and autotune phases, its mode and directory.
    parser.add_argument("--observe-worker", type=int, default=None,
                        metavar="RANK", help=argparse.SUPPRESS)
    parser.add_argument("--obs-mode", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--obs-dir", default=None, help=argparse.SUPPRESS)
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
    if args.engine_bench_worker is not None:
        print(json.dumps(engine_bench_worker(args.engine_bench_worker,
                                             "cuda:0")), flush=True)
        return 0
    if args.train_worker is not None:
        print(json.dumps(train_worker(
            args.train_worker, "cuda:0",
            names=args.train_parts and args.train_parts.split(","))),
              flush=True)
        return 0
    if args.moe_worker is not None:
        print(json.dumps(moe_worker(args.moe_worker, "cuda:0")), flush=True)
        return 0
    if args.parallel_worker is not None:
        print(json.dumps(parallel_worker(args.parallel_worker, "cuda:0")),
              flush=True)
        return 0
    if args.parallel_zoo_worker is not None:
        print(json.dumps(parallel_zoo_worker(args.parallel_zoo_worker,
                                             "cuda:0")), flush=True)
        return 0
    if args.ckpt_worker is not None:
        print(json.dumps(ckpt_worker(args.ckpt_worker, "cuda:0",
                                     args.ckpt_dir)), flush=True)
        return 0
    if args.kill_worker:
        kill_worker()
        return 0
    if args.observe_worker is not None:
        print(json.dumps(observe_worker(args.observe_worker, "cuda:0",
                                        args.obs_mode, args.obs_dir)),
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

    # Every process this script starts imports torch and the port anew.
    # Where the interpreter writes no bytecode (PYTHONDONTWRITEBYTECODE)
    # and the installation ships none, each such import compiles them
    # from source (8-10 s a process on an H100 host).  The processes it
    # starts share one bytecode cache in the build directory instead,
    # filled by one import of every module while the kernels build.
    os.environ["PYTHONPYCACHEPREFIX"] = str(_build.BUILD_DIR / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    t_warm = time.monotonic()
    warm = subprocess.Popen(
        [sys.executable, "-c", WARM_IMPORTS],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: warm.poll() is None and warm.kill())
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
    phase_serve_graph(runner, args.seed)
    phase_serve_tune(runner, args.seed)
    phase_profile(runner)
    del runner, served               # the fleet and training need the memory
    gc.collect()
    torch.cuda.empty_cache()
    # The first phase that starts processes: the cache is full by now.
    warm_err = warm.communicate()[1]
    check(warm.returncode == 0, f"importing every module of the port "
                                f"failed:\n{warm_err[-3000:]}")
    emit("import_cache", warm_s=time.monotonic() - t_warm,
         directory=os.environ["PYTHONPYCACHEPREFIX"])
    phase_fleet(args.seed)
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
    phase_collectives_one(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_engine()
    phase_engine_bench()
    # Both work in the processes they start: side by side.
    side_by_side(phase_engine_train, phase_engine_moe)
    moe_tokens = phase_train_moe(dev, args.seed)[1]
    gc.collect()
    torch.cuda.empty_cache()
    # Phases whose work is in the processes they start go two by two.
    side_by_side(phase_parallel, lambda: phase_ckpt(dev))
    side_by_side(phase_parallel_zoo, phase_ckpt_kill)
    phase_serve_weights(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_observe()
    phase_autotune()
    gc.collect()
    torch.cuda.empty_cache()
    phase_zoo(dev)
    gc.collect()
    torch.cuda.empty_cache()
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
    phase_train_profile("train_moe_profile", moe_factory(args.seed),
                        moe_tokens)
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
