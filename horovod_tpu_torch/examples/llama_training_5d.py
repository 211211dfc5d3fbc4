"""Llama training with configurable multi-axis parallelism — the flagship.

Counterpart of ``examples/llama_training_5d.py``: one model family under
every parallelism strategy the port ships:

    --strategy gspmd     data x fsdp x tensor (x expert with --experts):
                         shard_params + make_parallel_train_step
    --strategy seq       ring / Ulysses context parallelism x data:
                         make_context_parallel_train_step
    --strategy pipeline  GPipe stages x data:
                         make_pipelined_llama_train_step

One process per rank (``HOROVOD_RANK``/``HOROVOD_SIZE``/
``HOROVOD_COORDINATOR``; a world of one without them), tiny synthetic LM
data.  Every rank draws the same global batch from one seed and keeps its
own block (the reference draws it in one process), and the same seeded
weights.

    python -m horovod_tpu_torch.examples.llama_training_5d --smoke \\
        [--strategy gspmd|seq|pipeline] [--experts 4] [--device cpu]

Runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

__all__ = ["main"]


def _adamw(params, lr):
    """optax.adamw's defaults over fp32 masters of the params."""
    from horovod_tpu_torch.ops.mixed_precision import MasterWeights

    return MasterWeights(params, torch.optim.AdamW, lr=lr,
                         betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def main(argv=None) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import example_args
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from horovod_tpu_torch.ops.flash_attention import flash_attention_fn
    from horovod_tpu_torch.parallel.api import (make_parallel_train_step,
                                                shard_params)
    from horovod_tpu_torch.parallel.pipeline import (
        init_pipelined_llama, make_pipelined_llama_train_step)
    from horovod_tpu_torch.parallel.seq import (
        make_context_parallel_train_step)

    args = example_args("Llama multi-axis parallel training", argv,
                        batch_size=8, lr=1e-3, steps=20, seq_len=64,
                        strategy="gspmd", tensor=2, experts=0, pipe=2,
                        seq_shards=2)
    hvd.init(device=args.device)
    dev = hvd.device()
    n = hvd.size()
    steps = 3 if args.smoke else args.steps
    seq = 32 if args.smoke else args.seq_len
    rng = np.random.default_rng(0)

    def tokens(batch, vocab):
        return torch.from_numpy(rng.integers(0, vocab, (batch, seq + 1))
                                ).to(dev)

    def report(i, loss):
        if hvd.rank() == 0:
            print(f"step {i}: loss={float(loss):.4f}", flush=True)

    if args.strategy == "gspmd":
        tensor = min(args.tensor, n)
        rest = n // tensor
        fsdp = 2 if rest % 2 == 0 else 1
        axes = {"data": rest // fsdp, "fsdp": fsdp, "tensor": tensor}
        cfg = (LlamaConfig.tiny(num_experts=args.experts) if args.smoke
               else dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=4,
                                        num_experts=args.experts))
        if args.experts:
            axes["expert"] = 1  # experts shard over tensor-free capacity
        mesh = hvd.build_mesh(axes)
        with hvd.use_mesh(mesh):
            model = LlamaModel.from_state_dict(
                cfg, init_params(cfg, 0, dev), attention_fn=flash_attention_fn)
            shard_params(model, mesh)
            opt = hvd.DistributedOptimizer(_adamw(model.parameters(),
                                                  args.lr))
            step = make_parallel_train_step(model, opt, mesh)
            for i in range(steps):
                report(i, step(tokens(args.batch_size, cfg.vocab_size)))
    elif args.strategy == "seq":
        seq_shards = min(args.seq_shards, n)
        mesh = hvd.build_mesh({"data": n // seq_shards, "seq": seq_shards})
        cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=2)
        model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev))
        step = make_context_parallel_train_step(
            cfg, _adamw(model.parameters(), args.lr), mesh)
        for i in range(steps):
            t = tokens(args.batch_size, cfg.vocab_size)
            report(i, step(model, t[:, :-1], t[:, 1:]))
    elif args.strategy == "pipeline":
        pipe = min(args.pipe, n)
        mesh = hvd.build_mesh({"pipe": pipe, "data": n // pipe})
        cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=2 * pipe)
        model = init_pipelined_llama(cfg, init_params(cfg, 0, dev), pipe,
                                     mesh=mesh)
        step = make_pipelined_llama_train_step(
            cfg, _adamw(model.parameters(), args.lr), mesh, n_microbatches=2)
        for i in range(steps):
            t = tokens(args.batch_size, cfg.vocab_size)
            report(i, step(model, t[:, :-1], t[:, 1:]))
    else:
        raise SystemExit(f"unknown strategy {args.strategy}")
    print("done", flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
