"""One training step of each parallelism family on an n-rank mesh.

Counterpart of ``__graft_entry__.dryrun_multichip``.  The reference jits
each step over ``n`` virtual devices in one process; here
:func:`dryrun_multichip` starts ``n`` ranks of this module (gloo, all on
one device) and each rank runs:

1. GSPMD: data x fsdp x expert x tensor on an MoE Llama
   (``shard_params`` + ``make_parallel_train_step``);
2. sequence parallelism: data x seq, ring attention
   (``make_context_parallel_train_step``);
3. pipeline parallelism: pipe x data (``make_pipelined_llama_train_step``),
   when the pipe axis is larger than 1.

Each loss must be finite and equal on every rank.

    python -m horovod_tpu_torch.parallel.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from horovod_tpu_torch.common.launch import World

__all__ = ["dryrun_multichip"]


def _factor(n: int, k: int):
    """Split n into k factors of 2 (greedy), the remainder on the first."""
    out = []
    for _ in range(k - 1):
        f = 2 if n % 2 == 0 and n > 1 else 1
        out.append(f)
        n //= f
    return [n] + out


def _families(n: int) -> dict:
    """This rank's part of the dry run (``hvd.init()`` done): the three
    families' losses."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from horovod_tpu_torch.parallel.api import (make_parallel_train_step,
                                                shard_params)
    from horovod_tpu_torch.parallel.pipeline import (
        init_pipelined_llama, make_pipelined_llama_train_step)
    from horovod_tpu_torch.parallel.seq import (
        make_context_parallel_train_step)

    dev = hvd.device()
    rng = np.random.default_rng(0)

    def tokens(vocab, batch, seq):
        return torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(dev)

    out = {}
    # -- 1. dp x fsdp x tensor x expert (MoE) -------------------------------
    data, fsdp, tensor, expert = _factor(n, 4)
    mesh = hvd.build_mesh({"data": data, "fsdp": fsdp, "expert": expert,
                           "tensor": tensor})
    cfg = LlamaConfig.tiny(num_experts=max(2 * expert, 2))
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev))
    shard_params(model, mesh)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=1e-3))
    step = make_parallel_train_step(model, opt, mesh)
    out["gspmd"] = float(step(tokens(cfg.vocab_size, 2 * data * fsdp, 33)))
    # -- 2. data x seq (ring attention) -------------------------------------
    data2, seq_shards = _factor(n, 2)
    mesh = hvd.build_mesh({"data": data2, "seq": seq_shards})
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=2)
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 1, dev))
    step = make_context_parallel_train_step(
        cfg, torch.optim.SGD(model.parameters(), lr=1e-3), mesh,
        attention="ring")
    t = tokens(cfg.vocab_size, 2 * data2, 16 * seq_shards + 1)
    out["seq"] = float(step(model, t[:, :-1], t[:, 1:]))
    # -- 3. pipe x data (pipeline) ------------------------------------------
    pipe, data3 = _factor(n, 2)
    if pipe > 1:
        mesh = hvd.build_mesh({"pipe": pipe, "data": data3})
        cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=pipe)
        model = init_pipelined_llama(cfg, init_params(cfg, 2, dev), pipe,
                                     mesh=mesh)
        step = make_pipelined_llama_train_step(
            cfg, torch.optim.SGD(model.parameters(), lr=1e-3), mesh,
            n_microbatches=2)
        t = tokens(cfg.vocab_size, 4 * data3, 17)
        out["pipeline"] = float(step(model, t[:, :-1], t[:, 1:]))
    for name, loss in out.items():
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss ({name} dry run): {loss}")
    return out


def dryrun_multichip(n_devices: int, device: str = None,
                     timeout_s: float = 300) -> list:
    """Run the three families on ``n_devices`` ranks of this module, all on
    ``device`` (default: the card; ``"cpu"`` for the CPU) over gloo.
    Returns each rank's losses; raises if a rank fails, times out, or the
    ranks' losses differ."""
    argv = [sys.executable, "-m", "horovod_tpu_torch.parallel.dryrun",
            str(n_devices), "--rank-worker"]
    with World(n_devices,
               argv + (["--device", device] if device else [])) as world:
        outputs = world.wait(timeout_s)
    results = [json.loads(text.strip().splitlines()[-1]) for text in outputs]
    if any(r != results[0] for r in results):
        raise RuntimeError(f"dry run ranks disagree: {results}")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default=None)
    parser.add_argument("--rank-worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_worker:
        import horovod_tpu_torch as hvd

        hvd.init(device=args.device, backend="gloo")
        print(json.dumps(_families(args.n)), flush=True)
        hvd.shutdown()
        return 0
    print(json.dumps(dryrun_multichip(args.n, args.device)[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
