"""The readings the check's limits are set from (not run by the benchmark).

    python3 -m gpubench.calibrate --workload <name> --seeds 1,2,3 \
        --mode program|program_fp32|control|half_batch|no_exchange|unchanged

For every seed, the compared numbers of one kind of run against the
fp32 reference, one JSON line each on standard output:

* ``program``: the program's checked steps, as a benchmark run takes them
  (the lower reading of each number);
* ``program_fp32``: the same with the configuration's compute dtype set
  to float32, a witness of what the program's bf16 compute alone adds;
* ``control``: the reference itself in the program's place, computed in
  bfloat16 (parameters, gradients and optimizer state): the precision
  below the configuration's fp32 parameters;
* ``half_batch``, ``no_exchange``, ``unchanged``: the program with a fault
  planted underneath the step: each rank's step takes only the first half
  of its rows (the mean over those); ``DistributedOptimizer`` leaves out
  the gradient exchange between ranks; the optimizer's step is skipped.

A workload on several chips runs one process a card, as the benchmark
does.  The program's steps of every seed run first; then the ranks shut
down and rank 0 runs the references.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from gpubench import compare, manifest
from gpubench import run as harness

MODES = ("program", "program_fp32", "control", "half_batch", "no_exchange",
         "unchanged")


def plant(mode: str, patch=setattr) -> None:
    """Break the program underneath the timed path, in this process
    (``patch``: ``setattr``, or a test's ``monkeypatch.setattr``)."""
    import horovod_tpu_torch as hvd

    if mode == "unchanged":
        patch(hvd.DistributedOptimizer, "step", lambda self: None)
    elif mode == "no_exchange":
        patch(hvd.DistributedOptimizer, "synchronize", lambda self: None)
    elif mode == "half_batch":
        make = hvd.make_train_step

        def halved(model, loss_fn, opt):
            step = make(model, loss_fn, opt)
            return lambda batch: step({k: v[: v.shape[0] // 2]
                                       for k, v in batch.items()})
        patch(hvd, "make_train_step", halved)


def program_steps(cell, seeds, rank, world, mode, device) -> list:
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=None if device == "cuda" else "cpu")
    if mode not in ("program", "program_fp32"):
        plant(mode)
    out = []
    for seed in seeds:
        prog = harness.Program(cell, seed, rank, world)
        out.append(prog.checked_steps())
        del prog
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    dev = hvd.device()
    hvd.shutdown()
    return out, dev


def readings(cell, seeds, mode, rank, world, device) -> list:
    """Rank 0's compared numbers of each seed (None on other ranks)."""
    import torch

    if mode == "control":
        dev = torch.device(device, 0) if device == "cuda" else \
            torch.device("cpu")
        checked = [None] * len(seeds)
    else:
        checked, dev = program_steps(cell, seeds, rank, world, mode, device)
    if rank != 0:
        return None
    lines = []
    for seed, prog in zip(seeds, checked):
        ref = harness.reference_numbers(cell, seed, world, dev)
        if prog is None:
            prog = harness.reference_numbers(cell, seed, world, dev,
                                             torch.bfloat16)
        prog["change_norms"], ref["change_norms"] = compare.change_norms(
            prog["change"], ref["change"], ref["grads"])
        found = compare.numbers(prog, ref)
        lines.append({"workload": cell.name, "mode": mode, "seed": seed,
                      **{k: v["value"] for k, v in found.items()},
                      "at": {k: v["at"] for k, v in found.items()},
                      "losses": prog["losses"], "ref_losses": ref["losses"]})
        del ref, prog
        gc.collect()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--mode", choices=MODES, default="program")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    if args.mode == "program_fp32":
        cell.config["training"]["compute_dtype"] = "float32"
    seeds = [int(s) for s in args.seeds.split(",")]
    rank = args.rank or 0
    procs = []
    if args.rank is None and cell.chips > 1 and args.mode != "control":
        port = harness.free_port()
        os.environ.update(harness.rank_env(cell.chips, port, 0))
        procs = harness.spawn(sys.argv[1:] if argv is None else list(argv),
                              cell.chips, port, "gpubench.calibrate")
    try:
        t = time.perf_counter()
        lines = readings(cell, seeds, args.mode, rank, cell.chips, "cuda")
        rcs = harness.wait_all(procs, harness.RANK_WAIT_S)
    finally:
        harness.stop_all(procs)
    if lines is None:
        return 0
    for line in lines:
        print(json.dumps(line), flush=True)
    print(f"calibrate {args.workload} {args.mode}: {len(lines)} seeds in "
          f"{time.perf_counter() - t:.1f} s, ranks {rcs}", file=sys.stderr)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
