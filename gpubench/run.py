"""The harness: one run of one workload of ``BENCHMARK.json``.

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

A run is a Horovod user's data-parallel loop on the port
(``horovod_tpu_torch``): ``hvd.init()``, the seeded weights made equal by
``broadcast_parameters``, ``step = make_train_step(model, loss,
DistributedOptimizer(inner))``, each rank stepping its own rows of a
seeded global batch.  A workload on more than one chip runs one process a
card: this process is rank 0 and starts the others.

Set-up drives the step through its first three steps (the checked
steps) and a few warm-up steps; then the window dispatches steps back to
back for ``--seconds``, with no synchronize() inside it, and ends with
one.  ``--trace 1`` then profiles a further stretch of steps.  After the
window the program's state is freed and the plain reference
(``reference/``) runs the same three steps from the same weights and
batches; ``compare.py`` decides ``correct``.

The last line of standard output is the result: ``correct``,
``attempted`` and ``failed`` (the window's steps and those whose loss is
not finite), ``metrics`` (the workload's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.  Without enough CUDA devices, or
where the program or the check cannot be found, or if JAX or the JAX
package is loaded, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from gpubench import compare, guard, manifest, metrics, optimizers
from gpubench import trace as tracing
from gpubench import weights as wts
from gpubench.flops import PEAK_BF16_FLOPS
from gpubench.reference import train as ref_train

#: The steps the reference follows.
CHECK_STEPS = 3
#: How long rank 0 waits for the other ranks after its own window.
RANK_WAIT_S = 240


def log(rank: int, msg: str) -> None:
    print(f"[gpubench rank {rank}] {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank rank 0 started
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# The world of ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free local port whose + 64 (the torch group's rendezvous) is free
    too, below the ephemeral ranges."""
    draw = random.SystemRandom()
    while True:
        port = draw.randrange(20000, 32000)
        with socket.socket() as a, socket.socket() as b:
            try:
                a.bind(("127.0.0.1", port))
                b.bind(("127.0.0.1", port + 64))
            except OSError:
                continue
            return port


def rank_env(world: int, port: int, rank: int) -> Dict[str, str]:
    """The identity ``hvd.init()`` reads.  The engine's shared-memory
    plane is off: the training path does not use the engine, and the run
    leaves nothing in /dev/shm."""
    return {"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
            "HOROVOD_LOCAL_RANK": str(rank),
            "HOROVOD_LOCAL_SIZE": str(world),
            "HOROVOD_COORDINATOR": f"127.0.0.1:{port}",
            "HOROVOD_SHM_DISABLE": "1"}


def spawn(argv: List[str], world: int, port: int,
          module: str = "gpubench") -> list:
    """Ranks 1..world-1 of ``python -m <module> <argv>``; their standard
    output goes to standard error, so only rank 0 prints a result."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    return [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(r)],
        cwd=str(manifest.ROOT), env={**base, **rank_env(world, port, r)},
        stdout=sys.stderr.fileno())
        for r in range(1, world)]


def wait_all(procs: list, timeout_s: float) -> List[Optional[int]]:
    deadline = time.monotonic() + timeout_s
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    return rcs


def stop_all(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

class Program:
    """The port's training step on a workload, built from a seed: the
    model on the benchmark's weights, ``DistributedOptimizer(inner)`` and
    ``make_train_step``, with the rank's pool of batches."""

    def __init__(self, cell: manifest.Cell, seed: int, rank: int,
                 world: int):
        import horovod_tpu_torch as hvd

        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.rank, self.world = cell, seed, rank, world
        self.family = importlib.import_module(
            f"gpubench.families.{cfg['family']}")
        self.reference = importlib.import_module(
            f"gpubench.reference.{cfg['reference']}")
        self.device = hvd.device()
        self.specs = self.reference.param_specs(cfg)
        self.model, loss_fn = self.family.build(
            cfg, wts.make(self.specs, seed, self.device))
        hvd.broadcast_parameters(self.model)
        self.inner = optimizers.make(cfg["optimizer"],
                                     self.model.parameters(), world)
        self.step = hvd.make_train_step(self.model, loss_fn,
                                        hvd.DistributedOptimizer(self.inner))
        self.pool = [self.family.block(cfg, traffic, seed, i, rank,
                                       self.device)
                     for i in range(traffic["pool"])]
        self.n = 0                      # steps taken

    def next(self):
        """Dispatch the next step on the next batch of the pool; returns
        (the pool index, the loss tensor)."""
        import torch

        i = self.n % len(self.pool)
        with torch.profiler.record_function("gpubench.step"):
            loss = self.step(self.pool[i])
        self.n += 1
        return i, loss

    def checked_steps(self) -> dict:
        """The first steps, with what the check compares: each step's loss
        (averaged over the ranks), the norm of each parameter's first
        gradient as the optimizer got it, each parameter's change after the
        steps (rank 0 keeps it on the host) and the norm of each running
        statistic's change."""
        cfg = self.cell.config
        params = dict(self.model.named_parameters())
        losses, grad_norms = [], None
        for s in range(CHECK_STEPS):
            losses.append(float(self.next()[1]))
            if s == 0:
                grad_norms = ref_train.norms(optimizers.first_gradients(
                    cfg["optimizer"], self.inner, params))
        start = wts.make(self.specs, self.seed, self.device)
        change = ({n: (p.detach() - start[n]).cpu()
                   for n, p in params.items()} if self.rank == 0 else None)
        buffers = dict(self.model.named_buffers())
        stats = ref_train.norms({n: buffers[n] - start[n]
                                 for n in self.reference.buffer_names(cfg)})
        return {"losses": losses, "grad_norms": grad_norms,
                "change": change, "stats_change_norms": stats}


def reference_numbers(cell: manifest.Cell, seed: int, world: int, device,
                      dtype=None) -> dict:
    """The reference's numbers on the same weights and batches, in fp32
    with TF32 off (``dtype`` bf16 for the control)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"gpubench.families.{cfg['family']}")
    module = importlib.import_module(f"gpubench.reference.{cfg['reference']}")
    start = wts.make(module.param_specs(cfg), seed, device)
    return ref_train.follow(
        module, cfg, start,
        lambda s, r: family.block(cfg, traffic, seed, s, r, device), world,
        CHECK_STEPS, dtype or torch.float32)


def _sync(cuda: bool) -> None:
    import torch

    if cuda:
        torch.cuda.synchronize()


def _reduce(value: float, op, ctl) -> float:
    """``value`` reduced over the ranks on the host (gloo), or itself."""
    if ctl is None:
        return value
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=op, group=ctl)
    return float(t[0])


def _still(go: bool, ctl) -> bool:
    """Rank 0's decision to go on, given to every rank through the host
    (gloo), so every rank runs the same steps without a device sync."""
    if ctl is None:
        return go
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(go)], dtype=torch.int32)
    dist.broadcast(flag, src=0, group=ctl)
    return bool(flag[0])


def _mark(cuda: bool):
    import torch

    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3


def _profile(prog: Program, steps: int, cuda: bool):
    """``steps`` steps under ``torch.profiler`` (CUPTI), reduced to a
    :class:`trace.Trace`; and the pool indices they ran.  Only the CUDA
    activity is traced (the kernels and the host's CUDA calls): tracing
    every host operator slows the host more than the step it dispatches,
    and the device would idle for the profiler."""
    from torch.profiler import ProfilerActivity, profile

    _sync(cuda)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    done = [prog.next()[0] for _ in range(steps)]
    _sync(cuda)
    prof.stop()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return tracing.from_chrome(data), done


def run_rank(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             rank: int, world: int, device: str, start: float
             ) -> Optional[dict]:
    """One rank's run.  Rank 0 returns the result; the others None."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    cuda = device == "cuda"
    cfg, traffic = cell.config, cell.traffic
    phases = {"imports": time.perf_counter() - start}
    hvd.init(device=None if cuda else "cpu")
    ctl = dist.new_group(backend="gloo") if world > 1 else None
    phases["init"] = time.perf_counter() - start
    prog = Program(cell, seed, rank, world)
    dev = prog.device
    _sync(cuda)
    phases["build"] = time.perf_counter() - start
    checked = prog.checked_steps()
    phases["checked_steps"] = time.perf_counter() - start
    for _ in range(traffic["warmup_steps"]):
        prog.next()
    _sync(cuda)
    phases["warmup"] = time.perf_counter() - start
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if ctl is not None:
        dist.barrier(group=ctl)

    t0 = time.perf_counter()
    marks, losses, done = [], [], []
    while _still(time.perf_counter() - t0 < seconds, ctl):
        marks.append(_mark(cuda))
        i, loss = prog.next()
        done.append(i)
        losses.append(loss)
    marks.append(_mark(cuda))
    _sync(cuda)
    window_s = time.perf_counter() - t0
    setup_s = t0 - start
    step_ms = [_elapsed_ms(a, b, cuda) for a, b in zip(marks, marks[1:])]
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = int(_reduce(torch.cuda.max_memory_allocated(dev) if cuda else 0,
                       dist.ReduceOp.MAX, ctl))
    log(rank, f"window: {len(done)} steps in {window_s:.3f} s, set-up "
        f"{setup_s:.3f} s (ends of its phases: " + ", ".join(
            f"{k} {v:.2f}" for k, v in phases.items()) + f"), peak {peak} B")

    tr, traced = None, []
    busy_s = None
    if trace:
        tr, traced = _profile(prog, traffic["trace_steps"], cuda)
        busy_s = _reduce(tr.busy_us() / 1e6, dist.ReduceOp.SUM,
                         ctl) / world
    fam = prog.family
    per_index = [fam.step_flops(cfg, traffic, i, world)
                 for i in range(len(prog.pool))]
    bounds = [fam.attention_bound_s(cfg, prog.pool[i]) for i in traced]
    run = metrics.Run(
        chips=world, steps=len(done),
        samples_per_step=fam.rows(traffic) * world, window_s=window_s,
        step_ms=step_ms, peak_bytes=peak, setup_s=setup_s,
        window_flops=float(sum(per_index[i] for i in done)),
        peak_flops=PEAK_BF16_FLOPS, trace=tr, traced_steps=len(traced),
        attention_bound_s=(sum(bounds) if bounds and None not in bounds
                           else None))
    del prog, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    hvd.shutdown()
    if rank != 0:
        return None

    ref = reference_numbers(cell, seed, world, dev)
    checked["change_norms"], ref["change_norms"] = compare.change_norms(
        checked["change"], ref["change"], ref["grads"])
    found = compare.numbers(checked, ref)
    found["window_nonfinite"] = {"value": float(nonfinite)}
    correct, checks = compare.judge(found, cell.limits)
    names = cell.per_layer if trace else cell.end_to_end
    values = {}
    for name in names:
        v = metrics.read(name, run)
        if v is not None:
            values[name] = {"value": v, "unit": cell.units[name]}
    result = {"correct": correct, "attempted": run.steps,
              "failed": nonfinite, "metrics": values,
              "device": device_info(dev, world, peak, cuda)}
    if trace:
        result["device"].update(busy_s=busy_s,
                                window_s=tr.window_us() / 1e6)
        result["breakdown"] = tracing.breakdown(tr)
    result["window"] = {"steps": run.steps, "seconds": window_s,
                        "traced_steps": run.traced_steps,
                        "setup_phases_s": phases,
                        "found": {k: v["value"] for k, v in found.items()},
                        "losses": checked["losses"],
                        "ref_losses": ref["losses"],
                        "where": {k: v["at"] for k, v in found.items()
                                  if "at" in v}}
    result["checks"] = checks
    return result


def device_info(dev, world: int, peak: int, cuda: bool) -> dict:
    import torch

    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": world, "memory_peak_bytes": peak}
    if cuda:
        try:
            info["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", f"--id={dev.index or 0}"],
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            info["power_limit"] = None
    return info


def _program_here() -> bool:
    """Whether the program imports from this checkout (a directory with
    the benchmark alone has none)."""
    try:
        import horovod_tpu_torch
    except ImportError as e:
        print(f"gpubench: the program cannot be imported: {e}",
              file=sys.stderr)
        return False
    where = os.path.realpath(horovod_tpu_torch.__file__)
    if not where.startswith(os.path.realpath(manifest.ROOT) + os.sep):
        print(f"gpubench: horovod_tpu_torch comes from {where}, outside "
              f"the checkout {manifest.ROOT}", file=sys.stderr)
        return False
    return True


def main(argv=None, start: Optional[float] = None) -> int:
    args = parse(argv)
    start = time.perf_counter() if start is None else start
    cell = manifest.cell(manifest.load(), args.workload)
    rank = 0 if args.rank is None else args.rank
    if args.rank is not None:
        run_rank(cell, args.seed, args.seconds, bool(args.trace), rank,
                 cell.chips, "cuda", start)
        bad = guard.forbidden_modules()
        if bad:
            log(rank, f"loaded forbidden modules: {bad}")
            return 1
        return 0

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 2
    if not _program_here():
        return 1
    procs = []
    try:
        if cell.chips > 1:
            port = free_port()
            os.environ.update(rank_env(cell.chips, port, 0))
            procs = spawn(sys.argv[1:] if argv is None else list(argv),
                          cell.chips, port)
        result = run_rank(cell, args.seed, args.seconds, bool(args.trace),
                          0, cell.chips, "cuda", start)
        rcs = wait_all(procs, RANK_WAIT_S)
    finally:
        stop_all(procs)
    if any(rc != 0 for rc in rcs):
        print(f"gpubench: ranks 1..{cell.chips - 1} exited {rcs}",
              file=sys.stderr)
        return 1
    bad = guard.forbidden_modules()
    if bad:
        print(f"gpubench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 1
    emit(result)
    return 0


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
