"""Serving benchmark: open-loop Poisson load against the port's fleet.

Counterpart of the root ``bench_serve.py``.  Open loop (the serving
literature's convention): request arrival times are drawn from a Poisson
process and honored REGARDLESS of completions, so the generator measures
the system under load rather than pacing itself to it.  Each request
records submit → first token (TTFT) and submit → done latency on the
client's side of the socket.  The fleet is ``python -m
horovod_tpu_torch.run --serve`` on ``--device`` (cuda by default; cpu for
a CPU run).

    python -m horovod_tpu_torch.bench_serve [--device cpu] [--gate |
                                             --prefix-gate]

prints ONE JSON line (``horovod_tpu_torch.bench`` merges it into its line
under a ``serve_`` prefix)::

    {"metric": "serve", "tokens_per_sec": .., "req_latency_ms_p50": ..,
     "req_latency_ms_p99": .., "ttft_ms_p50": .., "ttft_ms_p99": ..,
     "batch_occupancy": .., "completed": .., "requests": ..,
     "replicas": 2, "requeued": .., "preemptions": ..,
     "kv_blocks_in_use_peak_seen": .., "device": ..}

``--gate`` is the serve gate: a short Poisson run on 2 replicas that
FAILS unless every request completes with its full nonzero token count,
continuous batching overlapped (batch occupancy > 1), a LIVE WEIGHT PUSH
lands mid-load (the seeded weights scaled by 1.25, epoch 1, lossless fp32
wire, through ``checkpoint.WeightPusher``: every replica acks epoch 1 and
every stream finishes under the one epoch that stamped its ``done``),
shutdown is clean (router exit 0) and nothing leaks — replica processes,
the router's listen socket and ``/dev/shm`` against their state before
the run.  Its line carries the push's result under ``weight_push``.

``--prefix-gate`` is the prefix-cache + fused-kernel gate: every request
shares a 24-token system prompt (6 full KV blocks) ahead of its random
suffix, and the last 2 requests repeat the first 2 verbatim.  Fleets with
fused+prefix ON and both OFF run interleaved, best of 2 per arm.  FAILS
unless the ON arm's prefix hit rate >= 0.5 with prefill tokens saved (and
exactly none on the OFF arm), the fused kernel ran on the ON arm, the
repeats stream bit-identical tokens, every request completes, occupancy
> 1, no KV block stays in use, shutdown is clean, nothing leaks, and ON
throughput >= 0.85x OFF.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np

__all__ = ["BENCH_ENV", "SYSTEM_PROMPT", "start_fleet", "stop_fleet",
           "kill_fleet", "make_plan", "run_load", "replica_procs",
           "leaks"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The reference's bench geometry (root ``bench_serve.py``), tiny model.
BENCH_ENV = {
    "HOROVOD_SERVE_BLOCK_SIZE": "4",
    "HOROVOD_SERVE_MAX_MODEL_LEN": "64",
    "HOROVOD_SERVE_MAX_BATCH": "8",
}

#: The shared system prompt of the prefix workload: 24 tokens = 6 FULL
#: KV blocks at the bench block size (4).
SYSTEM_PROMPT = [7 * i % 512 for i in range(1, 25)]



def _percentile(values, q):
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[idx]


def replica_procs(pgids):
    """Pids running the port's replica module in the process groups
    ``pgids`` (leak detection: each fleet is a process group of its own,
    so replicas of other fleets on the machine do not count)."""
    pids = set()
    for path in glob.glob("/proc/[0-9]*/cmdline"):
        pid = int(path.split("/")[2])
        try:
            with open(path, "rb") as f:
                cmd = f.read()
            if b"horovod_tpu_torch.serve.replica" in cmd and \
                    os.getpgid(pid) in pgids:
                pids.add(pid)
        except OSError:
            continue
    return pids


def _shm():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()


def start_fleet(replicas: int, *, device: str, env: dict,
                restart: int = 0, timeout: float = 300.0, extra_args=()):
    """``run.py --serve`` on an ephemeral port in its own process group
    (``extra_args`` appended, e.g. ``--serve-model DIR``); returns
    (process, router port, log lines).  ``env`` is laid over this
    process's environment."""
    full = dict(os.environ)
    full.update(env)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--serve",
         "--replicas", str(replicas), "--serve-port", "0",
         "--restart-on-failure", str(restart), "--device", device,
         *extra_args],
        env=full, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    log = []
    port = None
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        log.append(line)
        m = re.search(r"SERVE_ROUTER_READY port=(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        stop_fleet(proc)
        raise RuntimeError("router never became ready:\n" + "".join(log))
    threading.Thread(target=lambda: [log.append(ln) for ln in
                                     iter(proc.stdout.readline, "")],
                     daemon=True).start()
    return proc, port, log


def stop_fleet(proc, cli=None, timeout: float = 120.0) -> int:
    """Ask the router to shut down (when a client is given), wait, and
    kill the whole process group if it is still there; returns the
    router's exit code (-9 when it had to be killed)."""
    rc = None
    if cli is not None:
        cli.shutdown()
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
    if rc is None and proc.poll() is None:
        kill_fleet(proc)
        rc = -9
    elif rc is None:
        rc = proc.returncode
    if cli is not None:
        cli.close()
    return rc


def kill_fleet(proc) -> None:
    """Kill the fleet's whole process group (router and replicas)."""
    try:
        os.killpg(proc.pid, 9)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def make_plan(requests: int, rate_hz: float, *, seed: int = 0,
              vocab: int = 512, prompt_lo: int = 3, prompt_hi: int = 11,
              max_tokens_lo: int = 8, max_tokens_hi: int = 24,
              system_prompt=None, dup_tail: int = 0):
    """[(arrival s, prompt, max_tokens)]: Poisson arrivals at ``rate_hz``,
    prompts of ``prompt_lo``–``prompt_hi`` tokens under an optional
    shared ``system_prompt``; the last ``dup_tail`` requests repeat the
    first ones verbatim (prompt AND token budget)."""
    rng = np.random.default_rng(seed)
    head = list(system_prompt or [])
    plan = []
    t = 0.0
    for i in range(requests):
        t += float(rng.exponential(1.0 / rate_hz))
        prompt = head + rng.integers(
            0, vocab, int(rng.integers(prompt_lo, prompt_hi + 1))).tolist()
        n = int(rng.integers(max_tokens_lo, max_tokens_hi + 1))
        if dup_tail and i >= requests - dup_tail:
            _, prompt, n = plan[i - (requests - dup_tail)]
        plan.append((t, prompt, n))
    return plan


def _push_tree(env: dict, scale: float = 1.25):
    """The weights the gate pushes: the fleet's seeded weights (on the
    CPU, in the JAX package's paths and layout, as the reference's gate
    pushes ``runner.variables``) times ``scale``."""
    from horovod_tpu_torch.models.convert import init_params, params_to_jax
    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import build_model_config

    serve_cfg = ServeConfig.from_env(env)
    cfg = build_model_config(serve_cfg)
    tree = params_to_jax(init_params(cfg, serve_cfg.param_seed, "cpu"), cfg)

    def scaled(node):
        if isinstance(node, dict):
            return {k: scaled(v) for k, v in node.items()}
        return (node * np.float32(scale)).astype(np.float32)

    return scaled(tree)


def run_load(port: int, plan, *, timeout: float = 600.0, push_at: int = -1,
             push=None, push_wire: str = "fp32"):
    """Drive the open-loop ``plan`` (:func:`make_plan`) against the
    router; returns (client, per-request records, aggregate dict).  Each
    record holds the request's events, its final ``tokens`` and whether
    it was ``requeued``.  ``push_at >= 0`` pushes the tree ``push``
    (epoch 1, ``push_wire``) right after that request is submitted, from a
    thread, so the Poisson clock stays honest; the aggregate then carries
    the push's result."""
    from horovod_tpu_torch.serve.server import ServeClient

    cli = ServeClient("127.0.0.1", port, timeout=timeout)
    push_acks, push_thread = [], None

    def _push():
        from horovod_tpu_torch.checkpoint import WeightPusher

        pusher = WeightPusher("127.0.0.1", port, timeout=timeout)
        try:
            t = time.monotonic()
            push_acks.append(pusher.push(push, epoch=1, wire=push_wire))
            push_acks.append(time.monotonic() - t)
        finally:
            pusher.close()

    records = {}
    t0 = time.monotonic()
    for i, (due, prompt, n) in enumerate(plan):
        now = time.monotonic() - t0
        if now < due:
            time.sleep(due - now)
        rid = f"load{i}"
        records[rid] = {"submit": time.monotonic(), "n": n}
        cli.start_generate(rid, prompt, max_tokens=n)
        if i == push_at:
            push_thread = threading.Thread(target=_push, daemon=True)
            push_thread.start()
    for i in range(len(plan)):
        rid = f"load{i}"
        evs = cli.collect(rid, timeout=timeout)
        rec = records[rid]
        rec["events"] = evs
        rec["ok"] = (evs[-1]["event"] == "done"
                     and len(evs[-1]["tokens"]) == rec["n"]
                     and rec["n"] > 0)
        rec["requeued"] = any(e["event"] == "requeued" for e in evs)
        rec["tokens"] = evs[-1].get("tokens", []) \
            if evs[-1]["event"] == "done" else []
    wall = time.monotonic() - t0

    lat, ttft = [], []
    total_tokens = completed = requeued = 0
    for rec in records.values():
        if not rec["ok"]:
            continue
        completed += 1
        total_tokens += len(rec["tokens"])
        lat.append((rec["events"][-1]["_recv_ts"] - rec["submit"]) * 1e3)
        # A requeued stream restarts at index 0: its first token is the
        # first one the client saw.
        first = next(e for e in rec["events"] if e["event"] == "token")
        ttft.append((first["_recv_ts"] - rec["submit"]) * 1e3)
        requeued += int(rec["requeued"])
    stats = cli.stats()
    scheds = [r.get("scheduler", {}) for r in stats["replicas"]]
    agg = {
        "metric": "serve",
        "requests": len(plan),
        "completed": completed,
        "tokens": total_tokens,
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(total_tokens / wall, 2),
        "req_latency_ms_p50": round(_percentile(lat, 50), 1),
        "req_latency_ms_p99": round(_percentile(lat, 99), 1),
        "ttft_ms_p50": round(_percentile(ttft, 50), 1),
        "ttft_ms_p99": round(_percentile(ttft, 99), 1),
        "requeued": requeued,
        "router": stats["router"],
        "batch_occupancy": max(
            (s.get("batch_occupancy", 0.0) for s in scheds), default=0.0),
        "preemptions": sum(s.get("preemptions", 0) for s in scheds),
        "kv_blocks_in_use_peak_seen": max(
            (s.get("kv_blocks_in_use", 0) for s in scheds), default=0),
        "kv_blocks_in_use_final": sum(s.get("kv_blocks_in_use", 0)
                                      for s in scheds),
    }
    for key in ("prefix_hits", "prefix_misses", "prefix_evictions",
                "cow_forks", "fused_attn_steps", "prefill_tokens_saved"):
        agg[key] = sum(s.get(key, 0) for s in scheds)
    attempts = agg["prefix_hits"] + agg["prefix_misses"]
    agg["prefix_hit_rate"] = round(agg["prefix_hits"] / attempts, 3) \
        if attempts else 0.0
    if push_at >= 0:
        if push_thread is not None:
            push_thread.join(timeout=timeout)
        ack = push_acks[0] if push_acks else {}
        agg["weight_push"] = {
            "pushes": stats["router"].get("weight_pushes", 0),
            "acked": bool(ack.get("replicas")) and all(
                r.get("applied") for r in ack["replicas"]),
            "replica_weight_epochs": [s.get("weight_epoch")
                                      for s in scheds],
            "stream_weight_epochs": sorted({
                rec["events"][-1].get("weight_epoch")
                for rec in records.values() if rec["ok"]}),
            "restarted": sum(r.get("restarted") or 0
                             for r in ack.get("replicas", [])),
            "requeued_for_weights": sum(
                1 for rec in records.values() for e in rec["events"]
                if e["event"] == "requeued"
                and e.get("reason") == "weights"),
            "push_s": push_acks[1] if len(push_acks) > 1 else None}
    return cli, records, agg


def _dup_exact(records, requests: int, dup_tail: int) -> bool:
    return all(records[f"load{requests - dup_tail + j}"]["tokens"]
               == records[f"load{j}"]["tokens"] for j in range(dup_tail))


def leaks(pgids, shm_before, ports=()):
    """Replica processes left in the fleets' process groups, router ports
    still accepting, and new ``/dev/shm`` entries, as failure messages.
    Stragglers get 20 s to go (entries other programs create and remove
    meanwhile go with them)."""
    deadline = time.time() + 20
    while time.time() < deadline and (replica_procs(pgids)
                                      or _shm() - shm_before):
        time.sleep(0.5)
    failures = []
    leaked = replica_procs(pgids)
    if leaked:
        failures.append(f"leaked replica processes: {sorted(leaked)}")
    for port in ports:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=2):
                failures.append(f"router port {port} still accepting "
                                "connections")
        except OSError:
            pass
    shm = _shm() - shm_before
    if shm:
        failures.append(f"leaked /dev/shm entries: {sorted(shm)}")
    return failures


def _fleet_run(replicas, device, env, plan, dup_tail=0, push_at=-1):
    """One fleet: start, drive ``plan`` (with a weight push after request
    ``push_at`` when it is >= 0), shut down; the aggregate with
    ``clean_shutdown``, the port and the log's tail folded in."""
    full_env = dict(BENCH_ENV, **env)
    # Built before the fleet: model init must not distort the arrivals.
    push = _push_tree(full_env) if push_at >= 0 else None
    proc, port, log = start_fleet(replicas, device=device, env=full_env)
    cli = None
    try:
        cli, records, agg = run_load(port, plan, push_at=push_at, push=push)
    finally:
        rc = stop_fleet(proc, cli)
    agg["replicas"] = replicas
    agg["device"] = device
    agg["clean_shutdown"] = rc == 0
    agg["port"] = port
    agg["pgid"] = proc.pid
    agg["log_tail"] = "".join(log[-40:])
    if dup_tail:
        agg["dup_exact"] = _dup_exact(records, len(plan), dup_tail)
    return agg


def _main(device: str, replicas: int, requests: int, rate_hz: float) -> dict:
    agg = _fleet_run(replicas, device, {},
                     make_plan(requests, rate_hz))
    for key in ("router", "port", "pgid", "log_tail"):
        agg.pop(key)
    return agg


def _gate(device: str) -> int:
    """The serve gate — see the module docstring."""
    shm_before = _shm()
    requests, replicas = 24, 2
    # The push lands mid-load, so a real set of streams is in flight when
    # the swap lands.
    agg = _fleet_run(replicas, device, {}, make_plan(requests, 6.0),
                     push_at=requests // 2)
    log_tail, port, pgid = agg.pop("log_tail"), agg.pop("port"), \
        agg.pop("pgid")
    print(json.dumps(agg))

    failures = []
    if agg["completed"] != requests:
        failures.append(f"only {agg['completed']}/{requests} requests "
                        "completed with their full token count")
    if agg["batch_occupancy"] <= 1.0:
        failures.append(f"batch occupancy {agg['batch_occupancy']:.2f} "
                        "<= 1.0: continuous batching never overlapped")
    if agg["tokens_per_sec"] <= 0:
        failures.append("zero streamed tokens")
    push = agg["weight_push"]
    if push["pushes"] != 1 or not push["acked"]:
        failures.append(f"live weight push did not land: pushes="
                        f"{push['pushes']} acked={push['acked']}")
    if push["replica_weight_epochs"] != [1] * replicas:
        failures.append("replicas not all at the pushed weight epoch: "
                        f"{push['replica_weight_epochs']}")
    if not set(push["stream_weight_epochs"]) <= {0, 1}:
        failures.append(f"mixed-epoch streams: "
                        f"{push['stream_weight_epochs']}")
    if not agg["clean_shutdown"]:
        failures.append("unclean router shutdown")
    failures += leaks({pgid}, shm_before, [port])
    if failures:
        for f in failures:
            print(f"SERVE GATE FAIL: {f}", file=sys.stderr)
        print(log_tail, file=sys.stderr)
        return 1
    print(f"SERVE GATE OK: {requests} requests, "
          f"{agg['tokens_per_sec']} tok/s, occupancy "
          f"{agg['batch_occupancy']:.2f}, p99 "
          f"{agg['req_latency_ms_p99']:.0f} ms, weight push at epoch 1 "
          f"on every replica ({push['restarted']} streams restarted), "
          "clean shutdown")
    return 0


def _prefix_gate(device: str) -> int:
    """The prefix-cache + fused-kernel gate — see the module docstring."""
    shm_before = _shm()
    requests, dup_tail = 20, 2
    plan = make_plan(requests, 8.0, system_prompt=SYSTEM_PROMPT,
                     dup_tail=dup_tail)
    # Both arms build their whole program menu before READY
    # (HOROVOD_SERVE_WARMUP), so the measured window compares serving,
    # not first-use set-up.
    arms = {
        "on": {"HOROVOD_SERVE_FUSED_ATTN": "1",
               "HOROVOD_SERVE_PREFIX_CACHE": "1",
               "HOROVOD_SERVE_WARMUP": "64"},
        "off": {"HOROVOD_SERVE_FUSED_ATTN": "0",
                "HOROVOD_SERVE_PREFIX_CACHE": "0",
                "HOROVOD_SERVE_WARMUP": "64"},
    }
    # Interleaved best-of-2 per arm: alternating runs share whatever
    # machine noise drifts.
    runs = {"on": [], "off": []}
    for _ in range(2):
        for arm in ("off", "on"):
            runs[arm].append(_fleet_run(2, device, arms[arm], plan,
                                        dup_tail=dup_tail))
    best = {arm: max(rs, key=lambda a: a["tokens_per_sec"])
            for arm, rs in runs.items()}
    on, off = best["on"], best["off"]

    out = {"metric": "serve_prefix", "requests": requests, "device": device}
    for arm, agg in best.items():
        for key in ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99",
                    "req_latency_ms_p99", "batch_occupancy", "completed",
                    "prefix_hit_rate", "prefill_tokens_saved",
                    "prefix_hits", "cow_forks", "fused_attn_steps",
                    "dup_exact", "clean_shutdown",
                    "kv_blocks_in_use_final"):
            out[f"{key}_{arm}"] = agg.get(key)
    out["throughput_ratio"] = round(
        on["tokens_per_sec"] / max(1e-9, off["tokens_per_sec"]), 3)
    print(json.dumps(out))

    failures = []
    for arm, agg in best.items():
        if agg["completed"] != requests:
            failures.append(f"[{arm}] only {agg['completed']}/{requests} "
                            "requests completed with their full token "
                            "count")
        if not agg["dup_exact"]:
            failures.append(f"[{arm}] verbatim repeat streamed DIFFERENT "
                            "tokens than its original")
        if agg["batch_occupancy"] <= 1.0:
            failures.append(f"[{arm}] batch occupancy "
                            f"{agg['batch_occupancy']:.2f} <= 1.0: "
                            "continuous batching never overlapped")
        if agg["kv_blocks_in_use_final"] != 0:
            failures.append(f"[{arm}] {agg['kv_blocks_in_use_final']} KV "
                            "blocks still in use after all streams "
                            "finished (leak)")
    for arm, rs in runs.items():
        if not all(a["clean_shutdown"] for a in rs):
            failures.append(f"[{arm}] unclean router shutdown")
    if on["prefix_hit_rate"] < 0.5:
        failures.append(f"prefix hit rate {on['prefix_hit_rate']} < 0.5 on "
                        "the shared-system-prompt workload")
    if on["prefill_tokens_saved"] <= 0:
        failures.append("prefix cache saved zero prefill tokens")
    if on["fused_attn_steps"] <= 0:
        failures.append("fused kernel never ran on the ON arm")
    if off["prefix_hits"] != 0 or off["prefill_tokens_saved"] != 0:
        failures.append("OFF arm touched the prefix cache: hits="
                        f"{off['prefix_hits']} saved="
                        f"{off['prefill_tokens_saved']}")
    if on["tokens_per_sec"] < 0.85 * off["tokens_per_sec"]:
        failures.append(f"fused+prefix throughput {on['tokens_per_sec']} "
                        f"tok/s < 0.85x baseline {off['tokens_per_sec']} "
                        "tok/s")
    failures += leaks({a["pgid"] for rs in runs.values() for a in rs},
                      shm_before, [a["port"] for rs in runs.values()
                                   for a in rs])
    if failures:
        for f in failures:
            print(f"SERVE PREFIX GATE FAIL: {f}", file=sys.stderr)
        for arm, agg in best.items():
            print(f"--- [{arm}] log tail ---\n" + agg["log_tail"],
                  file=sys.stderr)
        return 1
    print(f"SERVE PREFIX GATE OK: hit_rate={on['prefix_hit_rate']}, "
          f"saved={on['prefill_tokens_saved']} prefill tokens, "
          f"{on['tokens_per_sec']} tok/s on vs {off['tokens_per_sec']} "
          f"off (ratio {out['throughput_ratio']}), repeats bit-exact, "
          "no leaks")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="the replicas' device: cuda (default) or cpu")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--gate", action="store_true",
                      help="the serve gate (2 replicas, 24 requests)")
    mode.add_argument("--prefix-gate", action="store_true",
                      help="the prefix-cache + fused-kernel gate")
    args = parser.parse_args(argv)
    if args.gate:
        return _gate(args.device)
    if args.prefix_gate:
        return _prefix_gate(args.device)
    print(json.dumps(_main(
        args.device,
        replicas=int(os.environ.get("HOROVOD_SERVE_BENCH_REPLICAS", "2")),
        requests=int(os.environ.get("HOROVOD_SERVE_BENCH_REQUESTS", "40")),
        rate_hz=float(os.environ.get("HOROVOD_SERVE_BENCH_RATE", "6")))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
