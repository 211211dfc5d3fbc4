"""Port parity: the paged-KV serving replica on the CPU.

The port's ``PagedKVCache``, ``ModelRunner``, ``Scheduler``,
``ReplicaServer``/``ServeClient`` and replica entry point, held against
the JAX package: the runner serves the JAX runner's weights (carried over
by ``params_from_jax``) in fp32, and every greedy stream must be
token-identical to the JAX offline reference ``jax.jit(generate)`` at the
serving cache geometry (``cache_len = max_model_len``), under a pool
tight enough to force preemption.
"""

import asyncio
import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models.generation import generate as jax_generate
from horovod_tpu.serve.config import ServeConfig as JaxServeConfig
from horovod_tpu.serve.config import \
    resolved_serve_config as jax_resolved_serve_config
from horovod_tpu.serve.engine import ModelRunner as JaxModelRunner
from horovod_tpu_torch.models.convert import params_from_jax
from horovod_tpu_torch.models.llama import LlamaModel
from horovod_tpu_torch.serve.config import ServeConfig, resolved_serve_config
from horovod_tpu_torch.serve.engine import ModelRunner
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK, PagedKVCache
from horovod_tpu_torch.serve.scheduler import Request, Scheduler
from horovod_tpu_torch.serve.server import ReplicaServer, ServeClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The reference's scheduler corpus env (tests/test_serve.py): the pool
#: is deliberately tight so preemption fires; fp32 so the two frameworks'
#: logits agree to ~1e-6 and greedy streams match token for token.
SERVE_ENV = {
    "HOROVOD_SERVE_BLOCK_SIZE": "4",
    "HOROVOD_SERVE_KV_BLOCKS": "10",
    "HOROVOD_SERVE_MAX_MODEL_LEN": "64",
    "HOROVOD_SERVE_MAX_BATCH": "4",
    "HOROVOD_SERVE_DTYPE": "float32",
}


# ---------------------------------------------------------------------------
# kv_cache: pure block accounting (the reference's cases on the port's copy)
# ---------------------------------------------------------------------------

def test_kv_cache_fund_grow_free_recycle():
    kv = PagedKVCache(num_blocks=8, block_size=4, max_blocks_per_seq=4)
    assert kv.capacity_blocks == 7
    assert kv.allocate(1, 9)
    assert kv.blocks_in_use == 3
    assert TRASH_BLOCK not in kv.table(1)
    assert kv.append_slot(1, 12)
    assert kv.blocks_in_use == 3
    assert kv.append_slot(1, 13)
    assert kv.blocks_in_use == 4
    assert kv.free(1) == 4 and kv.blocks_in_use == 0
    assert kv.allocate(2, 4 * 4)
    assert kv.blocks_in_use == 4 and kv.free_blocks == 3
    assert kv.stats()["kv_blocks_freed_total"] == 4
    assert kv.stats()["kv_blocks_allocated_total"] == 8


def test_kv_cache_all_or_nothing_refusal():
    kv = PagedKVCache(num_blocks=6, block_size=4, max_blocks_per_seq=8)
    assert kv.allocate(1, 12)
    assert not kv.allocate(2, 12)
    assert kv.blocks_in_use == 3 and kv.free_blocks == 2
    assert kv.allocate(2, 8)
    assert not kv.append_slot(2, 9)
    kv.free(1)
    assert kv.append_slot(2, 9)
    kv2 = PagedKVCache(num_blocks=16, block_size=4, max_blocks_per_seq=2)
    assert not kv2.allocate(1, 9)
    assert kv2.fits_model(8) and not kv2.fits_model(9)


def test_kv_cache_table_array_pads_with_trash():
    kv = PagedKVCache(num_blocks=8, block_size=4, max_blocks_per_seq=6)
    kv.allocate(5, 6)
    arr = kv.table_array(5, 6)
    assert arr.dtype == np.int32 and arr.shape == (6,)
    assert list(arr[:2]) == kv.table(5)
    assert (arr[2:] == TRASH_BLOCK).all()


def test_prefix_cache_accounting_share_evict_flush():
    kv = PagedKVCache(num_blocks=8, block_size=4, max_blocks_per_seq=8,
                      prefix_cache=True)
    prompt = list(range(100, 112))
    assert kv.allocate_prefix(1, prompt) == 0
    kv.register_prefix(1, prompt)
    kv.assert_consistent()
    assert kv.allocate_prefix(2, prompt) == 2
    kv.assert_consistent()
    assert kv.prefix_hits == 2 and kv.cow_forks == 1
    assert kv.table(2)[:2] == kv.table(1)[:2]
    assert kv.table(2)[2] != kv.table(1)[2]
    assert kv.allocate_prefix(3, prompt[:4] + [999] * 8) == 1
    kv.assert_consistent()
    kv.free(1)
    kv.assert_consistent()
    assert kv.blocks_in_use + kv.cached_blocks + kv.free_blocks == \
        kv.capacity_blocks
    kv.free(2)
    kv.free(3)
    kv.assert_consistent()
    assert kv.blocks_in_use == 0
    assert kv.cached_blocks >= 3
    assert kv.can_fund(7 * 4)
    assert kv.allocate_prefix(4, list(range(500, 528))) == 0
    kv.assert_consistent()
    assert kv.prefix_evictions > 0
    kv.free(4)
    kv.flush_prefix()
    kv.assert_consistent()
    assert kv.cached_blocks == 0 and kv.blocks_in_use == 0
    hits0 = kv.prefix_hits
    assert kv.allocate_prefix(5, prompt) == 0
    assert kv.prefix_hits == hits0
    kv.free(5)
    kv.assert_consistent()


def test_prefix_cache_off_is_plain_allocate():
    kv = PagedKVCache(num_blocks=8, block_size=4, max_blocks_per_seq=8,
                      prefix_cache=False)
    prompt = list(range(12))
    assert kv.allocate_prefix(1, prompt) == 0
    assert kv.register_prefix(1, prompt) == 0
    assert kv.allocate_prefix(2, prompt) == 0
    assert kv.prefix_hits == 0 and kv.cached_blocks == 0
    kv.free(1)
    kv.free(2)
    assert kv.free_blocks == kv.capacity_blocks


@pytest.mark.parametrize("env", [
    {},
    SERVE_ENV,
    {"HOROVOD_SERVE_BLOCK_SIZE": "5", "HOROVOD_SERVE_MAX_MODEL_LEN": "100",
     "HOROVOD_SERVE_MAX_BATCH": "3", "HOROVOD_SERVE_FUSED_ATTN": "1",
     "HOROVOD_SERVE_PREFIX_CACHE": "0", "HOROVOD_SERVE_WARMUP": "bad"},
])
def test_serve_config_resolves_like_the_reference(env):
    """Same env names, defaults, clamps and derived defaults."""
    assert vars(ServeConfig.from_env(env)) == \
        vars(JaxServeConfig.from_env(env))
    ours = {r["env"]: r for r in resolved_serve_config(env)}
    theirs = {r["env"]: r for r in jax_resolved_serve_config(env)}
    theirs.pop("HOROVOD_PAGED_ATTN_CHUNK")    # the JAX XLA path's knob
    assert ours == theirs


# ---------------------------------------------------------------------------
# runner + scheduler against the JAX offline reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """(port runner on the CPU, JAX runner) serving identical weights."""
    cfg = ServeConfig.from_env(SERVE_ENV)
    jrunner = JaxModelRunner(JaxServeConfig.from_env(SERVE_ENV))
    runner = ModelRunner(cfg, device="cpu")
    runner.model = LlamaModel.from_state_dict(
        runner.model_cfg, params_from_jax(jrunner.variables,
                                          runner.model_cfg, "cpu"))
    return runner, jrunner


@pytest.fixture(scope="module")
def runner(runners):
    return runners[0]


_GEN_CACHE = {}


def offline_tokens(runners, prompt, n):
    """JAX ``jit(generate)`` at the serving geometry: the reference
    stream."""
    runner, jrunner = runners
    fn = _GEN_CACHE.get(n)
    if fn is None:
        fn = jax.jit(functools.partial(
            jax_generate, jrunner.model_cfg, max_new_tokens=n,
            cache_len=runner.cache_len))
        _GEN_CACHE[n] = fn
    return np.asarray(fn(jrunner.variables,
                         jnp.asarray(np.asarray(prompt, np.int32)[None])))[0]


def _run_requests(sched, reqs, timeout=180):
    events = {}
    lock = threading.Lock()
    done = threading.Event()
    terminal = set()

    def emit_for(rid):
        def emit(ev):
            with lock:
                events.setdefault(rid, []).append(ev)
                if ev["event"] in ("done", "error", "cancelled"):
                    terminal.add(rid)
                    if len(terminal) == len(reqs):
                        done.set()
        return emit

    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    for req in reqs:
        sched.submit(req, emit_for(req.id))
    assert done.wait(timeout), \
        f"only {len(terminal)}/{len(reqs)} requests finished"
    sched.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
    return events


@pytest.mark.parametrize("fused", [0, 1])
def test_scheduler_streams_match_jax_offline_generate(runners, fused):
    """Mixed prompt lengths under a pool tight enough to force
    preemption: every stream equals JAX offline ``jit(generate)`` token
    for token, with the gather oracle and with the fused op."""
    runner = runners[0]
    cfg = ServeConfig.from_env(dict(SERVE_ENV,
                                    HOROVOD_SERVE_FUSED_ATTN=str(fused)))
    runner.fused_attn = bool(fused)
    try:
        sched = Scheduler(runner, cfg)
        rng = np.random.default_rng(0)
        reqs = [Request(id=f"r{i}",
                        prompt=rng.integers(
                            0, runner.model_cfg.vocab_size,
                            int(rng.integers(3, 14))).tolist(),
                        max_tokens=8) for i in range(6)]
        events = _run_requests(sched, reqs)
        stats = sched.stats()
    finally:
        runner.fused_attn = False
    for req in reqs:
        evs = events[req.id]
        assert evs[-1]["event"] == "done"
        toks = [e["token"] for e in evs if e["event"] == "token"]
        assert toks == evs[-1]["tokens"]
        np.testing.assert_array_equal(
            np.asarray(toks), offline_tokens(runners, req.prompt,
                                             req.max_tokens))
    assert stats["preemptions"] > 0, "pool was sized to force preemption"
    assert stats["batch_occupancy"] > 1.0
    assert stats["kv_blocks_in_use"] == 0
    assert stats["requests_completed"] == len(reqs)
    assert stats["fused_attn_steps"] == (stats["decode_steps"] if fused
                                         else 0)
    assert stats["config"]["fused_attn"] == fused


def test_scheduler_admission_control_and_rejects(runner):
    env = dict(SERVE_ENV, HOROVOD_SERVE_KV_BLOCKS="4")
    sched = Scheduler(runner, ServeConfig.from_env(env))
    rng = np.random.default_rng(1)
    reqs = [Request(id=f"r{i}", prompt=rng.integers(0, 512, 9).tolist(),
                    max_tokens=6) for i in range(3)]
    reqs += [Request(id="long", prompt=list(range(60)), max_tokens=30),
             Request(id="empty", prompt=[], max_tokens=4)]
    events = _run_requests(sched, reqs)
    for req in reqs[:3]:
        assert events[req.id][-1]["event"] == "done"
        assert len(events[req.id][-1]["tokens"]) == req.max_tokens
    assert "rejected" in events["long"][-1]["error"]
    assert events["empty"][-1]["event"] == "error"
    stats = sched.stats()
    assert stats["requests_rejected"] == 2
    assert stats["kv_blocks_in_use"] == 0


def test_scheduler_temperature_sampling_is_seed_stable(runner):
    cfg = ServeConfig.from_env(SERVE_ENV)
    outs = []
    for seed in (7, 7, 8):
        sched = Scheduler(runner, cfg)
        req = Request(id="t", prompt=list(range(1, 8)), max_tokens=12,
                      temperature=0.9, seed=seed)
        outs.append(_run_requests(sched, [req])["t"][-1]["tokens"])
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_prefix_hit_streams_match_and_cow_isolated(runners):
    """A repeated prompt hits the cache, the hit stream equals the miss
    stream and the JAX reference, and the shared pool blocks' bytes do
    not change while the second sequence decodes through them."""
    runner = runners[0]
    cfg = ServeConfig.from_env(dict(SERVE_ENV, HOROVOD_SERVE_KV_BLOCKS="24"))
    sched = Scheduler(runner, cfg)
    prompt = np.random.default_rng(21).integers(
        0, runner.model_cfg.vocab_size, 12).tolist()
    evs_a = _run_requests(sched, [Request(id="a", prompt=prompt,
                                          max_tokens=6)])["a"]
    shared = sorted(sched.kv._hash_to_block.values())
    assert len(shared) == 3
    before = runner.pool_k[:, shared].clone()
    sched2 = Scheduler(runner, cfg)
    sched2.kv = sched.kv
    evs_b = _run_requests(sched2, [Request(id="b", prompt=prompt,
                                           max_tokens=6)])["b"]
    assert evs_b[-1]["tokens"] == evs_a[-1]["tokens"]
    np.testing.assert_array_equal(np.asarray(evs_a[-1]["tokens"]),
                                  offline_tokens(runners, prompt, 6))
    st = sched2.stats()
    assert st["prefix_hits"] >= 2 and st["prefill_tokens_saved"] >= 8
    assert st["kv_blocks_in_use"] == 0
    assert torch.equal(before, runner.pool_k[:, shared]), \
        "a sharer mutated cached prefix blocks"
    sched.kv.assert_consistent()


def test_prefix_cache_survives_preemption_no_leaks(runners):
    runner = runners[0]
    sched = Scheduler(runner, ServeConfig.from_env(SERVE_ENV))
    rng = np.random.default_rng(6)
    head = rng.integers(0, runner.model_cfg.vocab_size, 8).tolist()
    reqs = [Request(id=f"r{i}",
                    prompt=head + rng.integers(
                        0, runner.model_cfg.vocab_size,
                        int(rng.integers(1, 5))).tolist(),
                    max_tokens=8) for i in range(6)]
    events = _run_requests(sched, reqs)
    for req in reqs:
        np.testing.assert_array_equal(
            np.asarray(events[req.id][-1]["tokens"]),
            offline_tokens(runners, req.prompt, req.max_tokens))
    stats = sched.stats()
    assert stats["preemptions"] > 0 and stats["prefix_hits"] > 0
    assert stats["kv_blocks_in_use"] == 0
    sched.kv.assert_consistent()


def test_warmup_runs_every_bucket_writing_only_trash():
    env = {"HOROVOD_SERVE_BLOCK_SIZE": "4",
           "HOROVOD_SERVE_MAX_MODEL_LEN": "16",
           "HOROVOD_SERVE_MAX_BATCH": "2",
           "HOROVOD_SERVE_KV_BLOCKS": "8",
           "HOROVOD_SERVE_WARMUP": "16",
           "HOROVOD_SERVE_FUSED_ATTN": "1"}
    r = ModelRunner(ServeConfig.from_env(env), device="cpu")
    # decode widths 1, 2; prefill spans 4, 8, 16; suffix spans 4, 8.
    assert r.warmup() == 7
    assert not r.pool_k[:, 1:].any() and not r.pool_v[:, 1:].any()
    assert r.pool_k[:, 0].any()
    assert ModelRunner(ServeConfig.from_env({}), device="cpu").warmup() == 0


def test_runner_refuses_without_gpu_and_unported_knobs(monkeypatch, runner):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRunner(ServeConfig.from_env({}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRunner(ServeConfig.from_env({}), device="cuda")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ModelRunner(ServeConfig.from_env(
            {"HOROVOD_SERVE_CHECKPOINT": "/nonexistent"}), device="cpu")
    with pytest.raises(NotImplementedError, match="autotune"):
        Scheduler(runner, ServeConfig.from_env(
            dict(SERVE_ENV, HOROVOD_SERVE_AUTOTUNE="1")))
    with pytest.raises(NotImplementedError, match="weight swaps"):
        Scheduler(runner, ServeConfig.from_env(SERVE_ENV)).swap_weights(
            1, [])
    with pytest.raises(ValueError, match="HOROVOD_SERVE_DTYPE"):
        ModelRunner(ServeConfig.from_env({"HOROVOD_SERVE_DTYPE": "int8"}),
                    device="cpu")


# ---------------------------------------------------------------------------
# protocol: in-process asyncio server + blocking client, and the entry point
# ---------------------------------------------------------------------------

def test_replica_server_protocol_roundtrip(runners):
    runner = runners[0]
    cfg = ServeConfig.from_env(SERVE_ENV)
    sched = Scheduler(runner, cfg)
    sched_thread = threading.Thread(target=sched.run, daemon=True)
    sched_thread.start()
    holder = {}
    started = threading.Event()

    def serve_thread():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def amain():
            server = ReplicaServer(sched)
            holder["port"] = await server.start("127.0.0.1", 0)
            started.set()
            await server.serve_until_shutdown()

        loop.run_until_complete(amain())
        loop.close()

    st = threading.Thread(target=serve_thread, daemon=True)
    st.start()
    assert started.wait(10)
    cli = ServeClient("127.0.0.1", holder["port"], timeout=120)
    cli.ping()
    evs = cli.generate("a", [1, 2, 3, 4, 5], max_tokens=6)
    toks = [e["token"] for e in evs if e["event"] == "token"]
    assert evs[-1]["event"] == "done" and toks == evs[-1]["tokens"]
    np.testing.assert_array_equal(
        np.asarray(toks), offline_tokens(runners, [1, 2, 3, 4, 5], 6))
    stats = cli.stats()
    assert stats["requests_completed"] >= 1
    assert stats["config"]["max_batch"] == cfg.max_batch
    with pytest.raises(RuntimeError, match="not ported"):
        cli.push_weights([], epoch=1, timeout=30)
    # A client that vanishes mid-request gets its work cancelled.
    cli2 = ServeClient("127.0.0.1", holder["port"], timeout=120)
    cli2.start_generate("b", list(range(1, 6)), max_tokens=34)
    deadline = time.time() + 30
    while time.time() < deadline:
        with cli2._qlock:
            if cli2._queues["b"]:
                break
        time.sleep(0.02)
    cli2.close()
    deadline = time.time() + 30
    while time.time() < deadline and cli.stats()["requests_cancelled"] < 1:
        time.sleep(0.2)
    assert cli.stats()["requests_cancelled"] >= 1
    cli.shutdown()
    st.join(timeout=15)
    assert not st.is_alive(), "server did not shut down cleanly"
    cli.close()
    sched.stop()
    sched_thread.join(timeout=10)
    assert not sched_thread.is_alive()


def _replica_env():
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_SERVE_BLOCK_SIZE="4",
               HOROVOD_SERVE_MAX_MODEL_LEN="32", HOROVOD_SERVE_WARMUP="8",
               HOROVOD_SERVE_FUSED_ATTN="1")
    env.pop("HOROVOD_SERVE_ENGINE", None)
    return env


def test_replica_entry_point_serves_on_cpu():
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.replica", "--device",
         "cpu", "--port", "0"], cwd=REPO, env=_replica_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.startswith("SERVE_REPLICA_READY"):
                port = int(line.split("port=")[1].split()[0])
        assert port is not None, (lines, proc.stderr.read())
        # decode widths 1, 2, 4, 8; prefill spans 4, 8; suffix spans 4, 8
        assert lines[0] == "SERVE_REPLICA_WARMUP replica=0 programs=8"
        cli = ServeClient("127.0.0.1", port, timeout=60)
        evs = cli.generate("x", [3, 1, 4, 1, 5], max_tokens=4, timeout=60)
        assert evs[-1]["event"] == "done" and len(evs[-1]["tokens"]) == 4
        cli.shutdown()
        assert proc.wait(timeout=60) == 0
        cli.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_replica_entry_point_refuses_without_gpu_or_with_engine():
    env = _replica_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.serve.replica"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and "READY" not in out.stdout
    env["HOROVOD_SERVE_ENGINE"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.serve.replica", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "engine binding" in out.stderr
