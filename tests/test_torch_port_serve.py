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
import dataclasses
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

from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models.generation import generate as jax_generate
from horovod_tpu.models.generation import \
    paged_decode_step as jax_paged_decode_step
from horovod_tpu.serve.config import ServeConfig as JaxServeConfig
from horovod_tpu.serve.config import \
    resolved_serve_config as jax_resolved_serve_config
from horovod_tpu.serve.engine import SERVE_DECODE_BAND as JAX_DECODE_BAND
from horovod_tpu.serve.engine import ModelRunner as JaxModelRunner
from horovod_tpu.serve.engine import \
    serve_collective_priority as jax_serve_collective_priority
from horovod_tpu.serve.replica import \
    parse_fault_schedule as jax_parse_fault_schedule
from horovod_tpu_torch.checkpoint.push import encode_leaves
from horovod_tpu_torch.models.convert import params_from_jax, params_to_jax
from horovod_tpu_torch.models.generation import paged_decode_step
from horovod_tpu_torch.models.llama import LlamaModel
from horovod_tpu_torch.serve.config import ServeConfig, resolved_serve_config
from horovod_tpu_torch.serve.engine import (SERVE_DECODE_BAND, ModelRunner,
                                            serve_collective_priority)
from horovod_tpu_torch.serve.replica import parse_fault_schedule
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
    from tests.test_torch_port_autotune import CHUNK_DOC

    assert vars(ServeConfig.from_env(env)) == \
        vars(JaxServeConfig.from_env(env))
    ours = {r["env"]: r for r in resolved_serve_config(env)}
    theirs = {r["env"]: r for r in jax_resolved_serve_config(env)}
    chunk = theirs["HOROVOD_PAGED_ATTN_CHUNK"]     # its help names its path
    theirs["HOROVOD_PAGED_ATTN_CHUNK"] = dict(
        chunk, doc=chunk["doc"].replace(*CHUNK_DOC))
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
    # An absent checkpoint is refused, never replaced by seeded weights.
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        ModelRunner(ServeConfig.from_env(
            {"HOROVOD_SERVE_CHECKPOINT": "/nonexistent"}), device="cpu")
    # HOROVOD_SERVE_AUTOTUNE=1 builds the serve tuner (no refusal).
    tuned = Scheduler(runner, ServeConfig.from_env(
        dict(SERVE_ENV, HOROVOD_SERVE_AUTOTUNE="1")))
    assert tuned._tuner is not None
    assert tuned.stats()["config"]["autotune"] == 1
    # A swap into a stopped scheduler acks without applying.
    stopped = Scheduler(runner, ServeConfig.from_env(SERVE_ENV))
    stopped.stop()
    assert stopped.swap_weights(1, []) == {"applied": False, "epoch": 0,
                                           "restarted": 0}
    with pytest.raises(ValueError, match="HOROVOD_SERVE_DTYPE"):
        ModelRunner(ServeConfig.from_env({"HOROVOD_SERVE_DTYPE": "int8"}),
                    device="cpu")


def test_serve_tuner_matches_the_reference_and_commits(runner):
    """The counterpart of ``tests/test_serve.py:496``: the port's serve
    tuner plans the reference ``ServeTuner``'s schedule for the same
    config (seeds 0 and 5), its stats keys are the reference's, and on
    the tiny model it commits within the trial cap, its committed
    ``max_batch`` in force; every width it can reach was built before
    its first window."""
    from horovod_tpu.serve.tuner import ServeTuner as JaxServeTuner
    from horovod_tpu_torch.serve.tuner import ServeTuner

    for seed in ("0", "5"):
        env = dict(SERVE_ENV, HOROVOD_SERVE_AUTOTUNE="1",
                   HOROVOD_SERVE_AUTOTUNE_SEED=seed,
                   HOROVOD_SERVE_AUTOTUNE_WINDOW_STEPS="4",
                   HOROVOD_SERVE_AUTOTUNE_MAX_TRIALS="3")
        cfg, jcfg = ServeConfig.from_env(env), JaxServeConfig.from_env(env)

        class _Stub:
            max_batch = cfg.max_batch
            prefill_waves = cfg.prefill_waves
            _c = {"tokens_streamed": 0, "fused_attn_steps": 0}
            kv = PagedKVCache(8, 4, 8)

        got = ServeTuner(_Stub(), cfg)
        want = JaxServeTuner(_Stub(), jcfg)
        assert got.search.planned_schedule() == \
            want.search.planned_schedule()
        assert len(got.search.planned_schedule()) == 3
        assert sorted(got.stats()) == sorted(want.stats())
    fresh = ModelRunner(cfg, device="cpu")
    sched = Scheduler(fresh, cfg)
    assert sorted(fresh._decode_fns) == [1, 2, 4]
    built = fresh.compilations
    rng = np.random.default_rng(2)
    reqs = [Request(id=f"r{i}", prompt=rng.integers(0, 512, 5).tolist(),
                    max_tokens=14) for i in range(8)]
    events = _run_requests(sched, reqs)
    for req in reqs:
        assert events[req.id][-1]["event"] == "done"
    stats = sched.stats()
    assert stats["tune_trials"] > 0 and stats["tune_committed"] == 1
    assert sched._tuner.committed is not None
    assert stats["config"]["max_batch"] == \
        sched._tuner.committed["max_batch"]
    # No decode width was built while the tuner ran.
    assert sorted(fresh._decode_fns) == [1, 2, 4]
    assert fresh.compilations - built == \
        sum(1 for _ in fresh._prefill_buckets)


# ---------------------------------------------------------------------------
# the decode program per pow2 width (what a CUDA graph captures on the card)
# ---------------------------------------------------------------------------

#: Pools wide enough for 7 live rows of distinct blocks at width 8.
DECODE_ENV = dict(SERVE_ENV, HOROVOD_SERVE_KV_BLOCKS="40",
                  HOROVOD_SERVE_MAX_BATCH="8")
#: Live rows' positions: block edges (block 4) and the table's last slot.
DECODE_POS = [63, 0, 3, 4, 7, 8, 15, 33]
FP32_ATOL = 1e-5


@pytest.fixture(scope="module")
def decode_runners():
    """{fused: port runner} on the JAX runner's weights, and the JAX
    runner, with random pools (the same values on both sides)."""
    cfg = ServeConfig.from_env(DECODE_ENV)
    jrunner = JaxModelRunner(JaxServeConfig.from_env(DECODE_ENV))
    rng = np.random.default_rng(3)
    runners = {}
    for fused in (0, 1):
        r = ModelRunner(dataclasses.replace(cfg, fused_attn=fused),
                        device="cpu")
        r.model = LlamaModel.from_state_dict(
            r.model_cfg, params_from_jax(jrunner.variables, r.model_cfg,
                                         "cpu"))
        if not runners:
            pools = [torch.from_numpy(rng.standard_normal(
                tuple(r.pool_k.shape)).astype(np.float32))
                for _ in range(2)]
        r.pool_k.copy_(pools[0])
        r.pool_v.copy_(pools[1])
        runners[fused] = r
    return runners, jrunner


def _decode_inputs(runner, width):
    """``width - 1`` live rows (one for width 1) at DECODE_POS, each on
    its own blocks, as the scheduler hands them to ``decode``, and the
    padded [width] arrays the program runs on."""
    live = max(1, width - 1)
    bs, maxb = runner.block_size, runner.max_blocks_per_seq
    rng = np.random.default_rng(width)
    tokens = rng.integers(0, runner.model_cfg.vocab_size, live).tolist()
    pos = DECODE_POS[:live]
    tables, nxt = [], 1
    for p in pos:
        t = np.full((maxb,), TRASH_BLOCK, np.int32)
        t[:p // bs + 1] = np.arange(nxt, nxt + p // bs + 1)
        nxt += p // bs + 1
        tables.append(t)
    full = (np.zeros((width,), np.int32),
            np.full((width, maxb), TRASH_BLOCK, np.int32),
            np.zeros((width,), np.int32))
    full[0][:live] = tokens
    full[1][:live] = tables
    full[2][:live] = pos
    return tokens, tables, pos, full


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_decode_program_is_the_eager_step_bitwise(decode_runners, width,
                                                  fused):
    """The program's body on its static buffers equals
    ``paged_decode_step`` on the same inputs and pools bit for bit:
    logits and the K/V it writes, across block boundaries."""
    runner = decode_runners[0][fused]
    tokens, tables, pos, full = _decode_inputs(runner, width)
    k0, v0 = runner.pool_k.clone(), runner.pool_v.clone()
    try:
        prog = runner._decode_fn(width)
        got = prog.run(tokens, tables, pos)
        assert got.dtype == np.float32 and got.shape == \
            (len(tokens), runner.model_cfg.vocab_size)
        assert prog.inputs.dtype == torch.int32
        pk, pv = k0.clone(), v0.clone()
        want, _, _ = paged_decode_step(
            runner.model, torch.from_numpy(full[0]).long(), pk, pv,
            torch.from_numpy(full[1]), torch.from_numpy(full[2]),
            fused=bool(fused))
        np.testing.assert_array_equal(got, want[:len(tokens)].numpy())
        assert torch.equal(runner.pool_k, pk)
        assert torch.equal(runner.pool_v, pv)
        # A second run (a replay on the card) rewrites the same K/V and
        # gives the same bits.
        assert prog.run(tokens, tables, pos).tobytes() == got.tobytes()
        assert torch.equal(runner.pool_k, pk)
    finally:
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_decode_program_matches_jax_paged_decode_step(decode_runners, width,
                                                      fused):
    """The same program against JAX's ``paged_decode_step`` on the same
    weights, inputs and pools: logits and written pools within fp32's
    1e-5, gather oracle and fused alike."""
    runners, jrunner = decode_runners
    runner = runners[fused]
    tokens, tables, pos, full = _decode_inputs(runner, width)
    k0, v0 = runner.pool_k.clone(), runner.pool_v.clone()
    try:
        got = runner._decode_fn(width).run(tokens, tables, pos)
        want, wk, wv = jax_paged_decode_step(
            jrunner.model_cfg, jrunner.variables, jnp.asarray(full[0]),
            jnp.asarray(k0.numpy()), jnp.asarray(v0.numpy()),
            jnp.asarray(full[1]), jnp.asarray(full[2]), fused=bool(fused))
        np.testing.assert_allclose(got, np.asarray(want)[:len(tokens)],
                                   rtol=0, atol=FP32_ATOL)
        np.testing.assert_allclose(runner.pool_k.numpy(), np.asarray(wk),
                                   rtol=0, atol=FP32_ATOL)
        np.testing.assert_allclose(runner.pool_v.numpy(), np.asarray(wv),
                                   rtol=0, atol=FP32_ATOL)
    finally:
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)


class _HostReads(TorchDispatchMode):
    """Records ops that read a tensor's value to the host or size their
    output by its data — what a CUDA graph cannot capture.  The fused
    decode's plain CPU version (``_decode_blockwise``) reads pos to bound
    its loop on the CPU only (the kernel never does), so its frames are
    exempt."""

    _OPS = {"aten::_local_scalar_dense", "aten::nonzero",
            "aten::masked_select", "aten::_unique2", "aten::unique_dim",
            "aten::unique_consecutive", "aten::repeat_interleave"}

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self._OPS:
            frame = sys._getframe()
            while frame is not None and \
                    frame.f_code.co_name != "_decode_blockwise":
                frame = frame.f_back
            if frame is None:
                self.hits.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fused", [0, 1])
def test_decode_body_reads_nothing_back_to_the_host(decode_runners, fused):
    runner = decode_runners[0][fused]
    tokens, tables, pos, _ = _decode_inputs(runner, 8)
    k0, v0 = runner.pool_k.clone(), runner.pool_v.clone()
    prog = runner._decode_fn(8)
    prog.run(tokens, tables, pos)          # fills the static inputs
    probe = _HostReads()
    try:
        with probe:
            prog.body()
        assert probe.hits == []
        with probe:
            int(torch.tensor([3, 1]).max())
        assert probe.hits == ["aten::_local_scalar_dense"]
    finally:
        runner.pool_k.copy_(k0)
        runner.pool_v.copy_(v0)


@pytest.mark.parametrize("env", [
    {"HOROVOD_SERVE_BLOCK_SIZE": "4", "HOROVOD_SERVE_MAX_MODEL_LEN": "16",
     "HOROVOD_SERVE_MAX_BATCH": "2", "HOROVOD_SERVE_KV_BLOCKS": "8",
     "HOROVOD_SERVE_WARMUP": "16", "HOROVOD_SERVE_FUSED_ATTN": "1"},
    {"HOROVOD_SERVE_BLOCK_SIZE": "4", "HOROVOD_SERVE_MAX_MODEL_LEN": "32",
     "HOROVOD_SERVE_MAX_BATCH": "3", "HOROVOD_SERVE_KV_BLOCKS": "8",
     "HOROVOD_SERVE_WARMUP": "8", "HOROVOD_SERVE_PREFIX_CACHE": "0"},
])
def test_warmup_builds_the_reference_programs(env):
    """``warmup()`` builds as many programs as the reference's compiles,
    and ``compilations`` stays level with the reference's through a
    decode width and prefill buckets met after it (a prefix-hit suffix
    and the static path near the cache's end)."""
    ours = ModelRunner(ServeConfig.from_env(env), device="cpu")
    theirs = JaxModelRunner(JaxServeConfig.from_env(env))
    assert ours.warmup() == theirs.warmup()
    assert ours.compilations == theirs.compilations
    tbl = np.arange(1, ours.max_blocks_per_seq + 1, dtype=np.int32)
    end = ours.cache_len - ours.block_size
    for runner in (ours, theirs):
        runner.decode([1] * 3, [tbl] * 3, [5] * 3)
        runner.prefill(list(range(1, 14)), tbl[:4].tolist(), start=4)
        runner.prefill(list(range(1, end + 2)), tbl.tolist(), start=end)
    assert ours.compilations == theirs.compilations
    assert ours.captures == 0           # graphs are captured on CUDA only


_FAULT_SCHEDULES = [
    None, "", "1:4:exit", "0:4:exit", "1:4:hang", "1:7:conn-reset",
    "2:0:exit", "1:4:boom", "1:x:exit", "1:4", "a:4:exit", "1:4:exit:9",
    "0:1:exit,1:9:hang", " 1:2:exit , 0:3:hang", "1:-3:exit",
    "1:4:exit,1:5:hang", "1:4:conn_reset", ",,", "1::exit",
]


@pytest.mark.parametrize("raw", _FAULT_SCHEDULES)
def test_parse_fault_schedule_like_the_reference(raw):
    for replica in (0, 1, 2):
        assert parse_fault_schedule(raw, replica) == \
            jax_parse_fault_schedule(raw, replica), (raw, replica)


@pytest.mark.parametrize("env", [
    {}, {"HOROVOD_SERVE_ENGINE": "1"},
    {"HOROVOD_SERVE_ENGINE": "1", "HOROVOD_PRIORITY_BANDS": "2"},
    {"HOROVOD_SERVE_ENGINE": "1", "HOROVOD_PRIORITY_BANDS": "0"},
    {"HOROVOD_SERVE_ENGINE": "1", "HOROVOD_PRIORITY_BANDS": "x"},
    {"HOROVOD_SERVE_ENGINE": "1", "HOROVOD_PRIORITY_BANDS": ""},
    {"HOROVOD_SERVE_ENGINE": "0", "HOROVOD_PRIORITY_BANDS": "3"},
    {"HOROVOD_PRIORITY_BANDS": "1"},
])
def test_serve_collective_priority_like_the_reference(env):
    assert serve_collective_priority(env) == \
        jax_serve_collective_priority(env)
    assert SERVE_DECODE_BAND == JAX_DECODE_BAND


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
    # A live push of the served weights themselves (lossless wire): acked
    # and applied at epoch 1, the next stream unchanged.
    frames = encode_leaves(params_to_jax(runner.model.state_dict(),
                                         runner.model_cfg), wire="fp32")
    ack = cli.push_weights(frames, epoch=1, timeout=60)
    assert (ack["event"], ack["applied"], ack["epoch"], ack["restarted"]) \
        == ("weights_ack", True, 1, 0)
    evs = cli.generate("a2", [1, 2, 3, 4, 5], max_tokens=6)
    assert evs[-1]["tokens"] == toks and evs[-1]["weight_epoch"] == 1
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


def _serve_one_request(proc):
    """Read the replica's lines up to READY, serve one request, shut it
    down; returns the lines before READY."""
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
    cli = ServeClient("127.0.0.1", port, timeout=60)
    evs = cli.generate("x", [3, 1, 4, 1, 5], max_tokens=4, timeout=60)
    assert evs[-1]["event"] == "done" and len(evs[-1]["tokens"]) == 4
    cli.shutdown()
    assert proc.wait(timeout=60) == 0
    cli.close()
    return lines


def _replica(env, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.replica", "--port",
         "0", *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_replica_entry_point_serves_on_cpu():
    proc = _replica(_replica_env(), "--device", "cpu")
    try:
        lines = _serve_one_request(proc)
        # decode widths 1, 2, 4, 8; prefill spans 4, 8; suffix spans 4, 8
        assert lines[0] == "SERVE_REPLICA_WARMUP replica=0 programs=8"
        assert lines[1].startswith("SERVE_REPLICA_TIMES replica=0 ")
        assert "captures=0 " in lines[1]      # no CUDA graph on the CPU
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_engine_world_replica_serves_on_cpu():
    """``HOROVOD_SERVE_ENGINE=1``: the replica starts the port's engine
    (``hvd.init``, a world of one) and serves."""
    env = _replica_env()
    env["HOROVOD_SERVE_ENGINE"] = "1"
    for key in [k for k in env if k.startswith(("OMPI_", "PMI_"))] + [
            "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR"]:
        env.pop(key, None)
    proc = _replica(env, "--device", "cpu")
    try:
        lines = _serve_one_request(proc)
        assert lines[0] == "SERVE_REPLICA_ENGINE replica=0 rank=0 size=1"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_replica_entry_point_refuses_without_gpu_or_with_engine():
    """Without a GPU and without ``--device cpu`` the replica refuses to
    start, an engine world too (``hvd.init`` asks for the device)."""
    env = _replica_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    for engine in ("0", "1"):
        env["HOROVOD_SERVE_ENGINE"] = engine
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr and "READY" not in out.stdout
