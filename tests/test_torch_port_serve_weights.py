"""Port parity: serving's weight plane on the CPU.

* The push codec: the port's ``encode_leaves`` gives the reference's
  frames byte for byte on the same arrays for every wire (int8, fp32,
  raw, and bf16/fp8, which the reference casts with ``ml_dtypes`` and
  the port with torch), and ``decode_leaves``/``apply_leaves`` agree.
* A replica serving a checkpoint: a tiny fp32 Llama checkpoint written
  by the JAX package's ``jax_capture`` streams the reference's tokens
  through the port's ``ModelRunner`` (``HOROVOD_SERVE_CHECKPOINT``), as
  through the reference's runner.
* ``swap_weights``: after a swap, the decode equals a fresh runner's on
  the decoded weights bit for bit; a stale epoch is acked and not
  applied; running streams restart behind ``requeued`` frames with
  ``reason: "weights"`` and finish on the new weights; the prefix cache
  is flushed; a gate-only partial push lands in ``w_gate_up``'s half; a
  shape mismatch raises and writes nothing.
* The CPU fleet: the router fans a push out to every replica, replays it
  to a relaunched replica before that replica takes traffic, and
  ``--serve-model <checkpoint dir>`` serves a checkpoint.
"""

import functools
import os
import threading
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.checkpoint import CheckpointWriter as RefWriter
from horovod_tpu.checkpoint import jax_capture as ref_jax_capture
from horovod_tpu.checkpoint import push as ref_push
from horovod_tpu.models.generation import generate as jax_generate
from horovod_tpu.serve.config import ServeConfig as JaxServeConfig
from horovod_tpu.serve.engine import ModelRunner as JaxModelRunner
from horovod_tpu_torch import bench_serve
from horovod_tpu_torch.checkpoint import (CheckpointWriter, jax_capture,
                                          push)
from horovod_tpu_torch.models.convert import params_from_jax, params_to_jax
from horovod_tpu_torch.models.generation import generate
from horovod_tpu_torch.models.llama import LlamaModel
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ModelRunner
from horovod_tpu_torch.serve.scheduler import Request, Scheduler
from horovod_tpu_torch.serve.server import ServeClient

SERVE_ENV = {
    "HOROVOD_SERVE_BLOCK_SIZE": "4",
    "HOROVOD_SERVE_KV_BLOCKS": "32",
    "HOROVOD_SERVE_MAX_MODEL_LEN": "64",
    "HOROVOD_SERVE_MAX_BATCH": "4",
    "HOROVOD_SERVE_DTYPE": "float32",
}
FLEET_TIMEOUT = 120


# ---------------------------------------------------------------------------
# the codec against the reference
# ---------------------------------------------------------------------------

def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "dense": {"kernel": rng.standard_normal((64, 64)).astype(np.float32),
                  "half": rng.standard_normal((48, 64)).astype(np.float16),
                  "wide": rng.standard_normal((40, 80)) * 3.0},
        "norm": {"scale": rng.standard_normal(64).astype(np.float32)},
        "small": np.ones((4, 4), np.float32) * 0.5,
        "zeros": np.zeros((64, 40), np.float32),
        "steps": np.int32(17),
        "ids": np.arange(10, dtype=np.int64).reshape(2, 5),
        "mask": np.array([True, False, True]),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


@pytest.mark.parametrize("wire", ["fp32", "bf16", "fp8", "int8"])
@pytest.mark.parametrize("min_elems", [push.PIN_MIN_ELEMS, 4])
def test_frames_equal_the_reference_byte_for_byte(wire, min_elems):
    tree = _codec_tree()
    ref = ref_push.encode_leaves(tree, wire=wire, min_elems=min_elems)
    assert push.encode_leaves(tree, wire=wire, min_elems=min_elems) == ref
    # Torch tensors in the arrays' places give the same frames.
    assert push.encode_leaves(_as_torch(tree), wire=wire,
                              min_elems=min_elems) == ref
    got, want = push.decode_leaves(ref), ref_push.decode_leaves(ref)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert got[path].tobytes() == want[path].tobytes(), (wire, path)


def test_bf16_leaves_ride_raw_as_in_the_reference():
    """numpy (with ml_dtypes) calls bf16 a non-float: the reference ships
    a bf16 array raw, and the port ships a bf16 tensor the same way; the
    port decodes it to its exact fp32."""
    x = np.random.default_rng(1).standard_normal((64, 64)).astype(
        ml_dtypes.bfloat16)
    ref = ref_push.encode_leaves({"x": x}, wire="int8")
    t = torch.from_numpy(x.view(np.uint16).copy().view(np.int16)).view(
        torch.bfloat16)
    assert push.encode_leaves({"x": t}, wire="int8") == ref
    assert ref[0]["wire"] == "raw" and ref[0]["dtype"] == "bfloat16"
    got = push.decode_leaves(ref)["w.x"]
    assert got.dtype == np.float32
    assert got.tobytes() == x.astype(np.float32).tobytes()


def test_apply_leaves_equals_the_reference():
    tree = _codec_tree()
    frames = ref_push.encode_leaves(tree, wire="int8")
    target = {"dense": {"kernel": np.zeros((64, 64), np.float16),
                        "half": np.zeros((48, 64), np.float32),
                        "wide": np.zeros((40, 80))},
              "norm": {"scale": np.zeros(64, np.float32)},
              "small": np.zeros((4, 4), np.float32),
              "zeros": np.ones((64, 40), np.float32),
              "steps": np.int32(0), "ids": np.zeros((2, 5), np.int64),
              "mask": np.zeros(3, bool), "other": np.ones(2)}
    want = ref_push.apply_leaves(target, ref_push.decode_leaves(frames))
    got = push.apply_leaves(target, push.decode_leaves(frames))
    for path in ("dense.kernel", "dense.half", "dense.wide", "norm.scale",
                 "small", "zeros", "ids", "mask", "other"):
        a, b = got, want
        for k in path.split("."):
            a, b = a[k], b[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    # Tensor targets are written in place.
    tt = {"norm": {"scale": torch.zeros(64)}}
    out = push.apply_leaves(tt, push.decode_leaves(frames))
    assert out["norm"]["scale"] is tt["norm"]["scale"]
    assert tt["norm"]["scale"].numpy().tobytes() == \
        tree["norm"]["scale"].tobytes()
    with pytest.raises(ValueError, match="does not match"):
        push.apply_leaves({"small": torch.zeros(2, 2)},
                          push.decode_leaves(frames))
    with pytest.raises(ValueError, match="wire"):
        push.encode_leaves(tree, wire="int4")


# ---------------------------------------------------------------------------
# a replica serving a checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny fp32 Llama checkpoint written by the JAX package: its serve
    runner's params moved off their seed (so a restore is visible), an
    optax state beside them, through ``jax_capture`` and the reference's
    writer."""
    import optax

    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jrunner = JaxModelRunner(JaxServeConfig.from_env(SERVE_ENV))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * 1.25 + 0.01,
        jrunner.variables["params"])
    opt_state = optax.adam(1e-3).init(params)
    state, sharded = ref_jax_capture(types.SimpleNamespace(), params,
                                     opt_state, step=5,
                                     extra={"meta_note": 1})
    w = RefWriter(d, meta={"model": "tiny"})
    w.save(5, state, sharded)
    w.wait(timeout=60)
    w.close()
    return d, params


def _greedy(runner, prompt, n):
    """The port's served stream through a Scheduler."""
    sched = Scheduler(runner, ServeConfig.from_env(SERVE_ENV))
    events = []
    done = threading.Event()

    def emit(ev):
        events.append(ev)
        if ev["event"] in ("done", "error"):
            done.set()

    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    sched.submit(Request(id="r", prompt=list(prompt), max_tokens=n), emit)
    assert done.wait(120)
    sched.stop()
    thread.join(timeout=10)
    assert events[-1]["event"] == "done", events[-1]
    return events[-1]["tokens"]


def test_replica_serves_a_jax_checkpoint_with_the_reference_tokens(
        jax_checkpoint):
    d, params = jax_checkpoint
    env = dict(SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=d)
    runner = ModelRunner(ServeConfig.from_env(env), device="cpu")
    assert runner.checkpoint_step == 5
    want = params_from_jax(params, runner.model_cfg, "cpu")
    for name, t in runner.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    jrunner = JaxModelRunner(JaxServeConfig.from_env(env))
    assert jrunner.checkpoint_step == 5
    fn = jax.jit(functools.partial(jax_generate, jrunner.model_cfg,
                                   max_new_tokens=12,
                                   cache_len=runner.cache_len))
    for prompt in ([1, 2, 3, 4, 5], [400, 9, 33, 7, 7, 7, 100]):
        theirs = np.asarray(fn(jrunner.variables, jnp.asarray(
            np.asarray(prompt, np.int32)[None])))[0]
        assert _greedy(runner, prompt, 12) == theirs.tolist()


def test_replica_checkpoint_refusals(jax_checkpoint, tmp_path):
    """No params slot, a geometry that does not fit, a torn set: each
    raises; the replica never falls back to seeded weights."""
    import shutil

    from horovod_tpu_torch.checkpoint import (CheckpointError,
                                              CheckpointIncompleteError)
    from horovod_tpu_torch.checkpoint import manifest as mf

    d, _ = jax_checkpoint
    w = CheckpointWriter(str(tmp_path / "noparams"))
    w.save(1, {"model": {"x": np.ones(3)}})
    w.wait(60)
    w.close()
    with pytest.raises(CheckpointError, match="no 'params' slot"):
        ModelRunner(ServeConfig.from_env(dict(
            SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=str(tmp_path / "noparams"))),
            device="cpu")
    with pytest.raises(CheckpointError, match="does not fit"):
        _mismatched_runner(d)
    torn = tmp_path / "torn"
    shutil.copytree(d, torn)
    shard = mf.shard_file(str(torn), 5, 0, 1)
    data = open(shard, "rb").read()
    open(shard, "wb").write(data[:len(data) // 2])
    with pytest.raises(CheckpointIncompleteError):
        ModelRunner(ServeConfig.from_env(dict(
            SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=str(torn))), device="cpu")


def test_a_depth_cut_checkpoint_is_served_at_its_depth(tmp_path):
    """A checkpoint of the named model's first layer (its widths, depth
    1) is served as a 1-layer model; its stream equals the port's offline
    generate over those weights."""
    import dataclasses

    runner, tree = _base()
    cut = dataclasses.replace(runner.model_cfg, num_layers=1)
    params = {k: v for k, v in tree["params"].items()
              if not k.startswith("layer_") or k == "layer_0"}
    model = LlamaModel.from_state_dict(cut, params_from_jax(params, cut,
                                                            "cpu"))
    st, sh = jax_capture(None, model, 4)
    w = CheckpointWriter(str(tmp_path), meta={"model": "tiny"})
    w.save(4, st, sh)
    w.wait(60)
    w.close()
    served = ModelRunner(ServeConfig.from_env(dict(
        SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=str(tmp_path))), device="cpu")
    assert served.model_cfg.num_layers == 1 and len(served.model.layers) == 1
    assert served.pool_k.shape[0] == 1
    prompt = [3, 1, 4, 1, 5]
    assert _greedy(served, prompt, 10) == generate(
        model, torch.tensor([prompt]), max_new_tokens=10,
        cache_len=served.cache_len)[0].tolist()


def _mismatched_runner(d):
    """A checkpoint of the tiny model served as a wider model raises."""
    import dataclasses

    from horovod_tpu_torch.serve import engine

    cfg = ServeConfig.from_env(dict(SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=d))
    real = engine.build_model_config

    def wider(serve_cfg):
        return dataclasses.replace(real(serve_cfg), hidden_size=128)

    engine.build_model_config = wider
    try:
        ModelRunner(cfg, device="cpu")
    finally:
        engine.build_model_config = real


def test_port_jax_capture_reads_back_in_both_replicas(tmp_path):
    """The port's JAX-form capture writes the params slot in the flax
    paths: the reference's runner and the port's both serve it."""
    from horovod_tpu_torch.frontend import DistributedOptimizer

    runner = ModelRunner(ServeConfig.from_env(SERVE_ENV), device="cpu")
    model = runner.model
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.75)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
    st, sh = jax_capture(opt, model, 7)
    w = CheckpointWriter(str(tmp_path), meta={"model": "tiny"})
    w.save(7, st, sh)
    w.wait(60)
    w.close()
    env = dict(SERVE_ENV, HOROVOD_SERVE_CHECKPOINT=str(tmp_path))
    served = ModelRunner(ServeConfig.from_env(env), device="cpu")
    for name, t in served.model.state_dict().items():
        assert torch.equal(t, model.state_dict()[name]), name
    jrunner = JaxModelRunner(JaxServeConfig.from_env(env))
    want = params_to_jax(model.state_dict(), runner.model_cfg)["params"]
    got = jax.tree_util.tree_map(np.asarray, jrunner.variables["params"])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), got, want))


# ---------------------------------------------------------------------------
# swap_weights
# ---------------------------------------------------------------------------

def _base():
    runner = ModelRunner(ServeConfig.from_env(SERVE_ENV), device="cpu")
    tree = params_to_jax(runner.model.state_dict(), runner.model_cfg)
    return runner, tree


def _perturbed(tree, scale=1.5):
    return {"params": jax.tree_util.tree_map(
        lambda a: (a * np.float32(scale) - np.float32(0.02)).astype(
            np.float32), tree["params"])}


def _fresh(runner, tree):
    fresh = ModelRunner(ServeConfig.from_env(SERVE_ENV), device="cpu")
    fresh.model = LlamaModel.from_state_dict(
        runner.model_cfg, params_from_jax(tree, runner.model_cfg, "cpu"))
    return fresh


def _prefill_decode(runner, prompt, steps):
    tbl = list(range(1, 1 + (len(prompt) + steps + 3) // 4))
    logits = [runner.prefill(prompt, tbl)]
    tok = int(np.argmax(logits[-1]))
    table = np.zeros(runner.max_blocks_per_seq, np.int32)
    table[:len(tbl)] = tbl
    for i in range(steps):
        out = runner.decode([tok], [table], [len(prompt) + i])
        logits.append(out[0])
        tok = int(np.argmax(out[0]))
    return np.stack(logits)


def test_swap_then_decode_equals_a_fresh_runner_bitwise():
    runner, tree = _base()
    new = _perturbed(tree)
    frames = push.encode_leaves(new, wire="int8")
    sched = Scheduler(runner, ServeConfig.from_env(SERVE_ENV))
    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    ack = sched.swap_weights(1, frames)
    assert ack == {"applied": True, "epoch": 1, "restarted": 0}
    # A replayed (stale) epoch is acked and not applied.
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    assert sched.swap_weights(1, push.encode_leaves(tree, wire="fp32")) \
        == {"applied": False, "epoch": 1, "restarted": 0}
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    sched.stop()
    thread.join(timeout=10)
    decoded = push.apply_leaves(tree, push.decode_leaves(frames))
    fresh = _fresh(runner, decoded)
    got = _prefill_decode(runner, [5, 6, 7, 8, 9], 6)
    want = _prefill_decode(fresh, [5, 6, 7, 8, 9], 6)
    assert got.tobytes() == want.tobytes()
    # The decoded weights differ from the old ones (the swap did land).
    assert not np.array_equal(got, _prefill_decode(_fresh(runner, tree),
                                                   [5, 6, 7, 8, 9], 6))


def test_running_streams_restart_on_the_new_weights():
    runner, tree = _base()
    env = dict(SERVE_ENV, HOROVOD_SERVE_PREFIX_CACHE="1")
    reached = threading.Event()

    def hook(step):
        if step == 3:
            # Hold the scheduler after its 3rd decode step until the push
            # is parked: the swap lands while every stream is running.
            reached.set()
            deadline = time.time() + 60
            while sched._pending_weights is None:
                assert time.time() < deadline
                time.sleep(0.01)

    sched = Scheduler(runner, ServeConfig.from_env(env), step_hook=hook)
    events = {}
    done = threading.Event()
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0],
               [3, 3, 3, 3, 4]]

    def emit_for(rid):
        def emit(ev):
            events.setdefault(rid, []).append(ev)
            if sum(1 for evs in events.values()
                   if evs[-1]["event"] == "done") == len(prompts):
                done.set()
        return emit

    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    for i, p in enumerate(prompts):
        sched.submit(Request(id=f"s{i}", prompt=p, max_tokens=20),
                     emit_for(f"s{i}"))
    new = _perturbed(tree, 0.9)
    acks = []
    frames = push.encode_leaves(new, wire="fp32")
    pusher = threading.Thread(target=lambda: reached.wait(60) and acks.append(
        sched.swap_weights(1, frames)))
    pusher.start()
    pusher.join(60)
    assert done.wait(120)
    sched.stop()
    thread.join(timeout=10)
    assert acks == [{"applied": True, "epoch": 1,
                     "restarted": len(prompts)}]
    fresh = _fresh(runner, new)
    for i, p in enumerate(prompts):
        evs = events[f"s{i}"]
        req = [e for e in evs if e["event"] == "requeued"]
        assert req == [{"event": "requeued", "id": f"s{i}",
                        "reason": "weights", "weight_epoch": 1}]
        after = evs[evs.index(req[0]) + 1:]
        toks = [e["token"] for e in after if e["event"] == "token"]
        assert [e["index"] for e in after if e["event"] == "token"] == \
            list(range(20))
        assert evs[-1]["tokens"] == toks and evs[-1]["weight_epoch"] == 1
        ids = torch.tensor([p], dtype=torch.long)
        want = generate(fresh.model, ids, max_new_tokens=20,
                        cache_len=runner.cache_len)[0].tolist()
        assert toks == want, i
    st = sched.stats()
    assert st["weight_swaps"] == 1 and st["weight_epoch"] == 1
    # The prefix cache was flushed at the swap: nothing registered from
    # the old epoch survives (every block is free again).
    assert sched.kv.blocks_in_use == 0
    assert sched.kv.prefix_evictions > 0 or sched.kv.prefix_hits == 0


def test_flush_prefix_is_called_at_the_swap():
    runner, tree = _base()
    sched = Scheduler(runner, ServeConfig.from_env(
        dict(SERVE_ENV, HOROVOD_SERVE_PREFIX_CACHE="1")))
    calls = []
    real = sched.kv.flush_prefix
    sched.kv.flush_prefix = lambda: calls.append(1) or real()
    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    sched.swap_weights(1, [])
    sched.stop()
    thread.join(timeout=10)
    assert calls == [1]


def test_gate_only_partial_push_lands_in_its_half():
    runner, tree = _base()
    H, F = runner.model_cfg.hidden_size, runner.model_cfg.intermediate_size
    gate = np.random.default_rng(2).standard_normal((H, F)).astype(
        np.float32)
    w = runner.model.layers[0].mlp.w_gate_up.weight
    up_before = w[F:].detach().clone()
    other_before = runner.model.layers[1].mlp.w_gate_up.weight.detach() \
        .clone()
    n = runner.apply_weights(push.decode_leaves(push.encode_leaves(
        {"params": {"layer_0": {"mlp": {"w_gate": {"kernel": gate}}}}},
        wire="fp32")))
    assert n == 1
    assert torch.equal(w[:F].detach(), torch.from_numpy(gate.T.copy()))
    assert torch.equal(w[F:].detach(), up_before)
    assert torch.equal(runner.model.layers[1].mlp.w_gate_up.weight.detach(),
                       other_before)
    up = gate * 2
    runner.apply_weights(push.decode_leaves(push.encode_leaves(
        {"params": {"layer_0": {"mlp": {"w_up": {"kernel": up}}}}},
        wire="fp32")))
    assert torch.equal(w[F:].detach(), torch.from_numpy(up.T.copy()))


def test_shape_mismatch_raises_and_writes_nothing():
    runner, tree = _base()
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    bad = {"params": {"norm_f": {"scale": np.ones(3, np.float32)},
                      "layer_0": tree["params"]["layer_0"]}}
    sched = Scheduler(runner, ServeConfig.from_env(SERVE_ENV))
    thread = threading.Thread(target=sched.run, daemon=True)
    thread.start()
    with pytest.raises(ValueError, match="does not match"):
        sched.swap_weights(1, push.encode_leaves(bad, wire="fp32"))
    assert sched.stats()["weight_epoch"] == 0
    sched.stop()
    thread.join(timeout=10)
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the CPU fleet
# ---------------------------------------------------------------------------

def _fleet(replicas, restart=0, extra_env=None, extra_args=()):
    return bench_serve.start_fleet(
        replicas, device="cpu", env=dict(SERVE_ENV, **(extra_env or {})),
        restart=restart, timeout=FLEET_TIMEOUT, extra_args=extra_args)


def test_router_fans_out_and_replays_the_push_to_a_relaunched_replica():
    """The push lands on both replicas before any load; replica 1 then
    dies at its 4th decode step, is relaunched, and gets the cached push
    before it takes traffic: every stream finishes at epoch 1 with the
    tokens of the pushed weights."""
    runner, tree = _base()
    new = _perturbed(tree, 1.1)
    fresh = _fresh(runner, new)
    proc, port, log = _fleet(2, restart=1,
                             extra_env={"HOROVOD_FAULT_INJECT": "1:4:exit"})
    cli = None
    try:
        cli = ServeClient("127.0.0.1", port, timeout=FLEET_TIMEOUT)
        pusher = push.WeightPusher("127.0.0.1", port)
        ack = pusher.push(new, wire="fp32")
        pusher.close()
        assert ack["epoch"] == 1 and len(ack["replicas"]) == 2
        assert all(r["applied"] for r in ack["replicas"])
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 512, 6).tolist() for _ in range(8)]
        for i, p in enumerate(prompts):
            cli.start_generate(f"j{i}", p, max_tokens=12)
        for i, p in enumerate(prompts):
            evs = cli.collect(f"j{i}", timeout=FLEET_TIMEOUT)
            assert evs[-1]["event"] == "done", (evs[-1], "".join(log[-30:]))
            assert evs[-1]["weight_epoch"] == 1
            ids = torch.tensor([p], dtype=torch.long)
            assert evs[-1]["tokens"] == generate(
                fresh.model, ids, max_new_tokens=12,
                cache_len=runner.cache_len)[0].tolist(), i
        deadline = time.time() + FLEET_TIMEOUT
        while True:
            st = cli.stats()
            if st["router"]["rejoins"] >= 1 or time.time() > deadline:
                break
            time.sleep(0.5)
        assert st["router"]["weight_pushes"] == 1
        assert st["router"]["weight_replays"] == 1, st["router"]
        assert st["router"]["replica_deaths"] == 1
        assert [r["scheduler"]["weight_epoch"] for r in st["replicas"]] \
            == [1, 1]
        assert bench_serve.stop_fleet(proc, cli) == 0
        cli = None
    finally:
        if cli is not None:
            cli.close()
        bench_serve.kill_fleet(proc)


def test_serve_model_checkpoint_directory(tmp_path):
    """``--serve-model <dir>``: every replica loads the newest complete
    checkpoint (the model name from the manifest's meta) and serves its
    tokens."""
    from horovod_tpu_torch.frontend import DistributedOptimizer

    runner, tree = _base()
    model = _fresh(runner, _perturbed(tree, 0.8)).model
    st, sh = jax_capture(DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1)), model, 12)
    w = CheckpointWriter(str(tmp_path), meta={"model": "tiny"})
    w.save(12, st, sh)
    w.wait(60)
    w.close()
    proc, port, log = _fleet(1, extra_args=("--serve-model", str(tmp_path)))
    cli = None
    try:
        assert any("serving checkpoint step 12" in ln for ln in log), log
        cli = ServeClient("127.0.0.1", port, timeout=FLEET_TIMEOUT)
        prompt = [7, 8, 9, 10]
        evs = cli.generate("c", prompt, max_tokens=10)
        assert evs[-1]["tokens"] == generate(
            model, torch.tensor([prompt]), max_new_tokens=10,
            cache_len=runner.cache_len)[0].tolist()
        cfg = cli.stats()["replicas"][0]["scheduler"]["config"]
        assert cfg["checkpoint_step"] == 12 and cfg["model"] == "tiny"
        assert bench_serve.stop_fleet(proc, cli) == 0
        cli = None
    finally:
        if cli is not None:
            cli.close()
        bench_serve.kill_fleet(proc)
