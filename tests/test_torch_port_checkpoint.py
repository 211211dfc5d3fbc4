"""Port parity: the weight plane's world-1 units on the CPU.

The port's ``horovod_tpu_torch.checkpoint`` (manifest, writer, loader,
stats, the ``ckpt-kill`` parser) held against the JAX package's
``horovod_tpu.checkpoint``, as ``tests/test_checkpoint.py`` holds the
reference: durability mechanics on real bytes, resharding window reads,
and the crossings between the packages (a checkpoint written by either
restores bitwise into the other; the same state gives the same manifest
and the same arrays).  Also: bf16 leaves (written as fp32 by the port;
the reference's bf16 arrays read back through ``uint16``), the walk's
paths against the reference's, the snapshot taken before the next
in-place step, and a flight note landing in the engine's recorder as the
reference's does.
"""

import collections
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.checkpoint import CheckpointLoader as RefLoader
from horovod_tpu.checkpoint import CheckpointWriter as RefWriter
from horovod_tpu.checkpoint.writer import parse_ckpt_kill as ref_parse
from horovod_tpu.elastic.state import _walk as ref_walk
from horovod_tpu_torch.checkpoint import (CheckpointError,
                                          CheckpointIncompleteError,
                                          CheckpointLoader, CheckpointWriter,
                                          checkpoint_stats, latest_manifest,
                                          parse_ckpt_kill)
from horovod_tpu_torch.checkpoint import manifest as mf
from horovod_tpu_torch.elastic.state import _walk
from horovod_tpu_torch.runtime.sharded import shard_bounds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(step):
    return {
        "params": {
            "a": np.linspace(-1, 1, 40, dtype=np.float32).reshape(8, 5),
            "flags": {"done": False, "count": 3, "lr": 0.125},
        },
        "step": step,
    }


def _save(directory, step, state, sharded=None, keep=4, writer=None):
    w = (writer or CheckpointWriter)(str(directory), keep=keep,
                                     meta={"model": "t"})
    try:
        w.save(step, state, sharded)
        w.wait(timeout=60)
    finally:
        w.close()


def _files(directory, step):
    man = json.load(open(mf.manifest_path(str(directory), step)))
    shard = mf.shard_file(str(directory), step, 0, 1)
    return man, open(shard, "rb").read(), np.load(shard)


# ---------------------------------------------------------------------------
# durability mechanics (tests/test_checkpoint.py:76-279 on the port)
# ---------------------------------------------------------------------------

def test_writer_roundtrip_bitexact(tmp_path):
    n = 1003
    flat = np.arange(n, dtype=np.float32) * 0.5
    _save(tmp_path, 7, _state(7), {"opt.mu": (torch.from_numpy(flat), n)})
    loader = CheckpointLoader(str(tmp_path))
    try:
        assert (loader.step, loader.world_size) == (7, 1)
        assert loader.meta == {"model": "t"}
        assert loader.sharded_names() == ["opt.mu"]
        assert loader.flat_length("opt.mu") == n
        tmpl = {"a": np.zeros((8, 5), np.float32),
                "flags": {"done": True, "count": 0, "lr": 0.0}}
        got = loader.restore_tree(tmpl, "params")
        assert got["a"].tobytes() == _state(7)["params"]["a"].tobytes()
        assert got["flags"]["done"] is False
        assert got["flags"]["count"] == 3 and got["flags"]["lr"] == 0.125
        assert int(np.asarray(loader.restore_tree(0, "step"))) == 7
        # A tensor target is overwritten in place, never rebound.
        t = torch.zeros(8, 5)
        out = loader.restore_tree({"a": t, "flags": tmpl["flags"]},
                                  "params")
        assert out["a"] is t
        assert t.numpy().tobytes() == _state(7)["params"]["a"].tobytes()
        for off, cnt in [(0, n), (13, 257), (990, 13), (500, 1)]:
            win = loader.read_flat("opt.mu", off, cnt)
            assert win.tobytes() == flat[off:off + cnt].tobytes()
        with pytest.raises(CheckpointError, match="shape mismatch"):
            loader.restore_tree({"a": torch.zeros(5, 8),
                                 "flags": tmpl["flags"]}, "params")
    finally:
        loader.close()


def test_torn_sets_refused_and_older_set_survives(tmp_path):
    _save(tmp_path, 5, _state(5))
    _save(tmp_path, 10, _state(10))
    shard = mf.shard_file(str(tmp_path), 10, 0, 1)
    good = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(good[: len(good) // 2])
    with pytest.raises(CheckpointIncompleteError):
        CheckpointLoader(str(tmp_path), step=10)
    assert latest_manifest(str(tmp_path))[1] == 5
    loader = CheckpointLoader(str(tmp_path))
    assert loader.step == 5
    loader.close()
    os.unlink(shard)
    with pytest.raises(CheckpointIncompleteError):
        CheckpointLoader(str(tmp_path), step=10)
    with open(shard + ".tmp", "wb") as f:
        f.write(good[: len(good) // 3])
    assert latest_manifest(str(tmp_path))[1] == 5
    with pytest.raises(FileNotFoundError):
        CheckpointLoader(str(tmp_path / "empty"))
    # Every manifest torn: the refusal surfaces, not a not-found.
    for step in (5,):
        os.unlink(mf.shard_file(str(tmp_path), step, 0, 1))
    with pytest.raises(CheckpointIncompleteError):
        CheckpointLoader(str(tmp_path))


def test_retention_deletes_manifest_first_and_keeps_newest(tmp_path):
    for step in (2, 4, 6):
        _save(tmp_path, step, _state(step), keep=2)
    assert mf.list_manifest_steps(str(tmp_path)) == [4, 6]
    assert not os.path.exists(mf.shard_dir(str(tmp_path), 2))
    for step in (4, 6):
        mf.validate(str(tmp_path), mf.read_manifest(str(tmp_path), step))


def _synthetic_world4(directory, full, dtype_name):
    n = full.size
    bounds = shard_bounds(n, 4)
    os.makedirs(mf.shard_dir(directory, 3))
    shards = []
    for r, (off, cnt) in enumerate(bounds):
        path = mf.shard_file(directory, 3, r, 4)
        np.savez(path.replace(".npz", ""), **{"sh.0": full[off:off + cnt]})
        shards.append({"file": os.path.relpath(path, directory),
                       "rank": r, "bytes": os.path.getsize(path)})
    man = {"format": mf.FORMAT_VERSION, "step": 3, "epoch": 0,
           "world_size": 4, "meta": {}, "shards": shards,
           "sharded": [{"name": "opt.v", "n": n, "dtype": dtype_name,
                        "key": "sh.0", "bounds": [list(b) for b in bounds]}],
           "replicated": {"paths": [], "file_rank": 0}}
    with open(mf.manifest_path(directory, 3), "w") as f:
        json.dump(man, f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resharding_window_reads_from_synthetic_world4(tmp_path, dtype):
    """A manifest hand-built at world 4 reads back any window at any new
    world size; a bf16 vector (what the JAX package writes, ``|V2`` on
    reload) comes back as its bits and restores bitwise into bf16."""
    n = 1000
    full = ((np.arange(n, dtype=np.float32) - 500.0) * 0.25).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    directory = str(tmp_path)
    _synthetic_world4(directory, full, dtype)
    bits = full.view(np.uint16) if dtype == "bfloat16" else full
    loader = CheckpointLoader(directory)
    try:
        assert loader.world_size == 4
        for off, cnt in [(0, n), (0, 1), (249, 4), (251, 500), (999, 1),
                         (100, 650)]:
            got = loader.read_flat("opt.v", off, cnt)
            assert got.tobytes() == bits[off:off + cnt].tobytes(), (off, cnt)
        for m in (1, 2, 3, 5, 7):
            for r in range(m):
                off, cnt = shard_bounds(n, m)[r]
                got = loader.my_flat_shard("opt.v", r, m)
                assert got.tobytes() == bits[off:off + cnt].tobytes()
        target = torch.zeros(n, dtype=torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
        loader.restore_tree({"v": target}, "opt")
        if dtype == "bfloat16":
            target = target.view(torch.int16)
        assert target.numpy().tobytes() == bits.tobytes()
    finally:
        loader.close()


@pytest.mark.parametrize("raw", [
    "1:20:ckpt-kill", "0:*:ckpt-kill", "1:4:exit,2:9:ckpt-kill", "2:9:exit",
    "x:9:ckpt-kill", "0:9q:ckpt-kill", "", None, "0:3", "+1:-3:ckpt-kill",
    " 1 : 7 : ckpt-kill ", "1:5:ckpt-kill,1:9:ckpt-kill"])
def test_parse_ckpt_kill_matches_the_reference(raw):
    for rank in (0, 1, 2):
        assert parse_ckpt_kill(raw, rank) == ref_parse(raw, rank), (raw, rank)


def test_checkpoint_stats_surface(tmp_path):
    _save(tmp_path, 9, _state(9))
    st = checkpoint_stats()
    for key in ("checkpoint_bytes", "checkpoint_restores",
                "weight_push_count", "checkpoint_ns_p50",
                "checkpoint_ns_p99", "last_checkpoint_step"):
        assert key in st, key
    assert st["checkpoint_bytes"] > 0
    assert st["last_checkpoint_step"] >= 9
    assert st["checkpoint_ns_p50"] > 0


# ---------------------------------------------------------------------------
# crossings between the packages
# ---------------------------------------------------------------------------

def _cross_state():
    rng = np.random.default_rng(3)
    return {"params": {"w": rng.standard_normal((33, 7)).astype(np.float32),
                       "b": rng.standard_normal(7).astype(np.float64),
                       "ids": np.arange(5, dtype=np.int32),
                       "layers": [{"k": np.float32(1.5)},
                                  {"k": np.float32(-2.0)}],
                       "t": (True, 4, 0.25)},
            "step": 11}


def _cross_sharded():
    flat = np.random.default_rng(4).standard_normal(517).astype(np.float32)
    return flat, {"opt.mu": (flat, 517)}


def test_manifest_and_arrays_equal_the_reference(tmp_path):
    """The same state through both writers: the manifests are equal (no
    timestamp differs; the epoch is 0 at world 1 on both), the npz holds
    the same keys with equal arrays, byte for byte."""
    flat, sh = _cross_sharded()
    _save(tmp_path / "ref", 11, _cross_state(), sh, writer=RefWriter)
    _save(tmp_path / "port", 11, _cross_state(), sh)
    man_r, bytes_r, npz_r = _files(tmp_path / "ref", 11)
    man_p, bytes_p, npz_p = _files(tmp_path / "port", 11)
    assert man_p == man_r
    assert sorted(npz_p.files) == sorted(npz_r.files)
    for k in npz_r.files:
        assert npz_p[k].dtype == npz_r[k].dtype and \
            npz_p[k].tobytes() == npz_r[k].tobytes(), k
    assert bytes_p == bytes_r


def test_reference_checkpoint_restores_bitwise_into_the_port(tmp_path):
    flat, sh = _cross_sharded()
    _save(tmp_path, 11, _cross_state(), sh, writer=RefWriter)
    want = _cross_state()["params"]
    target = {"w": torch.zeros(33, 7), "b": torch.zeros(7, dtype=torch.float64),
              "ids": np.zeros(5, np.int32),
              "layers": [{"k": np.float32(0)}, {"k": np.float32(0)}],
              "t": (False, 0, 0.0)}
    loader = CheckpointLoader(str(tmp_path))
    got = loader.restore_tree(target, "params")
    assert got["w"].numpy().tobytes() == want["w"].tobytes()
    assert got["b"].numpy().tobytes() == want["b"].tobytes()
    assert got["ids"].tobytes() == want["ids"].tobytes()
    assert [float(x["k"]) for x in got["layers"]] == [1.5, -2.0]
    assert got["t"] == (True, 4, 0.25)
    assert loader.read_flat("opt.mu").tobytes() == flat.tobytes()
    loader.close()


def test_port_checkpoint_restores_bitwise_into_the_reference(tmp_path):
    """Written by the port from torch tensors (CPU) and numbers, read by
    the reference's loader into numpy targets."""
    flat, _ = _cross_sharded()
    st = _cross_state()
    st["params"]["w"] = torch.from_numpy(st["params"]["w"].copy())
    _save(tmp_path, 11, st, {"opt.mu": (torch.from_numpy(flat), 517)})
    want = _cross_state()["params"]
    target = {"w": np.zeros((33, 7), np.float32), "b": np.zeros(7),
              "ids": np.zeros(5, np.int32),
              "layers": [{"k": np.float32(0)}, {"k": np.float32(0)}],
              "t": (False, 0, 0.0)}
    loader = RefLoader(str(tmp_path))
    got = loader.restore_tree(target, "params")
    for k in ("w", "b", "ids"):
        assert np.asarray(got[k]).tobytes() == want[k].tobytes(), k
    assert got["t"] == (True, 4, 0.25)
    assert loader.read_flat("opt.mu").tobytes() == flat.tobytes()
    assert loader.step == 11 and loader.meta == {"model": "t"}
    loader.close()


def test_bf16_leaves_written_as_fp32_and_restored_bitwise(tmp_path):
    """The port writes a bf16 tensor as fp32 (exact; numpy reads it with
    no ml_dtypes), and a bf16 target gets every bit back; the reference's
    loader reads the same file into an fp32 target."""
    x = torch.randn(64, 9, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    flat = torch.randn(301, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    _save(tmp_path, 4, {"m": {"x": x}}, {"zero.master.0": (flat, 301)})
    _, _, npz = _files(tmp_path, 4)
    assert {npz[k].dtype for k in npz.files} == {np.dtype(np.float32)}
    loader = CheckpointLoader(str(tmp_path))
    tx, tf = torch.zeros_like(x), torch.zeros_like(flat)
    loader.restore_tree({"x": tx}, "m")
    loader.restore_tree({"master": {"0": tf}}, "zero")
    assert torch.equal(tx.view(torch.int16), x.view(torch.int16))
    assert torch.equal(tf.view(torch.int16), flat.view(torch.int16))
    loader.close()
    ref = RefLoader(str(tmp_path)).restore_tree(
        {"x": np.zeros((64, 9), np.float32)}, "m")
    assert ref["x"].tobytes() == x.float().numpy().tobytes()


def test_reference_bf16_leaves_read_through_uint16(tmp_path):
    """The reference's bf16 arrays (``ml_dtypes``) reload as ``|V2``: the
    port reads a replicated leaf into a bf16 tensor bitwise, and refuses
    a target that is not bf16."""
    x = np.random.default_rng(5).standard_normal((16, 8)).astype(
        ml_dtypes.bfloat16)
    _save(tmp_path, 2, {"p": {"x": x}}, writer=RefWriter)
    _, _, npz = _files(tmp_path, 2)
    assert npz["rep.0"].dtype == np.dtype("V2")
    loader = CheckpointLoader(str(tmp_path))
    t = torch.zeros(16, 8, dtype=torch.bfloat16)
    loader.restore_tree({"x": t}, "p")
    assert t.view(torch.int16).numpy().tobytes() == x.tobytes()
    with pytest.raises(CheckpointError, match="bf16"):
        loader.restore_tree({"x": torch.zeros(16, 8)}, "p")
    with pytest.raises(CheckpointError, match="bf16"):
        loader.restore_tree({"x": np.zeros((16, 8), np.float32)}, "p")
    loader.close()


_NT = collections.namedtuple("_NT", ["mu", "nu", "count"])


def test_walk_paths_equal_the_reference():
    """Every checkpoint and push path is a walk path: the port's order and
    separators are the reference's, on nested dicts, lists, tuples,
    namedtuples, numpy arrays and scalars, with None and strings skipped."""
    tree = {"z": [np.zeros(2), {"b": 1, "a": 2.5}], "a": (True, None, "s"),
            10: np.float32(3), "m": _NT(np.ones(3), [np.int64(2)], 7),
            "e": {}, "l": []}
    got, want = [], []
    _walk(tree, "root", lambda p, leaf: got.append(p) or leaf)
    ref_walk(tree, "root", lambda p, leaf: want.append(p) or leaf)
    assert got == want and len(got) == 8
    # The same tree with torch tensors in the arrays' places walks alike.
    ttree = {"z": [torch.zeros(2), {"b": 1, "a": 2.5}],
             "a": (True, None, "s"), 10: torch.tensor(3.0),
             "m": _NT(torch.ones(3), [torch.tensor(2)], 7), "e": {}, "l": []}
    tgot = []
    _walk(ttree, "root", lambda p, leaf: tgot.append(p) or leaf)
    assert tgot == want


def test_snapshot_is_taken_before_the_next_in_place_step(tmp_path):
    """save() returns with the snapshot taken: an in-place update right
    after it (what optimizer.step does to params and moments) does not
    reach the written bytes."""
    p = torch.arange(4096, dtype=torch.float32)
    before = p.clone()
    w = CheckpointWriter(str(tmp_path), meta={})
    try:
        w.save(1, {"model": {"p": p}}, {"zero.master.0": (p, 4096)})
        p.mul_(-3.0).add_(1.0)
        w.wait(timeout=60)
    finally:
        w.close()
    loader = CheckpointLoader(str(tmp_path))
    assert loader.read_replicated("model.p").tobytes() == \
        before.numpy().tobytes()
    assert loader.read_flat("zero.master.0").tobytes() == \
        before.numpy().tobytes()
    loader.close()
    assert w.last_stall_ms > 0 and w.last_write_ms > 0


_NOTE = """
import json, os, sys
pkg = sys.argv[1]
if pkg == "port":
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime.engine import flight_note, get_engine
    hvd.init(device="cpu")
    lib = get_engine().lib
    import ctypes
    lib.horovod_flight_dump.argtypes = [ctypes.c_char_p]
    lib.horovod_flight_dump.restype = ctypes.c_int
    dump = lambda: lib.horovod_flight_dump(b"test") == 0
else:
    from horovod_tpu.common.basics import basics as hvd
    from horovod_tpu.runtime.engine import flight_note, get_engine
    hvd.init()
    lib = get_engine()._lib
    dump = lambda: get_engine().flight_dump("test")
n0 = lib.horovod_flight_events()
flight_note("ckpt", "commit step=3 bytes=9 world=1")
flight_note("x" * 40, "y" * 400)
n1 = lib.horovod_flight_events()
assert dump()
hvd.shutdown()
print(json.dumps({"added": n1 - n0}))
"""


def test_flight_note_lands_in_the_recorder_as_the_reference(tmp_path):
    """A note lands in the engine's flight recorder ring (and its dump) as
    the reference's does, cut to the ring's field widths the same way."""
    events, added = {}, {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("HOROVOD_")}
        env.update(HOROVOD_FLIGHT_RECORDER_DIR=str(d), JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", _NOTE, pkg], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        added[pkg] = json.loads(out.stdout.strip().splitlines()[-1])
        dump = json.load(open(d / "flightrec.rank0.json"))
        events[pkg] = [(e["kind"], e["text"]) for e in dump["events"]
                       if e["kind"] != "epoch"]
    assert added["port"] == added["ref"] == {"added": 2}
    assert events["port"] == events["ref"]
    assert events["port"][0] == ("ckpt", "commit step=3 bytes=9 world=1")


def test_jax_form_capture_restores_masters_and_adamw_bitwise(tmp_path):
    """The JAX-form optimizer over ``MasterWeights(AdamW)`` on a bf16 Llama:
    ``jax_capture`` then ``jax_restore`` into a fresh model and optimizer
    gives back the params, the fp32 masters and AdamW's state bit for bit,
    and the next step of both equals."""
    from horovod_tpu_torch.checkpoint import jax_capture, jax_restore
    from horovod_tpu_torch.frontend import DistributedOptimizer
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from horovod_tpu_torch.ops.mixed_precision import MasterWeights

    cfg = LlamaConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17))).long()

    def build(seed):
        model = LlamaModel.from_state_dict(cfg, init_params(cfg, seed, "cpu"))
        opt = DistributedOptimizer(MasterWeights(
            model.parameters(), torch.optim.AdamW, lr=1e-3))
        return model, opt

    def step(model, opt):
        # The inner step (a world of one reduces nothing).
        opt.inner.zero_grad()
        logits = model(tokens[:, :-1]).float()
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size),
            tokens[:, 1:].reshape(-1)).backward()
        opt.inner.step()

    model, opt = build(0)
    step(model, opt)
    _save(tmp_path, 1, *jax_capture(opt, model, 1))
    twin, topt = build(1)
    loader = CheckpointLoader(str(tmp_path))
    assert jax_restore(topt, twin, loader) == 1
    loader.close()
    for (n, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(opt.inner.masters, topt.inner.masters):
        assert torch.equal(a, b)
    step(model, opt)
    step(twin, topt)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
