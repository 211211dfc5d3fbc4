"""Port parity: the weight plane across ranks, on the CPU (gloo + engine).

The multi-rank legs of ``tests/test_checkpoint.py:360-454`` on the port,
through the port's launcher (``python -m horovod_tpu_torch.run``):

* ZeRO-1 (the hook form's ``sharded=True``) saved at world 2 writes the
  same manifest and arrays as the reference's ``torch_capture`` of the
  reference's own worker (``tests/ckpt_worker.py torch``, both on torch
  with the same fp32 model, optimizer and integer gradients), and
  restores at worlds 1 and 3 to the uninterrupted run's digest; so does
  the reference's checkpoint restored into the port;
* the unsharded hook form: the optimizer state rides the replicated tree
  (the reference's paths, saved once from rank 0) and restores in a
  world of one;
* FSDP (``fsdp=True``): ``FsdpPlane.sharded_state``/``restore`` and the
  optimizer's shards across 2 → 1;
* ``run_elastic`` + the env-configured writer: a full-fleet kill and
  relaunch resumes from the newest manifest with zero committed steps
  lost, and the ``ckpt-kill`` fault (rank 1 SIGKILLed between the halves
  of its shard write) never tears a checkpoint set.

The gradients are integer-valued and identical on every rank (the
reference's ``ckpt_worker.py`` idea), so the trajectory is bitwise the
same at any world size and a restore's correctness is a digest equality.
This file is also the port's worker: ``python
tests/test_torch_port_checkpoint_ranks.py SCENARIO`` runs one rank, and
imports neither jax nor the JAX package.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
REF_WORKER = os.path.join(REPO, "tests", "ckpt_worker.py")

LR = 0.05
DIM = 8


def _env_int(name, default):
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _int_grads(step: int, n: int) -> np.ndarray:
    """Rank-independent integer-valued fp32 gradients (every partial sum
    exact): the trajectory does not depend on the world size."""
    rng = np.random.default_rng(1000 + step)
    return rng.integers(-8, 9, n).astype(np.float32)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# the port's worker (one rank)
# ---------------------------------------------------------------------------

def _net():
    import torch

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(7)
            self.w = torch.nn.Parameter(torch.randn(137, 3))
            self.b = torch.nn.Parameter(torch.randn(19))

    return Net()


def _scenario_torch(fsdp: bool = False):
    """tests/ckpt_worker.py's ``torch`` scenario on the port (``fsdp``:
    the hook form's FSDP units instead of ZeRO-1)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.checkpoint import (CheckpointLoader,
                                              CheckpointWriter,
                                              torch_capture, torch_restore)

    hvd.init(device="cpu")
    rank = hvd.rank()
    sharded = os.environ.get("CKPT_SHARDED", "1") != "0"
    mode = os.environ.get("CKPT_MODE", "train")
    directory = os.environ["HOROVOD_CHECKPOINT_DIR"]
    total = _env_int("CKPT_TOTAL_STEPS", 30)
    model = _net()
    base = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    if fsdp:
        opt = torch_frontend.DistributedOptimizer(base, fsdp=True)
    else:
        opt = torch_frontend.DistributedOptimizer(base, sharded=sharded)
    n = 137 * 3 + 19
    step, entry = 0, -1
    if mode == "resume":
        loader = CheckpointLoader(directory)
        try:
            step = torch_restore(opt, model, loader)
            if fsdp:
                masters = [u.shard.clone() for u in opt.plane.units]
                opt.plane.restore(loader)
                assert all(torch.equal(m, u.shard) for m, u in
                           zip(masters, opt.plane.units))
        finally:
            loader.close()
        entry = step
    writer = CheckpointWriter(meta={"model": "ckpt-test"})
    while step < total:
        step += 1
        g = _int_grads(step, n)
        model.w.grad = torch.from_numpy(g[:137 * 3].reshape(137, 3).copy())
        model.b.grad = torch.from_numpy(g[137 * 3:].copy())
        opt.step()
        st, sh = torch_capture(opt, model, step)
        if fsdp:
            sh.update(opt.plane.sharded_state())
        if writer.maybe_save(step, st, sh):
            writer.wait(timeout=120)
    writer.close()
    tag = "CKPT_FSDP_OK" if fsdp else "CKPT_TORCH_OK"
    print(f"{tag} rank={rank} mode={mode} sharded={int(sharded)} "
          f"step={step} entry={entry} "
          f"digest={_digest(model.w.detach().numpy(), model.b.detach().numpy())}",
          flush=True)
    hvd.shutdown()


_writer = None
_entry_step = None


def _rank_target(rank: int):
    import torch

    return torch.linspace(rank + 1.0, rank + 2.0, DIM, dtype=torch.float64)


def _train_elastic(state):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import CheckpointWriter
    from horovod_tpu_torch.runtime.engine import HorovodInternalError

    global _writer, _entry_step
    if _writer is None:
        _writer = CheckpointWriter(meta={"scenario": "elastic"})
    if _entry_step is None:
        _entry_step = int(state.step)
    total = _env_int("CKPT_TOTAL_STEPS", 30)
    while state.step < total:
        grad = 2.0 * (state.w - _rank_target(hvd.rank()))
        if hvd.size() > 1:
            grad = hvd.allreduce(grad, average=True, name="ckel.g")
        with torch.no_grad():
            state.w.sub_(LR * grad)      # in place: restore must be too
        state.step += 1
        state.commit()
        try:
            _writer.maybe_save(int(state.step), state, None)
        except HorovodInternalError:
            pass


def _scenario_elastic():
    """tests/ckpt_worker.py's ``elastic`` scenario on the port: the
    weights a torch tensor, updated in place, under ``run_elastic``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ElasticState, run_elastic
    from horovod_tpu_torch.runtime.engine import HorovodInternalError

    hvd.init(device="cpu")
    state = ElasticState(w=torch.zeros(DIM, dtype=torch.float64), step=0)
    w0 = state.w
    run_elastic(_train_elastic, state)
    assert state.w is w0, "the weights were rebound"
    try:
        _writer.wait(timeout=60)
    except (HorovodInternalError, TimeoutError):
        pass
    total = _env_int("CKPT_TOTAL_STEPS", 30)
    tbar = torch.stack([_rank_target(r) for r in range(hvd.size())]).mean(0)
    expected = tbar * (1.0 - (1.0 - 2.0 * LR) ** total)
    assert torch.allclose(state.w, expected, rtol=0, atol=1e-9), (
        state.w, expected)
    print(f"CKPT_ELASTIC_OK rank={hvd.rank()} step={int(state.step)} "
          f"entry={_entry_step} last_commit={_writer.last_committed_step}",
          flush=True)
    _writer.close()
    hvd.shutdown()


def _rank_main(argv):
    scenario = argv[0] if argv else "elastic"
    {"torch": _scenario_torch, "fsdp": lambda: _scenario_torch(fsdp=True),
     "elastic": _scenario_elastic}[scenario]()
    assert "jax" not in sys.modules and "horovod_tpu" not in sys.modules


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _launch(np_, scenario, *, ckpt_dir, total, interval=4, mode=None,
            sharded=None, inject=None, restarts=0, reference=False,
            timeout=300):
    """``-np np_`` ranks of the port's worker through the port's launcher
    (``reference``: the reference's worker through the reference's)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "CKPT_"))}
    env.update({
        "HOROVOD_CYCLE_TIME": "2",
        "HOROVOD_FAULT_TIMEOUT_SEC": "5",
        "HOROVOD_ELASTIC_BACKOFF_SEC": "0.5",
        "HOROVOD_LINK_RETRIES": "0",
        "HOROVOD_CHECKPOINT_INTERVAL_STEPS": str(interval),
        "CKPT_TOTAL_STEPS": str(total),
        "PYTHONPATH": REPO,
    })
    if reference:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)
    if mode is not None:
        env["CKPT_MODE"] = mode
    if sharded is not None:
        env["CKPT_SHARDED"] = "1" if sharded else "0"
    if inject is not None:
        env["HOROVOD_FAULT_INJECT"] = inject
    pkg = "horovod_tpu" if reference else "horovod_tpu_torch"
    cmd = [sys.executable, "-m", f"{pkg}.run", "-np", str(np_),
           "--checkpoint-dir", ckpt_dir]
    if restarts:
        cmd += ["--restart-on-failure", str(restarts)]
    cmd += ["--", sys.executable, REF_WORKER if reference else THIS,
            scenario]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          timeout=timeout)


def _oks(p, tag):
    out = p.stdout.decode()
    assert p.returncode == 0, out[-4000:] + p.stderr.decode()[-4000:]
    return re.findall(
        rf"{tag} rank=(\d+) mode=(\w+) sharded=(\d) step=(\d+) "
        rf"entry=(-?\d+) digest=([0-9a-f]+)", out)


def _npz(directory, step, rank, size):
    from horovod_tpu_torch.checkpoint import manifest as mf

    return np.load(mf.shard_file(directory, step, rank, size))


def _assert_same_checkpoint(a, b, step, size):
    """Two checkpoint directories hold equal manifests (``epoch`` aside:
    the engines' membership counters) and equal arrays, key by key."""
    from horovod_tpu_torch.checkpoint import manifest as mf

    ma = json.load(open(mf.manifest_path(a, step)))
    mb = json.load(open(mf.manifest_path(b, step)))
    ma.pop("epoch")
    mb.pop("epoch")
    assert ma == mb
    for r in range(size):
        za, zb = _npz(a, step, r, size), _npz(b, step, r, size)
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (r, k)
            assert za[k].tobytes() == zb[k].tobytes(), (r, k)


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """ZeRO-1 trained 10 steps at world 2 by the reference's worker and by
    the port's (checkpoints at 4 and 8)."""
    out = {}
    for name, ref in (("ref", True), ("port", False)):
        d = str(tmp_path_factory.mktemp(f"zero_{name}"))
        rows = _oks(_launch(2, "torch", ckpt_dir=d, total=10, mode="train",
                            reference=ref), "CKPT_TORCH_OK")
        assert len(rows) == 2 and {r[4] for r in rows} == {"-1"}
        out[name] = (d, {r[5] for r in rows})
    return out


def test_zero1_checkpoint_equals_the_reference_torch_capture(zero_runs):
    (dr, dig_r), (dp, dig_p) = zero_runs["ref"], zero_runs["port"]
    assert len(dig_p) == 1 and dig_p == dig_r
    _assert_same_checkpoint(dr, dp, 8, 2)


@pytest.mark.parametrize("world", [1, 3])
def test_zero1_saved_at_world2_restores_at_another_world(zero_runs, world,
                                                         tmp_path):
    """Masters and momentum resliced through shard_bounds at world 1 and
    world 3, the params re-derived from the masters: the uninterrupted
    run's digest."""
    d, digest = zero_runs["port"]
    rows = _oks(_launch(world, "torch", ckpt_dir=d, total=10,
                        mode="resume"), "CKPT_TORCH_OK")
    assert len(rows) == world
    assert {r[4] for r in rows} == {"8"}, rows
    assert {r[5] for r in rows} == digest


def test_reference_zero1_checkpoint_restores_in_the_port(zero_runs,
                                                         tmp_path):
    d, digest = zero_runs["ref"]
    rows = _oks(_launch(1, "torch", ckpt_dir=d, total=10, mode="resume"),
                "CKPT_TORCH_OK")
    assert [(r[4], r[5]) for r in rows] == [("8", next(iter(digest)))]


def test_unsharded_replicated_restore_bitexact(tmp_path):
    """sharded=False: the whole optimizer state rides the replicated tree,
    saved once from rank 0 under the reference's paths; a world-2 save
    restores in a world of one with the same digest."""
    dr, dp = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = _oks(_launch(2, "torch", ckpt_dir=dr, total=10, mode="train",
                       sharded=False, reference=True), "CKPT_TORCH_OK")
    train = _oks(_launch(2, "torch", ckpt_dir=dp, total=10, mode="train",
                         sharded=False), "CKPT_TORCH_OK")
    digest = {r[5] for r in train}
    assert len(digest) == 1 and digest == {r[5] for r in ref}
    _assert_same_checkpoint(dr, dp, 8, 2)
    rows = _oks(_launch(1, "torch", ckpt_dir=dp, total=10, mode="resume",
                        sharded=False), "CKPT_TORCH_OK")
    assert [(r[4], r[5]) for r in rows] == [("8", next(iter(digest)))]


def test_fsdp_sharded_state_restores_across_2_to_1(tmp_path):
    d = str(tmp_path)
    train = _oks(_launch(2, "fsdp", ckpt_dir=d, total=10, mode="train"),
                 "CKPT_FSDP_OK")
    digest = {r[5] for r in train}
    assert len(train) == 2 and len(digest) == 1
    from horovod_tpu_torch.checkpoint import CheckpointLoader

    loader = CheckpointLoader(d)
    assert loader.world_size == 2
    assert "fsdp.torch.u0" in loader.sharded_names()
    assert loader.read_flat("fsdp.torch.u0").tobytes() == \
        loader.read_flat("zero.master.0").tobytes()
    loader.close()
    rows = _oks(_launch(1, "fsdp", ckpt_dir=d, total=10, mode="resume"),
                "CKPT_FSDP_OK")
    assert [(r[4], r[5]) for r in rows] == [("8", next(iter(digest)))]


def test_full_fleet_kill_then_relaunch_loses_zero_committed_steps(tmp_path):
    """A 2-rank elastic run trains and checkpoints; a FRESH fleet on the
    same directory resumes from the newest manifest (disk beats memory
    when rank 0 lost progress) and lands on the closed form."""
    from horovod_tpu_torch.checkpoint import latest_manifest

    d = str(tmp_path)
    p1 = _launch(2, "elastic", ckpt_dir=d, total=30, interval=10)
    out1 = p1.stdout.decode()
    assert p1.returncode == 0, out1 + p1.stderr.decode()
    assert out1.count("CKPT_ELASTIC_OK") == 2, out1
    assert latest_manifest(d)[1] == 30
    p2 = _launch(2, "elastic", ckpt_dir=d, total=60, interval=10)
    out2 = p2.stdout.decode() + p2.stderr.decode()
    assert p2.returncode == 0, out2
    assert "restored from checkpoint step 30" in out2, out2
    rows = re.findall(r"CKPT_ELASTIC_OK rank=\d+ step=(\d+) entry=(\d+) "
                      r"last_commit=(\d+)", out2)
    assert len(rows) == 2, out2
    assert {r[1] for r in rows} == {"30"}, rows
    assert {r[0] for r in rows} == {"60"}, rows
    assert {r[2] for r in rows} == {"60"}, rows
    assert latest_manifest(d)[1] == 60


def test_ckpt_kill_mid_shard_write_never_tears_a_checkpoint(tmp_path):
    """Rank 1 is SIGKILLed between the two halves of its step-20 shard
    write: a torn ``.tmp`` and NO step-20 manifest; the previous commit
    stays loadable; the relaunch recovers and later checkpoints commit on
    every rank."""
    from horovod_tpu_torch.checkpoint import CheckpointLoader
    from horovod_tpu_torch.checkpoint import manifest as mf

    d = str(tmp_path)
    p = _launch(2, "elastic", ckpt_dir=d, total=30, interval=10,
                inject="1:20:ckpt-kill", restarts=2)
    out = p.stdout.decode() + p.stderr.decode()
    assert p.returncode == 0, out
    assert "FAULT INJECT: ckpt-kill at step 20" in out, out
    assert "relaunching" in out, out
    rows = re.findall(r"CKPT_ELASTIC_OK rank=\d+ step=(\d+) entry=(\d+) "
                      r"last_commit=(-?\d+)", out)
    assert len(rows) == 2, out
    assert set(mf.list_manifest_steps(d)) == {10, 30}, os.listdir(d)
    assert os.path.exists(mf.shard_file(d, 20, 1, 2) + ".tmp")
    for step in (10, 30):
        mf.validate(d, mf.read_manifest(d, step))
    loader = CheckpointLoader(d)
    assert loader.step == 30
    loader.close()
    assert {r[2] for r in rows} == {"30"}, rows


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
