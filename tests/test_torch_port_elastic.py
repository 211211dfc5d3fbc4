"""Port parity: elastic recovery on the CPU (gloo + engine).

The port's ``ElasticState`` and ``run_elastic`` against the JAX package's
``horovod_tpu.elastic``:

* commit / restore / sync of the same state, in a world of one and on 2
  ranks (each package's own launcher and engine): the same values and the
  same leaf types after every call (Python scalars stay Python, numpy
  scalars and arrays keep their dtypes); a torch tensor slot is restored
  and synced in place;
* ``run_elastic`` recovering a killed worker (the launcher relaunches
  it) to the identical final loss of an uninterrupted run, as
  ``tests/test_fault_tolerance.py:350`` does;
* a shrink under ``--elastic``: the dead rank is abandoned and the
  survivors re-form the engine and the torch group at size 2;
* the retry budget and the backoff schedule, equal to the reference's at
  the same worker id;
* the re-init after a failure keeps the first ``init``'s device and
  backend.

This file is also the port's worker: ``python
tests/test_torch_port_elastic.py SCENARIO`` runs one rank.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
LR = 0.05
DIM = 8


def _slots(rank, tensors=False):
    """The state both packages hold: rank-dependent values of every leaf
    kind (``tensors``: the array slot as a torch tensor)."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3) + rank
    if tensors:
        import torch

        w = torch.from_numpy(w)
    return {"w": w, "step": 3 + rank, "lr": 0.5 * (rank + 1),
            "flag": bool(rank), "cnt": np.int32(7 + rank),
            "nested": {"a": [np.float64(1.5 + rank),
                             np.ones(3, np.int64) * rank], "s": "keep"}}


def _describe(state):
    """``{path: (kind, dtype, values)}`` of every slot's leaves, a tensor
    and an array alike."""
    out = {}

    def leaf(path, v):
        if hasattr(v, "numpy") and hasattr(v, "detach"):
            v = v.detach().numpy()
        if isinstance(v, np.ndarray):
            out[path] = ("array", str(v.dtype), v.tolist())
        elif isinstance(v, np.generic):
            out[path] = ("np", str(v.dtype), v.item())
        else:
            out[path] = (type(v).__name__, None, v)

    def walk(obj, path):
        if isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{path}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}.{i}")
        else:
            leaf(path, obj)

    for k in state._keys:
        walk(getattr(state, k), k)
    return out


def _exercise(state):
    """commit → mutate → restore → mutate → sync: the description after
    each restore and sync."""
    import copy

    seen = {"init": _describe(state)}
    w = state.w
    w += 100
    state.step += 10
    state.lr = -1.0
    state.nested["a"][0] = np.float64(-7)
    state.restore()
    seen["restore"] = _describe(state)
    seen["restore_in_place"] = state.w is w if hasattr(w, "detach") else None
    state.step += 1
    state.sync()
    seen["sync"] = _describe(state)
    seen["sync_in_place"] = state.w is w if hasattr(w, "detach") else None
    seen["commits"] = state.commit_count
    return copy.deepcopy(seen)


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _scenario_sync(reference: bool):
    if reference:
        from horovod_tpu.common.basics import basics as hvd
        from horovod_tpu.elastic import ElasticState

        hvd.init()
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.elastic import ElasticState

        hvd.init(device="cpu")
    state = ElasticState(**_slots(hvd.rank(), tensors=not reference))
    out = _exercise(state)
    out["rank"] = hvd.rank()
    print("SYNC " + json.dumps(out), flush=True)
    hvd.shutdown()


def _rank_target(rank):
    import torch

    return torch.linspace(rank + 1.0, rank + 2.0, DIM, dtype=torch.float64)


def _scenario_train():
    """tests/elastic_worker.py on the port: SGD towards the ranks' mean
    target, committing every step, under run_elastic."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ElasticState, run_elastic

    total = int(os.environ.get("ELASTIC_TOTAL_STEPS", "30"))
    hvd.init(device="cpu")
    state = ElasticState(w=torch.zeros(DIM, dtype=torch.float64), step=0)
    sizes = set()

    def train(state):
        while state.step < total:
            sizes.add(hvd.size())
            grad = 2.0 * (state.w - _rank_target(hvd.rank()))
            if hvd.size() > 1:
                # Unnamed: the auto names must restart with the engine.
                grad = hvd.allreduce(grad, average=True)
            with torch.no_grad():
                state.w.sub_(LR * grad)
            state.step += 1
            state.commit()

    run_elastic(train, state)
    size = hvd.size()
    tbar = torch.stack([_rank_target(r) for r in range(size)]).sum(0) / size
    if len(sizes) == 1:
        expected = tbar * (1.0 - (1.0 - 2.0 * LR) ** total)
        assert torch.allclose(state.w, expected, rtol=0, atol=1e-9)
    loss = float(((state.w - tbar) ** 2).mean())
    print(f"ELASTIC_OK id={os.environ.get('HOROVOD_RANK')} "
          f"rank={hvd.rank()} size={size} epoch={hvd.epoch()} "
          f"sizes={','.join(map(str, sorted(sizes)))} loss={loss:.12e} "
          f"device={hvd.device()}", flush=True)
    hvd.shutdown()


def _scenario_reinit():
    """A world of one: the first train_fn call fails; run_elastic's
    re-init must use the first init's device and backend (cpu, gloo),
    not the default (the CUDA device, which raises here)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ElasticState, run_elastic
    from horovod_tpu_torch.runtime.engine import HorovodInternalError

    hvd.init(device="cpu", backend="gloo")
    state = ElasticState(w=torch.ones(3), step=0)
    calls = []

    def train(state):
        calls.append((str(hvd.device()), dist.get_backend()))
        if len(calls) == 1:
            state.w.mul_(5)
            raise HorovodInternalError("injected")
        return state.w.tolist()

    out = run_elastic(train, state, max_retries=2, backoff_sec=0.01)
    print("REINIT " + json.dumps({"calls": calls, "w": out}), flush=True)
    hvd.shutdown()


def _rank_main(argv):
    scenario = argv[0]
    if scenario == "ref_sync":
        _scenario_sync(reference=True)
        return
    {"sync": lambda: _scenario_sync(False), "train": _scenario_train,
     "reinit": _scenario_reinit}[scenario]()
    assert "jax" not in sys.modules and "horovod_tpu" not in sys.modules


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _env(reference=False, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "ELASTIC_"))}
    env.update({"HOROVOD_CYCLE_TIME": "2", "HOROVOD_FAULT_TIMEOUT_SEC": "5",
                "HOROVOD_ELASTIC_BACKOFF_SEC": "0.5",
                "HOROVOD_ELASTIC_MAX_RETRIES": "4",
                "HOROVOD_LINK_RETRIES": "0", "PYTHONPATH": REPO})
    if reference:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)
    env.update(extra)
    return env


def _run(np_, scenario, *, reference=False, flags=(), env=None,
         timeout=240):
    pkg = "horovod_tpu" if reference else "horovod_tpu_torch"
    cmd = [sys.executable, "-m", f"{pkg}.run", "-np", str(np_), *flags,
           "--", sys.executable, THIS, scenario]
    return subprocess.run(cmd, cwd=REPO, env=env or _env(reference),
                          capture_output=True, text=True, timeout=timeout)


def _lines(p, tag):
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    return [json.loads(ln.split(tag + " ", 1)[1])
            for ln in p.stdout.splitlines() if (tag + " ") in ln]


def _normal(desc):
    """JSON round trip: tuples become lists on both sides."""
    return json.loads(json.dumps(desc))


def test_commit_restore_sync_in_a_world_of_one_match_the_reference():
    import torch

    from horovod_tpu.elastic import ElasticState as RefState
    from horovod_tpu_torch.elastic import ElasticState

    ref = _exercise(RefState(**_slots(0)))
    port = _exercise(ElasticState(**_slots(0)))
    assert _normal(port) == _normal(ref)
    # A tensor slot: the same values, restored and synced in place.
    tport = _exercise(ElasticState(**_slots(0, tensors=True)))
    assert tport["restore_in_place"] and tport["sync_in_place"]
    for key in ("init", "restore", "sync"):
        assert _normal(tport[key]) == _normal(ref[key])
    # A slot whose structure changed since the commit is rebuilt.
    st = ElasticState(p={"a": torch.ones(2)}, step=0)
    st.p = {"b": torch.zeros(4)}
    st.restore()
    assert list(st.p) == ["a"] and torch.equal(st.p["a"], torch.ones(2))


def test_commit_restore_sync_on_two_ranks_match_the_reference():
    ref = sorted(_lines(_run(2, "ref_sync", reference=True), "SYNC"),
                 key=lambda d: d["rank"])
    port = sorted(_lines(_run(2, "sync"), "SYNC"), key=lambda d: d["rank"])
    assert len(ref) == len(port) == 2
    for r, p in zip(ref, port):
        assert p["init"] == r["init"] and p["restore"] == r["restore"]
        assert p["sync"] == r["sync"]
        assert p["restore_in_place"] and p["sync_in_place"]
    # Everyone left sync with rank 0's values.
    assert port[1]["sync"] == port[0]["sync"]
    assert port[1]["sync"]["w"] == port[0]["restore"]["w"]
    assert port[1]["sync"]["step"] == ["int", None, 4]


def _train_losses(p):
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    return re.findall(r"ELASTIC_OK id=(\d+) rank=(\d+) size=(\d+) "
                      r"epoch=(\d+) sizes=(\S+) loss=(\S+) device=(\S+)",
                      p.stdout)


def test_run_elastic_recovers_a_killed_worker_to_the_identical_loss():
    """Rank 1 exits at its 12th enqueue (training step 10: two sync
    broadcasts come first); the launcher relaunches it, rank 0 rolls back
    in place and both finish with the uninterrupted run's loss."""
    faulted = _run(2, "train", flags=("--restart-on-failure", "2"),
                   env=_env(HOROVOD_FAULT_INJECT="1:12:exit"))
    assert "relaunching" in faulted.stderr, faulted.stderr[-3000:]
    assert "rolling back" in faulted.stdout, faulted.stdout[-3000:]
    clean = _run(2, "train")
    f, c = _train_losses(faulted), _train_losses(clean)
    assert len(f) == len(c) == 2
    assert {ok[5] for ok in f} == {ok[5] for ok in c}
    assert len({ok[5] for ok in f}) == 1


def test_shrink_under_elastic_abandons_the_dead_rank():
    """Rank 2 of 3 dies and is never replaced: the survivors re-form the
    world (engine and torch group) at size 2 under a new epoch, finish,
    and agree on the loss."""
    p = _run(3, "train", flags=("--elastic",),
             env=_env(HOROVOD_FAULT_INJECT="2:10:exit",
                      HOROVOD_ELASTIC_GROW_TIMEOUT_SEC="2",
                      HOROVOD_ELASTIC_MIN_SIZE="1"))
    oks = _train_losses(p)
    assert len(oks) == 2, p.stdout[-3000:] + p.stderr[-3000:]
    assert {ok[2] for ok in oks} == {"2"}
    assert {ok[4] for ok in oks} == {"2,3"}
    assert min(int(ok[3]) for ok in oks) >= 2
    assert len({ok[5] for ok in oks}) == 1
    assert "abandoning it" in p.stderr


class _FakeState:
    """What run_elastic uses of a state: sync, commit_count, restore."""

    def __init__(self):
        self.commit_count = 0
        self.restores = 0

    def sync(self):
        self.commit_count += 1

    def restore(self):
        self.restores += 1


def _drive(pkg, monkeypatch, commits_at):
    """Run each package's run_elastic on a train_fn that fails every
    time (committing on the attempts in ``commits_at``), with init and
    shutdown stubbed; returns (sleeps, attempts, restores)."""
    if pkg == "ref":
        from horovod_tpu.common.basics import basics
        from horovod_tpu.elastic import driver
        from horovod_tpu.runtime.engine import HorovodInternalError
    else:
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.elastic import driver
        from horovod_tpu_torch.runtime.engine import HorovodInternalError
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "shutdown", lambda: None)
    sleeps = []
    monkeypatch.setattr(driver.time, "sleep", sleeps.append)
    state, attempts = _FakeState(), []

    def train(st):
        attempts.append(len(attempts))
        if len(attempts) in commits_at:
            st.commit_count += 1
        raise HorovodInternalError("boom")

    with pytest.raises(HorovodInternalError):
        driver.run_elastic(train, state, max_retries=3, backoff_sec=1.5)
    monkeypatch.undo()
    return sleeps, len(attempts), state.restores


@pytest.mark.parametrize("worker_id", ["0", "3"])
@pytest.mark.parametrize("commits_at", [(), (2,), (1, 3, 5)])
def test_retry_budget_and_backoff_equal_the_reference(monkeypatch,
                                                      worker_id, commits_at):
    monkeypatch.setenv("HOROVOD_RANK", worker_id)
    monkeypatch.delenv("HOROVOD_CHECKPOINT_DIR", raising=False)
    ref = _drive("ref", monkeypatch, commits_at)
    monkeypatch.setenv("HOROVOD_RANK", worker_id)
    monkeypatch.delenv("HOROVOD_CHECKPOINT_DIR", raising=False)
    port = _drive("port", monkeypatch, commits_at)
    assert port == ref
    # A commit between failures resets the budget: more attempts.
    assert ref[1] == 4 if not commits_at else ref[1] > 4


def test_reinit_keeps_the_first_init_device_and_backend():
    env = _env()
    for k in ("HOROVOD_CYCLE_TIME",):
        env.pop(k)
    p = subprocess.run([sys.executable, THIS, "reinit"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    out = _lines(p, "REINIT")[0]
    assert out["calls"] == [["cpu", "gloo"], ["cpu", "gloo"]]
    assert out["w"] == [1.0, 1.0, 1.0]     # rolled back in place


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
