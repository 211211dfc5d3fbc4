"""Port parity: the engine-driven optimizers.

* The hook form, ``torch_frontend.DistributedOptimizer``, against the
  reference torch frontend's (``horovod_tpu.torch``) at 2 ranks: the
  parameters bitwise after 3 steps for SGD with momentum and Adam, named
  and unnamed parameters (one name counter across param groups),
  ``backward_passes_per_step=2``, fp16 compression and ``wire_bf16``,
  sparse embeddings gathered or ``sparse_as_dense``, the force-allreduce
  of a parameter without a gradient, and the layout probe where one
  rank's gradient is sparse and the other's is absent (the
  ``SparseGradRetry`` path); priorities stamped in registration order
  under ``HOROVOD_PRIORITY_BANDS=1`` with no inversion counted;
  ``local_sgd_steps=3`` bitwise after every step.
* A local-SGD sync that a backup-worker partial commit leaves a rank out
  of (``HOROVOD_BACKUP_WORKERS=1`` and a slow rank, as
  ``tests/test_straggler.py`` makes one): the straggler keeps its local
  parameters and counts no sync, on both sides alike.
* The JAX-form ``frontend.DistributedOptimizer(sharded=/fsdp=/
  local_sgd_steps=)`` against ``horovod_tpu.jax.DistributedOptimizer``
  with ``optax.sgd`` on fp32 parameters: within 1e-6 after 3 steps
  (optax and ``torch.optim.SGD`` round the update differently); and
  bitwise equal to the port's own hook-form rung.
* Every refusal the factories keep raises with the reference's message;
  top-k with the sharded rungs is refused as the reference refuses it,
  and builds with the hook mixin and with local SGD (its paths are held
  in ``tests/test_torch_port_sparse.py``).

Each world is this file run as a script once per rank (``_rank_main``),
as ``tests/test_torch_port_engine.py`` does; reference and port run in
separate processes, each with its own engine.  A port process imports no
JAX (it checks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LR = 0.05
LOCAL_SGD_H = 3
#: The JAX-form cases' parameter tree, name -> shape.
JF_SHAPES = {"a.w": (3, 4), "a.b": (4,), "b.w": (4, 2)}


def _model(seed=5):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 9), torch.nn.Tanh(),
                               torch.nn.Linear(9, 3))


def _loss(m, step, rank):
    rng = np.random.default_rng(1000 * step + rank)
    x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    return ((m(x) - y) ** 2).mean()


def _flat(params):
    return np.concatenate([p.detach().reshape(-1).numpy() for p in params])


def _fp16_eager(mod, Compression, rank, tag):
    """The fp16 case as the reference computes it eagerly: each gradient
    through its fp16-compressed allreduce, then the same inner step.  The
    reference's hook form is not the yardstick there: it drops compressed
    reductions (``p.grad.data.set_`` rebinds an alias; ROADMAP.md Queue
    C)."""
    m = _model()
    opt = torch.optim.SGD(m.parameters(), lr=LR)
    out = {}
    for step in range(STEPS):
        opt.zero_grad()
        _loss(m, step, rank).backward()
        for n, p in m.named_parameters():
            p.grad.copy_(mod.allreduce(p.grad, True, f"{tag}.{n}",
                                       compression=Compression.fp16))
        opt.step()
        out[f"{tag}.params.{step}"] = _flat(m.parameters())
    return out


def _hook_program(mod, Compression, rank, size, reference=False):
    """The hook-form cases, the same calls on either side (``mod``:
    ``horovod_tpu.torch`` or the port's ``torch_frontend``).  The
    reference's fp16 case is :func:`_fp16_eager`; its hook form's is kept
    as ``fp16_hook``, to show the reference fault."""
    out = {}
    if reference:
        out.update(_fp16_eager(mod, Compression, rank, "fp16"))
    cases = {
        "sgd_named": (lambda m: torch.optim.SGD(m.parameters(), lr=LR,
                                                momentum=0.9), True, {}),
        "adam_unnamed": (lambda m: torch.optim.Adam(
            [{"params": m[0].parameters()},
             {"params": m[2].parameters(), "lr": 2e-3}], lr=1e-3),
            False, {}),
        "bpps2": (lambda m: torch.optim.SGD(m.parameters(), lr=LR), True,
                  dict(backward_passes_per_step=2)),
        "fp16": (lambda m: torch.optim.SGD(m.parameters(), lr=LR), True,
                 dict(compression=Compression.fp16)),
        "wire_bf16": (lambda m: torch.optim.SGD(m.parameters(), lr=LR),
                      True, dict(compression=Compression.wire_bf16)),
        "local_sgd": (lambda m: torch.optim.SGD(m.parameters(), lr=LR,
                                                momentum=0.9), True,
                      dict(local_sgd_steps=LOCAL_SGD_H)),
    }
    for tag, (make, named, kw) in cases.items():
        if reference and tag == "fp16":
            tag = "fp16_hook"
        m = _model()
        names = ([(f"{tag}.{n}", p) for n, p in m.named_parameters()]
                 if named else None)
        opt = mod.DistributedOptimizer(make(m), named_parameters=names, **kw)
        if tag == "adam_unnamed":
            out[f"{tag}.names"] = np.array(sorted(opt._param_names.values()))
        steps = 2 * STEPS if tag == "local_sgd" else STEPS
        for step in range(steps):
            opt.zero_grad()
            passes = 2 if tag == "bpps2" else 1
            for k in range(passes):
                _loss(m, passes * step + k, rank).backward()
            opt.step()
            out[f"{tag}.params.{step}"] = _flat(m.parameters())
        if tag == "local_sgd":
            out[f"{tag}.syncs"] = np.array(opt._local_sgd.sync_count)

    # Sparse gradients, gathered and densified (torch_worker's scenario).
    for tag, dense in (("sparse_gather", False), ("sparse_dense", True)):
        torch.manual_seed(5)
        emb = torch.nn.Embedding(12, 4, sparse=True)
        opt = mod.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.1),
            named_parameters=[(f"{tag}.emb", emb.weight)],
            sparse_as_dense=dense)
        idx = torch.tensor([rank % 12, (rank + 5) % 12, 3])
        opt.zero_grad()
        emb(idx).pow(2).sum().backward()
        opt.step()
        assert emb.weight.grad.is_sparse == (not dense)
        out[f"{tag}.grad"] = emb.weight.grad.to_dense().numpy()
        out[f"{tag}.params.0"] = emb.weight.detach().numpy()

    # Force-allreduce of a parameter that got no gradient.
    torch.manual_seed(5)
    md = torch.nn.ModuleDict({"used": torch.nn.Linear(2, 1),
                              "unused": torch.nn.Linear(2, 1)})
    opt = mod.DistributedOptimizer(
        torch.optim.SGD(md.parameters(), lr=0.1),
        named_parameters=[(f"force.{n}", p) for n, p in
                          md.named_parameters()])
    opt.zero_grad()
    md["used"](torch.full((4, 2), float(rank + 1))).sum().backward()
    opt.step()
    out["force.params.0"] = _flat(md.parameters())
    out["force.unused_grad"] = md["unused"].weight.grad.numpy()

    # The layout probe: on step 0 rank 0's embedding has no gradient and
    # no recorded layout while rank 1's is sparse, so rank 0's probe is
    # answered "retry sparsely" and it joins the gathers with nothing.
    torch.manual_seed(5)
    emb = torch.nn.Embedding(8, 3, sparse=True)
    lin = torch.nn.Linear(3, 1)
    named = [("probe.emb", emb.weight)] + [
        (f"probe.lin.{k}", v) for k, v in lin.named_parameters()]
    opt = mod.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1),
        named_parameters=named)
    for step in range(2):
        opt.zero_grad()
        loss = lin(torch.ones(2, 3)).sum()
        if rank != 0 or step > 0:
            loss = loss + emb(torch.tensor([(rank + step) % 8])).sum()
        loss.backward()
        opt.step()
        out[f"probe.params.{step}"] = _flat(p for _, p in named)
        out[f"probe.sparse.{step}"] = np.array(emb.weight.grad.is_sparse)
    return out


def _jf_params():
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in JF_SHAPES.items()}


def _jf_grads(step, rank):
    rng = np.random.default_rng(500 + 10 * step + rank)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in JF_SHAPES.items()}


_JF_RUNGS = {"sharded": dict(sharded=True), "fsdp": dict(fsdp=True),
             "local_sgd": dict(local_sgd_steps=STEPS)}


def _jf_port_program(hvd, torch_frontend, rank):
    """The JAX-form frontend's rungs, and the same rungs of the hook
    form, on parameters whose loss is ``sum(p * G)`` (so the gradient is
    ``G`` exactly, in either framework)."""
    out = {}
    for rung, kw in _JF_RUNGS.items():
        for form in ("jaxform", "hook"):
            named = [(n, torch.nn.Parameter(torch.from_numpy(v)))
                     for n, v in _jf_params().items()]
            params = [p for _, p in named]
            if form == "jaxform":
                opt = hvd.DistributedOptimizer(
                    torch.optim.SGD(params, lr=LR), named_parameters=named,
                    **kw)
            else:
                # One param group per top-level name: the JAX form's
                # default FSDP units.
                groups = [{"params": params[:2]}, {"params": params[2:]}]
                opt = torch_frontend.DistributedOptimizer(
                    torch.optim.SGD(groups if rung == "fsdp" else params,
                                    lr=LR), named_parameters=named, **kw)
            for step in range(STEPS):
                g = _jf_grads(step, rank)
                opt.zero_grad()
                sum((p * torch.from_numpy(g[n])).sum()
                    for n, p in named).backward()
                opt.step()
            out[f"jf.{rung}.{form}"] = _flat(params)
    return out


def _jf_jax_program(rank):
    import jax.numpy as jnp
    import optax
    import horovod_tpu.jax as hvd

    def tree(d):
        return {"a": {"b": jnp.asarray(d["a.b"]), "w": jnp.asarray(d["a.w"])},
                "b": {"w": jnp.asarray(d["b.w"])}}

    out = {}
    for rung, kw in _JF_RUNGS.items():
        params = tree(_jf_params())
        opt = hvd.DistributedOptimizer(optax.sgd(LR), **kw)
        state = opt.init(params)
        if opt.local_sgd is not None:
            # The hook form anchors before its first local step.
            opt.local_sgd.begin(params)
        for step in range(STEPS):
            updates, state = opt.update(tree(_jf_grads(step, rank)), state,
                                        params)
            params = optax.apply_updates(params, updates)
            if opt.local_sgd is not None:
                params = opt.local_sgd.maybe_sync(params)
        out[f"jf.{rung}.jax"] = np.concatenate([
            np.asarray(params["a"]["w"]).ravel(),
            np.asarray(params["a"]["b"]).ravel(),
            np.asarray(params["b"]["w"]).ravel()])
    return out


def _skip_program(mod, rank, barrier):
    """Local SGD (H=2, 4 steps) of one weight with rank 1 slow: each outer
    sync commits without it.  ``barrier(name)`` (a Max allreduce, never
    committed without a rank) starts every step on both ranks together,
    so only the injected delay decides who is late, and keeps rank 0
    from shutting down before the straggler is done."""
    torch.manual_seed(5)
    lin = torch.nn.Linear(6, 3, bias=False)
    opt = mod.DistributedOptimizer(
        torch.optim.SGD(lin.parameters(), lr=LR),
        named_parameters=[("skip.w", lin.weight)], local_sgd_steps=2)
    out = {}
    for step in range(4):
        opt.zero_grad()
        rng = np.random.default_rng(1000 * step + rank)
        x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
        lin(x).pow(2).mean().backward()
        barrier(f"skip.b{step}")
        opt.step()
        out[f"skip.params.{step}"] = _flat(lin.parameters())
    out["skip.syncs"] = np.array(opt._local_sgd.sync_count)
    barrier("skip.done")
    return out


def _rank_main(mode: str, dst: str) -> None:
    """One rank: ``python tests/test_torch_port_optimizers.py MODE
    OUT.npz``.  ``ref``/``port``: the hook-form cases (the port also runs
    its JAX-form cases); ``jax``: ``horovod_tpu.jax``'s rungs;
    ``ref_skip``/``port_skip``: the partial-commit case."""
    if mode == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu.jax as hvd

        hvd.init()
        out = _jf_jax_program(hvd.rank())
    elif mode.startswith("ref"):
        import horovod_tpu.torch as mod
        from horovod_tpu.runtime.engine import get_engine
        from horovod_tpu.torch.compression import Compression

        mod.init()
        if mode == "ref":
            out = _hook_program(mod, Compression, mod.rank(), mod.size(),
                                reference=True)
        else:
            out = _skip_program(mod, mod.rank(), lambda name: get_engine(
            ).allreduce(np.ones(1, np.float32), red_op="max", name=name))
        st = get_engine().stats()
        out["stats"] = np.array([st["priority_inversions"],
                                 st["local_sgd_syncs"]])
        mod.shutdown()
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import torch_frontend
        from horovod_tpu_torch.runtime.engine import get_engine

        hvd.init(device="cpu")
        eng = get_engine()
        stamped = []
        enqueue = eng.enqueue_allreduce

        def spy(buf, name=None, **kw):
            stamped.append((name, kw.get("priority")))
            return enqueue(buf, name=name, **kw)

        eng.enqueue_allreduce = spy
        if mode == "port":
            out = _hook_program(torch_frontend, hvd.Compression, hvd.rank(),
                                hvd.size())
            out.update(_jf_port_program(hvd, torch_frontend, hvd.rank()))
        else:
            out = _skip_program(torch_frontend, hvd.rank(), lambda name: eng.
                                synchronize(enqueue(torch.ones(1), name=name,
                                                    red_op="max")))
        names = [f"sgd_named.{n}" for n, _ in _model().named_parameters()]
        out["priorities"] = np.array(
            [dict((n, p) for n, p in stamped if n in names)[n]
             for n in names] if mode == "port" else [])
        st = eng.stats()
        out["stats"] = np.array([st["priority_inversions"],
                                 st["local_sgd_syncs"]])
        out["bands"] = np.array(st["config"]["priority_bands"])
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        assert not bad, bad
        hvd.shutdown()
    np.savez(dst, **out)


def _start_world(mode, n, tmp_path, extra_env):
    from test_torch_port_engine import _free_port

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests"),
               JAX_PLATFORMS="cpu",
               HOROVOD_COORDINATOR=f"127.0.0.1:{_free_port()}", **extra_env)
    outs = [tmp_path / f"{mode}{n}.{r}.npz" for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(outs[r])],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                 HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    return procs, outs


#: A slow rank 1 that backup workers commit without (test_straggler.py's
#: settings, with each of rank 1's enqueues delayed 1.5 s).
SKIP_ENV = {"HOROVOD_BACKUP_WORKERS": "1", "HOROVOD_BACKUP_GRACE_MS": "50",
            "HOROVOD_FAULT_INJECT": "1:*:slow:1500"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of 2 ranks: {mode: outputs}.  Two waves, so that the
    file never runs more than six processes at once."""
    from test_torch_port_engine import _finish

    tmp = tmp_path_factory.mktemp("optimizers")
    bands = {"HOROVOD_PRIORITY_BANDS": "1"}
    out = {}
    for wave in ((("port", bands), ("ref", bands)),
                 (("jax", {}), ("port_skip", SKIP_ENV),
                  ("ref_skip", SKIP_ENV))):
        started = {mode: _start_world(mode, 2, tmp, env)
                   for mode, env in wave}
        out.update({mode: _finish(w, timeout=240)
                    for mode, w in started.items()})
    return out


_HOOK_CASES = {"sgd_named": STEPS, "adam_unnamed": STEPS, "bpps2": STEPS,
               "fp16": STEPS, "wire_bf16": STEPS,
               "local_sgd": 2 * STEPS, "sparse_gather": 1,
               "sparse_dense": 1, "force": 1, "probe": 2}


@pytest.mark.parametrize("case", sorted(_HOOK_CASES))
def test_hook_form_matches_the_reference_bitwise(worlds, case):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        for step in range(_HOOK_CASES[case]):
            key = f"{case}.params.{step}"
            assert got[r][key].tobytes() == want[r][key].tobytes(), (r, key)
    if case != "local_sgd":
        # Averaged gradients: the ranks agree after every step.
        last = f"{case}.params.{_HOOK_CASES[case] - 1}"
        assert got[0][last].tobytes() == got[1][last].tobytes()


def test_compressed_reductions_reach_the_gradient(worlds):
    """The port's fp16 hook form equals the reference's eager fp16
    allreduce (above); the reference's own hook form leaves each rank's
    local gradient in ``.grad``, so its ranks part (ROADMAP.md Queue C)."""
    ref = worlds["ref"]
    last = f"fp16_hook.params.{STEPS - 1}"
    assert ref[0][last].tobytes() != ref[1][last].tobytes()
    got = worlds["port"]
    assert got[0][last.replace("_hook", "")].tobytes() != \
        ref[0][last].tobytes()


def test_hook_form_details_match_the_reference(worlds):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        for key in ("adam_unnamed.names", "sparse_gather.grad",
                    "sparse_dense.grad", "force.unused_grad",
                    "probe.sparse.0", "probe.sparse.1"):
            assert got[r][key].tolist() == want[r][key].tolist(), (r, key)
    assert got[0]["adam_unnamed.names"].tolist() == [
        f"allreduce.noname.{i}" for i in range(4)]
    # The gathered and the densified sparse gradient agree.
    np.testing.assert_allclose(got[0]["sparse_gather.grad"],
                               got[0]["sparse_dense.grad"], atol=1e-6)
    # Rank 0 had no embedding gradient on step 0 and joined the sparse
    # gathers through the probe.
    assert got[0]["probe.sparse.0"] and got[1]["probe.sparse.0"]


def test_priorities_follow_registration_order(worlds):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        assert int(got[r]["bands"]) == 1
        assert got[r]["priorities"].tolist() == list(range(4))
        # Bands on: no committed response dispatched after a less urgent
        # one of its cycle (tests/priority_worker.py's counter).
        assert got[r]["stats"][0] == want[r]["stats"][0] == 0


def test_local_sgd_syncs_every_h_steps(worlds):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        assert int(got[r]["local_sgd.syncs"]) == 2
        # The port's process also ran the two local-SGD rungs of the
        # JAX-form cases, one sync each.
        assert want[r]["stats"][1] == 2 and got[r]["stats"][1] == 2 + 2
    for step in range(2 * STEPS):
        key = f"local_sgd.params.{step}"
        same = got[0][key].tobytes() == got[1][key].tobytes()
        assert same == ((step + 1) % LOCAL_SGD_H == 0), step


def test_local_sgd_skipped_sync_keeps_local_parameters(worlds):
    got, want = worlds["port_skip"], worlds["ref_skip"]
    for r in range(2):
        for step in range(4):
            key = f"skip.params.{step}"
            assert got[r][key].tobytes() == want[r][key].tobytes(), (r, key)
    # Rank 0's syncs committed without rank 1 (its average is its own
    # model); rank 1 was skipped, kept its local model, counted nothing.
    assert [int(got[r]["skip.syncs"]) for r in range(2)] == [2, 0]
    assert [int(want[r]["skip.syncs"]) for r in range(2)] == [2, 0]
    assert got[0]["skip.params.3"].tobytes() != \
        got[1]["skip.params.3"].tobytes()


@pytest.mark.parametrize("rung", sorted(_JF_RUNGS))
def test_jax_form_rungs_match_the_jax_package(worlds, rung):
    got, want = worlds["port"], worlds["jax"]
    for r in range(2):
        jf = got[r][f"jf.{rung}.jaxform"]
        assert jf.tobytes() == got[r][f"jf.{rung}.hook"].tobytes()
        np.testing.assert_allclose(jf, want[r][f"jf.{rung}.jax"], rtol=0,
                                   atol=1e-6)
    assert got[0][f"jf.{rung}.jaxform"].tobytes() == \
        got[1][f"jf.{rung}.jaxform"].tobytes()


def _message(fn):
    with pytest.raises((ValueError, TypeError, NotImplementedError)) as e:
        fn()
    return str(e.value)


def _sgd():
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1)


_TORCH_REFUSALS = {
    "fsdp_and_sharded": dict(fsdp=True, sharded=True),
    "sharded_local_sgd": dict(sharded=True, local_sgd_steps=2),
    "fsdp_local_sgd": dict(fsdp=True, local_sgd_steps=4),
    "sharded_bpps": dict(sharded=True, backward_passes_per_step=2),
    "fsdp_bpps": dict(fsdp=True, backward_passes_per_step=3),
}


@pytest.mark.parametrize("case", sorted(_TORCH_REFUSALS))
def test_hook_form_refusals_match_the_reference(case, monkeypatch):
    import horovod_tpu.torch as ref
    from horovod_tpu_torch import torch_frontend

    monkeypatch.delenv("HOROVOD_LOCAL_SGD_STEPS", raising=False)
    kw = _TORCH_REFUSALS[case]
    assert _message(lambda: torch_frontend.DistributedOptimizer(
        _sgd(), **kw)) == _message(lambda: ref.DistributedOptimizer(
            _sgd(), **kw))


def test_hook_form_env_and_top_k_refusals(monkeypatch):
    import horovod_tpu.torch as ref
    from horovod_tpu.torch.compression import Compression as RefCompression
    from horovod_tpu_torch import torch_frontend

    # The env default of local SGD is refused with sharded, as in the
    # reference.
    monkeypatch.setenv("HOROVOD_LOCAL_SGD_STEPS", "4")
    assert _message(lambda: torch_frontend.DistributedOptimizer(
        _sgd(), sharded=True)) == _message(
            lambda: ref.DistributedOptimizer(_sgd(), sharded=True))
    monkeypatch.delenv("HOROVOD_LOCAL_SGD_STEPS")

    from horovod_tpu_torch.ops.compression import Compression

    for which in ("sharded", "fsdp"):
        assert _message(lambda: torch_frontend.DistributedOptimizer(
            _sgd(), compression=Compression.topk(0.01), **{which: True})) \
            == _message(lambda: ref.DistributedOptimizer(
                _sgd(), compression=RefCompression.topk(0.01),
                **{which: True}))
    # Top-k builds with the hook mixin and with local SGD, whose outer
    # sync then ships sparse deltas; HOROVOD_WIRE_POLICY=1 gives the hook
    # form the process's policy.
    opt = torch_frontend.DistributedOptimizer(
        _sgd(), compression=Compression.topk(0.01))
    assert opt._local_sgd is None and opt._wire_policy is None
    opt = torch_frontend.DistributedOptimizer(
        _sgd(), local_sgd_steps=2, compression=Compression.topk(0.01))
    assert opt._local_sgd._topk.ratio == 0.01
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "1")
    from horovod_tpu_torch.runtime.wire_policy import default_policy
    assert torch_frontend.DistributedOptimizer(_sgd())._wire_policy is \
        default_policy()


def test_dropped_optimizers_release_their_models(monkeypatch):
    """The gradient hooks hold their optimizer weakly: a hook-form or FSDP
    optimizer and its model, once dropped, are collected (a tensor's hooks
    are invisible to the cycle collector, so a strong hook would keep the
    parameters, the masters and the optimizer state for the process's
    life)."""
    import gc
    import weakref

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.ops.mixed_precision import MasterWeights

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR",
                "HOROVOD_LOCAL_SGD_STEPS"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        for kw in ({}, {"fsdp": True}, {"masters": True}):
            m = _model()
            inner = (MasterWeights(m.parameters(), torch.optim.AdamW)
                     if kw.pop("masters", False) else
                     torch.optim.SGD(m.parameters(), lr=LR))
            opt = torch_frontend.DistributedOptimizer(
                inner, named_parameters=m.named_parameters(), **kw)
            _loss(m, 0, 0).backward()
            opt.step()
            refs = [weakref.ref(opt), weakref.ref(m[0].weight)]
            del m, inner, opt
            gc.collect()
            assert all(r() is None for r in refs), kw
    finally:
        hvd.shutdown()


_JAX_REFUSALS = {
    "fsdp_and_sharded": dict(fsdp=True, sharded=True),
    "sharded_local_sgd": dict(sharded=True, local_sgd_steps=2),
    "fsdp_no_reduce": dict(fsdp=True, reduce_gradients=False),
    "sharded_max": dict(sharded=True, op="Max"),
}


@pytest.mark.parametrize("case", sorted(_JAX_REFUSALS))
def test_jax_form_refusals_match_the_jax_package(case, monkeypatch):
    import horovod_tpu.jax as ref
    import optax
    import horovod_tpu_torch as hvd

    monkeypatch.delenv("HOROVOD_LOCAL_SGD_STEPS", raising=False)
    kw = dict(_JAX_REFUSALS[case])
    op = kw.pop("op", None)
    port_kw = dict(kw, **({"op": hvd.Max} if op else {}))
    ref_kw = dict(kw, **({"op": ref.Max} if op else {}))
    assert _message(lambda: hvd.DistributedOptimizer(_sgd(), **port_kw)) \
        == _message(lambda: ref.DistributedOptimizer(optax.sgd(0.1),
                                                     **ref_kw))


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
