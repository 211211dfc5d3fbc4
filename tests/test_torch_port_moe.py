"""Port parity: the expert-parallel MoE plane (``runtime/moe.py``).

* The port's ``MoeLayer(world=(0, 1))`` against the JAX package's
  (``horovod_tpu.runtime.moe``) at ``tests/moe_worker.py``'s sizes (T 32,
  D 8, H 16, 4 experts, top-2): forward, dx, router and expert grads and
  the updated parameters over 4 SGD steps agree within
  ``|port - ref| <= 1e-6 + 1e-5 |ref|`` (fp32 rounding: the port's GEMMs
  sum in other orders than numpy's row-at-a-time products).
* Worlds of 2 and 4 ranks of the port's engine (this file run as a script
  per rank, ``_rank_main``): every rank's y, dx, router grad, owned expert
  grads and updated parameters equal, bit for bit, the port's own
  ``world=(0, 1)`` layer on the whole batch (``moe_worker.py
  scenario_moe_parity``); the capacity-factor sweep's drops equal the
  reference package's exactly, per rank block and in all, repeat runs are
  bitwise equal and the engine's ``moe_tokens_dropped`` moves by the
  local drops (``scenario_moe_capacity``); and 12 SGD steps cut the loss
  below 0.6x the first and track the reference's trajectory within
  rtol 1e-5 (``test_moe.py:58``, ``scenario_moe_convergence``).

A port process imports no JAX (it checks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, H = 32, 8, 16
CFS = (0.25, 0.5, 1.0, 4.0)


def _batch(seed=11):
    """``moe_worker._batch``: x and a learnable linear target."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    a = (rng.standard_normal((D, D)) * 0.5).astype(np.float32)
    return x, (x @ a).astype(np.float32)


def _shard(rank, size):
    return slice(rank * T // size, (rank + 1) * T // size)


def _close(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_port_layer_tracks_the_reference_at_world_one():
    from horovod_tpu.runtime.moe import MoeLayer as RefLayer
    from horovod_tpu_torch.runtime.moe import MoeLayer

    x, tgt = _batch()
    kw = dict(n_experts=4, topk=2, capacity_factor=1.25, seed=5,
              world=(0, 1))
    ref, lay = RefLayer(D, H, **kw), MoeLayer(D, H, device="cpu", **kw)
    assert lay.wg.device.type == "cpu"
    for p, q in zip(lay.router_params() + lay.expert_params(),
                    ref.router_params() + ref.expert_params()):
        assert p.numpy().tobytes() == q.tobytes()   # the same draws
    for _ in range(4):
        yr, cr = ref.forward(x)
        y, c = lay.forward(torch.from_numpy(x))
        _close(y, yr)
        assert c["dropped"] == cr["dropped"]
        dxr = ref.backward((yr - tgt) / T, cr)
        dx = lay.backward((y - torch.from_numpy(tgt)) / T, c)
        _close(dx, dxr)
        for g, gr in (("g_wg", "g_wg"), ("g_w1", "g_w1"), ("g_b1", "g_b1"),
                      ("g_w2", "g_w2"), ("g_b2", "g_b2")):
            _close(getattr(lay, g), getattr(ref, gr))
        lay.apply_grads(0.1)
        ref.apply_grads(0.1)
        for p, q in zip(lay.router_params() + lay.expert_params(),
                        ref.router_params() + ref.expert_params()):
            _close(p, q)


def test_layer_checks_its_arguments_as_the_reference_does():
    from horovod_tpu.runtime.moe import MoeLayer as RefLayer
    from horovod_tpu_torch.runtime.moe import MoeLayer

    for kw in (dict(n_experts=3, world=(0, 2)), dict(n_experts=2, topk=3,
                                                     world=(0, 1))):
        with pytest.raises(ValueError) as want:
            RefLayer(D, H, **kw)
        with pytest.raises(ValueError) as got:
            MoeLayer(D, H, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    # A multi-rank layer with no engine raises at its first collective.
    lay = MoeLayer(D, H, n_experts=4, world=(0, 2), device="cpu")
    with pytest.raises(RuntimeError, match="no engine is running"):
        lay.forward(torch.zeros(4, D))


def _parity(MoeLayer, rank, size, eng):
    """``scenario_moe_parity``: 4 steps, every byte against the
    world-of-one layer on the whole batch."""
    x_full, tgt = _batch()
    sh = _shard(rank, size)
    kw = dict(n_experts=4, topk=2, capacity_factor=1.25, seed=5,
              device="cpu")
    lay = MoeLayer(D, H, **kw)
    ref = MoeLayer(D, H, world=(0, 1), **kw)
    lo, epr = lay.expert_lo, lay.experts_per_rank
    x, xr = torch.from_numpy(x_full[sh]), torch.from_numpy(x_full)
    t, tr = torch.from_numpy(tgt[sh]), torch.from_numpy(tgt)
    s0 = eng.stats()
    out = {}

    def same(a, b, what):
        assert a.numpy().tobytes() == b.numpy().tobytes(), what

    for step in range(4):
        y, c = lay.forward(x)
        yr, cr = ref.forward(xr)
        same(y, yr[sh], f"step {step}: forward")
        dx = lay.backward((y - t) / T, c)
        dxr = ref.backward((yr - tr) / T, cr)
        same(dx, dxr[sh], f"step {step}: dx")
        same(lay.g_wg, ref.g_wg, f"step {step}: router grad")
        for g in ("g_w1", "g_b1", "g_w2", "g_b2"):
            same(getattr(lay, g), getattr(ref, g)[lo:lo + epr],
                 f"step {step}: {g}")
        lay.apply_grads(0.1)
        ref.apply_grads(0.1)
        same(lay.wg, ref.wg, f"step {step}: wg")
        for p, q in zip(lay.expert_params(), ref.expert_params()):
            same(p, q[lo:lo + epr], f"step {step}: expert params")
        out[f"parity.y.{step}"] = y.numpy()
    s1 = eng.stats()
    assert s1["alltoall_bytes"] > s0["alltoall_bytes"], s1
    assert s1["moe_dispatches"] > s0["moe_dispatches"], s1
    assert s1["moe_experts"] == 4 and s1["moe_capacity_factor"] == 1.25, s1
    return out


def _capacity(MoeLayer, rank, size, eng):
    """``scenario_moe_capacity``: drops per cf, per rank block and in all,
    a repeat bitwise, the engine counter moved by the local drops."""
    x_full, _ = _batch(seed=23)
    x = torch.from_numpy(x_full[_shard(rank, size)])
    out = {}
    for cf in CFS:
        kw = dict(n_experts=4, topk=2, capacity_factor=cf, seed=9,
                  device="cpu")
        lay = MoeLayer(D, H, **kw)
        ref = MoeLayer(D, H, world=(0, 1), **kw)
        before = eng.stats()["moe_tokens_dropped"]
        y, c = lay.forward(x)
        after = eng.stats()["moe_tokens_dropped"]
        yr, cr = ref.forward(torch.from_numpy(x_full))
        assert y.numpy().tobytes() == yr[_shard(rank, size)].numpy() \
            .tobytes(), cf
        lo, epr = lay.expert_lo, lay.experts_per_rank
        mine = int(((~cr["kept"]) & (cr["local_e"] >= lo)
                    & (cr["local_e"] < lo + epr)).sum())
        assert c["dropped"] == mine and after - before == mine, (
            cf, c["dropped"], mine, after - before)
        y2, c2 = lay.forward(x)
        assert y2.numpy().tobytes() == y.numpy().tobytes() and \
            c2["dropped"] == c["dropped"], cf
        out[f"capacity.{cf}"] = np.array([c["dropped"],
                                          int((~cr["kept"]).sum())])
    return out


def _convergence(MoeLayer, rank, size, eng):
    """``scenario_moe_convergence``: the global loss of 12 SGD steps."""
    x_full, tgt = _batch(seed=31)
    sh = _shard(rank, size)
    lay = MoeLayer(D, H, n_experts=4, topk=2, capacity_factor=2.0, seed=7,
                   device="cpu")
    x, t = torch.from_numpy(x_full[sh]), torch.from_numpy(tgt[sh])
    losses = []
    for step in range(12):
        y, c = lay.forward(x)
        local = torch.tensor([float(((y - t) ** 2).sum())],
                             dtype=torch.float64)
        total = float(eng.synchronize(eng.enqueue_allreduce(
            local, name=f"moe.loss.{step}"))[0])
        losses.append(total / (T * D))
        lay.backward((y - t) / (T * D) * 2, c)
        lay.apply_grads(0.4)
    return {"convergence.losses": np.array(losses)}


def _rank_main(dst: str) -> None:
    """One rank of a port world: ``python tests/test_torch_port_moe.py
    OUT.npz``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import moe
    from horovod_tpu_torch.runtime.engine import get_engine

    hvd.init(device="cpu")
    eng = get_engine()
    out = {}
    for scenario in (_parity, _capacity, _convergence):
        out.update(scenario(moe.MoeLayer, hvd.rank(), hvd.size(), eng))
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
    assert not bad, bad
    hvd.shutdown()
    np.savez(dst, **out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of 2 and 4 ranks: {n: [rank outputs]}."""
    from test_torch_port_engine import _finish, _free_port

    tmp = tmp_path_factory.mktemp("moe")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests"),
               JAX_PLATFORMS="cpu")
    started = {}
    for n in (2, 4):
        outs = [tmp / f"moe{n}.{r}.npz" for r in range(n)]
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(outs[r])],
            env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                     HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                     HOROVOD_COORDINATOR=coord),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        started[n] = (procs, outs)
    return {n: _finish(w, timeout=240) for n, w in started.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_equal_the_world_of_one_bitwise(worlds, n):
    """Each rank checked its y, dx and grads against ``world=(0, 1)``
    itself (bytes); here: the ranks' outputs tile the whole batch."""
    for step in range(4):
        ys = np.concatenate([worlds[n][r][f"parity.y.{step}"]
                             for r in range(n)])
        assert ys.shape == (T, D)
        other = np.concatenate([worlds[6 - n][r][f"parity.y.{step}"]
                                for r in range(6 - n)])
        assert ys.tobytes() == other.tobytes()


@pytest.mark.parametrize("n", [2, 4])
def test_capacity_sweep_drops_equal_the_reference(worlds, n):
    from horovod_tpu.runtime.moe import MoeLayer as RefLayer

    x_full, _ = _batch(seed=23)
    drops = {}
    for cf in CFS:
        ref = RefLayer(D, H, n_experts=4, topk=2, capacity_factor=cf,
                       seed=9, world=(0, 1))
        _, cr = ref.forward(x_full)
        epr = 4 // n
        for r in range(n):
            block = int(((~cr["kept"]) & (cr["local_e"] >= r * epr)
                         & (cr["local_e"] < (r + 1) * epr)).sum())
            mine, total = worlds[n][r][f"capacity.{cf}"].tolist()
            assert mine == block and total == cr["dropped"], (cf, r)
        drops[cf] = cr["dropped"]
    assert drops[0.25] >= drops[0.5] >= drops[1.0] >= drops[4.0] == 0
    assert drops[0.25] > 0


@pytest.mark.parametrize("n", [2, 4])
def test_convergence_tracks_the_reference(worlds, n):
    from horovod_tpu.runtime.moe import MoeLayer as RefLayer

    x_full, tgt = _batch(seed=31)
    ref = RefLayer(D, H, n_experts=4, topk=2, capacity_factor=2.0, seed=7,
                   world=(0, 1))
    ref_losses = []
    for _ in range(12):
        yr, cr = ref.forward(x_full)
        ref_losses.append(float(((yr - tgt) ** 2).mean()))
        ref.backward((yr - tgt) / (T * D) * 2, cr)
        ref.apply_grads(0.4)
    for r in range(n):
        losses = worlds[n][r]["convergence.losses"]
        assert losses.tolist() == worlds[n][0]["convergence.losses"] \
            .tolist()
        assert losses[-1] < 0.6 * losses[0], losses
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
