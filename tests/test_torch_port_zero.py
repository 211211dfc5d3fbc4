"""Port parity: ZeRO-1 (``runtime/sharded.py``) and FSDP units
(``runtime/fsdp.py``) behind the hook-form ``DistributedOptimizer``.

The port's ``torch_frontend.DistributedOptimizer(sharded=True)`` and
``(fsdp=True)`` against the reference torch frontend's
``_ShardedOptimizer`` and ``_FsdpOptimizer`` (``horovod_tpu.torch``), on
the same seeded numpy inputs and tiny models, at 2 ranks and at 3 (uneven
shards):

* parameters after 3 steps bitwise: an fp32 model with SGD and momentum
  in two param groups of different learning rates, a bf16 model with Adam
  (fp32 master shards, an fp32 reduction), and ``wire_bf16``; FSDP with a
  step in which one unit's hooks never all fire;
* the anchors, in each port rank: ZeRO-1 equals the unsharded flat step
  (a flat allreduce and the same torch SGD on the flat vector) and FSDP
  equals the dense replicated loop, bit for bit after every step;
  ``.grad`` is ``None`` once a unit's reduction fired;
* ``state_bytes`` is about 1/N of the unsharded masters and momenta;
  ``state_dict`` round-trips, and a reload at another world size raises
  ``ShardResizeError`` with the reference's message;
* the split (``shard_bounds``) and the flat helpers against the
  reference's, in this process.

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
MOM = 0.9


def _batch(step, rank, dtype):
    rng = np.random.default_rng(1000 * step + rank)
    x = rng.standard_normal((7, 11)).astype(np.float32)
    y = rng.standard_normal((7, 5)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)


def _model(dtype, seed=3):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(11, 17), torch.nn.Tanh(),
                            torch.nn.Linear(17, 5))
    # A leaf of unit 1 that only even steps use: on odd steps that unit's
    # hooks never all fire.
    m.extra = torch.nn.Parameter(torch.linspace(-1, 1, 6))
    return m.to(dtype)


def _groups(m, lrs=(LR, 2 * LR)):
    return [{"params": list(m[0].parameters()), "lr": lrs[0]},
            {"params": list(m[2].parameters()) + [m.extra], "lr": lrs[1]}]


def _loss(m, step, rank, dtype):
    x, y = _batch(step, rank, dtype)
    loss = ((m(x) - y).float() ** 2).mean()
    if step % 2 == 0:
        loss = loss + (m.extra.float() * 0.1).pow(2).sum()
    return loss


def _bits(m):
    """Every parameter's bytes as one uint8 vector."""
    return np.concatenate([p.detach().contiguous().view(torch.uint8)
                           .reshape(-1).numpy() for p in m.parameters()])


def _flat_anchor(mod, ref_m, flats, opts, step, rank, dtype, tag):
    """One step of the unsharded flat reference: the same loss's grads
    per group, one flat allreduce (average), torch SGD on the flat fp32
    vector, the result copied back."""
    ref_m.zero_grad()
    _loss(ref_m, step, rank, dtype).backward()
    for gi, g in enumerate(_groups(ref_m)):
        ps = g["params"]
        flat_g = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().to(torch.float32).reshape(-1) for p in ps])
        flats[gi].grad = mod.allreduce(flat_g, True, f"{tag}.anchor.{gi}")
        opts[gi].step()
        with torch.no_grad():
            off = 0
            for p in ps:
                p.copy_(flats[gi].detach()[off:off + p.numel()]
                        .reshape(p.shape))
                off += p.numel()


def _program(mod, Compression, ShardResizeError, rank, size):
    """The cases, the same calls on either side: ``mod`` is
    ``horovod_tpu.torch`` or the port's (``torch_frontend`` with the
    eager ops)."""
    out = {}
    cases = [("zero_fp32", torch.float32, torch.optim.SGD,
              dict(momentum=MOM), Compression.none, "sharded"),
             ("zero_bf16", torch.bfloat16, torch.optim.Adam, {},
              Compression.none, "sharded"),
             ("zero_wire_bf16", torch.float32, torch.optim.SGD,
              dict(momentum=MOM), Compression.wire_bf16, "sharded"),
             ("fsdp_fp32", torch.float32, torch.optim.SGD,
              dict(momentum=MOM), Compression.none, "fsdp"),
             ("fsdp_bf16", torch.bfloat16, torch.optim.AdamW, {},
              Compression.none, "fsdp")]
    for tag, dtype, opt_cls, kw, comp, rung in cases:
        m = _model(dtype)
        opt = mod.DistributedOptimizer(opt_cls(_groups(m), lr=LR, **kw),
                                       compression=comp, **{rung: True})
        anchor = tag in ("zero_fp32", "fsdp_fp32")
        if anchor:
            ref_m = _model(dtype)
            flats = [torch.nn.Parameter(torch.cat(
                [p.detach().reshape(-1) for p in g["params"]]))
                for g in _groups(ref_m)]
            opts = [torch.optim.SGD([f], lr=g["lr"], momentum=MOM)
                    for f, g in zip(flats, _groups(ref_m))]
        for step in range(STEPS):
            opt.zero_grad()
            _loss(m, step, rank, dtype).backward()
            if rung == "fsdp":
                # A unit whose hooks all fired has been reduced and its
                # gradients freed; unit 1 waits for step() on odd steps.
                fired = [all(p.grad is None for p in g["params"])
                         for g in _groups(m)]
                out[f"{tag}.freed.{step}"] = np.array(fired)
            opt.step()
            out[f"{tag}.params.{step}"] = _bits(m)
            if anchor:
                _flat_anchor(mod, ref_m, flats, opts, step, rank, dtype, tag)
                assert _bits(m).tobytes() == _bits(ref_m).tobytes(), \
                    (tag, step)
        n = sum(p.numel() for p in m.parameters())
        per_elem = {"zero_bf16": 12, "fsdp_bf16": 12}.get(tag, 8)
        out[f"{tag}.state_bytes"] = np.array(
            [opt.state_bytes(), n * per_elem])
        if tag == "zero_fp32":
            sd = opt.state_dict()
            fresh = mod.DistributedOptimizer(
                opt_cls(_groups(_model(dtype)), lr=LR, **kw), sharded=True)
            fresh.load_state_dict(sd)
            out["zero_fp32.reload"] = np.concatenate([
                g["params"][0].detach().numpy() for g in fresh.param_groups])
            out["zero_fp32.masters"] = np.concatenate([
                g["params"][0].detach().numpy() for g in opt.param_groups])
            bad = dict(sd, groups=[dict(g, shard=dict(g["shard"],
                                                      size=size + 1))
                                   for g in sd["groups"]])
            for key, sd_bad in (("resize", bad),
                                ("groups", dict(sd, groups=sd["groups"][:1]))):
                try:
                    fresh.load_state_dict(sd_bad)
                except ShardResizeError as e:
                    out[f"zero_fp32.msg.{key}"] = np.array(str(e))
    return out


def _rank_main(mode: str, dst: str) -> None:
    """One rank: ``python tests/test_torch_port_zero.py MODE OUT.npz``;
    ``port`` or ``ref``."""
    if mode == "ref":
        import horovod_tpu.torch as mod
        from horovod_tpu.runtime.sharded import ShardResizeError
        from horovod_tpu.torch.compression import Compression

        mod.init()
        out = _program(mod, Compression, ShardResizeError, mod.rank(),
                       mod.size())
        mod.shutdown()
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import torch_frontend
        from horovod_tpu_torch.runtime import mpi_ops
        from horovod_tpu_torch.runtime.engine import get_engine
        from horovod_tpu_torch.runtime.fsdp import fsdp_stats
        from horovod_tpu_torch.runtime.sharded import ShardResizeError

        hvd.init(device="cpu")

        class Mod:
            DistributedOptimizer = staticmethod(
                torch_frontend.DistributedOptimizer)
            allreduce = staticmethod(mpi_ops.allreduce)

        out = _program(Mod, hvd.Compression, ShardResizeError, hvd.rank(),
                       hvd.size())
        st = get_engine().stats()
        out["stats"] = np.array([st["sharded_steps"],
                                 fsdp_stats()["fsdp_units"]])
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        assert not bad, bad
        hvd.shutdown()
    np.savez(dst, **out)


def _start_world(mode, n, tmp_path):
    from test_torch_port_engine import _free_port

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests"),
               JAX_PLATFORMS="cpu",
               HOROVOD_COORDINATOR=f"127.0.0.1:{_free_port()}")
    outs = [tmp_path / f"{mode}{n}.{r}.npz" for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(outs[r])],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                 HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    return procs, outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: (port ranks' outputs, reference ranks' outputs)}; the two
    sides of a size run together, one size after the other."""
    from test_torch_port_engine import _finish

    tmp = tmp_path_factory.mktemp("zero")
    out = {}
    for n in (2, 3):
        port, ref = _start_world("port", n, tmp), _start_world("ref", n, tmp)
        out[n] = (_finish(port), _finish(ref))
    return out


_CASES = ["zero_fp32", "zero_bf16", "zero_wire_bf16", "fsdp_fp32",
          "fsdp_bf16"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("n", [2, 3])
def test_parameters_match_the_reference_bitwise(worlds, n, case):
    got, want = worlds[n]
    for r in range(n):
        for step in range(STEPS):
            key = f"{case}.params.{step}"
            assert got[r][key].tobytes() == want[r][key].tobytes(), \
                (r, key)
    # Ranks agree after every step.
    for step in range(STEPS):
        key = f"{case}.params.{step}"
        assert all(got[r][key].tobytes() == got[0][key].tobytes()
                   for r in range(n))


@pytest.mark.parametrize("n", [2, 3])
def test_fsdp_frees_a_units_grads_when_its_hooks_fire(worlds, n):
    got, want = worlds[n]
    for r in range(n):
        for case in ("fsdp_fp32", "fsdp_bf16"):
            for step in range(STEPS):
                key = f"{case}.freed.{step}"
                # Unit 0 is always reduced from inside the backward; unit
                # 1 only on the steps that use its extra leaf.
                assert got[r][key].tolist() == [True, step % 2 == 0], key
                assert got[r][key].tolist() == want[r][key].tolist()
    # Five optimizers of 3 steps each; two planes of two units.
    assert got[0]["stats"].tolist() == [5 * STEPS, 2 * 2]


@pytest.mark.parametrize("n", [2, 3])
def test_state_bytes_and_state_dict(worlds, n):
    got, want = worlds[n]
    for r in range(n):
        for case in _CASES:
            mine, full = got[r][f"{case}.state_bytes"].tolist()
            assert mine == want[r][f"{case}.state_bytes"][0], case
            # About 1/N: masters and state of one shard, which is at most
            # one element per group longer than n / N.
            assert mine <= full / n + 64, (case, mine, full)
        np.testing.assert_array_equal(got[r]["zero_fp32.reload"],
                                      got[r]["zero_fp32.masters"])
        for key in ("resize", "groups"):
            msg = str(got[r][f"zero_fp32.msg.{key}"])
            assert msg == str(want[r][f"zero_fp32.msg.{key}"]), msg


def test_shard_bounds_and_flat_helpers_match_the_reference():
    from horovod_tpu.runtime import sharded as ref
    from horovod_tpu_torch.runtime import sharded as port

    rng = np.random.default_rng(0)
    for size in range(1, 6):
        for n in list(range(0, 40)) + rng.integers(0, 100_001, 40).tolist():
            assert port.shard_bounds(n, size) == ref.shard_bounds(n, size)
            for r in range(size):
                assert port.my_shard(n, r, size) == ref.my_shard(n, r, size)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(3, 4), (5,), (2, 2, 2)]]
    tensors = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_array_equal(
        port.FlatSharder.flatten(tensors, torch.float32).numpy(),
        ref.FlatSharder.flatten(arrays, np.float32))
    for off, cnt in [(0, 0), (0, 25), (2, 13), (11, 9), (20, 5)]:
        np.testing.assert_array_equal(
            port.FlatSharder.slice_flat(tensors, off, cnt,
                                        torch.float32).numpy(),
            ref.FlatSharder.slice_flat(arrays, off, cnt, np.float32))
    # One step at a world of one: reducescatter, the update, allgather.
    grads = np.linspace(-1, 1, 25, dtype=np.float32)
    np.testing.assert_array_equal(
        port.FlatSharder(25, torch.float32, name="t").step(
            torch.from_numpy(grads), lambda g: g * -0.5).numpy(),
        ref.FlatSharder(25, np.float32, name="t").step(
            grads, lambda g: g * np.float32(-0.5)))
    flat = np.arange(25, dtype=np.float32)
    shapes = [a.shape for a in arrays]
    for a, b in zip(port.FlatSharder.unflatten(torch.from_numpy(flat),
                                               shapes),
                    ref.FlatSharder.unflatten(flat, shapes)):
        np.testing.assert_array_equal(a.numpy(), b)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
