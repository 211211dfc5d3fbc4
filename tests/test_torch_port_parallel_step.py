"""Port parity: ``make_parallel_train_step`` with tensor, expert and fsdp
placement (``parallel/api.py``, ``parallel/placement.py``).

Three SGD steps of the reference's GSPMD step (``horovod_tpu.parallel.api``
``shard_params`` + ``make_parallel_train_step``) on the conftest's CPU mesh
against the port's on gloo ranks of the same mesh shape (this file run as
a script per rank, ``_rank_main``), from the same weights and the same
global batch, fp32:

* ``tensor`` 2 (dense and MoE) and ``expert`` 2 (MoE) on two ranks;
  ``fsdp`` 2 x ``tensor`` 2 (dense), ``data`` 2 x ``expert`` 2 (MoE),
  ``expert`` 2 x ``tensor`` 2 (MoE), ``data`` 2 x ``fsdp`` 2 (dense) and
  ``fsdp`` 2 x ``expert`` 2 (MoE) on four;
* every rank's losses within rtol 1e-5 of the reference's, and the whole
  parameters after the steps (gathered by ``full_state_dict``) within
  ``tests/test_parallel_api.py:42``'s tolerance (5e-3 absolute and
  relative); the ranks' losses equal.

A world of one with every axis 1 is held bitwise against the plain loop.
The fused gate/up weight's placement under ``tensor`` is pinned: each
rank holds the gate half's block and the up half's block of the rules'
dimension (ROADMAP.md Queue C, C3), the same values as the rules'
contiguous block in another order.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS, LR = 8, 17, 3, 0.05
PARAM_TOL = 5e-3          # tests/test_parallel_api.py:42
LOSS_RTOL = 1e-5
SCENARIOS = {
    # name: (world size, mesh axes, experts, FFN width)
    "tensor2": (2, {"tensor": 2}, 1, 128),
    "tensor2_moe": (2, {"tensor": 2}, 4, 128),
    "expert2": (2, {"expert": 2}, 4, 128),
    "fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, 1, 128),
    "data2_expert2": (4, {"data": 2, "expert": 2}, 4, 128),
    "expert2_tensor2": (4, {"expert": 2, "tensor": 2}, 4, 128),
    "data2_fsdp2": (4, {"data": 2, "fsdp": 2}, 1, 128),
    "fsdp2_expert2": (4, {"fsdp": 2, "expert": 2}, 4, 128),
    # tensor 4: 2 KV heads do not divide (attention on gathered heads),
    # F 6 does not either while 2F does (gate/up gathered before the split)
    "tensor4_f6": (4, {"tensor": 4}, 1, 6),
    "tensor4_f6_moe": (4, {"tensor": 4}, 4, 6),
}


def _port_cfg(experts, ffn=128):
    from horovod_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(num_experts=experts),
                               dtype=torch.float32,
                               logits_dtype=torch.float32,
                               intermediate_size=ffn)


def _tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S))


def _rank_main(src: str, dst: str) -> None:
    """One rank: every scenario of its world size, in order.  IN holds the
    scenario names and each one's starting weights (``<name>.w.<param>``);
    OUT each one's losses and whole parameters after the steps, and, for
    the tensor scenarios, this rank's block of layer 0's fused gate/up
    weight."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.parallel.api import (make_parallel_train_step,
                                                shard_params)
    from horovod_tpu_torch.parallel.placement import full_state_dict

    hvd.init(device="cpu")
    data = np.load(src)
    tokens = torch.from_numpy(_tokens())
    out = {}
    for name in [str(n) for n in data["names"]]:
        _, axes, experts, ffn = SCENARIOS[name]
        cfg = _port_cfg(experts, ffn)
        pre = name + ".w."
        state = {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(pre)}
        model = LlamaModel.from_state_dict(cfg, state)
        mesh = hvd.build_mesh(axes)
        shard_params(model, mesh)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=LR))
        step = make_parallel_train_step(model, opt, mesh)
        out[name + ".losses"] = np.array([float(step(tokens))
                                          for _ in range(STEPS)])
        gu = ("moe.w_gate_up" if experts > 1 else "mlp.w_gate_up.weight")
        out[name + ".block"] = model.get_parameter(
            "layers.0." + gu).detach().numpy()
        for k, v in full_state_dict(model).items():
            out[name + ".final." + k] = v.numpy()
    np.savez(dst.format(rank=hvd.rank()), **out)
    assert "jax" not in sys.modules
    hvd.shutdown()


def rank_world(script, n, *args):
    """``n`` gloo ranks of the test file ``script`` run as a script on
    ``args`` (one thread each)."""
    from horovod_tpu_torch.common.launch import World

    return World(n, [sys.executable, os.path.abspath(script), *args],
                 env=dict(PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                 drop=("HOROVOD_", "OMPI_", "PMI_", "JAX_", "XLA_"))


def _start_world(n, names, starts, tmp_path):
    """Start ``n`` ranks of this file on the named scenarios."""
    src = tmp_path / f"in{n}.npz"
    arrays = {"names": np.array(names)}
    for name in names:
        arrays.update({f"{name}.w.{k}": v.numpy()
                       for k, v in starts[name].items()})
    np.savez(src, **arrays)
    return rank_world(__file__, n, str(src),
                      str(tmp_path / f"out{n}_{{rank}}.npz"))


def _reference(name, variables):
    """The reference's step: (losses, final params as numpy)."""
    import jax
    import optax

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
    from horovod_tpu.models import LlamaModel as JaxLlamaModel
    from horovod_tpu.parallel.api import (make_parallel_train_step,
                                          shard_params)

    n, axes, experts, ffn = SCENARIOS[name]
    cfg = dataclasses.replace(JaxLlamaConfig.tiny(num_experts=experts),
                              dtype=np.float32, logits_dtype=np.float32,
                              intermediate_size=ffn)
    model = JaxLlamaModel(cfg)
    mesh = build_mesh(axes, devices=jax.devices()[:n])
    params = shard_params(variables, mesh)
    opt = optax.sgd(LR)
    step = make_parallel_train_step(model, opt, mesh, donate=False)
    state = jax.jit(opt.init)(params)
    losses = []
    tokens = np.asarray(_tokens(), np.int32)
    for _ in range(STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds (2 and 4 ranks) started together, the references
    computed while they run: {scenario: (ref losses, ref params, [rank
    outputs])}."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
    from horovod_tpu.models import LlamaModel as JaxLlamaModel
    from horovod_tpu_torch.models.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("parallel_step")
    variables, starts = {}, {}
    for name, (_, _, experts, ffn) in SCENARIOS.items():
        jcfg = dataclasses.replace(JaxLlamaConfig.tiny(num_experts=experts),
                                   dtype=jnp.float32,
                                   logits_dtype=jnp.float32,
                                   intermediate_size=ffn)
        variables[name] = JaxLlamaModel(jcfg).init(
            jax.random.key(len(name)), jnp.zeros((1, 8), jnp.int32))
        starts[name] = params_from_jax(variables[name],
                                       _port_cfg(experts, ffn), "cpu")
    worlds = {n: _start_world(n, [k for k, v in SCENARIOS.items()
                                  if v[0] == n], starts, tmp)
              for n in (2, 4)}
    with worlds[2], worlds[4]:
        refs = {name: _reference(name, variables[name])
                for name in SCENARIOS}
        for world in worlds.values():
            world.wait(timeout_s=240)
    out = {}
    for name, (n, _, _, _) in SCENARIOS.items():
        ranks = [np.load(tmp / f"out{n}_{r}.npz") for r in range(n)]
        out[name] = (*refs[name], ranks, starts[name])
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parallel_step_tracks_the_reference(runs, name):
    from horovod_tpu_torch.models.convert import params_to_jax

    import jax

    ref_losses, ref_params, ranks, _ = runs[name]
    n, _, experts, ffn = SCENARIOS[name]
    for r in range(1, n):
        np.testing.assert_array_equal(ranks[r][name + ".losses"],
                                      ranks[0][name + ".losses"])
    np.testing.assert_allclose(ranks[0][name + ".losses"], ref_losses,
                               rtol=LOSS_RTOL)
    cfg = _port_cfg(experts, ffn)
    pre = name + ".final."
    for rank in ranks:
        final = {k[len(pre):]: torch.from_numpy(rank[k]) for k in rank.files
                 if k.startswith(pre)}
        got = dict(jax.tree_util.tree_leaves_with_path(
            params_to_jax(final, cfg)["params"]))
        want = jax.tree_util.tree_leaves_with_path(ref_params["params"])
        assert len(got) == len(want)
        for path, w in want:
            np.testing.assert_allclose(got[path], w, rtol=PARAM_TOL,
                                       atol=PARAM_TOL,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["tensor2", "tensor2_moe",
                                  "expert2_tensor2"])
def test_gate_up_blocks_pair_the_halves(runs, name):
    """Under ``tensor`` t, rank i holds rows [i F/t, (i+1) F/t) of the
    gate half and the same rows of the up half (the port's [.., 2F] dim),
    not the rules' contiguous rows [i 2F/t, (i+1) 2F/t)."""
    _, _, ranks, _ = runs[name]
    n, axes, experts, _ = SCENARIOS[name]
    t = axes["tensor"]
    key = "layers.0." + ("moe.w_gate_up" if experts > 1
                         else "mlp.w_gate_up.weight")
    d = 2 if experts > 1 else 0            # the 2F dimension
    for r, rank in enumerate(ranks):
        full = rank[name + ".final." + key]     # gathered after the steps
        F_ = full.shape[d] // 2
        i = r % t                          # tensor is the innermost axis
        block = rank[name + ".block"]
        if experts > 1 and "expert" in axes:
            e = block.shape[0]
            full_r = full[(r // t) * e:(r // t + 1) * e]
        else:
            full_r = full
        gate, up = np.split(full_r, 2, axis=d)
        want = np.concatenate([np.split(gate, t, axis=d)[i],
                               np.split(up, t, axis=d)[i]], axis=d)
        contiguous = np.split(full_r, t, axis=d)[i]
        np.testing.assert_array_equal(block, want)
        assert not np.array_equal(block, contiguous)
        assert block.shape[d] == 2 * F_ // t


def test_world_of_one_is_the_plain_loop(cpu_world):
    """Every axis 1: no placement, and the step is the plain loop's, bit
    for bit (the gradients are not touched)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy
    from horovod_tpu_torch.parallel.api import make_parallel_train_step

    cfg = _port_cfg(4)
    state = init_params(cfg, 3, "cpu")
    tokens = torch.from_numpy(_tokens())
    model = LlamaModel.from_state_dict(cfg, {k: v.clone()
                                             for k, v in state.items()})
    mesh = hvd.build_mesh({"data": 1, "fsdp": 1, "expert": 1, "tensor": 1})
    step = make_parallel_train_step(
        model, torch.optim.SGD(model.parameters(), lr=LR), mesh)
    assert model.placement is None
    plain = LlamaModel.from_state_dict(cfg, {k: v.clone()
                                             for k, v in state.items()})
    opt = torch.optim.SGD(plain.parameters(), lr=LR)
    for _ in range(STEPS):
        got = step(tokens)
        opt.zero_grad()
        loss = softmax_cross_entropy(plain(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
        opt.step()
        assert torch.equal(got, loss.detach())
    for (n, a), (_, b) in zip(model.named_parameters(),
                              plain.named_parameters()):
        assert torch.equal(a, b), n


@pytest.fixture
def cpu_world(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for var in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_param_shardings_match_the_reference_for_moe():
    """The port's placement specs for the tiny MoE model equal the
    reference's ``param_shardings`` (reversed for a ``Linear`` weight)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
    from horovod_tpu.models import LlamaModel as JaxLlamaModel
    from horovod_tpu.parallel import api as japi
    from horovod_tpu_torch.models.convert import _jax_path, _layout
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.parallel import api

    cfg = _port_cfg(4)
    jcfg = JaxLlamaConfig.tiny(num_experts=4)
    variables = jax.eval_shape(JaxLlamaModel(jcfg).init, jax.random.key(0),
                               jnp.zeros((1, 8), jnp.int32))
    model = LlamaModel(cfg, device="meta")
    for axes in ({"expert": 2, "tensor": 2, "fsdp": 2},
                 {"data": 2, "expert": 4}, {"tensor": 8}):
        jmesh = build_mesh(axes)
        want = {japi._path_str(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    japi.param_shardings(variables, jmesh))}
        got = api.param_shardings(model, axes)
        for name, kind, _ in _layout(cfg):
            ref = want["params/" + "/".join(_jax_path(name, kind))]
            ref = ref + (None,) * (len(got[name]) - len(ref))
            transposed = kind in ("dense", "head", "router")
            assert got[name] == (ref[::-1] if transposed else ref), name


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
