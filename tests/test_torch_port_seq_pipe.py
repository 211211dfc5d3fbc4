"""Port parity: the context-parallel step, the pipelined step and
``pipeline_apply`` (``parallel/seq.py``, ``parallel/pipeline.py``).

On 4 gloo ranks (this file run as a script per rank, ``_rank_main``)
against the reference's steps on the conftest's CPU mesh of the same
shape and against the dense single-shard SGD step, fp32, with
``tests/test_parallel_llm.py``'s tolerances (loss within 2e-5, parameters
within 1e-5 + 1e-4 |ref|):

* ``make_context_parallel_train_step``: the ring on ``seq`` 4 and on
  ``data`` 2 x ``seq`` 2, Ulysses on ``data`` 2 x ``seq`` 2
  (``test_parallel_llm.py:49``);
* ``make_pipelined_llama_train_step``: ``pipe`` 4 and ``pipe`` 2 x
  ``data`` 2, 2 microbatches (``test_parallel_llm.py:71, :109``), and its
  ZeRO rung, ``pipe`` 2 x ``fsdp`` 2 under
  ``DistributedOptimizer(AdamW, fsdp=True)`` for 2 steps against the
  reference's step under ``DistributedOptimizer(optax.adamw, fsdp=True)``
  and the dense AdamW steps, each rank's optimizer state the exact bytes
  of its halves (``test_parallel_llm.py:109``), at 2 layers (one a stage:
  each parameter's block) and at 4 (two a stage: whole layers stacked);
* ``pipeline_apply`` against sequential layers: outputs (2, 2), (4, 4) and
  (4, 2) stages x microbatches (``test_pipeline.py:45``) and stage
  gradients (``:76``, ``:131``: the broadcast from the last stage does not
  multiply them by the stage count), and the batch-divisibility error's
  wording (``:112``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01
LOSS_ATOL = 2e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
PIPE_TOL = 1e-5                 # tests/test_pipeline.py

# name: (kind, mesh axes, attention or n_microbatches, layers, B, S+1)
STEPS = {
    "ring_seq4": ("seq", {"data": 1, "seq": 4}, "ring", 2, 4, 33),
    "ring_data2_seq2": ("seq", {"data": 2, "seq": 2}, "ring", 2, 4, 33),
    "ulysses_data2_seq2": ("seq", {"data": 2, "seq": 2}, "ulysses", 2, 4,
                           33),
    "pipe4": ("pipe", {"pipe": 4}, 2, 4, 8, 17),
    "pipe2_data2": ("pipe", {"pipe": 2, "data": 2}, 2, 2, 8, 17),
    "pipe2_fsdp2": ("pipe", {"pipe": 2, "fsdp": 2}, 2, 2, 8, 17),
    "pipe2_fsdp2_l4": ("pipe", {"pipe": 2, "fsdp": 2}, 2, 4, 8, 17),
}
#: The cases stepped by AdamW (torch's and optax's defaults but the
#: decay), 2 steps: the ZeRO rung's.
ADAMW, ADAMW_STEPS = dict(lr=1e-3, weight_decay=0.01), 2
PIPE_CASES = [(2, 2), (4, 4), (4, 2)]


def _cfg(layers):
    from horovod_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               logits_dtype=torch.float32,
                               num_layers=layers)


def _tokens(B, S):
    return np.random.default_rng(0).integers(0, 512, (B, S))


def _mlp_layers(n_layers, width, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((width, width)) * 0.5).astype(
        np.float32), "b": np.zeros((width,), np.float32)}
        for _ in range(n_layers)]


def _rank_main(src: str, dst: str) -> None:
    """One rank of the 4-rank world: every step case, then the
    ``pipeline_apply`` cases.  OUT: losses, the parameters this rank can
    report whole after each step (a pipeline stage its own layers and the
    replicated rest, by ``LlamaModel`` name), and pipeline outputs and
    stage gradients."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.parallel.pipeline import (
        init_pipelined_llama, make_pipelined_llama_train_step,
        pipeline_apply, stack_pytrees)
    from horovod_tpu_torch.parallel.seq import (
        make_context_parallel_train_step)

    hvd.init(device="cpu")
    data = np.load(src)
    out = {}
    for name, (kind, axes, how, layers, B, S) in STEPS.items():
        cfg = _cfg(layers)
        pre = name + ".w."
        state = {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(pre)}
        mesh = hvd.build_mesh(axes)
        tokens = torch.from_numpy(_tokens(B, S))
        # The models below take these tensors as their parameters.
        fresh = {k: v.clone() for k, v in state.items()}
        if kind == "seq":
            model = LlamaModel.from_state_dict(cfg, state)
            step = make_context_parallel_train_step(
                cfg, hvd.DistributedOptimizer(torch.optim.SGD(
                    model.parameters(), lr=LR)), mesh, attention=how)
            named = dict(model.named_parameters())
        else:
            model = init_pipelined_llama(cfg, state, axes["pipe"], mesh=mesh)
            if "fsdp" in axes:
                inner = torch.optim.AdamW(model.parameters(), **ADAMW)
                opt = hvd.DistributedOptimizer(inner, fsdp=True)
            else:
                opt = torch.optim.SGD(model.parameters(), lr=LR)
            step = make_pipelined_llama_train_step(cfg, opt, mesh,
                                                   n_microbatches=how)
            named = {model.global_name(n): p
                     for n, p in model.named_parameters()}
        for _ in range(ADAMW_STEPS if "fsdp" in axes else 1):
            out[name + ".loss"] = np.array(float(step(model, tokens[:, :-1],
                                                      tokens[:, 1:])))
        if "fsdp" in axes:
            out[name + ".state_bytes"] = np.array(sum(
                t.numel() * t.element_size() for st in inner.state.values()
                for t in st.values() if torch.is_tensor(t)))
            # The same steps with the state whole on every rank.
            whole = init_pipelined_llama(cfg, fresh, axes["pipe"],
                                         mesh=mesh)
            plain = make_pipelined_llama_train_step(
                cfg, torch.optim.AdamW(whole.parameters(), **ADAMW), mesh,
                n_microbatches=how)
            for _ in range(ADAMW_STEPS):
                plain(whole, tokens[:, :-1], tokens[:, 1:])
            for n, p in whole.named_parameters():
                out[f"{name}.whole.{whole.global_name(n)}"] = \
                    p.detach().numpy()
        for n, p in named.items():
            out[f"{name}.final.{n}"] = p.detach().numpy()
    # pipeline_apply against sequential layers
    for n_stages, n_micro in PIPE_CASES:
        mesh = hvd.build_mesh({"pipe": n_stages, "data": 4 // n_stages})
        stage = mesh.get_local_rank("pipe")
        width, B, L = (8, 8, 8) if (n_stages, n_micro) != (2, 2) else \
            (4, 4, 4)
        layers = [{k: torch.from_numpy(v) for k, v in lp.items()}
                  for lp in _mlp_layers(L, width, n_stages * 10 + n_micro)]
        per = L // n_stages
        mine = {k: v.clone().requires_grad_(True) for k, v in stack_pytrees(
            layers[stage * per:(stage + 1) * per]).items()}

        def stage_fn(params, x):
            for i in range(params["w"].shape[0]):
                x = torch.tanh(x @ params["w"][i] + params["b"][i])
            return x

        x = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (B, width)).astype(np.float32))
        y = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (B, width)).astype(np.float32))
        got = pipeline_apply(stage_fn, mine, x, axis_name="pipe",
                             n_microbatches=n_micro, mesh=mesh)
        ((got - y) ** 2).mean().backward()
        key = f"pipe{n_stages}x{n_micro}"
        out[key + ".out"] = got.detach().numpy()
        for k, v in mine.items():
            out[f"{key}.grad.{k}"] = v.grad.numpy()
        out[key + ".stage"] = np.array(stage)
    try:
        pipeline_apply(lambda p, x: x, {}, torch.ones(4, 4),
                       axis_name="pipe", n_microbatches=3,
                       mesh=hvd.build_mesh({"pipe": 2, "data": 2}))
    except ValueError as e:
        out["divisibility_error"] = np.array(str(e))
    np.savez(dst.format(rank=hvd.rank()), **out)
    assert "jax" not in sys.modules
    hvd.shutdown()


def _jax_cfg(layers):
    import jax.numpy as jnp

    from horovod_tpu.models import LlamaConfig as JaxLlamaConfig

    return dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                               logits_dtype=jnp.float32, num_layers=layers)


def _optimizer(name):
    """(the case's optax optimizer, its steps)."""
    import optax

    if "fsdp" in STEPS[name][1]:
        return optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"]), \
            ADAMW_STEPS
    return optax.sgd(LR), 1


def _dense_reference(cfg, params, tokens, opt, steps):
    """``tests/test_parallel_llm.py``'s plain single-shard steps: (the
    last step's loss, the parameters after them)."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import LlamaModel as JaxLlamaModel

    model = JaxLlamaModel(cfg)

    def loss_fn(params):
        logits = model.apply(params, tokens[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, tokens[:, 1:, None],
                                             -1))
    state = opt.init(params)
    for _ in range(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return float(loss), params


def _references(name, variables):
    """(reference step loss, params; dense loss, params) as the port's
    state dicts (numpy)."""
    import jax
    import optax

    from horovod_tpu.jax import DistributedOptimizer, build_mesh
    from horovod_tpu.parallel.pipeline import make_pipelined_llama_train_step
    from horovod_tpu.parallel.seq import make_context_parallel_train_step
    from horovod_tpu_torch.models.convert import params_from_jax

    kind, axes, how, layers, B, S = STEPS[name]
    cfg = _jax_cfg(layers)
    tokens = np.asarray(_tokens(B, S), np.int32)
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(axes, devices=jax.devices()[:n])
    opt, steps = _optimizer(name)
    if kind == "seq":
        step = make_context_parallel_train_step(cfg, opt, mesh,
                                                attention=how, donate=False)
        params, _, loss = step(variables, jax.jit(opt.init)(variables),
                               tokens[:, :-1], tokens[:, 1:])
    else:
        P = axes["pipe"]
        flat = [variables["params"][f"layer_{i}"] for i in range(layers)]
        staged = jax.tree.map(lambda *a: np.stack(a).reshape(
            (P, layers // P) + a[0].shape), *flat)
        rest = {k: variables["params"][k]
                for k in ("tok_emb", "norm_f", "lm_head")}
        pp1 = {"stages": staged, "rest": rest}
        wrapped = (DistributedOptimizer(opt, fsdp=True) if "fsdp" in axes
                   else opt)
        step = make_pipelined_llama_train_step(cfg, wrapped, mesh,
                                               n_microbatches=how,
                                               donate=False)
        state = jax.jit(opt.init)(pp1)
        for _ in range(steps):
            pp1, state, loss = step(pp1, state, tokens[:, :-1],
                                    tokens[:, 1:])
        flat1 = jax.tree.map(lambda a: np.asarray(a).reshape(
            (layers,) + a.shape[2:]), pp1["stages"])
        params = {"params": dict(pp1["rest"])}
        for i in range(layers):
            params["params"][f"layer_{i}"] = jax.tree.map(lambda a: a[i],
                                                          flat1)
    tcfg = _cfg(layers)
    dense_loss, dense = _dense_reference(cfg, variables, tokens,
                                         *_optimizer(name))
    return (float(loss), params_from_jax(params, tcfg, "cpu"),
            dense_loss, params_from_jax(dense, tcfg, "cpu"))


def _sequential(n_stages, n_micro):
    """``tests/test_pipeline.py``'s sequential outputs and the gradients of
    each stage's stacked parameters."""
    import jax
    import jax.numpy as jnp

    width, B, L = (8, 8, 8) if (n_stages, n_micro) != (2, 2) else (4, 4, 4)
    layers = _mlp_layers(L, width, n_stages * 10 + n_micro)
    x = np.random.default_rng(9).standard_normal((B, width)).astype(
        np.float32)
    y = np.random.default_rng(6).standard_normal((B, width)).astype(
        np.float32)
    stacked = {k: jnp.stack([lp[k] for lp in layers]) for k in ("w", "b")}

    def run(st, x):
        for i in range(L):
            x = jnp.tanh(x @ st["w"][i] + st["b"][i])
        return x

    def loss(st):
        return jnp.mean((run(st, x) - y) ** 2)
    grads = jax.grad(loss)(stacked)
    return np.asarray(run(stacked, x)), {k: np.asarray(v)
                                         for k, v in grads.items()}, L


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world, the references computed while it runs."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import LlamaModel as JaxLlamaModel
    from horovod_tpu_torch.models.convert import params_from_jax

    from test_torch_port_parallel_step import rank_world

    tmp = tmp_path_factory.mktemp("seq_pipe")
    variables, arrays = {}, {}
    for i, (name, (_, _, _, layers, _, _)) in enumerate(STEPS.items()):
        variables[name] = JaxLlamaModel(_jax_cfg(layers)).init(
            jax.random.key(i), jnp.zeros((1, 8), jnp.int32))
        for k, v in params_from_jax(variables[name], _cfg(layers),
                                    "cpu").items():
            arrays[f"{name}.w.{k}"] = v.numpy()
    np.savez(tmp / "in.npz", **arrays)
    with rank_world(__file__, 4, str(tmp / "in.npz"),
                    str(tmp / "out{rank}.npz")) as world:
        refs = {name: _references(name, variables[name]) for name in STEPS}
        seq = {case: _sequential(*case) for case in PIPE_CASES}
        world.wait(timeout_s=240)
    ranks = [np.load(tmp / f"out{r}.npz") for r in range(4)]
    return refs, seq, ranks


#: (against, case).  The dense arm leaves out ``pipe2_fsdp2_l4``: there
#: the reference's own pipelined AdamW step misses the dense AdamW steps
#: on one element of ``layers.3.mlp.w_gate_up`` by 3.2e-5, past
#: ``PARAM_ATOL + PARAM_RTOL |ref|`` (Adam's update of a near-zero
#: gradient amplifies the summation order).  The case is held against
#: the reference's step and, bitwise, against the port's step with the
#: state whole.
MATCHES = [(against, name) for against in ("reference_step", "dense")
           for name in STEPS
           if (against, name) != ("dense", "pipe2_fsdp2_l4")]


@pytest.mark.parametrize("against,name", MATCHES)
def test_step_matches(world, name, against):
    refs, _, ranks = world
    ref_loss, ref_params, dense_loss, dense_params = refs[name]
    loss, params = ((ref_loss, ref_params) if against == "reference_step"
                    else (dense_loss, dense_params))
    for rank in ranks:
        assert float(rank[name + ".loss"]) == pytest.approx(loss,
                                                            abs=LOSS_ATOL)
        pre = name + ".final."
        names = [k[len(pre):] for k in rank.files if k.startswith(pre)]
        assert names
        for n in names:
            np.testing.assert_allclose(rank[pre + n], params[n].numpy(),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=n)
    # Between them, the ranks report every parameter.
    seen = {k for rank in ranks for k in rank.files
            if k.startswith(name + ".final.")}
    assert len(seen) == len(params)
    _, axes, _, layers, _, _ = STEPS[name]
    if "fsdp" in axes:
        # ZeRO over fsdp 2: two fp32 moments of half of each leaf that has
        # an even dimension, of all of any other, and each leaf's step
        # count whole (AdamW's 0-dim fp32 tensor).  Where fsdp divides a
        # stage's layer count, the leaf is the stage's layers of one name
        # stacked: half of them, and one step count for the stack.
        stacked = (layers // axes["pipe"]) % axes["fsdp"] == 0
        for rank in ranks:
            pre = name + ".final."
            want, stacks = 0, {}
            for k in rank.files:
                if not k.startswith(pre):
                    continue
                n, a = k[len(pre):], rank[k]
                if stacked and n.startswith("layers."):
                    local = n.split(".", 2)[2]
                    stacks[local] = stacks.get(local, 0) + a.size
                else:
                    want += 8 * a.size // (
                        2 if any(d % 2 == 0 for d in a.shape) else 1) + 4
            want += sum(8 * size // axes["fsdp"] + 4
                        for size in stacks.values())
            assert bool(stacks) == stacked
            assert int(rank[name + ".state_bytes"]) == want
            # Sharding the state changes no bit of the step.
            for k in rank.files:
                if k.startswith(pre):
                    n = k[len(pre):]
                    assert np.array_equal(rank[k],
                                          rank[f"{name}.whole.{n}"]), n


@pytest.mark.parametrize("n_stages,n_micro", PIPE_CASES)
def test_pipeline_apply_matches_sequential(world, n_stages, n_micro):
    _, seq, ranks = world
    want, grads, L = seq[(n_stages, n_micro)]
    per = L // n_stages
    key = f"pipe{n_stages}x{n_micro}"
    for rank in ranks:
        np.testing.assert_allclose(rank[key + ".out"], want, atol=PIPE_TOL,
                                   rtol=PIPE_TOL)
        s = int(rank[key + ".stage"])
        for k in ("w", "b"):
            np.testing.assert_allclose(
                rank[f"{key}.grad.{k}"], grads[k][s * per:(s + 1) * per],
                atol=PIPE_TOL, rtol=PIPE_TOL, err_msg=k)


def test_pipeline_batch_divisibility_error(world):
    _, _, ranks = world
    for rank in ranks:
        assert "not divisible" in str(rank["divisibility_error"])
        assert str(rank["divisibility_error"]) == \
            "batch 4 not divisible by 3 microbatches"


def test_stack_and_unstack_state_dicts():
    from horovod_tpu_torch.parallel.pipeline import (stack_pytrees,
                                                     unstack_pytree)

    trees = [{"a": torch.full((2,), float(i)), "n": {"b": torch.ones(3) * i}}
             for i in range(3)]
    stacked = stack_pytrees(trees)
    assert stacked["a"].shape == (3, 2) and stacked["n"]["b"].shape == (3, 3)
    back = unstack_pytree(stacked, 3)
    for t, b in zip(trees, back):
        assert torch.equal(t["a"], b["a"])
        assert torch.equal(t["n"]["b"], b["n"]["b"])


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
