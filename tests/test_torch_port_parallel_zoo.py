"""Port parity: ``shard_params`` + ``make_parallel_train_step`` on
``BertForPretraining`` and ``ResNet`` (``parallel/api.py``,
``parallel/placement.py``, ``models/bert.py``, ``models/resnet.py``).

Three SGD steps of the reference's GSPMD step (``horovod_tpu.parallel.api``
``shard_params`` + ``make_parallel_train_step(loss_fn=...)``, a tuple
batch) on the conftest's CPU mesh against the port's on gloo ranks of the
same mesh shape (this file run as a script per rank, ``_rank_main``), from
the same weights (``convert.params_from_jax``) and the same global batch,
fp32:

* BERT (``BertConfig.tiny()``: vocab 1024, H 64, 4 heads, 2 layers) under
  the reference example's loss at ``train=False`` with a key-padding mask
  that masks some keys, the port's attention through
  ``flash_attention_fn`` (the kernels' plain versions on the CPU, every
  layer's forward, dQ and dK/dV counted): ``tensor`` 2 (2 ranks),
  ``fsdp`` 2 x ``tensor`` 2 and ``data`` 2 x ``expert`` 2 (4); and 6 heads
  of 16 at ``tensor`` 4, where the heads do not divide (``qkv`` gathered);
* ResNet-18 at width 8, 64x64 images, 10 classes, under the model applied
  with ``train=True, mutable=["batch_stats"]`` (the new statistics thrown
  away) and softmax cross-entropy: ``tensor`` 2 (2 ranks), ``data`` 2 x
  ``fsdp`` 2 (BatchNorm over the global batch) and ``fsdp`` 2 x
  ``tensor`` 2 (4).  Its BatchNorm parameters and running statistics are
  perturbed away from their init so every path moves from the first
  step.  64x64, not 32x32: at 32x32 the last stage normalises 8 values at
  1x1, and the port's single-rank step itself parts from the reference by
  1.2e-5 to 7e-2 over three steps on every seed tried (fast variance's
  cancellation, ReLUs flipping on fp32 rounding); at 64x64 it holds
  within 8.2e-6 on seeds 0-11, and the scenarios' seeds (their index)
  are among them;
* every rank's losses within rtol 1e-5 of the reference's and equal
  across ranks; the whole parameters after the steps (``full_state_dict``)
  within ``tests/test_parallel_api.py:42``'s tolerance (5e-3 absolute and
  relative); a ResNet's running statistics, which the reference's step
  does not return, equal across ranks and within 1e-5 of the port's own
  world of one on the same global batch.

Besides: ``qkv``'s ``tensor`` layout (each rank its heads' block of q, of
k and of v; ROADMAP.md Queue C) and ``full_state_dict`` undoing it; BERT
under dropout on ``tensor`` 2 (the ranks, handed generators in one state,
draw the world of one's bits); a world of one through the parallel step
bit for bit the plain loop for ResNet (its BatchNorm statistics as
before); and the rules' placement of models with no hand placement,
gathered for use (``parallel/placement.py``), against the reference's
GSPMD step: ``MnistMLP`` at ``fsdp`` 2 (the rules replicate every leaf),
``MnistConvNet`` at ``tensor`` 2 (both convolutions split on their
out-channels) and at ``fsdp`` 2, and a user's two-``Linear`` module
(``body``, ``head``: the ``head/kernel`` rule) at ``fsdp`` 2 x ``tensor``
2 (4 ranks), each with ``param_shardings`` equal to the reference's leaf
for leaf and each rank holding the rules' block.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, IMG, STEPS, LR = 8, 16, 64, 3, 0.05
PARAM_TOL = 5e-3          # tests/test_parallel_api.py:42
LOSS_RTOL = 1e-5
STATS_TOL = 1e-5
SCENARIOS = {
    # name: (world size, mesh axes, model)
    "bert_tensor2": (2, {"tensor": 2}, "bert"),
    "resnet_tensor2": (2, {"tensor": 2}, "resnet"),
    "mnist_fsdp2": (2, {"data": 1, "fsdp": 2}, "mnist"),
    "mnistconv_tensor2": (2, {"tensor": 2}, "mnistconv"),
    "mnistconv_fsdp2": (2, {"fsdp": 2}, "mnistconv"),
    "user_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "user"),
    "bert_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "bert"),
    "bert_data2_expert2": (4, {"data": 2, "expert": 2}, "bert"),
    # 6 heads at tensor 4: qkv's 3H divides, the heads do not
    "bert6_tensor4": (4, {"tensor": 4}, "bert6"),
    "resnet_data2_fsdp2": (4, {"data": 2, "fsdp": 2}, "resnet"),
    "resnet_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "resnet"),
}


#: The models with no hand placement, gathered for use.
GENERIC = ("mnist", "mnistconv", "user")


class _UserNet(torch.nn.Module):
    """A user's module the converter does not know: the rules read its
    dotted names (``head`` takes the ``head/kernel`` rule, ``body`` none)."""

    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(28 * 28, 64)
        self.head = torch.nn.Linear(64, 10)

    def forward(self, x):
        x = torch.relu(self.body(x.reshape(x.shape[0], -1)))
        return self.head(x)


def _user_to_port(variables):
    return {f"{layer}.{k}": torch.from_numpy(np.array(
        v["kernel"].T if k == "weight" else v["bias"]))
        for layer, v in variables["params"].items()
        for k in ("weight", "bias")}


def _user_to_jax(state):
    return {"params": {layer: {"kernel": state[f"{layer}.weight"].numpy().T,
                               "bias": state[f"{layer}.bias"].numpy()}
                       for layer in ("body", "head")}}


def _cfg(kind):
    """The port's config of a scenario's model, fp32 (None: the user's
    module)."""
    from horovod_tpu_torch.models.bert import BertConfig
    from horovod_tpu_torch.models.mnist import MnistConfig
    from horovod_tpu_torch.models.resnet import ResNetConfig

    if kind.startswith("bert"):
        wide = dict(hidden_size=96, num_heads=6) if kind == "bert6" else {}
        return dataclasses.replace(BertConfig.tiny(), dtype=torch.float32,
                                   **wide)
    if kind == "resnet":
        return ResNetConfig.resnet18(num_classes=10, width=8,
                                     dtype=torch.float32)
    if kind == "user":
        return None
    return MnistConfig("conv" if kind == "mnistconv" else "mlp",
                       dtype=torch.float32)


def _bert_batch(vocab):
    """(ids, mlm labels, MLM targets, NSP labels, key mask): rows 1.. of
    the mask end early, so some keys are masked."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (B, S), dtype=np.int32)
    targets = rng.random((B, S)) < 0.15
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    nsp = rng.integers(0, 2, B, dtype=np.int32)
    lengths = np.array([S] + list(rng.integers(S // 2, S, B - 1)))
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    return ids, labels, targets, nsp, mask


def _images(channels=3, size=None):
    rng = np.random.default_rng(1)
    size = size or IMG
    x = rng.standard_normal((B, size, size, channels)).astype(np.float32)
    return x, rng.integers(0, 10, B).astype(np.int32)


def _port_batch(kind, n_dp):
    """The global batch the port's step takes, and its loss_fn."""
    from horovod_tpu_torch.examples.bert_pretraining_fsdp import (
        BertBatch, pretraining_loss)
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    def t(a):
        return torch.from_numpy(np.asarray(a))

    if kind.startswith("bert"):
        ids, labels, targets, nsp, mask = _bert_batch(_cfg(kind).vocab_size)
        batch = BertBatch(t(ids).long(), t(labels).long(), t(targets),
                          t(nsp).long(), attention_mask=t(mask))
        return batch.over(n_dp), pretraining_loss
    x, y = _images(1, 28) if kind in GENERIC else _images()

    def loss_fn(model, batch):
        kw = {"train": True} if kind == "resnet" else {}
        return softmax_cross_entropy(model(batch[0], **kw), batch[1])
    return (t(x), t(y).long()), loss_fn


def _port_model(kind, state):
    from horovod_tpu_torch.models.bert import BertForPretraining
    from horovod_tpu_torch.models.mnist import MnistConvNet, MnistMLP
    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.ops.flash_attention import flash_attention_fn

    if kind.startswith("bert"):
        return BertForPretraining.from_state_dict(_cfg(kind), state,
                                                  flash_attention_fn)
    if kind == "resnet":
        return ResNet.from_state_dict(_cfg(kind), state)
    if kind == "user":
        model = _UserNet()
        model.load_state_dict(state)
        return model
    cls = MnistConvNet if kind == "mnistconv" else MnistMLP
    return cls.from_state_dict(state, dtype=torch.float32)


def _rank_main(src: str, dst: str) -> None:
    """One rank: every scenario of its world size, in order.  IN holds the
    scenario names and each one's starting state (``<name>.w.<key>``);
    OUT each one's losses, whole parameters and buffers after the steps,
    the plain flash calls, this rank's block of layer 0's ``qkv`` weight
    and the dropout losses (BERT at ``tensor`` 2), and, for a model with
    no hand placement, this rank's block of every parameter, its index on
    each axis and whether the model was placed."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.api import (make_parallel_train_step,
                                                shard_params)
    from horovod_tpu_torch.parallel.placement import full_state_dict

    hvd.init(device="cpu")
    data = np.load(src)
    out = {}
    for name in [str(n) for n in data["names"]]:
        _, axes, kind = SCENARIOS[name]
        pre = name + ".w."
        state = {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(pre)}
        model = _port_model(kind, state)
        mesh = hvd.build_mesh(axes)
        n_dp = axes.get("data", 1) * axes.get("fsdp", 1)
        batch, loss_fn = _port_batch(kind, n_dp)
        shard_params(model, mesh)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=LR))
        step = make_parallel_train_step(model, opt, mesh, loss_fn=loss_fn)
        fa.reset_launches()
        out[name + ".losses"] = np.array([float(step(batch))
                                          for _ in range(STEPS)])
        out[name + ".plain"] = np.array([fa.plain_calls[k] for k in
                                         sorted(fa.plain_calls)])
        if kind.startswith("bert"):
            out[name + ".block"] = model.get_parameter(
                "encoder.layers.0.attention.qkv.weight").detach().numpy()
        if kind in GENERIC:
            out[name + ".placed"] = np.array(
                getattr(model, "placement", None) is not None)
            try:
                hvd.make_train_step(model, loss_fn, torch.optim.SGD(
                    model.parameters(), lr=LR))
                out[name + ".refused"] = np.array("")
            except ValueError as e:
                out[name + ".refused"] = np.array(str(e))
            out[name + ".coords"] = np.array([mesh.get_local_rank(a)
                                              for a in axes])
            for n, p in model.named_parameters():
                out[f"{name}.block.{n}"] = p.detach().numpy()
        for k, v in full_state_dict(model).items():
            out[name + ".final." + k] = v.numpy()
        for k, v in model.named_buffers():
            out[name + ".buf." + k] = v.numpy()
        if name == "bert_tensor2":
            out[name + ".dropout"] = _dropout_losses(kind, state, mesh,
                                                     batch)
    np.savez(dst.format(rank=hvd.rank()), **out)
    assert "jax" not in sys.modules
    hvd.shutdown()


def _dropout_losses(kind, state, mesh, batch):
    """The loss at ``train=True`` (dropout 0.1) of the model placed on
    ``mesh`` and of the world of one, each with a generator seeded 5."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy as xent
    from horovod_tpu_torch.parallel.api import shard_params

    losses = []
    for placed in (True, False):
        model = _port_model(kind, {k: v.clone() for k, v in state.items()})
        if placed:
            shard_params(model, mesh)
        mlm, nsp = model(batch.input_ids, None, batch.attention_mask,
                         train=True, generator=torch.Generator().manual_seed(5))
        losses.append(float(
            xent(mlm, batch.mlm_labels, where=batch.mask_positions,
                 reduction="sum") / batch.mlm_count
            + xent(nsp, batch.nsp_labels)))
    return np.array(losses)


def rank_world(script, n, *args):
    """``n`` gloo ranks of the test file ``script`` run as a script on
    ``args`` (one thread each)."""
    from horovod_tpu_torch.common.launch import World

    return World(n, [sys.executable, os.path.abspath(script), *args],
                 env=dict(PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                 drop=("HOROVOD_", "OMPI_", "PMI_", "JAX_", "XLA_"))


def _jax_model(kind):
    import jax.numpy as jnp

    from horovod_tpu.models.bert import BertConfig as JaxBertConfig
    from horovod_tpu.models.bert import BertForPretraining as JaxBert
    from horovod_tpu.models.mnist import MnistConvNet as JaxMnistConvNet
    from horovod_tpu.models.mnist import MnistMLP as JaxMnistMLP
    from horovod_tpu.models.resnet import ResNet18 as JaxResNet18

    if kind.startswith("bert"):
        cfg = _cfg(kind)
        return JaxBert(dataclasses.replace(
            JaxBertConfig.tiny(), dtype=jnp.float32,
            hidden_size=cfg.hidden_size, num_heads=cfg.num_heads))
    if kind == "resnet":
        return JaxResNet18(num_classes=10, width=8, dtype=jnp.float32)
    if kind == "user":
        import flax.linen as nn

        class UserNet(nn.Module):
            @nn.compact
            def __call__(self, x):
                x = x.reshape((x.shape[0], -1))
                x = nn.relu(nn.Dense(64, name="body")(x))
                return nn.Dense(10, name="head")(x)
        return UserNet()
    if kind == "mnistconv":
        return JaxMnistConvNet(dtype=jnp.float32)
    return JaxMnistMLP(dtype=jnp.float32)


def _init(kind, seed):
    """The reference's variables (a ResNet's BatchNorm scales, biases and
    running statistics perturbed from their init)."""
    import jax
    import jax.numpy as jnp

    model = _jax_model(kind)
    key = jax.random.key(seed)
    if kind.startswith("bert"):
        return model.init(key, jnp.zeros((1, S), jnp.int32))
    if kind in GENERIC:
        return model.init(key, jnp.zeros((1, 28, 28, 1)))
    v = jax.tree_util.tree_map(np.asarray, model.init(
        key, jnp.zeros((1, IMG, IMG, 3)), train=False))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" in name or "bn_init" in name:
            jitter = rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
            if name.endswith("['var']") or name.endswith("['scale']"):
                return (1.0 + jitter).astype(np.float32)
            return (0.2 * jitter).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, v)


def _reference(name, variables):
    """The reference's step: (losses, final variables as numpy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.ops.losses import softmax_cross_entropy as xent
    from horovod_tpu.parallel.api import (make_parallel_train_step,
                                          shard_params)

    n, axes, kind = SCENARIOS[name]
    model = _jax_model(kind)
    if kind.startswith("bert"):
        batch = _bert_batch(_cfg(kind).vocab_size)

        def loss_fn(params, batch):
            ids, labels, targets, nsp, mask = batch
            mlm_logits, nsp_logits = model.apply(
                params, ids, attention_mask=mask, train=False)
            return (xent(mlm_logits, labels, where=targets.astype(bool))
                    + xent(nsp_logits, nsp))
    else:
        batch = _images(1, 28) if kind in GENERIC else _images()

        def loss_fn(variables, batch):
            images, labels = batch
            if kind in GENERIC:
                return xent(model.apply(variables, images), labels)
            logits, _ = model.apply(variables, images, train=True,
                                    mutable=["batch_stats"])
            return xent(logits, labels)
    mesh = build_mesh(axes, devices=jax.devices()[:n])
    params = shard_params(variables, mesh)
    opt = optax.sgd(LR)
    step = make_parallel_train_step(model, opt, mesh, loss_fn=loss_fn,
                                    donate=False)
    state = jax.jit(opt.init)(params)
    batch = tuple(jnp.asarray(a) for a in batch)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds (2 and 4 ranks) started together, the references
    computed while they run: {scenario: (ref losses, ref variables,
    [rank outputs], port start state)}."""
    from horovod_tpu_torch.models.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("parallel_zoo")
    variables, starts = {}, {}
    for name, (_, _, kind) in SCENARIOS.items():
        variables[name] = _init(kind, list(SCENARIOS).index(name))
        starts[name] = (_user_to_port(variables[name]) if kind == "user"
                        else params_from_jax(variables[name], _cfg(kind),
                                             "cpu"))
    worlds = {}
    for n in (2, 4):
        names = [k for k, v in SCENARIOS.items() if v[0] == n]
        arrays = {"names": np.array(names)}
        for name in names:
            arrays.update({f"{name}.w.{k}": v.numpy()
                           for k, v in starts[name].items()})
        np.savez(tmp / f"in{n}.npz", **arrays)
        worlds[n] = rank_world(__file__, n, str(tmp / f"in{n}.npz"),
                               str(tmp / f"out{n}_{{rank}}.npz"))
    with worlds[2], worlds[4]:
        refs = {name: _reference(name, variables[name])
                for name in SCENARIOS}
        for world in worlds.values():
            world.wait(timeout_s=240)
    out = {}
    for name, (n, _, _) in SCENARIOS.items():
        ranks = [np.load(tmp / f"out{n}_{r}.npz") for r in range(n)]
        out[name] = (*refs[name], ranks, starts[name])
    return out


def _final(rank, name, prefix="final"):
    pre = f"{name}.{prefix}."
    return {k[len(pre):]: torch.from_numpy(rank[k]) for k in rank.files
            if k.startswith(pre)}


def _assert_params_close(cfg, final, ref_vars):
    import jax

    from horovod_tpu_torch.models.convert import params_to_jax

    tree = _user_to_jax(final) if cfg is None else params_to_jax(final, cfg)
    got = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    want = jax.tree_util.tree_leaves_with_path(ref_vars["params"])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


PLACED = [k for k, v in SCENARIOS.items() if v[2] != "mnist"]
RULES_ONLY = [k for k, v in SCENARIOS.items() if v[2] in GENERIC]


@pytest.mark.parametrize("name", PLACED)
def test_parallel_step_tracks_the_reference(runs, name):
    ref_losses, ref_vars, ranks, _ = runs[name]
    _, _, kind = SCENARIOS[name]
    cfg = _cfg(kind)
    for r in range(1, len(ranks)):
        np.testing.assert_array_equal(ranks[r][name + ".losses"],
                                      ranks[0][name + ".losses"])
    np.testing.assert_allclose(ranks[0][name + ".losses"], ref_losses,
                               rtol=LOSS_RTOL)
    for rank in ranks:
        final = _final(rank, name)
        if kind == "resnet":     # params_to_jax carries the whole state
            final.update(_final(rank, name, "buf"))
        _assert_params_close(cfg, final, ref_vars)
        # Every layer's attention through the three kernels (their plain
        # versions here), once a layer a step.
        want = cfg.num_layers * STEPS if kind.startswith("bert") else 0
        assert list(rank[name + ".plain"]) == [want] * 3


@pytest.mark.parametrize("name", [k for k in PLACED
                                  if SCENARIOS[k][2] == "resnet"])
def test_running_statistics_are_the_global_batchs(runs, name):
    """The reference's step returns no statistics: each rank's running
    mean and variance after the steps equal every other rank's and are
    within 1e-5 of the port's world of one on the same global batch."""
    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    _, _, ranks, start = runs[name]
    model = ResNet.from_state_dict(_cfg("resnet"), {
        k: v.clone() for k, v in start.items()})
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    x, y = (torch.from_numpy(a) for a in _images())
    for _ in range(STEPS):
        opt.zero_grad()
        softmax_cross_entropy(model(x, train=True), y.long()).backward()
        opt.step()
    want = dict(model.named_buffers())
    for rank in ranks:
        got = _final(rank, name, "buf")
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], _final(ranks[0], name,
                                                         "buf")[k])
            np.testing.assert_allclose(got[k], w, rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["bert_tensor2", "bert_fsdp2_tensor2"])
def test_qkv_blocks_hold_each_ranks_heads(runs, name):
    """Under ``tensor`` t with the heads divisible, rank i holds its heads'
    rows of q, then of k, then of v ([3H/t, .] of the port's [3H, H]),
    not the rules' contiguous rows [i 3H/t, (i+1) 3H/t); the whole weight
    from ``full_state_dict`` is the model's layout again (the
    reference's, which the parameter check above holds)."""
    _, _, ranks, _ = runs[name]
    _, axes, _ = SCENARIOS[name]
    t = axes["tensor"]
    key = "encoder.layers.0.attention.qkv.weight"
    for r, rank in enumerate(ranks):
        full = rank[name + ".final." + key]
        i = r % t                          # tensor is the innermost axis
        block = rank[name + ".block"]
        f = axes.get("fsdp", 1)
        cols = np.split(full, f, axis=1)[(r // t) % f]
        q, k, v = np.split(cols, 3, axis=0)
        want = np.concatenate([np.split(part, t, axis=0)[i]
                               for part in (q, k, v)], axis=0)
        np.testing.assert_array_equal(block, want)
        assert not np.array_equal(block, np.split(cols, t, axis=0)[i])


def test_heads_that_do_not_divide_keep_the_rules_layout(runs):
    """6 heads at ``tensor`` 4: each rank holds the rules' contiguous rows
    of ``qkv`` (its product is gathered whole before the heads split)."""
    _, _, ranks, _ = runs["bert6_tensor4"]
    key = "encoder.layers.0.attention.qkv.weight"
    for r, rank in enumerate(ranks):
        full = rank["bert6_tensor4.final." + key]
        np.testing.assert_array_equal(rank["bert6_tensor4.block"],
                                      np.split(full, 4, axis=0)[r])


def test_dropout_bits_match_across_a_tensor_group(runs):
    """``train=True`` on ``tensor`` 2: the placed model's loss equals the
    world of one's under the same generator state (dropout draws on
    whole activations), on both ranks."""
    _, _, ranks, _ = runs["bert_tensor2"]
    for rank in ranks:
        placed, alone = rank["bert_tensor2.dropout"]
        np.testing.assert_allclose(placed, alone, rtol=LOSS_RTOL)
    without = ranks[0]["bert_tensor2.losses"][0]
    assert abs(ranks[0]["bert_tensor2.dropout"][1] - without) > 1e-3


def test_fsdp2_shards_a_model_without_hand_placement(runs):
    """``MnistMLP`` (no hand placement) at ``fsdp`` 2: the rules replicate
    every leaf (its kernels are 2-dimensional, the ``kernel$`` rule
    names 4), so ``shard_params`` leaves the model whole on each rank (no
    FSDP2 unit shards what the rules replicate), the parallel step splits
    the rows over ``fsdp``, and the losses and whole parameters track the
    reference's GSPMD step."""
    ref_losses, ref_vars, ranks, start = runs["mnist_fsdp2"]
    for rank in ranks:
        assert not bool(rank["mnist_fsdp2.placed"])
        blocks = _final(rank, "mnist_fsdp2", "block")
        assert {k: tuple(v.shape) for k, v in blocks.items()} == \
            {k: tuple(v.shape) for k, v in start.items()}
        np.testing.assert_allclose(rank["mnist_fsdp2.losses"], ref_losses,
                                   rtol=LOSS_RTOL)
        _assert_params_close(_cfg("mnist"), _final(rank, "mnist_fsdp2"),
                             ref_vars)


def _reference_shardings(name, variables):
    """The reference's ``param_shardings`` of a scenario's variables on
    its mesh, by the port's parameter name: (mesh axis or None) per
    reference dimension, laid on the port's dimensions."""
    import jax

    from horovod_tpu.jax import build_mesh
    from horovod_tpu.parallel.api import param_shardings

    n, axes, kind = SCENARIOS[name]
    mesh = build_mesh(axes, devices=jax.devices()[:n])
    tree = param_shardings(variables, mesh)["params"]
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(tree):
        keys = [k.key for k in path]
        leaf = np.asarray(variables["params"][keys[0]][keys[1]])
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        out[tuple(keys)] = spec
    return out


@pytest.mark.parametrize("name", RULES_ONLY)
def test_rules_place_models_without_hand_placement(runs, name):
    """``param_shardings`` of a model with no hand placement equals the
    reference's leaf for leaf (each mesh axis on the port dimension that
    holds the reference's: a ``Linear`` weight's spec reversed, a conv
    weight's out-channels on dimension 0), each rank holds the rules'
    block of the whole parameter after the steps, and ``make_train_step``
    refuses the model where it is placed."""
    from horovod_tpu_torch.models.convert import flax_layout, params_to_jax
    from horovod_tpu_torch.parallel.api import param_shardings

    _, _, ranks, start = runs[name]
    n, axes, kind = SCENARIOS[name]
    model = _port_model(kind, {k: v.clone() for k, v in start.items()})
    got = param_shardings(model, axes)
    if kind == "user":
        variables = _user_to_jax(start)
        layout = {}
        for k in ("body", "head"):
            layout[f"{k}.weight"] = (f"params/{k}/kernel", (1, 0))
            layout[f"{k}.bias"] = (f"params/{k}/bias", None)
    else:
        variables = params_to_jax(start, _cfg(kind))
        layout = flax_layout(_cfg(kind))
    want = _reference_shardings(name, variables)
    assert len(got) == len(want) == len(start)
    for pname, spec in got.items():
        path, dims = layout[pname]
        ref = want[tuple(path.split("/")[1:])]
        dims = dims or tuple(range(len(ref)))
        assert (spec or (None,) * len(ref)) == tuple(ref[j] for j in dims), \
            (pname, spec, ref)
    placed = any(any(s) for s in got.values())
    for rank in ranks:
        assert bool(rank[name + ".placed"]) == placed
        # make_train_step averages over every rank: it refuses a placed
        # model and takes one the rules leave whole.
        assert ("make_parallel_train_step" in str(rank[name + ".refused"])) \
            == placed
        coords = dict(zip(axes, rank[name + ".coords"].tolist()))
        for pname, whole in _final(rank, name).items():
            block = whole
            for d, a in enumerate(got[pname]):
                if a is not None:
                    block = block.chunk(axes[a], d)[coords[a]]
            np.testing.assert_array_equal(
                rank[f"{name}.block.{pname}"], block.numpy(), err_msg=pname)


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


def test_world_of_one_resnet_is_the_plain_loop(cpu_world):
    """Every axis 1: no placement, and the ResNet's parallel step is the
    plain loop's bit for bit — losses, parameters and running
    statistics."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy
    from horovod_tpu_torch.parallel.api import make_parallel_train_step

    cfg = _cfg("resnet")
    state = init_params(cfg, 3, "cpu")
    (x, y), loss_fn = _port_batch("resnet", 1)
    model = ResNet.from_state_dict(cfg, {k: v.clone()
                                         for k, v in state.items()})
    mesh = hvd.build_mesh({"data": 1, "fsdp": 1, "expert": 1, "tensor": 1})
    step = make_parallel_train_step(
        model, torch.optim.SGD(model.parameters(), lr=LR), mesh,
        loss_fn=loss_fn)
    assert model.placement is None
    plain = ResNet.from_state_dict(cfg, {k: v.clone()
                                         for k, v in state.items()})
    opt = torch.optim.SGD(plain.parameters(), lr=LR)
    for _ in range(STEPS):
        got = step((x, y))
        opt.zero_grad()
        loss = softmax_cross_entropy(plain(x, train=True), y)
        loss.backward()
        opt.step()
        assert torch.equal(got, loss.detach())
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              plain.state_dict().items()):
        assert torch.equal(a, b), n


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
