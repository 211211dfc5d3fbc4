"""Port parity: ResNet and its weights across frameworks.

* ``same_padding`` against ``lax.padtype_to_pads(..., "SAME")``;
* ResNet-50's parameter count (25,557,032, tests/test_models.py) and
  flax's tree, both ways through ``models/convert.py``;
* fp32 ResNet-50 (B 2, 64 x 64) against flax on the same weights:
  ``train=True`` logits and the updated ``batch_stats``, eval-mode
  logits, and the gradients of the bench's loss against ``jax.grad``.
  With flax's weights perturbed (every BatchNorm scale, bias and running
  statistic drawn, so no block starts as the identity) the reference is
  flax in fp64: there flax's own fp32 gradients land up to 0.04 (relative
  L2) from its fp64 ones and the port's within 0.01, so fp64 is what can
  tell a wrong port from fp32 noise.  At the bench's own start (zero last
  BatchNorm scales) both fp32 and fp64 flax hold the gradients to 1e-4;
* one bf16 ``BottleneckBlock`` (stride 2, with its projection) against
  flax's in bf16;
* the bench step and its entry point: tests/test_torch_port_resnet_bench.py.

Tolerances are stated where they are used.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from horovod_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from horovod_tpu.models.resnet import ResNet50 as JaxResNet50
from horovod_tpu_torch import bench as port_bench
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                             ResNetConfig, same_padding)

CFG = ResNetConfig.resnet50(dtype=torch.float32)
B, S = 2, 64


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3), dtype=np.float32)


def _perturb(variables, seed):
    """Every BatchNorm scale 1 + 0.1·N (the zero-initialised ones too),
    bias 0.1·N, running mean 0.1·N, running var 1 + 0.2·|N|; the head's
    bias 0.1·N."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if name == "scale":
            return v * 0 + 1 + 0.1 * noise
        if name in ("bias", "mean"):
            return v * 0 + 0.1 * noise
        if name == "var":
            return v * 0 + 1 + 0.2 * np.abs(noise)
        return v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _close_to_max(got, want, rel, name="", floor=0.0):
    """max |got − want| <= rel · max |want| + floor, as numpy arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top + floor, \
        f"{name}: max |d| {err} vs {rel} x {top} + {floor}"


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax(variables, x, dtype, labels=None):
    """flax ResNet-50 in ``dtype`` on ``variables`` (cast to it), as
    numpy: without ``labels`` the train logits, updated batch_stats and
    eval logits; with them the bench loss and its parameter gradients
    (batch statistics, train=True).  fp64 runs inside
    ``jax.enable_x64``."""
    model = JaxResNet50(dtype=dtype)
    v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    x = jnp.asarray(x, dtype)
    out = {}
    if labels is None:
        logits, upd = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
        out["train"], out["stats"] = np.asarray(logits), _flat(
            upd["batch_stats"])
        out["eval"] = np.asarray(jax.jit(lambda v, x: model.apply(
            v, x, train=False))(v, x))
    else:
        def loss(params):
            lg, _ = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
            logp = jax.nn.log_softmax(lg)
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))

        value, grads = jax.jit(jax.value_and_grad(loss))(v["params"])
        out["loss"], out["grads"] = float(value), _flat(grads)
    return out


def _fp64(variables, x, labels=None):
    with jax.enable_x64(True):
        return _flax(variables, x, jnp.float64, labels)


def _port(variables):
    return ResNet.from_state_dict(CFG, params_from_jax(variables, CFG,
                                                       "cpu"))


def _port_grads(model, x, labels):
    model.zero_grad(set_to_none=True)
    loss = port_bench.loss_fn(model, (torch.from_numpy(x),
                                      torch.from_numpy(labels)))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update(model.named_buffers())
    return float(loss.detach()), _flat(params_to_jax(grads, CFG)["params"])


@pytest.fixture(scope="module")
def r50():
    """flax ResNet-50's variables as its ``init`` makes them (the bench's
    start: the last BatchNorm scale of each block at zero, so every block
    starts as the identity) and perturbed (every BatchNorm scale, bias
    and running statistic drawn, so every block computes)."""
    model = JaxResNet50(dtype=jnp.float32)
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, S, S, 3)), train=False))())
    return variables, jax.device_get(_perturb(variables, seed=1))


@pytest.mark.parametrize("size,k,s", [(56, 3, 2), (55, 3, 2), (112, 3, 2),
                                      (7, 1, 2), (224, 7, 2), (28, 3, 1),
                                      (5, 3, 2), (1, 3, 2), (2, 1, 2),
                                      (14, 1, 1)])
def test_same_padding_matches_lax(size, k, s):
    assert same_padding(size, k, s) == \
        tuple(lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0])


def test_resnet50_parameter_count_and_tree(r50):
    """25,557,032 parameters (buffers apart); the seeded init fills flax's
    tree leaf for leaf (shapes, and both collections), and flax's
    variables come back bitwise through params_to_jax."""
    variables = r50[1]
    port = _port(variables)
    assert sum(p.numel() for p in port.parameters()) == 25_557_032
    state = init_params(CFG, 0, "cpu")
    assert sum(state[n].numel() for n, _ in port.named_parameters()) == \
        25_557_032
    # The last BatchNorm scale of each block starts at zero, the rest at 1.
    assert float(state["blocks.5.norms.2.scale"].abs().max()) == 0.0
    assert float(state["blocks.5.norms.1.scale"].min()) == 1.0
    back = params_to_jax(port.state_dict(), CFG)
    want, got = _flat(variables), _flat(back)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    seeded = _flat(params_to_jax(state, CFG))
    assert {k: v.shape for k, v in seeded.items()} == \
        {k: v.shape for k, v in want.items()}


def test_resnet50_forward_and_batch_stats_match_flax(r50):
    """fp32 port, perturbed weights, against flax in fp64 (the same
    function computed exactly enough): train=True logits within 3e-4 of
    the largest |logit| — 53 BatchNorms over 8 to 2048 values a channel
    renormalise what each layer's fp32 rounding moved, and flax's own
    fp32 run lands 2e-4 from its fp64 one here; every updated running
    mean and var within 1e-5 of its tensor's largest; eval-mode logits
    (the running statistics, left unchanged) within 1e-5."""
    variables = r50[1]
    x = _images(B, S, seed=2)
    want = _fp64(variables, x)
    port = _port(variables)
    mean = port.bn_init.mean.clone()
    with torch.no_grad():
        evl = port(torch.from_numpy(x))
    assert torch.equal(port.bn_init.mean, mean)
    _close_to_max(evl.numpy(), want["eval"], 1e-5, "eval logits")
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=True)
    _close_to_max(got.numpy(), want["train"], 3e-4, "train logits")
    stats = _flat(params_to_jax(port.state_dict(), CFG)["batch_stats"])
    for k, v in stats.items():
        _close_to_max(v, want["stats"][k], 1e-5, k)


def test_resnet50_gradients_match_jax_grad(r50):
    """The bench's loss (fp32 log-softmax NLL, train=True) at the bench's
    own start: every parameter's gradient within 1e-4 of its tensor's
    largest, against flax in fp32 and in fp64 (the main paths' convolutions
    get exact zeros on both sides behind the zero scales)."""
    variables = r50[0]
    x, labels = _images(B, S, seed=4), np.array([3, 997])
    loss, got = _port_grads(_port(variables), x, labels)
    for want in (_flax(variables, x, jnp.float32, labels),
                 _fp64(variables, x, labels)):
        np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
        for k, v in got.items():
            _close_to_max(v, want["grads"][k], 1e-4, k)


def test_perturbed_resnet50_gradients_track_fp64_jax_grad(r50):
    """With every block computing (perturbed BatchNorms), fp32 gradients
    of ResNet-50 at B 2 are ill-conditioned — flax's own fp32 gradients
    sit up to 0.04 (relative L2 of a tensor) from its fp64 ones here — so
    each port gradient is held to flax's fp64 gradient within a relative
    L2 error of 0.02, and the loss within 1e-5."""
    variables = r50[1]
    x, labels = _images(B, S, seed=4), np.array([3, 997])
    want = _fp64(variables, x, labels)
    loss, got = _port_grads(_port(variables), x, labels)
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    for k, v in got.items():
        w = want["grads"][k]
        err = np.linalg.norm(v - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 0.02, f"{k}: relative L2 {err}"


def test_bf16_bottleneck_block_matches_flax():
    """One bf16 BottleneckBlock, stride 2 on 16 x 16 (the (0, 1) SAME
    padding of its 3x3) with its projection, train=True, perturbed
    BatchNorms, against flax's bf16 block: the output within 2 bf16 ulps
    of max(1, |ref|) — both sides round each convolution's fp32 sum and
    each normalised value once, so an ulp flipped early moves a few
    outputs by an ulp or two — and the running statistics (fp32, from the
    bf16 convolution outputs) within 1e-3 of their largest."""
    jblock = JaxBottleneck(filters=32, strides=2, dtype=jnp.bfloat16)
    x = _images(2, 16, seed=5)
    x = np.concatenate([x] * 22, axis=-1)[..., :64]       # [2, 16, 16, 64]
    variables = jax.device_get(_perturb(
        jblock.init(jax.random.key(1), jnp.asarray(x), train=False), 6))
    want, upd = jblock.apply(variables, jnp.asarray(x, jnp.bfloat16),
                             train=True, mutable=["batch_stats"])
    block = BottleneckBlock(64, 32, 2, torch.bfloat16)
    state = {}
    for j in range(4):
        state[f"convs.{j}.weight"] = torch.from_numpy(np.asarray(
            variables["params"][f"Conv_{j}"]["kernel"]).transpose(3, 2, 0, 1)
            .copy())
        for coll, leaves in (("params", ("scale", "bias")),
                             ("batch_stats", ("mean", "var"))):
            for leaf in leaves:
                state[f"norms.{j}.{leaf}"] = torch.from_numpy(np.asarray(
                    variables[coll][f"BatchNorm_{j}"][leaf]).copy())
    block.load_state_dict(state)
    tx = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = block(tx, True).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == (2, 8, 8, 128)
    ref = np.asarray(want, np.float32)
    d = np.abs(got - ref)
    assert (d <= 2 * 2.0 ** -7 * np.maximum(1.0, np.abs(ref))).all(), \
        float(d.max())
    for j in range(4):
        for leaf in ("mean", "var"):
            _close_to_max(getattr(block.norms[j], leaf).numpy(),
                          upd["batch_stats"][f"BatchNorm_{j}"][leaf], 1e-3,
                          f"BatchNorm_{j}.{leaf}")
