"""Port parity: the MNIST and skip-gram models, their initializers, the
examples' synthetic data and the optimizers the examples step with.

* ``MnistConvNet``/``MnistMLP`` (``horovod_tpu_torch/models/mnist.py``)
  against the flax modules on the same weights (``models/convert.py``
  both ways): logits, and the gradients of ``sum(logits · W)`` against
  ``jax.grad``.  fp32: each tensor within 1e-5 of its largest element.
  bf16: logits within 2^-7 of their largest (one bf16 ulp at that
  scale), kernel gradients within 1e-2 of their largest; the bias
  gradients of the bf16 layers within 0.1 of their largest, because
  they are sums over every output position that XLA's CPU reduces in
  bf16 where torch accumulates in fp32 (measured: 5.3 % on ``Conv_0``,
  3136 positions; the kernels' gradients agree to 0.07 %);
* ``SkipGramModel``'s logits and ``nce_loss`` with its gradients against
  the JAX functions, within 1e-6;
* the initializers' laws against the flax ones;
* ``examples/common.py``'s synthetic data and sharding, bitwise;
* SGD with momentum, with nesterov, and Adagrad against optax over 6
  steps from the same parameters and gradients.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from examples import common as ref_common
from horovod_tpu.models import MnistConvNet as JaxConvNet
from horovod_tpu.models import MnistMLP as JaxMLP
from horovod_tpu.models import SkipGramModel as JaxSkipGram
from horovod_tpu.models import nce_loss as jax_nce_loss
from horovod_tpu_torch.examples import common as port_common
from horovod_tpu_torch.examples.jax_word2vec import adagrad
from horovod_tpu_torch.models import (MnistConvNet, MnistMLP, SkipGramModel,
                                      nce_loss)
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.mnist import MnistConfig
from horovod_tpu_torch.models.word2vec import SkipGramConfig

B = 4
_MODELS = {"conv": (JaxConvNet, MnistConvNet), "mlp": (JaxMLP, MnistMLP)}
_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _within(got, want, rel, name=""):
    """max |got - want| <= rel · max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top, f"{name}: max |d| {err} vs {rel} x {top}"


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", sorted(_MODELS))
def test_mnist_logits_and_gradients_match_flax(kind, dtype):
    jax_cls, port_cls = _MODELS[kind]
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 28, 28, 1)).astype(np.float32)
    w = rng.standard_normal((B, 10)).astype(np.float32)
    jm = jax_cls(dtype=jdt)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    want_grads = jax.grad(lambda v: jnp.sum(
        jm.apply(v, jnp.asarray(x)) * w))(variables)

    cfg = MnistConfig(kind, dtype=tdt)
    model = port_cls.from_state_dict(
        params_from_jax(jax.device_get(variables), cfg, "cpu"), dtype=tdt)
    assert model.config == cfg
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    (got * torch.from_numpy(w)).sum().backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()},
                          cfg)
    bf16 = dtype == "bf16"
    _within(got.detach().numpy(), want, 2 ** -7 if bf16 else 1e-5, "logits")
    got_g, want_g = _leaves(grads), _leaves(want_grads)
    assert sorted(got_g) == sorted(want_g)
    for path, g in want_g.items():
        last_layer = "Dense_1" in path
        rel = 1e-5 if not bf16 else (
            0.1 if path.endswith("['bias']") and not last_layer else 1e-2)
        _within(got_g[path], g, rel, path)


def test_mnist_params_round_trip_and_flatten_order():
    """``convert`` both ways is the identity on flax's tree, and the first
    Dense's input columns are flax's kernel rows in their (H, W, C)
    order."""
    jm = JaxConvNet(dtype=jnp.float32)
    variables = jax.device_get(jm.init(jax.random.key(1),
                                       jnp.zeros((1, 28, 28, 1))))
    cfg = MnistConfig("conv", dtype=torch.float32)
    state = params_from_jax(variables, cfg, "cpu")
    back = params_to_jax(state, cfg)
    want = _leaves(variables["params"])
    for path, v in _leaves(back["params"]).items():
        np.testing.assert_array_equal(v, want[path], err_msg=path)
    model = MnistConvNet.from_state_dict(state, dtype=torch.float32)
    # Row (h, w, c) = (1, 2, 3) of the [3136, 512] kernel.
    row = (1 * 7 + 2) * 64 + 3
    np.testing.assert_array_equal(
        model.dense_0.weight[:, row].detach().numpy(),
        np.asarray(variables["params"]["Dense_0"]["kernel"])[row])


def test_mnist_mlp_hidden_and_classes():
    model = MnistMLP(num_classes=7, hidden=24, dtype=torch.float32,
                     device="cpu")
    assert model.dense_0.weight.shape == (24, 784)
    assert model(torch.zeros(3, 28, 28, 1)).shape == (3, 7)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_skipgram_logits_and_nce_loss_match_jax():
    """``paired_logits``, ``candidate_logits``, ``nce_loss`` and its
    gradients (dense, only looked-up rows non-zero) within 1e-6."""
    V, E, K = 50, 16, 5
    rng = np.random.default_rng(0)
    c, lab = rng.integers(0, V, B), rng.integers(0, V, B)
    neg = rng.integers(0, V, (B, K))
    jm = JaxSkipGram(vocab_size=V, embedding_size=E)
    variables = jm.init(jax.random.key(0), jnp.zeros((2,), jnp.int32))
    ids = [jnp.asarray(a) for a in (c, lab, neg)]
    want_loss, want_grads = jax.value_and_grad(
        lambda v: jax_nce_loss(jm, v, *ids))(variables)
    emb = jm.apply(variables, ids[0])
    want_pos = jm.apply(variables, emb, ids[1],
                        method=JaxSkipGram.paired_logits)
    want_neg = jm.apply(variables, emb, ids[2],
                        method=JaxSkipGram.candidate_logits)

    cfg = SkipGramConfig(V, E)
    model = SkipGramModel.from_state_dict(
        params_from_jax(jax.device_get(variables), cfg, "cpu"),
        vocab_size=V, embedding_size=E)
    t = [torch.from_numpy(a).long() for a in (c, lab, neg)]
    got_emb = model(t[0])
    np.testing.assert_allclose(
        model.paired_logits(got_emb, t[1]).detach().numpy(),
        np.asarray(want_pos), atol=1e-6)
    np.testing.assert_allclose(
        model.candidate_logits(got_emb, t[2]).detach().numpy(),
        np.asarray(want_neg), atol=1e-6)
    loss = nce_loss(model, *t)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    for name, p in model.named_parameters():
        assert p.grad.layout == torch.strided and p.grad.shape == p.shape
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(want_grads["params"][name]),
            atol=1e-6, err_msg=name)
    # Dense, with the looked-up rows alone non-zero.
    rows = model.embeddings.grad.abs().sum(-1).nonzero().flatten()
    assert set(rows.tolist()) == set(c.tolist())


def test_skipgram_init_laws():
    """``embeddings`` uniform on [-1, 1) (mean 0, std 1/sqrt(3)),
    ``nce_weights`` within ±2·stddev with the std of a standard normal
    truncated to ±2 (0.8796) times stddev = 1/sqrt(E) — flax's
    ``truncated_normal`` has no variance correction — and ``nce_biases``
    zeros; the same laws as flax's draws, each moment within 4 standard
    errors of its law on 2^18 samples."""
    V, E = 2048, 128
    stddev = 1 / math.sqrt(E)
    state = init_params(SkipGramConfig(V, E), 3, "cpu")
    jax_state = jax.device_get(JaxSkipGram(vocab_size=V, embedding_size=E)
                               .init(jax.random.key(3),
                                     jnp.zeros((2,), jnp.int32)))["params"]
    n = V * E
    trunc_std = 0.87962566103423978
    for emb in (state["embeddings"].numpy(),
                np.asarray(jax_state["embeddings"])):
        assert emb.min() >= -1.0 and emb.max() < 1.0
        assert abs(emb.mean()) < 4 * (1 / math.sqrt(3)) / math.sqrt(n)
        assert abs(emb.std() - 1 / math.sqrt(3)) < 4 * 0.3 / math.sqrt(n)
    for w in (state["nce_weights"].numpy(),
              np.asarray(jax_state["nce_weights"])):
        assert np.abs(w).max() <= 2 * stddev * (1 + 1e-6)
        assert abs(w.mean()) < 4 * stddev / math.sqrt(n)
        assert abs(w.std() / stddev - trunc_std) < 4 * 0.6 / math.sqrt(n)
    assert not state["nce_biases"].any()
    # A generator draws what its seed draws.
    gen = torch.Generator().manual_seed(3)
    for k, v in init_params(SkipGramConfig(V, E), gen, "cpu").items():
        assert torch.equal(v, state[k]), k


def test_mnist_init_laws():
    """Kernels from ``lecun_normal`` (std 1/sqrt(fan_in), |w| <= 2 of
    those after the truncation's rescale), biases zero; a generator and
    its seed give the same weights."""
    state = init_params(MnistConfig("conv"), 5, "cpu")
    for name, fan_in in (("conv_0", 25), ("conv_1", 800),
                         ("dense_0", 3136), ("dense_1", 512)):
        w = state[name + ".weight"].numpy()
        std = 1 / math.sqrt(fan_in)
        assert abs(w.std() / std - 1) < 0.1, name
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert not state[name + ".bias"].any()
    model = MnistConvNet(generator=torch.Generator().manual_seed(5),
                         device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("n,seed", [(64, 0), (300, 7)])
def test_synthetic_data_is_the_reference_bitwise(n, seed):
    for name in ("synthetic_mnist",):
        got = getattr(port_common, name)(n, seed)
        want = getattr(ref_common, name)(n, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    got = port_common.synthetic_imagenet(n // 8, 16, 10, seed)
    want = ref_common.synthetic_imagenet(n // 8, 16, 10, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for size in (1, 2, 3):
        for r in range(size):
            for g, w in zip(port_common.shard_for_rank(got, r, size),
                            ref_common.shard_for_rank(want, r, size)):
                assert np.array_equal(g, w)


#: (optax transformation, torch optimizer, bound on max |Δparam| over the
#: largest |param - param0| reached).  SGD and nesterov are the same
#: arithmetic (optax's trace is torch's momentum_buffer): fp32 rounding
#: only (measured: up to 1.2e-7), held to 1e-5.  Adagrad: torch divides
#: by sqrt(acc) + eps, optax multiplies by rsqrt(acc + eps); with acc >=
#: 0.1 each step differs by at most 1.9e-7 of itself, 1.2e-6 over 6
#: steps, plus the rounding: 2e-6 (measured: up to 3.2e-7).
_OPTIMIZERS = {
    "sgd_momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                     lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
                     1e-5),
    "nesterov": (lambda: optax.sgd(0.05, momentum=0.9, nesterov=True),
                 lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9,
                                           nesterov=True), 1e-5),
    "adagrad": (lambda: optax.adagrad(0.2), lambda p: adagrad(p, 0.2),
                2e-6),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_trajectory_matches_optax(name):
    make_tx, make_opt, rel = _OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    shapes = [(16, 8), (8,), (3, 5, 2)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    # Elements that get no gradient in a step.
    grads[0][1][:3] = 0
    tx = make_tx()
    params = [jnp.asarray(p) for p in start]
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in start]
    opt = make_opt(tparams)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p0, want, got in zip(start, params, tparams):
        moved = float(np.abs(np.asarray(want) - p0).max())
        err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
        assert err <= rel * moved, (name, err, moved)
