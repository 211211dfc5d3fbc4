"""Port parity: softmax_cross_entropy.

The port's ``ops/losses.py`` against the JAX package's on the same
numpy-seeded logits and targets, at tests/test_losses.py's tolerances:
loss rtol 1e-6; fp32 grads atol 1e-6 / rtol 1e-5; bf16 grads (emitted in
bf16 by both) atol 2e-3 / rtol 2e-2.  Each case runs once in a single
chunk and once cut into chunks of a few rows, which must change nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops.losses import softmax_cross_entropy as jax_xent
from horovod_tpu_torch.ops import losses
from horovod_tpu_torch.ops.losses import softmax_cross_entropy

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2e-3, 2e-2)}


def _data(dtype, seed, B=2, S=16, V=97):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V)) * 3.0).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    where = rng.random((B, S)) < 0.7
    jdt, tdt = _DT[dtype]
    return ((jnp.asarray(logits, jdt), jnp.asarray(targets),
             jnp.asarray(where)),
            (torch.from_numpy(logits).to(tdt),
             torch.from_numpy(targets).long(), torch.from_numpy(where)))


@pytest.fixture(params=["one_chunk", "chunks_of_3_rows"])
def chunking(request, monkeypatch):
    if request.param == "chunks_of_3_rows":
        monkeypatch.setattr(losses, "CHUNK_ELEMENTS", 3 * 97)
    return request.param


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked,reduction", [(False, "mean"),
                                              (True, "mean"),
                                              (False, "sum"),
                                              (True, "sum")])
def test_loss_and_grads_match_jax(dtype, masked, reduction, chunking):
    seed = 4 * (dtype == "bfloat16") + 2 * masked + (reduction == "sum")
    (jl, jt, jw), (tl, tt, tw) = _data(dtype, seed=seed)
    jwhere = jw if masked else None
    twhere = tw if masked else None

    def jloss(logits):
        return jax_xent(logits, jt, where=jwhere, reduction=reduction)

    want = jloss(jl)
    g_want = jax.grad(jloss)(jl)
    x = tl.clone().requires_grad_(True)
    got = softmax_cross_entropy(x, tt, where=twhere, reduction=reduction)
    got.backward()

    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert x.grad.dtype == _DT[dtype][1]          # cotangent in logits dtype
    atol, rtol = GRAD_TOL[dtype]
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(g_want, np.float32), atol=atol,
                               rtol=rtol)


def test_all_masked_returns_zero_and_bad_reduction_raises():
    _, (tl, tt, tw) = _data("float32", seed=4)
    assert float(softmax_cross_entropy(tl, tt,
                                       where=torch.zeros_like(tw))) == 0.0
    with pytest.raises(ValueError, match="reduction"):
        softmax_cross_entropy(tl, tt, reduction="nope")
