"""Port parity: the 1x1 convolution with BatchNorm statistics (B7).

The port's ``ops/conv_bn_stats.py`` (its plain version: the tensors lie
on the CPU) against the TPU kernel itself, ``experiments/
pallas_conv_bn_spike.py``'s ``_kernel``, run through ``pl.pallas_call``
in interpret mode with the spike's BlockSpecs, and against the spike's
``xla_conv_stats`` on the NHWC view.  The same numpy-seeded bf16 inputs
go to both.  Tolerances:

* y within one bf16 ulp of the reference's (|d| <= 2^-7 |y|): both round
  an fp32 sum of exact bf16 products once, the sums taken in other
  orders;
* Σy, Σy² (and mean, var) within 1e-5 of the sum of |terms|: fp32 sums
  of the same 2048 x 512 products in another order.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from horovod_tpu_torch.experiments import conv_bn_spike as port_spike
from horovod_tpu_torch.ops import conv_bn_stats as cbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_spike():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_bn_spike",
        os.path.join(REPO, "experiments", "pallas_conv_bn_spike.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


spike = _load_spike()


def _data(N, K, C, seed):
    """(x [N, K], w [K, C]) as bf16-valued fp32 numpy arrays, the spike's
    distributions (x standard normal, w 0.05 x standard normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, K), dtype=np.float32)
    w = 0.05 * rng.standard_normal((K, C), dtype=np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    return bf(x), bf(w)


def _torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _pallas_interpret(x, w, rows=512):
    """The TPU kernel, ``pl.pallas_call(spike._kernel)`` with the spike's
    BlockSpecs, interpreted on the CPU: (y, s1 [C], s2 [C])."""
    N, K = x.shape
    C = w.shape[1]
    y, s1, s2 = pl.pallas_call(
        spike._kernel,
        grid=(N // rows,),
        in_specs=[pl.BlockSpec((rows, K), lambda i: (i, 0)),
                  pl.BlockSpec((K, C), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((rows, C), lambda i: (i, 0)),
                   pl.BlockSpec((1, C), lambda i: (0, 0)),
                   pl.BlockSpec((1, C), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((N, C), jnp.bfloat16),
                   jax.ShapeDtypeStruct((1, C), jnp.float32),
                   jax.ShapeDtypeStruct((1, C), jnp.float32)],
        interpret=True,
    )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    return (np.asarray(y, np.float32), np.asarray(s1[0]),
            np.asarray(s2[0]))


def _assert_y(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    d = np.abs(got - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), float(d.max())


def _assert_sum(got, want, scale):
    """fp32 sums of the same terms in other orders: within 1e-5 of the
    sum of the terms' magnitudes (``scale``)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert (np.abs(got - want) <= 1e-5 * scale).all(), \
        float(np.abs(got - want).max() / scale.max())


def test_plain_matches_the_tpu_kernel_in_interpret_mode():
    """N 2048, K 512, C 128, bf16: four 512-row grid steps of the TPU
    kernel carry s1/s2 across the grid; the plain version sums them in
    one pass."""
    x, w = _data(2048, 512, 128, seed=0)
    y_p, s1_p, s2_p = _pallas_interpret(x, w)
    cbs.reset_launches()
    y, s1, s2 = cbs.conv_stats(_torch(x), _torch(w))
    assert cbs.plain_calls["conv_bn_stats"] == 1
    assert cbs.launches["conv_bn_stats"] == 0
    assert y.shape == (2048, 128) and y.dtype == torch.bfloat16
    assert s1.dtype == s2.dtype == torch.float32
    _assert_y(y, y_p)
    y32 = x.astype(np.float64) @ w.astype(np.float64)
    _assert_sum(s1, s1_p, np.abs(y32).sum(0))
    _assert_sum(s2, s2_p, (y32 * y32).sum(0))


def test_plain_matches_xla_conv_stats_on_the_nhwc_view():
    """The same rows as an NHWC batch [2, 32, 32, 512] through the spike's
    ``xla_conv_stats`` (an XLA 1x1 convolution with an fp32 result, then
    the fp32 mean and E[y²] − mean²): y, mean and var."""
    x, w = _data(2048, 512, 128, seed=1)
    y_x, m_x, v_x = spike.xla_conv_stats(
        jnp.asarray(x, jnp.bfloat16).reshape(2, 32, 32, 512),
        jnp.asarray(w, jnp.bfloat16).reshape(1, 1, 512, 128))
    y, mean, var = cbs.conv_bn_stats(_torch(x), _torch(w))
    _assert_y(y, np.asarray(y_x, np.float32).reshape(2048, 128))
    y32 = x.astype(np.float64) @ w.astype(np.float64)
    _assert_sum(mean, np.asarray(m_x), np.abs(y32).mean(0))
    _assert_sum(var, np.asarray(v_x), (y32 * y32).mean(0))


@pytest.mark.parametrize("N,K,C", [(1000, 512, 128), (333, 72, 40),
                                   (1, 8, 8), (129, 640, 136),
                                   (127, 576, 120), (128, 16, 256)])
def test_plain_at_ragged_shapes_follows_its_own_math(N, K, C):
    """Ragged N (and K, C off the kernel's 64 / 128 tiles): y is the fp64
    product rounded once to bf16 (within one ulp), Σy and Σy² its fp32
    sums, mean and var the spike's formulas."""
    x, w = _data(N, K, C, seed=N)
    y, mean, var = cbs.conv_bn_stats(_torch(x), _torch(w))
    y64 = x.astype(np.float64) @ w.astype(np.float64)
    _assert_y(y, y64)
    _assert_sum(mean * N, y64.sum(0), np.abs(y64).sum(0))
    _assert_sum((var + mean * mean) * N, (y64 * y64).sum(0),
                (y64 * y64).sum(0))


def test_the_wrapper_refuses_what_the_kernel_cannot_run():
    x, w = _data(64, 64, 16, seed=2)
    tx, tw = _torch(x), _torch(w)
    with pytest.raises(TypeError, match="bfloat16"):
        cbs.conv_stats(tx.float(), tw)
    with pytest.raises(ValueError, match="multiples of 8"):
        cbs.conv_stats(tx[:, :60], tw[:60])
    with pytest.raises(ValueError, match="multiples of 8"):
        cbs.conv_stats(tx, tw[:, :12])
    with pytest.raises(ValueError, match="shared memory"):
        cbs.conv_stats(torch.zeros((4, 1024), dtype=torch.bfloat16),
                       torch.zeros((1024, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no rows"):
        cbs.conv_stats(tx[:0], tw)
    with pytest.raises(ValueError, match=r"x \[N, K\]"):
        cbs.conv_stats(tx, tw[:32])
    assert cbs.grid_rows(200704, 128, 132) == 132
    assert cbs.grid_rows(200704, 256, 132) == 66
    assert cbs.grid_rows(1000, 128, 132) == 8


def test_spike_chain_and_entry_point():
    """The spike's chain on the CPU at a small N: REPEATS dependent steps
    of the kernel arm (here its plain version), each perturbing w by
    1e-12 · mean — below bf16's resolution at w's scale, so w keeps its
    values; the entry point raises without a GPU."""
    x, w = _data(256, 64, 16, seed=3)
    tx, tw = _torch(x), _torch(w)
    cbs.reset_launches()
    w_out, sums = port_spike.chain(
        lambda v: port_spike.kernel_conv_stats(tx, v), tw)
    assert cbs.plain_calls["conv_bn_stats"] == port_spike.REPEATS
    assert sums.shape == (port_spike.REPEATS,)
    assert torch.equal(w_out, tw)
    y, _, _ = cbs.conv_bn_stats(tx, tw)
    torch.testing.assert_close(sums, y[:, 0].float().sum().expand(
        port_spike.REPEATS))
    assert port_spike.N == 200704 and port_spike.FLOPS == \
        2.0 * 200704 * 512 * 128 * 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_spike.main(["check"])
