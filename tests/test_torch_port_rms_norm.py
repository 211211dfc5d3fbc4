"""Port parity: the fused RMSNorm, forward and backward.

The port's ``ops/rms_norm.py`` (its plain versions: the tensors lie on the
CPU) against the JAX package's ``rms_norm(..., use_kernel=True)``, whose
Pallas kernels run in interpret mode as the JAX package's own tests run
them on the CPU.  The same numpy-seeded inputs go to both; the
tolerances are tests/test_rms_norm.py's: forward 1e-6, bf16 out 2e-2,
x and scale gradients 1e-5, the multi-block dscale 1e-4, the off-tile
fallback 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops.rms_norm import rms_norm as jax_rms_norm
from horovod_tpu_torch.ops import rms_norm as trn


def _data(shape, dtype="float32", seed=0):
    """(jax x, jax scale, torch x, torch scale) from one numpy draw; the
    scale is fp32 around 1, as tests/test_rms_norm.py draws it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, jnp.asarray(scale), tx, torch.from_numpy(scale)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", [(4, 64, 256), (2, 3, 8, 128)])
def test_forward_matches_jax(shape):
    """Forward at 1e-6, for a 3-D and a 4-D input (the port flattens the
    leading dims as the reference does)."""
    jx, js, tx, ts = _data(shape, seed=len(shape))
    want = jax_rms_norm(jx, js, use_kernel=True)
    trn.reset_launches()
    got = trn.rms_norm(tx, ts)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    assert trn.plain_calls["rms_fwd"] == 1 and trn.launches["rms_fwd"] == 0


def test_forward_bf16_out():
    jx, js, tx, ts = _data((4, 64, 256), "bfloat16", seed=1)
    want = jax_rms_norm(jx, js, use_kernel=True)
    got = trn.rms_norm(tx, ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape,seed", [((2, 16, 128), 2), ((24, 128), 5)])
def test_gradients_match_jax(shape, seed):
    jx, js, tx, ts = _data(shape, seed=seed)

    def loss(x, s):
        return jnp.sum(jax_rms_norm(x, s, use_kernel=True) ** 2)

    gx, gs = jax.grad(loss, argnums=(0, 1))(jx, js)
    x, s = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    trn.reset_launches()
    (trn.rms_norm(x, s) ** 2).sum().backward()
    assert trn.plain_calls == {"rms_fwd": 1, "rms_bwd": 1}
    assert x.grad.dtype == torch.float32 and s.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(x.grad), _np(gx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(s.grad), _np(gs), atol=1e-5, rtol=1e-5)


def test_multi_rowblock_dscale():
    """512 rows: two of the reference's 256-row blocks, 128 of the port's
    4-row blocks (block_rows(512) = 4): every partial must be summed."""
    jx, js, tx, ts = _data((512, 128), seed=3)
    gs = jax.grad(lambda s: jnp.sum(
        jax_rms_norm(jx, s, use_kernel=True) ** 2))(js)
    s = ts.clone().requires_grad_(True)
    (trn.rms_norm(tx, s) ** 2).sum().backward()
    assert trn.block_rows(512) == 4
    np.testing.assert_allclose(_np(s.grad), _np(gs), atol=1e-4, rtol=1e-5)


def test_off_tile_h_against_the_reference_fallback():
    """H 100 (off the reference's 128 tile): the reference takes its plain
    XLA math; the port's kernels take any H, so its plain version runs."""
    jx, js, tx, ts = _data((3, 7, 100), seed=4)
    want = jax_rms_norm(jx, js, use_kernel=True)
    trn.reset_launches()
    got = trn.rms_norm(tx, ts)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    assert trn.plain_calls["rms_fwd"] == 1


def test_plain_backward_partials_follow_the_row_blocks():
    """The plain backward writes one partial per block of block_rows(R)
    rows, in block order, and their sum is dscale; dx comes back in x's
    dtype (bf16 here), dscale in the scale's."""
    rng = np.random.default_rng(6)
    R, H = 1000, 40
    x = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    y, rstd = trn._fwd_rows(x, scale, 1e-5, torch.float32)
    dx, parts = trn._bwd_rows(x, scale, rstd, dy)
    rows = trn.block_rows(R)
    assert rows == 8 and parts.shape == (125, H)
    xhat = x * rstd[:, None]
    torch.testing.assert_close(parts[7], (dy * xhat)[56:64].sum(0))
    torch.testing.assert_close(parts.sum(0), (dy * xhat).sum(0), rtol=1e-5,
                               atol=1e-5)
    xb = x.to(torch.bfloat16).requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    trn.rms_norm(xb, s, out_dtype=torch.float32).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and s.grad.dtype == torch.float32
    with pytest.raises(ValueError, match="does not match"):
        trn.rms_norm(x, scale[:-1])


@pytest.mark.parametrize("R", [1, 100, 131, 132, 133, 264, 4096, 10000])
def test_backward_blocks_are_at_most_one_per_sm(R):
    """The backward's row blocks: contiguous, covering every row, at most
    TARGET_BLOCKS (one per SM of an H100) of them, the last one ragged;
    the plain backward writes one partial per block, and each is its
    block's Σ dy·x̂."""
    rng = np.random.default_rng(R)
    H = 16
    x = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    rows = trn.block_rows(R)
    n_blocks = -(-R // rows)
    assert trn.TARGET_BLOCKS == 132
    assert n_blocks <= trn.TARGET_BLOCKS and (n_blocks - 1) * rows < R
    assert rows == 1 or (rows - 1) * trn.TARGET_BLOCKS < R
    _, rstd = trn._fwd_rows(x, scale, 1e-5, torch.float32)
    dx, parts = trn._bwd_rows(x, scale, rstd, dy)
    assert parts.shape == (n_blocks, H)
    xhat = x * rstd[:, None]
    last = (n_blocks - 1) * rows
    torch.testing.assert_close(parts[-1], (dy * xhat)[last:].sum(0))
    torch.testing.assert_close(parts[0], (dy * xhat)[:rows].sum(0))
