"""Port: process identity, collectives, compression, master weights and
the entry points' device rule.

``common/basics.py`` reads the reference's env names in its order and
raises before ``init()``; the collectives and the cast and wire
compressors act as the reference's on a world of one; ``MasterWeights`` keeps the
bf16 params within one bf16 ulp of the JAX package's ``master_weights``
(the port copies the rounded master; the reference adds a bf16 delta)
and its masters equal the reference's in fp32; the entry points raise
without a GPU unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from horovod_tpu.ops.mixed_precision import master_weights
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.convert import init_params, params_from_jax
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.mixed_precision import MasterWeights

_ENV = (basics._RANK_ENV + basics._SIZE_ENV + basics._LOCAL_RANK_ENV
        + basics._LOCAL_SIZE_ENV + ("HOROVOD_COORDINATOR",))


@pytest.fixture
def clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    hvd.shutdown()


def test_identity_from_env_and_queries_before_init(clean_env):
    for query in (hvd.rank, hvd.size, hvd.local_rank, hvd.local_size):
        with pytest.raises(ValueError, match="not been initialized"):
            query()
    clean_env.setenv("OMPI_COMM_WORLD_RANK", "0")
    with pytest.raises(ValueError, match="half-specified"):
        hvd.init(device="cpu")
    clean_env.setenv("PMI_SIZE", "1")
    clean_env.setenv("HOROVOD_LOCAL_SIZE", "1")
    hvd.init(device="cpu")
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) == \
        (0, 1, 0, 1)
    assert hvd.is_initialized() and hvd.device() == torch.device("cpu")
    assert torch.distributed.get_backend() == "gloo"
    hvd.shutdown()
    assert not hvd.is_initialized()


def test_collectives_and_compression_on_one_rank(clean_env):
    hvd.init(device="cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product):
        out = hvd.allreduce(x, op=op)
        assert torch.equal(out, x) and out is not x
    assert torch.equal(hvd.allreduce(x, average=False), x)
    for comp, wire in ((Compression.fp16, torch.float16),
                       (Compression.bf16, torch.bfloat16)):
        t, ctx = comp.compress(x)
        assert t.dtype == wire and comp.decompress(t, ctx).dtype == x.dtype
        assert hvd.allreduce(x, compression=comp).dtype == torch.float32
    outs = hvd.grouped_allreduce([x, x.double(), x[0]])
    assert [o.dtype for o in outs] == [torch.float32, torch.float64,
                                       torch.float32]
    assert torch.equal(hvd.broadcast(x, 0), x)
    # The wire compressors ask the engine for a wire format; at size 1
    # they are identities, as in the reference.  Top-k needs the sparse
    # plane, which is not ported.
    for comp in (Compression.wire_int8, Compression.wire_bf16):
        out = hvd.allreduce(x, compression=comp)
        assert torch.equal(out, x) and out is not x
    with pytest.raises(NotImplementedError, match="runtime/sparse.py"):
        Compression.topk(0.01)


def test_unported_options_raise():
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    for kw in (dict(sharded=True), dict(fsdp=True),
               dict(local_sgd_steps=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            hvd.DistributedOptimizer(opt, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaModel(LlamaConfig.tiny(num_experts=4), device="meta")
    # The RMSNorm kernels are ported: the fused model builds.
    fused = LlamaModel(dataclasses.replace(LlamaConfig.tiny(),
                                           fused_rmsnorm=True), device="meta")
    assert fused.norm_f.fused and fused.layers[0].norm_attn.fused


def test_master_weights_track_the_reference_within_one_bf16_ulp():
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 8)).astype(np.float32)
    grads = [rng.standard_normal((16, 8)).astype(np.float32) * 1e-2
             for _ in range(4)]
    jopt = master_weights(optax.adamw(1e-2))
    jp = {"w": jnp.asarray(w0, jnp.bfloat16)}
    js = jopt.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    opt = MasterWeights([p], torch.optim.AdamW, lr=1e-2,
                        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    assert opt.masters[0].dtype == torch.float32
    for g in grads:
        upd, js = jopt.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g).to(torch.bfloat16)
        opt.step()
        opt.zero_grad()
        assert p.grad is None and p.dtype == torch.bfloat16
        want = np.asarray(jp["w"], np.float32)
        got = p.detach().float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
        # fp32 masters: the two AdamW formulas order their terms
        # differently (decay before or inside the update), a few fp32 ulps.
        np.testing.assert_allclose(opt.masters[0].detach().numpy(),
                                   np.asarray(js.master["w"]), rtol=1e-6,
                                   atol=1e-6)


def test_entry_points_raise_without_gpu_unless_asked_for_cpu(clean_env):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the entry points take it")
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"params": {}}, cfg)
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, "cpu"))
    # The step takes hvd.init()'s device: before init it raises, and
    # init raises without a GPU unless asked for the CPU.
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.make_train_step(model, lambda m, b: m(b).sum(),
                            torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    step = hvd.make_train_step(model, lambda m, b: m(b).float().mean(),
                               torch.optim.SGD(model.parameters(), lr=0.1))
    assert torch.isfinite(step(torch.zeros((1, 4), dtype=torch.long)))
