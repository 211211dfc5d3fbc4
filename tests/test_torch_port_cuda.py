"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips with a reason where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so on a GPU machine
without JAX it runs on its own::

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import generation
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, *, B, Hkv, G, D, BS, maxb, seed):
    """Random pools, distinct live blocks per row, block-edge positions and
    a trailing padded row (pos 0, all-trash table)."""
    rng = np.random.default_rng(seed)
    nb = B * maxb + 1
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D),
                                             np.float32))
    pk = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    pv = torch.from_numpy(rng.standard_normal((nb, BS, Hkv, D), np.float32))
    edges = [0, BS - 1, BS, maxb * BS - 1, 3 * BS // 2, 2 * BS + 1]
    pos = np.zeros((B,), np.int32)
    tables = np.zeros((B, maxb), np.int32)
    for i in range(B - 1):
        pos[i] = edges[i % len(edges)]
        live = pos[i] // BS + 1
        tables[i, :live] = rng.permutation(np.arange(1, nb))[:live]
    return ([t.to(dev, dtype) for t in (q, pk, pv)]
            + [torch.from_numpy(a).to(dev) for a in (tables, pos)])


def _agree(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    else:   # 2 bf16 ULPs of max(1, |ref|)
        assert bool(((got - ref).abs()
                     <= 2.0 ** -7 * ref.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype,Hkv,G,D,BS", [
    (torch.float32, 2, 2, 16, 16),
    (torch.bfloat16, 8, 4, 128, 16),
    (torch.float32, 3, 1, 64, 8),
    (torch.bfloat16, 1, 32, 256, 32),     # > 48 KiB of shared memory
])
def test_kernel_matches_plain_version(dev, dtype, Hkv, G, D, BS):
    args = _case(dev, dtype, B=7, Hkv=Hkv, G=G, D=D, BS=BS, maxb=8,
                 seed=D + G)
    before = pa.launches
    got = pa.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    _agree(got, pa._decode_blockwise(*args), dtype)


def test_kernel_rejects_what_it_cannot_run(dev):
    q, pk, pv, tables, pos = _case(dev, torch.float32, B=2, Hkv=2, G=2,
                                   D=16, BS=16, maxb=4, seed=0)
    with pytest.raises(TypeError):
        pa.paged_attention_decode(q.half(), pk.half(), pv.half(), tables,
                                  pos)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_decode(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), pk, pv, tables, pos)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention_decode(q[..., :8].contiguous(),
                                  pk[..., :8].contiguous(),
                                  pv[..., :8].contiguous(), tables, pos)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_decode(q, pk, pv, tables.long(), pos)


def test_fused_decode_step_tracks_oracle_on_the_card(dev):
    """The whole decode step through the kernel against the gather
    oracle, bf16 tiny model: logits within 4 bf16 ULPs at logit scale."""
    cfg = LlamaConfig.tiny()
    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev))
    shape = (cfg.num_layers, 17, 4, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    pv = torch.zeros_like(pk)
    prompt = torch.arange(1, 10, device=dev)[None]
    table = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32,
                         device=dev)
    logits, _, _ = generation.paged_prefill(model, torch.cat(
        [prompt, prompt.new_zeros((1, 3))], 1), pk, pv, table,
        prompt_len=9, cache_len=32)
    tok = logits.argmax(-1)
    tables = table[None].clone()
    pos = torch.tensor([9], dtype=torch.int32, device=dev)
    before = pa.launches
    lf, _, _ = generation.paged_decode_step(model, tok, pk, pv, tables, pos,
                                            fused=True)
    assert pa.launches == before + cfg.num_layers
    lo, _, _ = generation.paged_decode_step(model, tok, pk, pv, tables, pos)
    assert float((lf.float() - lo.float()).abs().max()) < 0.125
