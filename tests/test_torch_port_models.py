"""Port parity: the Llama model and its KV-cache generation paths.

The port's ``LlamaModel`` and ``models/generation.py`` against the JAX
package on ``LlamaConfig.tiny()``, with the flax weights carried across
by ``params_from_jax``.  fp32: logits within 1e-5 (only the summation
order of the matmuls differs).  bf16: within FUSED_LOGIT_TOL (4 bf16
ULPs at logit scale, the reference's fused-vs-oracle contract), and the
argmax agrees wherever the reference's top-2 margin exceeds that bound.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
from horovod_tpu.models import LlamaModel as JaxLlamaModel
from horovod_tpu.models import generation as jgen
from horovod_tpu_torch.models import generation as tgen
from horovod_tpu_torch.models.convert import init_params, params_from_jax
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.serve.kv_cache import PagedKVCache

FP32_ATOL = 1e-5
FUSED_LOGIT_TOL = 0.125

BS = 4
MAXB = 8
NB = 32
CACHE = MAXB * BS

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    """(jax cfg, jax variables, port model) on identical weights."""
    jdt, tdt = _DT[dtype]
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jdt,
                               logits_dtype=jdt)
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=tdt,
                               logits_dtype=tdt)
    ids = jnp.zeros((1, 8), jnp.int32)
    variables = JaxLlamaModel(jcfg).init(jax.random.key(1), ids)
    model = LlamaModel.from_state_dict(tcfg, params_from_jax(variables,
                                                             tcfg, "cpu"))
    return jcfg, variables, model


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _close(ref, got, dtype, logits=True):
    """fp32: within FP32_ATOL.  bf16: within FUSED_LOGIT_TOL and, for
    logits, the same argmax wherever the reference's top-2 margin exceeds
    the tolerance."""
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=FP32_ATOL)
        return
    assert np.max(np.abs(ref - got)) < FUSED_LOGIT_TOL
    if not logits:
        return
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > FUSED_LOGIT_TOL
    assert (np.argmax(ref, -1) == np.argmax(got, -1))[decided].all()


def test_llama_logits_match_flax():
    jcfg, variables, model = _models("float32")
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 11))
    ref = JaxLlamaModel(jcfg).apply(variables, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(_t(ids).long())
    assert got.dtype == torch.float32
    _close(ref, got.numpy(), "float32")


def test_llama_logits_bf16_within_contract():
    jcfg, variables, model = _models("bfloat16")
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    ref = JaxLlamaModel(jcfg).apply(variables, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(_t(ids).long())
    assert got.dtype == torch.bfloat16
    _close(ref, got.float().numpy(), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_jax(dtype):
    jcfg, variables, model = _models(dtype)
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 7))
    jl, jcache = jgen.prefill(jcfg, variables, jnp.asarray(ids, jnp.int32),
                              cache_len=16)
    tl, tcache = tgen.prefill(model, _t(ids).long(), cache_len=16)
    _close(jl, tl.float().numpy(), dtype)
    tok = np.argmax(_np(jl), -1)
    for i in range(4):
        pos = 7 + i
        jl, jcache = jgen.decode_step(jcfg, variables,
                                      jnp.asarray(tok, jnp.int32), jcache,
                                      pos=pos)
        tl, tcache = tgen.decode_step(model, _t(tok).long(), tcache, pos=pos)
        _close(jl, tl.float().numpy(), dtype)
        tok = np.argmax(_np(jl), -1)


def test_generate_matches_jax_jit_generate():
    jcfg, variables, model = _models("float32")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 5))
    fn = jax.jit(functools.partial(jgen.generate, jcfg, max_new_tokens=6,
                                   cache_len=CACHE))
    ref = np.asarray(fn(variables, jnp.asarray(ids, jnp.int32)))
    got = tgen.generate(model, _t(ids).long(), max_new_tokens=6,
                        cache_len=CACHE)
    np.testing.assert_array_equal(got.numpy(), ref)
    gen = torch.Generator().manual_seed(0)
    sampled = tgen.generate(model, _t(ids).long(), max_new_tokens=6,
                            temperature=0.8, generator=gen)
    assert sampled.shape == (2, 6)
    with pytest.raises(ValueError, match="Generator"):
        tgen.generate(model, _t(ids).long(), max_new_tokens=2,
                      temperature=0.8)


def _pools(cfg, framework, dtype):
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    if framework == "jax":
        return jnp.zeros(shape, _DT[dtype][0]), jnp.zeros(shape,
                                                          _DT[dtype][0])
    return (torch.zeros(shape, dtype=_DT[dtype][1]),
            torch.zeros(shape, dtype=_DT[dtype][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_paths_match_jax(dtype):
    """paged_prefill (cold and start_blk>0), paged_prefill_suffix and
    paged_decode_step (gather oracle and fused, with a padded trash row)
    against their JAX counterparts on the same tables."""
    jcfg, variables, model = _models(dtype)
    rng = np.random.default_rng(4)
    kv = PagedKVCache(NB, BS, MAXB, prefix_cache=True)
    s0 = 7
    prompt = rng.integers(0, jcfg.vocab_size, s0).tolist()
    assert kv.allocate_prefix(1, prompt) == 0
    kv.register_prefix(1, prompt)
    table = kv.table_array(1, MAXB)
    pad = np.zeros((1, 8), np.int32)
    pad[0, :s0] = prompt
    jk, jv = _pools(jcfg, "jax", dtype)
    tk, tv = _pools(jcfg, "torch", dtype)
    jl, jk, jv = jgen.paged_prefill(jcfg, variables, jnp.asarray(pad), jk,
                                    jv, jnp.asarray(table), prompt_len=s0,
                                    cache_len=CACHE)
    tl, tk, tv = tgen.paged_prefill(model, _t(pad).long(), tk, tv,
                                    _t(table), prompt_len=s0,
                                    cache_len=CACHE)
    _close(jl, tl.float().numpy(), dtype)
    _close(jk, tk.float().numpy(), dtype, logits=False)

    # A second prompt sharing the first block: both hit paths.
    prompt2 = prompt[:4] + rng.integers(0, jcfg.vocab_size, 6).tolist()
    assert kv.allocate_prefix(2, prompt2) == 1
    table2 = kv.table_array(2, MAXB)
    sfx = np.zeros((1, 8), np.int32)
    sfx[0, :6] = prompt2[4:]
    outs = {}
    for name in ("static", "suffix"):
        tk2, tv2 = tk.clone(), tv.clone()
        if name == "static":
            jl2, jk2, _ = jgen.paged_prefill(
                jcfg, variables, jnp.asarray(sfx), jk, jv,
                jnp.asarray(table2), prompt_len=10, cache_len=CACHE,
                start_blk=1)
            tl2, tk2, _ = tgen.paged_prefill(
                model, _t(sfx).long(), tk2, tv2, _t(table2), prompt_len=10,
                cache_len=CACHE, start_blk=1)
        else:
            jl2, jk2, _ = jgen.paged_prefill_suffix(
                jcfg, variables, jnp.asarray(sfx), jk, jv,
                jnp.asarray(table2), prompt_len=10, start=4,
                cache_len=CACHE)
            tl2, tk2, _ = tgen.paged_prefill_suffix(
                model, _t(sfx).long(), tk2, tv2, _t(table2), prompt_len=10,
                start=4, cache_len=CACHE)
        _close(jl2, tl2.float().numpy(), dtype)
        _close(jk2, tk2.float().numpy(), dtype, logits=False)
        outs[name] = tl2.float().numpy()
    np.testing.assert_array_equal(outs["static"], outs["suffix"])

    # Teacher-forced decode: row 0 live, row 1 a padded trash row.
    tok = int(np.argmax(_np(jl)))
    for i in range(6):                  # crosses the block edge at 8
        pos = s0 + i
        assert kv.append_slot(1, pos + 1)
        tables = np.zeros((2, MAXB), np.int32)
        tables[0] = kv.table_array(1, MAXB)
        toks = np.asarray([tok, 0], np.int32)
        ps = np.asarray([pos, 0], np.int32)
        args = (jnp.asarray(toks), jk, jv, jnp.asarray(tables),
                jnp.asarray(ps))
        lo, jk_o, jv_o = jgen.paged_decode_step(jcfg, variables, *args)
        lf, _, _ = jgen.paged_decode_step(jcfg, variables, *args, fused=True)
        # The port writes in place: the fused call first, then the oracle
        # overwrites the same slots, so decoding continues on the
        # oracle's pools as on the JAX side.
        tf, _, _ = tgen.paged_decode_step(model, _t(toks).long(), tk, tv,
                                          _t(tables), _t(ps), fused=True)
        to, tk, tv = tgen.paged_decode_step(model, _t(toks).long(), tk, tv,
                                            _t(tables), _t(ps))
        _close(lo[:1], to[:1].float().numpy(), dtype)
        _close(lf[:1], tf[:1].float().numpy(), dtype)
        assert np.isfinite(tf.float().numpy()).all()
        jk, jv = jk_o, jv_o
        tok = int(np.argmax(_np(lo)[0]))
    _close(jk, tk.float().numpy(), dtype, logits=False)


def test_init_params_distributions_and_determinism():
    cfg = LlamaConfig.tiny()
    a = init_params(cfg, 7, "cpu")
    b = init_params(cfg, 7, "cpu")
    c = init_params(cfg, 8, "cpu")
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["layers.0.attn.wq.weight"],
                           c["layers.0.attn.wq.weight"])
    emb = a["tok_emb.weight"]
    assert emb.dtype == cfg.dtype and emb.shape == (cfg.vocab_size, 64)
    assert abs(float(emb.float().std()) - 64 ** -0.5) < 0.01
    w = a["layers.0.mlp.w_down.weight"].float()        # fan_in = 128
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    # lecun_normal truncates at two (pre-scaling) standard deviations.
    assert float(w.abs().max()) <= 2 * 128 ** -0.5 / 0.8796 + 1e-3
    assert a["norm_f.scale"].dtype == torch.float32
    assert torch.equal(a["norm_f.scale"], torch.ones(64))
    assert a["lm_head.weight"].dtype == cfg.logits_dtype
    model = LlamaModel.from_state_dict(cfg, a)
    assert model(torch.zeros((1, 3), dtype=torch.long)).shape == \
        (1, 3, cfg.vocab_size)


def test_conversion_rejects_mismatch_and_moe():
    _, variables, _ = _models("float32")
    wide = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128)
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(variables, wide, "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        LlamaModel(LlamaConfig.tiny(num_experts=4))
