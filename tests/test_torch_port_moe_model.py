"""Port parity: MoE in the model (``models/llama.py`` ``MoEBlock``).

The port's ``LlamaModel(LlamaConfig.tiny(num_experts=4))`` against the
flax model on the weights ``models/convert`` carries across, fp32:

* logits within 1e-5, and every parameter's gradient of a seeded
  cotangent within 1e-5 of the gradient tensor's largest magnitude plus
  1e-5 |ref| (each gradient sums 16k fp32 products; the routed dispatch
  runs each expert over its own tokens, the reference's dense einsum over
  a masked copy of every token: the same products, summed in other
  orders);
* the tie rule: with a router of zeros every expert is equally likely,
  and both pick experts 0 and 1 (``jax.lax.top_k``'s lower index first;
  ``top_k_route`` sorts stably), and tied probabilities in general;
* the routed block against the dense masked einsum in torch (the oracle
  ``chip_smoke.py`` holds it to on the card);
* ``convert``'s round trip of the MoE layout (router transposed, the
  expert tensors in their own layout) and ``init_params``'s draws at
  flax's fan-in for the expert tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
from horovod_tpu.models import LlamaModel as JaxLlamaModel
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                            MoEBlock, top_k_route)

LOGIT_ATOL = 1e-5
GRAD_SCALE_TOL, GRAD_RTOL = 1e-5, 1e-5


def _cfgs(num_experts=4):
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(num_experts=num_experts),
                               dtype=jnp.float32, logits_dtype=jnp.float32)
    tcfg = dataclasses.replace(LlamaConfig.tiny(num_experts=num_experts),
                               dtype=torch.float32,
                               logits_dtype=torch.float32)
    return jcfg, tcfg


def _ids(seed=3, B=2, S=16):
    return np.random.default_rng(seed).integers(0, 512, (B, S))


def test_moe_logits_and_gradients_match_flax():
    jcfg, tcfg = _cfgs()
    ids = _ids()
    jmodel = JaxLlamaModel(jcfg)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(ids, jnp.int32))
    cot = np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.vocab_size)).astype(np.float32)

    def jloss(v):
        return jnp.sum(jmodel.apply(v, jnp.asarray(ids, jnp.int32))
                       * jnp.asarray(cot))
    ref_logits = np.asarray(jmodel.apply(variables,
                                         jnp.asarray(ids, jnp.int32)))
    ref_grads = params_to_jax(params_from_jax(
        jax.grad(jloss)(variables), tcfg, "cpu"), tcfg)["params"]

    model = LlamaModel.from_state_dict(tcfg, params_from_jax(variables, tcfg,
                                                             "cpu"))
    assert model.layers[0].is_moe and not hasattr(model.layers[0], "mlp")
    logits = model(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=LOGIT_ATOL)
    (logits * torch.from_numpy(cot)).sum().backward()
    got = params_to_jax({n: p.grad for n, p in model.named_parameters()},
                        tcfg)["params"]
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    got_by_path = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_ref) == len(got_by_path) == len(list(
        model.parameters()))
    for path, want in flat_ref:
        np.testing.assert_allclose(
            got_by_path[path], want, rtol=GRAD_RTOL,
            atol=GRAD_SCALE_TOL * float(np.abs(want).max()),
            err_msg=jax.tree_util.keystr(path))


def test_top_k_ties_pick_the_lower_expert_first():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32)   # many ties
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = top_k_route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_equal_router_logits_route_like_flax():
    """A router of zeros: every token's experts are 0 and 1, weights 1/2,
    in both packages; the block's outputs agree."""
    jcfg, tcfg = _cfgs()
    ids = _ids(seed=5)
    variables = JaxLlamaModel(jcfg).init(jax.random.key(2),
                                         jnp.asarray(ids, jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for i in range(jcfg.num_layers):
        params[f"layer_{i}"]["moe"]["router"]["kernel"] = np.zeros_like(
            params[f"layer_{i}"]["moe"]["router"]["kernel"])
    ref = np.asarray(JaxLlamaModel(jcfg).apply({"params": params},
                                               jnp.asarray(ids, jnp.int32)))
    model = LlamaModel.from_state_dict(tcfg, params_from_jax(params, tcfg,
                                                             "cpu"))
    x = torch.randn(2, 16, tcfg.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    combine = model.layers[0].moe.route(x)
    want = torch.zeros_like(combine)
    want[..., :2] = 0.5
    assert torch.equal(combine, want)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)


def test_routed_block_equals_the_dense_masked_einsum():
    """The routed dispatch against the reference's formula in torch (every
    expert over a masked copy of every token), output and gradients."""
    _, tcfg = _cfgs()
    moe = MoEBlock(tcfg)
    state = init_params(tcfg, 1, "cpu")
    moe.load_state_dict({k[len("layers.0.moe."):]: v for k, v in
                         state.items() if k.startswith("layers.0.moe.")})
    gen = torch.Generator().manual_seed(9)
    x0 = torch.randn(2, 16, tcfg.hidden_size, generator=gen)
    cot = torch.randn(x0.shape, generator=gen)

    def dense(x):
        combine = moe.route(x)
        xe = torch.einsum("bsh,bse->ebsh", x, (combine != 0).to(x.dtype))
        gate, up = torch.chunk(torch.einsum("ebsh,ehf->ebsf", xe,
                                            moe.w_gate_up), 2, dim=-1)
        ye = torch.einsum("ebsf,efh->ebsh", gate * torch.sigmoid(gate) * up,
                          moe.w_down)
        return torch.einsum("ebsh,bse->bsh", ye, combine)

    params = [moe.router.weight, moe.w_gate_up, moe.w_down]
    runs = []
    for fn in (moe, dense):
        x = x0.clone().requires_grad_(True)
        y = fn(x)
        runs.append([y.detach()] + list(torch.autograd.grad(
            y, [x] + params, cot)))
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_conversion_round_trip_and_init_of_the_moe_layout():
    jcfg, tcfg = _cfgs()
    variables = JaxLlamaModel(jcfg).init(jax.random.key(0),
                                         jnp.zeros((1, 8), jnp.int32))
    state = params_from_jax(variables, tcfg, "cpu")
    assert state["layers.1.moe.router.weight"].shape == (4, 64)
    assert state["layers.1.moe.router.weight"].dtype == torch.float32
    assert state["layers.1.moe.w_gate_up"].shape == (4, 64, 256)
    assert state["layers.1.moe.w_down"].shape == (4, 128, 64)
    np.testing.assert_array_equal(
        state["layers.1.moe.router.weight"].numpy(),
        np.asarray(variables["params"]["layer_1"]["moe"]["router"]
                   ["kernel"]).T)
    back = params_to_jax(state, tcfg)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_array_equal(got[path], np.asarray(want))
    # Seeded init: the same names, shapes and dtypes; the expert tensors'
    # spread is lecun_normal over flax's fan-in (in x E), as flax's own.
    seeded = init_params(dataclasses.replace(tcfg, dtype=torch.bfloat16),
                         0, "cpu")
    assert {k: tuple(v.shape) for k, v in seeded.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    assert seeded["layers.0.moe.w_gate_up"].dtype == torch.bfloat16
    assert seeded["layers.0.moe.router.weight"].dtype == torch.float32
    for name in ("w_gate_up", "w_down"):
        want = float(np.std(np.asarray(
            variables["params"]["layer_0"]["moe"][name])))
        got_std = float(seeded[f"layers.0.moe.{name}"].float().std())
        assert abs(got_std - want) < 0.05 * want, (name, got_std, want)
    assert torch.equal(init_params(tcfg, 0, "cpu")["layers.0.moe.w_down"],
                       init_params(tcfg, 0, "cpu")["layers.0.moe.w_down"])


def test_a_dense_config_keeps_its_layout():
    """``num_experts == 1``: the SwiGLU, its parameters and names as
    before; ``num_experts > 1`` adds the MoE block in its place."""
    dense = LlamaModel(LlamaConfig.tiny(), device="meta")
    moe = LlamaModel(LlamaConfig.tiny(num_experts=4), device="meta")
    dense_names = [n for n, _ in dense.named_parameters()]
    assert "layers.0.mlp.w_gate_up.weight" in dense_names
    assert not any(".moe." in n for n in dense_names)
    moe_names = [n for n, _ in moe.named_parameters()]
    assert not any(".mlp." in n for n in moe_names)
    assert [n for n in moe_names if n.startswith("layers.0.moe.")] == [
        "layers.0.moe.w_gate_up", "layers.0.moe.w_down",
        "layers.0.moe.router.weight"]


@pytest.mark.parametrize("k", [1, 2])
def test_experts_per_token_follows_the_config(k):
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, experts_per_token=k)
    moe = MoEBlock(tcfg)
    torch.nn.init.normal_(moe.router.weight)
    combine = moe.route(torch.randn(3, 5, tcfg.hidden_size))
    assert ((combine != 0).sum(-1) == k).all()
    torch.testing.assert_close(combine.sum(-1), torch.ones(3, 5))
