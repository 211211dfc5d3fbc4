"""Port parity: meshes and parameter placement.

The port's ``parallel/mesh.py`` and ``parallel/api.py`` against the JAX
package's: ``_resolve_shape`` (results and error messages),
``data_axes`` / ``mesh_axis_size``, and ``infer_param_spec`` — the port
applies the reference's rules to each of its parameters through the
reference's tree path and reverses the spec of a ``Linear`` weight
(``[out, in]`` here, ``[in, out]`` there), so every parameter of BERT-base
(and of Llama-3-8B's layout) must get the reference's mesh axis on the
same logical dimension, for meshes ``{"data": 2, "fsdp": 4}`` and
``{"data": 8}``.  FSDP2 placement on two ranks is held in
``test_torch_port_bert.py``.
"""

import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
from horovod_tpu.models import LlamaModel as JaxLlamaModel
from horovod_tpu.models.bert import BertConfig as JaxBertConfig
from horovod_tpu.models.bert import BertForPretraining as JaxBert
from horovod_tpu.parallel import api as japi
from horovod_tpu.parallel import mesh as jmesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.bert import BertConfig, BertForPretraining
from horovod_tpu_torch.models.convert import _bert_layout, _jax_path, _layout
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.parallel import api, mesh

MESHES = [{"data": 2, "fsdp": 4}, {"data": 8}]


def _reference_specs(variables, jax_mesh):
    """{reference path: spec tuple} as ``shard_params`` would place them."""
    out = {}

    def spec(path, leaf):
        key = japi._path_str(path)
        out[key] = tuple(japi.infer_param_spec(key, jnp.shape(leaf),
                                               jax_mesh))
    jax.tree_util.tree_map_with_path(spec, variables)
    return out


def _layout_pairs(layout):
    """(port name, reference path, transposed) from convert's layout —
    an independent account of the name mapping ``param_specs`` makes."""
    for name, kind, _ in layout:
        path = "params/" + "/".join(_jax_path(name, kind))
        yield name, path, kind in ("dense", "head")


@pytest.mark.parametrize("axes", MESHES, ids=["data2_fsdp4", "data8"])
@pytest.mark.parametrize("model", ["bert_base", "llama3_8b"])
def test_param_specs_match_the_reference(model, axes):
    jax_mesh = jmesh.build_mesh(axes)
    ids = jnp.zeros((1, 8), jnp.int32)
    if model == "bert_base":
        variables = jax.eval_shape(JaxBert(JaxBertConfig.base()).init,
                                   jax.random.key(0), ids, ids)
        torch_model = BertForPretraining(BertConfig.base(), device="meta")
        pairs = _layout_pairs(_bert_layout(BertConfig.base()))
    else:
        variables = jax.eval_shape(
            JaxLlamaModel(JaxLlamaConfig.llama3_8b()).init,
            jax.random.key(0), ids)
        torch_model = LlamaModel(LlamaConfig.llama3_8b(), device="meta")
        pairs = _layout_pairs(_layout(LlamaConfig.llama3_8b()))
    want = _reference_specs(variables, jax_mesh)
    got = api.param_specs(torch_model, axes)
    pairs = list(pairs)
    assert sorted(got) == sorted(name for name, _, _ in pairs)
    assert len(want) == len(pairs)
    for name, path, transposed in pairs:
        ref = want[path]
        assert got[name] == (ref[::-1] if transposed else ref), (name, path)
    if axes.get("fsdp", 1) > 1:
        # The rules do shard something on the fsdp axis.
        assert any("fsdp" in s for s in got.values())
    else:
        assert all(a is None for spec in got.values() for a in spec)


@pytest.mark.parametrize("path,shape", [
    ("params/encoder/tok_emb/embedding", (30522, 768)),
    ("params/encoder/layer_3/attention/qkv/kernel", (768, 2304)),
    ("params/layer_0/attn/wq/kernel", (4096, 4096)),
    ("params/layer_0/mlp/w_down/kernel", (14336, 4096)),
    ("params/moe/w_gate_up", (8, 64, 256)),
    ("params/conv/kernel", (3, 3, 64, 128)),
    ("params/nsp/kernel", (768, 2)),
    ("params/encoder/ln_emb/scale", (768,)),
])
@pytest.mark.parametrize("axes", [{"data": 2, "fsdp": 4},
                                  {"fsdp": 2, "tensor": 4},
                                  {"data": 1, "fsdp": 8},
                                  {"expert": 8}])
def test_infer_param_spec_matches_the_reference(path, shape, axes):
    want = japi.infer_param_spec(path, shape, jmesh.build_mesh(axes))
    assert api.infer_param_spec(path, shape, axes) == tuple(want)


@pytest.mark.parametrize("axes,n", [
    ({"data": -1}, 8), ({"data": 2, "fsdp": -1}, 8), ({"data": 1, "fsdp": 1}, 1),
    ({"data": -1, "fsdp": -1}, 8), ({"data": 3, "fsdp": -1}, 8),
    ({"data": 2, "fsdp": 2}, 8), ({"data": 2, "fsdp": 4}, 8),
])
def test_resolve_shape_matches_the_reference(axes, n):
    try:
        want = jmesh._resolve_shape(axes, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh._resolve_shape(axes, n)
        assert str(got.value) == str(e)
    else:
        assert mesh._resolve_shape(axes, n) == want


def test_data_axes_and_axis_sizes_match_the_reference():
    for axes in ({"data": 2, "fsdp": 4}, {"fsdp": 2, "tensor": 4},
                 {"tensor": 8}):
        jm = jmesh.build_mesh(axes)
        assert mesh.data_axes(axes) == jmesh.data_axes(jm)
        for a in axes:
            assert mesh.mesh_axis_size(a, axes) == jmesh.mesh_axis_size(a, jm)
        assert mesh.mesh_axis_size(tuple(axes), axes) == \
            jmesh.mesh_axis_size(tuple(axes), jm)


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_one_rank_mesh_replicates_and_refuses_unported_axes(cpu_world):
    """One rank: ``{"data": 1, "fsdp": -1}`` resolves to fsdp 1, a real
    DeviceMesh over the default group; ``shard_params`` leaves the model
    as it is, and so does a mesh with ``tensor``, ``seq``, ``expert`` and
    ``pipe`` axes of size 1 (for a Llama too: nothing to place).  Still
    refused: tensor or expert placement of a model other than Llama (BERT
    here, ROADMAP Queue A item 7), and a mesh that does not cover the
    world, as in the reference."""
    m = mesh.build_mesh({"data": 1, "fsdp": -1})
    assert m.mesh_dim_names == ("data", "fsdp") and tuple(m.shape) == (1, 1)
    assert mesh.axis_sizes(m) == {"data": 1, "fsdp": 1}
    assert mesh.data_axes(m) == ("data", "fsdp")
    assert mesh.axis_sizes(mesh.build_mesh()) == {"data": 1}
    cfg = dataclasses.replace(BertConfig.tiny(), dtype=torch.float32)
    model = BertForPretraining(cfg)
    assert api.shard_params(model, m) is model
    assert all(type(p) is torch.nn.Parameter for p in model.parameters())
    wide = mesh.build_mesh({"data": 1, "fsdp": 1, "tensor": 1, "seq": 1,
                            "expert": 1, "pipe": 1})
    llama = LlamaModel(LlamaConfig.tiny(num_experts=4))
    shapes = {n: p.shape for n, p in llama.named_parameters()}
    for target in (model, llama):
        assert api.shard_params(target, wide) is target
    assert llama.placement is None
    assert {n: p.shape for n, p in llama.named_parameters()} == shapes
    for axis in ("tensor", "expert"):
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            api.shard_params(model, {"data": 1, "fsdp": 1, axis: 2})
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        api.make_parallel_train_step(model, None, {"data": 1, "fsdp": 2})
    with pytest.raises(ValueError, match="does not cover"):
        mesh.build_mesh({"data": 2})
    with mesh.use_mesh(m):
        assert mesh.default_mesh() is m
    assert mesh.axis_sizes(mesh.default_mesh()) == {"data": 1}


def test_build_mesh_raises_before_init():
    basics.shutdown()
    with pytest.raises(ValueError, match="hvd.init"):
        mesh.build_mesh({"data": -1})
