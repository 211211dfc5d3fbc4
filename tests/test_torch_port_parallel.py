"""Port parity: meshes and parameter placement.

The port's ``parallel/mesh.py`` and ``parallel/api.py`` against the JAX
package's: ``_resolve_shape`` (results and error messages),
``data_axes`` / ``mesh_axis_size``, and ``infer_param_spec`` — the port
applies the reference's rules to each of its parameters through the
reference's tree path and lays the spec on the port's dimensions (a
``Linear`` weight is ``[out, in]`` here, ``[in, out]`` there; a conv
weight OIHW here, HWIO there), so every parameter of BERT-base, of
Llama-3-8B's layout and of ResNet-50 must get the reference's mesh axis
on the same logical dimension, for meshes ``{"data": 2, "fsdp": 4}``,
``{"data": 8}`` and ``{"fsdp": 2, "tensor": 2}``.  The hand placement on
gloo ranks is held in ``test_torch_port_parallel_step.py`` (Llama) and
``test_torch_port_parallel_zoo.py`` (BERT, ResNet, and the rules'
placement of models with no hand placement).
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
from horovod_tpu.models.resnet import ResNet50 as JaxResNet50
from horovod_tpu.parallel import api as japi
from horovod_tpu.parallel import mesh as jmesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.bert import BertConfig, BertForPretraining
from horovod_tpu_torch.models.convert import (_bert_layout, _jax_path,
                                              _layout, _resnet_jax_path,
                                              _resnet_layout)
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig
from horovod_tpu_torch.parallel import api, mesh

MESHES = [{"data": 2, "fsdp": 4}, {"data": 8}, {"fsdp": 2, "tensor": 2}]
#: The reference dimension of each port dimension, by convert's kind (an
#: independent account of the layouts ``param_specs`` reads).
FLAX_DIMS = {"dense": (1, 0), "head": (1, 0), "conv": (3, 2, 0, 1)}


def _reference_specs(variables, jax_mesh):
    """{reference path: spec tuple} as ``shard_params`` would place them."""
    out = {}

    def spec(path, leaf):
        key = japi._path_str(path)
        out[key] = tuple(japi.infer_param_spec(key, jnp.shape(leaf),
                                               jax_mesh))
    jax.tree_util.tree_map_with_path(spec, variables)
    return out


def _layout_pairs(layout, path_of=_jax_path):
    """(port name, reference path, reference dimension of each port
    dimension or None) of every parameter in convert's layout — an
    independent account of the name mapping ``param_specs`` makes."""
    for name, kind, _ in layout:
        if kind in ("mean", "var"):       # ResNet's running statistics
            continue
        yield (name, "params/" + "/".join(path_of(name, kind)),
               FLAX_DIMS.get(kind))


def _resnet_path(cfg):
    def path_of(name, kind):
        coll, path = _resnet_jax_path(cfg, name, kind)
        assert coll == "params"
        return path
    return path_of


@pytest.mark.parametrize("axes", MESHES,
                         ids=["data2_fsdp4", "data8", "fsdp2_tensor2"])
@pytest.mark.parametrize("model", ["bert_base", "llama3_8b", "resnet50"])
def test_param_specs_match_the_reference(model, axes):
    """Every parameter's spec, laid on the port's dimensions, is the
    rules' on the reference's tree: BERT-base, Llama-3-8B's layout and
    ResNet-50 (its convolutions' ``tensor`` on the out-channels, the
    port's dimension 0 of an OIHW weight)."""
    n = 1
    for size in axes.values():
        n *= size
    jax_mesh = jmesh.build_mesh(axes, devices=jax.devices()[:n])
    ids = jnp.zeros((1, 8), jnp.int32)
    if model == "bert_base":
        variables = jax.eval_shape(JaxBert(JaxBertConfig.base()).init,
                                   jax.random.key(0), ids, ids)
        torch_model = BertForPretraining(BertConfig.base(), device="meta")
        pairs = _layout_pairs(_bert_layout(BertConfig.base()))
    elif model == "resnet50":
        cfg = ResNetConfig.resnet50()
        variables = jax.eval_shape(
            lambda k: JaxResNet50(num_classes=1000).init(
                k, jnp.zeros((1, 224, 224, 3)), train=False),
            jax.random.key(0))
        torch_model = ResNet(cfg, device="meta")
        pairs = _layout_pairs(_resnet_layout(cfg), _resnet_path(cfg))
    else:
        variables = jax.eval_shape(
            JaxLlamaModel(JaxLlamaConfig.llama3_8b()).init,
            jax.random.key(0), ids)
        torch_model = LlamaModel(LlamaConfig.llama3_8b(), device="meta")
        pairs = _layout_pairs(_layout(LlamaConfig.llama3_8b()))
    want = {k: v for k, v in _reference_specs(variables, jax_mesh).items()
            if k.startswith("params/")}
    got = api.param_specs(torch_model, axes)
    pairs = list(pairs)
    assert sorted(got) == sorted(name for name, _, _ in pairs)
    assert len(want) == len(pairs)
    for name, path, dims in pairs:
        ref = want[path]
        if ref and dims:
            ref = tuple(ref[j] for j in dims)
        assert got[name] == ref, (name, path)
    placed = [a for a in ("fsdp", "tensor") if axes.get(a, 1) > 1]
    for a in placed:
        # The rules do shard something on each of these axes.
        assert any(a in s for s in got.values()), a
    if not placed:
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
    ``pipe`` axes of size 1 (for a Llama too: nothing to place).  A model
    with no hand placement (``MnistMLP``) is placed by the rules at
    ``tensor``, ``expert`` and ``fsdp`` 2: they replicate every leaf of
    it, so it stays whole and unplaced (``make_train_step`` still takes
    it).  Still refused: a mesh that does not cover the world, as in the
    reference."""
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
    mlp = MnistMLP(dtype=torch.float32, device="cpu")
    shapes = {n: p.shape for n, p in mlp.named_parameters()}
    for axis in ("tensor", "expert", "fsdp"):
        sizes = {"data": 1, "fsdp": 1, axis: 2}
        assert set(api.param_shardings(mlp, sizes).values()) == {()}
        assert api.shard_params(mlp, sizes) is mlp
        assert getattr(mlp, "placement", None) is None
        assert {n: p.shape for n, p in mlp.named_parameters()} == shapes
    with pytest.raises(ValueError, match="does not cover"):
        mesh.build_mesh({"data": 2})
    with mesh.use_mesh(m):
        assert mesh.default_mesh() is m
    assert mesh.axis_sizes(mesh.default_mesh()) == {"data": 1}


def test_build_mesh_raises_before_init():
    basics.shutdown()
    with pytest.raises(ValueError, match="hvd.init"):
        mesh.build_mesh({"data": -1})
