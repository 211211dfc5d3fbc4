"""Parameters for the port's ``LlamaModel``, ``BertForPretraining``,
``ResNet``, MNIST models and ``SkipGramModel``: seeded, or carried over
from the JAX package.

Both functions return a state dict keyed by the port's module names, ready
for ``LlamaModel.from_state_dict`` / ``BertForPretraining.from_state_dict``
/ ``ResNet.from_state_dict`` (which model follows from the config's type):
Llama's tensors already in the dtype the model computes in (see
``models/llama.py``), BERT's and ResNet's all fp32 (the models cast at
each use).  ResNet's state dict also holds the BatchNorm running
statistics (flax's ``batch_stats``) as the buffers ``<norm>.mean`` and
``<norm>.var``.

* :func:`init_params` draws seeded weights with the *distributions* of
  the flax model's default initializers: ``nn.Dense`` kernels from
  ``lecun_normal`` (a normal truncated at two standard deviations, scaled
  so the truncated std is ``1/sqrt(fan_in)``), the ``nn.Embed`` table
  from a normal with std ``1/sqrt(hidden)``, RMSNorm and LayerNorm scales
  at one, biases (LayerNorm, ``Dense``, BERT's ``mlm_bias``) at zero;
  ResNet's ``nn.Conv`` kernels from ``lecun_normal`` over ``fan_in = k·k·
  in``, BatchNorm scales at one except the zero-initialised last one of
  each block (``resnet.py:79-83``), BatchNorm biases and running means at
  zero, running variances at one.  It
  cannot reproduce flax's bits: the JAX replica seeds with
  ``jax.random.key(HOROVOD_SERVE_PARAM_SEED)``, so a port replica and a
  JAX replica given the same seed serve *different* weights.  Every port
  replica given the same seed and device type serves identical weights.
* :func:`params_from_jax` converts the JAX package's parameter tree (as
  numpy arrays) — the way the parity tests put both frameworks on the
  same weights.  Flax ``Dense`` kernels are ``[in, out]``; torch
  ``Linear`` weights are ``[out, in]``; flax ``Conv`` kernels are
  ``[k, k, in, out]`` (HWIO), torch's ``[out, in, k, k]`` (OIHW).  An
  MoE layer's router is a ``Dense`` (transposed); its expert weights
  ``moe/w_gate_up`` [E, H, 2F] and ``moe/w_down`` [E, F, H] keep their
  layout, and :func:`init_params` draws them from ``lecun_normal`` with
  flax's fan-in over those shapes (in times E).
  :func:`params_to_jax` is its inverse (fp32 numpy leaves), so the tests
  can compare parameters after training steps.  BERT's ``type_emb`` table
  travels when the tree has it (the reference creates it only if ``init``
  saw ``token_type_ids``).  ResNet travels as the whole ``{"params",
  "batch_stats"}`` variables, both ways.

The MNIST models (``MnistConfig``) and the skip-gram model
(``SkipGramConfig``) travel the same way, all fp32: the MNIST ``Conv``
and ``Dense`` kernels transposed as above (``conv_<i>``/``dense_<i>`` are
flax's ``Conv_<i>``/``Dense_<i>``), the skip-gram tables as they are.
:func:`init_params` draws their kernels from ``lecun_normal`` with zero
biases, and the skip-gram tables from flax's own laws: ``embeddings``
uniform on [-1, 1), ``nce_weights`` a standard normal truncated to ±2
times ``1/sqrt(embedding_size)`` (``truncated_normal(stddev)``, with no
variance correction), ``nce_biases`` zeros.

Both functions place the tensors on the CUDA device unless given
``device="cpu"``, and raise without a GPU otherwise.  ``init_params``
takes a seed or an explicit ``torch.Generator``; with a generator it
draws on the generator's device and moves the result to ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.models.bert import BertConfig
from horovod_tpu_torch.models.llama import LlamaConfig
from horovod_tpu_torch.models.mnist import MnistConfig
from horovod_tpu_torch.models.resnet import ResNetConfig, block_convs
from horovod_tpu_torch.models.word2vec import SkipGramConfig

__all__ = ["init_params", "params_from_jax", "params_to_jax", "jax_tree",
           "jax_paths", "flax_layout"]

#: Standard deviation of a unit normal truncated to [-2, 2]; lecun_normal
#: divides by it so the truncated samples have the requested std.
_TRUNC_STD = 0.87962566103423978


def _layout(cfg: LlamaConfig) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(port name, kind, torch shape) for every parameter, in a fixed
    order; kind is "embed", "dense" (torch [out, in]), "head", "norm",
    "router" (the MoE router, a dense fp32 [E, H]) or "expert" (an
    expert-batched weight in the reference's own layout)."""
    D, H = cfg.head_dim, cfg.hidden_size
    yield "tok_emb.weight", "embed", (cfg.vocab_size, H)
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        yield p + "norm_attn.scale", "norm", (H,)
        yield p + "attn.wq.weight", "dense", (cfg.num_heads * D, H)
        yield p + "attn.wk.weight", "dense", (cfg.num_kv_heads * D, H)
        yield p + "attn.wv.weight", "dense", (cfg.num_kv_heads * D, H)
        yield p + "attn.wo.weight", "dense", (H, cfg.num_heads * D)
        yield p + "norm_mlp.scale", "norm", (H,)
        F_, E = cfg.intermediate_size, cfg.num_experts
        if E > 1:
            yield p + "moe.router.weight", "router", (E, H)
            yield p + "moe.w_gate_up", "expert", (E, H, 2 * F_)
            yield p + "moe.w_down", "expert", (E, F_, H)
        else:
            yield p + "mlp.w_gate_up.weight", "dense", (2 * F_, H)
            yield p + "mlp.w_down.weight", "dense", (H, F_)
    yield "norm_f.scale", "norm", (H,)
    yield "lm_head.weight", "head", (cfg.vocab_size, H)


def _bert_layout(cfg: BertConfig, type_emb: bool = True
                 ) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(port name, kind, torch shape) for every parameter of
    ``BertForPretraining``; kind is "embed", "dense" (torch [out, in]),
    "norm" (a LayerNorm scale) or "zero" (a bias)."""
    H, F = cfg.hidden_size, cfg.intermediate_size

    def dense(name, n_in, n_out):
        yield name + ".weight", "dense", (n_out, n_in)
        yield name + ".bias", "zero", (n_out,)

    def norm(name):
        yield name + ".weight", "norm", (H,)
        yield name + ".bias", "zero", (H,)

    yield "encoder.tok_emb.weight", "embed", (cfg.vocab_size, H)
    yield "encoder.pos_emb.weight", "embed", (cfg.max_position, H)
    if type_emb:
        yield "encoder.type_emb.weight", "embed", (cfg.type_vocab_size, H)
    yield from norm("encoder.ln_emb")
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."
        yield from dense(p + "attention.qkv", H, 3 * H)
        yield from dense(p + "attention.proj", H, H)
        yield from norm(p + "ln_attn")
        yield from dense(p + "mlp_in", H, F)
        yield from dense(p + "mlp_out", F, H)
        yield from norm(p + "ln_mlp")
    yield from dense("mlm_transform", H, H)
    yield from norm("mlm_ln")
    yield "mlm_bias", "zero", (cfg.vocab_size,)
    yield from dense("nsp", H, 2)


def _resnet_layout(cfg: ResNetConfig
                   ) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(port name, kind, torch shape) for every parameter and buffer of
    ``ResNet``; kind is "conv" (torch [out, in, k, k]), "head" (torch
    [out, in]), "zero" (a bias), "norm" / "norm0" (a BatchNorm scale that
    starts at one / zero), "mean" or "var" (running statistics)."""
    def norm(name, c, zero=False):
        yield name + ".scale", "norm0" if zero else "norm", (c,)
        yield name + ".bias", "zero", (c,)
        yield name + ".mean", "mean", (c,)
        yield name + ".var", "var", (c,)

    yield "conv_init.weight", "conv", (cfg.width, 3, 7, 7)
    yield from norm("bn_init", cfg.width)
    n_main = 3 if cfg.block == "bottleneck" else 2
    for i, cin, filters, stride in cfg.blocks():
        convs = block_convs(cfg.block, cin, filters, stride)
        for j, (ci, co, k, _) in enumerate(convs):
            yield f"blocks.{i}.convs.{j}.weight", "conv", (co, ci, k, k)
        for j, (_, co, _, _) in enumerate(convs):
            yield from norm(f"blocks.{i}.norms.{j}", co, j == n_main - 1)
    yield "head.weight", "head", (cfg.num_classes, cfg.features)
    yield "head.bias", "zero", (cfg.num_classes,)


def _mnist_layout(cfg: MnistConfig
                  ) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(port name, kind, torch shape) of ``MnistConvNet`` or
    ``MnistMLP``; kind is "conv", "dense" (torch [out, in]) or "zero"."""
    def layer(name, kind, shape):
        yield name + ".weight", kind, shape
        yield name + ".bias", "zero", (shape[0],)

    if cfg.kind == "conv":
        yield from layer("conv_0", "conv", (32, 1, 5, 5))
        yield from layer("conv_1", "conv", (64, 32, 5, 5))
        yield from layer("dense_0", "dense", (512, 7 * 7 * 64))
        yield from layer("dense_1", "dense", (cfg.num_classes, 512))
    else:
        yield from layer("dense_0", "dense", (cfg.hidden, 28 * 28))
        yield from layer("dense_1", "dense", (cfg.num_classes, cfg.hidden))


def _skipgram_layout(cfg: SkipGramConfig
                     ) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(name, kind, shape) of ``SkipGramModel``: "uniform" (on [-1, 1)),
    "trunc" (flax's uncorrected truncated normal) and "zero"."""
    V, E = cfg.vocab_size, cfg.embedding_size
    yield "embeddings", "uniform", (V, E)
    yield "nce_weights", "trunc", (V, E)
    yield "nce_biases", "zero", (V,)


def _layout_of(cfg, type_emb: bool = True):
    if isinstance(cfg, BertConfig):
        return _bert_layout(cfg, type_emb)
    if isinstance(cfg, ResNetConfig):
        return _resnet_layout(cfg)
    if isinstance(cfg, MnistConfig):
        return _mnist_layout(cfg)
    if isinstance(cfg, SkipGramConfig):
        return _skipgram_layout(cfg)
    return _layout(cfg)


#: Configs whose parameters are all fp32 (the models cast at each use).
_FP32_CONFIGS = (BertConfig, ResNetConfig, MnistConfig, SkipGramConfig)


def _dtype(cfg, kind: str) -> torch.dtype:
    if isinstance(cfg, _FP32_CONFIGS):
        return torch.float32
    return {"norm": torch.float32, "router": torch.float32,
            "head": cfg.logits_dtype}.get(kind, cfg.dtype)


def _unit_trunc_normal(shape, gen: torch.Generator,
                       device) -> torch.Tensor:
    """fp32 samples of N(0, 1) truncated to [-2, 2] (inverse-CDF of a
    uniform draw)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.erfinv((2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0))
    return (x * math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _trunc_normal(shape, std: float, gen: torch.Generator,
                  device) -> torch.Tensor:
    """:func:`_unit_trunc_normal` rescaled to ``std`` after truncation
    (``lecun_normal``)."""
    return _unit_trunc_normal(shape, gen, device).mul_(std / _TRUNC_STD)


def init_params(cfg, seed: Union[int, torch.Generator], device=None, *,
                token_types: bool = True) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` (a ``LlamaConfig``, ``BertConfig``,
    ``ResNetConfig``, ``MnistConfig`` or ``SkipGramConfig``; for ResNet
    also the running statistics) on ``device`` (``None``: the CUDA
    device), drawn with an explicit generator: a new one seeded with
    ``seed`` on ``device``, or ``seed`` itself when it is a
    ``torch.Generator`` (drawn on its device, then moved).
    ``token_types`` (BERT only): whether to make the ``type_emb`` table,
    as the reference's ``init`` does when it is given
    ``token_type_ids``."""
    layout = _layout_of(cfg, token_types)
    device = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    draw = gen.device
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in layout:
        if kind in ("norm", "var"):
            t = torch.ones(shape, dtype=torch.float32, device=draw)
        elif kind in ("zero", "norm0", "mean"):
            t = torch.zeros(shape, dtype=torch.float32, device=draw)
        elif kind == "embed":
            t = torch.randn(shape, generator=gen, device=draw,
                            dtype=torch.float32)
            t.mul_(1.0 / math.sqrt(cfg.hidden_size))
        elif kind == "uniform":
            t = torch.rand(shape, generator=gen, device=draw,
                           dtype=torch.float32).mul_(2.0).sub_(1.0)
        elif kind == "trunc":
            t = _unit_trunc_normal(shape, gen, draw).mul_(
                1.0 / math.sqrt(cfg.embedding_size))
        else:   # lecun_normal over flax's fan_in
            # dense / head / router / conv: everything but the out dim;
            # expert [E, in, out]: in times the batch dims (flax's
            # receptive field).
            fan_in = (shape[-2] * math.prod(shape[:-2]) if kind == "expert"
                      else math.prod(shape[1:]))
            t = _trunc_normal(shape, 1.0 / math.sqrt(fan_in), gen, draw)
        out[name] = t.to(device=device, dtype=_dtype(cfg, kind))
    return out


def _jax_path(name: str, kind: str) -> Tuple[str, ...]:
    """The flax tree path of a port parameter name of the given kind."""
    parts = name.split(".")
    i = parts.index("layers") if "layers" in parts else -1
    if i >= 0:
        parts = parts[:i] + [f"layer_{parts[i + 1]}"] + parts[i + 2:]
    if len(parts) == 1 or kind == "expert":   # a bare parameter
        return tuple(parts)
    leaf = {"embed": "embedding", "dense": "kernel", "head": "kernel",
            "router": "kernel",
            "norm": "scale", "zero": "bias"}[kind]
    return tuple(parts[:-1]) + (leaf,)


def _resnet_jax_path(cfg: ResNetConfig, name: str,
                     kind: str) -> Tuple[str, Tuple[str, ...]]:
    """(collection, flax path) of a ResNet parameter or buffer name:
    ``blocks.<i>.convs.<j>.weight`` is ``<Block>_<i>/Conv_<j>/kernel`` in
    ``params``, ``blocks.<i>.norms.<j>.mean`` is ``<Block>_<i>/
    BatchNorm_<j>/mean`` in ``batch_stats``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        mod = {"convs": "Conv", "norms": "BatchNorm"}[parts[2]]
        parts = [f"{cfg.block_name}_{parts[1]}", f"{mod}_{parts[3]}",
                 parts[4]]
    leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
    coll = "batch_stats" if kind in ("mean", "var") else "params"
    return coll, tuple(parts[:-1]) + (leaf,)


def _mnist_jax_path(name: str) -> Tuple[str, ...]:
    """``conv_<i>.weight`` is flax's ``Conv_<i>/kernel``, ``dense_<i>.bias``
    its ``Dense_<i>/bias``."""
    module, leaf = name.split(".")
    kind, index = module.split("_")
    return (f"{kind.capitalize()}_{index}",
            {"weight": "kernel"}.get(leaf, leaf))


def _path(cfg, name: str, kind: str) -> Tuple[str, Tuple[str, ...]]:
    """(collection, flax path) of a port name of the given kind."""
    if isinstance(cfg, ResNetConfig):
        return _resnet_jax_path(cfg, name, kind)
    if isinstance(cfg, MnistConfig):
        return "params", _mnist_jax_path(name)
    return "params", _jax_path(name, kind)


#: The flax dimension of each of the port tensor's dimensions, by kind
#: (the same order where a kind is absent): a ``Linear`` weight [out, in]
#: is flax's [in, out] kernel, an OIHW conv weight its HWIO kernel.
_FLAX_DIMS = {"dense": (1, 0), "head": (1, 0), "router": (1, 0),
              "conv": (3, 2, 0, 1)}


def _flax_dims(kind: str, ndim: int) -> Tuple[int, ...]:
    return _FLAX_DIMS.get(kind, tuple(range(ndim)))


def _from_jax_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    return arr.transpose(_flax_dims(kind, arr.ndim))


def _has_type_emb(cfg, tree: Mapping) -> bool:
    return isinstance(cfg, BertConfig) and "type_emb" in tree.get(
        "encoder", {})


def params_from_jax(tree: Mapping, cfg,
                    device=None) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's ``LlamaModel``, ``BertForPretraining``,
    ``MnistConvNet``, ``MnistMLP`` or ``SkipGramModel`` parameters
    (``variables`` or ``variables["params"]``, leaves
    convertible with ``np.asarray``), or a ``ResNet``'s whole ``{"params",
    "batch_stats"}`` variables, into the port's state dict on ``device``
    (``None``: the CUDA device)."""
    if isinstance(cfg, ResNetConfig):
        if "batch_stats" not in tree:
            raise ValueError("a ResNet needs its variables with both "
                             "'params' and 'batch_stats'")
        trees = tree
    else:
        trees = {"params": tree.get("params", tree)}
    layout = _layout_of(cfg, _has_type_emb(cfg, trees["params"]))
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in layout:
        coll, path = _path(cfg, name, kind)
        node = trees[coll]
        for key in path:
            node = node[key]
        arr = _from_jax_layout(np.asarray(node, dtype=np.float32), kind)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: JAX shape {arr.shape} does not match "
                             f"{shape}")
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            device=device, dtype=_dtype(cfg, kind))
    return out


def _to_jax_view(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The flax layout of a port tensor, as a view (no copy): ``[out, in]``
    to ``[in, out]``, OIHW to HWIO."""
    dims = _flax_dims(kind, t.dim())
    return t.permute(*sorted(range(t.dim()), key=dims.__getitem__))


def jax_tree(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's state dict as the JAX package's ``{"params": ...}`` tree
    (a ResNet's with ``"batch_stats"``), its leaves VIEWS of the port's
    tensors in the flax layout: writing into a leaf writes the model.
    The checkpoint plane saves and restores the ``params`` slot through
    it."""
    out: Dict = {"params": {}}
    if isinstance(cfg, ResNetConfig):
        out["batch_stats"] = {}
    type_emb = "encoder.type_emb.weight" in state
    for name, kind, _ in _layout_of(cfg, type_emb):
        coll, (*path, leaf) = _path(cfg, name, kind)
        node = out[coll]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _to_jax_view(state[name].detach(), kind)
    return out


def jax_paths(cfg) -> Dict[str, Tuple[str, str]]:
    """``{dotted flax path under params: (port name, kind)}`` of a
    Llama or BERT config: how a weight push's paths (``w.params.<path>``)
    map onto the port's parameters."""
    out = {}
    for name, kind, _ in _layout_of(cfg, True):
        coll, path = _path(cfg, name, kind)
        out[".".join((coll,) + path)] = (name, kind)
    return out


def flax_layout(cfg, type_emb: bool = True
                ) -> Optional[Dict[str, Tuple[str, Tuple[int, ...]]]]:
    """``{port parameter name: (its path in the reference's tree,
    "params/<flax path>"; the flax dimension of each port dimension)}``
    for the model ``cfg`` describes (a ResNet's running statistics are
    buffers and are not listed), or None for a config this module does
    not know.  ``type_emb`` (BERT): whether the model has the token-type
    table.  ``parallel/api.py`` applies the reference's sharding rules
    through it."""
    if not isinstance(cfg, (LlamaConfig,) + _FP32_CONFIGS):
        return None
    out = {}
    for name, kind, shape in _layout_of(cfg, type_emb):
        coll, path = _path(cfg, name, kind)
        if coll == "params":
            out[name] = ("/".join((coll,) + path),
                         _flax_dims(kind, len(shape)))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's state dict (or ``model.state_dict()``) as the JAX
    package's ``{"params": ...}`` tree of fp32 numpy arrays (a ResNet's as
    ``{"params": ..., "batch_stats": ...}``)."""
    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        return np.ascontiguousarray(node.float().cpu().numpy())

    return to_numpy(jax_tree(state, cfg))
