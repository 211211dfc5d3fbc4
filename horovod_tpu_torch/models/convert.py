"""Parameters for the port's ``LlamaModel`` and ``BertForPretraining``:
seeded, or carried over from the JAX package.

Both functions return a state dict keyed by the port's module names, ready
for ``LlamaModel.from_state_dict`` / ``BertForPretraining.from_state_dict``
(which model follows from the config's type): Llama's tensors already in
the dtype the model computes in (see ``models/llama.py``), BERT's all fp32
(the model casts at each use, see ``models/bert.py``).

* :func:`init_params` draws seeded weights with the *distributions* of
  the flax model's default initializers: ``nn.Dense`` kernels from
  ``lecun_normal`` (a normal truncated at two standard deviations, scaled
  so the truncated std is ``1/sqrt(fan_in)``), the ``nn.Embed`` table
  from a normal with std ``1/sqrt(hidden)``, RMSNorm and LayerNorm scales
  at one, biases (LayerNorm, ``Dense``, BERT's ``mlm_bias``) at zero.  It
  cannot reproduce flax's bits: the JAX replica seeds with
  ``jax.random.key(HOROVOD_SERVE_PARAM_SEED)``, so a port replica and a
  JAX replica given the same seed serve *different* weights.  Every port
  replica given the same seed and device type serves identical weights.
* :func:`params_from_jax` converts the JAX package's parameter tree (as
  numpy arrays) — the way the parity tests put both frameworks on the
  same weights.  Flax ``Dense`` kernels are ``[in, out]``; torch
  ``Linear`` weights are ``[out, in]``.  :func:`params_to_jax` is its
  inverse (fp32 numpy leaves), so the tests can compare parameters after
  training steps.  BERT's ``type_emb`` table travels when the tree has
  it (the reference creates it only if ``init`` saw ``token_type_ids``).

Both functions place the tensors on the CUDA device unless given
``device="cpu"``, and raise without a GPU otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.models.bert import BertConfig
from horovod_tpu_torch.models.llama import LlamaConfig, _require_dense

__all__ = ["init_params", "params_from_jax", "params_to_jax"]

#: Standard deviation of a unit normal truncated to [-2, 2]; lecun_normal
#: divides by it so the truncated samples have the requested std.
_TRUNC_STD = 0.87962566103423978


def _layout(cfg: LlamaConfig) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(port name, kind, torch shape) for every parameter, in a fixed
    order; kind is "embed", "dense" (torch [out, in]), "head" or "norm"."""
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
        yield p + "mlp.w_gate_up.weight", "dense",\
            (2 * cfg.intermediate_size, H)
        yield p + "mlp.w_down.weight", "dense", (H, cfg.intermediate_size)
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


def _layout_of(cfg, type_emb: bool = True):
    if isinstance(cfg, BertConfig):
        return _bert_layout(cfg, type_emb)
    _require_dense(cfg)
    return _layout(cfg)


def _dtype(cfg, kind: str) -> torch.dtype:
    if isinstance(cfg, BertConfig):
        return torch.float32
    return {"norm": torch.float32,
            "head": cfg.logits_dtype}.get(kind, cfg.dtype)


def _trunc_normal(shape, std: float, gen: torch.Generator,
                  device) -> torch.Tensor:
    """fp32 samples of N(0, 1) truncated to [-2, 2] (inverse-CDF of a
    uniform draw), rescaled to ``std`` after truncation."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.erfinv((2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0))
    x = (x * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std / _TRUNC_STD)


def init_params(cfg, seed: int, device=None, *,
                token_types: bool = True) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` (a ``LlamaConfig`` or a ``BertConfig``)
    drawn on ``device`` (``None``: the CUDA device) with an explicit
    generator.  ``token_types`` (BERT only): whether to make the
    ``type_emb`` table, as the reference's ``init`` does when it is given
    ``token_type_ids``."""
    layout = _layout_of(cfg, token_types)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in layout:
        if kind == "norm":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "zero":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "embed":
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            t.mul_(1.0 / math.sqrt(cfg.hidden_size))
        else:   # dense / head: lecun_normal over fan_in = shape[1]
            t = _trunc_normal(shape, 1.0 / math.sqrt(shape[1]), gen, device)
        out[name] = t.to(_dtype(cfg, kind))
    return out


def _jax_path(name: str, kind: str) -> Tuple[str, ...]:
    """The flax tree path of a port parameter name of the given kind."""
    parts = name.split(".")
    i = parts.index("layers") if "layers" in parts else -1
    if i >= 0:
        parts = parts[:i] + [f"layer_{parts[i + 1]}"] + parts[i + 2:]
    if len(parts) == 1:                    # a bare parameter (mlm_bias)
        return tuple(parts)
    leaf = {"embed": "embedding", "dense": "kernel", "head": "kernel",
            "norm": "scale", "zero": "bias"}[kind]
    return tuple(parts[:-1]) + (leaf,)


def _has_type_emb(cfg, tree: Mapping) -> bool:
    return isinstance(cfg, BertConfig) and "type_emb" in tree.get(
        "encoder", {})


def params_from_jax(tree: Mapping, cfg,
                    device=None) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's ``LlamaModel`` or ``BertForPretraining``
    parameters (``variables`` or ``variables["params"]``, leaves
    convertible with ``np.asarray``) into the port's state dict on
    ``device`` (``None``: the CUDA device)."""
    if "params" in tree:
        tree = tree["params"]
    layout = _layout_of(cfg, _has_type_emb(cfg, tree))
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in layout:
        node = tree
        for key in _jax_path(name, kind):
            node = node[key]
        arr = np.asarray(node, dtype=np.float32)
        if kind in ("dense", "head"):
            arr = arr.T                              # [in, out] -> [out, in]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: JAX shape {arr.shape} does not match "
                             f"{shape}")
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(
            device=device, dtype=_dtype(cfg, kind))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's state dict (or ``model.state_dict()``) as the JAX
    package's ``{"params": ...}`` tree of fp32 numpy arrays."""
    out: Dict = {}
    type_emb = "encoder.type_emb.weight" in state
    for name, kind, _ in _layout_of(cfg, type_emb):
        arr = state[name].detach().float().cpu().numpy()
        if kind in ("dense", "head"):
            arr = arr.T                              # [out, in] -> [in, out]
        *path, leaf = _jax_path(name, kind)
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": out}
