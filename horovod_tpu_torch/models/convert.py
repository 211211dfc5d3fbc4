"""Parameters for the port's ``LlamaModel``: seeded, or carried over
from the JAX package.

Both builders return a state dict keyed by the port's module names, each
tensor already in the dtype the model computes in (see
``models/llama.py``), ready for ``LlamaModel.from_state_dict``.

* :func:`init_params` draws seeded weights with the *distributions* of
  the flax model's default initializers: ``nn.Dense`` kernels from
  ``lecun_normal`` (a normal truncated at two standard deviations, scaled
  so the truncated std is ``1/sqrt(fan_in)``), the ``nn.Embed`` table
  from a normal with std ``1/sqrt(hidden)``, RMSNorm scales at one.  It
  cannot reproduce flax's bits: the JAX replica seeds with
  ``jax.random.key(HOROVOD_SERVE_PARAM_SEED)``, so a port replica and a
  JAX replica given the same seed serve *different* weights.  Every port
  replica given the same seed and device type serves identical weights.
* :func:`params_from_jax` converts the JAX package's parameter tree (as
  numpy arrays) — the way the parity tests put both frameworks on the
  same weights.  Flax ``Dense`` kernels are ``[in, out]``; torch
  ``Linear`` weights are ``[out, in]``.  :func:`params_to_jax` is its
  inverse (fp32 numpy leaves), so the tests can compare parameters after
  training steps.

Both functions place the tensors on the CUDA device unless given
``device="cpu"``, and raise without a GPU otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.device import resolve_device
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


def _dtype(cfg: LlamaConfig, kind: str) -> torch.dtype:
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


def init_params(cfg: LlamaConfig, seed: int,
                device=None) -> Dict[str, torch.Tensor]:
    """Seeded weights drawn on ``device`` (``None``: the CUDA device)
    with an explicit generator."""
    _require_dense(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in _layout(cfg):
        if kind == "norm":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "embed":
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            t.mul_(1.0 / math.sqrt(cfg.hidden_size))
        else:   # dense / head: lecun_normal over fan_in = shape[1]
            t = _trunc_normal(shape, 1.0 / math.sqrt(shape[1]), gen, device)
        out[name] = t.to(_dtype(cfg, kind))
    return out


def _jax_path(name: str) -> Tuple[str, ...]:
    """The flax tree path of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    leaf = {"scale": "scale", "weight": "kernel"}[parts[-1]]
    if parts[0] == "tok_emb":
        leaf = "embedding"
    return tuple(parts[:-1]) + (leaf,)


def params_from_jax(tree: Mapping, cfg: LlamaConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's ``LlamaModel`` parameters (``variables``
    or ``variables["params"]``, leaves convertible with ``np.asarray``)
    into the port's state dict on ``device`` (``None``: the CUDA
    device)."""
    _require_dense(cfg)
    device = resolve_device(device)
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in _layout(cfg):
        node = tree
        for key in _jax_path(name):
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


def params_to_jax(state: Mapping[str, torch.Tensor],
                  cfg: LlamaConfig) -> Dict:
    """The port's state dict (or ``model.state_dict()``) as the JAX
    package's ``{"params": ...}`` tree of fp32 numpy arrays."""
    _require_dense(cfg)
    out: Dict = {}
    for name, kind, _ in _layout(cfg):
        arr = state[name].detach().float().cpu().numpy()
        if kind in ("dense", "head"):
            arr = arr.T                              # [out, in] -> [in, out]
        *path, leaf = _jax_path(name)
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": out}
