"""Parameter sharding over a named mesh: the reference's rules, applied
with FSDP2.

Counterpart of the part of ``horovod_tpu/parallel/api.py`` that the BERT
example calls: :data:`SHARDING_RULES`, :func:`infer_param_spec` and
:func:`shard_params`.  The reference annotates each parameter with a
``NamedSharding`` and lets GSPMD insert the collectives; here:

* the same regexes run over each parameter's path in the reference's
  tree (``params/encoder/layer_0/attention/qkv/kernel`` for the port's
  ``encoder.layers.0.attention.qkv.weight``: ``layers.<i>`` is
  ``layer_<i>``, a ``Linear`` weight is a ``kernel``, an ``Embedding``
  weight an ``embedding``, a ``LayerNorm`` weight a ``scale``) and give
  the reference's spec over the reference's shape; a ``Linear`` weight is
  ``[out, in]`` here, ``[in, out]`` there, so its spec is reversed — each
  parameter puts the same mesh axis on the same logical dimension
  (:func:`param_specs`);
* an ``fsdp`` axis of size 1 (one card, or pure data parallelism)
  replicates everything and leaves the model as it is: the optimizer's
  ``DistributedOptimizer`` averages the gradients;
* an ``fsdp`` axis larger than 1 applies FSDP2 (``fully_shard``) to each
  layer of the model's ``layers`` stack and to the root, HSDP over
  (``data``, ``fsdp``) when ``data`` is larger than 1 too, each
  parameter sharded on the dimension the rules give ``fsdp``.  The FSDP
  units reduce their own gradients (wrap the optimizer with
  ``DistributedOptimizer(reduce_gradients=False)``, as the reference's
  ``make_parallel_train_step`` switches its optimizer's reduction off).
  FSDP2 shards every parameter it manages: one the rules replicate
  (norms, biases, the NSP head) is sharded on its first dimension
  anyway, the same values in another placement.

A ``tensor``, ``seq`` or ``expert`` axis larger than 1 raises:
tensor/sequence/expert parallelism, ``make_parallel_train_step`` and
``lm_loss_fn`` are ROADMAP.md Queue A item 9.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch.nn as nn

from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR,
                                             axis_sizes)

__all__ = ["SHARDING_RULES", "infer_param_spec", "param_specs",
           "shard_params"]

# Path-regex → axis names per dimension (None = replicate that dim), over
# the reference's tree paths and shapes: the reference's own table.
SHARDING_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"tok_emb.*embedding$", ("tensor", "fsdp")),
    (r"(pos_emb|type_emb).*embedding$", (None, "fsdp")),
    (r"(wq|wk|wv|qkv|mlp_in|w_gate_up|mlm_transform)/kernel$", ("fsdp", "tensor")),
    (r"(wo|proj|w_down|mlp_out)/kernel$", ("tensor", "fsdp")),
    (r"(lm_head|mlm_out)/kernel$", ("fsdp", "tensor")),
    (r"moe/w_gate_up$", ("expert", "fsdp", "tensor")),
    (r"moe/w_down$", ("expert", "tensor", "fsdp")),
    (r"router/kernel$", ("fsdp", None)),
    (r"head/kernel$", ("fsdp", "tensor")),   # resnet classifier
    (r"kernel$", (None, None, None, "tensor")),  # convs: shard out-channels
)

_UNPORTED_AXES = (AXIS_TENSOR, AXIS_SEQ, AXIS_EXPERT)


def infer_param_spec(path: str, shape: Tuple[int, ...],
                     mesh) -> Tuple[Optional[str], ...]:
    """The reference's spec for one parameter, as a tuple (one mesh axis
    or None per dimension; ``()`` replicates): ``path`` and ``shape`` are
    the reference's (tree path, ``[in, out]`` kernels).

    Axes not present in the mesh, mesh axes of size 1, and axes that do not
    divide the corresponding dimension are dropped (replicated) — so the same
    rules work on any mesh shape, including single-axis data-parallel meshes.
    ``mesh``: a ``DeviceMesh`` or a mapping {axis name: size}.
    """
    sizes = axis_sizes(mesh)
    for pattern, dims in SHARDING_RULES:
        if re.search(pattern, path):
            if len(dims) != len(shape):
                continue
            spec = []
            for dim_size, axis in zip(shape, dims):
                if (axis is None or axis not in sizes or sizes[axis] == 1
                        or dim_size % sizes[axis] != 0):
                    spec.append(None)
                else:
                    spec.append(axis)
            return tuple(spec)
    return ()  # replicate by default (norms, biases, small tables)


def _reference_path(module_name: str, module: nn.Module,
                    param_name: str) -> Tuple[str, bool]:
    """(the parameter's path in the reference's tree, whether the port
    stores it transposed)."""
    parts = module_name.split(".") if module_name else []
    if "layers" in parts:
        i = parts.index("layers")
        parts[i:i + 2] = [f"layer_{parts[i + 1]}"]
    leaf, transposed = param_name, False
    if isinstance(module, nn.Linear) and param_name == "weight":
        leaf, transposed = "kernel", True
    elif isinstance(module, nn.Embedding):
        leaf = "embedding"
    elif isinstance(module, nn.LayerNorm) and param_name == "weight":
        leaf = "scale"
    return "/".join(["params"] + parts + [leaf]), transposed


def param_specs(model: nn.Module,
                mesh) -> Dict[str, Tuple[Optional[str], ...]]:
    """{port parameter name: spec over the port's shape}: the reference's
    spec for the same parameter, reversed for a ``Linear`` weight."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            path, transposed = _reference_path(mod_name, mod, p_name)
            shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
            spec = infer_param_spec(path, shape, mesh)
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            out[name] = spec[::-1] if transposed else spec
    return out


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` (a ``DeviceMesh`` from
    ``build_mesh``) by the rules; returns the model (sharded in place by
    FSDP2 when ``fsdp`` > 1, untouched otherwise)."""
    sizes = axis_sizes(mesh)
    unported = [a for a in _UNPORTED_AXES if sizes.get(a, 1) > 1]
    if unported:
        raise NotImplementedError(
            f"shard_params: mesh axes {unported} of size > 1 — tensor, "
            "sequence and expert parallelism are not ported yet (ROADMAP.md "
            "Queue A item 9)")
    if sizes.get(AXIS_FSDP, 1) == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = param_specs(model, mesh)
    by_param = {p: specs[n] for n, p in model.named_parameters()}

    def placement(p):
        spec = by_param.get(p, ())
        return Shard(spec.index(AXIS_FSDP)) if AXIS_FSDP in spec else None

    dp_mesh = (mesh[(AXIS_DATA, AXIS_FSDP)]
               if sizes.get(AXIS_DATA, 1) > 1 else mesh[AXIS_FSDP])
    for name, mod in model.named_modules():
        if name.split(".")[-2:-1] == ["layers"]:
            fully_shard(mod, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    return model
