"""Parameter sharding over a named mesh and the GSPMD-style train step:
the reference's rules, applied by hand.

Counterpart of ``horovod_tpu/parallel/api.py``: :data:`SHARDING_RULES`,
:func:`infer_param_spec`, :func:`shard_params`, :func:`param_shardings`,
:func:`lm_loss_fn` and :func:`make_parallel_train_step`.  The reference
annotates each parameter with a ``NamedSharding`` and lets GSPMD insert
the collectives; here:

* the same regexes run over each parameter's path in the reference's
  tree (``params/encoder/layer_0/attention/qkv/kernel`` for the port's
  ``encoder.layers.0.attention.qkv.weight``: ``layers.<i>`` is
  ``layer_<i>``, a ``Linear`` weight is a ``kernel``, an ``Embedding``
  weight an ``embedding``, a ``LayerNorm`` weight a ``scale``) and give
  the reference's spec over the reference's shape; a ``Linear`` weight is
  ``[out, in]`` here, ``[in, out]`` there, so its spec is reversed — each
  parameter puts the same mesh axis on the same logical dimension
  (:func:`param_specs`);
* a ``LlamaModel`` (dense or MoE) on a mesh whose ``fsdp``, ``tensor`` or
  ``expert`` axis is larger than 1 is placed by hand
  (``parallel/placement.py``): each rank keeps its block of each
  parameter and the forward adds the collectives (the Megatron pair for
  ``tensor``, an allgather with a reduce-scatter backward for ``fsdp``,
  a sum of the experts' parts for ``expert``);
* any other model at ``fsdp`` > 1 gets FSDP2 (``fully_shard``) per layer
  of its ``layers`` stack and at the root, HSDP over (``data``, ``fsdp``)
  when ``data`` is larger than 1 too, each parameter sharded on the
  dimension the rules give ``fsdp`` (one the rules replicate on its first
  dimension: the same values in another placement); its FSDP units reduce
  their own gradients (wrap the optimizer with
  ``DistributedOptimizer(reduce_gradients=False)``).  ``tensor`` and
  ``expert`` placement for those models is not ported (ROADMAP.md Queue A
  item 7);
* ``seq`` and ``pipe`` axes replicate every parameter, as the rules do
  (the families that shard over them are ``parallel/seq.py`` and
  ``parallel/pipeline.py``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_FSDP, AXIS_TENSOR,
                                             axis_index, axis_sizes,
                                             data_axes)

__all__ = ["SHARDING_RULES", "infer_param_spec", "param_specs",
           "param_shardings", "shard_params", "lm_loss_fn",
           "make_parallel_train_step", "sum_gradients"]

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

_HAND_PLACED_AXES = (AXIS_FSDP, AXIS_TENSOR, AXIS_EXPERT)


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


def param_shardings(model: nn.Module,
                    mesh) -> Dict[str, Tuple[Optional[str], ...]]:
    """The placement :func:`shard_params` gives ``model`` on ``mesh``:
    {parameter name: one mesh axis or None per dimension of the port's
    shape} (the reference returns the matching ``NamedSharding`` tree).
    A ``LlamaModel``'s fused gate/up weight under ``tensor`` holds, on its
    ``tensor`` dimension, the gate half's block then the up half's
    (``parallel/placement.py``)."""
    return param_specs(model, mesh)


def _hand_placed(model: nn.Module, sizes) -> bool:
    from horovod_tpu_torch.models.llama import LlamaModel

    wide = any(sizes.get(a, 1) > 1 for a in _HAND_PLACED_AXES)
    if not isinstance(model, LlamaModel):
        if any(sizes.get(a, 1) > 1 for a in (AXIS_TENSOR, AXIS_EXPERT)):
            raise NotImplementedError(
                f"shard_params: tensor and expert placement is ported for "
                f"LlamaModel only, not {type(model).__name__} (ROADMAP.md "
                "Queue A item 7)")
        return False
    return wide


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` (a ``DeviceMesh`` from
    ``build_mesh``) by the rules; returns the model, placed in place (see
    the module's docstring), or untouched where every axis that shards
    parameters has size 1.  Build the optimizer after this call."""
    sizes = axis_sizes(mesh)
    if _hand_placed(model, sizes):
        if model.placement is None:
            from horovod_tpu_torch.parallel.placement import place
            place(model, mesh)
        return model
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


def lm_loss_fn(model: nn.Module) -> Callable:
    """Next-token cross-entropy on ``tokens`` [B, S+1] (the lse form of
    ``ops/losses.py``), as ``loss_fn(model, tokens)``: the port's steps
    pass the model they run, so ``model`` here only keeps the reference's
    call form."""

    def loss_fn(model, tokens):
        return softmax_cross_entropy(model(tokens[:, :-1]), tokens[:, 1:])

    return loss_fn


def _inner_optimizer(optimizer):
    """The optimizer that steps: a ``DistributedOptimizer`` unwrapped (the
    step reduces the gradients itself, as the reference's GSPMD step
    switches the wrapper's reduction off)."""
    from horovod_tpu_torch.frontend import DistributedOptimizer

    if isinstance(optimizer, DistributedOptimizer):
        return optimizer.inner
    return optimizer


def _check_optimizer(inner) -> None:
    masters = getattr(inner, "masters", None)
    if masters is None:
        return
    for p, m in zip(inner.model_params, masters):
        if p.shape != m.shape:
            raise ValueError(
                "make_parallel_train_step: the optimizer's master weights "
                f"are {tuple(m.shape)} for a parameter placed as "
                f"{tuple(p.shape)}; build the optimizer after shard_params")


@torch.no_grad()
def sum_gradients(params, axes_of: Callable, divisor: float) -> None:
    """Each parameter's gradient summed over the axes ``axes_of(p)`` gives
    (``comm`` axes) and divided by ``divisor``, in place: one flat buffer
    and one allreduce an axis for the gradients that share axes and
    dtype.  A parameter without a gradient gets zeros."""
    groups: Dict[Tuple, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        key = (tuple(id(a) for a in axes_of(p)), p.grad.dtype)
        groups.setdefault(key, (axes_of(p), []))[1].append(p)
    for over, ps in groups.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        for a in over:
            flat = comm.allreduce(flat, a)
        flat /= divisor
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def make_parallel_train_step(model: nn.Module, optimizer, mesh, *,
                             loss_fn: Optional[Callable] = None):
    """``step(tokens) -> loss``: the reference's GSPMD step over ``mesh``
    (a ``DeviceMesh`` from ``build_mesh``).

    ``tokens`` is the GLOBAL batch, the same on every rank, as the
    reference's step takes it; each rank keeps the rows of its index over
    the data-like axes (``data`` outer, ``fsdp`` inner), and ranks that
    differ only in ``tensor``, ``expert``, ``seq`` or ``pipe`` compute on
    the same rows.  The model is placed by :func:`shard_params` if it is
    not yet (before the optimizer steps for the first time).  The step
    zeroes the gradients, runs ``loss_fn(model, rows)`` (default
    :func:`lm_loss_fn`), the backward, sums each gradient over the
    data-like axes (over ``fsdp`` already inside the backward for a
    parameter sharded on it) and divides it by their size, then steps the
    optimizer (a ``DistributedOptimizer`` is unwrapped: it must not
    reduce again).  Gradients of parameters replicated over ``tensor`` or
    ``expert`` are whole on each rank and are not summed over them.
    Returns the global mean loss (fp32, 0-dim).
    """
    from horovod_tpu_torch.models.llama import LlamaModel

    sizes = axis_sizes(mesh)
    if sizes.get(AXIS_FSDP, 1) > 1 and not isinstance(model, LlamaModel):
        raise NotImplementedError(
            f"make_parallel_train_step: an fsdp axis is placed by hand for "
            f"LlamaModel only, not {type(model).__name__}; shard it with "
            "shard_params (FSDP2) and step it with make_train_step "
            "(ROADMAP.md Queue A item 7)")
    loss_fn = loss_fn or lm_loss_fn(model)
    inner = _inner_optimizer(optimizer)
    shard_params(model, mesh)
    _check_optimizer(inner)
    dp = tuple(a for a in data_axes(mesh) if sizes[a] > 1)
    axes = {a: comm.axis_group(mesh, a) for a in dp}
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    index = axis_index(mesh, data_axes(mesh))
    pl = getattr(model, "placement", None)
    params = [p for p in model.parameters() if p.requires_grad]

    def axes_of(p):
        """The data-like axes ``p``'s gradient still has to be summed
        over (``fsdp`` is done inside the backward where ``p`` is sharded
        on it)."""
        done = pl is not None and pl.dim(p, AXIS_FSDP) is not None
        return tuple(axes[a] for a in dp if not (a == AXIS_FSDP and done))

    def step(tokens: torch.Tensor) -> torch.Tensor:
        rows = tokens.shape[0] // n_dp
        if rows * n_dp != tokens.shape[0]:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by the "
                             f"data-like axes' size {n_dp}")
        inner.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens[index * rows:(index + 1) * rows])
        loss.backward()
        if dp:
            sum_gradients(params, axes_of, n_dp)
        inner.step()
        loss = loss.detach().float()
        for a in dp:
            loss = comm.allreduce(loss, axes[a])
        return loss / n_dp

    return step
