"""Parameter sharding over a named mesh and the GSPMD-style train step:
the reference's rules, applied by hand.

Counterpart of ``horovod_tpu/parallel/api.py``: :data:`SHARDING_RULES`,
:func:`infer_param_spec`, :func:`shard_params`, :func:`param_shardings`,
:func:`lm_loss_fn` and :func:`make_parallel_train_step`.  The reference
annotates each parameter with a ``NamedSharding`` and lets GSPMD insert
the collectives; here:

* the same regexes run over each parameter's path in the reference's
  tree and give the reference's spec over the reference's shape, which
  is laid onto the port's dimensions (:func:`param_specs`).  The path
  and the layout come from ``models/convert.py`` (:func:`~horovod_tpu_
  torch.models.convert.flax_layout`): ``encoder.layers.0.attention.qkv.
  weight`` is ``params/encoder/layer_0/attention/qkv/kernel``, a
  ``Linear`` weight ``[out, in]`` is the reference's ``[in, out]``
  kernel, and a ResNet's ``blocks.3.convs.1.weight`` (OIHW) is
  ``params/BottleneckBlock_3/Conv_1/kernel`` (HWIO), so the rules' conv
  ``tensor`` dimension, the kernel's out-channels, falls on the port's
  dimension 0.  A module the converter does not know gets its dotted
  name as its path (a ``Linear`` weight a transposed ``kernel``);
* a ``LlamaModel`` (dense or MoE), a ``BertForPretraining`` or a
  ``ResNet`` on a mesh whose ``fsdp``, ``tensor`` or ``expert`` axis is
  larger than 1 (a ResNet also when ``data`` is: its BatchNorm reads the
  global batch) is placed by hand (``parallel/placement.py``): each rank
  keeps its block of each parameter and the forward adds the collectives
  (the Megatron pair for ``tensor``, an allgather with a reduce-scatter
  backward for ``fsdp``, a sum of the experts' parts for ``expert``, and
  a ResNet's BatchNorm statistics summed over the data-like axes);
* any other module on such a mesh is placed by the same rules and
  gathered for use (``placement._gather_for_use``): each rank keeps its
  block of each parameter the rules shard, the model's forward reads it
  whole (the ``fsdp`` gather's backward reduce-scatters; a ``tensor`` or
  ``expert`` gather's keeps this rank's slice, the compute being
  replicated over those ranks), and what the rules replicate stays whole;
* ``seq`` and ``pipe`` axes replicate every parameter, as the rules do
  (the families that shard over them are ``parallel/seq.py`` and
  ``parallel/pipeline.py``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from horovod_tpu_torch.ops.collective_ops import in_step
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_FSDP, AXIS_TENSOR,
                                             axis_index, axis_sizes,
                                             data_axes, use_mesh)

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

_PLACED_AXES = (AXIS_FSDP, AXIS_TENSOR, AXIS_EXPERT)


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


def _generic_path(name: str, module: nn.Module,
                  param_name: str) -> Tuple[str, Tuple[int, ...]]:
    """(a path for the rules, the flax dimension of each port dimension)
    of a parameter of a module ``models/convert.py`` does not know: its
    dotted name, a ``Linear`` weight a transposed ``kernel``, an
    ``Embedding`` weight an ``embedding``."""
    leaf, dims = param_name, None
    if isinstance(module, nn.Linear) and param_name == "weight":
        leaf, dims = "kernel", (1, 0)
    elif isinstance(module, nn.Embedding):
        leaf = "embedding"
    parts = name.split(".") if name else []
    return "/".join(["params"] + parts + [leaf]), dims


def _reference_layout(model: nn.Module) -> Dict[str, Tuple[str, Tuple]]:
    """{port parameter name: (its path in the reference's tree, the flax
    dimension of each port dimension or None for the same order)}."""
    from horovod_tpu_torch.models.convert import flax_layout

    names = [n for n, _ in model.named_parameters()]
    layout = flax_layout(getattr(model, "config", None),
                         "encoder.type_emb.weight" in names)
    if layout is not None and all(n in layout for n in names):
        return {n: layout[n] for n in names}
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            out[f"{mod_name}.{p_name}" if mod_name else p_name] = \
                _generic_path(mod_name, mod, p_name)
    return out


def param_specs(model: nn.Module,
                mesh) -> Dict[str, Tuple[Optional[str], ...]]:
    """{port parameter name: spec over the port's shape}: the reference's
    spec for the same parameter, each mesh axis on the port dimension that
    holds the reference's (a ``Linear`` weight's spec reversed, a conv
    weight's out-channels on dimension 0)."""
    layout = _reference_layout(model)
    out = {}
    for name, p in model.named_parameters():
        path, dims = layout[name]
        dims = dims or tuple(range(p.dim()))
        ref_shape = [0] * p.dim()
        for d, j in enumerate(dims):
            ref_shape[j] = p.shape[d]
        spec = infer_param_spec(path, tuple(ref_shape), mesh)
        out[name] = tuple(spec[j] for j in dims) if spec else ()
    return out


def param_shardings(model: nn.Module,
                    mesh) -> Dict[str, Tuple[Optional[str], ...]]:
    """The placement :func:`shard_params` gives ``model`` on ``mesh``:
    {parameter name: one mesh axis or None per dimension of the port's
    shape} (the reference returns the matching ``NamedSharding`` tree).
    Two fused weights hold their ``tensor`` block in another order inside
    the rules' dimension (``parallel/placement.py``): a ``LlamaModel``'s
    gate/up weight the gate half's block then the up half's, a
    ``BertForPretraining``'s ``qkv`` its heads' block of q, of k and of
    v."""
    return param_specs(model, mesh)


def _placed(model: nn.Module, sizes) -> bool:
    """Whether :func:`shard_params` places ``model`` on a mesh of these
    axis sizes (``parallel/placement.py``): an axis that shards parameters
    is larger than 1 (for a ResNet, ``data`` too)."""
    from horovod_tpu_torch.models.resnet import ResNet

    axes = _PLACED_AXES
    if isinstance(model, ResNet):
        # BatchNorm over the global batch: data-parallel ranks share the
        # statistics too.
        axes = axes + (AXIS_DATA,)
    return any(sizes.get(a, 1) > 1 for a in axes)


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` (a ``DeviceMesh`` from
    ``build_mesh``) by the rules; returns the model, placed in place (see
    the module's docstring), or untouched where every axis that shards
    parameters has size 1, or where the rules shard none of a module's
    parameters that no hand placement covers.  Build the optimizer after
    this call."""
    if getattr(model, "placement", None) is None and \
            _placed(model, axis_sizes(mesh)):
        from horovod_tpu_torch.parallel.placement import place
        place(model, mesh)
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
    switches the wrapper's reduction off; its FSDP rung is never
    built)."""
    from horovod_tpu_torch.frontend import DistributedOptimizer

    if isinstance(optimizer, DistributedOptimizer):
        return optimizer.release_inner()
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


def _tensor_leaves(batch) -> list:
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (tuple, list)):
        return [t for b in batch for t in _tensor_leaves(b)]
    return []


def _rows(batch, lo: int, hi: int):
    """Rows ``lo:hi`` of every tensor of ``batch`` (a tensor, or a tuple,
    named tuple, list or dict of them; other leaves, such as None or a
    number, kept as they are)."""
    if isinstance(batch, torch.Tensor):
        return batch[lo:hi]
    if isinstance(batch, dict):
        return type(batch)((k, _rows(v, lo, hi)) for k, v in batch.items())
    if isinstance(batch, (tuple, list)):
        parts = [_rows(b, lo, hi) for b in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") \
            else type(batch)(parts)
    return batch


def make_parallel_train_step(model: nn.Module, optimizer, mesh, *,
                             loss_fn: Optional[Callable] = None):
    """``step(batch) -> loss``: the reference's GSPMD step over ``mesh``
    (a ``DeviceMesh`` from ``build_mesh``).

    ``batch`` is the GLOBAL batch, the same on every rank, as the
    reference's step takes it: a tensor, or a tuple (named tuples too),
    list or dict of tensors whose dimension 0 is the global batch (other
    leaves pass unchanged).  Each rank keeps the rows of its index over
    the data-like axes (``data`` outer, ``fsdp`` inner), and ranks that
    differ only in ``tensor``, ``expert``, ``seq`` or ``pipe`` compute on
    the same rows.  The model is placed by :func:`shard_params` if it is
    not yet (before the optimizer steps for the first time).  The step
    zeroes the gradients, runs ``loss_fn(model, rows)`` (default
    :func:`lm_loss_fn` on a tokens tensor), the backward, sums each
    gradient over the data-like axes (over ``fsdp`` already inside the
    backward for a parameter sharded on it) and divides it by their size,
    then steps the optimizer (a ``DistributedOptimizer`` is unwrapped: it
    must not reduce again).  ``loss_fn`` returns the mean over its rows,
    so the ranks' mean is the global batch's loss (a loss normalised by a
    global count divides by that count over the data-like size).
    Gradients of parameters replicated over ``tensor`` or ``expert`` are
    whole on each rank and are not summed over them.  Returns the global
    mean loss (fp32, 0-dim).

    While ``loss_fn`` runs, ``mesh`` is the mesh in use and
    ``hvd.allreduce`` and the other collectives are the device plane over
    its data-like axes unless given another ``axis_name`` (the
    reference's traced branch).
    """
    sizes = axis_sizes(mesh)
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

    def step(batch) -> torch.Tensor:
        leaves = _tensor_leaves(batch)
        if not leaves:
            raise ValueError("make_parallel_train_step: the batch holds no "
                             "tensor")
        size = leaves[0].shape[0]
        if any(t.shape[0] != size for t in leaves):
            raise ValueError(f"batch tensors of {[t.shape[0] for t in leaves]}"
                             " rows: every leaf's dimension 0 is the global "
                             "batch")
        rows = size // n_dp
        if rows * n_dp != size:
            raise ValueError(f"batch {size} not divisible by the "
                             f"data-like axes' size {n_dp}")
        inner.zero_grad(set_to_none=True)
        with use_mesh(mesh), in_step(data_axes(mesh)):
            loss = loss_fn(model, _rows(batch, index * rows,
                                        (index + 1) * rows))
        loss.backward()
        if dp:
            sum_gradients(params, axes_of, n_dp)
        inner.step()
        loss = loss.detach().float()
        for a in dp:
            loss = comm.allreduce(loss, axes[a])
        return loss / n_dp

    return step
