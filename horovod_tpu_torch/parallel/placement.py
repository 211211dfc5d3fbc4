"""A ``LlamaModel``'s parameters placed over the ``tensor``, ``expert`` and
``fsdp`` axes of a mesh.

Counterpart of what GSPMD does with the reference's ``shard_params``
placement under ``make_parallel_train_step``: each rank keeps only its
block of each parameter, by ``SHARDING_RULES`` (``api.param_specs``), and
the model's one forward (``models/llama.py``) adds the collectives XLA
would insert, on the axes its :class:`Placement` names.  Tensor
parallelism is built on the Megatron pair of ``parallel/comm.py`` (not
DTensor):

* a parameter sharded over ``fsdp`` is gathered whole for its use
  (:meth:`Placement.weight`; the backward reduce-scatters, so the
  gradient arrives summed over ``fsdp``);
* a column-parallel projection (output features over ``tensor``) takes
  its input through ``comm.copy_to`` (the input's cotangent is summed
  over ``tensor``); a row-parallel one (input features over ``tensor``)
  hands its partial sum to ``comm.reduce_from``; the attention runs on
  each rank's heads where both head counts divide ``tensor``, and on
  gathered heads otherwise;
* the vocabulary: the embedding's rows are split over ``tensor`` (each
  rank looks up its rows, zeros elsewhere, summed over ``tensor``), the
  head's columns too, and its logits are gathered over ``tensor`` whole
  before the loss, so the loss is the reference's on every rank;
* the MoE block routes every token on every rank (the router is
  replicated, its gradient whole on each rank), each ``expert`` rank runs
  its own experts on the tokens routed to them, and the parts are summed
  over ``expert`` (and ``tensor``) in fp32 before the cast.

The fused gate/up projection: the reference splits ``w_gate_up``'s 2F
outputs in halves after the product, so a contiguous ``tensor`` shard of
them would give one rank every gate column and the other every up column.
Where F divides by ``tensor``, each rank holds the gate half's block and
the up half's block instead (``paired``): the rules' dimension and
sizes, another order of the columns inside it.  Where only 2F divides,
the product is gathered over ``tensor`` before the split
(:meth:`Placement.swiglu`).  :func:`full_state_dict` undoes either layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import (AXIS_EXPERT, AXIS_FSDP,
                                             AXIS_TENSOR, axis_sizes)

__all__ = ["Placement", "UNPLACED", "place", "full_state_dict"]


def _is_gate_up(name: str) -> bool:
    return name.endswith(("mlp.w_gate_up.weight", "moe.w_gate_up"))


class Placement:
    """The groups of the placed axes and each parameter's spec (over the
    port's shape) and layout.  The model's modules read from it which of
    their collectives (``parallel/comm.py``) run over which axis; the
    unplaced model's, :data:`UNPLACED`, has every axis None and every
    parameter whole, so each collective returns its input."""

    def __init__(self, mesh=None, specs: Optional[Dict] = None, paired=()):
        sizes = axis_sizes(mesh) if mesh is not None else {}

        def axis(name):
            return (comm.axis_group(mesh, name)
                    if sizes.get(name, 1) > 1 else None)
        self.tensor, self.expert, self.fsdp = (
            axis(AXIS_TENSOR), axis(AXIS_EXPERT), axis(AXIS_FSDP))
        self.specs = specs or {}
        self.paired = set(paired)

    def dim(self, p, axis: str) -> Optional[int]:
        """The dimension of ``p`` split over ``axis``, or None."""
        spec = self.specs.get(p, ())
        return spec.index(axis) if axis in spec else None

    def weight(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p`` as its use needs it: whole over ``fsdp``."""
        d = self.dim(p, AXIS_FSDP)
        return p if d is None else comm.gather_shards(p, self.fsdp, d)

    def tensor_at(self, p, d: int):
        """The ``tensor`` group where dimension ``d`` of ``p`` is split
        over it, else None."""
        return self.tensor if self.dim(p, AXIS_TENSOR) == d else None

    def swiglu(self, p_gate_up, p_down):
        """The ``tensor`` group, or None, at each step of a SwiGLU on these
        weights: where its input enters column-split work, where the
        gate/up product is gathered whole before its split (a layout that
        is not ``paired``), where the activation is cut back after, and
        where the output's partial sums leave."""
        col, row = (self.tensor if self.dim(p, AXIS_TENSOR) is not None
                    else None for p in (p_gate_up, p_down))
        widen = None if p_gate_up in self.paired else col
        return col, widen, row if widen else None, row


#: The placement of a model on one rank.
UNPLACED = Placement()


def _sizes_and_coords(mesh):
    sizes = axis_sizes(mesh)
    return sizes, {a: mesh.get_local_rank(a) for a in sizes}


def place(model, mesh) -> Placement:
    """Cut each parameter of ``model`` (a ``LlamaModel`` holding whole
    parameters) to this rank's block, in place (``p.data``: the
    ``Parameter`` objects stay, so an optimizer built over them before
    keeps them, but its state must not exist yet), and hand the model's
    modules the placement.  Returns the placement."""
    from horovod_tpu_torch.parallel.api import param_specs

    sizes, coords = _sizes_and_coords(mesh)
    specs, paired = {}, set()
    F_ = model.config.intermediate_size
    t = sizes.get(AXIS_TENSOR, 1)
    for name, spec in param_specs(model, mesh).items():
        p = model.get_parameter(name)
        block = p.data
        pair = _is_gate_up(name) and AXIS_TENSOR in spec and F_ % t == 0
        for d, a in enumerate(spec):
            if a is None:
                continue
            n, i = sizes[a], coords[a]
            if a == AXIS_TENSOR and pair:
                block = torch.cat([h.chunk(n, d)[i]
                                   for h in block.chunk(2, d)], d)
            else:
                block = block.chunk(n, d)[i]
        p.data = block.contiguous().clone()
        specs[p] = spec
        if pair:
            paired.add(p)
    pl = Placement(mesh, specs, paired)
    for mod in model.modules():
        if hasattr(type(mod), "placement"):
            mod.placement = pl
    return pl


@torch.no_grad()
def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The whole parameters of a placed model (every rank gets them; a
    model never placed gives its own tensors), by name, as
    ``LlamaModel.state_dict()`` would hold them on one rank."""
    pl = model.placement
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if pl is not None:
            for d, a in enumerate(pl.specs.get(p, ())):
                if a is None:
                    continue
                axis = {AXIS_TENSOR: pl.tensor, AXIS_EXPERT: pl.expert,
                        AXIS_FSDP: pl.fsdp}[a]
                parts = comm._all_gather(t, axis, d).chunk(axis.size, d)
                if a == AXIS_TENSOR and p in pl.paired:
                    halves = [part.chunk(2, d) for part in parts]
                    t = torch.cat([h[0] for h in halves]
                                  + [h[1] for h in halves], d)
                else:
                    t = torch.cat(parts, d)
        out[name] = t.clone()
    return out
