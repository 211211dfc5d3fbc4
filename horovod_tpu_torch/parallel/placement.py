"""A model's parameters placed over the ``tensor``, ``expert`` and
``fsdp`` axes of a mesh: by hand for a ``LlamaModel``, a
``BertForPretraining`` or a ``ResNet``, gathered for use for any other
module.

Counterpart of what GSPMD does with the reference's ``shard_params``
placement under ``make_parallel_train_step``: each rank keeps only its
block of each parameter, by ``SHARDING_RULES`` (``api.param_specs``).

Any other module (``MnistConvNet``, a user's ``head`` / ``wq`` /
``mlp_in`` ``Linear``) runs its own forward, which knows nothing of the
mesh, so it is placed by **gather for use** (:func:`place` without hand
placement): each parameter the rules shard is read whole by the forward
(:meth:`Placement.whole`, swapped in by a pre-forward hook on the model
and swapped back after it).  Its ``fsdp`` gather's backward
reduce-scatters, so each block's gradient arrives summed over ``fsdp``
(whose ranks saw different rows); a ``tensor`` or ``expert`` gather's
backward keeps this rank's slice of a gradient the axis's ranks computed
alike, as the compute is replicated over them (a replicated GSPMD
program's is too).  What the rules replicate stays whole on every rank.
A module that reads a parameter outside its forward, or a forward that
mixes rows (BatchNorm normalises over this rank's rows here), is outside
what this placement promises.

The three hand-placed models' one forward (``models/llama.py``,
``models/bert.py``, ``models/resnet.py``) instead adds the collectives
XLA would insert, on the axes its :class:`Placement` names.  Tensor
parallelism is built on the Megatron pair of ``parallel/comm.py`` (not
DTensor):

* a parameter sharded over ``fsdp`` is gathered whole for its use
  (:meth:`Placement.weight`; the backward reduce-scatters, so the
  gradient arrives summed over ``fsdp``);
* a column-parallel projection (output features over ``tensor``) takes
  its input through ``comm.copy_to`` (the input's cotangent is summed
  over ``tensor``); a row-parallel one (input features over ``tensor``)
  hands its partial sum to ``comm.reduce_from`` and adds its own bias
  once after it; the attention runs on each rank's heads where the head
  counts divide ``tensor``, and on gathered heads otherwise;
* a replicated parameter used on a split activation — the bias of a
  column-parallel projection, BERT's ``mlm_bias`` on vocabulary-split
  logits, a BatchNorm's scale and bias on channel-split activations — is
  cut to this rank's part through ``comm.split`` (a fused layout's
  through :meth:`Placement.column_part`), whose backward gathers the
  parts' gradients: the gradient is whole on every rank, as the rules'
  replication wants;
* the vocabulary: the embedding's rows are split over ``tensor`` (each
  rank looks up its rows, zeros elsewhere, summed over ``tensor``), the
  head's columns too, and its logits are gathered over ``tensor`` whole
  before the loss, so the loss is the reference's on every rank;
* a ResNet's convolutions are split on their out-channels, so its
  activations are split on channels: each convolution reads them
  gathered whole (``comm.gather_shards``), and BatchNorm, ReLU, the
  residual add and the pooling run on the slice; its BatchNorm sums each
  channel's statistics over the data-like axes (:attr:`Placement.batch`,
  ``comm.psum``), as the reference's one program normalises over the
  global batch;
* the MoE block routes every token on every rank (the router is
  replicated, its gradient whole on each rank), each ``expert`` rank runs
  its own experts on the tokens routed to them, and the parts are summed
  over ``expert`` (and ``tensor``) in fp32 before the cast.

Two fused weights are split after their product in the reference, so a
contiguous ``tensor`` block of their outputs would not hold whole parts:
``w_gate_up``'s 2F outputs are a gate and an up half, ``qkv``'s 3H are q,
k and v (each heads-major).  Where the parts divide by ``tensor`` (F for
gate/up; the heads for ``qkv``), each rank holds its block of each part
in turn (:attr:`Placement.parts`): the rules' dimension and sizes,
another order inside it, and ``qkv``'s bias is cut the same way.
Otherwise the product is gathered over ``tensor`` before the split
(:meth:`Placement.swiglu`; BERT's attention then runs every head and
keeps the slice of its output the row-parallel ``proj`` reads).
:func:`full_state_dict` undoes either layout, and the generic blocks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_FSDP, AXIS_TENSOR,
                                             axis_sizes)

__all__ = ["Placement", "UNPLACED", "place", "hand_placed",
           "full_state_dict"]


def _parts(model, name: str, spec, sizes) -> int:
    """How many parts of a fused weight the ``tensor`` block of ``name``
    holds one after another: 2 for a Llama gate/up weight whose F divides
    by ``tensor``, 3 for a BERT ``qkv`` weight whose heads do, else 1."""
    from horovod_tpu_torch.models.bert import BertForPretraining

    t = sizes.get(AXIS_TENSOR, 1)
    if AXIS_TENSOR not in spec:
        return 1
    if isinstance(model, BertForPretraining):
        qkv = name.endswith("attention.qkv.weight")
        return 3 if qkv and model.config.num_heads % t == 0 else 1
    gate_up = name.endswith(("mlp.w_gate_up.weight", "moe.w_gate_up"))
    return 2 if gate_up and model.config.intermediate_size % t == 0 else 1


class Placement:
    """The groups of the placed axes and each parameter's spec (over the
    port's shape) and layout.  The model's modules read from it which of
    their collectives (``parallel/comm.py``) run over which axis; the
    unplaced model's, :data:`UNPLACED`, has every axis None and every
    parameter whole, so each collective returns its input."""

    def __init__(self, mesh=None, specs: Optional[Dict] = None,
                 parts: Optional[Dict] = None):
        sizes = axis_sizes(mesh) if mesh is not None else {}

        def axis(name):
            return (comm.axis_group(mesh, name)
                    if sizes.get(name, 1) > 1 else None)
        self.tensor, self.expert, self.fsdp = (
            axis(AXIS_TENSOR), axis(AXIS_EXPERT), axis(AXIS_FSDP))
        #: The data-like axes larger than 1, over which the ranks' rows
        #: differ (``data`` outer, ``fsdp`` inner).
        self.batch = tuple(a for a in (axis(AXIS_DATA), self.fsdp) if a)
        self.specs = specs or {}
        #: {parameter: k} for a fused weight whose ``tensor`` block holds
        #: its block of each of k parts in turn.
        self.parts = dict(parts or {})

    def dim(self, p, axis: str) -> Optional[int]:
        """The dimension of ``p`` split over ``axis``, or None."""
        spec = self.specs.get(p, ())
        return spec.index(axis) if axis in spec else None

    def weight(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p`` as its use needs it: whole over ``fsdp``."""
        d = self.dim(p, AXIS_FSDP)
        return p if d is None else comm.gather_shards(p, self.fsdp, d)

    def whole(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p`` whole for a forward that does not know the mesh: gathered
        over ``fsdp`` first (backward: the reduce-scatter of
        :meth:`weight`), then over ``tensor`` and ``expert`` (backward:
        this rank's slice, the axis's ranks having computed the same
        gradient)."""
        spec = self.specs.get(p, ())
        t = self.weight(p)
        for d, a in enumerate(spec):
            if a in (AXIS_TENSOR, AXIS_EXPERT):
                t = comm.gather(t, self.tensor if a == AXIS_TENSOR
                                else self.expert, d)
        return t

    def tensor_at(self, p, d: int):
        """The ``tensor`` group where dimension ``d`` of ``p`` is split
        over it, else None."""
        return self.tensor if self.dim(p, AXIS_TENSOR) == d else None

    def column_part(self, bias: torch.Tensor, weight) -> torch.Tensor:
        """The part of ``bias`` (replicated) that goes with this rank's
        output block of the column-parallel ``weight`` (its dimension 0
        split over ``tensor``), in ``weight``'s layout."""
        col = self.tensor_at(weight, 0)
        k = self.parts.get(weight, 1)
        if col is None or k == 1:
            return comm.split(bias, col, 0)
        return comm.split(bias.view(k, -1), col, 1).reshape(-1)

    def swiglu(self, p_gate_up, p_down):
        """The ``tensor`` group, or None, at each step of a SwiGLU on these
        weights: where its input enters column-split work, where the
        gate/up product is gathered whole before its split (a layout that
        does not hold the halves' blocks in turn), where the activation is
        cut back after, and where the output's partial sums leave."""
        col, row = (self.tensor if self.dim(p, AXIS_TENSOR) is not None
                    else None for p in (p_gate_up, p_down))
        widen = None if p_gate_up in self.parts else col
        return col, widen, row if widen else None, row


#: The placement of a model on one rank.
UNPLACED = Placement()


def _sizes_and_coords(mesh):
    sizes = axis_sizes(mesh)
    return sizes, {a: mesh.get_local_rank(a) for a in sizes}


def hand_placed(model) -> bool:
    """Whether ``model``'s forward places itself (``LlamaModel``,
    ``BertForPretraining``, ``ResNet``)."""
    from horovod_tpu_torch.models.bert import BertForPretraining
    from horovod_tpu_torch.models.llama import LlamaModel
    from horovod_tpu_torch.models.resnet import ResNet

    return isinstance(model, (LlamaModel, BertForPretraining, ResNet))


def place(model, mesh) -> Optional[Placement]:
    """Cut each parameter of ``model`` (holding whole parameters) to this
    rank's block, in place (``p.data``: the ``Parameter`` objects stay, so
    an optimizer built over them before keeps them, but its state must not
    exist yet), and hand the model's modules the placement: a
    ``LlamaModel``, ``BertForPretraining`` or ``ResNet`` by hand, any
    other module through :func:`_gather_for_use` (None, and the model
    untouched, where the rules shard none of its parameters).  Buffers (a
    ResNet's running statistics) stay whole.  Returns the placement;
    raises for a ResNet whose convolutions ``tensor`` splits only in part
    (the channel counts that do not divide by it), a layout no forward
    here runs."""
    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.parallel.api import param_specs

    hand = hand_placed(model)
    all_specs = param_specs(model, mesh)
    if not hand and not any(any(spec) for spec in all_specs.values()):
        return None
    sizes, coords = _sizes_and_coords(mesh)
    specs, parts = {}, {}
    if isinstance(model, ResNet):
        split = {AXIS_TENSOR in spec for name, spec in all_specs.items()
                 if name.endswith("weight") and name != "head.weight"}
        if len(split) > 1:
            raise NotImplementedError(
                f"place: tensor {sizes[AXIS_TENSOR]} divides some of the "
                "ResNet's convolution widths and not others; the forward "
                "splits every one or none")
    for name, spec in all_specs.items():
        if not hand and not any(spec):
            continue
        p = model.get_parameter(name)
        block = p.data
        k = _parts(model, name, spec, sizes) if hand else 1
        for d, a in enumerate(spec):
            if a is None:
                continue
            n, i = sizes[a], coords[a]
            if a == AXIS_TENSOR and k > 1:
                block = torch.cat([h.chunk(n, d)[i]
                                   for h in block.chunk(k, d)], d)
            else:
                block = block.chunk(n, d)[i]
        p.data = block.contiguous().clone()
        specs[p] = spec
        if k > 1:
            parts[p] = k
    pl = Placement(mesh, specs, parts)
    if not hand:
        _gather_for_use(model, pl)
        return pl
    for mod in model.modules():
        if hasattr(type(mod), "placement"):
            mod.placement = pl
    return pl


def _gather_for_use(model, pl: Placement) -> None:
    """Set ``model.placement`` and hook its forward: before it, each
    parameter ``pl`` shards is swapped for :meth:`Placement.whole` of it in
    its owning modules (once a forward, where modules share it); after it,
    even one that raised, the block is swapped back, so
    ``named_parameters``, the optimizer and ``full_state_dict`` see the
    blocks."""
    owned = [(mod, name, p) for mod in model.modules()
             for name, p in mod.named_parameters(recurse=False)
             if p in pl.specs]

    def gather(_module, _args):
        whole = {}
        for mod, name, p in owned:
            if id(p) not in whole:
                whole[id(p)] = pl.whole(p)
            mod._parameters[name] = whole[id(p)]

    def restore(_module, _args, _output):
        for mod, name, p in owned:
            mod._parameters[name] = p

    model.placement = pl
    model.register_forward_pre_hook(gather)
    model.register_forward_hook(restore, always_call=True)


@torch.no_grad()
def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The whole parameters of a placed model (every rank gets them; a
    model never placed gives its own tensors), by name, as the model's
    ``state_dict()`` would hold them on one rank (its buffers, whole on
    every rank, are not listed)."""
    pl = getattr(model, "placement", None)
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if pl is not None:
            for d, a in enumerate(pl.specs.get(p, ())):
                if a is None:
                    continue
                axis = {AXIS_TENSOR: pl.tensor, AXIS_EXPERT: pl.expert,
                        AXIS_FSDP: pl.fsdp}[a]
                blocks = comm._all_gather(t, axis, d).chunk(axis.size, d)
                k = pl.parts.get(p, 1) if a == AXIS_TENSOR else 1
                pieces = [b.chunk(k, d) for b in blocks]
                t = torch.cat([b[j] for j in range(k) for b in pieces], d)
        out[name] = t.clone()
    return out
