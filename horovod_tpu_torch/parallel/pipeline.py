"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.

Counterpart of ``horovod_tpu/parallel/pipeline.py``.  The layer stack is
split into ``pipe`` contiguous stages and each rank holds only its own
stage's layers (:func:`init_pipelined_llama`); the batch is cut into
microbatches that flow stage ``i`` -> ``i + 1``.

The reference runs one SPMD program on every stage, so its stages compute
on garbage in the bubble steps and mask it out; here each rank runs its
own schedule and computes only real microbatches:
:func:`pipeline_apply` runs every microbatch's forward through the stage
(receiving from the stage before, sending to the one after), keeps each
microbatch's graph (GPipe: all activations live until the backward), and
gives every stage the last stage's output (the broadcast from the last
stage).  Its backward is written out, as the reference pins its own vjp
for that broadcast (``_broadcast_from_last``): only the last stage takes
the output's cotangent (the replicas' cotangents are the same loss's, not
parts to sum, so summing them would multiply every stage's gradient by
the stage count), then the cotangents run back through the stages in
microbatch order, each stage's parameter gradients summed over its
microbatches.

The pipelined step's ZeRO rung (:class:`_ZeroRung`): with
``DistributedOptimizer(inner, fsdp=True)`` on a mesh whose ``fsdp`` axis
is larger than 1, the inner optimizer's state is sharded over ``fsdp`` by
the reference's ``_fsdp_state_spec`` rule on the reference's leaf (its
stage-stacked ``[pipe, L/pipe, ...]`` layers, its ``[in, out]`` kernels):
keep the stage dimension, shard the first dimension ``fsdp`` divides,
keep scalars and leaves it divides nowhere whole.  Each ``fsdp`` rank
steps only its block of each such leaf (whole layers of its stage where
``fsdp`` divides their count, else its block of each parameter), with
state of the block's size, then the blocks are gathered over ``fsdp`` so
every rank holds the whole parameters for the next forward: the
allgather half GSPMD inserts around the reference's update.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.api import _inner_optimizer, sum_gradients
from horovod_tpu_torch.parallel.mesh import (AXIS_FSDP, axis_index,
                                             axis_sizes, data_axes,
                                             default_mesh)

__all__ = ["pipeline_apply", "stack_pytrees", "unstack_pytree",
           "init_pipelined_llama", "make_pipelined_llama_train_step",
           "PipelinedLlama"]


def stack_pytrees(trees: Sequence[Mapping]) -> Dict:
    """Stack identically keyed (nested) dicts of tensors along a new
    leading dim: per-layer state dicts -> one stacked state dict."""
    first = trees[0]
    return {k: (stack_pytrees([t[k] for t in trees])
                if isinstance(first[k], Mapping)
                else torch.stack([t[k] for t in trees]))
            for k in first}


def unstack_pytree(tree: Mapping, n: int) -> List[Dict]:
    """The inverse of :func:`stack_pytrees`: ``n`` dicts of slices."""
    return [{k: (unstack_pytree(v, n)[i] if isinstance(v, Mapping)
                 else v[i]) for k, v in tree.items()} for i in range(n)]


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, Mapping) else [v])
    return out


class _Pipeline(torch.autograd.Function):
    """Outputs of the last stage on every stage; the stage parameters are
    the inputs after ``x`` so that their gradients return here."""

    @staticmethod
    def forward(ctx, stage_fn, stage_params, axis, n_micro, x, *leaves):
        n, i = axis.size, axis.index
        micro = x.detach().chunk(n_micro)
        ins, outs = [], []
        with torch.enable_grad():
            for m in range(n_micro):
                inp = (micro[m] if i == 0 else
                       comm.recv(micro[m], axis, i - 1))
                inp = inp.detach().requires_grad_(x.requires_grad or i > 0)
                out = stage_fn(stage_params, inp)
                if i < n - 1:
                    comm.send(out.detach(), axis, i + 1)
                ins.append(inp)
                outs.append(out)
        last = (torch.cat([o.detach() for o in outs]) if i == n - 1
                else torch.empty_like(x))
        ctx.state = (axis, ins, outs, leaves)
        return comm.broadcast(last, axis, n - 1)

    @staticmethod
    def backward(ctx, g):
        axis, ins, outs, leaves = ctx.state
        n, i = axis.size, axis.index
        grads = [None] * len(leaves)
        gx = []
        cots = g.chunk(len(outs)) if i == n - 1 else None
        for m, (inp, out) in enumerate(zip(ins, outs)):
            cot = cots[m] if cots is not None else comm.recv(out, axis, i + 1)
            wrt = list(leaves) + ([inp] if inp.requires_grad else [])
            got = torch.autograd.grad(out, wrt, cot, allow_unused=True)
            for j, gl in enumerate(got[:len(leaves)]):
                if gl is not None:
                    grads[j] = gl if grads[j] is None else grads[j] + gl
            g_in = got[len(leaves)] if inp.requires_grad else None
            if i > 0:
                comm.send(g_in, axis, i - 1)
            gx.append(g_in if g_in is not None else torch.zeros_like(inp))
        ctx.state = None
        dx = torch.cat(gx) if i == 0 else torch.zeros_like(g)
        return (None, None, None, None, dx, *grads)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   axis_name: str = "pipe", n_microbatches: int,
                   mesh=None) -> torch.Tensor:
    """Run ``x`` [B, ...] through the pipeline over ``axis_name`` of
    ``mesh`` (default: the default mesh) and return the last stage's
    output [B, ...] on every stage.  ``stage_fn(stage_params, x_mb)``
    applies this rank's stage to a microbatch (shape-preserving, the
    homogeneous-stage constraint); ``stage_params`` is a (nested) dict of
    the tensors it uses, whose gradients the backward fills.  Only stage
    0 reads ``x`` (and gets its gradient)."""
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         "microbatches")
    axis = comm.axis_group(mesh if mesh is not None else default_mesh(),
                           axis_name)
    return _Pipeline.apply(stage_fn, stage_params, axis, n_microbatches, x,
                           *_leaves(stage_params))


# ---------------------------------------------------------------------------
# Pipelined Llama
# ---------------------------------------------------------------------------

class PipelinedLlama(nn.Module):
    """One stage of a pipelined ``LlamaModel``: ``layers`` holds layers
    ``stage * L/n ... (stage + 1) * L/n - 1`` of the stack (local names
    ``layers.<j>``), and every stage holds the embedding, the final norm
    and the head (the reference's replicated ``rest``)."""

    def __init__(self, cfg, stage: int, n_stages: int, device=None,
                 attention_fn: Callable = None):
        from horovod_tpu_torch.models.llama import (LlamaLayer, RMSNorm,
                                                    causal_attention)

        super().__init__()
        if cfg.num_layers % n_stages != 0:
            raise ValueError(f"{cfg.num_layers} layers not divisible into "
                             f"{n_stages} stages")
        self.config, self.stage, self.n_stages = cfg, stage, n_stages
        fn = attention_fn or causal_attention
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                    device=device, dtype=cfg.dtype)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, fn)
            for _ in range(cfg.num_layers // n_stages))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                              device, cfg.fused_rmsnorm)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 device=device, dtype=cfg.logits_dtype)

    def global_name(self, name: str) -> str:
        """``LlamaModel``'s name of this stage's parameter ``name``."""
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(self.stage * len(self.layers) + int(parts[1]))
        return ".".join(parts)


def init_pipelined_llama(cfg, params, n_stages: int, *, stage=None,
                         mesh=None, pipe_axis: str = "pipe",
                         attention_fn: Callable = None,
                         device=None) -> PipelinedLlama:
    """This rank's stage of a pipelined Llama: ``params`` is a whole
    ``LlamaModel`` state dict (``models/convert``: ``init_params`` or
    ``params_from_jax``) or an int seed for ``init_params``; ``stage``
    defaults to this rank's index on ``pipe_axis`` of ``mesh`` (default:
    the default mesh).  Only the stage's layers are kept, on ``device``
    (default: where the given tensors are; for a seed, the card)."""
    from horovod_tpu_torch.common.device import resolve_device
    from horovod_tpu_torch.models.convert import init_params

    if stage is None:
        stage = (mesh if mesh is not None else default_mesh()
                 ).get_local_rank(pipe_axis)
    if isinstance(params, int):
        params = init_params(cfg, params, resolve_device(device))
    elif device is None:
        device = next(iter(params.values())).device
    device = resolve_device(device)
    model = PipelinedLlama(cfg, stage, n_stages, "meta", attention_fn)
    state = {n: params[model.global_name(n)].to(device)
             for n, _ in model.named_parameters()}
    model.load_state_dict(state, strict=True, assign=True)
    return model


class _ZeroRung:
    """The inner optimizer's state sharded over ``fsdp`` for a
    :class:`PipelinedLlama` (see the module's docstring).  Built at the
    first step, before the optimizer has state: each sharded leaf's
    parameters leave the optimizer's groups and one block parameter of
    this rank takes their place; :meth:`step` hands each block its part
    of the reduced gradients, steps the optimizer and gathers the blocks
    back into the whole parameters."""

    def __init__(self, model: PipelinedLlama, inner, axis):
        from horovod_tpu_torch.models.convert import flax_layout

        self.axis, self.inner = axis, inner
        f, per = axis.size, len(model.layers)
        layout = flax_layout(model.config)
        #: [(members, dim, block)]: ``dim`` is the sharded dimension of
        #: the members stacked on a new dimension 0 (0: whole layers).
        self.leaves = []
        by_layer: Dict[str, List[nn.Parameter]] = {}
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                by_layer.setdefault(".".join(parts[2:]), []).append(p)
            else:
                self._add([p], _state_dim(p, layout[name][1], f,
                                          model.n_stages))
        for local, members in by_layer.items():
            if per >= f and per % f == 0:
                self._add(members, 0)
                continue
            ref = layout[model.global_name(f"layers.0.{local}")][1]
            dim = _state_dim(members[0], ref, f)
            for p in members:
                self._add([p], dim)
        sharded = {id(p): i for i, leaf in enumerate(self.leaves)
                   for p in leaf[0]}
        placed = set()
        for group in inner.param_groups:
            kept, here = [], set()
            for p in group["params"]:
                if p in inner.state:
                    raise ValueError(
                        "make_pipelined_llama_train_step: the optimizer has "
                        "state already; build it before the first step")
                i = sharded.get(id(p))
                if i is None:
                    kept.append(p)
                elif i not in here:
                    if i in placed:
                        raise ValueError(
                            "make_pipelined_llama_train_step: the layers' "
                            "parameters of one name in several param "
                            "groups")
                    here.add(i)
                    kept.append(self.leaves[i][2])
            placed |= here
            group["params"] = kept

    def _add(self, members, dim):
        if dim is None:
            return
        f, k = self.axis.size, self.axis.index
        if dim == 0:
            n = len(members) // f
            block = torch.stack([p.detach() for p in
                                 members[k * n:(k + 1) * n]])
        else:
            block = members[0].detach().chunk(f, dim - 1)[k]
        self.leaves.append((members, dim,
                            nn.Parameter(block.clone().contiguous())))

    @torch.no_grad()
    def step(self) -> None:
        f, k = self.axis.size, self.axis.index
        for members, dim, block in self.leaves:
            if dim == 0:
                n = len(members) // f
                block.grad = torch.stack([p.grad for p in
                                          members[k * n:(k + 1) * n]])
            else:
                block.grad = members[0].grad.chunk(f, dim - 1)[k].contiguous()
        self.inner.step()
        by_dtype: Dict[torch.dtype, list] = {}
        for leaf in self.leaves:
            by_dtype.setdefault(leaf[2].dtype, []).append(leaf)
        for leaves in by_dtype.values():
            flat = torch.cat([b.reshape(-1) for _, _, b in leaves])
            ranks = comm.gather(flat, self.axis, 0).view(f, -1).unbind(0)
            at = 0
            for members, dim, block in leaves:
                parts = [r[at:at + block.numel()].view(block.shape)
                         for r in ranks]
                at += block.numel()
                if dim == 0:
                    for p, w in zip(members, torch.cat(parts)):
                        p.copy_(w)
                else:
                    members[0].copy_(torch.cat(parts, dim - 1))
        for members, _, block in self.leaves:
            block.grad = None


def _state_dim(p, ref_dims, f: int, n_stages=None):
    """The reference's ``_fsdp_state_spec`` on the reference's leaf of
    ``p`` past its stage dimensions (``ref_dims``: the reference dimension
    of each port dimension, None for the same order; ``n_stages``, for a
    replicated leaf: whose first dimension the rule keeps where it equals
    the stage count): 1 + the port dimension it shards over ``fsdp``, or
    None where the leaf stays whole."""
    dims = ref_dims or tuple(range(p.dim()))
    ref = [0] * p.dim()
    for d, j in enumerate(dims):
        ref[j] = p.shape[d]
    start = 1 if ref and ref[0] == n_stages else 0
    for j in range(start, len(ref)):
        if ref[j] >= f and ref[j] % f == 0:
            return dims.index(j) + 1
    return None


def make_pipelined_llama_train_step(cfg, optimizer, mesh, *,
                                    n_microbatches: int,
                                    pipe_axis: str = "pipe"):
    """``step(model, inputs, targets) -> loss``: one step of ``model`` (a
    :class:`PipelinedLlama`, whose parameters ``optimizer`` steps; a
    ``DistributedOptimizer`` is unwrapped) with the layer stack
    pipelined over ``pipe_axis`` and the batch over the data-like axes.

    ``inputs``/``targets`` are the GLOBAL [B, S] token ids, the same on
    every rank; each data shard takes its rows.  Every stage computes the
    loss (a local sum in lse form, on fp32 logits as the reference's) on
    the broadcast output; the embedding's gradient, which only stage 0
    has, is summed over ``pipe``; every gradient is summed over the data
    axes and divided by the global token count.  Returns the global mean
    loss (fp32, 0-dim).

    ``DistributedOptimizer(inner, fsdp=True)`` on a mesh whose ``fsdp``
    axis is larger than 1 takes the ZeRO rung (the module's docstring):
    from the first step, the inner optimizer's groups hold this rank's
    blocks of the leaves the rule shards, so build it fresh over the
    model's parameters."""
    from horovod_tpu_torch.models.llama import rope_freqs

    sizes = axis_sizes(mesh)
    fsdp = getattr(optimizer, "_fsdp", False) and \
        sizes.get(AXIS_FSDP, 1) > 1
    inner = _inner_optimizer(optimizer)
    rung = None
    pipe = comm.axis_group(mesh, pipe_axis)
    dp = [comm.axis_group(mesh, a) for a in data_axes(mesh) if sizes[a] > 1]
    n_data = 1
    for a in data_axes(mesh):
        n_data *= sizes[a]
    index = axis_index(mesh, data_axes(mesh))

    def step(model: PipelinedLlama, inputs: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        nonlocal rung
        B, S = inputs.shape
        if B % n_data:
            raise ValueError(f"batch {B} not divisible by the data axes' "
                             f"size {n_data}")
        rows = slice(index * (B // n_data), (index + 1) * (B // n_data))
        cos, sin = rope_freqs(cfg.head_dim, S, cfg.rope_theta,
                              device=inputs.device)

        def stage_fn(_params, h):
            for layer in model.layers:
                h = layer(h, cos, sin)
            return h

        if fsdp and rung is None:
            rung = _ZeroRung(model, inner, comm.axis_group(mesh, AXIS_FSDP))
        model.zero_grad(set_to_none=True)
        inner.zero_grad(set_to_none=True)
        h = pipeline_apply(stage_fn, dict(model.layers.named_parameters()),
                           model.tok_emb(inputs[rows]), axis_name=pipe_axis,
                           n_microbatches=n_microbatches, mesh=mesh)
        w = model.lm_head.weight
        logits = F.linear(model.norm_f(h).to(w.dtype), w).float()
        loss_sum = softmax_cross_entropy(logits, targets[rows],
                                         reduction="sum")
        loss_sum.backward()
        emb = model.tok_emb.weight
        if emb.grad is None:
            emb.grad = torch.zeros_like(emb)
        emb.grad = comm.allreduce(emb.grad, pipe)
        params = [p for p in model.parameters() if p.requires_grad]
        sum_gradients(params, lambda p: dp, B * S)
        if rung is not None:
            rung.step()
        else:
            inner.step()
        loss = loss_sum.detach().float()
        for a in dp:
            loss = comm.allreduce(loss, a)
        return loss / (B * S)

    return step
