"""The parallelism families' collectives, differentiable, over one axis of
a mesh.

Counterpart of the ``lax`` collectives the reference's families call
inside ``shard_map`` (``ppermute``, ``all_to_all``, ``psum``,
``all_gather``) and of the transposes JAX derives for them.  Each is a
``torch.autograd.Function`` over ``torch.distributed`` on the process
group of one mesh axis (:func:`axis_group`); ``send``, ``recv`` and
``all_to_all`` carry no autograd of their own, so every backward here is
written out:

* :func:`permute` — the ring step ``i -> i + shift``; its backward
  permutes the cotangent the other way (the transpose of ``ppermute``);
* :func:`all_to_all` — split one dimension into the group's ranks and
  concatenate what arrives along another (``lax.all_to_all(tiled=True)``);
  its backward is the inverse exchange;
* the Megatron pair: :func:`copy_to` (identity forward, allreduce
  backward) where a replicated activation enters rank-specific work, and
  :func:`reduce_from` (allreduce forward, identity backward) where the
  ranks' partial sums leave it;
* :func:`psum` (allreduce forward and backward): a sum every rank's loss
  reads, of parts computed from every rank's rows (a BatchNorm's
  statistics over the global batch, as SyncBatchNorm sums them);
* :func:`gather` (allgather forward; backward: this rank's slice of a
  cotangent every rank holds whole) and its mirror :func:`split`;
  :func:`gather_shards` (allgather forward, reduce-scatter backward: a
  parameter sharded over a data-like axis, whose ranks saw different
  data, or an activation split over ``tensor`` read whole by work split
  over it) and its mirror :func:`reduce_scatter` (``lax.psum_scatter``:
  reduce-scatter forward, allgather backward);
* :func:`broadcast_from` (``x`` of one rank on every rank; backward, the
  ranks' cotangents summed on that rank and zero on the others: the
  transpose of the reference's masked ``psum``).

The reduce-scatters sum in rank order: each rank receives every rank's
chunk of its slice (an all-to-all) and adds them up, rank 0's first, in
fp32 for a half type, rounded once -- the order and the accumulation of
the reference's ``psum`` on the CPU, so the bits do not depend on the
backend's algorithm.  :func:`sum_in_order` is a reduce-scatter and an
allgather of that kind (the bytes of a ring), differentiable; the
families' :func:`psum` runs the group's own allreduce.

Given no axis (None, or an axis of size 1), each returns its input: the
unplaced model runs the same forward as a placed one.

Transport: one helper, :func:`_on_wire`, runs every collective.  On a
gloo group a CUDA tensor goes through host memory (a D2H copy, the
collective on the host copy, an H2D copy), as gloo carries host tensors;
on NCCL it goes as it is.  The choice follows the group's backend only.
:data:`stats` counts the calls, the bytes that cross between ranks (the
algorithm's logical traffic from this rank: a ring allreduce sends 2(n-1)/n
of the tensor, an allgather (n-1) times the local part, an all-to-all
(n-1)/n, a permute the whole tensor) and the bytes staged through the
host both ways.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics

__all__ = ["axis_group", "axes_group", "world_axis", "permute", "all_to_all",
           "copy_to", "reduce_from", "psum", "gather", "split",
           "gather_shards", "reduce_scatter", "sum_in_order",
           "broadcast_from", "allreduce",
           "broadcast", "send", "recv", "stats", "reset_stats"]

#: Calls, bytes that cross between ranks, and bytes staged through the
#: host (D2H plus H2D), since the last :func:`reset_stats`.
stats = {"calls": 0, "wire_bytes": 0, "staged_bytes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


class _Axis:
    """One mesh axis: its process group, this rank's index on it and its
    size."""
    __slots__ = ("group", "index", "size")

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index % self.size)


def axis_group(mesh, axis: str) -> _Axis:
    """The group of ``axis`` on ``mesh`` (a ``DeviceMesh``), this rank's
    index on it and its size."""
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return _Axis(mesh.get_group(axis), mesh.get_local_rank(axis),
                 mesh.size(names.index(axis)))


def world_axis() -> _Axis:
    """The default process group as one axis: every rank, in rank
    order."""
    return _Axis(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


#: {(the mesh's rank layout, the axes): their flattened group}; a group
#: goes with the world that made it.
_flat_groups: dict = {}
basics.on_shutdown(_flat_groups.clear)


def axes_group(mesh, axes: Sequence[str]) -> _Axis:
    """``axes`` of ``mesh`` taken together as one axis, the first
    outermost (the reference's tuple ``axis_name``): a group over each
    set of ranks that differ only in them, made on first use by every
    rank of the mesh at once."""
    names = mesh.mesh_dim_names
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh has no axis {missing[0]!r} (axes {names})")
    dims = [names.index(a) for a in axes]
    index, size = 0, 1
    for a, d in zip(axes, dims):
        index = index * mesh.size(d) + mesh.get_local_rank(a)
        size *= mesh.size(d)
    layout = mesh.mesh
    key = (tuple(layout.flatten().tolist()), tuple(layout.shape),
           tuple(names), tuple(axes))
    if key not in _flat_groups:
        rest = [d for d in range(layout.dim()) if d not in dims]
        rows = layout.permute(rest + dims).reshape(-1, size).tolist()
        _flat_groups[key] = dist.new_subgroups_by_enumeration(rows)[0]
    return _Axis(_flat_groups[key], index, size)


Axes = Union[_Axis, Sequence[_Axis]]


def _axes(axes: Optional[Axes]) -> Tuple[_Axis, ...]:
    if axes is None:
        return ()
    if isinstance(axes, _Axis):
        axes = (axes,)
    return tuple(a for a in axes if a is not None and a.size > 1)


def _on_wire(axis: _Axis, run, wire_bytes: int, inout=(), out=(), inp=()):
    """Run ``run(tensors)``, a collective on ``axis``'s group over
    ``inout + out + inp`` (read and written, written, read): through host
    copies when the group is gloo and the tensors are on the card (each
    read one copied to the host, each written one back), as they are
    otherwise."""
    stats["calls"] += 1
    stats["wire_bytes"] += int(wire_bytes)
    tensors = list(inout) + list(out) + list(inp)
    if not (dist.get_backend(axis.group) == "gloo"
            and tensors[0].device.type == "cuda"):
        run(tensors)
        return
    host = ([t.cpu() for t in inout]
            + [torch.empty(t.shape, dtype=t.dtype) for t in out]
            + [t.cpu() for t in inp])
    run(host)
    written = list(inout) + list(out)
    for t, h in zip(written, host):
        t.copy_(h)
    stats["staged_bytes"] += sum(_nbytes(t) for t in written) + sum(
        _nbytes(t) for t in list(inout) + list(inp))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, axis: _Axis,
              op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the axis by the group's allreduce (a new
    tensor; ``op`` a ``torch.distributed`` op, the sum by default)."""
    out = x.contiguous().clone()
    if axis.size == 1:
        return out
    n = axis.size
    _on_wire(axis, lambda ts: dist.all_reduce(ts[0], op=op,
                                              group=axis.group),
             2 * (n - 1) * _nbytes(out) // n, inout=[out])
    return out


def broadcast(x: torch.Tensor, axis: _Axis, src: int) -> torch.Tensor:
    """``x`` of the axis's rank ``src``, on every rank of it (a new
    tensor)."""
    out = x.contiguous().clone()
    if axis.size == 1:
        return out
    _on_wire(axis, lambda ts: dist.broadcast(
        ts[0], axis.global_rank(src), group=axis.group),
        _nbytes(out) if axis.index == src else 0, inout=[out])
    return out


def _all_gather(x: torch.Tensor, axis: _Axis, dim: int) -> torch.Tensor:
    x = x.contiguous()
    if axis.size == 1:
        return x.clone()
    flat = x.reshape(1, -1)
    out = torch.empty((axis.size, flat.shape[1]), dtype=x.dtype,
                      device=x.device)

    def run(ts):
        dist.all_gather_into_tensor(ts[0], ts[1], group=axis.group)
    _on_wire(axis, run, (axis.size - 1) * _nbytes(x), out=[out], inp=[flat])
    return torch.cat([o.view(x.shape) for o in out.unbind(0)], dim=dim)


def _own(x: torch.Tensor, axis: _Axis, dim: int) -> torch.Tensor:
    return torch.chunk(x, axis.size, dim=dim)[axis.index].contiguous()


def _exchange(x: torch.Tensor, axis: _Axis, split_dim: int,
              what: str) -> torch.Tensor:
    """Chunk ``j`` of ``split_dim`` sent to rank ``j``: the chunks
    received, stacked in rank order."""
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"{what}: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not split into {n}")
    parts = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    if n == 1:
        return parts
    out = torch.empty_like(parts)

    def run(ts):
        dist.all_to_all_single(ts[0], ts[1], group=axis.group)
    _on_wire(axis, run, (n - 1) * _nbytes(parts) // n, out=[out],
             inp=[parts])
    return out


def _a2a(x: torch.Tensor, axis: _Axis, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    out = _exchange(x, axis, split_dim, "all_to_all")
    return torch.cat(out.unbind(0), dim=concat_dim)


def _reduce_scatter(x: torch.Tensor, axis: _Axis, dim: int) -> torch.Tensor:
    """The axis's ``x`` summed, this rank's chunk of ``dim``: the chunks
    added in rank order, in fp32 for a half type, rounded once."""
    parts = _exchange(x, axis, dim, "reduce_scatter")
    acc = (torch.float32 if x.dtype in (torch.float16, torch.bfloat16)
           else x.dtype)
    out = parts[0].to(acc)
    for p in parts[1:]:
        out = out + p.to(acc)
    return out.to(x.dtype)


def send(x: torch.Tensor, axis: _Axis, dst: int) -> None:
    """Send ``x`` to the axis's rank ``dst`` (blocking)."""
    x = x.contiguous()
    _on_wire(axis, lambda ts: dist.send(
        ts[0], axis.global_rank(dst), group=axis.group), _nbytes(x),
        inp=[x])


def recv(like: torch.Tensor, axis: _Axis, src: int) -> torch.Tensor:
    """A tensor shaped as ``like`` received from the axis's rank ``src``."""
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    _on_wire(axis, lambda ts: dist.recv(
        ts[0], axis.global_rank(src), group=axis.group), 0, out=[out])
    return out


def _permute(x: torch.Tensor, axis: _Axis, shift: int) -> torch.Tensor:
    x = x.contiguous()
    if axis.size == 1:
        return x.clone()
    out = torch.empty_like(x)

    def run(ts):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, ts[1], axis.global_rank(
                axis.index + shift), axis.group),
            dist.P2POp(dist.irecv, ts[0], axis.global_rank(
                axis.index - shift), axis.group)])
        for r in reqs:
            r.wait()
    _on_wire(axis, run, _nbytes(x), out=[out], inp=[x])
    return out


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _permute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.axis, -ctx.shift), None, None


def permute(x: torch.Tensor, axis: _Axis, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of the axis receives rank ``i - shift``'s ``x`` (sends
    its own to ``i + shift``), modulo the axis size."""
    return _Permute.apply(x, axis, shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, concat_dim, split_dim)
        return _a2a(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis: _Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: chunk ``j`` of ``split_dim`` goes to rank ``j``, what
    arrives is concatenated along ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = allreduce(g, a)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        for a in axes:
            x = allreduce(x, a)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        for a in axes:
            x = allreduce(x, a)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = allreduce(g, a)
        return g, None


def copy_to(x: torch.Tensor, axes: Optional[Axes]) -> torch.Tensor:
    """Identity forward; the cotangent summed over ``axes`` backward."""
    axes = _axes(axes)
    return _CopyTo.apply(x, axes) if axes else x


def reduce_from(x: torch.Tensor, axes: Optional[Axes]) -> torch.Tensor:
    """``x`` summed over ``axes`` forward; identity backward."""
    axes = _axes(axes)
    return _ReduceFrom.apply(x, axes) if axes else x


def psum(x: torch.Tensor, axes: Optional[Axes]) -> torch.Tensor:
    """``x`` summed over ``axes`` forward; the cotangent summed over them
    backward: every rank's loss reads the sum, so each part's cotangent
    is the sum of theirs."""
    axes = _axes(axes)
    return _Psum.apply(x, axes) if axes else x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, reduce):
        ctx.args = (axis, dim, reduce)
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, reduce = ctx.args
        if reduce:
            return _reduce_scatter(g, axis, dim), None, None, None
        return _own(g, axis, dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return _own(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.args = (axis, src)
        return broadcast(x, axis, src)

    @staticmethod
    def backward(ctx, g):
        axis, src = ctx.args
        g = sum_in_order(g, axis)
        return (g if axis.index == src else torch.zeros_like(g)), None, None


def gather(x: torch.Tensor, axis: Optional[_Axis], dim: int) -> torch.Tensor:
    """The axis's parts of ``x`` concatenated along ``dim`` in rank order;
    backward, this rank's slice of the (replicated) cotangent.  ``x``
    itself for no axis."""
    if axis is None or axis.size == 1:
        return x
    return _Gather.apply(x, axis, dim, False)


def split(x: torch.Tensor, axis: Optional[_Axis], dim: int) -> torch.Tensor:
    """This rank's part of a replicated ``x`` along ``dim``; backward, the
    parts' cotangents gathered.  ``x`` itself for no axis."""
    if axis is None or axis.size == 1:
        return x
    return _Split.apply(x, axis, dim)


def gather_shards(x: torch.Tensor, axis: Optional[_Axis],
                  dim: int) -> torch.Tensor:
    """``x``'s parts whole: allgather forward; backward, the ranks'
    cotangents summed and this rank's slice kept (a reduce-scatter) — a
    parameter sharded over a data-like axis, or an activation split over
    ``tensor`` that rank-specific work reads whole."""
    if axis is None or axis.size == 1:
        return x
    return _Gather.apply(x, axis, dim, True)


def reduce_scatter(x: torch.Tensor, axis: Optional[_Axis],
                   dim: int) -> torch.Tensor:
    """The ranks' ``x`` summed in rank order, this rank's chunk of
    ``dim`` (which the axis size must divide); backward, the chunks'
    cotangents gathered.  ``x`` itself for no axis."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceScatter.apply(x, axis, dim)


def sum_in_order(x: torch.Tensor, axis: Optional[_Axis]) -> torch.Tensor:
    """``x`` summed over the axis in rank order, on every rank: a
    :func:`reduce_scatter` and an allgather of the flattened tensor,
    padded to the axis size.  Backward, the same sum of the cotangents
    (the transposes compose: an allgather's is the reduce-scatter and
    back).  ``x`` itself for no axis."""
    if axis is None or axis.size == 1:
        return x
    flat = x.reshape(-1)
    pad = -flat.numel() % axis.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = gather_shards(reduce_scatter(flat, axis, 0), axis, 0)
    return out[:x.numel()].view(x.shape)


def broadcast_from(x: torch.Tensor, axis: Optional[_Axis],
                   src: int) -> torch.Tensor:
    """The axis's rank ``src``'s ``x`` on every rank; backward, the ranks'
    cotangents summed in rank order on ``src`` and zero elsewhere.  ``x``
    itself for no axis."""
    if axis is None or axis.size == 1:
        return x
    return _BroadcastFrom.apply(x, axis, src)
