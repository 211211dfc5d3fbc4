"""Context-parallel (sequence-parallel) LM training.

Counterpart of ``horovod_tpu/parallel/seq.py``: the sequence dimension is
sharded over the ``seq`` mesh axis and attention runs as ring attention
or Ulysses (``parallel/ring_attention.py``), composed with data
parallelism on the batch axes.  Parameters are replicated; each shard
computes its tokens' loss as a SUM, the gradients are divided by the
global token count and summed over the data and seq axes, so every rank
steps on the gradient of the global mean.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.api import _inner_optimizer, sum_gradients
from horovod_tpu_torch.parallel.mesh import (axis_index, axis_sizes,
                                             data_axes)
from horovod_tpu_torch.parallel.ring_attention import (make_ring_attention_fn,
                                                       ulysses_attention)

__all__ = ["make_context_parallel_train_step"]


def make_context_parallel_train_step(cfg, optimizer, mesh, *,
                                     seq_axis: str = "seq",
                                     attention: str = "auto"):
    """``step(model, inputs, targets) -> loss``: one step of ``model`` (a
    ``LlamaModel`` of ``cfg`` whose parameters ``optimizer`` steps; a
    ``DistributedOptimizer`` is unwrapped) with the sequence sharded over
    ``seq_axis`` and the batch over the data-like axes of ``mesh``.

    ``inputs``/``targets`` are the GLOBAL [B, S] token ids, the same on
    every rank (S divisible by the seq axis's size, B by the data axes');
    each rank takes its block.  ``attention``: "ulysses" (all-to-all of
    heads, flash attention at full S), "ring" (the flash ring) or "auto":
    Ulysses when both head counts divide the seq axis's size, the ring
    otherwise.  The model's attention is the chosen one for the step's
    forward, and its positions start at ``rank_in_seq * S_local``.
    Returns the global mean loss (fp32, 0-dim)."""
    sizes = axis_sizes(mesh)
    seq_size = sizes[seq_axis]
    if attention == "auto":
        heads_divide = (cfg.num_heads % seq_size == 0
                        and cfg.num_kv_heads % seq_size == 0)
        attention = "ulysses" if heads_divide else "ring"
    if attention == "ring":
        attention_fn = make_ring_attention_fn(seq_axis, mesh)
    elif attention == "ulysses":
        def attention_fn(q, k, v, *a, **kw):
            return ulysses_attention(q, k, v, axis_name=seq_axis, mesh=mesh)
    else:
        raise ValueError(f"unknown attention {attention!r}")
    inner = _inner_optimizer(optimizer)
    batch_axes = data_axes(mesh)
    n_batch = 1
    for a in batch_axes:
        n_batch *= sizes[a]
    reduce = [comm.axis_group(mesh, a) for a in batch_axes + (seq_axis,)
              if sizes[a] > 1]
    b_index = axis_index(mesh, batch_axes)
    s_index = mesh.get_local_rank(seq_axis)

    def step(model, inputs: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
        B, S = inputs.shape
        if B % n_batch or S % seq_size:
            raise ValueError(f"batch {B} x sequence {S} does not split over "
                             f"{n_batch} batch shards x {seq_size} sequence "
                             "shards")
        rows, cols = B // n_batch, S // seq_size
        block = (slice(b_index * rows, (b_index + 1) * rows),
                 slice(s_index * cols, (s_index + 1) * cols))
        params = [p for p in model.parameters() if p.requires_grad]
        inner.zero_grad(set_to_none=True)
        saved = [layer.attn.attention_fn for layer in model.layers]
        for layer in model.layers:
            layer.attn.attention_fn = attention_fn
        try:
            logits = model(inputs[block], positions_offset=s_index * cols)
        finally:
            for layer, fn in zip(model.layers, saved):
                layer.attn.attention_fn = fn
        loss_sum = softmax_cross_entropy(logits, targets[block],
                                         reduction="sum")
        loss_sum.backward()
        denom = B * S
        sum_gradients(params, lambda p: reduce, denom)
        inner.step()
        loss = loss_sum.detach().float()
        for axis in reduce:
            loss = comm.allreduce(loss, axis)
        return loss / denom

    return step
