"""BERT pretraining with FSDP-style sharding: MLM + NSP on synthetic
batches.

Counterpart of ``examples/bert_pretraining_fsdp.py``.  The pieces:
``hvd.init()``, ``build_mesh({"data": n // fsdp, "fsdp": fsdp})``,
``BertForPretraining`` (fp32 parameters, bf16 compute; ``--flash`` puts
the flash kernels behind the attention seam, bidirectional through the
key-bias sideband), ``shard_params`` (FSDP2 when ``fsdp`` > 1), AdamW with
optax.adamw's defaults, and ``hvd.make_train_step`` over
:func:`pretraining_loss`.

The reference's step is one GSPMD program over the *global* batch, so its
MLM term is the sum over every masked position of the global batch
divided by their global count.  Here every rank draws the same global
batch from ``default_rng(0)`` (the reference's rank-0 stream) and steps
its own rows (:meth:`BertBatch.shard`), which carry the global count
over n as their MLM divisor: the ranks' average — what the optimizer's
gradient averaging and ``make_train_step``'s loss average compute — is
then the global loss, with no collective in the loss.  An n-rank run and
the reference's one-process run on an n-device mesh see the same batch
and the same loss.

    python -m horovod_tpu_torch.examples.bert_pretraining_fsdp --smoke \\
        [--flash] [--fsdp N] [--device cpu]

Runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["BertBatch", "make_batch", "pretraining_loss", "build", "main"]


class BertBatch(NamedTuple):
    """A pretraining batch: ``input_ids``, ``mlm_labels`` (int64 [B, S]),
    ``mask_positions`` (bool [B, S], the MLM targets), ``nsp_labels``
    (int64 [B]); optional ``attention_mask`` ([B, S], 1 = a real token;
    None means every token, as the reference example passes),
    ``token_type_ids`` ([B, S], or None) and ``mlm_count``, what the MLM
    sum over these rows is divided by (None: their own masked count)."""

    input_ids: torch.Tensor
    mlm_labels: torch.Tensor
    mask_positions: torch.Tensor
    nsp_labels: torch.Tensor
    attention_mask: Optional[torch.Tensor] = None
    token_type_ids: Optional[torch.Tensor] = None
    mlm_count: Optional[float] = None

    def rows(self, index) -> "BertBatch":
        """The rows ``index`` (a slice or an index tensor) selects;
        ``mlm_count`` is kept whole."""
        return BertBatch(*(t[index] if isinstance(t, torch.Tensor) else t
                           for t in self))

    def shard(self, rank: int, n: int) -> "BertBatch":
        """Rank ``rank``'s 1/n of this global batch's rows, whose MLM sum
        is divided by the global masked count over n: the average over
        the n ranks of :func:`pretraining_loss` is the global batch's."""
        B = len(self.input_ids)
        if B % n:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{n} ranks")
        count = max(int(self.mask_positions.sum()), 1)
        return self.rows(slice(rank * B // n, (rank + 1) * B // n)) \
            ._replace(mlm_count=count / n)

    def to(self, device) -> "BertBatch":
        return BertBatch(*(t.to(device) if isinstance(t, torch.Tensor)
                           else t for t in self))


def make_batch(rng: np.random.Generator, vocab: int, batch: int,
               seq: int) -> BertBatch:
    """One step's synthetic global batch: the reference's numpy draws, in
    its order, as CPU tensors."""
    input_ids = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    mask_positions = rng.random((batch, seq)) < 0.15
    mlm_labels = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    nsp_labels = rng.integers(0, 2, batch, dtype=np.int32)
    return BertBatch(torch.from_numpy(input_ids).long(),
                     torch.from_numpy(mlm_labels).long(),
                     torch.from_numpy(mask_positions),
                     torch.from_numpy(nsp_labels).long())


def pretraining_loss(model, batch: BertBatch) -> torch.Tensor:
    """The reference example's ``loss_fn``: MLM cross-entropy summed over
    the masked positions and divided by ``batch.mlm_count`` (or the
    batch's own masked count), plus NSP cross-entropy averaged over the
    rows.  Without an ``attention_mask`` every key is attended: an
    all-ones mask keeps the flash seam bidirectional (it is causal without
    a mask)."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    mask = batch.attention_mask
    if mask is None:
        mask = torch.ones_like(batch.input_ids)
    mlm_logits, nsp_logits = model(batch.input_ids, batch.token_type_ids,
                                   mask, train=False)
    count = batch.mlm_count
    if count is None:
        count = torch.clamp(batch.mask_positions.sum().float(), min=1)
    mlm = softmax_cross_entropy(mlm_logits, batch.mlm_labels,
                                where=batch.mask_positions,
                                reduction="sum") / count
    return mlm + softmax_cross_entropy(nsp_logits, batch.nsp_labels)


def build(cfg, state, mesh, lr: float, attention_fn):
    """(model, optimizer): ``BertForPretraining`` on ``state``, made equal
    on every rank (``broadcast_parameters``) and placed by
    ``shard_params``; AdamW with optax.adamw's defaults (betas 0.9/0.999,
    eps 1e-8, weight decay 1e-4 — torch's own default decay is 1e-2) in a
    ``DistributedOptimizer`` that averages the gradients unless FSDP
    units reduce them."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import BertForPretraining
    from horovod_tpu_torch.parallel.api import shard_params
    from horovod_tpu_torch.parallel.mesh import AXIS_FSDP, axis_sizes

    model = BertForPretraining.from_state_dict(cfg, state, attention_fn)
    hvd.broadcast_parameters(model)
    model = shard_params(model, mesh)
    fsdp = axis_sizes(mesh).get(AXIS_FSDP, 1) > 1
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        reduce_gradients=not fsdp)
    return model, opt


def main(argv=None) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import example_args
    from horovod_tpu_torch.models.bert import BertConfig, \
        dot_product_attention
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.ops.flash_attention import flash_attention_fn
    from horovod_tpu_torch.parallel.mesh import build_mesh

    args = example_args("BERT pretraining (FSDP, synthetic)", argv,
                        batch_size=8, lr=1e-4, steps=40, seq_len=128,
                        fsdp=-1, flash=False)
    hvd.init(device=args.device)
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    fsdp = n if args.fsdp == -1 else args.fsdp
    mesh = build_mesh({"data": n // fsdp, "fsdp": fsdp})

    cfg = BertConfig.tiny() if args.smoke else BertConfig.base()
    seq = 32 if args.smoke else args.seq_len
    steps = 4 if args.smoke else args.steps
    # The reference initialises from input ids alone: no type_emb table.
    state = init_params(cfg, 0, dev, token_types=False)
    model, opt = build(cfg, state, mesh, args.lr, flash_attention_fn
                       if args.flash else dot_product_attention)
    step = hvd.make_train_step(model, pretraining_loss, opt)

    rng = np.random.default_rng(0)
    for i in range(steps):
        batch = make_batch(rng, cfg.vocab_size, args.batch_size, seq)
        loss = float(step(batch.shard(rank, n).to(dev)))
        if i % max(steps // 5, 1) == 0 and rank == 0:
            print(f"step {i}: loss={loss:.4f}", flush=True)
    hvd.shutdown()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
