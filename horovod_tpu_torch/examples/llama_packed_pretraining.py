"""Packed-sequence Llama pretraining: many documents per row, flash
attention with segment masking, the fused RMSNorm.

Counterpart of ``examples/llama_packed_pretraining.py``.  Documents of
random length are packed back to back into fixed rows, so no FLOPs go to
padding; attention is then block-diagonal causal (a token never attends
into the previous document) through ``flash_attention(segment_ids=...)``,
an O(S) sideband with the fully masked tiles skipped, and the loss is
masked at document boundaries.  The pieces: ``hvd.init()``, the model
with ``fused_rmsnorm=True`` (the RMSNorm kernels), ``hvd.DistributedOptimizer``
over ``MasterWeights(AdamW)`` and ``hvd.make_train_step``; each rank steps
its shard of the rows, segment ids travelling with the tokens.

    python -m horovod_tpu_torch.examples.llama_packed_pretraining --smoke \\
        [--device cpu]

Runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

__all__ = ["make_packed_batch", "bind_segments", "boundary_mask",
           "packed_lm_loss", "main"]


def make_packed_batch(rng: np.random.Generator, vocab: int, batch: int,
                      seq: int, mean_doc_len: float):
    """Rows of documents packed back to back: (tokens [B, S+1] int64,
    segment_ids [B, S] int32), CPU tensors.  The same numpy draws as the
    reference's, so one seed gives the same batch in both packages."""
    tokens = rng.integers(1, vocab, (batch, seq + 1), dtype=np.int64)
    seg = np.zeros((batch, seq), np.int32)
    for b in range(batch):
        pos, doc = 0, 0
        while pos < seq:
            length = max(1, int(rng.poisson(mean_doc_len)))
            seg[b, pos:pos + length] = doc
            pos += length
            doc += 1
    return torch.from_numpy(tokens), torch.from_numpy(seg)


def bind_segments(model, segment_ids: torch.Tensor) -> None:
    """Point every layer's ``attention_fn`` at causal flash attention
    masked to ``segment_ids`` [B, S] — the rows about to run (the
    reference closes each trace's segment ids over a fresh module).  The
    segment starts are computed once for all layers."""
    from horovod_tpu_torch.ops.flash_attention import segment_attention_fn

    fn = segment_attention_fn(segment_ids)
    for layer in model.layers:
        layer.attn.attention_fn = fn


def boundary_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] bool: True where the next token is in the same document.  A
    document's last token must not be trained to predict the next
    document's first (the attention mask blocks cross-document reads;
    this blocks cross-document targets)."""
    valid = torch.zeros(segment_ids.shape, dtype=torch.bool,
                        device=segment_ids.device)
    valid[:, :-1] = segment_ids[:, 1:] == segment_ids[:, :-1]
    return valid


def packed_lm_loss(model, batch) -> torch.Tensor:
    """Next-token cross-entropy over packed rows ``batch = (tokens [B,
    S+1], segment_ids [B, S])``, attention masked to the segments and the
    loss to :func:`boundary_mask`."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    tokens, seg = batch
    bind_segments(model, seg)
    logits = model(tokens[:, :-1])
    return softmax_cross_entropy(logits, tokens[:, 1:],
                                 where=boundary_mask(seg))


def main(argv=None) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from horovod_tpu_torch.ops.mixed_precision import MasterWeights

    p = argparse.ArgumentParser(description="packed-sequence Llama "
                                "pretraining")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config, S 128, 3 steps, for CI")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the CUDA device)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.01)
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    n, rank = hvd.size(), hvd.rank()
    if args.smoke:
        cfg = dataclasses.replace(LlamaConfig.tiny(), fused_rmsnorm=True)
        batch, seq, steps, mean_doc = n, 128, 3, 40
    else:
        cfg = LlamaConfig(vocab_size=32000, hidden_size=512, num_layers=8,
                          num_heads=4, num_kv_heads=4,
                          intermediate_size=2048, max_seq_len=2048,
                          fused_rmsnorm=True)
        batch, seq, steps, mean_doc = 4 * n, 1024, args.steps, 300

    dev = hvd.device()
    tokens, seg = make_packed_batch(np.random.default_rng(0),
                                    cfg.vocab_size, batch, seq, mean_doc)
    rows = slice(rank * batch // n, (rank + 1) * batch // n)
    shard = (tokens[rows].to(dev), seg[rows].to(dev))

    model = LlamaModel.from_state_dict(cfg, init_params(cfg, 0, dev))
    hvd.broadcast_parameters(model)
    opt = hvd.DistributedOptimizer(MasterWeights(
        model.parameters(), torch.optim.AdamW, lr=args.lr,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    step = hvd.make_train_step(model, packed_lm_loss, opt)

    losses = []
    for i in range(steps):
        losses.append(float(step(shard)))
        if rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    hvd.shutdown()
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not improve: {losses}")
    if rank == 0:
        print("packed pretraining done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
