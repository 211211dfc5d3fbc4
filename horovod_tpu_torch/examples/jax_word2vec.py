"""Skip-gram word2vec with NCE loss: the embedding-gradient workload.

Counterpart of ``examples/jax_word2vec.py`` (the reference's
``tensorflow_word2vec.py``): skip-gram batches from a synthetic Zipf
corpus, a direct ``broadcast_parameters``, Adagrad through
``hvd.DistributedOptimizer`` and ``hvd.make_train_step``.  The embedding
gradients are dense tensors (``F.embedding`` without ``sparse=True``), as
the JAX step's dense scatters are, and are averaged like any other.

Adagrad is optax's: the accumulator starts at 0.1 and eps is 1e-7.
torch's ``Adagrad`` divides by ``sqrt(acc) + eps`` where optax multiplies
by ``rsqrt(acc + eps)``; the two steps differ, relative, by about
eps · |1/sqrt(acc) - 1/(2 acc)|, at most 1.9e-7 with acc >= 0.1
(ROADMAP.md Queue C).

    python -m horovod_tpu_torch.examples.jax_word2vec [--smoke] \\
        [--device cpu] [--vocab V] [--embedding E] [--steps N]

Runs on the CUDA device unless given ``--device cpu``.  ``main(argv)``
returns ``{"losses": [loss a step], "step_ms": mean ms a step after the
first}``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["synthetic_corpus", "skipgram_batches", "adagrad", "main"]


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0):
    """Zipf-distributed token stream (word2vec's natural input shape)."""
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(1, vocab + 1)
    return rng.choice(vocab, size=n_tokens, p=freq / freq.sum())


def skipgram_batches(corpus, batch, window, negatives, vocab, seed):
    """(centers [B], context words [B], negatives [B, K]) forever."""
    rng = np.random.default_rng(seed)
    while True:
        centers = rng.integers(window, len(corpus) - window, batch)
        offsets = rng.integers(1, window + 1, batch) * \
            rng.choice([-1, 1], batch)
        yield (corpus[centers], corpus[centers + offsets],
               rng.integers(0, vocab, (batch, negatives)))


def adagrad(params, lr: float) -> torch.optim.Adagrad:
    """``optax.adagrad(lr)``'s settings in torch: the accumulator starts
    at 0.1, eps 1e-7."""
    return torch.optim.Adagrad(params, lr=lr, initial_accumulator_value=0.1,
                               eps=1e-7)


def main(argv=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.common import example_args
    from horovod_tpu_torch.models import SkipGramModel, nce_loss

    args = example_args("word2vec", argv, batch_size=128, lr=0.2,
                        vocab=2000, embedding=64, negatives=8, steps=400)
    hvd.init(device=args.device)
    dev = hvd.device()

    vocab = 200 if args.smoke else args.vocab
    steps = 20 if args.smoke else args.steps
    model = SkipGramModel(vocab_size=vocab, embedding_size=args.embedding,
                          device=dev)
    hvd.broadcast_parameters(model, root_rank=0)
    opt = hvd.DistributedOptimizer(adagrad(model.parameters(),
                                           args.lr * hvd.num_chips()))
    step = hvd.make_train_step(
        model, lambda m, b: nce_loss(m, *b), opt)

    corpus = synthetic_corpus(vocab, 10000 if args.smoke else 100000,
                              seed=hvd.rank())
    batches = skipgram_batches(corpus, args.batch_size, 2, args.negatives,
                               vocab, seed=hvd.rank())
    losses = []
    t0 = None
    for i in range(steps):
        batch = tuple(torch.from_numpy(a).long().to(dev)
                      for a in next(batches))
        losses.append(step(batch))
        if i == 0:
            losses[0].item()                   # the first step has run
            t0 = time.perf_counter()
        if i % max(steps // 5, 1) == 0 and hvd.rank() == 0:
            print(f"step {i}: nce loss={float(losses[i]):.4f}", flush=True)
    losses = [float(v) for v in losses]       # waits for the last step
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    print("done", flush=True)
    return {"losses": losses, "step_ms": step_ms}


if __name__ == "__main__":
    main()
