"""Token cross-entropy from (possibly bf16) logits, without an fp32 copy
of the logits.

Counterpart of ``horovod_tpu/ops/losses.py``: ``logsumexp(logits) -
logits[target]`` with a hand-written backward whose residuals are the
logits as given plus an fp32 lse ``[...]``, and whose cotangent
``(softmax - onehot) * g`` is emitted in the logits' dtype.

The reference leaves the fp32 upcast to XLA, which fuses it into the
reduction passes.  Eager PyTorch would materialise it: at B 2, S 2048
and a 128256-token vocabulary every fp32 copy of the logits is 2.1 GB,
and a plain forward and backward make several.  So both passes walk the
rows in chunks of at most :data:`CHUNK_ELEMENTS` logits, and no fp32
tensor larger than one chunk exists.  This is plain PyTorch, not a
kernel: the reference computes it outside any Pallas kernel too.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy", "CHUNK_ELEMENTS"]

#: Logits per chunk (rows x vocabulary): 2^25 fp32 values are 128 MiB.
CHUNK_ELEMENTS = 1 << 25


def _chunks(n_rows: int, vocab: int):
    step = max(1, CHUNK_ELEMENTS // vocab)
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


class _NLL(torch.autograd.Function):
    """Per-token negative log-likelihood [...] from logits [..., V]."""

    @staticmethod
    def forward(ctx, logits, targets):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        t = targets.reshape(-1, 1).long()
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=logits.device)
        for r0, r1 in _chunks(flat.shape[0], V):
            x = flat[r0:r1]
            m = x.amax(dim=-1).float()
            s = torch.exp(x.float() - m[:, None]).sum(dim=-1)
            lse[r0:r1] = m + torch.log(s)
        tgt = flat.gather(-1, t)[:, 0].float()
        ctx.save_for_backward(logits, targets, lse)
        return (lse - tgt).reshape(targets.shape)

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        t = targets.reshape(-1).long()
        gf = g.reshape(-1).float()
        d = torch.empty_like(flat)
        for r0, r1 in _chunks(flat.shape[0], V):
            p = torch.exp(flat[r0:r1].float() - lse[r0:r1, None])
            p[torch.arange(r1 - r0, device=p.device), t[r0:r1]] -= 1.0
            d[r0:r1] = (p * gf[r0:r1, None]).to(d.dtype)
        return d.reshape(logits.shape), None


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                          where=None, reduction: str = "mean"
                          ) -> torch.Tensor:
    """Token cross-entropy from logits [..., V] and integer targets [...].

    ``where``: optional boolean [...] mask of the tokens to include.
    Returns a scalar fp32 ``reduction``: "mean" over the selected tokens,
    or "sum" (the form a sharded loss needs when the mean's denominator
    is the global token count, summed outside).
    """
    if reduction not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    nll = _NLL.apply(logits, targets)
    if where is not None:
        nll = torch.where(where, nll, 0.0)
    if reduction == "sum":
        return nll.sum()
    if where is not None:
        return nll.sum() / torch.clamp(where.sum(), min=1)
    return nll.mean()
