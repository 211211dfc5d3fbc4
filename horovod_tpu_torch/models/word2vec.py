"""Skip-gram word2vec with NCE loss (PyTorch).

Counterpart of ``horovod_tpu/models/word2vec.py``: an input embedding
table and NCE output weights and biases (``embeddings``, ``nce_weights``,
``nce_biases``, the reference graph's variables), looked up with
``F.embedding`` WITHOUT ``sparse=True``: the gradients are dense tensors
of the tables' shape with only the looked-up rows non-zero, as the JAX
step's dense scatter gives them, and ``DistributedOptimizer`` reduces
them like any other gradient.

The seeded weights follow the flax initializers (``convert.init_params``):
``embeddings`` uniform on [-1, 1), ``nce_weights`` a standard normal
truncated to ±2 times ``1/sqrt(embedding_size)`` (flax's
``truncated_normal(stddev)``: no variance correction, unlike
``lecun_normal``), ``nce_biases`` zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SkipGramConfig", "SkipGramModel", "nce_loss"]


@dataclasses.dataclass(frozen=True)
class SkipGramConfig:
    vocab_size: int = 50000
    embedding_size: int = 128


class SkipGramModel(nn.Module):
    """``forward(center_ids [B]) -> embedded [B, E]``; the NCE logits
    through :meth:`paired_logits` and :meth:`candidate_logits`.  All
    parameters fp32, on the CUDA device unless given ``device="cpu"``."""

    def __init__(self, vocab_size: int = 50000, embedding_size: int = 128,
                 *, seed: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.config = SkipGramConfig(vocab_size, embedding_size)
        V, E = vocab_size, embedding_size
        meta = dict(dtype=torch.float32, device="meta")
        self.embeddings = nn.Parameter(torch.empty(V, E, **meta))
        self.nce_weights = nn.Parameter(torch.empty(V, E, **meta))
        self.nce_biases = nn.Parameter(torch.empty(V, **meta))
        if torch.device(device or "cpu").type != "meta":
            from horovod_tpu_torch.models.convert import init_params

            state = init_params(self.config, seed if generator is None
                                else generator, device)
            self.load_state_dict(state, strict=True, assign=True)

    @classmethod
    def from_state_dict(cls, state: Dict[str, torch.Tensor], **fields
                        ) -> "SkipGramModel":
        """Wrap ready fp32 tensors (``convert.params_from_jax``)."""
        model = cls(**fields, device="meta")
        model.load_state_dict(state, strict=True, assign=True)
        return model

    def forward(self, center_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(center_ids, self.embeddings)

    def _rows(self, word_ids: torch.Tensor):
        w = F.embedding(word_ids, self.nce_weights)
        b = F.embedding(word_ids, self.nce_biases.unsqueeze(1)).squeeze(-1)
        return w, b

    def paired_logits(self, embedded: torch.Tensor,
                      word_ids: torch.Tensor) -> torch.Tensor:
        """Per-example logits: embedded [B, E] × word_ids [B] → [B]."""
        w, b = self._rows(word_ids)
        return torch.einsum("be,be->b", embedded, w) + b

    def candidate_logits(self, embedded: torch.Tensor,
                         word_ids: torch.Tensor) -> torch.Tensor:
        """Per-example candidate logits: [B, E] × word_ids [B, K] →
        [B, K]."""
        w, b = self._rows(word_ids)
        return torch.einsum("be,bke->bk", embedded, w) + b


def nce_loss(model: SkipGramModel, center_ids: torch.Tensor,
             label_ids: torch.Tensor,
             negative_ids: torch.Tensor) -> torch.Tensor:
    """Noise-contrastive estimation loss (sigmoid form):
    ``-(mean log σ(pos) + mean over rows of Σ_k log σ(-neg_k))``.
    ``negative_ids [B, K]`` are pre-sampled in the data pipeline, as the
    reference's are."""
    embedded = model(center_ids)
    pos = model.paired_logits(embedded, label_ids)
    neg = model.candidate_logits(embedded, negative_ids)
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg).sum(-1).mean())
