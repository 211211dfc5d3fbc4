"""BERT pretraining (MLM + NSP) on the port: ``BertForPretraining`` with
the flash kernels (B1–B3, key bias), bf16 compute on fp32 parameters, the
loss through ``ops/losses.py``'s ``softmax_cross_entropy``.

The batches are phase-2 pretraining data as google-research/bert's
``create_pretraining_data.py`` makes it, from the recipe of
``bert_batch``, ``chip_smoke.py:2514``, with one change: each pool
entry's set of row lengths comes from the traffic file's ``shape_seed``
and only their order from the run's seed, so every seed does the same
work.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import flops
from gpubench.weights import derive


def rows(traffic: dict) -> int:
    return traffic["rows_per_rank"]


def lengths(traffic: dict, index: int, rank: int) -> np.ndarray:
    """The row lengths of one rank's rows of pool entry ``index``: all
    ``seq_len`` but a ``short_seq_prob`` share, uniform in [2, seq_len]."""
    rng = np.random.default_rng([traffic["shape_seed"], index, rank])
    B, S = traffic["rows_per_rank"], traffic["seq_len"]
    return np.where(rng.random(B) < traffic["short_seq_prob"],
                    rng.integers(2, S + 1, B), S)


def block(cfg: dict, traffic: dict, seed: int, index: int, rank: int,
          device) -> dict:
    """Each row's tokens split into sentences A and B (token types 0/1)
    at a uniform point; ``masked_lm_prob`` of its valid tokens (at most
    ``max_predictions_per_seq``) are MLM targets, of which 80 % become
    [MASK], 10 % a random token and 10 % stay; NSP labels are random."""
    rng = np.random.default_rng(derive(seed, "bert", index, rank))
    V = cfg["vocab_size"]
    B, S = traffic["rows_per_rank"], traffic["seq_len"]
    length = rng.permutation(lengths(traffic, index, rank))
    pos = np.arange(S)[None, :]
    valid = pos < length[:, None]
    labels = rng.integers(0, V, (B, S))
    ids = np.where(valid, labels, 0)
    split = rng.integers(1, np.maximum(length, 2))
    types = (valid & (pos >= split[:, None])).astype(np.int64)
    targets = np.zeros((B, S), bool)
    for b in range(B):
        n = min(traffic["max_predictions_per_seq"],
                max(1, int(round(length[b] * traffic["masked_lm_prob"]))))
        targets[b, rng.choice(length[b], n, replace=False)] = True
    roll = rng.random((B, S))
    ids = np.where(targets & (roll < 0.8), traffic["mask_token_id"], ids)
    ids = np.where(targets & (roll >= 0.8) & (roll < 0.9),
                   rng.integers(0, V, (B, S)), ids)
    nsp = rng.integers(0, 2, B)
    t = {"input_ids": ids, "token_type_ids": types,
         "attention_mask": valid.astype(np.int64), "mlm_labels": labels,
         "mlm_targets": targets, "nsp_labels": nsp}
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


def build(cfg: dict, state: dict):
    """(model, loss_fn): the port's model wrapping ``state``'s tensors."""
    from horovod_tpu_torch.models.bert import BertConfig, BertForPretraining
    from horovod_tpu_torch.ops.flash_attention import flash_attention_fn
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    bcfg = BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        dropout_rate=cfg["hidden_dropout_prob"],
        dtype=getattr(torch, cfg["training"]["compute_dtype"]))
    model = BertForPretraining.from_state_dict(
        bcfg, state, attention_fn=flash_attention_fn)

    def loss_fn(model, batch):
        with torch.profiler.record_function("gpubench.loss"):
            mlm_logits, nsp_logits = model(
                batch["input_ids"], batch["token_type_ids"],
                batch["attention_mask"], train=False)
            targets = batch["mlm_targets"]
            count = torch.clamp(targets.sum().float(), min=1)
            mlm = softmax_cross_entropy(mlm_logits, batch["mlm_labels"],
                                        where=targets, reduction="sum")
            return mlm / count + softmax_cross_entropy(nsp_logits,
                                                       batch["nsp_labels"])

    return model, loss_fn


def step_flops(cfg: dict, traffic: dict, index: int, world: int) -> int:
    S = traffic["seq_len"]
    return sum(flops.bert_flops(cfg, traffic["rows_per_rank"], S,
                                int(lengths(traffic, index, r).sum()))
               for r in range(world))


def attention_bound_s(cfg: dict, batch: dict) -> float:
    """The bound of one step's attention kernels on this rank's rows:
    forward, dQ and dK/dV at bf16 in every layer."""
    B, S = batch["input_ids"].shape
    heads = cfg["num_attention_heads"]
    D = cfg["hidden_size"] // heads
    valid = int(batch["attention_mask"].sum())
    return cfg["num_hidden_layers"] * sum(
        flops.flash_bound_s(k, B, S, heads, heads, D, valid)
        for k in flops.FLASH_KERNELS)
