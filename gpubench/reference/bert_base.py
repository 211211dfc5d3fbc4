"""Plain BERT pretraining (MLM + NSP) for the benchmark's check.

The encoder of google-research/bert (post-LayerNorm, tanh GELU, learned
positions, two token types), with the configuration file's assumed
details: LayerNorm epsilon 1e-6, the MLM output tied to the token table
with its own bias, the NSP head on the first position, no dropout.  The
loss is the MLM cross entropy summed over the rows' target positions and
divided by their count, plus the NSP cross entropy averaged over the
rows.  Every operation runs in ``dtype``: float32 for the reference, and
bfloat16 for the control.  Only the target positions' MLM logits are
formed; the other positions add nothing to the loss or its gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.weights import Spec


def _sizes(cfg: dict):
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return H, heads, H // heads, cfg["intermediate_size"]


def param_specs(cfg: dict) -> List[Spec]:
    """The weights the benchmark draws, by the names the program's state
    dict uses: N(0, initializer_range²) for matrices and tables, zeros
    for biases, ones for LayerNorm scales."""
    H, _, _, F_ = _sizes(cfg)
    std = cfg["initializer_range"]
    V = cfg["vocab_size"]

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in), "normal", std),
                (f"{name}.bias", (n_out,), "zeros", 0.0)]

    def norm(name):
        return [(f"{name}.weight", (H,), "ones", 0.0),
                (f"{name}.bias", (H,), "zeros", 0.0)]

    specs: List[Spec] = [
        ("mlm_bias", (V,), "zeros", 0.0),
        ("encoder.tok_emb.weight", (V, H), "normal", std),
        ("encoder.pos_emb.weight", (cfg["max_position_embeddings"], H),
         "normal", std),
        ("encoder.type_emb.weight", (cfg["type_vocab_size"], H), "normal",
         std)]
    specs += norm("encoder.ln_emb")
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        specs += dense(pre + "attention.qkv", H, 3 * H)
        specs += dense(pre + "attention.proj", H, H)
        specs += norm(pre + "ln_attn")
        specs += dense(pre + "mlp_in", H, F_)
        specs += dense(pre + "mlp_out", F_, H)
        specs += norm(pre + "ln_mlp")
    specs += dense("mlm_transform", H, H)
    specs += norm("mlm_ln")
    specs += dense("nsp", H, 2)
    return specs


def buffer_names(cfg: dict) -> List[str]:
    return []


def loss_and_buffers(p: Dict[str, torch.Tensor], buffers: dict,
                     batch: dict, cfg: dict, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, dict]:
    """(loss, {}) of one rank's rows; ``p`` holds tensors in ``dtype``."""
    H, heads, D, _ = _sizes(cfg)
    eps = cfg["assumed"]["layer_norm_eps"]
    ids, types = batch["input_ids"], batch["token_type_ids"]
    valid = batch["attention_mask"].bool()
    B, S = ids.shape

    def linear(x, name):
        return F.linear(x, p[name + ".weight"], p[name + ".bias"])

    def norm(x, name):
        return F.layer_norm(x, (H,), p[name + ".weight"], p[name + ".bias"],
                            eps)

    x = (p["encoder.tok_emb.weight"][ids]
         + p["encoder.pos_emb.weight"][:S][None]
         + p["encoder.type_emb.weight"][types])
    x = norm(x, "encoder.ln_emb")
    key_bias = torch.zeros((B, 1, 1, S), dtype=dtype, device=ids.device)
    key_bias = key_bias.masked_fill(~valid[:, None, None, :],
                                    torch.finfo(dtype).min)
    scale = 1.0 / math.sqrt(D)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        q, k, v = linear(x, pre + "attention.qkv").view(
            B, S, 3, heads, D).unbind(2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + key_bias
        probs = torch.softmax(scores, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H)
        x = norm(x + linear(a, pre + "attention.proj"), pre + "ln_attn")
        y = linear(F.gelu(linear(x, pre + "mlp_in"), approximate="tanh"),
                   pre + "mlp_out")
        x = norm(x + y, pre + "ln_mlp")
    targets = batch["mlm_targets"]
    h = F.gelu(linear(x[targets], "mlm_transform"), approximate="tanh")
    h = norm(h, "mlm_ln")
    logits = h @ p["encoder.tok_emb.weight"].t() + p["mlm_bias"]
    count = max(int(targets.sum()), 1)
    mlm = F.cross_entropy(logits, batch["mlm_labels"][targets],
                          reduction="sum") / count
    nsp = F.cross_entropy(linear(x[:, 0], "nsp"), batch["nsp_labels"])
    return mlm + nsp, {}
