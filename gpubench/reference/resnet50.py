"""Plain ResNet-50 v1.5 training (batch statistics) for the benchmark's
check.

Bottleneck blocks with the stride on the 3x3, a 1x1 projection where the
shapes change, post-activation, global average pool and a dense head,
with the configuration file's assumed details: XLA's "SAME" padding
(``total // 2`` before, the rest after) on the blocks' convolutions and
the max pool, padding 3 on the stem, and BatchNorm as the configuration
states it (statistics over N, H, W with the variance E[x²] − E[x]², eps
1e-5; running statistics r ← 0.99·r + 0.01·batch).  The loss is the mean
negative log-likelihood of the labels.  Every operation runs in
``dtype``: float32 for the reference, bfloat16 for the control.  Input
images are [B, H, W, 3].
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.flops import bottleneck_convs, resnet_blocks
from gpubench.weights import Spec


def _layout(cfg: dict):
    """(prefix, [(in, out, kernel, stride)]) of the stem and every block."""
    yield "", [(3, cfg["width"], 7, 2)]
    for i, (cin, filters, stride) in enumerate(
            resnet_blocks(cfg["stage_sizes"], cfg["width"])):
        yield f"blocks.{i}.", bottleneck_convs(cin, filters, stride)


def param_specs(cfg: dict) -> List[Spec]:
    """The weights and running statistics the benchmark draws, by the
    names the program's state dict uses: He-normal convolutions
    (N(0, 2 / fan_in)), BatchNorm scales 1 and biases 0, running means 0
    and variances 1, a N(0, 1 / fan_in) head with a zero bias."""
    specs: List[Spec] = []

    def norm(name, c):
        specs.extend([(f"{name}.scale", (c,), "ones", 0.0),
                      (f"{name}.bias", (c,), "zeros", 0.0),
                      (f"{name}.mean", (c,), "zeros", 0.0),
                      (f"{name}.var", (c,), "ones", 0.0)])

    for prefix, convs in _layout(cfg):
        for j, (ci, co, k, _) in enumerate(convs):
            name = "conv_init" if not prefix else f"{prefix}convs.{j}"
            specs.append((f"{name}.weight", (co, ci, k, k), "normal",
                          math.sqrt(2.0 / (ci * k * k))))
        for j, (_, co, _, _) in enumerate(convs):
            norm("bn_init" if not prefix else f"{prefix}norms.{j}", co)
    features = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1) * 4
    specs += [("head.weight", (cfg["num_classes"], features), "normal",
               1.0 / math.sqrt(features)),
              ("head.bias", (cfg["num_classes"],), "zeros", 0.0)]
    return specs


def buffer_names(cfg: dict) -> List[str]:
    return [s[0] for s in param_specs(cfg)
            if s[0].endswith((".mean", ".var"))]


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, padding=None):
    k = w.shape[-1]
    if padding is None:
        ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
        x = F.pad(x, (*pw, *ph))
        padding = 0
    return F.conv2d(x, w, stride=stride, padding=padding)


def loss_and_buffers(p: Dict[str, torch.Tensor],
                     buffers: Dict[str, torch.Tensor], batch: dict,
                     cfg: dict, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, the running statistics this rank's step leaves)."""
    eps = cfg["assumed"]["batch_norm_eps"]
    keep = cfg["assumed"]["batch_norm_momentum"]
    new: Dict[str, torch.Tensor] = {}

    def bn(x, name):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0)
        with torch.no_grad():
            new[name + ".mean"] = keep * buffers[name + ".mean"] \
                + (1 - keep) * mean
            new[name + ".var"] = keep * buffers[name + ".var"] \
                + (1 - keep) * var
        c = (1, -1, 1, 1)
        mul = torch.rsqrt(var + eps) * p[name + ".scale"]
        return (x - mean.view(c)) * mul.view(c) + p[name + ".bias"].view(c)

    x = batch["images"].to(dtype).permute(0, 3, 1, 2)
    x = F.relu(bn(_conv(x, p["conv_init.weight"], 2, padding=3), "bn_init"))
    ph, pw = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (*pw, *ph), value=-math.inf), 3, 2)
    for prefix, convs in list(_layout(cfg))[1:]:
        y = x
        for j, (_, _, _, stride) in enumerate(convs[:3]):
            y = bn(_conv(y, p[f"{prefix}convs.{j}.weight"], stride),
                   f"{prefix}norms.{j}")
            if j < 2:
                y = F.relu(y)
        residual = x
        if len(convs) > 3:
            residual = bn(_conv(x, p[f"{prefix}convs.3.weight"],
                                convs[3][3]), f"{prefix}norms.3")
        x = F.relu(residual + y)
    logits = F.linear(x.mean(dim=(2, 3)), p["head.weight"], p["head.bias"])
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch["labels"][:, None]).mean(), new
