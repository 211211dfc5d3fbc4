"""The optimizers' update rules, written out in plain tensor arithmetic.

``adamw``: decoupled weight decay, then Adam with bias correction, as
``torch.optim.AdamW`` defines it.  ``sgd``: heavy-ball momentum without
dampening, the buffer starting at the first gradient, as
``torch.optim.SGD`` defines it; its learning rate is ``lr_per_rank`` times
the world size.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def learning_rate(spec: dict, world: int) -> float:
    if "lr_per_rank" in spec:
        return spec["lr_per_rank"] * world
    return spec["lr"]


def init(spec: dict, params: List[torch.Tensor]) -> Dict[str, list]:
    if spec["name"] == "adamw":
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}
    if spec["name"] == "sgd":
        return {"buf": [None] * len(params)}
    raise ValueError(f"unknown optimizer {spec['name']!r}")


@torch.no_grad()
def step(spec: dict, params: List[torch.Tensor], grads: List[torch.Tensor],
         state: Dict[str, list], t: int, world: int) -> None:
    """Update ``params`` in place with step ``t`` (1-based)."""
    lr = learning_rate(spec, world)
    if spec["name"] == "adamw":
        b1, b2 = spec["betas"]
        eps, wd = spec["eps"], spec["weight_decay"]
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            p.mul_(1 - lr * wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt() + eps
            p.sub_(lr * (m / (1 - b1 ** t)) / denom)
        return
    mu = spec["momentum"]
    bufs = state["buf"]
    for i, (p, g) in enumerate(zip(params, grads)):
        bufs[i] = g.clone() if bufs[i] is None else bufs[i].mul_(mu).add_(g)
        p.sub_(lr * bufs[i])
