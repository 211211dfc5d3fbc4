"""The reference's first steps of data-parallel training, and the numbers
the check compares.

One process plays every rank in turn: each step sums the ranks' gradients
of their own rows' losses and divides by the world size (the average the
program's allreduce forms), averages the ranks' losses and their running
statistics, then applies the optimizer's rule from ``optim.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from gpubench.reference import optim


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm, computed in float64 on the host."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().double().norm()
                        for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def follow(module, cfg: dict, weights: Dict[str, torch.Tensor],
           block: Callable[[int, int], dict], world: int, steps: int,
           dtype: torch.dtype) -> dict:
    """Run ``steps`` steps from ``weights`` (fp32; parameters and running
    statistics), rank r of step s on ``block(s, r)``.  Returns the losses,
    each parameter's first averaged gradient (``grads``) and its norm, each
    parameter's change after the steps (``change``) and the norm of each
    running statistic's change."""
    buffer_names = set(module.buffer_names(cfg))
    names = [n for n in weights if n not in buffer_names]
    p = {n: weights[n].detach().to(dtype).clone().requires_grad_(True)
         for n in names}
    buffers = {n: weights[n].to(dtype) for n in buffer_names}
    state = optim.init(cfg["optimizer"], list(p.values()))
    losses: List[float] = []
    first = None
    for s in range(steps):
        total = [torch.zeros_like(t) for t in p.values()]
        loss_sum = 0.0
        new_sum: Dict[str, torch.Tensor] = {}
        for r in range(world):
            loss, new = module.loss_and_buffers(p, buffers, block(s, r), cfg,
                                                dtype)
            grads = torch.autograd.grad(loss, list(p.values()))
            for acc, g in zip(total, grads):
                acc.add_(g)
            loss_sum += float(loss.detach().double())
            for n, t in new.items():
                new_sum[n] = new_sum[n] + t if n in new_sum else t
            del loss, grads, new
        grads = [g / world for g in total]
        losses.append(loss_sum / world)
        if first is None:
            first = dict(zip(names, [g.float() for g in grads]))
        optim.step(cfg["optimizer"], list(p.values()), grads, state, s + 1,
                   world)
        if new_sum:
            buffers = {n: t / world for n, t in new_sum.items()}
    change = {n: p[n].detach().float() - weights[n] for n in names}
    stats = norms({n: buffers[n].float() - weights[n]
                   for n in buffer_names})
    return {"losses": losses, "grads": first, "grad_norms": norms(first),
            "change": change, "stats_change_norms": stats}
