"""The inner optimizer a configuration names, as a user builds it, and
the first gradient read back from its state.

``adamw`` is ``torch.optim.AdamW``; ``sgd`` is ``torch.optim.SGD`` with
momentum at ``lr_per_rank`` times the world size.  After one step AdamW's
first moment holds (1 − β1)·g and SGD's momentum buffer holds g, the
averaged gradient the optimizer was given.
"""

from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference.optim import learning_rate


def make(spec: dict, params, world: int) -> torch.optim.Optimizer:
    lr = learning_rate(spec, world)
    if spec["name"] == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=tuple(spec["betas"]),
                                 eps=spec["eps"],
                                 weight_decay=spec["weight_decay"])
    if spec["name"] == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=spec["momentum"])
    raise ValueError(f"unknown optimizer {spec['name']!r}")


def first_gradients(spec: dict, opt: torch.optim.Optimizer,
                    params: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient of step 1, from ``opt``'s state after
    that step (zeros where the optimizer holds no state for it: it never
    stepped)."""
    key, scale = (("exp_avg", 1 / (1 - spec["betas"][0]))
                  if spec["name"] == "adamw" else ("momentum_buffer", 1.0))
    return {n: (opt.state[p][key] * scale if key in opt.state.get(p, {})
                else torch.zeros_like(p)) for n, p in params.items()}
