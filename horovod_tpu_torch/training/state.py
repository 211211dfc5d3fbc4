"""The train state :func:`horovod_tpu_torch.training.fit` and its
callbacks pass around: the torch counterpart of flax's ``TrainState``
(params + optimizer state + step in one pytree)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    """``model`` (its parameters and buffers), ``optimizer`` (a
    ``torch.optim`` optimizer, ``MasterWeights``, or either wrapped in a
    ``DistributedOptimizer``) and ``step``, the number of steps taken
    (the user's train step advances it, as flax's ``apply_gradients``
    does).  Callbacks update it in place and return it."""

    model: torch.nn.Module
    optimizer: object
    step: int = 0
