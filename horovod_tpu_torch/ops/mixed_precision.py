"""Master-weight mixed precision: bf16 compute params, fp32 optimizer.

Counterpart of ``horovod_tpu/ops/mixed_precision.py``.  The model keeps
its parameters in the compute dtype (bf16), and :class:`MasterWeights`
keeps an fp32 master copy of each: ``step()`` upcasts the gradients onto
the masters, the inner ``torch.optim`` optimizer steps the masters in
fp32, and the model's parameters are re-derived from the masters.

Re-deriving differs from the reference in its last bit: the reference
adds ``(master - p).astype(bf16)`` to ``p`` (within one bf16 ulp of the
rounded master); here ``p`` is the master rounded to nearest even, which
the reference's result is within one ulp of.  Either way the master is
the authoritative value and the drift never accumulates.  Masters are
always fp32 (:data:`MASTER_DTYPE`), as the reference's; a parameter
already in fp32 is its own master (no copy).
"""

from __future__ import annotations

from typing import Iterable, List

import torch

__all__ = ["MasterWeights", "MASTER_DTYPE"]

MASTER_DTYPE = torch.float32


class MasterWeights:
    """``optimizer_cls(masters, **kwargs)`` stepping fp32 masters of
    ``params``, with the optimizer calls a training step makes:
    ``zero_grad``, ``step`` and ``state``.

    ``model_params`` are the parameters whose ``.grad`` the backward
    fills (and ``DistributedOptimizer`` reduces); ``masters`` the tensors
    the inner optimizer updates.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], optimizer_cls,
                 **kwargs):
        self.model_params: List[torch.nn.Parameter] = [
            p for p in params if p.requires_grad]
        self.masters: List[torch.Tensor] = [
            p if p.dtype == MASTER_DTYPE
            else p.detach().to(MASTER_DTYPE).requires_grad_(True)
            for p in self.model_params]
        self.inner = optimizer_cls(self.masters, **kwargs)

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.model_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        for p, m in zip(self.model_params, self.masters):
            if m is not p:
                m.grad = None if p.grad is None else \
                    p.grad.to(MASTER_DTYPE)
        self.inner.step()
        for p, m in zip(self.model_params, self.masters):
            if m is not p:
                p.copy_(m)
                m.grad = None
