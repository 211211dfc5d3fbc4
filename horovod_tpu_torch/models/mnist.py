"""MNIST models (PyTorch).

Counterpart of ``horovod_tpu/models/mnist.py``: a small convnet (conv-pool
×2 → dense) and an MLP, used by the example scripts.  The math is the
flax modules':

* **Layout.** The public input is NHWC, ``x [B, 28, 28, 1]``, as the
  reference's.  The trunk runs on the NCHW view of it (``permute``, the
  same bytes: channels-last memory), and the features are flattened back
  in flax's (H, W, C) order, so the first ``Dense`` weight's 3136 input
  columns are the flax kernel's rows in their own order
  (``models/convert.py`` only transposes ``[in, out]`` to ``[out, in]``).
* **Parameters are fp32 and computation runs in ``dtype``** (bf16 by
  default), as flax's ``Conv(dtype=)``/``Dense(dtype=)`` with fp32
  ``param_dtype``: each layer casts its input, weight and bias to
  ``dtype`` at every use and returns ``dtype``.  The last ``Dense``
  computes in fp32 (flax's ``Dense(dtype=float32)`` promotes its bf16
  input).  ``padding="SAME"`` for a 5×5 convolution at stride 1 is 2 on
  every side; the 2×2 max pools at stride 2 are VALID (28 → 14 → 7).

Both classes draw seeded weights (``convert.init_params``: flax's
``lecun_normal`` kernels and zero biases, in distribution, not in bits)
from ``seed`` or an explicit ``torch.Generator``, on the CUDA device
unless given ``device="cpu"``; ``from_state_dict`` wraps converted
weights (``convert.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["MnistConfig", "MnistConvNet", "MnistMLP"]


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    """``kind``: ``"conv"`` (:class:`MnistConvNet`) or ``"mlp"``
    (:class:`MnistMLP`, whose hidden width is ``hidden``)."""

    kind: str = "conv"
    num_classes: int = 10
    hidden: int = 128
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.kind not in ("conv", "mlp"):
            raise ValueError(f"kind must be 'conv' or 'mlp', got "
                             f"{self.kind!r}")


def _conv(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype
          ) -> torch.Tensor:
    return F.conv2d(x.to(dt), layer.weight.to(dt), layer.bias.to(dt),
                    padding=2)


def _dense(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype
           ) -> torch.Tensor:
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class _MnistNet(nn.Module):
    """Weights of ``config``: seeded, or assigned by
    :meth:`from_state_dict` (``device="meta"`` allocates nothing)."""

    def __init__(self, cfg: MnistConfig, seed, generator, device):
        super().__init__()
        self.config = cfg
        self._layers()
        if torch.device(device or "cpu").type != "meta":
            from horovod_tpu_torch.models.convert import init_params

            state = init_params(cfg, seed if generator is None
                                else generator, device)
            self.load_state_dict(state, strict=True, assign=True)

    @classmethod
    def from_state_dict(cls, state: Dict[str, torch.Tensor], **fields
                        ) -> "_MnistNet":
        """Wrap ready fp32 tensors (``convert.params_from_jax``) without
        a second copy; ``fields``: the constructor's."""
        model = cls(**fields, device="meta")
        model.load_state_dict(state, strict=True, assign=True)
        return model


class MnistConvNet(_MnistNet):
    """Conv(32) → pool → Conv(64) → pool → Dense(512) → Dense(classes);
    ``forward(x [B, 28, 28, 1]) -> fp32 logits [B, num_classes]``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(MnistConfig("conv", num_classes, dtype=dtype), seed,
                         generator, device)

    def _layers(self):
        meta = dict(dtype=torch.float32, device="meta")
        self.conv_0 = nn.Conv2d(1, 32, 5, **meta)
        self.conv_1 = nn.Conv2d(32, 64, 5, **meta)
        self.dense_0 = nn.Linear(7 * 7 * 64, 512, **meta)
        self.dense_1 = nn.Linear(512, self.config.num_classes, **meta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(_conv(self.conv_0, x, dt)), 2, 2)
        x = F.max_pool2d(F.relu(_conv(self.conv_1, x, dt)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(self.dense_0, x, dt))
        return _dense(self.dense_1, x, torch.float32)


class MnistMLP(_MnistNet):
    """Dense(hidden) → Dense(classes), the keras_mnist-style small model;
    ``forward(x [B, 28, 28, 1]) -> fp32 logits``."""

    def __init__(self, num_classes: int = 10, hidden: int = 128,
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(MnistConfig("mlp", num_classes, hidden, dtype),
                         seed, generator, device)

    def _layers(self):
        meta = dict(dtype=torch.float32, device="meta")
        self.dense_0 = nn.Linear(28 * 28, self.config.hidden, **meta)
        self.dense_1 = nn.Linear(self.config.hidden,
                                 self.config.num_classes, **meta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        x = F.relu(_dense(self.dense_0, x.reshape(x.shape[0], -1), dt))
        return _dense(self.dense_1, x, torch.float32)
