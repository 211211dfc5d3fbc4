"""Device resolution for the port's entry points.

The port runs on the CUDA device.  The CPU is a deliberate choice of the
caller (tests, a laptop smoke run), never a silent fallback: asked for no
device on a machine without a GPU, :func:`resolve_device` raises and says
how to ask for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises ``RuntimeError``
    when there is none.  An explicit ``"cpu"`` is honoured; an explicit
    CUDA device raises when CUDA is unavailable.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "--device cpu on the command line) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
