"""Process-level helpers shared by the port's entry points."""

from horovod_tpu_torch.common.device import resolve_device

__all__ = ["resolve_device"]
