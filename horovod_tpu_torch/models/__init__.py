"""Model zoo of the port: the dense Llama decoder and its KV-cache
generation paths (counterparts of ``horovod_tpu/models/``)."""

from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel

__all__ = ["LlamaConfig", "LlamaModel"]
