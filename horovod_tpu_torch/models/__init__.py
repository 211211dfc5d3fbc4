"""Model zoo of the port (counterparts of ``horovod_tpu/models/``): the
dense Llama decoder and its KV-cache generation paths, BERT
(``models/bert.py``) and ResNet (``models/resnet.py``)."""

from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel

__all__ = ["LlamaConfig", "LlamaModel"]
