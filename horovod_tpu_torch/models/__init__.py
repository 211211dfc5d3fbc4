"""Model zoo of the port (counterparts of ``horovod_tpu/models/``): the
dense Llama decoder and its KV-cache generation paths, BERT
(``models/bert.py``), ResNet (``models/resnet.py``), the MNIST models
(``models/mnist.py``) and skip-gram word2vec (``models/word2vec.py``)."""

from horovod_tpu_torch.models.bert import (BertConfig, BertEncoder,
                                           BertForPretraining)
from horovod_tpu_torch.models.generation import decode_step, generate, prefill
from horovod_tpu_torch.models.llama import LlamaConfig, LlamaModel
from horovod_tpu_torch.models.mnist import MnistConvNet, MnistMLP
from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101)
from horovod_tpu_torch.models.word2vec import SkipGramModel, nce_loss

__all__ = ["MnistConvNet", "MnistMLP", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "SkipGramModel", "nce_loss",
           "BertConfig", "BertEncoder", "BertForPretraining", "LlamaConfig",
           "LlamaModel", "prefill", "decode_step", "generate"]
