"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The JAX package (``horovod_tpu``) is the reference; this package mirrors
its module paths (``serve/engine.py`` here is the counterpart of
``horovod_tpu/serve/engine.py``) and is held against it by the
``tests/test_torch_port_*.py`` parity tests.  It never imports ``jax`` or
anything of ``horovod_tpu``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); without a GPU and without that
request they raise instead of falling back quietly.  Every TPU kernel on
a ported path is a hand-written Hopper kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``).

Ported so far: the paged-KV serving replica (``serve/``) over the dense
Llama model (``models/``) with the fused paged-attention decode kernel
(``ops/paged_attention.py``); and the data-parallel training step —
``import horovod_tpu_torch as hvd``: ``hvd.init()``, the model with
``ops.flash_attention.flash_attention_fn`` (forward and backward
kernels), ``ops.losses.softmax_cross_entropy``,
``hvd.DistributedOptimizer`` over ``ops.mixed_precision.MasterWeights``,
and ``hvd.make_train_step``; packed and BERT pretraining
(``examples/``); ResNet (``models/resnet.py``) with
``make_train_step`` (which averages its running statistics) and the ResNet-50
throughput bench (``python -m horovod_tpu_torch.bench``); and the conv +
BatchNorm-statistics spike (``experiments/conv_bn_spike.py``).
"""

from horovod_tpu_torch.common.basics import (device, init, is_initialized,
                                             local_rank, local_size, rank,
                                             shutdown, size)
from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.frontend import (DistributedOptimizer,
                                        allreduce_gradients,
                                        broadcast_optimizer_state,
                                        broadcast_parameters,
                                        make_train_step)
from horovod_tpu_torch.ops.collective_ops import (Average, Max, Min, Product,
                                                  ReduceOp, Sum, allreduce,
                                                  broadcast,
                                                  grouped_allreduce)
from horovod_tpu_torch.ops.compression import Compression

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device", "init", "shutdown",
           "is_initialized", "rank", "size", "local_rank", "local_size",
           "device", "ReduceOp", "Sum", "Average", "Min", "Max", "Product",
           "allreduce", "grouped_allreduce", "broadcast", "Compression",
           "allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "make_train_step"]
