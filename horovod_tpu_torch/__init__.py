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
BatchNorm-statistics spike (``experiments/conv_bn_spike.py``); the Llama
causal-LM bench (``python -m horovod_tpu_torch.bench --model llama``); and
the eager native engine (``runtime/``).

Two communicators, as ``common/basics.py`` sets out:

* ``hvd.allreduce``, ``grouped_allreduce``, ``allgather``, ``broadcast``,
  ``reducescatter`` and ``alltoall`` on tensors, and their handles
  (``*_async``, ``poll``, ``synchronize``), are the reference's eager
  collectives: named tensors through the native engine (``name=``,
  ``priority=``), on CPU or CUDA tensors, results on the input's device
  (``runtime/eager.py``, ``runtime/mpi_ops.py``);
* ``make_train_step``, ``DistributedOptimizer``, ``allreduce_gradients``
  and ``broadcast_parameters`` reduce over ``torch.distributed``'s default
  group (NCCL on the card), the counterpart of the reference's traced
  ``psum`` (``ops/collective_ops.py``).
"""

from horovod_tpu_torch.common.basics import (device, epoch, init,
                                             is_initialized, local_rank,
                                             local_size,
                                             mpi_threads_supported, rank,
                                             shutdown, size)
from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.frontend import (DistributedOptimizer,
                                        allreduce_gradients,
                                        broadcast_optimizer_state,
                                        broadcast_parameters,
                                        make_train_step)
from horovod_tpu_torch.ops.collective_ops import (Average, Max, Min, Product,
                                                  ReduceOp, Sum)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.runtime.eager import (allgather, allreduce, alltoall,
                                             broadcast, grouped_allreduce,
                                             reducescatter)
from horovod_tpu_torch.runtime.mpi_ops import (allgather_async, allreduce_,
                                               allreduce_async,
                                               allreduce_async_,
                                               alltoall_async, broadcast_,
                                               broadcast_async,
                                               broadcast_async_,
                                               grouped_allreduce_async, poll,
                                               reducescatter_async,
                                               synchronize)

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device", "init", "shutdown",
           "is_initialized", "rank", "size", "local_rank", "local_size",
           "device", "epoch", "mpi_threads_supported", "ReduceOp", "Sum",
           "Average", "Min", "Max", "Product", "allreduce",
           "grouped_allreduce", "allgather", "broadcast", "reducescatter",
           "alltoall", "allreduce_async", "allreduce_async_", "allreduce_",
           "grouped_allreduce_async", "allgather_async", "broadcast_async",
           "broadcast_async_", "broadcast_", "reducescatter_async",
           "alltoall_async", "poll", "synchronize", "Compression",
           "allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "make_train_step"]
