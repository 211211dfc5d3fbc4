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
the eager native engine (``runtime/``); and the engine-driven
optimizers: the reference torch frontend's hook form
(``hvd.torch_frontend.DistributedOptimizer``: gradient hooks that
enqueue each gradient's allreduce during the backward), ZeRO-1
(``runtime/sharded.py``), FSDP units (``runtime/fsdp.py``) and local SGD
(``hvd.elastic.LocalSGD``), which the JAX-form
``hvd.DistributedOptimizer(sharded=, fsdp=, local_sgd_steps=)`` reaches
through the same classes; and the sparse and expert planes:
``hvd.Compression.topk`` (top-k sparse allreduce with error feedback,
``hvd.runtime.sparse``), the statistics-driven wire policy
(``HOROVOD_WIRE_POLICY=1``, ``hvd.runtime.wire_policy``) and the
expert-parallel MoE layer over the variable-split alltoall
(``hvd.runtime.moe.MoeLayer``); and MoE in the model with the parallelism
families (``parallel/``): the mesh helpers (``hvd.build_mesh``,
``use_mesh``, ``default_mesh``, ``data_parallel_mesh``), tensor, expert
and fsdp placement with ``make_parallel_train_step``, ring and Ulysses
attention with ``make_context_parallel_train_step``, the GPipe pipeline
with ``make_pipelined_llama_train_step``, and ``ops/ragged.py``; and the
weight plane (``checkpoint/``: sharded async checkpoints of CUDA state,
resharding restore, live weight pushes), elastic recovery
(``hvd.elastic.ElasticState``, ``run_elastic``) and the training
launcher (``python -m horovod_tpu_torch.run -np N``); and the
observability and tuning planes: the engine's timeline and its merge
tool (``python -m horovod_tpu_torch.timeline merge``), the metrics
endpoint (``HOROVOD_METRICS_PORT``, ``run --status``) and
``hvd.fleet_stats()``, the flight recorder's postmortem
(``python -m horovod_tpu_torch.monitor.postmortem``), the stall
inspector (``HOROVOD_STALL_WARNING_SEC``), the engine autotuner
(``HOROVOD_AUTOTUNE``, ``run --print-config``) and the serve tuner
(``HOROVOD_SERVE_AUTOTUNE``); and the rest of the model zoo (the MNIST
models, skip-gram word2vec), the Keras-role training layer
(``horovod_tpu_torch.training``: ``fit``, the callbacks, per-epoch and
sharded checkpoints, the Estimator; the counterpart of
``horovod_tpu/flax/``) and the reference's examples
(``horovod_tpu_torch/examples/``); and the Keras 3 and TensorFlow
frontends over the engine (``horovod_tpu_torch.keras``, on Keras's torch
backend with CUDA gradients, and ``horovod_tpu_torch.tf``), which this
module does not import: they need Keras or TensorFlow, which
``horovod_tpu_torch.keras.impl``'s core of torch tensors does not; and
the device-plane collectives a step's loss function calls
(``ops/collective_ops.py``).

Two communicators, as in the reference:

* the device plane (``ops/collective_ops.py``): while a step built by
  ``make_train_step`` or ``parallel.api.make_parallel_train_step`` runs
  the user's loss function, ``hvd.allreduce``, ``grouped_allreduce``,
  ``allgather``, ``broadcast``, ``reducescatter`` and ``alltoall`` are
  collectives over ``torch.distributed`` groups of the step's mesh axes
  (default: its data axes; NCCL on the card), differentiable, with the
  backward ``jax.grad`` gives the reference's traced collectives;
  ``make_train_step``, ``DistributedOptimizer``, ``allreduce_gradients``
  and ``broadcast_parameters`` reduce over ``torch.distributed``'s default
  group too, the counterpart of the reference's traced ``psum``;
* the native engine: the same six names anywhere else, and their handles
  (``*_async``, ``poll``, ``synchronize``) everywhere, are the reference's
  eager collectives: named tensors through the native engine (``name=``,
  ``priority=``), on CPU or CUDA tensors, results on the input's device
  (``runtime/eager.py``, ``runtime/mpi_ops.py``); ``DistributedOptimizer``'s
  sharded, FSDP and local-SGD rungs, and all of ``torch_frontend``, go
  through it.
"""

from horovod_tpu_torch.common.basics import (device, epoch, fleet_stats,
                                             init, is_initialized,
                                             local_devices, local_rank,
                                             local_size,
                                             mpi_threads_supported,
                                             num_chips, rank, shutdown,
                                             size)
from horovod_tpu_torch import elastic, runtime, torch_frontend
from horovod_tpu_torch.runtime import moe, sparse, wire_policy  # noqa: F401
from horovod_tpu_torch.common.device import resolve_device
from horovod_tpu_torch.frontend import (DistributedOptimizer, allgather,
                                        allreduce, allreduce_gradients,
                                        alltoall, broadcast,
                                        broadcast_optimizer_state,
                                        broadcast_parameters,
                                        grouped_allreduce, make_train_step,
                                        reducescatter)
from horovod_tpu_torch.ops.collective_ops import (Average, Max, Min, Product,
                                                  ReduceOp, Sum)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.mesh import (build_mesh, data_parallel_mesh,
                                             default_mesh, use_mesh)
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
           "device", "num_chips", "local_devices", "epoch",
           "mpi_threads_supported", "fleet_stats",
           "ReduceOp", "Sum",
           "Average", "Min", "Max", "Product", "allreduce",
           "grouped_allreduce", "allgather", "broadcast", "reducescatter",
           "alltoall", "allreduce_async", "allreduce_async_", "allreduce_",
           "grouped_allreduce_async", "allgather_async", "broadcast_async",
           "broadcast_async_", "broadcast_", "reducescatter_async",
           "alltoall_async", "poll", "synchronize", "Compression",
           "allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "make_train_step", "torch_frontend", "elastic", "runtime",
           "build_mesh", "data_parallel_mesh", "default_mesh", "use_mesh"]
