"""Operators of the port; each kernel beside its plain PyTorch version.

The package re-exports what the reference's ``horovod_tpu/ops/__init__``
does: the device plane's collectives (``collective_ops``), compression,
fusion and the ragged allgather.  The kernels' modules
(``flash_attention``, ``rms_norm``, ``paged_attention``,
``conv_bn_stats``) are imported by their own paths."""

from horovod_tpu_torch.ops.collective_ops import (Average, Max, Min, Product,
                                                  ReduceOp, Sum, allgather,
                                                  allreduce, alltoall,
                                                  axis_rank, axis_size,
                                                  broadcast,
                                                  grouped_allreduce,
                                                  reducescatter)
from horovod_tpu_torch.ops.compression import Compression, Compressor
from horovod_tpu_torch.ops.fusion import (DEFAULT_FUSION_THRESHOLD,
                                          FusionPlan, fuse_apply,
                                          fusion_threshold_bytes,
                                          plan_fusion)
from horovod_tpu_torch.ops.ragged import (bucket_rows, compact, pad_rows,
                                          ragged_allgather)

__all__ = ["Average", "Max", "Min", "Product", "ReduceOp", "Sum",
           "allgather", "allreduce", "alltoall", "axis_rank", "axis_size",
           "broadcast", "grouped_allreduce", "reducescatter", "Compression",
           "Compressor", "DEFAULT_FUSION_THRESHOLD", "FusionPlan",
           "fuse_apply", "fusion_threshold_bytes", "plan_fusion",
           "bucket_rows", "compact", "pad_rows", "ragged_allgather"]
