"""Device ms a traced step in kernels whose names contain ``nccl``: the
gradient allreduce of ``DistributedOptimizer.step`` (``ops/fusion.py``,
``ops/collective_ops.py``)."""

from gpubench.metrics import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("nccl",))
