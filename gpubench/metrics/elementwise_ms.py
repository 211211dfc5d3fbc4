"""Device ms a traced step of the ``elementwise`` and ``reduce`` kernel
groups: the models' eager norms, casts, activations and BatchNorm's fp32
chain."""

from gpubench.metrics import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("elementwise", "reduce"))
