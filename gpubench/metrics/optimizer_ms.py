"""Device ms a traced step of the ``optimizer`` kernel group
(``multi_tensor_apply``): the inner optimizer's update inside
``DistributedOptimizer.step``."""

from gpubench.metrics import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("optimizer",))
