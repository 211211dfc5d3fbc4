"""The attention kernels' share of their roofline, in %: the sum of each
call's bound (from the batch's shapes and key mask, ``flops.flash_bound_s``)
over the device time of the ``flash`` kernel group, over the traced
steps."""

from gpubench.metrics import device_ms_per_step


def read(run):
    ms = device_ms_per_step(run, ("flash",))
    if ms is None or run.attention_bound_s is None:
        return None
    return 100.0 * run.attention_bound_s / (ms * run.traced_steps / 1e3)
