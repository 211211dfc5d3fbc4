"""Samples (sequences or images, summed over ranks) completed in the
window over the window's seconds; the window ends with a synchronize()."""


def read(run):
    return run.steps * run.samples_per_step / run.window_s
