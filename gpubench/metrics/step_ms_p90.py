"""The 90th percentile of every step of the window, each step timed
between CUDA events recorded at its boundaries on rank 0's stream."""

import statistics


def read(run):
    if len(run.step_ms) < 2:
        return None
    return statistics.quantiles(run.step_ms, n=10, method="inclusive")[8]
