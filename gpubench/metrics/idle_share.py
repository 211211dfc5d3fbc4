"""The device's idle share of the traced stretch, in %: 1 − the union of
its operations' intervals over the stretch from the first operation's
start to the last one's end (rank 0's card)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us())
