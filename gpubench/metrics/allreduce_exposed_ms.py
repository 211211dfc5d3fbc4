"""Device ms a traced step in which an NCCL kernel runs and no other
device operation does: the allreduce's time that nothing hides."""

from gpubench.trace import length, overlap, union


def read(run):
    if run.trace is None:
        return None
    nccl = union((o.start, o.end) for o in run.trace.kernels(("nccl",)))
    if not nccl:
        return None
    rest = union((o.start, o.end) for o in run.trace.device
                 if o.group != "nccl")
    return (length(nccl) - overlap(nccl, rest)) / 1e3 / run.traced_steps
