"""Seconds from the process's start to the first timed step: imports,
the launcher and NCCL's initialisation, weights, the checked steps and
the warm-up."""


def read(run):
    return run.setup_s
