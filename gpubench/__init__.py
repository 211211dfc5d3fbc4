"""The benchmark of ``horovod_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards.

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the workloads; each
configuration, traffic mix, metric and check limit is a file of its own
here (``configs/``, ``traffic/``, ``metrics/``, ``limits/``), with the
plain references in ``reference/`` and the port's side of each model
family in ``families/``.  ``python -m gpubench.calibrate`` reads the
numbers the check's limits are set from.  The tests:
``python -m pytest gpubench/tests -q`` (those marked ``cuda`` run on the
card only).  Nothing here imports ``jax`` or the JAX package
``horovod_tpu``.
"""
