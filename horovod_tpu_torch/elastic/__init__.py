"""Elastic training: the local-SGD policy.

Counterpart of ``horovod_tpu/elastic/``.  Ported so far:
:class:`LocalSGD` and :func:`default_local_sgd_steps`
(``elastic/state.py``), which ``DistributedOptimizer(local_sgd_steps=H)``
of both frontends drive.  ``ElasticState`` and ``run_elastic`` come with
the elastic plane, ROADMAP.md Queue A item 6.
"""

from horovod_tpu_torch.elastic.state import LocalSGD, default_local_sgd_steps

__all__ = ["LocalSGD", "default_local_sgd_steps"]
