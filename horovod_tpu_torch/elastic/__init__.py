"""Elastic training: commit/restore/sync of training state, the retry
driver, and the local-SGD policy.

Counterpart of ``horovod_tpu/elastic/``:

* :class:`ElasticState`: named slots (trees of tensors on any device,
  arrays, numbers) with ``commit`` (host copies), ``restore`` (in place)
  and ``sync`` (broadcast from rank 0 through the eager engine);
* :func:`run_elastic`: on a collective failure, tear down, back off,
  re-initialise with the first ``init``'s device and backend, roll back
  and retry (``HOROVOD_ELASTIC_MAX_RETRIES`` /
  ``HOROVOD_ELASTIC_BACKOFF_SEC``), restoring from
  ``HOROVOD_CHECKPOINT_DIR`` when rank 0 lost progress;
* :class:`LocalSGD` and :func:`default_local_sgd_steps`, which
  ``DistributedOptimizer(local_sgd_steps=H)`` of both frontends drive.
"""

from horovod_tpu_torch.elastic.driver import run_elastic
from horovod_tpu_torch.elastic.state import (ElasticState, LocalSGD,
                                             default_local_sgd_steps)

__all__ = ["ElasticState", "LocalSGD", "default_local_sgd_steps",
           "run_elastic"]
