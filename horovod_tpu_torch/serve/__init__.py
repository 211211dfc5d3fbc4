"""Inference serving on the port: paged KV cache, continuous batching,
JSON-lines replicas and the multi-replica router (counterpart of
``horovod_tpu/serve/``).

Ported: ``config``, ``kv_cache``, ``engine`` (``ModelRunner``, the decode
step as one CUDA graph per pow2 width), ``scheduler``, ``server``
(``ReplicaServer``/``ServeClient``, router sessions), ``replica`` (fault
schedule, engine world) and ``router`` (``Router``/``serve_main``), with
checkpoint restore and live weight pushes (the weight plane,
``horovod_tpu_torch.checkpoint``), the serve autotuner (``tuner``,
``HOROVOD_SERVE_AUTOTUNE``) and the router's ``/metrics`` "serve" mount
(``HOROVOD_METRICS_PORT``).

Entry points: ``python -m horovod_tpu_torch.run --serve`` (router +
replicas), ``python -m horovod_tpu_torch.serve.replica`` (one replica),
``python -m horovod_tpu_torch.bench_serve`` (Poisson open-loop load).
"""

from horovod_tpu_torch.serve.config import ServeConfig, resolved_serve_config
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK, PagedKVCache
from horovod_tpu_torch.serve.router import Router, serve_main

__all__ = ["ServeConfig", "resolved_serve_config", "PagedKVCache", "TRASH_BLOCK", "Router",
           "serve_main"]
