"""Inference serving on the port: paged KV cache, continuous batching,
JSON-lines replica (counterpart of ``horovod_tpu/serve/``).

Ported: ``config``, ``kv_cache``, ``engine`` (``ModelRunner``),
``scheduler``, ``server`` (``ReplicaServer``/``ServeClient``) and
``replica``.  The router and the serve autotuner come later.
"""

from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.kv_cache import TRASH_BLOCK, PagedKVCache

__all__ = ["ServeConfig", "PagedKVCache", "TRASH_BLOCK"]
