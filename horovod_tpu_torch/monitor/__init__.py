"""Fleet observability plane: live metrics endpoint + post-mortem tools.

Counterpart of ``horovod_tpu/monitor/`` (the port keeps its own copy).

* :mod:`horovod_tpu_torch.monitor.metrics` — the metric registry driving the
  Prometheus/JSON renderers and the docs reference table.
* :mod:`horovod_tpu_torch.monitor.server` — rank 0's HTTP endpoint
  (HOROVOD_METRICS_PORT; started by ``hvd.init``), plus the
  ``python -m horovod_tpu_torch.run --status`` client helpers.
* :mod:`horovod_tpu_torch.monitor.postmortem` — cross-correlates per-rank
  flight-recorder dumps (HOROVOD_FLIGHT_RECORDER_DIR) and names the
  divergence point: ``python -m horovod_tpu_torch.monitor.postmortem <dir>``.

See docs/observability.md.
"""

from horovod_tpu_torch.monitor.metrics import (
    STATS_METRICS,
    TELEM_COUNTERS,
    format_reference,
    render_json,
    render_prometheus,
)
from horovod_tpu_torch.monitor.server import (
    MetricsServer,
    format_status,
    get_metrics_server,
    query_status,
    start_metrics_server,
    stop_metrics_server,
)

__all__ = [
    "MetricsServer",
    "STATS_METRICS",
    "TELEM_COUNTERS",
    "format_reference",
    "format_status",
    "get_metrics_server",
    "query_status",
    "render_json",
    "render_prometheus",
    "start_metrics_server",
    "stop_metrics_server",
]
