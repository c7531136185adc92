"""Observability: tracing, metrics and the flight recorder. The counterpart
of the JAX package's ``obs/``.

  * `obs/trace.py`    - request-scoped spans with cross-thread context
                        propagation, deterministic sampling and
                        Chrome/Perfetto trace-event export (``run
                        --trace-out``).
  * `obs/metrics.py`  - counters, gauges and histograms in one named
                        registry with Prometheus text exposition.
  * `obs/recorder.py` - the always-on flight recorder: a bounded ring of
                        recent facts, dumped to JSON post-mortems.
  * `obs/profile.py`  - torch.profiler captures (``run --profile-dir``,
                        ``POST /control/profile``), Chrome trace parsing,
                        the DMA/compute split, host spans merged onto the
                        device timeline.
  * `obs/fleet.py`    - metrics federation: heartbeat delta snapshots,
                        restart-safe counter folding, bucket-merged fleet
                        histograms, the fabric router's one-pod view.
  * `obs/slo.py`      - declarative SLOs evaluated as multi-window burn
                        rates over the federated view (``GET /slo``).

The JAX package's ``cost``, ``devmem`` and ``profile`` are rewritten for
the card with the engine, streaming and serving layers that read them.
"""

from mpi_cuda_imagemanipulation_tpu_torch.obs import fleet  # noqa: F401
from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder  # noqa: F401
from mpi_cuda_imagemanipulation_tpu_torch.obs import slo  # noqa: F401
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace  # noqa: F401
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import (  # noqa: F401
    CONTENT_TYPE,
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    parse_exposition,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs.trace import (  # noqa: F401
    NOOP_SPAN,
    SpanContext,
    Tracer,
    current_context,
    current_trace_id,
    event,
    span,
    start_trace,
)

__all__ = [
    "CONTENT_TYPE",
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "NOOP_SPAN",
    "Registry",
    "SpanContext",
    "Tracer",
    "current_context",
    "current_trace_id",
    "event",
    "fleet",
    "parse_exposition",
    "recorder",
    "slo",
    "span",
    "start_trace",
    "trace",
]
