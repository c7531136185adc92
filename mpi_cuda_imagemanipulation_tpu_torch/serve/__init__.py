"""Online serving: the port's front door for live traffic. The counterpart
of the JAX package's ``serve/``.

Every other entry point (`run`/`batch`/`stream`) is offline: a fixed input
list, then exit. `serve/` turns the same device path into an online
service:

  * `scheduler.py`: micro-batching scheduler: a bounded admission queue
                    feeding coalesced same-bucket stacked dispatches under
                    a max_batch / max_delay_ms policy, on the async engine
                    (engine/core.py: pinned side-stream H2D and D2H).
  * `bucketing.py`: shape buckets + stack padding (shared with `batch`).
  * `padded.py`:    the bucket-padded executor: requests padded up to a
                    bucket compute BYTE-IDENTICAL outputs to the
                    per-request golden path (per-image true-shape border
                    gathers and masks), so bucketing is only an execution
                    detail.
  * `cache.py`:     shape-bucket function cache, warmed on the device at
                    start so no request pays a first call.
  * `metrics.py`:   queue depth, batch occupancy, queue-wait/device time,
                    p50/p95/p99 end-to-end latency: a facade over the app's
                    obs/ registry (`/stats` is a view over it, `GET
                    /metrics` its Prometheus exposition).
  * `server.py`:    stdlib ThreadingHTTPServer front end (POST /v1/process,
                    GET /healthz, /stats, /metrics), the in-process
                    `Client` and the context-manager `Server`.
  * `loadgen.py`:   open-loop offered-load sweep, with a fault_rate knob
                    for availability runs.

Fault tolerance (resilience/): dispatch runs under a retrying executor
with per-bucket circuit breakers, poison requests quarantine solo instead
of failing their micro-batch, open breakers degrade traffic to the golden
per-request path, and /healthz reports the health state machine.
"""

from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing  # noqa: F401
from mpi_cuda_imagemanipulation_tpu_torch.serve.scheduler import (  # noqa: F401
    STATUS_DEADLINE,
    STATUS_OK,
    STATUS_OVERLOADED,
    STATUS_QUARANTINED,
    DeadlineExceeded,
    Overloaded,
    Quarantined,
    RequestRejected,
    ServeError,
)
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import (  # noqa: F401
    Client,
    ServeApp,
    ServeConfig,
    Server,
)
