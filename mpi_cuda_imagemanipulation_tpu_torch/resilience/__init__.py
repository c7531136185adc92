"""Fault tolerance, the counterpart of the JAX package's ``resilience/``.

  * `failpoints` - deterministic, seedable fault injection at named sites,
                   armed by ``MCIM_FAILPOINTS`` or ``run --failpoints``;
  * `retry`      - bounded exponential backoff with deterministic jitter;
  * `breaker`    - per-key circuit breakers (closed -> open -> half-open),
                   their transitions noted in the flight recorder;
  * `health`     - the serving lifecycle state machine
                   (starting -> serving <-> degraded -> draining -> stopped);
  * `journal`    - the append-only batch journal behind ``batch --resume``;
  * `deadline`   - deadline propagation, retry budgets and hedging, with
                   the closed tier and hedge-outcome vocabularies;
  * `chaos`      - seeded chaos schedules over the failpoint sites.

Each module behaves as the JAX package's, and each is
tested against its JAX twin. Their users in the JAX package are its
serving scheduler and server, its batch command, its fabric router and
its federation front door; the port's versions of those come later, and
until then the port itself calls only the failpoints.
"""

from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    CircuitBreaker,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.failpoints import (  # noqa: F401
    FailpointError,
    maybe_fail,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.health import (  # noqa: F401
    HealthState,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import (  # noqa: F401
    BatchJournal,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy,
    call_with_retry,
)
