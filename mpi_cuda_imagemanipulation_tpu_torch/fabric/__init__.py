"""Pod-scale serving fabric: a front-door router over N replica workers.
The counterpart of the JAX package's ``fabric/``.

The source paper's whole distribution story is MPI rank coordination:
scatter rows to N workers, compute, gather (kern.cpp:55-83). The serving
tier's analogue of "N workers" is N *replica processes*, each the full
serve stack (scheduler + engine + shape-bucket function cache) with its
own CUDA context, with a front-door HTTP router load-balancing
`POST /v1/process` across them, and, unlike MPI_COMM_WORLD, surviving a
worker dying mid-collective.

    fabric/control.py     replica -> router heartbeat protocol (health
                          state, queue depth, open breakers, hot buckets)
    fabric/router.py      the front door: sticky shape-bucket affinity
                          with consistent-hash fallback, health-/load-
                          aware shedding, per-replica circuit breakers,
                          rerouting retries, 503 + Retry-After only when
                          NO replica is serving
    fabric/replica.py     one replica worker process (python -m ...fabric
                          .replica --device D): Server + HeartbeatSender
                          + SIGTERM drain
    fabric/supervisor.py  spawn + monitor + restart-with-backoff, and the
                          `Fabric` facade (router + supervised replicas
                          as one context manager)
    fabric/mesh.py        the oversize lane: ONE request larger than every
                          bucket runs row-sharded over the slots of a
                          parallel.mesh mesh (slots of one card, or NCCL
                          ranks), while small requests ride the replicas
    fabric/canary.py, fabric/session.py, fabric/autoscaler.py
                          the canary gate, live video session routing
                          and the elastic control loop

The guiding principle is the software-systolic one (PAPERS.md, arxiv
1907.06154): keep every replica's scheduler fed from the request stream
even while sibling replicas churn.
"""

from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import (  # noqa: F401
    Heartbeat,
    HeartbeatSender,
)
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import (  # noqa: F401
    Router,
    RouterConfig,
)
from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import (  # noqa: F401
    Fabric,
    FabricConfig,
    Supervisor,
)
