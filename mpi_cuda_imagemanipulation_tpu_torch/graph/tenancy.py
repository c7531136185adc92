"""Multi-tenant admission: the QoS ladder. The counterpart of the JAX
package's ``graph/tenancy.py``, so far only the two names the serving
scheduler reads (``serve/scheduler.MicroBatchScheduler.submit(qos=...)``):
the admission classes and the load fraction below which each admits. The
tenant registry, quotas and per-tenant cache namespaces come with the
pipeline service (ROADMAP queue 1, item 6).

Under load the low class sheds first: a class admits only while the load
fraction is below its threshold (batch: the ``MCIM_GRAPH_QOS_SHED_FRAC``
shed threshold; standard: halfway between that and 1; interactive: full
capacity).
"""

from __future__ import annotations

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

ENV_QOS_SHED_FRAC = "MCIM_GRAPH_QOS_SHED_FRAC"

# admission classes, best first
QOS_CLASSES = ("interactive", "standard", "batch")


def qos_admit_frac(qos: str, shed_frac: float | None = None) -> float:
    """The load fraction below which `qos` still admits: interactive rides
    to full capacity, batch stops at the shed threshold, standard halfway
    between, so as load climbs past the threshold the classes shed strictly
    low-first."""
    if shed_frac is None:
        shed_frac = float(env_registry.get(ENV_QOS_SHED_FRAC))
    return {
        "interactive": 1.0,
        "standard": (1.0 + shed_frac) / 2.0,
        "batch": shed_frac,
    }[qos]
