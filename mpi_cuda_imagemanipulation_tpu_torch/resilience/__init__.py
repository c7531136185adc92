"""Fault injection, the counterpart of the JAX package's ``resilience/``.

  * `failpoints` - deterministic, seedable fault injection at named sites,
    armed by ``MCIM_FAILPOINTS`` or ``run --failpoints``.

The JAX package's retry, breaker, health and journal modules serve its
serving and batch layers, which the port does not have yet.
"""

from mpi_cuda_imagemanipulation_tpu_torch.resilience.failpoints import (  # noqa: F401
    FailpointError,
    maybe_fail,
)
