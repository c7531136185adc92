"""mcim-check for the port — the static analysis gate over the port's
own files, and the runtime lock-order recorder.

The counterpart of the JAX package's ``analysis/``: four rule families
over the port's conventions, plus a recorder that validates the static
concurrency model at run time:

  * concurrency (rules_concurrency.py) — static lock-order graph,
    blocking-calls-under-lock (the torch device syncs included),
    guard-consistency for shared attributes;
  * tracer (rules_tracer.py) — use-after-donation (the JAX package's
    four tracing rules have no counterpart in eager PyTorch);
  * obs (rules_obs.py) — span lifecycle, metric naming scheme,
    failpoint site registry, the closed reason vocabularies, cost
    attribution at every compile-cache insertion;
  * surface (rules_surface.py) — CLI flags and MCIM_* env vars vs the
    docs and the utils/env.py registry.

Run via ``python -m mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check``
(text or ``--format json``); suppress a false positive inline with
``# mcim-torch: allow(<rule>: reason)`` (core.py says why the marker is
not the JAX package's).
"""

from mpi_cuda_imagemanipulation_tpu_torch.analysis.core import (  # noqa: F401
    RULES,
    Finding,
    Repo,
    render_json,
    render_text,
    run,
)
