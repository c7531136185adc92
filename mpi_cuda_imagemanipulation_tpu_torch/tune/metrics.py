"""Online-autotuning instrumentation: the `mcim_tune_*` metric family. The
counterpart of the JAX package's ``tune/metrics.py``.

One module-level registry, as plan/metrics.py has one: observations are
recorded from several entry points (in the JAX package the serve
scheduler's completion path, the cost ledger and the store's precedence
resolver; in the port so far the resolver), and a per-call registry would
fragment them. The tune controller's decision counters live on its own
registry and come with it.
"""

from __future__ import annotations

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry


class TuneMetrics:
    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        r = self.registry
        self.observations = r.counter(
            "mcim_tune_observations_total",
            "Online tuning observations ingested, by source (dispatch = "
            "serve-path per-image device seconds; ledger = measured "
            "boundary-byte ratios from the cost ledger).",
            labels=("source",),
        )
        self.stale_overrides = r.counter(
            "mcim_tune_stale_overrides_total",
            "Plan-choice resolutions where the newer of the offline "
            "record and the online promotion overrode the older one "
            "(freshness precedence: newest wins per key).",
        )
        self.quarantined = r.counter(
            "mcim_tune_quarantined_total",
            "Candidate flips quarantined in the calibration store after "
            "a canary breach (shadow-digest mismatch or burn).",
        )
        self.flushes = r.counter(
            "mcim_tune_flushes_total",
            "Online-record merges persisted to the calibration file.",
        )

    def snapshot(self) -> dict:
        return {
            "observations_dispatch": int(
                self.observations.value(source="dispatch")
            ),
            "observations_ledger": int(
                self.observations.value(source="ledger")
            ),
            "stale_overrides": int(self.stale_overrides.value()),
            "quarantined": int(self.quarantined.value()),
            "flushes": int(self.flushes.value()),
        }


tune_metrics = TuneMetrics()
