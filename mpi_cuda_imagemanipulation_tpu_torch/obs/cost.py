"""Cost attribution: what each built function moves across its boundary
and allocates on the card, keyed by the fingerprints the caches already
use. The counterpart of the JAX package's ``obs/cost.py``, rewritten.

The JAX package reads XLA's ``cost_analysis()`` and ``memory_analysis()``
of each compiled executable. PyTorch runs eagerly and has no compiler cost
model, so the port's `CostRecord` holds what the card can show about one
call, the first call of each variant at a cache insertion site (the stream
runner's tile functions, ``Pipeline.jit``'s planned functions):

  * **boundary bytes**: ``arg_bytes`` and ``out_bytes`` are the sizes of
    the call's live argument and result tensors; ``alias_bytes`` counts
    results whose storage is an argument's (an input handed back). The
    **drift ratio** = boundary bytes / modelled bytes
    (``mcim_cost_model_drift_ratio{site,stage}``) checks the one-read,
    one-write model of a stage, a tile or a planned function: a ratio
    outside [MCIM_COST_DRIFT_MIN, MCIM_COST_DRIFT_MAX] counts in
    ``mcim_cost_drift_alerts_total`` and leaves a flight-recorder note.
    The ``cost.model`` failpoint mis-models a stage 4x, so that the alert
    path is testable. A ``plan``-site ratio goes to the online tuning
    store (``tune/store.online_store.record_io_scale``).
  * **temp_bytes** on a card, taken only by `attribute_plan`, which asks
    for it: before each stage the ledger reads
    ``torch.cuda.memory_allocated`` and resets the device's peak
    (``reset_peak_memory_stats``); after it, it synchronises once and takes
    ``max_memory_allocated`` - before - out_bytes, floored at 0: what the
    stage allocated beyond its result. The cache wrappers (`wrap_cache_fn`)
    record boundary bytes and drift only, so the main paths neither reset
    the process-wide peak nor synchronise. ``temp_bytes`` is None on the
    CPU and at the cache sites.
  * ``flops``, ``hlo_bytes`` and ``code_bytes`` are None: no compiler
    counts them. The ``mcim_cost_hlo_bytes`` and ``mcim_cost_flops``
    families stay registered with no samples, so that the exposition has
    the JAX package's families.

``attribute_plan`` attributes every stage of a built plan on a zero image,
each accepted stage on the megakernel K4 with ``pallas=True``.
``MCIM_COST_ATTRIB=0`` turns off the wrappers (`wrap_cache_fn` returns the
bare callable). Measuring cannot fail apart from the call itself (whose
exception propagates, and the next call is measured instead), so
``mcim_cost_extract_failures_total`` is registered with no samples too.

The measured roofline (`peak_gb_s`, `measured_gb_s`,
`measured_roofline_frac`) divides a byte rate by the card's data-sheet
memory rate, keyed by `utils.platform.device_kind`, or by
``MCIM_COST_PEAK_GBS`` where set; a kind the table does not hold raises.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import torch

from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_ATTRIB = "MCIM_COST_ATTRIB"
ENV_CAP = "MCIM_COST_CAP"
ENV_DRIFT_MIN = "MCIM_COST_DRIFT_MIN"
ENV_DRIFT_MAX = "MCIM_COST_DRIFT_MAX"
ENV_PEAK_GBS = "MCIM_COST_PEAK_GBS"

# data-sheet memory rate in GB/s by `utils.platform.device_kind`: the H100
# SXM5's HBM3 (NVIDIA H100 Tensor Core GPU data sheet)
PEAK_GB_S = {"NVIDIA H100 80GB HBM3": 3350.0}

# the bounded attribution-site label set (one per cache kind), the JAX
# package's; the port fills 'plan' and 'stream' so far
SITES = ("serve", "plan", "graph", "stream", "bench")


def enabled() -> bool:
    return env_registry.get_bool(ENV_ATTRIB)


def drift_band() -> tuple[float, float]:
    return env_registry.get_float(ENV_DRIFT_MIN), env_registry.get_float(ENV_DRIFT_MAX)


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """One call's measured cost (module docstring). The JAX package's
    fields; those no compiler counts here are None."""

    arg_bytes: float
    out_bytes: float
    alias_bytes: float
    temp_bytes: float | None  # None on the CPU and at the cache sites
    flops: float | None = None
    hlo_bytes: float | None = None
    code_bytes: float | None = None

    @property
    def boundary_bytes(self) -> float:
        """Bytes crossing the call's boundary, an argument handed back
        counted once (the modelled quantity)."""
        return self.arg_bytes + self.out_bytes - self.alias_bytes

    @property
    def peak_bytes(self) -> float:
        """Arguments + results + temporaries (0 where not measured)."""
        return self.arg_bytes + self.out_bytes + (self.temp_bytes or 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["boundary_bytes"] = self.boundary_bytes
        d["peak_bytes"] = self.peak_bytes
        return d


class CostLedger:
    """The bounded attribution store and its ``mcim_cost_*`` families: an
    LRU capped at MCIM_COST_CAP entries keyed (site, key, stage). One
    module-level instance (`cost_ledger`) serves every site."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self._lock = threading.Lock()
        self._store: OrderedDict[tuple[str, str, str], dict] = OrderedDict()
        r = self.registry
        self.executables = r.counter(
            "mcim_cost_executables_total",
            "Built functions cost-attributed, per site.",
            labels=("site",),
        )
        self.failures = r.counter(
            "mcim_cost_extract_failures_total",
            "Attributions that could not measure their call, per site (none "
            "in the port: measuring fails only with the call).",
            labels=("site",),
        )
        self.drift_alerts = r.counter(
            "mcim_cost_drift_alerts_total",
            "Drift ratios outside [MCIM_COST_DRIFT_MIN, MCIM_COST_DRIFT_MAX].",
            labels=("site",),
        )
        self.drift_ratio = r.gauge(
            "mcim_cost_model_drift_ratio",
            "Measured boundary bytes / modelled bytes per attributed stage "
            "(~1.0: the one-read-one-write model holds).",
            labels=("site", "stage"),
            fn=self._drift_gauge,
        )
        self.hlo_bytes = r.gauge(
            "mcim_cost_hlo_bytes",
            "Compiler-counted bytes accessed per (site, key); no samples in "
            "the port (no compiler cost model).",
            labels=("site", "key"),
            fn=lambda: self._field_gauge("hlo_bytes"),
        )
        self.flops = r.gauge(
            "mcim_cost_flops",
            "Compiler-counted flops per (site, key); no samples in the port.",
            labels=("site", "key"),
            fn=lambda: self._field_gauge("flops"),
        )
        self.temp_bytes = r.gauge(
            "mcim_cost_temp_bytes",
            "Bytes a stage allocated on the card beyond its result, per "
            "(site, key); attribute_plan's stages only, none on the CPU.",
            labels=("site", "key"),
            fn=lambda: self._field_gauge("temp_bytes"),
        )

    # -- gauges over the store ----------------------------------------------

    def _drift_gauge(self) -> dict:
        with self._lock:
            return {
                (site, stage): e["drift_ratio"]
                for (site, _key, stage), e in self._store.items()
                if e.get("drift_ratio") is not None
            }

    def _field_gauge(self, field: str) -> dict:
        out: dict = {}
        with self._lock:
            # one sample per (site, key): the whole-call entry ("all") wins
            # over a stage's; fields not measured give no sample
            for (site, key, stage), e in self._store.items():
                v = e["cost"][field]
                if v is not None and (stage == "all" or (site, key) not in out):
                    out[(site, key)] = v
        return out

    # -- recording -----------------------------------------------------------

    def record(
        self,
        site: str,
        key: str,
        cost: CostRecord,
        *,
        modeled_bytes: float | None = None,
        stage: str = "all",
    ) -> float | None:
        """Fold one attribution in; returns the drift ratio (measured
        boundary / modelled bytes) when a model was given. An armed
        ``cost.model`` failpoint multiplies the model by 4."""
        if site not in SITES:
            raise ValueError(f"unknown cost site {site!r}; known: {SITES}")
        ratio = None
        if modeled_bytes is not None and modeled_bytes > 0:
            try:
                failpoints.maybe_fail("cost.model", cost_site=site, key=key)
            except failpoints.FailpointError:
                modeled_bytes = modeled_bytes * 4.0
            ratio = cost.boundary_bytes / modeled_bytes
        entry = {"cost": cost.to_dict(), "modeled_bytes": modeled_bytes, "drift_ratio": ratio}
        with self._lock:
            self._store[(site, key, stage)] = entry
            self._store.move_to_end((site, key, stage))
            while len(self._store) > env_registry.get_int(ENV_CAP):
                self._store.popitem(last=False)
        self.executables.inc(site=site)
        if ratio is None:
            return None
        lo, hi = drift_band()
        if not lo <= ratio <= hi:
            self.drift_alerts.inc(site=site)
            recorder.note(
                "cost_drift", site=site, key=key, stage=stage, ratio=round(ratio, 4),
                measured=cost.boundary_bytes, modeled=modeled_bytes,
            )
            get_logger().warning(
                "cost drift alert: %s/%s stage %s ratio %.3f outside [%.2f, %.2f] "
                "(measured %d B vs modelled %d B)", site, key, stage, ratio, lo, hi,
                int(cost.boundary_bytes), int(modeled_bytes),
            )
        if site == "plan":
            # advisory, as in the JAX package: a store hiccup never fails
            # the attribution
            try:
                from mpi_cuda_imagemanipulation_tpu_torch.tune.store import online_store

                online_store.record_io_scale(key, stage, ratio)
            except Exception:  # noqa: BLE001 - the store is optional here
                get_logger().debug("io-scale record for %s/%s failed", key, stage)
        return ratio

    def entries(self) -> dict[tuple[str, str, str], dict]:
        with self._lock:
            return dict(self._store)

    def drift(self, site: str, key: str, stage: str = "all") -> float | None:
        with self._lock:
            e = self._store.get((site, key, stage))
        return None if e is None else e.get("drift_ratio")

    def snapshot(self) -> dict:
        entries = self.entries()
        return {
            "entries": len(entries),
            "attributed": {s: int(self.executables.value(site=s)) for s in SITES},
            "drift_alerts": {s: int(self.drift_alerts.value(site=s)) for s in SITES},
            "ratios": {
                f"{site}/{key}/{stage}": e["drift_ratio"]
                for (site, key, stage), e in entries.items()
                if e.get("drift_ratio") is not None
            },
        }


# the shared ledger every site reports into
cost_ledger = CostLedger()


# --------------------------------------------------------------------------
# measuring one call
# --------------------------------------------------------------------------


def _tensors(obj) -> list[torch.Tensor]:
    """The tensor leaves of a result tree (tuples, lists, dict values)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def measured_call(fn, args: tuple, *, temp: bool = False) -> tuple[object, CostRecord]:
    """``fn(*args)`` and its CostRecord (module docstring): boundary bytes
    from the argument and result tensors; with `temp`, on a card (the first
    CUDA argument's device) the temporary bytes too, at the price of a
    reset of the device's peak and one synchronisation. Exceptions of `fn`
    propagate."""
    ins = _tensors(args)
    arg_bytes = sum(t.nbytes for t in ins)
    ptrs = {t.untyped_storage().data_ptr() for t in ins} - {0}
    dev = next((t.device for t in ins if t.device.type == "cuda"), None) if temp else None
    if dev is not None:
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    outs = _tensors(out)
    out_bytes = sum(t.nbytes for t in outs)
    alias = sum(t.nbytes for t in outs if t.untyped_storage().data_ptr() in ptrs)
    temp = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        temp = float(max(0, torch.cuda.max_memory_allocated(dev) - before - out_bytes))
    cost = CostRecord(arg_bytes=float(arg_bytes), out_bytes=float(out_bytes),
                      alias_bytes=float(alias), temp_bytes=temp)
    return out, cost


class LazyAttributedFn:
    """A cache entry that attributes its first successful call
    (`measured_call`, boundary bytes only, recorded under (site, key, stage) with the modelled
    bytes ``modeled_fn(args)`` gives) and passes every later call
    through."""

    __slots__ = ("_fn", "_site", "_key", "_modeled_fn", "_stage", "_ledger", "_done", "_lock")

    def __init__(self, site: str, key: str, fn, *, modeled_fn=None, stage: str = "all",
                 ledger: CostLedger | None = None):
        self._fn = fn
        self._site = site
        self._key = key
        self._modeled_fn = modeled_fn
        self._stage = stage
        self._ledger = ledger or cost_ledger
        self._done = False
        self._lock = threading.Lock()

    def __call__(self, *args):
        if self._done:
            return self._fn(*args)
        with self._lock:
            if self._done:
                return self._fn(*args)
            try:
                modeled = None if self._modeled_fn is None else self._modeled_fn(args)
            except Exception:  # noqa: BLE001 - no model: record without a drift check
                modeled = None
            # the lock holds concurrent first calls until one is attributed
            # mcim-torch: allow(lock-blocking-call: temp is False on this call, so no synchronize)
            out, cost = measured_call(self._fn, args)
            self._done = True
        self._ledger.record(self._site, self._key, cost, modeled_bytes=modeled, stage=self._stage)
        return out


def wrap_cache_fn(site: str, key: str, fn, *, modeled_fn=None):
    """The cache insertion hook: `fn` attributed at its first call when the
    layer is enabled, the bare `fn` when not (MCIM_COST_ATTRIB=0)."""
    if not enabled():
        return fn
    if site not in SITES:
        raise ValueError(f"unknown cost site {site!r}; known: {SITES}")
    return LazyAttributedFn(site, key, fn, modeled_fn=modeled_fn)


# --------------------------------------------------------------------------
# per-stage plan attribution
# --------------------------------------------------------------------------


def modeled_shape(ops, shape: tuple) -> tuple:
    """The shape `ops` turn a u8 image of `shape` into, from the ops alone:
    channel counts from their declarations, a geometric op's shape from
    its function on a meta tensor (no data)."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family

    shape = tuple(shape)
    for op in ops:
        if op_family(op) == "geometric":
            shape = tuple(op.fn(torch.empty(shape, dtype=torch.uint8, device="meta")).shape)
        elif op.out_channels:
            shape = shape[:2] + ((3,) if op.out_channels == 3 else ())
    return shape


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def stage_fn(stage, shape: tuple, *, impl: str = "torch", pallas: bool = False):
    """The u8 image -> image function `attribute_plan` runs for one stage
    of a plan on an input of `shape`: its op for a barrier stage; one K4
    launch (``ops/cuda_kernels.fused_stage``) with `pallas` where the
    megakernel accepts the stage (``plan/cuda_exec.stage_kernel_reject``);
    else the stage walker with accumulators by `impl`."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import stage_kernel_reject
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for, run_stage_full

    if stage.kind in ("geometric", "global"):
        return stage.ops[0]
    ch = shape[2] if len(shape) == 3 else 1
    if pallas and stage_kernel_reject(stage, shape[0], shape[1], ch) is None:
        return lambda img: ck.fused_stage(stage.ops, img)
    acc_fns = acc_fns_for(stage.ops, impl)
    return lambda img: run_stage_full(stage, img, acc_fns)


def attribute_plan(
    plan,
    shape: tuple,
    *,
    impl: str = "torch",
    pallas: bool = False,
    device=None,
    ledger: CostLedger | None = None,
) -> list[dict]:
    """Attribute every stage of a built plan on a zero u8 image of `shape`
    on `device` (default CUDA; raises without it), the stages in order,
    each on the previous one's output: drift ratio per stage label
    ``s<i>/<kind>``, keyed by the plan's fingerprint. The model: a stage
    reads its u8 input once and writes its u8 output once.

    Each stage runs `stage_fn`'s function: with `pallas`, one K4 launch
    where the megakernel accepts the stage. On a card each stage's
    ``temp_bytes`` is measured (`measured_call` with ``temp=True``). ``pallas=True`` on the CPU
    raises: no plain version stands in for K4 here.

    Returns ``[{stage, names, modeled_bytes, cost, drift_ratio}, ...]``."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if pallas and dev.type != "cuda":
        raise RuntimeError(
            f"attribute_plan(pallas=True) runs stages on the megakernel K4, which needs a "
            f"CUDA device; got {str(dev)!r}"
        )
    led = ledger or cost_ledger
    x = torch.zeros(tuple(shape), dtype=torch.uint8, device=dev)
    out: list[dict] = []
    for i, st in enumerate(plan.stages):
        fn = stage_fn(st, x.shape, impl=impl, pallas=pallas)
        modeled = float(_numel(x.shape) + _numel(modeled_shape(st.ops, x.shape)))
        label = f"s{i}/{st.kind}"
        x, cost = measured_call(fn, (x,), temp=True)
        out.append({
            "stage": label,
            "names": list(st.names),
            "modeled_bytes": modeled,
            "cost": cost.to_dict(),
            "drift_ratio": led.record("plan", plan.fingerprint, cost, modeled_bytes=modeled,
                                      stage=label),
        })
    return out


# --------------------------------------------------------------------------
# measured roofline helpers
# --------------------------------------------------------------------------


def peak_gb_s(kind: str | None = None) -> float:
    """The roofline denominator: MCIM_COST_PEAK_GBS when set, else the
    data-sheet rate of `kind` (`utils.platform.device_kind`; None: the
    current CUDA device's). Raises for a kind the table does not hold."""
    override = env_registry.get(ENV_PEAK_GBS)
    if override:
        return float(override)
    if kind is None:
        from mpi_cuda_imagemanipulation_tpu_torch.utils.platform import device_kind

        kind = device_kind(None)
    try:
        return PEAK_GB_S[kind]
    except KeyError:
        raise ValueError(
            f"no data-sheet memory rate for device kind {kind!r} (known: {sorted(PEAK_GB_S)}); "
            f"set {ENV_PEAK_GBS}"
        ) from None


def measured_gb_s(nbytes: float, seconds: float, chips: int = 1) -> float:
    return nbytes / max(seconds, 1e-12) / max(chips, 1) / 1e9


def measured_roofline_frac(
    nbytes: float, seconds: float, *, chips: int = 1, kind: str | None = None,
) -> float:
    return measured_gb_s(nbytes, seconds, chips) / peak_gb_s(kind)
