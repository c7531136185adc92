"""Online observation store: serving telemetry under autotune keys. The
counterpart of the JAX package's ``tune/store.py``, with the same file
sections, keys and merge rules.

Offline sweeps write `device_kinds.<kind>.plan_choice.<fingerprint>`
records; this module accumulates what the fleet measures about itself
at SERVING time under the same `(device_kind, pipeline_fingerprint,
width_window)` keys, in a sibling top-level section of the same
calibration file:

    online.<kind>.obs.<pipe_fp>.<window>.<arm>.samples = [[t, v], ...]
    online.<kind>.io_scale.<plan_fp>.<stage> = {ratio, at}
    online.<kind>.promoted.<pipe_fp> = {choice, width, at}
    online.<kind>.quarantine.<pipe_fp>.<arm> = {reason, at}
    tune_audit = [ {t, decision, ...}, ... ]          (bounded trail)

Three properties keep this safe on the serve path:

  * bounded — reservoirs cap at MCIM_TUNE_RESERVOIR samples per arm
    (newest win) and staleness decay (half-life MCIM_TUNE_STALE_S)
    discounts what survives, so a workload shift re-converges instead
    of being anchored by history;
  * cheap — ingestion appends to process memory; the file is only
    touched by a rate-limited merge (MCIM_TUNE_FLUSH_S) that re-reads,
    unions by timestamp and atomically rewrites, so N replicas sharing
    one store converge instead of clobbering each other;
  * off by default — persistence requires MCIM_TUNE=1 and respects
    MCIM_NO_CALIB like every other calibration consumer. In-memory
    ingestion always runs (it is just a deque append) so a single
    process can still introspect itself.

Width windows are power-of-two anchors (`1 << (w.bit_length()-1)`): the
factor-of-two rule the offline store applies at lookup time, applied
here at RECORD time so observations at 500 and 512 wide share a bucket.

Freshness precedence (`effective_plan_choice`): when an offline
`plan_choice` record and an online `promoted` record disagree for the
same key, the newer `recorded_at`/`at` stamp wins and
`mcim_tune_stale_overrides_total` counts the override.
plan/planner.resolve_plan_mode reads it where ``plan='auto'`` finds no
MCIM_PLAN.

Records are keyed by the device kind of utils/platform.device_kind (the
card's name, such as ``"NVIDIA H100 80GB HBM3"``, or ``"cpu"``), so an
online record taken under a TPU's kind never steers the card.
"""

from __future__ import annotations

import math
import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.tune.metrics import tune_metrics
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

_ENV_TUNE = "MCIM_TUNE"
_ENV_STALE_S = "MCIM_TUNE_STALE_S"
_ENV_RESERVOIR = "MCIM_TUNE_RESERVOIR"
_ENV_FLUSH_S = "MCIM_TUNE_FLUSH_S"

_ONLINE_KEY = "online"
_AUDIT_KEY = "tune_audit"
_AUDIT_CAP = 512


def width_window(width: int) -> str:
    """Power-of-two anchor bucketing a width into its factor-of-two
    window (500 and 512 -> "256"; the offline lookup rule, applied at
    record time)."""
    w = max(1, int(width))
    return str(1 << (w.bit_length() - 1))


def _now() -> float:
    return time.time()


def _device_kind() -> str | None:
    try:
        return calibration.current_device_kind()
    except Exception:
        return None


class OnlineStore:
    """Process-local reservoir of online observations + the merge/flush
    protocol against the shared calibration file.

    All public record_* methods are lock-protected and never raise on
    the happy path contract the serve scheduler needs: a broken store
    file or missing backend must degrade to "no observation", not a
    failed dispatch (callers still wrap in try/except as belt and
    braces)."""

    def __init__(self, clock=None):
        self._clock = clock or _now
        self._lock = threading.Lock()
        # obs[(kind, pipe_fp, window, arm)] = list[[t, v]]
        self._obs: dict[tuple, list] = {}
        # io[(kind, plan_fp, stage)] = (ratio, t)
        self._io: dict[tuple, tuple] = {}
        # promoted[(kind, pipe_fp)] = {"choice", "width", "at"}
        self._promoted: dict[tuple, dict] = {}
        # quarantine[(kind, pipe_fp, arm)] = {"reason", "at"}
        self._quarantine: dict[tuple, dict] = {}
        self._audit_pending: list[dict] = []
        self._last_t: dict[tuple, float] = {}
        self._dirty = False
        self._last_flush = 0.0
        self._kind: str | None = None

    # -- config ----------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        """Persistence armed? (MCIM_TUNE=1 and calibration not disabled.)"""
        return env_registry.get_bool(_ENV_TUNE) and not env_registry.get(
            "MCIM_NO_CALIB"
        )

    @staticmethod
    def _stale_s() -> float:
        v = env_registry.get_float(_ENV_STALE_S)
        return v if v and v > 0 else 900.0

    @staticmethod
    def _reservoir() -> int:
        v = env_registry.get_int(_ENV_RESERVOIR)
        return v if v and v > 0 else 64

    @staticmethod
    def _flush_s() -> float:
        v = env_registry.get_float(_ENV_FLUSH_S)
        return v if v is not None and v >= 0 else 1.0

    def _resolve_kind(self) -> str | None:
        with self._lock:
            if self._kind is not None:
                return self._kind
        kind = _device_kind()  # may initialize the backend: not under lock
        with self._lock:
            if self._kind is None and kind is not None:
                self._kind = kind
            return self._kind or kind

    # -- ingestion -------------------------------------------------------

    def record_dispatch(
        self, pipe_fp: str, width: int, arm: str, device_s: float
    ) -> None:
        """One serve-path observation: per-image device seconds under
        `arm` for (pipeline fingerprint, width window)."""
        kind = self._resolve_kind()
        if kind is None or not pipe_fp or device_s <= 0:
            return
        key = (kind, pipe_fp, width_window(width), str(arm))
        t = round(self._clock(), 3)
        with self._lock:
            # strictly increasing per key: the flush merge unions by
            # (t, v), so two sub-millisecond dispatches with equal cost
            # must not collapse into one observation
            last = self._last_t.get(key)
            if last is not None and t <= last:
                t = round(last + 0.001, 3)
            self._last_t[key] = t
            samples = self._obs.setdefault(key, [])
            samples.append([t, float(device_s)])
            cap = self._reservoir()
            if len(samples) > cap:
                del samples[: len(samples) - cap]
            self._dirty = True
        tune_metrics.observations.inc(source="dispatch")
        self.flush()

    def record_io_scale(self, plan_fp: str, stage: str, ratio: float) -> None:
        """One measured boundary-bytes/modeled-bytes ratio from the cost
        ledger, persisted so OTHER processes (and future builds in this
        one) can correct the analytical byte model."""
        kind = self._resolve_kind()
        if kind is None or not plan_fp or not ratio or ratio <= 0:
            return
        with self._lock:
            self._io[(kind, str(plan_fp), str(stage))] = (
                float(ratio),
                round(self._clock(), 3),
            )
            self._dirty = True
        tune_metrics.observations.inc(source="ledger")
        self.flush()

    def promote(self, pipe_fp: str, width: int, choice: str) -> None:
        """Record a fleet-wide promotion (the controller's promote
        decision) — the online side of the newest-wins precedence pair.

        `choice` is the closed plan vocabulary (`promoted_entry` already
        gates reads on it; raising at the write catches the typo'd arm
        at the choke point instead of silently banking a promotion no
        resolver will ever honour — fused-pallas-mxu joins the set via
        calibration.PLAN_CHOICES, nothing store-side to widen)."""
        if choice not in calibration.PLAN_CHOICES:
            raise ValueError(
                f"unknown plan choice {choice!r}; known: "
                f"{calibration.PLAN_CHOICES}"
            )
        kind = self._resolve_kind()
        if kind is None:
            return
        with self._lock:
            self._promoted[(kind, pipe_fp)] = {
                "choice": choice,
                "width": int(width),
                "at": round(self._clock(), 3),
            }
            self._dirty = True
        self.flush(force=True)

    def quarantine(self, pipe_fp: str, arm: str, reason: str) -> None:
        """Ban a candidate arm for this (kind, fingerprint) after a
        canary breach; the controller never proposes it again."""
        kind = self._resolve_kind()
        if kind is None:
            return
        with self._lock:
            self._quarantine[(kind, pipe_fp, str(arm))] = {
                "reason": str(reason)[:200],
                "at": round(self._clock(), 3),
            }
            self._dirty = True
        tune_metrics.quarantined.inc()
        self.flush(force=True)

    def audit(self, decision: str, **fields) -> None:
        """Append one decision to the store's audit trail (bounded at
        _AUDIT_CAP entries in the file; merged on flush)."""
        entry = {"t": round(self._clock(), 3), "decision": decision}
        entry.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._audit_pending.append(entry)
            if len(self._audit_pending) > _AUDIT_CAP:
                del self._audit_pending[: -_AUDIT_CAP]
            self._dirty = True

    # -- queries ---------------------------------------------------------

    def arm_stats(
        self, pipe_fp: str, window: str, device_kind: str | None = None
    ) -> dict:
        """{arm: {"mean", "n_eff", "n", "newest"}} merging this process's
        reservoirs with the persisted store (other replicas' flushes),
        staleness-decayed: weight = 0.5 ** (age / stale_s)."""
        kind = device_kind or self._resolve_kind()
        if kind is None:
            return {}
        now = self._clock()
        stale_s = self._stale_s()
        merged: dict[str, dict] = {}
        for arm, samples in self._all_samples(kind, pipe_fp, window).items():
            wsum = vsum = 0.0
            n = 0
            newest = 0.0
            for t, v in samples:
                age = max(0.0, now - t)
                if age > 8 * stale_s:
                    continue
                w = 0.5 ** (age / stale_s)
                wsum += w
                vsum += w * v
                n += 1
                newest = max(newest, t)
            if wsum > 0:
                merged[arm] = {
                    "mean": vsum / wsum,
                    "n_eff": wsum,
                    "n": n,
                    "newest": newest,
                }
        return merged

    def windows(self, pipe_fp: str, device_kind: str | None = None) -> dict:
        """{window: total_sample_count} for a fingerprint — the
        controller tunes the hottest window (workload-mix adaptive)."""
        kind = device_kind or self._resolve_kind()
        if kind is None:
            return {}
        out: dict[str, int] = {}
        seen: set[tuple] = set()
        with self._lock:
            mem = dict(self._obs)
        for (k, fp, window, arm), samples in mem.items():
            if k == kind and fp == pipe_fp:
                out[window] = out.get(window, 0) + len(samples)
                seen.add((window, arm))
        obs = self._persisted_kind(kind).get("obs", {})
        table = obs.get(pipe_fp, {}) if isinstance(obs, dict) else {}
        if isinstance(table, dict):
            for window, arms in table.items():
                if not isinstance(arms, dict):
                    continue
                for arm, rec in arms.items():
                    if (window, arm) in seen:
                        continue  # counted from memory already
                    samples = (
                        rec.get("samples") if isinstance(rec, dict) else None
                    )
                    if isinstance(samples, list):
                        out[window] = out.get(window, 0) + len(samples)
        return out

    def is_quarantined(
        self, pipe_fp: str, arm: str, device_kind: str | None = None
    ) -> bool:
        kind = device_kind or self._resolve_kind()
        if kind is None:
            return False
        with self._lock:
            if (kind, pipe_fp, arm) in self._quarantine:
                return True
        q = self._persisted_kind(kind).get("quarantine", {})
        table = q.get(pipe_fp) if isinstance(q, dict) else None
        return isinstance(table, dict) and arm in table

    def io_scale(
        self, plan_fp: str, stage: str, device_kind: str | None = None
    ) -> float | None:
        """Persisted measured/modeled boundary-byte ratio for a plan
        stage, or None. The cross-process generalization of the cost
        ledger's in-memory drift(): plan/pallas_exec and graph/compile
        fall back to this when the live ledger has no record (fresh
        process, record made by a replica)."""
        if env_registry.get("MCIM_NO_CALIB"):
            return None
        kind = device_kind or self._resolve_kind()
        if kind is None:
            return None
        with self._lock:
            ent = self._io.get((kind, plan_fp, stage))
        if ent is not None:
            return ent[0]
        table = self._persisted_kind(kind).get("io_scale", {})
        rec = table.get(plan_fp) if isinstance(table, dict) else None
        ent = rec.get(stage) if isinstance(rec, dict) else None
        if isinstance(ent, dict):
            ratio = ent.get("ratio")
            if isinstance(ratio, (int, float)) and ratio > 0:
                return float(ratio)
        return None

    def promoted_entry(
        self,
        pipe_fp: str,
        device_kind: str | None = None,
        width: int | None = None,
    ) -> dict | None:
        """The online promoted record for (fingerprint, kind), width-window
        filtered like the offline lookup."""
        kind = device_kind or self._resolve_kind()
        if kind is None:
            return None
        with self._lock:
            ent = self._promoted.get((kind, pipe_fp))
        if ent is None:
            table = self._persisted_kind(kind).get("promoted", {})
            ent = table.get(pipe_fp) if isinstance(table, dict) else None
        if not isinstance(ent, dict):
            return None
        if ent.get("choice") not in calibration.PLAN_CHOICES:
            return None
        rec_w = ent.get("width")
        if (
            width is not None
            and isinstance(rec_w, (int, float))
            and rec_w > 0
            and not (rec_w / 2 <= width <= rec_w * 2)
        ):
            return None
        return ent

    # -- persistence -----------------------------------------------------

    def flush(self, force: bool = False) -> str | None:
        """Merge this process's pending records into the calibration file
        (read, union, atomic rewrite). Rate-limited; no-op unless armed
        (MCIM_TUNE=1) or forced by a test."""
        if not force and not self.enabled():
            return None
        now = self._clock()
        with self._lock:
            if not self._dirty and not force:
                return None
            if not force and now - self._last_flush < self._flush_s():
                return None
            obs = dict(self._obs)
            io = dict(self._io)
            promoted = dict(self._promoted)
            quarantine = dict(self._quarantine)
            audit = list(self._audit_pending)
            self._audit_pending = []
            self._dirty = False
            self._last_flush = now
        try:
            data = calibration.raw_store()
            self._merge(data, obs, io, promoted, quarantine, audit, now)
            path = calibration.write_raw_store(data)
        except Exception:
            # persistence must never take down serving; records stay in
            # memory and the next flush retries
            with self._lock:
                self._audit_pending = audit + self._audit_pending
                self._dirty = True
            return None
        tune_metrics.flushes.inc()
        return path

    def _merge(self, data, obs, io, promoted, quarantine, audit, now):
        stale_s = self._stale_s()
        cap = self._reservoir()
        online = data.setdefault(_ONLINE_KEY, {})
        if not isinstance(online, dict):
            online = data[_ONLINE_KEY] = {}
        for (kind, fp, window, arm), samples in obs.items():
            rec = self._online_leaf(online, kind, "obs", fp, window, arm)
            merged = {
                (round(t, 3), v): None
                for t, v in self._file_samples(rec)
                if now - t <= 8 * stale_s
            }
            for t, v in samples:
                merged[(round(t, 3), float(v))] = None
            keep = sorted(merged, key=lambda tv: tv[0])[-cap:]
            rec["samples"] = [[t, v] for t, v in keep]
        for (kind, fp, stage), (ratio, t) in io.items():
            rec = self._online_leaf(online, kind, "io_scale", fp, stage)
            if not isinstance(rec.get("at"), (int, float)) or rec["at"] <= t:
                rec["ratio"] = round(ratio, 4)
                rec["at"] = t
        for (kind, fp), ent in promoted.items():
            table = self._online_leaf(online, kind, "promoted")
            old = table.get(fp)
            if (
                not isinstance(old, dict)
                or not isinstance(old.get("at"), (int, float))
                or old["at"] <= ent["at"]
            ):
                table[fp] = dict(ent)
        for (kind, fp, arm), ent in quarantine.items():
            table = self._online_leaf(online, kind, "quarantine", fp)
            table.setdefault(arm, dict(ent))
        if audit:
            trail = data.setdefault(_AUDIT_KEY, [])
            if not isinstance(trail, list):
                trail = data[_AUDIT_KEY] = []
            trail.extend(audit)
            trail.sort(key=lambda e: e.get("t", 0))
            del trail[:-_AUDIT_CAP]

    @staticmethod
    def _online_leaf(online: dict, kind: str, *path: str) -> dict:
        node = online.setdefault(kind, {})
        if not isinstance(node, dict):
            node = online[kind] = {}
        for p in path:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                nxt = node[p] = {}
            node = nxt
        return node

    @staticmethod
    def _file_samples(rec) -> list:
        samples = rec.get("samples") if isinstance(rec, dict) else None
        out = []
        if isinstance(samples, list):
            for s in samples:
                if (
                    isinstance(s, (list, tuple))
                    and len(s) == 2
                    and isinstance(s[0], (int, float))
                    and isinstance(s[1], (int, float))
                ):
                    out.append((float(s[0]), float(s[1])))
        return out

    def _persisted_kind(self, kind: str) -> dict:
        online = calibration._load().get(_ONLINE_KEY)
        if not isinstance(online, dict):
            return {}
        rec = online.get(kind)
        return rec if isinstance(rec, dict) else {}

    def _all_samples(self, kind: str, pipe_fp: str, window: str) -> dict:
        """{arm: [(t, v), ...]} unioned across memory and file."""
        out: dict[str, list] = {}
        obs = self._persisted_kind(kind).get("obs", {})
        table = obs.get(pipe_fp, {}) if isinstance(obs, dict) else {}
        arms = table.get(window, {}) if isinstance(table, dict) else {}
        if isinstance(arms, dict):
            for arm, rec in arms.items():
                out[arm] = self._file_samples(rec)
        with self._lock:
            for (k, fp, win, arm), samples in self._obs.items():
                if k == kind and fp == pipe_fp and win == window:
                    seen = {(round(t, 3), v) for t, v in out.get(arm, [])}
                    merged = list(out.get(arm, []))
                    for t, v in samples:
                        if (round(t, 3), v) not in seen:
                            merged.append((t, v))
                    out[arm] = merged
        return out

    def audit_trail(self) -> list:
        """The persisted audit trail plus unflushed pending entries."""
        trail = calibration._load().get(_AUDIT_KEY)
        out = list(trail) if isinstance(trail, list) else []
        with self._lock:
            out.extend(self._audit_pending)
        return out

    def reset(self) -> None:
        """Drop all process-local state (tests)."""
        with self._lock:
            self._obs.clear()
            self._io.clear()
            self._last_t.clear()
            self._promoted.clear()
            self._quarantine.clear()
            self._audit_pending = []
            self._dirty = False
            self._last_flush = 0.0
            self._kind = None


online_store = OnlineStore()


def effective_plan_choice(
    pipe_fp: str | None,
    device_kind: str | None = None,
    width: int | None = None,
) -> str | None:
    """Newest-wins plan choice across the offline record and the online
    promotion for one key.

    Both sides are width-window filtered first; a missing `recorded_at`
    (legacy offline entry) sorts as oldest. When both exist and
    DISAGREE, the loser is by definition stale —
    `mcim_tune_stale_overrides_total` counts the override so a fleet
    whose offline sweeps have been lapped by live measurement is visible
    in the exposition."""
    if pipe_fp is None or env_registry.get("MCIM_NO_CALIB"):
        return None
    if device_kind is None:
        try:
            device_kind = calibration.current_device_kind()
        except Exception:
            return None
    offline = calibration.plan_entry(
        pipe_fp, device_kind=device_kind, width=width
    )
    online = online_store.promoted_entry(
        pipe_fp, device_kind=device_kind, width=width
    )
    if offline is None and online is None:
        return None
    if online is None:
        return offline.get("choice")
    if offline is None:
        return online.get("choice")
    off_t = offline.get("recorded_at")
    off_t = float(off_t) if isinstance(off_t, (int, float)) else 0.0
    on_t = online.get("at")
    on_t = float(on_t) if isinstance(on_t, (int, float)) else 0.0
    newer, older = (
        (online, offline) if on_t >= off_t else (offline, online)
    )
    if newer.get("choice") != older.get("choice"):
        tune_metrics.stale_overrides.inc()
    return newer.get("choice")


def persisted_io_scale(plan_fp: str | None, stage: str) -> float | None:
    """Module-level convenience over online_store.io_scale — the drop-in
    fallback for cost_ledger.drift() callers. Returns the decay-free
    persisted ratio clamped to the ledger's [0.25, 4.0] sanity band, or
    None."""
    if plan_fp is None:
        return None
    try:
        ratio = online_store.io_scale(str(plan_fp), stage)
    except Exception:
        return None
    if ratio is None or not math.isfinite(ratio):
        return None
    return min(4.0, max(0.25, float(ratio)))
