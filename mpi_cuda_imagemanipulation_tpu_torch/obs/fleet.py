"""Metrics federation — one fleet view over every replica's registry.
The counterpart of the JAX package's ``obs/fleet.py``.

The router cannot answer "what is the pod's p99 right now" from its own
registry: latency lives in each replica's `mcim_serve_*` histograms. This
module moves those registries to the router WITHOUT a scrape round-trip:

  * **Replica side** — `DeltaSource` snapshots the replica's registries
    (`snapshot_registries`) and emits compact DELTAS on each heartbeat:
    only the series whose values changed since the last *acknowledged*
    snapshot ride the wire (values are ABSOLUTE, so a lost beat only
    delays freshness — it can never corrupt the merge). The router's
    heartbeat ack carries a `resync` flag when its baseline does not
    match (router restart, missed epoch): the replica then pushes one
    FULL snapshot on the next beat. `GET /fleet/snapshot` on the replica
    serves the same full snapshot for the router's active full-scrape
    fallback (heartbeat-gap recovery) and for CI equality checks.

  * **Router side** — `FleetAggregator` folds per-replica snapshots into
    one view, with the merge semantics the fleet exposition needs:

      counters     summed across replicas. Restart-safe: when a replica's
                   INCARNATION changes, the dying incarnation's last
                   values fold into a per-replica base so the new
                   process's counters (restarting from 0) add on top —
                   the fleet total never double-counts and never jumps
                   backward across a restart.
      histograms   bucket-merged (cumulative bucket counts, sum, count
                   all sum — identical bounds are required and checked).
                   The merged percentiles therefore equal the
                   percentiles of the POOLED observations at bucket
                   resolution (the property tests/test_fleet.py proves).
                   Exemplars: most recent timestamp wins per bucket, so
                   the federated p99 still links to a real trace id.
      gauges       never summed — each series gains a `replica` label
                   (a queue depth averaged across replicas is a lie).

    Stale replicas age OUT of the view: a replica whose snapshot has not
    been refreshed within `stale_s` stops contributing (same liveness
    definition as routing; its folded counter base leaves with it, which
    is exactly how a Prometheus federation behaves when a target
    disappears).

`quantile_from_buckets` is the Prometheus `histogram_quantile` rule
(linear interpolation inside the owning bucket) used by the SLO engine
and the fleet p99 readouts; `merged_exemplar_for_quantile` joins a
quantile to the nearest retained exemplar trace id.
"""

from __future__ import annotations

import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import (
    Registry,
    _escape_help,
    _fmt_exemplar,
    _fmt_value,
    _label_str,
)

SNAPSHOT_PATH = "/fleet/snapshot"


# --------------------------------------------------------------------------
# snapshots (replica side)
# --------------------------------------------------------------------------


def _capture(registries: list[Registry]) -> dict[str, dict]:
    """`{name: {kind, help, labels, [bounds,] series: {key: data}}}` over
    every metric in `registries` (later registries win name clashes —
    they shouldn't clash; the Registry dedups within one)."""
    out: dict[str, dict] = {}
    for reg in registries:
        for m in reg.metrics():
            entry: dict = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
            }
            if m.kind == "histogram":
                entry["bounds"] = list(m.buckets)
                entry["series"] = dict(m.data())
            else:
                entry["series"] = dict(m.values())
            out[m.name] = entry
    return out


def snapshot_registries(registries, *, seq: int = 0) -> dict:
    """A full, JSON-safe snapshot payload (series keys become lists)."""
    return {
        "seq": seq,
        "baseline_seq": 0,
        "full": True,
        "metrics": _to_wire(_capture(list(registries))),
    }


def _to_wire(metrics: dict[str, dict]) -> dict:
    wire = {}
    for name, entry in metrics.items():
        wire[name] = {
            **{k: v for k, v in entry.items() if k != "series"},
            "series": [
                [list(key), data] for key, data in entry["series"].items()
            ],
        }
    return wire


def _from_wire(metrics: dict) -> dict[str, dict]:
    out = {}
    for name, entry in metrics.items():
        out[name] = {
            **{k: v for k, v in entry.items() if k != "series"},
            "series": {
                tuple(key): data for key, data in entry["series"]
            },
        }
    return out


class DeltaSource:
    """The replica-side producer: `delta()` per heartbeat, `ack(seq)` on
    router acknowledgement, `force_full()` when the router asks for a
    resync. Values are absolute; a delta only narrows WHICH series ride
    the wire."""

    def __init__(self, registries):
        self._registries = list(registries)
        self._lock = threading.Lock()
        self._seq = 0
        self._acked: dict | None = None  # last router-applied capture
        self._acked_seq = 0
        self._pending: dict[int, dict] = {}  # seq -> capture

    def delta(self) -> dict:
        """The next heartbeat's metrics payload. Full until the first
        ack; afterwards only changed/new series (vs the acked capture)."""
        cur = _capture(self._registries)
        with self._lock:
            self._seq += 1
            seq = self._seq
            base = self._acked
            base_seq = self._acked_seq
            self._pending[seq] = cur
            # bound the pending window: unacked beats older than the
            # last few are useless (the router will resync anyway)
            for old in [s for s in self._pending if s < seq - 8]:
                del self._pending[old]
        if base is None:
            return {
                "seq": seq, "baseline_seq": 0, "full": True,
                "metrics": _to_wire(cur),
            }
        changed: dict[str, dict] = {}
        for name, entry in cur.items():
            old = base.get(name)
            if old is None:
                changed[name] = entry
                continue
            diff = {
                key: data
                for key, data in entry["series"].items()
                if old["series"].get(key) != data
            }
            if diff:
                changed[name] = {**entry, "series": diff}
        return {
            "seq": seq, "baseline_seq": base_seq, "full": False,
            "metrics": _to_wire(changed),
        }

    def ack(self, seq: int) -> None:
        with self._lock:
            cap = self._pending.pop(seq, None)
            if cap is not None and seq > self._acked_seq:
                self._acked = cap
                self._acked_seq = seq

    def force_full(self) -> None:
        with self._lock:
            self._acked = None
            self._acked_seq = 0
            self._pending.clear()


# --------------------------------------------------------------------------
# aggregation (router side)
# --------------------------------------------------------------------------


class _ReplicaMetrics:
    def __init__(self, incarnation: str):
        self.incarnation = incarnation
        self.seq = 0
        self.metrics: dict[str, dict] = {}
        self.last_update = 0.0


def _add_series(dst_entry: dict, key, data, kind: str) -> None:
    """Fold one series into an accumulating entry (counters add floats,
    histograms add buckets/sum/count and keep the freshest exemplars)."""
    series = dst_entry["series"]
    if kind != "histogram":
        series[key] = series.get(key, 0.0) + data
        return
    cur = series.get(key)
    if cur is None:
        series[key] = {
            "buckets": list(data["buckets"]),
            "sum": data["sum"],
            "count": data["count"],
            "exemplars": list(data.get("exemplars", ())),
        }
        return
    cur["buckets"] = [
        a + b for a, b in zip(cur["buckets"], data["buckets"])
    ]
    cur["sum"] += data["sum"]
    cur["count"] += data["count"]
    by_idx = {e[0]: e for e in cur["exemplars"]}
    for e in data.get("exemplars", ()):
        have = by_idx.get(e[0])
        if have is None or (e[3] or 0) >= (have[3] or 0):
            by_idx[e[0]] = e
    cur["exemplars"] = [by_idx[i] for i in sorted(by_idx)]


class FleetAggregator:
    """The router's fleet view. `apply()` folds heartbeat deltas in;
    `merged()`/`render()` produce the federated families; `stats()` the
    /stats section. One lock, short critical sections, no I/O under it."""

    def __init__(self, *, stale_s: float, clock=time.monotonic):
        self.stale_s = stale_s
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, _ReplicaMetrics] = {}
        # rid -> {name: {kind, bounds?, series: {key: folded data}}} from
        # DEAD incarnations (counters/histograms only — restart survival)
        self._base: dict[str, dict[str, dict]] = {}
        self.applied_deltas = 0
        self.full_syncs = 0
        self.resyncs = 0
        self.merge_errors = 0

    # -- ingest -------------------------------------------------------------

    def _fold_into_base(self, rid: str, metrics: dict[str, dict]) -> None:
        """A replica incarnation died: bank its cumulative families so the
        successor's counters (restarting at 0) stack on top."""
        base = self._base.setdefault(rid, {})
        for name, entry in metrics.items():
            if entry["kind"] == "gauge":
                continue
            dst = base.get(name)
            if dst is None:
                dst = base[name] = {
                    **{k: v for k, v in entry.items() if k != "series"},
                    "series": {},
                }
            for key, data in entry["series"].items():
                _add_series(dst, key, data, entry["kind"])

    def apply(
        self, rid: str, incarnation: str, payload: dict | None,
        now: float | None = None,
    ) -> bool:
        """Fold one heartbeat's metrics payload in. Returns False when
        the replica must RESYNC (send a full snapshot next beat): unknown
        baseline, incarnation change mid-delta, or no payload history."""
        if payload is None:
            return True  # metrics-less heartbeat: nothing to do
        now = self._clock() if now is None else now
        metrics = _from_wire(payload.get("metrics", {}))
        with self._lock:
            st = self._replicas.get(rid)
            if st is None or st.incarnation != incarnation:
                if st is not None:
                    self._fold_into_base(rid, st.metrics)
                st = self._replicas[rid] = _ReplicaMetrics(incarnation)
                if not payload.get("full"):
                    self.resyncs += 1
                    return False
            if payload.get("full"):
                st.metrics = metrics
                st.seq = payload["seq"]
                st.last_update = now
                self.full_syncs += 1
                return True
            if payload.get("baseline_seq") != st.seq:
                self.resyncs += 1
                return False
            for name, entry in metrics.items():
                have = st.metrics.get(name)
                if have is None:
                    st.metrics[name] = entry
                else:
                    have["series"].update(entry["series"])
            st.seq = payload["seq"]
            st.last_update = now
            self.applied_deltas += 1
            return True

    def full_sync(
        self, rid: str, incarnation: str, snapshot: dict,
        now: float | None = None,
    ) -> None:
        """Replace a replica's state from an out-of-band full snapshot
        (the router's active `GET /fleet/snapshot` fallback). The stored
        seq stays 0 so the next heartbeat delta resyncs cleanly."""
        now = self._clock() if now is None else now
        with self._lock:
            st = self._replicas.get(rid)
            if st is not None and st.incarnation != incarnation:
                self._fold_into_base(rid, st.metrics)
                st = None
            if st is None:
                st = self._replicas[rid] = _ReplicaMetrics(incarnation)
            st.metrics = _from_wire(snapshot.get("metrics", {}))
            st.seq = 0
            st.last_update = now
            self.full_syncs += 1

    def forget(self, rid: str) -> None:
        with self._lock:
            self._replicas.pop(rid, None)
            self._base.pop(rid, None)

    # -- views --------------------------------------------------------------

    def ages(self, now: float | None = None) -> dict[str, float]:
        now = self._clock() if now is None else now
        with self._lock:
            return {
                rid: now - st.last_update
                for rid, st in self._replicas.items()
            }

    def fresh_ids(self, now: float | None = None) -> list[str]:
        ages = self.ages(now)
        return sorted(r for r, age in ages.items() if age <= self.stale_s)

    def merged(self, now: float | None = None) -> dict[str, dict]:
        """The federated families over FRESH replicas:
        `{name: {kind, help, labels, [bounds,] series: {key: value|hist
        data}}}` — counters/histograms summed (incl. each fresh replica's
        banked base), gauges re-labeled with `replica`."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh = {
                rid: st
                for rid, st in self._replicas.items()
                if now - st.last_update <= self.stale_s
            }
            contributions = [
                (rid, src)
                for rid, st in fresh.items()
                for src in (st.metrics, self._base.get(rid, {}))
            ]
            out: dict[str, dict] = {}
            for rid, src in contributions:
                for name, entry in src.items():
                    kind = entry["kind"]
                    dst = out.get(name)
                    if dst is None:
                        labels = list(entry["labels"])
                        if kind == "gauge":
                            labels = labels + ["replica"]
                        dst = out[name] = {
                            **{
                                k: v
                                for k, v in entry.items()
                                if k != "series"
                            },
                            "labels": labels,
                            "series": {},
                        }
                    elif (
                        kind == "histogram"
                        and dst.get("bounds") != entry.get("bounds")
                    ):
                        self.merge_errors += 1
                        continue
                    for key, data in entry["series"].items():
                        if kind == "gauge":
                            dst["series"][key + (rid,)] = data
                        else:
                            _add_series(dst, key, data, kind)
            return out

    def render(self, now: float | None = None) -> str:
        """The federated exposition block appended to the router's own
        `GET /metrics` body."""
        lines: list[str] = []
        for name in sorted(merged := self.merged(now)):
            entry = merged[name]
            kind = entry["kind"]
            label_names = tuple(entry["labels"])
            lines.append(f"# HELP {name} {_escape_help(entry['help'])}")
            lines.append(f"# TYPE {name} {kind}")
            if kind != "histogram":
                for key in sorted(entry["series"]):
                    lines.append(
                        f"{name}{_label_str(label_names, key)} "
                        f"{_fmt_value(entry['series'][key])}"
                    )
                continue
            bounds = entry["bounds"]
            for key in sorted(entry["series"]):
                data = entry["series"][key]
                exemplars = {e[0]: tuple(e[1:]) for e in data["exemplars"]}
                for i, ub in enumerate(bounds):
                    ls = _label_str(
                        label_names, key, (("le", _fmt_value(ub)),)
                    )
                    lines.append(
                        f"{name}_bucket{ls} {data['buckets'][i]}"
                        + _fmt_exemplar(exemplars.get(i))
                    )
                inf_ls = _label_str(label_names, key, (("le", "+Inf"),))
                lines.append(
                    f"{name}_bucket{inf_ls} {data['count']}"
                    + _fmt_exemplar(exemplars.get(len(bounds)))
                )
                plain = _label_str(label_names, key)
                lines.append(f"{name}_sum{plain} {repr(float(data['sum']))}")
                lines.append(f"{name}_count{plain} {data['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def stats(self, now: float | None = None) -> dict:
        ages = self.ages(now)
        return {
            "replicas": sorted(ages),
            "fresh": self.fresh_ids(now),
            "ages_s": ages,
            "applied_deltas": self.applied_deltas,
            "full_syncs": self.full_syncs,
            "resyncs": self.resyncs,
            "merge_errors": self.merge_errors,
        }


# --------------------------------------------------------------------------
# quantiles + exemplars over merged histograms
# --------------------------------------------------------------------------


def quantile_from_buckets(
    bounds, cum_counts, total: float, q: float
) -> float | None:
    """Prometheus `histogram_quantile`: the q-th percentile estimated
    from CUMULATIVE bucket counts by linear interpolation inside the
    owning bucket. Observations past the last bound clamp to it."""
    if total <= 0:
        return None
    rank = (q / 100.0) * total
    prev_cum = 0.0
    prev_bound = 0.0
    for bound, cum in zip(bounds, cum_counts):
        if cum >= rank:
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_cum, prev_bound = cum, bound
    return float(bounds[-1]) if bounds else None


def merged_exemplar_for_quantile(
    entry: dict, q: float, key: tuple = ()
) -> tuple[str, float, float] | None:
    """The (trace_id, value, ts) exemplar nearest the q-th percentile of
    one merged histogram series — the federated p99's link back to a
    concrete trace."""
    data = entry["series"].get(key)
    if not data:
        return None
    bounds = entry["bounds"]
    v = quantile_from_buckets(bounds, data["buckets"], data["count"], q)
    if v is None:
        return None
    idx = len(bounds)
    for i, ub in enumerate(bounds):
        if v <= ub:
            idx = i
            break
    by_idx = {e[0]: tuple(e[1:]) for e in data.get("exemplars", ())}
    # nearest populated bucket by index distance (ties go up)
    for d in range(len(bounds) + 1):
        for i in (idx + d, idx - d):
            if i in by_idx:
                return by_idx[i]
    return None
