r"""Metrics registry: counters, gauges and histograms under one naming
scheme, with Prometheus text exposition. The counterpart of the JAX
package's ``obs/metrics.py``, with the same classes, names and output.

One registry per process, or per caller (the registry is an instance, so
tests compose freely): every subsystem registers its metrics into it, and
`render()` emits Prometheus text exposition format 0.0.4.

Naming scheme:

    mcim_<subsystem>_<what>[_total|_seconds]{label="value"}

  * prefix `mcim_`;
  * counters end `_total` and only go up; durations are SECONDS with a
    `_seconds` suffix (never ms: the exposition consumer rescales);
  * statuses, stages and buckets are LABELS, not name suffixes, so one
    family aggregates across them.

Histograms keep both the Prometheus cumulative buckets and a bounded
reservoir of recent samples: the buckets feed scraping, the reservoir the
exact p50/p95/p99 (`utils.timing.percentiles`). The reservoir is a
`deque(maxlen=sample_cap)`, and label cardinality is bounded by the
callers.

Histograms also carry **exemplars**: `observe(v, exemplar=trace_id)`
remembers the most recent (trace_id, value, ts) per bucket, rendered
OpenMetrics-style after the bucket line (`... # {trace_id="..."} value
ts`), so a p99 bucket links to a trace in the `--trace-out` export;
`exemplar_for_quantile(99)` is the programmatic form.

`parse_exposition()` is the matching parser. It tokenizes label blocks
with full escape handling (`\\`, `\"`, `\n` in label values), so
render -> parse round-trips adversarial values, and captures exemplars
per sample. Only `\n` ends a line: the parser splits on it alone, where
the JAX package's splits with `str.splitlines()`, which also breaks on
`\x0b`, `\x0c`, `\x1c`-`\x1e`, `\x85`, `\u2028` and `\u2029` that
`render` leaves unescaped inside label values (a label value `'\x1e'`
made that parser raise "unterminated value").
"""

from __future__ import annotations

import threading
import time
from collections import deque

from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import percentiles

# latency-in-seconds buckets: 1 ms .. 10 s, roughly log-spaced — covers
# both CPU-smoke and real-chip serving latencies
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

PERCENTILES = (50, 95, 99)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP text escapes only backslash and newline (the exposition spec);
    # quotes are legal there
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape(v: str) -> str:
    """Inverse of `_escape_label`/`_escape_help` (one pass, so '\\\\n'
    round-trips as backslash + n, not newline)."""
    out: list[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [
        f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)
    ] + [f'{n}="{_escape_label(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Shared labeled-value storage: {label-values-tuple: float}."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def values(self) -> dict[tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)

    def clear(self) -> None:
        """Drop every value: the tally starts again from nothing (the
        planner's per-run reset, plan/metrics.py)."""
        with self._lock:
            self._values.clear()

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            lines.append(
                f"{self.name}{_label_str(self.label_names, key)} "
                f"{_fmt_value(v)}"
            )
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labels=(), fn=None):
        super().__init__(name, help, labels)
        # callback gauge: `fn()` -> value (unlabeled) or {labels: value};
        # evaluated at render/value time so the scrape always sees the
        # live state (breaker boards, health machine, cache stats)
        self._fn = fn

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def set_max(self, v: float, **labels) -> None:
        """Monotone high-water update (peak gauges), atomic under the
        metric lock."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, 0.0), float(v))

    def _eval_fn(self) -> None:
        if self._fn is None:
            return
        got = self._fn()
        with self._lock:
            if isinstance(got, dict):
                self._values = {
                    (k,) if isinstance(k, str) else tuple(map(str, k)): float(v)
                    for k, v in got.items()
                }
            else:
                self._values = {(): float(got)}

    def value(self, **labels) -> float:
        self._eval_fn()
        return super().value(**labels)

    def values(self) -> dict[tuple[str, ...], float]:
        self._eval_fn()
        return super().values()

    def render(self) -> list[str]:
        self._eval_fn()
        return super().render()


def _fmt_exemplar(ex: tuple[str, float, float] | None) -> str:
    """OpenMetrics exemplar suffix for a bucket line, or ''. Our
    `parse_exposition` reads these back; 0.0.4-only scrapers treat the
    trailing ` # ...` as the OpenMetrics spec defines (an exemplar), and
    plain-text consumers ignore everything after the value."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (
        f' # {{trace_id="{_escape_label(trace_id)}"}} '
        f"{_fmt_value(value)} {repr(float(ts))}"
    )


class Histogram:
    """Prometheus histogram + bounded percentile reservoir.

    One instance carries every label combination (like Counter/Gauge);
    each combination owns cumulative bucket counts, sum, count, and a
    recent-sample deque for exact percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 sample_cap: int = 65536):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.buckets = tuple(sorted(buckets))
        self.sample_cap = sample_cap
        self._lock = threading.Lock()
        # key -> [bucket_counts list, sum, count, reservoir deque]
        self._series: dict[tuple[str, ...], list] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    def _cell(self, key):
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = [
                [0] * len(self.buckets), 0.0, 0,
                deque(maxlen=self.sample_cap),
                # per-bucket exemplar slots (last = +Inf): the most recent
                # (trace_id, value, unix_ts) observed into that bucket
                [None] * (len(self.buckets) + 1),
            ]
        return s

    def _bucket_index(self, v: float) -> int:
        """Index of the FIRST bucket containing v (len(buckets) = +Inf)."""
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                return i
        return len(self.buckets)

    def observe(self, v: float, *, exemplar: str | None = None,
                **labels) -> None:
        """Record one observation. `exemplar` attaches a trace id to the
        observation's bucket — the exposition then links that bucket (and
        any percentile that lands in it) to a concrete trace."""
        key = self._key(labels)
        with self._lock:
            s = self._cell(key)
            counts, _sum, _n, reservoir, exemplars = s
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += 1
            s[1] = _sum + v
            s[2] = _n + 1
            reservoir.append(v)
            if exemplar:
                exemplars[self._bucket_index(v)] = (
                    str(exemplar), float(v), time.time()
                )

    def data(self) -> dict[tuple[str, ...], dict]:
        """Raw per-series state for federation snapshots (obs/fleet.py):
        cumulative bucket counts, sum, count and the exemplar slots."""
        with self._lock:
            return {
                k: {
                    "buckets": list(s[0]),
                    "sum": s[1],
                    "count": s[2],
                    "exemplars": [
                        [i, *ex]
                        for i, ex in enumerate(s[4])
                        if ex is not None
                    ],
                }
                for k, s in self._series.items()
            }

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s[2] if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s[1] if s else 0.0

    def samples(self, **labels) -> list[float]:
        with self._lock:
            s = self._series.get(self._key(labels))
            return list(s[3]) if s else []

    def exemplars(self, **labels) -> dict[str, tuple[str, float, float]]:
        """`{le_string: (trace_id, value, unix_ts)}` for the buckets that
        hold one ("+Inf" for the overflow bucket)."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if not s:
                return {}
            exs = list(s[4])
        out = {}
        for i, ex in enumerate(exs):
            if ex is not None:
                le = (
                    _fmt_value(self.buckets[i])
                    if i < len(self.buckets)
                    else "+Inf"
                )
                out[le] = ex
        return out

    def exemplar_for_quantile(
        self, q: float, **labels
    ) -> tuple[str, float, float] | None:
        """The exemplar nearest the q-th percentile: compute the
        percentile over the recent reservoir, then return the exemplar of
        the bucket it falls in (or the nearest populated bucket at or
        above it). The join from "p99 spiked" to "this trace shows why"."""
        xs = self.samples(**labels)
        if not xs:
            return None
        v = percentiles(xs, (q,))[q]
        with self._lock:
            s = self._series.get(self._key(labels))
            exs = list(s[4]) if s else []
        if not exs:
            return None
        start = self._bucket_index(v)
        # nearest populated bucket by index distance (ties go up — a
        # tail quantile should prefer the slower neighbour)
        for d in range(len(exs)):
            for i in (start + d, start - d):
                if 0 <= i < len(exs) and exs[i] is not None:
                    return exs[i]
        return None

    def percentiles_ms(self, qs=PERCENTILES, **labels) -> dict | None:
        """`{"p50_ms": ...}` over the recent reservoir — the exact
        percentile view /stats and the shutdown summaries report
        (same definition as the bench suite: utils.timing.percentiles)."""
        xs = self.samples(**labels)
        if not xs:
            return None
        got = percentiles(xs, qs)
        return {f"p{int(q)}_ms": got[q] * 1e3 for q in qs}

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            series = {
                k: (list(s[0]), s[1], s[2], list(s[4]))
                for k, s in self._series.items()
            }
        for key in sorted(series):
            counts, total, n, exemplars = series[key]
            for i, ub in enumerate(self.buckets):
                ls = _label_str(
                    self.label_names, key, (("le", _fmt_value(ub)),)
                )
                lines.append(
                    f"{self.name}_bucket{ls} {counts[i]}"
                    + _fmt_exemplar(exemplars[i])
                )
            inf_ls = _label_str(self.label_names, key, (("le", "+Inf"),))
            lines.append(
                f"{self.name}_bucket{inf_ls} {n}"
                + _fmt_exemplar(exemplars[len(self.buckets)])
            )
            plain = _label_str(self.label_names, key)
            lines.append(f"{self.name}_sum{plain} {repr(float(total))}")
            lines.append(f"{self.name}_count{plain} {n}")
        return lines


class Registry:
    """One process's (or one ServeApp's) metric namespace. Registering an
    existing name returns the existing metric — subsystems that share a
    registry share the family (that is the point)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _register(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type/labels"
                    )
                return m
            m = self._metrics[name] = cls(name, help, labels, **kw)
            return m

    def counter(self, name: str, help: str,
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str, labels: tuple[str, ...] = (),
              fn=None) -> Gauge:
        return self._register(Gauge, name, help, labels, fn=fn)

    def histogram(self, name: str, help: str,
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  sample_cap: int = 65536) -> Histogram:
        return self._register(
            Histogram, name, help, labels, buckets=buckets,
            sample_cap=sample_cap,
        )

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list:
        """Every registered metric object, name-sorted (federation
        snapshots walk these; obs/fleet.py)."""
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (the `GET /metrics`
        body / `--metrics-out` snapshot)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _parse_label_block(
    line: str, i: int, lineno: int
) -> tuple[dict[str, str], str, int]:
    """Tokenize `line[i:]` starting at '{': returns (labels dict with
    unescaped values, the raw inner text, index just past '}'). Escape-
    aware, so label values containing `\\`, `\"`, `}`, `,` or rendered
    newlines parse correctly — rpartition-style splitting does not."""
    assert line[i] == "{"
    j = i + 1
    labels: dict[str, str] = {}
    while True:
        if j >= len(line):
            raise ValueError(f"line {lineno}: unterminated label block")
        if line[j] == "}":
            return labels, line[i + 1 : j], j + 1
        k = j
        while j < len(line) and line[j] not in '="}':
            j += 1
        if j >= len(line) or line[j] != "=":
            raise ValueError(f"line {lineno}: expected label=\"value\"")
        name = line[k:j].strip(", \t")
        j += 1
        if j >= len(line) or line[j] != '"':
            raise ValueError(
                f"line {lineno}: label {name!r} value must be quoted"
            )
        j += 1
        buf: list[str] = []
        while True:
            if j >= len(line):
                raise ValueError(
                    f"line {lineno}: unterminated value for label {name!r}"
                )
            c = line[j]
            if c == "\\" and j + 1 < len(line):
                buf.append(
                    {"n": "\n", "\\": "\\", '"': '"'}.get(
                        line[j + 1], c + line[j + 1]
                    )
                )
                j += 2
                continue
            if c == '"':
                j += 1
                break
            buf.append(c)
            j += 1
        labels[name] = "".join(buf)
        if j < len(line) and line[j] == ",":
            j += 1


def parse_labels(labelstr: str) -> dict[str, str]:
    """Parse the inner text of a label block (the `labelstr` keys
    `parse_exposition` returns) into `{name: unescaped value}`."""
    if not labelstr:
        return {}
    labels, _raw, _end = _parse_label_block("{" + labelstr + "}", 0, 0)
    return labels


def _parse_sample_line(line: str, lineno: int):
    """One sample line -> (name, raw labelstr, value, exemplar | None).
    Exemplars are the OpenMetrics ` # {labels} value [ts]` suffix."""
    i = 0
    while i < len(line) and line[i] not in "{ \t":
        i += 1
    name = line[:i]
    raw = ""
    if i < len(line) and line[i] == "{":
        _labels, raw, i = _parse_label_block(line, i, lineno)
    rest = line[i:].strip()
    exemplar = None
    if " # " in rest:
        val_part, _, ex_part = rest.partition(" # ")
        ex_part = ex_part.strip()
        if not ex_part.startswith("{"):
            raise ValueError(f"line {lineno}: malformed exemplar")
        ex_labels, _exraw, k = _parse_label_block(ex_part, 0, lineno)
        ex_fields = ex_part[k:].split()
        if not ex_fields:
            raise ValueError(f"line {lineno}: exemplar missing value")
        exemplar = {
            "labels": ex_labels,
            "value": float(ex_fields[0]),
            "ts": float(ex_fields[1]) if len(ex_fields) > 1 else None,
        }
    else:
        val_part = rest
    fields = val_part.split()
    if not fields:
        raise ValueError(f"line {lineno}: expected 'name value'")
    try:
        value = float(fields[0])
    except ValueError:
        raise ValueError(
            f"line {lineno}: unparsable value {fields[0]!r}"
        ) from None
    return name, raw, value, exemplar


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse Prometheus text exposition into
    `{family: {"type": str, "help": str, "samples": {(name, labelstr):
    value}, "exemplars": {(name, labelstr): {...}}}}`.
    Raises ValueError on malformed lines — the CI smoke lane's
    "/metrics parses" assertion. Label values round-trip escapes
    (`parse_labels` on a labelstr recovers the original values), and
    histogram bucket exemplars are captured per sample."""
    families: dict[str, dict] = {}

    def fam(name: str) -> dict:
        return families.setdefault(
            name,
            {"type": "untyped", "help": "", "samples": {}, "exemplars": {}},
        )

    # "\n" alone ends an exposition line (module docstring)
    for lineno, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            fam(name)["help"] = _unescape(help_text)
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE {kind!r}")
            fam(name)["type"] = kind
            continue
        if line.startswith("#"):
            continue
        name, labelstr, value, exemplar = _parse_sample_line(line, lineno)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
                break
        fam(base)["samples"][(name, labelstr)] = value
        if exemplar is not None:
            fam(base)["exemplars"][(name, labelstr)] = exemplar
    return families
