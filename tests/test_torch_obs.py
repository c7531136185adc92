"""The port's observability core (obs/metrics.py, obs/recorder.py,
obs/trace.py) against the JAX package's.

Metrics: the same call sequence (labels, callback gauges, histograms with
exemplars) renders the same exposition text in both packages, and both
parsers read it alike. The port's parser also round-trips label values
holding the separators `str.splitlines()` breaks on (`\\x0b`, `\\x0c`,
`\\x1c`-`\\x1e`, `\\x85`, `\\u2028`, `\\u2029`, `\\r`), where the JAX
package's raises (its test_fleet.py::test_exposition_roundtrip_property
fails on `'\\x1e'`). Recorder: the same ring, summary, triggers and dump
payload. Trace: the same spans, parent links, args, sampling and tail
decisions and counts, with timestamps and ids dropped.
"""

import json
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu.obs import metrics as jax_metrics
from mpi_cuda_imagemanipulation_tpu.obs import recorder as jax_recorder
from mpi_cuda_imagemanipulation_tpu.obs import trace as jax_trace
from mpi_cuda_imagemanipulation_tpu_torch import obs
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics, recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def _fill(mod):
    """One call sequence on a fresh registry of `mod`; returns it."""
    r = mod.Registry()
    c = r.counter("mcim_serve_requests_total", 'req "q"\nhelp', labels=("status", "bucket"))
    c.inc(status="ok", bucket="48x48x3")
    c.inc(3, status="failed", bucket='a"} b')
    c.inc(0.5, status="ok", bucket="96x96x1")
    r.counter("mcim_serve_unlabeled_total", "plain").inc(2)
    g = r.gauge("mcim_serve_queue_depth", "queue", labels=("lane",))
    g.set(4, lane="x")
    g.inc(2.5, lane="y")
    g.dec(1, lane="x")
    g.set_max(7, lane="x")
    g.set_max(3, lane="x")
    r.gauge("mcim_serve_breakers_open", "fn gauge", labels=("key",),
            fn=lambda: {"k1": 1, ("k2",): 0.25})
    r.gauge("mcim_health_up", "fn scalar", fn=lambda: 1)
    h = r.histogram("mcim_serve_latency_seconds", "lat", labels=("bucket",),
                    buckets=(0.01, 0.1, 1.0))
    for i, v in enumerate((0.005, 0.02, 0.02, 0.5, 3.0, 0.07)):
        h.observe(v, exemplar=f"trace-{i}" if i % 2 == 0 else None, bucket="b1")
    h.observe(0.2, bucket="b2")
    r.histogram("mcim_serve_empty_seconds", "never observed")
    return r


def test_render_and_parse_equal_the_jax_package_s(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    port = _fill(metrics)
    ref = _fill(jax_metrics)
    text = port.render()
    assert text == ref.render()
    assert metrics.parse_exposition(text) == jax_metrics.parse_exposition(text)
    assert port.names() == ref.names()
    ph, jh = port.get("mcim_serve_latency_seconds"), ref.get("mcim_serve_latency_seconds")
    assert ph.data() == jh.data()
    for q in (10, 50, 99):
        assert ph.exemplar_for_quantile(q, bucket="b1") == jh.exemplar_for_quantile(q, bucket="b1")
    assert ph.percentiles_ms(bucket="b1") == jh.percentiles_ms(bucket="b1")
    assert ph.exemplars(bucket="b1") == jh.exemplars(bucket="b1")
    assert (metrics.CONTENT_TYPE, metrics.DEFAULT_BUCKETS) == (
        jax_metrics.CONTENT_TYPE, jax_metrics.DEFAULT_BUCKETS)


def test_registry_refuses_what_the_jax_package_refuses():
    for mod in (metrics, jax_metrics):
        r = mod.Registry()
        c = r.counter("mcim_x_total", "x", labels=("a",))
        assert r.counter("mcim_x_total", "x", labels=("a",)) is c
        with pytest.raises(ValueError):
            r.gauge("mcim_x_total", "x", labels=("a",))
        with pytest.raises(ValueError):
            c.inc(-1, a="1")
        with pytest.raises(ValueError):
            c.inc(b="1")


ADVERSARIAL_VALUES = [
    "plain",
    'with "quotes"',
    "back\\slash",
    "new\nline",
    'all "of\\it"\ntogether',
    "trailing brace} ",
    'a"} b',
    "comma,equals=brace{",
    "",
]

# every separator str.splitlines() breaks on besides "\n"; render leaves
# them unescaped inside a label value
SPLITLINES_SEPARATORS = ["\r", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e", "\x85", "\u2028", "\u2029"]


def _roundtrip(mod, values):
    r = mod.Registry()
    c = r.counter("mcim_serve_adv_total", 'help with "quotes"\nand newline', labels=("v",))
    for i, v in enumerate(values):
        c.inc(i + 1, v=v)
    fam = mod.parse_exposition(r.render())["mcim_serve_adv_total"]
    assert fam["type"] == "counter"
    assert fam["help"] == 'help with "quotes"\nand newline'
    got = {mod.parse_labels(labels)["v"]: val for (_n, labels), val in fam["samples"].items()}
    assert got == {v: float(i + 1) for i, v in enumerate(values)}


def test_exposition_roundtrips_adversarial_labels():
    _roundtrip(metrics, ADVERSARIAL_VALUES)
    _roundtrip(jax_metrics, ADVERSARIAL_VALUES)


@pytest.mark.parametrize("sep", SPLITLINES_SEPARATORS, ids=lambda s: f"U+{ord(s):04X}")
def test_exposition_roundtrips_every_splitlines_separator(sep):
    values = [sep, f"a{sep}b", f'x"{sep}\\']
    _roundtrip(metrics, values)
    # the JAX parser splits the sample line there and raises
    with pytest.raises(ValueError):
        _roundtrip(jax_metrics, values)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.text(min_size=0, max_size=12), min_size=1, max_size=5, unique=True))
def test_exposition_roundtrip_property(values):
    _roundtrip(metrics, values)


def test_histogram_exemplars_render_parse_and_quantile():
    r = metrics.Registry()
    h = r.histogram("mcim_serve_lat_seconds", "lat")
    h.observe(0.02, exemplar="fast-trace")
    for _ in range(89):
        h.observe(0.03)
    for _ in range(9):
        h.observe(0.8)
    h.observe(0.8, exemplar="slow-trace")
    exs = metrics.parse_exposition(r.render())["mcim_serve_lat_seconds"]["exemplars"]
    assert {e["labels"]["trace_id"] for e in exs.values()} == {"fast-trace", "slow-trace"}
    assert h.exemplar_for_quantile(99)[0] == "slow-trace"
    assert h.exemplar_for_quantile(10)[0] == "fast-trace"


def test_every_family_has_type_and_help():
    r = metrics.Registry()
    r.counter("mcim_serve_a_total", "a")
    r.gauge("mcim_serve_b", "b", labels=("x",))
    r.histogram("mcim_serve_c_seconds", "c")
    text = r.render()
    fams = metrics.parse_exposition(text)
    for name in ("mcim_serve_a_total", "mcim_serve_b", "mcim_serve_c_seconds"):
        assert fams[name]["type"] != "untyped", name
        assert fams[name]["help"], name


@pytest.mark.parametrize("bad", ["# TYPE x bogus", 'x{a="1} 2', "x{a=1} 2", "x", "x abc",
                                 'x 1 # nolabels 2'])
def test_parser_rejects_what_the_jax_parser_rejects(bad):
    for mod in (metrics, jax_metrics):
        with pytest.raises(ValueError):
            mod.parse_exposition(bad + "\n")


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------


def test_recorder_vocabulary_and_env_names_are_the_jax_package_s():
    assert recorder.KNOWN_TRIGGERS == jax_recorder.KNOWN_TRIGGERS
    assert (recorder.ENV_DIR, recorder.ENV_CAP, recorder.ENV_MIN_INTERVAL_S) == (
        jax_recorder.ENV_DIR, jax_recorder.ENV_CAP, jax_recorder.ENV_MIN_INTERVAL_S)


def _notes(rec):
    for _ in range(40):
        rec.note("dispatch", bucket="48x48x3", n=2)
    rec.note("dispatch", bucket="96x96x3", n=1)
    rec.note("breaker", key="k", state="open")
    rec.note("heartbeat", replica="r0", warm=["48x48x3"])
    rec.note("log", level="WARNING", msg="m")


def test_recorder_ring_summary_and_dump_equal_the_jax_package_s(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    port, ref = recorder.FlightRecorder(cap=16), jax_recorder.FlightRecorder(cap=16)
    _notes(port)
    _notes(ref)
    assert port.entries() == ref.entries()
    assert len(port.entries()) == 16
    assert port.summary() == ref.summary()
    assert list(port.summary()["hot_buckets"]) == ["48x48x3", "96x96x3"]
    pp = port.dump("manual", path=str(tmp_path / "p.json"), extra={"why": "t"}, force=True)
    jp = ref.dump("manual", path=str(tmp_path / "j.json"), extra={"why": "t"}, force=True)
    with open(pp) as f, open(jp) as g:
        assert json.load(f) == json.load(g)


def test_recorder_rejects_unknown_trigger_and_rate_limits(tmp_path):
    rec = recorder.FlightRecorder(cap=8)
    with pytest.raises(ValueError, match="unknown recorder trigger"):
        rec.dump("not_a_trigger")
    assert rec.dump("manual", path=str(tmp_path / "a.json")) is not None
    assert rec.dump("manual", path=str(tmp_path / "b.json")) is None
    assert rec.dump("manual", path=str(tmp_path / "c.json"), force=True)


def test_recorder_dump_lands_in_the_recorder_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MCIM_RECORDER_DIR", str(tmp_path / "rec"))
    rec = recorder.configure(cap=8)
    try:
        recorder.note("log", level="WARNING", msg="hello")
        path = recorder.dump("manual", force=True)
        assert path.startswith(str(tmp_path / "rec"))
        with open(path) as f:
            payload = json.load(f)
        assert payload["entries"][-1]["msg"] == "hello"
        assert rec is recorder.get_recorder()
    finally:
        recorder.configure(cap=None)


def test_recorder_captures_breaker_failpoint_and_warning_facts():
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
    from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import CircuitBreaker
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

    rec = recorder.configure(cap=64)
    try:
        b = CircuitBreaker(failure_threshold=2, key=("48", "48", 3))
        b.on_failure()
        b.on_failure()
        failpoints.configure("halo.exchange=always")
        with pytest.raises(failpoints.FailpointError):
            failpoints.maybe_fail("halo.exchange")
        get_logger().warning("a warning %d", 7)
        get_logger().info("not recorded")
        by_kind = {}
        for _ts, kind, fields in rec.entries():
            by_kind.setdefault(kind, []).append(fields)
        assert by_kind["breaker"][-1] == {"key": "('48', '48', 3)", "state": "open"}
        assert by_kind["failpoint"] == [{"site": "halo.exchange", "n_call": 1}]
        assert by_kind["log"] == [{"level": "WARNING", "msg": "a warning 7"}]
    finally:
        failpoints.clear()
        recorder.configure(cap=None)


# --------------------------------------------------------------------------
# trace
# --------------------------------------------------------------------------


def _scenario(mod):
    """One deterministic workload on a fresh tracer of `mod`: sampled-in
    and sampled-out roots, nested and cross-parented spans, instant events,
    error roots that the tail keeps and benign ones it drops."""
    t = mod.Tracer(sample=0.5, tail=3, max_events=1000)
    ids = []
    # traces 1, 3, 5, 7 and 9 (loop n 0, 2, 4, 6, 7) are sampled out
    statuses = ("quarantined", "ok", "ok", None, None, "ok", "429", "deadline_expired")
    for n, status in enumerate(statuses):
        root = t.start_trace("req", n=n)
        ids.append(root.trace_id)
        with root:
            with t.span("stage.a", k=n) as a:
                t.event("retry", attempt=1)
                with t.span("stage.b"):
                    pass
                ctx = a.context()
            t.span("cross", parent=ctx, where="other-thread").end()
            if status is not None:
                root.set(status=status)
        if n == 6:
            try:
                with t.start_trace("boom"):
                    raise KeyError("x")
            except KeyError:
                pass
    adopted = t.start_trace("adopted", trace_id="upstream-1")
    adopted.end()
    return t, ids


def _normal(t, ids):
    """The tracer's events with timestamps, thread ids and the run-unique
    trace-id prefix dropped."""
    out = []
    for e in t.chrome_events(pid=1):
        e = dict(e)
        for k in ("ts", "dur", "tid", "pid"):
            e.pop(k, None)
        if e["ph"] == "M":
            continue
        args = dict(e["args"])
        if "trace_id" in args:
            args["trace_id"] = args["trace_id"].rsplit("-", 1)[-1]
        e["args"] = args
        out.append(e)
    kept = [t.trace_kept(i) for i in ids]
    return out, t.counts(), kept


def test_trace_structure_equals_the_jax_package_s():
    port = _normal(*_scenario(obs_trace))
    ref = _normal(*_scenario(jax_trace))
    assert port == ref
    events, counts, kept = port
    assert counts["traces"] == 10 and counts["sampled"] == 5
    assert counts["tail"]["kept_error"] >= 1 and counts["tail"]["dropped"] >= 1
    assert not all(kept)
    names = {e["name"] for e in events}
    assert {"req", "stage.a", "stage.b", "cross", "retry", "boom", "adopted"} <= names


def test_disarmed_and_sampled_out_spans_are_the_shared_noop():
    obs_trace.disable()
    assert obs_trace.start_trace("x") is obs_trace.NOOP_SPAN
    assert obs_trace.span("y") is obs_trace.NOOP_SPAN
    assert obs_trace.export("/nonexistent/never-written.json") == 0
    assert obs_trace.current_trace_id() == ""
    assert obs.span is obs_trace.span and obs.NOOP_SPAN is obs_trace.NOOP_SPAN
    t = obs_trace.Tracer(sample=0.0, tail=0)
    assert t.start_trace("x") is obs_trace.NOOP_SPAN
    assert t.span("y") is obs_trace.NOOP_SPAN  # no parent: never a new trace
    with pytest.raises(ValueError):
        obs_trace.Tracer(sample=1.5)


def test_module_tracer_exports_chrome_json_and_notes_the_recorder(tmp_path):
    rec = recorder.configure(cap=32)
    try:
        obs_trace.configure(sample=1.0, tail=0)
        assert obs_trace.enabled()
        root = obs_trace.start_trace("run", ops="gaussian:5")
        with root:
            assert obs_trace.current_trace_id() == root.trace_id
            assert obs_trace.current_context() == root.context()
            with obs_trace.span("child", x=1):
                obs_trace.event("mark")
        n = obs_trace.export(str(tmp_path / "t.json"))
        with open(tmp_path / "t.json") as f:
            doc = json.load(f)
        assert len(doc["traceEvents"]) == n and doc["displayTimeUnit"] == "ms"
        spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
        assert spans["child"]["args"]["parent_id"] == spans["run"]["args"]["span_id"]
        noted = [f["name"] for _ts, k, f in rec.entries() if k == "span"]
        assert noted == ["child", "run"]
    finally:
        obs_trace.disable()
        recorder.configure(cap=None)


@pytest.mark.parametrize("env", [{}, {"MCIM_TRACE_SAMPLE": "0.25"},
                                 {"MCIM_TRACE_SAMPLE": "1", "MCIM_TRACE_TAIL": "0"}])
def test_configure_from_env_equals_the_jax_package_s(env):
    try:
        for mod in (obs_trace, jax_trace):
            got = mod.configure_from_env(env=env)
            if not env:
                assert got is None
            else:
                assert (got.sample, got.tail_cap) == (
                    float(env["MCIM_TRACE_SAMPLE"]), int(env.get("MCIM_TRACE_TAIL", "256")))
    finally:
        obs_trace.disable()
        jax_trace.disable()
