"""`batch` through the port's main against the JAX package's cmd_batch on
the same directory (``--impl xla``) and against the port's `run`, on the
CPU: every dispatch form (one image, a stack, row and tile shards, a
data-parallel stack) under ``--impl torch`` and ``auto``, byte for byte
file by file; the exit codes; the trailing partial stack at its own size
and the shape-change flushes padded, in order; a corrupt input in the
skipped list and the journal; ``batch.interrupt`` then ``--resume`` with
no duplicate and no lost output, an edited input reprocessed; ``--window``;
the metrics and trace outputs; ``--json-metrics``'s keys; the
``--stream-rows`` refusals (--stack, --shards).
"""

import json
import logging
import os
import time

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu import cli as jax_cli
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch import engine as engine_pkg
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import BatchJournal

SPEC = "grayscale,contrast:3.5,emboss:3"
# sorted names interleave two shapes (and a gray source), so that a stack
# flushes on every shape change: A A B A A B
FILES = {
    "a0.ppm": (24, 40, 3, 1), "a1.ppm": (24, 40, 3, 2), "b0.png": (17, 32, 3, 3),
    "c0.ppm": (24, 40, 3, 4), "c1.pgm": (24, 40, 1, 5), "d0.png": (17, 32, 3, 6),
}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def _make_inputs(src) -> None:
    os.makedirs(src, exist_ok=True)
    for name, (h, w, c, seed) in FILES.items():
        save_image(os.path.join(src, name), synthetic_image(h, w, channels=c, seed=seed))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The input directory and the JAX package's cmd_batch outputs of it."""
    root = tmp_path_factory.mktemp("batch")
    src = str(root / "in")
    _make_inputs(src)
    out = str(root / "jax")
    assert jax_cli.main(["batch", "--input-dir", src, "--output-dir", out, "--ops", SPEC,
                         "--impl", "xla", "--no-journal"]) == 0
    return src, out


def _port(src, out, *extra) -> int:
    return cli.main(["batch", "--input-dir", str(src), "--output-dir", str(out), "--ops", SPEC,
                     "--device", "cpu", *extra])


def _same_files(got_dir, want_dir, names=FILES) -> None:
    for name in names:
        np.testing.assert_array_equal(load_image(os.path.join(got_dir, name)),
                                      load_image(os.path.join(want_dir, name)), err_msg=name)


FORMS = {"one image": [], "stack 3": ["--stack", "3"], "shards 2": ["--shards", "2"],
         "shards 2x2": ["--shards", "2x2"], "stack 4 shards 2": ["--stack", "4", "--shards", "2"]}


@pytest.mark.parametrize("impl", ["torch", "auto"])
@pytest.mark.parametrize("form", list(FORMS))
def test_every_dispatch_form_equals_jax_cmd_batch(corpus, tmp_path, impl, form):
    src, want = corpus
    assert _port(src, tmp_path / "out", "--impl", impl, "--no-journal", *FORMS[form]) == 0
    _same_files(tmp_path / "out", want)


def test_batch_equals_the_ports_run(corpus, tmp_path):
    src, _ = corpus
    assert _port(src, tmp_path / "out", "--impl", "cuda", "--plan", "fused-pallas",
                 "--no-journal") == 0
    for name in FILES:
        one = str(tmp_path / f"run_{name}")
        assert cli.main(["run", "--input", os.path.join(src, name), "--output", one, "--ops", SPEC,
                         "--device", "cpu", "--impl", "cuda"]) == 0
        np.testing.assert_array_equal(load_image(tmp_path / "out" / name), load_image(one))


def test_empty_glob_exits_3(tmp_path):
    (tmp_path / "in").mkdir()
    assert _port(tmp_path / "in", tmp_path / "out", "--glob", "*.nothing") == 3


class _Recorder(engine_pkg.Engine):
    """The engine, with the shape of each dispatch's input recorded."""

    shapes: list = []

    def submit(self, key, make_input, run, **kw):
        x = make_input()
        _Recorder.shapes.append((key, tuple(x.shape)))
        return super().submit(key, lambda: x, run, **kw)


def test_partial_stacks_and_shape_change_flushes(corpus, tmp_path, monkeypatch):
    """--stack 3 over A A B A A B: each shape change flushes the pending
    stack padded to 3 (pad_stack), in input order; the trailing partial
    stack goes at its own size."""
    src, want = corpus
    _Recorder.shapes = []
    monkeypatch.setattr(engine_pkg, "Engine", _Recorder)
    assert _port(src, tmp_path / "out", "--impl", "torch", "--stack", "3", "--no-journal") == 0
    assert _Recorder.shapes == [((0, 1), (3, 24, 40, 3)), ((2,), (3, 17, 32, 3)),
                                ((3, 4), (3, 24, 40, 3)), ((5,), (1, 17, 32, 3))]
    _same_files(tmp_path / "out", want)


def test_corrupt_input_continues_exits_1_journaled(corpus, tmp_path):
    src = tmp_path / "in"
    _make_inputs(src)
    (src / "bad.ppm").write_bytes(b"P6\n garbage")
    out, metrics = tmp_path / "out", tmp_path / "m.jsonl"
    assert _port(src, out, "--impl", "torch", "--json-metrics", str(metrics)) == 1
    _same_files(out, corpus[1])
    rec = json.loads(metrics.read_text().strip())
    assert rec["skipped"] == [str(src / "bad.ppm")]
    assert rec["failed"] == {"bad.ppm": "decode failed (skipped)"}
    assert rec["processed"] == len(FILES)
    journal = BatchJournal(out / ".mcim_batch_journal.jsonl").load()
    assert journal["bad.ppm"]["status"] == "failed"
    assert all(journal[n]["status"] == "ok" for n in FILES)


def test_interrupt_then_resume_no_duplicate_no_loss(corpus, tmp_path):
    """An armed batch.interrupt aborts the run mid-stream with --inflight 2;
    the engine drains what was dispatched (journaled only once written);
    --resume redoes only the rest, and an input edited since is
    reprocessed."""
    src = tmp_path / "in"
    _make_inputs(src)
    out = tmp_path / "out"
    base = ["--impl", "torch", "--inflight", "2"]
    assert _port(src, out, *base, "--failpoints", "batch.interrupt=after:3") == 2
    failpoints.clear()
    journal = BatchJournal(out / ".mcim_batch_journal.jsonl")
    done_before = {rel for rel, r in journal.load().items() if r["status"] == "ok"}
    assert 0 < len(done_before) < len(FILES)
    assert all((out / rel).exists() for rel in done_before)
    mtimes = {rel: os.stat(out / rel).st_mtime_ns for rel in done_before}
    edited = sorted(done_before)[0]
    save_image(src / edited, synthetic_image(*FILES[edited][:2], channels=FILES[edited][2],
                                             seed=99))
    time.sleep(0.02)
    metrics = tmp_path / "m.jsonl"
    assert _port(src, out, *base, "--resume", "--json-metrics", str(metrics)) == 0
    rec = json.loads(metrics.read_text().strip())
    assert rec["resumed"] == len(done_before) - 1
    assert rec["processed"] == len(FILES) - len(done_before) + 1
    for rel, t in mtimes.items():
        assert (os.stat(out / rel).st_mtime_ns != t) == (rel == edited), rel
    jax_out = tmp_path / "jax"
    assert jax_cli.main(["batch", "--input-dir", str(src), "--output-dir", str(jax_out),
                         "--ops", SPEC, "--impl", "xla", "--no-journal"]) == 0
    _same_files(out, jax_out)
    assert sum(r["status"] == "ok" for r in journal.load().values()) == len(FILES)


def test_resume_needs_the_journal(corpus, tmp_path):
    assert _port(corpus[0], tmp_path / "out", "--resume", "--no-journal") == 2


def test_window_is_a_deprecated_alias(corpus, tmp_path):
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    log = logging.getLogger("mcim_torch")
    log.addHandler(handler)
    try:
        assert _port(corpus[0], tmp_path / "out", "--impl", "torch", "--window", "1",
                     "--no-journal", "--json-metrics", str(tmp_path / "m.jsonl")) == 0
    finally:
        log.removeHandler(handler)
    assert "--window is deprecated; use --inflight" in seen
    assert json.loads((tmp_path / "m.jsonl").read_text())["inflight"] == 1
    _same_files(tmp_path / "out", corpus[1])


def test_metrics_out_and_trace_out(corpus, tmp_path):
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    try:
        assert _port(corpus[0], tmp_path / "out", "--impl", "torch", "--no-journal",
                     "--metrics-out", str(prom), "--trace-out", str(trace)) == 0
    finally:
        obs_trace.disable()
    text = prom.read_text()
    for family in ("mcim_engine_submitted_total", "mcim_engine_completed_total",
                   "mcim_engine_inflight_peak", "mcim_engine_device_idle_seconds_total",
                   "mcim_engine_stage_seconds", "mcim_batch_inputs_total"):
        assert f"# TYPE {family}" in text, family
    assert f'mcim_batch_inputs_total{{outcome="ok"}} {len(FILES)}' in text
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"batch.dispatch", "engine.force", "engine.encode"} <= names


def test_json_metrics_keys_equal_jax(corpus, tmp_path):
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    assert _port(corpus[0], tmp_path / "o1", "--impl", "torch", "--no-journal",
                 "--json-metrics", str(ours), "--show-timing") == 0
    assert jax_cli.main(["batch", "--input-dir", corpus[0], "--output-dir", str(tmp_path / "o2"),
                         "--ops", SPEC, "--impl", "xla", "--no-journal", "--json-metrics",
                         str(theirs)]) == 0
    a, b = (json.loads(p.read_text().strip()) for p in (ours, theirs))
    assert set(a) == set(b)
    assert set(a["engine"]) == set(b["engine"])
    assert set(a["engine"]["stages"]) == set(b["engine"]["stages"])
    assert (a["inputs"], a["processed"], a["resumed"]) == (b["inputs"], b["processed"], 0)


def test_show_timing_prints_the_idle_share(corpus, tmp_path, capsys):
    assert _port(corpus[0], tmp_path / "out", "--impl", "torch", "--no-journal",
                 "--show-timing") == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("batch [")]
    assert len(line) == 1 and "MP/s end-to-end" in line[0] and "device idle" in line[0]


def test_stream_rows_is_refused_by_name(corpus, tmp_path, capsys):
    """--stream-rows streams (tests/test_torch_stream.py); what it refuses,
    as the JAX package does, is --stack and --shards."""
    assert _port(corpus[0], tmp_path / "out", "--stream-rows", "8", "--stack", "2") == 2
    assert "tile engine" in capsys.readouterr().err
    with pytest.raises(ValueError, match="incompatible with --stack/--shards"):
        cli.cmd_batch(cli._build_parser().parse_args(
            ["batch", "--input-dir", corpus[0], "--output-dir", str(tmp_path / "o"),
             "--stream-rows", "8", "--shards", "2", "--device", "cpu"]))
