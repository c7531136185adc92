"""`run --trace-out` and the traced sharded dispatch on the CPU.

`run` writes one trace: the root ``run`` and its children ``run.load``,
``run.compile_and_run``, ``run.steady`` and ``run.save``, with the JAX
package's span names and parent links; ``--shards 2`` adds
``sharded.dispatch`` below ``run.compile_and_run``, with the mesh and halo
mode as its arguments. The trace is written on the error path too, where
the failpoint hit and the WARNING line land in the flight recorder, stderr
gets one error line, and the tracer is disarmed after the run. A timed
run on the CPU calls the pipeline twice, traced or not (on a card only a
traced run adds one synchronised call before the CUDA-event timing). Untraced, the sharded dispatch makes
no span.
"""

import json

import pytest
import torch

from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

RUN_SPANS = ("run.load", "run.compile_and_run", "run.steady", "run.save")


@pytest.fixture()
def image(tmp_path, monkeypatch):
    monkeypatch.delenv("MCIM_TRACE_SAMPLE", raising=False)
    monkeypatch.setenv("MCIM_CALIB_FILE", str(tmp_path / "calib.json"))
    path = tmp_path / "in.png"
    save_image(str(path), synthetic_image(48, 64, channels=3, seed=2))
    failpoints.clear()
    yield path
    failpoints.clear()
    obs_trace.disable()


def _spans(path):
    with open(path) as f:
        doc = json.load(f)
    return {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}


def _run(image, tmp_path, *extra):
    return cli.main(["run", "--input", str(image), "--output", str(tmp_path / "out.png"),
                     "--device", "cpu", "--trace-out", str(tmp_path / "t.json"), *extra])


def test_run_writes_the_five_spans(image, tmp_path):
    assert _run(image, tmp_path, "--show-timing") == 0
    spans = _spans(tmp_path / "t.json")
    assert set(spans) == {"run", *RUN_SPANS}
    root = spans["run"]["args"]
    assert "parent_id" not in root and root["impl"] == "auto" and root["shards"] == "1"
    for name in RUN_SPANS:
        assert spans[name]["args"]["parent_id"] == root["span_id"], name
        assert spans[name]["args"]["trace_id"] == root["trace_id"]
    assert spans["run.load"]["args"]["path"] == str(image)
    steady = spans["run.steady"]["args"]
    assert steady["steady_ms"] == steady["call_ms"]  # the CPU's host time
    assert not obs_trace.enabled()  # disarmed after the run


def test_sharded_run_adds_the_dispatch_span(image, tmp_path):
    assert _run(image, tmp_path, "--shards", "2", "--halo-mode", "overlap") == 0
    spans = _spans(tmp_path / "t.json")
    assert set(spans) == {"run", "run.load", "run.compile_and_run", "run.save",
                          "sharded.dispatch"}
    d = spans["sharded.dispatch"]["args"]
    assert d["parent_id"] == spans["run.compile_and_run"]["args"]["span_id"]
    assert (d["mesh"], d["halo_mode"]) == ("{'rows': 2}", "overlap")


def test_the_trace_is_written_on_the_error_path(image, tmp_path, monkeypatch):
    rec = recorder.configure(cap=64)
    try:
        assert _run(image, tmp_path, "--failpoints", "io.decode=always") == 2
        spans = _spans(tmp_path / "t.json")
        assert spans["run"]["args"]["error"] == "FailpointError"
        assert spans["run.load"]["args"]["error"] == "FailpointError"
        kinds = [(k, f) for _ts, k, f in rec.entries()]
        assert ("failpoint", {"site": "io.decode", "n_call": 1}) in kinds
        logs = [f for k, f in kinds if k == "log"]
        assert logs and logs[-1]["level"] == "WARNING" and "io.decode" in logs[-1]["msg"]
    finally:
        recorder.configure(cap=None)


def _count_runner_calls(monkeypatch):
    calls = []
    real = cli.image_runner

    def counted(*a, **k):
        fn = real(*a, **k)

        def run(x):
            calls.append(1)
            return fn(x)

        return run

    monkeypatch.setattr(cli, "image_runner", counted)
    return calls


@pytest.mark.parametrize("traced", [False, True])
def test_a_timed_cpu_run_calls_the_pipeline_twice_traced_or_not(image, tmp_path, monkeypatch,
                                                               traced):
    calls = _count_runner_calls(monkeypatch)
    argv = ["run", "--input", str(image), "--output", str(tmp_path / "out.png"),
            "--device", "cpu", "--show-timing"]
    if traced:
        argv += ["--trace-out", str(tmp_path / "t.json")]
    assert cli.main(argv) == 0
    # the first call, then one timed call on the CPU: the traced run's
    # synchronised call is its timed call there
    assert len(calls) == 2


def test_a_failed_run_prints_one_error_line(image, tmp_path, capsys):
    assert _run(image, tmp_path, "--failpoints", "io.decode=always") == 2
    err = capsys.readouterr().err
    assert err.count("io.decode") == 1 and err.startswith("error: ")


def test_a_sampled_out_run_writes_no_span(image, tmp_path):
    assert _run(image, tmp_path, "--trace-sample", "0") == 0
    assert _spans(tmp_path / "t.json") == {}


def test_untraced_sharded_dispatch_makes_no_span():
    pipe = Pipeline.parse("grayscale,gaussian:5")
    img = torch.from_numpy(synthetic_image(40, 32, channels=3, seed=1))
    fn = pipe.sharded(make_mesh(2, devices=["cpu", "cpu"]), backend="cuda")
    tracer = obs_trace.configure(sample=1.0, tail=0)
    try:
        fn(img)  # armed, but no trace is open: no span
        assert tracer.counts()["events"] == 0
        with obs_trace.start_trace("caller"):
            out = fn(img)
        names = [e["name"] for e in tracer.drain()]
        assert names == ["sharded.dispatch", "caller"]
        assert torch.equal(out, pipe(img))
    finally:
        obs_trace.disable()
