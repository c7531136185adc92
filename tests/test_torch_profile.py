"""The port's profiling (obs/profile.py, run --profile-dir) on the CPU: the
twins of the JAX package's test_obs.py merge test and test_cost.py capture
tests, the DMA/compute split held to the JAX package's summary on
JAX-shaped traces and extended to torch.profiler's categories, the live
capture (Chrome trace, merged artifact, rate limit, in-flight lock,
window cap, operators of other threads), and `run --profile-dir --device
cpu`.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.obs import profile as jax_profile
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.obs import profile as obs_profile
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

DEVICE_EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/device:TPU:0"}},
    {"ph": "X", "name": "fusion.23", "pid": 7, "tid": 1, "ts": 1000.0, "dur": 400.0},
    {"ph": "X", "name": "dma.copy_h2d", "pid": 7, "tid": 2, "ts": 1100.0, "dur": 100.0},
]


def test_profile_merge_host_and_device(tmp_path):
    t = obs_trace.Tracer(sample=1.0)
    with t.start_trace("serve.request"):
        with t.span("serve.dispatch"):
            pass
    host_path = tmp_path / "spans.json"
    t.export(str(host_path))
    device_path = tmp_path / "device.json"
    device_path.write_text(json.dumps({"traceEvents": DEVICE_EVENTS}))
    merged_out = tmp_path / "merged.json"
    summary = obs_profile.merge_and_summarize(str(host_path), str(device_path),
                                              merged_out=str(merged_out))
    assert summary["host_events"] >= 2
    assert summary["device_events"] == 2
    assert summary["device_dma_us"] == 100.0
    assert summary["device_compute_us"] == 400.0
    assert "mcim-host" in summary["processes"]
    merged = json.loads(merged_out.read_text())["traceEvents"]
    assert min(e["ts"] for e in merged if e.get("ph") == "X") == 0.0
    procs = {e["args"]["name"] for e in merged
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"mcim-host", "/device:TPU:0"} <= procs
    names = {t["name"] for t in summary["top_events"]}
    assert {"serve.request", "fusion.23", "dma.copy_h2d"} <= names
    # the JAX package's merge of the same two files gives the same summary
    jmerged = tmp_path / "jmerged.json"
    want = jax_profile.merge_and_summarize(str(host_path), str(device_path),
                                           merged_out=str(jmerged))
    assert {**summary, "merged_trace": None} == {**want, "merged_trace": None}
    assert json.loads(merged_out.read_text()) == json.loads(jmerged.read_text())


HOST = obs_profile.HOST_PID


def _jax_shaped_trace(seed: int) -> list[dict]:
    """A seeded JAX-shaped trace: device tracks with copy-shaped and
    compute names, the python host thread, the obs host track, an
    unnamed pid, a metadata-only process."""
    rng = np.random.default_rng(seed)
    procs = {3: "/device:TPU:0", 4: "/device:TPU:1", 5: "python3", 6: "/host:CPU",
             HOST: "mcim-host"}
    ev = [{"ph": "M", "name": "process_name", "pid": p, "args": {"name": n}}
          for p, n in procs.items()]
    names = ["fusion.1", "copy-start", "DMA wait", "convolution.4", "Infeed", "reduce",
             "MemcpyD2H", "transfer.3", "while.body"]
    for _ in range(200):
        ev.append({"ph": "X", "name": str(rng.choice(names)),
                   "pid": int(rng.choice([3, 4, 5, 6, HOST, 9])),
                   "tid": int(rng.integers(4)), "ts": float(rng.uniform(0, 1e6)),
                   "dur": float(np.round(rng.uniform(0.1, 500.0), 3))})
    ev.append({"ph": "i", "name": "marker", "pid": 3, "ts": 5.0})
    return ev


@pytest.mark.parametrize("seed", range(3))
def test_summarize_jax_shaped_trace_equals_the_jax_package_s(seed):
    ev = _jax_shaped_trace(seed)
    for top_n in (5, 40):
        assert obs_profile.summarize(ev, top_n=top_n) == jax_profile.summarize(ev, top_n=top_n)
    assert obs_profile.summary_table(obs_profile.summarize(ev)) == \
        jax_profile.summary_table(jax_profile.summarize(ev))
    host = [{"ph": "X", "name": "serve.request", "pid": 1, "tid": 1, "ts": 10.0, "dur": 3.0}]
    assert obs_profile.merge_traces(host, ev) == jax_profile.merge_traces(host, ev)
    assert obs_profile.DMA_MARKERS == jax_profile.DMA_MARKERS
    assert obs_profile.HOST_PID == jax_profile.HOST_PID


def test_summarize_reads_torch_profiler_categories():
    """A torch.profiler-shaped trace: copies and memsets on the card are
    DMA, kernels compute, and the host's operators and runtime calls, the
    profiler's own span (pid 'Spans', no process name) and annotations
    count as neither; the python host process is no device process."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 4242, "tid": 1,
         "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242, "tid": 1,
         "ts": 1.0, "dur": 7.0},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 0.0, "dur": 9999.0},
        {"ph": "X", "cat": "kernel", "name": "fused_stage_kernel<5, 0>", "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "void at::elementwise_kernel<...copy...>",
         "pid": 0, "tid": 7, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "pid": 0,
         "tid": 8, "ts": 5.0, "dur": 120.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 8,
         "ts": 5.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "run.steady", "pid": 0, "tid": 9,
         "ts": 5.0, "dur": 500.0},
    ]
    s = obs_profile.summarize(ev)
    assert s["device_dma_us"] == 123.0
    assert s["device_compute_us"] == 320.0  # a kernel named "copy" is still a kernel
    assert s["processes"]["python"] == 57.0


def test_capture_live_writes_merged_artifact_and_rate_limits(tmp_path, monkeypatch):
    """The live capture on the CPU: operators recorded while the window
    runs work, the profiler's Chrome trace in the capture directory that
    load_device_trace reads, the merged artifact with the obs host spans,
    a recorder dump; a second capture inside the rate limit refuses with a
    retry-after."""
    monkeypatch.setenv("MCIM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("MCIM_RECORDER_DIR", str(tmp_path / "rec"))
    monkeypatch.setenv("MCIM_RECORDER_MIN_INTERVAL_S", "0")  # another test's dump may be recent
    monkeypatch.setenv("MCIM_PROFILE_MIN_INTERVAL_S", "60")
    monkeypatch.setattr(obs_profile, "_last_capture_ts", 0.0)
    obs_trace.configure(sample=1.0, tail=0)
    try:
        with obs_trace.start_trace("test.capture") as root:
            with obs_trace.span("test.work", parent=root.context()):
                pass  # a CLOSED span, so the host side has >= 1 event
            result = obs_profile.capture_live(
                0.2, device="cpu",
                sleep=lambda s: (torch.ones(64, 64) * 2).sum(),
            )
    finally:
        obs_trace.disable()
    assert result["seconds"] == pytest.approx(0.2)
    assert result["device_trace_dir"].startswith(str(tmp_path))
    merged = json.load(open(result["artifact"]))
    assert merged["traceEvents"], "empty merged trace"
    assert result["host_events"] >= 1 and result["device_events"] > 0
    device = obs_profile.load_device_trace(result["device_trace_dir"])
    assert sum(1 for e in device if e.get("ph") != "M") == result["device_events"]
    assert any(e.get("name") == "aten::ones" for e in device)
    assert result["summary"]["processes"]
    assert os.listdir(tmp_path / "rec")  # the profile_capture dump
    with pytest.raises(obs_profile.ProfileUnavailable) as ei:
        obs_profile.capture_live(0.1, device="cpu")
    assert ei.value.retry_after_s > 0 and "rate limited" in ei.value.reason


def test_capture_live_in_flight_lock_and_window_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("MCIM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("MCIM_PROFILE_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("MCIM_PROFILE_MAX_S", "0.3")
    monkeypatch.setattr(obs_profile, "_last_capture_ts", 0.0)
    assert obs_profile._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(obs_profile.ProfileUnavailable) as ei:
            obs_profile.capture_live(0.1, device="cpu")
        assert ei.value.reason == "capture already in flight"
    finally:
        obs_profile._capture_lock.release()
    slept = []
    res = obs_profile.capture_live(5.0, device="cpu", sleep=slept.append)
    assert slept == [0.3] and res["seconds"] == 0.3  # capped at MCIM_PROFILE_MAX_S
    monkeypatch.setenv("MCIM_PROFILE_DEFAULT_S", "0.25")
    obs_profile.capture_live(None, device="cpu", sleep=slept.append)
    assert slept[-1] == 0.25
    assert not obs_profile._capture_lock.locked()  # never left held


def test_capture_records_operators_of_other_threads(tmp_path, monkeypatch):
    """The capture runs on the caller's thread while work runs on others
    (the HTTP handler and the scheduler in a server): their operators are
    in the trace."""
    monkeypatch.setenv("MCIM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(obs_profile, "_last_capture_ts", 0.0)
    started, stop = threading.Event(), threading.Event()

    def work():
        started.set()
        while not stop.is_set():
            torch.ones(32, 32).neg()

    def window(s):
        worker = threading.Thread(target=work)
        worker.start()
        started.wait(5)
        import time

        time.sleep(s)
        stop.set()
        worker.join(5)

    res = obs_profile.capture_live(0.2, device="cpu", sleep=window)
    device = obs_profile.load_device_trace(res["device_trace_dir"])
    tids = {e.get("tid") for e in device if e.get("name") == "aten::neg"}
    assert tids and threading.get_native_id() not in tids


def test_run_profile_dir_device_cpu(tmp_path):
    src, out, prof = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "prof"
    save_image(str(src), synthetic_image(40, 48, channels=3, seed=1))
    assert cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                     "--profile-dir", str(prof), "--show-timing"]) == 0
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    events = obs_profile.load_device_trace(str(prof))
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    summary = obs_profile.summarize(events)
    assert summary["processes"] and summary["device_dma_us"] == 0.0  # no card, no copies


def test_run_profile_dir_ignored_under_device_timeout(tmp_path):
    import logging

    src, out, prof = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "prof"
    save_image(str(src), synthetic_image(24, 32, channels=3, seed=2))
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = get_logger().logger  # its own handlers set up first
    logger.addHandler(handler)
    try:
        assert cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                         "--impl", "torch", "--device-timeout", "120",
                         "--profile-dir", str(prof)]) == 0
    finally:
        logger.removeHandler(handler)
    assert not prof.exists()
    assert any("--profile-dir is not supported in guarded mode" in r.getMessage()
               for r in records)


def test_init_profiler_runs_one_session_once(monkeypatch):
    """init_profiler starts and stops one session on the calling thread,
    once per process; ServeApp.start() calls it on a CUDA device only."""
    calls = []

    class Fake:
        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

    monkeypatch.setattr(obs_profile, "_kineto_ready", False)
    monkeypatch.setattr(obs_profile, "profiler", lambda device=None: Fake())
    obs_profile.init_profiler("cuda")
    obs_profile.init_profiler("cuda")
    assert calls == ["start", "stop"]
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeApp, ServeConfig

    monkeypatch.setattr(obs_profile, "_kineto_ready", False)
    app = ServeApp(ServeConfig(buckets=((32, 32),), channels=(3,), max_batch=1,
                               device="cpu")).start()
    app.stop(drain=False)
    assert calls == ["start", "stop"] and not obs_profile._kineto_ready


def test_profiler_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setenv("MCIM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(obs_profile, "_last_capture_ts", 0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        obs_profile.profiler()
    with pytest.raises(RuntimeError, match="cuda"):
        obs_profile.capture_live(0.1)
    # the refused capture started nothing: no directory, no rate-limit stamp
    assert not os.listdir(tmp_path) and obs_profile._last_capture_ts == 0.0
