"""The port's HTTP front door and CLI ``serve`` on the CPU: a round trip
through the context-manager ``Server`` on port 0 (POST /v1/process held to
the JAX package's golden, 400, 504, the replica's fleet routes (the
/fleet/snapshot federation snapshot, a session frame's refusals and an
unknown route's 404), the pipeline service's routes answering before any
registration, /healthz, /stats, /metrics), the HTTP open-loop generator,
and ``serve --device cpu`` in a subprocess stopped by SIGTERM: a clean
drain and exit 0, with the stats record written. The refusals (--impl
cuda/swar, also with --replicas > 1, and the default CUDA device without
one) exit 2 with their reason.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig, Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_OPS = "grayscale,contrast:3.5,emboss:3"
TIMEOUT_S = 60


def _golden(img):
    return np.asarray(jax.block_until_ready(JaxPipeline.parse(REFERENCE_OPS).jit()(img)))


def _post(base, data, path="/v1/process", headers=None):
    req = urllib.request.Request(f"{base}{path}", data=data, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(base, path):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_roundtrip_health_stats_metrics_and_refusals():
    cfg = ServeConfig(buckets=((48, 48),), channels=(3,), max_batch=2, device="cpu")
    with Server(cfg, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.address[1]}"
        code, body = _get(base, "/healthz")
        assert code == 200 and json.loads(body)["state"] == "serving"
        img = synthetic_image(30, 40, channels=3, seed=9)
        code, hdrs, body = _post(base, encode_image_bytes(img))
        assert code == 200 and hdrs["Content-Type"] == "image/png"
        np.testing.assert_array_equal(decode_image_bytes(body), _golden(img))
        code, _, body = _post(base, b"not an image")
        assert code == 400 and "undecodable" in json.loads(body)["error"]
        code, _, body = _post(base, encode_image_bytes(img), headers={"X-MCIM-Deadline-Ms": "0"})
        assert code == 504
        code, body = _get(base, "/fleet/snapshot")
        snap = json.loads(body)
        assert code == 200 and snap["full"]
        assert "mcim_serve_requests_total" in snap["metrics"]
        code, _, body = _post(base, b"{}", path="/v1/session/s1/frame")
        assert code == 400 and "X-Session-Seq" in json.loads(body)["error"]
        code, _, body = _post(base, b"{}", path="/v1/sessions/s1/frame")
        assert code == 404 and json.loads(body)["code"] == "unknown-route"
        # the pipeline service's routes, before any registration: an empty
        # registry, the taxonomy's refusals, a systolic hop refused by a
        # replica that is not systolic
        code, body = _get(base, "/v1/pipelines")
        assert code == 200 and json.loads(body) == {"tenants": {}}
        code, _, body = _post(base, b"{}", path="/v1/tenants")
        assert code == 422 and json.loads(body)["code"] == "bad-tenant-id"
        code, _, body = _post(base, b"{}", path="/v1/systolic")
        assert code == 409 and json.loads(body)["status"] == "systolic-broken"
        for path, headers in (("/v1/process?pipeline=p1", None),
                              ("/v1/process", {"X-MCIM-Pipeline": "p1"})):
            code, _, body = _post(base, encode_image_bytes(img), path=path, headers=headers)
            assert code == 404 and json.loads(body)["code"] == "unknown-tenant", path
        code, body = _get(base, "/stats")
        stats = json.loads(body)
        assert stats["completed"] == 1 and stats["rejected"] == 1
        assert stats["cache"]["traces_since_warmup"] == 0
        assert stats["pipeline"] == "grayscale,contrast3.5,emboss3"
        assert stats["device"] == "cpu"
        code, body = _get(base, "/metrics")
        fams = parse_exposition(body.decode())
        assert {"mcim_serve_requests_total", "mcim_plan_builds_total",
                "mcim_devmem_devices"} <= set(fams)
        assert any(name.startswith("mcim_engine_") for name in fams)
        # the HTTP open-loop generator against the same door
        blobs = [loadgen.encode_blob(synthetic_image(20 + k, 30, channels=3, seed=k))
                 for k in range(3)]
        rec = loadgen.http_run_offered_load(base, blobs, 40.0, 0.2, timeout_s=TIMEOUT_S)
        assert rec["ok"] == rec["submitted"] > 0
        for k, res in rec["results"]:
            want = _golden(synthetic_image(20 + k, 30, channels=3, seed=k))
            np.testing.assert_array_equal(decode_image_bytes(res["body"]), want)
        port = srv.address[1]
    # the listener is released on exit: the port binds again, as a
    # restarted server binds it (SO_REUSEADDR passes the closed
    # connections' TIME_WAIT, never a socket still listening)
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()


def test_server_start_failure_releases_everything():
    cfg = ServeConfig(ops="fliph", buckets=((32, 32),), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        Server(cfg, host="127.0.0.1", port=0).start()


def _serve_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_serve_drains_on_sigterm_and_exits_zero(tmp_path):
    metrics = tmp_path / "serve.json"
    env = _serve_env()
    env["MCIM_RECORDER_DIR"] = str(tmp_path / "rec")
    p = subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch", "serve", "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--buckets", "32,48", "--max-batch", "2",
         "--channels", "1,3", "--json-metrics", str(metrics)],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True,
    )
    lines: list[str] = []
    try:
        port = None
        for line in p.stderr:
            lines.append(line)
            m = re.search(r"serving \[.*\] on [\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "".join(lines)
        reader = threading.Thread(target=lambda: lines.extend(p.stderr), daemon=True)
        reader.start()
        base = f"http://127.0.0.1:{port}"
        img = synthetic_image(30, 40, channels=3, seed=2)
        code, _, body = _post(base, encode_image_bytes(img))
        assert code == 200
        np.testing.assert_array_equal(decode_image_bytes(body), _golden(img))
        gray = synthetic_image(25, 20, channels=1, seed=3)
        code, _, body = _post(base, encode_image_bytes(gray))
        assert code == 400  # the grayscale-first chain takes no gray input
        p.send_signal(signal.SIGTERM)
        assert p.wait(TIMEOUT_S) == 0
        reader.join(TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    log = "".join(lines)
    assert "graceful drain" in log and "serve shutdown: served 1/2" in log
    rec = json.loads(metrics.read_text())
    assert rec["event"] == "serve" and rec["completed"] == 1 and rec["rejected"] == 1
    assert rec["health"]["state"] == "stopped"
    assert os.listdir(tmp_path / "rec")  # the drain's recorder dump


@pytest.mark.parametrize("argv,reason", [
    (["--impl", "cuda"], "bucket border"),
    (["--impl", "swar"], "bucket border"),
    (["--replicas", "2", "--impl", "cuda"], "bucket border"),
])
def test_cli_serve_refusals_exit_nonzero_with_reason(argv, reason, capsys):
    assert cli.main(["serve", "--device", "cpu", "--port", "0", *argv]) == 2
    assert reason in capsys.readouterr().err


def test_cli_serve_defaults_to_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["serve", "--port", "0", "--buckets", "32"]) == 2
    assert "cuda" in capsys.readouterr().err
