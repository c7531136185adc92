"""The port's pipeline service over HTTP on the CPU: the twin of the JAX
package's test_http_pipeline_service_end_to_end through the port's
``Server`` on port 0 (registration, tenant configuration, pipeline-tagged
/v1/process with the side outputs in headers, the taxonomy's 404/422, a
quota shed, the mcim_graph_* families), a systolic relay between two port
servers (the test sends the placement header itself), POST
/control/profile with its 429, the multi-tenant load generator's lane
(the twin of the JAX package's graph_loadgen lane test), and CLI ``graph
--device cpu`` in a subprocess. Every image is held to the JAX package's
graph_callable under ``jax.jit`` on the same seeded input.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu import graph as jgraph
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import HDR_PLAN, encode_placement
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import profile as obs_profile
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig, Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
OPS = "grayscale,contrast:3.5"

UNSHARP_SPEC = {
    "version": 1,
    "name": "unsharp",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "g", "kind": "op", "op": "grayscale", "input": "src"},
        {"id": "blur", "kind": "op", "op": "gaussian:5", "input": "g"},
        {"id": "mask", "kind": "merge", "merge": "subtract", "inputs": ["g", "blur"]},
    ],
    "outputs": {"image": "mask", "histogram": "mask", "stats": "mask"},
}


def _post(base, path, data, headers=None):
    req = urllib.request.Request(base + path, data=data, headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _jax_graph(spec, img):
    fn = jax.jit(jgraph.graph_callable(jgraph.compile_graph(jgraph.parse_spec(spec))))
    return jax.tree_util.tree_map(np.asarray, fn(img))


def _server(**kw):
    cfg = ServeConfig(ops=OPS, buckets=((48, 48),), channels=(3,), max_batch=2, device="cpu",
                      **kw)
    return Server(cfg, host="127.0.0.1", port=0)


def _register(base, tenant, spec):
    code, _, out = _post(base, "/v1/pipelines",
                         json.dumps({"tenant": tenant, "spec": spec}).encode())
    assert code == 200, out
    return json.loads(out)


def test_http_pipeline_service_end_to_end():
    img = synthetic_image(33, 40, channels=3, seed=5)
    blob = encode_image_bytes(img)
    unsharp = _jax_graph(UNSHARP_SPEC, img)
    with _server() as srv:
        base = f"http://127.0.0.1:{srv.address[1]}"
        reg = _register(base, "acme", chain_as_spec(OPS))
        pid = reg["pipeline"]
        assert pid == jgraph.dag_fingerprint(jgraph.parse_spec(chain_as_spec(OPS)))
        assert reg["linear_chain"] == "grayscale,contrast3.5"
        # degenerate linear DAG: byte-identical to the chain door and JAX
        c1, _, chain_png = _post(base, "/v1/process", blob)
        c2, _, dag_png = _post(base, "/v1/process", blob,
                               {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid})
        assert (c1, c2) == (200, 200)
        assert chain_png == dag_png
        np.testing.assert_array_equal(decode_image_bytes(dag_png),
                                      np.asarray(JaxPipeline.parse(OPS).jit()(img)))
        # side outputs in ONE dispatch (headers ride the PNG response)
        upid = _register(base, "acme", UNSHARP_SPEC)["pipeline"]
        c3, h3, png3 = _post(base, f"/v1/process?tenant=acme&pipeline={upid}", blob)
        assert c3 == 200
        im3 = decode_image_bytes(png3)
        np.testing.assert_array_equal(im3, unsharp["image"])
        assert json.loads(h3["X-MCIM-Histogram"]) == [int(v) for v in unsharp["histogram"]]
        stats = json.loads(h3["X-MCIM-Stats"])
        assert stats == {"count": int(unsharp["stats"]["count"]),
                         "min": int(unsharp["stats"]["min"]),
                         "max": int(unsharp["stats"]["max"]),
                         "mean": round(float(unsharp["stats"]["mean"]), 4)}
        # the registry view
        with urllib.request.urlopen(base + "/v1/pipelines", timeout=TIMEOUT_S) as r:
            view = json.loads(r.read())
        assert sorted(view["tenants"]["acme"]["pipelines"]) == sorted([pid, upid])
        # unknown pipeline / tenant: structured 404 with the taxonomy code
        c4, _, out4 = _post(base, "/v1/process", blob,
                            {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": "dag-0000000000000000"})
        assert c4 == 404 and json.loads(out4)["code"] == "unknown-pipeline"
        c5, _, out5 = _post(base, "/v1/process", blob,
                            {"X-MCIM-Tenant": "nobody", "X-MCIM-Pipeline": pid})
        assert c5 == 404 and json.loads(out5)["code"] == "unknown-tenant"
        # malformed spec / body / image: 4xx + code, never 500
        for body, want in ((json.dumps({"tenant": "acme", "spec": {"version": 1}}).encode(),
                            (422, "bad-nodes")),
                           (b"{not json", (400, "bad-json")),
                           (b"[1]", (422, "bad-root"))):
            c, _, out = _post(base, "/v1/pipelines", body)
            assert (c, json.loads(out)["code"]) == want
        c, _, out = _post(base, "/v1/process", b"not an image",
                          {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid})
        assert c == 400 and json.loads(out)["code"] == "bad-image"
        c, _, out = _post(base, "/v1/tenants", json.dumps({"tenant": "t", "qos": "gold"}).encode())
        assert c == 422 and json.loads(out)["code"] == "bad-qos"
        # quota exhaustion: 503 + Retry-After, counted as shed
        c, _, out = _post(base, "/v1/tenants", json.dumps(
            {"tenant": "smol", "qos": "batch", "quota_requests": 1, "window_s": 300.0}).encode())
        assert c == 200 and json.loads(out)["window_s"] == 300.0
        _register(base, "smol", chain_as_spec(OPS))
        smol = {"X-MCIM-Tenant": "smol", "X-MCIM-Pipeline": pid}
        c7a, _, _ = _post(base, "/v1/process", blob, smol)
        c7b, h7b, _ = _post(base, "/v1/process", blob, smol)
        assert (c7a, c7b) == (200, 503)
        assert int(h7b["Retry-After"]) >= 1
        svc = srv.app.graph_service
        assert svc._m_requests.value(status="shed") == 1
        assert svc._m_shed.value(reason="quota") == 1
        assert svc._m_coalesced.value(outcome="batched") >= 3  # the group lane answered
        with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT_S) as r:
            fams = parse_exposition(r.read().decode())
        for fam in ("mcim_graph_requests_total", "mcim_graph_rejections_total",
                    "mcim_graph_pipelines", "mcim_graph_dispatch_seconds",
                    "mcim_graph_compiles_total", "mcim_systolic_tiles_forwarded_total"):
            assert fam in fams, fam
        with urllib.request.urlopen(base + "/stats", timeout=TIMEOUT_S) as r:
            stats = json.loads(r.read())
        assert stats["graph"]["tenants"]["smol"]["shed"] == 1
        assert stats["graph"]["device"] == "cpu"


def test_systolic_relay_between_two_servers():
    """Two port servers with systolic on: the test POSTs to the stage-0
    owner with the placement header (the placing front door's part), the
    owner runs its range and forwards the live env to the second server's
    /v1/systolic, and the relayed answer (image + side outputs) equals a
    solo dispatch and the JAX package's bytes. Each boundary is one
    forward; a broken hop answers 424."""
    spec = {**UNSHARP_SPEC, "nodes": UNSHARP_SPEC["nodes"][:3] + [
        {"id": "sharp", "kind": "op", "op": "sharpen", "input": "blur"},
        {"id": "mask", "kind": "merge", "merge": "subtract", "inputs": ["g", "sharp"]}]}
    img = synthetic_image(40, 36, channels=3, seed=7)
    blob = encode_image_bytes(img)
    want = _jax_graph(spec, img)
    with _server(systolic=True) as a, _server(systolic=True) as b:
        addrs = [f"127.0.0.1:{a.address[1]}", f"127.0.0.1:{b.address[1]}"]
        pid = _register("http://" + addrs[0], "acme", spec)["pipeline"]
        assert _register("http://" + addrs[1], "acme", spec)["pipeline"] == pid
        hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}
        c0, h0, solo = _post("http://" + addrs[0], "/v1/process", blob, hdrs)
        assert c0 == 200
        for ranges in (((0, 2), (2, 4)), ((0, 1), (1, 4)), ((0, 3), (3, 4))):
            hdr = encode_placement(tenant="acme", pipeline=pid, ranges=ranges, addrs=addrs,
                                   trace_id="")
            c, h, relayed = _post("http://" + addrs[0], "/v1/process", blob,
                                  {**hdrs, HDR_PLAN: hdr})
            assert c == 200, relayed
            assert relayed == solo
            np.testing.assert_array_equal(decode_image_bytes(relayed), want["image"])
            assert h["X-MCIM-Histogram"] == h0["X-MCIM-Histogram"]
            assert h["X-MCIM-Stats"] == h0["X-MCIM-Stats"]
        fwd = a.app.graph_service._m_sys_tiles.value()
        assert fwd == 3 and a.app.graph_service._m_sys_bytes.value() > 0
        assert b.app.graph_service._m_sys_tiles.value() == 0
        # a dead next owner: 424 systolic-broken, never a wrong answer
        hdr = encode_placement(tenant="acme", pipeline=pid, ranges=((0, 2), (2, 4)),
                               addrs=[addrs[0], "127.0.0.1:1"], trace_id="")
        c, _, out = _post("http://" + addrs[0], "/v1/process", blob, {**hdrs, HDR_PLAN: hdr})
        assert c == 424 and json.loads(out)["status"] == "systolic-broken"
        # a garbled frame at a hop is a 400, a garbled header a taxonomy 400
        c, _, out = _post("http://" + addrs[1], "/v1/systolic", b"garbage")
        assert c == 400 and json.loads(out)["code"] == "bad-json"
        c, _, out = _post("http://" + addrs[0], "/v1/process", blob, {**hdrs, HDR_PLAN: "{}"})
        assert c == 400 and json.loads(out)["code"] == "bad-json"


def test_control_profile_captures_and_rate_limits(tmp_path, monkeypatch):
    """POST /control/profile: a torch.profiler capture while the chain lane
    takes requests on other threads, its merged artifact and summary in
    the answer; a second call inside the rate limit answers 429 with
    Retry-After."""
    monkeypatch.setenv("MCIM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("MCIM_PROFILE_MIN_INTERVAL_S", "60")
    monkeypatch.setattr(obs_profile, "_last_capture_ts", 0.0)
    import threading

    img = encode_image_bytes(synthetic_image(30, 40, channels=3, seed=9))
    with _server() as srv:
        base = f"http://127.0.0.1:{srv.address[1]}"
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                _post(base, "/v1/process", img)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            c, _, out = _post(base, "/control/profile", json.dumps({"seconds": 1.0}).encode())
        finally:
            stop.set()
            t.join(TIMEOUT_S)
        assert c == 200, out
        res = json.loads(out)
        assert res["status"] == "ok" and res["seconds"] == pytest.approx(1.0)
        assert res["device_events"] > 0
        assert os.path.isfile(res["artifact"])
        assert res["artifact"].startswith(str(tmp_path))
        names = {e["name"] for e in res["summary"]["top_events"]}
        assert any(n.startswith("aten::") for n in names)  # the serving threads' operators
        c, h, out = _post(base, "/control/profile", b"{}")
        assert c == 429 and int(h["Retry-After"]) >= 1
        assert json.loads(out)["status"] == "unavailable"


def test_multi_tenant_loadgen_lane_gate_and_columns():
    """The graph_loadgen lane at a tiny scale: a chain lane and a DAG lane
    (the same pipeline as a linear spec) for two tenants over one arrival
    clock; every ok response byte-equal to the chain golden (the gate),
    per-tenant ok/shed/p99 columns, no unavailability."""
    imgs = [synthetic_image(20 + k, 30, channels=3, seed=k) for k in range(3)]
    blobs = [loadgen.encode_blob(im) for im in imgs]
    golden = [np.asarray(JaxPipeline.parse(OPS).jit()(im)) for im in imgs]
    with _server() as srv:
        base = f"http://127.0.0.1:{srv.address[1]}"
        lanes = [{"tenant": "chain", "blobs": blobs, "headers": {"X-MCIM-Tenant": "chain"}}]
        for t in ("t0", "t1"):
            pid = _register(base, t, chain_as_spec(OPS))["pipeline"]
            lanes.append({"tenant": t, "blobs": blobs,
                          "headers": {"X-MCIM-Tenant": t, "X-MCIM-Pipeline": pid}})
        rec = loadgen.multi_tenant_run(base, lanes, 60.0, 0.5, timeout_s=TIMEOUT_S,
                                       jitter_frac=0.3, seed=1)
    assert set(rec) == {"chain", "t0", "t1"}
    for tenant, r in rec.items():
        assert r["submitted"] > 0 and r["unavailable"] == 0, tenant
        assert "ok_frac" in r and "shed_frac" in r and "e2e_p99_ms" in r
        assert r["ok"] == r["submitted"]
        for k, res in r["results"]:
            np.testing.assert_array_equal(decode_image_bytes(res["body"]), golden[k])


def _cli(args, timeout=TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch",
                           "graph", *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_graph_device_cpu(tmp_path):
    """`graph --device cpu` in subprocesses: --validate-only prints the
    structure and the JAX package's pipeline id; a run writes the image,
    histogram and stats (each equal to the JAX package's on the same
    synthetic image) and the JSON record; a refusal prints its taxonomy
    code and exits 2."""
    spec = tmp_path / "unsharp.json"
    spec.write_text(json.dumps(UNSHARP_SPEC))
    pid = jgraph.dag_fingerprint(jgraph.parse_spec(UNSHARP_SPEC))
    r = _cli(["--spec", str(spec), "--validate-only"])
    assert r.returncode == 0, r.stderr
    assert f"pipeline id: {pid}" in r.stdout and "merge mask <- g subtract blur" in r.stdout
    out, hist, stats = tmp_path / "o.png", tmp_path / "h.json", tmp_path / "s.json"
    r = _cli(["--spec", str(spec), "--synthetic", "40x48x3", "--device", "cpu", "--output",
              str(out), "--histogram-out", str(hist), "--stats-out", str(stats),
              "--json-metrics", "-"])
    assert r.returncode == 0, r.stderr
    want = _jax_graph(UNSHARP_SPEC, synthetic_image(40, 48, channels=3, seed=0))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out)), want["image"])
    assert json.loads(hist.read_text()) == [int(v) for v in want["histogram"]]
    assert json.loads(stats.read_text())["mean"] == round(float(want["stats"]["mean"]), 4)
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["event"] == "graph" and rec["pipeline_id"] == pid and rec["device"] == "cpu"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "nodes": []}))
    r = _cli(["--spec", str(bad), "--validate-only"])
    assert r.returncode == 2 and "spec rejected [bad-nodes]" in r.stderr
    from mpi_cuda_imagemanipulation_tpu_torch import cli

    if not torch.cuda.is_available():  # the default device is cuda: refused
        assert cli.main(["graph", "--spec", str(spec), "--synthetic", "8x8x3"]) == 2
