"""Open-loop load generator: throughput vs latency under offered load.
The counterpart of the JAX package's ``serve/loadgen.py`` (jax-free there;
copied, with the imports pointed at the port).

Open-loop means arrivals are scheduled by the offered rate alone, never
gated on completions (a closed loop self-throttles and hides queueing
collapse: the coordinated-omission trap). `Client.submit` is non-blocking
by construction, so one thread fires requests on the arrival clock and the
handles are collected afterwards; shed requests resolve at once and count
against goodput.

`sweep()` reports, per offered rate, achieved throughput, p50/p95/p99
end-to-end latency, mean batch occupancy and shed fraction: the saturation
curve that sizes `--max-batch`/`--queue-depth` for a deployment.

`fault_rate` arms the `serve.dispatch` failpoint for the sweep, so the
records also report AVAILABILITY under injected transient faults: success
%, shed %, retried %, quarantined.

The HTTP generator (`http_run_offered_load`) fires the same open-loop clock
at `POST /v1/process` through a worker pool; `summarize_http_results`
keeps a 503 with Retry-After (an explicit shed, "come back later") apart
from unavailability (transport failures, a bare 503). `multi_tenant_run`
fires one such clock round-robin over tenant lanes (the pipeline
service's quota and QoS ladder act on each lane's slice) and reports per
tenant.

The churn mode (`churn_run`) drives the serving fabric over HTTP: the same
open-loop clock fires at the fabric router, a replica is SIGKILLed
mid-sweep, and the record reports ok% / retried% (router rerouting, from
the X-Fabric-Attempts response header) / p99 for the before, during and
after phases: availability under churn as three numbers.

With tracing armed (obs/trace.py, e.g. MCIM_TRACE_SAMPLE=1) every request
carries a trace id and each per-rate record names its slowest completions
(`slowest_traces`) and failures (`failed_traces`) by id.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import Client, ServeApp
from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import percentiles

PERCENTILES = (50, 95, 99)


def mixed_shapes(
    buckets, n: int, *, channels: int = 3, seed: int = 0, min_dim: int = 8
) -> list[np.ndarray]:
    """Deterministic request mix: for each bucket, one exact-fit image plus
    off-bucket sizes that exercise the padding path."""
    rng = np.random.default_rng(seed)
    shapes: list[tuple[int, int]] = []
    for bh, bw in buckets:
        shapes.append((bh, bw))
        shapes.append((max(min_dim, bh - 7), max(min_dim, bw - 13)))
        shapes.append((max(min_dim, (bh * 3) // 4), max(min_dim, (bw * 2) // 3)))
    out = []
    for i in range(n):
        h, w = shapes[int(rng.integers(len(shapes)))]
        out.append(
            synthetic_image(h, w, channels=channels, seed=int(rng.integers(1 << 31)))
        )
    return out


def run_offered_load(
    client: Client,
    images: list[np.ndarray],
    offered_rps: float,
    duration_s: float,
    *,
    clock=time.monotonic,
    sleep=time.sleep,
) -> dict:
    """Fire requests open-loop at `offered_rps` for `duration_s`; block for
    stragglers; return the per-rate record."""
    period = 1.0 / offered_rps
    t0 = clock()
    handles = []
    i = 0
    while True:
        due = t0 + i * period
        now = clock()
        if due - t0 >= duration_s:
            break
        if due > now:
            sleep(due - now)
        handles.append(client.submit(images[i % len(images)]))
        i += 1
    for h in handles:
        h.done.wait()
    wall = clock() - t0
    ok = [h for h in handles if h.status == "ok"]
    shed = sum(1 for h in handles if h.status == "overloaded")
    quarantined = sum(1 for h in handles if h.status == "quarantined")
    lat = [h.t_done - h.t_submit for h in ok]
    n = len(handles)
    rec = {
        "offered_rps": offered_rps,
        "submitted": n,
        "completed": len(ok),
        "shed": shed,
        "shed_frac": shed / n if n else 0.0,
        "quarantined": quarantined,
        # availability: the fraction of offered load that got a good
        # answer (shed is an explicit no, quarantined/error a failure)
        "ok_frac": len(ok) / n if n else 0.0,
        "achieved_rps": len(ok) / wall if wall > 0 else 0.0,
        "wall_s": wall,
    }
    if lat:
        p = percentiles(lat, PERCENTILES)
        rec.update({f"e2e_p{int(q)}_ms": p[q] * 1e3 for q in PERCENTILES})
        # tail attribution (obs/trace.py): when tracing is armed each
        # request carried a trace id — record the slowest completions so
        # a p99 outlier can be pulled up BY ID in the --trace-out file
        # instead of eyeballing the whole timeline. Under sampled
        # tracing with tail keep, ids that actually RESOLVE in the
        # export (sampled-in or tail-promoted) rank ahead of
        # provisional ids the tracer dropped — a slow-trace column full
        # of unresolvable ids is the old blind spot in a new shape.
        slowest = sorted(
            (h for h in ok if h.trace_id),
            key=lambda h: (
                not obs_trace.trace_kept(h.trace_id),
                -(h.t_done - h.t_submit),
            ),
        )[:3]
        if slowest:
            rec["slowest_traces"] = [
                {
                    "trace_id": h.trace_id,
                    "e2e_ms": (h.t_done - h.t_submit) * 1e3,
                    "kept": obs_trace.trace_kept(h.trace_id),
                }
                for h in slowest
            ]
        failed_ids = [
            {"trace_id": h.trace_id, "status": h.status}
            for h in handles
            if h.trace_id and h.status not in ("ok", "overloaded")
        ]
        if failed_ids:
            rec["failed_traces"] = failed_ids[:10]
    return rec


# --------------------------------------------------------------------------
# HTTP loadgen (the front door)
# --------------------------------------------------------------------------


def encode_blob(img: np.ndarray) -> memoryview:
    """Single-copy request blob: the PNG encoder writes into ONE buffer
    (`io.image.encode_image_into`) and the HTTP client posts a view of
    it — the full byte string is never duplicated. The streamed outputs'
    incremental encoder (io/stream_codec.PNGTileWriter over a BytesIO)
    hands its buffer through the same path, so a stream-produced frame
    costs one resident copy end to end."""
    import io as _io

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import encode_image_into

    buf = _io.BytesIO()
    encode_image_into(img, buf)
    return buf.getbuffer()


def http_post_image(
    url: str,
    blob: bytes | bytearray | memoryview,
    *,
    timeout_s: float = 30.0,
    headers: dict | None = None,
) -> dict:
    """One `POST /v1/process` against a front door (router or replica).
    `blob` is any bytes-like body (memoryviews from `encode_blob` / the
    incremental stream encoder post without a defensive copy). Returns
    {code, body, attempts, replica, trace_id, retry_after, e2e_s};
    transport errors surface as code 599 so open-loop accounting never
    raises. `retry_after` carries the server's Retry-After header — the
    router's explicit shed-and-retry-later signal, which the accounting
    layer must keep distinct from real unavailability. `headers` adds
    request headers — the multi-tenant lanes ride tenant + pipeline
    identity (X-MCIM-Tenant / X-MCIM-Pipeline) through here."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url.rstrip("/") + "/v1/process",
        data=blob,
        headers={
            "Content-Type": "application/octet-stream",
            **(headers or {}),
        },
        method="POST",
    )
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = resp.read()
            code = resp.status
            hdrs = resp.headers
    except urllib.error.HTTPError as e:
        body = e.read()
        code = e.code
        hdrs = e.headers
    except Exception:
        # connection refused/reset mid-churn: a transport-level failure,
        # distinct from any server-sent status
        return {
            "code": 599, "body": b"", "attempts": 1, "replica": "",
            "trace_id": "", "retry_after": "",
            "e2e_s": time.monotonic() - t0,
        }
    return {
        "code": code,
        "body": body,
        "attempts": int(hdrs.get("X-Fabric-Attempts", "1") or 1),
        "replica": hdrs.get("X-Fabric-Replica", ""),
        "trace_id": hdrs.get("X-Trace-Id", ""),
        "retry_after": hdrs.get("Retry-After", ""),
        "e2e_s": time.monotonic() - t0,
    }


def http_run_offered_load(
    url: str,
    blobs: list[bytes | bytearray | memoryview],
    offered_rps: float,
    duration_s: float,
    *,
    timeout_s: float = 30.0,
    max_workers: int = 32,
    clock=time.monotonic,
    sleep=time.sleep,
    headers: dict | None = None,
    deadline_ms: float | None = None,
) -> dict:
    """The open-loop generator over HTTP: arrivals on the offered clock via a
    worker pool, collection afterwards (same discipline as
    `run_offered_load` — completions never gate arrivals). Returns the
    phase record plus `results`: [(blob_index, response dict), ...] so the
    caller can verify successes bit-exactly against golden outputs.
    `headers` rides every request (e.g. the X-MCIM-Deadline-Ms budget the
    chaos lane sets); `deadline_ms` additionally feeds the summary's
    goodput-within-deadline column."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi_cuda_imagemanipulation_tpu_torch.resilience import (
        deadline as deadline_mod,
    )

    if deadline_ms is not None:
        headers = {
            **(headers or {}),
            deadline_mod.HEADER: f"{deadline_ms:.1f}",
        }
    period = 1.0 / offered_rps
    futures = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        t0 = clock()
        i = 0
        while True:
            due = t0 + i * period
            now = clock()
            if due - t0 >= duration_s:
                break
            if due > now:
                sleep(due - now)
            k = i % len(blobs)
            futures.append(
                (k, pool.submit(http_post_image, url, blobs[k],
                                timeout_s=timeout_s, headers=headers))
            )
            i += 1
        results = [(k, f.result()) for k, f in futures]
        wall = clock() - t0
    rec = summarize_http_results(
        results, wall, offered_rps, deadline_ms=deadline_ms
    )
    rec["results"] = results
    return rec


def summarize_http_results(
    results: list[tuple[int, dict]], wall: float, offered_rps: float,
    *, deadline_ms: float | None = None,
) -> dict:
    """The shared HTTP open-loop accounting: one phase/lane record from
    [(blob_index, response dict), ...]. A 503 WITH Retry-After is an
    explicit shed — "come back later", the intended behavior under
    quota/QoS/elastic pressure — and must not be folded into
    unavailability (the 599/bare-503 failure class): a lane that counts
    intentional shedding as downtime would misread admission control
    doing its job as the pod losing traffic. A 504 is a deadline miss
    (`deadline_expired`) — its own class, NOT unavailability: the stack
    refusing doomed work is the deadline chain doing its job. `accepted`
    is the offered load the pod actually took on; `ok_accepted_frac` is
    goodput over it (the elastic/tenant acceptance criteria gate on it
    at 100%). With `deadline_ms` set, `ok_in_deadline` / `goodput_rps`
    count only the 200s that ALSO landed within the client's budget —
    the chaos/elastic lanes' real goodput."""
    ok = [r for _, r in results if r["code"] == 200]
    retried = sum(1 for _, r in results if r["attempts"] > 1)
    shed = sum(
        1
        for _, r in results
        if r["code"] == 503 and r.get("retry_after")
    )
    overloaded = sum(1 for _, r in results if r["code"] == 429)
    deadline_expired = sum(1 for _, r in results if r["code"] == 504)
    n = len(results)
    # a deadline-expired request was REFUSED (the stack declined doomed
    # work), not taken on — it leaves `accepted` like a shed does
    accepted = n - shed - overloaded - deadline_expired
    lat = [r["e2e_s"] for r in ok]
    ok_in_deadline = (
        sum(1 for r in ok if r["e2e_s"] * 1e3 <= deadline_ms)
        if deadline_ms is not None
        else len(ok)
    )
    rec = {
        "offered_rps": offered_rps,
        "submitted": n,
        "ok": len(ok),
        "ok_frac": len(ok) / n if n else 0.0,
        "accepted": accepted,
        "ok_accepted_frac": len(ok) / accepted if accepted else 1.0,
        "retried": retried,
        "retried_frac": retried / n if n else 0.0,
        "shed": shed,
        "shed_frac": shed / n if n else 0.0,
        "deadline_expired": deadline_expired,
        "ok_in_deadline": ok_in_deadline,
        "goodput_rps": ok_in_deadline / wall if wall > 0 else 0.0,
        "unavailable": sum(
            1
            for _, r in results
            if r["code"] == 599
            or (r["code"] == 503 and not r.get("retry_after"))
        ),
        "overloaded": overloaded,
        "achieved_rps": len(ok) / wall if wall > 0 else 0.0,
        "wall_s": wall,
    }
    if lat:
        p = percentiles(lat, PERCENTILES)
        rec.update({f"e2e_p{int(q)}_ms": p[q] * 1e3 for q in PERCENTILES})
    return rec


def multi_tenant_run(
    url: str,
    lanes: list[dict],
    offered_rps: float,
    duration_s: float,
    *,
    timeout_s: float = 30.0,
    max_workers: int = 32,
    clock=time.monotonic,
    sleep=time.sleep,
    jitter_frac: float = 0.0,
    seed: int = 0,
) -> dict:
    """The multi-tenant offered-load mix: ONE open-loop arrival clock at
    `offered_rps` total, arrivals round-robined across the tenant lanes,
    per-tenant accounting out. Each lane is

        {"tenant": <id>, "blobs": [...], "headers": {...}}

    where `headers` carries the lane's identity (X-MCIM-Tenant, and
    X-MCIM-Pipeline for graph lanes), so each tenant's quota window and
    QoS class act on exactly its slice of the offered load. With
    `jitter_frac` > 0 each arrival moves by up to that fraction of the
    period either way, drawn from a generator seeded with `seed` (0, the
    default, is the JAX package's exact clock). Returns {tenant: phase
    record} with the shared shed-vs-unavailable accounting per tenant,
    each record with its `results` ([(blob index, response)], in arrival
    order) for the caller's byte checks."""
    from concurrent.futures import ThreadPoolExecutor

    period = 1.0 / offered_rps
    rng = np.random.default_rng(seed)
    futures: list[tuple[str, int, object]] = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        t0 = clock()
        i = 0
        while True:
            due = t0 + i * period
            if due - t0 >= duration_s:
                break
            if jitter_frac:
                due += float(rng.uniform(-jitter_frac, jitter_frac)) * period
            now = clock()
            if due > now:
                sleep(due - now)
            lane = lanes[i % len(lanes)]
            blobs = lane["blobs"]
            k = (i // len(lanes)) % len(blobs)
            futures.append((lane["tenant"], k, pool.submit(
                http_post_image, url, blobs[k], timeout_s=timeout_s,
                headers=lane.get("headers"),
            )))
            i += 1
        by_tenant: dict[str, list[tuple[int, dict]]] = {lane["tenant"]: [] for lane in lanes}
        for tenant, k, f in futures:
            by_tenant[tenant].append((k, f.result()))
        wall = clock() - t0
    share = offered_rps / len(lanes)
    out = {}
    for tenant, results in by_tenant.items():
        out[tenant] = summarize_http_results(results, wall, share)
        out[tenant]["results"] = results
    return out


def sweep(
    app: ServeApp,
    *,
    offered_rps: tuple[float, ...],
    duration_s: float = 2.0,
    n_images: int = 64,
    channels: int = 3,
    seed: int = 7,
    fault_rate: float = 0.0,
    fault_seed: int = 7,
) -> list[dict]:
    """The offered-load sweep over a STARTED app. Dispatch metrics (batch
    occupancy, retries) are read as per-rate deltas of the app-wide
    counters. `fault_rate > 0` arms the `serve.dispatch` failpoint for the
    whole sweep (cleared on exit), so the lane measures availability under
    injected transient dispatch failures."""
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim

    client = Client(app)
    images = mixed_shapes(
        app.cache.buckets,
        n_images,
        channels=channels,
        seed=seed,
        min_dim=min_true_dim(app.pipe),
    )
    if fault_rate > 0.0:
        failpoints.configure(
            f"serve.dispatch={fault_rate}", seed=fault_seed
        )
    records = []
    try:
        for rps in offered_rps:
            before = app.metrics.snapshot()
            rec = run_offered_load(client, images, rps, duration_s)
            after = app.metrics.snapshot()
            d_real = (after["dispatches"] or 0) - (before["dispatches"] or 0)
            if d_real:
                done = after["completed"] - before["completed"]
                rec["mean_batch_occupancy"] = done / d_real
            rec["dispatches"] = d_real
            rec["retried"] = after["retries"] - before["retries"]
            rec["retried_frac"] = (
                rec["retried"] / rec["submitted"] if rec["submitted"] else 0.0
            )
            rec["degraded"] = after["degraded"] - before["degraded"]
            # the p99's exemplar trace id (histogram bucket exemplars) —
            # printed next to the percentile in the lane table, so the
            # outlier links to its --trace-out spans without eyeballing
            ex = app.metrics.e2e_exemplar(99)
            if ex is not None:
                rec["p99_exemplar"] = ex
            if fault_rate > 0.0:
                rec["fault_rate"] = fault_rate
            records.append(rec)
    finally:
        if fault_rate > 0.0:
            failpoints.clear()
    return records


def churn_run(
    url: str,
    blobs: list[bytes],
    *,
    offered_rps: float,
    phase_s: float,
    kill,
    before_after=None,
    timeout_s: float = 30.0,
) -> dict:
    """Availability under churn, in three measured phases:

        before   steady state, every replica up
        during   `kill()` fires at the phase midpoint (SIGKILL one
                 replica) while the offered load keeps arriving: the
                 in-flight forwards to the dead replica must resolve via
                 router rerouting, not hang or error
        after    `before_after()` (e.g. wait for the supervisor restart
                 to rejoin) runs first, then steady state again

    Each phase reports ok% / retried% / p99; `results` ride along for
    byte-exactness checks. During-phase ok_frac stays 1.0 when rerouting
    works."""
    phases: dict[str, dict] = {}
    phases["before"] = http_run_offered_load(url, blobs, offered_rps, phase_s, timeout_s=timeout_s)
    killer = threading.Timer(phase_s / 2.0, kill)
    killer.start()
    try:
        phases["during"] = http_run_offered_load(
            url, blobs, offered_rps, phase_s, timeout_s=timeout_s)
    finally:
        killer.cancel()  # no-op if it already fired
        killer.join()
    if before_after is not None:
        before_after()
    phases["after"] = http_run_offered_load(url, blobs, offered_rps, phase_s, timeout_s=timeout_s)
    return phases
