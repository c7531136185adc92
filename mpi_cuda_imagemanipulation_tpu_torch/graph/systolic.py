"""Replica-level systolic execution: the wire protocol and the closed
fallback vocabulary. The counterpart of the JAX package's
``graph/systolic.py`` (json + numpy only; the port keeps its own copy, so
that a port replica and a JAX replica agree on the wire byte for byte).

The replica form of parallel/systolic.py: instead of slots of one mesh,
the stage owners are REPLICAS, and the band copy is an HTTP hop
replica-to-replica carrying the live environment slice at a step cut. The
fabric router (fabric/router.py) computes a `graph.compile.place_steps`
placement and forwards the request to the stage-0 owner with the placement map in a
header; each owner runs its contiguous step range (`graph_sub_callable`)
then forwards the live env to the next owner's ``/v1/systolic``
endpoint. The final owner renders the response (PNG + side-output
headers) and the reply chains back up through the nested forwards, so
the transport-forward count is structurally one per stage boundary.

Byte-exactness across the hop is free: env values are u8 arrays (the
graph IR materializes u8 at every step boundary), serialised raw; there
is no float in flight, so the handoff cannot perturb anything.
"""

from __future__ import annotations

import io
import json

import numpy as np

# ---------------------------------------------------------------------------
# Closed vocabularies + env/header surface
# ---------------------------------------------------------------------------

# Why a request fell back to the pinned-replica lane (never a wrong
# answer: the fallback IS the correct result, just not stage-sharded).
# Closed vocabulary: every count_fallback() call site passes a literal
# member, so dashboards can enumerate reasons without scraping live series.
#   off            systolic mode disabled (knob accounting: every graph
#                  request is attributed to exactly one lane)
#   replicas       fewer than 2 systolic-advertising routable replicas
#   ineligible     program not stage-shardable (placement returned None:
#                  too few steps, or non-streamable structure)
#   owner_down     forward to the stage-0 owner failed (death/drain
#                  between placement and dispatch)
#   forward_failed an inter-stage hop failed mid-chain (the owner
#                  answered 424 systolic-broken)
FALLBACK_REASONS = (
    "off",
    "replicas",
    "ineligible",
    "owner_down",
    "forward_failed",
)

ENV_SYSTOLIC = "MCIM_SYSTOLIC"
ENV_MIN_STEPS = "MCIM_SYSTOLIC_MIN_STEPS"

HDR_PLAN = "X-MCIM-Systolic-Plan"
SYSTOLIC_PATH = "/v1/systolic"


def count_fallback(counter, reason: str) -> None:
    """The one choke point for fallback accounting: raises on a reason
    outside the closed vocabulary, so a typo becomes a loud failure, not
    an unbounded label set."""
    if reason not in FALLBACK_REASONS:
        raise ValueError(
            f"unknown systolic fallback reason {reason!r}; "
            f"known: {FALLBACK_REASONS}"
        )
    counter.inc(reason=reason)


# ---------------------------------------------------------------------------
# Placement wire form (placing front door -> stage-0 owner, in HDR_PLAN)
# ---------------------------------------------------------------------------


def encode_placement(
    *,
    tenant: str,
    pipeline: str,
    ranges,
    addrs,
    trace_id: str,
) -> str:
    """The placement map as a compact JSON header value: step ranges in
    topo order and the owner base URL for each range (index k owns
    ranges[k]). Single-line by construction (headers)."""
    return json.dumps(
        {
            "tenant": tenant,
            "pipeline": pipeline,
            "ranges": [[int(lo), int(hi)] for lo, hi in ranges],
            "addrs": list(addrs),
            "trace_id": trace_id,
        },
        separators=(",", ":"),
    )


def decode_placement(header: str) -> dict:
    d = json.loads(header)
    for field in ("tenant", "pipeline", "ranges", "addrs", "trace_id"):
        if field not in d:
            raise ValueError(f"systolic placement missing {field!r}")
    if len(d["ranges"]) != len(d["addrs"]):
        raise ValueError("systolic placement ranges/addrs length mismatch")
    d["ranges"] = [(int(lo), int(hi)) for lo, hi in d["ranges"]]
    return d


# ---------------------------------------------------------------------------
# Inter-stage handoff wire form (owner k -> owner k+1, POST body)
# ---------------------------------------------------------------------------


def encode_handoff(meta: dict, env: dict) -> bytes:
    """One self-describing frame: a JSON header line {meta, arrays:
    [{key, shape, dtype}, ...]} then the raw array bytes concatenated in
    header order. u8 env values ride byte for byte (exactness needs no
    float discipline on the wire: there are no floats)."""
    arrays = []
    bufs = []
    for key in sorted(env):
        a = np.ascontiguousarray(env[key])
        arrays.append(
            {"key": key, "shape": list(a.shape), "dtype": str(a.dtype)}
        )
        bufs.append(a.tobytes())
    head = json.dumps(
        {"meta": meta, "arrays": arrays}, separators=(",", ":")
    ).encode("utf-8")
    out = io.BytesIO()
    out.write(head)
    out.write(b"\n")
    for b in bufs:
        out.write(b)
    return out.getvalue()


def decode_handoff(body: bytes) -> tuple[dict, dict]:
    """Inverse of encode_handoff -> (meta, env of np arrays)."""
    nl = body.find(b"\n")
    if nl < 0:
        raise ValueError("systolic handoff missing header line")
    head = json.loads(body[:nl].decode("utf-8"))
    meta = head.get("meta")
    arrays = head.get("arrays")
    if not isinstance(meta, dict) or not isinstance(arrays, list):
        raise ValueError("systolic handoff header malformed")
    env = {}
    off = nl + 1
    for spec in arrays:
        shape = tuple(int(s) for s in spec["shape"])
        dtype = np.dtype(spec["dtype"])
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        chunk = body[off : off + n]
        if len(chunk) != n:
            raise ValueError(
                f"systolic handoff truncated at {spec['key']!r}"
            )
        env[spec["key"]] = np.frombuffer(chunk, dtype=dtype).reshape(shape)
        off += n
    if off != len(body):
        raise ValueError("systolic handoff has trailing bytes")
    return meta, env
