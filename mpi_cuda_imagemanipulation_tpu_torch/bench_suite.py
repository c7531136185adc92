"""Benchmark suite: the five BASELINE.json configs and the beyond-parity
extras, measured on the card, and the suite's twelve lanes. The
counterpart of the JAX package's ``bench_suite.py``, rewritten on torch.

The reference's only "profiling subsystem" is two inconsistent wall-clock
spans printed to stdout (SURVEY.md §2.5/§6: kern.cpp:60,86-87 times compute
only; kernel.cu:190,226-227 times compute *plus* MPI_Gather). Here each
config reports seconds a call from `utils.timing.device_throughput`: on
the card device time on the padded clock (CUDA events around one call
queued behind a spin kernel; the build and first call excluded), with the
call's host enqueue beside it and ``host_bound`` where that is the longer;
on the CPU a host clock. Megapixels a second is the first-class metric.

The headline metric (BASELINE.json): megapixels a second a card on the 8K
5x5 Gaussian. ``roofline_frac`` divides the modelled byte rate by the
card's data-sheet memory rate (`obs.cost.peak_gb_s`, by
`utils.platform.device_kind`); ``device_kind`` stands where the JAX records
say ``tpu_gen``. No kernel-class element rate has been measured on the
card, so ``elem_ceiling_frac`` and ``ceiling_frac`` are not written.

Implementations (``impl``) are the port's backends: ``torch`` (the golden
ops; the JAX package's ``xla``), ``cuda`` (the hand-written kernels; its
``pallas``), ``swar``, ``mxu`` and ``auto``; ``both`` is torch then cuda.
Every lane defaults to the card and runs on the CPU when its caller passes
``device='cpu'``, sized down as the JAX lanes are off their hardware; each
keeps its JAX gate (byte equality before any timing) and record fields.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp
from mpi_cuda_imagemanipulation_tpu_torch.parallel.halo import exchange_halo_strips
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger
from mpi_cuda_imagemanipulation_tpu_torch.utils.platform import device_kind, is_cuda_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import _sync, device_throughput

# Estimated reference performance on its own headline config (BASELINE.md
# records the derivation: the reference publishes no numbers, so this is a
# first-principles estimate of the CUDA+MPI pipeline on 4xV100 at 8K 5x5,
# timed the way kernel.cu times itself, i.e. including MPI_Gather).
REFERENCE_BASELINE_MP_S_PER_CHIP = 1850.0

HEADLINE = "gaussian5_8k"

# Measured u8 compute-kernel element rate by device kind, giga-elements a
# second: the denominator of elem_ceiling_frac. Nothing has been measured
# on a card yet, so no record carries that field.
ELEM_G_S_MEASURED: dict[str, float] = {}

IMPLS = ("torch", "cuda", "swar", "mxu", "auto")


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    pipeline: str
    height: int
    width: int
    channels: int
    sharded: bool = False  # row-shard over the mesh's slots
    batch: int = 0  # >0: stack this many images per dispatch (Pipeline.batched)
    halo_mode: str = "serial"  # sharded halo execution (parallel.api.HALO_MODES)


# BASELINE.json "configs", in order, plus beyond-parity extras.
CONFIGS: dict[str, BenchConfig] = {
    c.name: c
    for c in [
        BenchConfig("grayscale_1080p", "grayscale", 1080, 1920, 3),
        BenchConfig("gaussian3_4k", "gaussian:3", 2160, 3840, 1),
        BenchConfig("sobel_4k", "sobel", 2160, 3840, 1),
        BenchConfig("gaussian5_8k", "gaussian:5", 4320, 7680, 1),
        BenchConfig("gaussian7_8k", "gaussian:7", 4320, 7680, 1),
        BenchConfig("reference_pipeline_4k", "grayscale,contrast:3.5,emboss:3", 2160, 3840, 3),
        BenchConfig("gaussian5_8k_sharded", "gaussian:5", 4320, 7680, 1, sharded=True),
        # overlap lane: the same workload with the interior-first overlapped
        # halo execution; the serial-vs-overlap comparison also rides every
        # sharded record as `halo_ab` when enabled (see _halo_ab)
        BenchConfig(
            "gaussian5_8k_sharded_overlap", "gaussian:5", 4320, 7680, 1,
            sharded=True, halo_mode="overlap",
        ),
        BenchConfig(
            "reference_1080p_batch8",
            "grayscale,contrast:3.5,emboss:3",
            1080, 1920, 3,
            batch=8,  # dispatch amortisation via Pipeline.batched
        ),
        BenchConfig("median3_4k", "median:3", 2160, 3840, 1),
        BenchConfig("erode5_4k", "erode:5", 2160, 3840, 1),
        BenchConfig("gaussian5_8k_batch2", "gaussian:5", 4320, 7680, 1, batch=2),
    ]
}


def modeled_hbm_bytes(cfg: BenchConfig) -> int:
    """Minimum device-memory traffic of the config: each fused
    [pointwise*, stencil?] group reads its input planes and writes its
    output planes once, as u8 (the kernels' contract; the JAX package's
    model, reported for every impl for comparability)."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import (
        _channels_after,
        group_ops,
    )

    pipe = Pipeline.parse(cfg.pipeline)
    n_ch = cfg.channels
    total = 0
    for pointwise, _stencil in group_ops(pipe.ops):
        n_out = _channels_after(pointwise, n_ch)
        total += (n_ch + n_out) * cfg.height * cfg.width
        n_ch = n_out
    return total * max(1, cfg.batch)


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def _halo_ab_enabled(device) -> bool:
    """Whether sharded configs run the serial-vs-overlap halo A/B and the
    per-group comms breakdown. MCIM_HALO_AB=1 forces it on, =0 off;
    default: on for a CUDA device, off on the CPU (the extra builds and
    timings are worth card minutes, not test minutes)."""
    v = env_registry.get("MCIM_HALO_AB") or ""
    if v == "1":
        return True
    if v == "0":
        return False
    return is_cuda_device(device)


def bench_mesh(n_shards: int | None, device):
    """The mesh of a sharded config on `device`: on a card one slot per
    visible card by default, as `parallel.mesh.make_mesh` makes it, or
    `n_shards` slots with slot i on card i modulo the cards; on the CPU
    `n_shards` CPU slots (default 1)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = n_shards or cards
        return make_mesh(n, devices=[torch.device("cuda", i % cards) for i in range(n)])
    n = n_shards or 1
    return make_mesh(n, devices=[dev] * n)


def _cards(mesh) -> int:
    """Distinct devices of a mesh: what `chips` counts."""
    return len({str(d) for d in mesh.devices})


def _comms_only_fn(mesh, halo: int):
    """A function of a mesh's tiles that performs ONLY one stencil group's
    ghost-strip exchange (parallel/halo.exchange_halo_strips: the (halo,
    W[, C]) strips over every boundary): the comms denominator of the
    per-group breakdown."""
    return lambda tiles: exchange_halo_strips(tiles, halo, mesh)


def _mesh_tiles(img: torch.Tensor, mesh) -> list[torch.Tensor]:
    """`img`'s row blocks, one on each slot's device (the scatter, done
    before any timing)."""
    return [t.to(d).contiguous() for t, d in zip(img.chunk(len(mesh.devices), dim=0),
                                                  mesh.devices)]


def _halo_ab(cfg: BenchConfig, pipe: Pipeline, mesh, img, impl: str) -> dict | None:
    """Serial-vs-overlap A/B plus the per-group comms/compute breakdown of
    a sharded config.

    Per stencil group: `comms_ms` times the group's ghost exchange alone;
    `serial_ms` times the group's sharded serial execution standalone
    (pointwise prologue included), so `compute_ms_est = serial_ms -
    comms_ms`. Pipeline-level: `comms_hidden_frac` = the fraction of total
    exchange time the overlap restructuring removed from the critical
    path, clipped to [0, 1]."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import (
        _channels_after,
        group_ops,
    )

    stencils = [op for op in pipe.ops if isinstance(op, StencilOp) and op.halo >= 1]
    if not stencils:
        return None
    ab: dict = {}
    for mode in ("serial", "overlap"):
        fn = pipe.sharded(mesh, backend=impl, halo_mode=mode)
        ab[f"{mode}_ms"] = device_throughput(fn, [img]) * 1e3
    per_group = []
    comms_total = 0.0
    n_ch = cfg.channels
    for gidx, (pointwise, stencil) in enumerate(group_ops(pipe.ops)):
        in_ch = n_ch
        n_ch = _channels_after(pointwise, n_ch)
        if stencil is None or stencil.halo < 1:
            continue
        gimg = torch.from_numpy(
            synthetic_image(cfg.height, cfg.width, channels=in_ch, seed=17)).to(img.device)
        tiles = _mesh_tiles(gimg, mesh)
        comms_ms = device_throughput(_comms_only_fn(mesh, stencil.halo), [tiles]) * 1e3
        comms_total += comms_ms
        entry = {
            "group": gidx,
            "ops": [op.name for op in pointwise] + [stencil.name],
            "halo": stencil.halo,
            "comms_ms": comms_ms,
        }
        if len(stencils) <= 3:  # bound the extra builds per config
            gpipe = Pipeline(ops=tuple(pointwise) + (stencil,))
            gserial = device_throughput(
                gpipe.sharded(mesh, backend=impl, halo_mode="serial"), [gimg]) * 1e3
            entry["serial_ms"] = gserial
            entry["compute_ms_est"] = gserial - comms_ms
        per_group.append(entry)
    ab["per_group"] = per_group
    ab["comms_ms_total"] = comms_total
    ab["compute_ms_est"] = ab["serial_ms"] - comms_total
    if comms_total > 0:
        ab["comms_hidden_frac"] = max(
            0.0, min(1.0, (ab["serial_ms"] - ab["overlap_ms"]) / comms_total))
    return ab


def config_image(cfg: BenchConfig, device) -> torch.Tensor:
    """The config's input on `device`: the seed-99 synthetic image, or a
    stack of seeds 99.. for a batched config."""
    if cfg.batch:
        arr = np.stack([
            synthetic_image(cfg.height, cfg.width, channels=cfg.channels, seed=99 + k)
            for k in range(cfg.batch)
        ])
    else:
        arr = synthetic_image(cfg.height, cfg.width, channels=cfg.channels, seed=99)
    return torch.from_numpy(arr).to(device)


def config_fn(cfg: BenchConfig, impl: str, device, mesh=None):
    """The config's callable at `impl` on `device` (a sharded config over
    `mesh`)."""
    pipe = Pipeline.parse(cfg.pipeline)
    if cfg.sharded:
        return pipe.sharded(mesh, backend=impl, halo_mode=cfg.halo_mode)
    if cfg.batch:
        return pipe.batched(backend=impl, device=device)
    return pipe.jit(backend=impl, device=device)


def run_config(cfg: BenchConfig, impl: str, *, n_shards: int | None = None,
               device=None) -> dict:
    """One (config, impl) record on `device` (default the card). A sharded
    config runs over `bench_mesh(n_shards, device)`; `chips` and the
    per-chip rate count its distinct cards, `slots` its slots."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost

    dev = resolve_device(device)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    img = config_image(cfg, dev)
    pipe = Pipeline.parse(cfg.pipeline)
    n_chips = 1
    mesh = None
    if cfg.sharded:
        mesh = bench_mesh(n_shards, dev)
        n_chips = _cards(mesh)
    fn = config_fn(cfg, impl, dev, mesh)
    clock: dict = {}
    sec = device_throughput(fn, [img], record=clock)
    mp = cfg.height * cfg.width * max(1, cfg.batch) / 1e6
    hbm_bytes = modeled_hbm_bytes(cfg)
    gb_s = obs_cost.measured_gb_s(hbm_bytes, sec, n_chips)
    rec = {
        "config": cfg.name,
        "pipeline": cfg.pipeline,
        "impl": impl,
        "height": cfg.height,
        "width": cfg.width,
        "chips": n_chips,
        "platform": _platform(dev),
        "ms_per_iter": sec * 1e3,
        "mp_per_s": mp / sec,
        "mp_per_s_per_chip": mp / sec / n_chips,
        "hbm_bytes_model": hbm_bytes,
        "hbm_gb_s_model": gb_s,
        "clock": clock["clock"],
        "host_enqueue_ms": clock["host_enqueue_ms"],
        "host_bound": clock["host_bound"],
    }
    if mesh is not None:
        rec["slots"] = len(mesh.devices)
    # MEASURED traffic columns (obs/cost.measured_call, on one more call):
    # the bytes crossing the call's boundary where the JAX records carry
    # XLA's compiled bytes, and on a card the allocator's peak beyond the
    # result; no compiler counts flops here, so hlo_flops is not written
    if obs_cost.enabled():
        _out, cost = obs_cost.measured_call(fn, (img,), temp=dev.type == "cuda")
        del _out
        rec["hbm_bytes_hlo"] = cost.boundary_bytes
        rec["hbm_gb_s_measured"] = obs_cost.measured_gb_s(cost.boundary_bytes, sec, n_chips)
        if cost.temp_bytes is not None:
            rec["hlo_temp_bytes"] = cost.temp_bytes
    if cfg.sharded:
        rec["halo_mode"] = cfg.halo_mode
        if _halo_ab_enabled(dev):
            ab = _halo_ab(cfg, pipe, mesh, img, impl)
            if ab:
                rec["halo_ab"] = ab
    if dev.type == "cuda":
        kind = device_kind(dev)
        rec["device_kind"] = kind
        try:
            rec["roofline_frac"] = obs_cost.measured_roofline_frac(
                hbm_bytes, sec, chips=n_chips, kind=kind)
        except ValueError as e:  # a card with no data-sheet row: no roofline column
            get_logger().warning("%s", e)
        else:
            if "hbm_bytes_hlo" in rec:
                rec["roofline_frac_measured"] = obs_cost.measured_roofline_frac(
                    rec["hbm_bytes_hlo"], sec, chips=n_chips, kind=kind)
        # the model counts u8 planes, so modelled bytes == modelled elements,
        # but only for impls that stream u8 elements (not swar's words, not
        # mxu's products): the element-rate column is written only then
        streams_u8 = impl not in ("swar", "mxu")
        if kind in ELEM_G_S_MEASURED and streams_u8:
            rec["elem_ceiling_frac"] = gb_s / ELEM_G_S_MEASURED[kind]
    return rec


SERVE_LOADGEN = "serve_loadgen"
ENGINE_AB = "engine_ab"
MXU_AB = "mxu_ab"
FABRIC_LOADGEN = "fabric_loadgen"
STREAM_AB = "stream_ab"
PLAN_AB = "plan_ab"
MEGAKERNEL_AB = "megakernel_ab"
MXU_FUSED_AB = "mxu_fused_ab"
GRAPH_LOADGEN = "graph_loadgen"
SYSTOLIC_AB = "systolic_ab"
FEDERATION_LOADGEN = "federation_loadgen"
TUNE_CONVERGENCE = "tune_convergence"


def _override(params: dict, knobs) -> dict:
    for env, key, cast in knobs:
        raw = env_registry.get(env)
        if raw:
            params[key] = cast(raw)
    return params


def _gate_image(h: int, w: int, c: int, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(synthetic_image(h, w, channels=c, seed=seed)).to(dev)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gate(name: str, pipe: Pipeline, lanes: dict, channels: int, dev) -> None:
    """Every lane byte-equal to the golden chain on three odd shapes, before
    any timing (the JAX lanes' gate)."""
    for th, tw, seed in ((48, 64, 1), (37, 200, 2), (130, 384, 3)):
        timg = _gate_image(th, tw, channels, seed, dev)
        golden = _host(pipe(timg))
        for lane, fn in lanes.items():
            if not np.array_equal(_host(fn(timg)), golden):
                raise AssertionError(f"{name} gate: lane {lane!r} mismatches golden at {th}x{tw}")


def _time_lanes(lanes: dict, img, extra=None) -> dict:
    """Each lane's clock record (`device_throughput`); one lane failing must
    not kill the A/B: its record holds the error. On a card each record
    also holds `launches`, the hand-written kernels its timed calls launched
    (ops/cuda_kernels.launch_counts), so a lane that fell back to a plain
    path shows none."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    on_card = img.device.type == "cuda"
    recs: dict[str, dict] = {}
    for lane, fn in lanes.items():
        clock: dict = {}
        before = ck.launch_counts() if on_card else {}
        try:
            sec = device_throughput(fn, [img], record=clock)
        except Exception as e:
            recs[lane] = {"error": str(e)[:200]}
            continue
        recs[lane] = {"ms_per_iter": sec * 1e3, "host_enqueue_ms": clock["host_enqueue_ms"],
                      "host_bound": clock["host_bound"], **(extra(lane, sec) if extra else {})}
        if on_card:
            recs[lane]["launches"] = {k: v - before[k] for k, v in ck.launch_counts().items()
                                      if v > before[k]}
    return recs


def _roofline(rec: dict, dev, nbytes: int, sec: float) -> None:
    """`roofline_frac` of a lane record on a card with a data-sheet rate."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost

    if dev.type != "cuda":
        return
    try:
        rec["roofline_frac"] = obs_cost.measured_roofline_frac(nbytes, sec,
                                                               kind=device_kind(dev))
    except ValueError:
        pass


def fabric_loadgen_params(device=None) -> dict:
    """The pod-fabric lane knobs, sized to the device. The offered rate
    deliberately EXCEEDS one replica's service capacity so the achieved
    column measures sustained pod throughput (capacity), not the arrival
    clock. Env overrides: MCIM_FABRIC_RPS / MCIM_FABRIC_DURATION_S /
    MCIM_FABRIC_REPLICAS."""
    on_card = is_cuda_device(device)
    params = {
        # several bucket keys spread sticky affinity over the replica set
        "ops": "grayscale,gaussian:5,contrast:3.5",
        "buckets": "512,768,1024,1536,2048" if on_card else "48,64,80,96,112,128",
        "max_batch": 8 if on_card else 4,
        "max_delay_ms": 4.0,
        "queue_depth": 256,
        "channels": "3",
        "offered_rps": 2048.0 if on_card else 600.0,
        # churn rate: below pod capacity, so the during-kill phase measures
        # rerouting, not saturation shedding
        "churn_rps": 512.0 if on_card else 120.0,
        "phase_s": 4.0 if on_card else 2.0,
        "replicas": 3,
        "n_images": 24,
        "heartbeat_s": 0.25,
        "max_workers": 256,
        # CPU only: per-dispatch synthetic device time (the sleep:MS
        # failpoint mode): a shared-core host has no per-replica device, so
        # without this floor replicas=N could never beat replicas=1. On a
        # card the floor is off and the lane measures the card.
        "device_floor_ms": None if on_card else 40.0,
        "device": str(torch.device("cuda" if device is None else device)),
    }
    raw = env_registry.get("MCIM_FABRIC_RPS")
    if raw:
        params["offered_rps"] = float(raw)
        params["churn_rps"] = float(raw) / 4.0
    raw = env_registry.get("MCIM_FABRIC_DURATION_S")
    if raw:
        params["phase_s"] = float(raw)
    raw = env_registry.get("MCIM_FABRIC_REPLICAS")
    if raw:
        params["replicas"] = int(raw)
    return params


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _FabricProc:
    """A whole pod (router + supervisor + replicas) as ONE subprocess via
    the `fabric` CLI on `p['device']`, in a process group of its own (so
    that `close` takes its replicas down with it whatever happened to the
    router). The load generator then owns this process's interpreter lock
    alone."""

    def __init__(self, p: dict, replicas: int, *, extra_args=(), extra_env=None):
        import subprocess
        import sys

        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.replicas = replicas
        env = dict(os.environ)
        if p.get("device_floor_ms"):
            # replicas inherit this env from the fabric process: every
            # dispatch pays the synthetic device floor (sleep:MS mode)
            env["MCIM_FAILPOINTS"] = f"serve.dispatch=sleep:{p['device_floor_ms']:g}"
        # spill the sticky target early: under deliberate saturation the
        # lane wants queue pressure converted into cross-replica spread
        env["MCIM_FABRIC_SHED_FRAC"] = "0.25"
        env.update(extra_env or {})
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            env=env,
            args=[
                sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch",
                "fabric",
                "--replicas", str(replicas),
                "--device", p.get("device", "cuda"),
                "--ops", p["ops"],
                "--buckets", p["buckets"],
                "--channels", p["channels"],
                "--max-batch", str(p["max_batch"]),
                "--max-delay-ms", str(p["max_delay_ms"]),
                "--queue-depth", str(p["queue_depth"]),
                "--host", "127.0.0.1",
                "--port", str(self.port),
                "--heartbeat-s", str(p["heartbeat_s"]),
                "--stale-s", str(4 * p["heartbeat_s"]),
                *extra_args,
            ],
            start_new_session=True,
        )

    def stats(self) -> dict:
        import json
        import urllib.request

        with urllib.request.urlopen(self.url + "/stats", timeout=10) as r:
            return json.loads(r.read())

    def routable(self) -> list[str]:
        try:
            st = self.stats()
        except Exception:
            return []
        return [rid for rid, rep in st["replicas"].items()
                if rep["fresh"] and rep["state"] in ("serving", "degraded")]

    def wait_routable(self, n: int, timeout_s: float = 240.0) -> None:
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"fabric process exited rc={self.proc.returncode}")
            if len(self.routable()) >= n:
                return
            _time.sleep(0.2)
        raise TimeoutError(
            f"{n} replicas not routable within {timeout_s:.0f}s (routable: {self.routable()})")

    def kill_replica(self, replica_id: str) -> int:
        """SIGKILL one replica by the pid its heartbeat reported; the
        fabric process's supervisor restarts it with backoff."""
        import signal as _signal

        pid = self.stats()["replicas"][replica_id]["pid"]
        os.kill(pid, _signal.SIGKILL)
        return pid

    def preempt_replica(self, replica_id: str) -> int:
        """SIGUSR1 = preemption notice: graceful drain + `preempt` dump +
        immediate no-backoff replacement by the supervisor."""
        import signal as _signal

        pid = self.stats()["replicas"][replica_id]["pid"]
        os.kill(pid, _signal.SIGUSR1)
        return pid

    def fresh_ids(self) -> list[str]:
        try:
            st = self.stats()
        except Exception:
            return []
        return [rid for rid, rep in st["replicas"].items() if rep["fresh"]]

    def autoscaler_events(self) -> list[dict]:
        try:
            auto = self.stats().get("autoscaler")
        except Exception:
            return []
        return list(auto["events"]) if auto else []

    def close(self) -> None:
        """SIGTERM (the pod drains), then SIGKILL to the whole process group
        for whatever is left (replicas of a router that was killed)."""
        import signal as _signal

        if self.proc.poll() is None:
            self.proc.send_signal(_signal.SIGTERM)
            try:
                self.proc.wait(timeout=60.0)
            except Exception:
                pass
        try:
            os.killpg(self.proc.pid, _signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait(timeout=10.0)

    def __enter__(self) -> "_FabricProc":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _phase_public(rec: dict) -> dict:
    """A phase record minus the raw per-request results (response bytes do
    not belong in a bench record)."""
    return {k: v for k, v in rec.items() if k != "results"}


def _lane_images(p: dict, dev):
    """The fabric lanes' request mix (seed 7), its PNG blobs and its
    goldens (`Pipeline.jit('torch')` on `dev`)."""
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim

    pipe = Pipeline.parse(p["ops"])
    images = loadgen.mixed_shapes(parse_buckets(p["buckets"]), p["n_images"], channels=3,
                                  seed=7, min_dim=min_true_dim(pipe))
    blobs = [loadgen.encode_blob(im) for im in images]
    golden_fn = pipe.jit("torch", device=dev)
    golden = [_host(golden_fn(im)) for im in images]
    return blobs, golden


def _bit_exact_checker(name: str, golden: list):
    def check(results) -> int:
        from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes

        n = 0
        for k, r in results:
            if r["code"] != 200:
                continue
            if not np.array_equal(decode_image_bytes(r["body"]), golden[k]):
                raise AssertionError(
                    f"{name}: response for image {k} mismatches the golden per-request output")
            n += 1
        return n

    return check


def _lane_row(printer, name: str, r: dict) -> None:
    printer(
        f"{name:22s} {r['achieved_rps']:9.1f} "
        f"{r['ok_frac'] * 100:5.1f}% "
        f"{r.get('shed_frac', 0.0) * 100:5.1f}% "
        f"{r['retried_frac'] * 100:6.1f}% "
        f"{r.get('e2e_p99_ms', float('nan')):8.2f}"
    )


def run_fabric_loadgen(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    replicas: int | None = None,
    device=None,
) -> dict:
    """The pod-fabric bench lane: the SAME open-loop HTTP request mix
    against (a) one replica, (b) N replicas, (c) N replicas with a SIGKILL
    mid-sweep (serve/loadgen.churn_run), and (d) an AUTOSCALED pod that must
    grow 1->N under the saturating rate, absorb a SIGUSR1 preemption
    mid-load, and drain back down once idle. Successes are gated
    byte-equal against the golden per-request path before any timing."""
    import threading as _threading
    import time as _time
    from collections import Counter

    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    dev = resolve_device(device)
    p = fabric_loadgen_params(dev)
    if replicas is not None:
        p["replicas"] = replicas
    blobs, golden = _lane_images(p, dev)
    check_bit_exact = _bit_exact_checker("fabric_loadgen", golden)

    lanes: dict[str, dict] = {}
    n_rep = p["replicas"]
    # -- replicas=1 baseline ----------------------------------------------
    with _FabricProc(p, 1) as fab:
        fab.wait_routable(1)
        # byte-exact gate BEFORE any timing: one pass over the unique mix
        gate_rps = min(64.0, p["offered_rps"])
        gate = loadgen.http_run_offered_load(fab.url, blobs, gate_rps, len(blobs) / gate_rps)
        gate_checked = check_bit_exact(gate["results"])
        rec1 = loadgen.http_run_offered_load(fab.url, blobs, p["offered_rps"], p["phase_s"],
                                             max_workers=p["max_workers"])
        check_bit_exact(rec1["results"])
        lanes["replicas_1"] = _phase_public(rec1)
    # -- replicas=N, same mix ---------------------------------------------
    with _FabricProc(p, n_rep) as fab:
        fab.wait_routable(n_rep)
        recn = loadgen.http_run_offered_load(fab.url, blobs, p["offered_rps"], p["phase_s"],
                                             max_workers=p["max_workers"])
        check_bit_exact(recn["results"])
        lanes[f"replicas_{n_rep}"] = _phase_public(recn)
        # the router's federated view of the lane just measured
        try:
            import json as _json
            import urllib.request as _rq

            with _rq.urlopen(fab.url + "/slo", timeout=10.0) as resp:
                slo_view = _json.loads(resp.read())
            rec_slo = {
                "p99": slo_view.get("p99"),
                "slos": {
                    name: {k: s[k] for k in ("alert", "burn_fast", "burn_slow")}
                    for name, s in slo_view.get("slos", {}).items()
                },
            }
        except Exception:
            rec_slo = None
        # -- churn: SIGKILL the replica serving the most traffic ----------
        by_replica = Counter(r["replica"] for _, r in recn["results"] if r["replica"])
        victim = by_replica.most_common(1)[0][0] if by_replica else "r0"
        killed_pid: list[int] = []
        phases = loadgen.churn_run(
            fab.url, blobs, offered_rps=p["churn_rps"], phase_s=p["phase_s"],
            kill=lambda: killed_pid.append(fab.kill_replica(victim)),
            before_after=lambda: fab.wait_routable(n_rep),
        )
        for ph in phases.values():
            check_bit_exact(ph["results"])
        new_pid = fab.stats()["replicas"][victim]["pid"]
        lanes[f"replicas_{n_rep}_churn"] = {name: _phase_public(ph) for name, ph in phases.items()}
        lanes[f"replicas_{n_rep}_churn"].update(
            victim=victim,
            churn_rps=p["churn_rps"],
            killed_pid=killed_pid[0] if killed_pid else None,
            respawned=bool(killed_pid) and new_pid != killed_pid[0],
        )
    # -- elastic: autoscale 1->N under saturation, preempt, drain back ------
    scale_env = {
        "MCIM_FABRIC_SCALE_TICK_S": "0.25",
        "MCIM_FABRIC_SCALE_SUSTAIN_S": "1.0",
        "MCIM_FABRIC_SCALE_COOLDOWN_S": "3.0",
        "MCIM_FABRIC_SCALE_UP_FRAC": "0.5",
        "MCIM_FABRIC_SCALE_DOWN_FRAC": "0.15",
    }
    with _FabricProc(p, 1, extra_args=["--autoscale", "--min-replicas", "1",
                                       "--max-replicas", str(n_rep)],
                     extra_env=scale_env) as fab:
        fab.wait_routable(1)
        stop_load = _threading.Event()
        elastic_recs: list[dict] = []

        def _elastic_load():
            while not stop_load.is_set():
                elastic_recs.append(loadgen.http_run_offered_load(
                    fab.url, blobs, p["offered_rps"], 1.0, max_workers=p["max_workers"]))

        loader = _threading.Thread(target=_elastic_load, daemon=True)
        t0 = _time.monotonic()
        loader.start()
        scale_up_s = None
        deadline = _time.monotonic() + 180.0
        while _time.monotonic() < deadline:
            if len(fab.routable()) >= n_rep:
                scale_up_s = _time.monotonic() - t0
                break
            _time.sleep(0.25)
        # preemption mid-load: evict one scaled-up replica gracefully
        preempted = False
        if scale_up_s is not None:
            victim = sorted(fab.routable())[-1]
            old_inc = fab.stats()["replicas"][victim]["incarnation"]
            fab.preempt_replica(victim)
            deadline = _time.monotonic() + 90.0
            while _time.monotonic() < deadline:
                rep = fab.stats()["replicas"].get(victim)
                if rep and rep["incarnation"] != old_inc and rep["state"] == "serving":
                    preempted = True
                    break
                _time.sleep(0.25)
        stop_load.set()
        loader.join(timeout=120.0)
        for rec_i in elastic_recs:
            check_bit_exact(rec_i["results"])
        # idle -> the loop must shrink back down by draining
        t1 = _time.monotonic()
        scale_down_s = None
        deadline = _time.monotonic() + 180.0
        while _time.monotonic() < deadline:
            if len(fab.fresh_ids()) <= 1:
                scale_down_s = _time.monotonic() - t1
                break
            _time.sleep(0.25)
        events = fab.autoscaler_events()
        n_el = sum(r["submitted"] for r in elastic_recs)
        ok_el = sum(r["ok"] for r in elastic_recs)
        shed_el = sum(r["shed"] for r in elastic_recs)
        accepted_el = sum(r["accepted"] for r in elastic_recs)
        lanes["elastic"] = {
            "offered_rps": p["offered_rps"],
            "submitted": n_el,
            "ok": ok_el,
            "ok_frac": ok_el / n_el if n_el else 0.0,
            "shed": shed_el,
            "shed_frac": shed_el / n_el if n_el else 0.0,
            "accepted": accepted_el,
            "ok_accepted_frac": ok_el / accepted_el if accepted_el else 1.0,
            "unavailable": sum(r["unavailable"] for r in elastic_recs),
            "retried_frac": sum(r["retried"] for r in elastic_recs) / n_el if n_el else 0.0,
            "achieved_rps": (sum(r["ok"] for r in elastic_recs)
                             / sum(r["wall_s"] for r in elastic_recs)
                             if elastic_recs else 0.0),
            "scaled_up": scale_up_s is not None,
            "scale_up_s": scale_up_s,
            "preempted": preempted,
            "scaled_down": scale_down_s is not None,
            "scale_down_s": scale_down_s,
            "drained": any(e["direction"] == "down" and e["reason"] == "drained"
                           for e in events),
            "events": events,
        }
    scaling = (lanes[f"replicas_{n_rep}"]["achieved_rps"] / lanes["replicas_1"]["achieved_rps"]
               if lanes["replicas_1"]["achieved_rps"] > 0 else None)
    rec = {
        "config": FABRIC_LOADGEN,
        "pipeline": p["ops"],
        "impl": "torch",
        "platform": _platform(dev),
        "buckets": p["buckets"],
        "replicas": n_rep,
        "offered_rps": p["offered_rps"],
        "phase_s": p["phase_s"],
        "bit_exact_gate": f"passed ({gate_checked} responses vs golden)",
        "lanes": lanes,
        "fleet_slo": rec_slo,
        "scaling_vs_1": scaling,
        "scaling_ok": scaling is not None and scaling >= 2.0,
    }
    printer(f"{'lane':22s} {'achieved':>9s} {'ok%':>6s} {'shed%':>6s} "
            f"{'retry%':>7s} {'p99 ms':>8s}")
    _lane_row(printer, "replicas_1", lanes["replicas_1"])
    _lane_row(printer, f"replicas_{n_rep}", lanes[f"replicas_{n_rep}"])
    for ph in ("before", "during", "after"):
        _lane_row(printer, f"churn/{ph}", lanes[f"replicas_{n_rep}_churn"][ph])
    el = lanes["elastic"]
    _lane_row(printer, "elastic", el)
    printer(
        "elastic: scale-up "
        + (f"{el['scale_up_s']:.1f}s" if el["scaled_up"] else "NEVER")
        + ", preempt->replace " + ("ok" if el["preempted"] else "FAILED")
        + ", scale-down "
        + (f"{el['scale_down_s']:.1f}s" if el["scaled_down"] else "NEVER")
        + (" (drained)" if el["drained"] else " (NOT drained)")
    )
    printer(f"scaling replicas_{n_rep}/replicas_1 = "
            + (f"{scaling:.2f}x" if scaling else "n/a") + f" (>=2x: {rec['scaling_ok']})")
    if rec_slo and rec_slo["p99"] and rec_slo["p99"].get("p99_s"):
        p99v = rec_slo["p99"]
        printer(f"federated p99 ~{p99v['p99_s'] * 1e3:.1f} ms"
                + (f"  p99~{p99v['exemplar_trace_id']}"
                   if p99v.get("exemplar_trace_id") else ""))
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def federation_loadgen_params(device=None) -> dict:
    """The federation lane knobs: the fabric_loadgen posture one tier up,
    two whole pods (each `replicas` replica processes behind its own
    router) joined to one front door. The fabric lane's env overrides
    apply here too; the pod count is fixed at 2, the smallest topology
    where "reroute" and "failover" mean different pods."""
    p = fabric_loadgen_params(device)
    p["pods"] = 2
    return p


def _fed_samples(door, family: str, label: str, where: str = "") -> dict[str, float]:
    """The front door's `family` samples whose labels hold `where`, summed
    by `label`'s value."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition

    fam = parse_exposition(door.registry.render()).get(family)
    out: dict[str, float] = {}
    if fam:
        for (_n, labels), v in fam["samples"].items():
            if where not in labels:
                continue
            key = labels.split(f'{label}="', 1)[1].split('"', 1)[0]
            out[key] = out.get(key, 0.0) + v
    return out


def run_federation_loadgen(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
    params: dict | None = None,
    door=None,
    pods: dict | None = None,
) -> dict:
    """The multi-pod federation bench lane: the same open-loop HTTP mix
    through the federation front door (federation/frontdoor.py) over 2 pods
    x N replicas, with a WHOLE POD SIGKILLed mid-sweep (router and replicas
    together, no drain, no restart). The gate is the fabric churn rule one
    tier up: during the pod loss every ACCEPTED request completes 200 and
    byte-equal against the golden per-request path, and the front door
    books the loss in mcim_fed_reroutes_total under REROUTE_REASONS only.

    `params` replaces `federation_loadgen_params(device)`. A caller may
    hand in a started in-process `door` (a FrontDoor) and its `pods` (pod
    id -> a `_FabricProc` federated to it, started with these params); the
    lane then kills one of them and closes neither the door nor the
    survivor."""
    import signal as _signal
    import tempfile as _tempfile
    import time

    from mpi_cuda_imagemanipulation_tpu_torch.federation.frontdoor import (
        REROUTE_REASONS,
        FrontDoor,
        FrontDoorConfig,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets

    dev = resolve_device(device)
    p = dict(params) if params is not None else federation_loadgen_params(dev)
    blobs, golden = _lane_images(p, dev)
    check_bit_exact = _bit_exact_checker("federation_loadgen", golden)

    own = door is None
    if own:
        tmp = _tempfile.mkdtemp(prefix="federation_loadgen_")
        door = FrontDoor(FrontDoorConfig(
            registry_path=os.path.join(tmp, "fed_registry.jsonl"),
            buckets=tuple(parse_buckets(p["buckets"])),
            stale_s=4 * p["heartbeat_s"],
            forward_timeout_s=60.0,
            forward_attempts=3,
        )).start(host="127.0.0.1", port=0)
        pods = {}
    lanes: dict[str, dict] = {}
    victim = None
    try:
        if own:
            for i in range(p["pods"]):
                pods[f"pod{i}"] = _FabricProc(
                    p, p["replicas"],
                    extra_args=["--federate", door.url, "--pod-id", f"pod{i}"],
                    extra_env={"MCIM_FED_HEARTBEAT_S": str(p["heartbeat_s"])},
                )
        ready: set = set()
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline:
            for pid, fab in pods.items():
                if fab.proc.poll() is not None:
                    raise RuntimeError(f"pod {pid} exited rc={fab.proc.returncode}")
            now = door._clock()
            ready = {v.pod_id for v in door.table.views()
                     if v.fresh(now, door.stale_s) and v.hb.routable >= p["replicas"]}
            if ready >= set(pods):
                break
            time.sleep(0.25)
        else:
            raise TimeoutError(f"pods never joined the front door (ready: {ready})")
        # byte-exact gate BEFORE any timing: one pass over the unique mix
        gate_rps = min(64.0, p["offered_rps"])
        gate = loadgen.http_run_offered_load(door.url, blobs, gate_rps, len(blobs) / gate_rps)
        gate_checked = check_bit_exact(gate["results"])
        # -- 2 pods, steady state -------------------------------------------
        rec2 = loadgen.http_run_offered_load(door.url, blobs, p["offered_rps"], p["phase_s"],
                                             max_workers=p["max_workers"])
        check_bit_exact(rec2["results"])
        lanes["pods_2"] = _phase_public(rec2)
        # -- whole-pod churn: the pod that carried the most forwards ------
        by_pod = _fed_samples(door, "mcim_fed_forwards_total", "pod", where='outcome="ok"')
        victim = max(by_pod, key=by_pod.get) if by_pod else next(iter(pods))
        survivor = next(pid for pid in pods if pid != victim)
        killed_pids: list[int] = []

        def _kill_whole_pod():
            fab = pods[victim]
            try:
                killed_pids.extend(rep["pid"] for rep in fab.stats()["replicas"].values())
            except Exception:
                pass
            if fab.proc.poll() is None:
                killed_pids.append(fab.proc.pid)
                fab.proc.send_signal(_signal.SIGKILL)
            for pid in killed_pids:
                try:
                    os.kill(pid, _signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

        phases = loadgen.churn_run(door.url, blobs, offered_rps=p["churn_rps"],
                                   phase_s=p["phase_s"], kill=_kill_whole_pod)
        for ph in phases.values():
            check_bit_exact(ph["results"])
        during = phases["during"]
        if during["unavailable"] or during["ok"] != during["accepted"]:
            raise AssertionError(
                f"federation_loadgen: requests lost during whole-pod SIGKILL of {victim}: "
                f"ok {during['ok']} / accepted {during['accepted']} / unavailable "
                f"{during['unavailable']}")
        reroutes = _fed_samples(door, "mcim_fed_reroutes_total", "reason")
        unknown = set(reroutes) - set(REROUTE_REASONS)
        if unknown:
            raise AssertionError(
                f"federation_loadgen: reroute reasons outside the closed vocabulary: "
                f"{sorted(unknown)}")
        if not reroutes:
            raise AssertionError("federation_loadgen: whole-pod SIGKILL produced no counted "
                                 "reroute")
        lanes["pod_churn"] = {name: _phase_public(ph) for name, ph in phases.items()}
        lanes["pod_churn"].update(victim=victim, survivor=survivor, churn_rps=p["churn_rps"],
                                  killed_pids=killed_pids, reroutes=reroutes)
    finally:
        if own:
            door.close()
            for fab in pods.values():
                fab.close()
        elif victim is not None:
            pods[victim].close()
    rec = {
        "config": FEDERATION_LOADGEN,
        "pipeline": p["ops"],
        "impl": "torch",
        "platform": _platform(dev),
        "buckets": p["buckets"],
        "pods": p["pods"],
        "replicas_per_pod": p["replicas"],
        "offered_rps": p["offered_rps"],
        "phase_s": p["phase_s"],
        "bit_exact_gate": f"passed ({gate_checked} responses vs golden)",
        "lanes": lanes,
        "reroutes": reroutes,
    }
    printer(f"{'lane':22s} {'achieved':>9s} {'ok%':>6s} {'shed%':>6s} "
            f"{'retry%':>7s} {'p99 ms':>8s}")
    _lane_row(printer, "pods_2", lanes["pods_2"])
    for ph in ("before", "during", "after"):
        _lane_row(printer, f"pod_churn/{ph}", lanes["pod_churn"][ph])
    printer(f"whole-pod SIGKILL of {victim}: during-phase {during['ok']}/{during['accepted']} "
            f"accepted requests ok (byte-exact), reroutes {reroutes}")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def mxu_ab_params(device=None) -> dict:
    """The MXU A/B lane knobs, sized to the device: the headline 8K
    gaussian:5 on a card, a small shape on the CPU. Env overrides:
    MCIM_MXU_AB_OPS / _HEIGHT / _WIDTH."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "gaussian:5",
        "height": 4320 if on_card else 256,
        "width": 7680 if on_card else 512,
    }, (("MCIM_MXU_AB_OPS", "ops", str), ("MCIM_MXU_AB_HEIGHT", "height", int),
        ("MCIM_MXU_AB_WIDTH", "width", int)))


def mxu_ab_lanes(pipe: Pipeline) -> dict[str, Callable]:
    """mxu_ab's three formulations of one chain: `vpu` the K1/K2 group
    runner (the JAX package's Pallas streaming kernels), `mxu` the banded
    products both passes, `hybrid` the row pass on the group runner's
    arithmetic and the column pass as a product."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import pipeline_mxu

    return {
        "vpu": lambda x: pipeline_cuda(pipe.ops, x),
        "mxu": lambda x: pipeline_mxu(pipe.ops, x, mode="banded"),
        "hybrid": lambda x: pipeline_mxu(pipe.ops, x, mode="hybrid"),
    }


def run_mxu_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """The VPU-vs-tensor-core bench lane: the same workload three ways
    (`mxu_ab_lanes`), each gated byte-equal against the golden path on
    three small shapes before any timing, then timed with MP/s and (on a
    card) `roofline_frac` against the one-read-one-write u8 model."""
    dev = resolve_device(device)
    p = mxu_ab_params(dev)
    pipe = Pipeline.parse(p["ops"])
    lanes = mxu_ab_lanes(pipe)
    _gate("mxu_ab", pipe, lanes, 1, dev)
    img = _gate_image(p["height"], p["width"], 1, 99, dev)
    mp = p["height"] * p["width"] / 1e6
    hbm_bytes = 2 * p["height"] * p["width"]  # one u8 read + one u8 write

    def extra(lane, sec):
        lr = {"mp_per_s_per_chip": mp / sec, "hbm_gb_s_model": hbm_bytes / sec / 1e9}
        _roofline(lr, dev, hbm_bytes, sec)
        return lr

    lane_recs = _time_lanes(lanes, img, extra)
    ok = {k: v for k, v in lane_recs.items() if "error" not in v}
    best = max(ok, key=lambda k: ok[k]["mp_per_s_per_chip"]) if ok else None
    rec = {
        "config": MXU_AB,
        "pipeline": p["ops"],
        "impl": "mxu_ab",
        "platform": _platform(dev),
        "height": p["height"],
        "width": p["width"],
        "bit_exact_gate": "passed (3 shapes x 3 lanes vs golden)",
        "lanes": lane_recs,
        "best_lane": best,
    }
    if dev.type == "cuda":
        rec["device_kind"] = device_kind(dev)
    printer(f"{'lane':8s} {'ms/iter':>9s} {'MP/s/chip':>11s} {'roofline':>9s}")
    for lane, lr in lane_recs.items():
        if "error" in lr:
            printer(f"{lane:8s} ERROR {lr['error'][:80]}")
            continue
        rl = f"{lr['roofline_frac'] * 100:8.1f}%" if "roofline_frac" in lr else f"{'-':>9s}"
        printer(f"{lane:8s} {lr['ms_per_iter']:9.3f} {lr['mp_per_s_per_chip']:11.0f} {rl}")
    if best:
        printer(f"best lane: {best}")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def engine_ab_params(device=None) -> dict:
    """The engine A/B lane knobs, sized to the device. The corpus is
    synthetic-slow-decode: real PNG bytes decoded per image plus a fixed
    host delay, so the serial lane's device-idle fraction is substantial.
    Env overrides: MCIM_ENGINE_AB_IMAGES / _DECODE_MS / _ENCODE_MS /
    _INFLIGHT."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "grayscale,contrast:3.5,emboss:3",
        "n_images": 32 if on_card else 12,
        "height": 1080 if on_card else 96,
        "width": 1920 if on_card else 128,
        "channels": 3,
        "decode_ms": 8.0 if on_card else 20.0,
        "encode_ms": 4.0 if on_card else 10.0,
        "inflight": 2,
        "io_threads": 4,
        "decode_threads": 4,
    }, (("MCIM_ENGINE_AB_IMAGES", "n_images", int),
        ("MCIM_ENGINE_AB_DECODE_MS", "decode_ms", float),
        ("MCIM_ENGINE_AB_ENCODE_MS", "encode_ms", float),
        ("MCIM_ENGINE_AB_INFLIGHT", "inflight", int)))


def engine_ab_images(p: dict) -> list[np.ndarray]:
    """engine_ab's corpus (seeds 31..)."""
    return [synthetic_image(p["height"], p["width"], channels=p["channels"], seed=31 + k)
            for k in range(p["n_images"])]


def run_engine_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    inflight: int | None = None,
    device=None,
    outputs: dict | None = None,
) -> dict:
    """Serial-vs-overlapped end-to-end A/B over the asynchronous engine
    (engine/core.py): the same inputs and function, two structures: decode
    -> dispatch -> force -> encode one image at a time, and a decode
    prefetch pool feeding the engine (`inflight` dispatches outstanding,
    pinned H2D by `device_stager`, in-order completion, an encode pool).
    Overlap is shown when the engine's idle fraction drops below serial's
    while the outputs stay byte-identical. `outputs`, when given, receives
    the serial lane's outputs by image index."""
    import time as _time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics
    from mpi_cuda_imagemanipulation_tpu_torch.engine.core import device_stager
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        decode_image_bytes,
        encode_image_bytes,
    )

    dev = resolve_device(device)
    p = engine_ab_params(dev)
    if inflight is not None:
        p["inflight"] = inflight
    decode_s = p["decode_ms"] / 1e3
    encode_s = p["encode_ms"] / 1e3
    imgs = engine_ab_images(p)
    blobs = [encode_image_bytes(im) for im in imgs]  # the on-"disk" corpus

    def decode(blob) -> np.ndarray:
        img = decode_image_bytes(blob)
        _time.sleep(decode_s)  # synthetic slow-decode tail
        return img

    def encode(out: np.ndarray) -> bytes:
        data = encode_image_bytes(out)
        _time.sleep(encode_s)  # synthetic slow-encode/write tail
        return data

    pipe = Pipeline.parse(p["ops"])
    fn = pipe.jit("torch", device=dev, donate=True)
    _sync(fn(imgs[0]))  # first call outside both timed lanes

    # -- serial lane -----------------------------------------------------
    serial_out: dict[int, np.ndarray] = {}
    busy = 0.0
    t0 = _time.perf_counter()
    for k, blob in enumerate(blobs):
        img = decode(blob)
        tb = _time.perf_counter()
        out = _host(fn(img))  # forces completion inline
        busy += _time.perf_counter() - tb
        serial_out[k] = out
        encode(out)
    serial_wall = _time.perf_counter() - t0
    serial_idle = max(0.0, 1.0 - busy / serial_wall)

    # -- overlapped lane -------------------------------------------------
    overlap_out: dict[int, np.ndarray] = {}
    errors: list = []

    def _on_done(k, out, info):
        arr = np.asarray(out)
        overlap_out[k] = arr
        encode(arr)

    metrics = EngineMetrics()
    engine = Engine(inflight=p["inflight"], io_threads=p["io_threads"],
                    stage=device_stager(dev, inflight=p["inflight"]), metrics=metrics,
                    name="engine-ab")
    t0 = _time.perf_counter()
    with ThreadPoolExecutor(p["decode_threads"]) as pool:
        pending: deque = deque()
        max_ahead = 2 * p["decode_threads"]
        it = iter(enumerate(blobs))
        exhausted = False
        while pending or not exhausted:
            while not exhausted and len(pending) < max_ahead:
                try:
                    k, blob = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append((k, pool.submit(decode, blob)))
            if not pending:
                break
            k, fut = pending.popleft()
            img = fut.result()
            engine.submit(k, lambda img=img: img, fn, on_done=_on_done,
                          on_error=lambda k, e: errors.append((k, e)))
        engine.close()
    overlap_wall = _time.perf_counter() - t0
    overlap_idle = metrics.device_idle_frac()

    if errors:
        raise RuntimeError(f"engine_ab overlapped lane failed: {errors[:3]}")
    bit_identical = len(overlap_out) == len(serial_out) and all(
        np.array_equal(serial_out[k], overlap_out[k]) for k in serial_out)
    if outputs is not None:
        outputs.update(serial_out)
    n = p["n_images"]
    rec = {
        "config": ENGINE_AB,
        "pipeline": p["ops"],
        "impl": "torch",
        "platform": _platform(dev),
        "n_images": n,
        "height": p["height"],
        "width": p["width"],
        "decode_ms": p["decode_ms"],
        "encode_ms": p["encode_ms"],
        "inflight": p["inflight"],
        "io_threads": p["io_threads"],
        "decode_threads": p["decode_threads"],
        "serial": {
            "wall_s": serial_wall,
            "images_per_s": n / serial_wall,
            "device_idle_frac": serial_idle,
        },
        "overlap": {
            "wall_s": overlap_wall,
            "images_per_s": n / overlap_wall,
            "device_idle_frac": overlap_idle,
            "inflight_peak": metrics.snapshot()["inflight_peak"],
        },
        "speedup": serial_wall / overlap_wall if overlap_wall > 0 else None,
        "overlap_won": overlap_idle is not None and overlap_idle < serial_idle,
        "bit_identical": bit_identical,
    }
    printer(f"{'lane':10s} {'wall s':>8s} {'img/s':>8s} {'dev idle':>9s}")
    printer(f"{'serial':10s} {serial_wall:8.2f} {n / serial_wall:8.1f} {serial_idle * 100:8.1f}%")
    printer(f"{'overlap':10s} {overlap_wall:8.2f} {n / overlap_wall:8.1f} "
            + (f"{overlap_idle * 100:8.1f}%" if overlap_idle is not None else f"{'-':>9s}"))
    printer(f"speedup {rec['speedup']:.2f}x, inflight {p['inflight']} "
            f"(peak {rec['overlap']['inflight_peak']}), bit_identical={bit_identical}")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def stream_ab_params(device=None) -> dict:
    """The stream A/B knobs, sized to the device. The read stage carries a
    small synthetic per-band latency on the CPU so the serial lane's
    device-idle fraction is substantial. Env overrides:
    MCIM_STREAM_AB_HEIGHT/_WIDTH/_TILE_ROWS."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "grayscale,contrast:3.5,emboss:3",
        "n_images": 2 if on_card else 3,
        "height": 8192 if on_card else 1536,
        "width": 2048 if on_card else 256,
        "channels": 3,
        "tile_rows": 512 if on_card else 128,
        "inflight": 2,
        "read_ms_per_band": 0.0 if on_card else 4.0,
    }, (("MCIM_STREAM_AB_HEIGHT", "height", int), ("MCIM_STREAM_AB_WIDTH", "width", int),
        ("MCIM_STREAM_AB_TILE_ROWS", "tile_rows", int)))


def run_stream_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    tile_rows: int | None = None,
    device=None,
    outputs: dict | None = None,
) -> dict:
    """Serial-whole-image vs streamed-tiles A/B (stream/runner.py): the full
    frame in one dispatch and one PNG, against the same rows through the
    tile engine (windowed synthetic reader, seam-stitched fixed-shape
    tiles, double-buffered dispatches, ordered incremental PNG encode).
    Reports img/s, device-idle fraction and peak resident bytes per lane;
    the outputs are gated byte-identical (both PNGs decoded) before any
    number is reported. `outputs`, when given, receives the decoded
    streamed outputs by image index."""
    import io as _io
    import time as _time

    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        decode_image_bytes,
        encode_image_bytes,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
        PNGTileWriter,
        SyntheticTileReader,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.stream import StreamMetrics, stream_pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import TileStager
    from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import TileFnCache, out_channels

    dev = resolve_device(device)
    p = stream_ab_params(dev)
    if tile_rows is not None:
        p["tile_rows"] = tile_rows
    h, w, c = p["height"], p["width"], p["channels"]
    T = p["tile_rows"]
    n_bands = -(-h // T)
    read_s_band = p["read_ms_per_band"] / 1e3
    pipe = Pipeline.parse(p["ops"])
    out_c = out_channels(pipe.ops, c)

    fn = pipe.jit("torch", device=dev)
    _sync(fn(synthetic_image(h, w, channels=c, seed=0)))  # first call outside the clocks

    # -- serial lane: whole image resident, one dispatch -----------------
    serial_png: dict[int, bytes] = {}
    serial_peak = 0
    busy = 0.0
    t0 = _time.perf_counter()
    for k in range(p["n_images"]):
        img = synthetic_image(h, w, channels=c, seed=100 + k)
        _time.sleep(read_s_band * n_bands)  # same modelled decode latency
        tb = _time.perf_counter()
        out = _host(fn(img))
        busy += _time.perf_counter() - tb
        png = encode_image_bytes(out)
        serial_peak = max(serial_peak, img.nbytes + out.nbytes + len(png))
        serial_png[k] = png
    serial_wall = _time.perf_counter() - t0
    serial_idle = max(0.0, 1.0 - busy / serial_wall)

    # -- streamed lane: fixed-shape tiles, constant footprint ------------
    class _SlowSynthetic(SyntheticTileReader):
        def _read(self, n):
            _time.sleep(read_s_band)  # modelled per-band decode latency
            return super()._read(n)

    smetrics = StreamMetrics()
    engine = Engine(inflight=p["inflight"], io_threads=2,
                    stage=TileStager(dev, inflight=p["inflight"], metrics=smetrics),
                    metrics=EngineMetrics(registry=smetrics.registry), ordered_done=True,
                    name="stream-ab")
    fn_cache = TileFnCache(pipe.ops, global_h=h, global_w=w, impl="torch", device=dev)
    # warm the streamed lane's tile functions (one untimed pass)
    _warm = PNGTileWriter(_io.BytesIO(), h, w, out_c)
    warm_metrics = StreamMetrics()
    with Engine(inflight=p["inflight"], io_threads=2,
                stage=TileStager(dev, inflight=p["inflight"], metrics=warm_metrics),
                ordered_done=True, name="stream-ab-warm") as _weng:
        stream_pipeline(SyntheticTileReader(h, w, channels=c, seed=99), _warm, pipe.ops,
                        tile_rows=T, impl="torch", device=dev, metrics=warm_metrics,
                        engine=_weng, fn_cache=fn_cache)
    _warm.close()

    stream_png: dict[int, bytes] = {}
    t0 = _time.perf_counter()
    try:
        for k in range(p["n_images"]):
            sink = _io.BytesIO()
            writer = PNGTileWriter(sink, h, w, out_c)
            stream_pipeline(_SlowSynthetic(h, w, channels=c, seed=100 + k), writer, pipe.ops,
                            tile_rows=T, impl="torch", device=dev, metrics=smetrics,
                            engine=engine, fn_cache=fn_cache)
            writer.close()
            stream_png[k] = sink.getvalue()
    finally:
        engine.close()
    stream_wall = _time.perf_counter() - t0
    stream_idle = engine.metrics.device_idle_frac()
    stream_peak = smetrics.peak_resident_bytes

    decoded = {k: decode_image_bytes(stream_png[k]) for k in range(p["n_images"])}
    bit_identical = all(np.array_equal(decode_image_bytes(serial_png[k]), decoded[k])
                        for k in range(p["n_images"]))
    if not bit_identical:
        raise RuntimeError(
            "stream_ab gate: streamed output mismatches the whole-image golden; refusing "
            "to report performance for wrong results")
    if outputs is not None:
        outputs.update(decoded)
    n = p["n_images"]
    rec = {
        "config": STREAM_AB,
        "pipeline": p["ops"],
        "impl": "torch",
        "platform": _platform(dev),
        "n_images": n,
        "height": h,
        "width": w,
        "channels": c,
        "tile_rows": T,
        "inflight": p["inflight"],
        "read_ms_per_band": p["read_ms_per_band"],
        "serial": {
            "wall_s": serial_wall,
            "images_per_s": n / serial_wall,
            "mp_per_s": n * h * w / 1e6 / serial_wall,
            "device_idle_frac": serial_idle,
            "peak_resident_bytes": serial_peak,
        },
        "stream": {
            "wall_s": stream_wall,
            "images_per_s": n / stream_wall,
            "mp_per_s": n * h * w / 1e6 / stream_wall,
            "device_idle_frac": stream_idle,
            "peak_resident_bytes": stream_peak,
            "inflight_peak": engine.metrics.snapshot()["inflight_peak"],
        },
        "speedup": serial_wall / stream_wall if stream_wall > 0 else None,
        "memory_ratio": serial_peak / stream_peak if stream_peak else None,
        "overlap_won": stream_idle is not None and stream_idle < serial_idle,
        "bit_identical": bit_identical,
    }
    printer(f"{'lane':10s} {'wall s':>8s} {'img/s':>8s} {'dev idle':>9s} {'peak MiB':>9s}")
    printer(f"{'serial':10s} {serial_wall:8.2f} {n / serial_wall:8.2f} "
            f"{serial_idle * 100:8.1f}% {serial_peak / 2**20:9.2f}")
    printer(f"{'stream':10s} {stream_wall:8.2f} {n / stream_wall:8.2f} "
            + (f"{stream_idle * 100:8.1f}%" if stream_idle is not None else f"{'-':>9s}")
            + f" {stream_peak / 2**20:9.2f}")
    printer(f"speedup {rec['speedup']:.2f}x, memory {rec['memory_ratio']:.1f}x smaller "
            f"resident, tile_rows {T}, bit_identical={bit_identical}")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def plan_ab_params(device=None) -> dict:
    """The fusion-planner A/B knobs, sized to the device: the
    pointwise-heavy headline chain at 8K on a card, a CPU-sized shape
    otherwise. Env overrides: MCIM_PLAN_AB_OPS/_HEIGHT/_WIDTH."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "grayscale,contrast:3.5,gaussian:5,quantize:6",
        "height": 4320 if on_card else 512,
        "width": 7680 if on_card else 512,
        "channels": 3,
    }, (("MCIM_PLAN_AB_OPS", "ops", str), ("MCIM_PLAN_AB_HEIGHT", "height", int),
        ("MCIM_PLAN_AB_WIDTH", "width", int)))


def plan_ab_lanes(pipe: Pipeline, dev) -> tuple[dict, dict]:
    """plan_ab's lanes and their plans: `off` the golden chain, `per_op`
    one callable per op, `pointwise` and `fused` the stage walker over
    those plans (the JAX package's XLA lanes, here the golden torch ops),
    and `fused_pallas`, the cuda arm: each eligible stage of the fused
    plan one K4 launch (plan/cuda_exec.py)."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import (
        plan_callable,
        run_unfused,
        unfused_callables,
    )

    plans = {m: build_plan(pipe.ops, m) for m in ("pointwise", "fused", "fused-pallas")}
    per_op = unfused_callables(pipe.ops)
    lanes = {
        "off": pipe.jit("torch", device=dev, plan="off"),
        "per_op": lambda x: run_unfused(per_op, x),
        "pointwise": plan_callable(plans["pointwise"]),
        "fused": plan_callable(plans["fused"]),
        "fused_pallas": plan_callable_cuda(plans["fused-pallas"]),
    }
    return lanes, {"pointwise": plans["pointwise"], "fused": plans["fused"],
                   "fused_pallas": plans["fused-pallas"]}


def run_plan_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Unfused-vs-fused execution-plan bench lane (plan/): the lanes of
    `plan_ab_lanes`, every one gated byte-identical to the golden chain on
    three odd shapes before any timing, then timed end to end, plus a
    per-stage breakdown of the fused plan and the modelled device-memory
    passes."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import run_stage_full

    dev = resolve_device(device)
    p = plan_ab_params(dev)
    pipe = Pipeline.parse(p["ops"])
    c = p["channels"]
    lanes, plans = plan_ab_lanes(pipe, dev)
    _gate("plan_ab", pipe, lanes, c, dev)

    img = _gate_image(p["height"], p["width"], c, 99, dev)
    mp = p["height"] * p["width"] / 1e6

    def extra(lane, sec):
        plan = plans.get(lane)
        return {
            "mp_per_s_per_chip": mp / sec,
            "stages": len(plan.stages) if plan else len(pipe.ops),
            "hbm_passes_model": plan.hbm_passes if plan else plans["fused"].hbm_passes_unfused,
        }

    lane_recs = _time_lanes(lanes, img, extra)
    # -- per-stage breakdown of the fused plan (where the time went) -----
    stage_ms = []
    for stage in plans["fused"].stages:
        try:
            sec = device_throughput(lambda x, s=stage: run_stage_full(s, x), [img], reps=3)
            stage_ms.append({"ops": "+".join(stage.names), "halo": stage.halo,
                             "ms_per_iter": sec * 1e3})
        except Exception as e:
            stage_ms.append({"ops": "+".join(stage.names), "error": str(e)[:200]})
    ok = {k: v for k, v in lane_recs.items() if "error" not in v}
    speedup = speedup_dispatch = None
    if "off" in ok and "fused" in ok:
        speedup = ok["off"]["ms_per_iter"] / ok["fused"]["ms_per_iter"]
    if "per_op" in ok and "fused" in ok:
        speedup_dispatch = ok["per_op"]["ms_per_iter"] / ok["fused"]["ms_per_iter"]
    rec = {
        "config": PLAN_AB,
        "pipeline": p["ops"],
        "impl": "plan_ab",
        "platform": _platform(dev),
        "height": p["height"],
        "width": p["width"],
        "channels": c,
        "bit_exact_gate": f"passed (3 shapes x {len(lanes)} lanes vs golden)",
        "lanes": lane_recs,
        "fused_stage_breakdown": stage_ms,
        "hbm_passes_saved_model": plans["fused"].hbm_passes_saved,
        "speedup_fused_vs_off": speedup,
        "speedup_fused_vs_per_op_dispatch": speedup_dispatch,
    }
    if dev.type == "cuda":
        rec["device_kind"] = device_kind(dev)
    printer(f"{'lane':12s} {'ms/iter':>9s} {'MP/s/chip':>11s} {'stages':>7s} {'hbm':>4s}")
    for lane, lr in lane_recs.items():
        if "error" in lr:
            printer(f"{lane:12s} ERROR {lr['error'][:80]}")
            continue
        printer(f"{lane:12s} {lr['ms_per_iter']:9.3f} {lr['mp_per_s_per_chip']:11.0f} "
                f"{lr['stages']:7d} {lr['hbm_passes_model']:4d}")
    for s in stage_ms:
        printer(f"  stage {s['ops']}: " + (f"{s['ms_per_iter']:.3f} ms" if "ms_per_iter" in s
                                          else f"ERROR {s['error'][:60]}"))
    if speedup is not None:
        printer(f"fused speedup {speedup:.2f}x e2e vs --plan off "
                f"({plans['fused'].hbm_passes_saved} modelled passes saved)")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def megakernel_ab_params(device=None) -> dict:
    """The fused-walker-vs-K4 A/B knobs: a two-stencil chain so the
    headline stage is temporally blocked (gaussian:5 + sharpen fuse behind
    one halo-3 stage) at 8K on a card, a CPU-sized shape otherwise. Env
    overrides: MCIM_MEGAKERNEL_AB_OPS/_HEIGHT/_WIDTH."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6",
        "height": 4320 if on_card else 384,
        "width": 7680 if on_card else 512,
        "channels": 3,
    }, (("MCIM_MEGAKERNEL_AB_OPS", "ops", str), ("MCIM_MEGAKERNEL_AB_HEIGHT", "height", int),
        ("MCIM_MEGAKERNEL_AB_WIDTH", "width", int)))


def megakernel_ab_lanes(pipe: Pipeline, dev) -> tuple[dict, dict]:
    """megakernel_ab's lanes: `off` the golden chain, `fused` the stage
    walker (torch), `fused_pallas` each eligible stage one K4 launch."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import plan_callable

    plans = {"fused": build_plan(pipe.ops, "fused"),
             "fused_pallas": build_plan(pipe.ops, "fused-pallas")}
    return {
        "off": pipe.jit("torch", device=dev, plan="off"),
        "fused": plan_callable(plans["fused"]),
        "fused_pallas": plan_callable_cuda(plans["fused_pallas"]),
    }, plans


def run_megakernel_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Fused-walker vs fused-kernel megakernel bench lane
    (plan/cuda_exec.py): the lanes of `megakernel_ab_lanes`, gated
    byte-identical to the golden chain on three odd shapes before any
    timing, with each stage's K4 eligibility in the record (a silent
    everything-fell-back run is visible). On the CPU the K4 lane runs K4's
    plain version (``interpret_mode``: a gate record, not a speed claim)."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import stage_kernel_reject

    dev = resolve_device(device)
    p = megakernel_ab_params(dev)
    pipe = Pipeline.parse(p["ops"])
    c = p["channels"]
    lanes, plans = megakernel_ab_lanes(pipe, dev)
    _gate("megakernel_ab", pipe, lanes, c, dev)
    img = _gate_image(p["height"], p["width"], c, 99, dev)
    mp = p["height"] * p["width"] / 1e6
    eligibility = [
        {"ops": "+".join(s.names), "halo": s.halo,
         "reject": stage_kernel_reject(s, p["height"], p["width"], c)}
        for s in plans["fused_pallas"].stages
    ]
    lane_recs = _time_lanes(lanes, img, lambda lane, sec: {"mp_per_s_per_chip": mp / sec})
    ok = {k: v for k, v in lane_recs.items() if "error" not in v}
    speedup = speedup_vs_off = None
    if "fused" in ok and "fused_pallas" in ok:
        speedup = ok["fused"]["ms_per_iter"] / ok["fused_pallas"]["ms_per_iter"]
    if "off" in ok and "fused_pallas" in ok:
        speedup_vs_off = ok["off"]["ms_per_iter"] / ok["fused_pallas"]["ms_per_iter"]
    rec = {
        "config": MEGAKERNEL_AB,
        "pipeline": p["ops"],
        "impl": "megakernel_ab",
        "platform": _platform(dev),
        "interpret_mode": dev.type != "cuda",
        "height": p["height"],
        "width": p["width"],
        "channels": c,
        "bit_exact_gate": "passed (3 shapes x 3 lanes vs golden)",
        "lanes": lane_recs,
        "stage_eligibility": eligibility,
        "megakernel_stages": sum(1 for e in eligibility if e["reject"] is None),
        "speedup_pallas_vs_fused": speedup,
        "speedup_pallas_vs_off": speedup_vs_off,
    }
    if dev.type == "cuda":
        rec["device_kind"] = device_kind(dev)
    printer(f"{'lane':14s} {'ms/iter':>9s} {'MP/s/chip':>11s}")
    for lane, lr in lane_recs.items():
        if "error" in lr:
            printer(f"{lane:14s} ERROR {lr['error'][:80]}")
            continue
        printer(f"{lane:14s} {lr['ms_per_iter']:9.3f} {lr['mp_per_s_per_chip']:11.0f}")
    for e in eligibility:
        printer(f"  stage {e['ops']} halo={e['halo']}: "
                + ("megakernel" if e["reject"] is None else f"fallback ({e['reject']})"))
    if speedup is not None:
        printer(f"fused-pallas {speedup:.2f}x vs the fused walker"
                + (" (plain versions on the CPU: a gate record, not a speed claim)"
                   if rec["interpret_mode"] else ""))
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def mxu_fused_ab_params(device=None) -> dict:
    """The in-stage tensor-core A/B knobs: a three-stencil chain mixing a
    separable Gaussian, a dense 3x3 and a wide box (every op int8-provable)
    at 8K on a card, a CPU-sized shape otherwise. Env overrides:
    MCIM_MXU_FUSED_AB_OPS/_HEIGHT/_WIDTH."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "gaussian:5,sharpen,box:5",
        "height": 4320 if on_card else 256,
        "width": 7680 if on_card else 384,
    }, (("MCIM_MXU_FUSED_AB_OPS", "ops", str), ("MCIM_MXU_FUSED_AB_HEIGHT", "height", int),
        ("MCIM_MXU_FUSED_AB_WIDTH", "width", int)))


def mxu_fused_ab_lanes(pipe: Pipeline, dev) -> dict[str, Callable]:
    """mxu_fused_ab's lanes: `off` the golden chain; one K4 stage with every
    in-stage op on the VPU arm (`fused_vpu`), on K5 bf16 (`fused_mxu`,
    setting 'f32') and on K5 int8 where proven (`fused_mxu_int8`, setting
    'on', which is what the JAX package's 'int8' setting resolves to); the
    whole-op banded products (`mxu_whole_op`)."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import pipeline_mxu
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda

    plan_vpu = build_plan(pipe.ops, "fused-pallas")
    plan_mxu = build_plan(pipe.ops, "fused-pallas-mxu")
    return {
        "off": pipe.jit("torch", device=dev, plan="off"),
        "fused_vpu": plan_callable_cuda(plan_vpu, mxu_stage="off"),
        "fused_mxu": plan_callable_cuda(plan_mxu, mxu_stage="f32"),
        "fused_mxu_int8": plan_callable_cuda(plan_mxu, mxu_stage="on"),
        "mxu_whole_op": lambda x: pipeline_mxu(pipe.ops, x),
    }


def run_mxu_fused_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """The tensor-core-inside-the-megakernel bench lane: one fused stage,
    the executions of `mxu_fused_ab_lanes`, all gated byte-identical to the
    golden chain on three odd shapes before any timing; the record reports
    each op's resolved in-stage arm so a silently ineligible run is
    visible. On the CPU the kernel lanes run their plain versions."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import mxu_int8_ok, stage_arm_for

    dev = resolve_device(device)
    p = mxu_fused_ab_params(dev)
    pipe = Pipeline.parse(p["ops"])
    lanes = mxu_fused_ab_lanes(pipe, dev)
    _gate("mxu_fused_ab", pipe, lanes, 1, dev)
    img = _gate_image(p["height"], p["width"], 1, 99, dev)
    mp = p["height"] * p["width"] / 1e6
    hbm_bytes = 2 * p["height"] * p["width"]  # one u8 read + one u8 write
    arms = {
        op.name: {"arm": stage_arm_for(op, width=p["width"], setting="on", device=dev),
                  "int8_proven": mxu_int8_ok(op)}
        for op in pipe.ops
    }

    def extra(lane, sec):
        lr = {"mp_per_s_per_chip": mp / sec, "hbm_gb_s_model": hbm_bytes / sec / 1e9}
        _roofline(lr, dev, hbm_bytes, sec)
        return lr

    lane_recs = _time_lanes(lanes, img, extra)
    ok = {k: v for k, v in lane_recs.items() if "error" not in v}

    def _speedup(a: str, b: str):  # lane a over lane b (>1: a faster)
        if a in ok and b in ok:
            return ok[b]["ms_per_iter"] / ok[a]["ms_per_iter"]
        return None

    mxu_lanes = [k for k in ("fused_mxu", "fused_mxu_int8") if k in ok]
    best_mxu = min(mxu_lanes, key=lambda k: ok[k]["ms_per_iter"]) if mxu_lanes else None
    rec = {
        "config": MXU_FUSED_AB,
        "pipeline": p["ops"],
        "impl": "mxu_fused_ab",
        "platform": _platform(dev),
        "interpret_mode": dev.type != "cuda",
        "height": p["height"],
        "width": p["width"],
        "bit_exact_gate": "passed (3 shapes x 5 lanes vs golden)",
        "lanes": lane_recs,
        "stage_arms": arms,
        "best_mxu_lane": best_mxu,
        "speedup_fused_mxu_vs_fused_vpu": _speedup(best_mxu, "fused_vpu") if best_mxu else None,
        "speedup_fused_mxu_f32_vs_fused_vpu": _speedup("fused_mxu", "fused_vpu"),
        "speedup_fused_mxu_int8_vs_f32": _speedup("fused_mxu_int8", "fused_mxu"),
        "speedup_fused_mxu_vs_whole_op": (_speedup(best_mxu, "mxu_whole_op")
                                          if best_mxu else None),
    }
    if dev.type == "cuda":
        rec["device_kind"] = device_kind(dev)
    printer(f"{'lane':15s} {'ms/iter':>9s} {'MP/s/chip':>11s} {'roofline':>9s}")
    for lane, lr in lane_recs.items():
        if "error" in lr:
            printer(f"{lane:15s} ERROR {lr['error'][:80]}")
            continue
        rl = f"{lr['roofline_frac'] * 100:8.1f}%" if "roofline_frac" in lr else f"{'-':>9s}"
        printer(f"{lane:15s} {lr['ms_per_iter']:9.3f} {lr['mp_per_s_per_chip']:11.0f} {rl}")
    for name, a in arms.items():
        printer(f"  op {name}: arm={a['arm']}" + (" (int8 proven)" if a["int8_proven"] else ""))
    sp = rec["speedup_fused_mxu_vs_fused_vpu"]
    if sp is not None:
        printer(f"fused-mxu ({best_mxu}) {sp:.2f}x vs fused-vpu"
                + (" (plain versions on the CPU: a gate record, not a speed claim)"
                   if rec["interpret_mode"] else ""))
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def tune_convergence_params(device=None) -> dict:
    """The autotune-convergence lane knobs: the pointwise-heavy headline
    chain, serving-bucket sized. Env overrides:
    MCIM_TUNE_CONV_OPS/_HEIGHT/_WIDTH."""
    on_card = is_cuda_device(device)
    return _override({
        "ops": "grayscale,contrast:3.5,gaussian:5,quantize:6",
        "height": 2160 if on_card else 384,
        "width": 3840 if on_card else 384,
        "channels": 3,
        "batch": 4,
    }, (("MCIM_TUNE_CONV_OPS", "ops", str), ("MCIM_TUNE_CONV_HEIGHT", "height", int),
        ("MCIM_TUNE_CONV_WIDTH", "width", int)))


def run_tune_convergence(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Online-autotuning convergence lane (tune/): the real control loop
    (TuneController + CanaryGate + OnlineStore) driven by real dispatch
    timings through the real serving functions, in one process: wall time
    and dispatches from "pinned to plan off, empty store" until the
    controller has explored `plan:fused` through the canary gate (shadow
    comparisons against the incumbent's outputs) and promoted it; then the
    tuned and pinned functions' throughput. Byte equality is gated before
    any timing."""
    import time as _time

    from mpi_cuda_imagemanipulation_tpu_torch.fabric.canary import (
        CANARY,
        CanaryConfig,
        CanaryGate,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
    from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import pipeline_fingerprint
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import make_serving_fn
    from mpi_cuda_imagemanipulation_tpu_torch.tune.controller import TuneConfig, TuneController
    from mpi_cuda_imagemanipulation_tpu_torch.tune.store import OnlineStore

    dev = resolve_device(device)
    p = tune_convergence_params(dev)
    pipe = Pipeline.parse(p["ops"])
    B, H, W, C = p["batch"], p["height"], p["width"], p["channels"]
    fp = pipeline_fingerprint(pipe.ops)
    fns = {arm: make_serving_fn(pipe, H, W, C, B, plan=mode, device=dev)
           for arm, mode in (("plan:off", "off"), ("plan:fused", "fused"))}
    imgs = torch.from_numpy(np.stack(
        [synthetic_image(H, W, channels=C, seed=7 + i) for i in range(B)])).to(dev)
    th = torch.full((B,), H - 9, dtype=torch.int32, device=dev)
    tw = torch.full((B,), W - 5, dtype=torch.int32, device=dev)

    # -- byte-exactness gate before any timing (and the first calls) -----
    outs = {arm: _host(fn(imgs, th, tw)) for arm, fn in fns.items()}
    if not np.array_equal(outs["plan:off"], outs["plan:fused"]):
        raise AssertionError("tune_convergence gate: fused output mismatches --plan off")

    gate = CanaryGate(CanaryConfig(frac=0.25, min_requests=8, shadow_every=4,
                                   promote_requests=16))
    canary_arm: dict = {"arm": None}

    def deploy(flip: dict) -> None:
        argv = flip["argv"]
        canary_arm["arm"] = "plan:" + argv[argv.index("--plan") + 1]
        gate.start("bench", flip)

    store = OnlineStore()  # in memory unless MCIM_TUNE arms persistence
    ctl = TuneController(
        gate=gate, deploy=deploy, pipe_fp=fp, current_arm="plan:off",
        arms=("plan:off", "plan:fused"), registry=Registry(), store=store,
        config=TuneConfig(tick_s=0.05, min_samples=6, explore_c=0.35, min_gain=1.02,
                          flip_timeout_s=600.0),
    )
    decisions: dict[str, int] = {}
    shadow_checks = 0
    max_iters = 3000
    iters = 0
    t0 = _time.perf_counter()
    while ctl.current_arm != "plan:fused" and iters < max_iters:
        iters += 1
        lane_arm, lane = ctl.current_arm, "stable"
        if gate.state == CANARY and gate.take_canary():
            lane_arm, lane = canary_arm["arm"], "canary"
        t1 = _time.perf_counter()
        out = fns[lane_arm](imgs, th, tw)
        _sync(out)
        dt = _time.perf_counter() - t1
        store.record_dispatch(fp, W, lane_arm, dt / B)
        if gate.state == CANARY:
            gate.record(lane, True)
            if lane == "canary" and gate.take_shadow():
                ref = _host(fns[ctl.current_arm](imgs, th, tw))
                shadow_checks += 1
                gate.record_shadow(np.array_equal(_host(out), ref))
        d = ctl.tick()
        decisions[d] = decisions.get(d, 0) + 1
    converge_s = _time.perf_counter() - t0
    if ctl.current_arm != "plan:fused":
        raise AssertionError(
            f"tune_convergence: not converged after {iters} dispatches: {ctl.status()}")

    # -- the banked payoff: tuned throughput vs the pinned baseline ------
    mp = B * int(th[0]) * int(tw[0]) / 1e6
    tuned_sec = device_throughput(fns[ctl.current_arm], [imgs, th, tw])
    pinned_sec = device_throughput(fns["plan:off"], [imgs, th, tw])
    rec = {
        "config": TUNE_CONVERGENCE,
        "pipeline": p["ops"],
        "impl": "tune_convergence",
        "platform": _platform(dev),
        "height": H,
        "width": W,
        "channels": C,
        "batch": B,
        "bit_exact_gate": "passed (fused vs --plan off on the bench batch)",
        "converge_s": converge_s,
        "iters_to_converge": iters,
        "shadow_checks": shadow_checks,
        "decisions": decisions,
        "tuned_arm": ctl.current_arm,
        "tuned_ms_per_iter": tuned_sec * 1e3,
        "tuned_mp_per_s_per_chip": mp / tuned_sec,
        "pinned_off_ms_per_iter": pinned_sec * 1e3,
        "pinned_off_mp_per_s_per_chip": mp / pinned_sec,
        "speedup_tuned_vs_pinned_off": pinned_sec / tuned_sec,
    }
    if dev.type == "cuda":
        rec["device_kind"] = device_kind(dev)
    printer(f"tune_convergence: converged to {ctl.current_arm} in {converge_s:.1f}s / "
            f"{iters} dispatches ({shadow_checks} shadow checks, decisions {decisions})")
    printer(f"tuned {rec['tuned_ms_per_iter']:.3f} ms/iter vs pinned off "
            f"{rec['pinned_off_ms_per_iter']:.3f} ms/iter -> "
            f"{rec['speedup_tuned_vs_pinned_off']:.2f}x banked")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def serve_loadgen_params(device=None) -> dict:
    """The serving-lane knobs, sized to the device: the CPU keeps the sweep
    small; a card gets serving-sized buckets and offered loads (env:
    MCIM_SERVE_RPS as a comma list, MCIM_SERVE_DURATION_S,
    MCIM_SERVE_FAULT_RATE)."""
    on_card = is_cuda_device(device)
    params = {
        "ops": "grayscale,contrast:3.5,emboss:3",
        "buckets": (((512, 512), (1024, 1024), (2048, 2048)) if on_card
                    else ((64, 64), (128, 128))),
        "max_batch": 8,
        "max_delay_ms": 4.0,
        "queue_depth": 256,
        # the last rate must exceed the single-dispatch service rate so
        # queueing (and hence coalescing) shows in the occupancy column
        "offered_rps": (64.0, 256.0, 1024.0) if on_card else (50.0, 200.0, 800.0),
        "duration_s": 4.0 if on_card else 1.5,
        "n_images": 48,
        # availability lane: this transient dispatch-failure rate
        # (serve.dispatch failpoint); 0 = fault-free latency sweep
        "fault_rate": 0.0,
    }
    rps_env = env_registry.get("MCIM_SERVE_RPS")
    if rps_env:
        params["offered_rps"] = tuple(float(t) for t in rps_env.split(",") if t.strip())
    dur_env = env_registry.get("MCIM_SERVE_DURATION_S")
    if dur_env:
        params["duration_s"] = float(dur_env)
    fault_env = env_registry.get("MCIM_SERVE_FAULT_RATE")
    if fault_env:
        params["fault_rate"] = float(fault_env)
    return params


def run_serve_loadgen(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    fault_rate: float | None = None,
    device=None,
) -> dict:
    """The online-serving bench lane: a ServeApp on `device`, an open-loop
    offered-load sweep, throughput against latency percentiles plus the
    batch-occupancy curve (serve/loadgen.py). With `fault_rate` the sweep
    runs with that injected transient dispatch-failure rate."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeApp, ServeConfig

    dev = resolve_device(device)
    p = serve_loadgen_params(dev)
    if fault_rate is not None:
        p["fault_rate"] = fault_rate
    # MCIM_TRACE_OUT: run the sweep traced and export the span timeline
    trace_out = env_registry.get("MCIM_TRACE_OUT")
    if trace_out:
        obs_trace.configure(sample=float(env_registry.get(obs_trace.ENV_SAMPLE) or "1.0"))
    app = ServeApp(ServeConfig(
        ops=p["ops"], buckets=p["buckets"], max_batch=p["max_batch"],
        max_delay_ms=p["max_delay_ms"], queue_depth=p["queue_depth"], channels=(3,),
        device=str(dev),
    )).start()
    try:
        sweep = loadgen.sweep(app, offered_rps=p["offered_rps"], duration_s=p["duration_s"],
                              n_images=p["n_images"], fault_rate=p["fault_rate"])
    finally:
        app.stop(drain=True)
    rec = {
        "config": SERVE_LOADGEN,
        "pipeline": p["ops"],
        "impl": "torch",
        "platform": _platform(dev),
        "buckets": [f"{h}x{w}" for h, w in p["buckets"]],
        "max_batch": p["max_batch"],
        "max_delay_ms": p["max_delay_ms"],
        "queue_depth": p["queue_depth"],
        "fault_rate": p["fault_rate"],
        "cache": app.cache.stats(),
        "sweep": sweep,
    }
    if trace_out:
        rec["trace_out"] = trace_out
        rec["trace_events"] = obs_trace.export(trace_out)
    printer(f"{'offered rps':>11s} {'achieved':>9s} {'ok%':>6s} {'shed%':>6s} "
            f"{'retry%':>6s} {'occup':>6s} {'p50 ms':>8s} {'p95 ms':>8s} {'p99 ms':>8s}")
    for s in sweep:
        ex = s.get("p99_exemplar")
        printer(
            f"{s['offered_rps']:11.0f} {s['achieved_rps']:9.1f} "
            f"{s['ok_frac'] * 100:5.1f}% {s['shed_frac'] * 100:5.1f}% "
            f"{s.get('retried_frac', 0.0) * 100:5.1f}% "
            f"{s.get('mean_batch_occupancy') or 0:6.2f} "
            f"{s.get('e2e_p50_ms', float('nan')):8.2f} "
            f"{s.get('e2e_p95_ms', float('nan')):8.2f} "
            f"{s.get('e2e_p99_ms', float('nan')):8.2f}"
            + (f"  p99~{ex['trace_id']}" if ex else "")
        )
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def graph_loadgen_params(device=None) -> dict:
    """The pipeline-service lane knobs, sized to the device. The tenant
    count cycles the QoS classes (interactive/standard/batch). Overrides:
    MCIM_GRAPH_TENANTS / the `tenants` argument."""
    on_card = is_cuda_device(device)
    params = {
        # a pointwise-heavy linear chain: the SAME workload runs as the
        # baked-in chain path and as a registered degenerate-DAG spec
        "ops": "grayscale,contrast:3.5,gaussian:5",
        "buckets": ((512, 512), (1024, 1024)) if on_card else ((64, 64), (96, 96)),
        "max_batch": 8 if on_card else 4,
        "max_delay_ms": 4.0,
        "queue_depth": 64,
        "offered_rps": 512.0 if on_card else 120.0,
        "duration_s": 3.0 if on_card else 1.5,
        "tenants": 3,
        "n_images": 8,
    }
    raw = env_registry.get("MCIM_GRAPH_TENANTS")
    if raw:
        params["tenants"] = int(raw)
    return params


def run_graph_loadgen(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    tenants: int | None = None,
    device=None,
    outputs: dict | None = None,
) -> dict:
    """The pipeline-service bench lane (graph/): ONE serving stack over real
    HTTP, the same linear chain down both doors (``chain``: the baked-in
    `--ops` path; ``dag``: the chain registered as a degenerate-DAG spec
    and served by pipeline id), gated byte-identical before timing, then
    measured under the same offered load, with a multi-tenant QoS mix.
    `outputs`, when given, receives the gate's decoded responses by image
    index."""
    import json as _json
    import urllib.request

    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig, Server

    dev = resolve_device(device)
    p = graph_loadgen_params(dev)
    if tenants is not None:
        p["tenants"] = tenants
    qos_cycle = ("interactive", "standard", "batch")
    with Server(ServeConfig(ops=p["ops"], buckets=p["buckets"], max_batch=p["max_batch"],
                            max_delay_ms=p["max_delay_ms"], queue_depth=p["queue_depth"],
                            channels=(3,), device=str(dev)), port=0) as srv:
        url = f"http://127.0.0.1:{srv.address[1]}"

        def post_json(path: str, payload: dict) -> dict:
            req = urllib.request.Request(url + path, data=_json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                return _json.loads(resp.read())

        tenant_ids = [f"t{i}" for i in range(max(1, p["tenants"]))]
        for i, tid in enumerate(tenant_ids):
            post_json("/v1/tenants", {"tenant": tid, "qos": qos_cycle[i % len(qos_cycle)]})
            reg = post_json("/v1/pipelines", {"tenant": tid, "spec": chain_as_spec(p["ops"])})
        pid = reg["pipeline"]

        min_dim = max(op.halo for op in Pipeline.parse(p["ops"]).ops) + 1
        images = loadgen.mixed_shapes(p["buckets"], p["n_images"], channels=3, seed=11,
                                      min_dim=min_dim)
        blobs = [bytes(loadgen.encode_blob(im)) for im in images]

        # -- byte-exactness gate BEFORE any timing ---------------------
        hdrs = {"X-MCIM-Tenant": tenant_ids[0], "X-MCIM-Pipeline": pid}
        for k in range(min(3, len(blobs))):
            chain_r = loadgen.http_post_image(url, blobs[k])
            dag_r = loadgen.http_post_image(url, blobs[k], headers=hdrs)
            if chain_r["code"] != 200 or dag_r["code"] != 200:
                raise AssertionError(f"graph_loadgen gate: image {k} answered "
                                     f"{chain_r['code']}/{dag_r['code']}")
            if chain_r["body"] != dag_r["body"]:
                raise AssertionError(f"graph_loadgen gate: DAG response for image {k} is not "
                                     "byte-identical to the chain path")
            if outputs is not None:
                outputs[k] = decode_image_bytes(chain_r["body"])

        # -- the two lanes under the same offered load -----------------
        chain_rec = loadgen.http_run_offered_load(url, blobs, p["offered_rps"], p["duration_s"])
        chain_rec.pop("results", None)
        dag_rec = loadgen.multi_tenant_run(
            url, [{"tenant": tenant_ids[0], "blobs": blobs, "headers": hdrs}],
            p["offered_rps"], p["duration_s"])[tenant_ids[0]]

        # -- the multi-tenant QoS mix ----------------------------------
        lanes = [{"tenant": tid, "blobs": blobs,
                  "headers": {"X-MCIM-Tenant": tid, "X-MCIM-Pipeline": pid}}
                 for tid in tenant_ids]
        mix = loadgen.multi_tenant_run(url, lanes, p["offered_rps"], p["duration_s"])
        graph_stats = srv.app.graph_service.stats()
    rec = {
        "config": GRAPH_LOADGEN,
        "pipeline": p["ops"],
        "impl": "graph_loadgen",
        "platform": _platform(dev),
        "buckets": [f"{h}x{w}" for h, w in p["buckets"]],
        "offered_rps": p["offered_rps"],
        "duration_s": p["duration_s"],
        "pipeline_id": pid,
        "bit_exact_gate": "passed (3 images, DAG bytes == chain bytes)",
        "lanes": {"chain": chain_rec, "dag": dag_rec},
        "tenants": {tid: {"qos": qos_cycle[i % len(qos_cycle)], **mix[tid]}
                    for i, tid in enumerate(tenant_ids)},
        "cache_entries": sum(t["cache_entries"] for t in graph_stats["tenants"].values()),
    }
    printer(f"{'lane':14s} {'ok%':>6s} {'shed%':>6s} {'achieved':>9s} "
            f"{'p50 ms':>8s} {'p99 ms':>8s}")

    def _row(name: str, r: dict) -> str:
        return (f"{name:14s} {r['ok_frac'] * 100:5.1f}% {r['shed_frac'] * 100:5.1f}% "
                f"{r['achieved_rps']:9.1f} {r.get('e2e_p50_ms', float('nan')):8.2f} "
                f"{r.get('e2e_p99_ms', float('nan')):8.2f}")

    printer(_row("chain", chain_rec))
    printer(_row("dag", dag_rec))
    for i, tid in enumerate(tenant_ids):
        printer(_row(f"{tid}/{qos_cycle[i % len(qos_cycle)][:5]}", mix[tid]))
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


def systolic_ab_params(device=None) -> dict:
    """The pod-level systolic A/B knobs: a chain long enough that
    stage-sharding it across two replicas is a real structural change (8
    per-op steps), every op streamable and channel-preserving. Env
    overrides: MCIM_SYSTOLIC_AB_OPS/_REQUESTS/_HEIGHT."""
    on_card = is_cuda_device(device)
    params = _override({
        "ops": "invert,gaussian:3,sharpen,box:3,quantize:6,gaussian:5,posterize:4,median",
        "height": 1024 if on_card else 72,
        "requests": 64 if on_card else 16,
        "channels": "3",
        "max_batch": 4,
        "max_delay_ms": 2.0,
        "queue_depth": 64,
        "heartbeat_s": 0.2,
        "device": str(torch.device("cuda" if device is None else device)),
    }, (("MCIM_SYSTOLIC_AB_OPS", "ops", str), ("MCIM_SYSTOLIC_AB_REQUESTS", "requests", int),
        ("MCIM_SYSTOLIC_AB_HEIGHT", "height", int)))
    params["width"] = params["height"]
    params["buckets"] = str(params["height"])
    return params


def run_systolic_ab(
    *,
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    device=None,
) -> dict:
    """The pod-level systolic bench lane: the SAME >= 8-stage DAG through
    two 2-replica pods, started together and driven one after the other,
    ``systolic`` (the router stage-shards the program
    across both replicas, the live env streaming replica to replica) and
    ``pinned`` (each request on one replica), gated byte-identical before
    timing against the in-process golden executor, then measured closed
    loop; the federated mcim_systolic_tiles_forwarded_total must read
    EXACTLY requests x stage boundaries."""
    import json as _json
    import time as _time
    import urllib.request

    from mpi_cuda_imagemanipulation_tpu_torch.graph import compile_graph, graph_callable, parse_spec
    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    dev = resolve_device(device)
    p = systolic_ab_params(dev)
    spec = chain_as_spec(p["ops"])
    n_steps = len(p["ops"].split(","))
    img = synthetic_image(p["height"], p["width"], channels=3, seed=23)
    blob = bytes(loadgen.encode_blob(img))
    golden = _host(graph_callable(compile_graph(parse_spec(spec)))(
        torch.from_numpy(img).to(dev))["image"])

    def counter(fams: dict, name: str) -> float:
        fam = fams.get(name)
        return sum(fam["samples"].values()) if fam else 0.0

    def run_lane(fab: _FabricProc, systolic: bool) -> tuple[dict, bytes, dict]:
        fab.wait_routable(2)
        if systolic:
            # placement needs BOTH replicas advertising stage ownership
            # before the first dispatch
            deadline = _time.monotonic() + 60.0
            while _time.monotonic() < deadline:
                reps = fab.stats()["replicas"]
                if sum(1 for r in reps.values() if r["fresh"] and r["systolic"]) >= 2:
                    break
                _time.sleep(0.2)
        req = urllib.request.Request(
            fab.url + "/v1/pipelines",
            data=_json.dumps({"tenant": "acme", "spec": spec}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            pid = _json.loads(resp.read())["pipeline"]
        hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}

        # -- byte-exactness gate BEFORE any timing (and the warmup) -
        n_sent = 0
        deadline = _time.monotonic() + 120.0
        while True:
            gate = loadgen.http_post_image(fab.url, blob, headers=hdrs)
            n_sent += 1
            if gate["code"] == 200:
                break
            if _time.monotonic() > deadline:
                raise AssertionError(
                    f"systolic_ab gate: lane {'systolic' if systolic else 'pinned'} never "
                    f"answered 200 (last {gate['code']})")
            _time.sleep(0.2)
        np.testing.assert_array_equal(
            decode_image_bytes(gate["body"]), golden,
            err_msg="systolic_ab gate: response is not byte-exact against the in-process "
            "golden executor")
        if systolic:
            pl = fab.stats()["systolic"]["placements"].get(pid)
            if not pl or len(pl["ranges"]) < 2:
                raise AssertionError(f"systolic_ab: program was never stage-sharded "
                                     f"(placement {pl})")
            if len(set(pl["owners"])) < 2:
                raise AssertionError(f"systolic_ab: both ranges landed on one replica "
                                     f"({pl['owners']})")
        else:
            pl = None

        # -- the timed closed loop ---------------------------------
        results = []
        t0 = _time.monotonic()
        for _ in range(p["requests"]):
            r = loadgen.http_post_image(fab.url, blob, headers=hdrs)
            if r["code"] == 200 and r["body"] != gate["body"]:
                raise AssertionError("systolic_ab: a response drifted mid-run")
            results.append((0, r))
            n_sent += 1
        wall = _time.monotonic() - t0
        rec = loadgen.summarize_http_results(results, wall,
                                             len(results) / wall if wall else 0.0)

        extras: dict = {}
        if systolic:
            # exactly one transport forward per stage boundary, for
            # EVERY request this lane sent (gate included)
            boundaries = len(pl["ranges"]) - 1
            expect = n_sent * boundaries
            deadline = _time.monotonic() + 60.0
            while True:
                with urllib.request.urlopen(fab.url + "/metrics", timeout=10.0) as resp:
                    fams = parse_exposition(resp.read().decode())
                forwards = counter(fams, "mcim_systolic_tiles_forwarded_total")
                if forwards >= expect:
                    break
                if _time.monotonic() > deadline:
                    raise AssertionError(
                        f"systolic_ab: {forwards:.0f} transport forwards for {n_sent} "
                        f"requests x {boundaries} boundaries: some requests fell back "
                        "mid-measurement")
                _time.sleep(0.2)
            if forwards != expect:
                raise AssertionError(f"systolic_ab: {forwards:.0f} forwards != {n_sent} "
                                     f"requests x {boundaries} boundaries")
            extras = {
                "placement": pl,
                "requests_sent": n_sent,
                "stage_boundaries": boundaries,
                "forwards": forwards,
                "forwards_per_request": forwards / n_sent,
                "exchange_bytes_per_request": counter(
                    fams, "mcim_systolic_exchange_bytes_total") / n_sent,
            }
        return rec, gate["body"], extras

    # both pods start at once, so that their start-ups overlap; each is
    # driven alone
    with _FabricProc(p, 2, extra_args=("--systolic",)) as sys_fab, _FabricProc(p, 2) as pin_fab:
        sys_rec, sys_body, sys_extras = run_lane(sys_fab, True)
        pin_rec, pin_body, _ = run_lane(pin_fab, False)
    if sys_body != pin_body:
        raise AssertionError("systolic_ab: systolic and pinned response bytes differ: the "
                             "cross-replica handoff is NOT lossless")
    speedup = (sys_rec["achieved_rps"] / pin_rec["achieved_rps"]
               if pin_rec["achieved_rps"] else None)
    rec = {
        "config": SYSTOLIC_AB,
        "pipeline": p["ops"],
        "impl": "systolic_ab",
        "platform": _platform(dev),
        "height": p["height"],
        "width": p["width"],
        "requests": p["requests"],
        "stages": n_steps,
        "bit_exact_gate": "passed (systolic bytes == pinned bytes == in-process golden)",
        "lanes": {"systolic": sys_rec, "pinned": pin_rec},
        **sys_extras,
        "speedup_systolic_vs_pinned": speedup,
    }
    printer(f"{'lane':10s} {'ok%':>6s} {'req/s':>8s} {'p50 ms':>8s} {'p99 ms':>8s}")
    for name, lr in (("systolic", sys_rec), ("pinned", pin_rec)):
        printer(f"{name:10s} {lr['ok_frac'] * 100:5.1f}% {lr['achieved_rps']:8.1f} "
                f"{lr.get('e2e_p50_ms', float('nan')):8.2f} "
                f"{lr.get('e2e_p99_ms', float('nan')):8.2f}")
    pl = sys_extras["placement"]
    printer(f"placed {pl['ranges']} on {pl['owners']} ({pl['source']}); "
            f"{sys_extras['forwards']:.0f} forwards / {sys_extras['requests_sent']} requests == "
            f"{sys_extras['stage_boundaries']} per request, "
            f"{sys_extras['exchange_bytes_per_request']:.0f} exchange bytes/request")
    if speedup is not None:
        printer(f"systolic vs pinned: {speedup:.2f}x achieved req/s")
    if json_path:
        emit_json_metrics(rec, None if json_path == "-" else json_path)
    return rec


_LANE_RUNNERS = {
    SERVE_LOADGEN: run_serve_loadgen,
    ENGINE_AB: run_engine_ab,
    MXU_AB: run_mxu_ab,
    FABRIC_LOADGEN: run_fabric_loadgen,
    STREAM_AB: run_stream_ab,
    PLAN_AB: run_plan_ab,
    MEGAKERNEL_AB: run_megakernel_ab,
    MXU_FUSED_AB: run_mxu_fused_ab,
    GRAPH_LOADGEN: run_graph_loadgen,
    SYSTOLIC_AB: run_systolic_ab,
    FEDERATION_LOADGEN: run_federation_loadgen,
    TUNE_CONVERGENCE: run_tune_convergence,
}


def run_suite(
    names: Sequence[str] | None = None,
    *,
    impl: str = "both",
    json_path: str | None = None,
    printer: Callable[[str], None] = print,
    halo_mode: str | None = None,
    device=None,
    n_shards: int | None = None,
) -> list[dict]:
    """The named configs and lanes (default: every config) on `device`: the
    lanes first, each on the side (a lane measures a structure, not one
    function), then each config at each impl (`both`: torch then cuda), a
    failing one logged and skipped so that the suite goes on. Sharded
    configs run over `bench_mesh(n_shards, device)`."""
    log = get_logger()
    dev = resolve_device(device)
    impls = ("torch", "cuda") if impl == "both" else (impl,)
    records: list[dict] = []
    if names:
        for lane in [n for n in _LANE_RUNNERS if n in names]:
            records.append(_LANE_RUNNERS[lane](json_path=json_path, printer=printer, device=dev))
        names = [n for n in names if n not in _LANE_RUNNERS]
        if not names:
            return records
        unknown = [n for n in names if n not in CONFIGS]
        if unknown:
            raise ValueError(f"unknown bench config(s) {unknown}; known: "
                             f"{sorted(CONFIGS) + sorted(_LANE_RUNNERS)}")
        selected = [CONFIGS[n] for n in names]
    else:
        selected = list(CONFIGS.values())
    if halo_mode is not None:  # CLI override for A/B runs
        selected = [dataclasses.replace(c, halo_mode=halo_mode) if c.sharded else c
                    for c in selected]
    printer(f"{'config':28s} {'impl':7s} {'chips':>5s} {'ms/iter':>9s} "
            f"{'MP/s':>10s} {'MP/s/chip':>10s} {'roofline':>9s}")
    for cfg in selected:
        for im in impls:
            try:
                rec = run_config(cfg, im, n_shards=n_shards, device=dev)
            except Exception as e:  # keep the suite running past one failure
                log.warning("config %s impl %s failed: %s", cfg.name, im, e)
                continue
            records.append(rec)
            rl = (f"{rec['roofline_frac'] * 100:8.1f}%" if "roofline_frac" in rec
                  else f"{'-':>9s}")
            printer(f"{rec['config']:28s} {rec['impl']:7s} {rec['chips']:5d} "
                    f"{rec['ms_per_iter']:9.3f} {rec['mp_per_s']:10.0f} "
                    f"{rec['mp_per_s_per_chip']:10.0f} {rl}"
                    + (" host-bound" if rec.get("host_bound") else ""))
            if json_path:
                emit_json_metrics(rec, None if json_path == "-" else json_path)
    return records


def headline_record(records: list[dict]) -> dict | None:
    """The BASELINE.json headline: the best MP/s a card on the 8K 5x5
    Gaussian. The single-card and the row-sharded run both qualify; the
    record names which impl and card count won."""
    cands = [r for r in records if r["config"] in (HEADLINE, HEADLINE + "_sharded")]
    if not cands:
        return None
    best = max(cands, key=lambda r: r["mp_per_s_per_chip"])
    rec = {
        "metric": "megapixels/sec/chip on 8K 5x5 Gaussian",
        "value": round(best["mp_per_s_per_chip"], 1),
        "unit": "MP/s/chip",
        "impl": best["impl"],
        "chips": best["chips"],
        "platform": best.get("platform"),
    }
    if "elem_ceiling_frac" in best:
        rec["ceiling_frac"] = round(best["elem_ceiling_frac"], 4)
        rec["ceiling_basis"] = ("measured u8 compute-kernel element rate "
                                "(bench_suite.ELEM_G_S_MEASURED)")
    rec["vs_baseline"] = round(best["mp_per_s_per_chip"] / REFERENCE_BASELINE_MP_S_PER_CHIP, 2)
    if "roofline_frac" in best:
        rec["roofline_frac"] = round(best["roofline_frac"], 4)
        rec["device_kind"] = best.get("device_kind")
    if "elem_ceiling_frac" in best:
        rec["elem_ceiling_frac"] = round(best["elem_ceiling_frac"], 4)
    return rec


def main(argv: Sequence[str] | None = None) -> int:
    """Single-config worker: run ONE (config, impl) or lane in this process
    and print exactly one JSON line."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="bench_suite")
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS) + sorted(_LANE_RUNNERS))
    ap.add_argument("--impl", default="cuda", choices=IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--halo-mode", default=None, choices=("serial", "overlap"),
                    help="override the config's sharded halo execution mode")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh slots for sharded configs (default: one per visible card)")
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="serve_loadgen only: inject this transient dispatch-failure rate "
                    "(env MCIM_SERVE_FAULT_RATE works too)")
    ap.add_argument("--inflight", type=int, default=None,
                    help="engine_ab only: overlapped-lane dispatch depth "
                    "(env MCIM_ENGINE_AB_INFLIGHT works too)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="fabric_loadgen only: scaled-lane replica count "
                    "(env MCIM_FABRIC_REPLICAS works too)")
    ap.add_argument("--tile-rows", type=int, default=None,
                    help="stream_ab only: streamed-lane tile height "
                    "(env MCIM_STREAM_AB_TILE_ROWS works too)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="graph_loadgen only: multi-tenant mix size "
                    "(env MCIM_GRAPH_TENANTS works too)")
    ap.add_argument("--json-metrics", default=None,
                    help="also write the record to this path ('-' = stdout); the one JSON "
                    "line always goes to stdout")
    args = ap.parse_args(argv)
    quiet = lambda s: None  # noqa: E731
    dev = resolve_device(args.device)
    extra = {
        SERVE_LOADGEN: {"fault_rate": args.fault_rate},
        FABRIC_LOADGEN: {"replicas": args.replicas},
        ENGINE_AB: {"inflight": args.inflight},
        STREAM_AB: {"tile_rows": args.tile_rows},
        GRAPH_LOADGEN: {"tenants": args.tenants},
    }
    if args.config in _LANE_RUNNERS:
        rec = _LANE_RUNNERS[args.config](printer=quiet, device=dev,
                                         **extra.get(args.config, {}))
    else:
        cfg = CONFIGS[args.config]
        if args.halo_mode is not None and cfg.sharded:
            cfg = dataclasses.replace(cfg, halo_mode=args.halo_mode)
        rec = run_config(cfg, args.impl, n_shards=args.shards, device=dev)
    if args.json_metrics and args.json_metrics != "-":
        emit_json_metrics(rec, args.json_metrics)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
