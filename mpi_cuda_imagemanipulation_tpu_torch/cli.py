"""Command line: ``python -m mpi_cuda_imagemanipulation_tpu_torch
run|batch|stream|serve|fabric|graph|autotune|info``.

``run`` applies a pipeline to one image, on the CUDA device by default,
through the hand-written kernels (``--impl auto``, the default, routes
each group as the calibration store's records and the ``MCIM_PREFER_*``
switches say, and with neither runs what ``--impl cuda`` runs), the
tensor-core route
(``--impl mxu``), the SWAR kernels (``--impl swar``) or PyTorch ops
(``--impl torch``), in the execution structure ``--plan`` selects
(models/pipeline.py says what each pair runs). ``--shards N`` row-shards
the image over N devices with ghost-strip exchange (parallel/api.py), and
``--shards RxC`` tile-shards it over a 2-D mesh (parallel/api2d.py); under
``torchrun`` every rank runs the same command and holds its share of the
shards. ``--device-timeout SECS`` runs the computation in a watchdog
subprocess (utils/guard.py) and exits with code 4 when it overruns.
``batch`` runs a pipeline over every image of a directory through the
asynchronous engine (engine/core.py): decode ahead on worker threads
(``io.image.batch_load``, the native codec for PPM/PGM), pinned H2D on a
copy stream, the computation (``Pipeline.jit`` or ``batched`` with
``donate=True``, ``sharded``, ``data_parallel``), pinned D2H on a side
stream, encode and write on a worker pool; a journal makes a killed run
resumable (``--resume``); ``--stream-rows N`` streams each input through
the tile engine instead.
``stream`` runs a pipeline over one image of any height (``--input``, or
``--synthetic HxW[xC]``) or over a video frame sequence
(``--video-frames``) as fixed-height row bands through the streaming tile
engine (stream/): decode, stitch, compute and encode overlap, and the host
holds a few bands whatever the image height; ``--resume`` finishes a
killed run from its journal.
``serve`` is the online front door (serve/): a micro-batching scheduler
over a shape-bucket function cache warmed on the card at start, answering
``POST /v1/process`` (image bytes in, PNG out), ``GET /healthz``,
``/stats`` and ``/metrics``, byte-equal to ``run`` per request; SIGTERM or
SIGINT drains what was admitted under ``--drain-deadline-s``; it also
answers the pipeline service's routes (graph specs per tenant, the
replica half of systolic execution) and ``POST /control/profile``.
``serve --replicas N`` (N > 1) hands over to ``fabric``.
``fabric`` is the pod-scale front door (fabric/): a router over N
supervised replica processes, each the ``serve`` stack on its own device
context (``--device``, default cuda), with heartbeat-driven affinity
routing, rerouting retries, restart with backoff, an optional oversize
mesh lane (``--mesh-shards``), the autoscaler, the tune controller and
the SLO burn-rate engine.
``graph`` validates a pipeline-spec DAG from a file and runs it on one
image (graph/), with its histogram and stats side outputs.
``autotune`` measures the routes of one choice on the card and records
the fastest in the calibration store (utils/calibration.py), which
``--impl auto --plan auto`` then follows; ``autotune info`` prints the
records for a pipeline (``--online``: with the online tuning store's, and
the plan the newest-wins rule picks). ``run --trace-out`` writes the run's
trace spans as Chrome/Perfetto JSON (obs/trace.py), ``run --profile-dir``
a ``torch.profiler`` trace of its calls (obs/profile.py). ``info`` prints the
toolchain, the devices, the backends, the kernels and the calibration
records for the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import REFERENCE_PIPELINE_SPEC
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import PLAN_MODES

# autotune's candidate tile heights: K2's (default 16) and K6-K8's (the
# SWAR picker's TILE_ROWS; default 64)
AUTOTUNE_BLOCKS = {"cuda": "8,16,24,32,48,64", "swar": "8,16,32,64"}
# the plans --impl auto can run, which `autotune --dimension plan` measures
AUTOTUNE_PLANS = ("off", "fused-pallas", "fused-pallas-mxu")


def _add_failpoint_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument(
        "--failpoints", default=None, metavar="SPEC",
        help="arm deterministic fault injection, e.g. 'io.decode=first:2,"
        "halo.exchange=always' (sites and modes: resilience/failpoints.py; "
        "MCIM_FAILPOINTS works too). For testing error paths",
    )
    sp.add_argument(
        "--failpoint-seed", type=int, default=0,
        help="seed for probabilistic failpoint modes (deterministic fail/pass "
        "sequence per site)",
    )


def _arm_failpoints(args: argparse.Namespace) -> None:
    if getattr(args, "failpoints", None):
        from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

        failpoints.configure(args.failpoints, seed=args.failpoint_seed)


def _add_trace_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write the run's trace spans (run, run.load, run.compile_and_run, "
        "run.steady, run.save; sharded.dispatch under --shards) as "
        "Chrome/Perfetto trace-event JSON to this path at exit (obs/trace.py; "
        "load it in ui.perfetto.dev). Under torchrun the rank that holds "
        "slot 0 writes it",
    )
    sp.add_argument(
        "--trace-sample", type=float, default=None, metavar="FRAC",
        help="trace this fraction of traces (deterministic every-k-th; default "
        "1.0 with --trace-out); sampled-out work pays one flag check "
        "(MCIM_TRACE_SAMPLE arms tracing too)",
    )


def _configure_tracing(args: argparse.Namespace) -> bool:
    """Arm the tracer from --trace-out/--trace-sample (or the
    MCIM_TRACE_SAMPLE env). Returns True when armed."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

    sample = getattr(args, "trace_sample", None)
    if getattr(args, "trace_out", None) or sample is not None:
        obs_trace.configure(sample=1.0 if sample is None else sample)
        return True
    return obs_trace.configure_from_env() is not None


def _export_trace(args: argparse.Namespace, log) -> None:
    if getattr(args, "trace_out", None):
        from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

        n = obs_trace.export(args.trace_out)
        log.info("trace: %d events -> %s", n, args.trace_out)


def _positive_float(v: str) -> float:
    f = float(v)
    if f <= 0:
        raise argparse.ArgumentTypeError(f"--device-timeout must be positive, got {v}")
    return f


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_imagemanipulation_tpu_torch",
        description="Image-manipulation pipeline on an NVIDIA GPU (PyTorch + CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run a pipeline on one image")
    run.add_argument("--input", required=True, help="input image path")
    run.add_argument("--output", required=True, help="output image path")
    run.add_argument(
        "--ops",
        default=REFERENCE_PIPELINE_SPEC,
        help="comma-separated pipeline (default: the reference pipeline, "
        "kernel.cu:192-195)",
    )
    run.add_argument(
        "--impl",
        choices=("auto", "cuda", "mxu", "swar", "torch"),
        default="auto",
        help="auto (default): each op group on the route the calibration store "
        "records for it on this card (`autotune`), or MCIM_PREFER_SWAR / "
        "MCIM_PREFER_MXU say, else its hand-written kernel, which is what "
        "cuda runs; "
        "cuda: the hand-written kernels, one launch per op group; "
        "mxu: eligible stencils as banded matrix products (torch.matmul), "
        "the other ops as under cuda; swar: eligible stencils on a gray plane, "
        "with fusable contrast/brightness/invert neighbours, as one launch of "
        "the SWAR kernels K6-K8 (every plan is then 'off'), the other ops as "
        "under cuda; torch: the golden PyTorch ops",
    )
    run.add_argument(
        "--plan",
        choices=PLAN_MODES,
        default="auto",
        help="fusion-planner execution structure: 'off' runs op groups (cuda: "
        "K1/K2 launches; mxu: banded products and K1/K2; torch: the golden "
        "ops op by op); 'pointwise' and 'fused' run the PyTorch stage walker "
        "(torch and mxu); 'fused-pallas' runs each eligible fused stage as "
        "one launch of the megakernel K4 (cuda and mxu; torch runs the "
        "walker); 'fused-pallas-mxu' does the same with every eligible "
        "stencil on K4's tensor-core arm K5 (torch: the walker with K5's "
        "plain version); 'auto' is MCIM_PLAN if set, else the plan the "
        "calibration store records for the pipeline on this card "
        "(`autotune --dimension plan`), else 'off' under auto and cuda and "
        "'fused' under torch and mxu. Byte-identical output in every mode",
    )
    run.add_argument(
        "--device", default="cuda", help="torch device (default cuda; cpu runs the "
        "plain PyTorch versions of the kernels)",
    )
    run.add_argument(
        "--shards", default="1",
        help="shard the image over devices: N row-shards (the mpirun -np "
        "analogue) with ghost-strip halo exchange, or RxC tile-shards over a "
        "2-D rows x cols mesh with the two-phase corner-carrying exchange "
        "(tiles compute with the torch ops: --impl torch or auto); 1 = single "
        "device. With --device cuda the first N (R * C) cards (fewer raise), "
        "with --device cpu that many CPU slots; under torchrun each rank holds "
        "an equal share of the shards",
    )
    run.add_argument(
        "--halo-mode", choices=("serial", "overlap"), default="serial",
        help="sharded halo execution: 'serial' runs every stencil group after "
        "its ghost-strip exchange; 'overlap' computes interior rows while the "
        "strips are in flight and prefetches the next group's exchange "
        "(byte-identical output; no-op without --shards)",
    )
    run.add_argument(
        "--block", type=int, default=None,
        help="row height of the stencil kernels' output tiles: K2 (default 16 "
        "rows) and K4 (default the tallest of 48, 32, 16 rows that fits); "
        "under --impl swar K6-K8 only (default 64 rows, halved to fit and for "
        "small grids). Not given, a block_h record of the calibration store "
        "(`autotune --dimension block`) sets K2's tile under auto and cuda, "
        "and K6-K8's under swar, where it fits",
    )
    run.add_argument(
        "--gray-output", action="store_true",
        help="write single-channel output instead of replicating gray to RGB "
        "(the reference replicates: kernel.cu:210)",
    )
    run.add_argument(
        "--device-timeout", type=_positive_float, default=None, metavar="SECS",
        help="run the device computation in a watchdog subprocess with this "
        "wall-clock budget, so that a wedged device fails fast with a clean "
        "error (exit code 4) instead of hanging the process (the reference "
        "deadlocks its peers on a mid-collective failure, kernel.cu:150). The "
        "budget covers the child's start-up and its first call, which builds "
        "the CUDA kernels with nvcc (tens of seconds) where build/torch_kernels/ "
        "holds no build of the sources yet",
    )
    run.add_argument("--show-timing", action="store_true", help="print timing")
    run.add_argument(
        "--json-metrics", default=None,
        help="write a JSON metrics line to this path ('-' = stdout)",
    )
    run.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="record a torch.profiler trace (CPU operators; on a card also its "
        "kernels and copies) over the first and the steady call, written to "
        "DIR as Chrome JSON (chrome://tracing, ui.perfetto.dev; "
        "obs/profile.summarize reads it). Ignored under --device-timeout",
    )
    _add_failpoint_flags(run)
    _add_trace_flags(run)

    _add_batch_parser(sub)
    _add_stream_parser(sub)
    _add_serve_parser(sub)
    _add_fabric_parser(sub)
    _add_graph_parser(sub)

    tune = sub.add_parser(
        "autotune",
        help="measure the routes of one choice on the card and record the fastest "
        "in the calibration store (utils/calibration.py), which --impl auto and "
        "--plan auto then follow",
    )
    tune.add_argument(
        "action", nargs="?", choices=("run", "info"), default="run",
        help="'run' (default) measures and records; 'info' prints the store's "
        "records for --ops on the device (with --online also the online tuning "
        "store's, and the plan choice the newest-wins rule picks)",
    )
    tune.add_argument(
        "--online", action="store_true",
        help="with 'info': include the online promotion, the per-window arm "
        "statistics and the audit-trail tail (tune/store.py) next to the offline "
        "records",
    )
    tune.add_argument("--ops", default="gaussian:5",
                      help="pipeline to tune against (default gaussian:5)")
    tune.add_argument(
        "--impl", choices=("cuda", "swar"), default="cuda",
        help="--dimension block: whose tile heights, K2's (cuda) or K6-K8's (swar)",
    )
    tune.add_argument(
        "--dimension", choices=("block", "backend", "plan"), default="block",
        help="'block': the stencil kernels' tile heights (--impl, --blocks), the "
        "default tile beside them, on an RGB frame where --ops takes one (K2; "
        "the record then steers K2 launches on as many channels) or a gray "
        "plane (K6-K8); 'backend': per banded family of the stencils "
        "in --ops, K1/K2 (vpu) against the whole-op banded products (mxu) and "
        "their hybrid form, which --impl auto then follows per family; 'plan': "
        "the plans --impl auto can run (off, fused-pallas, fused-pallas-mxu) on "
        "--ops, which --plan auto then follows. Every route is checked "
        "byte-equal to the golden ops before it is timed",
    )
    tune.add_argument("--height", type=int, default=4320)
    tune.add_argument("--width", type=int, default=7680)
    tune.add_argument(
        "--blocks", default=None,
        help="comma-separated candidate tile heights (default "
        f"{AUTOTUNE_BLOCKS['cuda']} for cuda, {AUTOTUNE_BLOCKS['swar']} for "
        "swar); a height a launch cannot take is skipped",
    )
    tune.add_argument("--device", default="cuda", help="torch device (default cuda)")
    tune.add_argument(
        "--calib-file", default=None,
        help="calibration store path (default $MCIM_CALIB_FILE or "
        "./.mcim_calibration.json)",
    )
    tune.add_argument("--dry-run", action="store_true",
                      help="measure and print, but do not write the store")
    tune.add_argument(
        "--allow-cpu", action="store_true",
        help="permit a CPU device: the kernels' plain versions on the host clock, "
        "recorded under the device kind 'cpu' (tests and development only; "
        "refused otherwise)",
    )
    tune.add_argument("--json-metrics", default=None,
                      help="write the record to this path ('-' = stdout)")

    info = sub.add_parser("info", help="print toolchain and device info")
    info.add_argument("--device", default="cuda", help="device to report on")
    return p


def _add_batch_parser(sub) -> None:
    """The ``batch`` subcommand's arguments (the JAX package's, in the
    port's terms: --impl names the port's backends, --device a torch
    device)."""
    batch = sub.add_parser("batch", help="run a pipeline over every image in a directory")
    batch.add_argument("--input-dir", required=True)
    batch.add_argument("--output-dir", required=True)
    batch.add_argument("--glob", default="*", help="input filename pattern")
    batch.add_argument("--ops", default=REFERENCE_PIPELINE_SPEC)
    batch.add_argument(
        "--impl", choices=("auto", "cuda", "mxu", "swar", "torch"), default="auto",
        help="the backend, as `run --impl` (run --help)",
    )
    batch.add_argument(
        "--plan", choices=PLAN_MODES, default="auto",
        help="fusion-planner execution structure, as `run --plan` (run --help)",
    )
    batch.add_argument(
        "--shards", default="1",
        help="N row-shards per image, or RxC 2-D tile-shards (run --help); with "
        "--stack the flat slot count hosts the data-parallel stack",
    )
    batch.add_argument(
        "--device", default="cuda", help="torch device (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels)",
    )
    batch.add_argument(
        "--halo-mode", choices=("serial", "overlap"), default="serial",
        help="sharded halo execution (see `run --help`)",
    )
    batch.add_argument("--threads", type=int, default=4, help="decode prefetch threads")
    batch.add_argument(
        "--inflight", type=int, default=None,
        help="device dispatches kept outstanding through the async engine "
        "(engine/core.py): >= 2 overlaps the card's work on dispatch N with the "
        "host's decode of N+1 and encode of N-1; default 2 (with --stream-rows, "
        "MCIM_STREAM_INFLIGHT=2, as for `stream`)",
    )
    batch.add_argument("--window", type=int, default=None,
                       help=argparse.SUPPRESS)  # deprecated alias for --inflight
    batch.add_argument(
        "--io-threads", type=int, default=4,
        help="encode/write worker threads draining completed dispatches (the "
        "engine's output pool; decode prefetch is --threads)",
    )
    batch.add_argument(
        "--stream-rows", type=int, default=0, metavar="N",
        help="N > 0: stream every input through the tile engine (stream/) in "
        "N-row bands with the output encoded incrementally (png, ppm/pgm; other "
        "containers are written as .png), so an input costs band memory, not "
        "frame memory; --impl torch, mxu or auto (the stage walker); refused "
        "with --stack and --shards",
    )
    batch.add_argument(
        "--stack", type=int, default=1,
        help="stack up to N same-shape images into one device dispatch "
        "(Pipeline.batched: one launch per kernel group for the stack); with "
        "--shards M the stack is data-parallel over M slots",
    )
    batch.add_argument("--gray-output", action="store_true",
                       help="write single-channel output instead of replicating gray to RGB")
    batch.add_argument("--show-timing", action="store_true",
                       help="print end-to-end MP/s, the inflight peak and the device's idle share")
    batch.add_argument(
        "--json-metrics", default=None,
        help="write a JSON metrics line (incl. the skipped-file list) to this path "
        "('-' = stdout)",
    )
    batch.add_argument(
        "--resume", action="store_true",
        help="skip inputs already journaled ok (content-hash-verified) by an "
        "earlier run over this output dir: a batch killed mid-way finishes by "
        "re-running only failures and never-reached inputs",
    )
    batch.add_argument(
        "--journal", default=None, metavar="PATH",
        help="batch journal path (append-only JSONL of per-input outcomes; default "
        "<output-dir>/.mcim_batch_journal.jsonl)",
    )
    batch.add_argument("--no-journal", action="store_true",
                       help="disable the journal (no resume for this run)")
    batch.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write a Prometheus text snapshot of the batch registry (engine "
        "stages, inflight, per-outcome input counts) at exit (obs/metrics.py)",
    )
    _add_failpoint_flags(batch)
    _add_trace_flags(batch)


def _add_stream_parser(sub) -> None:
    """The ``stream`` subcommand's arguments: every flag of the JAX
    package's, in the port's terms (--impl names the walker's routes,
    --device a torch device)."""
    stm = sub.add_parser(
        "stream",
        help="constant-memory streaming tile engine: run a pipeline over an image of "
        "any height (or a video frame sequence) as fixed-height row bands with "
        "seam-stitched halos, byte-equal to the whole-image path, with peak resident "
        "bytes set by --tile-rows/--inflight, never by image size (stream/)",
    )
    stm.add_argument(
        "--input", default=None,
        help="input image path (ppm/pgm read by seeking, png by the scanline decoder; "
        "other formats fall back to a whole-image decode with a warning)",
    )
    stm.add_argument(
        "--synthetic", default=None, metavar="HxW[xC]",
        help="process a deterministic synthetic image of this shape instead of --input "
        "(generated band by band: a 100000x4096 scan never exists whole on the host)",
    )
    stm.add_argument(
        "--output", default=None,
        help="output path, encoded incrementally (png: one IDAT chunk a band; ppm/pgm: "
        "appended raw rows, the resumable container)",
    )
    stm.add_argument(
        "--video-frames", default=None, metavar="GLOB",
        help="video mode: process this ordered frame glob instead of one image; "
        "temporal ops (framediff, tdenoise:K) may lead --ops and read a bounded "
        "frame-history ring (ops/temporal.py)",
    )
    stm.add_argument("--output-dir", default=None,
                     help="video mode: directory for per-frame outputs (basename kept, "
                     "extension from --out-ext)")
    stm.add_argument("--out-ext", default=".png",
                     help="video mode: output frame container extension")
    stm.add_argument("--ops", default=REFERENCE_PIPELINE_SPEC)
    stm.add_argument(
        "--impl", choices=("auto", "torch", "mxu"), default="torch",
        help="tile compute: torch (the golden accumulators, default), mxu (the whole-op "
        "banded products for eligible stencils, byte-identical), auto (what torch runs: "
        "no banded-product record steers the walker)",
    )
    stm.add_argument(
        "--plan", choices=PLAN_MODES, default="auto",
        help="fusion-planner stage structure of each tile's walk (byte-identical in "
        "every mode; fused-pallas[-mxu] keep their partition and walk it)",
    )
    stm.add_argument(
        "--tile-rows", type=int, default=None,
        help="row-band height, the memory budget knob (default "
        "MCIM_STREAM_TILE_ROWS=512); at least the chain halo",
    )
    stm.add_argument(
        "--inflight", type=int, default=None,
        help="tile dispatches kept outstanding (default MCIM_STREAM_INFLIGHT=2): >= 2 "
        "overlaps tile k+1's H2D with tile k's compute and k-1's encode",
    )
    stm.add_argument("--io-threads", type=int, default=2,
                     help="engine encode workers (writes are delivered in tile order)")
    stm.add_argument("--device", default="cuda",
                     help="torch device (default cuda; cpu runs on the host)")
    stm.add_argument(
        "--resume", action="store_true",
        help="skip tiles (or video frames) journaled ok by a killed earlier run; "
        "image-mode resume needs a ppm/pgm output (a PNG compressor's state does not "
        "survive a kill)",
    )
    stm.add_argument(
        "--journal", default=None, metavar="PATH",
        help="stream journal path (default <output>.journal.jsonl, or "
        "<output-dir>/.mcim_stream_journal.jsonl for video)",
    )
    stm.add_argument("--no-journal", action="store_true",
                     help="disable the journal (no kill-mid-stream resume)")
    stm.add_argument("--show-timing", action="store_true",
                     help="print end-to-end MP/s, tiles, peak resident bytes and the "
                     "device's idle share")
    stm.add_argument("--json-metrics", default=None,
                     help="write the stream summary record to this path ('-' = stdout)")
    stm.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write a Prometheus snapshot of the stream registry (mcim_stream_* with "
        "the peak-resident-bytes gauge, and the engine families) at exit",
    )
    _add_failpoint_flags(stm)
    _add_trace_flags(stm)


def _add_serve_parser(sub) -> None:
    """The ``serve`` subcommand's arguments: the JAX package's flags and
    defaults, in the port's terms (--impl names the padded executor's
    accumulations, --device a torch device)."""
    srv = sub.add_parser(
        "serve",
        help="online micro-batching server: POST /v1/process (image bytes in, PNG out), "
        "GET /healthz, /stats, /metrics: bounded queue, shape buckets warmed on the "
        "device at start, byte-identical to per-request `run` output (serve/)",
    )
    srv.add_argument("--ops", default=REFERENCE_PIPELINE_SPEC)
    srv.add_argument(
        "--impl", choices=("auto", "torch", "mxu", "cuda", "swar"), default="torch",
        help="the bucket-padded executor rebuilds each op's border at each request's true "
        "shape with the golden torch ops (torch, default); mxu contracts eligible stencil "
        "families as banded products inside the same executor (byte-identical); auto is "
        "torch. cuda and swar are refused: the hand-written kernels extend edges at the "
        "bucket border",
    )
    srv.add_argument(
        "--shards", type=int, default=1,
        help="data-parallel serving over N devices: each dispatch's stack splits over the "
        "mesh's slots (batch sizes are rounded to multiples of N); 1 = one device",
    )
    srv.add_argument(
        "--buckets", default="512,1024,2048,4096",
        help="comma-separated shape buckets, N (square) or RxC; requests pad up to the "
        "smallest fitting bucket so every function is built at start; larger images are "
        "rejected",
    )
    srv.add_argument("--max-batch", type=int, default=8,
                     help="requests coalesced per dispatch (a multiple of --shards)")
    srv.add_argument(
        "--max-delay-ms", type=float, default=5.0,
        help="longest a request waits for batch-mates before a partial dispatch ships",
    )
    srv.add_argument(
        "--queue-depth", type=int, default=64,
        help="admission bound: submissions beyond this many queued requests are shed "
        "with the 'overloaded' status (HTTP 429) instead of buffering without bound",
    )
    srv.add_argument(
        "--deadline-ms", type=float, default=None,
        help="per-request deadline; requests that expire while queued are answered "
        "'deadline_expired' (HTTP 504) and never take a device slot",
    )
    srv.add_argument("--channels", default="1,3",
                     help="channel counts to warm (and admit), comma-separated")
    srv.add_argument("--host", default="", help="bind address")
    srv.add_argument("--port", type=int, default=8000, help="port (0 picks a free one)")
    srv.add_argument("--device", default="cuda",
                     help="torch device (default cuda; cpu runs on the host)")
    srv.add_argument("--json-metrics", default=None,
                     help="write the shutdown stats record to this path ('-' = stdout)")
    srv.add_argument(
        "--retry-attempts", type=int, default=3,
        help="dispatch attempts per micro-batch (1 = no retry); transient failures back "
        "off exponentially with jitter",
    )
    srv.add_argument(
        "--breaker-threshold", type=int, default=5,
        help="consecutive dispatch failures that trip a bucket's circuit breaker open "
        "(its traffic then degrades to the golden per-request path until a half-open "
        "probe succeeds)",
    )
    srv.add_argument("--breaker-reset-s", type=float, default=30.0,
                     help="quiet seconds an open breaker waits before a half-open probe")
    srv.add_argument(
        "--inflight", type=int, default=2,
        help="micro-batch dispatches kept outstanding through the async engine "
        "(engine/core.py): >= 2 keeps the device busy while results copy back and "
        "responses encode; 1 = serial dispatch-then-drain",
    )
    srv.add_argument("--io-threads", type=int, default=4,
                     help="completion worker threads cropping results and resolving responses")
    srv.add_argument(
        "--drain-deadline-s", type=float, default=30.0,
        help="SIGTERM graceful-drain budget: admission stops at once, queued + in-flight "
        "work gets this long to flush before the scheduler stops",
    )
    srv.add_argument(
        "--replicas", type=int, default=1,
        help="N > 1: pod mode, the `fabric` front-door router over N supervised replica "
        "processes with these serve flags (the fabric subcommand exposes the router's own "
        "knobs)",
    )
    srv.add_argument("--plan", choices=PLAN_MODES, default="auto",
                     help="fusion-planner stage structure of the padded executor "
                     "(byte-identical in every mode)")
    _add_failpoint_flags(srv)
    _add_trace_flags(srv)


def _add_fabric_parser(sub) -> None:
    """The ``fabric`` subcommand's arguments: the JAX package's flags, in
    the port's terms (--impl names the replicas' padded-executor
    accumulations, --device a torch device)."""
    fab = sub.add_parser(
        "fabric",
        help="pod-scale serving fabric: front-door router + N supervised replica worker "
        "processes (each the full serve stack on its own device context), heartbeat-driven "
        "health/affinity routing, rerouting retries, restart-with-backoff; an optional mesh "
        "lane for requests too large for any replica bucket (fabric/)",
    )
    fab.add_argument("--replicas", type=int, default=3)
    fab.add_argument("--ops", default=REFERENCE_PIPELINE_SPEC)
    fab.add_argument("--buckets", default="512,1024,2048,4096")
    fab.add_argument("--channels", default="1,3")
    fab.add_argument("--max-batch", type=int, default=8)
    fab.add_argument("--max-delay-ms", type=float, default=5.0)
    fab.add_argument("--queue-depth", type=int, default=64)
    fab.add_argument(
        "--impl", choices=("auto", "torch", "mxu"), default="torch",
        help="every replica's padded executor: the golden torch ops (torch, default; the "
        "JAX package's xla), banded products for eligible stencils (mxu); auto is torch",
    )
    fab.add_argument("--host", default="", help="router bind address")
    fab.add_argument("--port", type=int, default=8000)
    fab.add_argument("--device", default="cuda",
                     help="torch device of every replica and of the mesh lane (default cuda; "
                     "cpu runs on the host)")
    fab.add_argument(
        "--heartbeat-s", type=float, default=None,
        help="replica heartbeat period (default: MCIM_FABRIC_HEARTBEAT_S); the router marks "
        "a replica stale after --stale-s without one",
    )
    fab.add_argument(
        "--stale-s", type=float, default=None,
        help="router freshness window: replicas silent this long are routed around "
        "(default: MCIM_FABRIC_STALE_S)",
    )
    fab.add_argument(
        "--forward-attempts", type=int, default=None,
        help="distinct replicas tried per request before 503 (default: "
        "MCIM_FABRIC_FORWARD_ATTEMPTS); attempt 2+ counts as retried",
    )
    fab.add_argument(
        "--mesh-shards", type=int, default=0,
        help="N > 0 arms the oversize mesh lane: requests exceeding every replica bucket run "
        "ONE row-sharded dispatch over an N-slot mesh in the router process (the cards in "
        "turn, or N CPU slots with --device cpu) instead of being rejected",
    )
    fab.add_argument(
        "--autoscale", action="store_true",
        help="arm the elastic control loop (fabric/autoscaler.py): replica count follows "
        "queue-fill/p99 pressure between --min-replicas and --max-replicas with hysteresis; "
        "scale-down is drain-before-kill (routing stops, the queue empties, THEN SIGTERM). "
        "--replicas is the starting count",
    )
    fab.add_argument("--min-replicas", type=int, default=None,
                     help="autoscaler floor (default MCIM_FABRIC_MIN_REPLICAS)")
    fab.add_argument(
        "--systolic", action="store_true", default=None,
        help="pod-level systolic execution (graph/systolic.py): the router stage-shards "
        "registered DAG pipelines across replicas and the live env streams replica-to-replica "
        "at each stage boundary; any fallback is the pinned single-replica path, never a "
        "wrong answer (default MCIM_SYSTOLIC)",
    )
    fab.add_argument(
        "--tune", action="store_true",
        help="arm the continuous autotuning loop (tune/): replicas persist serve-path "
        "observations to the calibration store and the router's tune controller proposes "
        "config flips from them, deploying each through the canary gate and promoting "
        "fleet-wide or rolling back (MCIM_TUNE_* env tunes the cadence/thresholds)",
    )
    fab.add_argument(
        "--tune-arms", default=None,
        help="comma-separated candidate arms the controller may propose (e.g. "
        "plan:off,plan:fused; default MCIM_TUNE_ARMS or plan:off,plan:fused)",
    )
    fab.add_argument("--max-replicas", type=int, default=None,
                     help="autoscaler ceiling (default MCIM_FABRIC_MAX_REPLICAS)")
    fab.add_argument("--plan", choices=PLAN_MODES, default="auto",
                     help="fusion-planner stage structure of every replica's padded executor "
                     "(byte-identical in every mode)")
    fab.add_argument(
        "--slo", default=None, metavar="SPECS",
        help="SLO specs the router's burn-rate engine evaluates over the federated fleet "
        "metrics: comma-separated avail:<pct> and latency:<le_seconds>:<pct> entries "
        "(default MCIM_SLO_SPECS; served at GET /slo and as mcim_slo_* gauges)",
    )
    fab.add_argument("--json-metrics", default=None,
                     help="write the shutdown fabric stats record to this path ('-' = stdout)")
    fab.add_argument(
        "--federate", default=None, metavar="URL",
        help="federation front-door URL: this pod's router pushes pod-aggregate heartbeats "
        "there and applies tenant quota-share leases from the acks",
    )
    fab.add_argument("--pod-id", default=None,
                     help="stable pod identity at the federation tier (default pod-<pid>)")
    _add_failpoint_flags(fab)
    _add_trace_flags(fab)


def _add_graph_parser(sub) -> None:
    """The ``graph`` subcommand's arguments: the JAX package's flags, in
    the port's terms (--impl names the walker's accumulations, --device a
    torch device)."""
    gph = sub.add_parser(
        "graph",
        help="validate/run a pipeline-spec DAG (graph/): branch taps, merge combinators, "
        "side outputs; the file form of what POST /v1/pipelines registers",
    )
    gph.add_argument(
        "--spec", required=True, metavar="PATH",
        help="pipeline spec JSON (graph/spec.py schema; a refusal prints its "
        "closed-taxonomy code and exits 2)",
    )
    gph.add_argument("--input", default=None, help="image to run the graph on")
    gph.add_argument(
        "--synthetic", default=None, metavar="HxW[xC]",
        help="run on a deterministic synthetic image of this shape instead of --input",
    )
    gph.add_argument("--output", default=None, help="write the image output here")
    gph.add_argument(
        "--histogram-out", default=None, metavar="PATH",
        help="write the histogram side output (JSON int[256]); needs a spec with "
        "outputs.histogram",
    )
    gph.add_argument(
        "--stats-out", default=None, metavar="PATH",
        help="write the stats side output (JSON count/min/max/mean); needs a spec with "
        "outputs.stats",
    )
    gph.add_argument(
        "--impl", choices=("torch", "mxu", "auto"), default="torch",
        help="stencil accumulation of the graph's segments, which run the stage walker "
        "(the JAX package's plan-executor impls): torch (the golden ops; the JAX "
        "package's xla), mxu (banded products for eligible stencils), auto (the banded "
        "products where the calibration store or MCIM_PREFER_MXU routes them on a card)",
    )
    gph.add_argument(
        "--validate-only", action="store_true",
        help="parse + compile-plan the spec and print its structure without running "
        "anything (no device touch)",
    )
    gph.add_argument("--device", default="cuda",
                     help="torch device (default cuda; cpu runs on the host)")
    gph.add_argument("--json-metrics", default=None,
                     help="write the run record ('-' = stdout)")
    gph.add_argument("--plan", choices=PLAN_MODES, default="auto",
                     help="fusion-planner stage structure of each segment "
                     "(byte-identical in every mode)")


def image_runner(pipe, *, impl: str, device, block_h=None, gray_output=False,
                 plan: str = "auto", mesh=None, halo_mode: str = "serial"):
    """The `run` computation as an image -> image function on `device`: the
    pipeline (row-sharded over `mesh` when one is given), then, unless
    `gray_output`, gray output replicated to RGB on the device (the
    reference's GRAY2BGR, kernel.cu:210) by the same backend and plan
    (under cuda + fused-pallas, a halo-0 K4 stage)."""
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    if mesh is not None:
        fn = pipe.sharded(mesh, backend=impl, halo_mode=halo_mode, plan=plan)
    else:
        fn = pipe.jit(backend=impl, block_h=block_h, device=device, plan=plan)
    to_rgb = None  # built at the first gray output

    def run(img):
        nonlocal to_rgb
        out = fn(img)
        if not gray_output and out.ndim == 2:
            if to_rgb is None:
                to_rgb = Pipeline.parse("gray2rgb").jit(
                    backend=impl, block_h=block_h, device=device, plan=plan
                )
            out = to_rgb(out)
        return out

    return run


def run_image(pipe, img, *, impl: str, device, block_h=None, gray_output=False,
              plan: str = "auto"):
    """The pipeline on one image, as ``run`` computes it (`image_runner`).
    Returns a tensor on `device`."""
    return image_runner(
        pipe, impl=impl, device=device, block_h=block_h, gray_output=gray_output,
        plan=plan,
    )(img)


def cmd_run(args: argparse.Namespace) -> int:
    """`run`: one image through the pipeline. One trace for the whole run
    (root ``run``; children ``run.load``, ``run.compile_and_run``,
    ``run.steady`` under --show-timing or --json-metrics, ``run.save``),
    exported on every exit path when --trace-out is given. The compute
    spans end after the device is synchronised, so they time the work,
    not its enqueue."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder, trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

    _arm_failpoints(args)
    armed = _configure_tracing(args)
    log = get_logger()
    root = obs_trace.start_trace("run", ops=args.ops, impl=args.impl, shards=str(args.shards))
    try:
        with root:
            return _run(args, root)
    except Exception as e:
        # the failure as a WARNING entry of the flight recorder's ring, beside
        # the failpoint or span entries that led to it; `main` prints it
        recorder.note("log", level="WARNING", msg=f"run failed: {type(e).__name__}: {e}"[:300])
        raise
    finally:
        if _writes_trace():
            _export_trace(args, log)
        if armed:
            obs_trace.disable()


def _writes_trace() -> bool:
    """Whether this process writes --trace-out: the only one, or the rank
    that holds slot 0 under a process group (rank 0)."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh

    return pmesh._world()[0] == 0


def _run(args: argparse.Namespace, root) -> int:
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo, mesh as pmesh
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import as_image_tensor
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    if args.device_timeout is not None:  # the child process owns the device
        return _run_guarded(args, root)
    pmesh.distributed_init(args.device)  # no-op unless launched by torchrun
    dev = pmesh.rank_device(args.device)
    pipe = Pipeline.parse(args.ops)
    mesh = pmesh.mesh_from_shards(args.shards, dev)
    if mesh is not None and args.block:
        print("warning: --block applies to single-device runs; ignored under --shards",
              file=sys.stderr)
    plan_metrics.reset()
    halo.exchanges.reset()
    runner = image_runner(
        pipe, impl=args.impl, device=dev, block_h=args.block,
        gray_output=args.gray_output, plan=args.plan, mesh=mesh,
        halo_mode=args.halo_mode,
    )
    with obs_trace.span("run.load", parent=root.context(), path=args.input):
        img = load_image(args.input)
        x = as_image_tensor(img, dev)
    # under a process group only the rank that holds slot 0 has the whole result
    writes = mesh is None or mesh.rank == mesh.ranks[0]

    def once():
        return runner(x)

    def sync():
        cards = {dev} if mesh is None else {mesh.devices[s] for s in mesh.local_slots}
        for d in cards:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    prof = None
    if args.profile_dir:
        from mpi_cuda_imagemanipulation_tpu_torch.obs.profile import profiler

        prof = profiler(dev)
        prof.start()
    t0 = time.perf_counter()
    with obs_trace.span("run.compile_and_run", parent=root.context()):
        out = once()
        sync()
    first_s = time.perf_counter() - t0  # includes the kernels' build on first use
    exchange_rounds = halo.exchanges.rounds
    steady_ms = None
    if args.show_timing or args.json_metrics:
        with obs_trace.span("run.steady", parent=root.context()) as steady:
            call_ms = None
            if steady is not obs_trace.NOOP_SPAN:
                # traced only: one synchronised call on the host clock, which
                # shows the span times the work and not its enqueue
                t0 = time.perf_counter()
                once()
                sync()
                call_ms = (time.perf_counter() - t0) * 1e3
            if dev.type == "cuda":  # device time per call from CUDA events
                steady_ms = device_time_ms(once)
                sync()
            elif call_ms is not None:
                steady_ms = call_ms
            else:  # host time of the CPU run; not a device number
                t0 = time.perf_counter()
                once()
                steady_ms = (time.perf_counter() - t0) * 1e3
            steady.set(call_ms=call_ms, steady_ms=steady_ms)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, f"run_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        get_logger().info("profile written to %s", path)
    if writes:
        with obs_trace.span("run.save", parent=root.context(), path=args.output):
            save_image(args.output, out.cpu().numpy())

    mp = img.shape[0] * img.shape[1] / 1e6
    clock = "device (CUDA events)" if dev.type == "cuda" else "host"
    if args.show_timing and writes:
        print(
            f"pipeline [{pipe.name}] impl={args.impl} plan={args.plan} "
            f"shards={args.shards} device={dev}: "
            f"first call {first_s * 1e3:.3f} ms, steady-state {steady_ms:.4f} ms {clock} "
            f"({mp / (steady_ms / 1e3):.1f} MP/s)"
        )
    if args.json_metrics and writes:
        rec = {
            "event": "run",
            "ops": pipe.name,
            "impl": args.impl,
            "plan": args.plan,
            "shards": args.shards,
            "halo_mode": args.halo_mode,
            "guarded": False,
            "halo_exchanges": exchange_rounds,
            "plan_metrics": plan_metrics.snapshot(),
            "plan_fallbacks": dict(plan_metrics.pallas_fallbacks),
            "mxu_stage_ops": dict(plan_metrics.mxu_stage_ops),
            "mxu_stage_fallbacks": dict(plan_metrics.mxu_stage_fallbacks),
            "mxu_golden_ops": dict(plan_metrics.mxu_golden_ops),
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "clock": clock,
            "height": img.shape[0],
            "width": img.shape[1],
            "first_call_s": first_s,
            "steady_ms": steady_ms,
            "mp_per_s": mp / (steady_ms / 1e3) if steady_ms else None,
        }
        emit_json_metrics(rec, args.json_metrics)
    return 0


def _run_guarded(args: argparse.Namespace, root) -> int:
    """`run --device-timeout`: the pipeline in a watchdog subprocess
    (utils/guard.py) on --device. The shard spec and --impl are checked here,
    before the child starts. On a timeout the error is logged, the root
    span marked, and the exit code is 4; the child's two synchronised
    windows feed --show-timing and --json-metrics. Under torchrun each
    rank's child joins the process group, and rank 0 writes."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        gray_to_rgb,
        load_image,
        save_image,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import parse_shards
    from mpi_cuda_imagemanipulation_tpu_torch.utils.guard import (
        DeviceTimeoutError,
        run_guarded,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger

    log = get_logger()
    _n_r, n_c = parse_shards(args.shards)
    if n_c is not None and args.impl not in ("torch", "auto"):
        raise ValueError(
            "2-D sharding (--shards RxC) computes tiles with the torch ops; use "
            f"--impl torch or auto (got {args.impl!r})"
        )
    if args.profile_dir:
        log.warning("--profile-dir is not supported in guarded mode (--device-timeout); ignored")
    with obs_trace.span("run.load", parent=root.context(), path=args.input):
        img = load_image(args.input)
    timings: dict = {}
    t0 = time.perf_counter()
    try:
        with obs_trace.span("run.compile_and_run", parent=root.context(), guarded=True):
            out = run_guarded(
                args.ops, img, args.device_timeout, impl=args.impl, block_h=args.block,
                shards=args.shards, halo_mode=args.halo_mode, timings=timings,
                device=args.device, plan=args.plan,
            )
    except DeviceTimeoutError as e:
        log.error("%s", e)
        root.set(error="DeviceTimeoutError")
        return 4
    first_s = timings.get("compile_and_run_s", time.perf_counter() - t0)
    steady_s = timings.get("steady_s")
    if not args.gray_output and out.ndim == 2:
        out = gray_to_rgb(out)
    writes = int(os.environ.get("RANK", "0")) == 0
    if writes:
        with obs_trace.span("run.save", parent=root.context(), path=args.output):
            save_image(args.output, out)
    mp = img.shape[0] * img.shape[1] / 1e6
    if args.show_timing and writes:
        steady = (f"steady-state {steady_s * 1e3:.4f} ms host ({mp / steady_s:.1f} MP/s)"
                  if steady_s else "steady-state timing unavailable")
        print(
            f"pipeline [{args.ops}] impl={args.impl} shards={args.shards} "
            f"device={args.device} (guarded): first call {first_s * 1e3:.3f} ms, {steady}"
        )
    if args.json_metrics and writes:
        emit_json_metrics(
            {
                "event": "run",
                "ops": args.ops,
                "impl": args.impl,
                "shards": args.shards,
                "halo_mode": args.halo_mode,
                "guarded": True,
                "device": args.device,
                # synchronised windows in the child, on the host clock
                "clock": "host",
                "height": img.shape[0],
                "width": img.shape[1],
                "compile_and_run_s": first_s,
                "steady_s": steady_s,
                "mp_per_s": mp / steady_s if steady_s else None,
            },
            args.json_metrics,
        )
    return 0


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------


def _lane_ms(fn, device) -> float:
    """Milliseconds of one call of `fn`: CUDA events (utils/timing
    .device_time_ms) on a card; on the CPU (--allow-cpu) the median of five
    host-clock calls, which is not a device time."""
    if device.type == "cuda":
        from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

        return device_time_ms(fn)
    fn()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _timed_lanes(tag: str, lanes: dict, x, want, device) -> dict | None:
    """{lane: ms} of every lane that runs; a lane that a launch cannot
    take (a tile too tall for the shared memory) is skipped. Each lane's
    output is held byte-equal to `want` before it is timed; None (and an
    error) when one differs, so that no record is written."""
    import torch

    timed = {}
    for lane, fn in lanes.items():
        try:
            got = fn(x)
        except ValueError as e:
            print(f"{tag} {lane}: skipped ({str(e)[:120]})")
            continue
        if not torch.equal(got, want):
            print(f"error: {tag} {lane} differs from the golden output; refusing to "
                  "record", file=sys.stderr)
            return None
        timed[lane] = _lane_ms(lambda f=fn: f(x), device)
    return timed


def _print_lanes(tag: str, timed: dict, choice, mp: float) -> dict:
    lane_mp = {str(k): round(mp / (v / 1e3), 1) for k, v in timed.items()}
    for lane, ms in timed.items():
        mark = "  <- fastest" if lane == choice else ""
        print(f"{tag} {lane!s:>16}: {ms:.4f} ms  {lane_mp[str(lane)]:,.1f} MP/s{mark}")
    return lane_mp


def _autotune_block(args, ops, device, kind: str, clock: str) -> tuple[int, dict | None]:
    """K2's (--impl cuda) or K6-K8's (--impl swar) tile heights on --ops, the
    default tile beside them; records the fastest with the channels it
    applies to. K2 runs on an RGB frame where the pipeline takes one (else a
    gray plane), and its record steers K2 launches that read as many
    channels; K6-K8 run on gray planes only (a gray input where the pipeline
    takes one)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    candidates = _parse_blocks(args)
    h, w = args.height, args.width
    swar = args.impl == "swar"
    if swar:
        stencils = [op for op in ops if sk.swar_any_eligible(op, (h, w))]
    else:
        stencils = [st for _, st in ck.group_ops(ops) if st is not None]
    if not stencils:
        print(f"error: no {'SWAR-eligible stencil (W % 4 == 0)' if swar else 'stencil'} "
              f"in --ops {args.ops!r} at {h}x{w}", file=sys.stderr)
        return 2, None
    # the default tile's height, to record if the default wins: K2's or the
    # SWAR picker's for the first stencil on this plane
    if swar:
        default_h = sk.swar_group(stencils[0]).shape(h, w, None)[0]
    else:
        default_h = ck.stencil_tile_shape(h, w)[0]
    pipe = Pipeline(ops)
    ch = _channels_for(pipe, 1 if swar else 3)
    x = torch.from_numpy(synthetic_image(h, w, channels=ch, seed=7)).to(device)
    channels = 1 if swar else ch  # what the recorded kernels read
    want = pipe.jit("torch", device=device, plan="off")(x)
    lanes = {"default": pipe.jit(args.impl, device=device, plan="off")}
    for bh in dict.fromkeys(candidates):
        lanes[bh] = pipe.jit(args.impl, bh, device=device, plan="off")
    timed = _timed_lanes("block", lanes, x, want, device)
    if timed is None:
        return 1, None
    choice = min(timed, key=timed.get)
    best_h = default_h if choice == "default" else choice
    lane_mp = _print_lanes(f"block {args.impl}", timed, choice, h * w / 1e6)
    rec = {"event": "autotune", "dimension": "block", "device_kind": kind, "clock": clock,
           "pipeline": args.ops, "impl": args.impl, "height": h, "width": w,
           "channels": channels, "default_h": default_h, "block_h": best_h,
           "ms": {str(k): v for k, v in timed.items()}, "mp_per_s": lane_mp}
    if not args.dry_run:
        rec["calib_file"] = calibration.record_block_h(
            kind, best_h, impl=args.impl, pipeline=args.ops, width=w, channels=channels,
            ms=round(timed[choice], 4), mp_per_s=lane_mp[str(choice)],
        )
    return 0, rec


def _autotune_backend(args, ops, device, kind: str, clock: str) -> tuple[int, dict | None]:
    """Per banded family of the stencils in --ops, on a gray plane: K1/K2
    ('vpu') against the whole-op banded products ('mxu') and their hybrid
    form; records the fastest per family."""
    from functools import partial

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import mxu_family, pipeline_mxu
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    fams: dict = {}  # family -> the first stencil of it
    for op in ops:
        fam = mxu_family(op)
        if fam is not None:
            fams.setdefault(fam, op)
    if not fams:
        print(f"error: no stencil with a banded formulation in --ops {args.ops!r} "
              "(ops/mxu_kernels.mxu_eligible)", file=sys.stderr)
        return 2, None
    h, w = args.height, args.width
    x = torch.from_numpy(synthetic_image(h, w, channels=1, seed=7)).to(device)
    records = []
    for fam, op in fams.items():
        lanes = {
            "vpu": partial(pipeline_cuda, (op,)),
            "mxu": partial(pipeline_mxu, (op,), mode="banded"),
            "hybrid": partial(pipeline_mxu, (op,), mode="hybrid"),
        }
        timed = _timed_lanes(f"backend {fam}", lanes, x, op(x), device)
        if timed is None:
            return 1, None
        choice = min(timed, key=timed.get)
        lane_mp = _print_lanes(f"backend {fam:>9}", timed, choice, h * w / 1e6)
        ent = {"family": fam, "op": op.name, "choice": choice, "width": w, "ms": timed,
               "mp_per_s": lane_mp}
        if not args.dry_run:
            ent["calib_file"] = calibration.record_backend_choice(
                kind, fam, choice, op=op.name, width=w, mp_per_s=lane_mp,
            )
        records.append(ent)
    return 0, {"event": "autotune", "dimension": "backend", "device_kind": kind,
               "clock": clock, "pipeline": args.ops, "height": h, "width": w,
               "families": records}


def _channels_for(pipe, prefer: int) -> int:
    """`prefer` channels (1 or 3) if the pipeline takes such an image, else
    the other count (an op that needs 3 channels, or 1, raises)."""
    import torch

    shape = (8, 8, 3) if prefer == 3 else (8, 8)
    try:
        pipe(torch.zeros(shape, dtype=torch.uint8))
    except ValueError:
        return 4 - prefer
    return prefer


def _autotune_plan(args, ops, device, kind: str, clock: str) -> tuple[int, dict | None]:
    """The plans --impl auto can run (AUTOTUNE_PLANS) on --ops end to end,
    on an RGB image where the pipeline takes one; records the fastest per
    (device kind, pipeline fingerprint, width)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, pipeline_fingerprint
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    pipe = Pipeline(ops)
    h, w = args.height, args.width
    ch = _channels_for(pipe, 3)
    x = torch.from_numpy(synthetic_image(h, w, channels=ch, seed=7)).to(device)
    want = pipe.jit("torch", device=device, plan="off")(x)
    lanes = {m: pipe.jit("auto", device=device, plan=m) for m in AUTOTUNE_PLANS}
    timed = _timed_lanes("plan", lanes, x, want, device)
    if timed is None:
        return 1, None
    choice = min(timed, key=timed.get)
    lane_mp = _print_lanes("plan", timed, choice, h * w / 1e6)
    fp = pipeline_fingerprint(ops)
    rec = {"event": "autotune", "dimension": "plan", "device_kind": kind, "clock": clock,
           "pipeline": args.ops, "pipeline_fp": fp, "height": h, "width": w,
           "channels": ch, "choice": choice, "ms": timed, "mp_per_s": lane_mp,
           "stages": {m: len(build_plan(ops, m).stages) for m in timed}}
    if not args.dry_run:
        rec["calib_file"] = calibration.record_plan_choice(
            kind, fp, choice, ops=args.ops, width=w, mp_per_s=lane_mp,
        )
    return 0, rec


def _parse_blocks(args) -> list[int]:
    """--blocks as ints, every token parsed before any measurement."""
    raw = args.blocks or AUTOTUNE_BLOCKS[args.impl]
    try:
        blocks = [int(tok) for tok in raw.split(",") if tok.strip()]
    except ValueError:
        raise ValueError(f"--blocks must be comma-separated ints: {raw!r}") from None
    if not blocks:
        raise ValueError("--blocks is empty")
    bad = [b for b in blocks if b < 1]
    if bad:
        raise ValueError(f"--blocks must be positive: {bad}")
    return blocks


def _autotune_info(args) -> int:
    """The store's records for --ops on the device's kind, as JSON; with
    --online also the online tuning store's promoted entry, per-window arm
    statistics and audit-trail tail, and the plan choice the newest-wins
    rule (tune/store.effective_plan_choice) picks."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
        STAGE_ARMS,
        STAGE_FALLBACK_REASONS,
        mxu_family,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.plan import pipeline_fingerprint
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    ops = make_pipeline_ops(args.ops)
    fp = pipeline_fingerprint(ops)
    kind = calibration.current_device_kind(args.device)
    kind_rec = calibration.entries().get(kind)
    kind_rec = kind_rec if isinstance(kind_rec, dict) else {}
    backend = kind_rec.get("backend_choice")
    backend = backend if isinstance(backend, dict) else {}
    fams = sorted({f for f in map(mxu_family, ops) if f is not None})
    report = {
        "store": calibration.calib_path(),
        "device_kind": kind,
        "ops": args.ops,
        "pipeline_fingerprint": fp,
        "plan_choice": calibration.plan_entry(fp, device_kind=kind),
        "block_h": {impl: kind_rec.get(impl) for impl in ("cuda", "swar")},
        "backend_choice": {f: backend.get(f) for f in fams},
        "mxu_in_stage": {
            "stage_arms": calibration.stage_arm_entries(kind),
            "ops_by_arm": {a: plan_metrics.mxu_stage_ops[a] for a in STAGE_ARMS if a != "vpu"},
            "fallbacks_by_reason": {
                r: plan_metrics.mxu_stage_fallbacks[r] for r in STAGE_FALLBACK_REASONS
            },
        },
    }
    if args.online:
        from mpi_cuda_imagemanipulation_tpu_torch.tune.store import (
            effective_plan_choice,
            online_store,
        )

        windows = online_store.windows(fp, device_kind=kind)
        report["online"] = {
            "promoted": online_store.promoted_entry(fp, device_kind=kind),
            "observations": {
                w: online_store.arm_stats(fp, w, device_kind=kind) for w in sorted(windows)
            },
            "audit_tail": online_store.audit_trail()[-10:],
        }
        # the choice resolve_plan_mode acts on, newest wins
        report["effective"] = {"plan_choice": effective_plan_choice(fp, device_kind=kind)}
    print(json.dumps(report, indent=2, sort_keys=True, default=str))
    return 0


def cmd_autotune(args: argparse.Namespace) -> int:
    """Measure one dimension's routes on the device and record the fastest.

    Every --blocks token is parsed before any measurement. The sweep runs
    with lookups off (MCIM_NO_CALIB), so the store cannot steer the sweep
    that is about to rewrite it, and the caller's MCIM_CALIB_FILE and
    MCIM_NO_CALIB are restored on return. A CPU device is refused unless
    --allow-cpu, so a host-clock time is never recorded for a card, and
    then its records go under the kind 'cpu'."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration, platform
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics

    saved = {k: os.environ.get(k) for k in ("MCIM_CALIB_FILE", "MCIM_NO_CALIB")}
    if args.calib_file:
        os.environ["MCIM_CALIB_FILE"] = args.calib_file
    try:
        if args.action == "info":
            return _autotune_info(args)
        if args.dimension == "block":
            _parse_blocks(args)
        device = torch.device(args.device)
        if not platform.is_cuda_device(device) and not args.allow_cpu:
            print(f"error: refusing to autotune on {str(device)!r}, which is no CUDA device "
                  "this process can use: its times would be the plain versions' on the "
                  "host; pass --device cpu --allow-cpu to record them under the kind "
                  "'cpu' (tests and development only)", file=sys.stderr)
            return 3
        device = resolve_device(device)
        ops = make_pipeline_ops(args.ops)
        kind = calibration.current_device_kind(device)
        clock = "device (CUDA events)" if device.type == "cuda" else "host"
        os.environ["MCIM_NO_CALIB"] = "1"
        sweep = {"block": _autotune_block, "backend": _autotune_backend,
                 "plan": _autotune_plan}[args.dimension]
        rc, rec = sweep(args, ops, device, kind, clock)
        if rec is None:
            return rc
        rec["dry_run"] = bool(args.dry_run)
        print("dry run: the store was not written" if args.dry_run
              else f"recorded in {calibration.calib_path()} [{kind}]")
        if args.json_metrics:
            emit_json_metrics(rec, args.json_metrics)
        return rc
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The hand-written kernels: name, source, what runs it.
KERNELS = (
    "K1 pointwise group (pointwise.cu)",
    "K2/K2g/K3 stencil group (stream_stencil.cu)",
    "K4/K4g fused plan stage (fused_stage.cu), with K5 its tensor-core arm (mma_stage.cuh)",
    "K6 separable SWAR stencil, narrow and wide (swar_stencil.cu)",
    "K7 SWAR 2-D correlation on 16-bit fields (swar_stencil.cu)",
    "K8 SWAR 2-D correlation on 32-bit lanes (swar_stencil.cu)",
    "T4 copy-rate probe: tiled, shared-memory and bitcast copies (copy_probe.cu; "
    "tools.roofline_probe)",
    "T2 pointwise chain on packed words (packed_proto.cu; tools.packed_proto)",
    "T3 5x5 Gaussian on quarter-strip words (swar_proto.cu; tools.swar_proto)",
    "T1/T1g/T1-pw group on packed words, stencil, ghost and pointwise forms "
    "(packed_stream.cu; tools.packed_kernels, tools.packed_ab)",
)


def _tool_output(cmd: list[str]) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() if r.returncode == 0 else f"unavailable (exit {r.returncode})"


def _batch_mesh(n_r: int, n_c: int | None, dev, *, flat: bool):
    """The mesh of `batch --shards`: R x C tiles (a 2-D mesh), N rows, or
    with `flat` (a data-parallel stack) R * C slots in a row. On the CPU
    that many CPU slots; on CUDA the first cards (fewer raise)."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh

    n = n_r * (n_c or 1)
    devices = [dev] * n if dev.type == "cpu" else None
    if n_c is not None and not flat:
        return pmesh.make_mesh_2d(n_r, n_c, devices=devices)
    return pmesh.make_mesh(n, devices=devices)


def cmd_batch(args: argparse.Namespace) -> int:
    """`batch`: the pipeline over every input of a directory through the
    engine (engine/core.py), the JAX package's ``cmd_batch`` in the port's
    terms. The dispatch form: ``Pipeline.data_parallel`` for a stack over a
    mesh, ``batched(donate=True)`` for a stack, ``sharded`` for N or RxC
    shards, else ``jit(donate=True)``; only the single-device forms are
    staged (``device_stager``: pinned H2D on a copy stream). A shape change
    flushes the pending stack padded to --stack (`pad_stack`); the trailing
    partial stack goes at its own size. Journal lines are written only
    after an output exists. Exit codes: 3 when no input matches, 1 when an
    input failed or was skipped, 0 otherwise."""
    import glob as globmod
    import threading

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics, device_stager
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import batch_load, gray_to_rgb, save_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
    from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import (
        DEFAULT_NAME as JOURNAL_DEFAULT_NAME,
        BatchJournal,
        content_digest,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import pad_stack
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger

    _arm_failpoints(args)
    _configure_tracing(args)
    log = get_logger()
    pmesh.distributed_init(args.device)  # no-op unless launched by torchrun
    dev = pmesh.rank_device(args.device)
    paths = sorted(
        p for p in globmod.glob(os.path.join(globmod.escape(args.input_dir), args.glob))
        if os.path.isfile(p)
    )
    if not paths:
        log.error("no inputs match %s/%s", args.input_dir, args.glob)
        return 3
    os.makedirs(args.output_dir, exist_ok=True)
    # outputs mirror the input's path under input-dir, so that a pattern
    # spanning subdirectories cannot collide on basenames
    rels = [os.path.relpath(p, args.input_dir) for p in paths]

    journal = None
    if not args.no_journal:
        journal = BatchJournal(args.journal
                               or os.path.join(args.output_dir, JOURNAL_DEFAULT_NAME))
    digests: dict[int, str | None] = {}

    def digest(i: int) -> str | None:
        if i not in digests:
            try:
                digests[i] = content_digest(paths[i])
            except OSError:
                digests[i] = None
        return digests[i]

    resumed: set[int] = set()
    if args.resume:
        if journal is None:
            raise ValueError("--resume needs the journal (drop --no-journal)")
        prior = journal.load()
        for i, rel in enumerate(rels):
            rec = prior.get(rel)
            # only ok records whose digest still matches the input's bytes:
            # an edited input is reprocessed
            if rec and rec.get("status") == "ok" and rec.get("digest") and \
                    rec.get("digest") == digest(i):
                resumed.add(i)
        log.info("resume: %d/%d inputs already journaled ok, %d to (re)run",
                 len(resumed), len(paths), len(paths) - len(resumed))
    failed: dict[int, str] = {}  # index -> error (decode, compute or save)
    pipe = Pipeline.parse(args.ops)
    stack = max(1, args.stack)
    n_r, n_c = pmesh.parse_shards(args.shards)
    n_flat = n_r * (n_c or 1)
    if args.stream_rows:
        if stack > 1 or n_flat > 1:
            raise ValueError("--stream-rows streams each input through the tile engine and is "
                             "incompatible with --stack/--shards")
        return _batch_stream(args, paths, rels, resumed, journal, digest, pipe, log, dev)
    if args.inflight is not None:
        inflight = args.inflight
    elif args.window is not None:
        log.warning("--window is deprecated; use --inflight")
        inflight = args.window
    else:
        inflight = 2
    inflight = max(1, inflight)
    stage = None  # H2D staging: the single-device forms only
    if stack > 1 and n_flat > 1:
        if stack % n_flat:
            log.warning(
                "--stack %d is not a multiple of %d slots: full mid-stream dispatches pad "
                "to %d images and discard the pad's compute (the trailing partial stack "
                "goes at its own size)", stack, n_flat, -(-stack // n_flat) * n_flat)
        fn = pipe.data_parallel(_batch_mesh(n_r, n_c, dev, flat=True), backend=args.impl,
                                plan=args.plan)
    elif stack > 1:
        fn = pipe.batched(backend=args.impl, device=dev, plan=args.plan, donate=True)
        stage = device_stager(dev, inflight=inflight)
    elif n_flat > 1 or n_c is not None:
        fn = pipe.sharded(_batch_mesh(n_r, n_c, dev, flat=False), backend=args.impl,
                          halo_mode=args.halo_mode, plan=args.plan)
    else:
        fn = pipe.jit(backend=args.impl, device=dev, plan=args.plan, donate=True)
        stage = device_stager(dev, inflight=inflight)

    # one registry for the run: the engine's families and the per-outcome
    # input counter; --metrics-out renders it at exit
    registry = Registry()
    inputs_total = registry.counter("mcim_batch_inputs_total",
                                    "Batch inputs by outcome (ok/failed/resumed).",
                                    labels=("outcome",))
    inputs_total.inc(len(resumed), outcome="resumed")
    state_lock = threading.Lock()  # done and failed across the engine's threads
    done = 0

    def record_failed(idxs, e) -> None:
        # a failed dispatch or save fails only its own inputs, each with a
        # journal line; the run goes on and exits 1
        msg = f"{type(e).__name__}: {e}"
        with state_lock:
            for i in idxs:
                failed[i] = msg
        inputs_total.inc(len(idxs), outcome="failed")
        for i in idxs:
            log.error("failed %s: %s", rels[i], msg)
            if journal is not None:
                journal.record_failed(rels[i], digest(i), msg)

    def save_one(i, out):
        nonlocal done
        if not args.gray_output and out.ndim == 2:
            out = gray_to_rgb(out)
        dst = os.path.join(args.output_dir, rels[i])
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        save_image(dst, out)
        if journal is not None:
            # journaled only here, after the output exists: a run killed with
            # this item in flight re-runs it on --resume, and the resumed run
            # skips exactly the journaled-ok inputs (no loss, no duplicate)
            journal.record_ok(rels[i], digest(i), rels[i])
        inputs_total.inc(outcome="ok")
        with state_lock:
            done += 1

    def on_done(idxs, out, info):
        for k, i in enumerate(idxs):  # padded images of a stack are dropped here
            try:
                save_one(i, out[k] if stack > 1 else out)
            except Exception as e:
                record_failed([i], e)

    def on_error(idxs, e):
        record_failed(list(idxs), e)

    engine = Engine(inflight=inflight, io_threads=max(1, args.io_threads), stage=stage,
                    metrics=EngineMetrics(registry=registry), name="batch")

    def ship(idxs, make_input):
        # each dispatch is its own trace: build, h2d and enqueue under this
        # root on this thread, force and encode under it on the engine's
        # threads; a host-side failure at submit fails these inputs only
        root = obs_trace.start_trace("batch.dispatch", n=len(idxs), first=rels[idxs[0]])
        try:
            with root:
                engine.submit(tuple(idxs), make_input, fn, on_done=on_done, on_error=on_error)
        except Exception as e:
            record_failed(idxs, e)

    pending: list[tuple[int, np.ndarray]] = []

    def flush_pending(final: bool = False):
        nonlocal pending
        if not pending:
            return
        idxs = [i for i, _ in pending]
        imgs = [im for _, im in pending]
        if stack == 1:
            ship(idxs, lambda: imgs[0])
        elif final and len(imgs) < stack:
            # the trailing partial stack goes at its own size
            ship(idxs, lambda: np.stack(imgs, axis=0))
        else:
            # a shape-change flush pads to --stack by repeating the last
            # image, so that each image shape keeps one stack shape
            ship(idxs, lambda: pad_stack(imgs, stack))
        pending = []

    t0 = time.perf_counter()
    total_mp = 0.0
    # with --resume only the inputs not journaled ok are decoded at all
    work_idx = [i for i in range(len(paths)) if i not in resumed]
    work_paths = [paths[i] for i in work_idx]
    seen: set[int] = set()
    try:
        for j, img, dig in batch_load(work_paths, n_threads=args.threads, on_error="skip",
                                      with_digests=True):
            i = work_idx[j]
            digests.setdefault(i, dig)
            # the kill point of the --resume tests: an armed batch.interrupt
            # aborts the run here, mid-stream
            failpoints.maybe_fail("batch.interrupt", index=i, path=paths[i])
            seen.add(i)
            if pending and (len(pending) >= stack or pending[-1][1].shape != img.shape):
                flush_pending()
            pending.append((i, img))
            total_mp += img.shape[0] * img.shape[1] / 1e6
            if stack == 1:
                flush_pending()
        flush_pending(final=True)
    finally:
        # drain every dispatched item (outputs written, journal lines
        # appended) even while an interrupt propagates: the work that
        # finished is resumable, the rest looks never started
        engine.close()
    # decode failures, skipped by batch_load: journal lines so that
    # --resume retries exactly these
    for j in range(len(work_paths)):
        i = work_idx[j]
        if i not in seen and i not in failed:
            failed[i] = "decode failed (skipped)"
            if journal is not None:
                journal.record_failed(rels[i], digest(i), failed[i])
    wall = time.perf_counter() - t0
    eng = engine.metrics.snapshot()

    def fmt(v: float, unit: str) -> str:
        return f"{v:.3g} {unit}" if v < 1 else f"{v:.1f} {unit}"

    mp_s, rate_s = fmt(total_mp, "MP"), fmt(total_mp / wall, "MP/s")
    log.info("processed %d/%d images (%s) in %.2fs (%s end-to-end)%s", done, len(paths), mp_s,
             wall, rate_s,
             f" [{len(resumed)} resumed, {len(failed)} failed]" if resumed or failed else "")
    if eng["submitted"]:
        log.info("%s", engine.metrics.summary_line())
    if args.show_timing:
        idle = eng["device_idle_frac"]
        print(f"batch [{pipe.name}] impl={args.impl} plan={args.plan} device={dev}: "
              f"{done}/{len(paths)} images, {mp_s} in {wall:.2f}s ({rate_s} end-to-end incl. "
              f"kernel builds and I/O; inflight {inflight}, peak {eng['inflight_peak']}"
              + (f", device idle {idle * 100:.0f}%" if idle is not None else "") + ")")
    skipped = [paths[i] for i in range(len(paths)) if i not in seen and i not in resumed]
    if args.json_metrics:
        emit_json_metrics(
            {
                "event": "batch",
                "ops": pipe.name,
                "impl": args.impl,
                "inputs": len(paths),
                "processed": done,
                "resumed": len(resumed),
                "skipped": skipped,
                "failed": {rels[i]: msg for i, msg in sorted(failed.items())},
                "journal": journal.path if journal is not None else None,
                "total_mp": total_mp,
                "wall_s": wall,
                "mp_per_s": total_mp / wall if wall > 0 else None,
                "inflight": inflight,
                "io_threads": args.io_threads,
                "engine": eng,
            },
            None if args.json_metrics == "-" else args.json_metrics,
        )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(registry.render())
        log.info("metrics snapshot -> %s", args.metrics_out)
    _export_trace(args, log)
    return 0 if done + len(resumed) == len(paths) else 1


def _stream_inflight(args) -> int:
    """The in-flight tile dispatches of both stream entry points (`stream`
    and `batch --stream-rows`): --inflight, else MCIM_STREAM_INFLIGHT."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    return max(1, args.inflight or env_registry.get_int("MCIM_STREAM_INFLIGHT") or 2)


def _batch_stream(args, paths, rels, resumed, journal, digest_fn, pipe, log, dev) -> int:
    """cmd_batch's streaming lane (--stream-rows): every input runs through
    the tile engine with its output encoded incrementally, so a gigapixel
    input in a batch directory costs band memory, not frame memory. One
    ordered engine serves every input; each input's pinned staging buffers
    are released when its stream ends. The journal keeps one record per
    input (digest-verified), so --resume composes as in the whole-image
    lane."""
    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics
    from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
        open_tile_reader,
        open_tile_writer,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op
    from mpi_cuda_imagemanipulation_tpu_torch.stream import StreamMetrics, stream_pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import TileStager
    from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import out_channels
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics

    if args.impl not in ("auto", "torch", "mxu"):
        raise ValueError(
            "--stream-rows computes tiles with the stage walker (--impl torch, mxu or "
            f"auto; the stream has no kernel route, as in the JAX package); got {args.impl!r}"
        )
    metrics = StreamMetrics()
    inflight = _stream_inflight(args)
    engine = Engine(
        inflight=inflight,
        io_threads=max(1, args.io_threads),
        stage=TileStager(dev, inflight=inflight, metrics=metrics),
        metrics=EngineMetrics(registry=metrics.registry),
        ordered_done=True,
        name="batch-stream",
    )
    done = 0
    failed: dict[int, str] = {}
    total_mp = 0.0
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(paths):
            if i in resumed:
                continue
            rel = rels[i]
            try:
                reader = open_tile_reader(p)
                ops = pipe.ops
                if not args.gray_output and out_channels(ops, reader.channels) == 1:
                    # the batch lane's gray -> RGB replication contract
                    ops = (*ops, make_op("gray2rgb"))
                base, ext = os.path.splitext(rel)
                if ext.lower() not in (".png", ".ppm", ".pgm", ".pnm"):
                    log.info("%s: no incremental encoder for %r; writing .png", rel, ext)
                    rel = base + ".png"
                dst = os.path.join(args.output_dir, rel)
                os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
                writer = open_tile_writer(dst, reader.height, reader.width,
                                          out_channels(ops, reader.channels))
                total_mp += reader.height * reader.width / 1e6
                stream_pipeline(reader, writer, ops, tile_rows=args.stream_rows, impl=args.impl,
                                plan=args.plan, device=dev, metrics=metrics, engine=engine)
                writer.close()
            except Exception as e:  # noqa: BLE001 - fails this input only, exit 1
                failed[i] = f"{type(e).__name__}: {e}"
                log.error("failed %s: %s", rels[i], failed[i])
                if journal is not None:
                    journal.record_failed(rels[i], digest_fn(i), failed[i])
                continue
            if journal is not None:
                journal.record_ok(rels[i], digest_fn(i), rel)
            done += 1
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    log.info("streamed %d/%d inputs (%.1f MP) in %.2fs, peak resident %.1f MiB", done,
             len(paths), total_mp, wall, metrics.peak_resident_bytes / 2**20)
    eng = engine.metrics.snapshot()
    if args.show_timing:
        idle = eng["device_idle_frac"]
        print(f"batch [{pipe.name}] impl={args.impl} plan={args.plan} device={dev} "
              f"stream-rows {args.stream_rows}: {done}/{len(paths)} images, {total_mp:.1f} MP in "
              f"{wall:.2f}s ({total_mp / wall:.1f} MP/s end-to-end; peak resident "
              f"{metrics.peak_resident_bytes / 2**20:.2f} MiB"
              + (f", device idle {idle * 100:.0f}%" if idle is not None else "") + ")")
    if args.json_metrics:
        emit_json_metrics(
            {
                "event": "batch",
                "mode": "stream",
                "ops": pipe.name,
                "impl": args.impl,
                "stream_rows": args.stream_rows,
                "inputs": len(paths),
                "processed": done,
                "resumed": len(resumed),
                "failed": {rels[i]: m for i, m in sorted(failed.items())},
                "total_mp": total_mp,
                "wall_s": wall,
                "peak_resident_bytes": metrics.peak_resident_bytes,
                "engine": eng,
            },
            None if args.json_metrics == "-" else args.json_metrics,
        )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.registry.render())
    _export_trace(args, log)
    return 0 if done + len(resumed) == len(paths) else 1


def cmd_stream(args: argparse.Namespace) -> int:
    """`stream`: one image of any height (or a video frame sequence) through
    the tile engine, the JAX package's ``cmd_stream`` in the port's terms:
    fixed-shape row bands, pinned H2D staging, seam-stitched halos, ordered
    incremental encode. Byte-equal to the whole-image golden path; peak
    resident bytes follow --tile-rows/--inflight, not image size. Exit 1
    when a tile failed (the durable prefix is journaled; --resume), 3 when
    no video frame matches."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
        PNMTileWriter,
        SyntheticTileReader,
        open_tile_reader,
        open_tile_writer,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import BatchJournal
    from mpi_cuda_imagemanipulation_tpu_torch.stream import (
        DEFAULT_TILE_ROWS,
        StreamMetrics,
        plan_tiles,
        resumable_tiles,
        stream_fingerprint,
        stream_pipeline,
        stream_video,
        validate_stream_ops,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import out_channels
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger

    dev = resolve_device(args.device)
    _arm_failpoints(args)
    _configure_tracing(args)
    log = get_logger()
    tile_rows = (args.tile_rows or env_registry.get_int("MCIM_STREAM_TILE_ROWS")
                 or DEFAULT_TILE_ROWS)
    inflight = _stream_inflight(args)
    metrics = StreamMetrics()

    # -- video mode ---------------------------------------------------------
    if args.video_frames:
        import glob as globmod

        if not args.output_dir:
            raise ValueError("--video-frames needs --output-dir")
        frames = sorted(p for p in globmod.glob(args.video_frames) if os.path.isfile(p))
        if not frames:
            log.error("no frames match %s", args.video_frames)
            return 3
        journal = None
        if not args.no_journal:
            journal = BatchJournal(args.journal or os.path.join(args.output_dir,
                                                                ".mcim_stream_journal.jsonl"))
        rec = stream_video(frames, args.output_dir, args.ops, tile_rows=tile_rows,
                           inflight=inflight, io_threads=max(1, args.io_threads), impl=args.impl,
                           plan=args.plan, device=dev, out_ext=args.out_ext, metrics=metrics,
                           journal=journal, resume=args.resume)
        log.info("video: %d/%d frames (%d resumed) in %.2fs (%.1f fps), peak resident %.1f MiB",
                 rec["frames_done"], rec["frames"], rec["frames_resumed"], rec["wall_s"],
                 rec["fps"] or 0.0, rec["peak_resident_bytes"] / 2**20)
        if args.show_timing:
            idle = rec["engine"]["device_idle_frac"]
            print(f"video [{args.ops}] impl={args.impl} device={dev}: {rec['frames_done']}/"
                  f"{rec['frames']} frames in {rec['wall_s']:.2f}s ({rec['fps'] or 0.0:.1f} fps, "
                  f"tile_rows {tile_rows}, inflight {inflight}, peak resident "
                  f"{rec['peak_resident_bytes'] / 2**20:.1f} MiB"
                  + (f", device idle {idle * 100:.0f}%" if idle is not None else "") + ")")
        if args.json_metrics:
            emit_json_metrics({"event": "stream", "mode": "video", "ops": args.ops, **rec},
                              None if args.json_metrics == "-" else args.json_metrics)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(metrics.registry.render())
        _export_trace(args, log)
        return 0

    # -- single-image mode --------------------------------------------------
    if bool(args.input) == bool(args.synthetic):
        raise ValueError("stream needs exactly one of --input/--synthetic")
    if not args.output:
        raise ValueError("stream needs --output")
    if args.synthetic:
        dims = [int(v) for v in args.synthetic.lower().split("x")]
        if len(dims) not in (2, 3):
            raise ValueError("--synthetic wants HxW or HxWxC")
        reader = SyntheticTileReader(dims[0], dims[1], channels=dims[2] if len(dims) == 3 else 3,
                                     seed=0)
    else:
        reader = open_tile_reader(args.input)

    pipe = Pipeline.parse(args.ops)
    halo = validate_stream_ops(pipe.ops)
    out_c = out_channels(pipe.ops, reader.channels)
    tiles = plan_tiles(reader.height, tile_rows, halo)
    fingerprint = stream_fingerprint(pipe.name, reader.height, reader.width, reader.channels,
                                     tile_rows, args.impl)
    journal = None
    if not args.no_journal:
        journal = BatchJournal(args.journal or args.output + ".journal.jsonl")

    resume_tiles = 0
    if args.resume:
        if journal is None:
            raise ValueError("--resume needs the journal (drop --no-journal)")
        if os.path.splitext(args.output)[1].lower() not in (".ppm", ".pgm", ".pnm"):
            raise ValueError(
                "image-mode --resume needs a ppm/pgm output (a PNG compressor's state does not "
                "survive a kill); video-mode resume works per frame with any container"
            )
        resume_tiles = resumable_tiles(journal, "stream", fingerprint, len(tiles))
    if resume_tiles and os.path.exists(args.output):
        writer = PNMTileWriter.resume(args.output, reader.height, reader.width, out_c,
                                      tiles[resume_tiles - 1].out_hi)
    else:
        resume_tiles = 0
        writer = open_tile_writer(args.output, reader.height, reader.width, out_c)

    root = obs_trace.start_trace("stream", ops=pipe.name, impl=args.impl, h=reader.height,
                                 w=reader.width, tile_rows=tile_rows)
    t0 = time.perf_counter()
    with root:
        try:
            res = stream_pipeline(
                reader, writer, pipe.ops, tile_rows=tile_rows, inflight=inflight,
                io_threads=max(1, args.io_threads), impl=args.impl, plan=args.plan, device=dev,
                metrics=metrics, journal=journal, resume_tiles=resume_tiles,
                trace_parent=root.context() if root is not obs_trace.NOOP_SPAN else None,
            )
        except RuntimeError as e:
            # completed tiles are durable and journaled: exit 1 so that a
            # scripted caller retries with --resume; closing the writer is
            # what makes the journaled prefix durable
            writer.close()
            log.error("%s", e)
            root.set(error="StreamError")
            _export_trace(args, log)
            return 1
        writer.close()
    wall = time.perf_counter() - t0
    mp = reader.height * reader.width / 1e6
    log.info("streamed %dx%d (%.1f MP) as %d tiles (%d resumed) in %.2fs, peak resident %.1f MiB "
             "vs %.1f MiB whole-image", reader.height, reader.width, mp, res.tiles,
             res.tiles_resumed, wall, res.peak_resident_bytes / 2**20,
             reader.height * reader.width * reader.channels / 2**20)
    if args.show_timing:
        idle = res.engine.get("device_idle_frac")
        print(f"stream [{pipe.name}] impl={args.impl} device={dev}: {mp:.1f} MP in {wall:.2f}s "
              f"({mp / wall:.1f} MP/s end-to-end; tile_rows {tile_rows}, inflight {inflight}, "
              f"{res.tiles} tiles, {res.compiles} tile functions, peak resident "
              f"{res.peak_resident_bytes / 2**20:.2f} MiB"
              + (f", device idle {idle * 100:.0f}%" if idle is not None else "") + ")")
    if args.json_metrics:
        emit_json_metrics(
            {
                "event": "stream",
                "mode": "image",
                "ops": pipe.name,
                "impl": args.impl,
                "height": reader.height,
                "width": reader.width,
                "channels": reader.channels,
                "tile_rows": tile_rows,
                "inflight": inflight,
                "halo": halo,
                "mp": mp,
                "mp_per_s": mp / wall if wall > 0 else None,
                **res.as_dict(),
            },
            None if args.json_metrics == "-" else args.json_metrics,
        )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.registry.render())
        log.info("metrics snapshot -> %s", args.metrics_out)
    _export_trace(args, log)
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Online serving: warm the shape-bucket function cache on the device,
    start the micro-batching scheduler, serve HTTP until SIGTERM/SIGINT,
    then drain (admission stops, queued + in-flight work flushes under
    --drain-deadline-s), dump the flight recorder and write the stats
    record. The JAX package's ``cmd_serve``; its pod mode (--replicas > 1)
    hands over to `cmd_fabric` with the same flags."""
    import signal
    import threading

    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig, Server
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger

    if args.impl in ("cuda", "swar"):
        raise ValueError(
            f"serve --impl {args.impl}: the hand-written kernels extend edges at the "
            "bucket border, and a bucket-padded request needs its border rebuilt at its "
            "own true shape; serve with --impl torch, mxu or auto"
        )
    if args.replicas > 1:
        # pod mode: same flags, but the process becomes the front-door
        # router over N supervised replica workers (fabric/); the `fabric`
        # subcommand exposes the router's own knobs
        for name, default in (
            ("heartbeat_s", None), ("stale_s", None), ("forward_attempts", None),
            ("mesh_shards", 0), ("slo", None),
            ("autoscale", False), ("min_replicas", None), ("max_replicas", None),
            ("systolic", None), ("tune", False), ("tune_arms", None),
            ("federate", None), ("pod_id", None),
        ):
            if not hasattr(args, name):
                setattr(args, name, default)
        return cmd_fabric(args)
    _arm_failpoints(args)
    _configure_tracing(args)
    log = get_logger()
    try:
        channels = tuple(sorted({int(c) for c in args.channels.split(",") if c.strip()}))
    except ValueError:
        raise ValueError(f"--channels must be comma-separated ints: {args.channels!r}") from None
    if not channels or not set(channels) <= {1, 3}:
        raise ValueError(f"--channels entries must be 1 and/or 3, got {channels}")
    cfg = ServeConfig(
        ops=args.ops,
        buckets=parse_buckets(args.buckets),
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        queue_depth=args.queue_depth,
        channels=channels,
        shards=args.shards,
        backend="torch" if args.impl == "auto" else args.impl,
        plan=args.plan,
        default_deadline_ms=args.deadline_ms,
        device=args.device,
        retry_attempts=args.retry_attempts,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        inflight=args.inflight,
        io_threads=args.io_threads,
    )
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        log.info("signal %s: graceful drain (deadline %.0fs)",
                 signal.Signals(signum).name, args.drain_deadline_s)
        stop_evt.set()

    srv = Server(cfg, args.host, args.port)  # raises before any handler is set
    prev_handlers = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        srv.start()
        log.info(
            "serving [%s] on %s:%d (buckets %s, max_batch %d, max_delay %.1fms, "
            "queue_depth %d, shards %d, device %s): POST /v1/process, GET /healthz, "
            "/stats, /metrics",
            srv.app.pipe.name, args.host or "0.0.0.0", srv.address[1], args.buckets,
            args.max_batch, args.max_delay_ms, args.queue_depth, args.shards,
            srv.app.cache.device,
        )
        stop_evt.wait()
    except KeyboardInterrupt:
        log.info("interrupt: draining and shutting down")
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        srv.close(drain=True, deadline_s=args.drain_deadline_s)
        # the drain is a flight-recorder dump trigger: the ring's serving
        # facts (hot buckets, breaker and failpoint history) become the
        # shutdown post-mortem (obs/recorder.py)
        dump_path = recorder.dump("sigterm_drain", extra={"entry": "serve"})
        if dump_path:
            log.info("recorder dump -> %s", dump_path)
        if args.json_metrics:
            emit_json_metrics({"event": "serve", **srv.app.stats()}, args.json_metrics)
        _export_trace(args, log)
    return 0


def cmd_fabric(args: argparse.Namespace) -> int:
    """Pod-scale serving: front-door router + N supervised replica worker
    processes (fabric/), each serving on `--device` in its own process.
    The router owns --port; replicas bind ephemeral ports and register via
    heartbeat. SIGTERM/SIGINT drains the whole pod (replicas flush
    in-flight work, then the router stops). The JAX package's
    ``cmd_fabric``."""
    import signal
    import threading

    from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import default_heartbeat_s
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import RouterConfig
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import Fabric, FabricConfig
    from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import ENV_SYSTOLIC
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics, get_logger

    # the replicas would each raise at start; refuse here, before any spawn
    resolve_device(args.device)
    _arm_failpoints(args)
    _configure_tracing(args)
    log = get_logger()
    systolic = (args.systolic if args.systolic is not None
                else env_registry.get_bool(ENV_SYSTOLIC))
    cfg = FabricConfig(
        replicas=args.replicas,
        ops=args.ops,
        buckets=args.buckets,
        channels=args.channels,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        queue_depth=args.queue_depth,
        impl="torch" if args.impl == "auto" else args.impl,
        device=args.device,
        plan=args.plan,
        tune=args.tune,
        tune_arms=args.tune_arms,
        heartbeat_s=args.heartbeat_s,
        router=RouterConfig(
            buckets=parse_buckets(args.buckets),
            stale_s=args.stale_s,
            forward_attempts=args.forward_attempts,
            slo_specs=args.slo,
        ),
        mesh_shards=args.mesh_shards,
        autoscale=args.autoscale,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        systolic=systolic,
        federate=args.federate,
        pod_id=args.pod_id,
    )
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        log.info("signal %s: draining the fabric", signal.Signals(signum).name)
        stop_evt.set()

    prev_handlers = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    fab = Fabric(cfg)
    try:
        fab.start(args.host, args.port)
        log.info(
            "fabric serving [%s] on %s:%d: router over %d replicas on %s (buckets %s, "
            "heartbeat %.2fs%s): POST /v1/process, GET /healthz, /stats, /metrics, /slo",
            args.ops, args.host or "0.0.0.0", fab.router.address[1], args.replicas,
            args.device, args.buckets,
            cfg.heartbeat_s if cfg.heartbeat_s is not None else default_heartbeat_s(),
            f", mesh lane {args.mesh_shards} shards"
            if args.mesh_shards else "",
        )
        stop_evt.wait()
    except KeyboardInterrupt:
        log.info("interrupt: draining the fabric")
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        stats = fab.stats() if fab.supervisor is not None else None
        fab.close(drain=True)
        if args.json_metrics and stats is not None:
            emit_json_metrics({"event": "fabric", **stats}, args.json_metrics)
        _export_trace(args, log)
    return 0


def cmd_graph(args: argparse.Namespace) -> int:
    """`graph`: validate (and optionally run) a pipeline-spec DAG from a
    file, the offline form of the pipeline service's POST surface. A
    refusal prints its taxonomy code and exits 2; --validate-only plans on
    the host and touches no device."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.graph import (
        compile_graph,
        dag_fingerprint,
        graph_callable,
        parse_spec,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        load_image,
        save_image,
        synthetic_image,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import as_image_tensor, resolve_device
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import emit_json_metrics

    try:
        with open(args.spec, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise FileNotFoundError(f"cannot read --spec: {e}") from None
    try:
        graph = parse_spec(raw)
    except SpecError as e:
        print(f"spec rejected [{e.code}]: {e}", file=sys.stderr)
        return 2
    if args.validate_only:
        program = compile_graph(graph, plan=args.plan, backend=args.impl, device="cpu")
        print(graph.describe())
        print(program.describe())
        print(f"pipeline id: {dag_fingerprint(graph)}")
        return 0
    if bool(args.input) == bool(args.synthetic):
        raise ValueError("graph needs exactly one of --input/--synthetic")
    dev = resolve_device(args.device)
    if args.synthetic:
        dims = [int(v) for v in args.synthetic.lower().split("x")]
        if len(dims) not in (2, 3):
            raise ValueError("--synthetic wants HxW or HxWxC")
        img = synthetic_image(dims[0], dims[1], channels=dims[2] if len(dims) == 3 else 3,
                              seed=0)
    else:
        img = load_image(args.input)
    try:
        graph.check_channels(img.shape[2] if img.ndim == 3 else 1)
    except SpecError as e:
        print(f"request rejected [{e.code}]: {e}", file=sys.stderr)
        return 2
    program = compile_graph(graph, plan=args.plan, backend=args.impl, width=img.shape[1],
                            device=dev)
    print(graph.describe())
    print(program.describe())
    print(f"pipeline id: {dag_fingerprint(graph)}")
    fn = graph_callable(program, impl=args.impl)
    x = as_image_tensor(img, dev)
    t0 = time.perf_counter()
    out = fn(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0  # the first call, on the host clock
    print(f"ran {len(program.steps)} steps in {wall * 1e3:.1f} ms (first call, host clock; "
          f"outputs: {sorted(out)})")
    if args.output:
        save_image(args.output, out["image"].cpu().numpy())
        print(f"image -> {args.output}")
    if args.histogram_out:
        if "histogram" not in out:
            raise ValueError("--histogram-out needs a spec with outputs.histogram")
        with open(args.histogram_out, "w") as f:
            json.dump([int(v) for v in out["histogram"].cpu()], f)
        print(f"histogram -> {args.histogram_out}")
    if args.stats_out:
        if "stats" not in out:
            raise ValueError("--stats-out needs a spec with outputs.stats")
        s = out["stats"]
        stats = {"count": int(s["count"]), "min": int(s["min"]), "max": int(s["max"]),
                 "mean": round(float(s["mean"]), 4)}
        with open(args.stats_out, "w") as f:
            json.dump(stats, f)
        print(f"stats -> {args.stats_out}")
    if args.json_metrics:
        emit_json_metrics(
            {
                "event": "graph",
                "spec": args.spec,
                "pipeline_id": dag_fingerprint(graph),
                "nodes": len(graph.nodes),
                "segments": program.n_segments,
                "merges": program.n_merges,
                "mode": program.mode,
                "impl": args.impl,
                "device": str(dev),
                "clock": "host",
                "wall_ms": wall * 1e3,
                "outputs": sorted(out),
            },
            None if args.json_metrics == "-" else args.json_metrics,
        )
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch._version import __version__
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import BACKENDS
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
        FAMILIES,
        registry_family_table,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels

    print(f"mpi_cuda_imagemanipulation_tpu_torch {__version__}")
    print(f"python {sys.version.split()[0]}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    print(f"cuda available: {torch.cuda.is_available()}")
    print(f"cuda devices: {torch.cuda.device_count()}")
    dist_ok = torch.distributed.is_available()
    print(
        "torch.distributed: "
        + (
            f"nccl {torch.distributed.is_nccl_available()}, "
            f"gloo {torch.distributed.is_gloo_available()}"
            if dist_ok else "not available"
        )
    )
    if torch.cuda.is_available() and args.device.startswith("cuda"):
        for i in range(torch.cuda.device_count()):
            print(f"device {i}: {torch.cuda.get_device_name(i)}")
        print(
            "nvidia-smi: " + _tool_output(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
            )
        )
    print(f"backends: {', '.join(BACKENDS)}")
    table = registry_family_table()
    print("ops:")
    for family in FAMILIES:
        print(f"  {family}: {', '.join(sorted(n for n, f in table.items() if f == family))}")
    print("kernels:")
    for k in KERNELS:
        print(f"  {k}")
    try:
        nvcc = kernels.find_nvcc()
        version = _tool_output([nvcc, "--version"]).splitlines()[-1]
        print(f"nvcc: {nvcc} ({version})")
    except RuntimeError as e:
        print(f"nvcc: {e}")
    try:
        import triton  # noqa: F401

        print(f"triton: {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    _print_calibration(args.device)
    return 0


def _print_calibration(device) -> None:
    """The calibration store's records for the device's kind, one line."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    kind = calibration.current_device_kind(device)
    rec = calibration.entries().get(kind)
    parts = []
    for name, ent in sorted(rec.items() if isinstance(rec, dict) else ()):
        if not isinstance(ent, dict):
            continue
        if name in ("backend_choice", "stage_arm", "plan_choice"):
            parts.extend(
                f"{name.split('_')[0]}:{key}={e.get('choice')}"
                for key, e in sorted(ent.items()) if isinstance(e, dict)
            )
        else:
            parts.append(f"{name}: block_h={ent.get('block_h')}")
    where = f"({calibration.calib_path()}) [{kind}]"
    print(f"calibration {where}: " + (", ".join(parts) if parts else
                                      "none (run `autotune` on the card)"))


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        return {"run": cmd_run, "batch": cmd_batch, "stream": cmd_stream, "serve": cmd_serve,
                "fabric": cmd_fabric, "graph": cmd_graph, "autotune": cmd_autotune, "info": cmd_info}[args.cmd](args)
    except (ValueError, RuntimeError, NotImplementedError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
