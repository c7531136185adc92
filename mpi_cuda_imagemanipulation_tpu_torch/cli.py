"""Command line: ``python -m mpi_cuda_imagemanipulation_tpu_torch run|info``.

``run`` applies a pipeline to one image, on the CUDA device by default,
through the hand-written kernels (``--impl auto``, the default, runs what
``--impl cuda`` runs), the tensor-core route
(``--impl mxu``), the SWAR kernels (``--impl swar``) or PyTorch ops
(``--impl torch``), in the execution structure ``--plan`` selects
(models/pipeline.py says what each pair runs). ``--shards N`` row-shards
the image over N devices with ghost-strip exchange (parallel/api.py); under
``torchrun`` every rank runs the same command and holds its share of the
shards. ``info`` prints the toolchain, the devices, the backends and the
kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import REFERENCE_PIPELINE_SPEC
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import PLAN_MODES


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
        help="auto (default): every eligible op group on its hand-written "
        "kernel, which is what cuda runs; "
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
        "plain version); 'auto' is 'off' under cuda and 'fused' under torch "
        "and mxu. Byte-identical output in every mode",
    )
    run.add_argument(
        "--device", default="cuda", help="torch device (default cuda; cpu runs the "
        "plain PyTorch versions of the kernels)",
    )
    run.add_argument(
        "--shards", default="1",
        help="shard the image over devices: N row-shards (the mpirun -np "
        "analogue) with ghost-strip halo exchange; 1 = single device. With "
        "--device cuda the first N cards (fewer raise), with --device cpu N "
        "CPU slots; under torchrun each rank holds N / WORLD_SIZE shards",
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
        help="row height of the stencil kernels' output tiles (K2 and K4, "
        "default 16; under --impl swar K6-K8 only, default 32)",
    )
    run.add_argument(
        "--gray-output", action="store_true",
        help="write single-channel output instead of replicating gray to RGB "
        "(the reference replicates: kernel.cu:210)",
    )
    run.add_argument("--show-timing", action="store_true", help="print timing")
    run.add_argument(
        "--json-metrics", default=None,
        help="write a JSON metrics line to this path ('-' = stdout)",
    )

    info = sub.add_parser("info", help="print toolchain and device info")
    info.add_argument("--device", default="cuda", help="device to report on")
    return p


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
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo, mesh as pmesh
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import as_image_tensor
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

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

    t0 = time.perf_counter()
    out = once()
    sync()
    exchange_rounds = halo.exchanges.rounds
    first_s = time.perf_counter() - t0  # includes the kernels' build on first use
    steady_ms = None
    if args.show_timing or args.json_metrics:
        if dev.type == "cuda":
            steady_ms = device_time_ms(once)
        else:  # host time of the CPU run; not a device number
            t0 = time.perf_counter()
            once()
            steady_ms = (time.perf_counter() - t0) * 1e3
    if writes:
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
        line = json.dumps(rec)
        if args.json_metrics == "-":
            print(line)
        else:
            with open(args.json_metrics, "a") as f:
                f.write(line + "\n")
    return 0


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
    return 0


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        return {"run": cmd_run, "info": cmd_info}[args.cmd](args)
    except (ValueError, RuntimeError, NotImplementedError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
