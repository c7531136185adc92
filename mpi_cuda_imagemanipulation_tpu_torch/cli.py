"""Command line: ``python -m mpi_cuda_imagemanipulation_tpu_torch run|info``.

``run`` applies a pipeline to one image, on the CUDA device by default,
through the hand-written kernels (``--impl cuda``) or the golden PyTorch
ops (``--impl torch``). ``info`` prints the toolchain and the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import REFERENCE_PIPELINE_SPEC


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
        choices=("cuda", "torch"),
        default="cuda",
        help="cuda: the hand-written kernels, one launch per op group; "
        "torch: the golden PyTorch ops",
    )
    run.add_argument(
        "--device", default="cuda", help="torch device (default cuda; cpu runs the "
        "plain PyTorch versions of the kernels)",
    )
    run.add_argument(
        "--block", type=int, default=None,
        help="row height of the stencil kernel's output tiles (default 16)",
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


def run_image(pipe, img, *, impl: str, device, block_h=None, gray_output=False):
    """The pipeline on one image, as ``run`` computes it: the pipeline, then,
    unless `gray_output`, gray output replicated to RGB on the device (the
    reference's GRAY2BGR, kernel.cu:210) by the same backend. Returns a
    tensor on `device`."""
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    out = pipe.jit(backend=impl, block_h=block_h, device=device)(img)
    if not gray_output and out.ndim == 2:
        out = Pipeline.parse("gray2rgb").jit(backend=impl, device=device)(out)
    return out


def cmd_run(args: argparse.Namespace) -> int:
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import (
        as_image_tensor,
        resolve_device,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    dev = resolve_device(args.device)
    pipe = Pipeline.parse(args.ops)
    img = load_image(args.input)
    x = as_image_tensor(img, dev)

    def once():
        return run_image(
            pipe, x, impl=args.impl, device=dev, block_h=args.block,
            gray_output=args.gray_output,
        )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    out = once()
    sync()
    first_s = time.perf_counter() - t0  # includes the kernels' build on first use
    steady_ms = None
    if args.show_timing or args.json_metrics:
        if dev.type == "cuda":
            steady_ms = device_time_ms(once)
        else:  # host time of the CPU run; not a device number
            t0 = time.perf_counter()
            once()
            steady_ms = (time.perf_counter() - t0) * 1e3
    save_image(args.output, out.cpu().numpy())

    mp = img.shape[0] * img.shape[1] / 1e6
    clock = "device (CUDA events)" if dev.type == "cuda" else "host"
    if args.show_timing:
        print(
            f"pipeline [{pipe.name}] impl={args.impl} device={dev}: first call "
            f"{first_s * 1e3:.3f} ms, steady-state {steady_ms:.4f} ms {clock} "
            f"({mp / (steady_ms / 1e3):.1f} MP/s)"
        )
    if args.json_metrics:
        rec = {
            "event": "run",
            "ops": pipe.name,
            "impl": args.impl,
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


def _tool_output(cmd: list[str]) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() if r.returncode == 0 else f"unavailable (exit {r.returncode})"


def cmd_info(args: argparse.Namespace) -> int:
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch._version import __version__
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels

    print(f"mpi_cuda_imagemanipulation_tpu_torch {__version__}")
    print(f"python {sys.version.split()[0]}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    print(f"cuda available: {torch.cuda.is_available()}")
    if torch.cuda.is_available() and args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}")
        print(
            "nvidia-smi: " + _tool_output(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
            )
        )
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
