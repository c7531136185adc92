#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mpi_cuda_imagemanipulation_tpu_torch/
ops/csrc`` with nvcc, then runs three phases; any failure raises and the
script exits non-zero without printing a result:

1. Kernel against plain version on the card. K1 (pointwise group) and K2
   (fused stencil group) must give the same bytes as their plain PyTorch
   versions for every kernel-safe pointwise op, every stencil of the
   registry at 1080x1920 RGB and at odd shapes, and the reference
   pipeline's fused group. A small input is also held against the
   loop-level emulator of the reference program (tests/_c_reference.py).
2. The main path at full size: the `run` command's computation
   (cli.run_image) on the 8K RGB synthetic image, for the reference
   pipeline and for gaussian:5, through the kernels and through the golden
   ops, byte-equal, with each kernel's launches counted over the run.
3. Numbers: CUDA-event times of each kernel and its plain version at the
   main path's shapes, the bound from bytes and operations, a PyTorch
   library call as a yardstick where one computes the same function, and
   each path end to end.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
MAIN_H, MAIN_W = 4320, 7680  # the 8K frame of the gaussian5_8k workload
SPECS = {
    "reference": "grayscale,contrast:3.5,emboss:3",
    "gaussian5_8k": "gaussian:5",
}
POINTWISE_CASES = [
    "grayscale", "grayscale601", "sepia", "contrast:3.5", "contrast:3",
    "brightness:20", "brightness:-7.5", "invert", "threshold:100",
    "posterize:3", "quantize:6", "solarize:100", "gray2rgb",
    "sepia,invert,brightness:9,grayscale,contrast:3.5,threshold:90,gray2rgb,solarize:60",
]
STENCIL_CASES = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3",
    "gaussian:5", "gaussian:7", "box:1", "box:3", "box:5", "sobel", "prewitt",
    "scharr", "sharpen", "unsharp", "laplacian:4", "laplacian:8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "filter:0.1/0.2/0.1/0.2/0.3/0.2/0.1/0.2/0.1",
    "filter:" + "/".join(str(v) for v in range(-24, 25)) + ":0.01",
    "erode:3", "erode:5", "dilate:3", "dilate:7", "median:3", "median:5",
]
FUSED_CASES = [
    "grayscale,contrast:3.5,emboss:3", "sepia,gaussian:5", "grayscale,gaussian:5",
    "invert,brightness:-20,median:5", "grayscale,gray2rgb,sobel",
    "grayscale601,contrast:3,emboss101:3",
]
SHAPES = [(1080, 1920), (37, 53), (257, 301)]


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def split_group(spec):
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import group_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    groups = group_ops(make_pipeline_ops(spec))
    assert len(groups) == 1, f"{spec} is not one kernel group"
    return groups[0]


def input_for(pointwise, shape, seed, device):
    """A seeded image for the group: the channels its first op needs, else
    RGB, or gray for odd seeds."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    first = next((op.in_channels for op in pointwise if op.in_channels), 0)
    img = synthetic_image(*shape, channels=first or (1 if seed % 2 else 3), seed=seed)
    return torch.from_numpy(img).to(device)


def check_equal(name, got, want):
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        err = (got.int() - want.int()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{name}: kernel != plain (shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, max abs err {err})")
    return 0


def phase1(device) -> int:
    """Every kernel case against its plain version; returns the case count."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    n = 0
    for spec in POINTWISE_CASES:
        pw, st = split_group(spec)
        assert st is None
        for seed, shape in enumerate(SHAPES):
            x = input_for(pw, shape, seed, device)
            check_equal(f"K1 {spec} {shape}", ck.pointwise_group(pw, x),
                        ck.pointwise_group_plain(pw, x))
            n += 1
    for spec in STENCIL_CASES + FUSED_CASES:
        pw, st = split_group(spec)
        for seed, shape in enumerate(SHAPES):
            x = input_for(pw, shape, seed, device)
            want = ck.stream_stencil_plain(pw, st, x)
            check_equal(f"K2 {spec} {shape}", ck.stream_stencil(pw, st, x), want)
            n += 1
            if seed == 0:  # other tile heights, including one above 48 KB of smem
                for tile_h in (5, 48):
                    check_equal(f"K2 {spec} {shape} tile_h={tile_h}",
                                ck.stream_stencil(pw, st, x, tile_h=tile_h), want)
                    n += 1
    print(f"phase 1: {n} kernel cases equal to their plain versions (max_abs_err 0)")
    return n


def phase1_reference(device) -> None:
    """The reference program on a small input against the repo's loop-level
    emulator of kernel.cu (float64, tests/_c_reference.py)."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    path = Path(__file__).resolve().parent / "tests" / "_c_reference.py"
    spec = importlib.util.spec_from_file_location("_c_reference", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    contrast_c, emboss_c = ref.contrast_c, ref.emboss_c
    grayscale_c, stencil_reflect101_c = ref.grayscale_c, ref.stencil_reflect101_c

    img = synthetic_image(48, 64, seed=7)
    gray = Pipeline.parse("grayscale").jit("cuda", device=device)(img).cpu().numpy()
    diff = np.abs(gray.astype(int) - grayscale_c(img).astype(int))
    assert diff.max() <= 3, "grayscale strays from the float64 reference"
    out = Pipeline.parse("contrast:3.5,emboss:3").jit("cuda", device=device)(gray)
    np.testing.assert_array_equal(out.cpu().numpy(), emboss_c(contrast_c(gray, 3.5), 3))
    from mpi_cuda_imagemanipulation_tpu_torch.ops import filters

    k2, scale = filters.gaussian_2d(5)
    g5 = Pipeline.parse("gaussian:5").jit("cuda", device=device)(gray)
    np.testing.assert_array_equal(g5.cpu().numpy(), stencil_reflect101_c(gray, k2, scale))
    print("phase 1: reference program on 48x64 equal to tests/_c_reference.py")


def phase2(device, x8k):
    """The main path at 8K through the kernels and the golden ops."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    launches = {}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        ck.reset_launch_counts()
        out = run_image(pipe, x8k, impl="cuda", device=device)
        torch.cuda.synchronize()
        counts = {"K1": ck.pointwise_group.launches, "K2": ck.stream_stencil.launches}
        want = run_image(pipe, x8k, impl="torch", device=device)
        assert out.shape == (MAIN_H, MAIN_W, 3) and out.dtype == torch.uint8, out.shape
        check_equal(f"main path {spec}", out, want)
        expected = {"K1", "K2"} if key == "reference" else {"K2"}
        for k in expected:
            if counts[k] < 1:
                raise AssertionError(f"main path {spec}: {k} was never launched")
        launches[key] = counts
        print(f"phase 2: {spec} at {MAIN_H}x{MAIN_W} RGB: cuda == torch, launches {counts}")
    return launches


def op_count(pointwise, stencil, n_pix: int, c_out: int) -> int:
    """Float32 operations the group does per image, counted from its ops."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import MEDIAN_NETWORKS

    per_op = {"grayscale": 8, "grayscale601": 8, "sepia": 27, "gray2rgb": 0,
              "invert": 1, "threshold": 1, "solarize": 2}
    prologue = 0
    for op in pointwise:
        base = op.name.rstrip("0123456789.-")
        prologue += per_op.get(base, 6)
    total = prologue * n_pix
    if stencil is not None:
        k = 2 * stencil.halo + 1
        if stencil.reduce == "median":
            st = 2 * len(MEDIAN_NETWORKS[k][0])
        elif stencil.reduce in ("min", "max"):
            st = 2 * (k - 1)
        elif stencil.separable is not None:
            st = 2 * (2 * k - 1) + 1
        else:
            nnz = sum(int((w != 0).sum()) for w in stencil.kernels)
            st = 2 * nnz + (4 if stencil.combine == "magnitude" else 0) + 1
        total += (st + 3) * n_pix * c_out
    return total


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase3(device, x8k, launches):
    import torch
    import torch.nn.functional as F

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import filters
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    mp = n_pix / 1e6
    rows = []

    def record(name, source, replaces, launch_count, fn, plain, c_in, c_out, pw, st,
               library=None):
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain at 8K, max abs err {err}")
        ms = device_time_ms(fn)
        plain_ms = device_time_ms(plain, reps=5, inner=2)
        library_ms = device_time_ms(library) if library is not None else None
        nbytes = (c_in + c_out) * n_pix
        bound_ms, bound_by = bound(nbytes, op_count(pw, st, n_pix, c_out))
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch_count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        rows.append(row)
        print(f"kernel {name}: {ms:.4f} ms ({mp / ms * 1e3:.1f} MP/s), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%}), plain "
              f"{plain_ms:.4f} ms, library {library_ms}, launches {launch_count}")

    # K2 on the reference group: 8K RGB in, gray out
    pw, st = split_group(SPECS["reference"])
    record(
        "K2 stream_stencil [grayscale,contrast3.5,emboss3]",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["reference"]["K2"],
        lambda: ck.stream_stencil(pw, st, x8k),
        lambda: ck.stream_stencil_plain(pw, st, x8k), 3, 1, pw, st,
    )
    # K1 on the reference path: the gray result replicated to RGB
    gray = ck.stream_stencil(pw, st, x8k)
    g2r, _ = split_group("gray2rgb")
    record(
        "K1 pointwise_group [gray2rgb]",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:540",
        launches["reference"]["K1"],
        lambda: ck.pointwise_group(g2r, gray),
        lambda: ck.pointwise_group_plain(g2r, gray), 1, 3, g2r, None,
        library=lambda: gray[..., None].expand(-1, -1, 3).contiguous(),
    )
    # K2 on gaussian:5, RGB in and out; the yardstick is a depthwise
    # float32 convolution of the pre-padded planes (TF32 off)
    pw5, st5 = split_group(SPECS["gaussian5_8k"])
    k2, _ = filters.gaussian_2d(5)
    weight = torch.from_numpy(k2).to(device).expand(3, 1, 5, 5).contiguous()
    xf = F.pad(x8k.permute(2, 0, 1)[None].float(), (2, 2, 2, 2), mode="reflect")
    record(
        "K2 stream_stencil [gaussian5]",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["gaussian5_8k"]["K2"],
        lambda: ck.stream_stencil(pw5, st5, x8k),
        lambda: ck.stream_stencil_plain(pw5, st5, x8k), 3, 3, pw5, st5,
        library=lambda: F.conv2d(xf, weight, groups=3),
    )
    del xf

    # each path's bound: every group reads its input and writes its output
    # once (reference: 3 -> 1 B, then 1 -> 3 B; gaussian:5: 3 -> 3 B)
    path_bytes = {"reference": 8 * n_pix, "gaussian5_8k": 6 * n_pix}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        t = {}
        for impl in ("cuda", "torch"):
            t[impl] = device_time_ms(
                lambda impl=impl: run_image(pipe, x8k, impl=impl, device=device),
                reps=5, inner=3,
            )
        bound_ms = path_bytes[key] / H100_BYTES_PER_S * 1e3
        print(f"path {key} [{spec}] {MAIN_H}x{MAIN_W} RGB in, RGB out: cuda "
              f"{t['cuda']:.4f} ms ({mp / t['cuda'] * 1e3:.1f} MP/s), bound "
              f"{bound_ms:.4f} ms by bytes ({bound_ms / t['cuda']:.1%}), plain (torch) "
              f"{t['torch']:.4f} ms ({mp / t['torch'] * 1e3:.1f} MP/s), launches "
              f"{launches[key]}")

    # every stencil of the registry through K2 at 8K RGB, kernel time only
    for spec in STENCIL_CASES:
        pws, sts = split_group(spec)
        ms = device_time_ms(lambda pws=pws, sts=sts: ck.stream_stencil(pws, sts, x8k),
                            reps=5, inner=5)
        bms, by = bound(6 * n_pix, op_count(pws, sts, n_pix, 3))
        print(f"sweep K2 {spec} 8K RGB: {ms:.4f} ms, bound {bms:.4f} ms by {by} "
              f"({bms / ms:.1%})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    phase1(device)
    phase1_reference(device)
    x8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    launches = phase2(device, x8k)
    rows = phase3(device, x8k, launches)
    torch.cuda.synchronize()

    print(f"gpu: {nvidia_smi()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
