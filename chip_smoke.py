#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mpi_cuda_imagemanipulation_tpu_torch/
ops/csrc`` with nvcc (one process per source, all at once), then runs
three phases; any failure raises and the script exits non-zero without
printing a result:

1. Kernel against plain version on the card. K1 (pointwise group), K2
   (fused stencil group) and K4 (fused plan stage) must give the same
   bytes as their plain PyTorch versions: every kernel-safe pointwise op,
   every stencil of the registry at 1080x1920 RGB and at odd shapes, the
   reference pipeline's fused group; for K4 also multi-stencil stages that
   mix edge modes, stages that change the channel count mid-stage, a
   halo-0 stage, the megakernel and plan_ab chains, shapes just above the
   size gates and tile heights above 48 KB of shared memory. A small input
   is also held against the loop-level emulator of the reference program
   (tests/_c_reference.py).
2. The main paths at full size: the `run` command's computation
   (cli.run_image) on the 8K RGB synthetic image, for the reference
   pipeline, gaussian:5 and the megakernel chain, under ``--plan off``
   (K1/K2 groups) and ``--plan fused-pallas`` (K4 stages), byte-equal to
   the golden ops, with each kernel's launches counted over each run.
3. Numbers: CUDA-event times of each kernel and its plain version at the
   main paths' shapes, the bound from bytes and operations, a PyTorch
   library call as a yardstick where one computes the same function, and
   each path end to end under both plans.

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
    # the JAX package's megakernel A/B lane (bench_suite.megakernel_ab_params)
    "megakernel_ab": "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6",
}
PLANS = ("off", "fused-pallas")
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
# K4 stages beyond the one-stencil ones: several stencils with mixed edge
# modes, channel counts that change mid-stage, halo 0, the main chains
STAGE_CASES = [
    "gaussian:5,sharpen", "emboss:3,gaussian:5", "median:3,sobel,box:3",
    "gaussian:7,gaussian:7,gaussian:7,gaussian:7,gaussian:7",
    "erode:3,dilate:5,median:5", "emboss:5,emboss:3,emboss101:3",
    "box:1,invert,box:1", "grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5",
    "grayscale,gaussian:3,gray2rgb,sharpen,sepia", "sepia,gaussian:3,grayscale,sobel",
    "sepia,median:3,invert,emboss:3", "gray2rgb",
    "grayscale,contrast:3.5,emboss:3", "grayscale,contrast:3.5,gaussian:5,quantize:6",
    SPECS["megakernel_ab"],
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
    n += phase1_k4(device)
    print(f"phase 1: {n} kernel cases equal to their plain versions (max_abs_err 0)")
    return n


def k4_tile_heights(ops, c_in) -> list:
    """Tile heights to hold K4 at: the default, 5, and, for a stage that
    uses shared memory, the smallest whose shared memory exceeds 48 KB."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    _, _, c_smem, two_pass = ck.fused_stage_program(ops, c_in)
    if not c_smem:
        return [None, 5]
    t = 1
    while ck.fused_stage_smem_bytes(c_smem, t, chain_halo(ops), two_pass) <= 48 * 1024:
        t += 1
    return [None, 5, t]


def phase1_k4(device) -> int:
    """K4 on every stage case against fused_stage_plain, byte-equal."""
    import ctypes

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

    lib = kr.load("fused_stage")
    assert lib.fused_stage_program_bytes() == ctypes.sizeof(kr.FsProgram)
    for args in [(3, 16, 3, 1), (1, 16, 1, 0), (3, 48, 16, 1), (1, 200, 0, 0)]:
        assert lib.fused_stage_smem_bytes(*args) == ck.fused_stage_smem_bytes(*args), args
    n = 0
    for spec in STENCIL_CASES + STAGE_CASES:
        ops = make_pipeline_ops(spec)
        halo = chain_halo(ops)
        max_op = max(op.halo for op in ops)
        shapes = list(SHAPES)
        if halo:  # just above the size gates: height > 2 halo, width > max op halo
            shapes += [(2 * halo + 1, 301), (257, max_op + 1), (2 * halo + 1, max_op + 1)]
        for seed, shape in enumerate(shapes):
            x = input_for(ops, shape, seed, device)
            c_in = 1 if x.ndim == 2 else 3
            reason = ck.fused_stage_reject(ops, *shape, c_in)
            assert reason is None, f"K4 {spec} {shape}: rejected ({reason})"
            want = ck.fused_stage_plain(ops, x)
            tiles = k4_tile_heights(ops, c_in) if seed == 0 else [None]
            for tile_h in tiles:
                check_equal(f"K4 {spec} {shape} tile_h={tile_h}",
                            ck.fused_stage(ops, x, tile_h=tile_h), want)
                n += 1
    print(f"phase 1: K4 equal to fused_stage_plain in {n} cases")
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
    """The main paths at 8K under each plan, against the golden ops, with
    every kernel's launches counted over each run."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    launches = {}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        for plan in PLANS:
            ck.reset_launch_counts()
            plan_metrics.reset()
            out = run_image(pipe, x8k, impl="cuda", device=device, plan=plan)
            torch.cuda.synchronize()
            counts = {"K1": ck.pointwise_group.launches, "K2": ck.stream_stencil.launches,
                      "K4": ck.fused_stage.launches}
            fallbacks = sum(plan_metrics.pallas_fallbacks.values())
            assert out.shape == (MAIN_H, MAIN_W, 3) and out.dtype == torch.uint8, out.shape
            check_equal(f"main path {spec} plan={plan}", out, want)
            if plan == "off":
                expected = {"K2"} if key == "gaussian5_8k" else {"K1", "K2"}
            else:
                expected = {"K4"}
            for k in counts:
                if k in expected and counts[k] < 1:
                    raise AssertionError(f"main path {spec} plan={plan}: {k} was never launched")
                if k not in expected and counts[k]:
                    raise AssertionError(f"main path {spec} plan={plan}: {k} launched {counts[k]}x")
            if fallbacks or (plan == "fused-pallas" and plan_metrics.pallas_stages < 1):
                raise AssertionError(f"main path {spec} plan={plan}: fallbacks "
                                     f"{dict(plan_metrics.pallas_fallbacks)}")
            launches[key, plan] = counts
            print(f"phase 2: {spec} plan={plan} at {MAIN_H}x{MAIN_W} RGB: cuda == golden, "
                  f"launches {counts}, K4 stages {plan_metrics.pallas_stages}, fallbacks 0")
    return launches


def op_count(ops, n_pix: int, c_in: int) -> int:
    """Float32 operations a group or stage does per image, counted from its
    ops: each pointwise op per pixel, each stencil per pixel and plane."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import MEDIAN_NETWORKS, StencilOp

    per_op = {"grayscale": 8, "grayscale601": 8, "sepia": 27, "gray2rgb": 0,
              "invert": 1, "threshold": 1, "solarize": 2}
    total, c = 0, c_in
    for op in ops:
        if not isinstance(op, StencilOp):
            total += per_op.get(op.name.rstrip("0123456789.-"), 6) * n_pix
            c = op.out_channels or c
            continue
        k = 2 * op.halo + 1
        if op.reduce == "median":
            st = 2 * len(MEDIAN_NETWORKS[k][0])
        elif op.reduce in ("min", "max"):
            st = 2 * (k - 1)
        elif op.separable is not None:
            st = 2 * (2 * k - 1) + 1
        else:
            nnz = sum(int((w != 0).sum()) for w in op.kernels)
            st = 2 * nnz + (4 if op.combine == "magnitude" else 0) + 1
        total += (st + 3) * n_pix * c
    return total


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase3(device, x8k, launches):
    import torch
    import torch.nn.functional as F

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import filters
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    mp = n_pix / 1e6
    rows = []
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"

    def record(name, source, replaces, launch_count, fn, plain, c_in, c_out, ops,
               library=None):
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain at 8K, max abs err {err}")
        ms = device_time_ms(fn)
        plain_ms = device_time_ms(plain, reps=5, inner=2)
        library_ms = device_time_ms(library) if library is not None else None
        nbytes = (c_in + c_out) * n_pix
        bound_ms, bound_by = bound(nbytes, op_count(ops, n_pix, c_in))
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
        "K2 stream_stencil [grayscale,contrast3.5,emboss3]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["reference", "off"]["K2"],
        lambda: ck.stream_stencil(pw, st, x8k),
        lambda: ck.stream_stencil_plain(pw, st, x8k), 3, 1, pw + [st],
    )
    # K1 on the reference path: the gray result replicated to RGB
    gray = ck.stream_stencil(pw, st, x8k)
    g2r, _ = split_group("gray2rgb")
    record(
        "K1 pointwise_group [gray2rgb]",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:540",
        launches["reference", "off"]["K1"],
        lambda: ck.pointwise_group(g2r, gray),
        lambda: ck.pointwise_group_plain(g2r, gray), 1, 3, g2r,
        library=lambda: gray[..., None].expand(-1, -1, 3).contiguous(),
    )
    # K2 on gaussian:5, RGB in and out; the yardstick is a depthwise
    # float32 convolution of the pre-padded planes (TF32 off)
    pw5, st5 = split_group(SPECS["gaussian5_8k"])
    kern, _ = filters.gaussian_2d(5)
    weight = torch.from_numpy(kern).to(device).expand(3, 1, 5, 5).contiguous()
    xf = F.pad(x8k.permute(2, 0, 1)[None].float(), (2, 2, 2, 2), mode="reflect")
    record(
        "K2 stream_stencil [gaussian5]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["gaussian5_8k", "off"]["K2"],
        lambda: ck.stream_stencil(pw5, st5, x8k),
        lambda: ck.stream_stencil_plain(pw5, st5, x8k), 3, 3, pw5 + [st5],
        library=lambda: F.conv2d(xf, weight, groups=3),
    )
    del xf
    # K4 on the first stage of the reference and megakernel paths, 8K RGB
    # in, gray out; no single PyTorch call computes a fused stage
    for key in ("reference", "megakernel_ab"):
        ops = make_pipeline_ops(SPECS[key])
        record(
            f"K4 fused_stage [{','.join(op.name for op in ops)}]", k4,
            "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
            launches[key, "fused-pallas"]["K4"],
            lambda ops=ops: ck.fused_stage(ops, x8k),
            lambda ops=ops: ck.fused_stage_plain(ops, x8k), 3, 1, ops,
        )
    # K4 on the halo-0 stage that replicates gray to RGB on the same path
    record(
        "K4 fused_stage [gray2rgb]", k4,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
        launches["reference", "fused-pallas"]["K4"],
        lambda: ck.fused_stage(g2r, gray), lambda: ck.fused_stage_plain(g2r, gray), 1, 3, g2r,
        library=lambda: gray[..., None].expand(-1, -1, 3).contiguous(),
    )

    # each path's bound: every launch reads its input and writes its output
    # once (gray paths: 3 -> 1 B, then 1 -> 3 B; gaussian:5: 3 -> 3 B),
    # under either plan
    path_bytes = {"reference": 8 * n_pix, "gaussian5_8k": 6 * n_pix,
                  "megakernel_ab": 8 * n_pix}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        bound_ms = path_bytes[key] / H100_BYTES_PER_S * 1e3
        golden = image_runner(pipe, impl="torch", device=device, plan="off")
        t_golden = device_time_ms(lambda: golden(x8k), reps=5, inner=3)
        for plan in PLANS:
            runner = image_runner(pipe, impl="cuda", device=device, plan=plan)
            t = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
            print(f"path {key} [{spec}] plan={plan} {MAIN_H}x{MAIN_W} RGB in, RGB out: "
                  f"cuda {t:.4f} ms ({mp / t * 1e3:.1f} MP/s), bound {bound_ms:.4f} ms by "
                  f"bytes ({bound_ms / t:.1%}), golden torch ops {t_golden:.4f} ms "
                  f"({mp / t_golden * 1e3:.1f} MP/s), launches {launches[key, plan]}")

    # every stencil of the registry through K2 at 8K RGB, kernel time only
    for spec in STENCIL_CASES:
        pws, sts = split_group(spec)
        ms = device_time_ms(lambda pws=pws, sts=sts: ck.stream_stencil(pws, sts, x8k),
                            reps=5, inner=5)
        bms, by = bound(6 * n_pix, op_count(pws + [sts], n_pix, 3))
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
