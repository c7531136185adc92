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
   size gates and tile heights above 48 KB of shared memory. The ghost
   modes of the row-sharded runner, K2g (fused group over a shard with
   ghost strips), K3 (stencil over a pre-extended tile) and K4g (fused
   stage over an extended tile), run the same cases on tiles cut as the
   first, a middle and the last of three shards; K3 also on a tile with
   pad rows. K5, the tensor-core arm of K4/K4g, in both forms (bf16 and
   int8) against its plain version and the VPU arm: every eligible stencil
   of the registry, multi-stencil stages under the settings 'on' and
   'f32', the boundary filters of the exactness argument (255 * sum|w| =
   2^24 - 1; |w| = 127 and 128) on the extreme inputs where the sums are
   largest (all 0, all 255, 0/255 checkerboards), the three main stages at
   8K and on the first, a middle and the last 1080x7680 shard tile. K6
   (narrow and wide), K7 and K8, the SWAR kernels, in full and ghost mode:
   every eligible stencil of the registry and two custom integer filters
   (scale != 1; sum|w| = 128 with large negative taps), with no chain, a
   pre-chain, a post-chain and both, on seeded, all-0, all-255,
   checkerboard and row-ramp planes and on the first, a middle and the last
   1080x7680 shard tile of the 8K gray frame. A small input is also held
   against the loop-level emulator of the reference program
   (tests/_c_reference.py). The tools' kernels: T4's copies (u8, f32, u32
   words, u32 at full element count, f32 at the packed size) at every
   block height, its shared-memory copy and its bitcast pair, on the 8K
   plane, on 36/44/37-row planes (one 100 wide: the element path) and on
   all-0, all-255 and checkerboard planes; T2 and T3 on their JAX
   self-tests' shapes and tile heights (ragged ones too), on those planes
   and at 8K, T3 also against the golden gaussian:5. Then the SWAR chains
   past the old limits: K6 after 17 and 40 fused steps, K8 with a 23x23
   filter (1058 tap words), and `run --impl swar` on a 17-step chain at 8K.
2. The main paths at full size: the `run` command's computation
   (cli.run_image) on the 8K RGB synthetic image, for the reference
   pipeline, gaussian:5 and the megakernel chain, under ``--plan off``
   (K1/K2 groups) and ``--plan fused-pallas`` (K4 stages), byte-equal to
   the golden ops, with each kernel's launches counted over each run. Then
   the row-sharded paths: ``Pipeline.sharded`` on the same frame over a
   4-slot mesh (slot i on card i modulo the number of cards, so all on the
   one card here), under both plans and both halo modes, and once at 4323
   rows (one pad row) to drive K3, byte-equal to golden, with the launches
   and strip exchanges the code implies and no full-mode launch. Then the
   SWAR backend (``--impl swar``): the five 8K workloads of its slice with
   their launches (K1, K6, K7, K8, and K2 for the colour gaussian:5), and
   ``Pipeline.sharded(backend='swar')`` on the 8K gray frame: one K7g, K6g
   or K8g per shard and one exchange round per group, no SWAR launch at
   4323 rows or under overlap. Then the tools' entry points in-process
   (`roofline_probe --quick`, the `packed_proto` self-test, `swar_proto
   --quick`), each with its launches counted, their records printed.
3. Numbers: CUDA-event times of each kernel and its plain version at the
   main paths' shapes (the ghost modes at the 1080x7680 shard), the bound
   from bytes and operations, a PyTorch library call as a yardstick where
   one computes the same function, the strip exchange, and each path end
   to end under both plans, sharded beside unsharded; K5 per form beside
   the VPU arm, and the tensor-core paths end to end; K6, K7 and K8 on the
   SWAR paths' groups (8K gray plane, and ghost mode on one shard) beside
   K2 on the same group, and the SWAR paths end to end; T4's kernels at the
   probe's 8K shapes beside `copy_`, the probe's copy rates as a share of
   3.35 TB/s, T2 at 8K beside K1 on the same group, T3 at 8K beside K6
   narrow and K2 on the same plane.

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
# dense tensor-core peaks, H100 SXM data sheet: bf16 operations, int8
H100_TC_OPS_PER_S = {"mxu": 989e12, "mxu-int8": 1979e12}
MAIN_H, MAIN_W = 4320, 7680  # the 8K frame of the gaussian5_8k workload
SPECS = {
    "reference": "grayscale,contrast:3.5,emboss:3",
    "gaussian5_8k": "gaussian:5",
    # the JAX package's megakernel A/B lane (bench_suite.megakernel_ab_params)
    "megakernel_ab": "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6",
}
PLANS = ("off", "fused-pallas")
HALO_MODES = ("serial", "overlap")
N_SHARDS = 4  # 1080 x 7680 shards of the 8K frame
PAD_H = 4323  # over 4 shards: 1081 rows each, one pad row in the last
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
# the JAX package's boundary filters (tests/test_mxu_backend.py): 255 *
# sum|w| = 2^24 - 1, the largest exact sum; |w| = 127, the int8 operand
# bound, and 128, just past it (the bf16 form only); then taps that cancel,
# whose sum on a plane constant along rows is the pixel itself, inside
# 0..255, after partial sums of 255 * 32640 (bf16) or 255 * 127 (int8)
BOUNDARY_FILTERS = [
    "filter:65280/512/1/0/0/0/0/0/0:1.0", "filter:127/1/0/0/0/0/0/0/0:1.0",
    "filter:128/1/0/0/0/0/0/0/0:1.0", "filter:32640/-32640/1/0/0/0/0/0/0:1.0",
    "filter:127/-127/1/0/0/0/0/0/0:1.0",
]
# the stencils whose raw sums the probe holds against the exact ones
PROBE_CASES = BOUNDARY_FILTERS + ["gaussian:7", "gaussian:5", "sobel", "laplacian:8",
                                  "emboss:5", "sharpen"]
# a fused stage K4 rejects ('lut-op')
REJECTED_SPEC = "gamma:2.2,gaussian:5"
# the SWAR slice's 8K workloads: (pipeline, the launches of one `run`)
SWAR_SPECS = {
    "reference": (SPECS["reference"], {"K1": 2, "K7": 1}),
    "megakernel_ab": (SPECS["megakernel_ab"], {"K1": 3, "K6-narrow": 1, "K7": 1}),
    "gaussian7_gray": ("grayscale,gaussian:7", {"K1": 2, "K6-wide": 1}),
    "sobel_gray": ("grayscale,sobel", {"K1": 2, "K8": 1}),
    "gaussian5_8k": (SPECS["gaussian5_8k"], {"K2": 1}),  # colour: the whole group falls back
}
# the sharded SWAR paths on the 8K gray frame: pipeline -> ghost kernel
SWAR_SHARDED = {"contrast:3.5,emboss:3": "K7g", "gaussian:5": "K6g-narrow", "sobel": "K8g"}
# every stencil a SWAR kernel takes: the registry's, a K8 filter with scale
# != 1 and a K7 filter at its bias bound (sum|w| = 128, large negative taps)
SWAR_STENCILS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "box:3", "box:5", "box:9", "emboss:3",
    "emboss:5", "emboss101:3", "emboss101:5", "sharpen", "laplacian:4", "laplacian:8",
    "sobel", "prewitt", "scharr", "unsharp", "filter:1/2/1/2/4/2/1/2/1:0.0625",
    "filter:-60/-4/0/0/1/0/0/0/63",
]
SWAR_CHAINS = [((), ()), (("contrast:3.5",), ()), ((), ("brightness:-20",)),
               (("invert", "brightness:-20"), ("contrast:3.5",))]
SWAR_SOURCE = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/swar_stencil.cu"
SWAR_REPLACES = {"K6": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:454",
                 "K7": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:798",
                 "K8": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:652"}
K5_SOURCE = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/mma_stage.cuh"
K5_REPLACES = "mpi_cuda_imagemanipulation_tpu/ops/mxu_kernels.py:853"
K5_KEYS = {"mxu": "K5-bf16", "mxu-int8": "K5-int8"}


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
    n += phase1_ghost(device)
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


def shard_cut(ops, shape, k, seed, device, halo):
    """The tile of shard `k` of three of a seeded image `shape[0] // 3 * 3`
    rows high, with its raw ghost strips (zeros where there is no
    neighbour), its y0 and the image height."""
    import torch

    local_h = shape[0] // 3
    img = input_for(ops, (3 * local_h, shape[1]), seed, device)
    y0 = k * local_h
    zeros = torch.zeros_like(img[:halo])
    top = img[y0 - halo:y0] if k else zeros
    bottom = img[y0 + local_h:y0 + local_h + halo] if k < 2 else zeros
    return img[y0:y0 + local_h].contiguous(), top.contiguous(), bottom.contiguous(), y0, 3 * local_h


def phase1_ghost(device) -> int:
    """K2g, K3 and K4g against their plain versions on tiles cut as the
    first, a middle and the last of three shards."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    n2 = n3 = n4 = 0
    for spec in STENCIL_CASES + FUSED_CASES:
        pw, st = split_group(spec)
        h = st.halo
        for i, shape in enumerate(SHAPES):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(pw, shape, k, i + k, device, h)
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                if h >= 1 and tile.shape[0] > h:  # the gates of the fused-ghost path
                    ftop, fbot = api._fix_edge_strips(top, bottom, tile, st, y0, image_h)
                    want = ck.stream_stencil_ghost_plain(pw, st, tile, ftop, fbot, **kw)
                    for tile_h in ((None, 5, 48) if i == 0 and k == 1 else (None,)):
                        check_equal(
                            f"K2g {spec} {shape} shard {k} tile_h={tile_h}",
                            ck.stream_stencil_ghost(pw, st, tile, ftop, fbot, tile_h=tile_h, **kw),
                            want)
                        n2 += 1
                # K3 over the materialised tile, as the runner builds it; once
                # more with a pad row at the end of the last shard
                post = ck.pointwise_group_plain(pw, torch.cat([top, tile, bottom])) if pw else (
                    torch.cat([top, tile, bottom]))
                for pad in ((0, 1) if k == 2 else (0,)):
                    ext = api._fix_edge_rows(post, st, y0, image_h - pad).contiguous()
                    check_equal(f"K3 {spec} {shape} shard {k} pad={pad}",
                                ck.stencil_tile(st, ext), ck.stencil_tile_plain(st, ext))
                    n3 += 1
    for spec in STENCIL_CASES + STAGE_CASES:
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        for i, shape in enumerate(SHAPES):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, shape, k, i + k, device, H)
                c_in = 1 if tile.ndim == 2 else 3
                if ck.fused_stage_reject(ops, tile.shape[0], shape[1], c_in) is not None:
                    continue  # the tile is lower than 2 H + 1 rows: the runner's gate
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                want = ck.fused_stage_ext_plain(ops, ext, **kw)
                for tile_h in ((None, 5) if i == 0 and k == 1 else (None,)):
                    check_equal(f"K4g {spec} {shape} shard {k} tile_h={tile_h}",
                                ck.fused_stage_ext(ops, ext, tile_h=tile_h, **kw), want)
                    n4 += 1
    assert n2 and n3 and n4
    print(f"phase 1: ghost modes equal to their plain versions: K2g {n2}, K3 {n3}, K4g {n4} cases")
    return n2 + n3 + n4


def k5_forms(op) -> list:
    """The K5 forms `op` has: bf16 for every eligible correlation, int8 too
    where its taps are proven to fit."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import mxu_eligible, mxu_int8_ok

    if getattr(op, "reduce", None) != "corr" or not mxu_eligible(op):
        return []
    return ["mxu", "mxu-int8"] if mxu_int8_ok(op) else ["mxu"]


def extreme_inputs(shape, channels, device):
    """The inputs at which a stencil's sums reach 255 * sum|w| or its
    negative: all 0, all 255, and the two 0/255 checkerboards; then a plane
    constant along rows, on which the cancelling boundary filters give the
    pixel itself."""
    import torch

    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    board = ((yy + xx) % 2 * 255).to(torch.uint8)
    planes = [torch.zeros(h, w, dtype=torch.uint8), torch.full((h, w), 255, dtype=torch.uint8),
              board, 255 - board, (yy * 37 % 256).to(torch.uint8)]
    out = []
    for p in planes:
        x = p if channels == 1 else p[..., None].expand(h, w, channels)
        out.append(x.contiguous().to(device))
    return out


def phase1_k5(device) -> int:
    """K5 in each form against its plain version (stage_valid_mxu_plain in
    the walker) and against the VPU arm: every eligible stencil of the
    registry and the boundary filters, on the seeded shapes and on the
    extreme inputs; multi-op stages under the settings 'on' and 'f32'; and
    K4g's form of each on tiles cut as the first, a middle and the last of
    three shards."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    cases = []  # (label, ops, arms)
    for spec in STENCIL_CASES + BOUNDARY_FILTERS:
        ops = make_pipeline_ops(spec)
        for arm in k5_forms(ops[0]):
            cases.append((f"{spec} {arm}", ops, (arm,)))
    for spec in STAGE_CASES:
        ops = make_pipeline_ops(spec)
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            if any(a != "vpu" for a in arms):
                cases.append((f"{spec} {setting}", ops, arms))
    n = n_ext = n_g = 0
    for label, ops, arms in cases:
        vpu = ("vpu",) * len(ops)
        inputs = [input_for(ops, shape, seed, device) for seed, shape in enumerate(SHAPES)]
        c = 3 if inputs[0].ndim == 3 else 1
        extremes = extreme_inputs((257, 301), c, device)
        for i, x in enumerate(inputs + extremes):
            want = ck.fused_stage_plain(ops, x, arms=arms)
            check_equal(f"K5 plain {label} input {i}", want, ck.fused_stage_plain(ops, x, arms=vpu))
            # other tile heights, including one above 48 KB of shared memory
            for tile_h in (k4_tile_heights(ops, c) if i == 0 else (None,)):
                check_equal(f"K5 {label} input {i} tile_h={tile_h}",
                            ck.fused_stage(ops, x, tile_h=tile_h, arms=arms), want)
                n += 1
            n_ext += i >= len(inputs)
        H = chain_halo(ops)
        for i, shape in enumerate(SHAPES[:1] + SHAPES[2:]):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, shape, k, i + k, device, H)
                if ck.fused_stage_reject(ops, tile.shape[0], shape[1], c) is not None:
                    continue
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                want = ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw)
                check_equal(f"K5 (K4g) plain {label} {shape} shard {k}", want,
                            ck.fused_stage_ext_plain(ops, ext, arms=("vpu",) * len(ops), **kw))
                check_equal(f"K5 (K4g) {label} {shape} shard {k}",
                            ck.fused_stage_ext(ops, ext, arms=arms, **kw), want)
                n_g += 1
    assert n and n_ext and n_g
    print(f"phase 1: K5 equal to its plain version and to the VPU arm in {n} K4 cases "
          f"({n_ext} on extreme inputs) and {n_g} K4g cases")
    return n + n_g


def phase1_k5_main(device, x8k) -> int:
    """K5 at the main paths' shapes: the three stages at 8K and on the
    first, a middle and the last 1080x7680 shard tile, in both forms, and
    gaussian:5 and the 2^24 - 1 boundary filter on the extreme 8K inputs,
    each against its plain version and the VPU arm."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    n = 0
    local_h = MAIN_H // N_SHARDS
    for key, spec in SPECS.items():
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        vpu = ck.fused_stage(ops, x8k, arms=("vpu",) * len(ops))
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            want = ck.fused_stage_plain(ops, x8k, arms=arms)
            check_equal(f"K5 plain {key} {setting} 8K", want, vpu)
            check_equal(f"K5 {key} {setting} 8K", ck.fused_stage(ops, x8k, arms=arms), want)
            n += 1
            for k in (0, 1, N_SHARDS - 1):
                y0 = k * local_h
                ext = x8k[max(y0 - H, 0):y0 + local_h + H]
                if k == 0:
                    ext = torch.cat([torch.zeros_like(x8k[:H]), ext])
                if k == N_SHARDS - 1:
                    ext = torch.cat([ext, torch.zeros_like(x8k[:H])])
                ext = ext.contiguous()
                kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)
                want = ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw)
                check_equal(f"K5 (K4g) plain {key} {setting} shard {k}", want,
                            vpu[y0:y0 + local_h])
                check_equal(f"K5 (K4g) {key} {setting} shard {k}",
                            ck.fused_stage_ext(ops, ext, arms=arms, **kw), want)
                n += 1
        del vpu
    for spec in ("gaussian:5", BOUNDARY_FILTERS[0], BOUNDARY_FILTERS[3]):
        ops = make_pipeline_ops(spec)
        for x in extreme_inputs((MAIN_H, MAIN_W), 3, device):
            vpu = ck.fused_stage(ops, x, arms=("vpu",))
            for arm in k5_forms(ops[0]):
                want = ck.fused_stage_plain(ops, x, arms=(arm,))
                check_equal(f"K5 plain {spec} {arm} extreme 8K", want, vpu)
                check_equal(f"K5 {spec} {arm} extreme 8K", ck.fused_stage(ops, x, arms=(arm,)), want)
                n += 1
    torch.cuda.synchronize()
    print(f"phase 1: K5 at 8K and on 1080x7680 shard tiles: {n} cases equal to the plain "
          "version and the VPU arm")
    return n


def exact_sums(plane, w2d):
    """Valid-mode correlation of a u8 plane in int64 on the card: the sums K5
    must keep bit for bit."""
    import torch

    w = torch.as_tensor(w2d, dtype=torch.float64).round().long().tolist()
    ks = len(w)
    rows, cols = plane.shape[0] - ks + 1, plane.shape[1] - ks + 1
    x = plane.long()
    out = torch.zeros((rows, cols), dtype=torch.long, device=plane.device)
    for d in range(ks):
        for i in range(ks):
            if w[d][i]:
                out += w[d][i] * x[d:d + rows, i:i + cols]
    return out


def phase1_k5_sums(device, x8k) -> int:
    """K5's raw f32 sums, read through its exactness probe (k5_sums: the tile
    functions K5 runs, before any combine, scale or rounding to u8), against
    the exact int64 sums: the boundary filters and several registry
    stencils in each form, on the extreme inputs and a seeded random plane
    at 257x301 and at 8K (a plane of the 8K frame, all 255, the row
    ramp). The u8 output of K5 hides the low bits of sums that leave
    0..255; this does not. Returns the largest sum checked."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    gen = torch.Generator().manual_seed(3)
    small = extreme_inputs((257, 301), 1, device) + [
        torch.randint(0, 256, (257, 301), generator=gen, dtype=torch.uint8).to(device)]
    big = [x8k[..., 0].contiguous()] + [extreme_inputs((MAIN_H, MAIN_W), 1, device)[i]
                                        for i in (1, 4)]
    n, top = 0, 0
    for spec in PROBE_CASES:
        op = make_op(spec)
        for arm in k5_forms(op):
            planes = small + big if spec in (BOUNDARY_FILTERS[0], BOUNDARY_FILTERS[3]) else small
            for i, plane in enumerate(planes):
                for k, w2d in enumerate(op.kernels):
                    want = exact_sums(plane, w2d)
                    got = ck.k5_sums(op, plane, arm, kernel=k)
                    if got.shape != want.shape or not torch.equal(got.double(), want.double()):
                        err = (got.double() - want.double()).abs().max().item()
                        raise AssertionError(f"K5 sums {spec} {arm} input {i} kernel {k}: "
                                             f"max abs err {err}")
                    top = max(top, int(want.abs().max().item()))
                    n += 1
    assert top == (1 << 24) - 1, top
    print(f"phase 1: K5's raw sums equal the exact int64 sums in {n} cases, up to |sum| = {top} "
          "(2^24 - 1)")
    return top


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


def sharded_mesh():
    """Four slots, slot i on card i modulo the number of cards: all on the
    one card here, spread over the cards where there are more."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count()
    return make_mesh(N_SHARDS, devices=[f"cuda:{i % cards}" for i in range(N_SHARDS)])


def expected_sharded(ops, plan, halo_mode, padded=False) -> tuple[dict, int]:
    """The launches and exchange rounds parallel/api.py implies for a
    one-stage pipeline over N_SHARDS shards: under 'off' a K2g per stencil
    group and shard (K3 after a K1 flush on padded tiles), a K1 per
    pointwise-only group; under 'fused-pallas' one K4g per shard; under
    'overlap' (either plan) a K1 flush of the prologue and three K3 per
    group and shard."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    groups = ck.group_ops(ops)
    stencils = sum(st is not None for _, st in groups)
    if plan == "fused-pallas" and halo_mode == "serial" and not padded:
        want["K4g"] = N_SHARDS
        return want, 1
    for pw, st in groups:
        if st is None:
            want["K1"] += N_SHARDS
        elif halo_mode == "overlap" and not padded:
            want["K1"] += N_SHARDS if pw else 0
            want["K3"] += 3 * N_SHARDS
        elif padded:
            want["K1"] += N_SHARDS if pw else 0
            want["K3"] += N_SHARDS
        else:
            want["K2g"] += N_SHARDS
    return want, stencils


def phase2_sharded(device, x8k):
    """`Pipeline.sharded` at 8K over the 4-slot mesh under each plan and
    halo mode, and at 4323 rows, against the golden ops; launches and
    exchanges as `expected_sharded` implies."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    mesh = sharded_mesh()
    launches = {}

    def drive(key, pipe, x, want, plan, halo_mode, padded):
        fn = pipe.sharded(mesh, backend="cuda", plan=plan, halo_mode=halo_mode)
        ck.reset_launch_counts()
        halo.exchanges.reset()
        plan_metrics.reset()
        out = fn(x)
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        counts = ck.launch_counts()
        rounds = halo.exchanges.rounds
        tag = f"sharded path {key} plan={plan} halo_mode={halo_mode} {x.shape[0]}x{x.shape[1]}"
        assert out.dtype == torch.uint8 and out.device == mesh.devices[0], tag
        check_equal(tag, out, want)
        exp_counts, exp_rounds = expected_sharded(pipe.ops, plan, halo_mode, padded)
        if counts != exp_counts:
            raise AssertionError(f"{tag}: launches {counts}, expected {exp_counts}")
        if rounds != exp_rounds:
            raise AssertionError(f"{tag}: {rounds} exchange rounds, expected {exp_rounds}")
        mega = plan == "fused-pallas" and halo_mode == "serial"
        want_fallbacks = {"image-too-small": 1} if mega and padded else {}
        if dict(plan_metrics.pallas_fallbacks) != want_fallbacks or (
                plan_metrics.pallas_stages != (1 if mega and not padded else 0)):
            raise AssertionError(f"{tag}: K4g stages {plan_metrics.pallas_stages}, fallbacks "
                                 f"{dict(plan_metrics.pallas_fallbacks)}")
        launches[key, plan, halo_mode, padded] = counts
        used = {k: v for k, v in counts.items() if v}
        print(f"phase 2: {tag}: sharded cuda == golden, launches {used}, {rounds} exchange "
              f"round(s) over {N_SHARDS - 1} boundaries, full-mode K2/K4 launches 0")

    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        want = pipe.jit("torch", device=device, plan="off")(x8k)
        for plan in PLANS:
            for halo_mode in HALO_MODES:
                drive(key, pipe, x8k, want, plan, halo_mode, False)
    xpad = torch.from_numpy(synthetic_image(PAD_H, MAIN_W, seed=1)).to(device)
    for key in ("reference", "gaussian5_8k"):
        pipe = Pipeline.parse(SPECS[key])
        want = pipe.jit("torch", device=device, plan="off")(xpad)
        for plan in PLANS:
            drive(key, pipe, xpad, want, plan, "serial", True)
    return launches


def expected_mxu(ops, impl, plan, *, gray_to_rgb=True, shards=1, halo_mode="serial") -> dict:
    """The launches a tensor-core path implies for one of the main chains
    (one fused stage; every stencil of them has an int8 K5 form): under
    'fused-pallas-mxu' one K4 (or, sharded, one K4g per shard) running
    K5-int8, and a halo-0 K4 stage for gray -> RGB; under 'mxu' with plan
    'off' no kernel for the stencils (banded products) and one K1 per
    pointwise run (per shard), gray -> RGB included. Sharded under
    halo_mode='overlap' no stage takes K4g: a fused-pallas-mxu run is the
    plan 'off' run of its backend."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    gray = any(op.out_channels == 1 for op in ops)
    if plan == "fused-pallas-mxu" and (shards == 1 or halo_mode == "serial"):
        want["K4g" if shards > 1 else "K4"] = shards
        want["K5-int8"] = shards
        want["K4"] += int(gray and gray_to_rgb)
        return want
    if impl == "cuda":
        assert shards == N_SHARDS and halo_mode == "overlap" and not gray_to_rgb
        return expected_sharded(ops, "off", "overlap")[0]
    assert impl == "mxu" and (plan == "off" or halo_mode == "overlap")
    runs = [pw for pw, st in ck.group_ops(ops) if pw]
    want["K1"] = shards * len(runs) + int(gray and gray_to_rgb)
    return want


def phase2_mxu(device, x8k):
    """The tensor-core paths at 8K against the golden ops: `run` under
    --plan fused-pallas-mxu (impl cuda and mxu) and --impl mxu --plan off,
    the stage executor with the in-stage setting 'f32' (K5 bf16), a stage
    K4 rejects under both impls, and Pipeline.sharded over the 4-slot mesh
    under fused-pallas-mxu (backends cuda and mxu, both halo modes) and
    mxu + off (both halo modes); launches, arm counts, K4 fallbacks and
    exchange rounds asserted."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    mesh = sharded_mesh()
    launches = {}

    def drive(tag, fn, x, want, exp, arms=None, rounds=None, fallbacks=None):
        ck.reset_launch_counts()
        plan_metrics.reset()
        halo.exchanges.reset()
        out = fn(x)
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        counts = ck.launch_counts()
        assert out.dtype == torch.uint8 and out.shape == want.shape, (tag, out.shape)
        check_equal(tag, out, want)
        if counts != exp:
            raise AssertionError(f"{tag}: launches {counts}, expected {exp}")
        if dict(plan_metrics.mxu_stage_ops) != (arms or {}) or plan_metrics.mxu_stage_fallbacks:
            raise AssertionError(f"{tag}: arms {dict(plan_metrics.mxu_stage_ops)}, expected "
                                 f"{arms or {}}; fallbacks {dict(plan_metrics.mxu_stage_fallbacks)}")
        if dict(plan_metrics.pallas_fallbacks) != (fallbacks or {}):
            raise AssertionError(f"{tag}: K4 fallbacks {dict(plan_metrics.pallas_fallbacks)}, "
                                 f"expected {fallbacks or {}}")
        if rounds is not None and halo.exchanges.rounds != rounds:
            raise AssertionError(f"{tag}: {halo.exchanges.rounds} exchange rounds, expected {rounds}")
        used = {k: v for k, v in counts.items() if v}
        print(f"phase 2: {tag}: == golden, launches {used}, in-stage arms "
              f"{dict(plan_metrics.mxu_stage_ops)}")
        return counts

    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        n_st = sum(isinstance(op, StencilOp) for op in pipe.ops)
        int8 = {"mxu-int8": n_st}
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        for impl, plan in (("cuda", "fused-pallas-mxu"), ("mxu", "fused-pallas-mxu"), ("mxu", "off")):
            launches[key, impl, plan] = drive(
                f"main path {spec} impl={impl} plan={plan} {MAIN_H}x{MAIN_W} RGB",
                lambda x, impl=impl, plan=plan: run_image(pipe, x, impl=impl, device=device,
                                                          plan=plan),
                x8k, want, expected_mxu(pipe.ops, impl, plan),
                arms=int8 if plan == "fused-pallas-mxu" else None)
        # the bf16 form at 8K: the stage executor with the setting 'f32'
        gray = pipe.jit("torch", device=device, plan="off")(x8k)
        f32 = plan_callable_cuda(build_plan(pipe.ops, "fused-pallas-mxu"), mxu_stage="f32")
        exp = dict.fromkeys(ck.launch_counts(), 0)
        exp.update({"K4": 1, "K5-bf16": 1})
        launches[key, "cuda", "f32"] = drive(
            f"main path {spec} fused-pallas-mxu mxu_stage=f32 {MAIN_H}x{MAIN_W} RGB", f32, x8k,
            gray, exp, arms={"mxu": n_st})
        # sharded, no gray -> RGB step; under overlap no stage takes K4g
        for backend, plan, halo_mode in (
                ("cuda", "fused-pallas-mxu", "serial"), ("cuda", "fused-pallas-mxu", "overlap"),
                ("mxu", "fused-pallas-mxu", "serial"), ("mxu", "fused-pallas-mxu", "overlap"),
                ("mxu", "off", "serial"), ("mxu", "off", "overlap")):
            fn = pipe.sharded(mesh, backend=backend, plan=plan, halo_mode=halo_mode)
            mega = plan == "fused-pallas-mxu" and halo_mode == "serial"
            launches[key, "sharded", backend, plan, halo_mode] = drive(
                f"sharded path {spec} backend={backend} plan={plan} halo_mode={halo_mode}",
                fn, x8k, gray,
                expected_mxu(pipe.ops, backend, plan, gray_to_rgb=False, shards=N_SHARDS,
                             halo_mode=halo_mode),
                arms=int8 if mega else None, rounds=1 if mega else n_st)
    # a stage K4 rejects (a lookup table: 'lut-op'): K1/K2 groups under cuda,
    # pipeline_mxu under mxu (the gather, then the banded products)
    pipe = Pipeline.parse(REJECTED_SPEC)
    want = pipe.jit("torch", device=device, plan="off")(x8k)
    for impl in ("cuda", "mxu"):
        exp = dict.fromkeys(ck.launch_counts(), 0)
        exp["K2"] = int(impl == "cuda")
        launches["rejected", impl] = drive(
            f"main path {REJECTED_SPEC} impl={impl} plan=fused-pallas-mxu {MAIN_H}x{MAIN_W} RGB",
            lambda x, impl=impl: run_image(pipe, x, impl=impl, device=device,
                                           plan="fused-pallas-mxu"),
            x8k, want, exp, fallbacks={"lut-op": 1})
    return launches


def swar_case(spec, chain):
    """(stencil op, pre ops, post ops, pre chain, post chain) of one SWAR
    case: the stencil of `spec` with the pointwise ops of `chain` fused."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    pre = tuple(make_op(s) for s in chain[0])
    post = tuple(make_op(s) for s in chain[1])
    return (make_op(spec), pre, post, tuple(map(sk.swar_fusable, pre)),
            tuple(map(sk.swar_fusable, post)))


def gray_tile(plane, y0, rows, h, op):
    """The tile of `rows` rows at `y0` of a gray plane with the ghost strips
    the sharded runner gives it: the neighbours' rows, the op's edge
    extension at the plane's first and last row."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    H = plane.shape[0]
    tile = plane[y0:y0 + rows].contiguous()
    top = plane[y0 - h:y0] if y0 else torch.zeros_like(plane[:h])
    bottom = plane[y0 + rows:y0 + rows + h] if y0 + rows < H else torch.zeros_like(plane[:h])
    top, bottom = api._fix_edge_strips(top, bottom, tile, op, y0, H)
    return tile, top.contiguous(), bottom.contiguous()


def phase1_swar(device, gray8k) -> int:
    """K6 (narrow and wide), K7 and K8 against their plain versions (run on
    the card): every SWAR stencil with each chain, full mode on a seeded
    plane, all 0, all 255, two checkerboards and a row ramp at 257x300 (tile
    heights 32, 7 and 33), seeded planes at 37x128 and 48x64; ghost mode on
    tiles cut as the first, a middle and the last of three shards of the
    seeded plane and of the 8K gray frame (1080x7680, the main path's
    shards); full mode on the 8K gray frame."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

    def plane(h, w, seed):
        return torch.from_numpy(synthetic_image(h, w, channels=1, seed=seed)).to(device)

    seeded = plane(257, 300, 1)
    full = [seeded] + extreme_inputs((257, 300), 1, device) + [plane(37, 128, 2), plane(48, 64, 3)]
    local_h = MAIN_H // N_SHARDS
    n_full = n_ghost = n8k = 0
    kinds = set()
    for spec in SWAR_STENCILS:
        for ci, chain in enumerate(SWAR_CHAINS):
            st, pre, post, pc, qc = swar_case(spec, chain)
            kinds.add(sk.swar_kind(st))
            kw = dict(pre_ops=pre, post_ops=post)
            label = f"{sk.swar_kind(st)} {spec} chain {chain}"
            for i, x in enumerate(full):
                want = sk.swar_stencil_plain(st, x, pre_chain=pc, post_chain=qc)
                for tile_h in ((None, 7, 33) if i == 0 else (None,)):
                    check_equal(f"{label} input {i} tile_h={tile_h}",
                                sk.swar_stencil(st, x, block_h=tile_h, **kw), want)
                    n_full += 1
            h = st.halo
            for src, rows, ys in ((seeded, 85, (0, 85, 170)),
                                  (gray8k, local_h, (0, local_h, MAIN_H - local_h))):
                if src is gray8k and ci not in (0, 3):
                    continue
                H = src.shape[0]
                for y0 in ys:
                    tile, top, bottom = gray_tile(src[:3 * rows] if src is seeded else src,
                                                  y0, rows, h, st)
                    gkw = dict(ghosts=(top, bottom), y0=y0, global_h=3 * rows if src is seeded else H)
                    want = sk.swar_stencil_plain(st, tile, pre_chain=pc, post_chain=qc, **gkw)
                    check_equal(f"{label} ghost {tuple(src.shape)} y0={y0}",
                                sk.swar_stencil(st, tile, **gkw, **kw), want)
                    n_ghost += 1
            if ci in (0, 3):
                want = sk.swar_stencil_plain(st, gray8k, pre_chain=pc, post_chain=qc)
                check_equal(f"{label} 8K", sk.swar_stencil(st, gray8k, **kw), want)
                n8k += 1
    assert kinds == set(sk.KINDS), kinds
    torch.cuda.synchronize()
    print(f"phase 1: K6 narrow/wide, K7, K8 equal to their plain versions (max_abs_err 0): "
          f"{n_full} full-mode cases, {n_ghost} ghost-mode cases ({len(SWAR_STENCILS)} "
          f"stencils x {len(SWAR_CHAINS)} chains), {n8k} on the 8K gray frame")
    return n_full + n_ghost + n8k


def phase2_swar(device, x8k, gray8k):
    """The SWAR backend's paths against the golden ops: `run --impl swar`
    (cli.run_image) on the five 8K workloads with exactly their launches,
    and Pipeline.sharded(backend='swar') on the 8K gray frame over the
    4-slot mesh: one ghost-mode launch per shard and one exchange round per
    group; at 4323 rows and under overlap no SWAR launch, the 'cuda'
    route's launches instead."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo

    launches = {}
    for key, (spec, exp) in SWAR_SPECS.items():
        pipe = Pipeline.parse(spec)
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        ck.reset_launch_counts()
        out = run_image(pipe, x8k, impl="swar", device=device, plan="off")
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        assert out.shape == (MAIN_H, MAIN_W, 3) and out.dtype == torch.uint8, out.shape
        check_equal(f"swar path {spec}", out, want)
        expected = {**dict.fromkeys(counts, 0), **exp}
        if counts != expected:
            raise AssertionError(f"swar path {spec}: launches {counts}, expected {expected}")
        launches[key] = counts
        print(f"phase 2: {spec} impl=swar at {MAIN_H}x{MAIN_W} RGB: swar == golden, launches "
              f"{exp}")
    mesh = sharded_mesh()
    to_gray = Pipeline.parse("grayscale").jit("torch", device=device, plan="off")
    gray_pad = to_gray(torch.from_numpy(synthetic_image(PAD_H, MAIN_W, seed=1)).to(device))
    for spec, kernel in SWAR_SHARDED.items():
        pipe = Pipeline.parse(spec)
        for x, halo_mode, padded in ((gray8k, "serial", False), (gray8k, "overlap", False),
                                     (gray_pad, "serial", True)):
            want = pipe.jit("torch", device=device, plan="off")(x)
            fn = pipe.sharded(mesh, backend="swar", halo_mode=halo_mode)
            ck.reset_launch_counts()
            halo.exchanges.reset()
            out = fn(x)
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            counts, rounds = ck.launch_counts(), halo.exchanges.rounds
            tag = f"sharded swar path {spec} halo_mode={halo_mode} {x.shape[0]}x{x.shape[1]} gray"
            assert out.dtype == torch.uint8 and out.device == mesh.devices[0], tag
            check_equal(tag, out, want)
            if halo_mode == "serial" and not padded:
                exp, exp_rounds = dict.fromkeys(counts, 0), 1
                exp[kernel] = N_SHARDS
            else:
                exp, exp_rounds = expected_sharded(pipe.ops, "off", halo_mode, padded)
            if counts != exp or rounds != exp_rounds:
                raise AssertionError(f"{tag}: launches {counts}, {rounds} rounds; expected "
                                     f"{exp}, {exp_rounds}")
            launches[spec, halo_mode, padded] = counts
            used = {k: v for k, v in counts.items() if v}
            print(f"phase 2: {tag}: == golden, launches {used}, {rounds} exchange round(s)")
    return launches


def phase3_swar(device, x8k, gray8k, swar_launches, record):
    """K6, K7 and K8 at the SWAR paths' shapes (the 8K gray plane; ghost
    mode on a middle 1080x7680 shard), each held against its plain version,
    with K2 (K2g) on the same group and plane, the route `--impl cuda`
    takes, timed beside it; then the SWAR paths end to end beside `--impl
    cuda`. `record` appends the kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    local_h = MAIN_H // N_SHARDS
    y0 = local_h
    # the gray input of the megakernel chain's sharpen group
    _, pre, _, pc, _ = swar_case("gaussian:5", (("contrast:3.5",), ()))
    blurred = sk.swar_stencil(swar_case("gaussian:5", ((), ()))[0], gray8k, pre_ops=pre)
    # (label, spec, chain, plane, phase-2 run and key, library call?)
    groups = [
        ("K6 narrow", "gaussian:5", (("contrast:3.5",), ()), gray8k, ("megakernel_ab", "K6-narrow"),
         False),
        ("K6 wide", "gaussian:7", ((), ()), gray8k, ("gaussian7_gray", "K6-wide"), True),
        ("K7", "emboss:3", (("contrast:3.5",), ()), gray8k, ("reference", "K7"), False),
        ("K7", "sharpen", ((), ()), blurred, ("megakernel_ab", "K7"), True),
        ("K8", "sobel", ((), ()), gray8k, ("sobel_gray", "K8"), False),
    ]
    for label, spec, chain, x, (key, count), lib in groups:
        st, pre, post, pc, qc = swar_case(spec, chain)
        names = ",".join(op.name for op in pre + (st,) + post)
        record(
            f"{label} swar_stencil [{names}] gray", SWAR_SOURCE, SWAR_REPLACES[label[:2]],
            swar_launches[key][count],
            lambda st=st, x=x, pre=pre: sk.swar_stencil(st, x, pre_ops=pre),
            lambda st=st, x=x, pc=pc: sk.swar_stencil_plain(st, x, pre_chain=pc), 1, 1,
            list(pre) + [st], library=conv_library(st, x, pad_rows=True) if lib else None,
        )
        t_k2 = device_time_ms(lambda st=st, x=x, pre=pre: ck.stream_stencil(list(pre), st, x),
                              reps=7)
        print(f"  K2 on the same group and plane (the --impl cuda route) in this run: "
              f"{t_k2:.4f} ms")
    ghost = [("K6g narrow", "gaussian:5", "K6g-narrow", True),
             ("K7g", "contrast:3.5,emboss:3", "K7g", False), ("K8g", "sobel", "K8g", False)]
    for label, spec, count, lib in ghost:
        parts = spec.split(",")
        st, pre, post, pc, qc = swar_case(parts[-1], (tuple(parts[:-1]), ()))
        h = st.halo
        tile, top, bottom = gray_tile(gray8k, y0, local_h, h, st)
        kw = dict(ghosts=(top, bottom), y0=y0, global_h=MAIN_H)
        ext = torch.cat([top, tile, bottom])
        record(
            f"{label} swar_stencil ghost [{spec}] gray shard", SWAR_SOURCE,
            SWAR_REPLACES[label[:2]], swar_launches[spec, "serial", False][count],
            lambda st=st, t=tile, pre=pre, kw=kw: sk.swar_stencil(st, t, pre_ops=pre, **kw),
            lambda st=st, t=tile, pc=pc, kw=kw: sk.swar_stencil_plain(st, t, pre_chain=pc, **kw),
            1, 1, list(pre) + [st], library=conv_library(st, ext, pad_rows=False) if lib else None,
            n_pix=local_h * MAIN_W, strip_bytes=2 * h * MAIN_W,
        )
        gk = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)

        def k2g(st=st, t=(tile, top, bottom), pre=pre):
            return ck.stream_stencil_ghost(list(pre), st, *t, **gk)

        t_k2 = device_time_ms(k2g, reps=7)
        # host time per call of each wrapper: where it exceeds the device
        # time, back-to-back launches wait on the host
        h_swar = host_enqueue_ms(lambda st=st, t=tile, pre=pre, kw=kw: sk.swar_stencil(
            st, t, pre_ops=pre, **kw))
        print(f"  K2g on the same group and shard (the --impl cuda route) in this run: "
              f"{t_k2:.4f} ms; host time to enqueue one call: {label} {h_swar:.4f} ms, K2g "
              f"{host_enqueue_ms(k2g):.4f} ms")
        del ext
    torch.cuda.synchronize()

    mp = MAIN_H * MAIN_W / 1e6
    for key, (spec, _) in SWAR_SPECS.items():
        pipe = Pipeline.parse(spec)
        times = {}
        for impl in ("swar", "cuda", "swar"):
            runner = image_runner(pipe, impl=impl, device=device, plan="off")
            times[impl] = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
        used = {k: v for k, v in swar_launches[key].items() if v}
        print(f"path {key} [{spec}] impl=swar {MAIN_H}x{MAIN_W} RGB in, RGB out: "
              f"{times['swar']:.4f} ms ({mp / times['swar'] * 1e3:.1f} MP/s), impl=cuda "
              f"plan=off in this run {times['cuda']:.4f} ms; launches {used}")
    mesh = sharded_mesh()
    for spec in SWAR_SHARDED:
        pipe = Pipeline.parse(spec)
        times = {}
        for backend in ("swar", "cuda"):
            fn = pipe.sharded(mesh, backend=backend)
            times[backend] = device_time_ms(lambda: fn(gray8k), reps=5, inner=3)
        print(f"sharded path [{spec}] {MAIN_H}x{MAIN_W} gray over {N_SHARDS} slots, serial: "
              f"swar {times['swar']:.4f} ms, cuda {times['cuda']:.4f} ms")


# --------------------------------------------------------------------------
# The tools' kernels: T4 (roofline_probe), T2 (packed_proto), T3 (swar_proto)
# --------------------------------------------------------------------------


def tool_planes(shape, device, seed=1):
    """A seeded u8 plane of `shape`, then all 0 and all 255 and a 0/255
    checkerboard."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    seeded = torch.from_numpy(synthetic_image(*shape, channels=1, seed=seed)).to(device)
    return [seeded] + extreme_inputs(shape, 1, device)[:3]


def phase1_tools(device, gray8k) -> int:
    """T4's copies and bitcasts, T2 and T3 against their plain versions, byte
    for byte; T3 unpacked against the golden gaussian:5; then the SWAR
    chains past the old 16-step limit (17 and 40 steps) and a filter past
    the old 512 tap words, on K6 and K8. Returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

    n = 0
    probe8k = torch.from_numpy(synthetic_image(rp.H, rp.W, channels=1, seed=99)).to(device)
    # T4: the probe's five arrays at its block heights on the 8K plane, then
    # small and odd shapes (W = 100: no 16-byte rows, the element path) and
    # flat planes at every block height
    arrays = [probe8k, probe8k.float(), pp.pack_u8(probe8k), probe8k.to(torch.int32),
              probe8k.float()[:, : rp.W // 4].contiguous()]
    small = [p for shape in ((36, 96), (44, 96), (37, 100)) for p in tool_planes(shape, device)]
    for x in arrays + small + [p.float() for p in small] + [p.to(torch.int32) for p in small]:
        for bh in rp.BLOCK_HEIGHTS + (1, 7):
            check_equal(f"T4 copy {tuple(x.shape)} {x.dtype} bh={bh}", rp.copy_probe(x, bh),
                        rp.copy_probe_plain(x))
            n += 1
    for x in [probe8k] + [p for p in small if p.shape[1] % 16 == 0]:
        for bh in rp.BLOCK_HEIGHTS + (5,):
            check_equal(f"T4 smem copy {tuple(x.shape)} bh={bh}", rp.smem_copy(x, bh), x)
            n += 1
    for x in [probe8k] + [p for p in small if p.shape[0] % 4 == 0 and p.shape[1] % 4 == 0]:
        for bh in rp.BLOCK_HEIGHTS + (8, 12):
            words = rp.bitcast_store(x, bh)
            check_equal(f"T4 bitcast store {tuple(x.shape)} bh={bh}", words,
                        rp.bitcast_store_plain(x))
            for lbh in (bh // 4, bh, 3):
                check_equal(f"T4 bitcast load {tuple(words.shape)} bh={lbh}",
                            rp.bitcast_load(words, lbh), x)
            n += 4
    # T2: the JAX self-test's shape and tile heights (24 leaves a ragged last
    # block), odd shapes, flat and checkerboard planes, the 8K frame
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    chain = make_pipeline_ops(pp.CHAIN)
    for shape, bhs in (((64, 256), (24, 128)), ((37, 128), (16, 5)), ((36, 96), (128,)),
                       ((MAIN_H, MAIN_W), (128, 96))):
        planes = tool_planes(shape, device, seed=shape[0])
        for i, p in enumerate(planes):
            rgb = [p, planes[(i + 1) % len(planes)], planes[(i + 2) % len(planes)]]
            words = [pp.pack_u8(q) for q in rgb]
            golden = torch.stack(rgb, dim=-1)
            for op in chain:
                golden = op(golden)
            for bh in bhs:
                got = pp.packed_gray_contrast(*words, block_h=bh)
                check_equal(f"T2 {shape} plane {i} bh={bh}", got,
                            pp.packed_gray_contrast_plain(*words))
                check_equal(f"T2 {shape} plane {i} bh={bh} vs golden", pp.unpack_u32(got), golden)
                n += 1
    pp.selftest(device)
    # T3: the JAX gate's shapes and ragged heights, flat and checkerboard
    # planes, the 8K plane at the timed block heights; unpacked == golden
    golden5 = Pipeline.parse("gaussian:5")
    for shape, bhs in (((48, 64), (16,)), ((37, 64), (16, 5)), ((50, 64), (24,)),
                       ((130, 256), (120, 7)), ((MAIN_H, MAIN_W), sp.BLOCK_HEIGHTS)):
        for i, p in enumerate(tool_planes(shape, device, seed=shape[0])):
            ext = sp.pack_quarters(sp.reflect_pad(p))
            want = sp.swar_words_plain(ext)
            for bh in bhs:
                got = sp.swar_proto(ext, bh)
                check_equal(f"T3 {shape} plane {i} bh={bh}", got, want)
                check_equal(f"T3 {shape} plane {i} bh={bh} vs golden", sp.unpack_quarters(got),
                            golden5(p))
                n += 1
    sp.bitexact_gate(device)
    n += phase1_swar_chains(device, gray8k)
    torch.cuda.synchronize()
    print(f"phase 1: T4 copies and bitcasts, T2, T3 and the long SWAR chains equal to their "
          f"plain versions (max_abs_err 0): {n} cases")
    return n


def phase1_swar_chains(device, gray8k) -> int:
    """K6 with 17 and 40 pre-chain steps (and a post-chain), K8 with a 23x23
    integer filter (1058 tap words), against their plain versions; and the
    17-step pipeline through `run --impl swar` at 8K, equal to golden with
    one K6 launch."""
    import dataclasses

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops

    n = 0
    plane = torch.from_numpy(synthetic_image(257, 300, channels=1, seed=4)).to(device)
    st = make_op("gaussian:5")
    for steps, post in ((17, ()), (40, ("invert", "brightness:-3"))):
        pre = make_pipeline_ops(",".join(["brightness:1"] * steps))
        post_ops = tuple(make_op(s) for s in post)
        pc, qc = tuple(map(sk.swar_fusable, pre)), tuple(map(sk.swar_fusable, post_ops))
        for x in (plane, gray8k):
            want = sk.swar_stencil_plain(st, x, pre_chain=pc, post_chain=qc)
            for tile_h in (None, 7):
                check_equal(f"K6 gaussian:5 after {steps} steps {tuple(x.shape)} tile_h={tile_h}",
                            sk.swar_stencil(st, x, pre_ops=pre, post_ops=post_ops,
                                            block_h=tile_h), want)
                n += 1
    big = dataclasses.replace(make_op("sobel"), name="ones23", halo=11,
                              kernels=(np.ones((23, 23), np.float32),), combine="single",
                              scale=1.0 / 529)
    assert sk.swar_kind(big) == "K8"
    for x in (plane, gray8k[:1080]):
        check_equal(f"K8 23x23 filter {tuple(x.shape)}", sk.swar_stencil(big, x),
                    sk.swar_stencil_plain(big, x))
        n += 1
    spec = "grayscale," + ",".join(["brightness:1"] * 17) + ",gaussian:5"
    pipe = Pipeline.parse(spec)
    x8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
    ck.reset_launch_counts()
    out = run_image(pipe, x8k, impl="swar", device=device, plan="off")
    torch.cuda.synchronize()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    check_equal("swar path with a 17-step chain", out, want)
    if counts != {"K1": 2, "K6-narrow": 1}:
        raise AssertionError(f"swar path with a 17-step chain: launches {counts}")
    print(f"phase 1: {spec.split(',')[0]} + 17 x brightness:1 + gaussian:5 impl=swar at "
          f"{MAIN_H}x{MAIN_W}: == golden, launches {counts}")
    return n + 1


def phase2_tools(device) -> dict:
    """The tools' entry points on the card, in-process: `roofline_probe
    --quick`, the `packed_proto` self-test and `swar_proto --quick`, each
    with the launch counts set to 0 before it and read after it. Prints
    their records; fails if a tool's kernels were not launched or a record
    is missing. Returns {tool: (launch counts, best records)}."""
    import contextlib
    import io

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

    # tool -> (entry point, arguments, kernels it must launch, best records wanted)
    tools = {
        "roofline_probe": (rp.main, ["--quick"],
                           ("T4-copy", "T4-smem-copy", "T4-bitcast-store", "T4-bitcast-load",
                            "K2"), 11),
        "packed_proto": (pp.main, [], ("T2",), 0),
        "swar_proto": (sp.main, ["--quick"], ("T3", "K2", "K6-narrow"), 8),
    }
    runs = {}
    name = torch.cuda.get_device_name(0)
    for tool, (entry, argv, kernels, n_best) in tools.items():
        buf = io.StringIO()
        ck.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = entry(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  {tool}: {line}")
        best = [json.loads(ln) for ln in lines if ln.startswith("{") and '"stat"' in ln]
        missing = [k for k in kernels if not counts.get(k)]
        if rc != 0 or missing or len(best) != n_best:
            raise AssertionError(f"{' '.join([tool] + argv)}: rc {rc}, launches {counts}, "
                                 f"kernels not launched {missing}, {len(best)} best records")
        if any(r["device"] != name or r["clock"] != "cuda events" for r in best):
            raise AssertionError(f"{tool}: records not from the card: {best}")
        runs[tool] = (counts, best)
        print(f"phase 2: {' '.join([tool] + argv)} on the card: launches {counts}")
    return runs


def phase3_tools(device, gray8k, tool_runs, record):
    """T4's kernels, T2 and T3 at their tools' shapes (the 8K plane or
    frame), each held against its plain version with `record`; K1 on T2's
    group and frame, and K2 and K6 narrow on T3's plane, timed beside them
    in the same run; the probe's copy rates as a share of the data sheet's
    3.35 TB/s."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    csrc = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/"
    probe = "tools/roofline_probe.py"
    n_pix = rp.H * rp.W
    t4 = tool_runs["roofline_probe"][0]
    x = torch.from_numpy(synthetic_image(rp.H, rp.W, channels=1, seed=99)).to(device)
    for label, arr, c in (("u8", x, 1), ("f32", x.float(), 4), ("u32 packed", pp.pack_u8(x), 4)):
        out = torch.empty_like(arr)
        record(f"T4 copy_probe [{label} {tuple(arr.shape)}, block_h 128]", csrc + "copy_probe.cu",
               f"{probe}:88", t4["T4-copy"], lambda arr=arr: rp.copy_probe(arr, 128),
               lambda arr=arr: rp.copy_probe_plain(arr), c, c, [], n_pix=arr.numel(),
               library=lambda out=out, arr=arr: out.copy_(arr))
    out = torch.empty_like(x)
    record(f"T4 smem_copy [u8 {tuple(x.shape)}, block_h 128] for the lagged copy",
           csrc + "copy_probe.cu", f"{probe}:158", t4["T4-smem-copy"],
           lambda: rp.smem_copy(x, 128), lambda: rp.copy_probe_plain(x), 1, 1, [],
           library=lambda: out.copy_(x))
    words = rp.bitcast_store(x, 128)
    pack_view = x.view(rp.H // 4, 4, rp.W).transpose(1, 2)
    unpack_view = words.view(torch.uint8).view(rp.H // 4, rp.W, 4).transpose(1, 2)
    record("T4 bitcast_store [u8 -> u32 sublane words, block_h 128]", csrc + "copy_probe.cu",
           f"{probe}:217", t4["T4-bitcast-store"], lambda: rp.bitcast_store(x, 128),
           lambda: rp.bitcast_store_plain(x), 1, 1, [], library=lambda: pack_view.contiguous())
    record("T4 bitcast_load [u32 sublane words -> u8, block_h 128]", csrc + "copy_probe.cu",
           f"{probe}:232", t4["T4-bitcast-load"], lambda: rp.bitcast_load(words, 128),
           lambda: rp.bitcast_load_plain(words), 1, 1, [],
           library=lambda: unpack_view.contiguous())
    del words, out
    sweep = []
    for label, arr in (("u8", x), ("f32", x.float())):
        for bh in rp.BLOCK_HEIGHTS:
            ms = device_time_ms(lambda arr=arr, bh=bh: rp.copy_probe(arr, bh), reps=7)
            sweep.append(f"{label} bh {bh}: {ms:.4f} ms "
                         f"({2 * arr.numel() * arr.element_size() / ms / 1e6:.0f} GB/s)")
    for bh in rp.BLOCK_HEIGHTS:
        ms = device_time_ms(lambda bh=bh: rp.smem_copy(x, bh), reps=7)
        sweep.append(f"shared-memory u8 bh {bh}: {ms:.4f} ms ({2 * x.numel() / ms / 1e6:.0f} GB/s)")
    print("  T4 copies by block height in this run: " + "; ".join(sweep))
    for rec in tool_runs["roofline_probe"][1]:
        if rec.get("gb_s") and "copy" in rec["case"]:
            print(f"  copy rate {rec['case']} block_h {rec.get('block_h')}: {rec['gb_s']:.1f} "
                  f"GB/s, {rec['gb_s'] / (H100_BYTES_PER_S / 1e9):.1%} of 3.35 TB/s "
                  f"({rec['device']}, {rec['power_limit']})")

    # T2 at 8K beside K1 on the same group and frame
    rgb = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    planes = [pp.pack_u8(rgb[..., c].contiguous()) for c in range(3)]
    chain = list(make_pipeline_ops(pp.CHAIN))
    record("T2 packed_gray_contrast [grayscale,contrast3.5] 8K, block_h 128",
           csrc + "packed_proto.cu", "tools/packed_proto.py:141",
           tool_runs["packed_proto"][0]["T2"], lambda: pp.packed_gray_contrast(*planes),
           lambda: pp.packed_gray_contrast_plain(*planes), 3, 1, chain, n_pix=MAIN_H * MAIN_W)
    t_k1 = device_time_ms(lambda: ck.pointwise_group(chain, rgb), reps=7)
    t_bh = {bh: device_time_ms(lambda bh=bh: pp.packed_gray_contrast(*planes, block_h=bh), reps=7)
            for bh in (8, 32, 512)}
    print(f"  K1 on the same group and frame ((H, W, 3) u8 in, gray out) in this run: "
          f"{t_k1:.4f} ms; T2 at block_h " +
          ", ".join(f"{bh}: {t:.4f} ms" for bh, t in t_bh.items()))
    del planes, rgb

    # T3 at 8K (bh 240) beside K6 narrow and K2 on the same plane
    g5 = make_op("gaussian:5")
    ext = sp.pack_quarters(sp.reflect_pad(x))
    record("T3 swar_proto [gaussian5] quarter-strip words 8K, bh 240", csrc + "swar_proto.cu",
           "tools/swar_proto.py:122", tool_runs["swar_proto"][0]["T3"],
           lambda: sp.swar_proto(ext, 240), lambda: sp.swar_words_plain(ext), 1, 1, [g5],
           strip_bytes=ext.numel() * 4 - n_pix, library=conv_library(g5, x, pad_rows=True))
    t_k6 = device_time_ms(lambda: sk.swar_stencil(g5, x), reps=7)
    t_k2 = device_time_ms(lambda: ck.stream_stencil([], g5, x), reps=7)
    t_e2e = device_time_ms(lambda: sp.gaussian5(x, 240), reps=7)
    print(f"  on the same 8K gray plane in this run: K6 narrow {t_k6:.4f} ms, K2 {t_k2:.4f} ms, "
          f"T3 with pad, pack and unpack {t_e2e:.4f} ms")


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


def bound(nbytes: int, ops: int, ops_ms: float | None = None) -> tuple[float, str]:
    """The least time for `nbytes` of device memory traffic and `ops`
    float32 operations (or, given, `ops_ms` for the operations)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3 if ops_ms is None else ops_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_ops_ms(ops, arms, n_pix: int, c_in: int) -> float:
    """Least time for a stage's operations with its stencils on the given
    in-stage arms: each tensor-core stencil's useful multiply-adds (two
    operations per nonzero tap, per pixel and plane) at the dense peak of
    its form, the rest as `op_count` counts it at the float32 rate."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp

    tc_ms, c = 0.0, c_in
    for op, arm in zip(ops, arms):
        if isinstance(op, StencilOp) and arm != "vpu":
            nnz = sum(int((w != 0).sum()) for w in op.kernels)
            tc_ms += 2 * nnz * n_pix * c / H100_TC_OPS_PER_S[arm] * 1e3
        elif not isinstance(op, StencilOp):
            c = op.out_channels or c
    rest = [op for op, arm in zip(ops, arms) if arm == "vpu"]
    return tc_ms + op_count(rest, n_pix, c_in) / H100_F32_OPS_PER_S * 1e3


def conv_library(op, x, pad_rows: bool):
    """One PyTorch call that computes a lone correlation stencil: a
    depthwise float32 `F.conv2d` (TF32 off) over the planes of the u8 image
    or pre-extended tile `x`, padded by the op's halo beforehand (columns
    always, rows unless the tile already carries them). The yardstick for
    `library_ms`; it leaves out the rounding to u8 and pads by reflection
    whatever the op's edge mode (border pixels only, the same work)."""
    import torch
    import torch.nn.functional as F

    h, k = op.halo, 2 * op.halo + 1
    c = x.shape[2] if x.ndim == 3 else 1
    planes = x.reshape(x.shape[0], x.shape[1], c).permute(2, 0, 1)[None].float()
    xf = F.pad(planes, (h, h, h if pad_rows else 0, h if pad_rows else 0), mode="reflect")
    weight = torch.as_tensor(op.kernels[0] * op.scale, dtype=torch.float32, device=x.device)
    weight = weight.expand(c, 1, k, k).contiguous()
    return lambda: F.conv2d(xf, weight, groups=c)


def phase3(device, x8k, launches, sharded_launches, mxu_launches, gray8k, swar_launches,
           tool_runs):
    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    mp = n_pix / 1e6
    rows = []
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"

    def record(name, source, replaces, launch_count, fn, plain, c_in, c_out, ops,
               library=None, n_pix=n_pix, strip_bytes=0, ops_ms=None):
        """Time one kernel beside its plain version. The bound counts
        `n_pix` pixels read at c_in and written at c_out bytes, plus
        `strip_bytes` of ghost rows read once, and the operations `ops`
        does (or `ops_ms` for them)."""
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain, max abs err {err}")
        ms = device_time_ms(fn, reps=7)
        plain_ms = device_time_ms(plain, reps=3, inner=2)
        library_ms = device_time_ms(library, reps=7) if library is not None else None
        nbytes = (c_in + c_out) * n_pix + strip_bytes
        bound_ms, bound_by = bound(nbytes, op_count(ops, n_pix, c_in), ops_ms)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch_count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        rows.append(row)
        print(f"kernel {name}: {ms:.4f} ms ({n_pix / 1e6 / ms * 1e3:.1f} MP/s), bound "
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
    conv5 = conv_library(st5, x8k, pad_rows=True)
    record(
        "K2 stream_stencil [gaussian5]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["gaussian5_8k", "off"]["K2"],
        lambda: ck.stream_stencil(pw5, st5, x8k),
        lambda: ck.stream_stencil_plain(pw5, st5, x8k), 3, 3, pw5 + [st5],
        library=conv5,
    )
    # K4 on the gaussian:5 path's one stage, RGB in and out, beside the same
    # convolution
    record(
        "K4 fused_stage [gaussian5]", k4,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
        launches["gaussian5_8k", "fused-pallas"]["K4"],
        lambda: ck.fused_stage([st5], x8k), lambda: ck.fused_stage_plain([st5], x8k),
        3, 3, [st5], library=conv5,
    )
    del conv5
    # the two K2 launches of the megakernel chain under plan off: the
    # prologue fused into gaussian:5 (RGB in, gray out), then sharpen on gray
    (pwm, stm), (pws, sts), _ = ck.group_ops(make_pipeline_ops(SPECS["megakernel_ab"]))
    graym = ck.stream_stencil(pwm, stm, x8k)
    record(
        "K2 stream_stencil [grayscale,contrast3.5,gaussian5]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["megakernel_ab", "off"]["K2"],
        lambda: ck.stream_stencil(pwm, stm, x8k),
        lambda: ck.stream_stencil_plain(pwm, stm, x8k), 3, 1, pwm + [stm],
    )
    record(
        "K2 stream_stencil [sharpen] gray", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["megakernel_ab", "off"]["K2"],
        lambda: ck.stream_stencil(pws, sts, graym),
        lambda: ck.stream_stencil_plain(pws, sts, graym), 1, 1, [sts],
        library=conv_library(sts, graym, pad_rows=True),
    )
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

    phase3_sharded(device, x8k, graym, sharded_launches, record)
    del graym
    phase3_k5(device, x8k, mxu_launches, record)
    phase3_swar(device, x8k, gray8k, swar_launches, record)
    phase3_tools(device, gray8k, tool_runs, record)

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
                            reps=3, inner=5)
        bms, by = bound(6 * n_pix, op_count(pws + [sts], n_pix, 3))
        print(f"sweep K2 {spec} 8K RGB: {ms:.4f} ms, bound {bms:.4f} ms by {by} "
              f"({bms / ms:.1%})")
    return rows


def phase3_k5(device, x8k, mxu_launches, record):
    """K5's times in each form at the main stages' shapes (8K, and K4g on a
    middle 1080 x 7680 shard), each held against its plain version and
    printed beside the VPU arm's time in the same run, then each
    tensor-core path end to end. `record` appends the kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    local_h = MAIN_H // N_SHARDS
    y0 = local_h
    kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)
    # form -> (setting, label, the phase-2 run whose launches count)
    forms = {"mxu-int8": ("on", "int8", ("cuda", "fused-pallas-mxu")),
             "mxu": ("f32", "bf16", ("cuda", "f32"))}
    for key, c_out in (("reference", 1), ("gaussian5_8k", 3), ("megakernel_ab", 1)):
        ops = make_pipeline_ops(SPECS[key])
        names = ",".join(op.name for op in ops)
        H = chain_halo(ops)
        ext = x8k[y0 - H:y0 + local_h + H].contiguous()
        library = conv_library(ops[0], x8k, pad_rows=True) if len(ops) == 1 else None
        library_g = conv_library(ops[0], ext, pad_rows=False) if len(ops) == 1 else None
        vpu = ("vpu",) * len(ops)
        t_vpu = device_time_ms(lambda ops=ops: ck.fused_stage(ops, x8k, arms=vpu), reps=7)
        t_vpu_g = device_time_ms(lambda ops=ops: ck.fused_stage_ext(ops, ext, arms=vpu, **kw), reps=7)
        for arm, (setting, label, lkey) in forms.items():
            arms = ck.stage_arms(ops, setting)
            ck_key = K5_KEYS[arm]
            ops_ms = k5_ops_ms(ops, arms, n_pix, 3)
            record(
                f"K5 {label} in fused_stage [{names}]", K5_SOURCE, K5_REPLACES,
                mxu_launches[(key, *lkey)][ck_key],
                lambda ops=ops, arms=arms: ck.fused_stage(ops, x8k, arms=arms),
                lambda ops=ops, arms=arms: ck.fused_stage_plain(ops, x8k, arms=arms),
                3, c_out, ops, library=library, ops_ms=ops_ms,
            )
            print(f"  operations bound {ops_ms:.4f} ms; the VPU arm of K4 on the same stage "
                  f"in this run: {t_vpu:.4f} ms")
        # K4g's form on one shard: the int8 form, which the sharded main path
        # launches
        arms = ck.stage_arms(ops, "on")
        ops_ms = k5_ops_ms(ops, arms, local_h * MAIN_W, 3)
        record(
            f"K5 int8 in fused_stage_ext [{names}]", K5_SOURCE, K5_REPLACES,
            mxu_launches[key, "sharded", "cuda", "fused-pallas-mxu", "serial"]["K5-int8"],
            lambda ops=ops, arms=arms, ext=ext: ck.fused_stage_ext(ops, ext, arms=arms, **kw),
            lambda ops=ops, arms=arms, ext=ext: ck.fused_stage_ext_plain(
                ops, ext, arms=arms, **kw),
            3, c_out, ops, library=library_g, n_pix=local_h * MAIN_W,
            strip_bytes=2 * H * MAIN_W * 3, ops_ms=ops_ms,
        )
        print(f"  operations bound {ops_ms:.4f} ms; the VPU arm of K4g on the same shard in "
              f"this run: {t_vpu_g:.4f} ms")
        del ext, library, library_g
    torch.cuda.synchronize()

    mp = n_pix / 1e6
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        for impl, plan in (("cuda", "fused-pallas-mxu"), ("mxu", "off")):
            runner = image_runner(pipe, impl=impl, device=device, plan=plan)
            t = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
            used = {k: v for k, v in mxu_launches[key, impl, plan].items() if v}
            print(f"path {key} [{spec}] impl={impl} plan={plan} {MAIN_H}x{MAIN_W} RGB in, RGB "
                  f"out: {t:.4f} ms ({mp / t * 1e3:.1f} MP/s), launches {used}")


def host_enqueue_ms(fn, reps: int = 7) -> float:
    """Host milliseconds one call of `fn` takes to enqueue its work (no
    synchronise inside the timed region; the device is idle when it starts):
    the median of `reps` samples. Not a device time."""
    import statistics

    import torch

    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


def phase3_sharded(device, x8k, gray8k, sharded_launches, record):
    """Times of K2g, K3, K4g and the per-shard K1 at the shapes the sharded
    main paths give them (a middle 1080 x 7680 shard of the 8K frame; the
    interior and one boundary band of the overlap mode), each held against
    its plain version, then of one strip exchange and of each sharded path
    end to end beside the unsharded one. `gray8k` is the megakernel chain's
    gray intermediate, the input of its second group. `record` appends the
    kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    k1 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu"
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"
    pk = "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py"
    local_h = MAIN_H // N_SHARDS
    y0 = local_h  # the second of four shards: neither edge
    n_pix = local_h * MAIN_W
    kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)

    def cut(img, h):
        """The shard's tile of `img` and its two h-row ghost strips."""
        return (img[y0:y0 + local_h].contiguous(), img[y0 - h:y0].contiguous(),
                img[y0 + local_h:y0 + local_h + h].contiguous())

    def names(ops):
        return ",".join(op.name for op in ops)

    # K2g on every stencil group of the three paths: the tile and two
    # (halo, W[, 3]) strips in. A lone stencil on a middle shard is one
    # convolution of the extended tile; a fused group has no single call
    groups = [(key, src, pw, st)
              for key, src in (("reference", x8k), ("gaussian5_8k", x8k))
              for pw, st in [split_group(SPECS[key])]]
    (pwm, stm), (pws, sts), (pwq, _) = ck.group_ops(make_pipeline_ops(SPECS["megakernel_ab"]))
    groups += [("megakernel_ab", x8k, pwm, stm), ("megakernel_ab", gray8k, pws, sts)]
    for key, src, pw, st in groups:
        tile, top, bottom = cut(src, st.halo)
        c_in = src.shape[2] if src.ndim == 3 else 1
        c_out = next((op.out_channels for op in reversed(pw) if op.out_channels), c_in)
        library = None if pw else conv_library(st, torch.cat([top, tile, bottom]), pad_rows=False)
        record(
            f"K2g stream_stencil_ghost [{names(pw + [st])}]" + ("" if c_in == 3 else " gray"),
            k2, f"{pk}:377", sharded_launches[key, "off", "serial", False]["K2g"],
            lambda pw=pw, st=st, t=(tile, top, bottom): ck.stream_stencil_ghost(pw, st, *t, **kw),
            lambda pw=pw, st=st, t=(tile, top, bottom): ck.stream_stencil_ghost_plain(
                pw, st, *t, **kw),
            c_in, c_out, pw + [st], library=library, n_pix=n_pix,
            strip_bytes=2 * st.halo * MAIN_W * c_in,
        )
        del library
    # K1 on the megakernel chain's trailing pointwise run, one gray shard
    gtile = gray8k[y0:y0 + local_h].contiguous()
    record(
        f"K1 pointwise_group [{names(pwq)}] gray shard", k1, f"{pk}:540",
        sharded_launches["megakernel_ab", "off", "serial", False]["K1"],
        lambda: ck.pointwise_group(pwq, gtile), lambda: ck.pointwise_group_plain(pwq, gtile),
        1, 1, pwq, n_pix=n_pix,
    )
    del gtile
    # K3 on gaussian:5 over the materialised (1084, W, 3) tile, as the padded
    # 4323-row run launches it
    _, st5 = split_group(SPECS["gaussian5_8k"])
    tile, top, bottom = cut(x8k, 2)
    ext = torch.cat([top, tile, bottom]).contiguous()
    record(
        "K3 stencil_tile [gaussian5]", k2, f"{pk}:787",
        sharded_launches["gaussian5_8k", "off", "serial", True]["K3"],
        lambda: ck.stencil_tile(st5, ext), lambda: ck.stencil_tile_plain(st5, ext),
        3, 3, [st5], library=conv_library(st5, ext, pad_rows=False), n_pix=n_pix,
        strip_bytes=4 * MAIN_W * 3,
    )
    # K3 as the overlap mode launches it, three times per group and shard:
    # the tile itself as the extended input of its interior (1076 rows out),
    # and a (3h, W, 3) boundary band (h rows out)
    k3_overlap = sharded_launches["gaussian5_8k", "off", "overlap", False]["K3"]
    record(
        "K3 stencil_tile [gaussian5] overlap interior", k2, f"{pk}:787", k3_overlap,
        lambda: ck.stencil_tile(st5, tile), lambda: ck.stencil_tile_plain(st5, tile),
        3, 3, [st5], library=conv_library(st5, tile, pad_rows=False),
        n_pix=(local_h - 4) * MAIN_W, strip_bytes=4 * MAIN_W * 3,
    )
    band = ext[:6].contiguous()
    record(
        "K3 stencil_tile [gaussian5] overlap band", k2, f"{pk}:787", k3_overlap,
        lambda: ck.stencil_tile(st5, band), lambda: ck.stencil_tile_plain(st5, band),
        3, 3, [st5], library=conv_library(st5, band, pad_rows=False),
        n_pix=2 * MAIN_W, strip_bytes=4 * MAIN_W * 3,
    )
    # K3 on the reference path's emboss:3 over the gray (1082, W) tile
    pwr, str_ = split_group(SPECS["reference"])
    tile1, top, bottom = cut(x8k, 1)
    ext1 = ck.pointwise_group(pwr, torch.cat([top, tile1, bottom]).contiguous())
    record(
        "K3 stencil_tile [emboss3] gray", k2, f"{pk}:787",
        sharded_launches["reference", "off", "serial", True]["K3"],
        lambda: ck.stencil_tile(str_, ext1), lambda: ck.stencil_tile_plain(str_, ext1),
        1, 1, [str_], library=conv_library(str_, ext1, pad_rows=False), n_pix=n_pix,
        strip_bytes=2 * MAIN_W,
    )
    del ext, ext1, band, tile1
    # K4g on the one stage of each path, over the (1080 + 2H, W, 3) tile;
    # the lone gaussian:5 stage is the same convolution as K3's
    for key, c_out in (("reference", 1), ("gaussian5_8k", 3), ("megakernel_ab", 1)):
        ops = make_pipeline_ops(SPECS[key])
        H = chain_halo(ops)
        tile, top, bottom = cut(x8k, H)
        ext = torch.cat([top, tile, bottom]).contiguous()
        library = conv_library(ops[0], ext, pad_rows=False) if len(ops) == 1 else None
        record(
            f"K4g fused_stage_ext [{names(ops)}]", k4, f"{pk}:993",
            sharded_launches[key, "fused-pallas", "serial", False]["K4g"],
            lambda ops=ops, ext=ext: ck.fused_stage_ext(ops, ext, **kw),
            lambda ops=ops, ext=ext: ck.fused_stage_ext_plain(ops, ext, **kw),
            3, c_out, ops, library=library, n_pix=n_pix, strip_bytes=2 * H * MAIN_W * 3,
        )
        del ext, library
    del tile, top, bottom

    # one exchange round of halo-1 and halo-3 RGB strips over the mesh
    mesh = sharded_mesh()
    tiles = [x8k[k * local_h:(k + 1) * local_h].to(mesh.devices[k]) for k in range(N_SHARDS)]
    for h in (1, 3):
        ms = device_time_ms(lambda h=h: halo.exchange_halo_strips(tiles, h, mesh), reps=5)
        print(f"exchange: one round of ({h}, {MAIN_W}, 3) strips over {N_SHARDS - 1} "
              f"boundaries ({6 * h * MAIN_W * 3} B copied): {ms:.4f} ms")
    del tiles

    # each sharded path end to end beside the unsharded one, no gray -> RGB
    mp = MAIN_H * MAIN_W / 1e6
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        for plan in PLANS:
            one = pipe.jit("cuda", device=device, plan=plan)
            t_one = device_time_ms(lambda: one(x8k), reps=5, inner=3)
            times, enqueue = {}, {}
            for halo_mode in HALO_MODES:
                fn = pipe.sharded(mesh, backend="cuda", plan=plan, halo_mode=halo_mode)
                times[halo_mode] = device_time_ms(lambda: fn(x8k), reps=5, inner=3)
                enqueue[halo_mode] = host_enqueue_ms(lambda: fn(x8k))
            used = {k: v for k, v in
                    sharded_launches[key, plan, "serial", False].items() if v}
            print(f"sharded path {key} [{spec}] plan={plan} {MAIN_H}x{MAIN_W} RGB over "
                  f"{N_SHARDS} slots on {len(set(mesh.devices))} card(s): serial "
                  f"{times['serial']:.4f} ms ({mp / times['serial'] * 1e3:.1f} MP/s), overlap "
                  f"{times['overlap']:.4f} ms, unsharded {t_one:.4f} ms; host time to enqueue "
                  f"one call: serial {enqueue['serial']:.4f} ms, overlap "
                  f"{enqueue['overlap']:.4f} ms; serial launches {used}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
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
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    phase1(device)
    phase1_k5(device)
    phase1_reference(device)
    x8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    phase1_k5_main(device, x8k)
    phase1_k5_sums(device, x8k)
    gray8k = Pipeline.parse("grayscale").jit("torch", device=device, plan="off")(x8k)
    phase1_swar(device, gray8k)
    phase1_tools(device, gray8k)
    launches = phase2(device, x8k)
    sharded_launches = phase2_sharded(device, x8k)
    mxu_launches = phase2_mxu(device, x8k)
    swar_launches = phase2_swar(device, x8k, gray8k)
    tool_runs = phase2_tools(device)
    rows = phase3(device, x8k, launches, sharded_launches, mxu_launches, gray8k, swar_launches,
                  tool_runs)
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
