#!/usr/bin/env python3
"""Split the time of the redesigned kernels (K1; K4, K4g and K5, the
fused-stage megakernel; K2, K2g and K3, the stream-stencil kernel; T4's
copies) three ways on one NVIDIA GPU: the kernels' device time (CUDA
events around one call queued behind a spin kernel), the wrapper's host
time per call, and CUDA events around calls back to back, beside the PyTorch call that computes the same
function. The helpers are ``chip_smoke.split_ms``'s, read from the checkout
this file lies in; the port is imported from ``--root`` (default the same
checkout), so that two trees can be timed with one clock:

    python3 tests/_torch_split_timing.py [--root DIR] [--label NAME]

Prints the card's name and power limit, then one JSON object per case.
The cases are the rows of PERF.md that the redesigns are measured on: K1
on the 8K gray -> RGB pass, on quantize:6 over the 8K gray plane and over
one gray 1080x7680 shard; K4 on the three 8K main stages and the gray ->
RGB stage; K4g on the three stages over a middle 1080x7680 shard; K5 in
its int8 and bf16 forms on the three 8K stages and int8 on the shard; K3
on an overlap band of gaussian:5 ((6, 7680, 3) in), K3 on the reference
path's emboss:3 over a gray (1082, 7680) tile, K2g on sharpen over a gray
1080x7680 shard, K2 on the three 8K groups and on sharpen over the 8K gray
plane, and T4's copies at block height 128; the SWAR kernels on the
SWAR paths' groups: K6 narrow ([contrast:3.5, gaussian:5], and the bare
gaussian:5 beside T3) and wide (gaussian:7, box:5), K7 ([contrast:3.5,
emboss:3], and sharpen over the blurred plane) and K8 (sobel, scharr,
unsharp) on the 8K gray plane, T3 on that plane beside K6 narrow, K2 and
T4's u8 copy of it (with T3's registers, spills and SASS loops), K6g
narrow, K7g and K8g on one gray
1080x7680 shard; the packed-word tools' kernels T1 (8K gray gaussian:5),
T1g (one gray shard of it), T1-pw (grayscale,contrast:3.5 on 2160x3840
RGB) and T2 (the same group on the 8K RGB planes), each beside K2, K2g or
K1 on the same input. Then each 8K main path under ``--plan off`` and ``--plan
fused-pallas``: the median, least and most of seven readings (CUDA events
back to back), the two plans taken in turn.

    --cases T1,T2      only the cases whose names start so (no path rows
                       unless "path" is listed; the --impl swar paths, 8K
                       and sharded, where "swar-path" is)

Needs a card; builds the kernels of the tree at ``--root``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--cases", default=None,
                    help="comma-separated name prefixes of the cases to time (default all)")
    args = ap.parse_args(argv)
    keep = None if args.cases is None else tuple(args.cases.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools.packed_proto import pack_u8

    torch.backends.cudnn.allow_tf32 = False
    print(f"gpu: {cs.nvidia_smi()}; tree: {args.label} ({ck.__file__})")
    H, W = cs.MAIN_H, cs.MAIN_W
    x8k = torch.from_numpy(synthetic_image(H, W, seed=0)).cuda()
    local_h = H // cs.N_SHARDS
    y0 = local_h
    kw = dict(y0=y0, image_h=H, image_w=W)

    def cut(img, h):
        return (img[y0:y0 + local_h].contiguous(), img[y0 - h:y0].contiguous(),
                img[y0 + local_h:y0 + local_h + h].contiguous())

    cases = []
    # K1, K4, K4g and K5 on the main paths
    pwr, str_ = cs.split_group(cs.SPECS["reference"])
    gray = ck.stream_stencil(pwr, str_, x8k)
    (pwm, stm), (pws, sts), (pwq, _) = ck.group_ops(make_pipeline_ops(cs.SPECS["megakernel_ab"]))
    sharp = ck.stream_stencil(pws, sts, ck.stream_stencil(pwm, stm, x8k))
    g2r = list(make_pipeline_ops("gray2rgb"))
    cases.append(("K1 pointwise_group [gray2rgb] 8K", lambda: ck.pointwise_group(g2r, gray),
                  lambda: gray[..., None].expand(-1, -1, 3).contiguous()))
    cases.append(("K1 pointwise_group [quantize6] 8K gray", lambda: ck.pointwise_group(pwq, sharp),
                  lambda: torch.bitwise_and(sharp, cs.QUANTIZE6_MASK)))
    sharp_tile = sharp[y0:y0 + local_h].contiguous()
    cases.append(("K1 pointwise_group [quantize6] gray shard",
                  lambda: ck.pointwise_group(pwq, sharp_tile),
                  lambda: torch.bitwise_and(sharp_tile, cs.QUANTIZE6_MASK)))
    for key in ("reference", "gaussian5_8k", "megakernel_ab"):
        ops = make_pipeline_ops(cs.SPECS[key])
        names = ",".join(op.name for op in ops)
        vpu = ("vpu",) * len(ops)
        halo = sum(op.halo for op in ops)
        ext = x8k[y0 - halo:y0 + local_h + halo].contiguous()
        lib8k = cs.conv_library(ops[0], x8k, pad_rows=True) if len(ops) == 1 else None
        libg = cs.conv_library(ops[0], ext, pad_rows=False) if len(ops) == 1 else None
        cases.append((f"K4 fused_stage [{names}] 8K",
                      lambda ops=ops, vpu=vpu: ck.fused_stage(ops, x8k, arms=vpu), lib8k))
        cases.append((f"K4g fused_stage_ext [{names}] shard",
                      lambda ops=ops, vpu=vpu, ext=ext: ck.fused_stage_ext(ops, ext, arms=vpu, **kw),
                      libg))
        for setting, form in (("on", "int8"), ("f32", "bf16")):
            arms = ck.stage_arms(ops, setting)
            cases.append((f"K5 {form} in fused_stage [{names}] 8K",
                          lambda ops=ops, arms=arms: ck.fused_stage(ops, x8k, arms=arms), lib8k))
        arms = ck.stage_arms(ops, "on")
        cases.append((f"K5 int8 in fused_stage_ext [{names}] shard",
                      lambda ops=ops, arms=arms, ext=ext: ck.fused_stage_ext(ops, ext, arms=arms,
                                                                             **kw), libg))
    cases.append(("K4 fused_stage [gray2rgb] 8K", lambda: ck.fused_stage(g2r, gray),
                  lambda: gray[..., None].expand(-1, -1, 3).contiguous()))
    pw5, st5 = cs.split_group("gaussian:5")
    tile, top, bot = cut(x8k, 2)
    band = torch.cat([top, tile, bot])[:6].contiguous()
    cases.append(("K3 stencil_tile [gaussian5] overlap band (6, 7680, 3)",
                  lambda: ck.stencil_tile(st5, band), cs.conv_library(st5, band, pad_rows=False)))
    tile1, top1, bot1 = cut(x8k, 1)
    ext1 = ck.pointwise_group(pwr, torch.cat([top1, tile1, bot1]).contiguous())
    cases.append(("K3 stencil_tile [emboss3] gray (1082, 7680)",
                  lambda: ck.stencil_tile(str_, ext1), cs.conv_library(str_, ext1, pad_rows=False)))
    graym = ck.stream_stencil(pwm, stm, x8k)
    gt, gtop, gbot = cut(graym, 1)
    cases.append(("K2g stream_stencil_ghost [sharpen] gray shard",
                  lambda: ck.stream_stencil_ghost(pws, sts, gt, gtop, gbot, **kw),
                  cs.conv_library(sts, torch.cat([gtop, gt, gbot]), pad_rows=False)))
    cases.append(("K2 stream_stencil [grayscale,contrast3.5,emboss3] 8K",
                  lambda: ck.stream_stencil(pwr, str_, x8k), None))
    cases.append(("K2 stream_stencil [gaussian5] 8K", lambda: ck.stream_stencil(pw5, st5, x8k),
                  cs.conv_library(st5, x8k, pad_rows=True)))
    cases.append(("K2 stream_stencil [grayscale,contrast3.5,gaussian5] 8K",
                  lambda: ck.stream_stencil(pwm, stm, x8k), None))
    cases.append(("K2 stream_stencil [sharpen] 8K gray", lambda: ck.stream_stencil(pws, sts, graym),
                  cs.conv_library(sts, graym, pad_rows=True)))
    probe = torch.from_numpy(synthetic_image(rp.H, rp.W, channels=1, seed=99)).cuda()
    for label, arr in (("u8", probe), ("f32", probe.float()), ("u32 words", pack_u8(probe))):
        out = torch.empty_like(arr)
        cases.append((f"T4 copy_probe [{label}] block_h 128",
                      lambda arr=arr: rp.copy_probe(arr, 128),
                      lambda arr=arr, out=out: out.copy_(arr)))
    out8 = torch.empty_like(probe)
    cases.append(("T4 smem_copy [u8] block_h 128", lambda: rp.smem_copy(probe, 128),
                  lambda: out8.copy_(probe)))
    cases += swar_cases(cs, x8k, kw)
    cases += packed_cases(cs, x8k, kw)
    if keep is not None:
        cases = [c for c in cases if c[0].startswith(keep)]
    if any(name.startswith("T3") for name, _, _ in cases):
        print(f"T3 build: {cs.t3_build_summary()}")
    for name, fn, library in cases:
        row = {"case": name, "tree": args.label, **cs.split_ms(fn)}
        if library is not None:
            lib = cs.split_ms(library)
            row.update({f"library_{k}": v for k, v in lib.items()})
        print(json.dumps(row))
    if keep is None:
        print(json.dumps({"case": "host parts of the K3 band call, us per call enqueued back "
                          "to back", "tree": args.label, **host_parts(ck, st5, band)}))
    if keep is None or "path" in keep:
        for row in path_rows(cs, x8k):
            print(json.dumps({"tree": args.label, **row}))
    if keep is None or "swar-path" in keep:
        for row in swar_path_rows(cs, x8k):
            print(json.dumps({"tree": args.label, **row}))
    return 0


def swar_groups(cs, x8k, kw) -> list:
    """The SWAR paths' groups (chip_smoke.phase3_swar's rows), each as
    (name, stencil op, plane, pre ops, ghost keywords, library call or
    None): the 8K gray plane, and ghost mode on the middle shard, each
    beside the convolution where the group is one lone stencil."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

    gray = Pipeline.parse("grayscale").jit("torch", device=x8k.device, plan="off")(x8k)
    pre5 = cs.swar_case("gaussian:5", (("contrast:3.5",), ()))[1]
    blurred = sk.swar_stencil(cs.swar_case("gaussian:5", ((), ()))[0], gray, pre_ops=pre5)
    groups = []
    for label, spec, chain, x, lib in (
            ("K6 narrow", "gaussian:5", ("contrast:3.5",), gray, False),
            ("K6 narrow", "gaussian:5", (), gray, True),
            ("K6 wide", "gaussian:7", (), gray, True),
            ("K6 wide", "box:5", (), gray, True),
            ("K7", "emboss:3", ("contrast:3.5",), gray, False),
            ("K7", "sharpen", (), blurred, True),
            ("K8", "sobel", (), gray, False),
            ("K8", "scharr", (), gray, False),
            ("K8", "unsharp", (), gray, True)):
        st, pre = cs.swar_case(spec, (chain, ()))[:2]
        names = ",".join(op.name for op in pre + (st,))
        groups.append((f"{label} swar_stencil [{names}] 8K gray", st, x, pre, {},
                       cs.conv_library(st, x, pad_rows=True) if lib else None))
    y0, local_h, H = kw["y0"], cs.MAIN_H // cs.N_SHARDS, cs.MAIN_H
    for label, spec, chain, lib in (("K6g narrow", "gaussian:5", (), True),
                                    ("K7g", "emboss:3", ("contrast:3.5",), False),
                                    ("K8g", "sobel", (), False)):
        st, pre = cs.swar_case(spec, (chain, ()))[:2]
        tile, top, bottom = cs.gray_tile(gray, y0, local_h, st.halo, st)
        names = ",".join(op.name for op in pre + (st,))
        groups.append((f"{label} swar_stencil ghost [{names}] gray shard", st, tile, pre,
                       dict(ghosts=(top, bottom), y0=y0, global_h=H),
                       cs.conv_library(st, torch.cat([top, tile, bottom]), pad_rows=False)
                       if lib else None))
    return groups


def swar_cases(cs, x8k, kw) -> list:
    """K6, K7 and K8 on the SWAR paths' groups (`swar_groups`), and T3, the
    SWAR 5x5 prototype, on the same 8K gray plane, beside K6 narrow and K2
    on the bare gaussian:5 and T4's u8 copy of that plane (named "T3 vs
    ...", so that ``--cases T3`` keeps them; ``--cases "T3 swar"`` keeps T3
    alone)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

    cases = [(name, lambda st=st, x=x, pre=pre, g=g: sk.swar_stencil(st, x, pre_ops=pre, **g),
              lib) for name, st, x, pre, g, lib in swar_groups(cs, x8k, kw)]
    gray = Pipeline.parse("grayscale").jit("torch", device=x8k.device, plan="off")(x8k)
    ext = sp.pack_quarters(sp.reflect_pad(gray))
    st5 = cs.swar_case("gaussian:5", ((), ()))[0]
    out = torch.empty_like(gray)
    cases += [
        ("T3 swar_proto [gaussian5] quarter-strip words 8K gray", lambda: sp.swar_proto(ext, 240),
         cs.conv_library(st5, gray, pad_rows=True)),
        ("T3 vs K6 narrow swar_stencil [gaussian5] 8K gray", lambda: sk.swar_stencil(st5, gray),
         None),
        ("T3 vs K2 stream_stencil [gaussian5] 8K gray", lambda: ck.stream_stencil([], st5, gray),
         None),
        ("T3 vs T4 copy_probe [u8] 8K gray, block_h 128", lambda: rp.copy_probe(gray, 128),
         lambda: out.copy_(gray)),
    ]
    return cases


def packed_cases(cs, x8k, kw) -> list:
    """T1 on the 8K gray gaussian:5, T1g on one gray 1080x7680 shard of it,
    T1 on the reference group's three planes (8K RGB in, one plane out),
    T1-pw on packed_ab's group (2160x3840 RGB, seed 31), T2 on the 8K RGB
    planes, each beside the u8 kernel on the same input (K2, K2g, K1;
    named "<T> vs <K> ...", so that ``--cases T1,T2`` keeps them)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp

    H, W = cs.MAIN_H, cs.MAIN_W
    gray = Pipeline.parse("grayscale").jit("torch", device=x8k.device, plan="off")(x8k)
    pw5, st5 = cs.split_group("gaussian:5")
    words = cs.t1_words(gray)
    tile, top, bot, y0 = cs.t1_ghost_tile(gray, 1, cs.N_SHARDS, st5.halo)
    tile = tile.contiguous()
    tw, ghosts = cs.t1_words(tile), (cs.t1_words(top), cs.t1_words(bot))
    rows = tile.shape[0]
    rgb = torch.from_numpy(synthetic_image(2160, 3840, channels=3, seed=31)).to(x8k.device)
    chain = list(make_pipeline_ops(pp.CHAIN))
    planes_ab = cs.t1_words(rgb)
    planes8k = [pp.pack_u8(x8k[..., c].contiguous()) for c in range(3)]

    def t1():
        return pk.run_group_packed_words(pw5, st5, words, H, W)

    def t1g():
        return pk.run_group_packed_words(pw5, st5, tw, rows, W, ghosts=ghosts, y0=y0, image_h=H)

    pwr, str_ = cs.split_group(cs.SPECS["reference"])
    planes_ref = cs.t1_words(x8k)

    cases = [
        ("T1 packed_stream [gaussian5] 8K gray words", t1,
         cs.conv_library(st5, gray, pad_rows=True)),
        ("T1 vs K2 stream_stencil [gaussian5] 8K gray",
         lambda: ck.stream_stencil(pw5, st5, gray), None),
        ("T1g packed_stream [gaussian5] gray shard", t1g, None),
        ("T1 packed_stream [grayscale,contrast3.5,emboss3] 8K RGB words",
         lambda: pk.run_group_packed_words(pwr, str_, planes_ref, H, W), None),
        ("T1g vs K2g stream_stencil_ghost [gaussian5] gray shard",
         lambda: ck.stream_stencil_ghost(pw5, st5, tile, top, bot, y0=y0, image_h=H, image_w=W),
         None),
        ("T1-pw packed_stream [grayscale,contrast3.5] 2160x3840 RGB words",
         lambda: pk.run_group_packed_words(chain, None, planes_ab, 2160, 3840), None),
        ("T1-pw vs K1 pointwise_group [grayscale,contrast3.5] 2160x3840 RGB",
         lambda: ck.pointwise_group(chain, rgb), None),
        ("T2 packed_gray_contrast [grayscale,contrast3.5] 8K RGB planes",
         lambda: pp.packed_gray_contrast(*planes8k), None),
        ("T2 vs K1 pointwise_group [grayscale,contrast3.5] 8K RGB",
         lambda: ck.pointwise_group(chain, x8k), None),
    ]
    return cases


def path_rows(cs, x8k, rounds: int = 7) -> list[dict]:
    """Each 8K main path under both plans: `rounds` readings of
    ``device_time_ms`` each, the plans taken in turn; their median, least
    and most."""
    import statistics

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    rows = []
    for key, spec in cs.SPECS.items():
        runners = {plan: image_runner(Pipeline.parse(spec), impl="cuda", device=x8k.device,
                                      plan=plan) for plan in cs.PLANS}
        ms = {plan: [] for plan in runners}
        for _ in range(rounds):
            for plan, runner in runners.items():
                ms[plan].append(device_time_ms(lambda runner=runner: runner(x8k), reps=5,
                                               inner=3))
        rows += [{"case": f"path {key} plan={plan}", "median_ms": statistics.median(v),
                  "min_ms": min(v), "max_ms": max(v)} for plan, v in ms.items()]
    return rows


def swar_path_rows(cs, x8k, rounds: int = 7) -> list[dict]:
    """The `--impl swar` paths (chip_smoke.SWAR_SPECS, the 8K RGB frame),
    then the sharded SWAR paths (chip_smoke.SWAR_SHARDED, the 8K gray frame
    over the 4-slot mesh, serial): `rounds` readings of ``device_time_ms``
    each, the paths taken in turn; their median, least and most."""
    import statistics

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    gray = Pipeline.parse("grayscale").jit("torch", device=x8k.device, plan="off")(x8k)
    mesh = cs.sharded_mesh()
    calls = {f"swar path {key}": (image_runner(Pipeline.parse(spec), impl="swar",
                                               device=x8k.device, plan="off"), x8k)
             for key, (spec, _) in cs.SWAR_SPECS.items()}
    calls.update({f"swar sharded path [{spec}] gray": (Pipeline.parse(spec).sharded(
        mesh, backend="swar"), gray) for spec in cs.SWAR_SHARDED})
    ms = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (fn, x) in calls.items():
            ms[name].append(device_time_ms(lambda fn=fn, x=x: fn(x), reps=5, inner=3))
    return [{"case": name, "median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v)}
            for name, v in ms.items()]


def host_parts(ck, stencil, band, calls: int = 2000) -> dict:
    """Host microseconds per call, enqueued back to back with no
    synchronise (the card keeps up with these tiny launches), of the K3
    wrapper on the band and of the pieces of its work: the output's
    allocation, the current stream's handle, and F.conv2d's call for
    comparison."""
    import time

    import torch
    import torch.nn.functional as F

    weight = torch.ones((3, 1, 5, 5), device=band.device)
    planes = band.permute(2, 0, 1)[None].float()
    parts = {
        "stencil_tile": lambda: ck.stencil_tile(stencil, band),
        "torch.empty": lambda: torch.empty((2, band.shape[1], 3), dtype=torch.uint8,
                                           device=band.device),
        "stream handle": lambda: torch.cuda.current_stream(band.device).cuda_stream,
        "F.conv2d": lambda: F.conv2d(planes, weight, groups=3),
    }
    if hasattr(ck, "stream_handle"):
        parts["ck.stream_handle"] = lambda: ck.stream_handle(band.device)
    out = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    sys.exit(main())
