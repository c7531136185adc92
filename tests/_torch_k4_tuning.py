#!/usr/bin/env python3
"""Time builds of the fused-stage megakernel (K4, K4g, K5) that differ in
their preprocessor settings (the blocks an SM must hold per instantiation,
``FS_BLOCKS_3``, ``FS_BLOCKS_5``, ``FS_BLOCKS_MMA`` in ``fused_stage.cu``),
beside the checkout's own build, on one NVIDIA GPU: each variant is
``fused_stage.cu`` built with the package's nvcc flags and its ``-D``
settings into ``build/tuning/``, and timed at the main paths' shapes at
several tile heights; K1 is timed with the checkout's build. Device times
from CUDA events around one call queued behind a spin kernel, beside the
host time per call and events around calls back to back
(``chip_smoke.split_ms``); every build is held against the plain version
first.

    python3 tests/_torch_k4_tuning.py [--quick] [--cases K5,K4g] [--variant NAME=-DMACRO=V[,-DMACRO=V]]...

for example ``--variant "3x3 at 6=-DFS_BLOCKS_3=6"``. Prints the card's name
and power limit, the registers and spills each variant's ptxas reports,
then one JSON object per (variant, case, tile height). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(kr, name, defines) -> ctypes.CDLL:
    """``fused_stage.cu`` built with the extra nvcc flags `defines`, its
    launch functions typed as the checkout's."""
    tag = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    out = HERE / "build" / "tuning" / f"libfused_stage_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [kr.find_nvcc(), *kr.NVCC_FLAGS, *defines, "-o", str(out),
         str(kr.CSRC_DIR / "fused_stage.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{(proc.stdout + proc.stderr)[-3000:]}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"ptxas {tag}: {line.strip()}")
    base, handle = kr.load("fused_stage"), ctypes.CDLL(str(out))
    for fn in ("fused_stage_launch", "fused_stage_ext_launch"):
        getattr(handle, fn).argtypes = getattr(base, fn).argtypes
        getattr(handle, fn).restype = getattr(base, fn).restype
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="tile heights 16 and 32 only")
    ap.add_argument("--cases", default=None,
                    help="comma-separated name prefixes of the cases to time (default all)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: a build of fused_stage.cu with the comma-separated "
                         "nvcc FLAGS (-DFS_BLOCKS_3=6,-DFS_BLOCKS_5=5); repeatable")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

    print(f"gpu: {cs.nvidia_smi()}")
    H, W = cs.MAIN_H, cs.MAIN_W
    x8k = torch.from_numpy(synthetic_image(H, W, seed=0)).cuda()
    local_h = H // cs.N_SHARDS
    y0 = local_h
    kw = dict(y0=y0, image_h=H, image_w=W)
    pwr, str_ = cs.split_group(cs.SPECS["reference"])
    gray = ck.stream_stencil(pwr, str_, x8k)
    g2r = list(make_pipeline_ops("gray2rgb"))
    q6 = list(make_pipeline_ops("quantize:6"))
    gc = list(make_pipeline_ops("grayscale,contrast:3.5"))
    k4_cases, k1_cases = [], []
    for key in ("reference", "gaussian5_8k", "megakernel_ab"):
        ops = make_pipeline_ops(cs.SPECS[key])
        halo = sum(op.halo for op in ops)
        ext = x8k[y0 - halo:y0 + local_h + halo].contiguous()
        k4_cases.append((f"K4 {key} 8K",
                         lambda t, ops=ops: ck.fused_stage(ops, x8k, tile_h=t),
                         lambda ops=ops: ck.fused_stage_plain(ops, x8k)))
        k4_cases.append((f"K4g {key} shard",
                         lambda t, ops=ops, ext=ext: ck.fused_stage_ext(ops, ext, tile_h=t, **kw),
                         lambda ops=ops, ext=ext: ck.fused_stage_ext_plain(ops, ext, **kw)))
        for setting, form in (("on", "int8"), ("f32", "bf16")):
            arms = ck.stage_arms(ops, setting)
            k4_cases.append((f"K5 {form} {key} 8K",
                             lambda t, ops=ops, arms=arms: ck.fused_stage(ops, x8k, tile_h=t,
                                                                          arms=arms),
                             lambda ops=ops, arms=arms: ck.fused_stage_plain(ops, x8k,
                                                                             arms=arms)))
    k1_cases = [("K1 gray2rgb 8K", lambda: ck.pointwise_group(g2r, gray),
                 lambda: ck.pointwise_group_plain(g2r, gray)),
                ("K1 quantize:6 8K gray", lambda: ck.pointwise_group(q6, gray),
                 lambda: ck.pointwise_group_plain(q6, gray)),
                ("K1 grayscale,contrast:3.5 8K", lambda: ck.pointwise_group(gc, x8k),
                 lambda: ck.pointwise_group_plain(gc, x8k))]
    if args.cases is not None:
        keep = tuple(args.cases.split(","))
        k4_cases = [c for c in k4_cases if c[0].startswith(keep)]
        k1_cases = [c for c in k1_cases if c[0].startswith(keep)]
    heights = (16, 32) if args.quick else (8, 16, 32, 48, 64)
    orig_load = kr.load

    def load_with(lib, name):
        return lib if name == "fused_stage" else orig_load(name)

    def run(variant, lib=None):
        kr.load = ck.kr.load = functools.partial(load_with, lib) if lib else orig_load
        try:
            for name, fn, plain in k4_cases:
                want = plain()
                for t in (None, *heights):
                    got = fn(t)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{variant}: {name} tile_h={t} != plain")
                    row = {"variant": variant, "case": name, "tile_h": t,
                           **cs.split_ms(lambda fn=fn, t=t: fn(t))}
                    print(json.dumps(row))
            for name, fn, plain in k1_cases if lib is None else ():
                if not torch.equal(fn(), plain()):
                    raise AssertionError(f"{variant}: {name} != plain")
                print(json.dumps({"variant": variant, "case": name, **cs.split_ms(fn)}))
        finally:
            kr.load = ck.kr.load = orig_load

    run("checkout")
    if not args.variant:
        return 0
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        run(name, build_variant(kr, name, flags.split(",")))
    run("checkout again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
