"""A/B of packed words against the u8 kernels, on one card, in one process;
the counterpart of the JAX repository's ``tools/packed_ab.py``.

    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.packed_ab
        [--hw H,W] [--device cuda|cpu]

First the reference pointwise prologue ``grayscale,contrast:3.5`` on
``synthetic_image(H, W, 3, seed=31)`` (default 2160 x 3840):

  a) ``prod_cuda``: ``Pipeline.jit('cuda')``, K1 on the (H, W, 3) image;
  b) ``prod_torch``: the golden ops;
  c) ``archived_packed``: ``pipeline_packed`` (tools/packed_kernels.py),
     T1's pointwise form on three packed word planes;
  d) ``packed_u32``: T2 (tools/packed_proto.py) on the three planes packed
     once, outside the timed call.

Then the 8K ``gaussian:5`` on ``synthetic_image(4320, 7680, 1, seed=7)``,
K2 (``Pipeline.jit('cuda')``) against T1 (``pipeline_packed``),
interleaved twice: ``g5_8k_cuda_r1``, ``g5_8k_packed_r1``, ``g5_8k_cuda_r2``,
``g5_8k_packed_r2``.

Every case is held equal to the golden ops before anything is timed. One
JSON record per case: ms by CUDA events, MP/s, GB/s (the pointwise group
reads 3 and writes 1 byte per pixel, gaussian:5 reads and writes 1), the
card's name and power limit. With ``--device cpu`` the tool checks the
plain versions at ``--hw`` (and gaussian:5 on a gray plane of that size)
and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mpi_cuda_imagemanipulation_tpu_torch.tools.common import card_label, emit, time_ms
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

CHAIN = "grayscale,contrast:3.5"
G5_HW = (4320, 7680)


def _check(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        err = (got.int() - want.int()).abs().max().item()
        raise AssertionError(f"{name} differs from the golden ops: max abs err {err}")


def run(height: int, width: int, device: torch.device, out=emit) -> list[dict]:
    """The A/B on `device`. Returns the records (none on the CPU)."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools.packed_kernels import pipeline_packed

    if width % 4:
        raise ValueError(f"--hw needs a width that is a multiple of 4, got {width}")
    rgb = torch.from_numpy(synthetic_image(height, width, channels=3, seed=31)).to(device)
    pipe = Pipeline.parse(CHAIN)
    golden = pipe.jit("torch", device=device)(rgb)
    planes = [pp.pack_u8(rgb[..., c].contiguous()) for c in range(3)]
    cases = [
        ("prod_cuda", pipe.jit("cuda", device=device)),
        ("prod_torch", pipe.jit("torch", device=device)),
        ("archived_packed", lambda x: pipeline_packed(pipe.ops, x)),
    ]
    for name, fn in cases:
        _check(name, fn(rgb), golden)
    _check("packed_u32", pp.unpack_u32(pp.packed_gray_contrast(*planes)), golden)

    g5 = Pipeline.parse("gaussian:5")
    if device.type == "cpu":
        gray = torch.from_numpy(synthetic_image(height, width, channels=1, seed=7))
        _check("gaussian:5 packed", pipeline_packed(g5.ops, gray), g5(gray))
        print("cpu validation ok (timing needs the card)", flush=True)
        return []

    label = card_label(device)
    n_pix = height * width
    records = []

    def record(name, fn, nbytes, mp):
        ms, clock = time_ms(fn, device)
        rec = {"case": name, "ms": ms, "mp_s": mp / 1e6 / (ms / 1e3),
               "gb_s": nbytes / (ms / 1e3) / 1e9, **label, "clock": clock}
        records.append(rec)
        out(rec)

    for name, fn in cases:
        record(name, lambda fn=fn: fn(rgb), 4 * n_pix, n_pix)
    record("packed_u32", lambda: pp.packed_gray_contrast(*planes), 4 * n_pix, n_pix)
    del rgb, planes

    gray8k = torch.from_numpy(synthetic_image(*G5_HW, channels=1, seed=7)).to(device)
    want = g5.jit("torch", device=device)(gray8k)
    fns = {"cuda": g5.jit("cuda", device=device),
           "packed": lambda x: pipeline_packed(g5.ops, x)}
    for name, fn in fns.items():
        _check(f"gaussian:5 {name}", fn(gray8k), want)
    n8k = G5_HW[0] * G5_HW[1]
    for rnd in (1, 2):
        for name, fn in fns.items():
            record(f"g5_8k_{name}_r{rnd}", lambda fn=fn: fn(gray8k), 2 * n8k, n8k)
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", default="2160,3840", help="H,W of the RGB frame (W %% 4 == 0)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu checks the plain versions)")
    args = ap.parse_args(argv)
    height, width = (int(v) for v in args.hw.split(","))
    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    run(height, width, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
