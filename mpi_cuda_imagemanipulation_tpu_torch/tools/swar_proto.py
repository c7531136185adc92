"""T3: the 5x5 binomial Gaussian on quarter-strip words, SWAR; the
counterpart of the JAX repository's ``tools/swar_proto.py``.

The row is cut into four equal strips and byte k of word j is strip k's
pixel j (``pack_quarters``), so a horizontal tap is a shift by whole words
for all four strips at once. The words split into two u32 arrays of two
16-bit fields each (bytes 0, 2 and 1, 3); the separable correlation runs on
those fields (row fields <= 4080, column fields <= 65280 < 2^16), and the
x 2^-8 round half to even is q = (s + 127 + ((s >> 8) & 1)) >> 8.

* ``swar_proto``: T3, the hand-written CUDA kernel
  (``ops/csrc/swar_proto.cu``), beside ``swar_words_plain`` (the JAX tool's
  whole-array ``swar_xla``), its plain version.
* ``pack_quarters`` / ``unpack_quarters``: plain PyTorch copies.
* ``bitexact_gate``: the JAX tool's gate, run before any timing.

Cases timed (round-robin rounds, per-case bests, the card's name and power
limit in every record): ``cuda_swar_prepacked_bh{120,240,480}`` (T3 on
pre-packed words), ``torch_swar_prepacked`` (the plain version),
``torch_swar_pack_cost`` (pack and unpack), ``swar_end_to_end`` (reflect
pad, pack, T3, unpack), ``gaussian5_8k_cuda`` (the port's K2) and
``gaussian5_8k_swar`` (the port's K6 narrow: production SWAR, which pairs
neighbouring columns instead of strips).

Usage: python -m mpi_cuda_imagemanipulation_tpu_torch.tools.swar_proto
       [--quick] [--height H] [--width W] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools.common import card_label, emit, run_rounds
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

TAPS = (1, 4, 6, 4, 1)  # binomial_1d(5); scale 1/256 in all
H_ = 2  # halo
BLOCK_HEIGHTS = (120, 240, 480)
# Launch geometry; SP_TILE_W in swar_proto.cu.
TILE_W = 32
M_LO = 0x00FF00FF


def pack_quarters(xpad: torch.Tensor) -> torch.Tensor:
    """(H + 2h, W + 2h) u8 reflect-padded plane -> (H + 2h, Ws + 2h) int32
    words; byte k of word j = quarter strip k's padded pixel j. Strip k's
    words cover padded columns [k Ws, k Ws + Ws + 2h), so every horizontal
    tap is word-local."""
    hp, wp2 = xpad.shape
    ws = (wp2 - 2 * H_) // 4
    strips = [xpad[:, k * ws: k * ws + ws + 2 * H_] for k in range(4)]
    return torch.stack(strips, dim=-1).contiguous().view(torch.int32).view(hp, ws + 2 * H_)


def unpack_quarters(words: torch.Tensor) -> torch.Tensor:
    """(H, Ws) int32 words -> (H, 4 Ws) u8, the four strips side by side."""
    h, ws = words.shape
    b = words.contiguous().view(torch.uint8).view(h, ws, 4)
    return torch.cat([b[..., k] for k in range(4)], dim=1)


def _taps5(a: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Sum of TAPS[t] * a shifted by t along `axis`, for n outputs."""
    acc = a.narrow(axis, 0, n) * TAPS[0]
    for t in range(1, 5):
        acc = acc + a.narrow(axis, t, n) * TAPS[t]
    return acc


def swar_words_plain(ext: torch.Tensor) -> torch.Tensor:
    """Plain version of T3 (the JAX tool's ``swar_xla``): (H + 4, Ws + 4)
    ext words -> (H, Ws) output words, the field arithmetic on int64."""
    w = ext.to(torch.int64) & 0xFFFFFFFF
    h, ws = ext.shape[0] - 2 * H_, ext.shape[1] - 2 * H_
    out = torch.zeros((h, ws), dtype=torch.int64, device=ext.device)
    for shift in (0, 8):
        rows = _taps5((w >> shift) & M_LO, 1, ws)
        s = _taps5(rows, 0, h)
        q = ((s + 0x007F007F + ((s >> 8) & 0x00010001)) >> 8) & M_LO
        out |= q << shift
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def smem_bytes(bh: int) -> int:
    """Dynamic shared memory of one T3 block (sp_smem_bytes in the source):
    the (bh + 4) x (TILE_W + 4) word window, then two (bh + 4) x TILE_W
    field arrays."""
    eh = bh + 2 * H_
    return (eh * (TILE_W + 2 * H_) + 2 * eh * TILE_W) * 4


def grid(height: int, ws: int, bh: int) -> tuple[int, int]:
    """T3's grid: (word-column tiles, row tiles)."""
    return -(-ws // TILE_W), -(-height // bh)


def swar_proto(ext: torch.Tensor, bh: int) -> torch.Tensor:
    """T3 over (H + 4, Ws + 4) int32 ext words into (H, Ws) words, in blocks
    of `bh` output rows (any height: stores stop at row H). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if ext.ndim != 2 or ext.dtype != torch.int32:
        raise ValueError(f"T3 takes 2-D int32 ext words, got {tuple(ext.shape)} {ext.dtype}")
    h, ws = ext.shape[0] - 2 * H_, ext.shape[1] - 2 * H_
    if h < 1 or ws < 1:
        raise ValueError(f"ext words {tuple(ext.shape)} hold no output")
    if bh < 1 or smem_bytes(bh) > ck.MAX_SMEM_BYTES:
        raise ValueError(f"block height {bh} needs {smem_bytes(bh)} B of shared memory "
                         f"(at most {ck.MAX_SMEM_BYTES})")
    if grid(h, ws, bh)[1] > ck._MAX_GRID_Y:
        raise ValueError(f"height {h} needs a taller block than {bh}")
    if ext.device.type == "cpu":
        return swar_words_plain(ext)
    if not ext.is_contiguous():
        raise ValueError("T3 takes contiguous ext words")
    out = torch.empty((h, ws), dtype=torch.int32, device=ext.device)
    with torch.cuda.device(ext.device):
        rc = kr.load("swar_proto").swar_proto_launch(
            ext.data_ptr(), out.data_ptr(), h, ws, bh,
            torch.cuda.current_stream().cuda_stream)
    ck._raise_on(rc, "swar_proto")
    ck.TOOL_LAUNCHES["T3"] += 1
    return out


def reflect_pad(img: torch.Tensor) -> torch.Tensor:
    """The u8 plane reflect-101 padded by the halo (numpy's 'reflect')."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import pad2d

    return pad2d(img.to(torch.float32), "reflect101", H_, H_, H_, H_).to(torch.uint8)


def gaussian5(img: torch.Tensor, bh: int) -> torch.Tensor:
    """`gaussian:5` on a u8 plane (W a multiple of 4) through T3: pad,
    pack, T3, unpack."""
    return unpack_quarters(swar_proto(pack_quarters(reflect_pad(img)), bh))


def bitexact_gate(device: torch.device) -> None:
    """The JAX tool's bit-exactness gate, on `device`: the plain version on
    48x64, 37x128 and 130x256 against the golden gaussian:5; T3 (on a card
    the kernel) at 48x64 with bh 16 and on the ragged heights 37/16 and
    50/24. Raises on a mismatch."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    pipe = Pipeline.parse("gaussian:5")

    def plane(h, w, seed):
        return torch.from_numpy(synthetic_image(h, w, channels=1, seed=seed)).to(device)

    for h, w, seed in ((48, 64, 1), (37, 128, 2), (130, 256, 3)):
        img = plane(h, w, seed)
        got = unpack_quarters(swar_words_plain(pack_quarters(reflect_pad(img))))
        if not torch.equal(got, pipe(img)):
            raise AssertionError(f"SWAR plain version != golden at {h}x{w}")
    for h, bh, seed in ((48, 16, 4), (37, 16, 6), (50, 24, 6)):
        img = plane(h, 64, seed)
        if not torch.equal(gaussian5(img, bh), pipe(img)):
            raise AssertionError(f"T3 != golden at {h}x64 bh={bh}")


def timing_cases(img: torch.Tensor) -> list:
    """The timed cases on the u8 plane `img`, as (base, fn)."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    h, w = img.shape
    mp = h * w
    xpad = reflect_pad(img)
    ext = pack_quarters(xpad)
    cases = [({"case": f"cuda_swar_prepacked_bh{bh}", "_mp": mp},
              lambda bh=bh: swar_proto(ext, bh)) for bh in BLOCK_HEIGHTS if h % bh == 0]
    cases += [
        ({"case": "torch_swar_prepacked", "_mp": mp}, lambda: swar_words_plain(ext)),
        ({"case": "torch_swar_pack_cost", "_mp": mp},
         lambda: unpack_quarters(pack_quarters(xpad))),
        ({"case": "swar_end_to_end", "block_h": 240, "_mp": mp}, lambda: gaussian5(img, 240)),
    ]
    ops = make_pipeline_ops("gaussian:5")
    cases.append(({"case": "gaussian5_8k_cuda", "_mp": mp},
                  lambda: ck.pipeline_cuda(ops, img)))
    cases.append(({"case": "gaussian5_8k_swar", "_mp": mp},
                  lambda: sk.swar_stencil(ops[0], img)))
    return cases


def run_proto(*, quick: bool, height: int, width: int, device: torch.device,
              out=emit) -> list[dict]:
    """The gate, then every case 1 (quick) or 3 times round-robin on a
    seeded (height, width) plane. Returns the per-case bests."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    if width % 4:
        raise ValueError(f"the width must be a multiple of 4, got {width}")
    bitexact_gate(device)
    print("bit-exactness gate: SWAR == golden on 3 shapes + T3 on 3 heights", flush=True)
    img = torch.from_numpy(synthetic_image(height, width, channels=1, seed=99)).to(device)
    return run_rounds(timing_cases(img), 1 if quick else 3, device, card_label(device), out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--height", type=int, default=4320)
    ap.add_argument("--width", type=int, default=7680)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    run_proto(quick=args.quick, height=args.height, width=args.width, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
