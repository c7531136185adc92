"""T4: measure the card's reachable streaming rate; the counterpart of the
JAX repository's ``tools/roofline_probe.py``.

Every bound in PERF.md divides a kernel's bytes by the H100's data-sheet
rate (3.35 TB/s). This probe measures what the card reaches on the simplest
kernels of the same shape, beside that figure, on the 8K gray plane
(``synthetic_image(4320, 7680, channels=1, seed=99)``):

  a) ``torch_copy_u8`` / ``torch_copy_f32``: ``out.copy_(x)``, a
     device-to-device copy, in place of XLA's copy (``x + 0``);
  b) ``cuda_copy_u8`` / ``cuda_copy_f32`` / ``cuda_copy_u32_packed``: the
     hand-written tiled copy (``ops/csrc/copy_probe.cu``) at block heights
     64/128/256/512 (128 with ``--quick``);
  c) ``cuda_copy_u32_fullelems`` / ``cuda_copy_f32_packedsize``: u32 at the
     full element count, f32 at the packed size;
  d) ``cuda_smem_copy_u8``: each block staged through shared memory, which
     stands for ``pallas_lagged_copy_u8`` (the TPU's scratch carry has no
     counterpart on the card);
  e) ``torch_pack_bitcast`` / ``torch_unpack_bitcast``: free views in
     PyTorch, recorded as such, with no time;
  f) ``cuda_u8load_u32store_bitcast`` / ``cuda_u32load_u8store_bitcast``:
     the sublane bitcast pair (byte k of word (i, j) = u8 row 4i + k);
  g) ``gaussian5_8k_cuda``: the port's K2 on the same plane, same process.

Names map the JAX tool's ``pallas_*`` to ``cuda_*`` and ``xla_*`` to
``torch_*``. Every case is measured ``--rounds`` times round-robin, then
each case's best is emitted with ``stat: best_of_N_rounds``; each record
carries the card's name and power limit. The JAX tool's
``gaussian5_8k_packed`` case needs T1, which is not ported yet.

Usage: python -m mpi_cuda_imagemanipulation_tpu_torch.tools.roofline_probe
       [--quick] [--rounds N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools.common import card_label, emit, run_rounds
from mpi_cuda_imagemanipulation_tpu_torch.tools.packed_proto import pack_u8, unpack_u32
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

H, W = 4320, 7680
BLOCK_HEIGHTS = (64, 128, 256, 512)
_DTYPES = {torch.uint8: kr.CP_U8, torch.float32: kr.CP_F32, torch.int32: kr.CP_U32}


# --------------------------------------------------------------------------
# The kernels' wrappers and plain versions
# --------------------------------------------------------------------------


def _check(x: torch.Tensor, block_h: int, dtypes, grid_y: int) -> None:
    if x.ndim != 2 or x.dtype not in dtypes:
        raise ValueError(f"takes a 2-D {dtypes} array, got {tuple(x.shape)} {x.dtype}")
    if block_h < 1:
        raise ValueError(f"block height must be >= 1, got {block_h}")
    if grid_y > ck._MAX_GRID_Y:
        raise ValueError(f"{x.shape[0]} rows need a taller block than {block_h}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("takes a contiguous array")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def copy_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the copies: a copy."""
    return x.clone()


def copy_probe(x: torch.Tensor, block_h: int) -> torch.Tensor:
    """T4's tiled copy of a 2-D u8, f32 or int32 (the u32 words) array in
    blocks of `block_h` rows; 16-byte vectors where the row pitch allows.
    CPU tensors take the plain version."""
    _check(x, block_h, tuple(_DTYPES), -(-x.shape[0] // max(block_h, 1)))
    if x.device.type == "cpu":
        return copy_probe_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kr.load("copy_probe").copy_probe_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], _DTYPES[x.dtype], block_h,
            _stream(x))
    ck._raise_on(rc, "copy_probe")
    ck.TOOL_LAUNCHES["T4-copy"] += 1
    return out


def smem_copy(x: torch.Tensor, block_h: int) -> torch.Tensor:
    """T4's copy of a u8 plane (width a multiple of 16) staged through
    shared memory, in blocks of `block_h` rows; the stand-in for the TPU's
    lagged copy. CPU tensors take the plain version."""
    _check(x, block_h, (torch.uint8,), -(-x.shape[0] // max(block_h, 1)))
    if x.shape[1] % 16:
        raise ValueError(f"the shared-memory copy takes widths that are multiples of 16, "
                         f"got {x.shape[1]}")
    if x.device.type == "cpu":
        return copy_probe_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kr.load("copy_probe").smem_copy_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], block_h, _stream(x))
    ck._raise_on(rc, "smem_copy")
    ck.TOOL_LAUNCHES["T4-smem-copy"] += 1
    return out


def bitcast_store_plain(x: torch.Tensor) -> torch.Tensor:
    """u8 (H, W) -> int32 words (H/4, W), byte k of word (i, j) = row 4i+k,
    column j: ``pltpu.bitcast`` along the second-minor axis."""
    h, w = x.shape
    return x.reshape(h // 4, 4, w).transpose(1, 2).contiguous().view(torch.int32).view(h // 4, w)


def bitcast_load_plain(words: torch.Tensor) -> torch.Tensor:
    """int32 words (Hw, W) -> u8 (4 Hw, W), the inverse of
    bitcast_store_plain."""
    hw, w = words.shape
    return words.contiguous().view(torch.uint8).view(hw, w, 4).transpose(1, 2).reshape(4 * hw, w)


def bitcast_store(x: torch.Tensor, block_h: int) -> torch.Tensor:
    """T4's u8 -> u32 sublane bitcast in blocks of `block_h` u8 rows (H, W
    and block_h multiples of 4; the last block may be ragged). CPU tensors
    take the plain version."""
    _check(x, block_h, (torch.uint8,), -(-x.shape[0] // max(block_h, 1)))
    h, w = x.shape
    if h % 4 or w % 4 or block_h % 4:
        raise ValueError(f"the bitcast takes H, W and block_h in multiples of 4, got "
                         f"{h}, {w}, {block_h}")
    if x.device.type == "cpu":
        return bitcast_store_plain(x)
    out = torch.empty((h // 4, w), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = kr.load("copy_probe").bitcast_store_launch(
            x.data_ptr(), out.data_ptr(), h, w, block_h, _stream(x))
    ck._raise_on(rc, "bitcast_store")
    ck.TOOL_LAUNCHES["T4-bitcast-store"] += 1
    return out


def bitcast_load(words: torch.Tensor, block_h: int) -> torch.Tensor:
    """T4's u32 -> u8 sublane bitcast in blocks of `block_h` word rows (W a
    multiple of 4). CPU tensors take the plain version."""
    _check(words, block_h, (torch.int32,), -(-words.shape[0] // max(block_h, 1)))
    hw, w = words.shape
    if w % 4:
        raise ValueError(f"the bitcast takes W in multiples of 4, got {w}")
    if words.device.type == "cpu":
        return bitcast_load_plain(words)
    out = torch.empty((4 * hw, w), dtype=torch.uint8, device=words.device)
    with torch.cuda.device(words.device):
        rc = kr.load("copy_probe").bitcast_load_launch(
            words.data_ptr(), out.data_ptr(), hw, w, block_h, _stream(words))
    ck._raise_on(rc, "bitcast_load")
    ck.TOOL_LAUNCHES["T4-bitcast-load"] += 1
    return out


# --------------------------------------------------------------------------
# The probe
# --------------------------------------------------------------------------


def probe_cases(img_u8: torch.Tensor, *, quick: bool) -> tuple[list, list[dict]]:
    """(timed cases as (base, fn), untimed records) on the u8 plane
    `img_u8`, as the JAX tool registers them."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    h, w = img_u8.shape
    img_f32 = img_u8.to(torch.float32)
    img_u32 = pack_u8(img_u8)  # the same bytes, a quarter of the elements
    cases = []

    # a) PyTorch's own device copy
    for name, arr in (("torch_copy_u8", img_u8), ("torch_copy_f32", img_f32)):
        out = torch.empty_like(arr)
        cases.append(({"case": name, "_nbytes": 2 * arr.numel() * arr.element_size()},
                      lambda out=out, arr=arr: out.copy_(arr)))
    # b/c) the hand-written tiled copies
    bhs = (128,) if quick else BLOCK_HEIGHTS
    arrays = [("cuda_copy_u8", img_u8, bhs), ("cuda_copy_f32", img_f32, bhs),
              ("cuda_copy_u32_packed", img_u32, bhs),
              ("cuda_copy_u32_fullelems", img_u8.to(torch.int32), (128,)),
              ("cuda_copy_f32_packedsize", img_f32[:, : w // 4].contiguous(), (128,))]
    for name, arr, heights in arrays:
        for bh in heights:
            cases.append(({"case": name, "block_h": bh,
                           "_nbytes": 2 * arr.numel() * arr.element_size()},
                          lambda arr=arr, bh=bh: copy_probe(arr, bh)))
    # d) the copy staged through shared memory, for the lagged copy
    for bh in bhs[:2]:
        cases.append(({"case": "cuda_smem_copy_u8", "block_h": bh,
                       "stands_for": "pallas_lagged_copy_u8", "_nbytes": 2 * h * w},
                      lambda bh=bh: smem_copy(img_u8, bh)))
    # e) column packing is a view of the same bytes in PyTorch: no kernel
    untimed = [
        {"case": "torch_pack_bitcast", "free_view": True,
         "note": "pack_u8 is a view of the contiguous plane; no copy runs"},
        {"case": "torch_unpack_bitcast", "free_view": True,
         "note": "unpack_u32 is a view of the contiguous words; no copy runs"},
    ]
    assert unpack_u32(img_u32).data_ptr() == img_u8.data_ptr()
    # f) the sublane bitcast pair
    words = bitcast_store(img_u8, 128)
    cases.append(({"case": "cuda_u8load_u32store_bitcast", "block_h": 128, "_nbytes": 2 * h * w},
                  lambda: bitcast_store(img_u8, 128)))
    cases.append(({"case": "cuda_u32load_u8store_bitcast", "block_h": 128, "_nbytes": 2 * h * w},
                  lambda: bitcast_load(words, 128)))
    # g) the port's K2 on the same plane
    ops = make_pipeline_ops("gaussian:5")
    cases.append(({"case": "gaussian5_8k_cuda", "_nbytes": 2 * h * w, "_mp": h * w},
                  lambda: pipeline_cuda(ops, img_u8)))
    return cases, untimed


def run_probe(*, quick: bool, rounds: int | None, device: torch.device,
              height: int | None = None, width: int | None = None, out=emit) -> list[dict]:
    """The probe on a (height, width) plane (default (H, W), the JAX tool's
    8K): every case `rounds` times round-robin (default 3, 1 with `quick`).
    Returns the per-case bests and the untimed records."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    n_rounds = rounds if rounds else (1 if quick else 3)
    img = torch.from_numpy(
        synthetic_image(height or H, width or W, channels=1, seed=99)).to(device)
    label = card_label(device)
    cases, untimed = probe_cases(img, quick=quick)
    for rec in untimed:
        out({**rec, **label})
    return run_rounds(cases, n_rounds, device, label, out) + [{**r, **label} for r in untimed]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--rounds", type=int, default=None,
        help="measure every case this many times in round-robin order and report "
        "per-case bests. Default 3, or 1 with --quick.",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    run_probe(quick=args.quick, rounds=args.rounds, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
