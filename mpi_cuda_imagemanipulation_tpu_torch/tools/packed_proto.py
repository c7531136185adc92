"""T2: a pointwise chain on packed words, four u8 pixels per 32-bit element;
the counterpart of the JAX repository's ``tools/packed_proto.py``.

The prototype asks whether moving four pixels per 32-bit element buys
anything over the u8 kernels' bytes. It holds:

* ``pack_u8`` / ``unpack_u32``: (H, W) u8 <-> (H, W/4) int32, byte k of
  word j = column 4j + k (little-endian). In PyTorch both are free views of
  a contiguous plane.
* ``packed_gray_contrast``: T2, ``grayscale`` then ``contrast:3.5`` on three
  packed planes (R, G, B) into one packed plane, a hand-written CUDA kernel
  (``ops/csrc/packed_proto.cu``, the planar body of ``packed_run.cuh``:
  sixteen pixels a thread, the chain table ``t2_program`` on the card)
  beside its plain version ``packed_gray_contrast_plain`` (unpack, the
  golden ops, pack).
* the packed-lane helpers ``_lanes_i32``, ``_pack_lanes_i32``,
  ``_shift_lanes`` and ``packed_row_corr_interior`` (a separable row pass on
  packed lanes, interior columns exact), plain PyTorch, as the JAX tool's
  jnp helpers are.

``python -m mpi_cuda_imagemanipulation_tpu_torch.tools.packed_proto`` runs
the self-test, on the card (the hand kernel) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

F32 = torch.float32
I32 = torch.int32
CHAIN = "grayscale,contrast:3.5"
DEFAULT_BLOCK_H = 128


def pack_u8(img: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 -> (H, W//4) int32, byte k of word j = column 4j+k: a view
    of the contiguous plane, no copy."""
    H, W = img.shape
    if W % 4:
        raise ValueError(f"pad the width to a multiple of 4 first, got {W}")
    return img.contiguous().view(H, W // 4, 4).view(I32).view(H, W // 4)


def unpack_u32(words: torch.Tensor) -> torch.Tensor:
    """(H, Wp) int32 -> (H, 4*Wp) u8 (inverse of pack_u8), a view."""
    H, Wp = words.shape
    return words.contiguous().view(torch.uint8).view(H, 4 * Wp)


def _lanes_i32(words: torch.Tensor) -> list[torch.Tensor]:
    """Split packed words into 4 int32 byte-lane arrays (values 0..255);
    lane k holds columns 4j+k."""
    w = words.to(I32)
    return [(w >> (8 * k)) & 0xFF for k in range(4)]


def _pack_lanes_i32(lanes: list[torch.Tensor]) -> torch.Tensor:
    """Inverse of _lanes_i32: 4 int32 lane arrays (0..255) -> packed int32
    (lane 3's bit 7 lands in the sign bit, as in the i32 words)."""
    l0, l1, l2, l3 = lanes
    return l0 | (l1 << 8) | (l2 << 16) | (l3 << 24)


def _shift_lanes(lanes: list[torch.Tensor], d: int) -> list[torch.Tensor]:
    """Byte-lane view of the image shifted by d columns (|d| <= 3): lane k
    reads lane (k + d) mod 4 with a word shift where it crosses a word;
    columns past the edge replicate it (only the interior is exact)."""
    out = []
    for k in range(4):
        lane = lanes[(k + d) % 4]
        s = (k + d) // 4  # -1, 0 or +1 for |d| <= 3
        if s > 0:
            lane = torch.cat([lane[:, s:], lane[:, -1:].expand(-1, s)], dim=1)
        elif s < 0:
            lane = torch.cat([lane[:, :1].expand(-1, -s), lane[:, :s]], dim=1)
        out.append(lane)
    return out


def packed_row_corr_interior(words: torch.Tensor, w1d, *, halo: int) -> list[torch.Tensor]:
    """Separable row pass on packed lanes (interior columns exact; edges
    replicate). Returns 4 float32 lane arrays, summed in tap order."""
    lanes = _lanes_i32(words)
    acc: list[torch.Tensor | None] = [None] * 4
    for i, wgt in enumerate(np.asarray(w1d, np.float32).reshape(-1)):
        sh = _shift_lanes(lanes, i - halo)
        for k in range(4):
            term = sh[k].to(F32) * torch.tensor(wgt, dtype=F32)
            acc[k] = term if acc[k] is None else acc[k] + term
    return acc


def packed_gray_contrast_plain(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of T2: unpack the three planes, the golden
    ``grayscale`` and ``contrast:3.5``, pack the result."""
    x = torch.stack([unpack_u32(p) for p in (r, g, b)], dim=-1)
    for op in make_pipeline_ops(CHAIN):
        x = op(x)
    return pack_u8(x)


def _check_planes(r, g, b) -> tuple[int, int]:
    shape = tuple(r.shape)
    for p in (r, g, b):
        if p.ndim != 2 or tuple(p.shape) != shape or p.dtype != I32 or p.device != r.device:
            raise ValueError(
                f"T2 takes three (H, W/4) int32 planes on one device, got "
                f"{[(tuple(q.shape), q.dtype, str(q.device)) for q in (r, g, b)]}"
            )
    return shape


def packed_gray_contrast(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
                         block_h: int = DEFAULT_BLOCK_H) -> torch.Tensor:
    """T2: ``grayscale`` then ``contrast:3.5`` on three packed (H, W/4)
    int32 planes into one. `block_h` is the JAX tool's block height: it is
    checked and sets nothing (the kernel walks the planes flat). A plane may
    start at any word (a row slice of a larger one). On CPU tensors the
    plain version runs; on CUDA tensors the kernel launches or this
    raises."""
    height, wp = _check_planes(r, g, b)
    if block_h < 1:
        raise ValueError(f"block height must be >= 1, got {block_h}")
    if r.device.type == "cpu":
        return packed_gray_contrast_plain(r, g, b)
    for p in (r, g, b):
        if not p.is_contiguous():
            raise ValueError("T2 takes contiguous planes")
    chain = t2_program()
    out = torch.empty_like(r)
    dev = r.device
    rc = kr.load("packed_proto").packed_pointwise_launch(
        r.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), height, wp, chain.ptr(dev),
        chain.n_ops, dev.index, ck.stream_handle(dev),
    )
    ck._raise_on(rc, "packed_proto")
    ck.TOOL_LAUNCHES["T2"] += 1
    return out


@functools.cache
def t2_program() -> ck.PointwiseChain:
    """T2's fixed chain (grayscale, then contrast 3.5), 3 channels in and 1
    out, as the cached chain table packed_proto.cu takes."""
    chain = ck.chain_for(tuple(make_pipeline_ops(CHAIN)), 3)
    assert chain.c_out == 1
    return chain


def selftest(device: torch.device) -> None:
    """The JAX tool's self-test, on `device` (T2 itself on a card): pack and
    lane round trips; T2 at 64x256 with block_h=24 (a ragged last block)
    against the golden ops; the packed gaussian:5 row pass against a
    direct correlation on the interior columns. Raises on a mismatch."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    rgb = torch.from_numpy(synthetic_image(64, 256, channels=3, seed=3)).to(device)
    r8, g8, b8 = (rgb[..., c].contiguous() for c in range(3))
    packed = pack_u8(r8)
    assert torch.equal(unpack_u32(packed), r8), "pack/unpack round trip"
    assert torch.equal(_pack_lanes_i32(_lanes_i32(packed)), packed), "lane round trip"
    golden = rgb
    for op in make_pipeline_ops(CHAIN):
        golden = op(golden)
    got = unpack_u32(packed_gray_contrast(pack_u8(r8), pack_u8(g8), pack_u8(b8), block_h=24))
    if not torch.equal(got, golden):
        err = (got.int() - golden.int()).abs().max().item()
        raise AssertionError(f"packed gray+contrast mismatch: max abs err {err}")
    w1d = np.asarray(make_op("gaussian:5").separable, np.float32).reshape(-1)
    lanes = packed_row_corr_interior(packed, w1d, halo=2)
    acc = torch.zeros((64, 256), dtype=F32, device=device)
    for k in range(4):
        acc[:, k::4] = lanes[k]
    x = r8.to(F32)
    ref = torch.zeros_like(x)
    for i, wgt in enumerate(w1d):
        idx = torch.clamp(torch.arange(256, device=device) + i - 2, 0, 255)
        ref = ref + x[:, idx] * torch.tensor(wgt, dtype=F32)
    assert torch.allclose(acc[:, 4:-4], ref[:, 4:-4]), "row-pass mismatch"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    selftest(device)
    print(f"packed_proto selftest on {device}: all ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
