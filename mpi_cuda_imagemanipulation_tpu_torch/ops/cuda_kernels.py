"""The hand-written CUDA kernels, their plain PyTorch versions, and the
pipeline runner that routes groups of ops to them.

A pipeline splits into ``[pointwise*, stencil?]`` groups (``group_ops``);
each group is one kernel launch:

* K1, ``pointwise_group`` (``csrc/pointwise.cu``): groups with no stencil.
* K2, ``stream_stencil`` (``csrc/stream_stencil.cu``): groups that end in a
  stencil; the pointwise prologue runs inside the stencil kernel.

Lookup-table ops have no kernel program and run as their own group, a
plain gather on the device.

Both kernels read and write interleaved HWC u8 images in place: (H, W) for
one channel, (H, W, 3) for three. Each wrapper takes its plain version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    PW_GRAY2RGB,
    U8,
    PointwiseOp,
    StencilOp,
)
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

# Launch geometry of K2; ST_TILE_W and ST_THREADS in stream_stencil.cu.
TILE_W = 128
THREADS = 256
DEFAULT_TILE_H = 16
# Largest dynamic shared memory one block may use on Hopper.
MAX_SMEM_BYTES = 232448
_MAX_GRID_Y = 65535

_FAMILIES = {"corr": 0, "magnitude": 1, "separable": 2, "min": 3, "max": 4, "median": 5}
_EDGE_MODES = {"interior": 0, "reflect101": 1, "edge": 2}
_QUANTIZERS = {"trunc_clip": 0, "rint_clip": 1}


# --------------------------------------------------------------------------
# Grouping
# --------------------------------------------------------------------------


def group_ops(ops) -> list[tuple[list[PointwiseOp], StencilOp | None]]:
    """Split a pipeline into ``[pointwise*, stencil?]`` groups; an op with no
    kernel program (a lookup table) becomes a group of its own."""
    groups: list[tuple[list[PointwiseOp], StencilOp | None]] = []
    pointwise: list[PointwiseOp] = []
    for op in ops:
        if isinstance(op, StencilOp):
            groups.append((pointwise, op))
            pointwise = []
        elif not op.kernel_safe:
            if pointwise:
                groups.append((pointwise, None))
                pointwise = []
            groups.append(([op], None))
        else:
            pointwise.append(op)
    if pointwise:
        groups.append((pointwise, None))
    return groups


def _channels_after(pointwise: list[PointwiseOp], n_ch: int) -> int:
    for op in pointwise:
        if op.out_channels:
            n_ch = op.out_channels
    return n_ch


def _channels(img: torch.Tensor) -> int:
    return 1 if img.ndim == 2 else img.shape[2]


# --------------------------------------------------------------------------
# Host-side encoding and geometry
# --------------------------------------------------------------------------


def pointwise_program(pointwise: list[PointwiseOp], c_in: int) -> tuple[kr.PwProgram, int]:
    """Encode a pointwise chain for the kernels' interpreter, checking that
    its channel counts chain from `c_in`. Returns (program, c_out)."""
    if c_in not in (1, 3):
        raise ValueError(f"the kernels take 1- or 3-channel images, got {c_in} channels")
    if len(pointwise) > kr.PW_MAX_OPS:
        raise ValueError(
            f"a kernel group holds at most {kr.PW_MAX_OPS} pointwise ops, got {len(pointwise)}"
        )
    prog = kr.PwProgram()
    prog.n_ops = len(pointwise)
    n = c_in
    for k, op in enumerate(pointwise):
        if op.program is None:
            raise ValueError(f"op {op.name!r} has no kernel program")
        if op.in_channels and op.in_channels != n:
            raise ValueError(f"op {op.name!r} expects {op.in_channels} channels, got {n}")
        n = op.out_channels or n
        prog.op[k], prog.p0[k], prog.p1[k] = op.program
    return prog, n


def _family(stencil: StencilOp) -> str:
    if stencil.reduce in ("min", "max", "median"):
        return stencil.reduce
    if stencil.reduce != "corr":
        raise ValueError(f"stencil {stencil.name!r}: unknown reduce {stencil.reduce!r}")
    if stencil.combine == "magnitude":
        if stencil.separable is not None or len(stencil.kernels) != 2:
            raise ValueError(f"stencil {stencil.name!r}: magnitude needs two 2-D kernels")
        return "magnitude"
    if stencil.combine != "single":
        raise ValueError(f"stencil {stencil.name!r}: unknown combine {stencil.combine!r}")
    return "corr" if stencil.separable is None else "separable"


def stencil_desc(stencil: StencilOp) -> kr.StencilDesc:
    """Encode a stencil for K2, rejecting what the kernel has no form for."""
    fam = _family(stencil)
    k = np.asarray(stencil.kernels[0]).shape
    ks = 2 * stencil.halo + 1
    if k != (ks, ks) or ks > kr.ST_MAX_K:
        raise ValueError(
            f"stencil {stencil.name!r}: kernel shape {k} with halo {stencil.halo}; "
            f"the kernel takes square windows of side 2*halo+1 <= {kr.ST_MAX_K}"
        )
    if fam == "median" and ks not in (3, 5):
        raise ValueError(f"stencil {stencil.name!r}: median networks exist for 3x3 and 5x5")
    if stencil.edge_mode not in _EDGE_MODES:
        raise ValueError(f"stencil {stencil.name!r}: edge mode {stencil.edge_mode!r}")
    if stencil.quantize not in _QUANTIZERS:
        raise ValueError(f"stencil {stencil.name!r}: quantizer {stencil.quantize!r}")
    d = kr.StencilDesc()
    d.family = _FAMILIES[fam]
    d.halo = stencil.halo
    d.ksize = ks
    d.edge_mode = _EDGE_MODES[stencil.edge_mode]
    d.quantize = _QUANTIZERS[stencil.quantize]
    d.scale = float(np.float32(stencil.scale))
    if fam in ("corr", "magnitude"):
        for dst, w in zip((d.w0, d.w1), stencil.kernels):
            w = np.asarray(w, dtype=np.float32)
            if w.shape != (ks, ks):
                raise ValueError(f"stencil {stencil.name!r}: kernel shapes differ")
            dst[: ks * ks] = [float(v) for v in w.reshape(-1)]
    if fam == "separable":
        sep = np.asarray(stencil.separable, dtype=np.float32).reshape(-1)
        if sep.shape != (ks,):
            raise ValueError(f"stencil {stencil.name!r}: separable weights of length {sep.size}")
        d.sep[:ks] = [float(v) for v in sep]
    return d


def stencil_smem_bytes(c_out: int, tile_h: int, halo: int, family: int) -> int:
    """Dynamic shared memory of one K2 block (st_smem_bytes in the source):
    the u8 window per plane, then for separable and min/max the float32
    row pass per plane."""
    eh, ew = tile_h + 2 * halo, TILE_W + 2 * halo
    nbytes = (c_out * eh * ew + 15) & ~15
    if family in (_FAMILIES["separable"], _FAMILIES["min"], _FAMILIES["max"]):
        nbytes += c_out * eh * TILE_W * 4
    return nbytes


def stencil_grid(height: int, width: int, tile_h: int) -> tuple[int, int]:
    """K2's grid: (column tiles, row tiles)."""
    return -(-width // TILE_W), -(-height // tile_h)


def _check_geometry(height, width, c_out, desc, tile_h) -> None:
    if tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    smem = stencil_smem_bytes(c_out, tile_h, desc.halo, desc.family)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"tile height {tile_h} needs {smem} B of shared memory "
            f"(at most {MAX_SMEM_BYTES})"
        )
    if stencil_grid(height, width, tile_h)[1] > _MAX_GRID_Y:
        raise ValueError(f"image height {height} needs a taller tile than {tile_h}")


def _check_cuda_input(img: torch.Tensor) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got {img.device}")
    if img.dtype != U8:
        raise TypeError(f"the kernels take uint8 images, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("the kernels take contiguous images")


def _out_like(img: torch.Tensor, c_out: int) -> torch.Tensor:
    h, w = img.shape[:2]
    shape = (h, w) if c_out == 1 else (h, w, c_out)
    return torch.empty(shape, dtype=U8, device=img.device)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# --------------------------------------------------------------------------
# K1: pointwise group
# --------------------------------------------------------------------------


def _apply_pointwise_planes(op: PointwiseOp, planes: list) -> list:
    """One pointwise op on the f32 planes of the image."""
    if op.planes_core is not None:  # channel-structure ops (3->1 or 3->3)
        out = op.planes_core(*planes)
        return list(out) if isinstance(out, (list, tuple)) else [out]
    if op.program[0] == PW_GRAY2RGB:
        return [planes[0]] * 3
    return [op.core(p) for p in planes]


def pointwise_group_plain(pointwise: list[PointwiseOp], img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: the chain's f32 cores on the planes."""
    pointwise_program(pointwise, _channels(img))
    planes = (
        [img[..., c].to(F32) for c in range(img.shape[2])] if img.ndim == 3 else [img.to(F32)]
    )
    for op in pointwise:
        planes = _apply_pointwise_planes(op, planes)
    out = [p.to(U8) for p in planes]
    return out[0] if len(out) == 1 else torch.stack(out, dim=-1)


def pointwise_group(pointwise: list[PointwiseOp], img: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: one launch applies the whole pointwise chain."""
    prog, c_out = pointwise_program(pointwise, _channels(img))
    if img.device.type == "cpu":
        return pointwise_group_plain(pointwise, img)
    _check_cuda_input(img)
    out = _out_like(img, c_out)
    lib = kr.load("pointwise")
    with torch.cuda.device(img.device):
        rc = lib.pointwise_launch(
            img.data_ptr(), out.data_ptr(), img.shape[0] * img.shape[1],
            _channels(img), c_out, ctypes.byref(prog),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "pointwise")
    pointwise_group.launches += 1
    return out


pointwise_group.launches = 0


# --------------------------------------------------------------------------
# K2: fused [pointwise*, stencil] group
# --------------------------------------------------------------------------


def stream_stencil_plain(
    pointwise: list[PointwiseOp], stencil: StencilOp, img: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K2: the pointwise chain, then the golden
    stencil (pad, valid, scale, quantize, interior passthrough)."""
    stencil_desc(stencil)
    post = pointwise_group_plain(pointwise, img) if pointwise else img
    return stencil(post)


def stream_stencil(
    pointwise: list[PointwiseOp],
    stencil: StencilOp,
    img: torch.Tensor,
    *,
    tile_h: int | None = None,
) -> torch.Tensor:
    """K2 wrapper: one launch runs the pointwise prologue and the stencil.
    `tile_h` is the output tile height (default 16 rows)."""
    prog, c_out = pointwise_program(pointwise, _channels(img))
    desc = stencil_desc(stencil)
    tile_h = tile_h or DEFAULT_TILE_H
    height, width = img.shape[:2]
    _check_geometry(height, width, c_out, desc, tile_h)
    if img.device.type == "cpu":
        return stream_stencil_plain(pointwise, stencil, img)
    _check_cuda_input(img)
    out = _out_like(img, c_out)
    lib = kr.load("stream_stencil")
    with torch.cuda.device(img.device):
        rc = lib.stream_stencil_launch(
            img.data_ptr(), out.data_ptr(), height, width, _channels(img), c_out,
            ctypes.byref(prog), ctypes.byref(desc), tile_h,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stream_stencil")
    stream_stencil.launches += 1
    return out


stream_stencil.launches = 0


def reset_launch_counts() -> None:
    pointwise_group.launches = 0
    stream_stencil.launches = 0


# --------------------------------------------------------------------------
# Group and pipeline runners
# --------------------------------------------------------------------------


def run_group(
    pointwise: list[PointwiseOp],
    stencil: StencilOp | None,
    img: torch.Tensor,
    *,
    block_h: int | None = None,
) -> torch.Tensor:
    """Run one ``[pointwise*, stencil?]`` group as one kernel launch (or, for
    a lookup-table op, a plain gather). `block_h` sets K2's tile height."""
    if stencil is None and len(pointwise) == 1 and not pointwise[0].kernel_safe:
        return pointwise[0](img)
    if stencil is None:
        return pointwise_group(pointwise, img)
    if stencil.edge_mode == "zero":
        raise NotImplementedError(
            "zero-mode stencils would need post-pointwise padding in the "
            "kernel path; none exist in the registry"
        )
    height, width = img.shape[:2]
    h = stencil.halo
    if stencil.edge_mode == "reflect101" and (height <= h or width <= h):
        raise ValueError(f"image {height}x{width} too small for halo {h}")
    return stream_stencil(pointwise, stencil, img, tile_h=block_h)


def pipeline_cuda(ops, img: torch.Tensor, *, block_h: int | None = None) -> torch.Tensor:
    """Run a pipeline group by group through the kernels. Same u8 result as
    the golden path; on a CPU tensor every group takes its plain version."""
    for pointwise, stencil in group_ops(ops):
        img = run_group(pointwise, stencil, img, block_h=block_h)
    return img
