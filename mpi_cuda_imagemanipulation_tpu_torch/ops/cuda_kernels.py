"""The hand-written CUDA kernels, their plain PyTorch versions, and the
pipeline runner that routes groups of ops to them.

A pipeline splits into ``[pointwise*, stencil?]`` groups (``group_ops``);
each group is one kernel launch:

* K1, ``pointwise_group`` (``csrc/pointwise.cu``): groups with no stencil.
* K2, ``stream_stencil`` (``csrc/stream_stencil.cu``): groups that end in a
  stencil; the pointwise prologue runs inside the stencil kernel.

Lookup-table ops have no kernel program and run as their own group, a
plain gather on the device.

A fused plan stage (``plan='fused-pallas'``, plan/cuda_exec.py) runs as
one launch of K4, ``fused_stage`` (``csrc/fused_stage.cu``): pointwise
runs and several chained stencils, with no intermediate in device memory.

The row-sharded runner (parallel/api.py) launches the ghost modes of the
same sources on each shard's tile:

* K2g, ``stream_stencil_ghost``: K2's group over one row-shard, its rows
  above and below the tile read from two raw ghost strips, the interior
  passthrough at global rows.
* K3, ``stencil_tile``: one stencil over a tile the caller already
  extended with ghost rows; no pointwise chain and no passthrough.
* K4g, ``fused_stage_ext``: K4's stage over a tile extended by the stage's
  one ghost exchange, edges rewritten per op where the tile touches the
  image's first or last row.

K5 is an arm of K4 and K4g, not a kernel of its own: a stencil of a stage
given a tensor-core in-stage arm (``arms``, or ``mxu_stage`` resolved by
ops/mxu_kernels.stage_arm_for) contracts as ``mma.sync`` products inside
the launch (``csrc/mma_stage.cuh``), in bf16 ('mxu') or int8 ('mxu-int8').
A stage with such an arm launches the kernel's tensor-core instantiation;
the others launch the VPU instantiation, whose code is that of K4 alone.
``launch_counts`` counts, besides each wrapper's launches, the K4/K4g
launches that ran each form ('K5-bf16', 'K5-int8'), and the launches of
the SWAR kernels K6-K8 by kernel and mode (``SWAR_LAUNCHES``, counted by
ops/swar_kernels.swar_stencil).

The kernels read and write interleaved HWC u8 images in place: (H, W) for
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
    QUANTIZERS_F32,
    U8,
    PointwiseOp,
    StencilOp,
    chain_halo,
    pad2d,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    check_stage_arm,
    stage_arms,
    stage_sums_mxu_plain,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for, run_stage_full
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Stage
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

# Launch geometry of K2; ST_TILE_W and ST_THREADS in stream_stencil.cu.
TILE_W = 128
THREADS = 256
DEFAULT_TILE_H = 16
# Largest dynamic shared memory one block may use on Hopper.
MAX_SMEM_BYTES = 232448
_MAX_GRID_Y = 65535

_FAMILIES = {"corr": 0, "magnitude": 1, "separable": 2, "min": 3, "max": 4, "median": 5}
_EDGE_MODES = {"interior": 0, "reflect101": 1, "edge": 2, "zero": 3}
_QUANTIZERS = {"trunc_clip": 0, "rint_clip": 1}
# in-stage arms as FsProgram.arm codes (FS_ARM_* in fused_stage.cu), and
# the launch-count key of each tensor-core form
_ARM_CODES = {"vpu": 0, "mxu": 1, "mxu-int8": 2}
_K5_FORMS = {"mxu": "K5-bf16", "mxu-int8": "K5-int8"}


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


def _out_like(img: torch.Tensor, c_out: int, height: int | None = None) -> torch.Tensor:
    h, w = img.shape[:2]
    h = h if height is None else height
    shape = (h, w) if c_out == 1 else (h, w, c_out)
    return torch.empty(shape, dtype=U8, device=img.device)


def _per_plane(fn, img: torch.Tensor) -> torch.Tensor:
    """`fn` on each channel plane of an (H, W) or (H, W, C) image."""
    if img.ndim == 3:
        return torch.stack([fn(img[..., c]) for c in range(img.shape[2])], dim=-1)
    return fn(img)


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
    if stencil.edge_mode == "zero":
        raise NotImplementedError(
            "zero-mode stencils would need post-pointwise padding in K2; "
            "none exist in the registry"
        )
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


# --------------------------------------------------------------------------
# K2g: the fused group over one row-shard, with ghost strips
# --------------------------------------------------------------------------


def ghost_row_source(t: int, local_h: int, halo: int) -> tuple[str, int]:
    """Where K2g's window load reads row `t` of the tile from
    (stream_stencil.cu): ('top', row) of the top strip above the tile,
    ('bottom', row) of the bottom strip below it (rows past the strip, which
    only outputs below the tile read, clamp to its last row), else ('tile',
    row)."""
    if halo > 0 and t < 0:
        return "top", halo + t
    if halo > 0 and t >= local_h:
        return "bottom", min(t - local_h, halo - 1)
    return "tile", min(t, local_h - 1)


def _check_ghost_args(stencil, tile, top, bottom, image_w) -> None:
    """The gates of K2g's caller (parallel/api.py keeps the same ones): a
    real halo, no zero mode, more tile rows than the halo, full-width tiles
    and (halo, W[, C]) strips beside the tile."""
    h = stencil.halo
    if h < 1:
        raise ValueError(f"stencil {stencil.name!r} has halo 0: no ghost strips to read")
    if stencil.edge_mode == "zero":
        raise NotImplementedError(
            "zero-mode stencils would need post-pointwise padding in K2g; "
            "none exist in the registry"
        )
    if tile.shape[0] <= h:
        raise ValueError(f"tile of {tile.shape[0]} rows too small for halo {h}")
    if tile.shape[1] != image_w:
        raise ValueError(f"row-shards are full width: tile {tile.shape[1]}, image {image_w}")
    want = (h,) + tuple(tile.shape[1:])
    for name, strip in (("top", top), ("bottom", bottom)):
        if tuple(strip.shape) != want or strip.dtype != tile.dtype or strip.device != tile.device:
            raise ValueError(
                f"{name} strip {tuple(strip.shape)} {strip.dtype} on {strip.device}; "
                f"the tile needs {want} {tile.dtype} on {tile.device}"
            )


def stream_stencil_ghost_plain(
    pointwise: list[PointwiseOp],
    stencil: StencilOp,
    tile: torch.Tensor,
    top: torch.Tensor,
    bottom: torch.Tensor,
    *,
    y0: int,
    image_h: int,
    image_w: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2g: the pointwise chain on the
    strip-extended tile, then the golden stencil over it (columns padded per
    the op's mode, valid rows, finalize at global row `y0`)."""
    stencil_desc(stencil)
    _check_ghost_args(stencil, tile, top, bottom, image_w)
    ext = torch.cat([top, tile, bottom], dim=0)
    post = pointwise_group_plain(pointwise, ext) if pointwise else ext
    h = stencil.halo

    def plane(x: torch.Tensor) -> torch.Tensor:
        xpad = pad2d(x.to(F32), stencil.edge_mode, 0, 0, h, h)
        return stencil.finalize(
            stencil.valid(xpad), x[h : x.shape[0] - h], y0, 0, image_h, image_w
        )

    return _per_plane(plane, post)


def stream_stencil_ghost(
    pointwise: list[PointwiseOp],
    stencil: StencilOp,
    tile: torch.Tensor,
    top: torch.Tensor,
    bottom: torch.Tensor,
    *,
    y0: int,
    image_h: int,
    image_w: int,
    tile_h: int | None = None,
) -> torch.Tensor:
    """K2g wrapper: one launch runs the pointwise prologue and the stencil
    over the row-shard `tile`, whose first row is global row `y0` of an
    (image_h, image_w) image. `top` and `bottom` are its raw, pre-pointwise
    (halo, W[, C]) ghost strips: the neighbours' rows, or on the first and
    last shard the edge extension the caller made of them
    (parallel.api._fix_edge_strips)."""
    prog, c_out = pointwise_program(pointwise, _channels(tile))
    desc = stencil_desc(stencil)
    _check_ghost_args(stencil, tile, top, bottom, image_w)
    tile_h = tile_h or DEFAULT_TILE_H
    local_h, width = tile.shape[:2]
    _check_geometry(local_h, width, c_out, desc, tile_h)
    if tile.device.type == "cpu":
        return stream_stencil_ghost_plain(
            pointwise, stencil, tile, top, bottom, y0=y0, image_h=image_h, image_w=image_w
        )
    for t in (tile, top, bottom):
        _check_cuda_input(t)
    out = _out_like(tile, c_out)
    lib = kr.load("stream_stencil")
    with torch.cuda.device(tile.device):
        rc = lib.stream_stencil_ghost_launch(
            tile.data_ptr(), top.data_ptr(), bottom.data_ptr(), out.data_ptr(),
            local_h, width, _channels(tile), c_out, ctypes.byref(prog), ctypes.byref(desc),
            tile_h, y0, image_h, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stream_stencil_ghost")
    stream_stencil_ghost.launches += 1
    return out


stream_stencil_ghost.launches = 0


# --------------------------------------------------------------------------
# K3: one stencil over a pre-extended shard tile
# --------------------------------------------------------------------------


def stencil_tile_plain(stencil: StencilOp, ext: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: columns padded per the op's mode, the
    golden valid stencil over the rows given, the quantizer; no interior
    passthrough."""
    stencil_desc(stencil)
    h = stencil.halo

    def plane(x: torch.Tensor) -> torch.Tensor:
        xpad = pad2d(x.to(F32), stencil.edge_mode, 0, 0, h, h)
        return QUANTIZERS_F32[stencil.quantize](stencil.valid(xpad)).to(U8)

    return _per_plane(plane, ext)


def stencil_tile(
    stencil: StencilOp, ext: torch.Tensor, *, tile_h: int | None = None
) -> torch.Tensor:
    """K3 wrapper: one launch runs `stencil` (valid rows, quantized) over
    `ext`, a (local_h + 2 halo, W[, C]) tile whose ghost rows the caller
    already made, all channels at once. Columns are extended per the op's
    mode inside. The interior passthrough is the caller's
    (parallel.api._stencil_on_ext). Returns (local_h, W[, C])."""
    desc = stencil_desc(stencil)
    h = stencil.halo
    local_h, width = ext.shape[0] - 2 * h, ext.shape[1]
    if local_h < 1:
        raise ValueError(f"extended tile of {ext.shape[0]} rows holds no row for halo {h}")
    if stencil.edge_mode == "reflect101" and width <= h:
        raise ValueError(f"tile width {width} too small for halo {h}")
    tile_h = tile_h or DEFAULT_TILE_H
    c = _channels(ext)
    _check_geometry(local_h, width, c, desc, tile_h)
    if ext.device.type == "cpu":
        return stencil_tile_plain(stencil, ext)
    _check_cuda_input(ext)
    out = _out_like(ext, c, local_h)
    lib = kr.load("stream_stencil")
    with torch.cuda.device(ext.device):
        rc = lib.stencil_tile_launch(
            ext.data_ptr(), out.data_ptr(), local_h, width, c, ctypes.byref(desc),
            tile_h, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil_tile")
    stencil_tile.launches += 1
    return out


stencil_tile.launches = 0


# --------------------------------------------------------------------------
# K4: one fused plan stage
# --------------------------------------------------------------------------

FS_DEFAULT_TILE_H = 16
# Largest stage halo K4 takes: beyond it the window's context rows would be
# most of the block's read (the same limit as the TPU megakernel's)
STAGE_MAX_HALO = 16


def _stage_channels(ops, c_in: int) -> tuple[int, int, bool]:
    """Walk a stage's channel counts from `c_in`, checking that they chain.
    Returns (c_out, c_smem, two_pass): `c_smem` is the most channels the
    stage holds in K4's shared memory (its channel count at each stencil),
    `two_pass` whether any stencil needs the float32 row pass."""
    if c_in not in (1, 3):
        raise ValueError(f"the kernels take 1- or 3-channel images, got {c_in} channels")
    n, c_smem, two_pass = c_in, 0, False
    for op in ops:
        if op.in_channels and op.in_channels != n:
            raise ValueError(f"op {op.name!r} expects {op.in_channels} channels, got {n}")
        if isinstance(op, StencilOp):
            c_smem = max(c_smem, n)
            two_pass = two_pass or _family(op) in ("separable", "min", "max")
        else:
            n = op.out_channels or n
    return n, c_smem, two_pass


def fused_stage_program(ops, c_in: int, arms=None) -> tuple[kr.FsProgram, int, int, bool]:
    """Encode a fused stage for K4, each stencil with its in-stage arm from
    `arms` (one per op, default all 'vpu'; a tensor-core arm must be proven
    for its op). A separable stencil on a tensor-core arm carries its 2-D
    kernel too, which K5 contracts. Returns (program, c_out, c_smem,
    two_pass), the last three as `_stage_channels` gives them."""
    arms = tuple(arms) if arms is not None else ("vpu",) * len(ops)
    if len(arms) != len(ops):
        raise ValueError(f"{len(arms)} arms for a stage of {len(ops)} ops")
    c_out, c_smem, two_pass = _stage_channels(ops, c_in)
    stencils = [op for op in ops if isinstance(op, StencilOp)]
    if len(ops) > kr.FS_MAX_OPS or len(stencils) > kr.FS_MAX_STENCILS:
        raise ValueError(
            f"K4 takes at most {kr.FS_MAX_OPS} ops and {kr.FS_MAX_STENCILS} "
            f"stencils per stage, got {len(ops)} and {len(stencils)}"
        )
    prog = kr.FsProgram()
    prog.n_ops = len(ops)
    prog.n_stencils = len(stencils)
    j = 0
    for k, (op, arm) in enumerate(zip(ops, arms)):
        check_stage_arm(op, arm)
        if isinstance(op, StencilOp):
            prog.st[j] = stencil_desc(op)
            if arm != "vpu" and op.separable is not None:
                ks = 2 * op.halo + 1
                prog.st[j].w0[: ks * ks] = [
                    float(v) for v in np.asarray(op.kernels[0], np.float32).reshape(-1)
                ]
            prog.arm[j] = _ARM_CODES[arm]
            prog.op[k] = kr.FS_OP_STENCIL + j
            j += 1
            continue
        if op.program is None:
            raise ValueError(f"op {op.name!r} has no kernel program")
        opcode, p0, p1 = op.program
        if p1 != 0.0:
            raise ValueError(f"op {op.name!r}: K4 carries one parameter per op")
        prog.op[k], prog.p0[k] = opcode, p0
    return prog, c_out, c_smem, two_pass


def fused_stage_smem_bytes(c_smem: int, tile_h: int, halo: int, two_pass: bool) -> int:
    """Dynamic shared memory of one K4 block (fs_smem_bytes in the source):
    two u8 buffers of `c_smem` planes of the (tile_h + 2 halo) x
    (128 + 2 halo) window, then one float32 window for the row pass of
    separable and min/max stencils."""
    plane = (tile_h + 2 * halo) * (TILE_W + 2 * halo)
    nbytes = 2 * ((c_smem * plane + 15) & ~15)
    if two_pass:
        nbytes += plane * 4
    return nbytes


def edge_src(c: int, n: int, mode: str) -> int | None:
    """The in-image index position `c` of an axis of length `n` takes its
    value from in K4's per-op edge fix (st_src in the source), as the
    golden ``pad2d`` extends: reflect101 mirrors without repeating the
    edge, edge clamps; None where 'interior' and 'zero' write 0."""
    if 0 <= c < n:
        return c
    if mode == "reflect101":
        c = -c if c < 0 else 2 * (n - 1) - c
        return min(max(c, 0), n - 1)
    if mode == "edge":
        return min(max(c, 0), n - 1)
    return None


def fused_stage_reject(ops, height: int, width: int, channels: int,
                       tile_h: int | None = None) -> str | None:
    """Why K4 cannot run this stage on a (height, width, channels) image,
    or None when it can: 'lut-op', 'no-f32-core', 'halo-too-large',
    'image-too-small' (the edge fix needs height > 2 * halo and width
    greater than the largest op halo), 'program-too-long' (more ops or
    stencils than the kernel's parameter holds) or 'smem-budget' (the tile
    needs more shared memory than a block has)."""
    for op in ops:
        if isinstance(op, StencilOp):
            continue
        if not op.kernel_safe:
            return "lut-op"
        if op.core is None and op.planes_core is None and op.name != "gray2rgb":
            return "no-f32-core"
    halo = chain_halo(ops)
    if halo > STAGE_MAX_HALO:
        return "halo-too-large"
    max_op_halo = max((op.halo for op in ops), default=0)
    if (halo and height <= 2 * halo) or (max_op_halo and width <= max_op_halo):
        return "image-too-small"
    n_stencils = sum(isinstance(op, StencilOp) for op in ops)
    if len(ops) > kr.FS_MAX_OPS or n_stencils > kr.FS_MAX_STENCILS:
        return "program-too-long"
    _, c_smem, two_pass = _stage_channels(ops, channels)
    if fused_stage_smem_bytes(c_smem, tile_h or FS_DEFAULT_TILE_H, halo, two_pass) > MAX_SMEM_BYTES:
        return "smem-budget"
    return None


def _resolve_arms(ops, mxu_stage, arms) -> tuple[str, ...]:
    """The stage's in-stage arms: `arms` as given, else resolved from the
    `mxu_stage` setting now (ops/mxu_kernels.stage_arm_for counts them)."""
    if arms is not None:
        return tuple(arms)
    return stage_arms(ops, mxu_stage)


def _count_k5(arms) -> None:
    for form in {_K5_FORMS[a] for a in arms if a != "vpu"}:
        K5_LAUNCHES[form] += 1


def fused_stage_plain(
    ops, img: torch.Tensor, *, mxu_stage: str | None = None, arms=None
) -> torch.Tensor:
    """Plain PyTorch version of K4: the stage walker (plan/exec.py) over the
    whole image, which is the golden per-op chain, each stencil on a
    tensor-core arm running K5's plain version (ops/mxu_kernels
    .stage_valid_mxu_plain). Arms as `fused_stage` takes them."""
    ops = tuple(ops)
    arms = _resolve_arms(ops, mxu_stage, arms)
    _stage_channels(ops, _channels(img))
    return run_stage_full(
        Stage("fused", ops, chain_halo(ops)), img, acc_fns_for(ops, "torch", arms)
    )


def fused_stage(
    ops,
    img: torch.Tensor,
    *,
    tile_h: int | None = None,
    mxu_stage: str | None = None,
    arms=None,
) -> torch.Tensor:
    """K4 wrapper: one launch runs a whole fused plan stage. `tile_h` is the
    output tile height (default 16 rows). Each stencil's in-stage arm is
    `arms[k]` (one per op) when given, else resolved from the `mxu_stage`
    setting once per call (ops/mxu_kernels.MXU_STAGE_SETTINGS; None is
    'auto', the VPU arm); a stencil on a tensor-core arm runs K5. Raises for
    a stage that `fused_stage_reject` rejects."""
    ops = tuple(ops)
    arms = _resolve_arms(ops, mxu_stage, arms)
    c_in = _channels(img)
    height, width = img.shape[:2]
    tile_h = tile_h or FS_DEFAULT_TILE_H
    if tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    reason = fused_stage_reject(ops, height, width, c_in, tile_h)
    if reason is not None:
        raise ValueError(f"K4 cannot run stage {[op.name for op in ops]}: {reason}")
    if stencil_grid(height, width, tile_h)[1] > _MAX_GRID_Y:
        raise ValueError(f"image height {height} needs a taller tile than {tile_h}")
    prog, c_out, c_smem, _ = fused_stage_program(ops, c_in, arms)
    if img.device.type == "cpu":
        return fused_stage_plain(ops, img, arms=arms)
    _check_cuda_input(img)
    out = _out_like(img, c_out)
    lib = kr.load("fused_stage")
    with torch.cuda.device(img.device):
        rc = lib.fused_stage_launch(
            img.data_ptr(), out.data_ptr(), height, width, c_in, c_smem, c_out,
            chain_halo(ops), tile_h, ctypes.byref(prog),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "fused_stage")
    fused_stage.launches += 1
    _count_k5(arms)
    return out


fused_stage.launches = 0


# --------------------------------------------------------------------------
# K4g: one fused plan stage over an extended shard tile
# --------------------------------------------------------------------------


def fused_stage_ext_plain(
    ops,
    ext: torch.Tensor,
    *,
    y0: int,
    image_h: int,
    image_w: int,
    mxu_stage: str | None = None,
    arms=None,
) -> torch.Tensor:
    """Plain PyTorch version of K4g: the stage walker under the sharded
    convention (plan/exec.walk_stage with the per-op edge fix of
    parallel/api.py) over the extended tile, each stencil on a tensor-core
    arm running K5's plain version. Arms as `fused_stage` takes them."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import _plan_walk

    ops = tuple(ops)
    arms = _resolve_arms(ops, mxu_stage, arms)
    _stage_channels(ops, _channels(ext))
    halo = chain_halo(ops)
    return _plan_walk(
        Stage("fused", ops, halo), ext, y0 - halo, image_h, image_w,
        acc_fns_for(ops, "torch", arms),
    )


def fused_stage_ext(
    ops,
    ext: torch.Tensor,
    *,
    y0: int,
    image_h: int,
    image_w: int,
    tile_h: int | None = None,
    mxu_stage: str | None = None,
    arms=None,
) -> torch.Tensor:
    """K4g wrapper: one launch runs a whole fused plan stage over `ext`, the
    (local_h + 2 halo, W[, C]) tile of the row-shard that starts at global
    row `y0` of an (image_h, image_w) image, extended by the stage's one
    ghost exchange (halo = chain_halo(ops)). Rows of `ext` outside the image
    may hold anything: each stencil's edge mode rewrites them in the kernel.
    Returns the shard's (local_h, W[, C']) rows. In-stage arms as
    `fused_stage` takes them. Raises for a stage that `fused_stage_reject`
    rejects at height local_h."""
    ops = tuple(ops)
    arms = _resolve_arms(ops, mxu_stage, arms)
    c_in = _channels(ext)
    halo = chain_halo(ops)
    local_h, width = ext.shape[0] - 2 * halo, ext.shape[1]
    tile_h = tile_h or FS_DEFAULT_TILE_H
    if tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    if local_h < 1:
        raise ValueError(f"extended tile of {ext.shape[0]} rows holds no row for halo {halo}")
    if width != image_w:
        raise ValueError(f"row-shards are full width: tile {width}, image {image_w}")
    if not 0 <= y0 <= image_h - local_h:
        raise ValueError(f"shard rows [{y0}, {y0 + local_h}) lie outside an image of {image_h}")
    reason = fused_stage_reject(ops, local_h, width, c_in, tile_h)
    if reason is not None:
        raise ValueError(f"K4g cannot run stage {[op.name for op in ops]}: {reason}")
    if stencil_grid(local_h, width, tile_h)[1] > _MAX_GRID_Y:
        raise ValueError(f"tile height {local_h} needs a taller tile than {tile_h}")
    prog, c_out, c_smem, _ = fused_stage_program(ops, c_in, arms)
    if ext.device.type == "cpu":
        return fused_stage_ext_plain(
            ops, ext, y0=y0, image_h=image_h, image_w=image_w, arms=arms
        )
    _check_cuda_input(ext)
    out = _out_like(ext, c_out, local_h)
    lib = kr.load("fused_stage")
    with torch.cuda.device(ext.device):
        rc = lib.fused_stage_ext_launch(
            ext.data_ptr(), out.data_ptr(), local_h, width, c_in, c_smem, c_out,
            halo, tile_h, ctypes.byref(prog), y0, image_h,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "fused_stage_ext")
    fused_stage_ext.launches += 1
    _count_k5(arms)
    return out


fused_stage_ext.launches = 0


def k5_sums(op: StencilOp, plane: torch.Tensor, arm: str, kernel: int = 0) -> torch.Tensor:
    """K5's exactness probe: the raw f32 sums K5 forms for `op`'s kernel
    number `kernel` over a (rows, cols) u8 plane, valid mode, (rows - 2h,
    cols - 2h), through the same tile functions, before any combine, scale
    or rounding to u8. Not a path's kernel: no launch is counted."""
    check_stage_arm(op, arm)
    if plane.ndim != 2 or plane.dtype != U8:
        raise ValueError(f"expected a 2-D uint8 plane, got {tuple(plane.shape)} {plane.dtype}")
    if kernel >= len(op.kernels):
        raise ValueError(f"op {op.name!r} has {len(op.kernels)} kernel(s), not {kernel + 1}")
    if plane.device.type == "cpu":
        return stage_sums_mxu_plain(op, plane, arm=arm, kernel=kernel)
    _check_cuda_input(plane)
    h = op.halo
    rows, cols = plane.shape
    out = torch.empty((rows - 2 * h, cols - 2 * h), dtype=torch.float32, device=plane.device)
    desc = fused_stage_program([op], 1, (arm,))[0].st[0]
    lib = kr.load("fused_stage")
    with torch.cuda.device(plane.device):
        rc = lib.k5_sums_launch(
            plane.data_ptr(), out.data_ptr(), rows, cols, ctypes.byref(desc), kernel,
            _ARM_CODES[arm], torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "k5_sums")
    return out


KERNEL_WRAPPERS = {
    "K1": pointwise_group,
    "K2": stream_stencil,
    "K2g": stream_stencil_ghost,
    "K3": stencil_tile,
    "K4": fused_stage,
    "K4g": fused_stage_ext,
}


# K4 and K4g launches that ran K5 in each form (one per launch, however
# many of its stencils took the form)
K5_LAUNCHES = {"K5-bf16": 0, "K5-int8": 0}
# launches of the SWAR kernels by kernel and mode, full and ghost
# (ops/swar_kernels.swar_stencil counts them)
SWAR_LAUNCHES = dict.fromkeys(
    ("K6-narrow", "K6-wide", "K7", "K8", "K6g-narrow", "K6g-wide", "K7g", "K8g"), 0
)
# launches of the tools' kernels (the tools/ subpackage counts them): T4's
# four copies (tools/roofline_probe.py), T2 (packed_proto.py), T3
# (swar_proto.py)
TOOL_LAUNCHES = dict.fromkeys(
    ("T4-copy", "T4-smem-copy", "T4-bitcast-store", "T4-bitcast-load", "T2", "T3"), 0
)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, of each K5 form, of
    each SWAR kernel and mode, and of each tools kernel."""
    return {
        **{k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}, **K5_LAUNCHES, **SWAR_LAUNCHES,
        **TOOL_LAUNCHES,
    }


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for counts in (K5_LAUNCHES, SWAR_LAUNCHES, TOOL_LAUNCHES):
        for key in counts:
            counts[key] = 0


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
