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

``pipeline_auto`` (``backend='auto'``) routes each group as the JAX
package's ``pipeline_auto`` does: to the whole-op banded products where
ops/mxu_kernels.use_mxu_for_stencil says so (a calibration record or
``MCIM_PREFER_MXU``, on a card), else to the SWAR kernels under
``MCIM_PREFER_SWAR``, else to K1/K2. With no record and no switch that
is exactly what ``pipeline_cuda`` launches. A ``block_h`` record for
``'cuda'`` (utils/calibration.py) is K2's tile height where the caller
gives none, the launch reads as many channels as the record's sweep did,
and the record fits the launch (``stencil_launch_shape``).

The kernels read and write interleaved HWC u8 images in place: (H, W) for
one channel, (H, W, 3) for three. The wrappers and runners are written for
a contiguous (N, H, W[, C]) stack (``takes_stack``): one image runs as a
stack of one, a stack (``Pipeline.batched``) is passed with
``batched=True``. K1 takes the stack as one flat run of pixels, and K2,
K4/K5 and the SWAR kernels K6-K8 take it on their batch axis, grid z
(``batch_geometry``), so each group is one launch per stack and counts
once; an op with no kernel program runs per image (``per_image``), as do
the plain versions. Each wrapper takes its plain version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from functools import partial

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    PW_GRAY2RGB,
    PW_POSTERIZE,
    QUANTIZERS_F32,
    U8,
    PointwiseOp,
    StencilOp,
    chain_halo,
    one_image,
    pad2d,
    per_image,
    takes_stack,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    check_stage_arm,
    mxu_col_variant,
    mxu_stencil,
    stage_arms,
    stage_sums_mxu_plain,
    use_mxu_for_stencil,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for, run_stage_full
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Stage
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration, platform

# Launch geometry of K2, K2g and K3 (stream_stencil.cu): ST_THREADS threads
# a block, a tile of tile_h rows (16 by default, or the launch's height if
# lower) by one of ST_TILE_WIDTHS columns (ST_MAX_TILE_W down to
# ST_MIN_TILE_W), narrowed until the grid has N_SMS blocks where the image
# allows. K4 (fused_stage.cu) takes the same widths (FS_TILE_WIDTHS).
TILE_W = 128
ST_TILE_WIDTHS = (128, 64, 32)
THREADS = 256
DEFAULT_TILE_H = 16
N_SMS = 132  # streaming multiprocessors of an H100 SXM
# Largest dynamic shared memory one block may use on Hopper.
MAX_SMEM_BYTES = 232448
_MAX_GRID_Y = 65535

_FAMILIES = {"corr": 0, "magnitude": 1, "separable": 2, "min": 3, "max": 4, "median": 5}
_EDGE_MODES = {"interior": 0, "reflect101": 1, "edge": 2, "zero": 3}
_QUANTIZERS = {"trunc_clip": 0, "rint_clip": 1}
# in-stage arms as the stage table's arm codes (FS_ARM_* in mma_stage.cuh), and
# the launch-count key of each tensor-core form
_ARM_CODES = {"vpu": 0, "mxu": 1, "mxu-int8": 2}
_K5_FORMS = {"mxu": "K5-bf16", "mxu-int8": "K5-int8"}


# --------------------------------------------------------------------------
# Grouping
# --------------------------------------------------------------------------


def group_ops(ops) -> list[tuple[list[PointwiseOp], StencilOp | None]]:
    """Split a pipeline into ``[pointwise*, stencil?]`` groups; an op with no
    kernel program (a lookup table, a geometric or a global-statistics op:
    ``kernel_safe`` False) becomes a group of its own."""
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


def _stack_channels(stack: torch.Tensor) -> int:
    """Channels of each image of an (N, H, W[, C]) stack."""
    return 1 if stack.ndim == 3 else stack.shape[3]


# --------------------------------------------------------------------------
# Host-side encoding and geometry
# --------------------------------------------------------------------------


def kernel_program(op: PointwiseOp) -> tuple[int, float, float]:
    """`op`'s (opcode, p0, p1) as the kernels' interpreter takes them. Its
    posterize multiplies by the step's reciprocal, exact only for a step
    that is a power of two."""
    if op.program is None:
        raise ValueError(f"op {op.name!r} has no kernel program")
    opcode, p0, p1 = op.program
    if opcode == PW_POSTERIZE:
        mantissa, _ = np.frexp(np.float32(p0))
        if p0 < 1.0 or mantissa != 0.5:
            raise ValueError(f"op {op.name!r}: posterize step {p0} is not a power of two")
    return opcode, p0, p1


def pointwise_program(pointwise: list[PointwiseOp], c_in: int) -> tuple[np.ndarray, int]:
    """Encode a pointwise chain of any length for the kernels' interpreter,
    checking that its channel counts chain from `c_in`. Returns (table,
    c_out): an (n_ops, 4) int32 table, one ``PwOp`` (pointwise.cuh) a row,
    the opcode, then p0 and p1 as float32 bits, then 0."""
    if c_in not in (1, 3):
        raise ValueError(f"the kernels take 1- or 3-channel images, got {c_in} channels")
    table = np.zeros((len(pointwise), 4), dtype=np.int32)
    n = c_in
    for k, op in enumerate(pointwise):
        opcode, p0, p1 = kernel_program(op)
        if op.in_channels and op.in_channels != n:
            raise ValueError(f"op {op.name!r} expects {op.in_channels} channels, got {n}")
        n = op.out_channels or n
        table[k, 0] = opcode
        table[k, 1:3] = np.asarray([p0, p1], dtype=np.float32).view(np.int32)
    return table, n


# the kernels' tables on each card, by content: copied once per table
_DEVICE_TABLES: dict[tuple[bytes, str], torch.Tensor] = {}


def device_table(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The int32 `table` on `device`, copied there at its first use. The
    copy completes before this returns, so a launch on any stream reads
    it."""
    key = (table.tobytes(), str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(table)).to(device)
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        _DEVICE_TABLES[key] = t
    return t


class PointwiseChain:
    """One chain as the kernels take it, built once (``chain_for``): its
    ops, table and output channels, and the table's address on each card."""

    def __init__(self, ops: tuple, c_in: int):
        self.ops = ops  # held, so that the ids in the cache's key stay theirs
        self.table, self.c_out = pointwise_program(list(ops), c_in)
        self.n_ops = len(ops)
        self._ptrs: dict[torch.device, int] = {}

    def ptr(self, device: torch.device) -> int | None:
        """The table's address on `device` (None for an empty chain)."""
        if not self.n_ops:
            return None
        p = self._ptrs.get(device)
        if p is None:
            p = self._ptrs[device] = device_table(self.table, device).data_ptr()
        return p


# chains and stencil descriptors by the identity of their ops (frozen
# dataclasses, held by the entries), so that a launch builds neither
_CHAINS: dict[tuple, PointwiseChain] = {}
_DESCS: dict[int, tuple[StencilOp, kr.StencilDesc]] = {}
_CACHE_LIMIT = 4096


def chain_for(pointwise, c_in: int) -> PointwiseChain:
    """The encoded chain of `pointwise` from `c_in` channels, cached."""
    key = (c_in, *map(id, pointwise))
    chain = _CHAINS.get(key)
    if chain is None:
        chain = PointwiseChain(tuple(pointwise), c_in)
        if len(_CHAINS) >= _CACHE_LIMIT:
            _CHAINS.clear()
        _CHAINS[key] = chain
    return chain


def desc_for(stencil: StencilOp) -> kr.StencilDesc:
    """`stencil_desc(stencil)`, cached on the op's identity."""
    hit = _DESCS.get(id(stencil))
    if hit is not None and hit[0] is stencil:
        return hit[1]
    desc = stencil_desc(stencil)
    if len(_DESCS) >= _CACHE_LIMIT:
        _DESCS.clear()
    _DESCS[id(stencil)] = (stencil, desc)
    return desc


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


# families with a float32 row pass (st_two_pass in the source)
_TWO_PASS = (_FAMILIES["separable"], _FAMILIES["min"], _FAMILIES["max"])


def stencil_smem_bytes(c_in: int, c_out: int, tile_h: int, tile_w: int, halo: int,
                       family: int, n_ops: int = 0) -> int:
    """Dynamic shared memory of one K2 block (st_layout in the source): the
    chain table, one 16-byte source per window row, the post-pointwise u8
    window per output plane (rows padded to 16 bytes), then one scratch
    region: the raw interleaved window, or for separable and min/max the
    float32 row pass per plane if that is larger."""
    eh, ew = tile_h + 2 * halo, tile_w + 2 * halo
    plane_pitch = -(-ew // 16) * 16
    raw = eh * (-(-(ew * c_in + 15) // 16) * 16)
    row_pass = c_out * eh * tile_w * 4 if family in _TWO_PASS else 0
    return n_ops * 16 + eh * 16 + c_out * eh * plane_pitch + max(raw, row_pass)


def stencil_tile_shape(height: int, width: int, tile_h: int | None = None) -> tuple[int, int]:
    """K2's block of outputs for a launch over (height, width): `tile_h`
    rows (default 16, or `height` if lower) by the widest of ST_TILE_WIDTHS
    that gives the grid N_SMS blocks, narrowing only while that adds
    blocks."""
    rows = tile_h or min(DEFAULT_TILE_H, height)
    cols = ST_TILE_WIDTHS[0]
    for narrower in ST_TILE_WIDTHS[1:]:
        if stencil_blocks(height, width, rows, cols) >= N_SMS:
            break
        if -(-width // narrower) > -(-width // cols):
            cols = narrower
    return rows, cols


def stencil_grid(height: int, width: int, tile_h: int, tile_w: int = TILE_W) -> tuple[int, int]:
    """K2's grid (and K4's, with its 128-column tiles): (column tiles, row
    tiles)."""
    return -(-width // tile_w), -(-height // tile_h)


def stencil_blocks(height: int, width: int, tile_h: int, tile_w: int) -> int:
    gx, gy = stencil_grid(height, width, tile_h, tile_w)
    return gx * gy


@functools.lru_cache(maxsize=4096)
def stencil_launch_shape(height: int, width: int, c_in: int, c_out: int, halo: int,
                         family: int, n_ops: int, tile_h: int | None,
                         calibrated: tuple | None = None) -> tuple[int, int]:
    """The (rows, cols) block of one K2/K2g/K3 launch, checked: shared
    memory within a block's and the grid within CUDA's. Where `tile_h` is
    None, `calibrated` (rows, channels) of a block_h record sets the tile
    height if the launch reads that many channels (None: any) and can take
    it, else the default does. Cached, so that a call repeats no shape
    arithmetic."""
    if tile_h is None and calibrated is not None and calibrated[1] in (None, c_in):
        try:
            return stencil_launch_shape(height, width, c_in, c_out, halo, family, n_ops,
                                        calibrated[0])
        except ValueError:
            pass  # a record that does not fit this launch costs time, never a launch
    if tile_h is not None and tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    rows, cols = stencil_tile_shape(height, width, tile_h)
    smem = stencil_smem_bytes(c_in, c_out, rows, cols, halo, family, n_ops)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"tile of {rows} x {cols} needs {smem} B of shared memory "
            f"(at most {MAX_SMEM_BYTES})"
        )
    if stencil_grid(height, width, rows, cols)[1] > _MAX_GRID_Y:
        raise ValueError(f"image height {height} needs a taller tile than {rows}")
    return rows, cols


def _check_cuda_input(img: torch.Tensor) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got {img.device}")
    if img.dtype != U8:
        raise TypeError(f"the kernels take uint8 images, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("the kernels take contiguous images")


def _out_like(img: torch.Tensor, c_out: int, height: int | None = None) -> torch.Tensor:
    """A fresh u8 output beside the u8 input `img` (same device)."""
    h, w = img.shape[:2]
    h = h if height is None else height
    return img.new_empty((h, w) if c_out == 1 else (h, w, c_out))


def _stack_like(stack: torch.Tensor, c_out: int) -> torch.Tensor:
    """A fresh u8 stack beside the u8 stack `stack`: one (H, W[, c_out])
    output per input image."""
    n, h, w = stack.shape[:3]
    return stack.new_empty((n, h, w) if c_out == 1 else (n, h, w, c_out))


def _per_plane(fn, img: torch.Tensor) -> torch.Tensor:
    """`fn` on each channel plane of an (H, W) or (H, W, C) image."""
    if img.ndim == 3:
        return torch.stack([fn(img[..., c]) for c in range(img.shape[2])], dim=-1)
    return fn(img)


# --------------------------------------------------------------------------
# The batch axis: one launch over a stack of same-shape images
# --------------------------------------------------------------------------

# images of one launch: CUDA's limit on grid z (ST_MAX_IMAGES, FS_MAX_IMAGES
# and SW_MAX_IMAGES in the sources)
MAX_BATCH = 65535


def batch_geometry(n: int, height: int, width: int, c_in: int,
                   c_out: int) -> tuple[int, int, int]:
    """(images, input stride, output stride) of one K2, K4 or K6-K8 launch
    over a contiguous stack of `n` (height, width) images of `c_in`
    channels in and `c_out` out, strides in bytes: the kernels' batch
    axis, grid z, takes image i at ``i * stride`` (in 64 bits there; here
    Python ints). One image is a stack of one. The input and output
    strides differ where the group changes the channel count."""
    if not 1 <= n <= MAX_BATCH:
        raise ValueError(f"one launch takes 1 to {MAX_BATCH} images, got {n}")
    pix = height * width
    return n, pix * c_in, pix * c_out


# the current stream's handle on a device, without building a Stream object
# (where this PyTorch build has the call)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device: torch.device) -> int:
    """The handle of the current CUDA stream of `device`, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it."""
    if _RAW_STREAM is not None:
        index = device.index
        return _RAW_STREAM(torch.cuda.current_device() if index is None else index)
    return torch.cuda.current_stream(device).cuda_stream


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


# K1's body (pointwise_run.cuh): PW_RUN pixels a thread
PW_RUN = 16


def pointwise_split(in_addr: int, out_addr: int, n_pix: int, c_in: int,
                    c_out: int) -> tuple[int, int, int, int]:
    """How K1's body splits a launch (pw_split in the source): (head, runs,
    tail, in_shift). Pixels [0, head) and the `tail` after the body run one
    a thread; the body is `runs` runs of PW_RUN pixels from `head`, the
    first pixel whose output is 16-byte aligned, so every run's output
    span is whole 16-byte words and its input starts `in_shift` bytes past
    a 16-byte boundary."""
    head = 0
    while head < PW_RUN and (out_addr + head * c_out) % 16:
        head += 1
    head = min(head, n_pix)
    runs = (n_pix - head) // PW_RUN
    tail = n_pix - head - runs * PW_RUN
    return head, runs, tail, (in_addr + head * c_in) % 16


@takes_stack
def pointwise_group(pointwise: list[PointwiseOp], stack: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: one launch applies the whole pointwise chain, of any
    length. A contiguous stack is one flat run of N * H * W pixels, so it
    too is one launch."""
    c_in = _stack_channels(stack)
    chain = chain_for(pointwise, c_in)
    dev = stack.device
    if dev.type == "cpu":
        return per_image(partial(pointwise_group_plain, pointwise), stack)
    _check_cuda_input(stack)
    out = _stack_like(stack, chain.c_out)
    rc = kr.load("pointwise").pointwise_launch(
        stack.data_ptr(), out.data_ptr(), stack.numel() // c_in, c_in,
        chain.c_out, chain.ptr(dev), chain.n_ops, dev.index, stream_handle(dev),
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


@takes_stack
def stream_stencil(
    pointwise: list[PointwiseOp],
    stencil: StencilOp,
    stack: torch.Tensor,
    *,
    tile_h: int | None = None,
    calibrated: tuple | None = None,
) -> torch.Tensor:
    """K2 wrapper: one launch runs the pointwise prologue (any length) and
    the stencil. `tile_h` is the block's output rows (default 16, or the
    image's height if lower; a `calibrated` record's where it applies,
    `stencil_launch_shape`); the columns follow (`stencil_tile_shape`).
    The one launch takes every image of the stack on its batch axis
    (`batch_geometry`)."""
    if stencil.edge_mode == "zero":
        raise NotImplementedError(
            "zero-mode stencils would need post-pointwise padding in K2; "
            "none exist in the registry"
        )
    c_in = _stack_channels(stack)
    chain = chain_for(pointwise, c_in)
    desc = desc_for(stencil)
    n, height, width = stack.shape[:3]
    rows, cols = stencil_launch_shape(height, width, c_in, chain.c_out, desc.halo, desc.family,
                                      chain.n_ops, tile_h, calibrated)
    dev = stack.device
    if dev.type == "cpu":
        return per_image(partial(stream_stencil_plain, pointwise, stencil), stack)
    _check_cuda_input(stack)  # only contiguous: images at a fixed stride
    n, in_stride, out_stride = batch_geometry(n, height, width, c_in, chain.c_out)
    out = _stack_like(stack, chain.c_out)
    rc = kr.load("stream_stencil").stream_stencil_launch(
        stack.data_ptr(), out.data_ptr(), height, width, c_in, chain.c_out, chain.ptr(dev),
        chain.n_ops, desc, rows, cols, n, in_stride, out_stride, dev.index, stream_handle(dev),
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
    c_in = _channels(tile)
    chain = chain_for(pointwise, c_in)
    desc = desc_for(stencil)
    _check_ghost_args(stencil, tile, top, bottom, image_w)
    local_h, width = tile.shape[:2]
    rows, cols = stencil_launch_shape(local_h, width, c_in, chain.c_out, desc.halo, desc.family,
                                      chain.n_ops, tile_h)
    if tile.device.type == "cpu":
        return stream_stencil_ghost_plain(
            pointwise, stencil, tile, top, bottom, y0=y0, image_h=image_h, image_w=image_w
        )
    for t in (tile, top, bottom):
        _check_cuda_input(t)
    out = _out_like(tile, chain.c_out)
    dev = tile.device
    rc = kr.load("stream_stencil").stream_stencil_ghost_launch(
        tile.data_ptr(), top.data_ptr(), bottom.data_ptr(), out.data_ptr(), local_h, width,
        c_in, chain.c_out, chain.ptr(dev), chain.n_ops, desc, rows, cols, y0, image_h,
        dev.index, stream_handle(dev),
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
    desc = desc_for(stencil)
    h = stencil.halo
    local_h, width = ext.shape[0] - 2 * h, ext.shape[1]
    if local_h < 1:
        raise ValueError(f"extended tile of {ext.shape[0]} rows holds no row for halo {h}")
    if stencil.edge_mode == "reflect101" and width <= h:
        raise ValueError(f"tile width {width} too small for halo {h}")
    c = _channels(ext)
    rows, cols = stencil_launch_shape(local_h, width, c, c, h, desc.family, 0, tile_h)
    dev = ext.device
    if dev.type == "cpu":
        return stencil_tile_plain(stencil, ext)
    _check_cuda_input(ext)
    out = _out_like(ext, c, local_h)
    rc = kr.load("stream_stencil").stencil_tile_launch(
        ext.data_ptr(), out.data_ptr(), local_h, width, c, desc, rows, cols, dev.index,
        stream_handle(dev),
    )
    _raise_on(rc, "stencil_tile")
    stencil_tile.launches += 1
    return out


stencil_tile.launches = 0


# --------------------------------------------------------------------------
# K4: one fused plan stage
# --------------------------------------------------------------------------

# Largest stage halo K4 takes: beyond it the window's context rows would be
# most of the block's read (the same limit as the TPU megakernel's)
STAGE_MAX_HALO = 16
FS_TILE_WIDTHS = ST_TILE_WIDTHS
# bytes of one op row and one stencil row of a stage table (PwOp, FsStencil)
FS_OP_BYTES = 16
FS_STENCIL_BYTES = 448


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


def stage_stencil_desc(op: StencilOp, arm: str) -> kr.StencilDesc:
    """The descriptor of `op` in a stage table on in-stage arm `arm`: a
    separable stencil on a tensor-core arm carries its 2-D kernel in w0 too,
    which K5 contracts."""
    d = desc_for(op)
    if arm != "vpu" and op.separable is not None:
        d = kr.StencilDesc.from_buffer_copy(d)
        ks = 2 * op.halo + 1
        d.w0[: ks * ks] = [float(v) for v in np.asarray(op.kernels[0], np.float32).reshape(-1)]
    return d


def _stencil_class(ksize: int) -> int:
    """The K4 instantiation a stencil of side `ksize` needs (3, 5 or 7)."""
    return max(3, ksize)


class StageProgram:
    """One fused stage as K4 and K4g take it, built once (``stage_program``):
    its ops and arms, channel counts, halo, the instantiation it needs, and
    its table, an int32 array: one 16-byte ``PwOp`` row per op (a pointwise
    opcode and its parameter's float32 bits, or ``FS_OP_STENCIL + j`` for
    stencil j), then one 448-byte ``FsStencil`` row per stencil (its
    descriptor and arm code). The table has no length limit; each block
    copies it into shared memory."""

    def __init__(self, ops: tuple, c_in: int, arms: tuple):
        if len(arms) != len(ops):
            raise ValueError(f"{len(arms)} arms for a stage of {len(ops)} ops")
        self.ops, self.arms, self.c_in = ops, arms, c_in  # held: the cache's ids stay theirs
        self.c_out, self.c_smem, self.two_pass = _stage_channels(ops, c_in)
        self.halo = chain_halo(ops)
        op_rows = np.zeros((len(ops), 4), dtype=np.int32)
        stencils = []
        for k, (op, arm) in enumerate(zip(ops, arms)):
            check_stage_arm(op, arm)
            if isinstance(op, StencilOp):
                row = kr.FsStencil()
                row.st = stage_stencil_desc(op, arm)
                row.arm = _ARM_CODES[arm]
                op_rows[k, 0] = kr.FS_OP_STENCIL + len(stencils)
                stencils.append(row)
                continue
            opcode, p0, p1 = kernel_program(op)
            if p1 != 0.0:
                raise ValueError(f"op {op.name!r}: K4 carries one parameter per op")
            op_rows[k, 0] = opcode
            op_rows[k, 1] = np.asarray(p0, dtype=np.float32).view(np.int32)
        self.n_ops, self.n_stencils = len(ops), len(stencils)
        # the last stencil's descriptor once more, passed by value at each
        # launch (its weights become kernel parameters in the store-fused
        # last step)
        self.last = ctypes.byref(stencils[-1].st) if stencils else None
        self._stencils = stencils
        self.table = np.concatenate(
            [op_rows.reshape(-1)] + [np.frombuffer(bytes(r), dtype=np.int32) for r in stencils]
        )
        self.kmax = max((_stencil_class(2 * op.halo + 1) for op in ops
                         if isinstance(op, StencilOp)), default=0)
        self.mma = any(a != "vpu" for a in arms)
        self._ptrs: dict[torch.device, int] = {}

    @property
    def table_bytes(self) -> int:
        return self.table.nbytes

    def stencil_rows(self) -> list:
        """The table's stencil rows as ``FsStencil`` structures."""
        base = self.n_ops * FS_OP_BYTES
        raw = self.table.tobytes()
        return [kr.FsStencil.from_buffer_copy(raw, base + j * FS_STENCIL_BYTES)
                for j in range(self.n_stencils)]

    def ptr(self, device: torch.device) -> int:
        """The table's address on `device`."""
        p = self._ptrs.get(device)
        if p is None:
            p = self._ptrs[device] = device_table(self.table, device).data_ptr()
        return p


_STAGES: dict[tuple, StageProgram] = {}


def stage_program(ops, c_in: int, arms=None) -> StageProgram:
    """The encoded stage of `ops` from `c_in` channels with in-stage arms
    `arms` (one per op, default all 'vpu'; a tensor-core arm must be proven
    for its op), cached on the ops' identity."""
    ops = tuple(ops)
    arms = tuple(arms) if arms is not None else ("vpu",) * len(ops)
    key = (c_in, arms, *map(id, ops))
    prog = _STAGES.get(key)
    if prog is None:
        prog = StageProgram(ops, c_in, arms)
        if len(_STAGES) >= _CACHE_LIMIT:
            _STAGES.clear()
        _STAGES[key] = prog
    return prog


def fused_stage_table_bytes(ops) -> int:
    """Bytes of the stage table of `ops` (``StageProgram.table``)."""
    n_st = sum(isinstance(op, StencilOp) for op in ops)
    return FS_OP_BYTES * len(ops) + FS_STENCIL_BYTES * n_st


def fused_stage_layout(c_in: int, c_smem: int, tile_h: int, tile_w: int, halo: int,
                       table_bytes: int, two_pass: bool) -> dict:
    """One K4 block's shared memory (fs_layout in the source), in order: the
    stage table, one 16-byte source per window row, buffers A and B (c_smem
    planes each of the (tile_h + 2 halo)-row window, `pitch` bytes a row:
    a multiple of 4 with room for the last strip's word reads, which end at
    most 5 bytes past the region), then for separable and min/max stencils
    the float32 row pass (c_smem planes of the same shape). The raw
    interleaved window (`raw_pitch` bytes a row: the row's c_in (tile_w +
    2 halo) bytes from up to 15 bytes below, in whole granules) is staged
    over B and what follows it."""
    eh, ew = tile_h + 2 * halo, tile_w + 2 * halo
    pitch = (ew + 5 + 3) & ~3
    raw_pitch = -(-(ew * c_in + 15) // 16) * 16
    plane = eh * pitch
    rows_off = -(-table_bytes // 16) * 16
    a_off = rows_off + eh * 16
    buf = -(-(c_smem * plane) // 16) * 16
    b_off = a_off + buf
    f_off = b_off + buf
    f_end = f_off + (c_smem * plane * 4 if two_pass else 0)
    total = max(f_end, b_off + eh * raw_pitch)
    return dict(pitch=pitch, raw_pitch=raw_pitch, plane=plane, rows_off=rows_off, a_off=a_off,
                b_off=b_off, f_off=f_off, total=total)


def fused_stage_smem_bytes(c_in: int, c_smem: int, tile_h: int, tile_w: int, halo: int,
                           table_bytes: int, two_pass: bool) -> int:
    """Dynamic shared memory of one K4 block (`fused_stage_layout`)."""
    return fused_stage_layout(c_in, c_smem, tile_h, tile_w, halo, table_bytes, two_pass)["total"]


def stage_row_source(r: int, first_row: int, in_row0: int, in_rows: int) -> int:
    """The array row K4's window row `r` is read from (st_row_sources_clamped
    in window_load.cuh): window row r is global row `first_row + r` (the
    tile's first output row less the stage halo), array row `global -
    in_row0` of an array of `in_rows` rows (in_row0 = 0 for the whole image
    in K4, the shard's first row less the halo in K4g), clamped into it."""
    return min(max(first_row + r - in_row0, 0), in_rows - 1)


def row_granules(addr: int, seg: int) -> tuple[int, int, int]:
    """How the window loader (st_row_at in window_load.cuh) copies a row
    segment of `seg` bytes at device address `addr`: (the 16-byte aligned
    address of its first granule, the shift from there to `addr`, the
    granule count)."""
    shift = addr & 15
    return addr - shift, shift, (shift + seg + 15) >> 4


# K4's tile heights, tallest first, and the blocks an SM should hold (the
# registers of the VPU instantiations allow four or five)
FS_TILE_ROWS = (48, 32, 16)
FS_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=4096)
def fused_stage_tile_shape(height: int, width: int, c_in: int, c_smem: int, halo: int,
                           two_pass: bool, table_bytes: int,
                           tile_h: int | None = None) -> tuple[int, int, int]:
    """K4's block of outputs for a launch over (height, width) and its
    shared memory: (rows, cols, smem bytes). Rows: `tile_h`, else the
    tallest of FS_TILE_ROWS whose block leaves room for FS_BLOCKS_PER_SM
    blocks on an SM (a tall tile reads fewer context rows: (rows + 2 halo)
    / rows), else 16 halved until the block fits, and never more than
    `height`; columns: the widest of FS_TILE_WIDTHS that gives the grid
    N_SMS blocks, narrowing only while that adds blocks; then, while the
    grid has fewer than N_SMS blocks, the next lower of FS_TILE_ROWS. The
    caller checks the shared memory against the budget."""

    def smem(r, c):
        return fused_stage_smem_bytes(c_in, c_smem, r, c, halo, table_bytes, two_pass)

    rows = tile_h
    if rows is None:
        fit = [r for r in FS_TILE_ROWS if smem(r, FS_TILE_WIDTHS[0])
               <= MAX_SMEM_BYTES // FS_BLOCKS_PER_SM]
        rows = fit[0] if fit else FS_TILE_ROWS[-1]
        while rows > 1 and smem(rows, FS_TILE_WIDTHS[0]) > MAX_SMEM_BYTES:
            rows //= 2
        rows = min(rows, height)
    cols = FS_TILE_WIDTHS[0]
    for narrower in FS_TILE_WIDTHS[1:]:
        if stencil_blocks(height, width, rows, cols) >= N_SMS:
            break
        if -(-width // narrower) > -(-width // cols):
            cols = narrower
    if tile_h is None:
        for lower in FS_TILE_ROWS:
            if lower < rows and stencil_blocks(height, width, rows, cols) < N_SMS:
                rows = lower
    return rows, cols, smem(rows, cols)


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
    greater than the largest op halo) or 'smem-budget' (the tile, with the
    stage table, needs more shared memory than a block has). A stage may
    hold any number of ops and stencils."""
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
    _, c_smem, two_pass = _stage_channels(ops, channels)
    if c_smem:
        smem = fused_stage_tile_shape(height, width, channels, c_smem, halo, two_pass,
                                      fused_stage_table_bytes(ops), tile_h)[2]
        if smem > MAX_SMEM_BYTES:
            return "smem-budget"
    return None


def _resolve_arms(ops, mxu_stage, arms, width: int, device) -> tuple[str, ...]:
    """The stage's in-stage arms: `arms` as given, else resolved from the
    `mxu_stage` setting now for an image `width` wide on `device`
    (ops/mxu_kernels.stage_arm_for counts them)."""
    if arms is not None:
        return tuple(arms)
    return stage_arms(ops, mxu_stage, width, device=device)


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
    arms = _resolve_arms(ops, mxu_stage, arms, img.shape[1], img.device)
    _stage_channels(ops, _channels(img))
    return run_stage_full(
        Stage("fused", ops, chain_halo(ops)), img, acc_fns_for(ops, "torch", arms)
    )


def _fs_launch_shape(prog: StageProgram, height: int, width: int,
                     tile_h: int | None) -> tuple[int, int]:
    """The (rows, cols) block of one K4/K4g launch of `prog` over (height,
    width), checked against the grid's height limit."""
    if tile_h is not None and tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    if not prog.c_smem:
        return 0, 0  # no stencil: K1's body
    rows, cols, _ = fused_stage_tile_shape(height, width, prog.c_in, prog.c_smem, prog.halo,
                                           prog.two_pass, prog.table_bytes, tile_h)
    if stencil_grid(height, width, rows, cols)[1] > _MAX_GRID_Y:
        raise ValueError(f"image height {height} needs a taller tile than {rows}")
    return rows, cols


@takes_stack
def fused_stage(
    ops,
    stack: torch.Tensor,
    *,
    tile_h: int | None = None,
    mxu_stage: str | None = None,
    arms=None,
) -> torch.Tensor:
    """K4 wrapper: one launch runs a whole fused plan stage. `tile_h` is the
    output tile height (default `fused_stage_tile_shape`'s). Each stencil's
    in-stage arm is `arms[k]` (one per op) when given, else resolved from
    the `mxu_stage` setting once per call (ops/mxu_kernels.MXU_STAGE_SETTINGS;
    None is MCIM_MXU_STAGE, by default 'auto': a stage_arm record on a card,
    else the VPU arm); a stencil on a tensor-core arm runs K5. Raises for a
    stage that `fused_stage_reject` rejects. The one launch takes every
    image of the stack on its batch axis (`batch_geometry`)."""
    ops = tuple(ops)
    n, height, width = stack.shape[:3]
    arms = _resolve_arms(ops, mxu_stage, arms, width, stack.device)
    c_in = _stack_channels(stack)
    if tile_h is not None and tile_h < 1:
        raise ValueError(f"tile height must be >= 1, got {tile_h}")
    reason = fused_stage_reject(ops, height, width, c_in, tile_h)
    if reason is not None:
        raise ValueError(f"K4 cannot run stage {[op.name for op in ops]}: {reason}")
    prog = stage_program(ops, c_in, arms)
    rows, cols = _fs_launch_shape(prog, height, width, tile_h)
    dev = stack.device
    if dev.type == "cpu":
        return per_image(partial(fused_stage_plain, ops, arms=arms), stack)
    _check_cuda_input(stack)  # only contiguous: images at a fixed stride
    n, in_stride, out_stride = batch_geometry(n, height, width, c_in, prog.c_out)
    out = _stack_like(stack, prog.c_out)
    rc = kr.load("fused_stage").fused_stage_launch(
        stack.data_ptr(), out.data_ptr(), height, width, c_in, prog.c_smem, prog.c_out,
        prog.halo, rows, cols, prog.ptr(dev), prog.last, prog.n_ops, prog.n_stencils,
        prog.kmax, int(prog.mma), int(prog.two_pass), n, in_stride, out_stride, dev.index,
        stream_handle(dev),
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
    arms = _resolve_arms(ops, mxu_stage, arms, image_w, ext.device)
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
    arms = _resolve_arms(ops, mxu_stage, arms, image_w, ext.device)
    c_in = _channels(ext)
    halo = chain_halo(ops)
    local_h, width = ext.shape[0] - 2 * halo, ext.shape[1]
    if tile_h is not None and tile_h < 1:
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
    prog = stage_program(ops, c_in, arms)
    rows, cols = _fs_launch_shape(prog, local_h, width, tile_h)
    dev = ext.device
    if dev.type == "cpu":
        return fused_stage_ext_plain(
            ops, ext, y0=y0, image_h=image_h, image_w=image_w, arms=arms
        )
    _check_cuda_input(ext)
    out = _out_like(ext, prog.c_out, local_h)
    rc = kr.load("fused_stage").fused_stage_ext_launch(
        ext.data_ptr(), out.data_ptr(), local_h, width, c_in, prog.c_smem, prog.c_out, halo,
        rows, cols, prog.ptr(dev), prog.last, prog.n_ops, prog.n_stencils, prog.kmax,
        int(prog.mma), int(prog.two_pass), y0, image_h, dev.index, stream_handle(dev),
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
    # K5 reads the window by words: rows a multiple of 4 bytes apart
    pitch = -(-cols // 4) * 4
    if pitch != cols or plane.data_ptr() % 4:
        padded = torch.zeros((rows, pitch), dtype=U8, device=plane.device)
        padded[:, :cols] = plane
        plane = padded
    out = torch.empty((rows - 2 * h, cols - 2 * h), dtype=torch.float32, device=plane.device)
    desc = stage_stencil_desc(op, arm)
    lib = kr.load("fused_stage")
    with torch.cuda.device(plane.device):
        rc = lib.k5_sums_launch(
            plane.data_ptr(), out.data_ptr(), rows, cols, pitch, ctypes.byref(desc), kernel,
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
# (swar_proto.py), T1's pointwise, stencil and ghost forms (packed_kernels.py)
TOOL_LAUNCHES = dict.fromkeys(
    ("T4-copy", "T4-smem-copy", "T4-bitcast-store", "T4-bitcast-load", "T2", "T3",
     "T1-pw", "T1", "T1g"), 0
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


@takes_stack
def run_group(
    pointwise: list[PointwiseOp],
    stencil: StencilOp | None,
    stack: torch.Tensor,
    *,
    block_h: int | None = None,
    calibrated: tuple | None = None,
) -> torch.Tensor:
    """Run one ``[pointwise*, stencil?]`` group as one kernel launch, or a
    group of one op with no kernel program as that op's own tensor ops (a
    lookup table's gather; a geometric op's gathers, whose output is
    contiguous, so that the next group's kernel takes it; a histogram and
    its table). `block_h` sets K2's tile height; where it is None, a
    `calibrated` record's does where it applies (`stencil_launch_shape`).
    A kernel group is one launch over the stack; an op with no kernel
    program runs per image."""
    if stencil is None and len(pointwise) == 1 and not pointwise[0].kernel_safe:
        return per_image(pointwise[0], stack)
    if stencil is None:
        return pointwise_group(pointwise, stack, batched=True)
    height, width = stack.shape[1:3]
    h = stencil.halo
    if stencil.edge_mode == "reflect101" and (height <= h or width <= h):
        raise ValueError(f"image {height}x{width} too small for halo {h}")
    return stream_stencil(pointwise, stencil, stack, tile_h=block_h, calibrated=calibrated,
                          batched=True)


@takes_stack
def pipeline_cuda(ops, stack: torch.Tensor, *, block_h: int | None = None,
                  calibrated: tuple | None = None) -> torch.Tensor:
    """Run a pipeline group by group through the kernels. Same u8 result as
    the golden path; on a CPU tensor every group takes its plain version.
    `block_h` and `calibrated` as `run_group` takes them."""
    for pointwise, stencil in group_ops(ops):
        stack = run_group(pointwise, stencil, stack, block_h=block_h, calibrated=calibrated,
                          batched=True)
    return stack


def calibrated_tile(impl: str, width: int, device) -> tuple | None:
    """(rows, channels) of the block_h record of `impl` ('cuda': K2;
    'swar': K6-K8) for `device`'s kind at `width` (channels None where the
    record does not say), or None. Reads the store: resolve it once per
    built function and image shape."""
    rec = calibration.block_entry(platform.device_kind(device), impl=impl, width=width)
    return None if rec is None else (rec["block_h"], rec.get("channels"))


def auto_runner(ops, width: int, device, *, block_h: int | None = None,
                swar: bool | None = None):
    """``backend='auto'`` for images `width` wide on `device`: a function
    stack -> stack with every routing decision made here, once. Each stencil
    that `use_mxu_for_stencil` routes runs as the whole-op banded products
    (`mxu_stencil`, in the mode it says), its pointwise prologue a K1 group
    before it; the runs of ops between such stencils go, under `swar`
    (default ``MCIM_PREFER_SWAR``), through `pipeline_swar` (each eligible
    ``[pre*, stencil, post*]`` group one K6-K8 launch on a gray plane), else
    through `pipeline_cuda`. `block_h` sets K2's tile (K6-K8's under
    `swar`); where it is None the store's block_h records do, where they
    fit. The counterpart of the JAX package's ``pipeline_auto``, whose
    static default (XLA for halo-1 groups, a TPU measurement) does not
    carry over: with no record and no switch this runs what `pipeline_cuda`
    runs. Each route takes the stack in its batched form (one launch per
    group and stack); `one_image` makes it an image -> image function."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import (
        pipeline_swar,
        prefer_swar,
    )

    swar = prefer_swar() if swar is None else swar
    impl = "swar" if swar else "cuda"
    tile = None if block_h is not None else calibrated_tile(impl, width, device)
    col = mxu_col_variant()
    steps: list = []  # (run of ops, None) or (stencil, banded mode)
    run: list = []
    for op in ops:
        mode = use_mxu_for_stencil(op, width, device)
        if mode is None:
            run.append(op)
            continue
        if run:
            steps.append((tuple(run), None))
            run = []
        steps.append((op, mode))
    if run:
        steps.append((tuple(run), None))

    def go(stack: torch.Tensor) -> torch.Tensor:
        for step, mode in steps:
            if mode is not None:
                stack = mxu_stencil(step, stack, mode=mode, col_variant=col, batched=True)
            elif swar:
                stack = pipeline_swar(step, stack, block_h=block_h, calibrated=tile, batched=True)
            else:
                stack = pipeline_cuda(step, stack, block_h=block_h, calibrated=tile, batched=True)
        return stack

    return go


def pipeline_auto(ops, img: torch.Tensor, *, block_h: int | None = None) -> torch.Tensor:
    """`auto_runner` for this image, resolved and run once. A built
    function (``Pipeline.jit(backend='auto')``) resolves once per image
    shape instead."""
    return one_image(auto_runner(ops, img.shape[1], img.device, block_h=block_h))(img)
