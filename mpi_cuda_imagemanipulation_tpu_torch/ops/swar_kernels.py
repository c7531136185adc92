"""The SWAR backend (``backend='swar'``): the counterpart of the JAX
package's ``ops/swar_kernels.py``.

SWAR computes integer stencils with two u8 pixels in one 32-bit register as
16-bit fields, and folds affine pointwise neighbours (contrast, brightness,
invert) into the stencil as integer steps, before it (pre-chain) or after it
(post-chain). Three hand-written CUDA kernels (``csrc/swar_stencil.cu``)
cover the correlation class:

* K6, the separable integer stencil (``swar_eligible``: non-negative integer
  taps summing to 2 <= S <= 128, scale 1/S^2, round-half-even; the binomial
  Gaussians and the odd box filters). Narrow mode (S a power of two <= 16)
  keeps both passes on 16-bit fields and normalises by a shift; wide mode
  runs its column pass on fields where 255 * S^2 < 2^16 (the box filters up
  to box:15), else on one pixel per 32-bit lane, and replays the golden
  float32 multiply and rounding on the exact integer sums.
* K7, the signed 2-D correlation over biased fields
  (``swar_corr2d_eligible``: scale 1, sum|w| <= 128; the emboss family with
  its interior guard, sharpen, the laplacians).
* K8, the rest of the correlation class with exact signed sums
  (``swar_corr2d_wide_eligible``: 255 * sum|w| < 2^24, any scale, one kernel
  or a magnitude of two, either quantizer; sobel, prewitt, scharr, unsharp,
  integer custom filters): on biased 16-bit fields where they fit (3x3:
  sobel, scharr, prewitt), else on 32-bit lanes.

Kernels of side 3, 5 and 7 take their taps as kernel parameters
(``swar_taps``) in instantiations of their own (``swar_instance``,
``SWAR_INSTANCES``); larger ones read a tap table.

An elementwise u8 op is its 256-entry table: ``swar_fusable`` fits that
table (``PointwiseOp.lut_host``) to ``min(max(A*x - C, 0) >> m, 255)`` with
``x = p`` or ``255 - p``, and an op fuses only when the fit reproduces every
entry. ``pipeline_swar`` runs each eligible ``[pre*, stencil, post*]`` group
as one launch on a single u8 plane and every other op through the K1/K2
group runner (``cuda_kernels.pipeline_cuda``), so the backend gives the same
bytes as the golden ops on any pipeline. ``auto`` takes it only under the
switch ``MCIM_PREFER_SWAR=1`` (`prefer_swar`; the JAX package keeps its own
off on a TPU measurement, which does not carry over).

Each kernel has a plain PyTorch version that computes the same integer
forms (``swar_stencil_plain``); ``swar_stencil`` takes it only for a tensor
on the CPU and, for a CUDA tensor, launches the kernel or raises. Launches
are counted in ``cuda_kernels.SWAR_LAUNCHES`` by kernel and mode ('K6-narrow',
'K6-wide', 'K7', 'K8'; ghost mode 'K6g-narrow', 'K6g-wide', 'K7g', 'K8g').

The JAX package's block-height picker (``_pick_swar_block_h``) sizes blocks
for a TPU's scratch memory; the port picks its own tile shape from the work
(``swar_tile_shape``), whose height ``block_h`` sets, and where it is None
the store's ``"swar"`` block_h record does where it fits
(utils/calibration.py, written by ``autotune --impl swar``). A group's descriptor, table, taps and launch shapes are
built once and cached on its ops' identity (``swar_group``), so a call, or
a shard's call in the sharded runner, repeats no host-side encoding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    _PAD_MODES,
    F32,
    QUANTIZERS_F32,
    U8,
    Op,
    PointwiseOp,
    StencilOp,
    _f32,
    pad2d,
    rint_clip_f32,
)
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

# Launch geometry (swar_stencil.cu: 256 threads a block, four output pairs
# a thread): the tile widths the picker chooses from, widest first (the
# kernel also takes 256), and the tile heights, tallest first.
TILE_WIDTHS = (128, 64)
TILE_W = TILE_WIDTHS[0]
TILE_ROWS = (64, 32, 16, 8)
DEFAULT_TILE_H = 64
# the largest kernel side with its taps as kernel parameters (SW_MAX_K)
MAX_K = kr.SW_MAX_K
# a 16-bit field holds sums below FIELD_LIMIT (K6 wide's column pass, K8's
# biased sums)
FIELD_LIMIT = 1 << 16
# Kernel kinds (SwKind in the source) and their launch-count keys
KINDS = {"K6-narrow": 0, "K6-wide": 1, "K7": 2, "K8": 3}
_GHOST_KEYS = {"K6-narrow": "K6g-narrow", "K6-wide": "K6g-wide", "K7": "K7g", "K8": "K8g"}


def prefer_swar() -> bool:
    """The switch MCIM_PREFER_SWAR=1: every auto path (``Pipeline.jit`` and
    the sharded runner) runs eligible stencil groups on K6-K8. Off by
    default. Read once per built function."""
    return env_registry.get_bool("MCIM_PREFER_SWAR")


# --------------------------------------------------------------------------
# Eligibility
# --------------------------------------------------------------------------


def swar_eligible(op: Op, plane_shape: tuple[int, ...] | None = None) -> bool:
    """Whether `op` (on an optional (H, W) u8 plane shape) runs on K6: a
    'corr'/'single' stencil with integer non-negative separable taps of odd
    length 2 * halo + 1 summing to 2 <= S <= 128, scale 1/S^2, rint_clip,
    and a real border extension."""
    if not isinstance(op, StencilOp):
        return False
    if op.reduce != "corr" or op.combine != "single":
        return False
    if op.quantize != "rint_clip":
        return False
    if op.edge_mode == "interior" or op.edge_mode not in _PAD_MODES:
        return False
    taps = op.separable
    if taps is None:
        return False
    t = np.asarray(taps)
    if not np.all(t == np.floor(t)) or np.any(t < 0):
        return False
    s = int(t.sum())
    # S <= 128: row-pass fields <= 255 * 128 = 32640 fit 16 bits with the
    # sign bit clear, and wide-mode column sums 255 * S^2 < 2^24 are exact
    # in float32
    if s < 2 or s > 128:
        return False
    if abs(op.scale * s * s - 1.0) > 1e-12:
        return False
    # exact form: the kernel reads 2 * halo + 1 taps, so an even-length
    # vector is refused here rather than run wrong
    if len(t) - 1 != 2 * op.halo:
        return False
    if plane_shape is not None and not _shape_ok(op, plane_shape):
        return False
    return True


def _taps_shift(op: StencilOp) -> tuple[tuple[int, ...], int]:
    """(integer taps, k) with 2^k = S^2: the field arithmetic constants."""
    t = tuple(int(v) for v in np.asarray(op.separable))
    s = sum(t)
    k = int(s * s).bit_length() - 1
    return t, k


def _swar_mode(taps: tuple[int, ...]) -> str:
    """'narrow' (16-bit-field column pass, shift normalisation) when S is a
    power of two <= 16; 'wide' (i32-lane column pass, golden float32
    quantize) otherwise."""
    s = sum(taps)
    return "narrow" if s <= 16 and not (s & (s - 1)) else "wide"


def _shape_ok(op: StencilOp, plane_shape) -> bool:
    """The common (H, W) plane gate: a single u8 plane, W a multiple of 4
    with W / 4 >= 2 * halo + 1, H past the halo. The kernels could take
    other widths; the gate is the JAX package's, so that routing and launch
    counts are the same."""
    if len(plane_shape) != 2:
        return False
    h_img, w_img = plane_shape
    return not (w_img % 4 or w_img // 4 < 2 * op.halo + 1 or h_img <= op.halo)


def _kernel_geom_ok(w: np.ndarray, halo: int) -> bool:
    """The 2-D kernels' geometry gate: an odd square of side 2 * halo + 1
    with integer weights."""
    if w.ndim != 2 or w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0:
        return False
    if w.shape[0] != 2 * halo + 1:
        return False
    return bool(np.all(w == np.floor(w)))


def _corr2d_weights(op: StencilOp) -> tuple[tuple[int, ...], ...]:
    w = np.asarray(op.kernels[0])
    return tuple(tuple(int(v) for v in row) for row in w)


def swar_corr2d_eligible(op: Op, plane_shape: tuple[int, ...] | None = None) -> bool:
    """Whether `op` runs on K7: one odd-square signed integer kernel, scale
    exactly 1 (both quantizers are then a clip of the integer sum), any
    border mode including 'interior', and sum|w| <= 128, so that the biased
    fields stay under 2^15."""
    if not isinstance(op, StencilOp):
        return False
    if op.reduce != "corr" or op.combine != "single":
        return False
    if len(op.kernels) != 1:
        return False
    if op.quantize not in ("trunc_clip", "rint_clip"):
        return False
    if op.scale != 1.0:
        return False
    if op.edge_mode not in _PAD_MODES:
        return False
    w = np.asarray(op.kernels[0])
    if op.halo < 1 or not _kernel_geom_ok(w, op.halo):
        return False
    if int(np.abs(w).sum()) > 128 or not np.any(w):
        return False
    if plane_shape is not None and not _shape_ok(op, plane_shape):
        return False
    return True


def swar_corr2d_wide_eligible(op: Op, plane_shape: tuple[int, ...] | None = None) -> bool:
    """Whether `op` runs on K8: odd-square integer kernel(s) with 255 *
    sum|w| < 2^24 (exact in float32), any scale, 'single' (one kernel) or
    'magnitude' (two), either quantizer."""
    if not isinstance(op, StencilOp):
        return False
    if op.reduce != "corr":
        return False
    if op.combine not in ("single", "magnitude"):
        return False
    if op.combine == "magnitude" and len(op.kernels) != 2:
        return False
    if op.combine == "single" and len(op.kernels) != 1:
        return False
    if op.quantize not in QUANTIZERS_F32:
        return False
    if op.edge_mode not in _PAD_MODES:
        return False
    if op.halo < 1:
        return False
    for k in op.kernels:
        w = np.asarray(k)
        if not _kernel_geom_ok(w, op.halo):
            return False
        if 255 * int(np.abs(w).sum()) >= 1 << 24 or not np.any(w):
            return False
    if plane_shape is not None and not _shape_ok(op, plane_shape):
        return False
    return True


def swar_any_eligible(op: Op, plane_shape: tuple[int, ...] | None = None) -> bool:
    """Whether any of K6, K7, K8 takes `op` (the runners' predicate)."""
    return (
        swar_eligible(op, plane_shape)
        or swar_corr2d_eligible(op, plane_shape)
        or swar_corr2d_wide_eligible(op, plane_shape)
    )


def swar_kind(op: StencilOp) -> str:
    """The kernel an eligible op runs on, as its launch-count key: K6 in
    its mode where ``swar_eligible``, else K7 where ``swar_corr2d_eligible``,
    else K8."""
    if swar_eligible(op):
        return f"K6-{_swar_mode(_taps_shift(op)[0])}"
    if swar_corr2d_eligible(op):
        return "K7"
    if swar_corr2d_wide_eligible(op):
        return "K8"
    raise ValueError(f"op {op.name!r} runs on no SWAR kernel")


# --------------------------------------------------------------------------
# Pointwise fusion: fitted affine u8 steps
# --------------------------------------------------------------------------


def _fit_affine_u8(lut_bytes: bytes) -> tuple[bool, int, int, int] | None:
    """Fit (neg, A, C, m) reproducing the 256-entry u8 table exactly, or
    None. The bounds keep every intermediate under 2^15 per 16-bit field:
    A <= 128 (A * 255 <= 32640 with the sign bit clear) and A * 255 +
    max(-C, 0) <= 32767 (additive steps stay in range)."""
    lut = np.frombuffer(lut_bytes, dtype=np.uint8).astype(np.int64)
    p = np.arange(256, dtype=np.int64)
    interior = np.nonzero((lut > 0) & (lut < 255))[0]
    if interior.size < 2:
        return None  # constant and step tables are not usefully affine
    p1, p2 = int(interior[0]), int(interior[-1])
    for neg in (False, True):
        x = 255 - p if neg else p
        dx = int(x[p2]) - int(x[p1])
        if dx == 0:
            continue
        dl = int(lut[p2]) - int(lut[p1])
        for m in range(9):
            a_est = (dl << m) / dx
            A = int(round(a_est))
            if A < 1 or A > 128:
                continue
            # C from the anchor: (A * x[p1] - C) >> m == lut[p1] leaves
            # exactly 2^m integer candidates
            base = A * int(x[p1]) - (int(lut[p1]) << m)
            for C in range(base - (1 << m) + 1, base + 1):
                if abs(C) > 32767 or A * 255 + max(-C, 0) > 32767:
                    continue
                t = np.maximum(A * x - C, 0)
                if np.array_equal(np.minimum(t >> m, 255), lut):
                    return (bool(neg), A, int(C), m)
    return None


_FIT_CACHE: dict[bytes, tuple | None] = {}


def swar_fusable(op: Op) -> tuple[bool, int, int, int] | None:
    """The fitted in-kernel form of an elementwise pointwise op, or None
    when the op cannot fuse into a SWAR kernel (no host table, channel
    structure, or no exact affine fit)."""
    if not isinstance(op, PointwiseOp) or not op.kernel_safe:
        return None
    if op.lut_host is None or op.core is None:
        return None
    if op.in_channels not in (0, 1) or op.out_channels not in (0, 1):
        return None
    lut = np.asarray(op.lut_host(), dtype=np.uint8)
    if lut.shape != (256,):
        return None
    key = lut.tobytes()
    if key not in _FIT_CACHE:
        _FIT_CACHE[key] = _fit_affine_u8(key)
    return _FIT_CACHE[key]


def _require_fusable(op: Op) -> tuple[bool, int, int, int]:
    fit = swar_fusable(op)
    if fit is None:
        raise ValueError(f"op {op.name!r} is not SWAR-fusable")
    return fit


def _chain_fixes_zero(pre_ops) -> bool:
    """Whether the composed pointwise prefix maps pixel value 0 to 0: the
    condition for fusing it under a zero-padded stencil (the golden path
    pads after the pointwise ops, the kernel maps the pad through them)."""
    v = 0
    for o in pre_ops:
        v = int(np.asarray(o.lut_host(), dtype=np.uint8)[v])
    return v == 0


def post_chain_end(ops, j: int) -> int:
    """Where the post-chain of a stencil at ops[j - 1] ends: after the
    fusable run that starts at ops[j], unless another eligible stencil
    follows that run (then the run is its pre-chain, and this returns j)."""
    k = j
    while k < len(ops) and swar_fusable(ops[k]) is not None:
        k += 1
    return j if k < len(ops) and swar_any_eligible(ops[k]) else k


def affine_int(x: torch.Tensor, chain) -> torch.Tensor:
    """Fitted (neg, A, C, m) steps on an integer tensor of u8 values."""
    for neg, A, C, m in chain:
        if neg:
            x = 255 - x
        x = torch.clamp((x * A - C).clamp_min(0) >> m, max=255)
    return x


# --------------------------------------------------------------------------
# Host-side encoding and geometry
# --------------------------------------------------------------------------


def swar_desc(op: StencilOp, pre_chain=(), post_chain=()) -> tuple[kr.SwarDesc, np.ndarray]:
    """Encode an eligible op with its fitted chains for the kernels: the
    descriptor and its int32 table (the chain steps, pre then post, then
    the taps), of any length. The wrapper points ``table`` at the table's
    copy on the card."""
    kind = swar_kind(op)
    d = kr.SwarDesc()
    d.kind = KINDS[kind]
    d.halo = op.halo
    d.edge_mode = ck._EDGE_MODES[op.edge_mode]
    d.quantize = ck._QUANTIZERS[op.quantize]
    d.combine = int(op.combine == "magnitude")
    d.interior = int(op.edge_mode == "interior")
    d.scale = _f32(op.scale)
    d.n_pre, d.n_post = len(pre_chain), len(post_chain)
    chain = [int(v) for step in tuple(pre_chain) + tuple(post_chain) for v in step]
    if kind.startswith("K6"):
        taps, k = _taps_shift(op)
        flat = list(taps)
        d.shift = k
        d.n_taps[0] = len(taps)
        d.fields = int(kind == "K6-wide" and 255 * sum(taps) ** 2 < FIELD_LIMIT)
    else:
        flat = []
        for j, w in enumerate(op.kernels):
            nz = [(i, int(v)) for i, v in enumerate(np.asarray(w).reshape(-1)) if v != 0]
            d.n_taps[j] = len(nz)
            flat += [x for pair in nz for x in pair]
        if kind == "K7":
            d.bias = 255 * sum(-w for row in _corr2d_weights(op) for w in row if w < 0)
        else:
            bias = _k8_field_bias(op)
            if bias is not None:
                d.bias, d.fields = bias, 1
    return d, np.asarray(chain + flat, dtype=np.int32)


def _k8_field_bias(op: StencilOp) -> int | None:
    """K8's common field bias, 255 * the largest sum|w < 0| of its kernels,
    where every kernel's biased sums, bias + sum(w * x) for u8 x, lie in
    [0, FIELD_LIMIT); else None (the sums run on i32 lanes)."""
    ws = [np.asarray(k).astype(np.int64) for k in op.kernels]
    bias = 255 * max(int(-np.minimum(w, 0).sum()) for w in ws)
    if all(bias + 255 * int(np.maximum(w, 0).sum()) < FIELD_LIMIT for w in ws):
        return bias
    return None


# The kernel sides with instantiations of their own, per kind, and K8's
# sides on 16-bit fields (sw_dispatch in the source; side 0, the tap table,
# takes the rest).
DISPATCH_SIDES = {"K6-narrow": (3, 5), "K6-wide": (3, 5, 7), "K7": (3, 5, 7), "K8": (3, 5, 7)}
K8_FIELD_SIDES = (3,)


def _forms(kind: str, side: int) -> tuple[str, ...]:
    """Where an instantiation sums: both forms where ``SwarDesc.fields``
    picks one (K6 wide's column-pass arms; K8 at a field side), else its
    only one."""
    if kind == "K6-wide" or (kind == "K8" and side in K8_FIELD_SIDES):
        return ("fields", "lanes")
    return ("lanes",) if kind == "K8" else ("fields",)


def swar_instance(d: kr.SwarDesc) -> tuple[str, int, str]:
    """The kernel instantiation sw_dispatch launches for descriptor `d`,
    from what it reads there (kind, halo, fields): the kind, the side of
    its compile-time tap loops (0: the tap table) and where it sums,
    'fields' (16-bit fields, two pixels a word) or 'lanes' (one pixel per
    i32 lane)."""
    kind = next(k for k, v in KINDS.items() if v == d.kind)
    ks = 2 * d.halo + 1
    side = ks if ks in DISPATCH_SIDES[kind] else 0
    forms = _forms(kind, side)
    return kind, side, forms[0] if d.fields or len(forms) == 1 else forms[1]


# every (kind, side, form) that sw_dispatch launches
SWAR_INSTANCES = frozenset(
    (kind, side, form)
    for kind, sides in DISPATCH_SIDES.items()
    for side in (*sides, 0)
    for form in _forms(kind, side)
)


def swar_taps(op: StencilOp) -> kr.SwarTaps:
    """The dense taps as the kernel parameters of the compile-time tap loops
    (SwarTaps) for a side of at most MAX_K: K6's 1-D taps at w[t]; K7's
    kernel and K8's first at w[dy * (2 halo + 1) + dx], K8's second at
    w[MAX_K^2 + dy * (2 halo + 1) + dx]. Zeros for larger kernels, which
    read the table."""
    taps = kr.SwarTaps()
    ks = 2 * op.halo + 1
    if ks > MAX_K:
        return taps
    if swar_kind(op).startswith("K6"):
        taps.w[:ks] = list(_taps_shift(op)[0])
        return taps
    for k, w in enumerate(op.kernels):
        at = k * MAX_K * MAX_K
        taps.w[at:at + ks * ks] = [int(v) for v in np.asarray(w).reshape(-1)]
    return taps


def window_pitch(tile_w: int, halo: int) -> int:
    """Pair words a window row holds (sw_window_pitch in the source): tile_w
    / 2 for the tile and the halo's words rounded up to 4, at least 4, so
    that a thread's 16-byte reads of words 4q .. 4q + 7 stay in the row."""
    return tile_w // 2 + ((max(halo, 4) + 3) & ~3)


def window_words(halo: int, tile_w: int = TILE_W) -> int:
    """Pair words of a window row that outputs read: output pair p reads
    words p .. p + halo."""
    return tile_w // 2 + halo


def raw_pitch(tile_w: int, halo: int) -> int:
    """Bytes a raw window row holds (sw_raw_pitch): its 16-byte granules from
    up to 15 bytes below the row's first byte, and room for the pair
    build's word reads past the window."""
    return -(-(2 * window_pitch(tile_w, halo) + 24) // 16) * 16


def swar_layout(kind: str, tile_h: int, halo: int, table_words: int = 0,
                tile_w: int = TILE_W) -> dict:
    """One block's shared memory (sw_layout in the source), in order: the
    table rounded up to 16 bytes, one 16-byte row source per window row, the
    window as pair words (`window_pitch` a row), then one scratch region:
    the raw window (`raw_pitch` bytes a row), or K6's row pass (tile_w / 2
    words a row) where that is larger."""
    eh = tile_h + 2 * halo
    wp, rp = window_pitch(tile_w, halo), raw_pitch(tile_w, halo)
    rows_off = ((table_words + 3) & ~3) * 4
    win_off = rows_off + eh * 16
    scratch_off = win_off + eh * wp * 4
    row_pass = eh * (tile_w // 2) * 4 if kind.startswith("K6") else 0
    total = scratch_off + max(eh * rp, row_pass)
    return dict(wp=wp, rp=rp, rows_off=rows_off, win_off=win_off, scratch_off=scratch_off,
                total=total)


def swar_smem_bytes(kind: str, tile_h: int, halo: int, table_words: int = 0,
                    tile_w: int = TILE_W) -> int:
    """Dynamic shared memory of one block (`swar_layout`)."""
    return swar_layout(kind, tile_h, halo, table_words, tile_w)["total"]


def swar_grid(height: int, width: int, tile_h: int, tile_w: int = TILE_W) -> tuple[int, int]:
    """The kernels' grid: (column tiles, row tiles)."""
    return -(-width // tile_w), -(-height // tile_h)


def pick_tile_h(kind: str, halo: int, block_h: int | None = None, table_words: int = 0,
                tile_w: int = TILE_W) -> int:
    """The output tile height for `tile_w` columns: `block_h` when given
    (raising if its shared memory exceeds a block's), else DEFAULT_TILE_H
    (64 rows: on the 8K gray plane 64-row tiles ran K6, K7 and K8 2-9%
    faster than 32-row ones, 1.5-1.8x faster than 8-row ones, H100 80GB
    HBM3 at 700 W, chip_smoke.py's sweep) halved until it fits."""
    if block_h is not None:
        if block_h < 1:
            raise ValueError(f"tile height must be >= 1, got {block_h}")
        nbytes = swar_smem_bytes(kind, block_h, halo, table_words, tile_w)
        if nbytes > ck.MAX_SMEM_BYTES:
            raise ValueError(
                f"tile height {block_h} needs {nbytes} B of shared memory "
                f"(at most {ck.MAX_SMEM_BYTES})"
            )
        return block_h
    def fits(rows):
        return swar_smem_bytes(kind, rows, halo, table_words, tile_w) <= ck.MAX_SMEM_BYTES

    tile_h = DEFAULT_TILE_H
    while tile_h > 1 and not fits(tile_h):
        tile_h //= 2
    if not fits(tile_h):
        raise ValueError(f"halo {halo} needs more shared memory than a block has")
    return tile_h


@functools.lru_cache(maxsize=4096)
def swar_tile_shape(kind: str, halo: int, height: int, width: int, block_h: int | None = None,
                    table_words: int = 0, calibrated: tuple | None = None) -> tuple[int, int]:
    """The (rows, cols) output tile of one launch over an (height, width)
    plane. Columns: TILE_W, narrowed to 64 while the grid has fewer than
    N_SMS blocks and the narrower tile adds blocks, or where no tile TILE_W
    wide fits the shared memory (a halo past 100). Rows: `block_h` when
    given, else `pick_tile_h`'s, then halved (down to 8) while the grid has
    fewer than 2 N_SMS blocks and halving adds blocks: a tall tile reads
    fewer context rows, (rows + 2 halo) / rows, and a short one gives a
    short plane (a shard, an overlap band) enough blocks. Where `block_h` is
    None, `calibrated` (rows, channels) of a block_h record taken on a gray
    plane (channels 1 or None) is taken as `block_h` if the shared memory
    and the grid allow it. Raises where the shared memory or the grid's
    height does not allow the tile."""
    if block_h is None and calibrated is not None and calibrated[1] in (None, 1):
        try:
            return swar_tile_shape(kind, halo, height, width, calibrated[0], table_words)
        except ValueError:
            pass  # a record that does not fit this launch costs time, never a launch
    for cols in TILE_WIDTHS:
        try:
            rows = pick_tile_h(kind, halo, block_h, table_words, cols)
            break
        except ValueError:
            if cols == TILE_WIDTHS[-1]:
                raise
    for narrower in TILE_WIDTHS[TILE_WIDTHS.index(cols) + 1:]:
        gx, gy = swar_grid(height, width, rows, cols)
        if gx * gy >= ck.N_SMS:
            break
        if -(-width // narrower) > gx:
            cols = narrower
    if block_h is None:
        while rows > TILE_ROWS[-1]:
            gx, gy = swar_grid(height, width, rows, cols)
            if gx * gy >= 2 * ck.N_SMS or -(-height // (rows // 2)) == gy:
                break
            rows //= 2
    if swar_grid(height, width, rows, cols)[1] > ck._MAX_GRID_Y:
        raise ValueError(f"plane height {height} needs a taller tile than {rows}")
    return rows, cols


class SwarGroup:
    """One ``[pre*, stencil, post*]`` group as the SWAR kernels take it,
    built once (``swar_group``): its kind, fitted chains, descriptor and
    int32 table, dense taps, and per card the descriptor pointing at the
    table's copy there."""

    def __init__(self, op: StencilOp, pre_ops: tuple, post_ops: tuple):
        self.ops = (op, pre_ops, post_ops)  # held, so that the ids in the cache's key stay theirs
        self.op = op
        self.pre_chain = tuple(_require_fusable(o) for o in pre_ops)
        self.post_chain = tuple(_require_fusable(o) for o in post_ops)
        self.kind = swar_kind(op)
        self.desc, self.table = swar_desc(op, self.pre_chain, self.post_chain)
        self.taps = swar_taps(op)
        self.taps_ref = ctypes.byref(self.taps)
        self._descs: dict[torch.device, tuple] = {}

    def desc_ref(self, device: torch.device):
        """A reference to the descriptor whose table pointer is the table's
        copy on `device` (made at the first call for the card)."""
        hit = self._descs.get(device)
        if hit is None:
            d = kr.SwarDesc.from_buffer_copy(self.desc)
            d.table = ck.device_table(self.table, device).data_ptr() if self.table.size else None
            hit = self._descs[device] = (d, ctypes.byref(d))
        return hit[1]

    def shape(self, height: int, width: int, block_h: int | None,
              calibrated: tuple | None = None) -> tuple[int, int]:
        return swar_tile_shape(self.kind, self.op.halo, height, width, block_h, self.table.size,
                               calibrated)


# groups by the identity of their ops (frozen dataclasses, held by the
# entries): two groups whose ops encode to equal bytes are still two keys
_GROUPS: dict[tuple, SwarGroup] = {}


def swar_group(op: StencilOp, pre_ops=(), post_ops=()) -> SwarGroup:
    """The encoded group of `op` with `pre_ops` before it and `post_ops`
    after it, cached on the ops' identity."""
    pre_ops, post_ops = tuple(pre_ops), tuple(post_ops)
    key = (id(op), tuple(map(id, pre_ops)), tuple(map(id, post_ops)))
    group = _GROUPS.get(key)
    if group is None:
        group = SwarGroup(op, pre_ops, post_ops)
        if len(_GROUPS) >= ck._CACHE_LIMIT:
            _GROUPS.clear()
        _GROUPS[key] = group
    return group


# --------------------------------------------------------------------------
# K6, K7, K8: plain version and wrapper
# --------------------------------------------------------------------------


def _check_args(op: StencilOp, stack: torch.Tensor, ghosts) -> None:
    plane = tuple(stack.shape[1:])
    if stack.ndim != 3 or stack.dtype != U8:
        raise ValueError(f"the SWAR kernels take one u8 plane an image, got {plane} {stack.dtype}")
    if not _shape_ok(op, plane):
        raise ValueError(f"op {op.name!r} cannot run on a {plane} plane (SWAR gates)")
    if ghosts is not None and stack.shape[0] != 1:
        raise ValueError("ghost mode takes one row-shard, not a stack")
    if ghosts is not None:
        want = (op.halo, stack.shape[2])
        for name, strip in zip(("top", "bottom"), ghosts):
            if tuple(strip.shape) != want or strip.dtype != U8 or strip.device != stack.device:
                raise ValueError(
                    f"{name} strip {tuple(strip.shape)} {strip.dtype} on {strip.device}; "
                    f"the tile needs {want} uint8 on {stack.device}"
                )


def swar_stencil_plain(
    op: StencilOp,
    img: torch.Tensor,
    *,
    pre_chain=(),
    post_chain=(),
    ghosts: tuple[torch.Tensor, torch.Tensor] | None = None,
    y0: int | None = None,
    global_h: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6, K7 and K8: the same integer forms on
    int32 tensors. The plane (with the ghost strips above and below it, in
    ghost mode) is padded per the op's mode, the fitted pre-chain maps every
    pixel, pad included; then K6's row and column sums with the narrow
    shift rounding or the wide float32 replay, K7's biased sums with the
    clip, or K8's signed sums with the golden combine, scale and quantizer
    (the magnitude's root through float64, as spec.StencilOp.valid takes
    it); the interior guard at global rows; the post-chain."""
    h = op.halo
    kind = swar_kind(op)
    height, width = img.shape
    if ghosts is not None:
        x = torch.cat([ghosts[0], img, ghosts[1]], dim=0)
        xp = pad2d(x.to(F32), op.edge_mode, 0, 0, h, h)
    else:
        xp = pad2d(img.to(F32), op.edge_mode, h, h, h, h)
    xp = affine_int(xp.to(torch.int32), pre_chain)

    def win(dy: int, dx: int) -> torch.Tensor:
        return xp[dy : dy + height, dx : dx + width]

    if kind.startswith("K6"):
        taps, k = _taps_shift(op)
        row = sum(t * xp[:, i : i + width] for i, t in enumerate(taps))
        s = sum(t * row[i : i + height] for i, t in enumerate(taps))
        if kind == "K6-narrow":
            q = (s + ((1 << (k - 1)) - 1) + ((s >> k) & 1)) >> k
        else:
            q = rint_clip_f32(s.to(F32) * _f32(op.scale)).to(torch.int32)
    elif kind == "K7":
        weights = _corr2d_weights(op)
        bias = 255 * sum(-w for row in weights for w in row if w < 0)
        pos = sum(w * win(dy, dx) for dy, r in enumerate(weights) for dx, w in enumerate(r) if w > 0)
        neg = sum(-w * win(dy, dx) for dy, r in enumerate(weights) for dx, w in enumerate(r) if w < 0)
        q = torch.clamp(((bias + pos) - neg) - bias, 0, 255)
    else:
        accs = []
        for kern in op.kernels:
            w = np.asarray(kern).astype(np.int64)
            accs.append(sum(int(w[dy, dx]) * win(dy, dx)
                            for dy in range(w.shape[0]) for dx in range(w.shape[1]) if w[dy, dx]))
        acc = accs[0].to(F32)
        if op.combine == "magnitude":
            b = accs[1].to(F32)
            acc = torch.sqrt((acc * acc + b * b).to(torch.float64)).to(F32)
        if op.scale != 1.0:
            acc = acc * _f32(op.scale)
        q = QUANTIZERS_F32[op.quantize](acc).to(torch.int32)
    if op.edge_mode == "interior":
        mask = op.interior_mask(
            (height, width), y0 or 0, 0, global_h or height, width, img.device
        )
        q = torch.where(mask, q, win(h, h))
    return affine_int(q, post_chain).to(U8)


@ck.takes_stack
def swar_stencil(
    op: StencilOp,
    stack: torch.Tensor,
    *,
    pre_ops=(),
    post_ops=(),
    ghosts: tuple[torch.Tensor, torch.Tensor] | None = None,
    y0: int | None = None,
    global_h: int | None = None,
    block_h: int | None = None,
    calibrated: tuple | None = None,
) -> torch.Tensor:
    """One eligible stencil (``swar_any_eligible``) on a stack of (H, W) u8
    planes through its SWAR kernel, with the fusable pointwise ops
    `pre_ops` before it and `post_ops` after it inside the same launch,
    which takes every plane on its batch axis
    (``cuda_kernels.batch_geometry``).

    Ghost mode, for the sharded runner (one plane): `ghosts` = (top, bottom), the raw
    (halo, W) strips above and below the tile (exchanged, or the edge
    extension on the first and last shard); `y0` is the tile's first global
    row and `global_h` the image height, which the interior guard follows.
    `block_h` sets the output tile height (`swar_tile_shape`; where it is
    None, a `calibrated` record's where it applies). The group's
    encoding and launch shape are cached (`swar_group`). On a CPU tensor the
    plain version runs; on a CUDA tensor the kernel launches or this
    raises."""
    group = swar_group(op, pre_ops, post_ops)
    _check_args(op, stack, ghosts)
    n, height, width = stack.shape
    tile_h, tile_w = group.shape(height, width, block_h, calibrated)
    if global_h is not None and y0 is not None and not 0 <= y0 <= global_h - height:
        raise ValueError(f"tile rows [{y0}, {y0 + height}) lie outside an image of {global_h}")
    dev = stack.device
    if dev.type == "cpu":
        plain = functools.partial(
            swar_stencil_plain, op, pre_chain=group.pre_chain, post_chain=group.post_chain,
            ghosts=ghosts, y0=y0, global_h=global_h,
        )
        return ck.per_image(plain, stack)
    ck._check_cuda_input(stack)  # only contiguous: planes at a fixed stride
    n, in_stride, out_stride = ck.batch_geometry(n, height, width, 1, 1)
    top = bottom = None
    if ghosts is not None:
        top, bottom = ghosts
        for t in ghosts:
            ck._check_cuda_input(t)
    out = torch.empty_like(stack)
    rc = kr.load("swar_stencil").swar_stencil_launch(
        stack.data_ptr(), None if top is None else top.data_ptr(),
        None if bottom is None else bottom.data_ptr(), out.data_ptr(), height, width,
        y0 or 0, global_h or height, group.desc_ref(dev), group.taps_ref, tile_h, tile_w,
        n, in_stride, out_stride, dev.index, ck.stream_handle(dev),
    )
    ck._raise_on(rc, "swar_stencil")
    ck.SWAR_LAUNCHES[group.kind if ghosts is None else _GHOST_KEYS[group.kind]] += 1
    return out


# --------------------------------------------------------------------------
# Pipeline runner
# --------------------------------------------------------------------------


@ck.takes_stack
def pipeline_swar(ops, stack: torch.Tensor, *, block_h: int | None = None,
                  calibrated: tuple | None = None) -> torch.Tensor:
    """Run a pipeline with every eligible ``[pre*, stencil, post*]`` group
    on its SWAR kernel and every other op through the K1/K2 group runner:
    the same bytes as the golden ops on any pipeline.

    The fallback takes maximal runs of ops, not single ops, so that its own
    group fusion (a pointwise prologue inside the stencil launch) is kept.
    `block_h` sets the SWAR kernels' tile height only (where it is None, a
    `calibrated` record's does where it applies); the fallback picks its
    own. Every group (SWAR or fallback) is one launch over the stack."""
    pending: list[Op] = []

    def flush(im):
        if pending:
            im = ck.pipeline_cuda(tuple(pending), im, block_h=None, batched=True)
            pending.clear()
        return im

    def fusable(o):
        return swar_fusable(o) is not None

    n = len(ops)
    i = 0
    while i < n:
        # try to form a fused group starting here: [pre*] stencil [post*]
        j = i
        pre: list[Op] = []
        while j < n and fusable(ops[j]):
            pre.append(ops[j])
            j += 1
        if j < n and swar_any_eligible(ops[j]):
            st = ops[j]
            end = post_chain_end(ops, j + 1)
            post = list(ops[j + 1 : end])
            j = end
            # a pre-chain commutes with zero padding only if it fixes 0;
            # reflect101 and edge pads are image values and always commute
            pre_ok = not pre or st.edge_mode != "zero" or _chain_fixes_zero(pre)
            stack = flush(stack)  # the shape gate needs the actual input
            if (
                pre_ok
                and stack.dtype == U8
                and stack.ndim == 3
                and swar_any_eligible(st, tuple(stack.shape[1:]))
            ):
                stack = swar_stencil(st, stack, pre_ops=tuple(pre), post_ops=tuple(post),
                                     block_h=block_h, calibrated=calibrated, batched=True)
            else:
                # the whole group falls back as one run
                pending.extend(pre)
                pending.append(st)
                pending.extend(post)
            i = j
            continue
        # no eligible stencil follows this position: ops[i] joins the
        # fallback run (a later iteration tries again from i + 1)
        pending.append(ops[i])
        i += 1
    return flush(stack)
