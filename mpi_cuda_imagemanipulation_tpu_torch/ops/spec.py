"""Op specifications in PyTorch — the golden u8 semantics of every op.

Each op is a small frozen dataclass whose methods are plain functions on
tensors. The golden path (``op(img)``) is the oracle; the hand-written CUDA
kernels (``ops/cuda_kernels.py``) reproduce it byte for byte, and their
plain PyTorch versions are built from the same functions here.

Numeric semantics follow the reference's ``kernel.cu`` (truncating per-term
grayscale, contrast 3.5 with clamp, interior-only emboss guard), with the
in-place emboss race resolved to the double-buffered reading and the
guard shrunk to in-bounds neighbourhoods. All stencil weights are integers
(``ops/filters.py``), accumulated exactly in float32, with normalisation by
a single multiply — so any summation order gives the same bits.

Two rules keep the float32 arithmetic identical on every device:

* every constant is a float32 value (``_f32``), and each elementwise step
  is its own tensor op, so nothing fuses into a multiply-add;
* ``magnitude``'s square root goes through float64. ``torch.sqrt`` on a
  float32 CPU tensor is not correctly rounded on every vector path; the
  float64 root of a float32 value, rounded back to float32, is (53 >= 2*24+2).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, ClassVar

import numpy as np
import torch
import torch.nn.functional as F

U8 = torch.uint8
F32 = torch.float32


def _f32(v) -> float:
    """`v` rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(v))


# --------------------------------------------------------------------------
# Quantizers: f32 -> u8-valued f32
# --------------------------------------------------------------------------


def trunc_clip_f32(x: torch.Tensor) -> torch.Tensor:
    """C semantics of assigning a clamped float to uchar (kernel.cu:19-24,91):
    clamp to [0, 255] then truncate toward zero."""
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def rint_clip_f32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, then clamp (the non-reference filter bank)."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


QUANTIZERS_F32: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "trunc_clip": trunc_clip_f32,
    "rint_clip": rint_clip_f32,
}

# --------------------------------------------------------------------------
# Tile machinery
# --------------------------------------------------------------------------


def exact_f32(t: torch.Tensor) -> torch.Tensor:
    """Integer-valued data as float32 (exact for u8); no-op on float32."""
    return t if t.dtype == F32 else t.to(F32)


def corr_valid(xpad: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Valid-mode 2-D correlation by static shifts, ``w[dy, dx]`` indexing.

    ``xpad`` is (H + kh - 1, W + kw - 1); returns float32 (H, W). Taps are
    summed in row-major order starting from the first nonzero tap, and
    zero taps are skipped — the order the CUDA kernel keeps, which matters
    only for non-integer weights."""
    kh, kw = weights.shape
    out_h = xpad.shape[-2] - (kh - 1)
    out_w = xpad.shape[-1] - (kw - 1)
    xf = exact_f32(xpad)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            w = _f32(weights[dy, dx])
            if w == 0.0:
                continue
            win = xf[..., dy : dy + out_h, dx : dx + out_w]
            term = win if w == 1.0 else win * w
            acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros(xpad.shape[:-2] + (out_h, out_w), dtype=F32, device=xpad.device)
    return acc


def separable_valid(xpad: torch.Tensor, w1d: np.ndarray) -> torch.Tensor:
    """A (1, k) pass then a (k, 1) pass; bit-identical to the 2-D outer
    product for integer weights."""
    row = np.asarray(w1d, dtype=np.float32).reshape(1, -1)
    col = np.asarray(w1d, dtype=np.float32).reshape(-1, 1)
    return corr_valid(corr_valid(xpad, row), col)


def window_reduce_1d(
    xpad: torch.Tensor, k: int, axis: int, fn: Callable
) -> torch.Tensor:
    """Valid-mode sliding min/max of width k along one axis."""
    out_len = xpad.shape[axis] - (k - 1)
    xf = exact_f32(xpad)
    acc = None
    for d in range(k):
        win = xf.narrow(axis, d, out_len)
        acc = win if acc is None else fn(acc, win)
    return acc


# Paeth's 19-exchange median-of-9 selection network: after these exchanges
# p[4] holds the median.
_MEDIAN9_EXCHANGES = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
    (4, 2),
)


def _oddeven_merge_pairs(n: int) -> list[tuple[int, int]]:
    """Batcher odd-even mergesort comparator pairs for arbitrary n (the
    standard iterative clipped construction)."""
    pairs: list[tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _prune_to_median(pairs: list[tuple[int, int]], n: int) -> tuple:
    """Drop comparators whose outputs never reach the median wire n//2
    (140 -> 113 comparators for n=25)."""
    needed = {n // 2}
    kept = []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.add(i)
            needed.add(j)
    return tuple(reversed(kept))


# size -> (exchange network, median wire index). The CUDA stencil kernel
# bakes the same pair lists into its source (ops/csrc/stream_stencil.cu);
# a test holds the two equal.
MEDIAN_NETWORKS = {
    3: (_MEDIAN9_EXCHANGES, 4),
    5: (_prune_to_median(_oddeven_merge_pairs(25), 25), 12),
}


def median_valid(xpad: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Valid-mode size x size median via a min/max selection network."""
    exchanges, mid = MEDIAN_NETWORKS[size]
    out_h = xpad.shape[0] - (size - 1)
    out_w = xpad.shape[1] - (size - 1)
    xf = exact_f32(xpad)
    p = [
        xf[dy : dy + out_h, dx : dx + out_w]
        for dy in range(size)
        for dx in range(size)
    ]
    for i, j in exchanges:
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[mid]


_PAD_MODES = {
    "interior": "constant",  # padding value irrelevant: masked by finalize
    "zero": "constant",
    "reflect101": "reflect",  # OpenCV BORDER_REFLECT_101
    "edge": "replicate",
}


def pad2d(
    xf: torch.Tensor,
    edge_mode: str,
    top: int,
    bottom: int,
    left: int,
    right: int,
) -> torch.Tensor:
    """Pad a float32 (H, W) tile, or each of a stack of them (..., H, W),
    on each side per the op's edge mode. ``F.pad``'s reflect/replicate
    modes need a leading batch dimension.

    ``F.pad`` refuses a reflection at least as wide as the side it
    reflects; ``jnp.pad`` (the JAX package's golden padding) reflects
    again and again. Such pads take the same indices here, by
    ``reflect101_index``."""
    if (top, bottom, left, right) == (0, 0, 0, 0):
        return xf
    lead = xf.shape[:-2]
    height, width = xf.shape[-2:]
    if edge_mode == "reflect101" and (max(top, bottom) >= height or max(left, right) >= width):
        rows = reflect101_index(height, top, bottom, xf.device)
        cols = reflect101_index(width, left, right, xf.device)
        return xf[..., rows, :][..., cols]
    out = F.pad(xf.reshape((math.prod(lead), 1, height, width)), (left, right, top, bottom),
                mode=_PAD_MODES[edge_mode])
    return out.reshape(lead + out.shape[-2:])


def reflect101_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """Source indices of an axis of length `n` padded by `before` and
    `after` in reflect-101 (numpy's 'reflect'), for pads of any width:
    reflection is periodic with period 2 (n - 1), and a single sample
    repeats."""
    c = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(c)
    period = 2 * (n - 1)
    c = torch.remainder(c, period)
    return torch.where(c >= n, period - c, c)


# --------------------------------------------------------------------------
# Op dataclasses
# --------------------------------------------------------------------------

# Opcodes of the pointwise program the CUDA kernels interpret
# (ops/csrc/pointwise.cuh holds the same numbers; a test holds them equal).
PW_GRAYSCALE = 0
PW_GRAYSCALE601 = 1
PW_SEPIA = 2
PW_GRAY2RGB = 3
PW_CONTRAST = 4
PW_BRIGHTNESS = 5
PW_INVERT = 6
PW_THRESHOLD = 7
PW_POSTERIZE = 8
PW_SOLARIZE = 9


@dataclasses.dataclass(frozen=True)
class PointwiseOp:
    """Per-pixel op. `core` is an elementwise f32 -> f32 function over exact
    u8 integer values; 3->1 and 3->3 channel ops set `planes_core` instead.
    `program` is the op's instruction for the CUDA kernels' pointwise
    interpreter: (opcode, p0, p1). Ops without one (the lookup-table ops)
    are not `kernel_safe` and run as a plain gather between kernel groups."""

    family: ClassVar[str] = "pointwise"
    halo: ClassVar[int] = 0

    name: str
    in_channels: int  # 3, 1, or 0 (= any)
    out_channels: int  # 3, 1, or 0 (= same as input)
    fn: Callable[[torch.Tensor], torch.Tensor]  # u8 -> u8
    core: Callable[[torch.Tensor], torch.Tensor] | None = None
    planes_core: Callable | None = None
    program: tuple[int, float, float] | None = None
    lut_host: Callable[[], np.ndarray] | None = None

    @property
    def kernel_safe(self) -> bool:
        return self.program is not None

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        _check_channels(self.name, self.in_channels, img)
        return self.fn(img)


def pointwise_from_core(
    name: str,
    in_channels: int,
    out_channels: int,
    core: Callable,
    program: tuple[int, float, float],
    lut_host: Callable[[], np.ndarray] | None = None,
) -> PointwiseOp:
    """A PointwiseOp whose u8 path is cast -> core -> cast (lossless: core
    maps exact u8 integers to exact u8 integers)."""

    def fn(img: torch.Tensor) -> torch.Tensor:
        return core(img.to(F32)).to(U8)

    return PointwiseOp(
        name, in_channels, out_channels, fn=fn, core=core, program=program,
        lut_host=lut_host,
    )


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """Neighbourhood op over a (H, W) plane or per channel over (H, W, C).

    kernels  : static correlation weight matrices, ``w[dy, dx]``.
    separable: optional 1-D weight vector for a bit-identical fast path.
    scale    : single post-accumulation multiply.
    combine  : 'single' or 'magnitude' (sqrt(a0^2 + a1^2)).
    reduce   : 'corr', 'min'/'max' (square window) or 'median' (3x3/5x5).
    edge_mode: 'interior' (reference guard: non-interior pixels pass the
               input through), 'reflect101', 'edge' or 'zero'.
    quantize : 'trunc_clip' or 'rint_clip'.
    """

    family: ClassVar[str] = "stencil"
    in_channels: ClassVar[int] = 0  # any; colour images filter per channel
    out_channels: ClassVar[int] = 0  # same as input

    name: str
    halo: int
    kernels: tuple
    scale: float = 1.0
    separable: np.ndarray | None = None
    combine: str = "single"
    reduce: str = "corr"
    edge_mode: str = "interior"
    quantize: str = "trunc_clip"

    def valid(self, xpad: torch.Tensor) -> torch.Tensor:
        """float32 (H+2h, W+2h) -> float32 (H, W): correlate, combine, scale."""
        if self.reduce in ("min", "max"):
            fn = torch.minimum if self.reduce == "min" else torch.maximum
            kh, kw = self.kernels[0].shape
            return window_reduce_1d(window_reduce_1d(xpad, kw, 1, fn), kh, 0, fn)
        if self.reduce == "median":
            return median_valid(xpad, self.kernels[0].shape[0])
        if self.separable is not None:
            accs = [separable_valid(xpad, self.separable)]
        else:
            accs = [corr_valid(xpad, k) for k in self.kernels]
        if self.combine == "single":
            acc = accs[0]
        elif self.combine == "magnitude":
            sq = accs[0] * accs[0] + accs[1] * accs[1]
            acc = torch.sqrt(sq.to(torch.float64)).to(F32)
        else:  # pragma: no cover
            raise ValueError(f"unknown combine {self.combine!r}")
        if self.scale != 1.0:
            acc = acc * _f32(self.scale)
        return acc

    def finalize_f32(
        self,
        acc: torch.Tensor,
        orig_f32: torch.Tensor,
        y0: int,
        x0: int,
        global_h: int,
        global_w: int,
    ) -> torch.Tensor:
        """Quantize (exact u8 values in f32) and, for 'interior' mode, pass
        through non-interior pixels; (y0, x0) are the tile's global offsets."""
        q = QUANTIZERS_F32[self.quantize](acc)
        if self.edge_mode != "interior":
            return q
        mask = self.interior_mask(acc.shape, y0, x0, global_h, global_w, acc.device)
        return torch.where(mask, q, orig_f32)

    def interior_mask(self, shape, y0, x0, global_h, global_w, device=None):
        """Reference guard (kernel.cu:83): x > o && x <= W-1-o (likewise y),
        in global image coordinates; an (h, w) mask for a `shape` whose last
        two axes are (h, w) (a stack's planes share it)."""
        h, w = shape[-2:]
        yy = (y0 + torch.arange(h, device=device)).view(h, 1)
        xx = (x0 + torch.arange(w, device=device)).view(1, w)
        o = self.halo
        return (xx > o) & (xx <= global_w - 1 - o) & (yy > o) & (yy <= global_h - 1 - o)

    def finalize(self, acc, orig_u8, y0, x0, global_h, global_w) -> torch.Tensor:
        return self.finalize_f32(
            acc, orig_u8.to(F32), y0, x0, global_h, global_w
        ).to(U8)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        _check_channels(self.name, self.in_channels, img)
        if img.ndim == 3:  # colour: filter each channel plane independently
            return torch.stack(
                [self._apply2d(img[..., c]) for c in range(img.shape[2])], dim=-1
            )
        return self._apply2d(img)

    def _apply2d(self, img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape
        o = self.halo
        xpad = pad2d(img.to(F32), self.edge_mode, o, o, o, o)
        return self.finalize(self.valid(xpad), img, 0, 0, h, w)


@dataclasses.dataclass(frozen=True)
class GeometricOp:
    """Shape-changing data-movement op (flip, rotate, transpose, crop, pad,
    resize; ops/geometry.py). `fn` is the one definition every backend
    runs: gathers, plus for resize and rotate a fixed-point lerp whose
    indices and weights are built on the host in float64, so the result is
    exact data movement plus exact float32 sums.

    Every route runs it as a step of its own between kernel groups
    (`kernel_safe=False`, like the lookup-table ops), and the sharded
    runner runs it on the whole image between sharded segments. Its output
    is always a contiguous tensor: the kernels refuse views."""

    family: ClassVar[str] = "geometric"

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]  # u8 -> u8, shape may change
    in_channels: int = 0
    out_channels: int = 0
    halo: int = 0
    kernel_safe: bool = False

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        _check_channels(self.name, self.in_channels, img)
        return self.fn(img)


@dataclasses.dataclass(frozen=True)
class GlobalOp:
    """Op whose per-pixel transform depends on a whole-image statistic
    (equalize, autocontrast, otsu; ops/histogram.py), split into two pieces
    every route composes the same way:

      stats(img, valid) -> int32[256]  counts over the image; `valid`
                                       (broadcastable to img, 0/1) masks
                                       rows that are sharding padding
      apply(img, stats) -> u8 image    pointwise given the statistic

    The statistic is additive: the sharded runner sums each tile's masked
    counts over the slots and ranks (integers, so the sum is exact) and
    applies the same function of it on every tile."""

    family: ClassVar[str] = "global-stat"

    name: str
    stats: Callable  # (u8 img, valid mask or None) -> int32 vector
    apply: Callable  # (u8 img, int32 stats) -> u8 img
    in_channels: int = 1
    out_channels: int = 0
    halo: int = 0
    kernel_safe: bool = False

    def fn(self, img: torch.Tensor) -> torch.Tensor:
        return self.apply(img, self.stats(img, None))

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        _check_channels(self.name, self.in_channels, img)
        return self.fn(img)


Op = PointwiseOp | StencilOp | GeometricOp | GlobalOp


def chain_halo(ops) -> int:
    """Total row context a chain of ops needs on each side of a region to
    reproduce the whole-image result there exactly: the sum of the per-op
    halos (op k's halo-h output row depends on op k-1's output h rows
    further out, and so on down the chain). A fused plan stage grows its
    halo once by this amount instead of extending the image per op."""
    return sum(op.halo for op in ops)


def _check_channels(name: str, want: int, img: torch.Tensor) -> None:
    got = img.shape[2] if img.ndim == 3 else 1
    if want and got != want:
        raise ValueError(
            f"op {name!r} expects a {want}-channel image, got shape {tuple(img.shape)}"
        )


# --------------------------------------------------------------------------
# The stack form: one image is a stack of one
# --------------------------------------------------------------------------


def per_image(fn, stack: torch.Tensor) -> torch.Tensor:
    """`fn` applied to each image of a stack, stacked: the plain versions,
    and the ops that have no batched form (geometric and global-statistics
    ops, lookup tables), which see one image each, as under the JAX
    package's vmap (statistics reduce per image). A stack of one is not
    copied."""
    if stack.shape[0] == 1:
        return fn(stack[0])[None]
    return torch.stack([fn(x) for x in stack])


def one_image(fn):
    """The image -> image form of a stack -> stack function `fn` (its last
    positional argument the stack): one image runs as a stack of one."""

    def run(*args, **kw):
        return fn(*args[:-1], args[-1][None], **kw)[0]

    return functools.update_wrapper(run, fn)


def takes_stack(fn):
    """`fn` is written for a contiguous (N, H, W[, C]) stack of same-shape
    images, its last positional argument. The function returned takes one
    image (as a stack of one), or a stack as it is with ``batched=True``:
    the one place where the two forms part."""
    one = one_image(fn)

    @functools.wraps(fn)
    def call(*args, batched: bool = False, **kw):
        return fn(*args, **kw) if batched else one(*args, **kw)

    return call
