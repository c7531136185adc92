"""Geometric ops: flip, rotate, transpose, crop, pad, resize. The counterpart
of the JAX package's ``ops/geometry.py``.

  * flips, quarter turns, transpose, crop and pad are data movement;
  * resize is 4-tap bilinear with 8-bit fixed-point weights built on the
    host in float64, chosen so every float32 product and sum on the device
    is an exact integer below 2^24 (`_linear_taps`); the device work is
    gathers and one weighted sum;
  * rotate is the same scheme over four flat gathers (`_rotate_maps`).

Half-pixel centre convention (``src = (dst + 0.5) * in/out - 0.5``), the
sampling grid of OpenCV's ``INTER_LINEAR`` and PIL's ``BILINEAR``; edge taps
clamp. Nearest mode rounds the same grid down.

Every op returns a contiguous tensor. ``Tensor.transpose``, a crop and
``rot90``-style swaps give views in PyTorch, and ``torch.flip`` (a negative
stride does not exist in PyTorch, so flips copy) keeps its input's strides:
the flip of a transposed or otherwise permuted image is permuted too. The
hand-written kernels that run after a geometric op refuse such tensors
(``cuda_kernels._check_cuda_input``, "the kernels take contiguous images");
the plain versions on the CPU accept any strides, so only the card would
show a missing copy.

The host-built maps are the counterparts of weights: they are built with the
JAX package's numpy code, not with ``torch.sin``/``torch.cos``, whose float64
results can differ by an ulp and move a ``floor``. They are cached per
shape, angle, method and device and uploaded once: at 8K a bilinear rotate
holds four taps of int32 index and float32 weight, about 1.06 GB on the
card, which a rebuild per call would spend seconds of host time on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    U8,
    GeometricOp,
    rint_clip_f32,
)

# maps kept per (shape, size or angle, method, device): a resize's are a
# few rows and columns, an 8K bilinear rotate's about 1.06 GB on the card
_RESIZE_CACHE_SIZE = 16
_ROTATE_CACHE_SIZE = 4

# --------------------------------------------------------------------------
# Data-movement ops
# --------------------------------------------------------------------------


def _fliph(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (1,)).contiguous()  # flip keeps a permuted input's strides


def _flipv(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (0,)).contiguous()


def _transpose(img: torch.Tensor) -> torch.Tensor:
    return img.transpose(0, 1).contiguous()


def _rot90(img: torch.Tensor) -> torch.Tensor:
    # the flip of the transposed view is itself column-major
    return torch.flip(img.transpose(0, 1), (1,)).contiguous()


def _rot180(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (0, 1)).contiguous()


def _rot270(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img.transpose(0, 1), (0,)).contiguous()


FLIP_H = GeometricOp("fliph", _fliph)
FLIP_V = GeometricOp("flipv", _flipv)
TRANSPOSE = GeometricOp("transpose", _transpose)

# clockwise rotations, named by angle
ROT90 = GeometricOp("rot90", _rot90)
ROT180 = GeometricOp("rot180", _rot180)
ROT270 = GeometricOp("rot270", _rot270)


def make_crop(y0: int, x0: int, h: int, w: int) -> GeometricOp:
    if h <= 0 or w <= 0 or y0 < 0 or x0 < 0:
        raise ValueError(f"invalid crop y0={y0} x0={x0} h={h} w={w}")

    def fn(img: torch.Tensor) -> torch.Tensor:
        ih, iw = img.shape[0], img.shape[1]
        if y0 + h > ih or x0 + w > iw:
            raise ValueError(
                f"crop [{y0}:{y0 + h}, {x0}:{x0 + w}] exceeds image {ih}x{iw}"
            )
        return img[y0 : y0 + h, x0 : x0 + w].contiguous()  # a view until copied

    return GeometricOp(f"crop{y0}_{x0}_{h}_{w}", fn)


_PAD_NP_MODES = {"zero": "constant", "reflect101": "reflect", "edge": "edge"}


@functools.lru_cache(maxsize=_RESIZE_CACHE_SIZE)
def _pad_index(size: int, n: int, np_mode: str, device: torch.device) -> torch.Tensor:
    """Source indices of an axis of length `size` padded by `n` on each
    side, by numpy's own rule (``np.pad`` of the index vector), on
    `device`: 'reflect' and 'edge' accept `n` past the side, reflecting
    again, as ``jnp.pad`` does, where ``F.pad`` refuses."""
    index = np.pad(np.arange(size, dtype=np.int64), (n, n), mode=np_mode)
    return torch.from_numpy(index).to(device)


def make_pad(n: int, mode: str = "zero") -> GeometricOp:
    if n <= 0:
        raise ValueError(f"pad amount must be positive, got {n}")
    if mode not in _PAD_NP_MODES:
        raise ValueError(f"unknown pad mode {mode!r}; known: {sorted(_PAD_NP_MODES)}")

    def fn(img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[0], img.shape[1]
        if mode == "zero":
            out = img.new_zeros((h + 2 * n, w + 2 * n) + tuple(img.shape[2:]))
            out[n : n + h, n : n + w] = img
            return out
        # F.pad refuses u8 and pads past the side: an index gather instead
        rows = _pad_index(h, n, _PAD_NP_MODES[mode], img.device)
        cols = _pad_index(w, n, _PAD_NP_MODES[mode], img.device)
        return img.index_select(0, rows).index_select(1, cols)

    return GeometricOp(f"pad{n}_{mode}", fn)


# --------------------------------------------------------------------------
# Resize
# --------------------------------------------------------------------------


WEIGHT_BITS = 8  # fixed-point lerp weight resolution (0..256)
_WEIGHT_ONE = float(1 << WEIGHT_BITS)
# 1 / 2^16, the power-of-two scale of the fixed-point sums: exact
_INV_WEIGHT_SQ = float(np.float32(1.0 / (_WEIGHT_ONE * _WEIGHT_ONE)))


def _linear_taps(in_len: int, out_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-tap source indices (lo, hi) and the hi-tap weight for one axis,
    built in float64 on the host with the JAX package's numpy code.

    Weights are 8-bit fixed point (w1 in 0..256, w0 = 256 - w1): with u8
    pixels every product pixel * wy * wx <= 255 * 2^16 < 2^24 and the 4-tap
    sum <= 255 * 2^16 are exact in float32, and the final scale is a power
    of two, so nothing rounds before the last rint and the result is the
    same on every device and in every summation order."""
    centers = (np.arange(out_len, dtype=np.float64) + 0.5) * (in_len / out_len) - 0.5
    lo = np.floor(centers)
    w1 = np.rint((centers - lo) * _WEIGHT_ONE).astype(np.float32)
    lo_c = np.clip(lo, 0, in_len - 1).astype(np.int32)
    hi_c = np.clip(lo + 1, 0, in_len - 1).astype(np.int32)
    return lo_c, hi_c, w1


def _nearest_index(in_len: int, out_len: int) -> np.ndarray:
    centers = (np.arange(out_len, dtype=np.float64) + 0.5) * (in_len / out_len)
    return np.clip(np.floor(centers), 0, in_len - 1).astype(np.int32)


@functools.lru_cache(maxsize=_RESIZE_CACHE_SIZE)
def _resize_maps(in_h: int, in_w: int, out_h: int, out_w: int, method: str,
                 device: torch.device) -> tuple:
    """The resize maps on `device`: (ys, xs) for 'nearest'; (ylo, yhi, xlo,
    xhi, wy1, wx1) for 'bilinear', the weights as float32 columns (out_h, 1)
    and rows (1, out_w)."""
    if method == "nearest":
        return tuple(torch.from_numpy(a).to(device)
                     for a in (_nearest_index(in_h, out_h), _nearest_index(in_w, out_w)))
    ylo, yhi, wy1 = _linear_taps(in_h, out_h)
    xlo, xhi, wx1 = _linear_taps(in_w, out_w)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (ylo, yhi, xlo, xhi, wy1.reshape(out_h, 1), wx1.reshape(1, out_w)))


def _resize_fn(out_h: int, out_w: int, method: str):
    def fn(img: torch.Tensor) -> torch.Tensor:
        if (out_h, out_w) == tuple(img.shape[:2]):
            return img.contiguous()
        maps = _resize_maps(img.shape[0], img.shape[1], out_h, out_w, method, img.device)
        if method == "nearest":
            ys, xs = maps
            return img.index_select(0, ys).index_select(1, xs)
        ylo, yhi, xlo, xhi, wy1, wx1 = maps
        xf = img.to(F32)
        r0 = xf.index_select(0, ylo)
        r1 = xf.index_select(0, yhi)
        a00 = r0.index_select(1, xlo)
        a01 = r0.index_select(1, xhi)
        a10 = r1.index_select(1, xlo)
        a11 = r1.index_select(1, xhi)
        if img.ndim == 3:  # the weights broadcast over the channels
            wy1, wx1 = wy1[..., None], wx1[..., None]
        wy0 = _WEIGHT_ONE - wy1
        wx0 = _WEIGHT_ONE - wx1
        # every product and partial sum below is an exact float32 integer;
        # the JAX package's grouping is kept all the same
        acc = (a00 * (wy0 * wx0) + a01 * (wy0 * wx1)) + (
            a10 * (wy1 * wx0) + a11 * (wy1 * wx1)
        )
        acc = acc * _INV_WEIGHT_SQ
        return rint_clip_f32(acc).to(U8)

    return fn


def make_resize(out_h: int, out_w: int, method: str = "bilinear") -> GeometricOp:
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"invalid resize target {out_h}x{out_w}")
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown resize method {method!r}")
    return GeometricOp(f"resize{out_h}x{out_w}_{method}", _resize_fn(out_h, out_w, method))


def make_scale(factor: float, method: str = "bilinear") -> GeometricOp:
    """Resize by a scale factor; the target shape comes from the input's."""
    if factor <= 0:
        raise ValueError(f"scale factor must be positive, got {factor}")
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown resize method {method!r}")

    def fn(img: torch.Tensor) -> torch.Tensor:
        th = max(1, int(round(img.shape[0] * factor)))
        tw = max(1, int(round(img.shape[1] * factor)))
        return _resize_fn(th, tw, method)(img)

    return GeometricOp(f"scale{factor:g}_{method}", fn)


def make_rot90(angle: int) -> GeometricOp:
    ops = {90: ROT90, 180: ROT180, 270: ROT270}
    if angle not in ops:
        raise ValueError(f"rotation must be 90/180/270 degrees, got {angle}")
    return ops[angle]


# --------------------------------------------------------------------------
# Rotate
# --------------------------------------------------------------------------


def _rotate_maps(h: int, w: int, angle_deg: float, method: str):
    """Host sampling maps for a same-size rotation about the image centre
    (counter-clockwise positive, OpenCV's getRotationMatrix2D convention;
    samples outside the image read the constant border 0, warpAffine's
    default), the JAX package's numpy code. Weights are the 8-bit fixed
    point of `_linear_taps`, so every product and partial sum is an exact
    float32 integer. 'nearest' returns (flat index, inside); 'bilinear'
    four (flat index, weight) taps, a border tap's weight zeroed."""
    th = np.deg2rad(angle_deg)
    cos, sin = np.cos(th), np.sin(th)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # inverse map: the source position of each output pixel
    dy, dx = yy - cy, xx - cx
    sy = cos * dy + sin * dx + cy
    sx = -sin * dy + cos * dx + cx
    if method == "nearest":
        iy = np.rint(sy).astype(np.int64)
        ix = np.rint(sx).astype(np.int64)
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        flat = np.clip(iy, 0, h - 1) * w + np.clip(ix, 0, w - 1)
        return (flat.astype(np.int32), inside.astype(np.float32))
    ylo = np.floor(sy)
    xlo = np.floor(sx)
    wy1 = np.rint((sy - ylo) * _WEIGHT_ONE).astype(np.float32)
    wx1 = np.rint((sx - xlo) * _WEIGHT_ONE).astype(np.float32)
    taps = []
    for oy, wy in ((0, _WEIGHT_ONE - wy1), (1, wy1)):
        for ox, wx in ((0, _WEIGHT_ONE - wx1), (1, wx1)):
            ty, tx = ylo + oy, xlo + ox
            inside = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
            flat = np.clip(ty, 0, h - 1) * w + np.clip(tx, 0, w - 1)
            # border-0 samples: zero the tap weight instead of the value
            taps.append((flat.astype(np.int32), (wy * wx * inside).astype(np.float32)))
    return taps


@functools.lru_cache(maxsize=_ROTATE_CACHE_SIZE)
def _rotate_maps_on(h: int, w: int, angle_deg: float, method: str,
                    device: torch.device) -> tuple:
    """`_rotate_maps` uploaded to `device`: ((flat index, weight), ...), the
    index raveled, the weight (h, w)."""
    maps = _rotate_maps(h, w, angle_deg, method)
    if method == "nearest":
        maps = [maps]
    return tuple((torch.from_numpy(idx.ravel()).to(device), torch.from_numpy(wt).to(device))
                 for idx, wt in maps)


def make_rotate(angle_deg: float, method: str = "bilinear") -> GeometricOp:
    """Arbitrary-angle rotation, same-size about the centre, constant-0
    border, counter-clockwise positive like PIL and OpenCV (so rotate:90
    equals the op named rot270, whose name follows the transpose-flip
    construction). Four flat gathers and an exact fixed-point lerp
    (`_rotate_maps`)."""
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown rotate method {method!r}")
    if not np.isfinite(angle_deg):
        raise ValueError(f"rotate angle must be finite, got {angle_deg}")

    def fn(img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[:2]
        if h * w >= 2**31:  # the flat int32 index would wrap
            raise ValueError(f"rotate supports images up to 2^31 pixels, got {h}x{w}")
        flat = img.reshape((h * w,) + tuple(img.shape[2:])).to(F32)
        maps = _rotate_maps_on(h, w, float(angle_deg), method, img.device)
        acc = None
        for idx, wt in maps:
            vals = flat.index_select(0, idx).reshape(img.shape)
            term = vals * (wt if img.ndim == 2 else wt[..., None])
            acc = term if acc is None else acc + term
        if method == "nearest":
            return acc.to(U8)  # the value itself or the border's 0: exact
        acc = acc * _INV_WEIGHT_SQ
        return rint_clip_f32(acc).to(U8)

    return GeometricOp(f"rotate{angle_deg:g}_{method}", fn)
