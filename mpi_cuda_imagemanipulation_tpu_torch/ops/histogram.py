"""Global-statistics ops: histogram, equalize, autocontrast, Otsu. The
counterpart of the JAX package's ``ops/histogram.py``.

Every op is an additive statistic plus a pointwise apply (``GlobalOp``,
ops/spec.py). The statistic is a 256-bin int32 histogram: exact integer
counts (float32 would lose exactness past 2^24 pixels, and an 8K frame has
33 M), which the sharded runner sums over slots and ranks. The lookup table
derived from it uses float32 arithmetic on exact integers, each step its
own tensor op, so the sharded and unsharded paths, the CPU and the card
build the same table.

All ops take single-channel images, like OpenCV's ``equalizeHist``; run
``grayscale`` first for colour inputs.
"""

from __future__ import annotations

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import F32, U8, GlobalOp

BINS = 256
I32 = torch.int32
# the ordered prefix sum's block length (_prefix_sum_f32)
_SCAN_BLOCK = 16


def histogram_stats(img: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """int32[256] pixel-value counts; `valid` (broadcastable to img, 0/1)
    masks rows that are sharding padding, not image content.

    ``jnp.bincount(..., weights=valid)`` counts in int32; ``torch.bincount``
    with weights counts in floats. So a masked pixel goes to a 257th bin
    that is dropped, and the counts stay integers: exact on the card too,
    where they are integer atomics."""
    idx = img.reshape(-1)
    if valid is None:
        return torch.bincount(idx, minlength=BINS).to(I32)
    keep = torch.broadcast_to(valid, img.shape).reshape(-1) != 0
    idx = torch.where(keep, idx.to(I32), BINS)
    return torch.bincount(idx, minlength=BINS + 1)[:BINS].to(I32)


def _f32_scalar(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=F32, device=device)


def _arange_f32(device) -> torch.Tensor:
    return torch.arange(BINS, dtype=F32, device=device)


def _lut_apply(img: torch.Tensor, lut_f32: torch.Tensor) -> torch.Tensor:
    """Apply an f32[256] table holding exact u8 integer values."""
    lut = lut_f32.to(U8)
    # a u8 index tensor would read as a mask: int32 indices
    return lut.index_select(0, img.reshape(-1).to(I32)).reshape(img.shape)


# --------------------------------------------------------------------------
# Equalize (cv::equalizeHist semantics)
# --------------------------------------------------------------------------


def equalize_apply(img: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """lut[i] = round((cdf(i) - cdf_min) / (N - cdf_min) * 255), cdf_min the
    CDF at the lowest occupied bin: OpenCV's equalizeHist formula. Constant
    images (denominator 0) pass through unchanged."""
    cdf = torch.cumsum(hist, 0, dtype=I32)  # exact
    total = cdf[-1]
    # the cdf at the first nonzero bin == min over occupied bins of cdf
    cdf_min = torch.min(torch.where(hist > 0, cdf, total))
    denom = (total - cdf_min).to(F32)
    # float32 `/` and `*` are correctly rounded, as separate tensor ops
    scaled = (cdf - cdf_min).to(F32) * (_f32_scalar(255.0, denom.device) / denom)
    lut = torch.clamp(torch.round(scaled), 0.0, 255.0)
    lut = torch.where(denom > 0, lut, _arange_f32(hist.device))
    return _lut_apply(img, lut)


EQUALIZE = GlobalOp("equalize", stats=histogram_stats, apply=equalize_apply)


# --------------------------------------------------------------------------
# Autocontrast (linear stretch of the occupied range to [0, 255])
# --------------------------------------------------------------------------


def autocontrast_apply(img: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    occupied = hist > 0
    bins = torch.arange(BINS, dtype=I32, device=hist.device)
    lo = torch.min(torch.where(occupied, bins, BINS)).to(F32)
    hi = torch.max(torch.where(occupied, bins, -1)).to(F32)
    span = hi - lo
    ident = _arange_f32(hist.device)
    scaled = (ident - lo) * (_f32_scalar(255.0, span.device) / span)
    lut = torch.clamp(torch.round(scaled), 0.0, 255.0)
    lut = torch.where(span > 0, lut, ident)
    return _lut_apply(img, lut)


AUTOCONTRAST = GlobalOp("autocontrast", stats=histogram_stats, apply=autocontrast_apply)


# --------------------------------------------------------------------------
# Otsu threshold
# --------------------------------------------------------------------------


def _prefix_sum_f32(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a float32[256] in one fixed order, the order
    the JAX package's ``jnp.cumsum`` takes on XLA's CPU backend (found by
    experiment with jax 0.9.0, and held to it by tests/test_torch_histogram.py):
    left to right within 16-element blocks, the block totals left to right,
    and each entry the prefix of the earlier blocks' totals plus its
    in-block partial sum.

    The moments' partial sums pass 2^24, where float32 addition rounds, so
    the order decides the bits: ``torch.cumsum`` on the CPU and its parallel
    scan on the card each take another. Written out as ordered elementwise
    adds, the same bytes come out on every device."""
    x = v.reshape(BINS // _SCAN_BLOCK, _SCAN_BLOCK)
    cols = [x[:, 0]]
    for i in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + x[:, i])
    part = torch.stack(cols, dim=1)  # in-block partial sums
    totals = part[:, -1]
    before = [torch.zeros((), dtype=F32, device=v.device)]
    for b in range(1, BINS // _SCAN_BLOCK):
        before.append(before[-1] + totals[b - 1])
    return (torch.stack(before)[:, None] + part).reshape(BINS)


def otsu_threshold_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Otsu's method: the threshold t maximising the between-class variance
    w0(t) w1(t) (mu0(t) - mu1(t))^2, pixels <= t in class 0. Class counts
    are exact int32 prefix sums; the weighted moments would overflow int32
    (255 x 33 M for an 8K frame), so they run in float32 in the JAX
    package's order (`_prefix_sum_f32`), never through float64: the same
    threshold on every device and sharding."""
    h = hist.to(I32)
    w0 = torch.cumsum(h, 0, dtype=I32)  # pixels <= t, exact
    total = w0[-1]
    s0 = _prefix_sum_f32(h.to(F32) * _arange_f32(h.device))
    stotal = s0[-1]
    w1 = total - w0
    valid = (w0 > 0) & (w1 > 0)
    mu0 = s0 / torch.clamp(w0, min=1).to(F32)
    mu1 = (stotal - s0) / torch.clamp(w1, min=1).to(F32)
    d = mu0 - mu1
    between = w0.to(F32) * w1.to(F32) * d * d
    between = torch.where(valid, between, _f32_scalar(-1.0, h.device))
    # torch.argmax returns the first maximising bin, as jnp.argmax does
    return torch.argmax(between).to(I32)


def otsu_apply(img: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    t = otsu_threshold_from_hist(hist)
    return (img.to(I32) > t).to(U8) * 255


OTSU = GlobalOp("otsu", stats=histogram_stats, apply=otsu_apply)
