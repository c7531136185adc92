"""Filter-bank definitions (correlation weights, `w[dy, dx]` indexing).

All stencil weights in this framework are *integers* stored as float32, with a
separate power-of-two (or single-multiply) normalisation scale. Integer
accumulation is exact in float32 (all partial sums < 2**24), so every backend
(golden jnp, Pallas tiles, sharded shard_map tiles) produces bit-identical
results regardless of accumulation order — the framework's cross-backend
bit-exactness guarantee rests on this.

Reference provenance:
  - EMBOSS3 / EMBOSS5: the reference's kernel.cu:71-82. The reference indexes
    `filter[fx][fy]` where `fx` is the *x* displacement (kernel.cu:86-88),
    i.e. it applies the transposed matrix; both matrices are symmetric so the
    transposition is unobservable, but we store the transposed ("as applied")
    orientation explicitly.
  - Gaussian / Sobel / box / sharpen: not present in the reference; mandated
    by BASELINE.json's benchmark configs and standard definitions.
"""

from __future__ import annotations

import numpy as np


def _w(rows) -> np.ndarray:
    a = np.asarray(rows, dtype=np.float32)
    assert a.ndim in (1, 2)
    return a


# Reference emboss 3x3 (kernel.cu:71-75), stored transposed (as applied —
# symmetric, so identical to the source matrix).
EMBOSS3 = _w([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]]).T.copy()

# Reference emboss 5x5 (kernel.cu:76-82): diagonal {4, 4, 1, -4, -4}.
EMBOSS5 = _w(np.diag([4.0, 4.0, 1.0, -4.0, -4.0]).astype(np.float32)).T.copy()


def binomial_1d(size: int) -> np.ndarray:
    """Integer binomial (Pascal) row, e.g. size=5 -> [1, 4, 6, 4, 1]."""
    row = np.array([1.0], dtype=np.float64)
    for _ in range(size - 1):
        row = np.convolve(row, [1.0, 1.0])
    return row.astype(np.float32)


def gaussian_2d(size: int) -> tuple[np.ndarray, float]:
    """Integer 2-D binomial-Gaussian kernel and its power-of-two 1/norm."""
    row = binomial_1d(size)
    k2 = np.outer(row, row).astype(np.float32)
    norm = float(k2.sum())  # (2**(size-1))**2 — a power of two
    return k2, 1.0 / norm


SOBEL_GX = _w([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
SOBEL_GY = SOBEL_GX.T.copy()

PREWITT_GX = _w([[-1, 0, 1], [-1, 0, 1], [-1, 0, 1]])
PREWITT_GY = PREWITT_GX.T.copy()

SCHARR_GX = _w([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]])
SCHARR_GY = SCHARR_GX.T.copy()

SHARPEN3 = _w([[0, -1, 0], [-1, 5, -1], [0, -1, 0]])

# 4- and 8-neighbour Laplacians (OpenCV/classic definitions)
LAPLACIAN4 = _w([[0, 1, 0], [1, -4, 1], [0, 1, 0]])
LAPLACIAN8 = _w([[1, 1, 1], [1, -8, 1], [1, 1, 1]])

# Unsharp mask: identity*2 - gaussian, as one integer 5x5 kernel with a
# power-of-two scale: 2*256*delta - binomial5x5, /256.
_G5 = np.outer(binomial_1d(5), binomial_1d(5)).astype(np.float32)
UNSHARP5 = (-_G5).copy()
UNSHARP5[2, 2] += 2.0 * 256.0
UNSHARP5_SCALE = 1.0 / 256.0


def box_2d(size: int) -> tuple[np.ndarray, float]:
    k2 = np.ones((size, size), dtype=np.float32)
    return k2, 1.0 / float(size * size)
