"""Image I/O: HWC uint8 numpy arrays at the package boundary.

Colour images are (H, W, 3) RGB uint8; grayscale are (H, W) uint8. Files
go through PIL.
"""

from __future__ import annotations

import os

import numpy as np


def load_image(path: str | os.PathLike, *, grayscale: bool = False) -> np.ndarray:
    """Load an image file to (H, W, 3) RGB uint8, or (H, W) if grayscale.

    `grayscale=True` on a colour source reduces with the golden grayscale
    op; a single-channel source is returned as stored. An armed
    ``io.decode`` failpoint raises before the file is opened."""
    from PIL import Image

    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

    failpoints.maybe_fail("io.decode", path=str(path))

    with Image.open(path) as im:
        if im.mode in ("L", "1", "I", "I;16", "F"):
            arr = np.array(im.convert("L"), dtype=np.uint8)
        else:
            arr = np.array(im.convert("RGB"), dtype=np.uint8)
    if grayscale and arr.ndim == 3:
        import torch

        from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import grayscale_u8

        arr = grayscale_u8(torch.from_numpy(arr)).numpy()
    if not grayscale and arr.ndim == 2:
        arr = gray_to_rgb(arr)
    return arr


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """Replicate a (H, W) gray image to (H, W, 3) — the reference's GRAY2BGR
    output convention (kernel.cu:210)."""
    return np.broadcast_to(img[..., None], (*img.shape, 3)).copy()


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save (H, W) or (H, W, 3) uint8 to `path` (format from extension)."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)


# Row-block granularity of the synthetic generator: every block of rows
# draws from its own seeded stream, so any row window can be produced
# without materialising the rows before it (synthetic_tile). Both packages
# must generate the same bytes from the same seed.
_SYNTH_BLOCK_ROWS = 256


def _synthetic_block(
    block: int, rows: int, width: int, channels: int, seed: int
) -> np.ndarray:
    rng = np.random.default_rng((seed, width, channels, block))
    shape = (rows, width, channels) if channels > 1 else (rows, width)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def synthetic_image(height: int, width: int, *, channels: int = 3, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-random test/bench image (uint8), generated in
    fixed row blocks so that `synthetic_tile` can produce any row window
    bit-identically."""
    return synthetic_tile(0, height, width, channels=channels, seed=seed)


def synthetic_tile(
    row0: int, rows: int, width: int, *, channels: int = 3, seed: int = 0
) -> np.ndarray:
    """Rows ``[row0, row0 + rows)`` of ``synthetic_image(H, width, ...)`` for
    any H > row0 + rows, at a cost proportional to the window."""
    if rows < 0 or row0 < 0:
        raise ValueError(f"bad window row0={row0} rows={rows}")
    b0 = row0 // _SYNTH_BLOCK_ROWS
    b1 = (row0 + rows + _SYNTH_BLOCK_ROWS - 1) // _SYNTH_BLOCK_ROWS
    parts = [
        _synthetic_block(b, _SYNTH_BLOCK_ROWS, width, channels, seed)
        for b in range(b0, max(b1, b0 + 1))
    ]
    band = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    off = row0 - b0 * _SYNTH_BLOCK_ROWS
    return np.ascontiguousarray(band[off : off + rows])
