"""Image I/O: HWC uint8 numpy arrays at the package boundary.

Colour images are (H, W, 3) RGB uint8; grayscale are (H, W) uint8. Binary
PPM/PGM files go through the port's native C++ codec (runtime/codec.py,
built at its first use) and every other format through PIL; where the codec
cannot be built, PPM/PGM go through PIL too, as in the JAX package (the
codec is host I/O, not a device kernel). ``batch_load`` decodes a list of
files ahead on worker threads, in order.
"""

from __future__ import annotations

import os

import numpy as np

_NATIVE_EXTS = {".ppm", ".pgm"}
# decoded images held ahead of the consumer (the native loader's window too)
MAX_AHEAD = 16


def _native_codec():
    """The native codec module, or None where its library cannot be built."""
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import codec

    return codec if codec.available() else None


def _pil_array(im) -> np.ndarray:
    """A PIL image as (H, W) uint8 for single-channel modes, else (H, W, 3)."""
    if im.mode in ("L", "1", "I", "I;16", "F"):
        return np.array(im.convert("L"), dtype=np.uint8)
    return np.array(im.convert("RGB"), dtype=np.uint8)


def load_image(path: str | os.PathLike, *, grayscale: bool = False) -> np.ndarray:
    """Load an image file to (H, W, 3) RGB uint8, or (H, W) if grayscale.

    `grayscale=True` on a colour source reduces with the golden grayscale
    op (the same bytes whichever decoder read the file); a single-channel
    source is returned as stored. An armed ``io.decode`` failpoint raises
    before the file is opened."""
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

    failpoints.maybe_fail("io.decode", path=str(path))
    ext = os.path.splitext(str(path))[1].lower()
    native = _native_codec() if ext in _NATIVE_EXTS else None
    if native is not None:
        arr = native.read_image(str(path))
    else:
        from PIL import Image

        with Image.open(path) as im:
            arr = _pil_array(im)
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


def _u8_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    return img


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save (H, W) or (H, W, 3) uint8 to `path` (format from extension)."""
    img = _u8_image(img)
    ext = os.path.splitext(str(path))[1].lower()
    native = _native_codec() if ext in _NATIVE_EXTS else None
    if native is not None:
        native.write_image(str(path), img)
        return
    from PIL import Image

    Image.fromarray(img).save(path)


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode an in-memory image (any PIL-readable format) with the same
    normalisation as `load_image`: (H, W, 3) RGB uint8, or (H, W) uint8 for
    single-channel sources. An armed ``io.decode`` failpoint raises
    first."""
    import io as _io

    from PIL import Image

    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

    failpoints.maybe_fail("io.decode", n_bytes=len(data))
    with Image.open(_io.BytesIO(data)) as im:
        return _pil_array(im)


def encode_image_into(img: np.ndarray, sink, format: str = "PNG") -> None:
    """Encode (H, W) or (H, W, 3) uint8 straight into a writable binary
    file object: the encoder writes into the sink, with no byte string in
    between (`encode_image_bytes` returns one)."""
    from PIL import Image

    Image.fromarray(_u8_image(img)).save(sink, format=format)


def encode_image_bytes(img: np.ndarray, format: str = "PNG") -> bytes:
    """Encode (H, W) or (H, W, 3) uint8 to image bytes (PNG by default,
    lossless)."""
    import io as _io

    buf = _io.BytesIO()
    encode_image_into(img, buf, format=format)
    return buf.getvalue()


def batch_load(paths, *, n_threads: int = 4, on_error: str = "raise",
               with_digests: bool = False):
    """Yield (index, image) over `paths` in order, decoding at most
    MAX_AHEAD images ahead on worker threads: the native ``BatchLoader``
    when the codec is built and every input is PPM/PGM, else a thread pool
    over `load_image`. Gray sources are normalised to (H, W, 3) whichever
    decoder ran. ``on_error='skip'`` logs and drops a file that fails to
    decode (its index is absent from the stream).

    ``with_digests=True`` yields (index, image, sha256 hex) with the
    content digest hashed on the decode worker beside the decode (on the
    native path, whose threads are C++, on the consumer thread, still ahead
    of dispatch)."""
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import content_digest

    paths = [str(p) for p in paths]

    def load_one(path: str):
        arr = load_image(path)
        return (arr, content_digest(path)) if with_digests else (arr,)

    def deliver(i, arr, *digest):
        return (i, gray_to_rgb(arr) if arr.ndim == 2 else arr, *digest)

    def failed(path, exc):
        if on_error == "raise":
            raise exc
        from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

        # on the native path the exception text names the file
        get_logger().warning("skipping %s: %s", path or "input", exc)

    native = _native_codec()
    if native is not None and all(os.path.splitext(p)[1].lower() in _NATIVE_EXTS
                                  for p in paths):
        with native.BatchLoader(paths, n_threads=n_threads) as loader:
            for _ in range(len(paths)):
                try:
                    i, arr = next(loader)
                except StopIteration:
                    break
                except IOError as e:
                    failed(None, e)
                    continue
                yield deliver(i, arr, *((content_digest(paths[i]),) if with_digests else ()))
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        pending: deque = deque()
        todo = iter(enumerate(paths))
        exhausted = False
        while pending or not exhausted:
            while not exhausted and len(pending) < MAX_AHEAD:
                nxt = next(todo, None)
                if nxt is None:
                    exhausted = True
                    break
                pending.append((nxt[0], pool.submit(load_one, nxt[1])))
            if not pending:
                break
            i, fut = pending.popleft()
            try:
                got = fut.result()
            except Exception as e:
                failed(paths[i], e)
                continue
            yield deliver(i, *got)


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
