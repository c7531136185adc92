"""Windowed decode + incremental encode — pixels never fully materialise.
The counterpart of the JAX package's ``io/stream_codec.py``, host numpy
only; its writers give the same bytes as the JAX package's.

`io/image.py` is the whole-image boundary: decode to one (H, W[, 3])
array, encode from one. That ceiling IS the repo's old problem-size
ceiling — a 100k x 100k scan cannot exist host-side. This module is the
row-band boundary the streaming tile engine (stream/) runs on:

  * **TileReader** — sequential row-band decode: ``read_rows(n)`` hands
    out the next ``n`` rows and forgets them; ``skip_rows`` fast-forwards
    (seek where the container allows, decode-and-discard where it
    doesn't — journal resume needs both). Implementations: PNM (P5/P6,
    header + seek — the native-codec formats), PNG (chunk walk + a
    zlib ``decompressobj`` + per-scanline unfiltering: None/Sub/Up are
    vectorised, Average/Paeth fall back to a per-pixel row loop — PIL
    emits all of them), synthetic (``io.image.synthetic_tile`` — the
    gigapixel bench source), and an in-memory array wrapper.
  * **TileWriter** — incremental encode: ``write_rows`` appends a band,
    ``close`` finalises the container. PNM appends raw bytes (and
    supports reopening at a row offset — the journal-resume path); PNG
    streams one IDAT chunk per band from a live ``compressobj`` (filter
    0 scanlines) so the compressor state is the only buffered state.

Both sides deal in the `load_image` conventions: (rows, W, 3) RGB uint8
or (rows, W) gray uint8. 16-bit, paletted and interlaced sources are
rejected loudly (`UnsupportedStreamFormat`) and the CLI falls back to a
whole-image decode with a warning — constant memory is a property worth
failing loudly over, not silently losing.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_tile

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class UnsupportedStreamFormat(ValueError):
    """The container cannot be streamed row-wise (or not by this codec)."""


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------


class TileReader:
    """Sequential row-band decoder. Subclasses set height/width/channels
    in __init__ and implement _read(n) -> uint8 rows."""

    height: int
    width: int
    channels: int  # 1 or 3

    def __init__(self):
        self._row = 0  # next row to hand out

    @property
    def rows_read(self) -> int:
        return self._row

    def read_rows(self, n: int) -> np.ndarray | None:
        """The next min(n, remaining) rows as uint8 (rows, W[, 3]);
        None once the image is exhausted."""
        n = min(n, self.height - self._row)
        if n <= 0:
            return None
        out = self._read(n)
        self._row += n
        return out

    def skip_rows(self, n: int) -> None:
        """Fast-forward past n rows (resume support). Default: decode and
        discard; seekable containers override."""
        n = min(n, self.height - self._row)
        if n > 0:
            self._read(n)
            self._row += n

    def _read(self, n: int) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "TileReader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class ArrayTileReader(TileReader):
    """Row-band view over an in-memory array (tests and video frames)."""

    def __init__(self, arr: np.ndarray):
        super().__init__()
        arr = np.asarray(arr)
        if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
            raise ValueError(f"expected uint8 (H,W[,3]) array, got {arr.shape} {arr.dtype}")
        self._arr = arr
        self.height, self.width = arr.shape[:2]
        self.channels = arr.shape[2] if arr.ndim == 3 else 1

    def _read(self, n: int) -> np.ndarray:
        return np.ascontiguousarray(self._arr[self._row : self._row + n])

    def skip_rows(self, n: int) -> None:
        self._row = min(self._row + n, self.height)


class SyntheticTileReader(TileReader):
    """Windowed synthetic source: each band comes from
    `io.image.synthetic_tile`, bit-identical to slicing the full
    `synthetic_image` — so a 100k-row scan is a few integers of state."""

    def __init__(self, height: int, width: int, *, channels: int = 3, seed: int = 0):
        super().__init__()
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed

    def _read(self, n: int) -> np.ndarray:
        return synthetic_tile(
            self._row, n, self.width, channels=self.channels, seed=self.seed
        )

    def skip_rows(self, n: int) -> None:
        self._row = min(self._row + n, self.height)


class PNMTileReader(TileReader):
    """P5 (gray) / P6 (RGB) binary PNM: one header parse, then every
    band is a seek + read — the ideal streaming container (and the
    native C++ codec's format, runtime/codec.py)."""

    def __init__(self, path: str | os.PathLike):
        super().__init__()
        self._f = open(path, "rb")
        try:
            magic = self._f.read(2)
            if magic not in (b"P5", b"P6"):
                raise UnsupportedStreamFormat(
                    f"{path}: not binary PNM (magic {magic!r})"
                )
            self.channels = 3 if magic == b"P6" else 1
            vals = []
            while len(vals) < 3:
                tok = self._token()
                vals.append(int(tok))
            self.width, self.height, maxval = vals
            if maxval != 255:
                raise UnsupportedStreamFormat(
                    f"{path}: maxval {maxval} (only 8-bit supported)"
                )
            self._data0 = self._f.tell()
        except Exception:
            self._f.close()
            raise

    def _token(self) -> bytes:
        """Next whitespace-delimited header token, skipping # comments."""
        tok = b""
        while True:
            c = self._f.read(1)
            if not c:
                raise UnsupportedStreamFormat("truncated PNM header")
            if c == b"#":
                while c and c != b"\n":
                    c = self._f.read(1)
                continue
            if c.isspace():
                if tok:
                    return tok
                continue
            tok += c

    def _stride(self) -> int:
        return self.width * self.channels

    def _read(self, n: int) -> np.ndarray:
        raw = self._f.read(n * self._stride())
        if len(raw) != n * self._stride():
            raise OSError("truncated PNM pixel data")
        arr = np.frombuffer(raw, dtype=np.uint8)
        if self.channels == 1:
            return arr.reshape(n, self.width)
        return arr.reshape(n, self.width, self.channels)

    def skip_rows(self, n: int) -> None:
        n = min(n, self.height - self._row)
        self._f.seek(n * self._stride(), os.SEEK_CUR)
        self._row += n

    def close(self) -> None:
        self._f.close()


def _unfilter_scanline(
    ftype: int, raw: np.ndarray, prev: np.ndarray, bpp: int
) -> np.ndarray:
    """One PNG scanline filter inversion. raw/prev are uint8 (stride,);
    prev is the RECONSTRUCTED previous scanline (zeros for the first)."""
    if ftype == 0:  # None
        return raw
    if ftype == 2:  # Up (uint8 add wraps mod 256 — the PNG spec's math)
        return raw + prev
    if ftype == 1:  # Sub: prefix sum per byte lane, stride bpp
        lanes = raw.reshape(-1, bpp).astype(np.uint32)
        recon = np.cumsum(lanes, axis=0, dtype=np.uint32) % 256
        return recon.astype(np.uint8).reshape(-1)
    out = np.zeros_like(raw)
    if ftype == 3:  # Average — sequential in x (left term)
        r = raw.astype(np.int32)
        p = prev.astype(np.int32)
        o = out.astype(np.int32)
        for x in range(len(raw)):
            left = o[x - bpp] if x >= bpp else 0
            o[x] = (r[x] + (left + p[x]) // 2) % 256
        return o.astype(np.uint8)
    if ftype == 4:  # Paeth — sequential in x (left + upleft terms)
        r = raw.astype(np.int32)
        p = prev.astype(np.int32)
        o = np.zeros(len(raw), np.int32)
        for x in range(len(raw)):
            a = o[x - bpp] if x >= bpp else 0
            b = p[x]
            c = p[x - bpp] if x >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            o[x] = (r[x] + pred) % 256
        return o.astype(np.uint8)
    raise UnsupportedStreamFormat(f"bad PNG filter type {ftype}")


class PNGTileReader(TileReader):
    """Streaming scanline decode of non-interlaced 8-bit gray/RGB PNG:
    IDAT chunks feed one zlib decompressobj, scanlines unfilter against
    only the previous reconstructed row — O(width) state regardless of
    image height. RGBA/16-bit/palette/interlaced raise
    UnsupportedStreamFormat (the CLI falls back to whole-image decode)."""

    def __init__(self, path: str | os.PathLike):
        super().__init__()
        self._f = open(path, "rb")
        try:
            if self._f.read(8) != _PNG_SIG:
                raise UnsupportedStreamFormat(f"{path}: not a PNG")
            ln, typ = struct.unpack(">I4s", self._f.read(8))
            if typ != b"IHDR" or ln != 13:
                raise UnsupportedStreamFormat(f"{path}: malformed IHDR")
            w, h, depth, color, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", self._f.read(13)
            )
            self._f.read(4)  # IHDR crc
            if depth != 8 or color not in (0, 2) or interlace != 0:
                raise UnsupportedStreamFormat(
                    f"{path}: only non-interlaced 8-bit gray/RGB streams "
                    f"(depth={depth} color={color} interlace={interlace})"
                )
            self.width, self.height = w, h
            self.channels = 3 if color == 2 else 1
            self._z = zlib.decompressobj()
            self._buf = bytearray()  # decompressed-but-unparsed bytes
            self._prev = np.zeros(w * self.channels, np.uint8)
            self._eof = False
        except Exception:
            self._f.close()
            raise

    def _stride(self) -> int:
        return self.width * self.channels

    def _fill(self, want: int) -> None:
        """Decompress until `want` bytes are buffered (or IEND)."""
        while len(self._buf) < want and not self._eof:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                self._eof = True
                break
            ln, typ = struct.unpack(">I4s", hdr)
            data = self._f.read(ln)
            self._f.read(4)  # crc
            if typ == b"IDAT":
                self._buf += self._z.decompress(data)
            elif typ == b"IEND":
                self._buf += self._z.flush()
                self._eof = True
            # ancillary chunks are skipped

    def _scanlines(self, n: int) -> np.ndarray:
        stride = self._stride()
        need = n * (stride + 1)
        self._fill(need)
        if len(self._buf) < need:
            raise OSError("truncated PNG pixel data")
        raw = np.frombuffer(bytes(self._buf[:need]), np.uint8).reshape(
            n, stride + 1
        )
        del self._buf[:need]
        out = np.empty((n, stride), np.uint8)
        prev = self._prev
        for r in range(n):
            prev = _unfilter_scanline(int(raw[r, 0]), raw[r, 1:], prev, self.channels)
            out[r] = prev
        self._prev = prev
        return out

    def _read(self, n: int) -> np.ndarray:
        flat = self._scanlines(n)
        if self.channels == 1:
            return flat.reshape(n, self.width)
        return flat.reshape(n, self.width, self.channels)

    def close(self) -> None:
        self._f.close()


class _FullDecodeTileReader(ArrayTileReader):
    """Fallback for containers without a streaming decode (JPEG, ...):
    whole-image `load_image`, row-band interface. NOT constant-memory —
    `open_tile_reader` logs when it has to resort to this."""

    def __init__(self, path: str | os.PathLike):
        from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image

        super().__init__(np.asarray(load_image(path)))


def open_tile_reader(path: str | os.PathLike, *, allow_fallback: bool = True) -> TileReader:
    """Open `path` with the best row-band decoder for its container:
    seekable PNM, streaming PNG, else (with `allow_fallback`) a logged
    whole-image fallback."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".ppm", ".pgm", ".pnm"):
        return PNMTileReader(path)
    if ext == ".png":
        try:
            return PNGTileReader(path)
        except UnsupportedStreamFormat:
            if not allow_fallback:
                raise
    elif not allow_fallback:
        raise UnsupportedStreamFormat(
            f"{path}: no streaming decoder for {ext!r} (use ppm/pgm/png)"
        )
    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

    get_logger().warning(
        "%s: no constant-memory decoder for this container — falling back "
        "to whole-image decode (stream memory bound does not hold)", path,
    )
    return _FullDecodeTileReader(path)


# --------------------------------------------------------------------------
# Writers
# --------------------------------------------------------------------------


class TileWriter:
    """Incremental row-band encoder; subclasses implement _write/close."""

    height: int
    width: int
    channels: int

    def __init__(self, height: int, width: int, channels: int):
        if channels not in (1, 3):
            raise ValueError(f"channels must be 1 or 3, got {channels}")
        self.height, self.width, self.channels = height, width, channels
        self.rows_written = 0

    def _check(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        if rows.dtype != np.uint8:
            raise TypeError(f"expected uint8 rows, got {rows.dtype}")
        if rows.ndim == 3 and rows.shape[2] == 1:
            rows = rows[..., 0]
        got_c = rows.shape[2] if rows.ndim == 3 else 1
        if rows.shape[1] != self.width or got_c != self.channels:
            raise ValueError(
                f"rows shape {rows.shape} does not match stream "
                f"({self.width} wide, {self.channels}ch)"
            )
        if self.rows_written + rows.shape[0] > self.height:
            raise ValueError("more rows than the declared image height")
        return rows

    def write_rows(self, rows: np.ndarray) -> None:
        rows = self._check(rows)
        self._write(np.ascontiguousarray(rows))
        self.rows_written += rows.shape[0]

    def _write(self, rows: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        """Push written rows toward durability (the stream runner calls
        this before journaling a tile ok — a journal record must never
        claim rows still sitting in a userland buffer)."""

    def close(self) -> None:
        pass

    def __enter__(self) -> "TileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class ArrayTileWriter(TileWriter):
    """Accumulate into one preallocated array (tests / in-memory golden
    compares — the one writer that deliberately materialises)."""

    def __init__(self, height: int, width: int, channels: int):
        super().__init__(height, width, channels)
        shape = (height, width, channels) if channels > 1 else (height, width)
        self.array = np.zeros(shape, np.uint8)

    def _write(self, rows: np.ndarray) -> None:
        self.array[self.rows_written : self.rows_written + rows.shape[0]] = rows


class PNMTileWriter(TileWriter):
    """Raw P5/P6 append — and the one container where a killed stream can
    RESUME: the byte offset of row k is header + k*stride, so `resume()`
    verifies the partial file's length and reopens positioned at the
    next whole row (the stream journal records which tiles those rows
    came from)."""

    def __init__(self, path: str | os.PathLike, height: int, width: int,
                 channels: int, *, _append_rows: int = 0):
        super().__init__(height, width, channels)
        self.path = str(path)
        header = (
            f"{'P6' if channels == 3 else 'P5'}\n{width} {height}\n255\n"
        ).encode()
        if _append_rows:
            self._f = open(self.path, "r+b")
            self._f.seek(len(header) + _append_rows * width * channels)
            self._f.truncate()
            self.rows_written = _append_rows
        else:
            self._f = open(self.path, "wb")
            self._f.write(header)

    @classmethod
    def resume(cls, path: str | os.PathLike, height: int, width: int,
               channels: int, rows_done: int) -> "PNMTileWriter":
        """Reopen a partial stream output at `rows_done` complete rows
        (any trailing partial row is truncated away)."""
        w = cls(path, height, width, channels, _append_rows=rows_done)
        return w

    def _write(self, rows: np.ndarray) -> None:
        self._f.write(rows.tobytes())

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self.flush()
        self._f.close()


class PNGTileWriter(TileWriter):
    """Incremental PNG: IHDR up front, one zlib-compressed IDAT chunk per
    band (filter-0 scanlines), IEND at close. The live compressor is the
    only cross-band state, so encoding a gigapixel output holds one
    band + O(32 KiB) of zlib window — never the image. The output reads
    back bit-identically (PNG is lossless; tests decode and compare)."""

    def __init__(self, sink, height: int, width: int, channels: int,
                 *, level: int = 6):
        super().__init__(height, width, channels)
        self._own = isinstance(sink, (str, os.PathLike))
        self._f = open(sink, "wb") if self._own else sink
        self._z = zlib.compressobj(level)
        self._closed = False
        self._f.write(_PNG_SIG)
        color = 2 if channels == 3 else 0
        self._chunk(
            b"IHDR",
            struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0),
        )

    def _chunk(self, typ: bytes, data: bytes) -> None:
        self._f.write(struct.pack(">I", len(data)))
        self._f.write(typ)
        self._f.write(data)
        self._f.write(struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    def _write(self, rows: np.ndarray) -> None:
        n = rows.shape[0]
        flat = rows.reshape(n, -1)
        # filter byte 0 per scanline, then one compressor feed per band
        scan = np.empty((n, flat.shape[1] + 1), np.uint8)
        scan[:, 0] = 0
        scan[:, 1:] = flat
        out = self._z.compress(scan.tobytes())
        out += self._z.flush(zlib.Z_SYNC_FLUSH)
        if out:
            self._chunk(b"IDAT", out)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.rows_written != self.height:
            # still finalise the container so the partial file parses,
            # but the height lie must not pass silently
            from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

            get_logger().warning(
                "PNG stream closed at %d/%d rows", self.rows_written, self.height
            )
        tail = self._z.flush()
        if tail:
            self._chunk(b"IDAT", tail)
        self._chunk(b"IEND", b"")
        self._f.flush()
        if self._own:
            self._f.close()


def open_tile_writer(
    path: str | os.PathLike, height: int, width: int, channels: int
) -> TileWriter:
    """The incremental encoder for `path`'s extension (PNM append/resume,
    streaming PNG); other extensions are rejected — a format that needs
    the whole image in memory to encode defeats the stream."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".ppm", ".pnm"):
        return PNMTileWriter(path, height, width, 3 if channels == 3 else channels)
    if ext == ".pgm":
        return PNMTileWriter(path, height, width, channels)
    if ext == ".png":
        return PNGTileWriter(path, height, width, channels)
    raise UnsupportedStreamFormat(
        f"{path}: no incremental encoder for {ext!r} (use ppm/pgm/png)"
    )
