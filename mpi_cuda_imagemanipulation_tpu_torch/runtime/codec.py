"""ctypes binding of the port's native C++ codec (``libmcim_runtime.so``,
``runtime/native/mcim_runtime.cpp``): binary PPM/PGM read, write and
header, and ``BatchLoader``, an ordered multithreaded prefetching reader.

The library is the port's own build (``runtime/build.py``, under
``build/native/``), made at the first use; the JAX package's library is
never loaded. Where it cannot be built (no g++ or make), ``available()``
is False and ``io/image.py`` decodes with PIL, as the JAX package does
without its build (host I/O, not a device kernel). ``NATIVE_IO`` counts
the images this codec read (``read_image``, each ``BatchLoader`` image)
and wrote (``write_image``), so that a run can show that its PPM/PGM files
went through it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.runtime import build as native_build

# images read and written through the native codec (plain counters; reset
# by assigning 0)
NATIVE_IO = {"read": 0, "write": 0}
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False
_load_lock = threading.Lock()


def _count(kind: str) -> None:
    with _count_lock:
        NATIVE_IO[kind] += 1


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ci, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    lib.mcim_read_header.argtypes = [ctypes.c_char_p, pi, pi, pi]  # path, h, w, c
    lib.mcim_read_header.restype = ci
    lib.mcim_read_image.argtypes = [ctypes.c_char_p, pu8, ctypes.c_size_t]
    lib.mcim_read_image.restype = ci
    lib.mcim_write_image.argtypes = [ctypes.c_char_p, pu8, ci, ci, ci]
    lib.mcim_write_image.restype = ci
    lib.mcim_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ci, ci]
    lib.mcim_loader_create.restype = ctypes.c_int64
    lib.mcim_loader_next.argtypes = [ctypes.c_int64, pu8, ctypes.c_size_t, pi, pi, pi, pi]
    lib.mcim_loader_next.restype = ci
    lib.mcim_loader_destroy.argtypes = [ctypes.c_int64]
    lib.mcim_loader_destroy.restype = None
    lib.mcim_version.argtypes = []
    lib.mcim_version.restype = ci
    return lib


def _load() -> ctypes.CDLL | None:
    """The library, built at the first call; None where it cannot be."""
    global _lib, _load_failed
    with _load_lock:
        if _lib is None and not _load_failed:
            path = native_build.build(verbose=False)
            try:
                _lib = _bind(ctypes.CDLL(str(path))) if path is not None else None
            except OSError:
                _lib = None
            _load_failed = _lib is None
    return _lib


def library_path() -> str | None:
    """The file the loaded library came from (None when not loaded)."""
    lib = _load()
    return None if lib is None else lib._name


def available() -> bool:
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec not built (runtime/build.py needs make and g++)")
    return lib


def read_header(path: str) -> tuple[int, int, int]:
    """(height, width, channels) of a binary PPM/PGM file."""
    lib = _need()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.mcim_read_header(str(path).encode(), ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c))
    if rc != 0:
        raise IOError(f"native codec failed to read header of {path} (rc={rc})")
    return h.value, w.value, c.value


def read_image(path: str) -> np.ndarray:
    """A binary PPM (H, W, 3) or PGM (H, W) file as uint8."""
    lib = _need()
    h, w, c = read_header(path)
    out = np.empty((h, w, c) if c > 1 else (h, w), dtype=np.uint8)
    rc = lib.mcim_read_image(str(path).encode(),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    if rc != 0:
        raise IOError(f"native codec failed to read {path} (rc={rc})")
    _count("read")
    return out


def write_image(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 as PGM, (H, W, 3) as PPM."""
    lib = _need()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    rc = lib.mcim_write_image(str(path).encode(),
                              img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c)
    if rc != 0:
        raise IOError(f"native codec failed to write {path} (rc={rc})")
    _count("write")


class BatchLoader:
    """Ordered, multithreaded prefetching reader over a list of PPM/PGM files.

    Worker threads decode up to 16 images ahead while the consumer (the
    device pipeline) runs: host-side I/O overlapped with device compute,
    the counterpart of the reference's host-device staging
    (kernel.cu:163,202). Iterate to get (index, (H, W[, C]) uint8 array) in
    input order; a file that fails to decode raises IOError at its turn,
    and the next item is the file after it.
    """

    def __init__(self, paths: list[str], n_threads: int = 4):
        self._lib = _need()
        self._paths = [str(p) for p in paths]
        n = len(self._paths)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in self._paths])
        self._handle = self._lib.mcim_loader_create(arr, n, int(n_threads))
        if self._handle < 0:
            self._handle = None
            raise RuntimeError("mcim_loader_create failed")
        self._buf = np.empty(1 << 20, dtype=np.uint8)

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        idx, h, w, c = (ctypes.c_int() for _ in range(4))
        while True:
            rc = self._lib.mcim_loader_next(
                self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._buf.size, ctypes.byref(idx), ctypes.byref(h), ctypes.byref(w),
                ctypes.byref(c),
            )
            if rc == 0:
                raise StopIteration
            if rc == -3:  # buffer too small: grow and retry
                self._buf = np.empty(max(h.value * w.value * max(c.value, 1),
                                         2 * self._buf.size), dtype=np.uint8)
                continue
            if rc < 0:
                raise IOError(f"loader_next failed (rc={rc})")
            break
        if h.value == 0:
            raise IOError(f"failed to decode {self._paths[idx.value]}")
        n = h.value * w.value * c.value
        shape = (h.value, w.value, c.value) if c.value > 1 else (h.value, w.value)
        _count("read")
        return idx.value, self._buf[:n].reshape(shape).copy()

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.mcim_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
