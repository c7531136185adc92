"""Build and load the package's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds. Libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of
the sources and flags, and are built at first use; one ``nvcc`` per source,
all started together.

The flags never include ``--use_fast_math`` or ``-ftz=true``, and
``-fmad=false`` keeps every product and sum its own IEEE-rounded step: the
kernels must reproduce the golden float32 arithmetic bit for bit.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch; the
wrappers in ``ops/cuda_kernels.py`` raise if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = (
    "pointwise", "stream_stencil", "fused_stage", "swar_stencil",
    # the tools' kernels (tools/: roofline_probe T4, packed_proto T2, swar_proto T3,
    # packed_kernels T1)
    "copy_probe", "packed_proto", "swar_proto", "packed_stream",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
    "-shared",
    "-Xcompiler", "-fPIC",
)

# Layouts shared with the C sources (pointwise.cuh, stencil.cuh,
# fused_stage.cu, swar_stencil.cu, copy_probe.cu, packed_stream.cu). A
# pointwise chain goes to K1, K2/K2g, T1 and T2, and a fused stage to
# K4/K4g, as a table of any length on the card
# (ops/cuda_kernels.pointwise_program, stage_program).
ST_MAX_K = 7
FS_OP_STENCIL = 100
# CUDA's limit on a kernel's parameters
KERNEL_PARAM_BYTES = 4096
# each stencil's in-stage arm in the stage table (FS_ARM_* in mma_stage.cuh)
FS_ARM_VPU, FS_ARM_BF16, FS_ARM_INT8 = 0, 1, 2
# copy_probe_launch's element types (CpType in copy_probe.cu)
CP_U8, CP_F32, CP_U32 = 0, 1, 2
# the largest SWAR kernel side whose taps go as kernel parameters
# (SW_MAX_K in swar_stencil.cu)
SW_MAX_K = 7
# planes per launch of T1 (PK_MAX_PLANES in packed_stream.cu, PR_MAX_PLANES
# in packed_run.cuh)
PK_MAX_PLANES = 3


class StencilDesc(ctypes.Structure):
    _fields_ = [
        ("family", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("ksize", ctypes.c_int),
        ("edge_mode", ctypes.c_int),
        ("quantize", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("w0", ctypes.c_float * (ST_MAX_K * ST_MAX_K)),
        ("w1", ctypes.c_float * (ST_MAX_K * ST_MAX_K)),
        ("sep", ctypes.c_float * ST_MAX_K),
    ]


class FsStencil(ctypes.Structure):
    """One stencil row of a fused stage's table (fused_stage.cu): its
    descriptor and its in-stage arm (FS_ARM_*). 448 bytes."""

    _fields_ = [("st", StencilDesc), ("arm", ctypes.c_int)]


class SwarDesc(ctypes.Structure):
    """One SWAR stencil (K6, K7 or K8) with its fused affine chains.
    ``table`` points at int32 device memory: the ``n_pre`` pre-chain steps,
    then the ``n_post`` post-chain steps, each (neg, A, C, m); then K6's 1-D
    taps, or K7's and K8's nonzero taps as (dy * (2 halo + 1) + dx, weight)
    pairs, kernel 0 first. ``bias`` is K7's 255 * sum|w < 0|, or K8's
    common field bias where ``fields`` is set (each kernel's biased sums fit
    a 16-bit field); for K6 wide ``fields`` says 255 * S^2 < 2^16. 64
    bytes."""

    _fields_ = [
        ("kind", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("edge_mode", ctypes.c_int),
        ("quantize", ctypes.c_int),
        ("combine", ctypes.c_int),
        ("interior", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("shift", ctypes.c_int),
        ("bias", ctypes.c_int),
        ("fields", ctypes.c_int),
        ("n_taps", ctypes.c_int * 2),
        ("n_pre", ctypes.c_int),
        ("n_post", ctypes.c_int),
        ("table", ctypes.c_void_p),
    ]


class SwarTaps(ctypes.Structure):
    """The taps of a SWAR kernel of side KS <= SW_MAX_K as kernel parameters
    (swar_stencil.cu), dense integers: K6's 1-D taps at w[t]; K7's kernel
    and K8's first at w[dy * KS + dx], K8's second at w[SW_MAX_K^2 + dy *
    KS + dx]; unread for larger kernels, which read the table. 392
    bytes; each kind's kernel takes the leading ints it reads (K6 7, K7 49,
    K8 98)."""

    _fields_ = [("w", ctypes.c_int * (2 * SW_MAX_K * SW_MAX_K))]


class PkPlanes(ctypes.Structure):
    """The word planes of one T1 launch (packed_stream.cu): the input
    planes, their top and bottom ghost strips (ghost mode only), the output
    planes, unused entries null; then the words from one image of a stack
    to the next in the input and the output planes (full mode). 112
    bytes."""

    _fields_ = [
        ("in_", ctypes.c_void_p * PK_MAX_PLANES),
        ("top", ctypes.c_void_p * PK_MAX_PLANES),
        ("bot", ctypes.c_void_p * PK_MAX_PLANES),
        ("out", ctypes.c_void_p * PK_MAX_PLANES),
        ("in_stride", ctypes.c_longlong),
        ("out_stride", ctypes.c_longlong),
    ]


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``). Raises when there is none: the kernels are never
    replaced by their plain versions on a CUDA tensor."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built"
    )


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def source_digest(name: str) -> str:
    """Hash of one kernel's source, every header in csrc/ and the flags."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Build the named kernels that are not built yet, one ``nvcc`` process
    per source, all running at once. Returns name -> library path."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = paths[n].with_name(f"{paths[n].stem}.{os.getpid()}.tmp.so")
        log = paths[n].with_suffix(".log").open("w")
        proc = subprocess.Popen(
            nvcc_command(nvcc, n, tmp), stdout=log, stderr=subprocess.STDOUT
        )
        procs.append((n, tmp, log, proc))
    failed = []
    for n, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        logs = "\n".join(
            f"--- {n} ---\n" + paths[n].with_suffix(".log").read_text()[-4000:]
            for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be, with the
    argument and result types of its C entry points declared."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "pointwise":
        # ... the chain table and its length, the device, the stream
        lib.pointwise_launch.argtypes = [vp, vp, ll, ci, ci, vp, ci, ci, vp]
        lib.pointwise_launch.restype = ci
        lib.pointwise_split.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, ll, ci, ci,
                                        ctypes.POINTER(ll)]
        lib.pointwise_split.restype = None
    elif name == "stream_stencil":
        st = ctypes.POINTER(StencilDesc)
        # ... the chain table and its length, the descriptor, the block's
        # rows and columns, (full: the stack's images and its input and
        # output strides; ghost: row0, image_h,) the device, the stream
        lib.stream_stencil_launch.argtypes = [
            vp, vp, ci, ci, ci, ci, vp, ci, st, ci, ci, ci, ll, ll, ci, vp,
        ]
        lib.stream_stencil_launch.restype = ci
        lib.stream_stencil_ghost_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, st, ci, ci, ci, ci, ci, vp,
        ]
        lib.stream_stencil_ghost_launch.restype = ci
        lib.stencil_tile_launch.argtypes = [vp, vp, ci, ci, ci, st, ci, ci, ci, vp]
        lib.stencil_tile_launch.restype = ci
        lib.stream_stencil_smem_bytes.argtypes = [ci, ci, ci, ci, ci, ci, ci]
        lib.stream_stencil_smem_bytes.restype = ll
    elif name == "fused_stage":
        # ... the tile's rows and columns, the stage table, its last
        # stencil's descriptor, its ops and stencils, the largest stencil
        # class, mma, two_pass, (full: the stack's images and its input and
        # output strides; ghost: row0, image_h,) the device, the stream
        st = ctypes.POINTER(StencilDesc)
        lib.fused_stage_launch.argtypes = [vp, vp, *[ci] * 8, vp, st, *[ci] * 6, ll, ll, ci, vp]
        lib.fused_stage_launch.restype = ci
        lib.fused_stage_ext_launch.argtypes = [vp, vp, *[ci] * 8, vp, st, *[ci] * 8, vp]
        lib.fused_stage_ext_launch.restype = ci
        lib.fused_stage_smem_bytes.argtypes = [ci] * 8
        lib.fused_stage_smem_bytes.restype = ll
        lib.fused_stage_table_bytes.argtypes = [ci, ci]
        lib.fused_stage_table_bytes.restype = ll
        # ... rows, cols, the row pitch, the descriptor, second, arm, the stream
        lib.k5_sums_launch.argtypes = [vp, vp, ci, ci, ci, ctypes.POINTER(StencilDesc), ci, ci, vp]
        lib.k5_sums_launch.restype = ci
    elif name == "swar_stencil":
        # ... the descriptor, the dense taps, the tile's rows and columns, the
        # stack's planes and its input and output strides, the device, the
        # stream
        lib.swar_stencil_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ctypes.POINTER(SwarDesc), ctypes.POINTER(SwarTaps),
            ci, ci, ci, ll, ll, ci, vp,
        ]
        lib.swar_stencil_launch.restype = ci
        lib.swar_smem_bytes.argtypes = [ci, ci, ci, ci, ci]
        lib.swar_smem_bytes.restype = ll
        for fn in ("swar_desc_bytes", "swar_taps_bytes"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ll
    elif name == "copy_probe":
        # the copies take the device index before the stream
        lib.copy_probe_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
        lib.smem_copy_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        for fn in ("bitcast_store_launch", "bitcast_load_launch"):
            getattr(lib, fn).argtypes = [vp, vp, ci, ci, ci, vp]
        for fn in ("copy_probe_launch", "smem_copy_launch", "bitcast_store_launch",
                   "bitcast_load_launch"):
            getattr(lib, fn).restype = ci
    elif name == "packed_proto":
        # R, G, B, out, H, Wp, the chain table and its length, the device,
        # the stream
        lib.packed_pointwise_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp, ci, ci, vp]
        lib.packed_pointwise_launch.restype = ci
    elif name == "packed_stream":
        pk, st = (ctypes.POINTER(t) for t in (PkPlanes, StencilDesc))
        # ... the chain as a table on the card and its length (vp, ci), the
        # descriptor, the strip's words, the chunk's and the run's rows,
        # (full: the stack's images; ghost: row0, image_h,) the device, the
        # stream
        lib.packed_pointwise_group_launch.argtypes = [pk, ci, ci, ci, ci, vp, ci, ci, vp]
        lib.packed_stream_launch.argtypes = [
            pk, ci, ci, ci, ci, vp, ci, st, ci, ci, ci, ci, ci, vp,
        ]
        lib.packed_stream_ghost_launch.argtypes = [
            pk, ci, ci, ci, ci, vp, ci, st, ci, ci, ci, ci, ci, ci, vp,
        ]
        for fn in ("packed_pointwise_group_launch", "packed_stream_launch",
                   "packed_stream_ghost_launch"):
            getattr(lib, fn).restype = ci
        lib.packed_stream_smem_bytes.argtypes = [ci] * 6
        lib.packed_stream_smem_bytes.restype = ll
        ull = ctypes.c_ulonglong
        lib.packed_pointwise_split.argtypes = [ull, ull, ull, ci, ull, ll, ctypes.POINTER(ll)]
        lib.packed_pointwise_split.restype = None
    elif name == "swar_proto":
        # ext, out, H, Ws, the strip's words, the run's rows, the stream
        lib.swar_proto_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        lib.swar_proto_launch.restype = ci
    return lib
