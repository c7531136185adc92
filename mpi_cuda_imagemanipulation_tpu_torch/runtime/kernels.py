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
    # the tools' kernels (tools/: roofline_probe T4, packed_proto T2, swar_proto T3)
    "copy_probe", "packed_proto", "swar_proto",
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
# fused_stage.cu, swar_stencil.cu, copy_probe.cu).
PW_MAX_OPS = 8
ST_MAX_K = 7
FS_MAX_OPS = 24
FS_MAX_STENCILS = 8
FS_OP_STENCIL = 100
# CUDA's limit on a kernel's parameters; K4 takes its stage program by value
KERNEL_PARAM_BYTES = 4096
# FsProgram.arm: each stencil's in-stage arm (FS_ARM_* in fused_stage.cu)
FS_ARM_VPU, FS_ARM_BF16, FS_ARM_INT8 = 0, 1, 2
# copy_probe_launch's element types (CpType in copy_probe.cu)
CP_U8, CP_F32, CP_U32 = 0, 1, 2


class PwProgram(ctypes.Structure):
    _fields_ = [
        ("n_ops", ctypes.c_int),
        ("op", ctypes.c_int * PW_MAX_OPS),
        ("p0", ctypes.c_float * PW_MAX_OPS),
        ("p1", ctypes.c_float * PW_MAX_OPS),
    ]


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


class FsProgram(ctypes.Structure):
    """One fused plan stage for K4: ops in order, each a pointwise opcode
    with its parameter or ``FS_OP_STENCIL + j`` for stencil ``st[j]``, which
    runs on in-stage arm ``arm[j]`` (FS_ARM_*). 3784 bytes."""

    _fields_ = [
        ("n_ops", ctypes.c_int),
        ("op", ctypes.c_int * FS_MAX_OPS),
        ("p0", ctypes.c_float * FS_MAX_OPS),
        ("n_stencils", ctypes.c_int),
        ("st", StencilDesc * FS_MAX_STENCILS),
        ("arm", ctypes.c_int * FS_MAX_STENCILS),
    ]


class SwarDesc(ctypes.Structure):
    """One SWAR stencil (K6, K7 or K8) with its fused affine chains.
    ``table`` points at int32 device memory: the ``n_pre`` pre-chain steps,
    then the ``n_post`` post-chain steps, each (neg, A, C, m); then K6's 1-D
    taps, or K7's and K8's nonzero taps as (dy * (2 halo + 1) + dx, weight)
    pairs, kernel 0 first. 64 bytes."""

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
        ("n_taps", ctypes.c_int * 2),
        ("n_pre", ctypes.c_int),
        ("n_post", ctypes.c_int),
        ("table", ctypes.c_void_p),
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
        lib.pointwise_launch.argtypes = [vp, vp, ll, ci, ci, ctypes.POINTER(PwProgram), vp]
        lib.pointwise_launch.restype = ci
    elif name == "stream_stencil":
        lib.stream_stencil_launch.argtypes = [
            vp, vp, ci, ci, ci, ci,
            ctypes.POINTER(PwProgram), ctypes.POINTER(StencilDesc), ci, vp,
        ]
        lib.stream_stencil_launch.restype = ci
        lib.stream_stencil_ghost_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci,
            ctypes.POINTER(PwProgram), ctypes.POINTER(StencilDesc), ci, ci, ci, vp,
        ]
        lib.stream_stencil_ghost_launch.restype = ci
        lib.stencil_tile_launch.argtypes = [
            vp, vp, ci, ci, ci, ctypes.POINTER(StencilDesc), ci, vp,
        ]
        lib.stencil_tile_launch.restype = ci
        lib.stream_stencil_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.stream_stencil_smem_bytes.restype = ll
    elif name == "fused_stage":
        lib.fused_stage_launch.argtypes = [
            vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.POINTER(FsProgram), vp,
        ]
        lib.fused_stage_launch.restype = ci
        lib.fused_stage_ext_launch.argtypes = [
            vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.POINTER(FsProgram), ci, ci, vp,
        ]
        lib.fused_stage_ext_launch.restype = ci
        lib.fused_stage_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.fused_stage_smem_bytes.restype = ll
        lib.k5_sums_launch.argtypes = [vp, vp, ci, ci, ctypes.POINTER(StencilDesc), ci, ci, vp]
        lib.k5_sums_launch.restype = ci
        lib.fused_stage_program_bytes.argtypes = []
        lib.fused_stage_program_bytes.restype = ll
    elif name == "swar_stencil":
        lib.swar_stencil_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ctypes.POINTER(SwarDesc), ci, vp,
        ]
        lib.swar_stencil_launch.restype = ci
        lib.swar_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.swar_smem_bytes.restype = ll
        lib.swar_desc_bytes.argtypes = []
        lib.swar_desc_bytes.restype = ll
    elif name == "copy_probe":
        lib.copy_probe_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        for fn in ("smem_copy_launch", "bitcast_store_launch", "bitcast_load_launch"):
            getattr(lib, fn).argtypes = [vp, vp, ci, ci, ci, vp]
        for fn in ("copy_probe_launch", "smem_copy_launch", "bitcast_store_launch",
                   "bitcast_load_launch"):
            getattr(lib, fn).restype = ci
    elif name == "packed_proto":
        lib.packed_pointwise_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(PwProgram), vp,
        ]
        lib.packed_pointwise_launch.restype = ci
    elif name == "swar_proto":
        lib.swar_proto_launch.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.swar_proto_launch.restype = ci
        lib.swar_proto_smem_bytes.argtypes = [ci]
        lib.swar_proto_smem_bytes.restype = ll
    return lib
