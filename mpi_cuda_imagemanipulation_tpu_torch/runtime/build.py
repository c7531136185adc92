"""Build the port's native codec: ``python -m
mpi_cuda_imagemanipulation_tpu_torch.runtime.build``.

Runs make on ``runtime/native/`` (g++, no other dependency) into
``build/native/`` at the root of the checkout, never next to the source,
so that the tree stays clean. The library is named by a hash of the source
and the Makefile: a changed source builds anew, and an unchanged one is
built once (`runtime/codec.py` builds it at its first use). Each build
writes a file of its own and renames it into place, so processes that
build at once do not read each other's half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    h = hashlib.sha256()
    for name in ("mcim_runtime.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libmcim_runtime-{h.hexdigest()[:16]}.so"


def build(verbose: bool = True) -> Path | None:
    """Build the library if it is not built yet; its path, or None where
    make or g++ is missing or the build fails (the message on stderr when
    `verbose`)."""
    path = library_path()
    if path.exists():
        return path
    if shutil.which("make") is None or shutil.which("g++") is None:
        if verbose:
            print("native build skipped: make/g++ not available", file=sys.stderr)
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["make", "-s", "-B", "-C", str(NATIVE_DIR), f"TARGET={tmp}"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        if verbose:
            print(proc.stdout, file=sys.stderr)
            print(proc.stderr, file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    if verbose:
        print(f"built {path}")
    return path


if __name__ == "__main__":
    sys.exit(0 if build() else 1)
