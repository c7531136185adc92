"""The port imports nothing of JAX and nothing of the JAX package.

Checked two ways: every module of the port, and `chip_smoke.py`, import in
a fresh interpreter in which importing `jax`, `jaxlib` or the JAX package
raises; and no import line of the port's sources or of `chip_smoke.py`
names them.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu_torch")
BLOCKED = ("jax", "jaxlib", "mpi_cuda_imagemanipulation_tpu")

_IMPORT_ALL = f"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = {BLOCKED!r}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())
for name in BLOCKED:
    sys.modules.pop(name, None)
import mpi_cuda_imagemanipulation_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 24  # every module of the port, parallel/* included


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|mpi_cuda_imagemanipulation_tpu)(?![\w])", re.M
)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_lines(path):
    with open(path) as f:
        src = f.read()
    assert not _JAX_IMPORT.findall(src), path
