"""The PyTorch port's golden ops against the JAX package's, on the CPU.

Every pointwise and stencil registry name runs through both packages'
``Pipeline.parse(spec)(img)`` on the same seeded image and must give the
same bytes. The one stated exception is ``filter:`` with non-integer
weights: its float32 tap sums are deterministic per implementation but may
round differently in the last ulp (XLA may contract a multiply and an add
into one fused step), which the quantizer can turn into one u8 step; it is
held to at most 1.
"""

import ast
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.io import image as jax_image
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import filters as jax_filters
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops import spec as jax_spec
from mpi_cuda_imagemanipulation_tpu_torch.io import image as port_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import filters, registry, spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu_torch")

POINTWISE_SPECS = [
    "grayscale", "gray", "grayscale601", "contrast:3.5", "contrast:3",
    "contrast:4.3", "brightness:20", "brightness:-7.5", "invert",
    "threshold:100", "threshold:77.7", "gray2rgb", "sepia", "posterize:3",
    "quantize:6", "solarize:100", "gamma:2.2", "gamma:0.5",
]
STENCIL_SPECS = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3",
    "gaussian:5", "gaussian:7", "box:1", "box:3", "box:5", "sobel", "prewitt",
    "scharr", "sharpen", "unsharp", "laplacian:4", "laplacian:8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "filter:-1/0/1/-2/0/2/-1/0/1",
    "filter:0.1/0.2/0.1/0.2/0.3/0.2/0.1/0.2/0.1",
    "erode:3", "erode:5", "dilate:3", "dilate:7", "median:3", "median:5",
]
SHAPES = {"rgb": (37, 53, 3), "gray": (29, 41, 1)}


def _non_integer_filter(s: str) -> bool:
    if not s.startswith("filter:"):
        return False
    vals = s.split(":")[1].split("/")
    return any(float(v) != int(float(v)) for v in vals)


def _image(kind: str, seed: int) -> np.ndarray:
    h, w, c = SHAPES[kind]
    return port_image.synthetic_image(h, w, channels=c, seed=seed)


def _both(spec_str: str, img: np.ndarray):
    want = np.asarray(JaxPipeline.parse(spec_str)(jnp.asarray(img)))
    got = Pipeline.parse(spec_str)(torch.from_numpy(img)).numpy()
    return got, want


def _assert_port_equals_jax(spec_str, img):
    got, want = _both(spec_str, img)
    assert got.shape == want.shape
    if _non_integer_filter(spec_str):
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


def _fits(spec_str: str, kind: str) -> bool:
    need = {op.in_channels for op in registry.make_pipeline_ops(spec_str)} - {0}
    return not need or need == {3 if kind == "rgb" else 1}


GOLDEN_CASES = [
    (s, kind) for s in POINTWISE_SPECS + STENCIL_SPECS for kind in sorted(SHAPES)
    if _fits(s, kind)
]


@pytest.mark.parametrize("spec_str,kind", GOLDEN_CASES)
def test_golden_op_matches_jax(spec_str, kind):
    _assert_port_equals_jax(spec_str, _image(kind, seed=len(spec_str)))


@pytest.mark.parametrize(
    "spec_str",
    ["grayscale,contrast:3.5,emboss:3", "grayscale601,contrast:3,emboss101:3",
     "sepia,gaussian:5,invert", "grayscale,gray2rgb,sobel,posterize:2",
     "gamma:2.2,median:5,solarize:50", "invert,erode:5,dilate:3"],
)
def test_golden_chains_match_jax(spec_str):
    _assert_port_equals_jax(spec_str, _image("rgb", seed=5))


@pytest.mark.parametrize("spec_str", ["emboss:3", "gaussian:7", "erode:5", "median:5", "unsharp"])
@pytest.mark.parametrize("shape", [(8, 9), (7, 130), (131, 6)])
def test_golden_odd_shapes_match_jax(spec_str, shape):
    img = port_image.synthetic_image(*shape, channels=1, seed=11)
    _assert_port_equals_jax(spec_str, img)


def test_magnitude_sqrt_is_correctly_rounded():
    """Scharr magnitudes pass 2^24; float32 torch.sqrt on the CPU is not
    correctly rounded on every vector path, so the golden path takes the
    root through float64. It must agree with JAX's on a large input."""
    img = port_image.synthetic_image(200, 300, channels=1, seed=2)
    for s in ("scharr", "sobel", "prewitt"):
        _assert_port_equals_jax(s, img)


# an argument for each registry name whose factory needs one
_PROBE_ARGS = {"crop": "crop:1:2:5:6", "pad": "pad:2", "resize": "resize:8x9",
               "scale": "scale:0.5", "rotate": "rotate:30",
               "filter": "filter:1/1/1/1/1/1/1/1/1:0.111"}


def test_every_jax_registry_name_is_registered():
    """Every name builds in the port, with the JAX op's name, halo and
    family (the geometric and global-statistics names too)."""
    assert set(jax_registry.REGISTRY) == set(registry.REGISTRY)
    for name in registry.REGISTRY:
        spec_str = _PROBE_ARGS.get(name, name)
        op, jax_op = registry.make_op(spec_str), jax_registry.make_op(spec_str)
        assert (op.name, op.halo) == (jax_op.name, jax_op.halo), name
        assert registry.op_family(op) == jax_registry.op_family(jax_op), name


def test_pipeline_parse_checks_channels():
    with pytest.raises(ValueError, match="expects 3 channels"):
        registry.make_pipeline_ops("grayscale,grayscale")
    with pytest.raises(ValueError, match="unknown op"):
        registry.make_op("nosuchop")
    with pytest.raises(ValueError):
        Pipeline.parse("grayscale")(torch.zeros((4, 4), dtype=torch.uint8))


def test_filters_are_the_jax_filters():
    names = [n for n in dir(jax_filters) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(getattr(filters, n), getattr(jax_filters, n))
    for size in (3, 5, 7):
        a, sa = filters.gaussian_2d(size)
        b, sb = jax_filters.gaussian_2d(size)
        np.testing.assert_array_equal(a, b)
        assert sa == sb


def test_median_networks_match_jax():
    assert spec.MEDIAN_NETWORKS == jax_spec._MEDIAN_NETWORKS


def _macro_pairs(source: str, macro: str) -> tuple:
    m = re.search(rf"#define {macro}\(X\)(.*?)\n\n", source, re.S)
    assert m, macro
    return tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+),(\d+)\)", m.group(1)))


def test_median_networks_match_cuda_source():
    with open(os.path.join(PORT, "ops", "csrc", "stencil.cuh")) as f:
        src = f.read()
    assert _macro_pairs(src, "ST_MEDIAN9_PAIRS") == spec.MEDIAN_NETWORKS[3][0]
    assert _macro_pairs(src, "ST_MEDIAN25_PAIRS") == spec.MEDIAN_NETWORKS[5][0]
    assert "return p[4];" in src and "return p[12];" in src
    assert spec.MEDIAN_NETWORKS[3][1] == 4 and spec.MEDIAN_NETWORKS[5][1] == 12


def test_pointwise_opcodes_match_cuda_header():
    with open(os.path.join(PORT, "ops", "csrc", "pointwise.cuh")) as f:
        src = f.read()
    header = dict(re.findall(r"\b(PW_[A-Z0-9]+) = (\d+),", src))
    ours = {n: getattr(spec, n) for n in dir(spec) if n.startswith("PW_")}
    assert {k: int(v) for k, v in header.items()} == ours


@pytest.mark.parametrize(
    "args",
    [(32, 48, 3, 0), (17, 33, 1, 4), (300, 20, 3, 9), (5, 7, 1, 1)],
)
def test_synthetic_image_is_byte_identical(args):
    h, w, c, seed = args
    np.testing.assert_array_equal(
        port_image.synthetic_image(h, w, channels=c, seed=seed),
        jax_image.synthetic_image(h, w, channels=c, seed=seed),
    )
    np.testing.assert_array_equal(
        port_image.synthetic_tile(3, h - 3, w, channels=c, seed=seed),
        jax_image.synthetic_tile(3, h - 3, w, channels=c, seed=seed),
    )


def test_image_roundtrip(tmp_path):
    rgb = port_image.synthetic_image(12, 20, seed=1)
    port_image.save_image(tmp_path / "a.png", rgb)
    np.testing.assert_array_equal(port_image.load_image(tmp_path / "a.png"), rgb)
    gray = port_image.load_image(tmp_path / "a.png", grayscale=True)
    np.testing.assert_array_equal(
        gray, np.asarray(jax_registry.grayscale_u8(jnp.asarray(rgb)))
    )
    port_image.save_image(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(port_image.load_image(tmp_path / "g.png")[..., 2], gray)
    with pytest.raises(TypeError):
        port_image.save_image(tmp_path / "f.png", rgb.astype(np.float32))


# --------------------------------------------------------------------------
# Carrying parameters across: the filter banks and tables are the parameters
# --------------------------------------------------------------------------

JAX_STENCIL_OPS = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3",
    "gaussian:5", "gaussian:7", "box:1", "box:3", "box:5", "sobel", "prewitt",
    "scharr", "sharpen", "unsharp", "laplacian:4", "laplacian:8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "erode:3", "dilate:5", "median:3", "median:5",
]


def _desc_from_jax_stencil(op) -> dict:
    return {
        "name": op.name,
        "halo": op.halo,
        "kernels": [np.asarray(k) for k in op.kernels],
        "separable": None if op.separable is None else np.asarray(op.separable),
        "scale": op.scale,
        "combine": op.combine,
        "reduce": op.reduce,
        "edge_mode": op.edge_mode,
        "quantize": op.quantize,
    }


@pytest.mark.parametrize("spec_str", JAX_STENCIL_OPS)
def test_op_from_arrays_roundtrips_stencils(spec_str):
    jax_op = jax_registry.make_op(spec_str)
    op = registry.op_from_arrays(_desc_from_jax_stencil(jax_op))
    ours = registry.make_op(spec_str)
    img = _image("gray", seed=3)
    got = op(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, ours(torch.from_numpy(img)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_op(jnp.asarray(img))))


@pytest.mark.parametrize("spec_str", ["gamma:2.2", "gamma:0.4", "contrast:4.3"])
def test_op_from_arrays_roundtrips_tables(spec_str):
    jax_op = jax_registry.make_op(spec_str)
    table = np.asarray(jax_op(jnp.arange(256, dtype=jnp.uint8)))
    op = registry.op_from_arrays(
        {"name": jax_op.name, "table": table, "in_channels": jax_op.in_channels,
         "out_channels": jax_op.out_channels}
    )
    assert not op.kernel_safe
    img = _image("gray", seed=4)
    got = op(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, registry.make_op(spec_str)(torch.from_numpy(img)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_op(jnp.asarray(img))))


def test_op_from_arrays_rejects_bad_table():
    with pytest.raises(ValueError, match="256"):
        registry.op_from_arrays({"name": "t", "table": np.zeros(10, np.uint8)})


# --------------------------------------------------------------------------
# Import rule: the port never imports JAX or the JAX package
# --------------------------------------------------------------------------


def _port_modules() -> list[str]:
    mods = []
    for dirpath, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_without_jax():
    mods = [m for m in _port_modules() if not m.endswith("__main__")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'mpi_cuda_imagemanipulation_tpu' not in sys.modules\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "mpi_cuda_imagemanipulation_tpu"
        or name.startswith("mpi_cuda_imagemanipulation_tpu.")
    )


def test_port_source_has_no_jax_imports():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}: imports {bad}"
