"""T2, the port's packed-word pointwise prototype (``tools/packed_proto.py``,
``ops/csrc/packed_proto.cu``), on the CPU: the plain version against the
JAX tool's ``packed_gray_contrast`` in interpret mode and against the golden
ops; the pack views and lane helpers and ``packed_row_corr_interior``
against the JAX tool's jnp functions (interior columns, as its self-test
checks them). The JAX tool is loaded from ``tools/`` as
``tests/test_swar_proto.py`` loads its neighbour.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module")
def jax_pp():
    spec = importlib.util.spec_from_file_location(
        "packed_proto", os.path.join(_TOOLS, "packed_proto.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rgb(h, w, seed):
    return synthetic_image(h, w, channels=3, seed=seed)


def _planes(rgb):
    return [torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)]


def _golden(rgb):
    return Pipeline.parse("grayscale,contrast:3.5")(torch.from_numpy(rgb)).numpy()


@pytest.mark.parametrize("shape,block_h", [((64, 256), 24), ((64, 256), 128), ((37, 128), 16),
                                           ((130, 64), 24)])
def test_t2_plain_matches_jax_interpret_and_golden(jax_pp, shape, block_h):
    rgb = _rgb(*shape, seed=shape[0])
    r8, g8, b8 = _planes(rgb)
    got = pp.packed_gray_contrast(pp.pack_u8(r8), pp.pack_u8(g8), pp.pack_u8(b8),
                                  block_h=block_h)
    assert got.dtype == torch.int32 and got.shape == (shape[0], shape[1] // 4)
    jr, jg, jb = (jax_pp.pack_u8(jnp.asarray(rgb[..., c])) for c in range(3))
    want = np.asarray(jax_pp.packed_gray_contrast(jr, jg, jb, interpret=True, block_h=block_h))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pp.unpack_u32(got).numpy(), _golden(rgb))


@pytest.mark.parametrize("kind", ["zeros", "full", "board"])
def test_t2_plain_on_extreme_planes(kind):
    yy, xx = np.mgrid[0:36, 0:96]
    plane = {"zeros": np.zeros((36, 96)), "full": np.full((36, 96), 255),
             "board": (yy + xx) % 2 * 255}[kind].astype(np.uint8)
    rgb = np.stack([plane, 255 - plane, plane], axis=-1)
    planes = [pp.pack_u8(p) for p in _planes(rgb)]
    np.testing.assert_array_equal(pp.unpack_u32(pp.packed_gray_contrast(*planes)).numpy(),
                                  _golden(rgb))


def test_pack_views_match_jax(jax_pp):
    plane = synthetic_image(9, 40, channels=1, seed=2)
    words = pp.pack_u8(torch.from_numpy(plane))
    want = np.asarray(jax_pp.pack_u8(jnp.asarray(plane))).view(np.int32)
    np.testing.assert_array_equal(words.numpy(), want)
    back = pp.unpack_u32(words)
    assert back.data_ptr() == words.data_ptr()  # a view, no copy
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_pp.unpack_u32(jnp.asarray(
        want.view(np.uint32)))))
    with pytest.raises(ValueError, match="multiple of 4"):
        pp.pack_u8(torch.zeros((3, 6), dtype=torch.uint8))


def test_lane_helpers_match_jax(jax_pp):
    words = pp.pack_u8(torch.from_numpy(synthetic_image(16, 64, channels=1, seed=7)))
    jwords = jnp.asarray(words.numpy())
    ours, theirs = pp._lanes_i32(words), jax_pp._lanes_i32(jwords)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pp._pack_lanes_i32(ours).numpy(),
                                  np.asarray(jax_pp._pack_lanes_i32(theirs)))
    assert torch.equal(pp._pack_lanes_i32(ours), words)
    for d in range(-3, 4):
        for a, b in zip(pp._shift_lanes(ours, d), jax_pp._shift_lanes(theirs, d)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"d={d}")


@pytest.mark.parametrize("spec,halo", [("gaussian:5", 2), ("gaussian:3", 1), ("gaussian:7", 3),
                                       ("box:5", 2)])
def test_packed_row_corr_interior_matches_jax(jax_pp, spec, halo):
    plane = synthetic_image(64, 256, channels=1, seed=3)
    words = pp.pack_u8(torch.from_numpy(plane))
    w1d = np.asarray(make_op(spec).separable, np.float32).reshape(-1)
    ours = pp.packed_row_corr_interior(words, w1d, halo=halo)
    theirs = jax_pp.packed_row_corr_interior(jnp.asarray(words.numpy()), w1d, halo=halo)
    interior = slice(2, -2)  # word columns whose taps stay inside the row
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy()[:, interior], np.asarray(b)[:, interior])


def test_selftest_and_main_on_the_cpu(capsys):
    pp.selftest(torch.device("cpu"))
    assert pp.main(["--device", "cpu"]) == 0
    assert "all ok" in capsys.readouterr().out


def test_t2_wrapper_refusals():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="three"):
        pp.packed_gray_contrast(a, a, torch.zeros((4, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="three"):
        pp.packed_gray_contrast(a, a, a.to(torch.int64))
    with pytest.raises(ValueError, match=">= 1"):
        pp.packed_gray_contrast(a, a, a, block_h=0)
    ck.reset_launch_counts()
    pp.packed_gray_contrast(a, a, a)
    assert ck.launch_counts()["T2"] == 0  # the plain version ran


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block_h", [((64, 256), 24), ((37, 128), 16), ((4320, 7680), 128)])
def test_t2_kernel_matches_plain_on_card(cuda_device, shape, block_h):
    planes = [pp.pack_u8(p) for p in _planes(_rgb(*shape, seed=1))]
    want = pp.packed_gray_contrast(*planes, block_h=block_h)
    ck.reset_launch_counts()
    got = pp.packed_gray_contrast(*[p.to(cuda_device) for p in planes], block_h=block_h)
    assert torch.equal(got.cpu(), want) and ck.TOOL_LAUNCHES["T2"] == 1
    pp.selftest(cuda_device)
