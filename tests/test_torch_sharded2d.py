"""The port's 2-D tile-sharded runner (parallel/api2d.py; `Pipeline.sharded`
on a ('rows', 'cols') mesh, `run --shards RxC`), the counterpart of
tests/test_sharded2d.py, on the CPU.

The port's mesh names the CPU once per slot; the JAX package's
`make_mesh_2d` takes the fake CPU devices of tests/conftest.py, so both
packages see the same decomposition of the same seeded image. The port is
held against the JAX package's `sharded_pipeline_2d` and against the
golden unsharded ops: corner ghosts (the two-phase exchange's point),
global edges on both axes, pad-to-multiple on both axes, global statistics
summed over both axes, geometric ops between segments. Every tolerance is
0: bytes must be equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import parse_shards as jax_parse_shards
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp, pad2d
from mpi_cuda_imagemanipulation_tpu_torch.parallel import api, api2d, halo, mesh as pmesh

HALO_MODES = ("serial", "overlap")


@functools.cache
def _image(h, w, channels=3, seed=7):
    return synthetic_image(h, w, channels=channels, seed=seed)


def _mesh(r, c):
    return pmesh.make_mesh_2d(r, c, devices=["cpu"] * (r * c))


def _check(spec, h, w, mesh_shape=(2, 4), channels=3, seed=7, halo_mode="serial",
           plan="auto", backend="torch", jax_too=True):
    img = _image(h, w, channels, seed)
    golden = Pipeline.parse(spec)(torch.from_numpy(img))
    got = Pipeline.parse(spec).sharded(_mesh(*mesh_shape), backend=backend,
                                       halo_mode=halo_mode, plan=plan)(img)
    assert got.shape == golden.shape and torch.equal(got, golden), (spec, mesh_shape, halo_mode)
    if jax_too:
        jax_fn = JaxPipeline.parse(spec).sharded(jax_make_mesh_2d(*mesh_shape),
                                                 halo_mode=halo_mode, plan=plan)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(jnp.asarray(img))))


@pytest.mark.parametrize("halo_mode", HALO_MODES)
@pytest.mark.parametrize("spec", [
    "grayscale,contrast:3.5,emboss:3",  # the reference pipeline, interior mode
    "gaussian:5",                       # separable, reflect-101, halo 2
    "sobel",                            # two-kernel magnitude
    "erode:5",                          # morphology, edge mode, halo 2
    "median:3",                         # rank filter
    "unsharp",                          # 5x5 non-separable
])
def test_2d_matches_jax_and_golden(spec, halo_mode):
    _check(spec, 64, 96, halo_mode=halo_mode)


@pytest.mark.parametrize("halo_mode", HALO_MODES)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2), (2, 3), (1, 8), (8, 1)])
def test_2d_mesh_geometries(mesh_shape, halo_mode):
    _check("grayscale,gaussian:5,emboss:3", 72, 88, mesh_shape=mesh_shape, halo_mode=halo_mode)


@pytest.mark.parametrize("halo_mode", HALO_MODES)
@pytest.mark.parametrize("hw", [(63, 95), (66, 98), (64, 96)])
def test_2d_pad_to_multiple(hw, halo_mode):
    """1 or 2 pad rows and columns (the overlap form falls back to serial
    there), and exact multiples."""
    _check("gaussian:5", *hw, halo_mode=halo_mode)


@pytest.mark.parametrize("halo_mode", HALO_MODES)
def test_2d_corner_dependence(halo_mode):
    """Two blurs make the corner pixels of inner tiles depend on their
    diagonal neighbour's data: wrong or zero corner ghosts cannot pass."""
    _check("gaussian:5,gaussian:5", 64, 96, halo_mode=halo_mode)


@pytest.mark.parametrize("plan", ["fused", "fused-pallas", "auto"])
def test_2d_plan_stage_forms(plan):
    """A fused stage pays one two-phase round for its grown halo; the walk
    fixes rows before columns, so global corners resolve to the golden
    reflect-of-reflect."""
    halo.exchanges.reset()
    _check("gaussian:5,gaussian:5,emboss:3", 64, 96, plan=plan, jax_too=plan != "auto")
    # one stage: one round on each axis
    assert halo.exchanges.axis_rounds == {"rows": 1, "cols": 1}


def test_2d_per_op_rounds():
    halo.exchanges.reset()
    _check("gaussian:5,emboss:3", 64, 96, plan="off", jax_too=False)
    assert halo.exchanges.axis_rounds == {"rows": 2, "cols": 2}
    assert halo.exchanges.rounds == 4


def test_2d_global_stats_summed_over_both_axes():
    _check("grayscale,equalize", 64, 96)
    _check("grayscale,otsu", 57, 91)  # pad rows and columns masked out


def test_2d_geometric_between_segments():
    _check("grayscale,rot180,gaussian:5", 64, 96)
    _check("crop:3:5:48:80,gaussian:3", 64, 96)


def test_2d_gray_input():
    _check("gaussian:5,sobel", 64, 96, channels=1)


def test_2d_auto_backend_logs_and_matches():
    import logging

    from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

    seen = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: seen.append((rec.levelno, rec.getMessage()))
    logger = get_logger().logger
    logger.addHandler(handler)
    try:
        _check("gaussian:5", 64, 96, backend="auto", jax_too=False)
    finally:
        logger.removeHandler(handler)
    assert any(lvl == logging.INFO and "2-D mesh: tile compute uses the torch ops" in msg
               for lvl, msg in seen)


def test_2d_too_small_rejected():
    img = _image(10, 96)
    with pytest.raises(ValueError, match="below the minimum") as got:
        Pipeline.parse("gaussian:7").sharded(_mesh(4, 2), backend="torch")(img)
    with pytest.raises(ValueError, match="below the minimum") as want:
        JaxPipeline.parse("gaussian:7").sharded(jax_make_mesh_2d(4, 2))(jnp.asarray(img))
    assert str(got.value) == str(want.value)  # the JAX package's wording


@pytest.mark.parametrize("backend", ["cuda", "mxu", "swar"])
def test_2d_rejects_kernel_backends(backend):
    with pytest.raises(ValueError, match="2-D sharding.*'torch' or 'auto'"):
        Pipeline.parse("gaussian:5").sharded(_mesh(2, 4), backend=backend)


@pytest.mark.parametrize("mode", ["reflect101", "edge", "zero"])
@pytest.mark.parametrize("axis", [0, 1])
def test_fix_edge_axis_matches_golden_pad(mode, axis):
    """On a single slot (no neighbour), the exchange and the edge fix along
    one axis reproduce the golden pad2d extension for every edge mode and
    both axes."""
    h = 2
    op = StencilOp(name="t", halo=h, kernels=(np.ones((5, 5), np.float32),), edge_mode=mode,
                   quantize="trunc_clip")
    tile = torch.from_numpy(synthetic_image(11, 13, channels=1, seed=3).astype(np.float32))
    ext = halo.exchange_halo([tile], h, _mesh(1, 1), axis=axis)[0]
    got = api._fix_edge_axis(ext, op, 0, tile.shape[axis], axis)
    pads = (h, h, 0, 0) if axis == 0 else (0, 0, h, h)
    assert torch.equal(got, pad2d(tile, mode, *pads))


def test_column_exchange_carries_corners():
    """The two-phase exchange on a 2 x 2 mesh: each tile's corner ghosts
    are its diagonal neighbour's pixels, relayed through the shared
    neighbour."""
    img = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    m = _mesh(2, 2)
    tiles = [img[:4, :4], img[:4, 4:], img[4:, :4], img[4:, 4:]]
    v = halo.exchange_halo(tiles, 1, m, axis=0)
    ext = halo.exchange_halo(v, 1, m, axis=1)
    assert ext[0].shape == (6, 6)
    assert ext[0][5, 5] == img[4, 4]  # tile (0, 0)'s lower-right corner: tile (1, 1)'s
    assert ext[3][0, 0] == img[3, 3]  # and back
    assert ext[1][5, 0] == img[4, 3] and ext[2][0, 5] == img[3, 4]
    assert ext[0][0, 0] == 0  # the mesh's edge: zeros, which the edge fix rewrites


def test_min_local_matches_jax():
    from mpi_cuda_imagemanipulation_tpu.parallel.api2d import _min_local as jax_min_local

    for pad in range(4):
        for h in range(5):
            assert api2d._min_local(pad, h) == jax_min_local(pad, h)


def test_parse_shards_and_mesh_from_shards():
    for spec in ("4", 4, "2x4", "2X4", "1x8", "1x1"):
        assert pmesh.parse_shards(spec) == jax_parse_shards(spec)
    assert pmesh.mesh_from_shards("1", "cpu") is None
    m = pmesh.mesh_from_shards("2x4", "cpu")
    assert isinstance(m, pmesh.Mesh2D) and m.axis_names == ("rows", "cols")
    assert m.shape == {"rows": 2, "cols": 4} and len(m.devices) == 8
    assert m.coords(5) == (1, 1) and m.local_slots == tuple(range(8)) and not m.distributed
    m18 = pmesh.mesh_from_shards("1x8", "cpu")  # an explicit RxC is 2-D even with a 1
    assert m18.axis_names == ("rows", "cols") and m18.shape == {"rows": 1, "cols": 8}
    assert len(pmesh.mesh_from_shards("1x1", "cpu").devices) == 1
    with pytest.raises(ValueError, match=r"a 2x4 mesh's slots but only 3 devices"):
        pmesh.make_mesh_2d(2, 4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():  # the default is every visible card
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.mesh_from_shards("2x2")


def test_cli_run_2d_shards(tmp_path, capsys):
    """`run --shards 2x4` (default --impl auto, and torch, both halo modes)
    equals the unsharded run; --impl cuda is refused with one line."""
    src, plain = tmp_path / "in.png", tmp_path / "plain.png"
    save_image(src, _image(60, 84, 3, 31))
    assert cli.main(["run", "--input", str(src), "--output", str(plain), "--device", "cpu"]) == 0
    for extra in ([], ["--impl", "torch", "--halo-mode", "overlap"],
                  ["--impl", "torch", "--plan", "fused", "--block", "8"]):
        out = tmp_path / "out.png"
        assert cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                         "--shards", "2x4", *extra]) == 0
        np.testing.assert_array_equal(load_image(out), load_image(plain))
    assert "--block applies to single-device runs" in capsys.readouterr().err
    assert cli.main(["run", "--input", str(src), "--output", str(tmp_path / "x.png"),
                     "--device", "cpu", "--shards", "2x2", "--impl", "cuda"]) == 2
    err = capsys.readouterr().err
    assert "2-D sharding" in err and err.count("\n") == 1
