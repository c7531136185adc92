"""The row-sharded SWAR path on the CPU (``Pipeline.sharded(mesh,
backend='swar')``, ``parallel/api.py``): against the JAX package's sharded
runner on the 8 fake devices of ``tests/conftest.py`` and against the golden
ops, at 2, 4 and 8 slots, even and uneven heights, serial and overlap; and
which groups take the SWAR ghost kernels (K6g, K7g, K8g) with which chains.

Every tolerance is 0: bytes must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.parallel import api, halo
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh


def cpu_mesh(n):
    return pmesh.make_mesh(n, devices=["cpu"] * n)


def _golden(spec, img):
    return Pipeline.parse(spec)(torch.from_numpy(img))


# heights per slot count: even (no pad rows) and uneven (pad rows in the
# last shard, where no group takes the SWAR path)
HEIGHTS = {2: (32, 35), 4: (64, 66), 8: (64, 68)}


@pytest.mark.parametrize("halo_mode", ["serial", "overlap"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("spec", ["contrast:3.5,emboss:3", "gaussian:5", "sobel"])
def test_sharded_swar_matches_jax(spec, n, halo_mode):
    for h in HEIGHTS[n]:
        img = synthetic_image(h, 64, channels=1, seed=h + n)
        want = np.asarray(JaxPipeline.parse(spec).sharded(
            jax_make_mesh(n), backend="swar", halo_mode=halo_mode)(jnp.asarray(img)))
        got = Pipeline.parse(spec).sharded(cpu_mesh(n), backend="swar", halo_mode=halo_mode)(img)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("halo_mode", ["serial", "overlap"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("spec,channels", [
    ("contrast:3.5,gaussian:5,invert", 1),
    ("contrast:3.5,gaussian:5,invert,sharpen,brightness:20", 1),
    ("gaussian:7,emboss:5,box:3", 1),
    ("unsharp,laplacian:4,prewitt", 1),
    ("gaussian:5,threshold:100", 1),
    ("invert,median:3,gaussian:3", 1),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", 3),
    ("grayscale,contrast:3.5,emboss:3", 3),
])
def test_sharded_swar_matches_golden(spec, channels, n, halo_mode):
    for h in HEIGHTS[n]:
        img = synthetic_image(h, 72, channels=channels, seed=h)
        got = Pipeline.parse(spec).sharded(cpu_mesh(n), backend="swar", halo_mode=halo_mode)(img)
        assert torch.equal(got, _golden(spec, img)), h


def _record(monkeypatch):
    calls = []
    real = api.swar_stencil

    def counting(op, img, **kw):
        calls.append((sk.swar_kind(op), kw.get("ghosts") is not None,
                      len(kw.get("pre_ops", ())), len(kw.get("post_ops", ()))))
        return real(op, img, **kw)

    monkeypatch.setattr(api, "swar_stencil", counting)
    return calls


def test_sharded_swar_engages(monkeypatch):
    """The ghost kernel runs once per shard on an eligible group, with the
    contrast prefix and the invert suffix fused (the JAX package's
    test_sharded_swar_engages); with pad rows, under overlap and on colour
    tiles it does not."""
    calls = _record(monkeypatch)
    pipe = Pipeline.parse("contrast:3.5,gaussian:5,invert")
    img = synthetic_image(64, 64, channels=1, seed=17)
    halo.exchanges.reset()
    got = pipe.sharded(cpu_mesh(4), backend="swar")(img)
    assert torch.equal(got, _golden("contrast:3.5,gaussian:5,invert", img))
    assert calls == [("K6-narrow", True, 1, 1)] * 4
    assert halo.exchanges.rounds == 1
    for spec, x, mode in (
            ("contrast:3.5,gaussian:5,invert", synthetic_image(66, 64, channels=1, seed=18),
             "serial"),
            ("contrast:3.5,gaussian:5,invert", img, "overlap"),
            ("invert,gaussian:5,brightness:20", synthetic_image(64, 64, channels=3, seed=1),
             "serial")):
        calls.clear()
        got = Pipeline.parse(spec).sharded(cpu_mesh(4), backend="swar", halo_mode=mode)(x)
        assert torch.equal(got, _golden(spec, x))
        assert calls == []


@pytest.mark.parametrize("spec,want", [
    ("contrast:3.5,emboss:3", [("K7", True, 1, 0)]),
    ("gaussian:5", [("K6-narrow", True, 0, 0)]),
    ("sobel", [("K8", True, 0, 0)]),
    ("gaussian:7,invert", [("K6-wide", True, 0, 1)]),
    # a fusable run between two eligible stencils is the second's pre-chain
    ("contrast:3.5,gaussian:5,invert,sharpen,brightness:20",
     [("K6-narrow", True, 1, 0), ("K7", True, 1, 1)]),
    # an unfittable suffix flushes through K1, the median through K2g
    ("gaussian:5,threshold:100,median:3,sobel",
     [("K6-narrow", True, 0, 0), ("K8", True, 0, 0)]),
])
def test_sharded_swar_groups(spec, want, monkeypatch):
    calls = _record(monkeypatch)
    img = synthetic_image(64, 64, channels=1, seed=21)
    halo.exchanges.reset()
    got = Pipeline.parse(spec).sharded(cpu_mesh(4), backend="swar")(img)
    assert torch.equal(got, _golden(spec, img))
    assert calls == [c for c in want for _ in range(4)]
    stencils = sum(op.halo > 0 for op in Pipeline.parse(spec).ops)
    assert halo.exchanges.rounds == stencils


def test_sharded_swar_on_colour_input_takes_the_cuda_route(monkeypatch):
    """The megakernel chain on RGB: its first group reads a colour tile
    (K2g), the sharpen group a gray one (K7g)."""
    calls = _record(monkeypatch)
    fused = []
    real = api._apply_group_fused
    monkeypatch.setattr(api, "_apply_group_fused", lambda region, pw, st, tiles: (
        fused.append(st.name), real(region, pw, st, tiles))[1])
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    img = synthetic_image(64, 64, channels=3, seed=22)
    got = Pipeline.parse(spec).sharded(cpu_mesh(4), backend="swar")(img)
    assert torch.equal(got, _golden(spec, img))
    assert fused == ["gaussian5"] and calls == [("K7", True, 0, 0)] * 4


def test_cli_run_impl_swar_shards_matches_jax(tmp_path):
    img = synthetic_image(64, 64, channels=3, seed=23)
    src = tmp_path / "in.png"
    save_image(src, img)
    out = tmp_path / "out.png"
    rc = cli.main(["run", "--input", str(src), "--output", str(out), "--impl", "swar",
                   "--shards", "4", "--device", "cpu", "--ops",
                   "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "--gray-output"])
    assert rc == 0
    want = np.asarray(JaxPipeline.parse("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6")
                      .sharded(jax_make_mesh(4), backend="swar")(jnp.asarray(load_image(src))))
    np.testing.assert_array_equal(load_image(out, grayscale=True), want)
