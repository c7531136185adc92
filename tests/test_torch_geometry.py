"""The port's geometric ops (``ops/geometry.py``) on the CPU, held byte for
byte against the JAX package's ``ops/geometry.py``:

* the cases of tests/test_geometry.py (numpy oracles, the registry's
  parsing and errors, quarter turns, crop and pad, bilinear and nearest
  resize, scale, arbitrary-angle rotate against PIL), each run through both
  packages;
* the host-built maps (``_linear_taps``, ``_nearest_index``,
  ``_rotate_maps``), the counterparts of weights, equal to JAX's arrays for
  odd, even, shrinking and growing sizes and for five angles, and equal
  after their upload;
* ``pad`` past the image side (up to twice it) in every mode;
* every geometric output is contiguous (the kernels refuse views);
* every backend (torch, cuda, swar, mxu, auto) under every plan, against
  the JAX golden ops and the JAX ``pallas`` backend in interpret mode, with
  ops that change the shape;
* the planner: the same stages, fingerprints and ``plan_metrics`` as JAX
  (``commute_geometrics`` moving real rot180/fliph/flipv past pointwise
  runs), and the fused-pallas executor against JAX's megakernel executor;
* ``Pipeline.sharded`` over 2, 3 and 8 CPU slots at heights 128, 131 and
  133 on every backend (both halo modes), against the JAX sharded runner
  on 8 fake devices;
* the CLI's ``run`` on every ``--impl``, ``--plan`` and ``--shards``.

On CPU tensors every kernel wrapper runs its plain version. The tests that
need a card carry the ``cuda`` marker. Every tolerance is 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import geometry as jax_geometry
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu.plan import build_plan as jax_build_plan
from mpi_cuda_imagemanipulation_tpu.plan.metrics import PlanMetrics as JaxPlanMetrics
from mpi_cuda_imagemanipulation_tpu.plan.pallas_exec import plan_callable_pallas
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import geometry
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
    make_op,
    make_pipeline_ops,
    registry_family_table,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import PlanMetrics, build_plan
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import BUILD_MODES

BACKENDS = ("torch", "cuda", "swar", "mxu", "auto")
PLANS = ("off", "auto", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")
# the backend x plan pairs the port runs (cuda refuses the walker modes)
LANES = [(b, p) for b in BACKENDS for p in PLANS
         if not (b in ("cuda", "auto") and p in ("pointwise", "fused"))]
SHARDED_LANES = [("torch", "off", "serial"), ("torch", "fused", "serial"),
                 ("cuda", "off", "serial"), ("cuda", "fused-pallas", "serial"),
                 ("cuda", "fused-pallas-mxu", "serial"), ("swar", "off", "serial"),
                 ("mxu", "off", "serial"), ("mxu", "fused-pallas", "serial"),
                 ("auto", "auto", "serial"), ("cuda", "off", "overlap"),
                 ("torch", "fused", "overlap")]
GEOMETRIC_SPECS = ["fliph", "mirror", "flipv", "flip", "transpose", "rot", "rot:180", "rot:270",
                   "rot90", "rot180", "rot270", "crop:3:5:20:30", "pad:4", "pad:3:reflect101",
                   "pad:2:edge", "resize:41x53", "resize:17x23:nearest", "scale:0.5",
                   "scale:1.5:nearest", "rotate:30", "rotate:-17:nearest"]


def _jax(spec, img):
    return np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))


def _port(spec, img):
    out = Pipeline.parse(spec)(torch.from_numpy(np.ascontiguousarray(img)))
    assert out.is_contiguous(), spec
    return out.numpy()


def _both(spec, img):
    """The port's bytes, after holding them equal to JAX's."""
    got = _port(spec, img)
    np.testing.assert_array_equal(got, _jax(spec, img), err_msg=spec)
    return got


# --------------------------------------------------------------------------
# numpy oracles (tests/test_geometry.py's)
# --------------------------------------------------------------------------


def _taps(in_len, out_len):
    centers = (np.arange(out_len, dtype=np.float64) + 0.5) * (in_len / out_len) - 0.5
    lo = np.floor(centers)
    w1 = np.rint((centers - lo) * 256.0)
    return (np.clip(lo, 0, in_len - 1).astype(np.int32),
            np.clip(lo + 1, 0, in_len - 1).astype(np.int32), w1)


def _np_resize_bilinear(img, th, tw):
    """Integer-exact oracle of the fixed-point scheme, in int64."""
    if (th, tw) == img.shape[:2]:
        return img.copy()
    ylo, yhi, wy1 = _taps(img.shape[0], th)
    xlo, xhi, wx1 = _taps(img.shape[1], tw)
    x = img.astype(np.int64)
    wy1 = wy1.astype(np.int64).reshape((th, 1) + (1,) * (img.ndim - 2))
    wx1 = wx1.astype(np.int64).reshape((1, tw) + (1,) * (img.ndim - 2))
    wy0, wx0 = 256 - wy1, 256 - wx1
    acc = (x[ylo][:, xlo] * wy0 * wx0 + x[ylo][:, xhi] * wy0 * wx1
           + x[yhi][:, xlo] * wy1 * wx0 + x[yhi][:, xhi] * wy1 * wx1)
    q, rem = acc >> 16, acc & 0xFFFF
    round_up = (rem > 0x8000) | ((rem == 0x8000) & (q & 1 == 1))
    return np.clip(q + round_up, 0, 255).astype(np.uint8)


def _np_resize_nearest(img, th, tw):
    ys = np.clip(np.floor((np.arange(th) + 0.5) * (img.shape[0] / th)), 0,
                 img.shape[0] - 1).astype(np.int32)
    xs = np.clip(np.floor((np.arange(tw) + 0.5) * (img.shape[1] / tw)), 0,
                 img.shape[1] - 1).astype(np.int32)
    return img[ys][:, xs]


# --------------------------------------------------------------------------
# tests/test_geometry.py's cases, through both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name,want_fn", [
    ("fliph", lambda a: a[:, ::-1]),
    ("flipv", lambda a: a[::-1]),
    ("transpose", lambda a: np.swapaxes(a, 0, 1)),
    ("rot90", lambda a: np.rot90(a, k=-1, axes=(0, 1))),
    ("rot180", lambda a: np.rot90(a, k=2, axes=(0, 1))),
    ("rot270", lambda a: np.rot90(a, k=1, axes=(0, 1))),
])
def test_flips_rots_transpose_vs_numpy(channels, name, want_fn):
    img = synthetic_image(37, 53, channels=channels, seed=40)
    np.testing.assert_array_equal(_both(name, img), want_fn(img))


def test_rot_by_angle_and_composition():
    img = synthetic_image(20, 31, channels=3, seed=41)
    np.testing.assert_array_equal(_both("rot:90", img), _both("rot90", img))
    out = torch.from_numpy(img)
    for _ in range(4):
        out = geometry.ROT90(out)
    np.testing.assert_array_equal(out.numpy(), img)
    with pytest.raises(ValueError, match="must be 90/180/270"):
        make_op("rot:45")


def test_crop_and_pad():
    img = synthetic_image(40, 50, channels=3, seed=42)
    np.testing.assert_array_equal(_both("crop:5:7:20:30", img), img[5:25, 7:37])
    with pytest.raises(ValueError, match="exceeds image 40x50"):
        make_op("crop:30:0:20:10")(torch.from_numpy(img))
    with pytest.raises(ValueError, match="crop needs crop:y0:x0:height:width"):
        make_op("crop:5")
    np.testing.assert_array_equal(_both("pad:4", img), np.pad(img, ((4, 4), (4, 4), (0, 0))))
    np.testing.assert_array_equal(_both("pad:3:reflect101", img),
                                  np.pad(img, ((3, 3), (3, 3), (0, 0)), mode="reflect"))
    np.testing.assert_array_equal(_both("pad:2:edge", img),
                                  np.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge"))
    np.testing.assert_array_equal(_both("pad:4,crop:4:4:40:50", img), img)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("th,tw", [(20, 30), (80, 100), (41, 53), (37, 67), (40, 25)])
def test_resize_bilinear_vs_oracle(channels, th, tw):
    img = synthetic_image(37, 53, channels=channels, seed=43)
    got = _both(f"resize:{th}x{tw}", img)
    assert got.shape[:2] == (th, tw)
    np.testing.assert_array_equal(got, _np_resize_bilinear(img, th, tw))


def test_resize_identity_and_nearest():
    img = synthetic_image(32, 48, channels=3, seed=44)
    np.testing.assert_array_equal(_both("resize:32x48", img), img)
    np.testing.assert_array_equal(_both("resize:17x23:nearest", img),
                                  _np_resize_nearest(img, 17, 23))
    np.testing.assert_array_equal(_both("resize:64x96:nearest", img),
                                  np.repeat(np.repeat(img, 2, 0), 2, 1))


def test_scale_factor():
    img = synthetic_image(40, 60, channels=1, seed=45)
    half = _both("scale:0.5", img)
    assert half.shape == (20, 30)
    np.testing.assert_array_equal(half, _np_resize_bilinear(img, 20, 30))
    assert _both("scale:1.5:nearest", img).shape == (60, 90)


@pytest.mark.parametrize("bad", [
    "resize:", "resize:0x10", "pad:0", "pad:2:wrap", "scale:0.5:cubic", "scale:-1",
    "resize:10x10:lanczos", "crop:1:2:3", "crop:0:0:0:4", "rotate:30:cubic", "rotate",
    "rotate:nan", "rotate:inf", "rot:45", "pad", "scale",
])
def test_registry_errors_match_jax(bad):
    """The same ValueError, with the same message, as the JAX registry."""
    with pytest.raises(ValueError) as ours:
        make_op(bad)
    with pytest.raises(ValueError) as theirs:
        jax_registry.make_op(bad)
    assert str(ours.value) == str(theirs.value)


def test_rotate_quarter_turns_match_exact_ops():
    img = synthetic_image(33, 33, channels=1, seed=70)
    np.testing.assert_array_equal(_both("rotate:90", img), _both("rot270", img))
    np.testing.assert_array_equal(_both("rotate:-90", img), _both("rot90", img))


@pytest.mark.parametrize("hw", [(33, 33), (32, 48)])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_rotate_180_and_identity(hw, method):
    img = synthetic_image(*hw, channels=3, seed=71)
    np.testing.assert_array_equal(_both(f"rotate:180:{method}", img), _both("rot180", img))
    np.testing.assert_array_equal(_both(f"rotate:0:{method}", img), img)


def test_rotate_matches_pil_quarter_turn():
    from PIL import Image

    img = synthetic_image(25, 25, channels=1, seed=72)
    pil = np.asarray(Image.fromarray(img).rotate(90, resample=Image.NEAREST))
    np.testing.assert_array_equal(_both("rotate:90:nearest", img), pil)


def test_rotate_close_to_pil_bilinear():
    from PIL import Image

    img = synthetic_image(41, 41, channels=1, seed=73)
    pil = np.asarray(Image.fromarray(img).rotate(30, resample=Image.BILINEAR)).astype(int)
    got = _both("rotate:30", img).astype(int)
    interior = np.s_[12:-12, 12:-12]  # away from the constant-border corners
    assert np.abs(got[interior] - pil[interior]).mean() < 2.0


def test_rotate_refuses_images_past_int32_indices():
    big = torch.zeros((1, 1), dtype=torch.uint8).expand(46341, 46341)  # a view: no memory
    with pytest.raises(ValueError, match="up to 2"):
        make_op("rotate:30")(big)


# --------------------------------------------------------------------------
# The maps, the contiguity of every output, pad past the side
# --------------------------------------------------------------------------


@pytest.mark.parametrize("in_len,out_len", [
    (37, 20), (37, 80), (36, 53), (53, 36), (40, 40), (41, 41), (7, 1), (1, 9), (4320, 2160),
    (7680, 15360),
])
def test_resize_maps_equal_jax(in_len, out_len):
    ours = geometry._linear_taps(in_len, out_len)
    theirs = jax_geometry._linear_taps(in_len, out_len)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    a, b = geometry._nearest_index(in_len, out_len), jax_geometry._nearest_index(in_len, out_len)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # and after the upload (the cached device copy)
    up = geometry._resize_maps(in_len, in_len + 1, out_len, out_len + 2, "bilinear",
                               torch.device("cpu"))
    np.testing.assert_array_equal(up[0].numpy(), ours[0])
    np.testing.assert_array_equal(up[4].numpy().ravel(), ours[2])
    np.testing.assert_array_equal(up[5].numpy().ravel(),
                                  jax_geometry._linear_taps(in_len + 1, out_len + 2)[2])


@pytest.mark.parametrize("angle", [30.0, -17.0, 45.5, 90.0, 181.25])
@pytest.mark.parametrize("hw", [(33, 33), (32, 48), (31, 50)])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_rotate_maps_equal_jax(angle, hw, method):
    ours = geometry._rotate_maps(*hw, angle, method)
    theirs = jax_geometry._rotate_maps(*hw, angle, method)
    if method == "nearest":
        ours, theirs = [ours], [theirs]
    assert len(ours) == len(theirs)
    for (ia, wa), (ib, wb) in zip(ours, theirs):
        assert ia.dtype == ib.dtype and ia.tobytes() == ib.tobytes()
        assert wa.dtype == wb.dtype and wa.tobytes() == wb.tobytes()
    up = geometry._rotate_maps_on(*hw, angle, method, torch.device("cpu"))
    for (ia, wa), (ib, wb) in zip(up, theirs):
        np.testing.assert_array_equal(ia.numpy(), ib.ravel())
        np.testing.assert_array_equal(wa.numpy(), wb)


@pytest.mark.parametrize("spec", GEOMETRIC_SPECS)
@pytest.mark.parametrize("channels", [1, 3])
def test_every_geometric_output_is_contiguous(spec, channels):
    """Every geometric op hands the next kernel a contiguous tensor, from a
    contiguous input, from a view (a column slice) and from a dense
    permuted image (a transposed plane, as the banded products can leave
    one), whose strides ``torch.flip`` would keep."""
    img = synthetic_image(37, 60, channels=channels, seed=3)
    _both(spec, img)
    x = torch.from_numpy(img)
    permuted = torch.from_numpy(np.ascontiguousarray(np.swapaxes(img, 0, 1))).transpose(0, 1)
    for view in (x[:, 3:56], permuted):
        assert not view.is_contiguous()
        out = Pipeline.parse(spec)(view)
        assert out.is_contiguous(), spec
        np.testing.assert_array_equal(out.numpy(), _jax(spec, np.ascontiguousarray(view.numpy())))


@pytest.mark.parametrize("mode", ["zero", "reflect101", "edge"])
@pytest.mark.parametrize("hw", [(5, 7), (1, 4), (2, 2), (6, 1)])
def test_pad_past_the_image_side(mode, hw):
    """Pads from 1 to twice the longer side; ``jnp.pad`` reflects again,
    where ``F.pad`` refuses."""
    for channels in (1, 3):
        img = synthetic_image(*hw, channels=channels, seed=sum(hw))
        for n in sorted({1, hw[0], hw[0] + 1, hw[1], 2 * max(hw)}):
            got = _both(f"pad:{n}:{mode}", img)
            assert got.shape[:2] == (hw[0] + 2 * n, hw[1] + 2 * n)


# --------------------------------------------------------------------------
# Every backend and plan, unsharded
# --------------------------------------------------------------------------

BACKEND_SPECS = [
    "grayscale,resize:96x64,gaussian:5",
    "rot90,gaussian:3",
    "grayscale,scale:0.5,sobel",
    "fliph,emboss:3,flipv",
    "transpose,brightness:30",
    "rot:90,gaussian:5",
    "transpose,emboss:3",
    "crop:3:5:60:40,gaussian:5",
    "pad:8:reflect101,gaussian:3",
    "grayscale,scale:2,sobel",
    "rotate:30",
    "grayscale,rotate:-17:nearest,gaussian:3",
    "grayscale,invert,rot180,contrast:3.5,gaussian:3,fliph,invert",
    "grayscale,invert,flipv,sobel,quantize:6",
    "pad:5:edge,grayscale,gaussian:5,crop:2:2:70:50",
]


@functools.cache
def _jax_reference(spec, shape, seed):
    """The JAX golden bytes, held equal to the JAX pallas backend in
    interpret mode (as tests/test_geometry.py runs it)."""
    img = synthetic_image(*shape, seed=seed)
    pipe = JaxPipeline.parse(spec)
    golden = np.asarray(pipe(jnp.asarray(img)))
    np.testing.assert_array_equal(np.asarray(pipe.jit("pallas")(jnp.asarray(img))), golden)
    return golden


@pytest.mark.parametrize("spec", BACKEND_SPECS)
def test_every_backend_and_plan_equals_jax(spec):
    img = synthetic_image(72, 56, seed=46)
    want = _jax_reference(spec, (72, 56), 46)
    pipe = Pipeline.parse(spec)
    for backend, plan in LANES:
        got = pipe.jit(backend, device="cpu", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{spec} [{backend}/{plan}]")


def test_geometric_ops_run_as_groups_of_their_own(monkeypatch):
    """Under cuda + off a geometric op is a group of its own between K2
    groups, called through run_group; the kernels after it are handed a
    contiguous image of the new shape."""
    shapes = []
    real = ck.stream_stencil

    def spy(pw, st, img, **kw):
        assert img.is_contiguous()
        # the runners hand the wrappers a stack (one image: a stack of one)
        shapes.append(tuple(img.shape[1:] if kw.get("batched") else img.shape))
        return real(pw, st, img, **kw)

    monkeypatch.setattr(ck, "stream_stencil", spy)
    ops = make_pipeline_ops("gaussian:3,rot90,emboss:3,crop:1:2:20:30,sobel")
    groups = ck.group_ops(ops)
    assert [(len(pw), st.name if st else pw[0].name) for pw, st in groups] == [
        (0, "gaussian3"), (1, "rot90"), (0, "emboss3"), (1, "crop1_2_20_30"), (0, "sobel")]
    img = synthetic_image(40, 56, channels=3, seed=9)
    got = ck.pipeline_cuda(ops, torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), _jax(
        "gaussian:3,rot90,emboss:3,crop:1:2:20:30,sobel", img))
    assert shapes == [(40, 56, 3), (56, 40, 3), (20, 30, 3)]


# --------------------------------------------------------------------------
# The planner and the fused-pallas executor
# --------------------------------------------------------------------------

PLAN_SPECS = BACKEND_SPECS + [
    "invert,brightness:20,rot180,gaussian:3",
    "brightness:10,fliph,invert,flipv,sharpen",
    "gaussian:3,invert,rot180,quantize:6,emboss:3",
]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_plans_and_metrics_equal_jax(spec):
    """The same stages (rot180/fliph/flipv moved left past pointwise runs in
    the fusing modes), fingerprints, pass counts and plan_metrics."""
    ops, jax_ops = make_pipeline_ops(spec), jax_registry.make_pipeline_ops(spec)
    ours, theirs = PlanMetrics(), JaxPlanMetrics()
    for mode in BUILD_MODES:
        plan, want = build_plan(ops, mode), jax_build_plan(jax_ops, mode)
        assert [(s.kind, s.names, s.halo) for s in plan.stages] == [
            (s.kind, s.names, s.halo) for s in want.stages], mode
        assert plan.fingerprint == want.fingerprint, mode
        assert (plan.hbm_passes, plan.hbm_passes_unfused, plan.n_absorbed_ops) == (
            want.hbm_passes, want.hbm_passes_unfused, want.n_absorbed_ops), mode
        ours.on_build(plan)
        theirs.on_build(want)
    assert ours.snapshot() == theirs.snapshot()


def test_commute_moves_real_geometric_ops():
    stages = build_plan(make_pipeline_ops("invert,brightness:20,rot180,gaussian:3"), "fused")
    assert [(s.kind, s.names) for s in stages.stages] == [
        ("geometric", ("rot180",)), ("fused", ("invert", "brightness20", "gaussian3"))]
    stages = build_plan(make_pipeline_ops("invert,rot90,gaussian:3"), "fused")
    assert [s.kind for s in stages.stages] == ["fused", "geometric", "fused"]  # not a permutation


@pytest.mark.parametrize("spec", ["grayscale,invert,rot180,contrast:3.5,gaussian:3,fliph,invert",
                                  "grayscale,resize:96x64,gaussian:5", "transpose,emboss:3"])
def test_fused_pallas_executor_equals_jax_megakernel(spec):
    img = synthetic_image(72, 56, seed=46)
    want = np.asarray(plan_callable_pallas(
        jax_build_plan(jax_registry.make_pipeline_ops(spec), "fused-pallas"), interpret=True,
    )(jnp.asarray(img)))
    got = plan_callable_cuda(build_plan(make_pipeline_ops(spec), "fused-pallas"))(
        torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# Sharded: local slots, padded heights, shape-changing segments
# --------------------------------------------------------------------------

SHARDED_SPECS = [
    "fliph",
    "flipv",
    "grayscale,resize:120x80,gaussian:5",
    "rot180,emboss:3",
    "grayscale,scale:2,sobel",
    "pad:8:reflect101,gaussian:3,crop:8:8:133:64",
    "rotate:30",
    "grayscale,rotate:-17:nearest,gaussian:3",
    "gaussian:3,rot:90,gaussian:5",
]


@functools.cache
def _jax_sharded_8(spec, height):
    img = synthetic_image(height, 64, channels=3, seed=47)
    return np.asarray(JaxPipeline.parse(spec).sharded(jax_make_mesh(8))(jnp.asarray(img)))


@pytest.mark.parametrize("height", [128, 131, 133])
@pytest.mark.parametrize("spec", SHARDED_SPECS)
def test_sharded_equals_jax(spec, height):
    img = synthetic_image(height, 64, channels=3, seed=47)
    want = _jax(spec, img)
    if height == 133:  # the JAX test's own case: its sharded runner agrees
        np.testing.assert_array_equal(_jax_sharded_8(spec, height), want)
    pipe = Pipeline.parse(spec)
    np.testing.assert_array_equal(pipe(torch.from_numpy(img)).numpy(), want)
    for n in (2, 3, 8):
        mesh = pmesh.make_mesh(n, devices=["cpu"] * n)
        for backend, plan, halo_mode in SHARDED_LANES:
            got = pipe.sharded(mesh, backend=backend, plan=plan, halo_mode=halo_mode)(img)
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"{spec} h={height} n={n} {backend}/{plan}/{halo_mode}")


def test_sharded_whole_segment_starts_from_a_numpy_image_on_the_slot_device():
    pipe = Pipeline.parse("rot:90,gaussian:5")
    img = synthetic_image(40, 64, channels=1, seed=2)
    out = pipe.sharded(pmesh.make_mesh(4, devices=["cpu"] * 4), backend="cuda")(img)
    assert isinstance(out, torch.Tensor) and out.shape == (64, 40)
    np.testing.assert_array_equal(out.numpy(), _jax("rot:90,gaussian:5", img))


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["rot:90,gaussian:5", "crop:2:3:30:40,pad:4:edge,emboss:3",
                                  "grayscale,scale:0.5,sobel"])
def test_cli_run_every_impl_plan_and_shards(tmp_path, spec):
    src = tmp_path / "in.png"
    img = synthetic_image(48, 64, channels=3, seed=12)
    save_image(src, img)
    want = _jax(spec, img)
    if want.ndim == 2:
        want = np.repeat(want[..., None], 3, axis=2)  # run's gray -> RGB
    for impl, plan in LANES:
        for shards in ("1", "4"):
            out = tmp_path / f"{impl}-{plan}-{shards}.png"
            argv = ["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                    "--ops", spec, "--impl", impl, "--plan", plan]
            if shards != "1":
                argv += ["--shards", shards]
            assert cli.main(argv) == 0, argv
            np.testing.assert_array_equal(load_image(out), want, err_msg=" ".join(argv))


def test_cli_info_lists_the_geometric_ops_as_ported(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.strip().startswith("geometric:"))
    names = {n.strip() for n in line.split(":", 1)[1].split(",")}
    assert names == {"fliph", "mirror", "flipv", "flip", "transpose", "rot", "rot90", "rot180",
                     "rot270", "crop", "pad", "resize", "scale", "rotate"}
    assert {n for n, f in registry_family_table().items() if f == "geometric"} == names


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", BACKEND_SPECS)
def test_geometry_on_the_card_equals_the_cpu(cuda_device, spec):
    """The maps, gathers and lerps give the card the CPU's bytes, and the
    kernels after each geometric op take its output."""
    img = synthetic_image(72, 56, seed=46)
    want = Pipeline.parse(spec)(torch.from_numpy(img)).numpy()
    for backend in ("cuda", "swar", "mxu"):
        for plan in ("off", "fused-pallas"):
            got = Pipeline.parse(spec).jit(backend, device=cuda_device, plan=plan)(img)
            np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=f"{backend}/{plan}")
