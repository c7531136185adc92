"""The port's tensor-core route on the CPU, held byte for byte against the
JAX package: ops/mxu_kernels.py (eligibility, the whole-op banded products,
morphology by threshold decomposition, the in-stage arm resolution and K5's
plain version), backend 'mxu' and plan 'fused-pallas-mxu' through every
entry point, sharded and not, and K5's fragment indexing through the
emulator in tests/_torch_k5_emulator.py.

The JAX side runs as its own tests run it: its banded products under
``jax.jit`` (XLA on the CPU refuses an eager bf16 x bf16 -> f32 dot), its
megakernel in interpret mode, its sharded runner on the fake CPU devices of
tests/conftest.py. Where the JAX package itself cannot run a case on the
CPU (its walker under impl='mxu'), the port is held against the golden ops.

Every tolerance is 0: bytes, and float32 sums, must be equal.
"""

import ctypes
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_k5_emulator import emulate_k5_sums

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import mxu_kernels as jmk
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops.spec import pad2d as jax_pad2d
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu.plan import build_plan as jax_build_plan
from mpi_cuda_imagemanipulation_tpu.plan.pallas_exec import plan_callable_pallas
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import BACKENDS, Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import mxu_kernels as mk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import pad2d
from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import plan_callable
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr


def _filter(weights, scale=1.0):
    return "filter:" + "/".join(str(w) for w in weights) + f":{scale}"


# the JAX package's frontier filters (tests/test_mxu_backend.py)
UNDER_2_24 = _filter([65280, 512, 1, 0, 0, 0, 0, 0, 0])  # 255 * sum|w| = 2^24 - 1
OVER_2_24 = _filter([65280, 512, 2, 0, 0, 0, 0, 0, 0])  # 2^24 + 254
INT8_127 = _filter([127, 1, 0, 0, 0, 0, 0, 0, 0])
INT8_128 = _filter([128, 1, 0, 0, 0, 0, 0, 0, 0])
# taps that cancel: on a plane constant along rows the sum is the pixel
# itself, inside 0..255, after partial sums of 255 * 32640
CANCEL_BF16 = _filter([32640, -32640, 1, 0, 0, 0, 0, 0, 0])
CANCEL_INT8 = _filter([127, -127, 1, 0, 0, 0, 0, 0, 0])

# every stencil family of the registry, and ops that are no stencil
REGISTRY_SPECS = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3", "gaussian:5",
    "gaussian:7", "box:1", "box:3", "box:5", "box:7", "sobel", "prewitt", "scharr",
    "sharpen", "unsharp", "laplacian:4", "laplacian:8", "erode:3", "erode:5", "erode:7",
    "dilate:3", "dilate:5", "dilate:7", "median:3", "median:5",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "filter:0.5/1/0.5/1/2/1/0.5/1/0.5:0.125",
    _filter(["1"] * 4 + ["257"] + ["1"] * 4),
    "filter:" + "/".join(str(v) for v in range(-24, 25)) + ":0.01",
    UNDER_2_24, OVER_2_24, INT8_127, INT8_128,
    "invert", "grayscale", "contrast:3.5", "gray2rgb",
]
# the 15 specs of the JAX package's test_stage_valid_mxu_matches_op_valid
STAGE_SPECS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "box:3", "box:5", "box:7", "sharpen",
    "emboss:3", "emboss:5", "emboss101:5", "unsharp", "laplacian:8", "sobel", "prewitt",
    "scharr",
]
STAGE_WIDTHS = [64, 67, 128, 131, 200, 384]


def _img(h, w, ch, seed):
    return synthetic_image(h, w, channels=ch, seed=seed)


def _carry(op, height, width, seed):
    """A width- and height-extended u8-valued float32 carry, as the JAX
    test builds it."""
    h = op.halo
    return synthetic_image(height + 2 * h, width + 2 * h, channels=1, seed=seed).astype(np.float32)


def cpu_mesh(n):
    return pmesh.make_mesh(n, devices=["cpu"] * n)


# --------------------------------------------------------------------------
# Eligibility
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", REGISTRY_SPECS)
def test_eligibility_matches_jax(spec):
    op, jop = make_op(spec), jax_registry.make_op(spec)
    assert mk.mxu_eligible(op) == jmk.mxu_eligible(jop)
    assert mk.mxu_family(op) == jmk.mxu_family(jop)
    assert mk.mxu_int8_ok(op) == jmk.mxu_int8_ok(jop)
    if getattr(op, "family", None) == "stencil":
        assert mk._sep_taps(op) == jmk._sep_taps(jop)


def test_eligibility_frontiers():
    assert mk.mxu_family(make_op(UNDER_2_24)) == "corr3x3"
    assert not mk.mxu_eligible(make_op(OVER_2_24))
    assert not mk.mxu_int8_ok(make_op(UNDER_2_24))
    assert mk.mxu_int8_ok(make_op(INT8_127)) and not mk.mxu_int8_ok(make_op(INT8_128))
    assert mk.mxu_family(make_op("gaussian:7")) == "sep7"  # sum 64: the split's bound
    assert not mk.mxu_int8_ok(make_op("gaussian:7"))  # centre tap 400
    assert mk.mxu_int8_ok(make_op("gaussian:5"))
    assert not mk.mxu_eligible(make_op("median:3"))
    # a bfloat16 round trip decides bf16-exactness, as ml_dtypes does there
    assert mk._bf16_exact([255, 256, 476, 65280, 400]) and not mk._bf16_exact([257])
    assert jmk._bf16_exact(np.array([257.0])) is False


# --------------------------------------------------------------------------
# The whole-op route
# --------------------------------------------------------------------------

PIPELINE_CASES = [
    ("gaussian:5", 1), ("gaussian:7", 1), ("box:5", 1), ("emboss:5", 1),
    ("emboss101:5", 1), ("scharr", 1), ("unsharp", 1),
    ("grayscale,contrast:3.5,emboss:3", 3), ("invert,gaussian:5,threshold:99", 1),
    ("median:3,gaussian:5", 1), ("gaussian:3", 3),
]
SHAPES = [(48, 64, 1), (37, 200, 2), (130, 384, 3)]


@functools.cache
def _jax_pipeline_mxu(spec, h, w, ch, seed, mode):
    ops = jax_registry.make_pipeline_ops(spec)
    img = jnp.asarray(_img(h, w, ch, seed))
    return np.asarray(jax.jit(lambda x: jmk.pipeline_mxu(ops, x, mode=mode))(img))


@pytest.mark.parametrize("mode", ["banded", "hybrid"])
@pytest.mark.parametrize("spec,ch", PIPELINE_CASES)
def test_pipeline_mxu_matches_jax(spec, ch, mode):
    ops = make_pipeline_ops(spec)
    for h, w, seed in SHAPES[:2] if ch == 3 else SHAPES:
        img = torch.from_numpy(_img(h, w, ch, seed))
        want = _jax_pipeline_mxu(spec, h, w, ch, seed, mode)
        golden = Pipeline.parse(spec)(img).numpy()
        np.testing.assert_array_equal(golden, want, err_msg=f"{spec} {h}x{w}")
        for variant in mk.MXU_COL_VARIANTS:
            got = mk.pipeline_mxu(ops, img, mode=mode, col_variant=variant)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{spec} {h}x{w} {variant}")


def test_f32_col_variant_matches_jax(monkeypatch):
    monkeypatch.setenv("MCIM_MXU_COL", "f32")
    jops = jax_registry.make_pipeline_ops("gaussian:7")
    img = _img(130, 384, 1, 5)
    want = np.asarray(jax.jit(lambda x: jmk.pipeline_mxu(jops, x))(jnp.asarray(img)))
    got = mk.mxu_stencil(make_op("gaussian:7"), torch.from_numpy(img), col_variant="f32")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", ["gaussian:5", "emboss101:5", "sobel", "unsharp", "box:1"])
def test_mxu_valid_matches_jax(spec):
    """mxu_valid is a drop-in for op.valid: the same float32 sums as the JAX
    mxu_valid and the golden op.valid on the same pre-extended tile."""
    op, jop = make_op(spec), jax_registry.make_op(spec)
    x = _img(57, 170, 1, 9).astype(np.float32)
    h = op.halo
    xpad = pad2d(torch.from_numpy(x), op.edge_mode, h, h, h, h)
    jpad = jax_pad2d(jnp.asarray(x), jop.edge_mode, h, h, h, h)
    np.testing.assert_array_equal(xpad.numpy(), np.asarray(jpad))
    golden = op.valid(xpad).numpy()
    for mode in mk.MXU_MODES:
        want = np.asarray(jax.jit(lambda xp, m=mode: jmk.mxu_valid(jop, xp, mode=m))(jpad))
        for variant in mk.MXU_COL_VARIANTS:
            got = mk.mxu_valid(op, xpad, mode=mode, col_variant=variant).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{spec} {mode} {variant}")
            np.testing.assert_array_equal(got, golden)


def test_bf16_split_exact_for_all_row_sums():
    """The 64a+b split of every reachable gaussian:7 row sum recombines to
    itself, with both halves bf16-exact (the JAX package's bound)."""
    s = torch.arange(0, 255 * 64 + 1, dtype=torch.float32)
    a = torch.floor(s * (1.0 / 64.0))
    b = s - a * 64.0
    assert a.max() <= 255 and b.max() <= 63
    a16, b16 = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    assert torch.equal(a16 * 64.0 + b16, s)


def test_bf16_matmul_is_not_exact_above_256():
    """Why the plain versions take float32 operands: a bf16 product returns
    bf16, which rounds an integer sum of 257 or more."""
    a = torch.tensor([[255.0, 2.0]], dtype=torch.bfloat16)
    w = torch.tensor([[1.0], [1.0]], dtype=torch.bfloat16)
    assert (a @ w).dtype == torch.bfloat16 and float(a @ w) != 257.0
    assert float(a.float() @ w.float()) == 257.0


def test_matmuls_run_with_tf32_off_and_restore_the_setting():
    seen = []
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        orig = torch.matmul

        def spy(*a, **k):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return orig(*a, **k)

        torch.matmul = spy
        try:
            op = make_op("sobel")
            xe = torch.from_numpy(_carry(op, 20, 40, 3))
            mk.stage_valid_mxu_plain(op, xe, arm="mxu")
            mk.mxu_valid(op, xe)
        finally:
            torch.matmul = orig
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("spec", ["erode:3", "erode:5", "dilate:3", "dilate:5"])
@pytest.mark.parametrize("shape", [(48, 64), (37, 131), (67, 200)])
def test_morphology_identity_matches_golden(spec, shape):
    """Threshold decomposition and digit-packed ones-windowsums against the
    golden rank walk (the JAX package's golden and the port's)."""
    img = _img(*shape, 1, sum(shape))
    want = np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))
    got = mk.mxu_stencil(make_op(spec), torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(Pipeline.parse(spec)(torch.from_numpy(img)).numpy(), want)


def test_morph_digits_match_jax():
    for K in (3, 5, 7):
        M = K * K + 1
        assert mk._morph_digits(M) == jmk._morph_digits(M)
        assert M ** mk._morph_digits(M) - 1 < 1 << 24 <= M ** (mk._morph_digits(M) + 1) - 1


def test_band_matrices_match_jax():
    for taps, h in (((1.0, 4.0, 6.0, 4.0, 1.0), 2), ((1.0,), 0)):
        np.testing.assert_array_equal(mk._band_np(taps, h), jmk._band_np(taps, h))
    w = make_op("emboss:5").kernels[0]
    np.testing.assert_array_equal(mk._band2_np(w, 2), jmk._band2_np(w, 2))


def test_ineligible_op_and_bad_mode_raise():
    with pytest.raises(ValueError, match="no banded-product"):
        mk.mxu_valid(make_op("median:3"), torch.zeros(10, 10))
    with pytest.raises(ValueError, match="unknown mode"):
        mk.mxu_valid(make_op("gaussian:3"), torch.zeros(10, 10), mode="fast")
    with pytest.raises(ValueError, match="column variant"):
        mk.mxu_valid(make_op("gaussian:3"), torch.zeros(10, 10), col_variant="bf16")


# --------------------------------------------------------------------------
# K5's plain version and its fragment indexing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", STAGE_WIDTHS)
@pytest.mark.parametrize("spec", STAGE_SPECS)
def test_stage_valid_mxu_plain_matches_jax(spec, width):
    op, jop = make_op(spec), jax_registry.make_op(spec)
    xe = _carry(op, 40, width, seed=width)
    golden = op.valid(torch.from_numpy(xe)).numpy()
    for arm in ("mxu", "mxu-int8"):
        if arm == "mxu-int8" and not mk.mxu_int8_ok(op):
            continue
        want = np.asarray(jax.jit(lambda x, a=arm: jmk.stage_valid_mxu(jop, x, arm=a))(xe))
        got = mk.stage_valid_mxu_plain(op, torch.from_numpy(xe), arm=arm).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} {width} {arm}")
        np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("spec", STAGE_SPECS + ["box:1", "filter:" + "/".join(
    str(v) for v in range(-24, 25)) + ":0.01", INT8_127, INT8_128])
def test_k5_emulator_matches_plain(spec):
    """K5's fragment loads, band-restricted K ranges and int8 shift,
    replayed in int64 (tests/_torch_k5_emulator.py), give the plain
    version's sums: ragged 16 x 8 tiles, one and several 128-column blocks."""
    op = make_op(spec)
    for height, width in ((21, 67), (40, 131)):
        xe = _carry(op, height, width, seed=height + width)
        for arm in ("mxu", "mxu-int8"):
            if arm == "mxu-int8" and not mk.mxu_int8_ok(op):
                continue
            want = mk.stage_valid_mxu_plain(op, torch.from_numpy(xe), arm=arm)
            accs = [torch.from_numpy(emulate_k5_sums(xe, k, arm)) for k in op.kernels]
            got = mk._combine_scale(op, accs)
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"{spec} {arm}")


def test_k5_emulator_at_the_extremes():
    """The sums at their largest (all 255, 0/255 checkerboards) in both
    forms, the 2^24 - 1 frontier included."""
    for spec in (UNDER_2_24, INT8_127, "laplacian:4", "emboss:5", "unsharp"):
        op = make_op(spec)
        h = op.halo
        yy, xx = np.mgrid[0 : 20 + 2 * h, 0 : 37 + 2 * h]
        board = ((yy + xx) % 2 * 255).astype(np.float32)
        for xe in (np.full_like(board, 255.0), board, 255.0 - board):
            golden = op.valid(torch.from_numpy(xe)).numpy()
            for arm in mk.STAGE_ARMS[1:]:
                if arm == "mxu-int8" and not mk.mxu_int8_ok(op):
                    continue
                accs = [torch.from_numpy(emulate_k5_sums(xe, k, arm)) for k in op.kernels]
                np.testing.assert_array_equal(mk._combine_scale(op, accs).numpy(), golden)
                np.testing.assert_array_equal(
                    mk.stage_valid_mxu_plain(op, torch.from_numpy(xe), arm=arm).numpy(), golden)
    assert float(make_op(UNDER_2_24).valid(torch.full((3, 3), 255.0)).item()) == (1 << 24) - 1


def _exact_sums(plane: np.ndarray, w2d) -> np.ndarray:
    """Valid-mode correlation in int64: the sums K5 must keep exactly."""
    w = np.asarray(w2d, np.float64).astype(np.int64)
    ks = w.shape[0]
    rows, cols = plane.shape[0] - ks + 1, plane.shape[1] - ks + 1
    x = plane.astype(np.int64)
    return sum(w[d, i] * x[d:d + rows, i:i + cols] for d in range(ks) for i in range(ks))


PROBE_PLANES = {
    "zeros": np.zeros((40, 70), np.uint8),
    "full": np.full((40, 70), 255, np.uint8),
    "board": (np.indices((40, 70)).sum(0) % 2 * 255).astype(np.uint8),
    "row-ramp": np.repeat((np.arange(40) * 37 % 256).astype(np.uint8)[:, None], 70, axis=1),
    "random": np.random.default_rng(9).integers(0, 256, (40, 70), dtype=np.uint8),
}


@pytest.mark.parametrize("spec", [UNDER_2_24, CANCEL_BF16, INT8_127, CANCEL_INT8, "gaussian:7",
                                  "sobel", "laplacian:8", "emboss:5"])
def test_k5_sums_probe_is_the_exact_sums(spec):
    """K5's exactness probe (its plain version here) and the emulator of its
    tiling both give the int64 sums, up to 2^24 - 1 on the boundary
    filter."""
    op = make_op(spec)
    for arm in ("mxu", "mxu-int8"):
        if arm == "mxu-int8" and not mk.mxu_int8_ok(op):
            continue
        for name, plane in PROBE_PLANES.items():
            for k, w2d in enumerate(op.kernels):
                exact = _exact_sums(plane, w2d)
                got = ck.k5_sums(op, torch.from_numpy(plane), arm, kernel=k)
                np.testing.assert_array_equal(got.numpy().astype(np.int64), exact,
                                              err_msg=f"{spec} {arm} {name}")
                np.testing.assert_array_equal(emulate_k5_sums(plane, w2d, arm), got.numpy())
    full = ck.k5_sums(make_op(UNDER_2_24), torch.from_numpy(PROBE_PLANES["full"]), "mxu")
    assert float(full.max()) == (1 << 24) - 1


def test_k5_sums_probe_refuses_bad_input():
    x = torch.zeros(8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="int8 form"):
        ck.k5_sums(make_op("gaussian:7"), torch.zeros(12, 12, dtype=torch.uint8), "mxu-int8")
    with pytest.raises(ValueError, match="2-D uint8"):
        ck.k5_sums(make_op("sobel"), x.float(), "mxu")
    with pytest.raises(ValueError, match="kernel"):
        ck.k5_sums(make_op("sharpen"), x, "mxu", kernel=1)


def test_stage_valid_mxu_plain_refuses_unproven_arms():
    with pytest.raises(ValueError, match="not a tensor-core"):
        mk.stage_valid_mxu_plain(make_op("gaussian:3"), torch.zeros(8, 8), arm="vpu")
    with pytest.raises(ValueError, match="int8 form"):
        mk.stage_valid_mxu_plain(make_op("gaussian:7"), torch.zeros(12, 12), arm="mxu-int8")
    with pytest.raises(ValueError, match="in-stage"):
        mk.stage_valid_mxu_plain(make_op("erode:3"), torch.zeros(8, 8), arm="mxu")


def test_int8_boundary_just_under_and_over_2_24():
    under, over = make_op(UNDER_2_24), make_op(OVER_2_24)
    assert mk.stage_arm_for(under, setting="on") == "mxu"
    assert mk.stage_arm_for(over, setting="on") == "vpu"
    xe = _carry(under, 32, 96, seed=4)
    np.testing.assert_array_equal(
        mk.stage_valid_mxu_plain(under, torch.from_numpy(xe), arm="mxu").numpy(),
        under.valid(torch.from_numpy(xe)).numpy(),
    )


def test_int8_operand_bound_127_vs_128():
    ok127, no128 = make_op(INT8_127), make_op(INT8_128)
    assert mk.stage_arm_for(ok127, setting="on") == "mxu-int8"
    assert mk.stage_arm_for(no128, setting="on") == "mxu"
    for op, arms in ((ok127, ("mxu", "mxu-int8")), (no128, ("mxu",))):
        xe = torch.from_numpy(_carry(op, 24, 150, seed=5))
        for arm in arms:
            np.testing.assert_array_equal(
                mk.stage_valid_mxu_plain(op, xe, arm=arm).numpy(), op.valid(xe).numpy())


# --------------------------------------------------------------------------
# In-stage arm resolution and its counters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", STAGE_SPECS + ["erode:3", "median:3", "invert", INT8_128])
def test_stage_arm_for_matches_jax_forced_settings(spec):
    op, jop = make_op(spec), jax_registry.make_op(spec)
    for setting in ("on", "f32", "off"):
        assert mk.stage_arm_for(op, setting=setting) == jmk.stage_arm_for(jop, setting=setting)


def test_stage_fallback_reasons_closed_vocabulary():
    # the JAX package's names with 'not-cuda' for its 'not-tpu', less the
    # setting that repeats another ('int8' is 'on')
    assert mk.STAGE_FALLBACK_REASONS == tuple(
        "not-cuda" if r == "not-tpu" else r for r in jmk.STAGE_FALLBACK_REASONS)
    assert mk.STAGE_ARMS == jmk.STAGE_ARMS
    assert mk.MXU_STAGE_SETTINGS == tuple(s for s in jmk.MXU_STAGE_SETTINGS if s != "int8")
    assert jmk.stage_arm_for(jax_registry.make_op("gaussian:5"), setting="int8") == "mxu-int8"
    c = plan_metrics.mxu_stage_fallbacks.__class__()
    with pytest.raises(ValueError, match="unknown mxu-in-stage"):
        mk.count_stage_fallback(c, "typo-reason")
    mk.count_stage_fallback(c, "off")
    assert c == {"off": 1}
    with pytest.raises(ValueError, match="unknown mxu_stage setting"):
        mk.stage_arm_for(make_op("gaussian:5"), setting="always")
    plan_metrics.reset()
    gauss = make_op("gaussian:5")
    assert mk.stage_arm_for(gauss, setting="off") == "vpu"
    assert mk.stage_arm_for(make_op("erode:3"), setting="on") == "vpu"
    # 'auto' (and no setting): off a CUDA device the VPU arm, as the JAX
    # package's 'not-tpu'
    assert mk.stage_arm_for(gauss) == "vpu"
    assert mk.stage_arm_for(gauss, setting="auto") == "vpu"
    assert dict(plan_metrics.mxu_stage_fallbacks) == {"off": 1, "family": 1, "not-cuda": 2}
    # ops with no banded formulation are not counted
    for spec in ("median:3", "invert", OVER_2_24):
        assert mk.stage_arm_for(make_op(spec), setting="on") == "vpu"
    assert sum(plan_metrics.mxu_stage_fallbacks.values()) == 4
    assert mk.stage_arm_for(gauss, setting="on") == "mxu-int8"
    assert mk.stage_arm_for(gauss, setting="f32") == "mxu"
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 1, "mxu": 1}
    assert plan_metrics.snapshot()["mxu_stage_ops"] == 2


def test_counters_advance_once_per_stage_build_and_once_per_plain_call():
    ops = make_pipeline_ops("grayscale,gaussian:5,sharpen")
    img = torch.from_numpy(_img(40, 70, 3, 1))
    plan_metrics.reset()
    fn = plan_callable_cuda(build_plan(ops, "fused-pallas-mxu"), mxu_stage="on")
    assert dict(plan_metrics.mxu_stage_ops) == {}  # resolved at the stage's first launch
    for _ in range(3):
        fn(img)
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 2}
    assert plan_metrics.pallas_stages == 3
    plan_metrics.reset()
    walker = plan_callable(build_plan(ops, "fused-pallas-mxu"), mxu_stage="on")
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 2}  # at build
    walker(img)
    walker(img)
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 2}
    plan_metrics.reset()
    for _ in range(2):  # the wrappers and plain versions: once per call
        ck.fused_stage(ops, img, mxu_stage="on")
        ck.fused_stage_plain(ops, img, mxu_stage="f32")
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 4, "mxu": 4}
    ck.fused_stage(ops, img, arms=ck.stage_arms(ops, "on"))  # given arms: counted where resolved
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 6, "mxu": 4}
    plan_metrics.reset()
    ck.fused_stage(ops, img)  # the default setting is 'auto': the VPU arm, counted
    assert dict(plan_metrics.mxu_stage_fallbacks) == {"not-cuda": 2}
    assert dict(plan_metrics.mxu_stage_ops) == {}


# --------------------------------------------------------------------------
# The K4 program with arms, and the wrappers on the CPU
# --------------------------------------------------------------------------


def test_program_carries_arms_under_the_parameter_limit():
    ops = make_pipeline_ops("grayscale,gaussian:5,median:3,sobel,gaussian:7")
    arms = ck.stage_arms(ops, "on")
    assert arms == ("vpu", "mxu-int8", "vpu", "mxu-int8", "mxu")
    prog = ck.stage_program(ops, 3, arms)
    rows = prog.stencil_rows()
    assert [r.arm for r in rows] == [kr.FS_ARM_INT8, kr.FS_ARM_VPU, kr.FS_ARM_INT8,
                                     kr.FS_ARM_BF16]
    # the separable stencils on a tensor-core arm carry their 2-D kernel
    np.testing.assert_array_equal(
        np.asarray(rows[0].st.w0[:25]), ops[1].kernels[0].reshape(-1))
    np.testing.assert_array_equal(
        np.asarray(rows[3].st.w0[:49]), ops[4].kernels[0].reshape(-1))
    assert prog.c_out == 1 and prog.mma and prog.kmax == 7
    vpu_prog = ck.stage_program(ops, 3)
    vpu_rows = vpu_prog.stencil_rows()
    assert [r.arm for r in vpu_rows] == [0] * 4 and not any(vpu_rows[0].st.w0)
    assert not vpu_prog.mma
    # the stage goes to the card as a table; the launch's parameters stay
    # far under CUDA's limit whatever the stage's length
    assert ck.stage_program(ops[1:] * 9, 1).table_bytes == 9 * (4 * 16 + 4 * 448)
    other = 4 * ctypes.sizeof(ctypes.c_void_p) + 16 * ctypes.sizeof(ctypes.c_int)
    assert other <= kr.KERNEL_PARAM_BYTES
    for bad_ops, bad_arms, msg in (
        (make_pipeline_ops("median:3"), ("mxu",), "in-stage"),
        (make_pipeline_ops("gaussian:7"), ("mxu-int8",), "int8 form"),
        (make_pipeline_ops("invert"), ("mxu",), "in-stage"),
        (make_pipeline_ops("sobel"), ("gpu",), "unknown stage arm"),
        (make_pipeline_ops("sobel"), ("vpu", "vpu"), "2 arms"),
    ):
        with pytest.raises(ValueError, match=msg):
            ck.stage_program(bad_ops, 1, bad_arms)


@pytest.mark.parametrize("spec", [
    "gaussian:5,sharpen", "invert,gaussian:5,sharpen,quantize:6", "sobel,box:3",
    "emboss:5,emboss:3", "erode:5,gaussian:3", "median:3,box:5", "unsharp,gaussian:7,box:1",
])
def test_wrappers_with_k5_arms_match_golden_on_cpu(spec):
    ops = make_pipeline_ops(spec)
    for h, w, ch in ((37, 150, 3), (70, 131, 1)):
        img = torch.from_numpy(_img(h, w, ch, h))
        golden = Pipeline.parse(spec)(img)
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            assert torch.equal(ck.fused_stage(ops, img, arms=arms), golden)
            assert torch.equal(ck.fused_stage_plain(ops, img, arms=arms), golden)
    ck.reset_launch_counts()
    assert ck.launch_counts() == dict.fromkeys(
        ["K1", "K2", "K2g", "K3", "K4", "K4g", "K5-bf16", "K5-int8", "K6-narrow", "K6-wide",
         "K7", "K8", "K6g-narrow", "K6g-wide", "K7g", "K8g", "T4-copy", "T4-smem-copy",
         "T4-bitcast-store", "T4-bitcast-load", "T2", "T3", "T1-pw", "T1", "T1g"], 0)


# --------------------------------------------------------------------------
# The slice through its entry points
# --------------------------------------------------------------------------

MEGA_SPECS = ["gaussian:5,sharpen", "invert,gaussian:5,sharpen,quantize:6", "sobel,box:3",
              "emboss:5,emboss:3", "erode:5,gaussian:3", "median:3,box:5"]


@functools.cache
def _jax_megakernel(spec, h, w, ch, mxu_stage):
    jops = jax_registry.make_pipeline_ops(spec)
    fn = plan_callable_pallas(jax_build_plan(jops, "fused-pallas-mxu"), mxu_stage=mxu_stage,
                              interpret=True)
    return np.asarray(fn(jnp.asarray(_img(h, w, ch, 11))))


@pytest.mark.parametrize("spec", MEGA_SPECS)
def test_fused_pallas_mxu_matches_jax_megakernel(spec):
    """plan='fused-pallas-mxu' under torch (the walker with K5's plain
    version), mxu and cuda (K4 stages with K5 arms, plain on the CPU), and
    plan='fused' under mxu, against the JAX megakernel with the arms forced
    on, in interpret mode."""
    h, w, ch = 24, 140, 1
    want = _jax_megakernel(spec, h, w, ch, "on")
    img = _img(h, w, ch, 11)
    pipe = Pipeline.parse(spec)
    for backend, plan in (("torch", "fused-pallas-mxu"), ("mxu", "fused-pallas-mxu"),
                          ("cuda", "fused-pallas-mxu"), ("mxu", "fused"), ("mxu", "pointwise"),
                          ("mxu", "off"), ("mxu", "auto")):
        got = pipe.jit(backend, device="cpu", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{spec} {backend}/{plan}")


def test_fused_pallas_mxu_f32_setting_matches_jax_megakernel():
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    want = _jax_megakernel(spec, 29, 64, 3, "f32")
    plan_metrics.reset()
    got = plan_callable_cuda(build_plan(make_pipeline_ops(spec), "fused-pallas-mxu"),
                             mxu_stage="f32")(torch.from_numpy(_img(29, 64, 3, 11)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu": 2}


def test_walker_under_mxu_matches_golden_where_jax_cannot_run():
    """The JAX walker under impl='mxu' dies on XLA's CPU backend (an eager
    bf16 x bf16 -> f32 dot); the port's is held against the golden ops."""
    spec = "gaussian:3,erode:3,dilate:5,median:3"
    img = torch.from_numpy(_img(59, 77, 1, 9))
    golden = np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img.numpy())))
    got = plan_callable(build_plan(make_pipeline_ops(spec), "fused"), impl="mxu")(img)
    np.testing.assert_array_equal(got.numpy(), golden)
    for plan in ("fused", "pointwise", "fused-pallas-mxu", "off"):
        got = Pipeline.parse(spec).jit("mxu", device="cpu", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), golden, err_msg=plan)


def test_walker_routes_accumulators_per_op(monkeypatch):
    calls = []
    orig_valid, orig_plain = mk.mxu_valid, mk.stage_valid_mxu_plain
    from mpi_cuda_imagemanipulation_tpu_torch.plan import exec as pexec

    monkeypatch.setattr(pexec, "mxu_valid", lambda op, x, **k: calls.append(
        ("whole", op.name)) or orig_valid(op, x, **k))
    monkeypatch.setattr(pexec, "stage_valid_mxu_plain", lambda op, x, **k: calls.append(
        ("k5", op.name, k["arm"])) or orig_plain(op, x, **k))
    ops = make_pipeline_ops("gaussian:3,median:3,erode:3,sobel")
    img = torch.from_numpy(_img(30, 40, 1, 2))
    plan_callable(build_plan(ops, "fused"), impl="mxu")(img)
    assert calls == [("whole", "gaussian3"), ("whole", "erode3"), ("whole", "sobel")]
    calls.clear()
    plan_callable(build_plan(ops, "fused-pallas-mxu"), mxu_stage="on")(img)
    assert calls == [("k5", "gaussian3", "mxu-int8"), ("k5", "sobel", "mxu-int8")]
    calls.clear()
    plan_callable(build_plan(ops, "fused"))(img)
    assert calls == []


def test_rejected_stage_under_mxu_keeps_the_banded_products(monkeypatch):
    """A stage K4 rejects runs `pipeline_mxu` under impl 'mxu': its eligible
    stencils keep the banded products, its other ops go to the K1/K2 group
    runner, and nothing walks in plain ops."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan import cuda_exec

    monkeypatch.setattr(cuda_exec, "run_stage_full", lambda *a, **k: pytest.fail("walker"),
                        raising=False)
    runs, whole = [], []
    orig_runner, orig_stencil = ck.pipeline_cuda, mk.mxu_stencil
    monkeypatch.setattr(ck, "pipeline_cuda", lambda ops, img, block_h=None, **kw: runs.append(
        [op.name for op in ops]) or orig_runner(ops, img, block_h=block_h, **kw))
    monkeypatch.setattr(mk, "mxu_stencil", lambda op, img, **k: whole.append(op.name) or
                        orig_stencil(op, img, **k))
    spec = "gamma:2,gaussian:5,median:3,sobel"  # a lookup table: 'lut-op'
    img = torch.from_numpy(_img(33, 60, 1, 4))
    plan_metrics.reset()
    got = Pipeline.parse(spec).jit("mxu", device="cpu", plan="fused-pallas-mxu")(img)
    assert torch.equal(got, Pipeline.parse(spec)(img))
    assert dict(plan_metrics.pallas_fallbacks) == {"lut-op": 1}
    assert runs == [["gamma2"], ["median3"]] and whole == ["gaussian5", "sobel"]


def test_pipeline_mxu_runs_other_ops_through_the_group_runner(monkeypatch):
    runs = []
    orig = ck.pipeline_cuda
    monkeypatch.setattr(ck, "pipeline_cuda", lambda ops, img, block_h=None, **kw: runs.append(
        [op.name for op in ops]) or orig(ops, img, block_h=block_h, **kw))
    spec = "grayscale,contrast:3.5,gaussian:5,median:3,sharpen,quantize:6"
    img = torch.from_numpy(_img(40, 50, 3, 6))
    got = Pipeline.parse(spec).jit("mxu", device="cpu", plan="off")(img)
    assert torch.equal(got, Pipeline.parse(spec)(img))
    assert runs == [["grayscale", "contrast3.5"], ["median3"], ["quantize6"]]


def test_backends_and_plan_resolution():
    from mpi_cuda_imagemanipulation_tpu_torch.plan import resolve_plan_mode

    assert "mxu" in BACKENDS
    ops = make_pipeline_ops("gaussian:5")
    jops = jax_registry.make_pipeline_ops("gaussian:5")
    from mpi_cuda_imagemanipulation_tpu.plan import resolve_plan_mode as jax_resolve

    for mode in ("off", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu", "auto"):
        assert resolve_plan_mode(ops, mode, backend="mxu") == jax_resolve(
            jops, mode, backend="mxu")
    assert resolve_plan_mode(ops, "fused-pallas-mxu", backend="cuda") == "fused-pallas-mxu"
    assert build_plan(ops, "fused-pallas-mxu").mode == "fused-pallas-mxu"
    assert build_plan(ops, "fused-pallas-mxu").fingerprint == jax_build_plan(
        jops, "fused-pallas-mxu").fingerprint


# --------------------------------------------------------------------------
# Sharded
# --------------------------------------------------------------------------


@functools.cache
def _jax_sharded(spec, h, w, ch, seed, n, backend, plan, halo_mode):
    img = _img(h, w, ch, seed)
    fn = JaxPipeline.parse(spec).sharded(
        jax_make_mesh(n), backend=backend, plan=plan, halo_mode=halo_mode)
    return np.asarray(fn(jnp.asarray(img)))


SHARDED_LANES = [("mxu", "off"), ("mxu", "auto"), ("mxu", "fused"), ("mxu", "fused-pallas"),
                 ("mxu", "fused-pallas-mxu"), ("cuda", "fused-pallas-mxu"),
                 ("torch", "fused-pallas-mxu")]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec,h,w,ch", [
    ("grayscale,contrast:3.5,emboss:3", 96, 200, 3),
    ("invert,gaussian:5,median:3,sharpen,quantize:6", 128, 140, 1),
])
def test_sharded_mxu_matches_jax(spec, h, w, ch, n):
    pipe = Pipeline.parse(spec)
    img = _img(h, w, ch, 7)
    for halo_mode in ("serial", "overlap"):
        want = _jax_sharded(spec, h, w, ch, 7, n, "mxu", "off", halo_mode)
        for backend, plan in SHARDED_LANES:
            got = pipe.sharded(cpu_mesh(n), backend=backend, plan=plan, halo_mode=halo_mode)(img)
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"n={n} {backend}/{plan}/{halo_mode}")


def test_sharded_fused_pallas_mxu_matches_jax():
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    want = _jax_sharded(spec, 64, 96, 3, 8, 4, "xla", "fused-pallas-mxu", "serial")
    pipe = Pipeline.parse(spec)
    img = _img(64, 96, 3, 8)
    for backend in ("cuda", "mxu", "torch"):
        plan_metrics.reset()
        got = pipe.sharded(cpu_mesh(4), backend=backend, plan="fused-pallas-mxu")(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)
        assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 2}, backend
        assert plan_metrics.pallas_stages == (0 if backend == "torch" else 1)


def test_sharded_structure_under_mxu(monkeypatch):
    """Which wrapper runs what, and one exchange per stencil or fused stage:
    eligible stencils take the banded products on the extended tile, the
    rest K2g (K3 with pad rows), pointwise runs K1; fused-pallas-mxu runs
    one K4g per shard with the arms resolved once."""
    calls = {}
    for key, fn in ck.KERNEL_WRAPPERS.items():
        calls[key] = 0

        def spy(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, fn.__name__, spy)
    whole = []
    orig = mk.mxu_valid
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    monkeypatch.setattr(api, "mxu_valid", lambda op, x, **k: whole.append(op.name) or orig(
        op, x, **k))
    img = _img(128, 96, 3, 16)

    def run(spec, image=img, **kw):
        for k in calls:
            calls[k] = 0
        whole.clear()
        halo.exchanges.reset()
        out = Pipeline.parse(spec).sharded(cpu_mesh(4), **kw)(image)
        assert torch.equal(out, Pipeline.parse(spec)(torch.from_numpy(image)))
        return {k: v for k, v in calls.items() if v}, len(whole), halo.exchanges.rounds

    spec = "grayscale,contrast:3.5,gaussian:5,median:3,quantize:6"
    assert run(spec, backend="mxu", plan="off") == ({"K1": 8, "K2g": 4}, 4, 2)
    assert run(spec, backend="mxu", plan="off", halo_mode="overlap")[1:] == (12, 2)
    assert run(spec, image=_img(131, 96, 3, 16), backend="mxu", plan="off") == (
        {"K1": 8, "K3": 4}, 4, 2)
    plan_metrics.reset()
    assert run(spec, backend="cuda", plan="fused-pallas-mxu") == ({"K4g": 4}, 0, 1)
    assert dict(plan_metrics.mxu_stage_ops) == {"mxu-int8": 1}


@pytest.mark.parametrize("halo_mode", ["serial", "overlap"])
def test_sharded_mxu_stages_off_k4g_take_the_plan_off_route(monkeypatch, halo_mode):
    """Under backend 'mxu' and a fused-pallas plan, a stage K4g does not take
    (rejected, or any stage under halo_mode='overlap') runs as under plan
    'off': banded products and K1/K2g/K3, never the stage walker."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    for name in ("_apply_stage_serial", "_apply_stage_overlap"):
        monkeypatch.setattr(api, name, lambda *a, **k: pytest.fail("stage walker"))
    counts = {}

    def spy(key, fn):
        return lambda *a, **k: counts.__setitem__(key, counts.get(key, 0) + 1) or fn(*a, **k)

    monkeypatch.setattr(api, "run_stage_cuda_ext", spy("K4g", api.run_stage_cuda_ext))
    monkeypatch.setattr(ck, "stream_stencil_ghost", spy("K2g", ck.stream_stencil_ghost))
    monkeypatch.setattr(ck, "stencil_tile", spy("K3", ck.stencil_tile))
    img = _img(128, 96, 3, 17)
    for spec, mega in (("grayscale,contrast:3.5,gaussian:5,median:3,quantize:6", True),
                       ("gamma:2,gaussian:5,median:3,sharpen", False)):  # 'lut-op'
        for plan in ("fused-pallas", "fused-pallas-mxu"):
            counts.update(K4g=0, K2g=0, K3=0)
            got = Pipeline.parse(spec).sharded(
                cpu_mesh(4), backend="mxu", plan=plan, halo_mode=halo_mode)(img)
            assert torch.equal(got, Pipeline.parse(spec)(torch.from_numpy(img))), (spec, plan)
            if mega and halo_mode == "serial":
                assert counts["K4g"] == 4 and counts["K2g"] == counts["K3"] == 0
            else:  # median:3 through K2g (serial) or three K3 a shard (overlap)
                assert counts["K4g"] == 0
                assert counts["K2g" if halo_mode == "serial" else "K3"] == (
                    4 if halo_mode == "serial" else 12)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,plan", [("mxu", "off"), ("mxu", "auto"), ("cuda", "fused-pallas-mxu"),
                                       ("mxu", "fused-pallas-mxu"), ("torch", "fused-pallas-mxu")])
def test_cli_run_tensor_core_route(tmp_path, impl, plan):
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    src, out, metrics = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "m.jsonl"
    img = _img(33, 47, 3, 40)
    save_image(src, img)
    rc = cli.main(["run", "--input", str(src), "--output", str(out), "--ops", spec,
                   "--impl", impl, "--plan", plan, "--device", "cpu",
                   "--json-metrics", str(metrics)])
    assert rc == 0
    want = np.asarray(JaxPipeline.parse(spec + ",gray2rgb")(jnp.asarray(img)))
    np.testing.assert_array_equal(load_image(out), want)
    rec = json.loads(metrics.read_text().strip())
    assert rec["impl"] == impl and rec["plan"] == plan
    mxu_ops = {"mxu-int8": 2} if plan == "fused-pallas-mxu" else {}
    assert rec["mxu_stage_ops"] == mxu_ops
    assert rec["plan_metrics"]["mxu_stage_ops"] == sum(mxu_ops.values())
    assert rec["mxu_stage_fallbacks"] == {}


def test_cli_sharded_mxu(tmp_path):
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    img = _img(64, 40, 3, 41)
    save_image(src, img)
    for plan in ("off", "fused-pallas-mxu"):
        rc = cli.main(["run", "--input", str(src), "--output", str(out), "--impl", "mxu",
                       "--plan", plan, "--shards", "4", "--device", "cpu"])
        assert rc == 0
        want = np.asarray(JaxPipeline.parse("grayscale,contrast:3.5,emboss:3,gray2rgb")(
            jnp.asarray(img)))
        np.testing.assert_array_equal(load_image(out), want)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["gaussian:5,sharpen", "sobel,box:3", "unsharp,gaussian:7",
                                  "grayscale,contrast:3.5,emboss:3", UNDER_2_24, INT8_127])
def test_k5_matches_plain_on_card(cuda_device, spec):
    ops = make_pipeline_ops(spec)
    x = torch.from_numpy(_img(257, 301, 3, 5)).to(cuda_device)
    for setting in ("on", "f32"):
        arms = ck.stage_arms(ops, setting)
        want = ck.fused_stage_plain(ops, x, arms=arms)
        assert torch.equal(ck.fused_stage(ops, x, arms=arms), want)
        assert torch.equal(want, ck.fused_stage(ops, x, arms=("vpu",) * len(ops)))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [UNDER_2_24, CANCEL_BF16, INT8_127, "gaussian:7", "sobel"])
def test_k5_sums_probe_exact_on_card(cuda_device, spec):
    op = make_op(spec)
    for arm in ("mxu", "mxu-int8") if mk.mxu_int8_ok(op) else ("mxu",):
        for plane in PROBE_PLANES.values():
            for k, w2d in enumerate(op.kernels):
                got = ck.k5_sums(op, torch.from_numpy(plane).to(cuda_device), arm, kernel=k)
                np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                              _exact_sums(plane, w2d))


@pytest.mark.cuda
def test_mxu_paths_match_golden_on_card(cuda_device):
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    pipe = Pipeline.parse(spec)
    x = torch.from_numpy(_img(257, 301, 3, 5)).to(cuda_device)
    want = pipe.jit("torch", device=cuda_device, plan="off")(x)
    for backend, plan in (("mxu", "off"), ("mxu", "fused"), ("cuda", "fused-pallas-mxu"),
                          ("mxu", "fused-pallas-mxu")):
        assert torch.equal(pipe.jit(backend, device=cuda_device, plan=plan)(x), want)
