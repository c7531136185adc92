"""Repairs to the PyTorch/CUDA port, each held against the JAX package:

* ``backend='auto'`` in ``Pipeline.jit`` and ``run --impl`` (the default),
  running what ``'cuda'`` runs, as ``Pipeline.sharded`` already did;
* the golden reflect-101 padding on images no wider or taller than the
  halo (``spec.pad2d``), which reflects repeatedly as ``jnp.pad`` does;
* the whole-op ``mxu`` route on images within a stencil's halo: a stencil
  with no banded form (median) runs its golden op there, as the JAX
  ``pipeline_mxu`` does, where the K2 group runner refuses the image;
* SWAR chains of any length (``swar_desc``'s table): a plain registry
  pipeline with 17 or 40 fusable steps before a stencil runs fused on K6,
  routed as the JAX SWAR path routes it.
* pointwise chains of any length on K1, K2, K2g and T1 (a table on the
  card in place of the 8-op by-value program): chains of 9, 17 and 40 ops,
  alone and before a stencil, through ``--impl cuda --plan off``,
  ``Pipeline.sharded`` and T1, equal to the JAX Pallas kernels in interpret
  mode;
* fused stages of any length on K4 and K4g (a table on the card in place
  of the 24-op, 8-stencil by-value program): stages of 26 and 82 ops, nine
  ``box:3`` and twelve ``box:1`` stencils run as one megakernel stage, with
  the JAX package's ``plan_metrics`` and bytes;
* the whole-op ``mxu`` route hands the next kernel a contiguous image: the
  banded products left a gray plane column-major, which the K1 launch after
  it refuses on the card ("the kernels take contiguous images").

Every tolerance is 0: bytes must be equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import pallas_kernels as jax_pallas
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops import swar_kernels as jax_swar
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu.plan.metrics import plan_metrics as jax_plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import BACKENDS, Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import pad2d, reflect101_index
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
from tools import packed_kernels as jax_pk

# --------------------------------------------------------------------------
# backend='auto'
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["grayscale,contrast:3.5,emboss:3", "gaussian:5"])
@pytest.mark.parametrize("plan", ["auto", "off", "fused-pallas"])
def test_jit_auto_equals_cuda_and_jax_auto(spec, plan):
    assert "auto" in BACKENDS
    img = synthetic_image(40, 52, channels=3, seed=21)
    got = Pipeline.parse(spec).jit("auto", device="cpu", plan=plan)(img).numpy()
    cuda = Pipeline.parse(spec).jit("cuda", device="cpu", plan=plan)(img).numpy()
    want = np.asarray(JaxPipeline.parse(spec).jit("auto", plan=plan)(jnp.asarray(img)))
    np.testing.assert_array_equal(got, cuda)
    np.testing.assert_array_equal(got, want)


def test_auto_runs_the_cuda_route(monkeypatch):
    """'auto' reaches the same K1/K2 group runner as 'cuda' (on the CPU its
    plain versions), not the golden ops."""
    seen = []
    real = ck.stream_stencil

    def k2(pointwise, stencil, img, **kw):
        seen.append(stencil.name)
        return real(pointwise, stencil, img, **kw)

    monkeypatch.setattr(ck, "stream_stencil", k2)
    img = synthetic_image(40, 52, channels=3, seed=2)
    Pipeline.parse("gaussian:5").jit("auto", device="cpu")(img)
    assert seen == ["gaussian5"]


def test_unknown_backend_still_refused():
    with pytest.raises(ValueError, match="unknown backend"):
        Pipeline.parse("gaussian:5").jit("pallas", device="cpu")


def _run(tmp_path, name, *extra):
    src = tmp_path / "in.png"
    if not src.exists():
        save_image(src, synthetic_image(33, 64, channels=3, seed=12))
    out = tmp_path / f"{name}.png"
    metrics = tmp_path / f"{name}.jsonl"
    rc = cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                   "--json-metrics", str(metrics), *extra])
    assert rc == 0
    return load_image(out), json.loads(metrics.read_text().splitlines()[-1])


@pytest.mark.parametrize("extra", [(), ("--ops", "gaussian:5", "--plan", "fused-pallas")])
def test_cli_run_defaults_to_impl_auto(tmp_path, extra):
    got, rec = _run(tmp_path, "default", *extra)
    want, rec_cuda = _run(tmp_path, "cuda", "--impl", "cuda", *extra)
    assert rec["impl"] == "auto" and rec_cuda["impl"] == "cuda"
    assert rec["plan_metrics"] == rec_cuda["plan_metrics"]
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# reflect-101 padding on images no wider or taller than the halo
# --------------------------------------------------------------------------

# every stencil of the registry with halo <= 3
NARROW_STENCILS = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3", "gaussian:5",
    "gaussian:7", "box:1", "box:3", "box:5", "box:7", "sobel", "prewitt", "scharr",
    "sharpen", "unsharp", "laplacian:4", "laplacian:8", "erode:3", "erode:7", "dilate:5",
    "median:3", "median:5", "filter:1/2/1/2/4/2/1/2/1:0.0625",
    "filter:" + "/".join(str(v) for v in range(-24, 25)) + ":0.01",
]


@pytest.mark.parametrize("spec", NARROW_STENCILS)
def test_golden_on_images_within_the_halo_matches_jax(spec):
    """Heights and widths 1..halo (and one past it), gray and RGB, against
    the JAX golden ops, through the golden ops and the stage walker."""
    pipe = Pipeline.parse(spec)
    h = pipe.max_halo
    for n in range(1, h + 2):
        for shape in ((n, 11), (11, n), (n, n)):
            for channels in (1, 3):
                img = synthetic_image(*shape, channels=channels, seed=n + channels)
                want = np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))
                for plan in ("off", "fused"):
                    got = pipe.jit("torch", device="cpu", plan=plan)(img).numpy()
                    np.testing.assert_array_equal(got, want, err_msg=f"{shape} {plan}")


@pytest.mark.parametrize("n", range(1, 8))
def test_reflect101_index_matches_numpy(n):
    x = np.arange(n) * 3 + 1
    for before in range(12):
        for after in range(12):
            want = np.pad(x, (before, after), mode="reflect")
            np.testing.assert_array_equal(x[reflect101_index(n, before, after).numpy()], want)
    tile = torch.arange(n * 5, dtype=torch.float32).reshape(n, 5)
    got = pad2d(tile, "reflect101", 4, 9, 6, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.pad(tile.numpy(), ((4, 9), (6, 2)), mode="reflect"))


@pytest.mark.parametrize("spec", ["gaussian:5", "sharpen", "emboss101:5"])
def test_mxu_route_on_images_within_the_halo_matches_jax(spec):
    """The whole-op banded products pad through the golden padding, so, as
    the JAX package's pipeline_mxu, they take such images."""
    from mpi_cuda_imagemanipulation_tpu.ops.mxu_kernels import pipeline_mxu as jax_mxu

    for shape in ((40, 2), (2, 40), (1, 1)):
        img = synthetic_image(*shape, channels=1, seed=3)
        ops = jax_registry.make_pipeline_ops(spec)
        want = np.asarray(jax.jit(lambda x, ops=ops: jax_mxu(ops, x))(jnp.asarray(img)))
        got = Pipeline.parse(spec).jit("mxu", device="cpu", plan="off")(img).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


SMALL_MXU_CASES = [
    ("median:5", (2, 3), 1), ("median:5", (3, 2), 1), ("median:5", (2, 3), 3),
    ("median:5", (3, 2), 3), ("grayscale,median:5", (2, 3), 3),
    ("grayscale,median:5", (3, 2), 3),
] + [("median:3", (1, n), 1) for n in (1, 2, 5, 40)]


@pytest.mark.parametrize("spec,shape,channels", SMALL_MXU_CASES)
def test_mxu_route_runs_golden_stencils_on_images_within_the_halo(spec, shape, channels):
    """A stencil with no banded form on an image no taller or wider than its
    halo runs its golden op under --impl mxu, as the JAX pipeline_mxu runs
    every such op; the group runner refused it before. Counted, by name."""
    from mpi_cuda_imagemanipulation_tpu.ops.mxu_kernels import pipeline_mxu as jax_mxu
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import pipeline_mxu
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    img = synthetic_image(*shape, channels=channels, seed=sum(shape))
    ops = jax_registry.make_pipeline_ops(spec)
    want = np.asarray(jax.jit(lambda x: jax_mxu(ops, x))(jnp.asarray(img)))
    plan_metrics.reset()
    got = Pipeline.parse(spec).jit("mxu", device="cpu", plan="off")(img).numpy()
    np.testing.assert_array_equal(got, want)
    stencil = spec.split(",")[-1].replace(":", "")
    assert dict(plan_metrics.mxu_golden_ops) == {stencil: 1}
    direct = pipeline_mxu(make_pipeline_ops(spec), torch.from_numpy(img))
    np.testing.assert_array_equal(direct.numpy(), want)


def test_mxu_route_keeps_the_group_runner_elsewhere(monkeypatch):
    """Ops other than such stencils keep the K1/K2 route, with no golden op
    counted: a median on an image past its halo goes to K2."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    seen = []
    real = ck.stream_stencil
    monkeypatch.setattr(ck, "stream_stencil",
                        lambda pw, st, img, **kw: seen.append(st.name) or real(pw, st, img, **kw))
    plan_metrics.reset()
    img = synthetic_image(3, 40, channels=3, seed=1)
    got = Pipeline.parse("grayscale,median:3").jit("mxu", device="cpu", plan="off")(img)
    want = Pipeline.parse("grayscale,median:3")(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert seen == ["median3"] and not plan_metrics.mxu_golden_ops


def test_kernel_paths_keep_refusing_narrow_reflect101():
    img = synthetic_image(40, 2, channels=1, seed=1)
    for backend, plan in (("cuda", "off"), ("cuda", "fused-pallas"), ("swar", "off")):
        with pytest.raises(ValueError, match="too small for halo"):
            Pipeline.parse("gaussian:5").jit(backend, device="cpu", plan=plan)(img)
    want = np.asarray(JaxPipeline.parse("gaussian:5")(jnp.asarray(img)))
    got = Pipeline.parse("gaussian:5").jit("torch", device="cpu", plan="off")(img)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# SWAR chains of any length
# --------------------------------------------------------------------------


def _jax_kind(op):
    """The launch-count key of the SWAR kernel the JAX package runs `op` on."""
    if jax_swar.swar_eligible(op):
        return "K6-" + jax_swar._swar_mode(jax_swar._taps_shift(op)[0])
    return "K7" if jax_swar.swar_corr2d_eligible(op) else "K8"


def _route(monkeypatch, module, kind, flush_owner, flush_name):
    """Record a pipeline_swar's decisions: (kernel, pre, post) per SWAR
    launch and ('flush', op names) per fallback run."""
    calls = []
    real_swar, real_flush = module.swar_stencil, getattr(flush_owner, flush_name)

    def swar(op, img, **kw):
        calls.append((kind(op), len(kw.get("pre_ops", ())), len(kw.get("post_ops", ()))))
        return real_swar(op, img, **kw)

    def flush(ops, img, **kw):
        calls.append(("flush", [op.name for op in ops]))
        return real_flush(ops, img, **kw)

    monkeypatch.setattr(module, "swar_stencil", swar)
    monkeypatch.setattr(flush_owner, flush_name, flush)
    return calls


@pytest.mark.parametrize("n", [17, 40])
@pytest.mark.parametrize("tail", ["", ",invert,brightness:-3"])
def test_long_swar_chain_matches_jax(monkeypatch, n, tail):
    spec = "grayscale," + ",".join(["brightness:1"] * n) + ",gaussian:5" + tail
    img = synthetic_image(40, 64, channels=3, seed=n)
    ours = _route(monkeypatch, sk, sk.swar_kind, ck, "pipeline_cuda")
    got = sk.pipeline_swar(make_pipeline_ops(spec), torch.from_numpy(img)).numpy()
    theirs = _route(monkeypatch, jax_swar, _jax_kind, jax_pallas, "pipeline_pallas")
    want = np.asarray(jax_swar.pipeline_swar(jax_registry.make_pipeline_ops(spec),
                                             jnp.asarray(img), interpret=True))
    n_post = 2 if tail else 0
    assert ours == [("flush", ["grayscale"]), ("K6-narrow", n, n_post)]
    assert theirs == ours
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, Pipeline.parse(spec)(torch.from_numpy(img)).numpy())


def test_long_chain_through_jit_swar_and_plain():
    spec = "grayscale," + ",".join(["brightness:1"] * 17) + ",gaussian:5"
    img = synthetic_image(45, 96, channels=3, seed=4)
    got = Pipeline.parse(spec).jit("swar", device="cpu")(img)
    np.testing.assert_array_equal(got.numpy(), Pipeline.parse(spec)(torch.from_numpy(img)).numpy())
    gray = Pipeline.parse("grayscale")(torch.from_numpy(img))
    ops = make_pipeline_ops(",".join(["brightness:1"] * 17))
    chain = tuple(map(sk.swar_fusable, ops))
    st = make_pipeline_ops("gaussian:5")[0]
    plain = sk.swar_stencil_plain(st, gray, pre_chain=chain)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_swar_filter_past_512_tap_words_runs():
    """A 23x23 integer correlation (529 nonzero taps, 1058 tap words) is
    one the JAX package's K8 takes; the port's table holds its taps."""
    import dataclasses

    big = dataclasses.replace(make_pipeline_ops("sobel")[0], name="ones23", halo=11,
                              kernels=(np.ones((23, 23), np.float32),), combine="single",
                              scale=1.0 / 529)
    img = torch.from_numpy(synthetic_image(40, 128, channels=1, seed=5))
    got = sk.swar_stencil(big, img)
    np.testing.assert_array_equal(got.numpy(), big(img).numpy())
    assert sk.swar_kind(big) == "K8"


# --------------------------------------------------------------------------
# Pointwise chains of any length (K1, K2, K2g, T1)
# --------------------------------------------------------------------------

_STEPS = ("brightness:3", "invert", "brightness:-5", "solarize:200")


def _chain(n: int) -> str:
    """n pointwise ops, the steps in turn."""
    return ",".join(_STEPS[k % len(_STEPS)] for k in range(n))


def _jax_pallas(spec, img):
    return np.asarray(jax_pallas.pipeline_pallas(
        jax_registry.make_pipeline_ops(spec), jnp.asarray(img), interpret=True))


@pytest.mark.parametrize("n", [9, 17, 40])
@pytest.mark.parametrize("tail", ["", ",gaussian:5", ",sobel"])
def test_long_pointwise_chain_through_cuda_off_matches_jax(n, tail):
    """``--impl cuda --plan off``: one K1 group (chain alone) or one K2
    group (chain, then the stencil) of n ops; the parent refused any group
    of more than 8."""
    spec = _chain(n) + tail
    img = synthetic_image(40, 56, channels=3, seed=n)
    want = _jax_pallas(spec, img)
    pipe = Pipeline.parse(spec)
    ck.reset_launch_counts()
    got = cli.run_image(pipe, torch.from_numpy(img), impl="cuda", device="cpu", plan="off")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, pipe(torch.from_numpy(img)).numpy())


@pytest.mark.parametrize("n", [12, 40])
def test_long_pointwise_chain_past_k4_falls_back_to_k1_k2(n):
    """Under ``--plan fused-pallas`` a stage of 26 or 82 ops is one K4
    stage, as on the JAX megakernel: the first K4 held 24 ops and ran such a
    stage as K1/K2 groups ('program-too-long'); its table now has no length
    limit."""
    spec = "grayscale," + _chain(n) + ",gaussian:5," + _chain(n)
    ops = make_pipeline_ops(spec)
    assert ck.fused_stage_reject(ops, 36, 48, 3) is None
    img = synthetic_image(36, 48, channels=3, seed=3)
    plan_metrics.reset()
    got = Pipeline.parse(spec).jit("cuda", device="cpu", plan="fused-pallas")(img)
    assert plan_metrics.pallas_stages == 1 and not plan_metrics.pallas_fallbacks
    np.testing.assert_array_equal(got.numpy(), _jax_pallas(spec, img))


# --------------------------------------------------------------------------
# Fused stages of any length on K4 and K4g
# --------------------------------------------------------------------------

LONG_STAGES = {
    "26 ops": "grayscale," + _chain(12) + ",gaussian:5," + _chain(12),
    "nine box:3": ",".join(["box:3"] * 9),
    "twelve box:1": ",".join(["box:1"] * 12),
    "twelve box:1 and box:3": ",".join(["box:1"] * 12 + ["box:3"]),
}
_JAX_REASONS = ("barrier", "lut-op", "no-f32-core", "halo-too-large", "image-too-small",
                "vmem-budget")


def _jax_counts() -> tuple[int, dict]:
    return (int(jax_plan_metrics.pallas_stages.value()),
            {r: int(jax_plan_metrics.pallas_fallbacks.value(reason=r)) for r in _JAX_REASONS})


@pytest.mark.parametrize("sharded", [False, True], ids=["full", "sharded"])
@pytest.mark.parametrize("case", list(LONG_STAGES))
def test_long_stage_runs_as_one_megakernel_stage_like_jax(case, sharded):
    """A stage with more ops or stencils than the first K4 held (24 ops, 8
    stencils) under ``plan='fused-pallas'``: the port's ``plan_metrics``
    (K4 or K4g stages, fallbacks by reason) and bytes equal the JAX
    package's, whose megakernel runs in interpret mode. Whole image through
    ``Pipeline.jit``, and over four CPU slots through ``Pipeline.sharded``
    (K4g; both runners leave a halo-0 stage to the per-group path,
    uncounted)."""
    spec = LONG_STAGES[case]
    img = synthetic_image(96, 40, channels=3, seed=len(spec))
    stages0, falls0 = _jax_counts()
    if sharded:
        want = JaxPipeline.parse(spec).sharded(jax_make_mesh(4), backend="auto",
                                               plan="fused-pallas")(jnp.asarray(img))
    else:
        want = JaxPipeline.parse(spec).jit("auto", plan="fused-pallas")(jnp.asarray(img))
    want = np.asarray(want)
    stages1, falls1 = _jax_counts()
    jax_fallbacks = {r: falls1[r] - falls0[r] for r in _JAX_REASONS if falls1[r] > falls0[r]}
    plan_metrics.reset()
    pipe = Pipeline.parse(spec)
    if sharded:
        mesh = pmesh.make_mesh(4, devices=["cpu"] * 4)
        got = pipe.sharded(mesh, backend="cuda", plan="fused-pallas")(img)
    else:
        got = pipe.jit("cuda", device="cpu", plan="fused-pallas")(img)
    np.testing.assert_array_equal(got.numpy(), want)
    assert plan_metrics.pallas_stages == stages1 - stages0
    assert dict(plan_metrics.pallas_fallbacks) == jax_fallbacks
    halo0 = sharded and case == "twelve box:1"
    assert plan_metrics.pallas_stages == (0 if halo0 else 1) and not jax_fallbacks


@pytest.mark.parametrize("n", [9, 17, 40])
@pytest.mark.parametrize("tail", ["", ",gaussian:5"])
def test_long_pointwise_chain_sharded_matches_jax(n, tail):
    """``Pipeline.sharded`` over four CPU slots: K2g per shard (or K1 for
    the chain alone), both halo modes."""
    spec = _chain(n) + tail
    img = synthetic_image(48, 40, channels=3, seed=n + 1)
    want = _jax_pallas(spec, img)
    mesh = pmesh.make_mesh(4, devices=["cpu"] * 4)
    for halo_mode in ("serial", "overlap"):
        got = Pipeline.parse(spec).sharded(mesh, backend="cuda", plan="off",
                                           halo_mode=halo_mode)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=halo_mode)


@pytest.mark.parametrize("n", [9, 17, 40])
@pytest.mark.parametrize("tail", ["", ",gaussian:5", ",emboss:3"])
def test_long_pointwise_chain_on_t1_matches_jax(n, tail):
    """T1-pw and T1 on word planes against the JAX packed-word runner in
    interpret mode."""
    spec = _chain(n) + tail
    img = synthetic_image(40, 128, channels=1, seed=n + 2)
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    (jpw, jst), = jax_pallas.group_ops(jax_registry.make_pipeline_ops(spec))
    assert pk.packed_supported(pw, st, 128)
    want = jax_pk.run_group_packed_words(jpw, jst, [jax_pk.pack_words(jnp.asarray(img))], 40,
                                         128, interpret=True, block_h=16)
    got = pk.run_group_packed_words(pw, st, [pk.pack_words(torch.from_numpy(img))], 40, 128,
                                    block_h=16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("route", ["full", "sharded"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("spec", ["gaussian:3", "gaussian:5", "sobel", "sharpen", "emboss:3",
                                  "erode:3", "box:5"])
def test_mxu_route_hands_the_next_kernel_a_contiguous_image(monkeypatch, spec, channels, route):
    """Every image the whole-op route passes to the K1/K2 group runner
    (`pipeline_mxu`, and the sharded runner's tiles under 'mxu'), and its
    result, is contiguous, as the kernels require on the card (their plain
    versions on the CPU take any strides); bytes equal to JAX."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import mxu_kernels

    seen = []
    real = ck.pipeline_cuda

    def spy(ops, img, **kw):
        seen.append(img.is_contiguous())
        return real(ops, img, **kw)

    monkeypatch.setattr(ck, "pipeline_cuda", spy)
    full = f"{spec},invert"
    img = synthetic_image(40, 52, channels=channels, seed=61)
    if route == "full":
        got = mxu_kernels.pipeline_mxu(make_pipeline_ops(full), torch.from_numpy(img))
    else:
        got = Pipeline.parse(full).sharded(pmesh.make_mesh(2, devices=["cpu"] * 2),
                                           backend="mxu", plan="off")(img)
    want = np.asarray(JaxPipeline.parse(full)(jnp.asarray(img)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert seen == [True] * (1 if route == "full" else 2) and got.is_contiguous()
