"""Three repairs to the PyTorch/CUDA port, each held against the JAX package:

* ``backend='auto'`` in ``Pipeline.jit`` and ``run --impl`` (the default),
  running what ``'cuda'`` runs, as ``Pipeline.sharded`` already did;
* the golden reflect-101 padding on images no wider or taller than the
  halo (``spec.pad2d``), which reflects repeatedly as ``jnp.pad`` does;
* SWAR chains of any length (``swar_desc``'s table): a plain registry
  pipeline with 17 or 40 fusable steps before a stencil runs fused on K6,
  routed as the JAX SWAR path routes it.

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
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import BACKENDS, Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import pad2d, reflect101_index

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
