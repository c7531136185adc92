"""The port's failpoints (resilience/failpoints.py) against the JAX
package's, and the three sites the port calls.

The spec grammar, its validation and the once/first/after/always modes
are the JAX package's test_resilience cases run against the port; for the
same spec and seed both packages give the same fail/pass sequence. The
sites: ``io.decode`` fails `load_image`, ``plan.fuse`` fails every fusing
build and never an 'off' one, ``halo.exchange`` fails `Pipeline.sharded`
on CPU slots, as it fails the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu.resilience import failpoints as jax_fp
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
from mpi_cuda_imagemanipulation_tpu_torch.resilience import FailpointError, failpoints

FUSING = ("pointwise", "fused", "fused-pallas", "fused-pallas-mxu")


@pytest.fixture(autouse=True)
def _disarmed():
    failpoints.clear()
    jax_fp.clear()
    yield
    failpoints.clear()
    jax_fp.clear()


def test_known_sites_are_the_jax_package_s():
    assert failpoints.KNOWN_SITES == jax_fp.KNOWN_SITES
    assert (failpoints.ENV_SPEC, failpoints.ENV_SEED) == (jax_fp.ENV_SPEC, jax_fp.ENV_SEED)


@pytest.mark.parametrize("spec", ["nope.site=0.5", "io.decode=wat", "io.decode=1.5",
                                  "io.decode", "io.decode=-0.1", "io.decode=sleep:-1"])
def test_spec_validation(spec):
    for mod in (failpoints, jax_fp):
        with pytest.raises(ValueError):
            mod.configure(spec)
        assert not mod.is_active()


def test_modes_once_first_after_always():
    failpoints.configure("io.decode=once")
    with pytest.raises(FailpointError):
        failpoints.maybe_fail("io.decode")
    failpoints.maybe_fail("io.decode")  # the second call passes

    failpoints.configure("io.decode=first:2")
    for _ in range(2):
        with pytest.raises(FailpointError):
            failpoints.maybe_fail("io.decode")
    failpoints.maybe_fail("io.decode")

    failpoints.configure("plan.fuse=after:2")
    failpoints.maybe_fail("plan.fuse")
    failpoints.maybe_fail("plan.fuse")
    with pytest.raises(FailpointError, match="call #3"):
        failpoints.maybe_fail("plan.fuse")

    failpoints.configure("halo.exchange=always")
    with pytest.raises(FailpointError) as e:
        failpoints.maybe_fail("halo.exchange")
    assert e.value.site == "halo.exchange" and e.value.n_call == 1
    failpoints.maybe_fail("io.decode")  # a site not armed passes
    assert failpoints.counts() == {"halo.exchange": {"calls": 1, "fired": 1}}

    failpoints.clear()
    failpoints.maybe_fail("halo.exchange")  # disarmed: no-op
    assert not failpoints.is_active()


def test_sleep_mode_delays_and_never_raises():
    failpoints.configure("io.decode=sleep:1")
    for _ in range(3):
        failpoints.maybe_fail("io.decode")
    assert failpoints.counts()["io.decode"] == {"calls": 3, "fired": 0}


def test_install_decides_on_the_call_s_context():
    failpoints.install("io.decode", lambda ctx: ctx.get("path") == "bad.png")
    failpoints.maybe_fail("io.decode", path="good.png")
    with pytest.raises(FailpointError):
        failpoints.maybe_fail("io.decode", path="bad.png")
    typo = "io.typo"  # not a literal argument: the repo's analyzer refuses unknown sites
    with pytest.raises(ValueError, match="unknown failpoint site"):
        failpoints.install(typo, lambda ctx: True)


def test_configure_from_env_arms_and_keeps_an_armed_configuration():
    failpoints.configure_from_env({"MCIM_FAILPOINTS": "io.decode=always",
                                   "MCIM_FAILPOINT_SEED": "5"})
    with pytest.raises(FailpointError):
        failpoints.maybe_fail("io.decode")
    failpoints.configure_from_env({})  # unset: the armed sites stay
    assert failpoints.is_active()


def _sequence(mod, spec, seed, site, n=40):
    mod.configure(spec, seed=seed)
    out = []
    for _ in range(n):
        try:
            mod.maybe_fail(site)
            out.append(0)
        except mod.FailpointError:
            out.append(1)
    mod.clear()
    return out


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), p=st.sampled_from(["0.1", "0.5", "0.9", "1", "0"]),
       site=st.sampled_from(["io.decode", "plan.fuse", "halo.exchange"]))
def test_sequence_equals_the_jax_package_s(seed, p, site):
    spec = f"{site}={p}"
    got = _sequence(failpoints, spec, seed, site)
    assert got == _sequence(jax_fp, spec, seed, site)
    assert got == _sequence(failpoints, spec, seed, site)  # deterministic


@pytest.mark.parametrize("mode", ["once", "first:3", "after:4", "always"])
def test_counted_modes_equal_the_jax_package_s(mode):
    assert (_sequence(failpoints, f"io.decode={mode}", 0, "io.decode", 10)
            == _sequence(jax_fp, f"io.decode={mode}", 0, "io.decode", 10))


def test_io_decode_fails_load_image(tmp_path):
    path = tmp_path / "in.png"
    save_image(path, synthetic_image(8, 8, seed=1))
    failpoints.configure("io.decode=once")
    with pytest.raises(FailpointError):
        load_image(path)
    assert load_image(path).shape == (8, 8, 3)
    failpoints.configure("io.decode=always")
    with pytest.raises(FailpointError):
        load_image(tmp_path / "missing.png")  # before the file is opened


@pytest.mark.parametrize("mode", FUSING)
def test_plan_fuse_fails_fusing_builds(mode):
    ops = make_pipeline_ops("grayscale,contrast:3.5,gaussian:5,sharpen")
    failpoints.configure("plan.fuse=always")
    with pytest.raises(FailpointError):
        build_plan(ops, mode)
    backend = "torch" if mode in ("pointwise", "fused") else "cuda"
    fn = Pipeline(ops).jit(backend, device="cpu", plan=mode)  # builds at its first call
    with pytest.raises(FailpointError):
        fn(synthetic_image(16, 24, seed=2))


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
def test_plan_fuse_never_fails_an_off_build(backend):
    ops = make_pipeline_ops("grayscale,contrast:3.5,gaussian:5,sharpen")
    failpoints.configure("plan.fuse=always")
    assert build_plan(ops, "off").mode == "off"
    img = synthetic_image(16, 24, seed=2)
    out = Pipeline(ops).jit(backend, device="cpu", plan="off")(img)
    np.testing.assert_array_equal(out.numpy(), Pipeline(ops)(torch.from_numpy(img)).numpy())
    assert failpoints.counts()["plan.fuse"]["calls"] == 0


@pytest.mark.parametrize("backend", ["cuda", "auto", "torch"])
def test_halo_exchange_fails_sharded_as_in_jax(backend):
    img = synthetic_image(64, 48, channels=1, seed=0)
    failpoints.configure("halo.exchange=always")
    jax_fp.configure("halo.exchange=always")
    fn = Pipeline.parse("gaussian:3").sharded(make_mesh(4, devices=["cpu"] * 4), backend=backend)
    with pytest.raises(FailpointError):
        fn(img)
    jax_fn = JaxPipeline.parse("gaussian:3").sharded(jax_make_mesh(4))
    with pytest.raises(jax_fp.FailpointError):
        jax_fn(jnp.asarray(img))
    failpoints.configure("halo.exchange=once")
    with pytest.raises(FailpointError):
        fn(img)
    np.testing.assert_array_equal(  # the next call passes
        fn(img).numpy(), Pipeline.parse("gaussian:3")(torch.from_numpy(img)).numpy()
    )


def test_cli_run_arms_failpoints(tmp_path, capsys):
    src = tmp_path / "in.png"
    save_image(src, synthetic_image(12, 16, seed=3))
    out = tmp_path / "out.png"
    base = ["run", "--input", str(src), "--output", str(out), "--device", "cpu"]
    assert cli.main(base + ["--failpoints", "io.decode=always"]) == 2
    assert "injected failpoint 'io.decode'" in capsys.readouterr().err
    assert not out.exists()
    assert cli.main(base + ["--failpoints", "plan.fuse=always", "--plan", "fused-pallas"]) == 2
    assert cli.main(base + ["--failpoints", "io.typo=always"]) == 2
    assert "unknown failpoint site" in capsys.readouterr().err
    failpoints.clear()
    assert cli.main(base + ["--failpoints", "io.decode=0", "--failpoint-seed", "9"]) == 0
    assert out.exists()
