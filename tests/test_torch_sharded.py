"""The port's row-sharded runner (`Pipeline.sharded`, `run --shards N`) on
the CPU, held byte for byte against the JAX package's sharded runner and
against the port's own unsharded golden path.

The JAX side runs as its own tests run it: `make_mesh(n)` over the fake CPU
devices of tests/conftest.py, Pallas kernels in interpret mode. The port's
mesh names the CPU once per slot, so both packages see the same
decomposition of the same seeded image. On CPU tiles the port's `cuda`
backend takes the kernels' plain versions through the same wrappers; which
wrapper ran, and how often strips were exchanged, is counted.

Every tolerance is 0: bytes must be equal.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import parse_shards as jax_parse_shards
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import REFERENCE_PIPELINE_SPEC
from mpi_cuda_imagemanipulation_tpu_torch.parallel import api, halo, mesh as pmesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import plan_metrics

HALO_MODES = ("serial", "overlap")
# (backend, plan) pairs the port runs sharded; the other pairs are refused
PORT_LANES = [
    ("torch", "off"), ("torch", "fused"), ("torch", "fused-pallas"), ("torch", "auto"),
    ("cuda", "off"), ("cuda", "fused-pallas"), ("cuda", "auto"), ("auto", "auto"),
]
MIXED = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"


def cpu_mesh(n):
    return pmesh.make_mesh(n, devices=["cpu"] * n)


@functools.cache
def _image(height, width, channels, seed):
    return synthetic_image(height, width, channels=channels, seed=seed)


@functools.cache
def _jax_sharded(spec, height, width, channels, seed, n, backend="xla", plan="auto",
                 halo_mode="serial"):
    """The JAX package's sharded output for this case (computed once)."""
    img = _image(height, width, channels, seed)
    fn = JaxPipeline.parse(spec).sharded(
        jax_make_mesh(n), backend=backend, plan=plan, halo_mode=halo_mode
    )
    return np.asarray(fn(jnp.asarray(img)))


def _check_all_lanes(spec, height, width, channels, seed, n, *, jax_kw=None,
                     lanes=PORT_LANES, halo_modes=HALO_MODES):
    """Every port lane and halo mode on this case equals the JAX sharded
    output and the port's unsharded golden."""
    img = _image(height, width, channels, seed)
    want = _jax_sharded(spec, height, width, channels, seed, n, **(jax_kw or {}))
    pipe = Pipeline.parse(spec)
    golden = pipe(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(golden, want, err_msg=f"{spec}: goldens differ")
    for backend, plan in lanes:
        for halo_mode in halo_modes:
            got = pipe.sharded(cpu_mesh(n), backend=backend, plan=plan, halo_mode=halo_mode)(img)
            assert got.dtype == torch.uint8 and got.device.type == "cpu"
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"{spec} n={n} {backend}/{plan}/{halo_mode}")


# --------------------------------------------------------------------------
# The slice as a whole against the JAX sharded runner
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_reference_pipeline_sharded_bitexact(n):
    _check_all_lanes(REFERENCE_PIPELINE_SPEC, 128, 96, 3, 20, n)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("height", [131, 101])
def test_uneven_height_not_truncated(n, height):
    # The reference silently drops rows % size rows (kernel.cu:117); the
    # runner pads and crops, so every row survives. Pad rows gate the fused
    # paths out per group: K3 over the materialised tile takes over.
    _check_all_lanes(REFERENCE_PIPELINE_SPEC, height, 64, 3, 21, n)


@pytest.mark.parametrize(
    "spec",
    ["gaussian:5", "gaussian:7", "sobel", "box:3", "sharpen", "prewitt", "scharr",
     "laplacian:8", "unsharp", "filter:1/2/1/2/4/2/1/2/1:0.0625"],
)
def test_reflect_stencils_sharded_bitexact(spec):
    _check_all_lanes(spec, 133, 80, 1, 22, 8)


@pytest.mark.parametrize("size", [3, 5])
def test_emboss_sharded_no_seams(size):
    # Seam detector: stencil output at shard boundaries must match golden
    # in every lane (an off-by-halo in a kernel's global row shows only in
    # interior-mode ops on middle shards).
    spec = f"emboss:{size}"
    img = _image(128, 64, 1, 23)
    want = _jax_sharded(spec, 128, 64, 1, 23, 8, backend="pallas")
    pipe = Pipeline.parse(spec)
    local_h = 128 // 8
    for backend, plan in PORT_LANES:
        for halo_mode in HALO_MODES:
            got = pipe.sharded(cpu_mesh(8), backend=backend, plan=plan,
                               halo_mode=halo_mode)(img).numpy()
            for b in range(1, 8):
                band = slice(b * local_h - size, b * local_h + size)
                np.testing.assert_array_equal(got[band], want[band])
            np.testing.assert_array_equal(got, want)


def test_long_mixed_pipeline_sharded():
    # multi-group: under overlap, group k+1's exchange prefetches from
    # group k's boundary outputs across the intervening pointwise chain
    _check_all_lanes("grayscale,gaussian:5,sobel,threshold:100,gray2rgb", 136, 72, 3, 24, 8)


@pytest.mark.parametrize(
    "spec",
    ["gaussian:5,gaussian:5",  # equal-halo prefetch
     "gaussian:7,emboss:3",  # shrinking halo across groups
     "emboss:3,gaussian:7",  # growing halo: prefetch needs interior rows
     "erode:5,dilate:3"],  # edge-mode morphology pair
)
def test_overlap_multi_group_bitexact(spec):
    _check_all_lanes(spec, 128, 80, 3, 35, 8, jax_kw={"halo_mode": "overlap"})


def test_pointwise_only_pipeline_sharded():
    halo.exchanges.reset()
    _check_all_lanes("grayscale,invert", 64, 48, 3, 25, 8)
    assert halo.exchanges.rounds == 0  # no stencil: nothing crosses a boundary


@pytest.mark.parametrize(
    "spec",
    ["gaussian:5", "sobel", "emboss:3", "emboss:5", "erode:5", "median:5",
     REFERENCE_PIPELINE_SPEC],
)
def test_sharded_fused_ghost_path_bitexact(spec):
    # heights divisible by 8 with no pad rows take the fused-ghost group
    # (K2g's plain version here; the ghost-mode Pallas group in JAX),
    # including ragged last blocks (136 / 8 = 17 rows per shard)
    channels = 3 if spec.startswith("grayscale") else 1
    _check_all_lanes(spec, 136, 96, channels, 31, 8, jax_kw={"backend": "pallas"})


def test_sharded_halo0_stencil():
    # halo-0 stencils (box:1) must not take the fused-ghost path: there are
    # no strips to exchange
    halo.exchanges.reset()
    _check_all_lanes("box:1", 128, 96, 1, 33, 8, jax_kw={"backend": "pallas"})
    assert halo.exchanges.rounds == 0


# the family list of the JAX package's multi-chip dry run
# (__graft_entry__.dryrun_multichip) less the global-statistics and
# geometric families, which the port's registry does not parse yet
FAMILIES = [
    ("reference", REFERENCE_PIPELINE_SPEC), ("separable-stencil", "gaussian:5"),
    ("gradient-magnitude", "sobel"), ("morphology", "erode:5"), ("rank-median", "median:5"),
    ("lut-pointwise", "grayscale,contrast:4.3,gamma:2.2"), ("emboss101", "emboss101:5"),
    ("unsharp", "unsharp"),
]


@pytest.mark.parametrize("family,spec", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_dryrun_families_on_uneven_heights(family, spec):
    """One op per family on 32 n + 5 rows, so the pad-and-crop path runs."""
    _check_all_lanes(spec, 32 * 4 + 5, 256, 3, 12, 4, halo_modes=("serial",))
    img = _image(32 * 8 + 5, 256, 3, 12)
    pipe = Pipeline.parse(spec)
    golden = pipe(torch.from_numpy(img))
    for backend in ("torch", "cuda"):
        assert torch.equal(pipe.sharded(cpu_mesh(8), backend=backend)(img), golden), family


# --------------------------------------------------------------------------
# Plans: temporal blocking over the wire
# --------------------------------------------------------------------------


def test_sharded_fused_matches_jax():
    img = _image(128, 96, 3, 6)
    want = _jax_sharded(MIXED, 128, 96, 3, 6, 4, plan="fused")
    for mode in ("off", "pointwise", "fused", "on"):
        got = Pipeline.parse(MIXED).sharded(cpu_mesh(4), backend="torch", plan=mode)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)


def test_sharded_fused_pallas_matches_jax():
    want = _jax_sharded(MIXED, 128, 96, 3, 14, 4, backend="auto", plan="fused-pallas")
    img = _image(128, 96, 3, 14)
    plan_metrics.reset()
    got = Pipeline.parse(MIXED).sharded(cpu_mesh(4), backend="cuda", plan="fused-pallas")(img)
    np.testing.assert_array_equal(got.numpy(), want)
    assert plan_metrics.pallas_stages == 1 and not plan_metrics.pallas_fallbacks


def test_sharded_overlap_with_explicit_plan_matches_jax():
    spec = "invert,gaussian:5,sharpen,quantize:6"
    want = _jax_sharded(spec, 160, 64, 3, 8, 4, plan="fused", halo_mode="overlap")
    img = _image(160, 64, 3, 8)
    pipe = Pipeline.parse(spec)
    for plan in ("fused", "auto"):  # auto under overlap keeps the per-group structure
        got = pipe.sharded(cpu_mesh(4), backend="torch", halo_mode="overlap", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=plan)
    got = pipe.sharded(cpu_mesh(4), backend="cuda", halo_mode="overlap", plan="fused-pallas")(img)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend,plan", [("torch", "fused"), ("cuda", "fused-pallas")])
def test_sharded_fallback_gates_stay_bit_exact(backend, plan):
    # pad rows inside the tile (130 % 4 != 0): the fused stage falls back to
    # the per-op (torch) or per-group (cuda) path inside the same region
    jax_kw = {"plan": plan, "backend": "xla" if backend == "torch" else "auto"}
    want = _jax_sharded(MIXED, 130, 48, 3, 9, 4, **jax_kw)
    plan_metrics.reset()
    got = Pipeline.parse(MIXED).sharded(cpu_mesh(4), backend=backend, plan=plan)(
        _image(130, 48, 3, 9))
    np.testing.assert_array_equal(got.numpy(), want)
    if backend == "cuda":
        assert dict(plan_metrics.pallas_fallbacks) == {"image-too-small": 1}
    # stage halo outgrows the tile (2 stencils x halo 2 = 4 > 24 / 8 = 3
    # rows per shard): per-op execution still fits and must take over
    spec = "gaussian:5,gaussian:5"
    want = _jax_sharded(spec, 24, 40, 3, 10, 8, **jax_kw)
    got = Pipeline.parse(spec).sharded(cpu_mesh(8), backend=backend, plan=plan)(
        _image(24, 40, 3, 10))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rejected_stage_runs_per_group_and_is_counted():
    """A stage K4g rejects (a lookup table inside) runs through the
    per-group path and is counted by reason."""
    spec = "grayscale,gamma:2.2,gaussian:5,sharpen"
    img = _image(128, 64, 3, 11)
    plan_metrics.reset()
    got = Pipeline.parse(spec).sharded(cpu_mesh(4), backend="cuda", plan="fused-pallas")(img)
    assert torch.equal(got, Pipeline.parse(spec)(torch.from_numpy(img)))
    assert dict(plan_metrics.pallas_fallbacks) == {"lut-op": 1}
    assert plan_metrics.pallas_stages == 0


def test_two_stage_plan_sharded_fused_pallas_matches_jax():
    """Two fused stages in one region, the second on the gray the first
    left: both run as K4g, with the JAX runner's bytes and stage count. The
    port asks K4g's eligibility with each stage's own input channels, the
    JAX runner with the image's; here both admit both stages."""
    from mpi_cuda_imagemanipulation_tpu.ops.registry import make_pipeline_ops as jax_ops
    from mpi_cuda_imagemanipulation_tpu.parallel import api as jax_api
    from mpi_cuda_imagemanipulation_tpu.plan import ir as jax_ir
    from mpi_cuda_imagemanipulation_tpu.plan.metrics import plan_metrics as jax_metrics
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.plan import ir

    first, second = "grayscale,contrast:3.5,gaussian:5", "emboss:3,quantize:6"
    img = _image(128, 96, 3, 17)

    def two_stages(mod, parse):
        return mod.Plan(
            stages=tuple(mod.Stage("fused", tuple(parse(spec)), halo)
                         for spec, halo in ((first, 2), (second, 1))),
            mode="fused-pallas",
        )

    before = jax_metrics.pallas_stages.value()
    want = np.asarray(jax_api._run_segment_planned(
        two_stages(jax_ir, jax_ops), jax_make_mesh(4), "auto", jnp.asarray(img), "serial",
        mega=True))
    jax_stages = int(jax_metrics.pallas_stages.value() - before)
    plan_metrics.reset()
    halo.exchanges.reset()
    got = api._run_segment_planned(
        two_stages(ir, make_pipeline_ops), cpu_mesh(4), "cuda", torch.from_numpy(img),
        "serial", True)
    np.testing.assert_array_equal(got.numpy(), want)
    golden = Pipeline.parse(f"{first},{second}")(torch.from_numpy(img))
    assert torch.equal(got, golden)
    assert plan_metrics.pallas_stages == jax_stages == 2
    assert not plan_metrics.pallas_fallbacks and halo.exchanges.rounds == 2


# --------------------------------------------------------------------------
# Structure: exchanges and kernel wrappers per call
# --------------------------------------------------------------------------


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls of each kernel wrapper (on CPU tiles a wrapper runs
    its plain version and its `launches` stays 0)."""
    calls = {}
    for key, fn in ck.KERNEL_WRAPPERS.items():
        calls[key] = 0

        def spy(*args, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ck, fn.__name__, spy)
    return calls


# (chain, halo-carrying fused stages, stencil count), as the JAX package's
# collective-permute counts in tests/test_plan.py, without the geometric op
EXCHANGE_CASES = [
    (MIXED, 1, 2), ("gaussian:3,sharpen,grayscale,sobel", 1, 3),
    ("invert,gaussian:3,gamma:2,sharpen,sobel,quantize:6", 1, 3), ("grayscale,invert", 0, 0),
]


@pytest.mark.parametrize("chain,n_stages,n_stencils", EXCHANGE_CASES)
def test_one_exchange_per_group_or_fused_stage(chain, n_stages, n_stencils):
    img = _image(128, 96, 3, 7)
    pipe = Pipeline.parse(chain)
    for backend, plan, want in (("torch", "off", n_stencils), ("cuda", "off", n_stencils),
                                ("torch", "fused", n_stages), ("cuda", "fused-pallas", None)):
        halo.exchanges.reset()
        plan_metrics.reset()
        pipe.sharded(cpu_mesh(4), backend=backend, plan=plan)(img)
        if want is None:  # one per K4g stage, one per stencil group of a rejected stage
            want = n_stages if plan_metrics.pallas_stages else n_stencils
        assert halo.exchanges.rounds == want, (chain, backend, plan)
    halo.exchanges.reset()
    pipe.sharded(cpu_mesh(1), backend="cuda")(img)
    assert halo.exchanges.rounds == 0  # one slot: nothing to exchange


def test_kernel_wrappers_per_call(wrapper_calls):
    img = _image(128, 96, 3, 16)
    none = dict.fromkeys(ck.KERNEL_WRAPPERS, 0)

    def run(spec, image=img, n=4, **kw):
        for k in wrapper_calls:
            wrapper_calls[k] = 0
        Pipeline.parse(spec).sharded(cpu_mesh(n), **kw)(image)
        return dict(wrapper_calls)

    # the reference pipeline: one K2g group per shard; one K4g stage per shard
    assert run(REFERENCE_PIPELINE_SPEC, backend="cuda") == {**none, "K2g": 4}
    assert run(REFERENCE_PIPELINE_SPEC, backend="cuda", plan="fused-pallas") == {**none, "K4g": 4}
    # two groups, then a flushed trailing pointwise run
    assert run(MIXED, backend="cuda") == {**none, "K2g": 8, "K1": 4}
    assert run(MIXED, backend="cuda", plan="fused-pallas") == {**none, "K4g": 4}
    # pad rows in the tile: flushed prologue (K1), then K3 on the extended tile
    padded = _image(131, 96, 3, 16)
    assert run(REFERENCE_PIPELINE_SPEC, image=padded, backend="cuda") == {**none, "K1": 4, "K3": 4}
    assert run(REFERENCE_PIPELINE_SPEC, image=padded, backend="cuda", plan="fused-pallas") == {
        **none, "K1": 4, "K3": 4}
    # overlap: interior and two bands per shard, each K3
    assert run("gaussian:5", backend="cuda", halo_mode="overlap") == {**none, "K3": 12}
    # the torch backend never reaches a kernel wrapper
    for plan in ("off", "fused", "fused-pallas"):
        assert run(MIXED, backend="torch", plan=plan) == none
    assert ck.launch_counts() == dict.fromkeys(ck.launch_counts(), 0)  # nothing on the CPU


# --------------------------------------------------------------------------
# Mesh, validation, CLI
# --------------------------------------------------------------------------


def test_mesh_construction():
    m = cpu_mesh(4)
    assert m.shape == {pmesh.ROWS: 4} and m.axis_names == ("rows",)
    assert m.local_slots == (0, 1, 2, 3) and not m.distributed
    assert all(d.type == "cpu" for d in m.devices)
    assert pmesh.make_mesh(devices=["cpu", "cpu"]).shape == {"rows": 2}
    with pytest.raises(ValueError, match="requested 3 shards but only 2 devices are visible"):
        pmesh.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="requested 9 shards but only 8 devices are visible"):
        jax_make_mesh(9)  # the JAX message the port repeats
    if not torch.cuda.is_available():  # the default is every visible card
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.mesh_from_shards("4")
    assert pmesh.mesh_from_shards("1", "cpu") is None
    assert pmesh.mesh_from_shards("4", "cpu").shape == {"rows": 4}
    m2 = pmesh.mesh_from_shards("2x4", "cpu")  # the 2-D mesh of parallel/api2d
    assert m2.axis_names == ("rows", "cols") and m2.shape == {"rows": 2, "cols": 4}
    assert m2.local_slots == tuple(range(8)) and all(d.type == "cpu" for d in m2.devices)


@pytest.mark.parametrize("spec", [4, "4", " 8 ", "2x4", "1X8", "0", "x", "2x", "-1", "2x0", "a"])
def test_parse_shards_matches_jax(spec):
    try:
        want = jax_parse_shards(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.parse_shards(spec)
        assert str(got.value) == str(e)
    else:
        assert pmesh.parse_shards(spec) == want


def test_distributed_init_reads_the_torchrun_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    pmesh.distributed_init("cpu")  # single process: no-op
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="missing: MASTER_PORT, WORLD_SIZE"):
        pmesh.distributed_init("cpu")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "1")
    pmesh.distributed_init("cpu")  # a world of one: still no group
    assert not torch.distributed.is_initialized()


def test_too_many_shards_raises_like_jax():
    img = _image(16, 32, 1, 26)
    with pytest.raises(ValueError, match="use fewer shards") as want:
        JaxPipeline.parse("gaussian:7").sharded(jax_make_mesh(8))(jnp.asarray(img))
    for backend in ("torch", "cuda"):
        with pytest.raises(ValueError, match="use fewer shards") as got:
            Pipeline.parse("gaussian:7").sharded(cpu_mesh(8), backend=backend)(img)
        assert str(got.value) == str(want.value)


def test_sharded_validation():
    pipe = Pipeline.parse("gaussian:5")
    with pytest.raises(ValueError, match="halo_mode"):
        pipe.sharded(cpu_mesh(2), halo_mode="pipelined")
    with pytest.raises(ValueError, match="unknown backend"):
        pipe.sharded(cpu_mesh(2), backend="xla")
    img = synthetic_image(16, 24, channels=1, seed=3)  # K5 to K8 are ported: mxu and swar run
    assert torch.equal(pipe.sharded(cpu_mesh(2), backend="swar")(img), pipe(torch.from_numpy(img)))
    assert torch.equal(pipe.sharded(cpu_mesh(2), backend="mxu")(img), pipe(torch.from_numpy(img)))
    with pytest.raises(ValueError, match="stage-walker mode"):
        pipe.sharded(cpu_mesh(2), backend="cuda", plan="fused")
    assert torch.equal(pipe.sharded(cpu_mesh(2), backend="cuda", plan="fused-pallas-mxu")(img),
                       pipe(torch.from_numpy(img)))
    with pytest.raises(TypeError, match="uint8"):
        pipe.sharded(cpu_mesh(2), backend="torch")(np.zeros((8, 8), np.float32))
    assert api.HALO_MODES == ("serial", "overlap")


def test_split_segments_keeps_the_segment_structure():
    pipe = Pipeline.parse("invert,rot180,gaussian:5")
    segs = api._split_segments(pipe.ops)
    assert [k for k, _ in segs] == ["sharded", "whole", "sharded"]
    img = _image(40, 24, 3, 5)
    golden = pipe(torch.from_numpy(img))
    for plan in ("off", "fused-pallas"):
        got = api.sharded_pipeline(pipe, cpu_mesh(2), plan=plan)(img)
        assert torch.equal(got, golden), plan


def test_cli_run_shards(tmp_path, capsys):
    src = tmp_path / "in.png"
    save_image(src, _image(101, 64, 3, 40))
    plain = tmp_path / "plain.png"
    assert cli.main(["run", "--input", str(src), "--output", str(plain), "--device", "cpu"]) == 0
    metrics = tmp_path / "m.jsonl"
    for mode in HALO_MODES:
        for plan in ("off", "fused-pallas"):
            out = tmp_path / f"{mode}-{plan}.png"
            rc = cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                           "--shards", "4", "--halo-mode", mode, "--plan", plan, "--block", "8",
                           "--json-metrics", str(metrics)])
            assert rc == 0
            np.testing.assert_array_equal(load_image(out), load_image(plain))
    assert "--block applies to single-device runs" in capsys.readouterr().err
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["halo_mode"] for r in recs] == ["serial", "serial", "overlap", "overlap"]
    assert all(r["shards"] == "4" and r["halo_exchanges"] == 1 for r in recs)
    # --shards RxC tile-shards (parallel/api2d) with the torch ops, and
    # refuses the kernel backends
    assert cli.main(["run", "--input", str(src), "--output", str(tmp_path / "x.png"),
                     "--device", "cpu", "--shards", "2x2"]) == 0
    np.testing.assert_array_equal(load_image(tmp_path / "x.png"), load_image(plain))
    assert cli.main(["run", "--input", str(src), "--output", str(tmp_path / "x.png"),
                     "--device", "cpu", "--shards", "2x2", "--impl", "cuda"]) == 2
    assert "2-D sharding" in capsys.readouterr().err
    if not torch.cuda.is_available():  # no card: an error, not a quiet CPU run
        assert cli.main(["run", "--input", str(src), "--output", str(tmp_path / "x.png"),
                         "--shards", "4"]) == 2
        assert "is_available" in capsys.readouterr().err


def test_cli_info_reports_devices_and_process_groups(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"cuda devices: {torch.cuda.device_count()}" in out
    assert "torch.distributed: nccl" in out and "gloo True" in out
