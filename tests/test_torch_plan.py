"""The port's fusion planner and the `run --plan fused-pallas` slice on the
CPU, held byte for byte against the JAX package.

* planner: the same stage partition, halos and fingerprints as the JAX
  package's `build_plan` for every build mode, the backend mapping of
  `resolve_plan_mode`, and the same reject reasons as
  `stage_pallas_reject`;
* walker: `plan_callable` against the JAX `plan_callable`;
* K4's plain version: `plan_callable_cuda` on CPU tensors (which runs
  `fused_stage_plain` per stage) against the JAX megakernel
  `plan_callable_pallas` in interpret mode;
* K4's host side: program encoding and its limits, shared memory, the
  edge-source index function against `pad2d`, and a tile-by-tile
  emulation of the kernel's window algorithm against its plain version;
* the slice as a whole: the port's CLI against the JAX CLI.

Every tolerance is 0: bytes must be equal.
"""

import ctypes
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stencil_emulator import emulate_stage as _emulate_k4

from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.plan import build_plan as jax_build_plan
from mpi_cuda_imagemanipulation_tpu.plan import pipeline_fingerprint as jax_fingerprint
from mpi_cuda_imagemanipulation_tpu.plan import resolve_plan_mode as jax_resolve
from mpi_cuda_imagemanipulation_tpu.plan import exec as jax_exec
from mpi_cuda_imagemanipulation_tpu.plan.ir import Stage as JaxStage
from mpi_cuda_imagemanipulation_tpu.plan.metrics import PlanMetrics as JaxPlanMetrics
from mpi_cuda_imagemanipulation_tpu.plan.pallas_exec import (
    plan_callable_pallas,
    stage_pallas_reject,
)
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
    REGISTRY,
    make_op,
    make_pipeline_ops,
    op_family,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    StencilOp,
    chain_halo,
    pad2d,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan import (
    PlanMetrics,
    Stage,
    build_plan,
    pipeline_fingerprint,
    plan_metrics,
    resolve_plan_mode,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan import exec as port_exec
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import (
    REJECT_REASONS,
    plan_callable_cuda,
    stage_kernel_reject,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import BUILD_MODES
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEGAKERNEL = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"  # megakernel_ab
PLAN_AB = "grayscale,contrast:3.5,gaussian:5,quantize:6"
REFERENCE = "grayscale,contrast:3.5,emboss:3"
# the JAX planner tests' random-chain pool (tests/test_plan.py)
_POOL = (
    "invert", "brightness:30", "contrast:2.0", "quantize:5", "solarize:99",
    "gaussian:3", "gaussian:5", "box:3", "sharpen", "sobel", "prewitt",
    "laplacian", "emboss:3", "median:3", "erode", "dilate",
)


def _pool_chain(seed: int) -> str:
    rng = np.random.default_rng(seed)
    return ",".join(str(rng.choice(_POOL)) for _ in range(int(rng.integers(2, 7))))


CHAINS = [_pool_chain(s) for s in range(12)] + [
    MEGAKERNEL, PLAN_AB, REFERENCE, "gamma:1.8,gaussian:3,invert,sobel,gray2rgb",
]


def _img(h, w, c, seed=0):
    return synthetic_image(h, w, channels=c, seed=seed)


def _jax(img):
    return jnp.asarray(img)


@pytest.fixture
def no_calibration(monkeypatch):
    """The JAX package's 'auto' as it resolves with nothing recorded."""
    monkeypatch.setenv("MCIM_NO_CALIB", "1")
    monkeypatch.delenv("MCIM_PLAN", raising=False)


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------


def test_op_families_match_jax():
    assert jax_registry.FAMILIES == ("pointwise", "stencil", "geometric", "global-stat")
    for name in REGISTRY:
        arg = jax_registry._FAMILY_PROBE_ARGS.get(name)  # the JAX table's own probes
        spec_str = f"{name}:{arg}" if arg else name
        op = make_op(spec_str)
        jax_op = jax_registry.make_op(spec_str)
        assert op_family(op) == jax_registry.op_family(jax_op), name
        assert (op.name, op.halo) == (jax_op.name, jax_op.halo), name
    with pytest.raises(TypeError, match="no known family"):
        op_family(object())


@pytest.mark.parametrize("spec_str", CHAINS)
def test_build_plan_matches_jax(spec_str):
    ops = make_pipeline_ops(spec_str)
    jax_ops = jax_registry.make_pipeline_ops(spec_str)
    assert pipeline_fingerprint(ops) == jax_fingerprint(jax_ops)
    assert chain_halo(ops) == sum(op.halo for op in jax_ops)
    for mode in BUILD_MODES:
        plan, want = build_plan(ops, mode), jax_build_plan(jax_ops, mode)
        assert [(s.kind, s.names, s.halo) for s in plan.stages] == [
            (s.kind, s.names, s.halo) for s in want.stages
        ], mode
        assert plan.fingerprint == want.fingerprint, mode
        assert plan.total_halo == chain_halo(ops)
        assert (plan.hbm_passes, plan.n_absorbed_ops) == (want.hbm_passes, want.n_absorbed_ops)


def test_plan_metrics_keys_and_counts_match_jax():
    ours, theirs = PlanMetrics(), JaxPlanMetrics()
    for mode in BUILD_MODES:
        ours.on_build(build_plan(make_pipeline_ops(MEGAKERNEL), mode))
        theirs.on_build(jax_build_plan(jax_registry.make_pipeline_ops(MEGAKERNEL), mode))
    assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    assert set(ours.snapshot().values()) == {0}


def test_resolve_plan_mode_backend_mapping(no_calibration):
    ops = make_pipeline_ops(MEGAKERNEL)
    jax_ops = jax_registry.make_pipeline_ops(MEGAKERNEL)
    # torch plays the JAX package's xla, cuda its auto
    assert resolve_plan_mode(ops, "auto", backend="torch") == "fused"
    assert jax_resolve(jax_ops, "auto", backend="xla") == "fused"
    assert resolve_plan_mode(ops, "auto", backend="cuda") == "off"
    assert jax_resolve(jax_ops, "auto", backend="auto") == "off"
    for mode in ("off", "pointwise", "fused", "fused-pallas"):
        assert resolve_plan_mode(ops, mode, backend="torch") == mode
        assert jax_resolve(jax_ops, mode, backend="xla") == mode
    assert resolve_plan_mode(ops, "on", backend="torch") == "fused"
    assert resolve_plan_mode(ops, "off", backend="cuda") == "off"
    assert resolve_plan_mode(ops, "fused-pallas", backend="cuda") == "fused-pallas"
    for mode in ("pointwise", "fused"):
        with pytest.raises(ValueError, match="stage-walker mode"):
            resolve_plan_mode(ops, mode, backend="cuda")
    for backend in ("torch", "cuda", "mxu"):  # K5 is ported: every backend resolves it
        assert resolve_plan_mode(ops, "fused-pallas-mxu", backend=backend) == "fused-pallas-mxu"
    assert jax_resolve(jax_ops, "fused-pallas-mxu", backend="xla") == "fused-pallas-mxu"
    assert build_plan(ops, "fused-pallas-mxu").fingerprint == jax_build_plan(
        jax_ops, "fused-pallas-mxu").fingerprint
    with pytest.raises(ValueError, match="unknown plan mode"):
        resolve_plan_mode(ops, "fastest", backend="torch")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_plan_mode(ops, "auto", backend="xla")


REJECT_CASES = [
    # (spec, height, width, channels)
    (MEGAKERNEL, 40, 60, 3),
    (REFERENCE, 3, 60, 3),  # height 2H + 1
    (REFERENCE, 2, 60, 3),  # height 2H: image-too-small
    ("gaussian:5,sharpen", 7, 3, 1),  # just above both gates
    ("gaussian:5,sharpen", 6, 30, 1),
    ("gaussian:5,sharpen", 30, 2, 1),  # width = largest op halo
    ("gamma:2.2,sobel", 30, 30, 1),  # lut-op
    (",".join(["gaussian:7"] * 6), 64, 64, 1),  # halo 18: halo-too-large
    (",".join(["gaussian:7"] * 5), 31, 4, 3),  # halo 15, just above the gates
    ("invert,gray2rgb", 1, 1, 1),  # halo 0: no size gate
]


@pytest.mark.parametrize("spec_str,height,width,channels", REJECT_CASES)
def test_stage_kernel_reject_matches_jax(spec_str, height, width, channels):
    ops = make_pipeline_ops(spec_str)
    jax_ops = jax_registry.make_pipeline_ops(spec_str)
    ours = stage_kernel_reject(Stage("fused", ops, chain_halo(ops)), height, width, channels)
    want = stage_pallas_reject(
        JaxStage("fused", jax_ops, sum(op.halo for op in jax_ops)), height, width, channels
    )
    assert want != "vmem-budget"  # the budget reasons differ by design
    assert ours == want


def test_stage_kernel_reject_reasons_of_its_own():
    # a stage of any length runs, as on the JAX megakernel: nine stencils
    # at halo 0 (the first K4 held at most eight)
    box1 = make_pipeline_ops(",".join(["box:1"] * 9))
    assert stage_kernel_reject(Stage("fused", box1, 0), 20, 20, 1) is None
    assert stage_kernel_reject(Stage("geometric", box1[:1], 0), 20, 20, 1) == "barrier"
    ops = make_pipeline_ops("gaussian:5")
    stage = Stage("fused", ops, 2)
    assert stage_kernel_reject(stage, 4000, 400, 3, tile_h=900) == "smem-budget"
    assert stage_kernel_reject(stage, 4000, 400, 3, tile_h=64) is None
    assert set(REJECT_REASONS) == {"barrier", "lut-op", "no-f32-core", "halo-too-large",
                                   "image-too-small", "smem-budget"}
    with pytest.raises(ValueError, match="smem-budget"):
        ck.fused_stage(ops, torch.zeros((4000, 400, 3), dtype=torch.uint8), tile_h=900)


# --------------------------------------------------------------------------
# The stage walker
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "spec_str,channels",
    [(MEGAKERNEL, 3), ("median:3,gray2rgb,sepia,gaussian:3", 1),
     ("grayscale,gaussian:3,gamma:1.8,sharpen,erode", 3), ("emboss:5,box:3,dilate:3", 3)],
)
def test_plan_callable_matches_jax(spec_str, channels):
    img = _img(33, 47, channels, seed=31)
    ops = make_pipeline_ops(spec_str)
    jax_ops = jax_registry.make_pipeline_ops(spec_str)
    for mode in ("pointwise", "fused"):
        got = port_exec.plan_callable(build_plan(ops, mode))(torch.from_numpy(img))
        want = jax_exec.plan_callable(jax_build_plan(jax_ops, mode))(_jax(img))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_walk_stage_threads_context_like_jax():
    """A tile with real context rows on both sides, as a tiled caller
    would pass it: the same region, rows and budgets as the JAX walker."""
    spec_str = "gaussian:5,invert,sharpen,emboss:3"
    ops = make_pipeline_ops(spec_str)
    jax_ops = jax_registry.make_pipeline_ops(spec_str)
    img = _img(40, 30, 1, seed=32).astype(np.float32)
    region = img[6:34]  # rows 6..33 with 5 rows of context at the top, 3 below
    got = port_exec.walk_stage(ops, torch.from_numpy(region), y_lo=6, lead_rem=5,
                               tail_rem=3, global_h=40, global_w=30)
    want = jax_exec.walk_stage(
        jax_ops, _jax(region), y_lo=6, lead_rem=5, tail_rem=3, global_h=40, global_w=30,
        acc_fns=jax_exec.acc_fns_for(jax_ops, "xla", 30),
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == tuple(int(v) for v in want[1:])


# --------------------------------------------------------------------------
# K4's plain version against the JAX megakernel (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "spec_str,shape",
    [(MEGAKERNEL, (29, 64, 3)), (REFERENCE, (3, 40, 3)),
     ("gaussian:5,sharpen,gamma:1.5,emboss:3", (7, 33, 1)),
     ("sepia,gaussian:3,grayscale,sobel,gray2rgb", (24, 20, 3))],
)
def test_plan_callable_cuda_matches_jax_megakernel(spec_str, shape):
    img = _img(*shape, seed=33)
    plan_metrics.reset()
    got = plan_callable_cuda(build_plan(make_pipeline_ops(spec_str), "fused-pallas"))(
        torch.from_numpy(img)
    )
    want = plan_callable_pallas(
        jax_build_plan(jax_registry.make_pipeline_ops(spec_str), "fused-pallas"),
        interpret=True,
    )(_jax(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert plan_metrics.pallas_stages + sum(plan_metrics.pallas_fallbacks.values()) >= 1


def test_rejected_stage_runs_through_the_group_runner(monkeypatch):
    calls = []
    monkeypatch.setattr(ck, "pipeline_cuda", lambda ops, img, block_h=None, **kw: calls.append(
        [op.name for op in ops]) or img)
    plan_metrics.reset()
    img = torch.from_numpy(_img(30, 30, 1, seed=34))
    plan_callable_cuda(build_plan(make_pipeline_ops("gamma:2.2,sobel"), "fused-pallas"))(img)
    assert calls == [["gamma2.2", "sobel"]]
    assert dict(plan_metrics.pallas_fallbacks) == {"lut-op": 1}
    assert plan_metrics.pallas_stages == 0


# --------------------------------------------------------------------------
# K4's host side
# --------------------------------------------------------------------------


def test_fused_stage_program_encoding():
    ops = make_pipeline_ops(MEGAKERNEL)
    prog = ck.stage_program(ops, 3)
    assert (prog.c_out, prog.c_smem, prog.two_pass, prog.halo) == (1, 1, True, 3)
    assert prog.n_ops == 5 and prog.n_stencils == 2 and (prog.kmax, prog.mma) == (5, False)
    # one 16-byte op row per op, then one 448-byte row per stencil
    assert prog.table.dtype == np.int32 and prog.table_bytes == 5 * 16 + 2 * 448
    assert prog.table_bytes == ck.fused_stage_table_bytes(ops)
    rows = prog.table[:20].reshape(5, 4)
    assert list(rows[:, 0]) == [
        ops[0].program[0], ops[1].program[0], kr.FS_OP_STENCIL, kr.FS_OP_STENCIL + 1,
        ops[4].program[0],
    ]
    p0 = rows[:, 1].view(np.float32)
    assert p0[1] == 3.5 and p0[4] == 4.0  # contrast factor, quantize step
    assert not rows[:, 2:].any()
    for row, op in zip(prog.stencil_rows(), ops[2:4]):
        assert bytes(row.st) == bytes(ck.stencil_desc(op)) and row.arm == kr.FS_ARM_VPU
    # the last stencil's descriptor also goes by value with each launch
    assert bytes(prog.last._obj) == bytes(prog.stencil_rows()[-1].st)
    assert ctypes.sizeof(kr.FsStencil) == ck.FS_STENCIL_BYTES
    # encoded once per stage: the same ops give the same program
    assert ck.stage_program(ops, 3) is prog
    # gray2rgb between stencils: three planes held at the second stencil
    prog = ck.stage_program(make_pipeline_ops("grayscale,emboss:3,gray2rgb,sobel"), 3)
    assert (prog.c_out, prog.c_smem, prog.two_pass, prog.kmax) == (3, 3, False, 3)
    prog = ck.stage_program(make_pipeline_ops("gray2rgb"), 1)
    assert (prog.c_out, prog.c_smem, prog.two_pass, prog.n_stencils) == (3, 0, False, 0)
    assert prog.last is None
    assert ck.stage_program(make_pipeline_ops("gaussian:7,box:3"), 3).kmax == 7


def test_fused_stage_program_limits():
    # no limit on the ops or stencils of a stage: the table grows with it
    prog = ck.stage_program(make_pipeline_ops(",".join(["invert"] * 25)), 3)
    assert prog.n_ops == 25 and prog.table_bytes == 25 * 16
    prog = ck.stage_program(make_pipeline_ops(",".join(["box:1"] * 9)), 3)
    assert prog.n_stencils == 9 and prog.table_bytes == 9 * (16 + 448)
    with pytest.raises(ValueError, match="no kernel program"):
        ck.stage_program(make_pipeline_ops("gamma:2,sobel"), 3)
    with pytest.raises(ValueError, match="expects 3 channels"):
        ck.stage_program(make_pipeline_ops("sobel,grayscale"), 1)
    with pytest.raises(ValueError, match="1- or 3-channel"):
        ck.stage_program(make_pipeline_ops("sobel"), 4)
    assert ck.stage_program(make_pipeline_ops(",".join(["box:1"] * 8)), 1).n_stencils == 8


def test_fused_stage_geometry():
    # the megakernel stage: a table of 976 bytes, 22 window rows of 16-byte
    # sources, two u8 buffers of one 22 x 140 plane (134 + 5 rounded up to
    # a multiple of 4), a float32 plane for the row pass; the raw RGB window
    # (22 rows of 432 bytes) fits over B and the float plane
    L = ck.fused_stage_layout(3, 1, 16, 128, 3, 976, True)
    assert (L["pitch"], L["raw_pitch"], L["plane"]) == (140, 432, 22 * 140)
    assert (L["rows_off"], L["a_off"], L["b_off"]) == (976, 976 + 22 * 16, 1328 + 3088)
    assert L["total"] == L["f_off"] + 3080 * 4 == 19824
    assert L["b_off"] + 22 * 432 <= L["total"]
    assert ck.fused_stage_smem_bytes(3, 1, 16, 128, 3, 976, True) == 19824
    # no row pass: the raw window sets the end
    assert ck.fused_stage_smem_bytes(3, 1, 16, 128, 1, 16, False) == 16 + 18 * 16 + 18 * 136 + \
        18 * 416
    assert ck.fused_stage_smem_bytes(3, 3, 16, 128, 16, 448, True) > 48 * 1024  # needs the opt-in
    assert ck.stencil_grid(4320, 7680, 16) == (60, 270)
    # redundant reads of 16 x 128 tiles: 1.44x at halo 3, 3.75x at 16
    for halo, ratio in ((3, 1.44), (16, 3.75)):
        assert round((16 + 2 * halo) * (128 + 2 * halo) / (16 * 128), 2) == ratio


@pytest.mark.parametrize("mode", ["reflect101", "edge", "zero", "interior"])
def test_edge_src_matches_pad2d(mode):
    for n, m in ((2, 3), (5, 4), (9, 7)):
        x = torch.arange(1, n * m + 1, dtype=F32).reshape(n, m)
        for p in range(0, min(n, m)):
            padded = pad2d(x, mode, p, p, p, p)
            for i in range(-p, n + p):
                for j in range(-p, m + p):
                    sy, sx = ck.edge_src(i, n, mode), ck.edge_src(j, m, mode)
                    want = 0.0 if sy is None or sx is None else float(x[sy, sx])
                    assert float(padded[i + p, j + p]) == want, (mode, n, m, p, i, j)


@pytest.mark.parametrize(
    "spec_str,channels",
    [("gaussian:5,sharpen", 1), ("emboss:3,gaussian:5", 3), ("median:3,sobel,box:3", 1),
     ("erode:3,dilate:5,emboss:5", 1), ("grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5", 3),
     ("sepia,gaussian:3,grayscale,sobel", 3), (MEGAKERNEL, 3), ("box:1,invert,box:1", 3),
     (",".join(["gaussian:7"] * 3), 1)],
)
def test_k4_tile_algorithm_matches_plain(spec_str, channels):
    """The kernel's window algorithm, emulated tile by tile, gives the bytes
    of its plain version at shapes just above the size gates and at tile
    heights that leave ragged last tiles and several column tiles."""
    ops = make_pipeline_ops(spec_str)
    R, max_op = chain_halo(ops), max(op.halo for op in ops)
    shapes = [(2 * R + 1, 140), (23, max_op + 1), (2 * R + 1, max_op + 1), (37, 53)]
    for seed, (h, w) in enumerate(shapes):
        img = _img(h, w, channels, seed=40 + seed)
        assert ck.fused_stage_reject(ops, h, w, channels) is None
        want = ck.fused_stage_plain(ops, torch.from_numpy(img)).numpy()
        for tile_h in (16, 5):
            np.testing.assert_array_equal(_emulate_k4(ops, img, tile_h), want,
                                          err_msg=f"{spec_str} {h}x{w} tile_h={tile_h}")


def test_pointwise_cores_keep_the_u8_carry_exact():
    """K4 keeps its carry in u8: every kernel pointwise op maps integers in
    0..255 to integers in 0..255 (grid of RGB triples for 3-channel ops)."""
    v = torch.arange(256, dtype=F32)
    g = torch.tensor(sorted(set(range(0, 256, 5)) | {254, 255}), dtype=F32)
    rgb = torch.cartesian_prod(g, g, g)
    specs = ["grayscale", "grayscale601", "sepia", "gray2rgb", "invert",
             "contrast:3.5", "contrast:3", "contrast:0.5", "brightness:20",
             "brightness:-7.5", "threshold:100", "posterize:3", "quantize:6",
             "solarize:100"]
    for spec_str in specs:
        op = make_op(spec_str)
        assert op.kernel_safe, spec_str
        if op.planes_core is not None:
            outs = op.planes_core(rgb[:, 0], rgb[:, 1], rgb[:, 2])
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
        elif op.core is not None:
            outs = [op.core(v)]
        else:  # gray2rgb replicates
            outs = [v]
        for o in outs:
            assert torch.equal(o, o.round()) and o.min() >= 0 and o.max() <= 255, spec_str


# --------------------------------------------------------------------------
# Pipeline, CLI and launch routing
# --------------------------------------------------------------------------


def test_plan_modes_route_to_the_right_kernels(monkeypatch):
    """Under cuda, 'off' and 'auto' launch what the K1/K2 route launches;
    'fused-pallas' launches K4 once per eligible stage and nothing else."""
    calls = []
    for name in ("pointwise_group", "stream_stencil", "fused_stage"):
        real = getattr(ck, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(ck, name, spy)
    img = _img(24, 36, 3, seed=35)
    pipe = Pipeline.parse(MEGAKERNEL)
    want = pipe.jit("torch", device="cpu", plan="off")(img)
    for plan in ("off", "auto"):
        calls.clear()
        assert torch.equal(pipe.jit("cuda", device="cpu", plan=plan)(img), want)
        assert calls == ["stream_stencil", "stream_stencil", "pointwise_group"]
    calls.clear()
    assert torch.equal(pipe.jit("cuda", device="cpu", plan="fused-pallas")(img), want)
    assert calls == ["fused_stage"]
    for plan in ("pointwise", "fused", "fused-pallas"):
        calls.clear()
        assert torch.equal(pipe.jit("torch", device="cpu", plan=plan)(img), want)
        assert calls == []


def _jax_cli_run(*argv):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu", "run", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr


def test_cli_run_fused_pallas_matches_jax_cli(tmp_path, capsys):
    src = tmp_path / "in.png"
    save_image(src, _img(31, 45, 3, seed=36))
    jax_out, out, metrics = tmp_path / "jax.png", tmp_path / "port.png", tmp_path / "m.jsonl"
    _jax_cli_run("--input", str(src), "--output", str(jax_out), "--ops", MEGAKERNEL,
                 "--impl", "auto", "--plan", "fused-pallas")
    rc = cli.main(["run", "--input", str(src), "--output", str(out), "--ops", MEGAKERNEL,
                   "--impl", "cuda", "--plan", "fused-pallas", "--device", "cpu",
                   "--json-metrics", str(metrics)])
    assert rc == 0
    np.testing.assert_array_equal(load_image(out), load_image(jax_out))
    rec = json.loads(metrics.read_text().strip())
    assert rec["plan"] == "fused-pallas" and rec["plan_fallbacks"] == {}
    assert set(rec["plan_metrics"]) == set(JaxPlanMetrics().snapshot())
    assert rec["plan_metrics"]["pallas_stages"] >= 2  # the stage, then gray -> RGB


def test_cli_run_refuses_plans_the_backend_does_not_run(tmp_path, capsys):
    src = tmp_path / "in.png"
    save_image(src, _img(8, 8, 3, seed=37))
    for impl, plan, msg in (("cuda", "fused", "stage-walker"),
                            ("cuda", "pointwise", "stage-walker")):
        rc = cli.main(["run", "--input", str(src), "--output", str(tmp_path / "o.png"),
                       "--impl", impl, "--plan", plan, "--device", "cpu"])
        assert rc == 2
        assert msg in capsys.readouterr().err
    assert not (tmp_path / "o.png").exists()
    # K5 is ported: fused-pallas-mxu runs under every backend
    for impl in ("cuda", "torch", "mxu"):
        out = tmp_path / f"{impl}.png"
        rc = cli.main(["run", "--input", str(src), "--output", str(out),
                       "--impl", impl, "--plan", "fused-pallas-mxu", "--device", "cpu"])
        assert rc == 0 and out.exists()


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec_str", [MEGAKERNEL, REFERENCE, "median:3,sobel,box:3",
                                      "sepia,gaussian:3,grayscale,sobel", "gray2rgb"])
def test_fused_stage_matches_plain_on_card(cuda_device, spec_str):
    ops = make_pipeline_ops(spec_str)
    c = 1 if spec_str == "gray2rgb" else 3
    for shape in ((257, 301), (2 * chain_halo(ops) + 1, 130)):
        img = torch.from_numpy(_img(*shape, c, seed=38)).to(cuda_device)
        for tile_h in (None, 5, 48):
            assert torch.equal(ck.fused_stage(ops, img, tile_h=tile_h),
                               ck.fused_stage_plain(ops, img))
