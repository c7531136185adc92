"""The port's kernel modules on the CPU: K1 (pointwise group) and K2 (fused
stencil group) run their plain PyTorch versions on CPU tensors and must
give the same bytes as the JAX package's Pallas kernels in interpret mode.

Also checked here: the host-side encoding and geometry the CUDA kernels are
launched with, and that nothing falls back to the CPU where CUDA was asked
for. Tests that need a card carry the ``cuda`` marker and skip without one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import pallas_kernels as jax_pk
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import registry
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr


def _jax_pallas(spec_str, img, block_h=None):
    ops = JaxPipeline.parse(spec_str).ops
    if block_h is None:
        return np.asarray(jax_pk.pipeline_pallas(ops, jnp.asarray(img), interpret=True))
    planes = (
        [jnp.asarray(img[..., c]) for c in range(img.shape[2])]
        if img.ndim == 3 else [jnp.asarray(img)]
    )
    for pw, st in jax_pk.group_ops(ops):
        planes = jax_pk.run_group(pw, st, planes, interpret=True, block_h=block_h)
    return np.asarray(planes[0] if len(planes) == 1 else jnp.stack(planes, -1))


def _port_cuda_on_cpu(spec_str, img, block_h=None):
    ops = Pipeline.parse(spec_str).ops
    return ck.pipeline_cuda(ops, torch.from_numpy(img), block_h=block_h).numpy()


@pytest.mark.parametrize(
    "spec_str,channels",
    [
        ("grayscale,contrast:3.5,emboss:3", 3),  # the reference pipeline: one K2
        ("sepia,gaussian:5", 3),
        ("grayscale,gaussian:5,quantize:6", 3),  # K2, then a trailing K1
        ("gamma:2.2,sobel", 1),  # a lookup-table group, then K2
        ("grayscale,gray2rgb,median:3", 3),  # gray -> RGB inside the prologue
        ("invert,solarize:90,brightness:-3", 3),  # K1 alone
    ],
)
def test_pipeline_matches_pallas_interpret(spec_str, channels):
    img = synthetic_image(40, 56, channels=channels, seed=21)
    got = _port_cuda_on_cpu(spec_str, img)
    np.testing.assert_array_equal(got, _jax_pallas(spec_str, img))


@pytest.mark.parametrize("spec_str", ["box:1", "invert,box:1"])
def test_halo0_stencil_matches_jax_golden(spec_str):
    """Halo 0 (box:1): the JAX Pallas stream kernel cannot build this group
    (its top strip concatenates zero rows), so K2's plain version is held
    against the JAX golden path instead."""
    img = synthetic_image(40, 56, channels=3, seed=22)
    want = np.asarray(JaxPipeline.parse(spec_str)(jnp.asarray(img)))
    np.testing.assert_array_equal(_port_cuda_on_cpu(spec_str, img), want)
    np.testing.assert_array_equal(_port_cuda_on_cpu(spec_str, img), img if spec_str == "box:1"
                                  else 255 - img)


@pytest.mark.parametrize(
    "spec_str,height",
    [
        ("gaussian:5", 65),
        ("gaussian:7", 66),
        ("erode:5", 65),
        ("box:5", 97),
        ("dilate:7", 66),
        ("median:3", 96),
        ("gaussian:5", 64),
    ],
)
def test_ragged_heights_match_pallas_run_group(spec_str, height):
    img = synthetic_image(height, 140, channels=1, seed=41)
    got = _port_cuda_on_cpu(spec_str, img, block_h=32)
    np.testing.assert_array_equal(got, _jax_pallas(spec_str, img, block_h=32))


def test_group_split_matches_jax():
    spec_str = "grayscale,contrast:3.5,emboss:3,gamma:0.8,invert,gaussian:3,posterize:2"
    ours = ck.group_ops(Pipeline.parse(spec_str).ops)
    theirs = jax_pk.group_ops(JaxPipeline.parse(spec_str).ops)
    assert [([p.name for p in pw], st and st.name) for pw, st in ours] == [
        ([p.name for p in pw], st and st.name) for pw, st in theirs
    ]
    assert ck._channels_after(ours[0][0], 3) == 1


# --------------------------------------------------------------------------
# Host-side encoding and geometry of the launches
# --------------------------------------------------------------------------


def test_pointwise_program_encoding():
    ops = list(Pipeline.parse("grayscale,contrast:3.5,gray2rgb,posterize:3").ops)
    prog, c_out = ck.pointwise_program(ops, 3)
    assert c_out == 3
    assert prog.n_ops == 4
    assert list(prog.op)[:4] == [op.program[0] for op in ops]
    assert prog.p0[1] == 3.5 and prog.p0[3] == 32.0
    with pytest.raises(ValueError, match="expects 3 channels"):
        ck.pointwise_program(ops, 1)
    with pytest.raises(ValueError, match="at most 8"):
        ck.pointwise_program([registry.make_op("invert")] * 9, 3)
    with pytest.raises(ValueError, match="no kernel program"):
        ck.pointwise_program([registry.make_op("gamma:2")], 1)
    with pytest.raises(ValueError, match="1- or 3-channel"):
        ck.pointwise_program([], 4)


@pytest.mark.parametrize(
    "spec_str,family,ksize",
    [
        ("emboss:3", 0, 3), ("sobel", 1, 3), ("gaussian:7", 2, 7), ("box:1", 2, 1),
        ("erode:5", 3, 5), ("dilate:3", 4, 3), ("median:5", 5, 5), ("unsharp", 0, 5),
    ],
)
def test_stencil_desc_encoding(spec_str, family, ksize):
    op = registry.make_op(spec_str)
    d = ck.stencil_desc(op)
    assert (d.family, d.ksize, d.halo) == (family, ksize, op.halo)
    if family in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(d.w0[: ksize * ksize]), op.kernels[0].reshape(-1)
        )
    if family == 2:
        np.testing.assert_array_equal(np.asarray(d.sep[:ksize]), op.separable)
    assert d.scale == np.float32(op.scale)


def test_stencil_desc_rejects_what_the_kernel_cannot_run():
    gauss = registry.make_op("gaussian:5")
    with pytest.raises(ValueError, match="square windows"):
        ck.stencil_desc(dataclasses.replace(gauss, halo=1))
    with pytest.raises(ValueError, match="edge mode"):
        ck.stencil_desc(dataclasses.replace(gauss, edge_mode="wrap"))
    with pytest.raises(ValueError, match="median networks"):
        ck.stencil_desc(
            registry.op_from_arrays({"name": "m7", "halo": 3, "kernels": [np.ones((7, 7))],
                                     "reduce": "median", "edge_mode": "reflect101"})
        )


def test_run_group_rejections_match_jax():
    img = torch.from_numpy(synthetic_image(3, 40, channels=1, seed=1))
    with pytest.raises(ValueError, match="too small for halo"):
        ck.run_group([], registry.make_op("gaussian:7"), img)
    zero = dataclasses.replace(registry.make_op("sharpen"), edge_mode="zero")
    with pytest.raises(NotImplementedError):
        ck.run_group([], zero, img)


@pytest.mark.parametrize(
    "c_out,tile_h,halo,family",
    [(3, 16, 2, 2), (1, 16, 1, 0), (3, 48, 3, 2), (1, 1, 0, 2), (3, 16, 2, 5)],
)
def test_stencil_shared_memory_sizes(c_out, tile_h, halo, family):
    nbytes = ck.stencil_smem_bytes(c_out, tile_h, halo, family)
    window = c_out * (tile_h + 2 * halo) * (ck.TILE_W + 2 * halo)
    assert nbytes >= window
    if family in (2, 3, 4):
        assert nbytes == -(-window // 16) * 16 + 4 * c_out * (tile_h + 2 * halo) * ck.TILE_W
    else:
        assert nbytes == -(-window // 16) * 16
    assert nbytes <= ck.MAX_SMEM_BYTES


def test_stencil_geometry_checks():
    op = registry.make_op("gaussian:7")
    img = torch.from_numpy(synthetic_image(64, 64, seed=2))
    with pytest.raises(ValueError, match="shared memory"):
        ck.stream_stencil([], op, img, tile_h=400)
    assert ck.stencil_grid(4320, 7680, 16) == (60, 270)
    assert ck.stencil_grid(37, 53, 16) == (1, 3)


def test_wrappers_count_no_launch_on_cpu():
    ck.reset_launch_counts()
    img = torch.from_numpy(synthetic_image(20, 24, seed=3))
    ck.pipeline_cuda(Pipeline.parse("grayscale,emboss:3,gray2rgb").ops, img)
    assert ck.pointwise_group.launches == 0 and ck.stream_stencil.launches == 0


# --------------------------------------------------------------------------
# No fallback: CUDA asked for means CUDA or an error
# --------------------------------------------------------------------------


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Pipeline.parse("emboss:3").jit(backend="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Pipeline.parse("emboss:3").jit(backend="torch", device="cuda")


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    img = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.stream_stencil([], registry.make_op("emboss:3"), img)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.pointwise_group([registry.make_op("invert")], img)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kr.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kr, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kr.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kr.find_nvcc()


def test_nvcc_flags_are_ieee_exact():
    cmd = kr.nvcc_command("nvcc", "pointwise", kr.BUILD_DIR / "x.so")
    assert "-fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "ftz=true" in c for c in cmd)
    assert kr.library_path("pointwise").parent == kr.BUILD_DIR
    assert kr.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_kernel_sources_stand_alone():
    for name in os.listdir(kr.CSRC_DIR):
        with open(kr.CSRC_DIR / name) as f:
            src = f.read()
        assert "torch/extension.h" not in src, name
        assert "cudaGetLastError" in src or name.endswith(".cuh"), name
    assert set(kr.SOURCES) == {
        n[:-3] for n in os.listdir(kr.CSRC_DIR) if n.endswith(".cu")
    }


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "spec_str",
    ["grayscale,contrast:3.5,emboss:3", "gaussian:5", "sobel", "median:5",
     "erode:3", "sepia,invert", "grayscale,gray2rgb"],
)
def test_kernels_match_plain_on_card(cuda_device, spec_str):
    img = torch.from_numpy(synthetic_image(257, 301, seed=5)).to(cuda_device)
    pipe = Pipeline.parse(spec_str)
    got = pipe.jit("cuda", device=cuda_device)(img)
    want = pipe.jit("torch", device=cuda_device)(img)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_shared_memory_formula_matches_source(cuda_device):
    lib = kr.load("stream_stencil")
    for args in [(3, 16, 2, 2), (1, 16, 1, 0), (3, 48, 3, 2)]:
        assert lib.stream_stencil_smem_bytes(*args) == ck.stencil_smem_bytes(*args)
