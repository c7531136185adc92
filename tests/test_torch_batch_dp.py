"""The port's batched and data-parallel forms (`Pipeline.batched`,
`Pipeline.data_parallel`) against the JAX package's on the CPU, and the
batch axis of the kernels' launches (K1 flat, K2, K4/K5 and K6-K8 on grid
z; ops/cuda_kernels.batch_geometry).

The same seeded stacks go through both packages: JAX's `batched` is a
`jax.vmap` (its Pallas kernels in interpret mode take the batch as a grid
dimension), its `data_parallel` shards the stack over the fake CPU devices
of tests/conftest.py. On CPU stacks the port's wrappers take their plain
versions image by image; which wrapper ran, for how many images, is
recorded by spies. Every tolerance is 0: bytes must be equal.
"""

import ctypes
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stencil_emulator import emulate_stage

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

# the port's backends and the JAX package's names for them
JAX_BACKEND = {"torch": "xla", "cuda": "pallas", "mxu": "mxu", "swar": "swar", "auto": "auto"}
SPECS = ["grayscale,contrast:3.5,emboss:3", "gaussian:5,sobel", "sharpen,median:3,erode:3"]


@pytest.fixture(autouse=True)
def _no_calib(monkeypatch):
    monkeypatch.setenv("MCIM_NO_CALIB", "1")


def _stack(n, h=24, w=40, channels=3, seed0=100):
    return np.stack([synthetic_image(h, w, channels=channels, seed=seed0 + t) for t in range(n)])


def _jax_batched(spec, imgs, backend="xla", plan="auto"):
    return np.asarray(JaxPipeline.parse(spec).batched(backend, plan=plan)(jnp.asarray(imgs)))


@pytest.mark.parametrize("plan", ["off", "fused", "fused-pallas"])
@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("spec", SPECS)
def test_batched_matches_jax(spec, backend, plan):
    imgs = _stack(3)
    if plan == "fused" and backend in ("cuda", "auto"):
        # the port's kernel backends refuse the walker plans, batched or not
        with pytest.raises(ValueError, match="stage-walker"):
            Pipeline.parse(spec).batched(backend, device="cpu", plan=plan)
        with pytest.raises(ValueError, match="stage-walker"):
            Pipeline.parse(spec).jit(backend, device="cpu", plan=plan)
        return
    got = Pipeline.parse(spec).batched(backend, device="cpu", plan=plan)(imgs)
    want = _jax_batched(spec, imgs, JAX_BACKEND[backend], plan)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["cuda", "swar", "mxu", "auto"])
@pytest.mark.parametrize("spec", ["gaussian:5", "contrast:3.5,emboss:3,invert", "sobel",
                                  "box:5,sharpen"])
def test_batched_gray_planes_match_jax(spec, backend):
    """Gray stacks, W % 4 == 0: the SWAR kernels' plane path (K6-K8) and the
    banded products on 3-D stacks."""
    imgs = _stack(2, 20, 48, channels=1, seed0=7)
    got = Pipeline.parse(spec).batched(backend, device="cpu", plan="off")(imgs)
    np.testing.assert_array_equal(got.numpy(), _jax_batched(spec, imgs, JAX_BACKEND[backend],
                                                            "off"))


@pytest.mark.parametrize("spec", ["grayscale,equalize,gaussian:3", "grayscale,otsu",
                                  "grayscale,rot:90,gaussian:5", "gaussian:3,crop:2:3:16:30,box:3",
                                  "autocontrast,emboss:3"])
@pytest.mark.parametrize("backend", ["torch", "cuda", "swar"])
def test_batched_global_and_geometric_ops(spec, backend):
    """A statistic reduces per image, as under vmap; a geometric op runs per
    image between the batched groups."""
    channels = 1 if spec.startswith("autocontrast") else 3
    imgs = _stack(3, 28, 36, channels=channels, seed0=40)
    got = Pipeline.parse(spec).batched(backend, device="cpu")(imgs)
    want = _jax_batched(spec, imgs, JAX_BACKEND[backend])
    np.testing.assert_array_equal(got.numpy(), want)
    for t in range(3):  # and image by image against the port's own golden
        assert torch.equal(got[t], Pipeline.parse(spec)(torch.from_numpy(imgs[t])))


@pytest.mark.parametrize("plan", ["off", "fused-pallas"])
def test_batched_non_contiguous_stack(plan):
    """A permuted view and a strided slice of a bigger stack reach the
    kernels' entry contiguous (they take each image at a fixed stride)."""
    base = _stack(6, 30, 24)
    views = [
        torch.from_numpy(base)[::2],                           # every other image
        torch.from_numpy(np.ascontiguousarray(base.transpose(0, 2, 1, 3))).permute(0, 2, 1, 3),
        torch.from_numpy(base)[:, :, 4:20],                    # a column window
    ]
    fn = Pipeline.parse("grayscale,contrast:3.5,emboss:3").batched("cuda", device="cpu",
                                                                   plan=plan)
    seen = []
    real = ck.stream_stencil if plan == "off" else ck.fused_stage

    def spy(*a, **k):
        seen.append(a[-1].is_contiguous())
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "stream_stencil" if plan == "off" else "fused_stage", spy)
        for v in views:
            assert not v.is_contiguous()
            got = fn(v)
            want = _jax_batched("grayscale,contrast:3.5,emboss:3", v.contiguous().numpy(),
                                "pallas", plan)
            np.testing.assert_array_equal(got.numpy(), want)
    assert seen and all(seen)


def test_batched_rejects_a_non_stack():
    fn = Pipeline.parse("invert").batched("cuda", device="cpu")
    with pytest.raises(ValueError, match="stack"):
        fn(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="stack"):
        fn(np.zeros((0, 4, 4), np.uint8))


# --------------------------------------------------------------------------
# One launch per group and stack
# --------------------------------------------------------------------------


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        img = a[-1] if name != "swar_stencil" else a[1]
        calls.append((name, bool(k.get("batched")), tuple(img.shape)))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("backend,plan,spec,want", [
    # K1 then K2 for the first group, K2 for the second
    ("cuda", "off", "grayscale,contrast:3.5,emboss:3,invert",
     [("stream_stencil", 1), ("pointwise_group", 1)]),
    ("cuda", "off", "gaussian:5,sobel", [("stream_stencil", 2)]),
    # one K4 per fused stage
    ("cuda", "fused-pallas", "grayscale,contrast:3.5,emboss:3", [("fused_stage", 1)]),
    ("cuda", "fused-pallas-mxu", "gaussian:5,sharpen", [("fused_stage", 1)]),
    ("mxu", "fused-pallas", "gaussian:5,emboss:3", [("fused_stage", 1)]),
])
def test_one_wrapper_call_per_group_and_stack(monkeypatch, backend, plan, spec, want):
    calls: list = []
    for name in ("pointwise_group", "stream_stencil", "fused_stage"):
        _spy(monkeypatch, ck, name, calls)
    imgs = _stack(4, 20, 32)
    Pipeline.parse(spec).batched(backend, device="cpu", plan=plan)(imgs)
    assert sorted(Counter(n for n, _, _ in calls).items()) == sorted(want)
    # every call took the whole stack (a gray one after `grayscale`)
    assert all(b and shape[0] == 4 and shape[1:3] == (20, 32) for _, b, shape in calls)


def test_one_swar_call_per_group_and_stack(monkeypatch):
    calls: list = []
    _spy(monkeypatch, sk, "swar_stencil", calls)
    _spy(monkeypatch, ck, "stream_stencil", calls)
    imgs = _stack(5, 24, 64, channels=1)
    got = Pipeline.parse("contrast:3.5,gaussian:5,invert,sobel,median:3").batched(
        "swar", device="cpu")(imgs)
    # K6 (with its chains) and K8 on SWAR, the median on K2: each once
    assert calls == [("swar_stencil", True, imgs.shape), ("swar_stencil", True, imgs.shape),
                     ("stream_stencil", True, imgs.shape)]
    want = _jax_batched("contrast:3.5,gaussian:5,invert,sobel,median:3", imgs, "swar")
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_count_no_launch_on_cpu_stacks():
    ck.reset_launch_counts()
    imgs = torch.from_numpy(_stack(3, 20, 32))
    for backend, plan in (("cuda", "off"), ("cuda", "fused-pallas"), ("swar", "off")):
        Pipeline.parse("gaussian:5,emboss:3").batched(backend, device="cpu", plan=plan)(imgs)
    assert not any(ck.launch_counts().values())


def test_route_is_built_once_per_image_shape(monkeypatch):
    built = []
    real = Pipeline._build

    def spy(self, *a, **k):
        built.append(a[3])  # the images' width
        return real(self, *a, **k)

    monkeypatch.setattr(Pipeline, "_build", spy)
    fn = Pipeline.parse("gaussian:5").batched("cuda", device="cpu")
    for n in (1, 2, 5):
        fn(_stack(n, 20, 32))
    fn(_stack(2, 20, 36))
    assert built == [32, 36]


def test_one_image_runs_as_a_stack_of_one():
    """The wrappers and runners are written for stacks (ops/spec.takes_stack):
    one image reaches the body as a stack of one and comes back as its
    image, a stack passes as it is with ``batched=True``; `per_image` does
    not copy a stack of one."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import per_image, takes_stack

    seen = []

    @takes_stack
    def body(k, stack, *, add=0):
        seen.append(tuple(stack.shape))
        return stack + k + add

    img = torch.zeros(5, 6, 3, dtype=torch.uint8)
    assert body(2, img, add=1).shape == (5, 6, 3) and int(body(2, img).max()) == 2
    assert body(1, torch.stack([img, img]), batched=True).shape == (2, 5, 6, 3)
    assert seen == [(1, 5, 6, 3), (1, 5, 6, 3), (2, 5, 6, 3)]
    one = img[None]
    assert per_image(lambda x: x, one).data_ptr() == one.data_ptr()
    assert torch.equal(per_image(lambda x: x + 1, torch.stack([img, img + 1]))[1], img + 2)


# --------------------------------------------------------------------------
# The batch axis's host-side geometry
# --------------------------------------------------------------------------


def test_batch_geometry():
    assert ck.batch_geometry(1, 4320, 7680, 3, 1) == (1, 99_532_800, 33_177_600)
    # grayscale changes the channel count: the strides differ
    n, s_in, s_out = ck.batch_geometry(4, 37, 53, 3, 1)
    assert (n, s_in, s_out) == (4, 37 * 53 * 3, 37 * 53)
    for bad in (0, -1, ck.MAX_BATCH + 1):
        with pytest.raises(ValueError, match="images"):
            ck.batch_geometry(bad, 8, 8, 1, 1)
    assert ck.MAX_BATCH == 65535  # CUDA's limit on grid z


def test_batch_offsets_pass_2_to_the_31_in_64_bits():
    """A stack of 8K RGB frames passes 2^31 bytes at its 22nd frame: the
    offsets are exact Python ints here, computed without allocating, and
    they reach the kernels unwrapped through the 64-bit stride arguments."""
    n, s_in, s_out = ck.batch_geometry(24, 4320, 7680, 3, 3)
    assert n * s_in > 2**31 and 21 * s_in < 2**31 < 22 * s_in
    assert [i * s_in for i in (22, 23)] == [2_189_721_600, 2_289_254_400]
    assert ctypes.c_longlong(23 * s_in).value == 23 * s_in
    assert ctypes.c_int(23 * s_in).value != 23 * s_in  # what a 32-bit offset would make


def test_fused_stage_reads_each_image_through_its_offset():
    """Image i of a stack starts i * stride bytes past the first, so with
    a stride that is no multiple of 16 each image reaches K4's block at
    another alignment. The numpy replay of K4 (tests/_torch_stencil_emulator.py)
    from each image's own offset equals the plain version on that image."""
    stack = torch.from_numpy(_stack(3, 13, 37, seed0=5))
    for ops in (Pipeline.parse("grayscale,contrast:3.5,emboss:3").ops,
                Pipeline.parse("gaussian:5,sharpen").ops):
        _, s_in, _ = ck.batch_geometry(3, 13, 37, 3, 1)
        assert s_in % 16 == 3
        for i, img in enumerate(stack):
            got = emulate_stage(ops, img.numpy(), base=(11 + i * s_in) % 16)
            want = ck.fused_stage_plain(ops, img, arms=("vpu",) * len(ops)).numpy()
            np.testing.assert_array_equal(got.reshape(want.shape), want)


class _FakeLib:
    """Stands for a loaded kernel library: takes the bindings' declarations."""

    def __getattr__(self, name):
        fn = type("EntryPoint", (), {})()
        setattr(self, name, fn)
        return fn


def test_launch_argtypes_carry_the_batch(monkeypatch):
    """The ctypes bindings of K2, K4 and K6-K8 declare the stack's image
    count as an int and its input and output strides as 64-bit ints, just
    before the device and the stream."""
    monkeypatch.setattr(kr, "build", lambda names: {n: Path(f"lib{n}.so") for n in names})
    monkeypatch.setattr(kr.ctypes, "CDLL", lambda path: _FakeLib())
    ci, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    for name in ("stream_stencil", "fused_stage", "swar_stencil"):
        lib = kr.load.__wrapped__(name)
        argtypes = getattr(lib, f"{name}_launch").argtypes
        assert argtypes[-5:] == [ci, ll, ll, ci, vp], name


# --------------------------------------------------------------------------
# Data-parallel
# --------------------------------------------------------------------------


def _dp_mesh(n):
    return pmesh.make_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("n_slots", [2, 4])
@pytest.mark.parametrize("n_img", [1, 4, 5, 7])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_data_parallel_matches_jax(n_slots, n_img, backend):
    spec = "grayscale,contrast:3.5,emboss:3"
    imgs = _stack(n_img, 24, 40, seed0=60)
    got = Pipeline.parse(spec).data_parallel(_dp_mesh(n_slots), backend=backend)(imgs)
    jax_fn = JaxPipeline.parse(spec).data_parallel(jax_make_mesh(n_slots),
                                                   backend=JAX_BACKEND[backend])
    want = np.asarray(jax_fn(jnp.asarray(imgs)))
    assert got.shape[0] == n_img
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", ["grayscale,equalize", "gaussian:5,sobel",
                                  "grayscale,rot:90,gaussian:3"])
def test_data_parallel_global_and_geometric(spec):
    imgs = _stack(6, 28, 36, seed0=80)
    got = Pipeline.parse(spec).data_parallel(_dp_mesh(4))(imgs)
    want = np.asarray(JaxPipeline.parse(spec).data_parallel(jax_make_mesh(4))(jnp.asarray(imgs)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_data_parallel_splits_the_stack_over_the_slots_in_order(monkeypatch):
    """Each slot runs `batched` once on its chunk, in slot order; the stack
    is padded with its last image to a multiple of the slots."""
    chunks = []
    real = Pipeline.batched

    def spy(self, *a, **k):
        fn = real(self, *a, **k)

        def run(x):
            chunks.append(x.clone())
            return fn(x)

        return run

    monkeypatch.setattr(Pipeline, "batched", spy)
    imgs = torch.from_numpy(_stack(5, 16, 24))
    out = Pipeline.parse("invert").data_parallel(_dp_mesh(4))(imgs)
    assert [c.shape[0] for c in chunks] == [2, 2, 2, 2]
    padded = torch.cat([imgs, imgs[-1:].expand(3, -1, -1, -1)])
    assert torch.equal(torch.cat(chunks), padded)
    assert torch.equal(out, 255 - imgs)


def test_data_parallel_rejects_bad_stacks():
    fn = Pipeline.parse("invert").data_parallel(_dp_mesh(2))
    with pytest.raises(TypeError, match="uint8"):
        fn(np.zeros((2, 4, 4), np.float32))
    with pytest.raises(ValueError, match="stack"):
        fn(np.zeros((4, 4), np.uint8))
