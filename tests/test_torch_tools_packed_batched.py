"""T1's batch axis (``tools/packed_kernels.py``, ``ops/csrc/packed_stream.cu``)
on the CPU, against the JAX repository's ``tools/packed_kernels.py``:

* port ``pipeline_packed(batched=True)`` on a (3, 49, 256) gray stack
  equals ``jax.vmap(pipeline_packed, interpret=True)``, the counterpart of
  ``tests/test_packed.py::test_packed_pipeline_batched_vmap``; RGB stacks
  and stacks through fallback groups equal the JAX pipeline per image;
* the host-side batch geometry: the grid (strips, runs, images), the
  strides in words, a 64-bit offset past 2^31 bytes computed without
  allocating, and the tile picker given the stack's length;
* one launch counted per group per stack, with the stack's image count and
  strides in the launch's arguments, through the launch path with a
  stand-in library (meta tensors, no card).

Every tolerance is 0.
"""

import ctypes
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
from tools import packed_kernels as jax_pk


def _stack(n, h, w, channels, seed0):
    return np.stack([synthetic_image(h, w, channels=channels, seed=seed0 + k) for k in range(n)])


def test_batched_pipeline_equals_jax_vmap_interpret():
    """tests/test_packed.py:159 on the port: the stack through the batched
    runner, the JAX runner under vmap in interpret mode."""
    img3 = _stack(3, 49, 256, 1, 50)
    ops = JaxPipeline.parse("gaussian:5").ops
    want = np.asarray(jax.vmap(partial(jax_pk.pipeline_packed, ops, interpret=True))(
        jnp.asarray(img3)))
    got = pk.pipeline_packed(make_pipeline_ops("gaussian:5"), torch.from_numpy(img3),
                             batched=True)
    assert got.shape == (3, 49, 256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec,channels", [
    ("grayscale,gaussian:5", 3), ("sepia,gaussian:3", 3), ("sepia,invert", 3),
    ("gaussian:5,invert,sobel", 1), ("gamma:2.2,emboss:3,median:3", 1),
    ("grayscale,contrast:3.5,emboss:3,gray2rgb", 3),
])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_batched_pipeline_equals_jax_per_image(spec, channels, n):
    """RGB and gray stacks, packed groups and fallback groups (gamma's
    table, gray2rgb after a stencil) alike: image i equals the JAX
    pipeline on image i, and the one-image form on it."""
    imgs = _stack(n, 33, 64, channels, 70 + n)
    got = pk.pipeline_packed(make_pipeline_ops(spec), torch.from_numpy(imgs), batched=True)
    for i in range(n):
        want = np.asarray(JaxPipeline.parse(spec)(jnp.asarray(imgs[i])))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=f"image {i}")
        one = pk.pipeline_packed(make_pipeline_ops(spec), torch.from_numpy(imgs[i]))
        np.testing.assert_array_equal(one.numpy(), want)


def test_batched_pipeline_takes_a_non_contiguous_stack():
    imgs = torch.from_numpy(_stack(6, 20, 128, 3, 90))[::2]
    assert not imgs.is_contiguous()
    got = pk.pipeline_packed(make_pipeline_ops("grayscale,gaussian:5"), imgs, batched=True)
    for i in range(3):
        want = np.asarray(JaxPipeline.parse("grayscale,gaussian:5")(jnp.asarray(imgs[i].numpy())))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("ghost", [False, True])
def test_words_runner_batched_equals_one_image_at_a_time(ghost):
    """run_group_packed_words(batched=True) on (N, H, W/4) planes equals the
    one-image call per image (the plain versions here); ghost mode takes
    one image only."""
    pw, st = ck.group_ops(make_pipeline_ops("invert,gaussian:5"))[0]
    stack = torch.from_numpy(_stack(3, 24, 96, 1, 95))
    words = [pk._pack(stack)]
    got = pk.run_group_packed_words(pw, st, words, 24, 96, batched=True)[0]
    assert got.shape == (3, 24, 24) and got.dtype == torch.int32
    for i in range(3):
        one = pk.run_group_packed_words(pw, st, [words[0][i]], 24, 96)[0]
        assert torch.equal(got[i], one)
    if ghost:
        strips = ([torch.zeros((2, 24), dtype=torch.int32)],) * 2
        with pytest.raises(ValueError, match="ghost mode takes one image"):
            pk.run_group_packed_words(pw, st, words, 24, 96, ghosts=strips, y0=0, image_h=24,
                                      batched=True)


@pytest.mark.parametrize("n,h,wp", [(1, 4320, 1920), (4, 4320, 1920), (3, 49, 64), (7, 5, 11)])
def test_batch_geometry_grid_and_word_strides(n, h, wp):
    images, s_in, s_out = pk.packed_batch_geometry(n, h, wp)
    assert (images, s_in, s_out) == (n, h * wp, h * wp)
    tile_w, run_h = pk.packed_tile_shape(h, wp, n)
    strips, runs = pk.packed_grid(h, wp, tile_w, run_h)
    assert strips == -(-wp // tile_w) and runs == -(-h // run_h) and runs <= 65535
    # the grid's z is the stack: the last image's first word sits
    # (n - 1) * stride words past the first image's
    assert (images - 1) * s_in == (n - 1) * h * wp


def test_batch_geometry_limits():
    with pytest.raises(ValueError, match="1 to 65535"):
        pk.packed_batch_geometry(0, 8, 8)
    with pytest.raises(ValueError, match="1 to 65535"):
        pk.packed_batch_geometry(65536, 8, 8)
    assert pk.MAX_BATCH == ck.MAX_BATCH == 65535


def test_offset_past_2_31_bytes_in_64_bits():
    """A stack of 8K gray planes passes 2^31 bytes at its 66th image: the
    last image's byte offset, computed from the geometry without
    allocating, does not fit 32 bits, and PkPlanes carries the strides as
    64-bit ints."""
    n, h, wp = 80, 4320, 1920
    _, s_in, s_out = pk.packed_batch_geometry(n, h, wp)
    last = 4 * (n - 1) * s_in
    assert last > 2**31 and 4 * 65 * s_in > 2**31 > 4 * 64 * s_in
    planes = kr.PkPlanes()
    planes.in_stride, planes.out_stride = s_in, s_out
    assert planes.in_stride * 4 * (n - 1) == last
    assert dict(kr.PkPlanes._fields_)["in_stride"] is ctypes.c_longlong
    assert ctypes.sizeof(kr.PkPlanes) == 112


@pytest.mark.parametrize("h,wp", [(4320, 1920), (97, 96), (40, 8), (33, 40), (200000, 8)])
def test_tile_picker_given_the_stack(h, wp):
    """Given N, the picker counts every image's blocks: a stack keeps strips
    at least as wide and runs at least as long as one image, narrowing
    only while the whole grid is short of N_SMS one-chunk blocks, and runs
    cover about TARGET_BLOCKS blocks over the stack."""
    one = pk.packed_tile_shape(h, wp)
    assert pk.packed_tile_shape(h, wp, 1) == one
    for n in (2, 4, 16, 1000):
        tile_w, run_h = pk.packed_tile_shape(h, wp, n)
        assert tile_w >= one[0] and run_h >= one[1] and run_h % pk.CHUNK_H == 0
        strips, runs = pk.packed_grid(h, wp, tile_w, run_h)
        assert runs <= 65535
        for w in (w for w in pk.TILE_WIDTHS if w > tile_w):
            assert n * np.prod(pk.packed_grid(h, wp, w, pk.CHUNK_H)) < pk.N_SMS
        chunks = pk.packed_grid(h, wp, tile_w, pk.CHUNK_H)[1]
        if pk.CHUNK_H < run_h < chunks * pk.CHUNK_H:
            assert n * strips * runs >= pk.TARGET_BLOCKS // 2
    # one 8K plane fills the card with 32-word strips and 3-chunk runs; four
    # planes keep the strips and take runs four times as long, about
    assert pk.packed_tile_shape(4320, 1920) == (32, 96)
    assert pk.packed_tile_shape(4320, 1920, 4) == (32, 480)


class _RecordingLib:
    """Stands for the loaded packed_stream library: records each launch."""

    def __init__(self):
        self.calls = []

    def _record(self, name):
        def launch(planes_ref, *args):
            planes = ctypes.cast(planes_ref, ctypes.POINTER(kr.PkPlanes)).contents
            self.calls.append((name, planes.in_stride, planes.out_stride, args))
            return 0
        return launch

    def __getattr__(self, name):
        return self._record(name)


@pytest.fixture
def launches(monkeypatch):
    """T1's launch path without a card: meta tensors, a recording library,
    a stream handle of 0."""
    lib = _RecordingLib()
    monkeypatch.setattr(kr, "load", lambda name: lib)
    monkeypatch.setattr(ck, "stream_handle", lambda device: 0)
    ck.reset_launch_counts()
    yield lib
    ck.reset_launch_counts()


@pytest.mark.parametrize("n", [1, 3])
def test_one_launch_per_group_per_stack(launches, n):
    """pipeline_packed over a stack of n: each group is one launch counted
    once: T1 with n images on grid z and the per-image word strides, T1-pw
    as one flat run of n * H rows."""
    h, w = 40, 128
    stack = torch.empty((n, h, w, 3), dtype=torch.uint8, device="meta")
    out = pk.pipeline_packed(make_pipeline_ops("grayscale,gaussian:5,invert,sobel,contrast:3.5"),
                             stack, batched=True)
    assert out.shape == (n, h, w)
    assert ck.TOOL_LAUNCHES["T1"] == 2 and ck.TOOL_LAUNCHES["T1-pw"] == 1
    assert [c[0] for c in launches.calls] == ["packed_stream_launch"] * 2 + [
        "packed_pointwise_group_launch"]
    wp = w // 4
    tile_w, run_h = pk.packed_tile_shape(h, wp, n)
    for name, s_in, s_out, args in launches.calls[:2]:
        # H, Wp, n_in, n_out, table, n_ops, desc, tile_w, chunk_h, run_h, n_img, device, stream
        assert (args[0], args[1], args[7], args[8], args[9], args[10]) == (
            h, wp, tile_w, pk.CHUNK_H, run_h, n)
        assert s_in == s_out == h * wp
    _, _, _, args = launches.calls[2]
    assert args[:2] == (n * h, wp)  # T1-pw: the stack as one flat run


def test_one_image_is_a_stack_of_one(launches):
    pw, st = ck.group_ops(make_pipeline_ops("gaussian:5"))[0]
    words = [torch.empty((40, 32), dtype=torch.int32, device="meta")]
    out = pk.run_group_packed_words(pw, st, words, 40, 128)
    assert out[0].shape == (40, 32) and ck.TOOL_LAUNCHES["T1"] == 1
    (_, s_in, _, args), = launches.calls
    assert args[10] == 1 and s_in == 40 * 32
