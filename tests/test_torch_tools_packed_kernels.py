"""T1, the port's packed-word group runner (``tools/packed_kernels.py``,
``ops/csrc/packed_stream.cu``), on the CPU, against the JAX repository's
``tools/packed_kernels.py``:

* ``pack_words`` / ``unpack_words`` equal the JAX views as int32 words;
* ``packed_supported`` equals the JAX rules on every group of the
  registry's specs at widths 28/32/384/510/512;
* ``pipeline_packed`` (plain versions on the CPU) equals the JAX golden ops
  on the cases of ``tests/test_packed.py``: its 33 specs, the ragged
  heights, a last block shorter than the halo, the ``block_h`` overrides
  and the fallback groups;
* the plain versions equal the JAX kernels in interpret mode on one case
  per kind (separable, min/max, non-separable correlation, magnitude,
  median, interior, pointwise only) and on the two-tile ghost stitch;
* the wrappers refuse what the kernel does not take and count no launch on
  the CPU.

Every tolerance is 0: u8 or int32 bytes must be equal. Tests that need a
card carry the ``cuda`` marker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops.pallas_kernels import group_ops as jax_group_ops
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
from tools import packed_kernels as jax_pk

# tests/test_packed.py's specs
PACKED_SPECS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "box:3", "box:5", "box:7",
    "invert,gaussian:5", "brightness:25,gaussian:3", "grayscale,gaussian:5",
    "grayscale,contrast:3.5", "grayscale601,box:3", "sepia", "threshold:99,gaussian:5,invert",
    "erode:3", "erode:5", "erode:7", "dilate:5", "invert,dilate:3", "sobel", "prewitt",
    "scharr", "laplacian:8", "sharpen", "unsharp", "emboss101:3", "emboss101:5", "median:3",
    "median:5", "filter:1/2/1/2/4/2/1/2/1:0.0625", "grayscale,sobel", "emboss:3", "emboss:5",
    "grayscale,contrast:3.5,emboss:3",
]
# the registry's specs (tests/test_torch_ops.py's lists) beside them
REGISTRY_SPECS = PACKED_SPECS + [
    "gray", "contrast:4.3", "brightness:-7.5", "threshold:77.7", "gray2rgb", "posterize:3",
    "quantize:6", "solarize:100", "gamma:2.2", "box:1", "laplacian:4",
    "filter:-1/0/1/-2/0/2/-1/0/1", "filter:0.1/0.2/0.1/0.2/0.3/0.2/0.1/0.2/0.1",
    "dilate:3", "dilate:7", "grayscale,contrast:4.3,gaussian:5", "gamma:2.2,sobel",
]


def _channels(spec):
    return 3 if spec.startswith(("grayscale", "sepia", "gray,")) else 1


def _golden(spec, img):
    return np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))


def _packed(spec, img, block_h=None):
    return pk.pipeline_packed(Pipeline.parse(spec).ops, torch.from_numpy(img),
                              block_h=block_h).numpy()


# --------------------------------------------------------------------------
# Views and eligibility
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 64), (3, 32), (40, 384)])
def test_pack_words_equal_jax_as_int32(shape):
    img = synthetic_image(*shape, channels=1, seed=shape[0])
    img[::3, ::5] = 255  # high bytes: the sign bit of byte 3
    want = np.asarray(jax_pk.pack_words(jnp.asarray(img)))
    words = pk.pack_words(torch.from_numpy(img))
    assert words.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(words.numpy(), want)
    back = pk.unpack_words(words, shape[1])
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_pk.unpack_words(want, shape[1])))
    np.testing.assert_array_equal(back.numpy(), img)
    plane = torch.from_numpy(img)
    assert pk.pack_words(plane).data_ptr() == plane.data_ptr()  # a view


def test_views_refuse_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 4"):
        pk.pack_words(torch.zeros((4, 30), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8 plane"):
        pk.pack_words(torch.zeros((4, 32, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="hold width"):
        pk.unpack_words(torch.zeros((4, 8), dtype=torch.int32), 30)
    with pytest.raises(ValueError, match="int32 words"):
        pk.unpack_words(torch.zeros((4, 8), dtype=torch.int64), 32)


@pytest.mark.parametrize("spec", REGISTRY_SPECS)
def test_packed_supported_equals_jax(spec):
    ours = ck.group_ops(make_pipeline_ops(spec))
    theirs = jax_group_ops(JaxPipeline.parse(spec).ops)
    assert [[op.name for op in pw] for pw, _ in ours] == [[op.name for op in pw]
                                                          for pw, _ in theirs]
    for (pw, st), (jpw, jst) in zip(ours, theirs):
        for width in (28, 32, 384, 510, 512):
            assert pk.packed_supported(pw, st, width) == jax_pk.packed_supported(
                jpw, jst, width), (spec, width)


# --------------------------------------------------------------------------
# pipeline_packed against the JAX golden ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", PACKED_SPECS)
def test_pipeline_packed_equals_golden(spec):
    img = synthetic_image(97, 384, channels=_channels(spec), seed=41)
    np.testing.assert_array_equal(_packed(spec, img), _golden(spec, img))


@pytest.mark.parametrize("height", [33, 64, 65, 95, 129])
@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "median:3", "emboss:5"])
def test_pipeline_packed_ragged_heights(spec, height):
    img = synthetic_image(height, 256, channels=1, seed=42)
    np.testing.assert_array_equal(_packed(spec, img, block_h=32), _golden(spec, img))


@pytest.mark.parametrize("spec,height", [("gaussian:5", 33), ("gaussian:7", 34)])
def test_pipeline_packed_last_block_shorter_than_halo(spec, height):
    img = synthetic_image(height, 128, channels=1, seed=43)
    np.testing.assert_array_equal(_packed(spec, img, block_h=32), _golden(spec, img))


@pytest.mark.parametrize("block_h", [32, 64, 96])
def test_pipeline_packed_block_overrides(block_h):
    img = synthetic_image(130, 512, channels=1, seed=44)
    np.testing.assert_array_equal(_packed("gaussian:5", img, block_h), _golden("gaussian:5", img))


@pytest.mark.parametrize(
    "spec,ch,hw,launches",
    [
        ("gaussian:5", 1, (60, 258), {"K2": 1}),  # W % 4 != 0
        ("gaussian:5", 1, (60, 20), {"K2": 1}),  # W/4 < 8
        ("grayscale,contrast:4.3", 3, (40, 128), {"T1-pw": 1}),  # LUT step: a plain gather
        ("box:1", 1, (64, 128), {"K2": 1}),  # halo 0 < 1
    ],
)
def test_pipeline_packed_falls_back(monkeypatch, spec, ch, hw, launches):
    """Groups T1 does not take go to the K1/K2 runner, untouched; a halo-0
    box, which T1 refuses and K2 runs, among them. The JAX test's fourth
    case, `rot:90,gaussian:5`, has a test of its own below."""
    seen = {}
    for key, owner, name in (("T1-pw", pk, "run_group_packed_words"),
                             ("K2", ck, "stream_stencil"), ("K1", ck, "pointwise_group")):
        real = getattr(owner, name)

        def spy(*a, key=key, real=real, **kw):
            seen[key] = seen.get(key, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(owner, name, spy)
    img = synthetic_image(*hw, channels=ch, seed=45)
    np.testing.assert_array_equal(_packed(spec, img), _golden(spec, img))
    assert seen == launches


def test_pipeline_packed_geometric_fallback_equals_jax_interpret(monkeypatch):
    """tests/test_packed.py's fallback case `rot:90,gaussian:5`: the quarter
    turn goes to the u8 group runner (``ck.run_group``), and the stencil
    group after it, on the turned plane's words, to T1. Equal to the JAX
    ``pipeline_packed`` in interpret mode and to golden."""
    spec, img = "rot:90,gaussian:5", synthetic_image(64, 128, channels=1, seed=45)
    want = np.asarray(jax_pk.pipeline_packed(JaxPipeline.parse(spec).ops, jnp.asarray(img),
                                             interpret=True))
    seen = []
    real = pk.run_group_packed_words

    def spy(pw, st, words, height, width, **kw):
        seen.append((st.name, height, width, [w.is_contiguous() for w in words]))
        return real(pw, st, words, height, width, **kw)

    monkeypatch.setattr(pk, "run_group_packed_words", spy)
    got = _packed(spec, img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _golden(spec, img))
    assert seen == [("gaussian5", 128, 64, [True])]


def test_pipeline_packed_keeps_words_between_groups(monkeypatch):
    """Consecutive eligible groups stay in word form: the second group gets
    the first one's words."""
    calls = []
    real = pk.run_group_packed_words

    def spy(pw, st, words, *a, **kw):
        calls.append([w.data_ptr() for w in words])
        out = real(pw, st, words, *a, **kw)
        calls.append([w.data_ptr() for w in out])
        return out

    monkeypatch.setattr(pk, "run_group_packed_words", spy)
    img = synthetic_image(40, 128, channels=3, seed=3)
    spec = "grayscale,gaussian:5,invert,sobel"
    np.testing.assert_array_equal(_packed(spec, img), _golden(spec, img))
    assert len(calls) == 4 and calls[1] == calls[2]


def test_direct_multichannel_group():
    """A 3 -> 3 chain into a separable stencil, planes in and out."""
    img = synthetic_image(66, 320, channels=3, seed=51)
    planes = [torch.from_numpy(np.ascontiguousarray(img[..., c])) for c in range(3)]
    for pw, st in ck.group_ops(make_pipeline_ops("sepia,gaussian:3")):
        assert pk.packed_supported(pw, st, 320)
        planes = pk.run_group_packed(pw, st, planes)
    got = torch.stack(planes, -1).numpy()
    np.testing.assert_array_equal(got, _golden("sepia,gaussian:3", img))


# --------------------------------------------------------------------------
# The plain versions against the JAX kernels in interpret mode
# --------------------------------------------------------------------------

KINDS = [
    ("gaussian:5", 1),  # separable
    ("erode:3", 1),  # min/max
    ("laplacian:8", 1),  # non-separable correlation
    ("sobel", 1),  # magnitude
    ("median:5", 1),  # median
    ("emboss:3", 1),  # interior
    ("grayscale,contrast:3.5", 3),  # pointwise only
    ("grayscale,contrast:3.5,emboss:3", 3),  # 3 -> 1 chain into interior
]


@pytest.mark.parametrize("spec,ch", KINDS)
def test_words_equal_jax_interpret(spec, ch):
    img = synthetic_image(40, 128, channels=ch, seed=7)
    img[::7, ::3] = 255
    jplanes = [jnp.asarray(img[..., c] if ch > 1 else img) for c in range(ch)]
    jwords = [jax_pk.pack_words(p) for p in jplanes]
    words = [pk.pack_words(torch.from_numpy(np.array(p))) for p in jplanes]
    (jpw, jst), = jax_group_ops(JaxPipeline.parse(spec).ops)
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    want = jax_pk.run_group_packed_words(jpw, jst, jwords, 40, 128, interpret=True, block_h=16)
    got = pk.run_group_packed_words(pw, st, words, 40, 128, block_h=16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:5"])
def test_ghost_two_tile_stitch_equals_jax(spec):
    """tests/test_packed.py's stitch: two row tiles, each with its
    neighbour's rows as ghost strips and the reflect101 extension at the
    image's edges; the stitched tiles equal the golden image, and each
    tile's words equal the JAX ghost mode's in interpret mode."""
    h, w = 96, 256
    ref = synthetic_image(h, w, channels=1, seed=77)
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    (jpw, jst), = jax_group_ops(JaxPipeline.parse(spec).ops)
    halo, half = st.halo, h // 2
    tiles = [ref[:half], ref[half:]]
    ghosts = [(ref[1: 1 + halo][::-1], ref[half: half + halo]),
              (ref[half - halo: half], ref[h - 1 - halo: h - 1][::-1])]
    outs = []
    for k, (tile, (top, bot)) in enumerate(zip(tiles, ghosts)):
        t8, top8, bot8 = (torch.from_numpy(a.copy()) for a in (tile, top, bot))
        got = pk.run_group_packed(pw, st, [t8], ghosts=([top8], [bot8]), y0=k * half,
                                  image_h=h)[0]
        want = jax_pk.run_group_packed(
            jpw, jst, [jnp.asarray(tile)], ghosts=([jnp.asarray(top)], [jnp.asarray(bot)]),
            y0=jnp.int32(k * half), image_h=h, interpret=True)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        outs.append(got.numpy())
    np.testing.assert_array_equal(np.concatenate(outs), _golden(spec, ref))


# --------------------------------------------------------------------------
# Wrapper checks
# --------------------------------------------------------------------------


def _group(spec):
    return ck.group_ops(make_pipeline_ops(spec))[0]


def test_wrapper_refusals():
    words = [pk.pack_words(torch.from_numpy(synthetic_image(40, 128, channels=1, seed=1)))]
    pw, st = _group("gaussian:5")
    with pytest.raises(ValueError, match="packed_supported"):
        pk.run_group_packed_words(*_group("box:9"), words, 40, 128)
    with pytest.raises(ValueError, match="packed_supported"):
        pk.run_group_packed_words(*_group("gaussian:5"), [w[:, :6] for w in words], 40, 24)
    with pytest.raises(ValueError, match="1 or 3 word planes"):
        pk.run_group_packed_words(pw, st, words * 2, 40, 128)
    with pytest.raises(ValueError, match="int32 word planes"):
        pk.run_group_packed_words(pw, st, words, 41, 128)
    with pytest.raises(ValueError, match="too small for halo"):
        pk.run_group_packed_words(pw, st, [w[:2] for w in words], 2, 128)
    with pytest.raises(ValueError, match=">= 1"):
        pk.run_group_packed_words(pw, st, words, 40, 128, block_h=-1)
    # block_h sets nothing in the chunked kernel: a block height whose tile
    # once needed more shared memory than a block has now runs, and gives
    # the default's bytes
    big = pk.run_group_packed_words(*_group("sepia,gaussian:7"), words * 3, 40, 128, block_h=400)
    default = pk.run_group_packed_words(*_group("sepia,gaussian:7"), words * 3, 40, 128)
    assert len(big) == 3 and all(torch.equal(a, b) for a, b in zip(big, default))
    with pytest.raises(ValueError, match="expects 3 channels"):
        pk.run_group_packed_words(*_group("grayscale,gaussian:5"), words, 40, 128)
    strip = [w[:2] for w in words]
    with pytest.raises(ValueError, match="ghost mode needs a stencil"):
        pk.run_group_packed_words(*_group("invert"), words, 40, 128, ghosts=(strip, strip))
    with pytest.raises(ValueError, match="y0"):
        pk.run_group_packed_words(pw, st, words, 40, 128, ghosts=(strip, strip))
    with pytest.raises(ValueError, match="ghost strips"):
        pk.run_group_packed_words(pw, st, words, 40, 128, ghosts=(words, strip), y0=0,
                                  image_h=80)
    with pytest.raises(ValueError, match="outside an image"):
        pk.run_group_packed_words(pw, st, words, 40, 128, ghosts=(strip, strip), y0=50,
                                  image_h=80)


def test_wrappers_count_no_launch_on_cpu():
    ck.reset_launch_counts()
    img = synthetic_image(40, 128, channels=3, seed=2)
    pk.pipeline_packed(make_pipeline_ops("grayscale,contrast:3.5,emboss:3"), torch.from_numpy(img))
    assert {"T1-pw", "T1", "T1g"} <= set(ck.launch_counts())
    assert not any(ck.launch_counts().values())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", PACKED_SPECS)
def test_t1_matches_plain_on_card(cuda_device, spec):
    img = torch.from_numpy(synthetic_image(97, 384, channels=_channels(spec), seed=41))
    ck.reset_launch_counts()
    for block_h in (None, 32, 5):
        got = pk.pipeline_packed(make_pipeline_ops(spec), img.to(cuda_device), block_h=block_h)
        assert torch.equal(got.cpu(), pk.pipeline_packed(make_pipeline_ops(spec), img))
    assert ck.TOOL_LAUNCHES["T1"] + ck.TOOL_LAUNCHES["T1-pw"] >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:5"])
def test_t1g_matches_plain_on_card(cuda_device, spec):
    ref = torch.from_numpy(synthetic_image(96, 256, channels=1, seed=77))
    pw, st = _group(spec)
    h = st.halo
    tile, top, bot = ref[40:80], ref[40 - h: 40], ref[80: 80 + h]
    want = pk.run_group_packed(pw, st, [tile], ghosts=([top], [bot]), y0=40, image_h=96)[0]
    ck.reset_launch_counts()
    got = pk.run_group_packed(pw, st, [tile.to(cuda_device)],
                              ghosts=([top.to(cuda_device)], [bot.to(cuda_device)]), y0=40,
                              image_h=96)[0]
    assert torch.equal(got.cpu(), want) and ck.TOOL_LAUNCHES["T1g"] == 1
