"""T3, the port's quarter-strip SWAR prototype (``tools/swar_proto.py``,
``ops/csrc/swar_proto.cu``), on the CPU: the plain version and the pack /
unpack copies against the JAX tool's ``build_fns()`` (``swar_xla``,
``make_swar_pallas(interpret=True)``, ``pack_quarters``), loaded as
``tests/test_swar_proto.py`` loads them, on that file's cases; a numpy
replay of the kernel thread by thread (``_torch_tools_emulator.py``: the
run walk with its column cascades, the granule path with its cp.async ring,
lane 31's copy and the shuffle, the 4-byte path with two rows in flight,
the predicated stores over garbage) against the plain version and the
golden gaussian:5,
at widths that are no multiple of 4, on ext words off a 16-byte boundary,
on strips wider than the row, one row high, on runs cut short, and at 8K
through the launch-shape picker; the picker itself; the gate and the
timing cases through the entry point.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tools_emulator import emulate_swar_proto, swar_proto_source

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.tools import common
from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module")
def jax_swar():
    spec = importlib.util.spec_from_file_location(
        "swar_proto", os.path.join(_TOOLS, "swar_proto.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pack, unpack, sxla, mk_pallas = mod.build_fns()
    return mod, pack, unpack, sxla, mk_pallas


def _plane(h, w, seed):
    return synthetic_image(h, w, channels=1, seed=seed)


def _golden(img):
    return Pipeline.parse("gaussian:5")(torch.from_numpy(img)).numpy()


def _xpad(img):
    return np.pad(img, sp.H_, mode="reflect")


@pytest.mark.parametrize("hw_seed", [(48, 64, 1), (37, 128, 2), (130, 256, 3)])
def test_plain_and_packing_match_jax_swar_xla(jax_swar, hw_seed):
    mod, pack, unpack, sxla, _ = jax_swar
    h, w, seed = hw_seed
    img = _plane(h, w, seed)
    xpad = _xpad(img)
    ext = sp.pack_quarters(torch.from_numpy(xpad))
    jext = pack(jnp.asarray(xpad))
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jext).view(np.int32))
    np.testing.assert_array_equal(sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img))), ext)
    words = sp.swar_words_plain(ext)
    jwords = jax.jit(sxla)(jext)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords).view(np.int32))
    np.testing.assert_array_equal(sp.unpack_quarters(words).numpy(), np.asarray(unpack(jwords)))
    np.testing.assert_array_equal(sp.unpack_quarters(words).numpy(), _golden(img))
    assert (mod.TAPS, mod.H_) == (sp.TAPS, sp.H_)


@pytest.mark.parametrize("h_bh", [(48, 16), (37, 16), (50, 24), (64, 8)])
def test_t3_matches_jax_carry_kernel(jax_swar, h_bh):
    """The JAX streaming kernel in interpret mode, cropped to H rows as its
    caller crops it; T3 writes exactly H rows."""
    _, pack, unpack, _, mk_pallas = jax_swar
    h, bh = h_bh
    img = _plane(h, 64, seed=9)
    xpad = _xpad(img)
    jext = pack(jnp.asarray(xpad))
    want = np.asarray(mk_pallas(jext.shape, bh, interpret=True)(jext))[:h].view(np.int32)
    got = sp.swar_proto(sp.pack_quarters(torch.from_numpy(xpad)), bh)
    assert got.shape == (h, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sp.gaussian5(torch.from_numpy(img), bh).numpy(), _golden(img))


@pytest.mark.parametrize("shape,bh", [((48, 64), 16), ((37, 128), 16), ((50, 64), 24),
                                      ((64, 64), 8), ((130, 256), 120), ((37, 520), 5),
                                      ((8, 1040), 240)])
def test_kernel_blocks_replayed_against_plain(shape, bh):
    """The replay on both paths (granules, and 4-byte words as for ext off
    a 16-byte boundary); `bh` goes to the wrapper and sets nothing."""
    img = torch.from_numpy(_plane(*shape, seed=11))
    ext = sp.pack_quarters(sp.reflect_pad(img))
    want = sp.swar_words_plain(ext).numpy()
    for ext_byte in (0, 4):
        np.testing.assert_array_equal(emulate_swar_proto(ext.numpy(), ext_byte=ext_byte), want)
    np.testing.assert_array_equal(sp.swar_proto(ext, bh).numpy(), want)


@pytest.mark.parametrize("kind", ["zeros", "full", "board"])
def test_extreme_planes(kind):
    yy, xx = np.mgrid[0:37, 0:128]
    img = {"zeros": np.zeros((37, 128)), "full": np.full((37, 128), 255),
           "board": (yy + xx) % 2 * 255}[kind].astype(np.uint8)
    ext = sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img)))
    for ext_byte in (0, 4):
        np.testing.assert_array_equal(emulate_swar_proto(ext.numpy(), ext_byte=ext_byte),
                                      sp.swar_words_plain(ext).numpy())
    np.testing.assert_array_equal(sp.gaussian5(torch.from_numpy(img), 16).numpy(), _golden(img))


def _offset_copy(ext: torch.Tensor, words: int) -> torch.Tensor:
    """`ext`'s words in a contiguous tensor that starts `words` int32 into a
    larger one: a row slice of a bigger word array, off a 16-byte boundary."""
    big = torch.zeros(ext.numel() + 8, dtype=torch.int32)
    view = big[words:words + ext.numel()].view(ext.shape)
    view.copy_(ext)
    assert view.is_contiguous() and view.data_ptr() % 16 == (4 * words + big.data_ptr()) % 16
    return view


# (H, W, ext off a 16-byte boundary): Ws % 4 != 0 (W 132 -> Ws 33, W 4 ->
# Ws 1, W 516 -> Ws 129); ext one and three words in; Ws under one strip;
# H = 1; H under one run; H not a multiple of the run (37 = 16 + 16 + 5;
# 50); a row of two warps whose second is partly past Ws (W 1040 -> Ws 260)
NEW_SHAPES = [(48, 132, 0), (37, 132, 0), (1, 4, 0), (50, 516, 0), (48, 64, 1), (37, 128, 3),
              (50, 132, 1), (16, 64, 0), (1, 64, 0), (1, 132, 0), (5, 128, 0), (15, 256, 1),
              (37, 64, 0), (50, 1040, 0), (17, 520, 0)]


@pytest.mark.parametrize("h,w,off", NEW_SHAPES)
def test_new_design_replayed_on_odd_shapes(h, w, off):
    """The replay at the shapes the granule design makes new: every one
    equal to the plain version and, unpacked, to the golden gaussian:5; the
    wrapper on the CPU (plain version) takes the offset ext as it is."""
    img = _plane(h, w, seed=h + w)
    ext = sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img)))
    if off:
        ext = _offset_copy(ext, off)
    ext_byte = ext.data_ptr() % 16
    assert (ext_byte != 0) == (off != 0)
    strip_words, run_h = sp.launch_shape(h, ext.shape[1] - 4)
    assert run_h <= max(h, sp.MIN_RUN_H)
    got = emulate_swar_proto(ext.numpy(), ext_byte=ext_byte)
    want = sp.swar_words_plain(ext).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sp.unpack_quarters(torch.from_numpy(got)).numpy(), _golden(img))
    np.testing.assert_array_equal(sp.swar_proto(ext, 240).numpy(), want)


def test_new_design_replayed_at_8k_through_the_picker():
    """The 8K plane: 512-word strips (the fourth with three live warps and
    one that returns), runs of 21 rows, the last one 15."""
    img = _plane(4320, 7680, seed=5)
    ext = sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img)))
    assert sp.launch_shape(4320, 1920) == (512, 21) and 4320 % 21 == 15
    got = emulate_swar_proto(ext.numpy())
    np.testing.assert_array_equal(got, sp.swar_words_plain(ext).numpy())
    np.testing.assert_array_equal(sp.unpack_quarters(torch.from_numpy(got)).numpy(), _golden(img))


@pytest.mark.parametrize("shape", [(8, 33), (37, 64), (1, 1), (200, 200)])
def test_replay_at_other_launch_shapes(shape):
    """Strips and runs the picker does not choose here: every strip width
    the kernel takes, runs of 1, 3 and 64 rows."""
    h, ws = shape
    img = _plane(h, 4 * ws, seed=ws)
    ext = sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img))).numpy()
    want = sp.swar_words_plain(torch.from_numpy(ext)).numpy()
    for strip_words in (128, 256, 512):
        for run_h in (1, 3, 64):
            for ext_byte in (0, 4):
                np.testing.assert_array_equal(
                    emulate_swar_proto(ext, ext_byte=ext_byte, shape=(strip_words, run_h)), want)


def test_geometry():
    assert sp.launch_shape(4320, 1920) == (512, 21)
    assert sp.grid(4320, 1920) == (4, 206)
    assert sp.launch_shape(37, 33) == (128, 16) and sp.grid(37, 33) == (1, 3)
    assert sp.launch_shape(1, 1) == (128, 1) and sp.launch_shape(37, 129) == (256, 16)
    assert sp.grid(1080, 7680) == (15, 52)
    for h in (1, 2, 15, 16, 17, 37, 1080, 4320, 70000, 200000):
        for ws in (1, 4, 33, 128, 129, 480, 1920, 4000):
            strip_words, run_h = sp.launch_shape(h, ws)
            strips, runs = sp.grid(h, ws)
            assert strip_words % 128 == 0 and strip_words <= 4 * sp.MAX_THREADS
            assert strips * strip_words >= ws > (strips - 1) * strip_words
            assert 1 <= run_h <= h and runs <= 65535 and (runs - 1) * run_h < h <= runs * run_h
            assert run_h >= min(h, sp.MIN_RUN_H)
    assert sp.granule_path(0, 0, 1920) and not sp.granule_path(4, 0, 1920)
    assert not sp.granule_path(0, 0, 33) and not sp.granule_path(0, 8, 1920)
    src = swar_proto_source()
    assert f"#define SP_MAX_THREADS {sp.MAX_THREADS}" in src
    # one static ring of granules, the same whatever bh is
    assert "extern __shared__" not in src
    assert "__shared__ uint4 ring[SP_DEPTH][SP_MAX_THREADS + SP_MAX_THREADS / 32];" in src
    ext = torch.from_numpy(sp.pack_quarters(sp.reflect_pad(torch.from_numpy(
        _plane(8, 32, seed=8)))).numpy())
    np.testing.assert_array_equal(sp.swar_proto(ext, 600), sp.swar_words_plain(ext))
    with pytest.raises(ValueError, match="block height"):
        sp.swar_proto(ext, 0)
    with pytest.raises(ValueError, match="int32"):
        sp.swar_proto(ext.to(torch.int64), 8)
    with pytest.raises(ValueError, match="no output"):
        sp.swar_proto(torch.zeros((4, 12), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        sp.run_proto(quick=True, height=8, width=30, device=torch.device("cpu"))


def test_gate_and_cases_through_the_entry_point(monkeypatch, capsys):
    monkeypatch.setattr(common, "time_ms", lambda fn, device: (fn(), (0.25, "host"))[1])
    ck.reset_launch_counts()
    assert sp.main(["--quick", "--height", "240", "--width", "256", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bit-exactness gate" in out
    import json

    best = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{") and "stat" in ln]
    assert {r["case"] for r in best} == {
        "cuda_swar_prepacked_bh120", "cuda_swar_prepacked_bh240", "torch_swar_prepacked",
        "torch_swar_pack_cost", "swar_end_to_end", "gaussian5_8k_cuda", "gaussian5_8k_swar"}
    assert all(r["stat"] == "best_of_1_rounds" and r["mp_s"] == 240 * 256 / 1e6 / 0.25e-3
               for r in best)
    assert not any(ck.launch_counts().values())


def test_rne_identity_on_every_column_sum():
    s = torch.arange(0, 65281, dtype=torch.int64)
    q = (s + 127 + ((s >> 8) & 1)) >> 8
    assert torch.equal(q, torch.round(s.to(torch.float64) / 256).to(torch.int64))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bh,off", [
    ((48, 64), 16, 0), ((37, 64), 16, 0), ((50, 64), 24, 0), ((4320, 7680), 120, 0),
    ((4320, 7680), 480, 0), ((48, 132), 16, 0), ((37, 132), 600, 0), ((1, 4), 1, 0),
    ((48, 64), 16, 1), ((37, 520), 16, 3), ((4320, 7680), 240, 1)])
def test_t3_kernel_matches_plain_on_card(cuda_device, shape, bh, off):
    img = torch.from_numpy(_plane(*shape, seed=3))
    ext = sp.pack_quarters(sp.reflect_pad(img))
    dev = ext.to(cuda_device)
    if off:
        big = torch.zeros(ext.numel() + 8, dtype=torch.int32, device=cuda_device)
        dev = big[off:off + ext.numel()].view(ext.shape)
        dev.copy_(ext)
        assert dev.data_ptr() % 16 == 4 * off
    ck.reset_launch_counts()
    got = sp.swar_proto(dev, bh)
    assert torch.equal(got.cpu(), sp.swar_words_plain(ext)) and ck.TOOL_LAUNCHES["T3"] == 1
    assert torch.equal(sp.unpack_quarters(got).cpu(), torch.from_numpy(_golden(img.numpy())))
    sp.bitexact_gate(cuda_device)
