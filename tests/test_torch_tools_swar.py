"""T3, the port's quarter-strip SWAR prototype (``tools/swar_proto.py``,
``ops/csrc/swar_proto.cu``), on the CPU: the plain version and the pack /
unpack copies against the JAX tool's ``build_fns()`` (``swar_xla``,
``make_swar_pallas(interpret=True)``, ``pack_quarters``), loaded as
``tests/test_swar_proto.py`` loads them, on that file's cases; a numpy
replay of the kernel's blocks (``_torch_tools_emulator.py``: the bh + 4 row
window, the zero fill past the array, the predicated stores) against the
plain version; the gate and the timing cases through the entry point.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tools_emulator import emulate_swar_proto

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
    img = torch.from_numpy(_plane(*shape, seed=11))
    ext = sp.pack_quarters(sp.reflect_pad(img))
    np.testing.assert_array_equal(emulate_swar_proto(ext.numpy(), bh),
                                  sp.swar_words_plain(ext).numpy())


@pytest.mark.parametrize("kind", ["zeros", "full", "board"])
def test_extreme_planes(kind):
    yy, xx = np.mgrid[0:37, 0:128]
    img = {"zeros": np.zeros((37, 128)), "full": np.full((37, 128), 255),
           "board": (yy + xx) % 2 * 255}[kind].astype(np.uint8)
    ext = sp.pack_quarters(sp.reflect_pad(torch.from_numpy(img)))
    np.testing.assert_array_equal(emulate_swar_proto(ext.numpy(), 16),
                                  sp.swar_words_plain(ext).numpy())
    np.testing.assert_array_equal(sp.gaussian5(torch.from_numpy(img), 16).numpy(), _golden(img))


def test_geometry():
    assert sp.smem_bytes(480) == (484 * 36 + 2 * 484 * 32) * 4 <= ck.MAX_SMEM_BYTES
    assert sp.smem_bytes(240) < sp.smem_bytes(480)
    assert sp.grid(4320, 1920, 240) == (60, 18)
    assert sp.grid(37, 33, 16) == (2, 3)
    ext = torch.zeros((12, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        sp.swar_proto(ext, 600)
    with pytest.raises(ValueError, match="shared memory"):
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
@pytest.mark.parametrize("shape,bh", [((48, 64), 16), ((37, 64), 16), ((50, 64), 24),
                                      ((4320, 7680), 120), ((4320, 7680), 480)])
def test_t3_kernel_matches_plain_on_card(cuda_device, shape, bh):
    img = torch.from_numpy(_plane(*shape, seed=3))
    ext = sp.pack_quarters(sp.reflect_pad(img))
    ck.reset_launch_counts()
    got = sp.swar_proto(ext.to(cuda_device), bh)
    assert torch.equal(got.cpu(), sp.swar_words_plain(ext)) and ck.TOOL_LAUNCHES["T3"] == 1
    sp.bitexact_gate(cuda_device)
