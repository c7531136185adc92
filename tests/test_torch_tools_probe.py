"""T4, the port's copy-rate probe (``tools/roofline_probe.py``,
``ops/csrc/copy_probe.cu``), on the CPU:

* the plain versions of the copies are byte copies;
* the bitcast plain versions equal ``pltpu.bitcast`` inside a
  ``pl.pallas_call(interpret=True)`` built with the JAX probe's kernel bodies
  and block specs (the probe's kernels are closures inside its ``main`` and
  cannot be imported) at a small shape with a ragged last block;
* a numpy replay of the bitcast kernels' grids and byte transposes
  (``_torch_tools_emulator.py``, selectors read from the source) equals the
  plain versions;
* the record names map the JAX probe's, and ``gb_s`` / ``mp_s`` are its
  arithmetic.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tools_emulator import byte_perm, emulate_bitcast_load, emulate_bitcast_store
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.tools import common
from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plane(h, w, seed=1):
    return torch.from_numpy(synthetic_image(h, w, channels=1, seed=seed))


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(36, 96), (44, 96), (37, 100), (128, 1920)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.int32])
def test_copies_are_byte_copies(shape, dtype):
    x = _plane(*shape).to(dtype)
    for bh in (1, 16, 64, 512):
        out = rp.copy_probe(x, bh)
        assert out.dtype == dtype and torch.equal(out, x)
        assert out.data_ptr() != x.data_ptr()
    if dtype == torch.uint8 and shape[1] % 16 == 0:
        for bh in (8, 64, 128):
            assert torch.equal(rp.smem_copy(x, bh), x)


def _jax_bitcast_store(x, bh):
    """The probe's bitcast_store_call body and specs (roofline_probe.py:217)."""
    H, W = x.shape

    def kernel(in_ref, out_ref):
        out_ref[:] = pltpu.bitcast(in_ref[:], jnp.uint32)

    return pl.pallas_call(
        kernel, grid=(-(-H // bh),),
        in_specs=[pl.BlockSpec((bh, W), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((bh // 4, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((H // 4, W), jnp.uint32), interpret=True,
    )(jnp.asarray(x))


def _jax_bitcast_load(w, bh):
    """The probe's bitcast_load_call body and specs (roofline_probe.py:232)."""
    Hw, W = w.shape

    def kernel(in_ref, out_ref):
        out_ref[:] = pltpu.bitcast(in_ref[:], jnp.uint8)

    return pl.pallas_call(
        kernel, grid=(-(-Hw // bh),),
        in_specs=[pl.BlockSpec((bh, W), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((4 * bh, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((4 * Hw, W), jnp.uint8), interpret=True,
    )(jnp.asarray(w))


@pytest.mark.parametrize("shape,bh,load_bh", [((40, 128), 16, 4), ((36, 256), 8, 3),
                                               ((44, 128), 12, 5)])
def test_bitcasts_match_pltpu_bitcast(shape, bh, load_bh):
    x = synthetic_image(*shape, channels=1, seed=shape[0])
    want = np.asarray(_jax_bitcast_store(x, bh)).view(np.int32)
    words = rp.bitcast_store(torch.from_numpy(x), bh)
    assert words.dtype == torch.int32 and words.shape == (shape[0] // 4, shape[1])
    np.testing.assert_array_equal(words.numpy(), want)
    back = np.asarray(_jax_bitcast_load(want.view(np.uint32), load_bh))
    np.testing.assert_array_equal(rp.bitcast_load(words, load_bh).numpy(), back)
    np.testing.assert_array_equal(back, x)


def test_bitcast_is_not_a_column_view():
    """Byte k of word (i, j) is row 4i + k, column j: not four neighbouring
    columns, which is what ``view(torch.int32)`` packs."""
    x = torch.arange(8 * 4, dtype=torch.uint8).reshape(8, 4)
    words = rp.bitcast_store_plain(x)
    assert words[0, 1].item() == int.from_bytes(bytes(x[0:4, 1].tolist()), "little")
    assert not torch.equal(words.view(torch.uint8).view(2, 4, 4),
                           x.view(2, 4, 4))


# --------------------------------------------------------------------------
# The kernels' indexing, replayed
# --------------------------------------------------------------------------


def test_byte_perm_emulation():
    assert byte_perm(0x33221100, 0x77665544, 0x3210) == 0x33221100
    assert byte_perm(0x33221100, 0x77665544, 0x7654) == 0x77665544
    assert byte_perm(0x33221100, 0x77665544, 0x5140) == 0x55114400
    assert byte_perm(0x03020100, 0x07060504, 0x5140) == 0x05010400


@pytest.mark.parametrize("shape,bh,load_bh", [((36, 96), 8, 3), ((44, 96), 16, 4),
                                               ((40, 1040 * 4), 16, 3), ((1080, 128), 128, 128)])
def test_bitcast_kernels_replayed(shape, bh, load_bh):
    x = synthetic_image(*shape, channels=1, seed=5)
    words = emulate_bitcast_store(x, bh)
    np.testing.assert_array_equal(words, rp.bitcast_store_plain(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(emulate_bitcast_load(words, load_bh), x)


@pytest.mark.parametrize("fill", [0, 255])
def test_bitcast_replay_on_flat_planes(fill):
    x = np.full((36, 96), fill, np.uint8)
    words = emulate_bitcast_store(x, 8)
    assert (words.view(np.uint32) == (0x01010101 * fill)).all()
    np.testing.assert_array_equal(emulate_bitcast_load(words, 2), x)


# --------------------------------------------------------------------------
# Host-side checks
# --------------------------------------------------------------------------


def test_wrapper_refusals():
    x = _plane(36, 96)
    with pytest.raises(ValueError, match="multiples of 4"):
        rp.bitcast_store(_plane(37, 96), 8)
    with pytest.raises(ValueError, match="multiples of 4"):
        rp.bitcast_store(x, 6)
    with pytest.raises(ValueError, match="multiples of 4"):
        rp.bitcast_load(torch.zeros((9, 10), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        rp.smem_copy(_plane(36, 100), 8)
    with pytest.raises(ValueError, match="2-D"):
        rp.copy_probe(x.to(torch.int64), 8)
    with pytest.raises(ValueError, match=">= 1"):
        rp.copy_probe(x, 0)
    with pytest.raises(ValueError, match="taller block"):
        rp.copy_probe(torch.zeros((70000, 16), dtype=torch.uint8), 1)


def test_wrappers_count_no_launch_on_cpu():
    ck.reset_launch_counts()
    x = _plane(36, 96)
    rp.copy_probe(x, 8), rp.smem_copy(x, 8), rp.bitcast_load(rp.bitcast_store(x, 8), 2)
    assert set(ck.TOOL_LAUNCHES) <= set(ck.launch_counts())
    assert not any(ck.launch_counts().values())


# --------------------------------------------------------------------------
# Records
# --------------------------------------------------------------------------

# the JAX probe's case names, and the port's for each
NAMES = {
    "xla_copy_u8": "torch_copy_u8", "xla_copy_f32": "torch_copy_f32",
    "pallas_copy_u8": "cuda_copy_u8", "pallas_copy_f32": "cuda_copy_f32",
    "pallas_copy_u32_packed": "cuda_copy_u32_packed",
    "pallas_copy_u32_fullelems": "cuda_copy_u32_fullelems",
    "pallas_copy_f32_packedsize": "cuda_copy_f32_packedsize",
    "pallas_lagged_copy_u8": "cuda_smem_copy_u8",
    "xla_pack_bitcast": "torch_pack_bitcast", "xla_unpack_bitcast": "torch_unpack_bitcast",
    "pallas_u8load_u32store_bitcast": "cuda_u8load_u32store_bitcast",
    "pallas_u32load_u8store_bitcast": "cuda_u32load_u8store_bitcast",
    "gaussian5_8k_pallas": "gaussian5_8k_cuda", "gaussian5_8k_packed": "gaussian5_8k_packed",
}


def _probe(monkeypatch, quick, rounds, ms=0.5):
    """The probe on a 64x256 CPU plane with every sample `ms`."""
    monkeypatch.setattr(common, "time_ms", lambda fn, device: (fn(), (ms, "host"))[1])
    records = []
    best = rp.run_probe(quick=quick, rounds=rounds, device=torch.device("cpu"), height=64,
                        width=256, out=records.append)
    return records, best


def test_record_names_map_the_jax_probe():
    with open(os.path.join(REPO, "tools", "roofline_probe.py")) as f:
        src = f.read()
    jax_names = set(re.findall(r'"((?:xla|pallas|gaussian5)_[a-z0-9_]+)"', src))
    assert jax_names == set(NAMES)


@pytest.mark.parametrize("quick,rounds", [(True, None), (False, 2)])
def test_records_and_rates(monkeypatch, quick, rounds):
    records, best = _probe(monkeypatch, quick, rounds)
    n_rounds = rounds or 1
    names = {r["case"] for r in best}
    assert names == set(NAMES.values())
    timed = [r for r in best if not r.get("free_view")]
    assert all(r["stat"] == f"best_of_{n_rounds}_rounds" for r in timed)
    assert all(r["device"] == "cpu" and r["power_limit"] is None for r in records)
    assert all(r["clock"] == "host" for r in records if "ms" in r)
    copies = [r for r in timed if r["case"] == "cuda_copy_u8"]
    assert sorted(r["block_h"] for r in copies) == ([128] if quick else list(rp.BLOCK_HEIGHTS))
    assert len([r for r in records if "round" in r]) == n_rounds * len(timed)
    nbytes = {"torch_copy_u8": 2 * 64 * 256, "torch_copy_f32": 8 * 64 * 256,
              "cuda_copy_u32_packed": 2 * 64 * 256, "cuda_copy_u32_fullelems": 8 * 64 * 256,
              "cuda_copy_f32_packedsize": 2 * 64 * 256, "cuda_smem_copy_u8": 2 * 64 * 256,
              "cuda_u8load_u32store_bitcast": 2 * 64 * 256, "gaussian5_8k_cuda": 2 * 64 * 256,
              "gaussian5_8k_packed": 2 * 64 * 256}
    for r in timed:
        if r["case"] in nbytes:
            assert r["gb_s"] == nbytes[r["case"]] / (0.5 / 1e3) / 1e9
    for case in ("gaussian5_8k_cuda", "gaussian5_8k_packed"):
        g5 = next(r for r in timed if r["case"] == case)
        assert g5["mp_s"] == 64 * 256 / 1e6 / (0.5 / 1e3)
        assert g5["gb_s"] == 2 * 64 * 256 / (0.5 / 1e3) / 1e9
    smem = [r for r in timed if r["case"] == "cuda_smem_copy_u8"]
    assert all(r["stands_for"] == "pallas_lagged_copy_u8" for r in smem)
    views = [r for r in best if r.get("free_view")]
    assert {r["case"] for r in views} == {"torch_pack_bitcast", "torch_unpack_bitcast"}
    assert all("ms" not in r for r in views)


def test_best_is_the_least_sample(monkeypatch):
    samples = iter([3.0, 1.0, 2.0] * 100)
    monkeypatch.setattr(common, "time_ms", lambda fn, device: (next(samples), "host"))
    out = []
    best = common.run_rounds([({"case": "a", "_nbytes": 10}, lambda: None)], 3,
                             torch.device("cpu"), {"device": "cpu"}, out.append)
    assert best[0]["ms"] == 1.0 and best[0]["stat"] == "best_of_3_rounds"
    assert [r["round"] for r in out[:3]] == [1, 2, 3]


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(rp, "H", 32)
    monkeypatch.setattr(rp, "W", 128)
    assert rp.main(["--quick", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert any('"gaussian5_8k_cuda"' in ln and "best_of_1_rounds" in ln for ln in lines)


def test_cuda_device_is_the_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        rp.main(["--quick"])


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(36, 96), (44, 96), (37, 100), (4320, 7680)])
def test_probe_kernels_match_plain_on_card(cuda_device, shape):
    x = _plane(*shape)
    ck.reset_launch_counts()
    for dtype in (torch.uint8, torch.float32, torch.int32):
        xd = x.to(dtype).to(cuda_device)
        assert torch.equal(rp.copy_probe(xd, 64).cpu(), x.to(dtype))
    if shape[1] % 16 == 0:
        assert torch.equal(rp.smem_copy(x.to(cuda_device), 64).cpu(), x)
    if shape[0] % 4 == 0:
        words = rp.bitcast_store(x.to(cuda_device), 128)
        assert torch.equal(words.cpu(), rp.bitcast_store_plain(x))
        assert torch.equal(rp.bitcast_load(words, 128).cpu(), x)
    assert ck.TOOL_LAUNCHES["T4-copy"] == 3
