"""The redesigned K5 (``ops/csrc/mma_stage.cuh``, ``fs_mma_walk`` in
``ops/csrc/fused_stage.cu``) on the CPU: ``tests/_torch_k5_emulator.py``
replays its fragments (B built once per lane, A as word loads from a buffer
whose bytes past the region are garbage, the clamps of a tile's reads into
the region's rows and the pitch) in int64, and the sums are held against
the exact int64 sums, the plain version
(``stage_valid_mxu_plain``) and the JAX package's ``stage_valid_mxu``:
kernel sides 1, 3, 5 and 7 in both forms, magnitude ops, regions that are
no multiple of 16 x 8, buffer pitches as K4 lays them out, and the inputs
where the sums are largest. Then the lanes' stores of a tile.

Every tolerance is 0: the sums are exact integers.
"""

import jax
import numpy as np
import pytest
import torch
from _torch_k5_emulator import b_fragments, emulate_k5_sums, store_lanes

from mpi_cuda_imagemanipulation_tpu.ops import mxu_kernels as jmk
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import mxu_kernels as mk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

# sides 1, 3, 5, 7; magnitude; the boundary filters of the exactness argument
SPECS = ["box:1", "gaussian:3", "sharpen", "emboss:5", "gaussian:5", "unsharp", "gaussian:7",
         "box:7", "sobel", "prewitt", "scharr",
         "filter:65280/512/1/0/0/0/0/0/0:1.0", "filter:127/1/0/0/0/0/0/0/0:1.0",
         "filter:127/-127/1/0/0/0/0/0/0:1.0", "filter:32640/-32640/1/0/0/0/0/0/0:1.0"]
# (rows, cols) of the output region: no multiple of 16 x 8, one tile and less
REGIONS = [(21, 67), (16, 8), (5, 3), (40, 131), (33, 130)]


def _arms(op):
    return ["mxu", "mxu-int8"] if mk.mxu_int8_ok(op) else ["mxu"]


def _exact(x, w2d):
    w = np.asarray(w2d, np.float64).astype(np.int64)
    ks = w.shape[0]
    rows, cols = x.shape[0] - ks + 1, x.shape[1] - ks + 1
    x = x.astype(np.int64)
    return sum(w[d, i] * x[d:d + rows, i:i + cols] for d in range(ks) for i in range(ks))


def _k4_pitch(cols):
    """K4's buffer pitch for a window `cols` wide (fs_layout)."""
    return (cols + 5 + 3) & ~3


def test_specs_cover_sides_forms_and_magnitude():
    ops = [make_op(s) for s in SPECS]
    assert {2 * op.halo + 1 for op in ops} == {1, 3, 5, 7}
    assert any(op.combine == "magnitude" for op in ops)
    assert all(mk.mxu_eligible(op) for op in ops)
    assert {2 * op.halo + 1 for op in ops if mk.mxu_int8_ok(op)} == {1, 3, 5, 7}


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("spec", SPECS)
def test_replay_sums_are_exact(spec, region):
    """A region in a K4-pitched buffer of garbage (and in the probe's
    zero-padded one): every form's sums are the exact ones, a magnitude
    op's two kernels sharing every A fragment."""
    op = make_op(spec)
    h = op.halo
    rows, cols = region[0] + 2 * h, region[1] + 2 * h
    x = synthetic_image(rows, cols, channels=1, seed=rows * cols)
    second = op.kernels[1] if op.combine == "magnitude" else None
    for arm in _arms(op):
        for pitch, garbage in ((_k4_pitch(cols), cols), (None, None)):
            got = emulate_k5_sums(x, op.kernels[0], arm, pitch=pitch, garbage_seed=garbage,
                                  second=second)
            got = got if second is not None else [got]
            for k, acc in zip(op.kernels, got):
                np.testing.assert_array_equal(acc.astype(np.int64), _exact(x, k),
                                              err_msg=f"{spec} {arm} pitch={pitch}")


@pytest.mark.parametrize("spec", ["gaussian:3", "gaussian:5", "gaussian:7", "box:1", "sobel",
                                  "emboss:5", "unsharp", "filter:127/-127/1/0/0/0/0/0/0:1.0"])
def test_replay_matches_plain_and_jax(spec):
    """Combined, scaled and quantized as the plain version finishes them,
    the replayed sums give the plain version's and the JAX package's
    stage_valid_mxu bytes, in both forms, on a region of 37 x 131."""
    op, jop = make_op(spec), jax_registry.make_op(spec)
    h = op.halo
    xe = synthetic_image(37 + 2 * h, 131 + 2 * h, channels=1, seed=7).astype(np.float32)
    for arm in _arms(op):
        accs = [torch.from_numpy(emulate_k5_sums(xe, k, arm, pitch=_k4_pitch(xe.shape[1]),
                                                 garbage_seed=3))
                for k in op.kernels]
        got = mk._combine_scale(op, accs).numpy()
        want = mk.stage_valid_mxu_plain(op, torch.from_numpy(xe), arm=arm).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} {arm}")
        jax_out = np.asarray(jax.jit(lambda x, a=arm: jmk.stage_valid_mxu(jop, x, arm=a))(xe))
        np.testing.assert_array_equal(got, jax_out, err_msg=f"{spec} {arm} jax")


def test_replay_at_the_largest_sums():
    """All 0, all 255, the checkerboards, a row ramp (where the cancelling
    filters' partial sums are largest): exact in both forms, with garbage
    past the region."""
    ramp = np.repeat((np.arange(40) * 37 % 256).astype(np.uint8)[:, None], 70, axis=1)
    board = (np.indices((40, 70)).sum(0) % 2 * 255).astype(np.uint8)
    planes = [np.zeros((40, 70), np.uint8), np.full((40, 70), 255, np.uint8), board,
              255 - board, ramp]
    top = 0
    for spec in SPECS:
        op = make_op(spec)
        for arm in _arms(op):
            for x in planes:
                for k in op.kernels:
                    want = _exact(x, k)
                    got = emulate_k5_sums(x, k, arm, pitch=_k4_pitch(70), garbage_seed=1)
                    np.testing.assert_array_equal(got.astype(np.int64), want)
                    top = max(top, int(np.abs(want).max()))
    assert top == (1 << 24) - 1


def test_b_fragments_are_the_band():
    """Each lane's hoisted B registers hold the band C_d[k, n] = w[d][k - n]
    at its (k, n) positions, zero outside the kernel."""
    w = np.arange(1, 50, dtype=np.int64).reshape(7, 7)
    G, T = np.arange(32) // 4, np.arange(32) % 4
    bf = b_fragments(w, False)
    for d in range(7):
        for lane in range(32):
            for q in range(2):
                for e in range(2):
                    j = 2 * T[lane] + 8 * q + e - G[lane]
                    assert bf[d, q, e, lane] == (w[d, j] if 0 <= j < 7 else 0)
    bi = b_fragments(w, True)
    for p in range(4):
        for lane in range(32):
            for q in range(2):
                for i in range(4):
                    j, d = 4 * T[lane] + i - G[lane], 2 * p + q
                    assert bi[p, q, i, lane] == (w[d, j] if d < 7 and 0 <= j < 7 else 0)


def test_every_output_of_a_tile_is_stored_once():
    """fs_mma_walk's stores cover a 16 x 8 tile exactly once, 16-bit words
    of two outputs at even columns."""
    seen = np.zeros((16, 8), np.int64)
    for lane, r, c, n in store_lanes():
        assert c % n == 0
        seen[r, c:c + n] += 1
    assert (seen == 1).all()


def test_k5_sums_pads_the_plane_to_words():
    """The probe's wrapper hands the kernel rows a multiple of 4 bytes apart
    (its plain version here): any width gives the exact sums."""
    op = make_op("sobel")
    for cols in (67, 68, 70, 71):
        plane = synthetic_image(23, cols, channels=1, seed=cols)
        got = ck.k5_sums(op, torch.from_numpy(plane), "mxu-int8", kernel=1).numpy()
        np.testing.assert_array_equal(got.astype(np.int64), _exact(plane, op.kernels[1]))
        np.testing.assert_array_equal(
            emulate_k5_sums(plane, op.kernels[1], "mxu-int8", garbage_seed=cols), got)
