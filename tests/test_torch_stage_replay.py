"""The fused-stage megakernel's tiling (K4, K4g; fused_stage.cu) and K1's
body (pointwise_run.cuh) on the CPU: the host-side choices the kernels
follow (K4's tile shape, the window's row sources in both modes, the
granules and shifts of every row alignment, the padded plane pitch, the
shared memory at every stage halo, K1's head/body/tail split at every byte
offset), then the numpy replays of ``tests/_torch_stencil_emulator.py``
(``emulate_stage``, ``emulate_pointwise``) held byte for byte against the
plain versions at made-up unaligned addresses: multi-stencil stages,
channel-changing stages, ghost rows on the first, a middle and the last
shard, long stages, narrow, short and ragged images, and K1's 3 -> 1,
1 -> 3, 1 -> 1 and 3 -> 3 chains at every input offset.

Every tolerance is 0: bytes must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_stencil_emulator import emulate_pointwise, emulate_stage
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

POSITIONS = ("first", "middle", "last")


def _img(h, w, channels, seed):
    return synthetic_image(h, w, channels=channels, seed=seed)


def _shape(height, width, c, ops, tile_h=None):
    prog = ck.stage_program(ops, c)
    return ck.fused_stage_tile_shape(height, width, c, prog.c_smem, prog.halo, prog.two_pass,
                                     prog.table_bytes, tile_h)


# --------------------------------------------------------------------------
# K4's launch shape and shared memory
# --------------------------------------------------------------------------


def test_tile_shape_of_the_main_launches():
    ref = make_pipeline_ops("grayscale,contrast:3.5,emboss:3")
    mega = make_pipeline_ops("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6")
    g5 = make_pipeline_ops("gaussian:5")
    quarter = ck.MAX_SMEM_BYTES // ck.FS_BLOCKS_PER_SM
    # 8K frames and 1080-row shards: the tallest tile that leaves room for
    # four blocks an SM: 48 rows for the gray stages, 16 for the RGB
    # gaussian:5 (three planes and its float32 row pass)
    for ops, rows in ((ref, 48), (mega, 48), (g5, 16)):
        for height in (4320, 1080):
            r, c, smem = _shape(height, 7680, 3, ops)
            assert (r, c) == (rows, 128) and smem <= quarter
    assert _shape(4320, 7680, 3, g5, 32)[2] > quarter
    # a deep RGB stage takes the lowest tile, even so over a quarter
    deep = make_pipeline_ops(",".join(["box:3"] * 9))
    assert _shape(4320, 7680, 3, deep)[:2] == (16, 128)
    # narrow images narrow the columns while that adds blocks, then lower
    # the rows while the grid is short of an SM each
    assert _shape(37, 53, 3, g5)[:2] == (16, 32)
    assert _shape(37, 20, 3, g5)[:2] == (16, 128)
    assert _shape(257, 301, 3, ref)[:2] == (16, 32)
    assert _shape(5, 7680, 3, ref)[:2] == (5, 32)
    # an explicit tile height is the block's rows, and its shared memory
    # is what the budget check reads
    assert _shape(4000, 400, 3, g5, 64)[:2] == (64, 128)
    assert _shape(4000, 400, 3, g5, 900)[2] > ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("two_pass", [False, True])
def test_smem_at_every_stage_halo(c, two_pass):
    """At every stage halo 0..16 the default tile fits a block's shared
    memory (its rows halved until it does), with the table of a stage of
    R box:3 stencils beside it; the layout's regions are 16-byte aligned and
    the raw window fits over B and what follows."""
    for halo in range(17):
        table = ck.FS_OP_BYTES * max(halo, 1) + ck.FS_STENCIL_BYTES * max(halo, 1)
        rows, cols, smem = ck.fused_stage_tile_shape(4320, 7680, c, c, halo, two_pass, table)
        assert smem <= ck.MAX_SMEM_BYTES, (halo, rows)
        assert rows in ck.FS_TILE_ROWS or rows < 16
        L = ck.fused_stage_layout(c, c, rows, cols, halo, table, two_pass)
        assert L["total"] == smem
        assert all(L[k] % 16 == 0 for k in ("rows_off", "a_off", "b_off", "f_off"))
        eh, ew = rows + 2 * halo, cols + 2 * halo
        assert L["a_off"] - L["rows_off"] == 16 * eh
        assert L["b_off"] + eh * L["raw_pitch"] <= smem
        assert L["raw_pitch"] >= ew * c + 15
        # the pitch: words align, and the last strip's word reads (at most
        # 5 bytes past the region) stay in the row
        assert L["pitch"] % 4 == 0 and ew + 5 <= L["pitch"] < ew + 9
        if two_pass:
            assert smem >= L["f_off"] + 4 * c * L["plane"]


@settings(max_examples=300, deadline=None)
@given(
    height=st.integers(1, 5000), width=st.integers(2, 9000), c=st.sampled_from([1, 3]),
    spec=st.sampled_from(["gaussian:5,sharpen", "box:1", "median:5,gaussian:7,emboss:3",
                          "grayscale,emboss:3,gray2rgb,sobel", ",".join(["gaussian:7"] * 5),
                          ",".join(["box:3"] * 9), "erode:3,dilate:5"]),
    tile_h=st.one_of(st.none(), st.integers(1, 64)),
)
def test_launch_shape_covers_every_output_once(height, width, c, spec, tile_h):
    """The chosen grid covers every output pixel once, the block's shared
    memory fits or the stage is rejected for it, and every flat loop of the
    block (the granules, the four-pixel groups, each stencil's strips and
    each pointwise run's words) stays under 2^16, the high-multiply
    division's range, with a divisor of at least 2."""
    ops = make_pipeline_ops(spec)
    if spec.startswith("grayscale") and c == 1:
        return
    reason = ck.fused_stage_reject(ops, height, width, c, tile_h)
    if reason is not None:
        assert reason in ("image-too-small", "smem-budget")
        return
    prog = ck.stage_program(ops, c)
    try:
        rows, cols = ck._fs_launch_shape(prog, height, width, tile_h)
    except ValueError as e:
        assert "taller tile" in str(e)
        return
    assert cols in ck.FS_TILE_WIDTHS
    gx, gy = ck.stencil_grid(height, width, rows, cols)
    assert (gx - 1) * cols < width <= gx * cols and (gy - 1) * rows < height <= gy * rows
    R = prog.halo
    L = ck.fused_stage_layout(c, prog.c_smem, rows, cols, R, prog.table_bytes, prog.two_pass)
    assert L["total"] <= ck.MAX_SMEM_BYTES
    eh, ew = rows + 2 * R, cols + 2 * R
    assert 2 <= L["raw_pitch"] // 16 and eh * (L["raw_pitch"] // 16) < 1 << 16
    assert eh * ((ew + 3) // 4) < 1 << 16
    g_rows, g_cols = eh, ew
    for op in ops:
        if op.halo or getattr(op, "reduce", None):
            o_cols = g_cols - 2 * op.halo
            strips = (o_cols + 3) // 4
            assert strips >= 2 and prog.c_smem * g_rows * strips < 1 << 16
            g_rows, g_cols = g_rows - 2 * op.halo, o_cols
    assert (g_rows, g_cols) == (rows, cols)


def test_row_sources_in_both_modes():
    """Full mode: window row r of the tile at output row y0 reads image row
    y0 - R + r, clamped into the image. Ghost mode: the extended tile's
    array row is the global row less (shard row0 - R), so the tile's context
    rows are read where they lie and only rows past the array clamp."""
    H, R = 40, 3
    for y0 in (0, 16, 32):
        rows = [ck.stage_row_source(r, y0 - R, 0, H) for r in range(16 + 2 * R)]
        assert rows == [min(max(y0 - R + r, 0), H - 1) for r in range(16 + 2 * R)]
    # K4g: a 10-row shard at global row 20, extended by R rows each side
    row0, local_h = 20, 10
    in_row0, in_rows = row0 - R, local_h + 2 * R
    for ty0 in (row0, row0 + 5):
        for r in range(5 + 2 * R):
            g = ty0 - R + r
            ar = ck.stage_row_source(r, ty0 - R, in_row0, in_rows)
            if g < in_row0 + in_rows:
                assert ar == g - in_row0  # real neighbour rows, never rewritten
            else:
                assert ar == in_rows - 1  # feeds only outputs past the shard


@pytest.mark.parametrize("c", [1, 3])
def test_granules_and_shifts_at_every_alignment(c):
    """Every row segment, at every start byte, is copied in whole 16-byte
    granules from the aligned address at or below it that end at or past
    its last byte, within the raw window's pitch."""
    for cols in ck.FS_TILE_WIDTHS:
        for halo in (0, 1, 3, 16):
            ew = cols + 2 * halo
            raw_pitch = ck.fused_stage_layout(c, c, 16, cols, halo, 16, False)["raw_pitch"]
            for width_px in (ew, ew - 1, 1):
                seg = width_px * c
                for off in range(32):
                    addr = (1 << 20) + off
                    src, shift, grans = ck.row_granules(addr, seg)
                    assert src % 16 == 0 and src + shift == addr and 0 <= shift < 16
                    assert src + 16 * grans >= addr + seg > src + 16 * (grans - 1)
                    assert 16 * grans <= raw_pitch


@pytest.mark.parametrize("c_in,c_out", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_k1_split_at_every_byte_offset(c_in, c_out):
    """K1's body starts at the first pixel whose output is 16-byte aligned;
    every run's input then starts at one offset past a 16-byte boundary; the
    head and the tail (each under 16 pixels) and the runs cover every pixel
    once."""
    for n in (1, 15, 16, 17, 100, 1023, 4320 * 7680):
        for in_off in range(16):
            for out_off in (0, 1, 5, 12):
                head, runs, tail, shift = ck.pointwise_split(4096 + in_off, 8192 + out_off, n,
                                                             c_in, c_out)
                assert head + 16 * runs + tail == n
                assert 0 <= head < 16 and 0 <= tail < 16 + (16 if runs == 0 else 0)
                if runs:
                    assert (8192 + out_off + head * c_out) % 16 == 0
                    for t in (0, runs - 1):
                        assert (4096 + in_off + (head + 16 * t) * c_in) % 16 == shift
                if out_off == 0:
                    assert head == 0 and shift == in_off


@pytest.mark.parametrize("bits", range(1, 9))
def test_posterize_by_reciprocal_equals_division(bits):
    """The kernels' posterize multiplies by 1 / step (pointwise.cuh): for
    every registry step, a power of two, that equals the division on every
    u8 value in float32; both encoders refuse a step that is not one."""
    op = make_pipeline_ops(f"posterize:{bits}")[0]
    opcode, step, _ = ck.kernel_program(op)
    x = np.arange(256, dtype=np.float32)
    step = np.float32(step)
    np.testing.assert_array_equal(np.floor(x * (np.float32(1) / step)) * step,
                                  np.floor(x / step) * step)
    bad = dataclasses.replace(op, program=(opcode, float(step) * 3.0, 0.0))
    with pytest.raises(ValueError, match="power of two"):
        ck.pointwise_program([bad], 1)
    with pytest.raises(ValueError, match="power of two"):
        ck.stage_program([bad], 1)


# --------------------------------------------------------------------------
# K1's body, replayed
# --------------------------------------------------------------------------

K1_CHAINS = {
    (3, 1): "grayscale,contrast:3.5", (1, 3): "gray2rgb", (1, 1): "quantize:6",
    (3, 3): "sepia,invert,brightness:-20",
}


@pytest.mark.parametrize("c_in,c_out", list(K1_CHAINS))
def test_k1_replay_matches_plain_at_every_offset(c_in, c_out):
    pw = make_pipeline_ops(K1_CHAINS[c_in, c_out])
    img = torch.from_numpy(_img(9, 37, c_in, seed=c_in * 4 + c_out))
    want = ck.pointwise_group_plain(pw, img)
    for base in range(16):
        for out_base in (0, 7):
            got = emulate_pointwise(pw, img, base=base, out_base=out_base)
            assert torch.equal(got, want), (base, out_base)
    # a long chain, and no chain at all
    long_pw = make_pipeline_ops(",".join(["brightness:3", "invert", "solarize:200"] * 7))
    for base in (0, 5):
        assert torch.equal(emulate_pointwise(long_pw, img, base=base),
                           ck.pointwise_group_plain(long_pw, img))


# --------------------------------------------------------------------------
# K4 and K4g, replayed
# --------------------------------------------------------------------------

STAGES = [
    ("gaussian:5,sharpen", 1), ("emboss:3,gaussian:5", 3), ("median:3,sobel,box:3", 1),
    ("grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5", 3),
    ("grayscale,gaussian:3,gray2rgb,sharpen,sepia", 3), ("sepia,median:3,invert,emboss:3", 3),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", 3), ("median:5,erode:3", 1),
    ("emboss:5,emboss:3,emboss101:3", 1), ("box:1,invert,box:1", 3), ("gray2rgb", 1),
    (",".join(["box:3"] * 9), 1), (",".join(["box:1"] * 12), 3),
    ("grayscale," + ",".join(["brightness:1"] * 12) + ",gaussian:5,"
     + ",".join(["brightness:1"] * 12), 3),
]


@pytest.mark.parametrize("spec,channels", STAGES)
def test_k4_replay_matches_plain(spec, channels):
    """Full mode at made-up unaligned addresses, at shapes just above the
    size gates, narrow, short and ragged ones, with ragged last tiles."""
    ops = make_pipeline_ops(spec)
    R, max_op = chain_halo(ops), max(op.halo for op in ops)
    shapes = [(2 * R + 1, 45), (37, 53), (21, max(max_op + 1, 2)), (2 * R + 3, 130)]
    for seed, (h, w) in enumerate(shapes):
        img = _img(h, w, channels, seed=7 * seed + len(spec))
        assert ck.fused_stage_reject(ops, h, w, channels) is None
        want = ck.fused_stage_plain(ops, torch.from_numpy(img)).numpy()
        for base, tile_h in ((3, None), (13, 5)):
            np.testing.assert_array_equal(emulate_stage(ops, img, tile_h, base=base), want,
                                          err_msg=f"{spec} {h}x{w} base={base} tile_h={tile_h}")


@pytest.mark.parametrize("spec,channels", [s for s in STAGES if chain_halo(
    make_pipeline_ops(s[0])) > 0])
def test_k4g_replay_matches_plain(spec, channels):
    """Ghost mode on the first, a middle and the last of three shards,
    whose extended tiles start at unaligned addresses; context rows that lie
    outside the image hold zeros the edge fix must rewrite."""
    ops = make_pipeline_ops(spec)
    H = chain_halo(ops)
    local_h, width = 2 * H + 3, 41
    image_h = 3 * local_h
    img = _img(image_h, width, channels, seed=local_h)
    padded = np.concatenate([np.zeros_like(img[:H]), img, np.zeros_like(img[:H])])
    for k, position in enumerate(POSITIONS):
        y0 = k * local_h
        ext = np.ascontiguousarray(padded[y0:y0 + local_h + 2 * H])
        want = ck.fused_stage_ext_plain(ops, torch.from_numpy(ext), y0=y0, image_h=image_h,
                                        image_w=width).numpy()
        got = emulate_stage(ops, ext, None, y0=y0, image_h=image_h, base=5 + k)
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} shard {position}")
