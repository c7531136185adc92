"""T4's copies after their redesign (ops/csrc/copy_probe.cu) on the CPU: the
host's grids against the source's constants, a replay of each CTA's rows
and columns (every element copied exactly once, within its block_h-row
unit), and the grids' size at the probe's block heights: at least two CTAs
per SM of an H100 (132 SMs) on the 8K plane, at every height.
"""

import re

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp

N_SMS = 132


def _defines():
    src = (kr.CSRC_DIR / "copy_probe.cu").read_text()
    return {m.group(1): m.group(2) for m in re.finditer(r"#define (CP_\w+) (\S+)", src)}


def test_constants_match_the_source():
    d = _defines()
    assert int(d["CP_THREADS"]) == rp.CP_LANES * rp.CP_CTA_ROWS // rp.CP_ROWS_PER_THREAD
    assert int(d["CP_LANES"]) == rp.CP_LANES
    assert int(d["CP_ROWS_PER_THREAD"]) == rp.CP_ROWS_PER_THREAD >= 4
    assert int(d["CP_VEC"]) == rp.CP_VEC
    assert int(d["CP_BULK_CTA_BYTES"]) == rp.CP_BULK_CTA_BYTES
    assert int(d["CP_BULK_CTA_BYTES"]) % int(d["CP_STAGE_BYTES"]) == 0


def _replay_copy(height, row_units, block_h):
    """copy_tiled_kernel's (CTA, thread) -> (row, column) map: how often each
    element is copied, and whether every copy stays inside its unit."""
    gx, gy, per_unit = rp.copy_grid(height, row_units, 1, block_h, aligned=False)
    hits = np.zeros((height, row_units), dtype=np.int64)
    threads = rp.CP_LANES * rp.CP_CTA_ROWS // rp.CP_ROWS_PER_THREAD
    step = threads // rp.CP_LANES
    for bx in range(gx):
        for by in range(gy):
            unit = by // per_unit
            u0 = unit * block_h
            y1 = min(u0 + block_h, height)
            for t in range(threads):
                c = bx * rp.CP_LANES + t % rp.CP_LANES
                if c >= row_units:
                    continue
                y0 = u0 + (by - unit * per_unit) * rp.CP_CTA_ROWS + t // rp.CP_LANES
                for i in range(rp.CP_ROWS_PER_THREAD):
                    y = y0 + step * i
                    if y < y1:
                        assert u0 <= y < u0 + block_h
                        hits[y, c] += 1
    return hits


@pytest.mark.parametrize("height,units", [(36, 6), (44, 6), (37, 100), (97, 33), (130, 480)])
@pytest.mark.parametrize("block_h", [1, 7, 5, 32, 33, 64, 128])
def test_copy_ctas_cover_every_element_once(height, units, block_h):
    assert (_replay_copy(height, units, block_h) == 1).all()


@pytest.mark.parametrize("block_h", rp.BLOCK_HEIGHTS)
@pytest.mark.parametrize("itemsize", [1, 4])
def test_copies_fill_the_card_at_every_block_height(block_h, itemsize):
    """The 8K plane (u8, and f32 or u32 words) gives at least two CTAs per
    SM at every swept block height (the first design gave 68 at 128)."""
    gx, gy, per_unit = rp.copy_grid(rp.H, rp.W, itemsize, block_h)
    assert gx == -(-rp.W * itemsize // 16 // rp.CP_LANES)
    assert per_unit == -(-block_h // rp.CP_CTA_ROWS)
    assert gx * gy >= 2 * N_SMS
    smem_ctas, _ = rp.smem_copy_grid(rp.H, rp.W, block_h)
    assert smem_ctas >= 2 * N_SMS


@pytest.mark.parametrize("height,width", [(36, 96), (44, 96), (4320, 7680), (7, 16)])
@pytest.mark.parametrize("block_h", [1, 5, 64, 128, 512])
def test_smem_copy_ctas_cover_every_byte_once(height, width, block_h):
    """smem_copy_kernel's (CTA, stage) -> byte ranges: contiguous unit
    ranges of whole rows, every byte once, every bulk copy a multiple of 16
    bytes of at most one stage."""
    ctas, per_unit = rp.smem_copy_grid(height, width, block_h)
    total, unit_bytes = height * width, block_h * width
    stage = int(_defines()["CP_STAGE_BYTES"])
    covered = 0
    last = 0
    for b in range(ctas):
        unit = b // per_unit
        u0 = unit * unit_bytes
        b0 = u0 + (b - unit * per_unit) * rp.CP_BULK_CTA_BYTES
        b1 = min(u0 + unit_bytes, b0 + rp.CP_BULK_CTA_BYTES, total)
        if b0 >= b1:
            continue
        assert b0 == last  # CTAs in order tile the plane's bytes
        for off in range(b0, b1, stage):
            n = min(stage, b1 - off)
            assert n % 16 == 0 and off % 16 == 0
            covered += n
        last = b1
    assert covered == total
