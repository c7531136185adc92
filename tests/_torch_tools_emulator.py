"""Numpy replays of the tools kernels' indexing (ops/csrc/copy_probe.cu,
swar_proto.cu and packed_run.cuh), block by block and thread by thread in
vector form: the tests hold them against the plain versions, so that the
kernels' index arithmetic is checked on the CPU, where no CUDA compiler
runs.

* ``byte_perm``: CUDA's ``__byte_perm(x, y, s)``; ``transpose4x4`` with the
  selectors read from copy_probe.cu.
* ``emulate_bitcast_store`` / ``emulate_bitcast_load``: the bitcast
  kernels' grids (four columns per thread, ragged last block).
* ``emulate_swar_proto``: T3's blocks: the (bh + 4) x (TILE_W + 4) window
  with its zero fill past the array, the row pass, the column pass and the
  predicated stores. Every output word must be written exactly once.
* ``emulate_planar``: the planar pointwise body of T2 and T1-pw
  (packed_run.cuh): the split of a launch (``pk.planar_split``) at made-up
  addresses, the head and tail one word a thread, each body run's input
  read as the kernel reads it (one uint4, or the two aligned uint4 around
  it and a select by the plane's shift), the chain on sixteen pixels, one
  uint4 store per output plane.
"""

import re

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

THREADS = 256


def byte_perm(x, y, s: int):
    """``__byte_perm``: byte n of the result is byte (s >> 4n) & 7 of the
    eight bytes of y:x (x the low four)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def source_selectors() -> list[int]:
    """The __byte_perm selectors of transpose4x4 in copy_probe.cu, in order."""
    src = (kr.CSRC_DIR / "copy_probe.cu").read_text()
    body = src[src.index("transpose4x4(const"):]
    body = body[: body.index("\n}\n")]
    return [int(v, 16) for v in re.findall(r"__byte_perm\([^;]*?(0x[0-9A-Fa-f]+)\)", body)]


def transpose4x4(a):
    """copy_probe.cu's transpose4x4 on arrays of words, with its selectors."""
    s = source_selectors()
    assert len(s) == 8, s
    t01, t23 = byte_perm(a[0], a[1], s[0]), byte_perm(a[2], a[3], s[1])
    u01, u23 = byte_perm(a[0], a[1], s[2]), byte_perm(a[2], a[3], s[3])
    return [byte_perm(t01, t23, s[4]), byte_perm(t01, t23, s[5]),
            byte_perm(u01, u23, s[6]), byte_perm(u01, u23, s[7])]


def _rows_of_block(by: int, rows_per_block: int, n_rows: int) -> range:
    return range(by * rows_per_block, min((by + 1) * rows_per_block, n_rows))


def emulate_bitcast_store(x: np.ndarray, block_h: int) -> np.ndarray:
    """bitcast_store_kernel over a (H, W) u8 plane: block (bx, by) covers
    quads bx*256 .. and u8 rows by*block_h .., word rows by*block_h/4 ..;
    thread q loads four u32 (columns 4q..4q+3 of rows 4i..4i+3)."""
    h, w = x.shape
    quads, hw = w // 4, h // 4
    rows32 = np.ascontiguousarray(x).view(np.uint32)  # (H, quads)
    out = np.full((hw, w), 0xDEADBEEF, np.uint32)
    written = np.zeros((hw, quads), np.int32)
    for by in range(-(-h // block_h)):
        for bx in range(-(-quads // THREADS)):
            q = np.arange(bx * THREADS, min((bx + 1) * THREADS, quads))
            for i in _rows_of_block(by, block_h // 4, hw):
                b = transpose4x4([rows32[4 * i + k, q] for k in range(4)])
                for j in range(4):
                    out[i, 4 * q + j] = b[j]
                written[i, q] += 1
    assert (written == 1).all(), "a word written other than once"
    return out.view(np.int32)


def emulate_bitcast_load(words: np.ndarray, block_h: int) -> np.ndarray:
    """bitcast_load_kernel over (Hw, W) words: block_h word rows per block,
    thread q reads words 4q..4q+3 of row i, stores four u32 of u8 rows
    4i..4i+3."""
    hw, w = words.shape
    quads = w // 4
    vec = np.ascontiguousarray(words).view(np.uint32).reshape(hw, quads, 4)
    out = np.zeros((4 * hw, quads), np.uint32)
    written = np.zeros((4 * hw, quads), np.int32)
    for by in range(-(-hw // block_h)):
        for bx in range(-(-quads // THREADS)):
            q = np.arange(bx * THREADS, min((bx + 1) * THREADS, quads))
            for i in _rows_of_block(by, block_h, hw):
                b = transpose4x4([vec[i, q, k] for k in range(4)])
                for k in range(4):
                    out[4 * i + k, q] = b[k]
                    written[4 * i + k, q] += 1
    assert (written == 1).all(), "a word written other than once"
    return out.view(np.uint8).reshape(4 * hw, w)


def emulate_swar_proto(ext: np.ndarray, bh: int) -> np.ndarray:
    """swar_proto_kernel over (H + 4, Ws + 4) ext words, block by block."""
    ext = np.ascontiguousarray(ext).view(np.uint32)
    hp, wsp = ext.shape
    h, ws = hp - 4, wsp - 4
    tw, ew, eh = sp.TILE_W, sp.TILE_W + 4, bh + 4
    m = np.uint32(sp.M_LO)
    taps = [np.uint32(t) for t in sp.TAPS]
    out = np.full((h, ws), 0xDEADBEEF, np.uint32)
    written = np.zeros((h, ws), np.int32)
    gx_blocks, gy_blocks = sp.grid(h, ws, bh)
    for by in range(gy_blocks):
        for bx in range(gx_blocks):
            x0, y0 = bx * tw, by * bh
            gy = y0 + np.arange(eh)[:, None]
            gx = x0 + np.arange(ew)[None, :]
            inside = (gy < hp) & (gx < wsp)
            win = np.where(inside, ext[np.minimum(gy, hp - 1), np.minimum(gx, wsp - 1)],
                           np.uint32(0))
            fields = []
            for shift in (0, 8):
                f = (win >> np.uint32(shift)) & m
                fields.append(sum(taps[t] * f[:, t:t + tw] for t in range(5)))
            qs = []
            for row in fields:
                s = sum(taps[t] * row[t:t + bh] for t in range(5))
                qs.append(((s + np.uint32(0x007F007F) + ((s >> np.uint32(8)) &
                                                          np.uint32(0x00010001)))
                           >> np.uint32(8)) & m)
            word = qs[0] | (qs[1] << np.uint32(8))
            r = y0 + np.arange(bh)[:, None]
            c = x0 + np.arange(tw)[None, :]
            keep = (r < h) & (c < ws)
            rr, cc = np.nonzero(keep)
            out[y0 + rr, x0 + cc] = word[rr, cc]
            written[y0 + rr, x0 + cc] += 1
    assert (written == 1).all(), "an output word written other than once"
    return out.view(np.int32)


def emulate_planar(pointwise, words, *, bases=None, out_base: int = 0) -> list[np.ndarray]:
    """What one launch of the planar body writes for the chain `pointwise`
    over the int32 word planes `words` (numpy, one shape): input plane c at
    bases[c] words past a 16-byte boundary, the outputs at `out_base` words
    past one. Returns the flat output planes (int32). Bytes outside a plane
    read as 0xA5."""
    n_in = len(words)
    n = words[0].size
    bases = bases or [0] * n_in
    c_out = ck.pointwise_program(list(pointwise), n_in)[1]
    starts = [(1 << 20) * (c + 1) + 4 * b for c, b in enumerate(bases)]
    out_addr = (1 << 30) + 4 * out_base
    head, runs, tail, shifts = pk.planar_split(starts, out_addr, n)
    assert head + pk.RUN_WORDS * runs + tail == n and head < pk.RUN_WORDS and tail < pk.RUN_WORDS
    # each plane's bytes with 16 bytes of 0xA5 on either side
    pad = [np.concatenate([np.full(16, 0xA5, np.uint8),
                           np.ascontiguousarray(w).reshape(-1).view(np.uint8),
                           np.full(16, 0xA5, np.uint8)]) for w in words]

    def read(c: int, addr: int, nbytes: int) -> np.ndarray:
        off = addr - starts[c] + 16
        assert 0 <= off and off + nbytes <= len(pad[c]), "a read past the padding"
        return pad[c][off:off + nbytes]

    def chain(pix: np.ndarray) -> np.ndarray:
        """(m, n_in) u8 pixels -> (m, c_out)."""
        t = torch.from_numpy(pix if n_in == 3 else pix[:, 0])[None]
        res = ck.pointwise_group_plain(list(pointwise), t).numpy()[0] if pointwise else t.numpy()[0]
        return res.reshape(len(pix), c_out)

    out = np.full((c_out, 4 * n), 0x3C, dtype=np.uint8)
    written = np.zeros((c_out, n), dtype=np.int64)
    singles = list(range(head)) + list(range(head + pk.RUN_WORDS * runs, n))
    for p in singles:
        pix = np.stack([read(c, starts[c] + 4 * p, 4) for c in range(n_in)], axis=-1)
        out[:, 4 * p:4 * p + 4] = chain(pix).T
        written[:, p] += 1
    for t in range(runs):
        p0 = head + pk.RUN_WORDS * t
        assert (out_addr + 4 * p0) % 16 == 0
        cols = []
        for c in range(n_in):
            a = starts[c] + 4 * p0
            s = shifts[c]
            assert a % 16 == 4 * s
            if s == 0:
                cols.append(read(c, a, 16))
            else:
                x = read(c, a - 4 * s, 32)  # two aligned uint4
                cols.append(x[4 * s:4 * s + 16])
        pix = np.stack(cols, axis=-1)
        out[:, 4 * p0:4 * p0 + 16] = chain(pix).T
        written[:, p0:p0 + pk.RUN_WORDS] += 1
    assert (written == 1).all(), "every output word written exactly once"
    return [np.ascontiguousarray(o).view(np.int32) for o in out]
