"""Numpy replays of the tools kernels' indexing (ops/csrc/copy_probe.cu,
swar_proto.cu and packed_run.cuh), block by block and thread by thread in
vector form: the tests hold them against the plain versions, so that the
kernels' index arithmetic is checked on the CPU, where no CUDA compiler
runs.

* ``byte_perm``: CUDA's ``__byte_perm(x, y, s)``; ``transpose4x4`` with the
  selectors read from copy_probe.cu.
* ``emulate_bitcast_store`` / ``emulate_bitcast_load``: the bitcast
  kernels' grids (four columns per thread, ragged last block).
* ``emulate_swar_proto``: T3's threads: four output words each, a run of
  rows walked with the column window carried as cascades in registers; the
  granule path (a cp.async ring of SP_DEPTH rows, lane 31's second granule,
  the shuffle) and the 4-byte path (two rows in flight in registers); the
  predicated stores over garbage. Every output word must be written exactly
  once.
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


def swar_proto_source() -> str:
    return (kr.CSRC_DIR / "swar_proto.cu").read_text()


def swar_proto_hi_selector() -> int:
    """The __byte_perm selector of swar_proto.cu's sp_hi (the hi field set)."""
    return int(re.search(r"sp_hi\(uint32_t w\) \{ return __byte_perm\(w, 0u, (0x[0-9A-Fa-f]+)\)",
                         swar_proto_source()).group(1), 16)


def swar_proto_depth() -> int:
    """SP_DEPTH in swar_proto.cu: the rows of a thread's granule ring."""
    return int(re.search(r"#define SP_DEPTH (\d+)", swar_proto_source()).group(1))


def emulate_swar_proto(ext: np.ndarray, *, ext_byte: int = 0, out_byte: int = 0,
                       shape=None) -> np.ndarray:
    """swar_proto_kernel over (H + 4, Ws + 4) ext words, thread by thread in
    vector form (every live thread of every run at once, one ext row a
    step): ext `ext_byte` and the output `out_byte` bytes past a 16-byte
    boundary pick the path (``sp.granule_path``); `shape` is the launch's
    (strip_words, run_h), by default ``sp.launch_shape``. Replays the warp
    that returns past the row; on the granule path the ring of SP_DEPTH rows
    in shared memory filled by predicated cp.async (lane 31's second
    granule with its own; none past the run's last row) and the shuffle of
    the next lane's granule; on the 4-byte path the
    eight clamped word loads of rows i + 1 and i + 2, in flight while row i
    computes, clamped to the run's last row; the cascades of
    [1, 1] sums carried in registers; the round and repack on uint32; the
    stores predicated at Ws, one uint4 or four words. Every read must lie in
    ext, every ring slot must hold its row when read and be read before it is
    refilled; the output starts as garbage and every word must be written
    exactly once."""
    ext = np.ascontiguousarray(ext).view(np.uint32)
    hp, pitch = ext.shape
    h, ws = hp - 2 * sp.H_, pitch - 2 * sp.H_
    strip_words, run_h = shape or sp.launch_shape(h, ws)
    threads = strip_words // 4
    assert threads % 32 == 0 and 0 < threads <= sp.MAX_THREADS and run_h >= 1
    vec = sp.granule_path(ext_byte, out_byte, ws)
    assert not vec or pitch % 4 == 0
    ngran = -(-ws // 4)
    strips, runs = -(-ngran // threads), -(-h // run_h)
    assert runs <= ck._MAX_GRID_Y
    g = np.arange(strips * threads)
    g = g[(g & ~31) < ngran]  # a warp wholly past the row returns
    last = (g & 31) == 31
    r0 = np.arange(runs) * run_h
    n_in = np.minimum(run_h, h - r0) + 2 * sp.H_  # ext rows of each run
    m = np.uint32(sp.M_LO)
    hi_sel = swar_proto_hi_selector()
    pitch4 = pitch // 4
    go, gx = np.minimum(g, pitch4 - 1), np.minimum(g + 1, pitch4 - 1)
    cols = np.minimum(4 * g[:, None] + np.arange(8), pitch - 1)

    def load(row):
        """The eight raw words of each run's ext row r0 + row, (runs, T, 8)."""
        rows = r0 + row
        assert (row < n_in).all() and rows.max() < hp
        a = np.zeros((runs, len(g), 8), np.uint32)
        if vec:
            own = 4 * go[:, None] + np.arange(4)
            nxt = 4 * gx[last][:, None] + np.arange(4)
            assert own.max() < pitch and (nxt.max(initial=0) < pitch)
            a[:, :, :4] = ext[rows[:, None, None], own[None]]
            a[:, last, 4:] = ext[rows[:, None, None], nxt[None]]
        else:
            a[:] = ext[rows[:, None, None], cols[None]]
        return a

    def row5(f, k):
        return (f[..., k] + f[..., k + 4]) + np.uint32(4) * (f[..., k + 1] + f[..., k + 3]) \
            + np.uint32(6) * f[..., k + 2]

    def rnd(s):
        return s + np.uint32(0x007F007F) + ((s >> np.uint32(8)) & np.uint32(0x00010001))

    out = np.full((h, ws), 0xDEADBEEF, np.uint32)
    written = np.zeros((h, ws), np.int32)
    depth = swar_proto_depth()
    # granule path: the ring of `depth` rows (garbage until filled) and the
    # row each slot holds, per run; 4-byte path: rows i + 1, i + 2 in flight
    ring = np.full((depth, runs, len(g), 8), 0xA5A5A5A5, np.uint32)
    held = np.full((depth, runs), -1)

    def copy_row(row: int, i: int) -> None:
        """cp.async of row `row` into its slot, in the runs that have it (a
        predicated copy); the slot's row must already have been read (at
        step i - 1 or before)."""
        has = row < n_in
        slot = row % depth
        assert (held[slot][has] <= i - 1).all(), "a slot refilled before it was read"
        ring[slot][has] = load(np.where(has, row, n_in - 1))[has]
        held[slot][has] = row

    if vec:
        for r in range(depth - 1):
            copy_row(r, 0)
    else:
        a0, a1 = load(np.zeros(runs, int)), load(np.ones(runs, int))
    casc = np.zeros((2, 4, 4, runs, len(g)), np.uint32)  # field set, word, stage
    for i in range(int(n_in.max())):
        live = i < n_in
        if vec:
            assert (held[i % depth][live] == i).all(), "row read before its cp.async"
            w = ring[i % depth].copy()
            copy_row(i + depth - 1, i)
            # __shfl_down_sync: lane L < 31 takes lane L + 1's granule
            nb = np.zeros_like(w[:, :, :4])
            nb[:, :-1] = w[:, 1:, :4]
            w[:, ~last, 4:] = nb[:, ~last]
        else:
            w = a0.copy()
            a0 = a1
            a1 = load(np.where(live, np.minimum(i + 2, n_in - 1), n_in - 1))
        fields = (w & m, byte_perm(w, 0, hi_sel).reshape(w.shape))
        o = np.zeros((runs, len(g), 4), np.uint32)
        for f, fl in enumerate(fields):
            for k in range(4):
                p = casc[f, k]
                x1 = p[0] + row5(fl, k)
                x2 = p[1] + x1
                x3 = p[2] + x2
                s = p[3] + x3
                p[:] = np.where(live[:, None], np.stack([row5(fl, k), x1, x2, x3]), p)
                q = rnd(s)
                o[..., k] |= (q >> np.uint32(8)) & m if f == 0 else q & ~m
        if i < 2 * sp.H_:
            continue
        for run in np.nonzero(live)[0]:
            y = r0[run] + i - 2 * sp.H_
            assert y < h
            for k in range(4):
                c = 4 * g + k
                keep = c < ws if not vec else g < ngran
                if vec:
                    assert (c[keep] < ws).all()
                out[y, c[keep]] = o[run, keep, k]
                written[y, c[keep]] += 1
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
