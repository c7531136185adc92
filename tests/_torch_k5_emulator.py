"""A CPU emulation of K5, the tensor-core arm of the fused-stage kernel
(``ops/csrc/mma_stage.cuh`` and ``fs_mma_walk`` in
``ops/csrc/fused_stage.cu``), for the port's tests.

It replays what each lane of a warp holds in its fragment registers, with
the kernel's own index formulas: the B fragments built once per lane from
the taps (the band-restricted K range from ``c0 - h``, the int8 form's
pairing of kernel rows), the A fragments as word loads from a buffer whose
rows are ``pitch`` bytes apart and whose bytes past the region are garbage
(``x ^ 0x80`` as s8 in the int8 form, two bytes as bf16 in the other), the
clamps of a tile's reads into the region's rows and the pitch. It places the registers into the A, B and
D matrices by the PTX ISA's fragment layouts of ``mma.m16n8k16`` and
``mma.m16n8k32``, multiplies in int64, and reads each lane's four outputs
back, stored only where they lie in the output region. Where nvcc is
absent, this is what checks the kernel's indexing. With the whole carry as
the window, its tiling is also that of ``k5_sums_kernel``, K5's exactness
probe.
"""

import numpy as np

G = np.arange(32) // 4  # groupID of each lane
T = np.arange(32) % 4  # threadID_in_group


def _tap(w, d, j):
    ks = w.shape[0]
    ok = (d < ks) & (j >= 0) & (j < ks)
    return np.where(ok, w[min(d, ks - 1), np.clip(j, 0, ks - 1)], 0).astype(np.int64)


def b_fragments(w, int8):
    """mma_b_build: each lane's B registers for one kernel, as the values of
    their elements: int8, (pairs, 2 registers, 4 bytes, 32 lanes), kernel
    rows (2p, 2p + 1); bf16, (rows, 2, 2, 32)."""
    ks = w.shape[0]
    if int8:
        return np.stack([np.stack([np.stack([_tap(w, 2 * p + q, 4 * T + i - G) for i in range(4)])
                                   for q in range(2)]) for p in range((ks + 1) // 2)])
    return np.stack([np.stack([np.stack([_tap(w, d, 2 * T + 8 * q + i - G) for i in range(2)])
                               for q in range(2)]) for d in range(ks)])


class _Buffer:
    """One plane of the region in a buffer of `pitch` bytes a row, garbage
    past the region (or zeros), read as the tile functions read it."""

    def __init__(self, xe, pitch, garbage_seed):
        rows, cols = xe.shape
        assert pitch % 4 == 0 and pitch >= cols
        rng = np.random.default_rng(garbage_seed)
        self.buf = (rng.integers(0, 256, (rows + 32, pitch), dtype=np.int64)
                    if garbage_seed is not None else np.zeros((rows + 32, pitch), np.int64))
        self.buf[:rows, :cols] = xe
        self.rows, self.P = rows, pitch

    def load(self, r, c, n):
        """mma_row, then mma_ld32 (n = 4) / mma_ld16 (n = 2): n bytes at rows
        r, columns c (arrays over the lanes), the row clamped to the
        region's last and the column (once per tile in the kernel) to the
        pitch."""
        r, c = np.minimum(r, self.rows - 1), np.minimum(c, self.P - n)
        return [self.buf[r, c + i] for i in range(n)]


def _tile_int8(buf, bfs, r0, c0, ks):
    """mma_tile_int8: one m16n8k32 step per kernel row pair (d, d + 1), the
    A words x ^ 0x80 as s8; one D per kernel of `bfs`."""
    h = ks // 2
    Ds = [np.zeros((16, 8), np.int64) for _ in bfs]
    for p in range((ks + 1) // 2):
        r, c = r0 - h + 2 * p + G, c0 - h + 4 * T
        pair = 2 * p + 1 < ks
        regs = [(r, c), (r + 8, c), (r + 1, c), (r + 9, c)]
        A = np.full((16, 32), 10**9, np.int64)
        for q, (rr, cc) in enumerate(regs):
            vals = buf.load(rr, cc, 4) if (q < 2 or pair) else [np.zeros(32, np.int64)] * 4
            for j in range(4):
                v = (vals[j] ^ 0x80).astype(np.int64)
                v = np.where(v >= 128, v - 256, v)  # the byte as s8: x - 128
                if q >= 2 and not pair:
                    v = np.zeros_like(v)
                # a_i, i = 4q + j: row g (+8 for q in 1, 3), col 4t + j (+16 for q >= 2)
                A[G + (8 if q in (1, 3) else 0), 4 * T + j + (16 if q >= 2 else 0)] = v
        assert (A < 10**9).all() and A.min() >= -128 and A.max() <= 127
        for D, bf in zip(Ds, bfs):
            Bm = np.full((32, 8), 10**9, np.int64)
            for q in range(2):
                for j in range(4):
                    Bm[4 * T + j + 16 * q, G] = bf[p, q, j]
            assert (Bm < 10**9).all() and Bm.min() >= -128 and Bm.max() <= 127
            D += A @ Bm
    return Ds


def _tile_bf16(buf, bfs, r0, c0, ks):
    """mma_tile_bf16: one m16n8k16 step per kernel row d, four 16-bit loads
    a lane."""
    h = ks // 2
    Ds = [np.zeros((16, 8), np.int64) for _ in bfs]
    for d in range(ks):
        r, c = r0 - h + d + G, c0 - h + 2 * T
        # a0 .. a3, two elements each
        regs = [buf.load(r, c, 2), buf.load(r + 8, c, 2), buf.load(r, c + 8, 2),
                buf.load(r + 8, c + 8, 2)]
        # the PTX layout of m16n8k16: register q at row g (+8 for q = 1, 3),
        # element e at col 2t + e (+8 for q >= 2)
        A = np.full((16, 16), 10**9, np.int64)
        for q, vals in enumerate(regs):
            for e in range(2):
                A[G + (8 if q in (1, 3) else 0), 2 * T + e + (8 if q >= 2 else 0)] = vals[e]
        assert (A < 10**9).all()
        for D, bf in zip(Ds, bfs):
            Bm = np.full((16, 8), 10**9, np.int64)
            for q in range(2):
                for e in range(2):
                    Bm[2 * T + e + 8 * q, G] = bf[d, q, e]
            assert (Bm < 10**9).all()
            D += A @ Bm
    return Ds


def emulate_k5_sums(xe: np.ndarray, w2d, arm: str, *, pitch: int | None = None,
                    garbage_seed: int | None = None, second=None) -> np.ndarray:
    """One kernel's sums (or, with `second`, two kernels' sums sharing every
    A fragment, as a magnitude op's) over a u8-valued (rows, cols) region as
    K5 computes them, float32 (rows - 2h, cols - 2h): the region in a
    buffer `pitch` bytes a row (default cols rounded up to 4, as the probe
    pads), its bytes past the region garbage from `garbage_seed` (default
    zeros), the output region [h, rows - h) x [h, cols - h) cut into 16 x 8
    tiles from (h, h). Each lane's four outputs are stored where they lie in
    the region; the int8 form adds 128 * sum(w) in float32."""
    x = np.asarray(xe)
    assert np.array_equal(x, np.round(x)) and x.min() >= 0 and x.max() <= 255
    kernels = [w2d] + ([second] if second is not None else [])
    ws = []
    for k in kernels:
        w = np.asarray(k, np.float64)
        assert np.array_equal(w, np.round(w))
        ws.append(w.astype(np.int64))
    ks = ws[0].shape[0]
    h = ks // 2
    rows, cols = x.shape
    pitch = pitch if pitch is not None else -(-cols // 4) * 4
    buf = _Buffer(x.astype(np.int64), pitch, garbage_seed)
    y_end, x_end = rows - h, cols - h
    int8 = arm == "mxu-int8"
    bfs = [b_fragments(w, int8) for w in ws]
    outs = [np.full((rows - 2 * h, cols - 2 * h), np.nan, np.float64) for _ in ws]
    for r0 in range(h, y_end, 16):
        for c0 in range(h, x_end, 8):
            Ds = _tile_int8(buf, bfs, r0, c0, ks) if int8 else _tile_bf16(buf, bfs, r0, c0, ks)
            for out, D in zip(outs, Ds):
                for i in range(4):  # each lane's D registers: rows g (+8), cols 2t + (i & 1)
                    wy = r0 + G + (i >> 1) * 8
                    wx = c0 + 2 * T + (i & 1)
                    keep = (wy < y_end) & (wx < x_end)
                    out[wy[keep] - h, wx[keep] - h] = D[(wy - r0)[keep], (wx - c0)[keep]]
    accs = []
    for out, w in zip(outs, ws):
        assert not np.isnan(out).any()  # every output stored
        acc = out.astype(np.float32)
        if int8:
            acc = acc + np.float32(128 * int(w.sum()))
        accs.append(acc)
    return accs[0] if second is None else accs


def store_lanes():
    """Where each lane of fs_mma_walk writes a 16 x 8 tile's outputs: (lane,
    row, first column, count) per store, each lane's two adjacent outputs
    of rows g and g + 8 as 16-bit words."""
    return [(lane, G[lane] + 8 * k, 2 * T[lane], 2) for lane in range(32) for k in range(2)]
