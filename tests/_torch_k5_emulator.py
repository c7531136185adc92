"""A CPU emulation of K5, the tensor-core arm of the fused-stage kernel
(``ops/csrc/mma_stage.cuh`` and ``fs_stencil_mma`` in
``ops/csrc/fused_stage.cu``), for the port's tests.

It replays what each lane of a warp loads into its fragment registers,
with the kernel's own index formulas (the band-restricted K range from
``c0 - h``, the int8 form's pairing of kernel rows and its ``x - 128``
shift, zero outside the input window), places the registers into the A, B
and D matrices by the PTX ISA's fragment layouts of ``mma.m16n8k16`` and
``mma.m16n8k32``, multiplies in int64, and reads each lane's four outputs
back, stored only where they lie in the output region. Where nvcc is
absent, this is what checks the kernel's indexing. With the whole carry
as the window, its tiling is also that of ``k5_sums_kernel``, K5's
exactness probe.
"""

import numpy as np

G = np.arange(32) // 4  # groupID of each lane
T = np.arange(32) % 4  # threadID_in_group


def _px(x, r, c, int8):
    """Window elements at (r, c) (arrays), zero outside: u8 values, or x - 128
    in the int8 form (mma_a_bf16 / mma_a_s8)."""
    inside = (r >= 0) & (r < x.shape[0]) & (c >= 0) & (c < x.shape[1])
    v = x[np.clip(r, 0, x.shape[0] - 1), np.clip(c, 0, x.shape[1] - 1)].astype(np.int64)
    if int8:
        v = v - 128
    return np.where(inside, v, 0)


def _tap(w, d, j):
    ks = w.shape[0]
    ok = (d < ks) & (j >= 0) & (j < ks)
    return np.where(ok, w[min(d, ks - 1), np.clip(j, 0, ks - 1)], 0).astype(np.int64)


def _tile_bf16(x, w, r0, c0):
    """mma_tile_bf16: one m16n8k16 step per kernel row d; returns D (16, 8)."""
    ks = w.shape[0]
    h = ks // 2
    D = np.zeros((16, 8), np.int64)
    for d in range(ks):
        r, c = r0 - h + d + G, c0 - h + 2 * T
        # each lane's registers: (row, col) of each of its 8 A and 4 B elements
        regs_a = [(r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1),
                  (r, c + 8), (r, c + 9), (r + 8, c + 8), (r + 8, c + 9)]
        vals_a = [_px(x, rr, cc, False) for rr, cc in regs_a]
        vals_b = [_tap(w, d, 2 * T - G), _tap(w, d, 2 * T + 1 - G),
                  _tap(w, d, 2 * T + 8 - G), _tap(w, d, 2 * T + 9 - G)]
        # the PTX layout of m16n8k16: a_i at row g (+8 for i in 2,3,6,7),
        # col 2t + (i & 1) (+8 for i >= 4); b_i at k = 2t + (i & 1) (+8 for
        # i >= 2), n = g
        A = np.full((16, 16), 10**9, np.int64)
        Bm = np.full((16, 8), 10**9, np.int64)
        for i, v in enumerate(vals_a):
            A[G + (8 if i in (2, 3, 6, 7) else 0), 2 * T + (i & 1) + (8 if i >= 4 else 0)] = v
        for i, v in enumerate(vals_b):
            Bm[2 * T + (i & 1) + (8 if i >= 2 else 0), G] = v
        assert (A < 10**9).all() and (Bm < 10**9).all()  # every element set once
        D += A @ Bm
    return D


def _tile_int8(x, w, r0, c0):
    """mma_tile_int8: one m16n8k32 step per kernel row pair (d, d + 1)."""
    ks = w.shape[0]
    h = ks // 2
    D = np.zeros((16, 8), np.int64)
    for d in range(0, ks, 2):
        r, c = r0 - h + d + G, c0 - h + 4 * T
        pair = d + 1 < ks
        regs = [(r, c), (r + 8, c), (r + 1, c), (r + 9, c)]
        A = np.full((16, 32), 10**9, np.int64)
        Bm = np.full((32, 8), 10**9, np.int64)
        for q, (rr, cc) in enumerate(regs):
            for j in range(4):
                v = _px(x, rr, cc + j, True)
                if q >= 2 and not pair:
                    v = np.zeros_like(v)
                # a_i, i = 4q + j: row g (+8 for q in 1, 3), col 4t + j (+16 for q >= 2)
                A[G + (8 if q in (1, 3) else 0), 4 * T + j + (16 if q >= 2 else 0)] = v
        for q, dd in enumerate((d, d + 1)):
            for j in range(4):
                Bm[4 * T + j + 16 * q, G] = _tap(w, dd, 4 * T + j - G)
        assert (A < 10**9).all() and (Bm < 10**9).all()
        # the operands are int8
        assert A.min() >= -128 and A.max() <= 127 and Bm.min() >= -128 and Bm.max() <= 127
        D += A @ Bm
    return D


def emulate_k5_sums(xe: np.ndarray, w2d: np.ndarray, arm: str) -> np.ndarray:
    """One kernel's sums over a width-extended u8-valued carry (rows, W + 2h)
    as K5 computes them, float32 (rows - 2h, W): the whole carry as the
    input window (off = 0), the output region [h, rows - h) x [h, W + h)
    cut into 16 x 8 tiles from (h, h), each lane's four outputs stored where
    they lie in the region; the int8 form adds 128 * sum(w) in float32."""
    x = np.asarray(xe)
    w = np.asarray(w2d, np.float64)
    assert np.array_equal(w, np.round(w))
    w = w.astype(np.int64)
    ks = w.shape[0]
    h = ks // 2
    rows, we = x.shape
    y_end, x_end = rows - h, we - h
    out = np.full((rows - 2 * h, we - 2 * h), np.nan, np.float64)
    int8 = arm == "mxu-int8"
    for r0 in range(h, y_end, 16):
        for c0 in range(h, x_end, 8):
            D = _tile_int8(x, w, r0, c0) if int8 else _tile_bf16(x, w, r0, c0)
            for i in range(4):  # each lane's D registers: rows g (+8), cols 2t + (i & 1)
                wy = r0 + G + (i >> 1) * 8
                wx = c0 + 2 * T + (i & 1)
                keep = (wy < y_end) & (wx < x_end)
                out[wy[keep] - h, wx[keep] - h] = D[(wy - r0)[keep], (wx - c0)[keep]]
    assert not np.isnan(out).any()  # every output stored
    acc = out.astype(np.float32)
    if int8:
        acc = acc + np.float32(128 * int(w.sum()))
    return acc
