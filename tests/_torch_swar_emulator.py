"""A numpy replay of the SWAR kernels' algorithm (``ops/csrc/swar_stencil.cu``:
K6 narrow and wide, K7, K8, full and ghost mode), tile by tile, for the
port's tests: the same grid, the same window of pre-chained pair words, the
same funnel shifts, per-halfword saturating arithmetic and quantizers, the
same masked stores. ``uint32`` arrays wrap as the card's registers do."""

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

_LO = np.uint32(0x00FF00FF)
_ONES = np.uint32(0x00010001)


def _halves(x):
    x = np.asarray(x, dtype=np.uint32)
    return x & np.uint32(0xFFFF), x >> np.uint32(16)


def _join(lo, hi):
    return (np.asarray(lo, np.uint32) & np.uint32(0xFFFF)) | (np.asarray(hi, np.uint32) << np.uint32(16))


def vsubus2(a, b):
    """__vsubus2: per-halfword max(a - b, 0)."""
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.where(al > bl, al - bl, 0), np.where(ah > bh, ah - bh, 0))


def vminu2(a, b):
    """__vminu2: per-halfword unsigned minimum."""
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.minimum(al, bl), np.minimum(ah, bh))


def funnel16(lo, hi):
    """__funnelshift_r(lo, hi, 16): the middle 32 bits of hi:lo."""
    return (np.asarray(lo, np.uint32) >> np.uint32(16)) | (np.asarray(hi, np.uint32) << np.uint32(16))


def chain_fields(f, steps):
    for neg, A, C, m in steps:
        if neg:
            f = _LO - f
        t = f * np.uint32(A)
        if C > 0:
            t = vsubus2(t, np.uint32(C) * _ONES)
        elif C < 0:
            t = t + np.uint32(-C) * _ONES
        if m:
            t = (t >> np.uint32(m)) & (np.uint32(0xFFFF >> m) * _ONES)
        f = vminu2(t, _LO)
    return f


def chain_lane(x, steps):
    for neg, A, C, m in steps:
        if neg:
            x = 255 - x
        x = np.minimum(np.maximum(x * A - C, 0) >> m, 255)
    return x


def _src(c, n, mode):
    """sw_src: the source index, -1 for a zero."""
    c = np.asarray(c)
    inside = (c >= 0) & (c < n)
    if mode in ("zero", "interior"):
        return np.where(inside, c, -1)
    if mode == "reflect101":
        c = np.where(c < 0, -c, np.where(c >= n, 2 * (n - 1) - c, c))
    return np.clip(c, 0, n - 1)


def _rint_clip(x):
    return np.clip(np.rint(x), 0, 255)


def _quantize(x, mode):
    return np.floor(np.clip(x, 0, 255)) if mode == "trunc_clip" else _rint_clip(x)


def emulate_swar(op, img, *, pre_chain=(), post_chain=(), tile_h=sk.DEFAULT_TILE_H,
                 ghosts=None, y0=0, global_h=None):
    """The kernel over a (H, W) u8 plane, block by block. Ghost mode when
    `ghosts` = (top, bottom) is given. Every output byte must be written
    exactly once; an unwritten one reads 0xFF... and fails the caller's
    comparison, a twice-written one raises."""
    kind = sk.swar_kind(op)
    H, W = img.shape
    global_h = H if global_h is None else global_h
    h = op.halo
    nw = sk.window_words(h)
    eh = tile_h + 2 * h
    P = sk.PAIRS
    f32 = np.float32
    scale = f32(op.scale)
    out = np.zeros((H, W), np.uint8)
    writes = np.zeros((H, W), np.int32)
    img = np.asarray(img, np.uint8)
    for by in range(0, H, tile_h):
        for bx in range(0, W, sk.TILE_W):
            # 1. window load
            ty = by + np.arange(eh) - h
            if ghosts is None:
                sy = _src(ty, H, op.edge_mode)
                rows = np.where(sy[:, None] >= 0, img[np.maximum(sy, 0)], 0)
            else:
                top, bottom = (np.asarray(g, np.uint8) for g in ghosts)
                rows = np.stack([
                    top[h + t] if t < 0 else bottom[min(t - H, h - 1)] if t >= H else img[t]
                    for t in ty
                ])
            gx = bx - h + 2 * np.arange(nw)
            s0, s1 = _src(gx, W, op.edge_mode), _src(gx + 1, W, op.edge_mode)
            v0 = np.where(s0 >= 0, rows[:, np.maximum(s0, 0)], 0).astype(np.uint32)
            v1 = np.where(s1 >= 0, rows[:, np.maximum(s1, 0)], 0).astype(np.uint32)
            win = chain_fields(v0 | (v1 << np.uint32(16)), pre_chain)  # (eh, nw)

            def pair(r0, dy, dx):
                """Pair words at window rows r0 + dy, columns 2p + dx, for
                every pair p of the tile: (rows, P)."""
                wr = win[r0 + dy]
                a = wr[..., dx // 2 : dx // 2 + P]
                return funnel16(a, wr[..., dx // 2 + 1 : dx // 2 + 1 + P]) if dx % 2 else a

            ly = np.arange(tile_h)
            if kind.startswith("K6"):
                taps, k = sk._taps_shift(op)
                row = np.zeros((eh, P), np.uint32)
                for t, w in enumerate(taps):
                    row = row + pair(np.arange(eh), 0, t) * np.uint32(w)
                if kind == "K6-narrow":
                    s = np.zeros((tile_h, P), np.uint32)
                    for t, w in enumerate(taps):
                        s = s + row[ly + t] * np.uint32(w)
                    half = np.uint32((1 << (k - 1)) - 1)
                    b = (s >> np.uint32(k)) & _ONES
                    q = ((s + ((half << np.uint32(16)) | half) + b) >> np.uint32(k)) & _LO
                    q = chain_fields(q, post_chain)
                    lanes = list(_halves(q))
                else:
                    lanes = []
                    for lane in _halves(row):
                        s = sum(int(w) * lane[ly + t].astype(np.int64) for t, w in enumerate(taps))
                        qq = _rint_clip(s.astype(f32) * scale).astype(np.int64)
                        lanes.append(chain_lane(qq, post_chain))
            else:
                kernels = [np.asarray(kk).astype(np.int64) for kk in op.kernels]
                taps = [[(dy, dx, int(w[dy, dx])) for dy in range(2 * h + 1)
                         for dx in range(2 * h + 1) if w[dy, dx]] for w in kernels]
                if kind == "K7":
                    pos = np.zeros((tile_h, P), np.uint32)
                    neg = np.zeros((tile_h, P), np.uint32)
                    for dy, dx, w in taps[0]:
                        v = pair(ly, dy, dx)
                        if w > 0:
                            pos = pos + v * np.uint32(w)
                        else:
                            neg = neg + v * np.uint32(-w)
                    bias = np.uint32(255 * sum(-w for _, _, w in taps[0] if w < 0)) * _ONES
                    q = vminu2(vsubus2((bias + pos) - neg, bias), _LO)
                    lanes = list(_halves(q))
                else:
                    accs = []
                    for kt in taps[: 1 + (op.combine == "magnitude")]:
                        acc = [np.zeros((tile_h, P), np.int64), np.zeros((tile_h, P), np.int64)]
                        for dy, dx, w in kt:
                            for f, lane in enumerate(_halves(pair(ly, dy, dx))):
                                acc[f] = acc[f] + w * lane.astype(np.int64)
                        accs.append(acc)
                    lanes = []
                    for f in range(2):
                        a = accs[0][f].astype(f32)
                        if op.combine == "magnitude":
                            b = accs[1][f].astype(f32)
                            a = np.sqrt((a * a + b * b).astype(np.float64)).astype(f32)
                        if f32(op.scale) != f32(1.0):
                            a = a * scale
                        lanes.append(_quantize(a, op.quantize).astype(np.int64))
                if op.edge_mode == "interior":
                    centre = _halves(pair(ly, h, h))
                    gy = (y0 + by + ly)[:, None]
                    for f in range(2):
                        gxx = (bx + 2 * np.arange(P) + f)[None, :]
                        keep = (gxx > h) & (gxx <= W - 1 - h) & (gy > h) & (gy <= global_h - 1 - h)
                        lanes[f] = np.where(keep, lanes[f], centre[f])
                if kind == "K7":
                    lanes = _halves(chain_fields(_join(*lanes), post_chain))
                else:
                    lanes = [chain_lane(np.asarray(x, np.int64), post_chain) for x in lanes]
            # masked stores of both bytes of each pair
            for f in range(2):
                lane = np.asarray(lanes[f])
                for r in range(tile_h):
                    gy = by + r
                    if gy >= H:
                        continue
                    cols = bx + 2 * np.arange(P) + f
                    ok = cols < W
                    out[gy, cols[ok]] = lane[r][ok]
                    writes[gy, cols[ok]] += 1
    if writes.max() > 1:
        raise AssertionError("an output byte was written twice")
    out[writes == 0] = 0xFF
    return out
