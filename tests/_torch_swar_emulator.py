"""A numpy replay of the SWAR kernels (``ops/csrc/swar_stencil.cu``: K6
narrow and wide, K7, K8, full and ghost mode), block by block, for the
port's tests: the same tile shape and shared-memory layout, the window
loader's row sources (a row of zeros where the edge mode has none) and
16-byte granules copied from made-up device addresses into a raw buffer
that starts as garbage, the pair build of four words a thread (word reads
and funnel shifts in blocks inside the image, the edge mode's source column
per pixel in border blocks), then the instantiation the dispatch picks
from the descriptor (``swar_instance``): for sides 3/5/7 the register
window (two 16-byte reads of a window row, the odd pairs as funnel shifts
of registers) with K7's biased multiply-add per tap modulo 2^32, K8's
biased 16-bit fields (side 3) or i32 lanes, and K6's row pass of four pair
words a thread and its column pass of two rows a thread (read from the
source) on fields or lanes; the tap-table loops for larger kernels; the
interior guard hoisted out of blocks inside the interior, the post-chain on
pair words, and the stores of eight bytes a thread. ``uint32`` arrays wrap as the card's registers do."""

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

_LO = np.uint32(0x00FF00FF)
_ONES = np.uint32(0x00010001)
_U32 = np.uint32


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


def funnel(lo, hi, s):
    """__funnelshift_r(lo, hi, s) for shifts s in 0..31 (arrays)."""
    v = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return ((v >> np.asarray(s, np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def chain_fields(f, steps):
    """sw_chain_fields4: each step with its subtraction and addition (one of
    them of 0) and its shift (maybe by 0) on every word."""
    f = np.asarray(f, np.uint32)
    for neg, A, C, m in steps:
        x = _LO - f if neg else f
        t = vsubus2(x * np.uint32(A), np.uint32(max(C, 0)) * _ONES)
        t = t + np.uint32(max(-C, 0)) * _ONES
        f = vminu2((t >> np.uint32(m)) & (np.uint32(0xFFFF >> m) * _ONES), _LO)
    return f


def _src(c, n, mode):
    """sw_src: the source index, -1 for a zero."""
    c = np.asarray(c)
    inside = (c >= 0) & (c < n)
    if mode in ("zero", "interior"):
        return np.where(inside, c, -1)
    if mode == "reflect101":
        c = np.where(c < 0, -c, np.where(c >= n, 2 * (n - 1) - c, c))
    return np.clip(c, 0, n - 1)


_MAGIC_BITS = np.uint32(0x4B400000)
_MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def _field_f(field, off):
    """sw_field_f: the u16 field's bits into the magic's mantissa (a byte
    permute), as float32, minus `off` (one float32 subtraction)."""
    bits = _MAGIC_BITS | np.asarray(field, np.uint32)
    return bits.view(np.float32) - np.float32(off)


def _lane_f(n):
    """sw_lane_f: an integer 0 <= n < 2^22 added to the magic's bits."""
    n = np.asarray(n, np.int64)
    assert n.min(initial=0) >= 0 and n.max(initial=0) < 1 << 22
    return (_MAGIC_BITS + n.astype(np.uint32)).view(np.float32) - _MAGIC


def _rint_clip_byte(x):
    """sw_rint_clip_bits: clip to [0, 255] in float32, add the magic (round
    half to even at 1), the low byte; its second byte must be 0."""
    bits = (np.clip(np.asarray(x, np.float32), 0, 255).astype(np.float32) + _MAGIC).view(np.uint32)
    assert not np.any(bits & np.uint32(0xFF00))
    return (bits & np.uint32(0xFF)).astype(np.int64)


def _quantize2(x, mode):
    """sw_quantize2's quantizer of one pixel: the magic rounding for
    rint_clip, floor of the clip for trunc_clip."""
    x = np.asarray(x, np.float32)
    return _rint_clip_byte(x) if mode == "rint_clip" else np.floor(np.clip(x, 0, 255))


def _le_words(b):
    """Little-endian 32-bit words of a (..., 4n) uint8 array: (..., n)."""
    return np.ascontiguousarray(b).view("<u4").astype(np.uint32)


class _Memory:
    """An array at a made-up device address `addr`, with garbage bytes
    around it: the 16-byte granules a row reads from below its first byte
    and past its last are real reads of whatever lies there."""

    def __init__(self, arr, addr, rng):
        self.addr = addr
        flat = np.asarray(arr, np.uint8).reshape(-1)
        self.pad = 32 + (addr & 15)
        self.buf = rng.integers(0, 256, flat.size + 2 * self.pad + 32, dtype=np.uint8)
        self.buf[self.pad:self.pad + flat.size] = flat

    def read(self, addr, n):
        """`n` bytes from device address `addr` (at most 16 below the array
        and what the granules reach past it)."""
        i = addr - self.addr + self.pad
        assert 0 <= i and i + n <= self.buf.size, (addr, n)
        return self.buf[i:i + n]


def _source_rows() -> int:
    """The output rows a thread of K6's compile-time column pass takes, as
    swar_stencil.cu's sw_k6_columns sets them."""
    import re
    from pathlib import Path

    src = (Path(sk.__file__).parent / "csrc" / "swar_stencil.cu").read_text()
    return int(re.search(r"constexpr int ROWS = KS > 0 \? (\d+) : 1;", src).group(1))


ROWS = _source_rows()


def _k6_row_pass(win, t1, side, eh, nq, wp):
    """K6's row pass into the (eh, P2) row-pass buffer. Side 3/5/7: four pair
    words a thread (group g of a row) from the register window, its words
    4g .. 4g + 7 (two 16-byte reads) and the odd pairs as funnel shifts of
    them, one multiply-add per word and tap; the tap table: one pair word a
    thread, its window words read one by one."""
    p2 = 4 * nq
    rowp = np.zeros((eh, p2), np.uint32)
    if side:
        hk = side // 2
        words = 4 * np.arange(nq)[:, None] + np.arange(8)[None, :]
        assert words.max() < wp
        for r in range(eh):
            w = win[r, words]
            o = funnel16(w[:, :3 + hk], w[:, 1:4 + hk])
            acc = np.zeros((nq, 4), np.uint32)
            for dx in range(side):
                acc = acc + (o if dx & 1 else w)[:, dx // 2:dx // 2 + 4] * _U32(t1[dx])
            rowp[r] = acc.reshape(-1)
        return rowp
    p = np.arange(p2)
    for r in range(eh):
        a = win[r, p]
        acc = a * _U32(t1[0])
        for t in range(1, len(t1), 2):
            b = win[r, p + (t + 1) // 2]
            acc = acc + funnel16(a, b) * _U32(t1[t]) + b * _U32(t1[t + 1])
            a = b
        rowp[r] = acc
    return rowp


def _k6_columns(rowp, t1, arm, rows, tile_h, y_end, nq, eh, shift, scale):
    """K6's column pass: `rows` output rows a thread (a group from row ly0),
    one 16-byte read of the row pass per tap row shared by the group's rows;
    the last read, which feeds only the group's last row, only where that
    row is stored. `arm`: 'narrow' (fields, >> shift round-half-even),
    'fields' (wide on fields), 'lanes' (wide on i32 lanes); then the u8
    results as pair words (rows past y_end hold zeros)."""
    n = len(t1)
    s = np.zeros((tile_h, nq, 4), np.uint32)
    lo = np.zeros((tile_h, nq, 4), np.int64)
    hi = np.zeros((tile_h, nq, 4), np.int64)
    ly0 = np.arange(0, tile_h, rows)
    ly0 = ly0[ly0 < y_end]
    last = ly0 + rows - 1 < y_end
    for t in range(n + rows - 1):
        read = ly0[(t < n) | last]
        assert read.size == 0 or read.max() + t < eh, "a read past the row pass"
        c = rowp[read + t].reshape(-1, nq, 4)
        for rr in range(rows):
            if not 0 <= t - rr < n:
                continue
            at = read + rr
            keep = at < tile_h
            tap = t1[t - rr]
            if arm == "lanes":
                lo[at[keep]] += tap * (c[keep] & _U32(0xFFFF)).astype(np.int64)
                hi[at[keep]] += tap * (c[keep] >> _U32(16)).astype(np.int64)
            else:
                s[at[keep]] = s[at[keep]] + c[keep] * _U32(tap)
    if arm == "narrow":
        half = _U32((1 << (shift - 1)) - 1)
        b = (s >> _U32(shift)) & _ONES
        return ((s + ((half << _U32(16)) | half) + b) >> _U32(shift)) & _LO
    if arm == "fields":
        floats = [_field_f(x, _MAGIC) for x in _halves(s)]
    else:
        floats = [_lane_f(x) for x in (lo, hi)]
    return _join(*(_rint_clip_byte(f * np.float32(scale)) for f in floats))


def _k8_window_sums(op, flat, ly, q, wp, side, form, bias):
    """K8's sums at side 3/5/7 from the register window (each window row's
    words 4q .. 4q + 7 for every quad): 'fields', bias + sum(w * x) per
    kernel on whole pair words modulo 2^32, read out per field minus the
    bias; 'lanes', each row split into one pixel per lane. Returns the sums
    as [kernel][field] arrays of (tile_h, nq, 4) and the centre pairs."""
    hk = side // 2
    dense = [np.asarray(k).astype(np.int64).reshape(-1) for k in op.kernels]
    idx = np.arange(8)[None, None, :]
    cen = None
    if form == "fields":
        bias2 = _U32(bias) * _ONES
        acc = [np.full(ly.shape[:1] + q.shape[1:2] + (4,), bias2, np.uint32) for _ in dense]
        for dy in range(side):
            w = flat[(ly + dy) * wp + 4 * q + idx]
            o = funnel16(w[..., :3 + hk], w[..., 1:4 + hk])
            for dx in range(side):
                src = (o if dx & 1 else w)[..., dx // 2:dx // 2 + 4]
                for k, d in enumerate(dense):
                    acc[k] = acc[k] + src * _U32(int(d[dy * side + dx]) & 0xFFFFFFFF)
            if dy == hk:
                cen = (o if hk & 1 else w)[..., hk // 2:hk // 2 + 4]
        off = _MAGIC + np.float32(bias)
        sums = [[_field_f(f, off) for f in _halves(a)] for a in acc]
        return sums + [[0, 0]] * (2 - len(sums)), cen
    acc = [0 for _ in dense]
    for dy in range(side):
        w = flat[(ly + dy) * wp + 4 * q + idx]
        lanes = np.stack(_halves(w[..., :4 + hk]), axis=-1).reshape(w.shape[:2] + (8 + 2 * hk,))
        lanes = lanes.astype(np.int64)
        for dx in range(side):
            for k, d in enumerate(dense):
                acc[k] = acc[k] + int(d[dy * side + dx]) * lanes[..., dx:dx + 8]
        if dy == hk:
            cen = _join(lanes[..., hk:hk + 8:2], lanes[..., hk + 1:hk + 8:2])
    sums = [[a[..., 0::2], a[..., 1::2]] for a in acc]
    return sums + [[0, 0]] * (2 - len(sums)), cen


def emulate_swar(op, img, *, pre_chain=(), post_chain=(), tile_h=None, tile_w=None,
                 ghosts=None, y0=0, global_h=None, addr=0, ghost_addrs=(4096, 8192), seed=0):
    """The kernel over a (H, W) u8 plane, block by block. Ghost mode when
    `ghosts` = (top, bottom) is given. `tile_h` and `tile_w` default to the
    host's choice (``swar_tile_shape``); `addr` and `ghost_addrs` are the
    made-up device addresses of the plane and the strips, so that rows start
    at any byte of a granule; the raw buffer and the bytes around the arrays
    start as seeded garbage. Every output byte must be written exactly once;
    an unwritten one reads 0xFF and fails the caller's comparison, a
    twice-written one raises."""
    desc, table = sk.swar_desc(op, pre_chain, post_chain)
    kind, side, form = sk.swar_instance(desc)
    H, W = img.shape
    global_h = H if global_h is None else global_h
    h = op.halo
    if tile_h is None or tile_w is None:
        rows_w = sk.swar_tile_shape(kind, h, H, W, tile_h, table.size)
        tile_h, tile_w = rows_w if tile_w is None else (rows_w[0], tile_w)
    assert tile_w in (64, 128, 256) and tile_h >= 1
    lay = sk.swar_layout(kind, tile_h, h, table.size, tile_w)
    WP, RP = lay["wp"], lay["rp"]
    eh = tile_h + 2 * h
    nq = tile_w // 8
    P2 = tile_w // 2
    ks = 2 * h + 1
    f32 = np.float32
    scale = f32(op.scale)
    rng = np.random.default_rng(seed)
    mem = _Memory(img, addr, rng)
    if ghosts is not None:
        mem_top, mem_bot = (_Memory(g, a, rng) for g, a in zip(ghosts, ghost_addrs))
    out = np.zeros((H, W), np.uint8)
    writes = np.zeros((H, W), np.int32)
    # the kernels' tap encodings: K6's 1-D taps; K7/K8's (word offset << 1 |
    # parity, weight) from the table's (offset, weight)
    n_chain = 4 * (len(pre_chain) + len(post_chain))
    taps = [int(v) for v in table[n_chain:]]
    enc = []
    if not kind.startswith("K6"):
        for t in range(0, len(taps), 2):
            dy, dx = divmod(taps[t], ks)
            enc.append((((dy * WP + (dx >> 1)) << 1) | (dx & 1), taps[t + 1]))
    n0 = desc.n_taps[0]
    for by in range(0, H, tile_h):
        for bx in range(0, W, tile_w):
            x0 = bx
            border = x0 - h < 0 or x0 + tile_w + h > W
            lo_c, hi_c = max(x0 - h, 0), min(x0 + tile_w + h, W)
            seg = hi_c - lo_c
            # 1. row sources and the raw window
            raw = rng.integers(0, 256, (eh, RP), dtype=np.uint8)
            shifts = np.zeros(eh, np.int64)
            has = np.zeros(eh, bool)
            for r in range(eh):
                ty = by + r - h
                if ghosts is None:
                    sy = int(_src(ty, H, op.edge_mode))
                    if sy < 0:
                        continue
                    m, a = mem, addr + sy * W
                elif ty < 0:
                    m, a = mem_top, ghost_addrs[0] + (h + ty) * W
                elif ty >= H:
                    m, a = mem_bot, ghost_addrs[1] + min(ty - H, h - 1) * W
                else:
                    m, a = mem, addr + ty * W
                a += lo_c
                shift = a & 15
                granules = (shift + seg + 15) >> 4
                assert 16 * granules <= RP
                raw[r, :16 * granules] = m.read(a - shift, 16 * granules)
                shifts[r], has[r] = shift, True
            # 2. pair words, four a thread (group g: window pixels 8g .. 8g + 7)
            gw = WP // 4
            g = np.arange(gw)
            win = np.zeros((eh, WP), np.uint32)
            for r in range(eh):
                if not has[r]:
                    lo = hi = np.zeros(gw, np.uint32)
                elif not border:
                    b = shifts[r] + 8 * g
                    words = _le_words(raw[r])
                    w0, w1, w2 = (words[(b & ~3) // 4 + k] for k in range(3))
                    s = 8 * (b & 3)
                    lo, hi = funnel(w0, w1, s), funnel(w1, w2, s)
                else:
                    cx = x0 - h + 8 * g[:, None] + np.arange(8)[None, :]
                    sx = _src(cx, W, op.edge_mode)
                    idx = shifts[r] + np.clip(sx, lo_c, hi_c - 1) - lo_c
                    v = np.where(sx < 0, 0, raw[r][idx]).astype(np.uint32)
                    sh = np.uint32(8) * (np.arange(4, dtype=np.uint32))
                    lo = (v[:, :4] << sh).sum(axis=1).astype(np.uint32)
                    hi = (v[:, 4:] << sh).sum(axis=1).astype(np.uint32)
                bytes_lo = [(lo >> _U32(8 * k)) & _U32(0xFF) for k in range(4)]
                bytes_hi = [(hi >> _U32(8 * k)) & _U32(0xFF) for k in range(4)]
                f = np.stack([bytes_lo[0] | bytes_lo[1] << _U32(16),
                              bytes_lo[2] | bytes_lo[3] << _U32(16),
                              bytes_hi[0] | bytes_hi[1] << _U32(16),
                              bytes_hi[2] | bytes_hi[3] << _U32(16)], axis=1)
                win[r] = chain_fields(f, pre_chain).reshape(-1)
            flat = win.reshape(-1)
            y_end, x_end = min(tile_h, H - by), min(tile_w, W - x0)
            ly = np.arange(tile_h)[:, None, None]
            q = np.arange(nq)[None, :, None]
            j = np.arange(4)[None, None, :]
            # 3. four output pairs a thread: (tile_h, nq, 4) pair words
            if kind.startswith("K6"):
                t1 = [int(v) for v in taps]
                n = len(t1)
                rowp = _k6_row_pass(win, t1, side, eh, nq, WP)
                arm = "narrow" if kind == "K6-narrow" else ("fields" if desc.fields else "lanes")
                res = _k6_columns(rowp, t1, arm, ROWS if side else 1, tile_h, y_end, nq, eh,
                                  desc.shift, scale)
                res = chain_fields(res, post_chain)
            else:
                base = ly * WP + 4 * q
                if kind == "K7" and side:
                    dense = np.asarray(op.kernels[0]).astype(np.int64).reshape(-1)
                    bias2 = _U32(desc.bias) * _ONES
                    acc = np.full((tile_h, nq, 4), bias2, np.uint32)
                    cen = None
                    for dy in range(ks):
                        w = flat[(ly + dy) * WP + 4 * q + np.arange(8)[None, None, :]]
                        o = funnel16(w[..., :3 + h], w[..., 1:4 + h])
                        for dx in range(ks):
                            wt = _U32(int(dense[dy * ks + dx]) & 0xFFFFFFFF)
                            src = o if dx & 1 else w
                            acc = acc + src[..., dx // 2:dx // 2 + 4] * wt
                        if dy == h:
                            cen = (o if h & 1 else w)[..., h // 2:h // 2 + 4]
                    res = vminu2(vsubus2(acc, bias2), _LO)
                else:
                    if kind == "K8" and side:
                        sums, cen = _k8_window_sums(op, flat, ly, q, WP, side, form, desc.bias)
                    else:
                        c = base + h * WP + h // 2 + j
                        cen = funnel16(flat[c], flat[c + 1]) if h & 1 else flat[c]

                    def pair(o_enc):
                        p = base + (o_enc >> 1) + j
                        return funnel16(flat[p], flat[p + 1]) if o_enc & 1 else flat[p]

                    if kind == "K7":
                        bias2 = _U32(desc.bias) * _ONES
                        acc = np.full((tile_h, nq, 4), bias2, np.uint32)
                        for o_enc, wt in enc[:n0]:
                            acc = acc + pair(o_enc) * _U32(wt & 0xFFFFFFFF)
                        res = vminu2(vsubus2(acc, bias2), _LO)
                    else:
                        if not side:
                            sums = []
                            for kt in (enc[:n0], enc[n0:]):
                                a = [np.zeros((tile_h, nq, 4), np.int64) for _ in range(2)]
                                for o_enc, wt in kt:
                                    for lane, v in enumerate(_halves(pair(o_enc))):
                                        a[lane] = a[lane] + wt * v.astype(np.int64)
                                sums.append(a)
                        lanes = []
                        for lane in range(2):
                            acc = np.asarray(sums[0][lane]).astype(f32)
                            if op.combine == "magnitude":
                                b = np.asarray(sums[1][lane]).astype(f32)
                                acc = np.sqrt((acc * acc + b * b).astype(np.float64)).astype(f32)
                            if scale != f32(1.0):
                                acc = acc * scale
                            lanes.append(_quantize2(acc, op.quantize).astype(np.int64))
                        res = _join(*lanes)
                all_filtered = op.edge_mode != "interior" or (
                    y0 + by > h and y0 + by + y_end - 1 <= global_h - 1 - h and x0 > h
                    and x0 + x_end - 1 <= W - 1 - h)
                if not all_filtered:
                    gy = y0 + by + ly
                    gx = x0 + 8 * q + 2 * j
                    keep_lo = (gx > h) & (gx <= W - 1 - h) & (gy > h) & (gy <= global_h - 1 - h)
                    keep_hi = (gx + 1 > h) & (gx + 1 <= W - 1 - h) & (gy > h) & (
                        gy <= global_h - 1 - h)
                    m = np.where(keep_lo, _U32(0xFFFF), _U32(0)) | np.where(
                        keep_hi, _U32(0xFFFF0000), _U32(0))
                    res = (res & m) | (cen & ~m)
                # every field holds a u8 value: the post-chain on pair words
                res = chain_fields(res, post_chain)
            # stores: eight bytes a thread, in pixel order, where the quad
            # lies in the plane (n = min(8, x_end - 8q) of them)
            lo, hi = _halves(res)
            pix = np.stack([lo, hi], axis=-1).reshape(tile_h, nq * 8)
            for r in range(y_end):
                n_pix = min(x_end, nq * 8)
                out[by + r, x0:x0 + n_pix] = pix[r, :n_pix]
                writes[by + r, x0:x0 + n_pix] += 1
    if writes.max() > 1:
        raise AssertionError("an output byte was written twice")
    out[writes == 0] = 0xFF
    return out
