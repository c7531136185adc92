"""A numpy replay of stream_stencil.cu (K2, K2g, K3), block by block.

It follows the kernel's own index arithmetic, so that the CPU tests can hold
the tiling against the plain versions before any card runs it:

* the host's launch shape (``ck.stencil_launch_shape``) and grid;
* per block: the window rows' sources (the row source in full mode, the
  ghost strips otherwise), each row's 16-byte aligned granules at made-up
  device addresses (``base`` offsets the buffers, so that rows start at
  every alignment), the flat loops split by the high-multiply division;
* the raw window, then four pixels per step through the column source
  (border blocks only) and the pointwise chain into u8 planes;
* four adjacent outputs per step: the row pass into float32 rows, the
  column pass or the 2-D window, each output's taps in stencil.cuh's order
  with float32 IEEE steps, the passthrough, the quantizer, and the stores,
  as words where the row pitch allows.

Bytes outside every buffer read as 0xA5, shared memory no step wrote as
0x5A, so a stray read shows in the result. Every output byte must be
written exactly once.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import MEDIAN_NETWORKS

F32 = np.float32
_FAMILY = {v: k for k, v in ck._FAMILIES.items()}
_EDGE = {v: k for k, v in ck._EDGE_MODES.items()}


def magic(d: int) -> int:
    """st_magic: floor(2^32 / d) + 1 in 32 bits (2^32 / d for a power of two)."""
    return (0xFFFFFFFF // d + 1) & 0xFFFFFFFF


def div(n: int, m: int) -> int:
    """st_div: the high 32 bits of n * m."""
    return (n * m) >> 32


def st_src(c: int, n: int, mode: str) -> int:
    if mode == "reflect101" and (c < 0 or c >= n):
        c = -c if c < 0 else 2 * (n - 1) - c
    return min(max(c, 0), n - 1)


def st_filtered(gy, gx, H, W, h, mode) -> bool:
    if mode != "interior":
        return True
    return h < gx <= W - 1 - h and h < gy <= H - 1 - h


class _Memory:
    """Device buffers at made-up addresses; reads outside them give 0xA5."""

    def __init__(self):
        self.buffers = []  # (start, bytes)

    def add(self, data: np.ndarray, base: int) -> int:
        start = (self.buffers[-1][0] + len(self.buffers[-1][1]) + 4096) & ~4095 if self.buffers \
            else 1 << 20
        start += base
        self.buffers.append((start, np.ascontiguousarray(data).reshape(-1)))
        return start

    def read(self, addr: int, n: int) -> np.ndarray:
        out = np.full(n, 0xA5, dtype=np.uint8)
        for start, buf in self.buffers:
            lo, hi = max(addr, start), min(addr + n, start + len(buf))
            if lo < hi:
                out[lo - addr:hi - addr] = buf[lo - start:hi - start]
        return out


def _sep_taps(vals, weights, family):
    """st_tap4 over taps k (vals[k] is an array of lanes): separable sums
    with zero taps skipped and the first nonzero tap starting the sum, or
    a min/max reduction."""
    acc = np.zeros_like(vals[0])
    first = True
    for k, v in enumerate(vals):
        if family == "separable":
            wt = F32(weights[k])
            if wt == 0:
                continue
            t = v if wt == 1 else (v * wt).astype(F32)
            acc = t if first else (acc + t).astype(F32)
        else:
            acc = v if first else (np.minimum(acc, v) if family == "min" else np.maximum(acc, v))
        first = False
    return acc


def _corr(rows, w, KS):
    """st_strip_window's sum: rows[dy][b] lanes of window bytes as f32."""
    acc = np.zeros_like(rows[0][0])
    first = True
    for dy in range(KS):
        for dx in range(KS):
            wt = F32(w[dy * KS + dx])
            if wt == 0:
                continue
            v = rows[dy][dx]
            t = v if wt == 1 else (v * wt).astype(F32)
            acc = t if first else (acc + t).astype(F32)
            first = False
    return acc


def emulate(pointwise, stencil, img: torch.Tensor, *, mode: str = "full", top=None, bottom=None,
            row0: int = 0, image_h: int | None = None, tile_h: int | None = None,
            base: int = 0) -> torch.Tensor:
    """What one launch writes. `mode` is 'full' (K2: `img` is the image),
    'ghost' (K2g: `img` is the shard tile, `top`/`bottom` its strips,
    `row0` its first global row of `image_h`) or 'tile' (K3: `img` is the
    pre-extended tile, no chain)."""
    a = img.numpy()
    c_in = 1 if a.ndim == 2 else a.shape[2]
    desc = ck.stencil_desc(stencil)
    h = stencil.halo
    KS = 2 * h + 1
    fam = _FAMILY[desc.family]
    emode = _EDGE[desc.edge_mode]
    if mode == "tile":
        pointwise = []
    chain = ck.pointwise_program(list(pointwise), c_in)
    c_out = chain[1]
    n_ops = len(pointwise)
    W = a.shape[1]
    mem = _Memory()
    if mode == "tile":
        H = a.shape[0] - 2 * h
        ext = mem.add(a, base)
        in_ = ext + h * W * c_in
        top_a, bot_a = ext, ext + (h + H) * W * c_in
        image_h = H
    else:
        H = a.shape[0]
        in_ = mem.add(a, base)
        if mode == "ghost":
            top_a = mem.add(top.numpy(), (base + 3) % 16)
            bot_a = mem.add(bottom.numpy(), (base + 7) % 16)
        else:
            image_h = H
    rows, cols = ck.stencil_launch_shape(H, W, c_in, c_out, h, desc.family, n_ops, tile_h)
    assert cols in ck.ST_TILE_WIDTHS
    eh, ew = rows + 2 * h, cols + 2 * h
    P = -(-ew // 16) * 16
    RP = -(-(ew * c_in + 15) // 16) * 16
    strips = cols // 4
    two_pass = fam in ("separable", "min", "max")
    out = np.full(H * W * c_out, 0x3C, dtype=np.uint8)
    written = np.zeros(H * W * c_out, dtype=np.int64)
    vec_store = W % 4 == 0  # outputs are fresh allocations: 4-aligned
    gx_n, gy_n = ck.stencil_grid(H, W, rows, cols)
    assert gy_n <= 65535
    sep = np.asarray(desc.sep, dtype=F32)
    w0, w1 = np.asarray(desc.w0, dtype=F32), np.asarray(desc.w1, dtype=F32)
    for by in range(gy_n):
        for bx in range(gx_n):
            x0, y0 = bx * cols, by * rows
            border = x0 - h < 0 or x0 + cols + h > W
            sx_lo, sx_hi = max(x0 - h, 0), min(x0 + cols + h, W)
            seg = (sx_hi - sx_lo) * c_in
            # 0. row sources
            srcs, shifts, grans = [], [], []
            for r in range(eh):
                ty = y0 + r - h
                if mode == "full":
                    row = in_ + st_src(ty, H, emode) * W * c_in
                elif h > 0 and ty < 0:
                    row = top_a + (h + ty) * W * c_in
                elif h > 0 and ty >= H:
                    row = bot_a + min(ty - H, h - 1) * W * c_in
                else:
                    row = in_ + min(ty, H - 1) * W * c_in
                p = row + sx_lo * c_in
                shifts.append(p & 15)
                srcs.append(p - (p & 15))
                grans.append(((p & 15) + seg + 15) >> 4)
            # 1. raw window, granule by granule
            raw = np.full((eh, RP), 0x5A, dtype=np.uint8)
            ga = RP >> 4
            assert 2 <= ga and eh * ga < 1 << 16
            ma = magic(ga)
            for i in range(eh * ga):
                r = div(i, ma)
                g = i - r * ga
                if g < grans[r]:
                    raw[r, 16 * g:16 * g + 16] = mem.read(srcs[r] + 16 * g, 16)
            # 2. four pixels per step into the planes
            planes = np.full((c_out, eh, P), 0x5A, dtype=np.uint8)
            gb = (ew + 3) >> 2
            assert eh * gb < 1 << 16
            mb = magic(gb)
            pix = np.zeros((eh, 4 * gb, c_in), dtype=np.uint8)
            zero = np.zeros((eh, 4 * gb), dtype=bool)
            for i in range(eh * gb):
                r = div(i, mb)
                g = i - r * gb
                for j in range(4):
                    cx = x0 - h + min(4 * g + j, ew - 1)
                    sx = min(max(st_src(cx, W, emode), sx_lo), sx_hi - 1) if border else cx
                    p = shifts[r] + (sx - sx_lo) * c_in
                    assert 0 <= p and p + c_in <= RP
                    pix[r, 4 * g + j] = raw[r, p:p + c_in]
                    zero[r, 4 * g + j] = (mode == "tile" and emode in ("zero", "interior")
                                          and border and (cx < 0 or cx >= W))
            t = torch.from_numpy(pix if c_in == 3 else pix[..., 0])
            post = ck.pointwise_group_plain(list(pointwise), t).numpy() if n_ops else t.numpy()
            post = post.reshape(eh, 4 * gb, c_out)
            post = np.where(zero[..., None], 0, post)
            planes[:, :, :4 * gb] = post.transpose(2, 0, 1)
            # 3a. row pass, four values per step
            if two_pass:
                s_row = np.full((c_out, eh, cols), np.nan, dtype=F32)
                for s in range(strips):
                    taps = [planes[:, :, 4 * s + k:4 * s + k + 4].astype(F32) for k in range(KS)]
                    s_row[:, :, 4 * s:4 * s + 4] = _sep_taps(taps, sep, fam)
            # 3b. four adjacent outputs per step
            for ly in range(rows):
                gy = y0 + ly
                if gy >= H:
                    continue
                for s in range(strips):
                    lx = 4 * s
                    gx = x0 + lx
                    if gx >= W:
                        continue
                    q = np.zeros((c_out, 4), dtype=np.uint8)
                    for c in range(c_out):
                        win = planes[c, ly:ly + KS, lx:lx + 4 + KS - 1].astype(F32)
                        if two_pass:
                            acc = _sep_taps([s_row[c, ly + k, lx:lx + 4] for k in range(KS)],
                                            sep, fam)
                        elif fam == "median":
                            pairs = MEDIAN_NETWORKS[KS][0]
                            assert len(pairs) and KS in (3, 5)
                            acc = np.array([np.sort(win[:, j:j + KS].reshape(-1))[KS * KS // 2]
                                            for j in range(4)], dtype=F32)
                        else:
                            rws = [[win[dy, dx:dx + 4] for dx in range(KS)] for dy in range(KS)]
                            acc = _corr(rws, w0, KS)
                            if fam == "magnitude":
                                b = _corr(rws, w1, KS)
                                sq = ((acc * acc).astype(F32) + (b * b).astype(F32)).astype(F32)
                                acc = np.sqrt(sq.astype(np.float64)).astype(F32)
                        for j in range(4):
                            filt = mode == "tile" or (
                                st_filtered(gy, gx + j, H, W, h, emode) if mode == "full"
                                else st_filtered(row0 + gy, gx + j, image_h, W, h, emode))
                            if filt:
                                v = acc[j]
                                if fam in ("corr", "magnitude", "separable") and desc.scale != 1:
                                    v = F32(v * F32(desc.scale))
                                v = (np.floor(np.clip(v, 0, 255)) if desc.quantize == 0
                                     else np.clip(np.rint(v), 0, 255))
                            else:
                                v = win[h, j + h]
                            q[c, j] = int(np.clip(v, 0, 255))
                    o = (gy * W + gx) * c_out
                    if vec_store:
                        assert o % 4 == 0
                        span = 4 * c_out
                        out[o:o + span] = q.T.reshape(-1)
                        written[o:o + span] += 1
                    else:
                        for j in range(4):
                            if gx + j >= W:
                                break
                            out[o + j * c_out:o + (j + 1) * c_out] = q[:, j]
                            written[o + j * c_out:o + (j + 1) * c_out] += 1
    assert (written == 1).all(), "every output byte written exactly once"
    shape = (H, W) if c_out == 1 else (H, W, c_out)
    return torch.from_numpy(out.reshape(shape))
