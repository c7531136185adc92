"""Numpy replays of the kernels that read their windows through
window_load.cuh, block by block: stream_stencil.cu (K2, K2g, K3) and
fused_stage.cu (K4, K4g), and of K1's body (pointwise_run.cuh), run by run.

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

K4's replay (``emulate_stage``) follows fused_stage.cu the same way: the
host's tile shape and shared-memory layout, the stage table's stencil rows
as the kernel reads them, the clamped window rows as granules, four pixels
a step through the leading chain into buffer A, then per stencil the edge
fix of border blocks, the four-output strips over the region kept from
offset 0 of its buffer (reading the garbage past the region that the
kernel reads), the pointwise runs on whole words, and the store of the
tile's four-output strips through the trailing run (the kernel fuses the
last stencil with it; the values are the same). K1's
replay (``emulate_pointwise``) splits a launch as pw_split does and reads
each run's input as the kernel does: 16-byte words, or 4-byte words from
below the span and a funnel shift.

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


# --------------------------------------------------------------------------
# K1's body (pointwise_run.cuh)
# --------------------------------------------------------------------------


def _funnel_r(lo: int, hi: int, sh: int) -> int:
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF


def emulate_pointwise(pointwise, img: torch.Tensor, *, base: int = 0,
                      out_base: int = 0) -> torch.Tensor:
    """What one launch of K1's body writes for the chain `pointwise` over
    `img`, whose first byte lies `base` bytes past a 16-byte boundary (the
    output `out_base` bytes past one): the split of ``ck.pointwise_split``,
    the head and tail pixel by pixel, each body run's input read as the
    kernel reads it (uint4 words, or 4-byte words from below the span and a
    funnel shift), de-interleaved, run through the chain as 16 pixels, and
    stored as 16-byte words."""
    a = img.numpy()
    c_in = 1 if a.ndim == 2 else a.shape[2]
    c_out = ck.pointwise_program(list(pointwise), c_in)[1]
    n = a.shape[0] * a.shape[1]
    mem = _Memory()
    in_addr = mem.add(a, base)
    out_addr = (1 << 30) + out_base
    head, runs, tail, shift = ck.pointwise_split(in_addr, out_addr, n, c_in, c_out)
    assert head + 16 * runs + tail == n and head <= 16 and tail < 16 + 16
    out = np.full(n * c_out, 0x3C, dtype=np.uint8)
    written = np.zeros(n * c_out, dtype=np.int64)

    def chain(px: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(px.reshape(1, -1, c_in) if c_in == 3 else px.reshape(1, -1))
        res = ck.pointwise_group_plain(list(pointwise), t) if pointwise else t
        return res.numpy().reshape(-1)

    for p in list(range(head)) + list(range(head + 16 * runs, n)):
        px = mem.read(in_addr + p * c_in, c_in)
        out[p * c_out:(p + 1) * c_out] = chain(px)
        written[p * c_out:(p + 1) * c_out] += 1
    for t in range(runs):
        p0 = head + 16 * t
        src = in_addr + p0 * c_in
        assert src % 16 == shift and (out_addr + p0 * c_out) % 16 == 0
        if shift == 0:
            raw = mem.read(src, 16 * c_in)
        else:
            s4, sh = src & ~3, 8 * (src & 3)
            x = [int(v) for v in mem.read(s4, 16 * c_in + 4).view("<u4")]
            if not sh:
                x[-1] = 0  # the word past the span is not loaded
            words = [_funnel_r(x[k], x[k + 1], sh) for k in range(4 * c_in)]
            raw = np.asarray(words, dtype="<u4").view(np.uint8)
        o = p0 * c_out
        out[o:o + 16 * c_out] = chain(raw)
        written[o:o + 16 * c_out] += 1
    assert (written == 1).all(), "every output byte written exactly once"
    shape = a.shape[:2] if c_out == 1 else (*a.shape[:2], c_out)
    return torch.from_numpy(out.reshape(shape))


# --------------------------------------------------------------------------
# K4 and K4g (fused_stage.cu)
# --------------------------------------------------------------------------


def _finish(acc, desc, fam):
    """st_finish: scale (corr, magnitude, separable), quantize, then the
    clip of pw_to_u8."""
    v = acc
    if fam in ("corr", "magnitude", "separable") and F32(desc.scale) != 1:
        v = (v * F32(desc.scale)).astype(F32)
    v = np.floor(np.clip(v, 0, 255)) if desc.quantize == 0 else np.clip(np.rint(v), 0, 255)
    return np.clip(v, 0, 255).astype(np.uint8)


def _stage_stencil(A, B, F, n_planes, g, desc, P):
    """fs_stencil: the strips of one stencil from buffer A over region `g`
    into buffer B (and F for the row pass), all planes."""
    fam, emode = _FAMILY[desc.family], _EDGE[desc.edge_mode]
    h = desc.halo
    KS = 2 * h + 1
    o_rows, o_cols = g["rows"] - 2 * h, g["cols"] - 2 * h
    strips = (o_cols + 3) // 4
    Wc = 4 * strips
    assert strips >= 2 and o_rows * strips < 1 << 16
    nb = 4 * (-(-(4 + 2 * h) // 4))  # the words a strip row reads
    assert 4 * (strips - 1) + nb <= P, "a strip reads past the pitch"
    two_pass = fam in ("separable", "min", "max")
    ogy, ogx = g["gy0"] + h, g["gx0"] + h
    H, W = g["H"], g["W"]
    gy = ogy + np.arange(o_rows)[:, None]
    gx = ogx + np.arange(Wc)[None, :]
    if emode == "interior":
        filt = (gx > h) & (gx <= W - 1 - h) & (gy > h) & (gy <= H - 1 - h)
    else:
        filt = np.ones((o_rows, Wc), dtype=bool)
    w0, w1 = np.asarray(desc.w0, dtype=F32), np.asarray(desc.w1, dtype=F32)
    sep = np.asarray(desc.sep, dtype=F32)
    for c in range(n_planes):
        X = A[c].astype(F32)
        if two_pass:
            F[c, :g["rows"], :Wc] = _sep_taps([X[:g["rows"], k:k + Wc] for k in range(KS)], sep,
                                             fam)
            acc = _sep_taps([F[c, k:k + o_rows, :Wc] for k in range(KS)], sep, fam)
        elif fam == "median":
            assert KS in (3, 5)
            win = np.stack([X[dy:dy + o_rows, dx:dx + Wc] for dy in range(KS) for dx in range(KS)])
            acc = np.sort(win, axis=0)[KS * KS // 2]
        else:
            rws = [[X[dy:dy + o_rows, dx:dx + Wc] for dx in range(KS)] for dy in range(KS)]
            acc = _corr(rws, w0, KS)
            if fam == "magnitude":
                b = _corr(rws, w1, KS)
                sq = ((acc * acc).astype(F32) + (b * b).astype(F32)).astype(F32)
                acc = np.sqrt(sq.astype(np.float64)).astype(F32)
        center = A[c, h:h + o_rows, h:h + Wc]
        B[c, :o_rows, :Wc] = np.where(filt, _finish(acc, desc, fam), center)


def _edge_fix(A, n_planes, g, emode):
    """fs_edge_fix: the region's out-of-image positions from in-image ones
    of the same region (0 in interior and zero modes)."""
    rows, cols, gy0, gx0, H, W = g["rows"], g["cols"], g["gy0"], g["gx0"], g["H"], g["W"]
    lo_y, hi_y = max(0, -gy0), min(rows, H - gy0) - 1
    lo_x, hi_x = max(0, -gx0), min(cols, W - gx0) - 1
    assert lo_y <= hi_y and lo_x <= hi_x
    r, c = np.arange(rows), np.arange(cols)
    out_mask = ~(((r >= lo_y) & (r <= hi_y))[:, None] & ((c >= lo_x) & (c <= hi_x))[None, :])
    sy = np.clip([st_src(gy0 + i, H, emode) - gy0 for i in r], lo_y, hi_y)
    sx = np.clip([st_src(gx0 + j, W, emode) - gx0 for j in c], lo_x, hi_x)
    for p in range(n_planes):
        reg = A[p, :rows, :cols]
        vals = np.zeros_like(reg) if emode in ("interior", "zero") else reg[sy[:, None], sx[None, :]]
        reg[out_mask] = vals[out_mask]


def _planes_chain(pointwise, planes: np.ndarray) -> np.ndarray:
    """The chain on (n, rows, cols) u8 planes; returns (n', rows, cols)."""
    if not pointwise:
        return planes
    img = planes[0] if planes.shape[0] == 1 else planes.transpose(1, 2, 0)
    res = ck.pointwise_group_plain(list(pointwise), torch.from_numpy(np.ascontiguousarray(img)))
    res = res.numpy()
    return res[None] if res.ndim == 2 else res.transpose(2, 0, 1)


def emulate_stage(ops, img, tile_h: int | None = None, *, y0: int | None = None,
                  image_h: int | None = None, base: int = 0) -> np.ndarray:
    """What one K4 launch (or, with `y0` and `image_h`, one K4g launch)
    writes for the fused stage `ops` (VPU arms) over `img`, a numpy array:
    the whole image, or a (local_h + 2R, W[, 3]) extended tile whose row R
    is global row `y0` of an image `image_h` rows high. `base` offsets the
    input's address past a 16-byte boundary. A stage with no stencil is K1's
    body."""
    ops = tuple(ops)
    a = np.ascontiguousarray(img)
    c_in = 1 if a.ndim == 2 else a.shape[2]
    prog = ck.stage_program(ops, c_in)
    R, W = prog.halo, a.shape[1]
    if y0 is None:
        H, in_row0, in_rows, out_row0, out_rows = a.shape[0], 0, a.shape[0], 0, a.shape[0]
    else:
        H, in_row0, in_rows = image_h, y0 - R, a.shape[0]
        out_row0, out_rows = y0, a.shape[0] - 2 * R
    if prog.n_stencils == 0:
        return emulate_pointwise(list(ops), torch.from_numpy(a), base=base).numpy()
    table_ops = prog.table[:4 * prog.n_ops].reshape(-1, 4)
    descs = [row.st for row in prog.stencil_rows()]
    for k, op in enumerate(ops):
        if isinstance(op, ck.StencilOp):
            assert bytes(descs[table_ops[k, 0] - 100]) == bytes(ck.stencil_desc(op))
        else:
            assert table_ops[k, 0] == op.program[0]
            assert table_ops[k, 1:2].view(F32)[0] == F32(op.program[1])
    rows, cols = ck._fs_launch_shape(prog, out_rows, W, tile_h)
    assert cols in ck.FS_TILE_WIDTHS
    L = ck.fused_stage_layout(c_in, prog.c_smem, rows, cols, R, prog.table_bytes, prog.two_pass)
    assert L["total"] <= ck.MAX_SMEM_BYTES
    P, RP = L["pitch"], L["raw_pitch"]
    assert P % 4 == 0 and RP % 16 == 0 and L["a_off"] % 16 == 0 and L["f_off"] % 16 == 0
    eh, ew = rows + 2 * R, cols + 2 * R
    mem = _Memory()
    in_addr = mem.add(a, base)
    c_out = prog.c_out
    out = np.full(out_rows * W * c_out, 0x3C, dtype=np.uint8)
    written = np.zeros(out.size, dtype=np.int64)
    vec_store = W % 4 == 0
    first = next((k for k, op in enumerate(ops) if isinstance(op, ck.StencilOp)))
    gx_n, gy_n = ck.stencil_grid(out_rows, W, rows, cols)
    assert gy_n <= 65535
    for by in range(gy_n):
        for bx in range(gx_n):
            x0, ty0 = bx * cols, out_row0 + by * rows
            border = x0 - R < 0 or x0 + cols + R > W
            lo, hi = max(x0 - R, 0), min(x0 + cols + R, W)
            seg = (hi - lo) * c_in
            # 1. window rows, granules, the raw window
            raw = np.full((eh, RP), 0x5A, dtype=np.uint8)
            shifts = []
            ga = RP >> 4
            assert ga >= 2 and eh * ga < 1 << 16
            for r in range(eh):
                ar = ck.stage_row_source(r, ty0 - R, in_row0, in_rows)
                src, shift, grans = ck.row_granules(in_addr + (ar * W + lo) * c_in, seg)
                assert grans <= ga
                shifts.append(shift)
                for g16 in range(grans):
                    raw[r, 16 * g16:16 * g16 + 16] = mem.read(src + 16 * g16, 16)
            # 2. four pixels a step, the leading chain, buffer A
            gb = (ew + 3) >> 2
            assert eh * gb < 1 << 16
            pix = np.zeros((eh, 4 * gb, c_in), dtype=np.uint8)
            for r in range(eh):
                for q in range(4 * gb):
                    cx = x0 - R + min(q, ew - 1)
                    sx = min(max(cx, lo), hi - 1) if border else cx
                    pos = shifts[r] + (sx - lo) * c_in
                    assert 0 <= pos and pos + c_in <= RP
                    pix[r, q] = raw[r, pos:pos + c_in]
            A = np.full((prog.c_smem, eh, P), 0x5A, dtype=np.uint8)
            B = np.full_like(A, 0x5A)
            Fb = np.full(A.shape, np.nan, dtype=F32)
            lead = _planes_chain(ops[:first], pix.transpose(2, 0, 1))
            n_cur = lead.shape[0]
            A[:n_cur, :, :4 * gb] = lead
            # 3. the walk
            g = dict(rows=eh, cols=ew, gy0=ty0 - R, gx0=x0 - R, H=H, W=W)
            k = first
            while k < len(ops):
                desc = descs[table_ops[k, 0] - 100]
                h = desc.halo
                inside = (g["gy0"] >= 0 and g["gy0"] + g["rows"] <= H and g["gx0"] >= 0
                          and g["gx0"] + g["cols"] <= W)
                if h > 0 and not inside:
                    _edge_fix(A, n_cur, g, _EDGE[desc.edge_mode])
                _stage_stencil(A, B, Fb, n_cur, g, desc, P)
                A, B = B, A
                g = dict(g, rows=g["rows"] - 2 * h, cols=g["cols"] - 2 * h, gy0=g["gy0"] + h,
                         gx0=g["gx0"] + h)
                k += 1
                end = next((e for e in range(k, len(ops)) if isinstance(ops[e], ck.StencilOp)),
                           len(ops))
                if end == len(ops):
                    break
                if end > k:
                    Wc = 4 * ((g["cols"] + 3) // 4)
                    res = _planes_chain(ops[k:end], A[:n_cur, :g["rows"], :Wc])
                    n_cur = res.shape[0]
                    A[:n_cur, :g["rows"], :Wc] = res
                    k = end
            assert (g["rows"], g["cols"]) == (rows, cols)
            # 4. the store through the trailing run
            q = _planes_chain(ops[k:], A[:n_cur, :rows, :cols])
            assert q.shape[0] == c_out
            rows_out = min(rows, out_row0 + out_rows - ty0)
            cols_out = min(cols, W - x0)
            for ly in range(rows_out):
                for lx in range(0, cols, 4):
                    if lx >= cols_out:
                        continue
                    o = ((ty0 - out_row0 + ly) * W + x0 + lx) * c_out
                    n4 = 4 if vec_store and lx + 4 <= cols_out else min(4, cols_out - lx)
                    if vec_store:
                        assert o % 4 == 0
                    out[o:o + n4 * c_out] = q[:, ly, lx:lx + n4].T.reshape(-1)
                    written[o:o + n4 * c_out] += 1
    assert (written == 1).all(), "every output byte written exactly once"
    return out.reshape((out_rows, W) if c_out == 1 else (out_rows, W, c_out))
