"""A numpy replay of T1's stencil form (``ops/csrc/packed_stream.cu``) for
the CPU tests, block by block and chunk by chunk, following the kernel's
own index arithmetic:

* the host's launch shape (``pk.packed_tile_shape``: strips of tile_w
  words, runs of run_h rows walked in chunks of chunk_h) and grid;
* per chunk, the sources of the rows it loads (all window rows for the
  first chunk, the chunk_h new ones after it), resolved as StRows: the
  row source in full mode, the ghost strips in ghost mode; each row's
  16-byte granules read from made-up device addresses into one of
  RAW_SLOTS raw slots, PREFETCH chunks ahead of the one read, that keep
  whatever earlier chunks left there (planes and strips
  start at any word past a 16-byte boundary, ``bases``), the flat loop
  split by the high-multiply division;
* the window pass: per loaded row and window word one funnel shift of two
  raw words (column sources by st_src, clamped into the loaded words, in
  strips that touch a border), the chain, the words written into the ring
  of chunk_h + 2h rows and into its mirror past the end;
* the row pass of separable and min/max stencils into the float32 ring;
* four outputs a word: the column pass or the 2-D window read from the
  ring at one pitch, the finish, the interior passthrough at global
  coordinates, one word store per plane.

Bytes outside every buffer read as 0xA5, shared memory no step wrote as
0x5A (NaN in the float ring), so a stray read shows in the result; every
output word must be written exactly once.
"""

from __future__ import annotations

import numpy as np
import torch
from _torch_stencil_emulator import _EDGE, _FAMILY, F32, _corr, _Memory, _sep_taps, div, magic, \
    st_filtered, st_src

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _finish(acc, desc, fam):
    """st_finish on an array of accumulators, then pw_to_u8's clip."""
    v = acc
    if fam in ("corr", "magnitude", "separable") and F32(desc.scale) != 1:
        v = (v * F32(desc.scale)).astype(F32)
    v = np.floor(np.clip(v, 0, 255)) if desc.quantize == 0 else np.clip(np.rint(v), 0, 255)
    return np.clip(v, 0, 255)


def emulate_t1(pointwise, stencil, words, height, width, *, ghosts=None, y0=0, image_h=None,
               tile_w=None, run_h=None, chunk_h=None, bases=None) -> list[np.ndarray]:
    """What one T1 (or, with `ghosts`, T1g) launch writes for (height,
    width/4) int32 input planes `words` (numpy). `tile_w`, `run_h` and
    `chunk_h` override the host's shape; `bases[c]` is input plane c's
    word offset past a 16-byte boundary (its strips take the next two
    offsets)."""
    wp, W = width // 4, width
    n_in = len(words)
    n_ops = len(pointwise)
    n_out = ck.pointwise_program(list(pointwise), n_in)[1]
    desc = ck.stencil_desc(stencil)
    fam, emode = _FAMILY[desc.family], _EDGE[desc.edge_mode]
    h = stencil.halo
    KS = 2 * h + 1
    chunk_h = chunk_h or pk.CHUNK_H
    shape = pk.packed_tile_shape(height, wp)
    tw = tile_w or shape[0]
    rh = run_h or shape[1]
    assert tw in pk.TILE_WIDTHS and rh % chunk_h == 0 and 1 <= chunk_h <= pk.MAX_CHUNK_H
    bases = bases or [0] * n_in
    mem = _Memory()
    in_a = [mem.add(np.ascontiguousarray(w).view(np.uint8), 4 * bases[c])
            for c, w in enumerate(words)]
    if ghosts is not None:
        top_a = [mem.add(np.ascontiguousarray(t).view(np.uint8), 4 * ((bases[c] + 1) % 4))
                 for c, t in enumerate(ghosts[0])]
        bot_a = [mem.add(np.ascontiguousarray(b).view(np.uint8), 4 * ((bases[c] + 2) % 4))
                 for c, b in enumerate(ghosts[1])]
    else:
        image_h = height
    eh = chunk_h + 2 * h
    RB, RBM = eh, eh + 2 * h
    RP, P, FW = _round16(4 * tw + 24), _round16(4 * tw + 8), 4 * tw
    G = (4 * tw + 2 * h + 3) >> 2
    mg = magic(G)
    two_pass = fam in ("separable", "min", "max")
    sep = np.asarray(desc.sep, dtype=F32)
    w0s, w1s = np.asarray(desc.w0, dtype=F32), np.asarray(desc.w1, dtype=F32)
    gx_n, gy_n = pk.packed_grid(height, wp, tw, rh)
    assert gy_n <= 65535
    out = np.full((n_out, height, wp), 0xC3C3C3C3, dtype=np.uint32)
    written = np.zeros((n_out, height, wp), dtype=np.int64)
    lead = 8 * (4 - h)
    for by in range(gy_n):
        for bx in range(gx_n):
            w0, ry0 = bx * tw, by * rh
            ry1 = min(ry0 + rh, height)
            lo, hi = max(w0 - 1, 0), min(w0 + tw + 1, wp)
            border = w0 == 0 or w0 + tw + 1 > wp
            seg = 4 * (hi - lo)
            n_chunks = -(-(ry1 - ry0) // chunk_h)
            raw = [np.full((n_in * eh, RP), 0x5A, dtype=np.uint8) for _ in range(pk.RAW_SLOTS)]
            ring = np.full((n_out, RBM, P), 0x5A, dtype=np.uint8)
            fring = np.full((n_out, RBM, FW), np.nan, dtype=F32)
            slots = [None] * pk.ROW_SLOTS

            def resolve(k, y_base=ry0, stop=ry1, lo=lo, seg=seg):
                y = y_base + k * chunk_h
                first = 2 * h if k else 0
                nn = min(chunk_h, stop - y) + 2 * h - first
                entries = []
                for c in range(n_in):
                    for j in range(nn):
                        ty = y - h + first + j
                        if ghosts is None:
                            row = in_a[c] + st_src(ty, height, emode) * wp * 4
                        elif ty < 0:
                            row = top_a[c] + (h + ty) * wp * 4
                        elif ty >= height:
                            row = bot_a[c] + min(ty - height, h - 1) * wp * 4
                        else:
                            row = in_a[c] + ty * wp * 4
                        p = row + 4 * lo
                        entries.append((p - (p & 15), p & 15, ((p & 15) + seg + 15) >> 4))
                assert len(entries) <= n_in * eh
                slots[k % pk.ROW_SLOTS] = entries

            def fetch(k, raw=raw):
                entries = slots[k % pk.ROW_SLOTS]
                dst = raw[k % pk.RAW_SLOTS]
                ga = RP >> 4
                ma = magic(ga)
                assert len(entries) * ga < 1 << 16
                for i in range(len(entries) * ga):
                    r = div(i, ma)
                    g = i - r * ga
                    if g < entries[r][2]:
                        dst[r, 16 * g:16 * g + 16] = mem.read(entries[r][0] + 16 * g, 16)

            for k in range(min(pk.PREFETCH + 1, n_chunks)):
                resolve(k)
            for k in range(min(pk.PREFETCH, n_chunks)):
                fetch(k)
            for k in range(n_chunks):
                if k + pk.PREFETCH < n_chunks:
                    fetch(k + pk.PREFETCH)
                rk = slots[k % pk.ROW_SLOTS]
                if k + pk.PREFETCH + 1 < n_chunks:
                    resolve(k + pk.PREFETCH + 1)
                y = ry0 + k * chunk_h
                n = min(chunk_h, ry1 - y)
                first = 2 * h if k else 0
                nn = n + 2 * h - first
                base = (k * chunk_h) % RB
                src = raw[k % pk.RAW_SLOTS]
                # 1. the window pass: the loaded rows' window words
                win = np.zeros((nn, 4 * G, n_in), dtype=np.uint8)
                assert nn * G < 1 << 16
                for i in range(nn * G):
                    j = div(i, mg)
                    g = i - j * G
                    for c in range(n_in):
                        r = c * nn + j
                        shift = rk[r][1]
                        if not border:
                            o = shift + 4 * g
                            assert o % 4 == 0 and o + 8 <= RP
                            a, b = (int(v) for v in src[r, o:o + 8].view("<u4"))
                            word = ((b << 32 | a) >> lead) & 0xFFFFFFFF
                            win[j, 4 * g:4 * g + 4, c] = np.frombuffer(
                                word.to_bytes(4, "little"), dtype=np.uint8)
                        else:
                            for b in range(4):
                                cx = 4 * (w0 + g) - h + b
                                sx = min(max(st_src(cx, W, emode), 4 * lo), 4 * hi - 1)
                                assert shift + sx - 4 * lo < shift + seg <= RP
                                win[j, 4 * g + b, c] = src[r, shift + sx - 4 * lo]
                t = torch.from_numpy(win if n_in == 3 else win[..., 0])
                post = ck.pointwise_group_plain(list(pointwise), t).numpy() if n_ops else t.numpy()
                post = post.reshape(nn, 4 * G, n_out)
                pos_of = [(base + first + j) % RB for j in range(nn)]
                for j, pos in enumerate(pos_of):
                    assert base + first + j < 2 * RB
                    ring[:, pos, :4 * G] = post[j].T
                    if pos < 2 * h:
                        ring[:, pos + RB, :4 * G] = post[j].T
                # 2. the row pass into the float ring
                if two_pass:
                    for pos in pos_of:
                        f = ring[:, pos, :].astype(F32)
                        acc = _sep_taps([f[:, x:x + FW] for x in range(KS)], sep, fam)
                        fring[:, pos] = acc
                        if pos < 2 * h:
                            fring[:, pos + RB] = acc
                # 3. four outputs a word, one word store per plane
                for ly in range(n):
                    pos = (base + ly) % RB
                    assert base + ly < 2 * RB and pos + KS - 1 < RBM
                    gy = y + ly
                    for c in range(n_out):
                        rows = ring[c, pos:pos + KS].astype(F32)
                        if two_pass:
                            acc = _sep_taps([fring[c, pos + dy] for dy in range(KS)], sep, fam)
                        elif fam == "median":
                            stack = np.stack([rows[dy, dx:dx + FW] for dy in range(KS)
                                              for dx in range(KS)])
                            acc = np.sort(stack, axis=0)[KS * KS // 2]
                        else:
                            taps = [[rows[dy, dx:dx + FW] for dx in range(KS)] for dy in range(KS)]
                            acc = _corr(taps, w0s, KS)
                            if fam == "magnitude":
                                b = _corr(taps, w1s, KS)
                                sq = ((acc * acc).astype(F32) + (b * b).astype(F32)).astype(F32)
                                acc = np.sqrt(sq.astype(np.float64)).astype(F32)
                        center = rows[h, h:h + FW]
                        res = _finish(acc, desc, fam)
                        for s in range(tw):
                            gw = w0 + s
                            if gw >= wp:
                                continue
                            word = 0
                            for j in range(4):
                                gx = 4 * gw + j
                                filt = (st_filtered(gy, gx, height, W, h, emode) if ghosts is None
                                        else st_filtered(y0 + gy, gx, image_h, W, h, emode))
                                v = res[4 * s + j] if filt else center[4 * s + j]
                                assert not np.isnan(v), "a read of the float ring no pass wrote"
                                word |= int(v) << (8 * j)
                            out[c, gy, gw] = word
                            written[c, gy, gw] += 1
    assert (written == 1).all(), "every output word written exactly once"
    return [o.view(np.int32) for o in out]
