"""A CPU emulation of the fused-stage CUDA kernel's algorithm
(``ops/csrc/fused_stage.cu``), tile by tile, for the port's tests: K4 over a
whole image and K4g over an extended shard tile."""

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import F32, StencilOp, chain_halo


def emulate_k4(ops, img: np.ndarray, tile_h: int, *, y0: int | None = None,
               image_h: int | None = None) -> np.ndarray:
    """fused_stage.cu's algorithm on the CPU, tile by tile: window load with
    clamped indices, leading pointwise ops, per stencil the edge fix of the
    out-of-image window positions (sources clamped into the in-image part
    of the window) and the stencil over the shrunk window into the other
    buffer, pointwise runs in place, and the store through the trailing
    run. Unwritten buffer positions hold a marker, so a read of one shows.

    Full mode (K4): `img` is the whole image. Ghost mode (K4g, `y0` and
    `image_h` given): `img` is a (local_h + 2R, W) extended tile whose row R
    is global row `y0` of an image `image_h` rows high; window rows are laid
    out in global coordinates, read from array row `global - (y0 - R)`, and
    are out of image by their global row."""
    R, tw = chain_halo(ops), ck.TILE_W
    W = img.shape[1]
    if y0 is None:
        H, in_row0, in_rows, out_row0, out_rows = img.shape[0], 0, img.shape[0], 0, img.shape[0]
    else:
        H, in_row0, in_rows = image_h, y0 - R, img.shape[0]
        out_row0, out_rows = y0, img.shape[0] - 2 * R
    eh, ew = tile_h + 2 * R, tw + 2 * R
    x = torch.from_numpy(img)
    first = next((k for k, op in enumerate(ops) if isinstance(op, StencilOp)), len(ops))
    out = None
    for y0 in range(out_row0, out_row0 + out_rows, tile_h):  # global row of the tile
        for x0 in range(0, W, tw):
            rows = np.clip(np.arange(y0 - R, y0 - R + eh) - in_row0, 0, in_rows - 1)
            cols = np.clip(np.arange(x0 - R, x0 - R + ew), 0, W - 1)
            a = x[rows][:, cols]
            for op in ops[:first]:
                a = op(a)
            off, k = 0, first
            while k < len(ops):
                st = ops[k]
                h = st.halo
                planes = [a] if a.ndim == 2 else [a[..., c] for c in range(a.shape[2])]
                lo_y, hi_y = max(off, R - y0), min(eh - off, H - y0 + R) - 1
                lo_x, hi_x = max(off, R - x0), min(ew - off, W - x0 + R) - 1
                if h:
                    def src(wc, y_axis):
                        g0, n, lo, hi = (y0, H, lo_y, hi_y) if y_axis else (x0, W, lo_x, hi_x)
                        if lo <= wc <= hi:
                            return wc
                        s = ck.edge_src(g0 - R + wc, n, st.edge_mode)
                        return None if s is None else min(max(s - g0 + R, lo), hi)
                    sy = [src(r, True) for r in range(eh)]
                    sx = [src(c, False) for c in range(ew)]
                    r_idx, c_idx = torch.arange(eh)[:, None], torch.arange(ew)[None, :]
                    fix = ((r_idx >= off) & (r_idx < eh - off) & (c_idx >= off)
                           & (c_idx < ew - off)
                           & ~((r_idx >= lo_y) & (r_idx <= hi_y) & (c_idx >= lo_x)
                               & (c_idx <= hi_x)))
                    zero = torch.tensor([v is None for v in sy])[:, None] | torch.tensor(
                        [v is None for v in sx])[None, :]
                    rows_src = torch.tensor([0 if v is None else v for v in sy])
                    cols_src = torch.tensor([0 if v is None else v for v in sx])
                    planes = [
                        torch.where(fix, torch.where(zero, 0, p[rows_src][:, cols_src]), p)
                        .to(p.dtype)
                        for p in planes
                    ]
                o = off + h
                new = []
                for p in planes:
                    q = torch.full_like(p, 77)
                    xin = p[off:eh - off, off:ew - off].to(F32)
                    acc = st.valid(xin)
                    orig = xin[h:xin.shape[0] - h, h:xin.shape[1] - h]
                    res = st.finalize_f32(acc, orig, y0 - R + o, x0 - R + o, H, W)
                    q[o:eh - o, o:ew - o] = res.to(torch.uint8)
                    new.append(q)
                a = new[0] if len(new) == 1 else torch.stack(new, dim=-1)
                off, k = o, k + 1
                while k < len(ops) and not isinstance(ops[k], StencilOp):
                    a = ops[k](a)
                    k += 1
            tile = a[R:R + tile_h, R:R + tw]
            if out is None:
                out = torch.zeros((out_rows, W) + tuple(tile.shape[2:]), dtype=torch.uint8)
            hh, ww = min(tile_h, out_row0 + out_rows - y0), min(tw, W - x0)
            out[y0 - out_row0:y0 - out_row0 + hh, x0:x0 + ww] = tile[:hh, :ww]
    return out.numpy()
