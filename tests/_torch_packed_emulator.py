"""A numpy replay of T1's tiling (``ops/csrc/packed_stream.cu``) for the
CPU tests: block by block, the window the kernel loads (rows by
``window_row_source``, words and their bytes by ``window_word_sources``),
the chain on the window's pixels, the stencil over the window's valid part,
the interior passthrough at global coordinates, and the store of the
block's words that lie inside the image. The arithmetic is the golden ops'
(the kernel's is stencil.cuh's, held equal on the card); what this replays
is where every byte comes from and goes to.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import F32
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk


def _bytes(words: np.ndarray) -> np.ndarray:
    """(rows, Wp) int32 -> (rows, 4 Wp) u8, byte k of word j at 4j + k."""
    return np.ascontiguousarray(words).view(np.uint8).reshape(words.shape[0], -1)


def emulate_t1(pointwise, stencil, words, height, width, *, tile_h,
               ghosts=None, y0=0, image_h=None) -> list[np.ndarray]:
    """T1's output word planes for (height, width/4) int32 input planes
    `words` (numpy), computed block by block as the kernel's grid does."""
    wp = width // 4
    n_in = len(words)
    src = [_bytes(w) for w in words]
    tops = [_bytes(t) for t in ghosts[0]] if ghosts else None
    bots = [_bytes(b) for b in ghosts[1]] if ghosts else None
    n_out = ck._channels_after(pointwise, n_in)
    out = [np.zeros((height, wp), np.int32) for _ in range(n_out)]
    h = stencil.halo if stencil is not None else 0
    eh = tile_h + 2 * h
    win_words = pk.WIN_WORDS if stencil is not None else pk.TILE_WORDS
    first = -1 if stencil is not None else 0
    n_bx, n_by = pk.packed_grid(height, wp, tile_h)
    for by in range(n_by):
        for bx in range(n_bx):
            w0, row0 = bx * pk.TILE_WORDS, by * tile_h
            window = np.zeros((eh, 4 * win_words, n_in), np.uint8)
            for wy in range(eh):
                ty = row0 + wy - h
                if stencil is None:
                    where, r = "image", min(ty, height - 1)
                else:
                    where, r = pk.window_row_source(ty, height, h, stencil.edge_mode,
                                                    ghosts is not None)
                rows = {"image": src, "tile": src, "top": tops, "bottom": bots}[where]
                for ww in range(win_words):
                    gw = w0 + ww + first
                    if stencil is None:
                        cols = [min(4 * gw + k, width - 1) for k in range(4)]
                    else:
                        cols = pk.window_word_sources(gw, wp, stencil.edge_mode)
                    for c in range(n_in):
                        window[wy, 4 * ww: 4 * ww + 4, c] = rows[c][r, cols]
            img = torch.from_numpy(window if n_in > 1 else window[..., 0])
            post = ck.pointwise_group_plain(list(pointwise), img) if pointwise else img
            planes = [post] if post.ndim == 2 else [post[..., c] for c in range(n_out)]
            for c, plane in enumerate(planes):
                if stencil is None:
                    tile = plane.numpy()
                else:
                    cols = slice(4 - h, 4 - h + 4 * pk.TILE_WORDS + 2 * h)
                    acc = stencil.valid(plane[:, cols].to(F32))
                    center = plane[h: h + tile_h, 4: 4 + 4 * pk.TILE_WORDS]
                    gy0 = row0 + (y0 if ghosts is not None else 0)
                    tile = stencil.finalize(acc, center, gy0, 4 * w0,
                                            image_h if ghosts is not None else height,
                                            width).numpy()
                rows_here = min(tile_h, height - row0)
                words_here = min(pk.TILE_WORDS, wp - w0)
                block = np.ascontiguousarray(tile[:rows_here, : 4 * words_here])
                out[c][row0: row0 + rows_here, w0: w0 + words_here] = (
                    block.view(np.int32).reshape(rows_here, words_here))
    return out
