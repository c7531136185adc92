// The window loader shared by the stream-stencil kernel (stream_stencil.cu:
// K2, K2g, K3) and the fused plan-stage megakernel (fused_stage.cu: K4,
// K4g).
//
// Each window row's source is resolved once per block (StRow: the 16-byte
// aligned address of its first granule, the shift from there to the row's
// first window byte, the granule count); warps then copy whole row
// segments as 16-byte cp.async granules into a raw staging buffer. Rows
// start at any byte (RGB rows, shard views): whole granules from the
// aligned address below the row, the shift carried to the de-interleave.
// The flat loops split their index with a high multiply by a per-block
// constant, not a division.

#pragma once

#include <stdint.h>

#include "stencil.cuh"

// One window row's source, resolved once per block. 16 bytes.
struct StRow {
  const unsigned char* src;
  int shift;
  int granules;
};

__host__ __device__ inline size_t st_round16(size_t x) { return (x + 15) & ~(size_t)15; }

// floor(n / d) as one high multiply by m = st_magic(d): exact for
// n < 2^16 and 2 <= d <= 2^16 (m = floor(2^32 / d) + 1, or 2^32 / d for a
// power of two); the host keeps every loop's n below 2^16.
__device__ __forceinline__ unsigned st_magic(unsigned d) { return 0xFFFFFFFFu / d + 1u; }
__device__ __forceinline__ unsigned st_div(unsigned n, unsigned m) { return __umulhi(n, m); }

__device__ __forceinline__ void st_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The row segment of `seg` bytes that starts at `p`, as whole granules.
__device__ __forceinline__ StRow st_row_at(const unsigned char* p, int seg) {
  const int shift = (int)((uintptr_t)p & 15);
  return StRow{p - shift, shift, (shift + seg + 15) >> 4};
}

// The modes of the stream-stencil kernel, a template parameter so that
// each compiles without the others' branches: the whole image (K2), one
// row-shard with ghost strips (K2g), a pre-extended tile (K3).
enum StMode { ST_FULL = 0, ST_GHOST = 1, ST_TILE = 2 };

// The column bounds of tile column `x0`: the columns the window needs
// from the image, all of them in a tile that touches no border, else the
// part inside the image (border columns then take their value from an
// in-image column: the edge mode's source in K2, any in K4, whose edge fix
// rewrites them).
struct StCols {
  bool border;
  int lo;
  int hi;
};

__device__ __forceinline__ StCols st_cols(int x0, int tile_w, int h, int W) {
  return StCols{x0 - h < 0 || x0 + tile_w + h > W, max(x0 - h, 0), min(x0 + tile_w + h, W)};
}

// K2's window rows for the tile at (x0, y0): the row source in full mode;
// in the ghost modes the strips (rows past a strip feed only outputs below
// the tile, which are not stored). Threads < eh write one.
template <int MODE, int THREADS>
__device__ __forceinline__ void st_row_sources(StRow* rows, int eh, int h, int x0, int y0,
                                               int tile_w, const unsigned char* in,
                                               const unsigned char* top,
                                               const unsigned char* bot, int H, int W,
                                               int c_in, int edge_mode) {
  const StCols cols = st_cols(x0, tile_w, h, W);
  const int seg = (cols.hi - cols.lo) * c_in;
  for (int r = threadIdx.x; r < eh; r += THREADS) {
    const int ty = y0 + r - h;  // row of the image (full) or of the tile
    const unsigned char* row;
    if (MODE == ST_FULL) {
      row = in + (long long)st_src(ty, H, edge_mode) * W * c_in;
    } else if (h > 0 && ty < 0) {
      row = top + (long long)(h + ty) * W * c_in;
    } else if (h > 0 && ty >= H) {
      row = bot + (long long)min(ty - H, h - 1) * W * c_in;
    } else {
      row = in + (long long)min(ty, H - 1) * W * c_in;
    }
    rows[r] = st_row_at(row + (long long)cols.lo * c_in, seg);
  }
}

// K4's window rows: window row r is global row `g0 + r`, read from array
// row `g0 + r - in_row0` of an array of `in_rows` rows, clamped into it
// (rows outside the image take their value from the first stencil's edge
// fix; rows past the array feed only outputs that are not stored).
template <int THREADS>
__device__ __forceinline__ void st_row_sources_clamped(StRow* rows, int eh, int g0, int in_row0,
                                                       int in_rows, const StCols& cols,
                                                       const unsigned char* in, int W,
                                                       int c_in) {
  const int seg = (cols.hi - cols.lo) * c_in;
  for (int r = threadIdx.x; r < eh; r += THREADS) {
    const int ar = min(max(g0 + r - in_row0, 0), in_rows - 1);
    rows[r] = st_row_at(in + ((long long)ar * W + cols.lo) * c_in, seg);
  }
}

// Issues the cp.async granules of a tile's raw window (its rows' sources
// in `rows`, `rp` bytes a row); the caller commits the group.
template <int THREADS>
__device__ __forceinline__ void st_load_window(unsigned char* raw, const StRow* rows, int eh,
                                               int rp) {
  const unsigned ga = rp >> 4;
  const unsigned ma = st_magic(ga);
  for (unsigned i = threadIdx.x; i < (unsigned)eh * ga; i += THREADS) {
    const unsigned r = st_div(i, ma);
    const unsigned g = i - r * ga;
    if ((int)g < rows[r].granules) st_cp_async16(raw + r * rp + 16 * g, rows[r].src + 16 * g);
  }
}

__device__ __forceinline__ void st_load_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}
