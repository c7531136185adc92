// K6, K7 and K8: the SWAR stencil kernels, each in a full-image mode and a
// ghost mode over one row-shard. One kernel template, one entry point.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py
//           K6: make_swar_stencil (kernel :487), the separable integer
//               stencil in its narrow and wide modes;
//           K7: make_swar_corr2d (kernel :899), the signed integer 2-D
//               correlation over biased 16-bit fields;
//           K8: make_swar_corr2d_wide (kernel :731), the rest of the
//               correlation class on one pixel per 32-bit lane;
//           each with the fused affine pre- and post-chains, and ghost
//           mode as swar_stencil(ghosts=, y0=, global_h=) runs them for
//           the sharded runner (parallel/api.py _apply_group_swar).
// Computes: one stencil on a single u8 plane with integer taps, exactly:
//           * pre-chain on every loaded pixel (pad and ghost pixels too):
//             x -> min(max(A * x - C, 0) >> m, 255), x = 255 - p when neg;
//           * K6 narrow: a row and a column pass on 16-bit fields, two
//             pixels per 32-bit register (sums <= 255 * S^2 <= 65280),
//             then q = (s + (2^(k-1) - 1) + ((s >> k) & 1)) >> k, the
//             integer round-half-even of s / S^2;
//           * K6 wide: the row pass on fields (<= 255 * S <= 32640), the
//             column pass on i32 lanes, then the golden float32 replay
//             rint(f32(s) * scale) and the clip;
//           * K7: bias + sum(w * x) per field with bias = 255 * sum|w < 0|,
//             so no field ends negative or past 2^15, then
//             min(max(acc - bias, 0), 255) by per-halfword intrinsics;
//           * K8: signed i32 sums per lane, the combine (single, or
//             __fsqrt_rn of a0^2 + a1^2), the scale and the quantizer in
//             IEEE float32 (built with -fmad=false);
//           * the reference guard of interior-mode ops (K7, K8) at global
//             coordinates: outside the interior the pre-chained centre
//             pixel passes through; then the post-chain.
//           Ghost mode takes the rows above and below a (local_h, W) tile
//           from two raw (halo, W) strips and follows the guard in global
//           rows (row0, image_h).
// Bound on the H100: device memory. Each pixel is read once and written
//           once (1 B + 1 B): an 8K gray plane (33.18 MP) cannot take less
//           than 19.8 us at 3.35 TB/s, one 1080 x 7680 shard 5.0 us. The
//           integer work (one multiply-add per pixel pair and tap) is far
//           below the card's operation rates.
// Design:   the TPU kernel walks row blocks in order, carrying the previous
//           block's fields in scratch memory, and packs the padded plane
//           into quarter-strip words in a pass of its own. Here a 2-D grid
//           of independent output tiles (tile_w columns x tile_h rows, 256
//           threads) each loads its own window with a halo of h rows and
//           columns. Two neighbouring pixels share a 32-bit word as 16-bit
//           fields: the window is kept in shared memory as pre-chained words
//           of pixels (2i, 2i+1); a pair at an odd offset is a funnel shift
//           of two neighbouring words. The first design (one pair word a
//           thread built from two one-byte loads, each through a per-pixel
//           edge branch; one output pair a thread from a run-time tap loop
//           with a sign branch; two-byte stores; 128 x 32 tiles whatever the
//           plane) ran K7 at 8% of its bound. This one takes over what K2's
//           and K4's redesigns proved:
//           - Tile shape from the work (ops/swar_kernels.swar_tile_shape):
//             taller tiles for larger halos, columns narrowed to 64 until the
//             grid fills the 132 SMs.
//           - Window load through K2's loader (window_load.cuh): each window
//             row's source resolved once per block (the array row, the
//             ghost strip row, or a row of zeros), whole row segments copied
//             as 16-byte cp.async granules into a raw staging buffer; edges
//             resolved only in blocks whose window leaves the image, a branch
//             uniform over the block; then four pair words (8 pixels) a
//             thread from word reads and funnel shifts, each pre-chain step
//             dispatched once for the four, stored as one 16-byte word.
//           - Four output pairs (8 pixels) a thread. K7 of at most 7x7 runs
//             one instantiation per kernel side with its taps as kernel
//             parameters (SwarTaps): each window row's 4 + h words are read
//             once into registers (two 16-byte shared loads), the odd-offset
//             pairs are funnel shifts of registers, and every tap is one
//             multiply-add per pair word by the signed weight: the sum is
//             linear modulo 2^32 and each field's result lies in [0, 2^15),
//             so bias + sum(w * x) is the same word as (bias + P) - N with
//             no sign branch. Larger K7 kernels, and K8, run the tap table
//             from shared memory, four pairs a thread.
//           - The interior guard hoisted out of blocks whose outputs all lie
//             inside the interior, at global coordinates.
//           - Stores: the four pairs' bytes gathered by byte permutes, one
//             8-byte store where the row pitch and address allow, 4-byte
//             ones else, bytes only at the ragged edge.
//           K6 keeps its row pass in shared memory for the column pass. The
//           chains and the taps, of any length, come from a table in device
//           memory that the host builds once per group; each block copies
//           it into shared memory ahead of its window.

#include <stdint.h>

#include "device_scope.cuh"
#include "pointwise.cuh"
#include "window_load.cuh"

#define SW_THREADS 256
#define SW_MAX_K 7  // the largest K7 kernel side with taps as kernel parameters
#define SW_MAX_DEVICES 16

enum SwKind { SW_K6_NARROW = 0, SW_K6_WIDE = 1, SW_K7 = 2, SW_K8 = 3 };
enum SwEdge {
  SW_EDGE_INTERIOR = 0,
  SW_EDGE_REFLECT101 = 1,
  SW_EDGE_EDGE = 2,
  SW_EDGE_ZERO = 3,
};

// One SWAR stencil with its fused chains (ops/swar_kernels.swar_desc
// builds it and its table; runtime/kernels.SwarDesc has the same layout).
struct SwarDesc {
  int kind;       // SwKind
  int halo;
  int edge_mode;  // SwEdge
  int quantize;   // K8: 0 trunc_clip, 1 rint_clip
  int combine;    // K8: 0 single, 1 magnitude
  int interior;   // K7, K8: the reference guard
  float scale;    // K6 wide, K8
  int shift;      // K6 narrow: k with 2^k = S^2
  int bias;       // K7: 255 * sum|w < 0|
  int n_taps[2];  // K6: the 1-D taps' length; K7, K8: nonzero taps per kernel
  int n_pre;
  int n_post;
  // Device memory, sw_table_words(*this) ints: the pre steps, then the post
  // steps, four each (neg, A, C, m); then the taps: K6's 1-D taps, or K7's
  // and K8's nonzero taps as (offset, weight) pairs, kernel 0 first,
  // offset = dy * (2 halo + 1) + dx.
  const int* table;
};

// K7's kernel as kernel parameters, dense: w[dy * (2 halo + 1) + dx] for a
// side of at most SW_MAX_K (ops/swar_kernels.swar_taps; runtime/kernels.
// SwarTaps). 196 bytes.
struct SwarTaps {
  int w[SW_MAX_K * SW_MAX_K];
};

__host__ __device__ inline int sw_tap_words(const SwarDesc& d) {
  return (d.kind == SW_K6_NARROW || d.kind == SW_K6_WIDE) ? d.n_taps[0]
                                                          : 2 * (d.n_taps[0] + d.n_taps[1]);
}

__host__ __device__ inline int sw_table_words(const SwarDesc& d) {
  return 4 * (d.n_pre + d.n_post) + sw_tap_words(d);
}

// Pair words a window row holds: tile_w / 2 for the tile and at least 4 for
// the halo (a multiple of 4), so that a thread's two 16-byte reads of words
// 4q .. 4q + 7 stay in the row.
__host__ __device__ inline int sw_window_pitch(int tile_w, int halo) {
  return tile_w / 2 + (((halo > 4 ? halo : 4) + 3) & ~3);
}

// Bytes a raw window row holds: the row's granules from up to 15 bytes
// below its first byte, and room for the pair build's word reads past it.
__host__ __device__ inline int sw_raw_pitch(int tile_w, int halo) {
  return (int)st_round16((size_t)2 * sw_window_pitch(tile_w, halo) + 24);
}

// Dynamic shared memory, in order: the table (rounded up to 16 bytes), one
// StRow per window row, the window as pre-chained pair words
// (sw_window_pitch a row), then one scratch region that holds first the raw
// window (sw_raw_pitch bytes a row) and then, for K6, the row pass (tile_w /
// 2 words a row).
struct SwLayout {
  int wp;  // window pitch, words
  int rp;  // raw pitch, bytes
  size_t rows_off;
  size_t win_off;
  size_t scratch_off;
  size_t total;
};

__host__ __device__ inline SwLayout sw_layout(int kind, int tile_h, int tile_w, int halo,
                                              int table_words) {
  SwLayout L;
  const size_t eh = (size_t)tile_h + 2 * halo;
  L.wp = sw_window_pitch(tile_w, halo);
  L.rp = sw_raw_pitch(tile_w, halo);
  L.rows_off = (size_t)((table_words + 3) & ~3) * sizeof(int);
  L.win_off = L.rows_off + eh * sizeof(StRow);
  L.scratch_off = L.win_off + eh * L.wp * sizeof(uint32_t);
  const size_t raw = eh * L.rp;
  const size_t row_pass =
      (kind == SW_K6_NARROW || kind == SW_K6_WIDE) ? eh * (tile_w / 2) * sizeof(uint32_t) : 0;
  L.total = L.scratch_off + (raw > row_pass ? raw : row_pass);
  return L;
}

// The affine chain on two 16-bit fields, each holding a u8 value.
__device__ __forceinline__ uint32_t sw_chain_fields(uint32_t f, const int* c, int n) {
  for (int s = 0; s < n; ++s, c += 4) {
    if (c[0]) f = 0x00FF00FFu - f;
    uint32_t t = f * (uint32_t)c[1];  // <= 32640 per field
    const int C = c[2];
    if (C > 0) {
      t = __vsubus2(t, (uint32_t)C * 0x00010001u);
    } else if (C < 0) {
      t += (uint32_t)(-C) * 0x00010001u;  // <= 32767 per field
    }
    if (c[3]) t = (t >> c[3]) & ((0xFFFFu >> c[3]) * 0x00010001u);
    f = __vminu2(t, 0x00FF00FFu);
  }
  return f;
}

// The same chain on four pair words, each step dispatched once for the
// four (a subtraction or an addition of 0 and a shift by 0 change nothing).
__device__ __forceinline__ void sw_chain_fields4(uint32_t (&f)[4], const int* c, int n) {
  for (int s = 0; s < n; ++s, c += 4) {
    const uint32_t flip = c[0] ? 0x00FF00FFu : 0u;
    const uint32_t A = (uint32_t)c[1];
    const int C = c[2];
    const uint32_t sub = C > 0 ? (uint32_t)C * 0x00010001u : 0u;
    const uint32_t add = C < 0 ? (uint32_t)(-C) * 0x00010001u : 0u;
    const int m = c[3];
    const uint32_t mask = (0xFFFFu >> m) * 0x00010001u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = flip ? flip - f[j] : f[j];
      const uint32_t t = __vsubus2(x * A, sub) + add;
      f[j] = __vminu2((t >> m) & mask, 0x00FF00FFu);
    }
  }
}

// The same chain on one value per lane.
__device__ __forceinline__ int sw_chain_lane(int x, const int* c, int n) {
  for (int s = 0; s < n; ++s, c += 4) {
    if (c[0]) x = 255 - x;
    x = min(max(x * c[1] - c[2], 0) >> c[3], 255);
  }
  return x;
}

// Source index of coordinate c on an axis of length n, or -1 for a zero.
__device__ __forceinline__ int sw_src(int c, int n, int mode) {
  if (c >= 0 && c < n) return c;
  if (mode == SW_EDGE_ZERO || mode == SW_EDGE_INTERIOR) return -1;
  if (mode == SW_EDGE_REFLECT101) c = c < 0 ? -c : 2 * (n - 1) - c;
  return min(max(c, 0), n - 1);
}

// The pair word (p[c], p[c + 1]) of window row `w` for an even (odd = 0)
// or odd (odd = 1) column c; `w` points at the word of columns (c, c + 1)
// rounded down to even.
__device__ __forceinline__ uint32_t sw_pair(const uint32_t* w, int odd) {
  return odd ? __funnelshift_r(w[0], w[1], 16) : w[0];
}

__device__ __forceinline__ float sw_quantize(float x, int mode) {
  return mode == 0 ? pw_trunc_clip(x) : pw_rint_clip(x);
}

// The reference guard (kernel.cu:83) at global coordinates.
__device__ __forceinline__ bool sw_filtered(int gy, int gx, int H, int W, int h) {
  return gx > h && gx <= W - 1 - h && gy > h && gy <= H - 1 - h;
}

// K8's combine, scale and quantizer on one lane's exact sums, in the golden
// float32 order (spec.StencilOp.valid, finalize).
__device__ __forceinline__ int sw_finish(int a, int b, const SwarDesc& d) {
  float acc = (float)a;
  if (d.combine) {
    const float fb = (float)b;
    acc = __fsqrt_rn(__fadd_rn(__fmul_rn(acc, acc), __fmul_rn(fb, fb)));
  }
  if (d.scale != 1.0f) acc = __fmul_rn(acc, d.scale);
  return (int)sw_quantize(acc, d.quantize);
}

// The window rows' sources of the tile at (x0, y0): in full mode the edge
// mode's row, or none (a row of zeros) for zero and interior modes; in
// ghost mode the strips (rows past a strip feed only outputs below the
// tile, which are not stored). Threads < eh write one.
template <bool GHOST>
__device__ __forceinline__ void sw_row_sources(StRow* rows, int eh, int h, int x0, int y0,
                                               int tile_w, const unsigned char* in,
                                               const unsigned char* top,
                                               const unsigned char* bot, int H, int W,
                                               int mode) {
  const StCols cols = st_cols(x0, tile_w, h, W);
  for (int r = threadIdx.x; r < eh; r += SW_THREADS) {
    const int ty = y0 + r - h;
    const unsigned char* row;
    if (!GHOST) {
      const int sy = sw_src(ty, H, mode);
      if (sy < 0) {
        rows[r] = StRow{nullptr, 0, 0};
        continue;
      }
      row = in + (long long)sy * W;
    } else if (ty < 0) {
      row = top + (long long)(h + ty) * W;
    } else if (ty >= H) {
      row = bot + (long long)min(ty - H, h - 1) * W;
    } else {
      row = in + (long long)ty * W;
    }
    rows[r] = st_row_at(row + cols.lo, cols.hi - cols.lo);
  }
}

// The eight bytes of four output pairs (pair words, one byte a field) in
// pixel order at `o`: one 8-byte store, two 4-byte ones, or bytes for the
// `n` < 8 pixels left at the ragged edge.
__device__ __forceinline__ void sw_store8(unsigned char* o, const uint32_t (&q)[4], int n,
                                          bool vec8, bool vec4) {
  const uint32_t w0 = __byte_perm(q[0], q[1], 0x6420);
  const uint32_t w1 = __byte_perm(q[2], q[3], 0x6420);
  if (vec8 && n >= 8) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w0, w1);
  } else if (vec4 && (n & 3) == 0) {
    *reinterpret_cast<uint32_t*>(o) = w0;
    if (n >= 8) *reinterpret_cast<uint32_t*>(o + 4) = w1;
  } else {
    for (int b = 0; b < n && b < 8; ++b) o[b] = (unsigned char)((b < 4 ? w0 : w1) >> (8 * (b & 3)));
  }
}

// KS: the K7 instantiation's kernel side (3, 5 or 7: taps as kernel
// parameters), 0 for the tap-table form (K6, K8, larger K7 kernels).
template <int KIND, int KS, bool GHOST>
__global__ void __launch_bounds__(SW_THREADS)
swar_stencil_kernel(const unsigned char* __restrict__ in,
                    const unsigned char* __restrict__ top,
                    const unsigned char* __restrict__ bot,
                    unsigned char* __restrict__ out, int H, int W, int row0,
                    int image_h, const __grid_constant__ SwarDesc d,
                    const __grid_constant__ SwarTaps T, int tile_h, int tile_w, int lg_quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool K6 = KIND == SW_K6_NARROW || KIND == SW_K6_WIDE;
  const int h = KS ? KS / 2 : d.halo;
  const int eh = tile_h + 2 * h;
  const int x0 = blockIdx.x * tile_w;
  const int y0 = blockIdx.y * tile_h;
  const SwLayout L = sw_layout(KIND, tile_h, tile_w, h, sw_table_words(d));
  const int WP = L.wp;
  const int n_chain = 4 * (d.n_pre + d.n_post);
  int* s_chain = reinterpret_cast<int*>(smem);
  int* s_taps = s_chain + n_chain;
  StRow* rows = reinterpret_cast<StRow*>(smem + L.rows_off);
  uint32_t* s_win = reinterpret_cast<uint32_t*>(smem + L.win_off);
  unsigned char* raw = smem + L.scratch_off;
  uint32_t* s_row = reinterpret_cast<uint32_t*>(smem + L.scratch_off);

  // 1. The chains and the taps (K6's as given; K7's and K8's as (word
  // offset in the window << 1 | column parity, weight) from (offset,
  // weight)), and each window row's source; then the raw window: the rows'
  // segments as 16-byte granules, cp.async straight into shared memory.
  const int ks = 2 * h + 1;
  const int* taps = d.table + n_chain;
  for (int i = threadIdx.x; i < n_chain; i += SW_THREADS) s_chain[i] = d.table[i];
  if (K6) {
    for (int i = threadIdx.x; i < d.n_taps[0]; i += SW_THREADS) s_taps[i] = taps[i];
  } else if (KS == 0) {
    for (int t = threadIdx.x; t < d.n_taps[0] + d.n_taps[1]; t += SW_THREADS) {
      const int off = taps[2 * t];
      const int dy = off / ks, dx = off - dy * ks;
      s_taps[2 * t] = ((dy * WP + (dx >> 1)) << 1) | (dx & 1);
      s_taps[2 * t + 1] = taps[2 * t + 1];
    }
  }
  sw_row_sources<GHOST>(rows, eh, h, x0, y0, tile_w, in, top, bot, H, W, d.edge_mode);
  __syncthreads();
  st_load_window<SW_THREADS>(raw, rows, eh, L.rp);
  st_load_wait();
  __syncthreads();

  // 2. Four pair words (window pixels 8g .. 8g + 7, image columns x0 - h +
  // 8g on) a thread: word reads and funnel shifts, or in blocks whose
  // window leaves the image the edge mode's source column per pixel (a
  // branch uniform over the block); a row of zeros where the row has no
  // source; the pre-chain once for the four; one 16-byte store.
  const int* pre = s_chain;
  const int* post = s_chain + 4 * d.n_pre;
  {
    const StCols cols = st_cols(x0, tile_w, h, W);
    const unsigned gw = (unsigned)WP >> 2;
    const unsigned mg = st_magic(gw);
    for (unsigned i = threadIdx.x; i < (unsigned)eh * gw; i += SW_THREADS) {
      const unsigned r = st_div(i, mg);
      const unsigned g = i - r * gw;
      const StRow src = rows[r];
      uint32_t lo = 0u, hi = 0u;
      if (src.src != nullptr) {
        const unsigned char* rr = raw + r * L.rp;
        if (!cols.border) {
          const unsigned b = (unsigned)src.shift + 8u * g;
          const uint32_t* w = reinterpret_cast<const uint32_t*>(rr + (b & ~3u));
          const unsigned s = 8u * (b & 3u);
          lo = __funnelshift_r(w[0], w[1], s);
          hi = __funnelshift_r(w[1], w[2], s);
        } else {
          const int off = src.shift - cols.lo;  // image column c at rr[off + c]
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cx = x0 - h + 8 * (int)g + j;
            const int sx = sw_src(cx, W, d.edge_mode);
            const uint32_t v = sx < 0 ? 0u : rr[off + min(max(sx, cols.lo), cols.hi - 1)];
            if (j < 4) {
              lo |= v << (8 * j);
            } else {
              hi |= v << (8 * (j - 4));
            }
          }
        }
      }
      uint32_t f[4] = {__byte_perm(lo, 0u, 0x4140), __byte_perm(lo, 0u, 0x4342),
                       __byte_perm(hi, 0u, 0x4140), __byte_perm(hi, 0u, 0x4342)};
      sw_chain_fields4(f, pre, d.n_pre);
      *reinterpret_cast<uint4*>(s_win + r * WP + 4 * g) = make_uint4(f[0], f[1], f[2], f[3]);
    }
  }
  __syncthreads();

  // 3. Four output pairs (8 pixels) a thread: quad q of output row ly.
  const int nq = tile_w >> 3;
  const int y_end = min(tile_h, H - y0);
  const int x_end = min(tile_w, W - x0);
  const bool vec8 = (W & 7) == 0 && ((uintptr_t)out & 7) == 0;
  const bool vec4 = (W & 3) == 0 && ((uintptr_t)out & 3) == 0;

  if constexpr (K6) {
    const int n = d.n_taps[0];
    const int P2 = tile_w >> 1;  // pair words a row-pass row
    // 3a. Row pass on fields: output pair p reads window columns 2p .. 2p + 2h + 1.
    for (int i = threadIdx.x; i < eh << (lg_quads + 2); i += SW_THREADS) {
      const int r = i >> (lg_quads + 2);
      const int p = i & (P2 - 1);
      const uint32_t* w = s_win + r * WP + p;
      uint32_t a = w[0];
      uint32_t acc = a * (uint32_t)s_taps[0];
      for (int t = 1; t < n; t += 2) {
        const uint32_t b = w[(t + 1) >> 1];
        acc += __funnelshift_r(a, b, 16) * (uint32_t)s_taps[t];
        acc += b * (uint32_t)s_taps[t + 1];
        a = b;
      }
      s_row[r * P2 + p] = acc;
    }
    __syncthreads();
    // 3b. Column pass, quantize, post-chain, store.
    const uint32_t half = (1u << (d.shift - 1)) - 1u;
    const uint32_t m_half = (half << 16) | half;
    for (int i = threadIdx.x; i < tile_h << lg_quads; i += SW_THREADS) {
      const int ly = i >> lg_quads;
      const int q = i & (nq - 1);
      if (ly >= y_end || 8 * q >= x_end) continue;
      const uint32_t* col = s_row + ly * P2 + 4 * q;
      uint32_t res[4];
      if (KIND == SW_K6_NARROW) {
        uint32_t s[4] = {0u, 0u, 0u, 0u};
        for (int t = 0; t < n; ++t) {
          const uint4 c = *reinterpret_cast<const uint4*>(col + t * P2);
          const uint32_t tap = (uint32_t)s_taps[t];
          s[0] += c.x * tap;
          s[1] += c.y * tap;
          s[2] += c.z * tap;
          s[3] += c.w * tap;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (s[j] >> d.shift) & 0x00010001u;
          res[j] = ((s[j] + m_half + b) >> d.shift) & 0x00FF00FFu;
        }
        sw_chain_fields4(res, post, d.n_post);
      } else {
        int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
        for (int t = 0; t < n; ++t) {
          const uint4 c = *reinterpret_cast<const uint4*>(col + t * P2);
          const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
          const int tap = s_taps[t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo[j] += tap * (int)(cw[j] & 0xFFFFu);
            hi[j] += tap * (int)(cw[j] >> 16);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q0 = (int)pw_rint_clip(__fmul_rn((float)lo[j], d.scale));
          const int q1 = (int)pw_rint_clip(__fmul_rn((float)hi[j], d.scale));
          res[j] = (uint32_t)sw_chain_lane(q0, post, d.n_post) |
                   ((uint32_t)sw_chain_lane(q1, post, d.n_post) << 16);
        }
      }
      sw_store8(out + (long long)(y0 + ly) * W + x0 + 8 * q, res, min(8, x_end - 8 * q), vec8,
                vec4);
    }
    return;
  }

  // 3. K7, K8: the 2-D correlation of each quad over its window; the
  // interior guard only in blocks that reach the border band.
  const bool all_filtered =
      !d.interior || (row0 + y0 > h && row0 + y0 + y_end - 1 <= image_h - 1 - h && x0 > h &&
                      x0 + x_end - 1 <= W - 1 - h);
  const uint32_t bias2 = (uint32_t)d.bias * 0x00010001u;
  for (int i = threadIdx.x; i < tile_h << lg_quads; i += SW_THREADS) {
    const int ly = i >> lg_quads;
    const int q = i & (nq - 1);
    if (ly >= y_end || 8 * q >= x_end) continue;
    uint32_t res[4], cen[4];
    if constexpr (KIND == SW_K7 && KS > 0) {
      constexpr int hk = KS / 2;
      uint32_t acc[4] = {bias2, bias2, bias2, bias2};
      const uint4* base = reinterpret_cast<const uint4*>(s_win + ly * WP) + q;
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
        const uint4 a = base[dy * (WP >> 2)];
        const uint4 b = base[dy * (WP >> 2) + 1];
        const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t o[3 + hk];  // o[i]: the pair at odd window column 2i + 1
#pragma unroll
        for (int k = 0; k < 3 + hk; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], 16);
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const uint32_t wt = (uint32_t)T.w[dy * KS + dx];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += ((dx & 1) ? o[j + (dx >> 1)] : w[j + (dx >> 1)]) * wt;
        }
        if (dy == hk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) cen[j] = (hk & 1) ? o[j + (hk >> 1)] : w[j + (hk >> 1)];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) res[j] = __vminu2(__vsubus2(acc[j], bias2), 0x00FF00FFu);
    } else {
      const uint32_t* base = s_win + ly * WP + 4 * q;
      const uint32_t* c = base + h * WP + (h >> 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) cen[j] = sw_pair(c + j, h & 1);
      if (KIND == SW_K7) {
        uint32_t acc[4] = {bias2, bias2, bias2, bias2};
        for (int t = 0; t < d.n_taps[0]; ++t) {
          const int o = s_taps[2 * t];
          const uint32_t wt = (uint32_t)s_taps[2 * t + 1];
          const uint32_t* p = base + (o >> 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += sw_pair(p + j, o & 1) * wt;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) res[j] = __vminu2(__vsubus2(acc[j], bias2), 0x00FF00FFu);
      } else {
        // kernel 0 and 1, fields 0 and 1, of each pair
        int a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
        int b0[4] = {0, 0, 0, 0}, b1[4] = {0, 0, 0, 0};
        const int n0 = d.n_taps[0];
        for (int t = 0; t < n0; ++t) {
          const int o = s_taps[2 * t];
          const int wt = s_taps[2 * t + 1];
          const uint32_t* p = base + (o >> 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t v = sw_pair(p + j, o & 1);
            a0[j] += wt * (int)(v & 0xFFFFu);
            a1[j] += wt * (int)(v >> 16);
          }
        }
        if (d.combine) {
          for (int t = n0; t < n0 + d.n_taps[1]; ++t) {
            const int o = s_taps[2 * t];
            const int wt = s_taps[2 * t + 1];
            const uint32_t* p = base + (o >> 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t v = sw_pair(p + j, o & 1);
              b0[j] += wt * (int)(v & 0xFFFFu);
              b1[j] += wt * (int)(v >> 16);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          res[j] = (uint32_t)sw_finish(a0[j], b0[j], d) | ((uint32_t)sw_finish(a1[j], b1[j], d) << 16);
        }
      }
    }
    if (!all_filtered) {
      const int gy = row0 + y0 + ly;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = x0 + 8 * q + 2 * j;
        const uint32_t m = (sw_filtered(gy, gx, image_h, W, h) ? 0x0000FFFFu : 0u) |
                           (sw_filtered(gy, gx + 1, image_h, W, h) ? 0xFFFF0000u : 0u);
        res[j] = (res[j] & m) | (cen[j] & ~m);
      }
    }
    if (KIND == SW_K7) {
      sw_chain_fields4(res, post, d.n_post);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        res[j] = (uint32_t)sw_chain_lane((int)(res[j] & 0xFFFFu), post, d.n_post) |
                 ((uint32_t)sw_chain_lane((int)(res[j] >> 16), post, d.n_post) << 16);
      }
    }
    sw_store8(out + (long long)(y0 + ly) * W + x0 + 8 * q, res, min(8, x_end - 8 * q), vec8,
              vec4);
  }
}

template <int KIND, int KS, bool GHOST>
static int sw_launch(const unsigned char* in, const unsigned char* top,
                     const unsigned char* bot, unsigned char* out, int H, int W, int row0,
                     int image_h, const SwarDesc* d, const SwarTaps* taps, int tile_h,
                     int tile_w, int device, cudaStream_t stream) {
  const size_t smem = sw_layout(KIND, tile_h, tile_w, d->halo, sw_table_words(*d)).total;
  // the opt-in above 48 KB, once per instantiation, size and device
  static size_t opted[SW_MAX_DEVICES] = {};
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(swar_stencil_kernel<KIND, KS, GHOST>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem;
  }
  int lg = 0;
  while ((8 << lg) < tile_w) ++lg;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h);
  swar_stencil_kernel<KIND, KS, GHOST><<<grid, SW_THREADS, smem, stream>>>(
      in, top, bot, out, H, W, row0, image_h, *d, *taps, tile_h, tile_w, lg);
  return (int)cudaGetLastError();
}

template <bool GHOST>
static int sw_dispatch(const unsigned char* in, const unsigned char* top,
                       const unsigned char* bot, unsigned char* out, int H, int W, int row0,
                       int image_h, const SwarDesc* d, const SwarTaps* taps, int tile_h,
                       int tile_w, int device, cudaStream_t s) {
#define SW_ARGS in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w, device, s
  switch (d->kind) {
    case SW_K6_NARROW: return sw_launch<SW_K6_NARROW, 0, GHOST>(SW_ARGS);
    case SW_K6_WIDE: return sw_launch<SW_K6_WIDE, 0, GHOST>(SW_ARGS);
    case SW_K7:
      switch (d->halo) {
        case 1: return sw_launch<SW_K7, 3, GHOST>(SW_ARGS);
        case 2: return sw_launch<SW_K7, 5, GHOST>(SW_ARGS);
        case 3: return sw_launch<SW_K7, 7, GHOST>(SW_ARGS);
        default: return sw_launch<SW_K7, 0, GHOST>(SW_ARGS);
      }
    case SW_K8: return sw_launch<SW_K8, 0, GHOST>(SW_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SW_ARGS
}

// K6, K7 or K8 (d->kind) over an (H, W) u8 plane whose first row is global
// row `row0` of an image `image_h` rows high (the interior guard's
// coordinates; 0 and H for a whole image), in tiles of tile_h x tile_w
// outputs (tile_w 64, 128 or 256), on `device` and `stream`. `taps` is K7's
// dense kernel (read for a side of at most SW_MAX_K). Ghost mode when `top`
// and `bot` are given: the plane is a row-shard and `top` / `bot` are its
// raw (halo, W) ghost strips. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int swar_stencil_launch(const unsigned char* in, const unsigned char* top,
                                   const unsigned char* bot, unsigned char* out, int H, int W,
                                   int row0, int image_h, const SwarDesc* d,
                                   const SwarTaps* taps, int tile_h, int tile_w, int device,
                                   void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const bool width_ok = tile_w == 64 || tile_w == 128 || tile_w == 256;
  if (W % 4 || tile_h < 1 || !width_ok || d->halo < 0 || d->n_pre < 0 || d->n_post < 0 ||
      d->n_taps[0] < 0 || d->n_taps[1] < 0 || (d->table == nullptr && sw_table_words(*d) > 0) ||
      (top == nullptr) != (bot == nullptr) || taps == nullptr || device < 0 ||
      device >= SW_MAX_DEVICES) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (top != nullptr) {
    if (d->halo < 1) return (int)cudaErrorInvalidValue;
    return sw_dispatch<true>(in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w,
                             device, s);
  }
  return sw_dispatch<false>(in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w,
                            device, s);
}

// Dynamic shared memory one launch needs, and the structures' sizes, for
// the host-side checks.
extern "C" long long swar_smem_bytes(int kind, int tile_h, int tile_w, int halo,
                                     int table_words) {
  return (long long)sw_layout(kind, tile_h, tile_w, halo, table_words).total;
}

extern "C" long long swar_desc_bytes() { return (long long)sizeof(SwarDesc); }

extern "C" long long swar_taps_bytes() { return (long long)sizeof(SwarTaps); }
