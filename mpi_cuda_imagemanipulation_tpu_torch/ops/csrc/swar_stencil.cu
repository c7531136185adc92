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
//             column pass on fields (255 * S^2 < 2^16) or i32 lanes, then
//             the golden float32 replay rint(f32(s) * scale) and the clip;
//           * K7: bias + sum(w * x) per field with bias = 255 * sum|w < 0|,
//             so no field ends negative or past 2^15, then
//             min(max(acc - bias, 0), 255) by per-halfword intrinsics;
//           * K8: exact signed sums (biased 16-bit fields where they fit,
//             else i32 lanes), the combine (single, or __fsqrt_rn of a0^2 +
//             a1^2), the scale and the quantizer in IEEE float32 (built with
//             -fmad=false);
//           * the reference guard of interior-mode ops (K7, K8) at global
//             coordinates: outside the interior the pre-chained centre
//             pixel passes through; then the post-chain.
//           Ghost mode takes the rows above and below a (local_h, W) tile
//           from two raw (halo, W) strips and follows the guard in global
//           rows (row0, image_h).
//           Full mode takes a stack of same-shape planes (the batched
//           pipeline; the JAX package's vmap of the Pallas kernels, whose
//           rule adds a grid dimension): grid z is the plane, each at its
//           own input and output stride, so a group over a stack is one
//           launch.
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
//           - Four output pairs (8 pixels) a thread. Kernels of side 3, 5 or
//             7 run one instantiation per side with their taps as kernel
//             parameters (SwarTaps): each window row's 4 + h words are read
//             once into registers (two 16-byte shared loads), the
//             odd-offset pairs are funnel shifts of registers, and the tap
//             loops are unrolled at compile time. Larger kernels run a tap
//             table from shared memory.
//           - K7: every tap is one multiply-add per pair word by the signed
//             weight: the sum is linear modulo 2^32 and each field's result
//             lies in [0, 2^15), so bias + sum(w * x) is the same word as
//             (bias + P) - N with no sign branch.
//           - K8 (side 3) where each kernel's sums fit a 16-bit field
//             (sobel, scharr, prewitt: bias + 255 * sum|w > 0| < 2^16, bias
//             = 255 * the larger kernel's sum|w < 0|): the same biased
//             multiply-add per pair word and tap for both kernels, each
//             field read out as field - bias for the float finish. Other
//             K8 kernels of side 3/5/7 (unsharp, scaled filters) split each
//             window row into one pixel per i32 lane and take one
//             multiply-add per pixel and tap. The finish keeps the golden
//             float32 order (__fsqrt_rn of a^2 + b^2, the scale, the
//             quantizer); each result lies in [0, 255], so the post-chain
//             runs on pair words, as K7's does.
//           - K6 of side 3/5/7: the row pass takes four pair words a thread
//             from the register window, one multiply-add per word and tap,
//             and stores them as one 16-byte word; the column pass reads
//             one 16-byte word per tap row for two output rows at a time
//             (they share all but one read), unrolled at compile time.
//             Narrow mode normalises fields by a shift; wide mode runs the
//             column pass on fields too where 255 * S^2 < 2^16 (box:3 to
//             box:15) and on i32 lanes else (gaussian:7), then replays
//             rint(f32(s) * scale). Larger K6 kernels keep one pair a thread
//             in the row pass and a run-time tap loop.
//           - The interior guard hoisted out of blocks whose outputs all lie
//             inside the interior, at global coordinates.
//           - Stores: the four pairs' bytes gathered by byte permutes, one
//             8-byte store where the row pitch and address allow, 4-byte
//             ones else, bytes only at the ragged edge.
//           K6 keeps its row pass in shared memory for the column pass. The
//           chains and the table-form taps, of any length, come from a
//           table in device memory that the host builds once per group;
//           each block copies it into shared memory ahead of its window.

#include <stdint.h>

#include "device_scope.cuh"
#include "pointwise.cuh"
#include "window_load.cuh"

#define SW_THREADS 256
#define SW_MAX_K 7  // the largest kernel side with taps as kernel parameters
#define SW_KK (SW_MAX_K * SW_MAX_K)
#define SW_MAX_DEVICES 16
// planes of one full-mode launch: CUDA's limit on grid z
#define SW_MAX_IMAGES 65535

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
  int bias;       // K7: 255 * sum|w < 0|; K8 on fields: the larger kernel's
  int fields;     // K6 wide: 255 * S^2 < 2^16; K8: bias + 255 * sum|w > 0| < 2^16
  int n_taps[2];  // K6: the 1-D taps' length; K7, K8: nonzero taps per kernel
  int n_pre;
  int n_post;
  // Device memory, sw_table_words(*this) ints: the pre steps, then the post
  // steps, four each (neg, A, C, m); then the taps: K6's 1-D taps, or K7's
  // and K8's nonzero taps as (offset, weight) pairs, kernel 0 first,
  // offset = dy * (2 halo + 1) + dx.
  const int* table;
};

// The taps as kernel parameters, dense, for a side KS of at most SW_MAX_K
// (ops/swar_kernels.swar_taps; runtime/kernels.SwarTaps): K6's 1-D taps at
// w[t]; K7's kernel and K8's first at w[dy * KS + dx], K8's second at
// w[SW_KK + dy * KS + dx]. 392 bytes.
struct SwarTaps {
  int w[2 * SW_KK];
};

// The leading NW ints of SwarTaps: what a kind's kernel takes as its
// parameters (K6 SW_MAX_K, K7 SW_KK, K8 2 SW_KK), so that no kind's launch
// carries taps it does not read.
template <int NW>
struct SwTapsN {
  int w[NW];
};
template <int KIND>
using SwTapsOf = SwTapsN<KIND == SW_K8 ? 2 * SW_KK : KIND == SW_K7 ? SW_KK : SW_MAX_K>;

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

// The affine chain on four pair words (two 16-bit fields each, each
// holding a u8 value), each step dispatched once for the four (a
// subtraction or an addition of 0 and a shift by 0 change nothing).
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
      const uint32_t t = __vsubus2(x * A, sub) + add;  // <= 32767 per field
      f[j] = __vminu2((t >> m) & mask, 0x00FF00FFu);
    }
  }
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

// The register window of quad q in one window row: its words 4q .. 4q + 7
// (two 16-byte shared loads) and the NO odd-offset pairs o[k] = (p[2k + 1],
// p[2k + 2]) as funnel shifts of registers.
template <int NO>
__device__ __forceinline__ void sw_window_row(const uint32_t* row, int q, uint32_t (&w)[8],
                                              uint32_t (&o)[NO]) {
  const uint4* b = reinterpret_cast<const uint4*>(row) + q;
  const uint4 a = b[0], c = b[1];
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = c.x, w[5] = c.y, w[6] = c.z, w[7] = c.w;
#pragma unroll
  for (int k = 0; k < NO; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], 16);
}

// Pair j of the register window at column offset dx (compile-time after
// unrolling: a register, no select).
template <int NO>
__device__ __forceinline__ uint32_t sw_pair_at(const uint32_t (&w)[8], const uint32_t (&o)[NO],
                                               int j, int dx) {
  return (dx & 1) ? o[j + (dx >> 1)] : w[j + (dx >> 1)];
}

// 1.5 * 2^23: the float 2^23 * 1.5 + n has the bits 0x4B400000 + n for an
// integer |n| < 2^22, so an integer in the mantissa becomes a float by one
// byte permute or add and one exact subtraction, and a float in [0, 255]
// is rounded half to even into its low byte by one add (no conversion
// instruction: those run at a quarter of the float rate).
#define SW_MAGIC 12582912.0f
#define SW_MAGIC_BITS 0x4B400000u

// (SW_MAGIC + field `HI` of pair word `w`) - off: the field (0 low, 1 high)
// into the magic's mantissa by a byte permute, then one subtraction; for
// off = SW_MAGIC + c with an integer 0 <= c < 2^16, exactly field - c.
template <int HI>
__device__ __forceinline__ float sw_field_f(uint32_t w, float off) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, SW_MAGIC_BITS, HI ? 0x7632 : 0x7610)), off);
}

// An integer 0 <= n < 2^22 as a float.
__device__ __forceinline__ float sw_lane_f(uint32_t n) {
  return __fsub_rn(__uint_as_float(SW_MAGIC_BITS + n), SW_MAGIC);
}

// rint_clip(x) = clip(rint(x)) = rint(clip(x)) in the low byte of the
// result (its second byte 0).
__device__ __forceinline__ uint32_t sw_rint_clip_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), SW_MAGIC));
}

// Two pixels' results (the quantizer mode's) as one pair word.
__device__ __forceinline__ uint32_t sw_quantize2(float x0, float x1, int mode) {
  if (mode == 1) return __byte_perm(sw_rint_clip_bits(x0), sw_rint_clip_bits(x1), 0x5410);
  return (uint32_t)(int)pw_trunc_clip(x0) | ((uint32_t)(int)pw_trunc_clip(x1) << 16);
}

// The reference guard (kernel.cu:83) at global coordinates.
__device__ __forceinline__ bool sw_filtered(int gy, int gx, int H, int W, int h) {
  return gx > h && gx <= W - 1 - h && gy > h && gy <= H - 1 - h;
}

// K8's combine and scale on one pixel's exact sums as floats, in the
// golden float32 order (spec.StencilOp.valid, finalize); the quantizer
// follows (sw_quantize2).
template <bool COMBINE>
__device__ __forceinline__ float sw_combine(float a, float b, const SwarDesc& d) {
  float acc = a;
  if (COMBINE) acc = __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  if (d.scale != 1.0f) acc = __fmul_rn(acc, d.scale);
  return acc;
}

// K8's exact sums of quad q for a kernel side KS <= SW_MAX_K, over the KS
// window rows from `win`, both kernels (NK = 2) or one, as floats: FIELDS,
// per kernel bias + sum(w * x) on whole pair words, one multiply-add per
// word and tap (linear modulo 2^32; each field ends in [0, 2^16)), read out
// as field - bias by a byte permute and one subtraction (sw_field_f); else
// one pixel per i32 lane, one multiply-add per pixel and tap. a[n], b[n]:
// pixel 8q + n's sums; cen: the centre pairs (the guard's passthrough).
template <int KS, bool FIELDS, int NK>
__device__ __forceinline__ void sw_k8_sums(const uint32_t* win, int WP, int q,
                                           const SwTapsOf<SW_K8>& T,
                                           int bias, float (&a)[8], float (&b)[8],
                                           uint32_t (&cen)[4]) {
  constexpr int hk = KS / 2;
  if constexpr (FIELDS) {
    const uint32_t bias2 = (uint32_t)bias * 0x00010001u;
    uint32_t acc[NK][4];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = bias2;
    }
#pragma unroll
    for (int dy = 0; dy < KS; ++dy) {
      uint32_t w[8], o[3 + hk];
      sw_window_row(win + dy * WP, q, w, o);
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const uint32_t wt = (uint32_t)T.w[k * SW_KK + dy * KS + dx];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] += sw_pair_at(w, o, j, dx) * wt;
        }
      }
      if (dy == hk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cen[j] = sw_pair_at(w, o, j, hk);
      }
    }
    const float off = SW_MAGIC + (float)bias;  // exact: bias < 2^16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[2 * j] = sw_field_f<0>(acc[0][j], off);
      a[2 * j + 1] = sw_field_f<1>(acc[0][j], off);
      b[2 * j] = NK == 2 ? sw_field_f<0>(acc[NK - 1][j], off) : 0.0f;
      b[2 * j + 1] = NK == 2 ? sw_field_f<1>(acc[NK - 1][j], off) : 0.0f;
    }
  } else {
    int acc[NK][8];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[k][n] = 0;
    }
#pragma unroll
    for (int dy = 0; dy < KS; ++dy) {
      uint32_t w[8], o[1];
      sw_window_row(win + dy * WP, q, w, o);
      int x[8 + 2 * hk];  // pixels 8q - h + 0 .. 7 + 2h of the window row
#pragma unroll
      for (int k = 0; k < 4 + hk; ++k) {
        x[2 * k] = (int)(w[k] & 0xFFFFu);
        x[2 * k + 1] = (int)(w[k] >> 16);
      }
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int wt = T.w[k * SW_KK + dy * KS + dx];
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[k][n] += wt * x[n + dx];
        }
      }
      if (dy == hk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cen[j] = (uint32_t)x[2 * j + hk] | ((uint32_t)x[2 * j + 1 + hk] << 16);
        }
      }
    }
    // |sums| < 2^24: exact in float32 (swar_corr2d_wide_eligible)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      a[n] = (float)acc[0][n];
      b[n] = NK == 2 ? (float)acc[NK - 1][n] : 0.0f;
    }
  }
}

// K8 on quad q of output row ly (window rows from ly): the sums, then the
// finish of each pixel into its field of res.
template <int KS, bool FIELDS, int NK>
__device__ __forceinline__ void sw_k8_quad(const uint32_t* win, int WP, int q,
                                           const SwTapsOf<SW_K8>& T,
                                           const SwarDesc& d, uint32_t (&res)[4],
                                           uint32_t (&cen)[4]) {
  float a[8], b[8];
  sw_k8_sums<KS, FIELDS, NK>(win, WP, q, T, d.bias, a, b, cen);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    res[j] = sw_quantize2(sw_combine<NK == 2>(a[2 * j], b[2 * j], d),
                          sw_combine<NK == 2>(a[2 * j + 1], b[2 * j + 1], d), d.quantize);
  }
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

// Where K6's column pass stores a tile's outputs: output row ly, quad q of
// the tile at (x0, y0). (K7 and K8 store from locals: through this struct
// K7 measured 1-2% slower on the card.)
struct SwOut {
  unsigned char* out;
  int W, x0, y0, y_end, x_end;
  bool vec8, vec4;

  __device__ __forceinline__ void store(int ly, int q, const uint32_t (&res)[4]) const {
    sw_store8(out + (long long)(y0 + ly) * W + x0 + 8 * q, res, min(8, x_end - 8 * q), vec8,
              vec4);
  }
};

// K6's column pass arms: narrow (fields, >> k with round-half-even), wide
// on fields (255 * S^2 < 2^16), wide on i32 lanes.
enum SwK6Arm { SW_ARM_NARROW = 0, SW_ARM_WIDE_FIELDS = 1, SW_ARM_WIDE_LANES = 2 };

// One row-pass word `c` (four pair words) times `tap` into the column sums:
// fields (s), or the low lanes in s and the high ones in hi.
template <int ARM>
__device__ __forceinline__ void sw_k6_add(uint32_t (&s)[4], int (&hi)[4], const uint4& c,
                                          int tap) {
  const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ARM == SW_ARM_WIDE_LANES) {
      s[j] += (uint32_t)tap * (cw[j] & 0xFFFFu);
      hi[j] += tap * (int)(cw[j] >> 16);
    } else {
      s[j] += cw[j] * (uint32_t)tap;
    }
  }
}

// The column sums of four pairs to their u8 results, one per field.
template <int ARM>
__device__ __forceinline__ void sw_k6_finish(const uint32_t (&s)[4], const int (&hi)[4],
                                             const SwarDesc& d, uint32_t (&res)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ARM == SW_ARM_NARROW) {
      const uint32_t half = (1u << (d.shift - 1)) - 1u;
      const uint32_t b = (s[j] >> d.shift) & 0x00010001u;
      res[j] = ((s[j] + ((half << 16) | half) + b) >> d.shift) & 0x00FF00FFu;
    } else {
      // exact floats of the sums (fields < 2^16; lanes <= 255 * 128^2 < 2^22)
      const float l = ARM == SW_ARM_WIDE_LANES ? sw_lane_f(s[j]) : sw_field_f<0>(s[j], SW_MAGIC);
      const float h = ARM == SW_ARM_WIDE_LANES ? sw_lane_f((uint32_t)hi[j])
                                               : sw_field_f<1>(s[j], SW_MAGIC);
      res[j] = sw_quantize2(__fmul_rn(l, d.scale), __fmul_rn(h, d.scale), 1);
    }
  }
}

// K6's column pass over the row pass `s_row` (P2 pair words a row), its
// quantizer, post-chain and store: KS > 0 unrolled over the taps T.w[t],
// two output rows a thread sharing KS + 1 16-byte reads (faster than one
// row on the card); KS = 0 a run-time loop over the n taps in s_taps, one
// row a thread.
template <int ARM, int KS>
__device__ __forceinline__ void sw_k6_columns(const uint32_t* s_row, int P2, int tile_h,
                                              int lg_quads, const int* s_taps,
                                              const SwTapsN<SW_MAX_K>& T, const SwarDesc& d,
                                              const int* post, const SwOut& O) {
  constexpr int ROWS = KS > 0 ? 2 : 1;
  const int nq = 1 << lg_quads;
  const int P4 = P2 >> 2;
  const int groups = (tile_h + ROWS - 1) / ROWS;
  for (int i = threadIdx.x; i < groups << lg_quads; i += SW_THREADS) {
    const int ly = (i >> lg_quads) * ROWS;
    const int q = i & (nq - 1);
    if (ly >= O.y_end || 8 * q >= O.x_end) continue;
    const uint4* col = reinterpret_cast<const uint4*>(s_row + ly * P2) + q;
    uint32_t s[ROWS][4];
    int hi[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0u, hi[r][j] = 0;
    }
    if constexpr (KS > 0) {
      // the last read feeds only row ly + ROWS - 1: not past the row pass
      const bool last = ly + ROWS - 1 < O.y_end;
#pragma unroll
      for (int t = 0; t < KS + ROWS - 1; ++t) {
        const uint4 c = (t < KS || last) ? col[t * P4] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (t - r >= 0 && t - r < KS) sw_k6_add<ARM>(s[r], hi[r], c, T.w[t - r]);
        }
      }
    } else {
      for (int t = 0; t < d.n_taps[0]; ++t) sw_k6_add<ARM>(s[0], hi[0], col[t * P4], s_taps[t]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (ly + r >= O.y_end) break;
      uint32_t res[4];
      sw_k6_finish<ARM>(s[r], hi[r], d, res);
      sw_chain_fields4(res, post, d.n_post);
      O.store(ly + r, q, res);
    }
  }
}

// KS: the kernel side of an instantiation with its taps as kernel
// parameters (3, 5 or 7), 0 for the tap-table form. F16: K8 on biased
// 16-bit fields (side 3).
template <int KIND, int KS, bool GHOST, bool F16>
__global__ void __launch_bounds__(SW_THREADS)
swar_stencil_kernel(const unsigned char* __restrict__ in,
                    const unsigned char* __restrict__ top,
                    const unsigned char* __restrict__ bot,
                    unsigned char* __restrict__ out, int H, int W, int row0,
                    int image_h, const __grid_constant__ SwarDesc d,
                    const __grid_constant__ SwTapsOf<KIND> T, int tile_h, int tile_w,
                    int lg_quads, long long in_stride, long long out_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the batch axis: grid z is the plane of a stack (full mode; 1 in ghost
  // mode), its offset taken in 64 bits
  in += (long long)blockIdx.z * in_stride;
  out += (long long)blockIdx.z * out_stride;
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

  // 1. The chains and the table-form taps (K6's as given; K7's and K8's as
  // (word offset in the window << 1 | column parity, weight) from (offset,
  // weight)), and each window row's source; then the raw window: the rows'
  // segments as 16-byte granules, cp.async straight into shared memory.
  const int ks = 2 * h + 1;
  const int* taps = d.table + n_chain;
  for (int i = threadIdx.x; i < n_chain; i += SW_THREADS) s_chain[i] = d.table[i];
  if (K6 && KS == 0) {
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
    const SwOut O{out, W, x0, y0, y_end, x_end, vec8, vec4};
    const int P2 = tile_w >> 1;  // pair words a row-pass row
    // 3a. Row pass on fields.
    if constexpr (KS > 0) {
      // four pair words a thread from the register window: pair 4g + j
      // reads window pairs 4g + j + dx / 2 (even dx) or the odd pairs
      constexpr int hk = KS / 2;
      for (int i = threadIdx.x; i < eh << lg_quads; i += SW_THREADS) {
        const int r = i >> lg_quads;
        const int g = i & (nq - 1);
        uint32_t w[8], o[3 + hk];
        sw_window_row(s_win + r * WP, g, w, o);
        uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const uint32_t tap = (uint32_t)T.w[dx];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += sw_pair_at(w, o, j, dx) * tap;
        }
        *reinterpret_cast<uint4*>(s_row + r * P2 + 4 * g) = make_uint4(acc[0], acc[1], acc[2],
                                                                      acc[3]);
      }
    } else {
      // one pair word a thread: output pair p reads window columns 2p .. 2p + 2h + 1
      const int n = d.n_taps[0];
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
    }
    __syncthreads();
    // 3b. Column pass, quantize, post-chain, store.
    if (KIND == SW_K6_NARROW) {
      sw_k6_columns<SW_ARM_NARROW, KS>(s_row, P2, tile_h, lg_quads, s_taps, T, d, post, O);
    } else if (d.fields) {
      sw_k6_columns<SW_ARM_WIDE_FIELDS, KS>(s_row, P2, tile_h, lg_quads, s_taps, T, d, post, O);
    } else {
      sw_k6_columns<SW_ARM_WIDE_LANES, KS>(s_row, P2, tile_h, lg_quads, s_taps, T, d, post, O);
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
      // the register window spelled out, not through sw_window_row and
      // sw_pair_at: K7 measured 1-2% faster so on the card
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
    } else if constexpr (KIND == SW_K8 && KS > 0) {
      if (d.combine) {
        sw_k8_quad<KS, F16, 2>(s_win + ly * WP, WP, q, T, d, res, cen);
      } else {
        sw_k8_quad<KS, F16, 1>(s_win + ly * WP, WP, q, T, d, res, cen);
      }
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
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            res[j] = sw_quantize2(sw_combine<true>((float)a0[j], (float)b0[j], d),
                                  sw_combine<true>((float)a1[j], (float)b1[j], d), d.quantize);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            res[j] = sw_quantize2(sw_combine<false>((float)a0[j], 0.0f, d),
                                  sw_combine<false>((float)a1[j], 0.0f, d), d.quantize);
          }
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
    // every field holds a u8 value: the post-chain on pair words
    sw_chain_fields4(res, post, d.n_post);
    sw_store8(out + (long long)(y0 + ly) * W + x0 + 8 * q, res, min(8, x_end - 8 * q), vec8,
              vec4);
  }
}

template <int KIND, int KS, bool GHOST, bool F16 = false>
static int sw_launch(const unsigned char* in, const unsigned char* top,
                     const unsigned char* bot, unsigned char* out, int H, int W, int row0,
                     int image_h, const SwarDesc* d, const SwarTaps* taps, int tile_h,
                     int tile_w, int n_img, long long in_stride, long long out_stride,
                     int device, cudaStream_t stream) {
  const size_t smem = sw_layout(KIND, tile_h, tile_w, d->halo, sw_table_words(*d)).total;
  // the opt-in above 48 KB, once per instantiation, size and device
  static size_t opted[SW_MAX_DEVICES] = {};
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(swar_stencil_kernel<KIND, KS, GHOST, F16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem;
  }
  int lg = 0;
  while ((8 << lg) < tile_w) ++lg;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, n_img);
  swar_stencil_kernel<KIND, KS, GHOST, F16><<<grid, SW_THREADS, smem, stream>>>(
      in, top, bot, out, H, W, row0, image_h, *d, *reinterpret_cast<const SwTapsOf<KIND>*>(taps),
      tile_h, tile_w, lg, in_stride, out_stride);
  return (int)cudaGetLastError();
}

// The instantiation of a descriptor: the kernel side for sides 3/5/7 where
// the kind has one (K6 narrow 3/5; K6 wide, K7 and K8 3/5/7; K8 side 3 on
// fields where its sums fit), else the tap table; each in full and ghost
// mode.
template <bool GHOST>
static int sw_dispatch(const unsigned char* in, const unsigned char* top,
                       const unsigned char* bot, unsigned char* out, int H, int W, int row0,
                       int image_h, const SwarDesc* d, const SwarTaps* taps, int tile_h,
                       int tile_w, int n_img, long long in_stride, long long out_stride,
                       int device, cudaStream_t s) {
#define SW_ARGS                                                                        \
  in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w, n_img, in_stride, \
      out_stride, device, s
  switch (d->kind) {
    case SW_K6_NARROW:
      switch (d->halo) {
        case 1: return sw_launch<SW_K6_NARROW, 3, GHOST>(SW_ARGS);
        case 2: return sw_launch<SW_K6_NARROW, 5, GHOST>(SW_ARGS);
        default: return sw_launch<SW_K6_NARROW, 0, GHOST>(SW_ARGS);
      }
    case SW_K6_WIDE:
      switch (d->halo) {
        case 1: return sw_launch<SW_K6_WIDE, 3, GHOST>(SW_ARGS);
        case 2: return sw_launch<SW_K6_WIDE, 5, GHOST>(SW_ARGS);
        case 3: return sw_launch<SW_K6_WIDE, 7, GHOST>(SW_ARGS);
        default: return sw_launch<SW_K6_WIDE, 0, GHOST>(SW_ARGS);
      }
    case SW_K7:
      switch (d->halo) {
        case 1: return sw_launch<SW_K7, 3, GHOST>(SW_ARGS);
        case 2: return sw_launch<SW_K7, 5, GHOST>(SW_ARGS);
        case 3: return sw_launch<SW_K7, 7, GHOST>(SW_ARGS);
        default: return sw_launch<SW_K7, 0, GHOST>(SW_ARGS);
      }
    case SW_K8:
      switch (d->halo) {
        case 1:
          return d->fields ? sw_launch<SW_K8, 3, GHOST, true>(SW_ARGS)
                           : sw_launch<SW_K8, 3, GHOST>(SW_ARGS);
        case 2: return sw_launch<SW_K8, 5, GHOST>(SW_ARGS);
        case 3: return sw_launch<SW_K8, 7, GHOST>(SW_ARGS);
        default: return sw_launch<SW_K8, 0, GHOST>(SW_ARGS);
      }
    default: return (int)cudaErrorInvalidValue;
  }
#undef SW_ARGS
}

// K6, K7 or K8 (d->kind) over an (H, W) u8 plane whose first row is global
// row `row0` of an image `image_h` rows high (the interior guard's
// coordinates; 0 and H for a whole image), in tiles of tile_h x tile_w
// outputs (tile_w 64, 128 or 256), on `device` and `stream`. `taps` is the
// dense kernel (read for a side of at most SW_MAX_K). Ghost mode when `top`
// and `bot` are given: the plane is a row-shard and `top` / `bot` are its
// raw (halo, W) ghost strips. Full mode takes a stack of `n_img` planes,
// plane i at `in + i * in_stride` and written to `out + i * out_stride`
// (bytes; one plane: n_img 1): grid z is the plane, so a tile never spans
// two. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int swar_stencil_launch(const unsigned char* in, const unsigned char* top,
                                   const unsigned char* bot, unsigned char* out, int H, int W,
                                   int row0, int image_h, const SwarDesc* d,
                                   const SwarTaps* taps, int tile_h, int tile_w, int n_img,
                                   long long in_stride, long long out_stride, int device,
                                   void* stream) {
  if (H <= 0 || W <= 0 || n_img == 0) return 0;
  if (n_img < 0 || n_img > SW_MAX_IMAGES || (top != nullptr && n_img != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool width_ok = tile_w == 64 || tile_w == 128 || tile_w == 256;
  if (W % 4 || tile_h < 1 || !width_ok || d->halo < 0 || d->n_pre < 0 || d->n_post < 0 ||
      d->n_taps[0] < 0 || d->n_taps[1] < 0 || (d->table == nullptr && sw_table_words(*d) > 0) ||
      (top == nullptr) != (bot == nullptr) || taps == nullptr || device < 0 ||
      device >= SW_MAX_DEVICES || (top != nullptr && d->halo < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (top != nullptr) {
    return sw_dispatch<true>(in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w,
                             1, 0, 0, device, s);
  }
  return sw_dispatch<false>(in, top, bot, out, H, W, row0, image_h, d, taps, tile_h, tile_w,
                            n_img, in_stride, out_stride, device, s);
}

// Dynamic shared memory one launch needs, and the structures' sizes, for
// the host-side checks.
extern "C" long long swar_smem_bytes(int kind, int tile_h, int tile_w, int halo,
                                     int table_words) {
  return (long long)sw_layout(kind, tile_h, tile_w, halo, table_words).total;
}

extern "C" long long swar_desc_bytes() { return (long long)sizeof(SwarDesc); }

extern "C" long long swar_taps_bytes() { return (long long)sizeof(SwarTaps); }
