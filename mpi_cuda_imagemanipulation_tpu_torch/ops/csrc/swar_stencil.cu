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
//           * K7: (bias + P) - N per field with bias = 255 * sum|w < 0|,
//             so no field goes negative (< 2^15), then
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
//           integer work (a few multiply-adds per pixel pair and tap) is far
//           below the card's operation rates.
// Design:   the TPU kernel walks row blocks in order, carrying the previous
//           block's fields in scratch memory, and packs the padded plane
//           into quarter-strip words in a pass of its own before the call
//           (and unpacks after it). Here a 2-D grid of independent output
//           tiles (SW_TILE_W columns x tile_h rows, 256 threads) each
//           loads its own window with a halo of h rows and columns, the
//           border resolved by index (reflect101, edge or zero) and ghost
//           rows read from the strips, so neither pad nor pack costs a trip
//           through device memory. Two neighbouring pixels share a 32-bit
//           word as 16-bit fields: the window is kept in shared memory as
//           pre-chained words of pixels (2i, 2i+1); a pair at an odd offset
//           is a funnel shift of two neighbouring words, so every tap of a
//           pixel pair is one multiply-add. K6 keeps its row pass in shared
//           memory for the column pass. Per-halfword intrinsics
//           (__vsubus2, __vminu2) replace the TPU kernel's sign-probe
//           helpers: they give the same field values under the < 2^15
//           bound the host's affine fitter and eligibility gates keep.

#include <stdint.h>

#include "pointwise.cuh"

#define SW_TILE_W 128
#define SW_PAIRS (SW_TILE_W / 2)
#define SW_THREADS 256
#define SW_MAX_CHAIN 16
#define SW_MAX_TAPS 512

enum SwKind { SW_K6_NARROW = 0, SW_K6_WIDE = 1, SW_K7 = 2, SW_K8 = 3 };
enum SwEdge {
  SW_EDGE_INTERIOR = 0,
  SW_EDGE_REFLECT101 = 1,
  SW_EDGE_EDGE = 2,
  SW_EDGE_ZERO = 3,
};

// One SWAR stencil with its fused chains (ops/swar_kernels.swar_desc
// builds it; runtime/kernels.SwarDesc has the same layout).
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
  int chain[2 * SW_MAX_CHAIN][4];  // pre steps, then post steps: neg, A, C, m
  // K6: the 1-D taps. K7, K8: (offset, weight) pairs of each kernel's
  // nonzero taps, kernel 0 first, offset = dy * (2 halo + 1) + dx.
  int taps[SW_MAX_TAPS];
};

__host__ __device__ inline int sw_words(int halo) { return SW_PAIRS + halo; }

// Dynamic shared memory: the window as pre-chained pair words, then (K6)
// the row pass.
__host__ __device__ inline size_t sw_smem_bytes(int kind, int tile_h, int halo) {
  const size_t eh = (size_t)tile_h + 2 * halo;
  size_t bytes = eh * sw_words(halo) * sizeof(uint32_t);
  if (kind == SW_K6_NARROW || kind == SW_K6_WIDE) bytes += eh * SW_PAIRS * sizeof(uint32_t);
  return bytes;
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

// One K8 tap on both lanes of a pair: `tap` is (word offset << 1 | column
// parity, weight).
__device__ __forceinline__ void sw_lane_taps(const uint32_t* base, const int* tap, int& lo,
                                             int& hi) {
  const uint32_t v = sw_pair(base + (tap[0] >> 1), tap[0] & 1);
  lo += tap[1] * (int)(v & 0xFFFFu);
  hi += tap[1] * (int)(v >> 16);
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

__device__ __forceinline__ void sw_store(unsigned char* q, uint32_t fields) {
  *reinterpret_cast<uint16_t*>(q) = (uint16_t)((fields & 0xFFu) | ((fields >> 8) & 0xFF00u));
}

template <int KIND, bool GHOST>
__global__ void __launch_bounds__(SW_THREADS)
swar_stencil_kernel(const unsigned char* __restrict__ in,
                    const unsigned char* __restrict__ top,
                    const unsigned char* __restrict__ bot,
                    unsigned char* __restrict__ out, int H, int W, int row0,
                    int image_h, const __grid_constant__ SwarDesc d, int tile_h) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_chain[2 * SW_MAX_CHAIN * 4];
  __shared__ int s_taps[SW_MAX_TAPS];
  const int h = d.halo;
  const int nw = sw_words(h);
  const int eh = tile_h + 2 * h;
  const int x0 = blockIdx.x * SW_TILE_W;
  const int y0 = blockIdx.y * tile_h;
  uint32_t* s_win = smem;
  uint32_t* s_row = smem + eh * nw;

  // The chains, and the taps: K6's as given; K7's and K8's as (word
  // offset in the window, column parity, weight) from (offset, weight).
  const int ks = 2 * h + 1;
  const int n_chain = 4 * (d.n_pre + d.n_post);
  const int n_nz = d.n_taps[0] + d.n_taps[1];
  for (int i = threadIdx.x; i < n_chain; i += SW_THREADS) s_chain[i] = (&d.chain[0][0])[i];
  if (KIND == SW_K6_NARROW || KIND == SW_K6_WIDE) {
    for (int i = threadIdx.x; i < d.n_taps[0]; i += SW_THREADS) s_taps[i] = d.taps[i];
  } else {
    for (int t = threadIdx.x; t < n_nz; t += SW_THREADS) {
      const int off = d.taps[2 * t];
      const int dy = off / ks, dx = off - dy * ks;
      s_taps[2 * t] = ((dy * nw + (dx >> 1)) << 1) | (dx & 1);
      s_taps[2 * t + 1] = d.taps[2 * t + 1];
    }
  }
  const int* pre = s_chain;
  const int* post = s_chain + 4 * d.n_pre;
  __syncthreads();

  // 1. Window load: pair words of window columns (2k, 2k + 1), image
  // columns x0 - h + 2k and one more, edges resolved by index, rows beyond
  // a ghost tile from its strips (rows past a strip feed only outputs below
  // the tile, which are not stored), the pre-chain on every pixel.
  for (int i = threadIdx.x; i < eh * nw; i += SW_THREADS) {
    const int r = i / nw;
    const int k = i - r * nw;
    const int ty = y0 + r - h;
    const unsigned char* row;
    if (!GHOST) {
      const int sy = sw_src(ty, H, d.edge_mode);
      row = sy < 0 ? nullptr : in + (long long)sy * W;
    } else if (ty < 0) {
      row = top + (long long)(h + ty) * W;
    } else if (ty >= H) {
      row = bot + (long long)min(ty - H, h - 1) * W;
    } else {
      row = in + (long long)ty * W;
    }
    const int gx = x0 - h + 2 * k;
    const int s0 = sw_src(gx, W, d.edge_mode);
    const int s1 = sw_src(gx + 1, W, d.edge_mode);
    const uint32_t v0 = (row != nullptr && s0 >= 0) ? row[s0] : 0u;
    const uint32_t v1 = (row != nullptr && s1 >= 0) ? row[s1] : 0u;
    s_win[i] = sw_chain_fields(v0 | (v1 << 16), pre, d.n_pre);
  }
  __syncthreads();

  if (KIND == SW_K6_NARROW || KIND == SW_K6_WIDE) {
    const int n = d.n_taps[0];
    // 2. Row pass on fields: output pair p reads window columns 2p .. 2p + 2h + 1.
    for (int i = threadIdx.x; i < eh * SW_PAIRS; i += SW_THREADS) {
      const int r = i / SW_PAIRS;
      const int p = i - r * SW_PAIRS;
      const uint32_t* w = s_win + r * nw + p;
      uint32_t a = w[0];
      uint32_t acc = a * (uint32_t)s_taps[0];
      for (int t = 1; t < n; t += 2) {
        const uint32_t b = w[(t + 1) >> 1];
        acc += __funnelshift_r(a, b, 16) * (uint32_t)s_taps[t];
        acc += b * (uint32_t)s_taps[t + 1];
        a = b;
      }
      s_row[i] = acc;
    }
    __syncthreads();
    // 3. Column pass, quantize, post-chain, store.
    const uint32_t half = (1u << (d.shift - 1)) - 1u;
    const uint32_t m_half = (half << 16) | half;
    for (int i = threadIdx.x; i < tile_h * SW_PAIRS; i += SW_THREADS) {
      const int ly = i / SW_PAIRS;
      const int p = i - ly * SW_PAIRS;
      const int gy = y0 + ly;
      const int gx = x0 + 2 * p;
      if (gy >= H || gx >= W) continue;
      const uint32_t* col = s_row + ly * SW_PAIRS + p;
      uint32_t q;
      if (KIND == SW_K6_NARROW) {
        uint32_t s = 0;
        for (int t = 0; t < n; ++t) s += col[t * SW_PAIRS] * (uint32_t)s_taps[t];
        const uint32_t b = (s >> d.shift) & 0x00010001u;
        q = ((s + m_half + b) >> d.shift) & 0x00FF00FFu;
        q = sw_chain_fields(q, post, d.n_post);
      } else {
        int lo = 0, hi = 0;
        for (int t = 0; t < n; ++t) {
          const uint32_t f = col[t * SW_PAIRS];
          lo += s_taps[t] * (int)(f & 0xFFFFu);
          hi += s_taps[t] * (int)(f >> 16);
        }
        const int q0 = (int)pw_rint_clip(__fmul_rn((float)lo, d.scale));
        const int q1 = (int)pw_rint_clip(__fmul_rn((float)hi, d.scale));
        q = (uint32_t)sw_chain_lane(q0, post, d.n_post) |
            ((uint32_t)sw_chain_lane(q1, post, d.n_post) << 16);
      }
      sw_store(out + (long long)gy * W + gx, q);
    }
    return;
  }

  // 2-3. K7, K8: the 2-D correlation of each output pair over its window.
  const int centre = ((h * nw + (h >> 1)) << 1) | (h & 1);
  for (int i = threadIdx.x; i < tile_h * SW_PAIRS; i += SW_THREADS) {
    const int ly = i / SW_PAIRS;
    const int p = i - ly * SW_PAIRS;
    const int gy = y0 + ly;
    const int gx = x0 + 2 * p;
    if (gy >= H || gx >= W) continue;
    const uint32_t* base = s_win + ly * nw + p;
    uint32_t q;
    if (KIND == SW_K7) {
      uint32_t P = 0, N = 0;
      for (int t = 0; t < d.n_taps[0]; ++t) {
        const int o = s_taps[2 * t];
        const int w = s_taps[2 * t + 1];
        const uint32_t v = sw_pair(base + (o >> 1), o & 1);
        if (w > 0) {
          P += v * (uint32_t)w;
        } else {
          N += v * (uint32_t)(-w);
        }
      }
      const uint32_t bias = (uint32_t)d.bias * 0x00010001u;
      q = __vminu2(__vsubus2((bias + P) - N, bias), 0x00FF00FFu);
    } else {
      const int n0 = d.n_taps[0];
      int a0 = 0, a1 = 0, b0 = 0, b1 = 0;  // kernel 0 and 1, fields 0 and 1
      for (int t = 0; t < n0; ++t) sw_lane_taps(base, s_taps + 2 * t, a0, a1);
      if (d.combine) {
        for (int t = n0; t < n0 + d.n_taps[1]; ++t) sw_lane_taps(base, s_taps + 2 * t, b0, b1);
      }
      q = (uint32_t)sw_finish(a0, b0, d) | ((uint32_t)sw_finish(a1, b1, d) << 16);
    }
    if (d.interior) {
      const uint32_t c = sw_pair(base + (centre >> 1), centre & 1);
      const uint32_t m = (sw_filtered(row0 + gy, gx, image_h, W, h) ? 0x0000FFFFu : 0u) |
                         (sw_filtered(row0 + gy, gx + 1, image_h, W, h) ? 0xFFFF0000u : 0u);
      q = (q & m) | (c & ~m);
    }
    if (KIND == SW_K7) {
      q = sw_chain_fields(q, post, d.n_post);
    } else {
      q = (uint32_t)sw_chain_lane((int)(q & 0xFFFFu), post, d.n_post) |
          ((uint32_t)sw_chain_lane((int)(q >> 16), post, d.n_post) << 16);
    }
    sw_store(out + (long long)gy * W + gx, q);
  }
}

template <int KIND, bool GHOST>
static int sw_launch(const unsigned char* in, const unsigned char* top,
                     const unsigned char* bot, unsigned char* out, int H, int W,
                     int row0, int image_h, const SwarDesc* d, int tile_h,
                     cudaStream_t stream) {
  const size_t smem = sw_smem_bytes(KIND, tile_h, d->halo);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swar_stencil_kernel<KIND, GHOST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + SW_TILE_W - 1) / SW_TILE_W, (H + tile_h - 1) / tile_h);
  swar_stencil_kernel<KIND, GHOST><<<grid, SW_THREADS, smem, stream>>>(
      in, top, bot, out, H, W, row0, image_h, *d, tile_h);
  return (int)cudaGetLastError();
}

template <bool GHOST>
static int sw_dispatch(const unsigned char* in, const unsigned char* top,
                       const unsigned char* bot, unsigned char* out, int H, int W,
                       int row0, int image_h, const SwarDesc* d, int tile_h,
                       cudaStream_t s) {
  switch (d->kind) {
    case SW_K6_NARROW:
      return sw_launch<SW_K6_NARROW, GHOST>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
    case SW_K6_WIDE:
      return sw_launch<SW_K6_WIDE, GHOST>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
    case SW_K7:
      return sw_launch<SW_K7, GHOST>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
    case SW_K8:
      return sw_launch<SW_K8, GHOST>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6, K7 or K8 (d->kind) over an (H, W) u8 plane whose first row is global
// row `row0` of an image `image_h` rows high (the interior guard's
// coordinates; 0 and H for a whole image), on `stream`. Ghost mode when
// `top` and `bot` are given: the plane is a row-shard and `top` / `bot` are
// its raw (halo, W) ghost strips. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int swar_stencil_launch(const unsigned char* in, const unsigned char* top,
                                   const unsigned char* bot, unsigned char* out, int H,
                                   int W, int row0, int image_h, const SwarDesc* d,
                                   int tile_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (W % 4 || tile_h < 1 || d->halo < 0 || d->n_pre < 0 || d->n_post < 0 ||
      d->n_pre + d->n_post > 2 * SW_MAX_CHAIN || (top == nullptr) != (bot == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (top != nullptr) {
    if (d->halo < 1) return (int)cudaErrorInvalidValue;
    return sw_dispatch<true>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
  }
  return sw_dispatch<false>(in, top, bot, out, H, W, row0, image_h, d, tile_h, s);
}

// Dynamic shared memory one launch needs, and the descriptor's size, for
// the host-side checks.
extern "C" long long swar_smem_bytes(int kind, int tile_h, int halo) {
  return (long long)sw_smem_bytes(kind, tile_h, halo);
}

extern "C" long long swar_desc_bytes() { return (long long)sizeof(SwarDesc); }
