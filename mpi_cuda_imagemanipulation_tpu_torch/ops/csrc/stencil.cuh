// Per-family stencil arithmetic shared by the fused stencil kernel
// (stream_stencil.cu, K2) and the fused plan-stage megakernel
// (fused_stage.cu, K4).
//
// Every function repeats the golden float32 order of ops/spec.py
// (StencilOp.valid / finalize_f32): taps in row-major order with zero taps
// skipped and the first nonzero tap starting the sum, one IEEE-rounded
// step per product and sum (__fmul_rn / __fadd_rn; the sources are built
// with -fmad=false), __fsqrt_rn for the magnitude, a single scale multiply
// and the quantizer. Inputs are u8 windows in shared memory; each
// function reads `KS` taps per axis from a pointer and a row stride, so
// the two kernels' layouts can differ.

#pragma once

#include <stdint.h>

#include "pointwise.cuh"

#define ST_MAX_K 7

enum StFamily {
  ST_CORR = 0,
  ST_MAGNITUDE = 1,
  ST_SEPARABLE = 2,
  ST_MIN = 3,
  ST_MAX = 4,
  ST_MEDIAN = 5,
};

enum StEdge {
  ST_EDGE_INTERIOR = 0,
  ST_EDGE_REFLECT101 = 1,
  ST_EDGE_EDGE = 2,
  ST_EDGE_ZERO = 3,
};

enum StQuant { ST_TRUNC_CLIP = 0, ST_RINT_CLIP = 1 };

struct StencilDesc {
  int family;
  int halo;
  int ksize;  // 2 * halo + 1
  int edge_mode;
  int quantize;
  float scale;
  float w0[ST_MAX_K * ST_MAX_K];  // first kernel, w0[dy * ksize + dx]
  float w1[ST_MAX_K * ST_MAX_K];  // second kernel (magnitude), same layout
  float sep[ST_MAX_K];            // separable 1-D weights
};

// The median selection networks: the same pair lists as
// spec.MEDIAN_NETWORKS (a test holds them equal). X(i, j) puts min into
// wire i and max into wire j; the median ends on wire 4 (3x3) or 12 (5x5).
#define ST_MEDIAN9_PAIRS(X)                                                 \
  X(1,2) X(4,5) X(7,8) X(0,1) X(3,4) X(6,7) X(1,2) X(4,5) X(7,8) X(0,3)     \
  X(5,8) X(4,7) X(3,6) X(1,4) X(2,5) X(4,7) X(4,2) X(6,4) X(4,2)

#define ST_MEDIAN25_PAIRS(X)                                                \
  X(0,1) X(2,3) X(4,5) X(6,7) X(8,9) X(10,11) X(12,13) X(14,15) X(16,17)    \
  X(18,19) X(20,21) X(22,23) X(0,2) X(1,3) X(4,6) X(5,7) X(8,10) X(9,11)    \
  X(12,14) X(13,15) X(16,18) X(17,19) X(20,22) X(21,23) X(1,2) X(5,6)       \
  X(9,10) X(13,14) X(17,18) X(21,22) X(0,4) X(1,5) X(2,6) X(3,7) X(8,12)    \
  X(9,13) X(10,14) X(11,15) X(16,20) X(17,21) X(18,22) X(19,23) X(2,4)      \
  X(3,5) X(10,12) X(11,13) X(18,20) X(19,21) X(1,2) X(3,4) X(5,6) X(9,10)   \
  X(11,12) X(13,14) X(17,18) X(19,20) X(21,22) X(0,8) X(1,9) X(2,10)        \
  X(3,11) X(4,12) X(5,13) X(6,14) X(7,15) X(16,24) X(4,8) X(5,9) X(6,10)    \
  X(7,11) X(20,24) X(2,4) X(3,5) X(6,8) X(7,9) X(10,12) X(11,13) X(18,20)   \
  X(19,21) X(22,24) X(1,2) X(3,4) X(5,6) X(7,8) X(9,10) X(11,12) X(13,14)   \
  X(17,18) X(19,20) X(21,22) X(23,24) X(0,16) X(1,17) X(2,18) X(3,19)       \
  X(4,20) X(5,21) X(6,22) X(7,23) X(8,24) X(8,16) X(9,17) X(10,18)          \
  X(11,19) X(12,20) X(13,21) X(6,10) X(7,11) X(12,16) X(13,17) X(10,12)     \
  X(11,13) X(11,12)

#define ST_EXCHANGE(i, j)               \
  {                                     \
    const float lo = fminf(p[i], p[j]); \
    const float hi = fmaxf(p[i], p[j]); \
    p[i] = lo;                          \
    p[j] = hi;                          \
  }

// Whether the family runs as a row pass into float32 scratch, then a
// column pass.
__host__ __device__ inline bool st_two_pass(int family) {
  return family == ST_SEPARABLE || family == ST_MIN || family == ST_MAX;
}

// Source index of coordinate c on an axis of length n for reflect101 and
// edge, as _src_col in the TPU kernels. Interior and zero modes, and
// reflected indices that no kept output reads, clamp into the image.
__device__ __forceinline__ int st_src(int c, int n, int mode) {
  if (mode == ST_EDGE_REFLECT101 && (c < 0 || c >= n)) {
    c = c < 0 ? -c : 2 * (n - 1) - c;
  }
  return min(max(c, 0), n - 1);
}

// Valid-mode correlation at one output: taps in row-major order, zero taps
// skipped, the first nonzero tap starting the sum (spec.corr_valid).
template <int KS>
__device__ __forceinline__ float st_corr(const unsigned char* win, int ew,
                                         const float* w) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const float wt = w[dy * KS + dx];
      if (wt == 0.0f) continue;
      const float v = (float)win[dy * ew + dx];
      const float t = wt == 1.0f ? v : __fmul_rn(v, wt);
      acc = first ? t : __fadd_rn(acc, t);
      first = false;
    }
  }
  return acc;
}

template <int KS>
__device__ __forceinline__ float st_median(const unsigned char* win, int ew) {
  float p[KS * KS];
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) p[dy * KS + dx] = (float)win[dy * ew + dx];
  }
  if constexpr (KS == 3) {
    ST_MEDIAN9_PAIRS(ST_EXCHANGE)
    return p[4];
  } else if constexpr (KS == 5) {
    ST_MEDIAN25_PAIRS(ST_EXCHANGE)
    return p[12];
  } else {
    return p[KS * KS / 2];  // no median network of this size; rejected on the host
  }
}

// The unscaled accumulator of a one-pass family (corr, magnitude,
// median) at one output, from its KS x KS window.
template <int KS>
__device__ __forceinline__ float st_window(const unsigned char* win, int ew,
                                           const StencilDesc& st) {
  if (st.family == ST_MEDIAN) return st_median<KS>(win, ew);
  float acc = st_corr<KS>(win, ew, st.w0);
  if (st.family == ST_MAGNITUDE) {
    const float b = st_corr<KS>(win, ew, st.w1);
    acc = __fsqrt_rn(__fadd_rn(__fmul_rn(acc, acc), __fmul_rn(b, b)));
  }
  return acc;
}

// Weighted 1-D sum of KS taps at stride `stride` (separable passes).
template <int KS, typename T>
__device__ __forceinline__ float st_sep_sum(const T* x, int stride,
                                            const float* w) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float wt = w[k];
    if (wt == 0.0f) continue;
    const float v = (float)x[k * stride];
    const float t = wt == 1.0f ? v : __fmul_rn(v, wt);
    acc = first ? t : __fadd_rn(acc, t);
    first = false;
  }
  return acc;
}

// Sliding min or max of KS taps at stride `stride`.
template <int KS, typename T>
__device__ __forceinline__ float st_reduce(const T* x, int stride, bool is_min) {
  float acc = (float)x[0];
#pragma unroll
  for (int k = 1; k < KS; ++k) {
    const float v = (float)x[k * stride];
    acc = is_min ? fminf(acc, v) : fmaxf(acc, v);
  }
  return acc;
}

// Row pass of a two-pass family: KS taps along a u8 row.
template <int KS>
__device__ __forceinline__ float st_row_pass(const unsigned char* row,
                                             const StencilDesc& st) {
  if (st.family == ST_SEPARABLE) return st_sep_sum<KS>(row, 1, st.sep);
  return st_reduce<KS>(row, 1, st.family == ST_MIN);
}

// Column pass of a two-pass family: KS taps down the float32 row-pass
// scratch, `stride` floats apart.
template <int KS>
__device__ __forceinline__ float st_col_pass(const float* col, int stride,
                                             const StencilDesc& st) {
  if (st.family == ST_SEPARABLE) return st_sep_sum<KS>(col, stride, st.sep);
  return st_reduce<KS>(col, stride, st.family == ST_MIN);
}

__device__ __forceinline__ float st_quantize(float x, int mode) {
  return mode == ST_TRUNC_CLIP ? pw_trunc_clip(x) : pw_rint_clip(x);
}

// Scale (corr, magnitude and separable only: min/max/median results are
// never scaled, spec.StencilOp.valid) and quantize an accumulator.
__device__ __forceinline__ float st_finish(float acc, const StencilDesc& st) {
  if (st.family <= ST_SEPARABLE && st.scale != 1.0f) acc = __fmul_rn(acc, st.scale);
  return st_quantize(acc, st.quantize);
}

// The reference guard of 'interior' mode (kernel.cu:83) at global
// coordinates: only outputs whose whole window lies inside the image are
// filtered; the rest pass the op's input through.
__device__ __forceinline__ bool st_filtered(int gy, int gx, int H, int W, int h,
                                            int mode) {
  if (mode != ST_EDGE_INTERIOR) return true;
  return gx > h && gx <= W - 1 - h && gy > h && gy <= H - 1 - h;
}

// The strip forms, shared by K2 and K4: four adjacent outputs per thread,
// each window row's 4 + KS - 1 bytes read as words once and reused for
// all four, each output's taps in the order of the one-output functions
// above.

// The first NB bytes at `p` (4-byte aligned, in shared memory) as floats,
// read as words.
template <int NB>
__device__ __forceinline__ void st_row_bytes(const unsigned char* p, float f[NB]) {
  constexpr int NW = (NB + 3) / 4;
  uint32_t w[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = reinterpret_cast<const uint32_t*>(p)[k];
#pragma unroll
  for (int b = 0; b < NB; ++b) f[b] = (float)((w[b >> 2] >> (8 * (b & 3))) & 0xFFu);
}

// Four adjacent outputs of a one-pass family (corr, magnitude, median)
// from the window rows at `win` (`pitch` bytes apart), each output's taps
// in stencil.cuh's order; `center` gets the four window centres.
template <int KS>
__device__ __forceinline__ void st_strip_window(const unsigned char* win, int pitch,
                                                const StencilDesc& st, float acc[4],
                                                float center[4]) {
  constexpr int h = KS / 2;
  constexpr int NB = 4 + KS - 1;
  if constexpr (KS == 3 || KS == 5) {
    if (st.family == ST_MEDIAN) {
      // each row's 4 + KS - 1 bytes kept as two words; one output at a time
      // (a 25-value network is live per output), its row bytes shifted out
      // of the words, so the network's registers are not held four times
      static_assert(NB <= 8, "a median row fits two words");
      uint64_t w[KS];
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
        const uint32_t* r = reinterpret_cast<const uint32_t*>(win + dy * pitch);
        w[dy] = (uint64_t)r[1] << 32 | r[0];
      }
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        float p[KS * KS];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const uint64_t row = w[dy] >> (8 * j);
#pragma unroll
          for (int dx = 0; dx < KS; ++dx) p[dy * KS + dx] = (float)((row >> (8 * dx)) & 0xFFu);
        }
        const float c = p[h * KS + h];
        if constexpr (KS == 3) {
          ST_MEDIAN9_PAIRS(ST_EXCHANGE)
        } else {
          ST_MEDIAN25_PAIRS(ST_EXCHANGE)
        }
        // static indices into the results (a dynamic one would put them in
        // local memory)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k == j) {
            acc[k] = p[KS * KS / 2];
            center[k] = c;
          }
        }
      }
      return;
    }
  }
  const bool magnitude = st.family == ST_MAGNITUDE;
  float b[4];
  bool first_a = true, first_b = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = b[j] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
    float f[NB];
    st_row_bytes<NB>(win + dy * pitch, f);
    if (dy == h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) center[j] = f[j + h];
    }
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const float wa = st.w0[dy * KS + dx];
      if (wa != 0.0f) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t = wa == 1.0f ? f[j + dx] : __fmul_rn(f[j + dx], wa);
          acc[j] = first_a ? t : __fadd_rn(acc[j], t);
        }
        first_a = false;
      }
      if (!magnitude) continue;
      const float wb = st.w1[dy * KS + dx];
      if (wb != 0.0f) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t = wb == 1.0f ? f[j + dx] : __fmul_rn(f[j + dx], wb);
          b[j] = first_b ? t : __fadd_rn(b[j], t);
        }
        first_b = false;
      }
    }
  }
  if (magnitude) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = __fsqrt_rn(__fadd_rn(__fmul_rn(acc[j], acc[j]), __fmul_rn(b[j], b[j])));
    }
  }
}

// One tap of a separable sum or a min/max reduction over four lanes.
__device__ __forceinline__ void st_tap4(float acc[4], const float* v, float wt, bool& first,
                                        int family) {
  if (family == ST_SEPARABLE) {
    if (wt == 0.0f) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = wt == 1.0f ? v[j] : __fmul_rn(v[j], wt);
      acc[j] = first ? t : __fadd_rn(acc[j], t);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = first ? v[j] : (family == ST_MIN ? fminf(acc[j], v[j]) : fmaxf(acc[j], v[j]));
    }
  }
  first = false;
}

// Four adjacent row-pass values of a two-pass family from the u8 row at
// `row` (st_row_pass's taps).
template <int KS>
__device__ __forceinline__ float4 st_strip_row_pass(const unsigned char* row,
                                                    const StencilDesc& st) {
  constexpr int NB = 4 + KS - 1;
  float f[NB];
  st_row_bytes<NB>(row, f);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool first = true;
#pragma unroll
  for (int k = 0; k < KS; ++k) st_tap4(acc, f + k, st.sep[k], first, st.family);
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// Four adjacent column-pass values from the float32 row pass at `col`
// (`pitch` floats a row; st_col_pass's taps).
template <int KS>
__device__ __forceinline__ void st_strip_col_pass(const float* col, int pitch,
                                                  const StencilDesc& st, float acc[4]) {
  bool first = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float4 r = *reinterpret_cast<const float4*>(col + k * pitch);
    const float v[4] = {r.x, r.y, r.z, r.w};
    st_tap4(acc, v, st.sep[k], first, st.family);
  }
}
