// K2: the fused [pointwise*, stencil] group kernel, full-image mode.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           _stream_kernel with ghosts=False (the pallas_call in run_group
//           for groups that end in a stencil).
// Computes: the group's pointwise prologue (pointwise.cuh), then one
//           stencil with in-kernel edge extension (reflect101 / edge; the
//           interior mode clamps, since its border outputs pass through),
//           the interior-mode passthrough at global coordinates, the
//           scale multiply and the quantizer. Families: corr, magnitude,
//           separable, min, max, median (3x3 and 5x5 networks).
// Bound on the H100: device memory for every family but the 5x5 median.
//           Each pixel reads c_in bytes and writes c_out bytes once from
//           device memory: the 8K reference group (3 B in, 1 B out) takes
//           at least 39.6 us at 3.35 TB/s, the 8K RGB gaussian:5 (3 + 3 B)
//           59.4 us. A 5x5 median runs 113 min/max pairs per pixel and
//           plane and may be bound by operations instead.
// Design:   a 2-D grid of output tiles (ST_TILE_W columns x tile_h rows,
//           256 threads). The TPU kernel walks row blocks in order and
//           carries the row pass in scratch memory; Hopper blocks run in
//           no order, so each block instead loads its own window with a
//           halo of h rows and columns (reading (tile_h+2h)(128+2h)/
//           (tile_h*128) times the tile, 1.44 for 16 x 128 tiles at h = 3,
//           the overlap mostly from L2). The window passes through the pointwise chain once and
//           is kept as u8 in shared memory (its values are exact integers);
//           separable and min/max stencils add a float32 row pass in shared
//           memory. Arithmetic repeats the golden float32 order with IEEE
//           rounding (built with -fmad=false; __fsqrt_rn for magnitude).

#include "pointwise.cuh"

#define ST_TILE_W 128
#define ST_THREADS 256
#define ST_MAX_K 7

enum StFamily {
  ST_CORR = 0,
  ST_MAGNITUDE = 1,
  ST_SEPARABLE = 2,
  ST_MIN = 3,
  ST_MAX = 4,
  ST_MEDIAN = 5,
};

enum StEdge { ST_EDGE_INTERIOR = 0, ST_EDGE_REFLECT101 = 1, ST_EDGE_EDGE = 2 };

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

// Source index of coordinate c on an axis of length n: the same rule as
// _src_col in the TPU kernel for reflect101 and edge. Interior mode, and
// reflected indices that no valid output reads, clamp into the image.
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

__device__ __forceinline__ float st_quantize(float x, int mode) {
  return mode == ST_TRUNC_CLIP ? pw_trunc_clip(x) : pw_rint_clip(x);
}

// Shared memory: the post-pointwise u8 window per output plane, then (for
// separable and min/max) the float32 row pass per plane.
__host__ __device__ inline size_t st_smem_bytes(int c_out, int tile_h, int halo,
                                                int family) {
  const size_t eh = tile_h + 2 * halo, ew = ST_TILE_W + 2 * halo;
  size_t bytes = (size_t)c_out * eh * ew;
  bytes = (bytes + 15) & ~(size_t)15;
  if (family == ST_SEPARABLE || family == ST_MIN || family == ST_MAX) {
    bytes += (size_t)c_out * eh * ST_TILE_W * sizeof(float);
  }
  return bytes;
}

template <int KS>
__global__ void __launch_bounds__(ST_THREADS)
stream_stencil_kernel(const unsigned char* __restrict__ in,
                      unsigned char* __restrict__ out, int H, int W, int c_in,
                      int c_out, const __grid_constant__ PwProgram prog,
                      const __grid_constant__ StencilDesc st, int tile_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int h = KS / 2;
  const int ew = ST_TILE_W + 2 * h;
  const int eh = tile_h + 2 * h;
  const int x0 = blockIdx.x * ST_TILE_W;
  const int y0 = blockIdx.y * tile_h;
  const int fam = st.family;
  unsigned char* s_pix = smem;
  float* s_row = reinterpret_cast<float*>(
      smem + (((size_t)c_out * eh * ew + 15) & ~(size_t)15));

  // 1-3. Window load with edge extension by index, pointwise chain, u8
  // planes into shared memory.
  for (int i = threadIdx.x; i < eh * ew; i += ST_THREADS) {
    const int wy = i / ew;
    const int wx = i - wy * ew;
    const int gy = st_src(y0 + wy - h, H, st.edge_mode);
    const int gx = st_src(x0 + wx - h, W, st.edge_mode);
    float v[3];
    pw_load(in + ((long long)gy * W + gx) * c_in, v, c_in);
    pw_apply(prog, v, c_in);
    s_pix[wy * ew + wx] = pw_to_u8(v[0]);
    if (c_out > 1) {
      s_pix[(eh + wy) * ew + wx] = pw_to_u8(v[1]);
      s_pix[(2 * eh + wy) * ew + wx] = pw_to_u8(v[2]);
    }
  }
  __syncthreads();

  // 4a. Row pass of separable and min/max stencils.
  const bool two_pass = fam == ST_SEPARABLE || fam == ST_MIN || fam == ST_MAX;
  if (two_pass) {
    for (int i = threadIdx.x; i < c_out * eh * ST_TILE_W; i += ST_THREADS) {
      const int x = i % ST_TILE_W;
      const int r = i / ST_TILE_W;  // plane * eh + row
      const unsigned char* row = s_pix + r * ew + x;
      float acc = 0.0f;
      if (fam == ST_SEPARABLE) {
        bool first = true;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const float wt = st.sep[k];
          if (wt == 0.0f) continue;
          const float v = (float)row[k];
          const float t = wt == 1.0f ? v : __fmul_rn(v, wt);
          acc = first ? t : __fadd_rn(acc, t);
          first = false;
        }
      } else {
        acc = (float)row[0];
#pragma unroll
        for (int k = 1; k < KS; ++k) {
          const float v = (float)row[k];
          acc = fam == ST_MIN ? fminf(acc, v) : fmaxf(acc, v);
        }
      }
      s_row[r * ST_TILE_W + x] = acc;
    }
    __syncthreads();
  }

  // 4b-5. Column pass or 2-D window per output, scale, quantize, interior
  // passthrough.
  for (int i = threadIdx.x; i < tile_h * ST_TILE_W; i += ST_THREADS) {
    const int ly = i / ST_TILE_W;
    const int lx = i - ly * ST_TILE_W;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    bool filtered = true;
    if (st.edge_mode == ST_EDGE_INTERIOR) {
      filtered = gx > h && gx <= W - 1 - h && gy > h && gy <= H - 1 - h;
    }
    unsigned char* q = out + ((long long)gy * W + gx) * c_out;
    for (int c = 0; c < c_out; ++c) {
      const unsigned char* win = s_pix + (c * eh + ly) * ew + lx;
      float res;
      if (!filtered) {
        res = (float)win[h * ew + h];
      } else {
        float acc;
        if (two_pass) {
          const float* col = s_row + (c * eh + ly) * ST_TILE_W + lx;
          if (fam == ST_SEPARABLE) {
            acc = 0.0f;
            bool first = true;
#pragma unroll
            for (int k = 0; k < KS; ++k) {
              const float wt = st.sep[k];
              if (wt == 0.0f) continue;
              const float v = col[k * ST_TILE_W];
              const float t = wt == 1.0f ? v : __fmul_rn(v, wt);
              acc = first ? t : __fadd_rn(acc, t);
              first = false;
            }
          } else {
            acc = col[0];
#pragma unroll
            for (int k = 1; k < KS; ++k) {
              const float v = col[k * ST_TILE_W];
              acc = fam == ST_MIN ? fminf(acc, v) : fmaxf(acc, v);
            }
          }
        } else if (fam == ST_MEDIAN) {
          acc = st_median<KS>(win, ew);
        } else {
          acc = st_corr<KS>(win, ew, st.w0);
          if (fam == ST_MAGNITUDE) {
            const float b = st_corr<KS>(win, ew, st.w1);
            acc = __fsqrt_rn(__fadd_rn(__fmul_rn(acc, acc), __fmul_rn(b, b)));
          }
        }
        // min/max/median results are never scaled (spec.StencilOp.valid)
        if (fam <= ST_SEPARABLE && st.scale != 1.0f) acc = __fmul_rn(acc, st.scale);
        res = st_quantize(acc, st.quantize);
      }
      q[c] = pw_to_u8(res);
    }
  }
}

template <int KS>
static int st_launch(const unsigned char* in, unsigned char* out, int H, int W,
                     int c_in, int c_out, const PwProgram* prog,
                     const StencilDesc* st, int tile_h, cudaStream_t stream) {
  const size_t smem = st_smem_bytes(c_out, tile_h, st->halo, st->family);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_stencil_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + ST_TILE_W - 1) / ST_TILE_W, (H + tile_h - 1) / tile_h);
  stream_stencil_kernel<KS><<<grid, ST_THREADS, smem, stream>>>(
      in, out, H, W, c_in, c_out, *prog, *st, tile_h);
  return (int)cudaGetLastError();
}

// Launches K2 on `stream`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a kernel size this source has no instance of.
extern "C" int stream_stencil_launch(const unsigned char* in, unsigned char* out,
                                     int H, int W, int c_in, int c_out,
                                     const PwProgram* prog, const StencilDesc* st,
                                     int tile_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (st->ksize) {
    case 1: return st_launch<1>(in, out, H, W, c_in, c_out, prog, st, tile_h, s);
    case 3: return st_launch<3>(in, out, H, W, c_in, c_out, prog, st, tile_h, s);
    case 5: return st_launch<5>(in, out, H, W, c_in, c_out, prog, st, tile_h, s);
    case 7: return st_launch<7>(in, out, H, W, c_in, c_out, prog, st, tile_h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one launch needs, for the host-side check.
extern "C" long long stream_stencil_smem_bytes(int c_out, int tile_h, int halo,
                                               int family) {
  return (long long)st_smem_bytes(c_out, tile_h, halo, family);
}
