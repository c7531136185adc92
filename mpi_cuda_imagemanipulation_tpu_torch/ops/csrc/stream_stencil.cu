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
// Arithmetic: the per-family functions of stencil.cuh, shared with K4.
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

#include "stencil.cuh"

#define ST_TILE_W 128
#define ST_THREADS 256

// Shared memory: the post-pointwise u8 window per output plane, then (for
// separable and min/max) the float32 row pass per plane.
__host__ __device__ inline size_t st_smem_bytes(int c_out, int tile_h, int halo,
                                                int family) {
  const size_t eh = tile_h + 2 * halo, ew = ST_TILE_W + 2 * halo;
  size_t bytes = (size_t)c_out * eh * ew;
  bytes = (bytes + 15) & ~(size_t)15;
  if (st_two_pass(family)) {
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
  const bool two_pass = st_two_pass(fam);
  if (two_pass) {
    for (int i = threadIdx.x; i < c_out * eh * ST_TILE_W; i += ST_THREADS) {
      const int x = i % ST_TILE_W;
      const int r = i / ST_TILE_W;  // plane * eh + row
      s_row[r * ST_TILE_W + x] = st_row_pass<KS>(s_pix + r * ew + x, st);
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
    const bool filtered = st_filtered(gy, gx, H, W, h, st.edge_mode);
    unsigned char* q = out + ((long long)gy * W + gx) * c_out;
    for (int c = 0; c < c_out; ++c) {
      const unsigned char* win = s_pix + (c * eh + ly) * ew + lx;
      float res;
      if (!filtered) {
        res = (float)win[h * ew + h];
      } else {
        const float acc =
            two_pass ? st_col_pass<KS>(s_row + (c * eh + ly) * ST_TILE_W + lx,
                                       ST_TILE_W, st)
                     : st_window<KS>(win, ew, st);
        res = st_finish(acc, st);
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
