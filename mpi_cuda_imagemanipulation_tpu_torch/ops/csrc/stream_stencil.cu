// K2, K2g and K3: the fused [pointwise*, stencil] group kernel in its
// full-image mode, its ghost mode over one row-shard, and the stencil over
// a pre-extended shard tile. One kernel template, three entry points.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           K2:  _stream_kernel with ghosts=False (the pallas_call in
//                run_group for groups that end in a stencil);
//           K2g: _stream_kernel with ghosts=True (run_group(ghosts=...),
//                stencil_tile_pallas_fused), the row-sharded fast path;
//           K3:  stencil_tile_pallas, the row-sharded fallback over a
//                materialised extended tile.
// Computes: the group's pointwise prologue (pointwise.cuh), then one
//           stencil with in-kernel edge extension (reflect101 / edge; the
//           interior mode clamps, since its border outputs pass through),
//           the interior-mode passthrough at global coordinates, the
//           scale multiply and the quantizer. Families: corr, magnitude,
//           separable, min, max, median (3x3 and 5x5 networks).
//           Ghost mode (K2g) runs the same group over a (local_h, W) shard
//           tile whose first row is global row `row0`: rows above and below
//           the tile come from two raw (halo, W) ghost strips (the
//           neighbours' rows, or the edge extension the host synthesised on
//           the first and last shard), the pointwise chain runs on strip
//           pixels as on tile pixels, and the interior passthrough follows
//           global rows against the true image height. K3 is ghost mode
//           over one (local_h + 2 halo, W) array (its first and last halo
//           rows are the strips), with an empty pointwise program, zero-mode
//           columns read as 0, and no passthrough: its caller applies the
//           interior mask.
// Bound on the H100: device memory for every family but the 5x5 median.
//           Each pixel reads c_in bytes and writes c_out bytes once from
//           device memory: the 8K reference group (3 B in, 1 B out) takes
//           at least 39.6 us at 3.35 TB/s, the 8K RGB gaussian:5 (3 + 3 B)
//           59.4 us. A 5x5 median runs 113 min/max pairs per pixel and
//           plane and may be bound by operations instead. The ghost modes
//           run per shard: on one 1080 x 7680 shard of that frame the
//           reference group moves 33.2 MB (9.9 us), gaussian:5 49.8 MB
//           (14.9 us), K3 the same bytes as K2g on the same stencil.
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

// The three modes of the kernel, a template parameter so that each compiles
// without the others' branches: the whole image (K2), one row-shard with
// ghost strips (K2g), a pre-extended tile (K3).
enum StMode { ST_FULL = 0, ST_GHOST = 1, ST_TILE = 2 };

template <int KS, int MODE>
__global__ void __launch_bounds__(ST_THREADS)
stream_stencil_kernel(const unsigned char* __restrict__ in,
                      unsigned char* __restrict__ out, int H, int W, int c_in,
                      int c_out, const __grid_constant__ PwProgram prog,
                      const __grid_constant__ StencilDesc st, int tile_h,
                      const unsigned char* __restrict__ top,
                      const unsigned char* __restrict__ bot, int row0,
                      int image_h) {
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
  // planes into shared memory. Full mode extends rows by index; the ghost
  // modes take the rows beyond the tile from the strips (rows past a strip
  // feed only outputs below the tile, which are not stored).
  constexpr bool ghosts = MODE != ST_FULL;
  // K3 pads columns as the golden pad2d does: zeros for zero mode and for
  // interior mode (whose border outputs its caller then passes through)
  const bool zero_cols =
      MODE == ST_TILE &&
      (st.edge_mode == ST_EDGE_ZERO || st.edge_mode == ST_EDGE_INTERIOR);
  for (int i = threadIdx.x; i < eh * ew; i += ST_THREADS) {
    const int wy = i / ew;
    const int wx = i - wy * ew;
    const int ty = y0 + wy - h;  // row of the tile
    const unsigned char* row;
    if (!ghosts) {
      row = in + (long long)st_src(ty, H, st.edge_mode) * W * c_in;
    } else if (h > 0 && ty < 0) {
      row = top + (long long)(h + ty) * W * c_in;
    } else if (h > 0 && ty >= H) {
      row = bot + (long long)min(ty - H, h - 1) * W * c_in;
    } else {
      row = in + (long long)min(ty, H - 1) * W * c_in;
    }
    const int cx = x0 + wx - h;
    const int gx = st_src(cx, W, st.edge_mode);
    float v[3];
    pw_load(row + (long long)gx * c_in, v, c_in);
    pw_apply(prog, v, c_in);
    if (zero_cols && (cx < 0 || cx >= W)) v[0] = v[1] = v[2] = 0.0f;
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
    // the interior passthrough at global rows; K3 leaves it to its caller
    const bool filtered =
        MODE == ST_TILE ||
        (MODE == ST_FULL ? st_filtered(gy, gx, H, W, h, st.edge_mode)
                         : st_filtered(row0 + gy, gx, image_h, W, h, st.edge_mode));
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

template <int KS, int MODE>
static int st_launch(const unsigned char* in, unsigned char* out, int H, int W,
                     int c_in, int c_out, const PwProgram* prog,
                     const StencilDesc* st, int tile_h, const unsigned char* top,
                     const unsigned char* bot, int row0, int image_h,
                     cudaStream_t stream) {
  const size_t smem = st_smem_bytes(c_out, tile_h, st->halo, st->family);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_stencil_kernel<KS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + ST_TILE_W - 1) / ST_TILE_W, (H + tile_h - 1) / tile_h);
  stream_stencil_kernel<KS, MODE><<<grid, ST_THREADS, smem, stream>>>(
      in, out, H, W, c_in, c_out, *prog, *st, tile_h, top, bot, row0, image_h);
  return (int)cudaGetLastError();
}

// Launches the kernel for the stencil's size. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a kernel size this source
// has no instance of.
template <int MODE>
static int st_dispatch(const unsigned char* in, unsigned char* out, int H, int W,
                       int c_in, int c_out, const PwProgram* prog,
                       const StencilDesc* st, int tile_h, const unsigned char* top,
                       const unsigned char* bot, int row0, int image_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define ST_CASE(KS)                                                         \
  case KS:                                                                  \
    return st_launch<KS, MODE>(in, out, H, W, c_in, c_out, prog, st, tile_h, \
                               top, bot, row0, image_h, s);
  switch (st->ksize) {
    ST_CASE(1)
    ST_CASE(3)
    ST_CASE(5)
    ST_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ST_CASE
}

// K2: the group over a whole (H, W) image, on `stream`.
extern "C" int stream_stencil_launch(const unsigned char* in, unsigned char* out,
                                     int H, int W, int c_in, int c_out,
                                     const PwProgram* prog, const StencilDesc* st,
                                     int tile_h, void* stream) {
  return st_dispatch<ST_FULL>(in, out, H, W, c_in, c_out, prog, st, tile_h, nullptr,
                              nullptr, 0, H, stream);
}

// K2g: the group over a (local_h, W) row-shard whose first row is global
// row `row0` of an image `image_h` rows high, with its raw (halo, W) ghost
// strips `top` and `bot`. The stencil's halo must be at least 1.
extern "C" int stream_stencil_ghost_launch(const unsigned char* tile,
                                           const unsigned char* top,
                                           const unsigned char* bot,
                                           unsigned char* out, int local_h, int W,
                                           int c_in, int c_out, const PwProgram* prog,
                                           const StencilDesc* st, int tile_h, int row0,
                                           int image_h, void* stream) {
  if (st->halo < 1 || top == nullptr || bot == nullptr) return (int)cudaErrorInvalidValue;
  return st_dispatch<ST_GHOST>(tile, out, local_h, W, c_in, c_out, prog, st, tile_h,
                               top, bot, row0, image_h, stream);
}

// K3: the stencil alone (valid rows, quantized, no passthrough) over a
// pre-extended (local_h + 2 halo, W) array of `c` interleaved channels;
// writes (local_h, W).
extern "C" int stencil_tile_launch(const unsigned char* ext, unsigned char* out,
                                   int local_h, int W, int c, const StencilDesc* st,
                                   int tile_h, void* stream) {
  PwProgram none = {};  // no pointwise ops
  const long long strip = (long long)st->halo * W * c;
  return st_dispatch<ST_TILE>(ext + strip, out, local_h, W, c, c, &none, st, tile_h,
                              ext, ext + strip + (long long)local_h * W * c, 0, local_h,
                              stream);
}

// Dynamic shared memory one launch needs, for the host-side check.
extern "C" long long stream_stencil_smem_bytes(int c_out, int tile_h, int halo,
                                               int family) {
  return (long long)st_smem_bytes(c_out, tile_h, halo, family);
}
