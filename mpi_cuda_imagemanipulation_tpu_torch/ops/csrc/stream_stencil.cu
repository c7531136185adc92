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
// Computes: the group's pointwise prologue (pointwise.cuh, a chain table
//           of any length), then one stencil with in-kernel edge extension
//           (reflect101 / edge; the interior mode clamps, since its border
//           outputs pass through), the interior-mode passthrough at global
//           coordinates, the scale multiply and the quantizer. Families:
//           corr, magnitude, separable, min, max, median (3x3 and 5x5
//           networks). Ghost mode (K2g) runs the same group over a
//           (local_h, W) shard tile whose first row is global row `row0`:
//           rows above and below the tile come from two raw (halo, W) ghost
//           strips (the neighbours' rows, or the edge extension the host
//           synthesised on the first and last shard), the pointwise chain
//           runs on strip pixels as on tile pixels, and the interior
//           passthrough follows global rows against the true image height.
//           K3 is ghost mode over one (local_h + 2 halo, W) array (its first
//           and last halo rows are the strips), with no pointwise chain,
//           zero-mode columns read as 0, and no passthrough: its caller
//           applies the interior mask.
//           Full mode takes a stack of same-shape images (the batched
//           pipeline; the JAX package's vmap of the Pallas kernel, whose
//           rule adds a grid dimension): grid z is the image, each at its
//           own input and output stride, so a stack is one launch.
// Bound on the H100: device memory for every family but the 5x5 median.
//           Each pixel reads c_in bytes and writes c_out bytes once: the 8K
//           reference group (3 B in, 1 B out) takes at least 39.6 us at
//           3.35 TB/s, the 8K RGB gaussian:5 (3 + 3 B) 59.4 us, one
//           1080 x 7680 shard of them 9.9 / 14.9 us. The card's own copy of
//           a u8 plane reaches 55-77% of that rate (tools/roofline_probe).
//           A 5x5 median runs 113 min/max pairs per pixel and plane, over
//           a 25-value network per output that no neighbour shares, and
//           stays bound by operations.
// Arithmetic: the per-family functions of stencil.cuh, the ones K4 uses:
//           the golden float32 order with zero taps skipped, one
//           IEEE-rounded step per product and sum (built with -fmad=false),
//           __fsqrt_rn, rintf, a clip before every u8 store.
// Design:   the first design (one pixel per thread per step, an integer
//           division per window element, an edge-mode branch per row and
//           column, three 1-byte loads per RGB pixel, one output per thread
//           from KS^2 shared-memory bytes, one byte per channel stored,
//           128-column tiles whatever the image) ran at 7-10% of the bytes
//           bound on the main groups. This one:
//           - Tile shape from the work: tile_h rows (the wrappers' tile_h,
//             16 by default or the launch's height if lower) by tile_w =
//             128, 64 or 32 columns, the host narrowing the columns until
//             the grid has 132 blocks where the image allows, so a 2-row
//             overlap band runs 240 blocks of 2 x 32, not 60 of 16 x 128.
//           - Window load: each window row's source is resolved once per
//             block (the row source in full mode, the strips in the ghost
//             modes); warps then copy whole row segments, c_in (tile_w +
//             2 h) contiguous bytes, as 16-byte cp.async granules into a
//             raw staging buffer. The flat loops split their index with a
//             high multiply by a per-block constant, not a division.
//           - Edge extension by column source (st_src) only in blocks that
//             touch the left or right border, a branch uniform over the
//             block; rows need none past the prologue.
//           - The pointwise chain runs once per window pixel from the
//             chain table in shared memory, four pixels per thread, and
//             writes de-interleaved u8 planes as 4-byte words.
//           - Compute: each thread takes 4 adjacent outputs of a row; it
//             loads each window row's 4 + 2 h bytes as words once and
//             reuses them for all four (the row pass of separable and
//             min/max stencils the same, into float32 rows stored as
//             float4; the column pass reads float4s).
//           - Stores: the four outputs' channels interleaved in registers,
//             then one 4-byte word per channel (12 bytes for RGB) where the
//             row pitch allows, else byte stores at the ragged edge.

#include <stdint.h>

#include "device_scope.cuh"
#include "stencil.cuh"
#include "window_load.cuh"

#define ST_THREADS 256
#define ST_MAX_TILE_W 128
#define ST_MIN_TILE_W 32
#define ST_MAX_DEVICES 16
// images of one full-mode launch: CUDA's limit on grid z
#define ST_MAX_IMAGES 65535

// The block's shared memory, in order: the chain table (n_ops PwOp), the
// window rows' sources, the post-pointwise u8 planes (c_out planes of
// tile_h + 2 halo rows, plane_pitch bytes each), then one scratch region
// that holds first the raw interleaved window (raw_pitch bytes a row) and
// then, for separable and min/max, the float32 row pass (c_out planes of
// tile_h + 2 halo rows of tile_w floats).
struct StLayout {
  int plane_pitch;
  int raw_pitch;
  size_t rows_off;
  size_t planes_off;
  size_t scratch_off;
  size_t total;
};

__host__ __device__ inline StLayout st_layout(int c_in, int c_out, int tile_h, int tile_w,
                                              int halo, int family, int n_ops) {
  StLayout L;
  const size_t eh = tile_h + 2 * halo, ew = tile_w + 2 * halo;
  L.plane_pitch = (int)st_round16(ew);
  L.raw_pitch = (int)st_round16(ew * c_in + 15);
  L.rows_off = (size_t)n_ops * sizeof(PwOp);
  L.planes_off = L.rows_off + eh * sizeof(StRow);
  L.scratch_off = L.planes_off + (size_t)c_out * eh * L.plane_pitch;
  const size_t raw = eh * (size_t)L.raw_pitch;
  const size_t row_pass = st_two_pass(family) ? (size_t)c_out * eh * tile_w * sizeof(float) : 0;
  L.total = L.scratch_off + (raw > row_pass ? raw : row_pass);
  return L;
}

// Registers a thread, set so that blocks fit on an SM: four for the 5x5
// instantiations (64 registers; the median branch and the chain's four
// pixels take 72 otherwise, and three blocks ran gaussian:5 at 8K 10%
// slower), five for the others (48; left at 64 the 3x3 full mode took
// them all and ran the reference group 8% slower, and left unbounded the
// 7x7 ones took 203).
template <int KS, int MODE>
__global__ void __launch_bounds__(ST_THREADS, KS == 5 ? 4 : 5)
stream_stencil_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
                      int H, int W, int c_in, int c_out, const PwOp* __restrict__ chain,
                      int n_ops, const __grid_constant__ StencilDesc st, int tile_h,
                      int tile_w, int lg_strips, const unsigned char* __restrict__ top,
                      const unsigned char* __restrict__ bot, int row0, int image_h,
                      long long in_stride, long long out_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the batch axis: grid z is the image of a stack (full mode; 1 in the
  // ghost modes), its offset taken in 64 bits (a stack of 8K RGB frames
  // passes 2^31 bytes at its 22nd)
  in += (long long)blockIdx.z * in_stride;
  out += (long long)blockIdx.z * out_stride;
  constexpr int h = KS / 2;
  const int eh = tile_h + 2 * h;
  const int ew = tile_w + 2 * h;
  const int x0 = blockIdx.x * tile_w;
  const int y0 = blockIdx.y * tile_h;
  const int fam = st.family;
  const StLayout L = st_layout(c_in, c_out, tile_h, tile_w, h, fam, n_ops);
  const int P = L.plane_pitch;
  const int RP = L.raw_pitch;
  PwOp* s_ops = reinterpret_cast<PwOp*>(smem);
  StRow* rows = reinterpret_cast<StRow*>(smem + L.rows_off);
  unsigned char* s_pix = smem + L.planes_off;
  const unsigned char* raw = smem + L.scratch_off;
  float* s_row = reinterpret_cast<float*>(smem + L.scratch_off);
  const bool two_pass = st_two_pass(fam);
  const int strips = tile_w >> 2;
  // K3 pads columns as the golden pad2d does: zeros for zero mode and for
  // interior mode (whose border outputs its caller then passes through)
  const bool zero_cols =
      MODE == ST_TILE && (st.edge_mode == ST_EDGE_ZERO || st.edge_mode == ST_EDGE_INTERIOR);
  const bool vec_store = (W & 3) == 0 && ((uintptr_t)out & 3) == 0;
  // 1. The chain table and each window row's source, then the raw
  // window: the rows' segments as 16-byte granules, cp.async straight
  // into shared memory.
  pw_copy_chain(s_ops, chain, n_ops);
  st_row_sources<MODE, ST_THREADS>(rows, eh, h, x0, y0, tile_w, in, top, bot, H, W, c_in, st.edge_mode);
  __syncthreads();
  st_load_window<ST_THREADS>(smem + L.scratch_off, rows, eh, RP);
  st_load_wait();
  __syncthreads();

  // 2. Four window pixels per thread: edge extension by column source
  // (border blocks only, a branch uniform over the block), the pointwise
  // chain, de-interleaved u8 planes.
  const StCols cols = st_cols(x0, tile_w, h, W);
  {
    const unsigned gb = (ew + 3) >> 2;
    const unsigned mb = st_magic(gb);
    for (unsigned i = threadIdx.x; i < (unsigned)eh * gb; i += ST_THREADS) {
      const unsigned r = st_div(i, mb);
      const unsigned g = i - r * gb;
      const unsigned char* rr = raw + r * RP + rows[r].shift;
      // the four pixels' source columns and values
      const unsigned char* p[4];
      bool zero[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cx = x0 - h + min(4 * (int)g + j, ew - 1);
        int sx = cx;
        if (cols.border) sx = min(max(st_src(cx, W, st.edge_mode), cols.lo), cols.hi - 1);
        p[j] = rr + (sx - cols.lo) * c_in;
        zero[j] = zero_cols && cols.border && (cx < 0 || cx >= W);
      }
      uint32_t word[3] = {0u, 0u, 0u};
      if (n_ops == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (c < c_in && !zero[j]) word[c] |= (uint32_t)p[j][c] << (8 * j);
          }
        }
      } else {
        // the chain once for the four pixels, each op dispatched once
        float v[4][3];
#pragma unroll
        for (int j = 0; j < 4; ++j) pw_load(p[j], v[j], c_in);
        pw_apply_n<4>(s_ops, n_ops, v, c_in);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (!zero[j]) word[c] |= (uint32_t)pw_to_u8(v[j][c]) << (8 * j);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < c_out) {
          *reinterpret_cast<uint32_t*>(s_pix + (c * eh + r) * P + 4 * g) = word[c];
        }
      }
    }
  }
  __syncthreads();

  // 3a. Row pass of separable and min/max stencils: four values per
  // thread from one read of the row's 4 + 2h bytes, stored as a float4.
  if (two_pass) {
    for (int i = threadIdx.x; i < (c_out * eh) << lg_strips; i += ST_THREADS) {
      const int rr = i >> lg_strips;  // plane * eh + window row
      const int s4 = 4 * (i & (strips - 1));
      *reinterpret_cast<float4*>(s_row + rr * tile_w + s4) =
          st_strip_row_pass<KS>(s_pix + rr * P + s4, st);
    }
    __syncthreads();
  }

  // 3b. Four adjacent outputs per thread: column pass or 2-D window,
  // scale, quantize, the interior passthrough at global rows (K3 leaves
  // it to its caller); the channels interleaved in registers, then
  // stored.
  for (int i = threadIdx.x; i < tile_h << lg_strips; i += ST_THREADS) {
    const int ly = i >> lg_strips;
    const int lx = 4 * (i & (strips - 1));
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    uint32_t q[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c >= c_out) break;
      float acc[4], center[4];
      if (two_pass) {
        st_strip_col_pass<KS>(s_row + (c * eh + ly) * tile_w + lx, tile_w, st, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) center[j] = 0.0f;
      } else {
        st_strip_window<KS>(s_pix + (c * eh + ly) * P + lx, P, st, acc, center);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool filtered =
            MODE == ST_TILE ||
            (MODE == ST_FULL ? st_filtered(gy, gx + j, H, W, h, st.edge_mode)
                             : st_filtered(row0 + gy, gx + j, image_h, W, h, st.edge_mode));
        float res;
        if (filtered) {
          res = st_finish(acc[j], st);
        } else {
          res = two_pass ? (float)s_pix[(c * eh + ly + h) * P + lx + j + h] : center[j];
        }
        q[c][j] = pw_to_u8(res);
      }
    }
    unsigned char* o = out + ((long long)gy * W + gx) * c_out;
    if (vec_store && c_out == 1) {
      *reinterpret_cast<uint32_t*>(o) =
          q[0][0] | q[0][1] << 8 | q[0][2] << 16 | q[0][3] << 24;
    } else if (vec_store) {
      // bytes j * 3 + c: r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
      uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
      o32[0] = q[0][0] | q[1][0] << 8 | q[2][0] << 16 | q[0][1] << 24;
      o32[1] = q[1][1] | q[2][1] << 8 | q[0][2] << 16 | q[1][2] << 24;
      o32[2] = q[2][2] | q[0][3] << 8 | q[1][3] << 16 | q[2][3] << 24;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gx + j >= W) break;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (c < c_out) o[j * c_out + c] = (unsigned char)q[c][j];
        }
      }
    }
  }
}

template <int KS, int MODE>
static int st_launch(const unsigned char* in, unsigned char* out, int H, int W, int c_in,
                     int c_out, const PwOp* chain, int n_ops, const StencilDesc* st, int tile_h,
                     int tile_w, const unsigned char* top, const unsigned char* bot, int row0,
                     int image_h, int n_img, long long in_stride, long long out_stride,
                     int device, cudaStream_t stream) {
  const size_t smem =
      st_layout(c_in, c_out, tile_h, tile_w, st->halo, st->family, n_ops).total;
  // the opt-in above 48 KB, once per instantiation, size and device
  static size_t opted[ST_MAX_DEVICES] = {};
  if (device >= ST_MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_stencil_kernel<KS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem;
  }
  int lg = 0;
  while ((4 << lg) < tile_w) ++lg;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, n_img);
  stream_stencil_kernel<KS, MODE><<<grid, ST_THREADS, smem, stream>>>(
      in, out, H, W, c_in, c_out, chain, n_ops, *st, tile_h, tile_w, lg, top, bot, row0,
      image_h, in_stride, out_stride);
  return (int)cudaGetLastError();
}

// Launches the kernel for the stencil's size on `device`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments this source has no instance of or the kernel does not take.
template <int MODE>
static int st_dispatch(const unsigned char* in, unsigned char* out, int H, int W, int c_in,
                       int c_out, const PwOp* chain, int n_ops, const StencilDesc* st,
                       int tile_h, int tile_w, const unsigned char* top,
                       const unsigned char* bot, int row0, int image_h, int n_img,
                       long long in_stride, long long out_stride, int device, void* stream) {
  if (H <= 0 || W <= 0 || n_img == 0) return 0;
  const bool width_ok = tile_w == ST_MIN_TILE_W || tile_w == 64 || tile_w == ST_MAX_TILE_W;
  if (!width_ok || tile_h < 1 || device < 0 || n_ops < 0 || (n_ops > 0 && chain == nullptr) ||
      n_img < 0 || n_img > ST_MAX_IMAGES || (MODE != ST_FULL && n_img != 1) ||
      c_in < 1 || c_in > 3 || c_out < 1 || c_out > 3 || (n_ops == 0 && c_in != c_out)) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
#define ST_CASE(KS)                                                                       \
  case KS:                                                                                \
    return st_launch<KS, MODE>(in, out, H, W, c_in, c_out, chain, n_ops, st, tile_h, tile_w, \
                               top, bot, row0, image_h, n_img, in_stride, out_stride, device, s);
  switch (st->ksize) {
    ST_CASE(1)
    ST_CASE(3)
    ST_CASE(5)
    ST_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ST_CASE
}

// K2: the group over a stack of `n_img` whole (H, W) images, image i at
// `in + i * in_stride` and written to `out + i * out_stride` (bytes; one
// image: n_img 1), with the chain table `chain` (n_ops PwOp in device
// memory), in tiles of tile_h x tile_w outputs. A tile never spans two
// images: grid z is the image.
extern "C" int stream_stencil_launch(const unsigned char* in, unsigned char* out, int H, int W,
                                     int c_in, int c_out, const PwOp* chain, int n_ops,
                                     const StencilDesc* st, int tile_h, int tile_w, int n_img,
                                     long long in_stride, long long out_stride, int device,
                                     void* stream) {
  return st_dispatch<ST_FULL>(in, out, H, W, c_in, c_out, chain, n_ops, st, tile_h, tile_w,
                              nullptr, nullptr, 0, H, n_img, in_stride, out_stride, device,
                              stream);
}

// K2g: the group over a (local_h, W) row-shard whose first row is global
// row `row0` of an image `image_h` rows high, with its raw (halo, W) ghost
// strips `top` and `bot`. The stencil's halo must be at least 1.
extern "C" int stream_stencil_ghost_launch(const unsigned char* tile, const unsigned char* top,
                                           const unsigned char* bot, unsigned char* out,
                                           int local_h, int W, int c_in, int c_out,
                                           const PwOp* chain, int n_ops, const StencilDesc* st,
                                           int tile_h, int tile_w, int row0, int image_h,
                                           int device, void* stream) {
  if (st->halo < 1 || top == nullptr || bot == nullptr) return (int)cudaErrorInvalidValue;
  return st_dispatch<ST_GHOST>(tile, out, local_h, W, c_in, c_out, chain, n_ops, st, tile_h,
                               tile_w, top, bot, row0, image_h, 1, 0, 0, device, stream);
}

// K3: the stencil alone (valid rows, quantized, no passthrough) over a
// pre-extended (local_h + 2 halo, W) array of `c` interleaved channels;
// writes (local_h, W).
extern "C" int stencil_tile_launch(const unsigned char* ext, unsigned char* out, int local_h,
                                   int W, int c, const StencilDesc* st, int tile_h, int tile_w,
                                   int device, void* stream) {
  const long long strip = (long long)st->halo * W * c;
  return st_dispatch<ST_TILE>(ext + strip, out, local_h, W, c, c, nullptr, 0, st, tile_h,
                              tile_w, ext, ext + strip + (long long)local_h * W * c, 0, local_h,
                              1, 0, 0, device, stream);
}

// Dynamic shared memory one launch needs, for the host-side check.
extern "C" long long stream_stencil_smem_bytes(int c_in, int c_out, int tile_h, int tile_w,
                                               int halo, int family, int n_ops) {
  return (long long)st_layout(c_in, c_out, tile_h, tile_w, halo, family, n_ops).total;
}
