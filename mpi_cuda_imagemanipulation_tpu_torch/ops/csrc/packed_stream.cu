// T1, T1g and T1-pw: one [pointwise*, stencil?] group on packed word
// planes, four u8 pixels per 32-bit word. One source, three entry points:
// the pointwise form (T1-pw), the stencil form over a whole image (T1) and
// its ghost mode over one row-shard (T1g).
//
// Replaces: tools/packed_kernels.py
//           run_group_packed_words (:643): the pointwise form
//           _pointwise_kernel_packed (:429, pallas_call :676) and the
//           stencil form _stream_kernel_packed (:438, pallas_call :752),
//           full mode and ghost mode (ghosts, y0, image_h); and both
//           under jax.vmap (a stack of images, tests/test_packed.py:159):
//           full mode takes the batch on grid z, each plane's image i at
//           i * in_stride (out_stride) words, offset in 64 bits at entry;
//           the pointwise form takes a contiguous stack as one flat run.
// Computes: n_in (1 or 3) int32 word planes (H, Wp), one per channel, byte
//           k (little-endian) of word j = column 4j + k of a u8 plane of
//           width W = 4 Wp, into n_out such planes (the channel count after
//           the chain): per pixel the pointwise chain (pointwise.cuh), then
//           one stencil of halo 1-3 (corr, magnitude, separable, min, max,
//           3x3 or 5x5 median) with edge extension by index (reflect101,
//           edge; interior clamps, its border outputs pass the
//           post-pointwise value through), the scale and the quantizer, in
//           stencil.cuh's arithmetic, the same as K2's: so each byte equals
//           the golden op's. Ghost mode (T1g) runs the group over a
//           (local_h, Wp) row-shard whose first row is global row `row0`:
//           rows above and below it come from raw (halo, Wp) ghost word
//           strips per input plane, and the interior passthrough follows
//           global rows against the image height `image_h`.
// Bound on the H100: device memory. Each pixel reads n_in bytes and
//           writes n_out bytes once: the 8K gray gaussian:5 (33.18 MP,
//           66.4 MB) takes at least 19.8 us at 3.35 TB/s, the pointwise
//           group grayscale,contrast:3.5 on a 2160 x 3840 RGB frame
//           (3 B in, 1 B out, 33.2 MB) 9.9 us. A 5x5 median runs 113
//           min/max pairs per pixel and may be bound by operations instead.
// Design:   the TPU kernel walks row blocks in order and carries its window
//           rows from block to block in scratch memory. The first design
//           here carried nothing: 16-row tiles, each loading its own window
//           (25% more rows for a 5x5) as 4-byte words with an edge branch
//           per word, the chain on every byte, three barrier-separated
//           phases with no load in flight, each output reading its taps
//           anew; it ran at 5-7% of the bytes bound. This one re-expresses
//           the TPU walk as a loop inside a block:
//           - A block owns a strip of tile_w words (32, 16 or 8: the host
//             narrows it until the grid fills the SMs, as K2's picker
//             does) and a run of run_h rows, which it walks in chunks of
//             chunk_h output rows.
//           - Loads: each loaded row's source is resolved once (the row
//             source in full mode, the ghost strips in ghost mode) into a
//             StRow; the rows then arrive as 16-byte cp.async granules
//             (window_load.cuh) in one of three raw slots, chunks k + 1
//             and k + 2 in flight while chunk k computes (one chunk ahead
//             ran within 1% and spilled 8-24 bytes at 64 registers).
//           - Carry instead of reload: the post-chain window lives in a
//             ring of chunk_h + 2h rows per plane, so a chunk loads only
//             its chunk_h new rows and reads the 2h before them where the
//             previous chunk left them; halo rows are read once per run.
//             The ring's first 2h rows are mirrored past its end, so the
//             KS rows of any output lie at one pitch and stencil.cuh's
//             strip functions read them as K2's do. The row pass of
//             separable and min/max stencils has a float32 ring of its own.
//           - The window pass: four pixels per thread, one funnel shift of
//             two raw words per plane aligns column 4 w - h to a word (the
//             strips read words), then the chain (each op through the
//             read-only cache, once for the four; skipped when the group
//             has none); column sources (st_src) only in strips that touch
//             the left or right border, a branch uniform over the block.
//           - Compute, as K2 does: each thread four adjacent outputs, one
//             output word, reading each window row's 4 + 2h bytes as words
//             once; the row pass into float rows read back as float4; one
//             word store per plane. Bytes to floats and back through the
//             mantissa of 2^23 where this source converts (packed_run.cuh).
//           Per chunk: two barriers (three with a row pass); four blocks of
//           256 threads an SM (three or two ran slower). The TPU block height (the wrapper's block_h)
//           sets nothing: chunk_h and run_h come from the host's shape
//           picker. On the card the 8K gray gaussian:5 spends most of its
//           time in stencil.cuh's row and column passes, not in its loads
//           (PERF.md). The pointwise form is packed_run.cuh's planar body.
//           Built with -fmad=false.

#include <stdint.h>

#include "device_scope.cuh"
#include "packed_run.cuh"
#include "stencil.cuh"
#include "window_load.cuh"

#define PK_THREADS 256
#define PK_MAX_PLANES 3
#define PK_MAX_TILE_W 32  // output words a strip: 128 pixel columns
#define PK_MIN_TILE_W 8
#define PK_MAX_CHUNK_H 48  // the largest whose 3-plane block fits in shared memory
// chunks whose loads are in flight ahead of the one read (one ran slower)
#define PK_PREFETCH 2
#define PK_BLOCKS 4  // blocks an SM in the launch bounds
#define PK_RAW_SLOTS (PK_PREFETCH + 1)
// row sources: the chunk read, the ones in flight, the next
#define PK_ROW_SLOTS (PK_PREFETCH + 2)
#define PK_MAX_DEVICES 16
// images of one full-mode launch: CUDA's limit on grid z
#define PK_MAX_IMAGES 65535

// The planes of one launch: n_in input planes and, in ghost mode, their
// top and bottom strips; n_out output planes; the words from one image of
// a stack to the next in the input and the output planes (full mode; grid
// z is the image). 112 bytes.
struct PkPlanes {
  const uint32_t* in[PK_MAX_PLANES];
  const uint32_t* top[PK_MAX_PLANES];
  const uint32_t* bot[PK_MAX_PLANES];
  uint32_t* out[PK_MAX_PLANES];
  long long in_stride;
  long long out_stride;
};

enum PkMode { PK_FULL = 0, PK_GHOST = 1 };

// A stencil block's shared memory, in order: PK_ROW_SLOTS slots of row
// sources (n_in x (chunk_h + 2 halo) StRow each); PK_RAW_SLOTS raw slots of
// as many rows, raw_pitch bytes a row; the post-chain window ring per output plane,
// ring = chunk_h + 2 halo rows and the mirror of its first 2 halo rows,
// `pitch` bytes a row (byte 0 = column 4 w0 - halo); then, for separable
// and min/max, the float32 row-pass ring per plane, as many rows of
// 4 tile_w floats.
struct PkLayout {
  int raw_pitch;
  int pitch;
  int ring;
  size_t raw_off;
  size_t pix_off;
  size_t row_off;
  size_t total;
};

__host__ __device__ inline PkLayout pk_layout(int n_in, int n_out, int tile_w, int chunk_h,
                                              int halo, int family) {
  PkLayout L;
  const int eh = chunk_h + 2 * halo;
  const size_t rows = (size_t)eh + 2 * halo;
  L.ring = eh;
  // a row's granules from the aligned address below word w0 - 1, up to
  // 12 bytes before it, plus the word past the window that the last
  // funnel shift reads
  L.raw_pitch = (int)st_round16(4 * tile_w + 24);
  L.pitch = (int)st_round16(4 * tile_w + 8);
  L.raw_off = (size_t)PK_ROW_SLOTS * n_in * eh * sizeof(StRow);
  L.pix_off = L.raw_off + PK_RAW_SLOTS * (size_t)n_in * eh * L.raw_pitch;
  L.row_off = L.pix_off + (size_t)n_out * rows * L.pitch;
  L.total = L.row_off +
            (st_two_pass(family) ? (size_t)n_out * rows * 4 * tile_w * sizeof(float) : 0);
  return L;
}

// T1 (MODE = PK_FULL) and T1g (PK_GHOST): the chain, then the stencil.
// Four blocks an SM (64 registers a thread).
template <int KS, int MODE>
__global__ void __launch_bounds__(PK_THREADS, PK_BLOCKS)
packed_stream_kernel(const __grid_constant__ PkPlanes pl, int H, int Wp, int n_in, int n_out,
                     const PwOp* __restrict__ chain, int n_ops,
                     const __grid_constant__ StencilDesc st, int tile_w, int lg_w, int chunk_h,
                     int run_h, int row0, int image_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the batch axis: grid z is the image of a stack (1 in ghost mode), its
  // word offset taken in 64 bits (a stack of 8K gray planes passes 2^31
  // bytes at its 66th image)
  const long long z_in = (long long)blockIdx.z * pl.in_stride;
  const long long z_out = (long long)blockIdx.z * pl.out_stride;
  constexpr int h = KS / 2;
  // bits from the start of raw word w - 1 to column 4 w - h
  constexpr unsigned lead = 8 * (4 - h);
  const int W = 4 * Wp;
  const int w0 = blockIdx.x * tile_w;
  const int ry0 = blockIdx.y * run_h;
  const int ry1 = min(ry0 + run_h, H);
  const int eh = chunk_h + 2 * h;
  const PkLayout L = pk_layout(n_in, n_out, tile_w, chunk_h, h, st.family);
  const int RB = L.ring, RBM = RB + 2 * h, P = L.pitch, RP = L.raw_pitch, FW = 4 * tile_w;
  StRow* rows = reinterpret_cast<StRow*>(smem);
  unsigned char* raw = smem + L.raw_off;
  unsigned char* s_pix = smem + L.pix_off;
  float* s_row = reinterpret_cast<float*>(smem + L.row_off);
  const bool two_pass = st_two_pass(st.family);
  // the words a window row needs from the image: all of [w0 - 1, w0 +
  // tile_w + 1) in a strip that touches no border, else the part inside
  const int lo = max(w0 - 1, 0);
  const int hi = min(w0 + tile_w + 1, Wp);
  const bool border = w0 == 0 || w0 + tile_w + 1 > Wp;
  const int seg = 4 * (hi - lo);
  const int n_chunks = (ry1 - ry0 + chunk_h - 1) / chunk_h;
  const int G = (4 * tile_w + 2 * h + 3) >> 2;  // window words a row
  const unsigned mg = st_magic(G);

  // Chunk k: output rows [y, y + n) (of the image, or of the tile in ghost
  // mode), window rows [y - h, y + n + h). It loads all of them (k = 0),
  // else the last n (the first 2h are the previous chunk's last). Loaded
  // row j of plane c is entry c * nn + j of the chunk's slots.
  auto resolve = [&](int k) {
    const int y = ry0 + k * chunk_h;
    const int first = k ? 2 * h : 0;
    const int nn = min(chunk_h, ry1 - y) + 2 * h - first;
    StRow* slot = rows + (k % PK_ROW_SLOTS) * n_in * eh;
    for (int i = threadIdx.x; i < n_in * nn; i += PK_THREADS) {
      const int c = i >= nn ? (i >= 2 * nn ? 2 : 1) : 0;
      const int ty = y - h + first + (i - c * nn);
      const uint32_t* row;
      if (MODE == PK_FULL) {
        row = pl.in[c] + z_in + (long long)st_src(ty, H, st.edge_mode) * Wp;
      } else if (ty < 0) {
        row = pl.top[c] + (long long)(h + ty) * Wp;
      } else if (ty >= H) {
        // rows past the strip feed only outputs below the tile
        row = pl.bot[c] + (long long)min(ty - H, h - 1) * Wp;
      } else {
        row = pl.in[c] + (long long)ty * Wp;
      }
      slot[i] = st_row_at(reinterpret_cast<const unsigned char*>(row + lo), seg);
    }
  };
  auto fetch = [&](int k) {
    const int y = ry0 + k * chunk_h;
    const int nn = min(chunk_h, ry1 - y) + (k ? 0 : 2 * h);
    st_load_window<PK_THREADS>(raw + (size_t)(k % PK_RAW_SLOTS) * n_in * eh * RP,
                               rows + (k % PK_ROW_SLOTS) * n_in * eh, n_in * nn, RP);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int k = 0; k <= PK_PREFETCH && k < n_chunks; ++k) resolve(k);
  __syncthreads();
  for (int k = 0; k < PK_PREFETCH; ++k) {
    if (k < n_chunks) {
      fetch(k);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }
  for (int k = 0; k < n_chunks; ++k) {
    // chunk k's rows have landed, chunk k - 1's outputs are done, the
    // sources of chunk k + PK_PREFETCH are resolved
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PK_PREFETCH - 1));
    __syncthreads();
    if (k + PK_PREFETCH < n_chunks) {
      fetch(k + PK_PREFETCH);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if (k + PK_PREFETCH + 1 < n_chunks) resolve(k + PK_PREFETCH + 1);
    const int y = ry0 + k * chunk_h;
    const int n = min(chunk_h, ry1 - y);
    const int first = k ? 2 * h : 0;
    const int nn = n + 2 * h - first;
    const int base = (k * chunk_h) % RB;  // ring row of window row y - h
    const unsigned char* rs = raw + (size_t)(k % PK_RAW_SLOTS) * n_in * eh * RP;
    const StRow* rk = rows + (k % PK_ROW_SLOTS) * n_in * eh;

    // 1. The loaded rows into the ring: four pixels per step, aligned by
    // one funnel shift (or by column source in border strips), the chain,
    // one word per output plane (and its mirror).
    for (unsigned i = threadIdx.x; i < (unsigned)(nn * G); i += PK_THREADS) {
      const int j = (int)st_div(i, mg);
      const int g = (int)i - j * G;
      int pos = base + first + j;
      if (pos >= RB) pos -= RB;
      uint32_t wi[3] = {0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c >= n_in) break;
        const int r = c * nn + j;
        const unsigned char* src = rs + r * RP + rk[r].shift;  // word lo of the row
        if (!border) {
          const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src) + g;
          wi[c] = __funnelshift_r(s32[0], s32[1], lead);
        } else {
          uint32_t w = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int cx = 4 * (w0 + g) - h + b;
            const int sx = min(max(st_src(cx, W, st.edge_mode), 4 * lo), 4 * hi - 1);
            w |= (uint32_t)src[sx - 4 * lo] << (8 * b);
          }
          wi[c] = w;
        }
      }
      uint32_t wo[3] = {wi[0], wi[1], wi[2]};
      if (n_ops > 0) {
        float v[4][3];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int c = 0; c < 3; ++c) v[b][c] = pr_byte_f(wi[c], b);
        }
        pw_apply_ldg<4>(chain, n_ops, v, n_in);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          wo[c] = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b) wo[c] |= pr_f_byte(v[b][c]) << (8 * b);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c >= n_out) break;
        unsigned char* d = s_pix + (size_t)(c * RBM + pos) * P + 4 * g;
        *reinterpret_cast<uint32_t*>(d) = wo[c];
        if (pos < 2 * h) *reinterpret_cast<uint32_t*>(d + (size_t)RB * P) = wo[c];
      }
    }
    __syncthreads();

    // 2. Row pass of separable and min/max stencils over the loaded rows:
    // four values per step from one read of the row's 4 + 2h bytes, one
    // float4 into the float ring (and its mirror).
    if (two_pass) {
      for (int i = threadIdx.x; i < (n_out * nn) << lg_w; i += PK_THREADS) {
        const int r = i >> lg_w;  // plane * nn + loaded row
        const int s4 = 4 * (i & (tile_w - 1));
        const int c = r >= nn ? (r >= 2 * nn ? 2 : 1) : 0;
        int pos = base + first + (r - c * nn);
        if (pos >= RB) pos -= RB;
        const float4 f = st_strip_row_pass<KS>(s_pix + (size_t)(c * RBM + pos) * P + s4, st);
        float* d = s_row + (size_t)(c * RBM + pos) * FW + s4;
        *reinterpret_cast<float4*>(d) = f;
        if (pos < 2 * h) *reinterpret_cast<float4*>(d + (size_t)RB * FW) = f;
      }
      __syncthreads();
    }

    // 3. Four adjacent outputs (one word) per step: column pass or 2-D
    // window from the ring, scale, quantize, the interior passthrough at
    // global coordinates; one word store per plane.
    for (int i = threadIdx.x; i < n << lg_w; i += PK_THREADS) {
      const int ly = i >> lg_w;
      const int s = i & (tile_w - 1);
      const int gw = w0 + s;
      if (gw >= Wp) continue;
      const int gy = y + ly;
      int pos = base + ly;
      if (pos >= RB) pos -= RB;
#pragma unroll 1
      for (int c = 0; c < n_out; ++c) {
        const unsigned char* win = s_pix + (size_t)(c * RBM + pos) * P + 4 * s;
        float acc[4], center[4];
        if (two_pass) {
          st_strip_col_pass<KS>(s_row + (size_t)(c * RBM + pos) * FW + 4 * s, FW, st, acc);
#pragma unroll
          for (int j = 0; j < 4; ++j) center[j] = 0.0f;
        } else {
          st_strip_window<KS>(win, P, st, acc, center);
        }
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gx = 4 * gw + j;
          const bool filtered =
              MODE == PK_FULL ? st_filtered(gy, gx, H, W, h, st.edge_mode)
                              : st_filtered(row0 + gy, gx, image_h, W, h, st.edge_mode);
          float res;
          if (filtered) {
            res = st_finish(acc[j], st);
          } else {
            res = two_pass ? (float)win[h * P + j + h] : center[j];
          }
          word |= pr_f_byte(res) << (8 * j);
        }
        pl.out[c][z_out + (long long)gy * Wp + gw] = word;
      }
    }
  }
}

template <int KS, int MODE>
static int pk_launch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out, const PwOp* chain,
                     int n_ops, const StencilDesc* st, int tile_w, int chunk_h, int run_h,
                     int row0, int image_h, int n_img, int device, cudaStream_t stream) {
  const size_t smem = pk_layout(n_in, n_out, tile_w, chunk_h, st->halo, st->family).total;
  // the opt-in above 48 KB, once per instantiation, size and device
  static size_t opted[PK_MAX_DEVICES] = {};
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_stream_kernel<KS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem;
  }
  int lg = 0;
  while ((1 << lg) < tile_w) ++lg;
  const dim3 grid((Wp + tile_w - 1) / tile_w, (H + run_h - 1) / run_h, n_img);
  packed_stream_kernel<KS, MODE><<<grid, PK_THREADS, smem, stream>>>(
      *pl, H, Wp, n_in, n_out, chain, n_ops, *st, tile_w, lg, chunk_h, run_h, row0, image_h);
  return (int)cudaGetLastError();
}

static bool pk_args_ok(int n_in, int n_out, const PwOp* chain, int n_ops, int device) {
  return n_in >= 1 && n_in <= PK_MAX_PLANES && n_out >= 1 && n_out <= PK_MAX_PLANES &&
         n_ops >= 0 && (n_ops == 0 || chain != nullptr) && (n_ops > 0 || n_in == n_out) &&
         device >= 0 && device < PK_MAX_DEVICES;
}

// Launches the stencil form for the stencil's size (halo 1-3) on `device`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
template <int MODE>
static int pk_dispatch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out, const PwOp* chain,
                       int n_ops, const StencilDesc* st, int tile_w, int chunk_h, int run_h,
                       int row0, int image_h, int n_img, int device, void* stream) {
  if (H <= 0 || Wp <= 0 || n_img == 0) return 0;
  const bool shape_ok = (tile_w == PK_MIN_TILE_W || tile_w == 16 || tile_w == PK_MAX_TILE_W) &&
                        chunk_h >= 1 && chunk_h <= PK_MAX_CHUNK_H && run_h >= chunk_h &&
                        run_h % chunk_h == 0 && (H + run_h - 1) / run_h <= 65535 &&
                        n_img >= 1 && n_img <= PK_MAX_IMAGES && (MODE == PK_FULL || n_img == 1);
  if (!shape_ok || !pk_args_ok(n_in, n_out, chain, n_ops, device) || H <= st->halo) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
#define PK_CASE(KS)                                                                         \
  case KS:                                                                                  \
    return pk_launch<KS, MODE>(pl, H, Wp, n_in, n_out, chain, n_ops, st, tile_w, chunk_h,  \
                               run_h, row0, image_h, n_img, device, s);
  switch (st->ksize) {
    PK_CASE(3)
    PK_CASE(5)
    PK_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_CASE
}

// T1-pw: the chain table `chain` (n_ops PwOp in device memory) over the
// (H, Wp) planes of `pl` (their strips and strides unused), on `device`. A
// contiguous stack of N images is one flat run: the host passes N * H rows.
extern "C" int packed_pointwise_group_launch(const PkPlanes* pl, int H, int Wp, int n_in,
                                             int n_out, const PwOp* chain, int n_ops, int device,
                                             void* stream) {
  if (H <= 0 || Wp <= 0) return 0;
  if (!pk_args_ok(n_in, n_out, chain, n_ops, device)) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  PrPlanes p;
  for (int c = 0; c < PK_MAX_PLANES; ++c) {
    p.in[c] = pl->in[c];
    p.out[c] = pl->out[c];
  }
  const long long n = (long long)H * Wp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_in == 1 && n_out == 1) return pr_launch<1, 1>(p, n, chain, n_ops, s);
  if (n_in == 1 && n_out == 3) return pr_launch<1, 3>(p, n, chain, n_ops, s);
  if (n_in == 3 && n_out == 1) return pr_launch<3, 1>(p, n, chain, n_ops, s);
  if (n_in == 3 && n_out == 3) return pr_launch<3, 3>(p, n, chain, n_ops, s);
  return (int)cudaErrorInvalidValue;
}

// T1: the group over a stack of `n_img` whole (H, Wp) images, in strips
// of tile_w words and runs of run_h rows walked in chunks of chunk_h; image
// i of each plane at `pl->in_stride * i` words (out: `pl->out_stride`; one
// image: n_img 1). A block never spans two images: grid z is the image.
extern "C" int packed_stream_launch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out,
                                    const PwOp* chain, int n_ops, const StencilDesc* st,
                                    int tile_w, int chunk_h, int run_h, int n_img, int device,
                                    void* stream) {
  return pk_dispatch<PK_FULL>(pl, H, Wp, n_in, n_out, chain, n_ops, st, tile_w, chunk_h, run_h,
                              0, H, n_img, device, stream);
}

// T1g: the group over a (local_h, Wp) row-shard whose first row is global
// row `row0` of an image `image_h` rows high, with its raw (halo, Wp) ghost
// strips in `pl->top` and `pl->bot`.
extern "C" int packed_stream_ghost_launch(const PkPlanes* pl, int local_h, int Wp, int n_in,
                                          int n_out, const PwOp* chain, int n_ops,
                                          const StencilDesc* st, int tile_w, int chunk_h,
                                          int run_h, int row0, int image_h, int device,
                                          void* stream) {
  for (int c = 0; c < n_in && c < PK_MAX_PLANES; ++c) {
    if (pl->top[c] == nullptr || pl->bot[c] == nullptr) return (int)cudaErrorInvalidValue;
  }
  return pk_dispatch<PK_GHOST>(pl, local_h, Wp, n_in, n_out, chain, n_ops, st, tile_w, chunk_h,
                               run_h, row0, image_h, 1, device, stream);
}

// Dynamic shared memory one stencil launch needs, for the host-side check.
extern "C" long long packed_stream_smem_bytes(int n_in, int n_out, int tile_w, int chunk_h,
                                              int halo, int family) {
  return (long long)pk_layout(n_in, n_out, tile_w, chunk_h, halo, family).total;
}

// The split of one pointwise launch (pr_split), for the host-side check:
// head, runs, tail and the three input shifts (words) in `split[0..5]`.
extern "C" void packed_pointwise_split(unsigned long long in0, unsigned long long in1,
                                       unsigned long long in2, int n_in, unsigned long long out,
                                       long long n, long long* split) {
  const uintptr_t in[PR_MAX_PLANES] = {(uintptr_t)in0, (uintptr_t)in1, (uintptr_t)in2};
  const PrSplit s = pr_split(in, n_in, (uintptr_t)out, n);
  split[0] = s.head;
  split[1] = s.runs;
  split[2] = s.tail;
  for (int c = 0; c < PR_MAX_PLANES; ++c) split[3 + c] = s.shift[c];
}
