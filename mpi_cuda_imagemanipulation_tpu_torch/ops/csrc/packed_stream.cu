// T1, T1g and T1-pw: one [pointwise*, stencil?] group on packed word
// planes, four u8 pixels per 32-bit word. One source, three entry points:
// the pointwise form (T1-pw), the stencil form over a whole image (T1) and
// its ghost mode over one row-shard (T1g).
//
// Replaces: tools/packed_kernels.py
//           run_group_packed_words (:643): the pointwise form
//           _pointwise_kernel_packed (:429, pallas_call :676) and the
//           stencil form _stream_kernel_packed (:438, pallas_call :752),
//           full mode and ghost mode (ghosts, y0, image_h).
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
// Design:   the TPU kernel walks row blocks in order, carries the row pass
//           from block to block in scratch memory, and unpacks words into
//           four f32 lane planes with shifts and masks, rebuilding the
//           first and last `halo` columns from their clamped sources. Here
//           blocks run in no order and carry nothing: a block owns a tile
//           of tile_h rows x PK_TILE_WORDS words and loads its own window,
//           tile_h + 2 halo rows x PK_TILE_WORDS + 2 words (one halo word
//           each side holds the <= 3 halo columns), as 32-bit word loads,
//           neighbouring threads on neighbouring words. A halo word outside
//           the image takes each of its four bytes from the column source
//           of the edge mode (st_src); window rows outside the image come
//           from the row source (full mode) or the ghost strips (ghost
//           mode). The chain runs per byte of the loaded words and the
//           result goes to shared memory as words, one window per output
//           plane. Shared memory is byte-addressable, so the stencil reads
//           its taps as u8 without shifts; separable and min/max stencils
//           first write a float32 row pass. Each thread then computes the
//           four pixels of one output word and stores the word. The
//           pointwise form is a tile of words with no window. tile_h (the
//           JAX block_h) changes no byte. Built with -fmad=false.

#include <stdint.h>

#include "stencil.cuh"

#define PK_TILE_WORDS 32  // output words per tile row: 128 pixel columns
#define PK_WIN_WORDS (PK_TILE_WORDS + 2)
#define PK_THREADS 256
#define PK_MAX_PLANES 3

// The planes of one launch: n_in input planes and, in ghost mode, their
// top and bottom strips; n_out output planes. 96 bytes.
struct PkPlanes {
  const uint32_t* in[PK_MAX_PLANES];
  const uint32_t* top[PK_MAX_PLANES];
  const uint32_t* bot[PK_MAX_PLANES];
  uint32_t* out[PK_MAX_PLANES];
};

enum PkMode { PK_FULL = 0, PK_GHOST = 1 };

// Shared memory of one stencil block: the chain's table (n_ops PwOp), the
// post-pointwise window per output plane as words, then (separable, min,
// max) the float32 row pass per plane, tile_h + 2 halo rows of 4
// PK_TILE_WORDS columns.
__host__ __device__ inline size_t pk_smem_bytes(int n_out, int tile_h, int halo, int family,
                                                int n_ops) {
  const size_t eh = tile_h + 2 * halo;
  size_t bytes = (size_t)n_ops * sizeof(PwOp) + (size_t)n_out * eh * PK_WIN_WORDS * 4;
  if (st_two_pass(family)) bytes += (size_t)n_out * eh * PK_TILE_WORDS * 4 * sizeof(float);
  return bytes;
}

// Word `gw` of a row of Wp words. A word outside the row takes each byte k
// from column st_src(4 gw + k): the edge mode's source, clamped.
__device__ __forceinline__ uint32_t pk_load_word(const uint32_t* row, int gw, int Wp, int mode) {
  if (gw >= 0 && gw < Wp) return row[gw];
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = st_src(4 * gw + k, 4 * Wp, mode);
    word |= ((row[src >> 2] >> (8 * (src & 3))) & 0xFFu) << (8 * k);
  }
  return word;
}

// The chain (its table in shared memory) on the four pixels of one word
// position: n_in words in, n_out words out.
__device__ __forceinline__ void pk_chain(const PwOp* ops, int n_ops, const uint32_t* w_in,
                                         int n_in, uint32_t* w_out, int n_out) {
#pragma unroll
  for (int c = 0; c < PK_MAX_PLANES; ++c) w_out[c] = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[3];
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) {
      v[c] = c < n_in ? (float)((w_in[c] >> (8 * k)) & 0xFFu) : 0.0f;
    }
    pw_apply(ops, n_ops, v, n_in);
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) {
      if (c < n_out) w_out[c] |= (uint32_t)pw_to_u8(v[c]) << (8 * k);
    }
  }
}

// T1-pw: the chain alone, one word per thread and plane. Dynamic shared
// memory: the chain's table.
__global__ void __launch_bounds__(PK_THREADS)
packed_pointwise_group_kernel(const __grid_constant__ PkPlanes pl, int H, int Wp, int n_in,
                              int n_out, int tile_h, const PwOp* __restrict__ chain,
                              int n_ops) {
  extern __shared__ __align__(16) PwOp s_ops[];
  pw_copy_chain(s_ops, chain, n_ops);
  __syncthreads();
  const int w0 = blockIdx.x * PK_TILE_WORDS;
  const int y0 = blockIdx.y * tile_h;
  for (int i = threadIdx.x; i < tile_h * PK_TILE_WORDS; i += PK_THREADS) {
    const int ly = i / PK_TILE_WORDS;
    const int gy = y0 + ly;
    const int gw = w0 + i - ly * PK_TILE_WORDS;
    if (gy >= H || gw >= Wp) continue;
    const long long o = (long long)gy * Wp + gw;
    uint32_t w_in[PK_MAX_PLANES], w_out[PK_MAX_PLANES];
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) w_in[c] = c < n_in ? pl.in[c][o] : 0u;
    pk_chain(s_ops, n_ops, w_in, n_in, w_out, n_out);
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) {
      if (c < n_out) pl.out[c][o] = w_out[c];
    }
  }
}

// T1 (MODE = PK_FULL) and T1g (PK_GHOST): the chain, then the stencil.
template <int KS, int MODE>
__global__ void __launch_bounds__(PK_THREADS)
packed_stream_kernel(const __grid_constant__ PkPlanes pl, int H, int Wp, int n_in, int n_out,
                     const PwOp* __restrict__ chain, int n_ops,
                     const __grid_constant__ StencilDesc st, int tile_h, int row0,
                     int image_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int h = KS / 2;
  constexpr int ew = 4 * PK_WIN_WORDS;   // window row, bytes
  constexpr int rw = 4 * PK_TILE_WORDS;  // row-pass row, floats
  const int W = 4 * Wp;
  const int eh = tile_h + 2 * h;
  const int w0 = blockIdx.x * PK_TILE_WORDS;
  const int y0 = blockIdx.y * tile_h;
  // the chain's table, then the windows, then the row pass
  PwOp* s_ops = reinterpret_cast<PwOp*>(smem);
  unsigned char* s_win = smem + (size_t)n_ops * sizeof(PwOp);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_win);
  const unsigned char* s_pix = s_win;
  float* s_row = reinterpret_cast<float*>(s_win + (size_t)n_out * eh * ew);
  pw_copy_chain(s_ops, chain, n_ops);
  __syncthreads();

  // 1. The window: word loads with edge words by column source, rows by
  // the row source (full) or from the strips (ghost: rows past a strip
  // feed only outputs below the tile, which are not stored), the chain,
  // words into shared memory.
  for (int i = threadIdx.x; i < eh * PK_WIN_WORDS; i += PK_THREADS) {
    const int wy = i / PK_WIN_WORDS;
    const int ww = i - wy * PK_WIN_WORDS;
    const int ty = y0 + wy - h;  // row of the image (full) or tile (ghost)
    const int gw = w0 + ww - 1;
    uint32_t w_in[PK_MAX_PLANES], w_out[PK_MAX_PLANES];
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) {
      if (c >= n_in) {
        w_in[c] = 0u;
        continue;
      }
      const uint32_t* row;
      if (MODE == PK_FULL) {
        row = pl.in[c] + (long long)st_src(ty, H, st.edge_mode) * Wp;
      } else if (ty < 0) {
        row = pl.top[c] + (long long)(h + ty) * Wp;
      } else if (ty >= H) {
        row = pl.bot[c] + (long long)min(ty - H, h - 1) * Wp;
      } else {
        row = pl.in[c] + (long long)ty * Wp;
      }
      w_in[c] = pk_load_word(row, gw, Wp, st.edge_mode);
    }
    pk_chain(s_ops, n_ops, w_in, n_in, w_out, n_out);
#pragma unroll
    for (int c = 0; c < PK_MAX_PLANES; ++c) {
      if (c < n_out) s_words[(c * eh + wy) * PK_WIN_WORDS + ww] = w_out[c];
    }
  }
  __syncthreads();

  // 2. Row pass of separable and min/max stencils. Pixel x of the tile is
  // byte x + 4 of its window row; its taps start h bytes left of it.
  const bool two_pass = st_two_pass(st.family);
  if (two_pass) {
    for (int i = threadIdx.x; i < n_out * eh * rw; i += PK_THREADS) {
      const int r = i / rw;  // plane * eh + row
      const int x = i - r * rw;
      s_row[r * rw + x] = st_row_pass<KS>(s_pix + r * ew + x + 4 - h, st);
    }
    __syncthreads();
  }

  // 3. Four pixels per output word: column pass or 2-D window, scale,
  // quantize, the interior passthrough at global coordinates; one word
  // store per plane.
  for (int i = threadIdx.x; i < tile_h * PK_TILE_WORDS; i += PK_THREADS) {
    const int ly = i / PK_TILE_WORDS;
    const int lw = i - ly * PK_TILE_WORDS;
    const int gy = y0 + ly;
    const int gw = w0 + lw;
    if (gy >= H || gw >= Wp) continue;
    for (int c = 0; c < n_out; ++c) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lx = 4 * lw + k;
        const int gx = 4 * gw + k;
        const bool filtered =
            MODE == PK_FULL ? st_filtered(gy, gx, H, W, h, st.edge_mode)
                            : st_filtered(row0 + gy, gx, image_h, W, h, st.edge_mode);
        const unsigned char* win = s_pix + (c * eh + ly) * ew + lx + 4 - h;
        float res;
        if (!filtered) {
          res = (float)win[h * ew + h];
        } else {
          const float acc = two_pass
                                ? st_col_pass<KS>(s_row + (c * eh + ly) * rw + lx, rw, st)
                                : st_window<KS>(win, ew, st);
          res = st_finish(acc, st);
        }
        word |= (uint32_t)pw_to_u8(res) << (8 * k);
      }
      pl.out[c][(long long)gy * Wp + gw] = word;
    }
  }
}

template <int KS, int MODE>
static int pk_launch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out, const PwOp* chain,
                     int n_ops, const StencilDesc* st, int tile_h, int row0, int image_h,
                     cudaStream_t stream) {
  const size_t smem = pk_smem_bytes(n_out, tile_h, st->halo, st->family, n_ops);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_stream_kernel<KS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Wp + PK_TILE_WORDS - 1) / PK_TILE_WORDS, (H + tile_h - 1) / tile_h);
  packed_stream_kernel<KS, MODE><<<grid, PK_THREADS, smem, stream>>>(
      *pl, H, Wp, n_in, n_out, chain, n_ops, *st, tile_h, row0, image_h);
  return (int)cudaGetLastError();
}

static bool pk_args_ok(int n_in, int n_out, int tile_h, const PwOp* chain, int n_ops) {
  return n_in >= 1 && n_in <= PK_MAX_PLANES && n_out >= 1 && n_out <= PK_MAX_PLANES &&
         tile_h >= 1 && n_ops >= 0 && (n_ops == 0 || chain != nullptr);
}

// Launches the stencil form for the stencil's size (halo 1-3). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
template <int MODE>
static int pk_dispatch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out, const PwOp* chain,
                       int n_ops, const StencilDesc* st, int tile_h, int row0, int image_h,
                       void* stream) {
  if (H <= 0 || Wp <= 0) return 0;
  if (!pk_args_ok(n_in, n_out, tile_h, chain, n_ops) || H <= st->halo) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
#define PK_CASE(KS)                                                                          \
  case KS:                                                                                   \
    return pk_launch<KS, MODE>(pl, H, Wp, n_in, n_out, chain, n_ops, st, tile_h, row0, image_h, \
                               s);
  switch (st->ksize) {
    PK_CASE(3)
    PK_CASE(5)
    PK_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_CASE
}

// T1-pw: the chain table `chain` (n_ops PwOp in device memory) over the
// (H, Wp) planes of `pl`, in tiles of tile_h rows.
extern "C" int packed_pointwise_group_launch(const PkPlanes* pl, int H, int Wp, int n_in,
                                             int n_out, const PwOp* chain, int n_ops, int tile_h,
                                             void* stream) {
  if (H <= 0 || Wp <= 0) return 0;
  if (!pk_args_ok(n_in, n_out, tile_h, chain, n_ops)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_ops * sizeof(PwOp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_pointwise_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Wp + PK_TILE_WORDS - 1) / PK_TILE_WORDS, (H + tile_h - 1) / tile_h);
  packed_pointwise_group_kernel<<<grid, PK_THREADS, smem, (cudaStream_t)stream>>>(
      *pl, H, Wp, n_in, n_out, tile_h, chain, n_ops);
  return (int)cudaGetLastError();
}

// T1: the group over whole (H, Wp) planes.
extern "C" int packed_stream_launch(const PkPlanes* pl, int H, int Wp, int n_in, int n_out,
                                    const PwOp* chain, int n_ops, const StencilDesc* st,
                                    int tile_h, void* stream) {
  return pk_dispatch<PK_FULL>(pl, H, Wp, n_in, n_out, chain, n_ops, st, tile_h, 0, H, stream);
}

// T1g: the group over a (local_h, Wp) row-shard whose first row is global
// row `row0` of an image `image_h` rows high, with its raw (halo, Wp) ghost
// strips in `pl->top` and `pl->bot`.
extern "C" int packed_stream_ghost_launch(const PkPlanes* pl, int local_h, int Wp, int n_in,
                                          int n_out, const PwOp* chain, int n_ops,
                                          const StencilDesc* st, int tile_h, int row0,
                                          int image_h, void* stream) {
  for (int c = 0; c < n_in && c < PK_MAX_PLANES; ++c) {
    if (pl->top[c] == nullptr || pl->bot[c] == nullptr) return (int)cudaErrorInvalidValue;
  }
  return pk_dispatch<PK_GHOST>(pl, local_h, Wp, n_in, n_out, chain, n_ops, st, tile_h, row0,
                               image_h, stream);
}

// Dynamic shared memory one stencil launch needs, for the host-side check.
extern "C" long long packed_stream_smem_bytes(int n_out, int tile_h, int halo, int family,
                                              int n_ops) {
  return (long long)pk_smem_bytes(n_out, tile_h, halo, family, n_ops);
}
