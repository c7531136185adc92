// T3: the 5x5 binomial Gaussian on quarter-strip words, SWAR.
//
// Replaces: tools/swar_proto.py
//           make_swar_pallas (:122; pallas_call :159, built in build_fns
//           :56), with _row_pass_fields (:91) and _col_finalize (:106).
// Computes: `gaussian:5` (taps 1 4 6 4 1 in both directions, scale 1/256,
//           round half to even) on an (H + 4, Ws + 4) word array, the
//           reflect-padded u8 plane packed in quarter strips: byte k of
//           word j is strip k's pixel j (pack_quarters :66), so a
//           horizontal tap is a shift by whole words for all four strips
//           at once. Out: (H, Ws) words of the same layout, exactly H rows.
//           Per word: lo = w & 0x00FF00FF (strips 0 and 2), hi = (w >> 8) &
//           0x00FF00FF (strips 1 and 3); a row pass over five neighbouring
//           words (fields <= 255 * 16 = 4080), a column pass over five rows
//           (fields <= 4080 * 16 = 65280 < 2^16, so no carry between the
//           two 16-bit fields), q = ((s + 0x007F007F + ((s >> 8) &
//           0x00010001)) >> 8) & 0x00FF00FF, the integer round half to
//           even of s / 256, and out = q_lo | (q_hi << 8).
// Bound on the H100: device memory. Each output word reads about one ext
//           word (the 4-word border aside) and writes one: the 8K plane
//           (Ws = 1920, 33.18 MP, 66.5 MB in and out) cannot take less than
//           19.8 us at 3.35 TB/s. Integer work, counted from the
//           arithmetic: per output word and row, 2 field splits, 8 for the
//           two row passes (two adds and two multiply-adds each), 8 adds
//           for the two column cascades, 8 for the two rounds and the
//           repack: 26 instructions a word, 6.5 a pixel; at 64 32-bit
//           integer lanes an SM a clock over 132 SMs at 1.98 GHz (16.7
//           T/s) the 8.3 M words take 12.9 us, under the bytes bound.
//           The granule path's compiled loop runs 359 instructions for two
//           rows of four words (45 a word, with the shuffles, the ring's
//           loads and copies, the addresses and the loop).
// Design:   the TPU kernel streams row blocks in order and carries the
//           previous block's row-pass fields in scratch memory. The first
//           design here ran the blocks in parallel instead: a block of
//           `bh` output rows and 32 words loaded its bh + 4 rows of 36
//           words into shared memory one 4-byte word at a time (a bounds
//           test and a divide by 36 each), wrote both row-pass field sets
//           to shared memory, read ten of them back per output word and
//           stored one word a thread, in three phases between barriers,
//           with shared memory growing with bh; it ran at 27% of the bytes
//           bound (0.0738 ms on the 8K plane). This one carries the TPU
//           walk into a loop inside each thread:
//           - Four output words a thread, one 16-byte store: output word j
//             reads ext words j .. j + 4, so the thread of granule g (words
//             4g .. 4g + 3) needs ext granules g and g + 1. It copies its
//             own granule; g + 1 is the next lane's, taken by
//             __shfl_down_sync, and lane 31 copies it itself.
//           - A block of up to 128 threads owns a strip of up to 512 words
//             and a run of rows (the host's picker, swar_proto.launch_shape,
//             cuts runs so that the card holds about 24 warps an SM: 21
//             rows at 8K). Each thread walks its run's ext rows once, top
//             to bottom: the vertical halo is read once a run, and 4 rows a
//             run are reread, mostly from L2.
//           - The column pass carries its window in registers as a cascade
//             of four [1, 1] sums a field set and word (1 4 6 4 1 =
//             (1 + z)^4): each new row costs four adds a field set. Its
//             first four rows only fill it. The loop takes two rows an
//             iteration, so the cascades need no register moves.
//           - Loads in flight: each thread keeps a ring of SP_DEPTH rows of
//             its granules in shared memory, filled by cp.async: row i is
//             read while rows i + 1 .. i + 7 are in flight. Each thread
//             reads only what it copied itself, so a wait_group and no
//             barrier orders them.
//           - Alignment: the granule path runs when Ws % 4 == 0 and both
//             base pointers are 16-byte aligned (the ext pitch is then a
//             16-byte multiple). Otherwise, chosen once per launch, each
//             thread loads its eight ext words one by one (column indices
//             clamped to the row) two rows ahead in registers, and stores
//             each of its words below Ws.
//           - Lanes past the row compute on clamped columns and store
//             nothing; a warp wholly past it returns at once.
//           Measured on the 8K plane (PERF.md): 2.3x the first design, 63%
//           of the bytes bound, 1.13x T4's u8 copy of the plane. What lost:
//           two rows in flight in registers (1.3x slower), rings of 4 or
//           16 rows, runs of 16 or 42 rows, strips of 32 or 64 threads
//           (tied), copies past the run's end or predicated in PTX (slower,
//           or spilled at 80 registers), a 64-register cap (spills).
//           The JAX block height (the wrapper's `bh`) sets nothing here.
//           Built with -fmad=false; there is no float in this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_MAX_THREADS 128  // threads a block: a strip of up to 512 output words
#define SP_HALO 2
#define SP_LO 0x00FF00FFu  // the lo field set: bytes 0 and 2
// ext rows a thread's granule ring holds (granule path; a power of two):
// row i is read while rows i + 1 .. i + SP_DEPTH - 1 are in flight
#define SP_DEPTH 8

// The hi field set of a word: bytes 1 and 3 as 16-bit fields, (w >> 8) &
// SP_LO in one byte permute.
__device__ __forceinline__ uint32_t sp_hi(uint32_t w) { return __byte_perm(w, 0u, 0x4341); }

// The row pass of output word k of four, over fields k .. k + 4 of eight.
__device__ __forceinline__ uint32_t sp_row5(const uint32_t (&f)[8], int k) {
  return (f[k] + f[k + 4]) + 4u * (f[k + 1] + f[k + 3]) + 6u * f[k + 2];
}

// One step of a column cascade: four [1, 1] sums, each stage keeping its
// last input. Returns the 1 4 6 4 1 sum of the last five rows fed.
__device__ __forceinline__ uint32_t sp_cascade(uint32_t (&p)[4], uint32_t r) {
  const uint32_t x1 = p[0] + r, x2 = p[1] + x1, x3 = p[2] + x2, s = p[3] + x3;
  p[0] = r;
  p[1] = x1;
  p[2] = x2;
  p[3] = x3;
  return s;
}

// s + 127 + (s / 256 odd) on both fields: its bits 8-15 and 24-31 are the
// rounded s / 256 (no field passes 65408, so nothing carries between them).
__device__ __forceinline__ uint32_t sp_round(uint32_t s) {
  return s + 0x007F007Fu + ((s >> 8) & 0x00010001u);
}

// One 16-byte cp.async from device memory into shared memory, past L1.
__device__ __forceinline__ void sp_cp16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Launch: blockDim.x threads (a multiple of 32, at most SP_MAX_THREADS)
// per strip, grid (strips, runs). Thread g of the row takes output words
// 4g .. 4g + 3 of the run's rows r0 .. r0 + run_h - 1 (those below H and
// Ws). VEC: the granule path (Ws % 4 == 0, ext and out 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(SP_MAX_THREADS)
swar_proto_kernel(const uint32_t* __restrict__ ext, uint32_t* __restrict__ out, int H, int Ws,
                  int run_h) {
  // VEC: each thread's granule ring, and lane 31's neighbour granules after
  __shared__ uint4 ring[SP_DEPTH][SP_MAX_THREADS + SP_MAX_THREADS / 32];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int ngran = (Ws + 3) >> 2;
  if ((g & ~31) >= ngran) return;  // the whole warp lies past the row
  const bool last = (threadIdx.x & 31) == 31;
  const int r0 = blockIdx.y * run_h;
  const int n_in = min(run_h, H - r0) + 2 * SP_HALO;  // ext rows of the run
  const int pitch = Ws + 2 * SP_HALO;
  const uint32_t* src = ext + (size_t)r0 * pitch;
  uint32_t* dst = out + (size_t)r0 * Ws + 4 * g;

  // granule path: ext granules g and g + 1 (lane 31), clamped to the row
  const int pitch4 = pitch >> 2;
  const uint4* own = reinterpret_cast<const uint4*>(src) + min(g, pitch4 - 1);
  const uint4* nxt = reinterpret_cast<const uint4*>(src) + min(g + 1, pitch4 - 1);
  const int xslot = SP_MAX_THREADS + (threadIdx.x >> 5);
  auto copy_row = [&](int row) {  // row < n_in: its granules into slot row % SP_DEPTH
    uint4* slot = ring[row & (SP_DEPTH - 1)];
    sp_cp16(slot + threadIdx.x, own + row * pitch4);
    if (last) sp_cp16(slot + xslot, nxt + row * pitch4);
  };
  // 4-byte path: a thread's eight ext columns, clamped to the row; the raw
  // words of rows i + 1 and i + 2, in flight while row i computes
  int col[8];
  uint32_t a0[8] = {}, a1[8] = {};
  auto load = [&](uint32_t (&a)[8], int row) {
    const uint32_t* s = src + row * pitch;
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = __ldg(s + col[k]);
  };
  if constexpr (VEC) {
#pragma unroll
    for (int r = 0; r < SP_DEPTH - 1; ++r) {
      if (r < n_in) copy_row(r);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = min(4 * g + k, pitch - 1);
    load(a0, 0);
    load(a1, 1);  // a run has at least 5 ext rows
  }

  uint32_t lo[4][4] = {}, hi[4][4] = {};  // column cascades: word, stage
  // two rows an iteration, so that the cascades and the 4-byte path's rows
  // trade registers without moves
#pragma unroll 2
  for (int i = 0; i < n_in; ++i) {
    uint32_t w[8];
    if constexpr (VEC) {
      // row i has landed once at most SP_DEPTH - 2 younger groups are pending
      asm volatile("cp.async.wait_group %0;\n" ::"n"(SP_DEPTH - 2) : "memory");
      const uint4* slot = ring[i & (SP_DEPTH - 1)];
      const uint4 q = slot[threadIdx.x];
      const uint4 x = last ? slot[xslot] : q;
      // row i + SP_DEPTH - 1 goes to the slot row i - 1 left
      if (i + SP_DEPTH - 1 < n_in) copy_row(i + SP_DEPTH - 1);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
      const uint32_t nb[4] = {__shfl_down_sync(0xFFFFFFFFu, q.x, 1),
                              __shfl_down_sync(0xFFFFFFFFu, q.y, 1),
                              __shfl_down_sync(0xFFFFFFFFu, q.z, 1),
                              __shfl_down_sync(0xFFFFFFFFu, q.w, 1)};
      // words 4 .. 7 are the next lane's granule; lane 31 loaded its own
      w[4] = last ? x.x : nb[0], w[5] = last ? x.y : nb[1];
      w[6] = last ? x.z : nb[2], w[7] = last ? x.w : nb[3];
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = a0[k], a0[k] = a1[k];
      load(a1, min(i + 2, n_in - 1));
    }
    uint32_t fl[8], fh[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) fl[k] = w[k] & SP_LO, fh[k] = sp_hi(w[k]);
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t sl = sp_cascade(lo[k], sp_row5(fl, k));
      const uint32_t sh = sp_cascade(hi[k], sp_row5(fh, k));
      o[k] = ((sp_round(sl) >> 8) & SP_LO) | (sp_round(sh) & ~SP_LO);
    }
    if (i < 2 * SP_HALO) continue;  // the cascade's first four rows only fill it
    if constexpr (VEC) {
      if (g < ngran) *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * g + k < Ws) dst[k] = o[k];
      }
    }
    dst += Ws;
  }
}

// T3 over an (H + 4, Ws + 4) ext word array into (H, Ws) words: strips of
// `strip_words` output words (a multiple of 128, at most 4 SP_MAX_THREADS),
// runs of `run_h` rows, on `stream`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int swar_proto_launch(const unsigned int* ext, unsigned int* out, int H, int Ws,
                                 int strip_words, int run_h, void* stream) {
  if (H <= 0 || Ws <= 0) return 0;
  const int threads = strip_words / 4;
  if (strip_words % 128 || threads > SP_MAX_THREADS || run_h < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int ngran = (Ws + 3) / 4;
  const long long runs = ((long long)H + run_h - 1) / run_h;
  if (runs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((ngran + threads - 1) / threads, (unsigned)runs);
  const bool vec = Ws % 4 == 0 && ((uintptr_t)ext & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    swar_proto_kernel<true><<<grid, threads, 0, s>>>(ext, out, H, Ws, run_h);
  } else {
    swar_proto_kernel<false><<<grid, threads, 0, s>>>(ext, out, H, Ws, run_h);
  }
  return (int)cudaGetLastError();
}
