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
// Bound on the H100: device memory. Each output pixel reads about one byte
//           (plus the 4-word border) and writes one: an 8K plane
//           (33.18 MP) cannot take less than 19.8 us at 3.35 TB/s. The
//           integer work, about 40 operations per word (10 per pixel), is
//           far below the card's rate.
// Design:   the TPU kernel streams row blocks in order and carries the
//           previous block's row-pass fields in scratch memory. Here blocks
//           run in parallel: a block of `bh` output rows and 32 words
//           (128 pixels) loads its bh + 4 rows of 36 words into shared
//           memory, keeps its row-pass fields (lo and hi) there, and runs
//           the column pass from them; stores are predicated at H and Ws,
//           so no row past the image is written. This layout pairs strips,
//           not neighbouring columns as K6 does, so no funnel shifts.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_TILE_W 32  // output words per block
#define SP_THREADS 256
#define SP_HALO 2

// Dynamic shared memory of one block: the window, then the lo and hi
// row-pass fields.
__host__ __device__ inline size_t sp_smem_bytes(int bh) {
  const size_t eh = (size_t)bh + 2 * SP_HALO;
  return (eh * (SP_TILE_W + 2 * SP_HALO) + 2 * eh * SP_TILE_W) * sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t sp_taps5(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                             uint32_t e) {
  return a + 4u * b + 6u * c + 4u * d + e;
}

__global__ void __launch_bounds__(SP_THREADS)
swar_proto_kernel(const uint32_t* __restrict__ ext, uint32_t* __restrict__ out, int H, int Ws,
                  int bh) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int ew = SP_TILE_W + 2 * SP_HALO;
  const int eh = bh + 2 * SP_HALO;
  const int wsp = Ws + 2 * SP_HALO;  // ext row pitch, in words
  const int hp = H + 2 * SP_HALO;
  const int x0 = blockIdx.x * SP_TILE_W;
  const int y0 = blockIdx.y * bh;
  uint32_t* s_win = smem;
  uint32_t* s_lo = s_win + eh * ew;
  uint32_t* s_hi = s_lo + eh * SP_TILE_W;

  // 1. Window: ext rows y0 .. y0 + bh + 3, words x0 .. x0 + 35.
  for (int i = threadIdx.x; i < eh * ew; i += SP_THREADS) {
    const int r = i / ew;
    const int c = i - r * ew;
    const int gy = y0 + r, gx = x0 + c;
    s_win[i] = (gy < hp && gx < wsp) ? ext[(long long)gy * wsp + gx] : 0u;
  }
  __syncthreads();

  // 2. Row pass on the two field sets: output word j reads words j .. j + 4.
  for (int i = threadIdx.x; i < eh * SP_TILE_W; i += SP_THREADS) {
    const int r = i / SP_TILE_W;
    const int j = i - r * SP_TILE_W;
    const uint32_t* w = s_win + r * ew + j;
    s_lo[i] = sp_taps5(w[0] & 0x00FF00FFu, w[1] & 0x00FF00FFu, w[2] & 0x00FF00FFu,
                       w[3] & 0x00FF00FFu, w[4] & 0x00FF00FFu);
    s_hi[i] = sp_taps5((w[0] >> 8) & 0x00FF00FFu, (w[1] >> 8) & 0x00FF00FFu,
                       (w[2] >> 8) & 0x00FF00FFu, (w[3] >> 8) & 0x00FF00FFu,
                       (w[4] >> 8) & 0x00FF00FFu);
  }
  __syncthreads();

  // 3. Column pass over five rows, round half to even, repack, store.
  for (int i = threadIdx.x; i < bh * SP_TILE_W; i += SP_THREADS) {
    const int r = i / SP_TILE_W;
    const int j = i - r * SP_TILE_W;
    const int gy = y0 + r, gx = x0 + j;
    if (gy >= H || gx >= Ws) continue;
    const int o = r * SP_TILE_W + j;
    uint32_t q[2];
    const uint32_t* rows[2] = {s_lo + o, s_hi + o};
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const uint32_t* c = rows[f];
      const uint32_t s = sp_taps5(c[0], c[SP_TILE_W], c[2 * SP_TILE_W], c[3 * SP_TILE_W],
                                  c[4 * SP_TILE_W]);
      q[f] = ((s + 0x007F007Fu + ((s >> 8) & 0x00010001u)) >> 8) & 0x00FF00FFu;
    }
    out[(long long)gy * Ws + gx] = q[0] | (q[1] << 8);
  }
}

// T3 over an (H + 4, Ws + 4) ext word array into (H, Ws) words, blocks of
// `bh` output rows, on `stream`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int swar_proto_launch(const unsigned int* ext, unsigned int* out, int H, int Ws,
                                 int bh, void* stream) {
  if (H <= 0 || Ws <= 0) return 0;
  if (bh < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sp_smem_bytes(bh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swar_proto_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Ws + SP_TILE_W - 1) / SP_TILE_W, (H + bh - 1) / bh);
  swar_proto_kernel<<<grid, SP_THREADS, smem, (cudaStream_t)stream>>>(ext, out, H, Ws, bh);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one launch, for the host-side checks.
extern "C" long long swar_proto_smem_bytes(int bh) { return (long long)sp_smem_bytes(bh); }
