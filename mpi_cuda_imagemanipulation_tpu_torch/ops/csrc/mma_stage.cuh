// K5: the tensor-core arm of the fused plan-stage megakernel (K4 and K4g,
// fused_stage.cu), one stencil op of a stage at a time.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/mxu_kernels.py
//           stage_valid_mxu with _stage_corr2d, _stage_corr2d_int8 and
//           _band2_traced: the arm != 'vpu' branch of _stage_kernel
//           (ops/pallas_kernels.py) inside K4's pallas_call.
// Computes: a stencil's valid-mode correlation over the u8 window buffer
//           in shared memory, as products with a banded matrix:
//           out[r, n] = sum_d sum_k x[r + d, k] * C_d[k, n], with
//           C_d[n + i, n] = w[d][i]; then the golden magnitude combine
//           (two kernels), scale, quantizer and interior passthrough of
//           stencil.cuh, as the VPU arm does, into the other buffer.
//           Separable ops contract their 2-D kernel (the host puts it in
//           w0). Two forms:
//           - bf16 (arm 'mxu'): mma.sync m16n8k16, bf16 operands (u8
//             values and eligible taps are exact in bf16), f32 sums;
//           - int8 (arm 'mxu-int8'): mma.sync m16n8k32, x - 128 and the
//             taps (|w| <= 127, ops/mxu_kernels.mxu_int8_ok) as s8, s32
//             sums, then __int2float_rn(s) + 128 * sum(w) in f32.
//           Every product and partial sum is an integer below 2^24 (int8:
//           2^23), so the result is the golden sum bit for bit provided
//           the tensor cores keep 24 bits in their f32 sums; chip_smoke.py
//           checks that at the inputs where the sums are largest.
// Bound on the H100: the megakernel's (device memory; see fused_stage.cu).
//           The tensor-core work is 16 MACs per output, kernel row and
//           kernel (bf16) or 16 per output, kernel row pair and kernel
//           (int8), against KS * KS useful ones: far below the 989 TFLOP/s
//           (bf16) and 1979 TOP/s (int8) the card has.
// Design:   one warp computes a 16 x 8 output tile (rows x columns) of the
//           stencil's output region per step, the block's eight warps
//           striding over the region's tiles. The band of an 8-column
//           block starting at window column c0 meets only the window
//           columns c0 - h .. c0 + 7 + h, so each kernel row contracts
//           K = 16 columns from c0 - h (8 + 2h <= 14 of them meet nonzero
//           taps), not the TPU's B + 2h = 128 + 2h: one k16 step per
//           kernel row in bf16, and one k32 step per pair of kernel rows
//           in int8 (k < 16 from row d, k >= 16 from row d + 1). A comes
//           from the u8 buffer, converted in registers (bf16 bits of a
//           small integer are its float bits' top half; s8 is x - 128),
//           zero where the element lies outside the stencil's input
//           window, so no read leaves the window; B is built in registers
//           from the taps in the stage program. Stores are predicated to
//           the output region, which is not a multiple of 16 x 8.

#pragma once

#include "stencil.cuh"

#define FS_ARM_VPU 0
#define FS_ARM_BF16 1
#define FS_ARM_INT8 2

// D += A * B for one warp: A 16x16 bf16 (row major), B 16x8 bf16 (column
// major), D 16x8 f32. Fragment layout (PTX ISA, mma.m16n8k16): lane
// (g = lane / 4, t = lane % 4) holds A(g, 2t..2t+1), A(g+8, 2t..2t+1),
// A(g, 2t+8..2t+9), A(g+8, 2t+8..2t+9); B(2t..2t+1, g), B(2t+8..2t+9, g);
// D(g, 2t..2t+1), D(g+8, 2t..2t+1). The lower half of a register holds the
// lower index.
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4], const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A * B for one warp: A 16x32 s8 (row major), B 32x8 s8 (column
// major), D 16x8 s32. Lane (g, t) holds A(g, 4t..4t+3), A(g+8, 4t..4t+3),
// A(g, 16+4t..16+4t+3), A(g+8, 16+4t..16+4t+3); B(4t..4t+3, g),
// B(16+4t..16+4t+3, g); D as in the bf16 form. Byte j of a register holds
// index j of its four.
__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4], const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One plane of the stencil's input window: window positions [lo_y, hi_y) x
// [lo_x, hi_x) of a buffer `ew` bytes wide.
struct MmaSrc {
  const unsigned char* p;
  int ew, lo_y, hi_y, lo_x, hi_x;
};

__device__ __forceinline__ bool mma_in(const MmaSrc& s, int r, int c) {
  return r >= s.lo_y && r < s.hi_y && c >= s.lo_x && c < s.hi_x;
}

// bf16 bits of a float with at most 8 significant bits: the top half of
// its float bits, exactly.
__device__ __forceinline__ unsigned mma_bf16_bits(float v) { return __float_as_uint(v) >> 16; }

// Two window elements (r, c), (r, c + 1) as packed bf16, zero outside.
__device__ __forceinline__ unsigned mma_a_bf16(const MmaSrc& s, int r, int c) {
  const float lo = mma_in(s, r, c) ? (float)s.p[r * s.ew + c] : 0.0f;
  const float hi = mma_in(s, r, c + 1) ? (float)s.p[r * s.ew + c + 1] : 0.0f;
  return mma_bf16_bits(lo) | (mma_bf16_bits(hi) << 16);
}

// Four window elements (r, c .. c + 3) as packed s8 x - 128, zero outside.
__device__ __forceinline__ unsigned mma_a_s8(const MmaSrc& s, int r, int c) {
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = mma_in(s, r, c + j) ? (int)s.p[r * s.ew + c + j] - 128 : 0;
    v |= ((unsigned)x & 0xFFu) << (8 * j);
  }
  return v;
}

// Tap w[d][j] of a KS x KS kernel, zero outside it: the band entry C_d[k, n]
// with j = k - n.
template <int KS>
__device__ __forceinline__ float mma_tap(const float* w, int d, int j) {
  return (d < KS && j >= 0 && j < KS) ? w[d * KS + j] : 0.0f;
}

template <int KS>
__device__ __forceinline__ unsigned mma_b_bf16(const float* w, int d, int j) {
  return mma_bf16_bits(mma_tap<KS>(w, d, j)) | (mma_bf16_bits(mma_tap<KS>(w, d, j + 1)) << 16);
}

template <int KS>
__device__ __forceinline__ unsigned mma_b_s8(const float* w, int d, int j) {
  unsigned v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) v |= ((unsigned)(int)mma_tap<KS>(w, d, j + i) & 0xFFu) << (8 * i);
  return v;
}

// 128 * sum(w): the int8 form's correction, exact (integer taps).
template <int KS>
__device__ __forceinline__ float mma_corr128(const float* w) {
  float s = 0.0f;
  for (int i = 0; i < KS * KS; ++i) s = __fadd_rn(s, w[i]);
  return __fmul_rn(128.0f, s);
}

// The sums of one kernel over one 16 x 8 output tile whose first output
// is window position (r0, c0): this lane's four, D(g, 2t..2t+1) and
// D(g+8, 2t..2t+1), as exact f32 integers. A(m, k) = x(r0 - h + d + m,
// c0 - h + k), B(k, n) = w[d][k - n].
template <int KS>
__device__ __forceinline__ void mma_tile_bf16(float (&acc)[4], const MmaSrc& s,
                                              const float* w, int r0, int c0, int g,
                                              int t) {
  constexpr int h = KS / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int d = 0; d < KS; ++d) {
    const int r = r0 - h + d + g, c = c0 - h + 2 * t;
    const unsigned a[4] = {mma_a_bf16(s, r, c), mma_a_bf16(s, r + 8, c),
                           mma_a_bf16(s, r, c + 8), mma_a_bf16(s, r + 8, c + 8)};
    const unsigned b[2] = {mma_b_bf16<KS>(w, d, 2 * t - g), mma_b_bf16<KS>(w, d, 2 * t + 8 - g)};
    mma_bf16_m16n8k16(acc, a, b);
  }
}

// The same in the int8 form: one k32 step per kernel row pair (d, d + 1),
// then the s32 sums to f32 with 128 * sum(w) added back.
template <int KS>
__device__ __forceinline__ void mma_tile_int8(float (&acc)[4], const MmaSrc& s,
                                              const float* w, float corr, int r0, int c0,
                                              int g, int t) {
  constexpr int h = KS / 2;
  int sum[4] = {0, 0, 0, 0};
#pragma unroll
  for (int d = 0; d < KS; d += 2) {
    const int r = r0 - h + d + g, c = c0 - h + 4 * t;
    const bool pair = d + 1 < KS;
    const unsigned a[4] = {mma_a_s8(s, r, c), mma_a_s8(s, r + 8, c),
                           pair ? mma_a_s8(s, r + 1, c) : 0u,
                           pair ? mma_a_s8(s, r + 9, c) : 0u};
    const unsigned b[2] = {mma_b_s8<KS>(w, d, 4 * t - g), mma_b_s8<KS>(w, d + 1, 4 * t - g)};
    mma_s8_m16n8k32(sum, a, b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(__int2float_rn(sum[i]), corr);
}

// The magnitude combine of st_window (stencil.cuh), on two exact sums.
__device__ __forceinline__ float mma_magnitude(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}
