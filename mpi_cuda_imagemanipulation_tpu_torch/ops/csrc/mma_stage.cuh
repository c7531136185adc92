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
//           stencil.cuh, as the VPU arm does. Separable ops contract their
//           2-D kernel (the host puts it in w0). Two forms:
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
//           (bf16) and 1979 TOP/s (int8) the card has. What sets the pace
//           is getting the operands to the tensor cores.
// Design:   one warp computes a 16 x 8 output tile (rows x columns) of the
//           stencil's output region per step. The band of an 8-column
//           block starting at window column c0 meets only the window
//           columns c0 - h .. c0 + 7 + h, so each kernel row contracts
//           K = 16 columns from c0 - h (8 + 2h <= 14 of them meet nonzero
//           taps), not the TPU's B + 2h = 128 + 2h: one k16 step per
//           kernel row in bf16, and one k32 step per pair of kernel rows
//           in int8 (k < 16 from row d, k >= 16 from row d + 1). The first
//           design built every fragment element by element, every tile
//           (four bounds-checked byte loads per A register, B rebuilt from
//           float taps with range checks), and ran 1.29-1.62x the VPU arm
//           of the same stage. This one:
//           - B in registers, built once per stencil and warp (MmaB): it
//             depends on the lane and the taps only; the magnitude's two
//             kernels share every A fragment.
//           - A as word loads: the columns c0 - h + 4t (int8) and c0 - h +
//             2t (bf16) are word- and halfword-aligned in the buffers (the
//             region starts at offset 0, the pitch is a multiple of 4), so
//             an int8 register is one 32-bit shared load and ^ 0x80808080
//             (u8 - 128 as s8) and a bf16 register one 16-bit load, the two
//             bytes converted to float and their top halves packed. Elements
//             past the region are not zeroed: the band's entries there are
//             0 (the kept outputs' taps all lie in the window) and every
//             loaded byte is a finite value, so they add exact zeros. A
//             tile's reads past the region's last row are clamped to it and
//             its column to the pitch: one min per row and tile, no check
//             per element. The bf16 conversion takes no conversion
//             instruction: the byte in the mantissa of 2^23, 2^23
//             subtracted exactly.
//           - No A register is carried from one column tile to the next:
//             in bf16 the next tile's first half is this tile's second (the
//             int8 layout puts those columns in other lanes), but holding it
//             took 2 KS registers and ran the bf16 stages 1.04-1.63x
//             slower on the H100.
//           - The passthrough test hoisted out of regions wholly inside the
//             image; each lane's two adjacent outputs stored as one 16-bit
//             word.

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

// One plane of the stencil's input region as the tile functions read it:
// `rows` rows from `p`, `P` bytes apart (a multiple of 4, 4-byte aligned).
struct MmaWin {
  const unsigned char* p;
  int P;
  int rows;
};

// The row of the region at `r` (a tile's reads past the region's last row
// clamped to it) and the 4 bytes at column c of it, c a multiple of 4 and
// at most P - 4 (the caller clamps it once per tile).
__device__ __forceinline__ const unsigned char* mma_row(const MmaWin& s, int r) {
  return s.p + min(r, s.rows - 1) * s.P;
}

__device__ __forceinline__ unsigned mma_ld32(const unsigned char* row, int c) {
  return *reinterpret_cast<const unsigned*>(row + c);
}

// The 2 bytes at column c (even, at most P - 2), low byte first.
__device__ __forceinline__ unsigned mma_ld16(const unsigned char* row, int c) {
  return *reinterpret_cast<const unsigned short*>(row + c);
}

// bf16 bits of a float with at most 8 significant bits: the top half of
// its float bits, exactly.
__device__ __forceinline__ unsigned mma_bf16_bits(float v) { return __float_as_uint(v) >> 16; }

// Two u8 values (the low two bytes of v) as packed bf16, the lower byte in
// the lower half, with no conversion instruction: a byte permute puts each
// into the mantissa of 2^23 (the float 2^23 + x), an exact subtraction of
// 2^23 leaves x, and a byte permute gathers the two top halves.
__device__ __forceinline__ unsigned mma_bf16x2(unsigned v) {
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440)), 8388608.0f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441)), 8388608.0f);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
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

// One kernel's B fragments for this lane, held for the whole stencil: int8,
// r[p] for kernel rows (2p, 2p + 1); bf16, r[d] for kernel row d.
template <int KS, bool INT8>
struct MmaB {
  static constexpr int N = INT8 ? (KS + 1) / 2 : KS;
  unsigned r[N][2];
};

template <int KS, bool INT8>
__device__ __forceinline__ void mma_b_build(MmaB<KS, INT8>& b, const float* w, int g, int t) {
#pragma unroll
  for (int p = 0; p < MmaB<KS, INT8>::N; ++p) {
    if (INT8) {
      b.r[p][0] = mma_b_s8<KS>(w, 2 * p, 4 * t - g);
      b.r[p][1] = mma_b_s8<KS>(w, 2 * p + 1, 4 * t - g);
    } else {
      b.r[p][0] = mma_b_bf16<KS>(w, p, 2 * t - g);
      b.r[p][1] = mma_b_bf16<KS>(w, p, 2 * t + 8 - g);
    }
  }
}

// 128 * sum(w): the int8 form's correction, exact (integer taps).
template <int KS>
__device__ __forceinline__ float mma_corr128(const float* w) {
  float s = 0.0f;
  for (int i = 0; i < KS * KS; ++i) s = __fadd_rn(s, w[i]);
  return __fmul_rn(128.0f, s);
}

// The s32 sums of one or (TWO) two kernels over the 16 x 8 output tile
// whose first output is window position (r0, c0): this lane's four,
// D(g, 2t..2t+1) and D(g+8, 2t..2t+1). A(m, k) = x(r0 - h + d + m, c0 - h +
// k) - 128, B(k, n) = w[d][k - n]: one k32 step per kernel row pair. Rows
// past the region's last are clamped to it, and the column to the pitch.
template <int KS, bool TWO>
__device__ __forceinline__ void mma_tile_int8(int (&s0)[4], int (&s1)[4], const MmaWin& s,
                                              const MmaB<KS, true>& b0,
                                              const MmaB<KS, true>& b1, int r0, int c0, int g,
                                              int t) {
  constexpr int h = KS / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0;
  const int c = min(c0 - h + 4 * t, s.P - 4);
#pragma unroll
  for (int p = 0; p < (KS + 1) / 2; ++p) {
    const int r = r0 - h + 2 * p + g;
    const bool pair = 2 * p + 1 < KS;
    const unsigned a[4] = {mma_ld32(mma_row(s, r), c) ^ 0x80808080u,
                           mma_ld32(mma_row(s, r + 8), c) ^ 0x80808080u,
                           pair ? mma_ld32(mma_row(s, r + 1), c) ^ 0x80808080u : 0u,
                           pair ? mma_ld32(mma_row(s, r + 9), c) ^ 0x80808080u : 0u};
    mma_s8_m16n8k32(s0, a, b0.r[p]);
    if (TWO) mma_s8_m16n8k32(s1, a, b1.r[p]);
  }
}

// The f32 sums of one or two kernels over one tile in the bf16 form: one
// k16 step per kernel row.
template <int KS, bool TWO>
__device__ __forceinline__ void mma_tile_bf16(float (&a0)[4], float (&a1)[4], const MmaWin& s,
                                              const MmaB<KS, false>& b0,
                                              const MmaB<KS, false>& b1, int r0, int c0, int g,
                                              int t) {
  constexpr int h = KS / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) a0[i] = a1[i] = 0.0f;
  const int c = min(c0 - h + 2 * t, s.P - 2), c8 = min(c0 - h + 2 * t + 8, s.P - 2);
#pragma unroll
  for (int d = 0; d < KS; ++d) {
    const unsigned char* row = mma_row(s, r0 - h + d + g);
    const unsigned char* row8 = mma_row(s, r0 - h + d + g + 8);
    const unsigned a[4] = {mma_bf16x2(mma_ld16(row, c)), mma_bf16x2(mma_ld16(row8, c)),
                           mma_bf16x2(mma_ld16(row, c8)), mma_bf16x2(mma_ld16(row8, c8))};
    mma_bf16_m16n8k16(a0, a, b0.r[d]);
    if (TWO) mma_bf16_m16n8k16(a1, a, b1.r[d]);
  }
}

// The magnitude combine of st_window (stencil.cuh), on two exact sums.
__device__ __forceinline__ float mma_magnitude(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}

// This lane's four exact sums of one tile (the int8 form's with 128 *
// sum(w) added back), `acc1` the second kernel's (TWO).
template <int KS, bool INT8, bool TWO>
__device__ __forceinline__ void mma_tile(float (&acc0)[4], float (&acc1)[4], const MmaWin& s,
                                         const MmaB<KS, INT8>& b0, const MmaB<KS, INT8>& b1,
                                         float corr0, float corr1, int r0, int c0, int g,
                                         int t) {
  if constexpr (INT8) {
    int s0[4], s1[4];
    mma_tile_int8<KS, TWO>(s0, s1, s, b0, b1, r0, c0, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc0[i] = __fadd_rn(__int2float_rn(s0[i]), corr0);
      acc1[i] = TWO ? __fadd_rn(__int2float_rn(s1[i]), corr1) : 0.0f;
    }
  } else {
    mma_tile_bf16<KS, TWO>(acc0, acc1, s, b0, b1, r0, c0, g, t);
  }
}
