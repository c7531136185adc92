// Per-pixel interpreter of a pointwise op chain, shared by the pointwise
// group kernel (pointwise.cu, K1), the fused stencil kernel
// (stream_stencil.cu, K2), the fused plan-stage megakernel
// (fused_stage.cu, K4) and the tools' packed kernels (packed_stream.cu T1,
// packed_proto.cu T2).
//
// A chain is a table of PwOp in device memory, an opcode and up to two
// float32 parameters per op, of any length: the wrapper builds it once per
// chain (ops/cuda_kernels.chain_for). K2 and K4 copy it into shared memory
// before their load loops (pw_copy_chain); K1, T1 and T2 read each op
// through the read-only cache (pw_apply_ldg). Each op repeats its golden
// PyTorch core (ops/registry.py) operation for operation: every product
// and sum is one IEEE-rounded float32 step (__fmul_rn / __fadd_rn, and the
// sources are built with -fmad=false), so the results are the golden
// bytes. Values entering and leaving every op
// are exact integers in [0, 255].

#pragma once

#include <cuda_runtime.h>

// Opcodes: the same numbers as PW_* in ops/spec.py.
enum PwOpcode {
  PW_GRAYSCALE = 0,     // 3 -> 1, kernel.cu:39-42, per-term truncation
  PW_GRAYSCALE601 = 1,  // 3 -> 1, OpenCV fixed-point Rec.601
  PW_SEPIA = 2,         // 3 -> 3, integer matrix x1000 then * 0.001
  PW_GRAY2RGB = 3,      // 1 -> 3, replicate
  PW_CONTRAST = 4,      // p0 = factor (rounding-free factors only)
  PW_BRIGHTNESS = 5,    // p0 = delta
  PW_INVERT = 6,
  PW_THRESHOLD = 7,     // p0 = threshold
  PW_POSTERIZE = 8,     // p0 = step (a power of two)
  PW_SOLARIZE = 9,      // p0 = threshold
};

// One op of a chain table: 16 bytes, the layout of chain_table's rows.
struct PwOp {
  int op;
  float p0;
  float p1;
  int pad;
};

__device__ __forceinline__ float pw_clip(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// trunc_clip: clamp to [0, 255], then floor.
__device__ __forceinline__ float pw_trunc_clip(float x) {
  return floorf(pw_clip(x));
}

// rint_clip: round half to even, then clamp.
__device__ __forceinline__ float pw_rint_clip(float x) {
  return pw_clip(rintf(x));
}

__device__ __forceinline__ float pw_sepia_row(float r, float g, float b,
                                              float m0, float m1, float m2) {
  float acc = __fadd_rn(__fadd_rn(__fmul_rn(r, m0), __fmul_rn(g, m1)),
                        __fmul_rn(b, m2));
  return pw_rint_clip(__fmul_rn(acc, 0.001f));
}

// Each channel c < n of each of the N pixels as x, replaced by EXPR.
#define PW_EACH(EXPR)                      \
  _Pragma("unroll") for (int j = 0; j < N; ++j) { \
    _Pragma("unroll") for (int c = 0; c < 3; ++c) { \
      if (c < n) {                         \
        const float x = v[j][c];           \
        v[j][c] = (EXPR);                  \
      }                                    \
    }                                      \
  }                                        \
  return n;

// Applies one op (opcode `op`, parameter `a`) to N pixels: `v[j]` holds
// pixel j's `n` channel values; returns the channel count after the op. The
// opcode's dispatch runs once for the N pixels; each pixel's arithmetic is
// the same as alone.
template <int N>
__device__ __forceinline__ int pw_apply_lanes(int op, float a, float (*v)[3], int n) {
  switch (op) {
    case PW_GRAYSCALE:
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float tr = floorf(__fmul_rn(v[j][0], 0.3f));
        const float tg = floorf(__fmul_rn(v[j][1], 0.59f));
        const float tb = floorf(__fmul_rn(v[j][2], 0.11f));
        v[j][0] = __fadd_rn(__fadd_rn(tr, tg), tb);
      }
      return 1;
    case PW_GRAYSCALE601:
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = __fadd_rn(__fmul_rn(v[j][0], 4899.0f), __fmul_rn(v[j][1], 9617.0f));
        acc = __fadd_rn(acc, __fmul_rn(v[j][2], 1868.0f));
        acc = __fadd_rn(acc, 8192.0f);
        v[j][0] = floorf(__fmul_rn(acc, 0.00006103515625f));  // 2^-14, exact
      }
      return 1;
    case PW_SEPIA:
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float r = v[j][0], g = v[j][1], b = v[j][2];
        v[j][0] = pw_sepia_row(r, g, b, 393.0f, 769.0f, 189.0f);
        v[j][1] = pw_sepia_row(r, g, b, 349.0f, 686.0f, 168.0f);
        v[j][2] = pw_sepia_row(r, g, b, 272.0f, 534.0f, 131.0f);
      }
      return 3;
    case PW_GRAY2RGB:
#pragma unroll
      for (int j = 0; j < N; ++j) v[j][1] = v[j][2] = v[j][0];
      return 3;
    // elementwise ops act identically on every channel
    case PW_CONTRAST:
      PW_EACH(pw_trunc_clip(__fadd_rn(__fmul_rn(a, __fsub_rn(x, 128.0f)), 128.0f)))
    case PW_BRIGHTNESS:
      PW_EACH(pw_trunc_clip(__fadd_rn(x, a)))
    case PW_INVERT:
      PW_EACH(__fsub_rn(255.0f, x))
    case PW_THRESHOLD:
      PW_EACH(x >= a ? 255.0f : 0.0f)
    case PW_POSTERIZE: {
      // the step is a power of two (2^(8 - bits), checked by the host's
      // encoder): then 1 / a is exact and x * (1 / a) equals x / a, without
      // the division's slow path
      const float inv = __fdiv_rn(1.0f, a);
      PW_EACH(__fmul_rn(floorf(__fmul_rn(x, inv)), a))
    }
    case PW_SOLARIZE:
      PW_EACH(x >= a ? __fsub_rn(255.0f, x) : x)
    default:
      return n;
  }
}

#undef PW_EACH

// Applies one op (opcode `op`, parameter `a`) to one pixel. `v` holds `n`
// channel values; returns the channel count after the op.
__device__ __forceinline__ int pw_apply_one(int op, float a, float v[3], int n) {
  return pw_apply_lanes<1>(op, a, reinterpret_cast<float(*)[3]>(v), n);
}

// Applies the chain `ops[0 .. n_ops)` (in shared memory) to N pixels at
// once, each op dispatched once for all N.
template <int N>
__device__ __forceinline__ int pw_apply_n(const PwOp* ops, int n_ops, float (*v)[3], int n) {
  for (int k = 0; k < n_ops; ++k) n = pw_apply_lanes<N>(ops[k].op, ops[k].p0, v, n);
  return n;
}

// Applies the chain `ops[0 .. n_ops)` (in shared memory) to one pixel. `v`
// holds `n` channel values; returns the channel count after the chain. The
// wrapper has checked that the chain's channel counts agree.
__device__ __forceinline__ int pw_apply(const PwOp* ops, int n_ops, float v[3], int n) {
  for (int k = 0; k < n_ops; ++k) n = pw_apply_one(ops[k].op, ops[k].p0, v, n);
  return n;
}

// The chain `ops[0 .. n_ops)` in device memory applied to N pixels, each
// op read through the read-only cache (uniform over the warp) and
// dispatched once for the N.
template <int N>
__device__ __forceinline__ int pw_apply_ldg(const PwOp* __restrict__ ops, int n_ops,
                                            float (*v)[3], int n) {
  for (int k = 0; k < n_ops; ++k) n = pw_apply_lanes<N>(__ldg(&ops[k].op), __ldg(&ops[k].p0), v, n);
  return n;
}

// The block's threads copy the chain table into shared memory `s_ops`; the
// caller synchronises before the first pw_apply.
__device__ __forceinline__ void pw_copy_chain(PwOp* s_ops, const PwOp* __restrict__ ops,
                                              int n_ops) {
  for (int k = threadIdx.x; k < n_ops; k += blockDim.x) s_ops[k] = ops[k];
}

// Loads `n` interleaved u8 channels of one pixel.
__device__ __forceinline__ void pw_load(const unsigned char* p, float v[3], int n) {
  v[0] = (float)p[0];
  v[1] = n > 1 ? (float)p[1] : 0.0f;
  v[2] = n > 2 ? (float)p[2] : 0.0f;
}

// The u8 value of a float holding a u8-valued result, clipped first.
__device__ __forceinline__ unsigned char pw_to_u8(float x) {
  return (unsigned char)(int)pw_clip(x);
}
