// Per-pixel interpreter of a pointwise op chain, shared by the pointwise
// group kernel (pointwise.cu, K1) and the fused stencil kernel
// (stream_stencil.cu, K2).
//
// A chain is a small program passed by value as a kernel parameter: an
// opcode and up to two float32 parameters per op, at most PW_MAX_OPS ops.
// Each op repeats its golden PyTorch core (ops/registry.py) operation for
// operation: every product and sum is one IEEE-rounded float32 step
// (__fmul_rn / __fadd_rn, and the sources are built with -fmad=false), so
// the results are the golden bytes. Values entering and leaving every op
// are exact integers in [0, 255].

#pragma once

#include <cuda_runtime.h>

#define PW_MAX_OPS 8

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

struct PwProgram {
  int n_ops;
  int op[PW_MAX_OPS];
  float p0[PW_MAX_OPS];
  float p1[PW_MAX_OPS];
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

// Applies `prog` to one pixel. `v` holds `n` channel values; returns the
// channel count after the chain. The wrapper has checked that the chain's
// channel counts agree.
__device__ __forceinline__ int pw_apply(const PwProgram& prog, float v[3], int n) {
  for (int k = 0; k < prog.n_ops; ++k) {
    const float a = prog.p0[k];
    switch (prog.op[k]) {
      case PW_GRAYSCALE: {
        const float tr = floorf(__fmul_rn(v[0], 0.3f));
        const float tg = floorf(__fmul_rn(v[1], 0.59f));
        const float tb = floorf(__fmul_rn(v[2], 0.11f));
        v[0] = __fadd_rn(__fadd_rn(tr, tg), tb);
        n = 1;
        break;
      }
      case PW_GRAYSCALE601: {
        float acc = __fadd_rn(__fmul_rn(v[0], 4899.0f), __fmul_rn(v[1], 9617.0f));
        acc = __fadd_rn(acc, __fmul_rn(v[2], 1868.0f));
        acc = __fadd_rn(acc, 8192.0f);
        v[0] = floorf(__fmul_rn(acc, 0.00006103515625f));  // 2^-14, exact
        n = 1;
        break;
      }
      case PW_SEPIA: {
        const float r = v[0], g = v[1], b = v[2];
        v[0] = pw_sepia_row(r, g, b, 393.0f, 769.0f, 189.0f);
        v[1] = pw_sepia_row(r, g, b, 349.0f, 686.0f, 168.0f);
        v[2] = pw_sepia_row(r, g, b, 272.0f, 534.0f, 131.0f);
        n = 3;
        break;
      }
      case PW_GRAY2RGB:
        v[1] = v[0];
        v[2] = v[0];
        n = 3;
        break;
      default:
        // elementwise ops act identically on every channel
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (c >= n) break;
          const float x = v[c];
          float y = x;
          switch (prog.op[k]) {
            case PW_CONTRAST:
              y = pw_trunc_clip(__fadd_rn(__fmul_rn(a, __fsub_rn(x, 128.0f)), 128.0f));
              break;
            case PW_BRIGHTNESS:
              y = pw_trunc_clip(__fadd_rn(x, a));
              break;
            case PW_INVERT:
              y = __fsub_rn(255.0f, x);
              break;
            case PW_THRESHOLD:
              y = x >= a ? 255.0f : 0.0f;
              break;
            case PW_POSTERIZE:
              y = __fmul_rn(floorf(__fdiv_rn(x, a)), a);
              break;
            case PW_SOLARIZE:
              y = x >= a ? __fsub_rn(255.0f, x) : x;
              break;
            default:
              break;
          }
          v[c] = y;
        }
        break;
    }
  }
  return n;
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
