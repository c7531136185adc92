// K1's body: a pointwise chain over an interleaved HWC u8 image, sixteen
// pixels a thread. Launched by the pointwise group kernel (pointwise.cu)
// and by the fused plan-stage megakernel for a stage with no stencil
// (fused_stage.cu).
//
// Each thread of the body takes a run of PW_RUN = 16 pixels: its output
// span (16 or 48 bytes) is whole 16-byte words, and so is its input span
// when the input is aligned as the output is. Gray -> RGB is one uint4
// load and three uint4 stores, a 3 -> 1 chain three loads and one store,
// 1 -> 1 one and one. The channels are de-interleaved in registers and the
// chain applied once per op for the sixteen pixels, each op read from the
// table in device memory through the read-only cache (no shared memory and
// no barrier, so a block's loads start at once), then interleaved again in
// registers. The output is a fresh allocation, so
// the body starts at the first pixel whose output is 16-byte aligned; the
// input of every run then starts at the same offset `in_shift` past a
// 16-byte boundary (shard views and flushed regions start at any byte):
// 0 takes uint4 loads, anything else 4-byte loads from the word below and
// a funnel shift by the byte offset. The misaligned head (under 16 pixels)
// and the ragged tail (under 16) run one pixel a thread, in threads after
// the body's. The grid follows the work: one thread per run.

#pragma once

#include <stdint.h>

#include "pointwise.cuh"

#define PW_THREADS 256
#define PW_RUN 16

// A launch's pixels: [0, head) and [head + PW_RUN * runs, n_pix) one a
// thread, the body in `runs` runs from `head`; every run's input starts
// `in_shift` bytes past a 16-byte boundary.
struct PwSplit {
  long long head;
  long long runs;
  long long tail;
  int in_shift;
};

__host__ __device__ inline PwSplit pw_split(uintptr_t in, uintptr_t out, long long n_pix,
                                            int c_in, int c_out) {
  PwSplit s;
  long long head = 0;
  while (head < PW_RUN && ((out + (uintptr_t)(head * c_out)) & 15)) ++head;
  if (head > n_pix) head = n_pix;
  s.head = head;
  s.runs = (n_pix - head) / PW_RUN;
  s.tail = n_pix - head - s.runs * PW_RUN;
  s.in_shift = (int)((in + (uintptr_t)(head * c_in)) & 15);
  return s;
}

template <int CI, int CO>
__global__ void __launch_bounds__(PW_THREADS)
pw_run_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
              const PwOp* __restrict__ chain, int n_ops, const PwSplit sp) {
  const long long t = (long long)blockIdx.x * PW_THREADS + threadIdx.x;
  if (t >= sp.runs) {
    // the head and the tail, one pixel a thread
    long long e = t - sp.runs;
    long long p;
    if (e < sp.head) {
      p = e;
    } else if (e - sp.head < sp.tail) {
      p = sp.head + sp.runs * PW_RUN + (e - sp.head);
    } else {
      return;
    }
    float v[1][3];
    pw_load(in + p * CI, v[0], CI);
    pw_apply_ldg<1>(chain, n_ops, v, CI);
#pragma unroll
    for (int c = 0; c < CO; ++c) out[p * CO + c] = pw_to_u8(v[0][c]);
    return;
  }
  const long long p0 = sp.head + t * PW_RUN;
  const unsigned char* src = in + p0 * CI;
  uint32_t w[4 * CI];
  if (sp.in_shift == 0) {
#pragma unroll
    for (int k = 0; k < CI; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + k);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
  } else {
    // the words from the one at or below the span, shifted down by the
    // span's byte offset in it (the word past the span only when the span
    // ends inside it)
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>((uintptr_t)src & ~(uintptr_t)3);
    const unsigned sh = 8u * (unsigned)((uintptr_t)src & 3);
    uint32_t x[4 * CI + 1];
#pragma unroll
    for (int k = 0; k < 4 * CI; ++k) x[k] = __ldg(s4 + k);
    x[4 * CI] = sh ? __ldg(s4 + 4 * CI) : 0u;
#pragma unroll
    for (int k = 0; k < 4 * CI; ++k) w[k] = __funnelshift_r(x[k], x[k + 1], sh);
  }
  float v[PW_RUN][3];
#pragma unroll
  for (int j = 0; j < PW_RUN; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int b = j * CI + c;
      v[j][c] = c < CI ? (float)((w[b >> 2] >> (8 * (b & 3))) & 0xFFu) : 0.0f;
    }
  }
  pw_apply_ldg<PW_RUN>(chain, n_ops, v, CI);
  uint32_t o[4 * CO];
#pragma unroll
  for (int k = 0; k < 4 * CO; ++k) o[k] = 0u;
#pragma unroll
  for (int j = 0; j < PW_RUN; ++j) {
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int b = j * CO + c;
      o[b >> 2] |= (uint32_t)pw_to_u8(v[j][c]) << (8 * (b & 3));
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + p0 * CO);
#pragma unroll
  for (int k = 0; k < CO; ++k) dst[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
}

// Launches the body on `stream` over `n_pix` pixels with the chain table
// `chain` (n_ops PwOp in device memory). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for channel counts it has no
// instance of.
static int pw_run_launch(const unsigned char* in, unsigned char* out, long long n_pix, int c_in,
                         int c_out, const PwOp* chain, int n_ops, cudaStream_t stream) {
  if (n_pix <= 0) return 0;
  if (n_ops < 0 || (n_ops > 0 && chain == nullptr)) return (int)cudaErrorInvalidValue;
  const PwSplit sp = pw_split((uintptr_t)in, (uintptr_t)out, n_pix, c_in, c_out);
  const long long threads = sp.runs + sp.head + sp.tail;
  const unsigned blocks = (unsigned)((threads + PW_THREADS - 1) / PW_THREADS);
#define PW_CASE(CI, CO)                                                                 \
  if (c_in == CI && c_out == CO) {                                                      \
    pw_run_kernel<CI, CO><<<blocks, PW_THREADS, 0, stream>>>(in, out, chain, n_ops, sp); \
    return (int)cudaGetLastError();                                                     \
  }
  PW_CASE(1, 1)
  PW_CASE(1, 3)
  PW_CASE(3, 1)
  PW_CASE(3, 3)
#undef PW_CASE
  return (int)cudaErrorInvalidValue;
}
