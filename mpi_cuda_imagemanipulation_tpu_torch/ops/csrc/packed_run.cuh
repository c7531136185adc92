// The planar pointwise body of T2 (packed_proto.cu) and T1-pw
// (packed_stream.cu): a pointwise chain over n_in int32 word planes into
// n_out word planes, four u8 pixels a word (byte k of word j = column
// 4j + k), sixteen pixels a thread.
//
// The planes are contiguous runs of n words (an (H, Wp) plane has H * Wp),
// walked flat. Thread t of the body takes words [head + 4t, head + 4t + 4)
// of every plane: one uint4 load per input plane, one uint4 store per
// output plane. The outputs are fresh allocations that share their
// alignment, so the body starts at the first word whose output is 16-byte
// aligned; input plane c then starts every run `shift[c]` words past a
// 16-byte boundary (a row slice of a larger plane starts at any word): 0
// takes one uint4 load, anything else the two aligned uint4 around the run
// and a select by the shift, which is uniform over the launch. The
// misaligned head (under 4 words) and the ragged tail (under 4) run one
// word a thread, in threads after the body's. The chain runs once per op
// for the sixteen pixels (pw_apply_ldg: each op read from the table in
// device memory through the read-only cache), so there is no shared memory
// and no barrier. Bytes become floats and floats bytes by adds through the
// mantissa of 2^23, not by conversion instructions, which run at a quarter
// of the float rate. The grid follows the work: one thread per run.

#pragma once

#include <stdint.h>

#include "pointwise.cuh"

#define PR_THREADS 256
#define PR_RUN_WORDS 4  // words a plane per body thread: 16 pixels
#define PR_MAX_PLANES 3

// Byte b of w as a float: the byte as the low mantissa bits of 2^23, less
// 2^23 (exact; an add where a conversion instruction runs at a quarter of
// the float rate).
__device__ __forceinline__ float pr_byte_f(uint32_t w, int b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((w >> (8 * b)) & 0xFFu)), 8388608.0f);
}

// The u8 of a float that holds an integer (every chain step and stencil
// finish leaves one), clipped to [0, 255] first: the low byte of its sum
// with 2^23, pw_to_u8's value without its conversion.
__device__ __forceinline__ uint32_t pr_f_byte(float x) {
  return __float_as_uint(__fadd_rn(pw_clip(x), 8388608.0f)) & 0xFFu;
}

struct PrPlanes {
  const uint32_t* in[PR_MAX_PLANES];
  uint32_t* out[PR_MAX_PLANES];
};

// A launch's words: [0, head) and [head + PR_RUN_WORDS * runs, n) one a
// thread, the body in `runs` runs from `head`; input plane c's runs start
// shift[c] words past a 16-byte boundary.
struct PrSplit {
  long long head;
  long long runs;
  long long tail;
  int shift[PR_MAX_PLANES];
};

__host__ __device__ inline PrSplit pr_split(const uintptr_t* in, int n_in, uintptr_t out,
                                            long long n) {
  PrSplit s;
  long long head = 0;
  while (head < PR_RUN_WORDS && ((out + 4 * (uintptr_t)head) & 15)) ++head;
  if (head > n) head = n;
  s.head = head;
  s.runs = (n - head) / PR_RUN_WORDS;
  s.tail = n - head - s.runs * PR_RUN_WORDS;
  for (int c = 0; c < PR_MAX_PLANES; ++c) {
    s.shift[c] = c < n_in ? (int)(((in[c] + 4 * (uintptr_t)head) & 15) >> 2) : 0;
  }
  return s;
}

template <int CI, int CO>
__global__ void __launch_bounds__(PR_THREADS)
pr_run_kernel(const PrPlanes pl, const PwOp* __restrict__ chain, int n_ops, const PrSplit sp) {
  const long long t = (long long)blockIdx.x * PR_THREADS + threadIdx.x;
  if (t >= sp.runs) {
    // the head and the tail, one word (four pixels) a thread
    const long long e = t - sp.runs;
    long long p;
    if (e < sp.head) {
      p = e;
    } else if (e - sp.head < sp.tail) {
      p = sp.head + sp.runs * PR_RUN_WORDS + (e - sp.head);
    } else {
      return;
    }
    float v[4][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t w = c < CI ? __ldg(pl.in[c] + p) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j][c] = pr_byte_f(w, j);
    }
    pw_apply_ldg<4>(chain, n_ops, v, CI);
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      uint32_t w = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= pr_f_byte(v[j][c]) << (8 * j);
      pl.out[c][p] = w;
    }
    return;
  }
  const long long p0 = sp.head + t * PR_RUN_WORDS;
  uint32_t w[CI][4];
#pragma unroll
  for (int c = 0; c < CI; ++c) {
    const int s = sp.shift[c];
    if (s == 0) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(pl.in[c] + p0));
      w[c][0] = q.x;
      w[c][1] = q.y;
      w[c][2] = q.z;
      w[c][3] = q.w;
    } else {
      // the aligned uint4 at or below the run and the next one, the run's
      // four words selected from their eight
      const uint4* a4 = reinterpret_cast<const uint4*>(pl.in[c] + p0 - s);
      const uint4 a = __ldg(a4), b = __ldg(a4 + 1);
      const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) w[c][k] = s == 1 ? x[k + 1] : s == 2 ? x[k + 2] : x[k + 3];
    }
  }
  float v[4 * PR_RUN_WORDS][3];
#pragma unroll
  for (int j = 0; j < 4 * PR_RUN_WORDS; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[j][c] = c < CI ? pr_byte_f(w[c < CI ? c : 0][j >> 2], j & 3) : 0.0f;
    }
  }
  pw_apply_ldg<4 * PR_RUN_WORDS>(chain, n_ops, v, CI);
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    uint32_t o[PR_RUN_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4 * PR_RUN_WORDS; ++j) {
      o[j >> 2] |= pr_f_byte(v[j][c]) << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(pl.out[c] + p0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Whether a launch takes these planes: every pointer 4-byte aligned and
// set, the outputs at one alignment modulo 16 bytes.
static bool pr_planes_ok(const PrPlanes& pl, int n_in, int n_out) {
  for (int c = 0; c < n_in; ++c) {
    if (pl.in[c] == nullptr || ((uintptr_t)pl.in[c] & 3)) return false;
  }
  for (int c = 0; c < n_out; ++c) {
    if (pl.out[c] == nullptr || ((uintptr_t)pl.out[c] & 3) ||
        (((uintptr_t)pl.out[c] ^ (uintptr_t)pl.out[0]) & 15)) {
      return false;
    }
  }
  return true;
}

// Launches the body on `stream` over `n` words of each plane with the
// chain table `chain` (n_ops PwOp in device memory, CI channels in, CO
// out). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for planes it does not take.
template <int CI, int CO>
static int pr_launch(const PrPlanes& pl, long long n, const PwOp* chain, int n_ops,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_ops < 0 || (n_ops > 0 && chain == nullptr) || !pr_planes_ok(pl, CI, CO)) {
    return (int)cudaErrorInvalidValue;
  }
  uintptr_t in[PR_MAX_PLANES] = {0, 0, 0};
  for (int c = 0; c < CI; ++c) in[c] = (uintptr_t)pl.in[c];
  const PrSplit sp = pr_split(in, CI, (uintptr_t)pl.out[0], n);
  const long long threads = sp.runs + sp.head + sp.tail;
  const unsigned blocks = (unsigned)((threads + PR_THREADS - 1) / PR_THREADS);
  pr_run_kernel<CI, CO><<<blocks, PR_THREADS, 0, stream>>>(pl, chain, n_ops, sp);
  return (int)cudaGetLastError();
}
