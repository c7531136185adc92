// T2: a pointwise chain on packed words, four u8 pixels per 32-bit element.
//
// Replaces: tools/packed_proto.py
//           packed_gray_contrast (:141; kernel packed_gray_contrast_kernel
//           :117, pallas_call :148).
// Computes: three (H, Wp) int32 planes R, G, B, byte k (little-endian) of
//           word j = column 4j + k of the u8 plane (pack_u8 :49), into one
//           such plane: per pixel the pointwise chain of the program it is
//           given, which the wrapper sets to the golden `grayscale` then
//           `contrast:3.5` (3 channels in, 1 out). The chain is
//           pointwise.cuh's: the same IEEE float32 steps as K1, rintf,
//           clips, so each byte equals the golden op's.
// Bound on the H100: device memory. Each pixel moves 3 bytes in and 1 out
//           and costs a few tens of float32 operations: an 8K frame
//           (33.18 MP, 132.7 MB) cannot take less than 39.6 us at
//           3.35 TB/s; its operations need under 10 us at 67 TFLOP/s.
// Design:   the TPU kernel unpacks lanes with i32 shifts and masks because
//           Mosaic had no u8 loads; here each thread loads word j of each
//           plane (one coalesced 4-byte load per plane), splits the four
//           bytes, runs the chain on each pixel and packs the four results
//           into one word. Blocks take `block_h` rows (the TPU block
//           height) of 256 words each; the last block may be ragged.

#include <stdint.h>

#include "pointwise.cuh"

#define PP_THREADS 256

__global__ void __launch_bounds__(PP_THREADS)
packed_pointwise_kernel(const uint32_t* __restrict__ r, const uint32_t* __restrict__ g,
                        const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int H,
                        int Wp, int block_h, const __grid_constant__ PwProgram prog) {
  const int j = blockIdx.x * PP_THREADS + threadIdx.x;
  if (j >= Wp) return;
  const int y0 = blockIdx.y * block_h;
  const int y1 = min(y0 + block_h, H);
  for (int y = y0; y < y1; ++y) {
    const long long o = (long long)y * Wp + j;
    const uint32_t wr = r[o], wg = g[o], wb = b[o];
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[3] = {(float)((wr >> (8 * k)) & 0xFFu), (float)((wg >> (8 * k)) & 0xFFu),
                    (float)((wb >> (8 * k)) & 0xFFu)};
      pw_apply(prog, v, 3);
      word |= (uint32_t)pw_to_u8(v[0]) << (8 * k);
    }
    out[o] = word;
  }
}

// Runs `prog` (3 channels in, 1 out) over three packed (H, Wp) planes on
// `stream`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int packed_pointwise_launch(const unsigned int* r, const unsigned int* g,
                                       const unsigned int* b, unsigned int* out, int H, int Wp,
                                       int block_h, const PwProgram* prog, void* stream) {
  if (H <= 0 || Wp <= 0) return 0;
  if (block_h < 1 || prog->n_ops < 0 || prog->n_ops > PW_MAX_OPS) return (int)cudaErrorInvalidValue;
  const dim3 grid((Wp + PP_THREADS - 1) / PP_THREADS, (H + block_h - 1) / block_h);
  packed_pointwise_kernel<<<grid, PP_THREADS, 0, (cudaStream_t)stream>>>(r, g, b, out, H, Wp,
                                                                         block_h, *prog);
  return (int)cudaGetLastError();
}
