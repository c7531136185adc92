// T2: a pointwise chain on packed words, four u8 pixels per 32-bit element.
//
// Replaces: tools/packed_proto.py
//           packed_gray_contrast (:141; kernel packed_gray_contrast_kernel
//           :117, pallas_call :148).
// Computes: three (H, Wp) int32 planes R, G, B, byte k (little-endian) of
//           word j = column 4j + k of the u8 plane (pack_u8 :49), into one
//           such plane: per pixel the pointwise chain of the table it is
//           given, which the wrapper sets to the golden `grayscale` then
//           `contrast:3.5` (3 channels in, 1 out; tools/packed_proto.py
//           t2_program). The chain is pointwise.cuh's: the same IEEE
//           float32 steps as K1, rintf, clips, so each byte equals the
//           golden op's.
// Bound on the H100: device memory. Each pixel moves 3 bytes in and 1 out
//           and costs a few tens of float32 operations: an 8K frame
//           (33.18 MP, 132.7 MB) cannot take less than 39.6 us at
//           3.35 TB/s; its operations need under 10 us at 67 TFLOP/s.
// Design:   the TPU kernel unpacks lanes with i32 shifts and masks because
//           Mosaic had no u8 loads. The first design here took blocks of
//           block_h rows x 256 words, each thread walking its rows one
//           word per plane at a time with the chain interpreted per pixel
//           from a by-value program: latency-bound, at 17% of the bytes
//           bound at 8K. This one is the planar body of packed_run.cuh
//           (shared with T1-pw): a flat walk over the H * Wp words, sixteen
//           pixels a thread as one uint4 load per plane and one uint4
//           store, the chain table read through the read-only cache and
//           applied once per op for the sixteen, the misaligned head and
//           ragged tail one word a thread. The TPU block height `block_h`
//           sets nothing here; the wrapper checks it and passes none.

#include "device_scope.cuh"
#include "packed_run.cuh"

// Runs the chain table `chain` (n_ops PwOp in device memory, 3 channels in,
// 1 out) over three packed (H, Wp) planes on `device` and `stream`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int packed_pointwise_launch(const unsigned int* r, const unsigned int* g,
                                       const unsigned int* b, unsigned int* out, int H, int Wp,
                                       const PwOp* chain, int n_ops, int device, void* stream) {
  if (H <= 0 || Wp <= 0) return 0;
  if (device < 0) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  PrPlanes pl = {{r, g, b}, {out, nullptr, nullptr}};
  return pr_launch<3, 1>(pl, (long long)H * Wp, chain, n_ops, (cudaStream_t)stream);
}
