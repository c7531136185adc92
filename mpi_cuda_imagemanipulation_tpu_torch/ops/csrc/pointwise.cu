// K1: the pointwise group kernel.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           _pointwise_kernel (the pallas_call in run_group for groups
//           with no stencil).
// Computes: a chain of pointwise ops (pointwise.cuh), a table of any
//           length, over an interleaved HWC u8 image with c_in channels,
//           writing an interleaved u8 image with c_out channels. One read
//           and one write per pixel.
// Bound on the H100: device memory. Each pixel moves (c_in + c_out) bytes
//           and costs at most a few tens of float32 operations, far below
//           the card's operations-per-byte balance; at 3.35 TB/s an 8K
//           gray -> RGB pass (4 B/px) takes at least 39.6 us.
// Design:   the first design (a grid-stride loop capped at 132 x 16
//           blocks, one pixel a thread a step, c_in one-byte loads and
//           c_out one-byte stores at stride c_out, the chain dispatched per
//           pixel) ran the 8K gray -> RGB pass at 34% of its bytes bound
//           where a copy of the plane reaches 84%. This one is K1's body in
//           pointwise_run.cuh: sixteen pixels a thread as whole 16-byte
//           words in and out, de-interleaved in registers, each chain op
//           dispatched once for the sixteen, the misaligned head and the
//           ragged tail one pixel a thread, the grid sized from the work.

#include "device_scope.cuh"
#include "pointwise_run.cuh"

// Launches K1 on `device` and `stream` with the chain table `chain`
// (n_ops PwOp in device memory). Returns cudaGetLastError() after the
// launch.
extern "C" int pointwise_launch(const unsigned char* in, unsigned char* out, long long n_pix,
                                int c_in, int c_out, const PwOp* chain, int n_ops, int device,
                                void* stream) {
  if (n_pix <= 0) return 0;
  if (device < 0) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  return pw_run_launch(in, out, n_pix, c_in, c_out, chain, n_ops, (cudaStream_t)stream);
}

// The split of one launch (pw_split), for the host-side check: head, runs,
// tail and the input shift in `split[0..3]`.
extern "C" void pointwise_split(unsigned long long in, unsigned long long out, long long n_pix,
                                int c_in, int c_out, long long* split) {
  const PwSplit s = pw_split((uintptr_t)in, (uintptr_t)out, n_pix, c_in, c_out);
  split[0] = s.head;
  split[1] = s.runs;
  split[2] = s.tail;
  split[3] = s.in_shift;
}
