// K1: the pointwise group kernel.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           _pointwise_kernel (the pallas_call in run_group for groups
//           with no stencil).
// Computes: a chain of pointwise ops (pointwise.cuh) over an interleaved
//           HWC u8 image with c_in channels, writing an interleaved u8
//           image with c_out channels. One read and one write per pixel.
// Bound on the H100: device memory. Each pixel moves (c_in + c_out) bytes
//           and costs at most a few tens of float32 operations, far below
//           the card's operations-per-byte balance; at 3.35 TB/s an 8K
//           gray -> RGB pass (4 B/px) takes at least 39.6 us.
// Design:   a grid-stride loop, one pixel per thread per step, reading
//           the HWC layout in place (the TPU kernel's planar split was for
//           its (8, 128) lanes and would cost extra copies here). No
//           shared memory, no synchronisation.

#include "pointwise.cuh"

__global__ void __launch_bounds__(256)
pointwise_kernel(const unsigned char* __restrict__ in,
                 unsigned char* __restrict__ out, long long n_pix, int c_in,
                 int c_out, const __grid_constant__ PwProgram prog) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_pix;
       i += stride) {
    float v[3];
    pw_load(in + i * c_in, v, c_in);
    pw_apply(prog, v, c_in);
    unsigned char* q = out + i * c_out;
    q[0] = pw_to_u8(v[0]);
    if (c_out > 1) {
      q[1] = pw_to_u8(v[1]);
      q[2] = pw_to_u8(v[2]);
    }
  }
}

// Launches K1 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int pointwise_launch(const unsigned char* in, unsigned char* out,
                                long long n_pix, int c_in, int c_out,
                                const PwProgram* prog, void* stream) {
  if (n_pix <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_pix + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  pointwise_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, n_pix, c_in, c_out, *prog);
  return (int)cudaGetLastError();
}
