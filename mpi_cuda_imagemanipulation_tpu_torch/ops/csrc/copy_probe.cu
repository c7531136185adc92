// T4: the copy-rate probe's kernels. Four streaming copies of a plane, each
// a kernel of its own with a plain C entry point.
//
// Replaces: tools/roofline_probe.py
//           copy_call (pallas_call :94): a row-blocked streaming copy of a
//               (H, W) u8, f32 or u32 array, block_h rows per grid step;
//           lagged_copy_call (:170): the same copy lagged one block
//               through a scratch carry;
//           bitcast_store_call (:221): u8 rows in, u32 words out,
//               pltpu.bitcast along the second-minor axis;
//           bitcast_load_call (:236): its inverse.
// Computes: copies that move the array's bytes unchanged, and the sublane
//           bitcast pair: byte k (little-endian) of word (i, j) is u8 row
//           4i + k, column j (jax/_src/pallas/mosaic/primitives.py reshapes
//           (m, n) to (m/4, 4, n) and swaps the last two axes), so a u32
//           array of shape (H/4, W) holds a (H, W) u8 plane.
// Bound on the H100: device memory, by construction: each kernel reads
//           every input byte once and writes every output byte once and
//           computes nothing else. An 8K gray plane (33.18 MB) read and
//           written cannot take less than 19.8 us at 3.35 TB/s, the f32
//           plane 79.2 us. The probe measures how near the card comes.
// Design:   `copy_tiled` gives each block `block_h` rows of one column
//           chunk (256 threads x 16 bytes), the TPU block's counterpart;
//           each thread copies 16-byte vectors down its column where the
//           row pitch is a multiple of 16 bytes, else one element of the
//           type at a time. The TPU's scratch carry has no counterpart
//           here (blocks run in parallel, in no order): `smem_copy`
//           stands in for the lagged copy by staging each block through
//           shared memory with cp.async, eight rows of the chunk at a time,
//           then storing from there. The bitcasts give each thread four
//           neighbouring columns of four rows: four 4-byte loads, a 4 x 4
//           byte transpose in registers (__byte_perm), one 16-byte store,
//           and the reverse for the load side; the last block is ragged.

#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 256
#define CP_VEC 16                          // bytes per vector access
#define CP_CHUNK (CP_THREADS * CP_VEC)     // bytes of one block's column chunk
#define CP_STAGE_ROWS 8                    // rows staged at once by smem_copy

enum CpType { CP_U8 = 0, CP_F32 = 1, CP_U32 = 2 };

// Rows [y0, y1) of a chunk of 16-byte vectors: vector `c` of every row.
__global__ void __launch_bounds__(CP_THREADS)
copy_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int H,
                int row_vecs, int block_h) {
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  if (c >= row_vecs) return;
  const int y0 = blockIdx.y * block_h;
  const int y1 = min(y0 + block_h, H);
#pragma unroll 4
  for (int y = y0; y < y1; ++y) {
    out[(long long)y * row_vecs + c] = in[(long long)y * row_vecs + c];
  }
}

// The same over elements of T, for a row pitch that is no multiple of 16.
template <typename T>
__global__ void __launch_bounds__(CP_THREADS)
copy_elem_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W,
                 int block_h) {
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  if (c >= W) return;
  const int y0 = blockIdx.y * block_h;
  const int y1 = min(y0 + block_h, H);
#pragma unroll 4
  for (int y = y0; y < y1; ++y) out[(long long)y * W + c] = in[(long long)y * W + c];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// A u8 plane with a row pitch that is a multiple of 16 bytes, each block's
// rows staged through shared memory: cp.async of CP_STAGE_ROWS rows of the
// chunk, wait, barrier, store from shared memory, barrier.
__global__ void __launch_bounds__(CP_THREADS)
smem_copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int H,
                 int row_vecs, int block_h) {
  __shared__ __align__(16) uint4 stage[CP_STAGE_ROWS][CP_THREADS];
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  const bool live = c < row_vecs;
  const int y0 = blockIdx.y * block_h;
  const int y1 = min(y0 + block_h, H);
  for (int y = y0; y < y1; y += CP_STAGE_ROWS) {
    const int n = min(CP_STAGE_ROWS, y1 - y);
    if (live) {
      for (int r = 0; r < n; ++r) cp_async16(&stage[r][threadIdx.x], in + (long long)(y + r) * row_vecs + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (live) {
      for (int r = 0; r < n; ++r) out[(long long)(y + r) * row_vecs + c] = stage[r][threadIdx.x];
    }
    __syncthreads();
  }
}

// 4 x 4 byte transpose: a[k] holds four bytes j = 0..3 of row k; returns
// in b[j] the four bytes k = 0..3 of column j. Its own inverse.
__device__ __forceinline__ void transpose4x4(const uint32_t a[4], uint32_t b[4]) {
  const uint32_t t01 = __byte_perm(a[0], a[1], 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t t23 = __byte_perm(a[2], a[3], 0x5140);  // a2.0 a3.0 a2.1 a3.1
  const uint32_t u01 = __byte_perm(a[0], a[1], 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t u23 = __byte_perm(a[2], a[3], 0x7362);  // a2.2 a3.2 a2.3 a3.3
  b[0] = __byte_perm(t01, t23, 0x5410);
  b[1] = __byte_perm(t01, t23, 0x7632);
  b[2] = __byte_perm(u01, u23, 0x5410);
  b[3] = __byte_perm(u01, u23, 0x7632);
}

// u8 (H, W) -> u32 (H / 4, W): thread `q` takes columns 4q .. 4q + 3 of u8
// rows 4i .. 4i + 3 for every word row i of its block (block_h u8 rows).
__global__ void __launch_bounds__(CP_THREADS)
bitcast_store_kernel(const uint32_t* __restrict__ in, uint4* __restrict__ out, int Hw,
                     int quads, int block_h) {
  const int q = blockIdx.x * CP_THREADS + threadIdx.x;
  if (q >= quads) return;
  const int i0 = blockIdx.y * (block_h / 4);
  const int i1 = min(i0 + block_h / 4, Hw);
  for (int i = i0; i < i1; ++i) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = in[(long long)(4 * i + k) * quads + q];
    transpose4x4(a, b);
    out[(long long)i * quads + q] = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

// u32 (Hw, W) -> u8 (4 Hw, W), the inverse; block_h word rows per block.
__global__ void __launch_bounds__(CP_THREADS)
bitcast_load_kernel(const uint4* __restrict__ in, uint32_t* __restrict__ out, int Hw,
                    int quads, int block_h) {
  const int q = blockIdx.x * CP_THREADS + threadIdx.x;
  if (q >= quads) return;
  const int i0 = blockIdx.y * block_h;
  const int i1 = min(i0 + block_h, Hw);
  for (int i = i0; i < i1; ++i) {
    const uint4 w = in[(long long)i * quads + q];
    const uint32_t a[4] = {w.x, w.y, w.z, w.w};
    uint32_t b[4];
    transpose4x4(a, b);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(long long)(4 * i + k) * quads + q] = b[k];
  }
}

static dim3 cp_grid(int units, int rows, int rows_per_block) {
  return dim3((units + CP_THREADS - 1) / CP_THREADS, (rows + rows_per_block - 1) / rows_per_block);
}

// Copies an (H, W) array of `dtype` (CpType) in blocks of `block_h` rows on
// `stream`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int copy_probe_launch(const void* in, void* out, int H, int W, int dtype,
                                 int block_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (block_h < 1 || dtype < CP_U8 || dtype > CP_U32) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)W * (dtype == CP_U8 ? 1 : 4);
  if (row_bytes % CP_VEC == 0) {
    const int row_vecs = (int)(row_bytes / CP_VEC);
    copy_vec_kernel<<<cp_grid(row_vecs, H, block_h), CP_THREADS, 0, s>>>(
        (const uint4*)in, (uint4*)out, H, row_vecs, block_h);
  } else if (dtype == CP_U8) {
    copy_elem_kernel<unsigned char><<<cp_grid(W, H, block_h), CP_THREADS, 0, s>>>(
        (const unsigned char*)in, (unsigned char*)out, H, W, block_h);
  } else if (dtype == CP_F32) {
    copy_elem_kernel<float><<<cp_grid(W, H, block_h), CP_THREADS, 0, s>>>(
        (const float*)in, (float*)out, H, W, block_h);
  } else {
    copy_elem_kernel<uint32_t><<<cp_grid(W, H, block_h), CP_THREADS, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, H, W, block_h);
  }
  return (int)cudaGetLastError();
}

// Copies an (H, W) u8 plane, W a multiple of 16, through shared memory.
extern "C" int smem_copy_launch(const unsigned char* in, unsigned char* out, int H, int W,
                                int block_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (block_h < 1 || W % CP_VEC) return (int)cudaErrorInvalidValue;
  const int row_vecs = W / CP_VEC;
  smem_copy_kernel<<<cp_grid(row_vecs, H, block_h), CP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, H, row_vecs, block_h);
  return (int)cudaGetLastError();
}

// u8 (H, W) -> u32 (H / 4, W) in blocks of block_h u8 rows; H, W and
// block_h multiples of 4.
extern "C" int bitcast_store_launch(const unsigned char* in, unsigned int* out, int H, int W,
                                    int block_h, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (H % 4 || W % 4 || block_h < 4 || block_h % 4) return (int)cudaErrorInvalidValue;
  const int quads = W / 4;
  bitcast_store_kernel<<<cp_grid(quads, H, block_h), CP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint4*)out, H / 4, quads, block_h);
  return (int)cudaGetLastError();
}

// u32 (Hw, W) -> u8 (4 Hw, W) in blocks of block_h word rows; W a multiple
// of 4.
extern "C" int bitcast_load_launch(const unsigned int* in, unsigned char* out, int Hw, int W,
                                   int block_h, void* stream) {
  if (Hw <= 0 || W <= 0) return 0;
  if (W % 4 || block_h < 1) return (int)cudaErrorInvalidValue;
  const int quads = W / 4;
  bitcast_load_kernel<<<cp_grid(quads, Hw, block_h), CP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint32_t*)out, Hw, quads, block_h);
  return (int)cudaGetLastError();
}
