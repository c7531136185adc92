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
// Design:   the first design gave each CTA block_h rows of one 4 KB
//           column chunk, one 16-byte vector per thread and row: 68 CTAs
//           for 132 SMs on the 8K gray plane at block height 128, one load
//           in flight per thread, 1.11-1.54x `copy_`'s device time. Here
//           block_h stays the rows of one unit of work (the TPU's grid
//           step) and no longer sets the CTA:
//           - the copies (`copy_tiled_kernel`, one template over 16-byte
//             vectors where the row pitch is a multiple of 16 bytes, else
//             over elements) cut each unit into CTAs of CP_CTA_ROWS rows
//             by CP_LANES vectors: each warp covers 32 neighbouring
//             vectors of a row (512 contiguous bytes), each thread loads
//             CP_ROWS_PER_THREAD rows, all its loads issued before its
//             stores. The 8K u8 plane gets 15 x 135-144 CTAs at every
//             swept block height, some 15 per SM;
//           - the shared-memory copy moves each unit's bytes (contiguous:
//             whole rows) with the Tensor Memory Accelerator: one thread
//             per CTA issues `cp.async.bulk` loads of CP_STAGE_BYTES into
//             two shared-memory buffers, each completing on its own
//             `mbarrier`, and `cp.async.bulk` stores from the buffer that
//             has arrived while the other one loads; CTAs of
//             CP_BULK_CTA_BYTES of a unit each.
//           The TPU's scratch carry has no counterpart here (blocks run in
//           parallel, in no order): the shared-memory copy stands in for
//           the lagged copy. The bitcasts give each thread four
//           neighbouring columns of four rows: four 4-byte loads, a 4 x 4
//           byte transpose in registers (__byte_perm), one 16-byte store,
//           and the reverse for the load side; the last block is ragged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

#define CP_THREADS 256
#define CP_VEC 16                 // bytes per vector access
#define CP_LANES 32               // vectors (or elements) of a row per CTA
#define CP_ROWS_PER_THREAD 4      // loads in flight per thread before its stores
#define CP_CTA_ROWS (CP_THREADS / CP_LANES * CP_ROWS_PER_THREAD)  // 32 rows per CTA
#define CP_STAGE_BYTES 16384      // one bulk copy of the shared-memory copy
#define CP_BULK_CTA_BYTES 65536   // bytes of a unit per shared-memory-copy CTA
#define CP_BULK_THREADS 32

enum CpType { CP_U8 = 0, CP_F32 = 1, CP_U32 = 2 };

// CTA (blockIdx.x, blockIdx.y) of the copies: column units
// [32 blockIdx.x, +32) of rows [y0, y1): block_h-row unit blockIdx.y /
// ctas_per_unit, its CTA blockIdx.y % ctas_per_unit of CP_CTA_ROWS rows.
template <typename T>
__global__ void __launch_bounds__(CP_THREADS)
copy_tiled_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int row_units,
                  int block_h, int ctas_per_unit) {
  const int c = blockIdx.x * CP_LANES + (threadIdx.x & (CP_LANES - 1));
  if (c >= row_units) return;
  const int unit = blockIdx.y / ctas_per_unit;
  const int u0 = unit * block_h;
  const int y0 = u0 + (blockIdx.y - unit * ctas_per_unit) * CP_CTA_ROWS +
                 threadIdx.x / CP_LANES;
  const int y1 = min(u0 + block_h, H);
  constexpr int step = CP_THREADS / CP_LANES;
  T v[CP_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < CP_ROWS_PER_THREAD; ++i) {
    const int y = y0 + step * i;
    if (y < y1) v[i] = in[(long long)y * row_units + c];
  }
#pragma unroll
  for (int i = 0; i < CP_ROWS_PER_THREAD; ++i) {
    const int y = y0 + step * i;
    if (y < y1) out[(long long)y * row_units + c] = v[i];
  }
}

__device__ __forceinline__ unsigned cp_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A u8 plane's rows as contiguous bytes, each block_h-row unit split into
// CTAs of CP_BULK_CTA_BYTES; thread 0 of each CTA streams its range
// through two CP_STAGE_BYTES buffers with bulk copies: the load of stage
// s + 1 is in flight while stage s is stored.
__global__ void __launch_bounds__(CP_BULK_THREADS)
smem_copy_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
                 long long unit_bytes, long long total_bytes, int ctas_per_unit) {
  __shared__ __align__(128) unsigned char stage[2][CP_STAGE_BYTES];
  __shared__ __align__(8) unsigned long long bar[2];
  if (threadIdx.x != 0) return;
  const int unit = blockIdx.x / ctas_per_unit;
  const long long u0 = (long long)unit * unit_bytes;
  const long long b0 = u0 + (long long)(blockIdx.x - unit * ctas_per_unit) * CP_BULK_CTA_BYTES;
  const long long b1 = min(min(u0 + unit_bytes, b0 + CP_BULK_CTA_BYTES), total_bytes);
  if (b0 >= b1) return;
  const unsigned bars[2] = {cp_smem_addr(&bar[0]), cp_smem_addr(&bar[1])};
  const unsigned bufs[2] = {cp_smem_addr(stage[0]), cp_smem_addr(stage[1])};
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars[0]));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars[1]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int n = (int)((b1 - b0 + CP_STAGE_BYTES - 1) / CP_STAGE_BYTES);
  auto load = [&](int s) {
    const long long off = b0 + (long long)s * CP_STAGE_BYTES;
    const unsigned bytes = (unsigned)min((long long)CP_STAGE_BYTES, b1 - off);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bars[s & 1]), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(bufs[s & 1]), "l"(in + off), "r"(bytes), "r"(bars[s & 1])
        : "memory");
  };
  load(0);
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) {
      // the store of stage s - 1 must have read the buffer stage s + 1 takes
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(s + 1);
    }
    cp_mbar_wait(bars[s & 1], (unsigned)(s >> 1) & 1u);
    const long long off = b0 + (long long)s * CP_STAGE_BYTES;
    const unsigned bytes = (unsigned)min((long long)CP_STAGE_BYTES, b1 - off);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(out + off), "r"(bufs[s & 1]), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The copies' grid: column chunks of CP_LANES units, then per block_h-row
// unit ceil(block_h / CP_CTA_ROWS) CTAs.
static dim3 cp_copy_grid(int row_units, int H, int block_h, int* ctas_per_unit) {
  *ctas_per_unit = (block_h + CP_CTA_ROWS - 1) / CP_CTA_ROWS;
  const int n_units = (H + block_h - 1) / block_h;
  return dim3((row_units + CP_LANES - 1) / CP_LANES, n_units * *ctas_per_unit);
}

template <typename T>
static void cp_launch_tiled(const void* in, void* out, int H, int row_units, int block_h,
                            cudaStream_t s) {
  int per_unit = 0;
  const dim3 grid = cp_copy_grid(row_units, H, block_h, &per_unit);
  copy_tiled_kernel<T><<<grid, CP_THREADS, 0, s>>>((const T*)in, (T*)out, H, row_units,
                                                   block_h, per_unit);
}

// Copies an (H, W) array of `dtype` (CpType) in units of `block_h` rows on
// `stream` of `device`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int copy_probe_launch(const void* in, void* out, int H, int W, int dtype,
                                 int block_h, int device, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (block_h < 1 || dtype < CP_U8 || dtype > CP_U32) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)W * (dtype == CP_U8 ? 1 : 4);
  const bool aligned = ((uintptr_t)in % CP_VEC) == 0 && ((uintptr_t)out % CP_VEC) == 0;
  if (row_bytes % CP_VEC == 0 && aligned) {
    cp_launch_tiled<uint4>(in, out, H, (int)(row_bytes / CP_VEC), block_h, s);
  } else if (dtype == CP_U8) {
    cp_launch_tiled<unsigned char>(in, out, H, W, block_h, s);
  } else if (dtype == CP_F32) {
    cp_launch_tiled<float>(in, out, H, W, block_h, s);
  } else {
    cp_launch_tiled<uint32_t>(in, out, H, W, block_h, s);
  }
  return (int)cudaGetLastError();
}

// Copies an (H, W) u8 plane, W a multiple of 16 and both pointers 16-byte
// aligned, through shared memory with bulk copies, in units of block_h rows.
extern "C" int smem_copy_launch(const unsigned char* in, unsigned char* out, int H, int W,
                                int block_h, int device, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (block_h < 1 || W % CP_VEC || (uintptr_t)in % CP_VEC || (uintptr_t)out % CP_VEC) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const long long unit_bytes = (long long)block_h * W;
  const int per_unit = (int)((unit_bytes + CP_BULK_CTA_BYTES - 1) / CP_BULK_CTA_BYTES);
  const long long n_units = (H + block_h - 1) / block_h;
  smem_copy_kernel<<<(unsigned)(n_units * per_unit), CP_BULK_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, unit_bytes, (long long)H * W, per_unit);
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
