// K4 and K4g: the fused plan-stage megakernel, in its full-image mode and
// in its ghost mode over one row-shard. One kernel template, two entry
// points: the VPU instantiations run every stencil on the VPU arm (the
// strip functions of stencil.cuh); the tensor-core instantiations also run
// the stencils the stage table puts on a tensor-core arm as K5
// (mma_stage.cuh). A stage launches the second kind only when one of its
// stencils has such an arm.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           _stage_kernel (launched by fused_stage_call) with every op on
//           the 'vpu' arm: with ghosts=False (K4), the route
//           plan='fused-pallas' takes for each eligible stage
//           (plan/pallas_exec.py), and with ghosts=True (K4g), the route
//           the row-sharded runner takes (run_stage_pallas_ext).
// Computes: one fused plan stage in one launch: its pointwise runs, its
//           chained stencils (total halo R <= 16, any number of ops and
//           stencils), each stencil's own edge extension applied to that
//           stencil's input (reflect101 mirrors, edge clamps, interior and
//           zero write 0), the interior-mode passthrough at global
//           coordinates, scale and quantizer. The u8 image is read once
//           and the u8 stage output written once; no intermediate reaches
//           device memory. Images are interleaved HWC, (H, W) or (H, W, 3),
//           and the channel count may change inside the stage (grayscale
//           3 -> 1, gray2rgb 1 -> 3).
//           Ghost mode (K4g) runs the stage over a (local_h + 2R, W) shard
//           tile already extended by the stage's one ghost exchange, whose
//           row R is global row `out_row0` of an image H rows high. The
//           window is laid out in global coordinates as in full mode; a
//           window row is read from array row `global row - in_row0`, is
//           out of image by its global row against H, and the per-op edge
//           rewrite therefore fires only on the shards whose tile touches
//           the image's first or last row. Context rows that are real
//           neighbour rows are never rewritten. It writes local_h rows.
//           Full mode takes a stack of same-shape images (the batched
//           pipeline under plan='fused-pallas[-mxu]'; the JAX package's
//           vmap of the Pallas megakernel, whose rule adds a grid
//           dimension): grid z is the image, each at its own input and
//           output stride, so a stage over a stack is one launch.
// The stage: a table in device memory (ops/cuda_kernels.stage_program,
//           built once per stage and copied once per card), its ops in
//           order as PwOp rows (a pointwise opcode and its parameter, or
//           FS_OP_STENCIL + j for stencil j), then one FsStencil per
//           stencil (its descriptor and in-stage arm). Each block copies it
//           into shared memory before its load loop, so a stage has no
//           length limit; its bytes count in the shared-memory budget.
// Bound on the H100: device memory for the stages of the main path. Each
//           pixel reads c_in bytes and writes c_out bytes once: the 8K
//           megakernel chain (3 B in, 1 B out) takes at least 39.6 us at
//           3.35 TB/s. Deep stages (several 5x5 medians, R near 16) may be
//           bound by operations instead. K4g runs per shard: a quarter of
//           those bytes on a 1080 x 7680 shard, plus 2R ghost rows.
// Design:   the first design (one pixel a thread a step in every loop, c_in
//           one-byte loads with two clamps per element, the leading chain
//           dispatched per op per pixel, one output per thread from KS^2
//           shared-memory bytes, the row pass one plane at a time, one byte
//           per channel stored at stride c_out, 128 x 16 tiles whatever the
//           halo, all four KS templates behind one run-time switch with a
//           40-register cap) ran at 4-6% of its bytes bound. This one takes
//           over what the stream-stencil redesign (stream_stencil.cu)
//           proved:
//           - Tile shape from the work (ops/cuda_kernels.fused_stage_tile_
//             shape): taller tiles for a larger stage halo, to cut the
//             redundant reads (tile_h + 2R)(tile_w + 2R) / (tile_h tile_w);
//             columns narrowed to 64 or 32 until the grid has 132 blocks.
//           - Window load: window_load.cuh, K2's loader: each window row's
//             source resolved once per block (array row global - in_row0,
//             clamped), whole row segments as 16-byte cp.async granules
//             into a raw staging buffer; then four pixels a thread, the
//             leading chain from the table in shared memory with each op
//             dispatched once for the four, de-interleaved u8 planes
//             written as 4-byte words.
//           - Buffers: each plane holds the current window region from its
//             first row and column (region row r, column c at r * P + c),
//             so a stencil's four-output strip reads its input rows from a
//             word boundary and writes its outputs to one, whatever the
//             halo consumed so far. The plane pitch P is a multiple of 4
//             with room for the last strip's word reads past the region.
//           - Edge fix only in blocks whose window region leaves the
//             image, a branch uniform over the block; rows inside the image
//             visit only their out-of-image columns.
//           - Stencils, VPU arm: four adjacent outputs a thread, each
//             window row's 4 + 2h bytes read as words once; separable and
//             min/max rows pass into float32 rows stored as float4 for all
//             planes at once, one barrier, then a column pass of float4s;
//             the interior passthrough test hoisted out of regions wholly
//             inside the image.
//           - Pointwise runs between stencils and the trailing run: four
//             pixels a thread, one dispatch per op.
//           - The last stencil on the VPU arm fused with the store, as K2
//             stores: four outputs a thread for every plane, the trailing
//             pointwise run, the channels interleaved in registers, one
//             4-byte word per channel where the row pitch allows, bytes at
//             the ragged edge; its outputs never return to shared memory.
//             A last stencil on K5's arm stores through shared memory and
//             a pass of its own (fs_store_tile): fused with the store like
//             the VPU arm's, it spilled and ran the three main stages
//             1.12-1.50x slower on the H100.
//           - One instantiation per largest stencil class of the stage (3,
//             5 or 7): a 3x3 stage gets a 3x3 register file.
//           - A stage with no stencil runs K1's body (pointwise_run.cuh).
//           Arithmetic: the per-family functions of stencil.cuh, shared
//           with K2, so both keep the golden float32 order.

#include "device_scope.cuh"
#include "mma_stage.cuh"
#include "pointwise_run.cuh"
#include "stencil.cuh"
#include "window_load.cuh"

#define FS_THREADS 256
#define FS_WARPS (FS_THREADS / 32)
#define FS_MAX_DEVICES 16
// images of one full-mode launch: CUDA's limit on grid z
#define FS_MAX_IMAGES 65535
#define FS_OP_STENCIL 100  // ops[k].op = FS_OP_STENCIL + j runs stencil j
// Blocks an SM must hold, which sets the registers a thread: five for the
// 3x3 class (48 registers), four for the others and for the tensor-core
// instantiations (64: with K5's operands as word loads, three blocks (80
// registers) ran the three main stages up to 9% slower, five (48) the RGB
// gaussian:5 and the megakernel stage 3-10% slower, on the H100).
// A build may set each (-DFS_BLOCKS_3=6).
#ifndef FS_BLOCKS_3
#define FS_BLOCKS_3 5
#endif
#ifndef FS_BLOCKS_5
#define FS_BLOCKS_5 4
#endif
#ifndef FS_BLOCKS_MMA
#define FS_BLOCKS_MMA 4
#endif
#define FS_MIN_BLOCKS(KMAX, MMA) \
  ((MMA) ? FS_BLOCKS_MMA : ((KMAX) == 3 ? FS_BLOCKS_3 : FS_BLOCKS_5))

// One stencil of the stage table: its descriptor and in-stage arm
// (FS_ARM_*, mma_stage.cuh). 448 bytes.
struct FsStencil {
  StencilDesc st;
  int arm;
};
static_assert(sizeof(FsStencil) == 448, "the host's table rows");
static_assert(sizeof(PwOp) == 16, "the host's table rows");

__host__ __device__ inline int fs_table_bytes(int n_ops, int n_stencils) {
  return n_ops * (int)sizeof(PwOp) + n_stencils * (int)sizeof(FsStencil);
}

// The channel count after pointwise op `op` on `n` channels (what
// pw_apply_lanes returns), for block-uniform bookkeeping.
__device__ __forceinline__ int fs_channels_after(int op, int n) {
  switch (op) {
    case PW_GRAYSCALE:
    case PW_GRAYSCALE601:
      return 1;
    case PW_SEPIA:
    case PW_GRAY2RGB:
      return 3;
    default:
      return n;
  }
}

// Dynamic shared memory of one block, in order: the stage table, the
// window rows' sources, buffer A and buffer B (c_smem planes each of the
// (tile_h + 2R)-row window, `pitch` bytes a row), then for separable and
// min/max stencils the float32 row pass (c_smem planes of the same shape,
// 4 bytes an element). The raw interleaved window (`raw_pitch` bytes a row)
// is staged over B and what follows it, before either is used.
struct FsLayout {
  int pitch;
  int raw_pitch;
  int plane;  // (tile_h + 2R) * pitch
  size_t rows_off;
  size_t a_off;
  size_t b_off;
  size_t f_off;
  size_t total;
};

__host__ __device__ inline FsLayout fs_layout(int c_in, int c_smem, int tile_h, int tile_w,
                                              int halo, int table_bytes, bool two_pass) {
  FsLayout L;
  const int eh = tile_h + 2 * halo, ew = tile_w + 2 * halo;
  // the last strip's word reads end at most 5 bytes past the region
  L.pitch = (ew + 5 + 3) & ~3;
  L.raw_pitch = (int)st_round16((size_t)ew * c_in + 15);
  L.plane = eh * L.pitch;
  L.rows_off = st_round16((size_t)table_bytes);
  L.a_off = L.rows_off + (size_t)eh * sizeof(StRow);
  const size_t buf = st_round16((size_t)c_smem * L.plane);
  L.b_off = L.a_off + buf;
  L.f_off = L.b_off + buf;
  const size_t f_end = L.f_off + (two_pass ? (size_t)c_smem * L.plane * sizeof(float) : 0);
  const size_t raw_end = L.b_off + (size_t)eh * L.raw_pitch;
  L.total = f_end > raw_end ? f_end : raw_end;
  return L;
}

// The launch, by value.
struct FsArgs {
  const unsigned char* in;
  unsigned char* out;
  const unsigned char* table;
  int H, W;            // image
  int c_in, c_smem, c_out;
  int halo;            // stage halo R
  int tile_h, tile_w;
  int n_ops, n_stencils;
  int in_row0, in_rows, out_row0, out_rows;
  // the stage's last stencil once more (the table's last FsStencil row),
  // whose weights the store-fused last step then reads as kernel
  // parameters, as K2 reads its one stencil's
  StencilDesc last;
  // the batch axis (full mode): grid z is the image of a stack, image i
  // at `in + i * in_stride` and `out + i * out_stride` (bytes; 0 in
  // ghost mode, whose grid z is 1)
  long long in_stride, out_stride;
};

// This block's image of the stack: its input and output, offsets in 64
// bits (a stack of 8K RGB frames passes 2^31 bytes at its 22nd).
__device__ __forceinline__ const unsigned char* fs_in(const FsArgs& A) {
  return A.in + (long long)blockIdx.z * A.in_stride;
}
// The output's image index is read anew in each store pass (a volatile
// read the compiler cannot hoist), so that no 64-bit image pointer stays
// live in registers across the stage body, where K5's tensor-core arm
// spills.
__device__ __forceinline__ unsigned char* fs_out(const FsArgs& A) {
  unsigned z;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return A.out + (long long)z * A.out_stride;
}

// The current window region of one block: `rows` x `cols` positions from
// buffer offset 0, whose (0, 0) is global position (gy0, gx0).
struct FsRegion {
  int rows, cols;
  int gy0, gx0;
  int H, W;      // image
  int plane, P;  // buffer geometry
};

__device__ __forceinline__ FsRegion fs_shrink(FsRegion g, int h) {
  g.rows -= 2 * h;
  g.cols -= 2 * h;
  g.gy0 += h;
  g.gx0 += h;
  return g;
}

// Rewrites the out-of-image positions of the region in `n_planes` planes
// of `a` per edge mode `mode`, from in-image positions of the same region:
// reads touch only in-image positions and writes only out-of-image ones,
// so one pass suffices and corners need no ordering. Warp w takes rows
// w, w + 8, ...; a row inside the image visits only its out-of-image
// columns.
__device__ void fs_edge_fix(unsigned char* a, int n_planes, const FsRegion& g, int mode) {
  const int lo_y = max(0, -g.gy0), hi_y = min(g.rows, g.H - g.gy0) - 1;
  const int lo_x = max(0, -g.gx0), hi_x = min(g.cols, g.W - g.gx0) - 1;
  const bool zero = mode == ST_EDGE_INTERIOR || mode == ST_EDGE_ZERO;
  const int n_side = lo_x + (g.cols - 1 - hi_x);  // out-of-image columns of a row
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < g.rows; r += FS_WARPS) {
    const bool row_in = r >= lo_y && r <= hi_y;
    // the op's source row, kept inside the region's in-image rows (only
    // positions no kept output reaches would leave them)
    const int sy = min(max(st_src(g.gy0 + r, g.H, mode) - g.gy0, lo_y), hi_y);
    const int n = row_in ? n_side : g.cols;
    for (int i = lane; i < n; i += 32) {
      const int c = row_in ? (i < lo_x ? i : hi_x + 1 + (i - lo_x)) : i;
      const int dst = r * g.P + c;
      if (zero) {
        for (int p = 0; p < n_planes; ++p) a[p * g.plane + dst] = 0;
        continue;
      }
      const int sx = min(max(st_src(g.gx0 + c, g.W, mode) - g.gx0, lo_x), hi_x);
      const int src = sy * g.P + sx;
      for (int p = 0; p < n_planes; ++p) a[p * g.plane + dst] = a[p * g.plane + src];
    }
  }
}

// One stencil on the VPU arm from buffer `a` (input region `g`) into
// buffer `b` (the region shrunk by h, from offset 0), `n_planes` planes;
// four adjacent outputs a thread. Separable and min/max stencils run their
// row pass for every plane into `f`, then one barrier.
template <int KS>
__device__ void fs_stencil(const unsigned char* a, unsigned char* b, float* f, int n_planes,
                           const FsRegion& g, const StencilDesc& st) {
  constexpr int h = KS / 2;
  const FsRegion o = fs_shrink(g, h);  // the outputs
  const int P = g.P;
  const unsigned strips = (unsigned)(o.cols + 3) >> 2;
  const unsigned ms = st_magic(strips);
  const bool two_pass = st_two_pass(st.family);
  // interior mode passes through outputs within h of the border; a region
  // wholly inside needs no test
  const bool all_filtered = st.edge_mode != ST_EDGE_INTERIOR ||
                            (o.gy0 > h && o.gy0 + o.rows - 1 <= g.H - 1 - h && o.gx0 > h &&
                             o.gx0 + o.cols - 1 <= g.W - 1 - h);
  // one flat loop over the planes' strips: plane c = i / (rows x strips)
  if (two_pass) {
    const unsigned per = (unsigned)g.rows * strips;
    const unsigned mp = st_magic(per);
    for (unsigned i = threadIdx.x; i < (unsigned)n_planes * per; i += FS_THREADS) {
      const unsigned c = st_div(i, mp);
      const unsigned rs = i - c * per;
      const unsigned r = st_div(rs, ms);
      const unsigned at = c * g.plane + r * P + 4 * (rs - r * strips);
      *reinterpret_cast<float4*>(f + at) = st_strip_row_pass<KS>(a + at, st);
    }
    __syncthreads();
  }
  const unsigned per = (unsigned)o.rows * strips;
  const unsigned mp = st_magic(per);
  for (unsigned i = threadIdx.x; i < (unsigned)n_planes * per; i += FS_THREADS) {
    const unsigned c = st_div(i, mp);
    const unsigned rs = i - c * per;
    const unsigned r = st_div(rs, ms);
    const unsigned s4 = 4 * (rs - r * strips);
    const unsigned at = c * g.plane + r * P + s4;
    float acc[4], center[4];
    if (two_pass) {
      st_strip_col_pass<KS>(f + at, P, st, acc);
    } else {
      st_strip_window<KS>(a + at, P, st, acc, center);
    }
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float res;
      if (all_filtered ||
          st_filtered(o.gy0 + (int)r, o.gx0 + (int)s4 + j, g.H, g.W, h, st.edge_mode)) {
        res = st_finish(acc[j], st);
      } else {
        res = two_pass ? (float)a[at + h * P + h + j] : center[j];
      }
      word |= (uint32_t)pw_to_u8(res) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(b + at) = word;
  }
  __syncthreads();
}

// The four pixels at region (r, 4 s) of `n` planes of `a` as floats.
__device__ __forceinline__ void fs_load4(const unsigned char* a, int plane, int idx, int n,
                                         float v[4][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t w = c < n ? *reinterpret_cast<const uint32_t*>(a + c * plane + idx) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j][c] = (float)((w >> (8 * j)) & 0xFFu);
  }
}

// The trailing pointwise ops `trail` on four pixels held as one packed u8
// word per channel (byte j = pixel j), in place.
__device__ __forceinline__ void fs_trail4(uint32_t (&w)[3], const PwOp* trail, int n_trail,
                                          int n) {
  if (!n_trail) return;
  float v[4][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j][c] = (float)((w[c] >> (8 * j)) & 0xFFu);
  }
  pw_apply_n<4>(trail, n_trail, v, n);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w[c] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[c] |= (uint32_t)pw_to_u8(v[j][c]) << (8 * j);
  }
}

// Stores four outputs of the tile at (ly, lx) into the block's image
// `out` (fs_out), each channel c's four in the packed word w[c]: one
// 4-byte word per channel where the row pitch allows (RGB interleaved by
// byte permutes: r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3), else bytes.
__device__ __forceinline__ void fs_store4(unsigned char* out, const FsArgs& A, int x0, int y0,
                                          int ly, int lx, int cols_out, bool vec_store,
                                          const uint32_t (&w)[3]) {
  const int c_out = A.c_out;
  unsigned char* o = out + ((long long)(y0 - A.out_row0 + ly) * A.W + x0 + lx) * c_out;
  if (vec_store && lx + 4 <= cols_out && c_out == 1) {
    *reinterpret_cast<uint32_t*>(o) = w[0];
  } else if (vec_store && lx + 4 <= cols_out) {
    uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
    o32[0] = __byte_perm(__byte_perm(w[0], w[1], 0x1040), w[2], 0x3410);
    o32[1] = __byte_perm(__byte_perm(w[1], w[2], 0x2051), w[0], 0x3610);
    o32[2] = __byte_perm(__byte_perm(w[2], w[0], 0x3072), w[1], 0x3710);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lx + j >= cols_out) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < c_out) o[j * c_out + c] = (unsigned char)(w[c] >> (8 * j));
      }
    }
  }
}

// The tile's outputs from buffer `a` (the tile_h x tile_w region from offset
// 0, `P` bytes a row, `plane` bytes a plane) through the trailing pointwise
// run: four outputs a thread, their channels interleaved in registers.
__device__ void fs_store_tile(const unsigned char* a, int P, int plane, int n_cur,
                              const PwOp* trail, int n_trail, const FsArgs& A, int x0, int y0) {
  const int th = A.tile_h, tw = A.tile_w;
  const int rows_out = min(th, A.out_row0 + A.out_rows - y0), cols_out = min(tw, A.W - x0);
  const int lg = 31 - __clz(tw >> 2);
  unsigned char* const out = fs_out(A);
  const bool vec_store = (A.W & 3) == 0 && ((uintptr_t)out & 3) == 0;
  for (int i = threadIdx.x; i < th << lg; i += FS_THREADS) {
    const int ly = i >> lg;
    const int lx = 4 * (i & ((tw >> 2) - 1));
    if (ly >= rows_out || lx >= cols_out) continue;
    uint32_t w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w[c] = c < n_cur ? *reinterpret_cast<const uint32_t*>(a + c * plane + ly * P + lx) : 0u;
    }
    fs_trail4(w, trail, n_trail, n_cur);
    fs_store4(out, A, x0, y0, ly, lx, cols_out, vec_store, w);
  }
}

// K5: one stencil on a tensor-core arm (mma_stage.cuh), with the contract
// of fs_stencil: from buffer `a` (input region `g`) into buffer `b` (the
// region shrunk by h, from offset 0), `n_planes` planes. Each warp takes the
// region's 16 x 8 output tiles in turn, every plane of a tile; each lane
// finalizes the four outputs it holds and stores each row's two as one
// 16-bit word.
template <int KS, bool INT8, bool TWO>
__device__ void fs_mma_walk(const unsigned char* a, unsigned char* b, int n_planes,
                            const FsRegion& g, const StencilDesc& st) {
  constexpr int h = KS / 2;
  const int y_end = g.rows - h, x_end = g.cols - h;  // outputs [h, y_end) x [h, x_end)
  const int n_tx = (x_end - h + 7) >> 3;
  const int n_tiles = (y_end - h + 15) / 16 * n_tx;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  MmaB<KS, INT8> b0, b1;
  mma_b_build(b0, st.w0, gq, t);
  if (TWO) mma_b_build(b1, st.w1, gq, t);
  const float corr0 = INT8 ? mma_corr128<KS>(st.w0) : 0.0f;
  const float corr1 = INT8 && TWO ? mma_corr128<KS>(st.w1) : 0.0f;
  // interior mode passes through outputs within h of the border; a region
  // wholly inside needs no test
  const FsRegion o = fs_shrink(g, h);
  const bool all_filtered = st.edge_mode != ST_EDGE_INTERIOR ||
                            (o.gy0 > h && o.gy0 + o.rows - 1 <= g.H - 1 - h && o.gx0 > h &&
                             o.gx0 + o.cols - 1 <= g.W - 1 - h);
  for (int tile = threadIdx.x >> 5; tile < n_tiles; tile += FS_WARPS) {
    const int r0 = h + tile / n_tx * 16, c0 = h + tile % n_tx * 8;
    const int wy = r0 + gq, wx = c0 + 2 * t;  // this lane's first output
#pragma unroll 1
    for (int c = 0; c < n_planes; ++c) {
      const MmaWin src{a + c * g.plane, g.P, g.rows};
      float acc0[4], acc1[4];
      mma_tile<KS, INT8, TWO>(acc0, acc1, src, b0, b1, corr0, corr1, r0, c0, gq, t);
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = wy + (i >> 1) * 8, x = wx + (i & 1);
        float res = st_finish(TWO ? mma_magnitude(acc0[i], acc1[i]) : acc0[i], st);
        if (!all_filtered && !st_filtered(g.gy0 + y, g.gx0 + x, g.H, g.W, h, st.edge_mode)) {
          res = (float)src.p[min(y, g.rows - 1) * g.P + min(x, g.P - 1)];
        }
        q[i] = pw_to_u8(res);
      }
      // outputs (y, x) and (y, x + 1) as one 16-bit word (a second byte past
      // the region's last column lands in the row's padding)
      unsigned char* dst = b + c * g.plane + (wy - h) * g.P + wx - h;
      if (wx < x_end) {
        if (wy < y_end) *reinterpret_cast<unsigned short*>(dst) = (unsigned short)(q[0] | q[1] << 8);
        if (wy + 8 < y_end) {
          *reinterpret_cast<unsigned short*>(dst + 8 * g.P) = (unsigned short)(q[2] | q[3] << 8);
        }
      }
    }
  }
  __syncthreads();
}

template <int KS>
__device__ void fs_stencil_mma(const unsigned char* a, unsigned char* b, int n_planes,
                               const FsRegion& g, const StencilDesc& st, int arm) {
  const bool two = st.family == ST_MAGNITUDE;  // block-uniform
  if (arm == FS_ARM_INT8) {
    if (two) {
      fs_mma_walk<KS, true, true>(a, b, n_planes, g, st);
    } else {
      fs_mma_walk<KS, true, false>(a, b, n_planes, g, st);
    }
  } else if (two) {
    fs_mma_walk<KS, false, true>(a, b, n_planes, g, st);
  } else {
    fs_mma_walk<KS, false, false>(a, b, n_planes, g, st);
  }
}

// The stage's last stencil on the VPU arm fused with the store, as K2
// stores: the region shrinks to the tile; each thread takes four adjacent
// outputs of every plane, runs the trailing pointwise ops `trail` on them,
// interleaves their channels in registers and stores them, so the last
// stencil's outputs never return to shared memory.
template <int KS>
__device__ void fs_stencil_store(const unsigned char* a, float* f, int n_planes,
                                 const FsRegion& g, const StencilDesc& st, const PwOp* trail,
                                 int n_trail, const FsArgs& A, int x0, int y0) {
  constexpr int h = KS / 2;
  const FsRegion o = fs_shrink(g, h);  // the tile's outputs
  const int P = g.P;
  const unsigned strips = (unsigned)o.cols >> 2;  // tile_w / 4, a power of two
  const int lg = 31 - __clz((int)strips);
  const bool two_pass = st_two_pass(st.family);
  const bool all_filtered = st.edge_mode != ST_EDGE_INTERIOR ||
                            (o.gy0 > h && o.gy0 + o.rows - 1 <= g.H - 1 - h && o.gx0 > h &&
                             o.gx0 + o.cols - 1 <= g.W - 1 - h);
  if (two_pass) {
    const unsigned per = (unsigned)g.rows * strips;
    const unsigned mp = st_magic(per);
    for (unsigned i = threadIdx.x; i < (unsigned)n_planes * per; i += FS_THREADS) {
      const unsigned c = st_div(i, mp);
      const unsigned rs = i - c * per;
      const unsigned r = rs >> lg;
      const unsigned at = c * g.plane + r * P + 4 * (rs & (strips - 1));
      *reinterpret_cast<float4*>(f + at) = st_strip_row_pass<KS>(a + at, st);
    }
    __syncthreads();
  }
  const int rows_out = min(o.rows, A.out_row0 + A.out_rows - y0), cols_out = min(o.cols, A.W - x0);
  unsigned char* const out = fs_out(A);
  const bool vec_store = (A.W & 3) == 0 && ((uintptr_t)out & 3) == 0;
  for (int i = threadIdx.x; i < o.rows << lg; i += FS_THREADS) {
    const int ly = i >> lg;
    const int lx = 4 * (i & ((int)strips - 1));
    if (ly >= rows_out || lx >= cols_out) continue;
    uint32_t w[3] = {0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c >= n_planes) break;
      const int at = c * g.plane + ly * P + lx;
      float acc[4], center[4];
      if (two_pass) {
        st_strip_col_pass<KS>(f + at, P, st, acc);
      } else {
        st_strip_window<KS>(a + at, P, st, acc, center);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float res;
        if (all_filtered ||
            st_filtered(o.gy0 + ly, o.gx0 + lx + j, g.H, g.W, h, st.edge_mode)) {
          res = st_finish(acc[j], st);
        } else {
          res = two_pass ? (float)a[at + h * P + h + j] : center[j];
        }
        w[c] |= (uint32_t)pw_to_u8(res) << (8 * j);
      }
    }
    fs_trail4(w, trail, n_trail, n_planes);
    fs_store4(out, A, x0, y0, ly, lx, cols_out, vec_store, w);
  }
}

template <int KMAX, bool kMma>
__global__ void __launch_bounds__(FS_THREADS, FS_MIN_BLOCKS(KMAX, kMma))
fused_stage_kernel(const __grid_constant__ FsArgs A) {
  // `in` holds global rows [in_row0, in_row0 + in_rows) and `out` global
  // rows [out_row0, out_row0 + out_rows) of an image H rows high: the whole
  // image in full mode, one extended shard tile and its shard in ghost mode.
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = A.halo, tw = A.tile_w, th = A.tile_h;
  const int eh = th + 2 * R, ew = tw + 2 * R;
  const int tb = fs_table_bytes(A.n_ops, A.n_stencils);
  const FsLayout L = fs_layout(A.c_in, A.c_smem, th, tw, R, tb, false);
  const int P = L.pitch;
  const PwOp* ops = reinterpret_cast<const PwOp*>(smem);
  const FsStencil* sts = reinterpret_cast<const FsStencil*>(smem + A.n_ops * sizeof(PwOp));
  StRow* rows = reinterpret_cast<StRow*>(smem + L.rows_off);
  float* f = reinterpret_cast<float*>(smem + L.f_off);
  const int x0 = blockIdx.x * tw;
  const int y0 = A.out_row0 + blockIdx.y * th;  // global row of the tile's first output
  const int n_ops = A.n_ops;

  // 1. The table and each window row's source, then the raw window: the
  // rows' segments as 16-byte granules, cp.async straight into shared
  // memory.
  for (int i = threadIdx.x; i < tb / 16; i += FS_THREADS) {
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(A.table)[i];
  }
  const StCols cols = st_cols(x0, tw, R, A.W);
  st_row_sources_clamped<FS_THREADS>(rows, eh, y0 - R, A.in_row0, A.in_rows, cols, fs_in(A),
                                     A.W, A.c_in);
  __syncthreads();
  st_load_window<FS_THREADS>(smem + L.b_off, rows, eh, L.raw_pitch);
  st_load_wait();
  __syncthreads();

  // 2. Four window pixels a thread: the source column (border blocks
  // only, a branch uniform over the block; columns outside the image are
  // rewritten by the first stencil's edge fix), the leading chain, the
  // de-interleaved u8 planes of buffer A as words.
  int first = 0;
  while (first < n_ops && ops[first].op < FS_OP_STENCIL) ++first;
  int n_cur = A.c_in;
  for (int k = 0; k < first; ++k) n_cur = fs_channels_after(ops[k].op, n_cur);
  unsigned char* a = smem + L.a_off;
  unsigned char* b = smem + L.b_off;
  {
    const unsigned char* raw = smem + L.b_off;
    const unsigned gb = (unsigned)(ew + 3) >> 2;
    const unsigned mb = st_magic(gb);
    for (unsigned i = threadIdx.x; i < (unsigned)eh * gb; i += FS_THREADS) {
      const unsigned r = st_div(i, mb);
      const unsigned gx = i - r * gb;
      const unsigned char* rr = raw + r * L.raw_pitch + rows[r].shift;
      const unsigned char* p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cx = x0 - R + min(4 * (int)gx + j, ew - 1);
        const int sx = cols.border ? min(max(cx, cols.lo), cols.hi - 1) : cx;
        p[j] = rr + (sx - cols.lo) * A.c_in;
      }
      uint32_t word[3] = {0u, 0u, 0u};
      if (first == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (c < A.c_in) word[c] |= (uint32_t)p[j][c] << (8 * j);
          }
        }
      } else {
        float v[4][3];
#pragma unroll
        for (int j = 0; j < 4; ++j) pw_load(p[j], v[j], A.c_in);
        pw_apply_n<4>(ops, first, v, A.c_in);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) word[c] |= (uint32_t)pw_to_u8(v[j][c]) << (8 * j);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < n_cur) *reinterpret_cast<uint32_t*>(a + c * L.plane + r * P + 4 * gx) = word[c];
      }
    }
  }
  __syncthreads();

  // 3. The stage walk: each stencil with its edge fix, then the pointwise
  // run up to the next stencil, in place.
  FsRegion g{eh, ew, y0 - R, x0 - R, A.H, A.W, L.plane, P};
  int k = first;
  while (k < n_ops) {
    const FsStencil& fst = sts[ops[k].op - FS_OP_STENCIL];
    const StencilDesc& st = fst.st;
    int end = k + 1;
    while (end < n_ops && ops[end].op < FS_OP_STENCIL) ++end;
    const bool last = end == n_ops;  // the trailing run rides the store
    if (st.halo > 0) {
      // blocks whose region lies inside the image skip the fix (uniform)
      const bool inside = g.gy0 >= 0 && g.gy0 + g.rows <= A.H && g.gx0 >= 0 &&
                          g.gx0 + g.cols <= A.W;
      if (!inside) {
        fs_edge_fix(a, n_cur, g, st.edge_mode);
        __syncthreads();
      }
    }
    const PwOp* trail = ops + k + 1;
    const int n_trail = n_ops - k - 1;
    bool on_mma = false;
    if constexpr (kMma) {
      const int arm = fst.arm;  // block-uniform
      on_mma = arm != FS_ARM_VPU;
      switch (on_mma ? st.ksize : 0) {
        case 1: fs_stencil_mma<1>(a, b, n_cur, g, st, arm); break;
        case 3: fs_stencil_mma<3>(a, b, n_cur, g, st, arm); break;
        case 5: if constexpr (KMAX >= 5) fs_stencil_mma<5>(a, b, n_cur, g, st, arm); break;
        case 7: if constexpr (KMAX >= 7) fs_stencil_mma<7>(a, b, n_cur, g, st, arm); break;
        default: break;
      }
      if (on_mma && last) {  // the tile, from b, through the trailing run
        fs_store_tile(b, P, L.plane, n_cur, trail, n_trail, A, x0, y0);
        return;
      }
    }
    if (!on_mma && last) {
      const StencilDesc& sl = A.last;
      switch (sl.ksize) {
        case 1: fs_stencil_store<1>(a, f, n_cur, g, sl, trail, n_trail, A, x0, y0); break;
        case 3: fs_stencil_store<3>(a, f, n_cur, g, sl, trail, n_trail, A, x0, y0); break;
        case 5: if constexpr (KMAX >= 5) fs_stencil_store<5>(a, f, n_cur, g, sl, trail, n_trail, A, x0, y0); break;
        case 7: if constexpr (KMAX >= 7) fs_stencil_store<7>(a, f, n_cur, g, sl, trail, n_trail, A, x0, y0); break;
        default: break;
      }
      return;
    }
    if (!on_mma) {
      switch (st.ksize) {
        case 1: fs_stencil<1>(a, b, f, n_cur, g, st); break;
        case 3: fs_stencil<3>(a, b, f, n_cur, g, st); break;
        case 5: if constexpr (KMAX >= 5) fs_stencil<5>(a, b, f, n_cur, g, st); break;
        case 7: if constexpr (KMAX >= 7) fs_stencil<7>(a, b, f, n_cur, g, st); break;
        default: break;  // rejected on the host
      }
    }
    unsigned char* t = a;
    a = b;
    b = t;
    g = fs_shrink(g, st.halo);
    ++k;
    if (end > k) {
      int n_next = n_cur;
      for (int j = k; j < end; ++j) n_next = fs_channels_after(ops[j].op, n_next);
      const unsigned gw = (unsigned)(g.cols + 3) >> 2;
      const unsigned mw = st_magic(gw);
      for (unsigned i = threadIdx.x; i < (unsigned)g.rows * gw; i += FS_THREADS) {
        const unsigned r = st_div(i, mw);
        const int idx = r * P + 4 * (i - r * gw);
        float v[4][3];
        fs_load4(a, L.plane, idx, n_cur, v);
        pw_apply_n<4>(ops + k, end - k, v, n_cur);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (c >= n_next) break;
          uint32_t w = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) w |= (uint32_t)pw_to_u8(v[j][c]) << (8 * j);
          *reinterpret_cast<uint32_t*>(a + c * L.plane + idx) = w;
        }
      }
      n_cur = n_next;
      k = end;
      __syncthreads();
    }
  }
}

template <int KMAX, bool kMma>
static int fs_launch_k(const FsArgs& A, size_t smem, int n_img, int device, cudaStream_t s) {
  // the opt-in above 48 KB, once per instantiation, size and device
  static size_t opted[FS_MAX_DEVICES] = {};
  if (smem > 48 * 1024 && smem > opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stage_kernel<KMAX, kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[device] = smem;
  }
  const dim3 grid((A.W + A.tile_w - 1) / A.tile_w, (A.out_rows + A.tile_h - 1) / A.tile_h,
                  n_img);
  fused_stage_kernel<KMAX, kMma><<<grid, FS_THREADS, smem, s>>>(A);
  return (int)cudaGetLastError();
}

// Launches the stage on `device` and `stream` over the rows described at
// the kernel. `c_smem` is the most channels the stage holds in shared
// memory; `kmax` the largest stencil class (3, 5 or 7), `mma` whether a
// stencil takes a tensor-core arm, `two_pass` whether one is separable or
// min/max (the host reads all three from the stage). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
static int fs_launch(const unsigned char* in, unsigned char* out, int H, int W, int c_in,
                     int c_smem, int c_out, int halo, int tile_h, int tile_w,
                     const unsigned char* table, const StencilDesc* last, int n_ops,
                     int n_stencils, int kmax, int mma, int two_pass, int in_row0, int in_rows,
                     int out_row0, int out_rows, int n_img, long long in_stride,
                     long long out_stride, int device, void* stream) {
  if (out_rows <= 0 || W <= 0 || n_img == 0) return 0;
  if (device < 0 || device >= FS_MAX_DEVICES || n_ops < 1 || table == nullptr ||
      n_stencils < 0 || c_in < 1 || c_in > 3 || c_out < 1 || c_out > 3 || n_img < 0 ||
      n_img > FS_MAX_IMAGES) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_stencils == 0) {
    // halo 0: `in` and `out` hold the same rows, and a stack of them is
    // one flat run where its images lie back to back
    const long long pix = (long long)out_rows * W;
    if (n_img > 1 && (in_stride != pix * c_in || out_stride != pix * c_out)) {
      return (int)cudaErrorInvalidValue;
    }
    return pw_run_launch(in, out, pix * n_img, c_in, c_out,
                         reinterpret_cast<const PwOp*>(table), n_ops, s);
  }
  const bool width_ok = tile_w == 32 || tile_w == 64 || tile_w == 128;
  if (!width_ok || tile_h < 1 || c_smem < 1 || c_smem > 3 || halo < 0 || last == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  FsArgs A{in,       out,      table,    H,        W,       c_in,       c_smem,
           c_out,    halo,     tile_h,   tile_w,   n_ops,   n_stencils, in_row0,
           in_rows,  out_row0, out_rows, *last,    in_stride, out_stride};
  const size_t smem = fs_layout(c_in, c_smem, tile_h, tile_w, halo,
                                fs_table_bytes(n_ops, n_stencils), two_pass != 0).total;
#define FS_CASE(KMAX)                                                    \
  case KMAX:                                                             \
    return mma ? fs_launch_k<KMAX, true>(A, smem, n_img, device, s)      \
               : fs_launch_k<KMAX, false>(A, smem, n_img, device, s);
  switch (kmax) {
    FS_CASE(3)
    FS_CASE(5)
    FS_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FS_CASE
}

// K4: one fused stage over a stack of `n_img` whole (H, W) images, image
// i at `in + i * in_stride` and written to `out + i * out_stride` (bytes;
// one image: n_img 1), tiles of tile_h x tile_w outputs, the stage table
// `table` (n_ops op rows, then n_stencils FsStencil rows, in device
// memory) and its last stencil's descriptor `last` in host memory (null
// for a stage with no stencil). A tile never spans two images: grid z is
// the image.
extern "C" int fused_stage_launch(const unsigned char* in, unsigned char* out, int H, int W,
                                  int c_in, int c_smem, int c_out, int halo, int tile_h,
                                  int tile_w, const unsigned char* table,
                                  const StencilDesc* last, int n_ops, int n_stencils, int kmax,
                                  int mma, int two_pass, int n_img, long long in_stride,
                                  long long out_stride, int device, void* stream) {
  return fs_launch(in, out, H, W, c_in, c_smem, c_out, halo, tile_h, tile_w, table, last,
                   n_ops, n_stencils, kmax, mma, two_pass, 0, H, 0, H, n_img, in_stride,
                   out_stride, device, stream);
}

// K4g: one fused stage over a (local_h + 2 halo, W) extended shard tile
// whose shard starts at global row `row0` of an image `image_h` rows high;
// writes the shard's (local_h, W) rows.
extern "C" int fused_stage_ext_launch(const unsigned char* ext, unsigned char* out,
                                      int local_h, int W, int c_in, int c_smem, int c_out,
                                      int halo, int tile_h, int tile_w,
                                      const unsigned char* table, const StencilDesc* last,
                                      int n_ops, int n_stencils, int kmax, int mma,
                                      int two_pass, int row0, int image_h, int device,
                                      void* stream) {
  return fs_launch(ext, out, image_h, W, c_in, c_smem, c_out, halo, tile_h, tile_w, table,
                   last, n_ops, n_stencils, kmax, mma, two_pass, row0 - halo,
                   local_h + 2 * halo, row0, local_h, 1, 0, 0, device, stream);
}

// K5's exactness probe: the raw f32 sums of one kernel of stencil `st`
// (w0, or w1 when `second`) over a (rows, cols) u8 plane in device memory,
// `pitch` bytes a row (a multiple of 4, at a 4-byte aligned address),
// valid mode, into a (rows - KS + 1, cols - KS + 1) f32 array. One warp a
// 16 x 8 output tile, through the tile function K5 runs (mma_tile in
// mma_stage.cuh), so the sums are those K5 finalizes; the u8 rounding and
// clip of K5's output hide their low bits wherever the result leaves
// 0..255, which this output does not.
template <int KS, bool INT8>
__global__ void __launch_bounds__(FS_THREADS)
k5_sums_kernel(const unsigned char* __restrict__ in, float* __restrict__ out, int rows,
               int cols, int pitch, const __grid_constant__ StencilDesc st, int second) {
  constexpr int h = KS / 2;
  const int out_rows = rows - 2 * h, out_cols = cols - 2 * h;
  const int n_tx = (out_cols + 7) / 8;
  const int tile = blockIdx.x * FS_WARPS + (int)(threadIdx.x >> 5);
  if (tile >= (out_rows + 15) / 16 * n_tx) return;  // the whole warp
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const MmaWin src{in, pitch, rows};
  const int r0 = h + tile / n_tx * 16, c0 = h + tile % n_tx * 8;
  const float* w = second ? st.w1 : st.w0;
  MmaB<KS, INT8> b;
  mma_b_build(b, w, g, t);
  float acc[4], unused[4];
  mma_tile<KS, INT8, false>(acc, unused, src, b, b, INT8 ? mma_corr128<KS>(w) : 0.0f, 0.0f, r0,
                            c0, g, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = r0 - h + g + (i >> 1) * 8, x = c0 - h + 2 * t + (i & 1);
    if (y < out_rows && x < out_cols) out[(long long)y * out_cols + x] = acc[i];
  }
}

template <int KS>
static void k5_sums_run(const unsigned char* in, float* out, int rows, int cols, int pitch,
                        const StencilDesc* st, int second, int arm, unsigned blocks,
                        cudaStream_t s) {
  if (arm == FS_ARM_INT8) {
    k5_sums_kernel<KS, true><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, pitch, *st, second);
  } else {
    k5_sums_kernel<KS, false><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, pitch, *st, second);
  }
}

extern "C" int k5_sums_launch(const unsigned char* in, float* out, int rows, int cols, int pitch,
                              const StencilDesc* st, int second, int arm, void* stream) {
  const int h = st->ksize / 2;
  if (arm != FS_ARM_BF16 && arm != FS_ARM_INT8) return (int)cudaErrorInvalidValue;
  if (pitch < cols || pitch % 4 || ((uintptr_t)in & 3)) return (int)cudaErrorInvalidValue;
  if (rows <= 2 * h || cols <= 2 * h) return 0;
  const long long tiles = (long long)(rows - 2 * h + 15) / 16 * ((cols - 2 * h + 7) / 8);
  const unsigned blocks = (unsigned)((tiles + FS_WARPS - 1) / FS_WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (st->ksize) {
    case 1: k5_sums_run<1>(in, out, rows, cols, pitch, st, second, arm, blocks, s); break;
    case 3: k5_sums_run<3>(in, out, rows, cols, pitch, st, second, arm, blocks, s); break;
    case 5: k5_sums_run<5>(in, out, rows, cols, pitch, st, second, arm, blocks, s); break;
    case 7: k5_sums_run<7>(in, out, rows, cols, pitch, st, second, arm, blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory one launch needs and the table's size, for the
// host-side checks.
extern "C" long long fused_stage_smem_bytes(int c_in, int c_smem, int tile_h, int tile_w,
                                            int halo, int n_ops, int n_stencils, int two_pass) {
  return (long long)fs_layout(c_in, c_smem, tile_h, tile_w, halo,
                              fs_table_bytes(n_ops, n_stencils), two_pass != 0).total;
}

extern "C" long long fused_stage_table_bytes(int n_ops, int n_stencils) {
  return (long long)fs_table_bytes(n_ops, n_stencils);
}
