// K4 and K4g: the fused plan-stage megakernel, in its full-image mode and
// in its ghost mode over one row-shard. One kernel, two entry points, two
// instantiations: the VPU instantiation runs every stencil on the VPU arm
// (the per-family functions of stencil.cuh); the tensor-core instantiation
// also runs the stencils the stage program puts on a tensor-core arm as K5
// (mma_stage.cuh). A stage launches the second only when one of its
// stencils has such an arm.
//
// Replaces: mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py
//           _stage_kernel (launched by fused_stage_call) with every op on
//           the 'vpu' arm: with ghosts=False (K4), the route
//           plan='fused-pallas' takes for each eligible stage
//           (plan/pallas_exec.py), and with ghosts=True (K4g), the route
//           the row-sharded runner takes (run_stage_pallas_ext).
// Computes: one fused plan stage in one launch: its pointwise runs, its
//           chained stencils (total halo R <= 16), each stencil's own edge
//           extension applied to that stencil's input (reflect101 mirrors,
//           edge clamps, interior and zero write 0), the interior-mode
//           passthrough at global coordinates, scale and quantizer. The
//           u8 image is read once and the u8 stage output written once; no
//           intermediate reaches device memory. Images are interleaved HWC,
//           (H, W) or (H, W, 3), and the channel count may change inside
//           the stage (grayscale 3 -> 1, gray2rgb 1 -> 3).
//           Ghost mode (K4g) runs the stage over a (local_h + 2R, W) shard
//           tile already extended by the stage's one ghost exchange, whose
//           row R is global row `out_row0` of an image H rows high. The
//           window is laid out in global coordinates as in full mode; a
//           window row is read from array row `global row - in_row0`, is
//           out of image by its global row against H, and the per-op edge
//           rewrite therefore fires only on the shards whose tile touches
//           the image's first or last row. Context rows that are real
//           neighbour rows are never rewritten. It writes local_h rows.
// Bound on the H100: device memory for the stages of the main path. Each
//           pixel reads c_in bytes and writes c_out bytes once: the 8K
//           megakernel chain (3 B in, 1 B out) takes at least 39.6 us at
//           3.35 TB/s. Deep stages (several 5x5 medians, R near 16) may be
//           bound by operations instead. K4g runs per shard: a quarter of
//           those bytes on a 1080 x 7680 shard, plus 2R ghost rows.
// Design:   a 2-D grid of independent output tiles (FS_TILE_W columns x
//           tile_h rows, 256 threads), as K2; the TPU kernel's ordered
//           walk over full-width row blocks with context strips has no
//           counterpart. Each block loads a (tile_h + 2R) x (128 + 2R)
//           window once, runs the leading pointwise ops on it, and keeps
//           it as u8 planes in shared memory: every core maps exact
//           integers in 0..255 to exact integers in 0..255 and every
//           finalize clips, so a u8 carry loses nothing. Each stencil reads
//           one buffer and writes the other (ping-pong) over a window that
//           shrinks by its halo; separable and min/max stencils add a
//           float32 row pass, one plane at a time. Before each stencil with
//           a halo, the positions of the window that lie outside the image
//           take their values from in-image positions of the same buffer
//           (src(y), src(x) in that op's mode): reads touch only in-image
//           positions and writes only out-of-image ones, so one pass and
//           one barrier suffice and corners need no ordering. The sources
//           a kept output reaches lie inside the window because the host
//           gates height > 2R and width > the largest op halo. Redundant
//           reads grow with R: (tile_h + 2R)(128 + 2R) / (128 tile_h), 1.44
//           for 16 x 128 tiles at R = 3, 3.75 at R = 16. Every loop gives a
//           warp whole window rows and its lanes the columns, so no loop
//           divides by the run-time window width. Registers are capped so
//           that six blocks share an SM: the few spills this costs are
//           cheaper than the occupancy they buy (measured, PERF.md).
//           Arithmetic: the per-family functions of stencil.cuh, shared
//           with K2, so both keep the golden float32 order.
//           The tensor-core instantiation has its own register cap: the
//           VPU instantiation's code, and so its time, stays that of K4
//           alone.

#include "mma_stage.cuh"
#include "stencil.cuh"

#define FS_TILE_W 128
#define FS_THREADS 256
#define FS_WARPS (FS_THREADS / 32)
// at most 40 registers a thread, so that six blocks fit on an SM
#define FS_MIN_BLOCKS 6
// the tensor-core instantiation: at most 64 registers a thread
#define FS_MMA_MIN_BLOCKS 4
#define FS_MAX_OPS 24
#define FS_MAX_STENCILS 8
#define FS_OP_STENCIL 100  // op[k] = FS_OP_STENCIL + j runs stencil st[j]

// One fused stage, passed by value as a __grid_constant__ parameter (3784
// bytes, under the 4 KB kernel-parameter limit): its ops in order, each a
// pointwise opcode (PW_*) with its parameter, or a stencil, and each
// stencil's in-stage arm (FS_ARM_*, mma_stage.cuh).
struct FsProgram {
  int n_ops;
  int op[FS_MAX_OPS];
  float p0[FS_MAX_OPS];
  int n_stencils;
  StencilDesc st[FS_MAX_STENCILS];
  int arm[FS_MAX_STENCILS];
};

__device__ __forceinline__ bool fs_is_stencil(int op) { return op >= FS_OP_STENCIL; }

// The channel count after pointwise op `op` on `n` channels (what
// pw_apply_one returns), for block-uniform bookkeeping.
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

__host__ __device__ inline size_t fs_align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Dynamic shared memory: two u8 buffers of c_smem planes of the
// (tile_h + 2R) x (128 + 2R) window, then, if any stencil of the stage is
// separable or min/max, one float32 window for the row pass.
__host__ __device__ inline size_t fs_smem_bytes(int c_smem, int tile_h, int halo,
                                                bool two_pass) {
  const size_t plane = (size_t)(tile_h + 2 * halo) * (FS_TILE_W + 2 * halo);
  size_t bytes = 2 * fs_align16((size_t)c_smem * plane);
  if (two_pass) bytes += plane * sizeof(float);
  return bytes;
}

// Geometry of one block's window: window position (wy, wx) is global
// position (y0 - R + wy, x0 - R + wx).
struct FsWindow {
  int H, W;    // image
  int y0, x0;  // first output row and column of the tile
  int R;       // stage halo
  int eh, ew;  // window height and width
  int plane;   // eh * ew bytes
};

// Loops over a rectangle of the window without integer division: warp w
// takes rows y_lo + w, y_lo + w + FS_WARPS, ..., its lanes the columns.
#define FS_FOR_ROWS(wy, y_lo, y_hi) \
  for (int wy = (y_lo) + (int)(threadIdx.x >> 5); wy < (y_hi); wy += FS_WARPS)
#define FS_FOR_COLS(wx, x_lo, x_hi) \
  for (int wx = (x_lo) + (int)(threadIdx.x & 31); wx < (x_hi); wx += 32)

// Rewrites the out-of-image positions of the current window (rows and
// columns [off, e - off)) of `n_planes` planes per the edge mode of the
// next stencil, from in-image positions of the same window.
__device__ void fs_edge_fix(unsigned char* a, int n_planes, const FsWindow& w,
                            int off, int mode) {
  // in-image rows and columns of the current window, in window coordinates
  const int lo_y = max(off, w.R - w.y0), hi_y = min(w.eh - off, w.H - w.y0 + w.R) - 1;
  const int lo_x = max(off, w.R - w.x0), hi_x = min(w.ew - off, w.W - w.x0 + w.R) - 1;
  const bool zero = mode == ST_EDGE_INTERIOR || mode == ST_EDGE_ZERO;
  FS_FOR_ROWS(wy, off, w.eh - off) {
    const bool row_in = wy >= lo_y && wy <= hi_y;
    // the op's source, then kept inside the in-image part of the window
    // (only positions no kept output reaches would leave it)
    const int sy = min(max(st_src(w.y0 - w.R + wy, w.H, mode) - w.y0 + w.R, lo_y), hi_y);
    FS_FOR_COLS(wx, off, w.ew - off) {
      if (row_in && wx >= lo_x && wx <= hi_x) continue;
      const int dst = wy * w.ew + wx;
      if (zero) {
        for (int c = 0; c < n_planes; ++c) a[c * w.plane + dst] = 0;
        continue;
      }
      const int sx = min(max(st_src(w.x0 - w.R + wx, w.W, mode) - w.x0 + w.R, lo_x), hi_x);
      const int src = sy * w.ew + sx;
      for (int c = 0; c < n_planes; ++c) a[c * w.plane + dst] = a[c * w.plane + src];
    }
  }
}

// One stencil from buffer `a` into buffer `b` over the window shrunk by
// `off` (input) and `off + KS / 2` (output), `n_planes` planes.
template <int KS>
__device__ void fs_stencil(const unsigned char* a, unsigned char* b, float* s_row,
                           int n_planes, const FsWindow& w, int off,
                           const StencilDesc& st) {
  constexpr int h = KS / 2;
  const int o = off + h;
  const int gy0 = w.y0 - w.R, gx0 = w.x0 - w.R;
  const bool two_pass = st_two_pass(st.family);
  for (int c = 0; c < n_planes; ++c) {
    const unsigned char* ap = a + c * w.plane;
    if (two_pass) {
      FS_FOR_ROWS(wy, off, w.eh - off) {
        FS_FOR_COLS(wx, o, w.ew - o) {
          s_row[wy * w.ew + wx] = st_row_pass<KS>(ap + wy * w.ew + wx - h, st);
        }
      }
      __syncthreads();
    }
    FS_FOR_ROWS(wy, o, w.eh - o) {
      FS_FOR_COLS(wx, o, w.ew - o) {
        const int idx = wy * w.ew + wx;
        float res;
        if (!st_filtered(gy0 + wy, gx0 + wx, w.H, w.W, h, st.edge_mode)) {
          res = (float)ap[idx];
        } else if (two_pass) {
          res = st_finish(st_col_pass<KS>(s_row + idx - h * w.ew, w.ew, st), st);
        } else {
          res = st_finish(st_window<KS>(ap + idx - h * w.ew - h, w.ew, st), st);
        }
        b[c * w.plane + idx] = pw_to_u8(res);
      }
    }
    if (two_pass) __syncthreads();  // before the next plane's row pass
  }
  __syncthreads();
}

// K5: one stencil on a tensor-core arm, with the contract of fs_stencil:
// from buffer `a` into buffer `b` over the window shrunk by `off` (input)
// and `off + KS / 2` (output), `n_planes` planes. Each warp takes 16 x 8
// tiles of the output region in turn (mma_stage.cuh); each lane finalizes
// and stores the four outputs it holds that lie in the region.
template <int KS>
__device__ void fs_stencil_mma(const unsigned char* a, unsigned char* b, int n_planes,
                               const FsWindow& w, int off, const StencilDesc& st, int arm) {
  constexpr int h = KS / 2;
  const int o = off + h;
  const int gy0 = w.y0 - w.R, gx0 = w.x0 - w.R;
  const int y_end = w.eh - o, x_end = w.ew - o;  // the output region [o, y_end) x [o, x_end)
  const int n_tx = (x_end - o + 7) / 8;
  const int n_tiles = (y_end - o + 15) / 16 * n_tx;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool two = st.family == ST_MAGNITUDE;
  const bool int8 = arm == FS_ARM_INT8;
  const float corr0 = int8 ? mma_corr128<KS>(st.w0) : 0.0f;
  const float corr1 = int8 && two ? mma_corr128<KS>(st.w1) : 0.0f;
  for (int c = 0; c < n_planes; ++c) {
    const MmaSrc src = {a + c * w.plane, w.ew, off, w.eh - off, off, w.ew - off};
    for (int tile = threadIdx.x >> 5; tile < n_tiles; tile += FS_WARPS) {
      const int r0 = o + tile / n_tx * 16, c0 = o + tile % n_tx * 8;
      float acc0[4], acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (int8) {
        mma_tile_int8<KS>(acc0, src, st.w0, corr0, r0, c0, g, t);
        if (two) mma_tile_int8<KS>(acc1, src, st.w1, corr1, r0, c0, g, t);
      } else {
        mma_tile_bf16<KS>(acc0, src, st.w0, r0, c0, g, t);
        if (two) mma_tile_bf16<KS>(acc1, src, st.w1, r0, c0, g, t);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int wy = r0 + g + (i >> 1) * 8, wx = c0 + 2 * t + (i & 1);
        if (wy >= y_end || wx >= x_end) continue;
        const int idx = wy * w.ew + wx;
        float res;
        if (!st_filtered(gy0 + wy, gx0 + wx, w.H, w.W, h, st.edge_mode)) {
          res = (float)src.p[idx];
        } else {
          res = st_finish(two ? mma_magnitude(acc0[i], acc1[i]) : acc0[i], st);
        }
        b[c * w.plane + idx] = pw_to_u8(res);
      }
    }
  }
  __syncthreads();
}

// A stage with no stencil (gray2rgb alone, a pointwise run): one pixel a
// thread a step over the flat image, in a kernel of its own so that its
// few registers keep the SM full (the stencil kernel's register count
// would halve its occupancy).
__global__ void __launch_bounds__(FS_THREADS)
fused_stage_pointwise_kernel(const unsigned char* __restrict__ in,
                             unsigned char* __restrict__ out, long long n_pix,
                             int c_in, int c_out, const __grid_constant__ FsProgram prog) {
  const long long stride = (long long)gridDim.x * FS_THREADS;
  for (long long p = (long long)blockIdx.x * FS_THREADS + threadIdx.x; p < n_pix;
       p += stride) {
    float v[3];
    pw_load(in + p * c_in, v, c_in);
    int n = c_in;
    for (int k = 0; k < prog.n_ops; ++k) n = pw_apply_one(prog.op[k], prog.p0[k], v, n);
    for (int c = 0; c < c_out; ++c) out[p * c_out + c] = pw_to_u8(v[c]);
  }
}

template <bool kMma>
__global__ void __launch_bounds__(FS_THREADS, kMma ? FS_MMA_MIN_BLOCKS : FS_MIN_BLOCKS)
fused_stage_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
                   int H, int W, int c_in, int c_smem, int c_out, int halo,
                   int tile_h, const __grid_constant__ FsProgram prog, int in_row0,
                   int in_rows, int out_row0, int out_rows) {
  // `in` holds global rows [in_row0, in_row0 + in_rows) and `out` global
  // rows [out_row0, out_row0 + out_rows) of an image H rows high: the whole
  // image in full mode, one extended shard tile and its shard in ghost mode.
  const int n_ops = prog.n_ops;
  const int x0 = blockIdx.x * FS_TILE_W;
  const int y0 = out_row0 + blockIdx.y * tile_h;
  const int rows = min(tile_h, out_row0 + out_rows - y0), cols = min(FS_TILE_W, W - x0);

  // the first stencil (stages without one go to fused_stage_pointwise_kernel)
  int first = 0;
  while (first < n_ops && !fs_is_stencil(prog.op[first])) ++first;

  extern __shared__ __align__(16) unsigned char smem[];
  FsWindow w;
  w.H = H;
  w.W = W;
  w.y0 = y0;
  w.x0 = x0;
  w.R = halo;
  w.eh = tile_h + 2 * halo;
  w.ew = FS_TILE_W + 2 * halo;
  w.plane = w.eh * w.ew;
  unsigned char* a = smem;
  unsigned char* b = smem + fs_align16((size_t)c_smem * w.plane);
  float* s_row = reinterpret_cast<float*>(b + fs_align16((size_t)c_smem * w.plane));

  // 1. Window load (indices clamped into the array: the values outside the
  // image are replaced by the first stencil's edge fix, and rows past the
  // array feed only outputs that are not stored), leading pointwise ops, u8
  // planes into shared memory.
  int n_cur = c_in;
  for (int k = 0; k < first; ++k) n_cur = fs_channels_after(prog.op[k], n_cur);
  FS_FOR_ROWS(wy, 0, w.eh) {
    const long long row =
        (long long)min(max(y0 - halo + wy - in_row0, 0), in_rows - 1) * W;
    FS_FOR_COLS(wx, 0, w.ew) {
      const int gx = min(max(x0 - halo + wx, 0), W - 1);
      float v[3];
      pw_load(in + (row + gx) * c_in, v, c_in);
      int n = c_in;
      for (int k = 0; k < first; ++k) n = pw_apply_one(prog.op[k], prog.p0[k], v, n);
      for (int c = 0; c < n_cur; ++c) a[c * w.plane + wy * w.ew + wx] = pw_to_u8(v[c]);
    }
  }
  __syncthreads();

  // 2. The stage walk: each stencil with its edge fix, then the pointwise
  // run up to the next stencil, in place.
  int off = 0;  // halo consumed so far
  int k = first;
  while (k < n_ops) {
    const int j = prog.op[k] - FS_OP_STENCIL;
    const StencilDesc& st = prog.st[j];
    if (st.halo > 0) {
      // blocks whose window lies inside the image skip the fix (uniform)
      const bool inside = y0 - halo + off >= 0 && y0 + tile_h + halo - off <= H &&
                          x0 - halo + off >= 0 && x0 + FS_TILE_W + halo - off <= W;
      if (!inside) {
        fs_edge_fix(a, n_cur, w, off, st.edge_mode);
        __syncthreads();
      }
    }
    bool on_mma = false;
    if constexpr (kMma) {
      const int arm = prog.arm[j];  // block-uniform
      on_mma = arm != FS_ARM_VPU;
      switch (on_mma ? st.ksize : 0) {
        case 1: fs_stencil_mma<1>(a, b, n_cur, w, off, st, arm); break;
        case 3: fs_stencil_mma<3>(a, b, n_cur, w, off, st, arm); break;
        case 5: fs_stencil_mma<5>(a, b, n_cur, w, off, st, arm); break;
        case 7: fs_stencil_mma<7>(a, b, n_cur, w, off, st, arm); break;
        default: break;
      }
    }
    if (!on_mma) {
      switch (st.ksize) {
        case 1: fs_stencil<1>(a, b, s_row, n_cur, w, off, st); break;
        case 3: fs_stencil<3>(a, b, s_row, n_cur, w, off, st); break;
        case 5: fs_stencil<5>(a, b, s_row, n_cur, w, off, st); break;
        case 7: fs_stencil<7>(a, b, s_row, n_cur, w, off, st); break;
        default: break;  // rejected on the host
      }
    }
    unsigned char* t = a;
    a = b;
    b = t;
    off += st.halo;
    ++k;
    int end = k;
    while (end < n_ops && !fs_is_stencil(prog.op[end])) ++end;
    if (end == n_ops) break;  // the trailing run rides the store
    if (end > k) {
      int n_next = n_cur;
      for (int j = k; j < end; ++j) n_next = fs_channels_after(prog.op[j], n_next);
      FS_FOR_ROWS(wy, off, w.eh - off) {
        FS_FOR_COLS(wx, off, w.ew - off) {
          const int idx = wy * w.ew + wx;
          float v[3] = {0.0f, 0.0f, 0.0f};
          for (int c = 0; c < n_cur; ++c) v[c] = (float)a[c * w.plane + idx];
          int n = n_cur;
          for (int j = k; j < end; ++j) n = pw_apply_one(prog.op[j], prog.p0[j], v, n);
          for (int c = 0; c < n_next; ++c) a[c * w.plane + idx] = pw_to_u8(v[c]);
        }
      }
      n_cur = n_next;
      k = end;
      __syncthreads();
    }
  }

  // 3. Store the tile (off == halo here), through the trailing pointwise run.
  FS_FOR_ROWS(ly, 0, rows) {
    FS_FOR_COLS(lx, 0, cols) {
      const int idx = (ly + halo) * w.ew + lx + halo;
      float v[3] = {0.0f, 0.0f, 0.0f};
      for (int c = 0; c < n_cur; ++c) v[c] = (float)a[c * w.plane + idx];
      int n = n_cur;
      for (int j = k; j < n_ops; ++j) n = pw_apply_one(prog.op[j], prog.p0[j], v, n);
      unsigned char* q = out + ((long long)(y0 - out_row0 + ly) * W + x0 + lx) * c_out;
      for (int c = 0; c < c_out; ++c) q[c] = pw_to_u8(v[c]);
    }
  }
}

static bool fs_any_two_pass(const FsProgram* prog) {
  for (int j = 0; j < prog->n_stencils; ++j) {
    if (st_two_pass(prog->st[j].family)) return true;
  }
  return false;
}

// Whether any stencil takes a tensor-core arm (then the tensor-core
// instantiation runs the stage), or -1 when an arm is unknown or given to a
// family K5 has no form for (the host never encodes either).
static int fs_any_mma(const FsProgram* prog) {
  int any = 0;
  for (int j = 0; j < prog->n_stencils; ++j) {
    const int arm = prog->arm[j], fam = prog->st[j].family;
    if (arm == FS_ARM_VPU) continue;
    if (arm != FS_ARM_BF16 && arm != FS_ARM_INT8) return -1;
    if (fam != ST_CORR && fam != ST_MAGNITUDE && fam != ST_SEPARABLE) return -1;
    any = 1;
  }
  return any;
}

// Launches the stage on `stream` over the rows described at the kernel.
// `c_smem` is the most channels the stage holds in shared memory. Returns
// cudaGetLastError() after the launch.
static int fs_launch(const unsigned char* in, unsigned char* out, int H, int W,
                     int c_in, int c_smem, int c_out, int halo, int tile_h,
                     const FsProgram* prog, int in_row0, int in_rows, int out_row0,
                     int out_rows, void* stream) {
  if (out_rows <= 0 || W <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (prog->n_stencils == 0) {  // halo 0: `in` and `out` hold the same rows
    const long long n_pix = (long long)out_rows * W;
    long long blocks = (n_pix + FS_THREADS - 1) / FS_THREADS;
    if (blocks > 132LL * 16) blocks = 132LL * 16;  // 16 resident blocks per SM, as K1
    fused_stage_pointwise_kernel<<<(unsigned)blocks, FS_THREADS, 0, s>>>(
        in, out, n_pix, c_in, c_out, *prog);
    return (int)cudaGetLastError();
  }
  const int mma = fs_any_mma(prog);
  if (mma < 0) return (int)cudaErrorInvalidValue;
  const auto kernel = mma ? fused_stage_kernel<true> : fused_stage_kernel<false>;
  const size_t smem = fs_smem_bytes(c_smem, tile_h, halo, fs_any_two_pass(prog));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + FS_TILE_W - 1) / FS_TILE_W, (out_rows + tile_h - 1) / tile_h);
  kernel<<<grid, FS_THREADS, smem, s>>>(
      in, out, H, W, c_in, c_smem, c_out, halo, tile_h, *prog, in_row0, in_rows,
      out_row0, out_rows);
  return (int)cudaGetLastError();
}

// K4: one fused stage over a whole (H, W) image.
extern "C" int fused_stage_launch(const unsigned char* in, unsigned char* out, int H,
                                  int W, int c_in, int c_smem, int c_out, int halo,
                                  int tile_h, const FsProgram* prog, void* stream) {
  return fs_launch(in, out, H, W, c_in, c_smem, c_out, halo, tile_h, prog, 0, H, 0, H,
                   stream);
}

// K4g: one fused stage over a (local_h + 2 halo, W) extended shard tile
// whose shard starts at global row `row0` of an image `image_h` rows high;
// writes the shard's (local_h, W) rows.
extern "C" int fused_stage_ext_launch(const unsigned char* ext, unsigned char* out,
                                      int local_h, int W, int c_in, int c_smem,
                                      int c_out, int halo, int tile_h,
                                      const FsProgram* prog, int row0, int image_h,
                                      void* stream) {
  return fs_launch(ext, out, image_h, W, c_in, c_smem, c_out, halo, tile_h, prog,
                   row0 - halo, local_h + 2 * halo, row0, local_h, stream);
}

// K5's exactness probe: the raw f32 sums of one kernel of stencil `st`
// (w0, or w1 when `second`) over a (rows, cols) u8 plane in device memory,
// valid mode, into a (rows - KS + 1, cols - KS + 1) f32 array. One warp a
// 16 x 8 output tile, through the tile functions K5 runs (mma_stage.cuh),
// so the sums are those K5 finalizes; the u8 rounding and clip of K5's
// output hide their low bits wherever the result leaves 0..255, which
// this output does not.
template <int KS>
__global__ void __launch_bounds__(FS_THREADS)
k5_sums_kernel(const unsigned char* __restrict__ in, float* __restrict__ out, int rows,
               int cols, const __grid_constant__ StencilDesc st, int second, int arm) {
  constexpr int h = KS / 2;
  const int out_rows = rows - 2 * h, out_cols = cols - 2 * h;
  const int n_tx = (out_cols + 7) / 8;
  const int tile = blockIdx.x * FS_WARPS + (int)(threadIdx.x >> 5);
  if (tile >= (out_rows + 15) / 16 * n_tx) return;  // the whole warp
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const MmaSrc src = {in, cols, 0, rows, 0, cols};
  const int r0 = h + tile / n_tx * 16, c0 = h + tile % n_tx * 8;
  const float* w = second ? st.w1 : st.w0;
  float acc[4];
  if (arm == FS_ARM_INT8) {
    mma_tile_int8<KS>(acc, src, w, mma_corr128<KS>(w), r0, c0, g, t);
  } else {
    mma_tile_bf16<KS>(acc, src, w, r0, c0, g, t);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = r0 - h + g + (i >> 1) * 8, x = c0 - h + 2 * t + (i & 1);
    if (y < out_rows && x < out_cols) out[(long long)y * out_cols + x] = acc[i];
  }
}

extern "C" int k5_sums_launch(const unsigned char* in, float* out, int rows, int cols,
                              const StencilDesc* st, int second, int arm, void* stream) {
  const int h = st->ksize / 2;
  if (arm != FS_ARM_BF16 && arm != FS_ARM_INT8) return (int)cudaErrorInvalidValue;
  if (rows <= 2 * h || cols <= 2 * h) return 0;
  const long long tiles = (long long)(rows - 2 * h + 15) / 16 * ((cols - 2 * h + 7) / 8);
  const unsigned blocks = (unsigned)((tiles + FS_WARPS - 1) / FS_WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (st->ksize) {
    case 1: k5_sums_kernel<1><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, *st, second, arm); break;
    case 3: k5_sums_kernel<3><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, *st, second, arm); break;
    case 5: k5_sums_kernel<5><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, *st, second, arm); break;
    case 7: k5_sums_kernel<7><<<blocks, FS_THREADS, 0, s>>>(in, out, rows, cols, *st, second, arm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory one launch needs, and the program's size, for the
// host-side checks.
extern "C" long long fused_stage_smem_bytes(int c_smem, int tile_h, int halo,
                                            int two_pass) {
  return (long long)fs_smem_bytes(c_smem, tile_h, halo, two_pass != 0);
}

extern "C" long long fused_stage_program_bytes() { return (long long)sizeof(FsProgram); }
