// K4: fused gather RoIAlign for NVIDIA Hopper (sm_90a), one launch per
// cascade stage.
//
// Replaces the TPU kernel nuhtc_tpu/ops/roi_align_pallas.py:126
// roi_align_pallas_batched (body _make_kernel :42) by its purpose, not its
// code: mmcv RoIAlign(aligned=True, pool_mode='avg') on channels-last maps,
// summed over up to three maps that share one set of boxes:
//   feat_l (B, H_l, W_l, C) bf16 or f32, each with its own scale, sampling
//   ratio and pool_from; rois (B, R, 4) f32 [x1, y1, x2, y2] in image
//   coordinates; bias (B, R, C) f32 or none
//   -> out (B, R, out, out, C) = sum_l RoIAlign(feat_l) + bias, in the maps'
//   type: f32 sums, one rounding at the store.
// Per RoI, map and axis: start = x1*scale - 0.5, extent = x2*scale - 0.5 -
// start, bin = extent / out; each output bin averages grid_h x grid_w
// bilinear samples at start + i*bin + (s + 0.5)*bin/grid. The grid is
//   sampling_ratio                                    when it is > 0,
//   clamp(ceil(extent / out), 1, max_grid)            when it is 0 (adaptive),
//   k * clamp(ceil(extent / pool_from), 1, max_grid)  with pool_from = k*out:
//     the exact fusion of adaptive_avg_pool2d(RoIAlign(pool_from), out).
// A sample with coordinate < -1 or > size weighs 0; others clamp to
// [0, size - 1] and interpolate between floor and floor + 1 (clamped).
//
// What bounds it on the H100. By the count of bytes moved once and of
// operations in their cheapest exact form, bytes, with operations close: a
// bbox stage (B16, R1512, out 7, C64, bf16) writes 151.7 MB and reads 75 MB of
// maps and 6 MB of bias, against one multiply-add per channel and map cell
// under a bin. What the kernel really spends is instruction slots: a cell under a
// bin costs a thread one 16-byte load, 8 bf16-to-f32 conversions, 8
// multiply-adds and some ten more operations of list reading, addressing and
// loop, and with the loads compiled out it keeps about half of its time; a
// fifth is the start of a block and its geometry; the rest is the latency of
// the loads, which the L2 serves (the maps stay there). The design:
// - One launch for the whole stage. The sums over the maps and the bias stay
//   in registers; nothing but the result is written, and no elementwise pass
//   over (B, R, out, out, C) tensors follows.
// - Geometry once per RoI, map, axis and bin, in shared memory. One thread
//   per (map, axis, bin) walks the bin's samples with the round-to-nearest
//   intrinsics in the plain PyTorch version's order, so the validity tests
//   (y < -1, y > size) and ceil() cut at the same boxes. No other thread
//   divides.
// - Cell weights, not samples. That thread folds its bin's samples into a
//   short list of (weight, cell) entries, one per distinct cell (the non-zero
//   entries of the plain version's rows of Sy and Sx). A bin then loads each
//   cell under it once and does one multiply for the cell's weight and one
//   multiply-add per channel: the same function in another order of f32 sums.
//   A list holds at most 2*grid entries whatever the box's size, so there is
//   no window, no size limit and no dense fallback.
// - Few instructions around a cell: the loop over the maps is unrolled (their
//   parameters are constants, their bases uniform), an item's bin and channel
//   group come from the previous item's without a division, the lists hold
//   byte offsets, and a bf16 becomes an f32 by one shift or one mask.
// - Channels are innermost. A thread owns one output bin and VEC channels
//   (16 bytes), neighbouring threads neighbouring channel groups: at C = 64
//   bf16 eight threads read one cell as one 128-byte line, and a warp writes
//   512 contiguous bytes of output.
// - Blocks are RoIs in image-major order, so the maps of one image (4.7 MB
//   at the main path's shapes) are what is live in the 50 MB L2. Work by
//   size is the hardware's block scheduler's: with five blocks a SM, a large
//   box shares its SM with small ones, and sorting the boxes by area moved
//   the time by 5 % at most. The register budget (56: 5 blocks of 224
//   threads a SM) decides more than the unrolling.
// - Tried on the card and dropped: staging each RoI's window of cells in
//   shared memory so that bins share loads (no gain: the L1 and L2 already
//   serve the re-reads), a row weight applied once per row of cells (more
//   instructions than a multiply per cell while a bin has few cells a row),
//   more or fewer registers per thread, deeper unrolling; a large RoI's
//   items dealt to 2 to 7 blocks (a fifth off a mask-stage call whose boxes
//   are one sixteenth large, but the small RoIs' idle blocks cost a launch
//   without large boxes a tenth, and a forward has few large boxes). Not
//   tried: a block's warps sharing a bin's rows of cells.
//
// The backward (roi_align_sum_backward_launch) is the same sum read the other
// way. In the JAX package this gradient is XLA's autodiff of the exact or
// banded RoIAlign of nuhtc_tpu/ops/roi_align.py:276 (the Pallas kernel never
// trains). For every map
//   grad_map[b, y, x, c] = sum over RoIs, bins and samples of
//                          w(sample, cell) * grad_out[b, r, i, j, c]
// with the forward's geometry (the same cell lists), and
//   grad_bias[b, r, c] = sum over bins of grad_out[b, r, i, j, c].
// Gradients of the boxes are not taken: the detector feeds detached boxes.
// What bounds it: bytes, as for the forward: grad_out read once and each
// map's gradient written once, 363.8 MB a train step (B8: three cascade calls
// at R1024 out 7 over maps of 128², 64² and 128², one mask call at R256 out
// 14, C64, bf16), 0.109 ms at 3.35 TB/s.
// The first design scattered: a block per RoI, a thread per (bin, channel
// group), and every cell under a bin took its channels in float4 atomicAdds
// into an f32 buffer per map (zero-filled by the wrapper, rounded to bf16 by
// a second kernel). It took 6.4-8.4 ms a step (25.5 with scalar atomics), 6-9
// times the forward over the same cells: the train step's RoIs cluster on ~40
// nuclei a tile, so many RoIs add into the same cells and the atomics
// serialise in the L2; and they add in no fixed order, so the sums changed in
// their last bits from run to run.
// This design gathers, in a fixed order, and has no atomic and no f32 buffer:
// - A first launch (roi_backward_prep_kernel) computes, for every RoI and
//   map, the footprint of its sampling: the span of the cells in its row and
//   column lists, from bin_cells called as the forward calls it (with cells,
//   not byte offsets); and the bias gradient, each (RoI, channel) summed over
//   the bins in bin order by one thread.
// - The second launch (roi_align_sum_backward_kernel) gives a block one
//   8 x 8 tile of one map's gradient in one image, over 64 channels (8
//   groups of VEC). It walks that image's RoIs in index order, keeps those
//   whose footprint meets the tile (a ballot and an ordered compaction), and
//   takes the kept ones 8 at a time: their cell lists by bin_cells, folded
//   into per-bin weight rows over the tile's rows and columns; per tile cell
//   and axis the bins that weigh on it and the first four weights in one
//   float4; the grad_out of the bins that weigh on the tile, copied into the
//   shared memory that held the lists (as many RoIs a round as fit). A
//   thread owns two cells of one column and 8 channels, and adds
//   w_y * w_x * grad_out into registers, RoI by RoI, row bin by row bin,
//   column bin by column bin (the weights are separable; a cell under at
//   most 4 x 4 bins, the usual case, takes an unrolled path whose loads are
//   all in flight at once), then stores each cell once, in the map's type.
// Every sum runs in an order fixed by the inputs, so two calls give equal
// bits. The time is the accumulation's instructions, not bytes: compiled out
// (on the card, behind a temporary switch), the filter, the lists and the
// barriers kept a small part of the launch's time; the loads and the loop
// around them took the rest, which the unrolled path and the staged grad_out
// cut. Tiles under dense nuclei see hundreds of RoIs, and every RoI that
// meets a tile costs each of its threads a pass over the RoI's ranges. Tried
// on the card and dropped: tiles of 16 x 16 (a thread walks the RoIs of a
// larger area for its cells) and of 4 x 4 with 128 threads (a RoI's lists
// built in four times the tiles), batches of 16 RoIs and 4 channel groups a
// block; the compiler's own register count (80-121) lost to a budget of 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_MAPS = 3;

template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Pack<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    // a bf16 is the upper half of an f32: one shift or one mask per value
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <>
struct Pack<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

// The blocks per SM the kernel is compiled for (its register budget: 56 at 5
// blocks of 224 threads) and the unrolling of the loop over a bin's cells in
// a row. Both were settled by timing on the card; more registers or fewer
// blocks lost every time.
constexpr int MAX_THREADS = 224;
constexpr int MIN_BLOCKS = 5;
constexpr int X_UNROLL = 2;

struct MapArg {
  const void* feat;  // (B, H, W, C)
  int H, W, sampling_ratio, pool_from;
  float scale;
  int ent_base, ent_cap;  // first entry of this map's lists, entries per list
};

struct Args {
  MapArg map[MAX_MAPS];
  const float* rois;  // (B, R, 4)
  const float* bias;  // (B, R, C) or null
  void* out;          // (B, R, out, out, C)
  int n_maps, R, C, out_size, max_grid;
  int total_ent;  // float2 entries of all lists
};

// A bin's list of {weight, byte offset of the cell} entries while it is built:
// the last two entries wait in registers, where a later sample's cell meets them.
// Samples come in the order of their coordinates, so a cell that returns is
// one of those two; were it not, it would get a second entry, and the sums
// would still be right.
struct CellList {
  float2* e;
  int n, ca, cb;  // entries written; offsets of the two waiting (-1: none)
  float wa, wb;

  __device__ __forceinline__ void add(int cell, float w) {
    if (w == 0.0f) return;
    if (cell == cb) {
      wb += w;
      return;
    }
    if (cell == ca) {
      wa += w;
      return;
    }
    if (ca >= 0) e[n++] = make_float2(wa, __int_as_float(ca));
    ca = cb;
    wa = wb;
    cb = cell;
    wb = w;
  }

  __device__ __forceinline__ int finish() {
    if (ca >= 0) e[n++] = make_float2(wa, __int_as_float(ca));
    if (cb >= 0) e[n++] = make_float2(wb, __int_as_float(cb));
    return n;
  }
};

// The cell list of bin i on one axis of `size` cells of one RoI and map: c0,
// c1 are the box's image coordinates on this axis, `stride` the bytes between
// neighbouring cells. Returns its length. Not inlined, so that its registers
// are not the accumulation loop's.
__device__ __noinline__ int bin_cells(float2* e, float c0, float c1, float scale, int i, int size,
                                      int stride, int out_size, int sampling_ratio, int max_grid,
                                      int pool_from) {
  const float start = __fsub_rn(__fmul_rn(c0, scale), 0.5f);
  const float extent = __fsub_rn(__fsub_rn(__fmul_rn(c1, scale), 0.5f), start);
  const float bin = __fdiv_rn(extent, (float)out_size);
  int grid;
  if (pool_from > 0) {
    const float g = fminf(fmaxf(ceilf(__fdiv_rn(extent, (float)pool_from)), 1.0f), (float)max_grid);
    grid = (pool_from / out_size) * (int)g;
  } else if (sampling_ratio > 0) {
    grid = sampling_ratio;
  } else {
    grid = (int)fminf(fmaxf(ceilf(bin), 1.0f), (float)max_grid);
  }
  const float gridf = (float)grid;
  const float w = __fdiv_rn(1.0f, gridf);
  const float lo_edge = __fadd_rn(start, __fmul_rn((float)i, bin));
  const bool rising = !(bin < 0.0f);
  CellList list = {e, 0, -1, -1, 0.0f, 0.0f};
  for (int k = 0; k < grid; ++k) {
    const int s = rising ? k : grid - 1 - k;
    const float y = __fadd_rn(lo_edge, __fdiv_rn(__fmul_rn((float)s + 0.5f, bin), gridf));
    if (y < -1.0f || y > (float)size) continue;
    float yc = fminf(fmaxf(y, 0.0f), (float)(size - 1));
    int l = (int)floorf(yc);
    if (l >= size - 1) {
      l = size - 1;
      yc = (float)l;
    }
    const float frac = yc - (float)l;
    list.add(l * stride, (1.0f - frac) * w);
    list.add(min(l + 1, size - 1) * stride, frac * w);
  }
  return list.finish();
}

// One block per RoI, blockIdx.x = b * R + r. A thread owns bin (i, j) and
// channels [cg*VEC, cg*VEC + VEC) of the output. Shared memory:
//   the cell lists, float2 {weight, byte offset}: map l's list of axis a (0 is
//     y) and bin i starts at entry ent_base + (a * out + i) * ent_cap;
//   count[n_maps * 2 * out], the lists' lengths.
// The accumulation loop is written for few instructions, which is what
// it spends: the maps unrolled (their parameters are then constants and their
// bases uniform), no division per item, one multiply for a cell's weight and
// VEC multiply-adds, 32-bit byte offsets onto a uniform base.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) roi_align_sum_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ float2 ent[];
  const int out_size = a.out_size, C = a.C;
  const int lists = a.n_maps * 2 * out_size;
  int* count = reinterpret_cast<int*>(ent + a.total_ent);
  const long long roi = blockIdx.x;
  const int b = (int)(roi / a.R);

  // geometry: one thread per list
  const float* box = a.rois + roi * 4;
  for (int t = threadIdx.x; t < lists; t += blockDim.x) {
    const int l = t / (2 * out_size), rem = t - l * 2 * out_size;
    const int axis = rem >= out_size, i = rem - axis * out_size;
    const MapArg& m = a.map[l];
    const int cell_bytes = C * (int)sizeof(T);
    count[t] = bin_cells(ent + m.ent_base + rem * m.ent_cap, box[1 - axis], box[3 - axis], m.scale,
                         i, axis ? m.W : m.H, axis ? cell_bytes : m.W * cell_bytes, out_size,
                         m.sampling_ratio, a.max_grid, m.pool_from);
  }
  __syncthreads();

  T* dst = static_cast<T*>(a.out) + roi * out_size * out_size * C;
  const float* bias = a.bias ? a.bias + roi * C : nullptr;
  const int groups = C / VEC;
  const int items = out_size * out_size * groups;
  // the thread's item as (bin row i, bin column j, channel group cg) and the
  // step to its next item, so that no item divides
  const int step = blockDim.x;
  int cg = threadIdx.x % groups, j = threadIdx.x / groups, i = j / out_size;
  j -= i * out_size;
  const int dcg = step % groups, di = step / groups / out_size;
  const int dj = step / groups - di * out_size;
  for (int it = threadIdx.x; it < items; it += step) {
    const int c0 = cg * VEC;
    float acc[VEC];
    if (bias) {
      if (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 t = reinterpret_cast<const float4*>(bias + c0)[q];
          acc[4 * q] = t.x; acc[4 * q + 1] = t.y; acc[4 * q + 2] = t.z; acc[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = bias[c0 + v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    }

#pragma unroll
    for (int l = 0; l < MAX_MAPS; ++l) {
      if (l < a.n_maps) {
        const MapArg& m = a.map[l];
        const float2* ey = ent + m.ent_base + i * m.ent_cap;
        const float2* ex = ent + m.ent_base + (out_size + j) * m.ent_cap;
        const int ny = count[l * 2 * out_size + i], nx = count[l * 2 * out_size + out_size + j];
        const char* base = static_cast<const char*>(m.feat) + (size_t)b * m.H * m.W * C * sizeof(T);
        const unsigned c0_bytes = c0 * (unsigned)sizeof(T);
        for (int y = 0; y < ny; ++y) {
          const float2 cy = ey[y];
          const unsigned row = __float_as_uint(cy.y) + c0_bytes;
#pragma unroll X_UNROLL
          for (int x = 0; x < nx; ++x) {
            const float2 cx = ex[x];
            const float w = cy.x * cx.x;
            float val[VEC];
            Pack<T, VEC>::load(reinterpret_cast<const T*>(base + (row + __float_as_uint(cx.y))),
                               val);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = fmaf(w, val[v], acc[v]);
          }
        }
      }
    }
    Pack<T, VEC>::store(dst + ((long long)(i * out_size + j) * C + c0), acc);
    cg += dcg;
    const int carry = cg >= groups;
    cg -= carry * groups;
    j += dj + carry;
    if (j >= out_size) {
      j -= out_size;
      ++i;
    }
    i += di;
  }
}

template <typename T, int VEC>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int lists = a.n_maps * 2 * a.out_size;
  const size_t smem_bytes = (size_t)a.total_ent * sizeof(float2) + lists * sizeof(int);
  if (smem_bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(roi_align_sum_kernel<T, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int items = a.out_size * a.out_size * (a.C / VEC);
  const int passes = (items + MAX_THREADS - 1) / MAX_THREADS;
  int threads = ((items + passes - 1) / passes + 31) / 32 * 32;
  threads = max(64, min(threads, MAX_THREADS));
  const unsigned grid = (unsigned)((long long)B * a.R);
  roi_align_sum_kernel<T, VEC><<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The backward: see the note at the top. A block's tile, its channel groups
// and its threads: a thread owns column tx of the tile and rows ty1 + c *
// ROW_STEP (c < BWD_CELLS) of it, for one group of VEC channels.
constexpr int BWD_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 4;  // blocks a SM: a budget of 64 registers
constexpr int TILE = 8;            // cells of a tile's side
constexpr int BWD_GROUPS = 8;      // channel groups of VEC channels a block owns
constexpr int BWD_CELLS = TILE * TILE * BWD_GROUPS / BWD_THREADS;  // cells a thread owns: 2
constexpr int ROW_STEP = BWD_THREADS / BWD_GROUPS / TILE;          // rows between them: 4
constexpr int MAX_BATCH = 8;     // RoIs whose lists a block builds at once
constexpr int MAX_KEPT = 4096;   // RoIs a block filters before it builds their lists
constexpr int FAST = 4;          // bins per axis on a cell that the unrolled path takes
static_assert(ROW_STEP * BWD_CELLS == TILE && BWD_THREADS % (BWD_GROUPS * TILE) == 0,
              "a thread's cells must cover one column of the tile");
static_assert(FAST == 4 && TILE % 4 == 0, "lead weights are a float4, on 16 bytes");

struct BwdMap {
  void* grad;  // (B, H, W, C) in the maps' type
  int H, W, sampling_ratio, pool_from;
  float scale;
  int tiles_x;     // tiles across the map
  int block_base;  // the map's first block among an image's blocks
};

// grad_out (B, R, out, out, C) in the maps' type; grad_bias (B, R, C) f32 or
// null; span (B, R, n_maps) int4 {y0, y1, x0, x1}: the cells, inclusive, that
// a RoI's lists on a map reach (y0 > y1 when none), written by the first
// launch and read by the second.
struct BwdArgs {
  BwdMap map[MAX_MAPS];
  const float* rois;
  const void* grad_out;
  float* grad_bias;
  int4* span;
  int n_maps, R, C, out_size, max_grid;
  int cap;               // entries of the longest cell list of any map
  int chunks;            // channel chunks of BWD_GROUPS * VEC channels
  int blocks_per_image;  // sum over maps of tiles * chunks
  int batch;             // RoIs whose lists a block builds at once
  int kept_cap;          // RoIs a block filters in one pass
  int lists_floats;      // floats of the lists (and stage) region
  int stage_cap;         // values of T the stage holds
};

// The first launch. Threads [0, n_span): one (RoI, map, axis) each, the span
// of the cells of its out lists. Threads [n_span, n_span + n_bias): one
// (RoI, channel) each, the bias gradient summed over the bins in order.
// Shared memory: blockDim.x lists of `cap` entries.
template <typename T>
__global__ void roi_backward_prep_kernel(const __grid_constant__ BwdArgs a, long long n_span,
                                         long long n_bias) {
  extern __shared__ float2 lists[];
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < n_span) {
    const long long roi = t / (2 * a.n_maps);
    const int rem = (int)(t - roi * 2 * a.n_maps), l = rem >> 1, axis = rem & 1;
    const BwdMap& m = a.map[l];
    const float* box = a.rois + roi * 4;
    float2* e = lists + threadIdx.x * a.cap;
    int lo = 0x7fffffff, hi = -1;
    for (int i = 0; i < a.out_size; ++i) {
      const int n = bin_cells(e, box[1 - axis], box[3 - axis], m.scale, i, axis ? m.W : m.H, 1,
                              a.out_size, m.sampling_ratio, a.max_grid, m.pool_from);
      for (int k = 0; k < n; ++k) {
        const int c = __float_as_int(e[k].y);
        lo = min(lo, c);
        hi = max(hi, c);
      }
    }
    int* s = reinterpret_cast<int*>(a.span + roi * a.n_maps + l) + 2 * axis;
    s[0] = lo;
    s[1] = hi;
  } else if (t - n_span < n_bias) {
    const long long u = t - n_span, roi = u / a.C;
    const int c = (int)(u - roi * a.C), bins = a.out_size * a.out_size;
    const T* g = static_cast<const T*>(a.grad_out) + roi * bins * a.C + c;
    float sum = 0.0f;
    for (int k = 0; k < bins; ++k) {
      float v;
      Pack<T, 1>::load(g + (long long)k * a.C, &v);
      sum += v;
    }
    a.grad_bias[roi * a.C + c] = sum;
  }
}

// VEC values of T from src to dst, as they are (16 bytes when they make 16).
template <typename T, int VEC>
__device__ __forceinline__ void copy_raw(T* dst, const T* src) {
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v] = src[v];
  }
}

// The second launch: one block per (image, map, tile, channel chunk), image
// major. Shared memory, for `batch` RoIs at a time:
//   lists  [batch][2 * out][cap] float2, the cell lists as bin_cells writes
//          them; once folded, the same bytes (stage_cap values of T) hold
//          grad_out of the bins that weigh on the tile, a group of RoIs at a
//          time: RoI k's rectangle of bins rect[k] in row-major order, each
//          bin's BWD_GROUPS * VEC channels of the block's chunk;
//   weight [batch][2 * out][TILE] f32, list i of axis a folded onto the tile's
//          cells of that axis (row (k * 2 + a) * out + i);
//   range  [batch][2][TILE] int, per tile cell the bins [lo, hi) that weigh on
//          it (lo | hi << 16);
//   lead   [batch][2][TILE] float4, per tile cell the weights of bins lo to lo + 3;
//   rect   [batch] int2, per RoI and axis the bins that weigh on the tile;
//   kept   [kept_cap] int, the RoIs of the current pass that meet the tile;
//   warp_n [BWD_THREADS / 32] int, their count per warp.
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS) roi_align_sum_backward_kernel(
    const __grid_constant__ BwdArgs a) {
  extern __shared__ float2 lists[];
  const int out = a.out_size, nlist = 2 * out, K = a.batch;
  T* stage = reinterpret_cast<T*>(lists);
  float* weight = reinterpret_cast<float*>(lists) + a.lists_floats;
  float4* lead = reinterpret_cast<float4*>(weight + K * nlist * TILE);
  int* range = reinterpret_cast<int*>(lead + K * 2 * TILE);
  int2* rect = reinterpret_cast<int2*>(range + K * 2 * TILE);
  int* kept = reinterpret_cast<int*>(rect + K);
  int* warp_n = kept + a.kept_cap;
  constexpr int BIN = BWD_GROUPS * VEC;  // values of a staged bin

  const int b = blockIdx.x / a.blocks_per_image;
  int rem = blockIdx.x - b * a.blocks_per_image;
  int l = 0;
  while (l + 1 < a.n_maps && rem >= a.map[l + 1].block_base) ++l;
  const BwdMap& m = a.map[l];
  rem -= m.block_base;
  const int tile = rem / a.chunks, q = rem - tile * a.chunks;
  const int ty0 = tile / m.tiles_x * TILE, tx0 = (tile % m.tiles_x) * TILE;
  const int groups = a.C / VEC, cg_own = threadIdx.x % BWD_GROUPS;
  const int cg = q * BWD_GROUPS + cg_own;
  const int cell = threadIdx.x / BWD_GROUPS, tx = cell % TILE, ty1 = cell / TILE;
  const bool active = cg < groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* rois = a.rois + (long long)b * a.R * 4;
  const int4* span = a.span + (long long)b * a.R * a.n_maps + l;
  const T* gout = static_cast<const T*>(a.grad_out) + (long long)b * a.R * out * out * a.C;

  float acc[BWD_CELLS][VEC];
#pragma unroll
  for (int k = 0; k < BWD_CELLS; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;

  for (int pass = 0; pass < a.R; pass += a.kept_cap) {
    // the RoIs of this pass whose footprint meets the tile, in index order
    const int end = min(a.R, pass + a.kept_cap);
    int total = 0;
    for (int base = pass; base < end; base += BWD_THREADS) {
      const int r = base + threadIdx.x;
      bool meets = false;
      if (r < end) {
        const int4 s = span[(long long)r * a.n_maps];
        meets = s.x <= ty0 + TILE - 1 && s.y >= ty0 && s.z <= tx0 + TILE - 1 && s.w >= tx0;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, meets);
      if (lane == 0) warp_n[warp] = __popc(vote);
      __syncthreads();
      int before = 0, n = 0;
#pragma unroll
      for (int w = 0; w < BWD_THREADS / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        n += warp_n[w];
      }
      if (meets) kept[total + before + __popc(vote & ((1u << lane) - 1u))] = r;
      total += n;
      __syncthreads();
    }

    for (int k0 = 0; k0 < total; k0 += K) {
      const int nk = min(K, total - k0);
      // the lists of nk RoIs, each folded onto the tile's cells of its axis
      for (int t = threadIdx.x; t < nk * nlist; t += BWD_THREADS) {
        const int k = t / nlist, li = t - k * nlist, axis = li >= out, i = li - axis * out;
        const float* box = rois + kept[k0 + k] * 4;
        float2* e = lists + t * a.cap;
        const int n = bin_cells(e, box[1 - axis], box[3 - axis], m.scale, i, axis ? m.W : m.H, 1,
                                out, m.sampling_ratio, a.max_grid, m.pool_from);
        float* row = weight + t * TILE;
#pragma unroll
        for (int c = 0; c < TILE; ++c) row[c] = 0.0f;
        const int first = axis ? tx0 : ty0;
        for (int s = 0; s < n; ++s) {
          const int d = __float_as_int(e[s].y) - first;
          if (d >= 0 && d < TILE) row[d] += e[s].x;
        }
      }
      __syncthreads();
      // per RoI, axis and tile cell the bins that weigh on the cell, and per
      // RoI and axis their union over the tile (TILE neighbouring threads;
      // batch * 2 * TILE <= BWD_THREADS, so one round)
      {
        const int t = threadIdx.x;
        int lo = out, hi = 0;
        if (t < nk * 2 * TILE) {
          const float* col = weight + (t / TILE) * out * TILE + t % TILE;
          for (int i = 0; i < out; ++i) {
            if (col[i * TILE] != 0.0f) {
              lo = min(lo, i);
              hi = i + 1;
            }
          }
          range[t] = lo | (hi << 16);
          float w[FAST];
#pragma unroll
          for (int d = 0; d < FAST; ++d) w[d] = lo + d < hi ? col[(lo + d) * TILE] : 0.0f;
          lead[t] = make_float4(w[0], w[1], w[2], w[3]);
        }
#pragma unroll
        for (int o = TILE / 2; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (t < nk * 2 * TILE && t % TILE == 0)
          reinterpret_cast<int*>(rect)[t / TILE] = lo | (max(hi, lo) << 16);
      }
      __syncthreads();

      for (int g0 = 0; g0 < nk;) {
        // a group of RoIs whose bins fit the stage (every thread finds the same)
        int g1 = g0, used = 0;
        while (g1 < nk) {
          const int ry = rect[g1].x, rx = rect[g1].y;
          const int n = ((ry >> 16) - (ry & 0xffff)) * ((rx >> 16) - (rx & 0xffff)) * BIN;
          if (g1 > g0 && used + n > a.stage_cap) break;
          used += n;
          ++g1;
        }
        // grad_out of the group's bins into the stage: VEC values a thread and
        // step, the RoI found by walking on from the thread's previous one
        {
          int k = g0 - 1, first = 0, n = 0, i0 = 0, j0 = 0, wb = 1;
          for (int u = threadIdx.x; u < used / VEC; u += BWD_THREADS) {
            while (u >= first + n) {
              first += n;
              const int2 rr = rect[++k];
              i0 = rr.x & 0xffff;
              j0 = rr.y & 0xffff;
              wb = (rr.y >> 16) - j0;
              n = ((rr.x >> 16) - i0) * wb * BWD_GROUPS;
            }
            const int rest = u - first, bin = rest / BWD_GROUPS, c = rest - bin * BWD_GROUPS;
            const int gc = q * BWD_GROUPS + c, i = i0 + bin / wb, j = j0 + bin % wb;
            if (gc < groups)
              copy_raw<T, VEC>(stage + u * VEC,
                               gout + ((long long)kept[k0 + k] * out * out + i * out + j) * a.C +
                                   gc * VEC);
          }
        }
        __syncthreads();
        // w_y * w_x * grad_out into the thread's cells, RoI by RoI
        if (active) {
          int off = 0;
          for (int k = g0; k < g1; ++k) {
            const int2 rr = rect[k];
            const int ry = rr.x, rx = rr.y;
            const int iy0 = ry & 0xffff, jx0 = rx & 0xffff, wb = (rx >> 16) - jx0;
            const T* gs = stage + off + cg_own * VEC;
            off += ((ry >> 16) - iy0) * wb * BIN;
            const int xr = range[(2 * k + 1) * TILE + tx];
            const int xlo = xr & 0xffff, xhi = xr >> 16;
            if (xlo >= xhi) continue;
            const float* wy = weight + 2 * k * out * TILE;
            const float* wx = weight + (2 * k + 1) * out * TILE + tx;
            const float4 nx = lead[(2 * k + 1) * TILE + tx];
            const float w_x[FAST] = {nx.x, nx.y, nx.z, nx.w};
#pragma unroll
            for (int c = 0; c < BWD_CELLS; ++c) {
              const int ty = ty1 + c * ROW_STEP;
              const int yr = range[2 * k * TILE + ty];
              const int ylo = yr & 0xffff, yhi = yr >> 16;
              if (yhi - ylo <= FAST && xhi - xlo <= FAST) {
                // the usual case, unrolled: the weights of the first FAST bins
                // from one read an axis, then up to FAST * FAST independent loads
                const float4 ny = lead[2 * k * TILE + ty];
                const float w_y[FAST] = {ny.x, ny.y, ny.z, ny.w};
                const T* gb = gs + ((ylo - iy0) * wb + xlo - jx0) * BIN;
#pragma unroll
                for (int di = 0; di < FAST; ++di) {
                  if (ylo + di >= yhi) break;
#pragma unroll
                  for (int dj = 0; dj < FAST; ++dj) {
                    if (xlo + dj >= xhi) break;
                    const float w = w_y[di] * w_x[dj];
                    float val[VEC];
                    Pack<T, VEC>::load(gb + (di * wb + dj) * BIN, val);
#pragma unroll
                    for (int v = 0; v < VEC; ++v) acc[c][v] = fmaf(w, val[v], acc[c][v]);
                  }
                }
              } else {
                for (int i = ylo; i < yhi; ++i) {
                  const float w_y = wy[i * TILE + ty];
                  const T* grow = gs + ((i - iy0) * wb - jx0) * BIN;
                  for (int j = xlo; j < xhi; ++j) {
                    const float w = w_y * wx[j * TILE];
                    float val[VEC];
                    Pack<T, VEC>::load(grow + j * BIN, val);
#pragma unroll
                    for (int v = 0; v < VEC; ++v) acc[c][v] = fmaf(w, val[v], acc[c][v]);
                  }
                }
              }
            }
          }
        }
        __syncthreads();
        g0 = g1;
      }
    }
  }

  if (!active) return;
  T* grad = static_cast<T*>(m.grad) + (long long)b * m.H * m.W * a.C + cg * VEC;
  const int x = tx0 + tx;
#pragma unroll
  for (int c = 0; c < BWD_CELLS; ++c) {
    const int y = ty0 + ty1 + c * ROW_STEP;
    if (y < m.H && x < m.W) Pack<T, VEC>::store(grad + ((long long)y * m.W + x) * a.C, acc[c]);
  }
}

template <typename T, int VEC>
cudaError_t launch_backward(BwdArgs a, int B, cudaStream_t stream) {
  const long long n_span = (long long)B * a.R * a.n_maps * 2;
  const long long n_bias = a.grad_bias ? (long long)B * a.R * a.C : 0;
  int prep_threads = 128;
  while (prep_threads > 32 && prep_threads * a.cap * sizeof(float2) > 48 * 1024) prep_threads /= 2;
  const size_t prep_smem = prep_threads * a.cap * sizeof(float2);
  if (prep_smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err;
  if (prep_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(roi_backward_prep_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)prep_smem);
    if (err != cudaSuccess) return err;
  }
  const long long prep_blocks = (n_span + n_bias + prep_threads - 1) / prep_threads;
  roi_backward_prep_kernel<T><<<(unsigned)prep_blocks, prep_threads, prep_smem, stream>>>(
      a, n_span, n_bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nlist = 2 * a.out_size;
  a.batch = max(1, min(MAX_BATCH, BWD_THREADS / nlist));
  static_assert(MAX_BATCH * 2 * TILE <= BWD_THREADS && 32 % TILE == 0,
                "a tile's ranges are found in one round, TILE threads of a warp per RoI axis");
  a.chunks = (a.C / VEC + BWD_GROUPS - 1) / BWD_GROUPS;
  int blocks = 0;
  for (int l = 0; l < a.n_maps; ++l) {
    BwdMap& m = a.map[l];
    m.tiles_x = (m.W + TILE - 1) / TILE;
    m.block_base = blocks;
    blocks += m.tiles_x * ((m.H + TILE - 1) / TILE) * a.chunks;
  }
  for (int l = a.n_maps; l < MAX_MAPS; ++l) a.map[l] = a.map[0];
  a.blocks_per_image = blocks;
  a.kept_cap = min((a.R + BWD_THREADS - 1) / BWD_THREADS * BWD_THREADS, MAX_KEPT);
  // the lists region also stages grad_out: at least one RoI's every bin
  const size_t lists_bytes =
      max((size_t)a.batch * nlist * a.cap * sizeof(float2),
          (size_t)a.out_size * a.out_size * BWD_GROUPS * VEC * sizeof(T));
  a.lists_floats = (int)((lists_bytes + 15) / 16 * 4);
  a.stage_cap = (int)(a.lists_floats * sizeof(float) / sizeof(T));
  const size_t smem = a.lists_floats * sizeof(float) + (size_t)a.batch * nlist * TILE * sizeof(float) +
                      (size_t)a.batch * 2 * TILE * sizeof(float4) +
                      ((size_t)a.batch * 2 * (TILE + 1) + a.kept_cap + BWD_THREADS / 32) * sizeof(int);
  if (smem > 227 * 1024 || (long long)B * blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(roi_align_sum_backward_kernel<T, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  roi_align_sum_backward_kernel<T, VEC><<<(unsigned)(B * blocks), BWD_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Fills the MapArg entries of n_maps maps from the host arrays (as the
// forward's entry point reads them) and their list layout; returns the
// total of entries, or -1 on arguments the kernels do not take.
long long map_layout(MapArg* map, const void* const* ptrs, const int* dims, const float* scales,
                     int n_maps, int C, int out_size, int max_grid, int elem_bytes) {
  long long total_ent = 0;
  for (int l = 0; l < n_maps; ++l) {
    MapArg& m = map[l];
    m.feat = ptrs[l];
    m.H = dims[4 * l];
    m.W = dims[4 * l + 1];
    m.sampling_ratio = dims[4 * l + 2];
    m.pool_from = dims[4 * l + 3];
    m.scale = scales[l];
    if (m.H <= 0 || m.W <= 0 || m.sampling_ratio < 0 || m.pool_from < 0 ||
        (long long)m.H * m.W * C * elem_bytes > 0x7fffffffLL)  // 32-bit byte offsets
      return -1;
    if (m.pool_from != 0 && (m.pool_from % out_size != 0 || m.sampling_ratio != 0)) return -1;
    const long long grid_max = m.pool_from ? (long long)(m.pool_from / out_size) * max_grid
                                           : (m.sampling_ratio ? m.sampling_ratio : max_grid);
    // a list holds at most two cells per sample; the odd length keeps
    // neighbouring bins' lists on different banks
    const long long cap = 2 * grid_max + 1;
    if (total_ent + 2 * out_size * cap > (1 << 20)) return -1;
    m.ent_base = (int)total_ent;
    m.ent_cap = (int)cap;
    total_ent += 2 * out_size * cap;
  }
  for (int l = n_maps; l < MAX_MAPS; ++l) map[l] = map[0];
  return total_ent;
}

}  // namespace

// Host arrays of n_maps entries: feats (device pointers to (B, H, W, C)
// contiguous maps, all bf16 when is_bf16 else all f32), dims (H, W,
// sampling_ratio, pool_from per map; pool_from is 0 for none and else a
// multiple of out_size, with sampling_ratio 0), scales. rois (B, R, 4) f32,
// bias (B, R, C) f32 or null, out (B, R, out, out, C) in the maps' type.
// 16-byte loads are used when C allows them (C % 8 == 0 in bf16, C % 4 == 0
// in f32, pointers aligned), one channel per thread otherwise. Returns a
// cudaError_t code.
extern "C" int roi_align_sum_launch(const void* const* feats, const int* dims, const float* scales,
                                    int n_maps, const void* rois, const void* bias, void* out,
                                    int B, int R, int C, int out_size, int max_grid, int is_bf16,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_maps < 1 || n_maps > MAX_MAPS || B <= 0 || R <= 0 || C <= 0 || out_size <= 0 ||
      max_grid <= 0 || (long long)B * R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.rois = static_cast<const float*>(rois);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.n_maps = n_maps;
  a.R = R;
  a.C = C;
  a.out_size = out_size;
  a.max_grid = max_grid;
  const long long total_ent =
      map_layout(a.map, feats, dims, scales, n_maps, C, out_size, max_grid, is_bf16 ? 2 : 4);
  if (total_ent < 0) return (int)cudaErrorInvalidValue;
  bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  for (int l = 0; l < n_maps; ++l)
    aligned = aligned && reinterpret_cast<uintptr_t>(feats[l]) % 16 == 0;
  a.total_ent = (int)total_ent;
  cudaError_t err;
  if (is_bf16) {
    err = (aligned && C % 8 == 0) ? launch<bf16, 8>(a, B, s) : launch<bf16, 1>(a, B, s);
  } else {
    err = (aligned && C % 4 == 0) ? launch<float, 4>(a, B, s) : launch<float, 1>(a, B, s);
  }
  return (int)err;
}

// K4's backward. Host arrays of n_maps entries: grads (device pointers to
// the (B, H, W, C) map gradients, in the maps' type, every cell of which is
// written once), dims and scales as the forward takes them. rois (B, R, 4)
// f32, grad_out (B, R, out, out, C) in the maps' type, grad_bias (B, R, C) f32
// or null, span (B, R, n_maps, 4) int32 scratch. Two launches: the footprints
// and the bias gradient, then the map gradients. Returns a cudaError_t code.
extern "C" int roi_align_sum_backward_launch(void* const* grads, const int* dims,
                                             const float* scales, int n_maps, const void* rois,
                                             const void* grad_out, void* grad_bias, void* span,
                                             int B, int R, int C, int out_size, int max_grid,
                                             int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_maps < 1 || n_maps > MAX_MAPS || B <= 0 || R <= 0 || C <= 0 || out_size <= 0 ||
      out_size > 0x7fff || max_grid <= 0 || (long long)B * R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  MapArg layout[MAX_MAPS];
  if (map_layout(layout, reinterpret_cast<const void* const*>(grads), dims, scales, n_maps, C,
                 out_size, max_grid, is_bf16 ? 2 : 4) < 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.rois = static_cast<const float*>(rois);
  a.grad_out = grad_out;
  a.grad_bias = static_cast<float*>(grad_bias);
  a.span = static_cast<int4*>(span);
  a.n_maps = n_maps;
  a.R = R;
  a.C = C;
  a.out_size = out_size;
  a.max_grid = max_grid;
  a.cap = 0;
  bool aligned = reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  for (int l = 0; l < n_maps; ++l) {
    const MapArg& src = layout[l];
    BwdMap& m = a.map[l];
    m.grad = grads[l];
    m.H = src.H;
    m.W = src.W;
    m.sampling_ratio = src.sampling_ratio;
    m.pool_from = src.pool_from;
    m.scale = src.scale;
    a.cap = max(a.cap, src.ent_cap);
    aligned = aligned && reinterpret_cast<uintptr_t>(grads[l]) % 16 == 0;
  }
  cudaError_t err;
  if (is_bf16) {
    err = (aligned && C % 8 == 0) ? launch_backward<bf16, 8>(a, B, s)
                                  : launch_backward<bf16, 1>(a, B, s);
  } else {
    err = (aligned && C % 4 == 0) ? launch_backward<float, 4>(a, B, s)
                                  : launch_backward<float, 1>(a, B, s);
  }
  return (int)err;
}
