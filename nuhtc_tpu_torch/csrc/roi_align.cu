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
// What bounds it: bytes again (grad_out read once, each map's gradient
// written once), but what it spends is atomics: one block per RoI, a thread
// per (bin, channel group) as in the forward, and every cell under a bin takes
// its VEC channels in float4 atomicAdds (sm_90's vector atomics; scalar ones
// cost four times as long at the train step's shapes) into one f32 buffer per
// map, which the L2 resolves. A second pass rounds a bf16 map's buffer once
// to bf16. The bias gradient sums in shared memory and is stored once per
// RoI. Atomics add in no fixed order, so the f32 sums change in their last
// bits from run to run.

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

// VEC f32 adds of w * g into dst: float4 atomics (sm_90 has them in global
// memory) when VEC is a multiple of 4, which puts dst on 16 bytes; scalar
// ones otherwise.
template <int VEC>
__device__ __forceinline__ void scatter_add(float* dst, float w, const float* g) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(w * g[4 * q], w * g[4 * q + 1], w * g[4 * q + 2], w * g[4 * q + 3]));
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) atomicAdd(dst + v, w * g[v]);
  }
}

// The backward's arguments: map[l].feat is map l's f32 gradient buffer
// (B, H, W, C), zeroed by the caller; grad_out (B, R, out, out, C) in the
// maps' type; grad_bias (B, R, C) f32 or null.
struct BwdArgs {
  MapArg map[MAX_MAPS];
  const float* rois;
  const void* grad_out;
  float* grad_bias;
  int n_maps, R, C, out_size, max_grid;
  int total_ent;
};

// One block per RoI, blockIdx.x = b * R + r; a thread owns bin (i, j) and
// channels [cg*VEC, cg*VEC + VEC) of grad_out, reads them once and adds
// weight * value into every cell of every map under that bin. Shared memory:
// the cell lists (byte offsets into the f32 buffers), their lengths, and C
// floats of the RoI's bias gradient.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) roi_align_sum_backward_kernel(
    const __grid_constant__ BwdArgs a) {
  extern __shared__ float2 ent[];
  const int out_size = a.out_size, C = a.C;
  const int lists = a.n_maps * 2 * out_size;
  int* count = reinterpret_cast<int*>(ent + a.total_ent);
  float* sbias = reinterpret_cast<float*>(count + lists);
  const long long roi = blockIdx.x;
  const int b = (int)(roi / a.R);

  const float* box = a.rois + roi * 4;
  const int cell_bytes = C * (int)sizeof(float);
  for (int t = threadIdx.x; t < lists; t += blockDim.x) {
    const int l = t / (2 * out_size), rem = t - l * 2 * out_size;
    const int axis = rem >= out_size, i = rem - axis * out_size;
    const MapArg& m = a.map[l];
    count[t] = bin_cells(ent + m.ent_base + rem * m.ent_cap, box[1 - axis], box[3 - axis], m.scale,
                         i, axis ? m.W : m.H, axis ? cell_bytes : m.W * cell_bytes, out_size,
                         m.sampling_ratio, a.max_grid, m.pool_from);
  }
  if (a.grad_bias)
    for (int c = threadIdx.x; c < C; c += blockDim.x) sbias[c] = 0.0f;
  __syncthreads();

  const T* src = static_cast<const T*>(a.grad_out) + roi * out_size * out_size * C;
  const int groups = C / VEC;
  const int items = out_size * out_size * groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % groups, bin = it / groups;
    const int i = bin / out_size, j = bin - i * out_size;
    const int c0 = cg * VEC;
    float g[VEC];
    Pack<T, VEC>::load(src + ((long long)bin * C + c0), g);
    if (a.grad_bias) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) atomicAdd(sbias + c0 + v, g[v]);
    }
#pragma unroll
    for (int l = 0; l < MAX_MAPS; ++l) {
      if (l < a.n_maps) {
        const MapArg& m = a.map[l];
        const float2* ey = ent + m.ent_base + i * m.ent_cap;
        const float2* ex = ent + m.ent_base + (out_size + j) * m.ent_cap;
        const int ny = count[l * 2 * out_size + i], nx = count[l * 2 * out_size + out_size + j];
        char* base = static_cast<char*>(const_cast<void*>(m.feat)) +
                     (size_t)b * m.H * m.W * C * sizeof(float);
        const unsigned c0_bytes = c0 * (unsigned)sizeof(float);
        for (int y = 0; y < ny; ++y) {
          const float2 cy = ey[y];
          const unsigned row = __float_as_uint(cy.y) + c0_bytes;
          for (int x = 0; x < nx; ++x) {
            const float2 cx = ex[x];
            const float w = cy.x * cx.x;
            scatter_add<VEC>(reinterpret_cast<float*>(base + (row + __float_as_uint(cx.y))), w, g);
          }
        }
      }
    }
  }
  if (a.grad_bias) {
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) a.grad_bias[roi * C + c] = sbias[c];
  }
}

// The one rounding of a bf16 map's f32 gradient buffer.
__global__ void round_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                                  long long n) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x)
    dst[k] = __float2bfloat16(src[k]);
}

template <typename T, int VEC>
cudaError_t launch_backward(const BwdArgs& a, int B, cudaStream_t stream) {
  const int lists = a.n_maps * 2 * a.out_size;
  const size_t smem_bytes =
      (size_t)a.total_ent * sizeof(float2) + lists * sizeof(int) + a.C * sizeof(float);
  if (smem_bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(roi_align_sum_backward_kernel<T, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int items = a.out_size * a.out_size * (a.C / VEC);
  const int threads = max(64, min((items + 31) / 32 * 32, MAX_THREADS));
  const unsigned grid = (unsigned)((long long)B * a.R);
  roi_align_sum_backward_kernel<T, VEC><<<grid, threads, smem_bytes, stream>>>(a);
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

// K4's backward. Host arrays of n_maps entries: grad_f32 (device pointers to
// zeroed (B, H, W, C) f32 buffers, one per map), grad_out_maps (for bf16 maps
// the (B, H, W, C) bf16 gradients the buffers are rounded into; ignored for
// f32 maps, whose gradient is the buffer), dims and scales as the forward
// takes them. rois (B, R, 4) f32, grad_out (B, R, out, out, C) in the maps'
// type, grad_bias (B, R, C) f32 or null. Returns a cudaError_t code.
extern "C" int roi_align_sum_backward_launch(void* const* grad_f32, void* const* grad_out_maps,
                                             const int* dims, const float* scales, int n_maps,
                                             const void* rois, const void* grad_out,
                                             void* grad_bias, int B, int R, int C, int out_size,
                                             int max_grid, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_maps < 1 || n_maps > MAX_MAPS || B <= 0 || R <= 0 || C <= 0 || out_size <= 0 ||
      max_grid <= 0 || (long long)B * R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.rois = static_cast<const float*>(rois);
  a.grad_out = grad_out;
  a.grad_bias = static_cast<float*>(grad_bias);
  a.n_maps = n_maps;
  a.R = R;
  a.C = C;
  a.out_size = out_size;
  a.max_grid = max_grid;
  const long long total_ent = map_layout(a.map, reinterpret_cast<const void* const*>(grad_f32),
                                         dims, scales, n_maps, C, out_size, max_grid, 4);
  if (total_ent < 0) return (int)cudaErrorInvalidValue;
  a.total_ent = (int)total_ent;
  const bool aligned = reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  cudaError_t err;
  if (is_bf16) {
    err = (aligned && C % 8 == 0) ? launch_backward<bf16, 8>(a, B, s)
                                  : launch_backward<bf16, 1>(a, B, s);
  } else {
    err = (aligned && C % 4 == 0) ? launch_backward<float, 4>(a, B, s)
                                  : launch_backward<float, 1>(a, B, s);
  }
  if (err != cudaSuccess || !is_bf16) return (int)err;
  for (int l = 0; l < n_maps; ++l) {
    const long long n = (long long)B * dims[4 * l] * dims[4 * l + 1] * C;
    const long long want = (n + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    round_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(grad_f32[l]),
                                            static_cast<bf16*>(grad_out_maps[l]), n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
