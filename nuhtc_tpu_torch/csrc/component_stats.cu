// K3: per-component box and area statistics, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nuhtc_tpu/ops/components_pallas.py:98
// boxes_from_roots_pallas_batched (body _make_kernel :31). For each of K
// component ids ("roots": linear pixel indices, padded with H*W, which is
// also the background label) it collects xmin, xmax, ymin, ymax and the
// pixel count of lab == root over a raw label map, and returns boxes
// [x1, y1, x2 + 1, y2 + 1] (f32) and int32 areas. An id with no pixels gets
// +-1e9 extents and area 0, as on the TPU; an id listed twice gets the same
// numbers at both places.
//
// What bounds it on the H100: reading the label map once, 16.8 MB at the
// main path (B16, 512^2, K512), 5 us at 3.35 TB/s, which is about what one
// launch costs; the TPU design instead compares every pixel with every id,
// 2e9 compares per batch.
//
// Design: two launches, no global atomic, nothing to initialise:
// 1. strip_stats_kernel. A block takes a contiguous strip of one image's
//    pixels. It hashes the image's K ids into shared memory (open
//    addressing, id -> the smallest slot that lists it, so duplicates agree
//    whichever block looks), keeps a private 5 x K table of statistics in
//    shared memory and reads its strip 16 bytes a thread: a run of equal
//    labels among those four pixels is one lookup and one set of
//    shared-memory atomics. The background (label H*W), most of every image,
//    stays in registers, is reduced per warp and costs one shared-memory
//    update per warp. The block then writes its whole table to its own
//    place in a (B, strips, 5, K) buffer, coalesced; the first strip of an
//    image also writes each id's slot.
// 2. reduce_strips_kernel. One thread per id reduces its slot over the
//    strips and writes the box and the area.
// A launch serves as many ids as fit a block's shared memory (4096 and some
// more); the wrapper gives it more ids in several calls, which agree on an
// id listed in two of them because each call counts all of the id's pixels.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STRIP_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned hash_slot(int key, unsigned mask, int shift) {
  return ((unsigned)key * 2654435761u >> shift) & mask;
}

// The slot of label `key` in a block's hash (keys, -1 where empty), or -1.
__device__ __forceinline__ int find_slot(const int* keys, const int* vals, int key, unsigned mask,
                                         int shift) {
  unsigned h = hash_slot(key, mask, shift);
  while (true) {
    const int k = keys[h];
    if (k == key) return vals[h];
    if (k == -1) return -1;
    h = (h + 1) & mask;
  }
}

struct Run {  // pixels [x0, x1] of row y, all of one label
  int label, x0, x1, y;
};

// grid (strips, B). Shared memory: keys[hash_size], vals[hash_size],
// stats[5][K]. part (B, strips, 5, K), slot_of (B, K).
template <bool VEC4>
__global__ void __launch_bounds__(STRIP_THREADS) strip_stats_kernel(
    const int* __restrict__ lab, const int* __restrict__ roots, int* __restrict__ part,
    int* __restrict__ slot_of, int K, int W, int HW, int strip, int hash_size, int hash_shift) {
  extern __shared__ int sm[];
  int* keys = sm;
  int* vals = sm + hash_size;
  int* stats = sm + 2 * hash_size;
  const int b = blockIdx.y, s = blockIdx.x;
  const unsigned mask = (unsigned)hash_size - 1u;
  const int* ids = roots + (long long)b * K;

  for (int i = threadIdx.x; i < hash_size; i += blockDim.x) {
    keys[i] = -1;
    vals[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < 5 * K; i += blockDim.x) {
    const int stat = i / K;
    stats[i] = stat == 4 ? 0 : ((stat & 1) ? INT_MIN : INT_MAX);  // min, max, min, max, count
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int id = ids[k];
    if (id < 0 || id > HW) continue;  // owns no pixel
    unsigned h = hash_slot(id, mask, hash_shift);
    while (true) {
      const int prev = atomicCAS(&keys[h], -1, id);
      if (prev == -1 || prev == id) {
        atomicMin(&vals[h], k);
        break;
      }
      h = (h + 1) & mask;
    }
  }
  __syncthreads();
  if (s == 0) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int id = ids[k];
      slot_of[(long long)b * K + k] =
          (id < 0 || id > HW) ? -1 : find_slot(keys, vals, id, mask, hash_shift);
    }
  }

  int bg_n = 0, bg_x0 = INT_MAX, bg_x1 = INT_MIN, bg_y0 = INT_MAX, bg_y1 = INT_MIN;
  auto take = [&](const Run& r) {
    const int n = r.x1 - r.x0 + 1;
    if (r.label == HW) {  // background: registers
      bg_n += n;
      bg_x0 = min(bg_x0, r.x0);
      bg_x1 = max(bg_x1, r.x1);
      bg_y0 = min(bg_y0, r.y);
      bg_y1 = max(bg_y1, r.y);
      return;
    }
    if (r.label < 0 || r.label > HW) return;
    const int slot = find_slot(keys, vals, r.label, mask, hash_shift);
    if (slot < 0) return;
    atomicMin(&stats[slot], r.x0);
    atomicMax(&stats[K + slot], r.x1);
    atomicMin(&stats[2 * K + slot], r.y);
    atomicMax(&stats[3 * K + slot], r.y);
    atomicAdd(&stats[4 * K + slot], n);
  };

  const int* img = lab + (long long)b * HW;
  const int p0 = s * strip, p1 = min(HW, p0 + strip);
  if (VEC4) {  // W % 4 == 0 and strip % 4 == 0: four pixels of one row per load
    for (int p = p0 + 4 * threadIdx.x; p < p1; p += 4 * blockDim.x) {
      const int4 v = *reinterpret_cast<const int4*>(img + p);
      const int y = p / W, x = p - y * W;
      const int l[4] = {v.x, v.y, v.z, v.w};
      Run r = {l[0], x, x, y};
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        if (l[q] == r.label) {
          r.x1 = x + q;
        } else {
          take(r);
          r = {l[q], x + q, x + q, y};
        }
      }
      take(r);
    }
  } else {
    for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const int y = p / W, x = p - y * W;
      take({img[p], x, x, y});
    }
  }

  const int bg_slot = find_slot(keys, vals, HW, mask, hash_shift);
  if (bg_slot >= 0) {
    bg_n = __reduce_add_sync(FULL, bg_n);
    bg_x0 = __reduce_min_sync(FULL, bg_x0);
    bg_x1 = __reduce_max_sync(FULL, bg_x1);
    bg_y0 = __reduce_min_sync(FULL, bg_y0);
    bg_y1 = __reduce_max_sync(FULL, bg_y1);
    if ((threadIdx.x & 31) == 0 && bg_n > 0) {
      atomicMin(&stats[bg_slot], bg_x0);
      atomicMax(&stats[K + bg_slot], bg_x1);
      atomicMin(&stats[2 * K + bg_slot], bg_y0);
      atomicMax(&stats[3 * K + bg_slot], bg_y1);
      atomicAdd(&stats[4 * K + bg_slot], bg_n);
    }
  }
  __syncthreads();
  int* mine = part + ((long long)b * gridDim.x + s) * 5 * K;
  for (int i = threadIdx.x; i < 5 * K; i += blockDim.x) mine[i] = stats[i];
}

__device__ __forceinline__ void write_box(float* boxes, int* areas, int i, int area, int x0,
                                          int x1, int y0, int y1) {
  const bool has = area > 0;
  boxes[4 * i + 0] = has ? (float)x0 : 1e9f;
  boxes[4 * i + 1] = has ? (float)y0 : 1e9f;
  boxes[4 * i + 2] = (has ? (float)x1 : -1e9f) + 1.0f;
  boxes[4 * i + 3] = (has ? (float)y1 : -1e9f) + 1.0f;
  areas[i] = has ? area : 0;
}

__global__ void reduce_strips_kernel(const int* __restrict__ part, const int* __restrict__ slot_of,
                                     float* __restrict__ boxes, int* __restrict__ areas, int BK,
                                     int K, int strips) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BK) return;
  const int slot = slot_of[i];
  int area = 0, x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
  if (slot >= 0) {
    const int* p = part + (long long)(i / K) * strips * 5 * K + slot;
    for (int s = 0; s < strips; ++s, p += 5 * K) {
      x0 = min(x0, p[0]);
      x1 = max(x1, p[K]);
      y0 = min(y0, p[2 * K]);
      y1 = max(y1, p[3 * K]);
      area += p[4 * K];
    }
  }
  write_box(boxes, areas, i, area, x0, x1, y0, y1);
}

int hash_size_for(int K) {
  int n = 64;
  while (n < 2 * K) n *= 2;
  return n;
}

// Bytes of shared memory a block needs for K ids.
long long smem_bytes_for(int K) {
  return (2LL * hash_size_for(K) + 5LL * K) * (long long)sizeof(int);
}

}  // namespace

// The number of strips per image: enough blocks to fill
// the card twice, a strip no shorter than 2048 pixels and a multiple of 4.
extern "C" int component_stats_strips(int B, int HW) {
  const int want = (264 + B - 1) / B, most = (HW + 2047) / 2048;
  return max(1, min(want, most));
}

// lab (B, H, W) int32, roots (B, K) int32; scratch part
// (B, strips, 5, K) int32 with strips = component_stats_strips(B, H*W) and
// slot_of (B, K) int32, neither initialised; outputs boxes (B, K, 4) f32,
// areas (B, K) int32. Returns a cudaError_t code (0 = launched).
extern "C" int component_stats_launch(const void* lab, const void* roots, void* part,
                                      void* slot_of, void* boxes, void* areas, int B, int H,
                                      int W, int K, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || K <= 0 || (long long)H * W >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int HW = H * W, BK = B * K;
  const int strips = component_stats_strips(B, HW);
  const int strip = ((HW + strips - 1) / strips + 3) / 4 * 4;
  const int hash_size = hash_size_for(K);
  int hash_shift = 32;
  for (int n = hash_size; n > 1; n /= 2) --hash_shift;
  if (smem_bytes_for(K) > 227 * 1024) return (int)cudaErrorInvalidValue;  // a block's most
  const int smem = (int)smem_bytes_for(K);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(lab) % 16 == 0;
  auto kernel = vec4 ? strip_stats_kernel<true> : strip_stats_kernel<false>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)strips, (unsigned)B), STRIP_THREADS, smem, s>>>(
      static_cast<const int*>(lab), static_cast<const int*>(roots), static_cast<int*>(part),
      static_cast<int*>(slot_of), K, W, HW, strip, hash_size, hash_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_strips_kernel<<<(unsigned)((BK + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const int*>(part), static_cast<const int*>(slot_of), static_cast<float*>(boxes),
      static_cast<int*>(areas), BK, K, strips);
  return (int)cudaGetLastError();
}
