// K4: gather RoIAlign for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nuhtc_tpu/ops/roi_align_pallas.py:126
// roi_align_pallas_batched (body _make_kernel :42) by its purpose, not its
// code: mmcv RoIAlign(aligned=True, pool_mode='avg') on a channels-last map.
//   feat (B, H, W, C) bf16 or f32, rois (B, R, 4) f32 [x1, y1, x2, y2] in
//   image coordinates -> out (B, R, out, out, C) in feat's type, f32 sums.
// Per RoI and axis: start = x1*scale - 0.5, extent = x2*scale - 0.5 - start,
// bin = extent / out; each output bin averages grid_h x grid_w bilinear
// samples at start + i*bin + (s + 0.5)*bin/grid. The grid is
//   sampling_ratio                                    when it is > 0,
//   clamp(ceil(extent / out), 1, max_grid)            when it is 0 (adaptive),
//   k * clamp(ceil(extent / pool_from), 1, max_grid)  with pool_from = k*out:
//     the exact fusion of adaptive_avg_pool2d(RoIAlign(pool_from), out).
// A sample with coordinate < -1 or > size weighs 0; others clamp to
// [0, size - 1] and interpolate between floor and floor + 1 (clamped).
//
// What bounds it on the H100: bytes. A call writes R*out*out*C values per
// image (151.7 MB at B16, R1512, out 7, C64, bf16) and reads a map of at
// most 33.5 MB that stays in the 50 MB L2, while it does only a few FLOP per
// byte. So the design is about memory transactions:
// - The Pallas kernel DMAs a fixed 32x48 window of 128-padded channels per
//   RoI into VMEM, multiplies it by two interpolation matrices and needs a
//   dense fallback for RoIs larger than the window. Here nothing is staged:
//   one block per RoI walks the RoI's own sample grid, so there is no window,
//   no size limit and no fallback.
// - Channels are innermost. A thread owns one output bin and VEC channels
//   (16 bytes), and neighbouring threads own neighbouring channel groups:
//   at C = 64 bf16 eight threads read one corner as one 128-byte line, and a
//   warp writes 512 contiguous bytes of output.
// - Coordinates use the round-to-nearest intrinsics, not fused
//   multiply-adds, so they equal the plain PyTorch version's bit for bit and
//   the two validity tests (y < -1, y > size) and ceil() cut at the same
//   boxes; only the order of the f32 sums differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
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

struct Axis {
  float start, bin, gridf;
  int grid;
};

// One axis of one RoI: c0, c1 are the box's image coordinates on this axis.
__device__ __forceinline__ Axis make_axis(float c0, float c1, float scale, int out_size,
                                          int sampling_ratio, int max_grid, int pool_from) {
  Axis a;
  a.start = __fsub_rn(__fmul_rn(c0, scale), 0.5f);
  const float extent = __fsub_rn(__fsub_rn(__fmul_rn(c1, scale), 0.5f), a.start);
  a.bin = __fdiv_rn(extent, (float)out_size);
  if (pool_from > 0) {
    const float g = fminf(fmaxf(ceilf(__fdiv_rn(extent, (float)pool_from)), 1.0f), (float)max_grid);
    a.grid = (pool_from / out_size) * (int)g;
  } else if (sampling_ratio > 0) {
    a.grid = sampling_ratio;
  } else {
    a.grid = (int)fminf(fmaxf(ceilf(a.bin), 1.0f), (float)max_grid);
  }
  a.gridf = (float)a.grid;
  return a;
}

// Sample s of bin i on an axis of `size` cells: the two cells and their
// weights (sample weight 1/grid included); false when the sample weighs 0.
__device__ __forceinline__ bool sample(const Axis& a, int i, int s, int size, int* lo, int* hi,
                                       float* wlo, float* whi) {
  const float y = __fadd_rn(__fadd_rn(a.start, __fmul_rn((float)i, a.bin)),
                            __fdiv_rn(__fmul_rn((float)s + 0.5f, a.bin), a.gridf));
  if (y < -1.0f || y > (float)size) return false;
  float yc = fminf(fmaxf(y, 0.0f), (float)(size - 1));
  int l = (int)floorf(yc);
  if (l >= size - 1) {
    l = size - 1;
    yc = (float)l;
  }
  const float frac = yc - (float)l;
  const float w = __fdiv_rn(1.0f, a.gridf);
  *lo = l;
  *hi = min(l + 1, size - 1);
  *wlo = (1.0f - frac) * w;
  *whi = frac * w;
  return true;
}

// grid (R, B); a thread owns bin (i, j) and channels [cg*VEC, cg*VEC + VEC).
template <typename T, int VEC>
__global__ void roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                 T* __restrict__ out, int H, int W, int C, int R, int out_size,
                                 int sampling_ratio, int max_grid, int pool_from, float scale) {
  const int r = blockIdx.x, b = blockIdx.y;
  const float* box = rois + ((long long)b * R + r) * 4;
  const Axis ax = make_axis(box[0], box[2], scale, out_size, sampling_ratio, max_grid, pool_from);
  const Axis ay = make_axis(box[1], box[3], scale, out_size, sampling_ratio, max_grid, pool_from);
  const T* fmap = feat + (long long)b * H * W * C;
  T* dst = out + ((long long)b * R + r) * out_size * out_size * C;
  const int groups = C / VEC;
  const int items = out_size * out_size * groups;

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % groups, bin = it / groups;
    const int i = bin / out_size, j = bin - i * out_size;
    const int c0 = cg * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

    for (int sy = 0; sy < ay.grid; ++sy) {
      int y0, y1;
      float wy0, wy1;
      if (!sample(ay, i, sy, H, &y0, &y1, &wy0, &wy1)) continue;
      const T* row0 = fmap + (long long)y0 * W * C + c0;
      const T* row1 = fmap + (long long)y1 * W * C + c0;
      for (int sx = 0; sx < ax.grid; ++sx) {
        int x0, x1;
        float wx0, wx1;
        if (!sample(ax, j, sx, W, &x0, &x1, &wx0, &wx1)) continue;
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        Pack<T, VEC>::load(row0 + (long long)x0 * C, v00);
        Pack<T, VEC>::load(row0 + (long long)x1 * C, v01);
        Pack<T, VEC>::load(row1 + (long long)x0 * C, v10);
        Pack<T, VEC>::load(row1 + (long long)x1 * C, v11);
        const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] += w00 * v00[v] + w01 * v01[v] + w10 * v10[v] + w11 * v11[v];
      }
    }
    Pack<T, VEC>::store(dst + (long long)bin * C + c0, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feat, const void* rois, void* out, int B, int H, int W, int C, int R,
                   int out_size, int sampling_ratio, int max_grid, int pool_from, float scale,
                   cudaStream_t stream) {
  const int items = out_size * out_size * (C / VEC);
  const int passes = (items + 255) / 256;
  int threads = ((items + passes - 1) / passes + 31) / 32 * 32;
  threads = max(32, min(threads, 256));
  const dim3 grid((unsigned)R, (unsigned)B);
  roi_align_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), static_cast<T*>(out), H, W, C,
      R, out_size, sampling_ratio, max_grid, pool_from, scale);
  return cudaGetLastError();
}

}  // namespace

// feat (B, H, W, C) contiguous, bf16 when is_bf16 else f32; rois (B, R, 4)
// f32; out (B, R, out, out, C) in feat's type. pool_from is 0 for none and
// else a multiple of out_size (with sampling_ratio 0). 16-byte loads are used
// when C allows them (C % 8 == 0 in bf16, C % 4 == 0 in f32, pointers
// aligned), one channel per thread otherwise. Returns a cudaError_t code.
extern "C" int roi_align_launch(const void* feat, const void* rois, void* out, int B, int H, int W,
                                int C, int R, int out_size, int sampling_ratio, int max_grid,
                                int pool_from, int is_bf16, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || H <= 0 || W <= 0 || C <= 0 || out_size <= 0 || max_grid <= 0 ||
      B > 65535 || sampling_ratio < 0)
    return (int)cudaErrorInvalidValue;
  if (pool_from != 0 && (pool_from % out_size != 0 || sampling_ratio != 0))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(feat) % 16 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaError_t err;
  if (is_bf16) {
    if (aligned && C % 8 == 0)
      err = launch<bf16, 8>(feat, rois, out, B, H, W, C, R, out_size, sampling_ratio, max_grid,
                            pool_from, scale, s);
    else
      err = launch<bf16, 1>(feat, rois, out, B, H, W, C, R, out_size, sampling_ratio, max_grid,
                            pool_from, scale, s);
  } else {
    if (aligned && C % 4 == 0)
      err = launch<float, 4>(feat, rois, out, B, H, W, C, R, out_size, sampling_ratio, max_grid,
                             pool_from, scale, s);
    else
      err = launch<float, 1>(feat, rois, out, B, H, W, C, R, out_size, sampling_ratio, max_grid,
                             pool_from, scale, s);
  }
  return (int)err;
}
