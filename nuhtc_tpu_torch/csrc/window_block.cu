// K1: one Swin block after LN1, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nuhtc_tpu/ops/window_attention_pallas.py:255
// window_block_fused (body _make_block_kernel :189). Inputs are the padded
// (and, for shifted blocks, rolled) raw shortcut x and the post-LN1 map h1,
// both (B, Hp, Wp, C) bf16. Output, in the same frame:
//   x2  = x + proj(attn(h1))            attention per 7x7 window and head
//   out = x2 + fc2(gelu_tanh(fc1(LN2(x2))))
// bf16 operands, f32 accumulation, f32 softmax and LN2 statistics, the
// same casts as the Pallas body.
//
// What bounds it on the H100: the products. At the main path (B16, 512^2
// input) the 12 blocks do about 0.75 TFLOP, against ~0.3 GB of activations
// per block, so the kernel sits above the bf16 ridge once its matrix units
// are fed. This first version is simple rather than fast: warp-level
// mma.sync through nvcuda::wmma (16x16x16 bf16 tiles), weight tiles read
// straight from global memory (they stay in the 50 MB L2), no TMA and no
// wgmma.
//
// Design against the limits of the card:
// - The Pallas kernel holds a (7*Wp, 3C) qkv band in VMEM; that does not fit
//   in 227 KB of shared memory. Launch 1 works on one 7x7 window (49 tokens,
//   padded to 64 rows) and one head (head dim 32) per block, streaming the
//   window's h1 through shared memory in 32-channel chunks. Its band tables
//   reduce, per window, to the 49x49 relative bias plus the standard
//   shifted-window region mask (-100), which the block computes from the
//   window's position.
// - Everything after attention is per token, so launch 2 takes 32 flattened
//   tokens per block: proj + residual into an f32 tile in shared memory,
//   LN2, then the MLP tiled over the hidden dimension in 128-wide chunks
//   (hidden = 3072 at C = 768 does not fit otherwise), the fc2 sums held in
//   registers across chunks.
// - The attention output between the launches is bf16, as the Pallas body
//   casts it before proj; its buffer is padded to a multiple of 32 rows so
//   launch 2 needs no row guards on its matrix loads.
//
// K2, the attention-only tier, is a mode of this source and not a second
// copy. It replaces nuhtc_tpu/ops/window_attention_pallas.py:128
// window_attention_fused (body _make_kernel :74): out = proj(attn(h1)), no
// residual, LN2 and the MLP left to the caller. window_attention_launch runs
// the same launch 1 into the same bf16 buffer and then proj_kernel, a
// per-token product with wproj plus its bias. It is bound like K1's
// attention part: by the products once the matrix units are fed (the qkv
// and proj products are 8*M*C^2 FLOP against 2*M*C*2 bytes of maps).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 32;   // head dim: C / num_heads at every Swin-T stage
constexpr int NP = 64;   // window tokens padded to four 16-row tiles
constexpr int KC = 32;   // channel chunk of the qkv projection
constexpr int QKV_W = 3 * HD;
constexpr int ATTN_THREADS = 128;
constexpr int ATTN_SMEM = NP * QKV_W * 4 + NP * KC * 2 + 3 * NP * HD * 2 + NP * NP * 2;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int region(int p, int hp, int ws, int shift) {
  return (p >= hp - ws) + (p >= hp - shift);
}

// Launch 1: grid (windows, heads). Writes the head's bf16 attention output
// into attn_out[token, h*32 : h*32+32].
__global__ void __launch_bounds__(ATTN_THREADS) window_attn_kernel(
    const bf16* __restrict__ h1, const bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ relbias,
    bf16* __restrict__ attn_out, int Hp, int Wp, int C, int ws, int shift,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* R1 = reinterpret_cast<float*>(smem);              // [64][96] qkv, then S [64][64], O [64][32]
  bf16* Xc = reinterpret_cast<bf16*>(smem + NP * QKV_W * 4);  // [64][KC]
  bf16* Qs = Xc + NP * KC;                                 // [64][32]
  bf16* Ks = Qs + NP * HD;
  bf16* Vs = Ks + NP * HD;
  bf16* Ps = Vs + NP * HD;                                 // [64][64]

  const int N = ws * ws;
  const int nww = Wp / ws, nwh = Hp / ws;
  const int win = blockIdx.x, h = blockIdx.y;
  const int b = win / (nwh * nww);
  const int wrem = win - b * nwh * nww;
  const int wy = wrem / nww, wx = wrem - (wrem / nww) * nww;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto token_row = [&](int t) -> long long {
    const int py = wy * ws + t / ws, px = wx * ws + t % ws;
    return ((long long)b * Hp + py) * Wp + px;
  };

  // qkv for this head: (64 x C) @ (C x 96), warp w owns rows 16w..16w+15
  FragC acc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < C; k0 += KC) {
    for (int i = tid; i < NP * KC / 8; i += ATTN_THREADS) {
      const int r = i / (KC / 8), c8 = i % (KC / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < N) v = *reinterpret_cast<const uint4*>(h1 + token_row(r) * C + k0 + c8 * 8);
      *reinterpret_cast<uint4*>(Xc + r * KC + c8 * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Xc + warp * 16 * KC + kk, KC);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int part = j >> 1, sub = j & 1;
        FragBt bw;
        wmma::load_matrix_sync(
            bw, wqkv + (long long)(part * C + h * HD + sub * 16) * C + k0 + kk, C);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
    wmma::store_matrix_sync(R1 + warp * 16 * QKV_W + j * 16, acc[j], QKV_W, wmma::mem_row_major);
  __syncthreads();

  // + bias, q *= scale, cast to bf16 (the Pallas body's casts)
  for (int i = tid; i < NP * QKV_W; i += ATTN_THREADS) {
    const int r = i / QKV_W, j = i - r * QKV_W, part = j / HD, c = j - part * HD;
    float v = R1[i] + bqkv[part * C + h * HD + c];
    if (part == 0) v *= scale;
    bf16* dst = part == 0 ? Qs : (part == 1 ? Ks : Vs);
    dst[r * HD + c] = __float2bfloat16(v);
  }
  __syncthreads();

  // S = q k^T (64 x 64)
  {
    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * HD + kk, HD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBt bk;
        wmma::load_matrix_sync(bk, Ks + j * 16 * HD + kk, HD);
        wmma::mma_sync(s[j], a, bk, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(R1 + warp * 16 * NP + j * 16, s[j], NP, wmma::mem_row_major);
  }
  __syncthreads();

  // softmax rows in f32 with the bf16-rounded (relative bias + shift mask)
  const float* rb = relbias + (long long)h * N * N;
  for (int r = warp; r < NP; r += ATTN_THREADS / 32) {
    const int c0 = lane, c1 = lane + 32;
    if (r >= N) {
      Ps[r * NP + c0] = __float2bfloat16(0.0f);
      Ps[r * NP + c1] = __float2bfloat16(0.0f);
      continue;
    }
    int rreg = 0;
    if (shift) {
      rreg = 3 * region(wy * ws + r / ws, Hp, ws, shift) + region(wx * ws + r % ws, Wp, ws, shift);
    }
    float v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q;
      v[q] = -3.0e38f;
      if (c < N) {
        float bias = rb[r * N + c];
        if (shift) {
          const int creg = 3 * region(wy * ws + c / ws, Hp, ws, shift) +
                           region(wx * ws + c % ws, Wp, ws, shift);
          if (creg != rreg) bias += -100.0f;
        }
        v[q] = R1[r * NP + c] + __bfloat162float(__float2bfloat16(bias));
      }
    }
    const float m = warp_max(fmaxf(v[0], v[1]));
    const float e0 = c0 < N ? expf(v[0] - m) : 0.0f;
    const float e1 = c1 < N ? expf(v[1] - m) : 0.0f;
    const float ssum = warp_sum(e0 + e1);
    Ps[r * NP + c0] = __float2bfloat16(e0 / ssum);
    Ps[r * NP + c1] = __float2bfloat16(e1 / ssum);
  }
  __syncthreads();

  // O = p v (64 x 32), into R1 as [64][32]
  {
    FragC o[2];
    wmma::fill_fragment(o[0], 0.0f);
    wmma::fill_fragment(o[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < NP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * NP + kk, NP);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB bv;
        wmma::load_matrix_sync(bv, Vs + kk * HD + j * 16, HD);
        wmma::mma_sync(o[j], a, bv, o[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(R1 + warp * 16 * HD + j * 16, o[j], HD, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = tid; i < N * HD; i += ATTN_THREADS) {
    const int r = i / HD, c = i - r * HD;
    attn_out[token_row(r) * C + h * HD + c] = __float2bfloat16(R1[r * HD + c]);
  }
}

constexpr int MLP_TM = 32;       // tokens per block
constexpr int MLP_HC = 128;      // hidden chunk
constexpr int MLP_WARPS = 8;

template <int C>
constexpr int mlp_smem_bytes() {
  return MLP_TM * C * 4 + MLP_TM * C * 2 + MLP_TM * MLP_HC * 4 + MLP_TM * MLP_HC * 2 +
         MLP_WARPS * 256 * 4;
}

// Launch 2: grid (ceil(M / 32)). proj + residual + LN2 + MLP + residual on
// 32 flattened tokens.
template <int C>
__global__ void __launch_bounds__(MLP_WARPS * 32) block_mlp_kernel(
    const bf16* __restrict__ attn, const bf16* __restrict__ x,
    const bf16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g2, const float* __restrict__ be2,
    const bf16* __restrict__ w1, const float* __restrict__ bb1,
    const bf16* __restrict__ w2, const float* __restrict__ bb2, void* __restrict__ out,
    int out_f32, long long M) {
  constexpr int HID = 4 * C;
  constexpr int RT = MLP_TM / 16;
  constexpr int CT = C / 16;
  constexpr int YT = RT * CT;
  constexpr int MAXF = (YT + MLP_WARPS - 1) / MLP_WARPS;
  constexpr int UT = RT * (MLP_HC / 16);
  extern __shared__ __align__(128) unsigned char smem[];
  float* X2 = reinterpret_cast<float*>(smem);        // [TM][C]
  bf16* H2 = reinterpret_cast<bf16*>(X2 + MLP_TM * C); // [TM][C]
  float* Uf = reinterpret_cast<float*>(H2 + MLP_TM * C); // [TM][HC]
  bf16* Ub = reinterpret_cast<bf16*>(Uf + MLP_TM * MLP_HC); // [TM][HC]
  float* scratch = reinterpret_cast<float*>(Ub + MLP_TM * MLP_HC); // [warps][16*16]

  const long long m0 = (long long)blockIdx.x * MLP_TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // x2 (pre-bias) = attn @ wproj^T
  for (int t = warp; t < YT; t += MLP_WARPS) {
    const int rt = t / CT, ct = t - (t / CT) * CT;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < C; k += 16) {
      FragA a;
      FragBt bw;
      wmma::load_matrix_sync(a, attn + (m0 + rt * 16) * C + k, C);
      wmma::load_matrix_sync(bw, wproj + (long long)ct * 16 * C + k, C);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(X2 + rt * 16 * C + ct * 16, acc, C, wmma::mem_row_major);
  }
  __syncthreads();

  // x2 = x + (o + bproj); LN2 in f32 -> bf16 H2
  for (int r = warp; r < MLP_TM; r += MLP_WARPS) {
    const long long row = m0 + r;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float xv = row < M ? __bfloat162float(x[row * C + c]) : 0.0f;
      const float v = xv + (X2[r * C + c] + bproj[c]);
      X2[r * C + c] = v;
      sum += v;
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = X2[r * C + c] - mu;
      sq += d * d;
    }
    const float rs = rsqrtf(warp_sum(sq) / C + 1e-5f);
    for (int c = lane; c < C; c += 32)
      H2[r * C + c] = __float2bfloat16((X2[r * C + c] - mu) * rs * g2[c] + be2[c]);
  }
  __syncthreads();

  FragC yacc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(yacc[f], 0.0f);

  for (int h0 = 0; h0 < HID; h0 += MLP_HC) {
    // u = h2 @ w1[h0:h0+HC]^T
    for (int t = warp; t < UT; t += MLP_WARPS) {
      const int rt = t / (MLP_HC / 16), ct = t % (MLP_HC / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < C; k += 16) {
        FragA a;
        FragBt bw;
        wmma::load_matrix_sync(a, H2 + rt * 16 * C + k, C);
        wmma::load_matrix_sync(bw, w1 + (long long)(h0 + ct * 16) * C + k, C);
        wmma::mma_sync(acc, a, bw, acc);
      }
      wmma::store_matrix_sync(Uf + rt * 16 * MLP_HC + ct * 16, acc, MLP_HC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < MLP_TM * MLP_HC; i += MLP_WARPS * 32) {
      const float u = Uf[i] + bb1[h0 + (i % MLP_HC)];
      const float g = 0.5f * u * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * u * u * u)));
      Ub[i] = __float2bfloat16(g);
    }
    __syncthreads();
    // y += gelu(u) @ w2[:, h0:h0+HC]^T
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + f * MLP_WARPS;
      if (t < YT) {
        const int rt = t / CT, ct = t - (t / CT) * CT;
#pragma unroll
        for (int k = 0; k < MLP_HC; k += 16) {
          FragA a;
          FragBt bw;
          wmma::load_matrix_sync(a, Ub + rt * 16 * MLP_HC + k, MLP_HC);
          wmma::load_matrix_sync(bw, w2 + (long long)ct * 16 * HID + h0 + k, HID);
          wmma::mma_sync(yacc[f], a, bw, yacc[f]);
        }
      }
    }
    __syncthreads();
  }

  // out = x2 + (y + bfc2)
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + f * MLP_WARPS;
    if (t < YT) {
      const int rt = t / CT, ct = t - (t / CT) * CT;
      wmma::store_matrix_sync(sc, yacc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int r = rt * 16 + i / 16, c = ct * 16 + (i % 16);
        const long long row = m0 + r;
        if (row < M) {
          const float v = X2[r * C + c] + (sc[i] + bb2[c]);
          if (out_f32)
            reinterpret_cast<float*>(out)[row * C + c] = v;
          else
            reinterpret_cast<bf16*>(out)[row * C + c] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
cudaError_t launch_mlp(const bf16* attn, const bf16* x, const bf16* wproj, const float* bproj,
                       const float* g2, const float* be2, const bf16* w1, const float* bb1,
                       const bf16* w2, const float* bb2, void* out, int out_f32, long long M,
                       cudaStream_t stream) {
  constexpr int smem = mlp_smem_bytes<C>();
  cudaError_t err =
      cudaFuncSetAttribute(block_mlp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + MLP_TM - 1) / MLP_TM);
  block_mlp_kernel<C><<<grid, MLP_WARPS * 32, smem, stream>>>(
      attn, x, wproj, bproj, g2, be2, w1, bb1, w2, bb2, out, out_f32, M);
  return cudaGetLastError();
}

// K2's second launch: grid (ceil(M / 32)). out = attn @ wproj^T + bproj on 32
// flattened tokens, no residual. attn is the padded buffer of launch 1.
__global__ void __launch_bounds__(MLP_WARPS * 32) proj_kernel(
    const bf16* __restrict__ attn, const bf16* __restrict__ wproj,
    const float* __restrict__ bproj, void* __restrict__ out, int out_f32, int C, long long M) {
  __shared__ __align__(128) float scratch[MLP_WARPS * 256];
  const long long m0 = (long long)blockIdx.x * MLP_TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int CT = C / 16;
  float* sc = scratch + warp * 256;
  for (int t = warp; t < (MLP_TM / 16) * CT; t += MLP_WARPS) {
    const int rt = t / CT, ct = t - rt * CT;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < C; k += 16) {
      FragA a;
      FragBt bw;
      wmma::load_matrix_sync(a, attn + (m0 + rt * 16) * C + k, C);
      wmma::load_matrix_sync(bw, wproj + (long long)ct * 16 * C + k, C);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int c = ct * 16 + (i % 16);
      const long long row = m0 + rt * 16 + i / 16;
      if (row < M) {
        const float v = sc[i] + bproj[c];
        if (out_f32)
          reinterpret_cast<float*>(out)[row * C + c] = v;
        else
          reinterpret_cast<bf16*>(out)[row * C + c] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

// Launch 1 of both entry points.
cudaError_t launch_attn(const void* h1, const void* wqkv, const void* bqkv, const void* relbias,
                        void* attn_buf, int B, int Hp, int Wp, int C, int nh, int ws, int shift,
                        float scale, cudaStream_t s) {
  if (C != nh * HD || C % 16 || ws * ws > NP || Hp % ws || Wp % ws) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * (Hp / ws) * (Wp / ws)), (unsigned)nh);
  window_attn_kernel<<<grid, ATTN_THREADS, ATTN_SMEM, s>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(relbias),
      static_cast<bf16*>(attn_buf), Hp, Wp, C, ws, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x, h1 (B, Hp, Wp, C) bf16; wqkv (3C, C), wproj (C, C), w1 (4C, C),
// w2 (C, 4C) bf16 in (out, in) layout; biases, LN2 and relbias (nh, N, N)
// f32; attn_buf (ceil(B*Hp*Wp / 32) * 32, C) bf16 scratch; out (B, Hp, Wp, C)
// bf16, or f32 when out_f32. Returns a cudaError_t code (0 = launched).
extern "C" int window_block_launch(const void* x, const void* h1, const void* wqkv,
                                   const void* bqkv, const void* wproj, const void* bproj,
                                   const void* relbias, const void* g2, const void* be2,
                                   const void* w1, const void* bb1, const void* w2,
                                   const void* bb2, void* attn_buf, void* out, int B, int Hp,
                                   int Wp, int C, int nh, int ws, int shift, float scale,
                                   int out_f32, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_attn(h1, wqkv, bqkv, relbias, attn_buf, B, Hp, Wp, C, nh, ws, shift, scale, s);
  if (err != cudaSuccess) return (int)err;

  const long long M = (long long)B * Hp * Wp;
  const bf16* a = static_cast<const bf16*>(attn_buf);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const float* bp = static_cast<const float*>(bproj);
  const float* g = static_cast<const float*>(g2);
  const float* be = static_cast<const float*>(be2);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const float* b1 = static_cast<const float*>(bb1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b2 = static_cast<const float*>(bb2);
  switch (C) {
    case 96: err = launch_mlp<96>(a, xb, wp, bp, g, be, w1b, b1, w2b, b2, out, out_f32, M, s); break;
    case 192: err = launch_mlp<192>(a, xb, wp, bp, g, be, w1b, b1, w2b, b2, out, out_f32, M, s); break;
    case 384: err = launch_mlp<384>(a, xb, wp, bp, g, be, w1b, b1, w2b, b2, out, out_f32, M, s); break;
    case 768: err = launch_mlp<768>(a, xb, wp, bp, g, be, w1b, b1, w2b, b2, out, out_f32, M, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// K2: attention and proj only. h1 (B, Hp, Wp, C) bf16, weights and attn_buf as
// above; out (B, Hp, Wp, C) bf16, or f32 when out_f32, without the residual.
extern "C" int window_attention_launch(const void* h1, const void* wqkv, const void* bqkv,
                                       const void* wproj, const void* bproj, const void* relbias,
                                       void* attn_buf, void* out, int B, int Hp, int Wp, int C,
                                       int nh, int ws, int shift, float scale, int out_f32,
                                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_attn(h1, wqkv, bqkv, relbias, attn_buf, B, Hp, Wp, C, nh, ws, shift, scale, s);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * Hp * Wp;
  proj_kernel<<<(unsigned)((M + MLP_TM - 1) / MLP_TM), MLP_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(attn_buf), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), out, out_f32, C, M);
  return (int)cudaGetLastError();
}
