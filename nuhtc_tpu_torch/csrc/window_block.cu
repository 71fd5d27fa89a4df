// K1 and K2: one Swin block after LN1, for NVIDIA Hopper (sm_90a).
//
// K1 replaces the TPU kernel nuhtc_tpu/ops/window_attention_pallas.py:255
// window_block_fused (body _make_block_kernel :189). Inputs are the padded
// (and, for shifted blocks, rolled) raw shortcut x and the post-LN1 map h1,
// both (B, Hp, Wp, C) bf16. Output, in the same frame:
//   x2  = x + proj(attn(h1))            attention per 7x7 window and head
//   out = x2 + fc2(gelu_tanh(fc1(LN2(x2))))
// K2 replaces window_attention_fused (:128, body _make_kernel :74):
//   out = proj(attn(h1)), no residual; LN2 and the MLP stay with the caller.
// bf16 operands, f32 sums, f32 softmax and LN2 statistics, and the bf16
// roundings where the Pallas bodies put them: q*scale, k, v, the bias + mask
// sum, p, the attention output, LN2's output and gelu(u).
//
// What bounds it on the H100: the four large products (qkv, proj, fc1, fc2:
// 24*M*C^2 FLOP a block against 3 maps of M*C bf16), so the tensor cores'
// rate, once they are fed. All four run on wgmma (warpgroups of 4 warps,
// 64-row tiles, A and B from shared memory, f32 sums in registers). A weight
// reaches the tensor cores through shared memory only: tiles of 32 input
// columns are copied by cp.async into a ring of NS >= 2 slots, the copy of
// unit i + NS - 1 in flight while unit i is multiplied, each unit read by
// the four warps of a warpgroup. Every operand tile is [rows][32] bf16 in the
// 64-byte swizzle, K-major; 32 columns because the head dim is 32 and
// 96 = 3 * 32, so one layout and one descriptor serve every product at every
// width. Bias, q scale, softmax, GELU (tanh form), residuals, LN2 and the
// casts are applied to the sum fragments in registers.
//
// Launch 1 (window_attn_kernel): a block is one window (49 tokens padded to
// 64 rows; rows 49-63 are zeroed once) and HS warpgroups that deal the heads
// out among them (and among GY blocks per window). h1 is read once per block
// and stays in shared memory; per head, qkv is one 64 x 96 product over
// K = C with the head's 96 rows of wqkv streamed through the warpgroup's own
// ring. q, k and v go to shared memory as [64][32] tiles, so q k^T (64 x 64)
// and p v (64 x 32) are wgmma too (v read as an MN-major B operand, no
// transpose): they are small, but they sit between two wgmma products whose
// fragments they share, and p feeds p v from registers without touching
// shared memory. The relative bias comes as a table in the threads' register
// order with both bf16 roundings of each entry (bias, bias - 100), read 16
// bytes at a time: the scalar reads of a (nh, 49, 49) table cost a third of
// the launch. The shifted-window mask is computed from the window's position
// (-100 once) and only selects the rounding. The head's output leaves through
// the q tile as 16-byte stores into a bf16 map.
//
// Launch 2 (block_mlp_kernel): 64 tokens per block, CW warpgroups that split
// the output columns (C / CW each) of proj and fc2 and the HC hidden columns
// of an fc1 chunk, so no weight row is needed by two warpgroups: each streams
// its own rows through its own ring and they meet only where they exchange a
// token tile. proj's sums plus x and the bias are x2, kept in registers;
// LN2's statistics are reduced across the warpgroups through shared memory
// and its bf16 output replaces the attention tile as fc1's A operand; per
// hidden chunk, gelu(u) goes to shared memory once (two buffers, one block
// barrier per chunk) and is fc2's A operand for all warpgroups; fc2's sums
// stay in registers over the whole hidden dimension and meet x2 in the same
// fragment layout at the end. K2's second launch is the same kernel ending
// after proj.
//
// What each width needs, and what the schedule does:
// - 64-row tiles mean every block pulls all 9*C^2 weights of launch 2 through
//   L2 once per 64 tokens, ~0.8 GB a launch at every width: L2, not the
//   tensor cores, sets the floor of launch 2 (the launches read weights at
//   3.3 to 4.0 TB/s as measured). 128 rows per weight fetch would halve it,
//   but 128 x C f32 sums of fc2 plus x2 do not fit the register file from
//   C = 192 on; a thread block cluster with multicast copies is the way
//   past it.
// - C = 96 (M = 283,024 at B16): per-tile work is small and latency decides,
//   so several small blocks share an SM: one warpgroup per block in both
//   launches (3 and 2 blocks per SM); a unit is a whole weight matrix slab.
// - C = 192: two warpgroups split the columns, x2 and the fc2 sums are 48
//   registers each, hidden chunks of 128 (64 columns of fc1 a warpgroup);
//   one block per window and its six heads in launch 1.
// - C = 384: three warpgroups of 128 columns (64 + 64 sum registers), units
//   of 96 input columns so that a hidden chunk is one fc1 and one fc2 unit;
//   launch 1 deals the 12 heads over three blocks per window (1,200 blocks
//   for 264 slots).
// - C = 768 (M = 7,056): 64 x 768 f32 is 196 KB, so x2 and the fc2 sums do
//   not fit the register file together: three warpgroups hold 256 columns of
//   fc2 sums each and x2 waits in an f32 scratch map in device memory
//   (2*M*C*4 bytes, 0.013 ms at the card's rate). The 96 KB token tile
//   leaves room for two ring slots only, so launch 2 waits on L2 latency
//   there. 64-row tiles (not 128) give 111 blocks for 132 SMs; launch 1
//   takes two warpgroups and a third of the heads per block.
// The attention output crosses device memory once between the launches
// (2*M*C*2 bytes, 0.03 ms at C = 96): at C = 768 the h1 tile, the output
// tile and a ring do not fit 227 KB together, and one hand-over keeps one
// schedule for all widths.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 32;        // head dim: C / num_heads at every Swin-T stage
constexpr int NP = 64;        // window tokens padded to one wgmma row tile
constexpr int CHUNK = 4096;   // bytes of a [64][32] bf16 operand tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col < 32) in a [rows][32] bf16 tile under the
// 64-byte swizzle: the 16-byte unit index is XORed with bits 1-2 of the row.
// The tile's base is a multiple of 512 bytes.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + ((col & 7) << 1);
}

// wgmma shared-memory descriptor of a K-major 64-byte-swizzled tile: start
// address, 512 bytes between 8-row groups, layout type 2. A 16-deep step
// inside the 32-column tile adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before the tensor cores' reads.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float gelu_tanh(float u) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.7978845608028654f * (u + 0.044715f * u * u * u)));
  return 0.5f * u * (1.0f + t);
}

__device__ __forceinline__ int region(int p, int hp, int ws, int shift) {
  return (p >= hp - ws) + (p >= hp - shift);
}

// Copies rows [0, rows) x 32 columns of a row-major bf16 matrix (leading
// dimension ld) into a swizzled [rows][32] tile, 16 bytes per request.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long ld, int rows,
                                          int tid, int nthreads) {
  for (int i = tid; i < rows * 4; i += nthreads) {
    const int r = i >> 2, cc = i & 3;
    cp16(dst + r * 64 + ((cc ^ ((r >> 1) & 3)) << 4), src + r * ld + cc * 8, 16);
  }
}

// Launch 1: grid (windows, GY). A block is HS warpgroups on one window; the
// heads are dealt out over the GY * HS warpgroups of a window, hpw each. A
// warpgroup streams its heads' 96 weight rows through its own ring (stages
// of SD 32-column tiles) and meets the others only once, when h1 has landed.
template <int C, int HS, int NS, int SD>
constexpr int attn_smem_bytes() {
  return 1024 + (C / 32) * CHUNK + HS * (NS * SD * 6144 + 3 * CHUNK);
}

template <int C, int HS, int NS, int SD, int MINB>
__global__ void __launch_bounds__(HS * 128, MINB) window_attn_kernel(
    const bf16* __restrict__ h1, const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
    const uint4* __restrict__ relbias, bf16* __restrict__ attn_out, int Hp, int Wp, int ws,
    int shift, int hpw, float scale) {
  constexpr int KCH = C / 32;   // 32-column chunks of h1
  constexpr int SPH = KCH / SD; // ring stages per head
  constexpr int STAGE = SD * 6144;
  constexpr int NT = HS * 128;
  static_assert(KCH % SD == 0, "");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const uint32_t H1 = base;
  const uint32_t ring = base + KCH * CHUNK + wg * (NS * STAGE + 3 * CHUNK);
  const uint32_t Qs = ring + NS * STAGE;
  const uint32_t Ks = Qs + CHUNK, Vs = Ks + CHUNK;  // q, k, v: [64 tokens][32] tiles

  const int N = ws * ws;
  const int nww = Wp / ws, nwh = Hp / ws;
  const int win = blockIdx.x;
  const int b = win / (nwh * nww);
  const int wrem = win - b * nwh * nww;
  const int wy = wrem / nww, wx = wrem - wy * nww;
  const int h0 = (blockIdx.y * HS + wg) * hpw;
  const int T = hpw * SPH;

  auto token_row = [&](int tk) -> long long {
    const int py = wy * ws + tk / ws, px = wx * ws + tk % ws;
    return ((long long)b * Hp + py) * Wp + px;
  };
  auto start_copy = [&](int j) {
    if (j >= T) return;
    const int head = h0 + j / SPH, ks = j % SPH;
    const uint32_t buf = ring + (j % NS) * STAGE;
#pragma unroll
    for (int chunk = 0; chunk < SD; ++chunk)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        load_tile(buf + chunk * 6144 + part * 2048,
                  wqkv + ((long long)part * C + head * HD) * C + (ks * SD + chunk) * 32, C, 32, t,
                  128);
  };

  // the window's 49 rows of h1 by cp.async, rows 49-63 zero
  for (int i = tid; i < N * (C / 8); i += NT) {
    const int r = i / (C / 8), c8 = i - r * (C / 8);
    cp16(H1 + (c8 >> 2) * CHUNK + r * 64 + (((c8 & 3) ^ ((r >> 1) & 3)) << 4),
         h1 + token_row(r) * C + c8 * 8, 16);
  }
  cp_commit();
  for (int i = tid; i < (NP - N) * 16 * KCH; i += NT) {
    const int chunk = i / ((NP - N) * 16), rem = i - chunk * (NP - N) * 16;
    st_shared_u32(H1 + chunk * CHUNK + N * 64 + rem * 4, 0u);
  }
  for (int s = 0; s < NS - 1; ++s) {
    start_copy(s);
    cp_commit();
  }

  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  // bit (i*16 + j*2 + e): row r_i and column 8j + cq + e lie in different shift regions
  uint32_t mbits = 0;
  if (shift) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0;
      const int rreg = 3 * region(wy * ws + r / ws, Hp, ws, shift) + region(wx * ws + r % ws, Wp, ws, shift);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          const int creg = 3 * region(wy * ws + c / ws, Hp, ws, shift) + region(wx * ws + c % ws, Wp, ws, shift);
          if (creg != rreg) mbits |= 1u << (i * 16 + j * 2 + e);
        }
    }
  }

  long long out_row[2];  // rows (t/4) and (t/4 + 32) of the window, for the output copy
#pragma unroll
  for (int k = 0; k < 2; ++k) out_row[k] = token_row(min((t >> 2) + 32 * k, N - 1));

  cp_wait<NS - 1>();  // h1 has landed (this thread's part)
  fence_async();
  __syncthreads();

  int it = 0;
  for (int hh = 0; hh < hpw; ++hh) {
    const int head = h0 + hh;
    float acc[48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < SPH; ++ks) {
      cp_wait<NS - 2>();
      fence_async();
      wg_barrier(wg);
      start_copy(it + NS - 1);
      cp_commit();
      const uint32_t buf = ring + (it % NS) * STAGE;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < SD; ++c)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          wgmma_ss_n96(acc, make_desc(H1 + (ks * SD + c) * CHUNK + s * 32),
                       make_desc(buf + c * 6144 + s * 32), (ks | c | s) != 0);
      wgmma_commit();
      wgmma_wait0();
      ++it;
    }
    // + bias, q *= scale, bf16; q, k and v as [64][32] tiles (v is read as
    // an MN-major B operand: its rows are the product's depth)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int part = j >> 2, col = (j & 3) * 8 + cq;
      const float2 bb = *reinterpret_cast<const float2*>(bqkv + part * C + head * HD + col);
      float v0 = acc[4 * j] + bb.x, v1 = acc[4 * j + 1] + bb.y;
      float v2 = acc[4 * j + 2] + bb.x, v3 = acc[4 * j + 3] + bb.y;
      if (part == 0) {
        st_shared_u32(Qs + swz(r0, col), pack_bf16(v0 * scale, v1 * scale));
        st_shared_u32(Qs + swz(r1, col), pack_bf16(v2 * scale, v3 * scale));
      } else if (part == 1) {
        st_shared_u32(Ks + swz(r0, col), pack_bf16(v0, v1));
        st_shared_u32(Ks + swz(r1, col), pack_bf16(v2, v3));
      } else {
        st_shared_u32(Vs + swz(r0, col), pack_bf16(v0, v1));
        st_shared_u32(Vs + swz(r1, col), pack_bf16(v2, v3));
      }
    }
    fence_async();
    wg_barrier(wg);

    // S = q k^T (64 x 64)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 2; ++st)
      wgmma_ss_n64(s, make_desc(Qs + st * 32), make_desc(Ks + st * 32), st);
    wgmma_commit();
    wgmma_wait0();

    // softmax rows in f32 with the bf16-rounded (relative bias + shift mask):
    // the table holds both roundings of each entry in this thread's order
    const uint4* bt = relbias + ((long long)head * 8 * 128 + t);
    float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 w = __ldg(bt + j * 128);
      const uint32_t ws4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // k = 2i + e
        const bool masked = mbits & (1u << ((k >> 1) * 16 + j * 2 + (k & 1)));
        s[4 * j + k] += __uint_as_float(masked ? (ws4[k] & 0xffff0000u) : (ws4[k] << 16));
      }
      m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float sum0 = 0.0f, sum1 = 0.0f;  // padded columns hold -3e38: their exp is 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float e0 = __expf(s[4 * j + e] - m0), e1 = __expf(s[4 * j + 2 + e] - m1);
        s[4 * j + e] = e0;
        s[4 * j + 2 + e] = e1;
        sum0 += e0;
        sum1 += e1;
      }
    const float inv0 = 1.0f / quad_sum(sum0), inv1 = 1.0f / quad_sum(sum1);
    uint32_t pa[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int ja = 2 * st, jb = 2 * st + 1;
      pa[st][0] = pack_bf16(s[4 * ja] * inv0, s[4 * ja + 1] * inv0);
      pa[st][1] = pack_bf16(s[4 * ja + 2] * inv1, s[4 * ja + 3] * inv1);
      pa[st][2] = pack_bf16(s[4 * jb] * inv0, s[4 * jb + 1] * inv0);
      pa[st][3] = pack_bf16(s[4 * jb + 2] * inv1, s[4 * jb + 3] * inv1);
    }

    // O = p v (64 x 32), p from registers
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st)  // 16 tokens, 16 rows of the v tile, a step
      wgmma_rs_n32_mn(o, pa[st], make_desc(Vs + st * 1024), st);
    wgmma_commit();
    wgmma_wait0();

    // the head's (64 x 32) output through the q tile (each warp its own rows,
    // whose reads are over), then 16 bytes a thread to the bf16 map
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st_shared_u32(Qs + swz(r0, 8 * j + cq), pack_bf16(o[4 * j], o[4 * j + 1]));
      st_shared_u32(Qs + swz(r1, 8 * j + cq), pack_bf16(o[4 * j + 2], o[4 * j + 3]));
    }
    wg_barrier(wg);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = (t >> 2) + 32 * k, piece = t & 3;
      if (row < N) {
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(Qs + row * 64 + ((piece ^ ((row >> 1) & 3)) << 4)));
        *reinterpret_cast<uint4*>(attn_out + out_row[k] * C + head * HD + piece * 8) = v;
      }
    }
  }
  cp_wait<0>();
}

constexpr int MLP_TM = 64;  // tokens per block

template <int C, int CW, int HC, int NS, int KD>
constexpr int mlp_smem_bytes() {
  return 1024 + (C / 32) * CHUNK + 2 * (HC / 32) * CHUNK + NS * C * KD * 2 + 2 * CW * MLP_TM * 4;
}

// Launch 2: grid (ceil(M / 64)). proj + residual + LN2 + MLP + residual on 64
// flattened tokens; with PROJ_ONLY, proj + bias and no more (K2). A block is
// CW warpgroups; warpgroup w owns output columns [w*CN, (w+1)*CN) of proj and
// fc2 and hidden columns [w*UN, (w+1)*UN) of every fc1 chunk, so no weight is
// needed by two warpgroups: each streams its own rows through its own ring
// (units of CN rows x KD input columns, NS of them) and the warpgroups meet
// only where they exchange a token tile (LN2, gelu(u)). park is an f32 (M, C)
// scratch map for x2, used when PARK.
template <int C, int CW, int HC, int NS, int KD, int MINB, bool PARK, bool PROJ_ONLY>
__global__ void __launch_bounds__(CW * 128, MINB) block_mlp_kernel(
    const bf16* __restrict__ attn, const bf16* __restrict__ x, const bf16* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ g2, const float* __restrict__ be2,
    const bf16* __restrict__ w1, const float* __restrict__ bb1, const bf16* __restrict__ w2,
    const float* __restrict__ bb2, float* __restrict__ park, void* __restrict__ out, int out_f32,
    long long M) {
  constexpr int HID = 4 * C;
  constexpr int KCH = C / 32;      // 32-column chunks of a token tile
  constexpr int CN = C / CW;       // output columns of one warpgroup
  constexpr int UN = HC / CW;      // hidden columns of one warpgroup per chunk
  constexpr int D = KD / 32;       // 32-column tiles in a proj or fc2 unit
  constexpr int NPU = C / KD;      // units of proj
  constexpr int SPC = HC / KD;     // units of fc1, and of fc2, per hidden chunk
  constexpr int G1 = KCH / SPC;    // 32-column tiles of w1 in an fc1 unit
  constexpr int NHC = HID / HC;
  constexpr int UNIT = CN * KD * 2;
  constexpr int UCH = HC / 32;     // chunks of a gelu(u) tile
  constexpr int NT = CW * 128;
  constexpr int T = PROJ_ONLY ? NPU : NPU + NHC * 2 * SPC;
  static_assert(C % CW == 0 && HC % CW == 0 && C % KD == 0 && HC % KD == 0 && HID % HC == 0 &&
                UN % 8 == 0 && KCH % SPC == 0 && G1 * UN * 64 == UNIT, "");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t At = base;                     // attention tile, then LN2's output
  const uint32_t Ut = At + KCH * CHUNK;         // gelu(u) of a hidden chunk, two buffers
  const uint32_t rings = Ut + 2 * UCH * CHUNK;
  float* red = reinterpret_cast<float*>(smem_raw + (rings + CW * NS * UNIT - smem_u32(smem_raw)));

  const long long m0 = (long long)blockIdx.x * MLP_TM;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const uint32_t ring = rings + wg * NS * UNIT;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const long long g0 = m0 + r0, g1 = m0 + r1;

  auto start_copy = [&](int j) {
    if (j >= T) return;
    const uint32_t buf = ring + (j % NS) * UNIT;
    if (j < NPU) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        load_tile(buf + d * CN * 64, wproj + (long long)wg * CN * C + j * KD + d * 32, C, CN, t, 128);
      return;
    }
    const int jj = j - NPU, hc = jj / (2 * SPC), r = jj - hc * 2 * SPC;
    if (r < SPC) {
#pragma unroll
      for (int g = 0; g < G1; ++g)
        load_tile(buf + g * UN * 64, w1 + (long long)(hc * HC + wg * UN) * C + (r * G1 + g) * 32, C,
                  UN, t, 128);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        load_tile(buf + d * CN * 64,
                  w2 + (long long)wg * CN * HID + hc * HC + (r - SPC) * KD + d * 32, HID, CN, t, 128);
    }
  };

  // the block's 64 rows of the attention map; rows past M read as zero
  for (int i = tid; i < MLP_TM * (C / 8); i += NT) {
    const int r = i / (C / 8), c8 = i - r * (C / 8);
    const long long row = m0 + r;
    cp16(At + (c8 >> 2) * CHUNK + r * 64 + (((c8 & 3) ^ ((r >> 1) & 3)) << 4),
         attn + (row < M ? row : M - 1) * C + c8 * 8, row < M ? 16 : 0);
  }
  cp_commit();
  for (int s = 0; s < NS - 1; ++s) {
    start_copy(s);
    cp_commit();
  }
  cp_wait<NS - 1>();  // the token tile has landed (this thread's part)
  fence_async();
  __syncthreads();

  int it = 0;
  // this warpgroup's next unit: landed, seen by its four warps, the slot of
  // the unit before it (whose products every warp has waited for) refilled
  auto acquire = [&]() -> uint32_t {
    cp_wait<NS - 2>();
    fence_async();
    wg_barrier(wg);
    start_copy(it + NS - 1);
    cp_commit();
    return ring + (it % NS) * UNIT;
  };

  float acc[CN / 2];  // proj's sums, then fc2's
#pragma unroll
  for (int i = 0; i < CN / 2; ++i) acc[i] = 0.0f;
  for (int j = 0; j < NPU; ++j) {
    const uint32_t buf = acquire();
    wgmma_fence();
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        wgmma_ss<CN>(acc, make_desc(At + (j * D + d) * CHUNK + s * 32),
                     make_desc(buf + d * CN * 64 + s * 32), (j | d | s) != 0);
    wgmma_commit();
    wgmma_wait0();
    ++it;
  }

  if constexpr (PROJ_ONLY) {
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const int col = wg * CN + 8 * j + cq;
      const float2 bp = *reinterpret_cast<const float2*>(bproj + col);
      const float v0 = acc[4 * j] + bp.x, v1 = acc[4 * j + 1] + bp.y;
      const float v2 = acc[4 * j + 2] + bp.x, v3 = acc[4 * j + 3] + bp.y;
      if (out_f32) {
        float* o = reinterpret_cast<float*>(out);
        if (g0 < M) *reinterpret_cast<float2*>(o + g0 * C + col) = make_float2(v0, v1);
        if (g1 < M) *reinterpret_cast<float2*>(o + g1 * C + col) = make_float2(v2, v3);
      } else {
        bf16* o = reinterpret_cast<bf16*>(out);
        if (g0 < M) *reinterpret_cast<uint32_t*>(o + g0 * C + col) = pack_bf16(v0, v1);
        if (g1 < M) *reinterpret_cast<uint32_t*>(o + g1 * C + col) = pack_bf16(v2, v3);
      }
    }
    cp_wait<0>();
    return;
  } else {
    // x2 = x + (o + bproj); LN2 statistics in f32 over the warpgroups
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const int col = wg * CN + 8 * j + cq;
      const float2 bp = *reinterpret_cast<const float2*>(bproj + col);
      float2 xa = make_float2(0.0f, 0.0f), xb = xa;
      if (g0 < M) xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + g0 * C + col));
      if (g1 < M) xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + g1 * C + col));
      acc[4 * j] = xa.x + (acc[4 * j] + bp.x);
      acc[4 * j + 1] = xa.y + (acc[4 * j + 1] + bp.y);
      acc[4 * j + 2] = xb.x + (acc[4 * j + 2] + bp.x);
      acc[4 * j + 3] = xb.y + (acc[4 * j + 3] + bp.y);
      s0 += acc[4 * j] + acc[4 * j + 1];
      s1 += acc[4 * j + 2] + acc[4 * j + 3];
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if ((lane & 3) == 0) {
      red[wg * MLP_TM + r0] = s0;
      red[wg * MLP_TM + r1] = s1;
    }
    __syncthreads();
    float mu0 = 0.0f, mu1 = 0.0f;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      mu0 += red[w * MLP_TM + r0];
      mu1 += red[w * MLP_TM + r1];
    }
    mu0 *= 1.0f / C;
    mu1 *= 1.0f / C;
    float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const float d0 = acc[4 * j] - mu0, d1 = acc[4 * j + 1] - mu0;
      const float d2 = acc[4 * j + 2] - mu1, d3 = acc[4 * j + 3] - mu1;
      q0 += d0 * d0 + d1 * d1;
      q1 += d2 * d2 + d3 * d3;
    }
    q0 = quad_sum(q0);
    q1 = quad_sum(q1);
    float* red2 = red + CW * MLP_TM;
    if ((lane & 3) == 0) {
      red2[wg * MLP_TM + r0] = q0;
      red2[wg * MLP_TM + r1] = q1;
    }
    __syncthreads();
    float var0 = 0.0f, var1 = 0.0f;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      var0 += red2[w * MLP_TM + r0];
      var1 += red2[w * MLP_TM + r1];
    }
    const float rs0 = rsqrtf(var0 * (1.0f / C) + 1e-5f), rs1 = rsqrtf(var1 * (1.0f / C) + 1e-5f);

    // LN2's output in bf16 replaces the attention tile (every warp is past
    // proj: the barriers above); x2 stays in registers or waits in park
    float x2r[PARK ? 1 : CN / 2];
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const int col = wg * CN + 8 * j + cq;
      const float2 g = *reinterpret_cast<const float2*>(g2 + col);
      const float2 be = *reinterpret_cast<const float2*>(be2 + col);
      const uint32_t tile = At + (col >> 5) * CHUNK;
      st_shared_u32(tile + swz(r0, col & 31),
                    pack_bf16((acc[4 * j] - mu0) * rs0 * g.x + be.x,
                              (acc[4 * j + 1] - mu0) * rs0 * g.y + be.y));
      st_shared_u32(tile + swz(r1, col & 31),
                    pack_bf16((acc[4 * j + 2] - mu1) * rs1 * g.x + be.x,
                              (acc[4 * j + 3] - mu1) * rs1 * g.y + be.y));
      if constexpr (PARK) {
        if (g0 < M) *reinterpret_cast<float2*>(park + g0 * C + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (g1 < M) *reinterpret_cast<float2*>(park + g1 * C + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        x2r[4 * j] = acc[4 * j];
        x2r[4 * j + 1] = acc[4 * j + 1];
        x2r[4 * j + 2] = acc[4 * j + 2];
        x2r[4 * j + 3] = acc[4 * j + 3];
      }
    }
    fence_async();
    __syncthreads();

    for (int hc = 0; hc < NHC; ++hc) {
      // u = h2 @ w1[hc*HC : (hc+1)*HC]^T, this warpgroup's UN columns
      float u[UN / 2];
#pragma unroll
      for (int i = 0; i < UN / 2; ++i) u[i] = 0.0f;
      for (int r = 0; r < SPC; ++r) {
        const uint32_t buf = acquire();
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < G1; ++g)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            wgmma_ss<UN>(u, make_desc(At + (r * G1 + g) * CHUNK + s * 32),
                         make_desc(buf + g * UN * 64 + s * 32), (r | g | s) != 0);
        wgmma_commit();
        wgmma_wait0();
        ++it;
      }
      // gelu(u) into buffer hc % 2: its readers of chunk hc - 2 are done,
      // since every warpgroup has since passed the barrier of chunk hc - 1
      const uint32_t ub = Ut + (hc & 1) * UCH * CHUNK;
#pragma unroll
      for (int j = 0; j < UN / 8; ++j) {
        const int cu = wg * UN + 8 * j + cq;
        const float2 b1v = *reinterpret_cast<const float2*>(bb1 + hc * HC + cu);
        const uint32_t tile = ub + (cu >> 5) * CHUNK;
        st_shared_u32(tile + swz(r0, cu & 31),
                      pack_bf16(gelu_tanh(u[4 * j] + b1v.x), gelu_tanh(u[4 * j + 1] + b1v.y)));
        st_shared_u32(tile + swz(r1, cu & 31),
                      pack_bf16(gelu_tanh(u[4 * j + 2] + b1v.x), gelu_tanh(u[4 * j + 3] + b1v.y)));
      }
      fence_async();
      __syncthreads();
      // y += gelu(u) @ w2[:, hc*HC : (hc+1)*HC]^T, this warpgroup's CN columns
      for (int r = 0; r < SPC; ++r) {
        const uint32_t buf = acquire();
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            wgmma_ss<CN>(acc, make_desc(ub + (r * D + d) * CHUNK + s * 32),
                         make_desc(buf + d * CN * 64 + s * 32), (hc | r | d | s) != 0);
        wgmma_commit();
        wgmma_wait0();
        ++it;
      }
    }

    // out = x2 + (y + bfc2)
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const int col = wg * CN + 8 * j + cq;
      const float2 b2v = *reinterpret_cast<const float2*>(bb2 + col);
      float2 xa, xb;
      if constexpr (PARK) {
        xa = xb = make_float2(0.0f, 0.0f);
        if (g0 < M) xa = *reinterpret_cast<const float2*>(park + g0 * C + col);
        if (g1 < M) xb = *reinterpret_cast<const float2*>(park + g1 * C + col);
      } else {
        xa = make_float2(x2r[4 * j], x2r[4 * j + 1]);
        xb = make_float2(x2r[4 * j + 2], x2r[4 * j + 3]);
      }
      const float v0 = xa.x + (acc[4 * j] + b2v.x), v1 = xa.y + (acc[4 * j + 1] + b2v.y);
      const float v2 = xb.x + (acc[4 * j + 2] + b2v.x), v3 = xb.y + (acc[4 * j + 3] + b2v.y);
      if (out_f32) {
        float* o = reinterpret_cast<float*>(out);
        if (g0 < M) *reinterpret_cast<float2*>(o + g0 * C + col) = make_float2(v0, v1);
        if (g1 < M) *reinterpret_cast<float2*>(o + g1 * C + col) = make_float2(v2, v3);
      } else {
        bf16* o = reinterpret_cast<bf16*>(out);
        if (g0 < M) *reinterpret_cast<uint32_t*>(o + g0 * C + col) = pack_bf16(v0, v1);
        if (g1 < M) *reinterpret_cast<uint32_t*>(o + g1 * C + col) = pack_bf16(v2, v3);
      }
    }
    cp_wait<0>();
  }
}

struct BlockArgs {
  const bf16 *x, *h1, *wqkv, *wproj, *w1, *w2;
  const float *bqkv, *bproj, *g2, *be2, *bb1, *bb2;
  const uint4* relbias;
  bf16* attn_buf;
  float* park;
  void* out;
  int B, Hp, Wp, nh, ws, shift, out_f32;
  float scale;
  cudaStream_t stream;
};

// Launch 1 at width C: HS warpgroups per window, GY blocks per window.
template <int C, int HS, int NS, int SD, int MINB, int GY>
cudaError_t launch_attn(const BlockArgs& a) {
  constexpr int smem = attn_smem_bytes<C, HS, NS, SD>();
  static_assert((C / HD) % (HS * GY) == 0, "heads must deal out evenly");
  auto kernel = window_attn_kernel<C, HS, NS, SD, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * (a.Hp / a.ws) * (a.Wp / a.ws)), (unsigned)GY);
  kernel<<<grid, HS * 128, smem, a.stream>>>(a.h1, a.wqkv, a.bqkv, a.relbias, a.attn_buf, a.Hp,
                                             a.Wp, a.ws, a.shift, a.nh / (HS * GY), a.scale);
  return cudaGetLastError();
}

template <int C, int CW, int HC, int NS, int KD, int MINB, bool PARK, bool PROJ_ONLY>
cudaError_t launch_mlp(const BlockArgs& a) {
  constexpr int smem = mlp_smem_bytes<C, CW, HC, NS, KD>();
  auto kernel = block_mlp_kernel<C, CW, HC, NS, KD, MINB, PARK, PROJ_ONLY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long M = (long long)a.B * a.Hp * a.Wp;
  if (PARK && !PROJ_ONLY && a.park == nullptr) return cudaErrorInvalidValue;
  kernel<<<(unsigned)((M + MLP_TM - 1) / MLP_TM), CW * 128, smem, a.stream>>>(
      a.attn_buf, a.x, a.wproj, a.bproj, a.g2, a.be2, a.w1, a.bb1, a.w2, a.bb2, a.park, a.out,
      a.out_f32, M);
  return cudaGetLastError();
}

// Both launches at the width's schedule (see the note at the top).
template <bool PROJ_ONLY>
cudaError_t launch_block(const BlockArgs& a, int C) {
  if (C != a.nh * HD || a.ws * a.ws > NP || a.Hp % a.ws || a.Wp % a.ws) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (C) {
    case 96:
      err = launch_attn<96, 1, 2, 3, 3, 1>(a);
      return err != cudaSuccess ? err : launch_mlp<96, 1, 96, 3, 96, 2, false, PROJ_ONLY>(a);
    case 192:
      err = launch_attn<192, 1, 2, 3, 3, 1>(a);
      return err != cudaSuccess ? err : launch_mlp<192, 2, 128, 3, 64, 1, false, PROJ_ONLY>(a);
    case 384:
      err = launch_attn<384, 1, 2, 3, 2, 3>(a);
      return err != cudaSuccess ? err : launch_mlp<384, 3, 96, 2, 96, 1, false, PROJ_ONLY>(a);
    case 768:
      err = launch_attn<768, 2, 3, 2, 1, 3>(a);
      return err != cudaSuccess ? err : launch_mlp<768, 3, 96, 2, 32, 1, true, PROJ_ONLY>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes: x, h1 (B, Hp, Wp, C) bf16; wqkv (3C, C), wproj (C, C), w1 (4C, C),
// w2 (C, 4C) bf16 in (out, in) layout; biases and LN2 f32; relbias the bias
// table of ops/window_block.py bias_fragments, (nh, 8, 128, 4) int32;
// attn_buf (B*Hp*Wp, C) bf16 scratch; park (B*Hp*Wp, C) f32 scratch, needed
// at C = 768 only; out (B, Hp, Wp, C) bf16, or f32 when out_f32. All pointers
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
extern "C" int window_block_launch(const void* x, const void* h1, const void* wqkv,
                                   const void* bqkv, const void* wproj, const void* bproj,
                                   const void* relbias, const void* g2, const void* be2,
                                   const void* w1, const void* bb1, const void* w2,
                                   const void* bb2, void* attn_buf, void* park, void* out, int B,
                                   int Hp, int Wp, int C, int nh, int ws, int shift, float scale,
                                   int out_f32, void* stream) {
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.h1 = static_cast<const bf16*>(h1);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.wproj = static_cast<const bf16*>(wproj);
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bproj = static_cast<const float*>(bproj);
  a.relbias = static_cast<const uint4*>(relbias);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  a.bb1 = static_cast<const float*>(bb1);
  a.bb2 = static_cast<const float*>(bb2);
  a.attn_buf = static_cast<bf16*>(attn_buf);
  a.park = static_cast<float*>(park);
  a.out = out;
  a.B = B; a.Hp = Hp; a.Wp = Wp; a.nh = nh; a.ws = ws; a.shift = shift; a.out_f32 = out_f32;
  a.scale = scale;
  a.stream = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch_block<false>(a, C);
}

// K2: attention and proj only. h1 (B, Hp, Wp, C) bf16, weights and attn_buf as
// above; out (B, Hp, Wp, C) bf16, or f32 when out_f32, without the residual.
extern "C" int window_attention_launch(const void* h1, const void* wqkv, const void* bqkv,
                                       const void* wproj, const void* bproj, const void* relbias,
                                       void* attn_buf, void* out, int B, int Hp, int Wp, int C,
                                       int nh, int ws, int shift, float scale, int out_f32,
                                       void* stream) {
  BlockArgs a = {};
  a.h1 = static_cast<const bf16*>(h1);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bproj = static_cast<const float*>(bproj);
  a.relbias = static_cast<const uint4*>(relbias);
  a.attn_buf = static_cast<bf16*>(attn_buf);
  a.out = out;
  a.B = B; a.Hp = Hp; a.Wp = Wp; a.nh = nh; a.ws = ws; a.shift = shift; a.out_f32 = out_f32;
  a.scale = scale;
  a.stream = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch_block<true>(a, C);
}
