// ViTDet's attention with its decomposed relative-position bias, for NVIDIA
// Hopper (sm_90a): for each image and head of a packed qkv map,
//   out[q] = sum_k softmax_k(scale * q.k + bias_h[q, k / W] + bias_w[q, k % W]) v[k]
// over the n = H * W tokens of an H x W grid, the (n, n) scores never
// leaving the chip.
//
// It replaces no TPU kernel: the JAX package's ViTAttention
// (nuhtc_tpu/models/backbones.py) is plain jnp that XLA fuses on the TPU. The
// port's plain path (models/backbones.py ViTAttention) materialises the
// (b, heads, n, n) scores in device memory five times over (q.k^T, + bias_h,
// + bias_w, the f32 cast, the softmax, the bf16 cast): 16 bytes an element,
// 103 GB a batch of eight 1024^2 images in ViTDet-B's four global blocks.
//
// What bounds it on the H100: operations. q.k^T and p.v are 4 * n^2 * hd
// FLOP an image and head (412 GFLOP a global block of 8 x 12 heads x 4,096
// tokens, 0.42 ms at the bf16 peak) against 8 * n * hd bytes of q, k, v and
// the output (0.06 ms at 3.35 TB/s); at hd = 64 the softmax's one exp a
// score takes the MUFU as long as the two products take the tensor cores.
// Both products run on wgmma (64-row tiles, f32 sums in registers): S =
// q.k^T with q and k from shared memory, P.V with P from registers (the sum
// fragment converts to an A fragment in its own thread) and V read as an
// MN-major B operand, so nothing is transposed. A block is NWG warpgroups of
// 64 query rows each over one image and head; k and v go through a ring of
// NS shared-memory stages of 64 keys filled by cp.async, the copy of key
// block i + NS - 1 in flight while block i is multiplied, each stage read by
// every warpgroup of the block. Two blocks share an SM (at most 128
// registers a thread, under 113 KB of shared memory a block), so one block's
// softmax runs beside the other's products. The softmax runs online in f32
// in the base-2 domain (log2(e) folded into the scale and the bias; a
// running max and sum a row, 2^x on the MUFU), the scores and the bias stay
// in f32, P enters P.V in bf16, and the output is rescaled once by its row
// sum at the end. It leaves through the warpgroup's q tiles as 16-byte
// stores.
//
// The bias. bias_h[q, ky] = q . rel_h[y_q - ky + H - 1] and bias_w[q, kx] =
// q . rel_w[x_q - kx + W - 1], from the raw relative-position tables
// (2H - 1 and 2W - 1 rows of 64), which pass through the ring's last slot
// before the key loop. A warpgroup multiplies its 64 q rows by the tables on
// wgmma (64 table rows a product) and keeps what it needs of the products
// in shared memory in f32, log2(e) folded in, so a bias is a lookup; the
// (b, heads, n, H) and (b, heads, n, W) products never reach device memory.
// The tables take grids of at most 64 a side. Where W = 64 (the global
// blocks of a 1024^2 ViT: a 64 x 64 grid) a key block is exactly one grid
// row and a warpgroup's 64 queries are one grid row: bias_h is one value a
// query row and key block (H of them a row are kept), and bias_w is the same
// 64 values a row for every key block, which a thread keeps in registers, in
// S's fragment order, for the whole key loop. Any other grid (the 14 x 14
// windows, odd grids) keeps both products whole and looks both up a score.
// Keys past n (the tail of the last key block) are masked out; query rows
// past n are computed and not written. A window is one sequence of 196 keys
// with no mask: the padded tokens of the map take part as keys, as in the
// plain path.
//
// q, k and v are read in place from the qkv Linear output (b, n, 3, heads,
// hd) through its strides; the output is (b, n, heads * hd), proj's input.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;             // head dim: ViT-B's 768 / 12
constexpr int NWG = 2;             // warpgroups a block, 64 query rows each
constexpr int BM = 64 * NWG;       // query rows a block
constexpr int BN = 64;             // keys a step
constexpr int NS = 3;              // ring stages
constexpr int NT = NWG * 128;      // threads a block
constexpr int CHUNK = 4096;        // bytes of a [64][32] bf16 tile
constexpr int STAGE = 4 * CHUNK;   // k and v of 64 keys: two tiles each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1.0e30f;    // a masked score; exp2 of it less any max is 0
constexpr int GRID_MAX = 64;       // grid sides the bias takes: a table of 2 * 64 - 1 rows

// how the bias is read: none, looked up a score, or a grid row a key block
enum { BIAS_NONE = 0, BIAS_ANY = 1, BIAS_ROW64 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col < 32) in a [rows][32] bf16 tile under the
// 64-byte swizzle (the layout of csrc/window_block.cu): the 16-byte unit index
// is XORed with bits 1-2 of the row. The tile's base is a multiple of 512.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + ((col & 7) << 1);
}

// wgmma descriptor of such a tile: start address, 512 bytes between 8-row
// groups, 64-byte swizzle. A 16-deep step inside it adds 32 bytes.
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
// 2^x on the MUFU: exp2f's approximation (ex2.approx) without exp2f's path
// for subnormal results, which costs three more instructions a call. A
// softmax weight under 2^-126 is then 0, against a row sum of at least 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

constexpr int TS = 65;  // row stride in floats of BIAS_ROW64's tables: 64, and one against bank conflicts

// Shared memory a block needs: q and the ring, and with a bias each
// warpgroup's bias tables in f32, log2(e) folded in: BIAS_ROW64 [64][TS]
// (a block of q.rel_w^T, then the H values of bias_h a row), BIAS_ANY
// [64][2H - 1] (q.rel_h^T) and [64][2W - 1] (q.rel_w^T). The relative tables
// themselves pass through the ring's last slot, one at a time, before the
// key loop fills it.
inline int smem_bytes(int mode, int H, int W) {
  const int cols = mode == BIAS_ROW64 ? TS : mode == BIAS_ANY ? (2 * H - 1) + (2 * W - 1) : 0;
  return 1024 + NWG * 2 * CHUNK + NS * STAGE + NWG * 64 * cols * 4;
}

// Grid (ceil(n / BM), heads, b), NT threads. sb, sn, s3, sh: the element
// strides of qkv's image, token, q/k/v and head axes (the head's 64 values
// contiguous). rel_h (2H - 1, 64) and rel_w (2W - 1, 64): the relative
// position tables, row i for the offset i - (H - 1) (W - 1) of the query's
// grid row (column) from the key's. scale_log2: the softmax scale times
// log2(e).
template <int MODE>
__global__ void __launch_bounds__(NT, 2) vit_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ rel_h,
    const bf16* __restrict__ rel_w, bf16* __restrict__ out, int n, int H, int W,
    long long sb, long long sn, long long s3, long long sh, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t Qs = base;                      // NWG x two [64][32] tiles of q
  const uint32_t ring = base + NWG * 2 * CHUNK;  // NS x (k: two tiles, v: two tiles)
  const uint32_t slot = ring + (NS - 1) * STAGE; // a relative table before the key loop
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int head = blockIdx.y, bi = blockIdx.z, nh = gridDim.y;
  const int q0 = blockIdx.x * BM;
  const int nkb = (n + BN - 1) / BN;
  const bf16* qp = qkv + bi * sb + head * sh;  // q; k at + s3, v at + 2 s3
  const int TH = 2 * H - 1, TW = 2 * W - 1;    // table rows
  const int PH = (TH + 63) / 64 * 64, PW = (TW + 63) / 64 * 64;  // padded to whole products

  // rows [row0, row0 + rows) of a row-major bf16 matrix of `valid` rows (row
  // stride ld, 64 columns) into [P][32] tile pairs from dst (P: the pair's
  // rows, tiles of P * 64 bytes); rows past `valid` read as zero
  auto load_rows = [&](uint32_t dst, int P, const bf16* src, long long ld, int row0, int rows,
                       int valid) {
    for (int i = tid; i < rows * 8; i += NT) {
      const int r = i >> 3, c = (i >> 2) & 1, cc = i & 3, rr = r % P;
      const int row = row0 + r;
      const bool ok = row < valid;
      cp16(dst + (r / P) * 2 * P * 64 + c * P * 64 + rr * 64 + ((cc ^ ((rr >> 1) & 3)) << 4),
           src + (long long)(ok ? row : valid - 1) * ld + c * 32 + cc * 8, ok ? 16 : 0);
    }
  };
  auto start_copy = [&](int j) {
    if (j >= nkb) return;
    const uint32_t buf = ring + (j % NS) * STAGE;
    load_rows(buf, 64, qp + s3, sn, j * BN, BN, n);
    load_rows(buf + 2 * CHUNK, 64, qp + 2 * s3, sn, j * BN, BN, n);
  };

  // rel_h beside rel_w when both fit the slot (grids of up to 32 a side)
  const bool both = PH + PW <= 2 * 64;
  const uint32_t slot_h = both ? slot + PW * 128 : slot;
  load_rows(Qs, 64, qp, sn, q0, BM, n);
  if constexpr (MODE != BIAS_NONE) {
    load_rows(slot, PW, rel_w, HD, 0, PW, TW);
    if (both) load_rows(slot_h, PH, rel_h, HD, 0, PH, TH);
  }
  cp_commit();
  for (int s = 0; s < NS - 1; ++s) {
    start_copy(s);
    cp_commit();
  }

  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's rows of its 64
  const int cq = 2 * (lane & 3);
  const uint32_t Qw = Qs + wg * 2 * CHUNK;
  // this thread's query rows (the last token for rows past n) on the grid
  const int qr0 = min(q0 + wg * 64 + r0, n - 1), qr1 = min(q0 + wg * 64 + r1, n - 1);

  // The bias from this warpgroup's q rows times the tables: T = q.rel^T (64
  // table rows a product), so that bias_h[q, ky] = Th[q][y_q - ky + H - 1]
  // and bias_w[q, kx] = Tw[q][x_q - kx + W - 1].
  const uint32_t Tbase = ring + NS * STAGE + wg * 64 * (MODE == BIAS_ROW64 ? TS : TH + TW) * 4;
  float* const T = reinterpret_cast<float*>(smem_raw + (Tbase - smem_u32(smem_raw)));
  // q . rows [64cb, 64cb + 64) of the table at tab (the first step ignores acc)
  auto table_block = [&](float (&acc)[32], uint32_t tab, int P, int cb) {
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int st = 0; st < 2; ++st)
        wgmma_ss_n64(acc, make_desc(Qw + c * CHUNK + st * 32),
                     make_desc(tab + c * P * 64 + cb * 4096 + st * 32), (c | st) != 0);
    wgmma_commit();
    wgmma_wait0();
  };

  // BIAS_ROW64: the warpgroup's 64 rows are one grid row (y_q, and x_q = r);
  // this thread's bias_w * log2(e) at (row r_i, column 8j + cq + e) in
  // [16 i + 2 j + e], and T[r][kb] = bias_h[r, kb] * log2(e)
  float bwr[MODE == BIAS_ROW64 ? 32 : 1];
  // BIAS_ANY: each row's entry into Th and Tw
  const float* th0 = T + r0 * TH + qr0 / W + H - 1;
  const float* th1 = T + r1 * TH + qr1 / W + H - 1;
  const float* tw0 = T + 64 * TH + r0 * TW + qr0 % W + W - 1;
  const float* tw1 = T + 64 * TH + r1 * TW + qr1 % W + W - 1;
  if constexpr (MODE != BIAS_NONE) {
    const int yq = qr0 / W;
    float acc[32];
    cp_wait<NS - 1>();  // q and the tables of the first group landed (this thread's part)
    fence_async();
    __syncthreads();
    for (int cb = 0; cb < PW / 64; ++cb) {
      table_block(acc, slot, PW, cb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          if constexpr (MODE == BIAS_ROW64) {
            T[r0 * TS + c] = acc[4 * j + e] * LOG2E;
            T[r1 * TS + c] = acc[4 * j + 2 + e] * LOG2E;
          } else if (cb * 64 + c < TW) {
            T[64 * TH + r0 * TW + cb * 64 + c] = acc[4 * j + e] * LOG2E;
            T[64 * TH + r1 * TW + cb * 64 + c] = acc[4 * j + 2 + e] * LOG2E;
          }
        }
      if constexpr (MODE == BIAS_ROW64) {  // bias_w[r, kx] is column r - kx + 63
        wg_barrier(wg);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c0 = r0 - (8 * j + cq + e) + W - 1 - cb * 64;
            const int c1 = r1 - (8 * j + cq + e) + W - 1 - cb * 64;
            if (c0 >= 0 && c0 < 64) bwr[2 * j + e] = T[r0 * TS + c0];
            if (c1 >= 0 && c1 < 64) bwr[16 + 2 * j + e] = T[r1 * TS + c1];
          }
        wg_barrier(wg);
      }
    }
    if (!both) {
      __syncthreads();  // every warpgroup is done with rel_w
      load_rows(slot, PH, rel_h, HD, 0, PH, TH);
      cp_commit();
      cp_wait<0>();
      fence_async();
      __syncthreads();
    }
    for (int cb = 0; cb < PH / 64; ++cb) {
      table_block(acc, slot_h, PH, cb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb * 64 + 8 * j + cq + e;
          if constexpr (MODE == BIAS_ROW64) {  // key block kb is column yq - kb + H - 1
            const int kb = yq + H - 1 - c;
            if (kb >= 0 && kb < H) {
              T[r0 * TS + kb] = acc[4 * j + e] * LOG2E;
              T[r1 * TS + kb] = acc[4 * j + 2 + e] * LOG2E;
            }
          } else if (c < TH) {
            T[r0 * TH + c] = acc[4 * j + e] * LOG2E;
            T[r1 * TH + c] = acc[4 * j + 2 + e] * LOG2E;
          }
        }
    }
    wg_barrier(wg);
  }

  const float inv_w = 1.0f / W;
  float o0[16], o1[16];  // output columns 0-31 and 32-63, in the n32 fragment order
#pragma unroll
  for (int i = 0; i < 16; ++i) o0[i] = o1[i] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;  // running max (log2 domain) and this thread's part of the sum

  for (int kb = 0; kb < nkb; ++kb) {
    cp_wait<NS - 2>();  // key block kb (and q) landed, this thread's part
    fence_async();
    __syncthreads();    // ... every thread's part; every warpgroup is done with block kb - 1
    start_copy(kb + NS - 1);
    cp_commit();
    const uint32_t Ks = ring + (kb % NS) * STAGE, Vs = Ks + 2 * CHUNK;
    const int kbase = kb * BN;
    float bhr0 = 0.0f, bhr1 = 0.0f;
    if constexpr (MODE == BIAS_ROW64) {  // the key block is grid row kb
      bhr0 = T[r0 * TS + kb];
      bhr1 = T[r1 * TS + kb];
    }

    // S = q k^T (64 x 64), f32 (the first step ignores what s holds)
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int st = 0; st < 2; ++st)
        wgmma_ss_n64(s, make_desc(Qw + c * CHUNK + st * 32), make_desc(Ks + c * CHUNK + st * 32),
                     (c | st) != 0);
    wgmma_commit();
    wgmma_wait0();

    // t = (scale q.k + bias) log2(e); d[4j + e] is row r0, d[4j + 2 + e] row r1,
    // column 8j + cq + e
    const bool tail = kbase + BN > n;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        float b0 = 0.0f, b1 = 0.0f;
        if constexpr (MODE == BIAS_ROW64) {  // bias_h, one value a row, is added below
          b0 = bwr[2 * j + e];
          b1 = bwr[16 + 2 * j + e];
        } else if constexpr (MODE == BIAS_ANY) {
          // key / W through the reciprocal: exact while key + 0.5 < 2^22
          const int key = min(kbase + col, n - 1);
          const int ky = __float2int_rz((key + 0.5f) * inv_w), kx = key - ky * W;
          b0 = th0[-ky] + tw0[-kx];
          b1 = th1[-ky] + tw1[-kx];
        }
        float v0 = fmaf(s[4 * j + e], scale_log2, b0);
        float v1 = fmaf(s[4 * j + 2 + e], scale_log2, b1);
        if (tail && kbase + col >= n) v0 = v1 = NEG;
        s[4 * j + e] = v0;
        s[4 * j + 2 + e] = v1;
      }
    // the rows' maxima as trees, not chains of 16
    float mx[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      mx[8 + j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        mx[j] = fmaxf(mx[j], mx[j + w]);
        mx[8 + j] = fmaxf(mx[8 + j], mx[8 + j + w]);
      }
    const float mx0 = fmaxf(m0, quad_max(mx[0]) + bhr0);
    const float mx1 = fmaxf(m1, quad_max(mx[8]) + bhr1);
    const float a0 = exp2_ftz(m0 - mx0), a1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    const float sub0 = m0 - bhr0, sub1 = m1 - bhr1;  // p = exp2(t + bias_h - max)
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o0[4 * j] *= a0; o0[4 * j + 1] *= a0; o0[4 * j + 2] *= a1; o0[4 * j + 3] *= a1;
      o1[4 * j] *= a0; o1[4 * j + 1] *= a0; o1[4 * j + 2] *= a1; o1[4 * j + 3] *= a1;
    }
    float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the new weights' sums, two a row
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2_ftz(s[4 * j + e] - sub0), p1 = exp2_ftz(s[4 * j + 2 + e] - sub1);
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        ls[e] += p0;
        ls[2 + e] += p1;
      }
    l0 += ls[0] + ls[1];
    l1 += ls[2] + ls[3];
    // P in bf16 as the A operand of four 16-key steps
    uint32_t pa[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int ja = 2 * st, jb = 2 * st + 1;
      pa[st][0] = pack_bf16(s[4 * ja], s[4 * ja + 1]);
      pa[st][1] = pack_bf16(s[4 * ja + 2], s[4 * ja + 3]);
      pa[st][2] = pack_bf16(s[4 * jb], s[4 * jb + 1]);
      pa[st][3] = pack_bf16(s[4 * jb + 2], s[4 * jb + 3]);
    }

    // O += P V: 16 keys (16 rows of each v tile) a step, v's two 32-column tiles
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      wgmma_rs_n32_mn(o0, pa[st], make_desc(Vs + st * 1024), 1);
      wgmma_rs_n32_mn(o1, pa[st], make_desc(Vs + CHUNK + st * 1024), 1);
    }
    wgmma_commit();
    wgmma_wait0();
  }

  // O / row sum in bf16 through the warpgroup's q tiles (its products are
  // done; each warp writes its own rows), then 16 bytes a thread to out
  const float i0 = 1.0f / quad_sum(l0), i1 = 1.0f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 8 * j + cq;
    st_shared_u32(Qw + swz(r0, col), pack_bf16(o0[4 * j] * i0, o0[4 * j + 1] * i0));
    st_shared_u32(Qw + swz(r1, col), pack_bf16(o0[4 * j + 2] * i1, o0[4 * j + 3] * i1));
    st_shared_u32(Qw + CHUNK + swz(r0, col), pack_bf16(o1[4 * j] * i0, o1[4 * j + 1] * i0));
    st_shared_u32(Qw + CHUNK + swz(r1, col), pack_bf16(o1[4 * j + 2] * i1, o1[4 * j + 3] * i1));
  }
  wg_barrier(wg);
  const long long C = (long long)nh * HD;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = t + 128 * k, r = i >> 3, c = (i >> 2) & 1, cc = i & 3;
    const int tok = q0 + wg * 64 + r;
    if (tok < n) {
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(Qw + c * CHUNK + r * 64 + ((cc ^ ((r >> 1) & 3)) << 4)));
      *reinterpret_cast<uint4*>(out + ((long long)bi * n + tok) * C + head * HD + c * 32 + cc * 8) = v;
    }
  }
  cp_wait<0>();
}

template <int MODE>
cudaError_t launch(const bf16* qkv, const bf16* rel_h, const bf16* rel_w, bf16* out, int b,
                   int n, int H, int W, int nh, long long sb, long long sn, long long s3,
                   long long sh, float scale_log2, cudaStream_t stream) {
  auto kernel = vit_attention_kernel<MODE>;
  const int smem = smem_bytes(MODE, H, W);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)nh, (unsigned)b);
  kernel<<<grid, NT, smem, stream>>>(qkv, rel_h, rel_w, out, n, H, W, sb, sn, s3, sh,
                                     scale_log2);
  return cudaGetLastError();
}

}  // namespace

// qkv: bf16, element (image, token, part, head, d < 64) at sb*image + sn*token
// + s3*part + sh*head + d, every stride a multiple of 8 and the pointer
// 16-byte aligned. rel_h (2H - 1, 64) and rel_w (2W - 1, 64) bf16,
// contiguous, 16-byte aligned, H and W at most 64 and H * W = n; both null
// for no bias. out (b, n, heads * 64) bf16. Returns a cudaError_t code
// (0 = launched).
extern "C" int vit_attention_launch(const void* qkv, const void* rel_h, const void* rel_w,
                                    void* out, int b, int n, int H, int W, int nh, long long sb,
                                    long long sn, long long s3, long long sh, float scale,
                                    void* stream) {
  if (b < 1 || n < 1 || nh < 1 || b > 65535 || nh > 65535 || (rel_h == nullptr) != (rel_w == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rel_h != nullptr && (H < 1 || W < 1 || H > GRID_MAX || W > GRID_MAX || H * W != n))
    return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* th = static_cast<const bf16*>(rel_h);
  const bf16* tw = static_cast<const bf16*>(rel_w);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float sl = scale * LOG2E;
  if (rel_h == nullptr)
    return (int)launch<BIAS_NONE>(q, th, tw, o, b, n, H, W, nh, sb, sn, s3, sh, sl, st);
  if (W == BN)
    return (int)launch<BIAS_ROW64>(q, th, tw, o, b, n, H, W, nh, sb, sn, s3, sh, sl, st);
  return (int)launch<BIAS_ANY>(q, th, tw, o, b, n, H, W, nh, sb, sn, s3, sh, sl, st);
}
