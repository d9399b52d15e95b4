// The gradient of GQA attention (flash_attention.cu) from its row
// log-sum-exp, recomputing the probabilities instead of storing them:
//   P[i, j]  = exp(q_i . k_j * scale - lse_i)     (0 where masked)
//   Delta_i  = sum_d dO[i, d] O[i, d]
//   dS[i, j] = P[i, j] (dO_i . v_j - Delta_i)
//   dQ_i = scale sum_j dS[i, j] k_j
//   dK_j = scale sum_i dS[i, j] q_i,  dV_j = sum_i P[i, j] dO_i
// dK and dV of kv head hk sum over the G query heads hk * G .. hk * G +
// G - 1.  q, o, dO, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]
// (f32 or bf16); lse, Delta: f32 [B, Hq, Sq], lse in natural units as
// both forward paths write it.  Query row i sits at position i
// (training attends from 0); key j is masked when j > i (causal) or
// j <= i - window (window > 0), as in the forward.  A row is one (query
// position, query head of the kv head's group) pair, r = i * G + g, the
// forward's row order, so one K / V tile serves all G heads.
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// trains through XLA's autodiff of its plain attention
// (src/repro/models/common.py:166 chunked_attention, differentiated by
// jax.value_and_grad in src/repro/train/step.py:54).  The port's
// attention is its own kernel, which autograd cannot see through, so
// its gradient needs this one.
//
// Bound on the H100: MiniCPM-2B's training shape (q, k, v [8, 2048, 36,
// 64] bf16, causal) needs 2.5x the forward's 4 D flops per unmasked pair
// (five products: S, dP, dV, dK, dQ), 386.7 GFLOP, against 606 MB of q,
// k, v, o, dO, dq, dk, dv and the lse (0.181 ms at 3.35 TB/s):
// compute-bound, 0.391 ms at the 989 TFLOP/s of the bf16 tensor cores,
// so only wgmma reaches it.
//
// Two launches, in this order on one stream, with no atomics, so the same
// inputs give the same bits (a resumed training run repeats its losses):
// launch 0 computes dQ and Delta, launch 1 dK and dV, reading Delta.  Each
// kv head's G query heads are summed inside one block, in a fixed order.
// S and dP are computed in both launches (seven products where the bound
// counts five), so that neither needs atomics.  One C entry point, two
// paths; the caller picks one (kernels/ops.py, flash_bwd_plan):
//
// 1. wgmma (bf16, Sq * G >= 64 rows, D = 64 or 128).  One warpgroup a
//    block; 64 x 64 tiles; operands in shared memory in the 128-byte
//    swizzle that wgmma reads (flash_common.cuh, the forward's pieces),
//    filled by cp.async so that tile t + 1 loads while tile t is
//    computed; accumulators in f32 registers.
//    Launch 0: a block owns 64 rows of one (batch, kv head): Q and dO in
//    shared memory, Delta from dO and O in global memory first.  It walks
//    the key tiles the rows can see (causal and window bounds; fully
//    masked tiles skipped), K / V double-buffered: S = Q K^T and dP =
//    dO V^T (both operands K-major, as the forward's S), P =
//    exp2(S scale log2e - lse log2e) and dS = P (dP - Delta) in f32
//    registers on the accumulator fragment, dS rounded to bf16 A
//    fragments in place, and dQ += dS K (K read MN-major, as the
//    forward's O += P V).  The longest causal row tiles start first.
//    Launch 1: a block owns 64 keys of one (batch, kv head): K and V in
//    shared memory, dK and dV in f32 registers.  It walks the 64-row
//    tiles that can see those keys, Q / dO / lse / Delta double-buffered:
//    S^T = K Q^T, dP^T = V dO^T, then P^T and dS^T as above, dV += P^T
//    dO and dK += dS^T Q.  The element mask runs only on the diagonal
//    and window-edge tiles and on ragged tails (Sq * G or Sk not a
//    multiple of 64).  P and dS enter the products in bf16, as in SDPA's
//    backward; their sums stay f32.  At D 128 launch 1 holds 128 f32
//    accumulators a thread for dK and dV.
// 2. simt (every other case: f32, D 32, fewer than 64 rows).
//    stage 0 (dQ): a block of 128 threads takes 32 rows, four threads a
//    row, each holding a quarter of q, dO and the dQ sum in registers.
//    It computes Delta_i from dO and O, stores it, and walks the 32-key
//    tiles the rows may see: per key the two dot products (reduced over
//    the four threads), P from the lse, dS, and dQ += dS k.
//    stage 1 (dK, dV): a block takes 32 keys of one (batch, kv head),
//    four threads a key, each holding a quarter of k, v and the two sums;
//    it walks the G query heads and, for each, the 32-row tiles of q, dO,
//    lse and Delta that can see its keys (staged in shared memory), per
//    row the same two dot products, P, dS, then dV += P dO, dK += dS q.
//    f32 FMAs on the CUDA cores: the f32 tolerance (1e-4) rules out TF32
//    and bf16 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::LOG2E;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::desc_sw128;
using flash::dot4;
using flash::fence_proxy_async;
using flash::fence_regs;
using flash::load4;
using flash::pack_bf16;
using flash::smem_u32;
using flash::store4;
using flash::sw128;
using flash::wg_commit;
using flash::wg_fence;
using flash::wg_wait0;
using flash::wgmma_rs;
using flash::wgmma_ss;
using bf16 = __nv_bfloat16;

// key j hidden from the query at position i
__device__ __forceinline__ bool masked(int i, int j, int causal,
                                       int window) {
  return (causal && j > i) || (window > 0 && j <= i - window);
}

// ------------------------------------------------------------ path 2 --
constexpr int TPR = 4;               // threads per row (or key)
constexpr int BR = 32;               // rows (stage 0) or keys (1) a block
constexpr int BT = 32;               // keys (0) or rows (1) a shared tile
constexpr int THREADS = BR * TPR;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x += a * x.x; acc.y += a * x.y; acc.z += a * x.z; acc.w += a * x.w;
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq,
    int Hkv, float scale, int causal, int window) {
  constexpr int D4 = D / 4;
  constexpr int NV = D4 / TPR;       // float4s of a row per thread
  __shared__ float4 Ks[BT][D4];
  __shared__ float4 Vs[BT][D4];

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % TPR;
  const int rows = Sq * G;
  const int r_first = blockIdx.x * BR;
  const int r = r_first + tid / TPR;
  const bool valid = r < rows;
  const int qi = valid ? r / G : 0;
  const int h = hk * G + (valid ? r % G : 0);
  const int r_last = min(r_first + BR, rows) - 1;
  const int kend = causal ? min(Sk, r_last / G + 1) : Sk;
  const int kbeg = window > 0 ? max(0, r_first / G - window + 1) : 0;

  const long long qoff = ((long long)(b * Sq + qi) * Hq + h) * D;
  float4 qv[NV], dov[NV], acc[NV];
  float di = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int e = (n * TPR + c) * 4;
    qv[n] = scale4(load4(q + qoff + e), scale);
    dov[n] = load4(dout + qoff + e);
    di += dot4(dov[n], load4(o + qoff + e));
    acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  di = quad_sum(di);
  const long long lidx = ((long long)b * Hq + h) * Sq + qi;
  const float L = valid ? lse[lidx] : 0.f;
  if (valid && c == 0) delta[lidx] = di;

  for (int k0 = kbeg; k0 < kend; k0 += BT) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < BT * D4; e += THREADS) {
      const int j = e / D4, dd = e % D4, kp = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kp < Sk) {
        const long long off = ((long long)(b * Sk + kp) * Hkv + hk) * D +
                              dd * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      Ks[j][dd] = kx;
      Vs[j][dd] = vx;
    }
    __syncthreads();

    for (int j = 0; j < BT; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        s += dot4(qv[n], Ks[j][n * TPR + c]);
        dp += dot4(dov[n], Vs[j][n * TPR + c]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const int kp = k0 + j;
      const float p = (!valid || kp >= Sk || masked(qi, kp, causal, window))
                          ? 0.f : expf(s - L);
      const float ds = p * (dp - di);
#pragma unroll
      for (int n = 0; n < NV; ++n) fma4(acc[n], ds, Ks[j][n * TPR + c]);
    }
  }

  if (valid) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
      store4(dq + qoff + (n * TPR + c) * 4, scale4(acc[n], scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    float scale, int causal, int window) {
  constexpr int D4 = D / 4;
  constexpr int NV = D4 / TPR;
  __shared__ float4 Qs[BT][D4];
  __shared__ float4 Os[BT][D4];      // dO
  __shared__ float Ls[BT], Ds[BT];

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % TPR;
  const int j_first = blockIdx.x * BR;
  const int j = j_first + tid / TPR;
  const bool valid = j < Sk;
  const int j_last = min(j_first + BR, Sk) - 1;
  // the rows that can see a key of this block: i >= j (causal) and
  // i < j + window (window)
  const int qbeg = causal ? j_first : 0;
  const int qend = window > 0 ? min(Sq, j_last + window) : Sq;

  const long long koff = ((long long)(b * Sk + (valid ? j : 0)) * Hkv + hk) *
                         D;
  float4 kv[NV], vv[NV], dka[NV], dva[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int e = (n * TPR + c) * 4;
    kv[n] = scale4(load4(k + koff + e), scale);
    vv[n] = load4(v + koff + e);
    dka[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[n] = dka[n];
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int i0 = qbeg; i0 < qend; i0 += BT) {
      __syncthreads();               // the previous tile is consumed
      for (int e = tid; e < BT * D4; e += THREADS) {
        const int rr = e / D4, dd = e % D4, qp = i0 + rr;
        float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), ox = qx;
        if (qp < Sq) {
          const long long off = ((long long)(b * Sq + qp) * Hq + h) * D +
                                dd * 4;
          qx = load4(q + off);
          ox = load4(dout + off);
        }
        Qs[rr][dd] = qx;
        Os[rr][dd] = ox;
      }
      for (int rr = tid; rr < BT; rr += THREADS) {
        const int qp = i0 + rr;
        const long long li = ((long long)b * Hq + h) * Sq + qp;
        Ls[rr] = qp < Sq ? lse[li] : 0.f;
        Ds[rr] = qp < Sq ? delta[li] : 0.f;
      }
      __syncthreads();

      for (int rr = 0; rr < BT; ++rr) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          s += dot4(kv[n], Qs[rr][n * TPR + c]);
          dp += dot4(vv[n], Os[rr][n * TPR + c]);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const int qp = i0 + rr;
        const float p = (!valid || qp >= Sq || masked(qp, j, causal, window))
                            ? 0.f : expf(s - Ls[rr]);
        const float ds = p * (dp - Ds[rr]);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          fma4(dva[n], p, Os[rr][n * TPR + c]);
          fma4(dka[n], ds, Qs[rr][n * TPR + c]);
        }
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = (n * TPR + c) * 4;
      store4(dk + koff + e, scale4(dka[n], scale));
      store4(dv + koff + e, dva[n]);
    }
  }
}

// ------------------------------------------------------------ path 1 --
constexpr int WG = 64;               // rows or keys of a tile
constexpr int WG_THREADS = 128;      // one warpgroup
constexpr int BLK = WG * 128;        // bytes of a 64 x 64 bf16 block
constexpr int LD_BYTES = 2 * WG * 4; // lse and Delta of a row tile

// Dynamic shared memory, each 64 x D tile stored as D / 64 column blocks
// of 128-byte rows, 1 KB of slack for alignment.  Launch 0: Q, dO, then
// two stages of (K, V).  Launch 1: K, V, two stages of (Q, dO), then two
// stages of (lse, Delta).
constexpr int dq_smem_bytes(int D) { return 1024 + (D / 64) * BLK * 6; }
constexpr int dkv_smem_bytes(int D) {
  return 1024 + (D / 64) * BLK * 6 + 2 * LD_BYTES;
}

// 4 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

// element offset of row r (< rows) of (batch b, kv head hk) in a
// [B, S, Hq, D] tensor
__device__ __forceinline__ long long row_off(int b, int r, int S, int Hq,
                                             int hk, int G, int D) {
  return ((long long)(b * S + r / G) * Hq + hk * G + r % G) * D;
}

// cp.async of a 64 x D tile of rows [r0, r0 + 64) of (b, hk) from x into
// the swizzled tile at dst; rows past ``rows`` are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* x,
                                          int r0, int rows, int b, int S,
                                          int Hq, int hk, int G, int tid) {
  constexpr int CH = D / 8;
  for (int e = tid; e < WG * CH; e += WG_THREADS) {
    const int r = e / CH, c = e % CH, gr = r0 + r;
    const bool ok = gr < rows;
    cp_async16(dst + (c / 8) * BLK + sw128(r, c % 8),
               x + row_off(b, ok ? gr : 0, S, Hq, hk, G, D) + c * 8, ok);
  }
}

// cp.async of keys [j0, j0 + 64) of (b, hk) from k and v ([B, Sk, Hkv,
// D]); keys past Sk are zero-filled
template <int D>
__device__ __forceinline__ void load_keys(uint32_t ks, uint32_t vs,
                                          const bf16* k, const bf16* v,
                                          int j0, int Sk, int b, int Hkv,
                                          int hk, int tid) {
  constexpr int CH = D / 8;
  for (int e = tid; e < WG * CH; e += WG_THREADS) {
    const int j = e / CH, c = e % CH, kp = j0 + j;
    const bool ok = kp < Sk;
    const long long off =
        ((long long)(b * Sk + (ok ? kp : 0)) * Hkv + hk) * D + c * 8;
    const uint32_t dst = (c / 8) * BLK + sw128(j, c % 8);
    cp_async16(ks + dst, k + off, ok);
    cp_async16(vs + dst, v + off, ok);
  }
}

// s = A0 B0^T and t = A1 B1^T over D, all four 64 x D tiles in shared
// memory, K-major (the forward's S = Q K^T): D / 16 wgmmas a product in
// one committed group, waited for
template <int D>
__device__ __forceinline__ void two_products(float (&s)[32], uint32_t a0,
                                             uint32_t b0, float (&t)[32],
                                             uint32_t a1, uint32_t b1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = 0.f;
    t[e] = 0.f;
  }
  fence_regs(s);
  fence_regs(t);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BLK + (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(a0 + off), desc_sw128(b0 + off), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BLK + (kk % 4) * 32;
    wgmma_ss(t, desc_sw128(a1 + off), desc_sw128(b1 + off), kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs(s);
  fence_regs(t);
}

// acc[nb] += A . B over one 64-deep tile: A the four bf16 fragments of a
// 64 x 64 accumulator (registers), B a 64 x D tile in shared memory read
// MN-major (the forward's O += P V); issued, not waited for
template <int NB>
__device__ __forceinline__ void product_rs(float (&acc)[NB][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < WG / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_rs(acc[nb], a[kk], desc_sw128(bt + nb * BLK + kk * 2048));
}

// Accumulator element e of a thread in a 64 x 64 tile: row (M) 16 warp +
// lane / 4 + 8 ((e >> 1) & 1), column (N) 8 (e >> 2) + 2 (lane % 4) +
// (e & 1).  Elements 8 kk .. 8 kk + 7 are the A fragment of k-step kk.

// Launch 0: dQ and Delta of 64 rows of one (batch, kv head).
template <int D>
__global__ void __launch_bounds__(WG_THREADS) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int B, int Sq, int Sk,
    int Hq, int Hkv, float scale, int causal, int window) {
  constexpr int NB = D / 64;
  constexpr int TILE = NB * BLK;             // bytes of a 64 x D tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ float Ds[WG];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + TILE;
  const uint32_t skv = sdo + TILE;           // stage st: K, then V

  const int G = Hq / Hkv, rows = Sq * G;
  const int n_tiles = (rows + WG - 1) / WG;
  const int hb = Hkv * B;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / hb);  // longest first
  const int hk = (int)(blockIdx.x % hb) % Hkv;
  const int b = (int)(blockIdx.x % hb) / Hkv;
  const int row0 = tile * WG, tid = threadIdx.x;
  const int p_first = row0 / G, p_last = (min(row0 + WG, rows) - 1) / G;
  // key tiles [kt0, kt1) hold every key a row of the tile can see
  const int kend = causal ? min(Sk, p_last + 1) : Sk;
  const int kbeg = window > 0 ? max(0, p_first - window + 1) : 0;
  const int kt0 = kbeg / WG, kt1 = kend > kbeg ? (kend + WG - 1) / WG : kt0;

  load_rows<D>(sq, q, row0, rows, b, Sq, Hq, hk, G, tid);
  load_rows<D>(sdo, dout, row0, rows, b, Sq, Hq, hk, G, tid);
  if (kt0 < kt1)
    load_keys<D>(skv, skv + TILE, k, v, kt0 * WG, Sk, b, Hkv, hk, tid);
  cp_async_commit();                         // group: Q, dO and tile kt0

  // Delta = rowsum(dO o O), two threads a row, while the tiles load
  {
    const int r = tid / 2, half = tid % 2, gr = row0 + r;
    float d = 0.f;
    if (gr < rows) {
      const long long off = row_off(b, gr, Sq, Hq, hk, G, D) + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 4)
        d += dot4(load4(dout + off + c), load4(o + off + c));
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      Ds[r] = d;
      if (gr < rows)
        delta[((long long)b * Hq + hk * G + gr % G) * Sq + gr / G] = d;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const float scale_log2 = scale * LOG2E;
  int qpos[2];
  bool rvalid[2];
  float l2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = 16 * warp + lane / 4 + 8 * i, gr = row0 + lr;
    rvalid[i] = gr < rows;
    qpos[i] = rvalid[i] ? gr / G : 0;
    l2[i] = rvalid[i]
                ? lse[((long long)b * Hq + hk * G + gr % G) * Sq + gr / G] *
                      LOG2E
                : 0.f;
    di[i] = Ds[lr];
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % 2;
    if (kt + 1 < kt1) {                      // overlaps this tile's math
      const uint32_t nx = skv + (st ^ 1) * 2 * TILE;
      load_keys<D>(nx, nx + TILE, k, v, (kt + 1) * WG, Sk, b, Hkv, hk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // tile kt (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = skv + st * 2 * TILE, vs = ks + TILE;

    float s[32], dp[32];
    two_products<D>(s, sq, ks, dp, sdo, vs);   // S = Q K^T, dP = dO V^T

    const int k0 = kt * WG;
    const bool edge = k0 + WG > Sk || row0 + WG > rows ||
                      (causal && k0 + WG - 1 > p_first) ||
                      (window > 0 && k0 <= p_last - window);
    uint32_t ds[WG / 16][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = (e >> 1) & 1;
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p = exp2f(s[e + h] * scale_log2 - l2[i]);
        if (edge) {
          const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + h;
          if (!rvalid[i] || kp >= Sk || masked(qpos[i], kp, causal, window))
            p = 0.f;
        }
        x[h] = p * (dp[e + h] - di[i]);
      }
      ds[e / 8][(e % 8) / 2] = pack_bf16(x[0], x[1]);
    }

#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wg_fence();
    product_rs<NB>(acc, ds, ks);             // dQ += dS K
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncthreads();                         // stage free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int gr = row0 + 16 * warp + lane / 4 + 8 * i;
    bf16* dst = dq + row_off(b, gr, Sq, Hq, hk, G, D) + 2 * (lane & 3);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * 64 + 8 * n) =
            __floats2bfloat162_rn(acc[nb][4 * n + 2 * i] * scale,
                                  acc[nb][4 * n + 2 * i + 1] * scale);
  }
}

// Launch 1: dK and dV of 64 keys of one (batch, kv head).
template <int D>
__global__ void __launch_bounds__(WG_THREADS) flash_bwd_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Sk,
    int Hq, int Hkv, float scale, int causal, int window) {
  constexpr int NB = D / 64;
  constexpr int TILE = NB * BLK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + TILE;
  const uint32_t srow = sv + TILE;           // stage st: Q, then dO
  const uint32_t sld = srow + 4 * TILE;      // stage st: lse, then Delta
  const float* ld = reinterpret_cast<const float*>(smem_raw + (sld - base));

  const int G = Hq / Hkv, rows = Sq * G;
  const int hb = Hkv * B;
  const int kt = (int)(blockIdx.x / hb);     // early keys (most rows) first
  const int hk = (int)(blockIdx.x % hb) % Hkv;
  const int b = (int)(blockIdx.x % hb) / Hkv;
  const int j0 = kt * WG, tid = threadIdx.x;
  const int j_last = min(j0 + WG, Sk) - 1;
  // row tiles [rt0, rt1) hold every row that can see a key of the block:
  // position i >= j (causal), i < j + window (window)
  const int rbeg = causal ? min(rows, j0 * G) : 0;
  const int rend = window > 0 ? min(rows, (j_last + window) * G) : rows;
  const int rt0 = rbeg / WG, rt1 = rend > rbeg ? (rend + WG - 1) / WG : rt0;

  auto load_tile = [&](int rt, int st) {
    const uint32_t dst = srow + st * 2 * TILE;
    load_rows<D>(dst, q, rt * WG, rows, b, Sq, Hq, hk, G, tid);
    load_rows<D>(dst + TILE, dout, rt * WG, rows, b, Sq, Hq, hk, G, tid);
    const int gr = rt * WG + tid % WG;     // thread t: lse (t < 64) or Delta
    const bool ok = gr < rows;
    const long long li =
        ok ? ((long long)b * Hq + hk * G + gr % G) * Sq + gr / G : 0;
    cp_async4(sld + st * LD_BYTES + tid * 4, (tid < WG ? lse : delta) + li,
              ok);
  };
  load_keys<D>(sk, sv, k, v, j0, Sk, b, Hkv, hk, tid);
  if (rt0 < rt1) load_tile(rt0, 0);
  cp_async_commit();                         // group: K, V and tile rt0

  const int warp = tid / 32, lane = tid % 32;
  const float scale_log2 = scale * LOG2E;
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = j0 + 16 * warp + lane / 4 + 8 * i;
  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dka[nb][e] = 0.f;
      dva[nb][e] = 0.f;
    }

  for (int rt = rt0; rt < rt1; ++rt) {
    const int st = (rt - rt0) % 2;
    if (rt + 1 < rt1) load_tile(rt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile rt (and K, V) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t sqt = srow + st * 2 * TILE, sdot = sqt + TILE;
    const float* ls = ld + st * 2 * WG;      // lse of the tile's rows
    const float* dl = ls + WG;               // Delta

    float s[32], dp[32];
    two_products<D>(s, sk, sqt, dp, sv, sdot);  // S^T = K Q^T, dP^T = V dO^T

    const int r0 = rt * WG;
    const bool edge = j0 + WG > Sk || r0 + WG > rows ||
                      (causal && j0 + WG - 1 > r0 / G) ||
                      (window > 0 &&
                       j0 <= (min(r0 + WG, rows) - 1) / G - window);
    uint32_t pa[WG / 16][4], ds[WG / 16][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = (e >> 1) & 1;
      float p[2], x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * (e >> 2) + 2 * (lane & 3) + h;   // row of the tile
        float pv = exp2f(s[e + h] * scale_log2 - ls[c] * LOG2E);
        if (edge) {
          const int r = r0 + c;
          if (r >= rows || kpos[i] >= Sk ||
              masked(r / G, kpos[i], causal, window))
            pv = 0.f;
        }
        p[h] = pv;
        x[h] = pv * (dp[e + h] - dl[c]);
      }
      pa[e / 8][(e % 8) / 2] = pack_bf16(p[0], p[1]);
      ds[e / 8][(e % 8) / 2] = pack_bf16(x[0], x[1]);
    }

#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dva[nb]);
      fence_regs(dka[nb]);
    }
    wg_fence();
    product_rs<NB>(dva, pa, sdot);           // dV += P^T dO
    product_rs<NB>(dka, ds, sqt);            // dK += dS^T Q
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dva[nb]);
      fence_regs(dka[nb]);
    }
    __syncthreads();                         // stage free for tile rt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= Sk) continue;
    const long long off =
        ((long long)(b * Sk + kpos[i]) * Hkv + hk) * D + 2 * (lane & 3);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int e = 4 * n + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + nb * 64 + 8 * n) =
            __floats2bfloat162_rn(dka[nb][e] * scale, dka[nb][e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + nb * 64 + 8 * n) =
            __floats2bfloat162_rn(dva[nb][e], dva[nb][e + 1]);
      }
  }
}

// ---------------------------------------------------------- launchers --
template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
             int causal, int window, float scale, int stage,
             cudaStream_t stream) {
  if (stage == 0) {
    const dim3 grid((Sq * (Hq / Hkv) + BR - 1) / BR, Hkv, B);
    flash_bwd_dq_kernel<T, D><<<grid, THREADS, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        lse, delta, (T*)dq, Sq, Sk, Hq, Hkv, scale, causal, window);
  } else {
    const dim3 grid((Sk + BR - 1) / BR, Hkv, B);
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, Sq, Sk, Hq, Hkv, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
           int causal, int window, float scale, int stage,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                             Sk, Hq, Hkv, causal, window, scale, stage,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                             Sk, Hq, Hkv, causal, window, scale, stage,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                              Sq, Sk, Hq, Hkv, causal, window, scale, stage,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_wgmma_d(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window,
                   float scale, int stage, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes(D));
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem_bytes(D));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long tiles =
      stage == 0 ? ((long long)Sq * (Hq / Hkv) + WG - 1) / WG
                 : ((long long)Sk + WG - 1) / WG;
  const long long blocks = tiles * Hkv * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (stage == 0) {
    flash_bwd_dq_wgmma_kernel<D><<<(unsigned)blocks, WG_THREADS,
                                   dq_smem_bytes(D), stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
        (const bf16*)dout, lse, delta, (bf16*)dq, B, Sq, Sk, Hq, Hkv, scale,
        causal, window);
  } else {
    flash_bwd_dkv_wgmma_kernel<D><<<(unsigned)blocks, WG_THREADS,
                                    dkv_smem_bytes(D), stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        lse, delta, (bf16*)dk, (bf16*)dv, B, Sq, Sk, Hq, Hkv, scale, causal,
        window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// path: 0 simt, 1 wgmma (bf16, D 64 or 128).  stage 0: dq and delta (f32
// [B, Hq, Sq], rowsum(dO o O)); stage 1: dk and dv, reading delta.
// Launch stage 0, then stage 1, on the same stream and the same path.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int is_bf16,
    int causal, int window, float scale, int path, int stage,
    void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (stage != 0 && stage != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  switch (path) {
    case 0:
      return is_bf16
                 ? launch<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                Sk, Hq, Hkv, D, causal, window, scale, stage,
                                s)
                 : launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                 Sk, Hq, Hkv, D, causal, window, scale, stage,
                                 s);
    case 1:
      if (!is_bf16) return (int)cudaErrorInvalidValue;
      if (D == 64)
        return launch_wgmma_d<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                  Sk, Hq, Hkv, causal, window, scale, stage,
                                  s);
      if (D == 128)
        return launch_wgmma_d<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                   Sq, Sk, Hq, Hkv, causal, window, scale,
                                   stage, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}
