// GQA attention with an online softmax (flash attention), causal,
// sliding-window and q_offset masks:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
// q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; o: [B, Sq, Hq, D] in q's type
// (f32 or bf16; softmax in f32).  G = Hq / Hkv.  Query row i sits at
// position q_offset + i; key j is masked when j > q_offset + i (causal)
// or j <= q_offset + i - window (window > 0).  Masked scores are -1e30,
// not -inf, so a key block that is masked for a row before its first
// unmasked key is erased by alpha = exp(m - m_new) = 0, exactly as in the
// Pallas body, and a row with no unmasked key averages V over every key,
// as the reference's softmax of equal scores does.  Keys past Sk weigh
// exactly 0 (-inf).  Any Sq and Sk: the ragged edges are masked here.
//
// Replaces: src/repro/kernels/flash_attention.py:78, _flash_kernel (one
// q block in VMEM streaming its kv head's K/V blocks on the matrix unit).
//
// Bound on the H100: at the prefill shape (q [4, 1024, 40, 128], k/v
// [4, 1024, 10, 128], bf16, causal) the unmasked scores and the weighted
// sum need 43 GFLOP against 105 MB of q, k, v and o: compute-bound,
// 43.5 us at the 989 TFLOP/s of the bf16 tensor cores, so only wgmma
// reaches it.  At the decode shape (Sq = 1, cache 701 of 1,024) it is
// bound by the 14.4 MB of keys and values up to q_offset, 4.3 us at
// 3.35 TB/s, so the cache has to be streamed by many SMs at once.
//
// A row is one (query position, query head of the kv head's group)
// pair: rows r = i * G + g of one (batch, kv head) share every K/V tile,
// so one tile staged in shared memory serves all G heads.  One C entry
// point, three paths; the caller picks one (kernels/ops.py, flash_plan):
//
// 1. wgmma (bf16, Sq * G >= 64 rows, D = 64 or 128; prefill).  One
//    warpgroup per 64-row Q tile.  Q and a two-stage ring of 64-key K/V
//    tiles sit in shared memory in the 128-byte swizzle that wgmma reads,
//    filled by cp.async so that tile t + 1 loads while tile t is
//    computed.  S = Q K^T is one m64n64k16 wgmma per 16 of D (K read
//    K-major as stored); scale, masks and the online softmax run in f32
//    registers on the accumulator fragment, whose (row, key) each thread
//    knows; P is rounded to bf16 in place (the f32 fragment of S is the
//    A fragment of the next wgmma) and O += P V runs m64n64k16 wgmmas
//    with V read MN-major through the transpose bit.  l sums the f32 p.
//    Key tiles past the Q tile's last causal position are skipped, and
//    the longest causal Q tiles start first.
// 2. split (Sq * G <= 16 rows; decode, f32 or bf16).  The keys [0, kend)
//    are cut into splits of a multiple of 64 keys, enough that the grid
//    holds about two blocks per SM.  A block takes the real rows of one
//    (split, kv head, batch), spreads its 128 threads over keys for the
//    scores and over columns for P V, and writes f32 partials (m, l,
//    acc[D]) of each row; a second launch combines them:
//    O = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30).
//    Each split's m starts at -1e30, so a split of padding alone gives
//    l = 0 and a split masked wholly at -1e30 vanishes beside any split
//    with a real score.
// 3. simt (every other case; f32 prefill).  A block of 128 threads takes
//    32 rows, four threads a row, f32 FMAs on the CUDA cores: the f32
//    tolerance (2e-5) rules out TF32 and bf16 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::LN2;
using flash::LOG2E;
using flash::MASKED;
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

// ------------------------------------------------------------ path 3 --
constexpr int TPR = 4;               // threads per row
constexpr int BR = 32;               // rows per block
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int THREADS = BR * TPR;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int Hq, int Hkv, float scale, int causal, int window,
    int q_offset) {
  constexpr int D4 = D / 4;          // float4s per key row
  constexpr int NV = D4 / TPR;       // float4s of a row per thread
  __shared__ float4 Ks[BK][D4];
  __shared__ float4 Vs[BK][D4];

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % TPR;
  const int rows = Sq * G;
  const int r = blockIdx.x * BR + tid / TPR;
  const bool valid = r < rows;
  const int qi = valid ? r / G : 0;
  const int h = hk * G + (valid ? r % G : 0);
  const int qpos = q_offset + qi;
  const int r_last = min((int)blockIdx.x * BR + BR, rows) - 1;
  const int kend = causal ? min(Sk, q_offset + r_last / G + 1) : Sk;

  const long long qoff = ((long long)(b * Sq + qi) * Hq + h) * D;
  float4 qv[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float4 x = load4(q + qoff + (i * TPR + c) * 4);
    qv[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = MASKED, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < BK * D4; e += THREADS) {
      const int j = e / D4, dd = e % D4, kp = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kp < Sk) {
        const long long off = ((long long)(b * Sk + kp) * Hkv + hk) * D
                              + dd * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      Ks[j][dd] = kx;
      Vs[j][dd] = vx;
    }
    __syncthreads();

    float s[BK];
    float mt = MASKED;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) p += dot4(qv[i], Ks[j][i * TPR + c]);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int kp = k0 + j;
      if (kp >= Sk) {
        p = -INFINITY;               // padding past Sk: weight exactly 0
      } else if ((causal && kp > qpos) ||
                 (window > 0 && kp <= qpos - window)) {
        p = MASKED;
      }
      s[j] = p;
      mt = fmaxf(mt, p);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      lsum += s[j];
    }
    l = l * alpha + lsum;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha;
      acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vx = Vs[j][i * TPR + c];
        acc[i].x += s[j] * vx.x; acc[i].y += s[j] * vx.y;
        acc[i].z += s[j] * vx.z; acc[i].w += s[j] * vx.w;
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      store4(o + qoff + (i * TPR + c) * 4,
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                         acc[i].w * inv));
    }
    // the row's log-sum-exp of the scaled scores (m is in their units)
    if (lse != nullptr && c == 0)
      lse[((long long)b * Hq + h) * Sq + qi] = m + logf(l);
  }
}

// ------------------------------------------------------------ path 1 --
constexpr int WG_ROWS = 64;          // rows of a Q tile (one warpgroup)
constexpr int WG_KEYS = 64;          // keys of a K/V tile
constexpr int WG_THREADS = 128;
constexpr int STAGES = 2;            // K/V ring depth

// Dynamic shared memory of path 1: Q, then STAGES x (K, V), each stored
// as D / 64 column blocks of 128-byte rows; 1 KB of slack for alignment.
constexpr int wg_smem_bytes(int D) {
  return 1024 + (D / 64) * 128 * (WG_ROWS + STAGES * 2 * WG_KEYS);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS) flash_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int B, int Sq, int Sk, int Hq, int Hkv,
    float scale_log2, int causal, int window, int q_offset) {
  constexpr int NB = D / 64;                 // 64-column blocks
  constexpr int CH = D / 8;                  // 16-byte chunks of a row
  constexpr int Q_BLK = WG_ROWS * 128;       // bytes of one Q column block
  constexpr int KV_BLK = WG_KEYS * 128;      // ... of one K or V block
  constexpr int KV_BYTES = NB * KV_BLK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + NB * Q_BLK;

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int n_tiles = (rows + WG_ROWS - 1) / WG_ROWS;
  const int hb = Hkv * B;
  // longest causal Q tiles first: block 0.. take the last tiles
  const int tile = n_tiles - 1 - (int)(blockIdx.x / hb);
  const int hk = (int)(blockIdx.x % hb) % Hkv;
  const int b = (int)(blockIdx.x % hb) / Hkv;
  const int row0 = tile * WG_ROWS;
  const int tid = threadIdx.x;
  const int r_last = min(row0 + WG_ROWS, rows) - 1;
  const int kend = causal ? min(Sk, q_offset + r_last / G + 1) : Sk;
  const int n_kt = (kend + WG_KEYS - 1) / WG_KEYS;
  const int qpos_first = q_offset + row0 / G;

  for (int e = tid; e < WG_ROWS * CH; e += WG_THREADS) {
    const int r = e / CH, c = e % CH, gr = row0 + r;
    const bool ok = gr < rows;
    const int pos = ok ? gr / G : 0, h = hk * G + (ok ? gr % G : 0);
    cp_async16(sq + (c / 8) * Q_BLK + sw128(r, c % 8),
               q + ((long long)(b * Sq + pos) * Hq + h) * D + c * 8, ok);
  }
  auto load_kv = [&](int kt) {
    const uint32_t ks = skv + (kt % STAGES) * 2 * KV_BYTES;
    for (int e = tid; e < WG_KEYS * CH; e += WG_THREADS) {
      const int j = e / CH, c = e % CH, kp = kt * WG_KEYS + j;
      const bool ok = kp < Sk;
      const long long off =
          ((long long)(b * Sk + (ok ? kp : 0)) * Hkv + hk) * D + c * 8;
      const uint32_t dst = (c / 8) * KV_BLK + sw128(j, c % 8);
      cp_async16(ks + dst, k + off, ok);
      cp_async16(ks + KV_BYTES + dst, v + off, ok);
    }
  };
  load_kv(0);
  cp_async_commit();                         // group: Q and tile 0

  const int warp = tid / 32, lane = tid % 32;
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + 16 * warp + lane / 4 + 8 * i;
    rvalid[i] = gr < rows;
    qpos[i] = q_offset + (rvalid[i] ? gr / G : 0);
  }
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  float oacc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[nb][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);      // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();                      // tile kt (and Q) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = skv + (kt % STAGES) * 2 * KV_BYTES;
    const uint32_t vs = ks + KV_BYTES;

    // S = Q K^T: accumulator element e of a thread is row
    // 16 warp + lane / 4 + 8 ((e >> 1) & 1), key 8 (e >> 2) + 2 (lane % 4)
    // + (e & 1) of the tile.
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_sw128(sq + (kk / 4) * Q_BLK + (kk % 4) * 32),
               desc_sw128(ks + (kk / 4) * KV_BLK + (kk % 4) * 32), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    const int k0 = kt * WG_KEYS;
    const bool edge = k0 + WG_KEYS > Sk || window > 0 ||
                      (causal && k0 + WG_KEYS - 1 > qpos_first);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (kp >= Sk) {
          x = -INFINITY;
        } else if ((causal && kp > qpos[i]) ||
                   (window > 0 && kp <= qpos[i] - window)) {
          x = MASKED;
        }
      }
      s[e] = x;
      mt[i] = fmaxf(mt[i], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      alpha[i] = exp2f(m[i] - mt[i]);
      m[i] = mt[i];
      l[i] *= alpha[i];
    }
    uint32_t pa[WG_KEYS / 16][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = (e >> 1) & 1;
      const float p0 = exp2f(s[e] - m[i]), p1 = exp2f(s[e + 1] - m[i]);
      l[i] += p0 + p1;                       // the f32 p, not the bf16
      pa[e / 8][(e % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[nb][e] *= alpha[(e >> 1) & 1];

    // O += P V: V's 16 keys of step kk are two 8-key groups of 128-byte
    // rows, 1,024 B apart; its 64 columns of block nb are one row's width.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_KEYS / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        wgmma_rs(oacc[nb], pa[kk], desc_sw128(vs + nb * KV_BLK + kk * 2048));
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
    __syncthreads();                         // stage free for tile kt + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int gr = row0 + 16 * warp + lane / 4 + 8 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp, from m and l in log2 units
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * Hq + hk * G + gr % G) * Sq + gr / G] =
          (m[i] + log2f(l[i])) * LN2;
    __nv_bfloat16* dst =
        o + ((long long)(b * Sq + gr / G) * Hq + hk * G + gr % G) * D +
        2 * (lane & 3);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * 64 + 8 * n) =
            __floats2bfloat162_rn(oacc[nb][4 * n + 2 * i] * inv,
                                  oacc[nb][4 * n + 2 * i + 1] * inv);
      }
  }
}

// ------------------------------------------------------------ path 2 --
constexpr int SPLIT_ROWS = 16;       // most rows (Sq * G) a block takes
constexpr int SPLIT_KEYS = 32;       // keys of a shared-memory tile
constexpr int SPLIT_THREADS = 128;   // 4 warps

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Partials of one (split, kv head, batch): warp w scores rows w, w + 4,
// ... against the tile's 32 keys, one key a lane; thread t then
// accumulates column t % D of rows t / D, t / D + 128 / D, ...  Scratch:
// acc [B, Hkv, n_split, R, D], then (m, l) [B, Hkv, n_split, R, 2], f32,
// m in log2 units.
template <typename T, int D>
__global__ void __launch_bounds__(SPLIT_THREADS) flash_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ part, int B, int Sq,
    int Sk, int Hq, int Hkv, float scale_log2, int causal, int window,
    int q_offset, int kend, int split_len) {
  constexpr int D4 = D / 4;
  constexpr int TPC = SPLIT_THREADS / D;     // threads per column
  constexpr int RPT = SPLIT_ROWS / TPC;      // rows a thread accumulates
  __shared__ float4 qs[SPLIT_ROWS][D4];
  __shared__ float4 ks[SPLIT_KEYS][D4 + 1];  // padded: lanes read rows
  __shared__ __align__(16) float vs[SPLIT_KEYS][D];
  __shared__ float ps[SPLIT_ROWS][SPLIT_KEYS];
  __shared__ float alpha_s[SPLIT_ROWS];

  const int G = Hq / Hkv, R = Sq * G;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lo = split * split_len, hi = min(kend, lo + split_len);

  for (int e = tid; e < R * D4; e += SPLIT_THREADS) {
    const int r = e / D4, dd = e % D4;
    const long long off =
        ((long long)(b * Sq + r / G) * Hq + hk * G + r % G) * D + dd * 4;
    float4 x = load4(q + off);
    qs[r][dd] = make_float4(x.x * scale_log2, x.y * scale_log2,
                            x.z * scale_log2, x.w * scale_log2);
  }
  float m[SPLIT_ROWS / 4], l[SPLIT_ROWS / 4];   // rows warp + 4 x
#pragma unroll
  for (int x = 0; x < SPLIT_ROWS / 4; ++x) {
    m[x] = MASKED;
    l[x] = 0.f;
  }
  const int col = tid % D, rbase = tid / D;
  float acc[RPT];
#pragma unroll
  for (int y = 0; y < RPT; ++y) acc[y] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += SPLIT_KEYS) {
    __syncthreads();                         // the previous tile is consumed
    for (int e = tid; e < SPLIT_KEYS * D4; e += SPLIT_THREADS) {
      const int j = e / D4, dd = e % D4, kp = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kp < hi) {
        const long long off =
            ((long long)(b * Sk + kp) * Hkv + hk) * D + dd * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      ks[j][dd] = kx;
      *reinterpret_cast<float4*>(&vs[j][dd * 4]) = vx;
    }
    __syncthreads();

    const int kp = k0 + lane;
#pragma unroll
    for (int x = 0; x < SPLIT_ROWS / 4; ++x) {
      const int r = warp + 4 * x;
      if (r >= R) continue;                  // uniform across the warp
      float sc = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D4; ++dd) sc += dot4(qs[r][dd], ks[lane][dd]);
      const int qpos = q_offset + r / G;
      if (kp >= hi) {
        sc = -INFINITY;                      // outside the split
      } else if ((causal && kp > qpos) ||
                 (window > 0 && kp <= qpos - window)) {
        sc = MASKED;
      }
      float mt = sc;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m[x], mt);
      const float p = exp2f(sc - m_new);
      float ls = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, w);
      const float alpha = exp2f(m[x] - m_new);
      l[x] = l[x] * alpha + ls;
      m[x] = m_new;
      ps[r][lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int y = 0; y < RPT; ++y) {
      const int r = rbase + TPC * y;
      if (r >= R) continue;
      float a = acc[y] * alpha_s[r];
#pragma unroll 8
      for (int j = 0; j < SPLIT_KEYS; ++j) a += ps[r][j] * vs[j][col];
      acc[y] = a;
    }
  }

  const long long pbase = (((long long)b * Hkv + hk) * n_split + split) * R;
#pragma unroll
  for (int y = 0; y < RPT; ++y) {
    const int r = rbase + TPC * y;
    if (r >= R) continue;
    part[(pbase + r) * D + col] = acc[y];
  }
  float* ml = part + (long long)B * Hkv * n_split * R * D;
  if (lane == 0) {
#pragma unroll
    for (int x = 0; x < SPLIT_ROWS / 4; ++x) {
      const int r = warp + 4 * x;
      if (r >= R) continue;
      ml[(pbase + r) * 2] = m[x];
      ml[(pbase + r) * 2 + 1] = l[x];
    }
  }
}

// One block per (row, kv head, batch), one thread per column.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_combine_kernel(
    const float* __restrict__ part, T* __restrict__ o, int B, int Sq,
    int Hq, int Hkv, int n_split) {
  const int G = Hq / Hkv, R = Sq * G;
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int col = threadIdx.x;
  const float* ml = part + (long long)B * Hkv * n_split * R * D;
  const long long base = ((long long)b * Hkv + hk) * n_split * R + r;
  float mx = MASKED;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, ml[(base + (long long)s * R) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long i = base + (long long)s * R;
    const float w = exp2f(ml[i * 2] - mx);
    num += w * part[i * D + col];
    den += w * ml[i * 2 + 1];
  }
  store1(o + ((long long)(b * Sq + r / G) * Hq + hk * G + r % G) * D + col,
         num / fmaxf(den, 1e-30f));
}

// ---------------------------------------------------------- launchers --
template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                int causal, int window, int q_offset, float scale,
                cudaStream_t stream) {
  const dim3 grid((Sq * (Hq / Hkv) + BR - 1) / BR, Hkv, B);
#define FLASH_CASE(DIM)                                                    \
  case DIM:                                                                \
    flash_simt_kernel<T, DIM><<<grid, THREADS, 0, stream>>>(               \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, Hq,     \
        Hkv, scale, causal, window, q_offset);                             \
    break;
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes(D);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long n_tiles = (Sq * (long long)(Hq / Hkv) + WG_ROWS - 1) /
                            WG_ROWS;
  const long long blocks = n_tiles * Hkv * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<D><<<(unsigned)blocks, WG_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, B, Sq, Sk, Hq, Hkv,
      scale * LOG2E, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_split_d(const void* q, const void* k, const void* v, void* o,
                   float* part, int B, int Sq, int Sk, int Hq, int Hkv,
                   int causal, int window, int q_offset, float scale,
                   int kend, int split_len, int n_split,
                   cudaStream_t stream) {
  flash_split_kernel<T, D><<<dim3(n_split, Hkv, B), SPLIT_THREADS, 0,
                             stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part, B, Sq, Sk, Hq, Hkv,
      scale * LOG2E, causal, window, q_offset, kend, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_combine_kernel<T, D><<<dim3(Sq * (Hq / Hkv), Hkv, B), D, 0,
                               stream>>>(part, (T*)o, B, Sq, Hq, Hkv,
                                         n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 float* part, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                 int causal, int window, int q_offset, float scale,
                 int split_len, int n_split, cudaStream_t stream) {
  const int kend = causal ? (q_offset + Sq < Sk ? q_offset + Sq : Sk) : Sk;
  if (part == nullptr || Sq * (Hq / Hkv) > SPLIT_ROWS || split_len < 1 ||
      n_split < 1 || (long long)(n_split - 1) * split_len >= kend ||
      (long long)n_split * split_len < kend)
    return (int)cudaErrorInvalidValue;      // splits must tile [0, kend)
  switch (D) {
    case 32:
      return launch_split_d<T, 32>(q, k, v, o, part, B, Sq, Sk, Hq, Hkv,
                                   causal, window, q_offset, scale, kend,
                                   split_len, n_split, stream);
    case 64:
      return launch_split_d<T, 64>(q, k, v, o, part, B, Sq, Sk, Hq, Hkv,
                                   causal, window, q_offset, scale, kend,
                                   split_len, n_split, stream);
    case 128:
      return launch_split_d<T, 128>(q, k, v, o, part, B, Sq, Sk, Hq, Hkv,
                                    causal, window, q_offset, scale, kend,
                                    split_len, n_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// path: 0 simt, 1 wgmma, 2 split (split_len, n_split and the f32 scratch
// of B * Hkv * n_split * Sq * G * (D + 2) floats are read by path 2 only).
// lse: null, or (paths 0 and 1) the f32 [B, Hq, Sq] row log-sum-exp of
// the scaled scores, which the backward (flash_attention_bwd.cu) reads.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int is_bf16, int causal, int window,
                                      int q_offset, float scale, int path,
                                      int split_len, int n_split,
                                      void* scratch, void* lse,
                                      void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* rowlse = (float*)lse;
  switch (path) {
    case 0:
      return is_bf16 ? launch_simt<__nv_bfloat16>(q, k, v, o, rowlse, B, Sq,
                                                  Sk, Hq, Hkv, D, causal,
                                                  window, q_offset, scale, s)
                     : launch_simt<float>(q, k, v, o, rowlse, B, Sq, Sk, Hq,
                                          Hkv, D, causal, window, q_offset,
                                          scale, s);
    case 1:
      if (!is_bf16) return (int)cudaErrorInvalidValue;
      if (D == 64)
        return launch_wgmma_d<64>(q, k, v, o, rowlse, B, Sq, Sk, Hq, Hkv,
                                  causal, window, q_offset, scale, s);
      if (D == 128)
        return launch_wgmma_d<128>(q, k, v, o, rowlse, B, Sq, Sk, Hq, Hkv,
                                   causal, window, q_offset, scale, s);
      return (int)cudaErrorInvalidValue;
    case 2:
      if (rowlse != nullptr) return (int)cudaErrorInvalidValue;
      return is_bf16
                 ? launch_split<__nv_bfloat16>(q, k, v, o, (float*)scratch,
                                               B, Sq, Sk, Hq, Hkv, D, causal,
                                               window, q_offset, scale,
                                               split_len, n_split, s)
                 : launch_split<float>(q, k, v, o, (float*)scratch, B, Sq,
                                       Sk, Hq, Hkv, D, causal, window,
                                       q_offset, scale, split_len, n_split,
                                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
