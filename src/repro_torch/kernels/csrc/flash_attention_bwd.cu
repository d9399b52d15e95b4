// The gradient of GQA attention (flash_attention.cu) from its row
// log-sum-exp, recomputing the probabilities instead of storing them:
//   P[i, j]  = exp(q_i . k_j * scale - lse_i)     (0 where masked)
//   Delta_i  = sum_d dO[i, d] O[i, d]
//   dS[i, j] = P[i, j] (dO_i . v_j - Delta_i)
//   dQ_i = scale sum_j dS[i, j] k_j
//   dK_j = scale sum_i dS[i, j] q_i,  dV_j = sum_i P[i, j] dO_i
// dK and dV of kv head hk sum over the G query heads hk * G .. hk * G +
// G - 1.  q, o, dO, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]
// (f32 or bf16; arithmetic in f32); lse, Delta: f32 [B, Hq, Sq].  Query
// row i sits at position i (training attends from 0); key j is masked
// when j > i (causal) or j <= i - window (window > 0), as in the
// forward.  Any Sq, Sk and D of 32, 64 or 128.
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// trains through XLA's autodiff of its plain attention
// (src/repro/models/common.py:166 chunked_attention, differentiated by
// jax.value_and_grad in src/repro/train/step.py:54).  The port's
// attention is its own kernel, which autograd cannot see through, so
// its gradient needs this one.
//
// Bound on the H100: MiniCPM-2B's training shape (q, k, v [4, 2048, 36,
// 64] bf16, causal) needs 2.5x the forward's 4 D flops per unmasked
// pair, 38.7 GFLOP, against 47 MB of q, k, v, o, dO, dq, dk, dv and the
// lse: compute-bound, 39 us at the 989 TFLOP/s of the bf16 tensor cores.
// This first version does not reach for that: it multiplies in f32 on
// the CUDA cores (at most 67 TFLOP/s), like the forward's simt path.
//
// Two launches, in this order on one stream, with no atomics, so the same
// inputs give the same bits (a resumed training run repeats its losses):
//
// stage 0 (dQ): a block of 128 threads takes 32 rows (row r = i * G + g
//   of one (batch, kv head), the forward's row order, so one K / V tile
//   in shared memory serves the G heads), four threads a row, each
//   holding a quarter of q, dO and the dQ sum in registers.  It computes
//   Delta_i from dO and O, stores it, and walks the 32-key tiles the rows
//   may see: per key the two dot products (reduced over the four
//   threads), P from the lse, dS, and dQ += dS k.
// stage 1 (dK, dV): a block takes 32 keys of one (batch, kv head), four
//   threads a key, each holding a quarter of k, v and the two sums; it
//   walks the G query heads and, for each, the 32-row tiles of q, dO,
//   lse and Delta that can see its keys (staged in shared memory), per
//   row the same two dot products, P, dS, then dV += P dO, dK += dS q.
//   A kv head's group is summed inside its block, in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::dot4;
using flash::load4;
using flash::store4;

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

// key j hidden from the query at position i
__device__ __forceinline__ bool masked(int i, int j, int causal,
                                       int window) {
  return (causal && j > i) || (window > 0 && j <= i - window);
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

}  // namespace

// stage 0: dq and delta (f32 [B, Hq, Sq], rowsum(dO o O)); stage 1: dk and
// dv, reading delta.  Launch stage 0, then stage 1, on the same stream.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int is_bf16,
    int causal, int window, float scale, int stage, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (stage != 0 && stage != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  return is_bf16
             ? launch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                     Sq, Sk, Hq, Hkv, D, causal, window,
                                     scale, stage, s)
             : launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                             Hq, Hkv, D, causal, window, scale, stage, s);
}
