// GQA attention with an online softmax (flash attention), causal,
// sliding-window and q_offset masks:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
// q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; o: [B, Sq, Hq, D] in q's type
// (f32 or bf16; all arithmetic in f32).  G = Hq / Hkv.  Query row i sits
// at position q_offset + i; key j is masked when j > q_offset + i (causal)
// or j <= q_offset + i - window (window > 0).  Masked scores are -1e30,
// not -inf, so a key block that is masked for a row before its first
// unmasked key is erased by alpha = exp(m - m_new) = 0, exactly as in the
// Pallas body.  Any Sq and Sk: the ragged edges are masked here.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (one q
// block in VMEM streaming its kv head's K/V blocks on the matrix unit).
//
// Bound on the H100: at the prefill shape (q [4, 1024, 40, 128], k/v
// [4, 1024, 10, 128], causal) the scores and the weighted sum need about
// 43 GFLOP against 105 MB of q, k, v and o: compute-bound, 43.5 us at the
// 989 TFLOP/s of the bf16 tensor cores.  At the decode shape (one query
// row per head against the cache) it is bound by the bytes of the keys
// and values up to q_offset.
//
// Design (simple first; wgmma and TMA come later): one block of 128
// threads per (tile of 32 rows, kv head, batch), where a row is one
// (query position, query head of this kv head's group) pair, so each K/V
// tile staged in shared memory serves all G heads that read it and a
// decode step (Sq = 1) still fills a block with G rows.  Four threads
// share a row, each holding a quarter of q and of the f32 accumulator in
// registers and reading float4s of K/V (conflict-free, broadcast across
// rows); the partial dot products meet by warp shuffles.  Key tiles past
// the tile's last causal position are skipped: every score there is
// masked and its block would be a no-op.  The arithmetic is f32 on the
// CUDA cores, far from the tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TPR = 4;               // threads per row
constexpr int BR = 32;               // rows per block
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int THREADS = BR * TPR;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hq,
    int Hkv, float scale, int causal, int window, int q_offset) {
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
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sq * (Hq / Hkv) + BR - 1) / BR, Hkv, B);
#define FLASH_CASE(DIM)                                                    \
  case DIM:                                                                \
    flash_attention_kernel<T, DIM><<<grid, THREADS, 0, stream>>>(          \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, Hq, Hkv,     \
        scale, causal, window, q_offset);                                  \
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

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int is_bf16, int causal, int window,
                                      int q_offset, float scale,
                                      void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D,
                                         causal, window, q_offset, scale, s)
                 : launch<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal,
                                 window, q_offset, scale, s);
}
