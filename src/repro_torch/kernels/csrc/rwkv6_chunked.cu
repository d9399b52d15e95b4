// RWKV-6 (Finch) time mix, chunked: the recurrence
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// evaluated C tokens at a time.  Per chunk, with logw = log(max(w, 1e-30)),
// L its prefix sum over the chunk and Lprev = L - logw:
//   y_t  = (r_t * exp(Lprev_t)) S                                  (inter)
//        + sum_{s<t} [sum_c r_tc k_sc exp(Lprev_tc - L_sc)] v_s      (intra)
//        + (r_t . (u * k_t)) v_t                                    (bonus)
//   S'   = diag(exp(L_C)) S + (k * exp(L_C - L))^T V
// Every pairwise decay exp(Lprev_t - L_s), s < t, is <= 1: the stable
// difference form, never the 1/A matmul form.
// r, k, v, w: [B, S, H, 64] (f32 or bf16); u: [H, 64] (same type);
// s0: [B, H, 64, 64] f32.  y: [B, S, H, 64] f32; sout: [B, H, 64, 64] f32.
// C divides S and is at most 64.
//
// Replaces: src/repro/kernels/rwkv6_chunked.py, _rwkv6_kernel (one
// (batch, head) per grid step, the state carried through a fori loop).
//
// Bound on the H100: at the prefill shape (r, k, v, w [4, 1024, 64, 64]
// f32, chunk 16) one call moves about 344 MB (four inputs, y and both
// states), about 103 us at 3.35 TB/s, against about 5.9 GFLOP, about
// 88 us at the 67 TFLOP/s of f32 outside the tensor cores: bound by bytes.
//
// Design: one block of 256 threads per (batch, head), 256 blocks at the
// prefill shape.  The 64 x 64 f32 state stays in shared memory for the
// whole sequence; each chunk's r, k, v and L rows are staged in shared
// memory (rows padded to 65 floats so that threads walking s read distinct
// banks), the C x C scores are formed once per chunk, and y and the state
// update are written with one thread per output entry, reading the state
// and v rows along their fast axis.  Inputs and y are read and written
// once, coalesced along the head dimension.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;       // head size
constexpr int LD = HD + 1;   // padded row stride in shared memory
constexpr int THREADS = 256;

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int C) {
  return (size_t)HD * HD + 7 * (size_t)C * LD + (size_t)C * (C + 1) + C + HD;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rwkv6_chunked_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ sout, int S, int H, int C) {
  extern __shared__ float sm[];
  float* St = sm;              // state [64][64]
  float* rs = St + HD * HD;    // r, k, v [C][LD]
  float* ks = rs + C * LD;
  float* vs = ks + C * LD;
  float* Ls = vs + C * LD;     // L = prefix sum of logw
  float* Lp = Ls + C * LD;     // Lprev = L - logw
  float* rd = Lp + C * LD;     // r * exp(Lprev)
  float* kd = rd + C * LD;     // k * exp(L_C - L)
  float* sc = kd + C * LD;     // scores [C][C + 1]
  float* bonus = sc + C * (C + 1);
  float* us = bonus + C;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  for (int e = tid; e < HD * HD; e += THREADS)
    St[e] = s0[(long long)bh * HD * HD + e];
  for (int e = tid; e < HD; e += THREADS) us[e] = tof(u[h * HD + e]);

  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();           // the previous chunk's state update is done
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, c = e % HD;
      const long long off = ((long long)(b * S + t0 + t) * H + h) * HD + c;
      rs[t * LD + c] = tof(r[off]);
      ks[t * LD + c] = tof(k[off]);
      vs[t * LD + c] = tof(v[off]);
      Ls[t * LD + c] = logf(fmaxf(tof(w[off]), 1e-30f));
    }
    __syncthreads();
    if (tid < HD) {            // prefix sum down each column
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Ls[t * LD + tid];
        acc += lw;
        Ls[t * LD + tid] = acc;
        Lp[t * LD + tid] = acc - lw;
      }
    }
    __syncthreads();
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, c = e % HD;
      rd[t * LD + c] = rs[t * LD + c] * expf(Lp[t * LD + c]);
      kd[t * LD + c] = ks[t * LD + c]
                       * expf(Ls[(C - 1) * LD + c] - Ls[t * LD + c]);
    }
    for (int t = tid; t < C; t += THREADS) {
      float acc = 0.f;
      for (int c = 0; c < HD; ++c)
        acc += rs[t * LD + c] * us[c] * ks[t * LD + c];
      bonus[t] = acc;
    }
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      float acc = 0.f;
      if (s < t) {
        for (int c = 0; c < HD; ++c)
          acc += rs[t * LD + c] * ks[s * LD + c]
                 * expf(Lp[t * LD + c] - Ls[s * LD + c]);
      }
      sc[t * (C + 1) + s] = acc;
    }
    __syncthreads();
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, j = e % HD;
      float acc = 0.f;
      for (int c = 0; c < HD; ++c) acc += rd[t * LD + c] * St[c * HD + j];
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += sc[t * (C + 1) + s] * vs[s * LD + j];
      acc += intra;
      acc += bonus[t] * vs[t * LD + j];
      y[((long long)(b * S + t0 + t) * H + h) * HD + j] = acc;
    }
    __syncthreads();           // y has read the old state
    for (int e = tid; e < HD * HD; e += THREADS) {
      const int c = e / HD, j = e % HD;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += kd[s * LD + c] * vs[s * LD + j];
      St[e] = expf(Ls[(C - 1) * LD + c]) * St[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * HD; e += THREADS)
    sout[(long long)bh * HD * HD + e] = St[e];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, int B, int S,
           int H, int C, cudaStream_t stream) {
  const size_t bytes = smem_floats(C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked_kernel<T><<<B * H, THREADS, bytes, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const T*)u,
      (const float*)s0, (float*)y, (float*)sout, S, H, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_chunked_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* s0, void* y,
                                    void* sout, int B, int S, int H, int C,
                                    int is_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (C < 1 || C > HD || S % C != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, S,
                                         H, C, s)
                 : launch<float>(r, k, v, w, u, s0, y, sout, B, S, H, C, s);
}
