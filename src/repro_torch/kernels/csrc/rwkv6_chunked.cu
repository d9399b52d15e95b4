// RWKV-6 (Finch) time mix, chunked: the recurrence
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// evaluated C tokens at a time, in the log2 domain.  Per chunk, with
// L = prefix sum of log2(max(w, 1e-30)) over the chunk and Lprev_t =
// L_{t-1} (0 for the first token):
//   y_t = (r_t * 2^Lprev_t) S + sum_{s<=t} P_ts v_s,
//   P_ts = sum_c r_tc k_sc 2^(Lprev_tc - L_sc)  (s < t),
//   P_tt = r_t . (u * k_t)                       (the bonus, on the diagonal)
//   S'  = diag(2^L_C) S + (k * 2^(L_C - L))^T V
// so y = [r * 2^Lprev | P] @ [S ; V] is one product of depth 64 + C.
// Every pairwise decay 2^(Lprev_t - L_s), s < t, is <= 1: the stable
// difference form, never the 1/A matmul form.
// r, k, v, w: [B, S, H, 64] (f32 or bf16); u: [H, 64] (same type);
// s0: [B, H, 64, 64] f32.  y: [B, S, H, 64] f32; sout: [B, H, 64, 64] f32;
// states: null (serving) or [B, H, S / C, 64, 64] f32, the state at the
// start of each chunk (the first is s0), which the backward kernel
// (rwkv6_chunked_bwd.cu) reads; the state warps write it from the
// registers that hold it, before the chunk's update.
// C divides S and is at most 64; every pointer is 16-byte aligned.
//
// Replaces: src/repro/kernels/rwkv6_chunked.py, _rwkv6_kernel (one
// (batch, head) per grid step, the state carried through a fori loop).
//
// Bound on the H100: at the prefill shape (r, k, v, w [4, 1024, 64, 64]
// f32, chunk 16) one call moves about 344 MB (four inputs, y and both
// states), about 103 us at 3.35 TB/s, against about 5.4 GFLOP, about
// 80 us at the 67 TFLOP/s of f32 outside the tensor cores: bound by bytes.
// TF32 tensor cores would round each operand at ~5e-4, above the 1e-4
// this kernel is held to, so the products stay in f32 FMAs.
//
// Design: one block of 256 threads per (batch, head), 256 blocks at the
// prefill shape, two blocks an SM at C <= 16.  An f32 kernel of this shape
// is bound on the SM by shared-memory operand traffic and SFU work, not by
// device memory; what the design does about them:
// - a ring of chunks: each chunk's r, k, v, w rows are copied into shared
//   memory with 16-byte cp.async while the chunk before computes (two
//   stages at C <= 32, one above, where two would not fit); rows are
//   padded by 4 floats, so they stay 16-byte aligned;
// - decays: a warp-shuffle scan of log2(w) down each column (4 segments
//   of C/4 tokens a column), every decay one ex2.approx instruction;
// - scores: a group of 8 lanes splits the 64 channels and forms the 8
//   pairs (t, s), s in [8j, 8j + 8), of one row at once: 8 independent
//   sums that one reduce-scatter of 7 shuffles leaves one a lane; the bonus
//   is the diagonal pair; batches spread over all 8 warps, so the SFU work
//   is shared by the 4 schedulers;
// - products register-tiled, depth-major A operand [r * 2^Lprev | P]^T:
//   warps 0-3 form y, each thread a 4 x 8 tile over a quarter of the depth
//   64 + C, the quarters reduced by 24 shuffles; warps 4-7 update the
//   state, each thread a 4 x 8 tile kept in registers for the whole
//   sequence, depth C; every operand is a float4, 32 FMA per 3 loads; the
//   state is double-buffered in shared memory, so y (reading the old state)
//   and the update (writing the new one) run side by side;
// - three barriers a chunk (four at C > 32).
// C that is not a multiple of 16 runs as the next multiple, CP: the
// padding rows hold k = v = 0 and log2 w = 0, so they change nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HD = 64;          // head size
constexpr int LDR = HD + 4;     // row stride of the [token][channel] tiles
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory layout, in floats, for chunks padded to CP tokens
template <int CP>
struct Layout {
  static constexpr int NSTAGE = CP <= 32 ? 2 : 1;
  static constexpr int TILE = CP * LDR;              // one [CP][LDR] tile
  static constexpr int LDT = CP + 4;                 // row stride of AT
  static constexpr int RING = 0;                     // [NSTAGE][r, k, v, w]
  static constexpr int SBUF = RING + NSTAGE * 4 * TILE;  // state [2][64][64]
  // y's A operand depth-major: [r * 2^Lprev | P]^T, [64 + CP][LDT]
  static constexpr int AT = SBUF + 2 * HD * HD;
  static constexpr int KDEC = AT + (HD + CP) * LDT;  // k * 2^(L_C - L)
  static constexpr int AC = KDEC + TILE;             // 2^L_C [64]
  static constexpr int TOTAL = AC + HD;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 2^x in one SFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int CP>
__global__ void __launch_bounds__(THREADS, CP <= 16 ? 2 : 1)
rwkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const T* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ y, float* __restrict__ sout,
                     float* __restrict__ states, int S, int H, int C) {
  using Lay = Layout<CP>;
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long tok = (long long)H * HD;             // token stride
  const long long base = (long long)b * S * tok + (long long)h * HD;

  // zero the ring (padding rows stay 0) and the scores (s > t stays 0)
  for (int e = tid; e < Lay::SBUF; e += THREADS) sm[e] = 0.f;
  for (int e = tid; e < CP * Lay::LDT; e += THREADS)
    sm[Lay::AT + HD * Lay::LDT + e] = 0.f;
  __syncthreads();

  // copy chunk ci's r, k, v, w rows into ring stage `stage`
  auto load_chunk = [&](int ci, int stage) {
    float* dst = sm + Lay::RING + stage * 4 * Lay::TILE;
    const long long off = base + (long long)ci * C * tok;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T* src = (a == 0 ? r : a == 1 ? k : a == 2 ? v : w) + off;
      float* da = dst + a * Lay::TILE;
      for (int e = tid; e < 16 * C; e += THREADS) {   // 4 values a piece
        const int t = e >> 4, q = (e & 15) * 4;
        if constexpr (std::is_same<T, float>::value) {
          cp_async16(da + t * LDR + q, src + t * tok + q);
        } else {                                       // bf16: via registers
          const uint2 raw = *reinterpret_cast<const uint2*>(src + t * tok + q);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          st4(da + t * LDR + q, lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
    if constexpr (std::is_same<T, float>::value) cp_async_commit();
  };

  // score lanes: group of 8 lanes, channels 4 l8.. and 32 + 4 l8..
  const int l8 = lane & 7, grp = tid >> 3;
  const int ca = 4 * l8, cb = 32 + 4 * l8;
  float uu[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uu[i] = tof(u[h * HD + ca + i]);
    uu[4 + i] = tof(u[h * HD + cb + i]);
  }

  // product tiles: warps 0-3 form y, warps 4-7 update the state
  const bool ywarp = tid < 128;
  const int pt = tid & 127, cg = pt & 7, rg = pt >> 3;
  const int j0 = 4 * cg, j1 = 32 + 4 * cg;
  float st[4][8];
  if (!ywarp) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int c = 4 * rg + ii;
      const float4 a0 = ld4(s0 + (long long)bh * HD * HD + c * HD + j0);
      const float4 a1 = ld4(s0 + (long long)bh * HD * HD + c * HD + j1);
      st[ii][0] = a0.x; st[ii][1] = a0.y; st[ii][2] = a0.z; st[ii][3] = a0.w;
      st[ii][4] = a1.x; st[ii][5] = a1.y; st[ii][6] = a1.z; st[ii][7] = a1.w;
      st4(sm + Lay::SBUF + c * HD + j0, a0.x, a0.y, a0.z, a0.w);
      st4(sm + Lay::SBUF + c * HD + j1, a1.x, a1.y, a1.z, a1.w);
    }
  }

  float* AT = sm + Lay::AT;
  float* KD = sm + Lay::KDEC;
  float* AC = sm + Lay::AC;
  const int n = S / C;
  load_chunk(0, 0);
  for (int ci = 0; ci < n; ++ci) {
    int stage = 0;
    if constexpr (Lay::NSTAGE == 2) {
      stage = ci & 1;
    } else if (ci > 0) {
      __syncthreads();         // the previous chunk is done with the stage
      load_chunk(ci, 0);
    }
    if constexpr (std::is_same<T, float>::value) cp_async_wait_all();
    __syncthreads();           // chunk ci is in; chunk ci-1 is done
    if constexpr (Lay::NSTAGE == 2) {
      if (ci + 1 < n) load_chunk(ci + 1, stage ^ 1);
    }
    const float* R = sm + Lay::RING + stage * 4 * Lay::TILE;
    const float* K = R + Lay::TILE;
    const float* V = K + Lay::TILE;
    float* W = sm + Lay::RING + (stage * 4 + 3) * Lay::TILE;  // w, then L
    const float* Scur = sm + Lay::SBUF + (ci & 1) * HD * HD;
    float* Snext = sm + Lay::SBUF + ((ci & 1) ^ 1) * HD * HD;

    // ---- decays: lane (q, c) scans tokens [q SEG, (q + 1) SEG) of column c
    {
      constexpr int SEG = CP / 4;
      const int q = lane >> 3, c = warp * 8 + (lane & 7);
      float part[SEG], run = 0.f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = q * SEG + i;
        run += t < C ? log2f(fmaxf(W[t * LDR + c], 1e-30f)) : 0.f;
        part[i] = run;
      }
      float incl = run, o = __shfl_up_sync(FULL, incl, 8);
      if (q >= 1) incl += o;
      o = __shfl_up_sync(FULL, incl, 16);
      if (q >= 2) incl += o;
      float excl = __shfl_up_sync(FULL, incl, 8);
      if (q == 0) excl = 0.f;
      const float tot = __shfl_sync(FULL, incl, 24 + (lane & 7));
      float prev = excl;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = q * SEG + i, e = t * LDR + c;
        const float L = part[i] + excl;
        W[e] = L;
        AT[c * Lay::LDT + t] = R[e] * ex2(prev);
        KD[e] = K[e] * ex2(tot - L);
        prev = L;
      }
      if (q == 0) AC[c] = ex2(tot);
    }
    __syncthreads();

    // ---- scores: batch (j, t) holds the pairs (t, s), s in [8j, 8j + 8);
    //      group grp takes batches grp, grp + 32, ... in (j, t) order, so
    //      the 4 groups of a warp read the same k and L rows
    {
      const unsigned gmask = 0xffu << (lane & 24);
      // batches 0-7 go to slot 0 of warps 0-7, 8-15 to slot 1, ...
      for (int bi = (grp & 3) * 8 + (grp >> 2);; bi += 32) {
        int j = 0, t = bi;
        while (8 * j < C && t >= C - 8 * j) {
          t -= C - 8 * j;
          ++j;
        }
        if (8 * j >= C) break;
        t += 8 * j;
        const float4 ra = ld4(R + t * LDR + ca), rb = ld4(R + t * LDR + cb);
        float4 pa = make_float4(0.f, 0.f, 0.f, 0.f), pb = pa;
        if (t > 0) {
          pa = ld4(W + (t - 1) * LDR + ca);
          pb = ld4(W + (t - 1) * LDR + cb);
        }
        // pair e: s = 8j + e; its decays overflow for s >= t, where the
        // sum is not used
        float part[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int s = 8 * j + e;
          const float4 ka = ld4(K + s * LDR + ca), kb = ld4(K + s * LDR + cb);
          const float4 la = ld4(W + s * LDR + ca), lb = ld4(W + s * LDR + cb);
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc += comp(ra, i) * comp(ka, i) * ex2(comp(pa, i) - comp(la, i));
            acc += comp(rb, i) * comp(kb, i) * ex2(comp(pb, i) - comp(lb, i));
          }
          part[e] = acc;
        }
        // the bonus r_t . (u * k_t), summed over the group's 8 lanes
        float dg = 0.f;
        if ((t >> 3) == j) {
          const float4 ka = ld4(K + t * LDR + ca), kb = ld4(K + t * LDR + cb);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dg += comp(ra, i) * comp(ka, i) * uu[i];
            dg += comp(rb, i) * comp(kb, i) * uu[4 + i];
          }
          dg += __shfl_xor_sync(gmask, dg, 4);
          dg += __shfl_xor_sync(gmask, dg, 2);
          dg += __shfl_xor_sync(gmask, dg, 1);
        }
        // reduce-scatter over the 8 lanes: lane l8 ends with pair e = l8
        const bool b2 = l8 & 4, b1 = l8 & 2, b0 = l8 & 1;
        float v4[4], v2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v4[i] = (b2 ? part[i + 4] : part[i])
                  + __shfl_xor_sync(gmask, b2 ? part[i] : part[i + 4], 4);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          v2[i] = (b1 ? v4[i + 2] : v4[i])
                  + __shfl_xor_sync(gmask, b1 ? v4[i] : v4[i + 2], 2);
        const float x = (b0 ? v2[1] : v2[0])
                        + __shfl_xor_sync(gmask, b0 ? v2[0] : v2[1], 1);
        const int s = 8 * j + l8;
        if (s <= t) AT[(HD + s) * Lay::LDT + t] = s < t ? x : dg;
      }
    }
    __syncthreads();

    if (ywarp) {
      // ---- y = [r * 2^Lprev | P] @ [S ; V]: rows 4 rgy.. by columns j0..
      //      and j1.. a thread, the depth 64 + CP cut in quarters over lanes
      //      8 apart
      constexpr int DQ = (HD + CP) / 4;
      const int quarter = lane >> 3, b4 = lane & 16, b3 = lane & 8;
      for (int rgy = warp; rgy < CP / 4; rgy += 4) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int i = 0; i < DQ; ++i) {
          const int d = quarter * DQ + i;
          const float4 a = ld4(AT + d * Lay::LDT + 4 * rgy);
          const float* bp = d < HD ? Scur + d * HD : V + (d - HD) * LDR;
          const float4 b0 = ld4(bp + j0), b1 = ld4(bp + j1);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float x = comp(a, ii);
            acc[ii][0] += x * b0.x; acc[ii][1] += x * b0.y;
            acc[ii][2] += x * b0.z; acc[ii][3] += x * b0.w;
            acc[ii][4] += x * b1.x; acc[ii][5] += x * b1.y;
            acc[ii][6] += x * b1.z; acc[ii][7] += x * b1.w;
          }
        }
        // reduce-scatter over the quarters: the lane keeps row 2 b4 + b3
        float hf[2][8], o[8];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            hf[ii][j] = (b4 ? acc[ii + 2][j] : acc[ii][j])
                        + __shfl_xor_sync(FULL, b4 ? acc[ii][j] : acc[ii + 2][j],
                                          16);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = (b3 ? hf[1][j] : hf[0][j])
                 + __shfl_xor_sync(FULL, b3 ? hf[0][j] : hf[1][j], 8);
        const int t = 4 * rgy + (b4 ? 2 : 0) + (b3 ? 1 : 0);
        if (t < C) {
          float* yp = y + base + ((long long)ci * C + t) * tok;
          st4(yp + j0, o[0], o[1], o[2], o[3]);
          st4(yp + j1, o[4], o[5], o[6], o[7]);
        }
      }
    } else {
      // ---- state rows 4 rg.., columns j0.. and j1..: diag(AC) S + KD^T V
      if (states != nullptr) {   // the chunk's start state, for training
        float* sp0 = states + ((long long)bh * n + ci) * HD * HD;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float* sp = sp0 + (4 * rg + ii) * HD;
          st4(sp + j0, st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
          st4(sp + j1, st[ii][4], st[ii][5], st[ii][6], st[ii][7]);
        }
      }
      const float4 ac = ld4(AC + 4 * rg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[ii][j] *= comp(ac, ii);
#pragma unroll 4
      for (int s = 0; s < CP; ++s) {
        const float4 a = ld4(KD + s * LDR + 4 * rg);
        const float4 b0 = ld4(V + s * LDR + j0);
        const float4 b1 = ld4(V + s * LDR + j1);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float x = comp(a, ii);
          st[ii][0] += x * b0.x; st[ii][1] += x * b0.y;
          st[ii][2] += x * b0.z; st[ii][3] += x * b0.w;
          st[ii][4] += x * b1.x; st[ii][5] += x * b1.y;
          st[ii][6] += x * b1.z; st[ii][7] += x * b1.w;
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float* sp = Snext + (4 * rg + ii) * HD;
        st4(sp + j0, st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
        st4(sp + j1, st[ii][4], st[ii][5], st[ii][6], st[ii][7]);
      }
    }
  }
  if (!ywarp) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float* sp = sout + (long long)bh * HD * HD + (4 * rg + ii) * HD;
      st4(sp + j0, st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
      st4(sp + j1, st[ii][4], st[ii][5], st[ii][6], st[ii][7]);
    }
  }
}

template <typename T, int CP>
int launch_cp(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sout,
              void* states, int B, int S, int H, int C,
              cudaStream_t stream) {
  const size_t bytes = Layout<CP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked_kernel<T, CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked_kernel<T, CP><<<B * H, THREADS, bytes, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const T*)u,
      (const float*)s0, (float*)y, (float*)sout, (float*)states, S, H, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, void* states,
           int B, int S, int H, int C, cudaStream_t stream) {
  if (C <= 16)
    return launch_cp<T, 16>(r, k, v, w, u, s0, y, sout, states, B, S, H, C,
                            stream);
  if (C <= 32)
    return launch_cp<T, 32>(r, k, v, w, u, s0, y, sout, states, B, S, H, C,
                            stream);
  if (C <= 48)
    return launch_cp<T, 48>(r, k, v, w, u, s0, y, sout, states, B, S, H, C,
                            stream);
  return launch_cp<T, 64>(r, k, v, w, u, s0, y, sout, states, B, S, H, C,
                          stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Dynamic shared memory of one block at chunk C, in bytes.
extern "C" int rwkv6_chunked_smem_bytes(int C) {
  if (C <= 16) return (int)Layout<16>::BYTES;
  if (C <= 32) return (int)Layout<32>::BYTES;
  if (C <= 48) return (int)Layout<48>::BYTES;
  return (int)Layout<64>::BYTES;
}

extern "C" int rwkv6_chunked_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* s0, void* y,
                                    void* sout, void* states, int B, int S,
                                    int H, int C, int is_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (C < 1 || C > HD || S % C != 0) return (int)cudaErrorInvalidValue;
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
        aligned16(s0) && aligned16(y) && aligned16(sout) &&
        aligned16(states)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, states,
                                         B, S, H, C, s)
                 : launch<float>(r, k, v, w, u, s0, y, sout, states, B, S, H,
                                 C, s);
}
