// weighted_sample: each row's weighted path sample on the tick's path
// draw, one flow per warp:
//   u       = element f of uniform(k_path, (F, 1)), k_path of tick *t
//   csum    = prefix sum of the weight row w[f, :] (XLA's f32 order)
//   ev[f]   = min(count(csum < u * max(csum[P-1], 1e-30)), P - 1)
// w: f32 [F, P] (P <= 256); rng: the carry's [2] int64 key; t: int32.
//
// Replaces: no Pallas kernel.  It stands in for the reference's
// weighted_sample_rows (src/repro/net/policies/base.py:151) with its
// uniform on k_path, which XLA fuses under jit; the port's sampler for
// valiant, ugal_l, flicr_w, ops_u, ops_w and reps, one launch a tick.
//
// Bound on the H100: F = 1,056 rows of P = 64 weights at DF-1056 move
// about 270 KB, 0.08 us at 3.35 TB/s.  What is left is latency: the
// launch, the draw's chain of three threefry2x32 blocks (fold_in and
// split, the same for every row, then the row's element: ~60 rounds of
// dependent integer adds and rotate-xors), the row's load and its
// prefix sum.
//
// Design: one warp a row, 8 rows a block (132 blocks at F = 1,056, one
// wave).  Lane l holds entries l, l+32, ... of its row in NR registers,
// loaded while the warp draws u.  The prefix is formed as spritz_select.cu
// forms it: sequential inside 16-blocks (a half-warp each: lane j adds
// entries 1..j of its block left to right), then the sequential sum of
// the earlier block totals, no tree.  Adds and multiplies are
// __fadd_rn/__fmul_rn and the file is built with -fmad=false.  Padding
// past P is +0.0, which leaves every real prefix unchanged and is never
// counted.  Measured and dropped (PERF.md): a programmatic
// dependent launch drawing before the launch before it ends (the torch
// kernels before it do not release their dependents early, so it
// overlapped nothing and its wait cost more than it hid), two warps a
// row, one drawing while the other sums (slower alone), and a prefix
// table formed once a spec for Valiant's constant weights (0.09 us a
// call in ugal_l's loop, nothing end to end).
#include <cuda_runtime.h>

#include "tick_draws.cuh"

#define WS_WARPS 8      // rows (warps) a block
#define WS_MAX_REGS 8   // 32-entry registers a lane holds: P <= 256

constexpr unsigned WS_FULL = 0xffffffffu;

struct WsArgs {
  const float* w;
  const long long* rng;
  const int* t;
  int F, P;
  int* ev;
};

template <int NR>
__device__ __forceinline__ void ws_load(const float* row, int P, int lane,
                                        float (&x)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int e = 32 * i + lane;
    x[i] = e < P ? __ldg(row + e) : 0.0f;
  }
}

// XLA-order prefix of the row in x, in place (spritz_select.cu's stage)
template <int NR>
__device__ __forceinline__ void ws_prefix(float (&x)[NR], int lane) {
  const int j = lane & 15;
  const bool hi = lane >= 16;
  float c[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float acc = __shfl_sync(WS_FULL, x[i], 0, 16);
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      const float v = __shfl_sync(WS_FULL, x[i], k, 16);
      if (k <= j) acc = __fadd_rn(acc, v);
    }
    c[i] = acc;
  }
  float run = 0.0f;  // T_0 + ... + T_2i-1, sequential
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const float t0 = __shfl_sync(WS_FULL, c[i], 15);
    const float t1 = __shfl_sync(WS_FULL, c[i], 31);
    const float off1 = i == 0 ? t0 : __fadd_rn(run, t0);
    if (i == 0)
      x[i] = hi ? __fadd_rn(c[i], off1) : c[i];
    else
      x[i] = __fadd_rn(c[i], hi ? off1 : run);
    run = __fadd_rn(off1, t1);
  }
}

// count(csum < uf * max(total, 1e-30)), total = csum[P - 1]
template <int NR>
__device__ __forceinline__ int ws_count(const float (&s)[NR], float uf,
                                        int P, int lane) {
  const float total = __shfl_sync(WS_FULL, s[NR - 1], (P - 1) & 31);
  const float uu = __fmul_rn(uf, total < 1e-30f ? 1e-30f : total);
  int below = 0;
#pragma unroll
  for (int i = 0; i < NR; ++i)
    below += __popc(__ballot_sync(WS_FULL, 32 * i + lane < P && s[i] < uu));
  return below;
}

template <int NR>
__global__ void __launch_bounds__(32 * WS_WARPS)
    weighted_sample_kernel(const WsArgs a) {
  const int f = blockIdx.x * WS_WARPS + (threadIdx.x >> 5);
  if (f >= a.F) return;  // the whole warp leaves together
  const int P = a.P;
  const int lane = threadIdx.x & 31;
  float x[NR];
  ws_load<NR>(a.w + (long long)f * P, P, lane, x);
  const uint2 key = tick_key(a.rng, a.t, TICK_K_PATH);
  const float uf = tick_uniform(key, (uint32_t)f);
  ws_prefix<NR>(x, lane);
  const int below = ws_count<NR>(x, uf, P, lane);
  if (lane == 0) a.ev[f] = min(below, P - 1);
}

// ev[f] = row f's weighted sample on element f of uniform(k_path, (F, 1))
// at tick *t.
extern "C" int weighted_sample_launch(const void* w, const void* rng,
                                      const void* t, int F, int P, void* ev,
                                      void* stream) {
  if (P < 1 || P > 32 * WS_MAX_REGS) return (int)cudaErrorInvalidValue;
  const WsArgs a{(const float*)w, (const long long*)rng, (const int*)t, F, P,
                 (int*)ev};
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (F + WS_WARPS - 1) / WS_WARPS;
  if (F > 0) {
    switch ((P + 31) / 32) {
#define WS_CASE(n)                                                     \
  case n:                                                              \
    weighted_sample_kernel<n><<<blocks, 32 * WS_WARPS, 0, s>>>(a);     \
    break;
      WS_CASE(1) WS_CASE(2) WS_CASE(3) WS_CASE(4)
      WS_CASE(5) WS_CASE(6) WS_CASE(7) WS_CASE(8)
#undef WS_CASE
    }
  }
  return (int)cudaGetLastError();
}
