// Spritz Algorithm 1's path choice, one flow per warp:
//   csum    = prefix sum of the weight row w[f, :]
//   sampled = min(count(csum < u[f] * max(csum[P-1], 1e-30)), P - 1)
//   explore = count[f] >= explore_threshold
//   used    = !explore & front[f] >= 0
//   ev      = used ? front[f] : sampled;  new_count = explore ? 0 : count+1
// w: f32 [F, P] (P <= 256), u: f32 [F], front/count: int32 [F].
//
// Replaces: src/repro/kernels/spritz_select.py, _select_kernel (rows of
// weights tiled in VMEM, cumsum plus compare-reduce on the vector unit).
//
// Bound on the H100: F = 1,056 rows of P = 64 weights at DF-1056 move
// about 300 KB, 0.09 us at 3.35 TB/s; what is left is latency.  The
// sampled index must equal XLA's, so the prefix sum follows XLA's f32
// order exactly: sequential inside blocks of 16, then each block adds
// the sequential sum of the earlier block totals (P <= 256 gives at most
// 16 blocks, so that sum is itself one sequential block).
//
// Design: one warp a row, 8 rows a block (132 blocks at F = 1,056, one
// wave).  Lane l holds entries l, l+32, ... of its row in NR registers
// (coalesced loads); padding past P is +0.0, which leaves every real
// prefix unchanged and is never counted.  Register i holds the 16-blocks
// 2i (lanes 0-15) and 2i+1 (lanes 16-31), so a half-warp is one block:
// lane j of it starts from the block's entry 0 and adds entry k for
// k = 1..15 when k <= j, the left-to-right order with no tree.  Block
// totals come from lanes 15 and 31; every lane forms the sequential
// offsets itself in registers (no array indexed at run time, so no
// stack frame).  The count is a ballot per register.  Adds and
// multiplies are __fadd_rn/__fmul_rn and the file is built with
// -fmad=false, so no step is contracted.
//
// The path draw in place (kDraw): u[f] is element f of the tick's k_path
// draw (tick_draws.cuh: fold_in, split and the element, three threefry
// blocks), made by the warp while its row's loads are in flight (every
// row draws: waiting for the front to skip a used row's draw would put
// the chain behind a second load); rng and t are read from device
// memory, as a captured graph needs.  That replaces the engine's launch
// of tick_draws.cu a tick.

#include <cuda_runtime.h>

#include "tick_draws.cuh"

#define SEL_WARPS 8      // rows (warps) a block
#define SEL_MAX_REGS 8   // 32-entry registers a lane holds: P <= 256

constexpr unsigned FULL = 0xffffffffu;

// The inputs and outputs of one launch: u, or (kDraw) rng and t.
struct SelArgs {
  const float* w;
  const float* u;
  const long long* rng;
  const int* t;
  const int* front;
  const int* count;
  int F, P, explore_threshold;
  int* ev;
  int* newcnt;
  bool* used;
};

template <int NR, bool kDraw>
__global__ void __launch_bounds__(32 * SEL_WARPS)
    spritz_select_kernel(const SelArgs a) {
  const int f = blockIdx.x * SEL_WARPS + (threadIdx.x >> 5);
  if (f >= a.F) return;  // the whole warp leaves together
  const int P = a.P;
  const int lane = threadIdx.x & 31;
  const int j = lane & 15;     // position inside the 16-block
  const bool hi = lane >= 16;  // the register's second block
  const float* row = a.w + (long long)f * P;
  float x[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int e = 32 * i + lane;
    x[i] = e < P ? __ldg(row + e) : 0.0f;
  }
  const float uf = kDraw ? tick_uniform(tick_key(a.rng, a.t, TICK_K_PATH),
                                        (uint32_t)f)
                         : __ldg(a.u + f);

  // in-block prefix c = ((x_0 + x_1) + ...) + x_j, sequential
  float c[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float acc = __shfl_sync(FULL, x[i], 0, 16);
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      const float v = __shfl_sync(FULL, x[i], k, 16);
      if (k <= j) acc = __fadd_rn(acc, v);
    }
    c[i] = acc;
  }

  // csum = c + offset of its block, offset_b = ((T_0 + T_1) + ...) + T_b-1
  // (block 0 adds nothing)
  float s[NR];
  float run = 0.0f;  // T_0 + ... + T_2i-1, sequential
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const float t0 = __shfl_sync(FULL, c[i], 15);
    const float t1 = __shfl_sync(FULL, c[i], 31);
    const float off1 = i == 0 ? t0 : __fadd_rn(run, t0);
    if (i == 0)
      s[i] = hi ? __fadd_rn(c[i], off1) : c[i];
    else
      s[i] = __fadd_rn(c[i], hi ? off1 : run);
    run = __fadd_rn(off1, t1);
  }

  // total = csum[P - 1], which lies in the last register
  const float total = __shfl_sync(FULL, s[NR - 1], (P - 1) & 31);
  const float uu = __fmul_rn(uf, total < 1e-30f ? 1e-30f : total);
  int below = 0;
#pragma unroll
  for (int i = 0; i < NR; ++i)
    below += __popc(__ballot_sync(FULL, 32 * i + lane < P && s[i] < uu));

  if (lane == 0) {
    const int sampled = min(below, P - 1);
    const int c0 = a.count[f];
    const int fr = a.front[f];
    const bool explore = c0 >= a.explore_threshold;
    const bool used = !explore && fr >= 0;
    a.ev[f] = used ? fr : sampled;
    a.newcnt[f] = explore ? 0 : c0 + 1;
    a.used[f] = used;
  }
}

template <bool kDraw>
static int launch(const SelArgs& a, cudaStream_t s) {
  if (a.P < 1 || a.P > 32 * SEL_MAX_REGS) return (int)cudaErrorInvalidValue;
  if (a.F > 0) {
    const int blocks = (a.F + SEL_WARPS - 1) / SEL_WARPS;
    switch ((a.P + 31) / 32) {
#define SEL_CASE(n)                                                      \
  case n:                                                                \
    spritz_select_kernel<n, kDraw>                                       \
        <<<blocks, 32 * SEL_WARPS, 0, s>>>(a);                           \
    break;
      SEL_CASE(1) SEL_CASE(2) SEL_CASE(3) SEL_CASE(4)
      SEL_CASE(5) SEL_CASE(6) SEL_CASE(7) SEL_CASE(8)
#undef SEL_CASE
    }
  }
  return (int)cudaGetLastError();
}

// Algorithm 1's choice for F rows.  Exactly one of u ([F] f32) and rng
// (the carry's [2] int64 key, with t the tick in device memory: u drawn
// in place on k_path) is non-null.
extern "C" int spritz_select_launch(const void* w, const void* u,
                                    const void* rng, const void* t,
                                    const void* front, const void* count,
                                    int F, int P, int explore_threshold,
                                    void* ev, void* newcnt, void* used,
                                    void* stream) {
  if ((u == nullptr) == (rng == nullptr) || (rng && !t))
    return (int)cudaErrorInvalidValue;
  const SelArgs a{(const float*)w, (const float*)u, (const long long*)rng,
                  (const int*)t, (const int*)front, (const int*)count, F, P,
                  explore_threshold, (int*)ev, (int*)newcnt, (bool*)used};
  return rng ? launch<true>(a, (cudaStream_t)stream)
             : launch<false>(a, (cudaStream_t)stream);
}
