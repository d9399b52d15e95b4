// Spritz Algorithm 1's path choice, one flow per thread:
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
// about 300 KB, 0.09 us at 3.35 TB/s; the launch dominates.  Design:
// the sampled index must equal XLA's, so the prefix sum follows XLA's
// f32 order exactly: sequential inside blocks of 16, then each block
// adds the running (sequential) sum of the earlier block totals.  One
// thread walks its row twice: once for the total, once to count.  Adds
// and multiplies are __fadd_rn/__fmul_rn and the file is built with
// -fmad=false, so no step is contracted.
#include <cuda_runtime.h>

#define SEL_MAX_BLOCKS 16

__global__ void spritz_select_kernel(const float* __restrict__ w,
                                     const float* __restrict__ u,
                                     const int* __restrict__ front,
                                     const int* __restrict__ count, int F,
                                     int P, int explore_threshold,
                                     int* __restrict__ ev_out,
                                     int* __restrict__ newcnt_out,
                                     bool* __restrict__ used_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float* row = w + (long long)f * P;
  const int nb = (P + 15) / 16;
  float offset[SEL_MAX_BLOCKS];  // sum of earlier block totals, per block
  float run = 0.0f;
  float total = 0.0f;
  for (int b = 0; b < nb; ++b) {
    const int lo = 16 * b, hi = min(lo + 16, P);
    float acc = row[lo];
    for (int j = lo + 1; j < hi; ++j) acc = __fadd_rn(acc, row[j]);
    offset[b] = run;
    total = b == 0 ? acc : __fadd_rn(acc, run);
    run = b == 0 ? acc : __fadd_rn(run, acc);
  }
  const float uu = __fmul_rn(u[f], fmaxf(total, 1e-30f));
  int below = 0;
  for (int b = 0; b < nb; ++b) {
    const int lo = 16 * b, hi = min(lo + 16, P);
    float acc = row[lo];
    below += ((b == 0 ? acc : __fadd_rn(acc, offset[b])) < uu);
    for (int j = lo + 1; j < hi; ++j) {
      acc = __fadd_rn(acc, row[j]);
      below += ((b == 0 ? acc : __fadd_rn(acc, offset[b])) < uu);
    }
  }
  const int sampled = min(below, P - 1);
  const int c = count[f];
  const bool explore = c >= explore_threshold;
  const bool used = !explore && front[f] >= 0;
  ev_out[f] = used ? front[f] : sampled;
  newcnt_out[f] = explore ? 0 : c + 1;
  used_out[f] = used;
}

extern "C" int spritz_select_launch(const void* w, const void* u,
                                    const void* front, const void* count,
                                    int F, int P, int explore_threshold,
                                    void* ev, void* newcnt, void* used,
                                    void* stream) {
  if (P < 1 || P > 16 * SEL_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  if (F > 0) {
    const int threads = 128;
    const int blocks = (F + threads - 1) / threads;
    spritz_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)u, (const int*)front,
        (const int*)count, F, P, explore_threshold, (int*)ev, (int*)newcnt,
        (bool*)used);
  }
  return (int)cudaGetLastError();
}
