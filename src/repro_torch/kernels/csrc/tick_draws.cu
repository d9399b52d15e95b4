// The packet engine's random draws of one tick, in one launch: the tick's
// keys (k_path, k_mark) = split(fold_in(rng, t), 2) and the two uniform
// draws on them, u_path [F] (the policies' path draw, shape (F, 1)) and
// unif [M] (the RED/ECN draw), bit for bit as jax.random draws them with
// partitionable threefry2x32: element i of a draw on key k is
//   b = threefry(k, (0, i)); u = bits_as_f32((b.x ^ b.y) >> 9 | 1.0f) - 1.
//
// Reproduces: src/repro/net/sim/engine.py:130 (_tick_keys) and the two
// jax.random.uniform draws on its keys (the reference runs them as XLA
// element-wise code, not as a Pallas kernel).  Without this kernel the
// port derives the keys and draws with torch element-wise ops
// (_parity.py): about 490 launches a tick, each a few integer ops on
// [F + M] or [2] words.
//
// Bound on the H100: 8 B of key, 4 B of tick in, 4 (F + M) B out (24 KB at
// DF-1056, F = 1,056, M = 5,024): 0.007 us at 3.35 TB/s; 3 x 20 rounds of
// a few 32-bit integer ops per element.  The launch dominates.
// Design: one thread per element of either draw; each thread derives the
// tick's keys itself (two threefry blocks on four words: cheaper than a
// second launch or a barrier) and then its own 32 bits (tick_draws.cuh,
// shared with the kernels that draw in place).  The rng and the tick are
// read from device memory, so a captured graph draws each replay's tick.
//
// On the engine's path since the in-place draws, this launch runs only
// under a capacity plan, with n_flows 0: there the engine's torch RED
// math reads unif.  At full rate the fused rank + RED/ECN launch draws
// unif and the samplers (spritz_select.cu) draw u_path themselves.
#include <cuda_runtime.h>

#include "tick_draws.cuh"

__global__ void tick_draws_kernel(const long long* __restrict__ rng,
                                  const int* __restrict__ t, int F, int M,
                                  float* __restrict__ u_path,
                                  float* __restrict__ unif) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F + M) return;
  const bool path = i < F;
  const float u = tick_uniform(
      tick_key(rng, t, path ? TICK_K_PATH : TICK_K_MARK),
      (uint32_t)(path ? i : i - F));
  if (path)
    u_path[i] = u;
  else
    unif[i - F] = u;
}

extern "C" int tick_draws_launch(const void* rng, const void* t, int F,
                                 int M, void* u_path, void* unif,
                                 void* stream) {
  if (F + M > 0) {
    const int threads = 256;
    const int blocks = (F + M + threads - 1) / threads;
    tick_draws_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)rng, (const int*)t, F, M, (float*)u_path,
        (float*)unif);
  }
  return (int)cudaGetLastError();
}
