// The packet engine's per-tick random draws, shared by the kernels that
// make them: tick_draws.cu's standalone launch, the fused rank + RED/ECN
// launch (tick_rank.cu, the RED draw) and spritz_select.cu (the path
// draw).  The tick's keys are (k_path, k_mark) = split(fold_in(rng, t),
// 2), and element i of a uniform draw on key k is, bit for bit as
// jax.random draws it with partitionable threefry2x32,
//   b = threefry(k, (0, i)); u = bits_as_f32((b.x ^ b.y) >> 9 | 1.0f) - 1,
// a float in [0, 1 - 2^-23].
//
// rng ([2] int64, the carry's uint32 key words) and t (int32) are read
// from device memory, so a captured CUDA graph draws each replay's tick.
#pragma once

#include <stdint.h>

#define TICK_K_PATH 0u   // split's first key: the policies' path draw
#define TICK_K_MARK 1u   // split's second key: the RED/ECN draw

__device__ __forceinline__ uint32_t tick_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 with 20 rounds on counter (x0, x1), as _parity.threefry2x32.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = tick_rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// Key `which` (TICK_K_PATH or TICK_K_MARK) of tick *t: two threefry
// blocks, fold_in then split.
__device__ __forceinline__ uint2 tick_key(const long long* __restrict__ rng,
                                          const int* __restrict__ t,
                                          uint32_t which) {
  const uint2 key = threefry((uint32_t)__ldg(rng), (uint32_t)__ldg(rng + 1),
                             0u, (uint32_t)__ldg(t));       // fold_in
  return threefry(key.x, key.y, 0u, which);                 // split
}

// Element i of jax.random.uniform(key, shape) (exact: the subtraction
// of 1 from a float in [1, 2) rounds nothing).
__device__ __forceinline__ float tick_uniform(uint2 key, uint32_t i) {
  const uint2 b = threefry(key.x, key.y, 0u, i);
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}
