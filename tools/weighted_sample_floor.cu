// The floor of a launch at weighted_sample's place in the engine's step:
// two kernels on the sampler's grid (8 warps a block, a warp a row), one
// empty, one that reads rng and t and writes F ints.  Built and timed by
// tools/weighted_sample_bench.py; nothing of the port launches them.
#include <cuda_runtime.h>

#define FLOOR_WARPS 8

__global__ void __launch_bounds__(32 * FLOOR_WARPS) ws_floor_empty_kernel() {}

__global__ void __launch_bounds__(32 * FLOOR_WARPS)
    ws_floor_io_kernel(const long long* rng, const int* t, int F, int* ev) {
  const int f = blockIdx.x * FLOOR_WARPS + (threadIdx.x >> 5);
  if (f < F && (threadIdx.x & 31) == 0)
    ev[f] = (int)((unsigned)__ldg(rng) ^ (unsigned)__ldg(rng + 1) ^
                  (unsigned)__ldg(t)) & 1;
}

// nothing (io 0), or a read of rng and t and F ints written (io 1)
extern "C" int weighted_sample_floor_launch(const void* rng, const void* t,
                                            int F, int io, void* ev,
                                            void* stream) {
  const dim3 grid((F + FLOOR_WARPS - 1) / FLOOR_WARPS);
  if (io)
    ws_floor_io_kernel<<<grid, 32 * FLOOR_WARPS, 0, (cudaStream_t)stream>>>(
        (const long long*)rng, (const int*)t, F, (int*)ev);
  else
    ws_floor_empty_kernel<<<grid, 32 * FLOOR_WARPS, 0,
                            (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
