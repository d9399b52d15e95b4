// Per-flow aggregation for the packet engine's tick:
//   out[k, f] = sum(rows[k, n] for n with pflow[n] == f)
// rows: int32 [K, N], pflow: int32 [N], out: int32 [K, F], zeroed by the
// caller.  A pflow outside [0, F) adds nothing.
//
// Replaces: src/repro/kernels/flow_agg.py, _flow_agg_kernel (a one-hot
// GEMM streamed over packet blocks on the TPU's matrix unit).
//
// Bound on the H100: at the engine's shapes (N = 33,856 slots, F = 1,056
// flows, K = 6 or 2) one call moves under 1 MB, about 0.3 us at 3.35 TB/s;
// what it pays is the launch.  Design: a segment sum needs no one-hot.
// One thread per packet slot reads its flow id once and adds each
// non-zero row value with an int32 atomicAdd.  Integer adds are exact in
// any order, so the result equals the GEMM's bit for bit; most values
// are zero, so few atomics are issued.
#include <cuda_runtime.h>

__global__ void flow_agg_kernel(const int* __restrict__ rows,
                                const int* __restrict__ pflow,
                                int* __restrict__ out, int K, int N, int F) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int f = pflow[n];
  if (f < 0 || f >= F) return;
  for (int k = 0; k < K; ++k) {
    int v = rows[(long long)k * N + n];
    if (v != 0) atomicAdd(&out[(long long)k * F + f], v);
  }
}

extern "C" int flow_agg_launch(const void* rows, const void* pflow,
                               void* out, int K, int N, int F,
                               void* stream) {
  if (K > 0 && N > 0) {
    const int threads = 256;
    const int blocks = (N + threads - 1) / threads;
    flow_agg_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, (const int*)pflow, (int*)out, K, N, F);
  }
  return (int)cudaGetLastError();
}
