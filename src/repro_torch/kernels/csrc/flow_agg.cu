// Per-flow aggregation for the packet engine's tick:
//   out[k, f] = sum(rows[k, n] for n with pflow[n] == f)
// rows: [K, N] int32 or 1-byte (bool / uint8) values, pflow: int32 [N],
// out: int32 [K, F], zeroed by the caller.  A pflow outside [0, F) adds
// nothing.
//
// Replaces: src/repro/kernels/flow_agg.py, _flow_agg_kernel (a one-hot
// GEMM streamed over packet blocks on the TPU's matrix unit).
//
// Bound on the H100: at the engine's shapes (N = 33,856 slots, F = 1,056
// flows, K = 6 or 2) one call moves under 1 MB, about 0.3 us at 3.35 TB/s;
// what it pays is the launch.  Design: a segment sum needs no one-hot.
// One thread per packet slot reads its flow id once and adds each
// non-zero row value with an int32 atomicAdd.  Integer adds are exact in
// any order, so the result equals the GEMM bit for bit; most values
// are zero, so few atomics are issued.  Rows of 1-byte values (the
// engine's stacked bool indicators) are read as they are, with no cast
// launch before this one.
//
// A single-launch design without the caller's zero fill (one cluster of
// 16 blocks, shared-memory histograms summed through distributed shared
// memory) measured slower than this kernel plus its fill; PERF.md
// keeps its times and design.
#include <cuda_runtime.h>

template <typename T>
__global__ void flow_agg_kernel(const T* __restrict__ rows,
                                const int* __restrict__ pflow,
                                int* __restrict__ out, int K, int N, int F) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int f = pflow[n];
  if (f < 0 || f >= F) return;
  for (int k = 0; k < K; ++k) {
    int v = (int)rows[(long long)k * N + n];
    if (v != 0) atomicAdd(&out[(long long)k * F + f], v);
  }
}

// elem_bytes: 4 (int32 rows) or 1 (bool / uint8 rows).
extern "C" int flow_agg_launch(const void* rows, const void* pflow,
                               void* out, int K, int N, int F,
                               int elem_bytes, void* stream) {
  if (elem_bytes != 4 && elem_bytes != 1) return (int)cudaErrorInvalidValue;
  if (K > 0 && N > 0) {
    const int threads = 256;
    const int blocks = (N + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 1)
      flow_agg_kernel<unsigned char><<<blocks, threads, 0, s>>>(
          (const unsigned char*)rows, (const int*)pflow, (int*)out, K, N, F);
    else
      flow_agg_kernel<int><<<blocks, threads, 0, s>>>(
          (const int*)rows, (const int*)pflow, (int*)out, K, N, F);
  }
  return (int)cudaGetLastError();
}
