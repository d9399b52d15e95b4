// Per-tick FIFO enqueue rank: rank[i] is the number of entries j < i
// whose port equals port[i].  Ports outside [0, n_ports) share one
// overflow bucket (the compaction sentinel and pads).
// port: int32 [M] -> rank: int32 [M].
//
// Replaces: src/repro/kernels/tick_rank.py, _tick_rank_kernel (a
// sequential grid carrying per-port counts in VMEM across blocks).
//
// Bound on the H100: M = 5,024 compacted enqueues at DF-1056, 40 KB in
// and out, about 0.01 us at 3.35 TB/s; the launch dominates.  Design: a
// block of threads cannot carry counts from earlier blocks (blocks run
// in no order), so each thread counts the equal ports at lower indices
// itself: the block stages 256 ports at a time in shared memory and every
// thread compares against the staged tile, M^2 / 2 compares in all.  No
// atomics, so index order is never lost.  A histogram plus scan with
// __match_any_sync would do O(M) work; that is later work.
#include <cuda_runtime.h>

#define TR_THREADS 256

__device__ __forceinline__ int bucket(int p, int n_ports) {
  return (p < 0 || p >= n_ports) ? n_ports : p;
}

__global__ void tick_rank_kernel(const int* __restrict__ port,
                                 int* __restrict__ rank, int M,
                                 int n_ports) {
  __shared__ int tile[TR_THREADS];
  const int i = blockIdx.x * TR_THREADS + threadIdx.x;
  const int mine = i < M ? bucket(port[i], n_ports) : -1;
  const int block_end = min((int)(blockIdx.x + 1) * TR_THREADS, M);
  int count = 0;
  for (int base = 0; base < block_end; base += TR_THREADS) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < M ? bucket(port[j], n_ports) : -2;
    __syncthreads();
    const int lim = min(TR_THREADS, i - base);
    for (int u = 0; u < lim; ++u) count += (tile[u] == mine);
    __syncthreads();
  }
  if (i < M) rank[i] = count;
}

extern "C" int tick_rank_launch(const void* port, void* rank, int M,
                                int n_ports, void* stream) {
  if (M > 0) {
    const int blocks = (M + TR_THREADS - 1) / TR_THREADS;
    tick_rank_kernel<<<blocks, TR_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)port, (int*)rank, M, n_ports);
  }
  return (int)cudaGetLastError();
}
