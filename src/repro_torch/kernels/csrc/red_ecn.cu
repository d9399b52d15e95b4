// RED/ECN enqueue stage of the packet engine's tick, per candidate i
// (red_ecn.cuh): occupancy, trim, RED/ECN mark and service slot from the
// candidate's port tail and its rank.
//
// Replaces: src/repro/kernels/red_ecn.py, _red_ecn_kernel (a VMEM-tiled
// elementwise pass with the port tails replicated per block).
//
// Bound on the H100: M = 5,024 candidates and 3,960 port tails at
// DF-1056 move about 130 KB, 0.04 us at 3.35 TB/s; the launch dominates.
// Design: one thread per candidate with one gather from q_tail; the tick
// t is read from device memory, so a CUDA graph that captured the launch
// reads each replay's tick (the reference's t_ref operand).  The
// engine does not launch this kernel: it runs the same stage as the
// epilogue of tick_rank's launch (tick_rank.cu), where the ranks are
// made.  This standalone form is the counterpart of the reference's
// red_ecn, which takes the ranks as an input.
#include <cuda_runtime.h>

#include "red_ecn.cuh"

__global__ void red_ecn_kernel(const int* __restrict__ eport,
                               const int* __restrict__ rank,
                               const bool* __restrict__ enq,
                               const float* __restrict__ unif,
                               const int* __restrict__ q_tail,
                               const int* __restrict__ t_ref,
                               int qsize, float kmin, float recip,
                               int n_ports, int M, int* __restrict__ occ_out,
                               bool* __restrict__ trim_out,
                               bool* __restrict__ mark_out,
                               int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int t = __ldg(t_ref);
  const RedEcnOut o = red_ecn_one(q_tail[red_ecn_port(eport[i], n_ports)],
                                  rank[i], enq[i], unif[i], t, qsize, kmin,
                                  recip);
  occ_out[i] = o.occ;
  trim_out[i] = o.trim;
  mark_out[i] = o.mark;
  slot_out[i] = o.slot;
}

extern "C" int red_ecn_launch(const void* eport, const void* rank,
                              const void* enq, const void* unif,
                              const void* q_tail, const void* t, int qsize,
                              float kmin, float recip, int n_ports, int M,
                              void* occ, void* trim, void* mark, void* slot,
                              void* stream) {
  if (M > 0) {
    const int threads = 256;
    const int blocks = (M + threads - 1) / threads;
    red_ecn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)eport, (const int*)rank, (const bool*)enq,
        (const float*)unif, (const int*)q_tail, (const int*)t, qsize, kmin,
        recip, n_ports, M, (int*)occ, (bool*)trim, (bool*)mark, (int*)slot);
  }
  return (int)cudaGetLastError();
}
