// RED/ECN enqueue stage of the packet engine's tick, per candidate i:
//   occ   = max(q_tail[port] - t, 0) + rank
//   trim  = enq & (occ >= qsize)
//   mark  = accept & (unif < clip((occ - kmin) * recip, 0, 1))
//   slot  = accept ? max(q_tail[port], t) + rank + 1 : 0
// with port = min(eport, n_ports - 1) and accept = enq & !trim.
//
// Replaces: src/repro/kernels/red_ecn.py, _red_ecn_kernel (a VMEM-tiled
// elementwise pass with the port tails replicated per block).
//
// Bound on the H100: M = 5,024 candidates and 3,960 port tails at
// DF-1056 move about 130 KB, 0.04 us at 3.35 TB/s; the launch dominates.
// Design: one thread per candidate with one gather from q_tail.  The
// float steps are written with __fsub_rn/__fmul_rn (and the file is
// built with -fmad=false) so nothing is contracted: XLA computes the
// RED probability as (occ - kmin) times the f32 reciprocal of
// (kmax - kmin), which the caller passes in as `recip`.
#include <cuda_runtime.h>

__global__ void red_ecn_kernel(const int* __restrict__ eport,
                               const int* __restrict__ rank,
                               const bool* __restrict__ enq,
                               const float* __restrict__ unif,
                               const int* __restrict__ q_tail, int t,
                               int qsize, float kmin, float recip,
                               int n_ports, int M, int* __restrict__ occ_out,
                               bool* __restrict__ trim_out,
                               bool* __restrict__ mark_out,
                               int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int pc = min(eport[i], n_ports - 1);
  if (pc < 0) pc += n_ports;  // a negative index counts from the end
  const int tail = q_tail[pc];
  const int r = rank[i];
  const int occ = max(tail - t, 0) + r;
  const bool e = enq[i];
  const bool trim = e && (occ >= qsize);
  const bool accept = e && !trim;
  float pr = __fmul_rn(__fsub_rn(__int2float_rn(occ), kmin), recip);
  pr = fminf(fmaxf(pr, 0.0f), 1.0f);
  occ_out[i] = occ;
  trim_out[i] = trim;
  mark_out[i] = accept && (unif[i] < pr);
  slot_out[i] = accept ? max(tail, t) + r + 1 : 0;
}

extern "C" int red_ecn_launch(const void* eport, const void* rank,
                              const void* enq, const void* unif,
                              const void* q_tail, int t, int qsize,
                              float kmin, float recip, int n_ports, int M,
                              void* occ, void* trim, void* mark, void* slot,
                              void* stream) {
  if (M > 0) {
    const int threads = 256;
    const int blocks = (M + threads - 1) / threads;
    red_ecn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)eport, (const int*)rank, (const bool*)enq,
        (const float*)unif, (const int*)q_tail, t, qsize, kmin, recip,
        n_ports, M, (int*)occ, (bool*)trim, (bool*)mark, (int*)slot);
  }
  return (int)cudaGetLastError();
}
