// The RED/ECN enqueue stage of one candidate, shared by red_ecn.cu's
// standalone kernel and tick_rank.cu's fused epilogue:
//   occ   = max(tail - t, 0) + rank
//   trim  = enq & (occ >= qsize)
//   mark  = accept & (unif < clip((occ - kmin) * recip, 0, 1))
//   slot  = accept ? max(tail, t) + rank + 1 : 0
// with tail = q_tail[red_ecn_port(eport, n_ports)] and accept = enq & !trim.
//
// The float steps are written with __fsub_rn/__fmul_rn (and every file
// that includes this one is built with -fmad=false) so nothing is
// contracted: XLA computes the RED probability as (occ - kmin) times the
// f32 reciprocal of (kmax - kmin), which the caller passes in as `recip`.
#pragma once

// red_ecn's port mapping: min(eport, n_ports - 1), a negative index
// counted from the end.  (Not tick_rank's overflow bucket.)
__device__ __forceinline__ int red_ecn_port(int eport, int n_ports) {
  const int pc = min(eport, n_ports - 1);
  return pc < 0 ? pc + n_ports : pc;
}

struct RedEcnOut {
  int occ, slot;
  bool trim, mark;
};

// Everything but the draw: occ, trim, slot, and in `mark` the accept
// flag that the mark ands in; `pr` gets the clipped RED probability.
__device__ __forceinline__ RedEcnOut red_ecn_stage(int tail, int rank,
                                                   bool enq, int t,
                                                   int qsize, float kmin,
                                                   float recip, float& pr) {
  RedEcnOut o;
  o.occ = max(tail - t, 0) + rank;
  o.trim = enq && (o.occ >= qsize);
  o.mark = enq && !o.trim;                                   // accept
  pr = __fmul_rn(__fsub_rn(__int2float_rn(o.occ), kmin), recip);
  pr = fminf(fmaxf(pr, 0.0f), 1.0f);
  o.slot = o.mark ? max(tail, t) + rank + 1 : 0;
  return o;
}

__device__ __forceinline__ RedEcnOut red_ecn_one(int tail, int rank, bool enq,
                                                 float unif, int t, int qsize,
                                                 float kmin, float recip) {
  float pr;
  RedEcnOut o = red_ecn_stage(tail, rank, enq, t, qsize, kmin, recip, pr);
  o.mark = o.mark && (unif < pr);
  return o;
}

// The same stage with the uniform drawn in place: draw() gives it, a
// float in [0, 1), and is called only where it decides the mark (0 < pr
// < 1): no uniform is below pr = 0, every one is below pr = 1.  Equal to
// red_ecn_one on that uniform.
template <class Draw>
__device__ __forceinline__ RedEcnOut red_ecn_one_drawn(int tail, int rank,
                                                       bool enq,
                                                       const Draw& draw,
                                                       int t, int qsize,
                                                       float kmin,
                                                       float recip) {
  float pr;
  RedEcnOut o = red_ecn_stage(tail, rank, enq, t, qsize, kmin, recip, pr);
  o.mark = o.mark && (pr == 1.0f || (pr > 0.0f && draw() < pr));
  return o;
}
