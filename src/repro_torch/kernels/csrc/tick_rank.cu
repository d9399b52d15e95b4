// Per-tick FIFO enqueue rank: rank[i] is the number of entries j < i
// whose port equals port[i].  Ports outside [0, n_ports) share one
// overflow bucket (the compaction sentinel and pads).
// port: int32 [M] -> rank: int32 [M].
//
// Replaces: src/repro/kernels/tick_rank.py, _tick_rank_kernel (a
// sequential grid carrying per-port counts in VMEM across blocks).
//
// Bound on the H100: M = 5,024 compacted enqueues at DF-1056, 40 KB in
// and out, about 0.01 us at 3.35 TB/s.  What is left is latency on one
// SM: the launch, passes over shared memory at one SM's rate, and warp
// votes, which one SM issues slowly.
//
// Two paths behind one entry point; ops.tick_rank_plan picks one.
//
// smem (segs >= 1): the Pallas sequential grid done by one block in
// index order.  [0, M) is cut into `segs` contiguous segments of a
// multiple of 32 entries (segs <= 16, one a warp), and the block keeps a
// row of n_ports + 1 counts a segment in dynamic shared memory (opted in
// above 48 KB; rows padded to 16 bytes).
//   1. zero the rows with 16-byte stores;
//   2. count: every thread adds its entries into its segment's row with
//      shared-memory atomics that only sum (order does not matter here);
//   3. scan: each bucket's counts become an exclusive prefix over the
//      segments, one thread a bucket walking the rows;
//   4. rank: each warp walks its segment in index order, 32 entries a
//      step, 8 steps loaded at once.  The lanes of a step with the same
//      bucket are found by one ballot a bit of the bucket (cheaper than
//      __match_any_sync, whose cost grows with the distinct values in
//      the warp); an entry's rank is its row's count so far plus the
//      group's lanes below it, and the group's lowest lane then adds the
//      group's size to the row.
// One walk of M / (32 segs) steps against passes over segs rows of
// counts: the plan sizes segs to balance them.  No rank is read from an
// atomic, so index order is kept.
//
// pairwise (segs == 0), where even one row of counts does not fit in
// shared memory: each thread counts the equal ports at lower indices
// itself, the block staging 256 ports at a time in shared memory,
// M^2 / 2 compares in all.
//
// Fused RED/ECN epilogue (tick_rank_red_ecn_launch).  The engine's next
// step, red_ecn (red_ecn.cu), reads each entry's rank, its port's tail,
// its enqueue flag and its uniform draw, and keeps only trim, mark and
// slot.  Its own launch costs more than its 130 KB of traffic, so the
// fused entry point applies red_ecn.cuh's stage where the rank is made
// and writes trim, mark and slot in place of the rank (neither the rank
// nor the occupancy reaches device memory).  It also replaces
// src/repro/kernels/red_ecn.py, _red_ecn_kernel, on the engine's path.
// The smem path issues the epilogue's loads (enq, unif and the q_tail
// gather, an L2 round trip behind the port load) with the step batch's
// port loads, before the ballots, so they overlap the ballots instead of
// following each rank; the pairwise path loads them before its count.
//
// The RED draw in place (kDraw, tick_rank_red_ecn_launch with rng): the
// entry's uniform is element i of the tick's k_mark draw (tick_draws.cuh),
// which replaces a launch of tick_draws.cu a tick.  It is made only where
// it decides the mark (an accepted entry with 0 < pr < 1; the
// compaction's pads are never enqueued), so a tick's draws follow its
// enqueues in the RED band (~13 of M = 5,024 at DF-1056), not M: drawing
// all M in the one block the smem path runs on costs M threefry blocks
// of ~70 integer instructions on one SM.  The walking warp draws such an
// entry inline, one threefry block (deferring the band's draws past the
// walk to all 512 threads measured slower: the pass re-reads what the
// walk wrote).  k_mark (two threefry blocks) is made once a block by
// warp 0 before the first barrier, while the other warps zero the count
// rows, and handed over through an 8-byte scratch in device memory that
// the first barrier publishes (no static shared memory, so the plan's
// dynamic rows keep the whole opt-in).  The pairwise path, a thread an
// entry, makes k_mark in each thread before its count.
#include <cuda_runtime.h>

#include "red_ecn.cuh"
#include "tick_draws.cuh"

#define TR_THREADS 256        // pairwise path
#define TR_SMEM_THREADS 512   // smem path: 16 warps
#define TR_MAX_SEGS (TR_SMEM_THREADS / 32)
#define TR_UNROLL 8           // entries a lane loads before it walks them
#define TR_MAX_DEVICES 64     // devices whose shared-memory opt-in is kept

__device__ __forceinline__ int bucket(int p, int n_ports) {
  return (p < 0 || p >= n_ports) ? n_ports : p;
}

// The fused epilogue's inputs and outputs; a rank-only launch passes it
// empty and never reads it.  unif is read, or (kDraw) drawn from rng.
struct RedEcnArgs {
  const bool* enq;
  const float* unif;
  const long long* rng;  // the carry's key words, [2] int64
  uint2* k_mark;         // smem path with rng: 8 bytes of scratch
  const int* q_tail;
  const int* t;          // the tick, in device memory
  int qsize;
  float kmin, recip;
  bool* trim;
  bool* mark;
  int* slot;
};

// What an entry's epilogue reads besides its rank.
struct RedEcnIn {
  int tail, t;
  bool enq;
  float unif;
};

template <bool kDraw>
__device__ __forceinline__ RedEcnIn load_red(const RedEcnArgs& red, int i,
                                             int p, int n_ports) {
  return {__ldg(red.q_tail + red_ecn_port(p, n_ports)), __ldg(red.t),
          red.enq[i], kDraw ? 0.0f : __ldg(red.unif + i)};
}

// Entry i's result: its rank, or (kRed) its trim, mark and slot, the
// uniform read or (kDraw) drawn on key k_mark.
template <bool kRed, bool kDraw>
__device__ __forceinline__ void put(int* __restrict__ rank,
                                    const RedEcnArgs& red, int i, int r,
                                    const RedEcnIn& in, uint2 k_mark) {
  if constexpr (kRed) {
    RedEcnOut o;
    if constexpr (kDraw)
      o = red_ecn_one_drawn(in.tail, r, in.enq,
                            [&] { return tick_uniform(k_mark, (uint32_t)i); },
                            in.t, red.qsize, red.kmin, red.recip);
    else
      o = red_ecn_one(in.tail, r, in.enq, in.unif, in.t, red.qsize,
                      red.kmin, red.recip);
    red.trim[i] = o.trim;
    red.mark[i] = o.mark;
    red.slot[i] = o.slot;
  } else {
    rank[i] = r;
  }
}

// Loads the ports and buckets of steps [base, base + 32 * TR_UNROLL) of
// one lane (bucket -1 past the segment's end), all in flight together.
__device__ __forceinline__ void load_steps(const int* __restrict__ port,
                                           int base, int hi, int lane,
                                           int n_ports, int* p, int* b) {
#pragma unroll
  for (int u = 0; u < TR_UNROLL; ++u) {
    const int i = base + u * 32 + lane;
    p[u] = i < hi ? __ldg(port + i) : 0;
    b[u] = i < hi ? bucket(p[u], n_ports) : -1;
  }
}

// For each of the TR_UNROLL steps, the lanes whose bucket equals this
// lane's (valid lanes only): one ballot a bit of the bucket, `bits` of
// them (buckets < 2^bits), the steps' ballots interleaved.
__device__ __forceinline__ void groups_of(const int* b, int bits,
                                          unsigned* grp) {
#pragma unroll
  for (int u = 0; u < TR_UNROLL; ++u)
    grp[u] = __ballot_sync(0xffffffffu, b[u] >= 0);
  for (int k = 0; k < bits; ++k) {
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      const bool bit = (b[u] >> k) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, bit);
      grp[u] &= bit ? bal : ~bal;
    }
  }
}

template <bool kRed, bool kDraw>
__global__ void __launch_bounds__(TR_SMEM_THREADS)
tick_rank_smem_kernel(const int* __restrict__ port, int* __restrict__ rank,
                      RedEcnArgs red, int M, int n_ports, int segs,
                      int seg_len, int stride, int bits) {
  extern __shared__ int4 cnt4[];
  int* cnt = reinterpret_cast<int*>(cnt4);
  const int total4 = segs * stride / 4;          // stride % 4 == 0
  // kDraw: warp 0 makes k_mark while the others zero the rows; the first
  // barrier publishes it
  const int z0 = kDraw ? 32 : 0;
  if (kDraw && threadIdx.x < 32) {
    const uint2 k = tick_key(red.rng, red.t, TICK_K_MARK);
    if (threadIdx.x == 0) *red.k_mark = k;
  }
  for (int i = threadIdx.x - z0; i >= 0 && i < total4;
       i += TR_SMEM_THREADS - z0)
    cnt4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 2. count: every thread, integer atomics that only sum
  for (int i = threadIdx.x; i < M; i += TR_SMEM_THREADS)
    atomicAdd(&cnt[(i / seg_len) * stride + bucket(__ldg(port + i), n_ports)],
              1);
  __syncthreads();

  // 3. exclusive prefix over the segments, bucket by bucket
  for (int k = threadIdx.x; k <= n_ports; k += TR_SMEM_THREADS) {
    int run = 0;
#pragma unroll 4
    for (int s = 0; s < segs; ++s) {
      const int v = cnt[s * stride + k];
      cnt[s * stride + k] = run;
      run += v;
    }
  }
  __syncthreads();

  // 4. rank: each warp walks its segment in index order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= segs) return;
  const uint2 k_mark = kDraw ? *red.k_mark : make_uint2(0u, 0u);
  const unsigned below = (1u << lane) - 1u;
  int* row = cnt + warp * stride;
  const int lo = warp * seg_len, hi = min(lo + seg_len, M);
  int p[TR_UNROLL], b[TR_UNROLL];
  unsigned grp[TR_UNROLL];
  RedEcnIn in[TR_UNROLL] = {};
  for (int base = lo; base < hi; base += 32 * TR_UNROLL) {
    load_steps(port, base, hi, lane, n_ports, p, b);
    if constexpr (kRed) {          // in flight while the ballots run
#pragma unroll
      for (int u = 0; u < TR_UNROLL; ++u)
        if (b[u] >= 0) in[u] = load_red<kDraw>(red, base + u * 32 + lane,
                                               p[u], n_ports);
    }
    groups_of(b, bits, grp);
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      if (base + u * 32 >= hi) break;           // warp-uniform
      const int seen = b[u] >= 0 ? row[b[u]] : 0;
      __syncwarp();
      if (b[u] >= 0) {
        if ((grp[u] & below) == 0) row[b[u]] = seen + __popc(grp[u]);
        put<kRed, kDraw>(rank, red, base + u * 32 + lane,
                         seen + __popc(grp[u] & below), in[u], k_mark);
      }
      __syncwarp();
    }
  }
}

template <bool kRed, bool kDraw>
__global__ void tick_rank_pairwise_kernel(const int* __restrict__ port,
                                          int* __restrict__ rank,
                                          RedEcnArgs red, int M,
                                          int n_ports) {
  __shared__ int tile[TR_THREADS];
  const int i = blockIdx.x * TR_THREADS + threadIdx.x;
  const int p = i < M ? port[i] : 0;
  const int mine = i < M ? bucket(p, n_ports) : -1;
  RedEcnIn in = {};
  if (kRed && i < M) in = load_red<kDraw>(red, i, p, n_ports);
  const uint2 k_mark = kDraw ? tick_key(red.rng, red.t, TICK_K_MARK)
                             : make_uint2(0u, 0u);
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
  if (i < M) put<kRed, kDraw>(rank, red, i, count, in, k_mark);
}

// segs: the smem path's segment count (1..16), or 0 for the pairwise
// path.  The smem path needs segs * round_up(n_ports + 1, 4) * 4 bytes of
// shared memory, which the caller has checked against the device's limit.
template <bool kRed, bool kDraw>
static int launch(const int* port, int* rank, const RedEcnArgs& red, int M,
                  int n_ports, int segs, cudaStream_t s) {
  if (segs < 0 || segs > TR_MAX_SEGS) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  if (segs == 0) {
    const int blocks = (M + TR_THREADS - 1) / TR_THREADS;
    tick_rank_pairwise_kernel<kRed, kDraw><<<blocks, TR_THREADS, 0, s>>>(
        port, rank, red, M, n_ports);
    return (int)cudaGetLastError();
  }
  const int stride = (n_ports + 1 + 3) / 4 * 4;
  const int seg_len = ((M + segs - 1) / segs + 31) / 32 * 32;
  const size_t smem = (size_t)segs * stride * sizeof(int);
  // the opt-in is set once a device for each size it grows to (a launch
  // that a CUDA graph captures after a warm-up makes no attribute call)
  static size_t opted_in[TR_MAX_DEVICES] = {};   // one a template
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= TR_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(tick_rank_smem_kernel<kRed, kDraw>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = smem;
  }
  int bits = 1;                                  // buckets 0..n_ports
  while (bits < 31 && (1 << bits) <= n_ports) ++bits;
  tick_rank_smem_kernel<kRed, kDraw><<<1, TR_SMEM_THREADS, smem, s>>>(
      port, rank, red, M, n_ports, segs, seg_len, stride, bits);
  return (int)cudaGetLastError();
}

extern "C" int tick_rank_launch(const void* port, void* rank, int M,
                                int n_ports, int segs, void* stream) {
  return launch<false, false>((const int*)port, (int*)rank, RedEcnArgs{},
                              M, n_ports, segs, (cudaStream_t)stream);
}

// The rank, then red_ecn's stage on it, in one launch: writes trim, mark
// and slot [M] (no rank, no occupancy).  recip is the f32 reciprocal of
// kmax - kmin, as red_ecn_launch takes it; t points to the tick in device
// memory, as red_ecn_launch takes it.  Exactly one of unif ([M] f32) and
// rng (the carry's [2] int64 key: the uniforms are drawn in place, k_mark
// passing through 8 bytes of device memory at `scratch`) is non-null.
extern "C" int tick_rank_red_ecn_launch(const void* port, const void* enq,
                                        const void* unif, const void* rng,
                                        void* scratch, const void* q_tail,
                                        const void* t, int qsize, float kmin,
                                        float recip, int n_ports, int M,
                                        int segs, void* trim, void* mark,
                                        void* slot, void* stream) {
  if ((unif == nullptr) == (rng == nullptr) || (rng && !scratch))
    return (int)cudaErrorInvalidValue;
  const RedEcnArgs red{(const bool*)enq, (const float*)unif,
                       (const long long*)rng, (uint2*)scratch,
                       (const int*)q_tail, (const int*)t, qsize, kmin, recip,
                       (bool*)trim, (bool*)mark, (int*)slot};
  return rng ? launch<true, true>((const int*)port, nullptr, red, M, n_ports,
                                  segs, (cudaStream_t)stream)
             : launch<true, false>((const int*)port, nullptr, red, M,
                                   n_ports, segs, (cudaStream_t)stream);
}
