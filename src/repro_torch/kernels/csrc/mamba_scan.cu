// Mamba's selective scan and its gradient (Jamba's hybrid layers), f32.
//
// Forward, for each batch b, channel e < E (d_in) and state n < 16
// (d_state), over the tokens t in order:
//   h_t[e, n] = exp(dt_t A[e, n]) h_{t-1}[e, n] + (dt_t B_t[n]) x_t[e]
//   y_t[e]    = sum_n h_t[e, n] C_t[n]
// from h_{-1} = h0.  x, y: [B, S, E]; dt: [B, S] (one scalar a token,
// shared by every channel); A: [E, 16]; Bm, Cm: [B, S, 16]; h0 and the
// final state hT: [B, E, 16].  With ``states`` non-null it also writes
// the state before every K-th token, states[b, s] = h_{sK - 1}, [B,
// ceil(S / K), E, 16] (states[b, 0] = h0): the backward's checkpoints.
// The [B, S, E, 16] states are never written to device memory.
//
// Backward, from dy [B, S, E] and the final state's gradient dhT (null
// for 0), in reverse: with G the gradient reaching h_t from later tokens
// (dhT at the end), a_t = exp(dt_t A) and g = G + dy_t[e] C_t[n],
//   dx_t[e]  = dt_t sum_n g B_t[n]
//   dB_t[n]  = dt_t sum_e g x_t[e]           dC_t[n] = sum_e dy_t[e] h_t
//   ddt_t    = sum_{e,n} (g B_t[n] x_t[e] + g h_{t-1} a_t A[e, n])
//   dA[e, n] = sum_{b,t} g h_{t-1} a_t dt_t  G <- a_t g
// and dh0 = G after token 0.  Each K-token segment's states are
// recomputed from its checkpoint, then walked in reverse.
//
// Replaces: no Pallas kernel.  The reference gives this work to XLA: an
// associative scan in 256-token chunks (src/repro/models/ssm.py:66-96,
// the scan at :88) and its contraction with C, differentiated by XLA's
// autodiff.  On the card a token loop of torch ops would launch ~5
// kernels a token and keep a [B, d_in, 16] state a token for autograd.
//
// Bound on the H100: at Jamba-1.5-Large's width (E 16,384) and B 1 x S
// 2,048 the forward takes 537 M exponentials, 0.128 ms at 16 a clock an
// SM (132 SMs, 1.98 GHz), against its 268 MB of x and y (0.080 ms at
// 3.35 TB/s) and ~3.2 GFLOP of f32 FMAs (0.048 ms at 67 TFLOP/s): bound
// by the exponentials (kernels/work.py, mamba_scan_work).  The backward
// needs the same exponentials once more and reads x, dy and the
// checkpoints, writes dx: also bound by the exponentials.
//
// Design: a block holds 64 channels of one batch, four threads a
// channel, four states a thread, so a channel's sum over its 16 states
// is a thread's four FMAs and two shuffles.  The forward stages 64-token
// tiles of x, dt, B and C in shared memory, the next tile's loads in
// registers while the current one is scanned; every decay is one expf
// (one ex2.approx on the SFU after an exact split of dt A log2(e) on
// the FMA pipe, within 2 ulp of exp: the trained model's gradients sum
// many decays, and ex2.approx of a rounded dt A log2(e) alone is off by
// |dt A| ulp).  The backward takes segments of K = 16
// tokens, last first: the segment's tiles are staged (the previous
// segment's loads in flight), its 16 states recomputed from the
// checkpoint into shared memory, then walked in reverse, the decay
// raised again.  Its cross-channel sums (dB, dC over the 64 channels of
// a block; ddt over them and the states) leave each warp as a
// reduce-scatter of shuffles, are summed over the block's warps in a
// fixed order and written as per-block partials; a second kernel sums
// the partials over the blocks (and dA's over the batch) in a fixed
// order; ddt's sums over the channels and dA's over the segments and the
// batch run in f64.  No atomics: the same inputs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 16;          // d_state
constexpr int CH = 64;         // channels a block
constexpr int THREADS = 256;   // four a channel, four states each
constexpr int WARPS = THREADS / 32;
constexpr int TF = 64;         // tokens a forward tile
constexpr int K = 16;          // tokens between checkpoints
constexpr unsigned FULL = 0xffffffffu;

static_assert(TF % K == 0, "a forward tile holds whole segments");
static_assert(K * N == THREADS, "one B and one C element a thread");

// shared memory of the backward, in floats
constexpr int B_HIST = 0;                        // [K][THREADS] float4
constexpr int B_DDT = B_HIST + 4 * K * THREADS;  // [K][THREADS]
constexpr int B_RED = B_DDT + K * THREADS;       // [WARPS][K][32]
constexpr int B_X = B_RED + WARPS * K * 32;      // [K][CH]
constexpr int B_DY = B_X + K * CH;               // [K][CH]
constexpr int B_B = B_DY + K * CH;               // [K][N]
constexpr int B_C = B_B + K * N;                 // [K][N]
constexpr int B_DT = B_C + K * N;                // [K]
constexpr int B_TOTAL = B_DT + K;
constexpr size_t BWD_SMEM = B_TOTAL * sizeof(float);

__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ states,
                      int S, int E) {
  __shared__ float s_x[TF][CH];
  __shared__ float s_B[TF][N];
  __shared__ float s_C[TF][N];
  __shared__ float s_dt[TF];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 3;                       // the thread's 4 states
  const int c = warp * 8 + (lane >> 2);         // its channel in the block
  const int b = blockIdx.y;
  const int e = blockIdx.x * CH + c;
  const bool live = e < E;
  const int nseg = (S + K - 1) / K;
  const float* xb = x + (long long)b * S * E;
  const float* Bb = Bm + (long long)b * S * N;
  const float* Cb = Cm + (long long)b * S * N;
  const float* db = dt + (long long)b * S;
  float* yb = y + (long long)b * S * E;
  const long long own = ((long long)b * E + e) * N + 4 * q;

  float av[4], h[4];
  {
    const float4 hv = live ? *reinterpret_cast<const float4*>(h0 + own)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      av[j] = live ? A[(long long)e * N + 4 * q + j] : 0.f;
  }
  // a thread's share of a tile: x rows (tid >> 6) + 4 m, column tid & 63;
  // B and C elements tid + 256 m; dt element tid
  const int col = tid & 63;
  const bool col_live = blockIdx.x * CH + col < E;
  const int e_col = blockIdx.x * CH + col;
  float px[TF / 4], pB[4], pC[4], pdt = 0.f;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int m = 0; m < TF / 4; ++m) {
      const int t = t0 + (tid >> 6) + 4 * m;
      px[m] = (t < S && col_live) ? xb[(long long)t * E + e_col] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = tid + THREADS * m, t = t0 + (i >> 4);
      pB[m] = t < S ? Bb[(long long)t * N + (i & 15)] : 0.f;
      pC[m] = t < S ? Cb[(long long)t * N + (i & 15)] : 0.f;
    }
    pdt = (tid < TF && t0 + tid < S) ? db[t0 + tid] : 0.f;
  };
  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TF) {
    __syncthreads();                 // the last tile's readers are done
#pragma unroll
    for (int m = 0; m < TF / 4; ++m) s_x[(tid >> 6) + 4 * m][col] = px[m];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = tid + THREADS * m;
      s_B[i >> 4][i & 15] = pB[m];
      s_C[i >> 4][i & 15] = pC[m];
    }
    if (tid < TF) s_dt[tid] = pdt;
    __syncthreads();
    if (t0 + TF < S) fetch(t0 + TF);
    const int n_tok = min(TF, S - t0);
    for (int k = 0; k < n_tok; ++k) {
      const int t = t0 + k;
      if (states != nullptr && (k % K) == 0 && live)
        *reinterpret_cast<float4*>(
            states + (((long long)b * nseg + t / K) * E + e) * N + 4 * q) =
            make_float4(h[0], h[1], h[2], h[3]);
      const float d = s_dt[k], xv = s_x[k][c];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * q + j;
        const float a = expf(d * av[j]);
        h[j] = fmaf(a, h[j], (d * s_B[k][n]) * xv);
        acc = fmaf(h[j], s_C[k][n], acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      if (q == 0 && live) yb[(long long)t * E + e] = acc;
    }
  }
  if (live)
    *reinterpret_cast<float4*>(hT + own) = make_float4(h[0], h[1], h[2],
                                                       h[3]);
}

// One stage of a reduce-scatter over lanes ``mask`` apart: the lane with
// the bit set keeps the upper half of v[0, 2H), its partner the lower,
// each adding the other's copy of the half it keeps into v[0, H).
template <int H>
__device__ __forceinline__ void rs_stage(float* v, int mask, bool upper) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
mamba_scan_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ states,
                      const float* __restrict__ dy,
                      const float* __restrict__ dhT, float* __restrict__ dx,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      double* __restrict__ ddtp, double* __restrict__ dAp,
                      float* __restrict__ dh0, int S, int E) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float4* s_hist = smem4 + B_HIST / 4;
  float* s_ddt = sm + B_DDT;
  float* s_red = sm + B_RED;
  float* s_x = sm + B_X;
  float* s_dy = sm + B_DY;
  float* s_B = sm + B_B;
  float* s_C = sm + B_C;
  float* s_dt = sm + B_DT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 3;
  const int c = warp * 8 + (lane >> 2);
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int e = blk * CH + c;
  const bool live = e < E;
  const int nseg = (S + K - 1) / K;
  const float* xb = x + (long long)b * S * E;
  const float* yb = dy + (long long)b * S * E;
  const float* Bb = Bm + (long long)b * S * N;
  const float* Cb = Cm + (long long)b * S * N;
  const float* db = dt + (long long)b * S;
  const long long own = ((long long)b * E + e) * N + 4 * q;

  float a[4], G[4], dA[4];
  double dA_all[4];          // dA over the segments, in f64
  {
    const float4 g = (live && dhT != nullptr)
                         ? *reinterpret_cast<const float4*>(dhT + own)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    G[0] = g.x, G[1] = g.y, G[2] = g.z, G[3] = g.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = live ? A[(long long)e * N + 4 * q + j] : 0.f;
      dA_all[j] = 0.0;
    }
  }
  // a thread's share of a segment: x and dy rows (tid >> 6) + 4 m,
  // column tid & 63; B and C element tid; dt element tid; its own 4
  // checkpoint states
  const int col = tid & 63;
  const int e_col = blk * CH + col;
  const bool col_live = e_col < E;
  float px[K / 4], pdy[K / 4], pB, pC, pdt;
  float4 pst;
  auto fetch = [&](int seg) {
    const int t0 = seg * K;
#pragma unroll
    for (int m = 0; m < K / 4; ++m) {
      const int t = t0 + (tid >> 6) + 4 * m;
      const bool ok = t < S && col_live;
      px[m] = ok ? xb[(long long)t * E + e_col] : 0.f;
      pdy[m] = ok ? yb[(long long)t * E + e_col] : 0.f;
    }
    const int t = t0 + (tid >> 4);
    pB = t < S ? Bb[(long long)t * N + (tid & 15)] : 0.f;
    pC = t < S ? Cb[(long long)t * N + (tid & 15)] : 0.f;
    pdt = (tid < K && t0 + tid < S) ? db[t0 + tid] : 0.f;
    pst = live ? *reinterpret_cast<const float4*>(
                     states + (((long long)b * nseg + seg) * E + e) * N +
                     4 * q)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  fetch(nseg - 1);
  for (int seg = nseg - 1; seg >= 0; --seg) {
    __syncthreads();        // the last segment's readers are done
#pragma unroll
    for (int m = 0; m < K / 4; ++m) {
      s_x[((tid >> 6) + 4 * m) * CH + col] = px[m];
      s_dy[((tid >> 6) + 4 * m) * CH + col] = pdy[m];
    }
    s_B[tid] = pB;
    s_C[tid] = pC;
    if (tid < K) s_dt[tid] = pdt;
    const float4 hs = pst;
    __syncthreads();
    if (seg > 0) fetch(seg - 1);
    const int t0 = seg * K, n_tok = min(K, S - t0);
    // the segment's states from its checkpoint; tokens past S have dt 0
    // (decay 1, drive 0) and leave the state as it is
    {
      float h[4] = {hs.x, hs.y, hs.z, hs.w};
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float d = s_dt[k], xv = s_x[k * CH + c];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = fmaf(expf(d * a[j]), h[j],
                      (d * s_B[k * N + 4 * q + j]) * xv);
        s_hist[k * THREADS + tid] = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    float4 cur = s_hist[(K - 1) * THREADS + tid];
#pragma unroll
    for (int j = 0; j < 4; ++j) dA[j] = 0.f;
#pragma unroll 2
    for (int k = K - 1; k >= 0; --k) {
      const float4 prev = k > 0 ? s_hist[(k - 1) * THREADS + tid] : hs;
      const float hc[4] = {cur.x, cur.y, cur.z, cur.w};
      const float hp[4] = {prev.x, prev.y, prev.z, prev.w};
      const float d = s_dt[k], xv = s_x[k * CH + c], gy = s_dy[k * CH + c];
      float v[8];
      float ddt = 0.f, dxs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float Bn = s_B[k * N + 4 * q + j];
        const float Cn = s_C[k * N + 4 * q + j];
        const float g = fmaf(gy, Cn, G[j]);
        const float dec = expf(d * a[j]);
        const float ga = g * hp[j] * dec;
        v[j] = (g * d) * xv;                   // dB's share
        v[4 + j] = gy * hc[j];                 // dC's share
        ddt = fmaf(g * Bn, xv, fmaf(ga, a[j], ddt));
        dA[j] = fmaf(ga, d, dA[j]);
        dxs = fmaf(g, Bn, dxs);
        G[j] = dec * g;
      }
      dxs *= d;
      dxs += __shfl_xor_sync(FULL, dxs, 1);
      dxs += __shfl_xor_sync(FULL, dxs, 2);
      if (q == 0 && live && k < n_tok)
        dx[((long long)b * S + t0 + k) * E + e] = dxs;
      // over the warp's 8 channels of state quarter q: lane slot
      // (lane >> 2) & 7 ends with the sum of v[slot]
      rs_stage<4>(v, 16, lane & 16);
      rs_stage<2>(v, 8, lane & 8);
      rs_stage<1>(v, 4, lane & 4);
      const int slot = (lane >> 2) & 7;
      s_red[(warp * K + k) * 32 + (slot >> 2) * N + 4 * q + (slot & 3)] =
          v[0];
      s_ddt[k * THREADS + tid] = ddt;
      cur = prev;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dA_all[j] += dA[j];
    __syncthreads();
    // the block's sums for the segment: dB and dC over the warps, ddt
    // over the threads (in f64: ddt's terms cancel, and the dt_bias
    // gradient sums it over every token), each in a fixed order
    {
      const int k = tid >> 4, n = tid & 15;
      float sb = 0.f, sc = 0.f;
      double sd = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sb += s_red[(w * K + k) * 32 + n];
        sc += s_red[(w * K + k) * 32 + N + n];
      }
#pragma unroll
      for (int i = 0; i < THREADS / 16; ++i)
        sd += s_ddt[k * THREADS + i * 16 + n];
      sd += __shfl_xor_sync(FULL, sd, 1);
      sd += __shfl_xor_sync(FULL, sd, 2);
      sd += __shfl_xor_sync(FULL, sd, 4);
      sd += __shfl_xor_sync(FULL, sd, 8);
      if (k < n_tok) {
        const long long row = ((long long)b * nblk + blk) * S + t0 + k;
        dBp[row * N + n] = sb;
        dCp[row * N + n] = sc;
        if (n == 0) ddtp[row] = sd;
      }
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(dh0 + own) = make_float4(G[0], G[1], G[2],
                                                        G[3]);
    *reinterpret_cast<double2*>(dAp + own) = make_double2(dA_all[0],
                                                          dA_all[1]);
    *reinterpret_cast<double2*>(dAp + own + 2) = make_double2(dA_all[2],
                                                              dA_all[3]);
  }
}

// The second pass: dB, dC and ddt summed over the blocks' partials, dA
// over the batch, each in order.
__global__ void mamba_scan_bwd_sum_kernel(
    const float* __restrict__ dBp, const float* __restrict__ dCp,
    const double* __restrict__ ddtp, const double* __restrict__ dAp,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ ddt,
    float* __restrict__ dA, int B, int S, int E, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sn = (long long)S * N, nbs = B * sn, nbt = (long long)B * S;
  if (i < nbs) {
    const long long b = i / sn, r = i % sn;
    const float* pb = dBp + b * nblk * sn + r;
    const float* pc = dCp + b * nblk * sn + r;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      sb += pb[k * sn];
      sc += pc[k * sn];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < nbs + nbt) {
    const long long j = i - nbs, b = j / S, r = j % S;
    const double* p = ddtp + b * nblk * S + r;
    double s = 0.0;
    for (int k = 0; k < nblk; ++k) s += p[(long long)k * S];
    ddt[j] = (float)s;
  } else if (i < nbs + nbt + (long long)E * N) {
    const long long j = i - nbs - nbt;
    double s = 0.0;
    for (int b = 0; b < B; ++b) s += dAp[(long long)b * E * N + j];
    dA[j] = (float)s;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

cudaError_t set_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(mamba_scan_bwd_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Blocks of a call over E channels (the partials' second dimension).
extern "C" int mamba_scan_blocks(int E) { return (E + CH - 1) / CH; }

// Dynamic shared memory of a backward block.
extern "C" int mamba_scan_bwd_smem_bytes() { return (int)BWD_SMEM; }

// Backward blocks one SM holds (the occupancy calculator), or minus a
// CUDA error.
extern "C" int mamba_scan_bwd_blocks_per_sm() {
  const cudaError_t err = set_smem();
  if (err != cudaSuccess) return -(int)err;
  int nb = 0;
  const cudaError_t e2 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, mamba_scan_bwd_kernel, THREADS, BWD_SMEM);
  return e2 == cudaSuccess ? nb : -(int)e2;
}

// x, y: [B, S, E]; dt: [B, S]; A: [E, 16]; Bm, Cm: [B, S, 16]; h0, hT:
// [B, E, 16]; states: [B, ceil(S / 16), E, 16] or null; all f32,
// contiguous; h0, hT and states 16-byte aligned.
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* A, const void* Bm,
                                 const void* Cm, const void* h0, void* y,
                                 void* hT, void* states, int B, int S, int E,
                                 void* stream) {
  if (B == 0 || E == 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(h0) || !aligned16(hT) ||
      (states != nullptr && !aligned16(states)))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((E + CH - 1) / CH, B);
  mamba_scan_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)h0, (float*)y, (float*)hT,
      (float*)states, S, E);
  return (int)cudaGetLastError();
}

// The backward: two launches, the scan then the sums.  dhT may be null
// (0).  Outputs dx [B, S, E], ddt [B, S], dA [E, 16], dB, dC [B, S, 16],
// dh0 [B, E, 16]; scratch dBp, dCp [B, nblk, S, 16] f32, ddtp [B, nblk,
// S] and dAp [B, E, 16] f64, nblk = mamba_scan_blocks(E).  states, dhT, dAp and
// dh0 16-byte aligned.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* states, const void* dy, const void* dhT,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0, void* dBp,
    void* dCp, void* ddtp, void* dAp, int B, int S, int E, int nblk,
    void* stream) {
  if (B == 0 || E == 0) return 0;
  if (S < 1 || nblk != (E + CH - 1) / CH) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {states, dAp, dh0};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (dhT != nullptr && !aligned16(dhT))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  mamba_scan_bwd_kernel<<<dim3(nblk, B), THREADS, BWD_SMEM, s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)states, (const float*)dy,
      (const float*)dhT, (float*)dx, (float*)dBp, (float*)dCp,
      (double*)ddtp, (double*)dAp, (float*)dh0, S, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total =
      (long long)B * S * N + (long long)B * S + (long long)E * N;
  const int threads = 256;
  mamba_scan_bwd_sum_kernel<<<(unsigned)((total + threads - 1) / threads),
                              threads, 0, s>>>(
      (const float*)dBp, (const float*)dCp, (const double*)ddtp,
      (const double*)dAp, (float*)dB, (float*)dC, (float*)ddt, (float*)dA, B,
      S, E, nblk);
  return (int)cudaGetLastError();
}
