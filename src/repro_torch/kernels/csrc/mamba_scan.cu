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
// needs the same exponentials once and ~21 FLOPs a state element: bound
// by its FLOPs.  What holds both back in practice is the issue rate (a
// scheduler issues one warp instruction a clock), so the design counts
// the instructions a state element.
//
// The decay: expf(x) with x = dt A rounded as the reference rounds it,
// within expf's 2 ulp of exp(x).  The trained model's dt_bias gradient is
// a cancelling sum of many decays and shows their error: ex2.approx of a
// rounded x log2(e) alone is off by |x| ulp, and a cheaper split of it
// (ex2.approx of the rounded p = x log2(e) times 1 + err ln 2, err formed
// exactly) is 2.5 ulp from exp(x), past expf's 2 (PORT.md).
//
// Forward design: a block of 128 threads, 8 states a thread, two threads
// a channel (y's sum over the states is eight FMAs and one shuffle), 64
// channels a block: 256 blocks of 4 warps at B 1.
// dt, B and C come through a two-tile cp.async ring in shared memory (64
// tokens a tile), where dt B is formed once a token for the block; x is
// loaded a 16-token sub-tile ahead into registers.  Each sub-tile (one
// checkpoint segment) is one block of straight-line code, its y kept in
// registers and stored after it, so later tokens' decays, which do not
// depend on h, issue while the serial FMA chain runs; tokens past S have
// dt 0 and x 0 (decay 1, drive 0) and change no state.
//
// Backward design: a block of 128 threads holds 64 channels of one batch,
// four channels by two states a thread, so dB's and dC's sums over the
// channels start in the thread (four channels) and dx's over the states
// (two).  A segment of K = 16 tokens is staged by cp.async (the next
// segment's copies in flight), its states rebuilt from the checkpoint,
// each decay raised once and kept in registers (both 16-token loops
// unrolled), then walked in reverse.  A thread's shared-memory slot of
// token k holds its h_k, read once by the walk, then its partials of dB,
// dC and dx for token k; after the walk the block sums the slots over
// the channels (dB, dC) and the states (dx) in a fixed order, writes dx
// as coalesced rows and dB, dC and ddt (summed in f64 over the block) as
// per-block partials; a second kernel sums the partials over the blocks
// (and dA's over the batch) in a fixed order; ddt's sums over the
// channels and dA's over the segments and the batch run in f64.  No
// atomics: the same inputs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 16;          // d_state
constexpr int K = 16;          // tokens between checkpoints: a sub-tile
constexpr unsigned FULL = 0xffffffffu;

// the forward
constexpr int F_THREADS = 128;
constexpr int F_NS = 8;                  // states a thread
constexpr int F_TPC = N / F_NS;          // threads a channel
constexpr int F_CH = F_THREADS / F_TPC;  // channels a block
constexpr int TF = 64;                   // tokens a staged tile
static_assert(TF % K == 0, "a tile holds whole sub-tiles");

// the backward
constexpr int THREADS = 128;
constexpr int CH = 64;                   // channels a block (the partials)
constexpr int CT = 4, NT = 2;            // a thread's channels and states
constexpr int EL = CT * NT;              // its state elements
static_assert((CH / CT) * (N / NT) == THREADS, "one tile a thread");
static_assert(EL == 8, "a slot is two float4");

// shared memory of the backward, in floats: a thread's slots [K][THREADS]
// of EL floats (its h_k, then its partials), ddt's partials [K][DDT_LD],
// dA's f64 sums [4][THREADS] double2, then two stages of a
// segment: x, dy [K][CH], B, C [K][N], dt [K], the checkpoint [CH][N]
constexpr int DDT_LD = THREADS + 8;       // conflict-free f64 sums
constexpr int B_HIST = 0;
constexpr int B_DDT = B_HIST + K * THREADS * EL;
constexpr int B_DA = B_DDT + K * DDT_LD;
constexpr int B_STAGE = B_DA + 4 * THREADS * 4;
constexpr int ST_X = 0, ST_DY = ST_X + K * CH, ST_B = ST_DY + K * CH,
              ST_C = ST_B + K * N, ST_DT = ST_C + K * N, ST_CK = ST_DT + K,
              ST_SIZE = ST_CK + CH * N;
constexpr int B_TOTAL = B_STAGE + 2 * ST_SIZE;
constexpr size_t BWD_SMEM = B_TOTAL * sizeof(float);
static_assert(B_DDT % 4 == 0 && B_DA % 4 == 0 &&
                  B_STAGE % 4 == 0 && ST_CK % 4 == 0 && ST_SIZE % 4 == 0,
              "16-byte aligned regions");

// exp(d a): the product rounded as the reference rounds it
__device__ __forceinline__ float decay(float d, float a) {
  return expf(d * a);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; ``nbytes`` 0 fills the destination with 0
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Stages n floats of src into dst by 16-byte copies of every thread of
// the block: the first n_ok copied, the rest 0 (src and dst 16-byte
// aligned, n and n_ok multiples of 4).
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int n_ok, int tid, int nthr) {
  for (int i = 4 * tid; i < n; i += 4 * nthr)
    cp16(dst + i, i < n_ok ? src + i : src, i < n_ok ? 16 : 0);
}

// Stages a [nrow][ncol] block of rows (row r at src + r ld) into dst by
// 4-byte copies: rows below nrow_ok and columns below ncol_ok copied, the
// rest 0 (for rows that 16-byte copies cannot take).
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld, int nrow, int ncol,
                                           int nrow_ok, int ncol_ok, int tid,
                                           int nthr) {
  for (int i = tid; i < nrow * ncol; i += nthr) {
    const int r = i / ncol, c = i % ncol;
    const bool ok = r < nrow_ok && c < ncol_ok;
    cp4(dst + r * ncol + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two blocks an SM at least: the registers for a sub-tile's decays issued
// ahead (with expf, ptxas spills under its own limit of 128)
__global__ void __launch_bounds__(F_THREADS, 2)
mamba_scan_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ states,
                      int S, int E) {
  __shared__ __align__(16) float s_B[2][TF * N];   // B, then dt B in place
  __shared__ __align__(16) float s_C[2][TF * N];
  __shared__ __align__(16) float s_dt[2][TF];
  const int tid = threadIdx.x;
  const int q = tid % F_TPC;                // the thread's slice of states
  const int e = blockIdx.x * F_CH + tid / F_TPC;
  const int b = blockIdx.y;
  const bool live = e < E;
  const int nseg = (S + K - 1) / K;
  const long long own = ((long long)b * E + e) * N + q * F_NS;
  const float* xb = x + (long long)b * S * E + (live ? e : 0);
  float* yb = y + (long long)b * S * E + e;

  float av[F_NS], h[F_NS];
#pragma unroll
  for (int j = 0; j < F_NS; j += 4) {
    const float4 a4 = live ? ld4(A + (long long)e * N + q * F_NS + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 h4 = live ? ld4(h0 + own + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    av[j] = a4.x, av[j + 1] = a4.y, av[j + 2] = a4.z, av[j + 3] = a4.w;
    h[j] = h4.x, h[j + 1] = h4.y, h[j + 2] = h4.z, h[j + 3] = h4.w;
  }
  const int ntile = (S + TF - 1) / TF;
  auto load_tile = [&](int tile) {
    const int t0 = tile * TF, buf = tile & 1, n_ok = min(TF, S - t0);
    const long long row = (long long)b * S + t0;
    stage(s_B[buf], Bm + row * N, TF * N, n_ok * N, tid, F_THREADS);
    stage(s_C[buf], Cm + row * N, TF * N, n_ok * N, tid, F_THREADS);
    if (tid < TF)
      cp4(s_dt[buf] + tid, dt + row + (tid < n_ok ? tid : 0),
          tid < n_ok ? 4 : 0);
  };
  load_tile(0);
  cp_commit();
  if (ntile > 1) load_tile(1);
  cp_commit();

  float px[K];                              // x of the next sub-tile
  auto load_x = [&](int t0) {
    const float* p = xb + (long long)t0 * E;
    const int n_ok = live ? min(K, S - t0) : 0;
    if (n_ok == K) {
#pragma unroll
      for (int k = 0; k < K; ++k, p += E) px[k] = *p;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k, p += E) px[k] = k < n_ok ? *p : 0.f;
    }
  };
  load_x(0);
  for (int tile = 0; tile < ntile; ++tile) {
    const int buf = tile & 1, t0 = tile * TF;
    cp_wait<1>();
    __syncthreads();                        // tile `tile` has landed
    for (int i = tid; i < TF * N; i += F_THREADS)
      s_B[buf][i] *= s_dt[buf][i / N];      // dt B once a token
    __syncthreads();
    const float* sB = s_B[buf];
    const float* sC = s_C[buf];
    const float* sd = s_dt[buf];
    const int n_sub = (min(TF, S - t0) + K - 1) / K;
#pragma unroll 1
    for (int ks = 0; ks < n_sub; ++ks) {
      const int tk = t0 + ks * K;
      float xv[K], yv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) xv[k] = px[k];
      if (tk + K < S) load_x(tk + K);
      if (states != nullptr && live) {
        float* sp = states + (((long long)b * nseg + tk / K) * E + e) * N +
                    q * F_NS;
#pragma unroll
        for (int j = 0; j < F_NS; j += 4)
          *reinterpret_cast<float4*>(sp + j) =
              make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      }
      // the sub-tile's 16 tokens as one block of straight-line code: no
      // store or branch inside, so later tokens' decays issue early
      const float* sdk = sd + ks * K;
      const float* sBk = sB + ks * K * N + q * F_NS;
      const float* sCk = sC + ks * K * N + q * F_NS;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float d = sdk[k];
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int j = 0; j < F_NS; j += 4) {
          const float4 b4 = ld4(sBk + k * N + j), c4 = ld4(sCk + k * N + j);
          const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cj[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = decay(d, av[j + i]);
            h[j + i] = fmaf(a, h[j + i], bj[i] * xv[k]);
            if (i & 1)
              acc1 = fmaf(h[j + i], cj[i], acc1);
            else
              acc0 = fmaf(h[j + i], cj[i], acc0);
          }
        }
        float acc = acc0 + acc1;
#pragma unroll
        for (int o = 1; o < F_TPC; o *= 2)
          acc += __shfl_xor_sync(FULL, acc, o);
        yv[k] = acc;
      }
      if (live && q == 0) {
        float* yt = yb + (long long)tk * E;
        const int n_ok = min(K, S - tk);
        if (n_ok == K) {
#pragma unroll
          for (int k = 0; k < K; ++k, yt += E) *yt = yv[k];
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k, yt += E)
            if (k < n_ok) *yt = yv[k];
        }
      }
    }
    __syncthreads();                        // every reader of `buf` is done
    if (tile + 2 < ntile) load_tile(tile + 2);
    cp_commit();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < F_NS; j += 4)
      *reinterpret_cast<float4*>(hT + own + j) =
          make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  }
}

// A thread's slot of token k in the backward's shared memory: two float4
// (elements 0-3, then 4-7), their order swapped on every other group of
// four threads, so that eight threads of a quarter-warp touch 32
// distinct banks both in the walk (own slots) and in the block's sums.
__device__ __forceinline__ float4* slot(float* hist, int k, int tid,
                                        int half) {
  return reinterpret_cast<float4*>(hist) +
         ((k * THREADS + tid) * 2 + (half ^ ((tid >> 2) & 1)));
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
                      float* __restrict__ dh0, int S, int E, int vecX) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* hist = sm + B_HIST;
  float* s_ddt = sm + B_DDT;
  double2* s_dA = reinterpret_cast<double2*>(sm + B_DA);
  const int tid = threadIdx.x;
  const int cq = tid >> 3, sp = tid & 7;   // channels 4 cq + j, states 2 sp + i
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int e0 = blk * CH + CT * cq;
  const int nseg = (S + K - 1) / K;
  const int n_ch = min(CH, E - blk * CH);  // live channels of the block

  float av[EL], G[EL];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const bool ok = e0 + j < E;
    const long long o = ((long long)b * E + e0 + j) * N + NT * sp;
    const float2 a2 = ok ? *reinterpret_cast<const float2*>(
                               A + (long long)(e0 + j) * N + NT * sp)
                         : make_float2(0.f, 0.f);
    const float2 g2 = (ok && dhT != nullptr)
                          ? *reinterpret_cast<const float2*>(dhT + o)
                          : make_float2(0.f, 0.f);
    av[2 * j] = a2.x, av[2 * j + 1] = a2.y;
    G[2 * j] = g2.x, G[2 * j + 1] = g2.y;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
    s_dA[m * THREADS + tid] = make_double2(0.0, 0.0);

  auto load_seg = [&](int seg) {
    float* st = sm + B_STAGE + (seg & 1) * ST_SIZE;
    const int t0 = seg * K, n_tok = min(K, S - t0);
    const long long tok = (long long)b * S + t0;
    const float* xs = x + tok * E + blk * CH;
    const float* ys = dy + tok * E + blk * CH;
    if (vecX) {        // two 16-byte chunks of x and of dy a thread
#pragma unroll
      for (int m = 0; m < K * CH / 4 / THREADS; ++m) {
        const int i = tid + THREADS * m, r = i / (CH / 4),
                  c = 4 * (i % (CH / 4));
        const bool ok = r < n_tok && c < n_ch;
        const long long o = ok ? (long long)r * E + c : 0;
        cp16(st + ST_X + r * CH + c, xs + o, ok ? 16 : 0);
        cp16(st + ST_DY + r * CH + c, ys + o, ok ? 16 : 0);
      }
    } else {
      stage_rows(st + ST_X, xs, E, K, CH, n_tok, n_ch, tid, THREADS);
      stage_rows(st + ST_DY, ys, E, K, CH, n_tok, n_ch, tid, THREADS);
    }
    stage(st + ST_B, Bm + tok * N, K * N, n_tok * N, tid, THREADS);
    stage(st + ST_C, Cm + tok * N, K * N, n_tok * N, tid, THREADS);
    if (tid < K)
      cp4(st + ST_DT + tid, dt + tok + (tid < n_tok ? tid : 0),
          tid < n_tok ? 4 : 0);
    const float* ck =
        states + (((long long)b * nseg + seg) * E + blk * CH) * N;
#pragma unroll
    for (int m = 0; m < CH * N / 4 / THREADS; ++m) {
      const int i = 4 * (tid + THREADS * m);
      const bool ok = i < n_ch * N;
      cp16(st + ST_CK + i, ck + (ok ? i : 0), ok ? 16 : 0);
    }
    cp_commit();
  };
  load_seg(nseg - 1);
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const float* st = sm + B_STAGE + (seg & 1) * ST_SIZE;
    const float* s_x = st + ST_X;
    const float* s_dy = st + ST_DY;
    const float* s_B = st + ST_B;
    const float* s_C = st + ST_C;
    const float* s_dt = st + ST_DT;
    const float* s_ck = st + ST_CK;
    cp_wait<0>();
    __syncthreads();   // the segment has landed; the last one's sums are done
    if (seg > 0) load_seg(seg - 1);
    const int t0 = seg * K, n_tok = min(K, S - t0);

    // the segment's states from its checkpoint, each decay raised once;
    // tokens past S have dt 0 (decay 1, drive 0) and leave h as it is
    float h[EL], a[K][EL];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float2 c2 =
          *reinterpret_cast<const float2*>(s_ck + (CT * cq + j) * N + NT * sp);
      h[2 * j] = c2.x, h[2 * j + 1] = c2.y;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = s_dt[k];
      const float4 x4 = ld4(s_x + k * CH + CT * cq);
      const float2 b2 =
          *reinterpret_cast<const float2*>(s_B + k * N + NT * sp);
      const float xs[CT] = {x4.x, x4.y, x4.z, x4.w};
      const float bs[NT] = {d * b2.x, d * b2.y};   // dt B, as the forward
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int l = NT * j + i;
          a[k][l] = decay(d, av[l]);
          h[l] = fmaf(a[k][l], h[l], bs[i] * xs[j]);
        }
      *slot(hist, k, tid, 0) = make_float4(h[0], h[1], h[2], h[3]);
      *slot(hist, k, tid, 1) = make_float4(h[4], h[5], h[6], h[7]);
    }

    // the reverse walk: token k's slot gives h_k up (read at k + 1) and
    // takes the thread's partials of dB, dC (its 4 channels) and dx (its
    // 2 states)
    float dA[EL];
#pragma unroll
    for (int l = 0; l < EL; ++l) dA[l] = 0.f;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      float hp[EL];
      if (k > 0) {
        const float4 p0 = *slot(hist, k - 1, tid, 0);
        const float4 p1 = *slot(hist, k - 1, tid, 1);
        hp[0] = p0.x, hp[1] = p0.y, hp[2] = p0.z, hp[3] = p0.w;
        hp[4] = p1.x, hp[5] = p1.y, hp[6] = p1.z, hp[7] = p1.w;
      } else {
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float2 c2 = *reinterpret_cast<const float2*>(
              s_ck + (CT * cq + j) * N + NT * sp);
          hp[2 * j] = c2.x, hp[2 * j + 1] = c2.y;
        }
      }
      const float d = s_dt[k];
      const float4 x4 = ld4(s_x + k * CH + CT * cq);
      const float4 y4 = ld4(s_dy + k * CH + CT * cq);
      const float2 b2 = *reinterpret_cast<const float2*>(s_B + k * N + NT * sp);
      const float2 c2 = *reinterpret_cast<const float2*>(s_C + k * N + NT * sp);
      const float xs[CT] = {x4.x, x4.y, x4.z, x4.w};
      const float gy[CT] = {y4.x, y4.y, y4.z, y4.w};
      const float bs[NT] = {b2.x, b2.y}, cs[NT] = {c2.x, c2.y};
      float dxs[CT] = {0.f, 0.f, 0.f, 0.f}, dBs[NT] = {0.f, 0.f},
            dCs[NT] = {0.f, 0.f}, ddt = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int l = NT * j + i;
          const float g = fmaf(gy[j], cs[i], G[l]);
          const float Gn = a[k][l] * g;
          const float ga = Gn * hp[l];
          dA[l] = fmaf(ga, d, dA[l]);
          ddt = fmaf(ga, av[l], ddt);
          dxs[j] = fmaf(g, bs[i], dxs[j]);
          dBs[i] = fmaf(g, xs[j], dBs[i]);
          dCs[i] = fmaf(gy[j], h[l], dCs[i]);
          G[l] = Gn;
        }
#pragma unroll
      for (int j = 0; j < CT; ++j) ddt = fmaf(xs[j], dxs[j], ddt);
      *slot(hist, k, tid, 0) = make_float4(dBs[0], dBs[1], dCs[0], dCs[1]);
      *slot(hist, k, tid, 1) = make_float4(dxs[0], dxs[1], dxs[2], dxs[3]);
      s_ddt[k * DDT_LD + tid] = ddt;
#pragma unroll
      for (int l = 0; l < EL; ++l) h[l] = hp[l];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      double2 v = s_dA[m * THREADS + tid];
      v.x += dA[2 * m];
      v.y += dA[2 * m + 1];
      s_dA[m * THREADS + tid] = v;
    }
    __syncthreads();
    // the block's sums of the segment, each in a fixed order
    {  // dB and dC of token k, states 2 s + i: over the 16 channel groups
      const int k = tid >> 3, s = tid & 7;
      float4 w[4];
#pragma unroll
      for (int c = 0; c < CH / CT; ++c) {   // four chains, then their sum
        const float4 p = *slot(hist, k, c * 8 + s, 0);
        if (c < 4) {
          w[c] = p;
        } else {
          w[c & 3].x += p.x, w[c & 3].y += p.y, w[c & 3].z += p.z,
              w[c & 3].w += p.w;
        }
      }
      const float4 v = make_float4((w[0].x + w[1].x) + (w[2].x + w[3].x),
                                   (w[0].y + w[1].y) + (w[2].y + w[3].y),
                                   (w[0].z + w[1].z) + (w[2].z + w[3].z),
                                   (w[0].w + w[1].w) + (w[2].w + w[3].w));
      if (k < n_tok) {
        const long long row = ((long long)b * nblk + blk) * S + t0 + k;
        const float d = s_dt[k];
        *reinterpret_cast<float2*>(dBp + row * N + NT * s) =
            make_float2(d * v.x, d * v.y);
        *reinterpret_cast<float2*>(dCp + row * N + NT * s) =
            make_float2(v.z, v.w);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // dx of token k, channels 4 c + j
      const int k = (tid >> 4) + 8 * r, c = tid & 15;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < N / NT; ++u) {   // from state pair (u + c) % 8
        const float4 p = *slot(hist, k, c * 8 + ((u + c) & 7), 1);
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      const int ec = blk * CH + CT * c;
      if (k < n_tok && ec < E) {
        const float d = s_dt[k];
        float* o = dx + ((long long)b * S + t0 + k) * E + ec;
        if (vecX && ec + CT <= E) {
          *reinterpret_cast<float4*>(o) =
              make_float4(d * v.x, d * v.y, d * v.z, d * v.w);
        } else {
          const float vs[CT] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < CT; ++j)
            if (ec + j < E) o[j] = d * vs[j];
        }
      }
    }
    {  // ddt of token k over the block's 128 partials, in f64
      const int k = tid >> 3, part = tid & 7;
      double w[4] = {0.0, 0.0, 0.0, 0.0};   // four chains, then their sum
#pragma unroll
      for (int i = 0; i < THREADS / 8; ++i)
        w[i & 3] += (double)s_ddt[k * DDT_LD + part + 8 * i];
      double v = (w[0] + w[1]) + (w[2] + w[3]);
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      v += __shfl_xor_sync(FULL, v, 4);
      if (part == 0 && k < n_tok)
        ddtp[((long long)b * nblk + blk) * S + t0 + k] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (e0 + j >= E) continue;
    const long long o = ((long long)b * E + e0 + j) * N + NT * sp;
    *reinterpret_cast<float2*>(dh0 + o) = make_float2(G[2 * j], G[2 * j + 1]);
    *reinterpret_cast<double2*>(dAp + o) = s_dA[j * THREADS + tid];
  }
}

// The second pass: dB, dC and ddt summed over the blocks' partials, dA
// over the batch, each in a fixed order.  A block of SUM_THREADS takes 32
// consecutive outputs of dB and dC (or of ddt): its warp w sums the
// partials of blocks w, w + 8, w + 16, ... (a lane an output, so a warp
// reads 128 contiguous bytes a block), then the eight warps' sums are
// added in warp order.  The blocks past those take dA, a thread an
// element.
constexpr int SUM_THREADS = 256, SUM_W = SUM_THREADS / 32;

__global__ void __launch_bounds__(SUM_THREADS) mamba_scan_bwd_sum_kernel(
    const float* __restrict__ dBp, const float* __restrict__ dCp,
    const double* __restrict__ ddtp, const double* __restrict__ dAp,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ ddt,
    float* __restrict__ dA, int B, int S, int E, int nblk) {
  __shared__ float s_b[SUM_W][32], s_c[SUM_W][32];
  __shared__ double s_t[SUM_W][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long sn = (long long)S * N, nbs = B * sn, nbt = (long long)B * S;
  const long long g_bc = (nbs + 31) / 32, g_t = (nbt + 31) / 32;
  const long long g = blockIdx.x;
  if (g < g_bc) {
    const long long i = g * 32 + lane;
    float sb = 0.f, sc = 0.f;
    if (i < nbs) {
      const long long b = i / sn, r = i % sn;
      const float* pb = dBp + b * nblk * sn + r;
      const float* pc = dCp + b * nblk * sn + r;
      for (int k = w; k < nblk; k += SUM_W) {
        sb += pb[k * sn];
        sc += pc[k * sn];
      }
    }
    s_b[w][lane] = sb;
    s_c[w][lane] = sc;
    __syncthreads();
    if (w == 0 && i < nbs) {
      float tb = 0.f, tc = 0.f;
#pragma unroll
      for (int u = 0; u < SUM_W; ++u) {
        tb += s_b[u][lane];
        tc += s_c[u][lane];
      }
      dB[i] = tb;
      dC[i] = tc;
    }
  } else if (g < g_bc + g_t) {
    const long long j = (g - g_bc) * 32 + lane;
    double st = 0.0;
    if (j < nbt) {
      const long long b = j / S, r = j % S;
      const double* p = ddtp + b * nblk * S + r;
      for (int k = w; k < nblk; k += SUM_W) st += p[(long long)k * S];
    }
    s_t[w][lane] = st;
    __syncthreads();
    if (w == 0 && j < nbt) {
      double tt = 0.0;
#pragma unroll
      for (int u = 0; u < SUM_W; ++u) tt += s_t[u][lane];
      ddt[j] = (float)tt;
    }
  } else {
    const long long j = (g - g_bc - g_t) * SUM_THREADS + threadIdx.x;
    if (j < (long long)E * N) {
      double s = 0.0;
      for (int b = 0; b < B; ++b) s += dAp[(long long)b * E * N + j];
      dA[j] = (float)s;
    }
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

// Blocks of a backward call over E channels (the partials' second
// dimension).
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

// Forward blocks one SM holds, or minus a CUDA error; and its channels
// a block.
extern "C" int mamba_scan_fwd_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, mamba_scan_fwd_kernel, F_THREADS, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

extern "C" int mamba_scan_fwd_channels() { return F_CH; }

// x, y: [B, S, E]; dt: [B, S]; A: [E, 16]; Bm, Cm: [B, S, 16]; h0, hT:
// [B, E, 16]; states: [B, ceil(S / 16), E, 16] or null; all f32,
// contiguous; A, Bm, Cm, h0, hT and states 16-byte aligned.
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* A, const void* Bm,
                                 const void* Cm, const void* h0, void* y,
                                 void* hT, void* states, int B, int S, int E,
                                 void* stream) {
  if (B == 0 || E == 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {A, Bm, Cm, h0, hT};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (states != nullptr && !aligned16(states))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((E + F_CH - 1) / F_CH, B);
  mamba_scan_fwd_kernel<<<grid, F_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)h0, (float*)y, (float*)hT,
      (float*)states, S, E);
  return (int)cudaGetLastError();
}

// The backward: two launches, the scan then the sums.  dhT may be null
// (0).  Outputs dx [B, S, E], ddt [B, S], dA [E, 16], dB, dC [B, S, 16],
// dh0 [B, E, 16]; scratch dBp, dCp [B, nblk, S, 16] f32, ddtp [B, nblk,
// S] and dAp [B, E, 16] f64, nblk = mamba_scan_blocks(E).  A, Bm, Cm,
// states, dhT, dh0, dBp, dCp and dAp 16-byte aligned.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* states, const void* dy, const void* dhT,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0, void* dBp,
    void* dCp, void* ddtp, void* dAp, int B, int S, int E, int nblk,
    void* stream) {
  if (B == 0 || E == 0) return 0;
  if (S < 1 || nblk != (E + CH - 1) / CH) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {A, Bm, Cm, states, dAp, dh0, dBp, dCp};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (dhT != nullptr && !aligned16(dhT))
    return (int)cudaErrorMisalignedAddress;
  const int vecX = E % 4 == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dx);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  mamba_scan_bwd_kernel<<<dim3(nblk, B), THREADS, BWD_SMEM, s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)states, (const float*)dy,
      (const float*)dhT, (float*)dx, (float*)dBp, (float*)dCp,
      (double*)ddtp, (double*)dAp, (float*)dh0, S, E, vecX);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long groups = ((long long)B * S * N + 31) / 32 +
                            ((long long)B * S + 31) / 32 +
                            ((long long)E * N + SUM_THREADS - 1) / SUM_THREADS;
  mamba_scan_bwd_sum_kernel<<<(unsigned)groups, SUM_THREADS, 0, s>>>(
      (const float*)dBp, (const float*)dCp, (const double*)ddtp,
      (const double*)dAp, (float*)dB, (float*)dC, (float*)ddt, (float*)dA, B,
      S, E, nblk);
  return (int)cudaGetLastError();
}
