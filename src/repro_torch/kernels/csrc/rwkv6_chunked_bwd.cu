// The gradient of the chunked RWKV-6 time mix (rwkv6_chunked.cu): from
// dy and the gradient of the final state, dr, dk, dv, dw, du and the
// gradient of the initial state.  Per chunk, in the forward's log2
// arithmetic (L the prefix sum of log2(max(w, 1e-30)) over the chunk,
// Lprev_t = L_{t-1}, L_C the chunk's total, S the chunk's start state, dS
// the gradient of its end state, dP_ts = dy_t . v_s for s <= t):
//   dr_t = 2^Lprev_t (S dy_t) + sum_{s<t} dP_ts k_s 2^(Lprev_t - L_s)
//          + dP_tt u k_t
//   dk_s = sum_{t>s} dP_ts r_t 2^(Lprev_t - L_s) + dP_ss u r_s
//          + 2^(L_C - L_s) (dS v_s)
//   dv_s = sum_{t>=s} P_ts dy_t + (k_s 2^(L_C - L_s)) dS    (P_ss the bonus)
//   du  += sum_t dP_tt r_t k_t
//   dlog2(w_s) / ln 2 = sum_{t>=s} xl_t + sum_{t>s} xp_t + tot, with
//     xp_t = r_t (dr_t - dP_tt u k_t)  (on Lprev_t, so on every s < t),
//     xl_t = -k_t (dk_t - dP_tt u r_t)  (on L_t, so on every s <= t),
//     tot = 2^L_C (S . dS) + sum_s k_s 2^(L_C - L_s) (dS v_s)  (on L_C);
//   dw = dlog2(w) / (w ln 2), 0 where w < 1e-30 (the forward's clamp);
//   the start state's gradient dS <- diag(2^L_C) dS + (r 2^Lprev)^T dy.
// The chunks are walked in reverse, dS carried from one to the one
// before.  The division by w comes last: a 1/w taken early would turn a
// tiny w into inf.  Every decay raised is of an exponent <= 0 (the pairs
// s < t, the chunk's prefixes): the exponents of the pairs s >= t are
// positive and are never raised (they go in as -inf), so nothing
// overflows.
// r, k, v, w, dy: [B, S, H, 64] f32; u: [H, 64] f32; states: [B, H,
// S / C, 64, 64] f32, the forward kernel's chunk-start states; dsf: the
// final state's gradient [B, H, 64, 64] f32, or null for 0.  Outputs dr,
// dk, dv, dw: [B, S, H, 64] f32; dupart: [B, H, 64] f32, each (batch,
// head)'s share of du, which the wrapper sums over the batch in a fixed
// order; ds0: [B, H, 64, 64] f32.  No atomics: each output element is
// written by one thread of the one block that owns its (batch, head),
// every sum is taken in a fixed order, so the same inputs give the same
// bits.  C divides S and is at most 32; every pointer is 16-byte aligned.
//
// Replaces: no Pallas kernel.  The reference trains through XLA's
// autodiff of its plain chunked form (src/repro/models/ssm.py:129,
// rwkv6_chunked_jnp); on the card the forward is a ctypes launch, opaque
// to autograd, so its backward is written by hand.
//
// Bound on the H100: at RWKV-6-7B's training shape (r, k, v, w, dy [4,
// 2048, 64, 64] f32, chunk 16) a call reads five inputs (671 MB) and the
// states (537 MB) and writes four gradients (537 MB) and ds0: 1.749 GB,
// 0.522 ms at 3.35 TB/s, against 22.25 GFLOP (chip_smoke.py,
// rwkv_bwd_flops), 0.33 ms at the 67 TFLOP/s of f32 outside the tensor
// cores: bound by bytes.  TF32 tensor cores would round each operand at
// ~5e-4, above the 1e-4 this kernel is held to, so the products stay in
// f32 FMAs.
//
// Design: one block of 256 threads per (batch, head), walking the chunks
// in reverse; two blocks an SM at C <= 16 (110,912 B of shared memory a
// block, at most 128 registers, no spills), so RWKV-6-7B's 256 (batch,
// head) blocks are resident in one wave.  As in the forward, an f32
// kernel of this shape is bound on the SM by shared-memory operand
// traffic and the SFU, not by device memory.  The first, SIMT version
// formed every output as one thread's inner product over shared memory
// (two loads a FMA), loaded each chunk by plain loads behind a barrier,
// ran the decay scan, S . dS and the dw prefix sum on 64 of 256 threads,
// and raised each pairwise decay three times.  What this design does
// about each:
// - a ring of chunks: chunk ci - 1's r, k, v, w, dy rows are copied into
//   the ring's other stage with 16-byte cp.async while chunk ci computes,
//   and its start state into the one state buffer once chunk ci's last
//   readers of it are done (after the first phase: a second state buffer
//   would not fit at two blocks an SM); rows padded by 4 floats (LDR =
//   68), so they stay 16-byte aligned and a float4 walk of 8 lanes down 8
//   rows at one depth is free of bank conflicts;
// - decays formed once: a warp-shuffle scan of log2(w) down each column
//   (4 segments of C/4 tokens) on every warp, every decay one ex2.approx;
//   each pairwise decay 2^(Lprev_t - L_s) is raised once, in a register,
//   and used there for the score P_ts and for dr_t's and dk_s's
//   inter-token sums;
// - the pairwise terms on every warp: warp w owns channels 8w..8w+7, so
//   the walk of a channel (its decays, dr, dk, dw) stays in one warp; a
//   lane takes one channel and the tokens s = q, q + 4, .. of quarter q
//   against every row t, in groups of 4 rows: dk_s sums in the lane, dr_t
//   over the 4 quarters (3 shuffles a group leave row 4 g + q in lane q,
//   so a lane's dr, dk, xp and xl are of the same tokens) and P_ts over
//   the warp's 8 channels (a reduce-scatter of 7 shuffles a batch of 8
//   pairs) into one share a warp, which dv sums in a fixed order;
// - products register-tiled with float4 operands: dy [S ; V]^T (dr's
//   state term and dP) on warps 0-3 and v dS^T (dk's state term) on warps
//   4-7, 4 rows by 4 columns a pass (two passes for the 8 columns of S or
//   dS, which keeps the tile beside dS's registers), both operands
//   contiguous along the depth, the depth in quarters over lanes 8 apart,
//   reduced by shuffles; dv = [P^T | k 2^(L_C - L)] [dy ; dS], one
//   product of depth C + 64 with a depth-major A operand, 4 x 8 a thread
//   (32 FMA per 3 loads, the forward's tile), on warps 0-3, beside the
//   update of dS on warps 4-7, which keep dS in registers for the whole
//   walk, as the forward's state warps keep S;
// - dw and du on every warp: the reverse prefix sum over the chunk and
//   the chunk total's term by warp shuffles, the division by w ln 2 last;
// - four barriers a chunk: inputs in; the scan, the state products and
//   dP done; the pairwise terms done; dv done with the old dS, after which
//   the state warps store the new one (a single dS buffer, where a second
//   would not fit beside the ring at two blocks an SM).
// C that is not a multiple of 16 runs as the next multiple, CP: the
// padding rows hold r = k = v = dy = 0 and log2 w = 0, so they change
// nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head size
constexpr int LDR = HD + 4;     // row stride of the [row][64] tiles
constexpr int THREADS = 256;
constexpr int NIN = 5;          // ring inputs: r, k, v, w, dy
constexpr unsigned FULL = 0xffffffffu;
constexpr float LN2 = 0.6931471805599453f;

// shared-memory layout, in floats, for chunks padded to CP tokens
template <int CP>
struct Layout {
  static constexpr int TILE = CP * LDR;              // one [CP][LDR] tile
  static constexpr int LDT = CP + 4;                 // row stride of KDT
  static constexpr int LDP = CP + 1;                 // row stride of dP
  static constexpr int RING = 0;                     // [2][r, k, v, w, dy]
  static constexpr int S = RING + 2 * NIN * TILE;    // start state [64][LDR]
  static constexpr int DS = S + HD * LDR;            // its gradient
  static constexpr int L = DS + HD * LDR;            // log2 prefix [CP][LDR]
  static constexpr int RD = L + TILE;                // r * 2^Lprev
  static constexpr int XR = RD + TILE;               // dy S^T, then xp
  static constexpr int XK = XR + TILE;               // v dS^T
  static constexpr int KDT = XK + TILE;              // (k 2^(L_C-L))^T
  static constexpr int PW = KDT + HD * LDT;          // scores by warp
  static constexpr int DP = PW + 8 * CP * CP;        // dy v^T [CP][LDP]
  static constexpr int AC = DP + CP * LDP;           // 2^L_C [64]
  static constexpr int LC = AC + HD;                 // L_C [64]
  static constexpr int SDS = LC + HD;                // S . dS by row [64]
  static constexpr int TOTAL = SDS + HD;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 2^x in one SFU instruction; results below 2^-126 flush to 0, -inf to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// acc[ii][0..7] += a[ii] * (b0, b1): one depth step of a 4 x 8 tile
__device__ __forceinline__ void tile_fma(float (&acc)[4][8], const float4& a,
                                         const float4& b0,
                                         const float4& b1) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float x = comp(a, ii);
    acc[ii][0] += x * b0.x; acc[ii][1] += x * b0.y;
    acc[ii][2] += x * b0.z; acc[ii][3] += x * b0.w;
    acc[ii][4] += x * b1.x; acc[ii][5] += x * b1.y;
    acc[ii][6] += x * b1.z; acc[ii][7] += x * b1.w;
  }
}

// a 4-row tile summed over the depth quarters held by lanes 8 apart,
// scattered: the lane keeps row (lane >> 3) & 3 of it
template <int NC>
__device__ __forceinline__ void quarter_reduce(const float (&acc)[4][NC],
                                               int lane, float (&o)[NC]) {
  const bool b4 = lane & 16, b3 = lane & 8;
  float hf[2][NC];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int i = 0; i < NC; ++i)
      hf[ii][i] = (b4 ? acc[ii + 2][i] : acc[ii][i])
                  + __shfl_xor_sync(FULL, b4 ? acc[ii][i] : acc[ii + 2][i],
                                    16);
#pragma unroll
  for (int i = 0; i < NC; ++i)
    o[i] = (b3 ? hf[1][i] : hf[0][i])
           + __shfl_xor_sync(FULL, b3 ? hf[0][i] : hf[1][i], 8);
}

// A B^T for 4 rows of A (from a, stride LDR) against NC rows of B
// (brow(i), stride LDR), both contiguous along the depth 64: the lane
// sums its quarter of the depth, 4 x NC with float4 operands, then the
// quarters are reduced; the lane ends with row (lane >> 3) & 3
template <int NC, typename BRow>
__device__ __forceinline__ void nt_tile(const float* a, BRow brow, int lane,
                                        float (&o)[NC]) {
  const int d0 = (lane >> 3) * 16;
  float acc[4][NC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[ii][i] = 0.f;
#pragma unroll
  for (int dd = 0; dd < 16; dd += 4) {
    float4 x[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) x[ii] = ld4(a + ii * LDR + d0 + dd);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float4 y = ld4(brow(i) + d0 + dd);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        acc[ii][i] += x[ii].x * y.x; acc[ii][i] += x[ii].y * y.y;
        acc[ii][i] += x[ii].z * y.z; acc[ii][i] += x[ii].w * y.w;
      }
    }
  }
  quarter_reduce<NC>(acc, lane, o);
}

// 8 partial sums over the 8 lanes of a group (lane bits 0-2) reduced and
// scattered: lane l ends with sum l & 7
__device__ __forceinline__ float scatter8(const float (&p)[8], int lane) {
  const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
  float v4[4], v2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (b2 ? p[i + 4] : p[i])
            + __shfl_xor_sync(FULL, b2 ? p[i] : p[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (b1 ? v4[i + 2] : v4[i])
            + __shfl_xor_sync(FULL, b1 ? v4[i] : v4[i + 2], 2);
  return (b0 ? v2[1] : v2[0])
         + __shfl_xor_sync(FULL, b0 ? v2[0] : v2[1], 1);
}

template <int CP>
__global__ void __launch_bounds__(THREADS, CP <= 16 ? 2 : 1)
rwkv6_chunked_bwd_kernel(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ states,
                         const float* __restrict__ dy,
                         const float* __restrict__ dsf,
                         float* __restrict__ dr, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ dw,
                         float* __restrict__ dupart,
                         float* __restrict__ ds0, int S, int H, int C) {
  using Lay = Layout<CP>;
  constexpr int TILE = Lay::TILE, LDT = Lay::LDT, LDP = Lay::LDP;
  constexpr int NM = CP / 4;           // a lane's tokens s = 4 m + q
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long tok = (long long)H * HD;             // token stride
  const long long base = (long long)b * S * tok + (long long)h * HD;
  const int n = S / C;
  float* Ss = sm + Lay::S;
  float* DSs = sm + Lay::DS;
  float* Ls = sm + Lay::L;
  float* RDs = sm + Lay::RD;
  float* XR = sm + Lay::XR;
  float* XK = sm + Lay::XK;
  float* KDT = sm + Lay::KDT;
  float* PWs = sm + Lay::PW;
  float* DPs = sm + Lay::DP;
  float* ACs = sm + Lay::AC;
  float* LCs = sm + Lay::LC;
  float* SDSs = sm + Lay::SDS;

  // zero everything: the ring's padding rows stay 0
  for (int e = tid; e < Lay::TOTAL; e += THREADS) sm[e] = 0.f;
  __syncthreads();

  // copy chunk ci's r, k, v, w, dy rows into ring stage `stage`
  auto load_chunk = [&](int ci, int stage) {
    float* dst = sm + Lay::RING + stage * NIN * TILE;
    const long long off = base + (long long)ci * C * tok;
#pragma unroll
    for (int a = 0; a < NIN; ++a) {
      const float* src =
          (a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w : dy) + off;
      for (int e = tid; e < 16 * C; e += THREADS) {   // 4 values a piece
        const int t = e >> 4, q = (e & 15) * 4;
        cp_async16(dst + a * TILE + t * LDR + q, src + t * tok + q);
      }
    }
    cp_async_commit();
  };
  // copy chunk ci's start state into the state buffer
  auto load_state = [&](int ci) {
    const float* src = states + ((long long)bh * n + ci) * HD * HD;
    for (int e = tid; e < 16 * HD; e += THREADS) {
      const int row = e >> 4, q = (e & 15) * 4;
      cp_async16(Ss + row * LDR + q, src + row * HD + q);
    }
    cp_async_commit();
  };

  // product tiles: warps 0-3 multiply with dy (dr's state term, dP, dv),
  // warps 4-7 keep dS rows 4 rg.., columns j0.. and j1.. in registers
  const bool pwarp = warp < 4;
  const int cg = lane & 7, rg = (tid & 127) >> 3;
  const int j0 = 4 * cg, j1 = 32 + 4 * cg;
  // lane >> 3: a product lane's quarter of the depth; a channel lane's
  // quarter of the tokens
  const int q = lane >> 3;
  float st[4][8];
  if (!pwarp) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int c = 4 * rg + ii;
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      if (dsf != nullptr) {
        a0 = ld4(dsf + (long long)bh * HD * HD + c * HD + j0);
        a1 = ld4(dsf + (long long)bh * HD * HD + c * HD + j1);
      }
      st[ii][0] = a0.x; st[ii][1] = a0.y; st[ii][2] = a0.z; st[ii][3] = a0.w;
      st[ii][4] = a1.x; st[ii][5] = a1.y; st[ii][6] = a1.z; st[ii][7] = a1.w;
      st4(DSs + c * LDR + j0, a0.x, a0.y, a0.z, a0.w);
      st4(DSs + c * LDR + j1, a1.x, a1.y, a1.z, a1.w);
    }
  }

  // channel lanes (the scan, the pairwise terms, dr, dk, dw, du): warp w
  // owns channels 8w..8w+7; lane (q, c) takes quarter q of the tokens
  const int c = warp * 8 + (lane & 7);
  const float uc = u[h * HD + c];
  float dua = 0.f;

  load_chunk(n - 1, (n - 1) & 1);
  load_state(n - 1);
  for (int ci = n - 1; ci >= 0; --ci) {
    const int stage = ci & 1;
    cp_async_wait_all();
    __syncthreads();       // chunk ci is in; chunk ci + 1 is done with all
    if (ci > 0) load_chunk(ci - 1, stage ^ 1);
    const float* R = sm + Lay::RING + stage * NIN * TILE;
    const float* K = R + TILE;
    const float* V = K + TILE;
    const float* W = V + TILE;
    const float* DY = W + TILE;
    const long long off = base + (long long)ci * C * tok;

    // ---- decays: lane (q, c) scans tokens [q SEG, (q + 1) SEG) of
    //      column c
    {
      constexpr int SEG = CP / 4;
      float part[SEG], run = 0.f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = q * SEG + i;
        run += t < C ? log2f(fmaxf(W[t * LDR + c], 1e-30f)) : 0.f;
        part[i] = run;
      }
      float incl = run, o = __shfl_up_sync(FULL, incl, 8);
      if (q >= 1) incl += o;
      o = __shfl_up_sync(FULL, incl, 16);
      if (q >= 2) incl += o;
      float excl = __shfl_up_sync(FULL, incl, 8);
      if (q == 0) excl = 0.f;
      const float tot = __shfl_sync(FULL, incl, 24 + (lane & 7));
      float prev = excl;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = q * SEG + i, e = t * LDR + c;
        const float L = part[i] + excl;
        Ls[e] = L;
        RDs[e] = R[e] * ex2(prev);
        KDT[c * LDT + t] = K[e] * ex2(tot - L);
        prev = L;
      }
      if (q == 0) {
        ACs[c] = ex2(tot);
        LCs[c] = tot;
      }
    }

    // ---- products of depth 64: warps 0-3 dy S^T (dr's state term, before
    //      its decay) and dP = dy V^T; warps 4-7 v dS^T (dk's) and S . dS
    //      (the 8 columns of a lane in two passes of 4, which keeps the
    //      tile's registers beside dS's)
    if (pwarp) {
      constexpr int NV = CP / 8;
      for (int rgy = warp; rgy < CP / 4; rgy += 4) {
        const int t = 4 * rgy + q;
#pragma unroll
        for (int half = 0; half < 8; half += 4) {
          float o[4];
          nt_tile<4>(DY + 4 * rgy * LDR,
                     [&](int i) { return Ss + (cg + 8 * (half + i)) * LDR; },
                     lane, o);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            XR[t * LDR + cg + 8 * (half + i)] = o[i];
        }
        float p[NV];
        nt_tile<NV>(DY + 4 * rgy * LDR,
                    [&](int i) { return V + (cg + 8 * i) * LDR; }, lane, p);
#pragma unroll
        for (int i = 0; i < NV; ++i) DPs[t * LDP + cg + 8 * i] = p[i];
      }
    } else {
      for (int rgy = warp - 4; rgy < CP / 4; rgy += 4) {
        const int s = 4 * rgy + q;
#pragma unroll
        for (int half = 0; half < 8; half += 4) {
          float o[4];
          nt_tile<4>(V + 4 * rgy * LDR,
                     [&](int i) { return DSs + (cg + 8 * (half + i)) * LDR; },
                     lane, o);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            XK[s * LDR + cg + 8 * (half + i)] = o[i];
        }
      }
      // S . dS of row (tid & 127) >> 1, in two halves of 32
      const int row = (tid & 127) >> 1, d0 = (tid & 1) * 32;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < 32; d += 4) {
        const float4 x = ld4(Ss + row * LDR + d0 + d);
        const float4 y = ld4(DSs + row * LDR + d0 + d);
        a += x.x * y.x; a += x.y * y.y; a += x.z * y.z; a += x.w * y.w;
      }
      a += __shfl_xor_sync(FULL, a, 1);
      if (!(tid & 1)) SDSs[row] = a;
    }
    __syncthreads();       // decays, state products and dP are in
    if (ci > 0) load_state(ci - 1);    // the start state's readers are done

    // ---- pairwise terms: lane (q, c) against every row t, its tokens
    //      s = 4 m + q; each decay raised once for P_ts, dr_t and dk_s.
    //      Rows go in groups of 4; after group g the lane holds dr_t of
    //      its row t = 4 g + q, so dr, dk, xp and xl of a lane are of the
    //      same tokens 4 i + q
    {
      constexpr int RB = 8 / NM;        // rows a batch of 8 scores
      const bool b4 = lane & 16, b3 = lane & 8;
      float kk[NM], ll[NM], dka[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int e = (4 * m + q) * LDR + c;
        kk[m] = K[e];
        ll[m] = Ls[e];
        dka[m] = 0.f;
      }
#pragma unroll 1
      for (int g = 0; g < NM; ++g) {
        float acc[4], pp[8];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const int t = 4 * g + hh;
          const float rt = R[t * LDR + c];
          const float lp = t > 0 ? Ls[(t - 1) * LDR + c] : 0.f;
          float a = 0.f;
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            float p = 0.f;
            if (m <= g) {                // else s > t for every lane
              const int s = 4 * m + q;
              const float d = ex2(s < t ? lp - ll[m] : -INFINITY);
              const float kd = kk[m] * d;
              const float dp = DPs[t * LDP + s];
              p = s == t ? rt * uc * kk[m] : rt * kd;
              a += dp * kd;
              dka[m] += (dp * rt) * d;
            }
            pp[(hh % RB) * NM + m] = p;
          }
          acc[hh] = a;
          if (hh % RB == RB - 1) {
            // this warp's share of the scores (its 8 channels): lane l
            // ends with pair l & 7 of the batch
            const float x = scatter8(pp, lane);
            const int e = lane & 7;
            PWs[(warp * CP + t - (RB - 1) + e / NM) * CP + 4 * (e % NM) + q] =
                x;
          }
        }
        // dr's inter-token sums over the 4 quarters: lane q keeps row
        // 4 g + q; then dr, and xp in place of dy S^T
        const float h0 = (b4 ? acc[2] : acc[0])
                         + __shfl_xor_sync(FULL, b4 ? acc[0] : acc[2], 16);
        const float h1 = (b4 ? acc[3] : acc[1])
                         + __shfl_xor_sync(FULL, b4 ? acc[1] : acc[3], 16);
        const float intra = (b3 ? h1 : h0)
                            + __shfl_xor_sync(FULL, b3 ? h0 : h1, 8);
        const int t = 4 * g + q, e = t * LDR + c;
        const float lp = t > 0 ? Ls[e - LDR] : 0.f;
        const float inter = ex2(lp) * XR[e];
        const float rt = R[e], kt = K[e], dpd = DPs[t * LDP + t];
        if (t < C) dr[off + t * tok + c] = inter + intra + dpd * uc * kt;
        XR[e] = rt * (inter + intra);
        dua += dpd * rt * kt;
      }

      // dk and xl of tokens 4 m + q
      const float lc = LCs[c];
      float xpv[NM], xlv[NM], ksum = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int s = 4 * m + q, e = s * LDR + c;
        const float ks = ex2(lc - ll[m]) * XK[e];
        if (s < C)
          dk[off + s * tok + c] = dka[m] + DPs[s * LDP + s] * uc * R[e] + ks;
        xlv[m] = -kk[m] * (dka[m] + ks);
        xpv[m] = XR[e];
        ksum += kk[m] * ks;
      }
      ksum += __shfl_xor_sync(FULL, ksum, 8);
      ksum += __shfl_xor_sync(FULL, ksum, 16);
      const float tot = ACs[c] * SDSs[c] + ksum;

      // dw: the reverse prefix sum of xl + xp down column c, 4 rows at a
      // time (row 4 i + q in quarter q), the groups after it summed
      float after = 0.f;
#pragma unroll
      for (int i = NM - 1; i >= 0; --i) {
        float run = xlv[i] + xpv[i], o = __shfl_down_sync(FULL, run, 8);
        if (q <= 2) run += o;
        o = __shfl_down_sync(FULL, run, 16);
        if (q <= 1) run += o;
        const float grp = __shfl_sync(FULL, run, lane & 7);
        run += after;
        after += grp;
        const int t = 4 * i + q;
        const float g2 = (run - xpv[i] + tot) * LN2;  // d / d log2(w_t)
        const float wt = W[t * LDR + c];
        if (t < C)
          dw[off + t * tok + c] = wt >= 1e-30f ? g2 / (wt * LN2) : 0.f;
      }
    }
    __syncthreads();       // the scores are in

    if (pwarp) {
      // ---- dv = [P^T | k 2^(L_C - L)] [dy ; dS]: rows 4 rgy.. by
      //      columns j0.. and j1..; quarter q of the depth takes score
      //      rows q, q + 4, .. (each summed over the 8 warps' shares)
      //      and channels 16 q ..
      for (int rgy = warp; rgy < CP / 4; rgy += 4) {
        float acc[4][8];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[ii][j] = 0.f;
        // (unrolled no further: at two blocks an SM the 8 shares' loads
        // would not fit in 128 registers beside the tile and dS)
#pragma unroll 1
        for (int i = 0; i < NM; ++i) {
          const int t = q + 4 * i;
          float4 a = ld4(PWs + t * CP + 4 * rgy);
#pragma unroll 2
          for (int wp = 1; wp < 8; ++wp) {
            const float4 x = ld4(PWs + (wp * CP + t) * CP + 4 * rgy);
            a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
          }
          tile_fma(acc, a, ld4(DY + t * LDR + j0), ld4(DY + t * LDR + j1));
        }
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int cc = 16 * q + i;
          tile_fma(acc, ld4(KDT + cc * LDT + 4 * rgy),
                   ld4(DSs + cc * LDR + j0), ld4(DSs + cc * LDR + j1));
        }
        float o[8];
        quarter_reduce<8>(acc, lane, o);
        const int s = 4 * rgy + q;
        if (s < C) {
          float* vp = dv + off + s * tok;
          st4(vp + j0, o[0], o[1], o[2], o[3]);
          st4(vp + j1, o[4], o[5], o[6], o[7]);
        }
      }
    } else {
      // ---- dS rows 4 rg.., columns j0.. and j1..: diag(2^L_C) dS +
      //      (r 2^Lprev)^T dy, in registers
      const float4 ac = ld4(ACs + 4 * rg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[ii][j] *= comp(ac, ii);
#pragma unroll 4
      for (int t = 0; t < CP; ++t)
        tile_fma(st, ld4(RDs + t * LDR + 4 * rg), ld4(DY + t * LDR + j0),
                 ld4(DY + t * LDR + j1));
    }
    __syncthreads();       // dv is done with the old dS
    if (!pwarp) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float* sp = DSs + (4 * rg + ii) * LDR;
        st4(sp + j0, st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
        st4(sp + j1, st[ii][4], st[ii][5], st[ii][6], st[ii][7]);
      }
    }
  }
  if (!pwarp) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float* sp = ds0 + (long long)bh * HD * HD + (4 * rg + ii) * HD;
      st4(sp + j0, st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
      st4(sp + j1, st[ii][4], st[ii][5], st[ii][6], st[ii][7]);
    }
  }
  dua += __shfl_xor_sync(FULL, dua, 8);
  dua += __shfl_xor_sync(FULL, dua, 16);
  if (q == 0) dupart[(long long)bh * HD + c] = dua;
}

template <int CP>
cudaError_t set_smem() {
  const auto fn = rwkv6_chunked_bwd_kernel<CP>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<CP>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int CP>
int launch_cp(const float* r, const float* k, const float* v, const float* w,
              const float* u, const float* states, const float* dy,
              const float* dsf, float* dr, float* dk, float* dv, float* dw,
              float* dupart, float* ds0, int B, int S, int H, int C,
              cudaStream_t stream) {
  const cudaError_t err = set_smem<CP>();
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked_bwd_kernel<CP><<<B * H, THREADS, Layout<CP>::BYTES,
                                 stream>>>(
      r, k, v, w, u, states, dy, dsf, dr, dk, dv, dw, dupart, ds0, S, H, C);
  return (int)cudaGetLastError();
}

template <int CP>
int blocks_cp() {
  const cudaError_t err = set_smem<CP>();
  if (err != cudaSuccess) return -(int)err;
  int nb = 0;
  const cudaError_t e2 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, rwkv6_chunked_bwd_kernel<CP>, THREADS, Layout<CP>::BYTES);
  return e2 == cudaSuccess ? nb : -(int)e2;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Dynamic shared memory of one block at chunk C, in bytes.
extern "C" int rwkv6_chunked_bwd_smem_bytes(int C) {
  return C <= 16 ? (int)Layout<16>::BYTES : (int)Layout<32>::BYTES;
}

// Blocks of the kernel one SM holds at chunk C (the occupancy
// calculator, with the kernel's registers and shared memory), or minus a
// CUDA error.
extern "C" int rwkv6_chunked_bwd_blocks_per_sm(int C) {
  return C <= 16 ? blocks_cp<16>() : blocks_cp<32>();
}

extern "C" int rwkv6_chunked_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* states, const void* dy, const void* dsf,
    void* dr, void* dk, void* dv, void* dw, void* dupart, void* ds0, int B,
    int S, int H, int C, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (C < 1 || C > 32 || S % C != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {r, k, v, w, u, states, dy, dr, dk, dv, dw, dupart,
                        ds0};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (dsf != nullptr && !aligned16(dsf))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const auto fn = C <= 16 ? launch_cp<16> : launch_cp<32>;
  return fn((const float*)r, (const float*)k, (const float*)v,
            (const float*)w, (const float*)u, (const float*)states,
            (const float*)dy, (const float*)dsf, (float*)dr, (float*)dk,
            (float*)dv, (float*)dw, (float*)dupart, (float*)ds0, B, S, H, C,
            s);
}
