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
// The chunks are walked in reverse, dS carried in shared memory from one
// to the one before.  The division by w comes last: a 1/w taken early
// would turn a tiny w into inf.  Every decay raised is of an exponent
// <= 0 (the pairs s < t, the chunk's prefixes): the exponents of the
// pairs s >= t are positive and are never raised, so nothing overflows.
// r, k, v, w, dy: [B, S, H, 64] f32; u: [H, 64] f32; states: [B, H,
// S / C, 64, 64] f32, the forward kernel's chunk-start states; dsf: the
// final state's gradient [B, H, 64, 64] f32, or null for 0.  Outputs dr,
// dk, dv, dw: [B, S, H, 64] f32; dupart: [B, H, 64] f32, each (batch,
// head)'s share of du, which the wrapper sums over the batch in a fixed
// order; ds0: [B, H, 64, 64] f32.  No atomics: each output element is
// written by one thread of the one block that owns its (batch, head), so
// the same inputs give the same bits.  C divides S and is at most 32.
//
// Replaces: no Pallas kernel.  The reference trains through XLA's
// autodiff of its plain chunked form (src/repro/models/ssm.py:129,
// rwkv6_chunked_jnp); on the card the forward is a ctypes launch, opaque
// to autograd, so its backward is written by hand.
//
// Bound on the H100: at RWKV-6-7B's training shape (r, k, v, w, dy [4,
// 2048, 64, 64] f32, chunk 16) a call reads five inputs and the states
// (537 MB) and writes four gradients: about 1.2 GB, ~0.36 ms at 3.35
// TB/s, against ~13 GFLOP, ~0.2 ms at the 67 TFLOP/s of f32 outside the
// tensor cores: bound by bytes.
//
// Design (first version, SIMT, correctness first): one block of 256
// threads per (batch, head).  A chunk's r, k, v, w, dy and its start
// state are loaded into shared memory (rows padded to 65 floats, so row
// and column walks are both free of bank conflicts); one thread a channel
// scans the log2 decays and forms r 2^Lprev and k 2^(L_C - L); then, a
// barrier between each, the scores and dP (a thread a pair), dr, dk and dv
// (a thread an element), and the log-decay gradient (a thread a channel,
// a reverse prefix sum) beside the update of dS (a thread four
// elements).  Each output element is one thread's inner product over
// shared memory: no register tiling, no tensor cores yet.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head size
constexpr int LD = HD + 1;      // row stride of every shared tile
constexpr int THREADS = 256;
constexpr float LN2 = 0.6931471805599453f;

// shared-memory layout, in floats, for chunks padded to CP tokens
template <int CP>
struct Layout {
  static constexpr int TILE = CP * LD;               // one [CP][LD] tile
  static constexpr int LDP = CP + 1;                 // row stride of P, dP
  // [token][channel] tiles: inputs, decays and per-position terms
  static constexpr int R = 0, K = R + TILE, V = K + TILE, W = V + TILE,
                       DY = W + TILE, L = DY + TILE, LP = L + TILE,
                       RD = LP + TILE,               // r * 2^Lprev
                       KD = RD + TILE,               // k * 2^(L_C - L)
                       XP = KD + TILE, XL = XP + TILE,
                       KS = XL + TILE;               // k 2^(L_C-L) (dS v)
  static constexpr int S = KS + TILE;                // start state [64][LD]
  static constexpr int DS = S + HD * LD;             // its gradient [64][LD]
  static constexpr int P = DS + HD * LD;             // scores [CP][LDP]
  static constexpr int DP = P + CP * LDP;            // dP [CP][LDP]
  static constexpr int AC = DP + CP * LDP;           // 2^L_C [64]
  static constexpr int SDS = AC + HD;                // S . dS by row [64]
  static constexpr int U = SDS + HD;                 // u [64]
  static constexpr int TOTAL = U + HD;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

// 2^x in one SFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int CP>
__global__ void __launch_bounds__(THREADS)
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
  extern __shared__ float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const long long tok = (long long)H * HD;             // token stride
  const long long base = (long long)b * S * tok + (long long)h * HD;
  const int n = S / C;
  float* sR = sm + Lay::R;
  float* sK = sm + Lay::K;
  float* sV = sm + Lay::V;
  float* sW = sm + Lay::W;
  float* sDY = sm + Lay::DY;
  float* sL = sm + Lay::L;
  float* sLP = sm + Lay::LP;
  float* sRD = sm + Lay::RD;
  float* sKD = sm + Lay::KD;
  float* sXP = sm + Lay::XP;
  float* sXL = sm + Lay::XL;
  float* sKS = sm + Lay::KS;
  float* sS = sm + Lay::S;
  float* sDS = sm + Lay::DS;
  float* sP = sm + Lay::P;
  float* sDP = sm + Lay::DP;
  float* sAC = sm + Lay::AC;
  float* sSDS = sm + Lay::SDS;
  float* sU = sm + Lay::U;

  // zero everything (padding rows and the pairs s > t stay 0), then the
  // final state's gradient and u
  for (int e = tid; e < Lay::TOTAL; e += THREADS) sm[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < HD * HD; e += THREADS)
    sDS[(e >> 6) * LD + (e & 63)] =
        dsf != nullptr ? dsf[(long long)bh * HD * HD + e] : 0.f;
  if (tid < HD) sU[tid] = u[h * HD + tid];
  float du_acc = 0.f;                                  // channel tid < 64

  for (int ci = n - 1; ci >= 0; --ci) {
    __syncthreads();             // the chunk after is done with the tiles
    const long long off = base + (long long)ci * C * tok;
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e >> 6, c = e & 63, i = t * LD + c;
      const long long g = off + t * tok + c;
      sR[i] = r[g];
      sK[i] = k[g];
      sV[i] = v[g];
      sW[i] = w[g];
      sDY[i] = dy[g];
    }
    const float* st = states + ((long long)bh * n + ci) * HD * HD;
    for (int e = tid; e < HD * HD; e += THREADS)
      sS[(e >> 6) * LD + (e & 63)] = st[e];
    __syncthreads();

    // ---- decays: thread c scans column c
    if (tid < HD) {
      const int c = tid;
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const int i = t * LD + c;
        sLP[i] = run;
        sRD[i] = sR[i] * ex2(run);
        run += log2f(fmaxf(sW[i], 1e-30f));
        sL[i] = run;
      }
      sAC[c] = ex2(run);
      for (int t = 0; t < C; ++t) {
        const int i = t * LD + c;
        sKD[i] = sK[i] * ex2(run - sL[i]);
      }
    }
    __syncthreads();

    // ---- scores P (s < t; the bonus on the diagonal) and dP (s <= t), a
    //      thread a pair; S . dS, a thread a row
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      if (s > t) continue;
      float dp = 0.f, p = 0.f;
      for (int j = 0; j < HD; ++j) dp += sDY[t * LD + j] * sV[s * LD + j];
      if (s < t) {
        for (int c = 0; c < HD; ++c)
          p += sR[t * LD + c] * sK[s * LD + c] *
               ex2(sLP[t * LD + c] - sL[s * LD + c]);
      } else {
        for (int c = 0; c < HD; ++c)
          p += sR[t * LD + c] * sU[c] * sK[t * LD + c];
      }
      sP[t * Lay::LDP + s] = p;
      sDP[t * Lay::LDP + s] = dp;
    }
    if (tid < HD) {
      float a = 0.f;
      for (int j = 0; j < HD; ++j) a += sS[tid * LD + j] * sDS[tid * LD + j];
      sSDS[tid] = a;
    }
    __syncthreads();

    // ---- dr (t, c), dk (s, c) and dv (s, j), a thread an element
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e >> 6, c = e & 63, i = t * LD + c;
      const float lp = sLP[i];
      float inter = 0.f, intra = 0.f;
      for (int j = 0; j < HD; ++j) inter += sDY[t * LD + j] * sS[c * LD + j];
      inter *= ex2(lp);
      for (int s = 0; s < t; ++s)
        intra += sDP[t * Lay::LDP + s] * sK[s * LD + c] *
                 ex2(lp - sL[s * LD + c]);
      const float dpd = sDP[t * Lay::LDP + t];
      dr[off + t * tok + c] = inter + intra + dpd * sU[c] * sK[i];
      sXP[i] = sR[i] * (inter + intra);
    }
    for (int e = tid; e < C * HD; e += THREADS) {
      const int s = e >> 6, c = e & 63, i = s * LD + c;
      const float ls = sL[i];
      float intra = 0.f, ks = 0.f;
      for (int t = s + 1; t < C; ++t)
        intra += sDP[t * Lay::LDP + s] * sR[t * LD + c] *
                 ex2(sLP[t * LD + c] - ls);
      for (int j = 0; j < HD; ++j) ks += sV[s * LD + j] * sDS[c * LD + j];
      ks *= ex2(sL[(C - 1) * LD + c] - ls);
      const float dpd = sDP[s * Lay::LDP + s];
      dk[off + s * tok + c] = intra + dpd * sU[c] * sR[i] + ks;
      sXL[i] = -sK[i] * (intra + ks);
      sKS[i] = sK[i] * ks;
    }
    for (int e = tid; e < C * HD; e += THREADS) {
      const int s = e >> 6, j = e & 63;
      float acc = 0.f;
      for (int t = s; t < C; ++t) acc += sP[t * Lay::LDP + s] * sDY[t * LD + j];
      for (int c = 0; c < HD; ++c) acc += sKD[s * LD + c] * sDS[c * LD + j];
      dv[off + s * tok + j] = acc;
    }
    __syncthreads();

    // ---- the log-decay gradient and du, a thread a channel; the start
    //      state's gradient, four elements a thread
    if (tid < HD) {
      const int c = tid;
      float tot = sAC[c] * sSDS[c];
      for (int s = 0; s < C; ++s) tot += sKS[s * LD + c];
      float run = 0.f;
      for (int t = C - 1; t >= 0; --t) {
        const int i = t * LD + c;
        const float xp = sXP[i];
        run += sXL[i] + xp;
        const float g2 = (run - xp + tot) * LN2;        // d / d log2(w_t)
        const float wt = sW[i];
        dw[off + t * tok + c] = wt >= 1e-30f ? g2 / (wt * LN2) : 0.f;
        du_acc += sDP[t * Lay::LDP + t] * sR[i] * sK[i];
      }
    }
    for (int e = tid; e < HD * HD; e += THREADS) {
      const int c = e >> 6, j = e & 63, i = c * LD + j;
      float acc = sAC[c] * sDS[i];
      for (int t = 0; t < C; ++t) acc += sRD[t * LD + c] * sDY[t * LD + j];
      sDS[i] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * HD; e += THREADS)
    ds0[(long long)bh * HD * HD + e] = sDS[(e >> 6) * LD + (e & 63)];
  if (tid < HD) dupart[(long long)bh * HD + tid] = du_acc;
}

template <int CP>
int launch_cp(const float* r, const float* k, const float* v, const float* w,
              const float* u, const float* states, const float* dy,
              const float* dsf, float* dr, float* dk, float* dv, float* dw,
              float* dupart, float* ds0, int B, int S, int H, int C,
              cudaStream_t stream) {
  const size_t bytes = Layout<CP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked_bwd_kernel<CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked_bwd_kernel<CP><<<B * H, THREADS, bytes, stream>>>(
      r, k, v, w, u, states, dy, dsf, dr, dk, dv, dw, dupart, ds0, S, H, C);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Dynamic shared memory of one block at chunk C, in bytes.
extern "C" int rwkv6_chunked_bwd_smem_bytes(int C) {
  return C <= 16 ? (int)Layout<16>::BYTES : (int)Layout<32>::BYTES;
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
