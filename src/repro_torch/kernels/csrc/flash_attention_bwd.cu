// FlashAttention-2 backward for Hopper: the gradient of flash_attention.cu's
// function (causal, window, softcap, GQA/MQA, hd 64 / 128 / 256, ragged last
// tiles) for float32 or bfloat16 tensors, accumulated in float32.
//
// Replaces: the gradient the JAX package takes of its XLA attention
// (src/repro/models/attention.py:52, through jax.grad); none of its Pallas
// kernels has a VJP.  With s the logits after scale and softcap, P =
// exp(s - lse) (lse from the forward's LSE route, natural log), dO the
// output gradient and D = rowsum(dO * O):
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D) * (1 - tanh^2) * scale
//   (the tanh factor only with a softcap);  dQ = dS K;  dK = dS^T Q.
// A group's query heads sum into their kv head.
//
// Bound on the H100: operations.  At qwen2's train shape (B 4, S 2048, 12:2
// heads, hd 128) the backward is 2.5x the forward's 5.2e10 FLOP (the
// bound's count: S, dP, dV, dK, dQ, with S shared); the kernels take S and
// dP twice (once for dK / dV, once for dQ) and dV, dK and dQ twice (P and
// dS hi + lo, below): 10 products of the bound's 5.
//
// bfloat16 (`tc` below), on the tensor cores: mma.sync m16n8k16, bf16
// operands from ldmatrix, float32 accumulation.  A pre-pass writes D (one
// warp per row); then
// - dK / dV: one CTA per (query head, batch row, key tile), heavy key tiles
//   first.  It holds the tile's K and V and streams the query tiles that
//   can see it, in order, through two cp.async stages (Q, dO, lse, D).  Per
//   tile, phase 1: S^T = K Q^T and dP^T = V dO^T (rows keys, columns
//   queries), then P^T and dS^T; phase 2: dV += P^T dO and dK += dS^T Q.
//   The head's float32 dK and dV go to a partial (B, Hq, Sk, hd) each, and
//   a reduce launch sums a kv head's G partials in head order g = 0 .. G-1
//   and casts them once (G = 1: the CTA writes dk and dv itself).
// - dQ: one CTA per (query head, batch row, query tile), heavy tiles first:
//   Q, dO, lse and D held, the key tiles the forward visits streamed
//   through two stages, S and dP recomputed, dQ += dS K, dq written once.
// Every sum has one owner and a fixed order, whatever the SM count, the
// batch or the order the CTAs run in: no atomics, so a launch gives the
// same bits each time and a batch row the same bits alone as in a batch.
//
// The split: S and dP have bf16 operands (the inputs), so they are exact
// products.  P and dS are float32 in registers; as the A operand of dV, dK
// and dQ each is split into hi = bf16(x) and lo = bf16(x - hi) and taken
// twice (~16 significant bits), as the forward takes P V.  One bf16
// rounding of either (~2^-9) misses the bar of one bf16 rounding from the
// plain version (atol 1e-3 + rtol 1e-2 in chip_smoke.py) by 1.5-9x: a
// gradient is a sum of terms that can cancel to near 0
// (tests/test_torch_flash_bwd_tiles.py mirrors the arithmetic and shows
// it).  P^T and dS^T (dS for dQ) reach phase 2 through shared memory as
// hi and lo tiles, since phase 2 splits the warps by dims, not by columns.
//
// Tiles: streamed tiles of C = 64 rows; a CTA holds R = 64 rows (keys for
// dK / dV, 32 at hd 256; queries for dQ).  8 warps: phase 1 gives each a
// 16 x (C / WC) block of the R x C scores (WR = R / 16 warps down, WC = 8 /
// WR across); phase 2 a 16 x (hd / WC) block of the accumulators.  Tiles
// are bf16 rows whose 16-byte chunks are XOR-swizzled by the row's low 3
// bits, read by ldmatrix (.trans for the B operand of phase 2) without
// bank conflicts.  Budget (shared memory; float32 accumulators a thread;
// registers from ptxas, chip_smoke.py's [build] lines; CTAs an SM):
//   dK / dV  81 / 129 / 177 KB at hd 64 / 128 / 256 (R 32 at 256); dK and
//            dV 32 / 64 / 64, S and dP 32 / 32 / 16; 155 / 182 / 166
//            registers; one CTA an SM.
//   dQ       64.5 / 112.5 / 208.5 KB; dQ 16 / 32 / 64, S and dP 32; two
//            CTAs an SM at hd <= 128 (registers capped at 128: 123 / 128,
//            no spills; 26% faster than one on an H100 at the train
//            shape), one at hd 256 (183 registers).
// Two dK / dV CTAs an SM (R 32 at hd 128: 97 KB, 124 registers) measured
// no faster on an H100 than one at R 64.
//
// float32 (`fma` below): the FMA units, since tensor cores on float32 mean
// TF32 (~3 decimal digits) and the float32 route is held to 1e-4 and to the
// CPU step.  One CTA per (key tile, kv head, batch row) for dK / dV, walking
// the group's query heads and the query tiles that see the tile in that
// order; one per (query tile, query head, batch row) for dQ.  Tiles of 64
// (32 at hd 256) as float32 rows padded to HD + 1.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 256;

// D[b, h, r] = sum over d of dO * O, one warp per (b, r, h) row of the
// (B, Sq, Hq, HD) tensors.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ D, int rows, int Sq, int Hq) {
  constexpr int N = Vec<T>::N, NV = HD / N;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long base = static_cast<long long>(row) * HD;
  float acc = 0.f;
  for (int c = lane; c < NV; c += 32) {
    float o[N], g[N];
    load_vec(out + base + c * N, o);
    load_vec(dout + base + c * N, g);
#pragma unroll
    for (int i = 0; i < N; ++i) acc = fmaf(o[i], g[i], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % Hq, r = (row / Hq) % Sq, b = row / (Hq * Sq);
    D[(static_cast<long long>(b) * Hq + h) * Sq + r] = acc;
  }
}

namespace fma {

template <int HD>
struct Geo {
  static constexpr int BQ = HD == 256 ? 32 : 64;   // query rows per tile
  static constexpr int BK = BQ;                    // keys per tile
  static constexpr int RS = HD + 1;                // staged row stride
  static constexpr int PS = BK + 1;                // score tile row stride
  static constexpr int SR = BQ / 16, SC = BK / 16; // score entries per thread
  static constexpr int AD = HD / 16;               // accumulator dims per thread
  // Ks, Vs [BK][RS]; Qs, dOs [BQ][RS]; Ps, dSs [BQ][PS]; lse, D [BQ]
  static constexpr int floats = 2 * BK * RS + 2 * BQ * RS + 2 * BQ * PS + 2 * BQ;
  static constexpr int bytes = floats * 4;
  static_assert(bytes <= 232448, "shared memory of one CTA");
};

// Rows r0 .. r0 + R - 1 of one head of a (rows, heads, HD) tensor (row
// stride `rs` elements) into float32 rows of stride HD + 1; rows at or past
// `limit` are zeros.
template <typename T, int HD, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int r0, int limit) {
  constexpr int N = Vec<T>::N, CPR = HD / N;
  for (int idx = threadIdx.x; idx < R * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    float e[N];
    if (r0 + r < limit) {
      load_vec(src + static_cast<long long>(r0 + r) * rs + c * N, e);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[r * (HD + 1) + c * N + i] = e[i];
  }
}

// The shared-memory tiles of either kernel.
template <int HD>
struct Smem {
  using G = Geo<HD>;
  float *Ks, *Vs, *Qs, *dOs, *Ps, *dSs, *lse, *D;
  __device__ __forceinline__ explicit Smem(float* base)
      : Ks(base), Vs(base + G::BK * G::RS), Qs(base + 2 * G::BK * G::RS),
        dOs(Qs + G::BQ * G::RS), Ps(dOs + G::BQ * G::RS),
        dSs(Ps + G::BQ * G::PS), lse(dSs + G::BQ * G::PS), D(lse + G::BQ) {}
};

// The query tile's rows of lse and D (+inf and 0 past Sq: P is 0 there).
template <int HD>
__device__ __forceinline__ void stage_rows(const Smem<HD>& sm,
                                           const float* lse, const float* D,
                                           int q0, int Sq) {
  for (int r = threadIdx.x; r < Geo<HD>::BQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    sm.lse[r] = in ? lse[q0 + r] : INFINITY;
    sm.D[r] = in ? D[q0 + r] : 0.f;
  }
}

// For staged Q, dO (rows q0 ..) and K, V (keys k0 ..): P and dS (scale and
// the softcap's derivative included) of every (row, key) into Ps and dSs;
// 0 where the key is not visible to the row.
template <int HD>
__device__ __forceinline__ void scores(const Smem<HD>& sm, int q0, int k0,
                                       int Sq, int Sk, int causal, int window,
                                       float softcap, float scale) {
  using G = Geo<HD>;
  constexpr int SR = G::SR, SC = G::SC, RS = G::RS;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[SR][SC], dp[SR][SC];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float q[SR], o[SR], k[SC], v[SC];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      q[i] = sm.Qs[(tr + 16 * i) * RS + d];
      o[i] = sm.dOs[(tr + 16 * i) * RS + d];
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      k[j] = sm.Ks[(tc + 16 * j) * RS + d];
      v[j] = sm.Vs[(tc + 16 * j) * RS + d];
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = fmaf(q[i], k[j], s[i][j]);
        dp[i][j] = fmaf(o[i], v[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int rl = tr + 16 * i, r = q0 + rl;
    const float lse = sm.lse[rl], D = sm.D[rl];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int cl = tc + 16 * j, c = k0 + cl;
      const bool vis = r < Sq && c < Sk && (!causal || c <= r) &&
                       (window == 0 || c > r - window);
      float x = s[i][j] * scale, dx = scale;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dx = scale * (1.f - t * t);
      }
      const float p = vis ? expf(x - lse) : 0.f;
      sm.Ps[rl * G::PS + cl] = p;
      sm.dSs[rl * G::PS + cl] = p * (dp[i][j] - D) * dx;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
            int KH, int causal, int window, float softcap, float scale) {
  using Gm = Geo<HD>;
  constexpr int BQ = Gm::BQ, BK = Gm::BK, RS = Gm::RS, PS = Gm::PS;
  constexpr int KR = BK / 16, AD = Gm::AD;
  extern __shared__ float4 smem4[];
  const Smem<HD> sm(reinterpret_cast<float*>(smem4));
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / KH;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  const long long kv_rs = static_cast<long long>(KH) * HD;
  const long long q_rs = static_cast<long long>(Hq) * HD;
  stage<T, HD, BK>(sm.Ks, k + (static_cast<long long>(b) * Sk * KH + kh) * HD,
                   kv_rs, k0, Sk);
  stage<T, HD, BK>(sm.Vs, v + (static_cast<long long>(b) * Sk * KH + kh) * HD,
                   kv_rs, k0, Sk);

  float adk[KR][AD], adv[KR][AD];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < AD; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the query rows that can see a key of this tile: from the tile's first
  // key (causal) to its last key + window - 1 (window)
  const int q_lo = causal ? (k0 / BQ) * BQ : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long qoff = (static_cast<long long>(b) * Sq * Hq + h) * HD;
    const long long roff = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
      stage<T, HD, BQ>(sm.Qs, q + qoff, q_rs, q0, Sq);
      stage<T, HD, BQ>(sm.dOs, dout + qoff, q_rs, q0, Sq);
      stage_rows<HD>(sm, lse + roff, D + roff, q0, Sq);
      __syncthreads();
      scores<HD>(sm, q0, k0, Sq, Sk, causal, window, softcap, scale);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float p[KR], ds[KR], o[AD], x[AD];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          p[i] = sm.Ps[r * PS + tr + 16 * i];
          ds[i] = sm.dSs[r * PS + tr + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < AD; ++j) {
          o[j] = sm.dOs[r * RS + tc + 16 * j];
          x[j] = sm.Qs[r * RS + tc + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < KR; ++i)
#pragma unroll
          for (int j = 0; j < AD; ++j) {
            adv[i][j] = fmaf(p[i], o[j], adv[i][j]);
            adk[i][j] = fmaf(ds[i], x[j], adk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int c = k0 + tr + 16 * i;
    if (c >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + c) * KH + kh) * HD;
#pragma unroll
    for (int j = 0; j < AD; ++j) {
      dk[off + tc + 16 * j] = from_f32<T>(adk[i][j]);
      dv[off + tc + 16 * j] = from_f32<T>(adv[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, int Sq, int Sk, int Hq, int KH, int causal,
          int window, float softcap, float scale) {
  using Gm = Geo<HD>;
  constexpr int BQ = Gm::BQ, BK = Gm::BK, RS = Gm::RS, PS = Gm::PS;
  constexpr int QR = BQ / 16, AD = Gm::AD;
  extern __shared__ float4 smem4[];
  const Smem<HD> sm(reinterpret_cast<float*>(smem4));
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (Hq / KH);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  const long long q_rs = static_cast<long long>(Hq) * HD;
  const long long kv_rs = static_cast<long long>(KH) * HD;
  const long long qoff = (static_cast<long long>(b) * Sq * Hq + h) * HD;
  const long long kvoff = (static_cast<long long>(b) * Sk * KH + kh) * HD;
  const long long roff = (static_cast<long long>(b) * Hq + h) * Sq;
  stage<T, HD, BQ>(sm.Qs, q + qoff, q_rs, q0, Sq);
  stage<T, HD, BQ>(sm.dOs, dout + qoff, q_rs, q0, Sq);
  stage_rows<HD>(sm, lse + roff, D + roff, q0, Sq);

  float adq[QR][AD];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int j = 0; j < AD; ++j) adq[i][j] = 0.f;

  // the key tiles the forward visits for this query tile
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;   // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K and dS are consumed
    stage<T, HD, BK>(sm.Ks, k + kvoff, kv_rs, k0, Sk);
    stage<T, HD, BK>(sm.Vs, v + kvoff, kv_rs, k0, Sk);
    __syncthreads();
    scores<HD>(sm, q0, k0, Sq, Sk, causal, window, softcap, scale);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float ds[QR], x[AD];
#pragma unroll
      for (int i = 0; i < QR; ++i) ds[i] = sm.dSs[(tr + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < AD; ++j) x[j] = sm.Ks[c * RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < AD; ++j) adq[i][j] = fmaf(ds[i], x[j], adq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r >= Sq) continue;
    const long long off = qoff + static_cast<long long>(r) * q_rs;
#pragma unroll
    for (int j = 0; j < AD; ++j) dq[off + tc + 16 * j] = from_f32<T>(adq[i][j]);
  }
}

}  // namespace fma

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int C = 64;   // rows of a streamed tile: queries (dK/dV), keys (dQ)
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk ch of row r in a tile of W bf16 a row,
// the chunks XOR-swizzled by the row's low 3 bits: ldmatrix of 8
// consecutive rows at one chunk column, plain or transposed, and a quad's
// 4-byte stores into 8 rows hit 32 distinct banks.
template <int W>
__device__ __forceinline__ int at(int r, int ch) {
  return r * W + ((ch ^ (r & 7)) << 3);
}

// The tiles of one kernel (kDQ: the dQ kernel, else dK/dV).  A CTA holds R
// rows (keys; queries for dQ) and streams C-row tiles (queries; keys).  Its
// 8 warps split the R x C score tile into WR x WC blocks of 16 x CW (phase
// 1), and the R x HD accumulators into 16 x DW blocks (phase 2).
template <int HD, bool kDQ>
struct Geo {
  static constexpr int R = (!kDQ && HD == 256) ? 32 : 64;
  static constexpr int WR = R / 16, WC = kWarps / WR;
  static constexpr int CW = C / WC, DW = HD / WC;
  static constexpr int NT = CW / 8, DT = DW / 8;
  static constexpr int NA = kDQ ? 1 : 2;   // phase 2's A operands (dS; P, dS)
  // bf16 elements: the held pair (K, V; Q, dO), two stages of the streamed
  // pair, the A operands as hi and lo tiles of R x C; then float32 lse and
  // D (two stages of C for dK/dV, R for dQ)
  static constexpr int held = 2 * R * HD, stage = 2 * C * HD;
  static constexpr int atile = R * C;
  static constexpr int rows = kDQ ? R : 2 * C;
  static constexpr int bytes =
      (held + 2 * stage + 2 * NA * atile) * 2 + 2 * rows * 4;
  static_assert(bytes <= 232448, "shared memory of one CTA");
  static_assert(CW % 16 == 0 && DW % 16 == 0, "ldmatrix_x4 pairs of n-tiles");
};

// Rows r0 .. r0 + ROWS - 1 of one head of a (rows, heads, W) bf16 tensor
// (row stride ss elements) into a swizzled tile with cp.async; rows at or
// past `limit` are zero-filled.
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int limit) {
  constexpr int CPR = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kThreads) {
    const int r = idx / CPR, ch = idx % CPR;
    const bool in = r0 + r < limit;
    cp_async16(dst + at<W>(r, ch), in ? src + (r0 + r) * ss + ch * 8 : src,
               in ? 16 : 0);
  }
}

// lse and D of rows r0 .. r0 + N - 1 with cp.async; +inf and 0 past Sq, so
// that P is 0 there.
template <int N>
__device__ __forceinline__ void load_rows(float* Ls, float* Ds,
                                          const float* lse, const float* D,
                                          int r0, int Sq) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    if (r0 + i < Sq) {
      cp_async4(Ls + i, lse + r0 + i);
      cp_async4(Ds + i, D + r0 + i);
    } else {
      Ls[i] = INFINITY;
      Ds[i] = 0.f;
    }
  }
}

// Phase 1: S = A1 B1^T and dP = A2 B2^T for the warp's 16 rows r0 .. of the
// [.][HD] tiles A1, A2 and its NT * 8 columns c0 .. (rows of B1, B2), over
// the HD dims.  Element e of n-tile j is row r0 + gq + 8 (e / 2), column c0
// + 8 j + 2 tq + e % 2.
template <int HD, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], float (&dp)[NT][4],
                                       const bf16* A1, const bf16* A2,
                                       const bf16* B1, const bf16* B2, int r0,
                                       int c0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  const int a_row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
  const int b_row = c0 + (lane & 7) + (lane >> 4) * 8, b_ch = (lane >> 3) & 1;
#pragma unroll 4
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a1[4], a2[4];
    ldmatrix_x4(a1, A1 + at<HD>(a_row, 2 * ks + a_ch));
    ldmatrix_x4(a2, A2 + at<HD>(a_row, 2 * ks + a_ch));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b1[4], b2[4];
      ldmatrix_x4(b1, B1 + at<HD>(b_row + np * 16, 2 * ks + b_ch));
      ldmatrix_x4(b2, B2 + at<HD>(b_row + np * 16, 2 * ks + b_ch));
      mma_bf16(s[2 * np], a1, b1[0], b1[1]);
      mma_bf16(s[2 * np + 1], a1, b1[2], b1[3]);
      mma_bf16(dp[2 * np], a2, b2[0], b2[1]);
      mma_bf16(dp[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// P and dS of one score element from s = q.k and dp = dO.v: scale, the
// softcap and its derivative, P = exp(x - lse) where visible (0 elsewhere,
// and where lse is +inf), dS = P (dp - D) dx.
struct Grad {
  float scale, softcap, inv_cap;
  __device__ __forceinline__ void operator()(float s, float dp, float lse,
                                             float D, bool vis, float& p,
                                             float& ds) const {
    float x = s * scale, dx = scale;
    if (softcap > 0.f) {
      const float t = tanhf(x * inv_cap);
      x = t * softcap;
      dx = scale * (1.f - t * t);
    }
    p = vis ? fast_exp2((x - lse) * kLog2e) : 0.f;
    ds = p * (dp - D) * dx;
  }
};

// The pair (a, b) split into bf16 hi and lo terms, stored at element off of
// the hi tile and of the lo tile (`lo` elements after it).
template <int LO>
__device__ __forceinline__ void put_split(bf16* hi, int off, float a,
                                          float b) {
  uint32_t h, l;
  split_bf16(a, b, h, l);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(hi + LO + off) = l;
}

// Phase 2: acc (the warp's 16 rows r0 .., DT * 8 dims d0 ..) += A B, A the
// hi + lo tiles [.][C] at Ahi (lo `LO` elements after), B a [C][HD] tile,
// each k-step of 16 taken twice, hi then lo.
template <int HD, int DT, int LO>
__device__ __forceinline__ void accumulate(float (&acc)[DT][4],
                                           const bf16* Ahi, const bf16* Bm,
                                           int r0, int d0, int lane) {
  const int a_row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_ch = (d0 >> 3) + (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t hi[4], lo[4];
    ldmatrix_x4(hi, Ahi + at<C>(a_row, 2 * kk + a_ch));
    ldmatrix_x4(lo, Ahi + LO + at<C>(a_row, 2 * kk + a_ch));
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bm + at<HD>(kk * 16 + b_row, b_ch + 2 * dp));
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// One CTA per (query head h, batch row b, key tile): K and V of its R keys
// held, the tiles of C queries that can see them streamed through two
// stages in order.  Its head's dK and dV go to the float32 partials
// part[0 or 1][b][h][key] (G > 1), or straight to dk and dv (G = 1).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ part, int B, int Sq, int Sk, int Hq, int KH,
            int causal, int window, float softcap, float scale) {
  using L = Geo<HD, false>;
  constexpr int R = L::R, NT = L::NT, DT = L::DT, AT = L::atile;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);   // [R][HD]
  bf16* Vs = Ks + R * HD;                      // [R][HD]
  bf16* Qs = Vs + R * HD;                      // [2][C][HD]
  bf16* Os = Qs + 2 * C * HD;                  // [2][C][HD]: dO
  bf16* Ps = Os + 2 * C * HD;                  // [hi, lo][R][C]: P^T
  bf16* Ss = Ps + 2 * AT;                      // [hi, lo][R][C]: dS^T
  float* Ls = reinterpret_cast<float*>(Ss + 2 * AT);   // [2][C]
  float* Ds = Ls + 2 * C;                              // [2][C]

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * R;
  const int G = Hq / KH, kh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp % L::WR) * 16, wc = warp / L::WR;
  const int c0 = wc * L::CW, d0 = wc * L::DW;
  const Grad grad{scale, softcap, softcap > 0.f ? 1.f / softcap : 0.f};

  const long long q_rs = static_cast<long long>(Hq) * HD;
  const long long kv_rs = static_cast<long long>(KH) * HD;
  const long long kvoff = (static_cast<long long>(b) * Sk * KH + kh) * HD;
  const long long qoff = (static_cast<long long>(b) * Sq * Hq + h) * HD;
  const long long roff = (static_cast<long long>(b) * Hq + h) * Sq;
  load_tile<HD, R>(Ks, k + kvoff, kv_rs, k0, Sk);
  load_tile<HD, R>(Vs, v + kvoff, kv_rs, k0, Sk);

  // the query tiles that can see a key of this tile: from the one holding
  // its first key (causal) to its last key + window - 1 (window)
  const int q_lo = causal ? (k0 / C) * C : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + R - 1 + window) : Sq;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + C - 1) / C : 0;
  // tile n into stage n % 2, one commit group a tile (K, V ride in the
  // first)
  auto load_q = [&](int n) {
    if (n < nq) {
      const int st = n & 1, q0 = q_lo + n * C;
      load_tile<HD, C>(Qs + st * C * HD, q + qoff, q_rs, q0, Sq);
      load_tile<HD, C>(Os + st * C * HD, dout + qoff, q_rs, q0, Sq);
      load_rows<C>(Ls + st * C, Ds + st * C, lse + roff, D + roff, q0, Sq);
    }
    cp_async_commit();
  };
  load_q(0);

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;

  for (int n = 0; n < nq; ++n) {
    cp_async_wait<0>();
    // tile n is in; every warp is done with tile n - 1, its stage and the
    // P / dS tiles
    __syncthreads();
    load_q(n + 1);
    const int st = n & 1, q0 = q_lo + n * C;
    const bf16* Qt = Qs + st * C * HD;
    const bf16* Ot = Os + st * C * HD;
    const float* Lt = Ls + st * C;
    const float* Dt = Ds + st * C;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[NT][4], dp[NT][4];
    scores<HD, NT>(s, dp, Ks, Vs, Qt, Ot, r0, c0, lane);
    const bool mask = (causal && k0 + R - 1 > q0) ||
                      (window > 0 && k0 <= q0 + C - 1 - window) ||
                      q0 + C > Sq || k0 + R > Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // rows gq and gq + 8
        const int rl = r0 + gq + 8 * i, cl = c0 + 8 * j + 2 * tq;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + rl, query = q0 + cl + e;
          const bool vis = !mask ||
              (query < Sq && key < Sk && (!causal || key <= query) &&
               (window == 0 || key > query - window));
          grad(s[j][2 * i + e], dp[j][2 * i + e], Lt[cl + e], Dt[cl + e],
               vis, p[e], ds[e]);
        }
        const int off = at<C>(rl, cl >> 3) + (cl & 7);
        put_split<AT>(Ps, off, p[0], p[1]);
        put_split<AT>(Ss, off, ds[0], ds[1]);
      }
    }
    __syncthreads();   // P^T and dS^T are in
    // dV += P^T dO and dK += dS^T Q, over the tile's C queries
    accumulate<HD, DT, AT>(adv, Ps, Ot, r0, d0, lane);
    accumulate<HD, DT, AT>(adk, Ss, Qt, r0, d0, lane);
  }
  cp_async_wait<0>();   // no copy outlives the CTA

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + gq + 8 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int dim = d0 + 8 * d + 2 * tq;
      const float2 vk = make_float2(adk[d][2 * i], adk[d][2 * i + 1]);
      const float2 vv = make_float2(adv[d][2 * i], adv[d][2 * i + 1]);
      if (G == 1) {
        const long long o = ((static_cast<long long>(b) * Sk + key) * KH + kh)
                            * HD + dim;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(vk.x, vk.y);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(vv.x, vv.y);
      } else {
        const long long o = ((static_cast<long long>(b) * Hq + h) * Sk + key)
                            * HD + dim;
        const long long half = static_cast<long long>(B) * Hq * Sk * HD;
        *reinterpret_cast<float2*>(part + o) = vk;
        *reinterpret_cast<float2*>(part + half + o) = vv;
      }
    }
  }
}

// dk and dv (blockIdx.y 0 and 1) of every (b, key, kv head, 4 dims): the
// group's G partials summed in head order g = 0 .. G - 1, cast once.
template <int HD>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int B, int Sk, int Hq, int KH) {
  constexpr int V4 = HD / 4;
  const long long n = static_cast<long long>(B) * Sk * KH * V4;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const int G = Hq / KH;
  const int d4 = static_cast<int>(i % V4);
  const long long row = i / V4;   // (b, key, kv head)
  const int kh = static_cast<int>(row % KH);
  const long long bs = row / KH;
  const int key = static_cast<int>(bs % Sk), b = static_cast<int>(bs / Sk);
  const float* src = part + blockIdx.y * (static_cast<long long>(B) * Hq * Sk * HD) +
                     ((static_cast<long long>(b) * Hq + kh * G) * Sk + key) *
                         HD + d4 * 4;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(
        src + static_cast<long long>(g) * Sk * HD);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  bf16* dst = (blockIdx.y ? dv : dk) + i * 4;
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(acc.x, acc.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// One CTA per (query head h, batch row b, query tile): Q, dO, lse and D of
// its R queries held, the key tiles the forward visits streamed through
// two stages in order, the scores recomputed; dq written once.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)   // budget above
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dq, int Sq, int Sk, int Hq, int KH, int causal,
          int window, float softcap, float scale) {
  using L = Geo<HD, true>;
  constexpr int R = L::R, NT = L::NT, DT = L::DT, AT = L::atile;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [R][HD]
  bf16* Os = Qs + R * HD;                      // [R][HD]: dO
  bf16* Ks = Os + R * HD;                      // [2][C][HD]
  bf16* Vs = Ks + 2 * C * HD;                  // [2][C][HD]
  bf16* Ss = Vs + 2 * C * HD;                  // [hi, lo][R][C]: dS
  float* Ls = reinterpret_cast<float*>(Ss + 2 * AT);   // [R]
  float* Ds = Ls + R;                                  // [R]

  // the last query tiles see the most keys: they go first
  const int nqt = (Sq + R - 1) / R;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.z)) * R;
  const int kh = h / (Hq / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp % L::WR) * 16, wc = warp / L::WR;
  const int c0 = wc * L::CW, d0 = wc * L::DW;
  const Grad grad{scale, softcap, softcap > 0.f ? 1.f / softcap : 0.f};

  const long long q_rs = static_cast<long long>(Hq) * HD;
  const long long kv_rs = static_cast<long long>(KH) * HD;
  const long long kvoff = (static_cast<long long>(b) * Sk * KH + kh) * HD;
  const long long qoff = (static_cast<long long>(b) * Sq * Hq + h) * HD;
  const long long roff = (static_cast<long long>(b) * Hq + h) * Sq;
  load_tile<HD, R>(Qs, q + qoff, q_rs, q0, Sq);
  load_tile<HD, R>(Os, dout + qoff, q_rs, q0, Sq);
  load_rows<R>(Ls, Ds, lse + roff, D + roff, q0, Sq);

  // the key tiles the forward visits for this query tile
  const int k_hi = causal ? min(Sk, q0 + R) : Sk;   // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_lo / C;
  const int nk = k_hi > k_lo ? (k_hi - 1) / C + 1 - t0 : 0;
  auto load_kv = [&](int n) {
    if (n < nk) {
      const int st = n & 1, kt0 = (t0 + n) * C;
      load_tile<HD, C>(Ks + st * C * HD, k + kvoff, kv_rs, kt0, Sk);
      load_tile<HD, C>(Vs + st * C * HD, v + kvoff, kv_rs, kt0, Sk);
    }
    cp_async_commit();
  };
  load_kv(0);   // Q, dO, lse and D ride in the first group

  float adq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[d][e] = 0.f;

  for (int n = 0; n < nk; ++n) {
    cp_async_wait<0>();
    __syncthreads();   // tile n is in; every warp is done with tile n - 1
    load_kv(n + 1);
    const int st = n & 1, kt0 = (t0 + n) * C;
    const bf16* Kt = Ks + st * C * HD;
    const bf16* Vt = Vs + st * C * HD;

    // S = Q K^T and dP = dO V^T: rows are queries, columns keys
    float s[NT][4], dp[NT][4];
    scores<HD, NT>(s, dp, Qs, Os, Kt, Vt, r0, c0, lane);
    const bool mask = (causal && kt0 + C - 1 > q0) ||
                      (window > 0 && kt0 <= q0 + R - 1 - window) ||
                      q0 + R > Sq || kt0 + C > Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // rows gq and gq + 8
      const int rl = r0 + gq + 8 * i, query = q0 + rl;
      const float lr = Ls[rl], dr = Ds[rl];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = c0 + 8 * j + 2 * tq;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt0 + cl + e;
          const bool vis = !mask ||
              (query < Sq && key < Sk && (!causal || key <= query) &&
               (window == 0 || key > query - window));
          grad(s[j][2 * i + e], dp[j][2 * i + e], lr, dr, vis, p[e], ds[e]);
        }
        put_split<AT>(Ss, at<C>(rl, cl >> 3) + (cl & 7), ds[0], ds[1]);
      }
    }
    __syncthreads();   // dS is in
    accumulate<HD, DT, AT>(adq, Ss, Kt, r0, d0, lane);   // dQ += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int query = q0 + r0 + gq + 8 * i;
    if (query >= Sq) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const long long o = qoff + static_cast<long long>(query) * q_rs + d0 +
                          8 * d + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dq + o) =
          __floats2bfloat162_rn(adq[d][2 * i], adq[d][2 * i + 1]);
    }
  }
}

}  // namespace tc

template <typename T, int HD>
void launch_delta(const T* out, const T* dout, float* D, int B, int Sq,
                  int Hq, cudaStream_t s) {
  const int rows = B * Sq * Hq, wpb = kThreads / 32;
  delta_kernel<T, HD><<<(rows + wpb - 1) / wpb, kThreads, 0, s>>>(
      out, dout, D, rows, Sq, Hq);
}

// float32: the FMA kernels, one CTA per (key tile, kv head, batch row) for
// dK / dV.
template <int HD>
int launch_fma(const float* q, const float* k, const float* v,
               const float* out, const float* lse, const float* dout,
               float* dq, float* dk, float* dv, float* D, int B, int Sq,
               int Sk, int Hq, int KH, int causal, int window, float softcap,
               float scale, cudaStream_t s) {
  using Gm = fma::Geo<HD>;
  constexpr int bytes = Gm::bytes;
  const void* kerns[2] = {
      reinterpret_cast<const void*>(fma::dkdv_kernel<float, HD>),
      reinterpret_cast<const void*>(fma::dq_kernel<float, HD>)};
  for (const void* kern : kerns) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_delta<float, HD>(out, dout, D, B, Sq, Hq, s);
  fma::dkdv_kernel<float, HD><<<dim3((Sk + Gm::BK - 1) / Gm::BK, KH, B),
                                kThreads, bytes, s>>>(
      q, k, v, dout, lse, D, dk, dv, Sq, Sk, Hq, KH, causal, window, softcap,
      scale);
  fma::dq_kernel<float, HD><<<dim3((Sq + Gm::BQ - 1) / Gm::BQ, Hq, B),
                              kThreads, bytes, s>>>(
      q, k, v, dout, lse, D, dq, Sq, Sk, Hq, KH, causal, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16: the tensor-core kernels, then (G > 1) the ordered sum of the
// partials in `part`.
template <int HD>
int launch_tc(const tc::bf16* q, const tc::bf16* k, const tc::bf16* v,
              const tc::bf16* out, const float* lse, const tc::bf16* dout,
              tc::bf16* dq, tc::bf16* dk, tc::bf16* dv, float* D, float* part,
              int B, int Sq, int Sk, int Hq, int KH, int causal, int window,
              float softcap, float scale, cudaStream_t s) {
  using A = tc::Geo<HD, false>;
  using Q = tc::Geo<HD, true>;
  const int G = Hq / KH;
  if (G > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tc::dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      A::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        tc::dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Q::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_delta<tc::bf16, HD>(out, dout, D, B, Sq, Hq, s);
  tc::dkdv_kernel<HD><<<dim3(Hq, B, (Sk + A::R - 1) / A::R), kThreads,
                        A::bytes, s>>>(
      q, k, v, dout, lse, D, dk, dv, part, B, Sq, Sk, Hq, KH, causal, window,
      softcap, scale);
  if (G > 1) {
    const long long n = static_cast<long long>(B) * Sk * KH * (HD / 4);
    tc::reduce_kernel<HD><<<dim3(static_cast<unsigned>(
                                     (n + kThreads - 1) / kThreads), 2),
                            kThreads, 0, s>>>(part, dk, dv, B, Sk, Hq, KH);
  }
  tc::dq_kernel<HD><<<dim3(Hq, B, (Sq + Q::R - 1) / Q::R), kThreads,
                      Q::bytes, s>>>(
      q, k, v, dout, lse, D, dq, Sq, Sk, Hq, KH, causal, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* D, float* part, int B, int Sq, int Sk, int Hq, int KH,
           int causal, int window, float softcap, float scale, int dtype,
           cudaStream_t s) {
  if (dtype == kBF16) {
    using T = tc::bf16;
    return launch_tc<HD>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(out), lse,
        static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), D, part, B, Sq, Sk, Hq, KH, causal, window,
        softcap, scale, s);
  }
  if (dtype == kF32) {
    return launch_fma<HD>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out), lse,
        static_cast<const float*>(dout), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), D, B, Sq, Sk, Hq,
        KH, causal, window, softcap, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out, dout, dq: (B, Sq, Hq, hd) contiguous; k, v, dk, dv: (B, Sk, KH,
// hd) contiguous; lse: (B, Hq, Sq) float32 from the forward's LSE route;
// D: (B, Hq, Sq) float32 scratch; part: (2, B, Hq, Sk, hd) float32 scratch
// for bfloat16 with Hq > KH (else unused, may be null).  Hq % KH == 0, hd
// in {64, 128, 256}, float32 or bfloat16 (dtype code).  Returns the CUDA
// error code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* D,
    void* part, int B, int Sq, int Sk, int Hq, int KH, int hd, int causal,
    int window, float softcap, float scale, int dtype, void* stream) {
  if (KH < 1 || Hq % KH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  float* p = static_cast<float*>(part);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, l, dout, dq, dk, dv, d, p, B, Sq, Sk,
                        Hq, KH, causal, window, softcap, scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, l, dout, dq, dk, dv, d, p, B, Sq, Sk,
                         Hq, KH, causal, window, softcap, scale, dtype, s);
    case 256:
      return launch<256>(q, k, v, out, l, dout, dq, dk, dv, d, p, B, Sq, Sk,
                         Hq, KH, causal, window, softcap, scale, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
