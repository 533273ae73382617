// FlashAttention-2 backward for Hopper: the gradient of flash_attention.cu's
// function (causal, window, softcap, GQA/MQA, hd 64 / 128 / 256, ragged last
// tiles), in float32 arithmetic on float32 or bfloat16 tensors.
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
// Three launches: a pre-pass writes D (one warp per row); the dK/dV kernel
// takes one CTA per (key tile, kv head, batch row), loops over the group's
// query heads and, for each, over the query tiles that can see the key
// tile, in that fixed order, recomputing the scores; the dQ kernel takes
// one CTA per (query tile, query head, batch row) and loops over the key
// tiles the forward visits.  No atomics: every sum has one owner and a
// fixed order, so a launch gives the same bits each time and on any number
// of SMs.
//
// Bound on the H100: operations.  At qwen2's train shape (B 4, S 2048, 12:2
// heads, hd 128) the two kernels recompute the scores twice, 7 products of
// a (64 x 64 x 128) tile per visible tile pair against the forward's 2.
// This first version runs them on the FMA units (float32, no tensor cores:
// P and dS stay float32, so the gradients are within float32 rounding of
// the plain version before the final cast); tensor cores (wgmma, TMA) are
// later work.
//
// Tiles: BQ = BK = 64 at hd <= 128 (32 at hd 256, where 64-key tiles of
// K, V, Q and dO in float32 exceed the 227 KB of shared memory).  Staged
// tiles are float32 rows padded to HD + 1 floats, so a column read by 16
// threads hits 16 banks.  256 threads: thread t owns rows t / 16 + 16 i
// and columns t % 16 + 16 j of each score tile, and rows t / 16 + 16 i and
// dims t % 16 + 16 j of its accumulators.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 256;

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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* D, int B, int Sq, int Sk, int Hq, int KH, int causal,
           int window, float softcap, float scale, cudaStream_t s) {
  using Gm = Geo<HD>;
  constexpr int bytes = Gm::bytes;
  const void* kerns[2] = {reinterpret_cast<const void*>(dkdv_kernel<T, HD>),
                          reinterpret_cast<const void*>(dq_kernel<T, HD>)};
  for (const void* kern : kerns) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int rows = B * Sq * Hq, wpb = kThreads / 32;
  delta_kernel<T, HD><<<(rows + wpb - 1) / wpb, kThreads, 0, s>>>(
      static_cast<const T*>(out), gt, D, rows, Sq, Hq);
  dkdv_kernel<T, HD><<<dim3((Sk + Gm::BK - 1) / Gm::BK, KH, B), kThreads,
                       bytes, s>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, KH, causal, window, softcap, scale);
  dq_kernel<T, HD><<<dim3((Sq + Gm::BQ - 1) / Gm::BQ, Hq, B), kThreads, bytes,
                     s>>>(qt, kt, vt, gt, lse, D, static_cast<T*>(dq), Sq, Sk,
                          Hq, KH, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* out, const float* lse, const void* dout, void* dq,
                void* dk, void* dv, float* D, int B, int Sq, int Sk, int Hq,
                int KH, int causal, int window, float softcap, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, D, B, Sq, Sk,
                           Hq, KH, causal, window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, dout, dq, dk, dv, D, B, Sq, Sk,
                            Hq, KH, causal, window, softcap, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, dout, dq, dk, dv, D, B, Sq, Sk,
                            Hq, KH, causal, window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out, dout, dq: (B, Sq, Hq, hd) contiguous; k, v, dk, dv: (B, Sk, KH,
// hd) contiguous; lse: (B, Hq, Sq) float32 from the forward's LSE route;
// D: (B, Hq, Sq) float32 scratch.  Hq % KH == 0, hd in {64, 128, 256},
// float32 or bfloat16 (dtype code).  Returns the CUDA error code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* D,
    int B, int Sq, int Sk, int Hq, int KH, int hd, int causal, int window,
    float softcap, float scale, int dtype, void* stream) {
  if (KH < 1 || Hq % KH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (dtype == kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, l, dout, dq, dk, dv,
                                      d, B, Sq, Sk, Hq, KH, causal, window,
                                      softcap, scale, s);
  if (dtype == kF32)
    return dispatch_hd<float>(hd, q, k, v, out, l, dout, dq, dk, dv, d, B, Sq,
                              Sk, Hq, KH, causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
