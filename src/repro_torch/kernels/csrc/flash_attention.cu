// Causal GQA flash-attention forward for Hopper, reading q/k/v in the
// model's (B, S, H, hd) layout through strides (no transposes).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body `_kernel`; bshd wrapper src/repro/kernels/ops.py::flash_attention_bshd).
// Query i and key j sit at positions i and j.  Key j is visible to query i
// when j <= i (causal), and j > i - window when a window is set; the logits
// are soft-capped (tanh) when softcap > 0.  Softmax and accumulation are
// float32; a row with no visible key gives zeros.  Query head h reads kv
// head h / (Hq/KH).
//
// Bound on the H100: operations.  At Sq = Sk = 1024, hd = 128 and qwen2's
// 12:2 heads the causal forward is ~3.2 GFLOP per layer against ~7.3 MB of
// bf16 q/k/v/o, ~440 FLOP/byte, above the card's ~295.  This first version does its products with
// plain float32 FMAs (no mma/wgmma), so it runs far below that bound; the
// design keeps the tile logic a later tensor-core version needs: one CTA per
// (q tile of 64 rows, query head, batch row) walks the k tiles of 64 keys in
// order with an online softmax, skipping tiles wholly past the diagonal or
// wholly before the window.  Each thread holds a 4x8 block of the score tile
// and a 4 x hd/8 block of the output.  Tiles are staged in shared memory as
// float32 (Q and K transposed so the 4x8 products read contiguous floats).
// The last q and k tiles may be ragged: rows past Sq are not stored and
// keys past Sk are zero-filled and masked.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 128;
constexpr int PSTR = BK + 1;   // padded row stride of the probability tile

template <int HD>
constexpr int smem_bytes() {
  return (HD * BQ + HD * BK + BK * HD + BQ * PSTR) * static_cast<int>(sizeof(float));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Sk, int G,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh,
                       int causal, int window, float softcap, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][BQ]
  float* Kt = Qt + HD * BQ;                      // [HD][BK]
  float* Vs = Kt + HD * BK;                      // [BK][HD]
  float* Ps = Vs + BK * HD;                      // [BQ][PSTR]

  constexpr int N = Vec<T>::N;
  constexpr int DV = HD / N;     // 16-byte vectors per row
  constexpr int DPT = HD / 8;    // output dims per thread
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int t = threadIdx.x, rg = t / 8, cg = t % 8;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int idx = t; idx < BQ * DV; idx += kThreads) {
    const int r = idx % BQ, dv = idx / BQ;
    float e[N];
    if (q0 + r < Sq) {
      load_vec(qb + (long long)(q0 + r) * q_ss + dv * N, e);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) Qt[(dv * N + i) * BQ + r] = e[i];
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // k tiles that can hold a visible key for some row of this q tile
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;        // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int c0 = (k_lo / BK) * BK; c0 < k_hi; c0 += BK) {
    __syncthreads();   // previous tile fully consumed (and Qt written)
    for (int idx = t; idx < BK * DV; idx += kThreads) {
      const int c = idx % BK, dv = idx / BK;
      float e[N];
      if (c0 + c < Sk) {
        load_vec(kb + (long long)(c0 + c) * k_ss + dv * N, e);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) Kt[(dv * N + i) * BK + c] = e[i];
    }
    for (int idx = t; idx < BK * DV; idx += kThreads) {
      const int dv = idx % DV, c = idx / DV;
      float e[N];
      if (c0 + c < Sk) {
        load_vec(vb + (long long)(c0 + c) * v_ss + dv * N, e);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) Vs[c * HD + dv * N + i] = e[i];
    }
    __syncthreads();

    // S = Q K^T on this thread's 4x8 block
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * BQ + rg * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * BK + cg * 8]);
      const float4 kc = *reinterpret_cast<const float4*>(&Kt[d * BK + cg * 8 + 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }

    // mask, online softmax (the 8 threads of a row group are lanes
    // differing in their low 3 bits), probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + rg * 4 + i;
      bool ok[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + cg * 8 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = c < Sk && (!causal || c <= r) && (window == 0 || c > r - window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg * 4 + i) * PSTR + cg * 8 + j] = p;
        ps += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

    // O += P V: this thread's 4 rows x dims cg, cg + 8, ...
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(rg * 4 + i) * PSTR + c];
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        const float vv = Vs[c * HD + cg + 8 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][d] += pr[i] * vv;
      }
    }
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const float o = l[i] > 0.f ? acc[i][d] / l[i] : 0.f;
      ob[(long long)r * o_ss + cg + 8 * d] = from_f32<T>(o);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int G, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes<HD>();
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, G, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int G, const long long* st,
                int causal, int window, float softcap, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Sq, Hq, hd), k, v: (B, Sk, KH, hd), out: (B, Sq, Hq, hd), each with
// its own element strides (batch, sequence, head; the last dim contiguous,
// 16-byte aligned rows).  hd in {64, 128, 256}.  Returns the CUDA error code.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int Hq, int KH, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float scale, int dtype, void* stream) {
  if (KH < 1 || Hq % KH) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / KH;
  if (dtype == kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, Hq, G, st,
                                      causal, window, softcap, scale, s);
  if (dtype == kF32)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Sk, Hq, G, st, causal,
                              window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
