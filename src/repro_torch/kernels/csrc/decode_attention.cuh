// Flash-decode body shared by the port's decode kernels
// (decode_attention.cu, paged_decode_attention.cu, decode_attention_q8.cu):
// one query token per batch row against a KV context whose key rows are
// found through a policy class `Keys` (the kernels pass a `Cache` below: a
// stored element type over a row policy, `DenseRows` or `PagedRows`).
//
// Key j of row b is used when Keys::valid says so; a row with no valid key
// gives zeros.  Softmax and accumulation are float32.
//
// Bound on the H100: bytes.  Every valid key's K and V row is read once and
// each is used for 2*G FLOP per element (G = Hq/KH query heads share it), so
// the arithmetic intensity is ~G/2 FLOP/byte in bf16 (~G in int8), far below
// the card's ~295.  Design: one CTA per (batch row, kv head) holding all G
// query heads, so K/V are read once for the whole group.  Keys are walked in
// chunks of CK rows; each chunk's K and V rows are copied into shared memory
// with 16-byte cp.async copies, double buffered so the next chunk's copies
// are in flight while this chunk is computed (with only B*KH CTAs, 16 at
// batch 8 on qwen2, each SM must keep many bytes in flight).  Keys past the
// last valid one (the unfilled tail of a ctx bucket, the scratch pages of a
// page chain) are never loaded.  Scores take CK/256 of a key per thread and
// a shuffle sum; P.V gives each thread one column of at most 8 elements of
// V (one 16-byte vector of bf16, 4 floats, or 8 bytes of int8).  There is
// no split over keys across CTAs: every sum has a fixed order and results
// are the same on every run.
//
// Stored keys (Keys::Elem) are float32, bfloat16 or int8; q and the output
// are float32 or bfloat16 (T).  Int8 keys (Keys::kScaled) carry one float32
// scale per (key, kv head) for K and for V, staged into shared memory in the
// same cp.async group as their rows.  The scales are factored out of the
// sums: a score is (sum_d q_d * k_d) * k_scale * softmax_scale over the raw
// int8 values, and V's scale multiplies p before P.V, (p * v_scale) * v_d.
// The Pallas kernel and the plain version multiply each element instead
// (k_d * k_scale before the dot product), so the two round differently, by
// float32 rounding steps.
//
// The policies differ only in where key j's row lives and how its validity
// is decided; chunking, staging and arithmetic are this one body.  So the
// same keys at the same positions give bitwise equal outputs whether they
// sit in a dense cache or in a page chain.
//
// A policy provides, for batch row b with query position qp:
//   Elem, kScaled         the stored element type; int8 with scales or not
//   int  last(b, qp, t)   the last valid key this thread can see (-1: none);
//                         the block takes the max over its threads
//   bool valid(b, qp, j)  key j is attended
//   const Elem* k_row(b, kh, j), v_row(b, kh, j)   16-byte aligned rows
//   const float* k_scale(b, kh, j), v_scale(b, kh, j)   (kScaled only)
#pragma once

#include "common.cuh"

namespace rt {
namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query heads per kv head

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Geometry of the stored element type S (float, bf16 or int8) at head dim HD.
template <typename S, int HD>
struct Geom {
  static constexpr int N = 16 / sizeof(S);       // elements per 16-byte vector
  static constexpr int VPR = HD / N;             // vectors per K/V row (>= 4)
  static constexpr int CK = HD * sizeof(S) <= 256 ? 64 : 32;   // keys per chunk
  static constexpr int TPK = kThreads / CK;      // threads per key (scores)
  static constexpr int NPV = N < 8 ? N : 8;      // elements of a P.V column
  static constexpr int VPV = HD / NPV;           // P.V columns of a V row
  static constexpr int KG = kThreads / VPV;      // key groups (P.V)
  static constexpr int TILE = CK * HD;           // elements of one K or V tile
  // shared memory: 2 K tiles, 2 V tiles, then q (G x HD), p (G x CK) and,
  // for int8 keys, the scales [2 buffers][K, V][CK]
  static constexpr int tile_bytes() { return 4 * TILE * static_cast<int>(sizeof(S)); }
  static int smem_bytes(int G, bool scaled) {
    return tile_bytes() + (G * (HD + CK) + (scaled ? 4 * CK : 0)) *
                              static_cast<int>(sizeof(float));
  }
  // K rows are stored with their 16-byte slots XOR-swizzled so that the
  // threads scoring neighbouring keys hit different banks (no swizzle when a
  // row has fewer than 8 slots: int8 at hd 64, whose 4 threads per key then
  // read 64 contiguous bytes)
  static constexpr int SWZ = (VPR < 8 ? VPR : 8) - 1;
  static __device__ __forceinline__ int swz(int j) { return (j * TPK) & SWZ; }
};

// Where key rows live, in elements: a batch row (or a page), a key slot and
// a kv head apart.
struct Strides {
  long long b, k, h;
};

// Key rows of a dense cache (B, Sk, KH, hd), a strided view of a longer
// buffer or of a shared context (batch stride 0).  Key j is valid when
// 0 <= k_pos[b, j] <= qp and, with a window, k_pos[b, j] > qp - window.
struct DenseRows {
  const int* k_pos;
  int Sk, window;
  long long kp_sb;

  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    const int kp = k_pos[b * kp_sb + j];
    return kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
  }
  __device__ __forceinline__ int last(int b, int qp, int t) const {
    int l = -1;
    for (int j = t; j < Sk; j += kThreads)
      if (valid(b, qp, j)) l = j;
    return l;
  }
  __device__ __forceinline__ long long at(int b, int kh, int j,
                                          const Strides& s) const {
    return b * s.b + (long long)j * s.k + kh * s.h;
  }
};

// Key rows of a page pool (P, ps, KH, hd): key j of row b lives in page
// table[b, j / ps] at slot j % ps.  Pages are linear, so key j has position
// j: valid when j <= qp and, with a window, j > qp - window.  The walk
// stops at min(qp, n_pages*ps - 1).
struct PagedRows {
  const int* table;
  int n_pages, ps, window;
  long long pt_sb;                 // page-table row stride

  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    return j <= qp && (window == 0 || j > qp - window);
  }
  __device__ __forceinline__ int last(int b, int qp, int t) const {
    return max(min(qp, n_pages * ps - 1), -1);
  }
  __device__ __forceinline__ long long at(int b, int kh, int j,
                                          const Strides& s) const {
    const int page = table[b * pt_sb + j / ps];
    return page * s.b + (j % ps) * s.k + kh * s.h;
  }
};

// The Keys policy of the body: K/V rows of element type S found through
// Rows, and with Scaled their float32 scales (..., KH, 1), found the same
// way with their own strides.
template <typename S, class Rows, bool Scaled = false>
struct Cache {
  using Elem = S;
  static constexpr bool kScaled = Scaled;
  Rows rows;
  const S* k;
  const S* v;
  Strides k_st, v_st;
  const float* k_s = nullptr;
  const float* v_s = nullptr;
  Strides k_s_st{}, v_s_st{};

  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    return rows.valid(b, qp, j);
  }
  __device__ __forceinline__ int last(int b, int qp, int t) const {
    return rows.last(b, qp, t);
  }
  __device__ __forceinline__ const S* k_row(int b, int kh, int j) const {
    return k + rows.at(b, kh, j, k_st);
  }
  __device__ __forceinline__ const S* v_row(int b, int kh, int j) const {
    return v + rows.at(b, kh, j, v_st);
  }
  __device__ __forceinline__ const float* k_scale(int b, int kh, int j) const {
    return k_s + rows.at(b, kh, j, k_s_st);
  }
  __device__ __forceinline__ const float* v_scale(int b, int kh, int j) const {
    return v_s + rows.at(b, kh, j, v_s_st);
  }
};

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); out: (B, Hq, hd) contiguous.
template <typename T, int HD, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
              T* __restrict__ out, int KH, int G, long long q_sb,
              long long q_sh, float scale, const Keys keys) {
  using S = typename Keys::Elem;
  constexpr bool kScaled = Keys::kScaled;
  using C = Geom<S, HD>;
  constexpr int N = C::N, VPR = C::VPR, CK = C::CK, TPK = C::TPK;
  constexpr int NPV = C::NPV, VPV = C::VPV, KG = C::KG;
  extern __shared__ float4 smem4[];
  S* Ks = reinterpret_cast<S*>(smem4);                       // [2][CK][HD]
  S* Vs = Ks + 2 * C::TILE;                                  // [2][CK][HD]
  float* q_s = reinterpret_cast<float*>(Vs + 2 * C::TILE);   // [G][HD]
  float* p_s = q_s + G * HD;                                 // [G][CK]
  float* sc_s = p_s + G * CK;                                // [2][2][CK]
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int valid_s[CK];
  __shared__ int last_s[kWarps];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int qp = q_pos[b];

  // keys past the last valid one are never loaded
  int last = keys.last(b, qp, t);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) last_s[warp] = last;
  for (int i = t; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
  }
  if (t < G) { m_s[t] = kNegInf; l_s[t] = 0.f; }
  __syncthreads();
  int n_keys = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_keys = max(n_keys, last_s[w] + 1);
  const int n_chunks = (n_keys + CK - 1) / CK;

  auto load_chunk = [&](int c, int buf) {
    const int c0 = c * CK;
    S* kd = Ks + buf * C::TILE;
    S* vd = Vs + buf * C::TILE;
    for (int idx = t; idx < CK * VPR; idx += kThreads) {
      const int j = idx / VPR, s = idx % VPR;
      if (c0 + j < n_keys) {
        cp_async16(kd + j * HD + (s ^ C::swz(j)) * N, keys.k_row(b, kh, c0 + j) + s * N);
        cp_async16(vd + j * HD + s * N, keys.v_row(b, kh, c0 + j) + s * N);
      }
    }
    if constexpr (kScaled) {
      if (t < CK && c0 + t < n_keys) {
        cp_async4(sc_s + buf * 2 * CK + t, keys.k_scale(b, kh, c0 + t));
        cp_async4(sc_s + buf * 2 * CK + CK + t, keys.v_scale(b, kh, c0 + t));
      }
    }
    cp_async_commit();
  };

  float acc[kMaxG][NPV];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int n = 0; n < NPV; ++n) acc[g][n] = 0.f;
  const int sj = t / TPK, sp = t % TPK;   // scores: key in chunk, part
  const int kg = t / VPV, pv = t % VPV;   // P.V: key group, column

  if (n_chunks > 0) load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, c0 = c * CK;
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (t < CK) valid_s[t] = c0 + t < n_keys && keys.valid(b, qp, c0 + t);
    __syncthreads();

    // scores: TPK threads per key, each over slots sp, sp + TPK, ...
    const S* kr = Ks + buf * C::TILE + sj * HD;
    float dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPR / TPK; ++i) {
      const int s = sp + i * TPK;
      float e[N];
      load_vec(kr + (s ^ C::swz(sj)) * N, e);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float* qg = q_s + g * HD + s * N;
#pragma unroll
          for (int n = 0; n < N; ++n) dot[g] += qg[n] * e[n];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        float sc = dot[g];
        if constexpr (kScaled) sc *= sc_s[buf * 2 * CK + sj];
        if (sp == 0) p_s[g * CK + sj] = valid_s[sj] ? sc * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the chunk: warp w takes heads w, w + 8
    for (int g = warp; g < G; g += kWarps) {
      const bool ok0 = lane < CK && valid_s[lane];
      const bool ok1 = lane + 32 < CK && valid_s[lane + 32];
      const float s0 = ok0 ? p_s[g * CK + lane] : kNegInf;
      const float s1 = ok1 ? p_s[g * CK + lane + 32] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      if (lane < CK) p_s[g * CK + lane] = p0;
      if (lane + 32 < CK) p_s[g * CK + lane + 32] = p1;
      const float ps = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread (kg, pv) sums keys kg, kg + KG, ... on its column
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float corr = corr_s[g];
#pragma unroll
        for (int n = 0; n < NPV; ++n) acc[g][n] *= corr;
      }
    }
    const S* vr = Vs + buf * C::TILE;
    for (int j = kg; j < CK; j += KG) {
      if (!valid_s[j]) continue;
      float e[NPV];
      if constexpr (NPV < N) load_vec8(vr + j * HD + pv * NPV, e);
      else load_vec(vr + j * HD + pv * NPV, e);
      float vsc = 1.f;
      if constexpr (kScaled) vsc = sc_s[buf * 2 * CK + CK + j];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float p = p_s[g * CK + j];
          if constexpr (kScaled) p *= vsc;
#pragma unroll
          for (int n = 0; n < NPV; ++n) acc[g][n] += p * e[n];
        }
      }
    }
    __syncthreads();   // this buffer is refilled by the next iteration
  }

  // combine the key groups of each head in a fixed order, normalise, store
  float* red = reinterpret_cast<float*>(Ks);   // [KG][HD], the K tiles are free
  const int Hq = KH * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int n = 0; n < NPV; ++n) red[kg * HD + pv * NPV + n] = acc[g][n];
      __syncthreads();
      const float l = l_s[g];
      for (int d = t; d < HD; d += kThreads) {
        float o = 0.f;
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) o += red[kk * HD + d];
        o = l > 0.f ? o / l : 0.f;
        out[((long long)b * Hq + kh * G + g) * HD + d] = from_f32<T>(o);
      }
      __syncthreads();
    }
  }
}

template <typename T, int HD, class Keys>
int launch(const void* q, const void* q_pos, void* out, int B, int KH, int G,
           long long q_sb, long long q_sh, float scale, const Keys& keys,
           cudaStream_t s) {
  using C = Geom<typename Keys::Elem, HD>;
  const int bytes = C::smem_bytes(G, Keys::kScaled);
  auto kern = decode_kernel<T, HD, Keys>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const int*>(q_pos),
      static_cast<T*>(out), KH, G, q_sb, q_sh, scale, keys);
  return static_cast<int>(cudaGetLastError());
}

// Instantiate `launch` for the head dim.
template <typename T, class Keys>
int dispatch_hd(int hd, const void* q, const void* q_pos, void* out, int B,
                int KH, int G, long long q_sb, long long q_sh, float scale,
                const Keys& keys, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, q_pos, out, B, KH, G, q_sb, q_sh, scale, keys, s);
    case 128:
      return launch<T, 128>(q, q_pos, out, B, KH, G, q_sb, q_sh, scale, keys, s);
    case 256:
      return launch<T, 256>(q, q_pos, out, B, KH, G, q_sb, q_sh, scale, keys, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace decode
}  // namespace rt
