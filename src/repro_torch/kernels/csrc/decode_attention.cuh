// Flash-decode body shared by the dense and the paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu): one query token per
// batch row against a KV context whose key rows are found through a policy
// class `Keys`.
//
// Key j of row b is used when Keys::valid says so; a row with no valid key
// gives zeros.  Softmax and accumulation are float32.
//
// Bound on the H100: bytes.  Every valid key's K and V row is read once and
// each is used for 2*G FLOP per element (G = Hq/KH query heads share it), so
// the arithmetic intensity is ~G/2 FLOP/byte in bf16, far below the card's
// ~295.  Design: one CTA per (batch row, kv head) holding all G query heads,
// so K/V are read once for the whole group.  Keys are walked in chunks of
// CK rows; each chunk's K and V rows are copied into shared memory with
// 16-byte cp.async copies, double buffered so the next chunk's copies are in
// flight while this chunk is computed (with only B*KH CTAs, 16 at batch 8
// on qwen2, each SM must keep many bytes in flight).  Keys past the last
// valid one (the unfilled tail of a ctx bucket, the scratch pages of a page
// chain) are never loaded.  Scores take CK/256 of a key per thread and a
// shuffle sum; P.V gives each thread one 16-byte column of V.  There is no
// split over keys across CTAs: every sum has a fixed order and results are
// the same on every run.
//
// The two policies differ only in where key j's row lives and how its
// validity is decided; chunking, staging and arithmetic are this one body.
// So the same keys at the same positions give bitwise equal outputs whether
// they sit in a dense cache or in a page chain.
//
// A policy provides, for batch row b with query position qp:
//   int  last(b, qp, t)   the last valid key this thread can see (-1: none);
//                         the block takes the max over its threads
//   bool valid(b, qp, j)  key j is attended
//   const T* k_row(b, kh, j), v_row(b, kh, j)   16-byte aligned rows
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

template <typename T, int HD>
struct Geom {
  static constexpr int N = 16 / sizeof(T);       // elements per 16-byte vector
  static constexpr int VPR = HD / N;             // vectors per K/V row (>= 8)
  static constexpr int CK = HD * sizeof(T) <= 256 ? 64 : 32;   // keys per chunk
  static constexpr int TPK = kThreads / CK;      // threads per key (scores)
  static constexpr int KG = kThreads / VPR;      // key groups (P.V)
  static constexpr int TILE = CK * HD;           // elements of one K or V tile
  // shared memory: 2 K tiles, 2 V tiles, then q (G x HD) and p (G x CK)
  static constexpr int tile_bytes() { return 4 * TILE * static_cast<int>(sizeof(T)); }
  static int smem_bytes(int G) {
    return tile_bytes() + G * (HD + CK) * static_cast<int>(sizeof(float));
  }
  // K rows are stored with their 16-byte slots XOR-swizzled so that the
  // threads scoring neighbouring keys hit different banks
  static __device__ __forceinline__ int swz(int j) { return (j * TPK) & 7; }
};

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); out: (B, Hq, hd) contiguous.
template <typename T, int HD, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
              T* __restrict__ out, int KH, int G, long long q_sb,
              long long q_sh, float scale, const Keys keys) {
  using C = Geom<T, HD>;
  constexpr int N = C::N, VPR = C::VPR, CK = C::CK, TPK = C::TPK, KG = C::KG;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                       // [2][CK][HD]
  T* Vs = Ks + 2 * C::TILE;                                  // [2][CK][HD]
  float* q_s = reinterpret_cast<float*>(Vs + 2 * C::TILE);   // [G][HD]
  float* p_s = q_s + G * HD;                                 // [G][CK]
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
    T* kd = Ks + buf * C::TILE;
    T* vd = Vs + buf * C::TILE;
    for (int idx = t; idx < CK * VPR; idx += kThreads) {
      const int j = idx / VPR, s = idx % VPR;
      if (c0 + j < n_keys) {
        cp_async16(kd + j * HD + (s ^ C::swz(j)) * N, keys.k_row(b, kh, c0 + j) + s * N);
        cp_async16(vd + j * HD + s * N, keys.v_row(b, kh, c0 + j) + s * N);
      }
    }
    cp_async_commit();
  };

  float acc[kMaxG][N];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[g][n] = 0.f;
  const int sj = t / TPK, sp = t % TPK;   // scores: key in chunk, part
  const int kg = t / VPR, pv = t % VPR;   // P.V: key group, 16-byte column

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
    const T* kr = Ks + buf * C::TILE + sj * HD;
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
        if (sp == 0) p_s[g * CK + sj] = valid_s[sj] ? dot[g] * scale : kNegInf;
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
        for (int n = 0; n < N; ++n) acc[g][n] *= corr;
      }
    }
    const T* vr = Vs + buf * C::TILE;
    for (int j = kg; j < CK; j += KG) {
      if (!valid_s[j]) continue;
      float e[N];
      load_vec(vr + j * HD + pv * N, e);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = p_s[g * CK + j];
#pragma unroll
          for (int n = 0; n < N; ++n) acc[g][n] += p * e[n];
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
      for (int n = 0; n < N; ++n) red[kg * HD + pv * N + n] = acc[g][n];
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
  using C = Geom<T, HD>;
  const int bytes = C::smem_bytes(G);
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
