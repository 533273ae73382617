// Flash-decode body shared by the port's decode kernels
// (decode_attention.cu, paged_decode_attention.cu, decode_attention_q8.cu):
// one query token per batch row against a KV context whose key rows are
// found through a policy class `Keys` (the kernels pass a `Cache` below: a
// stored element type over a row policy, `DenseRows` or `PagedRows`).
//
// Key j of row b is used when Keys::valid says so; a row with no valid key
// gives zeros.  A logit s (the scaled dot product) is soft-capped to
// tanh(s / softcap) * softcap when softcap > 0 (gemma2), before the running
// max.  Softmax and accumulation are float32.
//
// Bound on the H100: bytes.  Every valid key's K and V row is read once and
// each is used for 2*G FLOP per element (G = Hq/KH query heads share it), so
// the arithmetic intensity is ~G/2 FLOP/byte in bf16 (~G in int8), far below
// the card's ~295.  The card reaches its memory rate only with many bytes in
// flight on every SM, so the keys of a row are split over CTAs:
//
// - Fixed spans.  The grid is (spans, KH, B): CTA (s, kh, b) takes key
//   indices [s*kSpan, (s+1)*kSpan) of row b for kv head kh, with all G query
//   heads, so K/V are read once for the whole group.  kSpan (128) is a
//   constant, counted from key 0, and never derived from Sk, the ctx
//   bucket, the page count, B or the SM count; the launch has
//   ceil(walk / kSpan) spans for the longest walk the caller allows (Sk
//   dense, n_pages*ps paged): 256 CTAs at B 8, Sk 2048, 2 kv heads.  A CTA
//   first finds its span's first and last valid key; it loads nothing
//   outside them, and a span with no valid key writes an empty partial
//   (m = -1e30, l = 0) and exits.
// - Inside a span, chunks of CK keys (aligned to the span's start; 64 bf16
//   or int8 keys at hd 128, so two a span) are copied into shared memory
//   with 16-byte cp.async copies, kStages deep, so two chunks are in flight
//   while one is computed; three block syncs a chunk.  A key's score is
//   summed by 256/CK threads, each holding its slots of the key in
//   registers, with shuffles; P.V
//   gives each thread one column of at most 8 elements of V (one 16-byte
//   vector of bf16, 4 floats, or 8 bytes of int8) for one query head (or a
//   few, when G exceeds the head slots), the keys of the chunk split over
//   KG key groups when G leaves slots free; the key groups are summed in
//   order at the end.
// - Partials.  Each CTA writes its unnormalised float32 acc[G][hd] and
//   m[G], l[G] to a scratch buffer the wrapper allocates; the kernel
//   allocates nothing.
// - Combine.  A second kernel folds a row's partials in span order 0, 1,
//   2, ..., skipping empty ones, normalises and casts to T.  No sum uses
//   atomics, every sum has a fixed order, and results are the same on
//   every run.
// - Span partials alone.  A launch with no output (out == nullptr) runs the
//   span kernel only and leaves the partials in the scratch: the
//   sequence-sharded decode, where each rank holds one range of a cache's
//   keys, runs it on its range (spans count from the range's first key),
//   the ranks gather their scratches in rank order, and the combine kernel
//   folds the gathered partials through strides (R ranges of `spans`
//   spans each, range-major: global span order).  A rank range of whole
//   spans gives exactly the partials the one-device launch gives for those
//   keys, so the result is that launch's, bit for bit.
//
// Because spans are fixed key indices, a row's result depends only on its
// own keys and q_pos: the same context gives the same bits in a ctx bucket
// of 1024 or 2048 slots (the extra spans are empty and skipped), and in a
// dense cache or a page chain (both walk key index = position).
//
// Staged keys (Keys::Elem) are float32, bfloat16 or int8; q and the output
// are float32 or bfloat16 (T).  A float32 past under a bfloat16 query
// (Keys::Src float, Elem bfloat16: a bf16 model with float32 caches) is
// loaded through registers and rounded to bf16 on its way into the stage,
// which gives the bits of the reference's cast of the gathered past to q's
// dtype without a copy of the pool; everything after the stage is the
// bf16 route's, so such a launch equals the bf16 kernel on the cast past,
// bit for bit.  Int8 keys (Keys::kScaled) carry one float32
// scale per (key, kv head) for K and for V, staged into shared memory in the
// same cp.async group as their rows.  The scales are factored out of the
// sums: a score is (sum_d q_d * k_d) * k_scale * softmax_scale over the raw
// int8 values, and V's scale multiplies p before P.V, (p * v_scale) * v_d.
// The Pallas kernel and the plain version multiply each element instead
// (k_d * k_scale before the dot product), so the two round differently, by
// float32 rounding steps.
//
// The policies differ only in where key j's row lives and how its validity
// is decided; spans, chunking, staging and arithmetic are this one body.
//
// A policy provides, for batch row b with query position qp:
//   Elem, kScaled         the staged element type; int8 with scales or not
//   Src, kRound           the stored element type; float32 rounded to bf16
//   int  len()            the walk: key indices 0 .. len() - 1
//   bool valid(b, qp, j)  key j is attended
//   const Src* k_row(b, kh, j), v_row(b, kh, j)   16-byte aligned rows
//   const float* k_scale(b, kh, j), v_scale(b, kh, j)   (kScaled only)
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query heads per kv head
constexpr int kSpan = 128;      // key indices per CTA (decode_attention.py SPAN)
constexpr int kStages = 3;      // chunks staged in shared memory

// Spans of a launch over a walk of `walk` key indices (at least one, so a
// row with no keys still gets its zeros from the combine).
inline int n_spans(long long walk) {
  return walk > kSpan ? static_cast<int>((walk + kSpan - 1) / kSpan) : 1;
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
  static constexpr int HS = kThreads / VPV;      // head slots (P.V)
  static constexpr int HPT = (kMaxG + HS - 1) / HS;   // heads a thread holds
  static constexpr int TILE = CK * HD;           // elements of one K or V tile
  // shared memory: kStages K tiles, kStages V tiles, then q (G x HD), p
  // (G x CK) and, for int8 keys, the scales [kStages][K, V][CK]
  static constexpr int tile_bytes() {
    return 2 * kStages * TILE * static_cast<int>(sizeof(S));
  }
  static int smem_bytes(int G, bool scaled) {
    return tile_bytes() + (G * (HD + CK) + (scaled ? 2 * kStages * CK : 0)) *
                              static_cast<int>(sizeof(float));
  }
  // K rows are stored with their 16-byte slots XOR-swizzled so that the
  // threads scoring neighbouring keys hit different banks (no swizzle when a
  // row has fewer than 8 slots: int8 at hd 64, whose 4 threads per key then
  // read 64 contiguous bytes)
  static constexpr int SWZ = (VPR < 8 ? VPR : 8) - 1;
  static __device__ __forceinline__ int swz(int j) { return (j * TPK) & SWZ; }
  static_assert(kSpan % CK == 0, "chunks tile a span");
  // the key-group sums ([KG][G][HD] floats, at most HS x HD) reuse the K tiles
  static_assert(HS * HD * 4 <= kStages * TILE * static_cast<int>(sizeof(S)),
                "key-group sums fit in the K tiles");
};

// Where key rows live, in elements: a batch row (or a page), a key slot and
// a kv head apart.
struct Strides {
  long long b, k, h;
};

// Key rows of a dense cache (B, Sk, KH, hd), possibly a strided view of a
// longer buffer.  Key j is valid when
// 0 <= k_pos[b, j] <= qp and, with a window, k_pos[b, j] > qp - window.
struct DenseRows {
  const int* k_pos;
  int Sk, window;
  long long kp_sb;

  __device__ __forceinline__ int len() const { return Sk; }
  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    const int kp = k_pos[b * kp_sb + j];
    return kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
  }
  __device__ __forceinline__ long long at(int b, int kh, int j,
                                          const Strides& s) const {
    return b * s.b + (long long)j * s.k + kh * s.h;
  }
};

// Key rows of a page pool (P, ps, KH, hd): key j of row b lives in page
// table[b, j / ps] at slot j % ps.  Pages are linear, so key j has position
// j: valid when j <= qp and, with a window, j > qp - window.  The walk is
// n_pages*ps keys, so keys past min(qp, n_pages*ps - 1) are never loaded.
struct PagedRows {
  const int* table;
  int n_pages, ps, window;
  long long pt_sb;                 // page-table row stride

  __device__ __forceinline__ int len() const { return n_pages * ps; }
  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    return j <= qp && (window == 0 || j > qp - window);
  }
  __device__ __forceinline__ long long at(int b, int kh, int j,
                                          const Strides& s) const {
    const int page = table[b * pt_sb + j / ps];
    return page * s.b + (j % ps) * s.k + kh * s.h;
  }
};

// The Keys policy of the body: K/V rows of element type Src found through
// Rows and staged as S (Src float and S bfloat16: rounded on load), and
// with Scaled their float32 scales (..., KH, 1), found the same way with
// their own strides.
template <typename S, class Rows, bool Scaled = false, typename Src = S>
struct Cache {
  using Elem = S;
  using Source = Src;
  static constexpr bool kScaled = Scaled;
  static constexpr bool kRound = !std::is_same<S, Src>::value;
  static_assert(!kRound || (std::is_same<S, __nv_bfloat16>::value &&
                            std::is_same<Src, float>::value && !Scaled),
                "only a float32 past is rounded, to bfloat16");
  Rows rows;
  const Src* k;
  const Src* v;
  Strides k_st, v_st;
  const float* k_s = nullptr;
  const float* v_s = nullptr;
  Strides k_s_st{}, v_s_st{};

  __device__ __forceinline__ int len() const { return rows.len(); }
  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    return rows.valid(b, qp, j);
  }
  __device__ __forceinline__ const Src* k_row(int b, int kh, int j) const {
    return k + rows.at(b, kh, j, k_st);
  }
  __device__ __forceinline__ const Src* v_row(int b, int kh, int j) const {
    return v + rows.at(b, kh, j, v_st);
  }
  __device__ __forceinline__ const float* k_scale(int b, int kh, int j) const {
    return k_s + rows.at(b, kh, j, k_s_st);
  }
  __device__ __forceinline__ const float* v_scale(int b, int kh, int j) const {
    return v_s + rows.at(b, kh, j, v_s_st);
  }
};

// Scratch of one launch, float32: acc [B][KH][spans][G][HD], then (m, l)
// [B][KH][spans][G][2].  (Host code calls it too: a __device__-only
// function called from the host compiles to a process exit there.)
__host__ __device__ __forceinline__ float* partial_ml(float* part, int B,
                                                     int KH, int spans, int G,
                                                     int HD) {
  return part + (long long)B * KH * spans * G * HD;
}

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); writes this CTA's partial.
template <typename T, int HD, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
              float* __restrict__ part, int KH, int G, long long q_sb,
              long long q_sh, float scale, float softcap, const Keys keys) {
  using S = typename Keys::Elem;
  constexpr bool kScaled = Keys::kScaled;
  using C = Geom<S, HD>;
  constexpr int N = C::N, VPR = C::VPR, CK = C::CK, TPK = C::TPK;
  constexpr int NPV = C::NPV, VPV = C::VPV, HS = C::HS, HPT = C::HPT;
  extern __shared__ float4 smem4[];
  S* Ks = reinterpret_cast<S*>(smem4);                       // [kStages][CK][HD]
  S* Vs = Ks + kStages * C::TILE;                            // [kStages][CK][HD]
  float* q_s = reinterpret_cast<float*>(Vs + kStages * C::TILE);   // [G][HD]
  float* p_s = q_s + G * HD;                                 // [G][CK]
  float* sc_s = p_s + G * CK;                                // [kStages][2][CK]
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int valid_s[2][CK];
  __shared__ int lo_s[kWarps], hi_s[kWarps];

  const int span = blockIdx.x, spans = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int qp = q_pos[b];
  const long long rec = ((long long)b * KH + kh) * spans + span;
  float* ml = partial_ml(part, gridDim.z, KH, spans, G, HD) + rec * G * 2;

  // the span's first and last valid key
  const int j0 = span * kSpan, j1 = min(j0 + kSpan, keys.len());
  int lo = 0x7fffffff, hi = -1;
  for (int j = j0 + t; j < j1; j += kThreads) {
    if (keys.valid(b, qp, j)) {
      lo = min(lo, j);
      hi = j;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) { lo_s[warp] = lo; hi_s[warp] = hi; }
  if (t < G) { m_s[t] = kNegInf; l_s[t] = 0.f; }
  __syncthreads();
  int first = 0x7fffffff, last = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, lo_s[w]);
    last = max(last, hi_s[w]);
  }
  if (last < 0) {   // an empty partial
    if (t < G) { ml[2 * t] = kNegInf; ml[2 * t + 1] = 0.f; }
    return;
  }

  for (int i = t; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
  }
  const int c_lo = (first - j0) / CK;
  const int n_chunks = (last - j0) / CK + 1 - c_lo;

  // the i-th chunk of this CTA into stage i % kStages: keys first..last only
  auto load_chunk = [&](int i) {
    const int c0 = j0 + (c_lo + i) * CK, st = i % kStages;
    S* kd = Ks + st * C::TILE;
    S* vd = Vs + st * C::TILE;
    for (int idx = t; idx < CK * VPR; idx += kThreads) {
      const int j = idx / VPR, s = idx % VPR;
      if (c0 + j >= first && c0 + j <= last) {
        S* kdst = kd + j * HD + (s ^ C::swz(j)) * N;
        S* vdst = vd + j * HD + s * N;
        if constexpr (Keys::kRound) {
          // float32 through registers: a plain store, visible after the
          // block sync that precedes the chunk's use, as the copies are
          round8_bf16(kdst, keys.k_row(b, kh, c0 + j) + s * N);
          round8_bf16(vdst, keys.v_row(b, kh, c0 + j) + s * N);
        } else {
          cp_async16(kdst, keys.k_row(b, kh, c0 + j) + s * N);
          cp_async16(vdst, keys.v_row(b, kh, c0 + j) + s * N);
        }
      }
    }
    if constexpr (kScaled) {
      if (t < CK && c0 + t >= first && c0 + t <= last) {
        cp_async4(sc_s + st * 2 * CK + t, keys.k_scale(b, kh, c0 + t));
        cp_async4(sc_s + st * 2 * CK + CK + t, keys.v_scale(b, kh, c0 + t));
      }
    }
  };
  // one commit group per chunk, empty ones included, so that waiting for
  // all but the newest kStages - 2 groups always means "chunk i is in"
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_chunks) load_chunk(i);
    cp_async_commit();
  }

  // P.V thread map: head slot hs = t / VPV, column pv = t % VPV.  With
  // G <= HS the slots hold KG = HS / G key groups of G heads each (keys
  // kgi, kgi + KG, ... of a chunk); with G > HS one key group, and slot hs
  // holds heads hs, hs + HS, ...
  const int GS = min(G, HS), KG = HS / GS;
  const int hs = t / VPV, pv = t % VPV, kgi = hs / GS, g0 = hs % GS;
  const bool pv_on = kgi < KG;
  float acc[HPT][NPV];
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int n = 0; n < NPV; ++n) acc[h][n] = 0.f;
  const int sj = t / TPK, sp = t % TPK;   // scores: key in chunk, part

  for (int i = 0; i < n_chunks; ++i) {
    const int c0 = j0 + (c_lo + i) * CK, st = i % kStages, vb = i & 1;
    if (t < CK) {
      const int j = c0 + t;
      valid_s[vb][t] = j >= first && j <= last && keys.valid(b, qp, j);
    }
    cp_async_wait<kStages - 2>();
    // chunk i is in, and every thread is done with chunk i - 1, whose
    // stage the next copies fill
    __syncthreads();
    if (i + kStages - 1 < n_chunks) load_chunk(i + kStages - 1);
    cp_async_commit();

    // scores: TPK threads per key, each over slots sp, sp + TPK, ... of its
    // key (held in registers), one query head at a time
    constexpr int SPT = VPR / TPK;   // slots per thread
    const S* kr = Ks + st * C::TILE + sj * HD;
    float e[SPT][N];
#pragma unroll
    for (int u = 0; u < SPT; ++u)
      load_vec(kr + ((sp + u * TPK) ^ C::swz(sj)) * N, e[u]);
    float ksc = 1.f;
    if constexpr (kScaled) ksc = sc_s[st * 2 * CK + sj];
    const bool key_ok = valid_s[vb][sj];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < SPT; ++u) {
          const float* qg = q_s + g * HD + (sp + u * TPK) * N;
#pragma unroll
          for (int n = 0; n < N; ++n) dot += qg[n] * e[u][n];
        }
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if constexpr (kScaled) dot *= ksc;
        if (sp == 0) {
          float x = dot * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          p_s[g * CK + sj] = key_ok ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax over the chunk: warp w takes heads w, w + 8
    for (int g = warp; g < G; g += kWarps) {
      const bool ok0 = lane < CK && valid_s[vb][lane];
      const bool ok1 = lane + 32 < CK && valid_s[vb][lane + 32];
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

    // P.V: thread (kgi, g0, pv) sums keys kgi, kgi + KG, ... on its column
    if (pv_on) {
#pragma unroll
      for (int h = 0; h < HPT; ++h) {
        const int g = g0 + h * GS;
        if (g < G) {
          const float corr = corr_s[g];
#pragma unroll
          for (int n = 0; n < NPV; ++n) acc[h][n] *= corr;
        }
      }
      const S* vr = Vs + st * C::TILE;
      for (int j = kgi; j < CK; j += KG) {
        if (!valid_s[vb][j]) continue;
        float e[NPV];
        if constexpr (NPV < N) load_vec8(vr + j * HD + pv * NPV, e);
        else load_vec(vr + j * HD + pv * NPV, e);
        float vsc = 1.f;
        if constexpr (kScaled) vsc = sc_s[st * 2 * CK + CK + j];
#pragma unroll
        for (int h = 0; h < HPT; ++h) {
          const int g = g0 + h * GS;
          if (g < G) {
            float p = p_s[g * CK + j];
            if constexpr (kScaled) p *= vsc;
#pragma unroll
            for (int n = 0; n < NPV; ++n) acc[h][n] += p * e[n];
          }
        }
      }
    }
  }

  // the partial: key groups summed in order 0 .. KG-1 (in the K tiles,
  // which nothing reads after the last chunk's scores), then m and l
  float* pacc = part + rec * G * HD;
  if (KG == 1) {
    if (pv_on) {
#pragma unroll
      for (int h = 0; h < HPT; ++h) {
        const int g = g0 + h * GS;
        if (g < G) {
#pragma unroll
          for (int n = 0; n < NPV; n += 4)
            *reinterpret_cast<float4*>(pacc + g * HD + pv * NPV + n) =
                make_float4(acc[h][n], acc[h][n + 1], acc[h][n + 2], acc[h][n + 3]);
        }
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(smem4);   // [KG][G][HD]
    if (pv_on) {
#pragma unroll
      for (int n = 0; n < NPV; ++n)
        red[(kgi * G + g0) * HD + pv * NPV + n] = acc[0][n];
    }
    __syncthreads();
    for (int idx = t; idx < G * HD; idx += kThreads) {
      float o = 0.f;
      for (int kk = 0; kk < KG; ++kk) o += red[kk * G * HD + idx];
      pacc[idx] = o;
    }
  }
  if (t < G) { ml[2 * t] = m_s[t]; ml[2 * t + 1] = l_s[t]; }
}

// Where partials lie, in floats: acc at r*r + b*b + kh*h + s*s + g*HD + d,
// (m, l) at r*r + b*b + kh*h + s*s + 2*g (+ 1), for range r of R, batch row
// b, kv head kh, span s of a range and query head g of the group.
struct PartStrides {
  long long r, b, h, s;
};

// The strides of one launch's scratch (R = 1): acc [B][KH][spans][G][HD],
// then (m, l) [B][KH][spans][G][2].
inline PartStrides scratch_strides(int KH, int spans, int G, int width) {
  const long long s = (long long)G * width;
  return {0, KH * spans * s, spans * s, s};
}

// One thread per (row, query head, dim): the row's partials folded in span
// order (range by range), normalised, cast to T.  out: (B, Hq, hd)
// contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
               T* __restrict__ out, int KH, int G, int R, int spans,
               long long a_r, long long a_b, long long a_h, long long a_s,
               long long m_r, long long m_b, long long m_h, long long m_s) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kh = h / G, g = h % G;
  float m = kNegInf, l = 0.f, o = 0.f;
  for (int r = 0; r < R; ++r) {
    const float* mr = ml + r * m_r + b * m_b + kh * m_h + 2 * g;
    const float* ar = acc + r * a_r + b * a_b + kh * a_h + g * HD + d;
    for (int s = 0; s < spans; ++s, mr += m_s, ar += a_s) {
      const float ls = mr[1];
      if (ls == 0.f) continue;   // no valid key in this span
      const float msp = mr[0];
      const float mn = fmaxf(m, msp);
      const float ca = expf(m - mn), cb = expf(msp - mn);
      l = l * ca + ls * cb;
      o = o * ca + *ar * cb;
      m = mn;
    }
  }
  out[((long long)b * KH * G + h) * HD + d] = from_f32<T>(l > 0.f ? o / l : 0.f);
}

template <typename T, int HD>
int launch_combine(const float* acc, const float* ml, void* out, int B,
                   int KH, int G, int R, int spans, const PartStrides& as,
                   const PartStrides& ms, cudaStream_t s) {
  combine_kernel<T, HD><<<dim3(KH * G, B), HD, 0, s>>>(
      acc, ml, static_cast<T*>(out), KH, G, R, spans, as.r, as.b, as.h, as.s,
      ms.r, ms.b, ms.h, ms.s);
  return static_cast<int>(cudaGetLastError());
}

// The span kernel, then (unless out is nullptr: the span-partial route) the
// combine over its scratch.
template <typename T, int HD, class Keys>
int launch(const void* q, const void* q_pos, void* out, float* part,
           int spans, int B, int KH, int G, long long q_sb, long long q_sh,
           float scale, float softcap, const Keys& keys, cudaStream_t s) {
  using C = Geom<typename Keys::Elem, HD>;
  const int bytes = C::smem_bytes(G, Keys::kScaled);
  auto kern = decode_kernel<T, HD, Keys>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(spans, KH, B), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const int*>(q_pos), part, KH, G,
      q_sb, q_sh, scale, softcap, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  return launch_combine<T, HD>(part, partial_ml(part, B, KH, spans, G, HD),
                               out, B, KH, G, 1, spans,
                               scratch_strides(KH, spans, G, HD),
                               scratch_strides(KH, spans, G, 2), s);
}

// Instantiate `launch` for the head dim.  `part` holds the scratch of
// `spans` = n_spans(walk) spans (the caller checks the count); `out`
// nullptr stops after the span kernel.
template <typename T, class Keys>
int dispatch_hd(int hd, const void* q, const void* q_pos, void* out,
                void* part, int spans, int B, int KH, int G, long long q_sb,
                long long q_sh, float scale, float softcap, const Keys& keys,
                cudaStream_t s) {
  float* p = static_cast<float*>(part);
  switch (hd) {
    case 64:
      return launch<T, 64>(q, q_pos, out, p, spans, B, KH, G, q_sb, q_sh, scale, softcap, keys, s);
    case 128:
      return launch<T, 128>(q, q_pos, out, p, spans, B, KH, G, q_sb, q_sh, scale, softcap, keys, s);
    case 256:
      return launch<T, 256>(q, q_pos, out, p, spans, B, KH, G, q_sb, q_sh, scale, softcap, keys, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Instantiate `launch_combine` for the head dim and the output type.
inline int combine_hd(int hd, int dtype, const float* acc, const float* ml,
                      void* out, int B, int KH, int G, int R, int spans,
                      const PartStrides& as, const PartStrides& ms,
                      cudaStream_t s) {
#define RT_COMBINE(T, HD) \
  return launch_combine<T, HD>(acc, ml, out, B, KH, G, R, spans, as, ms, s)
  if (dtype == kBF16) {
    if (hd == 64) RT_COMBINE(__nv_bfloat16, 64);
    if (hd == 128) RT_COMBINE(__nv_bfloat16, 128);
    if (hd == 256) RT_COMBINE(__nv_bfloat16, 256);
  } else if (dtype == kF32) {
    if (hd == 64) RT_COMBINE(float, 64);
    if (hd == 128) RT_COMBINE(float, 128);
    if (hd == 256) RT_COMBINE(float, 256);
  }
#undef RT_COMBINE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace rt
