// Chunked-prefill attention for Hopper: one stream's prompt chunk against
// [its past | the raw chunk], the past read straight from where it lives:
// the paged pool through the stream's page-table row, or the stream's row
// of a dense cache, which is a ring buffer when it is shorter than the
// context.
//
// Replaces: the chunk mode of src/repro/models/transformer.py::_apply_attn
// (XLA attention over the gathered, dequantized past concatenated with the
// chunk's own K/V; no Pallas kernel).  Query i of the chunk sits at
// position start + i.  Key positions below start are the past:
// - paged: position p lives in page page_table[p / ps] at offset p % ps of
//   the pool (P, ps, KH, hd);
// - dense row: position p lives at slot p % buf_len of the row (buf_len,
//   KH, hd), and is resident when p >= start - buf_len (the ring
//   arithmetic of models/kvcache.py::ring_slot_positions; older positions,
//   which the ring has overwritten, are masked).
// Position start + j is the chunk's key j, read from the raw chunk (S, KH,
// hd), valid when j < length.  Query i sees the keys in [lo(i), hi(i)]:
// hi(i) = start + min(i, length - 1) (causal, pads masked), and lo(i) the
// larger of start + i - window + 1 (with a window) and the oldest resident
// position.  Logits are soft-capped, tanh(s / softcap) * softcap, when
// softcap > 0.  Past entries at positions >= start (the rest of the last
// page, the chain's tail, scratch page 0, ring slots about to be
// overwritten) are never read as such, so the caller may write the chunk
// after this launch on the same stream (the reference reads the past
// before that write).  Softmax and accumulation are float32; query head h
// reads kv head h / G.
//
// Bound on the H100: operations.  At the paged burst's shape (256 queries
// at start 512, 12:2 heads, hd 128) the visible (query, key) pairs need
// ~1 GFLOP against ~1.6 MB of q, past, chunk and output.
//
// Rows.  The G query heads of a kv head are packed into one tile: row R of
// kv head kh is query R / G, head kh * G + R % G, so a tile of 64 rows holds
// every head of ~64 / G consecutive queries (G need not divide 64: a query
// may straddle two tiles), each K/V tile is staged once for all of them,
// and a tile's rows have nearly the same bounds.  The grid is (row tiles,
// KH, spans).
//
// bfloat16 q (`tc` below): the tensor-core tile step of flash_tile.cuh
// (mma.sync m16n8k16, ldmatrix from XOR-swizzled cp.async stages, two warp
// groups splitting the k tiles and merging in a fixed order, P as bf16
// hi + lo; hd 256: one group of eight warps, two per 16 rows).  K/V tiles
// are 64 key positions (32 at hd 256) counted from position 0, a row at a
// time from its source: a past row through the page ids, which the CTA
// first copies into shared memory (a 64-key tile covers four pages of 16),
// or from its ring slot; a chunk row from the raw K/V; a position past
// start + length zero-filled.  k tiles wholly above a tile's highest bound
// or wholly below its lowest lower bound are skipped, and only tiles that
// reach past a row's bound are masked.
// - Spans.  At the burst's shape the row tiles give 48 CTAs for 132 SMs,
//   so the keys are also split over CTAs in fixed spans of `span` key
//   positions counted from 0 (the wrapper's constant SPAN, never derived
//   from the chunk, the chain or the SM count): each CTA writes an
//   unnormalised float32 partial (acc, m, l) per row, and a second kernel
//   folds a row's spans in span order, from the span of its lower bound to
//   that of its upper one, skipping empty ones.  A row's bits depend only
//   on its keys, its bounds and the span: not on the page ids, the pool,
//   the chain's tail, the ring's other slots or the run.
// - int8 past with float32 scales (kv_quant): a past row is loaded as
//   int8, multiplied by its scale in float32 and rounded to bf16, which is
//   dequantize_kv (models/kvcache.py) exactly, then stored into the stage;
//   the raw chunk stays bf16, as in the reference.
// - float32 past (a bf16 model with float32 caches): a past row is loaded
//   as float32 and rounded to bf16 on its way into the stage, which is the
//   reference's cast of the gathered chain or row to q's dtype without a
//   copy of the pool; every later step is the bf16 route's, so a launch
//   equals the bf16 route on the cast past, bit for bit.
//
// float32 q (`fma` below): the FMA step of flash_tile.cuh with the same
// rows, sources and bounds (an int8 past dequantized to float32), one span.
#include <type_traits>

#include "flash_tile.cuh"

using namespace rt;

namespace {

using namespace rt::flash;

// Where a past key row lives: the pools (P, ps, KH, hd) read through the
// page ids (buf_len 0), or a dense row (buf_len, KH, hd) read at ring slot
// p % buf_len (page always 0, so sp is unused); for an int8 past, the
// float32 scales (..., KH, 1).  Strides in elements.
struct Pool {
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  long long sp, ss, sh;        // pool strides: page, slot, kv head
  long long s_sp, s_ss, s_sh;  // scale strides
  int ps, buf_len;

  // element offsets of past position p's row for kv head kh (ro) and of
  // its scale (so)
  __device__ __forceinline__ void locate(const int* pages, int p, int kh,
                                         long long& ro, long long& so) const {
    int page = 0, off;
    if (buf_len > 0) {
      off = p % buf_len;
    } else {
      const int pg = p / ps;
      off = p - pg * ps;
      page = pages[pg];
    }
    ro = page * sp + off * ss + kh * sh;
    so = page * s_sp + off * s_ss + kh * s_sh;
  }
};

// The visible keys of a chunk row: positions [lo, hi] of query i.
struct Bounds {
  int start, length, window, oldest;   // oldest: the first resident position
  __device__ __forceinline__ int hi(int i) const {
    return start + min(i, length - 1);
  }
  __device__ __forceinline__ int lo(int i) const {
    return window > 0 ? max(oldest, start + i - window + 1) : oldest;
  }
};

// Copy the page ids of positions 0 .. start-1 into shared memory.
__device__ __forceinline__ void stage_pages(int* pages, const int* table,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) pages[i] = table[i];
}

namespace tc {

using namespace rt::flash::tc;

// 16-byte chunk ch (8 elements) of a past key row into shared memory: a
// cp.async of bf16, int8 dequantized as dequantize_kv does (float32
// product with the scale, rounded once to bf16), or float32 rounded to
// bf16 (a cast).
template <typename E>
__device__ __forceinline__ void stage_past(bf16* dst, const void* pool,
                                           const float* scales, long long ro,
                                           long long so, int ch) {
  if constexpr (std::is_same<E, int8_t>::value) {
    const int2 raw =
        *reinterpret_cast<const int2*>(static_cast<const int8_t*>(pool) + ro + ch * 8);
    const float sc = scales[so];
    float e[8];
    widen_i8(raw.x, e);
    widen_i8(raw.y, e + 4);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(e[2 * i] * sc, e[2 * i + 1] * sc);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (std::is_same<E, float>::value) {
    round8_bf16(dst, static_cast<const float*>(pool) + ro + ch * 8);
  } else {
    cp_async16(dst, static_cast<const bf16*>(pool) + ro + ch * 8);
  }
}

template <int HD, typename E>
__global__ void __launch_bounds__(Tiles<HD>::kThreads)
chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, Pool pool,
             const int* __restrict__ table, float* __restrict__ part, int S,
             Bounds bd, int n_past_pages, int G, int span, long long q_ss,
             long long q_sh, long long k_ss, long long k_sh, long long v_ss,
             long long v_sh, float scale, float softcap) {
  using L = Tiles<HD>;
  constexpr int BK = L::BK, NS = L::NS, NT = L::NT, DT = L::DT;
  constexpr int KG = L::KG, GT = L::GT, CPR = L::CPR;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BQ][HD]
  int* pages = reinterpret_cast<int*>(Qs + L::bytes / 2);
  const int tid = threadIdx.x, grp = tid / GT, gt = tid % GT;
  bf16* Ks = Qs + BQ * HD + grp * 2 * NS * BK * HD;
  bf16* Vs = Ks + NS * BK * HD;

  const int kh = blockIdx.y, KH = gridDim.y, SG = S * G;
  const int R0 = blockIdx.x * BQ, sp = blockIdx.z;
  const int start = bd.start, length = bd.length;
  const Lane<HD> w(gt);
  const float sl2 = scale * kLog2e;

  // the keys this CTA takes: positions [lo, hi) of its span between the
  // tile's lowest lower bound and its highest upper bound; the tile's
  // lowest upper and highest lower bounds decide which k tiles need a mask
  const int i_first = R0 / G, i_last = (min(R0 + BQ, SG) - 1) / G;
  const int k_hi = bd.hi(i_last) + 1, hi_min = bd.hi(i_first);
  const int lo_min = bd.lo(i_first), lo_max = bd.lo(i_last);
  const int lo = max(sp * span, lo_min), hi = min(k_hi, sp * span + span);
  if (hi <= lo) return;   // the whole CTA: nothing of its span is visible
  const int t0 = lo / BK, nt = (hi - 1) / BK + 1 - t0;
  const int ng = nt > grp ? (nt - grp + KG - 1) / KG : 0;

  stage_pages(pages, table, n_past_pages);
  __syncthreads();

  auto load_kv = [&](int n) {
    if (n < ng) {
      const int st = n % NS, c0 = (t0 + grp + n * KG) * BK;
      bf16* kd = Ks + st * BK * HD;
      bf16* vd = Vs + st * BK * HD;
      for (int idx = gt; idx < BK * CPR; idx += GT) {
        const int r = idx / CPR, ch = idx % CPR, p = c0 + r;
        const int at = L::at(r, ch);
        if (p < start) {
          long long ro, so;
          pool.locate(pages, p, kh, ro, so);
          stage_past<E>(kd + at, pool.kp, pool.ks, ro, so, ch);
          stage_past<E>(vd + at, pool.vp, pool.vs, ro, so, ch);
        } else {
          const int j = p - start;
          const bool in = j < length;
          cp_async16(kd + at, in ? k + j * k_ss + kh * k_sh + ch * 8 : k,
                     in ? 16 : 0);
          cp_async16(vd + at, in ? v + j * v_ss + kh * v_sh + ch * 8 : v,
                     in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  // Q: row R is query R / G of head kh * G + R % G; rows past S * G zero
  for (int idx = tid; idx < BQ * CPR; idx += L::kThreads) {
    const int r = idx / CPR, ch = idx % CPR, R = R0 + r;
    const bool in = R < SG;
    const long long off =
        in ? (R / G) * q_ss + (kh * G + R % G) * q_sh + ch * 8 : 0;
    cp_async16(Qs + L::at(r, ch), q + off, in ? 16 : 0);
  }
#pragma unroll
  for (int n = 0; n < NS - 1; ++n) load_kv(n);
  cp_async_wait<NS - 2>();
  __syncthreads();

  const QFrags<HD> qf(Qs, w);
  State<HD> st;
  // the bounds of the thread's two rows
  int rb[2], lb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = (R0 + w.rw * 16 + w.gq + 8 * i) / G;
    rb[i] = bd.hi(qi);
    lb[i] = bd.lo(qi);
  }

  for (int n = 0; n < ng; ++n) {
    const int c0 = (t0 + grp + n * KG) * BK;
    if (n > 0) {
      cp_async_wait<NS - 2>();
      group_sync<GT>(grp);
    }
    load_kv(n + NS - 1);
    const bool mask = c0 + BK - 1 > hi_min || c0 < lo_max;
    // scale (log2 domain), softcap, the rows' bounds
    step<HD>(st, qf, Ks + (n % NS) * BK * HD, Vs + (n % NS) * BK * HD, w,
             [&](float (&s)[NT][4]) {
      if (softcap > 0.f) {
        const float pre = scale / softcap, post = softcap * kLog2e;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = tanhf(s[j][e] * pre) * post;
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
      }
      if (mask) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * w.tq + (e & 1);
            if (c > rb[e >> 1] || c < lb[e >> 1]) s[j][e] = kNegInf;
          }
      }
    });
  }
  cp_async_wait<0>();

  if (!merge_groups<HD>(st, reinterpret_cast<float*>(Qs + BQ * HD), grp, gt))
    return;
  const int spans = gridDim.z;
  float* ml = part + (long long)KH * spans * SG * HD;   // [KH][spans][SG][2]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = R0 + w.rw * 16 + w.gq + 8 * i;
    if (R >= SG) continue;
    const long long pr = ((long long)kh * spans + sp) * SG + R;
    float* pa = part + pr * HD + w.d0;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(pa + d * 8 + 2 * w.tq) =
          make_float2(st.o[d][2 * i], st.o[d][2 * i + 1]);
    if (w.tq == 0 && w.d0 == 0) {
      ml[2 * pr] = st.m[i];
      ml[2 * pr + 1] = st.l[i];
    }
  }
}

// Fold row R's span partials in span order, from the span of its lower
// bound to that of its upper one (spans with no visible key, l = 0,
// skipped), normalise, cast to bf16.  Block (R, kh), one thread per dim.
template <int HD>
__global__ void __launch_bounds__(HD)
chunk_merge_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                   int S, Bounds bd, int G, int span, int spans) {
  const int R = blockIdx.x, kh = blockIdx.y, KH = gridDim.y, d = threadIdx.x;
  const int SG = S * G, qi = R / G;
  const int hi = bd.hi(qi), lo = bd.lo(qi);
  // the spans whose CTAs saw this row's keys (none when lo > hi)
  const int s0 = lo / span, s1 = lo > hi ? -1 : min(spans - 1, hi / span);
  const float* ml = part + (long long)KH * spans * SG * HD;
  float m = kNegInf, l = 0.f, acc = 0.f;
  for (int s = s0; s <= s1; ++s) {
    const long long pr = ((long long)kh * spans + s) * SG + R;
    const float ls = ml[2 * pr + 1];
    if (ls == 0.f) continue;
    const float ms = ml[2 * pr];
    const float mn = fmaxf(m, ms);
    const float ca = fast_exp2(m - mn), cb = fast_exp2(ms - mn);
    l = l * ca + ls * cb;
    acc = acc * ca + part[pr * HD + d] * cb;
    m = mn;
  }
  out[((long long)qi * KH * G + kh * G + R % G) * HD + d] =
      __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

}  // namespace tc

namespace fma {

using namespace rt::flash::fma;

// Elements c4*4 .. c4*4+3 of a past key row as float32: a float4, or int8
// times its scale (dequantize_kv into float32).
template <typename E>
__device__ __forceinline__ void past4(float* e, const void* pool,
                                      const float* scales, long long ro,
                                      long long so, int c4) {
  if constexpr (std::is_same<E, int8_t>::value) {
    const int raw =
        *reinterpret_cast<const int*>(static_cast<const int8_t*>(pool) + ro + c4 * 4);
    const float sc = scales[so];
    widen_i8(raw, e);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] *= sc;
  } else {
    load_vec(static_cast<const float*>(pool) + ro + c4 * 4, e);
  }
}

template <int HD, typename E>
__global__ void __launch_bounds__(kThreads)
chunk_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Pool pool,
                 const int* __restrict__ table, float* __restrict__ out,
                 int S, Bounds bd, int n_past_pages, int G, long long q_ss,
                 long long q_sh, long long k_ss, long long k_sh,
                 long long v_ss, long long v_sh, float scale, float softcap) {
  extern __shared__ float4 smem4[];
  const Smem<HD> sm(reinterpret_cast<float*>(smem4));
  int* pages = reinterpret_cast<int*>(sm.end());

  constexpr int N = Vec<float>::N;
  const int kh = blockIdx.y, Hq = gridDim.y * G, SG = S * G;
  const int R0 = blockIdx.x * BQ;
  const int start = bd.start, length = bd.length;

  stage_pages(pages, table, n_past_pages);
  stage_q<HD>(sm, [&](int r, int dv, float* e) {
    const int R = R0 + r;
    if (R < SG) {
      load_vec(q + (R / G) * q_ss + (kh * G + R % G) * q_sh + dv * N, e);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = 0.f;
    }
  });
  State<HD> st;
  int rb[4], lb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = (R0 + st.rg * 4 + i) / G;
    rb[i] = bd.hi(qi);
    lb[i] = bd.lo(qi);
  }
  const int i_last = (min(R0 + BQ, SG) - 1) / G;
  const int k_hi = bd.hi(i_last) + 1;

  for (int c0 = bd.lo(R0 / G) / BK * BK; c0 < k_hi; c0 += BK) {
    __syncthreads();   // previous tile consumed; Qt and the page ids written
    // the key row at position c0 + c: past, chunk or zero
    stage_kv<HD>(sm, [&](float* e, bool is_v, int c, int c4) {
      const int p = c0 + c;
      if (p < start) {
        long long ro, so;
        pool.locate(pages, p, kh, ro, so);
        past4<E>(e, is_v ? pool.vp : pool.kp, is_v ? pool.vs : pool.ks, ro,
                 so, c4);
      } else if (p - start < length) {
        const int j = p - start;
        load_vec(is_v ? v + j * v_ss + kh * v_sh + c4 * N
                      : k + j * k_ss + kh * k_sh + c4 * N, e);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = 0.f;
      }
    });
    __syncthreads();
    step<HD>(st, sm, c0, scale, softcap,
             [&](int i, int c) { return c <= rb[i] && c >= lb[i]; });
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = R0 + st.rg * 4 + i;
    if (R >= SG) continue;
    float* ob = out + ((long long)(R / G) * Hq + kh * G + R % G) * HD;
#pragma unroll
    for (int d = 0; d < State<HD>::DPT; ++d)
      ob[st.cg + 8 * d] = st.l[i] > 0.f ? st.acc[i][d] / st.l[i] : 0.f;
  }
}

}  // namespace fma

struct Args {
  const void *q, *k, *v;
  Pool pool;
  const int* table;
  void* out;
  float* part;
  int S;
  Bounds bd;
  int n_past_pages, KH, G, span, spans;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale, softcap;
};

template <typename T, typename E, int HD>
int launch(const Args& a, cudaStream_t s) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  const int bytes = (kTC ? tc::Tiles<HD>::bytes : fma::smem_bytes<HD>()) +
                    a.n_past_pages * static_cast<int>(sizeof(int));
  constexpr int threads = kTC ? tc::Tiles<HD>::kThreads : fma::kThreads;
  const void* kern;
  if constexpr (kTC)
    kern = reinterpret_cast<const void*>(tc::chunk_kernel<HD, E>);
  else
    kern = reinterpret_cast<const void*>(fma::chunk_fma_kernel<HD, E>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int SG = a.S * a.G;
  dim3 grid((SG + BQ - 1) / BQ, a.KH, a.spans);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  if constexpr (kTC) {
    tc::chunk_kernel<HD, E><<<grid, threads, bytes, s>>>(
        q, k, v, a.pool, a.table, a.part, a.S, a.bd, a.n_past_pages, a.G,
        a.span, a.q_ss, a.q_sh, a.k_ss, a.k_sh, a.v_ss, a.v_sh, a.scale,
        a.softcap);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    tc::chunk_merge_kernel<HD><<<dim3(SG, a.KH), HD, 0, s>>>(
        a.part, out, a.S, a.bd, a.G, a.span, a.spans);
  } else {
    fma::chunk_fma_kernel<HD, E><<<grid, threads, bytes, s>>>(
        q, k, v, a.pool, a.table, out, a.S, a.bd, a.n_past_pages, a.G,
        a.q_ss, a.q_sh, a.k_ss, a.k_sh, a.v_ss, a.v_sh, a.scale, a.softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E>
int dispatch_hd(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, E, 64>(a, s);
    case 128: return launch<T, E, 128>(a, s);
    case 256: return launch<T, E, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (S, Hq, hd) with strides (q_ss, q_sh, 1); k, v: the raw chunk (S, KH,
// hd) with strides (k_ss, k_sh, 1), (v_ss, v_sh, 1), in q's dtype.  The
// past, of element type `past` (a dtype code): q's; float32 under a
// bfloat16 q (rounded to bf16 as it is staged); or kI8, int8 with k_scale,
// v_scale float32 (..., KH, 1) with strides (s_sp, s_ss, s_sh, 1):
// - buf_len 0: k_pool, v_pool (P, ps, KH, hd) with strides (p_sp, p_ss,
//   p_sh, 1), read through table, the stream's page ids, int32,
//   contiguous, covering positions 0 .. start-1 (n_pages of them);
// - buf_len > 0: the stream's dense rows (buf_len, KH, hd) with strides
//   (p_ss, p_sh, 1) (p_sp, s_sp, ps, n_pages and table unused), position
//   p at slot p % buf_len, resident from start - buf_len.
// window > 0 bounds each query's lookback; softcap > 0 caps the logits.
// out: (S, Hq, hd) contiguous.  bfloat16 (dtype) runs the tensor-core body
// with key spans of `span` positions (a positive multiple of 64), spans =
// ceil((start + length) / span), and part a float32 scratch of
// KH*spans*S*G*(hd+2) elements; float32 runs the FMA body, one span (span
// 0, spans 1, no scratch).  Requires 1 <= length <= S, G >= 1, hd in {64,
// 128, 256} and 16-byte aligned rows.  Returns the CUDA error code.
extern "C" int chunk_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* table, void* out, void* part, int S, int start, int length,
    int n_pages, int ps, int KH, int G, int hd, int span, int spans,
    long long q_ss, long long q_sh, long long k_ss, long long k_sh,
    long long v_ss, long long v_sh, long long p_sp, long long p_ss,
    long long p_sh, long long s_sp, long long s_ss, long long s_sh,
    float scale, float softcap, int window, int buf_len, int dtype,
    int past, void* stream) {
  const bool dense = buf_len > 0;
  const int n_past_pages = dense ? 0 : ps > 0 ? (start + ps - 1) / ps : -1;
  const bool split = dtype == kBF16;
  const int want = split && span > 0 ? (start + length + span - 1) / span : 1;
  if (length < 1 || length > S || start < 0 || KH < 1 || G < 1 ||
      window < 0 || buf_len < 0 || (!dense && (ps < 1 || !table)) ||
      n_past_pages > n_pages || (split ? span < 64 || span % 64 || !part
                                       : span != 0) ||
      spans != want || (past == kI8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bounds bd{start, length, window,
                  dense && start > buf_len ? start - buf_len : 0};
  const Args a{q, k, v,
               Pool{k_pool, v_pool, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), dense ? 0 : p_sp,
                    p_ss, p_sh, dense ? 0 : s_sp, s_ss, s_sh, ps, buf_len},
               static_cast<const int*>(table), out, static_cast<float*>(part),
               S, bd, n_past_pages, KH, G, span, spans,
               q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (past == kBF16) return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, s);
    if (past == kF32) return dispatch_hd<__nv_bfloat16, float>(hd, a, s);
    if (past == kI8) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a, s);
  } else if (dtype == kF32) {
    if (past == kF32) return dispatch_hd<float, float>(hd, a, s);
    if (past == kI8) return dispatch_hd<float, int8_t>(hd, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
