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
// bf16 q/k/v/o, ~440 FLOP/byte, above the card's ~295 for bf16 tensor cores.
//
// The C entry point picks the body by dtype; both skip k tiles wholly past
// the diagonal or wholly before the window and take the last q and k tiles
// ragged: rows past Sq are not stored, keys past Sk are zero-filled and
// masked.  A q tile is 64 rows of one query head.
//
// bfloat16 (`tc` below): FlashAttention-2 on the tensor cores, the tile
// step of flash_tile.cuh (mma.sync, swizzled cp.async stages, two warp
// groups splitting the k tiles, P as bf16 hi + lo; see there).
// - Work: one CTA per (pair of q tiles i and nq-1-i, query head, batch
//   row), so every CTA has the same causal work (192 tiles, 96 CTAs at the
//   serve shape).  Each group has its own ring of three K/V stages (208 KB
//   of shared memory in all at hd 128), so two tiles' copies are in flight
//   while one is computed, and one group's copies overlap the other's
//   math.  Masks are applied only on the tiles that need them (the
//   diagonal, the window's edge, the ragged last tile), from per-row
//   bounds.
//
// float32 (`fma` below): one CTA per (q tile, query head, batch row), the
// FMA step of flash_tile.cuh.  bfloat16 never takes this body.
//
// LSE route (the train mode's forward): with a non-null `lse` (B, Hq, Sq)
// float32, both bodies also write each row's log-sum-exp of its visible
// logits, in natural-log units: the tc body keeps its running max m in
// log2 units (logits prescaled by log2(e), fast_exp2), so it writes
// (m + log2(l)) * ln(2); the fma body writes m + log(l).  A row that sees
// no key gets +inf, so that the backward's exp(s - lse) is 0 there.  The
// backward (flash_attention_bwd.cu) recomputes P = exp(s - lse) in the
// same natural base.  Every serve path passes null.
#include <type_traits>

#include "flash_tile.cuh"

using namespace rt;

namespace {

using namespace rt::flash;

namespace tc {

using namespace rt::flash::tc;

constexpr float kLn2 = 0.6931471805599453f;

// Copy rows r0 .. r0 + R - 1 of a (rows, HD) bf16 matrix with row stride
// ss into a swizzled tile, thread t of n; rows at or past `limit` are
// zero-filled.
template <int HD, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int limit,
                                          int t, int n) {
  using L = Tiles<HD>;
  for (int idx = t; idx < R * L::CPR; idx += n) {
    const int r = idx / L::CPR, ch = idx % L::CPR;
    const bool in = r0 + r < limit;
    cp_async16(dst + L::at(r, ch), in ? src + (r0 + r) * ss + ch * 8 : src,
               in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, int Sq,
             int Sk, int G, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long o_sb, long long o_ss,
             long long o_sh, int causal, int window, float softcap,
             float scale) {
  using L = Tiles<HD>;
  constexpr int BK = L::BK, NS = L::NS, NT = L::NT, DT = L::DT;
  constexpr int KG = L::KG, GT = L::GT;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BQ][HD]
  const int tid = threadIdx.x, grp = tid / GT, gt = tid % GT;
  bf16* Ks = Qs + BQ * HD + grp * 2 * NS * BK * HD;   // the group's [NS][BK][HD]
  bf16* Vs = Ks + NS * BK * HD;                       // the group's [NS][BK][HD]

  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const Lane<HD> w(gt);
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kh * k_sh;
  const bf16* vb = v + b * v_sb + kh * v_sh;
  const float sl2 = scale * kLog2e;

  // q tiles i and nq - 1 - i, one after the other: every CTA has the same
  // causal work
  const int nq = (Sq + BQ - 1) / BQ, pair = blockIdx.x;
  for (int pass = 0; pass < 2; ++pass) {
    const int qt = pass == 0 ? nq - 1 - pair : pair;
    if (pass == 1) {
      if (qt == nq - 1 - pair) break;   // an odd nq's middle tile
      __syncthreads();   // every warp is done with the first tile's smem
    }
    const int q0 = qt * BQ;

    // k tiles that can hold a visible key for some row of this q tile; the
    // group takes tiles grp, grp + KG, ... of them
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;   // exclusive
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int t0 = k_lo / BK;
    const int nt = k_hi > k_lo ? (k_hi - 1) / BK + 1 - t0 : 0;
    const int ng = nt > grp ? (nt - grp + KG - 1) / KG : 0;

    // the group's n-th tile into stage n % NS; one commit group per tile,
    // empty ones included, so that "all but the newest NS - 2 groups" is
    // tile n
    auto load_kv = [&](int n) {
      if (n < ng) {
        const int st = n % NS, c0 = (t0 + grp + n * KG) * BK;
        load_tile<HD, BK>(Ks + st * BK * HD, kb, k_ss, c0, Sk, gt, GT);
        load_tile<HD, BK>(Vs + st * BK * HD, vb, v_ss, c0, Sk, gt, GT);
      }
      cp_async_commit();
    };
    load_tile<HD, BQ>(Qs, qb, q_ss, q0, Sq, tid, L::kThreads);
#pragma unroll
    for (int n = 0; n < NS - 1; ++n) load_kv(n);   // Q rides in the first
    cp_async_wait<NS - 2>();
    __syncthreads();   // Q and each group's first tile are in

    const QFrags<HD> qf(Qs, w);
    State<HD> st;

    for (int n = 0; n < ng; ++n) {
      const int c0 = (t0 + grp + n * KG) * BK;
      if (n > 0) {
        cp_async_wait<NS - 2>();
        // tile n is in, and the group is done with tile n - 1, whose
        // stage the next copies fill
        group_sync<GT>(grp);
      }
      load_kv(n + NS - 1);
      const bool mask = (causal && c0 + BK - 1 > q0) ||
                        (window > 0 && c0 <= q0 + BQ - 1 - window) ||
                        c0 + BK > Sk;
      // scale (log2 domain), softcap, masks
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
          // the visible keys of each of the thread's two rows: [lo, hi]
          int lo[2], hi[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = q0 + w.rw * 16 + w.gq + 8 * i;
            hi[i] = causal ? min(r, Sk - 1) : Sk - 1;
            lo[i] = window > 0 ? r - window + 1 : 0;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + j * 8 + 2 * w.tq + (e & 1);
              if (c < lo[e >> 1] || c > hi[e >> 1]) s[j][e] = kNegInf;
            }
        }
      });
    }
    cp_async_wait<0>();   // no copy outlives this tile

    if (!merge_groups<HD>(st, reinterpret_cast<float*>(Qs + BQ * HD), grp, gt))
      continue;
    if (lse && w.tq == 0 && w.d0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + w.rw * 16 + w.gq + 8 * i;
        if (r < Sq)
          lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + r] =
              st.l[i] > 0.f ? (st.m[i] + log2f(st.l[i])) * kLn2 : INFINITY;
      }
    }
    bf16* ob = out + b * o_sb + h * o_sh + w.d0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + w.rw * 16 + w.gq + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float x = st.l[i] > 0.f ? st.o[d][2 * i] / st.l[i] : 0.f;
        const float y = st.l[i] > 0.f ? st.o[d][2 * i + 1] / st.l[i] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(ob + r * o_ss + d * 8 + 2 * w.tq) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
}

}  // namespace tc

namespace fma {

using namespace rt::flash::fma;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int Sq, int Sk, int G,
             long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh,
             long long o_sb, long long o_ss, long long o_sh,
             int causal, int window, float softcap, float scale) {
  extern __shared__ float4 smem4[];
  const Smem<HD> sm(reinterpret_cast<float*>(smem4));
  constexpr int N = Vec<float>::N;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;

  stage_q<HD>(sm, [&](int r, int dv, float* e) {
    if (q0 + r < Sq) {
      load_vec(qb + (long long)(q0 + r) * q_ss + dv * N, e);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = 0.f;
    }
  });
  State<HD> st;

  // k tiles that can hold a visible key for some row of this q tile
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;        // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int c0 = (k_lo / BK) * BK; c0 < k_hi; c0 += BK) {
    __syncthreads();   // previous tile fully consumed (and Qt written)
    stage_kv<HD>(sm, [&](float* e, bool is_v, int c, int dv) {
      if (c0 + c < Sk) {
        load_vec((is_v ? vb + (long long)(c0 + c) * v_ss
                       : kb + (long long)(c0 + c) * k_ss) + dv * N, e);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = 0.f;
      }
    });
    __syncthreads();
    step<HD>(st, sm, c0, scale, softcap, [&](int i, int c) {
      const int r = q0 + st.rg * 4 + i;
      return c < Sk && (!causal || c <= r) && (window == 0 || c > r - window);
    });
  }

  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + st.rg * 4 + i;
    if (r >= Sq) continue;
    if (lse && st.cg == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + r] =
          st.l[i] > 0.f ? st.m[i] + logf(st.l[i]) : INFINITY;
#pragma unroll
    for (int d = 0; d < State<HD>::DPT; ++d) {
      const float o = st.l[i] > 0.f ? st.acc[i][d] / st.l[i] : 0.f;
      ob[(long long)r * o_ss + st.cg + 8 * d] = o;
    }
  }
}

}  // namespace fma

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int Hq, int G, const long long* st,
           int causal, int window, float softcap, float scale,
           cudaStream_t s) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = kTC ? tc::Tiles<HD>::bytes : fma::smem_bytes<HD>();
  constexpr int threads = kTC ? tc::Tiles<HD>::kThreads : fma::kThreads;
  auto kern = kTC ? reinterpret_cast<const void*>(tc::flash_kernel<HD>)
                  : reinterpret_cast<const void*>(fma::flash_kernel<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + BQ - 1) / BQ;
  dim3 grid(kTC ? (nq + 1) / 2 : nq, Hq, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if constexpr (kTC) {
    tc::flash_kernel<HD><<<grid, threads, bytes, s>>>(
        qt, kt, vt, ot, lse, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], causal, window, softcap,
        scale);
  } else {
    fma::flash_kernel<HD><<<grid, threads, bytes, s>>>(
        qt, kt, vt, ot, lse, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], causal, window, softcap,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int Hq, int G,
                const long long* st, int causal, int window, float softcap,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, Hq, G, st, causal, window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Sq, Hq, hd), k, v: (B, Sk, KH, hd), out: (B, Sq, Hq, hd), each with
// its own element strides (batch, sequence, head; the last dim contiguous,
// 16-byte aligned rows).  hd in {64, 128, 256}.  bfloat16 runs the tensor-
// core body, float32 the FMA body.  lse: null, or (B, Hq, Sq) float32
// contiguous, each row's natural-log log-sum-exp.  Returns the CUDA error
// code.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Sq,
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
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, l, B, Sq, Sk, Hq, G,
                                      st, causal, window, softcap, scale, s);
  if (dtype == kF32)
    return dispatch_hd<float>(hd, q, k, v, out, l, B, Sq, Sk, Hq, G, st,
                              causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
