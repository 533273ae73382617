// Attention tile steps shared by the port's flash-style kernels
// (flash_attention.cu, causal self-attention; chunk_attention.cu, a prompt
// chunk against its page-chain past).  The kernels decide which rows a CTA
// holds, where a key row lives and which keys a row sees; the arithmetic
// on a staged tile is the one body below, so a change to it changes both.
//
// bfloat16 (`tc`): FlashAttention-2 on the tensor cores with mma.sync
// m16n8k16 (bf16 operands, float32 accumulation).
// - A CTA holds BQ = 64 query rows.  Its KG warp groups of 4 warps split
//   the k tiles (group g takes tiles g, g + KG, ...), each walking its own
//   in order with an online softmax, and merge their (m, l, O) at the end
//   in a fixed order, through shared memory, thread by thread (the two
//   groups' threads hold the same fragments).  Each warp owns 16 rows, so
//   the row max and row sum take two quad shuffles.
// - Staging: Q, K and V as bf16 rows whose 16-byte chunks are
//   XOR-swizzled by the row's low 3 bits (`Tiles::at`), read with ldmatrix
//   (.trans for V) without bank conflicts; each group has its own ring of
//   NS K/V stages and one named barrier a tile (`group_sync`).
// - Products: S = Q K^T stays in registers, and so do the probabilities,
//   which are the A operand of P V directly: each p is split into two bf16
//   terms, hi = bf16(p) and lo = bf16(p - hi), and P V is two products, hi
//   V + lo V, so p keeps ~16 significant bits (~2^-17 relative) where the
//   Pallas kernel keeps p in float32.  A single bf16 rounding of p (~2^-9
//   relative) stays inside the bf16 tolerance of 2e-2 but not inside the
//   check that the output is at most one bf16 rounding from the plain
//   version (atol 1e-3 + rtol 1e-2 in chip_smoke.py): rows with few
//   visible keys and an output near 0 miss it by up to 2x
//   (tests/test_torch_split_decode.py mirrors both).  The second product
//   costs half again the tensor-core work.  exp2 is ex2.approx on logits
//   prescaled by log2(e); the caller's hook does the scaling and the mask.
// - hd 256: one group of eight warps, two per 16 rows, both computing the
//   rows' scores and each keeping the output for half of the dims (the
//   float32 accumulators of a whole row would spill); k tiles of 32 keys,
//   two stages, Q fragments re-read from shared memory (held in registers
//   at hd <= 128).
//
// float32 (`fma`): plain float32 FMAs, since tensor cores on float32 mean
// TF32 (~3 decimal digits) and the float32 routes are held to 1e-4 and to
// the CPU run token for token.  128 threads; each holds a 4x8 block of the
// 64 x 64 score tile and a 4 x hd/8 block of the output; tiles are staged
// in shared memory as float32 (Q and K transposed).
#pragma once

#include "common.cuh"

namespace rt {
namespace flash {

constexpr int BQ = 64;   // rows per CTA, in both bodies

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

template <int HD>
struct Tiles {
  static constexpr int KG = HD == 256 ? 1 : 2;     // warp groups
  static constexpr int DS = HD == 256 ? 2 : 1;     // warps per 16 rows
  static constexpr int GT = 128 * DS;              // threads per group
  static constexpr int kThreads = GT * KG;
  static constexpr int DW = HD / DS;               // output dims per warp
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys per k tile
  static constexpr int NS = HD == 256 ? 2 : 3;     // K/V stages per group
  static constexpr int CPR = HD / 8;               // 16-byte chunks per row
  static constexpr int NT = BK / 8;                // score n-tiles of 8 keys
  static constexpr int KS = HD / 16;               // k-steps of Q K^T
  static constexpr int DT = DW / 8;                // output n-tiles per warp
  static constexpr bool kQRegs = HD <= 128;        // Q fragments in registers
  static constexpr int bytes = (BQ + 2 * KG * NS * BK) * HD * 2;   // Q, K, V
  // element offset of 16-byte chunk ch of row r
  static __device__ __forceinline__ int at(int r, int ch) {
    return r * HD + ((ch ^ (r & 7)) << 3);
  }
  // the merge's per-thread state (o, m, l) fits in the K/V stages
  static_assert(KG == 1 || (DW / 2 + 4) * GT * 4 <= 2 * KG * NS * BK * HD * 2,
                "merge state fits");
};

// The GT threads of warp group g meet (named barrier 1 + g).
template <int GT>
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(GT));
}

// A thread's place in the tile, from its index gt in its group: the warp's
// 16 rows (rw) and first output dim (d0), the fragment row gq and column
// pair tq.  Element e of a score or output n-tile is row rw * 16 + gq +
// 8 * (e / 2), column 2 tq + e % 2.
template <int HD>
struct Lane {
  int lane, rw, d0, gq, tq;
  __device__ __forceinline__ explicit Lane(int gt)
      : lane(gt & 31), rw((gt >> 5) % 4), d0(((gt >> 5) / 4) * Tiles<HD>::DW),
        gq(lane >> 2), tq(lane & 3) {}
};

// The A fragments of Q (staged at Qs) for k-step ks: held in registers at
// hd <= 128, re-read from shared memory otherwise.
template <int HD>
struct QFrags {
  using L = Tiles<HD>;
  uint32_t f[L::kQRegs ? L::KS : 1][4];
  const bf16* Qs;
  int a_row, a_ch;   // ldmatrix: lane l gives row l % 8 of tile l / 8
  __device__ __forceinline__ QFrags(const bf16* qs, const Lane<HD>& w)
      : Qs(qs), a_row(w.rw * 16 + (w.lane & 7) + ((w.lane >> 3) & 1) * 8),
        a_ch(w.lane >> 4) {
    if constexpr (L::kQRegs) {
#pragma unroll
      for (int ks = 0; ks < L::KS; ++ks) load(f[ks], ks);
    }
  }
  __device__ __forceinline__ void load(uint32_t (&a)[4], int ks) const {
    ldmatrix_x4(a, Qs + L::at(a_row, 2 * ks + a_ch));
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int ks) const {
    if constexpr (L::kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f[ks][e];
    } else {
      load(a, ks);
    }
  }
};

// A thread's running output o (unnormalised), row max m (log2 domain) and
// row sum l for its two rows.
template <int HD>
struct State {
  float o[Tiles<HD>::DT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  __device__ __forceinline__ State() {
#pragma unroll
    for (int d = 0; d < Tiles<HD>::DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  }
};

// One staged k tile (Kt, Vt): S = Q K^T for the warp's 16 rows and BK
// keys (n-tile j holds keys 8j .. 8j+7 of the tile); logits(s) scales S to
// the log2 domain and masks it (kNegInf); online softmax; O += P V with
// P = hi + lo in bf16 over the warp's dims.
template <int HD, typename Logits>
__device__ __forceinline__ void step(State<HD>& st, const QFrags<HD>& q,
                                     const bf16* Kt, const bf16* Vt,
                                     const Lane<HD>& w, Logits&& logits) {
  using L = Tiles<HD>;
  constexpr int NT = L::NT, KS = L::KS, DT = L::DT, BK = L::BK;
  // Q fragments held in registers need the k-step loop unrolled; re-read
  // ones are loaded two k-steps ahead at most
  constexpr int kUnrollS = L::kQRegs ? KS : 2;
  const int lane = w.lane;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll kUnrollS
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    q.get(a, ks);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + L::at(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                 2 * ks + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], a, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
    }
  }

  logits(s);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(st.m[i], mx[i]);
    // a row with no visible key yet subtracts 0, so its masked logits give
    // 2^-1e30 = 0
    base[i] = m_new == kNegInf ? 0.f : m_new;
    const float corr = fast_exp2(st.m[i] - base[i]);
    st.m[i] = m_new;
    st.l[i] *= corr;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      st.o[d][2 * i] *= corr;
      st.o[d][2 * i + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(s[j][e] - base[e >> 1]);

  // the S fragments of n-tiles 2kk and 2kk+1 are the A fragments of k-step
  // kk of P V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
    st.l[0] += (s[2 * kk][0] + s[2 * kk][1]) + (s[2 * kk + 1][0] + s[2 * kk + 1][1]);
    st.l[1] += (s[2 * kk][2] + s[2 * kk][3]) + (s[2 * kk + 1][2] + s[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(
          vf, Vt + L::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                         (w.d0 >> 3) + 2 * dp + (lane >> 4)));
      mma_bf16(st.o[2 * dp], hi, vf[0], vf[1]);
      mma_bf16(st.o[2 * dp + 1], hi, vf[2], vf[3]);
      mma_bf16(st.o[2 * dp], lo, vf[0], vf[1]);
      mma_bf16(st.o[2 * dp + 1], lo, vf[2], vf[3]);
    }
  }
}

// With two warp groups: group 1's state into group 0's, thread by thread,
// through `red` (the K/V stages, which both groups are done with); every
// thread of the CTA calls it.  True for the threads that carry the rows on
// (all of them with one group).  Then the row sums over the quad.
template <int HD>
__device__ __forceinline__ bool merge_groups(State<HD>& st, float* red,
                                             int grp, int gt) {
  using L = Tiles<HD>;
  constexpr int DT = L::DT, GT = L::GT;
  if constexpr (L::KG == 2) {
    __syncthreads();   // both groups are done with their stages
    if (grp == 1) {
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(d * 4 + e) * GT + gt] = st.o[d][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        red[(DT * 4 + i) * GT + gt] = st.m[i];
        red[(DT * 4 + 2 + i) * GT + gt] = st.l[i];
      }
    }
    __syncthreads();
    if (grp == 1) return false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = red[(DT * 4 + i) * GT + gt];
      const float l1 = red[(DT * 4 + 2 + i) * GT + gt];
      const float mn = fmaxf(st.m[i], m1);
      const float bs = mn == kNegInf ? 0.f : mn;
      const float c0 = fast_exp2(st.m[i] - bs), c1 = fast_exp2(m1 - bs);
      st.l[i] = st.l[i] * c0 + l1 * c1;
      st.m[i] = mn;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        st.o[d][2 * i] = st.o[d][2 * i] * c0 + red[(d * 4 + 2 * i) * GT + gt] * c1;
        st.o[d][2 * i + 1] =
            st.o[d][2 * i + 1] * c0 + red[(d * 4 + 2 * i + 1) * GT + gt] * c1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
  return true;
}

}  // namespace tc

namespace fma {

constexpr int BK = 64, kThreads = 128;
constexpr int PSTR = BK + 1;   // padded row stride of the probability tile

template <int HD>
constexpr int smem_bytes() {
  return (HD * BQ + HD * BK + BK * HD + BQ * PSTR) * static_cast<int>(sizeof(float));
}

// The float32 tiles in shared memory, from `base`.
template <int HD>
struct Smem {
  float* Qt;   // [HD][BQ]
  float* Kt;   // [HD][BK]
  float* Vs;   // [BK][HD]
  float* Ps;   // [BQ][PSTR]
  __device__ __forceinline__ explicit Smem(float* base)
      : Qt(base), Kt(base + HD * BQ), Vs(base + HD * BQ + HD * BK),
        Ps(base + HD * BQ + 2 * HD * BK) {}
  __device__ __forceinline__ float* end() const { return Ps + BQ * PSTR; }
};

// Q into Qt, transposed: row(r, dv, e) fills e with the float32 elements
// dv * 4 .. dv * 4 + 3 of tile row r (zeros for a row past the input).
template <int HD, typename Row>
__device__ __forceinline__ void stage_q(const Smem<HD>& sm, Row&& row) {
  constexpr int N = Vec<float>::N, DV = HD / N;
  for (int idx = threadIdx.x; idx < BQ * DV; idx += kThreads) {
    const int r = idx % BQ, dv = idx / BQ;
    float e[N];
    row(r, dv, e);
#pragma unroll
    for (int i = 0; i < N; ++i) sm.Qt[(dv * N + i) * BQ + r] = e[i];
  }
}

// A k tile into Kt (transposed) and Vs: row(e, is_v, c, dv) fills e with
// elements dv * 4 .. of key c of the tile, K or V (zeros for a key past
// the input).
template <int HD, typename Row>
__device__ __forceinline__ void stage_kv(const Smem<HD>& sm, Row&& row) {
  constexpr int N = Vec<float>::N, DV = HD / N;
  const int t = threadIdx.x;
  for (int idx = t; idx < BK * DV; idx += kThreads) {
    const int c = idx % BK, dv = idx / BK;
    float e[N];
    row(e, false, c, dv);
#pragma unroll
    for (int i = 0; i < N; ++i) sm.Kt[(dv * N + i) * BK + c] = e[i];
  }
  for (int idx = t; idx < BK * DV; idx += kThreads) {
    const int dv = idx % DV, c = idx / DV;
    float e[N];
    row(e, true, c, dv);
#pragma unroll
    for (int i = 0; i < N; ++i) sm.Vs[c * HD + dv * N + i] = e[i];
  }
}

// A thread's running state for its rows rg * 4 + i of the tile and its
// dims cg + 8 d.
template <int HD>
struct State {
  static constexpr int DPT = HD / 8;   // output dims per thread
  float m[4], l[4], acc[4][DPT];
  int rg, cg;
  __device__ __forceinline__ State() : rg(threadIdx.x / 8), cg(threadIdx.x % 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
    }
  }
};

// One staged k tile whose key c sits at c0 + c: S on the thread's 4x8
// block, each logit times scale, soft-capped (tanh) when softcap > 0, kept
// where visible(i, key) for the thread's row i; online softmax (the 8
// threads of a row group are lanes differing in their low 3 bits); P
// through shared memory; O += P V.
template <int HD, typename Visible>
__device__ __forceinline__ void step(State<HD>& st, const Smem<HD>& sm,
                                     int c0, float scale, float softcap,
                                     Visible&& visible) {
  constexpr int DPT = State<HD>::DPT;
  const int rg = st.rg, cg = st.cg;
  float s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(&sm.Qt[d * BQ + rg * 4]);
    const float4 ka = *reinterpret_cast<const float4*>(&sm.Kt[d * BK + cg * 8]);
    const float4 kc = *reinterpret_cast<const float4*>(&sm.Kt[d * BK + cg * 8 + 4]);
    const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
    const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool ok[8];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = s[i][j] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      ok[j] = visible(i, c0 + cg * 8 + j);
      s[i][j] = ok[j] ? x : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m[i], mx);
    const float corr = expf(st.m[i] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      sm.Ps[(rg * 4 + i) * PSTR + cg * 8 + j] = p;
      ps += p;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    st.l[i] = st.l[i] * corr + ps;
    st.m[i] = m_new;
#pragma unroll
    for (int d = 0; d < DPT; ++d) st.acc[i][d] *= corr;
  }
  __syncthreads();

  for (int c = 0; c < BK; ++c) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = sm.Ps[(rg * 4 + i) * PSTR + c];
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const float vv = sm.Vs[c * HD + cg + 8 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[i][d] += pr[i] * vv;
    }
  }
}

}  // namespace fma
}  // namespace flash
}  // namespace rt
