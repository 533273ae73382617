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
// bfloat16 (`tc` below): FlashAttention-2 on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, float32 accumulation).
// - Work: one CTA per (pair of q tiles i and nq-1-i, query head, batch
//   row), so every CTA has the same causal work (192 tiles, 96 CTAs at the
//   serve shape).  Its two warp groups of 4 warps split each q tile's k
//   tiles (group g takes tiles g, g+2, ...), each walking its own in order
//   with an online softmax, and merge their (m, l, O) at the end in a
//   fixed order, through shared memory, thread by thread (the two groups'
//   threads hold the same fragments).  Each warp owns 16 query rows, so
//   the row max and row sum take two quad shuffles.  Masks are applied
//   only on the tiles that need them (the diagonal, the window's edge, the
//   ragged last tile), from per-row bounds.
// - Staging: Q, K and V as bf16, copied by 16-byte cp.async into rows
//   whose 16-byte chunks are XOR-swizzled by the row's low 3 bits, read
//   with ldmatrix (.trans for V) without bank conflicts.  Each group has
//   its own ring of three K/V stages (208 KB of shared memory in all at hd
//   128) and one named barrier a tile, so two tiles' copies are in flight
//   while one is computed, and one group's copies overlap the other's
//   math.
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
//   prescaled by log2(e).
// - hd 256: one group of eight warps, two per 16 query rows, both
//   computing the rows' scores and each keeping the output for half of
//   the dims (the float32 accumulators of a whole row would spill); k
//   tiles of 32 keys, two stages, Q fragments re-read from shared memory
//   (held in registers at hd <= 128).
//
// float32 (`fma` below): one CTA per (q tile, query head, batch row) with
// plain float32 FMAs, since tensor cores on float32 mean TF32 (~3 decimal
// digits) and the float32 route is the one held to 1e-4 and to the CPU run
// token for token.  Each thread holds a 4x8 block of the score tile and a
// 4 x hd/8 block of the output; tiles are staged in shared memory as
// float32 (Q and K transposed).  bfloat16 never takes this body.
#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 64;   // query rows per CTA, in both bodies

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

template <int HD>
struct Tiles {
  // KG warp groups split a q tile's k tiles (group g takes tiles g, g + KG,
  // ...) and merge at the end; at hd 256 one group of eight warps, two per
  // 16 query rows, each keeping the output for half of the dims
  static constexpr int KG = HD == 256 ? 1 : 2;
  static constexpr int DS = HD == 256 ? 2 : 1;
  static constexpr int GT = 128 * DS;              // threads per group
  static constexpr int kThreads = GT * KG;
  static constexpr int DW = HD / DS;               // output dims per warp
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys per k tile
  static constexpr int NS = HD == 256 ? 2 : 3;     // K/V stages per group
  static constexpr int CPR = HD / 8;               // 16-byte chunks per row
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

// The GT threads of warp group g meet (named barrier 1 + g).
template <int GT>
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(GT));
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
             int Sk, int G, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long o_sb, long long o_ss,
             long long o_sh, int causal, int window, float softcap,
             float scale) {
  using L = Tiles<HD>;
  constexpr int BK = L::BK, NS = L::NS, NT = BK / 8, KS = HD / 16;
  constexpr int KG = L::KG, GT = L::GT;
  constexpr int DT = L::DW / 8;   // output n-tiles of 8 dims per warp
  // Q fragments held in registers need the k-step loop unrolled; re-read
  // ones are loaded two k-steps ahead at most
  constexpr int kUnrollS = L::kQRegs ? KS : 2;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BQ][HD]
  const int tid = threadIdx.x, grp = tid / GT, gt = tid % GT;
  bf16* Ks = Qs + BQ * HD + grp * 2 * NS * BK * HD;   // the group's [NS][BK][HD]
  bf16* Vs = Ks + NS * BK * HD;                       // the group's [NS][BK][HD]

  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int lane = tid & 31, wg = gt >> 5;       // warp in the group
  const int rw = wg % 4, d0 = (wg / 4) * L::DW;  // the warp's rows and dims
  const int gq = lane >> 2, tq = lane & 3;       // fragment row, column pair
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

    // ldmatrix row addresses: lane l gives row l % 8 of tile l / 8
    const int a_row = rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_ch = lane >> 4;
    auto load_q = [&](uint32_t (&a)[4], int ks) {
      ldmatrix_x4(a, Qs + L::at(a_row, 2 * ks + a_ch));
    };
    uint32_t qf[L::kQRegs ? KS : 1][4];
    if constexpr (L::kQRegs) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_q(qf[ks], ks);
    }
    float o[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

    for (int n = 0; n < ng; ++n) {
      const int c0 = (t0 + grp + n * KG) * BK;
      if (n > 0) {
        cp_async_wait<NS - 2>();
        // tile n is in, and the group is done with tile n - 1, whose
        // stage the next copies fill
        group_sync<GT>(grp);
      }
      load_kv(n + NS - 1);
      const bf16* Kt = Ks + (n % NS) * BK * HD;
      const bf16* Vt = Vs + (n % NS) * BK * HD;

      // S = Q K^T: the warp's 16 rows x BK keys, n-tile j holds keys
      // 8j..8j+7
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll kUnrollS
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if constexpr (L::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
        } else {
          load_q(a, ks);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + L::at(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                     2 * ks + ((lane >> 3) & 1)));
          mma_bf16(s[2 * np], a, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
        }
      }

      // scale (log2 domain), softcap, masks, online softmax; element e of
      // n-tile j is row gq + 8 * (e / 2), key 8j + 2 tq + e % 2
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
      if ((causal && c0 + BK - 1 > q0) ||
          (window > 0 && c0 <= q0 + BQ - 1 - window) || c0 + BK > Sk) {
        // the visible keys of each of the thread's two rows: [lo, hi]
        int lo[2], hi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = q0 + rw * 16 + gq + 8 * i;
          hi[i] = causal ? min(r, Sk - 1) : Sk - 1;
          lo[i] = window > 0 ? r - window + 1 : 0;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * tq + (e & 1);
            if (c < lo[e >> 1] || c > hi[e >> 1]) s[j][e] = kNegInf;
          }
      }
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
        const float m_new = fmaxf(m[i], mx[i]);
        // a row with no visible key yet subtracts 0, so its masked logits
        // give 2^-1e30 = 0
        base[i] = m_new == kNegInf ? 0.f : m_new;
        const float corr = fast_exp2(m[i] - base[i]);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][2 * i] *= corr;
          o[d][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(s[j][e] - base[e >> 1]);

      // O += P V with P = hi + lo in bf16 (the S fragments of n-tiles 2kk
      // and 2kk+1 are the A fragments of k-step kk), over the warp's dims
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
        l[0] += (s[2 * kk][0] + s[2 * kk][1]) + (s[2 * kk + 1][0] + s[2 * kk + 1][1]);
        l[1] += (s[2 * kk][2] + s[2 * kk][3]) + (s[2 * kk + 1][2] + s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, Vt + L::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             (d0 >> 3) + 2 * dp + (lane >> 4)));
          mma_bf16(o[2 * dp], hi, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], hi, vf[2], vf[3]);
          mma_bf16(o[2 * dp], lo, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], lo, vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();   // no copy outlives this tile

    if constexpr (KG == 2) {
      // merge: group 1's state, thread by thread (the two groups' threads
      // hold the same fragments), into group 0 in the K/V stages
      float* red = reinterpret_cast<float*>(Qs + BQ * HD);   // [value][GT]
      __syncthreads();   // both groups are done with their stages
      if (grp == 1) {
#pragma unroll
        for (int d = 0; d < DT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(d * 4 + e) * GT + gt] = o[d][e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          red[(DT * 4 + i) * GT + gt] = m[i];
          red[(DT * 4 + 2 + i) * GT + gt] = l[i];
        }
      }
      __syncthreads();
      if (grp == 1) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = red[(DT * 4 + i) * GT + gt];
        const float l1 = red[(DT * 4 + 2 + i) * GT + gt];
        const float mn = fmaxf(m[i], m1);
        const float bs = mn == kNegInf ? 0.f : mn;
        const float c0 = fast_exp2(m[i] - bs), c1 = fast_exp2(m1 - bs);
        l[i] = l[i] * c0 + l1 * c1;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][2 * i] = o[d][2 * i] * c0 + red[(d * 4 + 2 * i) * GT + gt] * c1;
          o[d][2 * i + 1] =
              o[d][2 * i + 1] * c0 + red[(d * 4 + 2 * i + 1) * GT + gt] * c1;
        }
      }
    }

    bf16* ob = out + b * o_sb + h * o_sh + d0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = q0 + rw * 16 + gq + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float lo = l[i] > 0.f ? o[d][2 * i] / l[i] : 0.f;
        const float hi = l[i] > 0.f ? o[d][2 * i + 1] / l[i] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(ob + r * o_ss + d * 8 + 2 * tq) =
            __floats2bfloat162_rn(lo, hi);
      }
    }
  }
}

}  // namespace tc

namespace fma {

constexpr int BK = 64, kThreads = 128;
constexpr int PSTR = BK + 1;   // padded row stride of the probability tile

template <int HD>
constexpr int smem_bytes() {
  return (HD * BQ + HD * BK + BK * HD + BQ * PSTR) * static_cast<int>(sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
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

  constexpr int N = Vec<float>::N;
  constexpr int DV = HD / N;     // 16-byte vectors per row
  constexpr int DPT = HD / 8;    // output dims per thread
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int t = threadIdx.x, rg = t / 8, cg = t % 8;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;

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

  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const float o = l[i] > 0.f ? acc[i][d] / l[i] : 0.f;
      ob[(long long)r * o_ss + cg + 8 * d] = o;
    }
  }
}

}  // namespace fma

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int G, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t s) {
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
        qt, kt, vt, ot, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], causal, window, softcap,
        scale);
  } else {
    fma::flash_kernel<HD><<<grid, threads, bytes, s>>>(
        qt, kt, vt, ot, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], causal, window, softcap,
        scale);
  }
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
// 16-byte aligned rows).  hd in {64, 128, 256}.  bfloat16 runs the tensor-
// core body, float32 the FMA body.  Returns the CUDA error code.
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
