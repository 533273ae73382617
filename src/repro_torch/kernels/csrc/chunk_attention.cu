// Chunked-prefill attention for Hopper: one stream's prompt chunk against
// [its past | the raw chunk], the past read straight from where it lives:
// the paged pool through the stream's page-table row, or the stream's row
// of a dense cache, which is a ring buffer when it is shorter than the
// context.
//
// Replaces: the chunk mode of src/repro/models/transformer.py::_apply_attn
// (:311; XLA attention over the gathered, dequantized past concatenated
// with the chunk's own K/V; no Pallas kernel).  Query i of the chunk sits
// at position start + i.  Key positions below start are the past:
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
// Bound on the H100: operations, 4 hd FLOP per head and visible (query,
// key) pair against each input read once: the paged burst (256 queries at
// 512, 12:2, hd 128) ~1 GFLOP over ~1.6 MB (0.00101 ms); gemma2's
// 4096-query chunks (16:8, hd 256) 137-412 GFLOP (0.139-0.417 ms).
//
// Rows.  The G query heads of a kv head are packed into one tile: row R of
// kv head kh is query R / G, head kh * G + R % G, so a tile holds every
// head of consecutive queries (G need not divide 64: a query may straddle
// two tiles), each K/V tile is staged once for all of them, and a tile's
// rows have nearly the same bounds.
//
// bfloat16 q (`wg` below): a warp-specialised CTA of three warp groups.
// - The producer group (40 registers a thread after setmaxnreg) walks the
//   CTA's k tiles (64 key positions, 32 at hd 256, counted from position
//   0) into a ring of 4 shared-memory stages, each guarded by a full and
//   an empty mbarrier.  Its thread 0 loads a tile with TMA:
//   a chunk tile from a 3-d map over the raw chunk whose key extent is
//   `length` (pads come back as TMA's zeros); a bf16 dense-row tile from a
//   3-d map over (buf_len, KH, hd); a bf16 pool tile from a 4-d map over
//   (P, ps, KH, hd), one box per page of the kv head (the page ids staged
//   in shared memory from the table).  The maps are encoded on the host at
//   each launch (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint)
//   and passed as __grid_constant__ parameters.  An int8 past comes in as
//   raw bytes by the same boxes (unswizzled) into one of two raw slots,
//   its scales by cp.async; a tile TMA cannot take (it holds both past and
//   chunk rows, it wraps the ring, or its pages are not a multiple of 8
//   rows) comes in by the group's threads: chunk and bf16 past rows by
//   cp.async into the stage, int8 rows into the raw slot.  The next tile's
//   copies are started before this one is finished.  The group's threads
//   then round the raw rows to bf16 into the stage with dequantize_kv's
//   arithmetic (int8 x scale in float32, rounded once).  A float32 past is
//   staged and rounded once (a cast) a tile at a time, K then V.  So an
//   int8 or float32 launch equals the bf16 one on the dequantized or cast
//   past, bit for bit.  Stages hold 128-byte-swizzled sub-tiles of 64
//   dims (hopper.cuh).
// - Two consumer groups (232 registers) each own 64 packed rows (at hd
//   256 both own the same 64 rows and each half of the output dims).  Q
//   is loaded once per CTA with ordinary loads (G = 6 does not divide a
//   tile).  S = Q K^T is a wgmma with Q and K read from
//   shared memory through descriptors of TMA's swizzle; the probabilities
//   stay in registers and are split into bf16 hi + lo (see flash_tile.cuh:
//   one bf16 rounding of p would miss the one-rounding bar), the A
//   operands of two wgmmas against V read MN-major from the stage.
// - Spans.  A row's keys are cut into spans of `span` positions counted
//   from 0 (the wrapper's constant SPAN, never derived from the chunk, the
//   chain or the card).  Each span is an online softmax from a fresh (m,
//   l, acc), then folded into the row's running state (fold_weights,
//   fold) in span order, spans with no visible key skipped.  Where the
//   row tiles fill the card (the wrapper's rule, from the chunk's shape)
//   a CTA walks all its spans and folds them in registers: one launch, no
//   scratch.  Where they do not (the serve burst's 24 CTAs), the spans are
//   split over CTAs (grid z), each writes its float32 partial, and
//   chunk_merge_kernel folds them with the same operations in the same
//   order, so a row's bits are the same on either route.  k tiles wholly
//   outside a CTA's rows' bounds are skipped (a fully masked tile leaves
//   the state's bits as they are), and only tiles that reach past a row's
//   bound are masked.  A row's bits depend only on its keys, its bounds and
//   the span: not on the page ids, the pool, the chain's tail, the ring's
//   other slots, the route, the grid or the run.
//
// float32 q (`fma` below): the FMA step of flash_tile.cuh with the same
// rows, sources and bounds (an int8 past dequantized to float32), one span.
#include <type_traits>

#include "flash_tile.cuh"
#include "hopper.cuh"

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

namespace wg {

using bf16 = __nv_bfloat16;
using namespace rt::hopper;
constexpr float kLog2e = 1.4426950408889634f;

// The CTA's shape.  A consumer warp group owns 64 packed rows; at hd 256
// both groups hold the same 64 rows, each the output of half the dims (the
// float32 accumulators of a whole row, twice over for the span state and
// the folded state, would not fit in registers), and both compute the
// rows' scores.
template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys per k tile
  static constexpr int NC = 2;                      // consumer warp groups
  static constexpr int DS = HD == 256 ? 2 : 1;      // groups sharing 64 rows
  static constexpr int RT = 64 * NC / DS;           // rows per CTA
  static constexpr int DW = HD / DS;                // output dims per group
  static constexpr int NS = 4;                      // K/V stages
  // registers a thread after setmaxnreg: the producer group, the consumers
  // (128 x 40 + 256 x 232 = the 65536 of an SM)
  static constexpr int kProdRegs = 40;
  static constexpr int kConsRegs = 232;
  static constexpr int NT = BK / 8;                 // score n8 blocks
  static constexpr int DT = DW / 8;                 // output n8 blocks
  static constexpr int CPR = HD / 8;                // 16-byte chunks per row
  static constexpr int kThreads = 128 * (1 + NC);
  static constexpr int TILE = BK * HD;              // elements of a K or V tile
  static constexpr int QE = RT * HD;                // elements of Q
  // the producer's staging of raw past rows: two slots of a tile's int8 K
  // and V with their scales (one tile staged while the last is converted),
  // or one tile's float32 K or V
  static constexpr int kI8Slot = 2 * BK * HD + 2 * BK * 4;
  template <typename E>
  __host__ __device__ static constexpr int raw_bytes() {
    return std::is_same<E, bf16>::value ? 0
           : std::is_same<E, float>::value ? BK * HD * 4
                                            : 2 * kI8Slot;
  }
  // Q | K stages | V stages | raw staging | full, empty and raw barriers;
  // then the page ids (1024 bytes of slack align the base)
  template <typename E>
  __host__ __device__ static constexpr int bytes() {
    return 1024 + (QE + 2 * NS * TILE) * 2 + raw_bytes<E>() + (2 * NS + 2) * 8;
  }
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, 1);
  else wgmma_ss_n64(d, da, db, 1);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// One more span partial (ms, ls, xs: its row max, row sum and one output
// element) into the running (m, l, x): the same operations, in the same
// order, in the fold route's registers and in chunk_merge_kernel, so both
// routes give the same bits.  The caller skips a partial with ls == 0.
__device__ __forceinline__ void fold_weights(float m, float ms, float& mn,
                                             float& ca, float& cb) {
  mn = fmaxf(m, ms);
  ca = fast_exp2(m - mn);
  cb = fast_exp2(ms - mn);
}
__device__ __forceinline__ float fold(float x, float ca, float xs, float cb) {
  return __fadd_rn(__fmul_rn(x, ca), __fmul_rn(xs, cb));
}
__device__ __forceinline__ float normalise(float acc, float l) {
  return l > 0.f ? __fdiv_rn(acc, l) : 0.f;
}

// A k tile of a float32 past, K then V, by the producer group's 128
// threads (pt its thread) into the stages kd and vd, swizzled as TMA lays
// a tile out: a chunk row (zeros past length) by a 16-byte cp.async, a
// past row as raw bytes into `raw`, then rounded once to bf16 (a cast's
// arithmetic).
template <int HD>
__device__ __forceinline__ void stage_f32_tile(bf16* kd, bf16* vd, uint8_t* raw,
                                               int c0, const bf16* k,
                                               const bf16* v, long long k_ss,
                                               long long k_sh, long long v_ss,
                                               long long v_sh, const Pool& pool,
                                               const int* pages, int kh,
                                               int start, int length, int pt) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, CPR = C::CPR;
  float* fr = reinterpret_cast<float*>(raw);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    named_sync<128>(2);   // the last round's raw is converted
#pragma unroll 1
    for (int idx = pt; idx < BK * CPR; idx += 128) {
      const int r = idx / CPR, ch = idx % CPR, p = c0 + r;
      bf16* d = (h ? vd : kd) + swz(BK, r, ch);
      if (p >= start) {
        const int j = p - start;
        const bool in = j < length;
        const bf16* row = h ? v + j * v_ss + kh * v_sh : k + j * k_ss + kh * k_sh;
        cp_async16(d, in ? row + ch * 8 : k, in ? 16 : 0);
      } else {
        long long ro, so;
        pool.locate(pages, p, kh, ro, so);
        const float* s = static_cast<const float*>(h ? pool.vp : pool.kp) + ro + ch * 8;
        cp_async16(fr + r * HD + ch * 8, s);
        cp_async16(fr + r * HD + ch * 8 + 4, s + 4);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_sync<128>(2);   // every thread's raw bytes have landed
#pragma unroll 1
    for (int idx = pt; idx < BK * CPR; idx += 128) {
      const int r = idx / CPR, ch = idx % CPR;
      if (c0 + r < start)
        round8_bf16((h ? vd : kd) + swz(BK, r, ch), fr + r * HD + ch * 8);
    }
  }
  fence_async_smem();
}

// The bf16 route: grid (row tiles, KH, 1) folds every span in registers
// and writes the output (part null); grid (row tiles, KH, spans) writes
// span blockIdx.z's float32 partial (part) for chunk_merge_kernel.
// Thread group 0 is the producer (TMA, or its threads for the tiles TMA
// cannot take), groups 1 .. NC the consumers.  The TMA maps: the raw chunk
// (kc, vc: 3-d over (length, KH, hd)), the past (kp, vp: 3-d over
// (buf_len, KH, hd) for a dense row, tma_past 1; 4-d over (P, ps, KH, hd),
// boxes of hb rows, for a pool, tma_past 2; unused with tma_past 0).
template <int HD, typename E>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
chunk_kernel(__grid_constant__ const CUtensorMap kc_map,
             __grid_constant__ const CUtensorMap vc_map,
             __grid_constant__ const CUtensorMap kp_map,
             __grid_constant__ const CUtensorMap vp_map,
             const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, Pool pool,
             const int* __restrict__ table, bf16* __restrict__ out,
             float* __restrict__ part, int S, Bounds bd, int n_past_pages,
             int G, int span, int tma_past, int hb, long long q_ss,
             long long q_sh, long long k_ss, long long k_sh, long long v_ss,
             long long v_sh, float scale, float softcap) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NS = C::NS, NT = C::NT, DT = C::DT, CPR = C::CPR;
  constexpr int RT = C::RT, DW = C::DW, NC = C::NC, TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + C::QE;
  bf16* Vs = Ks + NS * TILE;
  uint8_t* raw = reinterpret_cast<uint8_t*>(Vs + NS * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + C::template raw_bytes<E>());
  uint64_t* empty = full + NS;
  uint64_t* rawbar = empty + NS;   // the producer's two raw slots
  int* pages = reinterpret_cast<int*>(rawbar + 2);

  const int kh = blockIdx.y, KH = gridDim.y, SG = S * G, R0 = blockIdx.x * RT;
  const int start = bd.start, length = bd.length;
  const bool split = part != nullptr;
  // the keys this CTA takes: its spans between the lowest lower bound and
  // the highest upper bound of its rows (k tiles wholly outside them would
  // leave every row's state as it is); the lowest upper and highest lower
  // bounds decide which k tiles need a mask
  const int i_first = R0 / G, i_last = (min(R0 + RT, SG) - 1) / G;
  const int k_hi = bd.hi(i_last) + 1, hi_min = bd.hi(i_first);
  const int lo_min = bd.lo(i_first), lo_max = bd.lo(i_last);
  // its k tiles, t0 .. t0 + nt - 1: every span from lo_min's (fold), or
  // span blockIdx.z's part of [lo_min, k_hi) (split)
  const int key_lo = split ? max(int(blockIdx.z) * span, lo_min) : lo_min;
  const int key_hi = split ? min(k_hi, int(blockIdx.z) * span + span) : k_hi;
  if (split && key_hi <= key_lo) return;   // the whole CTA: nothing visible
  const int t0 = key_lo / BK;
  const int nt = key_hi > key_lo ? (key_hi - 1) / BK + 1 - t0 : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], NC * 128);
    }
    mbar_init(&rawbar[0], 1);
    mbar_init(&rawbar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: the k tiles in order into the ring of stages ------------
    regs_dec<C::kProdRegs>();
    constexpr bool kBF = std::is_same<E, bf16>::value;
    constexpr bool kI8 = std::is_same<E, int8_t>::value;
    const int pt = threadIdx.x;
    for (int i = pt; i < n_past_pages; i += 128) pages[i] = table[i];
    named_sync<128>(2);
    // A tile is staged by TMA boxes into its stage (the chunk, a bf16
    // past), or by the group's threads: issue() starts its copies (TMA of
    // an int8 past's raw bytes into a raw slot, cp.async of scales, of
    // rows TMA cannot take), finish() waits for them, converts the raw
    // rows and marks the stage full.  Tile n + 1 is issued before tile n
    // is finished, so its copies fly while tile n is converted.
    struct Tile {
      int c0, st, slot, par;
      bool thread;
    };
    int nr = 0;   // tiles staged by the threads so far
    auto issue = [&](int n) {
      Tile tl{(t0 + n) * BK, n % NS, 0, 0, false};
      const int c0 = tl.c0, st = tl.st;
      mbar_wait(&empty[st], ((n / NS) & 1) ^ 1);
      bf16* kd = Ks + st * TILE;
      bf16* vd = Vs + st * TILE;
      const bool boxed =
          c0 + BK <= start &&
          (tma_past == 2 ||
           (tma_past == 1 && c0 % pool.buf_len + BK <= pool.buf_len));
      if (c0 >= start || (kBF && boxed)) {
        if (pt == 0) {
          mbar_arrive_tx(&full[st], 2 * TILE * 2);
#pragma unroll 1
          for (int c = 0; c < HD / 64; ++c) {
            bf16* kc = kd + c * BK * 64;
            bf16* vc = vd + c * BK * 64;
            if (c0 >= start) {
              tma_load_3d(kc, &kc_map, &full[st], c * 64, kh, c0 - start);
              tma_load_3d(vc, &vc_map, &full[st], c * 64, kh, c0 - start);
            } else if (tma_past == 1) {
              const int slot = c0 % pool.buf_len;
              tma_load_3d(kc, &kp_map, &full[st], c * 64, kh, slot);
              tma_load_3d(vc, &vp_map, &full[st], c * 64, kh, slot);
            } else {
#pragma unroll 1
              for (int b = 0; b < BK; b += hb) {
                const int p = c0 + b, pg = pages[p / pool.ps];
                tma_load_4d(kc + b * 64, &kp_map, &full[st], c * 64, kh,
                            p % pool.ps, pg);
                tma_load_4d(vc + b * 64, &vp_map, &full[st], c * 64, kh,
                            p % pool.ps, pg);
              }
            }
          }
        } else {
          mbar_arrive(&full[st]);
        }
        cp_async_commit();   // one group a tile, empty here
        return tl;
      }
      if constexpr (!kBF && !kI8) {
        // float32 past rows: staged and converted now, K then V
        stage_f32_tile<HD>(kd, vd, raw, c0, k, v, k_ss, k_sh, v_ss, v_sh,
                           pool, pages, kh, start, length, pt);
        mbar_arrive(&full[st]);
        cp_async_commit();
        return tl;
      }
      tl.thread = true;
      tl.slot = nr & 1;
      tl.par = (nr >> 1) & 1;
      ++nr;
      uint8_t* rs = raw + tl.slot * C::kI8Slot;
      named_sync<128>(2);   // the slot's last tile is converted
      const bool raw_tma = kI8 && boxed;
      if (pt == 0) {
        if (raw_tma) {
          mbar_arrive_tx(&rawbar[tl.slot], 2 * BK * HD);
          if (tma_past == 1) {
            const int slot = c0 % pool.buf_len;
            tma_load_3d(rs, &kp_map, &rawbar[tl.slot], 0, kh, slot);
            tma_load_3d(rs + BK * HD, &vp_map, &rawbar[tl.slot], 0, kh, slot);
          } else {
#pragma unroll 1
            for (int b = 0; b < BK; b += hb) {
              const int p = c0 + b, pg = pages[p / pool.ps];
              tma_load_4d(rs + b * HD, &kp_map, &rawbar[tl.slot], 0, kh,
                          p % pool.ps, pg);
              tma_load_4d(rs + (BK + b) * HD, &vp_map, &rawbar[tl.slot], 0,
                          kh, p % pool.ps, pg);
            }
          }
        } else {
          mbar_arrive(&rawbar[tl.slot]);
        }
      }
      constexpr int N = BK * CPR;
#pragma unroll 1
      for (int idx = pt; idx < 2 * N; idx += 128) {
        const int h = idx / N, r = (idx % N) / CPR, ch = idx % CPR;
        const int p = c0 + r;
        bf16* d = (h ? vd : kd) + swz(BK, r, ch);
        if (p >= start) {
          const int j = p - start;
          const bool in = j < length;
          const bf16* row = h ? v + j * v_ss + kh * v_sh : k + j * k_ss + kh * k_sh;
          cp_async16(d, in ? row + ch * 8 : k, in ? 16 : 0);
        } else if (!raw_tma) {
          long long ro, so;
          pool.locate(pages, p, kh, ro, so);
          const void* pp = h ? pool.vp : pool.kp;
          if constexpr (kI8)
            cp_async8(rs + (h * BK + r) * HD + ch * 8,
                      static_cast<const int8_t*>(pp) + ro + ch * 8);
          else
            cp_async16(d, static_cast<const bf16*>(pp) + ro + ch * 8);
        }
      }
      if constexpr (kI8) {
#pragma unroll 1
        for (int i = pt; i < 2 * BK; i += 128) {
          const int p = c0 + i % BK;
          if (p >= start) continue;
          long long ro, so;
          pool.locate(pages, p, kh, ro, so);
          cp_async4(rs + 2 * BK * HD + i * 4, (i < BK ? pool.ks : pool.vs) + so);
        }
      }
      cp_async_commit();
      return tl;
    };
    auto finish = [&](const Tile& tl, bool last) {
      if (!tl.thread) return;
      mbar_wait(&rawbar[tl.slot], tl.par);
      if (last) cp_async_wait<0>();
      else cp_async_wait<1>();
      named_sync<128>(2);   // every thread's copies have landed
      if constexpr (kI8) {
        const uint8_t* rs = raw + tl.slot * C::kI8Slot;
        constexpr int N = BK * CPR;
#pragma unroll 1
        for (int idx = pt; idx < 2 * N; idx += 128) {
          const int h = idx / N, r = (idx % N) / CPR, ch = idx % CPR;
          if (tl.c0 + r >= start) continue;
          bf16* d = (h ? Vs : Ks) + tl.st * TILE + swz(BK, r, ch);
          const int2 b =
              *reinterpret_cast<const int2*>(rs + (h * BK + r) * HD + ch * 8);
          const float sc =
              reinterpret_cast<const float*>(rs + 2 * BK * HD)[h * BK + r];
          float e[8];
          widen_i8(b.x, e);
          widen_i8(b.y, e + 4);
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 hv =
                __floats2bfloat162_rn(e[2 * i] * sc, e[2 * i + 1] * sc);
            w[i] = *reinterpret_cast<const uint32_t*>(&hv);
          }
          *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      fence_async_smem();
      mbar_arrive(&full[tl.st]);
    };
    if (nt > 0) {
      Tile cur = issue(0);
      for (int n = 0; n < nt; ++n) {
        const bool more = n + 1 < nt;
        const Tile nxt = more ? issue(n + 1) : cur;
        finish(cur, !more);
        cur = nxt;
      }
    }
  } else {
    // -- consumers: S = Q K^T and O += P V on wgmma, spans folded ---------
    regs_inc<C::kConsRegs>();
    const int cg = threadIdx.x / 128 - 1, ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, gq = lane / 4, tq = lane % 4;
    const int rbase = C::DS == 1 ? cg * 64 : 0;
    const int dbase = C::DS == 1 ? 0 : cg * DW;
    // Q: row R is query R / G of head kh * G + R % G; rows past S * G zero
#pragma unroll 1
    for (int idx = threadIdx.x - 128; idx < RT * CPR; idx += NC * 128) {
      const int r = idx / CPR, ch = idx % CPR, R = R0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (R < SG)
        val = *reinterpret_cast<const uint4*>(
            q + (R / G) * q_ss + (kh * G + R % G) * q_sh + ch * 8);
      *reinterpret_cast<uint4*>(Qs + (r / 64) * 64 * HD + swz(64, r % 64, ch)) =
          val;
    }
    fence_async_smem();
    named_sync<NC * 128>(1);
    const bf16* Qg = Qs + (rbase / 64) * 64 * HD;
    const float sl2 = scale * kLog2e;
    // the bounds of the thread's two rows
    int rb[2], lb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = (R0 + rbase + warp * 16 + gq + 8 * i) / G;
      rb[i] = bd.hi(qi);
      lb[i] = bd.lo(qi);
    }
    float ro[DT * 4], rm[2] = {kNegInf, kNegInf}, rl[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < DT * 4; ++e) ro[e] = 0.f;
    int n = 0;
    for (int sp = key_lo / span; nt > 0 && sp <= (key_hi - 1) / span; ++sp) {
      // the span's tiles among the CTA's
      const int ta = max(t0, sp * span / BK);
      const int tb = min(t0 + nt, (sp + 1) * span / BK);
      // the span's own online softmax, from a fresh state
      float o[DT * 4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < DT * 4; ++e) o[e] = 0.f;
      for (int t = ta; t < tb; ++t, ++n) {
        const int st = n % NS, c0 = t * BK;
        mbar_wait(&full[st], (n / NS) & 1);
        const bf16* Kt = Ks + st * TILE;
        const bf16* Vt = Vs + st * TILE + (dbase / 64) * BK * 64;
        float s[NT * 4];
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) s[e] = 0.f;
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          wgmma_ss<BK>(s, desc_sw128(Qg + (ks / 4) * 64 * 64 + (ks % 4) * 16, 0, 1024),
                       desc_sw128(Kt + (ks / 4) * BK * 64 + (ks % 4) * 16, 0, 1024));
        wg_commit();
        wg_wait<0>();
        fence_regs(s);

        // scale (log2 domain), softcap, the rows' bounds
        if (softcap > 0.f) {
          const float pre = scale / softcap, post = softcap * kLog2e;
#pragma unroll
          for (int e = 0; e < NT * 4; ++e) s[e] = tanhf(s[e] * pre) * post;
        } else {
#pragma unroll
          for (int e = 0; e < NT * 4; ++e) s[e] *= sl2;
        }
        if (c0 + BK - 1 > hi_min || c0 < lo_max) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + j * 8 + 2 * tq + (e & 1);
              if (c > rb[e >> 1] || c < lb[e >> 1]) s[4 * j + e] = kNegInf;
            }
        }
        // online softmax over the quad's columns
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float bs[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          // a row with no visible key yet subtracts 0, so its masked logits
          // give 2^-1e30 = 0
          bs[i] = m_new == kNegInf ? 0.f : m_new;
          const float corr = fast_exp2(m[i] - bs[i]);
          m[i] = m_new;
          l[i] *= corr;
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            o[4 * d + 2 * i] *= corr;
            o[4 * d + 2 * i + 1] *= corr;
          }
        }
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) s[e] = fast_exp2(s[e] - bs[(e >> 1) & 1]);
        // P as bf16 hi + lo: the score blocks 2kk and 2kk+1 are the A
        // fragment of k step kk of P V
        uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const float* a = s + 8 * kk;
          split_bf16(a[0], a[1], ph[kk][0], pl[kk][0]);
          split_bf16(a[2], a[3], ph[kk][1], pl[kk][1]);
          split_bf16(a[4], a[5], ph[kk][2], pl[kk][2]);
          split_bf16(a[6], a[7], ph[kk][3], pl[kk][3]);
          l[0] += (a[0] + a[1]) + (a[4] + a[5]);
          l[1] += (a[2] + a[3]) + (a[6] + a[7]);
        }
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = desc_sw128(Vt + kk * 16 * 64, BK * 128, 1024);
          wgmma_rs<DW>(o, ph[kk], dv);
          wgmma_rs<DW>(o, pl[kk], dv);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[st]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      if (split) {
        // the span's partial: [KH][spans][SG][HD] acc, then [..][SG][2] (m, l)
        const int spans = gridDim.z;
        float* ml = part + (long long)KH * spans * SG * HD;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int R = R0 + rbase + warp * 16 + gq + 8 * i;
          if (R >= SG) continue;
          const long long pr = ((long long)kh * spans + sp) * SG + R;
          float* pa = part + pr * HD + dbase;
#pragma unroll
          for (int d = 0; d < DT; ++d)
            *reinterpret_cast<float2*>(pa + d * 8 + 2 * tq) =
                make_float2(o[4 * d + 2 * i], o[4 * d + 2 * i + 1]);
          if (tq == 0 && dbase == 0) {
            ml[2 * pr] = m[i];
            ml[2 * pr + 1] = l[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (l[i] == 0.f) continue;   // no visible key in this span
          float mn, ca, cb;
          fold_weights(rm[i], m[i], mn, ca, cb);
          rl[i] = fold(rl[i], ca, l[i], cb);
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            ro[4 * d + 2 * i] = fold(ro[4 * d + 2 * i], ca, o[4 * d + 2 * i], cb);
            ro[4 * d + 2 * i + 1] =
                fold(ro[4 * d + 2 * i + 1], ca, o[4 * d + 2 * i + 1], cb);
          }
          rm[i] = mn;
        }
      }
    }
    if (!split) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int R = R0 + rbase + warp * 16 + gq + 8 * i;
        if (R >= SG) continue;
        bf16* ob = out + ((long long)(R / G) * KH * G + kh * G + R % G) * HD + dbase;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(ob + d * 8 + 2 * tq) =
              __floats2bfloat162_rn(normalise(ro[4 * d + 2 * i], rl[i]),
                                    normalise(ro[4 * d + 2 * i + 1], rl[i]));
      }
    }
  }
}

// Fold row R's span partials in span order, from the span of its lower
// bound to that of its upper one (spans with no visible key, l = 0,
// skipped), normalise, cast to bf16: the fold route's operations.  Block
// (R, kh), one thread per dim.
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
    float mn, ca, cb;
    fold_weights(m, ml[2 * pr], mn, ca, cb);
    l = fold(l, ca, ls, cb);
    acc = fold(acc, ca, part[pr * HD + d], cb);
    m = mn;
  }
  out[((long long)qi * KH * G + kh * G + R % G) * HD + d] =
      __float2bfloat16(normalise(acc, l));
}

}  // namespace wg

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
  int n_past_pages, KH, G, span, spans, pool_pages;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale, softcap;
};

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A tensor map over `rank` dims (innermost first: hd, KH, rows[, pages])
// with byte strides of dims 1..: boxes of `inner` elements x 1 kv head x
// `rows` rows [x 1 page], zeros out of bounds; bf16 in 64-element boxes
// with the 128-byte swizzle (the stages wgmma reads), or int8 raw bytes in
// whole rows, unswizzled (the producer's raw slots).
bool encode(CUtensorMap* m, bool i8, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            cuuint32_t inner, cuuint32_t rows) {
  const EncodeFn f = encode_fn();
  if (!f) return false;
  const cuuint32_t box[4] = {inner, 1, rows, 1}, one[4] = {1, 1, 1, 1};
  return f(m, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
           rank, const_cast<void*>(base), dims, strides, box, one,
           CU_TENSOR_MAP_INTERLEAVE_NONE,
           i8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int HD>
int launch_wg(const Args& a, int hd, cudaStream_t s) {
  using C = wg::Cfg<HD>;
  constexpr int BK = C::BK;
  const Pool& pl = a.pool;
  const long long b = 2;   // bytes of a bf16 chunk element
  CUtensorMap kc{}, vc{}, kp{}, vp{};
  // the raw chunk: (length, KH, hd), so pads read as zeros
  const cuuint64_t cdim[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(a.KH),
                              static_cast<cuuint64_t>(a.bd.length)};
  const cuuint64_t kst[2] = {static_cast<cuuint64_t>(a.k_sh * b),
                             static_cast<cuuint64_t>(a.k_ss * b)};
  const cuuint64_t vst[2] = {static_cast<cuuint64_t>(a.v_sh * b),
                             static_cast<cuuint64_t>(a.v_ss * b)};
  if (!encode(&kc, false, a.k, 3, cdim, kst, 64, BK) ||
      !encode(&vc, false, a.v, 3, cdim, vst, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  // the past through TMA, bf16 into the stages or int8 into the raw slots:
  // a dense row (a tile that wraps, or that holds chunk rows, is staged by
  // the producer's threads), or a pool in boxes of hb rows, one page of a
  // kv head each (page sizes a multiple of 8 that divide or are divided by
  // the tile); a float32 past is staged by the threads
  constexpr bool kI8 = std::is_same<E, int8_t>::value;
  int tma_past = 0, hb = 0;
  if (!std::is_same<E, float>::value && a.bd.start > 0) {
    const long long eb = kI8 ? 1 : 2;   // bytes of an element of the past
    const cuuint32_t inner = kI8 ? hd : 64;
    const cuuint64_t st3[2] = {static_cast<cuuint64_t>(pl.sh * eb),
                               static_cast<cuuint64_t>(pl.ss * eb)};
    if (pl.buf_len > 0) {
      const cuuint64_t d3[3] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(a.KH),
                                static_cast<cuuint64_t>(pl.buf_len)};
      if (!encode(&kp, kI8, pl.kp, 3, d3, st3, inner, BK) ||
          !encode(&vp, kI8, pl.vp, 3, d3, st3, inner, BK))
        return static_cast<int>(cudaErrorInvalidValue);
      tma_past = 1;
    } else if (pl.ps % 8 == 0 && (BK % pl.ps == 0 || pl.ps % BK == 0)) {
      hb = pl.ps < BK ? pl.ps : BK;
      const cuuint64_t d4[4] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(a.KH),
                                static_cast<cuuint64_t>(pl.ps),
                                static_cast<cuuint64_t>(a.pool_pages)};
      const cuuint64_t st4[3] = {st3[0], st3[1],
                                 static_cast<cuuint64_t>(pl.sp * eb)};
      if (!encode(&kp, kI8, pl.kp, 4, d4, st4, inner, hb) ||
          !encode(&vp, kI8, pl.vp, 4, d4, st4, inner, hb))
        return static_cast<int>(cudaErrorInvalidValue);
      tma_past = 2;
    }
  }
  const int bytes = C::template bytes<E>() +
                    a.n_past_pages * static_cast<int>(sizeof(int));
  const void* kern = reinterpret_cast<const void*>(wg::chunk_kernel<HD, E>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int SG = a.S * a.G;
  const bool split = a.part != nullptr;
  const dim3 grid((SG + C::RT - 1) / C::RT, a.KH, split ? a.spans : 1);
  using bf16 = __nv_bfloat16;
  bf16* out = static_cast<bf16*>(a.out);
  wg::chunk_kernel<HD, E><<<grid, C::kThreads, bytes, s>>>(
      kc, vc, kp, vp, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v), a.pool,
      a.table, out, a.part, a.S, a.bd, a.n_past_pages, a.G, a.span, tma_past,
      hb, a.q_ss, a.q_sh, a.k_ss, a.k_sh, a.v_ss, a.v_sh, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  wg::chunk_merge_kernel<HD><<<dim3(SG, a.KH), HD, 0, s>>>(
      a.part, out, a.S, a.bd, a.G, a.span, a.spans);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E, int HD>
int launch(const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wg<E, HD>(a, HD, s);
  } else {
    const int bytes = fma::smem_bytes<HD>() +
                      a.n_past_pages * static_cast<int>(sizeof(int));
    const void* kern = reinterpret_cast<const void*>(fma::chunk_fma_kernel<HD, E>);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.S * a.G + BQ - 1) / BQ, a.KH, 1);
    fma::chunk_fma_kernel<HD, E><<<grid, fma::kThreads, bytes, s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.pool, a.table, static_cast<T*>(a.out),
        a.S, a.bd, a.n_past_pages, a.G, a.q_ss, a.q_sh, a.k_ss, a.k_sh,
        a.v_ss, a.v_sh, a.scale, a.softcap);
    return static_cast<int>(cudaGetLastError());
  }
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
// - buf_len 0: k_pool, v_pool (pool_pages, ps, KH, hd) with strides (p_sp,
//   p_ss, p_sh, 1), read through table, the stream's page ids, int32,
//   contiguous, covering positions 0 .. start-1 (n_pages of them);
// - buf_len > 0: the stream's dense rows (buf_len, KH, hd) with strides
//   (p_ss, p_sh, 1) (p_sp, s_sp, ps, n_pages, pool_pages and table
//   unused), position p at slot p % buf_len, resident from start - buf_len.
// window > 0 bounds each query's lookback; softcap > 0 caps the logits.
// out: (S, Hq, hd) contiguous.  bfloat16 (dtype) runs the warp-specialised
// body over key spans of `span` positions (a positive multiple of 64),
// spans = ceil((start + length) / span): with part null one launch folds
// a row's spans in registers; with part, a float32 scratch of
// KH*spans*S*G*(hd+2) elements, one CTA per span writes its partial and a
// second kernel folds them in the same order with the same operations.
// float32 runs the FMA body, one span (span 0, spans 1, no scratch).
// Requires 1 <= length <= S, G >= 1, hd in {64, 128, 256} and 16-byte
// aligned rows and strides.  Returns the CUDA error code (a tensor map the
// driver does not encode: cudaErrorInvalidValue).
extern "C" int chunk_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* table, void* out, void* part, int S, int start, int length,
    int n_pages, int ps, int KH, int G, int hd, int span, int spans,
    long long q_ss, long long q_sh, long long k_ss, long long k_sh,
    long long v_ss, long long v_sh, long long p_sp, long long p_ss,
    long long p_sh, long long s_sp, long long s_ss, long long s_sh,
    float scale, float softcap, int window, int buf_len, int dtype,
    int past, int pool_pages, void* stream) {
  const bool dense = buf_len > 0;
  const int n_past_pages = dense ? 0 : ps > 0 ? (start + ps - 1) / ps : -1;
  const bool bf = dtype == kBF16;
  const int want = bf && span > 0 ? (start + length + span - 1) / span : 1;
  if (length < 1 || length > S || start < 0 || KH < 1 || G < 1 ||
      window < 0 || buf_len < 0 || (!dense && (ps < 1 || !table || pool_pages < 1)) ||
      n_past_pages > n_pages || (bf ? span < 64 || span % 64 : span != 0 || part) ||
      spans != want || (past == kI8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bounds bd{start, length, window,
                  dense && start > buf_len ? start - buf_len : 0};
  const Args a{q, k, v,
               Pool{k_pool, v_pool, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), dense ? 0 : p_sp,
                    p_ss, p_sh, dense ? 0 : s_sp, s_ss, s_sh, ps, buf_len},
               static_cast<const int*>(table), out, static_cast<float*>(part),
               S, bd, n_past_pages, KH, G, span, spans, pool_pages,
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
