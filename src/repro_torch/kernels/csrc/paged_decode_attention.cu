// Paged flash-decode for Hopper: one query token per stream against a
// shared K/V page pool, addressed through a per-stream page table.
//
// Replaces: src/repro/kernels/paged_decode_attention.py::paged_decode_attention
// (Pallas body `_kernel`; oracle paged_decode_attention_ref).
//
// The pool is read in the serving layout (P, ps, KH, hd); the Pallas
// wrapper's transpose to (P, KH, ps, hd) is a TPU tiling artefact and has no
// counterpart here.  Key j of row b lives in physical page
// page_table[b, j / ps] at offset j % ps; pages are linear, so its position
// is j itself and there is no k_pos array: key j is valid when j <= q_pos[b]
// and, with a window, j > q_pos[b] - window; logits are soft-capped when
// softcap > 0.  The walk is n_pages*ps keys,
// of which only those from the first to the last valid one are loaded, so
// scratch-page tails (unallocated chain entries, which point at page 0) are
// never read.  The table is read with its row stride: the engine passes the
// ctx-bucket slice table[:, :n_ctx] without a copy.
//
// Bound, design and arithmetic: decode_attention.cuh, the body shared with
// the dense kernel, so a context laid out as a page chain gives outputs
// bitwise equal to the same context in a dense cache.  The pool has q's
// dtype, or is float32 under a bfloat16 q (a bf16 model with float32
// caches): its rows are rounded to bf16 as they are staged, which is the
// reference's cast of the gathered chain to q's dtype
// (transformer.py::_apply_attn, paged decode) without a per-step copy of
// the pool, and gives the bf16 route's bits on the cast pool.
// An int8 pool with its scales (kv_quant) takes the int8 route below, the
// body of decode_attention_q8.cu; the reference has no paged int8 kernel
// (XLA gathers and dequantizes, models/kvcache.py::paged_cache_kv_arrays).
// The paged rows policy (decode::PagedRows) is in decode_attention.cuh.
#include "decode_attention.cuh"

using namespace rt;


// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); k_pool, v_pool: (P, ps, KH,
// hd), both with strides (p_sp, p_ss, p_sh, 1); page_table: (B, n_pages)
// int32 with strides (pt_sb, 1); q_pos: (B,) int32 contiguous; out:
// (B, Hq, hd) contiguous; part: float32 scratch of B*KH*spans*G*(hd+2)
// elements, spans = decode::n_spans(n_pages*ps).  Strides are in elements.
// dtype is q's and the output's code, kv_dtype the pools' (kv_dtype kF32
// under dtype kBF16: the rounding route).  Requires G = Hq/KH <= 16, hd in
// {64, 128, 256} and 16-byte aligned pool rows.  Returns the CUDA error
// code.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_pos, void* out, void* part,
    int spans, int B, int n_pages, int ps, int KH, int G, int hd,
    long long q_sb, long long q_sh,
    long long pt_sb, long long p_sp, long long p_ss, long long p_sh,
    int window, float scale, float softcap, int dtype, int kv_dtype,
    void* stream) {
  if (G < 1 || G > decode::kMaxG || ps < 1 ||
      spans != decode::n_spans((long long)n_pages * ps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::PagedRows rows{static_cast<const int*>(page_table), n_pages,
                               ps, window, pt_sb};
  const decode::Strides st{p_sp, p_ss, p_sh};
  if (dtype == kBF16 && kv_dtype == kF32) {
    using T = __nv_bfloat16;
    const decode::Cache<T, decode::PagedRows, false, float> keys{
        rows, static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), st, st};
    return decode::dispatch_hd<T>(hd, q, q_pos, out, part, spans, B, KH, G,
                                  q_sb, q_sh, scale, softcap, keys, s);
  }
  if (kv_dtype != dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    const decode::Cache<T, decode::PagedRows> keys{
        rows, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        st, st};
    return decode::dispatch_hd<T>(hd, q, q_pos, out, part, spans, B, KH, G,
                                  q_sb, q_sh, scale, softcap, keys, s);
  }
  if (dtype == kF32) {
    const decode::Cache<float, decode::PagedRows> keys{
        rows, static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), st, st};
    return decode::dispatch_hd<float>(hd, q, q_pos, out, part, spans, B, KH,
                                      G, q_sb, q_sh, scale, softcap, keys, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 route (kv_quant): k_pool, v_pool int8 (P, ps, KH, hd) with
// strides (p_sp, p_ss, p_sh, 1); k_scale, v_scale float32 (P, ps, KH, 1)
// with strides (s_sp, s_ss, s_sh, 1); q and out float32 or bfloat16
// (dtype), otherwise as above.  The body is decode_attention_q8's, with
// page-table addressing, so a chain gives that kernel's bits.
extern "C" int paged_decode_attention_q8_launch(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* page_table,
    const void* q_pos, void* out, void* part, int spans, int B, int n_pages,
    int ps, int KH, int G, int hd, long long q_sb, long long q_sh,
    long long pt_sb, long long p_sp, long long p_ss, long long p_sh,
    long long s_sp, long long s_ss, long long s_sh, int window, float scale,
    float softcap, int dtype, void* stream) {
  if (G < 1 || G > decode::kMaxG || ps < 1 ||
      spans != decode::n_spans((long long)n_pages * ps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::PagedRows rows{static_cast<const int*>(page_table), n_pages,
                               ps, window, pt_sb};
  const decode::Strides st{p_sp, p_ss, p_sh}, sst{s_sp, s_ss, s_sh};
  const decode::Cache<int8_t, decode::PagedRows, true> keys{
      rows, static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), st, st,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      sst, sst};
  if (dtype == kBF16)
    return decode::dispatch_hd<__nv_bfloat16>(hd, q, q_pos, out, part, spans,
                                              B, KH, G, q_sb, q_sh, scale,
                                              softcap, keys, s);
  if (dtype == kF32)
    return decode::dispatch_hd<float>(hd, q, q_pos, out, part, spans, B, KH,
                                      G, q_sb, q_sh, scale, softcap, keys, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
