// Flash-decode for Hopper over an int8 KV cache (kv_quant): one query token
// per batch row against int8 K/V rows with one float32 scale per (token,
// kv head), read in the serving layout (B, Sk, KH, hd) and (B, Sk, KH, 1).
//
// Replaces: src/repro/kernels/decode_attention_q8.py::decode_attention_q8
// (Pallas body `_kernel`).  It computes what decode_attention.cu computes
// (validity 0 <= k_pos <= q_pos and the window, the softcap, float32 online
// softmax, zeros for a row with no valid key) on the dequantized cache: K/V are
// widened to float32 after the load from shared memory, and the scales are
// applied in float32 registers (factored out of the sums: see
// decode_attention.cuh).  q and the output are float32 or bfloat16.
//
// Bound on the H100: bytes, about half of the bf16 kernel's: each valid key
// costs 2*hd bytes of int8 and 8 bytes of scales per kv head, against
// 4*hd bytes in bf16.  The body, its design and its thread map are
// decode_attention.cuh's (a third instantiation, with int8 rows and their
// scales staged in one cp.async group): keys split over CTAs in fixed spans
// and combined in span order, so results are deterministic; the paged int8
// route (paged_decode_attention.cu) is the same body with page-table
// addressing and gives the same bits on the same context.
#include "decode_attention.cuh"

using namespace rt;

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); k, v: int8 (B, Sk, KH, hd)
// with strides (*_sb, *_ss, *_sh, 1); k_scale, v_scale: float32
// (B, Sk, KH, 1) with strides (*_sb, *_ss, *_sh, 1); k_pos: (B, Sk) int32
// with strides (kp_sb, 1); q_pos: (B,) int32 contiguous; out: (B, Hq, hd)
// contiguous, q's dtype, or nullptr for the span-partial route (the partials
// are left in part, as decode_attention_launch leaves them; its
// decode_combine_launch folds them); part: float32 scratch of
// B*KH*spans*G*(hd+2) elements, spans = decode::n_spans(Sk).  Strides are in elements; softcap
// 0 leaves the logits uncapped.
// Requires G = Hq/KH <= 16, hd in {64, 128, 256} and 16-byte aligned K/V
// rows.  Returns the CUDA error code.
extern "C" int decode_attention_q8_launch(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* k_pos, const void* q_pos, void* out,
    void* part, int spans, int B, int Sk, int KH, int G, int hd,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long ks_sb, long long ks_ss, long long ks_sh, long long vs_sb,
    long long vs_ss, long long vs_sh, long long kp_sb, int window, float scale,
    float softcap, int dtype, void* stream) {
  if (G < 1 || G > decode::kMaxG || spans != decode::n_spans(Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::Cache<int8_t, decode::DenseRows, true> keys{
      {static_cast<const int*>(k_pos), Sk, window, kp_sb},
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      {ks_sb, ks_ss, ks_sh}, {vs_sb, vs_ss, vs_sh}};
  if (dtype == kBF16)
    return decode::dispatch_hd<__nv_bfloat16>(hd, q, q_pos, out, part, spans,
                                              B, KH, G, q_sb, q_sh, scale,
                                              softcap, keys, s);
  if (dtype == kF32)
    return decode::dispatch_hd<float>(hd, q, q_pos, out, part, spans, B, KH,
                                      G, q_sb, q_sh, scale, softcap, keys, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
