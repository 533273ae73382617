// Flash-decode for Hopper: one query token per batch row against a dense
// (or ring) KV cache read in the serving layout (B, Sk, KH, hd).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`; bshd wrapper src/repro/kernels/ops.py::decode_attention_bshd).
// Key j of row b is valid when 0 <= k_pos[b, j] <= q_pos[b] and, with a
// window, k_pos[b, j] > q_pos[b] - window; logits are soft-capped when
// softcap > 0.  The kernel body, its bound and
// its design are in decode_attention.cuh, shared with the paged kernel.
// The cache view cache[:, :ctx] is strided (batch stride = buf_len*KH*hd),
// so strides are passed and nothing is copied.  A batch stride of 0 (for K,
// V and k_pos) lets many query rows share one context: the chunked-prefill
// route runs each query of a chunk as one row.
#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T>
int run(const void* q, const void* k, const void* v, const void* k_pos,
        const void* q_pos, void* out, void* part, int spans, int B, int Sk,
        int KH, int G, int hd, const long long* st, int window, float scale,
        float softcap, cudaStream_t s) {
  const decode::Cache<T, decode::DenseRows> keys{
      {static_cast<const int*>(k_pos), Sk, window, st[8]},
      static_cast<const T*>(k), static_cast<const T*>(v),
      {st[2], st[3], st[4]}, {st[5], st[6], st[7]}};
  return decode::dispatch_hd<T>(hd, q, q_pos, out, part, spans, B, KH, G,
                                st[0], st[1], scale, softcap, keys, s);
}

}  // namespace

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); k, v: (B, Sk, KH, hd) with
// strides (*_sb, *_ss, *_sh, 1); k_pos: (B, Sk) int32 with strides (kp_sb, 1);
// q_pos: (B,) int32 contiguous; out: (B, Hq, hd) contiguous, or nullptr for
// the span-partial route (the partials are left in part: acc
// [B][KH][spans][G][hd], then (m, l) [B][KH][spans][G][2]); part: float32
// scratch of B*KH*spans*G*(hd+2) elements, spans = decode::n_spans(Sk).
// Strides are in elements; softcap 0 leaves the logits uncapped.  Requires
// G = Hq/KH <= 16, hd in {64, 128, 256}
// and 16-byte aligned K/V rows.  Returns the CUDA error code.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_pos, void* out, void* part, int spans, int B, int Sk,
    int KH, int G, int hd,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long kp_sb, int window, float scale, float softcap, int dtype,
    void* stream) {
  if (G < 1 || G > decode::kMaxG || spans != decode::n_spans(Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kp_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(q, k, v, k_pos, q_pos, out, part, spans, B,
                              Sk, KH, G, hd, st, window, scale, softcap, s);
  if (dtype == kF32)
    return run<float>(q, k, v, k_pos, q_pos, out, part, spans, B, Sk, KH, G,
                      hd, st, window, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The combine alone: partials of R key ranges of `spans` spans each (the
// span-partial route's scratches, gathered in range order), folded in
// range then span order into out (B, Hq, hd) contiguous, of type dtype.
// acc and ml are float32 with the strides (in floats) of range, batch row,
// kv head and span (acc's query head stride is hd, ml's 2; see
// decode::PartStrides).  Requires hd in {64, 128, 256}.  Returns the CUDA
// error code.
extern "C" int decode_combine_launch(
    const void* acc, const void* ml, void* out, int B, int KH, int G, int hd,
    int R, int spans, long long a_sr, long long a_sb, long long a_sh,
    long long a_ss, long long m_sr, long long m_sb, long long m_sh,
    long long m_ss, int dtype, void* stream) {
  if (G < 1 || G > decode::kMaxG || R < 1 || spans < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return decode::combine_hd(hd, dtype, static_cast<const float*>(acc),
                            static_cast<const float*>(ml), out, B, KH, G, R,
                            spans, {a_sr, a_sb, a_sh, a_ss},
                            {m_sr, m_sb, m_sh, m_ss},
                            static_cast<cudaStream_t>(stream));
}
