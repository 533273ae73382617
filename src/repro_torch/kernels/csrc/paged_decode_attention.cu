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
// and, with a window, j > q_pos[b] - window.  The walk stops at
// min(q_pos[b], n_pages*ps - 1), so scratch-page tails (unallocated chain
// entries, which point at page 0) and keys past the last valid one are never
// loaded.  The table is read with its row stride: the engine passes the
// ctx-bucket slice table[:, :n_ctx] without a copy.
//
// Bound, design and arithmetic: decode_attention.cuh, the body shared with
// the dense kernel, so a context laid out as a page chain gives outputs
// bitwise equal to the same context in a dense cache.  The pool must have
// q's dtype (the wrapper raises otherwise): no per-step cast of the pool.
#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T>
struct PagedKeys {
  const T* kp;
  const T* vp;
  const int* table;
  int n_pages, ps, window;
  long long pt_sb;                 // page-table row stride
  long long p_sp, p_ss, p_sh;      // pool strides: page, slot, kv head

  __device__ __forceinline__ bool valid(int b, int qp, int j) const {
    return j <= qp && (window == 0 || j > qp - window);
  }
  __device__ __forceinline__ int last(int b, int qp, int t) const {
    return max(min(qp, n_pages * ps - 1), -1);
  }
  __device__ __forceinline__ long long row(int b, int kh, int j) const {
    const int page = table[b * pt_sb + j / ps];
    return page * p_sp + (j % ps) * p_ss + kh * p_sh;
  }
  __device__ __forceinline__ const T* k_row(int b, int kh, int j) const {
    return kp + row(b, kh, j);
  }
  __device__ __forceinline__ const T* v_row(int b, int kh, int j) const {
    return vp + row(b, kh, j);
  }
};

}  // namespace

// q: (B, Hq, hd) with strides (q_sb, q_sh, 1); k_pool, v_pool: (P, ps, KH,
// hd), both with strides (p_sp, p_ss, p_sh, 1); page_table: (B, n_pages)
// int32 with strides (pt_sb, 1); q_pos: (B,) int32 contiguous; out:
// (B, Hq, hd) contiguous.  Strides are in elements.  Requires G = Hq/KH <=
// 16, hd in {64, 128, 256} and 16-byte aligned pool rows.  Returns the CUDA
// error code.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_pos, void* out, int B, int n_pages,
    int ps, int KH, int G, int hd, long long q_sb, long long q_sh,
    long long pt_sb, long long p_sp, long long p_ss, long long p_sh,
    int window, float scale, int dtype, void* stream) {
  if (G < 1 || G > decode::kMaxG || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    const PagedKeys<T> keys{static_cast<const T*>(k_pool),
                            static_cast<const T*>(v_pool), pt, n_pages, ps,
                            window, pt_sb, p_sp, p_ss, p_sh};
    return decode::dispatch_hd<T>(hd, q, q_pos, out, B, KH, G, q_sb, q_sh,
                                  scale, keys, s);
  }
  if (dtype == kF32) {
    const PagedKeys<float> keys{static_cast<const float*>(k_pool),
                                static_cast<const float*>(v_pool), pt,
                                n_pages, ps, window, pt_sb, p_sp, p_ss, p_sh};
    return decode::dispatch_hd<float>(hd, q, q_pos, out, B, KH, G, q_sb, q_sh,
                                      scale, keys, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
