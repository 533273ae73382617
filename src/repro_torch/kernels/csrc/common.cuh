// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel accumulates in float32 and reads/writes its tensors either
// as float32 or as bfloat16 (the int8 KV caches of decode are read here
// too); the element type is a template parameter and the Python wrapper
// picks the instantiation through an integer dtype code.  Beside the
// conversions: cp.async copies, ldmatrix, the bf16 mma.sync of the flash
// kernel and the warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes, mirrored by repro_torch.kernels._build.DTYPE_CODES; int8
// only for a stored K/V past (_build.PAST_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// masked logit, the same constant the Pallas kernels use
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype in JAX
}

// Elements of T in one 16-byte vector: 4 float32 or 8 bfloat16.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Load one 16-byte vector (p must be 16-byte aligned) and widen it to f32.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Eight float32 values at src (16-byte aligned) rounded to bfloat16 to
// nearest even, the bits of a float32 -> bfloat16 cast, and stored as one
// 16-byte vector at dst: a float32 K/V past read under a bfloat16 query
// (the reference casts the gathered past to q's dtype) without a copy.
__device__ __forceinline__ void round8_bf16(__nv_bfloat16* dst,
                                            const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  const __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(*reinterpret_cast<const uint32_t*>(&h[0]),
                 *reinterpret_cast<const uint32_t*>(&h[1]),
                 *reinterpret_cast<const uint32_t*>(&h[2]),
                 *reinterpret_cast<const uint32_t*>(&h[3]));
}

// int8 values widened to float32 (exact): 16 from a 16-byte vector, 8 from
// an 8-byte one (p aligned to its size); little endian, so byte i of word w
// is element 4w + i.  Each byte b, offset to b + 128, is put under the
// exponent of 2^23 by a byte permute, and 2^23 + 128 is subtracted: exactly
// b, without the int-to-float conversions' lower throughput.
__device__ __forceinline__ void widen_i8(int w, float* out) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
}

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  const int4 r = *reinterpret_cast<const int4*>(p);
  widen_i8(r.x, out); widen_i8(r.y, out + 4);
  widen_i8(r.z, out + 8); widen_i8(r.w, out + 12);
}

__device__ __forceinline__ void load_vec8(const int8_t* p, float* out) {
  const int2 r = *reinterpret_cast<const int2*>(p);
  widen_i8(r.x, out); widen_i8(r.y, out + 4);
}

// cp.async copies into shared memory: 16 bytes through L2 only (with
// src_bytes < 16 the rest of the 16 is zero-filled), 4 bytes through L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 tiles of 16-bit elements from shared memory (lanes 8i..8i+7 give
// the row addresses of tile i); lane l receives row l/4, columns 2(l%4) and
// 2(l%4)+1 of each tile, or with .trans the same of the transposed tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a * b on the tensor cores: a 16x16 (row), b 16x8 (col) bf16, d 16x8
// float32, in the mma.sync m16n8k16 fragment layouts.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: ~2 ulp, -inf and very negative x give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as bf16 pairs hi + lo (each rounded to nearest even, lo the
// rounded remainder): ~16 significant bits, packed for an mma A fragment,
// the first float in the low half.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace rt
