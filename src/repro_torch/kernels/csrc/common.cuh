// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel computes in float32 and reads/writes its tensors either as
// float32 or as bfloat16 (the int8 KV caches of decode are read here too);
// the element type is a template parameter and the Python wrapper picks the
// instantiation through an integer dtype code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes, mirrored by repro_torch.kernels._build.DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1 };

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

// int8 values widened to float32 (exact): 16 from a 16-byte vector, 8 from
// an 8-byte one (p aligned to its size); little endian, so byte i of word w
// is element 4w + i.
__device__ __forceinline__ void widen_i8(int w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<signed char>(w >> (8 * i)));
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
