// Row RMSNorm for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body `_kernel`).
// Computes, per row: y = x * rsqrt(mean(x^2) + eps) * w in float32, cast
// back to the input type.  w is float32.
//
// Bound on the H100: bytes.  Each row is read and written once (plus a
// second read that hits L1), about 3 FLOP per element, far below the
// ~295 FLOP/byte the card needs before compute matters.  Design: one block
// of 256 threads per row, 16-byte vector loads (the wrapper refuses rows
// that are not 16-byte aligned), a warp-shuffle + shared-memory sum of
// squares in a fixed order (so the result is the same on every run), no
// row padding (the Pallas `block_rows` padding is a TPU tiling artefact).
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = out + static_cast<size_t>(blockIdx.x) * d;
  constexpr int N = Vec<T>::N;

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float e[N];
    load_vec(xr + i, e);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += e[j] * e[j];
  }
  __shared__ float red[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) tot += red[i];  // same order everywhere
  const float inv = rsqrtf(tot / static_cast<float>(d) + eps);

  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float e[N];
    load_vec(xr + i, e);
#pragma unroll
    for (int j = 0; j < N; ++j) yr[i + j] = from_f32<T>(e[j] * inv * w[i + j]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int rows, int d, float eps,
            cudaStream_t s) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), d, eps);
}

}  // namespace

// x, out: (rows, d) contiguous, float32 or bfloat16 (dtype code); w: (d,)
// float32.  Rows must be 16-byte aligned (d a multiple of one vector).
// Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows,
                              int d, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  else if (dtype == kF32)
    launch<float>(x, w, out, rows, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
