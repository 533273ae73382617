// Row RMSNorm for Hopper, alone and fused with the residual add in front of
// it.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body `_kernel`).
// rmsnorm computes, per row: y = x * rsqrt(mean(x^2) + eps) * w in float32,
// cast back to the input type; w is float32.  add_rmsnorm first forms the
// residual sum s = x + delta (float32 sum rounded once to the type, which is
// what PyTorch's add of the two tensors gives), stores it over x (each
// thread reads its elements of x before it writes them), and normalises
// it: y is bitwise what rmsnorm gives on s, because both kernels run the
// one body below on the same (rounded) values.
//
// Bound on the H100: bytes.  Each row is read once and written once (x and
// delta read, s and y written for the fused kernel), about 3 FLOP per
// element, far below the ~295 FLOP/byte the card needs before compute
// matters.  At the serve path's shapes (8 to 1024 rows of 1536) a launch is
// a few microseconds, mostly its fixed cost, so what the fusion buys is a
// launch and a PyTorch operator per residual add.
//
// Design: one CTA per row, W warps, W = ceil(vectors / (32 * kVPT)) for the
// row's 16-byte vectors (2 warps for 1536 bf16 elements), at most 8.  A
// thread loads its vectors (t, t + 32W, ...) once, keeps them in registers
// between the sum of squares and the scaling (no second read of x), loads
// its slice of w as float4 vectors ahead of the reduction, and stores y
// (and s) as 16-byte vectors.  A row wider than 8 warps' registers (8192
// bf16, 4096 float32 elements) is taken in passes of 8 warps' vectors, and
// all but the last pass are read again to scale.  The sum of squares has a
// fixed order: each thread's vectors and elements in order, an xor
// butterfly inside the warp (every lane ends with the same bits), then the
// warps' sums in warp order.  W depends only on d, so a row's result is
// the same on every run, whatever the row count, and the fused and the
// unfused kernel agree bit for bit.
// No row padding (the Pallas `block_rows` padding is a TPU tiling artefact).
//
// Backward (rmsnorm_bwd_launch; the JAX package takes this gradient of
// src/repro/models/layers.py:22 with jax.grad, no kernel): for a row x,
// the output gradient dy and g = w * dy, in float32,
//   dx = (g - x_hat * mean(x_hat * g)) * inv,  inv = rsqrt(mean(x^2) + eps),
// plus ds when given (add_rmsnorm: its sum s feeds the residual stream too,
// and dx and ddelta are both ds + that), cast once to x's type; and
//   dw = sum over rows of dy * x_hat (float32).
// Two launches, no atomics: the row kernel takes one CTA per block of
// `rpb` rows (a function of the row count alone, fixed by the wrapper),
// reads each row twice (the sums, then dx; the second read hits L1/L2),
// and sums its rows' dy * x_hat per column in shared memory, in row order,
// into one float32 partial row per block; the second kernel adds the
// partial rows per column in block order.  Bound by bytes, as the forward:
// x, dy (and ds) read, dx written, the partials small beside them.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kVPT = 4;        // 16-byte vectors of its row a thread holds
constexpr int kMaxWarps = 8;   // warps per row (wider rows take passes)

// A raw 16-byte vector of T widened to float32, and back (rounded to
// nearest even for bf16, the first element in the low half).
template <typename T> __device__ __forceinline__ void unpack(const uint4& r, float* e);
template <> __device__ __forceinline__ void unpack<float>(const uint4& r, float* e) {
  e[0] = __uint_as_float(r.x); e[1] = __uint_as_float(r.y);
  e[2] = __uint_as_float(r.z); e[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* e) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[2 * i] = __uint_as_float(w[i] << 16);
    e[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* e);
template <> __device__ __forceinline__ uint4 pack<float>(const float* e) {
  return make_uint4(__float_as_uint(e[0]), __float_as_uint(e[1]),
                    __float_as_uint(e[2]), __float_as_uint(e[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* e) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(e[2 * i], e[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One row: y = rmsnorm(x) or, with kAdd, s = x + delta and y = rmsnorm(s);
// s may be x (no __restrict__ on either).  A row of more than kVPT vectors
// a thread is taken in passes of kVPT; the last pass's vectors stay in
// registers and the earlier ones are read again (from s, or x) to scale.
template <typename T, bool kAdd>
__device__ __forceinline__ void norm_row(const T* x,
                                         const T* __restrict__ delta,
                                         const float* __restrict__ w,
                                         T* s, T* __restrict__ y,
                                         int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int nv = d / N, tid = threadIdx.x, nt = blockDim.x;
  const int step = kVPT * nt;
  const long long row = static_cast<long long>(blockIdx.x) * nv;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row;
  const uint4* sr = kAdd ? reinterpret_cast<const uint4*>(s) + row : xr;
  uint4 v[kVPT];
  float wv[kVPT][N];
  auto load_w = [&](int c, float* e) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 f = reinterpret_cast<const float4*>(w)[(c * N + j) / 4];
      e[j] = f.x; e[j + 1] = f.y; e[j + 2] = f.z; e[j + 3] = f.w;
    }
  };
  // the sum of squares (and s), pass by pass; `base` ends at the last pass
  float ss = 0.f;
  int base = 0;
  for (;; base += step) {
    const bool last = base + step >= nv;
    uint4 dv[kVPT];
#pragma unroll
    for (int i = 0; i < kVPT; ++i) {
      const int c = base + tid + i * nt;
      if (c < nv) {
        v[i] = xr[c];
        if constexpr (kAdd) dv[i] = (reinterpret_cast<const uint4*>(delta) + row)[c];
        if (last) load_w(c, wv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kVPT; ++i) {
      const int c = base + tid + i * nt;
      if (c < nv) {
        float e[N];
        unpack<T>(v[i], e);
        if constexpr (kAdd) {
          float b[N];
          unpack<T>(dv[i], b);
#pragma unroll
          for (int j = 0; j < N; ++j) e[j] += b[j];
          v[i] = pack<T>(e);           // the sum rounded once to T
          (reinterpret_cast<uint4*>(s) + row)[c] = v[i];
          unpack<T>(v[i], e);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) ss += e[j] * e[j];
      }
    }
    if (last) break;
  }
  ss = warp_sum(ss);
  if (nt > 32) {
    __shared__ float red[kMaxWarps];
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < nt / 32; ++i) ss += red[i];   // warp order
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int b0 = 0; b0 < base; b0 += step) {   // earlier passes: all in range
#pragma unroll
    for (int i = 0; i < kVPT; ++i) {
      const int c = b0 + tid + i * nt;
      float e[N], f[N];
      unpack<T>(sr[c], e);
      load_w(c, f);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = e[j] * inv * f[j];
      (reinterpret_cast<uint4*>(y) + row)[c] = pack<T>(e);
    }
  }
#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    const int c = base + tid + i * nt;
    if (c < nv) {
      float e[N];
      unpack<T>(v[i], e);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = e[j] * inv * wv[i][j];
      (reinterpret_cast<uint4*>(y) + row)[c] = pack<T>(e);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  norm_row<T, false>(x, nullptr, w, nullptr, out, d, eps);
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
add_norm_kernel(const T* x, const T* __restrict__ delta,
                const float* __restrict__ w, T* s, T* __restrict__ out, int d,
                float eps) {
  norm_row<T, true>(x, delta, w, s, out, d, eps);
}

// The backward of one block of rows: dx for every row, and the block's
// partial dw (float32, one row of d) into part[blockIdx.x].  Each thread
// owns the same vectors (tid, tid + nt, ...) of every row, so its columns
// of the shared dw accumulator are its own.
template <typename T, bool kDs>
__global__ void __launch_bounds__(32 * kMaxWarps)
norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ dy, const T* __restrict__ ds,
                T* __restrict__ dx, float* __restrict__ part, int rows, int d,
                int rpb, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem4[];
  float* wacc = reinterpret_cast<float*>(smem4);   // [d]
  __shared__ float red[2][kMaxWarps];
  const int nv = d / N, tid = threadIdx.x, nt = blockDim.x;
  auto load_w = [&](int c, float* e) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 f = reinterpret_cast<const float4*>(w)[(c * N + j) / 4];
      e[j] = f.x; e[j + 1] = f.y; e[j + 2] = f.z; e[j + 3] = f.w;
    }
  };
  for (int c = tid; c < nv; c += nt)
#pragma unroll
    for (int j = 0; j < N; ++j) wacc[c * N + j] = 0.f;
  const int r0 = blockIdx.x * rpb, r1 = min(rows, r0 + rpb);
  for (int row = r0; row < r1; ++row) {
    const long long off = static_cast<long long>(row) * nv;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + off;
    const uint4* gr = reinterpret_cast<const uint4*>(dy) + off;
    // the sum of squares and of x * w * dy, each thread's vectors in order,
    // then the warp butterfly, then the warps in order
    float ss = 0.f, sg = 0.f;
    for (int c = tid; c < nv; c += nt) {
      float e[N], g[N], f[N];
      unpack<T>(xr[c], e);
      unpack<T>(gr[c], g);
      load_w(c, f);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += e[j] * e[j];
        sg += e[j] * (g[j] * f[j]);
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (nt > 32) {
      if ((tid & 31) == 0) {
        red[0][tid >> 5] = ss;
        red[1][tid >> 5] = sg;
      }
      __syncthreads();
      ss = sg = 0.f;
      for (int i = 0; i < nt / 32; ++i) {
        ss += red[0][i];
        sg += red[1][i];
      }
      __syncthreads();   // red is free for the next row
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    const float m = inv * sg / static_cast<float>(d);   // mean(x_hat * g)
    for (int c = tid; c < nv; c += nt) {
      float e[N], g[N], f[N], o[N];
      unpack<T>(xr[c], e);
      unpack<T>(gr[c], g);
      load_w(c, f);
      if constexpr (kDs) unpack<T>((reinterpret_cast<const uint4*>(ds) + off)[c], o);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = e[j] * inv;
        const float v = (g[j] * f[j] - xh * m) * inv;
        o[j] = kDs ? o[j] + v : v;
        wacc[c * N + j] += g[j] * xh;
      }
      (reinterpret_cast<uint4*>(dx) + off)[c] = pack<T>(o);
    }
  }
  float* pr = part + static_cast<long long>(blockIdx.x) * d;
  for (int c = tid; c < nv; c += nt)
#pragma unroll
    for (int j = 0; j < N; ++j) pr[c * N + j] = wacc[c * N + j];
}

// dw[col] = the partial rows' sum at col, in block order.
__global__ void dw_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dw, int nblk, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[static_cast<long long>(b) * d + col];
  dw[col] = acc;
}

// Threads per row for d elements of T (0: d not supported).
template <typename T>
int row_threads(int d) {
  constexpr int N = Vec<T>::N;
  if (d <= 0 || d % N) return 0;
  const int warps = (d / N + 32 * kVPT - 1) / (32 * kVPT);
  return 32 * (warps < kMaxWarps ? warps : kMaxWarps);
}

template <typename T>
int launch(const void* x, const void* delta, const void* w, void* s,
           void* out, int rows, int d, float eps, cudaStream_t st) {
  const int nt = row_threads<T>(d);
  if (!nt) return static_cast<int>(cudaErrorInvalidValue);
  if (delta)
    add_norm_kernel<T><<<rows, nt, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(delta),
        static_cast<const float*>(w), static_cast<T*>(s),
        static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T><<<rows, nt, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* delta, const void* w, void* s,
             void* out, int rows, int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, delta, w, s, out, rows, d, eps, st);
  if (dtype == kF32) return launch<float>(x, delta, w, s, out, rows, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, const void* ds,
               void* dx, void* part, void* dw, int rows, int d, float eps,
               int rpb, cudaStream_t st) {
  const int nt = row_threads<T>(d);
  if (!nt || rpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (rows + rpb - 1) / rpb;
  const int bytes = d * static_cast<int>(sizeof(float));
  auto kern = ds ? norm_bwd_kernel<T, true> : norm_bwd_kernel<T, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<nblk, nt, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(dy), static_cast<const T*>(ds),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, rpb, eps);
  dw_sum_kernel<<<(d + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nblk, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous, float32 or bfloat16 (dtype code); w: (d,)
// float32.  Rows and w must be 16-byte aligned (d a multiple of one
// vector).  Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows,
                              int d, float eps, int dtype, void* stream) {
  return dispatch(x, nullptr, w, nullptr, out, rows, d, eps, dtype, stream);
}

// s = x + delta and out = rmsnorm(s, w): x, delta, s, out (rows, d)
// contiguous of one dtype, s either x itself or apart from it; otherwise as
// rmsnorm_launch.
extern "C" int add_rmsnorm_launch(const void* x, const void* delta,
                                  const void* w, void* s, void* out, int rows,
                                  int d, float eps, int dtype, void* stream) {
  if (!delta || !s) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, delta, w, s, out, rows, d, eps, dtype, stream);
}

// The backward of rmsnorm(x, w, eps) for the output gradient dy: x, dy, ds
// (null, or the gradient of add_rmsnorm's sum, added to dx), dx (rows, d)
// contiguous of one dtype; w, dw (d,) float32; part (ceil(rows / rpb), d)
// float32 scratch for the per-block partial sums of dw.  Returns
// cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy,
                                  const void* ds, void* dx, void* part,
                                  void* dw, int rows, int d, float eps,
                                  int rpb, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(x, w, dy, ds, dx, part, dw, rows, d, eps,
                                     rpb, st);
  if (dtype == kF32)
    return launch_bwd<float>(x, w, dy, ds, dx, part, dw, rows, d, eps, rpb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
