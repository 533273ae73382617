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
// Bound by bytes: x, dy (and ds) read once, dx written once.  Two launches,
// no atomics, every order fixed by the indices; the geometry is the
// wrapper's (kernels/rmsnorm.py::bwd_geometry), a function of (rows, d,
// dtype) alone.  The rows kernel takes a row with a group of L threads, the
// fewest that hold its 16-byte vectors in registers (V each: vectors t,
// t + L, ...; L a power of two up to a warp, or whole warps), so each row
// is read once: x, dy (and ds) loaded together, kept for the two sums
// (sum x^2, sum x * g) and for dx.  A thread loads its slice of w once per
// CTA.  The sums: each thread's vectors and elements in order, an xor
// butterfly over the group's lanes, then (L > 32) its warps' sums in warp
// order through shared memory behind a named barrier of the group alone;
// so a row's dx depends on that row alone.  A CTA holds G groups (several
// rows in flight) over a contiguous block of rows, group j taking rows j,
// j + G, ...; each thread adds dy * x_hat for its columns in registers
// across its rows, and the groups' sums are combined in group order into
// one float32 partial row per CTA (at most 256 rows of scratch).  The
// second kernel sums the partial rows per column: strips of 32 columns,
// each warp of a strip a contiguous group of partial rows in order, the
// warps' sums then in warp order.
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

// The backward's geometry limits (mirrored by kernels/rmsnorm.py): threads
// of a rows CTA (the launch bound asks for one CTA an SM at least, which
// leaves a thread 255 registers and ptxas spills none), the row groups of
// a CTA whose groups span warps (named barriers 1 ..), and dw's sum's
// warps a strip of 32 columns.  A thread holds at most 6 (bf16) or 10
// (float32) vectors of its row: up to 200 registers of x, dy, ds, w and
// dw's sums.
constexpr int kBwdThreads = 256;
constexpr int kBwdWideGroups = 4;
constexpr int kDwWarps = 8;
template <typename T> constexpr int kBwdMaxVpt = sizeof(T) == 2 ? 6 : 10;

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The rows of CTA blockIdx.x, [rpc * blockIdx.x, +rpc): dx of every row,
// and the CTA's partial dw (float32, one row of d) into part[blockIdx.x].
// Groups of `lanes` threads take a row each; every group runs the same
// number of steps (an idle group sums zeros), so the warp shuffles and the
// barriers are uniform.
template <typename T, bool kDs, int V>
__global__ void __launch_bounds__(kBwdThreads, 1)
norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ dy, const T* __restrict__ ds,
                T* __restrict__ dx, float* __restrict__ part, int rows, int d,
                int lanes, int rpc, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem4[];
  float* comb = reinterpret_cast<float*>(smem4);   // [d], when G > 1
  __shared__ float red[2][kBwdWideGroups][kBwdThreads / 32][2];
  const int nv = d / N, tid = threadIdx.x, groups = blockDim.x / lanes;
  const int grp = tid / lanes, t = tid - grp * lanes;
  float wv[V][N], acc[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * lanes;
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 f = c < nv ? reinterpret_cast<const float4*>(w)[(c * N + j) / 4]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      wv[i][j] = f.x; wv[i][j + 1] = f.y; wv[i][j + 2] = f.z; wv[i][j + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }
  const int r0 = blockIdx.x * rpc, n = min(rpc, rows - r0);
  const int steps = (n + groups - 1) / groups;
  for (int k = 0; k < steps; ++k) {
    const int rr = k * groups + grp;
    const bool on = rr < n;
    const long long off = static_cast<long long>(on ? r0 + rr : r0) * nv;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + off;
    const uint4* gr = reinterpret_cast<const uint4*>(dy) + off;
    uint4 xv[V], gv[V], sv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + i * lanes;
      if (on && c < nv) {
        xv[i] = xr[c];
        gv[i] = gr[c];
        if constexpr (kDs) sv[i] = (reinterpret_cast<const uint4*>(ds) + off)[c];
      }
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (on && t + i * lanes < nv) {
        float e[N], g[N];
        unpack<T>(xv[i], e);
        unpack<T>(gv[i], g);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          ss += e[j] * e[j];
          sg += e[j] * (g[j] * wv[i][j]);
        }
      }
    }
    for (int o = min(lanes, 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if (lanes > 32) {   // the group's warps in order; red alternates by step
      float (*r)[2] = red[k & 1][grp];
      if ((t & 31) == 0) {
        r[t >> 5][0] = ss;
        r[t >> 5][1] = sg;
      }
      group_barrier(1 + grp, lanes);
      ss = sg = 0.f;
      for (int i = 0; i < lanes / 32; ++i) {
        ss += r[i][0];
        sg += r[i][1];
      }
    }
    if (!on) continue;
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    const float m = inv * sg / static_cast<float>(d);   // mean(x_hat * g)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + i * lanes;
      if (c < nv) {
        float e[N], g[N], o[N];
        unpack<T>(xv[i], e);
        unpack<T>(gv[i], g);
        if constexpr (kDs) unpack<T>(sv[i], o);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xh = e[j] * inv;
          const float v = (g[j] * wv[i][j] - xh * m) * inv;
          o[j] = kDs ? o[j] + v : v;
          acc[i][j] += g[j] * xh;
        }
        (reinterpret_cast<uint4*>(dx) + off)[c] = pack<T>(o);
      }
    }
  }
  // the groups' sums in group order; the last group writes the partial row
  float* pr = part + static_cast<long long>(blockIdx.x) * d;
  for (int j = 0; j < groups; ++j) {
    if (grp == j) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = t + i * lanes;
        if (c < nv) {
#pragma unroll
          for (int q = 0; q < N; q += 4) {
            float4 v = make_float4(acc[i][q], acc[i][q + 1], acc[i][q + 2],
                                   acc[i][q + 3]);
            float4* cv = reinterpret_cast<float4*>(comb + c * N + q);
            if (j > 0) {
              const float4 b = *cv;
              v = make_float4(b.x + v.x, b.y + v.y, b.z + v.z, b.w + v.w);
            }
            if (j == groups - 1)
              *reinterpret_cast<float4*>(pr + c * N + q) = v;
            else
              *cv = v;
          }
        }
      }
    }
    if (j < groups - 1) __syncthreads();
  }
}

// dw over a strip of 32 columns (blockIdx.x): warp k sums the partial rows
// [k q, (k + 1) q) in order (q = ceil(nparts / warps)), then the warps'
// sums are added in warp order.
__global__ void __launch_bounds__(32 * kDwWarps)
dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
              int nparts, int d) {
  __shared__ float red[kDwWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, col = blockIdx.x * 32 + lane;
  const int q = (nparts + nw - 1) / nw, p1 = min(nparts, (warp + 1) * q);
  float acc = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int p = warp * q; p < p1; ++p)
      acc += part[static_cast<long long>(p) * d + col];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < d) {
    float s = 0.f;
    for (int k = 0; k < nw; ++k) s += red[k][lane];
    dw[col] = s;
  }
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

// The backward's launch arguments, the geometry's as the wrapper gives it.
struct BwdArgs {
  const void *x, *w, *dy, *ds;
  void *dx, *part, *dw;
  int rows, d, lanes, vpt, groups, rpc, sum_warps;
  float eps;
};

// The rows kernel for vpt == V (tried from 1 up), then dw's sum.
template <typename T, bool kDs, int V = 1>
int launch_bwd_rows(const BwdArgs& a, cudaStream_t st) {
  if constexpr (V > kBwdMaxVpt<T>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (a.vpt != V) return launch_bwd_rows<T, kDs, V + 1>(a, st);
    const int ctas = (a.rows + a.rpc - 1) / a.rpc;
    const int bytes = a.groups > 1 ? a.d * static_cast<int>(sizeof(float)) : 0;
    if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    norm_bwd_kernel<T, kDs, V><<<ctas, a.groups * a.lanes, bytes, st>>>(
        static_cast<const T*>(a.x), static_cast<const float*>(a.w),
        static_cast<const T*>(a.dy), static_cast<const T*>(a.ds),
        static_cast<T*>(a.dx), static_cast<float*>(a.part), a.rows, a.d,
        a.lanes, a.rpc, a.eps);
    dw_sum_kernel<<<(a.d + 31) / 32, 32 * a.sum_warps, 0, st>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.dw), ctas,
        a.d);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  const int L = a.lanes, nv = a.d / N;
  const bool shape_ok =
      a.d > 0 && a.d % N == 0 && a.rows > 0 && a.rpc > 0 && L > 0 &&
      (L <= 32 ? (L & (L - 1)) == 0 : L % 32 == 0) &&
      static_cast<long long>(L) * a.vpt >= nv && a.groups > 0 &&
      a.groups * L <= kBwdThreads && (L <= 32 || a.groups <= kBwdWideGroups) &&
      a.sum_warps > 0 && a.sum_warps <= kDwWarps;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  return a.ds ? launch_bwd_rows<T, true>(a, st) : launch_bwd_rows<T, false>(a, st);
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
// contiguous of one dtype; w, dw (d,) float32; part (ceil(rows / rpc), d)
// float32 scratch for the CTAs' partial sums of dw.  The geometry (lanes a
// row, vectors a thread, row groups a CTA, rows a CTA, warps of dw's sum) is
// kernels/rmsnorm.py::bwd_geometry's.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy,
                                  const void* ds, void* dx, void* part,
                                  void* dw, int rows, int d, float eps,
                                  int lanes, int vpt, int groups, int rpc,
                                  int sum_warps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{x, w, dy, ds, dx, part, dw, rows, d, lanes, vpt, groups,
                  rpc, sum_warps, eps};
  if (dtype == kBF16) return launch_bwd<__nv_bfloat16>(a, st);
  if (dtype == kF32) return launch_bwd<float>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
