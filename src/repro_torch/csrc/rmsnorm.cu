// RMSNorm with an optional fused residual add, for Hopper (sm_90a).
//
//   rms_norm  out[r][:] = v * (1 / sqrt(mean(v * v) + eps)) * w,
//             v = x[r][:] (+ res[r][:]),  all in float, stored as T
//   replaces repro/kernels/rmsnorm.py::rms_norm_pallas (Pallas bodies
//   _kernel_nores and _kernel_res: res == nullptr selects the first).
//
// Rows are every leading dim flattened; d is the last dim, any size.  T is
// float, double, half or bfloat16; the arithmetic is float for all of them
// (a double input is computed in float, as the JAX kernel does), and the
// weight arrives as float.  The plain PyTorch version is
// repro_torch/kernels/ref.py::rms_norm_ref.  The sum of squares is taken
// per thread, then over the warp, then over the row's warps, in another
// order than the plain version's, and v*v+acc contracts into one fused
// multiply-add, so float results differ from it at rounding scale.
//
// Bound on the H100: bytes.  One call must read x (and res) and write out,
// (2 or 3) * rows * d * sizeof(T) bytes, against ~4 flops per element: far
// below the card's balance point, so the least time is bytes over 3.35
// TB/s, reached only with enough loads in flight on every SM.  The design:
//
//   * each row is read from device memory once and kept in registers
//     (kN vectors a thread), then scaled and written once;
//   * 16-byte loads and stores (float4, 8 x half/bfloat16, double2) for x,
//     res, w and out when d * sizeof(T) is a multiple of 16 and every
//     pointer is 16-byte aligned; otherwise the same kernel moves one
//     element at a time (the scalar path: an odd d, or a view at an odd
//     storage offset).  The launcher picks the path from d and the pointer
//     bits;
//   * a group of tpr threads owns a row.  Where rows are many (the prefill
//     shapes), the group is the fewest threads that hold the row in
//     registers -- one warp at d = 128 (one float4 a lane), two at d = 1024
//     -- so the card fills with independent rows ("many": enough groups
//     for 1024 threads on each of the device's SMs).  Where rows are few (the
//     decode shapes, 8 x 1024), the group is one vector a thread, up to a
//     1024-thread block, so all of a row's loads are in flight at once and
//     the call costs about one round trip to memory.  The groups' sums meet
//     in shared memory;
//   * a row too long for registers (more than 1024 threads x kMaxN vectors:
//     d > 16384 float or half, > 8192 double, > 4096 on the scalar path)
//     is walked twice by one 1024-thread block, the second read from L2.
//
// The backward (rms_norm_bwd_launch; the JAX package has no backward
// kernel: XLA differentiates its plain reference).  With v = x (+ res),
// r = 1 / sqrt(mean(v * v) + eps), g = dy * w:
//
//   dx = dres = r g - v r^3 mean(g * v),   dw = sum over rows of dy v r,
//
// in T for float and double (a double input is computed in double, the
// exact gradient of the formula; other dtypes are refused).  r is
// recomputed from x (+ res), not saved by the forward.  Three kernels:
//   * dx: one warp a row, two passes over the row (the second from L1/L2),
//     which also writes each row's r to a scratch vector;
//   * dw partials: a 32-column x 8-row block sums dy v r over a fixed
//     chunk of rows (consecutive lanes on consecutive columns), the 8 row
//     lanes then in shared memory in a fixed order: one partial row per
//     chunk;
//   * dw: one thread a column sums the chunks' partials in chunk order.
// No atomics: the same inputs give the same bits on every call.  Bound:
// bytes, (3 or 4) * rows * d * sizeof(T) read and written once; this
// version reads x, res and dy twice (dx, then the partials).
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;    // a row's group is at most one block
constexpr int kBlock = 256;          // block size when a group is smaller

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(double v) { return (float)v; }
__device__ __forceinline__ float load_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ double store_as<double>(float v) { return (double)v; }
template <> __device__ __forceinline__ __half store_as<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T moved as one aligned access (16 bytes on the vector path)
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&f)[V]) {
  const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = load_f(q.v[e]);
}

// the float weight of V elements, in pieces of at most 16 bytes
template <int V>
__device__ __forceinline__ void load_w(const float* p, float (&f)[V]) {
  constexpr int W = V < 4 ? V : 4;
#pragma unroll
  for (int e = 0; e < V; e += W) {
    const Pack<float, W> q = *reinterpret_cast<const Pack<float, W>*>(p + e);
#pragma unroll
    for (int k = 0; k < W; ++k) f[e + k] = q.v[k];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, const float (&f)[V]) {
  Pack<T, V> q;
#pragma unroll
  for (int e = 0; e < V; ++e) q.v[e] = store_as<T>(f[e]);
  *reinterpret_cast<Pack<T, V>*>(p) = q;
}

template <typename T, bool kRes, int V>
__device__ __forceinline__ void load_v(const T* x, const T* res, int64_t at,
                                       float (&v)[V]) {
  load_row<T, V>(x + at, v);
  if (kRes) {
    float r[V];
    load_row<T, V>(res + at, r);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] += r[e];
  }
}

// A group of tpr threads (a multiple of 32) owns row r; blockDim.x / tpr
// rows a block.  The row is nv = d / V vectors of V elements; thread t
// holds vectors t, t + tpr, ..., kN of them, in registers.  kN == 0: the
// row does not fit, and is walked twice.
template <typename T, bool kRes, int V, int kN>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ w, T* __restrict__ out,
                int64_t rows, int d, int tpr, float eps) {
  __shared__ float partial[kMaxThreads / 32];
  const int t = threadIdx.x % tpr;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = r < rows;
  const int nv = d / V;
  const int64_t row = r * d;
  constexpr int kHeld = kN > 0 ? kN : 1;
  float v[kHeld][V], wv[kHeld][V];
  float ss = 0.f;
  if (kN > 0) {
    // every load of the row is issued before the first use
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int q = t + k * tpr;
      if (live && q < nv) {
        load_v<T, kRes, V>(x, res, row + (int64_t)q * V, v[k]);
        load_w<V>(w + q * V, wv[k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kHeld; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[k][e] * v[k][e];
  } else {
    for (int q = t; live && q < nv; q += tpr) {
      float u[V];
      load_v<T, kRes, V>(x, res, row + (int64_t)q * V, u);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += u[e] * u[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {  // uniform over the block: the row's warps meet in shared memory
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr >> 5);
    ss = 0.f;
    for (int i = 0; i < (tpr >> 5); ++i) ss += partial[first + i];
  }
  if (!live) return;
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  if (kN > 0) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int q = t + k * tpr;
      if (q < nv) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = v[k][e] * inv * wv[k][e];
        store_row<T, V>(out + row + (int64_t)q * V, o);
      }
    }
  } else {
    for (int q = t; q < nv; q += tpr) {
      float u[V], wq[V], o[V];
      load_v<T, kRes, V>(x, res, row + (int64_t)q * V, u);
      load_w<V>(w + q * V, wq);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = u[e] * inv * wq[e];
      store_row<T, V>(out + row + (int64_t)q * V, o);
    }
  }
}

template <typename T, bool kRes, int V, int kN>
int launch_n(const T* x, const T* res, const float* w, T* out, int64_t rows,
             int d, int tpr, float eps, cudaStream_t stream) {
  const int per_block = tpr < kBlock ? kBlock / tpr : 1;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<T, kRes, V, kN><<<(int)blocks, per_block * tpr, 0, stream>>>(
      x, res, w, out, rows, d, tpr, eps);
  return (int)cudaGetLastError();
}

// The current device's multiprocessor count (132 on the H100 SXM), read
// once: the launch policies below size their grids by it.
int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

int pow2_at_least(int v) {
  int p = 32;
  while (p < v) p <<= 1;
  return p;
}

// Threads per row and vectors per thread for nv vectors a row; kMaxN is the
// most vectors a thread holds (16 floats: 4 float4, 2 x 8 half/bfloat16,
// 4 double2; 4 scalars).
template <typename T, bool kRes, int V>
int launch_v(const T* x, const T* res, const float* w, T* out, int64_t rows,
             int d, float eps, cudaStream_t stream) {
  constexpr int kMaxN = (V == 8) ? 2 : 4;
  const int nv = d / V;
  // many rows: the fewest threads that hold a row, if the card still gets
  // a full complement of threads on every SM
  const int few = pow2_at_least((nv + kMaxN - 1) / kMaxN);
  int tpr;
  if (few <= kBlock && rows * few >= (int64_t)sm_count() * kMaxThreads)
    tpr = few;
  else  // few rows: one vector a thread, as far as one block goes
    tpr = nv < kMaxThreads ? (nv + 31) / 32 * 32 : kMaxThreads;
  const int n = (nv + tpr - 1) / tpr;
  if (n == 1) return launch_n<T, kRes, V, 1>(x, res, w, out, rows, d, tpr, eps, stream);
  if (n == 2) return launch_n<T, kRes, V, 2>(x, res, w, out, rows, d, tpr, eps, stream);
  if (n <= kMaxN) return launch_n<T, kRes, V, kMaxN>(x, res, w, out, rows, d, tpr, eps, stream);
  return launch_n<T, kRes, V, 0>(x, res, w, out, rows, d, kMaxThreads, eps, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kRes>
int launch_r(const void* xp, const void* resp, const float* w, void* outp,
             int64_t rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* res = static_cast<const T*>(resp);
  T* out = static_cast<T*>(outp);
  if (d % V == 0 && aligned16(x) && aligned16(w) && aligned16(out) &&
      (!kRes || aligned16(res)))
    return launch_v<T, kRes, V>(x, res, w, out, rows, d, eps, stream);
  return launch_v<T, kRes, 1>(x, res, w, out, rows, d, eps, stream);
}

template <typename T>
int launch(const void* x, const void* res, const float* w, void* out,
           int64_t rows, int d, float eps, cudaStream_t stream) {
  if (res == nullptr)
    return launch_r<T, false>(x, nullptr, w, out, rows, d, eps, stream);
  return launch_r<T, true>(x, res, w, out, rows, d, eps, stream);
}

// ---- backward ----

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return 1.0f / sqrtf(ss / (float)d + eps);
}
__device__ __forceinline__ double inv_rms(double ss, int d, double eps) {
  return 1.0 / sqrt(ss / (double)d + eps);
}

template <typename T, bool kRes>
__device__ __forceinline__ T v_at(const T* x, const T* res, int64_t at) {
  return kRes ? x[at] + res[at] : x[at];
}

constexpr int kBwdThreads = 256;

// dx (= dres) and r per row; one warp a row
template <typename T, bool kRes>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const T* __restrict__ w, const T* __restrict__ dy,
                       T* __restrict__ dx, T* __restrict__ rinv,
                       int64_t rows, int d, T eps) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int64_t row = r * d;
  T ss = T(0), dot = T(0);
  for (int j = lane; j < d; j += 32) {
    const T v = v_at<T, kRes>(x, res, row + j);
    ss += v * v;
    dot += dy[row + j] * w[j] * v;
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  const T inv = inv_rms(ss, d, eps);
  const T coef = inv * inv * inv * (dot / (T)d);
  for (int j = lane; j < d; j += 32) {
    const T v = v_at<T, kRes>(x, res, row + j);
    dx[row + j] = inv * (dy[row + j] * w[j]) - v * coef;
  }
  if (lane == 0) rinv[r] = inv;
}

// partial[c][j] = sum over rows [c * rpc, (c + 1) * rpc) of dy v r
template <typename T, bool kRes>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_dw_partial_kernel(const T* __restrict__ x,
                               const T* __restrict__ res,
                               const T* __restrict__ dy,
                               const T* __restrict__ rinv,
                               T* __restrict__ partial, int64_t rows, int d,
                               int64_t rpc) {
  __shared__ T part[kBwdThreads / 32][32];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + cx;
  const int64_t r0 = (int64_t)blockIdx.y * rpc;
  const int64_t r1 = r0 + rpc < rows ? r0 + rpc : rows;
  T acc = T(0);
  if (j < d)
    for (int64_t r = r0 + ry; r < r1; r += kBwdThreads / 32) {
      const int64_t at = r * d + j;
      acc += dy[at] * v_at<T, kRes>(x, res, at) * rinv[r];
    }
  part[ry][cx] = acc;
  __syncthreads();
  if (ry == 0 && j < d) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < kBwdThreads / 32; ++i) s += part[i][cx];
    partial[(int64_t)blockIdx.y * d + j] = s;
  }
}

// dw[j] = sum over chunks c (in order) of partial[c][j]
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_dw_kernel(const T* __restrict__ partial, T* __restrict__ dw,
                       int d, int nchunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  T s = T(0);
  for (int c = 0; c < nchunks; ++c) s += partial[(int64_t)c * d + j];
  dw[j] = s;
}

template <typename T, bool kRes>
int launch_bwd(const void* xp, const void* resp, const void* wp,
               const void* dyp, void* dxp, void* dwp, void* rinvp,
               void* partialp, int64_t rows, int d, int64_t rpc, int nchunks,
               double eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* res = static_cast<const T*>(resp);
  const T* dy = static_cast<const T*>(dyp);
  T* rinv = static_cast<T*>(rinvp);
  T* partial = static_cast<T*>(partialp);
  const int64_t blocks = (rows * 32 + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 0x7fffffff || nchunks > 65535 ||
      (int64_t)nchunks * rpc < rows)
    return (int)cudaErrorInvalidValue;
  rms_norm_bwd_dx_kernel<T, kRes><<<(int)blocks, kBwdThreads, 0, stream>>>(
      x, res, static_cast<const T*>(wp), dy, static_cast<T*>(dxp), rinv, rows,
      d, (T)eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((d + 31) / 32, nchunks);
  rms_norm_bwd_dw_partial_kernel<T, kRes><<<grid, kBwdThreads, 0, stream>>>(
      x, res, dy, rinv, partial, rows, d, rpc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rms_norm_bwd_dw_kernel<T><<<(d + kBwdThreads - 1) / kBwdThreads,
                              kBwdThreads, 0, stream>>>(
      partial, static_cast<T*>(dwp), d, nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_r(const void* x, const void* res, const void* w, const void* dy,
                 void* dx, void* dw, void* rinv, void* partial, int64_t rows,
                 int d, int64_t rpc, int nchunks, double eps,
                 cudaStream_t stream) {
  if (res == nullptr)
    return launch_bwd<T, false>(x, nullptr, w, dy, dx, dw, rinv, partial,
                                rows, d, rpc, nchunks, eps, stream);
  return launch_bwd<T, true>(x, res, w, dy, dx, dw, rinv, partial, rows, d,
                             rpc, nchunks, eps, stream);
}

}  // namespace

// The backward.  dtype codes as below, 0 float32 or 1 float64 only; w, dw,
// the rows' r (rinv, rows long) and the partials (nchunks x d) are of the
// dtype; res may be null; rows of rpc per chunk, nchunks * rpc >= rows.
// dx is also dres.  Returns the cudaError_t of the three launches.
extern "C" int rms_norm_bwd_launch(int dtype, const void* x, const void* res,
                                   const void* w, const void* dy, void* dx,
                                   void* dw, void* rinv, void* partial,
                                   long long rows, int d, long long rpc,
                                   int nchunks, double eps, void* stream) {
  if (rows <= 0 || d <= 0 || rpc <= 0 || nchunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd_r<float>(x, res, w, dy, dx, dw, rinv, partial, rows, d, rpc, nchunks, eps, st);
    case 1: return launch_bwd_r<double>(x, res, w, dy, dx, dw, rinv, partial, rows, d, rpc, nchunks, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype codes shared with repro_torch/kernels/rmsnorm.py:
//   0 float32, 1 float64, 2 float16, 3 bfloat16.
// res may be null (no residual).  Returns the cudaError_t of the launch
// (0 = success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int rms_norm_launch(int dtype, const void* x, const void* res,
                               const void* w, void* out, long long rows,
                               int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  switch (dtype) {
    case 0: return launch<float>(x, res, wf, out, rows, d, eps, st);
    case 1: return launch<double>(x, res, wf, out, rows, d, eps, st);
    case 2: return launch<__half>(x, res, wf, out, rows, d, eps, st);
    case 3: return launch<__nv_bfloat16>(x, res, wf, out, rows, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
