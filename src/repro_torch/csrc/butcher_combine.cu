// Fused Runge-Kutta stage combination for Hopper (sm_90a).
//
// Two kernels over a stacked slope buffer ks of shape (s, n), s <= 13:
//
//   butcher_combine       out[j]    = x[j] + sum_{i<s} hc[i] * ks[i][j]
//     replaces repro/kernels/butcher_combine.py::butcher_combine_pallas
//     (Pallas body _kernel).
//   butcher_combine_rows  out[r][j] = sc[r] * x[j] + sum_{i<s} hc[r][i] * ks[i][j]
//     for r < m <= 13, all m rows from ONE read of (x, ks)
//     replaces repro/kernels/butcher_combine.py::butcher_combine_rows_pallas
//     (Pallas body _rows_kernel).
//
// hc (and sc) are device arrays in the accumulation type, already scaled by
// the step size on the device: the coefficient rows of the backward
// recursion depend on h at run time, so they are data, never constants of
// the build, and the host never reads them.
//
// Accumulation type is promote(T, float): float for float/half/bfloat16
// states, double for double states, strictly in stage order i = 0..s-1 --
// the order of the plain PyTorch versions in repro_torch/kernels/ref.py.
// The compiler contracts acc + hc*k into one fused multiply-add, so float
// results differ from the plain version (two roundings) at rounding scale.
//
// Bound on the H100: both kernels are purely memory-bound.  One pass moves
// (s+2)*n*sizeof(T) bytes for one row and (s+1+m)*n*sizeof(T) for m rows,
// against 2*s*n (or 2*m*s*n) flops: at most ~0.25 flop/byte in float, far
// below the card's ~20 flop/byte balance point, so the least time is bytes
// over 3.35 TB/s.  At the solver's sizes (n ~ 1e4, ~0.1 us of bytes) a
// call costs its fixed overhead and one round trip to memory instead.
//
// butcher_combine: one vector of V elements a thread, consecutive threads
// on consecutive vectors so every stage row is read coalesced, and a grid
// sized for the vector count.  V = 16 / sizeof(T) (float4, double2, 8 x
// half/bfloat16) when n * sizeof(T) is a multiple of 16 and x, ks and out
// are 16-byte aligned, so each row start is too; otherwise V = 1 (the
// scalar path: an odd n, or a view at an odd storage offset).  The kernel
// is a template on the stage count s (1..13), so all s stage loads of a
// vector and the s coefficients are issued before the first FMA, with no
// predicates and few registers; the sums then run in stage order.  The
// launcher picks V from n and the pointer bits and s from its argument,
// and halves the block (256 threads down to 32) while the grid would
// cover fewer blocks than the card has SMs (read from the device; 132 on
// the H100 SXM): at n ~ 1e4 the call is one round trip to memory, and
// spreading the bytes over more SMs shortens it.
//
// butcher_combine_rows: one element a thread an iteration, the stage loads
// unrolled the same way and kept in registers for all m rows; the
// coefficients sit in shared memory.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 13;
constexpr int kMaxRows = 13;
constexpr int kThreads = 256;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load_acc(float v) { return v; }
__device__ __forceinline__ double load_acc(double v) { return v; }
__device__ __forceinline__ float load_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float load_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T store_as(typename Acc<T>::type v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ double store_as<double>(double v) { return v; }
template <> __device__ __forceinline__ __half store_as<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T moved as one aligned access (16 bytes on the vector path)
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V, int S>
__global__ void __launch_bounds__(kThreads)
butcher_combine_kernel(const T* __restrict__ x, const T* __restrict__ ks,
                       const typename Acc<T>::type* __restrict__ hc,
                       T* __restrict__ out, int64_t n) {
  using A = typename Acc<T>::type;
  using P = Pack<T, V>;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n / V) return;
  const int64_t j = q * V;
  A c[S];
  P k[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    c[i] = hc[i];
    k[i] = *reinterpret_cast<const P*>(ks + i * n + j);
  }
  const P xv = *reinterpret_cast<const P*>(x + j);
  A acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = load_acc(xv.v[e]);
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = acc[e] + c[i] * load_acc(k[i].v[e]);
  P o;
#pragma unroll
  for (int e = 0; e < V; ++e) o.v[e] = store_as<T>(acc[e]);
  *reinterpret_cast<P*>(out + j) = o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
butcher_combine_rows_kernel(const T* __restrict__ x, const T* __restrict__ ks,
                            const typename Acc<T>::type* __restrict__ hc,
                            const typename Acc<T>::type* __restrict__ sc,
                            T* __restrict__ out, int64_t n, int s, int m) {
  using A = typename Acc<T>::type;
  __shared__ A shc[kMaxRows * kMaxStages];
  __shared__ A ssc[kMaxRows];
  for (int q = threadIdx.x; q < m * s; q += blockDim.x) shc[q] = hc[q];
  if (threadIdx.x < m) ssc[threadIdx.x] = sc[threadIdx.x];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const A xv = load_acc(x[j]);
    // each slope element is read once and kept in registers for all m rows
    // (the loops are unrolled to kMaxStages so k[] is never spilled to
    // local memory; stages past s are predicated off).
    A k[kMaxStages];
#pragma unroll
    for (int i = 0; i < kMaxStages; ++i)
      if (i < s) k[i] = load_acc(ks[i * n + j]);
    for (int r = 0; r < m; ++r) {
      A acc = ssc[r] * xv;
#pragma unroll
      for (int i = 0; i < kMaxStages; ++i)
        if (i < s) acc = acc + shc[r * s + i] * k[i];
      out[r * n + j] = store_as<T>(acc);
    }
  }
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

int grid_for(int64_t n) {
  // enough blocks to cover n once, capped at 16 resident blocks per SM;
  // the grid-stride loop covers the rest.
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * 16;
  return (int)(blocks < cap ? blocks : cap);
}

template <typename T, int V, int S = 1>
int launch_one_v(const T* x, const T* ks, const typename Acc<T>::type* hc,
                 T* out, int64_t n, int s, cudaStream_t stream) {
  if (s != S) {
    if constexpr (S < kMaxStages)
      return launch_one_v<T, V, S + 1>(x, ks, hc, out, n, s, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int64_t nvec = n / V;
  const int sms = sm_count();
  int threads = kThreads;
  while (threads > 32 && (nvec + threads - 1) / threads < sms) threads >>= 1;
  const int64_t blocks = (nvec + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  butcher_combine_kernel<T, V, S><<<(int)blocks, threads, 0, stream>>>(
      x, ks, hc, out, n);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_one(const void* x, const void* ks, const void* hc, void* out,
               int64_t n, int s, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(ks);
  const A* ht = static_cast<const A*>(hc);
  T* ot = static_cast<T*>(out);
  if (n % V == 0 && aligned16(x) && aligned16(ks) && aligned16(out))
    return launch_one_v<T, V>(xt, kt, ht, ot, n, s, stream);
  return launch_one_v<T, 1>(xt, kt, ht, ot, n, s, stream);
}

template <typename T>
int launch_rows(const void* x, const void* ks, const void* hc, const void* sc,
                void* out, int64_t n, int s, int m, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  butcher_combine_rows_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ks),
      static_cast<const A*>(hc), static_cast<const A*>(sc),
      static_cast<T*>(out), n, s, m);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with repro_torch/kernels/butcher_combine.py:
//   0 float32, 1 float64, 2 float16, 3 bfloat16.
// Both entry points return the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int butcher_combine_launch(int dtype, const void* x, const void* ks,
                                      const void* hc, void* out, long long n,
                                      int s, void* stream) {
  if (n <= 0 || s < 1 || s > kMaxStages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_one<float>(x, ks, hc, out, n, s, st);
    case 1: return launch_one<double>(x, ks, hc, out, n, s, st);
    case 2: return launch_one<__half>(x, ks, hc, out, n, s, st);
    case 3: return launch_one<__nv_bfloat16>(x, ks, hc, out, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int butcher_combine_rows_launch(int dtype, const void* x,
                                           const void* ks, const void* hc,
                                           const void* sc, void* out,
                                           long long n, int s, int m,
                                           void* stream) {
  if (n <= 0 || s < 1 || s > kMaxStages || m < 1 || m > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_rows<float>(x, ks, hc, sc, out, n, s, m, st);
    case 1: return launch_rows<double>(x, ks, hc, sc, out, n, s, m, st);
    case 2: return launch_rows<__half>(x, ks, hc, sc, out, n, s, m, st);
    case 3: return launch_rows<__nv_bfloat16>(x, ks, hc, sc, out, n, s, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
