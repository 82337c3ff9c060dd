// Fused Runge-Kutta stage combination for Hopper (sm_90a), in lane form:
// what the two kernels share (csrc/butcher_combine.cu, the one-row kernel;
// csrc/butcher_combine_rows.cu, the m-row kernel).  Each source is built
// into its own library, so the two build in parallel.
//
// Both kernels work over a stacked slope buffer ks of shape (s, n), s <= 13,
// whose n elements are B lanes of n_lane each (element j is in lane
// b = j / n_lane), and every lane has its own coefficient row.  One row for
// the whole buffer is the case B = 1 (n_lane = n); a lane-batched solve
// (the JAX package vmaps rk_step over per-lane step sizes, which puts a lane
// axis into both Pallas grids) passes B rows, one launch for all lanes.
//
// The coefficient rows arrive as device arrays in the accumulation type,
// already scaled by the step size on the device: they depend on h at run
// time (per lane), so they are data, never constants of the build, and the
// host never reads them.
//
// Accumulation type is promote(T, float): float for float/half/bfloat16
// states, double for double states, strictly in stage order i = 0..s-1 --
// the order of the plain PyTorch versions in repro_torch/kernels/ref.py.
// The compiler contracts acc + c*k into one fused multiply-add, so float
// results differ from the plain version (two roundings) at rounding scale.
//
// Bound on the H100: both kernels are purely memory-bound.  One pass moves
// (s+2)*n*sizeof(T) bytes for one row and (s+1+m)*n*sizeof(T) for m rows
// (plus the coefficient rows), against 2*s*n (or 2*m*s*n) flops: at most
// ~0.25 flop/byte in float, far below the card's ~20 flop/byte balance
// point, so the least time is bytes over 3.35 TB/s.  At the solver's sizes
// (n ~ 1e4, ~0.1 us of bytes) a call costs its fixed overhead and one round
// trip to memory instead.
//
// Design, the same for both kernels: one vector of V elements a thread,
// consecutive threads on consecutive vectors so every stage row is read
// coalesced, and a grid sized for the vector count.  V = 16 / sizeof(T)
// (float4, double2, 8 x half/bfloat16) when n * sizeof(T) is a multiple of
// 16, x, ks and out are 16-byte aligned (so each row start is too), and a
// lane holds at least V elements; otherwise V = 1 (the scalar path: an odd
// n, a view at an odd storage offset, or lanes of 1..V-1 elements).  The
// kernels are templates on the stage count s (1..13), so all s stage loads
// of a vector are issued before the first FMA, with no predicates.  A vector
// need not start at a lane boundary (a lane of 43 floats puts most lane
// boundaries inside a float4), so it may hold the end of lane b0 and the
// start of lane b0 + 1: each thread reads both lanes' rows through the
// read-only cache (the same row twice when the vector lies in one lane;
// neighbouring threads read the same rows, so these loads hit in L1) and
// each element takes its own lane's coefficients by a select, with no
// branch.  The launcher picks V from n, n_lane and the pointer bits and s
// from its argument, and halves the block (256 threads down to 32) while the
// grid would cover fewer blocks than the card has SMs (read from the device;
// 132 on the H100 SXM): at n ~ 1e4 the call is one round trip to memory, and
// spreading the bytes over more SMs shortens it.
#pragma once

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

// The lanes of a vector's first element (b0) and last (b1 = b0 or b0 + 1:
// a lane holds at least V elements on the vector path), and the first
// element index in the vector that lies in lane b1 (<= 0 when b1 == b0).
struct Lanes { int64_t b0, b1, split; };

template <int V>
__device__ __forceinline__ Lanes lanes_of(int64_t j, int64_t n_lane, bool narrow) {
  // 32-bit division where every index fits: a 64-bit one costs several
  // times the instructions
  const int64_t b0 = narrow ? (int64_t)((uint32_t)j / (uint32_t)n_lane) : j / n_lane;
  const int64_t r0 = j - b0 * n_lane;
  const int64_t b1 = b0 + (r0 + V - 1 >= n_lane ? 1 : 0);
  return {b0, b1, b1 * n_lane - j};
}

// The current device's multiprocessor count (132 on the H100 SXM), read
// once: the launch policy below sizes its grid by it.
int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// Threads a block for nvec vectors: 256, halved down to 32 while the grid
// would cover fewer blocks than the card has SMs.
int block_threads(int64_t nvec) {
  const int sms = sm_count();
  int threads = kThreads;
  while (threads > 32 && (nvec + threads - 1) / threads < sms) threads >>= 1;
  return threads;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Args {
  const void* x;
  const void* ks;
  const void* hc;
  const void* sc;   // rows only
  void* out;
  int64_t n, n_lane;
  int s, m;         // m: rows only
};

// The launch policy of both kernels.  K::run<T, V, S> launches K's kernel
// for dtype T, vector width V and stage count S on the given grid.
template <typename K, typename T, int V, int S = 1>
int launch_s(const Args& a, cudaStream_t stream) {
  if (a.s != S) {
    if constexpr (S < kMaxStages)
      return launch_s<K, T, V, S + 1>(a, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int64_t nvec = a.n / V;
  const int threads = block_threads(nvec);
  const int64_t blocks = (nvec + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  K::template run<T, V, S>(a, (int)blocks, threads, a.n <= 0xffffffffLL, stream);
  return (int)cudaGetLastError();
}

template <typename K, typename T>
int launch_t(const Args& a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (a.n % V == 0 && a.n_lane >= V && aligned16(a.x) && aligned16(a.ks) &&
      aligned16(a.out))
    return launch_s<K, T, V>(a, stream);
  return launch_s<K, T, 1>(a, stream);
}

// dtype codes shared with repro_torch/kernels/butcher_combine.py:
//   0 float32, 1 float64, 2 float16, 3 bfloat16.
// n is the element count of x (B lanes of n_lane elements each; n_lane = n
// for a single coefficient row).  Returns the cudaError_t of the launch
// (0 = success), or cudaErrorInvalidValue for arguments the kernels do not
// take.
template <typename K>
int launch(int dtype, const Args& a, void* stream) {
  if (a.n <= 0 || a.n_lane <= 0 || a.n % a.n_lane != 0 || a.s < 1 ||
      a.s > kMaxStages || a.m < 1 || a.m > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<K, float>(a, st);
    case 1: return launch_t<K, double>(a, st);
    case 2: return launch_t<K, __half>(a, st);
    case 3: return launch_t<K, __nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
