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
// exact gradient of the formula), and for bfloat16 in float: x, res and dy
// read as bfloat16, w, the statistics, the dw partials and dw in float, dx
// rounded to bfloat16 once (float16 is refused).  r is
// recomputed from x (+ res), not saved by the forward.  Bound: bytes,
// (3 or 4) * rows * d * sizeof(T), each of x, res, dy read once and dx
// written once.  Two launches, no atomics:
//   * rms_norm_bwd_kernel, one pass over the rows.  Each block walks a
//     fixed, contiguous chunk of rows; a group of tpr threads owns a row
//     and holds its v and dy in registers (16-byte loads, as the forward;
//     at most 4 vectors a thread, so one warp holds 4 rows at d = 128 and
//     two warps one row at d = 1024), sums v*v and g*v in one sweep (over
//     the lanes by shuffles, over the group's warps in shared memory under
//     a named barrier of the group alone), writes dx once and adds dy v r
//     to per-thread column sums.  A thread keeps the same columns (and
//     their w, loaded once) for every row of its block, so at the end the
//     block's groups meet in shared memory in group order and the block
//     writes one partial row of dw;
//   * rms_norm_bwd_dw_kernel sums the partial rows in a fixed order (lane
//     l of 32 takes chunks l, l + 32, ... in turn, then the 32 lane sums in
//     lane order).
// The group size comes from d, the chunks from (rows, d) (the caller's
// rows per chunk): never from the card, so the same inputs give the same
// bits on every call and every card.  A row too long for registers (d >
// 16384 float, > 8192 double, > 4096 on the scalar path) is walked twice
// by one 1024-thread block, and its column sums go to the block's partial
// row in device memory, row by row.
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

// V elements of T moved as one aligned access (16 bytes on the vector path;
// the backward's float vectors of bfloat16 rows, 32 bytes, as two)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack { T v[V]; };

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

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return 1.0f / sqrtf(ss / (float)d + eps);
}
__device__ __forceinline__ double inv_rms(double ss, int d, double eps) {
  return 1.0 / sqrt(ss / (double)d + eps);
}

// the backward's storage type T to its compute type A and back: A is T
// for float and double, float for bfloat16
__device__ __forceinline__ float acc_of(float v) { return v; }
__device__ __forceinline__ double acc_of(double v) { return v; }
__device__ __forceinline__ float acc_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(double& d, double v) { d = v; }
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

template <typename T, typename A, int V>
__device__ __forceinline__ void load_t(const T* p, A (&f)[V]) {
  const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = acc_of(q.v[e]);
}

template <typename T, typename A, int V>
__device__ __forceinline__ void store_t(T* p, const A (&f)[V]) {
  Pack<T, V> q;
#pragma unroll
  for (int e = 0; e < V; ++e) put(q.v[e], f[e]);
  *reinterpret_cast<Pack<T, V>*>(p) = q;
}

template <typename T, bool kRes, int V, typename A>
__device__ __forceinline__ void load_vt(const T* x, const T* res, int64_t at,
                                        A (&v)[V]) {
  load_t<T>(x + at, v);
  if (kRes) {
    A u[V];
    load_t<T>(res + at, u);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] += u[e];
  }
}

constexpr int kBwdBlock = 256;   // block size when a row's group is smaller
constexpr int kBwdMaxN = 4;      // vectors a thread holds per tensor

// Sums a and b over the tpr threads of group grp (tpr a power of 2, the
// group's threads consecutive): over the lanes by a butterfly of shuffles
// (every lane ends with the same bits), then, for a group of several
// warps, over its warps in order through red (2 slots a warp), behind a
// named barrier of the group's threads alone.
template <typename T>
__device__ __forceinline__ void group_sum2(T& a, T& b, int tpr, int grp,
                                           T* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, nw = tpr >> 5, first = grp * nw;
    if ((threadIdx.x & 31) == 0) {
      red[2 * warp] = a;
      red[2 * warp + 1] = b;
    }
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(tpr) : "memory");
    a = T(0);
    b = T(0);
    for (int i = 0; i < nw; ++i) {
      a += red[2 * (first + i)];
      b += red[2 * (first + i) + 1];
    }
  }
}

// One pass: block c walks rows [c * rpc, min((c + 1) * rpc, rows)), its
// blockDim / tpr groups taking rows base + grp for base = c * rpc, c * rpc
// + groups, ...; writes dx and partial[c][:].  Thread t of a group holds
// vectors t, t + tpr, ... (kN of them) of each row, and the same vectors of
// w and of its column sums for all the block's rows.  kN == 0: the row
// does not fit, one group of kThreads walks it twice.  x, res, dy and dx
// are T; w, the partials and every sum are the compute type A.
template <typename T, typename A, bool kRes, int V, int kN, int kThreads>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const A* __restrict__ w, const T* __restrict__ dy,
                    T* __restrict__ dx, A* __restrict__ partial,
                    int64_t rows, int d, int tpr, int64_t rpc, A eps) {
  constexpr int kHeld = kN > 0 ? kN : 1;
  // the groups' column sums meet here (several groups: kThreads == kBwdBlock)
  constexpr int kCols = kThreads == kBwdBlock ? kBwdBlock * kHeld * V : 1;
  __shared__ __align__(16) A cols[kCols];
  __shared__ A red[2][2 * kThreads / 32];   // two buffers: rows alternate
  const int t = threadIdx.x % tpr, grp = threadIdx.x / tpr;
  const int groups = blockDim.x / tpr;
  const int nv = d / V;
  const int64_t r0 = (int64_t)blockIdx.x * rpc;
  const int64_t r1 = r0 + rpc < rows ? r0 + rpc : rows;
  A* out = partial + (int64_t)blockIdx.x * d;
  A wv[kHeld][V], acc[kHeld][V];
  if (kN > 0) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int q = t + k * tpr;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k][e] = wv[k][e] = A(0);
      if (q < nv) load_t<A>(w + q * V, wv[k]);
    }
  }
  int it = 0;
  for (int64_t base = r0; base < r1; base += groups, ++it) {
    const int64_t r = base + grp;
    const bool live = r < r1;
    const int64_t row = r * d;
    A ss = A(0), dot = A(0);
    if (kN > 0) {
      A v[kHeld][V], g[kHeld][V];   // g: dy, as loaded
      // every load of the row is issued before the first use
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int q = t + k * tpr;
        if (live && q < nv) {
          load_vt<T, kRes>(x, res, row + (int64_t)q * V, v[k]);
          load_t<T>(dy + row + (int64_t)q * V, g[k]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[k][e] = g[k][e] = A(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss += v[k][e] * v[k][e];
          dot += g[k][e] * wv[k][e] * v[k][e];
        }
      group_sum2(ss, dot, tpr, grp, red[it & 1]);
      if (live) {
        const A inv = inv_rms(ss, d, eps);
        const A coef = inv * inv * inv * (dot / (A)d);
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
          const int q = t + k * tpr;
          if (q < nv) {
            A o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              o[e] = inv * (g[k][e] * wv[k][e]) - v[k][e] * coef;
              acc[k][e] += g[k][e] * v[k][e] * inv;
            }
            store_t<T>(dx + row + (int64_t)q * V, o);
          }
        }
      }
    } else {
      for (int q = t; live && q < nv; q += tpr) {
        A u[V], gq[V], wq[V];
        load_vt<T, kRes>(x, res, row + (int64_t)q * V, u);
        load_t<T>(dy + row + (int64_t)q * V, gq);
        load_t<A>(w + q * V, wq);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss += u[e] * u[e];
          dot += gq[e] * wq[e] * u[e];
        }
      }
      group_sum2(ss, dot, tpr, grp, red[it & 1]);
      if (live) {
        const A inv = inv_rms(ss, d, eps);
        const A coef = inv * inv * inv * (dot / (A)d);
        for (int q = t; q < nv; q += tpr) {
          A u[V], gq[V], wq[V], o[V], p[V];
          load_vt<T, kRes>(x, res, row + (int64_t)q * V, u);
          load_t<T>(dy + row + (int64_t)q * V, gq);
          load_t<A>(w + q * V, wq);
          if (r == r0) {
#pragma unroll
            for (int e = 0; e < V; ++e) p[e] = A(0);
          } else {   // this thread's own earlier store
            load_t<A>(out + q * V, p);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            o[e] = inv * (gq[e] * wq[e]) - u[e] * coef;
            p[e] += gq[e] * u[e] * inv;
          }
          store_t<T>(dx + row + (int64_t)q * V, o);
          store_t<A>(out + q * V, p);
        }
      }
    }
  }
  if (kN == 0) return;   // the partial row is written
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int q = t + k * tpr;
      if (q < nv) store_t<A>(out + q * V, acc[k]);
    }
    return;
  }
  // groups * d <= kCols: tpr * kN * V >= d
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int q = t + k * tpr;
    if (q < nv) store_t<A>(cols + grp * d + q * V, acc[k]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    A s = A(0);
    for (int i = 0; i < groups; ++i) s += cols[i * d + j];
    out[j] = s;
  }
}

constexpr int kDwLanes = 32;

// dw[j] = the partial rows' sum: lane l of kDwLanes sums chunks l, l +
// kDwLanes, ... in turn, then the lanes' sums are added in lane order
template <typename T>
__global__ void __launch_bounds__(32 * kDwLanes)
rms_norm_bwd_dw_kernel(const T* __restrict__ partial, T* __restrict__ dw,
                       int d, int nchunks) {
  __shared__ T part[kDwLanes][33];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + cx;
  T s = T(0);
  if (j < d)
    for (int c = ry; c < nchunks; c += kDwLanes) s += partial[(int64_t)c * d + j];
  part[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && j < d) {
    T sum = T(0);
#pragma unroll
    for (int i = 0; i < kDwLanes; ++i) sum += part[i][cx];
    dw[j] = sum;
  }
}

template <typename T, typename A, bool kRes, int V, int kN, int kThreads>
int launch_bwd_n(const T* x, const T* res, const A* w, const T* dy, T* dx,
                 A* partial, int64_t rows, int d, int tpr, int64_t rpc,
                 int nchunks, A eps, cudaStream_t stream) {
  const int threads = tpr < kBwdBlock ? kBwdBlock : tpr;
  rms_norm_bwd_kernel<T, A, kRes, V, kN, kThreads><<<nchunks, threads, 0, stream>>>(
      x, res, w, dy, dx, partial, rows, d, tpr, rpc, eps);
  return (int)cudaGetLastError();
}

// The group size: the fewest threads (a power of 2) that hold a row in
// kBwdMaxN vectors each, from d alone.
template <typename T, typename A, bool kRes, int V>
int launch_bwd_v(const T* x, const T* res, const A* w, const T* dy, T* dx,
                 A* partial, int64_t rows, int d, int64_t rpc, int nchunks,
                 A eps, cudaStream_t stream) {
  const int nv = d / V;
  int tpr = 1;
  while (tpr * kBwdMaxN < nv) tpr <<= 1;
  if (tpr > kMaxThreads)
    return launch_bwd_n<T, A, kRes, V, 0, kMaxThreads>(
        x, res, w, dy, dx, partial, rows, d, kMaxThreads, rpc, nchunks, eps,
        stream);
  const int n = (nv + tpr - 1) / tpr;
  if (tpr > kBwdBlock)  // then n > 2
    return launch_bwd_n<T, A, kRes, V, kBwdMaxN, kMaxThreads>(
        x, res, w, dy, dx, partial, rows, d, tpr, rpc, nchunks, eps, stream);
  if (n == 1)
    return launch_bwd_n<T, A, kRes, V, 1, kBwdBlock>(
        x, res, w, dy, dx, partial, rows, d, tpr, rpc, nchunks, eps, stream);
  if (n == 2)
    return launch_bwd_n<T, A, kRes, V, 2, kBwdBlock>(
        x, res, w, dy, dx, partial, rows, d, tpr, rpc, nchunks, eps, stream);
  return launch_bwd_n<T, A, kRes, V, kBwdMaxN, kBwdBlock>(
      x, res, w, dy, dx, partial, rows, d, tpr, rpc, nchunks, eps, stream);
}

template <typename T, typename A, bool kRes>
int launch_bwd(const void* xp, const void* resp, const void* wp,
               const void* dyp, void* dxp, void* dwp, void* partialp,
               int64_t rows, int d, int64_t rpc, int nchunks, double eps,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* res = static_cast<const T*>(resp);
  const A* w = static_cast<const A*>(wp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  A* partial = static_cast<A*>(partialp);
  if ((int64_t)nchunks * rpc < rows || (int64_t)(nchunks - 1) * rpc >= rows)
    return (int)cudaErrorInvalidValue;
  const int e =
      d % V == 0 && aligned16(x) && aligned16(w) && aligned16(dy) &&
              aligned16(dx) && (!kRes || aligned16(res))
          ? launch_bwd_v<T, A, kRes, V>(x, res, w, dy, dx, partial, rows, d,
                                        rpc, nchunks, (A)eps, stream)
          : launch_bwd_v<T, A, kRes, 1>(x, res, w, dy, dx, partial, rows, d,
                                        rpc, nchunks, (A)eps, stream);
  if (e != (int)cudaSuccess) return e;
  rms_norm_bwd_dw_kernel<A><<<(d + 31) / 32, 32 * kDwLanes, 0, stream>>>(
      partial, static_cast<A*>(dwp), d, nchunks);
  return (int)cudaGetLastError();
}

template <typename T, typename A = T>
int launch_bwd_r(const void* x, const void* res, const void* w, const void* dy,
                 void* dx, void* dw, void* partial, int64_t rows, int d,
                 int64_t rpc, int nchunks, double eps, cudaStream_t stream) {
  if (res == nullptr)
    return launch_bwd<T, A, false>(x, nullptr, w, dy, dx, dw, partial, rows,
                                   d, rpc, nchunks, eps, stream);
  return launch_bwd<T, A, true>(x, res, w, dy, dx, dw, partial, rows, d, rpc,
                                nchunks, eps, stream);
}

}  // namespace

// The backward.  dtype codes as below, 0 float32, 1 float64 or 3 bfloat16;
// w, dw and the partials (nchunks x d) are of the compute type (the dtype;
// float for bfloat16); res may be null; rows of
// rpc per chunk, nchunks = ceil(rows / rpc).  dx is also dres.  Returns the
// cudaError_t of the two launches.
extern "C" int rms_norm_bwd_launch(int dtype, const void* x, const void* res,
                                   const void* w, const void* dy, void* dx,
                                   void* dw, void* partial, long long rows,
                                   int d, long long rpc, int nchunks,
                                   double eps, void* stream) {
  if (rows <= 0 || d <= 0 || rpc <= 0 || nchunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd_r<float>(x, res, w, dy, dx, dw, partial, rows, d, rpc, nchunks, eps, st);
    case 1: return launch_bwd_r<double>(x, res, w, dy, dx, dw, partial, rows, d, rpc, nchunks, eps, st);
    case 3: return launch_bwd_r<__nv_bfloat16, float>(x, res, w, dy, dx, dw, partial, rows, d, rpc, nchunks, eps, st);
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
