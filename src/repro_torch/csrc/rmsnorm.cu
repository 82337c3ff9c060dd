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
// per lane and then over the warp, in another order than the plain
// version's, and v*v+acc contracts into one fused multiply-add, so float
// results differ from it at rounding scale.
//
// Bound on the H100: bytes.  One call must read x (and res) and write out,
// (2 or 3) * rows * d * sizeof(T) bytes, against ~4 flops per element: far
// below the card's balance point, so the least time is bytes over 3.35
// TB/s.  The design is the simple one: one warp per row, lanes on
// consecutive elements (coalesced), a grid-stride loop over rows; the row
// is read twice -- once for the sum of squares, once to scale it -- and the
// second read hits L1/L2 (a 1024-float row is 4 KB), so device memory sees
// each input once.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

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

template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ w, T* __restrict__ out,
                int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const T* xr = x + r * d;
    const T* rr = kRes ? res + r * d : nullptr;
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      float v = load_f(xr[j]);
      if (kRes) v += load_f(rr[j]);
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = 1.0f / sqrtf(ss / (float)d + eps);
    T* orow = out + r * d;
    for (int j = lane; j < d; j += 32) {
      float v = load_f(xr[j]);
      if (kRes) v += load_f(rr[j]);
      orow[j] = store_as<T>(v * inv * w[j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, const float* w, void* out,
           int64_t rows, int d, float eps, cudaStream_t stream) {
  // one warp per row, capped at 16 resident blocks on each of the 132 SMs;
  // the grid-stride loop covers the rest
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  const int64_t cap = 132 * 16;
  const int grid = (int)(blocks < cap ? blocks : cap);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (res == nullptr)
    rms_norm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, nullptr, w, ot, rows, d, eps);
  else
    rms_norm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, static_cast<const T*>(res), w, ot, rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

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
