// Flash attention (online softmax) for Hopper (sm_90a): causal, GQA,
// sliding window, query offset, padded-kv mask.
//
//   out[b,h,i,:] = sum_j p[i,j] v[b,h/group,j,:],
//   p[i,:] = softmax_j(scale * q[b,h,i,:] . k[b,h/group,j,:]) over the keys j
//   that are allowed: j < Sk, and (causal) j <= i + q_offset, and (window w)
//   j > i + q_offset - w.  A row with no allowed key gives zeros, not NaN.
//   replaces repro/kernels/flash_attention.py::flash_attention_pallas
//   (Pallas body _flash_kernel).
//
// q (B,H,Sq,D), k and v (B,Hkv,Sk,D) and out (B,H,Sq,D) are addressed by
// their strides (in elements) along b, h and s; the last dim must be
// contiguous.  So the (B,S,H,D) projections can be read through their
// transposed (B,H,S,D) views without a copy.  T is float, double, half or
// bfloat16; all arithmetic is float (a double input is computed in float,
// as the JAX reference does), the output is stored as T.  D is a template
// parameter: 16, 32, 64 or 128.  The plain PyTorch version is
// repro_torch/kernels/ref.py::attention_ref.
//
// Numerics follow _flash_kernel: per query row a running maximum m, sum l
// and accumulator acc in float; a kv tile that no row of the query tile may
// see is skipped by the same test (k_lo < Sk, causal k_lo <= q_hi, window
// k_hi > q_lo - w); -inf maxima are clamped to 0 before exponentiating, and
// l is floored at 1e-30.  Dot products and sums run in another order than
// the plain version's (which materialises the whole score matrix), with
// fused multiply-adds, so results differ from it at float rounding scale.
//
// Bound on the H100: operations.  Causal prefill at the LM's shape (B 8,
// H 16, S 1024, D 128) does 4*B*H*D*(S*(S+1)/2) ~ 34 GFLOP against ~100 MB
// moved: ~340 flop/byte, so the least time is flops over the 67 TFLOP/s of
// float32 FMA outside the tensor cores (tensor cores in TF32/bf16 are later
// work).  The design is the simple one: one CTA of 256 threads per (query
// tile of 64 rows, head, batch); a loop over kv tiles of 32 keys staged in
// shared memory (q, k and the probability tile padded by one float per row
// so the column reads hit distinct banks); each thread owns 4 query rows x
// 2 keys of the score tile and 4 rows x D/16 columns of the accumulator,
// and the row reductions run over 16 lanes with warp shuffles.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 32;              // keys per kv tile
constexpr int kTX = 16;              // threads along keys / head dim
constexpr int kTY = 16;              // threads along query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRQ = kBQ / kTY;       // query rows per thread
constexpr int kRK = kBK / kTX;       // keys per thread in the score tile

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

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

// max / sum over the 16 lanes that share a query row (lane groups 0-15 and
// 16-31 of a warp hold two different rows)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int group, int Sq, int Sk, float scale, int causal,
                       int has_window, int window, int q_offset) {
  constexpr int kDC = D / kTX;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                          // kBQ x (D+1)
  float* sK = sQ + kBQ * (D + 1);            // kBK x (D+1)
  float* sV = sK + kBK * (D + 1);            // kBK x D
  float* sP = sV + kBK * D;                  // kBQ x (kBK+1)

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int q0 = iq * kBQ;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    sQ[r * (D + 1) + c] = q0 + r < Sq ? load_f(qb[(q0 + r) * qs.s + c]) : 0.f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][kDC];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // absolute positions, as in _flash_kernel
  const int q_lo = q0 + q_offset;
  const int q_hi = q_lo + kBQ - 1;
  const int nk = (Sk + kBK - 1) / kBK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_lo = ik * kBK;
    const int k_hi = k_lo + kBK - 1;
    bool live = k_lo < Sk;
    if (causal) live = live && k_lo <= q_hi;
    if (has_window) live = live && k_hi > q_lo - window;
    if (!live) continue;             // the same for every thread of the CTA

    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k_lo + r < Sk;
      sK[r * (D + 1) + c] = in ? load_f(kb[(k_lo + r) * ks.s + c]) : 0.f;
      sV[r * D + c] = in ? load_f(vb[(k_lo + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRQ][kRK];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kRK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[kRQ], kv[kRK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qv[i] = sQ[(ty + kTY * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kRK; ++j) kv[j] = sK[(tx + kTX * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kRK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int qpos = q_lo + ty + kTY * i;
      bool mask[kRK];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRK; ++j) {
        const int kpos = k_lo + tx + kTX * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        mask[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRK; ++j) {
        const float p = mask[j] ? expf(s[i][j] - m_safe) : 0.f;
        psum += p;
        sP[(ty + kTY * i) * (kBK + 1) + tx + kTX * j] = p;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRQ], vv[kDC];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) pv[i] = sP[(ty + kTY * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vv[c] = sV[j * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();                 // before the next tile overwrites sK/sV/sP
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      ob[row * os.s + tx + kTX * c] = store_as<T>(acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int H, int group, int Sq, int Sk,
           float scale, int causal, int has_window, int window, int q_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  // above 48 KB a kernel must opt in to dynamic shared memory (once each)
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, group,
      Sq, Sk, scale, causal, has_window, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             const long long* st, int B, int H, int group, int Sq, int Sk,
             float scale, int causal, int has_window, int window, int q_offset,
             cudaStream_t stream) {
  switch (D) {
#define FA_CASE(DD)                                                         \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, out, st, B, H, group, Sq, Sk, scale,      \
                         causal, has_window, window, q_offset, stream);
    FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(128)
#undef FA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with repro_torch/kernels/flash_attention.py:
//   0 float32, 1 float64, 2 float16, 3 bfloat16.
// strides: 12 element strides, (b, h, s) for q, k, v and out in that order;
// the last dim of each is contiguous.  Returns the cudaError_t of the launch
// (0 = success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int has_window,
                                      int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int group = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, out, strides, B, H, group, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 1: return launch_d<double>(D, q, k, v, out, strides, B, H, group, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 2: return launch_d<__half>(D, q, k, v, out, strides, B, H, group, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 3: return launch_d<__nv_bfloat16>(D, q, k, v, out, strides, B, H, group, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
