// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of
//
//   out[b,h,i,:] = sum_j p[i,j] v[b,h/group,j,:],
//   p[i,j] = exp(scale q_i.k_j - lse[b,h,i]) on the allowed pairs, else 0,
//
// with the masks of the forward (attention_mask.cuh: causal, sliding window,
// query offset, padded kv), from the forward's row log-sum-exp ``lse`` (so
// the probabilities are recomputed, never stored).  The JAX package has no
// backward kernel (repro/kernels/flash_attention.py::flash_attention_pallas
// is differentiated by XLA through its plain reference); this is the
// backward of the port's forward, csrc/flash_attention.cu.  The plain
// PyTorch version is repro_torch/kernels/ref.py::attention_bwd_ref.
//
// The flash recurrence, per (batch, query head) row i:
//   D_i  = sum_d dout[i,d] out[i,d]                       (dot kernel)
//   dv_j = sum_i p[i,j] dout_i                            (dkdv kernel)
//   ds   = p[i,j] (dout_i.v_j - D_i)
//   dk_j = scale sum_i ds[i,j] q_i                        (dkdv kernel)
//   dq_i = scale sum_j ds[i,j] k_j                        (dq kernel)
// GQA: dk and dv of a kv head sum over its `group` query heads, inside one
// CTA, in a fixed order.  No atomics anywhere: every output element is
// written once by one thread, so two calls give the same bits.
//
// T is float or double, and all arithmetic is T (a double input is
// computed in double; lse arrives as float, the forward's output).  D is a
// template parameter: 16, 32, 64 or 128.
//
// Bound on the H100: operations.  The backward does 2.5x the forward's
// products (S and dP = dout.V^T again in the dq kernel, dS.K, dS^T.Q and
// P^T.dout), 85.9 GFLOP at the LM's shape (B 8, H 16/8, S 1024, D 128,
// causal): 1.28 ms at 67 TFLOP/s of float32 FMA.  This first kernel is
// simple on purpose: FMA on the CUDA cores from shared-memory tiles, each of
// 256 threads (a 16 x 16 grid) holding a register micro-tile (rows ty +
// 16a, columns tx + 16c: strided, so that a warp's shared reads fall in
// distinct banks or broadcast).  Tiles: 64 queries x 64 keys for float, 32
// x 32 for double; rows padded by one element.
//
//   dot kernel   one warp per (b, h, i) row.
//   dkdv kernel  one CTA per (kv tile, kv head, batch): K and V tiles stay
//                in shared memory; the CTA walks the query tiles of each of
//                its group's heads that the tile test keeps, and per pair
//                computes S and dP (one micro-tile of both per thread), then
//                P and dS into shared memory, then dV += P^T dout and dK +=
//                dS^T Q into registers.
//   dq kernel    one CTA per (query tile, head, batch): Q and dout stay in
//                shared memory; the CTA walks its live kv tiles (the
//                forward's contiguous range) and accumulates dQ += dS K.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mask.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads

template <typename T> struct Tiles;
template <> struct Tiles<float> { static constexpr int kBQ = 64, kBK = 64; };
template <> struct Tiles<double> { static constexpr int kBQ = 32, kBK = 32; };

struct Strides3 {
  long long b, h, s;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + R) of one head (row stride s_stride, D contiguous) into a
// shared tile of R rows of D + 1; rows past S are zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long s_stride, int r0, int S) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < S ? src[(long long)row * s_stride + c] : T(0);
  }
}

template <typename T, int D>
struct Smem {
  static constexpr int kBQ = Tiles<T>::kBQ, kBK = Tiles<T>::kBK;
  static constexpr int kLD = D + 1, kLP = kBK + 1;
  // dkdv: Q, dout, K, V, P, dS, lse, D
  static constexpr int kDkdv =
      (2 * kBQ * kLD + 2 * kBK * kLD + 2 * kBQ * kLP + 2 * kBQ) * (int)sizeof(T);
  // dq: Q, dout, K, V, dS, lse, D
  static constexpr int kDq =
      (2 * kBQ * kLD + 2 * kBK * kLD + kBQ * kLP + 2 * kBQ) * (int)sizeof(T);
};

// dvec[b,h,i] = sum_d dout[b,h,i,d] out[b,h,i,d]; one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ out, Strides3 os,
                    const T* __restrict__ dout, Strides3 ds,
                    T* __restrict__ dvec, int H, int Sq, int D,
                    long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = (int)(r % Sq);
  const long long bh = r / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = out + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + i * ds.s;
  T acc = T(0);
  for (int c = lane; c < D; c += 32) acc += drow[c] * orow[c];
  acc = warp_sum(acc);
  if (lane == 0) dvec[r] = acc;
}

// S = Q K^T and dP = dout V^T on this thread's micro-tile (rows ty + 16a,
// keys tx + 16c), then P and dS of the tile's allowed pairs
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    const T* sQ, const T* sdO, const T* sK, const T* sV, const T* sL,
    const T* sDv, T* sP, T* sdS, int q0, int k0, int Sq, T scale,
    const AttnMask& mask) {
  using S = Smem<T, D>;
  constexpr int TM = S::kBQ / 16, TN = S::kBK / 16, LD = S::kLD, LP = S::kLP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      s[a][c] = T(0);
      dp[a][c] = T(0);
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    T qa[TM], oa[TM], kb[TN], vb[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      qa[a] = sQ[(ty + 16 * a) * LD + d];
      oa[a] = sdO[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      kb[c] = sK[(tx + 16 * c) * LD + d];
      vb[c] = sV[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        s[a][c] += qa[a] * kb[c];
        dp[a][c] += oa[a] * vb[c];
      }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = k0 + tx + 16 * c;
      T p = T(0);
      if (i < Sq && mask.allowed(i + mask.q_offset, j))
        p = exp_t(s[a][c] * scale - sL[r]);
      sP[r * LP + tx + 16 * c] = p;
      sdS[r * LP + tx + 16 * c] = p * (dp[a][c] - sDv[r]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(T* sL, T* sDv,
                                          const float* __restrict__ lse,
                                          const T* __restrict__ dvec,
                                          long long bh, int q0, int Sq) {
  constexpr int BQ = Smem<T, D>::kBQ;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int i = q0 + r;
    sL[r] = i < Sq ? (T)lse[bh * Sq + i] : T(0);
    sDv[r] = i < Sq ? dvec[bh * Sq + i] : T(0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, Strides3 qs,
                     const T* __restrict__ k, Strides3 ks,
                     const T* __restrict__ v, Strides3 vs,
                     const T* __restrict__ dout, Strides3 dos,
                     const float* __restrict__ lse, const T* __restrict__ dvec,
                     T* __restrict__ dk, Strides3 dks, T* __restrict__ dv,
                     Strides3 dvs, int H, int group, int Sq, T scale,
                     AttnMask mask) {
  using S = Smem<T, D>;
  constexpr int BQ = S::kBQ, BK = S::kBK, LD = S::kLD, LP = S::kLP;
  constexpr int TK = BK / 16, TD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BQ * LD;
  T* sK = sdO + BQ * LD;
  T* sV = sK + BK * LD;
  T* sP = sV + BK * LD;
  T* sdS = sP + BQ * LP;
  T* sL = sdS + BQ * LP;
  T* sDv = sL + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK, k_hi = k0 + BK - 1;
  load_tile<T, D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, mask.Sk);
  load_tile<T, D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, mask.Sk);

  T acc_k[TK][TD], acc_v[TK][TD];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      acc_k[a][c] = T(0);
      acc_v[a][c] = T(0);
    }
  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = (long long)b * H + h;
    for (int it = 0; it < nq; ++it) {
      const int q0 = it * BQ;
      const int q_lo = q0 + mask.q_offset;
      const int q_hi = min(q0 + BQ, Sq) - 1 + mask.q_offset;
      if (!mask.tile_live(q_lo, q_hi, k0, k_hi)) continue;  // uniform
      __syncthreads();   // the previous pair's readers are done
      load_tile<T, D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<T, D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
      load_rows<T, D>(sL, sDv, lse, dvec, bh, q0, Sq);
      __syncthreads();
      probs_and_ds<T, D>(sQ, sdO, sK, sV, sL, sDv, sP, sdS, q0, k0, Sq, scale,
                         mask);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dout[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        T pa[TK], sa[TK], ob[TD], qb[TD];
#pragma unroll
        for (int a = 0; a < TK; ++a) {
          pa[a] = sP[r * LP + ty + 16 * a];
          sa[a] = sdS[r * LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          ob[c] = sdO[r * LD + tx + 16 * c];
          qb[c] = sQ[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TK; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            acc_v[a][c] += pa[a] * ob[c];
            acc_k[a][c] += sa[a] * qb[c];
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TK; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= mask.Sk) continue;
    T* dkr = dk + b * dks.b + hk * dks.h + j * dks.s;
    T* dvr = dv + b * dvs.b + hk * dvs.h + j * dvs.s;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      dkr[tx + 16 * c] = acc_k[a][c] * scale;
      dvr[tx + 16 * c] = acc_v[a][c];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, Strides3 qs,
                   const T* __restrict__ k, Strides3 ks,
                   const T* __restrict__ v, Strides3 vs,
                   const T* __restrict__ dout, Strides3 dos,
                   const float* __restrict__ lse, const T* __restrict__ dvec,
                   T* __restrict__ dq, Strides3 dqs, int H, int group, int Sq,
                   T scale, AttnMask mask) {
  using S = Smem<T, D>;
  constexpr int BQ = S::kBQ, BK = S::kBK, LD = S::kLD, LP = S::kLP;
  constexpr int TM = BQ / 16, TD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BQ * LD;
  T* sK = sdO + BQ * LD;
  T* sV = sK + BK * LD;
  T* sdS = sV + BK * LD;
  T* sL = sdS + BQ * LP;
  T* sDv = sL + BQ;
  // dS goes where dkdv keeps P; P itself is not needed here
  T* sP = sdS;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long bh = (long long)b * H + h;
  const int q0 = blockIdx.x * BQ;
  load_tile<T, D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<T, D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  load_rows<T, D>(sL, sDv, lse, dvec, bh, q0, Sq);
  int j_begin, j_end;
  mask.kv_tiles(q0 + mask.q_offset, min(q0 + BQ, Sq) - 1 + mask.q_offset, BK,
                &j_begin, &j_end);

  T acc[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[a][c] = T(0);
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, mask.Sk);
    load_tile<T, D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, mask.Sk);
    __syncthreads();
    // P is written and then overwritten by dS in the same slot: each
    // thread writes only its own entries, P first
    probs_and_ds<T, D>(sQ, sdO, sK, sV, sL, sDv, sP, sdS, q0, k0, Sq, scale,
                       mask);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      T sa[TM], kb[TD];
#pragma unroll
      for (int a = 0; a < TM; ++a) sa[a] = sdS[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) kb[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[a][c] += sa[a] * kb[c];
    }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    T* dqr = dq + b * dqs.b + h * dqs.h + i * dqs.s;
#pragma unroll
    for (int c = 0; c < TD; ++c) dqr[tx + 16 * c] = acc[a][c] * scale;
  }
}

Strides3 strides_at(const long long* st, int i) {
  return Strides3{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dvec, void* dq, void* dk,
           void* dv, const long long* st, int B, int H, int Hkv, int Sq,
           int Sk, double scale, const AttnMask& mask, cudaStream_t stream) {
  using S = Smem<T, D>;
  // above 48 KB a kernel must opt in to dynamic shared memory (once each)
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDkdv);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kDq);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* dvt = static_cast<T*>(dvec);
  const long long rows = (long long)B * H * Sq;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_bwd_dot_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), strides_at(st, 3), dot, strides_at(st, 4),
      dvt, H, Sq, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int group = H / Hkv;
  const T sc = (T)scale;
  dim3 gkv((Sk + S::kBK - 1) / S::kBK, Hkv, B);
  attn_bwd_dkdv_kernel<T, D><<<gkv, kThreads, S::kDkdv, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<T*>(dk), strides_at(st, 6),
      static_cast<T*>(dv), strides_at(st, 7), H, group, Sq, sc, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((Sq + S::kBQ - 1) / S::kBQ, H, B);
  attn_bwd_dq_kernel<T, D><<<gq, kThreads, S::kDq, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<T*>(dq), strides_at(st, 5), H,
      group, Sq, sc, mask);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* out, const void* dout, const float* lse, void* dvec,
             void* dq, void* dk, void* dv, const long long* st, int B, int H,
             int Hkv, int Sq, int Sk, double scale, const AttnMask& mask,
             cudaStream_t stream) {
  switch (D) {
#define FAB_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, out, dout, lse, dvec, dq, dk, dv, st, B,  \
                         H, Hkv, Sq, Sk, scale, mask, stream);
    FAB_CASE(16) FAB_CASE(32) FAB_CASE(64) FAB_CASE(128)
#undef FAB_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with repro_torch/kernels/flash_attention.py:
//   0 float32, 1 float64 (the backward takes no other).
// strides: 24 element strides, (b, h, s) for q, k, v, out, dout, dq, dk and
// dv in that order (the last dim of each contiguous); lse: contiguous
// (B, H, Sq) float, the forward's; dvec: a (B, H, Sq) scratch buffer of the
// dtype.  Launches three kernels (dot, dkdv, dq) on the stream.  Returns the
// cudaError_t of the launches (0 = success), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int Hkv, int Sq, int Sk,
    int D, double scale, int causal, int has_window, int window, int q_offset,
    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnMask mask{Sk, causal, has_window, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, out, dout, lf, dvec, dq, dk, dv, strides, B, H, Hkv, Sq, Sk, scale, mask, st);
    case 1: return launch_d<double>(D, q, k, v, out, dout, lf, dvec, dq, dk, dv, strides, B, H, Hkv, Sq, Sk, scale, mask, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
