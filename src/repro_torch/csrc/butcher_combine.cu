// butcher_combine: out[j] = x[j] + sum_{i<s} hc[b][i] * ks[i][j], lane b of
// element j (hc is (B, s); B = 1 for one row), for Hopper (sm_90a); it
// replaces repro/kernels/butcher_combine.py::butcher_combine_pallas (Pallas
// body _kernel).  The design and its bound are in butcher_combine.cuh.
#include "butcher_combine.cuh"

namespace {

template <typename T, int V, int S>
__global__ void __launch_bounds__(kThreads)
butcher_combine_kernel(const T* __restrict__ x, const T* __restrict__ ks,
                       const typename Acc<T>::type* __restrict__ hc,
                       T* __restrict__ out, int64_t n, int64_t n_lane,
                       bool narrow) {
  using A = typename Acc<T>::type;
  using P = Pack<T, V>;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n / V) return;
  const int64_t j = q * V;
  P k[S];
#pragma unroll
  for (int i = 0; i < S; ++i) k[i] = *reinterpret_cast<const P*>(ks + i * n + j);
  const P xv = *reinterpret_cast<const P*>(x + j);
  const Lanes l = lanes_of<V>(j, n_lane, narrow);
  A c0[S], c1[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    c0[i] = __ldg(hc + l.b0 * S + i);
    c1[i] = V > 1 ? __ldg(hc + l.b1 * S + i) : c0[i];
  }
  A acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = load_acc(xv.v[e]);
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc[e] = acc[e] + (e >= l.split ? c1[i] : c0[i]) * load_acc(k[i].v[e]);
  P o;
#pragma unroll
  for (int e = 0; e < V; ++e) o.v[e] = store_as<T>(acc[e]);
  *reinterpret_cast<P*>(out + j) = o;
}

struct OneRow {
  template <typename T, int V, int S>
  static void run(const Args& a, int blocks, int threads, bool narrow,
                  cudaStream_t stream) {
    using A = typename Acc<T>::type;
    butcher_combine_kernel<T, V, S><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.ks),
        static_cast<const A*>(a.hc), static_cast<T*>(a.out), a.n, a.n_lane,
        narrow);
  }
};

}  // namespace

// Returns the cudaError_t of the launch (launch() in butcher_combine.cuh).
extern "C" int butcher_combine_launch(int dtype, const void* x, const void* ks,
                                      const void* hc, void* out, long long n,
                                      long long n_lane, int s, void* stream) {
  const Args a{x, ks, hc, nullptr, out, (int64_t)n, (int64_t)n_lane, s, 1};
  return launch<OneRow>(dtype, a, stream);
}
