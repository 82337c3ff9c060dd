// butcher_combine_rows: out[r][j] = sc[r] * x[j] + sum_{i<s} hc[b][r][i] *
// ks[i][j] for r < m <= 13, lane b of element j (hc is (B, m, s); B = 1 for
// one block of rows; sc is (m,) for every lane), all m rows from ONE read
// of (x, ks), for Hopper (sm_90a); it replaces repro/kernels/
// butcher_combine.py::butcher_combine_rows_pallas (Pallas body
// _rows_kernel).  The solver uses it for the fused step update + embedded
// error, rows [b; b_err], sc [1; 0].  The design and its bound are in
// butcher_combine.cuh.  The kernel keeps the s stage vectors in registers
// for all m rows; for m = 2 it loads both rows' coefficients before the
// first FMA, other m take the rows one at a time.
#include "butcher_combine.cuh"

namespace {

// MR rows r0 .. r0+MR-1 of the rows kernel for one vector: all their
// coefficients (both lanes' rows) are loaded before the first FMA, then
// each row is summed in stage order and stored.
template <typename T, int V, int S, int MR>
__device__ __forceinline__ void rows_of(
    const Pack<T, V> (&k)[S], const typename Acc<T>::type (&xa)[V],
    const typename Acc<T>::type (&s_r)[MR],
    const typename Acc<T>::type* __restrict__ h0,
    const typename Acc<T>::type* __restrict__ h1, int r0, int64_t split,
    T* __restrict__ out, int64_t n, int64_t j) {
  using A = typename Acc<T>::type;
  A c0[MR][S], c1[MR][S];
#pragma unroll
  for (int rr = 0; rr < MR; ++rr)
#pragma unroll
    for (int i = 0; i < S; ++i) {
      c0[rr][i] = __ldg(h0 + (r0 + rr) * S + i);
      c1[rr][i] = V > 1 ? __ldg(h1 + (r0 + rr) * S + i) : c0[rr][i];
    }
#pragma unroll
  for (int rr = 0; rr < MR; ++rr) {
    A acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = s_r[rr] * xa[e];
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] = acc[e] + (e >= split ? c1[rr][i] : c0[rr][i]) * load_acc(k[i].v[e]);
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = store_as<T>(acc[e]);
    *reinterpret_cast<Pack<T, V>*>(out + (r0 + rr) * n + j) = o;
  }
}

template <typename T, int V, int S>
__global__ void __launch_bounds__(kThreads)
butcher_combine_rows_kernel(const T* __restrict__ x, const T* __restrict__ ks,
                            const typename Acc<T>::type* __restrict__ hc,
                            const typename Acc<T>::type* __restrict__ sc,
                            T* __restrict__ out, int64_t n, int64_t n_lane,
                            bool narrow, int m) {
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
  // each lane's (m, s) block of rows; the stage vectors stay in registers
  // for all m rows
  const A* h0 = hc + l.b0 * m * S;
  const A* h1 = hc + l.b1 * m * S;
  A xa[V];
#pragma unroll
  for (int e = 0; e < V; ++e) xa[e] = load_acc(xv.v[e]);
  if (m == 2) {   // the solver's rows (b, b_err): every load up front
    const A s2[2] = {__ldg(sc), __ldg(sc + 1)};
    rows_of<T, V, S, 2>(k, xa, s2, h0, h1, 0, l.split, out, n, j);
  } else {
    for (int r = 0; r < m; ++r) {
      const A s1[1] = {__ldg(sc + r)};
      rows_of<T, V, S, 1>(k, xa, s1, h0, h1, r, l.split, out, n, j);
    }
  }
}

struct Rows {
  template <typename T, int V, int S>
  static void run(const Args& a, int blocks, int threads, bool narrow,
                  cudaStream_t stream) {
    using A = typename Acc<T>::type;
    butcher_combine_rows_kernel<T, V, S><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.ks),
        static_cast<const A*>(a.hc), static_cast<const A*>(a.sc),
        static_cast<T*>(a.out), a.n, a.n_lane, narrow, a.m);
  }
};

}  // namespace

// Returns the cudaError_t of the launch (launch() in butcher_combine.cuh).
extern "C" int butcher_combine_rows_launch(int dtype, const void* x,
                                           const void* ks, const void* hc,
                                           const void* sc, void* out,
                                           long long n, long long n_lane,
                                           int s, int m, void* stream) {
  const Args a{x, ks, hc, sc, out, (int64_t)n, (int64_t)n_lane, s, m};
  return launch<Rows>(dtype, a, stream);
}
