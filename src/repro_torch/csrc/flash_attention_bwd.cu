// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of
//
//   out[b,h,i,:] = sum_j p[i,j] v[b,h/group,j,:],
//   p[i,j] = exp(scale q_i.k_j - lse[b,h,i]) on the allowed pairs, else 0,
//
// with the masks of the forward (attention_mask.cuh: causal, sliding window,
// query offset, padded kv), from the forward's row log-sum-exp ``lse`` (so
// the probabilities are recomputed, never stored).  It replaces no TPU
// kernel: the JAX package has no backward kernel
// (repro/kernels/flash_attention.py::flash_attention_pallas is
// differentiated by XLA through its plain reference); this is the backward
// of the port's forward, csrc/flash_attention.cu.  The plain PyTorch version
// is repro_torch/kernels/ref.py::attention_bwd_ref.
//
// The flash recurrence, per (batch, query head) row i:
//   D_i  = sum_d dout[i,d] out[i,d]                       (dot kernel)
//   dv_j = sum_i p[i,j] dout_i                            (dkdv kernel)
//   ds   = p[i,j] (dout_i.v_j - D_i)
//   dk_j = scale sum_i ds[i,j] q_i                        (dkdv kernel)
//   dq_i = scale sum_j ds[i,j] k_j                        (dq kernel)
// GQA: dk and dv of a kv head sum over its `group` query heads, inside one
// CTA, in a fixed order.  No atomics anywhere: every output element is
// written once by one thread, so two calls give the same bits.  Three
// launches: the row-dot pass, dK/dV, dQ.
//
// float32 at D 16, 32, 64, 128: wgmma in 3xTF32 on the tensor cores.
// bfloat16 at D 16 to 160: wgmma in bfloat16 on the tensor cores, from
// TMA-fed tiles, the bfloat16 kernels near the end of this file (P and dS
// rounded to bfloat16 as operands, every sum in float32; dQ recomputes S and
// dP instead of reading a dS scratch).  The simple FMA kernels take the rest
// on the CUDA cores: double in double (wgmma has no float64, and double is
// the exactness path), and float32 at D 160 (the wgmma layout does not fit
// a CTA there: dK/dV would need 249,856 bytes of shared memory, dQ 233,472;
// their bound is operations over the 67 TFLOP/s of float32 FMA, 3.21 ms at
// stablelm-12b's B 8, H 32/8, S 1024, D 160, causal).
//
// Bound on the H100: operations.  Five products per allowed (query, key)
// pair and head dim: S = Q.K^T, dP = dO.V^T, dV += P^T.dO, dK += dS^T.Q, dQ
// += dS.K; 85.9 GFLOP at the LM's training shape (B 8, H 16/8, S 1024, D
// 128, causal).  3xTF32 (each float split into hi, its TF32 part, and lo =
// x - hi; hi.hi plus hi.lo + lo.hi, the small terms first, as the forward)
// makes that 3 x flops over the 495 TFLOP/s of TF32: 0.521 ms.  S and dP
// keep hi.hi apart from the small terms and add the two at the end (the
// forward's rule: S feeds an exponential); the three accumulating products
// take all three terms into one accumulator, small first, as the forward's
// P.V does.
//
// Design, float32.  dQ comes from a dS scratch (five products, not seven):
// the dK/dV kernel writes each dS tile once to a scratch tensor in global
// memory, and a third kernel forms dQ = scale dS.K from it, so S and dP are
// never computed twice.  The scratch holds only the tiles the masks keep
// (0.285 GB at the training shape: ~0.17 ms of HBM traffic written and read
// once, against the ~0.2 ms of products the recompute would add).  Its
// layout: per (b, h), per 16-query block in order, its live 64-key tiles in
// order, each a 4096-byte block of two 32-key halves, each half 16 rows x 128
// bytes in TMA's 128-byte swizzle (what the dQ kernel reads it as); the
// wrapper asks flash_attention_bwd_scratch_bytes for its size.
//
//   dkdv kernel  one CTA of 384 threads per (64 keys, kv head, batch), heavy
//                causal tiles first; it walks the 16-query blocks of each of
//                its group's heads that its keys meet, in a fixed order.  One
//                producer lane (setmaxnreg 40) brings K and V once and each
//                block's Q and dO by TMA into a ring of two slots.  Two
//                consumer warpgroups (setmaxnreg 232) on the same 64 keys, M =
//                64: warpgroup 0 computes S^T = K.Q^T (A = K_hi from shared
//                memory, K_lo in its registers), P^T = exp2(S^T scale log2e -
//                lse log2e) on the allowed pairs, hands P^T to warpgroup 1
//                through shared memory (named barriers) and owns dV += P^T.dO;
//                warpgroup 1 computes dP^T = V.dO^T the same way, dS^T = P^T
//                (dP^T - D), writes dS to the scratch and owns dK += dS^T.Q.
//                Each warpgroup writes the operands it needs that TMA cannot
//                give, for the next block while this block's dV (dK) product
//                runs: the lo part beside its B tile (Q_lo beside Q, so one
//                wgmma of [Q_hi; Q_lo] gives hi.hi and hi.lo) and the other
//                tile transposed, hi and lo (dO^T, or Q^T: D rows x 16
//                queries), since TF32 wgmma takes both operands K-major only.
//                (Three converter warps of the producer warpgroup did this
//                at first, and could not keep up with the consumers.)  S^T's
//                lo.hi term has an accumulator of its own, so that each chain
//                of wgmma keeps one shape (alternating shapes on shared
//                registers serialize).  P^T and dS^T are A operands straight
//                from the accumulator registers: the accumulator holds
//                columns 2t and 2t+1 of each 8-query block, which is the TF32
//                A fragment once the queries of the block are taken in the
//                order 0,2,4,6,1,3,5,7 (the forward's key-order trick), so
//                the transposed copies are written in that order.
//                Registers: dK and dV take D/2 floats a thread each, S^T or
//                dP^T of 16 queries with its split 24, K_lo or V_lo D/2: one
//                warpgroup cannot hold both products' state at D 128, which
//                is why the two products are split between two warpgroups.
//                The producer warpgroup is whole (its other three warps exit
//                at once) so that its setmaxnreg.dec frees what the consumers
//                take.
//   dq kernel    one CTA of 384 threads per (128 queries, head, batch), heavy
//                causal tiles first, over its live kv tiles in steps of 32
//                keys, through a ring of three slots: the producer lane
//                brings the K tile by TMA and each live 16-row dS half-block
//                by a bulk copy; two consumer warpgroups of 64 rows write K
//                transposed, hi and lo (D rows x 32 keys), for the next step
//                while this step's products run, read their dS A fragments
//                from shared memory (hi and lo in registers; a 16-row block
//                the masks drop is zeros, one warp's rows) and accumulate dQ
//                += dS.K with three wgmma m64nDk8 per step of 8 keys.
//
// Shared memory (bytes, D 128): dkdv: K 32768 + V 32768 + 2 slots x (Q
// hi/lo 16384 + dO hi/lo 16384 + Q^T hi/lo 16384 + dO^T hi/lo 16384) + P^T
// exchange 4096 = 200704; dq: 3 slots x (raw K 16384 + K^T hi/lo 32768 + dS
// 16384) = 196608; each plus 1 KB of alignment slack and the barriers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_mask.cuh"
#include "wgmma_tf32.cuh"

namespace {

struct Strides3 {
  long long b, h, s;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The storage types and what the kernels compute in: float64 in double,
// float32 and bfloat16 in float (the row dots' type); the FMA kernels' tile
// edge (keys and queries) that fits a CTA's shared memory at D 160 (double
// only to D 128)
template <typename T>
struct Fma {
  using A = float;
  static constexpr int kTile = 64;
};
template <>
struct Fma<double> {
  using A = double;
  static constexpr int kTile = 32;
};

__device__ __forceinline__ float acc_of(float v) { return v; }
__device__ __forceinline__ double acc_of(double v) { return v; }
__device__ __forceinline__ float acc_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float exp_acc(float v) { return expf(v); }
__device__ __forceinline__ double exp_acc(double v) { return exp(v); }

// dvec[b,h,i] = sum_d dout[b,h,i,d] out[b,h,i,d] in the compute type (float
// for bfloat16); one warp a row
template <typename T, typename A = typename Fma<T>::A>
__global__ void __launch_bounds__(256)
attn_bwd_dot_kernel(const T* __restrict__ out, Strides3 os,
                    const T* __restrict__ dout, Strides3 ds,
                    A* __restrict__ dvec, int H, int Sq, int D,
                    long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = (int)(r % Sq);
  const long long bh = r / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = out + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + i * ds.s;
  A acc = A(0);
  for (int c = lane; c < D; c += 32) acc += acc_of(drow[c]) * acc_of(orow[c]);
  acc = warp_sum(acc);
  if (lane == 0) dvec[r] = acc;
}

Strides3 strides_at(const long long* st, int i) {
  return Strides3{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T>
int launch_dot(const void* out, const void* dout, void* dvec,
               const long long* st, int B, int H, int Sq, int D,
               cudaStream_t stream) {
  using A = typename Fma<T>::A;
  const long long rows = (long long)B * H * Sq;
  const long long blocks = (rows * 32 + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_bwd_dot_kernel<T><<<(int)blocks, 256, 0, stream>>>(
      static_cast<const T*>(out), strides_at(st, 3),
      static_cast<const T*>(dout), strides_at(st, 4), static_cast<A*>(dvec),
      H, Sq, D, rows);
  return (int)cudaGetLastError();
}

// ===========================================================================
// float32: wgmma 3xTF32
// ===========================================================================

constexpr int kBK = 64;          // keys per dK/dV CTA (M of both warpgroups)
constexpr int kBQ = 16;          // queries per dK/dV tile (a dS block's rows)
constexpr int kQRows = 128;      // query rows per dQ CTA
constexpr int kStep = 32;        // keys per dQ tile
constexpr int kQSlots = 3;       // the dQ kernel's ring
constexpr int kBlock = 4096;     // bytes of one dS block: kBQ x kBK floats
constexpr int kHalf = 2048;      // one 32-key half of it
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;

// A float tile with D along its rows, as TMA lands it: chunks of kPer
// elements, rows of kOp bytes (TMA's and wgmma's swizzle of that width)
template <int D>
struct Rows {
  static constexpr int kOp = D * 4 < 128 ? D * 4 : 128;
  static constexpr int kPer = kOp / 4;
  static constexpr int kChunks = D / kPer;
};

template <int D>
struct KvPlan {
  using R = Rows<D>;
  static constexpr int kKV = kBK * D * 4;     // K or V: chunk c at c kBK kOp
  // Q (dO) with its lo part: per chunk kBQ rows of hi, then kBQ rows of lo
  static constexpr int kQlo = kBQ * R::kOp;
  static constexpr int kQpitch = 2 * kQlo;
  static constexpr int kQ = R::kChunks * kQpitch;
  // transposed: D rows of kBQ queries (64 bytes), hi then lo
  static constexpr int kTRow = kBQ * 4;
  static constexpr int kT = D * kTRow;
  // a ring slot: [Q hi; lo], [dO hi; lo], Q^T hi, lo, dO^T hi, lo
  static constexpr int oSdO = kQ;
  static constexpr int oSQt = 2 * kQ;
  static constexpr int oSdOt = oSQt + 2 * kT;
  static constexpr int kStage = oSdOt + 2 * kT;
  static constexpr int oK = 0;
  static constexpr int oV = kKV;
  static constexpr int oRing = 2 * kKV;
  static constexpr int oX = oRing + 2 * kStage;   // the P^T hand-over
  static constexpr int kX = kBK * kBQ * 4;
  static constexpr int oBar = oX + kX;
  static constexpr int kBytes = oBar + 8 * 8 + 1024;   // + align slack
};
// dK/dV barriers: K and V landed; per slot: full (TMA), free (every
// consumer warp done with the slot)
constexpr int kBarKV = 0, kBarFull = 1, kBarFree = 3;
// named barriers of the dK/dV kernel (0 is __syncthreads): the P^T
// hand-over, and each consumer warpgroup's own (3 + warpgroup)
constexpr int kNbPFull = 1, kNbPEmpty = 2, kNbWg = 3;

template <int D>
struct QPlan {
  using R = Rows<D>;
  static constexpr int kK = kStep * D * 4;    // raw K: chunk c at c kStep kOp
  static constexpr int kKtRow = kStep * 4;    // K^T: D rows of 32 keys
  static constexpr int kKt = D * kKtRow;      // hi, then lo
  static constexpr int oSKt = kK;
  static constexpr int oSdS = kK + 2 * kKt;   // 8 half-blocks (16 rows each)
  static constexpr int kStage = oSdS + (kQRows / kBQ) * kHalf;
  static constexpr int oBar = kQSlots * kStage;
  static constexpr int kBytes = oBar + 2 * kQSlots * 8 + 1024;
};
// dQ barriers, per slot: full (TMA and bulk copies), free
constexpr int kQBarFull = 0, kQBarFree = kQSlots;
// the dQ kernel's named barrier of both consumer warpgroups
constexpr int kNbKt = 1;

// The live 64-key tiles of 16-query block iq, [*jb, *jb + n); returns n
__host__ __device__ inline int block_tiles(const AttnMask& m, int Sq, int iq,
                                           int* jb) {
  const int last = iq * kBQ + kBQ < Sq ? iq * kBQ + kBQ : Sq;
  int je;
  m.kv_tiles(iq * kBQ + m.q_offset, last - 1 + m.q_offset, kBK, jb, &je);
  return je > *jb ? je - *jb : 0;
}

// dS blocks of one (b, h): every 16-query block's live 64-key tiles
inline long long scratch_blocks(const AttnMask& m, int Sq) {
  long long n = 0;
  int jb;
  for (int iq = 0; iq < (Sq + kBQ - 1) / kBQ; ++iq)
    n += block_tiles(m, Sq, iq, &jb);
  return n;
}

// The (query head, 16-query block) pairs that kv tile j meets, in the fixed
// order every role of a dK/dV CTA walks: the group's heads, then the query
// blocks.  After next() returns true, g and iq name the pair and slot its dS
// block among its head's blocks.
struct TileWalk {
  AttnMask m;
  int Sq, j, group, nq;
  int g = 0, iq = -1, pre = 0, n = 0, jb = 0, slot = 0;

  __device__ TileWalk(const AttnMask& m_, int Sq_, int j_, int group_)
      : m(m_), Sq(Sq_), j(j_), group(group_), nq((Sq_ + kBQ - 1) / kBQ) {}

  __device__ bool next() {
    while (true) {
      pre += n;
      n = 0;
      if (++iq == nq) {
        if (++g == group) return false;
        iq = 0;
        pre = 0;
      }
      n = block_tiles(m, Sq, iq, &jb);
      if (j >= jb && j < jb + n) {
        slot = pre + j - jb;
        return true;
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(__grid_constant__ const CUtensorMap qmap,
                     __grid_constant__ const CUtensorMap kmap,
                     __grid_constant__ const CUtensorMap vmap,
                     __grid_constant__ const CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dsbuf,
                     long long nblk, float* __restrict__ dk, Strides3 dks,
                     float* __restrict__ dv, Strides3 dvs, int B, int H,
                     int Hkv, int group, int Sq, float scale, AttnMask mask) {
  using R = Rows<D>;
  using P = KvPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + P::oBar;
  auto bar = [&](int i) { return bars + 8 * i; };

  // kv tiles outermost in the grid: with a causal mask the first ones meet
  // the most query blocks, so the grid's tail is the light CTAs
  const int j = blockIdx.x / (Hkv * B);
  const int hk = blockIdx.x % Hkv, b = (blockIdx.x / Hkv) % B;
  const int k0 = j * kBK;
  int n_tiles = 0;
  for (TileWalk w(mask, Sq, j, group); w.next();) ++n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar(kBarKV), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(kBarFull + s), 1);
      mbar_init(bar(kBarFree + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index through a shuffle, so the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: its first lane issues every TMA copy; the
    // rest exits (the consumers write the operands TMA cannot give) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (n_tiles == 0 || warp != kConsumers / 32 || lane != 0) return;
    mbar_expect_tx(bar(kBarKV), 2 * P::kKV);
#pragma unroll
    for (int c = 0; c < R::kChunks; ++c) {
      tma_load(sbase + P::oK + c * kBK * R::kOp, &kmap, c * R::kPer, k0, hk,
               b, bar(kBarKV));
      tma_load(sbase + P::oV + c * kBK * R::kOp, &vmap, c * R::kPer, k0, hk,
               b, bar(kBarKV));
    }
    int i = 0;
    for (TileWalk w(mask, Sq, j, group); w.next(); ++i) {
      const int s = i & 1, n = i >> 1;
      if (n >= 1) mbar_wait_or_trap(bar(kBarFree + s), (n - 1) & 1);
      mbar_expect_tx(bar(kBarFull + s), 2 * kBQ * D * 4);
      const uint32_t st = sbase + P::oRing + s * P::kStage;
      const int h = hk * group + w.g;
#pragma unroll
      for (int c = 0; c < R::kChunks; ++c) {
        tma_load(st + c * P::kQpitch, &qmap, c * R::kPer, w.iq * kBQ, h, b,
                 bar(kBarFull + s));
        tma_load(st + P::oSdO + c * P::kQpitch, &domap, c * R::kPer,
                 w.iq * kBQ, h, b, bar(kBarFull + s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 S -> P, dV; warpgroup 1 dP -> dS, dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int tid = threadIdx.x % 128;
  const float scale_log2 = scale * kLog2e;

  constexpr int kNA = D / 2;                 // dV or dK registers a thread
  float acc[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc[i] = 0.f;

  if (n_tiles > 0) {
    // K_lo (warpgroup 0) or V_lo (1) as A fragments: rows (g, g+8) x
    // columns (t, t+4) of each step of 8 along D
    mbar_wait_or_trap(bar(kBarKV), 0);
    const uint32_t kv_s = sbase + (wg == 0 ? P::oK : P::oV);
    const uint8_t* kv = smem + (wg == 0 ? P::oK : P::oV);
    uint32_t alo[D / 8][4];
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        alo[ks][i] = tf32_lo(*reinterpret_cast<const float*>(
            kv + op_off(kBK, 16 * wl + g + 8 * (i & 1),
                        8 * ks + t + 4 * (i >> 1), R::kOp)));
    float* const xch = reinterpret_cast<float*>(smem + P::oX);
    const float* const rowsrc = wg == 0 ? lse : dvec;
    // the warpgroup's own operands beyond what TMA lands, in wgmma's
    // layout: the lo part beside its B tile of S^T (Q) or dP^T (dO), and the
    // other tile transposed, hi and lo, for dV (dO^T) or dK (Q^T)
    const int own = wg == 0 ? 0 : P::oSdO;
    const int other = wg == 0 ? P::oSdO : 0;
    const int tdst = wg == 0 ? P::oSdOt : P::oSQt;
    auto convert = [&](int s) {
      uint8_t* const stage = smem + P::oRing + s * P::kStage;
      constexpr int kTile4 = kBQ * D / 4;            // float4s in a tile
      constexpr int kPer4 = kBQ * R::kOp / 16;       // float4s in a chunk
#pragma unroll
      for (int it = 0; it < (kTile4 + 127) / 128; ++it) {
        const int e = tid + 128 * it;
        if (e < kTile4) {
          uint8_t* const hi = stage + own + (e / kPer4) * P::kQpitch +
                              (e % kPer4) * 16;
          const float4 x = *reinterpret_cast<const float4*>(hi);
          *reinterpret_cast<float4*>(hi + P::kQlo) =
              make_float4(x.x - tf32_hi(x.x), x.y - tf32_hi(x.y),
                          x.z - tf32_hi(x.z), x.w - tf32_hi(x.w));
        }
      }
      // transposed: a thread takes one row d and the 4 query positions
      // 4u .. 4u+3 (one 16-byte unit), which hold queries 8(u/2) + (u&1) +
      // 0, 2, 4, 6; a warp spans 32 rows d
#pragma unroll
      for (int it = 0; it < (kTile4 + 127) / 128; ++it) {
        const int e = tid + 128 * it;
        if (e < kTile4) {
          const int d = e % D, u = e / D;
          const int qa = 8 * (u >> 1) + (u & 1);
          const uint8_t* src = stage + other + (d / R::kPer) * P::kQpitch;
          float4 hv, lv;
          float* hp = &hv.x;
          float* lp = &lv.x;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float x = *reinterpret_cast<const float*>(
                src + swz(qa + 2 * c, (d % R::kPer) * 4, R::kOp));
            hp[c] = tf32_hi(x);
            lp[c] = x - hp[c];
          }
          uint8_t* const dst = stage + tdst + swz(d, 16 * u, P::kTRow);
          *reinterpret_cast<float4*>(dst) = hv;
          *reinterpret_cast<float4*>(dst + P::kT) = lv;
        }
      }
      fence_proxy_async();
    };

    // sacc: columns 0..15 hi.hi, 16..31 hi.lo; sx: lo.hi (its own
    // accumulator: one shape per chain, so neither waits for the other)
    float sacc[kBQ], sx[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) sx[i] = 0.f;
    // tile 0's operands; then each tile's conversion of the next one runs
    // while the tile's dV (dK) product is on the tensor cores
    mbar_wait_or_trap(bar(kBarFull), 0);
    convert(0);
    named_barrier(kNbWg + wg, 128);
    int i = 0;
    for (TileWalk w(mask, Sq, j, group); w.next(); ++i) {
      const int s = i & 1;
      const int q0 = w.iq * kBQ;
      const long long bh = (long long)b * H + hk * group + w.g;
      // lse (0) or D (1) of this thread's queries q0 + 8n + 2t + e
      float rowv[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * n + 2 * t + e;
          rowv[2 * n + e] = qi < Sq ? rowsrc[bh * Sq + qi] : 0.f;
        }
      const bool more = i + 1 < n_tiles;
      const uint32_t stage = sbase + P::oRing + s * P::kStage;

      // S^T = K.Q^T (or dP^T = V.dO^T), per step of 8 along D: K_hi.[Q_hi;
      // Q_lo] in one wgmma, and K_lo.Q_hi
      const uint32_t bop = stage + own;
      float (&shi)[kBQ / 2] = *reinterpret_cast<float (*)[kBQ / 2]>(&sacc[0]);
      float (&slo)[kBQ / 2] =
          *reinterpret_cast<float (*)[kBQ / 2]>(&sacc[kBQ / 2]);
      fence_regs(sacc);
      fence_regs(sx);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t c = 8 * ks / R::kPer, off = (8 * ks % R::kPer) * 4;
        const uint64_t da = gmma_desc(kv_s + c * kBK * R::kOp + off, R::kOp);
        const uint64_t db = gmma_desc(bop + c * P::kQpitch + off, R::kOp);
        wgmma_ss<2 * kBQ>(sacc, da, db, ks > 0);
        wgmma_rs<kBQ>(sx, alo[ks], db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(sx);
      // the slot's TMA tiles are read (their conversions were done during
      // the previous tile): TMA may refill them while dV (dK) runs
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kBarFree + s));
#pragma unroll
      for (int x = 0; x < kBQ / 2; ++x) slo[x] += sx[x];

      // pv[4n + 2hr + e]: key k0 + 16wl + g + 8hr, query q0 + 8n + 2t + e
      float pv[kBQ / 2];
      if (wg == 0) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * n + 2 * hr + e;
              const int qi = q0 + 8 * n + 2 * t + e;
              const int key = k0 + 16 * wl + g + 8 * hr;
              pv[x] = qi < Sq && mask.allowed(qi + mask.q_offset, key)
                          ? exp2f(fmaf(shi[x] + slo[x], scale_log2,
                                       -rowv[2 * n + e] * kLog2e))
                          : 0.f;
            }
        // hand P^T over at the same fragment positions
        if (i > 0) named_barrier(kNbPEmpty, kConsumers);
#pragma unroll
        for (int x = 0; x < kBQ / 2; ++x) xch[x * 128 + tid] = pv[x];
        __threadfence_block();
        named_arrive(kNbPFull, kConsumers);
      } else {
        named_barrier(kNbPFull, kConsumers);
#pragma unroll
        for (int x = 0; x < kBQ / 2; ++x) pv[x] = xch[x * 128 + tid];
        if (i + 1 < n_tiles) named_arrive(kNbPEmpty, kConsumers);
        // dS = P (dP - D), and the dS block to the scratch (the dQ kernel's
        // A operand layout: 32-key halves of 16 rows x 128 bytes, swizzled)
        float* const blk = dsbuf + (bh * nblk + w.slot) * (kBlock / 4);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * n + 2 * hr + e;
              pv[x] *= (shi[x] + slo[x]) - rowv[2 * n + e];
              const int kl = 16 * wl + g + 8 * hr, ql = 8 * n + 2 * t + e;
              blk[((kl / 32) * kHalf + swz(ql, (kl % 32) * 4, 128)) / 4] =
                  pv[x];
            }
      }

      // dV += P^T.dO (dK += dS^T.Q), per step of 8 queries: lo.hi, hi.lo,
      // hi.hi; A k-columns (t, t+4) = queries (2t, 2t+1) of the step
      const uint32_t tb = stage + tdst;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int ord[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[n][r] = __float_as_uint(pv[4 * n + ord[r]]);
          al[n][r] = tf32_lo(pv[4 * n + ord[r]]);
        }
      }
      if (more) mbar_wait_or_trap(bar(kBarFull + (s ^ 1)), ((i + 1) >> 1) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint64_t dh = gmma_desc(tb + 32 * n, P::kTRow);
        const uint64_t dl = gmma_desc(tb + P::kT + 32 * n, P::kTRow);
        wgmma_rs<D>(acc, al[n], dh, 1);
        wgmma_rs<D>(acc, ah[n], dl, 1);
        wgmma_rs<D>(acc, ah[n], dh, 1);
      }
      wgmma_commit();
      // tile i+1's operands while the product runs; then every warp of the
      // warpgroup has written its part of them
      if (more) convert(s ^ 1);
      wgmma_wait_all();
      fence_regs(acc);
      if (more) named_barrier(kNbWg + wg, 128);
    }
  }

  // ---- epilogue: dV (warpgroup 0), scale dK (1); keys past Sk not written
  float* const ob = wg == 0 ? dv + b * dvs.b + hk * dvs.h
                            : dk + b * dks.b + hk * dks.h;
  const long long os = wg == 0 ? dvs.s : dks.s;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * wl + g + 8 * hr;
    if (key >= mask.Sk) continue;
    float* const row = ob + key * os;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      row[8 * n + 2 * t] = acc[4 * n + 2 * hr] * f;
      row[8 * n + 2 * t + 1] = acc[4 * n + 2 * hr + 1] * f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(__grid_constant__ const CUtensorMap kmap,
                   const uint8_t* __restrict__ dsbuf, long long nblk,
                   float* __restrict__ dq, Strides3 dqs, int B, int H,
                   int group, int Sq, float scale, AttnMask mask) {
  using R = Rows<D>;
  using P = QPlan<D>;
  constexpr int kSub = kQRows / kBQ;          // 16-row blocks in the CTA
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + P::oBar;
  auto bar = [&](int i) { return bars + 8 * i; };

  // query tiles outermost, last first: causal ones see the most keys
  const int nqt = (Sq + kQRows - 1) / kQRows;
  const int iq = nqt - 1 - blockIdx.x / (H * B);
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int hk = h / group;
  const long long bh = (long long)b * H + h;
  const int q0 = iq * kQRows;
  int jb, je;
  mask.kv_tiles(q0 + mask.q_offset, min(q0 + kQRows, Sq) - 1 + mask.q_offset,
                kBK, &jb, &je);
  const int n_steps = je > jb ? 2 * (je - jb) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(bar(kQBarFull + s), 1);
      mbar_init(bar(kQBarFree + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: its first lane issues every copy; the rest
    // exits (the consumers write K transposed) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (n_steps == 0 || warp != kConsumers / 32 || lane != 0) return;
    // each 16-row block's live tiles and its first dS block
    int sjb[kSub], sn[kSub];
    long long spre[kSub];
    long long pre = 0;
    const int ib0 = q0 / kBQ;
    for (int ib = 0; ib < ib0 + kSub; ++ib) {
      int bjb = 0;
      const int n = ib * kBQ < Sq ? block_tiles(mask, Sq, ib, &bjb) : 0;
      if (ib >= ib0) {
        sjb[ib - ib0] = bjb;
        sn[ib - ib0] = n;
        spre[ib - ib0] = pre;
      }
      pre += n;
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kQSlots, n = i / kQSlots;
      const int jj = jb + i / 2, half = i & 1;
      if (n >= 1) mbar_wait_or_trap(bar(kQBarFree + s), (n - 1) & 1);
      int live = 0;
#pragma unroll
      for (int x = 0; x < kSub; ++x)
        live += jj >= sjb[x] && jj < sjb[x] + sn[x];
      mbar_expect_tx(bar(kQBarFull + s), P::kK + live * kHalf);
      const uint32_t st = sbase + s * P::kStage;
#pragma unroll
      for (int c = 0; c < R::kChunks; ++c)
        tma_load(st + c * kStep * R::kOp, &kmap, c * R::kPer,
                 (2 * jb + i) * kStep, hk, b, bar(kQBarFull + s));
#pragma unroll
      for (int x = 0; x < kSub; ++x)
        if (jj >= sjb[x] && jj < sjb[x] + sn[x])
          bulk_load(st + P::oSdS + x * kHalf,
                    dsbuf + (bh * nblk + spre[x] + jj - sjb[x]) * kBlock +
                        half * kHalf,
                    kHalf, bar(kQBarFull + s));
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64w .. q0 + 64w + 63;
  // warp wl's 16 rows are one dS block ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  // the live tiles of the warpgroup's four 16-row blocks
  int wjb[4], wn[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int ib = q0 / kBQ + 4 * wg + x;
    wjb[x] = 0;
    wn[x] = ib * kBQ < Sq ? block_tiles(mask, Sq, ib, &wjb[x]) : 0;
  }
  constexpr int kNA = D / 2;
  float acc[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc[i] = 0.f;

  // K transposed, hi and lo, for step i: the 256 consumer threads share
  // it; a thread takes one row d and the 4 keys 4u .. 4u+3 (one 16-byte
  // unit), a warp spanning 32 rows d
  const int ctid = threadIdx.x;                     // 0 .. kConsumers-1
  auto convert = [&](int i) {
    uint8_t* const stage = smem + (i % kQSlots) * P::kStage;
#pragma unroll
    for (int it = 0; it < (D * kStep / 4 + kConsumers - 1) / kConsumers;
         ++it) {
      const int e = ctid + kConsumers * it;
      if (e < D * kStep / 4) {
        const int d = e % D, u = e / D;
        const uint8_t* src = stage + (d / R::kPer) * kStep * R::kOp;
        float4 hv, lv;
        float* hp = &hv.x;
        float* lp = &lv.x;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = *reinterpret_cast<const float*>(
              src + swz(4 * u + c, (d % R::kPer) * 4, R::kOp));
          hp[c] = tf32_hi(x);
          lp[c] = x - hp[c];
        }
        uint8_t* const dst = stage + P::oSKt + swz(d, 16 * u, P::kKtRow);
        *reinterpret_cast<float4*>(dst) = hv;
        *reinterpret_cast<float4*>(dst + P::kKt) = lv;
      }
    }
    fence_proxy_async();
  };
  if (n_steps > 0) {
    mbar_wait_or_trap(bar(kQBarFull), 0);
    convert(0);
    named_barrier(kNbKt, kConsumers);
  }
  // per step: its products (the next step's K^T is written while they run)
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kQSlots, jj = jb + i / 2;
    const bool more = i + 1 < n_steps;
    if (more) mbar_wait_or_trap(bar(kQBarFull + (i + 1) % kQSlots),
                                ((i + 1) / kQSlots) & 1);
    const uint32_t stage = sbase + s * P::kStage;
    bool wg_live = false, live = false;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const bool l = jj >= wjb[x] && jj < wjb[x] + wn[x];
      wg_live = wg_live || l;
      if (x == wl) live = l;
    }
    if (wg_live) {
      // A fragments: rows (g, g+8) x keys (t, t+4) of each step of 8 keys,
      // hi and lo; zeros for a block the masks drop
      const uint8_t* blk = smem + s * P::kStage + P::oSdS +
                           (4 * wg + wl) * kHalf;
      uint32_t ah[kStep / 8][4], al[kStep / 8][4];
#pragma unroll
      for (int ks = 0; ks < kStep / 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = live ? *reinterpret_cast<const float*>(
                                     blk + swz(g + 8 * (r & 1),
                                               (8 * ks + t + 4 * (r >> 1)) * 4,
                                               128))
                               : 0.f;
          ah[ks][r] = __float_as_uint(x);
          al[ks][r] = tf32_lo(x);
        }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kStep / 8; ++ks) {
        const uint64_t dh = gmma_desc(stage + P::oSKt + 32 * ks, P::kKtRow);
        const uint64_t dl =
            gmma_desc(stage + P::oSKt + P::kKt + 32 * ks, P::kKtRow);
        wgmma_rs<D>(acc, al[ks], dh, 1);
        wgmma_rs<D>(acc, ah[ks], dl, 1);
        wgmma_rs<D>(acc, ah[ks], dh, 1);
      }
      wgmma_commit();
    }
    if (more) convert(i + 1);
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kQBarFree + s));
    if (more) named_barrier(kNbKt, kConsumers);
  }

  // ---- epilogue: scale dQ; rows past Sq not written ----
  float* const ob = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + 64 * wg + 16 * wl + g + 8 * hr;
    if (row >= Sq) continue;
    float* const orow = ob + row * dqs.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      orow[8 * n + 2 * t] = acc[4 * n + 2 * hr] * scale;
      orow[8 * n + 2 * t + 1] = acc[4 * n + 2 * hr + 1] * scale;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, void* dvec, void* scratch,
               void* dq, void* dk, void* dv, const long long* st, int B, int H,
               int Hkv, int Sq, int Sk, double scale, const AttnMask& mask,
               cudaStream_t stream) {
  using R = Rows<D>;
  using PK = KvPlan<D>;
  using PQ = QPlan<D>;
  // above 48 KB a kernel must opt in to dynamic shared memory (once each)
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PK::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PQ::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap qm, km, vm, dom, kqm;
  int e = encode_rows(&qm, f32, 4, q, D, Sq, H, B, st, R::kPer, kBQ);
  if (e == 0) e = encode_rows(&km, f32, 4, k, D, Sk, Hkv, B, st + 3, R::kPer, kBK);
  if (e == 0) e = encode_rows(&vm, f32, 4, v, D, Sk, Hkv, B, st + 6, R::kPer, kBK);
  if (e == 0) e = encode_rows(&dom, f32, 4, dout, D, Sq, H, B, st + 12, R::kPer, kBQ);
  if (e == 0) e = encode_rows(&kqm, f32, 4, k, D, Sk, Hkv, B, st + 3, R::kPer, kStep);
  if (e != 0) return e;
  e = launch_dot<float>(out, dout, dvec, st, B, H, Sq, D, stream);
  if (e != 0) return e;
  const long long nblk = scratch_blocks(mask, Sq);
  const int group = H / Hkv;
  const int nkv = (Sk + kBK - 1) / kBK;
  if ((long long)nkv * Hkv * B > 0x7fffffffLL ||
      (long long)((Sq + kQRows - 1) / kQRows) * H * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  attn_bwd_dkdv_kernel<D><<<nkv * Hkv * B, kThreads, PK::kBytes, stream>>>(
      qm, km, vm, dom, lse, static_cast<const float*>(dvec),
      static_cast<float*>(scratch), nblk, static_cast<float*>(dk),
      strides_at(st, 6), static_cast<float*>(dv), strides_at(st, 7), B, H,
      Hkv, group, Sq, (float)scale, mask);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int nqt = (Sq + kQRows - 1) / kQRows;
  attn_bwd_dq_kernel<D><<<nqt * H * B, kThreads, PQ::kBytes, stream>>>(
      kqm, static_cast<const uint8_t*>(scratch), nblk,
      static_cast<float*>(dq), strides_at(st, 5), B, H, group, Sq,
      (float)scale, mask);
  return (int)cudaGetLastError();
}

// ===========================================================================
// FMA on the CUDA cores: float64 in double, float32 at D 160
// ===========================================================================
//
// Simple on purpose: each of 256 threads (a 16 x 16 grid) holds a register
// micro-tile (rows ty + 16a, columns tx + 16c: strided, so that a warp's
// shared reads fall in distinct banks or broadcast) of square tiles of
// Fma<T>::kTile rows (32 for double, 64 for float), rows padded by one
// element.  The dkdv kernel: one CTA per (kv tile, kv head, batch) keeps K
// and V in shared memory and walks the query tiles of each of its group's
// heads that the tile test keeps, computing S and dP, then P and dS into
// shared memory, then dV += P^T dout and dK += dS^T Q.  The dq kernel: one
// CTA per (query tile, head, batch) keeps Q and dout and walks its live kv
// tiles (the forward's contiguous range), dQ += dS K; it recomputes S and
// dP (seven products in all, not five), which keeps it free of atomics and
// of a dS scratch.
//
// Shared memory (bytes): (2 (Q, dout) + 2 (K, V)) tiles x (D + 1) + P, dS
// (tile x (tile + 1)) + lse and D rows: 198,656 for float at D 160,
// 149,504 for double at D 128.

constexpr int kFmaThreads = 256;

// rows [r0, r0 + R) of one head (row stride s_stride, D contiguous) into a
// shared tile of R rows of D + 1 in the compute type; rows past S are zeros
template <int D, int R, typename T, typename A>
__device__ __forceinline__ void load_tile(A* dst, const T* src,
                                          long long s_stride, int r0, int S) {
  for (int e = threadIdx.x; e < R * D; e += kFmaThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] =
        row < S ? acc_of(src[(long long)row * s_stride + c]) : A(0);
  }
}

template <typename T, int D>
struct FmaSmem {
  using A = typename Fma<T>::A;
  static constexpr int kBQ = Fma<T>::kTile, kBK = Fma<T>::kTile;
  static constexpr int kLD = D + 1, kLP = kBK + 1;
  // dkdv: Q, dout, K, V, P, dS, lse, D
  static constexpr int kDkdv = (2 * kBQ * kLD + 2 * kBK * kLD + 2 * kBQ * kLP +
                                2 * kBQ) * (int)sizeof(A);
  // dq: Q, dout, K, V, dS, lse, D
  static constexpr int kDq =
      (2 * kBQ * kLD + 2 * kBK * kLD + kBQ * kLP + 2 * kBQ) * (int)sizeof(A);
};

// S = Q K^T and dP = dout V^T on this thread's micro-tile (rows ty + 16a,
// keys tx + 16c), then P and dS of the tile's allowed pairs
template <typename T, int D, typename A>
__device__ __forceinline__ void probs_and_ds(
    const A* sQ, const A* sdO, const A* sK, const A* sV, const A* sL,
    const A* sDv, A* sP, A* sdS, int q0, int k0, int Sq, A scale,
    const AttnMask& mask) {
  using S = FmaSmem<T, D>;
  constexpr int TM = S::kBQ / 16, TN = S::kBK / 16, LD = S::kLD, LP = S::kLP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  A s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      s[a][c] = A(0);
      dp[a][c] = A(0);
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    A qa[TM], oa[TM], kb[TN], vb[TN];
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
      A p = A(0);
      if (i < Sq && mask.allowed(i + mask.q_offset, j))
        p = exp_acc(s[a][c] * scale - sL[r]);
      sP[r * LP + tx + 16 * c] = p;
      sdS[r * LP + tx + 16 * c] = p * (dp[a][c] - sDv[r]);
    }
  }
}

template <int BQ, typename A>
__device__ __forceinline__ void load_rows(A* sL, A* sDv,
                                          const float* __restrict__ lse,
                                          const A* __restrict__ dvec,
                                          long long bh, int q0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += kFmaThreads) {
    const int i = q0 + r;
    sL[r] = i < Sq ? (A)lse[bh * Sq + i] : A(0);
    sDv[r] = i < Sq ? dvec[bh * Sq + i] : A(0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFmaThreads)
attn_bwd_dkdv_fma_kernel(const T* __restrict__ q, Strides3 qs,
                         const T* __restrict__ k, Strides3 ks,
                         const T* __restrict__ v, Strides3 vs,
                         const T* __restrict__ dout, Strides3 dos,
                         const float* __restrict__ lse,
                         const typename Fma<T>::A* __restrict__ dvec,
                         T* __restrict__ dk, Strides3 dks,
                         T* __restrict__ dv, Strides3 dvs, int H,
                         int group, int Sq, double scale_d, AttnMask mask) {
  using S = FmaSmem<T, D>;
  using A = typename S::A;
  constexpr int BQ = S::kBQ, BK = S::kBK, LD = S::kLD, LP = S::kLP;
  constexpr int TK = BK / 16, TD = D / 16;
  const A scale = (A)scale_d;
  extern __shared__ __align__(16) unsigned char smem_fma[];
  A* sQ = reinterpret_cast<A*>(smem_fma);
  A* sdO = sQ + BQ * LD;
  A* sK = sdO + BQ * LD;
  A* sV = sK + BK * LD;
  A* sP = sV + BK * LD;
  A* sdS = sP + BQ * LP;
  A* sL = sdS + BQ * LP;
  A* sDv = sL + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK, k_hi = k0 + BK - 1;
  load_tile<D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, mask.Sk);
  load_tile<D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, mask.Sk);

  A acc_k[TK][TD], acc_v[TK][TD];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      acc_k[a][c] = A(0);
      acc_v[a][c] = A(0);
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
      load_tile<D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
      load_rows<BQ>(sL, sDv, lse, dvec, bh, q0, Sq);
      __syncthreads();
      probs_and_ds<T, D>(sQ, sdO, sK, sV, sL, sDv, sP, sdS, q0, k0, Sq,
                         scale, mask);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dout[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        A pa[TK], sa[TK], ob[TD], qb[TD];
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
__global__ void __launch_bounds__(kFmaThreads)
attn_bwd_dq_fma_kernel(const T* __restrict__ q, Strides3 qs,
                       const T* __restrict__ k, Strides3 ks,
                       const T* __restrict__ v, Strides3 vs,
                       const T* __restrict__ dout, Strides3 dos,
                       const float* __restrict__ lse,
                       const typename Fma<T>::A* __restrict__ dvec,
                       T* __restrict__ dq, Strides3 dqs, int H,
                       int group, int Sq, double scale_d, AttnMask mask) {
  using S = FmaSmem<T, D>;
  using A = typename S::A;
  constexpr int BQ = S::kBQ, BK = S::kBK, LD = S::kLD, LP = S::kLP;
  constexpr int TM = BQ / 16, TD = D / 16;
  const A scale = (A)scale_d;
  extern __shared__ __align__(16) unsigned char smem_fma[];
  A* sQ = reinterpret_cast<A*>(smem_fma);
  A* sdO = sQ + BQ * LD;
  A* sK = sdO + BQ * LD;
  A* sV = sK + BK * LD;
  A* sdS = sV + BK * LD;
  A* sL = sdS + BQ * LP;
  A* sDv = sL + BQ;
  // dS goes where dkdv keeps P; P itself is not needed here
  A* sP = sdS;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long bh = (long long)b * H + h;
  const int q0 = blockIdx.x * BQ;
  load_tile<D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  load_rows<BQ>(sL, sDv, lse, dvec, bh, q0, Sq);
  int j_begin, j_end;
  mask.kv_tiles(q0 + mask.q_offset, min(q0 + BQ, Sq) - 1 + mask.q_offset, BK,
                &j_begin, &j_end);

  A acc[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[a][c] = A(0);
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, mask.Sk);
    load_tile<D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, mask.Sk);
    __syncthreads();
    // P is written and then overwritten by dS in the same slot: each
    // thread writes only its own entries, P first
    probs_and_ds<T, D>(sQ, sdO, sK, sV, sL, sDv, sP, sdS, q0, k0, Sq, scale,
                       mask);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      A sa[TM], kb[TD];
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

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, void* dvec, void* dq,
               void* dk, void* dv, const long long* st, int B, int H, int Hkv,
               int Sq, int Sk, double scale, const AttnMask& mask,
               cudaStream_t stream) {
  using S = FmaSmem<T, D>;
  using A = typename S::A;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_fma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDkdv);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_fma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kDq);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const A* dvt = static_cast<const A*>(dvec);
  int e = launch_dot<T>(out, dout, dvec, st, B, H, Sq, D, stream);
  if (e != 0) return e;
  const int group = H / Hkv;
  dim3 gkv((Sk + S::kBK - 1) / S::kBK, Hkv, B);
  attn_bwd_dkdv_fma_kernel<T, D><<<gkv, kFmaThreads, S::kDkdv, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<T*>(dk), strides_at(st, 6),
      static_cast<T*>(dv), strides_at(st, 7), H, group, Sq, scale, mask);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  dim3 gq((Sq + S::kBQ - 1) / S::kBQ, H, B);
  attn_bwd_dq_fma_kernel<T, D><<<gq, kFmaThreads, S::kDq, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<T*>(dq), strides_at(st, 5), H,
      group, Sq, scale, mask);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bfloat16: wgmma from TMA-fed tiles
// ===========================================================================
//
// The flash recurrence of the float32 kernels on bfloat16 q, k, v, dout as
// they are (no float32 copy): S = Q.K^T and dP = dO.V^T in float32; P =
// exp(S scale - lse) and dS = P (dP - D) in float32, rounded to bfloat16
// only where they are the A operand of the next product (dV += P^T.dO, dK
// += dS^T.Q, dQ += dS.K), as FlashAttention does; every sum in float32,
// dq, dk, dv rounded to bfloat16 once.
//
// Bound on the H100: operations over the bfloat16 tensor-core rate, five
// products (0.0869 ms at qwen3's B 8, H 16/8, S 1024, D 128, causal), and
// this design does those five.  The dK/dV kernel writes each dS^T tile, as
// rounded to bfloat16 for dK += dS^T.Q, to a scratch of the live (64-query,
// 64-key) tiles in global memory (0.143 GB at that shape, ~0.085 ms of HBM
// traffic written and read once), in the swizzled image that the dQ kernel
// reads as its MN-major A operand; so dQ += dS.K is the dQ kernel's one
// product, with no exp and no S or dP.  A first design recomputed S and dP
// in the dQ kernel (seven products, no scratch: the two products looked
// cheaper than the scratch's traffic at the tensor cores' full rate), and
// that dQ kernel, latency-bound on the exp between its products, took
// longer than the scratch's dQ kernel and the dK/dV kernel's writes of the
// scratch together (PERF.md).  No atomics: each dS^T tile is written once,
// by one CTA, and read once.
//
// Every product is one wgmma.m64nNk16 (bfloat16 in, float32 accumulators)
// on tiles that TMA lands in its swizzle (128 bytes; 64 at D 160, whose
// 320-byte rows are no multiple of 128, chunks of 32 elements; 64 and 32 at
// D 32 and 16), which is wgmma's operand layout both ways: read K-major, a
// K, V, Q or dO tile is the A or B operand of S^T = K.Q^T and dP^T = V.dO^T;
// read MN-major (the transpose bit that wgmma has for 16-bit types), dO
// and Q are the B operands of dV += P^T.dO and dK += dS^T.Q, and K that of
// dQ += dS.K (whose A, a dS^T tile of the scratch, is read MN-major too),
// exactly as they landed.  P^T and dS^T go from the float32 accumulator
// straight into the bfloat16 A-register fragment of the next wgmma: the
// accumulator holds columns 2t and 2t+1 of each 8-column block of rows g
// and g+8, which packed pairwise is the A fragment of a 16-deep step.
//
// Both kernels: heavy causal tiles first; two consumer warpgroups of 64
// rows each (the M of every wgmma) and a ring of slots that one thread
// fills by TMA and bulk copies; mbarriers order the roles: full (the bytes
// landed, and in the dK/dV kernel the row values written), free (every
// consumer warp is done with the slot).  The dK/dV kernel has 384 threads:
// a producer warpgroup (setmaxnreg 24) whose first warp alone works, and
// the consumers (setmaxnreg 240).  The dQ kernel is the two consumer
// warpgroups alone, thread 0 refilling each slot once every warp is done
// with it: with its ~100 registers two CTAs share an SM at D <= 128.
// Registers bound the dK/dV layout: a first one gave each warpgroup dK and
// dV of its own 64 keys and S^T, dP^T of 64 queries (192 accumulator
// floats a thread), and ptxas, whatever setmaxnreg granted, kept an
// accumulator in local memory or moved it there around every S^T chain,
// and serialized every wgmma; so no consumer holds more than D/2 + 32
// accumulator floats (its own sum and S^T or dP^T of 64 queries), and none
// spills.  P is 2^x from the
// SFU alone (ex2.approx.ftz: a P below 2^-126 is 0, far below what the
// bfloat16 operands and the float32 sums resolve); exp2f's range handling
// added three instructions an element on the path every other step waits
// for.  Only steps that the causal diagonal, the window edge or Sk cross
// pay for the element mask; rows past Sq get lse = +inf, so their P is 0.
//
//   dkdv kernel  per (64 keys, kv head, batch): K and V once; then, for
//                each of its GQA group's heads in order, the query blocks of
//                64 its keys meet: Q, dO by TMA, and lse (times log2 e) and
//                D by the producer warp.  Both warpgroups work on the same
//                64 keys: warpgroup 0 computes S^T = K.Q^T, P^T, hands P^T
//                (float) to warpgroup 1 through a 2-slot exchange in shared
//                memory (named barriers), and keeps dV += P^T.dO; warpgroup
//                1 computes dP^T = V.dO^T, dS^T = P^T (dP^T - D), keeps dK
//                += dS^T.Q and writes dS^T's bfloat16 A fragments to the
//                scratch (their swizzled positions; the producer puts each
//                step's tile index beside its rows).  With two exchange
//                slots warpgroup 0 runs up to a step ahead, so its S^T and
//                exp overlap warpgroup 1's dK of the step before; and each
//                warpgroup issues its next step's S^T (dP^T) chain right
//                behind this step's dV (dK) product, waiting for both at
//                the top of the next step.
//   dq kernel    per (128 queries, head, batch), 256 threads: its live kv
//                tiles of 64 keys, K by TMA and the two 64-query blocks'
//                dS^T tiles by bulk copies; warpgroup w keeps dQ of rows
//                64w .. 64w + 63 (D/2 floats a thread) and runs dQ += dS.K
//                with both operands read MN-major; it skips a tile its
//                block's rows do not see (that tile is not in the scratch).
//
// Shared memory (bytes): dkdv K, V 2 x 64 x 2D, 3 slots of Q, dO (2 x 64 x
// 2D) with the rows (2 x 64 x 4) and the tile index, each slot rounded up
// to 1 KB, and the exchange 2 x 16384: 166,912 at D 128 and 199,680 at D
// 160; dq 3 slots of K (64 x 2D) and two dS^T tiles (2 x 8192): 98,304 at D
// 128 and 110,592 at D 160; each plus 1 KB of alignment slack and the
// barriers.

constexpr int kHKeys = 64;     // keys per dK/dV CTA (both warpgroups')
constexpr int kHQ = 64;        // queries per dK/dV step
constexpr int kHRows = 128;    // queries per dQ CTA (64 a consumer warpgroup)
constexpr int kHStep = 64;     // keys per dQ step
constexpr int kHSlots = 3;     // the dK/dV kernel's ring
constexpr int kHQSlots = 3;    // the dQ kernel's ring
static_assert(kHQ == 64 && kHStep == 64 && kHKeys == 64,
              "S^T and dP^T are m64n64 products (products_kmajor), and a dS "
              "tile is 64 x 64");
// bytes of one dS^T tile of the scratch: 64 keys x 64 queries of bfloat16,
// rows of 128 bytes in TMA's and wgmma's 128-byte swizzle (the MN-major A
// operand image of dQ += dS.K)
constexpr int kHTile = kHKeys * kHQ * 2;
// named barriers of the dK/dV kernel's P^T exchange (0 is __syncthreads):
// slot x full (1 + x), empty (3 + x)
constexpr int kHNbXFull = 1, kHNbXEmpty = 3;

// A bfloat16 tile with D along its rows, as TMA lands it: chunks of kPer
// elements, rows of kOp bytes (TMA's swizzle of that width); chunk c of a
// tile of R rows at c R kOp
template <int D>
struct Rows16 {
  static constexpr int kOp =
      D * 2 <= 128 ? D * 2 : (D * 2) % 128 == 0 ? 128 : 64;
  static constexpr int kPer = kOp / 2;
  static constexpr int kChunks = D / kPer;
};

template <int D>
struct HKvPlan {
  static constexpr int kKV = kHKeys * D * 2;    // K or V
  static constexpr int kQ = kHQ * D * 2;        // Q or dO of one step
  // a slot: Q, dO, then lse (log2 units) and D of its kHQ rows
  static constexpr int oSdO = kQ;
  static constexpr int oSRows = 2 * kQ;
  // a slot: Q, dO, the lse and D rows, then the step's dS tile index (int)
  static constexpr int kStage =
      (2 * kQ + 2 * kHQ * 4 + 16 + 1023) / 1024 * 1024;
  static constexpr int oK = 0;
  static constexpr int oV = kKV;
  static constexpr int oRing = 2 * kKV;
  // the P^T exchange: two slots of 64 keys x kHQ queries of float, at the
  // accumulator's fragment positions (a thread's four values of each
  // 8-query block as one float4)
  static constexpr int oX = oRing + kHSlots * kStage;
  static constexpr int kX = kHKeys * kHQ * 4;
  static constexpr int oBar = oX + 2 * kX;
  static constexpr int kBytes = oBar + (1 + 2 * kHSlots) * 8 + 1024;
};

template <int D>
struct HQPlan {
  static constexpr int kK = kHStep * D * 2;     // K of one step
  // a slot: K, then the dS^T tiles of the two warpgroups' query blocks
  static constexpr int oSdS = kK;
  static constexpr int kStage = kK + 2 * kHTile;
  static constexpr int oBar = kHQSlots * kStage;
  static constexpr int kBytes = oBar + 2 * kHQSlots * 8 + 1024;
};
// dK/dV barriers: 0 K and V landed; per slot full (1 + s) and free (1 +
// kHSlots + s)
__device__ __forceinline__ int h_full(int s) { return 1 + s; }
__device__ __forceinline__ int h_free(int s) { return 1 + kHSlots + s; }

// The live 64-key tiles of 64-query block iq, [*jb, *jb + n): the dS tiles
// of that block in the scratch; returns n
__host__ __device__ inline int h_block_tiles(const AttnMask& m, int Sq, int iq,
                                             int* jb) {
  const int last = iq * kHQ + kHQ < Sq ? iq * kHQ + kHQ : Sq;
  int je;
  m.kv_tiles(iq * kHQ + m.q_offset, last - 1 + m.q_offset, kHKeys, jb, &je);
  return je > *jb ? je - *jb : 0;
}

// dS tiles of one (b, h): every 64-query block's live tiles, blocks in
// order, each block's tiles in order
inline long long h_scratch_tiles(const AttnMask& m, int Sq) {
  long long n = 0;
  int jb;
  for (int iq = 0; iq < (Sq + kHQ - 1) / kHQ; ++iq)
    n += h_block_tiles(m, Sq, iq, &jb);
  return n;
}
// arrivals on a dK/dV full barrier: the TMA lane's, and each lane of the
// warp that writes the rows
constexpr int kHRowArrivals = 32;

// d[64 x 64] += a[64 x 16] . b[64 x 16]^T, a and b in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_bf16_ss_n64(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] = a[64 x 16] . b[64 x 16]^T, a and b in shared memory,
// both K-major; d tied in and out, scale-d 0 (its old values unused)
__device__ __forceinline__ void wgmma_bf16_ssz_n64(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 16] += a[64 x 16] . b[16 x 16], a and b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_sstt_n16(float (&d)[8],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 32] += a[64 x 16] . b[16 x 32], a and b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_sstt_n32(float (&d)[16],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 16] . b[16 x 64], a and b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_sstt_n64(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 16] . b[16 x 128], a and b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_sstt_n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 160] += a[64 x 16] . b[16 x 160], a and b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_sstt_n160(float (&d)[80],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_sstt(float (&d)[N / 2], uint64_t da,
                                                uint64_t db) {
  if constexpr (N == 16) wgmma_bf16_sstt_n16(d, da, db);
  else if constexpr (N == 32) wgmma_bf16_sstt_n32(d, da, db);
  else if constexpr (N == 64) wgmma_bf16_sstt_n64(d, da, db);
  else if constexpr (N == 128) wgmma_bf16_sstt_n128(d, da, db);
  else wgmma_bf16_sstt_n160(d, da, db);
}

// d[64 x 16] += a[64 x 16] . b[16 x 16], a in registers (the bf16 A
// fragment), b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n16(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += a[64 x 16] . b[16 x 32], a in registers (the bf16 A
// fragment), b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n32(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 16] . b[16 x 64], a in registers (the bf16 A
// fragment), b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 16] . b[16 x 128], a in registers (the bf16 A
// fragment), b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 160] += a[64 x 16] . b[16 x 160], a in registers (the bf16 A
// fragment), b MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n160(float (&d)[80],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (N == 16) wgmma_bf16_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_bf16_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_bf16_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_bf16_rs_n128(d, a, db);
  else wgmma_bf16_rs_n160(d, a, db);
}

// 2^x by the SFU alone (ex2.approx.ftz: a result below 2^-126 is 0)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc = a[64 x D] . b[64 x D]^T over D in steps of 16, a and b K-major
// tiles of Rows16<D> (a of ra rows, b of rb rows, starting at a row that is
// a multiple of 8).  The first step does not read acc but has it tied in
// and out (scale-d 0): acc is carried across the pipelined loop, where a
// write-only accumulator makes the compiler copy it at the back edge and
// ptxas then serializes every wgmma (C7515)
template <int D>
__device__ __forceinline__ void products_kmajor(float (&acc)[32], uint32_t a,
                                                int ra, uint32_t b, int rb) {
  using R = Rows16<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t c = 16 * ks / R::kPer, off = (16 * ks % R::kPer) * 2;
    const uint64_t da = gmma_desc(a + c * ra * R::kOp + off, R::kOp);
    const uint64_t db = gmma_desc(b + c * rb * R::kOp + off, R::kOp);
    if (ks == 0) wgmma_bf16_ssz_n64(acc, da, db);
    else wgmma_bf16_ss_n64(acc, da, db);
  }
}

// acc[D / 2] += a . b over K = 16 * KS, a as bfloat16 A fragments, b the
// MN-major tile of Rows16<D> of rows rows (one per K index)
template <int D, int KS>
__device__ __forceinline__ void products_mn(float (&acc)[D / 2],
                                            const uint32_t (&a)[KS][4],
                                            uint32_t b, int rows) {
  using R = Rows16<D>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_bf16_rs<D>(acc, a[kk],
                     gmma_desc_mn(b + 16 * kk * R::kOp, R::kOp,
                                  rows * R::kOp));
}

// The accumulator's 8-column blocks packed pairwise: the bfloat16 A
// fragments of the 16-deep steps over its columns
template <int N>
__device__ __forceinline__ void to_afrag(const float (&acc)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// The query blocks of bq rows that keys [k_lo, k_hi] meet: a contiguous
// range [*b, *e) (empty when *e <= *b)
__device__ __forceinline__ void q_blocks(const AttnMask& m, int Sq, int bq,
                                         int k_lo, int k_hi, int* b, int* e) {
  const int nq = (Sq + bq - 1) / bq;
  int first = nq, last = -1;
  for (int iq = 0; iq < nq; ++iq) {
    const int q_lo = iq * bq + m.q_offset;
    const int q_hi = min(iq * bq + bq, Sq) - 1 + m.q_offset;
    if (m.tile_live(q_lo, q_hi, k_lo, k_hi)) {
      if (first == nq) first = iq;
      last = iq;
    }
  }
  *b = first;
  *e = last + 1;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_bf16_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          uint8_t* __restrict__ dsbuf, long long nblk,
                          __nv_bfloat16* __restrict__ dk, Strides3 dks,
                          __nv_bfloat16* __restrict__ dv, Strides3 dvs,
                          int B, int H, int Hkv, int group, int Sq,
                          float scale, AttnMask mask) {
  using R = Rows16<D>;
  using P = HKvPlan<D>;
  constexpr int BQ = kHQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + P::oBar;
  auto bar = [&](int i) { return bars + 8 * i; };

  // kv tiles outermost in the grid: with a causal mask the first ones meet
  // the most query blocks, so the grid's tail is the light CTAs
  const int j = blockIdx.x / (Hkv * B);
  const int hk = blockIdx.x % Hkv, b = (blockIdx.x / Hkv) % B;
  const int k0 = j * kHKeys;
  // steps: the group's heads in order, each over the query blocks [ib, ie)
  // that the CTA's keys meet (every step is live for both warpgroups)
  int ib, ie;
  q_blocks(mask, Sq, BQ, k0, k0 + kHKeys - 1, &ib, &ie);
  const int nb = ie > ib ? ie - ib : 0;
  const int n_steps = group * nb;

  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < kHSlots; ++s) {
      mbar_init(bar(h_full(s)), 1 + kHRowArrivals);
      mbar_init(bar(h_free(s)), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index through a shuffle, so the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: its first warp alone works (lane 0 issues
    // every TMA copy; the 32 lanes write each step's row values, read before
    // the slot is free); it is whole so that its setmaxnreg.dec frees what
    // the consumers take
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (n_steps == 0 || warp != kConsumers / 32) return;
    if (lane == 0) {
      mbar_expect_tx(bar(0), 2 * P::kKV);
#pragma unroll
      for (int c = 0; c < R::kChunks; ++c) {
        tma_load(sbase + P::oK + c * kHKeys * R::kOp, &kmap, c * R::kPer, k0,
                 hk, b, bar(0));
        tma_load(sbase + P::oV + c * kHKeys * R::kOp, &vmap, c * R::kPer, k0,
                 hk, b, bar(0));
      }
    }
    // the dS tiles of the blocks before ib, in each head's part of the
    // scratch; then the step's block's first tile and its live count
    int base = 0, toff = 0, n_prev = 0;
    for (int iq = 0; iq < ib; ++iq) {
      int jb;
      base += h_block_tiles(mask, Sq, iq, &jb);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kHSlots, n = i / kHSlots;
      const int h = hk * group + i / nb, iq = ib + i % nb, q0 = iq * BQ;
      const long long bh = (long long)b * H + h;
      toff = i % nb == 0 ? base : toff + n_prev;
      int jb;
      n_prev = h_block_tiles(mask, Sq, iq, &jb);
      float lv[BQ / 32], dvv[BQ / 32];
#pragma unroll
      for (int x = 0; x < BQ / 32; ++x) {
        const int qi = q0 + lane + 32 * x;
        lv[x] = qi < Sq ? lse[bh * Sq + qi] * kLog2e : INFINITY;
        dvv[x] = qi < Sq ? dvec[bh * Sq + qi] : 0.f;
      }
      if (n >= 1) mbar_wait_or_trap(bar(h_free(s)), (n - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(bar(h_full(s)), 2 * P::kQ);
        const uint32_t st = sbase + P::oRing + s * P::kStage;
#pragma unroll
        for (int c = 0; c < R::kChunks; ++c) {
          tma_load(st + c * BQ * R::kOp, &qmap, c * R::kPer, q0, h, b,
                   bar(h_full(s)));
          tma_load(st + P::oSdO + c * BQ * R::kOp, &domap, c * R::kPer, q0,
                   h, b, bar(h_full(s)));
        }
      }
      float* const rows = reinterpret_cast<float*>(
          smem + P::oRing + s * P::kStage + P::oSRows);
#pragma unroll
      for (int x = 0; x < BQ / 32; ++x) {
        rows[lane + 32 * x] = lv[x];
        rows[BQ + lane + 32 * x] = dvv[x];
      }
      if (lane == 0)
        reinterpret_cast<int*>(rows)[2 * BQ] = toff + j - jb;
      mbar_arrive(bar(h_full(s)));
    }
    return;
  }

  // ---- consumers on the CTA's 64 keys: warpgroup 0 S^T -> P^T, dV;
  // warpgroup 1 dP^T -> dS^T, dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int tid = threadIdx.x % 128;
  const float scale_log2 = scale * kLog2e;
  const int off = mask.q_offset;

  constexpr int kNA = D / 2;      // dV (warpgroup 0) or dK (1) a thread
  float acc[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc[i] = 0.f;

  if (n_steps > 0) {
    mbar_wait_or_trap(bar(0), 0);
    const uint32_t aKV = sbase + (wg == 0 ? P::oK : P::oV);
    float* const xch = reinterpret_cast<float*>(smem + P::oX);
    auto slot = [&](int i) {
      return sbase + P::oRing + (i % kHSlots) * P::kStage;
    };
    // S^T = K.Q^T (warpgroup 0) or dP^T = V.dO^T (1): keys k0 + 16wl + g +
    // 8hr, queries q0 + 8n + 2t + e at [4n + 2hr + e]; the exchange holds a
    // thread's four values of block n as one float4.  Pipelined by a step:
    // step i + 1's chain goes out right behind step i's dV (dK) product, and
    // both are waited for at the top of step i + 1
    float sacc[BQ / 2];
#pragma unroll
    for (int y = 0; y < BQ / 2; ++y) sacc[y] = 0.f;
    mbar_wait_or_trap(bar(h_full(0)), 0);
    wgmma_fence();
    products_kmajor<D>(sacc, aKV, kHKeys,
                       wg == 0 ? slot(0) : slot(0) + P::oSdO, BQ);
    wgmma_commit();
    for (int i = 0; i < n_steps; ++i) {
      const int x = i & 1;
      const int q0 = (ib + i % nb) * BQ;
      const uint32_t aQ = slot(i), adO = aQ + P::oSdO;
      const float* const rows = reinterpret_cast<const float*>(
          smem + P::oRing + (i % kHSlots) * P::kStage + P::oSRows);
      float* const xb = xch + x * (BQ / 2) * 128;
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(acc);
      if (i >= 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(h_free((i - 1) % kHSlots)));
      }
      if (wg == 0) {
        // P^T = exp2(S^T scale log2e - lse log2e) on the allowed pairs,
        // handed to warpgroup 1 at the same fragment positions
        const bool full = mask.tile_full(q0 + off, q0 + BQ - 1 + off, k0,
                                         k0 + kHKeys - 1);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * n + 2 * t);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int y = 4 * n + 2 * hr + e;
              float p =
                  ex2_ftz(fmaf(sacc[y], scale_log2, -(e ? l2.y : l2.x)));
              if (!full && !mask.allowed(q0 + 8 * n + 2 * t + e + off,
                                         k0 + 16 * wl + g + 8 * hr))
                p = 0.f;
              sacc[y] = p;
            }
        }
        if (i >= 2) named_barrier(kHNbXEmpty + x, kConsumers);
#pragma unroll
        for (int m = 0; m < BQ / 8; ++m)
          reinterpret_cast<float4*>(xb)[m * 128 + tid] =
              make_float4(sacc[4 * m], sacc[4 * m + 1], sacc[4 * m + 2],
                          sacc[4 * m + 3]);
        __threadfence_block();
        named_arrive(kHNbXFull + x, kConsumers);
      } else {
        // dS^T = P^T (dP^T - D)
        named_barrier(kHNbXFull + x, kConsumers);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(rows + BQ + 8 * n + 2 * t);
          const float4 p4 = reinterpret_cast<const float4*>(xb)[n * 128 + tid];
          sacc[4 * n] = p4.x * (sacc[4 * n] - d2.x);
          sacc[4 * n + 1] = p4.y * (sacc[4 * n + 1] - d2.y);
          sacc[4 * n + 2] = p4.z * (sacc[4 * n + 2] - d2.x);
          sacc[4 * n + 3] = p4.w * (sacc[4 * n + 3] - d2.y);
        }
        if (i + 2 < n_steps) named_arrive(kHNbXEmpty + x, kConsumers);
      }
      uint32_t af[BQ / 16][4];
      to_afrag<BQ>(sacc, af);
      if (wg == 1) {
        // dS^T, as rounded for dK += dS^T.Q, to the scratch for the dQ
        // kernel: row key, 128 bytes of queries, swizzled (its MN-major A)
        const long long bh = (long long)b * H + hk * group + i / nb;
        uint8_t* const tile =
            dsbuf + (bh * nblk + reinterpret_cast<const int*>(rows)[2 * BQ]) *
                        kHTile;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                tile + swz(16 * wl + g + 8 * (r & 1),
                           (16 * kk + 8 * (r >> 1) + 2 * t) * 2, 128)) =
                af[kk][r];
      }
      const bool more = i + 1 < n_steps;
      if (more)
        mbar_wait_or_trap(bar(h_full((i + 1) % kHSlots)),
                          ((i + 1) / kHSlots) & 1);
      wgmma_fence();
      products_mn<D, BQ / 16>(acc, af, wg == 0 ? adO : aQ, BQ);
      if (more)
        products_kmajor<D>(sacc, aKV, kHKeys,
                           wg == 0 ? slot(i + 1) : slot(i + 1) + P::oSdO,
                           BQ);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- epilogue: dV (warpgroup 0), scale dK (1), bfloat16; keys past Sk
  // not written
  __nv_bfloat16* const ob = wg == 0 ? dv + b * dvs.b + hk * dvs.h
                                    : dk + b * dks.b + hk * dks.h;
  const long long os = wg == 0 ? dvs.s : dks.s;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * wl + g + 8 * hr;
    if (key >= mask.Sk) continue;
    __nv_bfloat16* const row = ob + key * os;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t) =
          pack_bf16(acc[4 * n + 2 * hr] * f, acc[4 * n + 2 * hr + 1] * f);
  }
}

template <int D>
__global__ void __launch_bounds__(kConsumers, 2)
attn_bwd_dq_bf16_kernel(__grid_constant__ const CUtensorMap kmap,
                        const uint8_t* __restrict__ dsbuf, long long nblk,
                        __nv_bfloat16* __restrict__ dq, Strides3 dqs, int B,
                        int H, int group, int Sq, float scale,
                        AttnMask mask) {
  using R = Rows16<D>;
  using P = HQPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + P::oBar;
  auto bar = [&](int i) { return bars + 8 * i; };

  // query tiles outermost, last first: causal ones see the most keys
  const int nqt = (Sq + kHRows - 1) / kHRows;
  const int iq = nqt - 1 - blockIdx.x / (H * B);
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int hk = h / group;
  const long long bh = (long long)b * H + h;
  const int q0 = iq * kHRows;
  const int off = mask.q_offset;
  int jb, je;
  mask.kv_tiles(q0 + off, min(q0 + kHRows, Sq) - 1 + off, kHStep, &jb, &je);
  const int n_steps = je > jb ? je - jb : 0;
  // each warpgroup's 64-query block: its live tiles [wjb, wjb + wn) and
  // its first dS tile in (b, h)'s part of the scratch
  int wjb0 = 0, wn0 = 0, wjb1 = 0, wn1 = 0;
  long long woff0 = 0, woff1 = 0;
  for (int ib = 0; ib < 2 * iq + 2; ++ib) {
    int bjb = 0;
    const int n = ib * kHQ < Sq ? h_block_tiles(mask, Sq, ib, &bjb) : 0;
    if (ib == 2 * iq) {
      wjb0 = bjb;
      wn0 = n;
      woff0 = woff1;
    } else if (ib == 2 * iq + 1) {
      wjb1 = bjb;
      wn1 = n;
      break;
    }
    woff1 += n;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHQSlots; ++s) {
      mbar_init(bar(s), 1);
      mbar_init(bar(kHQSlots + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  // thread 0 issues every copy, K by TMA and each live dS^T tile by a bulk
  // copy: step i into slot i % kHQSlots once every warp is done with it
  auto issue = [&](int i) {
    const int s = i % kHQSlots, jj = jb + i;
    const bool l0 = jj >= wjb0 && jj < wjb0 + wn0;
    const bool l1 = jj >= wjb1 && jj < wjb1 + wn1;
    mbar_expect_tx(bar(s), P::kK + (l0 + l1) * kHTile);
    const uint32_t st = sbase + s * P::kStage;
#pragma unroll
    for (int c = 0; c < R::kChunks; ++c)
      tma_load(st + c * kHStep * R::kOp, &kmap, c * R::kPer, jj * kHStep,
               hk, b, bar(s));
    if (l0)
      bulk_load(st + P::oSdS,
                dsbuf + (bh * nblk + woff0 + jj - wjb0) * kHTile, kHTile,
                bar(s));
    if (l1)
      bulk_load(st + P::oSdS + kHTile,
                dsbuf + (bh * nblk + woff1 + jj - wjb1) * kHTile, kHTile,
                bar(s));
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kHQSlots && i < n_steps; ++i) issue(i);

  // ---- warpgroup wg owns query rows q0 + 64wg .. + 63 ----
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int qw0 = q0 + 64 * wg;
  const int mjb = wg == 0 ? wjb0 : wjb1;
  const int mje = mjb + (wg == 0 ? wn0 : wn1);
  constexpr int kNA = D / 2;
  float acc[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kHQSlots, jj = jb + i;
    mbar_wait_or_trap(bar(s), (i / kHQSlots) & 1);
    if (jj >= mjb && jj < mje) {
      // dQ += dS.K over the step's 64 keys: dS^T (A) and K (B) both read
      // MN-major, 16 keys a wgmma
      const uint32_t aK = sbase + s * P::kStage;
      const uint32_t aS = aK + P::oSdS + wg * kHTile;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHStep / 16; ++kk)
        wgmma_bf16_sstt<D>(acc, gmma_desc_mn(aS + 16 * kk * 128, 128, 0),
                           gmma_desc_mn(aK + 16 * kk * R::kOp, R::kOp,
                                        kHStep * R::kOp));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kHQSlots + s));
    if (threadIdx.x == 0 && i + kHQSlots < n_steps) {
      mbar_wait_or_trap(bar(kHQSlots + s), (i / kHQSlots) & 1);
      issue(i + kHQSlots);
    }
  }

  // ---- epilogue: scale dQ, bfloat16; rows past Sq not written ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = qw0 + 16 * wl + g + 8 * hr;
    if (row >= Sq) continue;
    __nv_bfloat16* const dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqr + 8 * n + 2 * t) =
          pack_bf16(acc[4 * n + 2 * hr] * scale,
                    acc[4 * n + 2 * hr + 1] * scale);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, void* dvec, void* scratch,
                void* dq, void* dk, void* dv, const long long* st, int B,
                int H, int Hkv, int Sq, int Sk, double scale,
                const AttnMask& mask, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  using R = Rows16<D>;
  using PK = HKvPlan<D>;
  using PQ = HQPlan<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PK::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PQ::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // boxes: Q, dO of a dK/dV step; K, V of a dK/dV CTA, and K of a dQ step
  const CUtensorMapDataType t16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, dom, km, vm;
  int e = encode_rows(&qm, t16, 2, q, D, Sq, H, B, st, R::kPer, kHQ);
  if (e == 0) e = encode_rows(&dom, t16, 2, dout, D, Sq, H, B, st + 12, R::kPer, kHQ);
  if (e == 0) e = encode_rows(&km, t16, 2, k, D, Sk, Hkv, B, st + 3, R::kPer, kHKeys);
  if (e == 0) e = encode_rows(&vm, t16, 2, v, D, Sk, Hkv, B, st + 6, R::kPer, kHKeys);
  if (e != 0) return e;
  e = launch_dot<bf>(out, dout, dvec, st, B, H, Sq, D, stream);
  if (e != 0) return e;
  const long long nblk = h_scratch_tiles(mask, Sq);
  const int group = H / Hkv;
  const int nkv = (Sk + kHKeys - 1) / kHKeys;
  const int nqt = (Sq + kHRows - 1) / kHRows;
  if ((long long)nkv * Hkv * B > 0x7fffffffLL ||
      (long long)nqt * H * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  uint8_t* const ds = static_cast<uint8_t*>(scratch);
  attn_bwd_dkdv_bf16_kernel<D><<<nkv * Hkv * B, kThreads, PK::kBytes,
                                 stream>>>(
      qm, km, vm, dom, lse, static_cast<const float*>(dvec), ds, nblk,
      static_cast<bf*>(dk), strides_at(st, 6), static_cast<bf*>(dv),
      strides_at(st, 7), B, H, Hkv, group, Sq, (float)scale, mask);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  attn_bwd_dq_bf16_kernel<D><<<nqt * H * B, kConsumers, PQ::kBytes,
                               stream>>>(
      km, ds, nblk, static_cast<bf*>(dq), strides_at(st, 5), B, H, group, Sq,
      (float)scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with repro_torch/kernels/flash_attention.py:
//   0 float32, 1 float64, 3 bfloat16 (the backward takes no other).
// The bytes of the dS scratch that a call needs (float32 at D <= 128, the
// wgmma kernels; 0 for the FMA kernels), in *bytes.  Returns 0, or
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_scratch_bytes(int dtype, int B, int H,
                                                 int Sq, int Sk, int D,
                                                 int causal, int has_window,
                                                 int window, int q_offset,
                                                 long long* bytes) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      (dtype != 0 && dtype != 1 && dtype != 3))
    return (int)cudaErrorInvalidValue;
  const AttnMask mask{Sk, causal, has_window, window, q_offset};
  *bytes = dtype == 0 && D <= 128
               ? (long long)B * H * scratch_blocks(mask, Sq) * kBlock
           : dtype == 3 ? (long long)B * H * h_scratch_tiles(mask, Sq) * kHTile
                        : 0;
  return 0;
}

// strides: 24 element strides, (b, h, s) for q, k, v, out, dout, dq, dk and
// dv in that order (the last dim of each contiguous; float32 at D <= 128
// and bfloat16: q, k, v and dout bases and their b, h, s strides 16-byte
// aligned, TMA's rule); lse: contiguous (B, H, Sq) float, the forward's;
// dvec: a (B, H, Sq) scratch buffer of the compute type (float for
// bfloat16); scratch: the dS scratch of flash_attention_bwd_scratch_bytes
// (16-byte aligned; null where that is 0).  Launches three kernels (dot,
// dkdv, dq) on the stream: float32 at D 16..128 the 3xTF32 wgmma kernels,
// bfloat16 (D 16..160) the bfloat16 wgmma kernels, float32 at D 160 and
// float64 (D 16..128) the FMA kernels.  Returns the
// cudaError_t of the launches (0 = success), cudaErrorInvalidValue for
// arguments the kernels do not take, or 1000 + the CUresult when a tensor
// map cannot be encoded.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dvec, void* scratch, void* dq,
    void* dk, void* dv, const long long* strides, int B, int H, int Hkv,
    int Sq, int Sk, int D, double scale, int causal, int has_window,
    int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnMask mask{Sk, causal, has_window, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  if (dtype == 0 && D <= 128 || dtype == 3) {
    for (const void* p : {q, k, v, dout, (const void*)scratch})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (scratch == nullptr && (dtype == 0 ? scratch_blocks(mask, Sq)
                                          : h_scratch_tiles(mask, Sq)) > 0)
      return (int)cudaErrorInvalidValue;
  }
  switch (dtype * 1000 + D) {
#define FAB_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch_f32<DD>(q, k, v, out, dout, lf, dvec, scratch, dq, dk,    \
                          dv, strides, B, H, Hkv, Sq, Sk, scale, mask, st); \
  case 1000 + DD:                                                           \
    return launch_fma<double, DD>(q, k, v, out, dout, lf, dvec, dq, dk, dv, \
                                  strides, B, H, Hkv, Sq, Sk, scale, mask,  \
                                  st);
    FAB_CASE(16) FAB_CASE(32) FAB_CASE(64) FAB_CASE(128)
#undef FAB_CASE
    case 160:
      return launch_fma<float, 160>(q, k, v, out, dout, lf, dvec, dq, dk, dv,
                                    strides, B, H, Hkv, Sq, Sk, scale, mask,
                                    st);
#define BF_CASE(DD)                                                         \
  case 3000 + DD:                                                           \
    return launch_bf16<DD>(q, k, v, out, dout, lf, dvec, scratch, dq, dk,   \
                           dv, strides, B, H, Hkv, Sq, Sk, scale, mask, st);
    BF_CASE(16) BF_CASE(32) BF_CASE(64) BF_CASE(128) BF_CASE(160)
#undef BF_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
