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
// bfloat16 at D 16 to 160: mma.sync m16n8k16 on the tensor cores, the
// bfloat16 kernels near the end of this file (P and dS rounded to bfloat16
// as operands, every sum in float32).  The simple FMA kernels take the rest
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
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ===========================================================================
//
// bfloat16 q, k, v, dout are read as they are (16-byte vector loads into
// shared memory, rows padded by 8 elements so that each ldmatrix phase
// meets 8 distinct 16-byte bank groups) and multiplied on the tensor cores
// with mma.sync.m16n8k16 (bfloat16 operands, float32 accumulators), the
// flash recurrence of the float32 kernels: S = Q.K^T, dP = dO.V^T in
// float32; P = exp(S scale - lse) and dS = P (dP - D) in float32, rounded
// to bfloat16 only where they are the A operand of the next product (dV +=
// P^T.dO, dK += dS^T.Q, dQ += dS.K), as FlashAttention does; every sum in
// float32, dq, dk, dv rounded to bfloat16 once.  Bound on the H100:
// operations over the bfloat16 tensor-core rate, five products (0.0869 ms
// at qwen3's B 8, H 16/8, S 1024, D 128, causal); this design does seven
// (the dQ kernel recomputes S and dP, so there is no dS scratch and no
// atomic); each CTA's next tile is copied by cp.async into a second stage
// while the current one is computed.
//
//   dkdv kernel  one CTA of 4 warps per (64 keys, kv head, batch); warp w
//                owns keys 16w .. 16w + 15 and keeps their dK and dV (D/2
//                floats a thread each) in registers over its GQA group's
//                32-query tiles (16 at D 160) in a fixed order: S^T =
//                K.Q^T and dP^T = V.dO^T (A = K or V rows by ldmatrix, B =
//                Q or dO rows),
//                then P^T and dS^T in the accumulators' registers become
//                the A fragments of dV += P^T.dO and dK += dS^T.Q (B by
//                ldmatrix.trans).
//   dq kernel    one CTA of 4 warps per (64 queries, head, batch); warp w
//                owns queries 16w .. 16w + 15, walks the live 32-key tiles:
//                S = Q.K^T, dP = dO.V^T, dS as A fragments of dQ += dS.K.
//
// Shared memory (bytes): dkdv K and V (64 rows each of D + 8) and two
// stages of Q, dO (32 rows each; 16 at D 160), lse and D, 70,144 at D 128
// and 64,768 at D 160; dq Q and dO (64 rows each) and two stages of K and V
// (32 rows each), 69,632 at D 128 and 86,016 at D 160.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeys = 64;       // keys per dK/dV CTA (16 a warp)
// queries per dK/dV step: 16 at D 160, where dK and dV take 80 floats a
// thread each
__host__ __device__ constexpr int mma_qtile(int D) {
  return D > 128 ? 16 : 32;
}
constexpr int kMmaQRows = 64;      // queries per dQ CTA (16 a warp)
constexpr int kMmaKTile = 32;      // keys per dQ step

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b, a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an asynchronous copy of `bytes` (0 or N) bytes into N bytes of shared
// memory, the rest zero-filled
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest `N` has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) of one head (row stride s, D contiguous, 16-byte
// aligned) into a shared tile of R rows of LDS elements (at address dst),
// by asynchronous copies; rows past S zeros
template <int D, int R, int LDS>
__device__ __forceinline__ void load_rows_bf16(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               long long s, int r0, int S) {
  constexpr int kVec = D / 8;    // 16-byte vectors a row
  for (int e = threadIdx.x; e < R * kVec; e += kMmaThreads) {
    const int r = e / kVec, c = e % kVec;
    const int row = r0 + r;
    cp_async<16>(dst + 2 * (r * LDS + 8 * c),
                 row < S ? src + (long long)row * s + 8 * c : src,
                 row < S ? 16 : 0);
  }
}

// The lane's ldmatrix row address of a 16 x 16 block at (r0, c0) of a
// row-major tile of LDS elements: the A fragment (rows r0..r0+15 by
// lane % 16, columns c0 or c0 + 8 by lane / 16), or, ``b`` set, two B
// fragments of 8 rows each (rows by lane % 8 and lane / 16, columns by
// (lane / 8) % 2); ``trans`` takes rows by lane % 16 and columns by lane /
// 16 for ldmatrix.trans
template <int LDS>
__device__ __forceinline__ uint32_t frag_addr(uint32_t base, int r0, int c0,
                                              bool b) {
  const int l = threadIdx.x % 32;
  const int r = b ? r0 + l % 8 + 8 * (l / 16) : r0 + l % 16;
  const int c = b ? c0 + 8 * ((l / 8) % 2) : c0 + 8 * (l / 16);
  return base + 2 * (r * LDS + c);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, Strides3 qs,
                         const __nv_bfloat16* __restrict__ k, Strides3 ks,
                         const __nv_bfloat16* __restrict__ v, Strides3 vs,
                         const __nv_bfloat16* __restrict__ dout, Strides3 dos,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         __nv_bfloat16* __restrict__ dk, Strides3 dks,
                         __nv_bfloat16* __restrict__ dv, Strides3 dvs, int H,
                         int group, int Sq, float scale, AttnMask mask) {
  constexpr int LDS = D + 8, BQ = mma_qtile(D), NT = D / 8;
  // a stage: Q and dO of one query tile, then its lse and D rows
  constexpr int kStage = 2 * BQ * LDS * 2 + 2 * BQ * 4;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t aK = smem_addr(smem_mma), aV = aK + kMmaKeys * LDS * 2;
  const uint32_t aS0 = aV + kMmaKeys * LDS * 2;
  const float* const rows0 =
      reinterpret_cast<const float*>(smem_mma + 2 * kMmaKeys * LDS * 2 +
                                     2 * BQ * LDS * 2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kMmaKeys, k_hi = k0 + kMmaKeys - 1;
  const float scale_log2 = scale * kLog2e;
  const int nq = (Sq + BQ - 1) / BQ;
  // the next live query tile after (gi, it), group heads outermost
  auto next_tile = [&](int& gi, int& it) {
    while (true) {
      if (++it == nq) {
        it = 0;
        if (++gi == group) return false;
      }
      const int q0 = it * BQ;
      if (mask.tile_live(q0 + mask.q_offset,
                         min(q0 + BQ, Sq) - 1 + mask.q_offset, k0, k_hi))
        return true;
    }
  };
  // a tile's Q, dO, lse and D rows into stage st (rows past Sq zeros)
  auto issue = [&](int st, int gi, int it) {
    const int h = hk * group + gi, q0 = it * BQ;
    const long long bh = (long long)b * H + h;
    const uint32_t aQ = aS0 + st * kStage, adO = aQ + BQ * LDS * 2;
    load_rows_bf16<D, BQ, LDS>(aQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
    load_rows_bf16<D, BQ, LDS>(adO, dout + b * dos.b + h * dos.h, dos.s, q0,
                               Sq);
    for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
      const bool in = q0 + r < Sq;
      const uint32_t dst = adO + BQ * LDS * 2 + 4 * r;
      cp_async<4>(dst, lse + (in ? bh * Sq + q0 + r : 0), in ? 4 : 0);
      cp_async<4>(dst + 4 * BQ, dvec + (in ? bh * Sq + q0 + r : 0),
                  in ? 4 : 0);
    }
  };
  load_rows_bf16<D, kMmaKeys, LDS>(aK, k + b * ks.b + hk * ks.h, ks.s, k0,
                                   mask.Sk);
  load_rows_bf16<D, kMmaKeys, LDS>(aV, v + b * vs.b + hk * vs.h, vs.s, k0,
                                   mask.Sk);
  int gi = 0, it = -1;
  bool have = next_tile(gi, it);
  if (have) issue(0, gi, it);
  cp_async_commit();

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;
  const int kw = 16 * warp;          // the warp's keys in the tile
  for (int n_tile = 0; have; ++n_tile) {
    // the next live tile's copies go out while this one is computed
    int g2 = gi, i2 = it;
    const bool more = next_tile(g2, i2);
    if (more) issue((n_tile + 1) & 1, g2, i2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = n_tile & 1, q0 = it * BQ;
    const uint32_t aQ = aS0 + st * kStage, adO = aQ + BQ * LDS * 2;
    const float* sL = rows0 + st * (kStage / 4);
    const float* sDv = sL + BQ;
    // S^T = K.Q^T and dP^T = V.dO^T: keys kw.. x the tile's BQ queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(frag_addr<LDS>(aK, kw, 16 * kk, false), ak);
      ldsm_x4(frag_addr<LDS>(aV, kw, 16 * kk, false), av);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(frag_addr<LDS>(aQ, 16 * np, 16 * kk, true), bq);
        ldsm_x4(frag_addr<LDS>(adO, 16 * np, 16 * kk, true), bo);
        mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * np], av, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T (rows: keys k0 + kw + g (+8); columns: queries q0 + 8n +
    // 2t (+1)), as the A fragments of the next two products
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + kw + g + 8 * (i / 2);
        const int ql = 8 * n + 2 * t + i % 2, qi = q0 + ql;
        const bool ok = qi < Sq && mask.allowed(qi + mask.q_offset, key);
        pv[i] = ok ? exp2f(fmaf(s[n][i], scale_log2, -sL[ql] * kLog2e))
                   : 0.f;
        dsv[i] = pv[i] * (dp[n][i] - sDv[ql]);
      }
      pa[n / 2][2 * (n % 2)] = pack_bf16(pv[0], pv[1]);
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(pv[2], pv[3]);
      da[n / 2][2 * (n % 2)] = pack_bf16(dsv[0], dsv[1]);
      da[n / 2][2 * (n % 2) + 1] = pack_bf16(dsv[2], dsv[3]);
    }
    // dV += P^T.dO, dK += dS^T.Q: k = the tile's queries, n = D
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq)
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(frag_addr<LDS>(adO, 16 * kq, 16 * n2, false), bo);
        ldsm_x4_t(frag_addr<LDS>(aQ, 16 * kq, 16 * n2, false), bq);
        mma_bf16(acc_v[2 * n2], pa[kq], bo[0], bo[1]);
        mma_bf16(acc_v[2 * n2 + 1], pa[kq], bo[2], bo[3]);
        mma_bf16(acc_k[2 * n2], da[kq], bq[0], bq[1]);
        mma_bf16(acc_k[2 * n2 + 1], da[kq], bq[2], bq[3]);
      }
    __syncthreads();   // this stage is refilled two tiles on
    gi = g2;
    it = i2;
    have = more;
  }
  cp_async_wait<0>();
  // epilogue: keys past Sk not written
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + kw + g + 8 * hr;
    if (key >= mask.Sk) continue;
    __nv_bfloat16* dkr = dk + b * dks.b + hk * dks.h + key * dks.s;
    __nv_bfloat16* dvr = dv + b * dvs.b + hk * dvs.h + key * dvs.s;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * n + 2 * t) =
          pack_bf16(acc_k[n][2 * hr] * scale, acc_k[n][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * n + 2 * t) =
          pack_bf16(acc_v[n][2 * hr], acc_v[n][2 * hr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, Strides3 qs,
                       const __nv_bfloat16* __restrict__ k, Strides3 ks,
                       const __nv_bfloat16* __restrict__ v, Strides3 vs,
                       const __nv_bfloat16* __restrict__ dout, Strides3 dos,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dq, Strides3 dqs, int H,
                       int group, int Sq, float scale, AttnMask mask) {
  constexpr int LDS = D + 8, BK = kMmaKTile, NT = D / 8;
  // a stage: K and V of one key tile
  constexpr int kStage = 2 * BK * LDS * 2;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t aQ = smem_addr(smem_mma), adO = aQ + kMmaQRows * LDS * 2;
  const uint32_t aS0 = adO + kMmaQRows * LDS * 2;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long bh = (long long)b * H + h;
  const int q0 = blockIdx.x * kMmaQRows, qw = 16 * warp;
  const float scale_log2 = scale * kLog2e;
  int j_begin, j_end;
  mask.kv_tiles(q0 + mask.q_offset,
                min(q0 + kMmaQRows, Sq) - 1 + mask.q_offset, BK, &j_begin,
                &j_end);
  auto issue = [&](int st, int jt) {
    const uint32_t aK = aS0 + st * kStage, aV = aK + BK * LDS * 2;
    load_rows_bf16<D, BK, LDS>(aK, k + b * ks.b + hk * ks.h, ks.s, jt * BK,
                               mask.Sk);
    load_rows_bf16<D, BK, LDS>(aV, v + b * vs.b + hk * vs.h, vs.s, jt * BK,
                               mask.Sk);
  };
  load_rows_bf16<D, kMmaQRows, LDS>(aQ, q + b * qs.b + h * qs.h, qs.s, q0,
                                    Sq);
  load_rows_bf16<D, kMmaQRows, LDS>(adO, dout + b * dos.b + h * dos.h, dos.s,
                                    q0, Sq);
  if (j_begin < j_end) issue(0, j_begin);
  cp_async_commit();
  // this thread's rows q0 + qw + g (+8): lse (log2 units) and D
  float rl[2], rd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + qw + g + 8 * hr;
    rl[hr] = i < Sq ? lse[bh * Sq + i] * kLog2e : 0.f;
    rd[hr] = i < Sq ? dvec[bh * Sq + i] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  for (int jt = j_begin; jt < j_end; ++jt) {
    // the next tile's copies go out while this one is computed
    if (jt + 1 < j_end) issue((jt + 1 - j_begin) & 1, jt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kt0 = jt * BK;
    const uint32_t aK = aS0 + ((jt - j_begin) & 1) * kStage,
                   aV = aK + BK * LDS * 2;
    // S = Q.K^T and dP = dO.V^T: the warp's 16 queries x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(frag_addr<LDS>(aQ, qw, 16 * kk, false), aq);
      ldsm_x4(frag_addr<LDS>(adO, qw, 16 * kk, false), ao);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(frag_addr<LDS>(aK, 16 * np, 16 * kk, true), bk);
        ldsm_x4(frag_addr<LDS>(aV, 16 * np, 16 * kk, true), bv);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS (rows: queries; columns: keys kt0 + 8n + 2t (+1)) as A fragments
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + qw + g + 8 * (i / 2);
        const int key = kt0 + 8 * n + 2 * t + i % 2;
        const bool ok = qi < Sq && mask.allowed(qi + mask.q_offset, key);
        const float p =
            ok ? exp2f(fmaf(s[n][i], scale_log2, -rl[i / 2])) : 0.f;
        dsv[i] = p * (dp[n][i] - rd[i / 2]);
      }
      da[n / 2][2 * (n % 2)] = pack_bf16(dsv[0], dsv[1]);
      da[n / 2][2 * (n % 2) + 1] = pack_bf16(dsv[2], dsv[3]);
    }
    // dQ += dS.K: k = the tile's keys, n = D
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq)
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bk[4];
        ldsm_x4_t(frag_addr<LDS>(aK, 16 * kq, 16 * n2, false), bk);
        mma_bf16(acc[2 * n2], da[kq], bk[0], bk[1]);
        mma_bf16(acc[2 * n2 + 1], da[kq], bk[2], bk[3]);
      }
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + qw + g + 8 * hr;
    if (row >= Sq) continue;
    __nv_bfloat16* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dqr + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * hr] * scale, acc[n][2 * hr + 1] * scale);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, void* dvec, void* dq,
               void* dk, void* dv, const long long* st, int B, int H, int Hkv,
               int Sq, int Sk, double scale, const AttnMask& mask,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int LDS = D + 8;
  // K and V, then two stages of Q, dO, lse and D rows; Q and dO, then two
  // stages of K and V
  constexpr int BQ = mma_qtile(D);
  constexpr int kDkdv =
      2 * kMmaKeys * LDS * 2 + 2 * (2 * BQ * LDS * 2 + 2 * BQ * 4);
  constexpr int kDq = (2 * kMmaQRows + 4 * kMmaKTile) * LDS * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdv);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDq);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // 16-byte row loads: bases and row strides of q, k, v, dout aligned
  for (int i : {0, 1, 2, 4})
    if (st[3 * i] % 8 || st[3 * i + 1] % 8 || st[3 * i + 2] % 8)
      return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const float* dvt = static_cast<const float*>(dvec);
  int e = launch_dot<bf>(out, dout, dvec, st, B, H, Sq, D, stream);
  if (e != 0) return e;
  const int group = H / Hkv;
  dim3 gkv((Sk + kMmaKeys - 1) / kMmaKeys, Hkv, B);
  attn_bwd_dkdv_mma_kernel<D><<<gkv, kMmaThreads, kDkdv, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<bf*>(dk), strides_at(st, 6),
      static_cast<bf*>(dv), strides_at(st, 7), H, group, Sq, (float)scale,
      mask);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  dim3 gq((Sq + kMmaQRows - 1) / kMmaQRows, H, B);
  attn_bwd_dq_mma_kernel<D><<<gq, kMmaThreads, kDq, stream>>>(
      qt, strides_at(st, 0), kt, strides_at(st, 1), vt, strides_at(st, 2), dot,
      strides_at(st, 4), lse, dvt, static_cast<bf*>(dq), strides_at(st, 5), H,
      group, Sq, (float)scale, mask);
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
               : 0;
  return 0;
}

// strides: 24 element strides, (b, h, s) for q, k, v, out, dout, dq, dk and
// dv in that order (the last dim of each contiguous; float32 at D <= 128: q,
// k, v and dout bases and their b, h, s strides 16-byte aligned, TMA's
// rule); lse: contiguous (B, H, Sq) float, the forward's; dvec: a (B, H, Sq)
// scratch buffer of the compute type (float for bfloat16); scratch: the dS
// scratch of flash_attention_bwd_scratch_bytes (16-byte aligned; null where
// that is 0).  Launches three kernels (dot, dkdv, dq) on the stream:
// float32 at D 16..128 the wgmma kernels, bfloat16 (D 16..160) the mma.sync
// kernels (q, k, v, dout bases and row strides 16-byte aligned), float32 at
// D 160 and float64 (D 16..128) the FMA kernels.  Returns the
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
  if (dtype == 0 && D <= 128) {
    for (const void* p : {q, k, v, dout, (const void*)scratch})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (scratch == nullptr && scratch_blocks(mask, Sq) > 0)
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
    return launch_mma<DD>(q, k, v, out, dout, lf, dvec, dq, dk, dv,         \
                          strides, B, H, Hkv, Sq, Sk, scale, mask, st);
    BF_CASE(16) BF_CASE(32) BF_CASE(64) BF_CASE(128) BF_CASE(160)
#undef BF_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
