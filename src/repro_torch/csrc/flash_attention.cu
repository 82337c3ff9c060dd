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
// q (B,H,Sq,D), k and v (B,Hkv,Sk,D) are read by TMA through 4-D tensor
// maps over (D, S, H, B) built from their strides, so the (B,S,H,D)
// projections are read through their transposed (B,H,S,D) views without a
// copy; bases and the b, h, s strides must be 16-byte aligned and the last
// dim contiguous (the wrapper checks).  out (B,H,Sq,D) is written through
// its strides.  T is float, double, half or bfloat16; all arithmetic is
// float (a double input is computed in float, as the JAX reference does),
// the output is stored as T.  D is a template parameter: 16, 32, 64, 128 or
// 160 (stablelm-12b's head dim; not for double, whose tiles at D 160 do not
// fit a CTA's shared memory).
// The plain PyTorch version is repro_torch/kernels/ref.py::attention_ref.
// Given a non-null lse, the kernel also writes each query row's log-sum-exp
// of its scaled scores, lse[b,h,i] = log(sum_j exp(scale q.k_j)) (float,
// contiguous (B,H,Sq)): what the backward kernels of flash_attention_bwd.cu
// recompute the probabilities from.  The serving path passes null.  The
// masks are those of attention_mask.cuh, shared with the backward.
//
// Numerics follow _flash_kernel: per query row a running maximum m, sum l
// and accumulator in float; a kv tile that no row of the query tile may see
// is skipped by the same test (k_lo < Sk, causal k_lo <= q_hi, window
// k_hi > q_lo - w); -inf maxima are clamped to 0 before exponentiating, and
// l is floored at 1e-30.  The exponentials are exp2 of scores scaled by
// scale * log2(e), which is exp of the scaled score up to float rounding.
//
// Bound on the H100: operations.  Causal prefill at the LM's shape (B 8,
// H 16, S 1024, D 128) does 4*B*H*D*(S*(S+1)/2) = 34.4 GFLOP against
// ~200 MB moved.  Both products run on the tensor cores with wgmma in
// 3xTF32, so the result keeps float32 accuracy: each float operand x is
// split into hi = x with its low 13 mantissa bits dropped (what the tensor
// core reads of a float as TF32) and lo = x - hi (exact in float); per step
// of 8 along the reduction the two small products hi_a.lo_b and lo_a.hi_b
// go into one accumulator and hi_a.hi_b into another, which are added at
// the end, small sum first.  The tensor core reads lo as TF32 too, an error
// below 2^-21 |x|.  Plain TF32 (hi.hi alone) misses the float32 tolerance
// on a 1024-key row.  So the least time is 3 x flops over the 495 TFLOP/s
// of TF32: 0.208 ms at that shape (the float32-FMA bound is 0.513 ms).
// half and bfloat16 values are exact in TF32: their lo is zero, so Q.K^T
// takes one product and P.V two (the probabilities are float and split).
//
// Design.  One CTA of 384 threads per (128 query rows, head, batch): two
// consumer warpgroups of 64 query rows each, and a producer warpgroup that
// gives 128 of its registers a thread to them (setmaxnreg 40 / 232).
// Lane 0 of the producer's first warp issues every copy as TMA: Q once,
// then the live K and V tiles of kBK keys (32; 16 for double, whose tiles
// are twice the bytes, and for float at D 160) into a ring of two slots.  The producer's other
// three warps write, per tile, the operands TMA cannot: K_lo beside K_hi
// in the slot (another T than float: K_hi and K_lo from the raw tile) and
// V transposed, hi and lo (D rows x kBK keys), since TF32 wgmma takes both
// operands K-major only and V's rows are D-contiguous.  Four mbarriers per
// slot order the roles: full (TMA's bytes landed), conv (the converters'
// writes are done), K free and Vt free (every consumer warp is done with
// them).  Tiles land in TMA's 128-byte swizzle (64 or 32 bytes where a row
// is that short), which is the canonical K-major layout of wgmma's shared
// memory operands: a float K tile is the hi operand of Q.K^T as it lands,
// and a float Q tile is loaded straight into its operand buffer.  Per tile
// a consumer warpgroup computes S (64 x kBK) = Q.K^T, per step of 8 along
// D, with one wgmma.m64n(2 kBK)k8 of Q_hi against [K_hi; K_lo] (both from
// shared memory) and one m64n(kBK)k8 of Q_lo, from registers, against K_hi
// into the hi.lo half; runs the online softmax on the accumulator
// fragments (a row lives on the 4 lanes of a quad: row max and sum are
// quad shuffles); then O (64 x D) += P.V with wgmma.m64nDk8, P from
// registers: the accumulator holds P[g][2t] and P[g][2t+1] of each 8-key
// block, which is the TF32 A fragment once the keys of the block are taken
// in the order 0,2,4,6,1,3,5,7, so Vt is written in that order.  P.V is
// waited for at once and the slot's Vt given back, so the converters fill
// it for the tile after next while the consumers work on the next one.  A
// warpgroup skips the products of a tile none of its rows may see, and
// only tiles that the causal diagonal, the window edge or Sk crosses pay
// for the element mask.  Causal grids start with the last query tiles,
// which see the most keys, so the tail of the grid is the light tiles.
//
// Shared memory (bytes, D 128):  float: Q_hi 65536 + 2 slots x (K hi/lo
// 32768 + raw V 16384 + Vt hi/lo 32768) = 229376;  half and bfloat16: Q_hi
// 65536 + 2 x (K hi 16384 + raw K 8192 + raw V 8192 + Vt hi 16384) =
// 163840;  double: Q_hi 65536 + 2 x (K hi/lo 16384 + raw K 16384 + raw V
// 16384 + Vt hi/lo 16384) = 196608; each plus 1 KB of alignment slack and
// the barriers.  Q_lo stays in registers (D/2 a thread), as do S and O.
//
// D 160.  Float at 32 keys a tile would need Q_hi 81920 + 2 x (40960 +
// 20480 + 40960) = 286720 bytes, over the 232448 a CTA may have, and
// 32 + 16 + 16 registers of S beside O's and Q_lo's 80 each; so float takes
// 16 keys a tile there: Q_hi 81920 + 2 x (K hi/lo 20480 + raw V 10240 + Vt
// hi/lo 20480) = 184320, and S's registers halve, which keeps a consumer
// thread's count at D 128's.  Q.K^T then reduces over 20 steps of 8 with
// m64n32k8 (Q_hi against [K_hi; K_lo]) and m64n16k8 (Q_lo against K_hi),
// and P.V is m64n160k8 over the tile's 2 steps.  half and bfloat16 keep 32
// keys (Q_hi 81920 + 2 x (K hi 20480 + raw K 10240 + raw V 10240 + Vt hi
// 20480) = 204800); their 320-byte rows are no multiple of 128, so their
// raw tiles land in TMA's 64-byte swizzle, chunks of 32 elements.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_mask.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kRowsWG = 64;          // query rows per consumer warpgroup
constexpr int kWG = 2;               // consumer warpgroups
constexpr int kBQ = kRowsWG * kWG;   // query rows per CTA
constexpr int kConsumers = 128 * kWG;
// + a producer warpgroup: its warp 0 issues the copies, warps 1-3 convert;
// a whole warpgroup, so that its setmaxnreg.dec frees the registers the
// consumers take
constexpr int kConverters = 96;
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // inputs with a non-zero lo part (half and bfloat16 are exact in TF32)
  static constexpr bool kSplit = kF32 || std::is_same<T, double>::value;
};

// Shared-memory plan.  Raw tiles (as TMA lands them) are rows of kRaw
// bytes in chunks of kRawElems elements along D; float operands are rows of
// kOp bytes (K-major along D), or of kVtRow bytes (Vt, K-major along keys).
template <typename T, int D>
struct Plan {
  using C = Cfg<T>;
  // keys per kv tile: 16 for double, whose raw tiles are twice the bytes,
  // and for float at D 160 (see the note above)
  static constexpr int kBK = sizeof(T) == 8 || (C::kF32 && D > 128) ? 16 : 32;
  // raw rows: the whole row up to 128 bytes, else 128-byte chunks, or
  // 64-byte ones where 128 does not divide the row (16-bit at D 160)
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kRaw = kRowBytes <= 128 ? kRowBytes
                              : kRowBytes % 128 == 0 ? 128 : 64;
  static constexpr int kRawElems = kRaw / (int)sizeof(T);
  static constexpr int kChunks = D / kRawElems;
  static_assert(kChunks * kRawElems == D, "raw chunks tile a row");
  static constexpr int kOp = D * 4 < 128 ? D * 4 : 128;
  static constexpr int kTile = kBK * D * (int)sizeof(T);   // raw K or V tile
  static constexpr int kQh = kBQ * D * 4;
  // K as the B operand of Q.K^T: per chunk of kOp/4 along D, the kBK rows
  // of K_hi and then (split inputs) the kBK rows of K_lo, so that one
  // 2kBK-row operand gives Q_hi.K_hi and Q_hi.K_lo in one wgmma
  static constexpr int kKlo = kBK * kOp;                    // hi -> lo rows
  static constexpr int kKpitch = (C::kSplit ? 2 : 1) * kBK * kOp;
  static constexpr int kKop = (D * 4 / kOp) * kKpitch;
  // V transposed: D rows of kBK keys, hi [and lo]
  static constexpr int kVtRow = kBK * 4;
  static constexpr int kVt = D * kVtRow;
  // a ring slot: the K operand (float: TMA lands K_hi in it), raw K
  // (another T), raw V, Vt
  static constexpr int oSRawK = kKop;
  static constexpr int oSV = oSRawK + (C::kF32 ? 0 : kTile);
  static constexpr int oSVt = oSV + kTile;
  static constexpr int kStage = oSVt + kVt * (C::kSplit ? 2 : 1);
  static_assert(C::kF32 || kRowsWG * D * (int)sizeof(T) <= kStage,
                "a slot holds a warpgroup's raw Q rows");
  static constexpr int oQh = 0;
  static constexpr int oRing = oQh + kQh;
  static constexpr int oBar = oRing + 2 * kStage;
  static constexpr int kBytes = oBar + 16 * 8 + 1024;       // + align slack
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(double v) { return (float)v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// element (row, col) of a raw tile of `rows` rows
template <typename T, int D>
__device__ __forceinline__ float raw_at(const uint8_t* tile, int rows, int row,
                                        int col) {
  using P = Plan<T, D>;
  const uint32_t off = (col / P::kRawElems) * rows * P::kRaw +
                       swz(row, (col % P::kRawElems) * sizeof(T), P::kRaw);
  return to_f(*reinterpret_cast<const T*>(tile + off));
}

// barriers (8 bytes each): Q (float), then one per ring slot of each kind
constexpr int kBarQ = 0;
constexpr int kBarFull = 1;     // TMA bytes of the slot landed
constexpr int kBarConv = 3;     // converters wrote K_lo (K_hi) and Vt
constexpr int kBarKFree = 5;    // consumers are done with K and raw V
constexpr int kBarVtFree = 7;   // consumers are done with Vt

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(__grid_constant__ const CUtensorMap qmap,
                       __grid_constant__ const CUtensorMap kmap,
                       __grid_constant__ const CUtensorMap vmap,
                       T* __restrict__ out, Strides os,
                       float* __restrict__ lse, int group, int Sq, int Sk,
                       float scale_log2, int causal, int has_window,
                       int window, int q_offset) {
  using C = Cfg<T>;
  using P = Plan<T, D>;
  constexpr int kBK = P::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + P::oBar;
  auto bar = [&](int i) { return bars + 8 * i; };

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kBQ;
  // the CTA's live kv tiles [j_begin, j_begin + n_tiles), by _flash_kernel's
  // test (a contiguous range); rows past Sq see nothing
  const AttnMask mask{Sk, causal, has_window, window, q_offset};
  int j_begin, j_end;
  mask.kv_tiles(q0 + q_offset, min(q0 + kBQ, Sq) - 1 + q_offset, kBK, &j_begin,
                &j_end);
  const int n_tiles = max(0, j_end - j_begin);
  // Tile i lives in ring slot i & 1.  Another T than float first stages
  // warpgroup w's raw Q rows in slot w: the full and K-free barriers then
  // complete once more before tile i's use, (i >> 1) + kQOff.
  constexpr int kQOff = C::kF32 ? 0 : 1;

  if (threadIdx.x == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(kBarFull + s), 1);
      mbar_init(bar(kBarConv + s), kConverters / 32);
      mbar_init(bar(kBarKFree + s), kConsumers / 32);
      mbar_init(bar(kBarVtFree + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index through a shuffle: the compiler then knows it (and all
  // that derives from it) is uniform across the warp, so the wgmma under
  // a warpgroup's branches is not serialized
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * kWG) {
    // ---- producer warpgroup ----
    // 384 threads start with 168 registers each; this warpgroup gives 128
    // of its back (setmaxnreg.inc draws only on what .dec freed)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (n_tiles == 0) return;
    if (warp == 4 * kWG) {
      // warp 0, lane 0: every TMA copy
      if (lane != 0) return;
      if constexpr (C::kF32) {
        mbar_expect_tx(bar(kBarQ), P::kQh);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          tma_load(sbase + P::oQh + c * kBQ * P::kOp, &qmap, c * P::kRawElems,
                   q0, h, b, bar(kBarQ));
      } else {
        for (int w = 0; w < kWG; ++w) {
          mbar_expect_tx(bar(kBarFull + w), kRowsWG * D * (int)sizeof(T));
#pragma unroll
          for (int c = 0; c < P::kChunks; ++c)
            tma_load(sbase + P::oRing + w * P::kStage + c * kRowsWG * P::kRaw,
                     &qmap, c * P::kRawElems, q0 + kRowsWG * w, h, b,
                     bar(kBarFull + w));
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1, n = (i >> 1) + kQOff;
        if (n >= 1) mbar_wait(bar(kBarKFree + s), (n - 1) & 1);
        mbar_expect_tx(bar(kBarFull + s), 2 * P::kTile);
        const int k_lo = (j_begin + i) * kBK;
        const uint32_t st = sbase + P::oRing + s * P::kStage;
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load(st + (C::kF32 ? c * P::kKpitch : P::oSRawK + c * kBK * P::kRaw),
                   &kmap, c * P::kRawElems, k_lo, hk, b, bar(kBarFull + s));
          tma_load(st + P::oSV + c * kBK * P::kRaw, &vmap, c * P::kRawElems,
                   k_lo, hk, b, bar(kBarFull + s));
        }
      }
      return;
    }
    // warps 1-3: the operands each tile needs beyond what TMA lands, in
    // wgmma's layout: K_lo beside K_hi (another T: K_hi and K_lo from raw
    // K), and V transposed, hi and lo
    const int vtid = threadIdx.x - kConsumers - 32;   // 0 .. kConverters-1
    if constexpr (!C::kF32) {
      // a later parity wait on a slot must not find its Q phase still open
      mbar_wait(bar(kBarFull), 0);
      mbar_wait(bar(kBarFull + 1), 0);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1;
      mbar_wait(bar(kBarFull + s), ((i >> 1) + kQOff) & 1);
      if (i >= 2) mbar_wait(bar(kBarVtFree + s), ((i >> 1) - 1) & 1);
      uint8_t* const stage = smem + P::oRing + s * P::kStage;
      if constexpr (C::kF32) {
        constexpr int kPer = kBK * P::kOp / 16;      // float4s in a chunk
        for (int e = vtid; e < kBK * D / 4; e += kConverters) {
          uint8_t* const hi = stage + (e / kPer) * P::kKpitch + (e % kPer) * 16;
          const float4 x = *reinterpret_cast<const float4*>(hi);
          *reinterpret_cast<float4*>(hi + P::kKlo) =
              make_float4(x.x - tf32_hi(x.x), x.y - tf32_hi(x.y),
                          x.z - tf32_hi(x.z), x.w - tf32_hi(x.w));
        }
      } else {
        const uint8_t* kraw = stage + P::oSRawK;
        for (int e = vtid; e < kBK * D / 4; e += kConverters) {
          const int row = e / (D / 4), col = (e % (D / 4)) * 4;
          float4 hv, lv;
          float* hp = &hv.x;
          float* lp = &lv.x;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float x = raw_at<T, D>(kraw, kBK, row, col + c);
            hp[c] = tf32_hi(x);
            lp[c] = x - hp[c];
          }
          constexpr int per = P::kOp / 4;
          const uint32_t off = (col / per) * P::kKpitch +
                               swz(row, (col % per) * 4, P::kOp);
          *reinterpret_cast<float4*>(stage + off) = hv;
          if constexpr (C::kSplit)
            *reinterpret_cast<float4*>(stage + off + P::kKlo) = lv;
        }
      }
      // Vt: a thread takes one row d and the 4 key positions 4u .. 4u+3 (one
      // 16-byte unit), which hold keys 8(u/2) + (u&1) + 0, 2, 4, 6: P.V
      // takes the keys of each 8-block in the order 0,2,4,6,1,3,5,7.  A warp
      // spans 32 rows d, so the raw reads and the 16-byte writes hit
      // distinct banks.
      const uint8_t* vraw = stage + P::oSV;
      uint8_t* const vt = stage + P::oSVt;
      for (int e = vtid; e < D * kBK / 4; e += kConverters) {
        const int d = e % D, u = e / D;
        const int key0 = 8 * (u >> 1) + (u & 1);
        float4 hv, lv;
        float* hp = &hv.x;
        float* lp = &lv.x;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = raw_at<T, D>(vraw, kBK, key0 + 2 * c, d);
          hp[c] = tf32_hi(x);
          lp[c] = x - hp[c];
        }
        const uint32_t off = swz(d, 16 * u, P::kVtRow);
        *reinterpret_cast<float4*>(vt + off) = hv;
        if constexpr (C::kSplit)
          *reinterpret_cast<float4*>(vt + P::kVt + off) = lv;
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kBarConv + s));
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64w .. q0 + 64w + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + kRowsWG * w + 16 * wl + g;  // and row_a + 8
  const int wq_lo = q0 + kRowsWG * w + q_offset;
  const int wq_hi = min(q0 + kRowsWG * (w + 1), Sq) - 1 + q_offset;
  const bool has_rows = q0 + kRowsWG * w < Sq;

  constexpr int kNO = D / 2;                         // O registers a thread
  float o[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qlo[C::kSplit ? D / 8 : 1][4];

  if (n_tiles > 0) {
    // Q: hi in shared memory (operand layout), lo in registers as A fragments
    const int qr = kRowsWG * w + 16 * wl + g;        // row within the CTA
    if constexpr (C::kF32) {
      mbar_wait(bar(kBarQ), 0);
      const uint8_t* qh = smem + P::oQh;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        // the A fragment: rows (g, g+8) x columns (t, t+4) of the step
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qlo[ks][i] = tf32_lo(*reinterpret_cast<const float*>(
              qh + op_off(kBQ, qr + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1),
                          P::kOp)));
      }
    } else {
      // a later parity wait on a slot must not find its Q phase still open
      mbar_wait(bar(kBarFull), 0);
      mbar_wait(bar(kBarFull + 1), 0);
      const uint8_t* raw = smem + P::oRing + w * P::kStage;
      for (int i = threadIdx.x % 128; i < kRowsWG * D / 4; i += 128) {
        const int row = i / (D / 4), col = (i % (D / 4)) * 4;
        float4 hv;
        float* hp = &hv.x;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hp[e] = tf32_hi(raw_at<T, D>(raw, kRowsWG, row, col + e));
        *reinterpret_cast<float4*>(
            smem + P::oQh + op_off(kBQ, kRowsWG * w + row, col, P::kOp)) = hv;
      }
      if constexpr (C::kSplit) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qlo[ks][i] = tf32_lo(raw_at<T, D>(raw, kRowsWG,
                                              16 * wl + g + 8 * (i & 1),
                                              8 * ks + t + 4 * (i >> 1)));
        }
      }
      fence_proxy_async();
      named_barrier(1 + w, 128);
      if (lane == 0) {
        mbar_arrive(bar(kBarKFree));
        mbar_arrive(bar(kBarKFree + 1));
      }
    }
  }

  // Per kv tile i (slot s = i & 1): wait for the converters; Q.K^T; release
  // K and raw V; online softmax; P.V; release Vt.  The two warpgroups do
  // not wait for each other.
  // sacc: columns 0..kBK-1 Q_hi.K_hi; kBK..2kBK-1 Q_hi.K_lo + Q_lo.K_hi
  // (split inputs; 16-bit ones use the first half alone)
  float sacc[kBK], sc[kBK / 2];
  uint32_t pl[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    sc[i] = 0.f;
    pl[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < kBK; ++i) sacc[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const int k_lo = (j_begin + i) * kBK, k_hi = k_lo + kBK - 1;
    const uint32_t stage = sbase + P::oRing + s * P::kStage;
    mbar_wait(bar(kBarConv + s), (i >> 1) & 1);

    const bool live = has_rows && mask.tile_live(wq_lo, wq_hi, k_lo, k_hi);
    if (live) {
      // S = Q.K^T, per step of 8 along D: Q_hi.[K_hi; K_lo] in one wgmma,
      // then Q_lo.K_hi into its hi.lo half; the two small terms are summed
      // before the large one is added, below
      const uint32_t qh = sbase + P::oQh + kRowsWG * w * P::kOp;
      float (&shi)[kBK / 2] = *reinterpret_cast<float (*)[kBK / 2]>(&sacc[0]);
      float (&slo)[kBK / 2] = *reinterpret_cast<float (*)[kBK / 2]>(&sacc[kBK / 2]);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        constexpr int per = P::kOp / 4;
        const uint32_t kc = (8 * ks / per) * P::kKpitch + (8 * ks % per) * 4;
        const uint32_t qc = (8 * ks / per) * kBQ * P::kOp + (8 * ks % per) * 4;
        const uint64_t dk = gmma_desc(stage + kc, P::kOp);
        const uint64_t dq = gmma_desc(qh + qc, P::kOp);
        if constexpr (C::kSplit) {
          wgmma_ss<2 * kBK>(sacc, dq, dk, ks > 0);
          wgmma_rs<kBK>(slo, qlo[ks], dk, 1);
        } else {
          wgmma_ss<kBK>(shi, dq, dk, ks > 0);
        }
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kBarKFree + s));

    if (live) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        if constexpr (C::kSplit) sc[j] = sacc[kBK / 2 + j] + sacc[j];
        else sc[j] = sacc[j];
      }
      // online softmax on the accumulator fragments: sc[4n + 2hr + e] is
      // row g + 8hr, key k_lo + 8n + 2t + e
      const bool full = mask.tile_full(wq_lo, wq_hi, k_lo, k_hi);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = row_a + 8 * hr + q_offset;
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sc[4 * n + 2 * hr + e] * scale_log2;
            if (!full && !mask.allowed(qpos, k_lo + 8 * n + 2 * t + e))
              v = -INFINITY;
            sc[4 * n + 2 * hr + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float corr = isfinite(m[hr]) ? exp2f(m[hr] - m_safe) : 0.f;
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * n + 2 * hr + e;
            const float p = exp2f(sc[j] - m_safe);
            sc[j] = p;
            pl[j] = tf32_lo(p);
            psum += p;
          }
        l[hr] = l[hr] * corr + psum;   // this lane's part; summed at the end
        m[hr] = m_new;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 2 * hr] *= corr;
          o[4 * n + 2 * hr + 1] *= corr;
        }
      }


      // O += P.V: per 8-key step, P_lo.V_hi + P_hi.V_lo + P_hi.V_hi, with
      // A k-columns (t, t+4) = keys (2t, 2t+1) of the step.  P_hi is p
      // itself: the tensor core reads it as TF32, dropping the bits in lo.
      const uint32_t vth = stage + P::oSVt, vtl = vth + P::kVt;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const uint32_t ah[4] = {__float_as_uint(sc[4 * n]),
                                __float_as_uint(sc[4 * n + 2]),
                                __float_as_uint(sc[4 * n + 1]),
                                __float_as_uint(sc[4 * n + 3])};
        const uint32_t al[4] = {pl[4 * n], pl[4 * n + 2], pl[4 * n + 1],
                                pl[4 * n + 3]};
        const uint64_t dvh = gmma_desc(vth + 32 * n, P::kVtRow);
        wgmma_rs<D>(o, al, dvh, 1);
        if constexpr (C::kSplit)
          wgmma_rs<D>(o, ah, gmma_desc(vtl + 32 * n, P::kVtRow), 1);
        wgmma_rs<D>(o, ah, dvh, 1);
      }
      wgmma_commit();
    }
    // P.V is waited for at once, so that the converters get the slot's Vt
    // back a whole tile before they need it; the other warpgroup keeps the
    // tensor cores busy meanwhile
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kBarVtFree + s));
  }

  // ---- epilogue: O / l, rows past Sq not written; with lse, the row's
  // log-sum-exp of the scaled scores (natural log) ----
  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row_a + 8 * hr;
    if (row >= Sq) continue;
    const float li = fmaxf(lt, 1e-30f);
    if (lse != nullptr && t == 0) {
      const float ms = isfinite(m[hr]) ? m[hr] : 0.f;
      lse[((int64_t)b * gridDim.y + h) * Sq + row] =
          (ms + log2f(li)) * 0.6931471805599453f;
    }
    T* orow = ob + row * os.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      orow[8 * n + 2 * t] = store_as<T>(o[4 * n + 2 * hr] / li);
      orow[8 * n + 2 * t + 1] = store_as<T>(o[4 * n + 2 * hr + 1] / li);
    }
  }
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> constexpr CUtensorMapDataType tma_type<double>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT64; }
template <> constexpr CUtensorMapDataType tma_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }

// A map over a (B, heads, S, D) view with element strides st = (b, h, s);
// boxes of one raw chunk x `rows` rows of one head (wgmma_tf32.cuh)
template <typename T, int D>
int encode(CUtensorMap* map, const void* base, int S, int heads, int B,
           const long long* st, int rows) {
  return encode_rows(map, tma_type<T>(), (int)sizeof(T), base, D, S, heads,
                     B, st, Plan<T, D>::kRawElems, rows);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const long long* st, int B, int H, int Hkv, int Sq, int Sk,
           float scale, int causal, int has_window, int window, int q_offset,
           cudaStream_t stream) {
  using C = Cfg<T>;
  using P = Plan<T, D>;
  // above 48 KB a kernel must opt in to dynamic shared memory (once each)
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap qm, km, vm;
  int e = encode<T, D>(&qm, q, Sq, H, B, st, C::kF32 ? kBQ : kRowsWG);
  if (e == 0) e = encode<T, D>(&km, k, Sk, Hkv, B, st + 3, P::kBK);
  if (e == 0) e = encode<T, D>(&vm, v, Sk, Hkv, B, st + 6, P::kBK);
  if (e != 0) return e;
  const Strides os{st[9], st[10], st[11]};
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, P::kBytes, stream>>>(
      qm, km, vm, static_cast<T*>(out), os, lse, H / Hkv, Sq, Sk,
      scale * kLog2e,
      causal, has_window, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             float* lse, const long long* st, int B, int H, int Hkv, int Sq, int Sk,
             float scale, int causal, int has_window, int window, int q_offset,
             cudaStream_t stream) {
  switch (D) {
#define FA_CASE(DD)                                                         \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, out, lse, st, B, H, Hkv, Sq, Sk, scale,   \
                         causal, has_window, window, q_offset, stream);
    FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(128)
#undef FA_CASE
    case 160:
      if constexpr (sizeof(T) == 8) return (int)cudaErrorInvalidValue;
      else
        return launch<T, 160>(q, k, v, out, lse, st, B, H, Hkv, Sq, Sk, scale,
                              causal, has_window, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with repro_torch/kernels/flash_attention.py:
//   0 float32, 1 float64, 2 float16, 3 bfloat16.
// lse: null, or a contiguous (B, H, Sq) float buffer for each query row's
// log-sum-exp of its scaled scores (what the backward kernels recompute the
// probabilities from; a row that sees no key gets log(1e-30)).
// strides: 12 element strides, (b, h, s) for q, k, v and out in that order;
// the last dim of each is contiguous, and q, k, v bases and strides are
// 16-byte aligned (TMA's rule).  Returns the cudaError_t of the launch
// (0 = success), cudaErrorInvalidValue for arguments the kernel does not
// take, or 1000 + the CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const long long* strides, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int has_window,
                                      int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(i == 0 ? q : i == 1 ? k : v) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, out, lse_f, strides, B, H, Hkv, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 1: return launch_d<double>(D, q, k, v, out, lse_f, strides, B, H, Hkv, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 2: return launch_d<__half>(D, q, k, v, out, lse_f, strides, B, H, Hkv, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    case 3: return launch_d<__nv_bfloat16>(D, q, k, v, out, lse_f, strides, B, H, Hkv, Sq, Sk, scale, causal, has_window, window, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
