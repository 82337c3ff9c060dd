// The attention masks shared by the flash attention kernels
// (flash_attention.cu, forward; flash_attention_bwd.cu, backward): the same
// rules as repro/kernels/flash_attention.py::_flash_kernel.
//
// Query row i has the absolute position qpos = i + q_offset; it may see key
// j when j < Sk, and (causal) j <= qpos, and (window w) j > qpos - w.  A
// tile of keys [k_lo, k_hi] is live for the query rows of absolute positions
// [q_lo, q_hi] when some pair may see each other by the tile test below
// (the element mask then decides each pair).
#pragma once

struct AttnMask {
  int Sk, causal, has_window, window, q_offset;

  __host__ __device__ __forceinline__ bool allowed(int qpos, int kpos) const {
    bool ok = kpos < Sk;
    if (causal) ok = ok && kpos <= qpos;
    if (has_window) ok = ok && kpos > qpos - window;
    return ok;
  }

  // some key of [k_lo, k_hi] is live for some query of [q_lo, q_hi]
  __host__ __device__ __forceinline__ bool tile_live(int q_lo, int q_hi,
                                                     int k_lo, int k_hi) const {
    return k_lo < Sk && (!causal || k_lo <= q_hi) &&
           (!has_window || k_hi > q_lo - window);
  }

  // every pair of the two ranges is allowed: no element mask is needed
  __host__ __device__ __forceinline__ bool tile_full(int q_lo, int q_hi,
                                                     int k_lo, int k_hi) const {
    return k_hi < Sk && (!causal || k_hi <= q_lo) &&
           (!has_window || k_lo > q_hi - window);
  }

  // the live kv tiles of bk keys for the queries [q_lo, q_hi], a contiguous
  // range [*begin, *end) (empty when *end <= *begin)
  __host__ __device__ __forceinline__ void kv_tiles(int q_lo, int q_hi, int bk,
                                                    int* begin, int* end) const {
    int e = (Sk + bk - 1) / bk;
    if (causal) {
      const int c = q_hi < 0 ? 0 : q_hi / bk + 1;
      if (c < e) e = c;
    }
    int b = 0;
    if (has_window) {
      const int x = q_lo - window - (bk - 1);
      b = x < 0 ? 0 : x / bk + 1;
    }
    *begin = b;
    *end = e;
  }
};
