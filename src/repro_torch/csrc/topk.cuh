// The running top-k of the port's cosine scans: a short list per thread,
// kept sorted by (score desc, index asc).
#pragma once

#include <math_constants.h>

namespace repro_torch {

constexpr int kMaxK = 8;

// (s, i) ranks before (s2, i2): higher score, then lower index; an empty
// slot (index -1) ranks after any real entry of the same score.
__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i >= 0 && (i2 < 0 || i < i2));
}

// Insert (s, i) into a sorted list of compile-time length K held in
// registers: the entry takes the last slot and bubbles up, every index known
// at compile time.
template <int K>
__device__ __forceinline__ void insert_sorted_reg(float (&ts)[K], int (&ti)[K], float s, int i) {
  if (!better(s, i, ts[K - 1], ti[K - 1])) return;
  ts[K - 1] = s;
  ti[K - 1] = i;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (better(ts[j], ti[j], ts[j - 1], ti[j - 1])) {
      const float s2 = ts[j];
      const int i2 = ti[j];
      ts[j] = ts[j - 1];
      ti[j] = ti[j - 1];
      ts[j - 1] = s2;
      ti[j - 1] = i2;
    }
  }
}

// The warp's best K of its lanes' sorted lists, in K rounds of a shuffle
// argmax on (score, index) with `better` (lanes break exact ties, which only
// empty slots have): each round's winner is popped from its lane's list.
// The lists are consumed; every lane gets the result in (out_s, out_i).
template <int K>
__device__ __forceinline__ void warp_topk_merge(float (&ts)[K], int (&ti)[K], float (&out_s)[K],
                                                int (&out_i)[K]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bs = ts[0];
    int bi = ti[0], bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (better(os, oi, bs, bi) || (!better(bs, bi, os, oi) && ol < bl)) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    out_s[r] = bs;
    out_i[r] = bi;
    if (lane == bl) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        ts[j] = ts[j + 1];
        ti[j] = ti[j + 1];
      }
      ts[K - 1] = -CUDART_INF_F;
      ti[K - 1] = -1;
    }
  }
}

}  // namespace repro_torch
