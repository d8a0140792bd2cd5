// The running top-k of the port's cosine scans: a short list per thread,
// kept sorted by (score desc, index asc).
#pragma once

namespace repro_torch {

constexpr int kMaxK = 8;

// (s, i) ranks before (s2, i2): higher score, then lower index; an empty
// slot (index -1) ranks after any real entry of the same score.
__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i >= 0 && (i2 < 0 || i < i2));
}

__device__ __forceinline__ void insert_sorted(float* ts, int* ti, int k, float s, int i) {
  if (!better(s, i, ts[k - 1], ti[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(s, i, ts[j - 1], ti[j - 1])) {
    ts[j] = ts[j - 1];
    ti[j] = ti[j - 1];
    --j;
  }
  ts[j] = s;
  ti[j] = i;
}

}  // namespace repro_torch
