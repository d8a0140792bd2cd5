// Flat cosine top-k scan of the semantic cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cosine_topk/kernel.py:cosine_topk_pallas
// (body _kernel + _topk_merge).  For queries q (B,D) and the bank db
// (N,D), both fp32 unit vectors, and a validity mask (N,), returns the k
// best scores q.db_n in descending order with their row indices.  Invalid
// rows never surface; ties go to the lowest index; slots with no valid row
// hold score -inf and index -1 (what ops.cosine_topk returns for the
// Pallas path).
//
// What bounds it on an H100: bytes.  At the main-path shape (B=8,
// N=262,144, D=384) the bank is 403 MB, read once: ~120 us at 3.35 TB/s,
// against 1.6 GFLOP of fp32 dot products (~24 us at 67 TFLOP/s).
//
// Design: the TPU kernel carried one running top-k down a sequential grid.
// Hopper blocks run in parallel, so the scan is split into chunks of rows:
//  * pass 1, one block per (chunk, group of 8 queries): the query group
//    sits in shared memory; each warp walks its own contiguous run of rows
//    in ascending order, one row per step, lanes reading 32 consecutive
//    floats at a time (coalesced), with a shuffle reduction per query.  Lane
//    0 keeps a sorted top-k per query (strict ">" on ascending rows keeps
//    the lowest index on ties), then the warps' lists are merged in shared
//    memory with an explicit (score desc, index asc) order and written out
//    as the chunk's partial top-k.
//  * pass 2, one warp per query, merges the chunks' partial lists.
// The bank is read exactly once; the partial lists are a few hundred KB.

#include <math_constants.h>

#include "common.cuh"
#include "topk.cuh"

namespace repro_torch {
namespace {

constexpr int kQB = 8;     // queries per pass-1 block
constexpr int kWarps = 8;  // warps per pass-1 block

__global__ void __launch_bounds__(kWarps * 32)
cosine_topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
                           const unsigned char* __restrict__ valid, int batch, int n, int d,
                           int k, int chunk, float* __restrict__ part_s,
                           int* __restrict__ part_i) {
  extern __shared__ float sq[];  // kQB * d
  __shared__ float ws[kWarps][kQB][kMaxK];
  __shared__ int wi[kWarps][kQB][kMaxK];

  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, batch - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kQB * d; i += blockDim.x) {
    const int qq = i / d;
    sq[i] = qq < nq ? q[(size_t)(q0 + qq) * d + (i % d)] : 0.f;
  }
  __syncthreads();

  float ts[kQB][kMaxK];
  int ti[kQB][kMaxK];
  for (int qq = 0; qq < kQB; ++qq)
    for (int j = 0; j < kMaxK; ++j) {
      ts[qq][j] = -CUDART_INF_F;
      ti[qq][j] = -1;
    }

  const int c0 = blockIdx.x * chunk;
  const int c1 = min(n, c0 + chunk);
  const int per_warp = (chunk + kWarps - 1) / kWarps;
  const int r0 = c0 + warp * per_warp;
  const int r1 = min(c1, r0 + per_warp);
  const int ne = d / 32;
  for (int row = r0; row < r1; ++row) {
    if (!valid[row]) continue;  // warp-uniform
    const float* x = db + (size_t)row * d;
    float part[kQB];
#pragma unroll
    for (int qq = 0; qq < kQB; ++qq) part[qq] = 0.f;
    for (int e = 0; e < ne; ++e) {
      const int col = lane + 32 * e;
      const float xv = x[col];
#pragma unroll
      for (int qq = 0; qq < kQB; ++qq) part[qq] += xv * sq[qq * d + col];
    }
#pragma unroll
    for (int qq = 0; qq < kQB; ++qq) part[qq] = warp_sum(part[qq]);
    if (lane == 0) {
      for (int qq = 0; qq < nq; ++qq) insert_sorted(ts[qq], ti[qq], k, part[qq], row);
    }
  }

  if (lane == 0) {
    for (int qq = 0; qq < kQB; ++qq)
      for (int j = 0; j < kMaxK; ++j) {
        ws[warp][qq][j] = ts[qq][j];
        wi[warp][qq][j] = ti[qq][j];
      }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nq) {
    const int qq = threadIdx.x;
    float ms[kMaxK];
    int mi[kMaxK];
    for (int j = 0; j < kMaxK; ++j) {
      ms[j] = -CUDART_INF_F;
      mi[j] = -1;
    }
    for (int w = 0; w < kWarps; ++w)
      for (int j = 0; j < k; ++j) insert_sorted(ms, mi, k, ws[w][qq][j], wi[w][qq][j]);
    const size_t base = ((size_t)blockIdx.x * batch + q0 + qq) * k;
    for (int j = 0; j < k; ++j) {
      part_s[base + j] = ms[j];
      part_i[base + j] = mi[j];
    }
  }
}

__global__ void cosine_topk_merge_kernel(const float* __restrict__ part_s,
                                         const int* __restrict__ part_i, int batch, int k,
                                         int nchunks, float* __restrict__ out_s,
                                         int* __restrict__ out_i) {
  __shared__ float ls[32][kMaxK];
  __shared__ int li[32][kMaxK];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float ts[kMaxK];
  int ti[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ts[j] = -CUDART_INF_F;
    ti[j] = -1;
  }
  for (int c = lane; c < nchunks * k; c += 32) {
    const int chunk = c / k;
    const int j = c % k;
    const size_t off = ((size_t)chunk * batch + b) * k + j;
    insert_sorted(ts, ti, k, part_s[off], part_i[off]);
  }
  for (int j = 0; j < kMaxK; ++j) {
    ls[lane][j] = ts[j];
    li[lane][j] = ti[j];
  }
  __syncwarp();
  if (lane == 0) {
    float ms[kMaxK];
    int mi[kMaxK];
    for (int j = 0; j < kMaxK; ++j) {
      ms[j] = -CUDART_INF_F;
      mi[j] = -1;
    }
    for (int w = 0; w < 32; ++w)
      for (int j = 0; j < k; ++j) insert_sorted(ms, mi, k, ls[w][j], li[w][j]);
    for (int j = 0; j < k; ++j) {
      out_s[(size_t)b * k + j] = ms[j];
      out_i[(size_t)b * k + j] = mi[j];
    }
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,D), db (N,D) fp32 contiguous; valid (N,) one byte per row;
// part_s/part_i (nchunks*B*k,) scratch; out_s (B,k) fp32, out_i (B,k) int32.
// Requires 1 <= k <= 8 and D % 32 == 0.  Returns cudaGetLastError().
extern "C" int cosine_topk_launch(const void* q, const void* db, const void* valid,
                                  void* part_s, void* part_i, void* out_s, void* out_i,
                                  int batch, int n, int d, int k, int chunk, void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || d % 32 != 0 || chunk < 1 || batch < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (n + chunk - 1) / chunk;
  dim3 grid(nchunks, (batch + kQB - 1) / kQB);
  const size_t smem = sizeof(float) * kQB * d;
  cosine_topk_partial_kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(db),
      static_cast<const unsigned char*>(valid), batch, n, d, k, chunk,
      static_cast<float*>(part_s), static_cast<int*>(part_i));
  cosine_topk_merge_kernel<<<batch, 32, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), batch, k, nchunks,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
