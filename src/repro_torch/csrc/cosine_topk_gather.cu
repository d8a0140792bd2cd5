// Shortlist cosine top-k of the IVF probe, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cosine_topk/kernel.py:cosine_topk_gather_pallas
// (body _gather_kernel + _topk_merge), and the (B, M, D) gather that
// ops.cosine_topk_gather runs in XLA before it.  For queries q (B,D) and the
// bank db (N,D), both fp32 unit vectors, and per query a list of M candidate
// bank rows cand_idx (B,M) with a mask cand_valid (B,M), returns the k best
// scores q_b . db[cand_idx[b,p]] over the live candidates (cand_valid and
// cand_idx >= 0) in descending order, with their bank rows.  Ties go to the
// lowest candidate POSITION p (what lax.top_k and the strict ">" merge of
// the TPU kernel keep), a row listed twice is reported twice, and slots with
// no live candidate hold score -inf and row -1.
//
// What bounds it on an H100: bytes.  Each live candidate row is read once
// (D * 4 bytes) plus the (B,M) index and mask: at B 8, M 2,048 (nprobe 8 x
// bucket 256), D 384 and about half the candidates live, ~12.6 MB, ~3.8 us
// at 3.35 TB/s, against 12.6 MFLOP of fp32 dot products (~0.2 us).
//
// Design: the gather is fused into index-driven loads; the (B,M,D)
// shortlist never exists in device memory, and dead candidates are skipped
// unread.  The TPU kernel carried one running top-k down a sequential grid;
// here the positions split into chunks scored in parallel:
//  * pass 1, one block per (chunk of positions, query): the query sits in
//    shared memory; each warp walks its own run of positions in ascending
//    order, kRows candidate rows in flight at a time, lanes reading 16
//    bytes each (float4, coalesced along the row), one shuffle reduction per
//    row.  Lane 0 keeps a sorted (score desc, position asc) top-k; the
//    block's warps merge in shared memory and write the chunk's partial
//    top-k of (score, position).
//  * pass 2, one warp per query, merges the chunks' partial lists in the
//    same order and maps positions to bank rows.
// Blocks: ceil(M / chunk) x B, 256 at the main-path shape with chunks of 64.

#include <math_constants.h>

#include "common.cuh"
#include "topk.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;  // warps per pass-1 block
constexpr int kRows = 4;   // candidate rows a warp has in flight

__global__ void __launch_bounds__(kWarps * 32)
gather_partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
                      const int* __restrict__ cand_idx,
                      const unsigned char* __restrict__ cand_valid, int n, int m, int d,
                      int k, int chunk, float* __restrict__ part_s,
                      int* __restrict__ part_p) {
  extern __shared__ float4 sq[];  // d / 4
  __shared__ float ws[kWarps][kMaxK];
  __shared__ int wp[kWarps][kMaxK];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d4 = d / 4;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * d);
  for (int i = threadIdx.x; i < d4; i += blockDim.x) sq[i] = q4[i];
  __syncthreads();

  float ts[kMaxK];
  int tp[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ts[j] = -CUDART_INF_F;
    tp[j] = -1;
  }

  const int* idx_b = cand_idx + (size_t)b * m;
  const unsigned char* valid_b = cand_valid + (size_t)b * m;
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(m, c0 + chunk);
  const int per_warp = (chunk + kWarps - 1) / kWarps;
  const int r0 = c0 + warp * per_warp;
  const int r1 = min(c1, r0 + per_warp);
  for (int p0 = r0; p0 < r1; p0 += kRows) {
    // every lane reads the same entries (one broadcast load), so liveness
    // is warp-uniform; a dead candidate's row is never read
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r;
      int ix = -1;
      if (p < r1 && valid_b[p]) ix = idx_b[p];
      row[r] = (ix >= 0 && ix < n) ? ix : -1;
    }
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    for (int e = lane; e < d4; e += 32) {
      const float4 qv = sq[e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row[r] < 0) continue;
        const float4 x = __ldg(reinterpret_cast<const float4*>(db + (size_t)row[r] * d) + e);
        part[r] += x.x * qv.x + x.y * qv.y + x.z * qv.z + x.w * qv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = warp_sum(part[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (row[r] >= 0) insert_sorted(ts, tp, k, part[r], p0 + r);
    }
  }

  if (lane == 0) {
    for (int j = 0; j < kMaxK; ++j) {
      ws[warp][j] = ts[j];
      wp[warp][j] = tp[j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ms[kMaxK];
    int mp[kMaxK];
    for (int j = 0; j < kMaxK; ++j) {
      ms[j] = -CUDART_INF_F;
      mp[j] = -1;
    }
    for (int w = 0; w < kWarps; ++w)
      for (int j = 0; j < k; ++j) insert_sorted(ms, mp, k, ws[w][j], wp[w][j]);
    const size_t base = ((size_t)b * gridDim.x + blockIdx.x) * k;
    for (int j = 0; j < k; ++j) {
      part_s[base + j] = ms[j];
      part_p[base + j] = mp[j];
    }
  }
}

__global__ void gather_merge_kernel(const float* __restrict__ part_s,
                                    const int* __restrict__ part_p,
                                    const int* __restrict__ cand_idx, int m, int k,
                                    int nchunks, float* __restrict__ out_s,
                                    int* __restrict__ out_i) {
  __shared__ float ls[32][kMaxK];
  __shared__ int lp[32][kMaxK];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float ts[kMaxK];
  int tp[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ts[j] = -CUDART_INF_F;
    tp[j] = -1;
  }
  const size_t base = (size_t)b * nchunks * k;
  for (int c = lane; c < nchunks * k; c += 32)
    insert_sorted(ts, tp, k, part_s[base + c], part_p[base + c]);
  for (int j = 0; j < kMaxK; ++j) {
    ls[lane][j] = ts[j];
    lp[lane][j] = tp[j];
  }
  __syncwarp();
  if (lane == 0) {
    float ms[kMaxK];
    int mp[kMaxK];
    for (int j = 0; j < kMaxK; ++j) {
      ms[j] = -CUDART_INF_F;
      mp[j] = -1;
    }
    for (int w = 0; w < 32; ++w)
      for (int j = 0; j < k; ++j) insert_sorted(ms, mp, k, ls[w][j], lp[w][j]);
    for (int j = 0; j < k; ++j) {
      const bool hit = mp[j] >= 0;
      out_s[(size_t)b * k + j] = hit ? ms[j] : -CUDART_INF_F;
      out_i[(size_t)b * k + j] = hit ? cand_idx[(size_t)b * m + mp[j]] : -1;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,D), db (N,D) fp32 contiguous and 16-byte aligned; cand_idx (B,M)
// int32; cand_valid (B,M) one byte per entry; part_s/part_p (B*nchunks*k,)
// scratch with nchunks = ceil(M / chunk); out_s (B,k) fp32, out_i (B,k)
// int32.  Candidates with an index outside [0, N) count as dead.  Requires
// 1 <= k <= 8 and D % 4 == 0.  Returns cudaGetLastError().
extern "C" int cosine_topk_gather_launch(const void* q, const void* db, const void* cand_idx,
                                         const void* cand_valid, void* part_s, void* part_p,
                                         void* out_s, void* out_i, int batch, int n, int m,
                                         int d, int k, int chunk, void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || d % 4 != 0 || d < 4 || chunk < 1 || batch < 1 || m < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (m + chunk - 1) / chunk;
  dim3 grid(nchunks, batch);
  const size_t smem = sizeof(float) * d;
  gather_partial_kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(db),
      static_cast<const int*>(cand_idx), static_cast<const unsigned char*>(cand_valid), n, m,
      d, k, chunk, static_cast<float*>(part_s), static_cast<int*>(part_p));
  gather_merge_kernel<<<batch, 32, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_p),
      static_cast<const int*>(cand_idx), m, k, nchunks, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
