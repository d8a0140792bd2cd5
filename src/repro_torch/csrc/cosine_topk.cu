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
// against 1.6 GFLOP of fp32 dot products (~24 us at 67 TFLOP/s on the CUDA
// cores; TF32 tensor cores would break both the 1e-5 contract and the
// exact-tie rule).  What it takes is enough bytes in flight, and no serial
// chain per row (a shuffle reduction, one lane inserting) between them.
//
// Design: the TPU kernel carried one running top-k down a sequential grid.
// Hopper blocks run in parallel, so the scan is split into chunks of
// `chunk` rows (block_n), one block per (chunk, group of 8 queries):
//  * bytes in flight: the block streams its rows through a four-stage ring
//    in shared memory (three stages in flight while one is read), one stage
//    = 128 rows x 32 floats (a column slice of each row), filled with
//    cp.async of 16 bytes a thread, 8 threads per 128-byte row slice (with
//    a 256-byte L2 prefetch hint); invalid rows are not copied.  The row
//    stride is padded by 4 floats so that the float4 reads of 8 neighbouring
//    rows hit distinct banks.  Two blocks fit on an SM.
//  * no per-row shuffles: each row has two threads, each of which sums the
//    row against 4 of the 8 queries (read from shared memory as broadcasts)
//    over d ascending, so a row's score does not depend on where the row
//    lands, and keeps its own sorted top-k per query in registers (the
//    kernel is templated on k; 4 queries a thread keep a k = 8 list out of
//    local memory).
//  * at the end of the block each query's 128 lists are merged by k rounds
//    of a warp-shuffle argmax on (score, index), then across the 4 warps
//    that hold the query, and the block writes its partial list.
//  * pass 2, one block of 256 threads per query, merges the chunks' partial
//    lists the same way: each thread keeps the top-k of its share (four
//    loads in flight), then k shuffle rounds per warp and across warps.
// The bank is read once; the partial lists are a few hundred KB.

#include <math_constants.h>

#include "common.cuh"
#include "topk.cuh"

namespace repro_torch {
namespace {

constexpr int kQB = 8;                   // queries per block
constexpr int kQT = 4;                   // queries per thread
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerStage = kScanThreads * kQT / kQB;   // 128: each row has 2 threads
constexpr int kSliceF = 32;              // floats of a row per stage
constexpr int kStrideF = kSliceF + 4;    // padded row stride in shared memory
constexpr int kStages = 4;
constexpr int kStageF = kRowsPerStage * kStrideF;
static_assert(kScanWarps == kQB, "the cross-warp merge gives one warp per query");

// 16 bytes global -> shared, bypassing L1; L2 fetches the surrounding 256
// bytes, so the row's next slice is already there when its stage comes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}

template <int K>
__global__ void __launch_bounds__(kScanThreads, K <= 4 ? 2 : 1)
cosine_topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
                           const unsigned char* __restrict__ valid, int batch, int n, int d,
                           int chunk, float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                       // kQB * d
  float* ring = smem + kQB * d;           // kStages * kStageF
  __shared__ float ws[kScanWarps][kQT][K];
  __shared__ int wi[kScanWarps][kQT][K];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = tid / kRowsPerStage;   // warp-uniform: queries half*4 .. half*4+3
  const int my = tid % kRowsPerStage;     // this thread's row within a stage
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, batch - q0);
  for (int i = tid; i < kQB * d; i += kScanThreads) {
    const int qq = i / d;
    sq[i] = qq < nq ? q[(size_t)(q0 + qq) * d + (i % d)] : 0.f;
  }

  const int c0 = blockIdx.x * chunk;
  const int c1 = min(n, c0 + chunk);
  const int slices = d / kSliceF;
  const int nsteps = ((c1 - c0 + kRowsPerStage - 1) / kRowsPerStage) * slices;
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  // step s: rows c0 + (s / slices) * 128 .. +127, floats (s % slices) * 32 .. +31
  auto fetch = [&](int s) {
    const int r0 = c0 + (s / slices) * kRowsPerStage;
    const int f0 = (s % slices) * kSliceF;
    const uint32_t dst0 = ring_u32 + (s % kStages) * kStageF * 4;
#pragma unroll
    for (int j = 0; j < kRowsPerStage * kSliceF / 4 / kScanThreads; ++j) {
      const int c = tid + j * kScanThreads;     // 8 float4 per row slice
      const int row = c / (kSliceF / 4), f4 = c % (kSliceF / 4);
      const int gr = r0 + row;
      if (gr < c1 && valid[gr])
        cp_async16(dst0 + (row * kStrideF + f4 * 4) * 4, db + (size_t)gr * d + f0 + f4 * 4);
    }
  };

  float ts[kQT][K];
  int ti[kQT][K];
#pragma unroll
  for (int qq = 0; qq < kQT; ++qq)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ts[qq][j] = -CUDART_INF_F;
      ti[qq][j] = -1;
    }
  float acc[kQT];
#pragma unroll
  for (int qq = 0; qq < kQT; ++qq) acc[qq] = 0.f;

  // a ring of kStages stages, kStages - 1 of them in flight ahead of the one read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) fetch(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  bool mine = false;
  for (int s = 0; s < nsteps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();   // stage s landed for every thread; stage s - 1 is free
    if (s + kStages - 1 < nsteps) fetch(s + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int slice = s % slices;
    const int row = c0 + (s / slices) * kRowsPerStage + my;
    if (slice == 0) mine = row < c1 && valid[row];
    if (mine) {
      const float4* x4 = reinterpret_cast<const float4*>(ring + (s % kStages) * kStageF +
                                                         my * kStrideF);
      const float4* q4 = reinterpret_cast<const float4*>(sq + half * kQT * d + slice * kSliceF);
#pragma unroll
      for (int f4 = 0; f4 < kSliceF / 4; ++f4) {
        const float4 x = x4[f4];
#pragma unroll
        for (int qq = 0; qq < kQT; ++qq) {
          const float4 w = q4[qq * (d / 4) + f4];
          float a = acc[qq];
          a = fmaf(x.x, w.x, a);
          a = fmaf(x.y, w.y, a);
          a = fmaf(x.z, w.z, a);
          a = fmaf(x.w, w.w, a);
          acc[qq] = a;
        }
      }
      if (slice == slices - 1) {
#pragma unroll
        for (int qq = 0; qq < kQT; ++qq) {
          if (half * kQT + qq < nq) insert_sorted_reg<K>(ts[qq], ti[qq], acc[qq], row);
          acc[qq] = 0.f;
        }
      }
    }
  }

  // the block's top-k per query: within each warp, then across the 4 warps
  // that hold the query
#pragma unroll
  for (int qq = 0; qq < kQT; ++qq) {
    float os[K];
    int oi[K];
    warp_topk_merge<K>(ts[qq], ti[qq], os, oi);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        ws[warp][qq][j] = os[j];
        wi[warp][qq][j] = oi[j];
      }
    }
  }
  __syncthreads();
  const int qq = warp;                                   // one warp per query
  const int w0 = (qq / kQT) * (kRowsPerStage / 32);      // first warp of its half
  float ms[K];
  int mi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = lane < kRowsPerStage / 32;
    ms[j] = in ? ws[w0 + lane][qq % kQT][j] : -CUDART_INF_F;
    mi[j] = in ? wi[w0 + lane][qq % kQT][j] : -1;
  }
  float os[K];
  int oi[K];
  warp_topk_merge<K>(ms, mi, os, oi);
  if (lane == 0 && qq < nq) {
    const size_t base = ((size_t)blockIdx.x * batch + q0 + qq) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_s[base + j] = os[j];
      part_i[base + j] = oi[j];
    }
  }
}

constexpr int kMergeThreads = 256;

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
cosine_topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                         int batch, int nchunks, float* __restrict__ out_s,
                         int* __restrict__ out_i) {
  __shared__ float ws[kMergeThreads / 32][K];
  __shared__ int wi[kMergeThreads / 32][K];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float ts[K];
  int ti[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ts[j] = -CUDART_INF_F;
    ti[j] = -1;
  }
  const int total = nchunks * K;
  for (int c0 = tid; c0 < total; c0 += 4 * kMergeThreads) {
    float s4[4];
    int i4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {    // four loads in flight before the inserts
      const int c = c0 + u * kMergeThreads;
      const size_t off = ((size_t)(c / K) * batch + b) * K + c % K;
      s4[u] = c < total ? part_s[off] : -CUDART_INF_F;
      i4[u] = c < total ? part_i[off] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) insert_sorted_reg<K>(ts, ti, s4[u], i4[u]);
  }
  float os[K];
  int oi[K];
  warp_topk_merge<K>(ts, ti, os, oi);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ws[warp][j] = os[j];
      wi[warp][j] = oi[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = lane < kMergeThreads / 32;
      ts[j] = in ? ws[lane][j] : -CUDART_INF_F;
      ti[j] = in ? wi[lane][j] : -1;
    }
    warp_topk_merge<K>(ts, ti, os, oi);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        out_s[(size_t)b * K + j] = os[j];
        out_i[(size_t)b * K + j] = oi[j];
      }
    }
  }
}

template <int K>
int launch(const float* q, const float* db, const unsigned char* valid, float* part_s,
           int* part_i, float* out_s, int* out_i, int batch, int n, int d, int chunk,
           cudaStream_t s) {
  const int nchunks = (n + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * ((size_t)kQB * d + (size_t)kStages * kStageF);
  static size_t allowed[kMaxDevices] = {};   // the limit set so far, per device
  cudaError_t err = raise_smem_limit(cosine_topk_partial_kernel<K>, smem, allowed, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(nchunks, (batch + kQB - 1) / kQB);
  cosine_topk_partial_kernel<K><<<grid, kScanThreads, smem, s>>>(q, db, valid, batch, n, d,
                                                                 chunk, part_s, part_i);
  cosine_topk_merge_kernel<K><<<batch, kMergeThreads, 0, s>>>(part_s, part_i, batch, nchunks,
                                                              out_s, out_i);
  return 0;
}

}  // namespace
}  // namespace repro_torch

// q (B,D), db (N,D) fp32 contiguous and 16-byte aligned; valid (N,) one
// byte per row; part_s/part_i (nchunks*B*k,) scratch; out_s (B,k) fp32,
// out_i (B,k) int32.  Requires 1 <= k <= 8 and D % 32 == 0.  Returns
// cudaGetLastError().
extern "C" int cosine_topk_launch(const void* q, const void* db, const void* valid,
                                  void* part_s, void* part_i, void* out_s, void* out_i,
                                  int batch, int n, int d, int k, int chunk, void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || d % 32 != 0 || chunk < 1 || batch < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  const unsigned char* vb = static_cast<const unsigned char*>(valid);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  int rc = 0;
  switch (k) {
    case 1: rc = launch<1>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 2: rc = launch<2>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 3: rc = launch<3>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 4: rc = launch<4>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 5: rc = launch<5>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 6: rc = launch<6>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    case 7: rc = launch<7>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
    default: rc = launch<8>(qf, dbf, vb, ps, pi, os, oi, batch, n, d, chunk, s); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
