// Shortlist cosine top-k of the IVF probe, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cosine_topk/kernel.py:cosine_topk_gather_pallas
// (body _gather_kernel + _topk_merge), and the (B, M, D) gather that
// ops.cosine_topk_gather runs in XLA before it.  For queries q (B,D) and the
// bank db (N,D), both fp32 unit vectors, and per query a list of M candidate
// bank rows cand_idx (B,M) with a mask cand_valid (B,M), returns the k best
// scores q_b . db[cand_idx[b,p]] over the live candidates (cand_valid and
// 0 <= cand_idx < N) in descending order, with their bank rows.  Ties go to
// the lowest candidate POSITION p (what lax.top_k and the strict ">" merge
// of the TPU kernel keep), a row listed twice is reported twice, and slots
// with no live candidate hold score -inf and row -1.
//
// What bounds it on an H100: bytes.  Each live candidate row is read once
// (D * 4 bytes) plus 5 bytes of index and mask per position: at B 8, M 2,048
// (nprobe 8 x bucket 256), D 384 and about half the candidates live,
// ~12.6 MB, ~3.5 us at 3.35 TB/s, against 12.6 MFLOP of fp32 dot products.
// Each query has its own candidates, so there is no reuse for tensor cores:
// it is a batched matvec, and what it takes is bytes in flight with no
// dependent chain per row between them.
//
// Design: one launch, no scratch.  The TPU kernel carried one running top-k
// down a sequential grid; here the M positions of a query are cut into
// `per_block` positions per block (ops.gather_plan mirrors the numbers), and
// the blocks of one query (at most 8) form one thread-block cluster:
//  * a block loads its positions' indices and masks coalesced (16 bytes of
//    indices and 4 of mask a thread where M % 4 == 0, scalars otherwise), in
//    rounds of kRound positions, and compacts the live ones, in position
//    order, into a shared list (a prefix sum over lanes, then warps); dead
//    candidates are never read;
//  * each warp then takes 8 live rows of the list at a time and issues all
//    of their loads (lanes read 16 bytes each, coalesced along the row, 24
//    float4 a lane at D 384) before the first use: 8 warps x 8 rows = 96 KB
//    in flight per block; the next 8 rows' loads go out as soon as the
//    current rows' products are summed into registers, before their
//    shuffles and inserts;
//  * the 8 rows' lane partials are summed by one transposed butterfly (9
//    shuffles for 8 rows); every row gets the same lanes, the same order
//    over d and the same addition tree whatever its slot, block or batch,
//    so a row listed twice scores the same bits at both positions;
//  * the lists are sorted (score, position) top-k arrays in registers
//    (insert_sorted_reg<K>, K a template parameter, 1..8), kept by lanes
//    0, 4, .., 28.  They merge by group_topk_merge (3 shuffle
//    steps a round) within a warp, then across the block's warps through
//    shared memory; each block then sends its list, with the positions'
//    bank rows, into cluster rank 0's shared memory (st.async, counted in
//    bytes on rank 0's mbarrier), and rank 0 merges the cluster's lists and
//    writes out_s/out_i.  The only cluster barrier is arrived at when a
//    block starts and waited on before its first remote store, so no block
//    waits at the end for another.  Every comparison is topk.cuh::better on
//    (score, position), never the row or the rank, so a tie between blocks
//    goes to the lower position.
// At the main-path shape: 8 clusters of 8 blocks of 256 positions, one wave
// on 64 SMs (an H100 holds 15 clusters of 8 of this kernel at once).

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "topk.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 4 * kThreads;   // positions loaded and compacted at once
constexpr int kRows = 8;               // live rows a warp has in flight
constexpr int kF = 3;                  // float4 of a row per lane per pass (D 384 in one)
constexpr int kMaxCluster = 8;         // blocks of one query (the portable cluster size)
static_assert((kWarps & (kWarps - 1)) == 0 && kWarps <= 32, "the warps' merge is a butterfly");

// The sums over the warp of the lanes' partials v[0..7] of 8 rows, by a
// butterfly that hands half of the rows to the partner lane at each of the
// first three steps: lane l returns the sum of row (l >> 2) & 7.  Each row
// meets the same pairs of lanes in the same order as warp_sum's, so its sum
// does not depend on its slot.
__device__ __forceinline__ float transposed_sum8(const float (&v)[kRows], int lane) {
  float w4[4];
  const bool h16 = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? v[i] : v[i + 4];
    w4[i] = (h16 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float w2[2];
  const bool h8 = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? w4[i] : w4[i + 2];
    w2[i] = (h8 ? w4[i + 2] : w4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool h4 = lane & 4;
  float w = (h4 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, h4 ? w2[0] : w2[1], 4);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  w += __shfl_xor_sync(0xffffffffu, w, 1);
  return w;
}

// The best K of the sorted (score, position) lists held by lanes 0, LO,
// 2 LO, .. (2 HI - LO) of each group: K rounds of a shuffle argmax with
// `better` over the offsets HI down to LO.  Unlike topk.cuh's
// warp_topk_merge it carries no lane number (two shuffles a step, not
// three): it REQUIRES the real entries of a group to hold distinct
// positions, and the lane whose head holds the winner's position pops it.
// Every caller below merges positions of one query, each scored once, so
// they are distinct.  The lists are consumed; every lane of the group gets
// the result in (out_s, out_p).
template <int K, int HI, int LO>
__device__ __forceinline__ void group_topk_merge(float (&ts)[K], int (&tp)[K], float (&out_s)[K],
                                                 int (&out_p)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bs = ts[0];
    int bp = tp[0];
#pragma unroll
    for (int off = HI; off >= LO; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (better(os, op, bs, bp)) {
        bs = os;
        bp = op;
      }
    }
    out_s[r] = bs;
    out_p[r] = bp;
    if (bp >= 0 && tp[0] == bp) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        ts[j] = ts[j + 1];
        tp[j] = tp[j + 1];
      }
      ts[K - 1] = -CUDART_INF_F;
      tp[K - 1] = -1;
    }
  }
}

// 4 bytes into the shared memory of cluster rank 0 at the address `local`
// has in this block, completing that many bytes on rank 0's mbarrier.
__device__ __forceinline__ void push_rank0(const void* local, uint32_t value, uint32_t bar) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst) : "r"(smem_u32(local)));
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(rbar) : "r"(bar));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(dst), "r"(value), "r"(rbar) : "memory");
}

// grid (cluster, B), clusters of (cluster, 1, 1); block x scores positions
// [x * per_block, min(M, (x + 1) * per_block)) of query blockIdx.y.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
gather_topk_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const int* __restrict__ cand_idx,
                   const unsigned char* __restrict__ cand_valid, int n, int m, int d,
                   int per_block, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ int s_pos[kRound];   // the round's live positions, ascending ...
  __shared__ int s_row[kRound];   // ... and their bank rows
  __shared__ int s_count[kWarps];
  __shared__ float s_ws[kWarps][K];
  __shared__ int s_wp[kWarps][K];
  __shared__ uint64_t s_bar;      // rank 0: the other blocks' lists have landed
  __shared__ float s_cs[kMaxCluster][K];   // rank 0: every block's list ...
  __shared__ int s_cp[kMaxCluster][K];     // ... positions
  __shared__ int s_cr[kMaxCluster][K];     // ... and bank rows

  const int b = blockIdx.y;
  const int rank = blockIdx.x;   // the cluster spans the grid's x
  const int nblocks = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d4 = d / 4;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * d);
  const int* idx_b = cand_idx + (size_t)b * m;
  const unsigned char* valid_b = cand_valid + (size_t)b * m;
  const int p_lo = rank * per_block;
  const int p_hi = min(m, p_lo + per_block);
  const bool vec = m % 4 == 0 && per_block % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cand_idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cand_valid) % 4 == 0;
  const uint32_t bar = smem_u32(&s_bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    if (rank == 0)   // rank 0 arrives at once and waits for the others' bytes
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"((nblocks - 1) * K * 12) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this block has started and set its barrier; the matching wait comes
  // before any block writes into rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float ts[K];
  int tp[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ts[j] = -CUDART_INF_F;
    tp[j] = -1;
  }

  for (int base = p_lo; base < p_hi; base += kRound) {
    // --- load 4 positions a thread and compact the live ones in order
    const int p0 = base + 4 * tid;
    int ix[4];
    bool lv[4];
    if (vec && p0 + 4 <= p_hi) {
      const int4 i4 = *reinterpret_cast<const int4*>(idx_b + p0);
      const uint32_t v4 = *reinterpret_cast<const uint32_t*>(valid_b + p0);
      ix[0] = i4.x;
      ix[1] = i4.y;
      ix[2] = i4.z;
      ix[3] = i4.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) lv[j] = (v4 >> (8 * j)) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + j;
        lv[j] = p < p_hi && valid_b[p];
        ix[j] = lv[j] ? idx_b[p] : -1;
      }
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lv[j] = lv[j] && ix[j] >= 0 && ix[j] < n;   // an index outside [0, N) is dead
      cnt += lv[j];
    }
    int inc = cnt;   // inclusive prefix over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    if (lane == 31) s_count[warp] = inc;
    __syncthreads();
    int at = inc - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      at += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lv[j]) {
        s_pos[at] = p0 + j;
        s_row[at] = ix[j];
        ++at;
      }
    }
    __syncthreads();

    // --- score the live rows: warp w takes batches w, w + 8, .. of 8 rows,
    // a pass at a time (one pass when D <= 384); a unit's loads are all
    // issued before its first use, and the next unit's loads go out before
    // this one's sum and insert
    const int nbatch = (total + kRows - 1) / kRows;
    const int mine = warp < nbatch ? (nbatch - warp + kWarps - 1) / kWarps : 0;
    const int passes = (d4 + 32 * kF - 1) / (32 * kF);
    const int units = mine * passes;
    float4 x[kRows][kF];
    float4 w[kF];
    auto load = [&](int u) {
      const int r0 = (warp + (u / passes) * kWarps) * kRows;
      const int nr = min(kRows, total - r0);
      const int c0 = (u % passes) * 32 * kF;
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int e = c0 + lane + 32 * f;
        w[f] = e < d4 ? __ldg(q4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4* row4 = reinterpret_cast<const float4*>(
            db + (size_t)s_row[r0 + min(r, nr - 1)] * d);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const int e = c0 + lane + 32 * f;
          x[r][f] = r < nr && e < d4 ? __ldg(row4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    };
    float v[kRows];
    if (units > 0) load(0);
    for (int u = 0; u < units; ++u) {
      if (u % passes == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < kF; ++f)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = v[r];
          a = fmaf(x[r][f].x, w[f].x, a);
          a = fmaf(x[r][f].y, w[f].y, a);
          a = fmaf(x[r][f].z, w[f].z, a);
          a = fmaf(x[r][f].w, w[f].w, a);
          v[r] = a;
        }
      if (u + 1 < units) load(u + 1);
      if (u % passes == passes - 1) {
        const int r0 = (warp + (u / passes) * kWarps) * kRows;
        const int nr = min(kRows, total - r0);
        const float score = transposed_sum8(v, lane);
        const int slot = (lane >> 2) & (kRows - 1);
        if ((lane & 3) == 0 && slot < nr) insert_sorted_reg<K>(ts, tp, score, s_pos[r0 + slot]);
      }
    }
    __syncthreads();   // the next round overwrites the list
  }

  // --- the block's top-k: the lists of lanes 0, 4, .., 28 of each warp, then
  // the warps' lists
  float os[K];
  int op[K];
  // distinct positions: each live position was scored by one lane once
  group_topk_merge<K, 16, 4>(ts, tp, os, op);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s_ws[warp][j] = os[j];
      s_wp[warp][j] = op[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = lane < kWarps;
      ts[j] = in ? s_ws[lane][j] : -CUDART_INF_F;
      tp[j] = in ? s_wp[lane][j] : -1;
    }
    // distinct positions: the warps scored disjoint rows of the list
    group_topk_merge<K, kWarps / 2, 1>(ts, tp, os, op);
  }
  int row[K];   // the list's bank rows (lane 0 of warp 0), read before the
                // cluster wait, which invalidates L1
  if (warp == 0 && lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) row[j] = op[j] >= 0 ? idx_b[op[j]] : -1;
  }

  // --- the query's blocks are one cluster: each sends its list, with the
  // positions' bank rows, into rank 0's shared memory; rank 0 merges them
  // and writes the result.  Every block has started and rank 0's barrier is
  // set once this wait returns.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp != 0) return;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (rank == 0) {
        s_cs[0][j] = os[j];
        s_cp[0][j] = op[j];
        s_cr[0][j] = row[j];
      } else {
        push_rank0(&s_cs[rank][j], __float_as_uint(os[j]), bar);
        push_rank0(&s_cp[rank][j], static_cast<uint32_t>(op[j]), bar);
        push_rank0(&s_cr[rank][j], static_cast<uint32_t>(row[j]), bar);
      }
    }
  }
  if (rank != 0) return;
  __syncwarp();
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar) : "memory");
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = lane < nblocks;
    ts[j] = in ? s_cs[lane][j] : -CUDART_INF_F;
    tp[j] = in ? s_cp[lane][j] : -1;
  }
  // distinct positions: the blocks hold disjoint ranges of them
  group_topk_merge<K, kMaxCluster / 2, 1>(ts, tp, os, op);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      int row = -1;   // the winner's row, from its block's list
      if (op[j] >= 0) {
        const int src = op[j] / per_block;
#pragma unroll
        for (int t = 0; t < K; ++t)
          if (s_cp[src][t] == op[j]) row = s_cr[src][t];
      }
      out_s[(size_t)b * K + j] = op[j] >= 0 ? os[j] : -CUDART_INF_F;
      out_i[(size_t)b * K + j] = row;
    }
  }
}

cudaLaunchConfig_t config(int cluster, int batch, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;   // the blocks of one query
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int K>
int launch(const float* q, const float* db, const int* idx, const unsigned char* valid,
           float* out_s, int* out_i, int batch, int n, int m, int d, int per_block,
           cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config((m + per_block - 1) / per_block, batch, attr);
  cfg.stream = s;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, gather_topk_kernel<K>, q, db, idx, valid,
                                             n, m, d, per_block, out_s, out_i));
}

template <int K>
int wave(int cluster, int* clusters) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(cluster, 1, attr);   // one cluster: only its shape is read
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(gather_topk_kernel<K>), &cfg));
}

}  // namespace
}  // namespace repro_torch

// q (B,D), db (N,D) fp32 contiguous and 16-byte aligned; cand_idx (B,M)
// int32; cand_valid (B,M) one byte per entry; out_s (B,k) fp32, out_i (B,k)
// int32.  Candidates with an index outside [0, N) count as dead.  Requires
// 1 <= k <= 8, D % 4 == 0 and at most 8 blocks of per_block positions per
// query.  One launch; returns cudaGetLastError().
extern "C" int cosine_topk_gather_launch(const void* q, const void* db, const void* cand_idx,
                                         const void* cand_valid, void* out_s, void* out_i,
                                         int batch, int n, int m, int d, int k, int per_block,
                                         void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || d % 4 != 0 || d < 4 || per_block < 1 || batch < 1 ||
      batch > 65535 || m < 1 || n < 1 || (m + per_block - 1) / per_block > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  const int* ix = static_cast<const int*>(cand_idx);
  const unsigned char* vb = static_cast<const unsigned char*>(cand_valid);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  int rc = 0;
  switch (k) {
    case 1: rc = launch<1>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 2: rc = launch<2>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 3: rc = launch<3>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 4: rc = launch<4>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 5: rc = launch<5>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 6: rc = launch<6>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    case 7: rc = launch<7>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
    default: rc = launch<8>(qf, dbf, ix, vb, os, oi, batch, n, m, d, per_block, s); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of `cluster` blocks (1-8) of the k instance that the card
// holds at once (cudaOccupancyMaxActiveClusters), into *clusters: what
// ops.gather_plan's GATHER_WAVE_CLUSTERS assumes.  Returns the CUDA error.
extern "C" int cosine_topk_gather_wave_clusters(int k, int cluster, int* clusters) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return wave<1>(cluster, clusters);
    case 2: return wave<2>(cluster, clusters);
    case 3: return wave<3>(cluster, clusters);
    case 4: return wave<4>(cluster, clusters);
    case 5: return wave<5>(cluster, clusters);
    case 6: return wave<6>(cluster, clusters);
    case 7: return wave<7>(cluster, clusters);
    default: return wave<8>(cluster, clusters);
  }
}
