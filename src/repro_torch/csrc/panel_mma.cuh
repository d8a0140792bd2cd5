// Tensor-core body of the bf16 panel attention kernels, for Hopper (sm_90a):
// a panel of queries x G grouped heads of one KV head against the slots of
// a KV cache, read through an accessor (attention_panel.cuh's PagedKV, or
// DenseKV) that gives each slot's position and row.
//
// Used for bf16 by paged_attention.cu (paged decode and the paged verify
// block, PagedKV), decode_attention_block.cu (the dense verify block,
// DenseKV) and decode_attention.cu (dense decode: one query, DenseKV with
// shift 1); fp32 stays on the CUDA cores (attention_panel.cuh,
// decode_attention.cu), since tensor cores would mean TF32.
//
// What bounds it on an H100: bytes.  At the main-path shapes (B 8, H 32,
// Hk 8, dh 128, cap 206, page 16) a call reads ~5.4 MB of K/V, 1.6 us at
// 3.35 TB/s.  Each slot's read is a dependent chain (position, table entry,
// row; dense: the row alone), so the design keeps a whole tile's chains in
// flight at once and puts the arithmetic on the tensor cores, leaving
// latency, not bytes or operations, as what the kernel waits on.  When a
// dense and a paged cache hold the same rows at cap == T, both accessors
// give the same positions, so the same tiles are loaded and summed in the
// same order: the two results are equal bit for bit.
//
// Design:
//  * One block per (row b, KV head, split of the slots, panel of queries),
//    4 warps.  A split is a whole number of 64-slot tiles.  ops.launch_plan
//    mirrors the numbers and keeps a call's clusters (below) within what the
//    card holds at once (wave_clusters): at the main shapes 64 x 2 splits of
//    two tiles = 128 blocks, since 4 splits would make 64 clusters of 4, two
//    more than an H100 holds, and a second wave.  Panel rows are queries x G
//    heads of the KV head, at most 16: two n-tiles of 8.
//  * Gather: for a tile, thread i < 64 resolves slot i (its position; its
//    table entry only if some panel row may see the slot) into a shared row
//    table; then all threads copy the tile's K and V rows with 16-byte
//    cp.async, 16 lanes to a 256-byte row (coalesced), into XOR-swizzled
//    shared tiles, all of the tile in flight at once.  A slot no panel row
//    sees is zero-filled (src-size 0) from the pool's base and never reads
//    its table entry or its page.  Tiles are double-buffered; a tile no
//    panel row sees (the TRASH row, the tail past cap) is skipped before it
//    is loaded.  The first tile's slots are resolved while the tile flags
//    are worked out; the Q panel comes in with the first tile.
//  * Tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators): each
//    warp takes 16 slots of the tile.  S = K Q^T with the slots as mma's M
//    side and the panel rows as its N side, so one query of G 4 pads to one
//    n-tile of 8, not to a 16-row m-tile; the Q fragments are read once from
//    the Q panel in shared memory (ldmatrix) and stay in registers.
//    O^T += V^T P^T with V through ldmatrix.trans and P rounded to bf16, its
//    accumulator fragments turned into B fragments by movmatrix.trans.
//  * Masking from positions only, per slot and panel row: a slot counts for
//    query i iff 0 <= key_pos <= limit(i); masked scores are -inf, so they
//    add exactly nothing (exp(-inf) = 0) and a row with no visible slot
//    keeps (m, l, acc) = (kNeg, 0, 0) and gives 0, the panel body's rule.
//    The exception is the accessor's uniform(b) (dense single-token decode
//    with cache_len <= 0): every slot t < T is visible at score 0, so the
//    row gets the reference's uniform average of V, with no host read and
//    no extra launch.
//  * Online softmax per warp in registers (a panel row's 16 scores of the
//    warp sit in the 8 lanes of one lane-in-quad, so the max takes 3
//    shuffles); the 4 warps merge through shared memory at the end, four
//    outputs (a float4) a thread.
//  * Shapes: dh 64, 80, 128 and 192 (and 256, for dense single-token decode
//    only: recurrentgemma's local attention, G 16), and any G whose panel fits kMaxCols
//    rows (G 7, 12 and 16 at deepseek's, nemotron's and qwen3-moe's widths:
//    one query of G 12 fills 12 of 16 columns and one of G 16 all 16, so a
//    K-4 verify block runs 4 panels, each two n-tiles of 8).  A
//    panel row's query and head are c / G and c % G.  S takes DH/16
//    k-steps, whose Q fragments load two at a time; an odd count (5 at dh
//    80) loads its last alone.  dh-80 rows sit in 128-column shared rows
//    (mma.cuh's row_bytes); at dh 192 a block takes ~105 KB, still two a SM;
//    at dh 256 ~141 KB, one a SM (ops.launch_plan's WAVE_CLUSTERS_ONE_A_SM),
//    and with two n-tiles (G 16) the O^T accumulators take 128 registers a
//    thread, beside Q fragments reread from shared memory each k-step.
//  * Splits: with one split the block writes the output.  Otherwise the
//    splits of a (row, KV head, panel) run as one thread-block cluster
//    (at most 8): each block leaves its state (m, l, acc) in shared memory,
//    and after a cluster barrier each block merges a share of the panel's
//    outputs, reading every split's (m, l) and acc for them in one round
//    through distributed shared memory, with no trip through device memory.
#pragma once

#include <cooperative_groups.h>
#include <math_constants.h>

#include "attention_panel.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace panel_mma {

constexpr int kTile = 64;                 // slots per tile: 4 warps x 16 (mma's M)
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 16;              // panel rows per block: two n-tiles of 8
constexpr int kMaxSplits = 8;             // splits of one cluster (the portable size)

struct Args {
  int g;         // query heads per KV head
  int kqp;       // queries per panel (blockIdx.z)
};

// Dynamic shared memory: two (K, V) tile buffers, the slot positions and
// rows of both, the Q panel, one flag per tile of the split.  After the loop the
// warps' states, then the block's merged acc, reuse the tile buffers.
template <int DH>
struct Smem {
  static constexpr int kTileBytes = kTile * row_bytes(DH);
  static constexpr int kBuf = 2 * kTileBytes;             // K then V
  static constexpr int kPos = 2 * kBuf;                   // int [2][kTile]
  static constexpr int kRow = kPos + 2 * kTile * 4;       // long long [2][kTile], -1: none
  static constexpr int kQ = kRow + 2 * kTile * 8;         // bf16 [kMaxCols][DH], swizzled
  static constexpr int kFlags = kQ + kMaxCols * row_bytes(DH);   // unsigned char [tiles]
  static constexpr int kAccStride = DH + 4;               // floats per warp-state row
  static constexpr int kBlk = kWarps * kMaxCols * kAccStride * 4;   // float [kMaxCols][DH]
  static size_t bytes(int tiles) { return kFlags + ((tiles + 15) / 16) * 16; }
  static_assert(kBlk + kMaxCols * DH * 4 <= 2 * kBuf, "merge states exceed the tiles");
};

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void fma4(float4& a, float w, const float4& x) {
  a.x += w * x.x;
  a.y += w * x.y;
  a.z += w * x.z;
  a.w += w * x.w;
}

// grid (B*Hk, nsplit, panels), clusters of (1, nsplit, 1); kThreads threads;
// Smem<DH>::bytes dynamic.  q/out (B,K,H,dh) bf16; q and the cache 16-byte
// aligned (cp.async).
template <int DH, int NT, class KV>
__global__ void __launch_bounds__(kThreads, DH > 192 ? 1 : 2)
panel_mma_kernel(const __nv_bfloat16* __restrict__ q, KV kv, panel::Geometry geo, Args args,
                 __nv_bfloat16* __restrict__ out) {
  using L = Smem<DH>;
  constexpr int kChunks = DH / 8;   // 16-byte chunks per row
  constexpr int KS = DH / 16;       // k-steps of S; m-tiles of O^T
  constexpr int D4 = DH / 4;        // float4 groups per row
  extern __shared__ __align__(128) unsigned char smem[];
  int* sPos = reinterpret_cast<int*>(smem + L::kPos);
  long long* sRow = reinterpret_cast<long long*>(smem + L::kRow);
  unsigned char* sFlag = smem + L::kFlags;
  __shared__ float sM[kWarps][kMaxCols], sL[kWarps][kMaxCols];
  __shared__ float sColM[kMaxCols], sColL[kMaxCols];

  const int bk = blockIdx.x;
  const int b = bk / geo.hk;
  const int kh = bk % geo.hk;
  const int split = blockIdx.y;
  const int g = args.g;
  const int h = geo.hk * g;
  const int qbase = blockIdx.z * args.kqp;
  const int nq = min(args.kqp, geo.kq - qbase);
  const int ncols = nq * g;          // panel rows of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;
  const int tq = lane % 4;
  // output (and Q) row of panel row c: query qbase + c / g, head kh*g + c % g
  auto qrow = [&](int c) {
    return (((long long)b * geo.kq + qbase + c / g) * h + (long long)kh * g + c % g) * DH;
  };

  // --- the Q panel, in flight with the first tile (rows past it zero)
  for (int i = tid; i < NT * 8 * kChunks; i += kThreads) {
    const int c = i / kChunks;
    const int ch = i % kChunks;
    cp_async16(smem_u32(smem + L::kQ) + swz<DH>(c, ch), q + (c < ncols ? qrow(c) : 0) + ch * 8,
               c < ncols);
  }
  // the limits of this lane's score columns 2tq, 2tq+1
  int lim[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * tq + e;
      lim[nt][e] = c < ncols ? kv.limit(b, qbase + c / g, geo) : -1;
    }
  }
  const int lim_max = kv.limit(b, qbase + nq - 1, geo);   // limits grow with the query
  const bool flat = kv.uniform(b);                        // every slot at score 0
  const int s0 = split * geo.chunk;
  const int s1 = min(s0 + geo.chunk, kv.end(b, qbase + nq - 1, geo));
  const int ntl = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;

  // --- which tiles some panel row sees; the first tile's slots resolved here
  for (int i = tid; i < ntl; i += kThreads) sFlag[i] = 0;
  const int kp0 = tid < kTile && tid < s1 - s0 ? kv.key_pos(b, s0 + tid, geo) : -1;
  const bool want0 = kp0 >= 0 && kp0 <= lim_max;
  const long long row0 = want0 ? kv.row(b, s0 + tid, kh, geo) : -1;
  __syncthreads();
  if (want0) sFlag[0] = 1;
  for (int j = kTile + tid; j < s1 - s0; j += kThreads) {
    const int kp = kv.key_pos(b, s0 + j, geo);
    if (kp >= 0 && kp <= lim_max) sFlag[j / kTile] = 1;
  }
  __syncthreads();

  // thread i < 64 resolves slot i of tile t into the shared position and row
  // tables (a slot no panel row sees gets row -1: no table read, zero-fill);
  // then the tile's K and V rows are copied, kChunks lanes to a row
  auto load_tile = [&](int t, int buf) {
    if (tid < kTile) {
      int kp = kp0;
      long long row = row0;
      if (t > 0) {
        const int j = t * kTile + tid;
        kp = j < s1 - s0 ? kv.key_pos(b, s0 + j, geo) : -1;
        row = kp >= 0 && kp <= lim_max ? kv.row(b, s0 + j, kh, geo) : -1;
      }
      sPos[buf * kTile + tid] = kp;
      sRow[buf * kTile + tid] = row;
    }
    __syncthreads();
    // unrolled whole up to dh 128; at dh 192 and 256 (24 and 32 copies a
    // thread) a whole unroll computes every source address up front and the
    // body spills
#pragma unroll (DH > 128 ? 4 : 2 * kTile * kChunks / kThreads)
    for (int j = 0; j < 2 * kTile * kChunks / kThreads; ++j) {
      const int c = j * kThreads + tid;
      const int sel = c / (kTile * kChunks);     // 0: K, 1: V
      const int rr = (c / kChunks) % kTile;
      const int ch = c % kChunks;
      const long long row = sRow[buf * kTile + rr];
      const __nv_bfloat16* src = (sel ? kv.v : kv.k) + (row < 0 ? 0 : row * DH) + ch * 8;
      cp_async16(smem_u32(smem + buf * L::kBuf + sel * L::kTileBytes) + swz<DH>(rr, ch), src,
                 row >= 0);
    }
  };
  auto next_tile = [&](int t) {
    ++t;
    while (t < ntl && !sFlag[t]) ++t;
    return t;
  };

  // B fragments of S = K Q^T, from the Q panel: held in registers for the
  // whole loop, except at dh 192 and 256 with two n-tiles, where the 48 or
  // 64 registers they take would spill; there each tile rereads them
  // (ldmatrix) instead
  constexpr bool kQRegs = KS * NT <= 16;
  uint32_t qf[kQRegs ? NT : 1][kQRegs ? KS : 1][2];
  float acc[KS][NT][4];
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = kNeg;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int md = 0; md < KS; ++md) acc[md][nt][0] = acc[md][nt][1] = acc[md][nt][2] =
        acc[md][nt][3] = 0.f;
  }

  int t = next_tile(-1);
  if (t < ntl) load_tile(t, 0);
  cp_async_commit();
  for (int it = 0; t < ntl; ++it) {
    const int buf = it & 1;
    const int tn = next_tile(t);
    if (tn < ntl) load_tile(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {   // b0, b1 of k-steps kk and kk+1: panel rows nt*8.., chunks 2kk..2kk+3
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int kk = 0; kk + 1 < KS; kk += 2)
            ldsm_x4(smem_u32(smem + L::kQ) + swz<DH>(nt * 8 + (lane & 7), 2 * kk + (lane >> 3)),
                    qf[nt][kk][0], qf[nt][kk][1], qf[nt][kk + 1][0], qf[nt][kk + 1][1]);
          if (KS % 2)   // an odd last k-step (dh 80): its two chunks alone
            ldsm_x2(smem_u32(smem + L::kQ) +
                        swz<DH>(nt * 8 + (lane & 7), 2 * (KS - 1) + ((lane >> 3) & 1)),
                    qf[nt][KS - 1][0], qf[nt][KS - 1][1]);
        }
      }
    }
    // this warp's 16 slots (row offsets keep their low 3 bits: same swizzle)
    const unsigned char* sK = smem + buf * L::kBuf + warp * 16 * row_bytes(DH);
    const unsigned char* sV = sK + L::kTileBytes;
    const int* pos = sPos + buf * kTile + warp * 16;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(sK + swz<DH>(lane & 15, 2 * kk + (lane >> 4))), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        if constexpr (kQRegs) {
          b0 = qf[nt][kk][0];
          b1 = qf[nt][kk][1];
        } else {
          ldsm_x2(smem_u32(smem + L::kQ) +
                      swz<DH>(nt * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)), b0, b1);
        }
        mma_bf16(s[nt], a, b0, b1);
      }
    }

    // mask from positions, online softmax per panel row (score column)
    const int kp_lo = pos[grp];
    const int kp_hi = pos[grp + 8];
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = e < 2 ? kp_lo : kp_hi;
        s[nt][e] = kp >= 0 && kp <= lim[nt][e & 1] ? (flat ? 0.f : s[nt][e] * geo.scale)
                                                   : -CUDART_INF_F;
      }
      float mx0 = fmaxf(s[nt][0], s[nt][2]);
      float mx1 = fmaxf(s[nt][1], s[nt][3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[nt][0], mx0);
      const float mn1 = fmaxf(m[nt][1], mx1);
      const float c0 = __expf(m[nt][0] - mn0);
      const float c1 = __expf(m[nt][1] - mn1);
      m[nt][0] = mn0;
      m[nt][1] = mn1;
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn1);
      s[nt][2] = __expf(s[nt][2] - mn0);
      s[nt][3] = __expf(s[nt][3] - mn1);
      l[nt][0] = l[nt][0] * c0 + s[nt][0] + s[nt][2];
      l[nt][1] = l[nt][1] * c1 + s[nt][1] + s[nt][3];
#pragma unroll
      for (int md = 0; md < KS; ++md) {
        acc[md][nt][0] *= c0;
        acc[md][nt][1] *= c1;
        acc[md][nt][2] *= c0;
        acc[md][nt][3] *= c1;
      }
      // P as B fragments of O^T += V^T P^T: slots 2tq.. of panel row grp
      pb[nt][0] = movm_t(pack_bf16(s[nt][0], s[nt][1]));
      pb[nt][1] = movm_t(pack_bf16(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int md = 0; md < KS; ++md) {
      uint32_t a[4];
      ldsm_x4_t(smem_u32(sV + swz<DH>((lane & 7) + ((lane >> 4) << 3), 2 * md + ((lane >> 3) & 1))),
                a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[md][nt], a, pb[nt][0], pb[nt][1]);
    }
    __syncthreads();   // this buffer is refilled two tiles on
    t = tn;
  }
  cp_async_wait<0>();

  // --- merge the 4 warps: states into shared memory (over the tiles)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], off);
      if (grp == 0) {
        sM[warp][nt * 8 + 2 * tq + e] = m[nt][e];
        sL[warp][nt * 8 + 2 * tq + e] = l[nt][e];
      }
    }
  }
  float* sAcc = reinterpret_cast<float*>(smem);   // [kWarps][kMaxCols][kAccStride]
#pragma unroll
  for (int md = 0; md < KS; ++md) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = sAcc + (warp * kMaxCols + nt * 8 + 2 * tq) * L::kAccStride + md * 16 + grp;
      p[0] = acc[md][nt][0];
      p[L::kAccStride] = acc[md][nt][1];
      p[8] = acc[md][nt][2];
      p[L::kAccStride + 8] = acc[md][nt][3];
    }
  }
  __syncthreads();
  if (tid < ncols) {   // per panel row: the warps' weights, the row's (m, l)
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sM[w][tid] - mx);
      ls += sL[w][tid] * f;
      sM[w][tid] = f;
    }
    sColM[tid] = mx;
    sColL[tid] = ls;
  }
  __syncthreads();
  const int nsplit = geo.nsplit;
  float* sBlk = reinterpret_cast<float*>(smem + L::kBlk);   // [kMaxCols][DH] this block's acc
  for (int i = tid; i < ncols * D4; i += kThreads) {        // 4 outputs a thread
    const int c = i / D4;
    const int d = (i % D4) * 4;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      fma4(as, sM[w][c],
           *reinterpret_cast<const float4*>(sAcc + (w * kMaxCols + c) * L::kAccStride + d));
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(sColL[c], 1e-30f);
      store_bf16x4(out + qrow(c) + d, make_float4(as.x * inv, as.y * inv, as.z * inv, as.w * inv));
    } else {
      *reinterpret_cast<float4*>(sBlk + c * DH + d) = as;
    }
  }
  if (nsplit == 1) return;

  // --- the splits of this (row, KV head, panel) are one cluster: merge the
  // blocks' states through distributed shared memory, each block a share
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                    // every block's state is in place
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * kThreads + tid; i < ncols * D4; i += nsplit * kThreads) {
    const int c = i / D4;
    const int d = (i % D4) * 4;
    float ms[kMaxSplits], ls[kMaxSplits];
    float4 x[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {   // every split's loads in flight at once
      if (sp < nsplit) {
        ms[sp] = *cluster.map_shared_rank(&sColM[c], sp);
        ls[sp] = *cluster.map_shared_rank(&sColL[c], sp);
        x[sp] = *cluster.map_shared_rank(reinterpret_cast<float4*>(sBlk + c * DH + d), sp);
      }
    }
    float mx = kNeg;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < nsplit) mx = fmaxf(mx, ms[sp]);
    float lsum = 0.f;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < nsplit) {
        const float f = __expf(ms[sp] - mx);
        lsum += ls[sp] * f;
        fma4(as, f, x[sp]);
      }
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    store_bf16x4(out + qrow(c) + d, make_float4(as.x * inv, as.y * inv, as.z * inv, as.w * inv));
  }
  cluster.sync();                    // no block leaves while another reads it
}

template <int DH, int NT, class KV>
int launch_nt(const void* q, const KV& kv, const panel::Geometry& geo, const Args& args,
              int batch, void* out, cudaStream_t stream) {
  const size_t smem = Smem<DH>::bytes((geo.chunk + kTile - 1) / kTile);
  static size_t allowed[kMaxDevices] = {};   // this instance's limit so far, per device
  cudaError_t err = raise_smem_limit(panel_mma_kernel<DH, NT, KV>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * geo.hk, geo.nsplit, (geo.kq + args.kqp - 1) / args.kqp);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = geo.nsplit;   // the splits of a panel
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, panel_mma_kernel<DH, NT, KV>, static_cast<const __nv_bfloat16*>(q), kv, geo, args,
      static_cast<__nv_bfloat16*>(out)));
}

// The most clusters of `splits` blocks of this instance, `smem` bytes of
// dynamic shared memory each, that the card holds at once
// (cudaOccupancyMaxActiveClusters): ops.launch_plan keeps a call's clusters
// within one such wave.
template <int DH, int NT, class KV>
int wave_clusters(int splits, int smem, int* clusters) {
  cudaFuncAttributes attr;   // the limit is only raised: launch_nt keeps its own
  cudaError_t err = cudaFuncGetAttributes(&attr, panel_mma_kernel<DH, NT, KV>);
  if (err == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
    err = cudaFuncSetAttribute(panel_mma_kernel<DH, NT, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);   // one cluster: only its shape is read
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(panel_mma_kernel<DH, NT, KV>), &cfg));
}

template <int DH, class KV>
int launch_dh(const void* q, const KV& kv, const panel::Geometry& geo, const Args& args,
              int batch, void* out, cudaStream_t stream) {
  const int cols = args.kqp * args.g;
  if (args.g < 1 || args.kqp < 1 || cols > kMaxCols || geo.chunk % kTile != 0 || geo.nsplit < 1 ||
      geo.nsplit > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  return cols <= 8 ? launch_nt<DH, 1, KV>(q, kv, geo, args, batch, out, stream)
                   : launch_nt<DH, 2, KV>(q, kv, geo, args, batch, out, stream);
}

// bf16 q/out (B,K,H,dh); dh 64, 80, 128 or 192, and 256 where the caller
// instantiates it (kDh256: dense single-token decode only); any G with a
// panel of at most kMaxCols rows (ops._check_qkv admits G 1, 2, 4, 6, 7, 8,
// 12 and 16).
template <bool kDh256 = false, class KV>
int launch(int dh, const void* q, const KV& kv, const panel::Geometry& geo, const Args& args,
           int batch, void* out, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_dh<64, KV>(q, kv, geo, args, batch, out, stream);
    case 80: return launch_dh<80, KV>(q, kv, geo, args, batch, out, stream);
    case 128: return launch_dh<128, KV>(q, kv, geo, args, batch, out, stream);
    case 192: return launch_dh<192, KV>(q, kv, geo, args, batch, out, stream);
    case 256:
      if constexpr (kDh256) return launch_dh<256, KV>(q, kv, geo, args, batch, out, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace panel_mma
}  // namespace repro_torch
