// Shared body of the fp32 q-block and paged decode attention kernels, for
// Hopper (sm_90a): a panel of KQ queries x G grouped heads of one KV head
// against a KV cache that is either dense (B,T,Hk,dh) or paged through a
// block table into a (P+1,page,Hk,dh) pool; and the DenseKV / PagedKV
// accessors through which both this body and the bf16 tensor-core body
// (panel_mma.cuh) read the cache.
//
// Used, for fp32, by decode_attention_block.cu (dense, per-query limit
// t < cache_len + i + 1) and paged_attention.cu (validity from slot_pos,
// optionally causal: slot_pos <= q_pos + i); bf16 calls of both, and of
// decode_attention.cu, run panel_mma.cuh.
//
// What bounds these kernels on an H100: bytes.  A verify step reads the
// cache once for all its KQ queries (the Pallas kernels' K x g panel), so
// at the main-path shapes (B=8, H=32, Hk=8, dh=128, T ~ 200 slots) it
// moves ~13 MB in fp32 (~4 us at 3.35 TB/s) against ~0.1 GFLOP of FMA.
//
// Design (simple first: no TMA, no wgmma, no cp.async pipelining):
//  * One block per (row b, KV head, slot split, query group).  The TPU
//    walked the cache as a sequential grid axis with (m, l, acc) in
//    scratch; Hopper blocks run in parallel, so the slots are split into
//    chunks (ops.launch_plan: enough blocks to fill 132 SMs), each block
//    writes a partial (m, l, acc) and panel_merge_kernel combines them.
//    With one split the block writes the normalised output directly.
//  * Inside a block each warp takes every kWarps-th slot.  A lane holds
//    dh/32 consecutive elements of the slot's K and V row, loaded once and
//    used by every panel row (the Pallas kernels' K x g panel that reads
//    each KV tile once); scores are warp-shuffle sums; each warp keeps its
//    own fp32 online softmax per panel row; the warps' states merge
//    through shared memory.
//  * Paged: each warp loads the slot's block-table entry itself (the TPU
//    prefetched the table into SMEM) and never builds the dense cache.
//    Slots with slot_pos < 0 (empty, rewound, the tail of the last page,
//    rows parked on the TRASH page) are skipped without loading.
//  * Visibility is per query but uniform across a warp, so skipping a
//    slot or a query never diverges a warp.
//  * Rule for a query with no visible slot (a row parked on TRASH before
//    any write): the output is 0, finite.  The plain version averages V
//    uniformly there (its finite -1e30 mask); such rows are discarded by
//    done-masking upstream and the checks compare rows with a visible slot.
//    (The dense verify block never has one: cache_len >= 0.)
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace panel {

constexpr int kWarps = 4;
constexpr int kMaxRows = 16;   // KQ * G: panel rows held in registers

struct Geometry {
  int kq;        // queries per row in the call (K)
  int tlen;      // dense: T;  paged: cap (slot_pos width)
  int hk;        // KV heads
  int page;      // paged: slots per page
  int npg;       // paged: block-table width
  int causal;    // paged: 1 = mask slot_pos <= q_pos + i as well
  int chunk;     // slots per split
  int nsplit;
  float scale;
};

// Dense cache: slot t of row b; query i sees t < cache_len[b] + i + 1 - shift.
// shift 0 is the verify block (its keys sit at slots cache_len + i); shift
// 1 the single-token kernel (t < cache_len), whose reference gives a row
// with cache_len <= 0, where every slot is masked, the uniform average of V
// over all T slots: uniform() then makes every slot visible, and
// panel_mma.cuh scores them all alike.
template <typename T>
struct DenseKV {
  const T* k;
  const T* v;
  const int* cache_len;
  int shift;

  __device__ __forceinline__ bool uniform(int b) const { return shift && cache_len[b] <= 0; }
  // First slot past which no query of [q0, q0 + nq) sees anything.
  __device__ __forceinline__ int end(int b, int q_last, const Geometry& g) const {
    return uniform(b) ? g.tlen : min(g.tlen, cache_len[b] + q_last + 1 - shift);
  }
  // Row index (in units of dh) of slot t's K/V for KV head kh.
  __device__ __forceinline__ long long row(int b, int t, int kh, const Geometry& g) const {
    return (((long long)b * g.tlen + t) * g.hk + kh);
  }
  // The absolute position that query i compares against (here the slot).
  __device__ __forceinline__ int key_pos(int b, int t, const Geometry&) const { return t; }
  __device__ __forceinline__ int limit(int b, int i, const Geometry&) const {
    return uniform(b) ? 0x7fffffff : cache_len[b] + i - shift;   // visible iff key_pos <= limit
  }
};

// Paged cache: slot t of row b lives in page block_tbl[b, t / page].
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  const int* block_tbl;
  const int* slot_pos;
  const int* q_pos;

  // A row with no valid slot gives 0 (the panel bodies' rule).
  __device__ __forceinline__ bool uniform(int) const { return false; }
  __device__ __forceinline__ int end(int, int, const Geometry& g) const { return g.tlen; }
  __device__ __forceinline__ long long row(int b, int t, int kh, const Geometry& g) const {
    const int phys = block_tbl[(long long)b * g.npg + t / g.page];
    return (((long long)phys * g.page + t % g.page) * g.hk + kh);
  }
  __device__ __forceinline__ int key_pos(int b, int t, const Geometry& g) const {
    return slot_pos[(long long)b * g.tlen + t];
  }
  __device__ __forceinline__ int limit(int b, int i, const Geometry& g) const {
    return g.causal ? q_pos[b] + i : 0x7fffffff;
  }
};

// grid (B*Hk, nsplit, ceil(K / KQ)); block kWarps*32 threads.
// q/out (B,K,H,dh) in T; part_* fp32 scratch of B*Hk*nsplit*K*G rows,
// used when nsplit > 1.
template <typename T, int DH, int G, int KQ, class KV>
__global__ void __launch_bounds__(kWarps * 32)
panel_split_kernel(const T* __restrict__ q, KV kv, Geometry geo, T* __restrict__ out,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc) {
  constexpr int EPL = DH / 32;
  constexpr int R = KQ * G;
  static_assert(R <= kMaxRows, "panel too tall for registers");
  __shared__ float sm_m[kWarps][R];
  __shared__ float sm_l[kWarps][R];
  __shared__ float sm_acc[kWarps][R][DH];

  const int bk = blockIdx.x;
  const int b = bk / geo.hk;
  const int kh = bk % geo.hk;
  const int split = blockIdx.y;
  const int qbase = blockIdx.z * KQ;
  const int nq = min(KQ, geo.kq - qbase);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = geo.hk * G;

  float qr[R][EPL];
#pragma unroll
  for (int qi = 0; qi < KQ; ++qi) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int qq = min(qbase + qi, geo.kq - 1);   // rows past nq are never stored
      const T* qp = q + (((long long)b * geo.kq + qq) * h + (long long)kh * G + gi) * DH
                    + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[qi * G + gi][e] = to_float(qp[e]);
    }
  }
  int lim[KQ];
#pragma unroll
  for (int qi = 0; qi < KQ; ++qi) lim[qi] = kv.limit(b, qbase + qi, geo);

  float m[R], l[R], acc[R][EPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const int t0 = split * geo.chunk;
  const int t1 = min(t0 + geo.chunk, kv.end(b, qbase + nq - 1, geo));
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int kp = kv.key_pos(b, t, geo);
    if (kp < 0) continue;                      // empty slot: never loaded
    const long long off = kv.row(b, t, kh, geo) * DH + lane * EPL;
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kr[e] = to_float(kv.k[off + e]);
      vr[e] = to_float(kv.v[off + e]);
    }
#pragma unroll
    for (int qi = 0; qi < KQ; ++qi) {
      if (qi >= nq || kp > lim[qi]) continue;  // uniform across the warp
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int r = qi * G + gi;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[r][e] * kr[e];
        s = warp_sum(s) * geo.scale;
        const float m_new = fmaxf(m[r], s);
        const float p = __expf(s - m_new);
        const float corr = __expf(m[r] - m_new);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + p * vr[e];
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * DH; i += kWarps * 32) {
    const int r = i / DH;
    const int d = i % DH;
    const int qi = r / G;
    const int gi = r % G;
    if (qi >= nq) continue;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * c;
      asum += sm_acc[w][r][d] * c;
    }
    const int query = qbase + qi;
    if (geo.nsplit == 1) {
      store_float(out + (((long long)b * geo.kq + query) * h + (long long)kh * G + gi) * DH + d,
                  asum / fmaxf(lsum, 1e-30f));
    } else {
      const long long slot = (((long long)bk * geo.nsplit + split) * geo.kq + query) * G + gi;
      part_acc[slot * DH + d] = asum;
      if (d == 0) {
        part_m[slot] = mx;
        part_l[slot] = lsum;
      }
    }
  }
}

// Merges the nsplit partial states of one (b, KV head) into the output.
// grid (B*Hk); 128 threads.
template <typename T, int DH, int G>
__global__ void panel_merge_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc, Geometry geo,
                                   T* __restrict__ out) {
  const int bk = blockIdx.x;
  const int b = bk / geo.hk;
  const int kh = bk % geo.hk;
  const int h = geo.hk * G;
  const int rows = geo.kq * G;
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH;
    const int d = i % DH;
    float mx = kNeg;
    for (int s = 0; s < geo.nsplit; ++s)
      mx = fmaxf(mx, part_m[((long long)bk * geo.nsplit + s) * rows + r]);
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < geo.nsplit; ++s) {
      const long long slot = ((long long)bk * geo.nsplit + s) * rows + r;
      const float c = __expf(part_m[slot] - mx);
      lsum += part_l[slot] * c;
      asum += part_acc[slot * DH + d] * c;
    }
    const int query = r / G;
    const int gi = r % G;
    store_float(out + (((long long)b * geo.kq + query) * h + (long long)kh * G + gi) * DH + d,
                asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DH, int G, int KQ, class KV>
void launch_panel(const void* q, const KV& kv, const Geometry& geo, int batch, void* out,
                  void* part_m, void* part_l, void* part_acc, cudaStream_t stream) {
  dim3 grid(batch * geo.hk, geo.nsplit, (geo.kq + KQ - 1) / KQ);
  panel_split_kernel<T, DH, G, KQ, KV><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), kv, geo, static_cast<T*>(out),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc));
  if (geo.nsplit > 1) {
    panel_merge_kernel<T, DH, G><<<batch * geo.hk, 128, 0, stream>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), geo, static_cast<T*>(out));
  }
}

template <typename T, int DH, int G, template <typename> class KVT>
bool launch_kq(int kqp, const void* q, const KVT<T>& kv, const Geometry& geo, int batch,
               void* out, void* part_m, void* part_l, void* part_acc, cudaStream_t stream) {
  switch (kqp) {
    case 1: launch_panel<T, DH, G, 1>(q, kv, geo, batch, out, part_m, part_l, part_acc, stream); return true;
    case 2: launch_panel<T, DH, G, 2>(q, kv, geo, batch, out, part_m, part_l, part_acc, stream); return true;
    case 4:
      if constexpr (G <= 4) {
        launch_panel<T, DH, G, 4>(q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
        return true;
      }
      return false;
    default: return false;
  }
}

template <typename T, int DH, template <typename> class KVT>
bool launch_g(int g, int kqp, const void* q, const KVT<T>& kv, const Geometry& geo, int batch,
              void* out, void* part_m, void* part_l, void* part_acc, cudaStream_t stream) {
  switch (g) {
    case 1: return launch_kq<T, DH, 1, KVT>(kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    case 2: return launch_kq<T, DH, 2, KVT>(kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    case 4: return launch_kq<T, DH, 4, KVT>(kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    case 8: return launch_kq<T, DH, 8, KVT>(kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    default: return false;
  }
}

// kqp queries per panel: 1, 2, or 4 where G <= 4 (ops.launch_plan's values).
template <typename T, template <typename> class KVT>
bool launch_dh(int dh, int g, int kqp, const void* q, const KVT<T>& kv, const Geometry& geo,
               int batch, void* out, void* part_m, void* part_l, void* part_acc,
               cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_g<T, 64, KVT>(g, kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    case 128: return launch_g<T, 128, KVT>(g, kqp, q, kv, geo, batch, out, part_m, part_l, part_acc, stream);
    default: return false;
  }
}

}  // namespace panel
}  // namespace repro_torch
