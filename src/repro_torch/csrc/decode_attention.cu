// Single-token decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _kernel).  Computes, for each row b and query head h,
//   softmax_t(q[b,h] . k[b,t,h//g] * scale  masked to t < cache_len[b]) @ v
// with fp32 scores, softmax and accumulation; output in the input dtype.
// A row with cache_len <= 0 has every slot masked, and the reference's
// softmax over its finite -1e30 scores is then uniform: the average of V
// over all T slots.  Both routes keep that rule.
//
// What bounds it on an H100: bytes.  At the main-path shape (B=8, H=32,
// Hk=8, dh=128, T ~ 100-300 slots, bf16) the cache read is 2*B*T*Hk*dh*2
// bytes (~4 MB at T=128, ~1.3 us at 3.35 TB/s) against ~17 MFLOP; in
// practice a launch of a few microseconds.
//
// bf16 runs the tensor-core panel body (panel_mma.cuh) with one query per
// row, through DenseKV with shift 1 (t < cache_len): cp.async tiles of 64
// slots, mma.sync for both products, the splits merged inside their
// thread-block cluster; one launch, no scratch.  This entry alone also
// takes dh 256 (recurrentgemma-9b's local attention: H 16 on one KV head,
// G 16, over its 2,048-slot ring): a decode step of B 4 reads 8.4 MB of K/V
// a layer, 2.5 us at 3.35 TB/s; one block a SM at that width.
//
// fp32 (tensor cores would mean TF32) runs the CUDA-core kernels below:
//  * One block per (b, kv head, T split).  The g = H/Hk query heads of a
//    KV group are one register panel, so each K/V row is read from device
//    memory once per group (the Pallas kernel's GQA panel).
//  * The TPU walked T as a sequential grid axis with a running max/sum in
//    scratch.  Hopper blocks run in parallel and carry nothing across, so
//    T is split into chunks, each block writes a partial (m, l, acc), and
//    a second small kernel merges the splits.  With one split the first
//    kernel writes the normalised output directly.
//  * Inside a block, each warp takes every WARPS-th key; a lane holds
//    dh/32 consecutive elements, the dot product is a warp shuffle
//    reduction, and each warp keeps its own online softmax.  The warps'
//    states are merged through shared memory at the end.
//  * dh 32 (recurrentgemma-9b's smoke config, fp32 only): one element a
//    lane, the general body.
//  * dh 16 (the serve CLI's default tiny stack, fp32 only): a key's row is
//    16 elements, one a lane, so a warp takes two keys at once, a
//    half-warp each, with its own shuffle reduction (offsets below 16 stay
//    inside the half) and its own online softmax; every lane joins every
//    shuffle, and a half past the split's last key skips only the update.
//  * dh 24 (nemotron-4-340b's smoke config; the small LM of the
//    reference's examples/serve_e2e.py, fp32 only): the same with 8 lanes
//    of 3 elements a key (common.cuh's row_lanes), four keys a warp; a
//    row is 96 bytes, so a lane's elements are only 4-byte aligned and
//    every load is a scalar one.

#include "common.cuh"
#include "panel_mma.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    int tlen, int hk, int chunk, int nsplit, float scale,
                    T* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int LANES = row_lanes(DH);          // lanes per key: 32, 16 at dh 16, 8 at dh 24
  constexpr int EPL = DH / LANES;               // elements of dh per lane
  constexpr int SUBS = 32 / LANES;              // keys a warp takes at once
  constexpr int WORKERS = kWarps * SUBS;        // online-softmax states per block
  __shared__ float sm_m[WORKERS][G];
  __shared__ float sm_l[WORKERS][G];
  __shared__ float sm_acc[WORKERS][G][DH];

  const int bk = blockIdx.x;
  const int b = bk / hk;
  const int kh = bk % hk;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LANES;                 // this lane's key of the warp's SUBS
  const int sl = lane % LANES;                  // its place in the key's row
  const int worker = warp * SUBS + sub;
  const int h = hk * G;

  // cache_len <= 0 leaves every slot masked: the reference's softmax over
  // all-NEG scores is then uniform over the whole cache, so visit every
  // slot with a constant NEG score.
  const int len = cache_len[b];
  const bool all_masked = len <= 0;
  const int t0 = split * chunk;
  int t1 = min(tlen, t0 + chunk);
  if (!all_masked) t1 = min(t1, len);

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * h + (size_t)kh * G + g) * DH + sl * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = to_float(qp[e]);
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // the warp walks the slots SUBS at a time, every lane in every shuffle
  for (int tw = t0 + warp * SUBS; tw < t1; tw += WORKERS) {
    const int t = tw + sub;
    const bool live = t < t1;
    const size_t row = (((size_t)b * tlen + (live ? t : tw)) * hk + kh) * DH + sl * EPL;
    float kv[EPL], vv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kv[e] = to_float(k[row + e]);
      vv[e] = to_float(v[row + e]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[g][e] * kv[e];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!live) continue;
      s = all_masked ? kNeg : s * scale;
      const float m_new = fmaxf(m[g], s);
      const float p = __expf(s - m_new);
      const float corr = __expf(m[g] - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + p * vv[e];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sl == 0) {
      sm_m[worker][g] = m[g];
      sm_l[worker][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[worker][g][sl * EPL + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * DH; i += kWarps * 32) {
    const int g = i / DH;
    const int d = i % DH;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < WORKERS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < WORKERS; ++w) {
      const float c = __expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      asum += sm_acc[w][g][d] * c;
    }
    if (nsplit == 1) {
      store_float(out + ((size_t)b * h + (size_t)kh * G + g) * DH + d,
                  asum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t slot = ((size_t)bk * nsplit + split) * G + g;
      part_acc[slot * DH + d] = asum;
      if (d == 0) {
        part_m[slot] = mx;
        part_l[slot] = lsum;
      }
    }
  }
}

// Merges the nsplit partial states of one (b, kv head) into the output.
template <typename T, int DH, int G>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    int hk, int nsplit, T* __restrict__ out) {
  const int bk = blockIdx.x;
  const int b = bk / hk;
  const int kh = bk % hk;
  const int h = hk * G;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x) {
    const int g = i / DH;
    const int d = i % DH;
    float mx = kNeg;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[((size_t)bk * nsplit + s) * G + g]);
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t slot = ((size_t)bk * nsplit + s) * G + g;
      const float c = __expf(part_m[slot] - mx);
      lsum += part_l[slot] * c;
      asum += part_acc[slot * DH + d] * c;
    }
    store_float(out + ((size_t)b * h + (size_t)kh * G + g) * DH + d, asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DH, int G>
void launch_typed(const void* q, const void* k, const void* v, const void* cache_len, void* out,
                  void* part_m, void* part_l, void* part_acc, int batch, int tlen, int hk,
                  int chunk, int nsplit, float scale, cudaStream_t stream) {
  dim3 grid(batch * hk, nsplit);
  decode_split_kernel<T, DH, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(cache_len), tlen, hk, chunk, nsplit, scale,
      static_cast<T*>(out), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc));
  if (nsplit > 1) {
    decode_merge_kernel<T, DH, G><<<batch * hk, 128, 0, stream>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), hk, nsplit, static_cast<T*>(out));
  }
}

template <typename T, int DH>
bool dispatch_g(int g, const void* q, const void* k, const void* v, const void* cache_len,
                void* out, void* part_m, void* part_l, void* part_acc, int batch, int tlen,
                int hk, int chunk, int nsplit, float scale, cudaStream_t stream) {
  switch (g) {
    case 1: launch_typed<T, DH, 1>(q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream); return true;
    case 2: launch_typed<T, DH, 2>(q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream); return true;
    case 4: launch_typed<T, DH, 4>(q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream); return true;
    case 8: launch_typed<T, DH, 8>(q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch_dh(int dh, int g, const void* q, const void* k, const void* v,
                 const void* cache_len, void* out, void* part_m, void* part_l, void* part_acc,
                 int batch, int tlen, int hk, int chunk, int nsplit, float scale,
                 cudaStream_t stream) {
  switch (dh) {
    case 16: return dispatch_g<T, 16>(g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream);
    case 24: return dispatch_g<T, 24>(g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream);
    case 32: return dispatch_g<T, 32>(g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream);
    case 64: return dispatch_g<T, 64>(g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream);
    case 128: return dispatch_g<T, 128>(g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch, tlen, hk, chunk, nsplit, scale, stream);
    default: return false;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,H,dh), k/v (B,T,Hk,dh) contiguous in `dtype`; cache_len (B,) int32;
// out (B,H,dh).  `chunk` and `nsplit` come from ops.launch_plan.  fp32:
// part_m/part_l (B*Hk*nsplit*g,) and part_acc (B*Hk*nsplit*g*dh,) fp32
// scratch, read only when nsplit > 1.  bf16: `chunk` a multiple of 64 slots,
// nsplit at most 8, q/k/v 16-byte aligned; no part_* is read; dh 256 (the
// hybrid's local attention) is taken here and by no other panel entry.
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cache_len, void* out, void* part_m,
                                       void* part_l, void* part_acc, int batch, int tlen,
                                       int hk, int g, int dh, int dtype, int chunk, int nsplit,
                                       float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    if (dispatch_dh<float>(dh, g, q, k, v, cache_len, out, part_m, part_l, part_acc, batch,
                           tlen, hk, chunk, nsplit, scale, s))
      rc = 0;
  } else if (dtype == kBFloat16) {
    panel::Geometry geo{1, tlen, hk, 1, 1, 0, chunk, nsplit, scale};
    panel::DenseKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                     static_cast<const __nv_bfloat16*>(v),
                                     static_cast<const int*>(cache_len), 1};
    rc = panel_mma::launch<true>(dh, q, kv, geo, panel_mma::Args{g, 1}, batch, out, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of `splits` blocks (1-8) of the bf16 body at dh 256 with
// `nt` n-tiles (1 or 2) and `smem` dynamic shared memory bytes that the
// card holds at once, into *clusters: what ops.launch_plan's
// WAVE_CLUSTERS_ONE_A_SM states.  Returns the CUDA error of the query.
extern "C" int panel_mma_wave_clusters_dh256(int nt, int splits, int smem, int* clusters) {
  using namespace repro_torch;
  using KV = panel::DenseKV<__nv_bfloat16>;
  if (splits < 1 || splits > panel_mma::kMaxSplits || (nt != 1 && nt != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return nt == 1 ? panel_mma::wave_clusters<256, 1, KV>(splits, smem, clusters)
                 : panel_mma::wave_clusters<256, 2, KV>(splits, smem, clusters);
}
