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
// thread-block cluster; one launch, no scratch.
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
  constexpr int EPL = DH / 32;  // elements of dh per lane
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][DH];

  const int bk = blockIdx.x;
  const int b = bk / hk;
  const int kh = bk % hk;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
    const T* qp = q + ((size_t)b * h + (size_t)kh * G + g) * DH + lane * EPL;
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

  for (int t = t0 + warp; t < t1; t += kWarps) {
    const size_t row = (((size_t)b * tlen + t) * hk + kh) * DH + lane * EPL;
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
      s = all_masked ? kNeg : warp_sum(s) * scale;
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
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * DH; i += kWarps * 32) {
    const int g = i / DH;
    const int d = i % DH;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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
// nsplit at most 8, q/k/v 16-byte aligned; no part_* is read.  Returns
// cudaGetLastError() after the launches.
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
    rc = panel_mma::launch(dh, q, kv, geo, panel_mma::Args{g, 1}, batch, out, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
