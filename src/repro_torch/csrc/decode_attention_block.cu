// Q-block (speculative verify) decode attention over a dense KV cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:
// decode_attention_block_pallas (body _kernel_block).  For each row b,
// query i of K and head h:
//   softmax_t(q[b,i,h] . k[b,t,h//g] * scale  masked to t < cache_len[b] + i + 1) @ v
// with fp32 scores, softmax and accumulation; output in the input dtype.
// cache_len counts the slots filled before the block; the block's own keys
// sit at slots cache_len + i, so the mask is causal inside the block.
//
// What bounds it on an H100: bytes, the cache read once for all K queries.
// bf16 runs the tensor-core panel body (panel_mma.cuh: cp.async tiles of 64
// slots, mma.sync for both products, the splits merged inside their
// thread-block cluster; one launch, no scratch); fp32 the CUDA-core panel
// body (attention_panel.cuh), since tensor cores would mean TF32.  Both
// read the cache through DenseKV with shift 0 (see attention_panel.cuh for
// the rule for a query with no visible slot, which cannot occur here since
// cache_len >= 0).

#include "attention_panel.cuh"
#include "panel_mma.cuh"

// q/out (B,K,H,dh), k/v (B,T,Hk,dh) contiguous in `dtype`; cache_len (B,)
// int32.  `chunk`, `nsplit` and `kqp` (queries per panel) come from
// ops.launch_plan.  fp32: part_m/part_l (B*Hk*nsplit*K*g,) and part_acc
// (... * dh) fp32 scratch, read only when nsplit > 1.  bf16: `chunk` a
// multiple of 64 slots, nsplit at most 8, q/k/v 16-byte aligned; no part_*
// is read.  Returns cudaGetLastError().
extern "C" int decode_attention_block_launch(const void* q, const void* k, const void* v,
                                             const void* cache_len, void* out, void* part_m,
                                             void* part_l, void* part_acc, int batch, int kq,
                                             int tlen, int hk, int g, int dh, int dtype,
                                             int chunk, int nsplit, int kqp, float scale,
                                             void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::panel;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geometry geo{kq, tlen, hk, 1, 1, 0, chunk, nsplit, scale};
  const int* len = static_cast<const int*>(cache_len);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    DenseKV<float> kv{static_cast<const float*>(k), static_cast<const float*>(v), len, 0};
    if (launch_dh<float, DenseKV>(dh, g, kqp, q, kv, geo, batch, out, part_m, part_l, part_acc,
                                  s))
      rc = 0;
  } else if (dtype == kBFloat16) {
    DenseKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                              static_cast<const __nv_bfloat16*>(v), len, 0};
    rc = panel_mma::launch(dh, q, kv, geo, panel_mma::Args{g, kqp}, batch, out, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of `splits` blocks (1-8) of the bf16 body at dh 128 with
// `nt` n-tiles (1 or 2) and `smem` dynamic shared memory bytes that the
// card holds at once, into *clusters: what ops.launch_plan's WAVE_CLUSTERS
// states.  Returns the CUDA error of the query.
extern "C" int panel_mma_wave_clusters(int nt, int splits, int smem, int* clusters) {
  using namespace repro_torch;
  using KV = panel::DenseKV<__nv_bfloat16>;
  if (splits < 1 || splits > panel_mma::kMaxSplits || (nt != 1 && nt != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return nt == 1 ? panel_mma::wave_clusters<128, 1, KV>(splits, smem, clusters)
                 : panel_mma::wave_clusters<128, 2, KV>(splits, smem, clusters);
}
