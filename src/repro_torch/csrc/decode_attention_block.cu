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
// What bounds it on an H100: bytes, the cache read once for all K queries
// (see attention_panel.cuh for the design and the rule for a query with no
// visible slot, which cannot occur here since cache_len >= 0).

#include "attention_panel.cuh"

// q/out (B,K,H,dh), k/v (B,T,Hk,dh) contiguous in `dtype`; cache_len (B,)
// int32; part_m/part_l (B*Hk*nsplit*K*g,) and part_acc (... * dh) fp32
// scratch, read only when nsplit > 1.  Returns cudaGetLastError().
extern "C" int decode_attention_block_launch(const void* q, const void* k, const void* v,
                                             const void* cache_len, void* out, void* part_m,
                                             void* part_l, void* part_acc, int batch, int kq,
                                             int tlen, int hk, int g, int dh, int dtype,
                                             int chunk, int nsplit, float scale, void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::panel;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geometry geo{kq, tlen, hk, 1, 1, 0, chunk, nsplit, scale};
  bool ok = false;
  if (dtype == kFloat32) {
    DenseKV<float> kv{static_cast<const float*>(k), static_cast<const float*>(v),
                      static_cast<const int*>(cache_len)};
    ok = launch_dh<float, DenseKV>(dh, g, pick_kq(kq, g), q, kv, geo, batch, out, part_m,
                                   part_l, part_acc, s);
  } else if (dtype == kBFloat16) {
    DenseKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                              static_cast<const __nv_bfloat16*>(v),
                              static_cast<const int*>(cache_len)};
    ok = launch_dh<__nv_bfloat16, DenseKV>(dh, g, pick_kq(kq, g), q, kv, geo, batch, out,
                                           part_m, part_l, part_acc, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
