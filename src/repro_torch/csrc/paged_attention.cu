// Decode attention over a paged KV pool, for Hopper (sm_90a): one query per
// row (paged_decode_attention_launch) or a verify block of K queries per
// row (paged_decode_attention_block_launch).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:
//   paged_decode_attention_pallas (body _kernel): slots with slot_pos < 0
//     are masked;
//   paged_decode_attention_block_pallas (body _kernel_block): query i keeps
//     slot_pos >= 0 && slot_pos <= q_pos + i.
// Each row's K/V are read through its block table, page block_tbl[b, j]
// of the (P+1, page, Hk, dh) pool holding logical slots [j*page, (j+1)*page);
// the dense cache is never built.  fp32 scores, softmax and accumulation;
// output in the input dtype.
//
// What bounds it on an H100: bytes, the row's valid slots read once for all
// queries.  bf16 runs on the tensor cores (panel_mma.cuh: cp.async gather of
// 64-slot tiles, mma.sync for both products, splits merged inside a
// thread-block cluster); fp32 on the CUDA cores (attention_panel.cuh).  A row with no
// valid slot gives 0 in both.

#include "attention_panel.cuh"
#include "panel_mma.cuh"

namespace {

int launch_paged(const void* q, const void* kp, const void* vp, const void* block_tbl,
                 const void* slot_pos, const void* q_pos, void* out, void* part_m,
                 void* part_l, void* part_acc, int batch, int kq, int cap, int hk, int g,
                 int dh, int page, int npg, int causal, int dtype, int chunk, int nsplit,
                 int kqp, float scale, void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::panel;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geometry geo{kq, cap, hk, page, npg, causal, chunk, nsplit, scale};
  const int* tbl = static_cast<const int*>(block_tbl);
  const int* sp = static_cast<const int*>(slot_pos);
  const int* qp = static_cast<const int*>(q_pos);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    PagedKV<float> kv{static_cast<const float*>(kp), static_cast<const float*>(vp), tbl, sp,
                      qp};
    if (launch_dh<float, PagedKV>(dh, g, kqp, q, kv, geo, batch, out, part_m, part_l, part_acc,
                                  s))
      rc = 0;
  } else if (dtype == kBFloat16) {
    PagedKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(kp),
                              static_cast<const __nv_bfloat16*>(vp), tbl, sp, qp};
    panel_mma::Args args{g, kqp};
    rc = panel_mma::launch(dh, q, kv, geo, args, batch, out, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (B,H,dh) contiguous in `dtype`; kp/vp (P+1,page,Hk,dh); block_tbl
// (B,npg) and slot_pos (B,cap) int32.  `chunk`, `nsplit` and `kqp`
// (queries per panel) come from ops.launch_plan.  fp32 splits the slots
// into `nsplit` chunks of `chunk` and merges in a second launch through
// part_*, fp32 scratch of B*Hk*nsplit*G rows (used when nsplit > 1).  bf16
// takes `chunk` a multiple of 64 slots and merges its splits (at most 8)
// inside their thread-block cluster; it reads no part_*.  Returns
// cudaGetLastError().
extern "C" int paged_decode_attention_launch(const void* q, const void* kp, const void* vp,
                                             const void* block_tbl, const void* slot_pos,
                                             void* out, void* part_m, void* part_l,
                                             void* part_acc, int batch, int cap, int hk,
                                             int g, int dh, int page, int npg, int dtype,
                                             int chunk, int nsplit, int kqp, float scale,
                                             void* stream) {
  return launch_paged(q, kp, vp, block_tbl, slot_pos, nullptr, out, part_m, part_l, part_acc,
                      batch, 1, cap, hk, g, dh, page, npg, 0, dtype, chunk, nsplit, kqp, scale,
                      stream);
}

// As above with q/out (B,K,H,dh), q_pos (B,) int32, the absolute position
// of each row's first query, and scratch of B*Hk*nsplit*K*G rows.
extern "C" int paged_decode_attention_block_launch(
    const void* q, const void* kp, const void* vp, const void* block_tbl, const void* slot_pos,
    const void* q_pos, void* out, void* part_m, void* part_l, void* part_acc, int batch,
    int kq, int cap, int hk, int g, int dh, int page, int npg, int dtype, int chunk, int nsplit,
    int kqp, float scale, void* stream) {
  return launch_paged(q, kp, vp, block_tbl, slot_pos, q_pos, out, part_m, part_l, part_acc,
                      batch, kq, cap, hk, g, dh, page, npg, 1, dtype, chunk, nsplit, kqp, scale,
                      stream);
}
