// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels
// (flash_attention.cu, panel_mma.cuh): swizzled shared-memory tiles,
// cp.async, ldmatrix, movmatrix and mma.sync m16n8k16 in bf16 with fp32
// accumulators, for Hopper (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

// Bytes of one row of a [rows][DH] bf16 tile in shared memory: DH/8 16-byte
// chunks rounded up to a whole number of groups of 8, so that the swizzle
// below keeps every chunk inside its row.  At DH 64, 128 and 192 that is the
// row itself; at DH 80 (10 chunks) the row is padded to 128 columns, whose
// other 6 chunks are never written or read (256 bytes a row against 160: the
// price of conflict-free ldmatrix phases, paid in shared memory only).
__host__ __device__ constexpr int row_bytes(int dh) { return (dh / 8 + 7) / 8 * 8 * 16; }

// Byte offset of the 16-byte chunk `ch` of row `row` in a [rows][DH] bf16
// tile: chunks are XOR-swizzled by the row's low 3 bits, so the 8 rows an
// ldmatrix phase reads, and the rows cp.async writes, fall in 8 distinct
// bank groups.
template <int DH>
__device__ __forceinline__ int swz(int row, int ch) {
  return row * row_bytes(DH) + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; pred false zero-fills (src-size
// 0), reading nothing at `src`, which must still be a valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// Two 8x8 matrices: lanes 0-15 give the row addresses (the others' are
// ignored).
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// The transpose of an 8x8 bf16 matrix held as a warp fragment (lane l holds
// row l/4, columns 2(l%4) and 2(l%4)+1), returned in the same layout.
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace repro_torch
