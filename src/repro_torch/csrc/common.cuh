// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// The JAX package's masking constant (models/attention.py NEG_INF): a
// finite -1e30, not -inf, so that a fully masked tile gives exp(0) = 1
// exactly as the reference recurrence does.
constexpr float kNeg = -1e30f;

// Element type codes shared with the Python wrappers.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lanes over which the fp32 CUDA-core attention bodies spread one cache
// slot's row of `dh` elements: the largest power of two that divides dh, at
// most 32 (dh 16: 16 lanes of 1 element, dh 24: 8 of 3, dh >= 32: 32).  A
// warp then takes 32 / row_lanes(dh) slots at once, one a sub-warp.
__host__ __device__ constexpr int row_lanes(int dh) { return (dh & -dh) < 32 ? (dh & -dh) : 32; }

// Sum over the LANES lanes of one sub-warp (offsets below LANES never leave
// it); every lane of the warp must call it.  At LANES 32 it is warp_sum.
template <int LANES>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Devices a process may launch on: the entries of the per-device tables below.
constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the current
// device (and, with `carveout`, ask for the largest shared-memory carveout).
// cudaFuncSetAttribute acts on the current device only, so `allowed` keeps
// one entry per device: one zero-initialised array per kernel instance.
template <class Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t smem, size_t* allowed,
                             bool carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

}  // namespace repro_torch
