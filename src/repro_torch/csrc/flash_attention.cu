// Causal / windowed GQA prefill attention with explicit positions, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _kernel).  What it computes is the function the JAX main path runs,
// _attend_xla_flash in src/repro/models/attention.py: the Pallas wrapper
// drops the positions and masks as if they started at 0, which is wrong for
// the TWEAK suffix (queries at P.., keys [prefix | suffix]).  So this kernel
// takes q_pos (B,Sq) and k_pos (B,Sk) and masks
//   allowed = (!causal || kp <= qp) && (window <= 0 || kp > qp - window)
// with the reference's padding conventions: keys past Sk (up to Sk_pad, a
// whole number of the model's flash key blocks) read as zeros at position
// 2**30.  Scores, softmax and accumulation are fp32; the online softmax
// visits keys in ascending order with the reference's finite -1e30 mask
// value, so appended fully masked keys are exact no-ops and a suffix over a
// stored prefix computes what the inline prefill computes.
//
// What bounds it on an H100: at the main-path shapes (B=8, Sq <= 128,
// H=32, dh=128) the work is ~0.5-2 GFLOP against ~10 MB of q/k/v/out, far
// below either roof; the kernel runs for a few microseconds to tens of
// microseconds and launch latency is a large share of it.  The FMA loops
// below run on the CUDA cores at a fraction of the tensor-core rate; that
// is the price of the first, simple version (a wgmma/TMA kernel is later
// work).
//
// Design: one block per (16-query tile, head, row).  The block stages its
// Q tile once and walks 32-key K/V tiles through shared memory (fp32,
// padded rows to avoid bank conflicts).  Eight threads own one query row:
// each computes four scores, the row max and sum are 8-lane shuffles, and
// each thread keeps dh/8 output accumulators in registers.  Heads of one
// KV group re-read the same K/V tile, which L2 serves.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 16;           // query rows per block
constexpr int kBK = 32;           // keys per shared-memory tile
constexpr int kTPR = 8;           // threads per query row
constexpr int kThreads = kBQ * kTPR;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 T* __restrict__ out, int sq, int sk, int sk_pad, int h, int hk,
                 int causal, int window, float scale) {
  __shared__ float sQ[kBQ][DH + 1];
  __shared__ float sK[kBK][DH + 1];
  __shared__ float sV[kBK][DH];
  __shared__ float sP[kBQ][kBK + 1];
  __shared__ int sKp[kBK];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kh = head / (h / hk);
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int sub = tid % kTPR;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int rr = i / DH;
    const int d = i % DH;
    const int qi = q0 + rr;
    sQ[rr][d] = qi < sq ? to_float(q[(((size_t)b * sq + qi) * h + head) * DH + d]) : 0.f;
  }
  const int qp = (q0 + r < sq) ? q_pos[(size_t)b * sq + q0 + r] : -1;

  constexpr int NACC = DH / kTPR;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  for (int kb = 0; kb < sk_pad; kb += kBK) {
    __syncthreads();  // previous tile fully consumed (and sQ written, first time)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH;
      const int d = i % DH;
      const int kj = kb + c;
      float kx = 0.f, vx = 0.f;
      if (kj < sk) {
        const size_t off = (((size_t)b * sk + kj) * hk + kh) * DH + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      sK[c][d] = kx;
      sV[c][d] = vx;
    }
    for (int i = tid; i < kBK; i += kThreads) {
      const int kj = kb + i;
      sKp[i] = kj < sk ? k_pos[(size_t)b * sk + kj] : (1 << 30);
    }
    __syncthreads();

    float s[kBK / kTPR];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK / kTPR; ++j) {
      const int c = sub + kTPR * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot += sQ[r][d] * sK[c][d];
      const int kp = sKp[c];
      const bool allowed = (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      s[j] = allowed ? dot * scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / kTPR; ++j) {
      const float p = __expf(s[j] - m_new);
      sP[r][sub + kTPR * j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's 8 threads share one warp

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = sub + kTPR * i;
      float a = acc[i] * corr;
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a += sP[r][c] * sV[c][d];
      acc[i] = a;
    }
  }

  if (q0 + r < sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * sq + q0 + r) * h + head) * DH;
#pragma unroll
    for (int i = 0; i < NACC; ++i) store_float(o + sub + kTPR * i, acc[i] * inv);
  }
}

template <typename T, int DH>
void launch_typed(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* k_pos, void* out, int batch, int sq, int sk, int sk_pad, int h,
                  int hk, int causal, int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, h, batch);
  flash_fwd_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<T*>(out),
      sq, sk, sk_pad, h, hk, causal, window, scale);
}

template <typename T>
bool dispatch_dh(int dh, const void* q, const void* k, const void* v, const void* q_pos,
                 const void* k_pos, void* out, int batch, int sq, int sk, int sk_pad, int h,
                 int hk, int causal, int window, float scale, cudaStream_t stream) {
  switch (dh) {
    case 64: launch_typed<T, 64>(q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h, hk, causal, window, scale, stream); return true;
    case 128: launch_typed<T, 128>(q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h, hk, causal, window, scale, stream); return true;
    default: return false;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,Sq,H,dh), k/v (B,Sk,Hk,dh), out (B,Sq,H,dh) contiguous in `dtype`;
// q_pos (B,Sq), k_pos (B,Sk) int32.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      int batch, int sq, int sk, int sk_pad, int h, int hk,
                                      int dh, int dtype, int causal, int window, float scale,
                                      void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kFloat32) {
    ok = dispatch_dh<float>(dh, q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h, hk,
                            causal, window, scale, s);
  } else if (dtype == kBFloat16) {
    ok = dispatch_dh<__nv_bfloat16>(dh, q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h,
                                    hk, causal, window, scale, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
