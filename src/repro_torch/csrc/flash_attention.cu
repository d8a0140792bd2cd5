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
// What bounds it on an H100: bytes.  At the main-path shapes (llama-3.1-8b:
// H 32, Hk 8, dh 128, bf16; B 8, a 128-token suffix over a 45-token prefix,
// or a 64-token prefill) q, k, v and out are ~10-22 MB, 3-7 us at 3.35 TB/s,
// against 0.5-1.8 GFLOP, ~2 us at the bf16 tensor-core rate; fp32 FMAs on
// the CUDA cores with both operands in shared memory would be bound by
// shared-memory bandwidth instead.
//
// Design of the bf16 path (flash_fwd_mma_kernel):
//  * GQA packing: one block per (row b, KV head kh, tile of 64 (query, head)
//    pairs).  For a fixed query the g = H/Hk heads of a KV group are adjacent
//    in memory, so the tile is 64/g queries x g heads, and each K/V tile is
//    staged once for all heads of its group.
//  * Tensor cores: four warps of 16 rows each run mma.sync m16n8k16 (bf16
//    inputs, fp32 accumulators).  Q fragments stay in registers for the whole
//    loop (ldmatrix); S = Q K^T per 64-key tile; P is rounded to bf16 for
//    P V (ldmatrix.trans for V), as flash attention kernels do; the rounding
//    of P (relative 2**-9) stays well inside the bf16 output tolerance.
//  * Asynchronous copies: K/V tiles of 64 keys come in with cp.async (16
//    bytes a thread) into a double-buffered, XOR-swizzled ring; keys past Sk
//    are zero-filled (src-size 0) and sit at position 2**30.
//  * Online softmax in registers on the mma accumulator layout: a row's
//    scores sit in the 4 lanes of a quad, so the row max takes 2 shuffles;
//    the sum is kept per lane and reduced once at the end.
//  * Key tiles are 64 keys counted from key 0 whatever Sq is, so a row's
//    arithmetic does not depend on the other rows of its block.  A tile that
//    is masked for every row of the block is skipped, decided from the
//    positions: after a row's first allowed key a masked key adds
//    exp(kNeg - m) = 0 with corr = 1, and before it whatever was summed is
//    multiplied by exp(kNeg - m_real) = 0, so skipping is bit-exact for every
//    row that has an allowed key.  A row with none (the uniform average over
//    Sk_pad keys, as the reference gives) is recomputed from V at the end.
//  * Head dims 64, 80, 128, 192 and 256 (llama, qwen and deepseek at 128,
//    danube at 80, nemotron at 192, recurrentgemma's local attention at
//    256) and any G = H/Hk: the tile is cut by pairs, so G 7 and 12 only
//    change which (query, head) a row holds.  Q and the output take DH/16
//    k-steps (5 at dh 80), one ldmatrix each; the dh-80 rows sit in
//    128-column shared-memory rows (mma.cuh's row_bytes) so the swizzle
//    stays inside them.  At dh 192 the tiles take 123 KB: one block a SM.
//  * dh 256 (tiles of 164 KB, one block a SM): one warp's O accumulator
//    over the whole width would be 128 fp32 registers a thread beside the
//    scores, and the body would spill.  So each 16-row slab has two warps
//    (8 warps a block), each holding half of the output's columns; both
//    compute the slab's whole S = Q K^T and the same online softmax (the
//    same arithmetic on the same inputs, so the same m and l), and each
//    runs P V for its half.  The duplicated Q K^T is a third more tensor
//    work than one warp would do: the price of no spills, paid in an
//    instance bound by bytes at the main shapes.
//
// fp32 inputs keep the CUDA-core body (flash_fwd_simt_kernel): tensor cores
// would mean TF32, which breaks the fp32 contract (1e-5).  fp32 appears in
// the tests, the small card engine and the train CLI's smoke configs (head
// dims 16, 24 and 32, fp32-only instances), never on a full-width path.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

// ------------------------------------------------------------ fp32 (SIMT)

constexpr int kBQ = 16;           // query rows per block
constexpr int kBK = 32;           // keys per shared-memory tile
constexpr int kTPR = 8;           // threads per query row
constexpr int kThreads = kBQ * kTPR;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
      s[j] = kb + c >= sk_pad ? -CUDART_INF_F : allowed ? dot * scale : kNeg;
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

// ------------------------------------------------------------ bf16 (mma.sync)

constexpr int kBM = 64;              // (query, head) rows per block: 4 slabs of 16
constexpr int kBN = 64;              // keys per tile
constexpr int kSlabs = kBM / 16;
constexpr int kKeyPadPos = 1 << 30;  // position of the keys past Sk

// warps that share a 16-row slab, each holding DH / kColSplit output columns
__host__ __device__ constexpr int col_split(int dh) { return dh > 192 ? 2 : 1; }
__host__ __device__ constexpr int mma_threads(int dh) { return kSlabs * col_split(dh) * 32; }

// Shared memory of one block: Q tile, then two (K, V) tile buffers, then the
// key positions of both buffers, then one flag per key tile (dynamic).
template <int DH>
struct MmaSmem {
  static constexpr int kRowBytes = row_bytes(DH);
  static constexpr int kTileBytes = kBN * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK0 = kBM * kRowBytes;
  static constexpr int kV0 = kK0 + kTileBytes;
  static constexpr int kBufStride = 2 * kTileBytes;       // (K, V) of one buffer
  static constexpr int kKpos = kK0 + 2 * kBufStride;      // int [2][kBN]
  static constexpr int kFlags = kKpos + 2 * kBN * 4;      // unsigned char [ntiles]
  static size_t bytes(int ntiles) { return kFlags + ((ntiles + 15) / 16) * 16; }
};

// Two blocks a SM up to dh 128; at dh 192 and 256 a block's tiles (123 and
// 164 KB) leave room for one, which may then take every register it needs.
template <int DH>
__global__ void __launch_bounds__(mma_threads(DH), DH > 128 ? 1 : 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ out, int sq,
                     int sk, int sk_pad, int h, int hk, int causal, int window,
                     float scale) {
  using L = MmaSmem<DH>;
  constexpr int kChunks = DH / 8;      // 16-byte chunks per row
  constexpr int kMmaThreads = mma_threads(DH);
  constexpr int kCols = DH / col_split(DH);   // output columns of one warp
  extern __shared__ __align__(128) unsigned char smem[];
  int* sKp = reinterpret_cast<int*>(smem + L::kKpos);
  unsigned char* sFlag = smem + L::kFlags;
  __shared__ int sQpMin, sQpMax;

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int g = h / hk;
  const int pairs = sq * g;                  // (query, head) rows of this (b, kh)
  const int p0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slab = warp % kSlabs;      // the warp's 16 rows
  const int col0 = warp / kSlabs * kCols;   // and its first output column
  const int ntiles = (sk_pad + kBN - 1) / kBN;

  // --- the Q tile, in flight while the tile flags are worked out (it joins
  // the first tile's copy group)
  {
    const uint32_t sq0 = smem_u32(smem + L::kQ);
    for (int c = tid; c < kBM * kChunks; c += kMmaThreads) {
      const int row = c / kChunks, ch = c % kChunks;
      const int p = p0 + row;
      const bool in = p < pairs;
      const int qi = in ? p / g : 0, hh = kh * g + (in ? p % g : 0);
      cp_async16(sq0 + swz<DH>(row, ch), q + (((size_t)b * sq + qi) * h + hh) * DH + ch * 8,
                 in);
    }
  }
  // --- which key tiles any row of the block may attend to
  if (tid == 0) {
    sQpMin = 0x7fffffff;
    sQpMax = -0x7fffffff - 1;
  }
  for (int t = tid; t < ntiles; t += kMmaThreads) sFlag[t] = 0;
  // the first two key positions of this thread load beside the query's
  const int* kpos_b = k_pos + (size_t)b * sk;
  const int kp0 = tid < sk ? kpos_b[tid] : kKeyPadPos;
  const int kp1 = tid + kMmaThreads < sk ? kpos_b[tid + kMmaThreads] : kKeyPadPos;
  const int qp_mine = tid < kBM && p0 + tid < pairs ? q_pos[(size_t)b * sq + (p0 + tid) / g] : 0;
  __syncthreads();
  if (tid < kBM && p0 + tid < pairs) {
    atomicMin(&sQpMin, qp_mine);
    atomicMax(&sQpMax, qp_mine);
  }
  __syncthreads();
  const int qmin = sQpMin, qmax = sQpMax;
  // conservative: some row of the block may allow a key at position kp
  auto wanted = [&](int kp) {
    return (!causal || kp <= qmax) && (window <= 0 || kp > qmin - window);
  };
  if (tid < sk_pad && wanted(kp0)) sFlag[tid / kBN] = 1;
  if (tid + kMmaThreads < sk_pad && wanted(kp1)) sFlag[(tid + kMmaThreads) / kBN] = 1;
  for (int j = tid + 2 * kMmaThreads; j < sk_pad; j += kMmaThreads)
    if (wanted(j < sk ? kpos_b[j] : kKeyPadPos)) sFlag[j / kBN] = 1;
  __syncthreads();

  // --- asynchronous loads
  const __nv_bfloat16* kbase = k + ((size_t)b * sk * hk + kh) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * sk * hk + kh) * DH;
  auto load_tile = [&](int t, int buf) {
    const uint32_t sk0 = smem_u32(smem + L::kK0 + buf * L::kBufStride);
    const uint32_t sv0 = smem_u32(smem + L::kV0 + buf * L::kBufStride);
    for (int c = tid; c < kBN * kChunks; c += kMmaThreads) {
      const int row = c / kChunks, ch = c % kChunks;
      const int kj = t * kBN + row;
      const bool in = kj < sk;
      const size_t off = (size_t)(in ? kj : 0) * hk * DH + ch * 8;
      cp_async16(sk0 + swz<DH>(row, ch), kbase + off, in);
      cp_async16(sv0 + swz<DH>(row, ch), vbase + off, in);
    }
    if (tid < kBN) {
      const int kj = t * kBN + tid;
      sKp[buf * kBN + tid] = kj < sk ? k_pos[(size_t)b * sk + kj] : kKeyPadPos;
    }
  };
  auto next_tile = [&](int t) {
    ++t;
    while (t < ntiles && !sFlag[t]) ++t;
    return t;
  };

  int t = next_tile(-1);
  if (t < ntiles) load_tile(t, 0);
  cp_async_commit();

  // this lane's two rows of the slab's 16 (mma accumulator layout)
  const int r_lo = slab * 16 + lane / 4;
  const int r_hi = r_lo + 8;
  const int qp_lo = p0 + r_lo < pairs ? q_pos[(size_t)b * sq + (p0 + r_lo) / g] : -1;
  const int qp_hi = p0 + r_hi < pairs ? q_pos[(size_t)b * sq + (p0 + r_hi) / g] : -1;
  const int tq = lane % 4;

  // the Q tile's A fragments stay in registers for the whole loop up to dh
  // 128; at dh 192 they would spill (48 registers beside the 96 of acc), so
  // each k-step rereads its own from the Q tile, as at dh 256
  constexpr bool kQRegs = DH <= 128;
  uint32_t qf[kQRegs ? DH / 16 : 1][4];
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  int visited = 0;

  for (int it = 0; t < ntiles; ++it) {
    const int buf = it & 1;
    const int tn = next_tile(t);
    if (tn < ntiles) load_tile(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* sK = smem + L::kK0 + buf * L::kBufStride;
    const unsigned char* sV = smem + L::kV0 + buf * L::kBufStride;
    const int* kp = sKp + buf * kBN;

    const unsigned char* sQ = smem + L::kQ;
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(smem_u32(sQ + swz<DH>(slab * 16 + (lane & 15), 2 * kk + (lane >> 4))),
                  qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      }
    }

    // S = Q K^T for 64 keys: 8 accumulator tiles of 16 x 8
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
        qa[0] = qf[kk][0];
        qa[1] = qf[kk][1];
        qa[2] = qf[kk][2];
        qa[3] = qf[kk][3];
      } else {
        ldsm_x4(smem_u32(sQ + swz<DH>(slab * 16 + (lane & 15), 2 * kk + (lane >> 4))),
                qa[0], qa[1], qa[2], qa[3]);
      }
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_u32(sK + swz<DH>(key, 2 * kk + ((lane >> 3) & 1))), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa, b0, b1);
        mma_bf16(s[2 * np + 1], qa, b2, b3);
      }
    }

    // mask, online softmax (a row's 64 scores live in one quad)
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);
        const int qp = e < 2 ? qp_lo : qp_hi;
        const int kpos = kp[c];
        const bool allowed = (!causal || kpos <= qp) && (window <= 0 || kpos > qp - window);
        float x = allowed ? s[j][e] * scale : kNeg;
        if (t * kBN + c >= sk_pad) x = -CUDART_INF_F;   // past the padded keys: no key
        s[j][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = __expf(m_lo - mn_lo), c_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn_lo);
      s[j][1] = __expf(s[j][1] - mn_lo);
      s[j][2] = __expf(s[j][2] - mn_hi);
      s[j][3] = __expf(s[j][3] - mn_hi);
      ps_lo += s[j][0] + s[j][1];
      ps_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * c_lo + ps_lo;
    l_hi = l_hi * c_hi + ps_hi;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
    }

    // O += P V over this warp's columns: P from the accumulators (bf16), V
    // through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < kCols / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(sV + swz<DH>(key, col0 / 8 + 2 * dp + (lane >> 4))), b0, b1, b2,
                  b3);
        mma_bf16(acc[2 * dp], pa, b0, b1);
        mma_bf16(acc[2 * dp + 1], pa, b2, b3);
      }
    }
    ++visited;
    __syncthreads();   // this buffer is refilled two tiles on
    t = tn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // a row with no allowed key at all: the uniform average over sk_pad keys
  // (past Sk they are zeros), recomputed here when masked tiles were skipped
  if (visited < ntiles) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float mrow = half ? m_hi : m_lo;
      if (mrow != kNeg) continue;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < sk; ++j) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              vbase + (size_t)j * hk * DH + col0 + n * 8 + 2 * tq);
          a0 += __low2float(x);
          a1 += __high2float(x);
        }
        acc[n][2 * half] = a0;
        acc[n][2 * half + 1] = a1;
      }
      if (half) l_hi = static_cast<float>(sk_pad);
      else l_lo = static_cast<float>(sk_pad);
    }
  }

  // out = acc / l, staged through the Q tile for 16-byte stores
  __syncthreads();
  unsigned char* sO = smem + L::kQ;
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sO + swz<DH>(r_lo, col0 / 8 + n) + 4 * tq) =
        pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(sO + swz<DH>(r_hi, col0 / 8 + n) + 4 * tq) =
        pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  __syncthreads();
  for (int c = tid; c < kBM * kChunks; c += kMmaThreads) {
    const int row = c / kChunks, ch = c % kChunks;
    const int p = p0 + row;
    if (p >= pairs) continue;
    const int qi = p / g, hh = kh * g + p % g;
    *reinterpret_cast<uint4*>(out + (((size_t)b * sq + qi) * h + hh) * DH + ch * 8) =
        *reinterpret_cast<const uint4*>(sO + swz<DH>(row, ch));
  }
}

// ------------------------------------------------------------ launch

template <int DH>
void launch_simt(const void* q, const void* k, const void* v, const void* q_pos,
                 const void* k_pos, void* out, int batch, int sq, int sk, int sk_pad, int h,
                 int hk, int causal, int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, h, batch);
  flash_fwd_simt_kernel<float, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<float*>(out),
      sq, sk, sk_pad, h, hk, causal, window, scale);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* q_pos,
               const void* k_pos, void* out, int batch, int sq, int sk, int sk_pad, int h,
               int hk, int causal, int window, float scale, cudaStream_t stream) {
  const int ntiles = (sk_pad + kBN - 1) / kBN;
  const size_t smem = MmaSmem<DH>::bytes(ntiles);
  static size_t allowed[kMaxDevices] = {};   // the limit set so far, per device
  cudaError_t err = raise_smem_limit(flash_fwd_mma_kernel<DH>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq * (h / hk) + kBM - 1) / kBM, hk, batch);
  flash_fwd_mma_kernel<DH><<<grid, mma_threads(DH), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<__nv_bfloat16*>(out), sq, sk, sk_pad, h, hk,
      causal, window, scale);
  return 0;
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
  if (hk < 1 || h % hk != 0 || sk_pad < sk) return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch_simt<16>) simt = nullptr;
  decltype(&launch_mma<64>) mma = nullptr;
  if (dtype == kFloat32) {   // ops.HEAD_DIMS
    simt = dh == 16 ? launch_simt<16> : dh == 24 ? launch_simt<24> : dh == 32 ? launch_simt<32>
         : dh == 64 ? launch_simt<64> : dh == 128 ? launch_simt<128> : nullptr;
  } else if (dtype == kBFloat16) {
    mma = dh == 64 ? launch_mma<64> : dh == 80 ? launch_mma<80> : dh == 128 ? launch_mma<128>
        : dh == 192 ? launch_mma<192> : dh == 256 ? launch_mma<256> : nullptr;
  }
  if (!simt && !mma) return static_cast<int>(cudaErrorInvalidValue);
  int rc = 0;
  if (simt)
    simt(q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h, hk, causal, window, scale, s);
  else
    rc = mma(q, k, v, q_pos, k_pos, out, batch, sq, sk, sk_pad, h, hk, causal, window, scale, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

