// Causal GQA flash attention, backward, for Hopper (sm_90a): dq in one
// launch, dk and dv in another, from the forward's out and logsumexp.
//
// Replaces the two Pallas TPU kernels of the JAX package's backward,
// src/repro/kernels/flash_attention.py:202 _flash_bwd:
//   _dq_kernel  (:124, pallas_call :212) -> flash_dq_tc_kernel (bf16),
//                                          flash_dq_kernel (float32)
//   _dkv_kernel (:160, pallas_call :239) -> flash_dkv_tc_kernel (bf16),
//                                          flash_dkv_kernel (float32)
// and computes what they compute:
//   q_s = q * scale (q upcast to float32, scale = 1/sqrt(D) as float32)
//   s   = q_s k^T, -inf where kpos > qpos (causal; absolute positions)
//   p   = exp(s - lse)                 (no renormalization)
//   dp  = do v^T
//   ds  = p * (dp - delta)             (delta = rowsum(do * out), given)
//   dq  = (sum over key tiles of ds k) * scale, cast once to q's type
//   dv  = sum over the group's heads and query tiles of p^T do
//   dk  = (sum over the same of ds^T q) * scale (the float32 kernel: of
//         ds^T (q_s / scale), the scale applied to each tile's product)
//   dk, dv cast once to k's type.
// causal = 0 drops the mask.
//
// Layout: q, do, dq [B, H, Sq, D]; k, v, dk, dv [B, Kv, Sk, D]; lse, delta
// float32 [B, H, Sq]; all contiguous; query head h reads key/value head
// h / (H / Kv) (GQA), so k and v are never expanded. Which dtype takes
// which kernels:
//   bfloat16 -> flash_dq_tc_kernel, flash_dkv_tc_kernel: tiles staged by
//               TMA, s and dp on the CUDA cores, dv, dk and dq on the
//               tensor cores (wgmma). This is what training runs.
//   float32  -> flash_dq_kernel, flash_dkv_kernel: float32 FMAs on the
//               CUDA cores. A tensor-core float32 product would be TF32,
//               which the port never uses.
//
// What bounds it. At the training shape of phi4-mini-3.8b (B 2, S 2048,
// 24 query over 8 key/value heads, D 128, bf16, causal) the 100.7M causal
// (query, key) pairs take 6 D operations each for dq (s, dp, ds k) and 8 D
// for dk/dv (s, dp, p^T do, ds^T q): 77 and 103 GFLOP, 0.078 and 0.104 ms
// at the card's 989 TFLOP/s bf16 tensor rate, on ~80 MB of inputs and
// outputs each (0.025 ms at 3.35 TB/s): bound by the operations
// (kernels/flash_attention.py::work_bwd).
//
// Precision plan of the bfloat16 kernels. The card holds them against
// flash_attention_bwd_plain on each of phi4-mini's 32 random-weight
// training layers at 2^-8 of the largest gradient and 1e-3 of the elements
// over one bf16 step (chip_smoke.py). Those layers have scores |s| ~ 1,300
// to 1,500, so each row's softmax is all but one-hot, delta = rowsum(do
// out) equals the dp of that key to within rounding, and ds = p (dp -
// delta) is what is left of a cancellation. So both s (which feeds exp)
// and dp (which feeds the cancellation) must be the plain version's bit for
// bit: q * scale rounded to float32, do upcast, then fmaf over d = 0 .. D
// - 1 from 0 (cuBLAS's order for the plain version's float32 products), on
// the CUDA cores; p = expf(s - lse) with the library's expf, a masked score
// giving exp(-inf) = 0 by a select of the argument. With dp summed exactly
// (the best the tensor cores could do) and s bitwise, ~45 % of dq and ~21 %
// of dk elements lie more than a bf16 step from the plain version on every
// one of the 32 layers (an emulation on the card; PERF.md). dv, dk and dq
// run on the tensor cores, from p and ds entering as three bf16 terms each
// (tma_wgmma.cuh split_terms), which hold a float32 value exactly: only
// the order of the float32 sums differs from the plain version. That
// holds only if they are split times 2^24 (exact; the epilogue multiplies
// it out): bf16's spacing bottoms out at 2^-133, so the terms of a float32
// value below ~2^-110 lose its low bits, and of one below 2^-133 all of
// it, while every float32 value times 2^24 is a multiple of 2^-125. On
// phi4-mini's first layers, whose dout reach ~5e15, such tiny p carry ~2 %
// of dv's elements (measured on the card; PERF.md). The price is headroom:
// a gradient or partial sum over 2^128 / 2^24 ~ 2.0e31 overflows to inf
// where the plain version's float32 would not. dk multiplies ds^T by q
// itself (bf16, exact) where the plain version takes
// q_s / scale: the two differ by at most one float32 ulp of q, far below
// the sums' reordering. So the CUDA cores sum 4 D per pair in each kernel,
// and the tensor cores issue 6 D (dq) and 12 D (dk/dv) where work_bwd
// counts 2 D and 4 D: the terms are the precision plan's cost, not work.
//
// bfloat16 design. Both kernels: one block of 384 threads owns 128 rows
// (queries for dq, keys for dk/dv) and streams tiles of 64 of the other
// side through a TMA ring; warps 8-11 are the producer warpgroup (it gives
// its registers up with setmaxnreg, and one thread keeps the ring full),
// warps 0-3 and 4-7 two consumer warpgroups of 64 rows, each with its
// accumulators in registers. Boxes are 64 head-dim columns (128 bytes)
// wide in the 128-byte swizzle, so D < 128 is zero-filled to 128 (the sums
// stop at D; output columns >= D are not stored), and rows past Sq or Sk
// of a 128-row tile are zero-filled too. No atomics: each output is summed
// by one block in one order, so two launches agree bitwise.
//   - s and dp. Each consumer warp owns 16 rows; its lanes compute the
//     16 x 64 sums of a tile with float32 FMAs (the bf16 operand unpacked,
//     the float32 one read 16 bytes a row), 4 head-dim columns at a time,
//     and pass them through the warp's exchange buffer into the wgmma
//     accumulator fragment (32 floats a thread). p and ds are computed in
//     that fragment and go to the products as A fragments from registers
//     (the m64n64 fragment's registers 8 kk .. 8 kk + 7 are, pair by pair,
//     the A fragment of slice kk).
//   - flash_dq_tc_kernel: one block per (batch row, query head, 128
//     queries), the latest query blocks of all heads first (the longest
//     causal rows start first). The bf16 q and do tiles land in the first
//     two stages of the ring; q * scale and do are copied out to float32
//     once per block, then the ring takes k and v tiles of 64 keys
//     (kDqStages stages) up to the diagonal. Per tile a warpgroup sums s
//     and dp, computes p and ds, and runs dq += ds k as 12 m64n128k16 (ds
//     from registers as three terms per 16 keys, k MN-major through the
//     transpose bit). A tile wholly above the diagonal for a warpgroup is
//     skipped. Epilogue: dq * scale as bf16 pairs, rows >= Sq masked.
//   - flash_dkv_tc_kernel: one block per (batch row, key/value head, 128
//     keys), the earliest key blocks of all heads first (they see the most
//     queries); k and v are loaded once and stay. q and do tiles of 64
//     queries stream through kDkvStages stages, over the group's g query
//     heads and, when causal, from the diagonal on. Per tile both
//     warpgroups copy q * scale and do to float32 (rows XOR-swizzled in
//     16-byte chunks, so that a lane's 8 queries hit 8 bank groups) and the
//     tile's lse and delta, between two named barriers. Each warpgroup sums
//     s^T and dp^T with its 64 keys as rows (every sum is still the same
//     FMA chain; s waits in the exchange buffers, and after a third named
//     barrier dp passes through the q scale copy, which both warpgroups
//     have then read, so that neither fragment is held in registers while
//     the other is summed), computes p^T and ds^T in the fragment, and
//     runs dv += p^T do and dk += ds^T q (12 m64n128k16 each, do and q
//     MN-major), half a tile's terms at a time so that they, dk, dv, p and
//     ds fit the registers. Keys past Sk give p = 0 (the query tiles
//     end at Sq). Epilogue: dk * scale and dv as bf16 pairs, rows >= Sk
//     masked.
// Shared memory per block: flash_attention_bwd_tc_smem_bytes
// (= kernels/flash_attention.py::bwd_tc_smem_plan).
//
// float32 design (flash_dq_kernel, flash_dkv_kernel). Each output tile is
// owned by one block that loops over everything it sums.
//   flash_dq_kernel: one block of 256 threads per (batch row, query head,
//   64 queries), latest queries first; the key/value tiles are a loop
//   inside the block that ends at the diagonal. Shared memory (float32,
//   222,720 B at D 128): q_s and do transposed ([d][row], rows padded to 68
//   so that a warp's transposing stores hit 32 banks), k and v transposed,
//   k row major, ds transposed, the dq accumulator, lse and delta.
//   flash_dkv_kernel: one block per (batch row, key/value head, 64 keys),
//   earliest keys first; the loop runs over the group's g query heads and,
//   when causal, the query tiles from the diagonal on. Shared memory
//   (220,672 B at D 128): k and v transposed, a [d][row] buffer that holds
//   q_s and then do, a [row][d] buffer that holds do and then q_s / scale,
//   the p / ds tile row major, the dk and dv accumulators, lse and delta.
// Every product runs as 4 x 4 register tiles (16 FMAs per two 16-byte
// loads). Every phase is a loop strided by blockDim.x whose iterations
// write disjoint elements, separated by __syncthreads(), so one thread per
// block computes the same (the CPU emulation in the tests runs it so).
//
// Without nvcc (the CPU emulation in the tests), the bfloat16 launchers run
// a host model of each tensor-core kernel instead: the same blocks, ring
// offsets, box coordinates, q scale, lanes of the scores and their
// exchange into the fragment, p and ds, three-term split, descriptors and
// epilogue, with TMA's zero fill and the 128-byte swizzle written out
// (tma_wgmma.cuh, shared with gmm.cu and flash_attention_fwd.cu) and each
// product read through its descriptors. It cannot show the PTX, the
// barriers, the fragment layout on the card or the tensor cores' own order
// of sums; the card's checks do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <cstring>

#include "tma_wgmma.cuh"

#ifndef __CUDACC__
#include <algorithm>
#include <vector>
#endif

namespace {

using namespace tc;

struct Dims {
  int B, H, Kv, Sq, Sk, D, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 128;
constexpr int kLd = 68;  // row stride of the [d][row] tiles and of p / ds
constexpr int kMaxSmem = 232448;

// dst[d * kLd + r] = src[r * D + d] * mul for a [rows, D] tile. A warp's 32
// lanes take 4 rows x 8 columns: 32-byte reads of each row, and stores that
// fall on 32 different banks since kLd % 32 == 4.
__device__ void load_transposed(float* dst, const float* src, int rows, int D,
                                float mul) {
  const int groups = rows / 4;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int lane = e & 31, rest = e >> 5;
    const int r = (rest % groups) * 4 + (lane & 3);
    const int d = (rest / groups) * 8 + (lane >> 2);
    dst[d * kLd + r] = src[(size_t)r * D + d] * mul;
  }
}

__device__ void load_rows(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

__device__ __forceinline__ void unpack(float4 a, float out[4]) {
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}

// acc[i][j] += sum_x a[x * lda + r0 + i] * b[x * ldb + c0 + j], x < n
__device__ __forceinline__ void product4x4(float acc[4][4], const float* a,
                                           int lda, int r0, const float* b,
                                           int ldb, int c0, int n) {
  for (int x = 0; x < n; ++x) {
    float av[4], bv[4];
    unpack(*reinterpret_cast<const float4*>(a + x * lda + r0), av);
    unpack(*reinterpret_cast<const float4*>(b + x * ldb + c0), bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

size_t dq_smem_floats(int D) {
  return 4 * (size_t)D * kLd + 2 * (size_t)kBlockK * D + (size_t)kBlockK * kLd +
         2 * kBlockQ;
}

size_t dkv_smem_floats(int D) {
  return 3 * (size_t)D * kLd + 3 * (size_t)kBlockK * D + (size_t)kBlockQ * kLd +
         2 * kBlockQ;
}

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                Dims P) {
  extern __shared__ float smem[];
  const int D = P.D;
  float* qT = smem;                  // [D][kLd]  q * scale
  float* doT = qT + D * kLd;         // [D][kLd]  do
  float* kT = doT + D * kLd;         // [D][kLd]  key tile
  float* vT = kT + D * kLd;          // [D][kLd]  value tile
  float* kR = vT + D * kLd;          // [kBlockK][D] key tile, row major
  float* acc = kR + kBlockK * D;     // [kBlockQ][D]
  float* dsT = acc + kBlockQ * D;    // [kBlockK][kLd] ds transposed
  float* lse_s = dsT + kBlockK * kLd;  // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;    // [kBlockQ]

  const int nq = P.Sq / kBlockQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * kBlockQ;
  const int b = bh / P.H, h = bh % P.H;
  const size_t kv_base = ((size_t)b * P.Kv + h / (P.H / P.Kv)) * P.Sk * D;
  const size_t q_base = ((size_t)bh * P.Sq + q0) * D;
  const size_t row_base = (size_t)bh * P.Sq + q0;

  load_transposed(qT, q + q_base, kBlockQ, D, P.scale);
  load_transposed(doT, dout + q_base, kBlockQ, D, 1.f);
  for (int e = threadIdx.x; e < kBlockQ * D; e += blockDim.x) acc[e] = 0.f;
  for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
    lse_s[r] = lse[row_base + r];
    delta_s[r] = delta[row_base + r];
  }

  int nk = P.Sk / kBlockK;
  if (P.causal) nk = min(nk, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    const size_t t_base = kv_base + (size_t)k0 * D;
    __syncthreads();  // the previous tile's readers are done
    load_transposed(kT, k + t_base, kBlockK, D, 1.f);
    load_transposed(vT, v + t_base, kBlockK, D, 1.f);
    load_rows(kR, k + t_base, kBlockK * D);
    __syncthreads();

    // s, dp and ds for 4 queries x 4 keys per iteration; ds stored
    // transposed
    for (int t = threadIdx.x; t < (kBlockQ / 4) * (kBlockK / 4);
         t += blockDim.x) {
      const int r0 = (t % (kBlockQ / 4)) * 4, c0 = (t / (kBlockQ / 4)) * 4;
      float s[4][4] = {}, dp[4][4] = {};
      product4x4(s, qT, kLd, r0, kT, kLd, c0, D);
      product4x4(dp, doT, kLd, r0, vT, kLd, c0, D);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool masked = P.causal && k0 + c0 + jj > q0 + r0 + i;
          const float p = expf((masked ? -INFINITY : s[i][jj]) -
                               lse_s[r0 + i]);
          col[i] = p * (dp[i][jj] - delta_s[r0 + i]);
        }
        *reinterpret_cast<float4*>(dsT + (c0 + jj) * kLd + r0) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // acc += ds k: 4 queries x 4 dims per iteration
    for (int t = threadIdx.x; t < (kBlockQ / 4) * (D / 4); t += blockDim.x) {
      const int n0 = (t % (D / 4)) * 4, r0 = (t / (D / 4)) * 4;
      float pv[4][4] = {};
      product4x4(pv, dsT, kLd, r0, kR, D, n0, kBlockK);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[(r0 + i) * D + n0 + jj] += pv[i][jj];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kBlockQ * D; e += blockDim.x)
    dq[q_base + e] = acc[e] * P.scale;
}

__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, Dims P) {
  extern __shared__ float smem[];
  const int D = P.D;
  float* kT = smem;                  // [D][kLd]  key tile
  float* vT = kT + D * kLd;          // [D][kLd]  value tile
  float* X = vT + D * kLd;           // [D][kLd]  q * scale, then do
  float* Y = X + D * kLd;            // [kBlockQ][D] do, then q_s / scale
  float* dk_acc = Y + kBlockQ * D;   // [kBlockK][D]
  float* dv_acc = dk_acc + kBlockK * D;  // [kBlockK][D]
  float* pds = dv_acc + kBlockK * D;     // [kBlockQ][kLd] p, then ds
  float* lse_s = pds + kBlockQ * kLd;    // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;      // [kBlockQ]

  const int nk = P.Sk / kBlockK;
  const int nq = P.Sq / kBlockQ;
  const int bkv = blockIdx.x / nk;
  const int k0 = (int)(blockIdx.x % nk) * kBlockK;
  const int b = bkv / P.Kv, kvh = bkv % P.Kv;
  const int g = P.H / P.Kv;
  const size_t kv_base = ((size_t)bkv * P.Sk + k0) * D;

  load_transposed(kT, k + kv_base, kBlockK, D, 1.f);
  load_transposed(vT, v + kv_base, kBlockK, D, 1.f);
  for (int e = threadIdx.x; e < kBlockK * D; e += blockDim.x) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  // query tiles that see a key of this tile: q0 + kBlockQ - 1 >= k0
  const int i0 = P.causal ? k0 / kBlockQ : 0;
  for (int gh = 0; gh < g; ++gh) {
    const int bh = b * P.H + kvh * g + gh;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * kBlockQ;
      const size_t q_base = ((size_t)bh * P.Sq + q0) * D;
      const size_t row_base = (size_t)bh * P.Sq + q0;
      __syncthreads();  // the previous iteration's readers are done
      load_transposed(X, q + q_base, kBlockQ, D, P.scale);
      for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
        lse_s[r] = lse[row_base + r];
        delta_s[r] = delta[row_base + r];
      }
      __syncthreads();

      // p = exp(s - lse), 4 queries x 4 keys per iteration, row major
      for (int t = threadIdx.x; t < (kBlockQ / 4) * (kBlockK / 4);
           t += blockDim.x) {
        const int c0 = (t % (kBlockK / 4)) * 4, r0 = (t / (kBlockK / 4)) * 4;
        float s[4][4] = {};
        product4x4(s, X, kLd, r0, kT, kLd, c0, D);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float row[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const bool masked = P.causal && k0 + c0 + jj > q0 + r0 + ii;
            row[jj] = expf((masked ? -INFINITY : s[ii][jj]) -
                           lse_s[r0 + ii]);
          }
          *reinterpret_cast<float4*>(pds + (r0 + ii) * kLd + c0) =
              make_float4(row[0], row[1], row[2], row[3]);
        }
      }
      __syncthreads();

      // do, row major into Y and transposed into X (q_s is read no more)
      load_rows(Y, dout + q_base, kBlockQ * D);
      load_transposed(X, dout + q_base, kBlockQ, D, 1.f);
      __syncthreads();

      // dv += p^T do: 4 keys x 4 dims per iteration
      for (int t = threadIdx.x; t < (kBlockK / 4) * (D / 4); t += blockDim.x) {
        const int n0 = (t % (D / 4)) * 4, c0 = (t / (D / 4)) * 4;
        float pv[4][4] = {};
        product4x4(pv, pds, kLd, c0, Y, D, n0, kBlockQ);
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            dv_acc[(c0 + ci) * D + n0 + nj] += pv[ci][nj];
      }
      __syncthreads();

      // ds = p (dp - delta) in place of p, dp = do v^T; and q_s / scale
      // into Y (do is read no more from it)
      for (int t = threadIdx.x; t < (kBlockQ / 4) * (kBlockK / 4);
           t += blockDim.x) {
        const int c0 = (t % (kBlockK / 4)) * 4, r0 = (t / (kBlockK / 4)) * 4;
        float dp[4][4] = {};
        product4x4(dp, X, kLd, r0, vT, kLd, c0, D);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float4* cell = reinterpret_cast<float4*>(pds + (r0 + ii) * kLd + c0);
          float p[4];
          unpack(*cell, p);
          const float dl = delta_s[r0 + ii];
          *cell = make_float4(p[0] * (dp[ii][0] - dl), p[1] * (dp[ii][1] - dl),
                              p[2] * (dp[ii][2] - dl), p[3] * (dp[ii][3] - dl));
        }
      }
      for (int e = threadIdx.x; e < kBlockQ * D; e += blockDim.x)
        Y[e] = __fdiv_rn(q[q_base + e] * P.scale, P.scale);
      __syncthreads();

      // dk += (ds^T (q_s / scale)) * scale: 4 keys x 4 dims per iteration
      for (int t = threadIdx.x; t < (kBlockK / 4) * (D / 4); t += blockDim.x) {
        const int n0 = (t % (D / 4)) * 4, c0 = (t / (D / 4)) * 4;
        float pv[4][4] = {};
        product4x4(pv, pds, kLd, c0, Y, D, n0, kBlockQ);
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            float* a = dk_acc + (c0 + ci) * D + n0 + nj;
            *a = __fadd_rn(*a, __fmul_rn(pv[ci][nj], P.scale));
          }
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kBlockK * D; e += blockDim.x) {
    dk[kv_base + e] = dk_acc[e];
    dv[kv_base + e] = dv_acc[e];
  }
}

int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, const Dims& P, void* stream) {
  const int n = P.B * P.H * (P.Sq / kBlockQ);
  const int smem = (int)(dq_smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), P);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const Dims& P, void* stream) {
  const int n = P.B * P.Kv * (P.Sk / kBlockK);
  const int smem = (int)(dkv_smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), P);
  return (int)cudaGetLastError();
}

bool takes(int B, int H, int Kv, int Sq, int Sk, int D) {
  return D >= 8 && D <= kMaxD && D % 8 == 0 && Sq % kBlockQ == 0 &&
         Sk % kBlockK == 0 && Kv > 0 && H % Kv == 0 && B * H * Sq > 0 &&
         Sk > 0 && dq_smem_floats(D) * sizeof(float) <= (size_t)kMaxSmem &&
         dkv_smem_floats(D) * sizeof(float) <= (size_t)kMaxSmem;
}

// ---------------------------------------------------------------------------
// bfloat16: s and dp on the CUDA cores, the other products on the tensor
// cores. What follows up to the CUDA-only part is shared by the kernels and
// their host models.

constexpr int kTcRows = 128;                  // rows a block owns
constexpr int kWgRows = kMmaM;                // rows per consumer warpgroup
constexpr int kConsumers = kTcRows / kWgRows;   // warpgroups
constexpr int kTcThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kProducerRegs = 24;             // setmaxnreg, per thread
constexpr int kConsumerRegs = 240;
// a block holds the registers it was launched with (65,536 / 384 threads,
// a multiple of 8: 168 each) and setmaxnreg only moves them between its
// warpgroups: an increase past what the others gave up waits for ever
constexpr int kLaunchRegs = 65536 / kTcThreads / 8 * 8;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <=
                  kLaunchRegs * kTcThreads,
              "the registers the block was launched with");
constexpr int kTile = 64;                     // rows of a streamed tile
// takes() admits Sq and Sk in multiples of kBlockQ and kBlockK, so a
// streamed 64-row query tile never runs past Sq (the dk/dv kernel reads a
// tile's lse and delta, and computes its p, unmasked by Sq)
static_assert(kTile == kBlockQ && kTile == kBlockK,
              "a streamed tile ends at Sq: mask its queries otherwise");
constexpr int kBoxCols = 64;                  // head-dim columns of a box
constexpr int kBoxes = kMaxD / kBoxCols;      // D zero-filled to 128
constexpr int kResBox = kTcRows * kRowBytes;  // a box of a resident tile
constexpr int kResBytes = kBoxes * kResBox;   // a resident bf16 tile, 32 KiB
constexpr int kTileBox = kTile * kRowBytes;   // a box of a streamed tile
constexpr int kTileBytes = kBoxes * kTileBox; // a streamed bf16 tile, 16 KiB
constexpr int kFrag = kTile / 2;      // s, p, dp, ds floats per thread
constexpr int kAcc = kMaxD / 2;       // dq, dk, dv floats per thread
constexpr int kTerms = 3;             // bf16 terms of p and ds
// p and ds enter the products times 2^24 (exact), so that the three bf16
// terms hold every float32 value, subnormal ones included, exactly and as
// normal bf16 numbers. 2^16 makes the split exact too, but through bf16
// subnormal terms, which the tensor cores need not keep (on the card one
// dv element of five training steps' 160 layers differed between the
// two). The accumulators hold 2^24 times dq, dk, dv until the epilogue
// (the range this costs: the design note above).
constexpr float kTermScale = 16777216.f;         // 2^24
constexpr float kTermUnscale = 1.f / 16777216.f;
constexpr int kSlices = kTile / kMmaK;        // k16 slices of a tile
constexpr int kXBytes = 16 * kTile * 4;       // a consumer warp's exchange
constexpr int kXAllBytes = kConsumers * 4 * kXBytes;  // 32 KiB
constexpr int kStatBytes = 2 * kTile * 4;     // a tile's lse and delta
static_assert(kFrag == 32 && kAcc == 64, "m64n64 and m64n128 fragments");

// dq: the layout from the aligned base. q scale and do (float32, 128 rows
// of 128 each), the exchange buffers, the ring (per stage a k and a v tile
// of 64 keys; the bf16 q and do tiles land in stages 0 and 1 before it
// starts), a full and an empty mbarrier per stage, the q and do tiles'
// mbarrier and the one that frees their landing place.
constexpr int kDqStages = 2;
constexpr int kDqRowsF32 = kTcRows * kMaxD * 4;   // 64 KiB
constexpr int kDqQs = 0;
constexpr int kDqDo = kDqRowsF32;
constexpr int kDqX = 2 * kDqRowsF32;
constexpr int kDqRing = kDqX + kXAllBytes;
constexpr int kDqStageBytes = 2 * kTileBytes;
static_assert(kDqStageBytes == kResBytes && kDqStages >= 2,
              "the q and do tiles land in the first two stages");
__host__ __device__ constexpr int dq_tc_smem_bytes(int stages) {
  return kSwizzleAtom + kDqRing + stages * kDqStageBytes + (2 * stages + 2) * 8;
}

// dk/dv: the bf16 k and v tiles, the exchange buffers, q scale and do of
// the current query tile (float32, 64 rows of 128 each), the ring (per
// stage a q and a do tile of 64 queries), the current tile's lse and
// delta, a full and an empty mbarrier per stage and the k and v tiles'
// mbarrier.
constexpr int kDkvStages = 2;
constexpr int kDkvRowsF32 = kTile * kMaxD * 4;    // 32 KiB
constexpr int kDkvK = 0;
constexpr int kDkvV = kResBytes;
constexpr int kDkvX = 2 * kResBytes;
constexpr int kDkvQs = kDkvX + kXAllBytes;
constexpr int kDkvDo = kDkvQs + kDkvRowsF32;
constexpr int kDkvRing = kDkvDo + kDkvRowsF32;
constexpr int kDkvStageBytes = 2 * kTileBytes;           // q then do
__host__ __device__ constexpr int kDkvStats(int stages) {
  return kDkvRing + stages * kDkvStageBytes;
}
__host__ __device__ constexpr int dkv_tc_smem_bytes(int stages) {
  return kSwizzleAtom + kDkvStats(stages) + kStatBytes + (2 * stages + 1) * 8;
}
static_assert(dq_tc_smem_bytes(kDqStages) <= kMaxSmem &&
                  dkv_tc_smem_bytes(kDkvStages) <= kMaxSmem,
              "a block's shared memory");

// The tensor maps, 0 q and 3 do {D, Sq, B H}, 1 k and 2 v {D, Sk, B Kv}
// (innermost first), boxes of 64 head-dim columns by `rows`.
enum { kMapQ = 0, kMapK = 1, kMapV = 2, kMapDo = 3 };
MapSpec map_spec(int map, const Dims& P, int rows) {
  const bool qside = map == kMapQ || map == kMapDo;
  const std::uint64_t n = qside ? P.Sq : P.Sk;
  const std::uint64_t heads =
      (std::uint64_t)P.B * (qside ? P.H : P.Kv);
  return {{(std::uint64_t)P.D, n, heads},
          {(std::uint64_t)P.D * 2, n * P.D * 2},
          {(std::uint32_t)kBoxCols, (std::uint32_t)rows, 1}};
}

// Where an element lies, before the swizzle: row `row`, head-dim column d
// of a bf16 tile whose 64-column boxes are `box` bytes apart (kResBox for
// the 128-row tiles, kTileBox for the 64-row ones).
__host__ __device__ constexpr std::uint32_t tile_at(int box, int row, int d) {
  return (d / kBoxCols) * box + row * kRowBytes + (d % kBoxCols) * 2;
}

// The float32 copies (q scale, do), rows of 128 floats. dq: plain rows (a
// warp's lanes read 2 rows at a time). dk/dv: each row's 16-byte chunks
// XOR-ed with its low 3 bits (a warp's lanes read 8 consecutive rows at a
// time, which then fall on 8 different bank groups).
__host__ __device__ constexpr int dq_f32_at(int row, int d) {
  return row * kMaxD + d;
}
__host__ __device__ constexpr int dkv_f32_at(int row, int d) {
  return row * kMaxD + (((d / 4) ^ (row % 8)) * 4) + d % 4;
}

// Who computes which s and dp. A consumer warp owns 16 rows of the block
// and a tile's 64 columns. dq: lane L sums rows 8 (L / 16) + i (i < 8) and
// keys L % 16 + 16 j (j < 4). dk/dv: lane L sums keys 4 (L / 8) + i (i < 4)
// and queries L % 8 + 8 j (j < 8). Then the warp's sums pass through its
// exchange buffer (16 rows of 64 floats), whence each thread reads its
// fragment.
__host__ __device__ constexpr int dq_row(int lane, int i) {
  return 8 * (lane / 16) + i;
}
__host__ __device__ constexpr int dq_key(int lane, int j) {
  return lane % 16 + 16 * j;
}
__host__ __device__ constexpr int dkv_key(int lane, int i) {
  return 4 * (lane / 8) + i;
}
__host__ __device__ constexpr int dkv_query(int lane, int j) {
  return lane % 8 + 8 * j;
}
__host__ __device__ constexpr int x_at(int row, int col) {
  return row * kTile + col;
}

// B MN-major (transpose-B 1) of a streamed tile, the head dim as N: slice
// kk of 16 rows, 16 rows further per slice, the second 64-column box
// kTileBox further (LBO), 8-row groups 1,024 bytes apart (SBO).
__host__ __device__ inline std::uint64_t mn_desc(std::uint32_t tile, int kk) {
  return sw128_desc(tile + kk * kMmaK * kRowBytes, kTileBox, 8 * kRowBytes);
}

// What dq block `index` computes: query head row bh (b H + h), its first
// query q0, the key/value head row kvh (b Kv + h / (H / Kv)) and the key
// tiles nk (the causal loop ends at the diagonal tile). The latest query
// blocks of every head come first.
struct DqBlock {
  int bh, q0, kvh, nk;
};

__host__ __device__ inline DqBlock dq_block(int index, const Dims& P) {
  const int nq = cdiv(P.Sq, kTcRows), heads = P.B * P.H;
  const int bh = index % heads, q0 = (nq - 1 - index / heads) * kTcRows;
  const int kvh = (bh / P.H) * P.Kv + (bh % P.H) / (P.H / P.Kv);
  int nk = P.Sk / kTile;
  if (P.causal) {
    const int diagonal = (q0 + kTcRows - 1) / kTile + 1;
    nk = nk < diagonal ? nk : diagonal;
  }
  return {bh, q0, kvh, nk};
}

// What dk/dv block `index` computes: key/value head row bkv (b Kv + kvh),
// its first key k0, and its query tiles: for each of the group's g heads,
// tiles first .. Sq / 64 - 1 (when causal, from the diagonal on); nt in
// all. The earliest key blocks of every head come first.
struct DkvBlock {
  int bkv, k0, first, per_head, nt;
};

__host__ __device__ inline DkvBlock dkv_block(int index, const Dims& P) {
  const int heads = P.B * P.Kv, nq = P.Sq / kTile;
  const int bkv = index % heads, k0 = index / heads * kTcRows;
  int first = P.causal ? k0 / kTile : 0;
  first = first < nq ? first : nq;
  return {bkv, k0, first, nq - first, P.H / P.Kv * (nq - first)};
}

// Tile j of a dk/dv block: its query head row and first query.
__host__ __device__ inline int dkv_tile_bh(const DkvBlock& blk, int j,
                                           const Dims& P) {
  return (blk.bkv / P.Kv) * P.H + (blk.bkv % P.Kv) * (P.H / P.Kv) +
         j / blk.per_head;
}
__host__ __device__ inline int dkv_tile_q0(const DkvBlock& blk, int j) {
  return (blk.first + j % blk.per_head) * kTile;
}

// The loads: copy(map, smem address, c0, c1, c2), coordinates innermost
// first. dq: the q and do tiles once, into ring stages 0 and 1; per key
// tile k0 the k boxes, then the v boxes, into a stage. dk/dv: the k and v
// tiles once; per query tile the q boxes, then the do boxes.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void dq_once_loads(const Copy& copy,
                                              std::uint32_t ring,
                                              const DqBlock& blk) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
    copy(kMapQ, ring + j * kResBox, j * kBoxCols, blk.q0, blk.bh);
    copy(kMapDo, ring + kDqStageBytes + j * kResBox, j * kBoxCols, blk.q0,
         blk.bh);
  }
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void dq_stage_loads(const Copy& copy,
                                               std::uint32_t stage, int k0,
                                               const DqBlock& blk) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
    copy(kMapK, stage + j * kTileBox, j * kBoxCols, k0, blk.kvh);
    copy(kMapV, stage + kTileBytes + j * kTileBox, j * kBoxCols, k0, blk.kvh);
  }
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void dkv_once_loads(const Copy& copy,
                                               std::uint32_t base,
                                               const DkvBlock& blk) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
    copy(kMapK, base + kDkvK + j * kResBox, j * kBoxCols, blk.k0, blk.bkv);
    copy(kMapV, base + kDkvV + j * kResBox, j * kBoxCols, blk.k0, blk.bkv);
  }
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void dkv_stage_loads(const Copy& copy,
                                                std::uint32_t stage, int q0,
                                                int bh) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
    copy(kMapQ, stage + j * kTileBox, j * kBoxCols, q0, bh);
    copy(kMapDo, stage + kTileBytes + j * kTileBox, j * kBoxCols, q0, bh);
  }
}

// dq, in the fragment of thread t (rows qrow0 + frag_row(t, i), keys k0 +
// frag_col(t, i)): s becomes p = exp(s - lse) (0 where the key is after
// the query, causal), then ds = p (dp - delta), times kTermScale. lse and
// delta of the
// thread's two rows. The guard selects exp's argument, not its result (a
// select of the result compiles to a branch around every exponential).
__host__ __device__ inline void dq_p_ds(float (&s)[kFrag],
                                        const float (&dp)[kFrag], int t,
                                        int qrow0, int k0,
                                        const float (&lse)[2],
                                        const float (&delta)[2],
                                        const Dims& P) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int r = (i / 2) % 2;
    const bool masked =
        P.causal && k0 + frag_col(t, i) > qrow0 + frag_row(t, i);
    const float p = expf(masked ? -INFINITY : s[i] - lse[r]);
    s[i] = p * (dp[i] - delta[r]) * kTermScale;
  }
}

// dk/dv, in the fragment of thread t (keys krow0 + frag_row(t, i), queries
// q0 + frag_col(t, i)): s becomes p, and dp becomes ds, both times
// kTermScale; lse and delta of the tile's 64 queries. A key past Sk or
// (causal) a key after the query gives p = 0.
__host__ __device__ inline void dkv_p_ds(float (&s)[kFrag],
                                         float (&dp)[kFrag], int t, int krow0,
                                         int q0, const float* lse,
                                         const float* delta, const Dims& P) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int c = frag_col(t, i), qpos = q0 + c, kpos = krow0 + frag_row(t, i);
    const bool masked = kpos >= P.Sk || (P.causal && kpos > qpos);
    const float p = expf(masked ? -INFINITY : s[i] - lse[c]);
    s[i] = p * kTermScale;
    dp[i] = p * (dp[i] - delta[c]) * kTermScale;
  }
}

// Thread t's part of a [rows, D] output of head row `head` (rows n): acc *
// mul as bf16 pairs, rows >= n and columns >= D masked.
__host__ __device__ inline void store_rows(__nv_bfloat16* out, int n,
                                           int head, int row0, int t,
                                           const float (&acc)[kAcc],
                                           float mul, const Dims& P) {
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int row = row0 + frag_row(t, i), col = frag_col(t, i);
    if (row < n && col < P.D)
      store_pair(out + ((size_t)head * n + row) * P.D + col, acc[i] * mul,
                 acc[i + 1] * mul);
  }
}

#ifdef __CUDACC__

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
}

// The sums of lane `lane` as the plain version's float32 products sum
// them: each starts at 0 and takes fmaf(x_d, y_d, s) for d = 0, 1, ..,
// D - 1 in turn, x the float32 copy (q scale, rounded to float32 before;
// do) and y the bf16 tile (k; v). 4 head-dim columns at a time: 16 bytes
// of each float32 row, 8 bytes of each bf16 row, 128 FMAs.
// dq: s[i][j] for row dq_row(lane, i) of the float32 rows row0 .., key
// dq_key(lane, j) of the stage's bf16 tile.
__device__ __forceinline__ void dq_sums(float (&s)[8][4], const float* x,
                                        const unsigned char* y, int row0,
                                        int lane, int D) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 4) {
    float yd[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          y + swizzle128(tile_at(kTileBox, dq_key(lane, j), d0)));
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        yd[j][dd] = half_of(dd < 2 ? raw.x : raw.y, dd % 2);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          x + dq_f32_at(row0 + dq_row(lane, i), d0));
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          s[i][j] = fmaf(a[dd], yd[j][dd], s[i][j]);
    }
  }
}

// dk/dv: s[i][j] for key dkv_key(lane, i) of the resident bf16 tile's rows
// row0 .., query dkv_query(lane, j) of the float32 copy.
__device__ __forceinline__ void dkv_sums(float (&s)[4][8],
                                         const unsigned char* y,
                                         const float* x, int row0, int lane,
                                         int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 4) {
    float yd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          y + swizzle128(tile_at(kResBox, row0 + dkv_key(lane, i), d0)));
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        yd[i][dd] = half_of(dd < 2 ? raw.x : raw.y, dd % 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          x + dkv_f32_at(dkv_query(lane, j), d0));
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          s[i][j] = fmaf(a[dd], yd[i][dd], s[i][j]);
    }
  }
}

// A warp's sums, lane by lane (row(lane, i), col(lane, j)), into an
// exchange buffer; and thread t's fragment out of one.
template <int I, int J, class Row, class Col>
__device__ __forceinline__ void park(const float (&s)[I][J], float* xbuf,
                                     int lane, const Row& row,
                                     const Col& col) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
      xbuf[x_at(row(lane, i), col(lane, j))] = s[i][j];
}

__device__ __forceinline__ void fragment(float (&frag)[kFrag],
                                         const float* xbuf, int t) {
#pragma unroll
  for (int i = 0; i < kFrag; i += 2) {
    const float2 x = *reinterpret_cast<const float2*>(
        xbuf + x_at(frag_row(t, i) % 16, frag_col(t, i)));
    frag[i] = x.x;
    frag[i + 1] = x.y;
  }
}

// `rows` rows x 128 columns of a bf16 tile at `tile` (64-column boxes
// `box` bytes apart, swizzled) into float32 at dst + at(row, d), each times
// mul (one rounding; mul 1 copies); the consumers' threads together.
template <class At>
__device__ __forceinline__ void to_f32(float* dst, const unsigned char* tile,
                                       int rows, int box, float mul,
                                       const At& at) {
  for (int task = threadIdx.x; task < rows * (kMaxD / 8);
       task += kConsumers * 128) {
    const int row = task / (kMaxD / 8), d = task % (kMaxD / 8) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        tile + swizzle128(tile_at(box, row, d)));
    const std::uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float x[8];
#pragma unroll
    for (int dd = 0; dd < 8; ++dd)
      x[dd] = __fmul_rn(half_of(w[dd / 2], dd % 2), mul);
    *reinterpret_cast<float4*>(dst + at(row, d)) =
        make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + at(row, d + 4)) =
        make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += A B: R / 4 k16 slices from first_slice on, each kTerms
// m64n128k16 (the terms of A from registers, B through mn_desc of `tile`),
// issued, committed and waited for.
template <int R>
__device__ __forceinline__ void term_products(
    float (&acc)[kAcc], std::uint32_t (&terms)[kTerms][R], std::uint32_t tile,
    int first_slice) {
#pragma unroll
  for (int u = 0; u < kTerms; ++u) fence_regs(terms[u]);
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < R / 4; ++kk) {
    const std::uint64_t db = mn_desc(tile, first_slice + kk);
#pragma unroll
    for (int u = 0; u < kTerms; ++u)
      wgmma_m64n128k16_rs<1>(acc, terms[u][4 * kk], terms[u][4 * kk + 1],
                             terms[u][4 * kk + 2], terms[u][4 * kk + 3], db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(acc);
#pragma unroll
  for (int u = 0; u < kTerms; ++u) fence_regs(terms[u]);
}

__global__ void __launch_bounds__(kTcThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, Dims P) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const std::uint32_t base = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                             ~(std::uint32_t)(kSwizzleAtom - 1);
  unsigned char* gbase = tc_smem + (base - smem_u32(tc_smem));
  const std::uint32_t ring = base + kDqRing;
  const std::uint32_t full = ring + kDqStages * kDqStageBytes;
  const std::uint32_t empty = full + kDqStages * 8;
  const std::uint32_t qfull = empty + kDqStages * 8;
  const std::uint32_t landed = qfull + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's arm
      mbar_init(empty + 8 * s, kConsumers * 4);    // one per consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(landed, kConsumers * 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // the producer warpgroup gives up registers; one thread loads q and
    // do into the first stages, waits until they are copied out, then
    // keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumers * 4 || lane != 0) return;
    const DqBlock blk = dq_block(blockIdx.x, P);
    const std::uint64_t maps[4] = {reinterpret_cast<std::uint64_t>(&qmap),
                                   reinterpret_cast<std::uint64_t>(&kmap),
                                   reinterpret_cast<std::uint64_t>(&vmap),
                                   reinterpret_cast<std::uint64_t>(&domap)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps[i]) : "memory");
    mbar_arrive_expect_tx(qfull, 2 * kResBytes);
    dq_once_loads(
        [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
          tma_load_3d(dst, maps[map], qfull, x0, x1, x2);
        },
        ring, blk);
    mbar_wait(landed, 0);
    for (int j = 0; j < blk.nk; ++j) {
      const int s = j % kDqStages;
      const std::uint32_t bar = full + 8 * s;
      mbar_wait(empty + 8 * s, ((j / kDqStages) & 1) ^ 1);
      mbar_arrive_expect_tx(bar, kDqStageBytes);
      dq_stage_loads(
          [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
            tma_load_3d(dst, maps[map], bar, x0, x1, x2);
          },
          ring + s * kDqStageBytes, j * kTile, blk);
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, all head-dim columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int qrow0 = dq_block(block_index(), P).q0 + wg * kWgRows;
  const float* qsf = reinterpret_cast<const float*>(gbase + kDqQs);
  const float* dof = reinterpret_cast<const float*>(gbase + kDqDo);
  float* xbuf = reinterpret_cast<float*>(gbase + kDqX + warp * kXBytes);
  const auto rows_at = [](int row, int d) { return dq_f32_at(row, d); };
  mbar_wait(qfull, 0);
  // q scale, rounded to float32 once per block, and do in float32, by the
  // two warpgroups together; then their landing place is free
  to_f32(reinterpret_cast<float*>(gbase + kDqQs), gbase + kDqRing, kTcRows,
         kResBox, P.scale, rows_at);
  to_f32(reinterpret_cast<float*>(gbase + kDqDo),
         gbase + kDqRing + kDqStageBytes, kTcRows, kResBox, 1.f, rows_at);
  consumers_sync();
  if (lane == 0) mbar_arrive(landed);
  float lse_r[2], delta_r[2];
  {
    const int bh = dq_block(block_index(), P).bh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + frag_row(t, 2 * r);
      const bool in = row < P.Sq;
      lse_r[r] = in ? lse[(size_t)bh * P.Sq + row] : 0.f;
      delta_r[r] = in ? delta[(size_t)bh * P.Sq + row] : 0.f;
    }
  }
  const int row0 = wg * kWgRows + 16 * (warp % 4);
  float acc[kAcc];
  zero(acc);
  for (int j = 0; j < dq_block(block_index(), P).nk; ++j) {
    const int s = j % kDqStages, k0 = j * kTile;
    const std::uint32_t stage = ring + s * kDqStageBytes;
    const unsigned char* tile = gbase + (stage - base);
    mbar_wait(full + 8 * s, (j / kDqStages) & 1);
    if (!P.causal || k0 <= qrow0 + kWgRows - 1) {
      // s = (q scale) k^T and dp = do v^T on the CUDA cores
      float sc[kFrag], dp[kFrag];
      {
        float x[8][4];
        dq_sums(x, qsf, tile, row0, lane, P.D);
        __syncwarp();
        park(x, xbuf, lane, dq_row, dq_key);
        __syncwarp();
        fragment(sc, xbuf, t);
        dq_sums(x, dof, tile + kTileBytes, row0, lane, P.D);
        __syncwarp();
        park(x, xbuf, lane, dq_row, dq_key);
        __syncwarp();
        fragment(dp, xbuf, t);
      }
      dq_p_ds(sc, dp, t, qrow0, k0, lse_r, delta_r, P);
      // dq += ds k on the tensor cores, ds from registers as three terms
      std::uint32_t terms[kTerms][kFrag / 2];
      split_terms(sc, 0, terms);
      term_products(acc, terms, stage, 0);
    }
    // the tile's k and v are read: release the stage
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows(dq, P.Sq, dq_block(block_index(), P).bh, qrow0, t, acc,
             P.scale * kTermUnscale, P);
}

__global__ void __launch_bounds__(kTcThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Dims P) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const std::uint32_t base = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                             ~(std::uint32_t)(kSwizzleAtom - 1);
  unsigned char* gbase = tc_smem + (base - smem_u32(tc_smem));
  const std::uint32_t ring = base + kDkvRing;
  const std::uint32_t full = base + kDkvStats(kDkvStages) + kStatBytes;
  const std::uint32_t empty = full + kDkvStages * 8;
  const std::uint32_t kvfull = empty + kDkvStages * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);
    }
    mbar_init(kvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumers * 4 || lane != 0) return;
    const DkvBlock blk = dkv_block(blockIdx.x, P);
    const std::uint64_t maps[4] = {reinterpret_cast<std::uint64_t>(&qmap),
                                   reinterpret_cast<std::uint64_t>(&kmap),
                                   reinterpret_cast<std::uint64_t>(&vmap),
                                   reinterpret_cast<std::uint64_t>(&domap)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps[i]) : "memory");
    mbar_arrive_expect_tx(kvfull, 2 * kResBytes);
    dkv_once_loads(
        [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
          tma_load_3d(dst, maps[map], kvfull, x0, x1, x2);
        },
        base, blk);
    for (int j = 0; j < blk.nt; ++j) {
      const int s = j % kDkvStages;
      const std::uint32_t bar = full + 8 * s;
      mbar_wait(empty + 8 * s, ((j / kDkvStages) & 1) ^ 1);
      mbar_arrive_expect_tx(bar, kDkvStageBytes);
      dkv_stage_loads(
          [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
            tma_load_3d(dst, maps[map], bar, x0, x1, x2);
          },
          ring + s * kDkvStageBytes, dkv_tile_q0(blk, j),
          dkv_tile_bh(blk, j, P));
    }
    return;
  }

  // a consumer warpgroup: 64 keys, all head-dim columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int krow0 = dkv_block(block_index(), P).k0 + wg * kWgRows;
  float* qsf = reinterpret_cast<float*>(gbase + kDkvQs);
  float* dof = reinterpret_cast<float*>(gbase + kDkvDo);
  float* st = reinterpret_cast<float*>(gbase + kDkvStats(kDkvStages));
  float* xbuf = reinterpret_cast<float*>(gbase + kDkvX + warp * kXBytes);
  const auto rows_at = [](int row, int d) { return dkv_f32_at(row, d); };
  const int row0 = wg * kWgRows + 16 * (warp % 4);
  float dka[kAcc], dva[kAcc];
  zero(dka);
  zero(dva);
  mbar_wait(kvfull, 0);
  for (int j = 0; j < dkv_block(block_index(), P).nt; ++j) {
    const int s = j % kDkvStages;
    const std::uint32_t stage = ring + s * kDkvStageBytes;
    const unsigned char* tile = gbase + (stage - base);
    mbar_wait(full + 8 * s, (j / kDkvStages) & 1);
    // both warpgroups are done with the last tile's float32 copies; q
    // scale and do of this one in float32, and its lse and delta
    consumers_sync();
    {
      const DkvBlock blk = dkv_block(block_index(), P);
      const int q0 = dkv_tile_q0(blk, j), bh = dkv_tile_bh(blk, j, P);
      to_f32(qsf, tile, kTile, kTileBox, P.scale, rows_at);
      to_f32(dof, tile + kTileBytes, kTile, kTileBox, 1.f, rows_at);
      if (threadIdx.x < kTile) {
        const size_t row = (size_t)bh * P.Sq + q0 + threadIdx.x;
        st[threadIdx.x] = lse[row];
        st[kTile + threadIdx.x] = delta[row];
      }
    }
    consumers_sync();
    const int q0 = dkv_tile_q0(dkv_block(block_index(), P), j);
    const bool live = !P.causal || q0 + kTile - 1 >= krow0;
    // s^T = k (q scale)^T and dp^T = v do^T on the CUDA cores. s waits in
    // the warp's exchange buffer while dp is summed, and dp goes through
    // the warp's own 4 KiB of q scale, free once both warpgroups have
    // summed s: neither fragment lives in registers during the other's
    // sums (with s's, ptxas spilled the unrolled loop).
    float x[4][8];
    if (live) {
      dkv_sums(x, gbase + kDkvK, qsf, row0, lane, P.D);
      park(x, xbuf, lane, dkv_key, dkv_query);
    }
    consumers_sync();
    if (live) {
      float* xdp = qsf + warp * (kXBytes / 4);
      dkv_sums(x, gbase + kDkvV, dof, row0, lane, P.D);
      park(x, xdp, lane, dkv_key, dkv_query);
      __syncwarp();
      float sc[kFrag], dp[kFrag];
      fragment(sc, xbuf, t);
      fragment(dp, xdp, t);
      dkv_p_ds(sc, dp, t, krow0, q0, st, st + kTile, P);
      // dv += p^T do, then dk += ds^T q on the tensor cores, half a tile's
      // terms at a time
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        std::uint32_t terms[kTerms][kFrag / 4];
        split_terms(sc, part * kFrag / 2, terms);
        term_products(dva, terms, stage + kTileBytes, part * kSlices / 2);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        std::uint32_t terms[kTerms][kFrag / 4];
        split_terms(dp, part * kFrag / 2, terms);
        term_products(dka, terms, stage, part * kSlices / 2);
      }
    }
    // the tile's q and do are read: release the stage
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  const DkvBlock blk = dkv_block(block_index(), P);
  store_rows(dk, P.Sk, blk.bkv, krow0, t, dka, P.scale * kTermUnscale, P);
  store_rows(dv, P.Sk, blk.bkv, krow0, t, dva, kTermUnscale, P);
}

int encode_maps(CUtensorMap (&maps)[4], const void* const (&srcs)[4],
                const Dims& P, int q_rows, int kv_rows) {
  for (int i = 0; i < 4; ++i) {
    const int rows = i == kMapQ || i == kMapDo ? q_rows : kv_rows;
    const int err = encode_map(&maps[i], map_spec(i, P, rows), srcs[i]);
    if (err != 0) return err;
  }
  return 0;
}

int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, const Dims& P, void* stream) {
  CUtensorMap maps[4];
  const void* const srcs[4] = {q, k, v, dout};
  const int err = encode_maps(maps, srcs, P, kTcRows, kTile);
  if (err != 0) return err;
  const int n = P.B * P.H * cdiv(P.Sq, kTcRows);
  const int smem = dq_tc_smem_bytes(kDqStages);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_tc_kernel<<<n, kTcThreads, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(dq), P);
  return (int)cudaGetLastError();
}

int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const Dims& P, void* stream) {
  CUtensorMap maps[4];
  const void* const srcs[4] = {q, k, v, dout};
  const int err = encode_maps(maps, srcs, P, kTile, kTcRows);
  if (err != 0) return err;
  const int n = P.B * P.Kv * cdiv(P.Sk, kTcRows);
  const int smem = dkv_tc_smem_bytes(kDkvStages);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_tc_kernel<<<n, kTcThreads, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), P);
  return (int)cudaGetLastError();
}

#else  // the host models of flash_dq_tc_kernel and flash_dkv_tc_kernel

// A model's tensor maps, sources and TMA copy into its shared memory.
struct Loads {
  SmemModel& model;
  MapSpec maps[4];
  const void* srcs[4];
  void operator()(int map, std::uint32_t dst, int x0, int x1, int x2) const {
    model.copy(maps[map], srcs[map], dst, x0, x1, x2);
  }
};

// `rows` rows x 128 columns of the bf16 tile at `tile` (boxes `box` apart)
// times mul, into float32 at dst[at(row, d)].
template <class At>
void model_to_f32(SmemModel& model, std::vector<float>& dst,
                  std::uint32_t tile, int rows, int box, float mul,
                  const At& at) {
  for (int row = 0; row < rows; ++row)
    for (int d = 0; d < kMaxD; ++d)
      dst[at(row, d)] = model.at(tile + tile_at(box, row, d)) * mul;
}

// One warp's sums as its lanes compute them (x float32 rows, y bf16 rows
// through the model), through its exchange buffer into the fragments
// frag[t] of the warp's threads. row(lane, i) and col(lane, j) index the
// warp's 16 rows and the tile's 64 columns; xrow / yrow map them to rows of
// the float32 copy and of the bf16 tile.
template <int I, int J, class Row, class Col, class XRow, class YRow,
          class XAt>
void model_sums(SmemModel& model, float (*frag)[kFrag], int warp,
                const std::vector<float>& x, const XAt& x_at_,
                std::uint32_t y, int box, const Row& row, const Col& col,
                const XRow& xrow, const YRow& yrow, int D) {
  std::vector<float> xbuf(16 * kTile);
  for (int lane = 0; lane < 32; ++lane)
    for (int i = 0; i < I; ++i)
      for (int j = 0; j < J; ++j) {
        float s = 0.f;
        for (int d = 0; d < D; ++d)
          s = fmaf(x[x_at_(xrow(lane, i, j), d)],
                   model.at(y + tile_at(box, yrow(lane, i, j), d)), s);
        xbuf[x_at(row(lane, i), col(lane, j))] = s;
      }
  for (int t = 32 * warp; t < 32 * warp + 32; ++t)
    for (int i = 0; i < kFrag; ++i)
      frag[t][i] = xbuf[x_at(frag_row(t, i) % 16, frag_col(t, i))];
}

// The three-term A operands of slices [first, first + slices) of each
// thread's fragment x[t] into products acc[64][128] with B through mn_desc
// of `tile`, as term_products issues them.
void model_term_products(SmemModel& model, const float (*x)[kFrag],
                         std::uint32_t tile, int first, int slices,
                         std::vector<float>& acc) {
  std::vector<std::uint32_t> terms(128 * kTerms * kFrag / 2);
  for (int t = 0; t < 128; ++t) {
    std::uint32_t tt[kTerms][kFrag / 2];
    split_terms(x[t], 0, tt);
    for (int u = 0; u < kTerms; ++u)
      for (int r = 0; r < kFrag / 2; ++r)
        terms[(t * kTerms + u) * (kFrag / 2) + r] = tt[u][r];
  }
  for (int kk = first; kk < first + slices; ++kk)
    for (int u = 0; u < kTerms; ++u) {
      float A[kMmaM][kMmaK];
      for (int t = 0; t < 128; ++t)
        for (int r = 0; r < 4; ++r)
          for (int h = 0; h < 2; ++h)
            A[a_row(t, r)][a_col(t, r, h)] =
                half_of(terms[(t * kTerms + u) * (kFrag / 2) + 4 * kk + r], h);
      model_wgmma(model, A, mn_desc(tile, kk), 1, kMaxD, acc.data());
    }
}

// Thread t's fragment of a [64][n] row-major matrix.
void fragment_from(float (&frag)[kAcc], const std::vector<float>& m, int t) {
  for (int i = 0; i < kAcc; ++i)
    frag[i] = m[frag_row(t, i) * kMaxD + frag_col(t, i)];
}

int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, const Dims& P, void*) {
  SmemModel model;  // from the ring on; the float32 copies are vectors
  model.smem.assign(kDqStages * kDqStageBytes, 0);
  const Loads copy{model,
                   {map_spec(0, P, kTcRows), map_spec(1, P, kTile),
                    map_spec(2, P, kTile), map_spec(3, P, kTcRows)},
                   {q, k, v, dout}};
  const auto at = [](int row, int d) { return dq_f32_at(row, d); };
  std::vector<float> qs(kTcRows * kMaxD), dof(kTcRows * kMaxD);
  std::vector<std::vector<float>> acc(kConsumers,
                                      std::vector<float>(kWgRows * kMaxD));
  float sc[128][kFrag], dp[128][kFrag];
  for (int index = 0; index < P.B * P.H * cdiv(P.Sq, kTcRows); ++index) {
    const DqBlock blk = dq_block(index, P);
    dq_once_loads(copy, 0, blk);
    model_to_f32(model, qs, 0, kTcRows, kResBox, P.scale, at);
    model_to_f32(model, dof, kDqStageBytes, kTcRows, kResBox, 1.f, at);
    for (auto& a : acc) std::fill(a.begin(), a.end(), 0.f);
    for (int j = 0; j < blk.nk; ++j) {
      const int k0 = j * kTile;
      const std::uint32_t stage = (j % kDqStages) * kDqStageBytes;
      dq_stage_loads(copy, stage, k0, blk);
      for (int wg = 0; wg < kConsumers; ++wg) {
        const int qrow0 = blk.q0 + wg * kWgRows;
        if (P.causal && k0 > qrow0 + kWgRows - 1) continue;
        for (int warp = 0; warp < 4; ++warp) {
          const int row0 = wg * kWgRows + 16 * warp;
          const auto xrow = [&](int lane, int i, int) {
            return row0 + dq_row(lane, i);
          };
          const auto yrow = [](int lane, int, int j) {
            return dq_key(lane, j);
          };
          model_sums<8, 4>(model, sc, warp, qs, at, stage, kTileBox,
                           dq_row, dq_key, xrow, yrow, P.D);
          model_sums<8, 4>(model, dp, warp, dof, at, stage + kTileBytes,
                           kTileBox, dq_row, dq_key, xrow, yrow, P.D);
        }
        for (int t = 0; t < 128; ++t) {
          float lse_r[2], delta_r[2];
          for (int r = 0; r < 2; ++r) {
            const int row = qrow0 + frag_row(t, 2 * r);
            const bool in = row < P.Sq;
            lse_r[r] = in ? lse[(size_t)blk.bh * P.Sq + row] : 0.f;
            delta_r[r] = in ? delta[(size_t)blk.bh * P.Sq + row] : 0.f;
          }
          dq_p_ds(sc[t], dp[t], t, qrow0, k0, lse_r, delta_r, P);
        }
        model_term_products(model, sc, stage, 0, kSlices, acc[wg]);
      }
    }
    for (int wg = 0; wg < kConsumers; ++wg)
      for (int t = 0; t < 128; ++t) {
        float a[kAcc];
        fragment_from(a, acc[wg], t);
        store_rows(static_cast<__nv_bfloat16*>(dq), P.Sq, blk.bh,
                   blk.q0 + wg * kWgRows, t, a, P.scale * kTermUnscale, P);
      }
  }
  return model.ok ? 0 : -3;
}

int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const Dims& P, void*) {
  SmemModel model;  // the bf16 tiles at their offsets; the float32 copies
                    // and lse, delta are vectors of their own
  model.smem.assign(kDkvRing + kDkvStages * kDkvStageBytes, 0);
  const Loads copy{model,
                   {map_spec(0, P, kTile), map_spec(1, P, kTcRows),
                    map_spec(2, P, kTcRows), map_spec(3, P, kTile)},
                   {q, k, v, dout}};
  const auto at = [](int row, int d) { return dkv_f32_at(row, d); };
  std::vector<float> qs(kTile * kMaxD), dof(kTile * kMaxD), st(2 * kTile);
  std::vector<std::vector<float>> dka(kConsumers,
                                      std::vector<float>(kWgRows * kMaxD)),
      dva = dka;
  float sc[128][kFrag], ds[128][kFrag];
  for (int index = 0; index < P.B * P.Kv * cdiv(P.Sk, kTcRows); ++index) {
    const DkvBlock blk = dkv_block(index, P);
    dkv_once_loads(copy, 0, blk);
    for (int wg = 0; wg < kConsumers; ++wg) {
      std::fill(dka[wg].begin(), dka[wg].end(), 0.f);
      std::fill(dva[wg].begin(), dva[wg].end(), 0.f);
    }
    for (int j = 0; j < blk.nt; ++j) {
      const int q0 = dkv_tile_q0(blk, j), bh = dkv_tile_bh(blk, j, P);
      const std::uint32_t stage = kDkvRing + (j % kDkvStages) * kDkvStageBytes;
      dkv_stage_loads(copy, stage, q0, bh);
      model_to_f32(model, qs, stage, kTile, kTileBox, P.scale, at);
      model_to_f32(model, dof, stage + kTileBytes, kTile, kTileBox, 1.f, at);
      for (int r = 0; r < kTile; ++r) {
        st[r] = lse[(size_t)bh * P.Sq + q0 + r];
        st[kTile + r] = delta[(size_t)bh * P.Sq + q0 + r];
      }
      for (int wg = 0; wg < kConsumers; ++wg) {
        const int krow0 = blk.k0 + wg * kWgRows;
        if (P.causal && q0 + kTile - 1 < krow0) continue;
        for (int warp = 0; warp < 4; ++warp) {
          const int row0 = wg * kWgRows + 16 * warp;
          const auto xrow = [](int lane, int, int j) {
            return dkv_query(lane, j);
          };
          const auto yrow = [&](int lane, int i, int) {
            return row0 + dkv_key(lane, i);
          };
          model_sums<4, 8>(model, sc, warp, qs, at, kDkvK, kResBox, dkv_key,
                           dkv_query, xrow, yrow, P.D);
          model_sums<4, 8>(model, ds, warp, dof, at, kDkvV, kResBox, dkv_key,
                           dkv_query, xrow, yrow, P.D);
        }
        for (int t = 0; t < 128; ++t)
          dkv_p_ds(sc[t], ds[t], t, krow0, q0, st.data(), st.data() + kTile,
                   P);
        for (int part = 0; part < 2; ++part)
          model_term_products(model, sc, stage + kTileBytes,
                              part * kSlices / 2, kSlices / 2, dva[wg]);
        for (int part = 0; part < 2; ++part)
          model_term_products(model, ds, stage, part * kSlices / 2,
                              kSlices / 2, dka[wg]);
      }
    }
    for (int wg = 0; wg < kConsumers; ++wg)
      for (int t = 0; t < 128; ++t) {
        float a[kAcc];
        fragment_from(a, dka[wg], t);
        store_rows(static_cast<__nv_bfloat16*>(dk), P.Sk, blk.bkv,
                   blk.k0 + wg * kWgRows, t, a, P.scale * kTermUnscale, P);
        fragment_from(a, dva[wg], t);
        store_rows(static_cast<__nv_bfloat16*>(dv), P.Sk, blk.bkv,
                   blk.k0 + wg * kWgRows, t, a, kTermUnscale, P);
      }
  }
  return model.ok ? 0 : -3;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// Shared memory in bytes of one block of each float32 kernel at head dim D
// (which 0 = dq, 1 = dk/dv; kernels/flash_attention.py::bwd_smem_plan
// holds the same numbers).
int flash_attention_bwd_smem_bytes(int D, int which) {
  return (int)((which == 0 ? dq_smem_floats(D) : dkv_smem_floats(D)) *
               sizeof(float));
}

// Bytes of dynamic shared memory one block of a tensor-core kernel (which
// 0 = dq, 1 = dk/dv) asks for with `stages` stages
// (kernels/flash_attention.py::bwd_tc_smem_plan states the same by part).
int flash_attention_bwd_tc_smem_bytes(int which, int stages) {
  return which == 0 ? dq_tc_smem_bytes(stages) : dkv_tc_smem_bytes(stages);
}

// The stages each tensor-core kernel is built with.
int flash_attention_bwd_tc_stages(int which) {
  return which == 0 ? kDqStages : kDkvStages;
}

// Launch dq on `stream` and return cudaGetLastError() (0 when the launch
// was accepted), or -1 for dimensions the kernels do not take (D not a
// multiple of 8 in [8, 128], Sq or Sk not a multiple of 64, H not a
// multiple of Kv, an empty grid), or -2 where cuTensorMapEncodeTiled
// refuses a tensor map (q, k, v or dout not 16-byte aligned). q, k, v,
// dout, dq are device pointers of float (bf16 = 0: the CUDA-core kernel)
// or __nv_bfloat16 (bf16 = 1: the tensor-core kernel); lse and delta are
// float32 [B, H, Sq].
int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Kv, int Sq, int Sk, int D, int causal,
                              int bf16, float scale, void* stream) {
  if (!takes(B, H, Kv, Sq, Sk, D)) return -1;
  const Dims P{B, H, Kv, Sq, Sk, D, causal, scale};
  return bf16 ? launch_dq_tc(q, k, v, dout, lse, delta, dq, P, stream)
              : launch_dq_f32(q, k, v, dout, lse, delta, dq, P, stream);
}

// Launch dk and dv (one kernel) on `stream`; returns as the dq launcher.
int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int H, int Kv, int Sq, int Sk, int D,
                               int causal, int bf16, float scale,
                               void* stream) {
  if (!takes(B, H, Kv, Sq, Sk, D)) return -1;
  const Dims P{B, H, Kv, Sq, Sk, D, causal, scale};
  return bf16 ? launch_dkv_tc(q, k, v, dout, lse, delta, dk, dv, P, stream)
              : launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, P, stream);
}

}  // extern "C"
