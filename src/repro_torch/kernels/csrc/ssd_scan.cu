// Chunked Mamba2 / SSD scan for Hopper (sm_90a): y and the final state of
// the selective state-space recurrence
//   S_t = exp(dt_t A) S_{t-1} + B_t^T (dt_t x_t),   y_t = C_t S_t
// of every (batch, head) row, in ONE launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py:69
// ssd_scan (body _ssd_kernel :25, pallas_call :77) of the JAX package, and
// computes what it computes, chunk by chunk of Q steps: the log-decay
// a = dt A and its inclusive cumsum; the intra-chunk scores
// (C B^T) * exp(cum_t - cum_s) * dt_s for s <= t (0 above the diagonal,
// taken by select: there the exponent is positive and may overflow, and a
// 0/1 mask would turn inf * 0 into NaN) applied to x; plus
// (C S_prev) * exp(cum_t); y rounded once to x's type; then
// S = exp(a_tot) S_prev + B^T (x * exp(a_tot - cum) dt), carried in float32
// to the next chunk and written out, float32, after the last.
//
// Layouts (the reference's): x [BH, S, P] float or bfloat16; dt [BH, S]
// float (after softplus); A [BH] float (negative); Bm, Cm [B, S, N] in x's
// type, row bh reading batch bh / heads; y [BH, S, P] in x's type; state
// [BH, N, P] float. Any chunk Q in [1, 256] that divides S; N and P
// multiples of 4 in [4, 64]; bf16 x, Bm, Cm 8-byte aligned.
//
// The TPU kernel walks a row's chunks along a sequential grid axis with
// the state in VMEM scratch and does its products on the MXU. On Hopper
// blocks run at once, in no order, so that grid axis becomes tickets and
// a chain of published states, and the products go to wgmma.
//
// Which dtype takes which kernel:
//   bfloat16 -> ssd_scan_tc_kernel: the products on the tensor cores
//               (wgmma), the chunks of a row in parallel across the card.
//               This is what serving runs.
//   float32  -> ssd_scan_kernel: float32 FMAs on the CUDA cores, one block
//               per row. A tensor-core float32 product would be TF32,
//               which the port never uses.
//
// What bounds it. At zamba2-7b's prefill of 4 x 4096 tokens (BH 448, Q 256,
// N = P = 64) one launch needs 448 x 16 chunks x 6,307,840 multiply-adds
// (the lower triangle of the two [Q, Q] products, C S_prev and
// B^T (x w)) = 9.0e10 operations on 489 MB of bf16 x and y (plus dt, B, C
// and the float32 state): 0.146 ms of bytes at 3.35 TB/s against 0.091 ms
// of bf16 tensor-core operations, so bytes bound it
// (kernels/ssd_scan.py::work). The float32 CUDA cores' ceiling for the
// same operations is 1.35 ms; the tensor-core kernel issues 2.4e11
// operations (kernels/ssd_scan.py::tc_operations: the zero-filled tiles
// and the three bf16 terms of each float32 operand), 0.24 ms at the bf16
// peak.
//
// Precision plan of the bfloat16 kernel (held on zamba2-7b's 81 layers:
// y within one bf16 step of the largest value with at most 1e-3 of the
// elements more than one step off, the float32 state within 1e-6). C B^T
// is an exact product of bf16 values, summed in float32 in the tensor
// cores' order. The decayed scores are computed on the CUDA cores as the
// plain version computes them. The scores, the carried state S_{c-1} and
// x w (x times w, rounded once as the plain version's x * w) enter their
// products as three bf16 terms (split_terms: hi = bf16(v), mid = bf16(v -
// hi), lo = bf16(v - hi - mid)), which hold a float32 exactly, so every
// product sees the plain version's float32 operands and only the order of
// the sums differs. One term instead of three puts 5-9 % of y more than a
// bf16 step off and the state 2-3e-3 off; two terms keep y within its
// bounds but put the state 2-6e-6 off (tests/test_torch_ssd.py pins the
// plan).
//
// bfloat16 design (ssd_scan_tc_kernel). One persistent block of 256
// threads (two warpgroups) per SM takes tiles, one (row, chunk) each, from
// an atomic ticket counter, the rows of a chunk fastest. The tiles of a
// row run in parallel; only the [N, P] state passes from chunk to chunk:
// the block of chunk c waits for the flag of chunk c - 1, whose ticket is
// BH earlier and so is held by a running block (at the serving shape
// 448 tickets, several tiles' time, earlier: the wait is all but never
// felt). Per tile:
//   - the loads of the block's NEXT tile go out first, into the other of
//     two buffers: x, B and C of the chunk as one TMA box each (64
//     columns of 128 bytes, Q rounded up to 64 rows, in the 128-byte
//     swizzle, zero past Q, N and P; three-dimensional maps over x {P, Q,
//     BH S / Q} and B, C {N, Q, B S / Q}); where P or N is not a multiple
//     of 8 (TMA wants 16-byte rows) all threads copy them by cp.async, 8
//     bytes at a time. dt of the next chunk comes by one warp's cp.async;
//   - the first warpgroup reads S_{c-1} from its slot (after its flag,
//     ld.acquire);
//   - L^T = (x w)^T B, the chunk's own contribution to the state, by RS
//     wgmma m64n64k16, A = x w as three bf16 terms from registers, each
//     warpgroup over half the rows of the chunk, two slices in flight; the
//     second's part goes to the first through shared memory;
//   - the chain, by the first warpgroup: S_c = exp(a_tot) S_{c-1} + L_c,
//     one rounding each as the plain version; S_c to its slot,
//     __threadfence, the flag (st.release), or, for the last chunk, to
//     state_out; then S_{c-1} as three bf16 terms into shared memory for
//     C S_{c-1};
//   - the rows in sub-tiles of 64 (0 and 2 to the first warpgroup, 1 and 3
//     to the second): per tile pair at or left of the diagonal, C B^T by
//     SS wgmma, the decayed scores in the accumulator fragment (cb
//     exp(cum_t - cum_s) dt_s; on a diagonal tile exp's argument above
//     the diagonal is -inf, so no exp overflows), their three bf16 terms
//     straight from the fragment into the A registers of scores x (for a
//     16-bit A the accumulator of columns 16 kk.. is, pair by pair, the A
//     fragment of slice kk), slice by slice so that a slice's split runs
//     while the tensor cores take the slice before, the next pair's C B^T
//     (or, after the last pair, C S_{c-1}: SS, the three terms) queued
//     behind; y = intra + (C S_{c-1}) exp(cum_t) rounded once to bf16, at
//     P = 64 passed between the threads of a quad by shuffles so that each
//     writes 16 bytes at a time;
//   - the warp that loaded dt of the next chunk, once its rows are done:
//     that chunk's cumsum of dt A and w = exp(a_tot - cum) dt, in float64,
//     each prefix rounded once to float32, 8 steps a lane and a scan
//     across the lanes (the float32 kernel's one-thread order and
//     torch.cumsum's give the same prefixes wherever the float64 sums are
//     exact, which they are while the steps lie within 2^22 of each
//     other).
// The products read an accumulator only after wgmma.wait_group 0, and
// what the control flow around them depends on is warp-uniform to the
// compiler (read through a shuffle): else ptxas serializes every wgmma.
// Nothing is summed by atomics and each sum has one order, so two
// launches agree bitwise. The block is held to one per SM by its shared
// memory (ssd_scan_tc_smem_bytes = kernels/ssd_scan.py::tc_smem_plan,
// 228,376 B: the two buffers take 192 KiB) and its registers. The wrapper
// allocates the scratch: the carried states [S / Q, BH, 64 x 64] float32
// (117 MB at the serving shape) and the flags and the ticket counter
// (zeroed).
//
// float32 design (ssd_scan_kernel). One block of 256 threads per bh, the
// chunks a loop inside it (the TPU's sequential grid axis), the [N, P]
// float32 state resident in shared memory. The [Q, Q] score tile is never
// built: at Q 256 it would take 262,144 B, over the 232,448 B a block may
// use. A chunk's x and B^T are staged once as float32, then its rows are
// taken in sub-tiles of 64: C of the sub-tile is staged transposed, and
// for each column sub-tile at or left of the diagonal the scores of the
// 64 x 64 pair are computed into shared memory and folded into a float32
// y accumulator, so that the sum over s runs in ascending order, one FMA
// chain per output. C S_prev and the write of y follow; all rows of a
// chunk are done before the state update, which reads S_prev. The cumsum
// is one thread's sequential prefix, summed in float64 and rounded once
// per step (XLA's float32 cumsum has an order of its own; this one is the
// closest to the exact sums, and the plain version's float64 cumsum
// rounds to the same values). Shared memory per block (csrc plan_of =
// kernels/ssd_scan.py::smem_plan): 203,776 B at Q 256, N = P = 64. Every
// phase is a loop strided by blockDim.x whose iterations write disjoint
// elements, separated by __syncthreads(), so one thread per block
// computes the same (the CPU emulation in the tests runs it so).
//
// Without nvcc (the CPU emulation in the tests), the bfloat16 launcher runs
// a host model of the tensor-core kernel instead: the tickets taken in
// turn by one block, the buffers alternating, the TMA boxes (zero fill
// and 128-byte swizzle written out) or the 8-byte copies, the lanes'
// cumsum, each warpgroup's A fragments and three-term packing, the
// second warpgroup's part of L, the chain through the slots and flags, the
// decayed scores in the fragment, the epilogue (at P = 64 the quads'
// shuffles exchanged between the modelled lanes), and each wgmma read
// through its descriptors as the tensor cores address the swizzled
// layouts (tma_wgmma.cuh, shared with gmm.cu and the flash kernels). It
// cannot show the PTX, the barriers, the blocks running at once, the
// fragment layout on the card or the tensor cores' own order of sums; the
// card's checks do.

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

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows (and columns) of a score sub-tile
constexpr int kMaxChunk = 256;
constexpr int kMaxNP = 64;       // the largest N and P
constexpr int kPad = 8;          // row padding of the transposed tiles
constexpr int kLdC = kTile + kPad;

struct Dims {
  int BH, S, P, N, Q, heads;
};

// Offsets (floats) of the parts of dynamic shared memory, in order. Every
// size is a multiple of 4 floats, so every part is 16-byte aligned.
struct Plan {
  int Qp, ldb;                 // Q rounded up to kTile; row stride of B^T
  int state, x, bt, ct, sc, yacc, cum, dt, w, total;
};

__host__ __device__ inline Plan plan_of(int Q, int N, int P) {
  Plan pl;
  pl.Qp = (Q + kTile - 1) / kTile * kTile;
  pl.ldb = pl.Qp + kPad;
  int o = 0;
  pl.state = o; o += N * P;            // [N][P] the carried state
  pl.x = o;     o += pl.Qp * P;        // [Qp][P] x of the chunk
  pl.bt = o;    o += N * pl.ldb;       // [N][ldb] B^T of the chunk
  pl.ct = o;    o += N * kLdC;         // [N][kLdC] C^T of a row sub-tile
  pl.sc = o;    o += kTile * kTile;    // [s][t] scores of a tile pair
  pl.yacc = o;  o += kTile * P;        // [t][P] y accumulator
  pl.cum = o;   o += pl.Qp;            // inclusive cumsum of dt A
  pl.dt = o;    o += pl.Qp;            // dt of the chunk
  pl.w = o;     o += pl.Qp;            // exp(a_tot - cum) dt
  pl.total = o;
  return pl;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, Dims D) {
  extern __shared__ float smem[];
  const int N = D.N, P = D.P, Q = D.Q;
  const Plan pl = plan_of(Q, N, P);
  const int Qp = pl.Qp, ldb = pl.ldb;
  float* S = smem + pl.state;
  float* xs = smem + pl.x;
  float* bt = smem + pl.bt;
  float* ct = smem + pl.ct;
  float* sc = smem + pl.sc;
  float* yacc = smem + pl.yacc;
  float* cum = smem + pl.cum;
  float* dts = smem + pl.dt;
  float* w = smem + pl.w;

  const int bh = blockIdx.x;
  const float a_h = A[bh];
  const float* xh = x + (size_t)bh * D.S * P;
  const float* dth = dt + (size_t)bh * D.S;
  const float* Bb = Bm + (size_t)(bh / D.heads) * D.S * N;
  const float* Cb = Cm + (size_t)(bh / D.heads) * D.S * N;
  float* yh = y + (size_t)bh * D.S * P;
  const int np4 = P / 4, nn4 = N / 4;

  for (int e = threadIdx.x; e < N * P; e += blockDim.x) S[e] = 0.f;

  for (int base = 0; base < D.S; base += Q) {
    __syncthreads();  // the previous chunk's state update is done
    // stage x and B^T of the chunk as float32, zero past Q; a warp's 32
    // lanes take 8 steps x 4 state dims of B, so the transposing stores
    // fall on 32 banks (ldb = 8 mod 32)
    for (int e = threadIdx.x; e < Qp * P; e += blockDim.x) {
      const int s = e / P;
      xs[e] = s < Q ? xh[(size_t)(base + s) * P + e % P] : 0.f;
    }
    for (int e = threadIdx.x; e < Qp * N; e += blockDim.x) {
      const int lane = e & 31, rest = e >> 5;
      const int n = (rest % nn4) * 4 + (lane & 3);
      const int s = (rest / nn4) * 8 + (lane >> 2);
      bt[n * ldb + s] = s < Q ? Bb[(size_t)(base + s) * N + n] : 0.f;
    }
    for (int e = threadIdx.x; e < Qp; e += blockDim.x)
      dts[e] = e < Q ? dth[base + e] : 0.f;
    __syncthreads();
    // a = dt A (float32) and its inclusive cumsum, accumulated in order in
    // float64 and each prefix rounded once to float32
    for (int e = threadIdx.x; e < 1; e += blockDim.x) {
      double run = 0.0;
      for (int s = 0; s < Q; ++s) {
        run += (double)__fmul_rn(dts[s], a_h);
        cum[s] = (float)run;
      }
      for (int s = Q; s < Qp; ++s) cum[s] = (float)run;
    }
    __syncthreads();
    const float a_tot = cum[Q - 1];
    for (int e = threadIdx.x; e < Qp; e += blockDim.x)
      w[e] = e < Q ? __fmul_rn(expf(__fsub_rn(a_tot, cum[e])), dts[e]) : 0.f;

    for (int r0 = 0; r0 < Qp; r0 += kTile) {
      __syncthreads();  // the previous sub-tile's readers are done
      for (int e = threadIdx.x; e < kTile * N; e += blockDim.x) {
        const int lane = e & 31, rest = e >> 5;
        const int n = (rest % nn4) * 4 + (lane & 3);
        const int t = (rest / nn4) * 8 + (lane >> 2);
        ct[n * kLdC + t] =
            r0 + t < Q ? Cb[(size_t)(base + r0 + t) * N + n] : 0.f;
      }
      for (int e = threadIdx.x; e < kTile * P; e += blockDim.x) yacc[e] = 0.f;

      for (int q0 = 0; q0 <= r0; q0 += kTile) {
        __syncthreads();
        // scores of rows r0.. against columns q0..: 4 x 4 per item,
        // stored transposed ([s][t])
        for (int e = threadIdx.x; e < (kTile / 4) * (kTile / 4);
             e += blockDim.x) {
          const int i0 = (e % (kTile / 4)) * 4, j0 = (e / (kTile / 4)) * 4;
          float acc[4][4] = {};
          for (int n = 0; n < N; ++n) {
            const float4 c = ld4(ct + n * kLdC + i0);
            const float4 b = ld4(bt + n * ldb + q0 + j0);
            const float cv[4] = {c.x, c.y, c.z, c.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = q0 + j0 + j;
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = r0 + i0 + i;
              v[i] = 0.f;
              if (s <= t && s < Q)
                v[i] = __fmul_rn(
                    __fmul_rn(acc[i][j], expf(__fsub_rn(cum[t], cum[s]))),
                    dts[s]);
            }
            *reinterpret_cast<float4*>(sc + (j0 + j) * kTile + i0) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        __syncthreads();
        // yacc += scores x: 4 rows x 4 columns of P per item, s ascending
        for (int e = threadIdx.x; e < (kTile / 4) * np4; e += blockDim.x) {
          const int i0 = (e % (kTile / 4)) * 4, p0 = (e / (kTile / 4)) * 4;
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = ld4(yacc + (i0 + i) * P + p0);
            acc[i][0] = a.x;
            acc[i][1] = a.y;
            acc[i][2] = a.z;
            acc[i][3] = a.w;
          }
          for (int j = 0; j < kTile; ++j) {
            const float4 a = ld4(sc + j * kTile + i0);
            const float4 b = ld4(xs + (q0 + j) * P + p0);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(yacc + (i0 + i) * P + p0) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();
      // y = yacc + (C S_prev) * exp(cum), rounded once to x's type
      for (int e = threadIdx.x; e < (kTile / 4) * np4; e += blockDim.x) {
        const int i0 = (e % (kTile / 4)) * 4, p0 = (e / (kTile / 4)) * 4;
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 c = ld4(ct + n * kLdC + i0);
          const float4 s = ld4(S + n * P + p0);
          const float cv[4] = {c.x, c.y, c.z, c.w};
          const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[i][k] = fmaf(cv[i], sv[k], acc[i][k]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + i0 + i;
          if (t >= Q) continue;
          const float decay = expf(cum[t]);
          float* row = yh + (size_t)(base + t) * P + p0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            row[k] = __fadd_rn(yacc[(i0 + i) * P + p0 + k],
                               __fmul_rn(acc[i][k], decay));
        }
      }
    }
    __syncthreads();
    // S = exp(a_tot) S_prev + B^T (x * w): 4 state dims x 4 columns of P
    // per item, s ascending
    const float keep = expf(a_tot);
    for (int e = threadIdx.x; e < nn4 * np4; e += blockDim.x) {
      const int p0 = (e % np4) * 4, n0 = (e / np4) * 4;
      float acc[4][4] = {};
      for (int s = 0; s < Q; ++s) {
        const float4 xv = ld4(xs + s * P + p0);
        const float ws = w[s];
        const float xw[4] = {__fmul_rn(xv.x, ws), __fmul_rn(xv.y, ws),
                             __fmul_rn(xv.z, ws), __fmul_rn(xv.w, ws)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float b = bt[(n0 + i) * ldb + s];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(b, xw[k], acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* st = S + (n0 + i) * P + p0 + k;
          *st = __fadd_rn(__fmul_rn(keep, *st), acc[i][k]);
        }
    }
  }
  __syncthreads();
  float* so = state_out + (size_t)bh * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) so[e] = S[e];
}

bool dims_ok(int BH, int S, int P, int N, int Q, int heads) {
  return BH > 0 && S > 0 && Q >= 1 && Q <= kMaxChunk && S % Q == 0 &&
         N >= 4 && N <= kMaxNP && N % 4 == 0 && P >= 4 && P <= kMaxNP &&
         P % 4 == 0 && heads > 0 && BH % heads == 0;
}

int launch_f32(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, void* y, float* state,
               const Dims& D, void* stream) {
  const int n = D.BH;
  const int smem = (int)(plan_of(D.Q, D.N, D.P).total * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), state, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. What follows up to the CUDA-only part is shared by
// the kernel and the host model.

constexpr int kTcThreads = 256;             // two warpgroups
constexpr int kRows = kMmaM;                // rows of a sub-tile: a wgmma's
constexpr int kCols = 64;                   // N and P zero-filled to 64
constexpr int kTerms = 3;                   // bf16 terms of a float32 operand
constexpr int kFrag = kRows * kCols / 128;  // m64n64 accumulators a thread
constexpr int kTileBytes = kMaxChunk * kRowBytes;  // x, B or C: 32 KiB
constexpr int kTermBytes = kCols * kRowBytes;      // a state term: 8 KiB
// a buffer: x, B and C of a chunk; two, so that one chunk's loads run
// while the block works on another
constexpr int kXOff = 0;
constexpr int kBOff = kXOff + kTileBytes;
constexpr int kCOff = kBOff + kTileBytes;
constexpr int kBufBytes = kCOff + kTileBytes;
constexpr int kSOff = 2 * kBufBytes;        // the state's terms
constexpr int kFOff = kSOff + kTerms * kTermBytes;  // cum, w, dt (float)
constexpr int kTicketOff = kFOff + 6 * kMaxChunk * 4;  // two tickets
constexpr int kBarOff = kTicketOff + 8;     // a TMA mbarrier per buffer
constexpr int kTcSmemBytes = kSwizzleAtom + kBarOff + 16;
constexpr int kSlotFloats = kCols * kCols;  // a carried state, [p][n]
static_assert(kCols * kRowBytes / 2 == kCols * kCols, "a row is 64 bf16");
static_assert(kSlotFloats * 4 <= kTerms * kTermBytes,
              "the second warpgroup's part of L^T fits the terms' place");
static_assert(kCols == kRowBytes / 2, "a tile row is one swizzle row");

// cum, w and dt of the chunk of buffer b: floats from kFOff on
__host__ __device__ constexpr int cum_at(int b) { return b * kMaxChunk; }
__host__ __device__ constexpr int w_at(int b) { return (2 + b) * kMaxChunk; }
__host__ __device__ constexpr int dts_at(int b) {
  return (4 + b) * kMaxChunk;
}
constexpr int kPrepWarp = 4;  // readies the next chunk's cumsum and w

// Where element (row, col) of a tile lies before the swizzle: rows of
// 128 bytes, 8-row atoms of 1,024 bytes from a 1,024-aligned start.
__host__ __device__ constexpr std::uint32_t tile_at(int row, int col) {
  return row * kRowBytes + col * 2;
}

// The block's chunk and row from its ticket, the rows of a chunk fastest:
// the block of (row, chunk c) waits only on the ticket BH before its own.
struct Block {
  int c, bh, base;
};
__host__ __device__ inline Block block_of(int ticket, const Dims& D) {
  const int c = ticket / D.BH;
  return {c, ticket % D.BH, c * D.Q};
}

// Whether the chunks come by TMA: rows of x, B and C a multiple of 16
// bytes (P and N multiples of 8) and their starts 16-byte aligned. Else
// the threads copy them by cp.async, 8 bytes at a time.
__host__ __device__ inline bool tma_ok(const Dims& D, const void* x,
                                       const void* Bm, const void* Cm) {
  return D.P % 8 == 0 && D.N % 8 == 0 &&
         ((reinterpret_cast<std::uintptr_t>(x) |
           reinterpret_cast<std::uintptr_t>(Bm) |
           reinterpret_cast<std::uintptr_t>(Cm)) & 15) == 0;
}

// The tensor maps (innermost first): x {P, Q, BH S / Q}, B and C {N, Q,
// B S / Q}, so that a chunk is one box of 64 columns by Q rounded up to 64
// rows, zero past Q and past P or N.
MapSpec map_spec(int map, const Dims& D) {
  const std::uint64_t nc = D.S / D.Q, width = map == 0 ? D.P : D.N;
  const std::uint64_t rows = (map == 0 ? D.BH : D.BH / D.heads) * nc;
  return {{width, (std::uint64_t)D.Q, rows},
          {width * 2, (std::uint64_t)D.Q * width * 2},
          {(std::uint32_t)kCols, (std::uint32_t)(cdiv(D.Q, kRows) * kRows),
           1}};
}

// The TMA loads of chunk `blk` into buffer `buf`: copy(map, shared
// address, c0, c1, c2) with map 0 = x, 1 = B, 2 = C.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void chunk_loads(const Copy& copy,
                                            std::uint32_t buf,
                                            const Block& blk, const Dims& D) {
  const int nc = D.S / D.Q;
  copy(0, buf + kXOff, 0, 0, blk.bh * nc + blk.c);
  copy(1, buf + kBOff, 0, 0, blk.bh / D.heads * nc + blk.c);
  copy(2, buf + kCOff, 0, 0, blk.bh / D.heads * nc + blk.c);
}

// The row sub-tiles of warpgroup wg (0 or 1) in order: 0 and 2, or 1 and
// 3. At Q 256 the first takes 1 + 3 of the causal tile pairs and the
// second 2 + 4: the first also runs the chain.
__host__ __device__ constexpr int row_tile(int wg, int j) {
  return wg + 2 * j;
}

// The descriptors. A = C of row tile r, K-major (n contiguous), slice kk
// of n; B for C B^T = B of column tile q, K-major, slice kk of n; B for
// scores x = x of column tile q, MN-major (p contiguous), slice kk of s;
// B for L^T = (x w)^T B = B, MN-major (n contiguous), slice kk of s; B for
// C S = state term u as [p][n], K-major, slice kk of n. Rows of 128
// bytes, 8-row groups 1,024 bytes apart (SBO); `buf` is the chunk's
// buffer, `sm` the start of shared memory.
__host__ __device__ inline std::uint64_t c_desc(std::uint32_t buf, int r,
                                                int kk) {
  return sw128_desc(buf + kCOff + tile_at(r * kRows, kk * kMmaK), 16,
                    8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t bt_desc(std::uint32_t buf, int q,
                                                 int kk) {
  return sw128_desc(buf + kBOff + tile_at(q * kRows, kk * kMmaK), 16,
                    8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t x_desc(std::uint32_t buf, int q,
                                                int kk) {
  return sw128_desc(buf + kXOff + tile_at(q * kRows + kk * kMmaK, 0),
                    kTileBytes, 8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t b_desc(std::uint32_t buf, int kk) {
  return sw128_desc(buf + kBOff + tile_at(kk * kMmaK, 0), kTileBytes,
                    8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t s_desc(std::uint32_t sm, int u,
                                                int kk) {
  return sw128_desc(sm + kSOff + u * kTermBytes + tile_at(0, kk * kMmaK),
                    16, 8 * kRowBytes);
}

// The 8 values of thread t's A fragment of L^T's slice kk: (x w)[s][p] =
// x_s,p w_s rounded once (the plain version's x * w) at p = a_row(t, r),
// s = 16 kk + a_col(t, r, h), as vals[2 r + h]; xat(s, p) reads x.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class X>
__host__ __device__ inline void xw_slice(const X& xat, const float* w,
                                         int t, int kk, float (&vals)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = kk * kMmaK + a_col(t, r, h);
      vals[2 * r + h] = mul_rn(xat(s, a_row(t, r)), w[s]);
    }
}

// C B^T of rows 64 r.., columns 64 q.. in thread t's fragment to the
// decayed scores, as the plain version: cb exp(cum_t - cum_s) dt_s where
// s <= t, else 0; the fragment's slice kk (columns 16 kk.., registers
// 8 kk..). Only a diagonal tile (q = r) has s > t: there the guard selects
// the exponent (exp(-inf) = 0), not the result, so that no exp runs where
// it may overflow. Past Q, dt is 0 (and only the last tile reaches Q).
template <bool Diagonal>
__host__ __device__ inline void decay_slice(float (&sc)[kFrag], int t, int r,
                                            int q, int kk, const float* cum,
                                            const float* dts) {
#pragma unroll
  for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
    const int tt = r * kRows + frag_row(t, i), s = q * kRows + frag_col(t, i);
    const float d = sub_rn(cum[tt], cum[s]);
    const float e = expf(Diagonal && s > tt ? -INFINITY : d);
    sc[i] = mul_rn(mul_rn(sc[i], e), dts[s]);
  }
}
__host__ __device__ inline void decay_scores(float (&sc)[kFrag], int t,
                                             int r, int q, int kk,
                                             const float* cum,
                                             const float* dts) {
  if (q == r)
    decay_slice<true>(sc, t, r, q, kk, cum, dts);
  else
    decay_slice<false>(sc, t, r, q, kk, cum, dts);
}

// The carried state: S_c = exp(a_tot) S_{c-1} + L_c, one rounding each
// (the plain version's order).
__host__ __device__ inline float chain(float keep, float prev, float l) {
  return add_rn(mul_rn(keep, prev), l);
}

// y of row tile r from thread t's fragments: the intra-chunk sum plus
// (C S_{c-1}) exp(cum_t), rounded once to bf16 (rows >= Q and columns >=
// P masked).
__host__ __device__ inline void store_y(__nv_bfloat16* y, const Dims& D,
                                        const Block& blk, int r, int t,
                                        const float (&acc)[kFrag],
                                        const float (&cs)[kFrag],
                                        const float* cum) {
  float decay[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    decay[h] = expf(cum[r * kRows + frag_row(t, 2 * h)]);
#pragma unroll
  for (int i = 0; i < kFrag; i += 2) {
    const int tt = r * kRows + frag_row(t, i), p = frag_col(t, i);
    const float d = decay[(i / 2) % 2];
    if (tt < D.Q && p < D.P)
      store_pair(y + ((size_t)blk.bh * D.S + blk.base + tt) * D.P + p,
                 add_rn(acc[i], mul_rn(cs[i], d)),
                 add_rn(acc[i + 1], mul_rn(cs[i + 1], d)));
  }
}

// 16 bytes (8 bf16) to a 16-byte aligned p
__host__ __device__ inline void store_16(__nv_bfloat16* p,
                                         const std::uint32_t (&v)[4]) {
#ifdef __CUDACC__
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  std::memcpy(p, v, 16);
#endif
}

// y of row tile r as store_y computes it, where P is 64: the four threads
// of a quad hold, for each of their two rows, the 8 bf16 pairs of columns
// 8 j + 2 (t % 4) (j = 0..7); two rounds of shuffles within the quad (a
// 4 x 4 transpose per half row) give thread t % 4 = k columns 8 k .. 8 k +
// 7 and 32 + 8 k .. 32 + 8 k + 7 of each row, written as 16 bytes each
// (a 4-byte store per pair fills half of each 32-byte sector it touches).
// shfl(v, m) returns v of lane t ^ m: __shfl_xor_sync on the card, the
// host model's exchange (model_store_y_rows) without nvcc.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Shfl>
__host__ __device__ inline void store_y_rows(__nv_bfloat16* y, const Dims& D,
                                             const Block& blk, int r, int t,
                                             const float (&acc)[kFrag],
                                             const float (&cs)[kFrag],
                                             const float* cum,
                                             const Shfl& shfl) {
  const int b = t & 1, B = (t >> 1) & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tt = r * kRows + frag_row(t, 2 * h);
    const float d = expf(cum[tt]);
    std::uint32_t v[8];  // column block j: columns 8 j + 2 (t % 4), + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      v[j] = pack_bf16(add_rn(acc[i], mul_rn(cs[i], d)),
                       add_rn(acc[i + 1], mul_rn(cs[i + 1], d)));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const std::uint32_t* a = v + 4 * half;  // a[c]: block 4 half + c
      // round 1 (lanes t, t ^ 1): x[q][e] = block 2 q + b of row e of the
      // pair of lanes (e = 0 the even lane's)
      std::uint32_t x[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const std::uint32_t own = b ? a[2 * q + 1] : a[2 * q];
        const std::uint32_t got = shfl(b ? a[2 * q] : a[2 * q + 1], 1);
        x[q][0] = b ? got : own;
        x[q][1] = b ? own : got;
      }
      // round 2 (lanes t, t ^ 2): out[m] = block 2 B + b = t % 4 of the
      // quad's row m
      std::uint32_t out[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const std::uint32_t keep = B ? x[1][e] : x[0][e];
        const std::uint32_t got = shfl(B ? x[0][e] : x[1][e], 2);
        out[e] = B ? got : keep;
        out[2 + e] = B ? keep : got;
      }
      if (tt < D.Q)
        store_16(y + ((size_t)blk.bh * D.S + blk.base + tt) * D.P +
                     8 * (4 * half + (t & 3)),
                 out);
    }
  }
}

// Thread t's part of the final state to state_out [BH, N, P] (from the
// [p][n] fragment; n >= N and p >= P masked).
__host__ __device__ inline void store_state(float* state_out, const Dims& D,
                                            int bh, int t,
                                            const float (&st)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int p = frag_row(t, i), n = frag_col(t, i);
    if (p < D.P && n < D.N)
      state_out[((size_t)bh * D.N + n) * D.P + p] = st[i];
  }
}

#ifdef __CUDACC__

// The loads of chunk `blk` into buffer `buf`: x, B and C by TMA (one
// thread arms the buffer's mbarrier `bar` with their bytes) or by all
// threads' cp.async (one group), four bf16 per copy, zero past Q, N and P.
__device__ __forceinline__ void stage(std::uint32_t buf, std::uint32_t bar,
                                      const Block& blk, const Dims& D,
                                      const std::uint64_t* maps, bool tma,
                                      const __nv_bfloat16* x,
                                      const __nv_bfloat16* Bm,
                                      const __nv_bfloat16* Cm) {
  const int Q = D.Q, Qp = cdiv(Q, kRows) * kRows;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, 3 * Qp * kRowBytes);
      chunk_loads(
          [&](int map, std::uint32_t dst, int c0, int c1, int c2) {
            tma_load_3d(dst, maps[map], bar, c0, c1, c2);
          },
          buf, blk, D);
    }
    return;
  }
  const __nv_bfloat16* xr = x + ((size_t)blk.bh * D.S + blk.base) * D.P;
  const size_t bc = ((size_t)(blk.bh / D.heads) * D.S + blk.base) * D.N;
#pragma unroll 4
  for (int e = threadIdx.x; e < Qp * (kCols / 4); e += kTcThreads) {
    const int s = e / (kCols / 4), col = e % (kCols / 4) * 4;
    const bool row = s < Q, liveP = row && col < D.P,
               liveN = row && col < D.N;
    const std::uint32_t at = swizzle128(tile_at(s, col));
    cp_async<8>(buf + kXOff + at, liveP ? xr + (size_t)s * D.P + col : xr,
                liveP);
    cp_async<8>(buf + kBOff + at,
                liveN ? Bm + bc + (size_t)s * D.N + col : Bm + bc, liveN);
    cp_async<8>(buf + kCOff + at,
                liveN ? Cm + bc + (size_t)s * D.N + col : Cm + bc, liveN);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// dt of chunk `blk` into shared memory at `dts` (zero past Q) by one
// warp's cp.async, one group.
__device__ __forceinline__ void stage_dt(std::uint32_t dts, const Block& blk,
                                         const Dims& D, const float* dt,
                                         int lane) {
  const int Q = D.Q, Qp = cdiv(Q, kRows) * kRows;
  const float* dtr = dt + (size_t)blk.bh * D.S + blk.base;
  for (int s = lane; s < Qp; s += 32)
    cp_async<4>(dts + 4 * s, s < Q ? dtr + s : dtr, s < Q);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One warp, once its dt copies are in: cum, the cumsum of dt A in float64,
// each prefix rounded once to float32: each lane sums 8 steps in order,
// the lanes' totals are scanned across the warp. dt A is a float32, so
// where the steps' magnitudes lie within 2^22 of each other every float64
// partial sum is exact, and this order, one thread's and the plain
// version's (torch.cumsum) give the same prefixes. Then w = exp(a_tot -
// cum) dt (0 past Q).
__device__ __forceinline__ void prep(float* cum, float* w, const float* dts,
                                     float a_h, int Q, int Qp, int lane) {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  double part[8], run = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = 8 * lane + k;
    run += s < Q ? (double)__fmul_rn(dts[s], a_h) : 0.0;
    part[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const double o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (8 * lane + k < Qp) cum[8 * lane + k] = (float)(excl + part[k]);
  __syncwarp();
  const float a_tot = cum[Q - 1];
  for (int s = lane; s < Qp; s += 32)
    w[s] = s < Q ? __fmul_rn(expf(__fsub_rn(a_tot, cum[s])), dts[s]) : 0.f;
}

// One block per SM, persistent: it takes tickets until none is left, and
// loads the chunk of its next ticket into one buffer while it works on
// the chunk in the other. Warp kPrepWarp (the second warpgroup's first)
// also loads dt of the next chunk and, once its rows are done, computes
// its cumsum and w (the first warpgroup, which runs the chain, sets the
// time).
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm,
                   __nv_bfloat16* __restrict__ y,
                   float* __restrict__ state_out, float* __restrict__ states,
                   int* __restrict__ flags,
                   const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap, Dims D,
                   int tma) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const std::uint32_t sb = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                           ~(std::uint32_t)(kSwizzleAtom - 1);
  unsigned char* sm = tc_smem + (sb - smem_u32(tc_smem));
  float* floats = reinterpret_cast<float*>(sm + kFOff);
  int* tickets = reinterpret_cast<int*>(sm + kTicketOff);
  // what the control flow around the products depends on is read through
  // a shuffle from lane 0, so that the compiler knows it is the same in a
  // warp: in a branch it cannot prove so, ptxas serializes every wgmma
  // (warning C7520)
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = tid / 32, lane = tid % 32;
  const int Q = D.Q, nc = D.S / Q, nr = cdiv(Q, kRows), Qp = nr * kRows;
  const int total = D.BH * nc;
  int* counter = flags + total;
  const std::uint64_t maps[3] = {reinterpret_cast<std::uint64_t>(&xmap),
                                 reinterpret_cast<std::uint64_t>(&bmap),
                                 reinterpret_cast<std::uint64_t>(&cmap)};
  const std::uint32_t bars = sb + kBarOff;

  if (tid == 0) {
    tickets[0] = atomicAdd(counter, 1);
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int ticket = __shfl_sync(0xffffffffu, tickets[0], 0);
  if (ticket < total) {
    const Block first = block_of(ticket, D);
    if (warp == kPrepWarp) {
      stage_dt(sb + kFOff + dts_at(0) * 4, first, D, dt, lane);
      prep(floats + cum_at(0), floats + w_at(0), floats + dts_at(0),
           A[first.bh], Q, Qp, lane);
    }
    stage(sb, bars, first, D, maps, tma, x, Bm, Cm);
  }
  for (int it = 0; ticket < total; ++it) {
    const int b = it & 1;
    const std::uint32_t buf = sb + b * kBufBytes;
    const float* cum = floats + cum_at(b);
    const float* w = floats + w_at(b);
    const float* dts = floats + dts_at(b);
    // the next ticket's loads into the other buffer (free: every thread
    // is past the chunk that used it), then this chunk's loads are waited
    if (tid == 0) tickets[b ^ 1] = atomicAdd(counter, 1);
    __syncthreads();
    const int next = __shfl_sync(0xffffffffu, tickets[b ^ 1], 0);
    if (next < total) {
      if (warp == kPrepWarp)
        stage_dt(sb + kFOff + dts_at(b ^ 1) * 4, block_of(next, D), D, dt,
                 lane);
      stage(sb + (b ^ 1) * kBufBytes, bars + 8 * (b ^ 1), block_of(next, D),
            D, maps, tma, x, Bm, Cm);
    }
    if (tma)
      mbar_wait(bars + 8 * b, (it >> 1) & 1);
    else if (next < total)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const Block blk = block_of(ticket, D);
    const float a_tot = cum[Q - 1];

    // 1. the first warpgroup waits for S_{c-1} (its publisher holds an
    //    earlier ticket, so it runs; a fault that kept it from publishing
    //    traps, a launch error, instead of hanging) and reads it; it is
    //    all but always there, BH tickets after it was published
    float prev[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) prev[i] = 0.f;
    if (wg == 0 && blk.c > 0) {
      const size_t from = (size_t)(blk.c - 1) * D.BH + blk.bh;
      if (t == 0)
        for (long long polls = 0; ld_acquire(flags + from) == 0; ++polls) {
          if (polls > (1ll << 26)) __trap();
          __nanosleep(32);
        }
      asm volatile("bar.sync 2, 128;" ::: "memory");
      const float* src = states + from * kSlotFloats;
#pragma unroll
      for (int i = 0; i < kFrag; i += 2) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            src + frag_row(t, i) * kCols + frag_col(t, i)));
        prev[i] = v.x;
        prev[i + 1] = v.y;
      }
    }

    // 2. L^T = (x w)^T B of the chunk, each warpgroup over half the slices
    //    of s, A as three bf16 terms from registers, two slices at a time,
    //    each in its own registers: the terms of a slice are written once
    //    the products that read them two slices before are done
    float lacc[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) lacc[i] = 0.f;
    {
      const int half = Qp / kMmaK / 2;
      std::uint32_t terms[2][kTerms][4];
      fence_regs(lacc);
      for (int kk = wg * half; kk < (wg + 1) * half; kk += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float vals[8];
          xw_slice(
              [&](int s, int p) {
                return smem_bf16(sm, buf - sb + kXOff + tile_at(s, p));
              },
              w, t, kk + h, vals);
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          fence_terms(terms[h]);
          split_terms(vals, 0, terms[h]);
          fence_terms(terms[h]);
          wg_fence();
#pragma unroll
          for (int u = 0; u < kTerms; ++u)
            wgmma_m64n64k16_rs<1>(lacc, terms[h][u][0], terms[h][u][1],
                                  terms[h][u][2], terms[h][u][3],
                                  b_desc(buf, kk + h));
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(lacc);
      fence_terms(terms[0]);
      fence_terms(terms[1]);
    }
    // the second warpgroup's part goes to the first through the terms'
    // place
    float* part = reinterpret_cast<float*>(sm + kSOff);
    if (wg == 1)
#pragma unroll
      for (int i = 0; i < kFrag; ++i) part[i * 128 + t] = lacc[i];
    __syncthreads();

    if (wg == 0) {
      // 3. the chain: publish S_c, then S_{c-1} as three bf16 terms for
      //    C S_{c-1}
      const float keep = expf(a_tot);
      const size_t slot = (size_t)blk.c * D.BH + blk.bh;
      float cur[kFrag];
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
        cur[i] = chain(keep, prev[i], __fadd_rn(lacc[i], part[i * 128 + t]));
      if (blk.c + 1 < nc) {
        float* dst = states + slot * kSlotFloats;
#pragma unroll
        for (int i = 0; i < kFrag; i += 2)
          __stcg(reinterpret_cast<float2*>(dst + frag_row(t, i) * kCols +
                                           frag_col(t, i)),
                 make_float2(cur[i], cur[i + 1]));
        __threadfence();
        asm volatile("bar.sync 2, 128;" ::: "memory");
        if (t == 0) st_release(flags + slot, 1);
      } else {
        store_state(state_out, D, blk.bh, t, cur);
        asm volatile("bar.sync 2, 128;" ::: "memory");  // part is read
      }
      std::uint32_t terms[kTerms][kFrag / 2];
      split_terms(prev, 0, terms);
#pragma unroll
      for (int j = 0; j < kFrag / 2; ++j)
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
          *reinterpret_cast<std::uint32_t*>(
              sm + kSOff + u * kTermBytes +
              swizzle128(tile_at(frag_row(t, 2 * j), frag_col(t, 2 * j)))) =
              terms[u][j];
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 2, 128;" ::: "memory");
      asm volatile("bar.arrive 1, 256;" ::: "memory");
    }

    // 4. each warpgroup's row tiles: the intra-chunk y on the tensor cores
    //    (C B^T, the decayed scores in the fragment, scores x from three
    //    bf16 terms), then C S_{c-1}, then y. The second warpgroup waits
    //    for the chain before its first C S_{c-1}.
    bool waited = wg == 0;
    const auto wait_chain = [&] {
      asm volatile("bar.sync 1, 256;" ::: "memory");
      waited = true;
    };
    for (int j = 0; j < 2; ++j) {
      const int r = row_tile(wg, j);
      if (r >= nr) continue;
      float acc[kFrag];
#pragma unroll
      for (int i = 0; i < kFrag; ++i) acc[i] = 0.f;
      // C B^T of the first pair; then per pair, slice by slice, the
      // decayed scores as three bf16 terms into scores x (the split of a
      // slice runs while the tensor cores take the one before), and C B^T
      // of the next pair queued behind, into registers of its own. (ptxas
      // serializes the products where another instruction reads or writes
      // the accumulators of a product in flight: C B^T is read only after
      // every product of the pair is done.)
      float sc[kFrag], next_sc[kFrag], cs[kFrag];
#pragma unroll
      for (int i = 0; i < kFrag; ++i) next_sc[i] = cs[i] = 0.f;
      fence_regs(acc);
      fence_regs(next_sc);
      fence_regs(cs);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / kMmaK; ++kk)
        wgmma_m64n64k16_ss<0>(next_sc, c_desc(buf, r, kk),
                              bt_desc(buf, 0, kk), kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      for (int q = 0; q <= r; ++q) {
        fence_regs(next_sc);
#pragma unroll
        for (int i = 0; i < kFrag; ++i) sc[i] = next_sc[i];
        std::uint32_t terms[kRows / kMmaK][kTerms][4];
#pragma unroll
        for (int kk = 0; kk < kRows / kMmaK; ++kk) {
          decay_scores(sc, t, r, q, kk, cum, dts);
          split_terms(sc, 8 * kk, terms[kk]);
          fence_terms(terms[kk]);
          wg_fence();
#pragma unroll
          for (int u = 0; u < kTerms; ++u)
            wgmma_m64n64k16_rs<1>(acc, terms[kk][u][0], terms[kk][u][1],
                                  terms[kk][u][2], terms[kk][u][3],
                                  x_desc(buf, q, kk));
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        }
        if (q < r) {
#pragma unroll
          for (int kk = 0; kk < kCols / kMmaK; ++kk)
            wgmma_m64n64k16_ss<0>(next_sc, c_desc(buf, r, kk),
                                  bt_desc(buf, q + 1, kk), kk > 0);
        } else {
          // after the last pair: C S_{c-1}, once the chain has written
          // the state's terms
          if (!waited) wait_chain();
#pragma unroll
          for (int kk = 0; kk < kCols / kMmaK; ++kk)
#pragma unroll
            for (int u = 0; u < kTerms; ++u)
              wgmma_m64n64k16_ss<0>(cs, c_desc(buf, r, kk), s_desc(sb, u, kk),
                                    kk + u > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kRows / kMmaK; ++kk) fence_terms(terms[kk]);
      }
      fence_regs(acc);
      fence_regs(cs);
      if (D.P == kCols)
        store_y_rows(y, D, blk, r, t, acc, cs, cum,
                     [](std::uint32_t v, int m) {
                       return __shfl_xor_sync(0xffffffffu, v, m);
                     });
      else
        store_y(y, D, blk, r, t, acc, cs, cum);
    }
    if (!waited) wait_chain();
    // 5. the next chunk's cumsum and w
    if (warp == kPrepWarp && next < total)
      prep(floats + cum_at(b ^ 1), floats + w_at(b ^ 1),
           floats + dts_at(b ^ 1), A[block_of(next, D).bh], Q, Qp, lane);
    // this chunk's buffer is read (the generic loads of x and the
    // products): the next TMA into it comes after the loop's barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    ticket = next;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

int launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, void* y, float* state, float* states,
              int* flags, const Dims& D, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3] = {};
  const bool tma = tma_ok(D, x, Bm, Cm);
  const void* srcs[3] = {x, Bm, Cm};
  for (int i = 0; tma && i < 3; ++i) {
    const int e = encode_map(&maps[i], map_spec(i, D), srcs[i]);
    if (e != 0) return e;
  }
  const int tiles = D.BH * (D.S / D.Q);
  ssd_scan_tc_kernel<<<tiles < sms ? tiles : sms, kTcThreads, kTcSmemBytes,
                       (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      state, states, flags, maps[0], maps[1], maps[2], D, (int)tma);
  return (int)cudaGetLastError();
}

#else  // the host model of ssd_scan_tc_kernel

// One SS product: A read through its descriptor (K-major), B too.
inline void model_ss(SmemModel& model, std::uint64_t da, std::uint64_t db,
                     int trans_b, Mat& acc) {
  float a[kMmaM][kMmaK];
  if (model.read_a(da, a))
    model_wgmma(model, a, db, trans_b, kCols, acc.data());
}

// store_y_rows for the warpgroup's threads in turn: a shuffle returns
// what lane t ^ m passed to the same call in the pass before, so the
// third pass, after both rounds of shuffles have gone through, stores
// what the quads exchange on the card (the addresses do not depend on
// it: the passes before store to the same places).
void model_store_y_rows(__nv_bfloat16* y, const Dims& D, const Block& blk,
                        int r, const float (*acc)[kFrag],
                        const float (*cs)[kFrag], const float* cum) {
  constexpr int kShfls = 16;  // shuffles a thread makes
  static std::uint32_t sent[2][128][kShfls];
  for (int pass = 0; pass < 3; ++pass)
    for (int t = 0; t < 128; ++t) {
      int k = 0;
      store_y_rows(y, D, blk, r, t, acc[t], cs[t], cum,
                   [&](std::uint32_t v, int m) {
                     sent[pass % 2][t][k] = v;
                     return sent[(pass + 1) % 2][t ^ m][k++];
                   });
    }
}

// prep's lanes, in turn: dt of a chunk to its cum and w
void model_prep(float* cum, float* w, const float* dts, float a_h, int Q,
                int Qp) {
  double part[32][8], incl[32];
  for (int l = 0; l < 32; ++l) {
    double run = 0.0;
    for (int k = 0; k < 8; ++k) {
      const int s = 8 * l + k;
      run += s < Q ? (double)__fmul_rn(dts[s], a_h) : 0.0;
      part[l][k] = run;
    }
    incl[l] = run;
  }
  for (int d = 1; d < 32; d *= 2) {
    double o[32];
    for (int l = 0; l < 32; ++l) o[l] = l >= d ? incl[l - d] : 0.0;
    for (int l = d; l < 32; ++l) incl[l] += o[l];
  }
  for (int l = 0; l < 32; ++l)
    for (int k = 0; k < 8; ++k)
      if (8 * l + k < Qp)
        cum[8 * l + k] = (float)((l ? incl[l - 1] : 0.0) + part[l][k]);
  const float a_tot = cum[Q - 1];
  for (int s = 0; s < Qp; ++s)
    w[s] = s < Q ? __fmul_rn(expf(__fsub_rn(a_tot, cum[s])), dts[s]) : 0.f;
}

int launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, void* y, float* state, float* states,
              int* flags, const Dims& D, void*) {
  SmemModel model;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* Bb = static_cast<const __nv_bfloat16*>(Bm);
  const __nv_bfloat16* Cb = static_cast<const __nv_bfloat16*>(Cm);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const int Q = D.Q, nc = D.S / Q, nr = cdiv(Q, kRows), Qp = nr * kRows;
  // cum, w, dt of each buffer's chunk, as in shared memory
  std::vector<float> floats(6 * kMaxChunk, NAN);
  const auto load_dt = [&](int b, const Block& blk) {
    for (int s = 0; s < Qp; ++s)
      floats[dts_at(b) + s] =
          s < Q ? dt[(size_t)blk.bh * D.S + blk.base + s] : 0.f;
  };
  static float frags[2][128][kFrag], prev[128][kFrag];
  static std::uint32_t regs[kTerms][128][4];
  const bool tma = tma_ok(D, x, Bm, Cm);
  const MapSpec maps[3] = {map_spec(0, D), map_spec(1, D), map_spec(2, D)};
  const void* srcs[3] = {x, Bm, Cm};
  model.smem.assign(kTcSmemBytes - kSwizzleAtom, 0xFF);
  const int tiles = D.BH * nc;
  if (tiles > 0) {
    const Block first = block_of(0, D);
    load_dt(0, first);
    model_prep(&floats[cum_at(0)], &floats[w_at(0)], &floats[dts_at(0)],
               A[first.bh], Q, Qp);
  }
  for (int it = 0; it < tiles; ++it) {
    // one block takes every ticket in turn, the buffers alternating; a
    // chunk finds its buffer and the state's terms as the chunk before
    // left them, NaN here, so that a read of a place not written shows
    const int b = it & 1;
    const std::uint32_t buf = b * kBufBytes;
    const float* cum = &floats[cum_at(b)];
    const float* w = &floats[w_at(b)];
    const float* dts = &floats[dts_at(b)];
    std::fill(model.smem.begin() + buf, model.smem.begin() + buf + kBufBytes,
              0xFF);
    std::fill(model.smem.begin() + kSOff,
              model.smem.begin() + kSOff + kTerms * kTermBytes, 0xFF);
    const Block blk = block_of(flags[tiles]++, D);
    // 1. the loads (TMA boxes, or 8-byte copies)
    if (tma) {
      chunk_loads(
          [&](int map, std::uint32_t dst, int c0, int c1, int c2) {
            model.copy(maps[map], srcs[map], dst, c0, c1, c2);
          },
          buf, blk, D);
    } else {
      const size_t bc = ((size_t)(blk.bh / D.heads) * D.S + blk.base) * D.N;
      for (int e = 0; e < Qp * (kCols / 4); ++e) {
        const int s = e / (kCols / 4), col = e % (kCols / 4) * 4;
        const struct {
          int off, width;
          const __nv_bfloat16* src;
        } rows[3] = {
            {kXOff, D.P, xb + ((size_t)blk.bh * D.S + blk.base + s) * D.P},
            {kBOff, D.N, Bb + bc + (size_t)s * D.N},
            {kCOff, D.N, Cb + bc + (size_t)s * D.N}};
        for (const auto& tl : rows) {
          __nv_bfloat16 v[4] = {};
          if (s < Q && col < tl.width) std::memcpy(v, tl.src + col, 8);
          model.store(buf + tl.off + tile_at(s, col), v, 8);
        }
      }
    }
    const float a_tot = cum[Q - 1];

    // 2. L^T by the two warpgroups, each over half the slices of s
    const int half = Qp / kMmaK / 2;
    for (int wg = 0; wg < 2; ++wg) {
      Mat lmat(kRows * kCols, 0.f);
      for (int kk = wg * half; kk < (wg + 1) * half; ++kk) {
        for (int t = 0; t < 128; ++t) {
          float vals[8];
          xw_slice(
              [&](int s, int p) {
                return model.at(buf + kXOff + tile_at(s, p));
              },
              w, t, kk, vals);
          std::uint32_t terms[kTerms][4];
          split_terms(vals, 0, terms);
          for (int u = 0; u < kTerms; ++u)
            for (int r = 0; r < 4; ++r) regs[u][t][r] = terms[u][r];
        }
        for (int u = 0; u < kTerms; ++u) {
          float a[kMmaM][kMmaK];
          a_from_regs(regs[u], a);
          model_wgmma(model, a, b_desc(buf, kk), 1, kCols, lmat.data());
        }
      }
      to_frags(lmat, frags[wg]);
    }

    // 3. the chain
    const size_t slot = (size_t)blk.c * D.BH + blk.bh;
    if (blk.c > 0 && flags[slot - D.BH] != 1) model.ok = false;
    for (int t = 0; t < 128; ++t) {
      float cur[kFrag];
      for (int i = 0; i < kFrag; ++i) {
        prev[t][i] = blk.c > 0 ? states[(slot - D.BH) * kSlotFloats +
                                        frag_row(t, i) * kCols +
                                        frag_col(t, i)]
                               : 0.f;
        cur[i] = chain(expf(a_tot), prev[t][i],
                       __fadd_rn(frags[0][t][i], frags[1][t][i]));
      }
      if (blk.c + 1 < nc) {
        for (int i = 0; i < kFrag; ++i)
          states[slot * kSlotFloats + frag_row(t, i) * kCols +
                 frag_col(t, i)] = cur[i];
      } else {
        store_state(state, D, blk.bh, t, cur);
      }
      std::uint32_t terms[kTerms][kFrag / 2];
      split_terms(prev[t], 0, terms);
      for (int j = 0; j < kFrag / 2; ++j)
        for (int u = 0; u < kTerms; ++u)
          model.store(kSOff + u * kTermBytes +
                          tile_at(frag_row(t, 2 * j), frag_col(t, 2 * j)),
                      &terms[u][j], 4);
    }
    if (blk.c + 1 < nc) flags[slot] = 1;

    // 4. the row tiles
    for (int r = 0; r < nr; ++r) {
      Mat acc(kRows * kCols, 0.f), cs(kRows * kCols, 0.f);
      for (int q = 0; q <= r; ++q) {
        Mat cb(kRows * kCols, 0.f);
        for (int kk = 0; kk < kCols / kMmaK; ++kk)
          model_ss(model, c_desc(buf, r, kk), bt_desc(buf, q, kk), 0, cb);
        to_frags(cb, frags[0]);
        static std::uint32_t sregs[kTerms][128][kFrag / 2];
        for (int t = 0; t < 128; ++t) {
          for (int kk = 0; kk < kRows / kMmaK; ++kk)
            decay_scores(frags[0][t], t, r, q, kk, cum, dts);
          std::uint32_t terms[kTerms][kFrag / 2];
          split_terms(frags[0][t], 0, terms);
          for (int u = 0; u < kTerms; ++u)
            for (int j = 0; j < kFrag / 2; ++j) sregs[u][t][j] = terms[u][j];
        }
        for (int kk = 0; kk < kRows / kMmaK; ++kk)
          for (int u = 0; u < kTerms; ++u) {
            for (int t = 0; t < 128; ++t)
              for (int rr = 0; rr < 4; ++rr)
                regs[u][t][rr] = sregs[u][t][4 * kk + rr];
            float a[kMmaM][kMmaK];
            a_from_regs(regs[u], a);
            model_wgmma(model, a, x_desc(buf, q, kk), 1, kCols,
                        acc.data());
          }
      }
      for (int kk = 0; kk < kCols / kMmaK; ++kk)
        for (int u = 0; u < kTerms; ++u)
          model_ss(model, c_desc(buf, r, kk), s_desc(0, u, kk), 0, cs);
      to_frags(acc, frags[0]);
      to_frags(cs, frags[1]);
      if (D.P == kCols)
        model_store_y_rows(yb, D, blk, r, frags[0], frags[1], cum);
      else
        for (int t = 0; t < 128; ++t)
          store_y(yb, D, blk, r, t, frags[0][t], frags[1][t], cum);
    }
    // the next chunk's dt, cumsum and w into the other slots
    if (it + 1 < tiles) {
      const Block next = block_of(it + 1, D);
      load_dt(b ^ 1, next);
      model_prep(&floats[cum_at(b ^ 1)], &floats[w_at(b ^ 1)],
                 &floats[dts_at(b ^ 1)], A[next.bh], Q, Qp);
    }
  }
  return model.ok ? 0 : -3;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the float32 (CUDA-core)
// kernel uses at chunk Q and dims N, P (kernels/ssd_scan.py::smem_plan
// states the same by part).
int ssd_scan_smem_bytes(int Q, int N, int P) {
  return (int)(plan_of(Q, N, P).total * sizeof(float));
}

// Bytes of dynamic shared memory one block of the bf16 (tensor-core)
// kernel asks for, whatever the dims (kernels/ssd_scan.py::tc_smem_plan
// states the same by part).
int ssd_scan_tc_smem_bytes() { return kTcSmemBytes; }

// Launches the scan on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or -1 for dimensions the kernels do not take (a
// chunk outside [1, 256] or not dividing S, N or P not a multiple of 4 in
// [4, 64], BH not a positive multiple of heads), or -2 where x, Bm or Cm
// is bf16 and not 8-byte aligned (the tensor-core kernel copies 8 bytes
// at a time). x, Bm, Cm, y are device
// pointers of float (bf16 = 0: the CUDA-core kernel) or __nv_bfloat16
// (bf16 = 1: the tensor-core kernel); dt, A, state of float. The
// tensor-core kernel also takes its scratch: `states`, [S / Q, BH, 64, 64]
// float (the carried states), and `flags`, S / Q x BH + 1 int, zero (a
// flag per published state, then the ticket counter); the CUDA-core kernel
// ignores both.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, void* y, float* state,
                    float* states, int* flags, int BH, int S, int P, int N,
                    int Q, int heads, int bf16, void* stream) {
  if (!dims_ok(BH, S, P, N, Q, heads)) return -1;
  if (bf16 && ((reinterpret_cast<std::uintptr_t>(x) |
                reinterpret_cast<std::uintptr_t>(Bm) |
                reinterpret_cast<std::uintptr_t>(Cm)) & 7))
    return -2;
  const Dims D{BH, S, P, N, Q, heads};
  return bf16 ? launch_tc(x, dt, A, Bm, Cm, y, state, states, flags, D,
                          stream)
              : launch_f32(x, dt, A, Bm, Cm, y, state, D, stream);
}

}  // extern "C"
