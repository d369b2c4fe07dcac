// Chunked RWKV6 WKV scan for Hopper (sm_90a): y and the final state of the
// recurrence with per-channel, data-dependent decay
//   y_t = r_t^T (S_t + diag(u) k_t v_t^T),   S_{t+1} = diag(w_t) S_t + k_t v_t^T
// (w_t = exp(logw_t)) of every (batch, head) row, in ONE launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py:69 wkv6_scan
// (body _wkv_kernel :23, pallas_call :74) of the JAX package, and computes
// what it computes, chunk by chunk of Q steps, in the same formulation:
// cum = the inclusive cumsum of logw per channel, cum_prev = cum - logw
// (not a separately summed exclusive cumsum: under strong decay |cum| is in
// the thousands and the two differ by an ulp of the exponent); the
// intra-chunk scores sum_c r[t,c] exp(min(cum_prev[t,c] - cum[s,c], 0))
// k[s,c] for s < t, 0 elsewhere (taken by select: every exponent is clamped
// to <= 0, so nothing overflows, and no 0/1 mask multiplies); y = scores v
// + (sum_c r u k) v + (r * exp(cum_prev)) S_prev, rounded once to r's
// type; then S = diag(exp(cum_tot)) S_prev + (k * exp(cum_tot - cum))^T v,
// carried in float32 to the next chunk and written out, float32, after the
// last. No ratio of exponentials is formed (they overflow).
//
// Layouts (the reference's): r, k, v [BH, S, C] float or bfloat16; logw
// [BH, S, C] float (<= 0); u [BH, C] float; y [BH, S, C] in r's type;
// state [BH, C, C] float, state[c_key][c_value]. Any chunk Q in [1, 64]
// that divides S; C a multiple of 4 in [4, 64]; bf16 r, k, v 8-byte
// aligned and (beside them) logw 16-byte aligned.
//
// The TPU kernel builds the chunk's [Q, Q, C] decay tensor in VMEM, reduces
// it with an einsum and carries the state along a sequential grid axis.
// Which dtype takes which kernel here:
//   bfloat16 -> wkv6_scan_tc_kernel: the chunks of a row in parallel across
//               the card, the products on the tensor cores (wgmma). This
//               is what the model's forward runs.
//   float32  -> wkv6_scan_kernel: float32 FMAs on the CUDA cores, one block
//               per row (a tensor-core float32 product would be TF32, which
//               the port never uses).
//
// What bounds it. At rwkv6-3b's forward of 4 x 4096 tokens (BH 160, Q = C
// = 64) one launch reads r, k, v (bf16) and logw (float32) and writes y
// and the state: 0.51 GB, 0.151 ms at 3.35 TB/s. kernels/wkv6_scan.py::work
// counts 2.04e10 operations (1.36e9 of them exps, one per pair, channel
// and chunk), 0.021 ms at the bf16 tensor-core rate: bytes bound it. On the
// float32 CUDA cores the same operations take 0.305 ms, and one exp per
// pair and channel alone ~0.37 ms on the SFUs (16 a clock per SM).
//
// bfloat16 design (wkv6_scan_tc_kernel). What runs in series is only the
// carried [C, C] state; the rest of a chunk depends on its own inputs. One
// block of 128 threads (one warpgroup) per (row, chunk) tile, two blocks
// per SM (shared memory, wkv6_scan_tc_smem_bytes =
// kernels/wkv6_scan.py::tc_smem_plan); a block takes its tile from an
// atomic ticket counter as it starts, the rows of a chunk fastest, so that
// the tile it waits on (BH tickets earlier) is held by a block that has
// started. Per tile:
//   - r, k, v by cp.async (16 bytes a copy where C is a multiple of 8,
//     else 8) into tiles of 64 rows of 128 bytes in the 128-byte swizzle,
//     zero past Q and C, and logw (16 bytes a copy) into the rows of
//     cum_prev; then 64 threads, a channel each, sum its cumsum in order
//     in float32 (the plain version's cumsum_rounded rounds the running
//     sum alike, so the two agree bitwise), with cum_prev = cum - logw in
//     place;
//   - the decays taken per sub-chunk of 16 steps: for s in an earlier
//     sub-chunk than t, with e the step before t's sub-chunk,
//     exp(cum_prev_t - cum_s) = exp(cum_prev_t - cum_e) exp(cum_e - cum_s),
//     both exponents <= 0 (clamped: cum_prev_t may round an ulp above
//     cum_{t-1}), so such pairs become r~_t S_e with r~_t = r_t
//     exp(min(cum_prev_t - cum_e, 0)) and S_e = sum_{s <= e} (k_s
//     exp(cum_e - cum_s)) v_s^T, the chunk's own state at e. Only the 120
//     pairs inside each sub-chunk keep one exp per channel (the plain
//     version's terms), summed on the CUDA cores with the u bonus
//     (sum_c r u k, on the diagonal): each quad of threads takes the rows
//     m and 15 - m of a sub-chunk (15 pairs and two bonuses), a lane a
//     quarter of the channels, added by shuffles. 31 K exps of a chunk's
//     ~42 K, where one exp per pair took 133 K;
//   - on the tensor cores (wgmma m64n64k16, A from registers, B from
//     shared memory): each sub-chunk's own part U_g = sum_{s in g} (k_s
//     exp(cum_e - cum_s)) v_s^T (e its last step), A as three bf16 terms,
//     B = v, and the chunk's state chained from one sub-chunk end to the
//     next as the state is across chunks, S_e = exp(cum_e - cum_e') S_e'
//     + U_g, one rounding each; the states at the ends of the first three
//     sub-chunks to shared memory as two bf16 terms, the last one (L) kept;
//     then y's sums within the chunk: the scores (and u bonus) as two
//     terms times v, and r~ S_e as one product over a depth of 3 x 64
//     (warp g's rows hold r~ of sub-chunk g in block g's columns, the
//     others zero; each warp's own r~ computed first, all warps at once),
//     the terms p, q of the two float32 operands taken where p + q < 2;
//   - the chain: thread 0 waits for the flag of S_{c-1} (ld.acquire; a
//     poll that never ends traps), S_c = exp(cum_tot) S_{c-1} + L, one
//     rounding each as the plain version, to a ring of two slots per row
//     (its flag, st.release, carries c + 1: the reader of slot c % 2 has
//     read it before it published S_{c+1}, the only state that may be
//     written there next but one), or, for the last chunk, to state_out;
//     while those stores drain, y += (r exp(cum_prev)) S_{c-1}, S_{c-1}
//     as two terms; then the fence and the flag; y rounded once to bf16.
// Precision plan (tests/test_torch_wkv.py::_tensor_core_plan pins it on
// the CPU; chip_smoke.py holds it on the card): r, k, v are exact as one
// bf16 term; the chunk's states, which feed the carried state and so
// every later y, take three terms of k exp(cum_e - cum) (exact products:
// only the order of sums, and the chain at each sub-chunk end, differ
// from the plain version's); the products that feed only y take two terms
// of each float32 operand (~2^-16 of each product, far below y's bf16
// rounding). Two terms for the states put the float32 state 2e-6 off,
// held at WKV_BF16_STATE_RTOL = 1e-6.
// The products read an accumulator only after wgmma.wait_group 0, and
// what the control flow around them depends on is warp-uniform to the
// compiler (read through a shuffle). Nothing is summed by atomics and each
// sum has one order, so two launches agree bitwise. The wrapper allocates
// the scratch: the ring [BH, 2, 64 x 64] float32 (5.2 MB at the forward
// shape, held in L2) and its flags and the ticket counter (zeroed).
//
// float32 design (wkv6_scan_kernel). One block of 256 threads per bh, the
// chunks a loop inside it (the TPU's sequential grid axis), the [C, C]
// float32 state resident in shared memory. The [Q, Q, C] decay tensor is
// never built (1 MiB in float32 at Q = C = 64): the sum over c runs inside
// the loop that makes each score, 4 x 4 scores per thread. A chunk's r, k,
// logw are staged transposed ([C][Q], so that 4 consecutive steps are one
// float4), v as it lies, all float32. The cumsum is one thread per
// channel, in order, each step's sum taken in float64 and the running sum
// rounded to float32 (the plain version sums alike, so the two agree
// bitwise). Rounding the running sum keeps cum - logw equal to the
// previous prefix in most steps, so the decays between near steps, which
// weigh most, come out nearly exact; against the exact recurrence this is
// closer than prefixes summed in float64 and rounded once (PERF.md). Then r
// and k are turned in place into r * exp(cum_prev) and
// k * exp(cum_tot - cum), y is written (the sum over s in ascending order,
// one FMA chain per output), and only after every row of the chunk is done
// does the state update read S_prev. Shared memory per block (csrc plan_of
// = kernels/wkv6_scan.py::smem_plan): 123,392 B at Q = C = 64. Every
// phase is a loop strided by blockDim.x whose iterations write disjoint
// elements, separated by __syncthreads(), so one thread per block
// computes the same (the CPU emulation in the tests runs it so).
//
// Without nvcc (the CPU emulation in the tests), the bfloat16 launcher runs
// a host model of the tensor-core kernel instead: the tickets taken in
// turn by one block, the 8- or 16-byte copies into the swizzled tiles, the
// lanes' cumsums, the CUDA-core items, each A fragment and its terms, each
// wgmma read through its descriptors (tma_wgmma.cuh), the sub-chunk states'
// terms in their tiles, the ring's slots and flags and y's stores. It
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
constexpr int kMaxChunk = 64;
constexpr int kMaxC = 64;
constexpr int kPad = 8;          // row padding of the transposed tiles

struct Dims {
  int BH, S, C, Q;
};

// Offsets (floats) of the parts of dynamic shared memory, in order. Every
// size is a multiple of 4 floats, so every part is 16-byte aligned.
struct Plan {
  int Qp, ld;                  // Q rounded up to 4; row stride of [C][Qp]
  int state, rt, kt, cum, cp, v, sc, diag, u, total;
};

__host__ __device__ inline Plan plan_of(int Q, int C) {
  Plan pl;
  pl.Qp = (Q + 3) / 4 * 4;
  pl.ld = pl.Qp + kPad;
  int o = 0;
  pl.state = o; o += C * C;            // [C][C] the carried state
  pl.rt = o;    o += C * pl.ld;        // [C][ld] r^T, then r * exp(cum_prev)
  pl.kt = o;    o += C * pl.ld;        // [C][ld] k^T, then k * exp(tot - cum)
  pl.cum = o;   o += C * pl.ld;        // [C][ld] inclusive cumsum of logw
  pl.cp = o;    o += C * pl.ld;        // [C][ld] logw, then cum - logw
  pl.v = o;     o += pl.Qp * C;        // [Qp][C] v of the chunk
  pl.sc = o;    o += pl.Qp * pl.Qp;    // [s][t] scores, s < t
  pl.diag = o;  o += pl.Qp;            // sum_c r u k per step
  pl.u = o;     o += C;                // u of the row
  pl.total = o;
  return pl;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, T* __restrict__ y,
                 float* __restrict__ state_out, Dims D) {
  extern __shared__ float smem[];
  const int C = D.C, Q = D.Q;
  const Plan pl = plan_of(Q, C);
  const int Qp = pl.Qp, ld = pl.ld;
  float* S = smem + pl.state;
  float* rt = smem + pl.rt;
  float* kt = smem + pl.kt;
  float* cum = smem + pl.cum;
  float* cp = smem + pl.cp;
  float* vs = smem + pl.v;
  float* sc = smem + pl.sc;
  float* diag = smem + pl.diag;
  float* us = smem + pl.u;

  const int bh = blockIdx.x;
  const size_t row = (size_t)bh * D.S * C;
  const T* rh = r + row;
  const T* kh = k + row;
  const T* vh = v + row;
  const float* wh = logw + row;
  T* yh = y + row;
  const int nc4 = C / 4, nq4 = Qp / 4, q8 = (Qp + 7) / 8 * 8;

  for (int e = threadIdx.x; e < C * C; e += blockDim.x) S[e] = 0.f;
  for (int e = threadIdx.x; e < C; e += blockDim.x) us[e] = u[bh * C + e];

  for (int base = 0; base < D.S; base += Q) {
    __syncthreads();  // the previous chunk's state update is done
    // stage r, k, logw transposed and v as it lies, float32, zero past Q; a
    // warp's 32 lanes take 8 steps x 4 channels, so the transposing stores
    // fall on 32 banks where ld = 8 mod 32 (the items run over Qp rounded
    // up to 8 steps, those past Qp skipped, so that every (s, c) is met)
    for (int e = threadIdx.x; e < q8 * C; e += blockDim.x) {
      const int lane = e & 31, rest = e >> 5;
      const int c = (rest % nc4) * 4 + (lane & 3);
      const int s = (rest / nc4) * 8 + (lane >> 2);
      if (s >= Qp) continue;
      const bool in = s < Q;
      const size_t g = (size_t)(base + s) * C + c;
      rt[c * ld + s] = in ? to_f32(rh[g]) : 0.f;
      kt[c * ld + s] = in ? to_f32(kh[g]) : 0.f;
      cp[c * ld + s] = in ? wh[g] : 0.f;
    }
    for (int e = threadIdx.x; e < Qp * C; e += blockDim.x) {
      const int s = e / C;
      vs[e] = s < Q ? to_f32(vh[(size_t)(base + s) * C + e % C]) : 0.f;
    }
    __syncthreads();
    // per channel: the inclusive cumsum of logw in order, each step's sum
    // taken in float64 and the running sum rounded to float32; cum_prev =
    // cum - logw in float32; zero past Q
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float run = 0.f;
      float* cumc = cum + c * ld;
      float* cpc = cp + c * ld;
      for (int s = 0; s < Q; ++s) {
        const float lw = cpc[s];
        run = (float)((double)run + (double)lw);
        cumc[s] = run;
        cpc[s] = __fsub_rn(run, lw);
      }
      for (int s = Q; s < Qp; ++s) cumc[s] = cpc[s] = 0.f;
    }
    // the u bonus of each step: sum_c (r u) k, c ascending
    for (int t = threadIdx.x; t < Qp; t += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rt[c * ld + t], us[c]),
                                       kt[c * ld + t]));
      diag[t] = acc;
    }
    __syncthreads();
    // scores of 4 steps t x 4 steps s per item, on and below the diagonal
    // block (the y loop reads no other), the sum over c inside: r[t,c]
    // exp(min(cum_prev[t,c] - cum[s,c], 0)) k[s,c]; kept where s < t, else
    // 0 (select); stored transposed ([s][t])
    for (int e = threadIdx.x; e < nq4 * nq4; e += blockDim.x) {
      const int i0 = (e % nq4) * 4, j0 = (e / nq4) * 4;
      if (j0 > i0) continue;
      float acc[4][4] = {};
      for (int c = 0; c < C; ++c) {
        const float4 ra = ld4(rt + c * ld + i0);
        const float4 pa = ld4(cp + c * ld + i0);
        const float4 ca = ld4(cum + c * ld + j0);
        const float4 ka = ld4(kt + c * ld + j0);
        const float rv[4] = {ra.x, ra.y, ra.z, ra.w};
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
        const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dec = expf(min(__fsub_rn(pv[i], cv[j]), 0.f));
            acc[i][j] = fmaf(__fmul_rn(rv[i], dec), kv[j], acc[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = j0 + j;
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = s < i0 + i ? acc[i][j] : 0.f;
        *reinterpret_cast<float4*>(sc + s * Qp + i0) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();
    // r -> r * exp(cum_prev) and k -> k * exp(cum_tot - cum), in place
    for (int e = threadIdx.x; e < C * Qp; e += blockDim.x) {
      const int c = e / Qp, s = e % Qp;
      const float tot = cum[c * ld + Q - 1];
      rt[c * ld + s] = __fmul_rn(rt[c * ld + s], expf(cp[c * ld + s]));
      kt[c * ld + s] = __fmul_rn(kt[c * ld + s],
                                 expf(__fsub_rn(tot, cum[c * ld + s])));
    }
    __syncthreads();
    // y = scores v + diag v + (r exp(cum_prev)) S_prev: 4 steps x 4 value
    // channels per item, s and c ascending; rounded once to r's type
    for (int e = threadIdx.x; e < nq4 * nc4; e += blockDim.x) {
      const int i0 = (e % nq4) * 4, p0 = (e / nq4) * 4;
      float acc[4][4] = {};
      for (int s = 0; s < i0 + 4; ++s) {
        const float4 a = ld4(sc + s * Qp + i0);
        const float4 b = ld4(vs + s * C + p0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
      }
      float inter[4][4] = {};
      for (int c = 0; c < C; ++c) {
        const float4 a = ld4(rt + c * ld + i0);
        const float4 b = ld4(S + c * C + p0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            inter[i][q] = fmaf(av[i], bv[q], inter[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = i0 + i;
        if (t >= Q) continue;
        T* out = yh + (size_t)(base + t) * C + p0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float intra = __fadd_rn(
              acc[i][q], __fmul_rn(diag[t], vs[t * C + p0 + q]));
          out[q] = from_f32<T>(__fadd_rn(intra, inter[i][q]));
        }
      }
    }
    __syncthreads();
    // S = exp(cum_tot) S_prev + kd^T v: 4 key x 4 value channels per item,
    // s ascending
    for (int e = threadIdx.x; e < nc4 * nc4; e += blockDim.x) {
      const int p0 = (e % nc4) * 4, c0 = (e / nc4) * 4;
      float acc[4][4] = {};
      for (int s = 0; s < Q; ++s) {
        const float4 b = ld4(vs + s * C + p0);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = kt[(c0 + i) * ld + s];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a, bv[q], acc[i][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float keep = expf(cum[(c0 + i) * ld + Q - 1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* st = S + (c0 + i) * C + p0 + q;
          *st = __fadd_rn(__fmul_rn(keep, *st), acc[i][q]);
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + (size_t)bh * C * C;
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) so[e] = S[e];
}

bool dims_ok(int BH, int S, int C, int Q) {
  return BH > 0 && S > 0 && Q >= 1 && Q <= kMaxChunk && S % Q == 0 &&
         C >= 4 && C <= kMaxC && C % 4 == 0;
}

int launch_f32(const void* r, const void* k, const void* v,
               const float* logw, const float* u, void* y, float* state,
               const Dims& D, void* stream) {
  const int n = D.BH;
  const int smem = (int)(plan_of(D.Q, D.C).total * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_scan_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_scan_kernel<float><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), logw, u, static_cast<float*>(y), state,
      D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. What follows up to the CUDA-only part is shared by
// the kernel and the host model.

constexpr int kTcThreads = 128;             // one warpgroup
constexpr int kRows = kMmaM;                // a chunk's steps, zero past Q
constexpr int kCols = 64;                   // channels, zero past C
constexpr int kSub = kMmaK;                 // steps of a sub-chunk: a slice
constexpr int kSubs = kRows / kSub;         // sub-chunks of a full chunk
constexpr int kTermsS = 3;  // bf16 terms of k exp(cum_b - cum): the states
constexpr int kTermsY = 2;  // of each float32 operand that feeds only y
constexpr int kFrag = kRows * kCols / 128;  // m64n64 accumulators a thread
constexpr int kTileBytes = kRows * kRowBytes;  // r, k, v or a term: 8 KiB
constexpr int kLd = kCols + 4;    // row stride (floats) of cum and cum_prev
constexpr int kLdSc = kSub + 4;   // row stride (floats) of the scores
constexpr int kRowPairs = kSub / 2;  // rows m and 15 - m of a sub-chunk
constexpr int kQuarter = kCols / 4;  // channels a lane of a quad sums
// shared memory (bytes from the 1,024-aligned start): the r, k, v tiles;
// the terms of S_e at the ends of sub-chunks 0-2 (slot 0 then takes those
// of S_{c-1}); cum and cum_prev [64][kLd]; the scores [64][kLdSc]; the
// ticket
constexpr int kROff = 0;
constexpr int kKOff = kTileBytes;
constexpr int kVOff = 2 * kTileBytes;
constexpr int kSOff = 3 * kTileBytes;
constexpr int kCumOff = kSOff + (kSubs - 1) * kTermsY * kTileBytes;
constexpr int kCpOff = kCumOff + kRows * kLd * 4;
constexpr int kScOff = kCpOff + kRows * kLd * 4;
constexpr int kTicketOff = kScOff + kRows * kLdSc * 4;
constexpr int kTcSmemBytes = kSwizzleAtom + kTicketOff + 16;
constexpr int kRing = 2;                    // carried states a row holds
constexpr int kSlotFloats = kCols * kCols;  // a carried state, [i][j]
static_assert(kCols == kRowBytes / 2, "a tile row is one swizzle row");
static_assert(2 * (kTcSmemBytes + 1024) <= 233472, "two blocks per SM");

__host__ __device__ inline float min0(float x) { return x < 0.f ? x : 0.f; }

// Where element (row, col) of a tile lies before the swizzle: rows of
// 128 bytes, 8-row atoms of 1,024 bytes from a 1,024-aligned start.
__host__ __device__ constexpr std::uint32_t tile_at(int row, int col) {
  return row * kRowBytes + col * 2;
}

// The tile of term q of state slot `slot` (0-2).
__host__ __device__ constexpr int term_tile(int slot, int q) {
  return kSOff + (slot * kTermsY + q) * kTileBytes;
}

// The tile's chunk and row from its ticket, the rows of a chunk fastest:
// the block of (row, chunk c) waits only on the ticket BH before its own.
struct Block {
  int c, bh, base;
};
__host__ __device__ inline Block block_of(int ticket, const Dims& D) {
  const int c = ticket / D.BH;
  return {c, ticket % D.BH, c * D.Q};
}

// The B descriptors, MN-major (j contiguous), rows of 128 bytes, 8-row
// groups 1,024 bytes apart: v, slice kk of the steps s; a state's term q,
// slice ii of the key channels i. `sb` is the start of shared memory.
__host__ __device__ inline std::uint64_t v_desc(std::uint32_t sb, int kk) {
  return sw128_desc(sb + kVOff + tile_at(kk * kSub, 0), kTileBytes,
                    8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t term_desc(std::uint32_t sb,
                                                   int slot, int q, int ii) {
  return sw128_desc(sb + term_tile(slot, q) + tile_at(ii * kSub, 0),
                    kTileBytes, 8 * kRowBytes);
}

// The copies of chunk `blk`'s r, k and v into their tiles, `Bytes` (8 or
// 16) each, items first, first + stride, ...: copy(offset in shared
// memory, source, live), zero where not live (past Q or C; the source is
// then the row's start, not read).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int Bytes, class Copy>
__host__ __device__ inline void chunk_copies(const Copy& copy,
                                             const Block& blk, const Dims& D,
                                             const __nv_bfloat16* r,
                                             const __nv_bfloat16* k,
                                             const __nv_bfloat16* v,
                                             int first, int stride) {
  constexpr int kPerRow = kRowBytes / Bytes, kEach = Bytes / 2;
  const size_t row0 = (size_t)blk.bh * D.S + blk.base;
  for (int e = first; e < 3 * kRows * kPerRow; e += stride) {
    const int m = e / (kRows * kPerRow), rest = e % (kRows * kPerRow);
    const int s = rest / kPerRow, col = rest % kPerRow * kEach;
    const __nv_bfloat16* src = m == 0 ? r : m == 1 ? k : v;
    const bool live = s < D.Q && col < D.C;
    copy(m * kTileBytes + tile_at(s, col),
         src + (live ? (row0 + s) * D.C + col : row0 * D.C), live);
  }
}

// The copies of chunk `blk`'s logw into the rows of cum_prev (floats at
// s kLd + c), 16 bytes each, items first, first + stride, ...: copy(float
// index, source).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void logw_copies(const Copy& copy,
                                            const Block& blk, const Dims& D,
                                            const float* logw, int first,
                                            int stride) {
  const int per_row = D.C / 4;
  const float* src = logw + ((size_t)blk.bh * D.S + blk.base) * D.C;
  for (int e = first; e < D.Q * per_row; e += stride) {
    const int s = e / per_row, col = e % per_row * 4;
    copy(s * kLd + col, src + (size_t)s * D.C + col);
  }
}

// Channel i's cumsum of logw over the chunk (logw staged in cp's rows), in
// order in float32, as the plain version's cumsum_rounded (its float64 sum
// of two floats rounds to the float32 sum), and cum_prev = cum - logw in
// place; past Q both hold the last prefix, past C both are 0.
__host__ __device__ inline void cumsum_channel(int i, const Dims& D,
                                               float* cum, float* cp) {
  float run = 0.f;
#pragma unroll 8
  for (int s = 0; s < D.Q; ++s) {
    const float w = i < D.C ? cp[s * kLd + i] : 0.f;
    run = add_rn(run, w);
    cum[s * kLd + i] = run;
    cp[s * kLd + i] = sub_rn(run, w);
  }
  for (int s = D.Q; s < kRows; ++s) cum[s * kLd + i] = cp[s * kLd + i] = run;
}

// 4 floats from p (16-byte aligned)
__host__ __device__ inline void ld4f(const float* p, float (&o)[4]) {
#ifdef __CUDACC__
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
#else
  for (int j = 0; j < 4; ++j) o[j] = p[j];
#endif
}

// Thread t's part of the CUDA cores' sums, over its quarter of the
// channels, c in [16 q, 16 q + 16) of C ascending (q = t % 4; the quad's
// four parts are summed as (p0 + p1) + (p2 + p3)): the rows ta = m and tb
// = 15 - m of sub-chunk g (m = t / 4 % 8, g = t / 32) hold 15 pairs s < t
// in all, listed j < 15 (j < m: row ta, s = j; else row tb, s = j - m),
// each sum_c r[t,c] exp(min(cum_prev[t,c] - cum[s,c], 0)) k[s,c] (the
// plain version's terms), into part[j]; the u bonus of ta and tb, sum_c
// (r u) k, into part[15] and part[16]. at4(tile, row, col, out) reads 4
// bf16 of a tile. Rows past Q hold zero r, so their sums are 0.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class At4>
__host__ __device__ inline void score_part(int t, const At4& at4,
                                           const float* u, const float* cum,
                                           const float* cp, const Dims& D,
                                           float (&part)[kSub + 1]) {
  const int q = t % 4, m = t / 4 % kRowPairs, g0 = t / 32 * kSub;
  const int ta = g0 + m, tb = g0 + kSub - 1 - m;
#pragma unroll
  for (int j = 0; j <= kSub; ++j) part[j] = 0.f;
  const int end = min(q * kQuarter + kQuarter, D.C);
  for (int c = q * kQuarter; c < end; c += 4) {
    float ra[4], rb[4], ka[4], kb[4], pa[4], pb[4], uc[4];
    at4(kROff, ta, c, ra);
    at4(kROff, tb, c, rb);
    at4(kKOff, ta, c, ka);
    at4(kKOff, tb, c, kb);
    ld4f(cp + ta * kLd + c, pa);
    ld4f(cp + tb * kLd + c, pb);
    ld4f(u + c, uc);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      part[kSub - 1] =
          add_rn(part[kSub - 1], mul_rn(mul_rn(ra[x], uc[x]), ka[x]));
      part[kSub] = add_rn(part[kSub], mul_rn(mul_rn(rb[x], uc[x]), kb[x]));
    }
#pragma unroll
    for (int j = 0; j < kSub - 1; ++j) {
      const bool first = j < m;
      const int s = g0 + (first ? j : j - m);
      float ks[4], cs[4];
      at4(kKOff, s, c, ks);
      ld4f(cum + s * kLd + c, cs);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        part[j] = fmaf(mul_rn(first ? ra[x] : rb[x],
                              expf(min0(sub_rn(first ? pa[x] : pb[x],
                                               cs[x])))),
                       ks[x], part[j]);
    }
  }
}

// The quad's sums (every lane holds them) to the scores sc[t][s % 16] of
// rows ta and tb, lane q storing those j = q mod 4.
__host__ __device__ inline void store_scores(int t, const float (&sum)[kSub + 1],
                                             float* sc) {
  const int q = t % 4, m = t / 4 % kRowPairs, g0 = t / 32 * kSub;
  const int ta = g0 + m, tb = g0 + kSub - 1 - m;
#pragma unroll
  for (int j = 0; j <= kSub; ++j) {
    if (j % 4 != q) continue;
    const int row = j < kSub - 1 ? (j < m ? ta : tb) : j == kSub - 1 ? ta : tb;
    const int col = j < kSub - 1 ? (j < m ? j : j - m) : row - g0;
    sc[row * kLdSc + col] = sum[j];
  }
}

// Thread t's A fragments (8 values of a 16-deep slice: row a_row(t, r),
// column a_col(t, r, h), as vals[2 r + h]).
//
// The last step of sub-chunk g of a chunk of Q steps.
__host__ __device__ inline int sub_end(int g, int Q) {
  return (g * kSub + kSub < Q ? g * kSub + kSub : Q) - 1;
}

// Sub-chunk g's own part of the chunk's state at its last step e, U_g =
// sum_{s in g} (k_s exp(cum_e - cum_s)) v_s^T (M = key channel i, K =
// step s): its one slice, kk = g.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class At>
__host__ __device__ inline void kd_slice(const At& at, const float* cum,
                                         int g, int Q, int t,
                                         float (&vals)[8]) {
  const int e = sub_end(g, Q);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = a_row(t, r), s = g * kSub + a_col(t, r, h);
      vals[2 * r + h] =
          s <= e ? mul_rn(at(kKOff, s, i),
                          expf(sub_rn(cum[e * kLd + i], cum[s * kLd + i])))
                 : 0.f;
    }
}

// y through the chunk's state at the end of sub-chunk g - 1 (e = 16 g -
// 1; M = step t, K = key channel i): r[t,i] exp(min(cum_prev[t,i] -
// cum[e,i], 0)), slice ii of i, on the rows of sub-chunk g (warp g's),
// else 0.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class At>
__host__ __device__ inline void rt_slice(const At& at, const float* cum,
                                         const float* cp, int g, int ii,
                                         int t, float (&vals)[8]) {
  const int e = g * kSub - 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) vals[2 * r + h] = 0.f;
  if (t / 32 != g) return;  // the rows a_row(t, .) of warp t / 32
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = a_row(t, r), i = ii * kSub + a_col(t, r, h);
      vals[2 * r + h] = mul_rn(
          at(kROff, tt, i),
          expf(min0(sub_rn(cp[tt * kLd + i], cum[e * kLd + i]))));
    }
}

// y through the carried state (M = step t, K = key channel i): r[t,i]
// exp(cum_prev[t,i]), slice ii of i.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class At>
__host__ __device__ inline void re_slice(const At& at, const float* cp,
                                         int ii, int t, float (&vals)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = a_row(t, r), i = ii * kSub + a_col(t, r, h);
      vals[2 * r + h] = mul_rn(at(kROff, tt, i), expf(cp[tt * kLd + i]));
    }
}

// y's scores within the sub-chunks and the u bonus (M = step t, K = step
// s): sc[t][s % 16] where s and t lie in one sub-chunk, s <= t < Q, else
// 0; slice kk of s (non-zero on warp kk's rows only).
__host__ __device__ inline void sc_slice(const float* sc, int kk, int t,
                                         const Dims& D, float (&vals)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = a_row(t, r), s = kk * kSub + a_col(t, r, h);
      vals[2 * r + h] = t / 32 == kk && s <= tt && tt < D.Q
                            ? sc[tt * kLdSc + s % kSub]
                            : 0.f;
    }
}

// Thread t's [i][j] fragment of a state as kTermsY bf16 terms into the
// tiles of slot `slot`, rows i of 64 channels j (the MN-major B of the
// products that read them): write(offset, pair of bf16).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Write>
__host__ __device__ inline void store_terms(const Write& write, int slot,
                                            int t, const float (&st)[kFrag]) {
  std::uint32_t terms[kTermsY][kFrag / 2];
  split_terms(st, 0, terms);
#pragma unroll
  for (int j = 0; j < kFrag / 2; ++j)
#pragma unroll
    for (int q = 0; q < kTermsY; ++q)
      write(term_tile(slot, q) + tile_at(frag_row(t, 2 * j),
                                         frag_col(t, 2 * j)),
            terms[q][j]);
}

// The carried state: S_c = exp(cum_tot) S_{c-1} + L_c, one rounding each
// (the plain version's order).
__host__ __device__ inline float chain(float keep, float prev, float l) {
  return add_rn(mul_rn(keep, prev), l);
}

// The chunk's state at the end of sub-chunk g, thread t's [i][j]
// fragment, from that at the end of sub-chunk g - 1 in st and U_g in u:
// exp(cum_e - cum_e') S + U_g, as the chain across chunks (for g = 0, U_0).
__host__ __device__ inline void sub_chain(const float* cum, int g, int Q,
                                          int t, float (&st)[kFrag],
                                          const float (&u)[kFrag]) {
  const int e = sub_end(g, Q), e0 = g * kSub - 1;
  float f[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = frag_row(t, 2 * hh);
    f[hh] = g ? expf(sub_rn(cum[e * kLd + i], cum[e0 * kLd + i])) : 0.f;
  }
#pragma unroll
  for (int x = 0; x < kFrag; ++x)
    st[x] = g ? chain(f[(x / 2) % 2], st[x], u[x]) : u[x];
}

// Thread t's part of the final state to state_out [BH, C, C] (from the
// [i][j] fragment; past C masked).
__host__ __device__ inline void store_state(float* state_out, const Dims& D,
                                            int bh, int t,
                                            const float (&st)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int ki = frag_row(t, i), vj = frag_col(t, i);
    if (ki < D.C && vj < D.C)
      state_out[((size_t)bh * D.C + ki) * D.C + vj] = st[i];
  }
}

// y of the chunk from thread t's fragment (M = step, N = channel), rounded
// once to bf16 (steps past Q and channels past C masked).
__host__ __device__ inline void store_y(__nv_bfloat16* y, const Dims& D,
                                        const Block& blk, int t,
                                        const float (&acc)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; i += 2) {
    const int tt = frag_row(t, i), j = frag_col(t, i);
    if (tt < D.Q && j < D.C)
      store_pair(y + ((size_t)blk.bh * D.S + blk.base + tt) * D.C + j,
                 acc[i], acc[i + 1]);
  }
}

// Whether r, k, v come 16 bytes a copy (rows a multiple of 16 bytes and
// 16-byte aligned starts), else 8.
inline bool wide_ok(const Dims& D, const void* r, const void* k,
                    const void* v) {
  return D.C % 8 == 0 && ((reinterpret_cast<std::uintptr_t>(r) |
                           reinterpret_cast<std::uintptr_t>(k) |
                           reinterpret_cast<std::uintptr_t>(v)) & 15) == 0;
}

#ifdef __CUDACC__

// acc += A B over the slices kk in [0, n): A from vals_of(kk, vals) as T
// bf16 terms in registers, B through desc_of(kk, q). SplitB: B is a
// float32 operand held as T terms too, and the products of terms p, q
// with p + q < T are taken; else B is exact (q = 0). Two slices in flight
// (a slice's terms are written once the products that read them two
// slices before are done); returns once all are done.
template <int T, bool SplitB, class Vals, class Desc>
__device__ __forceinline__ void rs_products(float (&acc)[kFrag], int n,
                                            const Vals& vals_of,
                                            const Desc& desc_of) {
  std::uint32_t terms[2][T][4];
  fence_regs(acc);
  for (int k0 = 0; k0 < n; k0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k0 + h < n) {
        float vals[8];
        vals_of(k0 + h, vals);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_terms(terms[h]);
        split_terms(vals, 0, terms[h]);
        fence_terms(terms[h]);
        wg_fence();
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int q = 0; q < (SplitB ? T - p : 1); ++q)
            wgmma_m64n64k16_rs<1>(acc, terms[h][p][0], terms[h][p][1],
                                  terms[h][p][2], terms[h][p][3],
                                  desc_of(k0 + h, q));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(acc);
  fence_terms(terms[0]);
  fence_terms(terms[1]);
}

// One block per (row, chunk) tile, two blocks per SM; the tile from the
// ticket counter as the block starts.
__global__ void __launch_bounds__(kTcThreads, 2)
wkv6_scan_tc_kernel(const __nv_bfloat16* __restrict__ r,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ logw,
                    const float* __restrict__ u,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state_out, float* __restrict__ states,
                    int* __restrict__ flags, Dims D, int wide) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const std::uint32_t sb = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                           ~(std::uint32_t)(kSwizzleAtom - 1);
  unsigned char* sm = tc_smem + (sb - smem_u32(tc_smem));
  float* cum = reinterpret_cast<float*>(sm + kCumOff);
  float* cp = reinterpret_cast<float*>(sm + kCpOff);
  float* sc = reinterpret_cast<float*>(sm + kScOff);
  int* ticket = reinterpret_cast<int*>(sm + kTicketOff);
  // what the control flow around the products depends on is read through
  // a shuffle from lane 0, so that the compiler knows it is the same in a
  // warp: in a branch it cannot prove so, ptxas serializes every wgmma
  // (warning C7520)
  const int t = threadIdx.x;
  const int Q = D.Q, nc = D.S / Q, ng = cdiv(Q, kSub);
  if (t == 0) *ticket = atomicAdd(flags + D.BH * kRing, 1);
  __syncthreads();
  const Block blk = block_of(__shfl_sync(0xffffffffu, *ticket, 0), D);
  const auto at = [&](int tile, int row, int col) {
    return smem_bf16(sm, tile + tile_at(row, col));
  };
  const auto at4 = [&](int tile, int row, int col, float (&out)[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        sm + swizzle128(tile + tile_at(row, col)));
    out[0] = half_of(w.x, 0);
    out[1] = half_of(w.x, 1);
    out[2] = half_of(w.y, 0);
    out[3] = half_of(w.y, 1);
  };
  const auto write = [&](std::uint32_t off, std::uint32_t val) {
    *reinterpret_cast<std::uint32_t*>(sm + swizzle128(off)) = val;
  };
  const auto vdesc = [&](int kk, int) { return v_desc(sb, kk); };

  // 1. r, k, v into their tiles; meanwhile logw to cum and cum_prev, a
  //    channel a thread
  if (wide)
    chunk_copies<16>([&](std::uint32_t off, const void* src, bool live) {
      cp_async<16>(sb + swizzle128(off), src, live);
    }, blk, D, r, k, v, t, kTcThreads);
  else
    chunk_copies<8>([&](std::uint32_t off, const void* src, bool live) {
      cp_async<8>(sb + swizzle128(off), src, live);
    }, blk, D, r, k, v, t, kTcThreads);
  logw_copies([&](int at, const float* src) {
    cp_async<16>(sb + kCpOff + 4 * at, src, true);
  }, blk, D, logw, t, kTcThreads);
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (t < kCols) cumsum_channel(t, D, cum, cp);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // 2. the pairs within each sub-chunk and the u bonus, on the CUDA cores
  {
    float sum[kSub + 1];
    score_part(t, at4, u + (size_t)blk.bh * D.C, cum, cp, D, sum);
#pragma unroll
    for (int j = 0; j <= kSub; ++j) {
      sum[j] = add_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], 1));
      sum[j] = add_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], 2));
    }
    store_scores(t, sum, sc);
  }

  // 3. the chunk's states at the ends of its sub-chunks, each sub-chunk's
  //    own part U_g by wgmma and the chain from one end to the next; those
  //    but the last to two terms each in shared memory, the last (L) kept
  float acc[kFrag];
  for (int g = 0; g < ng; ++g) {
    float part[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) part[i] = 0.f;
    rs_products<kTermsS, false>(
        part, 1,
        [&](int, float (&vals)[8]) { kd_slice(at, cum, g, Q, t, vals); },
        [&](int, int) { return v_desc(sb, g); });
    sub_chain(cum, g, Q, t, acc, part);
    if (g + 1 < ng) store_terms(write, g, t, acc);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // 4. y within the chunk: the scores and the u bonus times v; r~ S_e
  float yacc[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) yacc[i] = 0.f;
  rs_products<kTermsY, false>(
      yacc, ng,
      [&](int kk, float (&vals)[8]) { sc_slice(sc, kk, t, D, vals); }, vdesc);
  // r~ S_e: each warp's own A (its rows are sub-chunk w's, against the
  // state at the end of sub-chunk w - 1) for its four slices first, all
  // warps at once, so that no product waits on one warp's exps; for the
  // other states a warp's A is zero
  {
    const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
    std::uint32_t own[kSubs][kTermsY][4];
#pragma unroll
    for (int ii = 0; ii < kSubs; ++ii) {
      float vals[8];
      if (warp >= 1 && warp < ng) {
        rt_slice(at, cum, cp, warp, ii, t, vals);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) vals[x] = 0.f;
      }
      split_terms(vals, 0, own[ii]);
    }
    fence_regs(yacc);
    for (int g = 1; g < ng; ++g) {
      std::uint32_t a[kSubs][kTermsY][4];
#pragma unroll
      for (int ii = 0; ii < kSubs; ++ii) {
#pragma unroll
        for (int p = 0; p < kTermsY; ++p)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[ii][p][x] = warp == g ? own[ii][p][x] : 0u;
        fence_terms(a[ii]);
      }
      wg_fence();
#pragma unroll
      for (int ii = 0; ii < kSubs; ++ii)
#pragma unroll
        for (int p = 0; p < kTermsY; ++p)
#pragma unroll
          for (int q = 0; q < kTermsY - p; ++q)
            wgmma_m64n64k16_rs<1>(yacc, a[ii][p][0], a[ii][p][1], a[ii][p][2],
                                  a[ii][p][3], term_desc(sb, g - 1, q, ii));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int ii = 0; ii < kSubs; ++ii) fence_terms(a[ii]);
    }
    fence_regs(yacc);
  }

  // 5. the chain: wait for S_{c-1} (its publisher holds an earlier ticket,
  //    so it has started; a fault that kept it from publishing traps, a
  //    launch error, instead of hanging), publish S_c
  float prev[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) prev[i] = 0.f;
  if (blk.c > 0) {
    const int from = blk.bh * kRing + (blk.c - 1) % kRing;
    if (t == 0)
      for (long long polls = 0; ld_acquire(flags + from) != blk.c; ++polls) {
        if (polls > (1ll << 26)) __trap();
        __nanosleep(32);
      }
    __syncthreads();
    const float* src = states + (size_t)from * kSlotFloats;
#pragma unroll
    for (int i = 0; i < kFrag; i += 2) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(
          src + frag_row(t, i) * kCols + frag_col(t, i)));
      prev[i] = p.x;
      prev[i + 1] = p.y;
    }
  }
  const float keep[2] = {expf(cum[(Q - 1) * kLd + frag_row(t, 0)]),
                         expf(cum[(Q - 1) * kLd + frag_row(t, 2)])};
#pragma unroll
  for (int i = 0; i < kFrag; ++i)
    acc[i] = chain(keep[(i / 2) % 2], prev[i], acc[i]);
  const int to = blk.bh * kRing + blk.c % kRing;
  if (blk.c + 1 < nc) {
    float* dst = states + (size_t)to * kSlotFloats;
#pragma unroll
    for (int i = 0; i < kFrag; i += 2)
      __stcg(reinterpret_cast<float2*>(dst + frag_row(t, i) * kCols +
                                       frag_col(t, i)),
             make_float2(acc[i], acc[i + 1]));
  } else {
    store_state(state_out, D, blk.bh, t, acc);
  }

  // 6. while S_c's stores drain: y += (r exp(cum_prev)) S_{c-1}, S_{c-1}
  //    as two terms in slot 0 (every warp's products that read S_e are
  //    done); then S_c's flag
  if (blk.c > 0) {
    __syncthreads();
    store_terms(write, 0, t, prev);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    rs_products<kTermsY, true>(
        yacc, kSubs,
        [&](int kk, float (&vals)[8]) { re_slice(at, cp, kk, t, vals); },
        [&](int kk, int q) { return term_desc(sb, 0, q, kk); });
  }
  if (blk.c + 1 < nc) {
    __threadfence();
    __syncthreads();
    if (t == 0) st_release(flags + to, blk.c + 1);
  }
  store_y(y, D, blk, t, yacc);
}

int launch_tc(const void* r, const void* k, const void* v, const float* logw,
              const float* u, void* y, float* state, float* states,
              int* flags, const Dims& D, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_scan_tc_kernel<<<D.BH * (D.S / D.Q), kTcThreads, kTcSmemBytes,
                        (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), logw, u,
      static_cast<__nv_bfloat16*>(y), state, states, flags, D,
      (int)wide_ok(D, r, k, v));
  return (int)cudaGetLastError();
}

#else  // the host model of wkv6_scan_tc_kernel

// acc += A B as rs_products takes it, over the warpgroup's 128 threads in
// turn: vals_of(kk, t, vals), each product read through its descriptors.
template <int T, bool SplitB, class Vals, class Desc>
void model_products(SmemModel& model, Mat& acc, int n, const Vals& vals_of,
                    const Desc& desc_of) {
  static std::uint32_t regs[T][128][4];
  for (int kk = 0; kk < n; ++kk) {
    for (int t = 0; t < 128; ++t) {
      float vals[8];
      vals_of(kk, t, vals);
      std::uint32_t terms[T][4];
      split_terms(vals, 0, terms);
      for (int p = 0; p < T; ++p)
        for (int j = 0; j < 4; ++j) regs[p][t][j] = terms[p][j];
    }
    for (int p = 0; p < T; ++p) {
      float a[kMmaM][kMmaK];
      a_from_regs(regs[p], a);
      for (int q = 0; q < (SplitB ? T - p : 1); ++q)
        model_wgmma(model, a, desc_of(kk, q), 1, kCols, acc.data());
    }
  }
}

int launch_tc(const void* r, const void* k, const void* v, const float* logw,
              const float* u, void* y, float* state, float* states,
              int* flags, const Dims& D, void*) {
  SmemModel model;
  const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(r);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const int Q = D.Q, nc = D.S / Q, ng = cdiv(Q, kSub), tiles = D.BH * nc;
  const bool wide = wide_ok(D, r, k, v);
  std::vector<float> cum(kRows * kLd), cp(kRows * kLd), sc(kRows * kLdSc);
  static float frags[128][kFrag], prev[128][kFrag], pfr[128][kFrag];
  const auto at = [&](int tile, int row, int col) {
    return model.at(tile + tile_at(row, col));
  };
  const auto at4 = [&](int tile, int row, int col, float (&out)[4]) {
    for (int j = 0; j < 4; ++j) out[j] = at(tile, row, col + j);
  };
  const auto write = [&](std::uint32_t off, std::uint32_t val) {
    model.store(off, &val, 4);
  };
  const auto vdesc = [](int kk, int) { return v_desc(0, kk); };
  for (int it = 0; it < tiles; ++it) {
    // a tile finds shared memory as the tile before left it, NaN here, so
    // that a read of a place not written shows
    model.smem.assign(kCumOff, 0xFF);
    std::fill(cum.begin(), cum.end(), NAN);
    std::fill(cp.begin(), cp.end(), NAN);
    std::fill(sc.begin(), sc.end(), NAN);
    const Block blk = block_of(flags[D.BH * kRing]++, D);
    // 1. the copies, the cumsums
    const auto copy = [&](int bytes) {
      return [&model, bytes](std::uint32_t off, const __nv_bfloat16* src,
                             bool live) {
        unsigned char zero[16] = {};
        model.store(off, live ? static_cast<const void*>(src) : zero, bytes);
      };
    };
    if (wide)
      chunk_copies<16>(copy(16), blk, D, rb, kb, vb, 0, 1);
    else
      chunk_copies<8>(copy(8), blk, D, rb, kb, vb, 0, 1);
    logw_copies([&](int at, const float* src) {
      std::memcpy(&cp[at], src, 16);
    }, blk, D, logw, 0, 1);
    for (int i = 0; i < kCols; ++i) cumsum_channel(i, D, cum.data(), cp.data());
    // 2. the CUDA cores' sums, each quad's parts added as its shuffles add
    //    them
    static float part[128][kSub + 1];
    for (int t = 0; t < 128; ++t)
      score_part(t, at4, u + (size_t)blk.bh * D.C, cum.data(), cp.data(), D,
                 part[t]);
    for (int t = 0; t < 128; ++t) {
      const float* p0 = part[t & ~3];
      float sum[kSub + 1];
      for (int j = 0; j <= kSub; ++j)
        sum[j] = add_rn(add_rn(p0[j], p0[kSub + 1 + j]),
                        add_rn(p0[2 * (kSub + 1) + j], p0[3 * (kSub + 1) + j]));
      store_scores(t, sum, sc.data());
    }
    // 3. the chunk's states at its sub-chunk ends, chained; their terms
    //    to their tiles, L kept
    for (int g = 0; g < ng; ++g) {
      Mat part(kRows * kCols, 0.f);
      model_products<kTermsS, false>(
          model, part, 1,
          [&](int, int t, float (&vals)[8]) {
            kd_slice(at, cum.data(), g, Q, t, vals);
          },
          [g](int, int) { return v_desc(0, g); });
      to_frags(part, pfr);
      for (int t = 0; t < 128; ++t) {
        sub_chain(cum.data(), g, Q, t, frags[t], pfr[t]);
        if (g + 1 < ng) store_terms(write, g, t, frags[t]);
      }
    }
    // 4. y within the chunk
    Mat yv(kRows * kCols, 0.f);
    model_products<kTermsY, false>(
        model, yv, ng,
        [&](int kk, int t, float (&vals)[8]) {
          sc_slice(sc.data(), kk, t, D, vals);
        },
        vdesc);
    model_products<kTermsY, true>(
        model, yv, (ng - 1) * kSubs,
        [&](int kk, int t, float (&vals)[8]) {
          rt_slice(at, cum.data(), cp.data(), kk / kSubs + 1, kk % kSubs, t,
                   vals);
        },
        [](int kk, int q) { return term_desc(0, kk / kSubs, q, kk % kSubs); });
    // 5. the chain through the ring (frags holds L)
    const int from = blk.bh * kRing + (blk.c + kRing - 1) % kRing;
    const int to = blk.bh * kRing + blk.c % kRing;
    if (blk.c > 0 && flags[from] != blk.c) model.ok = false;
    for (int t = 0; t < 128; ++t) {
      const float keep[2] = {expf(cum[(Q - 1) * kLd + frag_row(t, 0)]),
                             expf(cum[(Q - 1) * kLd + frag_row(t, 2)])};
      for (int i = 0; i < kFrag; ++i) {
        const int at_i = frag_row(t, i) * kCols + frag_col(t, i);
        prev[t][i] = blk.c > 0 ? states[(size_t)from * kSlotFloats + at_i]
                               : 0.f;
        frags[t][i] = chain(keep[(i / 2) % 2], prev[t][i], frags[t][i]);
        if (blk.c + 1 < nc) states[(size_t)to * kSlotFloats + at_i] =
            frags[t][i];
      }
      if (blk.c + 1 == nc) store_state(state, D, blk.bh, t, frags[t]);
    }
    if (blk.c + 1 < nc) flags[to] = blk.c + 1;
    // 6. y through S_{c-1}, and y's stores
    if (blk.c > 0) {
      for (int t = 0; t < 128; ++t) store_terms(write, 0, t, prev[t]);
      model_products<kTermsY, true>(
          model, yv, kSubs,
          [&](int kk, int t, float (&vals)[8]) {
            re_slice(at, cp.data(), kk, t, vals);
          },
          [](int kk, int q) { return term_desc(0, 0, q, kk); });
    }
    to_frags(yv, frags);
    for (int t = 0; t < 128; ++t) store_y(yb, D, blk, t, frags[t]);
  }
  return model.ok ? 0 : -3;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the float32 (CUDA-core)
// kernel uses at chunk Q and head size C (kernels/wkv6_scan.py::smem_plan
// states the same by part).
int wkv6_scan_smem_bytes(int Q, int C) {
  return (int)(plan_of(Q, C).total * sizeof(float));
}

// Bytes of dynamic shared memory one block of the bf16 (tensor-core)
// kernel asks for, whatever the dims (kernels/wkv6_scan.py::tc_smem_plan
// states the same by part).
int wkv6_scan_tc_smem_bytes() { return kTcSmemBytes; }

// Launches the scan on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or -1 for dimensions the kernels do not take (a
// chunk outside [1, 64] or not dividing S, C not a multiple of 4 in
// [4, 64]), or -2 where r, k or v is bf16 and not 8-byte aligned, or
// logw not 16-byte aligned (the tensor-core kernel copies 8 bytes of bf16
// and 16 of float at a time at least). r, k, v, y are
// device pointers of float (bf16 = 0: the CUDA-core kernel) or
// __nv_bfloat16 (bf16 = 1: the tensor-core kernel); logw, u, state of
// float. The tensor-core kernel also takes its scratch: `states`, [BH, 2,
// 64, 64] float (the ring of carried states), and `flags`, BH x 2 + 1 int,
// zero (a flag per slot, then the ticket counter); the CUDA-core kernel
// ignores both.
int wkv6_scan_launch(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, void* y,
                     float* state, float* states, int* flags, int BH, int S,
                     int C, int Q, int bf16, void* stream) {
  if (!dims_ok(BH, S, C, Q)) return -1;
  if (bf16 && (((reinterpret_cast<std::uintptr_t>(r) |
                 reinterpret_cast<std::uintptr_t>(k) |
                 reinterpret_cast<std::uintptr_t>(v)) & 7) ||
               (reinterpret_cast<std::uintptr_t>(logw) & 15)))
    return -2;
  const Dims D{BH, S, C, Q};
  return bf16 ? launch_tc(r, k, v, logw, u, y, state, states, flags, D,
                          stream)
              : launch_f32(r, k, v, logw, u, y, state, D, stream);
}

}  // extern "C"
