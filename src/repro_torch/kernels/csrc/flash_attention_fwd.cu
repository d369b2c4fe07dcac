// Causal GQA flash attention, forward, for Hopper (sm_90a): the output and
// the row logsumexp of softmax(q k^T / sqrt(D)) v for every batch row, head
// and block of queries, in ONE launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// _flash_fwd (body _fwd_kernel :36, pallas_call :91) of the JAX package, and
// computes what _fwd_kernel computes:
//   s   = (q * scale) k^T in float32, q upcast from its type, scale 1/sqrt(D)
//   s   = -inf where kpos > qpos (causal; absolute positions from 0)
//   an online softmax over the key tiles with a running max m and sum l in
//   float32, p = exp(s - m) kept in float32 into the product p v
//   out = acc / max(l, 1e-30) in q's type
//   lse = m + log(l) in float32 [B, H, Sq] (0 for a row that saw no key)
// causal = 0 drops the mask.
//
// Layout: q, out [B, H, Sq, D]; k, v [B, Kv, Sk, D], contiguous; query head
// h reads key/value head h / (H / Kv) (GQA). Which dtype takes which kernel:
//   bfloat16 -> flash_fwd_tc_kernel: tiles staged by TMA, the scores on the
//               CUDA cores, P V on the tensor cores (wgmma). This is what
//               serving and training run.
//   float32  -> flash_fwd_kernel: float32 FMAs on the CUDA cores. A
//               tensor-core float32 product would be TF32, which the port
//               never uses.
//
// What bounds it. Causal attention does 2 B H S^2 D operations (S(S+1)/2
// query-key pairs, 4 D each) on 2 B (H + Kv) S D elements: at B 4, S 512,
// H 32, Kv 4, D 128 in bf16 that is 8.6 GFLOP on 38 MB, at B 1, S 4096 137
// GFLOP on 76 MB. Against the card's bf16 tensor rate (989 TFLOP/s) and
// 3.35 TB/s the first is bound by the bytes (11 us), the second by the
// operations (139 us) (kernels/flash_attention.py::work).
//
// Precision plan of the bfloat16 kernel. The card holds it against
// flash_attention_fwd_plain on every layer of random-weight serving models
// (chip_smoke.py serve, serve_hybrid) at 2^-8 of the largest output. There
// the scores reach |s| ~ 2,500, where float32 resolves p = exp(s - m) only
// to ~1e-3, and about a thousand outputs per layer lie in the largest
// value's binade, where one bf16 step is already over 2^-8 of it. So the
// scores must be the plain version's bit for bit: q * scale rounded to
// float32, then fmaf over d = 0 .. D - 1 from 0 (cuBLAS's order for these
// float32 products). A tensor-core q k^T, or even q k^T in float64, misses
// the bound on some layers; the CUDA cores sum in that order (S below).
// exp is the library's expf, as the plain version's (ex2.approx with a
// log2 e fold misses it on zamba2-7b's attentions). p goes into P V as
// three bf16 terms (p_hi = bf16(p), p_mid, p_lo the roundings of what is
// left), which hold a float32 p exactly: 6 D tensor operations per pair
// where work() counts 2 D for p v (two terms miss the bound on one of
// zamba2-7b's attentions). Each tile's P V is summed on its own and added
// as O alpha + P V (_fwd_kernel's order; rescaling O first and adding the
// products into it misses it there too). l sums the float32 p. Rounding p
// once to bf16 puts ~12 % of the outputs more than one bf16 step from the
// plain version, 100x the card's share bound (tests/test_torch_flash.py
// pins the plan).
//
// bfloat16 design (flash_fwd_tc_kernel). One block of 384 threads per
// (batch row, head, 128 queries), the late query blocks of a head first so
// that the longest causal rows start first, the blocks of one head
// adjacent so that its keys and values stay in L2. Not persistent, no
// split-K, no atomics: each output is summed by one block in one order, so
// two launches agree bitwise.
//   - TMA. Three-dimensional maps over q {D, Sq, B H} and k, v {D, Sk,
//     B Kv} (innermost first), each box 64 columns (128 bytes) wide in the
//     128-byte swizzle; the head dim takes two boxes, so D < 128 is
//     zero-filled to 128 (D 112: columns 112-127); the scores stop at D,
//     and the zero columns of v give output columns the store masks. Query
//     rows past Sq and key rows past Sk are zero-filled too; such keys are
//     masked to -inf. The q tile (128 rows) is loaded once; the k and v
//     tiles of 128 keys go through a ring of kStages stages, each with a
//     "full" and an "empty" mbarrier.
//   - Warps 8-11 are the producer warpgroup. It gives its registers up
//     (setmaxnreg to 24 a thread, so that the consumers may take 240 of the
//     168 a thread the block was launched with), and one of its threads
//     waits for a stage to be empty, arms its full barrier with the stage's
//     bytes and issues the four loads of a tile.
//   - Warps 0-3 and 4-7 are two consumer warpgroups of 64 query rows. First
//     they turn the bf16 q tile into q * scale in float32 (once per block).
//     Per key tile a warpgroup waits for "full"; each lane computes 8 rows
//     x 8 keys of S with float32 FMAs, reading 16 bytes of q scale per row
//     and 8 bytes of the bf16 k box per key for every 4 head-dim columns
//     (32 FMAs each), then the warp's 16 x 128 scores pass through its
//     exchange buffer into the wgmma accumulator layout, half the keys at
//     a time. The online softmax runs in that fragment: a thread holds 32
//     scores of each of two rows, the row maxima are taken across the quad
//     of threads that share a row (shfl_xor 1, 2), and each thread keeps a
//     partial l that the quad sums at the end; the max and the sum of a
//     row run as 4 independent chains, and the guards select expf's
//     argument, not its result (a select of the result compiles to a
//     branch around every exp). p goes from the fragment straight into the
//     A operand of P V (the register form, RS): for a 16-bit A the
//     accumulator of columns 16 kk .. 16 kk + 15 is, pair by pair, the A
//     fragment of slice kk, so no proxy fence and no barrier between the
//     warpgroup's threads. 24 wgmma m64n128k16 per tile (3 terms per 16
//     keys) in two halves, V MN-major through the transpose bit, into a
//     P V accumulator; then O = O alpha + P V and the stage is released.
//     The scores on the CUDA cores set the time: at 1 x 4096 tokens
//     (Yi-9B) they alone take about two thirds of it. The two warpgroups
//     taking turns at the scores by named barriers was slower on an H100.
//   - Epilogue: out = O / max(l, 1e-30) as bf16 pairs, rows >= Sq and
//     columns >= D masked; lse from the quad's first thread.
// Shared memory per block: flash_attention_fwd_tc_smem_bytes
// (= kernels/flash_attention.py::tc_smem_plan).
//
// float32 design (flash_fwd_kernel). One thread block of 256 threads per
// (batch row, head, block of 64 queries), blocks of late queries first. The
// key/value tiles are a loop inside the block (on the TPU a sequential grid
// axis); the causal loop ends at the diagonal tile. Tiles live in dynamic
// shared memory as float32 (153,600 B at D = 128): q times scale and k
// transposed ([d][row], rows padded to 68 so that the transposing stores of
// a warp hit 32 banks), v row major, the score tile transposed, the
// accumulator, and m, l per row. Each product runs as 4 x 4 register tiles
// (16 FMAs per two 16-byte loads). Every phase is a loop strided by
// blockDim.x whose iterations write disjoint elements, separated by
// __syncthreads(), so one thread per block computes the same (the CPU
// emulation in the tests runs it so).
//
// Without nvcc (the CPU emulation in the tests), the bfloat16 launcher runs
// a host model of the tensor-core kernel instead: the same blocks, tiles,
// stage offsets, box coordinates, q scale, lanes of the scores and their
// exchange into the fragment, softmax steps, three-term split of p,
// accumulator-to-A-fragment packing, descriptors and epilogue, with TMA's
// zero fill and the 128-byte swizzle written out (tma_wgmma.cuh, shared
// with gmm.cu and flash_attention_bwd.cu) and each product read through
// its descriptors. It cannot show the PTX, the barriers, the fragment
// layout on the card or the tensor cores' own order of sums; the card's
// checks do.

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

// isfinite without the library's overloads: false for +-inf and NaN.
__host__ __device__ inline bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 128;
constexpr int kLdQ = kBlockQ + 4;  // row stride of the transposed q / p tiles
constexpr int kLdK = kBlockK + 4;  // row stride of the transposed k tile

// dst[d * ld + r] = src[r * D + d] * mul for a [rows, D] tile. A warp's 32
// lanes take 4 rows x 8 columns: 32-byte reads of each row, and stores that
// fall on 32 different banks since ld % 32 == 4.
__device__ void load_transposed(float* dst, const float* src, int rows, int D,
                                int ld, float mul) {
  const int groups = rows / 4;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int lane = e & 31, rest = e >> 5;
    const int r = (rest % groups) * 4 + (lane & 3);
    const int d = (rest / groups) * 8 + (lane >> 2);
    dst[d * ld + r] = src[(size_t)r * D + d] * mul;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Dims P) {
  extern __shared__ float smem[];
  const int D = P.D;
  float* qT = smem;                   // [D][kLdQ]  q * scale
  float* kT = qT + D * kLdQ;          // [D][kLdK]  key tile
  float* vs = kT + D * kLdK;          // [kBlockK][D] value tile
  float* pT = vs + kBlockK * D;       // [kBlockK][kLdQ] scores, then p
  float* acc = pT + kBlockK * kLdQ;   // [kBlockQ][D]
  float* m = acc + kBlockQ * D;       // [kBlockQ] running max
  float* l = m + kBlockQ;             // [kBlockQ] running sum
  float* alpha = l + kBlockQ;         // [kBlockQ] rescale of acc and l
  float* msafe = alpha + kBlockQ;     // [kBlockQ] m, or 0 where not finite

  const int nq = P.Sq / kBlockQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * kBlockQ;
  const int b = bh / P.H, h = bh % P.H;
  const size_t kv_base = ((size_t)b * P.Kv + h / (P.H / P.Kv)) * P.Sk * D;
  const size_t q_base = ((size_t)bh * P.Sq + q0) * D;

  load_transposed(qT, q + q_base, kBlockQ, D, kLdQ, P.scale);
  for (int e = threadIdx.x; e < kBlockQ * D; e += blockDim.x) acc[e] = 0.f;
  for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  int nk = P.Sk / kBlockK;
  if (P.causal) nk = min(nk, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_transposed(kT, k + kv_base + (size_t)k0 * D, kBlockK, D, kLdK, 1.f);
    for (int e = threadIdx.x; e < kBlockK * D; e += blockDim.x)
      vs[e] = v[kv_base + (size_t)k0 * D + e];
    __syncthreads();

    // scores: 4 queries x 4 keys per iteration, masked, stored transposed
    for (int t = threadIdx.x; t < (kBlockQ / 4) * (kBlockK / 4);
         t += blockDim.x) {
      const int r0 = (t % (kBlockQ / 4)) * 4, c0 = (t / (kBlockQ / 4)) * 4;
      float s[4][4] = {};
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qT + d * kLdQ + r0);
        const float4 c = *reinterpret_cast<const float4*>(kT + d * kLdK + c0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(av[i], cv[jj], s[i][jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          col[i] = (P.causal && k0 + c0 + jj > q0 + r0 + i) ? -INFINITY
                                                            : s[i][jj];
        *reinterpret_cast<float4*>(pT + (c0 + jj) * kLdQ + r0) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // running max; the rescale of what was accumulated before this tile
    for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
      float mx = -INFINITY;
      for (int c = 0; c < kBlockK; ++c) mx = fmaxf(mx, pT[c * kLdQ + r]);
      const float m_prev = m[r], m_new = fmaxf(m_prev, mx);
      const float safe = finite(m_new) ? m_new : 0.f;
      alpha[r] = finite(m_prev) ? expf(m_prev - safe) : 0.f;
      m[r] = m_new;
      msafe[r] = safe;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBlockK * kBlockQ; e += blockDim.x) {
      const int c = e / kBlockQ, r = e % kBlockQ;
      float* p = pT + c * kLdQ + r;
      *p = finite(m[r]) ? expf(*p - msafe[r]) : 0.f;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
      float sum = 0.f;
      for (int c = 0; c < kBlockK; ++c) sum += pT[c * kLdQ + r];
      l[r] = l[r] * alpha[r] + sum;
    }
    // acc = acc alpha + p v: 4 queries x 4 dims per iteration
    for (int t = threadIdx.x; t < (kBlockQ / 4) * (D / 4); t += blockDim.x) {
      const int n0 = (t % (D / 4)) * 4, r0 = (t / (D / 4)) * 4;
      float pv[4][4] = {};
      for (int c = 0; c < kBlockK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(pT + c * kLdQ + r0);
        const float4 w = *reinterpret_cast<const float4*>(vs + c * D + n0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            pv[i][jj] = fmaf(av[i], wv[jj], pv[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* dst = reinterpret_cast<float4*>(acc + (r0 + i) * D + n0);
        const float4 cur = *dst;
        const float al = alpha[r0 + i];
        *dst = make_float4(cur.x * al + pv[i][0], cur.y * al + pv[i][1],
                           cur.z * al + pv[i][2], cur.w * al + pv[i][3]);
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kBlockQ * D; e += blockDim.x)
    out[q_base + e] = acc[e] / fmaxf(l[e / D], 1e-30f);
  for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x)
    lse[(size_t)bh * P.Sq + q0 + r] =
        finite(m[r]) ? m[r] + logf(fmaxf(l[r], 1e-30f)) : 0.f;
}

size_t smem_floats(int D) {
  return (size_t)D * kLdQ + (size_t)D * kLdK + (size_t)kBlockK * D +
         (size_t)kBlockK * kLdQ + (size_t)kBlockQ * D + 4 * kBlockQ;
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Dims& P, void* stream) {
  const int n = P.B * P.H * (P.Sq / kBlockQ);
  const int smem = (int)(smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: S on the CUDA cores, P V on the tensor cores. What follows up to
// the CUDA-only part is shared by the kernel and the host model.

constexpr int kTcQ = 128;                    // queries per block
constexpr int kTcKeys = 128;                 // keys per tile
constexpr int kWgRows = kMmaM;               // query rows per warpgroup
constexpr int kConsumers = kTcQ / kWgRows;   // warpgroups
constexpr int kTcThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kProducerRegs = 24;            // setmaxnreg, per thread
constexpr int kConsumerRegs = 240;
// a block holds the registers it was launched with (65,536 / 384 threads,
// a multiple of 8: 168 each) and setmaxnreg only moves them between its
// warpgroups: an increase past what the others gave up waits for ever
constexpr int kLaunchRegs = 65536 / kTcThreads / 8 * 8;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <=
                  kLaunchRegs * kTcThreads,
              "the registers the block was launched with");
constexpr int kBoxCols = 64;                 // head-dim columns of a box
constexpr int kBoxes = kMaxD / kBoxCols;     // D zero-filled to 128
constexpr int kQBoxBytes = kTcQ * kRowBytes;       // 16 KiB
constexpr int kKvBoxBytes = kTcKeys * kRowBytes;   // 16 KiB
constexpr int kQBytes = kBoxes * kQBoxBytes;       // the q tile, 32 KiB
constexpr int kStageBytes = 2 * kBoxes * kKvBoxBytes;  // k then v, 64 KiB
constexpr int kStages = 2;
constexpr int kQsBytes = kTcQ * kMaxD * 4;        // q scale, float32, 64 KiB
constexpr int kXKeys = kTcKeys / 2;                // keys per exchange
constexpr int kXBytes = 16 * kXKeys * 4;           // a warp's, 4 KiB
constexpr int kXAllBytes = kConsumers * 4 * kXBytes;  // 32 KiB
static_assert(kXAllBytes == kQBytes,
              "the bf16 q tile lands where the exchange buffers lie");
constexpr int kKeySlices = kTcKeys / kMmaK;  // k16 slices of O += P V
constexpr int kPTerms = 3;                   // bf16 terms of p into P V
constexpr int kPvTransB = 1;                 // V: MN-major
constexpr int kFrag = kTcKeys / 2;           // S and O floats per thread
static_assert(kMaxD == kTcKeys, "S and O share the m64n128 fragment");

// Bytes of dynamic shared memory a block asks for: slack to align to the
// swizzle atom, q scale in float32, the stages, the bf16 q tile (which,
// once turned into q scale, becomes the consumer warps' buffers for the
// exchange of S), a full and an empty mbarrier per stage and the q tile's
// mbarrier.
__host__ __device__ constexpr int tc_smem_bytes(int stages) {
  return kSwizzleAtom + kQsBytes + stages * kStageBytes + kXAllBytes +
         (2 * stages + 1) * 8;
}

// What block `index` computes: query head row bh (b H + h), its first query
// q0, the key/value head row kvh (b Kv + h / (H / Kv)) and the key tiles nk
// (the causal loop ends at the diagonal tile).
struct Block {
  int bh, q0, kvh, nk;
};

__host__ __device__ inline Block block_of(int index, const Dims& P) {
  const int nq = cdiv(P.Sq, kTcQ);
  const int bh = index / nq, q0 = (nq - 1 - index % nq) * kTcQ;
  const int kvh = (bh / P.H) * P.Kv + (bh % P.H) / (P.H / P.Kv);
  int nk = cdiv(P.Sk, kTcKeys);
  if (P.causal) {
    const int diagonal = (q0 + kTcQ - 1) / kTcKeys + 1;
    nk = nk < diagonal ? nk : diagonal;
  }
  return {bh, q0, kvh, nk};
}

// Where an element lies. The q tile and every k or v box are rows of 128
// bytes (64 head-dim columns) in the 128-byte swizzle; q_at and kv_at give
// the offset before the swizzle (swizzle128 of it is where TMA put it), of
// row `row`, column d.
__host__ __device__ constexpr std::uint32_t q_at(int row, int d) {
  return (d / kBoxCols) * kQBoxBytes + row * kRowBytes + (d % kBoxCols) * 2;
}
__host__ __device__ constexpr std::uint32_t kv_at(int key, int d) {
  return (d / kBoxCols) * kKvBoxBytes + key * kRowBytes + (d % kBoxCols) * 2;
}

// q scale in float32: rows of 128 floats.
__host__ __device__ constexpr int qs_at(int row, int d) {
  return row * kMaxD + d;
}

// Who computes which score. A consumer warp owns 16 query rows (those of
// its part of the S fragment) and a tile's 128 keys; lane L computes rows
// 8 (L / 16) + i and keys L % 16 + 16 j for i, j in 0..7 (the keys 16
// apart, so that the 8 lanes of a quarter warp read 8 different 8-byte
// pieces of the swizzled k box), then, half the keys at a time, writes
// them to the warp's exchange buffer (16 rows of 64 floats), whence each
// lane reads its fragment.
__host__ __device__ constexpr int s_row(int lane, int i) {
  return 8 * (lane / 16) + i;
}
__host__ __device__ constexpr int s_key(int lane, int j) {
  return lane % 16 + 16 * j;
}
__host__ __device__ constexpr int x_at(int row, int key) {
  return row * kXKeys + key % kXKeys;
}

// O += P V, key slice kk (16 keys): B = v, MN-major (D contiguous), 16 key
// rows further per slice, the second 64-column box kKvBoxBytes further
// (LBO), 8-row groups 1,024 bytes apart (SBO).
__host__ __device__ inline std::uint64_t v_desc(std::uint32_t stage, int kk) {
  return sw128_desc(stage + kBoxes * kKvBoxBytes + kk * kMmaK * kRowBytes,
                    kKvBoxBytes, 8 * kRowBytes);
}

// The loads: copy(map, smem address, c0, c1, c2) with map 0 = q {D, Sq,
// B H}, 1 = k and 2 = v {D, Sk, B Kv}, coordinates innermost first. The q
// tile once; per key tile k0 the k boxes, then the v boxes, into a stage.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void q_loads(const Copy& copy, std::uint32_t qs,
                                        const Block& blk) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j)
    copy(0, qs + j * kQBoxBytes, j * kBoxCols, blk.q0, blk.bh);
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void stage_loads(const Copy& copy,
                                            std::uint32_t stage, int k0,
                                            const Block& blk) {
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
    copy(1, stage + j * kKvBoxBytes, j * kBoxCols, k0, blk.kvh);
    copy(2, stage + (kBoxes + j) * kKvBoxBytes, j * kBoxCols, k0, blk.kvh);
  }
}

// The online softmax in the S fragment of thread t (rows frag_row(t, i) of
// the warpgroup's qrow0.., columns frag_col(t, i) of the tile's k0..). The
// row max and sum run as kChains independent chains per row, so that they
// do not wait on one another.
constexpr int kChains = 4;

// 1. S = -inf where the key is past Sk or (causal) after the query; mx =
//    the thread's own maxima of its two rows.
__host__ __device__ inline void mask_max(float (&s)[kFrag], float (&mx)[2],
                                         int t, int qrow0, int k0,
                                         const Dims& P) {
  if (k0 + kTcKeys > P.Sk || (P.causal && k0 + kTcKeys - 1 > qrow0)) {
#pragma unroll
    for (int i = 0; i < kFrag; ++i) {
      const int kpos = k0 + frag_col(t, i), qpos = qrow0 + frag_row(t, i);
      const bool masked = kpos >= P.Sk || (P.causal && kpos > qpos);
      s[i] = masked ? -INFINITY : s[i];
    }
  }
  float part[2][kChains];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < kChains; ++u) part[r][u] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    float& x = part[(i / 2) % 2][(i / 4) % kChains];
    x = fmaxf(x, s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]),
                  fmaxf(part[r][2], part[r][3]));
}

// 2. (the row max across the quad: mx becomes the tile's row max of s)
// 3. as _fwd_kernel: m_new = max(m, mx), safe = m_new or 0 where not
//    finite, p = exp(s - safe) (0 for a row with no finite score), alpha =
//    exp(m - safe) (0 where m is not finite), l = l alpha + sum p, with l
//    the thread's own part of the row sum. expf is the library's, as the
//    plain version's exp. The guards select the exponent (exp(-inf) = 0),
//    not the result: a select of the result compiles to a branch around
//    every exponential, which runs them one at a time.
__host__ __device__ inline void exp_update(float (&s)[kFrag],
                                           const float (&mx)[2],
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  float safe[2], sum[2][kChains];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    live[r] = finite(m_new);
    safe[r] = live[r] ? m_new : 0.f;
    alpha[r] = expf(finite(m[r]) ? m[r] - safe[r] : -INFINITY);
    m[r] = m_new;
#pragma unroll
    for (int u = 0; u < kChains; ++u) sum[r][u] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    const int r = (i / 2) % 2;
    const float p = expf(live[r] ? s[i] - safe[r] : -INFINITY);
    s[i] = p;
    sum[r][(i / 4) % kChains] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// 4. O = O alpha + (P V of the tile), one rounding each, in _fwd_kernel's
//    order: the tile's P V is summed on its own. (O alpha rounded first,
//    then the products added into O, puts twice as many outputs one bf16
//    step from the plain version on zamba2-7b's attentions, and one of
//    them into the largest values' binade, over the 2^-8 bound.)
__host__ __device__ inline void add_tile(float (&o)[kFrag],
                                         const float (&alpha)[2],
                                         const float (&pv)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) o[i] = fmaf(o[i], alpha[(i / 2) % 2], pv[i]);
}

// p of part `part` of a tile (key slices kPartSlices part ..) as kPTerms
// bf16 terms (split_terms: p_hi = bf16(p), p_mid = bf16(p - p_hi), p_lo =
// bf16(p - p_hi - p_mid)), which hold a float32 p exactly, so the products
// see p itself (two terms put an output of zamba2-7b's attentions over the
// bound). Register j of a term holds p[2 kPartRegs part + 2j] and the next;
// registers 4 (kk - kPartSlices part) .. + 3 of each term are the A
// fragment of key slice kk. A part of a tile at a time, so that the terms,
// O and the tile's P V fit the registers together.
constexpr int kPvParts = 2;
constexpr int kPartSlices = kKeySlices / kPvParts;
constexpr int kPartRegs = kFrag / 2 / kPvParts;
__host__ __device__ inline void split_p(
    const float (&p)[kFrag], int part,
    std::uint32_t (&terms)[kPTerms][kPartRegs]) {
  split_terms(p, 2 * kPartRegs * part, terms);
}

// Thread t's part of out and lse: out = O / max(l, 1e-30) as bf16 pairs
// (rows >= Sq, columns >= D masked), lse = m + log(max(l, 1e-30)), 0 where
// m is not finite, from the first thread of each quad; l is the quad's sum.
__host__ __device__ inline void store_out(__nv_bfloat16* out, float* lse,
                                          const Dims& P, int bh, int qrow0,
                                          int t, const float (&o)[kFrag],
                                          const float (&m)[2],
                                          const float (&l)[2]) {
  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < kFrag; i += 2) {
    const int row = qrow0 + frag_row(t, i), col = frag_col(t, i);
    const float d = lc[(i / 2) % 2];
    if (row < P.Sq && col < P.D)
      store_pair(out + ((size_t)bh * P.Sq + row) * P.D + col, o[i] / d,
                 o[i + 1] / d);
  }
  if (t % 4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow0 + frag_row(t, 2 * r);
      if (row < P.Sq)
        lse[(size_t)bh * P.Sq + row] =
            finite(m[r]) ? m[r] + logf(lc[r]) : 0.f;
    }
}

MapSpec map_spec(int map, const Dims& P) {
  const std::uint64_t rows = map == 0 ? P.Sq : P.Sk;
  const std::uint64_t heads =
      map == 0 ? (std::uint64_t)P.B * P.H : (std::uint64_t)P.B * P.Kv;
  const std::uint32_t box_rows = map == 0 ? kTcQ : kTcKeys;
  return {{(std::uint64_t)P.D, rows, heads},
          {(std::uint64_t)P.D * 2, rows * P.D * 2},
          {(std::uint32_t)kBoxCols, box_rows, 1}};
}

#ifdef __CUDACC__

// pv += P V of part `part` of a tile, one m64n128k16 per key slice and
// term of p, A from the term's registers.
__device__ __forceinline__ void pv_products(
    float (&pv)[kFrag], const std::uint32_t (&terms)[kPTerms][kPartRegs],
    std::uint32_t stage, int part) {
#pragma unroll
  for (int kk = 0; kk < kPartSlices; ++kk) {
    const std::uint64_t dv = v_desc(stage, kPartSlices * part + kk);
#pragma unroll
    for (int u = 0; u < kPTerms; ++u)
      wgmma_m64n128k16_rs<kPvTransB>(pv, terms[u][4 * kk],
                                     terms[u][4 * kk + 1],
                                     terms[u][4 * kk + 2],
                                     terms[u][4 * kk + 3], dv);
  }
}

__device__ __forceinline__ void fence_terms(
    std::uint32_t (&terms)[kPTerms][kPartRegs]) {
#pragma unroll
  for (int u = 0; u < kPTerms; ++u) fence_regs(terms[u]);
}

// S of lane `lane`'s 8 rows x 8 keys (s[i][j]: row s_row(lane, i) of the
// warp's 16, from q tile row row0 on; key s_key(lane, j) of the stage's
// tile), as the plain version's float32 product sums it: each score
// starts at 0 and takes fmaf(q_d scale, k_d, s) for d = 0, 1, .., D - 1 in
// turn, q_d scale rounded to float32 before (qs). 4 head-dim columns at a
// time: 16 bytes of each row of qs, then 8 bytes of each key of the bf16 k
// box, each used for 32 FMAs.
__device__ __forceinline__ void scores(float (&s)[8][8], const float* qs,
                                       const unsigned char* k, int row0,
                                       int lane, int D) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          qs + qs_at(row0 + s_row(lane, i), d0));
      a[i][0] = x.x;
      a[i][1] = x.y;
      a[i][2] = x.z;
      a[i][3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          k + swizzle128(kv_at(s_key(lane, j), d0)));
      float kd[4];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        kd[dd] = half_of(dd < 2 ? raw.x : raw.y, dd % 2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          s[i][j] = fmaf(a[i][dd], kd[dd], s[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    Dims P) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  // q scale (float32), aligned to the swizzle atom; the ring; the bf16 q
  // tile, then the consumer warps' exchange buffers; the barriers
  const std::uint32_t qs = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                           ~(std::uint32_t)(kSwizzleAtom - 1);
  unsigned char* base = tc_smem + (qs - smem_u32(tc_smem));
  const std::uint32_t ring = qs + kQsBytes;
  const std::uint32_t xq = ring + kStages * kStageBytes;
  const std::uint32_t full = xq + kXAllBytes;
  const std::uint32_t empty = full + kStages * 8;
  const std::uint32_t qfull = empty + kStages * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's arm
      mbar_init(empty + 8 * s, kConsumers * 4);      // one per consumer warp
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // the producer warpgroup gives up registers; one thread loads q, then
    // keeps the ring full. (The block's coordinates are worked out after
    // setmaxnreg, so that no register lives across it: ptxas spills it.)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumers * 4 || lane != 0) return;
    const Block blk = block_of(blockIdx.x, P);
    const std::uint64_t maps[3] = {reinterpret_cast<std::uint64_t>(&qmap),
                                   reinterpret_cast<std::uint64_t>(&kmap),
                                   reinterpret_cast<std::uint64_t>(&vmap)};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps[i]) : "memory");
    mbar_arrive_expect_tx(qfull, kQBytes);
    q_loads(
        [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
          tma_load_3d(dst, maps[map], qfull, x0, x1, x2);
        },
        xq, blk);
    for (int j = 0; j < blk.nk; ++j) {
      const int s = j % kStages;
      const std::uint32_t bar = full + 8 * s;
      mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(bar, kStageBytes);
      stage_loads(
          [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
            tma_load_3d(dst, maps[map], bar, x0, x1, x2);
          },
          ring + s * kStageBytes, j * kTcKeys, blk);
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, all head-dim columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const Block blk = block_of(blockIdx.x, P);
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int qrow0 = blk.q0 + wg * kWgRows;
  const float* qsf = reinterpret_cast<const float*>(base);
  float* xbuf = reinterpret_cast<float*>(base + (xq - qs) + warp * kXBytes);
  float o[kFrag], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kFrag; ++i) o[i] = 0.f;
  mbar_wait(qfull, 0);
  // q scale, rounded to float32 once per block by the two warpgroups
  // together; then the bf16 q tile's place is free for the exchanges
  for (int task = threadIdx.x; task < kTcQ * (kMaxD / 8);
       task += kConsumers * 128) {
    const int row = task / (kMaxD / 8), d = task % (kMaxD / 8) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + (xq - qs) + swizzle128(q_at(row, d)));
    const std::uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float x[8];
#pragma unroll
    for (int dd = 0; dd < 8; ++dd)
      x[dd] = __fmul_rn(half_of(w[dd / 2], dd % 2), P.scale);
    float* dst = reinterpret_cast<float*>(base) + qs_at(row, d);
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
  for (int j = 0; j < block_of(block_index(), P).nk; ++j) {
    const int s = j % kStages, k0 = j * kTcKeys;
    const std::uint32_t stage = ring + s * kStageBytes;
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    // S = (q scale) k^T on the CUDA cores, then through the warp's buffer
    // into the fragment
    float sc[kFrag];
    {
      float s8[8][8];
      scores(s8, qsf, base + (stage - qs), wg * kWgRows + 16 * (warp % 4),
             lane, P.D);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // keys 64 h .. 64 h + 63
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 4 * h; jj < 4 * h + 4; ++jj)
            xbuf[x_at(s_row(lane, i), s_key(lane, jj))] = s8[i][jj];
        __syncwarp();
#pragma unroll
        for (int i = kFrag / 2 * h; i < kFrag / 2 * (h + 1); i += 2) {
          const float2 x = *reinterpret_cast<const float2*>(
              xbuf + x_at(frag_row(t, i) % 16, frag_col(t, i)));
          sc[i] = x.x;
          sc[i + 1] = x.y;
        }
      }
    }

    // the online softmax in the fragment
    float mx[2], alpha[2];
    mask_max(sc, mx, t, qrow0, k0, P);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    exp_update(sc, mx, m, l, alpha);
    // the second half of p waits in the thread's own places of the
    // exchange buffer while the first half's products run (in registers
    // with O, the tile's P V and the terms, ptxas spilled)
#pragma unroll
    for (int i = kFrag / 2; i < kFrag; i += 2)
      *reinterpret_cast<float2*>(
          xbuf + x_at(frag_row(t, i) % 16, frag_col(t, i))) =
          make_float2(sc[i], sc[i + 1]);

    // the tile's P V on the tensor cores, A from registers, a part of the
    // tile at a time; then O = O alpha + P V
    float pv[kFrag];
#pragma unroll
    for (int i = 0; i < kFrag; ++i) pv[i] = 0.f;
#pragma unroll
    for (int part = 0; part < kPvParts; ++part) {
      if (part == kPvParts / 2) {
#pragma unroll
        for (int i = kFrag / 2; i < kFrag; i += 2) {
          const float2 x = *reinterpret_cast<const float2*>(
              xbuf + x_at(frag_row(t, i) % 16, frag_col(t, i)));
          sc[i] = x.x;
          sc[i + 1] = x.y;
        }
      }
      std::uint32_t terms[kPTerms][kPartRegs];  // p as bf16 pairs
      split_p(sc, part, terms);
      fence_regs(pv);
      fence_terms(terms);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      pv_products(pv, terms, stage, part);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(pv);
      fence_terms(terms);
    }
    add_tile(o, alpha, pv);
    // the tile's k and v are read: release the stage
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_out(out, lse, P, block_of(block_index(), P).bh, qrow0, t, o, m, l);
}

int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const Dims& P, void* stream) {
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_map(&maps[i], map_spec(i, P), srcs[i]);
    if (err != 0) return err;
  }
  const int n = P.B * P.H * cdiv(P.Sq, kTcQ);
  const int smem = tc_smem_bytes(kStages);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<<<n, kTcThreads, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, P);
  return (int)cudaGetLastError();
}

#else  // the host model of flash_fwd_tc_kernel

// A warpgroup's state: the O tile and each thread's m and partial l.
struct WgState {
  float O[kWgRows][kMaxD];
  float m[128][2], l[128][2];
};

int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const Dims& P, void*) {
  SmemModel model;  // from the ring on (q scale is a vector of its own)
  model.smem.assign(kStages * kStageBytes + kQBytes, 0);
  const MapSpec maps[3] = {map_spec(0, P), map_spec(1, P), map_spec(2, P)};
  const void* srcs[3] = {q, k, v};
  const auto copy = [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
    model.copy(maps[map], srcs[map], dst, x0, x1, x2);
  };
  const std::uint32_t ring = 0, xq = kStages * kStageBytes;
  std::vector<WgState> wgs(kConsumers);
  std::vector<float> qsf(kQsBytes / 4), xbuf(kXBytes / 4),
      PV(kWgRows * kTcKeys);
  float sc[128][kFrag], mx[128][2], alpha[128][2];
  std::uint32_t terms[128][kPTerms][kPartRegs];
  for (int index = 0; index < P.B * P.H * cdiv(P.Sq, kTcQ); ++index) {
    const Block blk = block_of(index, P);
    q_loads(copy, xq, blk);
    for (int row = 0; row < kTcQ; ++row)
      for (int d = 0; d < kMaxD; ++d)
        qsf[qs_at(row, d)] = model.at(xq + q_at(row, d)) * P.scale;
    for (WgState& w : wgs) {
      for (auto& row : w.O)
        for (float& x : row) x = 0.f;
      for (int t = 0; t < 128; ++t) {
        w.m[t][0] = w.m[t][1] = -INFINITY;
        w.l[t][0] = w.l[t][1] = 0.f;
      }
    }
    for (int j = 0; j < blk.nk; ++j) {
      const int k0 = j * kTcKeys;
      const std::uint32_t stage = ring + (j % kStages) * kStageBytes;
      stage_loads(copy, stage, k0, blk);
      for (int wg = 0; wg < kConsumers; ++wg) {
        WgState& w = wgs[wg];
        const int qrow0 = blk.q0 + wg * kWgRows;
        for (int warp = 0; warp < 4; ++warp) {
          // S of each lane's rows and keys, as scores() sums it, through
          // the warp's exchange buffer half the keys at a time
          const int row0 = wg * kWgRows + 16 * warp;
          for (int h = 0; h < 2; ++h) {
            for (int lane = 0; lane < 32; ++lane)
              for (int i = 0; i < 8; ++i)
                for (int jj = 4 * h; jj < 4 * h + 4; ++jj) {
                  float s = 0.f;
                  for (int d = 0; d < P.D; ++d)
                    s = fmaf(qsf[qs_at(row0 + s_row(lane, i), d)],
                             model.at(stage + kv_at(s_key(lane, jj), d)), s);
                  xbuf[x_at(s_row(lane, i), s_key(lane, jj))] = s;
                }
            for (int t = 32 * warp; t < 32 * warp + 32; ++t)
              for (int i = kFrag / 2 * h; i < kFrag / 2 * (h + 1); ++i)
                sc[t][i] = xbuf[x_at(frag_row(t, i) % 16, frag_col(t, i))];
          }
          for (int t = 32 * warp; t < 32 * warp + 32; ++t)
            mask_max(sc[t], mx[t], t, qrow0, k0, P);
        }
        for (int t = 0; t < 128; t += 4)  // the quad's row max
          for (int r = 0; r < 2; ++r) {
            const float x = fmaxf(fmaxf(mx[t][r], mx[t + 1][r]),
                                  fmaxf(mx[t + 2][r], mx[t + 3][r]));
            for (int u = t; u < t + 4; ++u) mx[u][r] = x;
          }
        for (int t = 0; t < 128; ++t)
          exp_update(sc[t], mx[t], w.m[t], w.l[t], alpha[t]);
        std::fill(PV.begin(), PV.end(), 0.f);  // the tile's P V
        for (int part = 0; part < kPvParts; ++part) {
          for (int t = 0; t < 128; ++t) split_p(sc[t], part, terms[t]);
          for (int kk = 0; kk < kPartSlices; ++kk)
            for (int u = 0; u < kPTerms; ++u) {  // p_hi, p_mid, p_lo
              float A[kMmaM][kMmaK];
              for (int t = 0; t < 128; ++t)
                for (int r = 0; r < 4; ++r)
                  for (int h = 0; h < 2; ++h)
                    A[a_row(t, r)][a_col(t, r, h)] =
                        half_of(terms[t][u][4 * kk + r], h);
              model_wgmma(model, A, v_desc(stage, kPartSlices * part + kk),
                          kPvTransB, kTcKeys, PV.data());
            }
        }
        for (int t = 0; t < 128; ++t) {
          float ot[kFrag], pv[kFrag];
          for (int i = 0; i < kFrag; ++i) {
            ot[i] = w.O[frag_row(t, i)][frag_col(t, i)];
            pv[i] = PV[frag_row(t, i) * kTcKeys + frag_col(t, i)];
          }
          add_tile(ot, alpha[t], pv);
          for (int i = 0; i < kFrag; ++i)
            w.O[frag_row(t, i)][frag_col(t, i)] = ot[i];
        }
      }
    }
    for (int wg = 0; wg < kConsumers; ++wg) {
      WgState& w = wgs[wg];
      for (int t = 0; t < 128; ++t) {
        const int q4 = t & ~3;
        float l[2], ot[kFrag];
        for (int r = 0; r < 2; ++r)  // the quad's sum, as shfl_xor 1 then 2
          l[r] = (w.l[q4][r] + w.l[q4 + 1][r]) +
                 (w.l[q4 + 2][r] + w.l[q4 + 3][r]);
        for (int i = 0; i < kFrag; ++i)
          ot[i] = w.O[frag_row(t, i)][frag_col(t, i)];
        store_out(static_cast<__nv_bfloat16*>(o), lse, P, blk.bh,
                  blk.q0 + wg * kWgRows, t, ot, w.m[t], l);
      }
    }
  }
  return model.ok ? 0 : -3;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns cudaGetLastError() (0
// when the launch was accepted), or -1 for dimensions the kernels do not
// take (D not a multiple of 8 in [8, 128], Sq or Sk not a multiple of 64, H
// not a multiple of Kv, an empty grid), or -2 where cuTensorMapEncodeTiled
// refuses a tensor map (q, k or v not 16-byte aligned). q, k, v, o are
// device pointers of float (bf16 = 0: the CUDA-core kernel) or
// __nv_bfloat16 (bf16 = 1: the tensor-core kernel); lse is float32
// [B, H, Sq].
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Kv,
                               int Sq, int Sk, int D, int causal, int bf16,
                               float scale, void* stream) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || Sq % kBlockQ != 0 ||
      Sk % kBlockK != 0 || Kv <= 0 || H % Kv != 0 || B * H * Sq <= 0 ||
      Sk <= 0)
    return -1;
  const Dims P{B, H, Kv, Sq, Sk, D, causal, scale};
  return bf16 ? launch_tc(q, k, v, o, lse, P, stream)
              : launch_f32(q, k, v, o, lse, P, stream);
}

// Bytes of dynamic shared memory one tensor-core block asks for with
// `stages` stages (kernels/flash_attention.py::tc_smem_plan states the same
// by part).
int flash_attention_fwd_tc_smem_bytes(int stages) {
  return tc_smem_bytes(stages);
}

// The stages the tensor-core kernel is built with.
int flash_attention_fwd_tc_stages() { return kStages; }

}  // extern "C"
