// Grouped (per-expert) matrix product for Hopper (sm_90a): out[e] = x[e] @
// w[e] for every expert e, in ONE launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:35 gmm (body
// _gmm_kernel :18, pallas_call :45) of the JAX package, and computes what it
// computes: x [E, C, D] and w [E, D, F] upcast to float32, a float32
// accumulator over the contraction dim D, the result cast once to x's type
// (bfloat16 rounds to nearest even). The TPU kernel blocks D in 512s and
// asserts D % 512 == 0 once D > 512; this source takes any D that is a
// multiple of 32, so deepseek-moe-16b's down product (D = 1,408) runs.
//
// Layout: x [E, C, D], w [E, D, F], out [E, C, F], contiguous, all of one
// type. Which dtype takes which kernel:
//   bfloat16 -> gmm_tc_kernel: tensor cores (wgmma), tiles staged by TMA.
//               This is what serving runs.
//   float32  -> gmm_kernel: float32 FMAs on the CUDA cores. A tensor-core
//               float32 product would be TF32, which the port never uses.
//
// What bounds it. One launch at deepseek-moe-16b's serving shapes (E 64, C
// 1,920, D 2,048 -> F 1,408 and D 1,408 -> F 2,048) is 2 E C D F = 7.09e11
// operations on 1.22 GB of bf16 operands and output: against the card's
// bf16 tensor rate (989 TFLOP/s) and 3.35 TB/s it is bound by the
// operations (0.72 ms against 0.36 ms of bytes; kernels/gmm.py::work). The
// product of two bf16 values is exact in float32, so the tensor cores
// change only the order of the float32 sums.
//
// bfloat16 design (gmm_tc_kernel). One block of 288 threads per (expert,
// 128 rows of C, 128 columns of F), the F tiles of one row tile and the row
// tiles of one expert adjacent in launch order so that an expert's x and w
// stay in L2 while its blocks run. Not persistent, no split-K, no atomics:
// each output is summed by one block in one order, so two launches agree
// bitwise.
//   - TMA. Three-dimensional tensor maps over x {D, C, E} and w {F, D, E}
//     (innermost first), so a box that runs past an expert's C, D or F is
//     zero-filled inside that expert and never reads the next expert. Each
//     box row is 128 bytes (64 bf16) in the 128-byte swizzle: x comes as a
//     box of 128 rows x 64 depths, w as two boxes of 64 depths x 64
//     columns. The maps are encoded on the host per call by
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters.
//   - A ring of kStages stages (32 KiB each: the x tile, then the two w
//     boxes), each with a "full" and an "empty" mbarrier. Warp 8, the
//     producer, waits for a stage to be empty, arms its full barrier with
//     the stage's bytes and issues the three loads of one 64-deep K step.
//   - Warps 0-3 and 4-7 are two consumer warpgroups, 64 rows x 128 columns
//     each. Per K step a warpgroup waits for "full", issues four
//     wgmma.mma_async m64n128k16 (f32 += bf16 x bf16) reading both
//     operands from shared memory through descriptors, commits them as one
//     group, waits until only that group is in flight, and then releases
//     the previous step's stage (one arrive per warp on "empty"). x is
//     K-major; w [D, F] with F contiguous is MN-major for B and goes in
//     through the transpose-B bit, with no transposed copy. The 64
//     accumulators a thread holds stay in registers.
//   - Epilogue: each thread converts its accumulators to bf16 in the wgmma
//     fragment layout and stores them as pairs; rows >= C and columns >= F
//     of an edge tile are masked.
// Shared memory per block: gmm_smem_bytes (= kernels/gmm.py::smem_plan).
//
// float32 design (gmm_kernel). One block of 256 threads per (expert, 64
// rows, 64 columns); chunks of 32 of D staged as float32 in shared memory
// beside a float32 accumulator tile, one FMA chain per output. Every phase
// is a loop strided by blockDim.x whose iterations write disjoint elements,
// separated by __syncthreads(), so one thread per block computes the same
// (the CPU emulation in the tests runs it so).
//
// Without nvcc (the CPU emulation in the tests), the bfloat16 launcher runs
// a host model of the tensor-core kernel instead: the same blocks, K steps,
// stage offsets, box coordinates, descriptors and epilogue, with TMA's
// zero fill and 128-byte swizzle written out, and each wgmma read through
// its descriptors as the tensor cores address the swizzled layouts. It
// cannot show the PTX, the barriers, the fragment layout or the tensor
// cores' own order of sums; the card's checks do. The TMA, mbarrier,
// descriptor and host-model parts are tma_wgmma.cuh's, shared with
// flash_attention_fwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_wgmma.cuh"

#ifndef __CUDACC__
#include <algorithm>
#include <vector>
#endif

namespace {

using namespace tc;

struct Dims {
  int E, C, D, F;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kBlockC = 64;   // rows of C per block
constexpr int kBlockF = 64;   // columns of F per block
constexpr int kChunk = 32;    // depth of D staged per iteration
constexpr int kLdX = kBlockC + 4;  // row stride of the transposed x chunk

__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, Dims P) {
  extern __shared__ float smem[];
  float* xT = smem;                   // [kChunk][kLdX]  x chunk, transposed
  float* ws = xT + kChunk * kLdX;     // [kChunk][kBlockF] w chunk
  float* acc = ws + kChunk * kBlockF; // [kBlockC][kBlockF] float32 sums

  const int nf = P.F / kBlockF, nc = P.C / kBlockC;
  const int fi = blockIdx.x % nf;
  const int ci = (blockIdx.x / nf) % nc;
  const int e = blockIdx.x / (nf * nc);
  const int c0 = ci * kBlockC, f0 = fi * kBlockF;
  const float* xe = x + ((size_t)e * P.C + c0) * P.D;   // row c0 of expert e
  const float* we = w + (size_t)e * P.D * P.F + f0;     // column f0 of e

  for (int i = threadIdx.x; i < kBlockC * kBlockF; i += blockDim.x)
    acc[i] = 0.f;

  for (int d0 = 0; d0 < P.D; d0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    // x chunk, transposed: a warp's 32 lanes take 4 rows x 8 depths, so
    // the reads are runs of 8 along D and the stores fall on 32 banks
    for (int i = threadIdx.x; i < kBlockC * kChunk; i += blockDim.x) {
      const int lane = i & 31, rest = i >> 5;
      const int r = (rest % (kBlockC / 4)) * 4 + (lane & 3);
      const int d = (rest / (kBlockC / 4)) * 8 + (lane >> 2);
      xT[d * kLdX + r] = xe[(size_t)r * P.D + d0 + d];
    }
    for (int i = threadIdx.x; i < kChunk * kBlockF; i += blockDim.x) {
      const int d = i / kBlockF, c = i % kBlockF;
      ws[i] = we[(size_t)(d0 + d) * P.F + c];
    }
    __syncthreads();

    // acc += x_chunk w_chunk: 4 rows x 4 columns per iteration
    for (int t = threadIdx.x; t < (kBlockC / 4) * (kBlockF / 4);
         t += blockDim.x) {
      const int r0 = (t % (kBlockC / 4)) * 4, n0 = (t / (kBlockC / 4)) * 4;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(acc + (r0 + i) * kBlockF + n0);
        s[i][0] = a.x;
        s[i][1] = a.y;
        s[i][2] = a.z;
        s[i][3] = a.w;
      }
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(xT + d * kLdX + r0);
        const float4 b =
            *reinterpret_cast<const float4*>(ws + d * kBlockF + n0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(acc + (r0 + i) * kBlockF + n0) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
  }
  __syncthreads();

  float* oe = out + ((size_t)e * P.C + c0) * P.F + f0;
  for (int i = threadIdx.x; i < kBlockC * kBlockF; i += blockDim.x)
    oe[(size_t)(i / kBlockF) * P.F + i % kBlockF] = acc[i];
}

constexpr int smem_floats() {
  return kChunk * kLdX + kChunk * kBlockF + kBlockC * kBlockF;
}

int launch_f32(const void* x, const void* w, void* o, const Dims& P,
               void* stream) {
  const int n = P.E * (P.C / kBlockC) * (P.F / kBlockF);
  const int smem = (int)(smem_floats() * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gmm_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(o), P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. What follows up to the CUDA-only part is shared by
// the kernel and the host model.

constexpr int kTcM = 128;             // rows of C per block
constexpr int kTcN = 128;             // columns of F per block
constexpr int kTcK = 64;              // depth of one K step: 128 bytes
constexpr int kWgRows = 64;           // rows per consumer warpgroup
constexpr int kConsumers = kTcM / kWgRows;           // warpgroups
constexpr int kTcThreads = kConsumers * 128 + 32;    // + the producer warp
constexpr int kBoxN = 64;             // columns of one w box: 128 bytes
constexpr int kXTileBytes = kTcM * kRowBytes;        // 16 KiB
constexpr int kWBoxBytes = kTcK * kRowBytes;         // 8 KiB
constexpr int kStageBytes = kXTileBytes + (kTcN / kBoxN) * kWBoxBytes;
constexpr int kStages = 4;
static_assert(kWgRows == kMmaM, "a consumer warpgroup's rows are one wgmma's");

// Bytes of dynamic shared memory a block asks for: slack to align the ring
// to the swizzle atom, the stages, a full and an empty mbarrier per stage.
__host__ __device__ constexpr int tc_smem_bytes(int stages) {
  return kSwizzleAtom + stages * kStageBytes + stages * 2 * 8;
}

// The descriptors of K-slice kk (16 deep) of a stage, for warpgroup wg.
// A, K-major: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO); a
// slice starts 32 bytes further along the row. B, MN-major: depth rows of
// 128 bytes (64 columns), 8-row groups 1,024 apart (SBO), the second
// 64-column box kWBoxBytes further (LBO); a slice starts 16 rows further.
__host__ __device__ inline std::uint64_t a_desc(std::uint32_t stage, int wg,
                                                int kk) {
  return sw128_desc(stage + wg * kWgRows * kRowBytes + kk * kMmaK * 2,
                    16, 8 * kRowBytes);
}
__host__ __device__ inline std::uint64_t b_desc(std::uint32_t stage, int kk) {
  return sw128_desc(stage + kXTileBytes + kk * kMmaK * kRowBytes,
                    kWBoxBytes, 8 * kRowBytes);
}

// The loads of K step kt into a stage: copy(map, smem address, c0, c1, c2)
// with map 0 = x {D, C, E}, 1 = w {F, D, E} and coordinates innermost first.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Copy>
__host__ __device__ inline void stage_loads(const Copy& copy,
                                            std::uint32_t stage, int kt,
                                            int c0, int f0, int e) {
  copy(0, stage, kt * kTcK, c0, e);
#pragma unroll
  for (int j = 0; j < kTcN / kBoxN; ++j)
    copy(1, stage + kXTileBytes + j * kWBoxBytes, f0 + j * kBoxN, kt * kTcK,
         e);
}

// The products of one stage for warpgroup wg: mma(A descriptor, B
// descriptor), one m64n128k16 each.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Mma>
__host__ __device__ inline void stage_mmas(const Mma& mma,
                                           std::uint32_t stage, int wg) {
#pragma unroll
  for (int kk = 0; kk < kTcK / kMmaK; ++kk)
    mma(a_desc(stage, wg, kk), b_desc(stage, kk));
}

// Thread t's accumulators to out as bf16 pairs, for the warpgroup's rows
// row0.. and the block's columns col0..; rows >= C and columns >= F masked.
__host__ __device__ inline void store_fragment(__nv_bfloat16* out,
                                               const Dims& P, int e, int row0,
                                               int col0, int t,
                                               const float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 + frag_row(t, i), col = col0 + frag_col(t, i);
    if (row < P.C && col < P.F)
      store_pair(out + ((size_t)e * P.C + row) * P.F + col, acc[i],
                 acc[i + 1]);
  }
}

MapSpec map_spec(int map, const Dims& P) {
  if (map == 0)
    return {{(std::uint64_t)P.D, (std::uint64_t)P.C, (std::uint64_t)P.E},
            {(std::uint64_t)P.D * 2, (std::uint64_t)P.C * P.D * 2},
            {(std::uint32_t)kTcK, (std::uint32_t)kTcM, 1}};
  return {{(std::uint64_t)P.F, (std::uint64_t)P.D, (std::uint64_t)P.E},
          {(std::uint64_t)P.F * 2, (std::uint64_t)P.D * P.F * 2},
          {(std::uint32_t)kBoxN, (std::uint32_t)kTcK, 1}};
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kTcThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              __nv_bfloat16* __restrict__ out, Dims P) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  // the ring, aligned to the swizzle atom; then the barriers
  const std::uint32_t ring = (smem_u32(tc_smem) + kSwizzleAtom - 1) &
                             ~(std::uint32_t)(kSwizzleAtom - 1);
  const std::uint32_t full = ring + kStages * kStageBytes;
  const std::uint32_t empty = full + kStages * 8;

  const int nf = cdiv(P.F, kTcN), nc = cdiv(P.C, kTcM);
  const int fi = blockIdx.x % nf;
  const int ci = (blockIdx.x / nf) % nc;
  const int e = blockIdx.x / (nf * nc);
  const int c0 = ci * kTcM, f0 = fi * kTcN;
  const int nk = cdiv(P.D, kTcK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's arm
      mbar_init(empty + 8 * s, kConsumers * 4);      // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      const std::uint64_t maps[2] = {reinterpret_cast<std::uint64_t>(&xmap),
                                     reinterpret_cast<std::uint64_t>(&wmap)};
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps[0]) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps[1]) : "memory");
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        const std::uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, kStageBytes);
        stage_loads(
            [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
              tma_load_3d(dst, maps[map], bar, x0, x1, x2);
            },
            ring + s * kStageBytes, kt, c0, f0, e);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows x 128 columns
  const int wg = warp / 4, t = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    stage_mmas(
        [&](std::uint64_t da, std::uint64_t db) {
          wgmma_m64n128k16_ss<1>(acc, da, db, 1);  // B MN-major
        },
        ring + s * kStageBytes, wg);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the previous step's products are done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(acc);
  store_fragment(out, P, e, c0 + wg * kWgRows, f0, t, acc);
}

int launch_tc(const void* x, const void* w, void* o, const Dims& P,
              void* stream) {
  CUtensorMap xmap, wmap;
  int err = encode_map(&xmap, map_spec(0, P), x);
  if (err == 0) err = encode_map(&wmap, map_spec(1, P), w);
  if (err != 0) return err;
  const int n = P.E * cdiv(P.C, kTcM) * cdiv(P.F, kTcN);
  const int smem = tc_smem_bytes(kStages);
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gmm_tc_kernel<<<n, kTcThreads, smem, (cudaStream_t)stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(o), P);
  return (int)cudaGetLastError();
}

#else  // the host model of gmm_tc_kernel

// One wgmma m64n128k16 with A K-major and B MN-major, both read through
// their descriptors (SmemModel::read_a, read_b), summed into acc in k order.
void model_mma(SmemModel& model, std::uint64_t da, std::uint64_t db,
               float (*acc)[kTcN]) {
  float A[kWgRows][kMmaK], B[kMmaK * kTcN];
  if (!model.read_a(da, A) || !model.read_b(db, 1, kTcN, B)) return;
  for (int m = 0; m < kWgRows; ++m)
    for (int n = 0; n < kTcN; ++n) {
      float s = acc[m][n];
      for (int k = 0; k < kMmaK; ++k) s += A[m][k] * B[k * kTcN + n];
      acc[m][n] = s;
    }
}

int launch_tc(const void* x, const void* w, void* o, const Dims& P, void*) {
  SmemModel model;
  model.smem.assign(tc_smem_bytes(kStages) - kSwizzleAtom, 0);
  const MapSpec maps[2] = {map_spec(0, P), map_spec(1, P)};
  const void* srcs[2] = {x, w};
  const int nf = cdiv(P.F, kTcN), nc = cdiv(P.C, kTcM);
  const int nk = cdiv(P.D, kTcK);
  std::vector<float> tiles(kConsumers * kWgRows * kTcN);
  for (int b = 0; b < P.E * nc * nf; ++b) {
    const int fi = b % nf, ci = (b / nf) % nc, e = b / (nf * nc);
    const int c0 = ci * kTcM, f0 = fi * kTcN;
    std::fill(tiles.begin(), tiles.end(), 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      const std::uint32_t stage = (kt % kStages) * kStageBytes;
      stage_loads(
          [&](int map, std::uint32_t dst, int x0, int x1, int x2) {
            model.copy(maps[map], srcs[map], dst, x0, x1, x2);
          },
          stage, kt, c0, f0, e);
      for (int wg = 0; wg < kConsumers; ++wg)
        stage_mmas(
            [&](std::uint64_t da, std::uint64_t db) {
              model_mma(model, da, db, reinterpret_cast<float(*)[kTcN]>(
                                           &tiles[wg * kWgRows * kTcN]));
            },
            stage, wg);
    }
    for (int wg = 0; wg < kConsumers; ++wg)
      for (int t = 0; t < 128; ++t) {
        float acc[64];
        for (int i = 0; i < 64; ++i)
          acc[i] = tiles[(wg * kWgRows + frag_row(t, i)) * kTcN +
                         frag_col(t, i)];
        store_fragment(static_cast<__nv_bfloat16*>(o), P, e,
                       c0 + wg * kWgRows, f0, t, acc);
      }
  }
  return model.ok ? 0 : -3;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// Launches out[e] = x[e] @ w[e] on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted), or -1 for dimensions the kernels do not
// take (C or F not a positive multiple of 64, D not a positive multiple of
// 32, E not positive, a grid over 2^31 - 1 blocks), or -2 where
// cuTensorMapEncodeTiled refuses a tensor map (x or w not 16-byte
// aligned). x, w, o are device pointers of float (bf16 = 0: the CUDA-core
// kernel) or __nv_bfloat16 (bf16 = 1: the tensor-core kernel).
int gmm_launch(const void* x, const void* w, void* o, int E, int C, int D,
               int F, int bf16, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || C % kBlockC != 0 ||
      F % kBlockF != 0 || D % kChunk != 0 ||
      (long long)E * (C / kBlockC) * (F / kBlockF) > 2147483647LL)
    return -1;
  const Dims P{E, C, D, F};
  return bf16 ? launch_tc(x, w, o, P, stream)
              : launch_f32(x, w, o, P, stream);
}

// Bytes of dynamic shared memory one tensor-core block asks for with
// `stages` stages (kernels/gmm.py::smem_plan states the same by part).
int gmm_smem_bytes(int stages) { return tc_smem_bytes(stages); }

// The stages the tensor-core kernel is built with.
int gmm_stages() { return kStages; }

}  // extern "C"
