// Grouped (per-expert) matrix product for Hopper (sm_90a): out[e] = x[e] @
// w[e] for every expert e, in ONE launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:35 gmm (body
// _gmm_kernel :18, pallas_call :45) of the JAX package, and computes what it
// computes: x [E, C, D] and w [E, D, F] upcast to float32, a float32
// accumulator over the contraction dim D, the result cast once to x's type
// (bfloat16 rounds to nearest even). The TPU kernel blocks D in 512s and
// asserts D % 512 == 0 once D > 512; this kernel takes any D that is a
// multiple of 32, so deepseek-moe-16b's down product (D = 1,408) runs.
//
// Layout: x [E, C, D], w [E, D, F], out [E, C, F], contiguous, all of one
// type (float or bfloat16).
//
// What bounds it. One launch at deepseek-moe-16b's serving shapes (E 64, C
// 1,920, D 2,048 -> F 1,408 and D 1,408 -> F 2,048) is 2 E C D F = 7.09e11
// operations on 1.22 GB of bf16 operands and output: against the card's
// bf16 tensor rate (989 TFLOP/s) and 3.35 TB/s it is bound by the operations
// (0.72 ms against 0.36 ms of bytes). This kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s: 10.6 ms), a 15x lower ceiling
// (kernels/gmm.py::work counts both). The products of two bf16 values are
// exact in float32, so moving them onto the tensor cores changes only the
// order of the sums.
//
// Design (simple and right first). One thread block of 256 threads per
// (expert, 64 rows of C, 64 columns of F), the F tiles of one row tile and
// the row tiles of one expert adjacent in launch order so that an expert's
// x and w stay in L2 while its blocks run. The contraction is a loop inside
// the block over chunks of 32 of D (on the TPU a sequential grid axis): the
// x chunk is staged transposed ([d][row], rows padded to 68 so that the
// transposing stores of a warp hit 32 banks) and the w chunk row major, both
// as float32 in dynamic shared memory, beside the float32 accumulator tile
// (33,280 B in all). Each thread owns 4 x 4 outputs per iteration: it reads
// its accumulator from shared memory, adds the chunk's 32 products in order
// with FMAs (16 per two 16-byte loads) and writes it back, so the sum over D
// is one sequential FMA chain per output, bitwise repeatable. Every phase is
// a loop strided by blockDim.x whose iterations write disjoint elements,
// separated by __syncthreads(), so one thread per block computes the same
// (the CPU emulation in the tests runs it so). Not yet: mma/wgmma
// tensor-core products, TMA or cp.async staging, bf16 tiles, overlapping a
// chunk's load with the previous chunk's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockC = 64;   // rows of C per block
constexpr int kBlockF = 64;   // columns of F per block
constexpr int kChunk = 32;    // depth of D staged per iteration
constexpr int kLdX = kBlockC + 4;  // row stride of the transposed x chunk

struct Dims {
  int E, C, D, F;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, Dims P) {
  extern __shared__ float smem[];
  float* xT = smem;                   // [kChunk][kLdX]  x chunk, transposed
  float* ws = xT + kChunk * kLdX;     // [kChunk][kBlockF] w chunk
  float* acc = ws + kChunk * kBlockF; // [kBlockC][kBlockF] float32 sums

  const int nf = P.F / kBlockF, nc = P.C / kBlockC;
  const int fi = blockIdx.x % nf;
  const int ci = (blockIdx.x / nf) % nc;
  const int e = blockIdx.x / (nf * nc);
  const int c0 = ci * kBlockC, f0 = fi * kBlockF;
  const T* xe = x + ((size_t)e * P.C + c0) * P.D;   // row c0 of expert e
  const T* we = w + (size_t)e * P.D * P.F + f0;     // column f0 of expert e

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
      xT[d * kLdX + r] = to_f32(xe[(size_t)r * P.D + d0 + d]);
    }
    for (int i = threadIdx.x; i < kChunk * kBlockF; i += blockDim.x) {
      const int d = i / kBlockF, c = i % kBlockF;
      ws[i] = to_f32(we[(size_t)(d0 + d) * P.F + c]);
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

  T* oe = out + ((size_t)e * P.C + c0) * P.F + f0;
  for (int i = threadIdx.x; i < kBlockC * kBlockF; i += blockDim.x)
    oe[(size_t)(i / kBlockF) * P.F + i % kBlockF] = from_f32<T>(acc[i]);
}

constexpr int smem_floats() {
  return kChunk * kLdX + kChunk * kBlockF + kBlockC * kBlockF;
}

template <typename T>
int launch(const void* x, const void* w, void* o, const Dims& P,
           void* stream) {
  const int n = P.E * (P.C / kBlockC) * (P.F / kBlockF);
  const int smem = (int)(smem_floats() * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gmm_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches out[e] = x[e] @ w[e] on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted), or -1 for dimensions the kernel does not
// take (C or F not a positive multiple of 64, D not a positive multiple of
// 32, E not positive, a grid over 2^31 - 1 blocks). x, w, o are device
// pointers of float (bf16 = 0) or __nv_bfloat16 (bf16 = 1).
int gmm_launch(const void* x, const void* w, void* o, int E, int C, int D,
               int F, int bf16, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || C % kBlockC != 0 ||
      F % kBlockF != 0 || D % kChunk != 0 ||
      (long long)E * (C / kBlockC) * (F / kBlockF) > 2147483647LL)
    return -1;
  const Dims P{E, C, D, F};
  return bf16 ? launch<__nv_bfloat16>(x, w, o, P, stream)
              : launch<float>(x, w, o, P, stream);
}

}  // extern "C"
