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
// h reads key/value head h / (H / Kv) (GQA). float or bfloat16 in and out,
// float32 arithmetic inside.
//
// What bounds it. Causal attention at the serving shapes does 2 B H S^2 D
// operations (S(S+1)/2 query-key pairs, 4 D each) on 2 B (H + Kv) S D
// elements: at B 4, S 512, H 32, Kv 4, D 128 in bf16 that is 8.6 GFLOP on
// 38 MB, at B 1, S 4096 137 GFLOP on 76 MB. Against the card's bf16 tensor
// rate (989 TFLOP/s) and 3.35 TB/s the first is bound by the bytes (11 us),
// the second by the operations (139 us); this kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s), a 15x lower ceiling
// (kernels/flash_attention.py::work counts both).
//
// Design (simple and right first). One thread block of 256 threads per
// (batch row, head, block of 64 queries), blocks of late queries first so
// that the longest causal rows start first. The key/value tiles are a loop
// inside the block (on the TPU a sequential grid axis); the causal loop ends
// at the diagonal tile. Tiles live in dynamic shared memory as float32
// (153,600 B at D = 128): q times scale and k transposed ([d][row], rows
// padded to 68 so that the transposing stores of a warp hit 32 banks), v row
// major, the score tile transposed, the accumulator, and m, l per row. Each
// product runs as 4 x 4 register tiles (16 FMAs per two 16-byte loads).
// Every phase is a loop strided by blockDim.x whose iterations write
// disjoint elements, separated by __syncthreads(), so one thread per block
// computes the same (the CPU emulation in the tests runs it so). Not yet:
// wgmma/mma tensor-core products, TMA or cp.async staging, bf16 tiles,
// overlapping a tile's load with the previous tile's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 128;
constexpr int kLdQ = kBlockQ + 4;  // row stride of the transposed q / p tiles
constexpr int kLdK = kBlockK + 4;  // row stride of the transposed k tile

struct Dims {
  int B, H, Kv, Sq, Sk, D, causal;
  float scale;
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
  return __float2bfloat16(x);
}

// isfinite without the library's overloads: false for +-inf and NaN.
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

// dst[d * ld + r] = src[r * D + d] * mul for a [rows, D] tile. A warp's 32
// lanes take 4 rows x 8 columns: 32-byte reads of each row (float32), and
// stores that fall on 32 different banks since ld % 32 == 4.
template <typename T>
__device__ void load_transposed(float* dst, const T* src, int rows, int D,
                                int ld, float mul) {
  const int groups = rows / 4;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int lane = e & 31, rest = e >> 5;
    const int r = (rest % groups) * 4 + (lane & 3);
    const int d = (rest / groups) * 8 + (lane >> 2);
    dst[d * ld + r] = to_f32(src[(size_t)r * D + d]) * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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
      vs[e] = to_f32(v[kv_base + (size_t)k0 * D + e]);
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
    out[q_base + e] = from_f32<T>(acc[e] / fmaxf(l[e / D], 1e-30f));
  for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x)
    lse[(size_t)bh * P.Sq + q0 + r] =
        finite(m[r]) ? m[r] + logf(fmaxf(l[r], 1e-30f)) : 0.f;
}

size_t smem_floats(int D) {
  return (size_t)D * kLdQ + (size_t)D * kLdK + (size_t)kBlockK * D +
         (size_t)kBlockK * kLdQ + (size_t)kBlockQ * D + 4 * kBlockQ;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Dims& P, void* stream) {
  const int n = P.B * P.H * (P.Sq / kBlockQ);
  const int smem = (int)(smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns cudaGetLastError() (0
// when the launch was accepted), or -1 for dimensions the kernel does not
// take (D not a multiple of 8 in [8, 128], Sq or Sk not a multiple of 64, H
// not a multiple of Kv, an empty grid). q, k, v, o are device pointers of
// float (bf16 = 0) or __nv_bfloat16 (bf16 = 1); lse is float32 [B, H, Sq].
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Kv,
                               int Sq, int Sk, int D, int causal, int bf16,
                               float scale, void* stream) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || Sq % kBlockQ != 0 ||
      Sk % kBlockK != 0 || Kv <= 0 || H % Kv != 0 || B * H * Sq <= 0 ||
      Sk <= 0)
    return -1;
  const Dims P{B, H, Kv, Sq, Sk, D, causal, scale};
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, lse, P, stream)
              : launch<float>(q, k, v, o, lse, P, stream);
}

}  // extern "C"
