// Causal GQA flash attention, backward, for Hopper (sm_90a): dq in one
// launch, dk and dv in another, from the forward's out and logsumexp.
//
// Replaces the two Pallas TPU kernels of the JAX package's backward,
// src/repro/kernels/flash_attention.py:202 _flash_bwd:
//   _dq_kernel  (:124, pallas_call :212) -> flash_dq_kernel
//   _dkv_kernel (:160, pallas_call :239) -> flash_dkv_kernel
// and computes what they compute, in their op order:
//   q_s = q * scale (q upcast to float32, scale = 1/sqrt(D) as float32)
//   s   = q_s k^T, -inf where kpos > qpos (causal; absolute positions)
//   p   = exp(s - lse)                 (no renormalization)
//   dp  = do v^T
//   ds  = p * (dp - delta)             (delta = rowsum(do * out), given)
//   dq  = (sum over key tiles of ds k) * scale, cast once to q's type
//   dv  = sum over the group's heads and query tiles of p^T do
//   dk  = sum over the same of (ds^T (q_s / scale)) * scale, the scale
//         applied to each tile's product before it is added
//   dk, dv cast once to k's type.
// causal = 0 drops the mask.
//
// Layout: q, do, dq [B, H, Sq, D]; k, v, dk, dv [B, Kv, Sk, D]; lse, delta
// float32 [B, H, Sq]; all contiguous; query head h reads key/value head
// h / (H / Kv) (GQA), so k and v are never expanded. float or bfloat16 in
// and out, float32 arithmetic inside.
//
// What bounds it. At the training shape of phi4-mini-3.8b (B 2, S 2048,
// 24 query over 8 key/value heads, D 128, bf16, causal) the 100.7M causal
// (query, key) pairs take 10 D operations each in a single-pass backward
// (129 GFLOP, 0.130 ms at the card's 989 TFLOP/s bf16 tensor rate) on
// 110 MB of inputs and outputs (0.033 ms at 3.35 TB/s): bound by the
// operations. This two-kernel design recomputes s in both kernels and dp
// in both (14 D per pair), and runs every product as float32 FMAs on the
// CUDA cores (67 TFLOP/s), a 15x lower ceiling
// (kernels/flash_attention.py::work_bwd counts both).
//
// Design (simple and right first). Blocks run in no order and nothing
// carries between them, so each output tile is owned by one block that
// loops over everything it sums; there are no atomics, and two launches on
// the same inputs are bitwise equal.
//   flash_dq_kernel: one block of 256 threads per (batch row, query head,
//   64 queries), latest queries first; the key/value tiles are a loop
//   inside the block that ends at the diagonal. Shared memory (float32,
//   222,720 B at D 128): q_s and do transposed ([d][row], rows padded to 68
//   so that a warp's transposing stores hit 32 banks), k and v transposed,
//   k row major, ds transposed, the dq accumulator, lse and delta.
//   flash_dkv_kernel: one block per (batch row, key/value head, 64 keys),
//   earliest keys first (they see the most queries); the loop runs over
//   the group's g query heads and, when causal, the query tiles from the
//   diagonal on. Shared memory (220,672 B at D 128): k and v transposed,
//   a [d][row] buffer that holds q_s and then do, a [row][d] buffer that
//   holds do and then q_s / scale, the p / ds tile row major, the dk and dv
//   accumulators, lse and delta.
// Every product runs as 4 x 4 register tiles (16 FMAs per two 16-byte
// loads). Every phase is a loop strided by blockDim.x whose iterations
// write disjoint elements, separated by __syncthreads(), so one thread per
// block computes the same (the CPU emulation in the tests runs it so).
// Not yet: wgmma/mma tensor-core products, TMA or cp.async staging, bf16
// tiles, more than one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 128;
constexpr int kLd = 68;  // row stride of the [d][row] tiles and of p / ds
constexpr int kMaxSmem = 232448;

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

// dst[d * kLd + r] = src[r * D + d] * mul for a [rows, D] tile. A warp's 32
// lanes take 4 rows x 8 columns: 32-byte reads of each row (float32), and
// stores that fall on 32 different banks since kLd % 32 == 4.
template <typename T>
__device__ void load_transposed(float* dst, const T* src, int rows, int D,
                                float mul) {
  const int groups = rows / 4;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int lane = e & 31, rest = e >> 5;
    const int r = (rest % groups) * 4 + (lane & 3);
    const int d = (rest / groups) * 8 + (lane >> 2);
    dst[d * kLd + r] = to_f32(src[(size_t)r * D + d]) * mul;
  }
}

template <typename T>
__device__ void load_rows(float* dst, const T* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = to_f32(src[e]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, Dims P) {
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
    dq[q_base + e] = from_f32<T>(acc[e] * P.scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Dims P) {
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
        Y[e] = __fdiv_rn(to_f32(q[q_base + e]) * P.scale, P.scale);
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
    dk[kv_base + e] = from_f32<T>(dk_acc[e]);
    dv[kv_base + e] = from_f32<T>(dv_acc[e]);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, const Dims& P,
              void* stream) {
  const int n = P.B * P.H * (P.Sq / kBlockQ);
  const int smem = (int)(dq_smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               const Dims& P, void* stream) {
  const int n = P.B * P.Kv * (P.Sk / kBlockK);
  const int smem = (int)(dkv_smem_floats(P.D) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), P);
  return (int)cudaGetLastError();
}

bool takes(int B, int H, int Kv, int Sq, int Sk, int D) {
  return D >= 8 && D <= kMaxD && D % 8 == 0 && Sq % kBlockQ == 0 &&
         Sk % kBlockK == 0 && Kv > 0 && H % Kv == 0 && B * H * Sq > 0 &&
         Sk > 0 && dq_smem_floats(D) * sizeof(float) <= (size_t)kMaxSmem &&
         dkv_smem_floats(D) * sizeof(float) <= (size_t)kMaxSmem;
}

}  // namespace

extern "C" {

// Shared memory in bytes of one block of each kernel at head dim D
// (kernels/flash_attention.py::bwd_smem_plan holds the same numbers).
int flash_attention_bwd_smem_bytes(int D, int which) {
  return (int)((which == 0 ? dq_smem_floats(D) : dkv_smem_floats(D)) *
               sizeof(float));
}

// Launch dq on `stream` and return cudaGetLastError() (0 when the launch
// was accepted), or -1 for dimensions the kernel does not take (D not a
// multiple of 8 in [8, 128], Sq or Sk not a multiple of 64, H not a
// multiple of Kv, an empty grid). q, k, v, dout, dq are device pointers of
// float (bf16 = 0) or __nv_bfloat16 (bf16 = 1); lse and delta are float32
// [B, H, Sq].
int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Kv, int Sq, int Sk, int D, int causal,
                              int bf16, float scale, void* stream) {
  if (!takes(B, H, Kv, Sq, Sk, D)) return -1;
  const Dims P{B, H, Kv, Sq, Sk, D, causal, scale};
  return bf16 ? launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, P,
                                         stream)
              : launch_dq<float>(q, k, v, dout, lse, delta, dq, P, stream);
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
  return bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                          P, stream)
              : launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, P,
                                  stream);
}

}  // extern "C"
