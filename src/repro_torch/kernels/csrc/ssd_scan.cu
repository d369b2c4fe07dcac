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
// multiples of 4 in [4, 64].
//
// What bounds it. At zamba2-7b's prefill of 4 x 4096 tokens (BH 448, Q 256,
// N = P = 64) one launch needs 448 x 16 chunks x 6,307,840 multiply-adds
// (the lower triangle of the two [Q, Q] products, C S_prev and
// B^T (x w)) = 9.0e10 operations on 489 MB of bf16 x and y (plus dt, B, C
// and the float32 state): 0.146 ms of bytes at 3.35 TB/s against 0.091 ms
// of bf16 tensor-core operations, so bytes bound it. This kernel does its
// products with float32 FMAs on the CUDA cores (67 TFLOP/s: 1.35 ms), a 9x
// lower ceiling (kernels/ssd_scan.py::work counts both).
//
// Design (simple and right first). One block of 256 threads per bh, the
// chunks a loop inside it (the TPU's sequential grid axis), the [N, P]
// float32 state resident in shared memory. The [Q, Q] score tile is never
// built: at Q 256 it would take 262,144 B, over the 232,448 B a block may
// use. A chunk's x and B^T are staged once as float32 (bf16 -> f32 is
// exact), then its rows are taken in sub-tiles of 64: C of the sub-tile is
// staged transposed, and for each column sub-tile at or left of the
// diagonal the scores of the 64 x 64 pair are computed into shared memory
// and folded into a float32 y accumulator, so that the sum over s runs
// in ascending order, one FMA chain per output. C S_prev and the write of
// y follow; all rows of a chunk are done before the state update, which
// reads S_prev. The cumsum is one thread's sequential prefix, summed in
// float64 and rounded once per step (XLA's float32 cumsum has an order of
// its own; this one is the closest to the exact sums, and the plain
// version's float64 cumsum rounds to the same values).
// Shared memory per block (csrc plan_of = kernels/ssd_scan.py::smem_plan):
// 203,776 B at Q 256, N = P = 64, so one block per SM. Every phase is a
// loop strided by blockDim.x whose iterations write disjoint elements,
// separated by __syncthreads(), so one thread per block computes the same
// (the CPU emulation in the tests runs it so). Not yet: tensor-core
// products (mma.sync / wgmma from bf16 tiles), a two-pass design (the
// chunk-local states in parallel, then a scan over chunks) to fill the
// 132 SMs, cp.async / TMA staging overlapped with the math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
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
  const T* xh = x + (size_t)bh * D.S * P;
  const float* dth = dt + (size_t)bh * D.S;
  const T* Bb = Bm + (size_t)(bh / D.heads) * D.S * N;
  const T* Cb = Cm + (size_t)(bh / D.heads) * D.S * N;
  T* yh = y + (size_t)bh * D.S * P;
  const int np4 = P / 4, nn4 = N / 4;

  for (int e = threadIdx.x; e < N * P; e += blockDim.x) S[e] = 0.f;

  for (int base = 0; base < D.S; base += Q) {
    __syncthreads();  // the previous chunk's state update is done
    // stage x and B^T of the chunk as float32, zero past Q; a warp's 32
    // lanes take 8 steps x 4 state dims of B, so the transposing stores
    // fall on 32 banks (ldb = 8 mod 32)
    for (int e = threadIdx.x; e < Qp * P; e += blockDim.x) {
      const int s = e / P;
      xs[e] = s < Q ? to_f32(xh[(size_t)(base + s) * P + e % P]) : 0.f;
    }
    for (int e = threadIdx.x; e < Qp * N; e += blockDim.x) {
      const int lane = e & 31, rest = e >> 5;
      const int n = (rest % nn4) * 4 + (lane & 3);
      const int s = (rest / nn4) * 8 + (lane >> 2);
      bt[n * ldb + s] = s < Q ? to_f32(Bb[(size_t)(base + s) * N + n]) : 0.f;
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
            r0 + t < Q ? to_f32(Cb[(size_t)(base + r0 + t) * N + n]) : 0.f;
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
          T* row = yh + (size_t)(base + t) * P + p0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            row[k] = from_f32<T>(__fadd_rn(yacc[(i0 + i) * P + p0 + k],
                                           __fmul_rn(acc[i][k], decay)));
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

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, const Dims& D,
           void* stream) {
  const int n = D.BH;
  const int smem = (int)(plan_of(D.Q, D.N, D.P).total * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block uses at chunk Q and dims N, P
// (kernels/ssd_scan.py::smem_plan states the same by part).
int ssd_scan_smem_bytes(int Q, int N, int P) {
  return (int)(plan_of(Q, N, P).total * sizeof(float));
}

// Launches the scan on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or -1 for dimensions the kernel does not take (a
// chunk outside [1, 256] or not dividing S, N or P not a multiple of 4 in
// [4, 64], BH not a positive multiple of heads). x, Bm, Cm, y are device
// pointers of float (bf16 = 0) or __nv_bfloat16 (bf16 = 1); dt, A, state
// of float.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, void* y, float* state,
                    int BH, int S, int P, int N, int Q, int heads, int bf16,
                    void* stream) {
  if (!dims_ok(BH, S, P, N, Q, heads)) return -1;
  const Dims D{BH, S, P, N, Q, heads};
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, D, stream)
              : launch<float>(x, dt, A, Bm, Cm, y, state, D, stream);
}

}  // extern "C"
