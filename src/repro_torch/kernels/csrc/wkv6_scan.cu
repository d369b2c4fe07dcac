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
// that divides S; C a multiple of 4 in [4, 64].
//
// What bounds it. At rwkv6-3b's forward of 4 x 4096 tokens (BH 160, Q = C
// = 64) one launch reads r, k, v (bf16) and logw (float32) and writes y
// and the state: 0.51 GB, 0.15 ms at 3.35 TB/s. The decayed scores cannot
// be one matrix product (the decay depends on t, s and c), so they take
// one exp and four float32 operations per (t, s < t, c): 1.36e9 exps and,
// with scores v, the r S_prev and the state update, 2.04e10 operations in
// all (an exp counted as one), 0.31 ms on the float32 CUDA cores
// (67 TFLOP/s): operations bound it (kernels/wkv6_scan.py::work counts
// both).
//
// Design (simple and right first). One block of 256 threads per bh, the
// chunks a loop inside it (the TPU's sequential grid axis), the [C, C]
// float32 state resident in shared memory. The [Q, Q, C] decay tensor is
// never built (1 MiB in float32 at Q = C = 64): the sum over c runs inside
// the loop that makes each score, 4 x 4 scores per thread. A chunk's r, k,
// logw are staged transposed ([C][Q], so that 4 consecutive steps are one
// float4), v as it lies, all float32 (bf16 -> f32 is exact). The cumsum is
// one thread per channel, in order, each step's sum taken in float64 and the
// running sum rounded to float32 (the plain version sums alike, so the two
// agree bitwise). Rounding the running sum keeps cum - logw equal to the
// previous prefix in most steps, so the decays between near steps, which
// weigh most, come out nearly exact; against the exact recurrence this is
// closer than prefixes summed in float64 and rounded once (PERF.md). Then r
// and k are turned in place into r * exp(cum_prev) and
// k * exp(cum_tot - cum), y is written (the sum over s in ascending order,
// one FMA chain per output), and only after every row of the chunk is done
// does the state update read S_prev. Shared memory per block (csrc plan_of
// = kernels/wkv6_scan.py::smem_plan): 123,392 B at Q = C = 64, so one block
// per SM. Every phase is a loop strided by blockDim.x whose iterations write
// disjoint elements, separated by __syncthreads(), so one thread per block
// computes the same (the CPU emulation in the tests runs it so). Not yet:
// the 160 blocks of the 4 x 4096 forward fill 132 SMs in two waves; a
// two-pass design (the chunk-local states in parallel, then a scan over
// chunks), tensor-core products for scores v and the state terms, and
// cp.async / TMA staging overlapped with the math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, void* y, float* state, const Dims& D,
           void* stream) {
  const int n = D.BH;
  const int smem = (int)(plan_of(D.Q, D.C).total * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_scan_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, static_cast<T*>(y), state, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block uses at chunk Q and head size C
// (kernels/wkv6_scan.py::smem_plan states the same by part).
int wkv6_scan_smem_bytes(int Q, int C) {
  return (int)(plan_of(Q, C).total * sizeof(float));
}

// Launches the scan on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or -1 for dimensions the kernel does not take (a
// chunk outside [1, 64] or not dividing S, C not a multiple of 4 in
// [4, 64]). r, k, v, y are device pointers of float (bf16 = 0) or
// __nv_bfloat16 (bf16 = 1); logw, u, state of float.
int wkv6_scan_launch(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, void* y,
                     float* state, int BH, int S, int C, int Q, int bf16,
                     void* stream) {
  if (!dims_ok(BH, S, C, Q)) return -1;
  const Dims D{BH, S, C, Q};
  return bf16 ? launch<__nv_bfloat16>(r, k, v, logw, u, y, state, D, stream)
              : launch<float>(r, k, v, logw, u, y, state, D, stream);
}

}  // extern "C"
