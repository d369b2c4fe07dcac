// The fused DDPG inner loop for Hopper (sm_90a): all U sequential updates of
// every tuning session in ONE launch.
//
// Replaces the Pallas TPU kernel kernels/ddpg_fused.py::ddpg_fused_learn
// (body _ddpg_kernel, step packed_update, _adam) of the JAX package. It
// computes, for each of N sessions, the U updates of core/ddpg.py::_ddpg_step
// in the reference's order:
//   1. target actor on s2, target critic on [s2, a2]  ->  y = r + gamma Q'
//   2. critic forward on [s, a], MSE backward (dq = 2 (q - y) / B), Adam
//   3. actor forward on s, sigmoid, the UPDATED critic on [s, mu]; backward
//      dmu = -(1/B) dQ/dx[k:k+m], times mu (1 - mu), through the actor; Adam
//   4. Polyak with tau on both targets
//   5. q_mean from the updated critic on (s, a)
//   6. Adam counts +1 per update on each network
//
// Layout. The learner state of a session is one float32 row of `floats`
// values at the REAL layer sizes (no [P, P] padding, which was a TPU tiling
// artefact): eight parameter sets (actor, critic, actor_targ, critic_targ,
// actor_mu, actor_nu, critic_mu, critic_nu), three layers each, every layer
// stored as w [fan_in, fan_out] row-major then b [fan_out]. The offset table
// is computed in Python (core/ddpg.py::state_layout) and passed by value.
// Counts are int32 [N, 2] (actor, critic). Minibatches arrive pre-gathered:
// s, s2 [N, U, B, k], a [N, U, B, m], r [N, U, B]. Metrics out: [N, U, 3]
// (critic_loss, actor_loss, q_mean). The state is updated IN PLACE.
//
// What bounds it. Per session-update the work is ~1.85 MFLOP of small dense
// products (B = 16 rows, widths 12..64) plus the Adam/Polyak sweep over
// ~10k parameters, on ~170 KB of state: at N = 1024 the bound is the f32
// operation rate (kernels/ddpg_learn.py::work counts it), not the bytes.
// Each update depends on the previous one, so the U loop runs inside the
// block and nothing is launched per update.
//
// Design (simple and right first): one thread block per session, grid (N,);
// activations and deltas of the current minibatch live in shared memory
// (< 48 KB for the repo's configurations); weights and Adam moments stay in
// device memory and are read through L1/L2. Every sum runs in a fixed order
// with no atomics, so two launches on the same inputs are bitwise equal.
// Elementwise Adam/Polyak arithmetic uses the _rn intrinsics, which the
// compiler never contracts into FMAs, so it rounds exactly like the
// reference's op order (optim/adam.py). Making it fast (shared-memory
// residency of the state, cp.async/TMA streaming of minibatches, tensor
// cores) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSets = 8;
constexpr int kLayers = 3;
constexpr int kThreads = 256;

enum { ACTOR = 0, CRITIC, ACTOR_T, CRITIC_T, ACTOR_MU, ACTOR_NU, CRITIC_MU,
       CRITIC_NU };

struct Layout {
  int off[kSets * kLayers * 2];  // [set][layer][w, b]
};

struct Hyper {
  float gamma, tau, one_minus_tau, b1, one_minus_b1, b2, one_minus_b2, eps,
      neg_actor_lr, neg_critic_lr;
};

struct Dims {
  int u, b, k, m, h1, h2, floats;
};

struct Net {
  float* w[kLayers];
  float* b[kLayers];
};

__device__ Net net_at(float* base, const Layout& L, int set) {
  Net n;
  for (int l = 0; l < kLayers; ++l) {
    n.w[l] = base + L.off[(set * kLayers + l) * 2];
    n.b[l] = base + L.off[(set * kLayers + l) * 2 + 1];
  }
  return n;
}

// out[r][j] = act(sum_i in[r][i] * w[i][j] + bias[j]) for r < rows, j < nout.
// act: 0 none, 1 relu, 2 sigmoid. The dot product accumulates in i order
// with FMAs; the bias is added after it, as in x @ w + b.
__device__ void dense(const float* in, int ld_in, int nin, const float* w,
                      const float* bias, int nout, float* out, int ld_out,
                      int rows, int act) {
  for (int e = threadIdx.x; e < rows * nout; e += blockDim.x) {
    const int r = e / nout, j = e - r * nout;
    const float* x = in + r * ld_in;
    float acc = 0.f;
    for (int i = 0; i < nin; ++i) acc = fmaf(x[i], w[i * nout + j], acc);
    float v = __fadd_rn(acc, bias[j]);
    if (act == 1) v = v > 0.f ? v : 0.f;
    if (act == 2) v = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
    out[r * ld_out + j] = v;
  }
}

// delta_in[r][i] = mask(h[r][i] > 0) * sum_j delta[r][j] * w[i][j]: the
// backward of x @ w through a ReLU (gradient 0 at exactly 0, as jax.nn.relu).
__device__ void back_relu(const float* delta, int nout, const float* w,
                          const float* h, int nin, float* delta_in, int rows) {
  for (int e = threadIdx.x; e < rows * nin; e += blockDim.x) {
    const int r = e / nin, i = e - r * nin;
    float acc = 0.f;
    const float* d = delta + r * nout;
    const float* wi = w + i * nout;
    for (int j = 0; j < nout; ++j) acc = fmaf(d[j], wi[j], acc);
    delta_in[e] = h[e] > 0.f ? acc : 0.f;
  }
}

struct AdamStep {
  float c1, c2, neg_lr;
};

__device__ AdamStep adam_step(const Hyper& H, int count, float neg_lr) {
  // c = 1 - b^count in float32; the power is rounded once from double.
  AdamStep a;
  a.c1 = __fsub_rn(1.f, (float)pow((double)H.b1, (double)count));
  a.c2 = __fsub_rn(1.f, (float)pow((double)H.b2, (double)count));
  a.neg_lr = neg_lr;
  return a;
}

// One Adam step on parameter p (moments m, v) with gradient g, then the
// Polyak update of its target t, in the reference's op order.
__device__ void adam_polyak(const Hyper& H, const AdamStep& A, float g,
                            float* p, float* m, float* v, float* t) {
  const float mu = __fadd_rn(__fmul_rn(H.b1, *m), __fmul_rn(H.one_minus_b1, g));
  const float nu = __fadd_rn(__fmul_rn(H.b2, *v),
                             __fmul_rn(H.one_minus_b2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(
      __fdiv_rn(mu, A.c1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, A.c2)), H.eps));
  const float w = __fadd_rn(*p, __fmul_rn(upd, A.neg_lr));
  *m = mu;
  *v = nu;
  *p = w;
  *t = __fadd_rn(__fmul_rn(H.one_minus_tau, *t), __fmul_rn(H.tau, w));
}

// Gradient of one layer (w [nin, nout], b [nout]) from its input rows `in`
// and output deltas `delta` — g_w[i][j] = sum_r in[r][i] delta[r][j],
// g_b[j] = sum_r delta[r][j], rows in order — fused with Adam and Polyak.
__device__ void layer_update(const Hyper& H, const AdamStep& A,
                             const float* in, int ld_in, int nin,
                             const float* delta, int nout, int rows,
                             const Net& P, const Net& M, const Net& V,
                             const Net& T, int l) {
  for (int e = threadIdx.x; e < nin * nout; e += blockDim.x) {
    const int i = e / nout, j = e - i * nout;
    float g = 0.f;
    for (int r = 0; r < rows; ++r)
      g = fmaf(in[r * ld_in + i], delta[r * nout + j], g);
    adam_polyak(H, A, g, P.w[l] + e, M.w[l] + e, V.w[l] + e, T.w[l] + e);
  }
  for (int j = threadIdx.x; j < nout; j += blockDim.x) {
    float g = 0.f;
    for (int r = 0; r < rows; ++r) g = __fadd_rn(g, delta[r * nout + j]);
    adam_polyak(H, A, g, P.b[l] + j, M.b[l] + j, V.b[l] + j, T.b[l] + j);
  }
}

__device__ float row_mean(const float* x, int rows) {
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, x[r]);
  return __fdiv_rn(acc, (float)rows);
}

__global__ void __launch_bounds__(kThreads)
ddpg_learn_kernel(float* __restrict__ state, int* __restrict__ counts,
                  const float* __restrict__ s_all,
                  const float* __restrict__ a_all,
                  const float* __restrict__ r_all,
                  const float* __restrict__ s2_all,
                  float* __restrict__ metrics, Dims D, Layout L, Hyper H) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int B = D.b, k = D.k, m = D.m, h1 = D.h1, h2 = D.h2, kc = k + m;

  float* xc = smem;            // [B, kc]  critic input (s, a)
  float* xt = xc + B * kc;     // [B, kc]  (s2, a2), later (s, mu)
  float* ha1 = xt + B * kc;    // [B, h1]
  float* ha2 = ha1 + B * h1;   // [B, h2]
  float* hb1 = ha2 + B * h2;   // [B, h1]
  float* hb2 = hb1 + B * h1;   // [B, h2]
  float* d1 = hb2 + B * h2;    // [B, h1]
  float* d2 = d1 + B * h1;     // [B, h2]
  float* e1 = d2 + B * h2;     // [B, h1]
  float* e2 = e1 + B * h1;     // [B, h2]
  float* mu = e2 + B * h2;     // [B, m]
  float* dz = mu + B * m;      // [B, m]
  float* q = dz + B * m;       // [B]
  float* y = q + B;            // [B]
  float* dq = y + B;           // [B]
  float* stat = dq + B;        // [3]

  float* base = state + (size_t)n * D.floats;
  const Net actor = net_at(base, L, ACTOR), critic = net_at(base, L, CRITIC);
  const Net actor_t = net_at(base, L, ACTOR_T);
  const Net critic_t = net_at(base, L, CRITIC_T);
  const Net actor_m = net_at(base, L, ACTOR_MU);
  const Net actor_v = net_at(base, L, ACTOR_NU);
  const Net critic_m = net_at(base, L, CRITIC_MU);
  const Net critic_v = net_at(base, L, CRITIC_NU);
  const int actor_count0 = counts[2 * n], critic_count0 = counts[2 * n + 1];

  for (int u = 0; u < D.u; ++u) {
    const size_t row0 = ((size_t)n * D.u + u) * B;
    const float* s = s_all + row0 * k;
    const float* a = a_all + row0 * m;
    const float* s2 = s2_all + row0 * k;
    for (int e = threadIdx.x; e < B * kc; e += blockDim.x) {
      const int r = e / kc, c = e - r * kc;
      xc[e] = c < k ? s[r * k + c] : a[r * m + c - k];
      if (c < k) xt[e] = s2[r * k + c];
    }
    for (int r = threadIdx.x; r < B; r += blockDim.x) y[r] = r_all[row0 + r];
    __syncthreads();

    // --- 1. Bellman target from the frozen target networks --------------
    dense(xt, kc, k, actor_t.w[0], actor_t.b[0], h1, ha1, h1, B, 1);
    __syncthreads();
    dense(ha1, h1, h1, actor_t.w[1], actor_t.b[1], h2, ha2, h2, B, 1);
    __syncthreads();
    dense(ha2, h2, h2, actor_t.w[2], actor_t.b[2], m, xt + k, kc, B, 2);
    __syncthreads();
    dense(xt, kc, kc, critic_t.w[0], critic_t.b[0], h1, ha1, h1, B, 1);
    __syncthreads();
    dense(ha1, h1, h1, critic_t.w[1], critic_t.b[1], h2, ha2, h2, B, 1);
    __syncthreads();
    dense(ha2, h2, h2, critic_t.w[2], critic_t.b[2], 1, q, 1, B, 0);
    __syncthreads();
    for (int r = threadIdx.x; r < B; r += blockDim.x)
      y[r] = __fadd_rn(y[r], __fmul_rn(H.gamma, q[r]));

    // --- 2. critic regression + Adam ------------------------------------
    dense(xc, kc, kc, critic.w[0], critic.b[0], h1, hb1, h1, B, 1);
    __syncthreads();
    dense(hb1, h1, h1, critic.w[1], critic.b[1], h2, hb2, h2, B, 1);
    __syncthreads();
    dense(hb2, h2, h2, critic.w[2], critic.b[2], 1, q, 1, B, 0);
    __syncthreads();
    for (int r = threadIdx.x; r < B; r += blockDim.x) {
      const float diff = __fsub_rn(q[r], y[r]);
      q[r] = __fmul_rn(diff, diff);
      dq[r] = __fdiv_rn(__fmul_rn(2.f, diff), (float)B);
    }
    __syncthreads();
    if (threadIdx.x == 0) stat[0] = row_mean(q, B);
    for (int e = threadIdx.x; e < B * h2; e += blockDim.x) {
      const int r = e / h2, i = e - r * h2;
      d2[e] = hb2[e] > 0.f ? __fmul_rn(dq[r], critic.w[2][i]) : 0.f;
    }
    __syncthreads();
    back_relu(d2, h2, critic.w[1], hb1, h1, d1, B);
    __syncthreads();
    {
      const AdamStep A = adam_step(H, critic_count0 + u + 1, H.neg_critic_lr);
      layer_update(H, A, hb2, h2, h2, dq, 1, B, critic, critic_m, critic_v,
                   critic_t, 2);
      layer_update(H, A, hb1, h1, h1, d2, h2, B, critic, critic_m, critic_v,
                   critic_t, 1);
      layer_update(H, A, xc, kc, kc, d1, h1, B, critic, critic_m, critic_v,
                   critic_t, 0);
    }
    __syncthreads();

    // --- 3. actor ascent through the UPDATED critic + Adam ---------------
    for (int e = threadIdx.x; e < B * k; e += blockDim.x) {
      const int r = e / k, c = e - r * k;
      xt[r * kc + c] = xc[r * kc + c];
    }
    dense(xc, kc, k, actor.w[0], actor.b[0], h1, ha1, h1, B, 1);
    __syncthreads();
    dense(ha1, h1, h1, actor.w[1], actor.b[1], h2, ha2, h2, B, 1);
    __syncthreads();
    dense(ha2, h2, h2, actor.w[2], actor.b[2], m, mu, m, B, 2);
    __syncthreads();
    for (int e = threadIdx.x; e < B * m; e += blockDim.x) {
      const int r = e / m, c = e - r * m;
      xt[r * kc + k + c] = mu[e];
    }
    __syncthreads();
    dense(xt, kc, kc, critic.w[0], critic.b[0], h1, hb1, h1, B, 1);
    __syncthreads();
    dense(hb1, h1, h1, critic.w[1], critic.b[1], h2, hb2, h2, B, 1);
    __syncthreads();
    dense(hb2, h2, h2, critic.w[2], critic.b[2], 1, q, 1, B, 0);
    __syncthreads();
    if (threadIdx.x == 0) stat[1] = -row_mean(q, B);
    {
      const float dq_actor = __fdiv_rn(-1.f, (float)B);
      for (int e = threadIdx.x; e < B * h2; e += blockDim.x) {
        const int i = e % h2;
        d2[e] = hb2[e] > 0.f ? __fmul_rn(dq_actor, critic.w[2][i]) : 0.f;
      }
    }
    __syncthreads();
    back_relu(d2, h2, critic.w[1], hb1, h1, d1, B);
    __syncthreads();
    for (int e = threadIdx.x; e < B * m; e += blockDim.x) {
      // dQ/d(action column c) through critic layer 0, then the sigmoid.
      const int r = e / m, c = e - r * m;
      const float* w0 = critic.w[0] + (k + c) * h1;
      float acc = 0.f;
      for (int j = 0; j < h1; ++j) acc = fmaf(d1[r * h1 + j], w0[j], acc);
      const float a_ = mu[e];
      dz[e] = __fmul_rn(acc, __fmul_rn(a_, __fsub_rn(1.f, a_)));
    }
    __syncthreads();
    back_relu(dz, m, actor.w[2], ha2, h2, e2, B);
    __syncthreads();
    back_relu(e2, h2, actor.w[1], ha1, h1, e1, B);
    __syncthreads();
    {
      const AdamStep A = adam_step(H, actor_count0 + u + 1, H.neg_actor_lr);
      layer_update(H, A, ha2, h2, h2, dz, m, B, actor, actor_m, actor_v,
                   actor_t, 2);
      layer_update(H, A, ha1, h1, h1, e2, h2, B, actor, actor_m, actor_v,
                   actor_t, 1);
      layer_update(H, A, xc, kc, k, e1, h1, B, actor, actor_m, actor_v,
                   actor_t, 0);
    }
    __syncthreads();

    // --- 5. q_mean from the updated critic on (s, a) ---------------------
    dense(xc, kc, kc, critic.w[0], critic.b[0], h1, hb1, h1, B, 1);
    __syncthreads();
    dense(hb1, h1, h1, critic.w[1], critic.b[1], h2, hb2, h2, B, 1);
    __syncthreads();
    dense(hb2, h2, h2, critic.w[2], critic.b[2], 1, q, 1, B, 0);
    __syncthreads();
    if (threadIdx.x == 0) {
      float* out = metrics + ((size_t)n * D.u + u) * 3;
      out[0] = stat[0];
      out[1] = stat[1];
      out[2] = row_mean(q, B);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[2 * n] = actor_count0 + D.u;
    counts[2 * n + 1] = critic_count0 + D.u;
  }
}

size_t smem_bytes(const Dims& D) {
  const int kc = D.k + D.m;
  return sizeof(float) * ((size_t)2 * D.b * kc + 4 * D.b * (D.h1 + D.h2) +
                          2 * D.b * D.m + 3 * D.b + 3);
}

}  // namespace

extern "C" {

// Launches the learner on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers; `offsets` (48
// ints) and `hyper` (10 floats) are host arrays copied into the launch.
int ddpg_learn_launch(float* state, int* counts, const float* s,
                      const float* a, const float* r, const float* s2,
                      float* metrics, const int* offsets, const float* hyper,
                      int n, int u, int b, int k, int m, int h1, int h2,
                      int floats, void* stream) {
  Layout L;
  for (int i = 0; i < kSets * kLayers * 2; ++i) L.off[i] = offsets[i];
  Hyper H;
  H.gamma = hyper[0];
  H.tau = hyper[1];
  H.one_minus_tau = hyper[2];
  H.b1 = hyper[3];
  H.one_minus_b1 = hyper[4];
  H.b2 = hyper[5];
  H.one_minus_b2 = hyper[6];
  H.eps = hyper[7];
  H.neg_actor_lr = hyper[8];
  H.neg_critic_lr = hyper[9];
  const Dims D{u, b, k, m, h1, h2, floats};
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ddpg_learn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ddpg_learn_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      state, counts, s, a, r, s2, metrics, D, L, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
