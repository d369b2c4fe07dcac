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
// The update itself is ddpg_update.cuh, shared with episode_learn.cu.
//
// Layout. The learner state of a session is one float32 row of `floats`
// values at the REAL layer sizes (no [P, P] padding, which was a TPU tiling
// artefact; see ddpg_update.cuh). Counts are int32 [N, 2] (actor, critic).
// Minibatches arrive pre-gathered: s, s2 [N, U, B, k], a [N, U, B, m],
// r [N, U, B]. Metrics out: [N, U, 3]
// (critic_loss, actor_loss, q_mean). The state is updated IN PLACE.
//
// What bounds it. Per session-update the work is ~1.85 MFLOP of small dense
// products (B = 16 rows, widths 12..64) plus the Adam/Polyak sweep over
// ~10k parameters: at N = 1024 the bound is the f32 operation rate
// (kernels/ddpg_learn.py::work counts it), not the bytes. Each update
// depends on the previous one, so the U loop runs inside the block and
// nothing is launched per update.
//
// Design: one block of kThreads per session, grid (N,), one block per SM.
// Shared memory holds, at the offsets of kernels/ddpg_learn.py::smem_plan,
// the session's whole learner state (parameters, targets and both Adam
// moments, loaded once and written back once) and the update's scratch.
// Update u + 1's minibatch rows come in by cp.async while update u runs
// (ddpg_update.cuh). Every sum runs in the first design's fixed order with
// no atomics, so the kernel gives those bits and two launches on the same
// inputs are bitwise equal.

#include "ddpg_update.cuh"

namespace {

using namespace ddpg;

// The pre-gathered minibatches of one session, the source of its updates:
// fetch copies update u's s and a (as xc's rows) and r into the stage and
// s2 straight into xt's first k columns, from the last thread down; load
// moves s, a and r into place.
struct Rows {
  const float *s, *a, *r, *s2;  // [U, B, k], [U, B, m], [U, B], [U, B, k]
  int b, k, m;

  __device__ void fetch(const Scratch& S, int u) const {
    const int kc = k + m;
    const float* su = s + (size_t)u * b * k;
    const float* au = a + (size_t)u * b * m;
    const float* s2u = s2 + (size_t)u * b * k;
    for (int e = rev_thread(); e < b * kc; e += blockDim.x) {
      const int row = e / kc, c = e - row * kc;
      copy_async4(S.stage + e, c < k ? su + row * k + c
                                     : au + row * m + c - k);
    }
    for (int e = rev_thread(); e < b * k; e += blockDim.x) {
      const int row = e / k, c = e - row * k;
      copy_async4(S.xt + row * kc + c, s2u + e);
    }
    for (int e = rev_thread(); e < b; e += blockDim.x)
      copy_async4(S.stage + b * kc + e, r + (size_t)u * b + e);
  }

  __device__ void load(const Scratch& S, int) const {
    const int kc = k + m;
    for (int e = threadIdx.x; e < b * kc; e += blockDim.x)
      S.xc[e] = S.stage[e];
    for (int e = threadIdx.x; e < b; e += blockDim.x)
      S.y[e] = S.stage[b * kc + e];
  }
};

__global__ void __launch_bounds__(kThreads)
ddpg_learn_kernel(float* __restrict__ state, int* __restrict__ counts,
                  const float* __restrict__ s_all,
                  const float* __restrict__ a_all,
                  const float* __restrict__ r_all,
                  const float* __restrict__ s2_all,
                  float* __restrict__ metrics, Dims D,
                  const __grid_constant__ Layout L, Hyper H,
                  int off_learner) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int B = D.b, k = D.k, m = D.m;
  float* row = state + (size_t)n * D.floats;
  const Nets nets = nets_at(smem, L);
  const Scratch S = scratch_at(smem + off_learner, D);
  const size_t row0 = (size_t)n * D.u * B;
  const Rows src{s_all + row0 * k, a_all + row0 * m, r_all + row0,
                 s2_all + row0 * k, B, k, m};
  const int actor_count0 = counts[2 * n], critic_count0 = counts[2 * n + 1];

  move_state<true>(D, L, row, smem);
  src.fetch(S, 0);
  copy_wait();
  __syncthreads();
  AdamConsts own{};
  for (int u = 0; u < D.u; ++u) {
    if (u % blockDim.x == 0) {
      const int uo = owned_update(u);
      if (uo < D.u)
        own = adam_consts(H, critic_count0 + uo + 1, actor_count0 + uo + 1);
    }
    ddpg_update(D, H, nets, S, src, u, u + 1 < D.u, own,
                metrics + ((size_t)n * D.u + u) * 3);
  }
  move_state<false>(D, L, row, smem);
  if (threadIdx.x == 0) {
    counts[2 * n] = actor_count0 + D.u;
    counts[2 * n + 1] = critic_count0 + D.u;
  }
}

}  // namespace

extern "C" {

// Launches the learner on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or -1 when the caller's shared-memory plan
// (smem_bytes, the learner's scratch at float offset off_learner) does not
// hold the state and the scratch, -3 when the widths are not the ones the
// kernel is built for (hidden kHidden-kHidden; k + m + 1 <= kHidden, so
// that a minibatch fits the stage). Pointers are device pointers; `offsets`
// (48 ints) and `hyper` (10 floats) are host arrays copied into the launch.
int ddpg_learn_launch(float* state, int* counts, const float* s,
                      const float* a, const float* r, const float* s2,
                      float* metrics, const int* offsets, const float* hyper,
                      int n, int u, int b, int k, int m, int h1, int h2,
                      int floats, int smem_bytes, int off_learner,
                      void* stream) {
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
  if (h1 != kHidden || h2 != kHidden || k + m + 1 > kHidden) return -3;
  const size_t smem = (size_t)smem_bytes;
  if (off_learner < floats ||
      smem < sizeof(float) * (off_learner + learner_smem_floats(D)))
    return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ddpg_learn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ddpg_learn_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      state, counts, s, a, r, s2, metrics, D, L, H, off_learner);
  return (int)cudaGetLastError();
}

// Opts the kernel into `smem_bytes` of dynamic shared memory, as every
// launch does, and returns the shared memory one block then holds, static
// and dynamic, as the runtime reports it (cudaFuncGetAttributes), or -1.
int ddpg_learn_shared_bytes(int smem_bytes) {
  if (cudaFuncSetAttribute(ddpg_learn_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, ddpg_learn_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes + attr.maxDynamicSharedSizeBytes;
}

}  // extern "C"
