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

#include "ddpg_update.cuh"

namespace {

using namespace ddpg;

__global__ void __launch_bounds__(kThreads)
ddpg_learn_kernel(float* __restrict__ state, int* __restrict__ counts,
                  const float* __restrict__ s_all,
                  const float* __restrict__ a_all,
                  const float* __restrict__ r_all,
                  const float* __restrict__ s2_all,
                  float* __restrict__ metrics, Dims D, Layout L, Hyper H) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int B = D.b, k = D.k, m = D.m;
  const Nets nets = nets_at(state + (size_t)n * D.floats, L);
  const int actor_count0 = counts[2 * n], critic_count0 = counts[2 * n + 1];

  for (int u = 0; u < D.u; ++u) {
    const size_t row0 = ((size_t)n * D.u + u) * B;
    ddpg_update(D, H, nets, smem, s_all + row0 * k, a_all + row0 * m,
                r_all + row0, s2_all + row0 * k, actor_count0 + u + 1,
                critic_count0 + u + 1, metrics + ((size_t)n * D.u + u) * 3);
  }
  if (threadIdx.x == 0) {
    counts[2 * n] = actor_count0 + D.u;
    counts[2 * n + 1] = critic_count0 + D.u;
  }
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
  const size_t smem = sizeof(float) * learner_smem_floats(D);
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
