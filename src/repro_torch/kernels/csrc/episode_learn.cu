// The whole tuning episode for Hopper (sm_90a): all T steps of the Fig. 1
// loop of every tuning session in ONE launch.
//
// Replaces the Pallas TPU kernel kernels/episode_fused.py::
// episode_fused_learn (body _episode_body) of the JAX package. For each of N
// sessions (one thread block each, grid (N,)) and each step t < T:
//   1. the actor forward on the session's state row (real layer sizes), then
//      the sigmoid;
//   2. clip(policy + noise, 0, 1), or the warmup action where use_warmup;
//   3. quantization to knob indices (the twin of core/action_mapping.py::
//      coord_maps: one fused multiply-add, floor, clamp, table lookup);
//   4. the Lustre model's step (envs/lustre_model.py::build_lustre_fns) on
//      this step's pre-drawn 3 + 11 n values;
//   5. the lo/span normalization, the serial objective fold and the reward;
//   6. the FIFO write into the replay window, store before learn;
//   7. for each of the U updates, a gather of the B minibatch rows from the
//      window by this step's pre-drawn indices, then one DDPG update
//      (ddpg_update.cuh, the learner ddpg_learn.cu runs too);
//   8. the trace: knob indices, raw metrics, reward, objective, and the
//      restart cost as int32 fixed point (core/episode.py).
// The learner state, the replay window and cursors, the env state (warmth
// and last_values), the state vector and the objective are updated IN
// PLACE. All randomness arrives pre-drawn (kernels/episode_learn.py::
// predraw): env_draws [N, T, 3 + 11 n] and mb_idx [N, T, U, B].
//
// What bounds it. The U updates per step are ~1.85 MFLOP each of small
// dense products (B = 16 rows, widths 12..64) plus the Adam/Polyak sweep;
// the env step is a few hundred scalar operations. At N = 1,024 the bound is
// the f32 operation rate (kernels/episode_learn.py::work counts it); at
// N = 1 the kernel is latency-bound: one block runs T * U dependent updates.
//
// Design: one block of kThreads per session, one block per SM. Shared
// memory holds, at the offsets of kernels/episode_learn.py::smem_plan, the
// session's whole learner state (parameters, targets and both Adam moments,
// loaded once and written back once), the learner's scratch, the replay
// window for the whole episode, the state and metric rows and the env
// step's per-sample scratch. The act forward and the env step's rows use
// the learner's scratch, which no update needs between steps. Steps 2-6
// and 8 run on thread 0, in the reference's order, every serial fold (the
// sample means, the objective) left to right. Update u + 1's minibatch
// indices come in by cp.async while update u runs, and each update
// gathers its rows from the window in shared memory (ddpg_update.cuh).
// Products and sums are written with the _rn intrinsics, so nvcc contracts
// nothing: where the reference's compiled code rounds a*b + c once (the
// quantization) the kernel writes __fmaf_rn. Transcendentals are CUDA's
// IEEE-mode expf, exp2f, log2f and powf (no fast math).

#include "ddpg_update.cuh"

namespace {

using namespace ddpg;

constexpr int kMaxKnobs = 16;
constexpr int kMaxTable = 128;
constexpr int kNumMetrics = 12;

// LustreParams fields, in order (envs/lustre_model.py)
enum Param { BASE_MBPS = 0, GAMMA, BETA, L_OPT, L_WIDTH, S_AMP, IO_KIB,
             WRITE_FRAC, META_RATE, CACHE_BASE, NOISE_SIGMA, L_GATE,
             GATE_WIDTH, CACHE_KAPPA, kNumParams };

// the named knobs the Lustre model reads
enum Knob { STRIPE_COUNT = 0, STRIPE_SIZE, SERVICE_THREADS, MAX_RPCS,
            MAX_PAGES, MAX_DIRTY, READ_AHEAD, CHECKSUMS, kNumNamed };

// The parameter space, flattened by kernels/episode_learn.py::space_desc.
struct Space {
  int m;
  int boolean[kMaxKnobs];  // 1: a >= 0.5; 0: an indexed knob
  int card[kMaxKnobs];
  int table[kMaxKnobs];    // offset of the knob's values in value/log2v
  int pos[kNumNamed];      // knob index of each named knob, -1 if absent
  int dfs_mask;            // bit j: a change of knob j restarts the DFS
  float span[kMaxKnobs], off[kMaxKnobs], base[kMaxKnobs];
  float value[kMaxTable], log2v[kMaxTable];
};

// float32 constants of the env step, each rounded from its Python value.
struct EnvConst {
  float sigma_scale;  // sqrt(run_seconds / run_len)
  float h0_dirty;     // 1 - exp(-32 / 24)
  float h0_ra;        // 1 - exp(-64 / 48)
  float net_cap95;    // NET_CAP * 0.95
  float net_cap;
};

struct Ptrs {
  float* state;
  int* counts;
  float *bs, *ba, *br, *bs2;
  int *next_slot, *size;
  float *warmth, *last_values, *state_vec, *objective;
  const unsigned char* use_warmup;
  const float *warmup, *noise, *w_vec, *lo, *span, *params, *env_draws;
  const int* mb_idx;
  int* tr_idx;
  float *tr_met, *tr_rew, *tr_obj;
  int* tr_rst;
};

struct Episode {
  int t_steps, cap, n_samples, draws, learn, updates;
  // offsets in floats of the shared-memory parts after the learner state,
  // from kernels/episode_learn.py::smem_plan
  int off_learner, off_window, off_state, off_samples;
};

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// Decoded knob j of unit action a: index, value, log2(value).
__device__ void decode(const Space& S, int j, float a, float* idx,
                       float* value, float* log2v) {
  if (S.boolean[j]) {
    const float i = a >= 0.5f ? 1.f : 0.f;
    *idx = i;
    *value = i;
    *log2v = 0.f;
    return;
  }
  const float x = floorf(__fmaf_rn(a, S.span[j], S.off[j]));
  const float i = clampf(fsub(x, S.base[j]), 0.f, (float)(S.card[j] - 1));
  const int at = S.table[j] + (int)i;
  *idx = i;
  *value = S.value[at];
  *log2v = S.log2v[at];
}

// The noise-free surface: throughput, iops and utilisation of one decoded
// config (envs/lustre_model.py::mean_perf, op for op).
__device__ void mean_perf(const Space& S, const EnvConst& E, const float* p,
                          const float* val, const float* lg, float* t_out,
                          float* iops_out, float* util_out, float* l_out,
                          float* sc_out) {
  const int* pos = S.pos;
  const float sc = val[pos[STRIPE_COUNT]];
  const float l = fsub(lg[pos[STRIPE_SIZE]], 16.f);

  const float par = fmul(powf(sc, p[GAMMA]),
                         expf(fmul(-p[BETA], fsub(sc, 1.f))));
  const float r_gate = fdiv(
      1.f, fadd(1.f, expf(fdiv(-fsub(l, p[L_GATE]), p[GATE_WIDTH]))));
  const float p_eff = par >= 1.f ? fadd(1.f, fmul(fsub(par, 1.f), r_gate))
                                 : par;
  const float q_l = fdiv(fsub(l, p[L_OPT]), p[L_WIDTH]);
  const float q_d = fdiv(fsub(4.f, p[L_OPT]), p[L_WIDTH]);
  const float s_l = fadd(1.f, fmul(p[S_AMP], fsub(1.f, sq(q_l))));
  const float s_d = fadd(1.f, fmul(p[S_AMP], fsub(1.f, sq(q_d))));
  const float s = fdiv(fmaxf(0.4f, s_l), fmaxf(0.4f, s_d));
  const float x = fmaxf(
      0.6f, fsub(1.f, fmul(fmul(0.03f, fmaxf(0.f, fsub(sc, 1.f))),
                           fmaxf(0.f, fsub(l, 8.f)))));
  float t = fmul(fmul(fmul(p[BASE_MBPS], p_eff), s), x);

  if (pos[SERVICE_THREADS] >= 0) {
    const float z = fdiv(fsub(lg[pos[SERVICE_THREADS]], 7.f), 3.f);
    t = fmul(t, fadd(0.75f, fmul(0.33f, expf(-sq(z)))));
  }
  if (pos[MAX_RPCS] >= 0) {
    const float rif = val[pos[MAX_RPCS]];
    const float lg_rif = lg[pos[MAX_RPCS]];
    const float per_ost = fdiv(rif, fmaxf(sc, 1.f));
    const float conc = fdiv(per_ost, fadd(per_ost, 2.f));
    const float over = fsub(
        1.f, fmul(fmul(0.03f, p[META_RATE]), fmaxf(0.f, fsub(lg_rif, 5.f))));
    t = fmul(fdiv(fmul(t, conc), 0.8f), fmaxf(over, 0.7f));
  }
  if (pos[MAX_PAGES] >= 0) {
    const float lg_pg = lg[pos[MAX_PAGES]];
    const float lr_opt = clampf(p[L_OPT], 0.f, 4.f);
    const float lr_a = fminf(fsub(lg_pg, 4.f), l);
    const float lr_b = fminf(4.f, l);
    const float ra = fadd(
        1.f, fmul(0.10f, fsub(1.f, sq(fdiv(fsub(lr_a, lr_opt), 4.f)))));
    const float rb = fadd(
        1.f, fmul(0.10f, fsub(1.f, sq(fdiv(fsub(lr_b, lr_opt), 4.f)))));
    t = fdiv(fmul(t, ra), rb);
  }
  if (pos[MAX_DIRTY] >= 0) {
    const float dirty = val[pos[MAX_DIRTY]];
    const float lg_dirty = lg[pos[MAX_DIRTY]];
    const float h = fsub(1.f, expf(fdiv(-dirty, 24.f)));
    const float burst = fsub(1.f, fmul(0.02f, fmaxf(0.f, fsub(lg_dirty, 9.f))));
    const float wf = p[WRITE_FRAC];
    t = fmul(fmul(t, fadd(fsub(1.f, wf), fdiv(fmul(wf, h), E.h0_dirty))),
             burst);
  }
  if (pos[READ_AHEAD] >= 0) {
    const float ra = val[pos[READ_AHEAD]];
    const float lg_ra = lg[pos[READ_AHEAD]];
    const float seq = clampf(fdiv(log2f(fdiv(p[IO_KIB], 8.f)), 7.f), 0.f, 1.f);
    const float rf = fsub(1.f, p[WRITE_FRAC]);
    const float h = fsub(1.f, expf(fdiv(-ra, 48.f)));
    const float gain = fmul(fmul(fmul(0.25f, rf), seq),
                            fsub(fdiv(h, E.h0_ra), 1.f));
    const float waste = fmul(fmul(fmul(0.12f, rf), fsub(1.f, seq)),
                             clampf(fdiv(fsub(lg_ra, 6.f), 4.f), 0.f, 1.f));
    t = fmul(t, fsub(fadd(1.f, gain), waste));
  }
  if (pos[CHECKSUMS] >= 0) {
    const bool ck_on = val[pos[CHECKSUMS]] >= 0.5f;
    t = fmul(t, ck_on ? 1.f : fadd(1.04f, fmul(0.06f, p[WRITE_FRAC])));
  }
  t = fminf(fminf(t, E.net_cap95), fmul(fmul(sc, 160.f), 1.05f));
  const float amp = fadd(1.f, fdiv(fmul(0.6f, fmaxf(0.f, fsub(4.f, l))), 4.f));
  *iops_out = fmul(fdiv(fmul(t, 1024.f), p[IO_KIB]), amp);
  *t_out = t;
  *util_out = fdiv(t, E.net_cap);
  *l_out = l;
  *sc_out = sc;
}

// One env step on one thread: updates warmth and last_values, writes the 12
// metrics (LUSTRE_STATE_METRICS order) and returns the restart cost.
// `samp` is scratch of 12 * n floats.
__device__ float lustre_step(const Space& S, const EnvConst& E,
                             const float* p, const float* val,
                             const float* lg, const float* draws, int n,
                             float* warmth, float* last_values,
                             float* metrics, float* samp) {
  const int* pos = S.pos;
  bool changed_any = false, dfs_changed = false;
  for (int j = 0; j < S.m; ++j) {
    const bool changed = val[j] != last_values[j];  // NaN: the first apply
    changed_any |= changed;
    dfs_changed |= changed && ((S.dfs_mask >> j) & 1);
    last_values[j] = val[j];
  }
  const float u_w = draws[0], z_run = draws[1];
  const float* z_samp = draws + 2;
  const float u_rst = draws[2 + n];
  const float* z_met = draws + 3 + n;  // [10, n]

  float w = changed_any ? fmul(*warmth, 0.4f) : *warmth;
  w = __fmaf_rn(0.6f, w, fmul(0.4f, u_w));  // rounded once, as the reference
  *warmth = w;
  const float we = w;  // episodes never run the eval protocol

  float t, iops, util, l, sc;
  mean_perf(S, E, p, val, lg, &t, &iops, &util, &l, &sc);

  const float cache_factor = expf(fmul(p[CACHE_KAPPA], fsub(we, 0.5f)));
  const float het = fsub(1.4f, fmul(0.8f, fminf(1.f, util)));
  const float sigma = fmul(fmul(p[NOISE_SIGMA], het), E.sigma_scale);
  const float run_factor = fmul(cache_factor, expf(fmul(sigma, z_run)));
  const float half_sigma = fdiv(p[NOISE_SIGMA], 2.f);
  const float t_run = fmul(t, run_factor), iops_run = fmul(iops, run_factor);
  const float rpc_mb = fminf(exp2f(fsub(l, 4.f)), 4.f);
  const float latency = fmul(0.05f, fadd(1.f, fmul(3.f, sq(util))));
  const float rpc_div = fmaxf(rpc_mb, 1e-3f);
  const float util2 = sq(util);
  const float wf = p[WRITE_FRAC];
  const float hit0 = fsub(fadd(fadd(p[CACHE_BASE], fmul(0.45f, fsub(we, 0.5f))),
                               fmul(0.03f, fsub(l, 4.f))),
                          fmul(0.2f, util));
  const float idle0 = fsub(fsub(100.f, fmul(55.f, p[META_RATE])),
                           fmul(25.f, util));
  const float wait0 = fadd(fmul(fmul(35.f, p[META_RATE]), fadd(0.5f, util)),
                           fmul(8.f, util));
  const float ram0 = fadd(28.f, fmul(40.f, util));
  float shift = 0.f;
  if (pos[READ_AHEAD] >= 0) {
    const float ra = val[pos[READ_AHEAD]];
    const float seq = clampf(fdiv(log2f(fdiv(p[IO_KIB], 8.f)), 7.f), 0.f, 1.f);
    const float h = fsub(1.f, expf(fdiv(-ra, 48.f)));
    shift = fmul(fmul(fmul(0.10f, fsub(1.f, wf)), seq),
                 fsub(fdiv(h, E.h0_ra), 1.f));
  }

  for (int i = 0; i < n; ++i) {
    const float sf = expf(fmul(half_sigma, z_samp[i]));
    const float tput = fmul(t_run, sf);
    const float iops_s = fmul(iops_run, sf);
    float jit[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) jit[q] = expf(fmul(0.05f, z_met[q * n + i]));
    const float write_mb = fmul(tput, wf);
    const float read_mb = fsub(tput, write_mb);
    float cur_dirty = fmul(fmul(fmul(write_mb, 2.f), 1048576.f), jit[0]);
    float cur_grant = fmul(fmul(fadd(fmul(sc, 32.f), write_mb), 1048576.f),
                           jit[1]);
    float read_rpcs = fmul(fmul(fdiv(read_mb, rpc_div), latency), jit[2]);
    float write_rpcs = fmul(fmul(fdiv(write_mb, rpc_div), latency), jit[3]);
    float pend_r = fmul(fmul(fmul(fdiv(read_mb, 4.f), 256.f), util2), jit[4]);
    float pend_w = fmul(fmul(fmul(fdiv(write_mb, 4.f), 256.f), util2),
                        jit[5]);
    float cache_hit = clampf(fadd(hit0, fmul(0.02f, z_met[6 * n + i])), 0.f,
                             1.f);
    float cpu_idle = clampf(fadd(idle0, fmul(2.f, z_met[7 * n + i])), 0.f,
                            100.f);
    const float iowait = clampf(fadd(wait0, fmul(1.5f, z_met[8 * n + i])),
                                0.f, 100.f);
    const float ram = clampf(
        fadd(fadd(ram0, fmul(fdiv(fmul(write_mb, 2.f), 16384.f), 100.f)),
             fmul(1.5f, z_met[9 * n + i])),
        0.f, 100.f);
    if (pos[MAX_RPCS] >= 0) {
      const float cap = fmul(val[pos[MAX_RPCS]], fmaxf(sc, 1.f));
      pend_r = fadd(pend_r, fmul(fmaxf(0.f, fsub(read_rpcs, cap)), 256.f));
      pend_w = fadd(pend_w, fmul(fmaxf(0.f, fsub(write_rpcs, cap)), 256.f));
      read_rpcs = fminf(read_rpcs, cap);
      write_rpcs = fminf(write_rpcs, cap);
    }
    if (pos[MAX_DIRTY] >= 0) {
      const float cap = fmul(val[pos[MAX_DIRTY]], 1048576.f);
      cur_dirty = fminf(cur_dirty, cap);
      cur_grant = fminf(cur_grant, fadd(fmul(2.f, cap), 33554432.f));
    }
    if (pos[READ_AHEAD] >= 0)
      cache_hit = clampf(fadd(cache_hit, shift), 0.f, 1.f);
    if (pos[CHECKSUMS] >= 0 && val[pos[CHECKSUMS]] >= 0.5f)
      cpu_idle = clampf(fsub(cpu_idle, fmul(8.f, util)), 0.f, 100.f);
    const float row[kNumMetrics] = {cur_dirty, cur_grant, read_rpcs,
                                    write_rpcs, pend_r, pend_w, cache_hit,
                                    cpu_idle, iowait, ram, tput, iops_s};
#pragma unroll
    for (int q = 0; q < kNumMetrics; ++q) samp[q * n + i] = row[q];
  }
  // windowed means: a serial left-to-right fold, as the reference's smean
  for (int q = 0; q < kNumMetrics; ++q) {
    float acc = samp[q * n];
    for (int i = 1; i < n; ++i) acc = fadd(acc, samp[q * n + i]);
    metrics[q] = fdiv(acc, (float)n);
  }
  return changed_any ? fadd(u_rst, dfs_changed ? 30.f : 0.f) : 0.f;
}

// The replay window of one session, the source of its updates: fetch
// copies update u's B row indices into the stage, from the last thread
// down; load gathers those rows of the window into xc, xt's first k
// columns and y.
struct Window {
  const float *ws, *wa, *wr, *ws2;  // the window in shared memory
  const int* idx;                   // this step's minibatch rows [U, B]
  int b, k, m;

  __device__ void fetch(const Scratch& S, int u) const {
    for (int e = rev_thread(); e < b; e += blockDim.x)
      copy_async4(S.stage + e, idx + (size_t)u * b + e);
  }

  __device__ void load(const Scratch& S, int) const {
    const int* rows = reinterpret_cast<const int*>(S.stage);
    const int kc = k + m;
    for (int e = threadIdx.x; e < b * kc; e += blockDim.x) {
      const int r = e / kc, c = e - r * kc, w = rows[r];
      if (c < k) {
        S.xc[e] = ws[w * k + c];
        S.xt[e] = ws2[w * k + c];
      } else {
        S.xc[e] = wa[w * m + c - k];
      }
    }
    for (int e = threadIdx.x; e < b; e += blockDim.x) S.y[e] = wr[rows[e]];
  }
};

__global__ void __launch_bounds__(kThreads)
episode_learn_kernel(Ptrs P, Dims D, Episode EP,
                     const __grid_constant__ Layout L, Hyper H,
                     const __grid_constant__ Space S, EnvConst E) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int T = EP.t_steps, U = D.u, B = D.b, k = D.k, m = D.m,
            cap = EP.cap, ns = EP.n_samples;

  // shared memory, part by part at the offsets of
  // kernels/episode_learn.py::smem_plan
  const Nets nets = nets_at(smem, L);           // the learner state
  const Scratch sc = scratch_at(smem + EP.off_learner, D);
  float* ws = smem + EP.off_window;             // window [cap, k]
  float* wa = ws + cap * k;                     //        [cap, m]
  float* wr = wa + cap * m;                     //        [cap]
  float* ws2 = wr + cap;                        //        [cap, k]
  float* sv = smem + EP.off_state;              // state row [k]
  float* met = sv + k;                          // metrics [k]
  float* samp = smem + EP.off_samples;          // env samples [12 n]
  // the act forward and the env step's rows, in the learner's scratch
  float* pol = sc.mu;                           // policy [m]
  float* act = sc.t1;                           // action [m]
  float* val = act + kMaxKnobs;                 // knob values [m]
  float* lgv = val + kMaxKnobs;                 // their log2 [m]
  float* norm = sc.t2;                          // normalized metrics [k]

  float* row = P.state + (size_t)n * D.floats;
  const float* params = P.params + (size_t)n * kNumParams;
  const int actor_count0 = P.counts[2 * n];
  const int critic_count0 = P.counts[2 * n + 1];

  // load the session's learner state, window and state row
  move_state<true>(D, L, row, smem);
  for (int e = threadIdx.x; e < cap * k; e += blockDim.x) {
    ws[e] = P.bs[(size_t)n * cap * k + e];
    ws2[e] = P.bs2[(size_t)n * cap * k + e];
  }
  for (int e = threadIdx.x; e < cap * m; e += blockDim.x)
    wa[e] = P.ba[(size_t)n * cap * m + e];
  for (int e = threadIdx.x; e < cap; e += blockDim.x)
    wr[e] = P.br[(size_t)n * cap + e];
  for (int e = threadIdx.x; e < k; e += blockDim.x)
    sv[e] = P.state_vec[(size_t)n * k + e];
  // carried scalars, owned by thread 0
  int next_slot = P.next_slot[n], size = P.size[n];
  float warmth = P.warmth[n], objective = P.objective[n];
  float* last_values = P.last_values + (size_t)n * m;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    const Window src{ws, wa, wr, ws2, P.mb_idx + nt * U * B, B, k, m};
    if (EP.updates) src.fetch(sc, 0);
    // --- 1. act: the actor forward on the state row -------------------
    for (int e = threadIdx.x; e < kQuarter; e += blockDim.x)
      fwd_in(sv, k, k, nets.actor.w[0], nets.actor.b[0], sc.t1, 1, e);
    __syncthreads();
    for (int e = threadIdx.x; e < kQuarter; e += blockDim.x)
      fwd_hid(sc.t1, nets.actor.w[1], nets.actor.b[1], sc.t2, 1, e);
    __syncthreads();
    for (int c = threadIdx.x; c < m; c += blockDim.x)
      pol[c] = sigmoid(fwd_out(sc.t2, nets.actor.w[2], nets.actor.b[2], m,
                               0, c));
    __syncthreads();

    if (threadIdx.x == 0) {
      // --- 2-3. explore or warm up, then quantize -----------------------
      const bool warm = P.use_warmup[nt] != 0;
      for (int j = 0; j < m; ++j) {
        const float a = warm ? clampf(P.warmup[nt * m + j], 0.f, 1.f)
                             : clampf(fadd(pol[j], P.noise[nt * m + j]),
                                      0.f, 1.f);
        float idx;
        decode(S, j, a, &idx, &val[j], &lgv[j]);
        act[j] = a;
        P.tr_idx[nt * m + j] = (int)idx;
      }
      // --- 4. the env step ----------------------------------------------
      const float cost = lustre_step(
          S, E, params, val, lgv, P.env_draws + nt * EP.draws, ns, &warmth,
          last_values, met, samp);
      // --- 5. normalize, objective, reward -------------------------------
      const float* lo = P.lo + (size_t)n * k;
      const float* span = P.span + (size_t)n * k;
      const float* wv = P.w_vec + (size_t)n * k;
      float obj = 0.f;
      for (int j = 0; j < k; ++j) {
        norm[j] = span[j] > 0.f
                      ? clampf(fdiv(fsub(met[j], lo[j]), span[j]), 0.f, 1.f)
                      : 0.f;
        obj = fadd(obj, fmul(wv[j], norm[j]));
      }
      const float reward = fdiv(fsub(obj, objective), fmaxf(objective, 1e-6f));
      // --- 6. FIFO write, store before learn -----------------------------
      if (EP.learn) {
        const int i = next_slot;
        for (int j = 0; j < k; ++j) {
          ws[i * k + j] = sv[j];
          ws2[i * k + j] = norm[j];
        }
        for (int j = 0; j < m; ++j) wa[i * m + j] = act[j];
        wr[i] = reward;
        next_slot = (i + 1) % cap;
        size = min(size + 1, cap);
      }
      // --- 8. the trace ---------------------------------------------------
      for (int j = 0; j < k; ++j) {
        P.tr_met[nt * k + j] = met[j];
        sv[j] = norm[j];
      }
      P.tr_rew[nt] = reward;
      P.tr_obj[nt] = obj;
      P.tr_rst[nt] = __float2int_rn(
          fmul(clampf(cost, 0.f, 1023.f), 2097152.f));
      objective = obj;
    }
    // --- 7. U updates on minibatches gathered from the window; the Adam
    // constants of the first blockDim.x, meanwhile on the other threads --
    AdamConsts own{};
    for (int u = 0; u < U; ++u) {
      if (!EP.updates) break;
      if (u % blockDim.x == 0) {
        const int uo = owned_update(u);
        if (uo < U)
          own = adam_consts(H, critic_count0 + t * U + uo + 1,
                            actor_count0 + t * U + uo + 1);
      }
      if (u == 0) {
        copy_wait();
        __syncthreads();
      }
      ddpg_update(D, H, nets, sc, src, u, u + 1 < U, own, nullptr);
    }
    if (!EP.updates) {
      copy_wait();
      __syncthreads();
    }
  }

  // write back the learner state, window, cursors, env state and carried
  // state
  move_state<false>(D, L, row, smem);
  for (int e = threadIdx.x; e < cap * k; e += blockDim.x) {
    P.bs[(size_t)n * cap * k + e] = ws[e];
    P.bs2[(size_t)n * cap * k + e] = ws2[e];
  }
  for (int e = threadIdx.x; e < cap * m; e += blockDim.x)
    P.ba[(size_t)n * cap * m + e] = wa[e];
  for (int e = threadIdx.x; e < cap; e += blockDim.x)
    P.br[(size_t)n * cap + e] = wr[e];
  for (int e = threadIdx.x; e < k; e += blockDim.x)
    P.state_vec[(size_t)n * k + e] = sv[e];
  if (threadIdx.x == 0) {
    P.next_slot[n] = next_slot;
    P.size[n] = size;
    P.warmth[n] = warmth;
    P.objective[n] = objective;
    if (EP.updates) {
      P.counts[2 * n] = actor_count0 + T * U;
      P.counts[2 * n + 1] = critic_count0 + T * U;
    }
  }
}

}  // namespace

extern "C" {

// Launches the episode on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or -1 when the caller's shared-memory plan does
// not hold the learner state and scratch before its window, -2 when the
// space does not fit the Space struct, -3 when the widths are not the ones
// the learner is built for (hidden kHidden-kHidden, k + m + 1 <= kHidden).
// Arrays (host memory, copied into the launch):
//   ptrs[26]        device pointers, in the order of struct Ptrs;
//   ints[18]        n, T, U, B, k, m, h1, h2, floats, cap, n_samples,
//                   learn, updates, then smem_plan's total bytes and the
//                   float offsets of its learner, window, state and
//                   env-sample parts (the learner state is at 0);
//   floats[15]      Hyper (10), then EnvConst (5);
//   offsets[48]     the learner's layout;
//   space_ints[58]  m, boolean[16], card[16], table[16], pos[8], dfs_mask;
//   space_floats[304] span[16], off[16], base[16], value[128], log2v[128].
int episode_learn_launch(void* const* ptrs, const int* ints,
                         const float* floats, const int* offsets,
                         const int* space_ints, const float* space_floats,
                         void* stream) {
  Ptrs P;
  void** dst = reinterpret_cast<void**>(&P);
  for (int i = 0; i < (int)(sizeof(Ptrs) / sizeof(void*)); ++i)
    dst[i] = ptrs[i];
  const int n = ints[0];
  const Dims D{ints[2], ints[3], ints[4], ints[5], ints[6], ints[7], ints[8]};
  Episode EP;
  EP.t_steps = ints[1];
  EP.cap = ints[9];
  EP.n_samples = ints[10];
  EP.draws = 3 + 11 * ints[10];
  EP.learn = ints[11];
  EP.updates = ints[12];
  EP.off_learner = ints[14];
  EP.off_window = ints[15];
  EP.off_state = ints[16];
  EP.off_samples = ints[17];
  Layout L;
  for (int i = 0; i < kSets * kLayers * 2; ++i) L.off[i] = offsets[i];
  Hyper H;
  H.gamma = floats[0];
  H.tau = floats[1];
  H.one_minus_tau = floats[2];
  H.b1 = floats[3];
  H.one_minus_b1 = floats[4];
  H.b2 = floats[5];
  H.one_minus_b2 = floats[6];
  H.eps = floats[7];
  H.neg_actor_lr = floats[8];
  H.neg_critic_lr = floats[9];
  EnvConst E;
  E.sigma_scale = floats[10];
  E.h0_dirty = floats[11];
  E.h0_ra = floats[12];
  E.net_cap95 = floats[13];
  E.net_cap = floats[14];
  Space S;
  S.m = space_ints[0];
  if (S.m != D.m || S.m > kMaxKnobs || D.k > 32) return -2;
  for (int j = 0; j < kMaxKnobs; ++j) {
    S.boolean[j] = space_ints[1 + j];
    S.card[j] = space_ints[1 + kMaxKnobs + j];
    S.table[j] = space_ints[1 + 2 * kMaxKnobs + j];
    S.span[j] = space_floats[j];
    S.off[j] = space_floats[kMaxKnobs + j];
    S.base[j] = space_floats[2 * kMaxKnobs + j];
  }
  for (int q = 0; q < kNumNamed; ++q)
    S.pos[q] = space_ints[1 + 3 * kMaxKnobs + q];
  S.dfs_mask = space_ints[1 + 3 * kMaxKnobs + kNumNamed];
  for (int i = 0; i < kMaxTable; ++i) {
    S.value[i] = space_floats[3 * kMaxKnobs + i];
    S.log2v[i] = space_floats[3 * kMaxKnobs + kMaxTable + i];
  }
  const size_t smem = (size_t)ints[13];
  if (D.h1 != kHidden || D.h2 != kHidden || D.k + D.m + 1 > kHidden)
    return -3;
  if (EP.off_learner < D.floats ||
      (size_t)EP.off_window < EP.off_learner + learner_smem_floats(D))
    return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        episode_learn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  episode_learn_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      P, D, EP, L, H, S, E);
  return (int)cudaGetLastError();
}

// Opts the kernel into `smem_bytes` of dynamic shared memory, as every
// launch does, and returns the shared memory one block then holds, static
// and dynamic, as the runtime reports it (cudaFuncGetAttributes), or -1.
int episode_learn_shared_bytes(int smem_bytes) {
  if (cudaFuncSetAttribute(episode_learn_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, episode_learn_kernel) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes + attr.maxDynamicSharedSizeBytes;
}

}  // extern "C"
