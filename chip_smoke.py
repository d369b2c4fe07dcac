#!/usr/bin/env python3
"""Drive the PyTorch port of the Magpie tuner on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. Phases, one JSON line each:

  1. device       the card's name and count, and ``nvidia-smi``'s name and
                  power limit;
  2. build        every CUDA source of ``src/repro_torch/kernels/csrc``
                  compiled (one ``nvcc`` per source, all started together);
                  the learner kernels (``ddpg_learn_kernel``,
                  ``episode_learn_kernel``) read from their libraries by
                  ``cuobjdump``: registers, stack and local bytes (held: 0)
                  and static shared bytes, and the shared memory a block
                  holds once opted into each space's ``smem_plan`` (held
                  equal to the plan: the whole learner state resident);
                  the tensor-core kernels (``gmm_tc_kernel``,
                  ``flash_fwd_tc_kernel``, ``flash_dq_tc_kernel``,
                  ``flash_dkv_tc_kernel``, ``ssd_scan_tc_kernel``) read
                  from their libraries by
                  ``cuobjdump``: registers, stack and local bytes (held: 0,
                  so no spills) and the count of ``HGMMA`` instructions in
                  each kernel's own SASS (held: not 0), beside its
                  ``ptxas`` line where this run compiled it;
  3. check        the ``ddpg_learn`` kernel against its plain PyTorch version
                  at N = 1 and N = 1024 sessions on the 2-D and 8-D spaces,
                  from independent ``ddpg_init`` states and minibatches
                  gathered from a 64-row replay: Adam counts and steps exact,
                  the median and 90th-percentile session errors within
                  ``RTOL`` and ``RTOL_P90``, and two launches on the same
                  inputs bitwise equal;
  4. check_episode the ``episode_learn`` kernel against its plain version,
                  T = 30 steps of N = 1 and N = 64 independent sessions on
                  both spaces (each session its own env seed, agent seed,
                  warmup plan and OU noise): two launches bitwise equal, the
                  warmup decisions equal, per session the first step whose
                  decisions differ, and the median and 90th-percentile
                  session errors of the trace before that step within
                  ``EP_RTOL`` and ``EP_RTOL_P90``; the learner and replay
                  window after the episode, over the sessions whose
                  decisions never differ, are reported (``--drift`` below
                  says why they are not held). Then the learner held: T = 2
                  warmup steps of N = 64 sessions whose windows start with
                  63 random rows (the gathers reach all 64 rows, the FIFO
                  wraps), the learner state after the 192 updates and the
                  window within ``LEARN_RTOL``/``LEARN_RTOL_P90`` and
                  ``WINDOW_RTOL``/``WINDOW_RTOL_P90``;
  5. tune         ``Tuner(engine="host")``, 30 steps on
                  ``LustreSimEnv("seq_write")`` (2-D) and on ``LustreSimV2``
                  (8-D), with the kernel's launch count read around each run;
                  the first steps are replayed on the CPU through the plain
                  learner and must make the same decisions;
  6. tune_scan    the main path, ``Tuner(engine="scan")``, 30 steps in ONE
                  ``run()`` call on the same two environments as
                  ``ModelEnv``s: ``episode_learn`` must launch exactly once;
                  a CPU replay of 10 steps through the plain version must
                  make the same decisions through the warmup and at least
                  the first step after it, and the replay windows' rows of
                  the warmup steps must agree within ``TUNE_WINDOW_RTOL``
                  (the rows of the later agreeing steps are reported);
  7. fleet        the fleet runtime, on the 2-D and the 8-D space:
                  ``FleetTuner.from_grid`` over 4 workloads x 256 seeds
                  (1,024 sessions), 30 steps, on the scan engine under four
                  schedules on 2-D (two on 8-D, ``FLEET_SCHEDULES_8D``):
                  monolithic (``episode_learn`` launched
                  exactly once), ``chunk=256`` with the copy streams (4
                  launches), ``chunk=256`` serial, and ``chunk=300`` (300 +
                  300 + 300 + 124, nothing padded): every trace leaf, the
                  learner state, the replay window and cursors and the keys
                  held bitwise equal across the four; 8 evenly spaced
                  sessions each held bitwise equal to a fleet of one built
                  from its workload and cell seed; a fleet of one held equal
                  to the single ``Tuner`` on both engines (configs,
                  objectives, restart seconds, all 30 steps); the host
                  engine on the same 1,024 sessions for
                  ``FLEET_HOST_STEPS`` = 5 steps on 2-D and
                  ``FLEET_HOST_STEPS_8D`` = 3 on 8-D (``ddpg_learn`` launched
                  exactly once per step, finite metrics, a positive median
                  throughput gain), with the fleet act held
                  independent of the fleet's width (and the rows a batched
                  product would change reported); ``memory_plan``'s learner
                  and replay bytes held equal to the live tensors and the
                  monolithic run's peak device memory held within the plan's
                  chunk and pre-draw bytes plus ``FLEET_PEAK_MARGIN``; the
                  wall time per step, the launches' device time, the host's
                  staging, drain, trace replay and evaluations, session-steps
                  per second and ``FleetResult.summary()`` reported;
 7b. service      the persistent ``FleetService`` on the 2-D space at the
                  fleet's width, lease width C = 256: (a) the same 1,024
                  sessions (seeds ``seed + 1000 x cell`` as ``from_grid``)
                  joined, one ``advance(30)`` (``episode_learn`` launched
                  exactly 4 times), all left at ``advance(0)``: every
                  session's history and ``TuningResult`` held bitwise equal
                  to ``FleetTuner.from_grid(..., engine="scan",
                  chunk=256).run(30)``; (b) a quiet service of the 1,024
                  running 3 x ``advance(5)`` (``SERVICE_ROUND_STEPS``) and
                  a churn service of the
                  same 1,024 where at every boundary 64 new tenants join
                  and the previous 64 leave (1,088 active, 5 launches, the
                  last ragged): the survivors held bitwise equal to the
                  quiet service's, the freed slots reused and the launches
                  of every advance ``ceil(active / 256)``; (c) the churn
                  service checkpointed after its first and second advance,
                  restored from the first and run on through the same
                  sequence: every result held bitwise equal to the
                  uninterrupted run's; then the newest checkpoint's
                  ``tensors.pt`` corrupted: ``restore(fallback=True)`` held
                  to reach the step before it and ``fallback=False`` to
                  raise. Reported: wall seconds per step and session-steps
                  per second of each advance, the launches' device seconds,
                  the boundaries' seconds (join evaluations, leave
                  finalizations), the checkpoints' seconds and bytes, the
                  restores' seconds, and the peak device memory beside
                  ``memory_plan(chunk=256)`` plus ``FLEET_PEAK_MARGIN``;
 7c. guard        the per-step episode body and the deployment guardrails
                  (``DeploymentPolicy(min_gain=0.01, rollback_window=4)``),
                  ``ddpg_learn`` launched once per step per chunk and
                  ``episode_learn`` never on the guarded path: (a) the body
                  (``stepwise_episode``) with ``policy=None`` against
                  ``episode_learn``, 64 sessions, 30 steps, 2-D and 8-D,
                  held as ``check_episode`` holds (the warmup decisions
                  equal; the trace before each session's first differing
                  decision within ``EP_RTOL``/``EP_RTOL_P90``), whether it
                  was bitwise reported; (b) the guarded ``Tuner``, 30 steps
                  on both spaces, against a CPU replay of 10 steps: events
                  and committed decisions equal through the warmup and
                  after it; (c) the guarded ``FleetTuner`` on the fleet
                  phase's 1,024 sessions (2-D, ``GUARD_FLEET_STEPS`` = 10
                  steps: the phase's time), monolithic and in
                  chunks of 256 on copy streams: trace, events, guard
                  state, learner, window and keys bitwise equal, 8 evenly
                  spaced sessions bitwise equal to guarded fleets of one,
                  the peak device memory within ``memory_plan``; the
                  monolithic run's step split by CUDA events (the act, the
                  draws, the three model steps, the learner's draw, gather
                  and launch, the rest), its promotions, rejections,
                  rollbacks and restart seconds beside the unguarded
                  fleet's; (d) 256 sessions on a ``FaultInjectedModel``
                  whose throughput collapses to 10 % at step 6 for 10
                  steps, under ``min_gain=-0.5, rollback_window=10,
                  rollback_threshold=0.3``: rollbacks inside the window held
                  (at least one over the fleet, the reference test's pin
                  for one session); (e) the guarded ``FleetService`` of the
                  same 1,024 sessions at lease width 256: ``advance(10)``
                  bitwise equal to the guarded static fleet, and
                  ``advance(5)``, a checkpoint, a restore and
                  ``advance(5)`` bitwise equal to that uninterrupted
                  ``advance(10)``, guard state and counters included;
 7d. resilience   the self-healing layer, 2-D, ``RESILIENCE_STEPS`` = 20
                  steps, ``ddpg_learn`` launched once per step per chunk and
                  ``episode_learn`` never: (a) the fleet phase's 1,024
                  sessions on a ``FaultInjectedModel`` whose throughput
                  reads NaN at steps 6-7 (``ChaosConfig(nan_metric=
                  "throughput", nan_start=6, nan_duration=2)``, the
                  reference example's chaos) under ``ResiliencePolicy()``:
                  monolithic (its step split by CUDA events), in chunks of
                  256 under ``ChunkSupervisor(backoff_seconds=0.0)`` with
                  ``ChaosConfig(fail_chunks=((1, 2),))`` (two retries held)
                  and 8 fleets of one: every trace leaf (NaN readings
                  included), learner, window, cursors, keys and health
                  counter bitwise equal; every session's two poisoned steps
                  held as resets, no degrade, and the trace's counters
                  equal to the carried totals; (b) without faults, 16
                  sessions through ``stepwise_episode`` with the policy
                  held bitwise equal to the body with no layer, no health
                  event; (c) 256 sessions poisoned for 3 steps under
                  ``max_resets=2``: two resets then a degrade in every
                  session, and the learners bitwise still over the 11
                  steps after; (d) 64 sessions in chunks of 32, chunk 0
                  stalled 1 s under a 0.8 s watchdog: a trip, and the bits
                  of the unstalled run; (e) a ``FleetService`` of the 1,024
                  at lease width 256 whose chunk 1 never stages
                  (``fail_chunks=((1, 99),)``): its 256 sessions
                  quarantined (they leave at the next boundary with no
                  history), the 768 survivors bitwise equal to (a)'s
                  static fleet; a resilient service's ``advance(10)``,
                  checkpoint, restore and ``advance(10)`` bitwise equal to
                  it too, health records included; (f) ``ddpg_learn`` at
                  N = 1,024 with NaN and inf planted in two sessions'
                  learners and a 1e38 reward in a third's minibatches: the
                  kernel's outputs (learner or losses) and its learner
                  non-finite in exactly the sessions where the plain
                  version's are (the losses alone reported: the kernel's
                  relu maps NaN to 0), and the detector
                  (``tree_nonfinite_rows``) flagging exactly those three;
                  reported: what the layer adds to a step of 1,024
                  sessions (the entry learner's copy, the detector, the
                  health update), CUDA-event medians;
 7e. share        experience sharing on the 8-D space, 1,024 sessions (4
                  workloads x 256 seeds, ordered by workload) in cells of
                  ``SHARE_CELL`` = 8 consecutive sessions, 20 steps,
                  ``SharingConfig(shared_replay=True, avg_every=4,
                  avg_opt_state=True, observation_scopes=("OSC",))``,
                  merged windows of 256 slots and a warmup of 1 step (the
                  reference benchmark's ``benchmarks/shared_experience.py``):
                  (a) monolithic, every merged write held against a
                  sequential walk of its members' writes, and in chunks of
                  256: bitwise equal, ``memory_plan`` equal to the live
                  tensors; (b) a sharing ``FleetService`` of the same
                  sessions, lease width 256, bitwise equal to the static
                  fleet; (c) one member of a cell whose every reading is
                  NaN, under resilience, against the same member inactive:
                  its cellmates' window, learners and
                  traces bitwise equal (32 sessions);
  8. check_flash  the ``flash_attention_fwd`` kernels against their plain
                  version on the same numpy inputs: bfloat16 (the
                  tensor-core kernel) at the two serving shapes (B 4, S 512
                  and B 1, S 4096; 32 query over 4 key/value heads, D 128)
                  and at zamba2-7b's shared attention (B 4, S 4096, 32
                  heads, D 112), causal; float32 (the CUDA-core kernel) at B
                  2, S 256, 8 over 2 heads, D 64, causal and not. ``out``
                  and ``lse`` held within ``FLASH_*`` below, two launches
                  bitwise equal;
  9. serve        the LM serving path, ``repro_torch.launch.serve.serve`` on
                  Yi-9B at its published depth and width in bfloat16, random
                  weights from a seeded ``torch.Generator`` on the card: 4
                  prompts x 512 tokens -> 32 greedy tokens, then 1 x 4096 ->
  9. Each prefill must launch the flash kernel exactly 48
                  times (once per layer) and each decode step never. Then
                  the same prefill once more with the kernel held against its
                  plain version on the q, k, v of each of the 48 layers (the
                  ``FLASH_*`` bf16 bounds), and the same requests through the
                  kernel's plain version and through the plain reference
                  attention (``attn_impl="ref"``): their last-token logits,
                  per-layer caches and first differing greedy position are
                  reported, not held, since random weights at this depth
                  amplify any rounding difference until nothing agrees
                  (PERF.md);
 10. check_flash_bwd the flash backward kernels (``flash_attention_dq``;
                  ``flash_attention_dkv``) against their plain version on
                  the same numpy inputs (out and lse from the forward's plain
                  version): bfloat16 (the tensor-core kernels
                  ``flash_dq_tc_kernel`` and ``flash_dkv_tc_kernel``: s and
                  dp on the CUDA cores in the plain version's float32
                  order, dv, dk and dq by ``wgmma`` from p and ds as three
                  bf16 terms) at the training shape of phi4-mini-3.8b (B 2,
                  S 2048, 24 query over 8 key/value heads, D 128, causal),
                  at B 2, S 256, 8 over 2 heads, D 64, causal and not, and
                  at B 1, S 192, 6 over 2 heads, D 112, causal (the 128-row
                  blocks run past Sq and Sk, the head dim is zero-filled);
                  float32 (the CUDA-core kernels) at B 2, S 256, 8 over 2
                  heads, D 64, causal and not; dq, dk, dv held within
                  ``FLASH_BWD_*``, two launches bitwise equal, and the
                  kernels' shared memory equal to ``bwd_smem_plan`` (the
                  tensor-core kernels' with the stages ``BWD_TC_STAGES``
                  states);
 11. train        the training path, ``Trainer`` over
                  ``make_train_step`` on phi4-mini-3.8b at its published
                  size in bfloat16 (random weights from a seeded
                  ``torch.Generator`` on the card; AdamW from
                  ``launch.train.make_optimizer``, clip 1.0,
                  ``remat="full"``; ``TokenPipeline`` batches of 2 x 2048
                  tokens): 4 steps, each launching the flash forward exactly
                  64 times (the forward and the remat recompute, 32 layers
                  each) and dq and dk/dv 32 times each (the bf16
                  tensor-core kernels), with a finite loss
                  and grad_norm and parameters that moved; wall time,
                  tokens/s and peak memory per step. Then one more step with
                  the backward kernels held against their plain version on
                  each of the 32 layers' own (q, k, v, out, lse, dout), and
                  the loss and grad_norm of one batch through the kernels
                  and through their plain versions (reported, not held:
                  random weights at this depth amplify rounding); last, the
                  same comparison of the backward on each layer of the
                  second step of a fresh run from the seed, held at one
                  bf16 step of the largest value (``FLASH_BWD_STEP2_RTOL``)
                  and the same share (``second_step_layers``);
 12. check_gmm    the ``gmm`` kernel against its plain version on the same
                  numpy inputs: bfloat16 (the tensor-core kernel) at
                  deepseek-moe-16b's two serving products (E 64, C 1920, D
                  2048 -> F 1408 and D 1408 -> F 2048), float32 (the
                  CUDA-core kernel) at E 4, C 256, D 640, F 384, and
                  bfloat16 at E 3, C 192, D 160, F 192 (its 128 x 128 x 64
                  tiles run past C, F and D); held within ``GMM_*`` below,
                  two launches bitwise equal;
 13. serve_moe    the MoE serving path, ``repro_torch.launch.serve.serve`` on
                  deepseek-moe-16b at its published size in bfloat16 (random
                  weights from a seeded ``torch.Generator`` on the card): 4
                  prompts x 4096 tokens -> 8 greedy tokens, whose prefill
                  must launch ``gmm`` exactly 84 times (gate, up and down of
                  28 layers: the expert capacity 1,920 is a multiple of 128)
                  and the flash forward 28 times, then 4 x 512 -> 8 (capacity
                  240: no ``gmm`` launch, the experts take einsum as in the
                  JAX package; 28 flash launches); no decode step launches
                  either kernel. Then the 4 x 4096 prefill once more with the
                  kernel held against its plain version on each layer's own
                  gate, up and down inputs (the ``GMM_*`` bf16 bounds), and
                  through the plain version: the last-token logits' gap is
                  reported, not held (random weights amplify rounding);
 14. check_ssd    the ``ssd_scan`` kernel against its plain version on the
                  same numpy inputs: float32 at B 2, H 3, S 400, P 32, N 16,
                  chunk 200 and at B 1, H 2, S 512, P = N = 64, chunk 256;
                  bfloat16 (the tensor-core kernel) at zamba2-7b's serving
                  shapes (B 4, H 112, P = N = 64: S 4096 at chunk 256, and
                  S 200 at chunk 200), at B 2, H 3, S 144, P 32, N 16,
                  chunk 72 (a partial row sub-tile, P and N zero-filled,
                  two chunks) and at B 1, H 2, S 96, P 12, N 20, chunk 48
                  (x, B and C copied by cp.async, not TMA); y and the
                  float32 state held within ``SSD_*`` below, two launches
                  bitwise equal;
 15. serve_hybrid the hybrid serving path, ``repro_torch.launch.serve.serve``
                  on zamba2-7b at its published size in bfloat16 (random
                  weights from a seeded ``torch.Generator`` on the card): 4
                  prompts x 4096 tokens -> 8 greedy tokens, whose prefill
                  must launch ``ssd_scan`` exactly 81 times (once per Mamba2
                  block, chunk 256) and the flash forward 9 times (the shared
                  attention), then 4 x 200 -> 8 (chunk 200: 81 ``ssd_scan``
                  launches, no flash launch, 200 not being a multiple of
                  128); no decode step launches either kernel. Then the 4 x
                  4096 prefill once more with the scan held against its
                  plain version on each of the 81 layers' own inputs (the
                  ``SSD_*`` bf16 bounds) and the flash forward (D 112) on
                  each of the 9 shared attentions' own q, k, v (the
                  ``FLASH_*`` bf16 bounds), and through the scan's plain
                  version: the last-token logits' gap is reported, not held
                  (random weights amplify rounding);
 16. check_wkv    the ``wkv6_scan`` kernel against its plain version on the
                  same numpy inputs: float32 (the CUDA-core kernel) at BH
                  6, S 384, c 64, chunk 64; at BH 6, S 120, c 16, chunk 24
                  (the smoke head size, a chunk below 64); under strong
                  decay (about -150 per step); bfloat16 (the tensor-core
                  kernel) at rwkv6-3b's forward shape (BH 160, S 4096, c
                  64, chunk 64), at c 16, chunk 24 and under strong decay;
                  y and the float32 state held within ``WKV_*`` below, two
                  launches bitwise equal;
 17. forward_rwkv the scoring and loss path, ``repro_torch.models.forward``
                  on rwkv6-3b at its published size in bfloat16 (random
                  weights from a seeded ``torch.Generator`` on the card),
                  under ``torch.no_grad()``: 4 x 4096 tokens and 4 x 200
                  (padded to a scan of 256), each launching ``wkv6_scan``
                  exactly 32 times (once per time-mix block), finite logits,
                  the cross-entropy against the shifted tokens reported;
                  then the 4 x 4096 forward once more with the kernel held
                  against its plain version on each of the 32 layers' own
                  inputs (the ``WKV_*`` bf16 bounds), and through the plain
                  version: the logits' gap is reported, not held (random
                  weights amplify rounding);
 18. serve_rwkv   the RWKV6 serving path, ``repro_torch.launch.serve.serve``
                  on rwkv6-3b: 4 x 4096 -> 8 and 4 x 200 -> 8. As in the JAX
                  package, prefill runs ``wkv_chunked`` (plain PyTorch) from
                  the cache's state and decode the O(1) recurrence, so no
                  ``wkv6_scan`` launch at all (held at 0); finite tokens, and
                  the WKV state left finite in the compute type (bf16);
 19. timing       CUDA-event medians of every kernel and its plain version:
                  the learners at N = 1 and N = 1024 (the plain learner
                  at N = 1,024 over ``PLAIN_TIMED_RUNS`` = 5 runs; the
                  episode's plain version at N = 1 only, over the kernel's
                  30 steps; the episode's pre-draw timed apart; at N = 1
                  beside a latency floor: each dependent phase's longest
                  FMA chain times the FMA latency plus a barrier), the flash
                  forward at the serving shapes of Yi-9B, zamba2-7b and
                  deepseek-moe-16b beside PyTorch's
                  ``scaled_dot_product_attention`` on the same tensors (with
                  its TFLOP/s, its share of the bound and its ratio to
                  SDPA), the flash forward, dq and dk/dv (the tensor-core
                  kernels) at the training shape beside SDPA's forward and
                  backward, with their TFLOP/s, share of the bound and ratio
                  to SDPA's backward, ``gmm`` at the
                  two MoE serving shapes beside ``torch.bmm`` (with its
                  TFLOP/s, its share of the bound and its ratio to
                  ``torch.bmm``),
                  ``ssd_scan`` at zamba2-7b's serving shape and
                  ``wkv6_scan`` at rwkv6-3b's forward shape (each with the
                  operations its tensor-core kernel issues; no PyTorch
                  call computes either scan); each beside the bound from
                  the shapes.

Then the whole run's seconds and each phase's (``per_phase_seconds``;
each phase's seconds also go to the standard error as it ends), the
``{"kernels": [...]}`` line,
``nvidia-smi``'s line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
It exits non-zero, printing no result, where no CUDA device exists or where
the repository's ``src/repro_torch`` is not beside it.

Phases 1-7b and 8-18 and the matching timings are the earlier slices';
phase 7c is the guardrails', 7d resilience's and 7e sharing's, whose paths
launch ``ddpg_learn`` once per step per chunk (its counts in the
``kernels`` line's ``launches_by_path`` under ``guarded``, ``resilient``
and ``shared``).

    python3 chip_smoke.py --profile

instead builds the kernels and profiles the serving path of Yi-9B
(``torch.profiler``): per request, one prefill and 3 decode steps, with
the device's busy share and the time of each kernel.

    python3 chip_smoke.py --profile-train

instead builds the kernels and profiles one training step of
phi4-mini-3.8b at the ``train`` phase's size (after one untimed step):
the device's busy share and the device time of the flash kernels, the
cuBLAS products and the rest.

    python3 chip_smoke.py --drift

instead builds the kernels and prints, after each of 30 steps of 64
sessions per space, how far the learner and the replay window of the
episode kernel and of the plain version on the CPU are from the plain
version on the card, over the sessions whose decisions agree so far: the
learning itself amplifies rounding, so the learner is held at T = 30 by
neither.

    python3 chip_smoke.py --layer-steps

instead builds the kernels and times the guarded and the resilient fleet
step of 1,024 sessions (``phase_layer_steps``), to compare two trees'
per-step bodies in one call.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: kernel vs plain version, per session: the largest max|kernel - plain| /
#: max|plain| over its float tensors. The median session must stay within
#: RTOL and the 90th percentile within RTOL_P90. A few sessions diverge far
#: more: a ReLU input or an Adam gradient within rounding of 0 flips sign,
#: which the JAX package and the port's plain version show between each
#: other on the CPU too (PERF.md, "Parity bounds").
RTOL = 1e-5
RTOL_P90 = 1e-4
#: episode kernel vs plain version, per session: the largest
#: max|kernel - plain| / max|plain| over the trace (metrics, rewards,
#: objectives) at the steps before the first differing decision. The median
#: session must stay within EP_RTOL and the 90th percentile within
#: EP_RTOL_P90 (measured on an H100: median 1.1e-7, p90 1.8e-7, worst
#: 3.0e-7; PERF.md).
EP_RTOL = 1e-6
EP_RTOL_P90 = 1e-5
#: the learner held: LEARN_STEPS steps of 64 sessions whose windows start
#: with LEARN_PREFILL random rows; per session the largest
#: max|kernel - plain| / max|plain| over the learner's tensors after the
#: episode (median within LEARN_RTOL, p90 within LEARN_RTOL_P90) and over
#: the window's s, a, r, s2 (WINDOW_RTOL, WINDOW_RTOL_P90). Measured on an
#: H100: learner median 5.9e-6 / 8.5e-6 (2-D / 8-D), p90 3.6e-5 / 3.5e-5;
#: the plain version on the CPU is as far from the plain version on the
#: card (PERF.md). Longer episodes are not held: the learning amplifies
#: rounding (``--drift``).
LEARN_STEPS = 2
LEARN_PREFILL = 63
LEARN_RTOL = 1e-4
LEARN_RTOL_P90 = 1e-3
WINDOW_RTOL = 1e-6
WINDOW_RTOL_P90 = 1e-5
#: the scan tuner on the card vs its CPU replay: the largest
#: max|card - cpu| / max|cpu| over the replay windows' s, a, r, s2 rows of
#: the warmup steps
TUNE_WINDOW_RTOL = 1e-5
EP_STEPS = 30
#: timed runs of the plain learner at N = 1,024 (20 before; ~1 s
#: each on the card)
PLAIN_TIMED_RUNS = 5
WARMUP_STEPS = 8
#: a dependent float32 FMA's latency on Hopper, and one __syncthreads of
#: the learners' 512-thread block on an H100 (clock64 around 1,000 of them),
#: in cycles: the learners' latency floor
FMA_LATENCY_CYCLES = 4
BARRIER_CYCLES = 45
#: published H100 SXM peaks (FP32 FLOP/s, HBM3 bytes/s)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED_SESSIONS = 1024
UPDATES = 96
CAPACITY = 64
#: published H100 SXM dense bf16 tensor-core rate (FLOP/s)
PEAK_BF16_FLOPS = 989e12
#: flash kernel vs its plain version on the same inputs (measured on an
#: H100 before they were pinned; PERF.md): out and lse as
#: max|kernel - plain| / max|plain| (bfloat16 out within FLASH_BF16_RTOL,
#: half a bf16 step of the largest value), and for bfloat16 the share of
#: the elements further apart than one bf16 step of the plain value
#: (FLASH_BF16_OFF_SHARE: only values near 0, where the float32
#: accumulation's cancellation error exceeds their own step, may be)
FLASH_F32_RTOL = 1e-5
FLASH_LSE_RTOL = 1e-5
FLASH_BF16_RTOL = 2.0 ** -8
FLASH_BF16_OFF_SHARE = 1e-3
#: (dtype, (B, S, H, Kv, D), causal): the serving shapes in bf16, then a
#: small float32 GQA shape both ways
FLASH_CASES = (("bfloat16", (4, 512, 32, 4, 128), True),
               ("bfloat16", (1, 4096, 32, 4, 128), True),
               ("bfloat16", (4, 4096, 32, 32, 112), True),
               ("float32", (2, 256, 8, 2, 64), True),
               ("float32", (2, 256, 8, 2, 64), False))
#: the serving requests: (batch, prompt tokens, generated tokens)
SERVE_REQUESTS = ((4, 512, 32), (1, 4096, 8))
SERVE_ARCH = "yi-9b"
SERVE_SEED = 0
#: flash backward kernels (dq; dk and dv) vs their plain version on the
#: same inputs, as max|kernel - plain| / max|plain| of each of dq, dk, dv
#: (float32 within FLASH_BWD_F32_RTOL; bfloat16 within FLASH_BWD_BF16_RTOL
#: and at most FLASH_BWD_BF16_OFF_SHARE of the elements further apart than
#: one bf16 step of the plain value: ds = p (dp - delta) cancels, so small
#: gradients carry the float32 summation-order error of the large ones)
FLASH_BWD_F32_RTOL = 1e-5
FLASH_BWD_BF16_RTOL = 2.0 ** -8
FLASH_BWD_BF16_OFF_SHARE = 1e-3
#: the second step of a fresh training run (``second_step_layers``): held
#: at one bf16 step of the largest value (2^-7, the bound of gmm, ssd_scan
#: and the host-model tests) with the same share. For a bf16 value in the
#: largest value's binade [2^e, 2^(e+1)) one step is 2^(e-7): more than
#: 2^-8 of the largest value and at most 2^-7 of it, so one element of that
#: binade rounded the other way, which any order of sums other than the
#: plain version's may give, can miss 2^-8 but never 2^-7
FLASH_BWD_STEP2_RTOL = 2.0 ** -7
#: (dtype, (B, S, H, Kv, D), causal): the training shape of phi4-mini-3.8b
#: in bf16, then a small float32 GQA shape both ways, then the same small
#: shape in bf16 both ways and a bf16 shape whose 128-row blocks run past
#: Sq and Sk (S 192) with the head dim zero-filled (D 112)
FLASH_BWD_CASES = (("bfloat16", (2, 2048, 24, 8, 128), True),
                   ("float32", (2, 256, 8, 2, 64), True),
                   ("float32", (2, 256, 8, 2, 64), False),
                   ("bfloat16", (2, 256, 8, 2, 64), True),
                   ("bfloat16", (2, 256, 8, 2, 64), False),
                   ("bfloat16", (1, 192, 6, 2, 112), True))
#: the training run: phi4-mini-3.8b at its published size, a batch of 2
#: sequences of 2048 tokens, 4 steps of AdamW through the Trainer
TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_BATCH = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 4
TRAIN_SEED = 0
#: gmm kernel vs its plain version on the same inputs, as
#: max|kernel - plain| / max|plain| (float32 within GMM_F32_RTOL; bfloat16
#: within GMM_BF16_RTOL, one bf16 step of the largest value, and at most
#: GMM_BF16_OFF_SHARE of the elements further apart than one bf16 step of
#: the plain value: the two sum the same exact products in another float32
#: order, so after the one rounding to bf16 a few elements land on the
#: neighbouring value, and sums that cancel to near 0 carry the order's
#: error of the large terms). Measured on an H100 before they were pinned
#: (PERF.md): float32 6.4e-7; bf16 5.5e-3 and 1.5e-5 of the elements
#: over one step at the serving shapes, 5.6e-3 and 1.3e-5 on the 84
#: products of a deepseek-moe-16b prefill
GMM_F32_RTOL = 1e-5
GMM_BF16_RTOL = 2.0 ** -7
GMM_BF16_OFF_SHARE = 1e-3
#: (dtype, (E, C, D, F)): deepseek-moe-16b's two serving products at 4 x
#: 4096 tokens (gate / up, then down) in bf16, a small float32 shape whose
#: D is a multiple of 128 but not of 512, then a bf16 shape whose tiles of
#: 128 x 128 x 64 run past C, F and D
GMM_CASES = (("bfloat16", (64, 1920, 2048, 1408)),
             ("bfloat16", (64, 1920, 1408, 2048)),
             ("float32", (4, 256, 640, 384)),
             ("bfloat16", (3, 192, 160, 192)))
#: the MoE serving requests: (batch, prompt tokens, generated tokens). At
#: 4 x 4096 the expert capacity C is 1,920, a multiple of 128: the experts
#: run through gmm (3 launches per layer); at 4 x 512 C is 240 and they
#: take einsum, as in the JAX package
MOE_REQUESTS = ((4, 4096, 8), (4, 512, 8))
MOE_ARCH = "deepseek-moe-16b"
MOE_SEED = 0
#: ssd_scan kernel vs its plain version on the same inputs, as
#: max|kernel - plain| / max|plain|: y in float32 within SSD_F32_RTOL; y in
#: bfloat16 within SSD_BF16_RTOL (one bf16 step of the largest value) with
#: at most SSD_BF16_OFF_SHARE of the elements further apart than one bf16
#: step of the plain value (the two sum the same float32 products in
#: another order, and y rounds once to bf16); the float32 state within
#: SSD_STATE_RTOL, and within SSD_BF16_STATE_RTOL after a bf16 scan: the
#: tensor-core kernel's three bf16 terms of x w and of the carried state
#: keep it within 3.2e-7 on zamba2-7b's 81 layers, where two terms each
#: read 2.1e-6-6.4e-6 and pass the y bounds
SSD_F32_RTOL = 1e-5
SSD_BF16_RTOL = 2.0 ** -7
SSD_BF16_OFF_SHARE = 1e-3
SSD_STATE_RTOL = 1e-5
SSD_BF16_STATE_RTOL = 1e-6
#: (dtype, (B, H, S, P, N, chunk)): small float32 shapes (an odd chunk; N =
#: P = 64), then zamba2-7b's prefill of 4 x 4096 tokens and of 4 x 200
#: (chunk 200) in bf16, and bf16 edge cases: two chunks of 72 (a partial
#: row sub-tile, N and P below 64); P 12 and N 20, rows that are not a
#: multiple of 16 bytes, which the kernel copies by cp.async, not TMA
SSD_CASES = (("float32", (2, 3, 400, 32, 16, 200)),
             ("float32", (1, 2, 512, 64, 64, 256)),
             ("bfloat16", (4, 112, 4096, 64, 64, 256)),
             ("bfloat16", (4, 112, 200, 64, 64, 200)),
             ("bfloat16", (2, 3, 144, 32, 16, 72)),
             ("bfloat16", (1, 2, 96, 12, 20, 48)))
#: the hybrid serving requests: (batch, prompt tokens, generated tokens).
#: At 4 x 4096 the scans run at chunk 256 and the shared attention takes
#: the flash path; at 4 x 200 the scans run at chunk 200 and the attention
#: takes the plain reference path (200 is not a multiple of 128)
HYBRID_REQUESTS = ((4, 4096, 8), (4, 200, 8))
HYBRID_ARCH = "zamba2-7b"
HYBRID_SEED = 0
#: wkv6_scan kernel vs its plain version on the same inputs, as
#: max|kernel - plain| / max|plain|: y in float32 within WKV_F32_RTOL; y in
#: bfloat16 within WKV_BF16_RTOL (one bf16 step of the largest value) with
#: at most WKV_BF16_OFF_SHARE of the elements further apart than one bf16
#: step of the plain value (the two sum the same float32 products in
#: another order, and y rounds once to bf16); the float32 state within
#: WKV_STATE_RTOL, and within WKV_BF16_STATE_RTOL after a bf16 scan: the
#: tensor-core kernel's three bf16 terms of the chunk's states keep it
#: within 1e-6 on rwkv6-3b's 32 layers, where two terms pass the y bounds
#: and put it over 1e-6 (PERF.md)
WKV_F32_RTOL = 1e-5
WKV_BF16_RTOL = 2.0 ** -7
WKV_BF16_OFF_SHARE = 1e-3
WKV_STATE_RTOL = 1e-5
WKV_BF16_STATE_RTOL = 1e-6
#: (dtype, (BH, S, c, chunk, w0)), logw = -exp(clip(N(0, 1) + w0, -8, 6)):
#: small float32 shapes (rwkv6-3b's head size and chunk; the smoke head
#: size at a chunk below 64; strong decay, about -150 per step), then
#: rwkv6-3b's forward of 4 x 4096 tokens in bf16 (40 heads of 64, chunk 64;
#: WKV_TIMED), then bf16 at the smoke head size and chunk and under strong
#: decay
WKV_CASES = (("float32", (6, 384, 64, 64, 0.0)),
             ("float32", (6, 120, 16, 24, 0.0)),
             ("float32", (4, 256, 64, 64, 5.0)),
             ("bfloat16", (160, 4096, 64, 64, 0.0)),
             ("bfloat16", (6, 120, 16, 24, 0.0)),
             ("bfloat16", (4, 256, 64, 64, 5.0)))
WKV_TIMED = WKV_CASES[3]
#: the SFUs' exps a clock per SM (one exp per pair and channel alone bounds
#: a kernel that takes it so: ``phase_timing_wkv``'s ``sfu_floor_ms``)
SFU_EXPS_PER_CLOCK_PER_SM = 16
#: the RWKV6 forward passes (batch, tokens): at 4 x 200 the time mix pads
#: the sequence to 256, a multiple of the chunk 64
RWKV_FORWARD = ((4, 4096), (4, 200))
#: the RWKV6 serving requests: (batch, prompt tokens, generated tokens)
RWKV_REQUESTS = ((4, 4096, 8), (4, 200, 8))
RWKV_ARCH = "rwkv6-3b"
RWKV_SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuobjdump(name: str, flag: str) -> str:
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(build._target(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def kernel_build(log: dict, name: str, kernel: str) -> dict:
    """The kernel ``kernel`` of ``csrc/<name>.cu`` as built, read from its
    library in every run by ``cuobjdump -res-usage``: its registers, its
    stack and local bytes (a spill would show there) and its ``SHARED``
    bytes; beside them its ``ptxas`` lines where this run compiled it (None
    where the library was built before). Raises unless the kernel is found
    with no stack or local bytes."""
    import re

    usage = None
    lines = cuobjdump(name, "-res-usage").splitlines()
    for head, body in zip(lines, lines[1:]):
        if head.strip().startswith("Function") and kernel in head:
            usage = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", body)}
    if usage is None:
        raise AssertionError(f"cuobjdump -res-usage finds no {kernel} in "
                             f"the library of {name}")
    ptxas = None
    text = log.get(name, {}).get("ptxas", "")
    for entry in text.split("Compiling entry function")[1:]:
        if kernel in entry.splitlines()[0]:
            ptxas = [ln.strip() for ln in entry.splitlines()
                     if "spill" in ln or "registers" in ln]
    facts = {"registers": usage.get("REG"),
             "local_bytes": usage.get("STACK", 0) + usage.get("LOCAL", 0),
             "cuobjdump_shared_bytes": usage.get("SHARED", 0), "ptxas": ptxas}
    if facts["local_bytes"]:
        raise AssertionError(f"{kernel} uses stack or local memory "
                             f"(spills): {usage}")
    return facts


def tc_build(log: dict, name: str, kernel: str) -> dict:
    """``kernel_build`` of a tensor-core kernel, with the count of ``HGMMA``
    instructions in its own SASS. Raises unless it has at least one."""
    hgmma, inside = 0, False
    for line in cuobjdump(name, "-sass").splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "HGMMA" in line:
            hgmma += 1
    if hgmma == 0:
        raise AssertionError(f"{kernel} has no HGMMA instruction: its bf16 "
                             f"products are not on the tensor cores")
    facts = kernel_build(log, name, kernel)
    return {"registers": facts["registers"],
            "local_bytes": facts["local_bytes"], "hgmma": hgmma,
            "ptxas": facts["ptxas"]}


def learner_build(log: dict, configs: dict, n_samples: int) -> dict:
    """``kernel_build`` of the two learner kernels, with the shared memory
    a block of each holds once opted into each space's ``smem_plan`` (its
    static and dynamic bytes as the runtime reports them), held equal to
    the plan's total: the whole learner state resident, nothing beside it.
    (``cuobjdump``'s ``SHARED`` of every kernel of the port reads 1,024:
    the block's reserved kilobyte on sm_90, which no plan counts.)"""
    from repro_torch.kernels import build
    from repro_torch.kernels import ddpg_learn as dl
    from repro_torch.kernels import episode_learn as el

    out = {}
    for name, module in (("ddpg_learn", dl), ("episode_learn", el)):
        facts = kernel_build(log, name, f"{name}_kernel")
        lib = module._bind(build.load(name))
        facts["shared_bytes"], facts["smem_plan_total"] = {}, {}
        for space, cfg in configs.items():
            plan = dl.smem_plan(cfg) if module is dl else el.smem_plan(
                cfg.state_dim, cfg.action_dim, cfg.hidden, cfg.batch_size,
                CAPACITY, n_samples)
            got = getattr(lib, f"{name}_shared_bytes")(plan["total"])
            facts["shared_bytes"][space] = got
            facts["smem_plan_total"][space] = plan["total"]
            if got != plan["total"]:
                raise AssertionError(
                    f"{name}_kernel holds {got} B of shared memory per block "
                    f"on {space}, its smem_plan {plan['total']} B")
        out[f"{name}_kernel"] = facts
    return out


def learner_floor_ms(cfg, updates: int, steps: int = 0) -> float:
    """A latency floor of one session's launch: the dependent phases of one
    update (``csrc/ddpg_update.cuh``, P0-P17), each its longest FMA chain
    times the FMA latency plus one barrier, times the updates; for an
    episode (``steps`` > 0) per step also the act forward's three phases and
    the env step's barrier. At the card's highest SM clock."""
    k, m, b, h = cfg.state_dim, cfg.action_dim, cfg.batch_size, \
        cfg.hidden[0]
    kc = k + m
    chains = [0, kc, h, h, kc, h, h, 0, h, b, kc, h, h, h, h, m, h, b]
    update = sum(c * FMA_LATENCY_CYCLES + BARRIER_CYCLES for c in chains)
    cycles = updates * update
    if steps:
        act = sum(c * FMA_LATENCY_CYCLES + BARRIER_CYCLES for c in (k, h, h))
        cycles = steps * (act + BARRIER_CYCLES + cycles)
    return cycles / sm_clock_max_hz() * 1e3


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def fleet_inputs(cfg, n: int, seed: int, device):
    """N independent learners (``ddpg_init`` of keys seed..seed+N-1) and the
    [N, U, B, .] minibatches of a 64-row replay per session."""
    import numpy as np
    import torch

    from repro_torch import random as jrandom
    from repro_torch.core.ddpg import DDPGState, ddpg_init

    states = [ddpg_init(jrandom.PRNGKey(seed + i), cfg, "cpu")
              for i in range(n)]
    state = DDPGState(*(torch.stack(xs).to(device) for xs in zip(*states)))
    rng = np.random.default_rng(seed)
    k, m = cfg.state_dim, cfg.action_dim
    replay = [rng.random((n, CAPACITY, k)), rng.random((n, CAPACITY, m)),
              rng.standard_normal((n, CAPACITY)), rng.random((n, CAPACITY, k))]
    idx = torch.as_tensor(rng.integers(0, CAPACITY, (n, UPDATES,
                                                     cfg.batch_size)))
    rows = torch.arange(n)[:, None, None]
    batches = tuple(
        torch.as_tensor(x, dtype=torch.float32)[rows, idx].contiguous()
        .to(device) for x in replay)
    return state, batches


def clone_state(state):
    from repro_torch.core.ddpg import DDPGState
    return DDPGState(*(t.clone() for t in state))


def compare(state, metrics, ref_state, ref_metrics, cfg) -> dict:
    """Counts and steps must be equal. Per session, the error is the largest
    ``max|a - b| / max|b|`` over its float tensors (each w/b of the eight
    parameter sets, and each metric column); returns the quantiles of that
    error over sessions and the largest absolute difference."""
    import torch

    if not torch.equal(state.counts, ref_state.counts):
        raise AssertionError("Adam counts differ from the plain version")
    if not torch.equal(state.step, ref_state.step):
        raise AssertionError("learner steps differ from the plain version")
    if not (bool(torch.isfinite(state.flat).all())
            and bool(torch.isfinite(metrics).all())):
        raise AssertionError("kernel produced a non-finite value")
    pairs = learner_pairs(state.flat, ref_state.flat, cfg)
    pairs += [(metrics[..., j], ref_metrics[..., j]) for j in range(3)]
    rel, abs_err = session_errors(pairs)
    return {"max_abs_err": abs_err, **quantiles(rel)}


def learner_pairs(flat, ref_flat, cfg) -> list:
    """(got, want) of each w and b of the learner's eight parameter sets."""
    from repro_torch.core.ddpg import unflatten

    got, want = unflatten(flat, cfg), unflatten(ref_flat, cfg)
    return [(g[key], w[key]) for name in got
            for g, w in zip(got[name], want[name]) for key in ("w", "b")]


def session_errors(pairs) -> tuple:
    """Per session (the leading axis), the largest ``max|a - b| / max|b|``
    over the pairs, as a float64 tensor; and the largest ``|a - b|``."""
    import torch

    n = pairs[0][1].shape[0]
    rel = torch.zeros(n, dtype=torch.float64, device=pairs[0][1].device)
    abs_err = 0.0
    for g, w in pairs:
        diff = (g - w).abs().reshape(n, -1).amax(dim=1).double()
        scale = w.abs().reshape(n, -1).amax(dim=1).double().clamp_min(1e-30)
        rel = torch.maximum(rel, diff / scale)
        abs_err = max(abs_err, float(diff.max()))
    return rel, abs_err


def quantiles(rel, prefix: str = "") -> dict:
    """Median, 90th percentile and maximum of per-session errors."""
    import torch

    q = torch.quantile(rel, torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64,
                                         device=rel.device)).tolist()
    return {f"{prefix}median_rel_err": q[0], f"{prefix}p90_rel_err": q[1],
            f"{prefix}max_rel_err": q[2]}


def episode_inputs(space: str, n: int, seed: int, device, steps=EP_STEPS,
                   prefill: int = 0):
    """Operands of N independent sessions' first episode on one space:
    session i has env seed and agent seed ``seed + i``, its own warmup plan
    and OU noise, a fresh learner, a 64-row replay window holding
    ``prefill`` random transitions (empty by default) and the normalized
    default-config metrics as its starting state."""
    import numpy as np
    import torch

    from repro_torch.core import DDPGConfig, MagpieAgent, Scalarizer
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.core.episode import BufferState, EpisodeCarry, \
        _consume_exploration
    from repro_torch.core.scalarization import metric_bounds, \
        normalize_state
    from repro_torch.envs import LustreSimEnv, LustreSimV2
    from repro_torch.envs.lustre_model import LustreEnvState
    from repro_torch.kernels.episode_learn import EpisodeKernelSpec, \
        EpisodeOperands

    env_cls = LustreSimEnv if space == "2d" else LustreSimV2
    envs = [env_cls("seq_write", seed=seed + i).to_model_env(device=device)
            for i in range(n)]
    cfg = DDPGConfig.for_env(envs[0])
    agents = [MagpieAgent(cfg, seed=seed + i, buffer_capacity=CAPACITY,
                          device=device) for i in range(n)]
    scal = Scalarizer(weights={"throughput": 1.0},
                      specs=envs[0].metric_specs)
    lo, span = metric_bounds(envs[0].metric_specs, envs[0].state_metrics)
    w_vec = scal.weight_vector(envs[0].state_metrics)
    starts = [env.apply(env.param_space.default_config(), eval_run=True)
              for env in envs]
    xs = [_consume_exploration(a, steps) for a in agents]

    def stack(rows, dtype=torch.float32):
        return torch.as_tensor(np.stack(rows), dtype=dtype, device=device)

    k, m = cfg.state_dim, cfg.action_dim
    rng = np.random.default_rng(seed)
    window = [rng.random((n, CAPACITY, k)), rng.random((n, CAPACITY, m)),
              rng.standard_normal((n, CAPACITY)) * 0.1,
              rng.random((n, CAPACITY, k))]
    live = np.arange(CAPACITY) < prefill
    carry = EpisodeCarry(
        env_state=LustreEnvState(
            key=torch.stack([e.model_state.key for e in envs]),
            warmth=torch.stack([e.model_state.warmth for e in envs]),
            last_values=torch.stack([e.model_state.last_values
                                     for e in envs])),
        ddpg=DDPGState(*(torch.stack(x).contiguous()
                         for x in zip(*[a.state for a in agents]))),
        buffer=BufferState(
            *(stack(x * live.reshape((1, CAPACITY) + (1,) * (x.ndim - 2)))
              for x in window),
            torch.full((n,), prefill % CAPACITY, dtype=torch.int32,
                       device=device),
            torch.full((n,), prefill, dtype=torch.int32, device=device)),
        learn_key=torch.stack([a._learn_key for a in agents]).to(device),
        state_vec=stack([normalize_state(m_, envs[0].metric_specs,
                                         envs[0].state_metrics)
                         for m_ in starts]),
        objective=stack([np.float32(scal.objective(m_)) for m_ in starts]))
    op = EpisodeOperands(
        use_warmup=stack([x[0] for x in xs], torch.bool),
        warmup=stack([x[1] for x in xs]), noise=stack([x[2] for x in xs]),
        w_vec=stack([w_vec] * n), lo=stack([lo] * n), span=stack([span] * n),
        params=torch.stack([e.params.vector() for e in envs]).contiguous(),
        carry=carry)
    spec = EpisodeKernelSpec(model=envs[0].model, cfg=cfg, learn=True,
                             num_updates=cfg.updates_per_step)
    return op, spec


def clone_tree(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(clone_tree(y) for y in x))


def tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(tree_equal(x, y) for x, y in zip(a, b))


def compare_episode(trace, ref) -> dict:
    """Per session, the first step whose knob indices differ (T when none)
    and the largest ``max|a - b| / max|b|`` over the trace's float fields
    at the steps before it; quantiles over sessions."""
    import torch

    n, steps = ref.rewards.shape
    same = (trace.action_idx == ref.action_idx).all(dim=-1)  # [N, T]
    first = torch.where(same.all(dim=1), torch.full((n,), steps,
                                                    device=same.device),
                        (~same).int().argmax(dim=1))
    errs = []
    for i in range(n):
        f = int(first[i])
        err = 0.0
        for a, b in ((trace.metrics, ref.metrics),
                     (trace.rewards, ref.rewards),
                     (trace.objectives, ref.objectives)):
            a, b = a[i, :f].double(), b[i, :f].double()
            if a.numel():
                err = max(err, float((a - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30)))
        errs.append(err)
    firsts = first.tolist()
    return {"first_differing_step": firsts,
            "sessions_never_differing": sum(f == steps for f in firsts),
            "min_first_differing_step": min(firsts),
            **quantiles(torch.tensor(errs, dtype=torch.float64)),
            "max_abs_err": max(
                float((a[i, :firsts[i]] - b[i, :firsts[i]]).abs().max())
                if firsts[i] else 0.0
                for i in range(n)
                for a, b in ((trace.metrics, ref.metrics),
                             (trace.rewards, ref.rewards),
                             (trace.objectives, ref.objectives)))}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_check(configs) -> dict:
    import torch

    from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain

    worst = {"max_abs_err": 0.0, "median_rel_err": 0.0, "p90_rel_err": 0.0,
             "max_rel_err": 0.0}
    for name, cfg in configs.items():
        for n in (1, SEED_SESSIONS):
            state, batches = fleet_inputs(cfg, n, seed=100, device="cuda")
            k1, k2, p = clone_state(state), clone_state(state), \
                clone_state(state)
            m1 = ddpg_learn(k1, batches, cfg=cfg)
            m2 = ddpg_learn(k2, batches, cfg=cfg)
            mp = ddpg_learn_plain(p, batches, cfg=cfg)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2)) and \
                torch.equal(m1, m2)
            if not bitwise:
                raise AssertionError("two launches on the same inputs differ")
            err = compare(k1, m1, p, mp, cfg)
            emit({"phase": "check", "space": name, "sessions": n,
                  "bitwise_repeat": bitwise, "rtol": RTOL,
                  "rtol_p90": RTOL_P90, **err})
            if err["median_rel_err"] > RTOL or err["p90_rel_err"] > RTOL_P90:
                raise AssertionError(
                    f"kernel vs plain: session errors median "
                    f"{err['median_rel_err']} (bound {RTOL}), p90 "
                    f"{err['p90_rel_err']} (bound {RTOL_P90}) ({name}, "
                    f"N={n})")
            for key in worst:
                worst[key] = max(worst[key], err[key])
    return worst


def compare_carry(carry, ref, cfg, held) -> dict:
    """The learner state and the replay window after the episode, kernel
    against plain, over the sessions ``held`` (a bool [N]): quantiles over
    them of each session's largest ``max|a - b| / max|b|`` over the
    learner's tensors, and over the window's s, a, r, s2."""
    import torch

    if not torch.equal(carry.buffer.size, ref.buffer.size):
        raise AssertionError("episode replay sizes differ from the plain "
                             "version")
    learner, _ = session_errors([
        (g[held], w[held])
        for g, w in learner_pairs(carry.ddpg.flat, ref.ddpg.flat, cfg)])
    window, _ = session_errors([
        (g[held], w[held]) for g, w in zip(carry.buffer[:4], ref.buffer[:4])])
    return {"held_sessions": int(held.sum()),
            **quantiles(learner, "learner_"), **quantiles(window, "window_")}


def phase_check_episode() -> dict:
    import torch

    from repro_torch.kernels.episode_learn import episode_learn, \
        episode_learn_plain

    worst = {"max_abs_err": 0.0, "median_rel_err": 0.0, "p90_rel_err": 0.0,
             "max_rel_err": 0.0, "learner_median_rel_err": 0.0,
             "learner_p90_rel_err": 0.0, "window_median_rel_err": 0.0,
             "window_p90_rel_err": 0.0}
    for space in ("2d", "8d"):
        for steps, n, prefill in ((EP_STEPS, 1, 0), (EP_STEPS, 64, 0),
                                  (LEARN_STEPS, 64, LEARN_PREFILL)):
            op, spec = episode_inputs(space, n, seed=300, device="cuda",
                                      steps=steps, prefill=prefill)
            k1, k2, p = clone_tree(op), clone_tree(op), clone_tree(op)
            t1 = episode_learn(k1, spec=spec)
            t2 = episode_learn(k2, spec=spec)
            tp = episode_learn_plain(p, spec=spec)
            torch.cuda.synchronize()
            bitwise = tree_equal(t1, t2) and tree_equal(k1, k2)
            if not bitwise:
                raise AssertionError("two episode launches on the same "
                                     "inputs differ")
            if not all(bool(torch.isfinite(x).all())
                       for x in (t1.metrics, t1.rewards, k1.carry.ddpg.flat)):
                raise AssertionError("episode kernel produced a non-finite "
                                     "value")
            for name, a, b in (("counts", k1.carry.ddpg.counts,
                                p.carry.ddpg.counts),
                               ("step", k1.carry.ddpg.step,
                                p.carry.ddpg.step),
                               ("cursors", k1.carry.buffer.next_slot,
                                p.carry.buffer.next_slot),
                               ("env key", k1.carry.env_state.key,
                                p.carry.env_state.key),
                               ("learn key", k1.carry.learn_key,
                                p.carry.learn_key)):
                if not torch.equal(a, b):
                    raise AssertionError(f"episode {name} differ from the "
                                         f"plain version")
            err = compare_episode(t1, tp)
            held = torch.tensor(err["first_differing_step"],
                                device=t1.rewards.device) == steps
            if bool(held.any()):
                err.update(compare_carry(k1.carry, p.carry, spec.cfg, held))
            held_learner = prefill > 0
            emit({"phase": "check_episode", "space": space, "sessions": n,
                  "steps": steps, "prefilled_rows": prefill,
                  "bitwise_repeat": bitwise, "rtol": EP_RTOL,
                  "rtol_p90": EP_RTOL_P90, "learner_held": held_learner,
                  **err})
            where = f"({space}, T={steps}, N={n})"
            if err["min_first_differing_step"] < min(steps, WARMUP_STEPS):
                raise AssertionError(f"a warmup decision differs from the "
                                     f"plain version {where}")
            if err["median_rel_err"] > EP_RTOL or \
                    err["p90_rel_err"] > EP_RTOL_P90:
                raise AssertionError(
                    f"episode kernel vs plain: session errors median "
                    f"{err['median_rel_err']} (bound {EP_RTOL}), p90 "
                    f"{err['p90_rel_err']} (bound {EP_RTOL_P90}) {where}")
            if held_learner:
                for part, med_tol, p90_tol in (
                        ("learner", LEARN_RTOL, LEARN_RTOL_P90),
                        ("window", WINDOW_RTOL, WINDOW_RTOL_P90)):
                    med = err[f"{part}_median_rel_err"]
                    p90 = err[f"{part}_p90_rel_err"]
                    if med > med_tol or p90 > p90_tol:
                        raise AssertionError(
                            f"episode kernel vs plain: {part} after the "
                            f"episode, median {med} (bound {med_tol}), p90 "
                            f"{p90} (bound {p90_tol}) {where}")
                for key in worst:
                    worst[key] = max(worst[key], err[key])
            else:
                for key in ("max_abs_err", "median_rel_err", "p90_rel_err",
                            "max_rel_err"):
                    worst[key] = max(worst[key], err[key])
    return worst


def phase_drift() -> None:
    """Per step of 30, for 64 sessions per space: the learner's and the
    window's median and 90th-percentile session errors of the episode
    kernel (``kernel_*``) and of the plain version on the CPU (``cpu_*``),
    each against the plain version on the card, over the sessions whose
    decisions have agreed with it so far. The episode runs as 30 launches
    of one step, which continue the same carry."""
    import torch

    from repro_torch.kernels.episode_learn import episode_learn, \
        episode_learn_plain

    def one_step(op, t):
        return op._replace(**{name: getattr(op, name)[:, t:t + 1]
                              .contiguous()
                              for name in ("use_warmup", "warmup", "noise")})

    n = 64
    for space in ("2d", "8d"):
        op, spec = episode_inputs(space, n, seed=300, device="cuda")
        runs = {"kernel": (clone_tree(op), episode_learn),
                "cpu": (tree_map(lambda x: x.cpu(), op),
                        episode_learn_plain)}
        plain = clone_tree(op)
        agree = {name: torch.ones_like(op.carry.objective,
                                       dtype=torch.bool) for name in runs}
        for t in range(EP_STEPS):
            want = episode_learn_plain(one_step(plain, t), spec=spec)
            row = {"phase": "drift", "space": space, "step": t + 1}
            for name, (x, fn) in runs.items():
                got = fn(one_step(x, t), spec=spec)
                agree[name] &= (got.action_idx.cuda()
                                == want.action_idx).all(dim=-1)[:, 0]
                held = agree[name]
                if not bool(held.any()):
                    continue
                carry = tree_map(lambda v: v.cuda(), x.carry)
                err = compare_carry(carry, plain.carry, spec.cfg, held)
                row.update({f"{name}_{key}": v for key, v in err.items()
                            if "median" in key or "p90" in key
                            or key == "held_sessions"})
            emit(row)


def phase_tune_scan(space: str, steps: int) -> dict:
    from repro_torch.core import Scalarizer, Tuner
    from repro_torch.envs import LustreSimEnv, LustreSimV2
    from repro_torch.kernels.ddpg_learn import ddpg_learn
    from repro_torch.kernels.episode_learn import episode_learn

    env_cls = LustreSimEnv if space == "2d" else LustreSimV2

    def tuner(device):
        env = env_cls("seq_write", seed=0).to_model_env(device=device)
        scal = Scalarizer(weights={"throughput": 1.0}, specs=env.metric_specs)
        return Tuner(env, scal, seed=0, engine="scan", device=device)

    import torch

    gpu = tuner(None)
    torch.cuda.synchronize()
    episode_learn.launches = 0
    ddpg_learn.launches = 0
    t0 = time.perf_counter()
    result = gpu.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = episode_learn.launches
    if launches != 1 or ddpg_learn.launches != 0:
        raise AssertionError(f"{space}: one run() launched episode_learn "
                             f"{launches} times and ddpg_learn "
                             f"{ddpg_learn.launches} times")
    for rec in result.history:
        if not all(math.isfinite(v) for v in rec.metrics.values()):
            raise AssertionError(f"{space}: non-finite metrics")
    gain = result.gain("throughput")
    if not math.isfinite(gain) or gain <= 0:
        raise AssertionError(f"{space}: tuning did not improve throughput "
                             f"({gain})")
    replay_steps = 10
    cpu_tuner = tuner("cpu")
    cpu = cpu_tuner.run(replay_steps)
    gpu_cfgs = [h.config for h in result.history[:replay_steps]]
    cpu_cfgs = [h.config for h in cpu.history]
    same = next((i for i, (a, b) in enumerate(zip(gpu_cfgs, cpu_cfgs))
                 if a != b), replay_steps)
    if same <= WARMUP_STEPS:
        raise AssertionError(f"{space}: decisions differ from the CPU replay "
                             f"at step {same}, in the warmup or at the first "
                             f"step after it")
    # step t wrote row t of both windows; after the warmup the actions
    # carry the learner's drift, so only the warmup rows are held
    gpu_rows, _ = gpu.agent.buffer.storage()
    cpu_rows, _ = cpu_tuner.agent.buffer.storage()

    def rows_rel(steps):
        rel, _ = session_errors([(g[None, :steps],
                                  c.to(g.device)[None, :steps])
                                 for g, c in zip(gpu_rows, cpu_rows)])
        return float(rel[0])

    warmup_rel, agreeing_rel = rows_rel(WARMUP_STEPS), rows_rel(same)
    if warmup_rel > TUNE_WINDOW_RTOL:
        raise AssertionError(f"{space}: replay window rows of the warmup "
                             f"differ from the CPU replay's by {warmup_rel} "
                             f"(bound {TUNE_WINDOW_RTOL})")
    default_rel = max(
        abs(result.default_metrics[key] - cpu.default_metrics[key])
        / max(abs(cpu.default_metrics[key]), 1e-30)
        for key in cpu.default_metrics)
    out = {"phase": "tune_scan", "space": space, "steps": steps,
           "run_calls": 1, "kernel_launches": launches,
           "default_throughput": result.default_metrics["throughput"],
           "tuned_throughput": result.best_metrics["throughput"],
           "gain": gain, "best_config": result.best_config,
           "wall_seconds": wall,
           "step_seconds": result.history[0].action_seconds,
           "default_metrics_max_rel_diff_vs_cpu": default_rel,
           "cpu_replay_steps": replay_steps,
           "configs_equal_to_cpu_through_step": same,
           "warmup_rows_rel_err_vs_cpu": warmup_rel,
           "window_rtol": TUNE_WINDOW_RTOL,
           "agreeing_rows_rel_err_vs_cpu": agreeing_rel}
    emit(out)
    return out


def phase_tune(space: str, steps: int) -> dict:
    from repro_torch.core import Scalarizer, Tuner
    from repro_torch.envs import LustreSimEnv, LustreSimV2
    from repro_torch.kernels.ddpg_learn import ddpg_learn

    env_cls = LustreSimEnv if space == "2d" else LustreSimV2

    def tuner(device):
        env = env_cls("seq_write", seed=0)
        scal = Scalarizer(weights={"throughput": 1.0}, specs=env.metric_specs)
        return Tuner(env, scal, seed=0, device=device)

    gpu = tuner(None)
    learn_calls = 0
    agent_learn = gpu.agent.learn

    def counted_learn(*args, **kwargs):
        nonlocal learn_calls
        learn_calls += 1
        return agent_learn(*args, **kwargs)

    gpu.agent.learn = counted_learn
    ddpg_learn.launches = 0
    t0 = time.perf_counter()
    result = gpu.run(steps)
    wall = time.perf_counter() - t0
    launches = ddpg_learn.launches
    if launches != learn_calls or launches == 0:
        raise AssertionError(f"{space}: kernel launched {launches} times for "
                             f"{learn_calls} learn calls")
    for rec in result.history:
        if not all(math.isfinite(v) for v in rec.metrics.values()):
            raise AssertionError(f"{space}: non-finite metrics")
    gain = result.gain("throughput")
    if not math.isfinite(gain) or gain <= 0:
        raise AssertionError(f"{space}: tuning did not improve throughput "
                             f"({gain})")
    # reference on a small input: the same seeds on the CPU (plain learner)
    replay_steps = 10
    cpu = tuner("cpu").run(replay_steps)
    if cpu.default_metrics != result.default_metrics:
        raise AssertionError(f"{space}: default metrics differ from the CPU")
    gpu_cfgs = [h.config for h in result.history[:replay_steps]]
    cpu_cfgs = [h.config for h in cpu.history]
    if gpu_cfgs[:8] != cpu_cfgs[:8]:
        raise AssertionError(f"{space}: warmup decisions differ from the CPU")
    same = next((i for i, (a, b) in enumerate(zip(gpu_cfgs, cpu_cfgs))
                 if a != b), replay_steps)
    learn_s = [h.learn_seconds for h in result.history]
    step_s = [h.action_seconds + h.learn_seconds for h in result.history]
    out = {"phase": "tune", "space": space, "steps": steps,
           "kernel_launches": launches, "learn_calls": learn_calls,
           "default_throughput": result.default_metrics["throughput"],
           "tuned_throughput": result.best_metrics["throughput"],
           "gain": gain, "best_config": result.best_config,
           "wall_seconds": wall,
           "median_step_seconds": statistics.median(step_s),
           "median_learn_seconds": statistics.median(learn_s),
           "cpu_replay_steps": replay_steps,
           "configs_equal_to_cpu_through_step": same,
           "warmup_equal_to_cpu": True}
    emit(out)
    return out


FLEET_WORKLOADS = ("file_server", "video_server", "seq_write", "seq_read")
FLEET_SEEDS = 256  # x 4 workloads: 1,024 sessions
#: (chunk, overlap) of the four schedules the scan fleet runs
FLEET_SCHEDULES = ((None, True), (256, True), (256, False), (300, True))
#: on the 8-D space only the first two schedules run (cut for the run's
#: time; the 2-D space runs all four)
FLEET_SCHEDULES_8D = FLEET_SCHEDULES[:2]
FLEET_SAMPLED = 8
#: steps of the host-engine fleet on 2-D and 8-D (its numpy simulator is
#: ~1.2-1.5 ms a session-step, so 30 steps of 1,024 sessions took a minute
#: a space; 10 before, cut for the run's time)
FLEET_HOST_STEPS = 5
FLEET_HOST_STEPS_8D = 3
#: the allocator's rounding and the small tensors of the final
#: recommendation, beside the plan's chunk and pre-draw bytes
FLEET_PEAK_MARGIN = 64 << 20


def fleet_snapshot(tuner, trace) -> dict:
    """A scan fleet's outputs after a run, on the host: every trace leaf,
    the learner state, the replay window and cursors, the learner keys and
    the env keys."""
    import torch

    agent = tuner.agent
    (s, a, r, s2), sizes = agent.buffer.storage()
    return {"trace": {name: getattr(trace, name)
                      for name in trace._fields},
            "learner": [x.clone() for x in agent.states],
            "window": [x.clone() for x in (s, a, r, s2)],
            "cursors": (agent.buffer._next, int(sizes[0])),
            "learn_keys": agent._learn_keys.clone(),
            "env_keys": torch.stack([e.model.key_of(e.model_state).cpu()
                                     for e in tuner.envs])}


def fleet_rows(snap: dict, rows) -> dict:
    """``fleet_snapshot`` of the sessions ``rows`` only."""
    return {"trace": {k: v[rows] for k, v in snap["trace"].items()},
            "learner": [x[rows] for x in snap["learner"]],
            "window": [x[rows] for x in snap["window"]],
            "cursors": snap["cursors"], "learn_keys": snap["learn_keys"][rows],
            "env_keys": snap["env_keys"][rows]}


def fleet_differences(a: dict, b: dict) -> list:
    """The names of the snapshot parts that are not bitwise equal."""
    import numpy as np
    import torch

    bad = [f"trace.{k}" for k in a["trace"]
           if not np.array_equal(a["trace"][k], b["trace"][k])]
    for part in ("learner", "window"):
        bad += [f"{part}[{i}]" for i, (x, y) in
                enumerate(zip(a[part], b[part])) if not torch.equal(x, y)]
    bad += [part for part in ("learn_keys", "env_keys")
            if not torch.equal(a[part], b[part])]
    if a["cursors"] != b["cursors"]:
        bad.append("cursors")
    return bad


def captured_fleet_run(tuner, steps: int):
    """``tuner.run(steps)`` with the trace of its fleet episode kept:
    (result, trace)."""
    import repro_torch.core.episode as episode

    kept = {}
    run = episode.run_fleet_episode_scan

    def keep(*args, **kwargs):
        kept["trace"] = run(*args, **kwargs)
        return kept["trace"]

    episode.run_fleet_episode_scan = keep
    try:
        result = tuner.run(steps)
    finally:
        episode.run_fleet_episode_scan = run
    return result, kept["trace"]


def same_history(a, b) -> int:
    """The first step whose config, objective or restart seconds differ
    between two ``TuningResult``s (their length when none)."""
    for i, (x, y) in enumerate(zip(a.history, b.history)):
        if (x.config, x.objective, x.restart_seconds) != \
                (y.config, y.objective, y.restart_seconds):
            return i
    return min(len(a.history), len(b.history))


def phase_fleet(space: str, smi: str) -> dict:
    """The fleet runtime on the card (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import DDPGConfig, FleetTuner, Scalarizer, Tuner, \
        fleet_act, last_fleet_run_stats
    from repro_torch.core.ddpg import actor_apply, unflatten
    from repro_torch.envs import LustreSimEnv, LustreSimV2
    from repro_torch.kernels.ddpg_learn import ddpg_learn
    from repro_torch.kernels.episode_learn import episode_learn

    env_cls = LustreSimEnv if space == "2d" else LustreSimV2
    objective = [{"throughput": 1.0}]
    grid = (list(FLEET_WORKLOADS), objective, list(range(FLEET_SEEDS)))
    sessions = len(FLEET_WORKLOADS) * FLEET_SEEDS
    out = {"phase": "fleet", "space": space, "sessions": sessions,
           "steps": EP_STEPS, "card": smi}

    # 1. the scan fleet under four schedules, bitwise equal
    runs, mono = [], None
    schedules = FLEET_SCHEDULES if space == "2d" else FLEET_SCHEDULES_8D
    host_steps = FLEET_HOST_STEPS if space == "2d" else FLEET_HOST_STEPS_8D
    for chunk, overlap in schedules:
        t0 = time.perf_counter()
        tuner = FleetTuner.from_grid(*grid, env_cls=env_cls, engine="scan",
                                     chunk=chunk, overlap=overlap)
        build_s = time.perf_counter() - t0
        if mono is None:
            plan = tuner.memory_plan(steps=EP_STEPS)
            if not plan["matches_live"]:
                raise AssertionError(f"{space}: memory_plan does not match "
                                     f"the live tensors: {plan}")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        episode_learn.launches = 0
        ddpg_learn.launches = 0
        t0 = time.perf_counter()
        result, trace = captured_fleet_run(tuner, EP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        stats = last_fleet_run_stats()
        want = -(-sessions // (chunk or sessions))
        if episode_learn.launches != want or ddpg_learn.launches != 0:
            raise AssertionError(
                f"{space} chunk {chunk}: episode_learn launched "
                f"{episode_learn.launches} times (want {want}), ddpg_learn "
                f"{ddpg_learn.launches}")
        if stats["padded_sessions"] != 0:
            raise AssertionError(f"{space}: padded sessions")
        snap = fleet_snapshot(tuner, trace)
        row = {"chunk": chunk, "overlap": overlap,
               "launches": episode_learn.launches,
               "build_seconds": build_s,
               "default_eval_seconds": tuner.timings["default_eval"],
               "run_seconds": wall, "step_seconds": wall / EP_STEPS,
               "session_steps_per_second": sessions * EP_STEPS / wall,
               "launch_device_seconds": stats["launch_device_seconds"],
               "prepare_seconds": stats["prepare_seconds"],
               "finish_seconds": stats["finish_seconds"],
               "staging": stats["staging"],
               "episode_seconds": tuner.timings["episode"],
               "replay_seconds": tuner.timings["replay"],
               "final_seconds": tuner.timings["final"],
               "peak_device_bytes": peak,
               "sampled_peak_device_bytes": stats["peak_device_bytes"]}
        if mono is None:
            mono, mono_result = snap, result
            bound = plan["chunk_device_bytes"] + \
                plan["predraw_transient_bytes"] + FLEET_PEAK_MARGIN
            if peak > bound:
                raise AssertionError(
                    f"{space}: the monolithic run's peak {peak} B is over "
                    f"the plan's {plan['chunk_device_bytes']} B + pre-draw "
                    f"{plan['predraw_transient_bytes']} B + margin")
            row.update(plan_chunk_device_bytes=plan["chunk_device_bytes"],
                       plan_predraw_transient_bytes=plan[
                           "predraw_transient_bytes"],
                       peak_bound_bytes=bound,
                       summary=result.summary("throughput"))
            labels, seeds = list(tuner.labels), list(tuner.agent.seeds)
        else:
            bad = fleet_differences(snap, mono)
            if bad:
                raise AssertionError(f"{space} chunk {chunk} overlap "
                                     f"{overlap}: {bad} differ from the "
                                     f"monolithic run")
            if any(same_history(x, y) != EP_STEPS for x, y in
                   zip(result.results, mono_result.results)):
                raise AssertionError(f"{space}: histories differ")
            row["bitwise_equal_to_monolithic"] = True
        runs.append(row)
        del tuner, result, trace, snap
    out["scan"] = runs

    # 2. independence: sampled sessions against fleets of one
    picked = [i * sessions // FLEET_SAMPLED for i in range(FLEET_SAMPLED)]
    for i in picked:
        workload = labels[i].split("|")[0]
        one = FleetTuner.from_grid([workload], objective, [seeds[i]],
                                   env_cls=env_cls, engine="scan")
        _, trace = captured_fleet_run(one, EP_STEPS)
        bad = fleet_differences(fleet_snapshot(one, trace),
                                fleet_rows(mono, [i]))
        if bad:
            raise AssertionError(f"{space}: session {i} ({labels[i]}) "
                                 f"differs from its fleet of one: {bad}")
    out["independent_sessions"] = picked

    # 3. a fleet of one against the single Tuner, both engines; and what
    # one evaluation apply of a single ModelEnv costs (why a fleet's
    # evaluations are batched)
    probe = env_cls("seq_write", seed=0).to_model_env()
    default = probe.param_space.default_config()
    probe.apply(default, eval_run=True)
    applies = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.apply(default, eval_run=True)
        applies.append(time.perf_counter() - t0)
    out["model_env_apply_seconds"] = statistics.median(applies)
    for engine in ("host", "scan"):
        seed = 5
        env = env_cls("seq_write", seed=seed)
        if engine == "scan":
            env = env.to_model_env()
        single = Tuner(env, Scalarizer(weights=dict(objective[0]),
                                       specs=env.metric_specs),
                       seed=seed, engine=engine).run(EP_STEPS)
        fleet = FleetTuner.from_grid(["seq_write"], objective, [seed],
                                     env_cls=env_cls,
                                     engine=engine).run(EP_STEPS)
        same = same_history(fleet.results[0], single)
        if same != EP_STEPS:
            raise AssertionError(f"{space} {engine}: a fleet of one differs "
                                 f"from the single Tuner at step {same}")
        out[f"fleet_of_one_{engine}_equal_steps"] = same

    # 4. the host engine at 1,024 sessions
    t0 = time.perf_counter()
    host = FleetTuner.from_grid(*grid, env_cls=env_cls, engine="host")
    build_s = time.perf_counter() - t0
    ddpg_learn.launches = 0
    episode_learn.launches = 0
    t0 = time.perf_counter()
    result = host.run(host_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ddpg_learn.launches != host_steps or \
            episode_learn.launches != 0:
        raise AssertionError(f"{space}: the host fleet launched ddpg_learn "
                             f"{ddpg_learn.launches} times in "
                             f"{host_steps} steps")
    if not all(np.isfinite(list(h.metrics.values())).all()
               for r in result.results for h in r.history):
        raise AssertionError(f"{space}: non-finite host fleet metrics")
    summary = result.summary("throughput")
    if not summary["p50"] > 0:
        raise AssertionError(f"{space}: median throughput gain "
                             f"{summary['p50']}")
    # the act's form: every session's action independent of the fleet's
    # width (held), and how many rows a batched product would change
    cfg = DDPGConfig.for_env(host.envs[0])
    flat = host.agent.states.flat
    x = torch.as_tensor(host._states(), device=flat.device)
    rows = min(64, sessions)
    whole = fleet_act(flat, x, cfg)
    alone = torch.cat([fleet_act(flat[i:i + 1], x[i:i + 1], cfg)
                       for i in range(rows)])
    if not torch.equal(whole[:rows], alone):
        raise AssertionError(f"{space}: fleet_act depends on the width")
    with torch.no_grad():
        bmm = actor_apply(unflatten(flat, cfg)["actor"], x[:, None])[:, 0]
        bmm_one = torch.cat([actor_apply(unflatten(flat[i:i + 1], cfg)[
            "actor"], x[i:i + 1, None])[:, 0] for i in range(rows)])
    out["host"] = {"launches": host_steps, "steps": host_steps,
                   "build_seconds": build_s,
                   "default_eval_seconds": host.timings["default_eval"],
                   "run_seconds": wall,
                   "step_seconds": wall / host_steps,
                   "session_steps_per_second":
                       sessions * host_steps / wall,
                   "act_seconds": host.timings["act"],
                   "env_seconds": host.timings["env"],
                   "learn_seconds": host.timings["learn"],
                   "final_seconds": host.timings["final"],
                   "summary": summary}
    out["act_rows_width_dependent"] = {
        "rows": rows, "fleet_act": 0,
        "batched_product": int((bmm[:rows] != bmm_one).any(-1).sum())}
    emit(out)
    return out


#: the service phase: lease width, rounds of steps, tenants that churn
SERVICE_CHUNK = 256
SERVICE_ROUNDS = 3
SERVICE_ROUND_STEPS = 5  # 10 before, cut for the run's time
SERVICE_CHURN = 64


def service_cells() -> list:
    """(workload, seed) of ``FleetTuner.from_grid``'s cells over
    ``FLEET_WORKLOADS`` x ``FLEET_SEEDS`` seeds with one objective: cell
    ``i`` has seed ``s + 1000 i``."""
    return [(w, s + 1000 * (i * FLEET_SEEDS + s))
            for i, w in enumerate(FLEET_WORKLOADS) for s in range(FLEET_SEEDS)]


def churn_tenants(r: int) -> list:
    """(workload, seed) of the 64 tenants that join the churn service at
    boundary ``r``: seeds apart from every grid cell's."""
    return [(FLEET_WORKLOADS[k % len(FLEET_WORKLOADS)], 2_000_000 + 1000 * k)
            for k in range(r * SERVICE_CHURN, (r + 1) * SERVICE_CHURN)]


def result_mismatch(a, b) -> list:
    """The parts of two ``TuningResult``s that are not bitwise equal (the
    wall-clock fields left out)."""
    def records(r):
        return [(h.step, h.config, h.metrics, h.objective, h.reward,
                 h.restart_seconds) for h in r.history]

    bad = ["history"] if records(a) != records(b) else []
    return bad + [f for f in ("best_config", "best_objective",
                              "best_metrics", "default_config",
                              "default_metrics",
                              "simulated_restart_seconds")
                  if getattr(a, f) != getattr(b, f)]


def timed_advance(svc, steps: int) -> dict:
    """``svc.advance(steps)`` with ``episode_learn``'s launches counted
    from 0 (held: ``ceil(active / SERVICE_CHUNK)``), its wall time, its
    peak device memory and the service's ``last_stats``."""
    import torch

    from repro_torch.kernels.episode_learn import episode_learn

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    episode_learn.launches = 0
    t0 = time.perf_counter()
    svc.advance(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = svc.last_stats
    active = stats["sessions"]
    want = -(-active // SERVICE_CHUNK) if steps else 0
    if episode_learn.launches != want:
        raise AssertionError(f"service: {episode_learn.launches} launches "
                             f"of episode_learn for {active} sessions "
                             f"(want {want})")
    boundary = sum(stats["boundary_seconds"].values())
    row = {"steps": steps, "sessions": active,
           "launches": episode_learn.launches, "wall_seconds": wall,
           "boundary_seconds": stats["boundary_seconds"],
           "peak_device_bytes": torch.cuda.max_memory_allocated() - before}
    if steps:
        row.update(step_seconds=(wall - boundary) / steps,
                   session_steps_per_second=stats["session_steps_per_sec"],
                   launch_device_seconds=stats["launch_device_seconds"],
                   staging=stats["staging"])
    return row


def leave_all(svc, sids) -> dict:
    """Every session of ``sids`` leaves at one ``advance(0)``."""
    for sid in sids:
        svc.request_leave(sid)
    return timed_advance(svc, 0)


def churn_round(svc, r: int, batches: list) -> dict:
    """Boundary ``r`` of the churn sequence: the previous 64 tenants leave,
    ``churn_tenants(r)`` join (held: into the freed slots, the lease table
    no longer), then ``advance(SERVICE_ROUND_STEPS)``."""
    objective = {"throughput": 1.0}
    freed = []
    if batches:
        leases = svc.lease_table()
        freed = sorted(leases.index(sid) for sid in batches[-1])
        for sid in batches[-1]:
            svc.request_leave(sid)
    width = len(svc.lease_table())
    batches.append([svc.request_join(w, objective, s)
                    for w, s in churn_tenants(r)])
    row = timed_advance(svc, SERVICE_ROUND_STEPS)
    leases = svc.lease_table()
    if freed and (len(leases) != width or
                  sorted(leases.index(sid) for sid in batches[-1]) != freed):
        raise AssertionError(f"service: boundary {r} did not reuse the "
                             f"freed slots")
    return row


def phase_service(smi: str) -> dict:
    """The persistent ``FleetService`` on the card (see the module
    docstring)."""
    import os
    import tempfile

    import torch

    from repro_torch.core import FleetService, FleetTuner, memory_plan

    objective = {"throughput": 1.0}
    cells = service_cells()
    n = len(cells)
    out = {"phase": "service", "space": "2d", "sessions": n,
           "chunk": SERVICE_CHUNK, "card": smi}

    # (a) all sessions join at the first boundary and leave after the last:
    # the static fleet's bits
    t0 = time.perf_counter()
    static = FleetTuner.from_grid(list(FLEET_WORKLOADS), [objective],
                                  list(range(FLEET_SEEDS)), engine="scan",
                                  chunk=SERVICE_CHUNK).run(EP_STEPS)
    static_s = time.perf_counter() - t0
    svc = FleetService(chunk=SERVICE_CHUNK)
    t0 = time.perf_counter()
    sids = [svc.request_join(w, objective, s) for w, s in cells]
    join_s = time.perf_counter() - t0
    run = timed_advance(svc, EP_STEPS)
    if run["launches"] != -(-n // SERVICE_CHUNK):  # 4
        raise AssertionError(f"service: {run['launches']} launches")
    left = leave_all(svc, sids)
    bad = [(i, result_mismatch(svc.result(sid), want))
           for i, (sid, want) in enumerate(zip(sids, static.results))
           if result_mismatch(svc.result(sid), want)]
    if bad:
        raise AssertionError(f"service: {len(bad)} sessions differ from the "
                             f"static fleet, first {bad[:4]}")
    out["equals_static"] = {"static_fleet_seconds": static_s,
                            "request_join_seconds": join_s,
                            "advance": run, "leave": left,
                            "sessions_bitwise_equal": n}
    env = svc.env_factory(*cells[0])
    plan_args = dict(
        sessions=n + SERVICE_CHURN, steps=SERVICE_ROUND_STEPS,
        chunk=SERVICE_CHUNK, capacity=svc.buffer_capacity,
        env_state_bytes_per_session=sum(x.numel() * x.element_size()
                                        for x in env.model_state),
        n_samples=env.model.n_samples)
    plan = memory_plan(svc.cfg, env.param_space, **plan_args)
    del svc, static

    # (b) churn at every boundary against a quiet service
    quiet = FleetService(chunk=SERVICE_CHUNK)
    q_sids = [quiet.request_join(w, objective, s) for w, s in cells]
    quiet_rows = [timed_advance(quiet, SERVICE_ROUND_STEPS)
                  for _ in range(SERVICE_ROUNDS)]
    quiet_rows.append(leave_all(quiet, q_sids))
    with tempfile.TemporaryDirectory() as ckpt:
        churn = FleetService(chunk=SERVICE_CHUNK, checkpoint_dir=ckpt)
        c_sids = [churn.request_join(w, objective, s) for w, s in cells]
        batches, churn_rows, saved = [], [], []
        for r in range(SERVICE_ROUNDS):
            churn_rows.append(churn_round(churn, r, batches))
            if r < 2:  # (c)'s checkpoints, after the first two advances
                t0 = time.perf_counter()
                path = churn.checkpoint()
                saved.append({
                    "step": churn.total_steps,
                    "seconds": time.perf_counter() - t0,
                    "bytes": sum(f.stat().st_size for f in
                                 pathlib.Path(path).iterdir()),
                    "lease_table": churn.lease_table()})
        churn_rows.append(leave_all(churn, batches[-1] + c_sids))
        want = -(-(n + SERVICE_CHURN) // SERVICE_CHUNK)  # 5, the last 64
        if any(r["sessions"] != n + SERVICE_CHURN or r["launches"] != want
               for r in churn_rows[:SERVICE_ROUNDS]):
            raise AssertionError("service: the churn rounds did not run "
                                 f"{n + SERVICE_CHURN} sessions in {want} "
                                 "launches")
        bad = [i for i, (qs, cs) in enumerate(zip(q_sids, c_sids))
               if result_mismatch(quiet.result(qs), churn.result(cs))]
        if bad:
            raise AssertionError(f"service: churn changed {len(bad)} "
                                 f"survivors, first {bad[:8]}")
        out["churn"] = {"quiet": quiet_rows, "churn": churn_rows,
                        "survivors_bitwise_equal": n,
                        "checkpoints": [{k: v for k, v in s.items()
                                         if k != "lease_table"}
                                        for s in saved],
                        "plan": plan, "plan_bound_bytes":
                            plan["chunk_device_bytes"]
                            + plan["predraw_transient_bytes"]
                            + FLEET_PEAK_MARGIN}
        del quiet

        # (c) resume from the first checkpoint, the same sequence on
        t0 = time.perf_counter()
        resumed = FleetService.restore(ckpt, step=SERVICE_ROUND_STEPS)
        restore_s = time.perf_counter() - t0
        if resumed.total_steps != SERVICE_ROUND_STEPS or \
                resumed.lease_table() != saved[0]["lease_table"]:
            raise AssertionError("service: the restored leases differ")
        again = batches[:1]
        resumed_rows = [churn_round(resumed, r, again)
                        for r in range(1, SERVICE_ROUNDS)]
        if again != batches:
            raise AssertionError("service: the resumed joins got other sids")
        resumed_rows.append(leave_all(resumed, again[-1] + c_sids))
        gone = [sid for b in batches for sid in b] + c_sids
        bad = [sid for sid in gone
               if result_mismatch(churn.result(sid), resumed.result(sid))]
        if bad:
            raise AssertionError(f"service: {len(bad)} resumed sessions "
                                 f"differ, first sids {bad[:8]}")
        del resumed

        # the newest checkpoint corrupted: fallback reaches the one before
        newest = os.path.join(ckpt, sorted(os.listdir(ckpt))[-1],
                              "tensors.pt")
        flat = torch.load(newest, weights_only=True)
        flat[f"sessions/{c_sids[0]}/ddpg/0"][0] += 1.0
        torch.save(flat, newest)
        del flat
        try:
            FleetService.restore(ckpt)
        except IOError as e:
            refused = str(e)
        else:
            raise AssertionError("service: a corrupted checkpoint restored")
        t0 = time.perf_counter()
        back = FleetService.restore(ckpt, fallback=True)
        fallback_s = time.perf_counter() - t0
        if back.total_steps != SERVICE_ROUND_STEPS or \
                back.lease_table() != saved[0]["lease_table"]:
            raise AssertionError(f"service: fallback reached step "
                                 f"{back.total_steps}")
    out["resume"] = {"restore_seconds": restore_s, "rounds": resumed_rows,
                     "sessions_bitwise_equal": len(gone),
                     "corrupted_refused": refused,
                     "fallback_restore_seconds": fallback_s,
                     "fallback_step": back.total_steps}
    out["launches"] = (run["launches"]
                       + sum(r["launches"] for r in quiet_rows)
                       + sum(r["launches"] for r in churn_rows)
                       + sum(r["launches"] for r in resumed_rows))
    emit(out)
    return out


#: the guard phase: the policy of ``examples/tune_fleet.py``'s defaults, the
#: fault scenario of the reference's rollback test, and its sizes
GUARD_POLICY = {"min_gain": 0.01, "rollback_window": 4}
GUARD_FAULT_POLICY = {"min_gain": -0.5, "rollback_window": 10,
                      "rollback_threshold": 0.3}
GUARD_FAULT = {"start": 6, "duration": 10, "to_fraction": 0.1}
GUARD_BODY_SESSIONS = 64
GUARD_FAULT_SESSIONS = 256
GUARD_FAULT_STEPS = 20
GUARD_REPLAY_STEPS = 10
#: steps of the guarded fleets and services ((c), (e)): 10, not the 30 of
#: the other phases, to keep the whole run under 1,000 s (a guarded step
#: of 1,024 sessions costs ~0.15 s monolithic and ~0.55 s in chunks of 256
#: on an H100; 20 before); the service's resume runs two halves of it
GUARD_FLEET_STEPS = 10


class StepTimer:
    """CUDA-event times of the parts of the per-step body, by wrapping the
    functions it looks up at each call: ``fleet_act`` (the act),
    ``fleet_learn_scan`` (the index draw, the gather and the launch),
    ``kernels.ops.ddpg_inner_loop`` (the learner launch alone) and the
    env models' ``step_fn`` (each model step) and ``step_draws``. The
    wrappers record events only; ``seconds()`` reads them after a
    synchronize."""

    def __init__(self, envs):
        import repro_torch.core.ddpg as ddpg
        import repro_torch.core.episode as episode
        import repro_torch.kernels.ops as ops

        self.events = {"act": [], "model_steps": [], "step_draws": [],
                       "learn": [], "learner_launch": []}
        self.active = False  # only the fleet episode's calls are timed
        self.patches = [(ddpg, "fleet_act"), (ddpg, "fleet_learn_scan"),
                        (ops, "ddpg_inner_loop"),
                        (episode, "run_fleet_episode_scan")]
        self.saved = [getattr(mod, name) for mod, name in self.patches]
        self.models = [e.model for e in envs]
        self.model_fns = [m._step_fn for m in self.models]

        def episode_run(*args, **kwargs):
            self.active = True
            try:
                return self.saved[3](*args, **kwargs)
            finally:
                self.active = False

        wrapped = {
            "fleet_act": self.timed("act", self.saved[0]),
            "fleet_learn_scan": self.timed("learn", self.saved[1]),
            "ddpg_inner_loop": self.timed("learner_launch", self.saved[2]),
            "run_fleet_episode_scan": episode_run}
        for mod, name in self.patches:
            setattr(mod, name, wrapped[name])
        step_fn = self.timed("model_steps", self.models[0]._step_fn)
        draws = self.timed("step_draws", self.models[0].step_draws)
        for m in self.models:  # one identity, as check_fleet_envs asks
            m._step_fn = step_fn
            m.step_draws = draws

    def timed(self, part, fn):
        import torch

        def run(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[part].append((begin, end))
            return out
        return run

    def restore(self) -> None:
        for (mod, name), fn in zip(self.patches, self.saved):
            setattr(mod, name, fn)
        for m, step_fn in zip(self.models, self.model_fns):
            m._step_fn = step_fn
            del m.step_draws  # the class's method again

    def seconds(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {part: sum(b.elapsed_time(e) for b, e in pairs) / 1e3
                for part, pairs in self.events.items()}


def counted(fn):
    """``fn()`` with both learner kernels' launches counted from 0:
    (result, ddpg_learn launches, episode_learn launches)."""
    from repro_torch.kernels.ddpg_learn import ddpg_learn
    from repro_torch.kernels.episode_learn import episode_learn

    ddpg_learn.launches = 0
    episode_learn.launches = 0
    out = fn()
    return out, ddpg_learn.launches, episode_learn.launches


def guard_snapshot(tuner, pair) -> dict:
    """``fleet_snapshot`` of a guarded fleet run, with its guard state."""
    trace, guard = pair
    snap = fleet_snapshot(tuner, trace)
    snap["guard"] = [x.copy() for x in guard]
    return snap


def guard_differences(a: dict, b: dict) -> list:
    """``fleet_differences`` and the guard state's leaves that differ."""
    import numpy as np

    return fleet_differences(a, b) + [
        f"guard[{i}]" for i, (x, y) in enumerate(zip(a["guard"], b["guard"]))
        if not np.array_equal(x, y)]


def guarded_results_mismatch(a, b) -> list:
    """``result_mismatch`` and the guardrail records."""
    bad = result_mismatch(a, b)
    return bad + (["guardrail_stats"]
                  if a.guardrail_stats != b.guardrail_stats else [])


def phase_guard(smi: str) -> dict:
    """The per-step body and the deployment guardrails on the card (see
    the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import DeploymentPolicy, FleetService, \
        FleetTuner, Scalarizer, Tuner, stepwise_episode
    from repro_torch.core.guardrails import EVENT_PROMOTED, EVENT_ROLLBACK
    from repro_torch.envs import FaultInjectedModel, LustreSimEnv, \
        LustreSimV2, ModelEnv, throughput_collapse
    from repro_torch.kernels.episode_learn import episode_learn

    t_phase = time.perf_counter()
    out = {"phase": "guard", "card": smi}
    policy = DeploymentPolicy(**GUARD_POLICY)
    objective = {"throughput": 1.0}
    launches = 0  # ddpg_learn's, on the guarded path

    # (a) the per-step body with policy=None against the episode kernel
    body = []
    for space in ("2d", "8d"):
        op, spec = episode_inputs(space, GUARD_BODY_SESSIONS, seed=500,
                                  device="cuda", steps=EP_STEPS)
        k, s = clone_tree(op), clone_tree(op)
        tk = episode_learn(k, spec=spec)
        ts, n_ddpg, n_ep = counted(lambda: stepwise_episode(s, spec=spec))
        torch.cuda.synchronize()
        if n_ddpg != EP_STEPS or n_ep != 0:
            raise AssertionError(f"guard {space}: the body launched "
                                 f"ddpg_learn {n_ddpg} times, episode_learn "
                                 f"{n_ep}")
        bitwise = tree_equal(tk, ts) and tree_equal(k, s)
        err = compare_episode(ts, tk)
        row = {"space": space, "sessions": GUARD_BODY_SESSIONS,
               "steps": EP_STEPS, "bitwise_equal_to_episode_kernel": bitwise,
               **err}
        if not bitwise:
            if err["min_first_differing_step"] < WARMUP_STEPS:
                raise AssertionError(f"guard {space}: a warmup decision of "
                                     f"the body differs from the kernel's")
            if err["median_rel_err"] > EP_RTOL or \
                    err["p90_rel_err"] > EP_RTOL_P90:
                raise AssertionError(
                    f"guard {space}: body vs kernel, median "
                    f"{err['median_rel_err']}, p90 {err['p90_rel_err']}")
        body.append(row)
        del op, k, s
    out["body"] = body

    # (b) the guarded Tuner, 30 steps on each space, and a CPU replay
    tuners = []
    for space, env_cls in (("2d", LustreSimEnv), ("8d", LustreSimV2)):
        def tuner(device):
            env = env_cls("seq_write", seed=0).to_model_env(device=device)
            return Tuner(env, Scalarizer(weights=objective,
                                         specs=env.metric_specs),
                         seed=0, engine="scan", policy=policy, device=device)

        gpu = tuner(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, n_ddpg, n_ep = counted(lambda: gpu.run(EP_STEPS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if n_ddpg != EP_STEPS or n_ep != 0:
            raise AssertionError(f"guard {space}: a guarded run() launched "
                                 f"ddpg_learn {n_ddpg} times, episode_learn "
                                 f"{n_ep}")
        launches += n_ddpg
        cpu = tuner("cpu")
        cpu.run(GUARD_REPLAY_STEPS)
        same = next((t for t in range(GUARD_REPLAY_STEPS)
                     if gpu.guard_events[t] != cpu.guard_events[t]
                     or result.history[t].config != cpu.history[t].config),
                    GUARD_REPLAY_STEPS)
        if same <= WARMUP_STEPS:
            raise AssertionError(f"guard {space}: events or committed "
                                 f"decisions differ from the CPU replay at "
                                 f"step {same}")
        tuners.append({"space": space, "steps": EP_STEPS,
                       "launches": n_ddpg, "wall_seconds": wall,
                       "step_seconds": wall / EP_STEPS,
                       "gain": result.gain("throughput"),
                       "guardrail_stats": result.guardrail_stats,
                       "cpu_replay_steps": GUARD_REPLAY_STEPS,
                       "equal_to_cpu_through_step": same})
    out["tuner"] = tuners

    # (c) the guarded fleet: monolithic (timed by part) and in chunks
    grid = (list(FLEET_WORKLOADS), [objective], list(range(FLEET_SEEDS)))
    sessions = len(FLEET_WORKLOADS) * FLEET_SEEDS
    fleet_rows_ = []
    snaps = {}
    for chunk in (None, SERVICE_CHUNK):
        tuner = FleetTuner.from_grid(*grid, engine="scan", chunk=chunk,
                                     policy=policy)
        plan = tuner.memory_plan(steps=GUARD_FLEET_STEPS)
        timer = StepTimer(tuner.envs) if chunk is None else None
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            (result, pair), n_ddpg, n_ep = counted(
                lambda: captured_fleet_run(tuner, GUARD_FLEET_STEPS))
            torch.cuda.synchronize()
        finally:
            if timer is not None:
                timer.restore()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        chunks = -(-sessions // (chunk or sessions))
        if n_ddpg != GUARD_FLEET_STEPS * chunks or n_ep != 0:
            raise AssertionError(f"guard fleet chunk {chunk}: ddpg_learn "
                                 f"{n_ddpg} launches, episode_learn {n_ep}")
        launches += n_ddpg
        bound = plan["chunk_device_bytes"] + \
            plan["predraw_transient_bytes"] + FLEET_PEAK_MARGIN
        if peak > bound:
            raise AssertionError(f"guard fleet: peak {peak} B over the "
                                 f"plan's {bound} B")
        episode_s = tuner.timings["episode"]
        ev = tuner.guard_events
        row = {"chunk": chunk, "launches": n_ddpg, "run_seconds": wall,
               "episode_seconds": episode_s,
               "step_seconds": episode_s / GUARD_FLEET_STEPS,
               "session_steps_per_second":
                   sessions * GUARD_FLEET_STEPS / episode_s,
               "replay_seconds": tuner.timings["replay"],
               "final_seconds": tuner.timings["final"],
               "peak_device_bytes": peak, "plan_bound_bytes": bound,
               "promotions": int(((ev & EVENT_PROMOTED) != 0).sum()),
               "rejections": int(((ev & EVENT_PROMOTED) == 0).sum()),
               "rollbacks": int(((ev & EVENT_ROLLBACK) != 0).sum()),
               "restart_seconds": float(tuner.simulated_restart_seconds.sum())}
        if timer is not None:
            parts = timer.seconds()
            per = {key: v / GUARD_FLEET_STEPS for key, v in parts.items()}
            per["rest"] = row["step_seconds"] - per["act"] - \
                per["model_steps"] - per["step_draws"] - per["learn"]
            row["per_step_device_seconds"] = per
            row["model_step_calls"] = len(timer.events["model_steps"])
        snaps[chunk] = guard_snapshot(tuner, pair)
        fleet_rows_.append(row)
        if chunk is None:
            labels, seeds = list(tuner.labels), list(tuner.agent.seeds)
        else:
            static = result
        del tuner, pair
    bad = guard_differences(snaps[SERVICE_CHUNK], snaps[None])
    if bad:
        raise AssertionError(f"guard fleet: chunks of {SERVICE_CHUNK} differ "
                             f"from the monolithic run: {bad}")
    picked = [i * sessions // FLEET_SAMPLED for i in range(FLEET_SAMPLED)]
    for i in picked:
        one = FleetTuner.from_grid([labels[i].split("|")[0]], [objective],
                                   [seeds[i]], engine="scan", policy=policy)
        (_, pair), n_ddpg, _ = counted(
            lambda: captured_fleet_run(one, GUARD_FLEET_STEPS))
        launches += n_ddpg
        snap = guard_snapshot(one, pair)
        whole = fleet_rows(snaps[None], [i])
        whole["guard"] = [g[[i]] for g in snaps[None]["guard"]]
        bad = guard_differences(snap, whole)
        if bad:
            raise AssertionError(f"guard fleet: session {i} differs from its "
                                 f"guarded fleet of one: {bad}")
    unguarded = FleetTuner.from_grid(*grid, engine="scan")
    t0 = time.perf_counter()
    unguarded.run(GUARD_FLEET_STEPS)
    torch.cuda.synchronize()
    out["fleet"] = {
        "sessions": sessions, "steps": GUARD_FLEET_STEPS,
        "runs": fleet_rows_,
        "chunked_bitwise_equal_to_monolithic": True,
        "independent_sessions": picked,
        "unguarded_episode_seconds": unguarded.timings["episode"],
        "unguarded_restart_seconds":
            float(unguarded.simulated_restart_seconds.sum())}
    del unguarded, snaps

    # (d) faults: a throughput collapse under the reference test's policy
    fault = throughput_collapse(**GUARD_FAULT)
    fault_policy = DeploymentPolicy(**GUARD_FAULT_POLICY)

    def faulted_env(workload, seed):
        base = LustreSimEnv(workload, seed=seed).as_model()
        return ModelEnv(FaultInjectedModel(base, [fault]), seed=seed)

    faulted = FleetTuner.from_grid(
        list(FLEET_WORKLOADS), [objective],
        list(range(GUARD_FAULT_SESSIONS // len(FLEET_WORKLOADS))),
        env_factory=faulted_env, engine="scan", policy=fault_policy)
    t0 = time.perf_counter()
    _, n_ddpg, n_ep = counted(lambda: faulted.run(GUARD_FAULT_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if n_ddpg != GUARD_FAULT_STEPS or n_ep != 0:
        raise AssertionError(f"guard faults: ddpg_learn {n_ddpg} launches, "
                             f"episode_learn {n_ep}")
    launches += n_ddpg
    window = slice(GUARD_FAULT["start"],
                   GUARD_FAULT["start"] + GUARD_FAULT_POLICY[
                       "rollback_window"])
    rolled = (faulted.guard_events[:, window] & EVENT_ROLLBACK) != 0
    in_window = int(rolled.sum())
    if in_window < 1:
        raise AssertionError("guard faults: no rollback answered the "
                             "collapse inside the window")
    out["faults"] = {
        "sessions": GUARD_FAULT_SESSIONS, "steps": GUARD_FAULT_STEPS,
        "launches": n_ddpg, "wall_seconds": wall,
        "rollbacks_in_window": in_window,
        "sessions_rolled_back_in_window": int(rolled.any(axis=1).sum()),
        "rollbacks_outside_window": int(
            ((faulted.guard_events & EVENT_ROLLBACK) != 0).sum()) - in_window}
    del faulted

    # (e) the guarded service: advance(30) == the static fleet; a resume
    cells = service_cells()

    def service(checkpoint_dir=None):
        svc = FleetService(chunk=SERVICE_CHUNK, policy=policy,
                           checkpoint_dir=checkpoint_dir)
        return svc, [svc.request_join(w, objective, s) for w, s in cells]

    def advance(svc, steps):
        nonlocal launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_ddpg, n_ep = counted(lambda: svc.advance(steps))
        torch.cuda.synchronize()
        want = steps * -(-svc.last_stats["sessions"] // SERVICE_CHUNK)
        if n_ddpg != want or n_ep != 0:
            raise AssertionError(f"guard service: ddpg_learn {n_ddpg} "
                                 f"launches (want {want}), episode_learn "
                                 f"{n_ep}")
        launches += n_ddpg
        return {"steps": steps, "launches": n_ddpg,
                "wall_seconds": time.perf_counter() - t0,
                "guardrails": svc.last_stats["guardrails"]}

    def results(svc, sids):
        for sid in sids:
            svc.request_leave(sid)
        svc.advance(0)
        return [svc.result(sid) for sid in sids]

    svc, sids = service()
    run = advance(svc, GUARD_FLEET_STEPS)
    kept = {sid: (svc._sessions[sid].guard, svc._sessions[sid].guard_counters)
            for sid in sids}
    whole = results(svc, sids)
    bad = [i for i, (a, b) in enumerate(zip(whole, static.results))
           if guarded_results_mismatch(a, b)]
    if bad:
        raise AssertionError(f"guard service: {len(bad)} sessions differ "
                             f"from the guarded static fleet, first {bad[:8]}")
    import tempfile
    half = GUARD_FLEET_STEPS // 2
    with tempfile.TemporaryDirectory() as ckpt:
        first, f_sids = service(ckpt)
        halves = [advance(first, half)]
        t0 = time.perf_counter()
        first.checkpoint()
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = FleetService.restore(ckpt)
        restore_s = time.perf_counter() - t0
        if resumed.policy != policy:
            raise AssertionError("guard service: the policy was not restored")
        halves.append(advance(resumed, GUARD_FLEET_STEPS - half))
    for sid, f_sid in zip(sids, f_sids):
        guard, counters = kept[sid]
        sess = resumed._sessions[f_sid]
        if counters != sess.guard_counters or not all(
                np.array_equal(a, b) for a, b in zip(guard, sess.guard)):
            raise AssertionError(f"guard service: session {f_sid}'s guard "
                                 f"differs after the resume")
    bad = [sid for sid, a, b in zip(f_sids, whole, results(resumed, f_sids))
           if guarded_results_mismatch(a, b)]
    if bad:
        raise AssertionError(f"guard service: {len(bad)} resumed sessions "
                             f"differ, first sids {bad[:8]}")
    out["service"] = {"advance": run, "sessions_bitwise_equal": len(sids),
                      "halves": halves, "checkpoint_seconds": ckpt_s,
                      "restore_seconds": restore_s,
                      "resumed_bitwise_equal": len(f_sids)}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


#: the resilience phase: steps, the reference example's NaN poison
#: (``examples/tune_fleet.py``'s --chaos), the degrade case's poison and
#: policy, the small stall fleet and its watchdog
RESILIENCE_STEPS = 20
RESILIENCE_POISON = {"nan_metric": "throughput", "nan_start": 6,
                     "nan_duration": 2}
DEGRADE_POISON = {"nan_metric": "throughput", "nan_start": 6,
                  "nan_duration": 3}
DEGRADE_POLICY = {"max_resets": 2}
DEGRADE_SESSIONS = 256
UNFAULTED_SESSIONS = 16
STALL_SEEDS = 16  # x 4 workloads: 64 sessions in chunks of 32
STALL_STEPS = 4
STALL_SECONDS = 1.0
WATCHDOG_SECONDS = 0.8
#: the planted non-finite learners: sessions with NaN, inf, and a 1e38
#: reward in their windows
PLANTED = {"nan": (3, 700), "inf": (5, 900), "reward": (9, 1000)}


def bits_of(x) -> bytes:
    """A float's bits, every NaN one value, for bitwise comparisons of
    histories that hold NaN readings: a resumed service's history comes
    back from the checkpoint's JSON record, which keeps a NaN but not its
    payload (the card's arithmetic makes NaNs of other payloads than the
    poison's)."""
    import struct
    x = float(x)
    return b"nan" if x != x else struct.pack("<d", x)


def nan_result_mismatch(a, b) -> list:
    """``result_mismatch`` with NaN readings compared by their bits."""
    def records(r):
        return [(h.step, h.config,
                 tuple((k, bits_of(v)) for k, v in h.metrics.items()),
                 bits_of(h.objective), bits_of(h.reward),
                 bits_of(h.restart_seconds)) for h in r.history]

    bad = ["history"] if records(a) != records(b) else []
    return bad + [f for f in ("best_config", "best_objective",
                              "best_metrics", "default_config",
                              "default_metrics",
                              "simulated_restart_seconds")
                  if getattr(a, f) != getattr(b, f)]


def resilient_snapshot(tuner, pair) -> dict:
    """``fleet_snapshot`` of a resilient fleet run, with its health state
    and the per-session cursors."""
    trace, health = pair
    snap = fleet_snapshot(tuner, trace)
    snap["health"] = [x.copy() for x in health[1:]]
    snap["cursors"] = tuple(tuple(x.tolist())
                            for x in tuner.agent.buffer.cursors())
    return snap


def resilient_differences(a: dict, b: dict) -> list:
    """``fleet_differences`` (NaN readings equal to themselves) and the
    health counters that differ."""
    import numpy as np
    a = dict(a, trace={k: np.nan_to_num(v, nan=7.0)
                       for k, v in a["trace"].items()})
    b = dict(b, trace={k: np.nan_to_num(v, nan=7.0)
                       for k, v in b["trace"].items()})
    return fleet_differences(a, b) + [
        f"health[{i}]" for i, (x, y) in
        enumerate(zip(a["health"], b["health"])) if not np.array_equal(x, y)]


def resilient_rows(snap: dict, rows) -> dict:
    """``resilient_snapshot`` of the sessions ``rows`` only."""
    out = fleet_rows(snap, rows)
    out["health"] = [x[rows] for x in snap["health"]]
    out["cursors"] = tuple(tuple(c[i] for i in rows)
                           for c in snap["cursors"])
    return out


def faulted_factory(poison: dict):
    """``env_factory`` of a fleet whose every session's model reads the
    ``ChaosConfig(**poison)`` NaN poison (one schedule: one step_fn)."""
    from repro_torch.envs import ChaosConfig, FaultInjectedModel, \
        LustreSimEnv, ModelEnv
    specs = ChaosConfig(**poison).fault_specs()

    def env_factory(workload, seed):
        base = LustreSimEnv(workload, seed=seed).as_model()
        return ModelEnv(FaultInjectedModel(base, specs), seed=seed)

    return env_factory


def check_planted(device, sessions: int = None) -> dict:
    """``ddpg_learn`` (on ``device``: the kernel on a card) and its plain
    version on the same inputs, with NaN and inf planted in some sessions'
    learner and a 1e38 reward in others' minibatches: the sessions whose
    outputs (learner and losses) are non-finite must be the same in both,
    exactly the planted ones, and the detector
    (``core.resilience.tree_nonfinite_rows``) must flag exactly them. The
    losses alone hold the kernel's one known departure: its relu maps NaN
    to 0 where ``torch.relu`` keeps it, so on a card the kernel's
    non-finite loss sessions are the plain version's less exactly the
    sessions with a planted NaN or inf weight (on the CPU both sides run
    the plain version and agree)."""
    import torch

    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.resilience import tree_nonfinite_rows
    from repro_torch.kernels import ops
    from repro_torch.kernels.ddpg_learn import ddpg_learn_plain

    sessions = sessions or SEED_SESSIONS
    cfg = DDPGConfig(state_dim=12, action_dim=2)
    state, batches = fleet_inputs(cfg, sessions, seed=77, device=device)
    planted = sorted({i for i, _ in PLANTED.values()})
    state.flat[PLANTED["nan"][0], PLANTED["nan"][1]] = float("nan")
    state.flat[PLANTED["inf"][0], PLANTED["inf"][1]] = float("inf")
    batches[2][PLANTED["reward"][0]] = 1e38
    plain = type(state)(*(x.cpu().clone() for x in state))
    metrics = ops.ddpg_inner_loop(state, batches, cfg=cfg)
    ref = ddpg_learn_plain(plain, tuple(b.cpu() for b in batches), cfg=cfg)

    def rows(x):  # [N] bool: a non-finite value in the session's row
        return ~torch.isfinite(x.reshape(x.shape[0], -1).cpu()).all(1)

    def listed(x):
        return x.nonzero().flatten().tolist()

    learner = (rows(state.flat), rows(plain.flat))
    losses = (rows(metrics), rows(ref))
    outputs = (learner[0] | losses[0], learner[1] | losses[1])
    weights = sorted({PLANTED["nan"][0], PLANTED["inf"][0]}) \
        if state.flat.is_cuda else []
    gap = listed(losses[1] & ~losses[0])
    if not torch.equal(*outputs) or not torch.equal(*learner) or \
            bool((losses[0] & ~losses[1]).any()) or gap != weights:
        raise AssertionError(f"planted: non-finite sessions, kernel / plain:"
                             f" outputs {listed(outputs[0])} / "
                             f"{listed(outputs[1])}, learner "
                             f"{listed(learner[0])} / {listed(learner[1])}, "
                             f"losses {listed(losses[0])} / "
                             f"{listed(losses[1])} (the plain version's "
                             f"alone must be {weights})")
    flagged = tree_nonfinite_rows((state.flat, metrics)).cpu()
    if sorted(flagged.nonzero().flatten().tolist()) != planted or \
            not torch.equal(flagged, tree_nonfinite_rows((plain.flat, ref))):
        raise AssertionError(f"planted: the detector flags "
                             f"{flagged.nonzero().flatten().tolist()}, "
                             f"planted {planted}")
    return {"sessions": sessions, "planted": PLANTED,
            "nonfinite_sessions": planted,
            "nonfinite_learner_sessions": listed(learner[0]),
            "nonfinite_loss_sessions": {"kernel": listed(losses[0]),
                                        "plain": listed(losses[1])},
            "plain_alone_loss_sessions": gap,
            "same_in_kernel_and_plain": True}


def layer_overhead(sessions: int, runs: int = 20) -> dict:
    """What the resilient step adds to a step of ``sessions`` 2-D
    learners, CUDA-event medians in ms: the copy of the step's entry
    learner (the reset target), the non-finite detector over the learners
    and their losses, and the health update with the learners' write-back
    (``core.resilience.health_update``)."""
    import torch

    from repro_torch.core import DDPGConfig, ResiliencePolicy
    from repro_torch.core.ddpg import DDPGState, state_layout
    from repro_torch.core.resilience import health_to_torch, \
        health_update, init_fleet_health_state, tree_nonfinite_rows

    cfg = DDPGConfig(state_dim=12, action_dim=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ddpg = DDPGState(
        torch.rand((sessions, state_layout(cfg).floats), device="cuda",
                   generator=gen),
        torch.zeros((sessions, 2), dtype=torch.int32, device="cuda"),
        torch.zeros(sessions, dtype=torch.int32, device="cuda"))
    losses = torch.rand((sessions, UPDATES, 3), device="cuda", generator=gen)
    policy = ResiliencePolicy()
    health = health_to_torch(init_fleet_health_state(ddpg, sessions, policy),
                             "cuda")
    bad = torch.zeros(sessions, dtype=torch.bool, device="cuda")

    def update():
        kept, _, _ = health_update(policy, health, bad, ddpg, ddpg)
        for dst, src in zip(ddpg, kept):
            dst.copy_(src)

    return {"sessions": sessions,
            "entry_copy": time_ms(
                lambda: DDPGState(*(x.clone() for x in ddpg)), runs),
            "detector": time_ms(
                lambda: tree_nonfinite_rows((ddpg.flat, losses)), runs),
            "health_update": time_ms(update, runs)}


#: steps and runs of each ``--layer-steps`` fleet
LAYER_STEPS = 10
LAYER_RUNS = 3


def phase_layer_steps(smi: str) -> None:
    """``--layer-steps``: the guarded fleet of the guard phase and the
    poisoned resilient fleet of the resilience phase (1,024 2-D sessions,
    monolithic), each built and run ``LAYER_RUNS`` times for
    ``LAYER_STEPS`` steps; one line per run with its episode seconds per
    step. Two trees run one after the other in one call compare a change
    to the per-step body."""
    import torch

    from repro_torch.core import DeploymentPolicy, FleetTuner, \
        ResiliencePolicy

    grid = (list(FLEET_WORKLOADS), [{"throughput": 1.0}],
            list(range(FLEET_SEEDS)))
    for layer, kwargs in (
            ("guarded", {"policy": DeploymentPolicy(**GUARD_POLICY)}),
            ("resilient", {"resilience": ResiliencePolicy(),
                           "env_factory": faulted_factory(
                               RESILIENCE_POISON)})):
        for run in range(LAYER_RUNS):
            tuner = FleetTuner.from_grid(*grid, engine="scan", **kwargs)
            torch.cuda.synchronize()
            tuner.run(LAYER_STEPS)
            torch.cuda.synchronize()
            episode_s = tuner.timings["episode"]
            emit({"phase": "layer_steps", "layer": layer, "run": run,
                  "sessions": len(tuner.envs), "steps": LAYER_STEPS,
                  "step_seconds": episode_s / LAYER_STEPS, "card": smi})
            del tuner


def phase_resilience(smi: str) -> dict:
    """The self-healing layer on the card (see the module docstring)."""
    import tempfile

    import torch

    from repro_torch.core import ChunkSupervisor, FleetService, \
        FleetTuner, ResiliencePolicy, last_fleet_run_stats, \
        stepwise_episode
    from repro_torch.core.resilience import EVENT_DEGRADED, \
        EVENT_NONFINITE, EVENT_RESET, ResilientCarry, health_counters, \
        health_to_torch, init_fleet_health_state
    from repro_torch.envs import ChaosConfig

    t_phase = time.perf_counter()
    out = {"phase": "resilience", "card": smi, "steps": RESILIENCE_STEPS}
    policy = ResiliencePolicy()
    objective = {"throughput": 1.0}
    grid = (list(FLEET_WORKLOADS), [objective], list(range(FLEET_SEEDS)))
    sessions = len(FLEET_WORKLOADS) * FLEET_SEEDS
    factory = faulted_factory(RESILIENCE_POISON)
    launches = 0  # ddpg_learn's, on the resilient path
    steps = RESILIENCE_STEPS
    poisoned = slice(RESILIENCE_POISON["nan_start"],
                     RESILIENCE_POISON["nan_start"]
                     + RESILIENCE_POISON["nan_duration"])

    # (a) the poisoned fleet: monolithic (timed by part); in chunks of 256
    # under a supervisor whose chunk 1 fails twice; 8 fleets of one
    chaos = ChaosConfig(fail_chunks=((1, 2),)).host()
    supervisor = ChunkSupervisor(backoff_seconds=0.0)
    runs, snaps = [], {}
    for chunk, sup, host_chaos in ((None, None, None),
                                   (SERVICE_CHUNK, supervisor, chaos)):
        tuner = FleetTuner.from_grid(*grid, env_factory=factory,
                                     engine="scan", chunk=chunk,
                                     resilience=policy, supervisor=sup,
                                     chaos=host_chaos)
        timer = StepTimer(tuner.envs) if chunk is None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            (result, pair), n_ddpg, n_ep = counted(
                lambda: captured_fleet_run(tuner, steps))
            torch.cuda.synchronize()
        finally:
            if timer is not None:
                timer.restore()
        wall = time.perf_counter() - t0
        chunks = -(-sessions // (chunk or sessions))
        # a failed attempt fails before its staging: it launches nothing
        if n_ddpg != steps * chunks or n_ep != 0:
            raise AssertionError(f"resilience chunk {chunk}: ddpg_learn "
                                 f"{n_ddpg} launches, episode_learn {n_ep}")
        launches += n_ddpg
        ev = tuner.health_events
        if not (ev[:, poisoned] & EVENT_NONFINITE).all() or \
                not (ev[:, poisoned] & EVENT_RESET).all() or \
                (ev[:, poisoned.stop:] & EVENT_NONFINITE).any() or \
                (ev & EVENT_DEGRADED).any():
            raise AssertionError(f"resilience chunk {chunk}: the poison's "
                                 f"events are not every session's resets")
        health = pair[1]
        for i in range(sessions):  # trace counters == carried totals
            c = health_counters(ev[i])
            if (c["resets"], c["nonfinite"]) != \
                    (int(health.resets[i]), int(health.nonfinite[i])):
                raise AssertionError(f"resilience: session {i}'s counters "
                                     f"differ from its carried totals")
        episode_s = tuner.timings["episode"]
        row = {"chunk": chunk, "launches": n_ddpg, "run_seconds": wall,
               "episode_seconds": episode_s,
               "step_seconds": episode_s / steps,
               "session_steps_per_second": sessions * steps / episode_s,
               "resets": int(((ev & EVENT_RESET) != 0).sum()),
               "nonfinite": int(((ev & EVENT_NONFINITE) != 0).sum())}
        if sup is not None:
            stats = last_fleet_run_stats()["supervisor"]
            if stats["retries"] != 2 or stats["failed_chunks"]:
                raise AssertionError(f"resilience: supervisor stats {stats}")
            row["supervisor"] = {k: stats[k] for k in
                                 ("retries", "watchdog_trips",
                                  "failed_chunks")}
        if timer is not None:
            parts = timer.seconds()
            per = {key: v / steps for key, v in parts.items()}
            per["rest"] = row["step_seconds"] - per["act"] - \
                per["model_steps"] - per["step_draws"] - per["learn"]
            row["per_step_device_seconds"] = per
            labels, seeds = list(tuner.labels), list(tuner.agent.seeds)
            static = result
        snaps[chunk] = resilient_snapshot(tuner, pair)
        runs.append(row)
        del tuner, pair
    bad = resilient_differences(snaps[SERVICE_CHUNK], snaps[None])
    if bad:
        raise AssertionError(f"resilience: the supervised chunks of "
                             f"{SERVICE_CHUNK} differ from the monolithic "
                             f"run: {bad}")
    picked = [i * sessions // FLEET_SAMPLED for i in range(FLEET_SAMPLED)]
    for i in picked:
        one = FleetTuner.from_grid([labels[i].split("|")[0]], [objective],
                                   [seeds[i]], env_factory=factory,
                                   engine="scan", resilience=policy)
        (_, pair), n_ddpg, _ = counted(lambda: captured_fleet_run(one, steps))
        launches += n_ddpg
        bad = resilient_differences(resilient_snapshot(one, pair),
                                    resilient_rows(snaps[None], [i]))
        if bad:
            raise AssertionError(f"resilience: session {i} differs from "
                                 f"its fleet of one: {bad}")
    out["fleet"] = {"sessions": sessions, "runs": runs,
                    "supervised_chunks_bitwise_equal_to_monolithic": True,
                    "independent_sessions": picked}
    del snaps

    # (b) without faults, the resilient body is the body with no layer
    op, spec = episode_inputs("2d", UNFAULTED_SESSIONS, seed=600,
                              device="cuda", steps=steps)
    plain, healed = clone_tree(op), clone_tree(op)
    health = health_to_torch(init_fleet_health_state(
        healed.carry.ddpg, UNFAULTED_SESSIONS, policy), "cuda")
    t_plain, n_plain, _ = counted(lambda: stepwise_episode(plain,
                                                           spec=spec))
    t_heal, n_heal, _ = counted(lambda: stepwise_episode(
        healed._replace(carry=ResilientCarry(healed.carry, health)),
        spec=spec, resilience=policy))
    torch.cuda.synchronize()
    launches += n_heal
    if not (tree_equal(tuple(t_heal)[:5], tuple(t_plain)) and
            tree_equal(healed, plain)) or t_heal.health_events.any():
        raise AssertionError("resilience: the body without faults differs "
                             "from the body with no layer")
    out["unfaulted_body"] = {"sessions": UNFAULTED_SESSIONS,
                             "steps": steps,
                             "bitwise_equal_to_plain_body": True,
                             "launches": n_heal}
    del op, plain, healed, health

    # (c) a 3-step poison at max_resets=2: every session degrades, and the
    # frozen learner stays bitwise still
    degrade = FleetTuner.from_grid(
        list(FLEET_WORKLOADS), [objective],
        list(range(DEGRADE_SESSIONS // len(FLEET_WORKLOADS))),
        env_factory=faulted_factory(DEGRADE_POISON), engine="scan",
        resilience=ResiliencePolicy(**DEGRADE_POLICY))
    frozen_at = DEGRADE_POISON["nan_start"] + DEGRADE_POISON["nan_duration"]
    _, n1, _ = counted(lambda: degrade.run(frozen_at))
    frozen = [x.clone() for x in degrade.agent.states]
    _, n2, _ = counted(lambda: degrade.run(steps - frozen_at))
    launches += n1 + n2
    ev = degrade.health_events
    if not (ev[:, frozen_at - 1:] & EVENT_DEGRADED).all() or \
            not (((ev & EVENT_RESET) != 0).sum(1)
                 == DEGRADE_POLICY["max_resets"]).all():
        raise AssertionError("resilience: the 3-step poison did not degrade "
                             "every session after its resets")
    if not all(torch.equal(x, y) for x, y in zip(frozen,
                                                 degrade.agent.states)):
        raise AssertionError("resilience: a degraded learner moved")
    out["degrade"] = {"sessions": DEGRADE_SESSIONS, "steps": steps,
                      "degraded_sessions": DEGRADE_SESSIONS,
                      "frozen_learner_bitwise_still": True}
    del degrade

    # (d) a stall trips the watchdog and leaves the bits as they were
    small = (list(FLEET_WORKLOADS), [objective], list(range(STALL_SEEDS)))
    stall = ChaosConfig(stall_chunks=((0, STALL_SECONDS),)).host()
    kw = dict(env_factory=factory, engine="scan", chunk=STALL_SEEDS * 2,
              resilience=policy)
    quiet = FleetTuner.from_grid(*small, **kw)
    stalled = FleetTuner.from_grid(
        *small, supervisor=ChunkSupervisor(
            backoff_seconds=0.0, watchdog_seconds=WATCHDOG_SECONDS),
        chaos=stall, **kw)
    (rq, pq), nq, _ = counted(lambda: captured_fleet_run(quiet,
                                                         STALL_STEPS))
    (rs, ps), ns, _ = counted(lambda: captured_fleet_run(stalled,
                                                         STALL_STEPS))
    launches += nq + ns
    stats = last_fleet_run_stats()["supervisor"]
    bad = resilient_differences(resilient_snapshot(stalled, ps),
                                resilient_snapshot(quiet, pq))
    if stats["watchdog_trips"] < 1 or bad:
        raise AssertionError(f"resilience: the stall's watchdog trips "
                             f"{stats['watchdog_trips']}, differences {bad}")
    out["stall"] = {"sessions": len(quiet.envs), "steps": STALL_STEPS,
                    "watchdog_trips": stats["watchdog_trips"],
                    "chunk_seconds": stats["chunk_seconds"],
                    "bitwise_equal_to_unstalled": True}
    del quiet, stalled

    # (e) a service whose chunk 1 never stages: its 256 sessions are
    # quarantined, the survivors equal the static fleet; (f) a resilient
    # service resumes bitwise from a checkpoint
    cells = service_cells()

    def service(**kw):
        svc = FleetService(chunk=SERVICE_CHUNK, resilience=policy,
                           env_factory=factory, **kw)
        return svc, [svc.request_join(w, objective, s) for w, s in cells]

    def advance(svc, n):
        nonlocal launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_ddpg, n_ep = counted(lambda: svc.advance(n))
        torch.cuda.synchronize()
        if n_ep != 0:
            raise AssertionError("resilience service: episode_learn ran")
        launches += n_ddpg
        return {"steps": n, "launches": n_ddpg,
                "wall_seconds": time.perf_counter() - t0}

    def results(svc, sids):
        for sid in sids:
            svc.request_leave(sid)
        svc.advance(0)
        return [svc.result(sid) for sid in sids]

    dead, d_sids = service(supervisor=ChunkSupervisor(
        max_retries=1, backoff_seconds=0.0),
        chaos=ChaosConfig(fail_chunks=((1, 99),)).host())
    quarantine_run = advance(dead, steps)
    lost = d_sids[SERVICE_CHUNK:2 * SERVICE_CHUNK]
    if dead.last_stats["quarantined"] != lost or \
            dead.last_stats["supervisor"]["failed_chunks"] != [1]:
        raise AssertionError("resilience service: the dead chunk's sessions "
                             "were not the quarantined ones")
    dead.advance(0)
    if any(sid in dead._sessions or dead.result(sid).history
           for sid in lost):
        raise AssertionError("resilience service: a quarantined session "
                             "stayed or kept a history")
    survivors = [i for i, sid in enumerate(d_sids) if sid not in lost]
    got = results(dead, [d_sids[i] for i in survivors])
    bad = [i for i, r in zip(survivors, got)
           if nan_result_mismatch(r, static.results[i])]
    if bad:
        raise AssertionError(f"resilience service: {len(bad)} survivors "
                             f"differ from the static fleet, first "
                             f"{bad[:8]}")
    half = steps // 2
    with tempfile.TemporaryDirectory() as ckpt:
        first, f_sids = service(checkpoint_dir=ckpt,
                                supervisor=ChunkSupervisor())
        halves = [advance(first, half)]
        t0 = time.perf_counter()
        first.checkpoint()
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = FleetService.restore(ckpt, env_factory=factory)
        restore_s = time.perf_counter() - t0
        if resumed.resilience != policy or \
                resumed.supervisor != ChunkSupervisor():
            raise AssertionError("resilience service: the policies were not "
                                 "restored")
        halves.append(advance(resumed, steps - half))
    bad = [i for i, r in enumerate(results(resumed, f_sids))
           if nan_result_mismatch(r, static.results[i])
           or r.health_stats != static.results[i].health_stats]
    if bad:
        raise AssertionError(f"resilience service: {len(bad)} resumed "
                             f"sessions differ, first {bad[:8]}")
    out["service"] = {"quarantine_advance": quarantine_run,
                      "quarantined": len(lost),
                      "survivors_bitwise_equal_to_static": len(survivors),
                      "halves": halves, "checkpoint_seconds": ckpt_s,
                      "restore_seconds": restore_s,
                      "resumed_bitwise_equal_to_static": len(f_sids)}

    # (g) planted non-finite learners through the kernel; (h) what the
    # layer adds to a step
    out["planted"] = check_planted("cuda")
    out["overhead_ms"] = layer_overhead(sessions)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


#: the share phase (8-D): cells of 8 consecutive sessions, the reference
#: benchmark's window (8 x 64 / 2 slots) and warmup
#: (``benchmarks/shared_experience.py``), its sharing modes and scope
SHARE_STEPS = 20
SHARE_CELL = 8
SHARE_CAPACITY = SHARE_CELL * CAPACITY // 2
SHARE_WARMUP = 1
SHARE_CONFIG = {"shared_replay": True, "avg_every": 4, "avg_opt_state": True,
                "observation_scopes": ("OSC",)}
#: the poisoned-member check: sessions (cells of SHARE_CELL) and the lane
POISON_SESSIONS = 32
POISON_LANE = 3


def share_fleet(chunk, device=None):
    """The share phase's fleet: ``from_grid``'s sessions (4 workloads x
    ``FLEET_SEEDS`` seeds, ordered by workload, seeds ``s + 1000 x cell``)
    on the 8-D space in cells of ``SHARE_CELL`` consecutive sessions, each
    cell's window of ``SHARE_CAPACITY`` slots merged."""
    from repro_torch.core import DDPGConfig, FleetAgent, FleetTuner, \
        Scalarizer, SharingConfig
    from repro_torch.envs import LustreSimV2

    objective = {"throughput": 1.0}
    seeds = FLEET_SEEDS
    envs, scals, labels, cell_seeds = [], [], [], []
    for i, workload in enumerate(FLEET_WORKLOADS):
        for s in range(seeds):
            cell_seed = s + 1000 * (i * seeds + s)
            env = LustreSimV2(workload, seed=cell_seed).to_model_env(
                device=device)
            envs.append(env)
            scals.append(Scalarizer(weights=objective,
                                    specs=env.metric_specs))
            labels.append(f"{workload}|throughput|seed{s}")
            cell_seeds.append(cell_seed)
    agent = FleetAgent(DDPGConfig.for_env(envs[0]), cell_seeds,
                       buffer_capacity=SHARE_CAPACITY,
                       warmup_steps=SHARE_WARMUP, store="host",
                       init_chunk=chunk, device=device,
                       replay_groups=[i // SHARE_CELL
                                      for i in range(len(envs))])
    return FleetTuner(envs, scals, agent, labels=labels, engine="scan",
                      chunk=chunk, sharing=SharingConfig(**SHARE_CONFIG),
                      cell_size=SHARE_CELL, device=device)


def share_snapshot(tuner, trace) -> dict:
    """A sharing fleet's outputs after a run: every trace leaf, the
    learners, the cells' merged windows and cursors, the keys."""
    import torch

    agent = tuner.agent
    window, nxt, size = agent.buffer.grouped_storage()
    return {"trace": {name: getattr(trace, name) for name in trace._fields},
            "learner": [x.clone() for x in agent.states],
            "window": [x.clone() for x in window],
            "cursors": (tuple(nxt.tolist()), tuple(size.tolist())),
            "learn_keys": agent._learn_keys.clone(),
            "env_keys": torch.stack([e.model.key_of(e.model_state).cpu()
                                     for e in tuner.envs])}


class MergedWalk:
    """Holds every merged FIFO write of a run (``core.episode.
    _write_merged``) against a sequential walk of the members' writes: for
    each cell, its kept members in session order, each at the cell's
    cursor, the cursor then advanced by one, as appends one by one
    (``BatchedReplayBuffer(groups=...).add``) write them. Counts the writes
    it checked."""

    def __init__(self):
        import repro_torch.core.episode as episode

        self.episode = episode
        self.saved = episode._write_merged
        self.writes = 0

        def checked(window, rows, keep, cell_size):
            before = [x.cpu().clone() for x in window]
            self.saved(window, rows, keep, cell_size)
            self.check(before, [x.cpu() for x in window],
                       [r.cpu() for r in rows], keep.cpu(), cell_size)

        episode._write_merged = checked

    def check(self, before, after, rows, keep, cs: int) -> None:
        import torch

        *win, nxt, size = before
        cap = win[0].shape[1]
        walked = [x.clone() for x in win]
        cursor = nxt.long().clone()
        count = size.long().clone()
        for j in range(cs):  # member j of every cell, in session order
            g = keep[j::cs].nonzero().flatten()
            for dst, row in zip(walked, rows):
                dst[g, cursor[g]] = row[g * cs + j]
            cursor[g] = (cursor[g] + 1) % cap
            count[g] = torch.clamp(count[g] + 1, max=cap)
        want = walked + [cursor.to(nxt.dtype), count.to(size.dtype)]
        if not all(torch.equal(x, y) for x, y in zip(after, want)):
            raise AssertionError("share: a merged write differs from the "
                                 "sequential walk of its members' writes")
        self.writes += 1

    def restore(self) -> None:
        self.episode._write_merged = self.saved


def poisoned_member(device, sessions: int = None,
                    steps: int = None) -> dict:
    """One member of a cell with a poisoned reading at every step (its
    model's parameters NaN) against the same member inactive (it never
    writes to the window nor weighs in the mean), under the share phase's
    sharing and ``ResiliencePolicy()``, through ``stepwise_episode`` on
    ``device``: its cellmates' merged window, learners and traces must be
    bitwise equal, so the poisoned member added nothing to the window or
    to the mean. Returns the learner launches and what was held."""
    import torch

    from repro_torch.core import ResiliencePolicy, SharingConfig, \
        stepwise_episode
    from repro_torch.core.episode import BufferState, CellInputs
    from repro_torch.core.resilience import EVENT_NONFINITE, \
        ResilientCarry, health_to_torch, init_fleet_health_state

    sessions, steps = sessions or POISON_SESSIONS, steps or SHARE_STEPS
    op, spec = episode_inputs("8d", sessions, seed=900, device=device,
                              steps=steps)
    cells = sessions // SHARE_CELL
    k, m = spec.cfg.state_dim, spec.cfg.action_dim
    z = torch.zeros
    merged = BufferState(
        z((cells, CAPACITY, k), device=device),
        z((cells, CAPACITY, m), device=device),
        z((cells, CAPACITY), device=device),
        z((cells, CAPACITY, k), device=device),
        z(cells, dtype=torch.int32, device=device),
        z(cells, dtype=torch.int32, device=device))
    op = op._replace(carry=op.carry._replace(buffer=merged))
    policy = ResiliencePolicy()
    sharing = SharingConfig(**SHARE_CONFIG)
    avg_now = torch.zeros((sessions, steps), dtype=torch.bool, device=device)
    avg_now[:, SHARE_CONFIG["avg_every"] - 1::SHARE_CONFIG["avg_every"]] = True
    runs = {}
    for case in ("poisoned", "inactive"):
        run = clone_tree(op)
        active = torch.ones((sessions, steps), dtype=torch.bool,
                            device=device)
        if case == "poisoned":
            run.params[POISON_LANE] = float("nan")
        else:
            active[POISON_LANE] = False
        health = health_to_torch(init_fleet_health_state(
            run.carry.ddpg, sessions, policy), device)
        trace = stepwise_episode(
            run._replace(carry=ResilientCarry(run.carry, health)),
            spec=spec, resilience=policy, sharing=sharing,
            cell_size=SHARE_CELL, cells=CellInputs(avg_now, active))
        runs[case] = (run, trace, health)
    (a, ta, ha), (b, tb, hb) = runs["poisoned"], runs["inactive"]
    if not (ta.health_events[POISON_LANE] & EVENT_NONFINITE).all():
        raise AssertionError("share: the poisoned member's readings were "
                             "not all flagged")
    mates = [i for i in range(sessions) if i != POISON_LANE]
    same = [tree_equal(a.carry.buffer, b.carry.buffer),
            torch.equal(a.carry.ddpg.flat[mates], b.carry.ddpg.flat[mates]),
            all(torch.equal(x[mates], y[mates])
                for x, y in zip(tuple(ta)[:5], tuple(tb)[:5]))]
    if not all(same):
        raise AssertionError(f"share: the poisoned member touched its "
                             f"cellmates (window, learners, traces equal: "
                             f"{same})")
    return {"sessions": sessions, "cell": SHARE_CELL, "lane": POISON_LANE,
            "steps": steps, "cellmates_bitwise_equal": True}


def phase_share(smi: str) -> dict:
    """Experience sharing on the card (see the module docstring)."""
    import torch

    from repro_torch.core import FleetService, SharingConfig, \
        last_fleet_run_stats

    t_phase = time.perf_counter()
    steps = SHARE_STEPS
    out = {"phase": "share", "card": smi, "steps": steps,
           "cell": SHARE_CELL, "capacity": SHARE_CAPACITY,
           "sharing": SHARE_CONFIG}
    launches = 0  # ddpg_learn's, on the shared path
    sessions = len(FLEET_WORKLOADS) * FLEET_SEEDS

    # (a) monolithic (each merged write held against a sequential walk,
    # timed by part) and in chunks of 256: bitwise equal
    runs, snaps = [], {}
    for chunk in (None, SERVICE_CHUNK):
        tuner = share_fleet(chunk)
        plan = tuner.memory_plan(steps=steps)
        if not plan["matches_live"] or plan["cell_size"] != SHARE_CELL:
            raise AssertionError(f"share: memory_plan {plan}")
        walk = MergedWalk() if chunk is None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            (result, trace), n_ddpg, n_ep = counted(
                lambda: captured_fleet_run(tuner, steps))
            torch.cuda.synchronize()
        finally:
            if walk is not None:
                walk.restore()
        wall = time.perf_counter() - t0
        chunks = -(-sessions // (chunk or sessions))
        if n_ddpg != steps * chunks or n_ep != 0:
            raise AssertionError(f"share chunk {chunk}: ddpg_learn {n_ddpg} "
                                 f"launches, episode_learn {n_ep}")
        launches += n_ddpg
        stats = last_fleet_run_stats()
        episode_s = tuner.timings["episode"]
        row = {"chunk": stats["chunk"], "launches": n_ddpg,
               "run_seconds": wall, "episode_seconds": episode_s,
               "step_seconds": episode_s / steps,
               "session_steps_per_second": sessions * steps / episode_s,
               "window_bytes": tuner.agent.buffer.nbytes,
               "plan_replay_bytes_per_session":
                   plan["per_session"]["replay_bytes"],
               "summary": result.summary("throughput")}
        if walk is not None:
            if walk.writes != steps:
                raise AssertionError(f"share: {walk.writes} merged writes "
                                     f"checked of {steps}")
            row["merged_writes_held_against_walk"] = walk.writes
            static = result
        snaps[chunk] = share_snapshot(tuner, trace)
        runs.append(row)
        del tuner, trace
    bad = fleet_differences(snaps[SERVICE_CHUNK], snaps[None])
    if bad:
        raise AssertionError(f"share: chunks of {SERVICE_CHUNK} differ from "
                             f"the monolithic run: {bad}")
    out["fleet"] = {"sessions": sessions, "runs": runs,
                    "chunked_bitwise_equal_to_monolithic": True}
    del snaps

    # (b) the sharing service == the static sharing fleet
    svc = FleetService(chunk=SERVICE_CHUNK, sharing=SharingConfig(
        **SHARE_CONFIG), cell_size=SHARE_CELL,
        buffer_capacity=SHARE_CAPACITY, warmup_steps=SHARE_WARMUP,
        env_cls=_lustre_v2())
    sids = [svc.request_join(w, {"throughput": 1.0}, s)
            for w, s in service_cells()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, n_ddpg, n_ep = counted(lambda: svc.advance(steps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if n_ep != 0 or n_ddpg != steps * -(-sessions // SERVICE_CHUNK):
        raise AssertionError(f"share service: ddpg_learn {n_ddpg} launches")
    launches += n_ddpg
    if len(svc._cells) != sessions // SHARE_CELL:
        raise AssertionError(f"share service: {len(svc._cells)} cells")
    for sid in sids:
        svc.request_leave(sid)
    svc.advance(0)
    bad = [i for i, sid in enumerate(sids)
           if result_mismatch(svc.result(sid), static.results[i])]
    if bad:
        raise AssertionError(f"share service: {len(bad)} sessions differ "
                             f"from the static sharing fleet, first "
                             f"{bad[:8]}")
    out["service"] = {"advance_seconds": wall, "launches": n_ddpg,
                      "cells": sessions // SHARE_CELL,
                      "sessions_bitwise_equal_to_static": len(sids)}
    del svc

    # (c) one poisoned member leaves its cellmates untouched
    out["poisoned_member"], n_ddpg, _ = counted(
        lambda: poisoned_member("cuda"))
    launches += n_ddpg
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _lustre_v2():
    from repro_torch.envs import LustreSimV2
    return LustreSimV2


def flash_inputs(shape, dtype, seed: int):
    """q [B, H, S, D], k/v [B, Kv, S, D] standard normal, from numpy, on the
    card in ``dtype``."""
    import numpy as np
    import torch

    B, S, H, Kv, D = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(dims, np.float32))
                 .to("cuda", getattr(torch, dtype))
                 for dims in ((B, H, S, D), (B, Kv, S, D), (B, Kv, S, D)))


def rel_err(a, b) -> float:
    """max|a - b| / max|b| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (2^-7 of
    the power of two at or below |b|; the smallest subnormal's at 0)."""
    import torch

    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


def flash_errors(o, lse, po, plse) -> dict:
    """The kernel's (out, lse) against the plain version's: max|a - b| /
    max|b| and max|a - b| of each; for bfloat16 out also the shares of the
    elements that differ at all and by more than one bf16 step of the plain
    value."""
    import torch

    err = {"out_rel_err": rel_err(o, po),
           "out_max_abs_err": float((o.float() - po.float()).abs().max()),
           "lse_rel_err": rel_err(lse, plse),
           "lse_max_abs_err": float((lse - plse).abs().max())}
    if o.dtype == torch.bfloat16:
        steps = bf16_steps(o, po)
        err["out_share_differing"] = float((steps > 0).float().mean())
        err["out_share_over_one_step"] = float((steps > 1).float().mean())
    return err


def hold_flash(err: dict, where: str) -> None:
    """Raise unless ``flash_errors`` are within the ``FLASH_*`` bounds."""
    if "out_share_over_one_step" in err:
        if err["out_rel_err"] > FLASH_BF16_RTOL or \
                err["out_share_over_one_step"] > FLASH_BF16_OFF_SHARE:
            raise AssertionError(
                f"flash kernel vs plain: out {err['out_rel_err']} (bound "
                f"{FLASH_BF16_RTOL}), {err['out_share_over_one_step']} of "
                f"the elements over one bf16 step apart (bound "
                f"{FLASH_BF16_OFF_SHARE}) {where}")
    elif err["out_rel_err"] > FLASH_F32_RTOL:
        raise AssertionError(f"flash kernel vs plain: out "
                             f"{err['out_rel_err']} (bound {FLASH_F32_RTOL}) "
                             f"{where}")
    if err["lse_rel_err"] > FLASH_LSE_RTOL:
        raise AssertionError(f"flash kernel vs plain: lse "
                             f"{err['lse_rel_err']} (bound {FLASH_LSE_RTOL}) "
                             f"{where}")


def worst_of(errs, keys) -> dict:
    return {key: max(e.get(key, 0.0) for e in errs) for key in keys}


FLASH_ERROR_KEYS = ("out_rel_err", "out_max_abs_err", "lse_rel_err",
                    "out_share_over_one_step")


def phase_check_flash() -> dict:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd, \
        flash_attention_fwd_plain

    errs = []
    for i, (dtype, shape, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(shape, dtype, seed=500 + i)
        o, lse = flash_attention_fwd(q, k, v, causal)
        o2, lse2 = flash_attention_fwd(q, k, v, causal)
        po, plse = flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        if not bitwise:
            raise AssertionError("two flash launches on the same inputs "
                                 "differ")
        if not (bool(torch.isfinite(o.float()).all())
                and bool(torch.isfinite(lse).all())):
            raise AssertionError("flash kernel produced a non-finite value")
        err = flash_errors(o, lse, po, plse)
        emit({"phase": "check_flash", "dtype": dtype,
              "shape_BSHKvD": list(shape), "causal": causal,
              "bitwise_repeat": bitwise, **err,
              "bounds": flash_bounds(dtype)})
        hold_flash(err, f"({dtype}, {shape}, causal={causal})")
        errs.append(err)
    return worst_of(errs, FLASH_ERROR_KEYS)


def flash_bounds(dtype: str) -> dict:
    if dtype == "bfloat16":
        return {"out_rel_err": FLASH_BF16_RTOL,
                "out_share_over_one_step": FLASH_BF16_OFF_SHARE,
                "lse_rel_err": FLASH_LSE_RTOL}
    return {"out_rel_err": FLASH_F32_RTOL, "lse_rel_err": FLASH_LSE_RTOL}


def phase_serve() -> dict:
    """The LM serving path on the card (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ddpg_learn import ddpg_learn
    from repro_torch.kernels.episode_learn import episode_learn
    from repro_torch.kernels.flash_attention import flash_attention_fwd, \
        flash_attention_fwd_plain
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params, model_defs

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(SERVE_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     tree_leaves(params)) / 1e9

    def prompts_of(batch, seq):
        rng = np.random.default_rng(seq)
        return torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)),
                               device="cuda")

    # per prefill and per decode step, the flash launches it made
    per_call = {"prefill": [], "decode": []}

    def counted(kind, make):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **kw):
                before = flash_attention_fwd.launches
                out = step(*a, **kw)
                per_call[kind].append(flash_attention_fwd.launches - before)
                return out
            return run
        return make_counted

    # the attention routes of the comparison runs (ops dispatches a CUDA
    # tensor to the kernel; these runs swap what it calls)
    kernel = ops.flash_attention_fwd
    layer_errs = []

    def plain_route(q, k, v, causal=True):
        return flash_attention_fwd_plain(q, k, v, causal)

    def checked_route(q, k, v, causal=True):
        out, lse = kernel(q, k, v, causal)
        layer_errs.append(flash_errors(
            out, lse, *flash_attention_fwd_plain(q, k, v, causal)))
        return out, lse

    def routed(route, fn):
        ops.flash_attention_fwd = route
        try:
            return fn()
        finally:
            ops.flash_attention_fwd = kernel

    # first use of the kernel library and cuBLAS, outside the counted run
    serve_mod.serve(cfg, prompts_of(1, 128), 2, params=params, device="cuda")
    torch.cuda.synchronize()

    served = []
    make_prefill, make_decode = serve_mod.make_prefill_step, \
        serve_mod.make_decode_step
    serve_mod.make_prefill_step = counted("prefill", make_prefill)
    serve_mod.make_decode_step = counted("decode", make_decode)
    try:
        for batch, seq, gen in SERVE_REQUESTS:
            prompts = prompts_of(batch, seq)
            for kind in per_call:
                per_call[kind].clear()
            torch.cuda.reset_peak_memory_stats()
            flash_attention_fwd.launches = 0
            ddpg_learn.launches = episode_learn.launches = 0
            res = serve_mod.serve(cfg, prompts, gen, params=params,
                                  device="cuda")
            launches = flash_attention_fwd.launches
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if per_call["prefill"] != [cfg.num_layers] or \
                    any(per_call["decode"]) or \
                    len(per_call["decode"]) != gen - 1 or \
                    launches != cfg.num_layers or \
                    ddpg_learn.launches or episode_learn.launches:
                raise AssertionError(
                    f"serve ({batch}x{seq}): flash launches per prefill "
                    f"{per_call['prefill']}, per decode step "
                    f"{per_call['decode']}, in all {launches}; want "
                    f"{cfg.num_layers} per prefill and 0 per decode step")
            if tuple(res.tokens.shape) != (batch, gen) or not bool(
                    torch.isfinite(res.prefill_logits.float()).all()):
                raise AssertionError(f"serve ({batch}x{seq}): tokens "
                                     f"{tuple(res.tokens.shape)} or "
                                     f"non-finite logits")
            served.append((batch, seq, gen, prompts, res, launches, peak_gb,
                           list(per_call["decode"])))
    finally:
        serve_mod.make_prefill_step = make_prefill
        serve_mod.make_decode_step = make_decode

    rows, total = [], 0
    for batch, seq, gen, prompts, res, launches, peak_gb, _ in served:
        total += launches
        where = f"serve ({batch}x{seq})"
        # the kernel on the model's own activations, layer by layer
        layer_errs.clear()
        before = flash_attention_fwd.launches
        routed(checked_route, lambda: serve_mod.make_prefill_step(
            cfg, batch, seq)(params, prompts))
        if len(layer_errs) != cfg.num_layers:
            raise AssertionError(f"{where}: {len(layer_errs)} checked layers")
        for i, err in enumerate(layer_errs):
            hold_flash(err, f"{where}, layer {i}")
        # the whole path through the kernel's plain version, and through
        # the plain reference attention (sdpa_ref): reported
        plain = routed(plain_route, lambda: serve_mod.serve(
            cfg, prompts, gen, params=params, device="cuda"))
        ref = serve_mod.serve(cfg, prompts, gen, params=params,
                              attn_impl="ref", device="cuda")
        if flash_attention_fwd.launches != before + cfg.num_layers:
            raise AssertionError(f"{where}: the plain paths launched the "
                                 f"flash kernel")
        flash_attention_fwd.launches = before  # checking launches not counted

        def versus(other):
            per_layer = [max(rel_err(res.cache[key][i, :, :seq],
                                     other.cache[key][i, :, :seq])
                             for key in ("k", "v"))
                         for i in range(cfg.num_layers)]
            parted = (res.tokens != other.tokens).any(dim=0).nonzero()
            return {"logits_rel_err": rel_err(res.prefill_logits,
                                              other.prefill_logits),
                    "cache_rel_err_per_layer": [float(f"{e:.3g}")
                                                for e in per_layer],
                    "layers_equal": next((i for i, e in enumerate(per_layer)
                                          if e > 0), cfg.num_layers),
                    "first_token_position_differing":
                        int(parted[0]) if parted.numel() else None}

        row = {"phase": "serve", "arch": cfg.name,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "batch": batch, "prompt": seq, "generated": gen,
               "flash_launches_per_prefill": cfg.num_layers,
               "flash_launches_per_decode_step": 0,
               "prefill_ms": res.prefill_seconds * 1e3,
               "decode_ms_per_token": res.decode_seconds / (gen - 1) * 1e3,
               "plain_prefill_ms": plain.prefill_seconds * 1e3,
               "ref_prefill_ms": ref.prefill_seconds * 1e3,
               "peak_memory_gb": peak_gb, "weights_gb": weights_gb,
               "init_seconds": init_s,
               "layers_held": worst_of(layer_errs, FLASH_ERROR_KEYS),
               "layer_bounds": flash_bounds("bfloat16"),
               "vs_plain_version": versus(plain),
               "vs_sdpa_ref": versus(ref),
               "first_sequence": res.tokens[0].tolist()}
        emit(row)
        rows.append(row)
    del params, served
    torch.cuda.empty_cache()
    return {"launches": total, "rows": rows}


def flash_bwd_inputs(shape, dtype, seed: int, causal: bool):
    """``flash_inputs`` and a standard-normal ``dout`` from numpy, with out
    and lse from the forward's plain version: ``(q, k, v, out, lse,
    dout)``."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain

    B, S, H, Kv, D = shape
    q, k, v = flash_inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    dout = torch.as_tensor(rng.standard_normal((B, H, S, D), np.float32)) \
        .to("cuda", getattr(torch, dtype))
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, out, lse, dout


def flash_bwd_errors(got, want) -> dict:
    """Per gradient (dq, dk, dv): max|a - b| / max|b|, max|a - b|, and for
    bfloat16 the share of the elements further apart than one bf16 step of
    the plain value."""
    import torch

    err = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err[f"{name}_rel_err"] = rel_err(a, b)
        err[f"{name}_max_abs_err"] = float((a.float() - b.float()).abs().max())
        if a.dtype == torch.bfloat16:
            steps = bf16_steps(a, b)
            err[f"{name}_share_differing"] = float((steps > 0).float().mean())
            err[f"{name}_share_over_one_step"] = float(
                (steps > 1).float().mean())
    return err


FLASH_BWD_ERROR_KEYS = tuple(f"{g}_{key}" for g in ("dq", "dk", "dv")
                             for key in ("rel_err", "max_abs_err",
                                         "share_over_one_step"))


def flash_bwd_bounds(dtype: str) -> dict:
    if dtype == "bfloat16":
        return {"rel_err": FLASH_BWD_BF16_RTOL,
                "share_over_one_step": FLASH_BWD_BF16_OFF_SHARE}
    return {"rel_err": FLASH_BWD_F32_RTOL}


def hold_flash_bwd(err: dict, dtype: str, where: str,
                   bounds: dict | None = None) -> None:
    """Raise unless ``flash_bwd_errors`` are within ``bounds`` (the
    ``FLASH_BWD_*`` bounds of ``dtype`` by default)."""
    for g in ("dq", "dk", "dv"):
        for key, bound in (bounds or flash_bwd_bounds(dtype)).items():
            if err[f"{g}_{key}"] > bound:
                raise AssertionError(
                    f"flash backward vs plain: {g} {key} {err[f'{g}_{key}']} "
                    f"(bound {bound}) {where}")


def phase_check_flash_bwd() -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa

    plan = fa.check_bwd_smem_fit(128)
    lib = fa.bind_bwd(fa.build.load("flash_attention_bwd"))
    for which, name in ((0, "dq"), (1, "dkv")):
        sizes = (lib.flash_attention_bwd_smem_bytes(128, which),
                 lib.flash_attention_bwd_tc_smem_bytes(
                     which, fa.BWD_TC_STAGES[name]))
        if sizes != (plan[name]["total"], plan[f"{name}_tc"]["total"]) or \
                lib.flash_attention_bwd_tc_stages(which) != \
                fa.BWD_TC_STAGES[name]:
            raise AssertionError(f"{name}: the kernels' shared memory or "
                                 f"stages and bwd_smem_plan disagree")
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    errs = {"bfloat16": [], "float32": []}
    for i, (dtype, shape, causal) in enumerate(FLASH_BWD_CASES):
        inputs = flash_bwd_inputs(shape, dtype, 700 + 2 * i, causal)
        got = fa.flash_attention_bwd(*inputs, causal)
        again = fa.flash_attention_bwd(*inputs, causal)
        want = fa.flash_attention_bwd_plain(*inputs, causal)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bitwise:
            raise AssertionError("two flash backward launches on the same "
                                 "inputs differ")
        if not all(bool(torch.isfinite(g.float()).all()) for g in got):
            raise AssertionError("flash backward produced a non-finite "
                                 "value")
        err = flash_bwd_errors(got, want)
        emit({"phase": "check_flash_bwd", "dtype": dtype,
              "shape_BSHKvD": list(shape), "causal": causal,
              "bitwise_repeat": bitwise, **err,
              "bounds": flash_bwd_bounds(dtype),
              "smem_bytes": {k: v["total"] for k, v in plan.items()}})
        hold_flash_bwd(err, dtype, f"({dtype}, {shape}, causal={causal})")
        errs[dtype].append(err)
    # checking launches are not the main path's
    fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches = before
    return {dtype: worst_of(e, FLASH_BWD_ERROR_KEYS)
            for dtype, e in errs.items()}


def param_sample(params) -> list:
    """The first 65,536 elements of every parameter tensor, copied."""
    from repro_torch.optim.transform import tree_items

    return [(path, p.detach().reshape(-1)[:65536].clone())
            for path, p in tree_items(params)]


def phase_train() -> dict:
    """The training path on the card (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ddpg_learn import ddpg_learn
    from repro_torch.kernels.episode_learn import episode_learn
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, model_defs, param_count
    from repro_torch.optim import global_norm
    from repro_torch.training import TrainConfig, Trainer, TrainerConfig, \
        make_grad_fn, make_train_step

    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(TRAIN_SEED), "cuda")
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model_defs(cfg))
    tc = TrainConfig(remat="full", clip_norm=1.0)
    step_fn = make_train_step(cfg, tx, tc)
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size,
                             global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=0)

    def to_batch(b):
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    counters = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    steps = []

    def counted_step(params, opt_state, batch):
        sample = param_sample(params)
        before = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = sum(int((p.detach().reshape(-1)[:x.numel()] != x).sum())
                    for (_, x), (_, p) in zip(sample, param_sample(params)))
        steps.append({
            "wall_ms": dt * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / dt,
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": [c.launches - b for c, b in zip(counters, before)],
            "sampled_elements_moved": moved,
            "sampled_elements": sum(x.numel() for _, x in sample)})
        return params, opt_state, metrics

    trainer = Trainer(counted_step, pipeline, params, opt_state,
                      TrainerConfig(total_steps=TRAIN_STEPS,
                                    checkpoint_dir="", log_every=1000),
                      to_batch=to_batch)
    for c in counters:
        c.launches = 0
    ddpg_learn.launches = episode_learn.launches = 0
    out = trainer.run()
    launches = [c.launches for c in counters]
    if ddpg_learn.launches or episode_learn.launches or \
            out["step"] != TRAIN_STEPS:
        raise AssertionError(f"train: {out['step']} steps, or a learner "
                             f"kernel launched")
    for i, row in enumerate(steps):
        where = f"train step {i + 1}"
        if row["launches"] != [2 * L, L, L]:
            raise AssertionError(
                f"{where}: forward / dq / dk-dv launches {row['launches']}, "
                f"want {[2 * L, L, L]}")
        if not (math.isfinite(row["loss"])
                and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"{where}: loss {row['loss']}, grad_norm "
                                 f"{row['grad_norm']}")
        if not row["sampled_elements_moved"]:
            raise AssertionError(f"{where}: no sampled parameter moved")
        emit({"phase": "train", "step": i + 1, **row})

    # one more step, the backward kernels held against their plain version
    # on each layer's own (q, k, v, out, lse, dout)
    def routed(fwd, bwd, fn):
        saved = ops.flash_attention_fwd, ops.flash_attention_bwd
        ops.flash_attention_fwd, ops.flash_attention_bwd = fwd, bwd
        try:
            return fn()
        finally:
            ops.flash_attention_fwd, ops.flash_attention_bwd = saved

    held_launches = [c.launches for c in counters]
    batch = to_batch(pipeline.batch(TRAIN_STEPS))
    held_metrics, layer_errs = checked_step(step_fn, params, opt_state, batch)
    if len(layer_errs) != L:
        raise AssertionError(f"train: {len(layer_errs)} checked layers")
    for i, err in enumerate(layer_errs):
        hold_flash_bwd(err, "bfloat16", f"(train, layer {L - 1 - i})")

    # the loss and gradient norm of one batch through the kernels and
    # through their plain versions, from the same parameters: reported
    grad_fn = make_grad_fn(cfg, tc)
    batch = to_batch(pipeline.batch(TRAIN_STEPS + 1))

    def loss_and_norm():
        loss, _, grads = grad_fn(params, batch)
        return float(loss), float(global_norm(grads))

    kernel_loss, kernel_norm = loss_and_norm()
    plain_loss, plain_norm = routed(fa.flash_attention_fwd_plain,
                                    fa.flash_attention_bwd_plain,
                                    loss_and_norm)
    for c, n in zip(counters, held_launches):
        c.launches = n  # checking launches are not counted

    steady = steps[1:] or steps
    row = {"phase": "train", "arch": cfg.name, "layers": L,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab_size,
           "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "remat": tc.remat, "init_seconds": init_s,
           "launches_per_step_fwd_dq_dkv": [2 * L, L, L],
           "launches": launches,
           "median_wall_ms_after_first": statistics.median(
               r["wall_ms"] for r in steady),
           "median_tokens_per_s_after_first": statistics.median(
               r["tokens_per_s"] for r in steady),
           "peak_memory_gb": max(r["peak_memory_gb"] for r in steps),
           "losses": [r["loss"] for r in steps],
           "held_step": {"loss": float(held_metrics["loss"]),
                         "grad_norm": float(held_metrics["grad_norm"]),
                         "layers_held": worst_of(layer_errs,
                                                 FLASH_BWD_ERROR_KEYS),
                         "bounds": flash_bwd_bounds("bfloat16")},
           "second_step_layers": None,
           "vs_plain_versions": {
               "kernel_loss": kernel_loss, "plain_loss": plain_loss,
               "loss_abs_gap": abs(kernel_loss - plain_loss),
               "kernel_grad_norm": kernel_norm, "plain_grad_norm": plain_norm,
               "grad_norm_rel_gap": abs(kernel_norm - plain_norm)
               / max(abs(plain_norm), 1e-30)}}
    del params, opt_state, trainer, step_fn, batch
    torch.cuda.empty_cache()
    row["second_step_layers"] = second_step_layers(cfg, tx, tc, pipeline)
    emit(row)
    return row


def checked_step(step_fn, params, opt_state, batch) -> tuple:
    """One training step with the backward kernels compared with their
    plain version on each layer's own (q, k, v, out, lse, dout): the step's
    metrics (its new parameters and optimizer state are dropped) and each
    layer's ``flash_bwd_errors``, the last layer first."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    kernel_bwd = ops.flash_attention_bwd
    errs = []

    def checked_bwd(q, k, v, o, lse, dout, causal=True):
        got = kernel_bwd(q, k, v, o, lse, dout, causal)
        errs.append(flash_bwd_errors(
            got, fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)))
        return got

    ops.flash_attention_bwd = checked_bwd
    try:
        metrics = step_fn(params, opt_state, batch)[2]
    finally:
        ops.flash_attention_bwd = kernel_bwd
    return metrics, errs


def second_step_layers(cfg, tx, tc, pipeline) -> dict:
    """``checked_step`` on the second step of a fresh run from
    ``TRAIN_SEED`` (the Trainer's second step), each layer held at
    ``FLASH_BWD_STEP2_RTOL`` and ``FLASH_BWD_BF16_OFF_SHARE``. On these
    inputs one element of the largest binade of dk or dv lies a bf16 step
    off on 2 of the 32 layers, over 2^-8 of the largest value, so the
    worst errors and each layer over the ``FLASH_BWD_BF16_*`` bounds are
    also printed."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, model_defs
    from repro_torch.training import make_train_step

    counters = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    saved = [c.launches for c in counters]
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(TRAIN_SEED), "cuda")
    opt_state = tx.init(params)
    step_fn = make_train_step(cfg, tx, tc)
    batches = [{key: torch.as_tensor(x, device="cuda")
                for key, x in pipeline.batch(i).items()} for i in (0, 1)]
    params, opt_state, _ = step_fn(params, opt_state, batches[0])
    _, errs = checked_step(step_fn, params, opt_state, batches[1])
    for c, n in zip(counters, saved):
        c.launches = n  # not the main path's
    del params, opt_state, step_fn, batches
    torch.cuda.empty_cache()
    if len(errs) != cfg.num_layers:
        raise AssertionError(f"train: {len(errs)} checked layers at step 2")
    held = {"rel_err": FLASH_BWD_STEP2_RTOL,
            "share_over_one_step": FLASH_BWD_BF16_OFF_SHARE}
    for i, err in enumerate(errs):
        hold_flash_bwd(err, "bfloat16", f"(train step 2, layer "
                       f"{cfg.num_layers - 1 - i})", held)
    bounds = flash_bwd_bounds("bfloat16")
    over = {cfg.num_layers - 1 - i: {f"{g}_{key}": err[f"{g}_{key}"]
                                     for g in ("dq", "dk", "dv")
                                     for key in bounds}
            for i, err in enumerate(errs)
            if any(err[f"{g}_{key}"] > bound for g in ("dq", "dk", "dv")
                   for key, bound in bounds.items())}
    return {"layers": len(errs), "worst": worst_of(errs, FLASH_BWD_ERROR_KEYS),
            "bounds": held, "layers_over_step5_bounds": over}


def gmm_inputs(shape, dtype, seed: int):
    """x [E, C, D] standard normal and w [E, D, F] scaled by 1/sqrt(D), from
    numpy, on the card in ``dtype``."""
    import numpy as np
    import torch

    E, C, D, F = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D), np.float32)
    w = rng.standard_normal((E, D, F), np.float32) / np.float32(math.sqrt(D))
    return tuple(torch.as_tensor(a).to("cuda", getattr(torch, dtype))
                 for a in (x, w))


def gmm_errors(out, plain) -> dict:
    """The kernel's out against the plain version's: max|a - b| / max|b|
    and max|a - b|; for bfloat16 also the shares of the elements that
    differ at all and by more than one bf16 step of the plain value."""
    import torch

    err = {"rel_err": rel_err(out, plain),
           "max_abs_err": float((out.float() - plain.float()).abs().max())}
    if out.dtype == torch.bfloat16:
        steps = bf16_steps(out, plain)
        err["share_differing"] = float((steps > 0).float().mean())
        err["share_over_one_step"] = float((steps > 1).float().mean())
    return err


def gmm_bounds(dtype: str) -> dict:
    if dtype == "bfloat16":
        return {"rel_err": GMM_BF16_RTOL,
                "share_over_one_step": GMM_BF16_OFF_SHARE}
    return {"rel_err": GMM_F32_RTOL}


def hold_gmm(err: dict, where: str) -> None:
    """Raise unless ``gmm_errors`` are within the ``GMM_*`` bounds."""
    bounds = gmm_bounds("bfloat16" if "share_over_one_step" in err
                        else "float32")
    over = {k: (err[k], b) for k, b in bounds.items() if err[k] > b}
    if over:
        raise AssertionError(f"gmm kernel vs plain {where}: (value, bound) "
                             f"{over}")


GMM_ERROR_KEYS = ("rel_err", "max_abs_err", "share_over_one_step")


def phase_check_gmm() -> dict:
    """The ``gmm`` kernel against its plain version on the same numpy
    inputs (``GMM_CASES``): two launches bitwise equal, finite, within the
    ``GMM_*`` bounds. Returns the worst errors per dtype."""
    import torch

    from repro_torch.kernels.gmm import gmm, gmm_plain

    worst = {}
    for i, (dtype, shape) in enumerate(GMM_CASES):
        x, w = gmm_inputs(shape, dtype, seed=900 + i)
        out = gmm(x, w)
        again = gmm(x, w)
        plain = gmm_plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("two gmm launches on the same inputs "
                                 "differ")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("gmm kernel produced a non-finite value")
        err = gmm_errors(out, plain)
        emit({"phase": "check_gmm", "dtype": dtype,
              "shape_ECDF": list(shape), "bitwise_repeat": True, **err,
              "bounds": gmm_bounds(dtype)})
        hold_gmm(err, f"({dtype}, {shape})")
        worst[dtype] = worst_of([worst.get(dtype, {}), err],
                                [k for k in GMM_ERROR_KEYS if k in err])
        del x, w, out, again, plain
    torch.cuda.empty_cache()
    return worst


def phase_serve_moe() -> dict:
    """The MoE serving path on the card (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.gmm import gmm, gmm_plain
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params, model_defs, moe

    cfg = get_config(MOE_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(MOE_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     tree_leaves(params)) / 1e9
    torch.cuda.empty_cache()   # init's float32 draws

    def prompts_of(batch, seq):
        rng = np.random.default_rng(seq)
        return torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)),
                               device="cuda")

    # per prefill and per decode step: (gmm launches, flash launches)
    per_call = {"prefill": [], "decode": []}

    def counted(kind, make):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **kw):
                before = gmm.launches, flash_attention_fwd.launches
                out = step(*a, **kw)
                per_call[kind].append((gmm.launches - before[0],
                                       flash_attention_fwd.launches
                                       - before[1]))
                return out
            return run
        return make_counted

    # the first use of cuBLAS's bf16 products and the MoE path, outside
    # the counted run
    serve_mod.serve(cfg, prompts_of(1, 128), 2, params=params, device="cuda")
    torch.cuda.synchronize()

    served = []
    make_prefill, make_decode = serve_mod.make_prefill_step, \
        serve_mod.make_decode_step
    serve_mod.make_prefill_step = counted("prefill", make_prefill)
    serve_mod.make_decode_step = counted("decode", make_decode)
    try:
        gmm.launches = flash_attention_fwd.launches = 0
        for batch, seq, gen in MOE_REQUESTS:
            prompts = prompts_of(batch, seq)
            for kind in per_call:
                per_call[kind].clear()
            torch.cuda.reset_peak_memory_stats()
            res = serve_mod.serve(cfg, prompts, gen, params=params,
                                  device="cuda")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            C = moe.capacity(cfg, batch * seq)
            want_gmm = 3 * L if C % ops.GMM_ALIGN == 0 else 0
            if per_call["prefill"] != [(want_gmm, L)] or \
                    per_call["decode"] != [(0, 0)] * (gen - 1):
                raise AssertionError(
                    f"serve_moe ({batch}x{seq}, C {C}): (gmm, flash) "
                    f"launches per prefill {per_call['prefill']}, per "
                    f"decode step {per_call['decode']}; want "
                    f"{(want_gmm, L)} per prefill and none per decode step")
            if tuple(res.tokens.shape) != (batch, gen) or not bool(
                    torch.isfinite(res.prefill_logits.float()).all()):
                raise AssertionError(f"serve_moe ({batch}x{seq}): tokens "
                                     f"{tuple(res.tokens.shape)} or "
                                     f"non-finite logits")
            served.append((batch, seq, gen, C, prompts, res, peak_gb,
                           per_call["prefill"][0]))
        launches = {"gmm": gmm.launches, "flash": flash_attention_fwd.launches}
        if launches["gmm"] != 3 * L:
            raise AssertionError(f"serve_moe: {launches['gmm']} gmm launches "
                                 f"over the requests, want {3 * L}")
    finally:
        serve_mod.make_prefill_step = make_prefill
        serve_mod.make_decode_step = make_decode

    # the aligned request once more: the kernel held against its plain
    # version on each layer's own gate, up and down inputs, then the
    # prefill through the plain version (ops dispatches a CUDA tensor to
    # the kernel; these runs swap what it calls)
    kernel = ops.gmm
    layer_errs = []

    def checked_route(x, w):
        out = kernel(x, w)
        layer_errs.append(gmm_errors(out, gmm_plain(x, w)))
        return out

    def routed(route, fn):
        ops.gmm = route
        try:
            return fn()
        finally:
            ops.gmm = kernel

    rows = []
    for batch, seq, gen, C, prompts, res, peak_gb, prefill_launches in served:
        row = {"phase": "serve_moe", "arch": cfg.name, "layers": L,
               "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
               "top_k": cfg.moe.top_k, "batch": batch, "prompt": seq,
               "generated": gen, "capacity": C,
               "gmm_launches_per_prefill": prefill_launches[0],
               "flash_launches_per_prefill": prefill_launches[1],
               "gmm_launches_per_decode_step": 0,
               "flash_launches_per_decode_step": 0,
               "prefill_ms": res.prefill_seconds * 1e3,
               "decode_ms_per_token": res.decode_seconds / (gen - 1) * 1e3,
               "peak_memory_gb": peak_gb, "weights_gb": weights_gb,
               "init_seconds": init_s,
               "first_sequence": res.tokens[0].tolist()}
        if prefill_launches[0]:
            before = gmm.launches
            layer_errs.clear()
            routed(checked_route, lambda: serve_mod.make_prefill_step(
                cfg, batch, seq + gen)(params, prompts))
            if len(layer_errs) != 3 * L:
                raise AssertionError(f"serve_moe: {len(layer_errs)} checked "
                                     f"products, want {3 * L}")
            for i, err in enumerate(layer_errs):
                hold_gmm(err, f"serve_moe ({batch}x{seq}), layer {i // 3} "
                         f"{('gate', 'up', 'down')[i % 3]}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_logits, _ = routed(gmm_plain, lambda: serve_mod
                                     .make_prefill_step(cfg, batch, seq + gen)
                                     (params, prompts))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if gmm.launches != before + 3 * L:
                raise AssertionError("serve_moe: the plain path launched "
                                     "the gmm kernel")
            gmm.launches = before  # checking launches are not counted
            row.update({
                "layers_held": worst_of(layer_errs, GMM_ERROR_KEYS),
                "layer_bounds": gmm_bounds("bfloat16"),
                "plain_prefill_ms": plain_s * 1e3,
                "vs_plain_version": {
                    "logits_rel_err": rel_err(res.prefill_logits,
                                              plain_logits),
                    "same_greedy_first_token": bool(torch.equal(
                        res.prefill_logits.argmax(-1),
                        plain_logits.argmax(-1)))}})
        emit(row)
        rows.append(row)
    del params, served
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def phase_timing_gmm(smi: str) -> list:
    """CUDA-event medians of ``gmm`` at deepseek-moe-16b's two bf16 serving
    shapes, of its plain version, and of ``torch.bmm`` on the same tensors
    (the yardstick only: the port never calls it on the aligned path),
    beside the bound from ``work()``."""
    import torch

    from repro_torch.kernels.gmm import gmm, gmm_plain, work

    rows = []
    for dtype, shape in GMM_CASES[:2]:
        x, w = gmm_inputs(shape, dtype, seed=950)
        before = gmm.launches
        kernel_ms = time_ms(lambda: gmm(x, w), 20)
        gmm.launches = before  # timing launches are not counted
        plain_ms = time_ms(lambda: gmm_plain(x, w), 5, warmup=1)
        library_ms = time_ms(lambda: torch.bmm(x, w), 20)
        wk = work(*shape, x.element_size())
        flops_ms = wk["flops"] / PEAK_BF16_FLOPS * 1e3
        bytes_ms = wk["bytes"] / PEAK_BYTES * 1e3
        row = {"phase": "timing", "kernel": "gmm", "dtype": dtype,
               "shape_ECDF": list(shape), "ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call": "torch.bmm",
               "bound_ms": max(flops_ms, bytes_ms),
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
               "bound_f32_cuda_cores_ms": wk["flops"] / PEAK_F32_FLOPS * 1e3,
               "flops": wk["flops"], "bytes": wk["bytes"],
               "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
               "tflops": wk["flops"] / kernel_ms / 1e9,
               "vs_library": kernel_ms / library_ms, "card": smi}
        emit(row)
        rows.append(row)
        del x, w
    torch.cuda.empty_cache()
    return rows


def ssd_inputs(shape, dtype, seed: int):
    """x [B H, S, P], dt [B H, S], A [B H], Bm/Cm [B, S, N] from numpy,
    with the reference test's ranges (x N(0, 0.5), dt U(0.1, 0.9), A
    -U(0.5, 2), B and C N(0, 0.3)), on the card; x, Bm, Cm in ``dtype``."""
    import numpy as np
    import torch

    B, H, S, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * H, S, P), np.float32) * np.float32(0.5)
    dt = rng.uniform(0.1, 0.9, (B * H, S)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, B * H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), np.float32) * np.float32(0.3)
    Cm = rng.standard_normal((B, S, N), np.float32) * np.float32(0.3)
    to = getattr(torch, dtype)
    return (torch.as_tensor(x).to("cuda", to), torch.as_tensor(dt).cuda(),
            torch.as_tensor(A).cuda(), torch.as_tensor(Bm).to("cuda", to),
            torch.as_tensor(Cm).to("cuda", to))


def ssd_errors(y, state, py, pstate) -> dict:
    """The kernel's (y, state) against the plain version's: max|a - b| /
    max|b| and max|a - b| of each; for bfloat16 y also the shares of the
    elements that differ at all and by more than one bf16 step."""
    import torch

    err = {"y_rel_err": rel_err(y, py),
           "y_max_abs_err": float((y.float() - py.float()).abs().max()),
           "state_rel_err": rel_err(state, pstate),
           "state_max_abs_err": float((state - pstate).abs().max())}
    if y.dtype == torch.bfloat16:
        steps = bf16_steps(y, py)
        err["y_share_differing"] = float((steps > 0).float().mean())
        err["y_share_over_one_step"] = float((steps > 1).float().mean())
    return err


def ssd_bounds(dtype: str) -> dict:
    if dtype == "bfloat16":
        return {"y_rel_err": SSD_BF16_RTOL,
                "y_share_over_one_step": SSD_BF16_OFF_SHARE,
                "state_rel_err": SSD_BF16_STATE_RTOL}
    return {"y_rel_err": SSD_F32_RTOL, "state_rel_err": SSD_STATE_RTOL}


def hold_ssd(err: dict, where: str, kernel: str = "ssd_scan",
             bounds_of=ssd_bounds) -> None:
    """Raise unless ``ssd_errors`` are within ``bounds_of(dtype)`` (the
    ``SSD_*`` bounds by default)."""
    bounds = bounds_of("bfloat16" if "y_share_over_one_step" in err
                       else "float32")
    over = {k: (err[k], b) for k, b in bounds.items() if not err[k] <= b}
    if over:
        raise AssertionError(f"{kernel} kernel vs plain {where}: (value, "
                             f"bound) {over}")


SSD_ERROR_KEYS = ("y_rel_err", "y_max_abs_err", "state_rel_err",
                  "state_max_abs_err", "y_share_over_one_step")


def phase_check_ssd() -> dict:
    """The ``ssd_scan`` kernel against its plain version on the same numpy
    inputs (``SSD_CASES``): two launches bitwise equal, finite, within the
    ``SSD_*`` bounds. Returns the worst errors per dtype."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import _bind, smem_plan, ssd_scan, \
        ssd_scan_plain, tc_smem_plan

    if _bind(build.load("ssd_scan")).ssd_scan_tc_smem_bytes() != \
            tc_smem_plan()["total"]:
        raise AssertionError("ssd_scan_tc_kernel's shared memory and "
                             "tc_smem_plan disagree")
    worst = {}
    for i, (dtype, shape) in enumerate(SSD_CASES):
        B, H, S, P, N, chunk = shape
        args = ssd_inputs(shape, dtype, seed=1100 + i)
        y, state = ssd_scan(*args, heads=H, chunk=chunk)
        y2, state2 = ssd_scan(*args, heads=H, chunk=chunk)
        py, pstate = ssd_scan_plain(*args, heads=H, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(state, state2)):
            raise AssertionError("two ssd_scan launches on the same inputs "
                                 "differ")
        if not (bool(torch.isfinite(y.float()).all())
                and bool(torch.isfinite(state).all())):
            raise AssertionError("ssd_scan kernel produced a non-finite "
                                 "value")
        err = ssd_errors(y, state, py, pstate)
        emit({"phase": "check_ssd", "dtype": dtype,
              "shape_BHSPN_chunk": list(shape), "bitwise_repeat": True,
              "smem_bytes": tc_smem_plan()["total"] if dtype == "bfloat16"
              else smem_plan(chunk, N, P)["total"], **err,
              "bounds": ssd_bounds(dtype)})
        hold_ssd(err, f"({dtype}, {shape})")
        worst[dtype] = worst_of([worst.get(dtype, {}), err],
                                [k for k in SSD_ERROR_KEYS if k in err])
        del args, y, y2, state, state2, py, pstate
    torch.cuda.empty_cache()
    return worst


def phase_serve_hybrid() -> dict:
    """The hybrid serving path on the card (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd, \
        flash_attention_fwd_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params, model_defs

    cfg = get_config(HYBRID_ARCH)
    L = cfg.num_layers
    n_attn = L // cfg.hybrid_attn_every
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(HYBRID_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     tree_leaves(params)) / 1e9
    torch.cuda.empty_cache()   # init's float32 draws

    def prompts_of(batch, seq):
        rng = np.random.default_rng(seq)
        return torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)),
                               device="cuda")

    # per prefill and per decode step: (ssd_scan launches, flash launches)
    per_call = {"prefill": [], "decode": []}

    def counted(kind, make):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **kw):
                before = ssd_scan.launches, flash_attention_fwd.launches
                out = step(*a, **kw)
                per_call[kind].append((ssd_scan.launches - before[0],
                                       flash_attention_fwd.launches
                                       - before[1]))
                return out
            return run
        return make_counted

    # the first use of cuBLAS's bf16 products and of the kernel, outside
    # the counted run
    serve_mod.serve(cfg, prompts_of(1, 256), 2, params=params, device="cuda")
    torch.cuda.synchronize()

    served = []
    make_prefill, make_decode = serve_mod.make_prefill_step, \
        serve_mod.make_decode_step
    serve_mod.make_prefill_step = counted("prefill", make_prefill)
    serve_mod.make_decode_step = counted("decode", make_decode)
    try:
        ssd_scan.launches = flash_attention_fwd.launches = 0
        for batch, seq, gen in HYBRID_REQUESTS:
            prompts = prompts_of(batch, seq)
            for kind in per_call:
                per_call[kind].clear()
            torch.cuda.reset_peak_memory_stats()
            res = serve_mod.serve(cfg, prompts, gen, params=params,
                                  device="cuda")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want_flash = n_attn if seq % ops.ATTENTION_BLOCK == 0 else 0
            if per_call["prefill"] != [(L, want_flash)] or \
                    per_call["decode"] != [(0, 0)] * (gen - 1):
                raise AssertionError(
                    f"serve_hybrid ({batch}x{seq}): (ssd_scan, flash) "
                    f"launches per prefill {per_call['prefill']}, per "
                    f"decode step {per_call['decode']}; want "
                    f"{(L, want_flash)} per prefill and none per decode "
                    f"step")
            if tuple(res.tokens.shape) != (batch, gen) or not bool(
                    torch.isfinite(res.prefill_logits.float()).all()):
                raise AssertionError(f"serve_hybrid ({batch}x{seq}): tokens "
                                     f"{tuple(res.tokens.shape)} or "
                                     f"non-finite logits")
            if res.cache["state"].dtype != torch.float32 or not bool(
                    torch.isfinite(res.cache["state"]).all()):
                raise AssertionError(f"serve_hybrid ({batch}x{seq}): the "
                                     f"SSM state is not finite float32")
            served.append((batch, seq, gen, prompts, res, peak_gb,
                           per_call["prefill"][0]))
        launches = {"ssd_scan": ssd_scan.launches,
                    "flash": flash_attention_fwd.launches}
        if launches["ssd_scan"] != L * len(HYBRID_REQUESTS):
            raise AssertionError(f"serve_hybrid: {launches['ssd_scan']} "
                                 f"ssd_scan launches over the requests, "
                                 f"want {L * len(HYBRID_REQUESTS)}")
    finally:
        serve_mod.make_prefill_step = make_prefill
        serve_mod.make_decode_step = make_decode

    # the 4 x 4096 request once more: the scan kernel held against its
    # plain version on each layer's own inputs, and the flash kernel (D 112)
    # on each shared attention's, then the prefill through the scan's plain
    # version (ops dispatches a CUDA tensor to the kernels; these runs swap
    # what it calls)
    kernel = ops.ssd_scan
    flash_kernel = ops.flash_attention_fwd
    layer_errs, flash_errs = [], []

    def flash_checked_route(q, k, v, causal=True):
        out, lse = flash_kernel(q, k, v, causal)
        flash_errs.append(flash_errors(
            out, lse, *flash_attention_fwd_plain(q, k, v, causal)))
        return out, lse

    def checked_route(*args, heads, chunk):
        y, state = kernel(*args, heads=heads, chunk=chunk)
        py, pstate = ssd_scan_plain(*args, heads=heads, chunk=chunk)
        layer_errs.append(ssd_errors(y, state, py, pstate))
        return y, state

    def routed(route, fn):
        ops.ssd_scan = route
        try:
            return fn()
        finally:
            ops.ssd_scan = kernel

    rows = []
    for batch, seq, gen, prompts, res, peak_gb, prefill_launches in served:
        row = {"phase": "serve_hybrid", "arch": cfg.name, "layers": L,
               "d_model": cfg.d_model, "ssm_heads": 2 * cfg.d_model
               // cfg.ssm.head_dim, "attention_applications": n_attn,
               "batch": batch, "prompt": seq, "generated": gen,
               "chunk": min(cfg.ssm.chunk, seq),
               "ssd_scan_launches_per_prefill": prefill_launches[0],
               "flash_launches_per_prefill": prefill_launches[1],
               "ssd_scan_launches_per_decode_step": 0,
               "flash_launches_per_decode_step": 0,
               "prefill_ms": res.prefill_seconds * 1e3,
               "decode_ms_per_token": res.decode_seconds / (gen - 1) * 1e3,
               "peak_memory_gb": peak_gb, "weights_gb": weights_gb,
               "init_seconds": init_s,
               "first_sequence": res.tokens[0].tolist()}
        if seq == HYBRID_REQUESTS[0][1]:
            before = ssd_scan.launches, flash_attention_fwd.launches
            layer_errs.clear()
            flash_errs.clear()
            ops.flash_attention_fwd = flash_checked_route
            try:
                routed(checked_route, lambda: serve_mod.make_prefill_step(
                    cfg, batch, seq + gen)(params, prompts))
            finally:
                ops.flash_attention_fwd = flash_kernel
            if len(layer_errs) != L or len(flash_errs) != n_attn:
                raise AssertionError(f"serve_hybrid: {len(layer_errs)} "
                                     f"checked scans, want {L}; "
                                     f"{len(flash_errs)} checked attentions, "
                                     f"want {n_attn}")
            for i, err in enumerate(layer_errs):
                hold_ssd(err, f"serve_hybrid ({batch}x{seq}), layer {i}")
            for i, err in enumerate(flash_errs):
                hold_flash(err, f"serve_hybrid ({batch}x{seq}), attention "
                                f"{i}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_logits, _ = routed(ssd_scan_plain, lambda: serve_mod
                                     .make_prefill_step(cfg, batch, seq + gen)
                                     (params, prompts))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if ssd_scan.launches != before[0] + L:
                raise AssertionError("serve_hybrid: the plain path launched "
                                     "the ssd_scan kernel")
            # checking launches are not counted
            ssd_scan.launches, flash_attention_fwd.launches = before
            row.update({
                "layers_held": worst_of(layer_errs, SSD_ERROR_KEYS),
                "layer_bounds": ssd_bounds("bfloat16"),
                "flash_layers_held": worst_of(flash_errs, FLASH_ERROR_KEYS),
                "flash_layer_bounds": flash_bounds("bfloat16"),
                "plain_prefill_ms": plain_s * 1e3,
                "vs_plain_version": {
                    "logits_rel_err": rel_err(res.prefill_logits,
                                              plain_logits),
                    "same_greedy_first_token": bool(torch.equal(
                        res.prefill_logits.argmax(-1),
                        plain_logits.argmax(-1)))}})
        emit(row)
        rows.append(row)
    del params, served
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def phase_timing_ssd(smi: str) -> list:
    """CUDA-event medians of ``ssd_scan`` and of its plain version at
    zamba2-7b's bf16 serving shape (4 x 4096 tokens: BH 448, chunk 256),
    beside the bound from ``work()`` (no single PyTorch call computes the
    SSD scan, so there is no library time) and the operations the
    tensor-core kernel issues (``tc_operations``: padding and the three
    bf16 terms included)."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain, \
        tc_operations, work

    dtype, shape = SSD_CASES[2]
    B, H, S, P, N, chunk = shape
    args = ssd_inputs(shape, dtype, seed=1150)
    before = ssd_scan.launches
    kernel_ms = time_ms(lambda: ssd_scan(*args, heads=H, chunk=chunk), 5,
                        warmup=1)
    ssd_scan.launches = before  # timing launches are not counted
    plain_ms = time_ms(lambda: ssd_scan_plain(*args, heads=H, chunk=chunk),
                       3, warmup=1)
    wk = work(B * H, S, P, N, chunk, args[0].dtype, heads=H)
    flops_ms = wk["flops"] / PEAK_BF16_FLOPS * 1e3
    bytes_ms = wk["bytes"] / PEAK_BYTES * 1e3
    row = {"phase": "timing", "kernel": "ssd_scan", "dtype": dtype,
           "shape_BHSPN_chunk": list(shape), "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "library_call": "none: no single PyTorch call computes the SSD "
                           "scan",
           "bound_ms": max(flops_ms, bytes_ms),
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "bound_f32_cuda_cores_ms": wk["flops"] / PEAK_F32_FLOPS * 1e3,
           "flops": wk["flops"], "bytes": wk["bytes"],
           "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
           "tflops": wk["flops"] / kernel_ms / 1e9,
           "tc_flops_issued": tc_operations(B * H, S, chunk),
           "tc_tflops_issued": tc_operations(B * H, S, chunk) / kernel_ms
           / 1e9, "card": smi}
    emit(row)
    del args
    torch.cuda.empty_cache()
    return [row]


def wkv_inputs(shape, dtype, seed: int):
    """r, k, v [BH, S, c] ~ 0.5 N(0, 1) in ``dtype``, logw [BH, S, c] =
    -exp(clip(N(0, 1) + w0, -8, 6)) float32 (the model's ``_decay`` clip),
    u [BH, c] ~ 0.5 N(0, 1) in ``dtype``, from numpy, on the card."""
    import numpy as np
    import torch

    BH, S, c, _, w0 = shape
    rng = np.random.default_rng(seed)
    to = getattr(torch, dtype)
    r, k, v = (torch.as_tensor(rng.standard_normal((BH, S, c), np.float32)
                               * np.float32(0.5)).to("cuda", to)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((BH, S, c), np.float32)
                           + np.float32(w0), -8, 6))
    u = rng.standard_normal((BH, c), np.float32) * np.float32(0.5)
    return (r, k, v, torch.as_tensor(logw).cuda(),
            torch.as_tensor(u).to("cuda", to))


def wkv_bounds(dtype: str) -> dict:
    if dtype == "bfloat16":
        return {"y_rel_err": WKV_BF16_RTOL,
                "y_share_over_one_step": WKV_BF16_OFF_SHARE,
                "state_rel_err": WKV_BF16_STATE_RTOL}
    return {"y_rel_err": WKV_F32_RTOL, "state_rel_err": WKV_STATE_RTOL}


def hold_wkv(err: dict, where: str) -> None:
    """Raise unless ``ssd_errors`` of the WKV scan are within the ``WKV_*``
    bounds."""
    hold_ssd(err, where, "wkv6_scan", wkv_bounds)


def phase_check_wkv() -> dict:
    """The ``wkv6_scan`` kernel against its plain version on the same numpy
    inputs (``WKV_CASES``): two launches bitwise equal, finite, within the
    ``WKV_*`` bounds. Returns the worst errors per dtype."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6_scan import _bind, smem_plan, \
        tc_smem_plan, wkv6_scan, wkv6_scan_plain

    if _bind(build.load("wkv6_scan")).wkv6_scan_tc_smem_bytes() != \
            tc_smem_plan()["total"]:
        raise AssertionError("wkv6_scan_tc_kernel's shared memory and "
                             "tc_smem_plan disagree")
    worst = {}
    for i, (dtype, shape) in enumerate(WKV_CASES):
        BH, S, c, chunk, w0 = shape
        args = wkv_inputs(shape, dtype, seed=1200 + i)
        y, state = wkv6_scan(*args, chunk=chunk)
        y2, state2 = wkv6_scan(*args, chunk=chunk)
        py, pstate = wkv6_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(state, state2)):
            raise AssertionError("two wkv6_scan launches on the same inputs "
                                 "differ")
        if not (bool(torch.isfinite(y.float()).all())
                and bool(torch.isfinite(state).all())):
            raise AssertionError("wkv6_scan kernel produced a non-finite "
                                 "value")
        err = ssd_errors(y, state, py, pstate)
        emit({"phase": "check_wkv", "dtype": dtype,
              "shape_BH_S_c_chunk_w0": list(shape), "bitwise_repeat": True,
              "bitwise_equal_to_plain": bool(torch.equal(y, py) and
                                             torch.equal(state, pstate)),
              "smem_bytes": tc_smem_plan()["total"] if dtype == "bfloat16"
              else smem_plan(chunk, c)["total"], **err,
              "bounds": wkv_bounds(dtype)})
        hold_wkv(err, f"({dtype}, {shape})")
        worst[dtype] = worst_of([worst.get(dtype, {}), err],
                                [k for k in SSD_ERROR_KEYS if k in err])
        del args, y, y2, state, state2, py, pstate
    torch.cuda.empty_cache()
    return worst


def rwkv_tokens(cfg, batch: int, seq: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seq)
    return torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)),
                           device="cuda")


def phase_forward_rwkv() -> dict:
    """The full-sequence forward of rwkv6-3b on the card (see the module
    docstring): the scoring and loss path, one ``wkv6_scan`` launch per
    time-mix block."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6_scan import wkv6_scan, wkv6_scan_plain
    from repro_torch.models import forward, init_params, model_defs
    from repro_torch.training.losses import cross_entropy

    cfg = get_config(RWKV_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(RWKV_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     tree_leaves(params)) / 1e9
    torch.cuda.empty_cache()   # init's float32 draws

    def run(tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = forward(cfg, params, tokens)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    # the first use of cuBLAS's bf16 products and of the kernel at the
    # request's shapes, outside the counted run
    for batch, seq in RWKV_FORWARD:
        run(rwkv_tokens(cfg, batch, seq))
    torch.cuda.empty_cache()

    rows, kept = [], {}
    wkv6_scan.launches = 0
    for batch, seq in RWKV_FORWARD:
        tokens = rwkv_tokens(cfg, batch, seq)
        torch.cuda.reset_peak_memory_stats()
        before = wkv6_scan.launches
        logits, seconds = run(tokens)
        launched = wkv6_scan.launches - before
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if launched != L:
            raise AssertionError(f"forward_rwkv ({batch}x{seq}): {launched} "
                                 f"wkv6_scan launches, want {L}")
        if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or not bool(
                torch.isfinite(logits.float()).all()):
            raise AssertionError(f"forward_rwkv ({batch}x{seq}): logits "
                                 f"{tuple(logits.shape)} or non-finite")
        with torch.no_grad():
            ce = float(cross_entropy(logits[:, :-1], tokens[:, 1:]))
        if not math.isfinite(ce):
            raise AssertionError(f"forward_rwkv ({batch}x{seq}): "
                                 f"cross-entropy {ce}")
        row = {"phase": "forward_rwkv", "arch": cfg.name, "layers": L,
               "d_model": cfg.d_model, "heads": cfg.d_model
               // cfg.rwkv_head_size, "batch": batch, "tokens": seq,
               "scan_length": -(-seq // 64) * 64 if seq >= 64 else seq,
               "wkv6_scan_launches": launched, "forward_ms": seconds * 1e3,
               "tokens_per_s": batch * seq / seconds,
               "cross_entropy": ce, "log_vocab": math.log(cfg.vocab_size),
               "peak_memory_gb": peak_gb, "weights_gb": weights_gb,
               "init_seconds": init_s}
        if seq == RWKV_FORWARD[0][1]:
            kept = {"tokens": tokens, "logits": logits, "row": row}
        else:
            emit(row)
            rows.append(row)
        del logits
    launches = wkv6_scan.launches
    if launches != L * len(RWKV_FORWARD):
        raise AssertionError(f"forward_rwkv: {launches} wkv6_scan launches, "
                             f"want {L * len(RWKV_FORWARD)}")

    # the 4 x 4096 forward once more: the kernel held against its plain
    # version on each layer's own inputs, then the forward through the
    # plain version (ops dispatches a CUDA tensor to the kernel; these runs
    # swap what it calls)
    kernel = ops.wkv6_scan
    layer_errs = []

    def checked_route(*args, chunk):
        y, state = kernel(*args, chunk=chunk)
        py, pstate = wkv6_scan_plain(*args, chunk=chunk)
        layer_errs.append(ssd_errors(y, state, py, pstate))
        return y, state

    def routed(route):
        ops.wkv6_scan = route
        try:
            return run(kept["tokens"])
        finally:
            ops.wkv6_scan = kernel

    routed(checked_route)
    if len(layer_errs) != L:
        raise AssertionError(f"forward_rwkv: {len(layer_errs)} checked "
                             f"scans, want {L}")
    for i, err in enumerate(layer_errs):
        hold_wkv(err, f"forward_rwkv, layer {i}")
    plain_logits, plain_s = routed(wkv6_scan_plain)
    if wkv6_scan.launches != launches + L:
        raise AssertionError("forward_rwkv: the plain path launched the "
                             "wkv6_scan kernel")
    wkv6_scan.launches = launches  # checking launches are not counted
    row = kept["row"]
    row.update({
        "layers_held": worst_of(layer_errs, SSD_ERROR_KEYS),
        "layer_bounds": wkv_bounds("bfloat16"),
        "plain_forward_ms": plain_s * 1e3,
        "vs_plain_version": {
            "logits_rel_err": rel_err(kept["logits"], plain_logits),
            "logits_max_abs_err": float((kept["logits"].float()
                                         - plain_logits.float()).abs().max()),
            "same_argmax_share": float((kept["logits"].argmax(-1)
                                        == plain_logits.argmax(-1))
                                       .float().mean())}})
    emit(row)
    rows.insert(0, row)
    del params, kept, plain_logits
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def phase_serve_rwkv() -> dict:
    """The RWKV6 serving path on the card (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6_scan import wkv6_scan
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params, model_defs

    cfg = get_config(RWKV_ARCH)
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(RWKV_SEED), "cuda")
    torch.cuda.empty_cache()   # init's float32 draws
    per_call = {"prefill": [], "decode": []}

    def counted(kind, make):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **kw):
                before = wkv6_scan.launches
                out = step(*a, **kw)
                per_call[kind].append(wkv6_scan.launches - before)
                return out
            return run
        return make_counted

    # the first use of the serving path's products, outside the counted run
    serve_mod.serve(cfg, rwkv_tokens(cfg, 1, 256), 2, params=params,
                    device="cuda")
    torch.cuda.synchronize()

    rows = []
    make_prefill, make_decode = serve_mod.make_prefill_step, \
        serve_mod.make_decode_step
    serve_mod.make_prefill_step = counted("prefill", make_prefill)
    serve_mod.make_decode_step = counted("decode", make_decode)
    try:
        wkv6_scan.launches = 0
        for batch, seq, gen in RWKV_REQUESTS:
            for kind in per_call:
                per_call[kind].clear()
            torch.cuda.reset_peak_memory_stats()
            res = serve_mod.serve(cfg, rwkv_tokens(cfg, batch, seq), gen,
                                  params=params, device="cuda")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if per_call["prefill"] != [0] or \
                    per_call["decode"] != [0] * (gen - 1):
                raise AssertionError(
                    f"serve_rwkv ({batch}x{seq}): wkv6_scan launches per "
                    f"prefill {per_call['prefill']}, per decode step "
                    f"{per_call['decode']}; want none (prefill runs "
                    f"wkv_chunked, decode the recurrence)")
            if tuple(res.tokens.shape) != (batch, gen) or not bool(
                    torch.isfinite(res.prefill_logits.float()).all()):
                raise AssertionError(f"serve_rwkv ({batch}x{seq}): tokens "
                                     f"{tuple(res.tokens.shape)} or "
                                     f"non-finite logits")
            state = res.cache["state"]
            if state.dtype != cfg.compute_dtype or not bool(
                    torch.isfinite(state.float()).all()):
                raise AssertionError(f"serve_rwkv ({batch}x{seq}): the WKV "
                                     f"state is {state.dtype} or not "
                                     f"finite; want finite "
                                     f"{cfg.compute_dtype}")
            row = {"phase": "serve_rwkv", "arch": cfg.name,
                   "layers": cfg.num_layers, "batch": batch, "prompt": seq,
                   "generated": gen,
                   "wkv6_scan_launches_per_prefill": per_call["prefill"][0],
                   "wkv6_scan_launches_per_decode_step": 0,
                   "prefill_ms": res.prefill_seconds * 1e3,
                   "decode_ms_per_token":
                       res.decode_seconds / (gen - 1) * 1e3,
                   "state_dtype": str(state.dtype).removeprefix("torch."),
                   "peak_memory_gb": peak_gb,
                   "first_sequence": res.tokens[0].tolist()}
            emit(row)
            rows.append(row)
            del res, state
        launches = wkv6_scan.launches
    finally:
        serve_mod.make_prefill_step = make_prefill
        serve_mod.make_decode_step = make_decode
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def sm_clock_max_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_timing_wkv(smi: str) -> dict:
    """CUDA-event medians of ``wkv6_scan`` and of its plain version at
    rwkv6-3b's bf16 forward shape (4 x 4096 tokens: BH 160, chunk 64, c
    64), beside the bound from ``work()`` (the operations, exps counted as
    one each, over the bf16 tensor rate, or the bytes, whichever is
    larger), the same operations on the float32 CUDA cores, the SFUs'
    floor for one exp per pair and channel (``work``'s exps at 16 a clock
    per SM at the highest SM clock) and the operations the tensor-core
    kernel issues (``tc_operations``: zero fill and terms included). No
    single PyTorch call computes the WKV scan, so there is no library
    time."""
    import torch

    from repro_torch.kernels.wkv6_scan import tc_operations, wkv6_scan, \
        wkv6_scan_plain, work

    dtype, shape = WKV_TIMED
    BH, S, c, chunk, _ = shape
    args = wkv_inputs(shape, dtype, seed=1250)
    before = wkv6_scan.launches
    kernel_ms = time_ms(lambda: wkv6_scan(*args, chunk=chunk), 5, warmup=1)
    wkv6_scan.launches = before  # timing launches are not counted
    plain_ms = time_ms(lambda: wkv6_scan_plain(*args, chunk=chunk), 3,
                       warmup=1)
    wk = work(BH, S, c, chunk, args[0].dtype)
    flops_ms = wk["flops"] / PEAK_BF16_FLOPS * 1e3
    bytes_ms = wk["bytes"] / PEAK_BYTES * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issued = tc_operations(BH, S, chunk)
    row = {"phase": "timing", "kernel": "wkv6_scan", "dtype": dtype,
           "shape_BH_S_c_chunk_w0": list(shape), "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "library_call": "none: no single PyTorch call computes the WKV "
                           "scan",
           "bound_ms": max(flops_ms, bytes_ms),
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "bound_f32_cuda_cores_ms": wk["flops"] / PEAK_F32_FLOPS * 1e3,
           "sfu_floor_ms": wk["exps"] / (sms * SFU_EXPS_PER_CLOCK_PER_SM
                                         * sm_clock_max_hz()) * 1e3,
           "flops": wk["flops"], "exps": wk["exps"], "bytes": wk["bytes"],
           "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
           "tflops": wk["flops"] / kernel_ms / 1e9,
           "tc_flops_issued": issued,
           "tc_tflops_issued": issued / kernel_ms / 1e9, "card": smi}
    emit(row)
    del args
    torch.cuda.empty_cache()
    return row


def phase_profile() -> None:
    """``--profile``: ``torch.profiler`` over the serving path of Yi-9B, for
    each request one prefill and then 3 decode steps (after an untimed
    prefill that warms the libraries): the wall time, the device time of
    every kernel summed (one stream, so the device's busy time), the busy
    share, the flash kernel's time, and the ten kernels that took longest."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params, model_defs

    cfg = get_config(SERVE_ARCH)
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(SERVE_SEED), "cuda")
    decode_steps = 3
    for batch, seq, _ in SERVE_REQUESTS:
        rng = np.random.default_rng(seq)
        prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                               (batch, seq)), device="cuda")
        prefill = serve_mod.make_prefill_step(cfg, batch, seq + decode_steps)
        decode = serve_mod.make_decode_step(cfg)
        logits, cache = prefill(params, prompts)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        runs = (("prefill", 1, lambda: prefill(params, prompts)),
                ("decode", decode_steps,
                 lambda: [decode(params, tok, cache, seq + i)
                          for i in range(decode_steps)]))
        for step, calls, fn in runs:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            emit({"phase": "profile", "batch": batch, "prompt": seq,
                  "step": step, "calls": calls,
                  "wall_ms_per_call": wall_ms / calls,
                  "device_ms_per_call": device_ms / calls,
                  "device_busy_share": device_ms / wall_ms,
                  "flash_ms_per_call": sum(
                      e.self_device_time_total for e in kernels
                      if "flash_fwd" in e.key) / 1e3 / calls,
                  "kernel_launches_per_call": sum(e.count for e in kernels)
                  / calls,
                  "top_kernels": [[e.key[:70], e.self_device_time_total
                                   / 1e3 / calls, e.count // calls]
                                  for e in top[:10]]})


def phase_profile_train() -> None:
    """``--profile-train``: ``torch.profiler`` over one training step of
    phi4-mini-3.8b at the ``train`` phase's size (after one untimed step
    that warms the libraries): the wall time, the device time of every
    kernel summed (one stream, so the device's busy time), the busy share,
    the device time by group (the three flash kernels, cuBLAS products, the
    rest), and the ten kernels that took longest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, model_defs
    from repro_torch.training import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    params = init_params(model_defs(cfg), torch.Generator(
        device="cuda").manual_seed(TRAIN_SEED), "cuda")
    tx = make_optimizer(cfg)
    state = tx.init(params)
    step = make_train_step(cfg, tx, TrainConfig(remat="full", clip_norm=1.0))
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size,
                             global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in pipeline.batch(i).items()} for i in range(2)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batches[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
              "gemm": 0.0, "other": 0.0}
    for e in kernels:
        name = next((g for g in groups if g in e.key), None)
        if name is None:
            name = "gemm" if any(s in e.key.lower() for s in (
                "gemm", "cutlass", "xmma", "nvjet")) else "other"
        groups[name] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    emit({"phase": "profile_train", "arch": cfg.name, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "wall_ms": wall_ms, "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "device_ms_by_group": groups,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3,
                           e.count] for e in top[:10]]})


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def sdpa_ms(q, k, v, causal: bool, runs: int = 20) -> tuple:
    """CUDA-event median of PyTorch's ``scaled_dot_product_attention`` on
    the kernel layout (the yardstick only: the port never calls it) and
    the call's name."""
    import torch.nn.functional as F

    try:
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), runs), \
            "scaled_dot_product_attention(enable_gqa=True)"
    except TypeError:  # a PyTorch without enable_gqa: expand k/v first
        g = q.shape[1] // k.shape[1]
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal), runs), \
            "scaled_dot_product_attention(k/v expanded)"


#: (dtype, (B, S, H, Kv, D), causal) of the flash forward's timings: the
#: serving shapes of Yi-9B (4 x 512 and 1 x 4096) and zamba2-7b (4 x 4096,
#: D 112), then deepseek-moe-16b's 4 x 4096 prefill (16 heads, no GQA)
FLASH_TIMING = (*FLASH_CASES[:3], ("bfloat16", (4, 4096, 16, 16, 128), True))
#: what the ``kernels`` line repeats of each flash forward timing
FLASH_ROW_KEYS = ("shape_BSHKvD", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "tflops", "bound_share", "vs_library")


def phase_timing_flash(smi: str) -> list:
    """CUDA-event medians of ``flash_attention_fwd`` at the serving shapes
    of ``FLASH_TIMING`` (bf16, causal: the tensor-core kernel), of its plain
    version, and of PyTorch's ``scaled_dot_product_attention`` on the same
    tensors (the yardstick only: the port never calls it), beside the bound
    from ``work()``: TFLOP/s and the share of the bound from the 4 D
    operations per pair that ``work()`` counts."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    rows = []
    for dtype, shape, causal in FLASH_TIMING:
        B, S, H, Kv, D = shape
        q, k, v = flash_inputs(shape, dtype, seed=600)
        before = fa.flash_attention_fwd.launches
        kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                            20)
        fa.flash_attention_fwd.launches = before  # timing launches not counted
        plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v,
                                                                causal),
                           5, warmup=1)
        library_ms, library_call = sdpa_ms(q, k, v, causal)
        w = fa.work(B, H, Kv, S, D, causal, q.element_size())
        flops_ms = w["flops"] / PEAK_BF16_FLOPS * 1e3
        bytes_ms = w["bytes"] / PEAK_BYTES * 1e3
        row = {"phase": "timing", "kernel": "flash_attention_fwd",
               "dtype": dtype, "shape_BSHKvD": list(shape), "causal": causal,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_call": library_call,
               "bound_ms": max(flops_ms, bytes_ms),
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
               "bound_f32_cuda_cores_ms": w["flops"] / PEAK_F32_FLOPS * 1e3,
               "flops": w["flops"], "bytes": w["bytes"],
               "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
               "tflops": w["flops"] / kernel_ms / 1e9,
               "vs_library": kernel_ms / library_ms, "card": smi}
        emit(row)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_timing_flash_train(smi: str) -> list:
    """CUDA-event medians at phi4-mini-3.8b's training shape (bf16,
    causal): ``flash_attention_fwd``, ``flash_attention_dq`` and
    ``flash_attention_dkv``, each beside its plain version, its bound
    (``work``, ``work_bwd``) and PyTorch's
    ``scaled_dot_product_attention`` (its forward, and its backward, which
    computes dq, dk and dv in one call; the yardstick only: the port never
    calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dtype, shape, causal = FLASH_BWD_CASES[0]
    B, S, H, Kv, D = shape
    q, k, v, out, lse, dout = flash_bwd_inputs(shape, dtype, 800, causal)
    delta = (dout.float() * out.float()).sum(-1)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    try:
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True)
        call = "scaled_dot_product_attention(enable_gqa=True)"
    except TypeError:  # a PyTorch without enable_gqa: expand k/v first
        ks, vs = (x.repeat_interleave(H // Kv, dim=1).detach()
                  .requires_grad_() for x in (k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        call = "scaled_dot_product_attention(k/v expanded)"
    library_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, **({"enable_gqa": True}
                                      if "gqa" in call else {})), 20)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), dout, retain_graph=True), 20)

    counters = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    before = [c.launches for c in counters]
    runs = (
        ("flash_attention_fwd", lambda: fa.flash_attention_fwd(q, k, v, True),
         lambda: fa.flash_attention_fwd_plain(q, k, v, True),
         fa.work(B, H, Kv, S, D, causal, q.element_size()),
         library_fwd_ms, call),
        ("flash_attention_dq",
         lambda: fa.flash_attention_dq(q, k, v, dout, lse, delta, True),
         lambda: fa.flash_attention_dq_plain(q, k, v, dout, lse, delta, True),
         fa.work_bwd(B, H, Kv, S, D, causal, q.element_size())["dq"],
         library_bwd_ms, call + " backward (dq, dk and dv)"),
        ("flash_attention_dkv",
         lambda: fa.flash_attention_dkv(q, k, v, dout, lse, delta, True),
         lambda: fa.flash_attention_dkv_plain(q, k, v, dout, lse, delta,
                                              True),
         fa.work_bwd(B, H, Kv, S, D, causal, q.element_size())["dkv"],
         library_bwd_ms, call + " backward (dq, dk and dv)"))
    rows = []
    for name, kernel, plain, w, library_ms, library_call in runs:
        kernel_ms = time_ms(kernel, 10)
        plain_ms = time_ms(plain, 5, warmup=1)
        flops_ms = w["flops"] / PEAK_BF16_FLOPS * 1e3
        bytes_ms = w["bytes"] / PEAK_BYTES * 1e3
        row = {"phase": "timing", "kernel": name, "dtype": dtype,
               "shape_BSHKvD": list(shape), "causal": causal,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_call": library_call,
               "bound_ms": max(flops_ms, bytes_ms),
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
               "bound_f32_cuda_cores_ms": w["flops"] / PEAK_F32_FLOPS * 1e3,
               "flops": w["flops"], "bytes": w["bytes"],
               "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
               "tflops": w["flops"] / kernel_ms / 1e9,
               "vs_library": kernel_ms / library_ms, "card": smi}
        emit(row)
        rows.append(row)
    single = fa.work_bwd(B, H, Kv, S, D, causal, q.element_size())
    emit({"phase": "timing", "kernel": "flash backward, single pass",
          "bound_ms": max(single["single_pass"]["flops"] / PEAK_BF16_FLOPS,
                          single["single_pass"]["bytes"] / PEAK_BYTES) * 1e3,
          **single["single_pass"]})
    for c, n in zip(counters, before):
        c.launches = n  # timing launches are not counted
    return rows


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(configs, smi: str) -> list:
    from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain, \
        work

    rows = []
    for name, cfg in configs.items():
        for n in (1, SEED_SESSIONS):
            state, batches = fleet_inputs(cfg, n, seed=200, device="cuda")
            ks, ps = clone_state(state), clone_state(state)
            before = ddpg_learn.launches
            kernel_ms = time_ms(lambda: ddpg_learn(ks, batches, cfg=cfg), 20)
            ddpg_learn.launches = before  # timing launches are not counted
            plain_ms = time_ms(
                lambda: ddpg_learn_plain(ps, batches, cfg=cfg),
                20 if n == 1 else PLAIN_TIMED_RUNS, warmup=1)
            w = work(cfg, n, UPDATES)
            flops_ms = w["flops"] / PEAK_F32_FLOPS * 1e3
            bytes_ms = w["bytes"] / PEAK_BYTES * 1e3
            row = {"phase": "timing", "space": name, "sessions": n,
                   "updates": UPDATES, "ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": max(flops_ms, bytes_ms),
                   "bound_by": "operations" if flops_ms >= bytes_ms
                   else "bytes",
                   "flops": w["flops"], "bytes": w["bytes"],
                   "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
                   "latency_floor_ms": learner_floor_ms(cfg, UPDATES)
                   if n == 1 else None,
                   "library_ms": None, "card": smi}
            emit(row)
            rows.append(row)
    return rows


def phase_timing_episode(smi: str) -> list:
    """CUDA-event times of one ``episode_learn`` launch (its pre-draw timed
    apart) at N = 1 and N = 1,024 sessions, of the plain version at N = 1,
    and the bound from ``work()``. The N = 1,024 operands tile 64
    independent sessions 16 times."""
    import torch

    from repro_torch.kernels import episode_learn as el

    rows = []
    for space in ("2d", "8d"):
        base, spec = episode_inputs(space, 64, seed=400, device="cuda")
        for n in (1, SEED_SESSIONS):
            reps = max(1, n // 64)
            op = tree_map(lambda x: x[:n].repeat(
                reps, *([1] * (x.dim() - 1))).contiguous(), base)
            t = op.use_warmup.shape[1]
            plain_op = clone_tree(op)
            # predraw advances the keys in place: one fresh copy per call,
            # made before the timed calls
            fresh = [clone_tree(op) for _ in range(4)]
            predraw_ms = time_ms(lambda: el.predraw(fresh.pop(), spec), 3,
                                 warmup=1)
            draws = el.predraw(op, spec)
            before = el.episode_learn.launches
            # repeated launches continue the same sessions' state: the
            # same work per launch
            kernel_ms = time_ms(lambda: el.launch(op, spec, *draws),
                                5 if n == 1 else 3, warmup=1)
            el.episode_learn.launches = before  # timing launches not counted
            plain_ms = None
            if n == 1:
                plain_ms = time_ms(
                    lambda: el.episode_learn_plain(plain_op, spec=spec), 1,
                    warmup=0)
            w = el.work(spec.cfg, n, t, CAPACITY, spec.model.n_samples)
            flops_ms = w["flops"] / PEAK_F32_FLOPS * 1e3
            bytes_ms = w["bytes"] / PEAK_BYTES * 1e3
            row = {"phase": "timing", "kernel": "episode_learn",
                   "space": space, "sessions": n, "steps": t,
                   "updates": spec.num_updates, "ms": kernel_ms,
                   "predraw_ms": predraw_ms, "plain_ms": plain_ms,
                   "bound_ms": max(flops_ms, bytes_ms),
                   "bound_by": "operations" if flops_ms >= bytes_ms
                   else "bytes",
                   "flops": w["flops"], "bytes": w["bytes"],
                   "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
                   "ms_per_step": kernel_ms / t,
                   "latency_floor_ms": learner_floor_ms(
                       spec.cfg, spec.num_updates, t) if n == 1 else None,
                   "library_ms": None, "card": smi}
            emit(row)
            rows.append(row)
    return rows


def timed(seconds: dict, name: str, fn, *args):
    """``fn(*args)``, its wall seconds added to ``seconds[name]`` and
    printed to the standard error as the phase ends (so that a run cut
    short still says where its time went)."""
    t0 = time.perf_counter()
    out = fn(*args)
    dt = time.perf_counter() - t0
    seconds[name] = seconds.get(name, 0.0) + dt
    print(f"[seconds] {name} {dt:.1f} (run so far "
          f"{sum(seconds.values()):.1f})", file=sys.stderr, flush=True)
    return out


def tree_map(fn, x):
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(tree_map(fn, y) for y in x))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    run_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.kernels import build

    seconds: dict = {}
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = build.build_all()
    for name, entry in log.items():
        print(f"[{name}] nvcc -Xptxas -v:\n{entry['ptxas']}", file=sys.stderr)
    gmm_build = tc_build(log, "gmm", "gmm_tc_kernel")
    flash_build = tc_build(log, "flash_attention_fwd", "flash_fwd_tc_kernel")
    bwd_build = {kernel: tc_build(log, "flash_attention_bwd", kernel)
                 for kernel in ("flash_dq_tc_kernel", "flash_dkv_tc_kernel")}
    ssd_build = tc_build(log, "ssd_scan", "ssd_scan_tc_kernel")
    wkv_build = tc_build(log, "wkv6_scan", "wkv6_scan_tc_kernel")
    configs = {"2d": DDPGConfig(state_dim=12, action_dim=2),
               "8d": DDPGConfig(state_dim=12, action_dim=8)}
    from repro_torch.envs import LustreSimEnv
    n_samples = LustreSimEnv("seq_write", seed=0).to_model_env(
        device="cpu").model.n_samples
    learners = learner_build(log, configs, n_samples)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in log.items()},
          **learners, "gmm_tc_kernel": gmm_build,
          "flash_fwd_tc_kernel": flash_build, **bwd_build,
          "ssd_scan_tc_kernel": ssd_build, "wkv6_scan_tc_kernel": wkv_build})

    if sys.argv[1:] == ["--drift"]:
        phase_drift()
        return 0
    if sys.argv[1:] == ["--profile"]:
        phase_profile()
        return 0
    if sys.argv[1:] == ["--profile-train"]:
        phase_profile_train()
        return 0
    if sys.argv[1:] == ["--layer-steps"]:
        phase_layer_steps(smi)
        return 0
    seconds["build"] = time.perf_counter() - run_t0
    err = timed(seconds, "check", phase_check, configs)
    ep_err = timed(seconds, "check_episode", phase_check_episode)
    tunes = [timed(seconds, "tune", phase_tune, space, 30)
             for space in ("2d", "8d")]
    scans = [timed(seconds, "tune_scan", phase_tune_scan, space, EP_STEPS)
             for space in ("2d", "8d")]
    fleets = [timed(seconds, "fleet", phase_fleet, space, smi)
              for space in ("2d", "8d")]
    service = timed(seconds, "service", phase_service, smi)
    guard = timed(seconds, "guard", phase_guard, smi)
    resilience = timed(seconds, "resilience", phase_resilience, smi)
    share = timed(seconds, "share", phase_share, smi)
    flash_err = timed(seconds, "check_flash", phase_check_flash)
    bwd_err = timed(seconds, "check_flash_bwd", phase_check_flash_bwd)
    served = timed(seconds, "serve", phase_serve)
    trained = timed(seconds, "train", phase_train)
    gmm_err = timed(seconds, "check_gmm", phase_check_gmm)
    moe = timed(seconds, "serve_moe", phase_serve_moe)
    ssd_err = timed(seconds, "check_ssd", phase_check_ssd)
    hybrid = timed(seconds, "serve_hybrid", phase_serve_hybrid)
    wkv_err = timed(seconds, "check_wkv", phase_check_wkv)
    rwkv_fwd = timed(seconds, "forward_rwkv", phase_forward_rwkv)
    rwkv_serve = timed(seconds, "serve_rwkv", phase_serve_rwkv)
    rows = timed(seconds, "timing", phase_timing, configs, smi)
    ep_rows = timed(seconds, "timing", phase_timing_episode, smi)
    flash_rows = timed(seconds, "timing", phase_timing_flash, smi)
    train_rows = {r["kernel"]: r for r in timed(
        seconds, "timing", phase_timing_flash_train, smi)}
    gmm_rows = timed(seconds, "timing", phase_timing_gmm, smi)
    ssd_row = timed(seconds, "timing", phase_timing_ssd, smi)[0]
    wkv_row = timed(seconds, "timing", phase_timing_wkv, smi)
    rwkv_held = next(r for r in rwkv_fwd["rows"] if "layers_held" in r)
    moe_held = next(r for r in moe["rows"] if "layers_held" in r)
    hybrid_held = next(r for r in hybrid["rows"] if "layers_held" in r)
    emit({"phase": "run", "seconds": time.perf_counter() - run_t0,
          "per_phase_seconds": seconds})

    main_row = next(r for r in rows
                    if r["space"] == "2d" and r["sessions"] == SEED_SESSIONS)
    ep_row = next(r for r in ep_rows
                  if r["space"] == "2d" and r["sessions"] == SEED_SESSIONS)
    ep_plain = next(r for r in ep_rows
                    if r["space"] == "2d" and r["sessions"] == 1)
    emit({"kernels": [{
        "name": "ddpg_learn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ddpg_learn.cu",
        "replaces": "src/repro/kernels/ddpg_fused.py:316",
        "launches": sum(t["kernel_launches"] for t in tunes)
        + sum(f["host"]["launches"] for f in fleets) + guard["launches"]
        + resilience["launches"] + share["launches"],
        "launches_by_path": {
            "tune": sum(t["kernel_launches"] for t in tunes),
            "fleet_host": sum(f["host"]["launches"] for f in fleets),
            "guarded": guard["launches"],
            "resilient": resilience["launches"],
            "shared": share["launches"]},
        "max_abs_err": err["max_abs_err"],
        "median_rel_err": err["median_rel_err"],
        "p90_rel_err": err["p90_rel_err"], "max_rel_err": err["max_rel_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "sessions": SEED_SESSIONS, "ok": True}, {
        "name": "episode_learn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/episode_learn.cu",
        "replaces": "src/repro/kernels/episode_fused.py:266",
        "launches": sum(t["kernel_launches"] for t in scans)
        + sum(r["launches"] for f in fleets for r in f["scan"])
        + service["launches"],
        "launches_by_path": {
            "tune_scan": sum(t["kernel_launches"] for t in scans),
            "fleet_scan": sum(r["launches"] for f in fleets
                              for r in f["scan"]),
            "service": service["launches"]},
        "max_abs_err": ep_err["max_abs_err"],
        "median_rel_err": ep_err["median_rel_err"],
        "p90_rel_err": ep_err["p90_rel_err"],
        "max_rel_err": ep_err["max_rel_err"],
        "learner_median_rel_err": ep_err["learner_median_rel_err"],
        "learner_p90_rel_err": ep_err["learner_p90_rel_err"],
        "window_median_rel_err": ep_err["window_median_rel_err"],
        "window_p90_rel_err": ep_err["window_p90_rel_err"],
        "ms": ep_row["ms"], "plain_ms": ep_plain["plain_ms"],
        "plain_sessions": 1,
        "bound_ms": ep_row["bound_ms"],
        "bound_by": ep_row["bound_by"], "library_ms": None,
        "sessions": SEED_SESSIONS, "steps": EP_STEPS, "ok": True}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": served["launches"] + trained["launches"][0]
        + moe["launches"]["flash"] + hybrid["launches"]["flash"],
        "launches_by_path": {"serve": served["launches"],
                             "train": trained["launches"][0],
                             "serve_moe": moe["launches"]["flash"],
                             "serve_hybrid": hybrid["launches"]["flash"]},
        "max_abs_err": flash_err["out_max_abs_err"],
        "out_rel_err": flash_err["out_rel_err"],
        "bf16_share_over_one_step": flash_err["out_share_over_one_step"],
        "lse_rel_err": flash_err["lse_rel_err"],
        "serve_layers_held": [r["layers_held"] for r in served["rows"]],
        "serve_hybrid_layers_held": hybrid_held["flash_layers_held"],
        "ms": flash_rows[0]["ms"], "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"],
        "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"],
        "library_call": flash_rows[0]["library_call"],
        "shape_BSHKvD": flash_rows[0]["shape_BSHKvD"], "dtype": "bfloat16",
        "tflops": flash_rows[0]["tflops"],
        "bound_share": flash_rows[0]["bound_share"],
        "vs_library": flash_rows[0]["vs_library"],
        "tc_kernel": flash_build,
        **{at: {key: row[key] for key in FLASH_ROW_KEYS}
           for at, row in (("at_S4096", flash_rows[1]),
                           ("at_zamba2", flash_rows[2]),
                           ("at_deepseek", flash_rows[3]),
                           ("at_training_shape",
                            train_rows["flash_attention_fwd"]))},
        "ok": True},
        *({"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": replaces, "launches": trained["launches"][index],
           "max_abs_err": max(bwd_err["bfloat16"][f"{g}_max_abs_err"]
                              for g in grads),
           "rel_err": {g: bwd_err["bfloat16"][f"{g}_rel_err"] for g in grads},
           "bf16_share_over_one_step": {
               g: bwd_err["bfloat16"][f"{g}_share_over_one_step"]
               for g in grads},
           "f32_rel_err": {g: bwd_err["float32"][f"{g}_rel_err"]
                           for g in grads},
           "train_layers_held": {
               key: trained["held_step"]["layers_held"][key]
               for key in FLASH_BWD_ERROR_KEYS if key[:2] in grads},
           "ms": train_rows[name]["ms"],
           "plain_ms": train_rows[name]["plain_ms"],
           "bound_ms": train_rows[name]["bound_ms"],
           "bound_by": train_rows[name]["bound_by"],
           "library_ms": train_rows[name]["library_ms"],
           "library_call": train_rows[name]["library_call"],
           "shape_BSHKvD": train_rows[name]["shape_BSHKvD"],
           "dtype": "bfloat16", "tflops": train_rows[name]["tflops"],
           "bound_share": train_rows[name]["bound_share"],
           "vs_library": train_rows[name]["vs_library"],
           "tc_kernel": bwd_build[kernel], "ok": True}
          for name, kernel, replaces, index, grads in (
              ("flash_attention_dq", "flash_dq_tc_kernel",
               "src/repro/kernels/flash_attention.py:124", 1, ("dq",)),
              ("flash_attention_dkv", "flash_dkv_tc_kernel",
               "src/repro/kernels/flash_attention.py:160", 2,
               ("dk", "dv")))), {
        "name": "gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:35",
        "launches": moe["launches"]["gmm"],
        "max_abs_err": gmm_err["bfloat16"]["max_abs_err"],
        "rel_err": gmm_err["bfloat16"]["rel_err"],
        "bf16_share_over_one_step":
            gmm_err["bfloat16"]["share_over_one_step"],
        "f32_rel_err": gmm_err["float32"]["rel_err"],
        "serve_layers_held": moe_held["layers_held"],
        "ms": gmm_rows[0]["ms"], "plain_ms": gmm_rows[0]["plain_ms"],
        "bound_ms": gmm_rows[0]["bound_ms"],
        "bound_by": gmm_rows[0]["bound_by"],
        "library_ms": gmm_rows[0]["library_ms"],
        "library_call": gmm_rows[0]["library_call"],
        "shape_ECDF": gmm_rows[0]["shape_ECDF"], "dtype": "bfloat16",
        "tflops": gmm_rows[0]["tflops"],
        "bound_share": gmm_rows[0]["bound_share"],
        "vs_library": gmm_rows[0]["vs_library"],
        "tc_kernel": gmm_build,
        "at_down_shape": {key: gmm_rows[1][key] for key in (
            "shape_ECDF", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tflops", "bound_share", "vs_library")},
        "ok": True}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan.py:69",
        "launches": hybrid["launches"]["ssd_scan"],
        "launches_by_path": {"serve_hybrid": hybrid["launches"]["ssd_scan"]},
        "max_abs_err": ssd_err["bfloat16"]["y_max_abs_err"],
        "y_rel_err": ssd_err["bfloat16"]["y_rel_err"],
        "bf16_share_over_one_step":
            ssd_err["bfloat16"]["y_share_over_one_step"],
        "state_rel_err": max(ssd_err[d]["state_rel_err"]
                             for d in ("bfloat16", "float32")),
        "f32_y_rel_err": ssd_err["float32"]["y_rel_err"],
        "serve_layers_held": hybrid_held["layers_held"],
        "ms": ssd_row["ms"], "plain_ms": ssd_row["plain_ms"],
        "bound_ms": ssd_row["bound_ms"], "bound_by": ssd_row["bound_by"],
        "bound_f32_cuda_cores_ms": ssd_row["bound_f32_cuda_cores_ms"],
        "library_ms": None, "library_call": ssd_row["library_call"],
        "shape_BHSPN_chunk": ssd_row["shape_BHSPN_chunk"],
        "dtype": "bfloat16", "tflops": ssd_row["tflops"],
        "bound_share": ssd_row["bound_share"],
        "tc_tflops_issued": ssd_row["tc_tflops_issued"],
        "tc_kernel": ssd_build, "ok": True}, {
        "name": "wkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6.py:69",
        "launches": rwkv_fwd["launches"] + rwkv_serve["launches"],
        "launches_by_path": {"forward_rwkv": rwkv_fwd["launches"],
                             "serve_rwkv": rwkv_serve["launches"]},
        "max_abs_err": wkv_err["bfloat16"]["y_max_abs_err"],
        "y_rel_err": wkv_err["bfloat16"]["y_rel_err"],
        "bf16_share_over_one_step":
            wkv_err["bfloat16"]["y_share_over_one_step"],
        "state_rel_err": max(wkv_err[d]["state_rel_err"]
                             for d in ("bfloat16", "float32")),
        "f32_y_rel_err": wkv_err["float32"]["y_rel_err"],
        "forward_layers_held": rwkv_held["layers_held"],
        "ms": wkv_row["ms"], "plain_ms": wkv_row["plain_ms"],
        "bound_ms": wkv_row["bound_ms"], "bound_by": wkv_row["bound_by"],
        "library_ms": None, "library_call": wkv_row["library_call"],
        "shape_BH_S_c_chunk_w0": wkv_row["shape_BH_S_c_chunk_w0"],
        "dtype": "bfloat16", "ok": True}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
