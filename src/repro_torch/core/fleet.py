"""Fleet tuning: many Magpie sessions through one learner launch.

The paper's headline numbers (91.8% average throughput gain, Fig. 4/5) come
from repeating whole tuning sessions across workloads, objectives and seeds.
This module makes that axis first-class:

  * ``FleetAgent`` — N independent DDPG learners (different seeds) stacked
    on a leading session axis. One ``learn()`` call is ONE launch of the
    CUDA learner ``kernels/csrc/ddpg_learn.cu`` for the whole fleet
    (``core.ddpg.fleet_learn_scan``), one thread block per session.
  * ``FleetTuner`` — runs a seeds x workloads x objectives grid of tuning
    sessions concurrently against per-session environments: with
    ``engine="host"`` step by step over the numpy simulator (its surface
    vectorized over the fleet, ``envs/lustre_sim.py::
    batch_mean_performance``), with ``engine="scan"`` as whole episodes of
    the episode kernel ``kernels/csrc/episode_learn.cu``, streamed chunk by
    chunk (``core.episode.run_fleet_episode_scan``). Returns one
    ``TuningResult`` per session plus aggregate gain statistics mirroring
    the paper's reporting.

Sessions are independent: a fleet of one reproduces the single
``Tuner``/``MagpieAgent`` pair exactly (same seed, same trajectory); the
fleet axis buys throughput and never changes the algorithm.

The persistent ``FleetService``, whose sessions join and leave while the
fleet runs, is ``core.service``. The policy layers of a scan fleet each run
the per-step body, one learner launch a step per chunk: ``policy`` (a
``core.guardrails.DeploymentPolicy``) guards every session, ``resilience``
(a ``core.resilience.ResiliencePolicy``) heals them, and ``sharing`` (a
``core.sharing.SharingConfig``) shares experience within cells of sessions
or masks their observations. ``supervisor`` and ``chaos`` supervise the
chunk stream on the host. bfloat16 replay storage is ROADMAP item A7b and
a fleet across several cards A11d; each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.core.agent import lhs_warmup_plan
from repro_torch.core.ddpg import (
    DDPGConfig,
    DDPGState,
    OUNoise,
    fleet_act,
    fleet_init,
    fleet_learn_scan,
    state_layout,
)
from repro_torch.core.episode import resolve_layers, tree_map
from repro_torch.core.replay_buffer import BatchedReplayBuffer, _is_float32
from repro_torch.core.scalarization import Scalarizer, normalize_state
from repro_torch.core.tuner import (
    StepRecord,
    TuningResult,
    evaluate_config,
)
from repro_torch.device import resolve_device


class FleetAgent:
    """N ``MagpieAgent``-equivalent learners batched over a session axis.

    Session i is seeded exactly like ``MagpieAgent(cfg, seed=seeds[i])``:
    the same network init key, warmup plan, OU-noise stream and minibatch
    key, so its behaviour does not depend on the fleet it runs in.

    ``device`` (``cuda`` unless given) is where the fleet learns and acts.
    ``store="device"`` keeps the stacked learner state and replay windows
    there; ``store="host"`` keeps them in CPU tensors (page-locked on a
    card), initialized ``init_chunk`` sessions at a time: the streaming
    chunked episode runtime stages one chunk at a time, so a 1,024-session
    fleet never holds its whole state on the card. Either way each session's
    values are the same bits. ``replay_groups`` (one cell id per session)
    merges each cell's replay into one shared window
    (``BatchedReplayBuffer(groups=...)``, shared replay). ``replay_dtype``
    other than float32 (ROADMAP A7b) raises.
    """

    def __init__(self, cfg: DDPGConfig, seeds: Sequence[int],
                 buffer_capacity: int = 64, warmup_steps: int = 8,
                 store: str = "device", replay_dtype=torch.float32,
                 init_chunk: Optional[int] = None, replay_groups=None,
                 device=None):
        if not seeds:
            raise ValueError("need at least one session seed")
        if store not in ("device", "host"):
            raise ValueError(f"unknown store {store!r}; use 'device' or "
                             f"'host'")
        self.cfg = cfg
        self.seeds = list(seeds)
        self.num_sessions = len(self.seeds)
        self.warmup_steps = warmup_steps
        self.store = store
        self.device = resolve_device(device)
        self.buffer = BatchedReplayBuffer(
            self.num_sessions, buffer_capacity, cfg.state_dim,
            cfg.action_dim, storage_dtype=replay_dtype,
            storage_backend=store, groups=replay_groups, device=self.device)
        keys = torch.stack([jrandom.PRNGKey(s) for s in self.seeds])
        if store == "host":
            ic = int(init_chunk) if init_chunk else min(64,
                                                        self.num_sessions)
            parts = [fleet_init(keys[i:i + ic], cfg, "cpu")
                     for i in range(0, self.num_sessions, ic)]
            pin = self.device.type == "cuda"
            self.states = DDPGState(*(
                torch.cat(xs).pin_memory() if pin else torch.cat(xs)
                for xs in zip(*parts)))
        else:
            self.states = fleet_init(keys, cfg, self.device)
        self.noises = [OUNoise(cfg.action_dim, seed=s + 1)
                       for s in self.seeds]
        self._learn_keys = torch.stack([jrandom.PRNGKey(s + 3)
                                        for s in self.seeds])
        self.steps_taken = 0
        self.last_metrics: dict = {}
        # per-session Latin-hypercube warmup plans (MagpieAgent's, per seed)
        self._warmup_plans = np.stack([
            lhs_warmup_plan(np.random.default_rng(s + 2), warmup_steps,
                            cfg.action_dim)
            for s in self.seeds])  # [N, warmup_steps, action_dim]

    # -- acting -------------------------------------------------------------

    def act(self, states: np.ndarray, explore: bool = True) -> np.ndarray:
        """Actions ``[N, m]`` for per-session states ``[N, k]`` (one
        lockstep fleet step); ``fleet_act`` on the device, so session i
        acts as ``MagpieAgent.act`` would."""
        if explore and self.steps_taken < self.warmup_steps:
            a = self._warmup_plans[:, self.steps_taken].copy()
        else:
            actor_floats = state_layout(self.cfg).offsets[1][0][0]
            # the actor's columns only: with a host store, only they cross
            flat = self.states.flat[:, :actor_floats].to(self.device)
            x = torch.as_tensor(np.asarray(states, np.float32),
                                device=self.device)
            a = fleet_act(flat, x, self.cfg).cpu().numpy()
            if explore:
                a = a + np.stack([noise() for noise in self.noises])
        self.steps_taken += 1
        return np.clip(a, 0.0, 1.0).astype(np.float32)

    # -- learning -----------------------------------------------------------

    def observe(self, states, actions, rewards, next_states) -> None:
        """One transition per session; each argument has a leading [N]
        axis."""
        self.buffer.add(states, actions, rewards, next_states)

    def learn(self, updates: Optional[int] = None) -> dict:
        """All sessions' ``updates`` gradient steps in ONE learner call
        (``fleet_learn_scan``: one kernel launch on the card). Returns
        {metric: [N] array}, each session's value from its last update."""
        if len(self.buffer) == 0:
            return {}  # learning before the first observe() is a no-op
        n = self.cfg.updates_per_step if updates is None else updates
        if n <= 0:
            return {}
        pair = jrandom.split_keys(self._learn_keys)  # [N, 2, 2]
        self._learn_keys, keys = pair[:, 0].contiguous(), pair[:, 1]
        data, sizes = self.buffer.storage()
        states = DDPGState(*(x.to(self.device) for x in self.states))
        states, metrics = fleet_learn_scan(states, data, sizes, keys,
                                           self.cfg, n)
        if self.store == "host":
            for dst, src in zip(self.states, states):
                dst.copy_(src)
        self.last_metrics = {k: v[:, -1].cpu().numpy()
                             for k, v in metrics.items()}
        return self.last_metrics


@dataclasses.dataclass
class FleetResult:
    """Per-session results + the paper's aggregate reporting (Fig. 4/5)."""

    results: list   # TuningResult per session
    labels: list    # human-readable session labels, parallel to ``results``
    wall_seconds: float

    def gains(self, metric: str) -> np.ndarray:
        """Proportional best-vs-default gain per session for ``metric``."""
        return np.array([r.gain(metric) for r in self.results])

    def summary(self, metric: str = "throughput") -> dict:
        """Aggregate gain statistics across sessions (mean/percentiles)."""
        g = self.gains(metric)
        return {
            "sessions": len(g),
            "mean": float(g.mean()),
            "std": float(g.std()),
            "min": float(g.min()),
            "p25": float(np.percentile(g, 25)),
            "p50": float(np.percentile(g, 50)),
            "p75": float(np.percentile(g, 75)),
            "max": float(g.max()),
        }

    def by_label(self, label: str) -> TuningResult:
        return self.results[self.labels.index(label)]


def replay_compact_trace(env, trace, i: int, *, start: int, per_step: float,
                         prev_config: dict, best_objective: float,
                         restart_seconds: float = 0.0,
                         finite_baseline: bool = False) -> dict:
    """Reconstruct session ``i``'s decision history from a compact trace.

    The scan engine returns action INDICES and fixed-point restarts; this
    decodes them into the exact ``StepRecord`` stream the host engine would
    have produced. Mutates ``env`` exactly like the host loop: appends
    ``restart_events`` and sets ``_last_config``.

    Returns a dict: ``records`` (list of StepRecord), ``cur_config`` /
    ``cur_metrics`` (the post-episode session state; ``cur_metrics`` is None
    for an empty trace), ``best`` (None, or the new best
    config/metrics/objective beating ``best_objective``) and
    ``restart_seconds`` (the running total, accumulated step by step from
    the passed-in value so the float addition order matches the host loop).

    ``finite_baseline=True`` (the reference's resilient engines) makes
    ``cur_metrics`` the LAST all-finite metrics row, and ``None`` when no
    row is finite.
    """
    steps = trace.rewards.shape[1]
    configs = env.param_space.configs_from_indices(trace.action_idx[i])
    names = env.state_metrics
    records, best = [], None
    for t in range(steps):
        metrics = {n: float(v) for n, v in zip(names, trace.metrics[i, t])}
        objective = float(trace.objectives[i, t])
        restart = float(trace.restarts[i, t])
        restart_seconds += restart
        if restart > 0:
            env.restart_events.append(
                (env._scope(configs[t], prev_config), restart))
        if objective > (best["objective"] if best else best_objective):
            best = {"objective": objective, "config": dict(configs[t]),
                    "metrics": dict(metrics)}
        records.append(StepRecord(
            step=start + t, config=configs[t], metrics=metrics,
            objective=objective, reward=float(trace.rewards[i, t]),
            restart_seconds=restart, action_seconds=per_step,
            learn_seconds=0.0,
        ))
        prev_config = configs[t]
    cur_config = configs[-1] if steps else prev_config
    cur_metrics = None
    if steps:
        last = steps - 1
        if finite_baseline:
            finite = np.isfinite(trace.metrics[i]).all(axis=1)
            last = int(np.nonzero(finite)[0][-1]) if finite.any() else None
        if last is not None:
            cur_metrics = {n: float(v)
                           for n, v in zip(names, trace.metrics[i, last])}
    env._last_config = dict(cur_config)
    return {"records": records, "cur_config": cur_config,
            "cur_metrics": cur_metrics, "best": best,
            "restart_seconds": restart_seconds}


def evaluate_fleet(envs: Sequence, configs: Sequence, runs: int) -> list:
    """``evaluate_config(envs[i], configs[i], runs)`` for every session.

    Pure-model environments (``ModelEnv``) of one model structure on one
    device step together: one batched model step per run for all sessions,
    each session's metrics summed over the runs in Python floats and divided
    once, and each env's state, last config and scope left as its own
    ``apply`` calls would leave them. The model's step is elementwise per
    session, so on a card each session gets the bits of its own
    ``evaluate_config``; on the CPU, where vectorized and scalar
    transcendentals may round differently, a fleet of one does. Any other
    environments are evaluated one by one."""
    models = {getattr(e, "model", None) for e in envs}
    batched = (None not in models and len({m.step_fn for m in models}) == 1
               and len({e.device for e in envs}) == 1)
    if not batched:
        return [evaluate_config(e, c, runs) for e, c in zip(envs, configs)]
    for e, c in zip(envs, configs):
        if not e.param_space.validate(c):
            raise ValueError(f"invalid config {c}")
    model, device = envs[0].model, envs[0].device
    actions = torch.as_tensor(np.stack([
        e.param_space.to_action(c) for e, c in zip(envs, configs)]),
        device=device)
    state = tree_map(lambda *xs: torch.stack(xs),
                     *(e.model_state for e in envs))
    params = type(envs[0].params)(*(torch.stack(x) for x in zip(
        *(e.params for e in envs))))
    acc = [dict() for _ in envs]
    for _ in range(runs):
        with torch.no_grad():
            state, vec, _ = model.step(state, actions, eval_run=True,
                                       params=params)
        for a, row in zip(acc, vec.cpu().numpy()):
            for name, v in zip(envs[0].state_metrics, row):
                a[name] = a.get(name, 0.0) + float(v)
    for i, (e, c) in enumerate(zip(envs, configs)):
        e.model_state = tree_map(lambda x: x[i], state)
        for _ in range(runs):
            e._last_scope = e._scope(c, e._last_config)
            e._last_config = dict(c)
    return [{k: v / runs for k, v in a.items()} for a in acc]


def recommend_final_fleet(envs: Sequence, scalarizers: Sequence,
                          best_configs: Sequence,
                          policy_configs: Sequence, runs: int) -> list:
    """``core.tuner.recommend_final`` of every session, its evaluations
    through ``evaluate_fleet``: the best configurations seen first, then
    the policy configurations that differ from them, each env in the single
    tuner's order. Returns ``(config, evaluated_metrics, replaced)`` per
    session."""
    finals = evaluate_fleet(envs, best_configs, runs)
    out = [(dict(c), m, False) for c, m in zip(best_configs, finals)]
    differ = [i for i, (p, b) in enumerate(zip(policy_configs, best_configs))
              if p != b]
    tried = evaluate_fleet([envs[i] for i in differ],
                           [policy_configs[i] for i in differ], runs)
    for i, metrics in zip(differ, tried):
        sc = scalarizers[i]
        if sc.objective(metrics) > sc.objective(finals[i]):
            out[i] = (dict(policy_configs[i]), metrics, True)
    return out


class FleetTuner:
    """N concurrent Magpie tuning sessions sharing one fused learner.

    Each session owns its environment and scalarizer (workloads and
    objectives may differ across the fleet); the agent is a ``FleetAgent``
    whose session i mirrors ``MagpieAgent(cfg, seed=seeds[i])``. The loop
    is the Fig. 1 loop of ``core.tuner.Tuner``, executed in lockstep across
    sessions: with ``engine="host"`` all N x ``updates_per_step`` gradient
    steps of a fleet step are one launch of the learner kernel; with
    ``engine="scan"`` a chunk of sessions' whole episodes is one launch of
    the episode kernel.

    ``device`` (``cuda`` unless given) must be the agent's. Evaluations
    (the default configurations, the final recommendation) go through
    ``evaluate_fleet``. The layers run on the scan engine only (the
    reference's ``ValueError`` elsewhere), and ``policy`` composes with no
    other (``ValueError``). ``policy`` (``core.guardrails.
    DeploymentPolicy``) guards every session: per-session counters,
    ``guard_events`` ``[N, T]``, ``shadow_objectives`` and
    ``guardrail_stats(i)``; the guard persists across ``run()`` calls.
    ``resilience`` (``core.resilience.ResiliencePolicy``) heals every
    session: ``health_events`` ``[N, T]`` and ``health_stats(i)``, the
    health state persisting across ``run()`` calls, and the histories
    replayed with a finite baseline (a corrupted reading never becomes a
    session's state). ``sharing`` (``core.sharing.SharingConfig``) with a
    cell mode runs cells of ``cell_size`` consecutive sessions (shared
    replay needs the agent's grouped buffer); its observation scopes mask
    the learners' view. ``supervisor`` (``core.resilience.
    ChunkSupervisor``) and ``chaos`` (``envs.faults.HostChaos``, needing a
    supervisor) supervise the chunk stream. ``devices`` naming more than
    one card is ROADMAP item A11d (``NotImplementedError``).

    ``timings`` holds the host seconds of the last construction and run by
    part: ``default_eval``; for the scan engine ``episode`` (the streamed
    fleet episode), ``replay`` (``replay_compact_trace`` of every session);
    for the host engine ``act``, ``env`` and ``learn`` (summed over steps);
    and ``final`` (the final recommendation with its evaluations).
    """

    def __init__(self, envs: Sequence, scalarizers: Sequence[Scalarizer],
                 agent: FleetAgent, eval_runs: int = 3, labels=None,
                 vectorized: Optional[bool] = None, engine: str = "host",
                 devices: Optional[Sequence] = None,
                 chunk: Optional[int] = None, overlap: bool = True,
                 policy=None, sharing=None, cell_size: int = 1,
                 resilience=None, supervisor=None, chaos=None,
                 device=None):
        if not (len(envs) == len(scalarizers) == agent.num_sessions):
            raise ValueError("envs, scalarizers and agent sessions must align")
        if engine not in ("host", "scan"):
            raise ValueError(f"unknown engine {engine!r}; use 'host' or 'scan'")
        if policy is not None and engine != "scan":
            raise ValueError(
                "DeploymentPolicy guardrails run inside the episode; use "
                "engine='scan' (the host loop has no shadow/canary body)")
        from repro_torch.core.sharing import normalize_sharing
        sharing = normalize_sharing(sharing)
        if sharing is not None and engine != "scan":
            raise ValueError(
                "experience sharing runs inside the episode scan; use "
                "engine='scan' (the host loop keeps sessions independent)")
        if resilience is not None:
            from repro_torch.core.resilience import normalize_resilience
            resilience = normalize_resilience(resilience)
        if resilience is not None and engine != "scan":
            raise ValueError(
                "ResiliencePolicy runs inside the episode scan; use "
                "engine='scan' (the host loop has no snapshot/reset body)")
        if supervisor is not None:
            from repro_torch.core.resilience import normalize_supervisor
            supervisor = normalize_supervisor(supervisor)
        if (supervisor is not None or chaos is not None) and engine != "scan":
            raise ValueError(
                "chunk supervision is a scan-engine feature (the host loop "
                "has no chunk stream to supervise)")
        layers = resolve_layers(policy, resilience, None, sharing,
                                cell_size)
        self.cell_size = layers.cell_size
        if layers.cells and len(envs) % self.cell_size != 0:
            raise ValueError(
                f"experience sharing needs whole cells: {len(envs)} sessions "
                f"is not a multiple of cell_size={self.cell_size}")
        if layers.shared_replay and agent.buffer.groups is None:
            raise ValueError(
                "shared replay needs a grouped replay buffer: build the "
                "fleet with from_grid(sharing=...) or pass "
                "FleetAgent(..., replay_groups=...)")
        self.sharing = sharing
        device = resolve_device(device)
        if device.type != agent.device.type or None not in (
                device.index, agent.device.index) and \
                device.index != agent.device.index:
            raise ValueError(f"the agent runs on {agent.device}, not on "
                             f"{device}")
        if engine == "scan" and any(getattr(e, "model", None) is None
                                    for e in envs):
            raise ValueError(
                "engine='scan' needs pure-model environments (ModelEnv); "
                "build the fleet with from_grid(engine='scan') or pass "
                "ModelEnv instances")
        if devices is not None and engine != "scan":
            raise ValueError("devices= is a scan-engine feature")
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "a fleet across several cards is ROADMAP item A11d; pass "
                "one device")
        if chunk is not None and engine != "scan":
            raise ValueError("chunk= streaming is a scan-engine feature")
        if chunk is not None and chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.engine = engine
        self.devices = list(devices) if devices else None
        self.chunk = chunk
        self.overlap = overlap  # chunks on copy streams (scan engine)
        self.policy = policy
        self._guard = None  # stacked GuardState, persists across run() calls
        self.guard_events = np.zeros((len(envs), 0), np.uint8)
        self.shadow_objectives = np.zeros((len(envs), 0), np.float32)
        self._guard_counters: Optional[list] = None  # one dict per session
        self.resilience = resilience
        self.supervisor = supervisor
        self.chaos = chaos
        self._health = None  # stacked HealthState, persists across run()
        self.health_events = np.zeros((len(envs), 0), np.uint8)
        self._health_counters: Optional[list] = None  # one dict per session
        self.envs = list(envs)
        self.scalarizers = list(scalarizers)
        self.agent = agent
        from repro_torch.core.sharing import resolve_obs_mask
        self._obs_mask = resolve_obs_mask(
            self.sharing, self.envs[0].metric_specs,
            self.envs[0].state_metrics)
        self.eval_runs = eval_runs
        self.labels = list(labels) if labels else [
            f"session{i}" for i in range(len(self.envs))]
        if vectorized is None:
            from repro_torch.envs.lustre_sim import LustreSimEnv
            vectorized = (engine == "host" and
                          all(isinstance(e, LustreSimEnv) for e in self.envs))
        self.vectorized = vectorized
        self.histories: list = [[] for _ in self.envs]
        self.simulated_restart_seconds = np.zeros(len(self.envs))
        self.timings: dict = {}
        t0 = time.perf_counter()
        self.default_configs = [e.param_space.default_config()
                                for e in self.envs]
        self.default_metrics = evaluate_fleet(self.envs, self.default_configs,
                                              eval_runs)
        self.timings["default_eval"] = time.perf_counter() - t0
        self._cur_configs = [dict(c) for c in self.default_configs]
        self._cur_metrics = [dict(m) for m in self.default_metrics]
        self.best_configs = [dict(c) for c in self.default_configs]
        self.best_metrics = [dict(m) for m in self.default_metrics]
        self.best_objectives = [
            sc.objective(m)
            for sc, m in zip(self.scalarizers, self.default_metrics)]

    # ------------------------------------------------------------------

    @classmethod
    def from_grid(cls, workloads: Sequence[str],
                  objectives: Sequence[Mapping[str, float]],
                  seeds: Sequence[int], *, env_factory=None, env_cls=None,
                  ddpg_config: Optional[DDPGConfig] = None,
                  buffer_capacity: int = 64, warmup_steps: int = 8,
                  eval_runs: int = 3, extended: bool = False,
                  engine: str = "host",
                  devices: Optional[Sequence] = None,
                  chunk: Optional[int] = None, overlap: bool = True,
                  replay_dtype=torch.float32, policy=None,
                  sharing=None, resilience=None, supervisor=None,
                  chaos=None, device=None) -> "FleetTuner":
        """Build a fleet for the full seeds x workloads x objectives grid.

        ``env_factory(workload, seed)`` defaults to ``env_cls(workload,
        seed=seed)`` with ``env_cls=LustreSimEnv``, the paper's evaluation
        environment; pass ``env_cls=LustreSimV2`` for the 8-knob space. The
        agent's dims come from the environments' ``ParamSpace``
        (``DDPGConfig.for_env``). Every grid cell is an independent tuning
        session; session seeds are offset per cell (``seed + 1000 *
        cell``) so no two sessions share a random stream.

        ``engine="scan"`` builds each cell as a pure-model environment
        (``env.to_model_env(device=device)``) and runs whole fleet episodes
        through the streaming chunked runtime (``core.episode``):
        ``chunk=C`` runs the grid as chunks of C sessions, one episode
        kernel launch each, with the fleet's state in host memory between
        chunks (the agent is built with ``store="host"``), while
        ``chunk=None`` runs one chunk of the whole grid. Per-session keys
        come from the cell seed alone, so on the card the results do not
        depend on the chunk size. ``overlap`` (default on) streams the
        chunks on copy streams beside the compute stream, bitwise the
        serial schedule.

        ``policy``, ``resilience``, ``supervisor`` and ``chaos`` apply to
        every session (``FleetTuner``). ``sharing`` shares experience
        within each workload x objective CELL: the ``len(seeds)``
        consecutive sessions that tune one surface under different seeds
        (with shared replay the agent's buffer is built grouped by cell).
        ``device`` is where the fleet runs: ``cuda`` unless given, so
        without a card the caller must pass ``"cpu"``. ``replay_dtype``
        other than float32 (ROADMAP A7b) and more than one device (A11d)
        raise ``NotImplementedError``."""
        from repro_torch.core.sharing import normalize_sharing
        sharing = normalize_sharing(sharing)
        device = resolve_device(device)
        if env_factory is not None and env_cls is not None:
            raise ValueError(
                "pass env_factory OR env_cls, not both — env_cls would be "
                "silently ignored")
        if env_factory is None:
            from repro_torch.envs.lustre_sim import LustreSimEnv
            env_cls = env_cls or LustreSimEnv

            if env_cls is LustreSimEnv:
                def base_factory(workload, seed):
                    return LustreSimEnv(workload, seed=seed, extended=extended)
            else:
                if extended:
                    raise ValueError(
                        "extended=True only applies to LustreSimEnv; "
                        f"{env_cls.__name__} defines its own space")

                def base_factory(workload, seed):
                    return env_cls(workload, seed=seed)

            if engine == "scan":
                def env_factory(workload, seed):
                    return base_factory(workload, seed).to_model_env(
                        device=device)
            else:
                env_factory = base_factory
        if devices is not None and engine == "scan" and len(devices) == 0:
            raise ValueError("devices must be non-empty")

        envs, scals, labels, cell_seeds = [], [], [], []
        cell = 0
        for workload in workloads:
            for weights in objectives:
                for seed in seeds:
                    env = env_factory(workload, seed + 1000 * cell)
                    envs.append(env)
                    scals.append(Scalarizer(weights=dict(weights),
                                            specs=env.metric_specs))
                    obj_name = "+".join(sorted(weights))
                    labels.append(f"{workload}|{obj_name}|seed{seed}")
                    cell_seeds.append(seed + 1000 * cell)
                    cell += 1
        if not envs:
            raise ValueError(
                "empty grid: need at least one workload, objective and seed")
        cfg = ddpg_config or DDPGConfig.for_env(envs[0])
        # seeds iterate innermost, so a workload x objective cell is
        # exactly len(seeds) consecutive sessions: the sharing cells
        cell_size = len(list(seeds))
        cell_modes = sharing is not None and sharing.cells
        replay_groups = None
        if sharing is not None and sharing.shared_replay:
            replay_groups = [i // cell_size for i in range(len(envs))]
        agent = FleetAgent(cfg, cell_seeds, buffer_capacity=buffer_capacity,
                           warmup_steps=warmup_steps,
                           store="host" if engine == "scan" else "device",
                           replay_dtype=replay_dtype, init_chunk=chunk,
                           replay_groups=replay_groups, device=device)
        return cls(envs, scals, agent, eval_runs=eval_runs, labels=labels,
                   engine=engine, devices=devices if engine == "scan" else None,
                   chunk=chunk if engine == "scan" else None, overlap=overlap,
                   policy=policy, sharing=sharing,
                   cell_size=cell_size if cell_modes else 1,
                   resilience=resilience, supervisor=supervisor, chaos=chaos,
                   device=device)

    # ------------------------------------------------------------------

    def memory_plan(self, steps: int = 30) -> dict:
        """Capacity accounting for this fleet (the module's
        ``memory_plan``), checked against the LIVE tensors: the predicted
        per-session learner and replay bytes against the sizes of
        ``agent.states`` and ``agent.buffer``, the live numbers reported
        beside them (``live`` / ``matches_live``)."""
        n = len(self.envs)
        env_state_bytes = 0
        if getattr(self.envs[0], "model", None) is not None:
            env_state_bytes = sum(x.numel() * x.element_size()
                                  for x in self.envs[0].model_state)
        model = getattr(self.envs[0], "model", None)
        shared_cell = (self.cell_size
                       if self.agent.buffer.groups is not None else 1)
        plan = memory_plan(
            self.agent.cfg, self.envs[0].param_space, sessions=n,
            steps=steps, chunk=self.chunk,
            capacity=self.agent.buffer.capacity,
            env_state_bytes_per_session=env_state_bytes,
            n_samples=getattr(model, "n_samples", 0), cell_size=shared_cell)
        live_learner = sum(x.numel() * x.element_size()
                           for x in self.agent.states) // n
        live_replay = self.agent.buffer.nbytes // n
        plan["live"] = {"learner_bytes_per_session": live_learner,
                        "replay_bytes_per_session": live_replay}
        plan["matches_live"] = (
            plan["per_session"]["learner_bytes"] == live_learner
            and plan["per_session"]["replay_bytes"] == live_replay)
        return plan

    def precompile(self, steps: int):
        """Build and load the episode kernel's library ahead of
        ``run(steps)`` without touching tuning state (scan engine only);
        ``core.episode.precompile_fleet_episode``."""
        if self.engine != "scan":
            raise ValueError("precompile() applies to the scan engine")
        from repro_torch.core.episode import precompile_fleet_episode
        return precompile_fleet_episode(
            self.envs[0], self.agent, steps, sessions=len(self.envs),
            chunk=self.chunk, devices=self.devices, policy=self.policy,
            stepwise=(self.resilience is not None or self.sharing is not None))

    # ------------------------------------------------------------------

    def _states(self) -> np.ndarray:
        return np.stack([
            normalize_state(m, e.metric_specs, e.state_metrics)
            for m, e in zip(self._cur_metrics, self.envs)])

    def _apply_all(self, configs: list) -> list:
        """Run every session's workload under its config for one fleet
        step."""
        if self.vectorized:
            from repro_torch.envs.lustre_sim import batch_mean_performance
            perfs = batch_mean_performance(self.envs, configs)
            return [e._run_with_perf(p, c)
                    for e, p, c in zip(self.envs, perfs, configs)]
        return [e.apply(c) for e, c in zip(self.envs, configs)]

    # ------------------------------------------------------------------

    def run(self, steps: int) -> FleetResult:
        """Run ``steps`` lockstep tuning iterations across the fleet.

        Callable repeatedly: agent, buffers and noise state persist across
        calls (progressive tuning, paper Fig. 7). Timing fields
        (``StepRecord.action_seconds``/``learn_seconds``,
        ``TuningResult.wall_seconds``) measure the FLEET's shared step, so
        they are identical across sessions; with ``engine="scan"`` per-step
        timings are the episode's average."""
        t_wall = time.perf_counter()
        if self.engine == "scan":
            self._run_scan(steps)
        else:
            self._run_host(steps)
        return self._finish(t_wall)

    def _run_scan(self, steps: int) -> None:
        """The streamed fleet episode (``core.episode.
        run_fleet_episode_scan``), histories rebuilt from its compact
        trace."""
        from repro_torch.core.episode import run_fleet_episode_scan
        start = len(self.histories[0])
        t0 = time.perf_counter()
        shared = dict(devices=self.devices, chunk=self.chunk,
                      overlap=self.overlap, supervisor=self.supervisor,
                      chaos=self.chaos)
        if self.policy is None:
            shared.update(sharing=self.sharing, cell_size=self.cell_size,
                          obs_mask=self._obs_mask)
        if self.resilience is not None:
            from repro_torch.core.resilience import empty_health_counters, \
                health_counters, init_fleet_health_state, \
                merge_health_counters
            if self._health is None:
                self._health = init_fleet_health_state(
                    self.agent.states, len(self.envs), self.resilience)
            trace, self._health = run_fleet_episode_scan(
                self.envs, self.agent, self.scalarizers, self._cur_metrics,
                steps, learn=True, resilience=self.resilience,
                health=self._health, **shared)
            self.health_events = np.concatenate(
                [self.health_events, trace.health_events], axis=1)
            self._health_counters = [
                merge_health_counters(c, health_counters(
                    trace.health_events[i]))
                for i, c in enumerate(self._health_counters
                                      or [empty_health_counters()
                                          for _ in self.envs])]
        elif self.policy is None:
            trace = run_fleet_episode_scan(
                self.envs, self.agent, self.scalarizers, self._cur_metrics,
                steps, learn=True, **shared)
        else:
            from repro_torch.core.guardrails import empty_counters, \
                guardrail_counters, init_fleet_guard_state, merge_counters
            if self._guard is None:
                self._guard = init_fleet_guard_state(
                    self.envs[0].param_space, self._cur_configs,
                    [sc.objective(m) for sc, m in
                     zip(self.scalarizers, self._cur_metrics)])
            trace, self._guard = run_fleet_episode_scan(
                self.envs, self.agent, self.scalarizers, self._cur_metrics,
                steps, learn=True, policy=self.policy, guard=self._guard,
                **shared)
            self.guard_events = np.concatenate(
                [self.guard_events, trace.guard_events], axis=1)
            self.shadow_objectives = np.concatenate(
                [self.shadow_objectives, trace.shadow_objectives], axis=1)
            self._guard_counters = [
                merge_counters(c, guardrail_counters(trace.guard_events[i],
                                                     trace.restarts[i]))
                for i, c in enumerate(self._guard_counters
                                      or [empty_counters()
                                          for _ in self.envs])]
        episode = time.perf_counter() - t0
        per_step = episode / max(1, steps)
        t0 = time.perf_counter()
        for i in range(len(self.envs)):
            rep = replay_compact_trace(
                self.envs[i], trace, i, start=start, per_step=per_step,
                prev_config=self._cur_configs[i],
                best_objective=self.best_objectives[i],
                restart_seconds=float(self.simulated_restart_seconds[i]),
                finite_baseline=self.resilience is not None)
            self.histories[i].extend(rep["records"])
            self.simulated_restart_seconds[i] = rep["restart_seconds"]
            if rep["best"] is not None:
                self.best_objectives[i] = rep["best"]["objective"]
                self.best_configs[i] = dict(rep["best"]["config"])
                self.best_metrics[i] = dict(rep["best"]["metrics"])
            self._cur_configs[i] = rep["cur_config"]
            if rep["cur_metrics"] is not None:
                self._cur_metrics[i] = rep["cur_metrics"]
        self.timings.update(episode=episode,
                            replay=time.perf_counter() - t0)

    def _run_host(self, steps: int) -> None:
        n_sessions = len(self.envs)
        start = len(self.histories[0])
        spent = {"act": 0.0, "env": 0.0, "learn": 0.0}
        for step_i in range(start, start + steps):
            states = self._states()

            t0 = time.perf_counter()
            actions = self.agent.act(states)
            t1 = time.perf_counter()
            configs = [e.param_space.to_config(a)
                       for e, a in zip(self.envs, actions)]
            metrics = self._apply_all(configs)
            action_seconds = time.perf_counter() - t0
            spent["act"] += t1 - t0
            spent["env"] += action_seconds - (t1 - t0)

            restarts = np.array([
                e.restart_cost(c, prev) for e, c, prev in
                zip(self.envs, configs, self._cur_configs)])
            self.simulated_restart_seconds += restarts

            next_states = np.stack([
                normalize_state(m, e.metric_specs, e.state_metrics)
                for m, e in zip(metrics, self.envs)])
            # python floats: StepRecord.reward must match Tuner's bitwise;
            # the replay buffer narrows to float32 on add, as the single
            # path does
            rewards = [sc.reward(prev, m) for sc, prev, m in
                       zip(self.scalarizers, self._cur_metrics, metrics)]
            objectives = [sc.objective(m)
                          for sc, m in zip(self.scalarizers, metrics)]

            t0 = time.perf_counter()
            self.agent.observe(states, actions, rewards, next_states)
            self.agent.learn()
            learn_seconds = time.perf_counter() - t0
            spent["learn"] += learn_seconds

            for i in range(n_sessions):
                if objectives[i] > self.best_objectives[i]:
                    self.best_objectives[i] = objectives[i]
                    self.best_configs[i] = dict(configs[i])
                    self.best_metrics[i] = dict(metrics[i])
                self.histories[i].append(StepRecord(
                    step=step_i, config=configs[i], metrics=metrics[i],
                    objective=objectives[i], reward=float(rewards[i]),
                    restart_seconds=float(restarts[i]),
                    action_seconds=action_seconds,
                    learn_seconds=learn_seconds,
                ))
            self._cur_configs = configs
            self._cur_metrics = metrics
        self.timings.update(spent)

    def guardrail_stats(self, i: int) -> Optional[dict]:
        """Session ``i``'s exported guardrail record (None when off)."""
        if self.policy is None:
            return None
        from repro_torch.core.guardrails import empty_counters, guard_row, \
            guardrail_stats
        guard_i = (guard_row(self._guard, i) if self._guard is not None
                   else None)
        counters = (self._guard_counters[i] if self._guard_counters
                    else empty_counters())
        return guardrail_stats(self.policy, guard_i, counters,
                               space=self.envs[i].param_space)

    def health_stats(self, i: int) -> Optional[dict]:
        """Session ``i``'s exported health record (None when off)."""
        if self.resilience is None:
            return None
        from repro_torch.core.resilience import empty_health_counters, \
            health_row, health_stats
        health_i = (health_row(self._health, i)
                    if self._health is not None else None)
        counters = (self._health_counters[i] if self._health_counters
                    else empty_health_counters())
        return health_stats(self.resilience, health_i, counters)

    def _finish(self, t_wall: float) -> FleetResult:
        """The final recommendation of every session, by the rule of
        ``core.tuner.recommend_final``: evaluate the best configuration
        seen, and where the policy's exploit-mode configuration differs,
        evaluate it too and keep it when its objective is higher
        (``recommend_final_fleet``)."""
        t0 = time.perf_counter()
        n = len(self.envs)
        policy_actions = self.agent.act(self._states(), explore=False)
        policy_configs = [self.envs[i].param_space.to_config(policy_actions[i])
                          for i in range(n)]
        finals = []
        for i, (config, metrics, replaced) in enumerate(
                recommend_final_fleet(self.envs, self.scalarizers,
                                      self.best_configs, policy_configs,
                                      self.eval_runs)):
            finals.append(metrics)
            if replaced:
                self.best_configs[i] = config
                self.best_metrics[i] = dict(metrics)
                self.best_objectives[i] = self.scalarizers[i].objective(
                    metrics)
        self.timings["final"] = time.perf_counter() - t0
        wall = time.perf_counter() - t_wall  # includes final evaluations,
        results = []                         # matching Tuner.run's clock
        for i in range(n):
            results.append(TuningResult(
                best_config=dict(self.best_configs[i]),
                best_objective=self.scalarizers[i].objective(finals[i]),
                best_metrics=finals[i],
                default_config=dict(self.default_configs[i]),
                default_metrics=dict(self.default_metrics[i]),
                history=list(self.histories[i]),
                simulated_restart_seconds=float(
                    self.simulated_restart_seconds[i]),
                wall_seconds=wall,
                guardrail_stats=self.guardrail_stats(i),
                health_stats=self.health_stats(i),
            ))
        return FleetResult(results=results, labels=list(self.labels),
                           wall_seconds=wall)


def memory_plan(cfg: DDPGConfig, space, *, sessions: int, steps: int,
                chunk: Optional[int] = None, capacity: int = 64,
                replay_dtype=torch.float32,
                env_state_bytes_per_session: int = 0,
                n_samples: int = 12, cell_size: int = 1) -> dict:
    """Bytes-per-session capacity accounting for the chunked fleet runtime,
    from the shapes the port allocates:

      * ``learner_bytes`` — one session's ``DDPGState``: the float32 flat
        vector (online + target actor and critic, both Adam moment sets)
        and the int32 Adam counts (2) and step;
      * ``replay_bytes`` — the float32 window, ``capacity x (2 k + m +
        1)`` floats; ``cell_size > 1`` models MERGED cell windows (shared
        replay): a cell of k sessions keeps one window, so the bytes per
        session divide by k (floor division, as the live accounting
        ``buffer.nbytes // sessions``);
      * ``staged_bytes`` — what else a session stages to the card per
        chunk: its env state, replay cursors (2 int32), learner key (2
        int64), state vector and objective, scalarization weights and
        metric bounds (3 k floats) and the model's 14 parameters;
      * per step: ``exploration_bytes_per_step`` (the warmup flag, warmup
        and noise rows), ``predraw_bytes_per_step`` (the pre-drawn env
        draws, ``3 + 11 n_samples`` floats, and the minibatch indices
        ``mb_idx``, ``updates_per_step x batch_size`` int32, of
        ``kernels/episode_learn.py::predraw``) and
        ``trace_bytes_per_step`` (the trace as the kernel writes it: int32
        knob indices, the float32 metrics, reward and objective, the int32
        fixed-point restart);
      * ``chunk_device_bytes`` — one chunk's resident device bytes, all of
        the above times the chunk: O(chunk x steps);
      * ``predraw_transient_bytes`` — the pre-draw's largest set of live
        temporaries beside them: its minibatch draw hashes ``[chunk, T, U,
        B]`` int64 words, up to 6 such tensors at once (the first hash's
        result kept, the second hash's two words and a round's three
        temporaries; 5.5 measured on the H100 at 1,024 sessions);
      * ``overlap_device_bytes`` — the overlapped schedule's bound: up to
        three chunks of device state at once (k computing, k+1 staged, k-1
        draining);
      * ``fleet_host_bytes`` — the whole fleet's host state and trace,
        O(sessions x steps).

    ``FleetTuner.memory_plan`` checks the learner and replay rows against
    the live tensors. Only float32 replay storage exists (ROADMAP A7b)."""
    from repro_torch.core.episode import resolve_chunk

    if not _is_float32(replay_dtype):
        raise NotImplementedError(
            f"replay storage in {replay_dtype} is ROADMAP item A7b")
    k, m = cfg.state_dim, cfg.action_dim
    u, b = cfg.updates_per_step, cfg.batch_size
    if cell_size > 1 and sessions % cell_size != 0:
        raise ValueError(
            f"merged cell buffers need whole cells: {sessions} sessions is "
            f"not a multiple of cell_size={cell_size}")
    learner_bytes = 4 * state_layout(cfg).floats + 4 * 2 + 4
    replay_bytes = 4 * capacity * (2 * k + m + 1) // cell_size
    staged_bytes = (env_state_bytes_per_session + 4 * 2 + 8 * 2 + 4 * k + 4
                    + 4 * 3 * k + 4 * 14)
    exploration_bytes_per_step = 1 + 2 * 4 * m
    predraw_bytes_per_step = 4 * (3 + 11 * n_samples) + 4 * u * b
    trace_bytes_per_step = 4 * m + 4 * k + 4 + 4 + 4
    space.index_dtype()  # a quantized space: the trace is knob indices
    c = resolve_chunk(sessions, chunk)
    per_session = learner_bytes + replay_bytes + staged_bytes + steps * (
        exploration_bytes_per_step + predraw_bytes_per_step
        + trace_bytes_per_step)
    chunk_device_bytes = c * per_session
    return {
        "sessions": sessions,
        "chunk": c,
        "steps": steps,
        "capacity": capacity,
        "cell_size": cell_size,
        "replay_dtype": "float32",
        "per_session": {
            "learner_bytes": learner_bytes,
            "replay_bytes": replay_bytes,
            "env_state_bytes": env_state_bytes_per_session,
            "staged_bytes": staged_bytes,
            "exploration_bytes_per_step": exploration_bytes_per_step,
            "predraw_bytes_per_step": predraw_bytes_per_step,
            "trace_bytes_per_step": trace_bytes_per_step,
        },
        "chunk_device_bytes": chunk_device_bytes,
        "predraw_transient_bytes": 6 * 8 * c * steps * u * b,
        "overlap_device_bytes": 3 * chunk_device_bytes,
        "fleet_host_bytes": sessions * per_session,
    }
