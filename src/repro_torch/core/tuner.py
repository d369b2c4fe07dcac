"""The Magpie tuning loop (paper Fig. 1): the host engine and the scan
(whole-episode) engine.

Components map onto the paper's architecture:
  Metrics Collector  -> env.apply(config) returning the Table-I metric dict
  Memory Pool        -> agent.buffer (FIFO replay, §II-D)
  RL Model           -> agent (DDPG, §II-C; its 96-update learner is the
                        CUDA kernel ``kernels/csrc/ddpg_learn.cu`` on the card)
  Controller         -> ParamSpace.to_config + env.apply (restart accounting)

Each tuning step: read state -> policy recommends a full configuration (all m
parameters at once, §II-B-4) -> apply (restarting workload/DFS, cost tracked) ->
reward = proportional scalarized performance change -> store -> learn.

``engine="host"`` runs one ``env.apply`` per step, for any
``TuningEnvironment``. ``engine="scan"`` needs a ``ModelEnv`` and runs each
``run()`` call as one episode (``core.episode.run_episode_scan``): on the
card ONE launch of the CUDA kernel ``kernels/csrc/episode_learn.cu``, on
the CPU its plain PyTorch version. ``policy`` (a
``core.guardrails.DeploymentPolicy``) turns on the deployment guardrails:
each ``run()`` then runs the guarded per-step body
(``core.episode.stepwise_episode``), one launch of the CUDA learner
``kernels/csrc/ddpg_learn.cu`` a step. So do the other layers the
reference runs inside the episode: ``resilience`` (a
``core.resilience.ResiliencePolicy``: snapshot, reset and degrade) and
``observation_scopes`` (the learner sees only the metrics of those
scopes).

The final recommendation is the best configuration *seen* during tuning
(§III-E: 'it recommends the best it has seen so far'), evaluated with
``eval_runs`` repetitions (§III-B: 'evaluated ... with three runs').
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.agent import MagpieAgent
from repro_torch.core.ddpg import DDPGConfig
from repro_torch.core.scalarization import Scalarizer, normalize_state


@dataclasses.dataclass
class StepRecord:
    step: int
    config: dict
    metrics: dict
    objective: float
    reward: float
    restart_seconds: float
    action_seconds: float
    learn_seconds: float


def evaluate_config(env, config: dict, runs: int) -> dict:
    """Average metrics over ``runs`` long evaluation runs (paper: 30 min x3).

    Shared by ``Tuner`` and ``FleetTuner`` so the evaluation protocol has one
    source of truth (fleet-of-one parity depends on it). Sums first and
    divides once — per-run ``v / runs`` accumulation drifts in float and made
    the mean order-dependent."""
    acc: dict = {}
    for _ in range(runs):
        m = env.apply(config, eval_run=True)
        for k, v in m.items():
            acc[k] = acc.get(k, 0.0) + v
    return {k: v / runs for k, v in acc.items()}


def recommend_final(scalarizer: Scalarizer, best_config: dict,
                    policy_config: dict, evaluate) -> tuple:
    """§III-E final recommendation, shared by ``Tuner`` and ``FleetTuner``.

    Re-evaluates the best-seen configuration and — since the policy has been
    fitted to *denoise* observations via the metric state — the policy's own
    exploit-mode candidate, keeping the better. The paper's plateau behaviour
    ('recommends the best it has seen so far') is preserved because the policy
    candidate only replaces best-seen when it truly wins. Returns
    ``(config, evaluated_metrics, replaced)``.
    """
    best_metrics = evaluate(best_config)
    if policy_config != best_config:
        policy_metrics = evaluate(policy_config)
        if (scalarizer.objective(policy_metrics)
                > scalarizer.objective(best_metrics)):
            return dict(policy_config), policy_metrics, True
    return dict(best_config), best_metrics, False


@dataclasses.dataclass
class TuningResult:
    best_config: dict
    best_objective: float
    best_metrics: dict
    default_config: dict
    default_metrics: dict
    history: list
    simulated_restart_seconds: float
    wall_seconds: float
    #: guarded sessions only (core.guardrails): the policy, per-session
    #: promotion/rollback counters and restart-budget accounting; None when
    #: guardrails are off
    guardrail_stats: Optional[dict] = None
    #: resilient sessions only (core.resilience): the policy, cumulative
    #: non-finite/reset counters and the degraded flag; None when off
    health_stats: Optional[dict] = None

    def gain(self, metric: str) -> float:
        """Proportional raw-metric gain of best vs default (paper's reported %)."""
        base = self.default_metrics[metric]
        return (self.best_metrics[metric] - base) / max(base, 1e-9)


class Tuner:
    def __init__(self, env, scalarizer: Scalarizer,
                 agent: Optional[MagpieAgent] = None,
                 eval_runs: int = 3, seed: int = 0, engine: str = "host",
                 policy=None, observation_scopes=None, resilience=None,
                 device=None):
        """``agent=None`` sizes a default DDPG agent from the environment's
        ``ParamSpace`` (``DDPGConfig.for_env``) on ``device`` (``cuda``
        unless given; without a card the caller must pass ``"cpu"``).

        ``engine``: "host" (dict loop, any environment) or "scan" (one
        episode call per ``run()``; needs a ``ModelEnv`` on the agent's
        device).

        ``policy`` (``core.guardrails.DeploymentPolicy``) turns on the
        shadow/canary deployment guardrails: proposals are scored in shadow
        inside the episode, promoted only past the min-gain/restart-budget
        gate and rolled back on regression. Scan engine only; the guard
        persists across progressive ``run()`` calls. ``policy=None`` runs
        the episode kernel, bitwise the unguarded tuner.

        ``resilience`` (``core.resilience.ResiliencePolicy``) turns on the
        self-healing body: a non-finite reading, learner or loss resets the
        session to its last-good snapshot, and past ``max_resets`` it
        degrades to a frozen incumbent; ``health_events`` and
        ``TuningResult.health_stats`` report it, and the health state
        persists across ``run()`` calls. ``observation_scopes`` (a tuple of
        metric scopes, e.g. ``("OSC",)``) masks the learner's view to the
        metrics of those scopes (``envs.metrics.scope_mask``); the reward
        and objective still read the whole state. Both run the per-step
        body, scan engine only, and neither composes with ``policy``
        (the reference's ``ValueError``s)."""
        if engine not in ("host", "scan"):
            raise ValueError(f"unknown engine {engine!r}; use 'host' or 'scan'")
        if engine == "scan" and getattr(env, "model", None) is None:
            raise ValueError(
                "engine='scan' needs a pure-model environment (ModelEnv); "
                "real-DFS/external environments must use engine='host'")
        if policy is not None and engine != "scan":
            raise ValueError(
                "DeploymentPolicy guardrails run inside the episode; use "
                "engine='scan' (the host loop has no shadow/canary body)")
        if observation_scopes is not None and engine != "scan":
            raise ValueError(
                "observation_scopes masks the actor input inside the episode "
                "scan; use engine='scan'")
        if observation_scopes is not None and policy is not None:
            raise ValueError(
                "observation_scopes does not compose with DeploymentPolicy "
                "guardrails; run guarded tuners with full-state observation")
        if resilience is not None:
            from repro_torch.core.resilience import normalize_resilience
            resilience = normalize_resilience(resilience)
        if resilience is not None and engine != "scan":
            raise ValueError(
                "ResiliencePolicy runs inside the episode scan; use "
                "engine='scan' (the host loop has no snapshot/reset body)")
        if resilience is not None and policy is not None:
            raise ValueError(
                "resilience does not compose with DeploymentPolicy "
                "guardrails; run guarded tuners without a ResiliencePolicy")
        self.env = env
        self.engine = engine
        self.policy = policy
        self.resilience = resilience
        self._health = None  # HealthState, persists across progressive runs
        self.health_events = np.zeros((0,), np.uint8)
        self._health_counters: Optional[dict] = None
        if observation_scopes is None:
            self._obs_mask = None
        else:
            from repro_torch.core.sharing import SharingConfig, \
                resolve_obs_mask
            self._obs_mask = resolve_obs_mask(
                SharingConfig(observation_scopes=tuple(observation_scopes)),
                env.metric_specs, env.state_metrics)
        self._guard = None  # GuardState, persists across progressive runs
        self.guard_events = np.zeros((0,), np.uint8)
        self.shadow_objectives = np.zeros((0,), np.float32)
        self._guard_counters: Optional[dict] = None
        self.scalarizer = scalarizer
        self.agent = agent or MagpieAgent(DDPGConfig.for_env(env), seed=seed,
                                          device=device)
        self.eval_runs = eval_runs
        self.history: list = []
        self.simulated_restart_seconds = 0.0
        # Baseline: metrics under the default configuration.
        self.default_config = env.param_space.default_config()
        self.default_metrics = self._evaluate(self.default_config, runs=eval_runs)
        self._cur_config = dict(self.default_config)
        self._cur_metrics = dict(self.default_metrics)
        self.best_config = dict(self.default_config)
        self.best_metrics = dict(self.default_metrics)
        self.best_objective = scalarizer.objective(self.default_metrics)

    # ------------------------------------------------------------------

    def _evaluate(self, config: dict, runs: int) -> dict:
        return evaluate_config(self.env, config, runs)

    def _state(self, metrics: dict) -> np.ndarray:
        return normalize_state(metrics, self.env.metric_specs, self.env.state_metrics)

    def _track_best(self, objective: float, config: dict, metrics: dict) -> None:
        if objective > self.best_objective:
            self.best_objective = objective
            self.best_config = dict(config)
            self.best_metrics = dict(metrics)

    # ------------------------------------------------------------------

    def run(self, steps: int, learn: bool = True) -> TuningResult:
        """Run ``steps`` tuning iterations; callable repeatedly (progressive tuning,
        paper Fig. 7 — the agent, buffer and noise state persist across calls)."""
        t_wall = time.perf_counter()
        if self.engine == "scan":
            self._run_scan(steps, learn)
        else:
            self._run_host(steps, learn)
        return self._finish(t_wall)

    def _run_host(self, steps: int, learn: bool) -> None:
        """The dict-based Fig. 1 loop — one host round trip per step."""
        start = len(self.history)
        for i in range(start, start + steps):
            state = self._state(self._cur_metrics)

            t0 = time.perf_counter()
            action = self.agent.act(state)
            config = self.env.param_space.to_config(action)
            metrics = self.env.apply(config)
            action_seconds = time.perf_counter() - t0

            restart = self.env.restart_cost(config, self._cur_config)
            self.simulated_restart_seconds += restart

            next_state = self._state(metrics)
            reward = self.scalarizer.reward(self._cur_metrics, metrics)
            objective = self.scalarizer.objective(metrics)

            t0 = time.perf_counter()
            if learn:
                self.agent.observe(state, action, reward, next_state)
                self.agent.learn()
            learn_seconds = time.perf_counter() - t0

            self._track_best(objective, config, metrics)
            self.history.append(StepRecord(
                step=i, config=config, metrics=metrics, objective=objective,
                reward=reward, restart_seconds=restart,
                action_seconds=action_seconds, learn_seconds=learn_seconds,
            ))
            self._cur_config = config
            self._cur_metrics = metrics

    def _run_scan(self, steps: int, learn: bool) -> None:
        """The episode engine: one episode call for all ``steps``, then the
        ``StepRecord`` history reconstructed from its trace."""
        from repro_torch.core.episode import run_episode_scan
        start = len(self.history)
        t0 = time.perf_counter()
        if self.policy is not None:
            from repro_torch.core.guardrails import empty_counters, \
                guardrail_counters, init_guard_state, merge_counters
            if self._guard is None:
                self._guard = init_guard_state(
                    self.env.param_space, self._cur_config,
                    self.scalarizer.objective(self._cur_metrics))
            trace, self._guard = run_episode_scan(
                self.env, self.agent, self.scalarizer, self._cur_metrics,
                steps, learn=learn, policy=self.policy, guard=self._guard)
            self.guard_events = np.concatenate(
                [self.guard_events, trace.guard_events])
            self.shadow_objectives = np.concatenate(
                [self.shadow_objectives, trace.shadow_objectives])
            self._guard_counters = merge_counters(
                self._guard_counters or empty_counters(),
                guardrail_counters(trace.guard_events, trace.restarts))
        elif self.resilience is not None:
            from repro_torch.core.resilience import empty_health_counters, \
                health_counters, init_health_state, merge_health_counters
            if self._health is None:
                self._health = init_health_state(self.agent.state,
                                                 self.resilience)
            trace, self._health = run_episode_scan(
                self.env, self.agent, self.scalarizer, self._cur_metrics,
                steps, learn=learn, obs_mask=self._obs_mask,
                resilience=self.resilience, health=self._health)
            self.health_events = np.concatenate(
                [self.health_events, trace.health_events])
            self._health_counters = merge_health_counters(
                self._health_counters or empty_health_counters(),
                health_counters(trace.health_events))
        else:
            trace = run_episode_scan(self.env, self.agent, self.scalarizer,
                                     self._cur_metrics, steps, learn=learn,
                                     obs_mask=self._obs_mask)
        per_step = (time.perf_counter() - t0) / max(1, steps)

        configs = self.env.param_space.configs_from_indices(trace.action_idx)
        names = self.env.state_metrics
        prev_config = self._cur_config
        for t in range(steps):
            metrics = {n: float(v) for n, v in zip(names, trace.metrics[t])}
            objective = float(trace.objectives[t])
            restart = float(trace.restarts[t])
            self.simulated_restart_seconds += restart
            if restart > 0:  # adapter-side restart log (scope bookkeeping)
                self.env.restart_events.append(
                    (self.env._scope(configs[t], prev_config), restart))
            self._track_best(objective, configs[t], metrics)
            self.history.append(StepRecord(
                step=start + t, config=configs[t], metrics=metrics,
                objective=objective, reward=float(trace.rewards[t]),
                restart_seconds=restart, action_seconds=per_step,
                learn_seconds=0.0,
            ))
            prev_config = configs[t]
            self._cur_config = configs[t]
            if (self.resilience is None
                    or bool(np.isfinite(trace.metrics[t]).all())):
                # as the resilient carry: a corrupted reading is recorded
                # raw in the history but never becomes the next observation
                # (nor the final recommendation's actor input)
                self._cur_metrics = metrics
        self.env._last_config = dict(self._cur_config)

    def guardrail_stats(self) -> Optional[dict]:
        """Exported guardrail record (None when guardrails are off): the
        policy, cumulative promotion/rollback/rejection counters, restart
        budget spent/remaining and the current live config."""
        if self.policy is None:
            return None
        from repro_torch.core.guardrails import empty_counters, \
            guardrail_stats
        return guardrail_stats(self.policy, self._guard,
                               self._guard_counters or empty_counters(),
                               space=self.env.param_space)

    def health_stats(self) -> Optional[dict]:
        """Exported health record (None when resilience is off): the
        policy, the cumulative non-finite and reset counters, the degraded
        flag and the carried totals."""
        if self.resilience is None:
            return None
        from repro_torch.core.resilience import empty_health_counters, \
            health_stats
        return health_stats(self.resilience, self._health,
                            self._health_counters or empty_health_counters())

    def _finish(self, t_wall: float) -> TuningResult:
        """§III-E final recommendation + result assembly (shared by engines)."""
        policy_action = self.agent.act(self._state(self._cur_metrics), explore=False)
        policy_config = self.env.param_space.to_config(policy_action)
        config, best_metrics, replaced = recommend_final(
            self.scalarizer, self.best_config, policy_config,
            lambda c: self._evaluate(c, runs=self.eval_runs))
        if replaced:
            self.best_config = config
            self.best_metrics = dict(best_metrics)
            self.best_objective = self.scalarizer.objective(best_metrics)
        return TuningResult(
            best_config=dict(self.best_config),
            best_objective=self.scalarizer.objective(best_metrics),
            best_metrics=best_metrics,
            default_config=dict(self.default_config),
            default_metrics=dict(self.default_metrics),
            history=list(self.history),
            simulated_restart_seconds=self.simulated_restart_seconds,
            wall_seconds=time.perf_counter() - t_wall,
            guardrail_stats=self.guardrail_stats(),
            health_stats=self.health_stats(),
        )
