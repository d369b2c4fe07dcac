"""Tuning-environment protocol (the paper's 'Environment': DFS + workloads).

Two layers live here:

``TuningEnvironment`` is the host-side dict protocol the Fig. 1 loop
consumes. An environment owns the static-parameter space and produces a
metric dict per evaluation. ``apply`` runs (or simulates) the workload under
a configuration and returns raw metric values; ``restart_cost`` accounts the
restart downtime the paper highlights as the distinguishing cost of *static*
parameters.

``EnvModel`` is the pure-function twin: ``init_state(key)`` and ``step(state,
unit_action)`` over torch tensors, with all randomness drawn from the
threefry key the state carries (``step_draws``). The episode engine
(``core.episode``) runs whole tuning episodes over such a model, on the card
inside one kernel launch. ``ModelEnv`` adapts a model back to the dict
protocol (one step per ``apply``, on its device), so the host-loop tuner and
the episode engine drive the same model.

The reference's ``fusion_barrier`` and ``barriered_step`` pin XLA fusion
boundaries so that its engines compile alike; eager torch has no fusion to
pin, so they have no counterpart here.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.action_mapping import ParamSpace
from repro_torch.core.scalarization import MetricSpec
from repro_torch.device import resolve_device


class TuningEnvironment(abc.ABC):
    param_space: ParamSpace
    metric_specs: Mapping[str, MetricSpec]
    state_metrics: list  # ordered metric names forming the RL state vector

    @abc.abstractmethod
    def apply(self, config: dict, eval_run: bool = False) -> dict:
        """Apply a configuration, run the workload, return raw metrics.

        ``eval_run=True`` marks a long final-evaluation run (lower variance);
        environments without that notion may ignore it."""

    @abc.abstractmethod
    def restart_cost(self, config: dict, prev_config: dict) -> float:
        """Seconds of downtime incurred by switching prev_config -> config."""

    @property
    def state_dim(self) -> int:
        return len(self.state_metrics)

    @property
    def action_dim(self) -> int:
        return self.param_space.dim



class EnvModel(abc.ABC):
    """A tuning environment as pure torch functions.

    Contract:
      * ``params`` is a tuple of tensors (per-instance constants such as the
        workload's shape parameters). Everything structural (the parameter
        space, metric order, sample count) is baked into the functions.
      * ``init_fn(params, key) -> state``; ``step_draws(key) -> (key,
        draws)`` walks the key chain one step, whatever the action;
        ``step_fn(params, state, unit_action, draws, eval_run) -> (state,
        metrics_vec, restart_cost)`` is the step's math over those draws.
        ``metrics_vec`` is the raw metric vector in ``state_metrics`` order;
        ``restart_cost`` the downtime in seconds (0 when the decoded
        configuration did not change).
      * the space is quantized (``ParamSpace.is_quantized``) and dynamics
        depend on the action only through its decoded values
        (``core.action_mapping.coord_maps``).
    """

    param_space: ParamSpace
    metric_specs: Mapping[str, MetricSpec]
    state_metrics: list
    params: Any
    #: parameter names whose change needs a full-DFS restart
    dfs_scope: tuple = ()

    @property
    @abc.abstractmethod
    def init_fn(self) -> Callable:
        """Pure ``(params, key) -> state``."""

    @property
    @abc.abstractmethod
    def step_fn(self) -> Callable:
        """Pure ``(params, state, unit_action, draws, eval_run) -> (state,
        metrics_vec, restart_cost)``."""

    @abc.abstractmethod
    def step_draws(self, key: torch.Tensor) -> tuple:
        """``(next key, this step's draws)``."""

    def init_state(self, key: torch.Tensor) -> Any:
        return self.init_fn(self.params, key)

    def key_of(self, state) -> torch.Tensor:
        """The threefry key the state carries (``step_draws`` walks it)."""
        return state.key

    def with_key(self, state, key: torch.Tensor):
        """``state`` carrying ``key`` in place of its own."""
        return state._replace(key=key)

    def step(self, state, unit_action: torch.Tensor, eval_run: bool = False,
             params=None) -> tuple:
        """One transition: advance the key chain, then the step's math.
        ``params`` defaults to ``self.params`` (pass a copy on another
        device to step there)."""
        key, draws = self.step_draws(self.key_of(state))
        return self.step_fn(self.params if params is None else params,
                            self.with_key(state, key), unit_action, draws,
                            eval_run)

    @property
    def state_dim(self) -> int:
        return len(self.state_metrics)

    @property
    def action_dim(self) -> int:
        return self.param_space.dim


class ModelEnv(TuningEnvironment):
    """Thin host adapter: dict-based ``apply`` over a pure ``EnvModel``.

    ``apply`` encodes the config to a unit action, runs one model step on
    ``device`` (``cuda`` unless given, like the port's other entry points)
    and names the resulting metric vector. Restart costs are drawn inside
    the step and surfaced through ``restart_cost`` to keep the Fig. 1 loop's
    call order.
    """

    def __init__(self, model: EnvModel, seed: int = 0, device=None):
        if not model.param_space.is_quantized:
            raise ValueError(
                "ModelEnv needs a quantized ParamSpace (continuous kinds do "
                "not survive the dict round trip bit-exactly)")
        from repro_torch import random as jrandom

        self.model = model
        self.device = resolve_device(device)
        self.params = type(model.params)(
            *(x.to(self.device) for x in model.params))
        self.param_space = model.param_space
        self.metric_specs = model.metric_specs
        self.state_metrics = list(model.state_metrics)
        self.seed = seed
        self.model_state = model.init_state(
            jrandom.PRNGKey(seed).to(self.device))
        self.restart_events: list = []  # (scope, seconds) per config change
        #: downtime accrued by tuning applies since the last restart_cost()
        #: read; None = no tuning apply happened (eval-only protocols fall
        #: back to the diff-based host draw below)
        self._pending_restart = None
        self._fallback_rng = np.random.default_rng(seed + 17)
        self._last_scope = "workload"
        self._last_config: dict = {}

    def _scope(self, config: dict, prev: dict) -> str:
        changed = [k for k in config if config[k] != prev.get(k)]
        return "dfs" if any(k in self.model.dfs_scope for k in changed) else \
            "workload"

    def apply(self, config: dict, eval_run: bool = False) -> dict:
        if not self.param_space.validate(config):
            raise ValueError(f"invalid config {config}")
        action = torch.as_tensor(self.param_space.to_action(config),
                                 device=self.device)
        with torch.no_grad():
            self.model_state, vec, cost = self.model.step(
                self.model_state, action, eval_run=eval_run,
                params=self.params)
        if not eval_run:
            # tuning applies accrue downtime until the loop reads it via
            # restart_cost(); evaluation runs are re-measurements and are
            # never charged
            self._pending_restart = (self._pending_restart or 0.0) + \
                float(cost)
        self._last_scope = self._scope(config, self._last_config)
        self._last_config = dict(config)
        vec = vec.cpu().numpy()
        return {name: float(v) for name, v in zip(self.state_metrics, vec)}

    def restart_cost(self, config: dict, prev_config: dict) -> float:
        """Seconds of downtime for switching prev_config -> config: the
        cost the last tuning apply drew inside the step, or, after
        evaluation applies only, a host-side draw from the config diff
        (same ranges, separate stream)."""
        cost, self._pending_restart = self._pending_restart, None
        if cost is None:
            changed = [k for k in config or {}
                       if config[k] != (prev_config or {}).get(k)]
            if not changed:
                return 0.0
            cost = float(self._fallback_rng.uniform(12.0, 20.0))
            if any(k in self.model.dfs_scope for k in changed):
                cost += 30.0
            self._last_scope = self._scope(config, prev_config or {})
        if cost > 0:
            self.restart_events.append((self._last_scope, cost))
        return cost

    def restart_summary(self) -> dict:
        """{scope: {count, seconds}} over the adapter's lifetime."""
        out = {"workload": {"count": 0, "seconds": 0.0},
               "dfs": {"count": 0, "seconds": 0.0}}
        for scope, seconds in self.restart_events:
            out[scope]["count"] += 1
            out[scope]["seconds"] += seconds
        return out
