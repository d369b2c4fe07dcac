"""Tuning-environment protocol (the paper's 'Environment': DFS + workloads).

``TuningEnvironment`` is the host-side dict protocol the Fig. 1 loop
consumes. An environment owns the static-parameter space and produces a
metric dict per evaluation. ``apply`` runs (or simulates) the workload under
a configuration and returns raw metric values; ``restart_cost`` accounts the
restart downtime the paper highlights as the distinguishing cost of *static*
parameters.

The reference's pure-model protocol (``EnvModel``/``ModelEnv``), which the
whole-episode engine scans over, is not part of this package yet (ROADMAP
A5).
"""

from __future__ import annotations

import abc
from typing import Mapping

from repro_torch.core.action_mapping import ParamSpace
from repro_torch.core.scalarization import MetricSpec


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

