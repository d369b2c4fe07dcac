"""Multi-objective scalarization + reward (paper §II-A, §II-B-5).

State: each metric is min-max normalized to [0,1] with bounds from the metric specs
(domain knowledge) or inferred from data. Objective: weighted sum of normalized
performance indicators. Reward: proportional change of the weighted sum:

    r_t = (sum_i w_i s_{t+1}(i) - sum_i w_i s_t(i)) / sum_i w_i s_t(i)

All arithmetic here is float32 with a fixed accumulation order (the order the
metric names appear in ``specs``). That is deliberate: the JAX package's fused
episode engine computes the identical normalization/objective/reward inside
one XLA program, and a host-loop tuning path must produce bit-identical
states and rewards so the engines can be proven equal. float32 is also what
the replay buffer stores, so no precision reaches the learner either way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Normalization bounds for one metric (paper Table I rows + objectives)."""

    name: str
    minimum: float
    maximum: float
    scope: str = ""  # e.g. "OSC", "MDS", informational
    description: str = ""

    def norm(self, value: float) -> float:
        """Min-max normalization in float32 (bit-aligned with the fused engine)."""
        lo, hi = _F32(self.minimum), _F32(self.maximum)
        span = hi - lo
        if span <= 0:
            return 0.0
        return float(np.clip((_F32(value) - lo) / span, _F32(0.0), _F32(1.0)))


def normalize_state(metrics: Mapping[str, float], specs: Mapping[str, MetricSpec], order: list) -> np.ndarray:
    """s_t = [norm(P_1), ..., norm(P_k)] in a fixed metric order."""
    return np.array([specs[name].norm(metrics[name]) for name in order], np.float32)


def metric_bounds(specs: Mapping[str, MetricSpec], order: list) -> tuple:
    """(lo, span) float32 arrays in state order: the episode engine's view
    of the normalization bounds. ``span`` is 0 for degenerate specs (norm ->
    0)."""
    lo = np.array([specs[name].minimum for name in order], np.float32)
    hi = np.array([specs[name].maximum for name in order], np.float32)
    return lo, hi - lo


@dataclasses.dataclass(frozen=True)
class Scalarizer:
    """Linear scalarization of the optimization objectives.

    ``weights`` maps objective metric name -> w_i. Objectives are a subset of the
    state metrics (throughput, IOPS, ...).
    """

    weights: Mapping[str, float]
    specs: Mapping[str, MetricSpec]

    def __post_init__(self):
        missing = set(self.weights) - set(self.specs)
        if missing:
            raise KeyError(f"objective weights without metric specs: {missing}")

    def weight_vector(self, order: list) -> np.ndarray:
        """Weights as a float32 vector over the state order (zeros
        elsewhere): what the episode engine folds against the normalized
        state. Raises if a weighted metric is not part of the state order."""
        outside = set(self.weights) - set(order)
        if outside:
            raise KeyError(
                f"objective metrics {outside} are not state metrics; the "
                f"episode engine reads objectives off the state vector")
        return np.array([_F32(self.weights.get(name, 0.0)) for name in order],
                        np.float32)

    def objective(self, metrics: Mapping[str, float]) -> float:
        """G(P) = sum_i w_i * norm(P_i), accumulated in float32 in specs order.

        Terms fold in the order the metric names appear in ``specs`` (the state
        order for every environment in this repo) so the host loop and the
        fused engine — which folds w·s serially over the state vector, where
        zero-weight terms are exact no-ops — agree bitwise.
        """
        acc = _F32(0.0)
        for name in self.specs:
            if name in self.weights:
                acc = acc + _F32(self.weights[name]) * _F32(self.specs[name].norm(metrics[name]))
        return float(acc)

    def reward(self, prev_metrics: Mapping[str, float], new_metrics: Mapping[str, float]) -> float:
        """Proportional performance change (paper's r_t), in float32."""
        prev = _F32(self.objective(prev_metrics))
        new = _F32(self.objective(new_metrics))
        return float((new - prev) / np.maximum(prev, _F32(1e-6)))
