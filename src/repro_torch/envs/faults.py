"""Deterministic fault injection for guardrail testing.

``FaultInjectedModel`` wraps any pure ``EnvModel`` and corrupts named
metrics over a step-indexed schedule (a throughput collapse at step k, an
iowait spike, a metric dropout) without touching the wrapped dynamics,
restart accounting or key chain. The wrapper is itself an ``EnvModel``
whose functions take leading batch axes, so faulted environments ride the
guarded episode body and the chunked fleet runtime unchanged:
``tests/test_torch_guardrails.py`` injects a degradation mid-episode and
pins that the ``DeploymentPolicy`` rolls the live config back within its
window.

Schedule semantics: the fault clock counts TUNING transitions only
(``eval_run=True`` probes, shadow scoring and ``evaluate_config``, read the
current clock but never advance it), so "collapse at step k" means the
k-th committed tuning step however many shadow probes ran. A fault row is
active for ``start <= t < start + duration``; shadow and live steps within
one guarded step see the SAME clock, so a shadow probe scores a proposal
under the fault regime the live system would run it in.

The key chain lives in the wrapped model's state: ``key_of`` and
``with_key`` reach through ``FaultyEnvState.base``, so the wrapped model's
draws are those it makes unwrapped.

``ChaosConfig`` plans faults across both failure domains: a NaN poison
of one metric inside the episode (``fault_specs()``, for
``FaultInjectedModel``) and, on the host, transient staging failures and
stalls of chosen chunks (``host()``, a ``HostChaos`` for the supervised
chunk stream of ``core.resilience.ChunkSupervisor``).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.envs.base import EnvModel

FAULT_MODES = ("scale", "dropout", "nan")


class FaultSpec(NamedTuple):
    """One step-indexed metric corruption.

    ``metric``    name from the wrapped model's ``state_metrics``.
    ``start``     first tuning step (0-based) the fault is active.
    ``duration``  number of tuning steps the fault stays active.
    ``mode``      "scale" multiplies the metric by ``scale``; "dropout"
                  zeroes it (a collector blackout); "nan" replaces it with
                  NaN (a poisoned sample).
    ``scale``     multiplier for mode="scale" (ignored otherwise).
    """

    metric: str
    start: int
    duration: int
    mode: str = "scale"
    scale: float = 0.2


class FaultyEnvState(NamedTuple):
    base: object   # the wrapped model's state
    step: object   # int32 tuning-step clock (eval probes do not advance it)


@functools.lru_cache(maxsize=None)
def _build_fault_fns(base_init, base_step, rows: tuple):
    """(init_fn, step_fn), cached on (wrapped fns, schedule): every session
    of a fleet sharing one schedule shares ONE step_fn identity, which is
    what ``check_fleet_envs`` asks of a fleet."""

    def init_fn(params, key):
        return FaultyEnvState(base=base_init(params, key),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=key.device))

    def step_fn(params, state, unit_action, draws, eval_run):
        base, vec, cost = base_step(params, state.base, unit_action, draws,
                                    eval_run)
        t = state.step
        for mi, start, duration, mode, scale in rows:
            active = (t >= start) & (t < start + duration)
            v = vec[..., mi]
            if mode == "dropout":
                faulted = torch.zeros_like(v)
            elif mode == "nan":
                faulted = torch.full_like(v, float("nan"))
            else:
                faulted = v * scale
            vec = vec.clone()
            vec[..., mi] = torch.where(active, faulted, v)
        # eval_run is a static bool: probes replay the same clock
        step = t if eval_run else t + 1
        return FaultyEnvState(base=base, step=step), vec, cost

    return init_fn, step_fn


class FaultInjectedModel(EnvModel):
    """An ``EnvModel`` whose observed metrics follow a fault schedule.

    Delegates space, specs, params, restart scope and draws to the wrapped
    model; only the emitted metric vector is corrupted while a fault row is
    active. Determinism is the wrapped model's: same key, same schedule,
    same trajectory."""

    def __init__(self, base: EnvModel, faults: Sequence[FaultSpec]):
        names = list(base.state_metrics)
        rows = []
        for f in faults:
            if f.metric not in names:
                raise ValueError(
                    f"unknown metric {f.metric!r}; the wrapped model "
                    f"exposes {names}")
            if f.mode not in FAULT_MODES:
                raise ValueError(
                    f"unknown fault mode {f.mode!r}; use one of "
                    f"{FAULT_MODES}")
            if f.start < 0 or f.duration <= 0:
                raise ValueError(
                    f"fault needs start >= 0 and duration > 0, got {f}")
            # a float32 scale: the product is the reference's f32 multiply
            rows.append((names.index(f.metric), int(f.start),
                         int(f.duration), f.mode,
                         float(np.float32(f.scale))))
        self.base = base
        self.faults = tuple(faults)
        self.param_space = base.param_space
        self.metric_specs = base.metric_specs
        self.state_metrics = names
        self.params = base.params
        self.dfs_scope = base.dfs_scope
        self._init_fn, self._step_fn = _build_fault_fns(
            base.init_fn, base.step_fn, tuple(rows))

    @property
    def init_fn(self):
        return self._init_fn

    @property
    def step_fn(self):
        return self._step_fn

    def step_draws(self, key: torch.Tensor) -> tuple:
        return self.base.step_draws(key)

    def key_of(self, state) -> torch.Tensor:
        return self.base.key_of(state.base)

    def with_key(self, state, key: torch.Tensor):
        return state._replace(base=self.base.with_key(state.base, key))


# ---------------------------------------------------------------------------
# Canonical fault shapes (the ones the guardrail suite pins)
# ---------------------------------------------------------------------------

def throughput_collapse(start: int, duration: int = 8,
                        to_fraction: float = 0.2) -> FaultSpec:
    """Throughput drops to ``to_fraction`` of its true value at ``start``."""
    return FaultSpec("throughput", start, duration, "scale", to_fraction)


def latency_spike(start: int, duration: int = 8, factor: float = 4.0,
                  metric: str = "cpu_usage_iowait") -> FaultSpec:
    """Latency pressure: the model exposes no latency metric directly, so a
    spike surfaces as io-wait inflation (``cpu_usage_iowait`` by default)."""
    return FaultSpec(metric, start, duration, "scale", factor)


def metric_dropout(metric: str, start: int, duration: int = 8) -> FaultSpec:
    """Collector blackout: ``metric`` reads zero while active."""
    return FaultSpec(metric, start, duration, "dropout")


def nan_poison(metric: str, start: int, duration: int = 1) -> FaultSpec:
    """``metric`` reads NaN while active: the divergence trigger of the
    resilience layer (its health check must catch it before the poisoned
    sample reaches the replay window)."""
    return FaultSpec(metric, start, duration, "nan")


# ---------------------------------------------------------------------------
# Runtime chaos: the fault classes the resilience layer defends against
# ---------------------------------------------------------------------------

class TransientChunkError(RuntimeError):
    """A deterministic, injected transient staging failure (the kind a real
    fleet sees from a flaky device transfer or a preempted host thread).
    The supervised ``stream_chunks`` retries these; an unsupervised stream
    propagates them."""


class ChaosConfig(NamedTuple):
    """A declarative chaos plan spanning both failure domains.

    Inside the episode (through ``FaultInjectedModel``):
      ``nan_metric``    metric name to poison with NaN, or None.
      ``nan_start``     first tuning step the poison is active.
      ``nan_duration``  number of poisoned tuning steps.

    On the host (delivered by ``HostChaos.before_chunk``):
      ``fail_chunks``   ((chunk_index, n_failures), ...): the chunk fails its
                        first ``n_failures`` stage attempts with
                        ``TransientChunkError``, then succeeds.
      ``stall_chunks``  ((chunk_index, seconds), ...): the chunk sleeps
                        before staging (trips a wall-clock watchdog, no
                        failure).
    """

    nan_metric: str | None = None
    nan_start: int = 0
    nan_duration: int = 1
    fail_chunks: Tuple[Tuple[int, int], ...] = ()
    stall_chunks: Tuple[Tuple[int, float], ...] = ()

    def fault_specs(self) -> Tuple[FaultSpec, ...]:
        """The in-episode half, as ``FaultSpec`` rows for
        ``FaultInjectedModel``; empty when no metric poison is planned."""
        if self.nan_metric is None:
            return ()
        return (nan_poison(self.nan_metric, self.nan_start,
                           self.nan_duration),)

    def host(self) -> "HostChaos | None":
        """The host half; None when no host faults are planned."""
        if not self.fail_chunks and not self.stall_chunks:
            return None
        return HostChaos(self)


class HostChaos:
    """The host half of a chaos plan, handed to supervised streams;
    stateless per attempt.

    ``before_chunk(ci, attempt)`` is called by ``stream_chunks`` before each
    stage attempt: it raises ``TransientChunkError`` while ``attempt`` is
    below the planned failure count for chunk ``ci`` (so retries clear the
    fault deterministically), and sleeps for planned stalls. The failure
    schedule keys on (chunk, attempt), not on the clock or randomness, so a
    retried run's numbers are byte for byte those of a run without
    faults."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._fails = {int(c): int(n) for c, n in config.fail_chunks}
        self._stalls = {int(c): float(s) for c, s in config.stall_chunks}

    def before_chunk(self, chunk_index: int, attempt: int) -> None:
        stall = self._stalls.get(chunk_index)
        if stall:
            time.sleep(stall)
        n = self._fails.get(chunk_index, 0)
        if attempt < n:
            raise TransientChunkError(
                f"injected transient failure {attempt + 1}/{n} staging "
                f"chunk {chunk_index}")
