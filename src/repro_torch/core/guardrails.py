"""Safe rollout: shadow/canary deployment guardrails with rollback.

The paper's premise (static parameters: every apply costs a restart) is why
a raw RL tuner cannot be pointed at a production file system. This module
adds the deployment layer that makes the tuner's recommendations
adoptable: a ``DeploymentPolicy`` evaluated inside the per-step episode
body (``core.episode.stepwise_episode``), so every proposal is scored in
shadow before the live configuration moves.

Per guarded step:

  shadow    the actor's proposal is scored with an ``eval_run=True`` probe
            on the current env state (the ``evaluate_config`` semantics:
            lower measurement variance), and the probed state is DISCARDED,
            so the live system never runs the proposal. The learner trains
            on this shadow transition, so the policy keeps improving while
            the gate holds the live config still.
  gate      promotion needs (a) shadow gain >= ``min_gain`` relative to the
            live objective and (b) the proposal's restart cost to fit the
            remaining ``max_restart_seconds`` budget (``gate_decision``).
  canary    if the gate passes, the proposal is committed to the live
            system and the displaced incumbent becomes the rollback
            fallback; the regression watch (``rollback_window`` steps) arms.
  rollback  while the watch is armed, a live objective more than
            ``rollback_threshold`` below the pre-promotion anchor restores
            the fallback configuration (``rollback_decision``). Rollbacks
            are always allowed: the budget gates promotions, never the path
            back to a known-good config; the fallback re-apply's restart is
            charged to the budget at the next committed step.

All of it is branch-free ``torch.where`` selection over three env steps
(shadow probe, canary branch, keep branch) of every session of a chunk at
once. The three share the step's draws (one ``step_draws``; the committed
branch's state carries the advanced key forward), so shadow and live draws
are correlated within a step, by design: the shadow score measures the
config, not a fresh noise draw.

Guardrails default OFF. ``policy=None`` never touches this module: every
engine runs the episode kernel as it did without it.

Decision trail: every step emits a uint8 event bitmask and the shadow
objective into the trace (``GuardedEpisodeTrace``), from which
``guardrail_counters`` derives the per-session counters surfaced by
``Tuner``, ``FleetTuner`` and ``FleetService``.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.action_mapping import ParamSpace

# guard_events bitmask (uint8): one trace byte records the whole decision
EVENT_PROMOTED = 1        # proposal passed the gate and was committed
EVENT_REJECTED_GAIN = 2   # shadow gain below min_gain
EVENT_REJECTED_BUDGET = 4  # restart budget could not absorb the apply
EVENT_ROLLBACK = 8        # live regression -> incumbent restored


class DeploymentPolicy(NamedTuple):
    """Static promotion/rollback policy (hashable; checkpoints store it).

    ``min_gain``            minimum relative shadow gain vs the live
                            objective for a proposal to be promoted.
    ``max_restart_seconds`` total committed restart downtime the guarded
                            session may spend; a promotion whose restart
                            would exceed the remainder is rejected.
    ``rollback_window``     steps after a promotion during which a live
                            regression restores the incumbent (0 disables
                            rollback).
    ``rollback_threshold``  relative drop vs the pre-promotion anchor that
                            counts as a regression.
    """

    min_gain: float = 0.0
    max_restart_seconds: float = float("inf")
    rollback_window: int = 0
    rollback_threshold: float = 0.05


class GuardState(NamedTuple):
    """Per-session guard carry: numpy between runs (``init_guard_state``),
    tensors with a leading session axis inside the episode.

    ``live_action`` is the unit action of the configuration the live system
    runs; ``fallback_action``/``fallback_obj`` anchor the rollback target
    (the incumbent displaced by the last promotion and its objective at
    promotion time). ``budget_spent`` accumulates every committed restart
    second; ``watch_left`` counts the remaining regression-watch steps."""

    live_action: Any       # [m] f32 unit action
    fallback_action: Any   # [m] f32 unit action
    fallback_obj: Any      # f32 scalar
    budget_spent: Any      # f32 scalar
    watch_left: Any        # i32 scalar
    promotions: Any        # i32 scalar, lifetime count
    rollbacks: Any         # i32 scalar, lifetime count


class GuardedCarry(NamedTuple):
    """The guarded body's carry: ``core.episode.EpisodeCarry`` and the
    sessions' ``GuardState``."""

    base: Any
    guard: GuardState


class GuardedEpisodeTrace(NamedTuple):
    """``EpisodeTrace`` plus the shadow-vs-live decision trail.

    The first five fields mirror ``EpisodeTrace``, so every trace consumer
    (``replay_compact_trace``, the tuner's history) reads a guarded trace
    unchanged. ``guard_events`` is the uint8 bitmask above;
    ``shadow_objectives`` the f32 shadow score of each step's proposal."""

    action_idx: Any
    metrics: Any
    rewards: Any
    objectives: Any
    restarts: Any
    guard_events: Any       # [.., T] uint8
    shadow_objectives: Any  # [.., T] f32


# ---------------------------------------------------------------------------
# Decision functions, on numpy and on torch operands (the property tests run
# them on host scalars; the episode body on [N] tensors)
# ---------------------------------------------------------------------------

def gate_decision(shadow_gain, restart_cost, budget_spent,
                  policy: DeploymentPolicy):
    """Canary promotion gate. Returns ``(promote, gain_ok, budget_ok)``.

    Monotone in both thresholds: lowering ``min_gain`` or raising
    ``max_restart_seconds`` can only turn rejections into promotions on the
    same inputs. A Python float threshold meets a float32 operand as a
    float32, as the reference's weakly typed scalar does."""
    gain_ok = shadow_gain >= policy.min_gain
    budget_ok = (budget_spent + restart_cost) <= policy.max_restart_seconds
    return gain_ok & budget_ok, gain_ok, budget_ok


def rollback_decision(live_obj, anchor_obj, watch_left,
                      policy: DeploymentPolicy):
    """Regression check against the pre-promotion anchor objective.

    Fires only while the watch is armed (``watch_left > 0``) and the live
    objective sits more than ``rollback_threshold`` (relative) below the
    anchor; the divisor is ``max(anchor, 1e-6)`` in float32. Monotone in the
    threshold: raising it can only suppress rollbacks."""
    floor = np.float32(1e-6)
    if isinstance(anchor_obj, torch.Tensor):
        denom = torch.clamp(anchor_obj, min=float(floor))
    else:
        denom = np.maximum(anchor_obj, floor)
    rel_drop = (live_obj - anchor_obj) / denom
    threshold = -float(np.float32(policy.rollback_threshold))
    return (watch_left > 0) & (rel_drop < threshold)


# ---------------------------------------------------------------------------
# Guard-state construction
# ---------------------------------------------------------------------------

def init_guard_state(space: ParamSpace, live_config: dict,
                     live_objective: float) -> GuardState:
    """Guard state for a session whose live system runs ``live_config``."""
    a = np.asarray(space.to_action(live_config), np.float32)
    return GuardState(
        live_action=a, fallback_action=a.copy(),
        fallback_obj=np.float32(live_objective),
        budget_spent=np.float32(0.0), watch_left=np.int32(0),
        promotions=np.int32(0), rollbacks=np.int32(0))


def stack_guards(guards) -> GuardState:
    """Per-session ``GuardState``s -> one with a leading [N] axis (numpy)."""
    return GuardState(*(np.stack(xs) for xs in zip(*guards)))


def guard_row(guard: GuardState, i: int) -> GuardState:
    """Session ``i`` of a stacked ``GuardState``, as numpy copies."""
    return GuardState(*(np.array(x[i]) for x in guard))


def init_fleet_guard_state(space: ParamSpace, live_configs, live_objectives
                           ) -> GuardState:
    """Stacked [N, ...] guard state for a fleet (numpy leaves)."""
    return stack_guards([init_guard_state(space, c, o)
                         for c, o in zip(live_configs, live_objectives)])


def guard_to_torch(guard: GuardState, device=None,
                   pin: bool = False) -> GuardState:
    """A (stacked) numpy ``GuardState`` as tensors, on ``device`` or, when
    ``pin``, in page-locked host memory."""
    def one(x):
        t = torch.as_tensor(np.array(x))
        return t.pin_memory() if pin else t.to(device)

    return GuardState(*(one(x) for x in guard))


def guard_to_numpy(guard: GuardState) -> GuardState:
    """A tensor ``GuardState`` as numpy copies."""
    return GuardState(*(x.cpu().numpy().copy() for x in guard))


# ---------------------------------------------------------------------------
# The guarded transition (the step ``core.episode.stepwise_episode`` runs
# when a policy is set)
# ---------------------------------------------------------------------------

def guarded_transition(model, params, state, proposal: torch.Tensor, draws,
                       objective: torch.Tensor, bounds: tuple,
                       guard: GuardState, policy: DeploymentPolicy) -> tuple:
    """The shadow/gate/canary/rollback layer around one env transition of
    every session of a chunk; the counterpart of the reference's
    ``build_guarded_step``.

    ``state`` carries this step's key (``model.with_key``) and ``draws`` are
    its draws; ``objective`` is the live objective before the step and
    ``bounds`` ``(lo, span, w_vec)``. Returns ``(transition, guard, event,
    shadow_objective)``: a ``core.episode.Transition`` whose committed
    action, metrics, restart and state are the live system's (the canary
    branch's where promoted, the keep branch's elsewhere) and whose stored
    row is the SHADOW transition (the proposal, its shadow gain and shadow
    state); the new ``GuardState``; the uint8 events ``[N]``; the shadow
    objectives ``[N]``."""
    from repro_torch.core.episode import Transition, normalized_objective, \
        relative_gain, tree_map

    _, shadow_metrics, _ = model.step_fn(params, state, proposal, draws,
                                         True)
    shadow_norm, shadow_obj = normalized_objective(shadow_metrics, *bounds)
    shadow_gain = relative_gain(shadow_obj, objective)

    # canary and keep branches both run; a select by promote commits one
    p_state, p_metrics, p_restart = model.step_fn(params, state, proposal,
                                                  draws, False)
    k_state, k_metrics, k_restart = model.step_fn(params, state,
                                                  guard.live_action, draws,
                                                  False)
    promote, gain_ok, budget_ok = gate_decision(
        shadow_gain, p_restart, guard.budget_spent, policy)

    def where(cond):
        def sel(p, k):
            return torch.where(
                cond.reshape(cond.shape + (1,) * (p.dim() - cond.dim())),
                p, k)
        return sel

    sel = where(promote)
    env_state = tree_map(sel, p_state, k_state)
    committed = sel(proposal, guard.live_action)
    metrics = sel(p_metrics, k_metrics)
    restart = sel(p_restart, k_restart)
    norm, obj = normalized_objective(metrics, *bounds)
    reward = relative_gain(obj, objective)

    # the displaced incumbent becomes the rollback anchor; every committed
    # restart draws on the budget (the keep branch's restart is 0 unless it
    # re-applies a rolled-back fallback, charged here)
    fallback_action = sel(guard.live_action, guard.fallback_action)
    fallback_obj = sel(objective, guard.fallback_obj)
    watch = torch.where(promote,
                        torch.full_like(guard.watch_left,
                                        policy.rollback_window),
                        torch.clamp(guard.watch_left - 1, min=0))
    budget = guard.budget_spent + restart

    rollback = rollback_decision(obj, fallback_obj, watch, policy)
    live_action = where(rollback)(fallback_action, committed)
    watch = torch.where(rollback, torch.zeros_like(watch), watch)

    u8 = torch.uint8
    event = (promote.to(u8) * EVENT_PROMOTED
             + (~gain_ok).to(u8) * EVENT_REJECTED_GAIN
             + (~budget_ok).to(u8) * EVENT_REJECTED_BUDGET
             + rollback.to(u8) * EVENT_ROLLBACK)
    guard = GuardState(
        live_action=live_action, fallback_action=fallback_action,
        fallback_obj=fallback_obj, budget_spent=budget, watch_left=watch,
        promotions=guard.promotions + promote.to(torch.int32),
        rollbacks=guard.rollbacks + rollback.to(torch.int32))
    transition = Transition(
        env_state=env_state, committed=committed, metrics=metrics,
        restart=restart, norm=norm, objective=obj, reward=reward,
        stored=(proposal, shadow_gain, shadow_norm))
    return transition, guard, event, shadow_obj


# ---------------------------------------------------------------------------
# Host-side counters (derived from the trace)
# ---------------------------------------------------------------------------

COUNTER_KEYS = ("proposals", "promotions", "rejected_min_gain",
                "rejected_budget", "rollbacks", "restart_seconds")


def guardrail_counters(events: np.ndarray,
                       restarts: np.ndarray = None) -> dict:
    """Structured counters from a session's event trace ([T] uint8).

    ``restarts`` (decoded f32 seconds, same length) adds the committed
    guarded downtime. Pure accounting: accumulate across runs by summing
    dicts (``merge_counters``)."""
    ev = np.asarray(events)
    d = {
        "proposals": int(ev.size),
        "promotions": int(((ev & EVENT_PROMOTED) != 0).sum()),
        "rejected_min_gain": int(((ev & EVENT_REJECTED_GAIN) != 0).sum()),
        "rejected_budget": int(((ev & EVENT_REJECTED_BUDGET) != 0).sum()),
        "rollbacks": int(((ev & EVENT_ROLLBACK) != 0).sum()),
        "restart_seconds": 0.0,
    }
    if restarts is not None:
        d["restart_seconds"] = float(np.asarray(restarts,
                                                np.float64).sum())
    return d


def merge_counters(a: dict, b: dict) -> dict:
    """Sum two counter dicts (missing keys count as zero)."""
    return {k: a.get(k, 0) + b.get(k, 0)
            for k in dict.fromkeys((*a, *b))}


def guardrail_stats(policy: DeploymentPolicy, guard: GuardState,
                    counters: dict, space: ParamSpace = None) -> dict:
    """One session's exported guardrail record: the policy, the cumulative
    counters and the guard state's own totals (float32 and int32
    accumulators, which the tests hold against the counters)."""
    spent = float(np.float32(guard.budget_spent)) if guard is not None else 0.0
    d = dict(counters)
    d.update(
        policy=dict(policy._asdict()),
        restart_budget_spent=spent,
        budget_remaining=max(0.0, float(policy.max_restart_seconds) - spent),
        watch_left=int(guard.watch_left) if guard is not None else 0,
        promotions_total=int(guard.promotions) if guard is not None else 0,
        rollbacks_total=int(guard.rollbacks) if guard is not None else 0)
    if space is not None and guard is not None:
        d["live_config"] = space.to_config(
            np.asarray(guard.live_action, np.float32))
    return d


@functools.lru_cache(maxsize=None)
def _empty_counters() -> tuple:
    return tuple((k, 0 if k != "restart_seconds" else 0.0)
                 for k in COUNTER_KEYS)


def empty_counters() -> dict:
    return dict(_empty_counters())
