"""Self-healing episode engine: divergence quarantine inside the per-step
body, and chunk retry on the host.

Guardrails (``core.guardrails``) protect the *tuned system* from bad
configurations; this module protects the *tuner* from its own failures, at
two layers:

Inside the episode (``ResiliencePolicy``): the per-step body
(``core.episode.stepwise_episode``) keeps a last-good snapshot of the
learner (parameters, targets, Adam state, counts), detects non-finite
metrics, learner state or learner losses after each step's learner launch,
and by a branch-free ``torch.where`` resets a diverged session to the
snapshot. Every step emits a uint8 ``health_events`` bitmask (NONFINITE /
RESET / DEGRADED) into the trace. Once a session has spent ``max_resets``
resets (or crossed ``degrade_after`` non-finite detections) it DEGRADES to
frozen-incumbent mode: its learner stays pinned to the snapshot, so the env
keeps serving the incumbent configuration while the other sessions keep
training. In a shared-experience cell a corrupted or degraded member adds
nothing to the merged window or the cell mean, so one NaN cannot poison its
cellmates.

On the host (``ChunkSupervisor``): ``core.episode.stream_chunks`` retries a
failed chunk with exponential backoff and times each chunk against a
watchdog. The host tensors between chunks are the source of truth, so a
failed chunk re-stages and re-runs the same inputs: retries are bitwise
invisible on success. After ``max_retries`` the chunk either raises
``ChunkFailure`` (``on_failure="raise"``) or is skipped (``"skip"``:
``FleetService.advance`` quarantines the chunk's sessions through the leave
path, leaving the survivors' bits as they were).

Resilience defaults OFF: ``resilience=None`` never touches this module, and
every engine runs as it did without it.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

# health_events bitmask (uint8): one trace byte records the step's health
EVENT_NONFINITE = 1  # non-finite detected in metrics/losses/params this step
EVENT_RESET = 2      # learner restored to the last-good snapshot
EVENT_DEGRADED = 4   # session is in frozen-incumbent (degraded) mode


class ResiliencePolicy(NamedTuple):
    """Static divergence-recovery policy (hashable; checkpoints store it).

    ``nonfinite_check``  master switch; ``False`` normalizes the whole
                         policy to ``None`` (fully off).
    ``max_resets``       snapshot resets a session may spend before the next
                         divergence degrades it (a counter in the carry, never
                         exceeded).
    ``snapshot_every``   cadence (steps) of the last-good snapshot refresh:
                         a reset rolls the learner back at most this many
                         steps.
    ``degrade_after``    optional cap on TOTAL non-finite detections; once
                         crossed the session degrades even with resets left
                         (``None``: only the exhausted-resets path).
    """

    nonfinite_check: bool = True
    max_resets: int = 3
    snapshot_every: int = 1
    degrade_after: Optional[int] = None


def normalize_resilience(policy) -> Optional[ResiliencePolicy]:
    """Canonicalize a resilience policy; fully off collapses to ``None``.

    ``None`` stays ``None``; ``nonfinite_check=False`` IS off (no detector,
    nothing downstream can fire), so it returns ``None`` too: there is one
    canonical off value."""
    if policy is None:
        return None
    p = ResiliencePolicy(*policy)
    if not p.nonfinite_check:
        return None
    if p.max_resets < 0:
        raise ValueError(f"max_resets must be >= 0, got {p.max_resets}")
    if p.snapshot_every < 1:
        raise ValueError(
            f"snapshot_every must be >= 1, got {p.snapshot_every}")
    if p.degrade_after is not None and p.degrade_after < 1:
        raise ValueError(
            f"degrade_after must be >= 1 (or None), got {p.degrade_after}")
    return ResiliencePolicy(True, int(p.max_resets), int(p.snapshot_every),
                            None if p.degrade_after is None
                            else int(p.degrade_after))


class HealthState(NamedTuple):
    """Per-session health carry: numpy scalars (a snapshot of CPU tensors)
    between runs, tensors with a leading session axis inside the episode.

    ``snapshot`` is the last-good learner (a ``core.ddpg.DDPGState``), or
    ``()`` under ``snapshot_every == 1``, where the reset target is the
    step's entry learner and no copy rides the carry; ``resets`` and
    ``nonfinite`` are lifetime int32 counters; ``degraded`` is the sticky
    frozen-incumbent flag; ``since_snap`` counts steps since the snapshot
    was last refreshed."""

    snapshot: Any     # DDPGState (last-good learner) or ()
    resets: Any       # i32, lifetime count (never exceeds max_resets)
    nonfinite: Any    # i32, lifetime non-finite detections
    degraded: Any     # bool, sticky
    since_snap: Any   # i32


class ResilientCarry(NamedTuple):
    """The resilient body's carry: ``core.episode.EpisodeCarry`` and the
    sessions' ``HealthState``."""

    base: Any
    health: HealthState


class ResilientEpisodeTrace(NamedTuple):
    """``EpisodeTrace`` plus the per-step health byte.

    The first five fields mirror ``EpisodeTrace``, so every trace consumer
    (``replay_compact_trace``, the tuner's history) reads a resilient trace
    unchanged."""

    action_idx: Any
    metrics: Any
    rewards: Any
    objectives: Any
    restarts: Any
    health_events: Any  # [.., T] uint8


# ---------------------------------------------------------------------------
# The decision function, on numpy and on torch operands (the property tests
# run it on host scalars; the episode body on [N] tensors)
# ---------------------------------------------------------------------------

def _as(x, like):
    """``x`` (bool) cast to the integer type of ``like``."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return np.asarray(x).astype(np.asarray(like).dtype)


def health_decision(bad, resets, nonfinite, degraded,
                    policy: ResiliencePolicy):
    """One step of the health state machine (branch-free).

    ``bad``/``degraded`` are bools (numpy or tensors), ``resets`` /
    ``nonfinite`` int32. Returns ``(do_reset, new_degraded, new_resets,
    new_nonfinite)``. Invariants (held by the property tests): resets never
    exceed ``max_resets``; ``degraded`` is sticky; a degraded step never
    resets."""
    nf = nonfinite + _as(bad, nonfinite)
    new_degraded = degraded | (bad & (resets >= policy.max_resets))
    if policy.degrade_after is not None:
        new_degraded = new_degraded | (nf >= policy.degrade_after)
    do_reset = bad & ~new_degraded
    return do_reset, new_degraded, resets + _as(do_reset, resets), nf


# ---------------------------------------------------------------------------
# Non-finite detection and branch-free selection
# ---------------------------------------------------------------------------

def _float_leaves(tree) -> list:
    """The floating tensors of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _float_leaves(x)]
    return []


def tree_nonfinite(tree) -> torch.Tensor:
    """Scalar bool tensor: any non-finite value in any float tensor of
    ``tree`` (a ``DDPGState``, the learner's metrics dict)."""
    bad = None
    for leaf in _float_leaves(tree):
        b = ~torch.isfinite(leaf).all()
        bad = b if bad is None else bad | b
    return torch.zeros((), dtype=torch.bool) if bad is None else bad


def tree_nonfinite_rows(tree) -> torch.Tensor:
    """``[rows]`` bool: per row (leading axis) whether any float tensor of
    the row-stacked ``tree`` holds a non-finite value: the per-session
    detector over the learner's ``flat`` and its metrics."""
    bad = None
    for leaf in _float_leaves(tree):
        row_bad = ~torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(1)
        bad = row_bad if bad is None else bad | row_bad
    if bad is None:
        raise ValueError("tree has no float leaves to health-check")
    return bad


def select_tree(flag, when_true, when_false):
    """Branch-free select over two nests of one structure: ``flag`` a
    scalar or ``[rows]`` bool tensor matching the tensors' leading axis,
    broadcast across their trailing dims (the reset / freeze primitive)."""
    if isinstance(when_true, torch.Tensor):
        f = flag.reshape(flag.shape + (1,) * (when_true.dim() - flag.dim()))
        return torch.where(f, when_true, when_false)
    return type(when_true)(*(select_tree(flag, a, b)
                             for a, b in zip(when_true, when_false)))


# ---------------------------------------------------------------------------
# Health-state construction and conversion
# ---------------------------------------------------------------------------

def _snapshot_tree(state, resilience):
    """The snapshot for a policy: CPU copies of the learner, or ``()`` for
    the every-step cadence (its reset target is the step's entry learner,
    so a second learner copy would be pure overhead)."""
    if resilience is not None and resilience.snapshot_every == 1:
        return ()
    return type(state)(*(x.detach().to("cpu", copy=True) for x in state))


def init_health_state(ddpg_state, resilience=None) -> HealthState:
    """Fresh health state for one session: the snapshot starts at its
    current learner (a ``DDPGState``); pass its ``ResiliencePolicy`` so the
    every-step cadence skips the snapshot copy."""
    return HealthState(
        snapshot=_snapshot_tree(ddpg_state, resilience),
        resets=np.int32(0), nonfinite=np.int32(0),
        degraded=np.bool_(False), since_snap=np.int32(0))


def init_fleet_health_state(stacked_states, n: int,
                            resilience=None) -> HealthState:
    """Stacked ``[N, ...]`` health state for a fleet, ``stacked_states``
    the agent's session-stacked ``DDPGState``."""
    return HealthState(
        snapshot=_snapshot_tree(stacked_states, resilience),
        resets=np.zeros(n, np.int32), nonfinite=np.zeros(n, np.int32),
        degraded=np.zeros(n, bool), since_snap=np.zeros(n, np.int32))


def stack_health(healths) -> HealthState:
    """Per-session ``HealthState``s -> one with a leading [N] axis."""
    healths = list(healths)
    first = healths[0].snapshot
    snapshot = () if len(first) == 0 else type(first)(*(
        torch.stack(xs) for xs in zip(*(h.snapshot for h in healths))))
    return HealthState(snapshot, *(np.stack(xs) for xs in
                                   zip(*(h[1:] for h in healths))))


def health_row(health: HealthState, i: int) -> HealthState:
    """Session ``i`` of a stacked ``HealthState``, as copies."""
    snap = health.snapshot
    snapshot = () if len(snap) == 0 else type(snap)(*(x[i].clone()
                                                  for x in snap))
    return HealthState(snapshot, *(np.array(x[i]) for x in health[1:]))


def health_to_torch(health: HealthState, device=None,
                    pin: bool = False) -> HealthState:
    """A (stacked) ``HealthState`` as tensors, on ``device`` or, when
    ``pin``, in page-locked host memory."""
    def one(x):
        t = torch.as_tensor(np.array(x)) if not isinstance(
            x, torch.Tensor) else x.to("cpu", copy=True)
        return t.pin_memory() if pin else t.to(device)

    snap = health.snapshot
    snapshot = () if len(snap) == 0 else type(snap)(*(one(x) for x in snap))
    return HealthState(snapshot, *(one(x) for x in health[1:]))


def health_to_numpy(health: HealthState) -> HealthState:
    """A tensor ``HealthState`` back in the host form: the snapshot as CPU
    tensors, the counters as numpy."""
    snap = health.snapshot
    snapshot = () if len(snap) == 0 else type(snap)(*(x.to("cpu", copy=True)
                                                  for x in snap))
    return HealthState(snapshot, *(x.cpu().numpy().copy()
                                   for x in health[1:]))


# ---------------------------------------------------------------------------
# The resilient step (what ``core.episode.stepwise_episode`` runs around the
# learner when a ResiliencePolicy is set)
# ---------------------------------------------------------------------------

def health_update(policy: ResiliencePolicy, health: HealthState, bad,
                  entry, learned) -> tuple:
    """The health layer after a step's learner: from the sessions' ``bad``
    flags ``[N]`` (a corrupted reading or a non-finite learner), their
    ``entry`` learner (the step's, a ``DDPGState``) and ``learned`` (after
    the learner launch and, in a cell, its mean), the reset or degraded
    freeze, the snapshot cadence and the health byte. The counterpart of
    the lifecycle in the reference's ``build_resilient_step``.

    Returns ``(learner, health, event)``: the learner the session keeps
    (``entry`` or the snapshot where it resets or is degraded, else
    ``learned``), the new ``HealthState`` and the uint8 events ``[N]``."""
    do_reset, degraded, resets, nf_total = health_decision(
        bad, health.resets, health.nonfinite, health.degraded, policy)
    pin = do_reset | degraded
    if policy.snapshot_every == 1:
        # a refreshed every-step snapshot is always the next step's entry
        # learner, so the revert target IS the entry learner
        learner = select_tree(pin, entry, learned)
        snapshot = health.snapshot
        refresh = ~bad & ~degraded
    else:
        learner = select_tree(pin, health.snapshot, learned)
        due = (health.since_snap + 1) >= policy.snapshot_every
        refresh = due & ~bad & ~degraded
        snapshot = select_tree(refresh, learner, health.snapshot)
    since = torch.where(refresh, torch.zeros_like(health.since_snap),
                        health.since_snap + 1)
    u8 = torch.uint8
    event = (bad.to(u8) * EVENT_NONFINITE + do_reset.to(u8) * EVENT_RESET
             + degraded.to(u8) * EVENT_DEGRADED)
    return learner, HealthState(snapshot, resets, nf_total, degraded,
                                since), event


# ---------------------------------------------------------------------------
# Host-side counters (derived from the trace)
# ---------------------------------------------------------------------------

HEALTH_COUNTER_KEYS = ("steps", "nonfinite", "resets", "degraded_steps")


def health_counters(events: np.ndarray) -> dict:
    """Structured counters from a session's health trace ([T] uint8). Pure
    accounting: accumulate across runs with ``merge_health_counters``."""
    ev = np.asarray(events)
    return {
        "steps": int(ev.size),
        "nonfinite": int(((ev & EVENT_NONFINITE) != 0).sum()),
        "resets": int(((ev & EVENT_RESET) != 0).sum()),
        "degraded_steps": int(((ev & EVENT_DEGRADED) != 0).sum()),
    }


def merge_health_counters(a: dict, b: dict) -> dict:
    """Sum two counter dicts (missing keys count as zero)."""
    return {k: a.get(k, 0) + b.get(k, 0) for k in dict.fromkeys((*a, *b))}


def empty_health_counters() -> dict:
    return {k: 0 for k in HEALTH_COUNTER_KEYS}


def health_stats(policy: ResiliencePolicy, health: HealthState,
                 counters: dict) -> dict:
    """One session's exported health record: the policy, the cumulative
    counters and the carried totals (which the tests hold against the
    trace-derived counters)."""
    d = dict(counters)
    d.update(
        policy=dict(policy._asdict()),
        resets_total=int(health.resets) if health is not None else 0,
        nonfinite_total=int(health.nonfinite) if health is not None else 0,
        degraded=bool(health.degraded) if health is not None else False)
    return d


# ---------------------------------------------------------------------------
# Host supervisor: chunk retry / backoff / watchdog configuration
# ---------------------------------------------------------------------------

class ChunkSupervisor(NamedTuple):
    """Host-side chunk supervision for ``core.episode.stream_chunks``.

    ``max_retries``        re-runs of a failed chunk before giving up. The
                           host tensors between chunks are the source of
                           truth, so a retry re-stages the SAME inputs and
                           is bitwise invisible on success.
    ``backoff_seconds``    initial retry delay; grows by
                           ``backoff_multiplier`` per attempt.
    ``watchdog_seconds``   per-chunk wall-clock budget; a chunk exceeding it
                           counts as a ``watchdog_trips`` stall in the run
                           stats (a chunk in this process cannot be
                           preempted, so detection is after the fact).
    ``on_failure``         ``"raise"`` propagates ``ChunkFailure`` after the
                           retries; ``"skip"`` leaves the chunk's host state
                           untouched and goes on with the other chunks
                           (``FleetService`` then quarantines the chunk's
                           sessions through the leave path).
    """

    max_retries: int = 2
    backoff_seconds: float = 0.05
    backoff_multiplier: float = 2.0
    watchdog_seconds: Optional[float] = None
    on_failure: str = "raise"


class ChunkFailure(RuntimeError):
    """A chunk kept failing after every supervised retry."""

    def __init__(self, chunk_index: int, attempts: int, cause: Exception):
        super().__init__(
            f"chunk {chunk_index} failed after {attempts} attempt(s): "
            f"{cause!r}")
        self.chunk_index = int(chunk_index)
        self.attempts = int(attempts)
        self.cause = cause


@functools.lru_cache(maxsize=None)
def _canon_supervisor(sup: ChunkSupervisor) -> ChunkSupervisor:
    if sup.max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {sup.max_retries}")
    if sup.on_failure not in ("raise", "skip"):
        raise ValueError(
            f"on_failure must be 'raise' or 'skip', got {sup.on_failure!r}")
    return sup


def normalize_supervisor(sup) -> Optional[ChunkSupervisor]:
    """Validate a supervisor config; ``None`` stays ``None`` (unsupervised:
    the unchanged pipeline, no added host work)."""
    if sup is None:
        return None
    return _canon_supervisor(ChunkSupervisor(*sup))
