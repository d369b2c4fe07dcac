"""Whole-episode engine: the Fig. 1 loop for one session, or for a fleet of
sessions chunk by chunk, as ONE kernel launch per episode (per chunk) on the
card.

``core.tuner.Tuner(engine="host")`` steps the loop from Python: every
tuning step crosses the host boundary to act, apply the config, scalarize
the reward, store the transition and learn. ``run_episode_scan`` hands the
whole T-step episode (act -> env step -> reward -> FIFO store -> 96
updates, per step) to ``kernels.ops.episode_inner_loop``: on the card the
CUDA kernel ``kernels/csrc/episode_learn.cu`` runs it in one launch; on the
CPU its plain PyTorch version runs the same steps in a Python loop.

Equivalence with the host loop over the same ``ModelEnv``: the exploration
(Latin-hypercube warmup plan and OU noise) is state-independent, so it is
drawn up front from the agent's own numpy streams
(``_consume_exploration``); the env key chain and the learner's minibatch
indices do not depend on the actions either, so they are drawn up front
from the same threefry chains (``kernels.episode_learn.predraw``). The
episode then performs the host loop's float32 arithmetic step for step, so
its decisions equal the host engine's (pinned in
tests/test_torch_tuner.py). The entry point mutates the env, the agent and
the replay buffer exactly as ``steps`` host-loop iterations would, so
progressive tuning and the final recommendation work unchanged on top.

The trace is compact: actions as per-knob quantization indices
(``ParamSpace.index_dtype``) and restart seconds as int32 fixed point
(``RESTART_FP_SCALE``).

The fleet runtime, ``stream_fleet_episode``, runs N sessions' episodes
streamed in chunks: the fleet's state stays in host tensors between chunks,
each chunk is staged into the same ``EpisodeOperands`` with a leading
``[C]`` axis and runs in one launch, and its trace and carry are copied
back (``stream_chunks``, with copy streams beside the compute stream when
``overlap``). Each session brings its own exploration and FIFO cursor, so
sessions of different ages share a launch. ``core.fleet.FleetTuner(
engine="scan")`` drives it through ``run_fleet_episode_scan`` (a fleet of
one age), ``core.service.FleetService`` directly.

The per-step body, ``stepwise_episode``, runs the same Fig. 1 loop as a
Python loop over the steps with every operation at ``[N, ...]``: the act
(``core.ddpg.fleet_act``), one ``step_draws`` and the model's step, the
reward, the FIFO store and the learner (``core.ddpg.fleet_learn_scan``, one
launch of the CUDA learner ``kernels/csrc/ddpg_learn.cu`` per step on the
card). It is the reference's default scan body (``_build_episode``) and
what the policy layers are written on: a ``core.guardrails.
DeploymentPolicy`` (the guarded transition), a ``core.resilience.
ResiliencePolicy`` (the health layer around the learner), an observation
mask (``core.sharing.resolve_obs_mask``) and the cells of
``core.sharing.SharingConfig`` (merged replay windows, the cell mean).
With every layer off, every entry point runs the episode kernel as
before. ``stream_chunks`` runs the chunks under a ``core.resilience.
ChunkSupervisor`` when one is given.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scalarization import metric_bounds, normalize_state


class BufferState(NamedTuple):
    """The FIFO replay window the episode carries (``ReplayBuffer``'s
    storage): float32 ``s [.., cap, k]``, ``a [.., cap, m]``, ``r [..,
    cap]``, ``s2 [.., cap, k]`` and int32 cursors ``next_slot``, ``size``."""

    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    s2: torch.Tensor
    next_slot: torch.Tensor
    size: torch.Tensor


class EpisodeCarry(NamedTuple):
    """What one step hands the next: env state, learner, replay window,
    the learner's key, the normalized metric state and its objective."""

    env_state: Any
    ddpg: Any
    buffer: BufferState
    learn_key: torch.Tensor
    state_vec: torch.Tensor
    objective: torch.Tensor


class Transition(NamedTuple):
    """One env transition of every session of a chunk, as the per-step
    body commits it: the env state after it, the action the live system
    ran, its raw metrics and restart seconds, the normalized state and its
    objective, the reward, and the ``(a, r, s2)`` rows the replay stores
    beside the state before the step."""

    env_state: Any
    committed: torch.Tensor
    metrics: torch.Tensor
    restart: torch.Tensor
    norm: torch.Tensor
    objective: torch.Tensor
    reward: torch.Tensor
    stored: tuple


class EpisodeTrace(NamedTuple):
    """Per-step outputs, steps on the last leading axis. ``action_idx``
    holds knob quantization indices (decode with
    ``ParamSpace.configs_from_indices``); ``restarts`` is int32 fixed point
    on the device and decoded float32 seconds once ``run_episode_scan``
    returns it."""

    action_idx: Any
    metrics: Any
    rewards: Any
    objectives: Any
    restarts: Any


# Every restart cost the env models emit is a float32 in {0} U [4 s, 1024 s),
# whose ulp is at least 2**-21, so cost * 2**21 is an exact int32 and the
# decode (int -> f64 -> / 2**21 -> f32) gives back the original bits.
RESTART_FP_SCALE = float(2 ** 21)
RESTART_FP_MAX_SECONDS = 1023.0


def _encode_restart(cost: torch.Tensor) -> torch.Tensor:
    clipped = torch.clamp(cost, 0.0, RESTART_FP_MAX_SECONDS)
    return torch.round(clipped * RESTART_FP_SCALE).to(torch.int32)


def decode_restarts(fp: np.ndarray) -> np.ndarray:
    """int32 fixed-point restart trace -> float32 seconds (exact)."""
    return (np.asarray(fp).astype(np.float64) / RESTART_FP_SCALE).astype(
        np.float32)


def normalized_objective(metrics: torch.Tensor, lo: torch.Tensor,
                         span: torch.Tensor, w_vec: torch.Tensor) -> tuple:
    """(normalized state, objective) of raw metrics ``[.., k]``: each metric
    clipped to [0, 1] within its bounds (0 where the span is 0), then the
    serial float32 fold of the weighted terms in state order, bit-aligned
    with ``Scalarizer.objective``."""
    norm = torch.where(span > 0, torch.clamp((metrics - lo) / span, 0.0, 1.0),
                       torch.zeros_like(metrics))
    obj = torch.zeros_like(metrics[..., 0])
    for j in range(norm.shape[-1]):
        obj = obj + w_vec[..., j] * norm[..., j]
    return norm, obj


def relative_gain(objective: torch.Tensor, prev: torch.Tensor
                  ) -> torch.Tensor:
    """The reward: ``(objective - prev) / max(prev, 1e-6)`` in float32."""
    return (objective - prev) / torch.clamp(prev, min=1e-6)


def tree_map(fn, *trees):
    """``fn`` over the tensors of nests of ``NamedTuple``s (env states,
    ``GuardState``), leaf by leaf; the nests share one structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))


def draw_exploration(plan: np.ndarray, noise_src, age: int,
                     warmup_steps: int, steps: int) -> tuple:
    """Pre-draw ``steps`` steps of one session's exploration at its own age
    ``age`` (the steps it has taken): the Latin-hypercube ``plan`` while
    ``age + t < warmup_steps``, then the OU ``noise_src``. Warmup plans and
    OU noise are state-independent, so drawing them up front leaves the
    noise stream exactly where ``steps`` host-loop ``act()`` calls would.
    Returns (use_warmup [T] bool, warmup_actions [T, m], noise [T, m]) as
    numpy."""
    m = plan.shape[-1]
    use_warmup = np.zeros(steps, bool)
    warmup = np.zeros((steps, m), np.float32)
    noise = np.zeros((steps, m), np.float32)
    for t in range(steps):
        if age + t < warmup_steps:
            use_warmup[t] = True
            warmup[t] = plan[age + t]
        else:
            noise[t] = noise_src()
    return use_warmup, warmup, noise


def _consume_exploration(agent, steps: int,
                         session: Optional[int] = None) -> tuple:
    """``draw_exploration`` from an agent's own host streams. A
    ``MagpieAgent`` (``session=None``) advances its ``steps_taken``; for a
    ``FleetAgent``, ``session`` picks the session's plan and noise stream
    and the caller advances the fleet's shared counter once."""
    if session is None:
        plan, noise_src = agent._warmup_plan, agent.noise
    else:
        plan, noise_src = agent._warmup_plans[session], agent.noises[session]
    out = draw_exploration(plan, noise_src, agent.steps_taken,
                           agent.warmup_steps, steps)
    if session is None:
        agent.steps_taken += steps
    return out


class Layers(NamedTuple):
    """The policy layers a per-step body runs, normalized: a
    ``core.guardrails.DeploymentPolicy``, a ``core.resilience.
    ResiliencePolicy``, an observation mask (0/1 floats over the k state
    metrics), a ``core.sharing.SharingConfig`` and the cell size of its
    cell modes (1 when they are off). All ``None`` (and 1) is the path
    without layers: the episode kernel."""

    policy: Any = None
    resilience: Any = None
    obs_mask: Any = None
    sharing: Any = None
    cell_size: int = 1

    @property
    def cells(self) -> bool:
        """Whether sessions run in cells (shared replay or the cell
        mean)."""
        return self.sharing is not None and self.sharing.cells

    @property
    def shared_replay(self) -> bool:
        return self.cells and self.sharing.shared_replay

    @property
    def stepwise(self) -> bool:
        """Whether any layer is on, so the per-step body runs."""
        return (self.policy is not None or self.resilience is not None
                or self.obs_mask is not None or self.cells)


def check_guard_composition(policy, **layers) -> None:
    """The reference's refusals of a ``DeploymentPolicy`` beside another
    layer that rewrites the body (``sharing``, ``resilience``,
    ``obs_mask``, ``observation_scopes``): ``ValueError``, the guarded step
    owning its own observe and learn path."""
    if policy is None:
        return
    for name, value in layers.items():
        if value is not None:
            raise ValueError(
                f"{name} does not compose with DeploymentPolicy guardrails "
                f"(the guarded step owns its own observe and learn path); "
                f"run guarded sessions with {name} off")


def resolve_layers(policy=None, resilience=None, obs_mask=None,
                   sharing=None, cell_size: int = 1) -> Layers:
    """The layers asked for, normalized (``normalize_resilience``,
    ``normalize_sharing``; a fully-off layer is ``None``, the cell size 1
    unless a cell mode is on) and checked: a ``DeploymentPolicy`` composes
    with none of the others (the reference's ``ValueError``)."""
    if resilience is not None:
        from repro_torch.core.resilience import normalize_resilience
        resilience = normalize_resilience(resilience)
    if sharing is not None:
        from repro_torch.core.sharing import normalize_sharing
        sharing = normalize_sharing(sharing)
    check_guard_composition(policy, sharing=sharing, resilience=resilience,
                            obs_mask=obs_mask)
    if obs_mask is not None:
        obs_mask = tuple(float(v) for v in obs_mask)
    layers = Layers(policy, resilience, obs_mask, sharing, 1)
    if layers.cells:
        if int(cell_size) < 1:
            raise ValueError(f"cell_size must be >= 1, got {cell_size}")
        layers = layers._replace(cell_size=int(cell_size))
    return layers


def _decode_trace(trace):
    """Device trace -> host numpy (its own trace type), restart fixed point
    decoded to seconds."""
    host = type(trace)(*(x.cpu().numpy() for x in trace))
    return host._replace(restarts=decode_restarts(host.restarts))


def _new_trace(n: int, steps: int, cfg, device, layers: Layers):
    """A zero trace of N sessions' T steps, as the episode kernel writes
    it; with the decision trail under a policy, the health byte under
    resilience."""
    from repro_torch.kernels.episode_learn import _empty_trace

    trace = _empty_trace(n, steps, cfg, device)

    def zeros(dtype=torch.float32):
        return torch.zeros((n, steps), dtype=dtype, device=device)

    if layers.policy is not None:
        from repro_torch.core.guardrails import GuardedEpisodeTrace
        return GuardedEpisodeTrace(*trace, guard_events=zeros(torch.uint8),
                                   shadow_objectives=zeros())
    if layers.resilience is not None:
        from repro_torch.core.resilience import ResilientEpisodeTrace
        return ResilientEpisodeTrace(*trace,
                                     health_events=zeros(torch.uint8))
    return trace


def plain_transition(model, params, state, action: torch.Tensor, draws,
                     objective: torch.Tensor, bounds: tuple) -> Transition:
    """The unguarded transition: the model's step on ``action`` (``state``
    carrying this step's key), its normalized state, objective and reward;
    the replay stores what the live system ran."""
    env_state, metrics, restart = model.step_fn(params, state, action, draws,
                                                False)
    norm, obj = normalized_objective(metrics, *bounds)
    reward = relative_gain(obj, objective)
    return Transition(env_state, action, metrics, restart, norm, obj, reward,
                      (action, reward, norm))


class CellInputs(NamedTuple):
    """What the cell body reads beside the episode's operands, both ``[N,
    T]`` bool on the learner's device: ``avg_now`` (the cell mean fires at
    this step; a cell reads its first lane) and ``active`` (False lanes
    are padding, such as a service's vacant seats: they never write to the
    merged window and weigh nothing in the mean)."""

    avg_now: torch.Tensor
    active: torch.Tensor


def _check_stepwise(op, carry: EpisodeCarry, spec, layers: Layers,
                    cells) -> tuple:
    """Validate what the per-step body reads; return (N, T)."""
    model, cfg = spec.model, spec.cfg
    if not model.param_space.is_quantized:
        raise ValueError("the episode body needs a quantized ParamSpace: "
                         "continuous knobs have no exact quantization (use "
                         "the host engine)")
    if op.use_warmup.dim() != 2:
        raise ValueError(f"use_warmup must be [N, T], got "
                         f"{tuple(op.use_warmup.shape)}")
    n, steps = op.use_warmup.shape
    k, m = cfg.state_dim, cfg.action_dim
    if m != model.param_space.dim or k != len(model.state_metrics):
        raise ValueError(f"cfg (k {k}, m {m}) does not match the model's "
                         f"{len(model.state_metrics)} metrics and "
                         f"{model.param_space.dim} knobs")
    cs = layers.cell_size
    if n % cs:
        raise ValueError(f"experience sharing needs whole cells: {n} "
                         f"sessions is not a multiple of cell_size={cs}")
    windows = n // cs if layers.shared_replay else n
    shapes = [("warmup", op.warmup, (n, steps, m)),
              ("noise", op.noise, (n, steps, m)),
              ("w_vec", op.w_vec, (n, k)), ("lo", op.lo, (n, k)),
              ("span", op.span, (n, k)),
              ("state_vec", carry.state_vec, (n, k)),
              ("objective", carry.objective, (n,)),
              ("replay windows", carry.buffer.size, (windows,))]
    if layers.cells:
        if cells is None:
            raise ValueError("the cell body needs its CellInputs")
        shapes += [("avg_now", cells.avg_now, (n, steps)),
                   ("active", cells.active, (n, steps))]
    if layers.obs_mask is not None:
        shapes.append(("obs_mask", torch.empty(len(layers.obs_mask)), (k,)))
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
    device = carry.ddpg.flat.device
    if any(x.device != device for x in _tensors((op, cells))):
        raise ValueError(f"every operand must be on the learner's {device}")
    return n, steps


def _write_merged(window: BufferState, rows: tuple, keep,
                  cell_size: int) -> None:
    """The FIFO write of the sessions' transition ``rows`` (s, a, r, s2),
    IN PLACE, into windows ``[G, cap, ...]`` of ``cell_size`` sessions each
    (1: every session its own window; more: a cell's merged window under
    shared replay): every kept member of window g (``keep [N]``, sessions
    ``[g cs, (g + 1) cs)``) appends in session order, member j of the kept
    at slot ``(next[g] + j) % cap``, as ``BatchedReplayBuffer(groups=...).
    add`` appends them; a dropped write leaves its slot and cursor. Where a
    cell larger than its window brings two members to one slot, the later
    member keeps it, as appends one by one would.

    Written as a gather, each slot reading the member that writes it last,
    so no two writes meet: the result does not depend on the order in
    which a card runs the writes."""
    bs, ba, br, bs2, nxt, size = window
    g, cap = bs.shape[0], bs.shape[1]
    cs = int(cell_size)
    device = bs.device
    kept = keep.reshape(g, cs)
    n_kept = kept.long()
    offs = torch.cumsum(n_kept, 1) - 1          # rank among the kept
    wrote = n_kept.sum(1)                        # [G]
    lane_of = torch.zeros((g, cs + 1), dtype=torch.long, device=device)
    lanes = torch.arange(cs, device=device).expand(g, cs)
    lane_of.scatter_(1, torch.where(kept, offs, cs), lanes)  # cs: unused
    d = (torch.arange(cap, device=device)[None] - nxt.long()[:, None]) % cap
    hit = d < wrote[:, None]                     # [G, cap]
    last = d + cap * (torch.clamp(wrote[:, None] - 1 - d, min=0) // cap)
    writer = lane_of.gather(1, torch.clamp(last, max=cs))
    src = torch.arange(g, device=device)[:, None] * cs + writer
    for dst, v in zip((bs, ba, br, bs2), rows):
        h = hit.reshape(hit.shape + (1,) * (dst.dim() - 2))
        dst.copy_(torch.where(h, v[src], dst))
    nxt.copy_(((nxt.long() + wrote) % cap).to(nxt.dtype))
    size.copy_(torch.clamp(size.long() + wrote, max=cap).to(size.dtype))


def _cell_mean(ddpg, weight, fire, cell_size: int, floats: int) -> None:
    """The masked cell mean of the learners' first ``floats`` floats (the
    actor, critic and target sets; with the Adam moments, all of
    ``flat``), IN PLACE, in the cells whose first lane ``fire``s: each
    cell's lanes of ``weight`` True are summed in lane order and divided by
    their count (at least 1); a lane of weight False adds nothing, a
    non-finite value included. ``counts`` and ``step`` stay per
    session."""
    n = ddpg.flat.shape[0]
    cs = int(cell_size)
    g = n // cs
    x = ddpg.flat[:, :floats].reshape(g, cs, floats)
    w = weight.reshape(g, cs)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.where(w[:, 0, None], x[:, 0], zero)
    for j in range(1, cs):
        acc = acc + torch.where(w[:, j, None], x[:, j], zero)
    denom = torch.clamp(w.to(x.dtype).sum(1), min=1.0)
    mean = acc / denom[:, None]
    on = fire.reshape(g, cs)[:, 0]
    ddpg.flat[:, :floats] = torch.where(on[:, None, None], mean[:, None],
                                        x).reshape(n, floats)


def stepwise_episode(op, *, spec, policy=None, resilience=None,
                     obs_mask=None, sharing=None, cell_size: int = 1,
                     cells: Optional[CellInputs] = None):
    """N sessions' T-step episodes as a Python loop over the steps, every
    operation at ``[N, ...]``: the reference's per-step scan body
    (``_build_episode``) and its layers: the guarded step
    (``build_guarded_step``), the resilient step (``build_resilient_step``),
    the observation mask and the cell body (``_build_cell_episode``).

    ``op`` is a ``kernels.episode_learn.EpisodeOperands`` whose carry is an
    ``EpisodeCarry``; with ``policy`` a ``core.guardrails.GuardedCarry``
    (the sessions' ``GuardState`` as ``[N, ...]`` tensors), with
    ``resilience`` a ``core.resilience.ResilientCarry`` (their
    ``HealthState``). ``spec`` is an ``EpisodeKernelSpec`` whose model is
    any ``EnvModel`` over a quantized space (a ``FaultInjectedModel``
    included). Per step: the act (``fleet_act`` on the state, times
    ``obs_mask`` where given: an in-order fold on the card, so a session's
    bits do not depend on N; then the warmup or noise override), ONE
    ``model.step_draws`` and the model's step (three of them, sharing the
    draws, when guarded: ``guarded_transition``), the reward, the FIFO
    write and the learner (``fleet_learn_scan``: the threefry index draw,
    then one launch of the CUDA learner on the card, ``ddpg_learn_plain``
    on the CPU). The replay stores the masked state rows; the objective
    and the reward read the whole state.

    ``resilience``: a session whose metrics are not all finite drops its
    FIFO write and keeps its state and objective (the trace records the
    raw reading); after the learner, a non-finite reading, learner or loss
    resets the session to its snapshot (the step's entry learner under
    ``snapshot_every == 1``) or, past the policy's budgets, freezes it;
    then the snapshot cadence and the health byte (``core.resilience.
    health_update``). A window may then be empty: its sampled size is
    clamped to 1 and the update discarded by the reset.

    ``sharing`` with a cell mode runs cells of ``cell_size`` consecutive
    sessions; ``cells`` (``CellInputs``) brings the averaging cadence and
    the active lanes. Shared replay: the carry's window is the cells'
    merged windows ``[N / cell_size, cap, ...]`` with a cursor each, every
    contributing member appends in session order (``_write_merged``) and
    every member's learner samples its cell's whole window (gathered by
    ``fleet_learn_scan`` before the one launch). ``avg_every``: where
    ``avg_now`` fires, the masked cell mean of the actor, critic and target
    sets (with ``avg_opt_state`` the Adam moments too; ``_cell_mean``).
    With resilience a corrupted or degraded lane adds nothing to the
    window or the mean.

    The carry (with the guard or the health state) is updated IN PLACE,
    as the episode kernel updates it; returns the trace (``EpisodeTrace``,
    ``GuardedEpisodeTrace`` or ``ResilientEpisodeTrace``, of tensors ``[N,
    T, ...]``, restarts as int32 fixed point). The replay cursors and
    sizes stay on the device: no step reads them on the host."""
    from repro_torch import random as jrandom
    from repro_torch.core.action_mapping import coord_maps
    from repro_torch.core.ddpg import DDPGState, fleet_act, \
        fleet_learn_scan, state_layout

    layers = resolve_layers(policy, resilience, obs_mask, sharing,
                            cell_size)
    policy, rz = layers.policy, layers.resilience
    guard = health = None
    if policy is not None:
        from repro_torch.core.guardrails import guarded_transition
        carry, guard = op.carry.base, op.carry.guard
    elif rz is not None:
        from repro_torch.core.resilience import health_update, \
            tree_nonfinite_rows
        carry, health = op.carry.base, op.carry.health
    else:
        carry = op.carry
    n, steps = _check_stepwise(op, carry, spec, layers, cells)
    cfg, model = spec.cfg, spec.model
    device = carry.ddpg.flat.device
    params = type(model.params).from_vector(op.params)
    maps = coord_maps(model.param_space)
    layout = state_layout(cfg)
    actor = layout.offsets[1][0][0]
    bounds = (op.lo, op.span, op.w_vec)
    mask = None if layers.obs_mask is None else torch.tensor(
        layers.obs_mask, dtype=torch.float32, device=device)
    cs = layers.cell_size
    shared, averaging = layers.shared_replay, \
        layers.cells and layers.sharing.averaging
    if averaging:
        mean_floats = (layout.floats if layers.sharing.avg_opt_state
                       else layout.offsets[4][0][0])
    windows = torch.arange(n, device=device) // cs if shared else None
    every = torch.ones(n, dtype=torch.bool, device=device)
    window = carry.buffer
    ddpg = carry.ddpg
    learn = bool(spec.learn)
    updates = learn and spec.num_updates > 0
    env_state, state_vec, objective = carry.env_state, carry.state_vec, \
        carry.objective
    trace = _new_trace(n, steps, cfg, device, layers)
    for t in range(steps):
        with torch.no_grad():
            obs = state_vec if mask is None else state_vec * mask
            explored = torch.clamp(
                fleet_act(ddpg.flat[:, :actor], obs, cfg) + op.noise[:, t],
                0.0, 1.0)
            action = torch.where(op.use_warmup[:, t, None],
                                 torch.clamp(op.warmup[:, t], 0.0, 1.0),
                                 explored)
            key, draws = model.step_draws(model.key_of(env_state))
            live = model.with_key(env_state, key)
            if policy is not None:
                tr, guard, event, shadow = guarded_transition(
                    model, params, live, action, draws, objective, bounds,
                    guard, policy)
                trace.guard_events[:, t] = event
                trace.shadow_objectives[:, t] = shadow
            else:
                tr = plain_transition(model, params, live, action, draws,
                                      objective, bounds)
            keep, contrib = every, None  # the lanes that write
            if rz is not None:
                bad_obs = ~torch.isfinite(tr.metrics).all(-1)
                keep = ~bad_obs
            if layers.cells:
                contrib = cells.active[:, t]
                if rz is not None:
                    contrib = contrib & ~bad_obs & ~health.degraded
                if shared or rz is not None:
                    keep = contrib
            if learn:  # FIFO write, store before learn
                a_row, r_row, s2_row = tr.stored
                s_row = state_vec
                if mask is not None:
                    s_row, s2_row = state_vec * mask, s2_row * mask
                _write_merged(window, (s_row, a_row, r_row, s2_row), keep,
                              cs if shared else 1)
        if updates:
            entry = None
            if rz is not None and rz.snapshot_every == 1:
                entry = DDPGState(*(x.clone() for x in ddpg))
            pair = jrandom.split_keys(carry.learn_key, 2)
            carry.learn_key.copy_(pair[:, 0])
            sizes = window.size if windows is None else window.size[windows]
            if rz is not None:
                empty = sizes == 0
                sizes = torch.clamp(sizes, min=1)
            _, lmetrics = fleet_learn_scan(
                ddpg, window[:4], sizes, pair[:, 1], cfg, spec.num_updates,
                windows=windows, check_sizes=False)
        else:
            entry = ddpg
        with torch.no_grad():
            if rz is not None:
                bad = bad_obs
                if updates:
                    bad = bad | (~empty & tree_nonfinite_rows(
                        (ddpg.flat, lmetrics)))
            if averaging:
                weight = contrib if rz is None else contrib & ~bad
                _cell_mean(ddpg, weight, cells.avg_now[:, t], cs,
                           mean_floats)
            if rz is not None:
                kept, health, event = health_update(rz, health, bad, entry,
                                                    ddpg)
                for dst, src in zip(ddpg, kept):
                    dst.copy_(src)
                trace.health_events[:, t] = event
            trace.action_idx[:, t] = torch.stack(
                [maps[j](tr.committed[:, j])["idx"]
                 for j in range(cfg.action_dim)], dim=-1).to(torch.int32)
            trace.metrics[:, t] = tr.metrics
            trace.rewards[:, t] = tr.reward
            trace.objectives[:, t] = tr.objective
            trace.restarts[:, t] = _encode_restart(tr.restart)
            env_state = tr.env_state
            if rz is None:
                state_vec, objective = tr.norm, tr.objective
            else:  # a corrupted reading never becomes the state
                state_vec = torch.where(bad_obs[:, None], state_vec, tr.norm)
                objective = torch.where(bad_obs, objective, tr.objective)
    for dst, src in zip(_tensors(carry.env_state), _tensors(env_state)):
        dst.copy_(src)
    carry.state_vec.copy_(state_vec)
    carry.objective.copy_(objective)
    if policy is not None:
        for dst, src in zip(op.carry.guard, guard):
            dst.copy_(src)
    if rz is not None:
        for dst, src in zip(_tensors(op.carry.health), _tensors(health)):
            dst.copy_(src)
    return trace


def run_episode_scan(env, agent, scalarizer, cur_metrics: dict, steps: int,
                     learn: bool = True, policy=None, guard=None,
                     obs_mask=None, resilience=None, health=None):
    """Run ``steps`` tuning iterations of one session in one episode call.

    ``env`` must be a ``ModelEnv`` on the agent's device. Mutates ``env``
    (model state), ``agent`` (learner state, key, buffer, noise stream,
    steps_taken) exactly as the host loop would and returns the per-step
    trace as numpy (``EpisodeTrace``, restarts in seconds). With no layer
    the episode is ONE call of the episode kernel (a ``LustreSimModel``
    env).

    Each layer runs the per-step body (``stepwise_episode``: one learner
    launch a step) instead. ``policy`` (``core.guardrails.
    DeploymentPolicy``) runs the guarded shadow/canary body; ``guard`` must
    then be the session's ``GuardState`` (``init_guard_state`` for a fresh
    session) and the return value becomes ``(GuardedEpisodeTrace,
    GuardState)``: the updated guard carries to the next progressive run.
    ``resilience`` (``core.resilience.ResiliencePolicy``) runs the
    self-healing body; ``health`` must then be the session's
    ``HealthState`` (``init_health_state`` for a fresh session) and the
    return value becomes ``(ResilientEpisodeTrace, HealthState)``; a
    fully-off policy normalizes to ``None``. ``obs_mask`` (0/1 floats over
    the state metrics) masks the learner's view. ``policy`` beside
    ``obs_mask`` or ``resilience`` raises the reference's ``ValueError``."""
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.kernels import ops
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   EpisodeOperands)

    layers = resolve_layers(policy, resilience, obs_mask)
    if policy is not None and guard is None:
        raise ValueError("guarded runs need a GuardState (core.guardrails."
                         "init_guard_state seeded from the live config)")
    if layers.resilience is not None and health is None:
        raise ValueError("resilient runs need a HealthState (core."
                         "resilience.init_health_state seeded from the "
                         "learner state)")
    device = agent.device
    if env.device != device:
        raise ValueError(f"env runs on {env.device}, the agent on {device}")
    model = env.model

    def one(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=device).unsqueeze(0).contiguous()

    lo, span = metric_bounds(env.metric_specs, env.state_metrics)
    w_vec = scalarizer.weight_vector(env.state_metrics)
    state_vec = normalize_state(cur_metrics, env.metric_specs,
                                env.state_metrics)
    objective = np.float32(scalarizer.objective(cur_metrics))
    use_warmup, warmup, noise = _consume_exploration(agent, steps)

    (bs, ba, br, bs2), size = agent.buffer.storage()
    buffer = BufferState(
        *(b.unsqueeze(0).clone() for b in (bs, ba, br, bs2)),
        next_slot=one(agent.buffer._next, torch.int32),
        size=one(size, torch.int32))
    env_state = tree_map(lambda x: x.unsqueeze(0).clone(), env.model_state)
    st = agent.state
    ddpg = DDPGState(st.flat.unsqueeze(0), st.counts.unsqueeze(0),
                     st.step.unsqueeze(0))
    carry = EpisodeCarry(env_state, ddpg, buffer,
                         agent._learn_key.to(device).unsqueeze(0).clone(),
                         one(state_vec), one(objective))
    op = EpisodeOperands(
        use_warmup=one(use_warmup, torch.bool), warmup=one(warmup),
        noise=one(noise), w_vec=one(w_vec), lo=one(lo), span=one(span),
        params=env.params.vector().unsqueeze(0).contiguous(), carry=carry)
    spec = EpisodeKernelSpec(model=model, cfg=agent.cfg, learn=learn,
                             num_updates=agent.cfg.updates_per_step)
    if not layers.stepwise:
        trace = ops.episode_inner_loop(op, spec=spec)
    elif policy is not None:
        from repro_torch.core.guardrails import GuardedCarry, \
            guard_to_torch, stack_guards
        guard = guard_to_torch(stack_guards([guard]), device)
        trace = stepwise_episode(
            op._replace(carry=GuardedCarry(base=carry, guard=guard)),
            spec=spec, policy=policy)
    elif layers.resilience is not None:
        from repro_torch.core.resilience import ResilientCarry, \
            health_to_torch, stack_health
        health = health_to_torch(stack_health([health]), device)
        trace = stepwise_episode(
            op._replace(carry=ResilientCarry(base=carry, health=health)),
            spec=spec, resilience=layers.resilience,
            obs_mask=layers.obs_mask)
    else:
        trace = stepwise_episode(op, spec=spec, obs_mask=layers.obs_mask)

    # write the carried state back (the learner was updated in place)
    env.model_state = tree_map(lambda x: x[0], carry.env_state)
    agent._learn_key = carry.learn_key[0].cpu()
    if learn:
        agent.buffer.set_storage(*(b[0] for b in carry.buffer[:4]),
                                 int(carry.buffer.next_slot[0]),
                                 int(carry.buffer.size[0]))
    out = _decode_trace(type(trace)(*(x[0] for x in trace)))
    if policy is not None:
        from repro_torch.core.guardrails import guard_row, guard_to_numpy
        return out, guard_row(guard_to_numpy(guard), 0)
    if layers.resilience is not None:
        from repro_torch.core.resilience import health_row, health_to_numpy
        return out, health_row(health_to_numpy(health), 0)
    return out


# ---------------------------------------------------------------------------
# Streaming chunked fleet runtime
# ---------------------------------------------------------------------------

#: stats of the most recent ``run_fleet_episode_scan`` call
_LAST_FLEET_STATS: dict = {}


def last_fleet_run_stats() -> dict:
    """Measurement record of the most recent fleet episode run.

    Keys: ``sessions``, ``chunk``, ``num_chunks``, ``overlap`` (whether the
    chunks streamed on copy streams beside the compute stream),
    ``padded_sessions`` (always 0: a launch takes any number of sessions,
    so the last chunk runs at its own width), ``peak_device_bytes``
    (``live_device_bytes`` sampled while each chunk's operands, and then its
    results, are live: a measured lower bound of the chunked runtime's
    footprint), ``launch_device_seconds`` (per chunk, the pre-draw and the
    kernel launch on the compute stream, by CUDA events; empty on the CPU),
    ``prepare_seconds`` (the host gathering the fleet's state and drawing
    its exploration), ``finish_seconds`` (decoding the trace and writing
    the state back) and ``staging``, the stream's measurements from
    ``stream_chunks``."""
    return dict(_LAST_FLEET_STATS)


def live_device_bytes() -> int:
    """Bytes in live tensors on the current card
    (``torch.cuda.memory_allocated``); 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


def resolve_chunk(n: int, chunk: Optional[int]) -> int:
    """Effective chunk size: ``chunk`` (default: the whole fleet), capped at
    ``n``. The last chunk holds the ragged remainder and runs at its own
    width. (The reference's rounding to a device-count multiple belongs to
    a fleet across several cards, ROADMAP item A11d.)"""
    c = int(chunk) if chunk is not None else int(n)
    if c <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return min(c, int(n))


def _tensors(tree) -> list:
    """The tensors of a nest of tuples (``NamedTuple``s included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    return []


def stream_chunks(call, stage, drain, num_chunks: int, overlap: bool = True,
                  supervisor=None, chaos=None,
                  staging: Optional[dict] = None, device=None):
    """Drive the chunked episode pipeline.

    ``stage(ci)`` copies chunk ``ci``'s operands to ``device`` (from
    page-locked host tensors, without waiting) and returns them;
    ``call(args)`` runs the episode on them on the current stream and
    returns what ``drain`` takes; ``drain(ci, out)`` enqueues the copies of
    chunk ``ci``'s results back into the host tensors.

    ``overlap=False``, a CPU ``device`` or a ``supervisor``: stage, call,
    drain one chunk at a time on one stream, waiting for the copies back
    before the next chunk.

    ``overlap=True`` on a card: chunk k+1 is staged on a host-to-device
    copy stream while chunk k computes, and chunk k-1 drains on a
    device-to-host stream. The compute stream waits on the staged chunk's
    event; the drain stream waits on the computed chunk's event; every
    tensor used on a stream other than the one it was made on is marked
    for that stream (``record_stream``), so the caching allocator does not
    hand its memory out while the other stream still reads it; the host
    waits on the drain's event before anything reads the host tensors.
    The same calls run on the same operands in the same order on the
    compute stream, so the results are bitwise those of the serial
    schedule.

    ``supervisor`` (a ``core.resilience.ChunkSupervisor``) runs the stream
    under host supervision: serially (the schedule is pure scheduling, so
    the results are unchanged), each chunk retried with exponential
    backoff. The host tensors change only in a drain, after the chunk's
    call has run, so a failed attempt leaves the chunk's inputs as they
    were and ``stage(ci)`` stages them again: retries are bitwise invisible
    on success. A chunk over ``watchdog_seconds`` of wall clock counts as a
    stall. After ``max_retries`` the chunk raises ``ChunkFailure``
    (``on_failure="raise"``) or is skipped with its host state untouched
    (``"skip"``: the quarantine path). ``chaos`` (an object with
    ``before_chunk(ci, attempt)``, such as ``envs.faults.HostChaos``)
    injects failures and stalls ahead of each staged attempt and needs a
    supervisor. Returns the supervisor's stats (``retries``,
    ``watchdog_trips``, ``failed_chunks``, ``chunk_seconds``) when
    supervised, else ``None``.

    ``staging`` (a dict) receives ``async`` (whether copy streams ran),
    ``stage_seconds`` (host time spent enqueuing the stagings),
    ``stage_wait_seconds`` (host time blocked on a staged chunk: all of the
    staging when serial, none when the copy stream runs it),
    ``drain_seconds`` (host time in the drains, waiting on their copies
    included) and ``overlap_efficiency`` (1 - wait / stage)."""
    if chaos is not None and supervisor is None:
        raise ValueError("host chaos injection needs a ChunkSupervisor "
                         "(unsupervised streams have no retry path)")
    st = staging if staging is not None else {}
    st.update(**{"async": False, "stage_seconds": 0.0,
                 "stage_wait_seconds": 0.0, "drain_seconds": 0.0,
                 "overlap_efficiency": 0.0})
    if supervisor is not None:
        from repro_torch.core.resilience import ChunkFailure, \
            normalize_supervisor
        supervisor = normalize_supervisor(supervisor)
    stats = {"retries": 0, "watchdog_trips": 0, "failed_chunks": [],
             "chunk_seconds": []}
    if num_chunks <= 0:
        return None if supervisor is None else stats
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    cuda = device.type == "cuda"

    def wait_host():
        if cuda:
            event = torch.cuda.current_stream(device).record_event()
            event.synchronize()

    if overlap and cuda and supervisor is None:
        st["async"] = True
        compute = torch.cuda.current_stream(device)
        h2d, d2h = torch.cuda.Stream(device), torch.cuda.Stream(device)

        def staged(ci):
            t0 = time.perf_counter()
            with torch.cuda.stream(h2d):
                args = stage(ci)
                event = h2d.record_event()
            st["stage_seconds"] += time.perf_counter() - t0
            return args, event

        def drained(ci, out, done):
            t0 = time.perf_counter()
            d2h.wait_event(done)
            for t in _tensors(out):
                t.record_stream(d2h)
            with torch.cuda.stream(d2h):
                drain(ci, out)
                event = d2h.record_event()
            event.synchronize()
            st["drain_seconds"] += time.perf_counter() - t0

        pending, inflight = staged(0), None
        for ci in range(num_chunks):
            args, ready = pending
            compute.wait_event(ready)
            for t in _tensors(args):
                t.record_stream(compute)
            out = call(args)
            done = compute.record_event()
            args = pending = None
            if ci + 1 < num_chunks:
                pending = staged(ci + 1)
            if inflight is not None:
                drained(*inflight)
            inflight = (ci, out, done)
        drained(*inflight)
    else:
        for ci in range(num_chunks):
            attempt = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if chaos is not None:
                        chaos.before_chunk(ci, attempt)
                    args = stage(ci)
                    st["stage_seconds"] += time.perf_counter() - t0
                    out = call(args)
                    args = None
                    t1 = time.perf_counter()
                    drain(ci, out)
                    wait_host()
                    st["drain_seconds"] += time.perf_counter() - t1
                except Exception as err:  # noqa: BLE001 - retry any fault
                    if supervisor is None:
                        raise
                    if attempt >= supervisor.max_retries:
                        stats["failed_chunks"].append(ci)
                        if supervisor.on_failure == "skip":
                            break  # quarantine: host state untouched
                        raise ChunkFailure(ci, attempt + 1, err) from err
                    time.sleep(supervisor.backoff_seconds
                               * supervisor.backoff_multiplier ** attempt)
                    attempt += 1
                    stats["retries"] += 1
                    continue
                elapsed = time.perf_counter() - t0
                stats["chunk_seconds"].append(elapsed)
                if supervisor is not None and \
                        supervisor.watchdog_seconds is not None and \
                        elapsed > supervisor.watchdog_seconds:
                    stats["watchdog_trips"] += 1
                break
        st["stage_wait_seconds"] = st["stage_seconds"]
    if st["stage_seconds"] > 0.0:
        st["overlap_efficiency"] = max(
            0.0, 1.0 - st["stage_wait_seconds"] / st["stage_seconds"])
    return None if supervisor is None else stats


def _host_copy(x, pin: bool, dtype=None) -> torch.Tensor:
    """A new contiguous CPU tensor holding ``x``, page-locked if ``pin``."""
    if isinstance(x, np.ndarray):
        x = np.array(x)  # a writable copy (broadcast views are read-only)
    t = torch.as_tensor(x, dtype=dtype)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    out.copy_(t)
    return out


def _host_state(x: torch.Tensor, pin: bool) -> tuple:
    """The host tensor the fleet streams ``x`` through: ``x`` itself where
    it already is one (a host-store agent's state, written in place), else a
    new copy; and whether it is a copy (to be written back)."""
    if x.device.type == "cpu" and x.is_contiguous() and \
            (x.is_pinned() or not pin):
        return x, False
    return _host_copy(x, pin), True


def _stacked(tensors: Sequence, pin: bool) -> torch.Tensor:
    """``torch.stack(tensors)`` on the host, page-locked if ``pin``."""
    first = tensors[0]
    out = torch.empty((len(tensors), *first.shape), dtype=first.dtype,
                      pin_memory=pin)
    if first.device.type == "cpu":
        return torch.stack(list(tensors), out=out)
    return out.copy_(torch.stack(list(tensors)))


def check_fleet_envs(envs: Sequence, device) -> None:
    """Raise unless ``envs`` share one env model structure and all run on
    ``device``: what one launch of the episode kernel can take."""
    if len({e.model.step_fn for e in envs}) != 1:
        raise ValueError(
            "fleet sessions must share one env model structure (same space "
            "and model class); mixed fleets need the host engine")
    for e in envs:
        if e.device != device:
            raise ValueError(f"an env runs on {e.device}, the fleet on "
                             f"{device}")


def stream_fleet_episode(envs: Sequence, scalarizers: Sequence,
                         cur_metrics: Sequence, exploration: Sequence,
                         ddpg, buffer: BufferState,
                         learn_keys: torch.Tensor, *, cfg, steps: int,
                         learn: bool = True, chunk: Optional[int] = None,
                         overlap: bool = True, device=None, policy=None,
                         guard=None, resilience=None, health=None,
                         obs_mask=None, sharing=None, cell_size: int = 1,
                         cells=None, supervisor=None, chaos=None,
                         primary=None) -> tuple:
    """The chunk machinery of the fleet episode, for any fleet of sessions
    of one env model structure: ``FleetTuner``'s (``run_fleet_episode_scan``)
    and ``FleetService``'s, whose sessions differ in age.

    The caller has checked ``envs`` with ``check_fleet_envs``. Per session
    ``i``: ``exploration[i]`` is its pre-drawn (use_warmup,
    warmup, noise) (``draw_exploration`` at its own age), ``ddpg`` (a
    ``DDPGState``), ``buffer`` (the windows and their own cursors
    ``next_slot``, ``size``) and ``learn_keys`` hold its state in host
    tensors with a leading ``[N]`` axis (page-locked on a card). The
    sessions run in ``ceil(N / chunk)`` chunks, one call each, the ragged
    last chunk at its own width; each chunk is staged to ``device``, run
    and drained back through ``stream_chunks``. With no layer a call is
    one launch of the episode kernel (``kernels.ops.episode_inner_loop``);
    with any layer it is the per-step body (``stepwise_episode``). The host
    tensors are written IN PLACE, and each env's model state (a nest of
    tensors) is gathered from and written back to its env (only the
    ``primary`` rows' where given: a service's vacant cell seats replicate
    a live member, whose env they must not overwrite).

    The layers: ``policy`` with ``guard`` (a ``GuardState`` of host tensors
    ``[N, ...]``), ``resilience`` with ``health`` (a ``HealthState`` of
    host tensors ``[N, ...]``), both staged and drained with the rest;
    ``obs_mask``; ``sharing`` with ``cell_size`` and ``cells`` (the host
    ``[N, T]`` bool arrays ``(avg_now, active)`` of ``CellInputs``), whose
    cells of ``cell_size`` consecutive sessions never span chunks (the
    chunk must be a multiple of the cell size); under shared replay
    ``buffer`` holds the cells' merged windows, ``[N / cell_size, ...]``,
    staged and drained cell by cell. ``supervisor`` and ``chaos`` put the
    chunk stream under host supervision (``stream_chunks``); a skipped
    chunk's host state and trace rows stay as they were.

    Returns (trace, stats): the decoded host trace (``[N, T, ...]`` numpy,
    restarts in seconds; a ``GuardedEpisodeTrace`` when guarded, a
    ``ResilientEpisodeTrace`` when resilient), and ``sessions``,
    ``chunk``, ``num_chunks``, ``overlap``, ``padded_sessions`` (0),
    ``peak_device_bytes``, ``launch_device_seconds`` (CUDA events around
    each call; empty on the CPU), ``prepare_seconds``, ``finish_seconds``,
    ``staging`` (see ``last_fleet_run_stats``) and, when supervised,
    ``supervisor`` (``stream_chunks``'s stats)."""
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.kernels import ops
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   EpisodeOperands)

    t_prep = time.perf_counter()
    device = torch.device(device)
    layers = resolve_layers(policy, resilience, obs_mask, sharing,
                            cell_size)
    if policy is not None:
        from repro_torch.core.guardrails import GuardedCarry, GuardState
        if guard is None:
            raise ValueError("guarded fleet runs need a stacked GuardState "
                             "(core.guardrails.init_fleet_guard_state)")
    if layers.resilience is not None:
        from repro_torch.core.resilience import ResilientCarry
        if health is None:
            raise ValueError("resilient fleet runs need a stacked "
                             "HealthState (core.resilience."
                             "init_fleet_health_state)")
    n = len(envs)
    c = resolve_chunk(n, chunk)
    cs = layers.cell_size
    if n % cs or c % cs:
        raise ValueError(f"cells of {cs} sessions need whole cells in the "
                         f"fleet ({n}) and in every chunk ({c})")
    if layers.cells and cells is None:
        raise ValueError("the cell body needs (avg_now, active)")
    num_chunks = -(-n // c)
    pin = device.type == "cuda"
    k, m = cfg.state_dim, cfg.action_dim

    env_state = tree_map(lambda *xs: _stacked(xs, pin),
                         *(e.model_state for e in envs))
    lo, span = metric_bounds(envs[0].metric_specs, envs[0].state_metrics)
    w_vec = np.stack([sc.weight_vector(e.state_metrics)
                      for sc, e in zip(scalarizers, envs)])
    state_vecs = np.stack([
        normalize_state(mtr, e.metric_specs, e.state_metrics)
        for mtr, e in zip(cur_metrics, envs)])
    objectives = np.array([np.float32(sc.objective(mtr))
                           for sc, mtr in zip(scalarizers, cur_metrics)],
                          np.float32)
    f32 = torch.float32
    operands = dict(
        use_warmup=_host_copy(np.stack([x[0] for x in exploration]), pin),
        warmup=_host_copy(np.stack([x[1] for x in exploration]), pin),
        noise=_host_copy(np.stack([x[2] for x in exploration]), pin),
        w_vec=_host_copy(w_vec, pin, f32),
        lo=_host_copy(np.broadcast_to(lo, (n, k)), pin, f32),
        span=_host_copy(np.broadcast_to(span, (n, k)), pin, f32),
        params=_stacked([e.params.vector() for e in envs], pin))
    if layers.cells:
        cells = tuple(_host_copy(np.asarray(x, bool), pin) for x in cells)
    state_vecs = _host_copy(state_vecs, pin, f32)
    objectives = _host_copy(objectives, pin, f32)
    out = _new_trace(n, steps, cfg, "cpu", layers)
    if pin:
        out = type(out)(*(x.pin_memory() for x in out))
    spec = EpisodeKernelSpec(model=envs[0].model, cfg=cfg, learn=learn,
                             num_updates=cfg.updates_per_step)
    prepare_seconds = time.perf_counter() - t_prep

    peak = [live_device_bytes()]
    events = []

    def spans(ci):
        a, b = ci * c, min(n, (ci + 1) * c)
        return (a, b), ((a // cs, b // cs) if layers.shared_replay
                        else (a, b))

    def stage(ci):
        (a, b), (wa, wb) = spans(ci)

        def dev(x, lo_=a, hi=b):
            part = x[lo_:hi]
            return torch.empty(part.shape, dtype=part.dtype,
                               device=device).copy_(part, non_blocking=True)

        carry = EpisodeCarry(
            env_state=tree_map(dev, env_state),
            ddpg=DDPGState(*(dev(x) for x in ddpg)),
            buffer=BufferState(*(dev(x, wa, wb) for x in buffer)),
            learn_key=dev(learn_keys), state_vec=dev(state_vecs),
            objective=dev(objectives))
        if policy is not None:
            carry = GuardedCarry(base=carry,
                                 guard=GuardState(*(dev(x) for x in guard)))
        elif layers.resilience is not None:
            carry = ResilientCarry(base=carry,
                                   health=tree_map(dev, health))
        args = EpisodeOperands(**{name: dev(x)
                                  for name, x in operands.items()},
                               carry=carry)
        staged_cells = None
        if layers.cells:
            staged_cells = CellInputs(*(dev(x) for x in cells))
        peak[0] = max(peak[0], live_device_bytes())
        return args, staged_cells

    def call(staged):
        args, staged_cells = staged
        if pin:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        if layers.stepwise:
            trace = stepwise_episode(
                args, spec=spec, policy=policy,
                resilience=layers.resilience, obs_mask=layers.obs_mask,
                sharing=layers.sharing, cell_size=cs, cells=staged_cells)
        else:
            trace = ops.episode_inner_loop(args, spec=spec)
        if pin:
            end.record()
            events.append((begin, end))
        return args.carry, trace

    def drain(ci, result):
        (a, b), (wa, wb) = spans(ci)
        carry, trace = result
        peak[0] = max(peak[0], live_device_bytes())
        pairs = [(x, y, a, b) for x, y in zip(out, trace)]
        if policy is not None:
            pairs += [(x, y, a, b) for x, y in zip(guard, carry.guard)]
            carry = carry.base
        elif layers.resilience is not None:
            pairs += [(x, y, a, b) for x, y in
                      zip(_tensors(health), _tensors(carry.health))]
            carry = carry.base
        pairs += [(x, y, a, b) for x, y in
                  [*zip(_tensors(env_state), _tensors(carry.env_state)),
                   *zip(ddpg, carry.ddpg), (learn_keys, carry.learn_key)]]
        pairs += [(x, y, wa, wb) for x, y in zip(buffer, carry.buffer)]
        for dst, src, lo_, hi in pairs:
            dst[lo_:hi].copy_(src, non_blocking=True)

    staging: dict = {}
    supervised = stream_chunks(call, stage, drain, num_chunks,
                               overlap=overlap, supervisor=supervisor,
                               chaos=chaos, staging=staging, device=device)

    t_finish = time.perf_counter()
    dev_env = tree_map(lambda x: x.to(device), env_state)
    for i, e in enumerate(envs):
        if primary is None or primary[i]:
            e.model_state = tree_map(lambda x: x[i], dev_env)
    trace = _decode_trace(out)
    stats = dict(
        sessions=n, chunk=c, num_chunks=num_chunks, overlap=overlap,
        padded_sessions=0, peak_device_bytes=peak[0],
        launch_device_seconds=[b.elapsed_time(e) / 1e3 for b, e in events],
        prepare_seconds=prepare_seconds,
        finish_seconds=time.perf_counter() - t_finish, staging=staging,
        cell_size=cs, sharing=layers.sharing)
    if supervised is not None:
        stats["supervisor"] = supervised
    return trace, stats


def run_fleet_episode_scan(envs: Sequence, agent, scalarizers: Sequence,
                           cur_metrics: Sequence, steps: int,
                           learn: bool = True,
                           devices: Optional[Sequence] = None,
                           chunk: Optional[int] = None, overlap: bool = True,
                           policy=None, guard=None, sharing=None,
                           cell_size: int = 1, obs_mask=None,
                           resilience=None, health=None, supervisor=None,
                           chaos=None):
    """N sessions' episodes streamed chunk by chunk. Trace leaves are
    ``[N, T, ...]`` host numpy arrays (restarts in seconds).

    The fleet's state (learners, replay windows and cursors, env states,
    learner keys) stays in host tensors (page-locked on a card) between
    chunks. ``chunk=C`` runs ``ceil(N / C)`` chunks (default: one chunk of
    all N, the monolithic schedule); each chunk's sessions are staged into
    ``EpisodeOperands`` with a leading ``[C]`` axis and run in ONE launch
    of the episode kernel (``kernels.ops.episode_inner_loop``: its plain
    version on the CPU), then the chunk's trace and carry are copied back
    (``stream_fleet_episode``). A launch takes any number of sessions, so
    the ragged last chunk runs at its own width: nothing is padded. On the
    card every session is one block of the kernel, so each session's
    results are the same bits whatever the chunk; the plain version on the
    CPU is batched PyTorch, whose products may round differently at
    different widths.

    The fleet is one age: every session's exploration is drawn at the
    agent's shared ``steps_taken``. Each session's replay cursor is its
    own (``BatchedReplayBuffer.cursors``); they stay in lockstep unless a
    resilient run drops some sessions' writes.

    ``overlap=True`` streams the chunks on copy streams beside the compute
    stream (``stream_chunks``), bitwise the serial schedule.

    The layers run the per-step body (``stepwise_episode``, one learner
    launch a step per chunk). ``policy``/``guard``: the guarded
    shadow/canary body, ``guard`` a stacked ``[N, ...]`` numpy
    ``GuardState`` (``init_fleet_guard_state``), and the return value
    becomes ``(GuardedEpisodeTrace, GuardState)``. ``resilience``/
    ``health``: the self-healing body, ``health`` a stacked ``HealthState``
    (``init_fleet_health_state``), and the return value becomes
    ``(ResilientEpisodeTrace, HealthState)``. ``obs_mask``: the learners'
    masked view. ``sharing``/``cell_size``: sessions ``[i cs, (i + 1) cs)``
    form cell i; cells never span chunks, so the chunk is rounded up to a
    whole number of cells; with shared replay the agent's buffer must be
    grouped (``FleetAgent(..., replay_groups=...)``) and its cells'
    windows are staged and drained cell by cell. The averaging cadence
    fires on the fleet's step clock. ``supervisor``/``chaos``: the chunk
    stream under host supervision; its stats land in
    ``last_fleet_run_stats()["supervisor"]``. ``policy`` beside
    ``sharing``, ``obs_mask`` or ``resilience`` raises the reference's
    ``ValueError``.

    ``devices`` may name one card (the agent's); more than one is ROADMAP
    item A11d."""
    from repro_torch.core.ddpg import DDPGState

    layers = resolve_layers(policy, resilience, obs_mask, sharing,
                            cell_size)
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "a fleet episode across several cards is ROADMAP item A11d; "
            "pass one device")
    if policy is not None and guard is None:
        raise ValueError("guarded fleet runs need a stacked GuardState "
                         "(core.guardrails.init_fleet_guard_state)")
    if layers.resilience is not None and health is None:
        raise ValueError("resilient fleet runs need a stacked HealthState "
                         "(core.resilience.init_fleet_health_state)")
    t_prep = time.perf_counter()
    check_fleet_envs(envs, agent.device)
    n = len(envs)
    cs = layers.cell_size
    c = resolve_chunk(n, chunk)
    if layers.cells:
        if n % cs:
            raise ValueError(
                f"experience sharing needs whole cells: {n} sessions is not "
                f"a multiple of cell_size={cs}")
        c = -(-c // cs) * cs  # cells never span chunks
    if layers.shared_replay and agent.buffer.groups is None:
        raise ValueError("shared replay needs a grouped BatchedReplayBuffer "
                         "(FleetAgent(..., replay_groups=...))")
    pin = agent.device.type == "cuda"
    learner = [_host_state(x, pin) for x in agent.states]
    if layers.shared_replay:
        (bs, ba, br, bs2), _, _ = agent.buffer.grouped_storage()
    else:
        (bs, ba, br, bs2), _ = agent.buffer.storage()
    window = [_host_state(x, pin) for x in (bs, ba, br, bs2)]
    buffer = BufferState(
        *(x for x, _ in window),
        *(_host_copy(x, pin) for x in agent.buffer.cursors()))
    learn_keys = _host_copy(agent._learn_keys, pin)
    s0 = agent.steps_taken
    xs = [_consume_exploration(agent, steps, session=i) for i in range(n)]
    agent.steps_taken += steps
    cells = None
    if layers.cells:
        avg_now = np.zeros((n, steps), bool)
        if layers.sharing.averaging:
            every = layers.sharing.avg_every
            avg_now[:] = ((s0 + np.arange(steps) + 1) % every) == 0
        cells = (avg_now, np.ones((n, steps), bool))
    if policy is not None:
        from repro_torch.core.guardrails import guard_to_numpy, \
            guard_to_torch
        guard = guard_to_torch(guard, pin=pin)
    if layers.resilience is not None:
        from repro_torch.core.resilience import health_to_numpy, \
            health_to_torch
        health = health_to_torch(health, pin=pin)
    gathered = time.perf_counter() - t_prep

    trace, stats = stream_fleet_episode(
        envs, scalarizers, cur_metrics, xs,
        DDPGState(*(x for x, _ in learner)), buffer, learn_keys,
        cfg=agent.cfg, steps=steps, learn=learn, chunk=c,
        overlap=overlap, device=agent.device, policy=policy, guard=guard,
        resilience=layers.resilience, health=health,
        obs_mask=layers.obs_mask, sharing=layers.sharing, cell_size=cs,
        cells=cells, supervisor=supervisor, chaos=chaos)

    t_finish = time.perf_counter()
    for (x, copied), dst in zip(learner, agent.states):
        if copied:
            dst.copy_(x)
    agent._learn_keys = learn_keys
    if learn:
        agent.buffer.set_storage(*buffer)
    stats["prepare_seconds"] += gathered
    stats["finish_seconds"] += time.perf_counter() - t_finish
    _LAST_FLEET_STATS.clear()
    _LAST_FLEET_STATS.update(stats)
    if policy is not None:
        return trace, guard_to_numpy(guard)
    if layers.resilience is not None:
        return trace, health_to_numpy(health)
    return trace


def precompile_fleet_episode(env, agent, steps: int, sessions: int,
                             chunk: Optional[int] = None,
                             devices: Optional[Sequence] = None,
                             learn: bool = True, policy=None,
                             stepwise: bool = False):
    """Build and load the library this fleet's episodes launch
    (``kernels/build.py``) ahead of ``run()``, after checking that the
    configuration fits it, without touching any tuning state: the episode
    kernel's (the model, the widths, its shared-memory plan), or with a
    ``policy`` or any other layer (``stepwise``) the learner kernel's,
    which the per-step body launches once a step. Returns the loaded
    library on a card and ``None`` on the CPU, where the plain versions
    need no build. More than one device is ROADMAP item A11d."""
    from repro_torch.kernels import build
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   _check_model,
                                                   check_smem_fit)

    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "a fleet episode across several cards is ROADMAP item A11d; "
            "pass one device")
    resolve_chunk(sessions, chunk)
    if policy is not None or stepwise:
        from repro_torch.kernels import ddpg_learn
        ddpg_learn.check_smem_fit(agent.cfg)
        name = "ddpg_learn"
    else:
        _check_model(EpisodeKernelSpec(env.model, agent.cfg, learn,
                                       agent.cfg.updates_per_step))
        check_smem_fit(agent.cfg, agent.buffer.capacity,
                       env.model.n_samples)
        name = "episode_learn"
    if agent.device.type != "cuda":
        return None
    return build.load(name)
