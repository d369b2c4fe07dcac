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
what the deployment guardrails are written on: ``policy`` (a
``core.guardrails.DeploymentPolicy``) runs every chunk through it with the
guarded transition; ``policy=None`` runs the episode kernel as before.
The resilient, masked and shared bodies are ROADMAP item A10b.
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


def _refuse_layers(caller: str, **layers) -> None:
    """Raise for any policy layer that was asked for: the resilient,
    masked, shared and supervised bodies are ROADMAP item A10b."""
    for name, value in layers.items():
        if value is not None:
            raise NotImplementedError(
                f"{caller}({name}=...) belongs to the resilient, masked, "
                f"shared or supervised episode body, ROADMAP item A10b, not "
                f"yet in repro_torch")


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


def _decode_trace(trace):
    """Device trace -> host numpy (its own trace type), restart fixed point
    decoded to seconds."""
    host = type(trace)(*(x.cpu().numpy() for x in trace))
    return host._replace(restarts=decode_restarts(host.restarts))


def _new_trace(n: int, steps: int, cfg, device, guarded: bool):
    """A zero trace of N sessions' T steps, as the episode kernel writes
    it; with the decision trail when ``guarded``."""
    from repro_torch.kernels.episode_learn import _empty_trace

    trace = _empty_trace(n, steps, cfg, device)
    if not guarded:
        return trace
    from repro_torch.core.guardrails import GuardedEpisodeTrace
    return GuardedEpisodeTrace(
        *trace, guard_events=torch.zeros((n, steps), dtype=torch.uint8,
                                         device=device),
        shadow_objectives=torch.zeros((n, steps), device=device))


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


def _check_stepwise(op, carry: EpisodeCarry, spec) -> tuple:
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
    for name, x, shape in (("warmup", op.warmup, (n, steps, m)),
                           ("noise", op.noise, (n, steps, m)),
                           ("w_vec", op.w_vec, (n, k)), ("lo", op.lo, (n, k)),
                           ("span", op.span, (n, k)),
                           ("state_vec", carry.state_vec, (n, k)),
                           ("objective", carry.objective, (n,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
    device = carry.ddpg.flat.device
    if any(x.device != device for x in _tensors(op)):
        raise ValueError(f"every operand must be on the learner's {device}")
    return n, steps


def stepwise_episode(op, *, spec, policy=None):
    """N sessions' T-step episodes as a Python loop over the steps, every
    operation at ``[N, ...]``: the reference's per-step scan body
    (``_build_episode``), and with ``policy`` its guarded form
    (``build_guarded_step``).

    ``op`` is a ``kernels.episode_learn.EpisodeOperands`` whose carry is an
    ``EpisodeCarry``, or with ``policy`` a ``core.guardrails.GuardedCarry``
    (the sessions' ``GuardState`` as ``[N, ...]`` tensors); ``spec`` an
    ``EpisodeKernelSpec`` whose model is any ``EnvModel`` over a quantized
    space (a ``FaultInjectedModel`` included). Per step: the act
    (``fleet_act``: an in-order fold on the card, so a session's bits do
    not depend on N; then the warmup or noise override), ONE
    ``model.step_draws`` and the model's step (three of them, sharing the
    draws, when guarded: ``guarded_transition``), the reward, the FIFO
    write at each session's own cursor, and the learner
    (``fleet_learn_scan``: the threefry index draw, then one launch of the
    CUDA learner on the card, ``ddpg_learn_plain`` on the CPU). The carry
    (and the guard) is updated IN PLACE, as the episode kernel updates it;
    returns the trace (``EpisodeTrace``, or ``GuardedEpisodeTrace``, of
    tensors ``[N, T, ...]``, restarts as int32 fixed point).

    The host reads the replay sizes once; the cursors then advance on the
    host as on the device, so no step waits for the device beyond what
    the model's step and the learner do themselves."""
    from repro_torch import random as jrandom
    from repro_torch.core.action_mapping import coord_maps
    from repro_torch.core.ddpg import fleet_act, fleet_learn_scan, \
        state_layout

    guarded = policy is not None
    if guarded:
        from repro_torch.core.guardrails import guarded_transition
        carry, guard = op.carry.base, op.carry.guard
    else:
        carry, guard = op.carry, None
    n, steps = _check_stepwise(op, carry, spec)
    cfg, model = spec.cfg, spec.model
    device = carry.ddpg.flat.device
    params = type(model.params).from_vector(op.params)
    maps = coord_maps(model.param_space)
    actor = state_layout(cfg).offsets[1][0][0]
    bounds = (op.lo, op.span, op.w_vec)
    bs, ba, br, bs2, nxt, size = carry.buffer
    cap = bs.shape[1]
    sizes = size.to("cpu", copy=True)  # a host copy, also on the CPU
    rows = torch.arange(n, device=device)
    learn = bool(spec.learn)
    updates = learn and spec.num_updates > 0
    env_state, state_vec, objective = carry.env_state, carry.state_vec, \
        carry.objective
    trace = _new_trace(n, steps, cfg, device, guarded)
    for t in range(steps):
        with torch.no_grad():
            explored = torch.clamp(
                fleet_act(carry.ddpg.flat[:, :actor], state_vec, cfg)
                + op.noise[:, t], 0.0, 1.0)
            action = torch.where(op.use_warmup[:, t, None],
                                 torch.clamp(op.warmup[:, t], 0.0, 1.0),
                                 explored)
            key, draws = model.step_draws(model.key_of(env_state))
            live = model.with_key(env_state, key)
            if guarded:
                tr, guard, event, shadow = guarded_transition(
                    model, params, live, action, draws, objective, bounds,
                    guard, policy)
                trace.guard_events[:, t] = event
                trace.shadow_objectives[:, t] = shadow
            else:
                tr = plain_transition(model, params, live, action, draws,
                                      objective, bounds)
            if learn:  # FIFO write, store before learn
                i = nxt.long()
                a_row, r_row, s2_row = tr.stored
                bs[rows, i] = state_vec
                ba[rows, i] = a_row
                br[rows, i] = r_row
                bs2[rows, i] = s2_row
                nxt.copy_((nxt + 1) % cap)
                size.copy_(torch.clamp(size + 1, max=cap))
                sizes = torch.clamp(sizes + 1, max=cap)
        if updates:
            pair = jrandom.split_keys(carry.learn_key, 2)
            carry.learn_key.copy_(pair[:, 0])
            fleet_learn_scan(carry.ddpg, (bs, ba, br, bs2), sizes,
                             pair[:, 1], cfg, spec.num_updates)
        trace.action_idx[:, t] = torch.stack(
            [maps[j](tr.committed[:, j])["idx"]
             for j in range(cfg.action_dim)], dim=-1).to(torch.int32)
        trace.metrics[:, t] = tr.metrics
        trace.rewards[:, t] = tr.reward
        trace.objectives[:, t] = tr.objective
        trace.restarts[:, t] = _encode_restart(tr.restart)
        env_state, state_vec, objective = tr.env_state, tr.norm, tr.objective
    for dst, src in zip(_tensors(carry.env_state), _tensors(env_state)):
        dst.copy_(src)
    carry.state_vec.copy_(state_vec)
    carry.objective.copy_(objective)
    if guarded:
        for dst, src in zip(op.carry.guard, guard):
            dst.copy_(src)
    return trace


def run_episode_scan(env, agent, scalarizer, cur_metrics: dict, steps: int,
                     learn: bool = True, policy=None, guard=None,
                     obs_mask=None, resilience=None, health=None):
    """Run ``steps`` tuning iterations of one session in one episode call.

    ``env`` must be a ``ModelEnv`` on the agent's device. Mutates ``env``
    (model state), ``agent`` (learner state, key, buffer, noise stream,
    steps_taken) exactly as the host loop would and returns the per-step
    trace as numpy (``EpisodeTrace``, restarts in seconds). With
    ``policy=None`` the episode is ONE call of the episode kernel (a
    ``LustreSimModel`` env).

    ``policy`` (``core.guardrails.DeploymentPolicy``) runs the guarded
    shadow/canary body instead (``stepwise_episode``: one learner launch a
    step); ``guard`` must then be the session's ``GuardState``
    (``init_guard_state`` for a fresh session) and the return value becomes
    ``(GuardedEpisodeTrace, GuardState)``: the updated guard carries to the
    next progressive run. ``policy`` beside ``obs_mask`` or ``resilience``
    raises the reference's ``ValueError``; the resilient and masked bodies
    (``obs_mask``, ``resilience``, ``health``) are ROADMAP item A10b and
    raise ``NotImplementedError``."""
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.kernels import ops
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   EpisodeOperands)

    check_guard_composition(policy, obs_mask=obs_mask, resilience=resilience)
    _refuse_layers("run_episode_scan", obs_mask=obs_mask,
                   resilience=resilience, health=health)
    if policy is not None and guard is None:
        raise ValueError("guarded runs need a GuardState (core.guardrails."
                         "init_guard_state seeded from the live config)")
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
    if policy is None:
        trace = ops.episode_inner_loop(op, spec=spec)
    else:
        from repro_torch.core.guardrails import GuardedCarry, guard_row, \
            guard_to_numpy, guard_to_torch, stack_guards
        guard = guard_to_torch(stack_guards([guard]), device)
        trace = stepwise_episode(
            op._replace(carry=GuardedCarry(base=carry, guard=guard)),
            spec=spec, policy=policy)

    # write the carried state back (the learner was updated in place)
    env.model_state = tree_map(lambda x: x[0], carry.env_state)
    agent._learn_key = carry.learn_key[0].cpu()
    if learn:
        agent.buffer.set_storage(*(b[0] for b in carry.buffer[:4]),
                                 int(carry.buffer.next_slot[0]),
                                 int(carry.buffer.size[0]))
    out = _decode_trace(type(trace)(*(x[0] for x in trace)))
    if policy is None:
        return out
    return out, guard_row(guard_to_numpy(guard), 0)


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
                  staging: Optional[dict] = None, device=None) -> None:
    """Drive the chunked episode pipeline.

    ``stage(ci)`` copies chunk ``ci``'s operands to ``device`` (from
    page-locked host tensors, without waiting) and returns them;
    ``call(args)`` runs the episode on them on the current stream and
    returns what ``drain`` takes; ``drain(ci, out)`` enqueues the copies of
    chunk ``ci``'s results back into the host tensors.

    ``overlap=False``, or a CPU ``device``: stage, call, drain one chunk
    at a time on one stream, waiting for the copies back before the next
    chunk.

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

    ``staging`` (a dict) receives ``async`` (whether copy streams ran),
    ``stage_seconds`` (host time spent enqueuing the stagings),
    ``stage_wait_seconds`` (host time blocked on a staged chunk: all of the
    staging when serial, none when the copy stream runs it),
    ``drain_seconds`` (host time in the drains, waiting on their copies
    included) and ``overlap_efficiency`` (1 - wait / stage). The reference's
    supervised schedule (``supervisor``, ``chaos``) is ROADMAP item A10b."""
    _refuse_layers("stream_chunks", supervisor=supervisor, chaos=chaos)
    st = staging if staging is not None else {}
    st.update(**{"async": False, "stage_seconds": 0.0,
                 "stage_wait_seconds": 0.0, "drain_seconds": 0.0,
                 "overlap_efficiency": 0.0})
    if num_chunks <= 0:
        return None
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    cuda = device.type == "cuda"

    def wait_host():
        if cuda:
            event = torch.cuda.current_stream(device).record_event()
            event.synchronize()

    if overlap and cuda:
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
            t0 = time.perf_counter()
            args = stage(ci)
            st["stage_seconds"] += time.perf_counter() - t0
            out = call(args)
            t0 = time.perf_counter()
            drain(ci, out)
            wait_host()
            st["drain_seconds"] += time.perf_counter() - t0
        st["stage_wait_seconds"] = st["stage_seconds"]
    if st["stage_seconds"] > 0.0:
        st["overlap_efficiency"] = max(
            0.0, 1.0 - st["stage_wait_seconds"] / st["stage_seconds"])
    return None


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
                         guard=None) -> tuple:
    """The chunk machinery of the fleet episode, for any fleet of sessions
    of one env model structure: ``FleetTuner``'s (``run_fleet_episode_scan``)
    and ``FleetService``'s, whose sessions differ in age.

    The caller has checked ``envs`` with ``check_fleet_envs``. Per session
    ``i``: ``exploration[i]`` is its pre-drawn (use_warmup,
    warmup, noise) (``draw_exploration`` at its own age), ``ddpg`` (a
    ``DDPGState``), ``buffer`` (the window and its own cursors
    ``next_slot``, ``size``) and ``learn_keys`` hold its state in host
    tensors with a leading ``[N]`` axis (page-locked on a card). The
    sessions run in ``ceil(N / chunk)`` chunks, one call each, the ragged
    last chunk at its own width; each chunk is staged to ``device``, run
    and drained back through ``stream_chunks``. With ``policy=None`` a call
    is one launch of the episode kernel (``kernels.ops.
    episode_inner_loop``); with a ``DeploymentPolicy`` it is the guarded
    per-step body (``stepwise_episode``), and ``guard`` (a ``GuardState`` of
    host tensors ``[N, ...]``) is staged and drained with the rest. The
    host tensors are written IN PLACE, and each env's model state (a nest
    of tensors) is gathered from and written back to its env.

    Returns (trace, stats): the decoded host trace (``[N, T, ...]`` numpy,
    restarts in seconds; a ``GuardedEpisodeTrace`` when guarded), and
    ``sessions``, ``chunk``, ``num_chunks``, ``overlap``,
    ``padded_sessions`` (0), ``peak_device_bytes``,
    ``launch_device_seconds`` (CUDA events around each call; empty on the
    CPU), ``prepare_seconds``, ``finish_seconds`` and ``staging`` (see
    ``last_fleet_run_stats``)."""
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.kernels import ops
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   EpisodeOperands)

    t_prep = time.perf_counter()
    device = torch.device(device)
    guarded = policy is not None
    if guarded:
        from repro_torch.core.guardrails import GuardedCarry, \
            GuardedEpisodeTrace, GuardState
        if guard is None:
            raise ValueError("guarded fleet runs need a stacked GuardState "
                             "(core.guardrails.init_fleet_guard_state)")
    n = len(envs)
    c = resolve_chunk(n, chunk)
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
    state_vecs = _host_copy(state_vecs, pin, f32)
    objectives = _host_copy(objectives, pin, f32)
    fields = dict(
        action_idx=_host_copy(np.zeros((n, steps, m), np.int32), pin),
        metrics=_host_copy(np.zeros((n, steps, k), np.float32), pin),
        rewards=_host_copy(np.zeros((n, steps), np.float32), pin),
        objectives=_host_copy(np.zeros((n, steps), np.float32), pin),
        restarts=_host_copy(np.zeros((n, steps), np.int32), pin))
    if guarded:
        out = GuardedEpisodeTrace(
            **fields,
            guard_events=_host_copy(np.zeros((n, steps), np.uint8), pin),
            shadow_objectives=_host_copy(np.zeros((n, steps), np.float32),
                                         pin))
    else:
        out = EpisodeTrace(**fields)
    spec = EpisodeKernelSpec(model=envs[0].model, cfg=cfg, learn=learn,
                             num_updates=cfg.updates_per_step)
    prepare_seconds = time.perf_counter() - t_prep

    peak = [live_device_bytes()]
    events = []

    def stage(ci):
        a, b = ci * c, min(n, (ci + 1) * c)

        def dev(x):
            part = x[a:b]
            return torch.empty(part.shape, dtype=part.dtype,
                               device=device).copy_(part, non_blocking=True)

        carry = EpisodeCarry(
            env_state=tree_map(dev, env_state),
            ddpg=DDPGState(*(dev(x) for x in ddpg)),
            buffer=BufferState(*(dev(x) for x in buffer)),
            learn_key=dev(learn_keys), state_vec=dev(state_vecs),
            objective=dev(objectives))
        if guarded:
            carry = GuardedCarry(base=carry,
                                 guard=GuardState(*(dev(x) for x in guard)))
        args = EpisodeOperands(**{name: dev(x)
                                  for name, x in operands.items()},
                               carry=carry)
        peak[0] = max(peak[0], live_device_bytes())
        return args

    def call(args):
        if pin:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        if guarded:
            trace = stepwise_episode(args, spec=spec, policy=policy)
        else:
            trace = ops.episode_inner_loop(args, spec=spec)
        if pin:
            end.record()
            events.append((begin, end))
        return args.carry, trace

    def drain(ci, result):
        a, b = ci * c, min(n, (ci + 1) * c)
        carry, trace = result
        peak[0] = max(peak[0], live_device_bytes())
        pairs = list(zip(out, trace))
        if guarded:
            pairs += zip(guard, carry.guard)
            carry = carry.base
        pairs += [*zip(_tensors(env_state), _tensors(carry.env_state)),
                  *zip(ddpg, carry.ddpg), *zip(buffer, carry.buffer),
                  (learn_keys, carry.learn_key)]
        for dst, src in pairs:
            dst[a:b].copy_(src, non_blocking=True)

    staging: dict = {}
    stream_chunks(call, stage, drain, num_chunks, overlap=overlap,
                  staging=staging, device=device)

    t_finish = time.perf_counter()
    dev_env = tree_map(lambda x: x.to(device), env_state)
    for i, e in enumerate(envs):
        e.model_state = tree_map(lambda x: x[i], dev_env)
    trace = _decode_trace(out)
    stats = dict(
        sessions=n, chunk=c, num_chunks=num_chunks, overlap=overlap,
        padded_sessions=0, peak_device_bytes=peak[0],
        launch_device_seconds=[b.elapsed_time(e) / 1e3 for b, e in events],
        prepare_seconds=prepare_seconds,
        finish_seconds=time.perf_counter() - t_finish, staging=staging)
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
    agent's shared ``steps_taken``, and its replay windows share one FIFO
    cursor.

    ``overlap=True`` streams the chunks on copy streams beside the compute
    stream (``stream_chunks``), bitwise the serial schedule.

    ``policy``/``guard`` run the guarded shadow/canary body
    (``stepwise_episode``, one learner launch a step per chunk): ``guard``
    is a stacked ``[N, ...]`` numpy ``GuardState``
    (``init_fleet_guard_state``); it rides the chunk carry like all fleet
    state and the return value becomes ``(GuardedEpisodeTrace,
    GuardState)``. ``policy`` beside ``sharing`` or ``resilience`` raises
    the reference's ``ValueError``.

    ``devices`` may name one card (the agent's); more than one is ROADMAP
    item A11d. ``sharing``, ``cell_size > 1``, ``obs_mask``,
    ``resilience``, ``health``, ``supervisor`` and ``chaos`` belong to the
    policy layers of ROADMAP item A10b and raise ``NotImplementedError``."""
    from repro_torch.core.ddpg import DDPGState

    check_guard_composition(policy, sharing=sharing, resilience=resilience)
    _refuse_layers("run_fleet_episode_scan", sharing=sharing,
                   obs_mask=obs_mask, resilience=resilience, health=health,
                   supervisor=supervisor, chaos=chaos)
    if cell_size != 1:
        raise NotImplementedError(
            "cells of sessions (cell_size > 1) belong to experience "
            "sharing, ROADMAP item A10b, not yet in repro_torch")
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "a fleet episode across several cards is ROADMAP item A11d; "
            "pass one device")
    if policy is not None and guard is None:
        raise ValueError("guarded fleet runs need a stacked GuardState "
                         "(core.guardrails.init_fleet_guard_state)")
    t_prep = time.perf_counter()
    check_fleet_envs(envs, agent.device)
    n = len(envs)
    pin = agent.device.type == "cuda"
    learner = [_host_state(x, pin) for x in agent.states]
    (bs, ba, br, bs2), sizes = agent.buffer.storage()
    window = [_host_state(x, pin) for x in (bs, ba, br, bs2)]
    buffer = BufferState(
        *(x for x, _ in window),
        next_slot=_host_copy(torch.full((n,), agent.buffer._next,
                                        dtype=torch.int32), pin),
        size=_host_copy(sizes, pin, torch.int32))
    learn_keys = _host_copy(agent._learn_keys, pin)
    xs = [_consume_exploration(agent, steps, session=i) for i in range(n)]
    agent.steps_taken += steps
    if policy is not None:
        from repro_torch.core.guardrails import guard_to_numpy, \
            guard_to_torch
        guard = guard_to_torch(guard, pin=pin)
    gathered = time.perf_counter() - t_prep

    trace, stats = stream_fleet_episode(
        envs, scalarizers, cur_metrics, xs,
        DDPGState(*(x for x, _ in learner)), buffer, learn_keys,
        cfg=agent.cfg, steps=steps, learn=learn, chunk=chunk,
        overlap=overlap, device=agent.device, policy=policy, guard=guard)

    t_finish = time.perf_counter()
    for (x, copied), dst in zip(learner, agent.states):
        if copied:
            dst.copy_(x)
    agent._learn_keys = learn_keys
    if learn:
        agent.buffer.set_storage(*buffer[:4], int(buffer.next_slot[0]),
                                 int(buffer.size[0]))
    stats["prepare_seconds"] += gathered
    stats["finish_seconds"] += time.perf_counter() - t_finish
    _LAST_FLEET_STATS.clear()
    _LAST_FLEET_STATS.update(stats)
    if policy is None:
        return trace
    return trace, guard_to_numpy(guard)


def precompile_fleet_episode(env, agent, steps: int, sessions: int,
                             chunk: Optional[int] = None,
                             devices: Optional[Sequence] = None,
                             learn: bool = True, policy=None):
    """Build and load the library this fleet's episodes launch
    (``kernels/build.py``) ahead of ``run()``, after checking that the
    configuration fits it, without touching any tuning state: the episode
    kernel's (the model, the widths, its shared-memory plan), or with a
    ``policy`` the learner kernel's, which the guarded body launches once a
    step. Returns the loaded library on a card and ``None`` on the CPU,
    where the plain versions need no build. More than one device is ROADMAP
    item A11d."""
    from repro_torch.kernels import build
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   _check_model,
                                                   check_smem_fit)

    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "a fleet episode across several cards is ROADMAP item A11d; "
            "pass one device")
    resolve_chunk(sessions, chunk)
    if policy is not None:
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
