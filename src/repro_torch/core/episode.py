"""Whole-episode engine: the Fig. 1 loop for one session, as ONE kernel
launch on the card.

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
(``RESTART_FP_SCALE``). Only a single session is ported; the fleet runtime
(``run_fleet_episode_scan``) is ROADMAP item A7, and the guarded, resilient
and observation-masked bodies are A10.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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


def _consume_exploration(agent, steps: int) -> tuple:
    """Pre-draw the episode's exploration from the agent's own host streams.

    Warmup plans and OU noise are state-independent, so consuming them up
    front leaves the agent's numpy RNG exactly where ``steps`` host-loop
    ``act()`` calls would. Returns (use_warmup [T] bool, warmup_actions
    [T, m], noise [T, m]) as numpy; advances ``steps_taken``."""
    m = agent.cfg.action_dim
    s0 = agent.steps_taken
    use_warmup = np.zeros(steps, bool)
    warmup = np.zeros((steps, m), np.float32)
    noise = np.zeros((steps, m), np.float32)
    for t in range(steps):
        if s0 + t < agent.warmup_steps:
            use_warmup[t] = True
            warmup[t] = agent._warmup_plan[s0 + t]
        else:
            noise[t] = agent.noise()
    agent.steps_taken += steps
    return use_warmup, warmup, noise


def _decode_trace(trace: EpisodeTrace) -> EpisodeTrace:
    """Device trace -> host numpy, restart fixed point decoded to seconds."""
    host = EpisodeTrace(*(x.cpu().numpy() for x in trace))
    return host._replace(restarts=decode_restarts(host.restarts))


def run_episode_scan(env, agent, scalarizer, cur_metrics: dict, steps: int,
                     learn: bool = True, policy=None, guard=None,
                     obs_mask=None, resilience=None,
                     health=None) -> EpisodeTrace:
    """Run ``steps`` tuning iterations of one session in one episode call.

    ``env`` must be a ``ModelEnv`` over a ``LustreSimModel`` on the agent's
    device. Mutates ``env`` (model state), ``agent`` (learner state, key,
    buffer, noise stream, steps_taken) exactly as the host loop would and
    returns the per-step trace as numpy (``EpisodeTrace``, restarts in
    seconds). The guarded, resilient and observation-masked bodies
    (``policy``, ``guard``, ``obs_mask``, ``resilience``, ``health``) are
    ROADMAP item A10 and raise ``NotImplementedError``."""
    from repro_torch.core.ddpg import DDPGState
    from repro_torch.kernels import ops
    from repro_torch.kernels.episode_learn import (EpisodeKernelSpec,
                                                   EpisodeOperands)

    for name, value in (("policy", policy), ("guard", guard),
                        ("obs_mask", obs_mask), ("resilience", resilience),
                        ("health", health)):
        if value is not None:
            raise NotImplementedError(
                f"run_episode_scan({name}=...) belongs to the guarded, "
                f"resilient or masked episode body, ROADMAP item A10, not "
                f"yet in repro_torch")
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
    es = env.model_state
    env_state = type(es)(key=es.key.unsqueeze(0).clone(),
                         warmth=es.warmth.reshape(1).clone(),
                         last_values=es.last_values.unsqueeze(0).clone())
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
    trace = ops.episode_inner_loop(op, spec=spec)

    # write the carried state back (the learner was updated in place)
    env.model_state = type(es)(key=carry.env_state.key[0],
                               warmth=carry.env_state.warmth[0],
                               last_values=carry.env_state.last_values[0])
    agent._learn_key = carry.learn_key[0].cpu()
    if learn:
        agent.buffer.set_storage(*(b[0] for b in carry.buffer[:4]),
                                 int(carry.buffer.next_slot[0]),
                                 int(carry.buffer.size[0]))
    return _decode_trace(EpisodeTrace(*(x[0] for x in trace)))
