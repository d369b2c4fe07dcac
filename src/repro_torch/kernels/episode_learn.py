"""The whole-episode kernel: the CUDA kernel's wrapper, its plain PyTorch
version, the pre-draw of the episode's randomness, the shared-memory plan
and the work it does.

``episode_learn`` launches ``csrc/episode_learn.cu`` (one thread block per
tuning session, all T steps of its episode inside the block; it replaces the
Pallas TPU kernel ``kernels/episode_fused.py::episode_fused_learn`` of the
JAX package). ``episode_learn_plain`` computes the same episode as a Python
loop over the steps: the Lustre model's torch step
(``envs/lustre_model.py``) and the plain learner
(``kernels/ddpg_learn.py::ddpg_learn_plain``), batched over sessions. It is
what a CPU tensor runs (``kernels.ops.episode_inner_loop``) and what the
kernel is held against on the card.

Both take ``EpisodeOperands`` (every tensor with a leading session axis N)
and an ``EpisodeKernelSpec``; both first call ``predraw``, which walks the
env key chain and the learner's key chain for T steps on the tensors'
device and so hands both versions the same draws; both update the carry IN
PLACE (learner, replay window and cursors, env state, keys, state vector,
objective) and return the trace (``core.episode.EpisodeTrace`` of tensors
``[N, T, ...]``, restarts as int32 fixed point): together what the
reference's ``EpisodeOutputs`` holds.

Only ``LustreSimModel`` environments over quantized spaces are taken: the
kernel's env step is a device function written for that model. The
synthetic model (``envs/synthetic.py``) is ROADMAP item A5's rest.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.core.action_mapping import coord_maps
from repro_torch.core.ddpg import DDPGConfig, actor_apply, state_layout, \
    unflatten
from repro_torch.core.episode import EpisodeCarry, EpisodeTrace, \
    _encode_restart, normalized_objective, relative_gain
from repro_torch.envs.lustre_model import LustreParams, LustreSimModel, \
    draws_per_step, episode_draws
from repro_torch.envs.lustre_sim import NET_CAP
from repro_torch.kernels import build
from repro_torch.kernels.ddpg_learn import SMEM_LIMIT, _hyper, check_plan, \
    ddpg_learn_plain
from repro_torch.kernels.ddpg_learn import smem_plan as smem_plan_learner
from repro_torch.kernels.ddpg_learn import work as learner_work

MAX_KNOBS = 16
MAX_TABLE = 128
MAX_STATE = 32
#: the knobs the kernel's Lustre step reads, in csrc's ``enum Knob`` order
NAMED_KNOBS = ("stripe_count", "stripe_size", "service_threads",
               "max_rpcs_in_flight", "max_pages_per_rpc", "max_dirty_mb",
               "read_ahead_mb", "checksums")


class EpisodeKernelSpec(NamedTuple):
    """Static configuration of an episode call."""

    model: Any            # envs.lustre_model.LustreSimModel
    cfg: DDPGConfig
    learn: bool           # store transitions (and learn when num_updates)
    num_updates: int      # learner updates per step (cfg.updates_per_step)


class EpisodeOperands(NamedTuple):
    """Inputs of N sessions' episodes, every tensor ``[N, ...]``; ``carry``
    is updated in place."""

    use_warmup: torch.Tensor  # [N, T] bool
    warmup: torch.Tensor      # [N, T, m] f32
    noise: torch.Tensor       # [N, T, m] f32
    w_vec: torch.Tensor       # [N, k] f32
    lo: torch.Tensor          # [N, k] f32
    span: torch.Tensor        # [N, k] f32
    params: torch.Tensor      # [N, 14] f32, LustreParams.vector()
    carry: EpisodeCarry       # env_state (LustreEnvState), ddpg (DDPGState),
                              # buffer (BufferState), learn_key [N, 2],
                              # state_vec [N, k], objective [N]


# ---------------------------------------------------------------------------
# Checks, shared-memory plan, pre-draw
# ---------------------------------------------------------------------------

def _updates(spec: EpisodeKernelSpec) -> bool:
    return bool(spec.learn) and spec.num_updates > 0


def _check_model(spec: EpisodeKernelSpec) -> None:
    model = spec.model
    if not isinstance(model, LustreSimModel):
        raise ValueError(
            f"the episode kernel runs the Lustre model only, not "
            f"{type(model).__name__}: other env models (the synthetic "
            f"surface) are ROADMAP item A5's rest")
    if not model.param_space.is_quantized:
        raise ValueError(
            "the episode kernel needs a quantized ParamSpace: continuous "
            "knobs have no exact in-graph quantization (use the host "
            "engine)")


def _check(op: EpisodeOperands, spec: EpisodeKernelSpec) -> tuple:
    """Validate shapes, dtypes, devices and contiguity; return (N, T)."""
    _check_model(spec)
    cfg = spec.cfg
    if len(cfg.hidden) != 2:
        raise ValueError(f"the episode kernel takes two hidden layers, got "
                         f"hidden={cfg.hidden!r}")
    k, m = cfg.state_dim, cfg.action_dim
    if m != spec.model.param_space.dim:
        raise ValueError(f"cfg.action_dim {m} != the space's "
                         f"{spec.model.param_space.dim} knobs")
    if k != len(spec.model.state_metrics):
        raise ValueError(f"cfg.state_dim {k} != the model's "
                         f"{len(spec.model.state_metrics)} metrics")
    if op.use_warmup.dim() != 2:
        raise ValueError(f"use_warmup must be [N, T], got "
                         f"{tuple(op.use_warmup.shape)}")
    n, t = op.use_warmup.shape
    c = op.carry
    cap = c.buffer.s.shape[1] if c.buffer.s.dim() == 3 else -1
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    floats = state_layout(cfg).floats
    want = {
        "use_warmup": (op.use_warmup, (n, t), torch.bool),
        "warmup": (op.warmup, (n, t, m), f32),
        "noise": (op.noise, (n, t, m), f32),
        "w_vec": (op.w_vec, (n, k), f32), "lo": (op.lo, (n, k), f32),
        "span": (op.span, (n, k), f32),
        "params": (op.params, (n, len(LustreParams._fields)), f32),
        "env key": (c.env_state.key, (n, 2), i64),
        "warmth": (c.env_state.warmth, (n,), f32),
        "last_values": (c.env_state.last_values, (n, m), f32),
        "flat": (c.ddpg.flat, (n, floats), f32),
        "counts": (c.ddpg.counts, (n, 2), i32),
        "step": (c.ddpg.step, (n,), i32),
        "s": (c.buffer.s, (n, cap, k), f32),
        "a": (c.buffer.a, (n, cap, m), f32),
        "r": (c.buffer.r, (n, cap), f32),
        "s2": (c.buffer.s2, (n, cap, k), f32),
        "next_slot": (c.buffer.next_slot, (n,), i32),
        "size": (c.buffer.size, (n,), i32),
        "learn_key": (c.learn_key, (n, 2), i64),
        "state_vec": (c.state_vec, (n, k), f32),
        "objective": (c.objective, (n,), f32),
    }
    device = c.ddpg.flat.device
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the learner on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cap < 1:
        raise ValueError("the replay window needs capacity >= 1")
    return n, t


def smem_plan(state_dim: int, action_dim: int, hidden: tuple,
              batch_size: int, capacity: int, n_samples: int) -> dict:
    """Bytes of dynamic shared memory one block of the episode kernel uses,
    by part, in the order the parts lie in shared memory: the session's
    whole learner state (resident for the launch), the learner's
    activations and deltas (which also hold the act forward's rows and the
    env step's action, knob values and normalized metrics between steps),
    the replay window, the state and metric rows, and the env step's
    per-sample scratch. The kernel takes each part's offset from this plan
    (``launch_args``) and computes none itself."""
    k, m, b = state_dim, action_dim, batch_size
    cfg = DDPGConfig(k, m, hidden=tuple(hidden), batch_size=b)
    learner = smem_plan_learner(cfg)
    row = 2 * k + m + 1  # one transition's floats
    parts = {
        "learner_state": learner["learner_state"],
        "learner": learner["learner"],
        "replay_window": 4 * capacity * row,
        "state_rows": 4 * 2 * k,
        "env_samples": 4 * 12 * n_samples,
    }
    parts["total"] = sum(parts.values())
    return parts


def check_smem_fit(cfg: DDPGConfig, capacity: int, n_samples: int) -> dict:
    """``smem_plan`` of this configuration; raises ``ValueError`` when it
    exceeds the per-block opt-in limit (227 KB on the H100), naming the
    knob to lower, or when the widths are not the learner's
    (``ddpg_learn.check_plan``)."""
    plan = smem_plan(cfg.state_dim, cfg.action_dim, cfg.hidden,
                     cfg.batch_size, capacity, n_samples)
    row = 4 * (2 * cfg.state_dim + cfg.action_dim + 1)
    most = max(0, (SMEM_LIMIT - plan["total"] + plan["replay_window"]) // row)
    check_plan(plan, cfg, "episode",
               also=f"buffer_capacity (replay capacity, at most {most} rows "
                    f"here), or ")
    return plan


def predraw(op: EpisodeOperands, spec: EpisodeKernelSpec) -> tuple:
    """All of the episode's randomness, drawn on the tensors' device before
    it runs: ``env_draws [N, T, 3 + 11 n]`` (the env key chain, six splits
    per step whatever the action) and ``mb_idx [N, T, U, B]`` int32 (the
    learner's key, split once per step; step t samples from the
    ``min(size0 + t + 1, capacity)`` rows the store-before-learn window
    holds then). Advances ``carry.env_state.key`` and ``carry.learn_key``
    in place, as the episode would."""
    c = op.carry
    n, t = op.use_warmup.shape
    key, env = episode_draws(c.env_state.key, t, spec.model.n_samples)
    c.env_state.key.copy_(key)
    u, b = spec.num_updates, spec.cfg.batch_size
    if not _updates(spec):
        return env, torch.zeros((n, t, 0, b), dtype=torch.int32,
                                device=env.device)
    lk, kks = c.learn_key, []
    for _ in range(t):
        pair = jrandom.split_keys(lk, 2)
        lk = pair[..., 0, :]
        kks.append(pair[..., 1, :])
    c.learn_key.copy_(lk)
    cap = c.buffer.s.shape[1]
    steps = torch.arange(1, t + 1, device=env.device, dtype=torch.int64)
    size_t = torch.clamp(c.buffer.size.to(torch.int64)[:, None] + steps,
                         max=cap)
    mb_idx = jrandom.randint_keys(torch.stack(kks, dim=1), (u, b), 0, size_t)
    return env, mb_idx


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def space_desc(model: LustreSimModel) -> tuple:
    """The parameter space flattened for the kernel's ``Space`` struct:
    (ints [58], floats [304]); see ``csrc/episode_learn.cu``."""
    space = model.param_space
    m = space.dim
    if m > MAX_KNOBS:
        raise ValueError(f"the episode kernel takes at most {MAX_KNOBS} "
                         f"knobs, got {m}")
    boolean = [0] * MAX_KNOBS
    card = [0] * MAX_KNOBS
    table = [0] * MAX_KNOBS
    span = [0.0] * MAX_KNOBS
    off = [0.0] * MAX_KNOBS
    base = [0.0] * MAX_KNOBS
    values, log2v = [], []
    for j, spec in enumerate(space.specs):
        card[j] = spec.cardinality
        table[j] = len(values)
        if spec.kind == "boolean":
            boolean[j] = 1
            vals, logs = [0.0, 1.0], [0.0, 0.0]
        elif spec.kind == "discrete":
            lo, hi = float(spec.minimum), float(spec.maximum)
            span[j], off[j], base[j] = hi - lo, lo + 0.5, lo
            vals = [lo + i for i in range(card[j])]
            logs = [0.0] * card[j]
        elif spec.kind == "log2_int":
            e_lo, e_hi = spec._log2_span()
            span[j], off[j] = float(e_hi - e_lo), 0.5
            vals = [float(2 ** e) for e in range(e_lo, e_hi + 1)]
            logs = [float(e) for e in range(e_lo, e_hi + 1)]
        else:
            span[j], off[j] = float(card[j] - 1), 0.5
            vals = [float(v) for v in spec.values]
            pow2 = all(v > 0 and v.is_integer() and
                       (int(v) & (int(v) - 1)) == 0 for v in vals)
            logs = [float(int(v).bit_length() - 1) if pow2 else 0.0
                    for v in vals]
        values += vals
        log2v += logs
    if len(values) > MAX_TABLE:
        raise ValueError(f"the space's value tables hold {len(values)} "
                         f"entries, over the kernel's {MAX_TABLE}")
    pad = [0.0] * (MAX_TABLE - len(values))
    pos = [space.names.index(k) if k in space.names else -1
           for k in NAMED_KNOBS]
    dfs = sum(1 << j for j, name in enumerate(space.names)
              if name in model.dfs_scope)
    ints = [m] + boolean + card + table + pos + [dfs]
    floats = span + off + base + values + pad + log2v + pad
    return ints, [float(np.float32(x)) for x in floats]


def env_consts(model: LustreSimModel) -> list:
    """The env step's float32 constants (csrc ``EnvConst``), each rounded
    from the Python expression the torch step evaluates."""
    return [float(np.float32(x)) for x in (
        np.sqrt(model.run_seconds / model.run_seconds),
        1.0 - np.exp(-32.0 / 24.0), 1.0 - np.exp(-64.0 / 48.0),
        NET_CAP * 0.95, NET_CAP)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The library's two functions: the launcher, and
    ``episode_learn_shared_bytes(smem_bytes)``, the shared memory a block of
    the kernel holds once opted into ``smem_bytes``."""
    fn = lib.episode_learn_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        lib.episode_learn_shared_bytes.argtypes = [ctypes.c_int]
        lib.episode_learn_shared_bytes.restype = ctypes.c_int
    return lib


def launch_args(op: EpisodeOperands, spec: EpisodeKernelSpec,
                env: torch.Tensor, mb_idx: torch.Tensor,
                trace: EpisodeTrace, plan: dict) -> tuple:
    """The host arrays ``episode_learn_launch`` takes (ptrs, ints, floats,
    offsets, space ints, space floats), as ctypes arrays; ``plan`` is the
    ``smem_plan`` of this launch, whose parts' offsets the kernel takes."""
    cfg, c = spec.cfg, op.carry
    n, t = op.use_warmup.shape
    cap = c.buffer.s.shape[1]
    model = spec.model
    # offsets in floats of every part after the learner's, in plan order
    parts = [v // 4 for key, v in plan.items() if key != "total"]
    part_offsets = np.cumsum(parts[:-1])
    tensors = [c.ddpg.flat, c.ddpg.counts, *c.buffer, c.env_state.warmth,
               c.env_state.last_values, c.state_vec, c.objective,
               op.use_warmup, op.warmup, op.noise, op.w_vec, op.lo, op.span,
               op.params, env, mb_idx, *trace]
    ints = [n, t, spec.num_updates, cfg.batch_size, cfg.state_dim,
            cfg.action_dim, cfg.hidden[0], cfg.hidden[1],
            state_layout(cfg).floats, cap, model.n_samples,
            int(bool(spec.learn)), int(_updates(spec)), plan["total"],
            *(int(x) for x in part_offsets)]
    floats = [float(x) for x in _hyper(cfg)] + env_consts(model)
    s_ints, s_floats = space_desc(model)
    return ((ctypes.c_void_p * len(tensors))(*(x.data_ptr()
                                                for x in tensors)),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats),
            (ctypes.c_int * 48)(*state_layout(cfg).flat_offsets()),
            (ctypes.c_int * len(s_ints))(*s_ints),
            (ctypes.c_float * len(s_floats))(*s_floats))


def _empty_trace(n: int, t: int, cfg: DDPGConfig, device) -> EpisodeTrace:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EpisodeTrace(z(n, t, cfg.action_dim, dtype=torch.int32),
                        z(n, t, cfg.state_dim), z(n, t), z(n, t),
                        z(n, t, dtype=torch.int32))


def episode_learn(op: EpisodeOperands, *,
                  spec: EpisodeKernelSpec) -> EpisodeTrace:
    """Run every session's whole episode in ONE launch of the CUDA kernel,
    on ``torch.cuda.current_stream()``. Updates ``op.carry`` IN PLACE and
    returns the trace. Raises on a tensor the kernel does not take, on a
    configuration over the shared-memory limit and on a refused launch.
    ``episode_learn.launches`` counts launches; the pre-draw is not one."""
    plan = _check_launch(op, spec)
    env, mb_idx = predraw(op, spec)
    return _launch(op, spec, env, mb_idx, plan)


episode_learn.launches = 0


def _check_launch(op: EpisodeOperands, spec: EpisodeKernelSpec) -> dict:
    """``_check`` plus what only the kernel needs: the fit in shared memory,
    the Space struct's limits and CUDA tensors. Returns the ``smem_plan``."""
    _check(op, spec)
    if spec.cfg.state_dim > MAX_STATE:
        raise ValueError(f"the episode kernel takes at most {MAX_STATE} "
                         f"state metrics, got {spec.cfg.state_dim}")
    plan = check_smem_fit(spec.cfg, op.carry.buffer.s.shape[1],
                          spec.model.n_samples)
    if not op.carry.ddpg.flat.is_cuda:
        raise ValueError("episode_learn launches the CUDA kernel and takes "
                         "CUDA tensors; use episode_learn_plain on the CPU")
    return plan


def launch(op: EpisodeOperands, spec: EpisodeKernelSpec,
           env_draws: torch.Tensor, mb_idx: torch.Tensor) -> EpisodeTrace:
    """The launch alone, on draws ``predraw`` made (``episode_learn`` is
    ``predraw`` then the launch; timing calls this to time the kernel
    apart). Counts the launch in ``episode_learn.launches``."""
    plan = _check_launch(op, spec)
    n, t = op.use_warmup.shape
    device = op.carry.ddpg.flat.device
    u = spec.num_updates if _updates(spec) else 0
    for name, x, shape, dtype in (
            ("env_draws", env_draws,
             (n, t, draws_per_step(spec.model.n_samples)), torch.float32),
            ("mb_idx", mb_idx, (n, t, u, spec.cfg.batch_size), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype or \
                x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"on {device}")
    return _launch(op, spec, env_draws, mb_idx, plan)


def _launch(op: EpisodeOperands, spec: EpisodeKernelSpec,
            env_draws: torch.Tensor, mb_idx: torch.Tensor,
            plan: dict) -> EpisodeTrace:
    """Launch on operands ``_check_launch`` accepted and their draws."""
    c = op.carry
    n, t = op.use_warmup.shape
    trace = _empty_trace(n, t, spec.cfg, c.ddpg.flat.device)
    if n == 0 or t == 0:
        return trace
    lib = _bind(build.load("episode_learn"))
    args = launch_args(op, spec, env_draws, mb_idx, trace, plan)
    with torch.cuda.device(c.ddpg.flat.device):
        stream = torch.cuda.current_stream(c.ddpg.flat.device).cuda_stream
        err = lib.episode_learn_launch(*(ctypes.addressof(a) for a in args),
                                       stream)
    if err != 0:
        raise RuntimeError(f"episode_learn: kernel launch failed with error "
                           f"{err}")
    episode_learn.launches += 1
    if _updates(spec):
        c.ddpg.step.add_(t * spec.num_updates)
    return trace


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def episode_learn_plain(op: EpisodeOperands, *,
                        spec: EpisodeKernelSpec) -> EpisodeTrace:
    """The same episodes in plain PyTorch: a Python loop over the T steps,
    batched over the N sessions, through the Lustre model's torch step and
    ``ddpg_learn_plain``. Updates ``op.carry`` IN PLACE and returns the
    trace."""
    n, t_steps = _check(op, spec)
    env_draws, mb_idx = predraw(op, spec)
    cfg, model, c = spec.cfg, spec.model, op.carry
    device = c.ddpg.flat.device
    maps = coord_maps(model.param_space)
    params = LustreParams.from_vector(op.params)
    bs, ba, br, bs2, nxt, size = c.buffer
    cap = bs.shape[1]
    rows = torch.arange(n, device=device)
    env_state = c.env_state
    state_vec, objective = c.state_vec.clone(), c.objective.clone()
    trace = _empty_trace(n, t_steps, cfg, device)
    for t in range(t_steps):
        with torch.no_grad():
            actor = unflatten(c.ddpg.flat, cfg)["actor"]
            policy = actor_apply(actor, state_vec[:, None, :])[:, 0]
            explored = torch.clamp(policy + op.noise[:, t], 0.0, 1.0)
            action = torch.where(op.use_warmup[:, t, None],
                                 torch.clamp(op.warmup[:, t], 0.0, 1.0),
                                 explored)
            idx = torch.stack([maps[j](action[:, j])["idx"]
                               for j in range(cfg.action_dim)], dim=-1)
            env_state, metrics, restart = model.step_fn(
                params, env_state, action, env_draws[:, t], False)
            norm, obj = normalized_objective(metrics, op.lo, op.span,
                                             op.w_vec)
            reward = relative_gain(obj, objective)
            if spec.learn:  # FIFO write, store before learn
                i = nxt.long()
                bs[rows, i] = state_vec
                ba[rows, i] = action
                br[rows, i] = reward
                bs2[rows, i] = norm
                nxt.copy_((nxt + 1) % cap)
                size.copy_(torch.clamp(size + 1, max=cap))
        if _updates(spec):
            at = mb_idx[:, t].long()
            r3 = rows[:, None, None]
            batches = tuple(x[r3, at].contiguous() for x in (bs, ba, br, bs2))
            ddpg_learn_plain(c.ddpg, batches, cfg=cfg)
        trace.action_idx[:, t] = idx.to(torch.int32)
        trace.metrics[:, t] = metrics
        trace.rewards[:, t] = reward
        trace.objectives[:, t] = obj
        trace.restarts[:, t] = _encode_restart(restart)
        state_vec, objective = norm, obj
    c.env_state.warmth.copy_(env_state.warmth)
    c.env_state.last_values.copy_(env_state.last_values)
    c.state_vec.copy_(state_vec)
    c.objective.copy_(objective)
    return trace


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------

def work(cfg: DDPGConfig, n: int, steps: int, capacity: int = 64,
         n_samples: int = 12) -> dict:
    """Floating-point operations and device-memory bytes N sessions' T-step
    episodes must spend, from the shapes alone.

    Operations: T times one learner call's U updates
    (``kernels/ddpg_learn.py::work``), plus per step the actor forward on
    one row, the env step (about 90 operations per sample and 60 per step,
    transcendentals counted as one) and the normalization and objective
    fold (4 k). Bytes: the learner state read and written once, the replay
    window read and written once, the inputs read once (exploration, bounds,
    params, the pre-drawn env values and minibatch indices) and the trace
    written once."""
    k, m, (h1, h2), b = cfg.state_dim, cfg.action_dim, cfg.hidden, \
        cfg.batch_size
    u = cfg.updates_per_step
    learner = learner_work(cfg, 1, u)["flops"]
    actor = 2 * (k * h1 + h1 * h2 + h2 * m)
    env = 90 * n_samples + 60
    per_step = learner + actor + env + 4 * k
    state_bytes = 2 * 4 * (state_layout(cfg).floats + 2)
    window_bytes = 2 * 4 * capacity * (2 * k + m + 1)
    inputs = 4 * steps * (1 + 2 * m + draws_per_step(n_samples) + u * b) + \
        4 * (3 * k + 14 + 2 + m + k + 1 + 2)
    outputs = 4 * steps * (m + k + 3)
    return {"flops": n * steps * per_step,
            "bytes": n * (state_bytes + window_bytes + inputs + outputs)}
