"""DDPG (Lillicrap et al.) in PyTorch — the paper's RL algorithm (§II-C).

The actor maps the metric state s_t in [0,1]^k to an action a in [0,1]^m;
the critic is Q_phi(s, a). Both are small ReLU MLPs with two hidden layers.
Learning follows §II-C:

  critic:  argmin_phi E[(Q_phi(s,a) - (r + gamma * Q_targ(s', mu_targ(s'))))^2]
  actor:   argmax_theta E[Q_phi(s, mu_theta(s))]

with Polyak-averaged target networks for both and one Adam step per network
per update (``optim/adam.py``, the reference's op order).

State layout. A learner is one contiguous float32 vector (``DDPGState.flat``)
holding eight parameter sets at their real sizes, in the order of
``PARAM_SETS``: the actor, the critic, their two Polyak targets, then the
Adam moments (mu, nu) of the actor and of the critic. Each set stores its
layers as ``w [fan_in, fan_out]`` (row-major) then ``b [fan_out]``, the
reference's ``x @ w + b`` orientation, so no transpose exists anywhere.
``StateLayout`` is the offset table; the CUDA learner
(``kernels/csrc/ddpg_learn.cu``) reads the same table. The Adam step counts
(actor, critic) are int32 in ``DDPGState.counts``. A fleet of N learners is
the same tensors with a leading session axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamHyper, adam_step

PARAM_SETS = ("actor", "critic", "actor_targ", "critic_targ",
              "actor_mu", "actor_nu", "critic_mu", "critic_nu")


# ---------------------------------------------------------------------------
# Config + layout
# ---------------------------------------------------------------------------

class DDPGConfig(NamedTuple):
    state_dim: int
    action_dim: int
    hidden: tuple = (64, 64)
    actor_lr: float = 1e-3
    critic_lr: float = 2e-3
    gamma: float = 0.9          # tuning steps are near-bandit; short horizon
    tau: float = 0.02           # Polyak coefficient for target networks
    updates_per_step: int = 96  # gradient steps per environment step (Table III)
    batch_size: int = 16

    @classmethod
    def for_space(cls, state_dim: int, space, **overrides) -> "DDPGConfig":
        """Size the learner from a ``ParamSpace``: one actor output per
        static parameter (paper §II-C-1)."""
        return cls(state_dim=state_dim, action_dim=space.dim, **overrides)

    @classmethod
    def for_env(cls, env, **overrides) -> "DDPGConfig":
        """State/action dims from a ``TuningEnvironment``."""
        return cls.for_space(env.state_dim, env.param_space, **overrides)

    @property
    def actor_sizes(self) -> tuple:
        return (self.state_dim, *self.hidden, self.action_dim)

    @property
    def critic_sizes(self) -> tuple:
        return (self.state_dim + self.action_dim, *self.hidden, 1)


class StateLayout(NamedTuple):
    """Offsets (in floats) of every ``w``/``b`` tensor in ``DDPGState.flat``.

    ``offsets[s][l]`` is ``(w_offset, b_offset)`` of layer ``l`` of parameter
    set ``PARAM_SETS[s]``; ``shapes[s][l]`` is ``(fan_in, fan_out)``."""

    offsets: tuple
    shapes: tuple
    floats: int

    def flat_offsets(self) -> list:
        """``[w, b]`` offsets of every layer of every set, set-major: the
        table the CUDA learner takes."""
        return [o for per_set in self.offsets for layer in per_set
                for o in layer]


@functools.lru_cache(maxsize=None)
def state_layout(cfg: DDPGConfig) -> StateLayout:
    offsets, shapes, pos = [], [], 0
    for name in PARAM_SETS:
        sizes = cfg.actor_sizes if name.startswith("actor") else \
            cfg.critic_sizes
        set_offsets, set_shapes = [], []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            set_offsets.append((pos, pos + fan_in * fan_out))
            set_shapes.append((fan_in, fan_out))
            pos += fan_in * fan_out + fan_out
        offsets.append(tuple(set_offsets))
        shapes.append(tuple(set_shapes))
    return StateLayout(tuple(offsets), tuple(shapes), pos)


def unflatten(flat: torch.Tensor, cfg: DDPGConfig) -> dict:
    """Views of ``flat [..., F]`` as {set name: [{"w", "b"}, ...]}."""
    layout = state_layout(cfg)
    lead = flat.shape[:-1]
    nets = {}
    for name, set_offsets, set_shapes in zip(PARAM_SETS, layout.offsets,
                                             layout.shapes):
        nets[name] = [
            {"w": flat[..., wo:wo + fi * fo].reshape(*lead, fi, fo),
             "b": flat[..., bo:bo + fo]}
            for (wo, bo), (fi, fo) in zip(set_offsets, set_shapes)]
    return nets


def flatten(nets: dict, cfg: DDPGConfig) -> torch.Tensor:
    """Inverse of ``unflatten``: one new ``[..., F]`` tensor."""
    parts = []
    for name in PARAM_SETS:
        for layer in nets[name]:
            lead = layer["b"].shape[:-1]
            parts += [layer["w"].reshape(*lead, -1), layer["b"]]
    return torch.cat(parts, dim=-1)


class DDPGState(NamedTuple):
    flat: torch.Tensor    # [..., F] float32, layout ``state_layout(cfg)``
    counts: torch.Tensor  # [..., 2] int32 Adam step counts (actor, critic)
    step: torch.Tensor    # [...] int32 updates taken


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(key: torch.Tensor, sizes: Sequence[int]) -> list:
    """He-uniform MLP init from a threefry key, bitwise the reference's
    ``core/ddpg.py::mlp_init``; CPU float32 tensors."""
    params = []
    keys = jrandom.split(key, len(sizes) - 1)
    for k, (fan_in, fan_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        bound = float(np.sqrt(6.0 / fan_in))
        w = jrandom.uniform(k, (fan_in, fan_out), -bound, bound)
        params.append({"w": w, "b": torch.zeros(fan_out)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP; no activation on the final layer. ``x [..., B, in]`` with
    weights ``[..., in, out]`` (matching leading session axes)."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"].unsqueeze(-2)
        if i + 1 < len(params):
            x = torch.relu(x)
    return x


def actor_apply(params: list, state: torch.Tensor) -> torch.Tensor:
    """Deterministic policy mu_theta: state -> action in [0,1]^m."""
    if state.dim() == 1:
        return torch.sigmoid(mlp_apply(params, state[None]))[0]
    return torch.sigmoid(mlp_apply(params, state))


def critic_apply(params: list, state: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    """Q_phi(s, a) -> scalar per row (last axis squeezed)."""
    x = torch.cat([state, action], dim=-1)
    return mlp_apply(params, x).squeeze(-1)


# ---------------------------------------------------------------------------
# Learner state + one update
# ---------------------------------------------------------------------------

def ddpg_init(key: torch.Tensor, cfg: DDPGConfig,
              device=None) -> DDPGState:
    """Fresh learner for one session, bitwise the reference's ``ddpg_init``
    (``PRNGKey`` split into actor/critic keys; targets start as copies, Adam
    moments and counts at zero). Runs on ``cuda`` unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    ka, kc = jrandom.split(key)
    actor = mlp_init(ka, cfg.actor_sizes)
    critic = mlp_init(kc, cfg.critic_sizes)

    def zeros(net):
        return [{k: torch.zeros_like(v) for k, v in layer.items()}
                for layer in net]

    nets = {"actor": actor, "critic": critic, "actor_targ": actor,
            "critic_targ": critic, "actor_mu": zeros(actor),
            "actor_nu": zeros(actor), "critic_mu": zeros(critic),
            "critic_nu": zeros(critic)}
    return DDPGState(
        flat=flatten(nets, cfg).to(device),
        counts=torch.zeros(2, dtype=torch.int32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _polyak(target: list, online: list, tau: float) -> list:
    return [{k: (1 - tau) * t[k] + tau * o[k] for k in t}
            for t, o in zip(target, online)]


def _adam_net(params: list, grads: list, mu: list, nu: list,
              count: torch.Tensor, lr: float) -> tuple:
    keys = [(i, k) for i, layer in enumerate(params) for k in ("w", "b")]

    def leaves(net):
        return [net[i][k] for i, k in keys]

    p, m, v, count = adam_step(leaves(params), grads, leaves(mu), leaves(nu),
                               count, AdamHyper(lr))

    def rebuild(flat_list):
        out = [dict() for _ in params]
        for (i, k), t in zip(keys, flat_list):
            out[i][k] = t
        return out

    return rebuild(p), rebuild(m), rebuild(v), count


def _leaf_copies(net: list) -> tuple:
    leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
              for layer in net]
    return leaves, [layer[k] for layer in leaves for k in ("w", "b")]


def _ddpg_step(state: DDPGState, batch: tuple, cfg: DDPGConfig) -> tuple:
    """One critic + one actor gradient step + Polyak, with autograd.

    ``batch`` = (s, a, r, s2), each ``[..., B, dim]`` (r ``[..., B]``), with
    the same leading session axes as ``state``. Returns a NEW
    ``(DDPGState, metrics)``; metrics hold ``[...]``-shaped critic_loss,
    actor_loss and q_mean (the latter from the updated critic)."""
    s, a, r, s2 = batch
    nets = unflatten(state.flat, cfg)
    with torch.enable_grad():
        # --- critic: Bellman regression against the frozen targets -------
        with torch.no_grad():
            a2 = actor_apply(nets["actor_targ"], s2)
            q_targ = r + cfg.gamma * critic_apply(nets["critic_targ"], s2, a2)
        critic, c_leaves = _leaf_copies(nets["critic"])
        q = critic_apply(critic, s, a)
        critic_loss = torch.mean(torch.square(q - q_targ), dim=-1)
        c_grads = torch.autograd.grad(critic_loss.sum(), c_leaves)
        critic, critic_mu, critic_nu, ccount = _adam_net(
            nets["critic"], c_grads, nets["critic_mu"], nets["critic_nu"],
            state.counts[..., 1], cfg.critic_lr)

        # --- actor: ascend Q_phi(s, mu_theta(s)) with the critic frozen --
        actor, a_leaves = _leaf_copies(nets["actor"])
        actor_loss = -torch.mean(critic_apply(critic, s,
                                              actor_apply(actor, s)), dim=-1)
        a_grads = torch.autograd.grad(actor_loss.sum(), a_leaves)
    actor, actor_mu, actor_nu, acount = _adam_net(
        nets["actor"], a_grads, nets["actor_mu"], nets["actor_nu"],
        state.counts[..., 0], cfg.actor_lr)

    new = {"actor": actor, "critic": critic,
           "actor_targ": _polyak(nets["actor_targ"], actor, cfg.tau),
           "critic_targ": _polyak(nets["critic_targ"], critic, cfg.tau),
           "actor_mu": actor_mu, "actor_nu": actor_nu,
           "critic_mu": critic_mu, "critic_nu": critic_nu}
    with torch.no_grad():
        new_state = DDPGState(
            flat=flatten(new, cfg).detach(),
            counts=torch.stack([acount, ccount], dim=-1),
            step=state.step + 1)
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(),
                   "q_mean": torch.mean(critic_apply(critic, s, a), dim=-1)}
    return new_state, metrics


# ---------------------------------------------------------------------------
# The fused learner: minibatch sampling, one gather, the 96-update kernel
# ---------------------------------------------------------------------------

def sample_minibatch_indices(key: torch.Tensor, num_updates: int,
                             batch_size: int, size: int) -> torch.Tensor:
    """``[num_updates, batch_size]`` uniform-with-replacement indices in
    ``[0, size)`` (int32, CPU), bitwise the reference's threefry draw.
    Precondition ``size >= 1`` (see ``_require_nonempty``)."""
    return jrandom.randint(key, (num_updates, batch_size), 0, size)


def gather_minibatches(data: tuple, idx: torch.Tensor) -> tuple:
    """Every update's minibatch in ONE gather per buffer array: (s, a, r,
    s2) each ``[num_updates, batch_size, ...]``. Gathers are exact."""
    flat = idx.reshape(-1).to(device=data[0].device, dtype=torch.int64)
    return tuple(x[flat].reshape(*idx.shape, *x.shape[1:]) for x in data)


def _require_nonempty(size) -> None:
    """Raise on an empty buffer instead of sampling garbage rows."""
    if int(np.min(np.asarray(size))) <= 0:
        raise ValueError(
            "cannot learn from an empty replay buffer: minibatch sampling "
            "needs size >= 1 valid rows (observe at least one transition "
            "before calling the fused learner)")


def ddpg_learn_scan(state: DDPGState, data: tuple, size: int,
                    key: torch.Tensor, cfg: DDPGConfig,
                    num_updates: int) -> tuple:
    """``num_updates`` minibatch gradient steps in one learner call.

    Samples the ``[num_updates, batch]`` indices from ``key`` (threefry,
    bitwise the reference), gathers every minibatch in one pass over the
    replay storage ``data`` (``(s, a, r, s2)``, each ``[capacity, ...]`` on
    the learner's device) and runs the whole inner loop through
    ``kernels.ops.ddpg_inner_loop``: the CUDA kernel for a CUDA state, the
    plain PyTorch loop for a CPU state. The learner state is updated IN
    PLACE and returned; metrics are ``[num_updates]`` tensors. Raises
    ``ValueError`` on an empty buffer."""
    from repro_torch.kernels import ops

    _require_nonempty(size)
    idx = sample_minibatch_indices(key, num_updates, cfg.batch_size, size)
    s, a, r, s2 = (b.to(torch.float32).unsqueeze(0)
                   for b in gather_minibatches(data, idx))
    fleet = DDPGState(state.flat.unsqueeze(0), state.counts.unsqueeze(0),
                      state.step.unsqueeze(0))
    metrics = ops.ddpg_inner_loop(fleet, (s, a, r, s2), cfg=cfg)
    return state, {"critic_loss": metrics[0, :, 0],
                   "actor_loss": metrics[0, :, 1],
                   "q_mean": metrics[0, :, 2]}


# ---------------------------------------------------------------------------
# Fleet: N independent learners batched over a leading session axis
# ---------------------------------------------------------------------------

def _mlp_init_keys(keys: torch.Tensor, sizes: Sequence[int]) -> list:
    """``mlp_init`` of every key of ``keys [N, 2]`` at once: each draw is
    elementwise in its key, so session i gets ``mlp_init(keys[i])``'s
    bits."""
    layer_keys = jrandom.split_keys(keys, len(sizes) - 1)
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = float(np.sqrt(6.0 / fan_in))
        w = jrandom.uniform_keys(layer_keys[:, i], (fan_in, fan_out), -bound,
                                 bound)
        params.append({"w": w, "b": torch.zeros(keys.shape[0], fan_out)})
    return params


def fleet_init(keys: torch.Tensor, cfg: DDPGConfig,
               device=None) -> DDPGState:
    """N fresh learners from ``keys [N, 2]`` in one pass: a ``DDPGState``
    with a leading session axis whose session i is ``ddpg_init(keys[i])``
    bit for bit (the draws are made on the CPU, as ``ddpg_init`` makes
    them, then moved). Runs on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    pair = jrandom.split_keys(keys)
    actor = _mlp_init_keys(pair[:, 0], cfg.actor_sizes)
    critic = _mlp_init_keys(pair[:, 1], cfg.critic_sizes)

    def zeros(net):
        return [{k: torch.zeros_like(v) for k, v in layer.items()}
                for layer in net]

    nets = {"actor": actor, "critic": critic, "actor_targ": actor,
            "critic_targ": critic, "actor_mu": zeros(actor),
            "actor_nu": zeros(actor), "critic_mu": zeros(critic),
            "critic_nu": zeros(critic)}
    n = keys.shape[0]
    return DDPGState(
        flat=flatten(nets, cfg).to(device),
        counts=torch.zeros((n, 2), dtype=torch.int32, device=device),
        step=torch.zeros((n,), dtype=torch.int32, device=device))


def _folded_layer(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """``x @ w + b`` per session as an in-order fold of float32 products
    over the inputs: elementwise operations only, so every session's
    outputs are the same bits whatever the number of sessions."""
    products = x[:, :, None] * layer["w"]  # [N, fan_in, fan_out]
    acc = products[:, 0]
    for j in range(1, products.shape[1]):
        acc = acc + products[:, j]
    return acc + layer["b"]


def fleet_act(flat: torch.Tensor, states: torch.Tensor,
              cfg: DDPGConfig) -> torch.Tensor:
    """Deterministic policy actions of every session: the actors of
    ``flat [N, F]`` (or of its first columns, the actor's) on ``states [N,
    k]`` -> ``[N, m]``, where ``flat`` lives. ``MagpieAgent.act`` is this
    function on a fleet of one, so a fleet's session i acts as the single
    agent would, whatever N.

    A batched product is not used, because its sums are not independent
    of N: cuBLAS picks its kernel by the batch count (on an H100, 42 and
    53 of 64 sessions' actions on the 2-D and 8-D spaces changed bits
    between N = 1 and N = 1,024: ``chip_smoke.py``'s fleet phase reports
    it). On a card each layer is an in-order fold of products
    (``_folded_layer``); on the CPU each session runs the single agent's
    own ``[1, k]`` products, one session at a time."""
    layout = state_layout(cfg)
    actor = [{"w": flat[:, wo:wo + fi * fo].reshape(-1, fi, fo),
              "b": flat[:, bo:bo + fo]}
             for (wo, bo), (fi, fo) in zip(layout.offsets[0],
                                           layout.shapes[0])]
    with torch.no_grad():
        if flat.device.type == "cpu":
            return torch.stack([
                actor_apply([{k: v[i] for k, v in layer.items()}
                             for layer in actor], states[i])
                for i in range(flat.shape[0])])
        x = states
        for i, layer in enumerate(actor):
            x = _folded_layer(x, layer)
            if i + 1 < len(actor):
                x = torch.relu(x)
        return torch.sigmoid(x)


def fleet_learn_scan(states: DDPGState, data: tuple, sizes: torch.Tensor,
                     keys: torch.Tensor, cfg: DDPGConfig,
                     num_updates: int, *, windows=None,
                     check_sizes: bool = True) -> tuple:
    """``ddpg_learn_scan`` of every session in ONE learner call.

    Samples the ``[N, num_updates, batch]`` indices from ``keys [N, 2]``
    (threefry, session i bitwise ``sample_minibatch_indices(keys[i], ...,
    sizes[i])``) on the learners' device, gathers every session's
    minibatches in one pass over ``data`` (``(s, a, r, s2)``, each ``[W,
    capacity, ...]``), moves them to the learners' device and runs all
    N x ``num_updates`` updates through ``kernels.ops.ddpg_inner_loop``:
    one launch of the CUDA kernel for a CUDA state, the plain PyTorch loop
    for a CPU state. Session i samples window i, or ``windows[i]`` (an int
    tensor ``[N]``: a cell's merged window, shared replay); ``sizes[i]`` is
    the size of the window it samples. ``states`` is updated IN PLACE and
    returned; metrics are ``[N, num_updates]`` tensors.

    Raises ``ValueError`` if any size is below 1, a check that reads the
    sizes on the host; ``check_sizes=False`` skips it for sizes that stay
    on the device, whose caller guarantees them (the per-step body writes
    before it learns, the resilient body clamps them)."""
    from repro_torch.kernels import ops

    sizes = torch.as_tensor(sizes)
    if check_sizes:
        _require_nonempty(sizes.cpu())
    where, device = data[0].device, states.flat.device
    n = states.flat.shape[0]
    idx = jrandom.randint_keys(keys.to(device), (num_updates, cfg.batch_size),
                               0, sizes.to(device))
    idx = idx.to(device=where, dtype=torch.int64)
    rows = torch.arange(n, device=where) if windows is None else \
        torch.as_tensor(windows).to(device=where, dtype=torch.int64)
    rows = rows[:, None, None]
    batches = tuple(x[rows, idx].to(states.flat.device).contiguous()
                    for x in data)
    metrics = ops.ddpg_inner_loop(states, batches, cfg=cfg)
    return states, {"critic_loss": metrics[:, :, 0],
                    "actor_loss": metrics[:, :, 1],
                    "q_mean": metrics[:, :, 2]}


# ---------------------------------------------------------------------------
# Exploration noise
# ---------------------------------------------------------------------------

class OUNoise:
    """Ornstein-Uhlenbeck process (standard DDPG exploration), with linear
    sigma decay so late tuning steps fine-tune rather than explore (§III-E:
    'Magpie ... then uses additional tuning steps for parameter fine-tuning')."""

    def __init__(self, dim: int, sigma: float = 0.40, theta: float = 0.15,
                 sigma_min: float = 0.05, decay_steps: int = 50, seed: int = 0):
        self.dim = dim
        self.sigma0 = sigma
        self.sigma_min = sigma_min
        self.theta = theta
        self.decay_steps = decay_steps
        self._rng = np.random.default_rng(seed)
        self._x = np.zeros(dim, np.float32)
        self._t = 0

    def reset(self) -> None:
        self._x[...] = 0.0

    def __call__(self) -> np.ndarray:
        frac = min(1.0, self._t / max(1, self.decay_steps))
        sigma = self.sigma0 + frac * (self.sigma_min - self.sigma0)
        self._x += -self.theta * self._x + sigma * self._rng.standard_normal(self.dim)
        self._t += 1
        return self._x.astype(np.float32)

    def state_dict(self) -> dict:
        return {"x": self._x.copy(), "t": self._t,
                "bitgen": self._rng.bit_generator.state}

    def load_state_dict(self, d: dict) -> None:
        self._x[...] = d["x"]
        self._t = int(d["t"])
        self._rng.bit_generator.state = d["bitgen"]
