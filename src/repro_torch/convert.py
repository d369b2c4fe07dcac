"""Learner weights and episode state carried between the JAX package and
the port.

The reference holds a learner as a pytree: ``DDPGState(actor, critic,
actor_targ, critic_targ, actor_opt, critic_opt, step)`` where each network
is a list of ``{"w": [fan_in, fan_out], "b": [fan_out]}`` layers and each
``*_opt`` is ``(ScaleByAdamState(count, mu, nu), ())``. As numpy (what
``jax.tree_util.tree_map(np.asarray, state)`` and the reference agent's
``state_dict()["ddpg"]`` hold) that tree converts to the port's flat state
and back here. The port keeps the reference's ``[fan_in, fan_out]``
orientation, so no transpose is involved; fields are read by position, so
the reference's NamedTuples and this module's look-alikes both convert.

The episode engine's other state converts the same way, from numpy: the
Lustre model's env state (uint32 key words, warmth, last values) and
parameters, and the replay window (``BufferState``). With these both
packages can step from the same state. So do the LM stack's parameters
(``lm_params_from_jax``), serving cache and AdamW state
(``adamw_state_from_jax``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGConfig, DDPGState, flatten, unflatten
from repro_torch.device import resolve_device


class AdamStateNumpy(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class DDPGStateNumpy(NamedTuple):
    actor: Any
    critic: Any
    actor_targ: Any
    critic_targ: Any
    actor_opt: Any
    critic_opt: Any
    step: Any


def _net_to_torch(net) -> list:
    return [{k: torch.from_numpy(np.array(layer[k], np.float32))
             for k in ("w", "b")} for layer in net]


def ddpg_state_from_numpy(tree, cfg: DDPGConfig, device=None) -> DDPGState:
    """The reference learner tree (numpy leaves) as the port's state."""
    device = resolve_device(device)
    actor, critic, actor_targ, critic_targ, actor_opt, critic_opt, step = tree
    a_adam, c_adam = actor_opt[0], critic_opt[0]
    nets = {"actor": actor, "critic": critic, "actor_targ": actor_targ,
            "critic_targ": critic_targ, "actor_mu": a_adam[1],
            "actor_nu": a_adam[2], "critic_mu": c_adam[1],
            "critic_nu": c_adam[2]}
    flat = flatten({k: _net_to_torch(v) for k, v in nets.items()}, cfg)
    counts = torch.tensor([int(np.asarray(a_adam[0])),
                           int(np.asarray(c_adam[0]))], dtype=torch.int32)
    return DDPGState(flat.to(device), counts.to(device),
                     torch.tensor(int(np.asarray(step)),
                                  dtype=torch.int32, device=device))


def ddpg_state_to_numpy(state: DDPGState, cfg: DDPGConfig) -> DDPGStateNumpy:
    """The port's state as the reference learner tree (numpy leaves)."""
    nets = unflatten(state.flat.detach().cpu(), cfg)

    def np_net(name):
        return [{k: layer[k].numpy().copy() for k in ("w", "b")}
                for layer in nets[name]]

    counts = state.counts.cpu().numpy().astype(np.int32)
    return DDPGStateNumpy(
        actor=np_net("actor"), critic=np_net("critic"),
        actor_targ=np_net("actor_targ"), critic_targ=np_net("critic_targ"),
        actor_opt=(AdamStateNumpy(counts[0], np_net("actor_mu"),
                                  np_net("actor_nu")), ()),
        critic_opt=(AdamStateNumpy(counts[1], np_net("critic_mu"),
                                   np_net("critic_nu")), ()),
        step=np.asarray(state.step.cpu().numpy(), np.int32))


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A threefry key (uint32 words ``[..., 2]``) as the port's int64 words."""
    return torch.as_tensor(np.asarray(key).astype(np.uint32).astype(np.int64),
                           device=resolve_device(device))


def env_state_from_numpy(tree, device=None):
    """The reference's ``LustreEnvState(key, warmth, last_values)`` (numpy
    leaves, any leading axes) as the port's."""
    from repro_torch.envs.lustre_model import LustreEnvState

    key, warmth, last_values = tree
    device = resolve_device(device)
    return LustreEnvState(
        key=key_from_numpy(key, device),
        warmth=torch.as_tensor(np.array(warmth, np.float32), device=device),
        last_values=torch.as_tensor(np.array(last_values, np.float32),
                                    device=device))


def lustre_params_from_numpy(tree, device=None):
    """The reference's ``LustreParams`` (numpy leaves, fields in order)."""
    from repro_torch.envs.lustre_model import LustreParams

    device = resolve_device(device)
    return LustreParams(*(torch.as_tensor(np.array(x, np.float32),
                                          device=device) for x in tree))


def buffer_from_numpy(tree, device=None):
    """The reference's replay window ``BufferState(s, a, r, s2, next_slot,
    size)`` (numpy leaves) as the port's float32 / int32 tensors."""
    from repro_torch.core.episode import BufferState

    device = resolve_device(device)
    s, a, r, s2, next_slot, size = tree
    floats = [torch.as_tensor(np.array(x, np.float32), device=device)
              for x in (s, a, r, s2)]
    ints = [torch.as_tensor(np.array(x, np.int32), device=device)
            for x in (next_slot, size)]
    return BufferState(*floats, *ints)


def _tensor_from_numpy(x, device) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a tensor of
    the same dtype on ``device``; bfloat16 (ml_dtypes) by its bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree, device)


def lm_params_from_jax(tree, device=None) -> dict:
    """The JAX package's LM parameter tree (nested dicts of arrays; numpy
    or jax leaves) as the port's nested dict of tensors on ``device``: any
    family's tree, the hybrid's ``layers.{norm, mamba}`` and
    ``shared_attn.{norm, attn}`` and the ``ssm`` family's ``layers.{tm_norm,
    time_mix, cm_norm}`` (the channel mix's ``cm_*`` inside ``time_mix``)
    too. The layouts are the same (stacked ``[L, ...]`` layers, ``[in,
    ...out]`` projections), so this is a tree walk; dtypes map one to
    one."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_cache_from_jax(tree, device=None) -> dict:
    """The JAX package's serving cache as the port's, on ``device``, dtypes
    kept: ``{"k", "v"}`` of ``[L, B, S_max, Kv, Dh]``, the hybrid's
    ``{"state" [L, B, H, N, P], "conv_x", "conv_bc", "attn_k", "attn_v"}``,
    or the ``ssm`` family's ``{"state" [L, B, H, c, c], "tm_last",
    "cm_last"}``. (After a bf16 prefill off the TPU the JAX package's hybrid
    ``state`` is bf16, where its ``make_cache`` declares float32; the port's
    is always float32, so convert such a cache's state with ``.float()``.
    Both packages leave the ``ssm`` family's state in the compute type after
    a prefill, so it converts as it is.)"""
    return _tree_from_numpy(tree, resolve_device(device))


def adamw_state_from_jax(tree, device=None) -> tuple:
    """The JAX package's optimizer state of a ``chain`` (numpy or jax
    leaves) as the port's, on ``device``: ``ScaleByAdamState(count, mu,
    nu)`` and ``ScaleByScheduleState(count)`` by their fields, the
    stateless members' ``()`` as they are. For ``adamw`` that is
    ``(ScaleByAdamState, (), ())``; with ``lm_params_from_jax`` both
    packages can then step from one state."""
    from repro_torch.optim.transform import ScaleByAdamState, \
        ScaleByScheduleState

    device = resolve_device(device)

    def member(state):
        fields = getattr(state, "_fields", ())
        if fields == ("count", "mu", "nu"):
            return ScaleByAdamState(_tensor_from_numpy(state.count, device),
                                    _tree_from_numpy(state.mu, device),
                                    _tree_from_numpy(state.nu, device))
        if fields == ("count",):
            return ScaleByScheduleState(_tensor_from_numpy(state.count,
                                                           device))
        if state == ():
            return ()
        raise ValueError(f"no port counterpart of optimizer state "
                         f"{type(state).__name__}")

    return tuple(member(s) for s in tree)
