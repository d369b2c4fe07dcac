"""MagpieAgent — the paper's agent: act (policy + exploration), observe, learn.

Combines the DDPG learner (``core.ddpg``), the FIFO replay buffer (§II-D)
and the exploration noise. Key chain as in the reference: the learner is
initialized from ``PRNGKey(seed)`` and the minibatch indices come from
``PRNGKey(seed + 3)``, split once per ``learn``; the OU noise and the
Latin-hypercube warmup draw from numpy Generators seeded ``seed + 1`` and
``seed + 2``. So a port agent and a reference agent with the same seed make
the same warmup decisions and sample the same minibatches.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import random as jrandom
from repro_torch.core.ddpg import (
    DDPGConfig,
    OUNoise,
    ddpg_init,
    ddpg_learn_scan,
    fleet_act,
)
from repro_torch.core.replay_buffer import ReplayBuffer
from repro_torch.device import resolve_device


def lhs_warmup_plan(rng: np.random.Generator, warmup_steps: int,
                    action_dim: int) -> np.ndarray:
    """Latin-hypercube warmup plan: each warmup step lands in a distinct
    1/warmup_steps interval of every action coordinate."""
    plan = np.empty((warmup_steps, action_dim), np.float32)
    for j in range(action_dim):
        perm = rng.permutation(warmup_steps)
        plan[:, j] = (perm + rng.uniform(size=warmup_steps)) / max(
            1, warmup_steps)
    return plan


class MagpieAgent:
    def __init__(self, cfg: DDPGConfig, buffer_capacity: int = 64,
                 seed: int = 0, warmup_steps: int = 8, device=None):
        """``warmup_steps``: initial stratified (Latin-hypercube) exploratory
        actions before the policy takes over. ``device``: where the learner
        and the replay buffer live; ``cuda`` unless given."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.warmup_steps = warmup_steps
        self.state = ddpg_init(jrandom.PRNGKey(seed), cfg, self.device)
        self.buffer = ReplayBuffer(buffer_capacity, cfg.state_dim,
                                   cfg.action_dim, self.device)
        self.noise = OUNoise(cfg.action_dim, seed=seed + 1)
        self._np_rng = np.random.default_rng(seed + 2)
        self._learn_key = jrandom.PRNGKey(seed + 3)  # minibatch RNG
        self.steps_taken = 0
        self.last_metrics: dict = {}
        self._warmup_plan = lhs_warmup_plan(self._np_rng, warmup_steps,
                                            cfg.action_dim)

    # -- acting -------------------------------------------------------------

    def act(self, state: np.ndarray, explore: bool = True) -> np.ndarray:
        """Action in [0,1]^m for the given normalized metric state."""
        if explore and self.steps_taken < self.warmup_steps:
            a = self._warmup_plan[self.steps_taken]
        else:
            x = torch.as_tensor(np.asarray(state, np.float32),
                                device=self.device)
            a = fleet_act(self.state.flat[None], x[None],
                          self.cfg)[0].cpu().numpy()
            if explore:
                a = a + self.noise()
        self.steps_taken += 1
        return np.clip(a, 0.0, 1.0).astype(np.float32)

    # -- learning -----------------------------------------------------------

    def observe(self, state, action, reward, next_state) -> None:
        self.buffer.add(state, action, float(reward), next_state)

    def learn(self, updates: Optional[int] = None, fused: bool = True) -> dict:
        """Run ``updates`` (default cfg.updates_per_step) minibatch gradient
        steps in ONE learner call (``ddpg_learn_scan``: the CUDA kernel on
        the card). The reference's ``fused=False`` per-update loop was a
        benchmark baseline and is not ported."""
        if not fused:
            raise NotImplementedError(
                "the per-update learner loop (fused=False) is not ported; "
                "use the fused learner")
        if len(self.buffer) == 0:
            return {}  # learning before the first observe() is a no-op
        n = self.cfg.updates_per_step if updates is None else updates
        if n <= 0:
            return {}
        self._learn_key, key = jrandom.split(self._learn_key)
        data, size = self.buffer.storage()
        self.state, metrics = ddpg_learn_scan(self.state, data, size, key,
                                              self.cfg, n)
        self.last_metrics = {k: float(v[-1]) for k, v in metrics.items()}
        return self.last_metrics

    # -- persistence (resume tuning) ----------------------------------------

    def state_dict(self) -> dict:
        """Host copies. ``"ddpg"`` is in the reference's learner-tree
        layout (``convert.ddpg_state_to_numpy``)."""
        return {
            "ddpg": convert.ddpg_state_to_numpy(self.state, self.cfg),
            "buffer": self.buffer.state_dict(),
            "noise": self.noise.state_dict(),
            "np_rng": self._np_rng.bit_generator.state,
            "learn_key": self._learn_key.numpy().astype(np.uint32),
            "steps_taken": self.steps_taken,
            "cfg": tuple(self.cfg),
        }

    def load_state_dict(self, d: dict) -> None:
        if tuple(self.cfg) != tuple(d["cfg"]):
            raise ValueError("agent config mismatch on resume")
        self.state = convert.ddpg_state_from_numpy(d["ddpg"], self.cfg,
                                                  self.device)
        self.buffer.load_state_dict(d["buffer"])
        self.noise.load_state_dict(d["noise"])
        self._np_rng.bit_generator.state = d["np_rng"]
        self._learn_key = torch.as_tensor(
            np.asarray(d["learn_key"]).astype(np.int64))
        self.steps_taken = int(d["steps_taken"])

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)

    def load(self, path: str) -> None:
        with open(path, "rb") as f:
            self.load_state_dict(pickle.load(f))
