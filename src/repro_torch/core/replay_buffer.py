"""FIFO replay buffer (paper §II-D), stored on the learner's device.

Limited size; once full, the oldest transition is evicted (FIFO) so the
model neither overfits stale history nor forgets recent experience.
``storage()`` hands the full fixed-capacity tensors plus the live size to
the fused learner (``core.ddpg.ddpg_learn_scan``), which samples and gathers
its minibatches where the tensors live. The fleet's batched buffer is not
ported yet (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 device=None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.device = resolve_device(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self._s = zeros(capacity, state_dim)
        self._a = zeros(capacity, action_dim)
        self._r = zeros(capacity)
        self._s2 = zeros(capacity, state_dim)
        self._next = 0  # next write slot
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, state, action, reward, next_state) -> None:
        i = self._next
        for dst, v in ((self._s, state), (self._a, action),
                       (self._r, reward), (self._s2, next_state)):
            dst[i] = torch.as_tensor(np.asarray(v, np.float32))
        self._next = (i + 1) % self.capacity  # FIFO eviction once full
        self._size = min(self._size + 1, self.capacity)

    def storage(self):
        """((s, a, r, s2) full-capacity tensors, size) for the fused learner.

        The tensors keep a fixed ``[capacity, ...]`` shape (zeros past
        ``size``); ``size`` restricts sampling to valid rows."""
        return (self._s, self._a, self._r, self._s2), self._size

    def set_storage(self, s, a, r, s2, next_slot: int, size: int) -> None:
        """Write back storage that the episode engine advanced on the
        device (it keeps the FIFO window for a whole episode and syncs it
        here once)."""
        for dst, v in ((self._s, s), (self._a, a), (self._r, r),
                       (self._s2, s2)):
            dst.copy_(torch.as_tensor(v, dtype=torch.float32))
        self._next = int(next_slot)
        self._size = int(size)

    def state_dict(self) -> dict:
        """Host copies, for checkpoint/resume of a tuning session."""
        return {"s": self._s.cpu().numpy(), "a": self._a.cpu().numpy(),
                "r": self._r.cpu().numpy(), "s2": self._s2.cpu().numpy(),
                "next": self._next, "size": self._size}

    def load_state_dict(self, d: dict) -> None:
        for dst, key in ((self._s, "s"), (self._a, "a"), (self._r, "r"),
                         (self._s2, "s2")):
            dst.copy_(torch.as_tensor(np.asarray(d[key], np.float32)))
        self._next = int(d["next"])
        self._size = int(d["size"])
