"""FIFO replay buffers (paper §II-D), stored on the learner's device.

Limited size; once full, the oldest transition is evicted (FIFO) so the
model neither overfits stale history nor forgets recent experience.
``ReplayBuffer`` is one session's buffer: ``storage()`` hands the full
fixed-capacity tensors plus the live size to the fused learner
(``core.ddpg.ddpg_learn_scan``), which samples and gathers its minibatches
where the tensors live. ``BatchedReplayBuffer`` is the fleet's: one window
per tuning session stacked on a leading session axis, written in lockstep,
with the same FIFO per session.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.device import resolve_device


def _f32(x) -> torch.Tensor:
    """A transition field narrowed through float32 (its wire precision)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


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


class BatchedReplayBuffer:
    """N independent FIFO windows stacked on a leading session axis:
    float32 ``s [N, capacity, k]``, ``a [N, capacity, m]``, ``r [N,
    capacity]``, ``s2 [N, capacity, k]``.

    ``storage_backend="device"`` keeps the tensors on ``device`` (``cuda``
    unless given), where the fleet learner gathers its minibatches;
    ``"host"`` keeps them in CPU tensors (page-locked when ``device`` is a
    card, so that copies to it can run asynchronously): the chunked episode
    runtime (``core.episode.run_fleet_episode_scan``) stages one chunk of
    sessions at a time, so a 1,024-session fleet never holds its whole
    replay pool on the card. Sessions step in lockstep (one ``add`` writes
    one transition per session), so one write cursor serves the fleet and
    each session's eviction order is ``ReplayBuffer``'s.

    The reference's bfloat16 storage (``storage_dtype``) and merged cell
    windows (``groups``) are not ported: the episode kernel keeps its replay
    window in float32 (ROADMAP A7b), and shared replay belongs to the
    policy layers (ROADMAP A10b). Both raise ``NotImplementedError``.
    """

    def __init__(self, num_sessions: int, capacity: int, state_dim: int,
                 action_dim: int, storage_dtype=torch.float32,
                 storage_backend: str = "device", groups=None, device=None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if num_sessions <= 0:
            raise ValueError("num_sessions must be positive")
        if storage_backend not in ("device", "host"):
            raise ValueError(f"unknown storage_backend {storage_backend!r}")
        if groups is not None:
            raise NotImplementedError(
                "merged cell windows (groups=...) belong to shared replay, "
                "ROADMAP item A10b, not yet in repro_torch")
        if not _is_float32(storage_dtype):
            raise NotImplementedError(
                f"replay storage in {storage_dtype} is ROADMAP item A7b: the "
                f"episode kernel keeps its replay window in float32")
        self.num_sessions = num_sessions
        self.capacity = capacity
        self.storage_backend = storage_backend
        self.storage_dtype = torch.float32
        self.device = resolve_device(device)
        host = storage_backend == "host"
        where = torch.device("cpu") if host else self.device
        pin = host and self.device.type == "cuda"

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=where,
                               pin_memory=pin)

        self._s = zeros(num_sessions, capacity, state_dim)
        self._a = zeros(num_sessions, capacity, action_dim)
        self._r = zeros(num_sessions, capacity)
        self._s2 = zeros(num_sessions, capacity, state_dim)
        self._next = 0  # next write slot, shared by the lockstep fleet
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @property
    def nbytes(self) -> int:
        """Bytes of the four stacked tensors (the whole fleet)."""
        return sum(x.numel() * x.element_size()
                   for x in (self._s, self._a, self._r, self._s2))

    def add(self, state, action, reward, next_state) -> None:
        """Add one transition per session; each argument is ``[N, ...]``."""
        i = self._next
        for dst, v in ((self._s, state), (self._a, action),
                       (self._r, reward), (self._s2, next_state)):
            dst[:, i] = _f32(v)
        self._next = (i + 1) % self.capacity  # FIFO eviction once full
        self._size = min(self._size + 1, self.capacity)

    def storage(self):
        """((s, a, r, s2) stacked ``[N, capacity, ...]`` tensors, sizes
        ``[N]``): the tensors where the backend keeps them, the sizes an
        int32 CPU tensor."""
        sizes = torch.full((self.num_sessions,), self._size,
                           dtype=torch.int32)
        return (self._s, self._a, self._r, self._s2), sizes

    def set_storage(self, s, a, r, s2, next_slot: int, size: int) -> None:
        """Write back storage that the fleet episode advanced off this
        object (it streams the windows chunk by chunk and syncs the shared
        cursor here)."""
        for dst, v in ((self._s, s), (self._a, a), (self._r, r),
                       (self._s2, s2)):
            dst.copy_(_f32(v))
        self._next = int(next_slot)
        self._size = int(size)

    def sample(self, keys: torch.Tensor, batch_size: int) -> tuple:
        """Per-session uniform minibatches: ``keys [N, 2]`` -> (s, a, r,
        s2) each ``[N, B, ...]`` float32, the indices bitwise the
        reference's threefry draw, gathered where the storage lives."""
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = jrandom.randint_keys(keys, (batch_size,), 0, self._size)
        idx = idx.to(device=self._s.device, dtype=torch.int64)
        rows = torch.arange(self.num_sessions, device=idx.device)[:, None]
        return tuple(x[rows, idx] for x in (self._s, self._a, self._r,
                                              self._s2))

    def as_arrays(self) -> tuple:
        """Valid rows only, as float32 numpy: each ``[N, size, ...]``."""
        return tuple(x[:, :self._size].cpu().numpy()
                     for x in (self._s, self._a, self._r, self._s2))

    def state_dict(self) -> dict:
        """Host copies, for checkpoint/resume of a fleet."""
        return {"s": self._s.cpu().numpy(), "a": self._a.cpu().numpy(),
                "r": self._r.cpu().numpy(), "s2": self._s2.cpu().numpy(),
                "next": self._next, "size": self._size}

    def load_state_dict(self, d: dict) -> None:
        self.set_storage(d["s"], d["a"], d["r"], d["s2"], d["next"],
                         d["size"])
