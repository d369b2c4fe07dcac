"""FIFO replay buffers (paper §II-D), stored on the learner's device.

Limited size; once full, the oldest transition is evicted (FIFO) so the
model neither overfits stale history nor forgets recent experience.
``ReplayBuffer`` is one session's buffer: ``storage()`` hands the full
fixed-capacity tensors plus the live size to the fused learner
(``core.ddpg.ddpg_learn_scan``), which samples and gathers its minibatches
where the tensors live. ``BatchedReplayBuffer`` is the fleet's: one window
per tuning session stacked on a leading session axis, written in lockstep,
with the same FIFO per session, or one merged window per cell of sessions
(``groups``, shared replay).
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
    """N FIFO windows stacked on a leading session axis: float32 ``s [N,
    capacity, k]``, ``a [N, capacity, m]``, ``r [N, capacity]``, ``s2 [N,
    capacity, k]``.

    ``storage_backend="device"`` keeps the tensors on ``device`` (``cuda``
    unless given), where the fleet learner gathers its minibatches;
    ``"host"`` keeps them in CPU tensors (page-locked when ``device`` is a
    card, so that copies to it can run asynchronously): the chunked episode
    runtime (``core.episode.run_fleet_episode_scan``) stages one chunk of
    sessions at a time, so a 1,024-session fleet never holds its whole
    replay pool on the card. Sessions step in lockstep (one ``add`` writes
    one transition per session), so one write cursor serves the fleet and
    each session's eviction order is ``ReplayBuffer``'s. The resilient
    episode drops a corrupted step's write, and where that leaves the
    sessions' cursors apart, ``set_storage`` keeps one cursor per session
    (``cursors()``).

    ``groups`` (one group id per session, numbered 0..G-1, each group a
    contiguous run of sessions) merges the members of each group into ONE
    shared FIFO window (shared replay, ``core.sharing``): the storage
    shrinks to ``[G, capacity, ...]`` with a cursor per group, each ``add``
    appends every member's transition to its group's window in session
    order, and each session samples from its group's whole window, so a
    cell of k sessions keeps one window and every learner sees k x the
    transitions per env step.

    The reference's bfloat16 storage (``storage_dtype``) is not ported: the
    episode kernel keeps its replay window in float32 (ROADMAP A7b); any
    other dtype raises ``NotImplementedError``.
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
        if not _is_float32(storage_dtype):
            raise NotImplementedError(
                f"replay storage in {storage_dtype} is ROADMAP item A7b: the "
                f"episode kernel keeps its replay window in float32")
        self.num_sessions = num_sessions
        self.capacity = capacity
        self.storage_backend = storage_backend
        self.storage_dtype = torch.float32
        self.device = resolve_device(device)
        self.groups = None if groups is None else tuple(
            int(g) for g in groups)
        rows = num_sessions
        if self.groups is not None:
            if len(self.groups) != num_sessions:
                raise ValueError("groups must name one group per session")
            gids = np.asarray(self.groups, np.int64)
            num_groups = int(gids.max()) + 1
            if sorted(set(self.groups)) != list(range(num_groups)):
                raise ValueError("group ids must be consecutive from 0")
            if np.any(np.diff(gids) < 0):
                # the chunked episode slices whole groups out of storage
                raise ValueError("groups must be contiguous session runs")
            self.num_groups = num_groups
            self._gids = gids
            # rank of each session within its group = its append order
            self._gcounts = np.bincount(gids).astype(np.int32)
            self._grank = np.concatenate(
                [np.arange(c) for c in self._gcounts]).astype(np.int64)
            rows = num_groups
        host = storage_backend == "host"
        where = torch.device("cpu") if host else self.device
        pin = host and self.device.type == "cuda"

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=where,
                               pin_memory=pin)

        self._s = zeros(rows, capacity, state_dim)
        self._a = zeros(rows, capacity, action_dim)
        self._r = zeros(rows, capacity)
        self._s2 = zeros(rows, capacity, state_dim)
        if self.groups is None:
            self._next = 0  # next write slot, shared by the lockstep fleet
            self._size = 0
        else:
            self._next = np.zeros(rows, np.int32)
            self._size = np.zeros(rows, np.int32)

    @property
    def rows(self) -> int:
        """Windows held: the sessions, or the groups of a grouped buffer."""
        return self._s.shape[0]

    def __len__(self) -> int:
        return int(np.max(self._size))

    @property
    def nbytes(self) -> int:
        """Bytes of the four stacked tensors (the whole fleet)."""
        return sum(x.numel() * x.element_size()
                   for x in (self._s, self._a, self._r, self._s2))

    def cursors(self) -> tuple:
        """(next slot, size), each an int32 CPU tensor ``[rows]``: one per
        window (session or group)."""
        return tuple(torch.as_tensor(np.broadcast_to(
            np.asarray(x, np.int32), (self.rows,)).copy())
            for x in (self._next, self._size))

    def add(self, state, action, reward, next_state) -> None:
        """Add one transition per session; each argument is ``[N, ...]``."""
        vals = [_f32(v) for v in (state, action, reward, next_state)]
        dsts = (self._s, self._a, self._r, self._s2)
        if self.groups is not None:
            # each member appends to its group's merged window in session
            # order: rank j lands at slot (next[g] + j) % cap, the last
            # member keeping a slot two members reach (a cell larger than
            # the window), as appends one by one would
            slots = (self._next[self._gids] + self._grank) % self.capacity
            for j in range(int(self._gcounts.max())):
                at = np.nonzero(self._grank == j)[0]
                g = torch.as_tensor(self._gids[at])
                p = torch.as_tensor(slots[at])
                for dst, v in zip(dsts, vals):
                    dst[g.to(dst.device), p.to(dst.device)] = \
                        v[torch.as_tensor(at)].to(dst.device)
            self._next = ((self._next + self._gcounts) % self.capacity
                          ).astype(np.int32)
            self._size = np.minimum(self._size + self._gcounts,
                                    self.capacity).astype(np.int32)
            return
        if isinstance(self._next, np.ndarray):  # one cursor per session
            rows = torch.arange(self.rows)
            i = torch.as_tensor(self._next, dtype=torch.int64)
            for dst, v in zip(dsts, vals):
                dst[rows.to(dst.device), i.to(dst.device)] = v.to(dst.device)
            self._next = ((self._next + 1) % self.capacity).astype(np.int32)
            self._size = np.minimum(self._size + 1,
                                    self.capacity).astype(np.int32)
            return
        i = self._next
        for dst, v in zip(dsts, vals):
            dst[:, i] = v
        self._next = (i + 1) % self.capacity  # FIFO eviction once full
        self._size = min(self._size + 1, self.capacity)

    def storage(self):
        """((s, a, r, s2) stacked ``[N, capacity, ...]`` tensors, sizes
        ``[N]``): the tensors where the backend keeps them, the sizes an
        int32 CPU tensor. A grouped buffer hands each session a copy of its
        group's merged window (``x[groups]``)."""
        sizes = self.cursors()[1]
        arrays = (self._s, self._a, self._r, self._s2)
        if self.groups is None:
            return arrays, sizes
        g = torch.as_tensor(self._gids)
        return tuple(x[g.to(x.device)] for x in arrays), sizes[g]

    def grouped_storage(self):
        """((s, a, r, s2) ``[G, capacity, ...]``, next ``[G]``, size
        ``[G]``): the cell-level view the chunked episode stages from and
        drains back to (cells never span chunks). Grouped buffers only."""
        if self.groups is None:
            raise ValueError("grouped_storage() requires groups=")
        return ((self._s, self._a, self._r, self._s2),
                self._next.copy(), self._size.copy())

    def set_storage(self, s, a, r, s2, next_slot, size) -> None:
        """Write back storage that the fleet episode advanced off this
        object. ``next_slot`` and ``size`` are ints or one per window
        (``[rows]``); an ungrouped buffer whose windows' cursors agree
        keeps one lockstep cursor, else one per session."""
        for dst, v in ((self._s, s), (self._a, a), (self._r, r),
                       (self._s2, s2)):
            dst.copy_(_f32(v))
        nxt, sz = (np.broadcast_to(np.asarray(x, np.int32).reshape(-1),
                                   (self.rows,)).copy()
                   for x in (next_slot, size))
        if self.groups is None and (nxt == nxt[0]).all() and \
                (sz == sz[0]).all():
            self._next, self._size = int(nxt[0]), int(sz[0])
        else:
            self._next, self._size = nxt, sz

    def sample(self, keys: torch.Tensor, batch_size: int) -> tuple:
        """Per-session uniform minibatches: ``keys [N, 2]`` -> (s, a, r,
        s2) each ``[N, B, ...]`` float32, the indices bitwise the
        reference's threefry draw, gathered where the storage lives (a
        grouped buffer's sessions from their group's window)."""
        if len(self) == 0:
            raise ValueError("cannot sample from an empty buffer")
        (data, sizes) = self.storage()
        idx = jrandom.randint_keys(keys, (batch_size,), 0, sizes)
        idx = idx.to(device=data[0].device, dtype=torch.int64)
        rows = torch.arange(self.num_sessions, device=idx.device)[:, None]
        return tuple(x[rows, idx] for x in data)

    def as_arrays(self) -> tuple:
        """Valid rows only, as float32 numpy: each ``[N or G, size, ...]``
        (the largest window's size)."""
        n = len(self)
        return tuple(x[:, :n].cpu().numpy()
                     for x in (self._s, self._a, self._r, self._s2))

    def state_dict(self) -> dict:
        """Host copies, for checkpoint/resume of a fleet."""
        def cursor(x):
            return x.copy() if isinstance(x, np.ndarray) else x

        return {"s": self._s.cpu().numpy(), "a": self._a.cpu().numpy(),
                "r": self._r.cpu().numpy(), "s2": self._s2.cpu().numpy(),
                "next": cursor(self._next), "size": cursor(self._size)}

    def load_state_dict(self, d: dict) -> None:
        self.set_storage(d["s"], d["a"], d["r"], d["s2"], d["next"],
                         d["size"])
