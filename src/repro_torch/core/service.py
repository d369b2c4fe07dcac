"""Persistent fleet serving: leased chunk slots, join and leave at advance
boundaries, checkpointed bitwise resume.

``FleetTuner`` fixes its roster when it is built. Magpie's deployment case,
tuning the live tenants of a shared file system, needs the opposite:
sessions arrive and depart while the fleet keeps tuning. ``FleetService``
runs the streaming chunked fleet episode (``core.episode.
stream_fleet_episode``) as a persistent loop:

  * slots are LEASED: a joining session takes the lowest free slot and
    frees it when it leaves. Every ``advance`` runs the active sessions in
    slot order as ``ceil(active / C)`` chunks of at most C sessions, one
    launch of the episode kernel each; the last chunk runs at its own
    width, so nothing is padded.
  * join and leave are REQUESTS, queued and applied only at ``advance``
    boundaries, so membership never changes inside an episode. A
    session's trajectory derives from its own seed streams and, on the
    card, each session is one block of the kernel, so churn leaves the
    surviving sessions' bits as they were.
  * each session's state (learner and Adam state, replay window and
    cursors, env model state, exploration streams, learner key, decision
    history) checkpoints through ``checkpoint/store.py`` (atomic keep-k,
    a CRC per tensor), so a killed service restores and continues with the
    same bits. A missing or corrupt checkpoint raises (``KeyError``,
    ``IOError``) rather than starting a session afresh.

Sessions of different ages share a launch because the kernel takes each
session's exploration (warmup mask included) and FIFO cursor as its own.

Departures from the reference's service (``repro/core/service.py``): the
evaluations of a boundary are batched. Every session leased at a boundary
has its default configuration evaluated there, all in one
``evaluate_fleet`` call, rather than one by one inside ``request_join``;
and a boundary's leavers are finalized together as ``FleetTuner`` does
(one ``fleet_act`` and ``evaluate_fleet`` of their best and then of their
differing policy configurations). Each env has its own key chain, so the
order of sessions does not change which draws an evaluation consumes. The
learners of a boundary's joiners are drawn there too, by ``fleet_init``
(elementwise in each session's key). No chunk is padded to the lease
width: a launch takes any number of sessions.

The policy layers run each leased chunk through the per-step body, and go
into checkpoints with their state. ``policy`` (a ``core.guardrails.
DeploymentPolicy``) guards every session: a session's ``GuardState`` is
initialized when its boundary evaluates its default configuration.
``resilience`` (a ``core.resilience.ResiliencePolicy``) heals every
session: its ``HealthState`` starts at the boundary that admits it.
``supervisor`` (a ``core.resilience.ChunkSupervisor``, with ``chaos``, an
``envs.faults.HostChaos``) supervises the chunk stream; ``advance`` forces
``on_failure="skip"``, and a chunk that stays dead has its sessions
quarantined through the leave path at the next boundary. ``sharing`` (a
``core.sharing.SharingConfig``) with a cell mode binds sessions of one
workload x objective into cells of ``cell_size`` seats at the boundaries;
a cell's merged window and averaging clock live with the cell and die with
its last member; its observation scopes mask the learners' view.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.checkpoint.store import (
    restore_checkpoint,
    restore_into,
    save_checkpoint,
)
from repro_torch.core.agent import lhs_warmup_plan
from repro_torch.core.ddpg import (
    DDPGConfig,
    DDPGState,
    OUNoise,
    fleet_act,
    fleet_init,
    state_layout,
)
from repro_torch.core.episode import (
    BufferState,
    _host_copy,
    _stacked,
    check_fleet_envs,
    draw_exploration,
    resolve_layers,
    stream_fleet_episode,
)
from repro_torch.core.fleet import (
    evaluate_fleet,
    recommend_final_fleet,
    replay_compact_trace,
)
from repro_torch.core.scalarization import Scalarizer, normalize_state
from repro_torch.core.tuner import StepRecord, TuningResult
from repro_torch.device import resolve_device

_WINDOW = ("s", "a", "r", "s2")


@dataclasses.dataclass
class _Session:
    """One tenant's tuning state, on the host between rounds (its env's
    model state stays where the env runs)."""

    sid: int
    label: str
    workload: str
    weights: dict
    seed: int
    env: object                # ModelEnv (owns model params + model_state)
    scalarizer: Scalarizer
    ddpg: Optional[DDPGState]  # CPU tensors, no session axis; None until
    #                            the boundary that admits the session
    buf: dict                  # {"s","a","r","s2"} CPU tensors + "next","size"
    learn_key: torch.Tensor    # [2] int64, CPU
    noise: OUNoise
    warmup_plan: np.ndarray    # [warmup_steps, m]
    steps_taken: int
    default_config: dict
    default_metrics: dict
    cur_config: dict
    cur_metrics: dict
    best_config: dict
    best_metrics: dict
    best_objective: float
    history: list
    restart_seconds: float
    joined_at: float
    # guardrails (service-wide policy; None when guardrails are off)
    guard: object = None        # core.guardrails.GuardState, numpy leaves
    guard_counters: Optional[dict] = None
    # resilience (service-wide policy; None when resilience is off)
    health: object = None       # core.resilience.HealthState
    health_counters: Optional[dict] = None


class FleetService:
    """A persistent, elastic fleet of Magpie tuning sessions.

    ``chunk`` is the lease width C: the most sessions one launch of the
    episode kernel takes. ``request_join`` / ``request_leave`` queue
    membership changes; ``advance(steps)`` applies the queue at its boundary
    and then runs ``steps`` tuning iterations of every active session.
    ``advance(0)`` is a boundary that only changes membership.

    Each session is seeded exactly as a scan ``FleetTuner.from_grid`` cell
    with the same seed (its learner ``fleet_init`` of ``PRNGKey(seed)`` on
    the CPU, ``OUNoise(seed + 1)``, the warmup plan of ``default_rng(seed +
    2)``, the learner key ``PRNGKey(seed + 3)``, the env
    ``env_factory(workload, seed)``), so a session that joins at the first
    boundary and leaves after the last reproduces the static fleet. A
    leaving session is finalized by the §III-E rule (``recommend_final``'s,
    batched as ``FleetTuner`` does) and its ``TuningResult`` kept for
    ``result(sid)``.

    ``device`` is where the sessions run: ``cuda`` unless given, so
    without a card the caller must pass ``"cpu"``. ``env_factory(workload,
    seed)`` defaults to ``env_cls(workload, seed=seed).to_model_env(
    device=device)`` with ``env_cls=LustreSimEnv``.

    ``policy`` (``core.guardrails.DeploymentPolicy``) guards every session;
    ``guardrail_stats(sid)``, ``last_stats["guardrails"]`` (the advance's
    counters summed over its sessions) and each departed session's
    ``TuningResult.guardrail_stats`` report it. ``resilience`` heals every
    session (``health_stats(sid)``, ``TuningResult.health_stats``);
    ``supervisor`` and ``chaos`` supervise the chunk stream, and
    ``last_stats`` then holds ``supervisor`` and ``quarantined`` (the sids
    of chunks that stayed dead, which leave at the next boundary);
    ``sharing`` with ``cell_size`` runs cells (``chunk`` must be a multiple
    of ``cell_size``, so cells never span chunks). With every layer off the
    service runs the episode kernel, bitwise the service without them.
    """

    def __init__(self, *, chunk: int, env_factory=None, env_cls=None,
                 ddpg_config: Optional[DDPGConfig] = None,
                 buffer_capacity: int = 64, warmup_steps: int = 8,
                 eval_runs: int = 3, overlap: bool = True,
                 checkpoint_dir: Optional[str] = None, keep: int = 3,
                 policy=None, sharing=None, cell_size: int = 1,
                 resilience=None, supervisor=None, chaos=None,
                 device=None):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        layers = resolve_layers(policy, resilience, None, sharing,
                                cell_size)
        if supervisor is not None:
            from repro_torch.core.resilience import normalize_supervisor
            supervisor = normalize_supervisor(supervisor)
        if layers.cells and chunk % layers.cell_size != 0:
            raise ValueError(
                f"chunk ({chunk}) must be a multiple of cell_size "
                f"({layers.cell_size}) so cells never span chunk programs")
        if env_factory is not None and env_cls is not None:
            raise ValueError("pass env_factory OR env_cls, not both")
        self.device = resolve_device(device)
        if env_factory is None:
            from repro_torch.envs.lustre_sim import LustreSimEnv
            cls_ = env_cls or LustreSimEnv

            def env_factory(workload, seed):
                return cls_(workload, seed=seed).to_model_env(
                    device=self.device)
        self.chunk = int(chunk)
        self.env_factory = env_factory
        self.cfg = ddpg_config
        self.buffer_capacity = buffer_capacity
        self.warmup_steps = warmup_steps
        self.eval_runs = eval_runs
        self.overlap = overlap
        self.checkpoint_dir = checkpoint_dir
        self.keep = keep
        self.policy = policy
        self.resilience = layers.resilience
        # a chunk that keeps failing is skipped, and its sessions leave at
        # the next boundary (advance forces on_failure="skip")
        self.supervisor = supervisor
        self.chaos = chaos
        self.sharing = layers.sharing
        self.cell_size = layers.cell_size
        self._layers = layers
        self._cells: dict = {}      # cell id -> {key, seats, steps, buf}
        self._next_cell = 0
        self._obs_mask = None       # resolved from the first env
        self.total_steps = 0
        self._slots: list = []          # slot index -> sid or None (leases)
        self._sessions: dict = {}       # sid -> _Session (leased only)
        self._join_queue: list = []     # _Session, in request order
        self._leave_queue: list = []    # sid, in request order
        self._completed: dict = {}      # sid -> TuningResult
        self._next_sid = 0
        self.last_stats: dict = {}

    # -- membership requests ------------------------------------------------

    def request_join(self, workload: str, weights: Mapping[str, float],
                     seed: int, label: Optional[str] = None) -> int:
        """Queue a new tuning session; it is leased at the next boundary,
        which also draws its learner and evaluates its default
        configuration. Returns its sid."""
        sid = self._next_sid
        self._next_sid += 1
        if label is None:
            label = f"{workload}|{'+'.join(sorted(weights))}|seed{seed}"
        self._join_queue.append(
            self._new_session(sid, workload, dict(weights), seed, label))
        return sid

    def request_leave(self, sid: int) -> None:
        """Queue a session's departure; finalized at the next boundary."""
        if sid not in self._sessions and \
                all(s.sid != sid for s in self._join_queue):
            raise KeyError(f"unknown or already-finished session {sid}")
        if sid not in self._leave_queue:
            self._leave_queue.append(sid)

    def result(self, sid: int) -> TuningResult:
        """The ``TuningResult`` of a departed session."""
        if sid not in self._completed:
            raise KeyError(f"session {sid} has not left (or never existed)")
        return self._completed[sid]

    @property
    def active(self) -> dict:
        """{sid: label} of currently leased sessions."""
        return {sid: s.label for sid, s in self._sessions.items()}

    def lease_table(self) -> list:
        """slot index -> sid (or None): the service's chunk-row leases."""
        return list(self._slots)

    def _session_guardrail_stats(self, sess: _Session) -> Optional[dict]:
        if self.policy is None:
            return None
        from repro_torch.core.guardrails import empty_counters, \
            guardrail_stats
        return guardrail_stats(self.policy, sess.guard,
                               sess.guard_counters or empty_counters(),
                               space=sess.env.param_space)

    def guardrail_stats(self, sid: int) -> Optional[dict]:
        """An ACTIVE session's guardrail record (None when off)."""
        if sid not in self._sessions:
            raise KeyError(f"session {sid} is not active")
        return self._session_guardrail_stats(self._sessions[sid])

    def _session_health_stats(self, sess: _Session) -> Optional[dict]:
        if self.resilience is None:
            return None
        from repro_torch.core.resilience import empty_health_counters, \
            health_stats
        return health_stats(self.resilience, sess.health,
                            sess.health_counters or empty_health_counters())

    def health_stats(self, sid: int) -> Optional[dict]:
        """An ACTIVE session's health record (None when off)."""
        if sid not in self._sessions:
            raise KeyError(f"session {sid} is not active")
        return self._session_health_stats(self._sessions[sid])

    # -- session construction ------------------------------------------------

    def _new_session(self, sid, workload, weights, seed, label) -> _Session:
        """A session with its env, scalarizer and exploration streams; its
        learner and default evaluation come at the boundary
        (``_apply_requests``)."""
        env = self.env_factory(workload, seed)
        if self.cfg is None:
            self.cfg = DDPGConfig.for_env(env)
        cap, k, m = self.buffer_capacity, self.cfg.state_dim, \
            self.cfg.action_dim
        buf = {"s": torch.zeros((cap, k)), "a": torch.zeros((cap, m)),
               "r": torch.zeros((cap,)), "s2": torch.zeros((cap, k)),
               "next": 0, "size": 0}
        default_config = env.param_space.default_config()
        return _Session(
            sid=sid, label=label, workload=workload, weights=weights,
            seed=seed, env=env,
            scalarizer=Scalarizer(weights=weights, specs=env.metric_specs),
            ddpg=None, buf=buf, learn_key=jrandom.PRNGKey(seed + 3),
            noise=OUNoise(m, seed=seed + 1),
            warmup_plan=lhs_warmup_plan(
                np.random.default_rng(seed + 2), self.warmup_steps, m),
            steps_taken=0, default_config=dict(default_config),
            default_metrics={}, cur_config=dict(default_config),
            cur_metrics={}, best_config=dict(default_config),
            best_metrics={}, best_objective=float("-inf"), history=[],
            restart_seconds=0.0, joined_at=time.perf_counter())

    def _draw_learners(self, sessions: Sequence[_Session]) -> None:
        """The learners of ``sessions``: ``fleet_init`` on the CPU, a lease
        width of keys at a time, as a host-store ``FleetAgent`` draws
        them; with resilience each session's health state starts here, on
        its fresh learner."""
        keys = torch.stack([jrandom.PRNGKey(s.seed) for s in sessions])
        for i in range(0, len(sessions), self.chunk):
            part = fleet_init(keys[i:i + self.chunk], self.cfg, "cpu")
            for j, s in enumerate(sessions[i:i + self.chunk]):
                s.ddpg = DDPGState(*(x[j] for x in part))
        if self.resilience is not None:
            from repro_torch.core.resilience import init_health_state
            for s in sessions:
                s.health = init_health_state(s.ddpg, self.resilience)

    def _evaluate_defaults(self, sessions: Sequence[_Session]) -> None:
        """The default configurations of ``sessions``, evaluated in one
        ``evaluate_fleet``; with a policy, each session's guard starts on
        its default configuration and objective."""
        metrics = evaluate_fleet([s.env for s in sessions],
                                 [s.default_config for s in sessions],
                                 self.eval_runs)
        for s, m in zip(sessions, metrics):
            s.default_metrics = dict(m)
            s.cur_metrics = dict(m)
            s.best_metrics = dict(m)
            s.best_objective = s.scalarizer.objective(m)
            if self.policy is not None:
                from repro_torch.core.guardrails import init_guard_state
                s.guard = init_guard_state(s.env.param_space,
                                           s.default_config,
                                           s.best_objective)

    # -- boundary: apply the request queue -----------------------------------

    def _apply_requests(self) -> dict:
        """Apply the queue: admit the joiners, finalize the leavers (a
        session that joined and left within this boundary is finalized
        without a lease), free their slots, then lease the joiners in
        request order to the lowest free slots. Returns the boundary's
        seconds by part."""
        t0 = time.perf_counter()
        if self._join_queue:
            self._draw_learners(self._join_queue)
            t_learners = time.perf_counter()
            self._evaluate_defaults(self._join_queue)
        else:
            t_learners = t0
        t1 = time.perf_counter()
        leaving = []
        for sid in self._leave_queue:
            if sid in self._sessions:
                leaving.append(self._sessions.pop(sid))
                self._slots[self._slots.index(sid)] = None
            else:  # joined and left within one boundary: never leased
                sess = next(s for s in self._join_queue if s.sid == sid)
                self._join_queue.remove(sess)
                leaving.append(sess)
        self._leave_queue = []
        self._finalize(leaving)
        t2 = time.perf_counter()
        for sess in self._join_queue:
            if None in self._slots:
                self._slots[self._slots.index(None)] = sess.sid
            else:
                self._slots.append(sess.sid)
            self._sessions[sess.sid] = sess
        self._join_queue = []
        if self._layers.cells:
            self._bind_cells()
        return {"join_learners": t_learners - t0,
                "join_evaluations": t1 - t_learners,
                "leave_finalizations": t2 - t1}

    # -- cell topology (experience sharing) ----------------------------------

    @staticmethod
    def _cell_key(sess: _Session) -> tuple:
        return (sess.workload, tuple(sorted(sess.weights.items())))

    def _new_cell_buf(self) -> dict:
        cap, k, m = self.buffer_capacity, self.cfg.state_dim, \
            self.cfg.action_dim
        return {"s": torch.zeros((cap, k)), "a": torch.zeros((cap, m)),
                "r": torch.zeros((cap,)), "s2": torch.zeros((cap, k)),
                "next": 0, "size": 0}

    def _bind_cells(self) -> None:
        """Re-bind cell membership at a boundary (cell modes only).

        A cell is ``cell_size`` seats keyed by (workload, objective):
        departing sessions free their seat, joining sessions take the
        lowest free seat of the lowest matching cell (or found a new cell).
        Seats, not slots, fix a member's lane in the cell body, so the
        surviving members keep their lanes across churn. A cell whose last
        member leaves is dropped WITH its merged window: experience belongs
        to the tenants that made it."""
        for cid in sorted(self._cells):
            rec = self._cells[cid]
            rec["seats"] = [sid if sid in self._sessions else None
                            for sid in rec["seats"]]
            if all(sid is None for sid in rec["seats"]):
                del self._cells[cid]
        seated = {sid for rec in self._cells.values()
                  for sid in rec["seats"] if sid is not None}
        for sid in sorted(self._sessions):  # sid order: deterministic
            if sid in seated:
                continue
            key = self._cell_key(self._sessions[sid])
            for cid in sorted(self._cells):
                rec = self._cells[cid]
                if rec["key"] == key and None in rec["seats"]:
                    rec["seats"][rec["seats"].index(None)] = sid
                    break
            else:
                buf = (self._new_cell_buf()
                       if self.sharing.shared_replay else None)
                self._cells[self._next_cell] = {
                    "key": key,
                    "seats": [sid] + [None] * (self.cell_size - 1),
                    "steps": 0, "buf": buf}
                self._next_cell += 1

    def _finalize(self, sessions: Sequence[_Session]) -> None:
        """The §III-E final recommendation of departing sessions, batched as
        ``FleetTuner._finish``: the policy's exploit-mode actions by
        ``fleet_act``, then ``recommend_final_fleet``."""
        if not sessions:
            return
        actor_floats = state_layout(self.cfg).offsets[1][0][0]
        flat = torch.stack([s.ddpg.flat[:actor_floats]
                            for s in sessions]).to(self.device)
        states = np.stack([normalize_state(s.cur_metrics,
                                           s.env.metric_specs,
                                           s.env.state_metrics)
                           for s in sessions])
        x = torch.as_tensor(np.asarray(states, np.float32),
                            device=self.device)
        actions = np.clip(fleet_act(flat, x, self.cfg).cpu().numpy(), 0.0,
                          1.0).astype(np.float32)
        policy_configs = [s.env.param_space.to_config(a)
                          for s, a in zip(sessions, actions)]
        finals = recommend_final_fleet(
            [s.env for s in sessions], [s.scalarizer for s in sessions],
            [s.best_config for s in sessions], policy_configs,
            self.eval_runs)
        now = time.perf_counter()
        for s, (config, metrics, _) in zip(sessions, finals):
            self._completed[s.sid] = TuningResult(
                best_config=config,
                best_objective=s.scalarizer.objective(metrics),
                best_metrics=metrics,
                default_config=dict(s.default_config),
                default_metrics=dict(s.default_metrics),
                history=list(s.history),
                simulated_restart_seconds=float(s.restart_seconds),
                wall_seconds=now - s.joined_at,
                guardrail_stats=self._session_guardrail_stats(s),
                health_stats=self._session_health_stats(s))

    # -- the serving loop ----------------------------------------------------

    def advance(self, steps: int) -> list:
        """One boundary, then ``steps`` tuning iterations of every active
        session. Returns the sids that advanced (slot order).

        ``last_stats`` then holds ``boundary_seconds`` (``join_learners``,
        ``join_evaluations``, ``leave_finalizations``), ``sessions`` and
        ``steps``, and where
        sessions ran: ``chunk``, ``num_chunks``, ``overlap``,
        ``padded_sessions`` (0), ``peak_device_bytes``,
        ``session_steps_per_sec``, ``launch_device_seconds`` (CUDA events on
        the card; empty on the CPU), ``staging`` (``stream_chunks``'s
        measurements), ``cell_size`` and ``sharing``; with a policy,
        ``guardrails`` (this advance's counters summed over its sessions);
        with a supervisor, ``supervisor`` (its stats) and ``quarantined``
        (the sids of the chunks it skipped: they keep their state from
        before the advance and leave at the next boundary, the survivors'
        bits as they were)."""
        boundary = self._apply_requests()
        order = [sid for sid in self._slots if sid is not None]
        self.last_stats = {"boundary_seconds": boundary,
                           "sessions": len(order), "steps": steps,
                           "num_chunks": 0}
        if not order or steps <= 0:
            return []
        quarantined = self._advance_sessions(
            [self._sessions[sid] for sid in order], steps)
        self.total_steps += steps
        for sid in quarantined:
            self.request_leave(sid)
        return order

    def _rows(self, sessions: Sequence[_Session]) -> tuple:
        """The rows the episode runs and whether each is a session's own
        (primary): ``sessions`` in slot order, or with cells the cells'
        seats in cell order, a vacant seat riding as an inactive replica of
        its cell's first live member (it computes, but never writes to the
        merged window, weighs nothing in the mean, and its results are
        discarded), so a ragged cell runs as a full one."""
        if not self._layers.cells:
            return list(sessions), [True] * len(sessions), []
        rows, primary, row_cells = [], [], []
        for cid in sorted(self._cells):
            rec = self._cells[cid]
            live = [sid for sid in rec["seats"] if sid is not None]
            for sid in rec["seats"]:
                rows.append(self._sessions[live[0] if sid is None else sid])
                primary.append(sid is not None)
                row_cells.append(cid)
        return rows, primary, row_cells

    def _advance_sessions(self, sessions: Sequence[_Session],
                          steps: int) -> list:
        """One ``steps``-long episode segment of ``sessions`` (slot order)
        through ``stream_fleet_episode``: each session's exploration drawn
        at its own age, its window with its own FIFO cursor (with shared
        replay, its cell's); then each session's state written back and
        its history rebuilt from the compact trace
        (``replay_compact_trace``). Returns the sids to quarantine: the
        sessions of chunks the supervisor skipped, whose state stays as it
        was before the advance."""
        t0 = time.perf_counter()
        layers = self._layers
        check_fleet_envs([s.env for s in sessions], self.device)
        pin = self.device.type == "cuda"
        exploration = {}
        for s in sessions:
            exploration[s.sid] = draw_exploration(
                s.warmup_plan, s.noise, s.steps_taken, self.warmup_steps,
                steps)
            s.steps_taken += steps
        rows, primary, row_cells = self._rows(sessions)
        n = len(rows)
        if self.sharing is not None and \
                self.sharing.observation_scopes is not None and \
                self._obs_mask is None:
            from repro_torch.core.sharing import resolve_obs_mask
            env0 = rows[0].env
            self._obs_mask = resolve_obs_mask(
                self.sharing, env0.metric_specs, env0.state_metrics)
        ddpg = DDPGState(*(_stacked([getattr(s.ddpg, f) for s in rows],
                                    pin) for f in DDPGState._fields))
        owners = ([self._cells[cid]["buf"] for cid in sorted(self._cells)]
                  if layers.shared_replay else [s.buf for s in rows])
        buffer = BufferState(
            *(_stacked([b[key] for b in owners], pin) for key in _WINDOW),
            *(_host_copy(np.array([b[key] for b in owners], np.int32),
                         pin) for key in ("next", "size")))
        learn_keys = _stacked([s.learn_key for s in rows], pin)
        cells = None
        if layers.cells:
            # the averaging cadence fires on each CELL's own step clock,
            # whatever its members' ages
            avg_now = np.zeros((n, steps), bool)
            if self.sharing.averaging:
                every = self.sharing.avg_every
                for j, cid in enumerate(row_cells):
                    avg_now[j] = ((self._cells[cid]["steps"]
                                   + np.arange(steps) + 1) % every) == 0
            cells = (avg_now, np.broadcast_to(
                np.asarray(primary, bool)[:, None], (n, steps)))
        guard = health = None
        if self.policy is not None:
            from repro_torch.core.guardrails import empty_counters, \
                guard_row, guard_to_numpy, guard_to_torch, \
                guardrail_counters, merge_counters, stack_guards
            guard = guard_to_torch(stack_guards([s.guard for s in rows]),
                                   pin=pin)
            round_counters = empty_counters()
        if self.resilience is not None:
            from repro_torch.core.resilience import empty_health_counters, \
                health_counters, health_row, health_to_numpy, \
                health_to_torch, merge_health_counters, stack_health
            health = health_to_torch(stack_health([s.health for s in rows]),
                                     pin=pin)
        sup = self.supervisor
        if sup is not None and sup.on_failure != "skip":
            # a persistent service survives a dead chunk: quarantine, never
            # crash
            sup = sup._replace(on_failure="skip")
        trace, stats = stream_fleet_episode(
            [s.env for s in rows], [s.scalarizer for s in rows],
            [s.cur_metrics for s in rows],
            [exploration[s.sid] for s in rows], ddpg, buffer, learn_keys,
            cfg=self.cfg, steps=steps, chunk=self.chunk,
            overlap=self.overlap, device=self.device, policy=self.policy,
            guard=guard, resilience=self.resilience, health=health,
            obs_mask=self._obs_mask, sharing=self.sharing,
            cell_size=self.cell_size, cells=cells, supervisor=sup,
            chaos=self.chaos, primary=primary)
        wall = time.perf_counter() - t0
        per_step = wall / max(1, steps)
        failed_rows: set = set()
        quarantined: list = []
        if "supervisor" in stats:
            c = stats["chunk"]
            for ci in stats["supervisor"]["failed_chunks"]:
                failed_rows.update(range(ci * c, min(n, (ci + 1) * c)))
            quarantined = sorted({rows[j].sid for j in failed_rows
                                  if primary[j]})
        if layers.shared_replay:
            for g, cid in enumerate(sorted(self._cells)):
                cb = self._cells[cid]["buf"]
                for key, x in zip(_WINDOW, buffer):
                    cb[key] = x[g]
                cb["next"] = int(buffer.next_slot[g])
                cb["size"] = int(buffer.size[g])
        for cid in self._cells:
            self._cells[cid]["steps"] += steps
        if guard is not None:
            guard = guard_to_numpy(guard)
        if health is not None:
            health = health_to_numpy(health)
        for j, s in enumerate(rows):
            if not primary[j] or j in failed_rows:
                # a vacant seat's replica, or a skipped chunk's row whose
                # drain never ran: nothing to write back
                continue
            if guard is not None:
                s.guard = guard_row(guard, j)
                delta = guardrail_counters(trace.guard_events[j],
                                           trace.restarts[j])
                s.guard_counters = merge_counters(
                    s.guard_counters or empty_counters(), delta)
                round_counters = merge_counters(round_counters, delta)
            if health is not None:
                s.health = health_row(health, j)
                s.health_counters = merge_health_counters(
                    s.health_counters or empty_health_counters(),
                    health_counters(trace.health_events[j]))
            s.ddpg = DDPGState(*(x[j] for x in ddpg))
            if not layers.shared_replay:
                for key, x in zip(_WINDOW, buffer):
                    s.buf[key] = x[j]
                s.buf["next"] = int(buffer.next_slot[j])
                s.buf["size"] = int(buffer.size[j])
            s.learn_key = learn_keys[j]
            rep = replay_compact_trace(
                s.env, trace, j, start=len(s.history), per_step=per_step,
                prev_config=s.cur_config, best_objective=s.best_objective,
                restart_seconds=s.restart_seconds,
                finite_baseline=self.resilience is not None)
            s.history.extend(rep["records"])
            s.restart_seconds = rep["restart_seconds"]
            if rep["best"] is not None:
                s.best_objective = rep["best"]["objective"]
                s.best_config = dict(rep["best"]["config"])
                s.best_metrics = dict(rep["best"]["metrics"])
            s.cur_config = rep["cur_config"]
            if rep["cur_metrics"] is not None:
                s.cur_metrics = rep["cur_metrics"]
        self.last_stats.update(
            chunk=stats["chunk"], num_chunks=stats["num_chunks"],
            overlap=self.overlap, padded_sessions=0,
            peak_device_bytes=stats["peak_device_bytes"],
            session_steps_per_sec=len(sessions) * steps / max(wall, 1e-9),
            launch_device_seconds=stats["launch_device_seconds"],
            staging=stats["staging"], cell_size=self.cell_size,
            sharing=self.sharing)
        if guard is not None:
            self.last_stats["guardrails"] = round_counters
        if "supervisor" in stats:
            self.last_stats["supervisor"] = stats["supervisor"]
            self.last_stats["quarantined"] = list(quarantined)
        return quarantined

    # -- checkpoint / restore ------------------------------------------------

    @staticmethod
    def _tree(s: _Session) -> dict:
        """A session's tensors, as the checkpoint stores them. The learner,
        window and key are copies: between advances they are rows of the
        last advance's stacked tensors, whose whole storage ``torch.save``
        would write."""
        tree = {"ddpg": DDPGState(*(x.clone() for x in s.ddpg)),
                "buffer": {key: s.buf[key].clone() for key in _WINDOW},
                "env_params": s.env.params.vector(),
                "env_state": s.env.model_state,
                "learn_key": s.learn_key.clone(),
                "noise_x": torch.from_numpy(s.noise.state_dict()["x"]),
                "warmup_plan": torch.from_numpy(s.warmup_plan)}
        if s.guard is not None:
            for name in ("live_action", "fallback_action"):
                tree[f"guard_{name}"] = torch.from_numpy(
                    np.array(getattr(s.guard, name), np.float32))
        if s.health is not None and len(s.health.snapshot):
            # the last-good learner: a resumed session resets to the SAME
            # state
            tree["health_snapshot"] = DDPGState(
                *(x.clone() for x in s.health.snapshot))
        return tree

    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Write the whole service state through ``checkpoint/store.py``
        (keep-k, as ``keep`` says) and return the step's directory.

        Call at a boundary: pending join or leave requests belong to the
        NEXT boundary, not to durable state, so they raise instead of being
        dropped. Departed sessions' results were handed to their callers
        and are not stored."""
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise ValueError("no checkpoint directory configured")
        if self._join_queue or self._leave_queue:
            raise RuntimeError(
                "pending join/leave requests; apply them first with "
                "advance() (advance(0) is a membership-only boundary)")
        tree, extra = {"sessions": {}}, {
            "chunk": self.chunk, "warmup_steps": self.warmup_steps,
            "buffer_capacity": self.buffer_capacity,
            "eval_runs": self.eval_runs, "overlap": bool(self.overlap),
            "keep": self.keep, "total_steps": self.total_steps,
            "next_sid": self._next_sid,
            "policy": (dict(self.policy._asdict())
                       if self.policy is not None else None),
            "resilience": (dict(self.resilience._asdict())
                           if self.resilience is not None else None),
            "supervisor": (dict(self.supervisor._asdict())
                           if self.supervisor is not None else None),
            "sharing": (dict(self.sharing._asdict())
                        if self.sharing is not None else None),
            "cell_size": self.cell_size, "next_cell": self._next_cell,
            # the cell topology: key and seat order are durable state, a
            # member's lane in the cell body must survive a resume
            "cells": {str(cid): {
                "workload": rec["key"][0],
                "weights": [[k, v] for k, v in rec["key"][1]],
                "seats": [(-1 if sid is None else sid)
                          for sid in rec["seats"]],
                "steps": rec["steps"],
                "buf_next": (rec["buf"]["next"]
                             if rec["buf"] is not None else -1),
                "buf_size": (rec["buf"]["size"]
                             if rec["buf"] is not None else -1),
            } for cid, rec in self._cells.items()},
            "slots": [(-1 if s is None else s) for s in self._slots],
            "cfg": ({**self.cfg._asdict(), "hidden": list(self.cfg.hidden)}
                    if self.cfg is not None else None),
            "sessions": {}}
        tree["cells"] = {str(cid): {key: rec["buf"][key].clone()
                                    for key in _WINDOW}
                         for cid, rec in self._cells.items()
                         if rec["buf"] is not None}
        for sid, s in self._sessions.items():
            tree["sessions"][str(sid)] = self._tree(s)
            nd = s.noise.state_dict()
            extra["sessions"][str(sid)] = {
                "label": s.label, "workload": s.workload,
                "weights": s.weights, "seed": s.seed,
                "steps_taken": s.steps_taken,
                "buffer_next": s.buf["next"], "buffer_size": s.buf["size"],
                "noise_t": nd["t"], "noise_bitgen": nd["bitgen"],
                "default_config": s.default_config,
                "default_metrics": s.default_metrics,
                "cur_config": s.cur_config, "cur_metrics": s.cur_metrics,
                "best_config": s.best_config, "best_metrics": s.best_metrics,
                "best_objective": s.best_objective,
                "restart_seconds": s.restart_seconds,
                "restart_events": [[sc, sec]
                                   for sc, sec in s.env.restart_events],
                "last_config": s.env._last_config,
                "history": [dataclasses.asdict(r) for r in s.history],
            }
            if s.guard is not None:
                extra["sessions"][str(sid)]["guard"] = {
                    "fallback_obj": float(s.guard.fallback_obj),
                    "budget_spent": float(s.guard.budget_spent),
                    "watch_left": int(s.guard.watch_left),
                    "promotions": int(s.guard.promotions),
                    "rollbacks": int(s.guard.rollbacks),
                    "counters": dict(s.guard_counters or {}),
                }
            if s.health is not None:
                extra["sessions"][str(sid)]["health"] = {
                    "resets": int(s.health.resets),
                    "nonfinite": int(s.health.nonfinite),
                    "degraded": bool(s.health.degraded),
                    "since_snap": int(s.health.since_snap),
                    "counters": dict(s.health_counters or {}),
                }
        return save_checkpoint(directory, self.total_steps, tree,
                               keep=self.keep, extra=extra)

    @classmethod
    def restore(cls, directory: str, *, env_factory=None, env_cls=None,
                step: Optional[int] = None, fallback: bool = False,
                device=None) -> "FleetService":
        """Rebuild a service from a checkpoint of this package, with the
        same bits.

        Environments are rebuilt by ``env_factory(workload, seed)`` and must
        be the definition the checkpoint was taken with: the restored model
        params are held equal to the rebuilt ones, and a mismatch raises
        ``ValueError`` ("drifted"). The tensors are CRC-verified by the
        store and restored through ``restore_into`` onto the rebuilt
        templates, so a missing leaf raises ``KeyError``.

        ``fallback=True`` survives a corrupted newest checkpoint by walking
        the keep-k history to the newest verifiable step (the restored
        service's ``total_steps`` says how far back it reached). The
        service comes back with its layers: the policy and every session's
        guard and counters, the resilience policy and every session's
        health state (its snapshot included), the supervisor, and the
        sharing config with its cells (their seats, clocks and merged
        windows). Chaos is a test's plan and is not stored."""
        step, flat, extra = restore_checkpoint(directory, step,
                                               fallback=fallback)
        cfg = None
        if extra["cfg"] is not None:
            cfg_d = dict(extra["cfg"])
            cfg_d["hidden"] = tuple(cfg_d["hidden"])
            cfg = DDPGConfig(**cfg_d)
        policy = resilience = supervisor = sharing = None
        if extra.get("policy") is not None:
            from repro_torch.core.guardrails import DeploymentPolicy, \
                GuardState, init_guard_state
            policy = DeploymentPolicy(**extra["policy"])
        if extra.get("resilience") is not None:
            from repro_torch.core.resilience import HealthState, \
                ResiliencePolicy, init_health_state
            resilience = ResiliencePolicy(**extra["resilience"])
        if extra.get("supervisor") is not None:
            from repro_torch.core.resilience import ChunkSupervisor
            supervisor = ChunkSupervisor(**extra["supervisor"])
        if extra.get("sharing") is not None:
            from repro_torch.core.sharing import SharingConfig
            sh = dict(extra["sharing"])
            if sh.get("observation_scopes") is not None:
                sh["observation_scopes"] = tuple(sh["observation_scopes"])
            sharing = SharingConfig(**sh)
        svc = cls(chunk=extra["chunk"], env_factory=env_factory,
                  env_cls=env_cls, ddpg_config=cfg,
                  buffer_capacity=extra["buffer_capacity"],
                  warmup_steps=extra["warmup_steps"],
                  eval_runs=extra["eval_runs"], overlap=extra["overlap"],
                  checkpoint_dir=directory, keep=extra["keep"],
                  policy=policy, sharing=sharing,
                  cell_size=extra.get("cell_size", 1),
                  resilience=resilience, supervisor=supervisor,
                  device=device)
        svc.total_steps = extra["total_steps"]
        svc._next_sid = extra["next_sid"]
        svc._slots = [None if s < 0 else int(s) for s in extra["slots"]]
        svc._next_cell = extra.get("next_cell", 0)
        layout = state_layout(svc.cfg) if svc.cfg is not None else None
        leaves: dict = {}  # (sessions | cells, id) -> its flat tensors
        for key, v in flat.items():
            top, id_s, leaf = key.split("/", 2)
            leaves.setdefault((top, id_s), {})[leaf] = v
        for cid_s, cm in extra.get("cells", {}).items():
            buf = None
            if cm["buf_next"] >= 0:
                buf = svc._new_cell_buf()
                restored = restore_into({key: buf[key] for key in _WINDOW},
                                        leaves.get(("cells", cid_s), {}))
                buf.update(restored)
                buf["next"] = int(cm["buf_next"])
                buf["size"] = int(cm["buf_size"])
            svc._cells[int(cid_s)] = {
                "key": (cm["workload"],
                        tuple((k, v) for k, v in cm["weights"])),
                "seats": [None if sid < 0 else int(sid)
                          for sid in cm["seats"]],
                "steps": int(cm["steps"]), "buf": buf}
        for sid_s, meta in extra["sessions"].items():
            sid = int(sid_s)
            s = svc._new_session(sid, meta["workload"], dict(meta["weights"]),
                                 meta["seed"], meta["label"])
            s.ddpg = DDPGState(torch.zeros(layout.floats),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros((), dtype=torch.int32))
            if policy is not None:  # the template's guard leaves
                s.guard = init_guard_state(s.env.param_space,
                                           s.default_config, 0.0)
            if resilience is not None:  # the template's snapshot
                s.health = init_health_state(s.ddpg, svc.resilience)
            restored = restore_into(svc._tree(s),
                                    leaves.get(("sessions", sid_s), {}))
            if not torch.equal(restored["env_params"],
                               s.env.params.vector()):
                raise ValueError(
                    f"session {sid}: environment definition drifted: the "
                    "rebuilt model params differ from the checkpoint's")
            s.ddpg = restored["ddpg"]
            for key in _WINDOW:
                s.buf[key] = restored["buffer"][key]
            s.buf["next"] = int(meta["buffer_next"])
            s.buf["size"] = int(meta["buffer_size"])
            s.env.model_state = restored["env_state"]
            s.learn_key = restored["learn_key"]
            s.noise.load_state_dict({
                "x": restored["noise_x"].numpy(), "t": meta["noise_t"],
                "bitgen": meta["noise_bitgen"]})
            s.warmup_plan = restored["warmup_plan"].numpy()
            s.steps_taken = int(meta["steps_taken"])
            s.default_config = dict(meta["default_config"])
            s.default_metrics = dict(meta["default_metrics"])
            s.cur_config = dict(meta["cur_config"])
            s.cur_metrics = dict(meta["cur_metrics"])
            s.best_config = dict(meta["best_config"])
            s.best_metrics = dict(meta["best_metrics"])
            s.best_objective = float(meta["best_objective"])
            s.restart_seconds = float(meta["restart_seconds"])
            s.env.restart_events = [
                (sc, sec) for sc, sec in meta["restart_events"]]
            s.env._last_config = dict(meta["last_config"])
            s.history = [StepRecord(**r) for r in meta["history"]]
            if policy is not None:
                gm = meta["guard"]
                s.guard = GuardState(
                    live_action=restored["guard_live_action"].numpy(),
                    fallback_action=restored["guard_fallback_action"].numpy(),
                    fallback_obj=np.float32(gm["fallback_obj"]),
                    budget_spent=np.float32(gm["budget_spent"]),
                    watch_left=np.int32(gm["watch_left"]),
                    promotions=np.int32(gm["promotions"]),
                    rollbacks=np.int32(gm["rollbacks"]))
                s.guard_counters = dict(gm["counters"])
            if resilience is not None:
                hm = meta["health"]
                s.health = HealthState(
                    snapshot=restored.get("health_snapshot", ()),
                    resets=np.int32(hm["resets"]),
                    nonfinite=np.int32(hm["nonfinite"]),
                    degraded=np.bool_(hm["degraded"]),
                    since_snap=np.int32(hm["since_snap"]))
                s.health_counters = dict(hm["counters"])
            svc._sessions[sid] = s
        return svc

