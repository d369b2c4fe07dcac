"""The port's experience sharing (``core/sharing.py``, the cell body of
``core/episode.py::stepwise_episode``, ``BatchedReplayBuffer(groups=...)``,
the sharing ``FleetTuner`` and ``FleetService``), on the CPU, inside the
port: the reference's ``tests/test_shared_experience.py``, case for case,
and a cell larger than its window. The comparisons with the JAX package are
in ``tests/test_torch_sharing_reference.py``.

Held, each measured before it was pinned:

* sharing off (``None``, or a config whose every mode is off) runs the
  episode kernel, BITWISE the fleet without it;
* the degenerate cells are exact identities: a shared-replay cell of one
  session and an averaging cadence that never fires give the independent
  fleet's histories BITWISE, on the 2-D and the 8-D space (on the CPU the
  per-step body equals the episode kernel's plain version);
* the merged window interleaves the members' transitions in session order,
  bit for bit; a cell larger than its window (colliding slots) equals a
  sequential walk of its members' writes;
* chunks of whole cells are bitwise the monolithic run; the chunk is
  rounded up to whole cells;
* observation scopes mask only the learner's view: a scoped fleet of one
  equals the scoped ``Tuner`` bitwise;
* the grouped buffer validates its cells, merges, wraps and round-trips;
  ``memory_plan`` divides the replay bytes by the cell size and matches
  the live tensors;
* the sharing service equals the static sharing fleet bitwise, resumes
  bitwise, and a cell dies with its last member.

The reference's random-space parity runs on ``SyntheticSurfaceModel``
(ROADMAP A5's rest, not ported); the port's runs random seeds and lengths
of both Lustre spaces. Its benchmark helpers belong to the port's
benchmark PR.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.kernels.ops as ops
from repro_torch.core import (
    DDPGConfig,
    FleetService,
    FleetTuner,
    MagpieAgent,
    Scalarizer,
    SharingConfig,
    Tuner,
    last_fleet_run_stats,
    memory_plan,
    normalize_sharing,
)
from repro_torch.core.replay_buffer import BatchedReplayBuffer
from repro_torch.envs import LustreSimEnv, LustreSimV2
from repro_torch.envs.metrics import scope_mask

W = {"throughput": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The sessions' learners are tiny: one intra-op thread runs them
    fastest, and the suite's parallel workers do not oversubscribe the
    cores. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(env_cls=LustreSimEnv, seeds=(0, 1), workloads=("seq_write",),
           sharing=None, chunk=None, updates=4, warmup=3, capacity=16):
    cfg = DDPGConfig.for_env(env_cls(workloads[0]), updates_per_step=updates)
    return FleetTuner.from_grid(
        list(workloads), [W], list(seeds), env_cls=env_cls, engine="scan",
        ddpg_config=cfg, eval_runs=1, warmup_steps=warmup,
        buffer_capacity=capacity, chunk=chunk, sharing=sharing,
        device="cpu")


def _records(result):
    return [(h.step, h.config, h.metrics, h.objective, h.reward,
             h.restart_seconds) for h in result.history]


def _assert_same(a, b):
    assert _records(a) == _records(b)
    assert a.best_config == b.best_config
    assert a.best_objective == b.best_objective
    assert a.default_metrics == b.default_metrics


# ---------------------------------------------------------------------------
# SharingConfig normalization
# ---------------------------------------------------------------------------

def test_normalize_sharing_canonicalizes_off_to_none():
    assert normalize_sharing(None) is None
    assert normalize_sharing(SharingConfig()) is None
    assert normalize_sharing(SharingConfig(avg_every=math.inf)) is None
    assert normalize_sharing(SharingConfig(avg_every=0)) is None
    # opt-state averaging without an averaging cadence is no mode at all
    assert normalize_sharing(SharingConfig(avg_opt_state=True)) is None
    with pytest.raises(TypeError):
        normalize_sharing({"shared_replay": True})


def test_normalize_sharing_sorts_scopes_for_hash_identity():
    a = normalize_sharing(SharingConfig(observation_scopes=("OST", "OSC")))
    b = normalize_sharing(SharingConfig(observation_scopes=("OSC", "OST")))
    assert a == b and a.observation_scopes == ("OSC", "OST")
    on = normalize_sharing(SharingConfig(shared_replay=True, avg_every=4.0))
    assert on.shared_replay and on.avg_every == 4 and on.averaging


# ---------------------------------------------------------------------------
# Sharing off == the path without it, bit for bit
# ---------------------------------------------------------------------------

def test_sharing_off_runs_the_episode_kernel_bitwise(monkeypatch):
    seen = []
    kernel = ops.episode_inner_loop
    monkeypatch.setattr(ops, "episode_inner_loop",
                        lambda *a, **k: seen.append(1) or kernel(*a, **k))
    base = _fleet().run(5)
    off = _fleet(sharing=SharingConfig(avg_every=math.inf)).run(5)
    stats = last_fleet_run_stats()
    assert len(seen) == 2  # one launch a run, both runs
    assert stats["sharing"] is None and stats["cell_size"] == 1
    for ra, rb in zip(base.results, off.results):
        _assert_same(ra, rb)


# ---------------------------------------------------------------------------
# Degenerate cells == independent fleet (2-D and 8-D)
# ---------------------------------------------------------------------------

def _check_degenerate_parity(env_cls, sharing, seeds, workloads):
    ind = _fleet(env_cls, seeds=seeds, workloads=workloads).run(6)
    shr = _fleet(env_cls, seeds=seeds, workloads=workloads,
                 sharing=sharing).run(6)
    assert last_fleet_run_stats()["sharing"] == normalize_sharing(sharing)
    for ra, rb in zip(ind.results, shr.results):
        _assert_same(ra, rb)


@pytest.mark.parametrize("env_cls", [LustreSimEnv, LustreSimV2])
def test_shared_replay_cell_of_one_matches_independent(env_cls):
    """A one-session cell's merged window IS its own window: the merged
    write collapses to the FIFO write and the merged sampling to the
    session's own, so the histories are the independent fleet's bits."""
    _check_degenerate_parity(
        env_cls, SharingConfig(shared_replay=True), (0,),
        ("seq_write", "random_rw"))


@pytest.mark.parametrize("env_cls", [LustreSimEnv, LustreSimV2])
def test_averaging_that_never_fires_matches_independent(env_cls):
    """``avg_every`` longer than the run: the cell mean never applies, so
    the histories are the independent fleet's."""
    _check_degenerate_parity(
        env_cls, SharingConfig(avg_every=10_000, avg_opt_state=True),
        (0, 1), ("seq_write",))


# ---------------------------------------------------------------------------
# Merged FIFO: session-order interleave of member transitions, bit for bit
# ---------------------------------------------------------------------------

def test_merged_window_interleaves_member_transitions():
    steps, k = 3, 2  # all-warmup steps: both arms run identical actions
    ind = _fleet(seeds=(0, 1), warmup=4)
    shr = _fleet(seeds=(0, 1), warmup=4,
                 sharing=SharingConfig(shared_replay=True))
    ind.run(steps), shr.run(steps)

    (ms, ma, mr, ms2), nxt, sizes = shr.agent.buffer.grouped_storage()
    (bs, ba, br, bs2), isizes = ind.agent.buffer.storage()
    assert ms.shape[0] == 1 and bs.shape[0] == 2
    assert int(sizes[0]) == steps * k and int(nxt[0]) == steps * k
    for t in range(steps):
        for j in range(k):  # env step t, member j -> merged slot t*k + j
            for m, b in ((ms, bs), (ma, ba), (mr, br), (ms2, bs2)):
                assert torch.equal(m[0, t * k + j], b[j, t])


def test_cell_larger_than_its_window_equals_a_sequential_walk():
    """Cells of 3 over windows of 2 slots: two members of a cell reach one
    slot every step, and the later member keeps it, as appending the
    members' transitions one by one (the grouped buffer's ``add``) does."""
    seeds, steps = (0, 1, 2), 4
    ind = _fleet(seeds=seeds, warmup=steps + 1, capacity=2)
    shr = _fleet(seeds=seeds, warmup=steps + 1, capacity=2,
                 sharing=SharingConfig(shared_replay=True))
    ind.run(steps), shr.run(steps)
    walk = BatchedReplayBuffer(3, 2, 12, 2, groups=[0, 0, 0],
                               storage_backend="host", device="cpu")
    (bs, ba, br, bs2), _ = ind.agent.buffer.storage()
    # the independent windows (capacity 2) hold the last 2 steps; replay
    # the whole run's rows from a wide enough copy instead
    wide = _fleet(seeds=seeds, warmup=steps + 1, capacity=steps)
    wide.run(steps)
    (ws, wa, wr, ws2), _ = wide.agent.buffer.storage()
    for t in range(steps):
        walk.add(ws[:, t], wa[:, t], wr[:, t], ws2[:, t])
    (gs, ga, gr, gs2), gnext, gsize = shr.agent.buffer.grouped_storage()
    (es, ea, er, es2), enext, esize = walk.grouped_storage()
    for got, want in ((gs, es), (ga, ea), (gr, er), (gs2, es2)):
        assert torch.equal(got, want)
    assert list(gnext) == list(enext) and list(gsize) == list(esize) == [2]


# ---------------------------------------------------------------------------
# Chunking stays pure scheduling under sharing
# ---------------------------------------------------------------------------

def test_chunked_matches_monolithic_under_sharing():
    sharing = SharingConfig(shared_replay=True, avg_every=2,
                            avg_opt_state=True)
    mono = _fleet(seeds=(0, 1), workloads=("seq_write", "random_rw"),
                  sharing=sharing)
    chunked = _fleet(seeds=(0, 1), workloads=("seq_write", "random_rw"),
                     sharing=sharing, chunk=2)
    rm, rc = mono.run(6), chunked.run(6)
    stats = last_fleet_run_stats()
    assert stats["chunk"] == 2 and stats["num_chunks"] == 2
    for a, b in zip(rm.results, rc.results):
        _assert_same(a, b)
    for x, y in zip(mono.agent.states, chunked.agent.states):
        assert torch.equal(x, y)


def test_chunk_is_rounded_up_to_whole_cells():
    sharing = SharingConfig(shared_replay=True)
    fleet = _fleet(seeds=(0, 1, 2), workloads=("seq_write", "random_rw"),
                   sharing=sharing, chunk=2)
    fleet.run(2)
    assert last_fleet_run_stats()["chunk"] == 3  # cells of 3 never split


def test_sharing_needs_whole_cells_and_the_scan_engine():
    from repro_torch.core import FleetAgent
    env = LustreSimEnv("seq_write")
    cfg = DDPGConfig.for_env(env, updates_per_step=2)
    with pytest.raises(ValueError, match="scan"):
        FleetTuner.from_grid(["seq_write"], [W], [0, 1], env_cls=LustreSimEnv,
                             engine="host", ddpg_config=cfg,
                             sharing=SharingConfig(shared_replay=True),
                             device="cpu")
    envs = [LustreSimEnv("seq_write", seed=s).to_model_env(device="cpu")
            for s in range(3)]
    scals = [Scalarizer(weights=W, specs=e.metric_specs) for e in envs]
    agent = FleetAgent(cfg, [0, 1, 2], device="cpu", store="host")
    with pytest.raises(ValueError, match="whole cells"):
        FleetTuner(envs, scals, agent, engine="scan", cell_size=2,
                   sharing=SharingConfig(avg_every=2), device="cpu")
    with pytest.raises(ValueError, match="grouped"):
        FleetTuner(envs, scals, agent, engine="scan", cell_size=3,
                   sharing=SharingConfig(shared_replay=True), device="cpu")


# ---------------------------------------------------------------------------
# DIAL observation scopes: the learner's view, nothing else
# ---------------------------------------------------------------------------

def test_scope_mask_resolves_compound_scopes_and_rejects_unknown():
    env = LustreSimV2("seq_write")
    for scopes in (("OSC",), ("MDS",)):
        mask = scope_mask(env.metric_specs, env.state_metrics, scopes)
        names = [n for n, v in zip(env.state_metrics, mask) if v]
        assert 0 < len(names) < len(env.state_metrics)
        for n in names:  # '&'-joined scopes are visible to every part
            assert set(scopes) & set(env.metric_specs[n].scope.split("&"))
    with pytest.raises(ValueError, match="unknown metric scopes"):
        scope_mask(env.metric_specs, env.state_metrics, ["QUORUM"])


def test_scoped_fleet_of_one_matches_scoped_tuner():
    seed, steps = 5, 8
    sharing = SharingConfig(observation_scopes=("OSC",))

    env = LustreSimV2("seq_write", seed=seed).to_model_env(device="cpu")
    scal = Scalarizer(weights=W, specs=env.metric_specs)
    agent = MagpieAgent(DDPGConfig.for_env(env, updates_per_step=4),
                        seed=seed, warmup_steps=3, buffer_capacity=16,
                        device="cpu")
    single = Tuner(env, scal, agent, engine="scan", eval_runs=1,
                   observation_scopes=("OSC",), device="cpu").run(steps)

    cfg = DDPGConfig.for_env(LustreSimV2("seq_write"), updates_per_step=4)
    fleet = FleetTuner.from_grid(
        ["seq_write"], [W], [seed], env_cls=LustreSimV2, engine="scan",
        ddpg_config=cfg, eval_runs=1, warmup_steps=3, buffer_capacity=16,
        sharing=sharing, device="cpu")
    got = fleet.run(steps).results[0]
    _assert_same(single, got)


def test_scoped_tuner_differs_from_full_state_tuner():
    def run(scopes):
        env = LustreSimV2("seq_write", seed=2).to_model_env(device="cpu")
        scal = Scalarizer(weights=W, specs=env.metric_specs)
        agent = MagpieAgent(DDPGConfig.for_env(env, updates_per_step=4),
                            seed=2, warmup_steps=2, buffer_capacity=16,
                            device="cpu")
        return Tuner(env, scal, agent, engine="scan", eval_runs=1,
                     observation_scopes=scopes, device="cpu").run(10)

    full, scoped = run(None), run(("OSC",))
    assert any(h.config != g.config
               for h, g in zip(full.history, scoped.history))


def test_observation_scopes_validation():
    from repro_torch.core import DeploymentPolicy
    env = LustreSimV2("seq_write", seed=0).to_model_env(device="cpu")
    scal = Scalarizer(weights=W, specs=env.metric_specs)
    agent = MagpieAgent(DDPGConfig.for_env(env), device="cpu")
    with pytest.raises(ValueError, match="scan"):
        Tuner(env, scal, agent, engine="host",
              observation_scopes=("OSC",), device="cpu")
    with pytest.raises(ValueError, match="compose"):
        Tuner(env, scal, agent, engine="scan", policy=DeploymentPolicy(),
              observation_scopes=("OSC",), device="cpu")
    with pytest.raises(ValueError, match="unknown metric scopes"):
        Tuner(env, scal, agent, engine="scan",
              observation_scopes=("QUORUM",), device="cpu")


# ---------------------------------------------------------------------------
# Grouped replay buffer: topology validation + merge semantics
# ---------------------------------------------------------------------------

def test_grouped_buffer_validates_cell_topology():
    with pytest.raises(ValueError, match="one group per session"):
        BatchedReplayBuffer(3, 4, 2, 1, groups=[0, 0], device="cpu")
    with pytest.raises(ValueError, match="consecutive"):
        BatchedReplayBuffer(2, 4, 2, 1, groups=[0, 2], device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        BatchedReplayBuffer(4, 4, 2, 1, groups=[0, 1, 0, 1], device="cpu")


def test_grouped_buffer_merges_adds_and_expands_views():
    buf = BatchedReplayBuffer(4, 8, 2, 1, groups=[0, 0, 1, 1],
                              storage_backend="host", device="cpu")
    for t in range(3):
        v = np.arange(4, dtype=np.float32) + 10 * t
        buf.add(np.stack([v, v]).T, v[:, None], v, np.stack([v, v]).T)
    (gs, _, gr, _), nxt, sizes = buf.grouped_storage()
    assert gs.shape == (2, 8, 2) and list(nxt) == [6, 6]
    assert list(sizes) == [6, 6] and len(buf) == 6
    # session order within the group, env-step major: [t0s0, t0s1, t1s0...]
    assert gr[0, :6].tolist() == [0, 1, 10, 11, 20, 21]
    assert gr[1, :6].tolist() == [2, 3, 12, 13, 22, 23]
    # the per-session expansion: every member sees its group's window
    (es, _, er, _), esizes = buf.storage()
    assert es.shape == (4, 8, 2) and esizes.tolist() == [6, 6, 6, 6]
    assert torch.equal(er[0], er[1]) and torch.equal(er[2], er[3])
    assert not torch.equal(er[0], er[2])
    # sample draws each session's minibatch from its group's window
    from repro_torch import random as jrandom
    keys = torch.stack([jrandom.PRNGKey(s) for s in range(4)])
    _, _, r, _ = buf.sample(keys, 16)
    assert set(r[0].tolist()) <= {0, 1, 10, 11, 20, 21}
    assert set(r[3].tolist()) <= {2, 3, 12, 13, 22, 23}


def test_grouped_buffer_fifo_wraps_per_group():
    buf = BatchedReplayBuffer(2, 4, 1, 1, groups=[0, 0],
                              storage_backend="host", device="cpu")
    for t in range(3):  # 6 adds into 4 slots: first 2 evicted
        v = np.array([2 * t, 2 * t + 1], np.float32)
        buf.add(v[:, None], v[:, None], v, v[:, None])
    (_, _, gr, _), nxt, sizes = buf.grouped_storage()
    assert list(sizes) == [4] and list(nxt) == [2]
    assert gr[0].tolist() == [4, 5, 2, 3]  # wrapped FIFO


def test_grouped_buffer_set_storage_roundtrip():
    buf = BatchedReplayBuffer(4, 4, 2, 1, groups=[0, 0, 1, 1],
                              storage_backend="host", device="cpu")
    v = np.ones((4, 2), np.float32)
    buf.add(v, v[:, :1], v[:, 0], v)
    (s, a, r, s2), nxt, sizes = buf.grouped_storage()
    twin = BatchedReplayBuffer(4, 4, 2, 1, groups=[0, 0, 1, 1],
                               storage_backend="host", device="cpu")
    twin.set_storage(s, a, r, s2, nxt, sizes)
    (ts, _, tr, _), tn, tsz = twin.grouped_storage()
    assert torch.equal(ts, s) and torch.equal(tr, r)
    assert list(tn) == list(nxt) and list(tsz) == list(sizes)
    twin.load_state_dict(buf.state_dict())
    assert list(twin.grouped_storage()[2]) == list(sizes)


def test_ungrouped_buffer_keeps_divergent_cursors():
    """Cursors that a resilient run left apart stay one per session; equal
    cursors fold back into the lockstep one."""
    buf = BatchedReplayBuffer(2, 4, 1, 1, device="cpu")
    z = torch.zeros(2, 4)
    buf.set_storage(z[..., None], z[..., None], z, z[..., None],
                    torch.tensor([1, 2]), torch.tensor([1, 2]))
    buf.add(np.ones((2, 1)), np.ones((2, 1)), np.ones(2), np.ones((2, 1)))
    nxt, size = buf.cursors()
    assert nxt.tolist() == [2, 3] and size.tolist() == [2, 3]
    assert buf.storage()[0][2][0, 1] == 1 and buf.storage()[0][2][1, 2] == 1
    assert buf.storage()[1].tolist() == [2, 3] and len(buf) == 3
    buf.set_storage(*buf.storage()[0], 3, 3)
    assert buf._next == 3 and buf._size == 3


# ---------------------------------------------------------------------------
# memory_plan models merged cell buffers (and matches the live tensors)
# ---------------------------------------------------------------------------

def test_memory_plan_divides_replay_bytes_by_cell_size():
    env = LustreSimV2("seq_write")
    cfg = DDPGConfig.for_env(env)
    kw = dict(sessions=8, steps=8, capacity=64)
    ind = memory_plan(cfg, env.param_space, **kw)
    mrg = memory_plan(cfg, env.param_space, cell_size=4, **kw)
    assert (mrg["per_session"]["replay_bytes"]
            == ind["per_session"]["replay_bytes"] // 4)
    assert mrg["cell_size"] == 4
    with pytest.raises(ValueError, match="whole cells"):
        memory_plan(cfg, env.param_space, sessions=6, steps=8, cell_size=4)


def test_fleet_memory_plan_matches_live_under_sharing():
    """The reference also checks bf16 storage here; the port stores replay
    in float32 only (ROADMAP A7b), and a bf16 request raises."""
    cfg = DDPGConfig.for_env(LustreSimV2("seq_write"), updates_per_step=2)
    kw = dict(env_cls=LustreSimV2, engine="scan", ddpg_config=cfg,
              eval_runs=1, warmup_steps=2, buffer_capacity=32,
              sharing=SharingConfig(shared_replay=True), device="cpu")
    fleet = FleetTuner.from_grid(["seq_write"], [W], [0, 1], **kw)
    plan = fleet.memory_plan(steps=6)
    assert plan["cell_size"] == 2
    assert plan["replay_dtype"] == "float32"
    assert plan["matches_live"] is True
    with pytest.raises(NotImplementedError, match="A7b"):
        FleetTuner.from_grid(["seq_write"], [W], [0, 1],
                             replay_dtype=torch.bfloat16, **kw)


# ---------------------------------------------------------------------------
# FleetService: cell binding, static parity, checkpointed sharing
# ---------------------------------------------------------------------------

def _sharing_service(tmpdir=None, sharing=None, cell_size=2):
    cfg = DDPGConfig.for_env(LustreSimEnv("seq_write"), updates_per_step=4)
    return FleetService(
        chunk=2, env_cls=LustreSimEnv, ddpg_config=cfg, warmup_steps=3,
        eval_runs=1, buffer_capacity=16, sharing=sharing,
        cell_size=cell_size, checkpoint_dir=tmpdir, device="cpu")


def test_sharing_service_matches_static_sharing_fleet():
    sharing = SharingConfig(shared_replay=True, avg_every=2)
    seeds, steps = [0, 1], 6
    static = _fleet(seeds=seeds, sharing=sharing).run(steps)

    svc = _sharing_service(sharing=sharing)
    sids = [svc.request_join("seq_write", W, s + 1000 * i)
            for i, s in enumerate(seeds)]
    svc.advance(steps)
    for sid in sids:
        svc.request_leave(sid)
    svc.advance(0)
    for sid, res in zip(sids, static.results):
        _assert_same(res, svc.result(sid))


def test_sharing_service_checkpoint_resume_is_bitwise(tmp_path):
    sharing = SharingConfig(shared_replay=True, avg_every=2)
    svc = _sharing_service(str(tmp_path / "svc"), sharing=sharing)
    sids = [svc.request_join("seq_write", W, s) for s in (0, 1)]
    svc.advance(4)
    svc.checkpoint()

    svc.advance(3)
    for sid in sids:
        svc.request_leave(sid)
    svc.advance(0)

    res = FleetService.restore(str(tmp_path / "svc"), device="cpu")
    assert res.sharing == normalize_sharing(sharing)
    assert res.cell_size == 2
    res.advance(3)
    for sid in sids:
        res.request_leave(sid)
    res.advance(0)
    for sid in sids:
        _assert_same(svc.result(sid), res.result(sid))


def test_cell_dies_with_its_last_member():
    sharing = SharingConfig(shared_replay=True)
    svc = _sharing_service(sharing=sharing)
    a = svc.request_join("seq_write", W, 0)
    svc.advance(2)
    assert len(svc._cells) == 1
    svc.request_leave(a)
    svc.advance(0)
    assert svc._cells == {}  # merged experience leaves with its tenants
    b = svc.request_join("seq_write", W, 7)
    svc.advance(2)
    assert len(svc._cells) == 1 and b in svc.active


def test_service_chunk_must_align_with_cells():
    cfg = DDPGConfig.for_env(LustreSimEnv("seq_write"), updates_per_step=2)
    with pytest.raises(ValueError, match="multiple of cell_size"):
        FleetService(chunk=3, env_cls=LustreSimEnv, ddpg_config=cfg,
                     sharing=SharingConfig(shared_replay=True), cell_size=2,
                     device="cpu")


def test_one_poisoned_member_leaves_its_cellmates_untouched():
    """``chip_smoke.poisoned_member`` on the CPU: a member whose every
    reading is NaN, under resilience, in cells of 8 with shared replay and
    the cell mean, against the same member inactive: its cellmates'
    merged windows, learners and traces bitwise equal."""
    import chip_smoke

    out = chip_smoke.poisoned_member("cpu", sessions=16, steps=6)
    assert out["cellmates_bitwise_equal"]


# ---------------------------------------------------------------------------
# Random-seed parity of the cell of one (hypothesis)
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(space=st.sampled_from(["2d", "8d"]), steps=st.integers(3, 7),
       seed=st.integers(0, 2 ** 16))
def test_random_seed_cell_of_one_parity(space, steps, seed):
    env_cls = LustreSimEnv if space == "2d" else LustreSimV2
    cfg = DDPGConfig.for_env(env_cls("seq_write"), updates_per_step=2)

    def build(sharing):
        return FleetTuner.from_grid(
            ["seq_write"], [{"throughput": 0.7, "iops": 0.3}], [seed],
            env_cls=env_cls, engine="scan", ddpg_config=cfg, eval_runs=1,
            warmup_steps=2, buffer_capacity=8, sharing=sharing,
            device="cpu")

    ind = build(None).run(steps).results[0]
    shr = build(SharingConfig(shared_replay=True)).run(steps).results[0]
    _assert_same(ind, shr)
