"""The port's self-healing layer (``core/resilience.py``, the resilient
per-step body of ``core/episode.py::stepwise_episode``, the supervised
``stream_chunks`` and ``envs/faults.py``'s host chaos), on the CPU, inside
the port: the reference's ``tests/test_resilience.py``, case for case. The
comparisons with the JAX package are in
``tests/test_torch_resilience_reference.py``.

Held, each measured before it was pinned:

* resilience off (``None``, or ``nonfinite_check=False``) runs the episode
  kernel (one ``episode_inner_loop`` call a run or chunk, no learner
  launch), BITWISE the run without the argument, in the ``Tuner``, the
  chunked fleet and the service;
* a resilient run without faults runs the per-step body (one learner launch
  a step) and is BITWISE the plain run (on the CPU the body equals the
  episode kernel's plain version, ``tests/test_torch_guardrails.py``);
* a NaN reading is recorded raw, never stored, and answered by a reset
  within the snapshot window; past ``max_resets`` (or ``degrade_after``)
  the session degrades and its learner stays bitwise still;
* the health counters equal the carried totals; ``health_decision`` keeps
  its invariants on numpy and on torch operands;
* supervision is bitwise invisible: retried chunks, stalls and supervised
  serial streams give the unsupervised run's bits; a dead chunk raises
  ``ChunkFailure``, or in a service quarantines its sessions while the
  survivors stay bitwise; a resilient service resumes bitwise;
* a learner planted with NaN or inf, or fed a 1e38 reward, comes out of
  the learner non-finite in exactly those sessions, and the detector flags
  exactly them.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.kernels.ops as ops
from repro_torch.core import (
    ChunkSupervisor,
    DDPGConfig,
    DeploymentPolicy,
    FleetService,
    FleetTuner,
    MagpieAgent,
    ResiliencePolicy,
    Scalarizer,
    SharingConfig,
    Tuner,
    health_decision,
    last_fleet_run_stats,
    normalize_resilience,
    normalize_supervisor,
)
from repro_torch.core.resilience import (
    EVENT_DEGRADED,
    EVENT_NONFINITE,
    EVENT_RESET,
    ChunkFailure,
    empty_health_counters,
    health_counters,
    merge_health_counters,
    tree_nonfinite,
    tree_nonfinite_rows,
)
from repro_torch.envs import (
    ChaosConfig,
    FaultInjectedModel,
    LustreSimEnv,
    LustreSimV2,
    ModelEnv,
    nan_poison,
)

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


@pytest.fixture
def calls(monkeypatch):
    """Counts of the episode kernel's and the learner's calls (on the CPU
    their plain versions run)."""
    seen = {"episode": 0, "learner": 0}

    def spy(name, fn):
        def run(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(ops, "episode_inner_loop",
                        spy("episode", ops.episode_inner_loop))
    monkeypatch.setattr(ops, "ddpg_inner_loop",
                        spy("learner", ops.ddpg_inner_loop))
    return seen


def _tuner(env_cls=LustreSimEnv, resilience=None, seed=3, updates=4,
           warmup=3, env=None, **kw):
    env = env or env_cls("seq_write", seed=seed).to_model_env(device="cpu")
    agent = MagpieAgent(DDPGConfig.for_env(env, updates_per_step=updates),
                        seed=seed, warmup_steps=warmup, device="cpu")
    return Tuner(env, Scalarizer(weights=W, specs=env.metric_specs), agent,
                 engine="scan", eval_runs=1, resilience=resilience,
                 device="cpu", **kw)


def _fleet(resilience=None, supervisor=None, chaos=None, chunk=2,
           seeds=(0, 1, 2), env_factory=None, sharing=None):
    env = (env_factory("seq_write", 0) if env_factory
           else LustreSimEnv("seq_write"))
    cfg = DDPGConfig.for_env(env, updates_per_step=4)
    return FleetTuner.from_grid(
        ["seq_write"], [W], list(seeds),
        env_cls=None if env_factory else LustreSimEnv,
        env_factory=env_factory, engine="scan", ddpg_config=cfg,
        eval_runs=1, warmup_steps=3, chunk=chunk, resilience=resilience,
        supervisor=supervisor, chaos=chaos, sharing=sharing, device="cpu")


def _faulted_tuner(fault_specs, resilience, seed=0, env_cls=LustreSimV2):
    base = env_cls("seq_write", seed=seed).as_model()
    env = ModelEnv(FaultInjectedModel(base, fault_specs), seed=seed,
                   device="cpu")
    return _tuner(resilience=resilience, seed=seed, env=env)


def _faulted_fleet_factory(fault_specs):
    """Every session wraps its model in ONE shared fault schedule, so the
    fleet keeps one step_fn identity (one episode body)."""
    specs = tuple(fault_specs)

    def env_factory(workload, seed):
        base = LustreSimV2(workload, seed=seed).as_model()
        return ModelEnv(FaultInjectedModel(base, specs), seed=seed,
                        device="cpu")

    return env_factory


def _records(result):
    return [(h.config, h.metrics, h.objective, h.reward, h.restart_seconds)
            for h in result.history]


def _same(a, b):
    """Bitwise equal histories and outcomes (NaN readings equal to NaN)."""
    assert [(h.config, h.restart_seconds) for h in a.history] == \
        [(h.config, h.restart_seconds) for h in b.history]
    for x, y in zip(a.history, b.history):
        np.testing.assert_array_equal(
            [x.objective, x.reward, *x.metrics.values()],
            [y.objective, y.reward, *y.metrics.values()])
    assert a.best_config == b.best_config
    assert a.best_objective == b.best_objective


# ---------------------------------------------------------------------------
# Off path: resilience=None is the episode kernel, bit for bit
# ---------------------------------------------------------------------------

def test_resilience_none_runs_the_episode_kernel(calls):
    """``resilience=None``, and a fully-off policy, run the path without
    the layer: the episode kernel once per run, no learner launch."""
    from repro_torch.core.episode import resolve_layers
    assert not resolve_layers(resilience=None).stepwise
    assert not resolve_layers(
        resilience=ResiliencePolicy(nonfinite_check=False)).stepwise
    _tuner(seed=5).run(4)
    _tuner(seed=5, resilience=None).run(4)
    _tuner(seed=5,
           resilience=ResiliencePolicy(nonfinite_check=False)).run(4)
    assert calls == {"episode": 3, "learner": 0}


def test_nonfinite_check_false_normalizes_to_the_off_program():
    assert normalize_resilience(None) is None
    off = ResiliencePolicy(nonfinite_check=False, max_resets=9)
    assert normalize_resilience(off) is None
    assert normalize_supervisor(None) is None
    with pytest.raises(ValueError, match="max_resets"):
        normalize_resilience(ResiliencePolicy(max_resets=-1))
    with pytest.raises(ValueError, match="snapshot_every"):
        normalize_resilience(ResiliencePolicy(snapshot_every=0))
    with pytest.raises(ValueError, match="degrade_after"):
        normalize_resilience(ResiliencePolicy(degrade_after=0))
    with pytest.raises(ValueError, match="on_failure"):
        normalize_supervisor(ChunkSupervisor(on_failure="crash"))
    t = _tuner(resilience=off)
    assert t.resilience is None and t.run(2).health_stats is None


def test_resilience_off_is_bitwise_neutral_single_tuner():
    ref = _tuner(seed=5).run(8)
    off = _tuner(seed=5, resilience=None).run(8)
    assert _records(ref) == _records(off)
    assert off.health_stats is None


def test_resilience_off_is_bitwise_neutral_chunked_fleet(calls):
    ref, off = _fleet(), _fleet(resilience=None)
    for steps in (4, 3):  # progressive runs stay aligned too
        for a, b in zip(ref.run(steps).results, off.run(steps).results):
            assert _records(a) == _records(b)
            assert b.health_stats is None
    assert calls == {"episode": 8, "learner": 0}  # 2 chunks a run


def test_resilience_off_is_bitwise_neutral_service():
    def make(**kw):
        svc = FleetService(chunk=2, warmup_steps=3, eval_runs=1,
                           device="cpu",
                           ddpg_config=DDPGConfig(12, 2, updates_per_step=4),
                           **kw)
        svc.request_join("seq_write", W, 0)
        svc.request_join("seq_write", W, 1)
        return svc

    ref, off = make(), make(resilience=None, supervisor=None)
    for steps in (4, 2):
        ref.advance(steps), off.advance(steps)
        for sid in (0, 1):
            assert _records(ref._sessions[sid]) == \
                _records(off._sessions[sid])
    assert "supervisor" not in ref.last_stats
    assert "quarantined" not in ref.last_stats


def test_resilient_run_without_faults_matches_plain_single_tuner(calls):
    """On a healthy run the resilient body is the plain body: the same
    FIFO writes, the same learner inputs, no health event."""
    ref = _tuner(seed=5).run(8)
    assert calls == {"episode": 1, "learner": 0}
    t = _tuner(seed=5, resilience=ResiliencePolicy())
    res = t.run(8)
    assert calls == {"episode": 1, "learner": 8}
    assert _records(ref) == _records(res)
    assert not np.any(t.health_events)
    s = res.health_stats
    assert s["resets_total"] == 0 and s["nonfinite_total"] == 0
    assert not s["degraded"]
    assert s["policy"]["max_resets"] == ResiliencePolicy().max_resets


def test_resilient_fleet_without_faults_matches_plain_fleet():
    ref, res = _fleet(), _fleet(resilience=ResiliencePolicy())
    for a, b in zip(ref.run(6).results, res.run(6).results):
        assert _records(a) == _records(b)
        assert b.health_stats["resets_total"] == 0
    assert not np.any(res.health_events)


# ---------------------------------------------------------------------------
# Recovery inside the episode: NaN divergence -> snapshot reset or degrade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("snapshot_every", [1, 3])
def test_nan_divergence_recovers_within_the_snapshot_window(snapshot_every):
    start, dur = 4, 2
    t = _faulted_tuner([nan_poison("throughput", start=start, duration=dur)],
                       ResiliencePolicy(max_resets=4,
                                        snapshot_every=snapshot_every))
    res = t.run(12)
    ev = t.health_events
    # the poison is observed (raw in the trace) and answered by a reset on
    # each corrupted step: the learner never keeps a poisoned sample
    for k in range(start, start + dur):
        assert ev[k] & EVENT_NONFINITE
        assert ev[k] & EVENT_RESET
        assert np.isnan(res.history[k].metrics["throughput"])
    after = ev[start + dur:]
    assert not np.any(after & EVENT_NONFINITE)
    assert not np.any(after & EVENT_DEGRADED)
    post = [h.objective for h in res.history[start + dur:]]
    assert np.all(np.isfinite(post))
    s = res.health_stats
    assert s["resets_total"] == dur and s["nonfinite_total"] == dur
    assert not s["degraded"]
    # the poisoned writes were dropped: 12 steps, 2 never stored
    assert len(t.agent.buffer) == 12 - dur
    assert torch.isfinite(t.agent.buffer.storage()[0][3]).all()


def test_exhausted_reset_budget_degrades_cleanly_and_stays_frozen():
    start = 3
    t = _faulted_tuner([nan_poison("throughput", start=start, duration=50)],
                       ResiliencePolicy(max_resets=0, snapshot_every=1))
    t.run(start + 1)
    frozen = [x.clone() for x in t.agent.state]
    res = t.run(10 - start - 1)
    ev = t.health_events
    assert not np.any(ev[:start])
    # max_resets=0: the FIRST divergence degrades; no reset is ever spent
    # and the flag is sticky for the rest of the run
    assert not np.any(ev & EVENT_RESET)
    assert np.all(ev[start:] & EVENT_DEGRADED)
    s = res.health_stats
    assert s["degraded"] and s["resets_total"] == 0
    assert s["degraded_steps"] == 10 - start
    assert s["nonfinite_total"] == 10 - start
    # the frozen incumbent: the learner stays bitwise still
    for x, y in zip(frozen, t.agent.state):
        assert torch.equal(x, y)


def test_degrade_after_caps_total_nonfinite_detections():
    """``degrade_after`` degrades a flapping session even with resets left:
    two separated poison bursts spend resets, the third crosses the cap on
    non-finite detections."""
    pol = ResiliencePolicy(max_resets=100, snapshot_every=1, degrade_after=3)
    t = _faulted_tuner([nan_poison("throughput", start=2, duration=1),
                        nan_poison("throughput", start=5, duration=1),
                        nan_poison("throughput", start=8, duration=1)], pol)
    res = t.run(12)
    ev = t.health_events
    assert ev[2] & EVENT_RESET and ev[5] & EVENT_RESET
    assert ev[8] & EVENT_DEGRADED and not (ev[8] & EVENT_RESET)
    assert np.all(ev[8:] & EVENT_DEGRADED)
    assert res.health_stats["resets_total"] == 2


def test_trace_counters_equal_in_graph_totals():
    t = _faulted_tuner([nan_poison("throughput", start=4, duration=2)],
                       ResiliencePolicy(max_resets=4))
    res = t.run(10)
    s = res.health_stats
    got = health_counters(t.health_events)
    assert got["steps"] == 10
    assert got["resets"] == s["resets_total"]
    assert got["nonfinite"] == s["nonfinite_total"]
    assert s["degraded_steps"] == got["degraded_steps"] == 0


def test_merge_health_counters_and_empty_counters():
    a = health_counters(np.array(
        [0, EVENT_NONFINITE | EVENT_RESET, EVENT_NONFINITE | EVENT_DEGRADED,
         EVENT_DEGRADED], np.uint8))
    assert a["steps"] == 4 and a["nonfinite"] == 2
    assert a["resets"] == 1 and a["degraded_steps"] == 2
    merged = merge_health_counters(a, empty_health_counters())
    assert merged == a
    assert empty_health_counters()["resets"] == 0


# ---------------------------------------------------------------------------
# health_decision invariants (hypothesis), on numpy and on torch operands
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None)
@given(bads=st.lists(st.booleans(), max_size=40),
       max_resets=st.integers(0, 6),
       degrade_after=st.none() | st.integers(1, 10))
def test_health_decision_invariants(bads, max_resets, degrade_after):
    """Fold an arbitrary fault sequence through the state machine: resets
    never exceed ``max_resets``, degraded is sticky, a degraded step never
    resets, every bad step counts once; the torch form (one lane per
    prefix) agrees with the numpy form."""
    pol = ResiliencePolicy(max_resets=max_resets,
                           degrade_after=degrade_after)
    resets, nf = np.int32(0), np.int32(0)
    degraded = np.bool_(False)
    t_resets = torch.zeros(1, dtype=torch.int32)
    t_nf = torch.zeros(1, dtype=torch.int32)
    t_deg = torch.zeros(1, dtype=torch.bool)
    for b in bads:
        b = np.bool_(b)
        do_reset, new_deg, new_resets, new_nf = health_decision(
            b, resets, nf, degraded, pol)
        assert int(new_resets) <= max_resets
        assert bool(new_deg) or not bool(degraded)   # sticky
        assert not (bool(do_reset) and bool(new_deg))  # degraded: no reset
        assert int(new_nf) == int(nf) + int(bool(b))
        assert int(new_resets) - int(resets) == int(bool(do_reset))
        t_reset, t_deg, t_resets, t_nf = health_decision(
            torch.tensor([bool(b)]), t_resets, t_nf, t_deg, pol)
        assert (bool(t_reset), bool(t_deg), int(t_resets), int(t_nf)) == \
            (bool(do_reset), bool(new_deg), int(new_resets), int(new_nf))
        resets, nf, degraded = new_resets, new_nf, new_deg


# ---------------------------------------------------------------------------
# The learner's non-finite outputs and the detector
# ---------------------------------------------------------------------------

def test_planted_nonfinite_learners_are_flagged_exactly():
    """NaN or inf planted in some sessions' learner, or a 1e38 reward in
    their windows, leaves the plain learner's outputs non-finite in
    exactly those sessions, and the detector flags exactly them."""
    from repro_torch.core.ddpg import fleet_init, fleet_learn_scan
    from repro_torch import random as jrandom
    cfg = DDPGConfig(12, 2, updates_per_step=4)
    n, cap = 6, 8
    state = fleet_init(torch.stack([jrandom.PRNGKey(s) for s in range(n)]),
                       cfg, "cpu")
    rng = np.random.default_rng(0)
    data = [torch.as_tensor(rng.random(shape, dtype=np.float32))
            for shape in ((n, cap, 12), (n, cap, 2), (n, cap), (n, cap, 12))]
    state.flat[1, 5] = float("nan")
    state.flat[3, 100] = float("inf")
    data[2][4] = 1e38
    keys = torch.stack([jrandom.PRNGKey(100 + s) for s in range(n)])
    _, metrics = fleet_learn_scan(state, tuple(data),
                                  torch.full((n,), cap), keys, cfg, 4)
    bad = tree_nonfinite_rows((state.flat, metrics))
    assert bad.tolist() == [False, True, False, True, True, False]
    assert bool(tree_nonfinite((state, metrics)))
    assert not bool(tree_nonfinite(state.counts))


# ---------------------------------------------------------------------------
# Host supervisor: retries are bitwise invisible, stalls only trip counters
# ---------------------------------------------------------------------------

def test_supervised_stream_without_faults_is_bitwise_invisible():
    ref = _fleet()
    sup = _fleet(supervisor=ChunkSupervisor(max_retries=2,
                                            backoff_seconds=0.0))
    for a, b in zip(ref.run(6).results, sup.run(6).results):
        assert _records(a) == _records(b)


def test_transient_chunk_failure_is_retried_to_a_bitwise_equal_result():
    chaos = ChaosConfig(fail_chunks=((0, 1),))  # chunk 0: 1 failure, then ok
    ref = _fleet()
    faulted = _fleet(supervisor=ChunkSupervisor(max_retries=2,
                                                backoff_seconds=0.0),
                     chaos=chaos.host())
    rr, rf = ref.run(6), faulted.run(6)
    stats = last_fleet_run_stats()["supervisor"]
    assert stats["retries"] == 1 and stats["failed_chunks"] == []
    for a, b in zip(rr.results, rf.results):
        assert _records(a) == _records(b)


def test_stalled_chunk_trips_the_watchdog_without_touching_results():
    chaos = ChaosConfig(stall_chunks=((0, 0.05),))
    ref = _fleet()
    stalled = _fleet(supervisor=ChunkSupervisor(backoff_seconds=0.0,
                                                watchdog_seconds=0.02),
                     chaos=chaos.host())
    rr, rs = ref.run(5), stalled.run(5)
    stats = last_fleet_run_stats()["supervisor"]
    assert stats["watchdog_trips"] >= 1
    assert stats["failed_chunks"] == []
    assert len(stats["chunk_seconds"]) == 2  # 3 sessions / chunk=2
    for a, b in zip(rr.results, rs.results):
        assert _records(a) == _records(b)


def test_exhausted_retries_raise_chunk_failure_by_default():
    chaos = ChaosConfig(fail_chunks=((0, 99),))  # never clears
    faulted = _fleet(supervisor=ChunkSupervisor(max_retries=1,
                                                backoff_seconds=0.0),
                     chaos=chaos.host())
    with pytest.raises(ChunkFailure, match="chunk 0"):
        faulted.run(4)
    assert ChaosConfig().host() is None and ChaosConfig().fault_specs() == ()


def test_chaos_without_a_supervisor_is_refused():
    from repro_torch.core.episode import stream_chunks
    with pytest.raises(ValueError, match="ChunkSupervisor"):
        stream_chunks(lambda args: args, lambda ci: ci,
                      lambda ci, out: None, 2, chaos=object())


# ---------------------------------------------------------------------------
# Service quarantine: a dead chunk leaves, the survivors stay bitwise
# ---------------------------------------------------------------------------

def _service(n=4, **kw):
    svc = FleetService(chunk=2, warmup_steps=3, eval_runs=1, device="cpu",
                       ddpg_config=DDPGConfig(12, 2, updates_per_step=4),
                       **kw)
    return svc, [svc.request_join("seq_write", W, seed)
                 for seed in range(n)]


def test_dead_chunk_quarantines_sessions_and_survivors_stay_bitwise():
    ref, _ = _service()
    chaos = ChaosConfig(fail_chunks=((1, 99),))  # chunk 1 never stages
    # on_failure="raise" is forced to "skip" inside advance: a persistent
    # service quarantines, it never crashes
    svc, sids = _service(
        supervisor=ChunkSupervisor(max_retries=1, backoff_seconds=0.0,
                                   on_failure="raise"),
        chaos=chaos.host())
    ref.advance(4)
    svc.advance(4)
    assert svc.last_stats["supervisor"]["failed_chunks"] == [1]
    assert svc.last_stats["quarantined"] == sids[2:]
    for sid in sids[:2]:
        assert _records(ref._sessions[sid]) == _records(svc._sessions[sid])
    # the quarantined sessions leave at the next boundary with the state
    # they had before the advance (the failed chunk never drained)
    svc.advance(0)
    for sid in sids[2:]:
        assert sid not in svc._sessions
        assert svc.result(sid).history == []
    for sid in sids[:2]:
        assert sid in svc._sessions


def test_resilient_service_checkpoint_restore_resumes_bit_identically(
        tmp_path):
    pol = ResiliencePolicy(max_resets=2, snapshot_every=2)
    sup = ChunkSupervisor(max_retries=1, backoff_seconds=0.0)
    svc = FleetService(chunk=2, warmup_steps=3, eval_runs=1, device="cpu",
                       ddpg_config=DDPGConfig(12, 2, updates_per_step=4),
                       resilience=pol, supervisor=sup,
                       checkpoint_dir=str(tmp_path))
    a = svc.request_join("seq_write", W, 0)
    b = svc.request_join("random_rw", {"iops": 1.0}, 1)
    svc.advance(5)
    svc.checkpoint()
    svc.advance(4)
    want = {sid: svc.health_stats(sid) for sid in (a, b)}
    want_hist = {sid: _records(svc._sessions[sid]) for sid in (a, b)}
    want_snap = {sid: svc._sessions[sid].health.snapshot for sid in (a, b)}

    back = FleetService.restore(str(tmp_path), device="cpu")
    assert back.resilience == normalize_resilience(pol)
    assert back.supervisor == sup
    back.advance(4)
    for sid in (a, b):
        assert back.health_stats(sid) == want[sid]
        assert _records(back._sessions[sid]) == want_hist[sid]
        for x, y in zip(want_snap[sid], back._sessions[sid].health.snapshot):
            assert torch.equal(x, y)
    # departure surfaces the health record on the TuningResult
    back.request_leave(a)
    back.advance(0)
    res = back.result(a)
    assert res.health_stats["policy"]["max_resets"] == 2
    assert res.health_stats["steps"] == 9  # 5 checkpointed + 4 resumed


# ---------------------------------------------------------------------------
# Composition: sharing masks corrupted contributions; guardrails refuse
# ---------------------------------------------------------------------------

def test_shared_cell_masks_poisoned_contributions():
    """With shared replay, a poisoned step's transitions are DROPPED from
    the cell's merged window, so the window is the fault-free window minus
    the poisoned writes, and every member recovers."""
    sharing = SharingConfig(shared_replay=True)
    pol = ResiliencePolicy(max_resets=4, snapshot_every=1)
    clean = _fleet(sharing=sharing, resilience=pol,
                   env_factory=_faulted_fleet_factory([]))
    poisoned = _fleet(
        sharing=sharing, resilience=pol,
        env_factory=_faulted_fleet_factory(
            [nan_poison("throughput", start=3, duration=1)]))
    clean.run(8)
    poisoned.run(8)
    ev = poisoned.health_events
    assert np.all(ev[:, 3] & EVENT_NONFINITE)  # every member saw the poison
    assert not np.any(ev[:, 4:] & EVENT_DEGRADED)  # ...and all recovered
    _, _, clean_size = clean.agent.buffer.grouped_storage()
    _, _, got_size = poisoned.agent.buffer.grouped_storage()
    # one poisoned step x 3 members never reached the merged window
    assert np.all(clean_size - got_size == 3)


def test_resilience_refuses_guardrail_composition():
    env = LustreSimEnv("seq_write", seed=0).to_model_env(device="cpu")
    scal = Scalarizer(weights=W, specs=env.metric_specs)
    with pytest.raises(ValueError, match="does not compose"):
        Tuner(env, scal, engine="scan", policy=DeploymentPolicy(),
              resilience=ResiliencePolicy(), device="cpu")
    with pytest.raises(ValueError, match="does not compose"):
        FleetTuner.from_grid(
            ["seq_write"], [W], [0], engine="scan", env_cls=LustreSimEnv,
            policy=DeploymentPolicy(), resilience=ResiliencePolicy(),
            device="cpu")
    with pytest.raises(ValueError, match="does not compose"):
        FleetService(chunk=2, policy=DeploymentPolicy(),
                     resilience=ResiliencePolicy(), device="cpu")


def test_resilience_requires_the_scan_engine():
    env = LustreSimEnv("seq_write", seed=0)
    scal = Scalarizer(weights=W, specs=env.metric_specs)
    with pytest.raises(ValueError, match="scan"):
        Tuner(env, scal, engine="host", resilience=ResiliencePolicy(),
              device="cpu")
    with pytest.raises(ValueError, match="scan"):
        FleetTuner.from_grid(
            ["seq_write"], [W], [0], engine="host", env_cls=LustreSimEnv,
            resilience=ResiliencePolicy(), device="cpu")
    with pytest.raises(ValueError, match="scan"):
        FleetTuner.from_grid(
            ["seq_write"], [W], [0], engine="host", env_cls=LustreSimEnv,
            supervisor=ChunkSupervisor(), device="cpu")
