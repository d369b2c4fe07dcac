"""The port's deployment guardrails (``core/guardrails.py``), its fault
injection (``envs/faults.py``) and the per-step episode body they run on
(``core/episode.py::stepwise_episode``), on the CPU, inside the port. The
comparisons with the JAX package are in
``tests/test_torch_guardrails_reference.py``.

Measured bounds, each pinned as measured:

* the per-step body with ``policy=None`` against the episode kernel's
  plain version (``episode_learn_plain``), 3 sessions, 10 steps, 4 updates
  a step, 2-D and 8-D: BITWISE equal, trace and carry (the act, the model
  step, the reward, the store and the learner are the same float32
  operations in the same order on the CPU);
* guarded chunked against guarded monolithic fleets (3 sessions, chunks of
  2, 6 steps), and a guarded fleet of one against the guarded ``Tuner``:
  bitwise (histories, events, guardrail records);
* a guarded service's kill and resume: bitwise.

The reference's rollback-incumbent test checks no step on its scenario
(LustreSimV2 seed 0, ROADMAP Queue C); the port's runs seed 2, where two
rollbacks are checked (measured). The monotonicity properties draw anchors
from 2**-10, a float32 value, where the reference's 0.001 is not one.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.kernels.ops as ops
from repro_torch.core import (
    DDPGConfig,
    DeploymentPolicy,
    FleetService,
    FleetTuner,
    MagpieAgent,
    Scalarizer,
    Tuner,
    gate_decision,
    rollback_decision,
    stepwise_episode,
)
from repro_torch.core.guardrails import (
    EVENT_PROMOTED,
    EVENT_REJECTED_GAIN,
    EVENT_ROLLBACK,
    empty_counters,
    guardrail_counters,
    merge_counters,
)
from repro_torch.envs import (
    FaultInjectedModel,
    FaultSpec,
    FaultyEnvState,
    LustreSimEnv,
    LustreSimV2,
    ModelEnv,
    metric_dropout,
    throughput_collapse,
)
from repro_torch.kernels.episode_learn import episode_learn_plain

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
    """Counts of the episode kernel's, the learner's and the per-step
    body's calls (on the CPU the kernels' plain versions run)."""
    import repro_torch.core.episode as episode

    seen = {"episode": 0, "learner": 0, "body": 0}

    def spy(name, fn):
        def run(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(ops, "episode_inner_loop",
                        spy("episode", ops.episode_inner_loop))
    monkeypatch.setattr(ops, "ddpg_inner_loop",
                        spy("learner", ops.ddpg_inner_loop))
    monkeypatch.setattr(episode, "stepwise_episode",
                        spy("body", episode.stepwise_episode))
    return seen


def _tuner(env_cls=LustreSimEnv, seed=3, updates=4, warmup=3, env=None,
           **kw):
    env = env or env_cls("seq_write", seed=seed).to_model_env(device="cpu")
    agent = MagpieAgent(DDPGConfig.for_env(env, updates_per_step=updates),
                        seed=seed, warmup_steps=warmup, device="cpu")
    return Tuner(env, Scalarizer(weights=W, specs=env.metric_specs), agent,
                 engine="scan", eval_runs=1, device="cpu", **kw)


def _fleet(chunk=2, seeds=(0, 1, 2), **kw):
    cfg = DDPGConfig.for_env(LustreSimEnv("seq_write"), updates_per_step=4)
    return FleetTuner.from_grid(
        ["seq_write"], [W], list(seeds), env_cls=LustreSimEnv,
        engine="scan", ddpg_config=cfg, eval_runs=1, warmup_steps=3,
        chunk=chunk, device="cpu", **kw)


def _service(**kw):
    svc = FleetService(chunk=2, warmup_steps=3, eval_runs=1, device="cpu",
                       ddpg_config=DDPGConfig(12, 2, updates_per_step=4),
                       **kw)
    return svc, [svc.request_join("seq_write", W, s) for s in (0, 1)] + \
        [svc.request_join("random_rw", {"iops": 1.0}, 2)]


def _records(result):
    return [(h.config, h.metrics, h.objective, h.reward, h.restart_seconds)
            for h in result.history]


def _faulted(faults, seed, policy=None, env_cls=LustreSimV2):
    base = env_cls("seq_write", seed=seed).as_model()
    env = ModelEnv(FaultInjectedModel(base, faults), seed=seed, device="cpu")
    return _tuner(seed=seed, env=env, policy=policy)


# ---------------------------------------------------------------------------
# Off path: policy=None is the episode kernel, bit for bit
# ---------------------------------------------------------------------------

def test_policy_none_is_bitwise_neutral_tuner(calls):
    ref = _tuner(seed=5).run(8)
    assert calls == {"episode": 1, "learner": 0, "body": 0}
    off = _tuner(seed=5, policy=None).run(8)
    assert calls == {"episode": 2, "learner": 0, "body": 0}
    assert _records(ref) == _records(off)
    assert off.guardrail_stats is None


def test_policy_none_is_bitwise_neutral_fleet(calls):
    ref, off = _fleet(), _fleet(policy=None)
    for steps in (4, 3):  # progressive runs stay aligned too
        for a, b in zip(ref.run(steps).results, off.run(steps).results):
            assert _records(a) == _records(b)
            assert b.guardrail_stats is None
    assert calls == {"episode": 8, "learner": 0, "body": 0}  # 2 chunks a run


def test_policy_none_is_bitwise_neutral_service(calls):
    (ref, sids), (off, _) = _service(), _service(policy=None)
    for steps in (4, 2):
        ref.advance(steps), off.advance(steps)
        for sid in sids:
            assert _records(ref._sessions[sid]) == \
                _records(off._sessions[sid])
            assert off.guardrail_stats(sid) is None
    assert calls == {"episode": 8, "learner": 0, "body": 0}
    assert "guardrails" not in off.last_stats


@pytest.mark.parametrize("space", ["2d", "8d"])
def test_the_body_equals_the_episode_kernels_plain_version(space):
    import chip_smoke

    op, spec = chip_smoke.episode_inputs(space, 3, seed=300, device="cpu",
                                         steps=10)
    spec = spec._replace(cfg=spec.cfg._replace(updates_per_step=4),
                         num_updates=4)
    a, b = chip_smoke.clone_tree(op), chip_smoke.clone_tree(op)
    want = episode_learn_plain(a, spec=spec)
    got = stepwise_episode(b, spec=spec)
    assert chip_smoke.tree_equal(got, want)
    assert chip_smoke.tree_equal(b, a)


# ---------------------------------------------------------------------------
# Gate behaviour (fixed seeds)
# ---------------------------------------------------------------------------

def test_min_gain_gate_blocks_all_promotions_and_freezes_config(calls):
    t = _tuner(policy=DeploymentPolicy(min_gain=1e9))
    res = t.run(10)
    assert calls == {"episode": 0, "learner": 10, "body": 1}
    s = res.guardrail_stats
    assert s["promotions"] == 0 and s["promotions_total"] == 0
    assert s["rejected_min_gain"] == 10
    assert s["restart_budget_spent"] == 0.0
    assert all(h.config == res.default_config for h in res.history)
    assert all(h.restart_seconds == 0.0 for h in res.history)
    # ... while the shadow trail shows the tuner kept exploring
    assert len(set(np.round(t.shadow_objectives, 6))) > 1


def test_permissive_policy_promotes():
    s = _tuner(policy=DeploymentPolicy(min_gain=-10.0)).run(10)
    assert s.guardrail_stats["promotions"] > 0
    assert s.guardrail_stats["rejected_min_gain"] == 0


def test_restart_budget_caps_committed_downtime():
    cap = 40.0
    t = _tuner(policy=DeploymentPolicy(min_gain=-10.0,
                                       max_restart_seconds=cap,
                                       rollback_window=0))
    res = t.run(12)
    s = res.guardrail_stats
    assert 0.0 <= s["restart_budget_spent"] <= cap
    assert s["budget_remaining"] >= 0.0
    assert s["rejected_budget"] > 0  # the cap bit
    promoted = np.nonzero(t.guard_events & EVENT_PROMOTED)[0]
    assert promoted.size
    assert all(h.restart_seconds == 0.0
               for h in res.history[promoted[-1] + 1:])


def test_zero_budget_promotes_nothing_with_restart_cost():
    res = _tuner(policy=DeploymentPolicy(
        min_gain=-10.0, max_restart_seconds=0.0, rollback_window=0)).run(10)
    assert res.guardrail_stats["restart_budget_spent"] == 0.0
    assert res.guardrail_stats["promotions"] == 0
    assert all(h.restart_seconds == 0.0 for h in res.history)


def test_promoted_steps_cleared_the_min_gain_bar():
    """Each step's shadow gain recomputed from the trace in float32: every
    promotion cleared ``min_gain``, every gain rejection missed it."""
    pol = DeploymentPolicy(min_gain=0.02, rollback_window=4)
    t = _tuner(policy=pol, seed=11)
    res = t.run(14)
    objectives = np.asarray([h.objective for h in res.history], np.float32)
    shadow = np.asarray(t.shadow_objectives, np.float32)
    ev = t.guard_events
    for i in range(1, len(ev)):
        prev = objectives[i - 1]
        gain = np.float32(shadow[i] - prev) / np.maximum(prev,
                                                         np.float32(1e-6))
        if ev[i] & EVENT_PROMOTED:
            assert gain >= np.float32(pol.min_gain)
        if ev[i] & EVENT_REJECTED_GAIN:
            assert gain < np.float32(pol.min_gain)


# ---------------------------------------------------------------------------
# Fault injection: degradation -> rollback within the window
# ---------------------------------------------------------------------------

ROLLBACK_POLICY = DeploymentPolicy(min_gain=-0.5, rollback_window=10,
                                   rollback_threshold=0.3)
COLLAPSE = throughput_collapse(start=6, duration=10, to_fraction=0.1)


def test_injected_collapse_triggers_rollback_within_window():
    t = _faulted([COLLAPSE], seed=0, policy=ROLLBACK_POLICY)
    t.run(20)
    rollbacks = np.nonzero(t.guard_events & EVENT_ROLLBACK)[0]
    in_window = rollbacks[(rollbacks >= 6) & (rollbacks < 16)]
    assert in_window.size > 0


def test_rollback_restores_the_pre_promotion_incumbent():
    """After a rollback at step r with no promotion at r + 1, the config
    committed at r + 1 is the incumbent the last promotion p <= r displaced:
    the config committed at p - 1 (the default at p = 0), where no rollback
    at p - 1 had replaced it."""
    t = _faulted([COLLAPSE], seed=2, policy=ROLLBACK_POLICY)
    res = t.run(20)
    ev = t.guard_events
    checked = 0
    for r in np.nonzero(ev & EVENT_ROLLBACK)[0]:
        if r + 1 >= len(ev) or ev[r + 1] & EVENT_PROMOTED:
            continue
        promos = [p for p in np.nonzero(ev & EVENT_PROMOTED)[0] if p <= r]
        if not promos or (promos[-1] > 0
                          and ev[promos[-1] - 1] & EVENT_ROLLBACK):
            continue
        p = promos[-1]
        incumbent = res.history[p - 1].config if p else res.default_config
        assert res.history[r + 1].config == incumbent
        checked += 1
    assert checked > 0


def test_best_objective_never_below_promotion_anchors():
    pol = DeploymentPolicy(min_gain=-0.5, rollback_window=8,
                           rollback_threshold=0.2)
    t = _faulted([throughput_collapse(start=5, duration=8, to_fraction=0.2)],
                 seed=0, policy=pol)
    res = t.run(16)
    best = max(h.objective for h in res.history)
    for p in np.nonzero(t.guard_events & EVENT_PROMOTED)[0]:
        if p:
            assert best >= res.history[p - 1].objective


def test_metric_dropout_is_observed_by_the_state():
    """Dropout zeroes the metric in the committed trace while active, and
    the normalized state the next step acts on reads it (the body's
    own run with ``policy=None`` and a guarded tuner's)."""
    fault = metric_dropout("iops", start=2, duration=3)
    t = _faulted([fault], seed=1, policy=DeploymentPolicy(min_gain=-10.0))
    iops = [h.metrics["iops"] for h in t.run(8).history]
    assert all(v == 0.0 for v in iops[2:5])
    assert all(v != 0.0 for v in iops[:2] + iops[5:])
    # the unguarded body on the same model: the trace and the state
    import chip_smoke

    op, spec = chip_smoke.episode_inputs("8d", 2, seed=1, device="cpu",
                                         steps=4)
    model = FaultInjectedModel(spec.model, [metric_dropout("iops", 0, 2)])
    op = op._replace(carry=op.carry._replace(env_state=FaultyEnvState(
        base=op.carry.env_state, step=torch.zeros(2, dtype=torch.int32))))
    trace = stepwise_episode(op, spec=spec._replace(model=model))
    k = model.state_metrics.index("iops")
    assert (trace.metrics[:, :2, k] == 0).all()
    assert (trace.metrics[:, 2:, k] != 0).all()
    assert (op.carry.env_state.step == 4).all()


def test_fault_wrapper_validates_inputs():
    base = LustreSimV2("seq_write", seed=0).as_model()
    with pytest.raises(ValueError, match="unknown metric"):
        FaultInjectedModel(base, [FaultSpec("latency", 0, 1)])
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultInjectedModel(base, [FaultSpec("iops", 0, 1, mode="negate")])
    with pytest.raises(ValueError, match="duration"):
        FaultInjectedModel(base, [FaultSpec("iops", 0, 0)])


def test_one_fault_schedule_shares_one_step_fn_across_sessions():
    rows = [throughput_collapse(start=3, duration=2)]
    a = FaultInjectedModel(LustreSimV2("seq_write", seed=0).as_model(), rows)
    b = FaultInjectedModel(LustreSimV2("seq_write", seed=9).as_model(), rows)
    assert a.step_fn is b.step_fn


def test_the_fault_clock_and_key_chain():
    """Eval probes read the clock and never advance it; the wrapped model's
    key chain (routed through ``FaultyEnvState.base``) gives the draws it
    gives unwrapped."""
    base = LustreSimEnv("seq_write", seed=4).as_model()
    wrapped = ModelEnv(FaultInjectedModel(base, [COLLAPSE]), seed=4,
                       device="cpu")
    plain = ModelEnv(base, seed=4, device="cpu")
    cfg = plain.param_space.default_config()
    for eval_run in (True, False, True, False):
        a = wrapped.apply(cfg, eval_run=eval_run)
        b = plain.apply(cfg, eval_run=eval_run)
        assert a == b  # before step 6 no fault row is active
    assert int(wrapped.model_state.step) == 2
    assert torch.equal(wrapped.model_state.base.key, plain.model_state.key)


# ---------------------------------------------------------------------------
# Decision functions: numpy and torch operands agree; monotone thresholds
# ---------------------------------------------------------------------------

def _both(fn, *args, policy):
    """``fn`` on numpy float32 scalars and on torch float32 tensors."""
    as_np = [np.float32(a) if isinstance(a, float) else np.int32(a)
             for a in args]
    as_t = [torch.tensor(a, dtype=torch.float32 if isinstance(a, float)
                         else torch.int32) for a in args]
    out_np, out_t = fn(*as_np, policy), fn(*as_t, policy)
    out_np = out_np if isinstance(out_np, tuple) else (out_np,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    assert [bool(x) for x in out_np] == [bool(x) for x in out_t]
    return bool(out_np[0])


_F32 = dict(allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=60, deadline=None)
@given(gain=st.floats(-5, 5, **_F32), restart=st.floats(0, 100, **_F32),
       spent=st.floats(0, 500, **_F32), min_gain=st.floats(-2, 2, **_F32),
       budget=st.floats(0, 500, **_F32), d_gain=st.floats(0, 3, **_F32),
       d_budget=st.floats(0, 300, **_F32))
def test_gate_is_monotone_in_thresholds(gain, restart, spent, min_gain,
                                        budget, d_gain, d_budget):
    tight = DeploymentPolicy(min_gain=min_gain, max_restart_seconds=budget)
    loose = DeploymentPolicy(min_gain=min_gain - d_gain,
                             max_restart_seconds=budget + d_budget)
    p_tight = _both(gate_decision, gain, restart, spent, policy=tight)
    p_loose = _both(gate_decision, gain, restart, spent, policy=loose)
    assert p_loose or not p_tight


@settings(max_examples=60, deadline=None)
@given(live=st.floats(0, 10, **_F32), anchor=st.floats(2 ** -10, 10, **_F32),
       watch=st.integers(0, 20), thr=st.floats(0, 1, **_F32),
       d_thr=st.floats(0, 1, **_F32))
def test_rollback_is_monotone_in_threshold(live, anchor, watch, thr, d_thr):
    low = DeploymentPolicy(rollback_threshold=thr)
    high = DeploymentPolicy(rollback_threshold=thr + d_thr)
    r_low = _both(rollback_decision, live, anchor, watch, policy=low)
    r_high = _both(rollback_decision, live, anchor, watch, policy=high)
    assert r_low or not r_high
    assert not _both(rollback_decision, live, anchor, 0, policy=low)


# ---------------------------------------------------------------------------
# Counters, fleets, service
# ---------------------------------------------------------------------------

def test_counters_agree_with_the_carried_totals():
    t = _tuner(policy=DeploymentPolicy(min_gain=-10.0, rollback_window=5))
    s = t.run(9).guardrail_stats
    assert s["promotions"] == s["promotions_total"] > 0
    assert s["rollbacks"] == s["rollbacks_total"]
    # the trace's restarts decoded and summed in float64; the guard's
    # running float32 sum: equal up to float32 rounding
    assert s["restart_budget_spent"] == pytest.approx(s["restart_seconds"],
                                                      rel=1e-5)
    assert s["proposals"] == 9
    t.run(3)  # the guard persists across progressive runs
    s = t.guardrail_stats()
    assert s["proposals"] == 12 and s["promotions"] == s["promotions_total"]


def test_merge_counters_and_empty_counters():
    a = guardrail_counters(np.array([1, 2, 9], np.uint8),
                           np.array([10.0, 0.0, 5.0]))
    assert a["proposals"] == 3 and a["promotions"] == 2
    assert a["rejected_min_gain"] == 1 and a["rollbacks"] == 1
    assert a["restart_seconds"] == 15.0
    assert merge_counters(a, empty_counters()) == a
    assert empty_counters()["restart_seconds"] == 0.0


def test_guarded_fleet_chunk_invariance(calls):
    pol = DeploymentPolicy(min_gain=-10.0, rollback_window=4)
    mono, chunked = _fleet(policy=pol, chunk=None), _fleet(policy=pol)
    rm, rc = mono.run(6), chunked.run(6)
    assert calls["episode"] == 0 and calls["learner"] == 6 + 2 * 6
    assert np.array_equal(mono.guard_events, chunked.guard_events)
    assert np.array_equal(mono.shadow_objectives, chunked.shadow_objectives)
    for a, b in zip(rm.results, rc.results):
        assert _records(a) == _records(b)
        assert a.guardrail_stats == b.guardrail_stats


def test_guarded_fleet_of_one_is_the_guarded_tuner():
    pol = DeploymentPolicy(min_gain=0.01, rollback_window=4)
    single = _tuner(seed=3, policy=pol)
    want = single.run(6)
    fleet = _fleet(chunk=None, seeds=(3,), policy=pol)
    got = fleet.run(6).results[0]
    assert _records(got) == _records(want)
    assert np.array_equal(fleet.guard_events[0], single.guard_events)
    assert got.guardrail_stats == want.guardrail_stats


def test_guarded_service_equals_the_static_fleet_and_resumes(tmp_path):
    pol = DeploymentPolicy(min_gain=-10.0, rollback_window=4,
                           max_restart_seconds=200.0)
    svc, sids = _service(policy=pol, checkpoint_dir=str(tmp_path))
    svc.advance(5)
    assert set(svc.last_stats["guardrails"]) == set(empty_counters())
    svc.checkpoint()
    svc.advance(4)
    want = {sid: svc.guardrail_stats(sid) for sid in sids}
    want_hist = {sid: _records(svc._sessions[sid]) for sid in sids}

    back = FleetService.restore(str(tmp_path), device="cpu")
    assert back.policy == pol
    back.advance(4)
    for sid in sids:
        assert back.guardrail_stats(sid) == want[sid]
        assert _records(back._sessions[sid]) == want_hist[sid]
    back.request_leave(sids[0])
    back.advance(0)
    res = back.result(sids[0])
    assert res.guardrail_stats["promotions_total"] == \
        want[sids[0]]["promotions_total"]
    assert res.guardrail_stats["policy"]["rollback_window"] == 4


def test_guardrails_require_the_scan_engine():
    env = LustreSimEnv("seq_write", seed=0)
    scal = Scalarizer(weights=W, specs=env.metric_specs)
    with pytest.raises(ValueError, match="scan"):
        Tuner(env, scal, engine="host", policy=DeploymentPolicy(),
              device="cpu")
    with pytest.raises(ValueError, match="scan"):
        FleetTuner.from_grid(["seq_write"], [W], [0], engine="host",
                             env_cls=LustreSimEnv, policy=DeploymentPolicy(),
                             device="cpu")
