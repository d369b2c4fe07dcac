"""The port's persistent ``FleetService`` (``repro_torch/core/service.py``)
on the CPU, on small services (2-D ``LustreSimEnv("seq_write")``, 4
updates a step, warmup 3, one evaluation run, lease width 2), as the
reference's own service tests (``tests/test_service.py``) run.

Bounds (each measured before it was pinned):

* A service whose sessions all join before the first ``advance`` and
  leave after the last equals the static ``FleetTuner(engine="scan",
  chunk=2)`` EXACTLY: every decision, metric, objective, reward and
  restart, the best configuration, objective and metrics, the default
  metrics and the restart seconds. Both run the same chunks of the same
  sessions (on the CPU the episode's plain version batches its products
  over a chunk's sessions, which may round differently at another width;
  here the widths are the same) and evaluate the same sessions together.
* Churn at every boundary is neutral EXACTLY (the survivors' chunk, slots
  0 and 1, is the same in both services; the transient runs in a chunk of
  its own), learners included.
* Kill and resume is EXACT: histories, results, learners and windows.
* Against the reference's ``FleetService`` (3 sessions and a transient, 2
  rounds of 3 steps, 2-D and 8-D): the warmup decisions EXACT; the default
  metrics within 1e-6 relative (measured 2.0e-7 on 2-D, 6.7e-7 on 8-D: the
  env step is a few ulps off the reference's compiled XLA, as
  ``tests/test_torch_chunked_fleet.py`` pins); the first differing
  decision: none of 6 on either space (measured); the throughput gain
  within ``GAIN_BOUND`` (measured at most 5.3e-7 on 2-D, 6.5e-7 on 8-D).
"""

import math

import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import FleetService as JFleetService
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro_torch.core import ChunkSupervisor, DDPGConfig, DeploymentPolicy, \
    FleetService, FleetTuner, ResiliencePolicy, SharingConfig
from repro_torch.envs import ChaosConfig, LustreSimEnv, LustreSimV2

W = {"throughput": 1.0}
GAIN_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The services here are tiny: one intra-op thread runs them fastest,
    and the suite's parallel workers do not oversubscribe the cores.
    Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(env_cls=LustreSimEnv):
    return DDPGConfig.for_env(env_cls("seq_write"), updates_per_step=4)


def _service(chunk=2, **kw):
    kw.setdefault("ddpg_config", _cfg(kw.get("env_cls", LustreSimEnv)))
    kw.setdefault("warmup_steps", 3)
    kw.setdefault("eval_runs", 1)
    kw.setdefault("device", "cpu")
    return FleetService(chunk=chunk, **kw)


def _records(result):
    return [(h.step, h.config, h.metrics, h.objective, h.reward,
             h.restart_seconds) for h in result.history]


def _assert_same_results(a, b):
    """Bitwise equal runs (the wall-clock fields excluded)."""
    assert _records(a) == _records(b)
    assert a.best_config == b.best_config
    assert a.best_objective == b.best_objective
    assert a.best_metrics == b.best_metrics
    assert a.default_config == b.default_config
    assert a.default_metrics == b.default_metrics
    assert a.simulated_restart_seconds == b.simulated_restart_seconds


def _assert_same_learners(a, b):
    for x, y in zip(a.ddpg, b.ddpg):
        assert torch.equal(x, y)
    for key in ("s", "a", "r", "s2", "next", "size"):
        x, y = a.buf[key], b.buf[key]
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(a.learn_key, b.learn_key)


def _leave_all(svc, sids):
    for sid in sids:
        svc.request_leave(sid)
    assert svc.advance(0) == []  # membership-only boundary
    return [svc.result(sid) for sid in sids]


def test_service_matches_static_fleet_exactly():
    seeds, steps = [0, 1, 2, 3], 6
    fleet = FleetTuner.from_grid(
        ["seq_write"], [W], seeds, engine="scan", ddpg_config=_cfg(),
        eval_runs=1, warmup_steps=3, chunk=2, device="cpu")
    static = fleet.run(steps)

    svc = _service()
    # from_grid offsets cell seeds by 1000 per cell: the same here, so
    # both consume the same streams
    sids = [svc.request_join("seq_write", W, s + 1000 * i)
            for i, s in enumerate(seeds)]
    assert svc.advance(steps) == sids
    stats = svc.last_stats
    assert stats["sessions"] == 4 and stats["chunk"] == 2
    assert stats["num_chunks"] == 2 and stats["padded_sessions"] == 0
    assert stats["launch_device_seconds"] == []  # no card here
    assert set(stats["boundary_seconds"]) == {
        "join_learners", "join_evaluations", "leave_finalizations"}
    for sid in sids:
        assert svc.guardrail_stats(sid) is None
        assert svc.health_stats(sid) is None
    results = _leave_all(svc, sids)
    assert svc.active == {} and svc.total_steps == steps
    for got, want in zip(results, static.results):
        _assert_same_results(got, want)


def test_churn_every_boundary_is_bitwise_neutral():
    rounds, steps = 3, 2

    quiet = _service()
    survivors_q = [quiet.request_join("seq_write", W, s) for s in (0, 1)]
    for _ in range(rounds):
        quiet.advance(steps)

    churn = _service()
    survivors_c = [churn.request_join("seq_write", W, s) for s in (0, 1)]
    transient = None
    for r in range(rounds):
        # a fresh tenant joins every round and the previous one departs:
        # membership changes at EVERY boundary while the survivors run
        if transient is not None:
            churn.request_leave(transient)
        transient = churn.request_join("seq_write", W, 50 + r)
        churn.advance(steps)
        assert transient in churn.active
        assert churn.last_stats["num_chunks"] == 2
    for sq, sc in zip(survivors_q, survivors_c):
        _assert_same_learners(quiet._sessions[sq], churn._sessions[sc])
    _leave_all(churn, [transient])
    for a, b in zip(_leave_all(quiet, survivors_q),
                    _leave_all(churn, survivors_c)):
        _assert_same_results(a, b)
    # the transients really ran (steps per round while leased)
    assert len(churn.result(transient).history) == steps


def test_lease_width_runs_ragged_chunks_unpadded():
    """The reference pads every chunk to the lease width so that one
    compiled program serves any population; a launch of the port's kernel
    takes any number of sessions, so growing the population adds chunks
    and the last one runs at its own width."""
    svc = _service()
    svc.request_join("seq_write", W, 0)
    svc.advance(2)
    first = dict(svc.last_stats)
    svc.request_join("seq_write", W, 1)
    svc.request_join("seq_write", W, 2)
    svc.advance(2)
    second = svc.last_stats
    assert (first["num_chunks"], second["num_chunks"]) == (1, 2)
    assert (first["chunk"], second["chunk"]) == (1, 2)
    assert first["padded_sessions"] == second["padded_sessions"] == 0
    assert second["sessions"] == 3


def test_leases_are_recycled():
    svc = _service()
    a = svc.request_join("seq_write", W, 0)
    b = svc.request_join("seq_write", W, 1)
    svc.advance(1)
    assert svc.lease_table() == [a, b]
    svc.request_leave(a)
    c = svc.request_join("seq_write", W, 2)
    svc.advance(1)
    assert svc.lease_table() == [c, b]  # freed slot reused, not appended
    assert svc.result(a).best_config  # departed session finalized


def test_join_and_leave_within_one_boundary():
    """A session that joins and leaves before any boundary is never
    leased, yet gets a result: its default evaluation and final
    recommendation, with no history."""
    svc = _service()
    a = svc.request_join("seq_write", W, 0)
    gone = svc.request_join("seq_write", W, 1)
    svc.request_leave(gone)
    assert svc.advance(2) == [a]
    assert gone not in svc.lease_table() and svc.lease_table() == [a]
    res = svc.result(gone)
    assert res.history == [] and res.default_metrics
    assert res.best_config and math.isfinite(res.best_objective)
    with pytest.raises(KeyError):
        svc.request_leave(gone)


def test_kill_and_resume_is_bitwise(tmp_path):
    ckpt = str(tmp_path / "svc")
    svc = _service(checkpoint_dir=ckpt)
    sids = [svc.request_join("seq_write", W, s) for s in (0, 1, 2)]
    svc.advance(4)
    path = svc.checkpoint()
    assert str(tmp_path) in path

    # the original keeps going...
    svc.advance(3)
    learners = {sid: svc._sessions[sid] for sid in sids}

    # ...and its restored twin continues from the snapshot
    res = FleetService.restore(ckpt, device="cpu")
    assert res.total_steps == 4 and res.lease_table() == sids
    assert set(res.active) == set(sids)
    res.advance(3)
    for sid in sids:
        _assert_same_learners(learners[sid], res._sessions[sid])
    for a, b in zip(_leave_all(svc, sids), _leave_all(res, sids)):
        _assert_same_results(a, b)


def test_checkpoint_refuses_pending_requests(tmp_path):
    svc = _service(checkpoint_dir=str(tmp_path / "svc"))
    svc.request_join("seq_write", W, 0)
    with pytest.raises(RuntimeError, match="pending"):
        svc.checkpoint()
    svc.advance(1)
    svc.checkpoint()  # applied at the boundary -> checkpointable


def test_restore_detects_environment_drift(tmp_path):
    ckpt = str(tmp_path / "svc")
    svc = _service(checkpoint_dir=ckpt)
    svc.request_join("seq_write", W, 0)
    svc.advance(2)
    svc.checkpoint()

    def drifted(workload, seed):
        # a different workload calibration = different model params (the
        # seed alone would not drift them: it only seeds the state's key)
        return LustreSimEnv("random_rw", seed=seed).to_model_env(
            device="cpu")

    with pytest.raises(ValueError, match="drifted"):
        FleetService.restore(ckpt, env_factory=drifted, device="cpu")


def test_restore_refuses_a_missing_leaf(tmp_path):
    """A checkpoint that lacks one of a session's tensors (its CRCs of the
    rest still verify) raises ``KeyError`` rather than starting the
    session afresh."""
    ckpt = tmp_path / "svc"
    svc = _service(checkpoint_dir=str(ckpt))
    svc.request_join("seq_write", W, 0)
    svc.advance(2)
    path = svc.checkpoint()
    tensors = f"{path}/tensors.pt"
    flat = torch.load(tensors, weights_only=True)
    del flat["sessions/0/learn_key"]
    torch.save(flat, tensors)
    with pytest.raises(KeyError, match="learn_key"):
        FleetService.restore(str(ckpt), device="cpu")


def test_fallback_restore_past_a_corrupted_checkpoint(tmp_path):
    """``fallback=True`` walks the keep-k history past a corrupted newest
    step to the one before it; without it the corruption raises."""
    ckpt = str(tmp_path / "svc")
    svc = _service(checkpoint_dir=ckpt, keep=2)
    sids = [svc.request_join("seq_write", W, s) for s in (0, 1)]
    svc.advance(2)
    svc.checkpoint()
    svc.advance(2)
    newest = svc.checkpoint()
    flat = torch.load(f"{newest}/tensors.pt", weights_only=True)
    flat["sessions/0/ddpg/0"][0] += 1.0  # a flipped learner value
    torch.save(flat, f"{newest}/tensors.pt")
    with pytest.raises(IOError):
        FleetService.restore(ckpt, device="cpu")
    back = FleetService.restore(ckpt, fallback=True, device="cpu")
    assert back.total_steps == 2 and back.lease_table() == sids
    step_2 = FleetService.restore(ckpt, step=2, device="cpu")
    for sid in sids:
        _assert_same_learners(step_2._sessions[sid], back._sessions[sid])


@pytest.mark.parametrize("layer,match", [
    ({"policy": DeploymentPolicy(), "resilience": ResiliencePolicy()},
     "compose"),
    ({"policy": DeploymentPolicy(),
      "sharing": SharingConfig(shared_replay=True)}, "compose"),
    ({"sharing": SharingConfig(shared_replay=True), "cell_size": 3},
     "multiple of cell_size"),
    ({"resilience": ResiliencePolicy(max_resets=-1)}, "max_resets"),
    ({"supervisor": ChunkSupervisor(on_failure="crash")}, "on_failure"),
    ({"chaos": ChaosConfig(fail_chunks=((0, 1),)).host()},
     "ChunkSupervisor")], ids=["policy", "sharing", "cell_size",
                               "resilience", "supervisor", "chaos"])
def test_policy_layers_are_refused(layer, match):
    """The reference's ``ValueError``s: a ``DeploymentPolicy`` beside
    resilience or sharing, a lease width that splits cells, an invalid
    resilience policy or supervisor, chaos without a supervisor (at the
    first advance that streams chunks)."""
    with pytest.raises(ValueError, match=match):
        svc = _service(**layer)
        svc.request_join("seq_write", W, 0)
        svc.advance(1)


def test_unknown_session_raises():
    svc = _service()
    with pytest.raises(KeyError):
        svc.request_leave(99)
    with pytest.raises(KeyError):
        svc.result(99)
    with pytest.raises(KeyError):
        svc.guardrail_stats(99)


def _drive(svc):
    """3 sessions and a transient: 2 rounds of 3 steps, the transient
    leaving after the first."""
    sids = [svc.request_join("seq_write", W, s) for s in (0, 1, 2)]
    transient = svc.request_join("seq_write", W, 50)
    svc.advance(3)
    svc.request_leave(transient)
    svc.advance(3)
    sids.append(transient)
    for sid in sids[:3]:
        svc.request_leave(sid)
    svc.advance(0)
    return [svc.result(sid) for sid in sids]


@pytest.mark.parametrize("j_cls,t_cls", [(JLustreSimEnv, LustreSimEnv),
                                         (JLustreSimV2, LustreSimV2)],
                         ids=["2d", "8d"])
def test_service_matches_reference(j_cls, t_cls):
    jres = _drive(JFleetService(
        chunk=2, env_cls=j_cls, warmup_steps=3, eval_runs=1,
        ddpg_config=JDDPGConfig.for_env(j_cls("seq_write"),
                                        updates_per_step=4)))
    tres = _drive(_service(env_cls=t_cls))
    for jr, tr in zip(jres, tres):
        assert len(tr.history) == len(jr.history)
        assert tr.default_config == jr.default_config
        for key, want in jr.default_metrics.items():
            assert abs(tr.default_metrics[key] - want) <= 1e-6 * abs(want)
        for a, b in zip(tr.history[:3], jr.history[:3]):  # the warmup
            assert a.config == b.config
            assert a.restart_seconds == b.restart_seconds
        assert [h.config for h in tr.history] == \
            [h.config for h in jr.history]  # no decision differs (measured)
        assert abs(tr.gain("throughput") - jr.gain("throughput")) <= \
            GAIN_BOUND
