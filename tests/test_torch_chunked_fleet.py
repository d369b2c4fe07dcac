"""The port's streaming chunked fleet runtime on the CPU
(``core/episode.py::run_fleet_episode_scan`` under ``FleetTuner(engine=
"scan")``), on small fleets (5 sessions, 4 updates a step, warmup 3, 6
steps), as the reference's own chunked-fleet tests run.

Bounds (each measured before it was pinned):

* Chunked against monolithic, C in {1, 3, 5} (3: a ragged last chunk of
  2, run at its own width, nothing padded), 2-D and 8-D: every decision,
  metric, objective, reward and restart of every session EXACT (measured 0
  ulps), and so the Adam counts, steps, keys and env states; the learner
  state and the replay window after the run within 1e-6 of their largest
  values (measured at C = 1: learner 1.8e-7 on 2-D, 2.3e-7 on 8-D, window
  6.0e-8, the actions of the steps after the warmup; 0 at C 3 and 5). On
  the CPU the episode's plain version batches its products over the
  chunk's sessions, and a chunk of one runs unbatched products, which round
  differently. (On the card each session is one block of the kernel, and
  chunking is bitwise: ``chip_smoke.py``'s ``fleet`` phase holds it.)
* ``overlap=True`` equals ``overlap=False`` EXACTLY, in one run and across
  progressive runs (on the CPU both run the serial schedule; the card's
  copy streams are held by ``chip_smoke.py``).
* Progressive runs survive chunking: two runs at C = 2 against two
  monolithic runs, within the same bounds as above.
* ``memory_plan``'s learner and replay bytes equal the live tensors'.
* The port's scan ``FleetTuner`` against the reference's on 5 sessions:
  the warmup decisions EXACT, the default metrics within 1e-6 relative
  (measured 2.9e-7 on 2-D, 7.5e-7 on 8-D: the env step is a few ulps off
  the reference's compiled XLA).
"""

import numpy as np
import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import FleetTuner as JFleetTuner
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro_torch.core import (
    DDPGConfig,
    FleetTuner,
    last_fleet_run_stats,
    live_device_bytes,
    memory_plan,
    resolve_chunk,
)
from repro_torch.envs import LustreSimEnv, LustreSimV2

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The fleets here are tiny: one intra-op thread runs them fastest, and
    the suite's parallel workers do not oversubscribe the cores. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(env_cls, chunk, seeds=(0, 1, 2, 3, 4), overlap=True):
    cfg = DDPGConfig.for_env(env_cls("seq_write"), updates_per_step=4)
    return FleetTuner.from_grid(
        ["seq_write"], [{"throughput": 1.0}], list(seeds), env_cls=env_cls,
        engine="scan", ddpg_config=cfg, eval_runs=1, warmup_steps=3,
        chunk=chunk, overlap=overlap, device="cpu")


def _records(result):
    return [(h.config, h.metrics, h.objective, h.reward, h.restart_seconds)
            for h in result.history]


def _assert_same_runs(a, b):
    for ra, rb in zip(a.results, b.results):
        assert _records(ra) == _records(rb)
        assert ra.best_config == rb.best_config
        assert ra.best_objective == rb.best_objective


def _gaps(fa, fb) -> tuple:
    """The learner's and the replay window's largest difference over their
    largest value."""
    a, b = fa.agent.states.flat, fb.agent.states.flat
    window = max(float(np.abs(x - y).max() / np.abs(y).max())
                 for x, y in zip(fa.agent.buffer.as_arrays(),
                                 fb.agent.buffer.as_arrays()))
    return float((a - b).abs().max() / b.abs().max()), window


@pytest.mark.parametrize("env_cls", [LustreSimEnv, LustreSimV2],
                         ids=["2d", "8d"])
def test_chunked_matches_monolithic(env_cls):
    mono_fleet = _fleet(env_cls, None)
    mono = mono_fleet.run(6)
    assert last_fleet_run_stats()["num_chunks"] == 1
    for c in (1, 3, 5):
        fleet = _fleet(env_cls, c)
        got = fleet.run(6)
        stats = last_fleet_run_stats()
        assert stats["chunk"] == c and stats["sessions"] == 5
        assert stats["num_chunks"] == -(-5 // c)
        assert stats["padded_sessions"] == 0
        assert len(got.results) == 5
        _assert_same_runs(mono, got)
        assert max(_gaps(fleet, mono_fleet)) <= RTOL, c
        for x, y in zip(fleet.agent.states[1:], mono_fleet.agent.states[1:]):
            assert torch.equal(x, y)  # Adam counts and steps
        assert torch.equal(fleet.agent._learn_keys,
                           mono_fleet.agent._learn_keys)
        for e, f in zip(fleet.envs, mono_fleet.envs):
            for x, y in zip(e.model_state, f.model_state):
                assert torch.equal(x, y)


def test_overlap_is_bitwise_the_serial_schedule():
    on, off = _fleet(LustreSimEnv, 2), _fleet(LustreSimEnv, 2, overlap=False)
    for steps in (4, 3):
        r_on = on.run(steps)
        assert last_fleet_run_stats()["overlap"] is True
        r_off = off.run(steps)
        assert last_fleet_run_stats()["overlap"] is False
        _assert_same_runs(r_on, r_off)
    for x, y in zip(on.agent.states, off.agent.states):
        assert torch.equal(x, y)
    staging = last_fleet_run_stats()["staging"]
    assert staging["async"] is False and staging["drain_seconds"] >= 0.0


def test_progressive_runs_survive_chunking():
    mono, chunked = _fleet(LustreSimEnv, None), _fleet(LustreSimEnv, 2)
    for steps in (3, 4):
        _assert_same_runs(mono.run(steps), chunked.run(steps))
    assert max(_gaps(chunked, mono)) <= RTOL
    assert all(len(h) == 7 for h in chunked.histories)
    assert chunked.agent.steps_taken == 7 + 2  # + two final recommendations


def test_resolve_chunk():
    for n in (1, 5, 64, 1000):
        for chunk in (None, 1, 3, 16, 4096):
            c = resolve_chunk(n, chunk)
            assert c == min(n, chunk or n)
            assert 0 <= -(-n // c) * c - n < c  # the ragged rest, one chunk
    with pytest.raises(ValueError):
        resolve_chunk(4, 0)


def test_memory_plan_matches_live_tensors():
    fleet = _fleet(LustreSimV2, 2, seeds=(0, 1, 2))
    plan = fleet.memory_plan(steps=10)
    assert plan["matches_live"], plan
    per = plan["per_session"]
    assert per["learner_bytes"] == plan["live"]["learner_bytes_per_session"]
    assert per["replay_bytes"] == plan["live"]["replay_bytes_per_session"]
    # the paper's 2-D learner: 41,228 floats (~165 KB); the pre-draw's
    # 96 x 16 int32 minibatch indices a step (~184 KB over 30 steps)
    full = memory_plan(DDPGConfig(12, 2), LustreSimEnv().param_space,
                       sessions=1024, steps=30)
    assert full["per_session"]["learner_bytes"] == 4 * 41_228 + 12
    assert full["per_session"]["predraw_bytes_per_step"] == \
        4 * (3 + 11 * 12) + 4 * 96 * 16
    assert plan["chunk_device_bytes"] < plan["fleet_host_bytes"]
    assert plan["chunk"] == 2 and plan["sessions"] == 3
    assert plan["overlap_device_bytes"] == 3 * plan["chunk_device_bytes"]
    assert live_device_bytes() == 0  # no card here


def test_precompile_checks_without_touching_state():
    fleet = _fleet(LustreSimEnv, 2, seeds=(0, 1))
    before = [x.clone() for x in fleet.agent.states]
    assert fleet.precompile(steps=4) is None  # the CPU builds nothing
    for x, y in zip(before, fleet.agent.states):
        assert torch.equal(x, y)
    assert fleet.agent.steps_taken == 0


@pytest.mark.parametrize("j_cls,t_cls", [(JLustreSimEnv, LustreSimEnv),
                                         (JLustreSimV2, LustreSimV2)],
                         ids=["2d", "8d"])
def test_scan_fleet_matches_reference(j_cls, t_cls):
    grid = (["seq_write"], [{"throughput": 1.0}], [0, 1, 2, 3, 4])
    jf = JFleetTuner.from_grid(
        *grid, env_cls=j_cls, engine="scan", eval_runs=1, warmup_steps=3,
        ddpg_config=JDDPGConfig.for_env(j_cls("seq_write"),
                                        updates_per_step=4), chunk=3)
    jres = jf.run(6)
    tres = _fleet(t_cls, 3).run(6)
    for jr, tr in zip(jres.results, tres.results):
        assert tr.default_config == jr.default_config
        for key, want in jr.default_metrics.items():
            assert abs(tr.default_metrics[key] - want) <= 1e-6 * abs(want)
        assert [h.config for h in tr.history[:3]] == \
            [h.config for h in jr.history[:3]]
        for a, b in zip(tr.history[:3], jr.history[:3]):
            assert a.restart_seconds == b.restart_seconds
    assert last_fleet_run_stats()["padded_sessions"] == 0  # 5 = 3 + 2
