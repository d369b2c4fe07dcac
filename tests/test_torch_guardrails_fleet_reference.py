"""The port's guarded ``FleetTuner`` and ``FleetService`` against the JAX
package's on the CPU, same environments, same seeds (apart from
``tests/test_torch_guardrails_reference.py`` so that the two files run on
two workers).

Bounds (each measured before it was pinned; policy ``min_gain=0.01,
rollback_window=4``): a guarded fleet of 5 sessions (4 updates a step,
warmup 3, chunks of 2, 6 steps) and a guarded service (3 sessions, lease
width 2, 6 steps in two advances): every event, decision, restart second
and guardrail record EQUAL (measured), the shadow objectives of the
proposals that land on the reference's knobs within ``SHADOW_RTOL`` = 1e-6
relative (measured 2.3e-7; every proposal lands there).
"""

import numpy as np
import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import DeploymentPolicy as JDeploymentPolicy
from repro.core import FleetService as JFleetService
from repro.core import FleetTuner as JFleetTuner
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro_torch.core import DDPGConfig, DeploymentPolicy, FleetService, \
    FleetTuner
from repro_torch.envs import LustreSimEnv
from tests.test_torch_guardrails_reference import POLICY, W, \
    _assert_shadows, _proposals


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the learners are tiny, and the suite's parallel
    workers do not oversubscribe the cores. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_guarded_fleet_matches_reference():
    jf = JFleetTuner.from_grid(
        ["seq_write"], [W], list(range(5)), env_cls=JLustreSimEnv,
        engine="scan", ddpg_config=JDDPGConfig.for_env(
            JLustreSimEnv("seq_write"), updates_per_step=4),
        eval_runs=1, warmup_steps=3, chunk=2,
        policy=JDeploymentPolicy(**POLICY))
    tf = FleetTuner.from_grid(
        ["seq_write"], [W], list(range(5)), env_cls=LustreSimEnv,
        engine="scan", ddpg_config=DDPGConfig.for_env(
            LustreSimEnv("seq_write"), updates_per_step=4),
        eval_runs=1, warmup_steps=3, chunk=2,
        policy=DeploymentPolicy(**POLICY), device="cpu")
    jr, tr = jf.run(6), tf.run(6)
    np.testing.assert_array_equal(tf.guard_events, jf.guard_events)
    space = tf.envs[0].param_space
    (j_rows, _), (t_rows, _) = jf.agent.buffer.storage(), \
        tf.agent.buffer.storage()
    for i, (a, b) in enumerate(zip(jr.results, tr.results)):
        assert [h.config for h in b.history] == [h.config for h in a.history]
        assert b.guardrail_stats == a.guardrail_stats
        _assert_shadows(jf.shadow_objectives[i], tf.shadow_objectives[i],
                        _proposals(np.asarray(j_rows[1])[i], space, 6),
                        _proposals(t_rows[1][i].numpy(), space, 6))


def _drive(svc):
    """3 sessions, 2 advances of 3 steps; every session's record and its
    guard trail kept before they leave."""
    sids = [svc.request_join("seq_write", W, s) for s in (0, 1, 2)]
    svc.advance(3)
    svc.advance(3)
    stats = [svc.guardrail_stats(sid) for sid in sids]
    for sid in sids:
        svc.request_leave(sid)
    svc.advance(0)
    return [svc.result(sid) for sid in sids], stats


def test_guarded_service_matches_reference():
    jres, jstats = _drive(JFleetService(
        chunk=2, env_cls=JLustreSimEnv, warmup_steps=3, eval_runs=1,
        policy=JDeploymentPolicy(**POLICY),
        ddpg_config=JDDPGConfig.for_env(JLustreSimEnv("seq_write"),
                                        updates_per_step=4)))
    tres, tstats = _drive(FleetService(
        chunk=2, env_cls=LustreSimEnv, warmup_steps=3, eval_runs=1,
        policy=DeploymentPolicy(**POLICY), device="cpu",
        ddpg_config=DDPGConfig.for_env(LustreSimEnv("seq_write"),
                                       updates_per_step=4)))
    for jr, tr, js, ts in zip(jres, tres, jstats, tstats):
        assert [h.config for h in tr.history] == [h.config for h in jr.history]
        assert [h.restart_seconds for h in tr.history] == \
            [h.restart_seconds for h in jr.history]
        assert ts == js
        assert tr.guardrail_stats == jr.guardrail_stats


