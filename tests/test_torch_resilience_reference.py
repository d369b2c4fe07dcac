"""The port's resilient ``Tuner`` and ``FleetTuner`` against the JAX
package's on the CPU, same environments, same seeds, same NaN poison (the
JAX side runs as ``tests/test_resilience.py`` runs it). The port alone is
``tests/test_torch_resilience.py``.

Bounds (each measured before it was pinned):

* the resilient ``Tuner`` on ``LustreSimV2("seq_write", seed=0)`` wrapped
  in a ``FaultInjectedModel`` whose throughput reads NaN at steps 4-5 and
  9, ``ResiliencePolicy(max_resets=2, snapshot_every=2)``, 16 updates a
  step, 12 steps: two resets, then a degrade at step 9. Every committed
  configuration, restart second, health event and health record EQUAL
  (measured), and every finite objective within ``OBJ_RTOL`` = 1e-6
  relative (measured 4.8e-7: the env step is a few ulps off the
  reference's compiled XLA, ``tests/test_torch_env_model.py``);
* a resilient fleet of 5 on the same model with NaN at steps 3-4,
  ``ResiliencePolicy(max_resets=1)``, 4 updates a step, warmup 3, chunks
  of 2, 8 steps: every event, decision and health record EQUAL (measured),
  the objectives within ``OBJ_RTOL`` (measured 3.7e-7).
"""

import numpy as np
import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import FleetTuner as JFleetTuner
from repro.core import MagpieAgent as JMagpieAgent
from repro.core import ResiliencePolicy as JResiliencePolicy
from repro.core import Scalarizer as JScalarizer
from repro.core import Tuner as JTuner
from repro.envs import FaultInjectedModel as JFaultInjectedModel
from repro.envs import LustreSimV2 as JLustreSimV2
from repro.envs import ModelEnv as JModelEnv
from repro.envs import nan_poison as j_nan_poison
from repro_torch.core import DDPGConfig, FleetTuner, MagpieAgent, \
    ResiliencePolicy, Scalarizer, Tuner
from repro_torch.envs import FaultInjectedModel, LustreSimV2, ModelEnv, \
    nan_poison

W = {"throughput": 1.0}
OBJ_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the learners are tiny, and the suite's parallel
    workers do not oversubscribe the cores. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_objectives(t_result, j_result):
    """NaN where the reference reads NaN, else within OBJ_RTOL."""
    t = np.array([h.objective for h in t_result.history], np.float64)
    j = np.array([h.objective for h in j_result.history], np.float64)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    ok = np.isfinite(j)
    rel = np.abs(t[ok] - j[ok]) / np.maximum(np.abs(j[ok]), 1e-30)
    assert rel.max() <= OBJ_RTOL


def _assert_decisions(t_result, j_result):
    assert [h.config for h in t_result.history] == \
        [h.config for h in j_result.history]
    assert [h.restart_seconds for h in t_result.history] == \
        [h.restart_seconds for h in j_result.history]
    assert t_result.health_stats == j_result.health_stats
    _assert_objectives(t_result, j_result)


def test_resilient_tuner_matches_reference():
    pol = dict(max_resets=2, snapshot_every=2)
    starts = ((4, 2), (9, 1))
    jenv = JModelEnv(JFaultInjectedModel(
        JLustreSimV2("seq_write", seed=0).as_model(),
        [j_nan_poison("throughput", start=s, duration=d) for s, d in starts]),
        seed=0)
    tenv = ModelEnv(FaultInjectedModel(
        LustreSimV2("seq_write", seed=0).as_model(),
        [nan_poison("throughput", start=s, duration=d) for s, d in starts]),
        seed=0, device="cpu")
    jt = JTuner(jenv, JScalarizer(weights=W, specs=jenv.metric_specs),
                JMagpieAgent(JDDPGConfig.for_env(jenv, updates_per_step=16),
                             seed=0),
                engine="scan", resilience=JResiliencePolicy(**pol))
    tt = Tuner(tenv, Scalarizer(weights=W, specs=tenv.metric_specs),
               MagpieAgent(DDPGConfig.for_env(tenv, updates_per_step=16),
                           seed=0, device="cpu"),
               engine="scan", resilience=ResiliencePolicy(**pol),
               device="cpu")
    jr, tr = jt.run(12), tt.run(12)
    np.testing.assert_array_equal(tt.health_events, jt.health_events)
    assert tr.health_stats["resets_total"] == 2
    assert tr.health_stats["degraded"]
    _assert_decisions(tr, jr)
    assert tr.best_config == jr.best_config


def _j_factory(workload, seed):
    return JModelEnv(JFaultInjectedModel(
        JLustreSimV2(workload, seed=seed).as_model(),
        (j_nan_poison("throughput", start=3, duration=2),)), seed=seed)


def _t_factory(workload, seed):
    return ModelEnv(FaultInjectedModel(
        LustreSimV2(workload, seed=seed).as_model(),
        (nan_poison("throughput", start=3, duration=2),)), seed=seed,
        device="cpu")


def test_resilient_fleet_matches_reference():
    kw = dict(engine="scan", eval_runs=1, warmup_steps=3, chunk=2)
    jf = JFleetTuner.from_grid(
        ["seq_write"], [W], list(range(5)), env_factory=_j_factory,
        ddpg_config=JDDPGConfig.for_env(JLustreSimV2("seq_write"),
                                        updates_per_step=4),
        resilience=JResiliencePolicy(max_resets=1), **kw)
    tf = FleetTuner.from_grid(
        ["seq_write"], [W], list(range(5)), env_factory=_t_factory,
        ddpg_config=DDPGConfig.for_env(LustreSimV2("seq_write"),
                                       updates_per_step=4),
        resilience=ResiliencePolicy(max_resets=1), device="cpu", **kw)
    jr, tr = jf.run(8), tf.run(8)
    np.testing.assert_array_equal(tf.health_events, jf.health_events)
    assert (tf.health_events[:, 4] & 4).all()  # every session degraded
    for a, b in zip(jr.results, tr.results):
        _assert_decisions(b, a)
    # every session dropped the same two writes: the cursors agree
    assert len(tf.agent.buffer) == len(jf.agent.buffer) == 6
