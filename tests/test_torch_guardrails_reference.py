"""The port's deployment guardrails against the JAX package's on the CPU,
same environments, same seeds: the guarded ``Tuner`` of ``repro_torch``
beside that of ``repro``, and the fault-injected env model. The guarded
fleet and service are ``tests/test_torch_guardrails_fleet_reference.py``
(apart, so that the two files run on two workers); the port alone is
``tests/test_torch_guardrails.py``.

Bounds (each measured before it was pinned; policy ``min_gain=0.01,
rollback_window=4``, the defaults of ``examples/tune_fleet.py``):

* the guarded ``Tuner`` on seq_write seed 0 (16 updates a step), 2-D for
  30 steps and 8-D for 12: every event, committed configuration, restart
  second, promotion, rollback and the budget EQUAL through the last step
  (measured: no step differs on either space);
* its shadow objectives within ``SHADOW_RTOL`` = 1e-6 relative at every
  step whose proposal lands on the reference's knobs (measured: every
  proposal lands there; 2.9e-7 on 2-D, 3.2e-7 on 8-D: the env step is a
  few ulps off the reference's compiled XLA,
  ``tests/test_torch_env_model.py``). A proposal the gate rejects is never
  committed, so where the learners drift apart by float32 rounding (96
  updates a step: from step 12 on 2-D, measured) a proposal may land
  elsewhere while every decision stays equal; such steps are left out;
* ``FaultInjectedModel`` over the reference's on the same key, a collapse
  and a dropout active part of the time, shadow probes interleaved: the
  fault clocks and keys EQUAL, the metrics within the env model's
  ``STEP_ULPS`` = 64 float32 ulps (measured 7).
"""

import numpy as np
import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import DeploymentPolicy as JDeploymentPolicy
from repro.core import MagpieAgent as JMagpieAgent
from repro.core import Scalarizer as JScalarizer
from repro.core import Tuner as JTuner
from repro.envs import FaultInjectedModel as JFaultInjectedModel
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro.envs import ModelEnv as JModelEnv
from repro.envs import metric_dropout as j_metric_dropout
from repro.envs import throughput_collapse as j_throughput_collapse
from repro_torch.core import (
    DDPGConfig,
    DeploymentPolicy,
    MagpieAgent,
    Scalarizer,
    Tuner,
)
from repro_torch.envs import (
    FaultInjectedModel,
    LustreSimEnv,
    LustreSimV2,
    ModelEnv,
    metric_dropout,
    throughput_collapse,
)
from tests.test_torch_env_model import STEP_ULPS, _ulps

W = {"throughput": 1.0}
POLICY = dict(min_gain=0.01, rollback_window=4)
SHADOW_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the learners are tiny, and the suite's parallel
    workers do not oversubscribe the cores. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _proposals(buffer_rows, space, steps):
    """The configurations of the proposals a guarded run stored (the replay
    window's action rows of its first ``steps`` steps)."""
    return space.to_configs(np.asarray(buffer_rows, np.float32)[:steps])


def _assert_shadows(j_shadow, t_shadow, j_props, t_props):
    """Shadow objectives within SHADOW_RTOL where the proposals agree."""
    j_shadow = np.asarray(j_shadow, np.float64)
    t_shadow = np.asarray(t_shadow, np.float64)
    same = [a == b for a, b in zip(j_props, t_props)]
    assert same[0]
    rel = np.abs(t_shadow - j_shadow) / np.maximum(np.abs(j_shadow), 1e-30)
    assert rel[np.array(same)].max() <= SHADOW_RTOL


@pytest.mark.parametrize("j_cls,t_cls,steps", [
    (JLustreSimEnv, LustreSimEnv, 30), (JLustreSimV2, LustreSimV2, 12)],
    ids=["2d-paper-30", "8d-12"])
def test_guarded_tuner_matches_reference(j_cls, t_cls, steps):
    jenv = j_cls("seq_write", seed=0).to_model_env()
    tenv = t_cls("seq_write", seed=0).to_model_env(device="cpu")
    jt = JTuner(jenv, JScalarizer(weights=W, specs=jenv.metric_specs),
                JMagpieAgent(JDDPGConfig.for_env(jenv, updates_per_step=16),
                             seed=0),
                engine="scan", policy=JDeploymentPolicy(**POLICY))
    tt = Tuner(tenv, Scalarizer(weights=W, specs=tenv.metric_specs),
               MagpieAgent(DDPGConfig.for_env(tenv, updates_per_step=16),
                           seed=0, device="cpu"),
               engine="scan", policy=DeploymentPolicy(**POLICY),
               device="cpu")
    jr, tr = jt.run(steps), tt.run(steps)
    np.testing.assert_array_equal(tt.guard_events, jt.guard_events)
    assert [h.config for h in tr.history] == [h.config for h in jr.history]
    assert [h.restart_seconds for h in tr.history] == \
        [h.restart_seconds for h in jr.history]
    assert tr.guardrail_stats == jr.guardrail_stats
    space = tenv.param_space
    _assert_shadows(
        jt.shadow_objectives, tt.shadow_objectives,
        _proposals(jt.agent.buffer.storage()[0][1], space, steps),
        _proposals(tt.agent.buffer.storage()[0][1].numpy(), space, steps))


def test_fault_injected_model_matches_reference():
    j_base = JLustreSimV2("seq_write", seed=7).as_model()
    t_base = LustreSimV2("seq_write", seed=7).as_model()
    jm = JFaultInjectedModel(j_base, [j_throughput_collapse(2, 3, 0.1),
                                      j_metric_dropout("iops", 4, 2)])
    tm = FaultInjectedModel(t_base, [throughput_collapse(2, 3, 0.1),
                                     metric_dropout("iops", 4, 2)])
    jenv, tenv = JModelEnv(jm, seed=7), ModelEnv(tm, seed=7, device="cpu")
    rng = np.random.default_rng(1)
    configs = jenv.param_space.to_configs(
        rng.uniform(size=(10, jenv.param_space.dim)))
    worst = 0
    for i, config in enumerate(configs):
        eval_run = i % 3 == 1  # shadow probes read the clock, never move it
        mj, mt = jenv.apply(config, eval_run), tenv.apply(config, eval_run)
        names = jenv.state_metrics
        worst = max(worst, _ulps([mt[k] for k in names],
                                 [mj[k] for k in names]))
        assert int(tenv.model_state.step) == int(jenv.model_state.step)
        if 4 <= int(jenv.model_state.step) - (not eval_run) < 6:
            assert mt["iops"] == mj["iops"] == 0.0
    assert worst <= STEP_ULPS
    assert int(tenv.model_state.step) == 7
    np.testing.assert_array_equal(
        tenv.model_state.base.key.numpy(),
        np.asarray(jenv.model_state.base.key).astype(np.int64))
    assert float(tenv.model_state.base.warmth) == \
        float(jenv.model_state.base.warmth)
