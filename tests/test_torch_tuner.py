"""The port's slice as a whole: ``Tuner(engine="host")`` of ``repro_torch``
against the JAX reference's, on the CPU, same environments, same seeds.

* The 8 Latin-hypercube warmup decisions and the default metrics are EXACT
  (numpy streams and configs, no learner involved).
* After warmup the actor drives the decisions, so float drift between the
  two learners can change a config. On seq_write, seed 0, 2-D, 30 steps
  (the paper's budget): no step differed (measured). On the 8-D space, 12
  steps: none differed.
* The final throughput gain lies within 0.25 (absolute, gain as a fraction)
  of the reference's; measured equal for the runs below.

The scan engine, ``Tuner(engine="scan")`` over a ``ModelEnv``, against the
reference's scan engine on seq_write seed 0:

* the 8 warmup decisions EXACT; the default metrics within 1e-6 relative
  (measured 1.3e-7 on 2-D and 6.4e-7 on 8-D: the env step is a few ulps off
  the reference's compiled XLA, tests/test_torch_env_model.py);
* the first differing decision: step 16 of 30 on 2-D, none of 12 on 8-D
  (measured); the gain within 0.05 of the reference's (measured 3e-7 on
  both).

Inside the port the scan engine equals the host engine over the same
``ModelEnv`` EXACTLY (configs, metrics, rewards, restarts), in one run and
across progressive runs: the reference's own invariants.
"""

import numpy as np
import pytest

from repro.core import Scalarizer as JScalarizer
from repro.core import Tuner as JTuner
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro_torch.core import Scalarizer, Tuner
from repro_torch.kernels.ddpg_learn import ddpg_learn
from repro_torch.kernels.episode_learn import episode_learn
from repro_torch.envs import LustreSimEnv, LustreSimV2

GAIN_BAND = 0.25


def _pair(j_cls, t_cls, workload, seed, steps):
    jenv, tenv = j_cls(workload, seed=seed), t_cls(workload, seed=seed)
    w = {"throughput": 1.0}
    jt = JTuner(jenv, JScalarizer(weights=w, specs=jenv.metric_specs),
                seed=seed)
    tt = Tuner(tenv, Scalarizer(weights=w, specs=tenv.metric_specs),
               seed=seed, device="cpu")
    return jt.run(steps), tt.run(steps), tt


def _first_config_change(jr, tr):
    return next((i for i, (a, b) in enumerate(zip(jr.history, tr.history))
                 if a.config != b.config), None)


@pytest.mark.parametrize("j_cls,t_cls,steps,same_through", [
    (JLustreSimEnv, LustreSimEnv, 30, 30),
    (JLustreSimV2, LustreSimV2, 12, 12),
], ids=["2d-paper-30", "8d-12"])
def test_tuner_matches_reference(j_cls, t_cls, steps, same_through):
    jr, tr, tuner = _pair(j_cls, t_cls, "seq_write", 0, steps)
    assert tr.default_config == jr.default_config
    assert tr.default_metrics == jr.default_metrics  # exact
    assert [h.config for h in tr.history[:8]] == \
        [h.config for h in jr.history[:8]]  # the warmup decisions, exact
    for a, b in zip(tr.history[:8], jr.history[:8]):
        assert a.metrics == b.metrics and a.reward == b.reward
        assert a.restart_seconds == b.restart_seconds
    first = _first_config_change(jr, tr)
    assert first is None or first >= same_through, first
    assert abs(tr.gain("throughput") - jr.gain("throughput")) <= GAIN_BAND
    assert tr.gain("throughput") > 0
    assert len(tr.history) == steps
    assert all(np.isfinite(list(h.metrics.values())).all()
               for h in tr.history)
    assert tuner.agent.state.step.item() == 96 * steps


def test_progressive_runs_continue_the_session():
    env = LustreSimEnv("seq_write", seed=2)
    tuner = Tuner(env, Scalarizer(weights={"throughput": 1.0},
                                  specs=env.metric_specs),
                  seed=2, eval_runs=1, device="cpu")
    tuner.run(3)
    result = tuner.run(2)
    assert [h.step for h in result.history] == [0, 1, 2, 3, 4]
    assert len(tuner.agent.buffer) == 5


def test_agent_state_dict_round_trip():
    from repro_torch.core import DDPGConfig, MagpieAgent

    cfg = DDPGConfig(12, 2, updates_per_step=4)
    a = MagpieAgent(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        a.observe(rng.random(12), a.act(rng.random(12).astype(np.float32)),
                  0.1, rng.random(12))
        a.learn()
    b = MagpieAgent(cfg, seed=9, device="cpu")
    b.load_state_dict(a.state_dict())
    s = rng.random(12).astype(np.float32)
    np.testing.assert_array_equal(a.act(s, explore=False),
                                  b.act(s, explore=False))
    assert a.learn() == b.learn()


@pytest.mark.parametrize("kwargs,item", [
    ({"engine": "scan"}, "ModelEnv"), ({"policy": object()}, "A10"),
    ({"resilience": object()}, "A10"),
    ({"observation_scopes": ("OSC",)}, "A10")])
def test_scan_engine_layers_are_not_ported_yet(kwargs, item):
    """The scan engine refuses a non-``ModelEnv`` env with the reference's
    ``ValueError``; the layers inside the reference's episode body (ROADMAP
    A10) are not ported."""
    env = LustreSimEnv("seq_write")
    scal = Scalarizer(weights={"throughput": 1.0}, specs=env.metric_specs)
    error = ValueError if item == "ModelEnv" else NotImplementedError
    with pytest.raises(error, match=item):
        Tuner(env, scal, device="cpu", **kwargs)


SCAN_GAIN_BAND = 0.05


def _scan_pair(j_cls, t_cls, steps):
    w = {"throughput": 1.0}
    jenv = j_cls("seq_write", seed=0).to_model_env()
    tenv = t_cls("seq_write", seed=0).to_model_env(device="cpu")
    jt = JTuner(jenv, JScalarizer(weights=w, specs=jenv.metric_specs),
                seed=0, engine="scan")
    tt = Tuner(tenv, Scalarizer(weights=w, specs=tenv.metric_specs),
               seed=0, engine="scan", device="cpu")
    return jt.run(steps), tt.run(steps), tt


@pytest.mark.parametrize("j_cls,t_cls,steps,same_through", [
    (JLustreSimEnv, LustreSimEnv, 30, 16),
    (JLustreSimV2, LustreSimV2, 12, 12),
], ids=["2d-paper-30", "8d-12"])
def test_scan_tuner_matches_reference(j_cls, t_cls, steps, same_through):
    jr, tr, tuner = _scan_pair(j_cls, t_cls, steps)
    assert tr.default_config == jr.default_config
    for key, want in jr.default_metrics.items():
        assert abs(tr.default_metrics[key] - want) <= 1e-6 * abs(want)
    assert [h.config for h in tr.history[:8]] == \
        [h.config for h in jr.history[:8]]  # the warmup decisions, exact
    for a, b in zip(tr.history[:8], jr.history[:8]):
        assert a.restart_seconds == b.restart_seconds
    first = _first_config_change(jr, tr)
    assert first is None or first >= same_through, first
    assert abs(tr.gain("throughput") - jr.gain("throughput")) <= \
        SCAN_GAIN_BAND
    assert tr.gain("throughput") > 0
    assert len(tr.history) == steps
    assert tuner.agent.state.step.item() == 96 * steps
    assert tuner.agent.steps_taken == steps + 1  # + the final recommendation


def _scan_tuner(engine, seed=1, updates=8):
    from repro_torch.core import DDPGConfig, MagpieAgent

    env = LustreSimV2("seq_write", seed=seed).to_model_env(device="cpu")
    agent = MagpieAgent(DDPGConfig.for_env(env, updates_per_step=updates),
                        seed=seed, device="cpu")
    return Tuner(env, Scalarizer(weights={"throughput": 1.0},
                                 specs=env.metric_specs),
                 agent=agent, eval_runs=1, engine=engine, device="cpu")


def _records(history):
    return [(h.config, h.metrics, h.objective, h.reward, h.restart_seconds)
            for h in history]


def test_scan_engine_equals_host_engine_on_the_same_model_env(monkeypatch):
    """The CPU tensor reaches the plain versions: no kernel launches."""
    monkeypatch.setattr(episode_learn, "launches", 0)
    monkeypatch.setattr(ddpg_learn, "launches", 0)
    host, scan = _scan_tuner("host"), _scan_tuner("scan")
    hr, sr = host.run(14), scan.run(14)
    assert _records(hr.history) == _records(sr.history)
    assert hr.best_config == sr.best_config
    assert hr.simulated_restart_seconds == sr.simulated_restart_seconds
    assert host.env.restart_summary() == scan.env.restart_summary()
    for a, b in zip(host.agent.state, scan.agent.state):
        assert a.equal(b)
    assert host.agent._learn_key.equal(scan.agent._learn_key)
    assert host.agent.buffer.state_dict()["next"] == \
        scan.agent.buffer.state_dict()["next"]
    assert episode_learn.launches == 0 and ddpg_learn.launches == 0


def test_scan_progressive_runs_equal_host_progressive_runs():
    """Progressive tuning (10 then 20 steps in two run() calls) on the scan
    engine equals the host engine's, exactly: agent, buffer, noise and the
    env key chain resume identically (the reference pins the same, with its
    3 + 5 steps). Between the calls each engine's final recommendation
    evaluates on the env, so 10 + 20 is not the same run as 30 in one."""
    host, scan = _scan_tuner("host", seed=2), _scan_tuner("scan", seed=2)
    for steps in (10, 20):
        hr, sr = host.run(steps), scan.run(steps)
        assert _records(hr.history) == _records(sr.history)
        assert hr.best_config == sr.best_config
    assert [h.step for h in sr.history] == list(range(30))
    for a, b in zip(host.agent.state, scan.agent.state):
        assert a.equal(b)
    assert host.env.model_state.key.equal(scan.env.model_state.key)
