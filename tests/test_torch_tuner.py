"""The port's tuner on the CPU, inside the port: progressive runs, the
agent's state round trip, the refusals, and the scan engine against the
host engine. The comparisons with the JAX reference's tuner are in
``tests/test_torch_tuner_reference.py``.

Inside the port the scan engine equals the host engine over the same
``ModelEnv`` EXACTLY (configs, metrics, rewards, restarts), in one run and
across progressive runs: the reference's own invariants.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import DeploymentPolicy, ResiliencePolicy, \
    Scalarizer, Tuner
from repro_torch.envs import LustreSimEnv, LustreSimV2
from repro_torch.kernels.ddpg_learn import ddpg_learn
from repro_torch.kernels.episode_learn import episode_learn


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One session's learner is tiny: one intra-op thread runs it fastest,
    and the suite's parallel workers do not oversubscribe the cores.
    Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    ({"engine": "scan"}, "ModelEnv"), ({"policy": DeploymentPolicy()}, "scan"),
    ({"resilience": ResiliencePolicy()}, "scan"),
    ({"observation_scopes": ("OSC",)}, "scan")])
def test_scan_engine_layers_are_not_ported_yet(kwargs, item):
    """The scan engine refuses a non-``ModelEnv`` env, and the host engine
    each layer of the episode body (a ``DeploymentPolicy``, a
    ``ResiliencePolicy``, observation scopes), with the reference's
    ``ValueError``s."""
    env = LustreSimEnv("seq_write")
    scal = Scalarizer(weights={"throughput": 1.0}, specs=env.metric_specs)
    with pytest.raises(ValueError, match=item):
        Tuner(env, scal, device="cpu", **kwargs)


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
