"""Port parity: the numpy modules the port keeps its own copies of
(action mapping, scalarization, metrics, workloads, the Lustre simulator)
give EXACTLY the reference's results on the same inputs."""

import numpy as np
import pytest

from repro.core import scalarization as j_sc
from repro.envs import lustre_sim as j_ls
from repro_torch.core import scalarization as t_sc
from repro_torch.envs import lustre_sim as t_ls

SPACES = ["paper_param_space", "magpie8_param_space", "extended_param_space"]
ENVS = [("LustreSimEnv", "seq_write"), ("LustreSimEnv", "file_server"),
        ("LustreSimV2", "seq_write"), ("LustreSimV2", "random_rw")]


def _actions(space_dim, n=200, seed=0):
    rng = np.random.default_rng(seed)
    acts = rng.uniform(-0.1, 1.1, size=(n, space_dim))
    acts[:8] = np.linspace(0.0, 1.0, 8)[:, None]  # rounding edges
    return acts


@pytest.mark.parametrize("space", SPACES)
def test_param_space_round_trips_equal(space):
    js, ts = getattr(j_ls, space)(), getattr(t_ls, space)()
    acts = _actions(js.dim)
    jc, tc = js.to_configs(acts), ts.to_configs(acts)
    assert jc == tc
    np.testing.assert_array_equal(js.to_actions(jc), ts.to_actions(tc))
    assert js.default_config() == ts.default_config()
    assert [js.to_config(a) for a in acts[:20]] == \
        [ts.to_config(a) for a in acts[:20]]
    assert js.grid(3) == ts.grid(3)
    assert all(ts.validate(c) for c in tc)


@pytest.mark.parametrize("cls,workload", ENVS)
def test_batch_mean_performance_equal(cls, workload):
    jenv, tenv = getattr(j_ls, cls)(workload), getattr(t_ls, cls)(workload)
    configs = jenv.param_space.to_configs(_actions(jenv.param_space.dim, 64))
    assert j_ls.batch_mean_performance([jenv] * 64, configs) == \
        t_ls.batch_mean_performance([tenv] * 64, configs)


@pytest.mark.parametrize("cls,workload", ENVS)
def test_apply_and_restart_streams_equal(cls, workload):
    """A fixed config sequence, short and evaluation runs interleaved: the
    metric dicts and restart costs are the same numbers (same PCG64
    streams)."""
    jenv = getattr(j_ls, cls)(workload, seed=5)
    tenv = getattr(t_ls, cls)(workload, seed=5)
    configs = jenv.param_space.to_configs(_actions(jenv.param_space.dim, 12))
    prev = jenv.param_space.default_config()
    for i, config in enumerate(configs):
        assert jenv.apply(config, eval_run=i % 4 == 3) == \
            tenv.apply(config, eval_run=i % 4 == 3)
        assert jenv.restart_cost(config, prev) == \
            tenv.restart_cost(config, prev)
        prev = config
    assert jenv.restart_summary() == tenv.restart_summary()
    assert jenv.sim_clock == tenv.sim_clock


def test_scalarizer_and_normalize_state_equal():
    env = j_ls.LustreSimV2("seq_read", seed=3)
    configs = env.param_space.to_configs(_actions(env.param_space.dim, 10))
    metrics = [env.apply(c) for c in configs]
    t_specs = t_ls.lustre_metric_specs()
    for weights in ({"throughput": 1.0}, {"throughput": 0.6, "iops": 0.4}):
        js = j_sc.Scalarizer(weights=weights, specs=env.metric_specs)
        ts = t_sc.Scalarizer(weights=weights, specs=t_specs)
        for prev, new in zip(metrics[:-1], metrics[1:]):
            assert js.objective(new) == ts.objective(new)
            assert js.reward(prev, new) == ts.reward(prev, new)
    for m in metrics:
        np.testing.assert_array_equal(
            j_sc.normalize_state(m, env.metric_specs, env.state_metrics),
            t_sc.normalize_state(m, t_specs, env.state_metrics))


def test_pure_model_twin_is_ported():
    """``as_model``/``to_model_env`` give the torch model and its adapter
    (parity with the reference in tests/test_torch_env_model.py)."""
    from repro_torch.envs.lustre_model import LustreSimModel

    env = t_ls.LustreSimV2("seq_write")
    assert isinstance(env.as_model(), LustreSimModel)
    assert env.as_model().dfs_scope == ("service_threads", "checksums")
    menv = env.to_model_env(device="cpu")
    metrics = menv.apply(env.param_space.default_config())
    assert list(metrics) == env.state_metrics
    assert all(np.isfinite(list(metrics.values())))
