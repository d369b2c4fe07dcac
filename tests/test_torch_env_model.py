"""Port parity: the pure env model (``repro_torch.envs.lustre_model``,
``repro_torch.envs.base.ModelEnv``) and the action-mapping twin
(``repro_torch.core.action_mapping.coord_maps``) against the JAX package's
``envs/lustre_model.py``, ``envs/base.py`` and ``jax_coord_maps`` on the CPU.

Tolerances (each measured before it was pinned; PERF.md, "Parity bounds"):

* coord maps: index, value, q and log2 EQUAL to the compiled
  ``jax_coord_maps`` over a dense sweep of unit actions and +-3 ulps around
  every rounding edge (the quantization is one fused multiply-add, as XLA
  compiles it; eager JAX rounds each op apart and differs on edges);
* the noise-free surface: within 8 float32 ulps of the compiled JAX
  ``perf_fn`` (measured 5) and within 2e-6 relative of the numpy
  simulator's ``batch_mean_performance`` (float64; measured 5.5e-7);
* ``step_draws``: the key chain EQUAL and every draw bitwise equal to
  ``jax.random`` on the reference's own split order;
* the step math fed the reference's draws: restart costs and warmth EQUAL,
  metrics within ``STEP_ULPS`` = 64 float32 ulps (measured 8, 3, 18 and 51
  on the four env/workload pairs). The reference's compiled XLA fuses
  multiply-adds, turns divisions by constants into products and has its own
  ``exp``/``pow``, so the eager torch step cannot be bitwise;
* ``ModelEnv``: the same bounds through ``apply``/``restart_cost``, with
  evaluation runs interleaved (metrics measured within 18 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.action_mapping import jax_coord_maps
from repro.envs import lustre_sim as j_ls
from repro_torch import convert
from repro_torch import random as jrandom
from repro_torch.core.action_mapping import coord_maps
from repro_torch.envs import lustre_sim as t_ls
from repro_torch.envs.base import ModelEnv
from repro_torch.envs.lustre_model import LustreSimModel, step_draws

SPACES = ["paper_param_space", "magpie8_param_space", "extended_param_space"]
ENVS = [("LustreSimEnv", "seq_write"), ("LustreSimEnv", "file_server"),
        ("LustreSimV2", "seq_write"), ("LustreSimV2", "random_rw")]
STEP_ULPS = 64
PERF_ULPS = 8


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _sweep(space) -> np.ndarray:
    """Unit actions: a dense grid plus +-3 ulps around every knob's
    rounding edges (a * span + off crossing an integer + 0.5)."""
    a = np.linspace(0.0, 1.0, 20_001, dtype=np.float32)
    edges = []
    for spec in space.specs:
        card = spec.cardinality
        span = card - 1 if spec.kind != "boolean" else 1
        for i in range(card):
            e = np.float32((i + 0.5) / max(span, 1))
            if spec.kind == "boolean":
                e = np.float32(0.5)
            for _ in range(3):
                e = np.nextafter(e, np.float32(0))
            for _ in range(7):
                edges.append(e)
                e = np.nextafter(e, np.float32(2))
    return np.clip(np.concatenate([a, np.float32(edges)]), 0, 1)


@pytest.mark.parametrize("space", SPACES)
def test_coord_maps_equal_jax_coord_maps(space):
    sp = getattr(t_ls, space)()
    jmaps, tmaps = jax_coord_maps(getattr(j_ls, space)()), coord_maps(sp)
    a = _sweep(sp)
    for jm, tm in zip(jmaps, tmaps):
        # compiled, as the reference's episode and env step run it (eager
        # JAX rounds each op apart and lands elsewhere on the edges)
        want = {k: np.asarray(v)
                for k, v in jax.jit(jm)(jnp.asarray(a)).items()}
        got = {k: v.numpy() for k, v in tm(torch.from_numpy(a)).items()}
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(want[key].astype(np.float32),
                                          got[key], err_msg=key)


@pytest.mark.parametrize("space", SPACES)
def test_index_trace_helpers_equal(space):
    js, ts = getattr(j_ls, space)(), getattr(t_ls, space)()
    assert ts.is_quantized == js.is_quantized
    assert ts.index_dtype() == js.index_dtype()
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s.cardinality, 50) for s in ts.specs], 1)
    assert ts.configs_from_indices(idx) == js.configs_from_indices(idx)
    idx_t = torch.stack([m(torch.from_numpy(
        rng.uniform(size=50).astype(np.float32)))["idx"]
        for m in coord_maps(ts)], dim=1)
    configs = ts.configs_from_indices(idx_t.numpy().astype(np.int64))
    assert all(ts.validate(c) for c in configs)


@pytest.mark.parametrize("cls,workload", ENVS)
def test_noise_free_surface_matches(cls, workload):
    jenv, tenv = getattr(j_ls, cls)(workload), getattr(t_ls, cls)(workload)
    jmodel, tmodel = jenv.as_model(), tenv.as_model()
    rng = np.random.default_rng(1)
    acts = rng.uniform(size=(64, jenv.param_space.dim)).astype(np.float32)
    got = tmodel._perf_fn(tmodel.params, torch.from_numpy(acts))
    want = jax.jit(jax.vmap(lambda a: jmodel._perf_fn(jmodel.params, a)))(
        jnp.asarray(acts))
    for key in ("throughput", "iops", "util"):
        assert _ulps(got[key].numpy(), np.asarray(want[key])) <= PERF_ULPS
    configs = tenv.param_space.to_configs(acts)
    exact = t_ls.batch_mean_performance([tenv] * 64, configs)
    for key in ("throughput", "iops"):
        ref = np.array([p[key] for p in exact])
        rel = np.abs(got[key].numpy() - ref) / np.abs(ref)
        assert rel.max() <= 2e-6
    one = tmodel.mean_performance(configs[0])
    assert abs(one["throughput"] - exact[0]["throughput"]) <= \
        2e-6 * exact[0]["throughput"]


def _jax_draws(key, n):
    """The reference step's draws, in its own order."""
    key, k_w, k_run, k_samp, k_restart, k_metrics = jax.random.split(key, 6)
    ks = jax.random.split(k_metrics, 10)
    draws = [jax.random.uniform(k_w)[None], jax.random.normal(k_run)[None],
             jax.random.normal(k_samp, (n,)),
             jax.random.uniform(k_restart, minval=12.0, maxval=20.0)[None]]
    draws += [jax.random.normal(ks[i], (n,)) for i in range(10)]
    return key, np.concatenate([np.asarray(d) for d in draws])


def test_step_draws_equal_the_jax_key_chain():
    jk = jax.random.PRNGKey(11)
    tk = jrandom.PRNGKey(11)
    for _ in range(4):
        jk, want = _jax_draws(jk, 12)
        tk, got = step_draws(tk, 12)
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
        assert got.shape == (135,)
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.numpy().view(np.int32))
    # a batch of chains walks like each chain alone
    keys = torch.stack([jrandom.PRNGKey(s) for s in (1, 2)])
    bk, bd = step_draws(keys, 12)
    for i, s in enumerate((1, 2)):
        k1, d1 = step_draws(jrandom.PRNGKey(s), 12)
        assert torch.equal(bk[i], k1) and torch.equal(bd[i], d1)


@pytest.mark.parametrize("cls,workload", ENVS)
def test_step_math_on_the_reference_draws(cls, workload):
    """Both models step from the same state on the same draws (the
    reference's own, fed to the port) over random actions, evaluation runs
    interleaved: costs and warmth equal, metrics within STEP_ULPS."""
    jmodel = getattr(j_ls, cls)(workload).as_model()
    tmodel = getattr(t_ls, cls)(workload).as_model()
    jstate = jmodel.init_state(jax.random.PRNGKey(5))
    tstate = tmodel.init_state(jrandom.PRNGKey(5))
    rng = np.random.default_rng(2)
    worst = 0
    for i in range(24):
        a = rng.uniform(size=jmodel.param_space.dim).astype(np.float32)
        if i % 6 == 5:
            a = prev  # an unchanged config: no restart
        eval_run = i % 4 == 3
        _, draws = _jax_draws(jstate.key, tmodel.n_samples)
        jstate, jvec, jcost = jmodel.step(jstate, jnp.asarray(a), eval_run)
        tstate, tvec, tcost = tmodel.step_fn(
            tmodel.params, tstate, torch.from_numpy(a),
            torch.from_numpy(draws), eval_run)
        assert float(tcost) == float(jcost)
        assert float(tstate.warmth) == float(jstate.warmth)
        np.testing.assert_array_equal(tstate.last_values.numpy(),
                                      np.asarray(jstate.last_values))
        worst = max(worst, _ulps(tvec.numpy(), np.asarray(jvec)))
        prev = a
    assert worst <= STEP_ULPS


@pytest.mark.parametrize("cls,workload", ENVS)
def test_model_env_apply_and_restarts_match(cls, workload):
    jenv = getattr(j_ls, cls)(workload, seed=3).to_model_env()
    tenv = getattr(t_ls, cls)(workload, seed=3).to_model_env(device="cpu")
    rng = np.random.default_rng(0)
    configs = jenv.param_space.to_configs(
        rng.uniform(size=(16, jenv.param_space.dim)))
    configs[5] = configs[4]  # unchanged: no restart drawn
    prev = jenv.param_space.default_config()
    worst = 0
    for i, config in enumerate(configs):
        eval_run = i % 5 == 4
        mj, mt = jenv.apply(config, eval_run), tenv.apply(config, eval_run)
        names = jenv.state_metrics
        worst = max(worst, _ulps([mt[k] for k in names],
                                 [mj[k] for k in names]))
        assert tenv.restart_cost(config, prev) == \
            jenv.restart_cost(config, prev)
        prev = config
    assert worst <= STEP_ULPS
    assert tenv.restart_summary() == jenv.restart_summary()
    assert float(tenv.model_state.warmth) == float(jenv.model_state.warmth)
    np.testing.assert_array_equal(
        tenv.model_state.key.numpy(),
        np.asarray(jenv.model_state.key).astype(np.int64))
    # evaluation-only protocols draw restarts from the host-side stream
    assert tenv.restart_cost(configs[0], configs[1]) == \
        jenv.restart_cost(configs[0], configs[1])


@pytest.mark.parametrize("cls", ["LustreSimEnv", "LustreSimV2"])
def test_as_model_and_to_model_env(cls):
    env = getattr(t_ls, cls)("seq_write", seed=4)
    model = env.as_model()
    assert isinstance(model, LustreSimModel)
    assert model.param_space == env.param_space
    assert model.dfs_scope == tuple(
        k for k in type(env).DFS_SCOPE if k in env.param_space.names)
    assert model.n_samples == 12
    menv = env.to_model_env(device="cpu")
    assert isinstance(menv, ModelEnv) and menv.seed == 4
    assert menv.device == torch.device("cpu")
    jenv = getattr(j_ls, cls)("seq_write", seed=4).to_model_env()
    np.testing.assert_array_equal(
        menv.model_state.key.numpy(),
        np.asarray(jenv.model_state.key).astype(np.int64))
    params = convert.lustre_params_from_numpy(
        [np.asarray(x) for x in jenv.model.params], "cpu")
    for a, b in zip(params, menv.params):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="invalid config"):
        menv.apply({**env.param_space.default_config(), "stripe_count": 99})
