"""The port's fleet runtime on the CPU: ``BatchedReplayBuffer``,
``fleet_init``, ``fleet_learn_scan``, ``FleetAgent`` and ``FleetTuner`` of
``repro_torch`` against the port's single-session pieces and against the
JAX reference's fleet, on small fleets (5 sessions, 4 updates a step,
warmup 3, 6 steps), as the reference's own fleet tests run.

Bounds (each measured before it was pinned):

* ``BatchedReplayBuffer``: contents EXACT against N port ``ReplayBuffer``s
  and the reference's ``BatchedReplayBuffer``; ``sample`` EXACT against
  the reference's (the same threefry indices, exact gathers).
* ``fleet_init``: session i EXACT against ``ddpg_init(key i)``.
* ``fleet_learn_scan`` against ``ddpg_learn_scan`` of each session alone
  (6 updates, 2-D and 8-D): the Adam counts exact, the learner within 1e-4
  of its largest value (measured at most 4.4e-5, one 8-D session; the
  others at most 3.7e-7): the plain learner's products are batched over
  sessions on the CPU and round differently at another width.
* A fleet of one equals the single port ``Tuner`` EXACTLY on both engines
  and both spaces: configs, metrics, objectives, rewards, restarts, the
  best configuration and the default metrics.
* The port's host-engine ``FleetTuner`` against the reference's on 5
  sessions, 6 steps: the warmup decisions and the default metrics exact;
  the first differing decision: none of 6 on either space (measured); the
  gain within ``GAIN_BAND`` (measured equal).
"""

import numpy as np
import pytest
import torch

from repro.core import BatchedReplayBuffer as JBatchedReplayBuffer
from repro.core import DDPGConfig as JDDPGConfig
from repro.core import FleetTuner as JFleetTuner
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro_torch import random as jrandom
from repro_torch.core import (
    BatchedReplayBuffer,
    ChunkSupervisor,
    DDPGConfig,
    DeploymentPolicy,
    FleetAgent,
    FleetTuner,
    MagpieAgent,
    ReplayBuffer,
    ResiliencePolicy,
    Scalarizer,
    SharingConfig,
    Tuner,
    ddpg_init,
    fleet_act,
    fleet_init,
    fleet_learn_scan,
    run_fleet_episode_scan,
)
from repro_torch.core.ddpg import ddpg_learn_scan
from repro_torch.envs import ChaosConfig, LustreSimEnv, LustreSimV2

GAIN_BAND = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The fleets here are tiny: one intra-op thread runs them fastest, and
    the suite's parallel workers do not oversubscribe the cores. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEEDS = (0, 1, 2, 3, 4)


def _transitions(rng, n, steps, k=2, m=1):
    return [(rng.random((n, k)).astype(np.float32),
             rng.random((n, m)).astype(np.float32),
             rng.random(n).astype(np.float32),
             rng.random((n, k)).astype(np.float32)) for _ in range(steps)]


def test_batched_buffer_fifo_parity():
    """Per-session contents equal N port ``ReplayBuffer``s and the
    reference's batched buffer, through FIFO eviction; ``sample`` draws the
    reference's minibatches."""
    n, cap = 3, 4
    batched = BatchedReplayBuffer(n, cap, 2, 1, device="cpu")
    singles = [ReplayBuffer(cap, 2, 1, device="cpu") for _ in range(n)]
    ref = JBatchedReplayBuffer(n, cap, state_dim=2, action_dim=1)
    for s, a, r, s2 in _transitions(np.random.default_rng(0), n, 7):
        batched.add(s, a, r, s2)
        ref.add(s, a, r, s2)
        for i, buf in enumerate(singles):
            buf.add(s[i], a[i], float(r[i]), s2[i])
    assert len(batched) == len(ref) == len(singles[0]) == cap
    (bs, ba, br, bs2), sizes = batched.storage()
    assert sizes.tolist() == [cap] * n and batched._next == ref._next
    for i, buf in enumerate(singles):
        (ss, sa, sr, ss2), _ = buf.storage()
        for x, y in ((bs[i], ss), (ba[i], sa), (br[i], sr), (bs2[i], ss2)):
            assert torch.equal(x, y)
    for got, want in zip(batched.as_arrays(), ref.as_arrays()):
        np.testing.assert_array_equal(got, want)
    import jax
    import jax.numpy as jnp

    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 1, 2)])
    keys = torch.stack([jrandom.PRNGKey(s) for s in (0, 1, 2)])
    for got, want in zip(batched.sample(keys, 5), ref.sample(jkeys, 5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    copy = BatchedReplayBuffer(n, cap, 2, 1, storage_backend="host",
                               device="cpu")
    copy.load_state_dict(batched.state_dict())
    assert copy.nbytes == batched.nbytes == 4 * n * cap * (2 + 1 + 1 + 2)
    for x, y in zip(copy.as_arrays(), batched.as_arrays()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("m", [2, 8])
def test_fleet_init_is_ddpg_init_per_session(m):
    cfg = DDPGConfig(12, m)
    seeds = [0, 7, 1003]
    fleet = fleet_init(torch.stack([jrandom.PRNGKey(s) for s in seeds]),
                       cfg, "cpu")
    for i, s in enumerate(seeds):
        for got, want in zip(fleet, ddpg_init(jrandom.PRNGKey(s), cfg,
                                              "cpu")):
            assert torch.equal(got[i], want)


def _storage(rng, cap, size, k, m):
    s, a = np.zeros((cap, k), np.float32), np.zeros((cap, m), np.float32)
    r, s2 = np.zeros(cap, np.float32), np.zeros((cap, k), np.float32)
    s[:size], a[:size] = rng.random((size, k)), rng.random((size, m))
    r[:size], s2[:size] = rng.standard_normal(size), rng.random((size, k))
    return tuple(torch.tensor(x) for x in (s, a, r, s2))


@pytest.mark.parametrize("m", [2, 8])
def test_fleet_learner_sessions_match_single(m):
    cfg = DDPGConfig(12, m, updates_per_step=6)
    seeds = [0, 7, 3]
    states = fleet_init(torch.stack([jrandom.PRNGKey(s) for s in seeds]),
                        cfg, "cpu")
    rng = np.random.default_rng(3)
    data = [_storage(rng, 16, 10, 12, m) for _ in seeds]
    batched = tuple(torch.stack([d[j] for d in data]) for j in range(4))
    keys = torch.stack([jrandom.PRNGKey(s + 3) for s in seeds])
    states, metrics = fleet_learn_scan(
        states, batched, torch.full((3,), 10, dtype=torch.int32), keys, cfg,
        6)
    assert metrics["critic_loss"].shape == (3, 6)
    for i, seed in enumerate(seeds):
        single, _ = ddpg_learn_scan(ddpg_init(jrandom.PRNGKey(seed), cfg,
                                              "cpu"), data[i], 10,
                                    jrandom.PRNGKey(seed + 3), cfg, 6)
        assert torch.equal(states.counts[i], single.counts)
        assert torch.equal(states.step[i], single.step)
        err = (states.flat[i] - single.flat).abs().max()
        assert err <= 1e-4 * single.flat.abs().max(), (i, float(err))
    with pytest.raises(ValueError, match="empty replay"):
        fleet_learn_scan(states, batched, torch.zeros(3, dtype=torch.int32),
                         keys, cfg, 6)


def test_fleet_act_of_one_is_the_agent_act_and_independent_of_n():
    cfg = DDPGConfig(12, 2)
    seeds = list(range(6))
    agents = [MagpieAgent(cfg, seed=s, device="cpu") for s in seeds]
    flat = torch.stack([a.state.flat for a in agents])
    x = torch.tensor(np.random.default_rng(0).random((6, 12)),
                     dtype=torch.float32)
    whole = fleet_act(flat, x, cfg)
    for i, agent in enumerate(agents):
        agent.steps_taken = agent.warmup_steps
        assert torch.equal(whole[i], torch.as_tensor(
            agent.act(x[i].numpy(), explore=False)))
        assert torch.equal(fleet_act(flat[i:i + 1], x[i:i + 1], cfg)[0],
                           whole[i])


def test_the_cards_folded_layer_is_independent_of_the_width():
    """On a card ``fleet_act`` runs each layer as an in-order fold of
    products (``_folded_layer``, elementwise operations only): every
    session's outputs are the same bits at any width, and within 1e-6 of
    the product ``x @ w + b`` (measured 2.0e-7)."""
    from repro_torch.core.ddpg import _folded_layer

    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((6, 64)), dtype=torch.float32)
    layer = {"w": torch.tensor(rng.standard_normal((6, 64, 12)),
                               dtype=torch.float32),
             "b": torch.tensor(rng.standard_normal((6, 12)),
                               dtype=torch.float32)}
    whole = _folded_layer(x, layer)
    for i in range(6):
        one = _folded_layer(x[i:i + 1], {k: v[i:i + 1]
                                         for k, v in layer.items()})
        assert torch.equal(one[0], whole[i])
    want = (x.double()[:, None] @ layer["w"].double())[:, 0] + layer["b"]
    assert float((whole - want).abs().max() / want.abs().max()) <= 1e-6


def test_fleet_agent_act_respects_warmup_and_bounds():
    cfg = DDPGConfig(state_dim=2, action_dim=2)
    agent = FleetAgent(cfg, seeds=[0, 1, 2], warmup_steps=3, device="cpu")
    states = np.full((3, 2), 0.5, np.float32)
    for _ in range(6):
        a = agent.act(states)
        assert a.shape == (3, 2)
        assert (a >= 0.0).all() and (a <= 1.0).all()
    a0 = FleetAgent(cfg, seeds=[0, 1], warmup_steps=1,
                    device="cpu").act(states[:2])
    assert not np.allclose(a0[0], a0[1])


def test_host_store_learns_like_the_device_store():
    cfg = DDPGConfig(state_dim=3, action_dim=2, updates_per_step=3)
    agents = [FleetAgent(cfg, seeds=[4, 5], store=store, init_chunk=1,
                         device="cpu") for store in ("device", "host")]
    for s, a, r, s2 in _transitions(np.random.default_rng(1), 2, 4, 3, 2):
        for agent in agents:
            agent.observe(s, a, r, s2)
            agent.learn()
    for x, y in zip(*(agent.states for agent in agents)):
        assert torch.equal(x, y)


def _records(result):
    return [(h.config, h.metrics, h.objective, h.reward, h.restart_seconds)
            for h in result.history]


@pytest.mark.parametrize("engine", ["host", "scan"])
@pytest.mark.parametrize("env_cls", [LustreSimEnv, LustreSimV2])
def test_fleet_of_one_matches_single_tuner(engine, env_cls):
    seed, steps = 5, 6
    env = env_cls("seq_write", seed=seed)
    if engine == "scan":
        env = env.to_model_env(device="cpu")
    cfg = DDPGConfig.for_env(env, updates_per_step=4)
    agent = MagpieAgent(cfg, seed=seed, warmup_steps=3, device="cpu")
    single = Tuner(env, Scalarizer(weights={"throughput": 1.0},
                                   specs=env.metric_specs), agent,
                   engine=engine, eval_runs=1, device="cpu").run(steps)
    fleet = FleetTuner.from_grid(
        ["seq_write"], [{"throughput": 1.0}], [seed], env_cls=env_cls,
        engine=engine, ddpg_config=cfg, warmup_steps=3, eval_runs=1,
        device="cpu")
    got = fleet.run(steps).results[0]
    assert _records(got) == _records(single)
    assert got.best_config == single.best_config
    assert got.best_objective == single.best_objective
    assert got.default_metrics == single.default_metrics
    assert got.simulated_restart_seconds == single.simulated_restart_seconds


def _reference_pair(j_cls, t_cls, engine, steps=6):
    grid = (["seq_write"], [{"throughput": 1.0}], list(SEEDS))
    kw = dict(engine=engine, eval_runs=1, warmup_steps=3)
    jf = JFleetTuner.from_grid(*grid, env_cls=j_cls, ddpg_config=JDDPGConfig.
                               for_env(j_cls("seq_write"),
                                       updates_per_step=4), **kw)
    tf = FleetTuner.from_grid(*grid, env_cls=t_cls, ddpg_config=DDPGConfig.
                              for_env(t_cls("seq_write"),
                                      updates_per_step=4),
                              device="cpu", **kw)
    return jf.run(steps), tf.run(steps)


def _first_config_change(jr, tr):
    return next((i for i, (a, b) in enumerate(zip(jr.history, tr.history))
                 if a.config != b.config), None)


@pytest.mark.parametrize("j_cls,t_cls,same_through", [
    (JLustreSimEnv, LustreSimEnv, 6), (JLustreSimV2, LustreSimV2, 6)],
    ids=["2d", "8d"])
def test_host_fleet_matches_reference(j_cls, t_cls, same_through):
    jres, tres = _reference_pair(j_cls, t_cls, "host")
    assert tres.labels == jres.labels
    for jr, tr in zip(jres.results, tres.results):
        assert tr.default_config == jr.default_config
        assert tr.default_metrics == jr.default_metrics  # exact
        assert [h.config for h in tr.history[:3]] == \
            [h.config for h in jr.history[:3]]  # the warmup, exact
        for a, b in zip(tr.history[:3], jr.history[:3]):
            assert a.metrics == b.metrics and a.reward == b.reward
            assert a.restart_seconds == b.restart_seconds
        first = _first_config_change(jr, tr)
        assert first is None or first >= same_through, first
    assert np.abs(tres.gains("throughput")
                  - jres.gains("throughput")).max() <= GAIN_BAND
    summary = tres.summary("throughput")
    assert summary["sessions"] == len(SEEDS) and np.isfinite(summary["mean"])


def test_grid_labels_and_progressive_runs():
    fleet = FleetTuner.from_grid(["seq_write", "file_server"],
                                 [{"throughput": 1.0}], [0, 1],
                                 eval_runs=1, device="cpu")
    assert fleet.agent.num_sessions == 4
    assert "file_server|throughput|seed1" in fleet.labels
    r1 = fleet.run(2)
    r2 = fleet.run(2)
    assert all(len(r.history) == 4 for r in r2.results)
    assert r2.by_label("seq_write|throughput|seed0") is r2.results[0]
    for a, b in zip(r1.results, r2.results):
        assert max(h.objective for h in b.history) >= \
            max(h.objective for h in a.history)
    assert fleet.guardrail_stats(0) is None and fleet.health_stats(0) is None
    assert {"default_eval", "act", "env", "learn", "final"} <= \
        set(fleet.timings)


def _small_grid(**kw):
    return FleetTuner.from_grid(["seq_write"], [{"throughput": 1.0}], [0],
                                eval_runs=1, device="cpu", **kw)


@pytest.mark.parametrize("build,item", [
    (lambda: _small_grid(engine="host", policy=DeploymentPolicy()), "scan"),
    (lambda: _small_grid(engine="host",
                         sharing=SharingConfig(shared_replay=True)), "scan"),
    (lambda: _small_grid(engine="host", resilience=ResiliencePolicy()),
     "scan"),
    (lambda: _small_grid(engine="host", supervisor=ChunkSupervisor()),
     "scan"),
    (lambda: _small_grid(engine="scan", chaos=ChaosConfig(
        fail_chunks=((0, 1),)).host()).run(1), "ChunkSupervisor"),
    (lambda: _small_grid(engine="scan", replay_dtype=torch.bfloat16), "A7b"),
    (lambda: _small_grid(engine="scan", devices=["cpu", "cpu"]), "A11d"),
    (lambda: FleetAgent(DDPGConfig(12, 2), [0, 1, 2],
                        replay_groups=[0, 1, 0], device="cpu"),
     "contiguous"),
    (lambda: BatchedReplayBuffer(2, 4, 2, 1, groups=[0, 2], device="cpu"),
     "consecutive"),
    (lambda: BatchedReplayBuffer(2, 4, 2, 1, storage_dtype=np.float16,
                                 device="cpu"), "A7b"),
    (lambda: FleetTuner(*_parts(), engine="scan", cell_size=2,
                        sharing=SharingConfig(avg_every=2), device="cpu"),
     "whole cells"),
    (lambda: run_fleet_episode_scan(*_scan_parts(),
                                    policy=DeploymentPolicy(),
                                    guard=object(), obs_mask=(1.0,) * 12),
     "compose"),
    (lambda: run_fleet_episode_scan(
        *_scan_parts(), policy=DeploymentPolicy(), guard=object(),
        sharing=SharingConfig(shared_replay=True)), "compose"),
    (lambda: run_fleet_episode_scan(*_scan_parts(),
                                    resilience=ResiliencePolicy()),
     "HealthState"),
], ids=["policy", "sharing", "resilience", "supervisor", "chaos", "bf16",
        "devices", "replay_groups", "groups", "storage_dtype", "cell_size",
        "obs_mask", "guard", "health"])
def test_refusals_name_their_roadmap_item(build, item):
    """What is not ported names its ROADMAP item (``NotImplementedError``:
    bfloat16 replay A7b, several cards A11d); everything else gets the
    reference's ``ValueError``: a policy layer on the host engine, chaos
    without a supervisor, replay groups that are not consecutive runs, a
    fleet that is not whole cells, a ``DeploymentPolicy`` beside another
    layer, resilience without a health state."""
    error = NotImplementedError if item in ("A7b", "A11d") else ValueError
    with pytest.raises(error, match=item):
        build()


def _parts():
    fleet = _small_grid()
    return fleet.envs, fleet.scalarizers, fleet.agent


def _scan_parts():
    fleet = _small_grid(engine="scan")
    return (fleet.envs, fleet.agent, fleet.scalarizers, fleet._cur_metrics,
            2)
