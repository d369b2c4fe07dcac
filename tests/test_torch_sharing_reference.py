"""The port's experience sharing against the JAX package's on the CPU, same
environments, same seeds (the JAX side runs as
``tests/test_shared_experience.py`` runs it). The port alone is
``tests/test_torch_sharing.py``.

Bounds (each measured before it was pinned; "scaled" is max |port - ref|
over max |ref| of the tensor):

* a fleet of 2 cells x 2 sessions (seq_write and random_rw, seeds 0 and 1;
  4 updates a step, warmup 3, windows of 16, chunks of 2, 6 steps) under
  ``SharingConfig(shared_replay=True, avg_every=2, avg_opt_state=True)``,
  on the 2-D and the 8-D space: every committed configuration and restart
  second EQUAL, the cells' cursors and sizes EQUAL, the merged windows
  within ``WINDOW_SCALED`` = 1e-5 (measured 3.1e-7: the env step is a few
  ulps off the reference's compiled XLA, ``tests/test_torch_env_model.py``,
  and the actions follow the learners), the averaged learners (parameters,
  targets and Adam moments) within ``LEARNER_SCALED`` = 1e-5 (measured
  3.5e-7), the objectives within ``OBJ_RTOL`` = 1e-6 relative (measured
  3.1e-7). The cell mean folds a cell's 2 lanes as the reference's sum
  does, so at this cell size its order of sums is the reference's;
* the scoped ``Tuner`` (``observation_scopes=("OSC",)``, LustreSimV2
  seed 2, 16 updates a step, 8 steps): every configuration EQUAL, the
  window's cursor and size EQUAL, its state rows within ``WINDOW_SCALED``
  (measured 1.3e-7) and zero in every masked column, the objectives within
  ``OBJ_RTOL`` (measured 4.3e-7).
"""

import numpy as np
import pytest
import torch

from repro.core import DDPGConfig as JDDPGConfig
from repro.core import FleetTuner as JFleetTuner
from repro.core import MagpieAgent as JMagpieAgent
from repro.core import Scalarizer as JScalarizer
from repro.core import SharingConfig as JSharingConfig
from repro.core import Tuner as JTuner
from repro.envs import LustreSimEnv as JLustreSimEnv
from repro.envs import LustreSimV2 as JLustreSimV2
from repro_torch.core import DDPGConfig, FleetTuner, MagpieAgent, \
    Scalarizer, SharingConfig, Tuner
from repro_torch.envs import LustreSimEnv, LustreSimV2

W = {"throughput": 1.0}
WINDOW_SCALED = 1e-5
LEARNER_SCALED = 1e-5
OBJ_RTOL = 1e-6
SHARING = dict(shared_replay=True, avg_every=2, avg_opt_state=True)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the learners are tiny, and the suite's parallel
    workers do not oversubscribe the cores. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scaled(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_histories(t_result, j_result):
    assert [h.config for h in t_result.history] == \
        [h.config for h in j_result.history]
    assert [h.restart_seconds for h in t_result.history] == \
        [h.restart_seconds for h in j_result.history]
    t = np.array([h.objective for h in t_result.history], np.float64)
    j = np.array([h.objective for h in j_result.history], np.float64)
    assert (np.abs(t - j) / np.maximum(np.abs(j), 1e-30)).max() <= OBJ_RTOL


def _j_flat(states, n: int) -> np.ndarray:
    """The reference's stacked learners in the port's ``flat`` layout:
    the actor, critic and their targets, then the Adam moments (mu, nu) of
    the actor and of the critic, each layer's w then b."""
    parts = []

    def add(net):
        for layer in net:
            parts.extend(np.asarray(layer[key]).reshape(n, -1)
                         for key in ("w", "b"))

    for name in ("actor", "critic", "actor_targ", "critic_targ"):
        add(getattr(states, name))
    for opt in (states.actor_opt, states.critic_opt):
        add(opt[0].mu)
        add(opt[0].nu)
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("j_cls,t_cls", [(JLustreSimEnv, LustreSimEnv),
                                         (JLustreSimV2, LustreSimV2)],
                         ids=["2d", "8d"])
def test_sharing_fleet_matches_reference(j_cls, t_cls):
    kw = dict(engine="scan", eval_runs=1, warmup_steps=3, buffer_capacity=16,
              chunk=2)
    grid = (["seq_write", "random_rw"], [W], [0, 1])
    jf = JFleetTuner.from_grid(
        *grid, env_cls=j_cls, sharing=JSharingConfig(**SHARING),
        ddpg_config=JDDPGConfig.for_env(j_cls("seq_write"),
                                        updates_per_step=4), **kw)
    tf = FleetTuner.from_grid(
        *grid, env_cls=t_cls, sharing=SharingConfig(**SHARING),
        ddpg_config=DDPGConfig.for_env(t_cls("seq_write"),
                                       updates_per_step=4),
        device="cpu", **kw)
    jr, tr = jf.run(6), tf.run(6)
    for a, b in zip(jr.results, tr.results):
        _assert_histories(b, a)
    j_win, j_next, j_size = jf.agent.buffer.grouped_storage()
    t_win, t_next, t_size = tf.agent.buffer.grouped_storage()
    assert list(t_next) == list(j_next) and list(t_size) == list(j_size)
    for got, want in zip(t_win, j_win):
        assert _scaled(got.numpy(), want) <= WINDOW_SCALED
    j_flat = _j_flat(jf.agent.states, 4)
    assert tf.agent.states.flat.shape == j_flat.shape
    assert _scaled(tf.agent.states.flat.numpy(), j_flat) <= LEARNER_SCALED
    np.testing.assert_array_equal(tf.agent.states.step.numpy(),
                                  np.asarray(jf.agent.states.step))


def test_scoped_tuner_matches_reference():
    jenv = JLustreSimV2("seq_write", seed=2).to_model_env()
    tenv = LustreSimV2("seq_write", seed=2).to_model_env(device="cpu")
    jt = JTuner(jenv, JScalarizer(weights=W, specs=jenv.metric_specs),
                JMagpieAgent(JDDPGConfig.for_env(jenv, updates_per_step=16),
                             seed=2, warmup_steps=2, buffer_capacity=16),
                engine="scan", eval_runs=1, observation_scopes=("OSC",))
    tt = Tuner(tenv, Scalarizer(weights=W, specs=tenv.metric_specs),
               MagpieAgent(DDPGConfig.for_env(tenv, updates_per_step=16),
                           seed=2, warmup_steps=2, buffer_capacity=16,
                           device="cpu"),
               engine="scan", eval_runs=1, observation_scopes=("OSC",),
               device="cpu")
    jr, tr = jt.run(8), tt.run(8)
    _assert_histories(tr, jr)
    (js, _, _, js2), j_size = jt.agent.buffer.storage()
    (ts, _, _, ts2), t_size = tt.agent.buffer.storage()
    assert t_size == j_size and tt.agent.buffer._next == jt.agent.buffer._next
    hidden = np.asarray(tt._obs_mask) == 0
    assert hidden.any()
    for got, want in ((ts, js), (ts2, js2)):
        assert _scaled(got.numpy(), want) <= WINDOW_SCALED
        assert not got[:, hidden].any()
