"""Port parity: the DDPG learner (``repro_torch.core.ddpg``,
``repro_torch.optim.adam``) against the JAX reference on the CPU, on the
paper's 2-D space shape (m = 2) and the 8-knob shape (m = 8).

Tolerances (measured before pinning, recorded in PERF.md):

* init, minibatch indices, gathers and one Adam step: bitwise;
* one ``_ddpg_step``: per float tensor, max|port - ref| <= 1e-6 x max|ref|
  (measured <= 4.2e-7);
* ``ddpg_learn_scan`` (96 updates): counts and steps exact, per tensor
  max|port - ref| <= 5e-5 x max|ref| (measured <= 2.4e-5 over replay sizes
  1 and 40 and init seeds 0 and 1; the metrics <= 1.7e-6). A raw ulp
  bound is the wrong metric: autograd and ``jax.grad`` sum in different
  orders, and Adam's early sqrt(nu) + eps denominators turn 1-ulp gradient
  differences into large relative differences on near-zero entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.core import ddpg as j_ddpg
from repro_torch import random as jrandom
from repro_torch.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
from repro_torch.core import ddpg as t_ddpg
from repro_torch.optim.adam import AdamHyper, adam_step

DIMS = [(12, 2), (12, 8)]


def _storage(rng, cap, k, m):
    return (rng.random((cap, k)).astype(np.float32),
            rng.random((cap, m)).astype(np.float32),
            rng.standard_normal(cap).astype(np.float32),
            rng.random((cap, k)).astype(np.float32))


def _jax_state(k, m, seed):
    cfg = j_ddpg.DDPGConfig(k, m)
    state, txs = j_ddpg.ddpg_init(jax.random.PRNGKey(seed), cfg)
    return cfg, state, txs


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _worst_rel(port_tree, ref_tree) -> float:
    """Ints must be equal; returns the largest per-tensor
    max|a - b| / max|b| over the float leaves."""
    worst = 0.0
    for a, b in zip(_leaves(port_tree), _leaves(ref_tree)):
        if a.dtype != np.float32:
            np.testing.assert_array_equal(a, b)
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    return worst


@pytest.mark.parametrize("k,m", DIMS)
@pytest.mark.parametrize("seed", [0, 3])
def test_ddpg_init_bitwise(k, m, seed):
    _, jstate, _ = _jax_state(k, m, seed)
    tstate = t_ddpg.ddpg_init(jrandom.PRNGKey(seed), t_ddpg.DDPGConfig(k, m),
                              "cpu")
    got = ddpg_state_to_numpy(tstate, t_ddpg.DDPGConfig(k, m))
    for a, b in zip(_leaves(got), _leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_init_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ddpg.ddpg_init(jrandom.PRNGKey(0), t_ddpg.DDPGConfig(12, 2))


@pytest.mark.parametrize("k,m", DIMS)
def test_one_step_matches_ddpg_update(k, m):
    jcfg, jstate, (atx, ctx) = _jax_state(k, m, 0)
    tcfg = t_ddpg.DDPGConfig(k, m)
    rng = np.random.default_rng(1)
    s, a, r, s2 = _storage(rng, jcfg.batch_size, k, m)
    j_new, j_ms = j_ddpg.ddpg_update(jstate, (s, a, r, s2), jcfg, atx, ctx)
    tstate = ddpg_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   tcfg, "cpu")
    t_new, t_ms = t_ddpg._ddpg_step(
        tstate, tuple(torch.from_numpy(x) for x in (s, a, r, s2)), tcfg)
    assert _worst_rel(ddpg_state_to_numpy(t_new, tcfg), j_new) <= 1e-6
    for key in ("critic_loss", "actor_loss", "q_mean"):
        np.testing.assert_allclose(t_ms[key].numpy(), np.asarray(j_ms[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("k,m", DIMS)
@pytest.mark.parametrize("size", [1, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_learn_scan_matches_reference(k, m, size, seed):
    """The carried-across state, storage, size and key: 96 updates through
    the port's learner (the plain version on the CPU) vs the reference's
    ``ddpg_learn_scan``."""
    jcfg, jstate, (atx, ctx) = _jax_state(k, m, seed)
    tcfg = t_ddpg.DDPGConfig(k, m)
    data = _storage(np.random.default_rng(1), 64, k, m)
    j_new, j_ms = j_ddpg.ddpg_learn_scan(jstate, data, size,
                                         jax.random.PRNGKey(7), jcfg, atx,
                                         ctx, 96)
    tstate = ddpg_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   tcfg, "cpu")
    t_new, t_ms = t_ddpg.ddpg_learn_scan(
        tstate, tuple(torch.from_numpy(x) for x in data), size,
        jrandom.PRNGKey(7), tcfg, 96)
    assert t_new is tstate  # updated in place
    got = ddpg_state_to_numpy(t_new, tcfg)
    assert int(got.step) == int(j_new.step) == 96
    assert int(got.actor_opt[0].count) == int(j_new.actor_opt[0].count)
    assert int(got.critic_opt[0].count) == int(j_new.critic_opt[0].count)
    assert _worst_rel(got, j_new) <= 5e-5
    for key in ("critic_loss", "actor_loss", "q_mean"):
        want = np.asarray(j_ms[key])
        assert float(np.abs(t_ms[key].numpy() - want).max()) <= \
            1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("size", [1, 17, 64])
def test_minibatch_indices_and_gather_bitwise(size):
    key = 11
    want = np.asarray(j_ddpg.sample_minibatch_indices(
        jax.random.PRNGKey(key), 96, 16, jnp.asarray(size)))
    got = t_ddpg.sample_minibatch_indices(jrandom.PRNGKey(key), 96, 16, size)
    np.testing.assert_array_equal(want, got.numpy())
    data = _storage(np.random.default_rng(2), 64, 12, 8)
    j_b = j_ddpg.gather_minibatches(tuple(jnp.asarray(x) for x in data),
                                    jnp.asarray(want))
    t_b = t_ddpg.gather_minibatches(tuple(torch.from_numpy(x) for x in data),
                                    got)
    for a, b in zip(t_b, j_b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_learn_scan_raises_on_empty_buffer():
    cfg = t_ddpg.DDPGConfig(12, 2)
    state = t_ddpg.ddpg_init(jrandom.PRNGKey(0), cfg, "cpu")
    data = tuple(torch.from_numpy(x)
                 for x in _storage(np.random.default_rng(0), 8, 12, 2))
    with pytest.raises(ValueError, match="empty replay buffer"):
        t_ddpg.ddpg_learn_scan(state, data, 0, jrandom.PRNGKey(1), cfg, 4)


@pytest.mark.parametrize("count", [0, 1, 5, 40])
def test_adam_one_step_bitwise(count):
    """One step on shared gradients, moments and count: the port's op order
    is the reference's, bit for bit."""
    rng = np.random.default_rng(count)
    shapes = [(12, 64), (64,), (64, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s))
             .astype(np.float32) for s in shapes]
    mu = [(rng.standard_normal(s) * 1e-3).astype(np.float32) for s in shapes]
    nu = [(rng.random(s) * 1e-6).astype(np.float32) for s in shapes]
    if count == 0:
        mu = [np.zeros_like(x) for x in mu]
        nu = [np.zeros_like(x) for x in nu]
    tx = j_optim.adam(2e-3)
    jst = (j_optim.scale_by_adam().init(params)._replace(
        count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu), ())
    upd, jst2 = tx.update(grads, jst, params)
    j_params = j_optim.apply_updates(params, upd)
    p, m, v, c = adam_step(
        [torch.from_numpy(x) for x in params],
        [torch.from_numpy(x) for x in grads],
        [torch.from_numpy(x) for x in mu], [torch.from_numpy(x) for x in nu],
        torch.tensor(count, dtype=torch.int32), AdamHyper(2e-3))
    assert int(c) == int(jst2[0].count) == count + 1
    for got, want in zip(p + m + v, list(j_params) + list(jst2[0].mu)
                         + list(jst2[0].nu)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_ou_noise_stream_equal():
    jn, tn = j_ddpg.OUNoise(8, seed=4), t_ddpg.OUNoise(8, seed=4)
    for _ in range(60):
        np.testing.assert_array_equal(jn(), tn())
