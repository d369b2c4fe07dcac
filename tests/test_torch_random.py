"""Port parity: ``repro_torch.random`` (threefry2x32 in PyTorch) against
``jax.random`` under the installed jax's defaults
(``jax_threefry_partitionable=True``). Every raw output must be EQUAL: the
learner init, the key chains, the minibatch indices and the env model's
noise of the port depend on these bits. ``normal`` is bitwise too: its
``erf_inv`` and ``log1p`` are XLA's CPU code rounded step by step (measured
0 differing values of 1,000,095 over five keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import random as jrandom

SEEDS = [0, 1, 2, 7, 42, 12345, 2 ** 31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), jrandom.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      jrandom.split(tk, num).numpy())
    # a chain of splits, as the agent's learn key advances
    for _ in range(4):
        jk, _ = jax.random.split(jk)
        tk, _ = jrandom.split(tk)
    np.testing.assert_array_equal(_np(jk), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), jrandom.PRNGKey(seed)
    for shape in [(1,), (7,), (12, 64), (3, 5, 2)]:
        want = _np(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(want,
                                      jrandom.random_bits(tk, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed):
    """Including the weight-init shapes of both spaces' networks and their
    He bounds (``mlp_init``)."""
    jk, tk = jax.random.PRNGKey(seed), jrandom.PRNGKey(seed)
    shapes = [(12, 64), (64, 64), (64, 2), (64, 8), (14, 64), (20, 64),
              (64, 1), (7,), (3, 5, 2)]
    for shape in shapes:
        bound = float(np.sqrt(6.0 / shape[0]))
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, -bound,
                                             bound))
        got = jrandom.uniform(tk, shape, -bound, bound).numpy()
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    want = np.asarray(jax.random.uniform(jk, (33,)))
    np.testing.assert_array_equal(
        want.view(np.int32), jrandom.uniform(tk, (33,)).numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equal_over_maxval(seed):
    """The learner's draw: ``[96, 16]`` indices in ``[0, size)`` for every
    replay size 1..64, plus a span past 2**16 (the wrapped multiplier)."""
    jk, tk = jax.random.PRNGKey(seed), jrandom.PRNGKey(seed)
    for maxval in list(range(1, 65)) + [100_000, 2 ** 20]:
        want = np.asarray(jax.random.randint(jk, (96, 16), 0, maxval))
        got = jrandom.randint(tk, (96, 16), 0, maxval).numpy()
        np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (5, 3), 3, 9)),
        jrandom.randint(tk, (5, 3), 3, 9).numpy())


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        jrandom.PRNGKey(2 ** 31)
    with pytest.raises(ValueError):
        jrandom.split(jrandom.split(jrandom.PRNGKey(0), 2))
    with pytest.raises(ValueError):
        jrandom.randint(jrandom.PRNGKey(0), (2,), 5, 2)


NORMAL_SHAPES = [(), (1,), (12,), (2, 3), (10, 12), (4097,)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bitwise(seed):
    """Including the env model's draws: a scalar, 12 samples, and the ten
    metric keys' [10, 12]."""
    jk, tk = jax.random.PRNGKey(seed), jrandom.PRNGKey(seed)
    for shape in NORMAL_SHAPES:
        want = np.asarray(jax.random.normal(jk, shape))
        got = jrandom.normal(tk, shape).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(want), _bits(got))


def test_erf_inv_and_log1p_bitwise_over_the_unit_interval():
    """The two functions ``normal`` builds on, on a dense grid with the
    edges: XLA's ``erf_inv`` on (-1, 1) and its ``log1p`` on (-1, 0]."""
    import torch

    u = np.linspace(-1, 1, 100_001, dtype=np.float32)[1:-1]
    u = np.concatenate([u, np.float32([np.nextafter(np.float32(-1), 0),
                                       -0.99718, 0.99718, 0.0, -0.5])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    np.testing.assert_array_equal(
        _bits(want), _bits(jrandom._erf_inv(torch.from_numpy(u)).numpy()))
    x = -np.linspace(0, 1, 100_001, dtype=np.float32)[:-1]
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    np.testing.assert_array_equal(
        _bits(want), _bits(jrandom._log1p_f32(torch.from_numpy(x)).numpy()))


def test_batched_keys_equal_one_key_at_a_time():
    """``*_keys`` on a [3, 2] batch of keys give row i what the single-key
    function gives for key i (randint with one bound per key)."""
    import torch

    keys = torch.stack([jrandom.PRNGKey(s) for s in (0, 5, 99)])
    bounds = torch.tensor([1, 17, 64])
    split = jrandom.split_keys(keys, 6)
    unif = jrandom.uniform_keys(keys, (4,), 12.0, 20.0)
    norm = jrandom.normal_keys(keys, (2, 3))
    ints = jrandom.randint_keys(keys, (96, 16), 0, bounds)
    for i in range(3):
        key = keys[i]
        assert torch.equal(split[i], jrandom.split(key, 6))
        assert torch.equal(unif[i], jrandom.uniform(key, (4,), 12.0, 20.0))
        assert torch.equal(norm[i], jrandom.normal(key, (2, 3)))
        assert torch.equal(ints[i], jrandom.randint(key, (96, 16), 0,
                                                    int(bounds[i])))
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(
                jax.random.PRNGKey([0, 5, 99][i]), (96, 16), 0,
                int(bounds[i]))), ints[i].numpy())
