"""Port parity: ``repro_torch.random`` (threefry2x32 in PyTorch) against
``jax.random`` under the installed jax's defaults
(``jax_threefry_partitionable=True``). Every raw output must be EQUAL: the
learner init, the key chain and the minibatch indices of the port depend on
these bits."""

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
