"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``
bit for bit: keys, splits, raw bits, uniform floats, randint,
permutations and choice with and without probabilities, over several seeds
and shapes (jax 0.9 with partitionable threefry, its default)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, -5]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits(seed):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), _np(k))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                      _np(jax.random.split(k, num)))
    for shape in ((), (5,), (5, 3)):
        np.testing.assert_array_equal(prng.bits(kt, shape).numpy(),
                                      _np(jax.random.bits(k, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (11,), (4, 6)])
def test_uniform(seed, shape):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.uniform(kt, shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,shape", [
    (0, 10, (6,)), (0, 1500, ()), (-7, 100_000, (4, 2)),
    (0, 2 ** 31 - 1, (9,)), (-2 ** 31, 2 ** 31 - 1, (5,)), (3, 3, (2,))])
def test_randint(seed, lo, hi, shape):
    """Spans above 2^16 exercise the wrapped uint32 square of the fold."""
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.randint(kt, shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(k, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 5, 100, 1500, 5000])
def test_permutation_and_choice_without_replacement(seed, n):
    """n = 5000 takes two sort rounds, n <= 1500 one."""
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.permutation(kt, n).numpy(),
                                  np.asarray(jax.random.permutation(k, n)))
    m = min(n, 4)
    np.testing.assert_array_equal(
        prng.choice(kt, n, (m,), replace=False).numpy(),
        np.asarray(jax.random.choice(k, n, (m,), replace=False)))
    np.testing.assert_array_equal(
        prng.choice(kt, n, (3,)).numpy(),
        np.asarray(jax.random.choice(k, n, (3,))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 3, 17, 1500, 4595])
def test_choice_with_probabilities(seed, n):
    """Same float32 p in both: the cumsum follows XLA's CPU order and the
    search jax's fixed-depth bisection, so every draw agrees."""
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    rng = np.random.default_rng(seed & 0xFFFF)
    p = rng.random(n).astype(np.float32)
    p[rng.random(n) < 0.3] = 0.0                  # zero-probability points
    p[0] = max(p[0], 1e-3)
    p /= p.sum()
    assert int(prng.choice(kt, n, p=torch.from_numpy(p))) == int(
        jax.random.choice(k, n, p=jnp.asarray(p)))
    np.testing.assert_array_equal(
        prng.choice(kt, n, (50,), p=torch.from_numpy(p)).numpy(),
        np.asarray(jax.random.choice(k, n, (50,), p=jnp.asarray(p))))


@pytest.mark.parametrize("n", [5, 16, 17, 257, 1500, 70_000])
def test_cumsum_follows_xla_order(n):
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    x /= x.sum()
    np.testing.assert_array_equal(prng.xla_cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_choice_with_probabilities_without_replacement_is_refused():
    with pytest.raises(NotImplementedError):
        prng.choice(prng.PRNGKey(0), 4, (2,), replace=False,
                    p=torch.full((4,), 0.25))
