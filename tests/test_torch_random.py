"""PyTorch port: `utils/random.py` (threefry2x32) against `jax.random`.

The port's quantized stochastic rounding must replay the JAX package's
noise, so its stream is held bit for bit against the installed jax
(partitionable threefry, the jax 0.9 default) for keys, fold_in, split
and uniform at several shapes.
"""

import numpy as np
import pytest
import torch

import jax

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

from lightgbm_tpu_torch.utils import random as R

SEEDS = [0, 5, 42, 2 ** 31 - 1]


def _jkey(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_installed_jax_defaults():
    """The layout this module reproduces is the installed default."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(R.PRNGKey(seed).numpy(),
                                  _jkey(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 123456, 2 ** 31 + 3])
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        R.fold_in(R.PRNGKey(seed), data).numpy(),
        _jkey(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(num):
    key = R.fold_in(R.PRNGKey(5), 11)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 11)
    np.testing.assert_array_equal(R.split(key, num).numpy(),
                                  _jkey(jax.random.split(jkey, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (5, 3), (4096,), (2, 3, 4)])
def test_uniform(shape):
    kg, _ = R.split(R.fold_in(R.PRNGKey(3), 2))
    jkg, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 2))
    got = R.uniform(kg, shape).numpy()
    want = np.asarray(jax.random.uniform(jkg, shape))
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0
