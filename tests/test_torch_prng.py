"""The port's numpy threefry key layer against `jax.random`, word for word."""
import jax
import numpy as np
import pytest
import torch

from repro.core.engine import split_chain as jax_split_chain
from repro_torch.core import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in_match_jax(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for n in (1, 2, 3, 10, 33):
        np.testing.assert_array_equal(prng.split(key, n), np.asarray(jax.random.split(jkey, n)))
    for data in (0, 1, 5, 99, 2**31 + 3):
        np.testing.assert_array_equal(prng.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(jkey, data)))


@pytest.mark.parametrize("n", [0, 1, 4, 9])
def test_split_chain_matches_engine(n):
    key = prng.PRNGKey(3)
    adv, subs = prng.split_chain(key, n)
    jadv, jsubs = jax_split_chain(jax.random.PRNGKey(3), n)
    np.testing.assert_array_equal(adv, np.asarray(jadv))
    np.testing.assert_array_equal(subs, np.asarray(jsubs).reshape(n, 2))
