"""The port's seeded sampling against ``jax.random`` on the CPU.

``repro_torch.core.sampling`` computes threefry-2x32 in int64 torch
arithmetic with JAX's partitionable random-bits layout, so the keys,
the random bits and the uniforms must be bitwise JAX's, the Gumbel noise
(two ``log``s, whose last bit may differ between XLA and torch) within
1e-6, and the sampled tokens JAX's.  The reference runs under
``jax.threefry_partitionable(True)``: the default of the jax this tree
runs, not of every jax the repo supports.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import sample_from_logits as j_sample
from repro_torch.core import sampling as S


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread.  With torch's default
    of a thread per core in each of several test processes sharing the
    same cores, every small op waits at a barrier for threads the other
    processes hold, and the file runs several times slower (ROADMAP C13,
    C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 40 + 5]
TINY = np.finfo(np.float32).tiny
V = 1001


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])


@pytest.fixture(scope="module")
def step_keys():
    """fold_in(PRNGKey(seed), count) for each seed: the reference's."""
    counts = np.array([0, 5, 17, 2 ** 31 - 1], np.int32)
    return np.stack([np.asarray(jax.random.fold_in(k, c))
                     for k, c in zip(_keys(SEEDS), counts)]), counts


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bitwise(seed):
    assert np.array_equal(S.threefry_seed(seed),
                          np.asarray(jax.random.PRNGKey(seed)))


def test_fold_in_bitwise(step_keys):
    want, counts = step_keys
    got = S.fold_in(_keys(SEEDS), counts).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_random_bits_and_uniforms_bitwise(step_keys):
    keys, _ = step_keys
    kt = torch.from_numpy(keys.astype(np.int64))
    bits = np.stack([np.asarray(jax.random.bits(k, (V,))) for k in keys])
    assert np.array_equal(S.random_bits(kt, V).numpy(),
                          bits.astype(np.int64))
    u = np.stack([np.asarray(jax.random.uniform(k, (V,), minval=TINY,
                                                maxval=1.)) for k in keys])
    got = S.uniform(kt, V).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), u.view(np.int32))


def test_gumbel_within_1e6(step_keys):
    keys, _ = step_keys
    want = np.stack([np.asarray(jax.random.gumbel(k, (V,))) for k in keys])
    got = S.gumbel(torch.from_numpy(keys.astype(np.int64)), V).numpy()
    # relative, with an absolute floor where the noise crosses zero
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("filters", [False, True],
                         ids=["temperature", "top-k-top-p"])
def test_sample_from_logits_tokens_equal(filters):
    """Greedy, temperature, top-k and top-p rows mixed in one batch, the
    filter branch on and off, rows of several seeds and stream
    positions."""
    rng = np.random.default_rng(0)
    B = 8
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temps = np.array([0, .8, 1., .5, .8, 0, 1.2, .7], np.float32)
    top_ks = np.array([0, 0, 20, 0, 5, 3, 0, 50], np.int32) * filters
    top_ps = np.where(filters, [1, 1, 1, .9, .5, 1, .95, 1],
                      1.).astype(np.float32)
    keys = _keys(range(B))
    counts = np.arange(B, dtype=np.int32) * 3
    want = np.asarray(j_sample(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(counts),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    got = S.sample_from_logits(torch.from_numpy(logits), keys, counts,
                               temps, top_ks, top_ps).numpy()
    assert np.array_equal(got, want)
    assert S.sampling_plan(temps, top_ks, top_ps) == (True, filters)
    # the same rows as device-resident tensors with a host plan
    again = S.sample_from_logits(
        torch.from_numpy(logits), torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(counts), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
        plan=S.sampling_plan(temps, top_ks, top_ps)).numpy()
    assert np.array_equal(again, want)
