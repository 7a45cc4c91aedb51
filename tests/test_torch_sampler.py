"""The port's host sampler (``repro_torch.serving.sampler``) against the
JAX package's on the CPU: ``sample`` and ``sample_device``, the legacy
single-key batch sampler, give JAX's token ids bitwise on the same numpy
logits and the same key.  Its noise is one key's partitionable threefry
bits over the B x V positions flattened (``jax.random.categorical`` over
[B, V]); top-k masks below the k-th largest scaled logit.  The reference
runs under ``jax.threefry_partitionable(True)``, as in
``tests/test_torch_sampling.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as J
from repro_torch.serving import sampler as P


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


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


SEEDS = [0, 7, 2 ** 31 - 1]


def _case(B, V, seed):
    rng = np.random.default_rng(1000 * B + V + seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    # greedy and sampled rows mixed; a single row samples
    temps = [0.8] if B == 1 else \
        [0.0 if i % 3 == 0 else 0.5 + 0.15 * i for i in range(B)]
    return logits, temps


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("top_k", [0, 1, 40])
@pytest.mark.parametrize("B,V", [(1, 256), (1, 1000), (8, 256), (8, 1000)])
def test_sample_matches_jax_bitwise(B, V, top_k, seed):
    logits, temps = _case(B, V, seed)
    key = jax.random.PRNGKey(seed)
    want = J.sample(jnp.asarray(logits), key, temps, top_k)
    got = P.sample(torch.from_numpy(logits), np.asarray(key), temps, top_k)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("top_k", [0, 1, 40])
def test_sample_device_matches_jax_bitwise(top_k, seed):
    """The device entry on tensors (the key as a tensor of its bits, the
    temperatures as a tensor): [B] int32 on the logits' device."""
    logits, temps = _case(8, 1000, seed)
    key = jax.random.PRNGKey(seed)
    t = np.asarray(temps, np.float32)
    want = J.sample_device(jnp.asarray(logits), key, jnp.asarray(t), top_k)
    got = P.sample_device(torch.from_numpy(logits),
                          torch.from_numpy(np.array(key).view(np.int32)),
                          torch.from_numpy(t), top_k)
    assert got.dtype == torch.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_tied_logits_at_the_kth_value(seed):
    """Rows whose k-th largest logit is tied with others: every tied
    entry stays in (``scaled < kth`` masks), as in the reference."""
    rng = np.random.default_rng(seed)
    B, V, k = 8, 256, 40
    logits = rng.normal(size=(B, V)).astype(np.float32)
    for row in logits:
        order = np.argsort(-row)
        row[order[k - 3:k + 5]] = row[order[k - 1]]   # 8 ties around the kth
    temps = [0.0, 1.0, 0.7, 2.0, 0.0, 1.3, 0.9, 5.0]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(J.sample(jnp.asarray(logits), key, temps, k))
    got = P.sample(torch.from_numpy(logits), np.asarray(key), temps, k)
    np.testing.assert_array_equal(got, want)
    # no sampled row picks a logit below the tied k-th value
    kth = np.sort(logits, -1)[:, -k]
    assert (logits[np.arange(B), got] >= kth).all()


def test_same_exports_as_the_reference():
    assert P.__all__ == J.__all__
    import repro.serving as js
    import repro_torch.serving as ps
    # neither package re-exports the legacy sampler from its serving layer
    for name in ("sample", "sample_device"):
        assert hasattr(js, name) == hasattr(ps, name) is False
