"""The port's int8 KV pool ops (``repro_torch.core.kv_quant``) against the
JAX package's on the CPU, on the same numpy inputs.

Codes must be equal: both sides take the same f32 steps in the same
order (zero the junk slots, amax, ``max(amax, 1e-20) / 127``, a true
divide, round half to even, clip to +-127, cast).  Scales are held to
rtol 1e-6 rather than bit equality: they are one max and one divide on
both sides, but XLA may fuse the divide into other ops; 1e-6 is a few
f32 ulps, far below the 1/127 a scale step would move a code.  The port
updates the pools in place, the JAX package returns new ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_quant as jkq
from repro_torch.core import kv_quant as kq


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

L, NB, BS, KV, D = 2, 12, 4, 2, 8


def _pools(rng):
    """Random int8 codes with random scales: a pool that already holds
    other sequences' blocks, so boundary merges read real data."""
    vals = rng.integers(-127, 128, (L, NB, BS, KV, D)).astype(np.int8)
    scales = rng.uniform(0.01, 0.2, (L, NB, KV)).astype(np.float32)
    return vals, scales


def _check(tvals, tscales, jvals, jscales):
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales),
                               rtol=1e-6, atol=0)


def test_quantize_dequantize_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, BS, KV, D)) * 3).astype(np.float32)
    x[0, 1] = 0.0                                 # an all-zero block
    live = rng.random((3, 5, BS)) < 0.7
    q, s = kq.quantize_blocks(torch.from_numpy(x), torch.from_numpy(live))
    jq, js = jkq.quantize_blocks(jnp.asarray(x), jnp.asarray(live))
    _check(q, s, jq, js)
    deq = kq.dequantize_blocks(q, s)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jkq.dequantize_blocks(jq, js)))
    # live values come back within half a step; junk slots as exact zeros
    err = np.abs(deq.numpy() - x) * live[..., None, None]
    assert (err <= s.numpy()[..., None, :, None] / 2 + 1e-7).all()
    assert (deq.numpy()[~live] == 0).all()
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127


@pytest.mark.parametrize("pos_offset", [0, 8, 5])    # 0 / aligned / unaligned
@pytest.mark.parametrize("ctx_cut", [0, 3])          # live to the end / cut
def test_write_prefill_kv_quant_matches_jax(pos_offset, ctx_cut):
    """A padded chunk of S = 6 rows at ``pos_offset`` (a 0-d tensor, as
    the serving chunk passes it); row 1 has its ctx_len cut short.  The
    boundary block at an unaligned offset merges its live prefix."""
    rng = np.random.default_rng(1 + pos_offset + ctx_cut)
    vals, scales = _pools(rng)
    S, B, MB = 6, 2, 5
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    ctx = np.array([pos_offset + S, pos_offset + S - 2 - ctx_cut], np.int32)
    tv, ts = torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())
    kq.write_prefill_kv_quant(tv, ts, 1, torch.from_numpy(k),
                              torch.from_numpy(bt), torch.from_numpy(ctx),
                              torch.tensor(pos_offset, dtype=torch.int32))
    jv, js = jkq.write_prefill_kv_quant(
        jnp.asarray(vals), jnp.asarray(scales), 1, jnp.asarray(k),
        jnp.asarray(bt), jnp.asarray(ctx), jnp.int32(pos_offset))
    _check(tv, ts, jv, js)
    assert not np.array_equal(tv.numpy(), vals)      # something was written
    # an int offset takes the same path
    iv, is_ = torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())
    kq.write_prefill_kv_quant(iv, is_, 1, torch.from_numpy(k),
                              torch.from_numpy(bt), torch.from_numpy(ctx),
                              pos_offset)
    assert torch.equal(iv, tv) and torch.equal(is_, ts)


def test_write_decode_kv_quant_matches_jax():
    """Slot 1 is inactive (position -1: dropped, though it reads a live
    block through table entry 0); slot 2's new token is far larger than
    its block's contents, so the block's scale grows and its old codes
    are requantized; slot 0 opens a fresh block (offset 0)."""
    rng = np.random.default_rng(2)
    vals, scales = _pools(rng)
    B, MB = 3, 3
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    pos = np.array([8, -1, 6], np.int32)
    k_new = rng.normal(size=(B, KV, D)).astype(np.float32)
    k_new[2] *= 50.0
    tv, ts = torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())
    kq.write_decode_kv_quant(tv, ts, 0, torch.from_numpy(k_new),
                             torch.from_numpy(bt), torch.from_numpy(pos))
    jv, js = jkq.write_decode_kv_quant(jnp.asarray(vals), jnp.asarray(scales),
                                       0, jnp.asarray(k_new), jnp.asarray(bt),
                                       jnp.asarray(pos))
    _check(tv, ts, jv, js)
    grown = bt[2, 1]
    assert (ts[0, grown] > torch.from_numpy(scales[0, grown])).all()
    untouched = np.setdiff1d(np.arange(NB), [bt[0, 2], grown])
    np.testing.assert_array_equal(tv[0, untouched].numpy(),
                                  vals[0, untouched])
    # every row inactive: the pools are left as they were
    kq.write_decode_kv_quant(tv, ts, 1, torch.from_numpy(k_new),
                             torch.from_numpy(bt),
                             torch.full((B,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(tv[1].numpy(), vals[1])
    np.testing.assert_array_equal(ts[1].numpy(), scales[1])


def test_copy_blocks_quant_and_gathers_match_jax():
    rng = np.random.default_rng(3)
    vals, scales = _pools(rng)
    src, dst = np.array([1, 3, 1], np.int32), np.array([6, 2, 9], np.int32)
    tv, ts = kq.copy_blocks_quant(torch.from_numpy(vals.copy()),
                                  torch.from_numpy(scales.copy()),
                                  torch.from_numpy(src),
                                  torch.from_numpy(dst))
    jv, js = jkq.copy_blocks_quant(jnp.asarray(vals), jnp.asarray(scales),
                                   jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    bt = np.array([[4, 0, 7], [2, 5, 1]], np.int32)
    got = kq.gather_kv_quant_bounded(tv, ts, 1, torch.from_numpy(bt), 10, 2)
    want = jkq.gather_kv_quant_bounded(jv, js, 1, jnp.asarray(bt), 10, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = kq.gather_kv_quant(tv, ts, 0, torch.from_numpy(bt), 11,
                             torch.bfloat16)
    want = jkq.gather_kv_quant(jv, js, 0, jnp.asarray(bt), 11, jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_cache_modes_and_sizes_match_jax():
    kv, ks_, vv, vs = kq.make_kv_pool_quant(L, NB, BS, KV, D,
                                             device="cpu")
    jk, jv, jks, jvs = jkq.make_kv_pool_quant(L, NB, BS, KV, D)
    cache = kq.KVCache(kv, vv, ks_, vs)
    jcache = jkq.KVCache(jk, jv, jks, jvs)
    assert cache.quantized and cache.block_size == jcache.block_size == BS
    assert cache.nbytes() == jcache.nbytes()
    # the mode-dispatching gather, both pool formats
    rng = np.random.default_rng(5)
    vals, scales = _pools(rng)
    dense = rng.normal(size=vals.shape).astype(np.float32)
    bt = np.array([[3, 9, 1], [0, 5, 7]], np.int32)
    for t, j in ((kq.KVCache(*map(torch.from_numpy, (vals, vals, scales,
                                                     scales))),
                  jkq.KVCache(*map(jnp.asarray, (vals, vals, scales,
                                                 scales)))),
                 (kq.KVCache(torch.from_numpy(dense), torch.from_numpy(dense)),
                  jkq.KVCache(jnp.asarray(dense), jnp.asarray(dense)))):
        for a, b in zip(kq.kv_gather(t, 1, torch.from_numpy(bt), 10,
                                     torch.float32),
                        jkq.kv_gather(j, 1, jnp.asarray(bt), 10,
                                      jnp.float32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert kq.cache_to_state(cache).keys() == jkq.cache_to_state(
        jcache).keys()
    assert kq.normalize_kv_cache_dtype("int8") == "int8"
    assert kq.normalize_kv_cache_dtype("bfloat16") == "bf16"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        kq.normalize_kv_cache_dtype("fp4")
