"""The port's model (``repro_torch.models``) against the JAX package on the
CPU, on the same bridged params: RTN quantization bit-exact, and
whole-prompt prefill / decode / prefill-chunk / unified-step logits,
tokens and pools at f32 (atol 1e-4 on logits: the sums run in another
order), over the bf16-mode pool and the int8 pool.  int8 is compared
with int8 only, never with bf16.  Also the paged pool writes, the CoW
copy and the sampler's greedy, guard and top-k/top-p filter paths.

Model: reduced qwen2-1.5b with 12 query heads over 2 KV heads (G = 6),
f32 activations, non-zero qkv biases set through numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import paged_cache as jpc
from repro.core import sampling as jsamp
from repro.core.kv_quant import cache_from_state as j_cache_from_state
from repro.core.kv_quant import cache_to_state as j_cache_to_state
from repro.models import transformer as JT
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.core import paged_cache as pc
from repro_torch.core import sampling as samp
from repro_torch.core.kv_quant import cache_from_state
from repro_torch.models import transformer as T
from repro_torch.models.quantize import quantize_params_rtn


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

CFG_KW = dict(num_heads=12, num_kv_heads=2, dtype="float32")
NB, MB, B, W = 32, 8, 3, 16
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_reduced("qwen2-1.5b", **CFG_KW)
    cfg = get_reduced("qwen2-1.5b", **CFG_KW)
    params = _np(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for b in ("bq", "bk", "bv"):           # init leaves them at zero
        a = params["layers"]["attn"][b]
        params["layers"]["attn"][b] = rng.normal(
            0, 0.5, a.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    out = {"dense": (jp, params_from_numpy(params, device="cpu"))}
    jq = j_rtn(jp, jcfg, group_size=32)
    out["rtn-int4"] = (jq, params_from_numpy(_np(jq), device="cpu"))
    return jcfg, cfg, out


def test_quantize_params_rtn_bit_exact(models):
    jcfg, cfg, m = models
    jp, tp = m["dense"]
    want = _np(j_rtn(jp, jcfg, group_size=32))
    got = quantize_params_rtn(tp, cfg, group_size=32)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert b.numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)

    walk(want, got)


def _close(t, j, tol, err=""):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=0,
                               err_msg=err)


def _pools_close(tcache, jcache):
    """Pools at POOL_TOL; an int8 pool dequantized, within one scale step
    more (a K/V value that differs in its last bits between the two
    sides may round to the neighbouring code) and with scales at rtol
    1e-5."""
    for name, t, j, ts, js in (("k", tcache.k, jcache.k, tcache.k_scale,
                                jcache.k_scale),
                               ("v", tcache.v, jcache.v, tcache.v_scale,
                                jcache.v_scale)):
        if ts is None:
            _close(t, j, POOL_TOL, f"{name}_pool")
            continue
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   err_msg=f"{name}_scales")
        step = ts.numpy()[:, :, None, :, None]
        diff = np.abs(t.float().numpy() * step
                      - np.asarray(j, np.float32) * np.asarray(js)[
                          :, :, None, :, None])
        assert (diff <= step + POOL_TOL).all(), f"{name}_pool"


def _sampling(n):
    return {"keys": np.zeros((n, 2), np.uint32),
            "counts": np.zeros((n,), np.int32),
            "temps": np.zeros((n,), np.float32),
            "top_ks": np.zeros((n,), np.int32),
            "top_ps": np.ones((n,), np.float32)}


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunks_decode_and_unified_step_match_jax(models, quant, kv):
    jcfg, cfg, m = models
    jp, tp = m[quant]
    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32,
                               kv_cache_dtype=kv)
    tst = T.make_decode_state(cfg, B, NB, MB, kv_cache_dtype=kv,
                              device="cpu")
    assert tst.keys() == jst.keys()
    jc = j_cache_from_state(jst)
    tc = cache_from_state(tst)
    prompts = {0: rng.integers(1, V, 40), 2: rng.integers(1, V, 20),
               1: rng.integers(1, V, 12)}
    blocks = {0: [5, 9, 2], 2: [7, 11], 1: [3]}
    last = {}
    # multi-chunk prefill of slots 0 and 2: offsets 0 / aligned, and a
    # padded last chunk
    for slot in (0, 2):
        p = prompts[slot]
        bt = np.zeros((1, MB), np.int32)
        bt[0, :len(blocks[slot])] = blocks[slot]
        for off in range(0, len(p), W):
            n = min(W, len(p) - off)
            toks = np.zeros((1, W), np.int32)
            toks[0, :n] = p[off:off + n]
            jl, jc = JT.prefill_chunk(jcfg, jp, jc, jnp.asarray(toks),
                                      jnp.asarray(bt), jnp.int32(off),
                                      jnp.int32(off + n))
            tl, tc = T.prefill_chunk(cfg, tp, tc, torch.from_numpy(toks),
                                     torch.from_numpy(bt),
                                     torch.tensor(off, dtype=torch.int32),
                                     torch.tensor(off + n,
                                                  dtype=torch.int32))
            _close(tl, jl, LOGIT_TOL, f"chunk {slot}@{off}")
            _pools_close(tc, jc)
        last[slot] = int(np.argmax(np.asarray(jl)[0]))

    # one decode step: slot 1 inactive (seq_len 0: its KV write drops)
    bt = np.zeros((B, MB), np.int32)
    for slot in (0, 2):
        bt[slot, :len(blocks[slot]) + 1] = blocks[slot] + [20 + slot]
    sl = np.array([41, 0, 21], np.int32)
    toks = np.array([last[0], 0, last[2]], np.int32)
    jst = dict(jst, **j_cache_to_state(jc), block_table=jnp.asarray(bt),
               seq_lens=jnp.asarray(sl))
    tst.update(block_table=torch.from_numpy(bt), seq_lens=torch.from_numpy(sl))
    jlog, jst = JT.decode_step(jcfg, jp, jst, jnp.asarray(toks))
    tlog, tst = T.decode_step(cfg, tp, tst, torch.from_numpy(toks))
    _close(tlog, jlog, LOGIT_TOL, "decode")
    _pools_close(cache_from_state(tst), j_cache_from_state(jst))

    # unified step: decode slots 0 and 2 + the first chunk of slot 1
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
    sl = np.array([42, 0, 22], np.int32)
    active = np.array([True, False, True])
    ctoks = np.zeros((1, W), np.int32)
    ctoks[0, :12] = prompts[1]
    cbt = np.zeros((1, MB), np.int32)
    cbt[0, 0] = blocks[1][0]
    jst = dict(jst, seq_lens=jnp.asarray(sl))
    tst.update(seq_lens=torch.from_numpy(sl))
    sp = _sampling(B + 1)
    jout, jst = JT.unified_step(
        jcfg, jp, jst, jnp.asarray(nxt), {k: jnp.asarray(v)
                                          for k, v in sp.items()},
        jnp.asarray(active), jnp.asarray(ctoks), jnp.asarray(cbt),
        jnp.int32(0), jnp.int32(12))
    tout, tst = T.unified_step(
        cfg, tp, tst, torch.from_numpy(nxt), sp, torch.from_numpy(active),
        torch.from_numpy(ctoks), torch.from_numpy(cbt),
        torch.tensor(0, dtype=torch.int32), torch.tensor(12,
                                                         dtype=torch.int32))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tst["seq_lens"].numpy(),
                                  np.asarray(jst["seq_lens"]))
    _pools_close(cache_from_state(tst), j_cache_from_state(jst))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_wave_matches_jax(models, kv):
    """A whole-prompt wave of three right-padded prompts (``T.prefill``):
    last-token logits, seq_lens and the pools the wave wrote; then a
    decode step reads those pools back."""
    jcfg, cfg, m = models
    jp, tp = m["rtn-int4"]
    rng = np.random.default_rng(4)
    S = 24                                       # a prefill_bucket multiple
    lens = np.array([24, 17, 5], np.int32)
    toks = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32,
                               kv_cache_dtype=kv)
    tst = T.make_decode_state(cfg, B, NB, MB, kv_cache_dtype=kv,
                              device="cpu")
    jst["block_table"] = jnp.asarray(bt)
    tst["block_table"] = torch.from_numpy(bt)
    jlog, jst = JT.prefill(jcfg, jp, jst, {"tokens": jnp.asarray(toks),
                                           "ctx_lens": jnp.asarray(lens)})
    tlog, tst = T.prefill(cfg, tp, tst, {"tokens": torch.from_numpy(toks),
                                         "ctx_lens": torch.from_numpy(lens)})
    _close(tlog, jlog, LOGIT_TOL, "prefill")
    np.testing.assert_array_equal(tst["seq_lens"].numpy(), lens)
    _pools_close(cache_from_state(tst), j_cache_from_state(jst))
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
    sl = lens + 1
    jst["seq_lens"] = jnp.asarray(sl)
    tst["seq_lens"] = torch.from_numpy(sl)
    jlog, jst = JT.decode_step(jcfg, jp, jst, jnp.asarray(nxt))
    tlog, tst = T.decode_step(cfg, tp, tst, torch.from_numpy(nxt))
    _close(tlog, jlog, LOGIT_TOL, "decode after prefill")
    _pools_close(cache_from_state(tst), j_cache_from_state(jst))


def test_decode_megastep_greedy_tokens_match_jax(models):
    jcfg, cfg, m = models
    jp, tp = m["rtn-int4"]
    rng = np.random.default_rng(2)
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    tst = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    pool = rng.normal(size=tuple(jst["k_pool"].shape)).astype(np.float32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    sl = np.array([9, 0, 30], np.int32)
    toks = np.array([4, 0, 77], np.int32)
    active = sl > 0
    jst = dict(jst, k_pool=jnp.asarray(pool), v_pool=jnp.asarray(-pool),
               block_table=jnp.asarray(bt), seq_lens=jnp.asarray(sl))
    tst.update(k_pool=torch.from_numpy(pool.copy()),
               v_pool=torch.from_numpy(-pool), block_table=torch.from_numpy(bt),
               seq_lens=torch.from_numpy(sl))
    sp = _sampling(B)
    jout, jst = JT.decode_megastep(
        jcfg, jp, jst, jnp.asarray(toks), {k: jnp.asarray(v)
                                           for k, v in sp.items()},
        jnp.asarray(active), jnp.int32(3), max_horizon=4)
    tout, tst = T.decode_megastep(cfg, tp, tst, torch.from_numpy(toks), sp,
                                  torch.from_numpy(active), 3, max_horizon=4)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tst["seq_lens"].numpy(),
                                  np.asarray(jst["seq_lens"]))
    _close(tst["k_pool"], jst["k_pool"], POOL_TOL, "k_pool")


# ------------------------------------------------------------ pool writes

def test_pool_writes_drop_like_jax():
    """Negative decode positions and prefill positions >= ctx_len are
    dropped (redirected, not indexed out of range); the rest lands where
    the JAX scatter puts it, bit for bit."""
    rng = np.random.default_rng(3)
    L, nb, bs, KV, D = 2, 10, 4, 2, 8
    pool = rng.normal(size=(L, nb, bs, KV, D)).astype(np.float32)
    bt = rng.permutation(nb)[:9].reshape(3, 3).astype(np.int32)
    k_new = rng.normal(size=(3, KV, D)).astype(np.float32)
    pos = np.array([5, -1, 11], np.int32)
    want = jpc.write_decode_kv(jnp.asarray(pool), 1, jnp.asarray(k_new),
                               jnp.asarray(bt), jnp.asarray(pos))
    got = pc.write_decode_kv(torch.from_numpy(pool.copy()), 1,
                             torch.from_numpy(k_new), torch.from_numpy(bt),
                             torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # all rows dropped: the pool is left untouched
    none = pc.write_decode_kv(torch.from_numpy(pool.copy()), 0,
                              torch.from_numpy(k_new), torch.from_numpy(bt),
                              torch.from_numpy(np.full(3, -1, np.int32)))
    np.testing.assert_array_equal(none.numpy(), pool)
    k = rng.normal(size=(2, 6, KV, D)).astype(np.float32)
    ctx = np.array([9, 5], np.int32)
    want = jpc.write_prefill_kv(jnp.asarray(pool), 0, jnp.asarray(k),
                                jnp.asarray(bt[:2]), jnp.asarray(ctx),
                                pos_offset=3)
    got = pc.write_prefill_kv(torch.from_numpy(pool.copy()), 0,
                              torch.from_numpy(k), torch.from_numpy(bt[:2]),
                              torch.from_numpy(ctx),
                              torch.tensor(3, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy_blocks_and_bounded_gather_match_jax():
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(2, 8, 4, 2, 4)).astype(np.float32)
    src, dst = np.array([1, 3, 1], np.int32), np.array([6, 2, 1], np.int32)
    want = jpc.copy_blocks(jnp.asarray(pool), jnp.asarray(src),
                           jnp.asarray(dst))
    got = pc.copy_blocks(torch.from_numpy(pool.copy()), torch.from_numpy(src),
                         torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bt = np.array([[4, 0, 7], [2, 5, 1]], np.int32)
    want = jpc.gather_kv_bounded(jnp.asarray(pool), 1, jnp.asarray(bt), 10, 2)
    got = pc.gather_kv_bounded(torch.from_numpy(pool), 1,
                               torch.from_numpy(bt), 10, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ sampling

def test_greedy_guard_and_filter_match_jax():
    rng = np.random.default_rng(5)
    Bs, V = 6, 50
    logits = rng.normal(size=(Bs, V)).astype(np.float32)
    logits[2, 7] = np.nan
    logits[4] = -np.inf
    sp = _sampling(Bs)
    want = jsamp.sample_from_logits(jnp.asarray(logits), *(
        jnp.asarray(sp[k]) for k in ("keys", "counts", "temps", "top_ks",
                                     "top_ps")), guard=True)
    got = samp.sample_from_logits(torch.from_numpy(logits), sp["keys"],
                                  sp["counts"], sp["temps"], sp["top_ks"],
                                  sp["top_ps"], guard=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scaled = rng.normal(size=(Bs, V)).astype(np.float32)
    ks = np.array([0, 1, 5, 50, 3, 0], np.int32)
    ps = np.array([1.0, 1.0, 0.9, 0.5, 0.3, 0.7], np.float32)
    want = jsamp._filter_top_k_top_p(jnp.asarray(scaled), jnp.asarray(ks),
                                     jnp.asarray(ps))
    got = samp._filter_top_k_top_p(torch.from_numpy(scaled),
                                   torch.from_numpy(ks), torch.from_numpy(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seeded_sampling_is_a_function_of_key_and_count():
    """Temperature sampling depends only on each row's (key, count), not
    on the batch (its bits against JAX's: tests/test_torch_sampling.py)."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    keys = np.array([[1, 2], [3, 4], [1, 2]], np.uint32)
    counts = np.array([5, 5, 5], np.int32)
    temps = np.array([0.8, 0.8, 0.8], np.float32)
    tk, tp = np.zeros(3, np.int32), np.ones(3, np.float32)
    a = samp.sample_from_logits(logits, keys, counts, temps, tk, tp)
    b = samp.sample_from_logits(logits[[2, 1, 0]], keys[[2, 1, 0]], counts,
                                temps, tk, tp)
    assert a.tolist() == b[[2, 1, 0]].tolist()
    assert int(a[0]) == int(a[2])          # same row, same key and count
    u = samp.uniform(samp.fold_in(keys, counts), 40)
    assert float(u.min()) > 0 and float(u.max()) < 1
