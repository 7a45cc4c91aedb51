"""The port's dynamic grouping (``repro_torch.core.grouping``, MHA -> Opt-GQA
by activation similarity) against the JAX package's on the CPU: the case
of ``examples/convert_mha_to_gqa.py`` and those of
``tests/test_grouping.py``, on the same numpy inputs.  Same groups and
query permutation, similarities and merged K/V weights within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import grouping as jgr
from repro.models import transformer as JT
from repro_torch.core import grouping as gr


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

TOL = 1e-6


def _clustered_acts(H=8, N=64, D=16, groups=2, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(groups, D))
    return np.stack([protos[h % groups] + noise * rng.normal(size=(N, D))
                     for h in range(H)]).astype(np.float32)


def _example_case():
    """examples/convert_mha_to_gqa.py: layer 0 of an MHA reduced
    qwen1.5-0.5b (8 heads), key activations of [4, 64] tokens, 4 groups."""
    key = jax.random.PRNGKey(0)
    cfg = j_get_reduced("qwen1.5-0.5b", num_layers=2, num_kv_heads=4,
                        num_heads=8)
    mha = cfg.replace(num_kv_heads=cfg.num_heads)
    params = JT.init_params(mha, key)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"])
    toks = jax.random.randint(key, (4, 64), 0, cfg.vocab_size)
    x = np.asarray(params["embed"][toks], np.float32)
    H, Dh = mha.num_heads, mha.resolved_head_dim
    acts = np.einsum("bsd,dhk->hbsk", x, lp["attn"]["wk"]).reshape(H, -1, Dh)
    a = lp["attn"]
    return a["wq"], a["wk"], a["wv"], acts, cfg.num_kv_heads


def _grouping_cases():
    rng = np.random.default_rng(1)
    wq, wk, wv = (rng.normal(size=(32, 8, 16)).astype(np.float32)
                  for _ in range(3))
    wk1 = rng.normal(size=(16, 1, 8)).astype(np.float32)
    same = np.concatenate([wk1] * 4, axis=1)
    tile = np.tile(rng.normal(size=(1, 32, 8)).astype(np.float32), (4, 1, 1))
    w12 = [rng.normal(size=(32, 12, 16)).astype(np.float32)
           for _ in range(3)]
    return {"example_convert_mha_to_gqa": _example_case,
            "clustered_8_heads_2_groups": lambda: (
                wq, wk, wv, _clustered_acts(), 2),
            "clustered_12_heads_4_groups": lambda: (
                *w12, _clustered_acts(H=12, groups=3), 4),
            "identical_heads": lambda: (same, same, same, tile, 1)}


CASES = _grouping_cases()


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_convert_mha_to_gqa_matches_jax(case, weighted):
    wq, wk, wv, acts, kv = CASES[case]()
    want = jgr.convert_mha_to_gqa(jnp.asarray(wq), jnp.asarray(wk),
                                  jnp.asarray(wv), jnp.asarray(acts), kv,
                                  weighted=weighted)
    got = gr.convert_mha_to_gqa(*(torch.from_numpy(np.array(a))
                                  for a in (wq, wk, wv, acts)), kv,
                                weighted=weighted)
    assert got.groups == want.groups
    np.testing.assert_array_equal(got.q_perm, want.q_perm)
    for name in ("wk", "wv"):
        t, j = getattr(got, name), np.asarray(getattr(want, name))
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, atol=TOL, rtol=0,
                                   err_msg=name)
    assert abs(got.intra_sim - want.intra_sim) <= TOL
    assert abs(got.inter_sim - want.inter_sim) <= TOL


def test_similarity_and_clustering_match_jax():
    acts = _clustered_acts(H=12, groups=3)
    sim = gr.head_similarity(torch.from_numpy(acts))
    want = jgr.head_similarity(jnp.asarray(acts))
    np.testing.assert_allclose(sim, want, atol=TOL, rtol=0)
    for n in (1, 2, 3, 4, 6, 12):
        groups = gr.cluster_heads(sim, n)
        assert groups == jgr.cluster_heads(want, n)
        assert sorted(len(g) for g in groups) == [12 // n] * n
        np.testing.assert_allclose(gr.grouping_quality(sim, groups),
                                   jgr.grouping_quality(want, groups),
                                   atol=TOL)
    with pytest.raises(ValueError, match="do not split"):
        gr.cluster_heads(sim, 5)
