"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU, on the same bridged params and numpy inputs: the
routed path against the reference's ``moe_apply`` (``ragged_dot``) and
both packages' dense O(E) oracles at 1e-5 (f32: MoE routing turns bf16
rounding into other experts), top-1 routing, the shared experts'
contribution, expert padding, the ``[B, 1, d]`` decode shape, bitwise
repeats, no host read on the path, and the init's shapes and dtypes.

Model: reduced qwen2-moe-a2.7b (4 experts, top-2, 1 shared expert,
d 64, expert hidden 32), f32 activations.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ARCH = "qwen2-moe-a2.7b"
TOL = 1e-5


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return j_get_reduced(ARCH, **kw), get_reduced(ARCH, **kw)


def _params(jcfg, seed=0, ep=1):
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg, ep=ep)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(cfg, tp, x):
    return M.moe_apply(cfg, tp, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 64), (8, 1, 64), (1, 33, 64)],
                         ids=["prefill", "decode", "ragged"])
def test_moe_apply_matches_reference_and_oracles(shape):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x(shape)
    got = _port(cfg, tp, x)
    np.testing.assert_allclose(got, np.asarray(JM.moe_apply(jcfg, jp, x,
                                                            None)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(JM.moe_apply_dense_ref(
        jcfg, jp, x)), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, M.moe_apply_dense_ref(cfg, tp, torch.from_numpy(x)).numpy(),
        atol=TOL, rtol=0)


def test_routing_matches_reference():
    """The same top-k ids and renormalized weights as the reference's."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    x2 = _x((40, 64), seed=1)
    ids, w = M._route(cfg, tp, torch.from_numpy(x2))
    logits = x2 @ np.asarray(jp["router"])
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    jw, jids = jax.lax.top_k(probs, cfg.moe_top_k)
    jw = np.asarray(jw) / np.asarray(jw).sum(-1, keepdims=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-6, rtol=0)


def test_top1_routing_selects_argmax_expert():
    jcfg, cfg = _cfgs(moe_top_k=1, num_shared_experts=0)
    jp, tp = _params(jcfg)
    assert "ws_gate" not in tp
    x = _x((1, 6, 64))
    got = _port(cfg, tp, x)
    np.testing.assert_allclose(got, np.asarray(JM.moe_apply_dense_ref(
        jcfg, jp, x)), atol=TOL, rtol=0)
    # top-1 renormalizes to weight 1: each token is its argmax expert's
    # SwiGLU output alone
    x2 = torch.from_numpy(x[0])
    e = (x2 @ tp["router"]).argmax(-1)
    for t in range(6):
        w = {k: tp[k][e[t]] for k in ("we_gate", "we_up", "we_down")}
        o = (torch.nn.functional.silu(x2[t] @ w["we_gate"])
             * (x2[t] @ w["we_up"])) @ w["we_down"]
        np.testing.assert_allclose(got[0, t], o.numpy(), atol=TOL, rtol=0)


def test_shared_expert_contributes():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((1, 4, 64))
    y1 = _port(cfg, tp, x)
    tp2 = dict(tp, ws_down=torch.zeros_like(tp["ws_down"]))
    y2 = _port(cfg, tp2, x)
    assert np.abs(y1 - y2).max() > 1e-4
    # the difference is exactly the shared MLP
    shared = M._shared_local(cfg, tp, torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(y1[0] - y2[0], shared, atol=TOL, rtol=0)
    jp2 = dict(jp, ws_down=np.zeros_like(np.asarray(jp["ws_down"])))
    np.testing.assert_allclose(y2, np.asarray(JM.moe_apply(jcfg, jp2, x,
                                                           None)),
                               atol=TOL, rtol=0)


def test_expert_padding():
    jcfg, cfg = _cfgs(num_experts=6)
    assert M.padded_experts(cfg, 4) == JM.padded_experts(jcfg, 4) == 8
    assert M.padded_experts(cfg) == 6
    p = M.moe_init(torch.Generator().manual_seed(0), cfg, ep=4)
    assert p["we_gate"].shape[0] == 8 and p["router"].shape[1] == 6
    jp, tp = _params(jcfg, ep=4)
    assert tp["we_gate"].shape[0] == 8
    x = _x((1, 4, 64))
    got = _port(cfg, tp, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(JM.moe_apply(jcfg, jp, x,
                                                            None)),
                               atol=TOL, rtol=0)


def test_decode_rows_equal_prefill_rows_and_repeat_bitwise():
    """The ``[B, 1, d]`` decode route gives each token what the
    ``[1, B, d]`` prefill route gives it (routing is per token), and a
    second call gives the same bits (no scatter-add)."""
    _, cfg = _cfgs()
    _, tp = _params(j_get_reduced(ARCH, dtype="float32"), seed=2)
    x = torch.from_numpy(_x((1, 16, 64), seed=2))
    pre = M.moe_apply(cfg, tp, x)
    dec = M.moe_apply(cfg, tp, x.reshape(16, 1, 64))
    assert dec.shape == (16, 1, 64)
    np.testing.assert_allclose(dec[:, 0].numpy(), pre[0].numpy(), atol=1e-6,
                               rtol=0)
    assert torch.equal(M.moe_apply(cfg, tp, x), pre)


def test_path_reads_nothing_back_on_meta():
    """The routed path at full width on the ``meta`` device, where any
    read of a value (``.item()``, ``nonzero``, a data-dependent shape)
    raises: the path the async engine runs has no host read."""
    cfg = get_config(ARCH)
    p = T.cast_params(T.init_params(cfg, device="meta"), torch.bfloat16)
    lp = T._index(p["layers"], 0)["moe"]
    for shape in ((8, 1, cfg.d_model), (1, 256, cfg.d_model)):
        x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
        y = M.moe_apply(cfg, lp, x)
        assert y.shape == shape and y.dtype == torch.bfloat16


def test_init_shapes_match_reference_at_full_width():
    """The full-width tree (made on ``meta``) has the reference's leaves
    and shapes; it holds ``num_params`` plus the final norm."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    want = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = T.init_params(cfg, device="meta")
    flat_w = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w
    n = sum(t.numel() for t in T._leaves(got))
    assert n == cfg.num_params() + cfg.d_model == 14_315_735_040


def test_init_params_cast_as_drawn():
    """``init_params(dtype=bf16)`` equals ``cast_params`` of the f32 init
    bit for bit, the norms kept f32."""
    cfg = get_reduced(ARCH)
    f32 = T.init_params(cfg, 5, "cpu")
    b16 = T.init_params(cfg, 5, "cpu", dtype=torch.bfloat16)
    want = T.cast_params(f32, torch.bfloat16)
    for a, b in zip(T._leaves(b16), T._leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert b16["layers"]["attn_norm"]["w"].dtype == torch.float32
    assert b16["layers"]["moe"]["we_gate"].dtype == torch.bfloat16
    assert f32["layers"]["moe"]["we_gate"].shape == (2, 4, 64, 32)
