"""The port's full-sequence forward and model-level GPTQ against the JAX
package on the CPU, on the same bridged params and calibration tokens:
``T.forward`` logits (dense, RTN and the JAX package's GPTQ artifact)
within 1e-4, the calibration Hessians within 1e-5 of the largest entry,
``gptq_quantize_model``'s codes equal in at least 99.9% of entries with
scales, zeros and ``g_idx`` bitwise equal, and ``LLM.load(quant=
"gptq-int4")`` draining greedy token-exact against the JAX ``LLM``
(``enable_async_step=False``), chunked and whole-prompt.

Model: reduced qwen2-1.5b with 12 query heads over 2 KV heads (G = 6),
f32 activations, non-zero qkv biases set through numpy (the LLM drains
keep ``init_params``' zero biases: both loads build their own params).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.gptq import HessianAccumulator as JHessian
from repro.models import transformer as JT
from repro.models.attention import attn_apply as j_attn_apply
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.layers import mlp_apply as j_mlp_apply
from repro.models.quantize import gptq_quantize_model as j_gptq_model
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core.quant import unpack_int4
from repro_torch.models import transformer as T
from repro_torch.models.quantize import (calibration_hessians,
                                         gptq_quantize_model)
from repro_torch.serving import LLM, SamplingParams


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
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24)
LOGIT_TOL = 1e-4
HESSIAN_REL = 1e-5
CODES_EQUAL = 0.999
GS = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _calib(vocab, n=2, b=2, s=24, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


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
    calib = _calib(cfg.vocab_size)
    jg = j_gptq_model(jcfg, jp, calib, JQuantConfig(bits=4, group_size=GS))
    return jcfg, cfg, jp, calib, jg


@pytest.mark.parametrize("quant", ["dense", "rtn-int4", "jax-gptq-int4"])
def test_forward_matches_jax(models, quant):
    """``T.forward`` on bridged params (the JAX package's RTN or GPTQ
    artifact for the quantized cases) against ``JT.forward``."""
    jcfg, cfg, jp, _, jg = models
    jparams = {"dense": jp, "rtn-int4": j_rtn(jp, jcfg, group_size=GS),
               "jax-gptq-int4": jg}[quant]
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(JT.forward(jcfg, jparams, {"tokens": tokens}))
    got = T.forward(cfg, params_from_numpy(_np(jparams), device="cpu"),
                    {"tokens": tokens})
    assert got.shape == (2, 20, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)


def _jax_hessians(jcfg, jp, calib):
    """The JAX package's calibration replay (``gptq_quantize_model``'s
    first half), kept per layer."""
    hess = [(JHessian(jcfg.d_model), JHessian(jcfg.d_model))
            for _ in range(jcfg.num_layers)]
    for batch in calib:
        x = JT._embed_inputs(jcfg, jp, batch, None, {})
        for i, (ha, hm) in enumerate(hess):
            lp = jax.tree.map(lambda a: a[i], jp["layers"])
            hn = j_apply_norm(lp["attn_norm"], x, jcfg.norm, jcfg.norm_eps)
            ha.update(np.asarray(hn.reshape(-1, jcfg.d_model), np.float32))
            x = x + j_attn_apply(jcfg, lp["attn"], hn, None,
                                 kind=jcfg.layer_kind(i), rt={})
            hn = j_apply_norm(lp["mlp_norm"], x, jcfg.norm, jcfg.norm_eps)
            hm.update(np.asarray(hn.reshape(-1, jcfg.d_model), np.float32))
            x = x + j_mlp_apply(lp["mlp"], hn, jcfg.act, {})
    return hess


def test_calibration_hessians_match_jax(models):
    jcfg, cfg, jp, calib, _ = models
    want = _jax_hessians(jcfg, jp, calib)
    got = calibration_hessians(cfg, params_from_numpy(_np(jp), device="cpu"),
                               calib)
    for i, (w_pair, g_pair) in enumerate(zip(want, got)):
        for name, w, h in zip(("attn", "mlp"), w_pair, g_pair):
            assert h.n == w.n
            err = np.abs(h.h.numpy() - w.h).max() / np.abs(w.h).max()
            assert err <= HESSIAN_REL, (i, name, err)


def test_gptq_quantize_model_matches_jax(models):
    jcfg, cfg, jp, calib, jg = models
    got = gptq_quantize_model(cfg, params_from_numpy(_np(jp), device="cpu"),
                              calib, QuantConfig(bits=4, group_size=GS))
    want = _np(jg)
    wl, gl = want["layers"], got["layers"]
    n_leaves = 0
    for block in ("attn", "mlp"):
        for name, w in wl[block].items():
            t = gl[block][name]
            if not isinstance(w, dict):
                np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
                continue
            n_leaves += 1
            K = w["g_idx"].shape[-1]
            for key in ("scales", "zeros", "g_idx"):
                np.testing.assert_array_equal(t[key].numpy(), w[key],
                                              err_msg=f"{name}/{key}")
            codes = [unpack_int4(t["qweight"][i], K).numpy()
                     for i in range(cfg.num_layers)]
            ref = [unpack_int4(params_from_numpy(w["qweight"][i],
                                                 device="cpu"), K).numpy()
                   for i in range(cfg.num_layers)]
            same = np.mean(np.stack(codes) == np.stack(ref))
            assert same >= CODES_EQUAL, (name, same)
    assert n_leaves == 7


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "whole-prompt"])
def test_llm_load_gptq_greedy_drain_token_exact_vs_jax(models, monkeypatch,
                                                       chunked):
    """Both facades load reduced qwen2-1.5b with the same weights (the
    port's ``init_params`` hands back the JAX package's, bridged), run GPTQ
    on the same calibration tokens, and serve the same greedy requests."""
    jcfg, cfg, _, calib, _ = models
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(_np(jparams), device="cpu")
    monkeypatch.setattr(T, "init_params", lambda c, seed, dev, **kw: bridged)
    kw = dict(enable_chunked_prefill=chunked, prefill_bucket=16, **ENGINE_KW)
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, 250, n)) for n in (30, 45, 12, 70)]
    max_tokens = (10, 6, 12, 4)
    jllm = JLLM.load("qwen2-1.5b", quant="gptq-int4", reduced=True,
                     overrides=CFG_KW, seed=0, calib_batches=calib,
                     enable_async_step=False, **kw)
    want = jllm.generate(prompts, [JSP(max_tokens=m) for m in max_tokens])
    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", reduced=True,
                   overrides=CFG_KW, seed=0, calib_batches=calib,
                   enable_async_step=False, device="cpu", **kw)
    got = llm.generate(prompts, [SamplingParams(max_tokens=m)
                                 for m in max_tokens])
    assert set(llm.load_s) == {"init", "calibration", "obq", "pack"}
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    assert llm.engine.alloc.audit()["live_blocks"] == 0
