"""The port's vision-prefixed decoder (llava-next-mistral-7b: a dense GQA
decoder behind ``num_prefix_embeds`` precomputed patch embeddings, the
reference's ``vision_patches`` frontend) against the JAX package on the
CPU, on the same bridged params and the same numpy inputs.

``T.forward`` with and without ``vision_embeds`` at 5e-5 (f32);
``T.prefill`` with the prefix (which counts as context: ``seq_lens`` is
prefix + ctx_lens, positions run over prefix and text) plus three
``T.decode_step``s against the reference's same calls, the
reference's ``test_serving_consistency`` held to JAX and not only to
itself; greedy drains of text prompts through ``LLM.load`` token-exact
against the JAX engine's (the reference's engine passes no vision
embeddings, so neither does the port's), also on a ``gptq-int4`` load;
``gptq_quantize_model``'s codes bitwise the reference's on explicit
calibration batches, one of them with a vision prefix.

Model: reduced llava-next-mistral-7b (2 layers, d_model 64, 4 / 4 heads
of dim 16, 8 prefix embeddings), f32 activations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.models.quantize import gptq_quantize_model as j_gptq_model
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import transformer as T
from repro_torch.models.quantize import gptq_quantize_model
from repro_torch.serving import LLM, SamplingParams

ARCH = "llava-next-mistral-7b"
OVR = {"dtype": "float32"}
LOGIT_TOL = 5e-5
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24, prefill_bucket=16)
GS = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this file's small ops: with one a
    core in each of several test processes, every small op waits for
    threads the others hold (ROADMAP C13)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llava():
    jcfg, cfg = j_get_reduced(ARCH, **OVR), get_reduced(ARCH, **OVR)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(_np(params), device="cpu")


def _vision(cfg, B, seed):
    """Patch embeddings at the reference data pipeline's scale (x 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model))
            * 0.1).astype(np.float32)


def _close(t, j, tol, err=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0, err_msg=err)


def test_registry_serves_llava():
    """The full config as the reference has it: a dense GQA decoder (32
    layers, 32 / 8 heads of dim 128, SwiGLU 14336, untied 32,000 head)
    behind 2,880 patch embeddings, 7.24 B parameters by count of the
    leaves; chunked prefill as any full-attention decoder."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings, cfg.frontend,
            cfg.num_prefix_embeds, cfg.is_encoder) == \
        ("vlm", 32, 4096, 32, 8, 128, 14336, 32000, False,
         "vision_patches", 2880, False)
    assert T.supports_chunked_prefill(cfg)
    meta = T.init_params(cfg, device="meta")
    assert set(meta) == {"embed", "final_norm", "head", "layers"}
    n = sum(t.numel() for t in T._leaves(meta))
    assert 7.2e9 < n < 7.3e9
    assert get_reduced(ARCH).num_prefix_embeds == 8


@pytest.mark.parametrize("prefix", [True, False], ids=["vision", "text"])
def test_forward_matches_jax(llava, prefix):
    """The logits over [prefix + text] (or the text alone) at 5e-5."""
    jcfg, cfg, params, bridged = llava
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 19))
             .astype(np.int32)}
    if prefix:
        batch["vision_embeds"] = _vision(cfg, 2, 2)
    want = JT.forward(jcfg, params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = T.forward(cfg, bridged, batch)
    assert got.shape == (2, 19 + 8 * prefix, cfg.vocab_size)
    _close(got, want, LOGIT_TOL)


def test_prefill_and_decode_with_vision_prefix_match_jax(llava):
    """``prefill`` with 8 prefix embeddings over right-padded ragged text,
    then three teacher-forced ``decode_step``s over the paged pool: every
    step's logits at 5e-5 of the reference's same calls, ``seq_lens``
    after the prefill prefix + ctx_lens, and the served logits equal to
    the port's own ``forward`` at the same positions (the reference's
    ``test_serving_consistency``).  Other vision embeddings move the
    prefill's logits far past the limit: the prefix is attended."""
    jcfg, cfg, params, bridged = llava
    B, S_total, S_prompt, P = 2, 28, 19, cfg.num_prefix_embeds
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S_total)).astype(np.int32)
    ve = _vision(cfg, B, 4)
    ctx_lens = np.array([S_prompt, S_prompt - 6], np.int32)
    MB = 4
    table = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    batch = {"tokens": toks[:, :S_prompt], "ctx_lens": ctx_lens,
             "vision_embeds": ve}
    jst = JT.make_decode_state(jcfg, B, B * MB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(table)
    jlg, jst = JT.prefill(jcfg, params, jst, jax.tree.map(jnp.asarray,
                                                          batch))
    st = T.make_decode_state(cfg, B, B * MB, MB, device="cpu")
    st["block_table"] = torch.from_numpy(table)
    p = T.split_layers(bridged)
    with torch.no_grad():
        full = T.forward(cfg, bridged, {"tokens": toks, "vision_embeds": ve})
        lg, st = T.prefill(cfg, p, st, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        _close(lg, jlg, LOGIT_TOL, "prefill")
        np.testing.assert_array_equal(st["seq_lens"].numpy(), P + ctx_lens)
        np.testing.assert_array_equal(np.asarray(jst["seq_lens"]),
                                      P + ctx_lens)
        for b in range(B):
            _close(lg[b], full[b, P + ctx_lens[b] - 1], LOGIT_TOL)
        other, _ = T.prefill(cfg, p, T.make_decode_state(
            cfg, B, B * MB, MB, device="cpu") | {
                "block_table": torch.from_numpy(table)},
            {**{k: torch.from_numpy(v) for k, v in batch.items()},
             "vision_embeds": torch.from_numpy(_vision(cfg, B, 5))})
        assert (other - lg).abs().max().item() > 100 * LOGIT_TOL
        for step in range(3):
            pos = ctx_lens + step
            tok = toks[np.arange(B), pos]
            jst = dict(jst, seq_lens=jnp.asarray(P + pos + 1))
            jlg, jst = JT.decode_step(jcfg, params, jst, jnp.asarray(tok))
            st["seq_lens"] = torch.from_numpy(P + pos + 1)
            lg, st = T.decode_step(cfg, p, st, torch.from_numpy(tok))
            _close(lg, jlg, LOGIT_TOL, f"step {step}")
            for b in range(B):
                _close(lg[b], full[b, P + pos[b]], LOGIT_TOL)
    _close(st["k_pool"], jst["k_pool"], LOGIT_TOL, "k_pool")
    _close(st["v_pool"], jst["v_pool"], LOGIT_TOL, "v_pool")


@pytest.fixture(scope="module")
def jax_drains(llava):
    """The JAX engine's greedy tokens (synchronous), chunked and
    whole-prompt, from ``JLLM.load`` on the reduced config."""
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, 250, n)) for n in (30, 45, 12, 70)]
    mts = (10, 6, 12, 4)
    out = {}
    for chunked in (True, False):
        jllm = JLLM.load(ARCH, reduced=True, overrides=OVR, seed=0,
                         enable_async_step=False,
                         enable_chunked_prefill=chunked, **ENGINE_KW)
        out[chunked] = [o.token_ids for o in jllm.generate(
            prompts, [JSP(max_tokens=m) for m in mts])]
    return prompts, mts, out


@pytest.mark.parametrize("mode", ["defaults", "sync", "whole-prompt"])
def test_llm_load_greedy_drain_matches_jax_engine(llava, jax_drains,
                                                  monkeypatch, mode):
    """``LLM.load(ARCH, reduced=True)`` (its ``init_params`` handing back
    the JAX package's params, bridged) drains four text prompts over
    three slots greedy, token-exact against the JAX engine in the same
    prefill mode; the defaults (chunked, async, graphs) against its
    synchronous chunked engine."""
    _, _, _, bridged = llava
    prompts, mts, want = jax_drains
    monkeypatch.setattr(T, "init_params", lambda c, seed, dev, **kw: bridged)
    kw = {"defaults": {}, "sync": dict(enable_async_step=False),
          "whole-prompt": dict(enable_async_step=False,
                               enable_chunked_prefill=False)}[mode]
    llm = LLM.load(ARCH, reduced=True, overrides=OVR, seed=0, device="cpu",
                   **ENGINE_KW, **kw)
    assert llm.engine.chunked == (mode != "whole-prompt")
    assert llm.engine.async_step == (mode == "defaults")
    got = llm.generate(prompts, [SamplingParams(max_tokens=m) for m in mts])
    assert [o.token_ids for o in got] == want[mode != "whole-prompt"]
    assert llm.engine.alloc.audit()["live_blocks"] == 0
    llm.close()


def test_gptq_codes_match_jax(llava):
    """GPTQ over explicit calibration batches (text, and text behind a
    vision prefix): every code, scale, zero and ``g_idx`` bitwise the
    reference's."""
    jcfg, cfg, params, bridged = llava
    rng = np.random.default_rng(6)
    calib = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 24))
              .astype(np.int32)},
             {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))
              .astype(np.int32), "vision_embeds": _vision(cfg, 2, 7)}]
    want = _np(j_gptq_model(jcfg, params, [jax.tree.map(jnp.asarray, b)
                                           for b in calib],
                            JQuantConfig(bits=4, group_size=GS)))
    got = gptq_quantize_model(cfg, bridged, calib,
                              QuantConfig(bits=4, group_size=GS))
    n = 0
    for block in ("attn", "mlp"):
        for name, w in want["layers"][block].items():
            if not isinstance(w, dict):
                continue
            for key in ("qweight", "scales", "zeros", "g_idx"):
                np.testing.assert_array_equal(
                    got["layers"][block][name][key].numpy(), w[key],
                    err_msg=f"{name}/{key}")
            n += 1
    assert n == 7


def test_llm_load_gptq_int4_drains_token_exact_vs_jax(llava, monkeypatch):
    """``LLM.load(quant="gptq-int4")`` takes the vlm family, as the
    reference's: both facades load the same weights (the port's
    ``init_params`` hands back the JAX package's, bridged), run GPTQ on
    the same calibration tokens, and serve the same greedy text
    requests."""
    _, _, _, bridged = llava
    monkeypatch.setattr(T, "init_params", lambda c, seed, dev, **kw: bridged)
    rng = np.random.default_rng(9)
    calib = [{"tokens": rng.integers(0, 256, (2, 24)).astype(np.int32)}
             for _ in range(2)]
    prompts = [list(rng.integers(1, 250, n)) for n in (30, 12, 45)]
    mts = (8, 5, 10)
    kw = dict(quant="gptq-int4", reduced=True, overrides=OVR, seed=0,
              calib_batches=calib, enable_async_step=False, **ENGINE_KW)
    want = JLLM.load(ARCH, **kw).generate(prompts,
                                          [JSP(max_tokens=m) for m in mts])
    llm = LLM.load(ARCH, device="cpu", **kw)
    got = llm.generate(prompts, [SamplingParams(max_tokens=m) for m in mts])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert set(llm.load_s) == {"init", "calibration", "obq", "pack"}
    llm.close()
