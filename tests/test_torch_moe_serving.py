"""The port's MoE decoder served end to end against the JAX package on
the CPU, on the same bridged params: ``T.forward`` logits, prefill plus
paged decode against the full forward (the port's counterpart of
``test_serving_consistency``), greedy engine drains token-exact against
the JAX engine (chunked on the synchronous engine, the async default,
whole-prompt waves, and the int8 pool against JAX's int8 pool), a seeded
sampling mix on the async engines, and the refusal of both int4 modes.

Model: reduced qwen2-moe-a2.7b (2 layers, 4 query heads over 4 KV heads,
4 experts top-2 plus a shared one), f32 activations: MoE routing turns
bf16 rounding into other experts (``tests/test_arch_smoke.py``), so the
two packages are compared where their logits agree to rounding.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.models import transformer as T
from repro_torch.serving import LLM, SamplingParams

ARCH = "qwen2-moe-a2.7b"
CFG_KW = dict(dtype="float32")
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24, prefill_bucket=16)
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def moe():
    jcfg = j_get_reduced(ARCH, **CFG_KW)
    cfg = get_reduced(ARCH, **CFG_KW)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, cfg, params, bridged


def _prompts():
    rng = np.random.default_rng(17)
    ps = [list(rng.integers(1, 250, n)) for n in (30, 45, 12, 70, 20)]
    ps[1][:32] = ps[0][:32]                 # two full shared blocks
    return ps


def test_forward_logits_match_jax(moe):
    jcfg, cfg, params, bridged = moe
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    want = np.asarray(JT.forward(jcfg, params, {"tokens": toks}))
    with torch.no_grad():
        got = T.forward(cfg, bridged, {"tokens": toks}).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("S_prompt", [19, 16], ids=["mid-block",
                                                   "block-boundary"])
def test_prefill_then_paged_decode_matches_forward(moe, S_prompt):
    """Whole-prompt prefill, then decode steps over the paged pool to 28
    tokens, against the teacher-forced full forward (f32)."""
    _, cfg, _, params = moe
    B, S_total = 2, 28
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S_total)).astype(np.int32))
    with torch.no_grad():
        full = T.forward(cfg, params, {"tokens": toks})
        p = T.split_layers(T.cast_params(params, T.act_dtype(cfg)))
        st = T.make_decode_state(cfg, B, 16, 8, device="cpu")
        st["block_table"] = torch.arange(16, dtype=torch.int32) \
            .reshape(B, 8)
        lens = torch.full((B,), S_prompt, dtype=torch.int32)
        logits, st = T.prefill(cfg, p, st, {"tokens": toks[:, :S_prompt],
                                            "ctx_lens": lens})
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, S_prompt - 1].numpy(),
                                   atol=LOGIT_TOL, rtol=0)
        for t in range(S_prompt, S_total):
            st["seq_lens"] = torch.full((B,), t + 1, dtype=torch.int32)
            logits, st = T.decode_step(cfg, p, st, toks[:, t])
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       atol=LOGIT_TOL, rtol=0)


def _drain_both(moe, prompts, sps_j, sps_t, **kw):
    jcfg, cfg, params, bridged = moe
    jllm = JLLM(jcfg, params, **kw)
    want = jllm.generate(prompts, sps_j)
    llm = LLM(cfg, bridged, device="cpu", **kw)
    got = llm.generate(prompts, sps_t)
    return llm, jllm, got, want


MODES = {"chunked-sync": dict(enable_async_step=False),
         "async": {},
         "whole-prompt": dict(enable_async_step=False,
                              enable_chunked_prefill=False),
         "int8-chunked-sync": dict(enable_async_step=False,
                                   kv_cache_dtype="int8"),
         "int8-whole-prompt": dict(enable_async_step=False,
                                   enable_chunked_prefill=False,
                                   kv_cache_dtype="int8")}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_drain_token_exact_vs_jax(moe, mode):
    prompts = _prompts()
    mts = (10, 6, 12, 4, 8)
    llm, jllm, got, want = _drain_both(
        moe, prompts, [JSP(max_tokens=m) for m in mts],
        [SamplingParams(max_tokens=m) for m in mts], **ENGINE_KW,
        **MODES[mode])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    eng = llm.engine
    assert eng.chunked == ("whole" not in mode)
    if eng.chunked:
        assert eng.metrics["prefill_chunks"] > len(prompts)  # multi-chunk
    assert eng.alloc.stats == jllm.engine.alloc.stats
    assert eng.alloc.stats["reused"] > 0                     # prefix reuse
    assert eng.alloc.audit()["live_blocks"] == 0
    for k in ("device_dispatches", "decode_steps", "async_steps"):
        assert eng.metrics[k] == jllm.engine.metrics[k], k
    if mode == "async":
        assert eng.metrics["async_steps"] > 0


def test_seeded_sampling_mix_async_vs_jax(moe):
    """Greedy, temperature, top-k and top-p rows with per-request seeds
    on both packages' async engines: the same tokens."""
    prompts = _prompts()

    def sps(SP):
        return [SP(max_tokens=8), SP(max_tokens=8, temperature=0.8, seed=1),
                SP(max_tokens=8, temperature=0.9, top_k=5, seed=2),
                SP(max_tokens=8, temperature=0.7, top_p=0.9, seed=3),
                SP(max_tokens=8, temperature=1.0, top_k=20, top_p=0.8,
                   seed=4)]
    _, _, got, want = _drain_both(moe, prompts, sps(JSP),
                                  sps(SamplingParams), **ENGINE_KW)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]


def test_int4_modes_refused_for_moe():
    """The reference refuses gptq-int4 for MoE and cannot serve its
    rtn-int4 (ROADMAP C8): the port refuses both, before loading."""
    with pytest.raises(ValueError, match="C8"):
        LLM.load(ARCH, quant="rtn-int4", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="dense-family"):
        LLM.load(ARCH, quant="gptq-int4", reduced=True, device="cpu")
    from repro_torch.models.quantize import quantize_params_rtn
    cfg = get_reduced(ARCH)
    with pytest.raises(ValueError, match="C8"):
        quantize_params_rtn(T.init_params(cfg, 0, "cpu"), cfg)
    llm = LLM.load(ARCH, reduced=True, device="cpu")
    assert llm.engine.chunked and llm.engine.async_step
    [out] = llm.generate([list(range(1, 30))], SamplingParams(max_tokens=4))
    assert len(out.token_ids) == 4
    assert llm.params["layers"][0]["moe"]["we_gate"].dtype == torch.bfloat16
