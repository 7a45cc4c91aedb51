"""The port's attention-free Mamba-1 stack (falcon-mamba-7b: 64 layers of
RMSNorm then the selective-scan mixer, per-slot ``ssm_h`` / ``ssm_conv``
state, no paged pool) against the JAX package on the CPU, on the same
bridged params.

Modules at 5e-5 (f32): the selective scan inside ``_ssm_inner`` (the
port's plain ``selective_scan_ref`` on the CPU) with and without a mask,
``ssm_apply``, ``ssm_prefill`` on right-padded ragged rows (y, final
state, conv state) and a chain of 12 ``ssm_decode`` steps.  The model at
1e-4 for logits and 1e-5 for the state: ``forward``, ``prefill`` plus
decode steps, a megastep, dense and rtn-int4 (RTN's codes of in_proj /
out_proj bitwise the reference's, drawn whole or a layer at a time).
Greedy engine drains token-exact with the JAX engine in the defaults,
synchronous and whole-prompt modes (chunked prefill falls back to waves,
as in the reference); graphs on equal graphs off, and a planted missing
copy-back of ``ssm_h`` or ``ssm_conv`` changes the tokens.  The
reference's refusals (int8 KV, gptq-int4) with its messages.

Model: reduced falcon-mamba-7b (the reference's reduced default: 2
layers, d_model 64, din 128, state 4, conv 4, dt rank 16), f32
activations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.quantize import quantize_params_rtn
from repro_torch.serving import LLM, SamplingParams
from repro_torch.serving import step_graph


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

ARCH = "falcon-mamba-7b"
MOD_TOL = 5e-5
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mamba():
    kw = dict(dtype="float32")
    jcfg, cfg = j_get_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(_np(params), device="cpu")


@pytest.fixture(scope="module")
def quantized(mamba):
    jcfg, _, params, bridged = mamba
    jq = j_rtn(params, jcfg, group_size=32)
    return {"dense": (params, bridged),
            "rtn-int4": (jq, params_from_numpy(_np(jq), device="cpu"))}


def _close(t, j, tol, err=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0, err_msg=err)


def _layer0(mamba):
    jcfg, cfg, params, bridged = mamba
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], params["layers"])["ssm"],
            T.split_layers(bridged)["layers"][0]["ssm"])


def test_registry_serves_falcon_mamba():
    """The full config as the reference has it, its layer plan (64 Mamba
    layers, no attention, no chunked prefill) and its size by count of
    the leaves: about 7.0 B, the tied embedding 266 M of it."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.ssm_state,
            cfg.ssm_conv, cfg.ssm_expand, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings) == ("ssm", 64, 4096, 16, 4, 2, 0, 65024,
                                    True)
    assert S.dt_rank(cfg) == 256
    assert set(T.layer_plan(cfg)) == {("ssm", "layers", i)
                                      for i in range(64)}
    assert T.attn_layer_count(cfg) == (0, 64)
    assert not T.supports_chunked_prefill(cfg)
    meta = T.init_params(cfg, device="meta")
    assert set(meta) == {"embed", "final_norm", "layers"}
    assert set(meta["layers"]) == {"attn_norm", "ssm"}
    n = sum(t.numel() for t in T._leaves(meta))
    assert 6.95e9 < n < 7.05e9
    assert meta["embed"].numel() == 65024 * 4096
    shapes = {k: tuple(v.shape) for k, v in meta["layers"]["ssm"].items()}
    assert shapes == {"in_proj": (64, 4096, 16384),
                      "conv_w": (64, 8192, 4), "conv_b": (64, 8192),
                      "x_proj": (64, 8192, 288), "dt_proj": (64, 256, 8192),
                      "dt_bias": (64, 8192), "A_log": (64, 8192, 16),
                      "D": (64, 8192), "out_proj": (64, 8192, 4096)}


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_selective_scan_matches_jax_inner(mamba, masked):
    """``_ssm_inner`` (dt, B, C from x_proj / dt_proj, the selective scan
    in ``selective_scan_ref``, the D skip and the SiLU gate) from a
    random state; masked positions leave the state as it is."""
    jcfg, cfg, jp, tp = _layer0(mamba)
    rng = np.random.default_rng(1)
    B, Sq, din, N = 3, 21, 128, cfg.ssm_state
    xc = rng.normal(size=(B, Sq, din)).astype(np.float32)
    z = rng.normal(size=(B, Sq, din)).astype(np.float32)
    h0 = rng.normal(size=(B, din, N)).astype(np.float32)
    mask = np.arange(Sq)[None] < np.array([21, 9, 1])[:, None]
    kw = {"mask": mask} if masked else {}
    jy, jh = JS._ssm_inner(jcfg, jp, jnp.asarray(xc), jnp.asarray(z),
                           jnp.asarray(h0),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    ty, th = S._ssm_inner(cfg, tp, torch.from_numpy(xc),
                          torch.from_numpy(z), torch.from_numpy(h0),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(ty, jy, MOD_TOL, "y")
    _close(th, jh, MOD_TOL, "h")
    if masked:                          # dt = 0: the state passes through
        dt = torch.zeros(1, 3, din)
        _, h_still = S.ops.selective_scan(
            dt, torch.ones(1, 3, din), torch.ones(1, 3, N),
            torch.ones(1, 3, N), -torch.ones(din, N),
            torch.from_numpy(h0[:1]))
        assert torch.equal(h_still, torch.from_numpy(h0[:1]))


def test_ssm_apply_matches_jax(mamba):
    jcfg, cfg, jp, tp = _layer0(mamba)
    x = np.random.default_rng(2).normal(size=(2, 17, 64)).astype(np.float32)
    want = JS.ssm_apply(jcfg, jp, jnp.asarray(x))
    got = S.ssm_apply(cfg, tp, torch.from_numpy(x))
    _close(got, want, MOD_TOL)


def test_ssm_prefill_then_decode_steps_match_jax(mamba):
    """A ragged wave (ctx_lens 13, 2, 6 in a width of 13: the conv state
    of a 2-token row is zero-padded), then 12 decode steps: y, the state
    and the conv state at every step."""
    jcfg, cfg, jp, tp = _layer0(mamba)
    rng = np.random.default_rng(3)
    B, Sq = 3, 13
    lens = np.array([13, 2, 6], np.int32)
    x = rng.normal(size=(B, Sq, 64)).astype(np.float32)
    mask = np.arange(Sq)[None] < lens[:, None]
    jy, jh, jc = JS.ssm_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(mask),
                                jnp.asarray(lens))
    ty, th, tc = S.ssm_prefill(cfg, tp, torch.from_numpy(x),
                               torch.from_numpy(mask),
                               torch.from_numpy(lens))
    for name, g, w in (("y", ty, jy), ("h", th, jh), ("conv", tc, jc)):
        _close(g * torch.from_numpy(mask)[..., None] if name == "y" else g,
               w * mask[..., None] if name == "y" else w, MOD_TOL, name)
    jdecode = jax.jit(lambda x, h, c: JS.ssm_decode(jcfg, jp, x, h, c))
    for t in range(12):
        x = rng.normal(size=(B, 64)).astype(np.float32)
        jy, jh, jc = jdecode(jnp.asarray(x), jh, jc)
        ty, th, tc = S.ssm_decode(cfg, tp, torch.from_numpy(x), th, tc)
        for name, g, w in (("y", ty, jy), ("h", th, jh), ("conv", tc, jc)):
            _close(g, w, MOD_TOL, f"step {t} {name}")


# ------------------------------------------------------------ model

def test_quantize_params_rtn_matches_jax(mamba, quantized):
    """in_proj and out_proj to int4 with the reference's fan-ins, bit for
    bit; x_proj, dt_proj and the f32 leaves dense; and a seeded
    ``LLM.load`` that quantizes each layer as it is drawn gives the codes
    of the whole-tree RTN of the same init."""
    jcfg, cfg, _, bridged = mamba
    got = quantize_params_rtn(bridged, cfg, group_size=32)
    ssm = got["layers"]["ssm"]
    assert {k for k, v in ssm.items() if isinstance(v, dict)} == \
        {"in_proj", "out_proj"}

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert b.numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)

    walk(_np(quantized["rtn-int4"][0]), got)
    llm = LLM.load(ARCH, quant="rtn-int4", reduced=True, device="cpu",
                   capture_graphs=False, max_slots=2, num_blocks=8,
                   max_blocks_per_seq=2, overrides={"dtype": "float32"})
    whole = quantize_params_rtn(T.init_params(llm.cfg, 0, device="cpu"),
                                llm.cfg, group_size=32)
    walk(_np({k: v for k, v in whole.items() if k != "layers"}),
         {k: v for k, v in llm.params.items() if k != "layers"})
    per_layer = llm.params["layers"]
    for i, lp in enumerate(per_layer):
        walk(_np(T._index(whole["layers"], i)), lp, f"layer {i}")
    llm.close()


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
def test_forward_logits_match_jax(mamba, quantized, quant):
    jcfg, cfg, *_ = mamba
    jp, tp = quantized[quant]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 45))
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, LOGIT_TOL)


def _state_close(st, jst):
    assert st.keys() == jst.keys() == {"seq_lens", "ssm_h", "ssm_conv"}
    for name in ("ssm_h", "ssm_conv"):
        assert tuple(st[name].shape) == tuple(jst[name].shape), name
        _close(st[name], jst[name], STATE_TOL, name)


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
def test_prefill_and_decode_steps_match_jax(mamba, quantized, quant):
    """A ragged wave, then 20 decode steps: each step's logits, and
    ``ssm_h`` / ``ssm_conv`` after the wave and at the end; the state
    has no pool and no block table, as the reference's."""
    jcfg, cfg, *_ = mamba
    jp, tp = quantized[quant]
    B, steps = 3, 20
    lens = np.array([31, 4, 17], np.int32)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, 31 + steps)).astype(np.int32)
    jst = JT.make_decode_state(jcfg, B, 8, 2, dtype=jnp.float32)
    st = T.make_decode_state(cfg, B, 8, 2, device="cpu")
    batch = {"tokens": toks[:, :31], "ctx_lens": lens}
    want, jst = JT.prefill(jcfg, jp, jst, jax.tree.map(jnp.asarray, batch))
    jdecode = jax.jit(lambda s, t: JT.decode_step(jcfg, jp, s, t))
    p = T.split_layers(tp)
    with torch.no_grad():
        got, st = T.prefill(cfg, p, st, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        _close(got, want, LOGIT_TOL, "prefill")
        _state_close(st, jst)
        for t in range(steps):
            pos = lens + t
            tok = toks[np.arange(B), pos]
            jst = dict(jst, seq_lens=jnp.asarray(pos + 1))
            want, jst = jdecode(jst, jnp.asarray(tok))
            st["seq_lens"] = torch.from_numpy(pos + 1)
            got, st = T.decode_step(cfg, p, st, torch.from_numpy(tok))
            _close(got, want, LOGIT_TOL, f"step {t}")
    _state_close(st, jst)


def test_decode_megastep_matches_jax(mamba, quantized):
    """A greedy megastep of 16 steps after a prefill, one slot inactive
    (its state row still steps, as in the reference): tokens and state
    equal JAX's."""
    jcfg, cfg, *_ = mamba
    jp, tp = quantized["rtn-int4"]
    B, n = 3, 16
    lens = np.array([20, 0, 9], np.int32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (B, 20)).astype(np.int32)
    active = lens > 0
    sampling = {"keys": np.zeros((B, 2), np.uint32),
                "counts": np.zeros(B, np.int32),
                "temps": np.zeros(B, np.float32),
                "top_ks": np.zeros(B, np.int32),
                "top_ps": np.ones(B, np.float32)}
    batch = {"tokens": toks, "ctx_lens": np.maximum(lens, 1)}
    jst = JT.make_decode_state(jcfg, B, 8, 2, dtype=jnp.float32)
    jlog, jst = JT.prefill(jcfg, jp, jst, jax.tree.map(jnp.asarray, batch))
    first = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jst["seq_lens"] = jnp.asarray(lens + active)
    want, jst = JT.decode_megastep(
        jcfg, jp, jst, jnp.asarray(first),
        jax.tree.map(jnp.asarray, sampling), jnp.asarray(active),
        jnp.int32(n), max_horizon=n)
    st = T.make_decode_state(cfg, B, 8, 2, device="cpu")
    p = T.split_layers(tp)
    with torch.no_grad():
        log, st = T.prefill(cfg, p, st, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        assert (log.argmax(-1).numpy() == first).all()
        st["seq_lens"] = torch.from_numpy(lens + active)
        got, st = T.decode_megastep(cfg, p, st, torch.from_numpy(first),
                                    sampling, torch.from_numpy(active), n,
                                    max_horizon=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _state_close(st, jst)


def test_cast_params_keeps_the_mamba_f32_leaves(mamba):
    """A_log (A = -exp(A_log) in f32), conv_w and conv_b (f32 in decode),
    dt_bias and D (cast at each use, as the reference) stay f32 when the
    rest is cast to bf16."""
    _, _, _, bridged = mamba
    ssm = T.cast_params(bridged, torch.bfloat16)["layers"]["ssm"]
    assert {k for k, v in ssm.items() if v.dtype == torch.float32} == \
        {"A_log", "conv_w", "conv_b", "dt_bias", "D"}
    assert ssm["in_proj"].dtype == ssm["x_proj"].dtype == torch.bfloat16


# ------------------------------------------------------------ engine

ENGINE_KW = dict(max_slots=3, num_blocks=32, max_blocks_per_seq=8,
                 prefill_bucket=16)
DRAIN_MODES = {"defaults": {}, "sync": dict(enable_async_step=False),
               "whole-prompt": dict(enable_chunked_prefill=False)}


def _prompts(seed, vocab, lens=(5, 9, 20, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def jax_drain(mamba):
    """The JAX engine's greedy tokens on its defaults, which serve a Mamba
    stack through whole-prompt waves, synchronously, as its synchronous
    and whole-prompt modes do."""
    jcfg, cfg, params, _ = mamba
    jllm = JLLM(jcfg, params, **ENGINE_KW)
    assert not jllm.engine.chunked and not jllm.engine.async_step
    prompts = _prompts(11, cfg.vocab_size)
    return prompts, [o.token_ids for o in jllm.generate(prompts,
                                                         JSP(max_tokens=12))]


@pytest.mark.parametrize("mode", list(DRAIN_MODES))
def test_greedy_drain_matches_jax_engine(mamba, jax_drain, mode):
    """Four prompts over three slots (one waits for a slot), 12 greedy
    tokens each: the JAX engine's tokens.  The port serves a Mamba stack
    through whole-prompt waves, synchronously, even where chunked prefill
    and the async step are asked for, with no block table on the
    device."""
    _, cfg, _, bridged = mamba
    prompts, want = jax_drain
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW, **DRAIN_MODES[mode])
    eng = llm.engine
    assert not eng.chunked and not eng.async_step
    assert not eng.scheduler.ring_only
    got = llm.generate(prompts, SamplingParams(max_tokens=12))
    assert [o.token_ids for o in got] == want
    assert "block_table" not in eng.runner.state
    assert eng.alloc.audit()["live_blocks"] == 0
    llm.close()


def _serve(cfg, params, prompts, **kw):
    llm = LLM(cfg, params, device="cpu", **ENGINE_KW, **kw)
    outs = llm.generate(prompts, SamplingParams(max_tokens=16))
    stats = llm.engine.runner.graph_stats()
    llm.close()
    return [o.token_ids for o in outs], stats


@pytest.fixture(scope="module")
def mamba_memory():
    """The reduced model on the port's seeded init, set so that its
    tokens depend on the state: dt ~ 1 (dt_bias = softplus^-1(1)), A =
    -0.05 (the state decays by ~0.95 a step, so it carries ~20 steps) and
    out_proj x 4 (the mixer outweighs the residual stream, whose tied
    embedding alone would repeat the input token).  At the init's dt
    (0.001-0.1) and A (-1..-4) a stale ``ssm_h`` changes no greedy
    token."""
    cfg = get_reduced(ARCH, dtype="float32")
    params = T.init_params(cfg, 0, device="cpu")
    ssm = params["layers"]["ssm"]
    ssm["dt_bias"].fill_(0.5413)
    ssm["A_log"].fill_(float(np.log(0.05)))
    ssm["out_proj"].mul_(4.0)
    return cfg, params


@pytest.mark.parametrize("key", ["ssm_h", "ssm_conv"])
def test_graphs_on_equal_off_and_a_planted_copy_back_fault_shows(
        mamba_memory, monkeypatch, key):
    """The megastep's decode step runs as a step graph (on the CPU the
    recorded step replayed on the static buffers) and gives the eager
    engine's tokens; with the copy-back of ``key`` into the static state
    dropped, a replay reads the state the wave left, and the tokens
    change."""
    cfg, params = mamba_memory
    prompts = _prompts(12, cfg.vocab_size, lens=(5, 9, 20))
    eager, _ = _serve(cfg, params, prompts, capture_graphs=False)
    sound, stats = _serve(cfg, params, prompts)
    assert sound == eager
    assert stats["megastep"]["replays"] > 0
    real = step_graph.copy_back
    monkeypatch.setattr(step_graph, "copy_back", lambda state, new: real(
        state, {k: v for k, v in new.items() if k != key}))
    broken, _ = _serve(cfg, params, prompts)
    assert broken != eager


def test_refusals_match_the_reference(mamba):
    """int8 KV (no attention KV at all) and gptq-int4 (not a dense model)
    raise the reference's messages; chunked prefill is refused by name at
    the model."""
    jcfg, cfg, _, bridged = mamba
    with pytest.raises(ValueError) as jerr:
        JT.make_decode_state(jcfg, 2, 8, 2, kv_cache_dtype="int8")
    with pytest.raises(ValueError) as err:
        T.make_decode_state(cfg, 2, 8, 2, kv_cache_dtype="int8",
                            device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "attention-free family 'ssm'" in str(err.value)
    with pytest.raises(ValueError) as err:
        LLM.load(ARCH, quant="rtn-int4", reduced=True, device="cpu",
                 kv_cache_dtype="int8")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="dense-family models, not "
                       "'ssm' \\(falcon-mamba-7b\\); use "
                       "quant='rtn-int4'"):
        LLM.load(ARCH, quant="gptq-int4", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="whole prompts"):
        T.prefill_chunk(cfg, bridged, None,
                        torch.zeros((1, 4), dtype=torch.int32),
                        torch.zeros((1, 2), dtype=torch.int32), 0, 4)
