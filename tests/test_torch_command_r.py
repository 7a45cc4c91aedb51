"""The port's command-r-plus-104b (a dense GQA decoder with layernorm and
a tied 256,000-token embedding, served as rtn-int4 at group size 128)
against the JAX package on the CPU, on the same bridged params and numpy
inputs.

The config and the full model's leaf shapes are the reference's, and its
served bytes reckon to 62.9 GB at group 128 (81.8 at 32, more than the
card holds); RTN codes, scales and zeros at group 128 are bitwise the
reference's, and ``LLM.load``'s draw (each layer quantized from f32, then
cast) equals quantize-then-cast; ``forward``, ``prefill`` and
``decode_step`` within 1e-4 of JAX's (layernorm with a bias, rope theta
7.5e7); the plain decode and chunk attention at G = 12 against the Pallas
kernels in interpret mode; greedy drains token-exact against the JAX
engine, with step graphs on and off.

Model: reduced command-r (2 layers, d_model 256, d_ff 512, 12 query heads
over 1 KV head of dim 32, so every linear's K is a multiple of 128 and
group 128 holds), f32 activations.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_reduced as j_get_reduced
from repro.kernels.flash_attention import flash_attention_chunk as j_chunk
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.models import transformer as JT
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import NOT_PORTED, get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.quantize import quantize_params_rtn
from repro_torch.serving import LLM, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
ARCH = "command-r-plus-104b"
SMALL = dict(d_model=256, d_ff=512, num_heads=12, num_kv_heads=1,
             head_dim=32)
OVR = {**SMALL, "dtype": "float32"}
GS = 128
LOGIT_TOL = 1e-4
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24, prefill_bucket=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this file's small ops (ROADMAP C13)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cmdr():
    """The reduced config in both packages and the JAX params, with the
    layernorms' weights and biases drawn (the init's are 1 and 0, which
    would leave the bias untested), bridged to the port."""
    jcfg, cfg = j_get_reduced(ARCH, **OVR), get_reduced(ARCH, **OVR)
    params = _np(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)

    def norms(tree, key=""):
        if isinstance(tree, dict):
            return {k: norms(v, k if k.endswith("norm") else key)
                    for k, v in tree.items()}
        if key.endswith("norm"):
            return (1 + 0.1 * rng.standard_normal(tree.shape)) \
                .astype(np.float32)
        return tree
    params = norms(params)
    return jcfg, cfg, params, params_from_numpy(params, device="cpu")


def _close(t, j, tol=LOGIT_TOL, err=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0, err_msg=err)


def test_config_is_the_references():
    """Every field of the config as the reference has it; it is served,
    and only kimi-k2 stays unported."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.norm, cfg.tie_embeddings, cfg.rope_theta) \
        == ("dense", 64, 12288, 96, 8, 128, 33792, 256000, "layernorm", True,
            75e6)
    assert NOT_PORTED == ("kimi-k2-1t-a32b",)
    assert T.supports_chunked_prefill(cfg)
    assert dataclasses.asdict(get_reduced(ARCH, **OVR)) == \
        dataclasses.asdict(j_get_reduced(ARCH, **OVR))


def _served_bytes(cfg, gs):
    """The served tree's bytes, from one meta layer quantized at ``gs`` and
    cast as the runner casts it, times the layers, plus the bf16 tied
    embedding and the final norm; ``g_idx`` (never read on the card)
    apart."""
    layer = T.cast_params(quantize_params_rtn(
        T.init_layer(None, cfg, "meta"), cfg, gs), torch.bfloat16)
    top = T.cast_params({k: v for k, v in T.init_params(
        cfg.replace(num_layers=1), device="meta").items() if k != "layers"},
        torch.bfloat16)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for k, v in tree.items() if k != "g_idx")
        return tree.numel() * tree.element_size()
    return cfg.num_layers * nbytes(layer) + nbytes(top)


def test_full_model_shapes_and_served_bytes():
    """The full model's leaves on the meta device have the reference's
    shapes (``jax.eval_shape``: 103.8 B parameters, a tied embedding);
    at group 128 the served tree (int4 codes 50.33 GB, f32 scales and
    zeros 6.29, the bf16 embedding 6.29) is 62.9 GB, at group 32 81.8 GB,
    more than the card's 80."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    want = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = T.init_params(cfg, device="meta")
    flat_w = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g == flat_w
    assert "head" not in got
    assert sum(int(np.prod(s)) for s in flat_g.values()) == \
        pytest.approx(103.81e9, rel=1e-3)
    assert _served_bytes(cfg, 128) / 1e9 == pytest.approx(62.927, abs=1e-3)
    assert _served_bytes(cfg, 32) / 1e9 == pytest.approx(81.802, abs=1e-3)


def test_index_widths_and_the_group_128_plan():
    """The embedding (3.15e9 elements) and the w_gate / w_up code stacks
    ([64, 1536, 33792] int32, 3.32e9) pass 2**31 elements, but what a
    kernel receives is one layer's view: every int4 leaf of a layer, the
    per-call products' M, K, N and the whole paged pool stay below 2**31
    (the wrappers pass them as C ints).  ``plan`` stages 1 scale row a k
    tile at group 128 (2 at 32)."""
    from repro_torch.kernels.gptq_matmul import plan
    cfg = get_config(ARCH)
    meta = T.init_params(cfg, device="meta")
    assert meta["embed"].numel() > 2 ** 31
    q = quantize_params_rtn(T.init_layer(None, cfg, "meta"), cfg, GS)
    assert 64 * q["mlp"]["w_gate"]["qweight"].numel() > 2 ** 31
    leaves = [t for blk in ("attn", "mlp") for w in q[blk].values()
              for t in w.values()]
    assert max(t.numel() for t in leaves) < 2 ** 31
    pool = T.make_decode_state(cfg, 8, 512, 64, device="meta")["k_pool"]
    assert pool.numel() < 2 ** 31
    for M in (8, 256):
        for K, N in ((12288, 33792), (33792, 12288)):
            assert max(M, K, N, M * K, M * N) < 2 ** 31
            assert plan(M, K, N, 128, 132).sr == 1
            assert plan(M, K, N, 32, 132).sr == 2


def test_rtn_codes_at_group_128_match_jax(cmdr):
    """RTN at group 128 over the layer stacks: every code, scale, zero and
    g_idx bitwise the reference's; each linear has K / 128 groups."""
    jcfg, cfg, params, bridged = cmdr
    want = _np(j_rtn(params, jcfg, group_size=GS))
    got = quantize_params_rtn(bridged, cfg, GS)
    n = 0
    for block in ("attn", "mlp"):
        for name, w in want["layers"][block].items():
            if not isinstance(w, dict):
                continue
            for key in ("qweight", "scales", "zeros", "g_idx"):
                np.testing.assert_array_equal(
                    got["layers"][block][name][key].numpy(), w[key],
                    err_msg=f"{name}/{key}")
            K = got["layers"][block][name]["g_idx"].shape[-1]
            assert got["layers"][block][name]["scales"].shape[1] == K // GS
            n += 1
    assert n == 7


def test_load_quantizes_from_f32_then_casts():
    """``LLM.load(quant="rtn-int4", quant_group_size=128)`` draws each layer
    in f32, quantizes it and casts what stays dense (the embedding in the
    activation dtype from the start): bitwise the f32 init quantized and
    then cast by the runner, and the codes those of the f32 weights."""
    cfg = get_reduced(ARCH, **SMALL)
    llm = LLM.load(ARCH, quant="rtn-int4", quant_group_size=GS, reduced=True,
                   overrides=SMALL, seed=3, device="cpu")
    want = T.split_layers(T.cast_params(quantize_params_rtn(
        T.init_params(cfg, 3, "cpu"), cfg, GS), torch.bfloat16))
    assert llm.params["embed"].dtype == torch.bfloat16
    assert llm.params["final_norm"]["b"].dtype == torch.float32

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    same(llm.params, want)
    llm.close()


def test_dequantized_weights_give_the_plain_int4_numbers(cmdr):
    """``chip_smoke.dequantized`` (the card-vs-CPU check's CPU side) turns
    each int4 dict into the weight the plain int4 product multiplies by:
    ``T.forward`` over it equals the int4 tree's forward bit for bit."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    _, cfg, _, bridged = cmdr
    bcfg = cfg.replace(dtype="bfloat16")
    q = T.cast_params(quantize_params_rtn(bridged, bcfg, GS), torch.bfloat16)
    dense = T.cast_params(chip_smoke.dequantized(q, torch.bfloat16),
                          torch.bfloat16)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32))}
    with torch.no_grad():
        assert torch.equal(T.forward(bcfg, q, toks),
                           T.forward(bcfg, dense, toks))


def test_forward_prefill_and_decode_match_jax(cmdr):
    """``forward`` over ragged prompts, then ``prefill`` over the paged pool
    and three teacher-forced ``decode_step``s: every call's f32 logits
    within 1e-4 of the reference's same call, the pools too."""
    jcfg, cfg, params, bridged = cmdr
    B, S_total, S_prompt, MB = 2, 28, 19, 4
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S_total)).astype(np.int32)
    ctx_lens = np.array([S_prompt, S_prompt - 6], np.int32)
    table = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        _close(T.forward(cfg, bridged, {"tokens": torch.from_numpy(toks)}),
               JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}),
               err="forward")
    batch = {"tokens": toks[:, :S_prompt], "ctx_lens": ctx_lens}
    jst = JT.make_decode_state(jcfg, B, B * MB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(table)
    jlg, jst = JT.prefill(jcfg, jp, jst, jax.tree.map(jnp.asarray, batch))
    st = T.make_decode_state(cfg, B, B * MB, MB, device="cpu")
    st["block_table"] = torch.from_numpy(table)
    p = T.split_layers(bridged)
    with torch.no_grad():
        lg, st = T.prefill(cfg, p, st, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        _close(lg, jlg, err="prefill")
        for step in range(3):
            pos = ctx_lens + step
            tok = toks[np.arange(B), pos]
            jst = dict(jst, seq_lens=jnp.asarray(pos + 1))
            jlg, jst = JT.decode_step(jcfg, jp, jst, jnp.asarray(tok))
            st["seq_lens"] = torch.from_numpy(pos + 1)
            lg, st = T.decode_step(cfg, p, st, torch.from_numpy(tok))
            _close(lg, jlg, err=f"step {step}")
    _close(st["k_pool"], jst["k_pool"], err="k_pool")
    _close(st["v_pool"], jst["v_pool"], err="v_pool")


def test_paged_decode_and_chunk_at_g12_match_pallas():
    """command-r's grouping (12 query heads a KV head, head dim 128): the
    port's plain decode and chunk attention against the Pallas kernels in
    interpret mode, f32, within 5e-5."""
    rng = np.random.default_rng(12)
    H, KV, D, BS, MB = 24, 2, 128, 8, 5
    B, NB = 4, 4 * 5 + 3
    f = np.float32
    q = rng.normal(size=(B, H, D)).astype(f)
    kp, vp = (rng.normal(size=(NB, BS, KV, D)).astype(f) for _ in range(2))
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    sl = np.array([1, 13, 2 * BS, MB * BS], np.int32)
    out = ops.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, bt, sl)), None)
    pal = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, sl)), None,
                  interpret=True)
    _close(out, pal, 5e-5, "paged decode")
    W, q_off, total = 16, 11, 20
    qc = rng.normal(size=(1, W, H, D)).astype(f)
    kr, vr = (rng.normal(size=(1, W, KV, D)).astype(f) for _ in range(2))
    cbt = bt[:1]
    out = ops.chunk_prefill_attention(
        torch.from_numpy(qc), torch.from_numpy(kp)[None],
        torch.from_numpy(vp)[None], None, None, 0, torch.from_numpy(cbt),
        torch.tensor(q_off, dtype=torch.int32),
        torch.tensor(total, dtype=torch.int32), torch.from_numpy(kr),
        torch.from_numpy(vr))
    pal = j_chunk(jnp.asarray(qc), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(cbt), jnp.int32(q_off), jnp.int32(total),
                  jnp.asarray(kr), jnp.asarray(vr), block_q=8,
                  interpret=True)
    _close(out[:, :total - q_off], pal[:, :total - q_off], 5e-5, "chunk")


@pytest.fixture(scope="module")
def jax_drain():
    """The JAX engine's greedy tokens (synchronous, chunked) from
    ``JLLM.load(quant="rtn-int4", quant_group_size=128)``."""
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, 250, n)) for n in (30, 45, 12, 70)]
    mts = (10, 6, 12, 4)
    jllm = JLLM.load(ARCH, quant="rtn-int4", quant_group_size=GS,
                     reduced=True, overrides=OVR, seed=0,
                     enable_async_step=False, **ENGINE_KW)
    return prompts, mts, [o.token_ids for o in jllm.generate(
        prompts, [JSP(max_tokens=m) for m in mts])]


@pytest.mark.parametrize("mode", ["sync", "defaults", "graphs-off"])
def test_greedy_drain_matches_jax_engine(cmdr, jax_drain, mode):
    """The reference's seed-0 params, quantized at group 128 by the port,
    drain four prompts over three slots greedy, token-exact against the
    JAX engine: synchronous chunked, the defaults (async, step graphs),
    and the defaults with graphs off."""
    _, cfg, _, _ = cmdr
    prompts, mts, want = jax_drain
    jparams = _np(JT.init_params(j_get_reduced(ARCH, **OVR),
                                 jax.random.PRNGKey(0)))
    params = quantize_params_rtn(params_from_numpy(jparams, device="cpu"),
                                 cfg, GS)
    kw = {"sync": dict(enable_async_step=False), "defaults": {},
          "graphs-off": dict(capture_graphs=False)}[mode]
    llm = LLM(cfg, params, seed=0, device="cpu", **ENGINE_KW, **kw)
    assert llm.engine.chunked
    assert llm.engine.async_step == (mode != "sync")
    got = llm.generate(prompts, [SamplingParams(max_tokens=m) for m in mts])
    assert [o.token_ids for o in got] == want
    assert llm.engine.alloc.audit()["live_blocks"] == 0
    llm.close()
