"""The port's hybrid decoder (recurrentgemma-2b: RG-LRU layers with
per-slot recurrent state beside sliding-window attention layers over
private rings) against the JAX package on the CPU, on the same bridged
params (bridged in this process: the reference's hybrid init folds
``hash(stack name)`` into its keys, which Python salts per process,
ROADMAP C12).

Modules at 5e-5 (f32): the non-gated GELU MLP, ``rglru_apply``,
``rglru_prefill`` on right-padded ragged rows (y, final state, conv
state) and a chain of ``rglru_decode`` steps.  The model at the logit
tolerance of ``tests/test_torch_model.py``: ``forward``, RTN's tree,
prefill plus decode chains with a ring wrap (dense and rtn-int4) and a
megastep.  Greedy engine drains: one request alone token-exact with the
JAX engine, batches token-exact with the reference's teacher-forced
``JT.forward`` (ROADMAP C11: the JAX engine's batched rings alias).  The
runner's wave writes the recurrent state in place at the wave's slots,
and the port's own init is repeatable across processes.

Model: reduced recurrentgemma-2b cut to 6 layers (recurrent, recurrent,
sliding, twice: 4 RG-LRU and 2 attention layers; the reference's reduced
default has 2 layers, both recurrent), d_model and lru_width 64, 4 query
heads over 1 KV head of dim 16, f32 activations; window 32 for the
modules and the model, 12 for the engine drains (rings of 32 slots).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.kv_quant import cache_from_state
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.quantize import quantize_params_rtn
from repro_torch.serving import LLM, FaultInjector, FaultSpec, SamplingParams
from repro_torch.serving.model_runner import ModelRunner


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

ARCH = "recurrentgemma-2b"
MOD_TOL = 5e-5
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(**kw):
    kw = dict(num_layers=6, dtype="float32", **kw)
    jcfg, cfg = j_get_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(_np(params), device="cpu")


@pytest.fixture(scope="module")
def rgemma():
    return _models()


@pytest.fixture(scope="module")
def rgemma12():
    return _models(sliding_window=12)


def _close(t, j, tol, err=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0, err_msg=err)


def test_registry_serves_recurrentgemma():
    """The full config as the reference has it, and its size by count of
    the leaves (``cfg.num_params()`` leaves out wr and wi)."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.lru_width,
            cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.sliding_window, cfg.act) == \
        ("hybrid", 26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048, "gelu")
    plan = T.layer_plan(cfg)
    assert T.attn_layer_count(cfg) == (8, 18)
    assert [p[0] for p in plan[:3]] == ["recurrent", "recurrent", "sliding"]
    assert plan[5] == ("sliding", "attn_layers", 1)
    assert plan[25] == ("recurrent", "rec_layers", 17)
    assert not T.supports_chunked_prefill(cfg)
    meta = T.init_params(cfg, device="meta")
    n = sum(t.numel() for t in T._leaves(meta))
    assert 2.37e9 < n < 2.39e9 and "head" not in meta


# ------------------------------------------------------------ modules

def test_gelu_mlp_matches_jax(rgemma):
    """The non-gated MLP with ``jax.nn.gelu``'s tanh approximation."""
    jcfg, cfg, params, bridged = rgemma
    jmlp = jax.tree.map(lambda a: a[0], params["attn_layers"])["mlp"]
    tmlp = T.split_layers(bridged)["attn_layers"][0]["mlp"]
    assert set(tmlp) == {"w_up", "w_down"}
    x = np.random.default_rng(1).normal(size=(3, 7, 64)).astype(np.float32)
    want = JL.mlp_apply(jmlp, jnp.asarray(x), "gelu")
    got = L.mlp_apply(tmlp, torch.from_numpy(x), "gelu")
    _close(got, want, MOD_TOL)
    xs = np.linspace(-6, 6, 101).astype(np.float32)
    _close(L.act_fn("gelu")(torch.from_numpy(xs)),
           jax.nn.gelu(jnp.asarray(xs)), 1e-6)


def _rec(rgemma, i=0):
    jcfg, cfg, params, bridged = rgemma
    return (jax.tree.map(lambda a: a[i], params["rec_layers"])["rec"],
            T.split_layers(bridged)["rec_layers"][i]["rec"])


def test_rglru_apply_matches_jax(rgemma):
    jcfg, cfg, *_ = rgemma
    jp, tp = _rec(rgemma, 1)
    x = np.random.default_rng(2).normal(size=(2, 19, 64)).astype(np.float32)
    with torch.no_grad():
        got = S.rglru_apply(cfg, tp, torch.from_numpy(x))
    _close(got, JS.rglru_apply(jcfg, jp, jnp.asarray(x)), MOD_TOL)


def test_rglru_prefill_ragged_matches_jax(rgemma):
    """Right-padded rows of lengths 1, 2 (shorter than the conv's 3 taps
    of state: zeros before the first token), 9 and the full 16: y, the
    state at each ctx_len and the last 3 valid inputs."""
    jcfg, cfg, *_ = rgemma
    jp, tp = _rec(rgemma, 2)
    B, Sq = 4, 16
    x = np.random.default_rng(3).normal(size=(B, Sq, 64)).astype(np.float32)
    lens = np.array([1, 2, 9, 16], np.int32)
    mask = np.arange(Sq)[None] < lens[:, None]
    want = JS.rglru_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(lens))
    with torch.no_grad():
        got = S.rglru_prefill(cfg, tp, torch.from_numpy(x),
                              torch.from_numpy(mask), torch.from_numpy(lens))
    for name, g, w in zip(("y", "h_final", "conv_state"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, MOD_TOL, name)


def test_rglru_decode_chain_matches_jax(rgemma):
    """Twelve decode steps from a prefill's state: every output, the state
    and the conv state stay within 5e-5 of JAX's."""
    jcfg, cfg, *_ = rgemma
    jp, tp = _rec(rgemma, 3)
    rng = np.random.default_rng(4)
    B = 3
    x0 = rng.normal(size=(B, 5, 64)).astype(np.float32)
    lens = np.array([5, 3, 4], np.int32)
    mask = np.arange(5)[None] < lens[:, None]
    _, jh, jc = JS.rglru_prefill(jcfg, jp, jnp.asarray(x0),
                                 jnp.asarray(mask), jnp.asarray(lens))
    with torch.no_grad():
        _, th, tc = S.rglru_prefill(cfg, tp, torch.from_numpy(x0),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(lens))
        for t in range(12):
            x = rng.normal(size=(B, 64)).astype(np.float32)
            jy, jh, jc = JS.rglru_decode(jcfg, jp, jnp.asarray(x), jh, jc)
            ty, th, tc = S.rglru_decode(cfg, tp, torch.from_numpy(x), th, tc)
            for name, g, w in (("y", ty, jy), ("h", th, jh), ("conv", tc, jc)):
                _close(g, w, MOD_TOL, f"step {t} {name}")


def test_mamba_half_is_refused_by_name():
    """The Mamba half of ``models/ssm.py`` is ported (falcon-mamba-7b,
    ``tests/test_torch_ssm.py``); a family still unported is refused by
    name at the registry, and at the model what stays unserved: the
    decode state of the audio encoder, which has no decode."""
    with pytest.raises(NotImplementedError, match="kimi-k2-1t-a32b"):
        get_config("kimi-k2-1t-a32b")
    with pytest.raises(NotImplementedError, match="hubert-xlarge"):
        T.make_decode_state(get_reduced("hubert-xlarge"), 2, 8, 2,
                            device="cpu")


# ------------------------------------------------------------ model

@pytest.fixture(scope="module")
def quantized(rgemma):
    jcfg, cfg, params, bridged = rgemma
    jq = j_rtn(params, jcfg, group_size=32)
    return {"dense": (params, bridged),
            "rtn-int4": (jq, params_from_numpy(_np(jq), device="cpu"))}


def test_quantize_params_rtn_matches_jax(rgemma, quantized):
    """Both stacks walked with the reference's targets: w_in, w_gate_rec,
    w_out_rec, the attention and MLP linears to int4, bit for bit; wr,
    wi, conv_w, a_param and the tied embedding dense."""
    jcfg, cfg, _, bridged = rgemma
    want = _np(quantized["rtn-int4"][0])
    got = quantize_params_rtn(bridged, cfg, group_size=32)
    rec = got["rec_layers"]["rec"]
    assert {k for k, v in rec.items() if isinstance(v, dict)} == \
        {"w_in", "w_gate_rec", "w_out_rec"}
    assert "qweight" in got["attn_layers"]["attn"]["wk"]
    assert "qweight" in got["attn_layers"]["mlp"]["w_down"]

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert b.numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)

    walk(want, got)


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
def test_forward_logits_match_jax(rgemma, quantized, quant):
    jcfg, cfg, *_ = rgemma
    jp, tp = quantized[quant]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 45))
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, LOGIT_TOL)


def _state_close(st, jst):
    for name in ("lru_h", "rec_conv", "k_pool", "v_pool"):
        assert tuple(st[name].shape) == tuple(jst[name].shape), name
        _close(st[name], jst[name], POOL_TOL, name)


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
def test_prefill_and_decode_steps_match_jax(rgemma, quantized, quant):
    """A wave whose longest prompt (40) outgrows the 32-slot ring, then 30
    decode steps (both rings wrap): each step's logits, and at the end
    ``lru_h``, ``rec_conv`` and the pools (2 attention layers) equal
    JAX's."""
    jcfg, cfg, *_ = rgemma
    jp, tp = quantized[quant]
    B, MB, NB, steps = 2, 2, 8, 30
    lens = np.array([40, 13], np.int32)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, 40 + steps)).astype(np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(bt)
    st = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    assert st.keys() == jst.keys()
    st["block_table"] = torch.from_numpy(bt)
    batch = {"tokens": toks[:, :40], "ctx_lens": lens}
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


def test_decode_megastep_matches_jax(rgemma, quantized):
    """A greedy megastep of 20 steps after a prefill, one slot inactive
    (its recurrent row still steps, as in the reference): tokens and
    state equal JAX's."""
    jcfg, cfg, *_ = rgemma
    jp, tp = quantized["rtn-int4"]
    B, MB, NB, n = 3, 2, 8, 20
    lens = np.array([20, 0, 9], np.int32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    active = lens > 0
    sampling = {"keys": np.zeros((B, 2), np.uint32),
                "counts": np.zeros(B, np.int32),
                "temps": np.zeros(B, np.float32),
                "top_ks": np.zeros(B, np.int32),
                "top_ps": np.ones(B, np.float32)}
    batch = {"tokens": toks, "ctx_lens": np.maximum(lens, 1)}
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(bt)
    jlog, jst = JT.prefill(jcfg, jp, jst, jax.tree.map(jnp.asarray, batch))
    first = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jst["seq_lens"] = jnp.asarray(lens + active)
    want, jst = JT.decode_megastep(
        jcfg, jp, jst, jnp.asarray(first),
        jax.tree.map(jnp.asarray, sampling), jnp.asarray(active),
        jnp.int32(n), max_horizon=n)
    st = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    st["block_table"] = torch.from_numpy(bt)
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


def test_cast_params_keeps_the_rglru_f32_leaves(rgemma):
    """``a_param`` (read in f32 always) and ``conv_w`` (f32 in decode,
    cast only in prefill) stay f32 when the rest is cast to bf16."""
    _, cfg, _, bridged = rgemma
    b16 = T.cast_params(bridged, torch.bfloat16)
    rec = b16["rec_layers"]["rec"]
    assert rec["a_param"].dtype == rec["conv_w"].dtype == torch.float32
    assert rec["wr"].dtype == rec["w_in"].dtype == torch.bfloat16
    assert b16["attn_layers"]["attn_norm"]["w"].dtype == torch.float32
    assert T.keeps_dtype("rec_layers.rec.a_param")
    assert not T.keeps_dtype("rec_layers.rec.wi")


def test_bridge_carries_the_two_stack_tree(rgemma):
    """``params_from_numpy`` carries both per-kind stacks leaf for leaf,
    and ``split_layers`` splits each."""
    _, cfg, params, bridged = rgemma
    want = _np(params)
    assert set(bridged) == set(want) == {"embed", "final_norm",
                                         "rec_layers", "attn_layers"}
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        t = bridged
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    split = T.split_layers(bridged)
    assert len(split["rec_layers"]) == 4 and len(split["attn_layers"]) == 2
    assert T._layer(split, 5, cfg) is split["attn_layers"][1]
    assert T._layer(split, 4, cfg) is split["rec_layers"][3]


_INIT_SUMS = """
import torch
from repro_torch.configs.registry import get_reduced
from repro_torch.models import transformer as T
cfg = get_reduced("recurrentgemma-2b", num_layers=3)
p = T.init_params(cfg, 0, device="cpu")
print(repr([float(t.double().sum()) for t in T._leaves(p)]))
"""


def test_port_init_is_repeatable_across_processes():
    """Two processes with other string-hash salts draw the same weights
    (the reference's do not: ROADMAP C12)."""
    outs = []
    for seed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=SRC)
        outs.append(subprocess.run([sys.executable, "-c", _INIT_SUMS],
                                   env=env, capture_output=True, text=True,
                                   check=True, timeout=300).stdout)
    assert outs[0] == outs[1] and outs[0].startswith("[")


# ------------------------------------------------------------ engine

def _teacher_forced(jcfg, params, prompts, max_tokens):
    """The reference's greedy tokens without its engine: argmax of
    ``JT.forward`` over the prompt plus the tokens so far, one token at a
    time (right-padded to one width, so one trace serves every step)."""
    width = max(len(p) for p in prompts) + max_tokens
    fwd = jax.jit(lambda toks: JT.forward(jcfg, params, {"tokens": toks}))
    seqs = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    for _ in range(max_tokens):
        buf = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            buf[i, :len(s)] = s
        logits = np.asarray(fwd(jnp.asarray(buf)))
        for i, s in enumerate(seqs):
            t = int(np.argmax(logits[i, len(s) - 1]))
            s.append(t)
            out[i].append(t)
    return out


ENGINE_KW = dict(max_slots=3, num_blocks=24, max_blocks_per_seq=2,
                 prefill_bucket=16)
DRAIN_MODES = {"sync": dict(enable_async_step=False), "async": {}}


def test_single_request_drain_matches_jax_engine(rgemma12):
    """One request alone, past position 16 and the 32-slot ring: the JAX
    engine's ring aliases only onto its own first block, which a window
    of 12 under 16-token blocks survives, so the JAX engine is right here
    and the port gives its tokens."""
    jcfg, cfg, params, bridged = rgemma12
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size,
                                                9).tolist()
    kw = dict(ENGINE_KW, enable_async_step=False)
    want = JLLM(jcfg, params, **kw).generate([prompt], JSP(max_tokens=30))
    llm = LLM(cfg, bridged, device="cpu", **kw)
    got = llm.generate([prompt], SamplingParams(max_tokens=30))
    assert got[0].token_ids == want[0].token_ids
    assert got[0].token_ids == _teacher_forced(jcfg, params, [prompt],
                                               30)[0]
    llm.close()


@pytest.mark.parametrize("mode", list(DRAIN_MODES))
@pytest.mark.parametrize("lens", [(9, 9), (5, 9, 20)],
                         ids=["equal", "ragged"])
def test_batched_drain_matches_teacher_forced_tokens(rgemma12, mode, lens):
    """Prompts served together over private 32-slot rings, 30 greedy
    tokens each (every ring wraps, every recurrent row steps), against
    the reference's teacher-forced tokens."""
    jcfg, cfg, params, bridged = rgemma12
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    want = _teacher_forced(jcfg, params, prompts, 30)
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW, **DRAIN_MODES[mode])
    eng = llm.engine
    assert eng.scheduler.ring_only and not eng.chunked and not eng.async_step
    got = llm.generate(prompts, SamplingParams(max_tokens=30))
    assert [o.token_ids for o in got] == want
    assert eng.alloc.audit() == {"live_blocks": 0, "free_blocks": 24,
                                 "hash_entries": 0}
    llm.close()


def test_preempted_drain_rebuilds_the_recurrent_state(rgemma12):
    """A request poisoned mid-decode is bisected out: the others are
    preempted and replayed (prompt plus output through a new wave, which
    rebuilds their recurrent rows) and finish with the teacher-forced
    tokens; every ring block comes back."""
    jcfg, cfg, params, bridged = rgemma12
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (20, 9, 14)]
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW,
              enable_async_step=False, max_horizon=4,
              fault_injector=FaultInjector([FaultSpec("dispatch", step=4,
                                                      rid=1)]))
    got = llm.generate(prompts, SamplingParams(max_tokens=24))
    eng = llm.engine
    assert eng.metrics["preemptions"] >= 2 and eng.metrics["quarantined"] == 1
    assert got[1].finish_reason == "error"
    want = _teacher_forced(jcfg, params, [prompts[0], prompts[2]], 24)
    assert [got[0].token_ids, got[2].token_ids] == want
    assert eng.alloc.audit() == {"live_blocks": 0, "free_blocks": 24,
                                 "hash_entries": 0}
    llm.close()


class _Seq:
    def __init__(self, slot, prompt, block_ids):
        self.slot, self.seq_len, self.block_ids = slot, len(prompt), block_ids
        self.req = type("Req", (), {"prompt": prompt})()


def test_wave_writes_the_recurrent_rows_in_place(rgemma12):
    """A wave of slots 2 and 0 writes exactly those rows of ``lru_h`` and
    ``rec_conv``, into the runner's own tensors (a step graph reads
    them), with the values a prefill of the same rows gives; slot 1
    keeps its row."""
    _, cfg, _, bridged = rgemma12
    r = ModelRunner(cfg, bridged, max_slots=3, num_blocks=8,
                    max_blocks_per_seq=2, chunk_tokens=None)
    st = r.state
    ptrs = {k: st[k].data_ptr() for k in ("lru_h", "rec_conv")}
    st["lru_h"].fill_(7.0)
    st["rec_conv"].fill_(7.0)
    rng = np.random.default_rng(17)
    seqs = [_Seq(2, rng.integers(1, 200, 11).tolist(), [4, 5]),
            _Seq(0, rng.integers(1, 200, 5).tolist(), [0, 1])]
    r.prefill(seqs, 16)
    assert {k: st[k].data_ptr() for k in ptrs} == ptrs
    assert r.state is st
    sub = T.make_decode_state(cfg, 2, 8, 2, device="cpu")
    sub["block_table"] = torch.tensor([[6, 7], [2, 3]], dtype=torch.int32)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    for i, s in enumerate(seqs):
        toks[i, :s.seq_len] = torch.tensor(s.req.prompt)
    with torch.no_grad():
        _, want = T.prefill(cfg, r.params, sub, {
            "tokens": toks, "ctx_lens": torch.tensor([11, 5],
                                                     dtype=torch.int32)})
    for k in ("lru_h", "rec_conv"):
        assert torch.equal(st[k][:, [2, 0]], want[k]), k
        assert bool((st[k][:, 1] == 7.0).all()), k


def test_refusals_match_the_reference(rgemma):
    """int8 KV (the sliding layers' rings) and gptq-int4 (not a dense
    model) raise the reference's messages; chunked prefill is quietly
    off for the engine and refused by name at the model."""
    jcfg, cfg, _, bridged = rgemma
    with pytest.raises(ValueError) as jerr:
        JT.make_decode_state(jcfg, 2, 8, 2, kv_cache_dtype="int8")
    with pytest.raises(ValueError) as err:
        T.make_decode_state(cfg, 2, 8, 2, kv_cache_dtype="int8",
                            device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="dense-family models, not "
                       "'hybrid' \\(recurrentgemma-2b\\); use "
                       "quant='rtn-int4'"):
        LLM.load(ARCH, quant="gptq-int4", reduced=True, device="cpu")
    llm = LLM(cfg, bridged, device="cpu", enable_chunked_prefill=True,
              **ENGINE_KW)
    assert not llm.engine.chunked and llm.engine.scheduler.ring_only
    st = T.make_decode_state(cfg, 1, 8, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="whole prompts"):
        T.prefill_chunk(cfg, bridged, cache_from_state(st),
                        torch.zeros((1, 4), dtype=torch.int32),
                        st["block_table"][:1], 0, 4)
    llm.close()


def test_rtn_load_serves_on_the_cpu():
    """``LLM.load`` with rtn-int4 at the reduced size (the reference's
    2-layer default: both layers recurrent, so no attention pool at
    all) serves greedy tokens, and the 6-layer cut too."""
    for kw in ({}, {"overrides": {"num_layers": 6}}):
        llm = LLM.load(ARCH, quant="rtn-int4", reduced=True, device="cpu",
                       max_slots=2, num_blocks=8, max_blocks_per_seq=2,
                       **kw)
        stack = T.layer_plan(llm.cfg)[0][1]
        assert stack == ("layers" if not kw else "rec_layers")
        rec = llm.params[stack][0]["rec"]
        assert "qweight" in rec["w_in"] and not isinstance(rec["wr"], dict)
        out = llm.generate([[1, 2, 3, 4, 5]], SamplingParams(max_tokens=6))
        assert len(out[0].token_ids) == 6
        llm.close()
