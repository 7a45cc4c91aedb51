"""The port's sliding-window decoder (h2o-danube-3-4b, every layer a
window over a ring cache) against the JAX package on the CPU, on the same
bridged params: the ring prefill and its writes, prefill plus decode steps
and the megastep over a full, distinct block table (the reference's own
model-level setting), greedy engine drains against the reference's
teacher-forced tokens, a single-request drain against the JAX engine, the
ring scheduler's private blocks, and the int8 refusal.

Model: reduced h2o-danube-3-4b (2 layers, d_model 64, 8 query heads over 2
KV heads, head dim 16, and one case at the real head dim 120), f32
activations, window 12.  Rings of ``MB * 16`` slots: 64 for the prefill
cases, 32 where a sequence must wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.kv_quant import cache_from_state as j_cache_from_state
from repro.models import transformer as JT
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.kv_quant import cache_from_state
from repro_torch.core.paged_cache import BlockAllocator
from repro_torch.models import transformer as T
from repro_torch.serving import LLM, FaultInjector, FaultSpec, SamplingParams
from repro_torch.serving.scheduler import RequestState, Scheduler


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

ARCH = "h2o-danube-3-4b"
WINDOW = 12
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


def _cfg_kw(head_dim=16):
    return dict(dtype="float32", num_heads=8, num_kv_heads=2,
                head_dim=head_dim, sliding_window=WINDOW)


def _models(head_dim=16):
    jcfg = j_get_reduced(ARCH, **_cfg_kw(head_dim))
    cfg = get_reduced(ARCH, **_cfg_kw(head_dim))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, cfg, params, bridged


@pytest.fixture(scope="module")
def danube():
    return _models()


@pytest.fixture(scope="module")
def danube120():
    return _models(120)


def test_registry_serves_danube():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.sliding_window) == \
        (24, 3840, 32, 8, 120, 10240, 8192)
    assert {cfg.layer_kind(i) for i in range(24)} == {"sliding"}
    assert not T.supports_chunked_prefill(cfg)


# ------------------------------------------------------------ ring prefill

@pytest.mark.parametrize("model", ["danube", "danube120"])
def test_ring_prefill_pools_match_jax(model, request):
    """``attn_prefill_ring`` of layer 0 on a wave whose lengths lie below,
    at and above the 64-slot ring (a prompt of 80 keeps its last 64
    tokens, the oldest 16 overwritten): outputs and both pools equal
    JAX's."""
    jcfg, cfg, params, bridged = request.getfixturevalue(model)
    B, S, MB, NB = 3, 80, 4, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    lens = np.array([40, 64, 80], np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    jlp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    want, jcache = JT.attn_prefill_ring(
        jcfg, jlp, jnp.asarray(x), None, kind="sliding",
        cache=j_cache_from_state(jst), layer=0,
        block_table=jnp.asarray(bt), ctx_lens=jnp.asarray(lens), rt={})
    st = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    lp = T.split_layers(bridged)["layers"][0]["attn"]
    with torch.no_grad():
        got, cache = T.attn_prefill_ring(
            cfg, lp, torch.from_numpy(x), kind="sliding",
            cache=cache_from_state(st), layer=0,
            block_table=torch.from_numpy(bt),
            ctx_lens=torch.from_numpy(lens))
    for a, b in ((got, want), (cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POOL_TOL,
                                   rtol=0)


def test_write_ring_keeps_the_last_cache_len_positions():
    """``_write_ring`` alone on positions 0..S-1 of rows of lengths below,
    at and above the ring: each kept position lands at slot p % cache_len
    of its own row, dropped ones nowhere (pools equal JAX's)."""
    B, S, MB, BS, NB = 3, 40, 2, 8, 8
    rng = np.random.default_rng(5)
    k = rng.normal(size=(B, S, 2, 8)).astype(np.float32)
    lens = np.array([10, 16, 40], np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    pool = rng.normal(size=(1, NB, BS, 2, 8)).astype(np.float32)
    cache_len = MB * BS
    pos = np.arange(S)
    keep = (pos[None] >= lens[:, None] - cache_len) & (pos[None] < lens[:, None])
    want = JT._write_ring(jnp.asarray(pool), 0, jnp.asarray(k),
                          jnp.asarray(bt), jnp.asarray(pos),
                          jnp.asarray(keep), cache_len)
    got = T._write_ring(torch.from_numpy(pool.copy()), 0,
                        torch.from_numpy(k), torch.from_numpy(bt),
                        torch.from_numpy(pos), torch.from_numpy(keep),
                        cache_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ model steps

def _tables(B, MB, NB, seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)


def test_prefill_and_decode_steps_match_jax_with_wrap(danube):
    """Prefill (one prompt longer than the 32-slot ring) then 40 decode
    steps over a full, distinct table: every step's logits and the final
    pools equal JAX's (both rings wrap)."""
    jcfg, cfg, params, bridged = danube
    B, MB, NB, steps = 2, 2, 8, 40
    lens = np.array([40, 13], np.int32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, 40 + steps)).astype(np.int32)
    bt = _tables(B, MB, NB, 8)
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(bt)
    st = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    st["block_table"] = torch.from_numpy(bt)
    p = T.split_layers(bridged)
    batch = {"tokens": toks[:, :40], "ctx_lens": lens}
    want, jst = JT.prefill(jcfg, params, jst, jax.tree.map(jnp.asarray,
                                                             batch))
    jdecode = jax.jit(lambda st, tok: JT.decode_step(jcfg, params, st, tok))
    with torch.no_grad():
        got, st = T.prefill(cfg, p, st, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=0)
        for t in range(steps):
            pos = lens + t
            tok = toks[np.arange(B), pos]
            jst = dict(jst, seq_lens=jnp.asarray(pos + 1))
            want, jst = jdecode(jst, jnp.asarray(tok))
            st["seq_lens"] = torch.from_numpy(pos + 1)
            got, st = T.decode_step(cfg, p, st, torch.from_numpy(tok))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=LOGIT_TOL, rtol=0)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]),
                                   atol=POOL_TOL, rtol=0)


def test_decode_megastep_matches_jax_with_wrap(danube):
    """A greedy megastep of 24 steps (one slot inactive) after a prefill,
    crossing the 32-slot ring's end: the tokens and the pools equal
    JAX's."""
    jcfg, cfg, params, bridged = danube
    B, MB, NB, n = 3, 2, 8, 24
    lens = np.array([20, 0, 9], np.int32)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    bt = _tables(B, MB, NB, 10)
    active = lens > 0
    sampling = {"keys": np.zeros((B, 2), np.uint32),
                "counts": np.zeros(B, np.int32),
                "temps": np.zeros(B, np.float32),
                "top_ks": np.zeros(B, np.int32),
                "top_ps": np.ones(B, np.float32)}
    jst = JT.make_decode_state(jcfg, B, NB, MB, dtype=jnp.float32)
    jst["block_table"] = jnp.asarray(bt)
    jlog, jst = JT.prefill(jcfg, params, jst,
                           {"tokens": jnp.asarray(toks),
                            "ctx_lens": jnp.asarray(np.maximum(lens, 1))})
    jst["seq_lens"] = jnp.asarray(lens)
    first = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jst["seq_lens"] = jst["seq_lens"] + jnp.asarray(active, jnp.int32)
    want, jst = JT.decode_megastep(
        jcfg, params, jst, jnp.asarray(first),
        jax.tree.map(jnp.asarray, sampling), jnp.asarray(active),
        jnp.int32(n), max_horizon=n)
    st = T.make_decode_state(cfg, B, NB, MB, device="cpu")
    st["block_table"] = torch.from_numpy(bt)
    p = T.split_layers(bridged)
    with torch.no_grad():
        log, st = T.prefill(cfg, p, st, {
            "tokens": torch.from_numpy(toks),
            "ctx_lens": torch.from_numpy(np.maximum(lens, 1))})
        assert (log.argmax(-1).numpy() == first).all()
        st["seq_lens"] = torch.from_numpy(lens + active.astype(np.int32))
        got, st = T.decode_megastep(
            cfg, p, st, torch.from_numpy(first), sampling,
            torch.from_numpy(active), n, max_horizon=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]),
                                   atol=POOL_TOL, rtol=0)


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


@pytest.mark.parametrize("mode", list(DRAIN_MODES))
@pytest.mark.parametrize("lens", [(9, 9), (5, 9, 20)],
                         ids=["equal", "ragged"])
def test_batched_drain_matches_teacher_forced_tokens(danube, mode, lens):
    """The ROADMAP C11 case: prompts served together over 32-slot rings,
    30 greedy tokens each (every ring wraps), against the reference's
    teacher-forced tokens.  The JAX engine gives every ring sequence only
    its prompt's blocks and pads its table row with block 0, so its rings
    alias from position 16 on and its batched tokens depart; the port's
    scheduler gives each ring all its blocks, private."""
    jcfg, cfg, params, bridged = danube
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    want = _teacher_forced(jcfg, params, prompts, 30)
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW, **DRAIN_MODES[mode])
    assert llm.engine.scheduler.ring_only and not llm.engine.chunked
    got = llm.generate(prompts, SamplingParams(max_tokens=30))
    assert [o.token_ids for o in got] == want
    assert llm.engine.alloc.audit() == {"live_blocks": 0, "free_blocks": 24,
                                        "hash_entries": 0}
    llm.close()


LONG_PROMPTS = {"33": (33,), "40": (40,), "60": (60,),
                "33+short": (33, 7), "40+short": (9, 40),
                "60+short": (60, 5)}


@pytest.mark.parametrize("mode", list(DRAIN_MODES))
@pytest.mark.parametrize("lens", list(LONG_PROMPTS.values()),
                         ids=list(LONG_PROMPTS))
def test_prompt_longer_than_its_ring_matches_teacher_forced_tokens(
        danube, mode, lens):
    """ROADMAP C17: a prompt longer than its 32-slot ring, alone and
    batched with a short one, gives the tokens of teacher forcing over
    the whole prompt.  The ring prefill keeps the last ``cache_len``
    positions itself, so the scheduler must not cut a fresh ring prompt
    to its head (the JAX scheduler does, and then answers the head)."""
    jcfg, cfg, params, bridged = danube
    rng = np.random.default_rng(100 + sum(lens))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    want = _teacher_forced(jcfg, params, prompts, 12)
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW, **DRAIN_MODES[mode])
    got = llm.generate(prompts, SamplingParams(max_tokens=12))
    assert [o.token_ids for o in got] == want
    assert [len(o.prompt_token_ids) for o in got] == list(lens)
    assert llm.engine.metrics["truncated_prompts"] == 0
    assert llm.engine.alloc.audit() == {"live_blocks": 0, "free_blocks": 24,
                                        "hash_entries": 0}
    llm.close()


def test_prompt_longer_than_a_ring_that_is_exactly_the_window():
    """C17 as the ROADMAP states it: window 32 over rings of 2 x 16 = 32
    slots, prompts of 40 and 60 tokens served together with a short one,
    against teacher forcing."""
    jcfg = j_get_reduced(ARCH, **dict(_cfg_kw(), sliding_window=32))
    cfg = get_reduced(ARCH, **dict(_cfg_kw(), sliding_window=32))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    rng = np.random.default_rng(32)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 60, 6)]
    want = _teacher_forced(jcfg, params, prompts, 12)
    llm = LLM(cfg, bridged, device="cpu", **ENGINE_KW,
              enable_async_step=False)
    assert llm.engine.scheduler.cap_tokens == 32 == cfg.sliding_window
    got = llm.generate(prompts, SamplingParams(max_tokens=12))
    assert [o.token_ids for o in got] == want
    assert llm.engine.metrics["truncated_prompts"] == 0
    llm.close()


def test_single_request_drain_matches_jax_engine(danube):
    """One request alone: the JAX engine's ring aliases only onto its own
    first block, which a window of 12 under 16-token blocks survives, so
    the JAX engine is right here and the port gives its tokens."""
    jcfg, cfg, params, bridged = danube
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


def test_ring_drain_with_preemption_keeps_audit_clean(danube):
    """A request poisoned mid-decode is bisected out: the others are
    preempted, replayed (prompt plus output, longer than the ring: never
    clamped) and finish with the teacher-forced tokens; every ring block
    comes back and no block was ever content-addressed."""
    jcfg, cfg, params, bridged = danube
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
    assert eng.alloc.stats["reused"] == 0
    llm.close()


def test_ring_scheduler_owns_whole_private_rows():
    """Under ``ring_only`` admission takes all MB blocks of a row (the
    watermark check asks for that many), shares none even between equal
    prompts, registers none, and ``free`` / requeue return them all."""
    alloc = BlockAllocator(12, 4, watermark_frac=0.0)
    sch = Scheduler(alloc, max_slots=3, max_blocks_per_seq=4, ring_only=True)
    for rid in range(3):
        sch.add(RequestState(rid=rid, prompt=[1, 2, 3, 4, 5]))
    admitted = sch.try_admit()
    assert len(admitted) == 2                       # 12 blocks, watermark 1
    ids = [b for s in admitted for b in s.block_ids]
    assert all(len(s.block_ids) == 4 for s in admitted)
    assert len(set(ids)) == 8 and alloc.stats["reused"] == 0
    for s in admitted:
        sch.register_written(s)
    assert alloc.audit()["hash_entries"] == 0
    s = admitted[0]
    s.req.output = list(range(40))                  # outgrows the 16 slots
    sch.preempt_request(s.req.rid)
    assert alloc.num_free == 8
    again = sch.try_admit()               # the replay heads the queue
    assert [len(x.req.prompt) for x in again] == [45]      # not clamped
    assert alloc.num_free == 4 and len(sch.waiting) == 1
    for x in list(sch.running.values()):
        sch.finish(x, "length")
    assert alloc.audit() == {"live_blocks": 0, "free_blocks": 12,
                             "hash_entries": 0}


def test_int8_ring_is_refused_as_in_the_reference(danube):
    jcfg, cfg, _, bridged = danube
    with pytest.raises(ValueError) as jerr:
        JT.make_decode_state(jcfg, 2, 8, 2, kv_cache_dtype="int8")
    with pytest.raises(ValueError) as err:
        T.make_decode_state(cfg, 2, 8, 2, kv_cache_dtype="int8",
                            device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="sliding-window"):
        LLM(cfg, bridged, device="cpu", kv_cache_dtype="int8", **ENGINE_KW)


def test_sliding_stack_refuses_chunked_prefill(danube):
    """Chunked prefill is quietly off for the engine (as in the reference)
    and refused by name at the model."""
    _, cfg, _, bridged = danube
    llm = LLM(cfg, bridged, device="cpu", enable_chunked_prefill=True,
              **ENGINE_KW)
    assert not llm.engine.chunked and not llm.engine.async_step
    st = T.make_decode_state(cfg, 1, 8, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="whole prompts"):
        T.prefill_chunk(cfg, bridged, cache_from_state(st),
                        torch.zeros((1, 4), dtype=torch.int32),
                        st["block_table"][:1], 0, 4)
    llm.close()
