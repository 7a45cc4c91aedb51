"""The runner's fixed-shape steps as step graphs (``serving/step_graph.py``)
on the CPU, where a "graph" is the recorded step function replayed on the
same static buffers: the bookkeeping that the card's captured CUDA graphs
share.

Greedy drains with graphs on must equal the JAX engine's tokens (danube
and recurrentgemma: the reference's teacher-forced tokens, ROADMAP C11)
and the drains with graphs off, in every mode the card serves; each
variant is captured once (the recompile sentinel's counterpart); the
decode state keeps its storage; a returned output survives later
replays; seeded sampling and the fault injector's poisoned dispatches
give the eager engine's results.  A planted fault (the copy-back of
``seq_lens``, or of recurrentgemma's ``lru_h`` or ``rec_conv``, dropped)
must change the tokens, so the on/off parity can fail.  Models run in
f32 at reduced sizes, so both packages' logits agree to rounding.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.serving import LLM as JLLM
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import SamplingParams as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.serving import (LLM, FaultInjector, FaultSpec,
                                 SamplingParams)
from repro_torch.serving import step_graph
from repro_torch.serving.model_runner import ModelRunner, _Staging
from repro_torch.serving.step_graph import StepGraph


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


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _bridge(arch, **cfg_kw):
    jcfg = j_get_reduced(arch, **cfg_kw)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, get_reduced(arch, **cfg_kw), params, bridged


@pytest.fixture(scope="module")
def dense():
    return _bridge("qwen1.5-0.5b", num_layers=2, num_heads=4, num_kv_heads=2,
                   dtype="float32")


@pytest.fixture(scope="module")
def moe():
    return _bridge("qwen2-moe-a2.7b", dtype="float32")


@pytest.fixture(scope="module")
def danube():
    return _bridge("h2o-danube-3-4b", dtype="float32", num_heads=8,
                   num_kv_heads=2, head_dim=16, sliding_window=12)


@pytest.fixture(scope="module")
def rgemma():
    return _bridge("recurrentgemma-2b", dtype="float32", num_layers=6,
                   sliding_window=12)


DENSE_KW = dict(max_slots=4, num_blocks=128, max_blocks_per_seq=16,
                prefill_bucket=32, max_num_batched_tokens=64)
MOE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
              max_num_batched_tokens=24, prefill_bucket=16)
DANUBE_KW = dict(max_slots=3, num_blocks=24, max_blocks_per_seq=2,
                 prefill_bucket=16)
# mode -> (model, engine options, the step graphs its drain must replay)
MODES = {
    "sync-chunked": ("dense", dict(DENSE_KW, enable_async_step=False),
                     {"unified", "megastep"}),
    "async-chunked": ("dense", DENSE_KW, {"chained"}),
    "whole-prompt": ("dense", dict(DENSE_KW, enable_async_step=False,
                                   enable_chunked_prefill=False),
                     {"megastep"}),
    "int8-chunked": ("dense", dict(DENSE_KW, enable_async_step=False,
                                   kv_cache_dtype="int8"),
                     {"unified", "megastep"}),
    "moe": ("moe", MOE_KW, {"chained"}),
    "danube": ("danube", DANUBE_KW, {"megastep"}),
    "rgemma": ("rgemma", DANUBE_KW, {"megastep"}),
}
# the ring stacks, whose reference is teacher forcing
RINGS = ("danube", "rgemma")


def _prompts(seed, vocab, lens=None):
    rng = np.random.default_rng(seed)
    lens = lens or rng.integers(4, 90, 6)
    ps = [rng.integers(1, min(vocab, 250), int(n)).tolist() for n in lens]
    ps[1][:16] = ps[0][:16] if len(ps[0]) >= 16 and len(ps[1]) >= 16 \
        else ps[1][:16]
    return ps


def _teacher_forced(jcfg, params, prompts, max_tokens):
    """The reference's greedy tokens without its engine (argmax of
    ``JT.forward`` one token at a time): the danube reference, since the
    JAX engine's batched rings alias (ROADMAP C11)."""
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


def _serve(model, kw, prompts, sps, **extra):
    """Tokens and finish reasons of one drain, and the LLM (closed)."""
    _, cfg, _, bridged = model
    llm = LLM(cfg, bridged, device="cpu", **kw, **extra)
    outs = llm.generate(prompts, sps)
    stats = llm.engine.runner.graph_stats()
    assert llm.engine.alloc.audit()["live_blocks"] == 0
    llm.close()
    return [(o.token_ids, o.finish_reason) for o in outs], stats, llm


@pytest.mark.parametrize("mode", list(MODES))
def test_graphed_drain_equals_reference_and_eager(mode, request):
    name, kw, kinds = MODES[mode]
    model = request.getfixturevalue(name)
    jcfg, cfg, params, _ = model
    if name in RINGS:
        prompts = _prompts(3, cfg.vocab_size, lens=(5, 9, 20))
        mts = (30, 30, 30)
    else:
        prompts = _prompts(0, cfg.vocab_size)[:5 if name == "moe" else 6]
        mts = (10, 6, 12, 4, 8, 9)[:len(prompts)]
    sps = [SamplingParams(max_tokens=m) for m in mts]
    got, stats, _ = _serve(model, kw, prompts, sps)
    eager, off, _ = _serve(model, kw, prompts, sps, capture_graphs=False)
    assert got == eager
    assert off == {}                        # graphs off: nothing captured
    if name in RINGS:
        want = _teacher_forced(jcfg, params, prompts, 30)
        assert [t for t, _ in got] == want
    else:
        jouts = JLLM(jcfg, params, **kw).generate(
            prompts, [JSP(max_tokens=m) for m in mts])
        assert got == [(o.token_ids, o.finish_reason) for o in jouts]
    assert kinds <= {k for k, s in stats.items() if s["replays"] > 0}, stats
    for k, s in stats.items():              # one capture per variant
        assert s["captures"] == len(s["variants"]) > 0, (k, s)


def test_each_variant_is_captured_once_after_warmup(dense):
    """The recompile sentinel's counterpart: a second drain of the same
    traffic replays what the first captured and captures nothing."""
    _, cfg, _, bridged = dense
    llm = LLM(cfg, bridged, device="cpu", **DENSE_KW)
    prompts = _prompts(0, cfg.vocab_size)
    sps = SamplingParams(max_tokens=8)
    first = [o.token_ids for o in llm.generate(prompts, sps)]
    runner = llm.engine.runner
    warm = {k: (g.captures, set(g.variants), g.replays)
            for k, g in runner.graphs.items()}
    again = [o.token_ids for o in llm.generate(prompts, sps)]
    assert again == first
    for k, g in runner.graphs.items():
        captures, variants, replays = warm[k]
        assert (g.captures, set(g.variants)) == (captures, variants), k
        assert g.replays > replays, k
    llm.close()
    assert runner.graphs == {}              # close released them


def test_state_keeps_its_storage_across_steps(dense):
    """Every decode-state entry is the same tensor at the same address
    from the first step to the last: tables are copied in, ``seq_lens +
    active`` is copied back."""
    _, cfg, _, bridged = dense
    for kv in ("bf16", "int8"):
        llm = LLM(cfg, bridged, device="cpu", kv_cache_dtype=kv, **DENSE_KW)
        eng = llm.engine
        st = eng.runner.state
        ptrs = {k: (t, t.data_ptr()) for k, t in st.items()}
        for p in _prompts(1, cfg.vocab_size):
            eng.add(p, SamplingParams(max_tokens=9))
        steps = 0
        while eng._work_pending():
            eng.step()
            steps += 1
            assert eng.runner.state is st
            for k, (t, ptr) in ptrs.items():
                assert st[k] is t and t.data_ptr() == ptr, (kv, k, steps)
        assert steps > 10 and eng.runner.graphs
        llm.close()


def test_chained_output_survives_later_replays(dense):
    """A chained step's returned buffer is a fresh copy: it keeps its
    tokens through the next replays, which read it as their feed, and
    every output equals the eager runner's on the same inputs."""
    _, cfg, _, bridged = dense
    B, W = 4, 16
    rows = {"keys": np.zeros((B + 1, 2), np.uint32),
            "counts": np.zeros(B + 1, np.int32),
            "temps": np.zeros(B + 1, np.float32),
            "top_ks": np.zeros(B + 1, np.int32),
            "top_ps": np.ones(B + 1, np.float32)}
    active = np.array([True, False, True, False])
    prompt = list(range(5, 45))
    outs = {}
    for graphs in (True, False):
        seqs = {0: types.SimpleNamespace(block_ids=[1, 2], seq_len=20),
                2: types.SimpleNamespace(block_ids=[3], seq_len=7)}
        r = ModelRunner(cfg, bridged, max_slots=B, num_blocks=16,
                        max_blocks_per_seq=4, chunk_tokens=W,
                        capture_graphs=graphs)
        prev, got = None, []
        for i in range(4):
            for s in seqs.values():
                s.seq_len += 1
            r.sync_tables(seqs)
            use_prev = np.array([i > 0, False, i > 0, False])
            chain_idx = np.array([0, 0, 4 if i % 2 else 2, 0], np.int32)
            toks = np.array([7 + i, 0, 9, 0], np.int32)
            out = r.unified_step_chained(prev, chain_idx, use_prev, toks,
                                         rows, active, prompt, [5, 6, 7],
                                         W * (i % 2), W)
            got.append((out, out.clone()))
            prev = out
        for out, kept in got:
            assert torch.equal(out, kept)
        outs[graphs] = [kept for _, kept in got]
        if graphs:
            assert r.graphs["chained"].replays == 3
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))


def test_seeded_sampling_equals_eager_and_captures_each_plan(dense):
    """Greedy rows beside seeded temperature, top-k and top-p rows; the
    greedy requests outlive the sampled ones, so the drain runs all-greedy
    steps too: both ``sampling_plan`` branches are captured, and the
    tokens are the eager engine's (and the JAX engine's)."""
    jcfg, cfg, params, _ = dense
    prompts = _prompts(4, cfg.vocab_size)

    def sps(SP):
        return [SP(max_tokens=14), SP(max_tokens=16),
                SP(max_tokens=5, temperature=0.9, seed=1),
                SP(max_tokens=6, temperature=0.7, top_k=8, seed=2),
                SP(max_tokens=4, temperature=1.1, top_p=0.8, seed=3),
                SP(max_tokens=12)]

    for kw in (DENSE_KW, dict(DENSE_KW, enable_async_step=False)):
        got, stats, _ = _serve(dense, kw, prompts, sps(SamplingParams))
        eager, _, _ = _serve(dense, kw, prompts, sps(SamplingParams),
                             capture_graphs=False)
        assert got == eager
        jouts = JLLM(jcfg, params, **kw).generate(prompts, sps(JSP))
        assert got == [(o.token_ids, o.finish_reason) for o in jouts]
        plans = {tuple(v[:2]) for s in stats.values() for v in s["variants"]}
        assert (False, False) in plans and (True, True) in plans, stats


FAULTS = [("dispatch", dict(step=1, rid=2)),    # poisoned, bisected
          ("dispatch", dict(step=5, count=1)),  # transient, retried
          ("nan", dict(step=2, rid=1)),         # a NaN row: the guard
          ("nan", dict(step=6, rid=4))]


@pytest.mark.parametrize("kw", [DENSE_KW,
                                dict(DENSE_KW, enable_async_step=False)],
                         ids=["async", "sync"])
def test_poisoned_dispatches_replay_without_recapture(dense, kw):
    """The fault scenarios of ``tests/test_torch_faults.py`` with graphs
    on: the same tokens, finish reasons and recovery counters as graphs
    off and the JAX engine.  A retry or a bisection re-stages and
    replays; the poison row is a variant of its own, captured once."""
    jcfg, cfg, params, bridged = dense
    prompts = _prompts(2, cfg.vocab_size, lens=(30, 12, 50, 9, 70, 25))
    results, metrics = {}, {}
    for graphs in (True, False):
        llm = LLM(cfg, bridged, device="cpu", capture_graphs=graphs,
                  fault_injector=FaultInjector(
                      [FaultSpec(s, **a) for s, a in FAULTS]), **kw)
        outs = llm.generate(prompts, SamplingParams(max_tokens=10))
        results[graphs] = [(o.token_ids, o.finish_reason) for o in outs]
        eng = llm.engine
        metrics[graphs] = {k: eng.metrics[k] for k in
                           ("dispatch_retries", "quarantined")}
        if graphs:
            stats = eng.runner.graph_stats()
        llm.close()
    jllm = JLLM(jcfg, params, fault_injector=JFaultInjector(
        [JFaultSpec(s, **a) for s, a in FAULTS]), **kw)
    jouts = jllm.generate(prompts, JSP(max_tokens=10))
    assert results[True] == results[False] \
        == [(o.token_ids, o.finish_reason) for o in jouts]
    assert metrics[True] == metrics[False] == {
        k: jllm.engine.metrics[k] for k in metrics[True]}
    assert metrics[True]["dispatch_retries"] > 0
    assert "error" in {r for _, r in results[True]}
    assert any(v[3] for s in stats.values() for v in s["variants"]), stats
    for s in stats.values():
        assert s["captures"] == len(s["variants"])


def test_planted_copy_back_fault_changes_the_tokens(dense, monkeypatch):
    """With the copy-back of ``seq_lens`` into the static state dropped,
    a megastep's later decode steps read stale lengths: the graphed
    drain must depart from the eager one, or the parity check above
    could not fail."""
    _, cfg, _, _ = dense
    kw = dict(DENSE_KW, enable_async_step=False)
    prompts = _prompts(0, cfg.vocab_size)
    sps = SamplingParams(max_tokens=12)
    eager, _, _ = _serve(dense, kw, prompts, sps, capture_graphs=False)
    sound, _, _ = _serve(dense, kw, prompts, sps)
    assert sound == eager
    real = step_graph.copy_back
    monkeypatch.setattr(step_graph, "copy_back", lambda state, new: real(
        state, {k: v for k, v in new.items() if k != "seq_lens"}))
    broken, _, _ = _serve(dense, kw, prompts, sps)
    assert broken != eager


@pytest.fixture(scope="module")
def rgemma_memory():
    """recurrentgemma on the port's own seeded init (repeatable in every
    process, unlike the reference's, ROADMAP C12), its RG-LRU decay set
    to a ~ 0.9 a step, so the state carries ~10 steps back: the init's
    decay, a ~ exp(-5), forgets a token within a step, and a stale state
    then changes no greedy token."""
    from repro_torch.models import transformer as T
    cfg = get_reduced("recurrentgemma-2b", dtype="float32", num_layers=6,
                      sliding_window=12)
    params = T.init_params(cfg, 0, device="cpu")
    params["rec_layers"]["rec"]["a_param"].fill_(-3.6)
    return None, cfg, None, params


@pytest.mark.parametrize("key", ["lru_h", "rec_conv"])
def test_planted_recurrent_copy_back_fault_changes_the_tokens(
        rgemma_memory, monkeypatch, key):
    """recurrentgemma's per-slot recurrent state comes back from each
    decode step as a new tensor: with its copy-back into the static state
    dropped, a replay reads the state its capture left, and the graphed
    drain must depart from the eager one."""
    model = rgemma_memory
    prompts = _prompts(3, model[1].vocab_size, lens=(5, 9, 20))
    sps = SamplingParams(max_tokens=20)
    eager, _, _ = _serve(model, DANUBE_KW, prompts, sps,
                         capture_graphs=False)
    sound, _, _ = _serve(model, DANUBE_KW, prompts, sps)
    assert sound == eager
    real = step_graph.copy_back
    monkeypatch.setattr(step_graph, "copy_back", lambda state, new: real(
        state, {k: v for k, v in new.items() if k != key}))
    broken, _, _ = _serve(model, DANUBE_KW, prompts, sps)
    assert broken != eager


class _Counter:
    def __init__(self, name):
        self.name, self.launches = name, 0


def test_replay_adds_the_launches_its_capture_recorded():
    """The launch accounting: a capture records each counter's delta (on
    the CPU a replay's function counts for itself, as its capture did),
    and a replay that counts otherwise than its capture raises.  Static
    inputs keep their fixed shapes; every run returns a fresh tensor."""
    a, b = _Counter("a"), _Counter("b")
    acc = torch.zeros(4, dtype=torch.int32)
    path = {"extra": 0}

    def body(key):
        inp = g.inputs()
        a.launches += 2 if key else 1
        b.launches += path["extra"]
        acc.add_(inp["x"] * inp["on"])
        return acc * 2

    g = StepGraph("toy", {"x": ((4,), np.int32), "on": ((), np.bool_)},
                  torch.device("cpu"), body, counters=[a, b])
    staging = _Staging(torch.device("cpu"))
    g.stage(staging, {"x": np.arange(4), "on": True})
    first = g.run(True)
    assert (a.launches, g.captures, g.replays) == (2, 1, 0)
    assert g.variants[True].launches == [2, 0]      # per counter
    outs = [g.run(True) for _ in range(3)]
    assert (a.launches, b.launches, g.captures, g.replays) == (8, 0, 1, 3)
    assert torch.equal(first, torch.tensor([0, 2, 4, 6], dtype=torch.int32))
    assert torch.equal(outs[-1], 8 * torch.arange(4, dtype=torch.int32))
    g.stage(staging, {"x": np.ones(4, np.int32)})       # "on" left 0
    g.run(False)
    assert (a.launches, g.captures) == (9, 2)
    assert torch.equal(acc, 4 * torch.arange(4, dtype=torch.int32))
    path["extra"] = 1                   # a host branch outside the key
    with pytest.raises(RuntimeError, match="replay launched"):
        g.run(True)
    with pytest.raises(ValueError, match="static input"):
        g.stage(staging, {"x": np.arange(5)})
    with pytest.raises(KeyError):
        g.stage(staging, {"y": np.arange(4)})
