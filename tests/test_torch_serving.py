"""The port's serving stack against the JAX package on the CPU: identical
scheduler plans over a seeded arrival trace, greedy ``LLM`` drains
token-exact against the JAX engine (both ``enable_async_step=False``) on
the same bridged params — chunked or whole-prompt prefill, bf16 or int8 KV
pool (int8 compared with int8 only) — copy-on-write on the device pools,
and a clean allocator audit after every drain."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.paged_cache import BlockAllocator as JAlloc
from repro.models import transformer as JT
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro.serving.scheduler import RequestState as JReq
from repro.serving.scheduler import Scheduler as JSched
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.core.paged_cache import BlockAllocator
from repro_torch.serving import LLM, SamplingParams
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

CFG_KW = dict(num_heads=12, num_kv_heads=2, dtype="float32")
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24)


def _plan_key(plan):
    return (tuple(plan.decode_slots), plan.horizon, tuple(plan.cow_pairs),
            tuple((c.seq.slot, c.seq.req.rid, c.start, c.length)
                  for c in plan.prefill))


def test_plan_step_plans_identical_over_seeded_trace():
    """Both schedulers see the same arrivals and the same fake sampled
    tokens; every plan (decode slots, horizon, CoW pairs, chunks) and the
    final allocator state must agree."""
    rng = np.random.default_rng(7)
    scheds = []
    for Alloc, Sched in ((JAlloc, JSched), (BlockAllocator, Scheduler)):
        scheds.append(Sched(Alloc(40, 4), max_slots=3, max_blocks_per_seq=10,
                            metrics={"preemptions": 0,
                                     "truncated_prompts": 0}))
    reqs = {0: JReq, 1: RequestState}
    shared = list(rng.integers(1, 100, 8))
    trace = []
    for step in range(40):
        arrivals = []
        if step % 3 == 0 and step < 30:
            n = int(rng.integers(3, 30))
            p = list(rng.integers(1, 100, n))
            if step % 2 == 0:
                p = shared + p                     # shared prefix
            arrivals.append((p, int(rng.integers(2, 9))))
        trace.append((arrivals, int(rng.integers(0, 100))))
    rid = 0
    for arrivals, tok in trace:
        keys = []
        for i, s in enumerate(scheds):
            for j, (p, mt) in enumerate(arrivals):
                sp = (JSP if i == 0 else SamplingParams)(max_tokens=mt)
                s.add(reqs[i](rid=rid + j, prompt=list(p), sampling=sp,
                              arrival=float(rid + j + 1)))
            s.finish_at_capacity()
            plan = s.plan_step(12, max_horizon=4)
            keys.append(_plan_key(plan))
            for c in plan.prefill:
                s.complete_chunk(c)
            for slot in plan.decode_slots:
                seq = s.running[slot]
                for _ in range(plan.horizon):
                    seq.req.output.append(tok)
                    seq.seq_len += 1
                    if seq.req.tokens_remaining() <= 0:
                        s.finish(seq, "length")
                        break
            for c in plan.prefill:
                if c.last and c.seq.slot in s.running:
                    c.seq.req.output.append(tok)
                    c.seq.seq_len += 1
                    if c.seq.req.tokens_remaining() <= 0:
                        s.finish(c.seq, "length")
        rid += len(arrivals)
        assert keys[0] == keys[1]
    assert scheds[0].alloc.audit() == scheds[1].alloc.audit()
    assert scheds[0].alloc.stats == scheds[1].alloc.stats
    assert scheds[1].alloc.stats["reused"] > 0


@pytest.fixture(scope="module")
def small():
    jcfg = j_get_reduced("qwen2-1.5b", **CFG_KW)
    cfg = get_reduced("qwen2-1.5b", **CFG_KW)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params


def _prompts():
    rng = np.random.default_rng(8)
    ps = [list(rng.integers(1, 250, n)) for n in (30, 45, 12, 70, 20)]
    ps[1][:32] = ps[0][:32]                 # two full shared blocks
    ps[4][:16] = ps[0][:16]
    return ps


def _drain_both(params, jcfg, cfg, prompts, max_tokens, **kw):
    """The same greedy requests through the JAX engine and the port's,
    both synchronous; returns (port LLM, JAX LLM, port outputs, JAX
    outputs)."""
    jllm = JLLM(jcfg, params, enable_async_step=False, **kw)
    want = jllm.generate(prompts, [JSP(max_tokens=m) for m in max_tokens])
    llm = LLM(cfg, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu"),
              device="cpu", enable_async_step=False, **kw)
    got = llm.generate(prompts, [SamplingParams(max_tokens=m)
                                 for m in max_tokens])
    return llm, jllm, got, want


@pytest.mark.parametrize("quant,kv,chunked", [
    (None, "bf16", True), ("rtn-int4", "bf16", True),
    ("rtn-int4", "int8", True), ("rtn-int4", "bf16", False),
    ("rtn-int4", "int8", False)],
    ids=["None", "rtn-int4", "rtn-int4-int8", "rtn-int4-whole",
         "rtn-int4-int8-whole"])
def test_llm_greedy_drain_token_exact_vs_jax(small, quant, kv, chunked):
    """Chunked mode runs multi-chunk prompts through unified dispatches;
    whole-prompt mode (``enable_chunked_prefill=False``) runs waves
    padded to ``prefill_bucket`` through ``T.prefill``, then megasteps."""
    jcfg, cfg, params = small
    if quant == "rtn-int4":
        params = j_rtn(params, jcfg, group_size=32)
    prompts = _prompts()
    llm, jllm, got, want = _drain_both(
        params, jcfg, cfg, prompts, (10, 6, 12, 4, 8), kv_cache_dtype=kv,
        enable_chunked_prefill=chunked, prefill_bucket=16, **ENGINE_KW)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    eng = llm.engine
    if chunked:
        assert eng.metrics["prefill_chunks"] > len(prompts)  # multi-chunk
    else:
        assert eng.metrics["prefill_chunks"] == 0
    assert eng.alloc.stats == jllm.engine.alloc.stats
    assert eng.alloc.stats["reused"] > 0                     # prefix reuse
    assert eng.alloc.audit() == {"live_blocks": 0, "free_blocks": 48,
                                 "hash_entries": 0}
    rep = eng.report()
    assert rep["device_dispatches"] == jllm.engine.metrics[
        "device_dispatches"]
    assert rep["decode_steps"] == jllm.engine.metrics["decode_steps"]
    assert rep["kv_pool_bytes"] == jllm.engine.runner.kv_pool_bytes()


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_llm_int8_block_starved_drain_with_preemptions(small, chunked):
    """A 9-block int8 pool: decode growth preempts sequences, which are
    recomputed into fresh blocks (new scales); tokens, preemptions and
    allocator stats still match the JAX engine's."""
    jcfg, cfg, params = small
    params = j_rtn(params, jcfg, group_size=32)
    rng = np.random.default_rng(51)
    prompts = [list(rng.integers(1, 200, n)) for n in (28, 28, 40)]
    llm, jllm, got, want = _drain_both(
        params, jcfg, cfg, prompts, (24, 24, 24), kv_cache_dtype="int8",
        enable_chunked_prefill=chunked, prefill_bucket=16, max_slots=3,
        num_blocks=9, max_blocks_per_seq=8, max_num_batched_tokens=8)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert llm.engine.metrics["preemptions"] > 0
    assert llm.engine.metrics["preemptions"] == \
        jllm.engine.metrics["preemptions"]
    assert llm.engine.alloc.stats == jllm.engine.alloc.stats
    assert llm.engine.alloc.audit()["live_blocks"] == 0


def test_copy_on_write_forked_tail(small):
    """A forked sequence's shared partial tail is copied on the device
    before its first divergent write (the engine's CoW path)."""
    _, cfg, params = small
    llm = LLM(cfg, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu"),
              device="cpu", **ENGINE_KW)
    eng = llm.engine
    [out] = llm.generate([list(range(1, 21))], SamplingParams(max_tokens=1))
    assert out.finish_reason == "length"
    alloc, runner = eng.alloc, eng.runner
    ids, _ = alloc.allocate_prompt(list(range(1, 7)), register=False)
    runner.state["k_pool"][:, ids[-1]] = 1.5
    fork = alloc.fork_sequence(ids)
    grown, cow = alloc.grow(fork, 6, 1)
    assert cow is not None and cow[0] == ids[-1]
    before = runner.dispatches
    runner.copy_cow([cow])
    assert runner.dispatches == before + 1
    assert torch.equal(runner.state["k_pool"][:, cow[1]],
                       runner.state["k_pool"][:, cow[0]])
    alloc.free_sequence(grown)
    alloc.free_sequence(ids)
    assert alloc.audit()["live_blocks"] == 0


def test_abort_mid_prefill_frees_blocks(small):
    _, cfg, params = small
    llm = LLM(cfg, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu"),
              device="cpu", **ENGINE_KW)
    eng = llm.engine
    rid = eng.add(list(range(1, 60)), SamplingParams(max_tokens=4))
    eng.step()                                 # first chunk only
    assert eng.alloc.audit()["live_blocks"] > 0
    assert eng.abort(rid)
    outs = eng.step()
    assert [o.finish_reason for o in outs] == ["aborted"]
    assert eng.alloc.audit()["live_blocks"] == 0
