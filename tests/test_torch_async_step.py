"""The port's async pipelined engine on the CPU: the counterparts of the
engine and detokenize-worker cases of ``tests/test_async_step.py``.

The pipelined loop (``enable_async_step=True``, the default) must be
token-exact against the port's read-back-every-step engine and against
the JAX package's async engine on the same bridged weights, with greedy
and seeded top-k rows, on the bf16 and int8 pools; also under seeded
faults with a poisoned in-flight dispatch, through an abort while a
request's next token is in flight, and through ``close()``.  The model
runs in f32 so that the two packages' logits agree to rounding and no
near-tie flips a sampled token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.serving import SamplingParams as JSP
from repro.serving import ServingEngine as JEngine
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.faults import FaultSpec as JFaultSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving import (FaultInjector, FaultSpec, SamplingParams,
                                 ServingEngine)
from repro_torch.serving.detok import DetokWorker
from repro_torch.serving.scheduler import RequestState


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

CFG_KW = dict(num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32")
ENGINE_KW = dict(max_slots=4, num_blocks=128, max_blocks_per_seq=16,
                 prefill_bucket=32, max_num_batched_tokens=64)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_reduced("qwen1.5-0.5b", **CFG_KW)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, params, get_reduced("qwen1.5-0.5b", **CFG_KW), bridged


def _engine(tiny, **kw):
    _, _, cfg, params = tiny
    return ServingEngine(cfg, params, device="cpu", **ENGINE_KW, **kw)


def _jengine(tiny, **kw):
    jcfg, params, _, _ = tiny
    return JEngine(jcfg, params, **ENGINE_KW, **kw)


def _drain(eng, prompts, sps):
    rids = [eng.add(p, sp) for p, sp in zip(prompts, sps)]
    finals = {}
    for out in eng.stream():
        if out.finished:
            finals[out.request_id] = out
    return {r: (tuple(finals[r].token_ids), finals[r].finish_reason)
            for r in rids}


def _prompts(seed, n=6):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 200, int(k)))
            for k in rng.integers(4, 90, n)]


def _sps(SP):
    return [SP(max_tokens=10)] * 3 \
        + [SP(max_tokens=10, temperature=0.8, top_k=20, seed=i)
           for i in range(3)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_async_token_exact_vs_sync_and_jax(tiny, kv):
    prompts, prompts2 = _prompts(0), _prompts(7)
    with _engine(tiny, kv_cache_dtype=kv) as a:
        got = _drain(a, prompts, _sps(SamplingParams))
        got2 = _drain(a, prompts2, _sps(SamplingParams))
        assert a.alloc.audit()["live_blocks"] == 0
    with _engine(tiny, kv_cache_dtype=kv, enable_async_step=False) as s:
        want = _drain(s, prompts, _sps(SamplingParams))
        want2 = _drain(s, prompts2, _sps(SamplingParams))
        assert s.report()["async_steps"] == 0
    with _jengine(tiny, kv_cache_dtype=kv) as j:
        jwant = _drain(j, prompts, _sps(JSP))
        jwant2 = _drain(j, prompts2, _sps(JSP))
    assert got == want and got2 == want2
    assert got == jwant and got2 == jwant2
    # the pipeline engaged, on the reference's schedule
    assert 0 < a.metrics["async_steps"] == j.metrics["async_steps"]


def test_async_parity_under_poisoned_in_flight_dispatch(tiny):
    prompts = _prompts(2, n=8)

    def specs(Spec):
        return [Spec("dispatch", step=1, rid=2),    # poisoned early
                Spec("dispatch", step=5, rid=5),    # poisoned mid-pipe
                Spec("dispatch", step=7, count=1),  # transient
                Spec("nan", step=2, rid=1),         # in-flight NaN row
                Spec("nan", step=5, rid=4),
                Spec("alloc", step=6, count=2)]

    results = {}
    for mode in (True, False):
        with _engine(tiny, enable_async_step=mode,
                     fault_injector=FaultInjector(specs(FaultSpec))) as eng:
            results[mode] = _drain(eng, prompts,
                                   [SamplingParams(max_tokens=10)] * 8)
            assert eng.alloc.audit()["live_blocks"] == 0
    with _jengine(tiny,
                  fault_injector=JFaultInjector(specs(JFaultSpec))) as j:
        jres = _drain(j, prompts, [JSP(max_tokens=10)] * 8)
    assert results[True] == results[False] == jres
    reasons = {r for _, r in results[True].values()}
    assert "error" in reasons               # the poison really fired


def test_async_abort_mid_flight_token_exact(tiny):
    """Abort rid 1 while its next token is in flight (speculated): that
    token is discarded, the final event carries exactly the absorbed
    prefix, and every other request matches the unaborted sync run."""
    prompts = _prompts(2, n=8)
    sp = SamplingParams(max_tokens=12)
    with _engine(tiny, enable_async_step=False) as s:
        want = _drain(s, prompts, [sp] * 8)

    eng = _engine(tiny)
    rids = [eng.add(p, sp) for p in prompts]
    outs, aborted_len = [], None
    while eng._work_pending():
        outs.extend(eng.step())
        if aborted_len is None:
            seq = next((q for q in eng.scheduler.running.values()
                        if q.req.rid == rids[1]), None)
            if seq is not None and seq.speculated \
                    and len(seq.req.output) >= 1:
                aborted_len = len(seq.req.output)   # in-flight tok NOT here
                assert eng.abort(rids[1])
    finals = {o.request_id: o for o in outs if o.finished}
    assert aborted_len is not None, "never caught rid 1 mid-flight"
    assert finals[rids[1]].finish_reason == "aborted"
    assert tuple(finals[rids[1]].token_ids) == \
        want[rids[1]][0][:aborted_len]
    for r in rids:
        if r != rids[1]:
            assert (tuple(finals[r].token_ids),
                    finals[r].finish_reason) == want[r]
    assert eng.alloc.audit()["live_blocks"] == 0
    eng.close()


def test_close_is_idempotent_and_flushes(tiny):
    eng = _engine(tiny)
    for p in _prompts(4, n=3):
        eng.add(p, SamplingParams(max_tokens=4))
    for _ in range(8):                       # leave work in flight
        eng.step()
        if eng._flight is not None:
            break
    assert eng._flight is not None
    outs = eng.close()
    assert eng._flight is None and eng._detok is None
    assert all(hasattr(o, "request_id") for o in outs)
    assert eng.close() == []                 # idempotent
    assert eng.alloc.audit()["free_blocks"] >= 0


def test_detok_worker_fifo_and_collect_discipline():
    w = DetokWorker(lambda toks: "".join(chr(97 + t % 26) for t in toks),
                    NULL_TRACER)
    reqs = [RequestState(rid=i, prompt=[1]) for i in range(3)]
    for i, r in enumerate(reqs):
        r.output = [i, i + 1]
        w.submit(r, [i, i + 1], False, None)
    assert w.pending() == 3
    first = w.collect_upto(2)
    assert [o.request_id for o in first] == [0, 1]     # FIFO, exactly 2
    rest = w.collect_all()
    assert [o.request_id for o in rest] == [2]
    assert w.pending() == 0 and w.collect_upto(5) == []
    assert reqs[0].text == first[0].text != ""
    w.close()
    assert not w._thread.is_alive()


def test_detok_worker_exception_propagates():
    def boom(_toks):
        raise ValueError("bad detokenizer")

    w = DetokWorker(boom, NULL_TRACER)
    r = RequestState(rid=0, prompt=[1])
    r.output = [5]
    w.submit(r, [5], False, None)
    with pytest.raises(ValueError, match="bad detokenizer"):
        w.collect_upto(1)
