"""The port's serving fault tolerance on the CPU: the scenarios of
``tests/test_faults.py`` run on ``repro_torch``, in the unified and
two-call modes and on both pools.

Every scenario keeps the reference's own contract (the engine drains,
quarantined requests finish with "error", every other greedy request is
token-exact against a fault-free run, the allocator audits clean); where
the reference compares two runs, the port's faulty run is also held to
the JAX engine's under the same fault schedule on the same bridged
weights: the same tokens, finish reasons and recovery counters.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import SamplingParams as JSP
from repro.serving import ServingEngine as JEngine
from repro.serving import random_schedule as j_random_schedule
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.serving import (EngineOverloadedError, FaultInjector,
                                 FaultSpec, SamplingParams, ServingEngine,
                                 TransientDeviceError, random_schedule)

CFG_KW = dict(num_layers=2, dtype="float32")
MODES = [
    pytest.param({}, id="unified"),
    pytest.param({"enable_unified_step": False}, id="two-call"),
]
POOLS = ["bf16", "int8"]
ENGINE_KW = dict(max_slots=2, num_blocks=64, max_blocks_per_seq=8,
                 max_num_batched_tokens=8)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file's steps on one torch intra-op thread.  The watchdog
    scenario times work steps of a tiny model (~10 ms each alone); with
    torch's default of one thread per core in each of several test
    processes on the same cores, every small op waits at a barrier for
    threads the other processes hold, and the steps take 0.7-2.7 s, so a
    0.4 s stall no longer exceeds 3x their average.  One thread keeps
    the steps near 10 ms under that load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    jcfg = j_get_reduced("qwen2-1.5b", **CFG_KW)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, params, get_reduced("qwen2-1.5b", **CFG_KW), bridged


def _mk(small, **kw):
    _, _, cfg, params = small
    return ServingEngine(cfg, params, device="cpu", **{**ENGINE_KW, **kw})


def _jmk(small, **kw):
    jcfg, params, _, _ = small
    return JEngine(jcfg, params, **{**ENGINE_KW, **kw})


def _prompts(n, seed=0, lo=3, hi=15):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 200, int(rng.integers(lo, hi))))
            for _ in range(n)]


def _drain(eng, prompts, max_tokens=5, max_steps=500, SP=SamplingParams):
    for p in prompts:
        eng.add(p, SP(max_tokens=max_tokens))
    eng.run_until_done(max_steps=max_steps)
    assert not eng.scheduler.has_work(), "engine failed to drain"
    return {r.rid: r for r in eng.finished}


def _outputs(fin):
    return {r: (list(v.output), v.finish_reason) for r, v in fin.items()}


def _vs_jax(small, eng, got, prompts, specs, **kw):
    """The JAX engine under the same fault schedule: same tokens, finish
    reasons and recovery counters as the port's run."""
    jeng = _jmk(small, fault_injector=JFaultInjector(specs), **kw)
    want = _drain(jeng, prompts, SP=JSP)
    jeng.close()
    assert _outputs(got) == _outputs(want)
    for k in ("dispatch_retries", "quarantined", "preemptions"):
        assert eng.metrics[k] == jeng.metrics[k], k


# --------------------------------------------------------------- injector
def test_fault_spec_validates_site():
    with pytest.raises(ValueError):
        FaultSpec("gamma-ray", step=0)


def test_injector_arming_counts_and_forgive():
    fi = FaultInjector([FaultSpec("dispatch", step=1, count=2),
                        FaultSpec("dispatch", step=0, rid=7),
                        FaultSpec("alloc", step=0)])
    fi.step_begin()                                  # step 0
    assert fi.alloc_blocked() and not fi.alloc_blocked()  # count=1 clears
    with pytest.raises(TransientDeviceError):
        fi.check_dispatch([7, 8])                    # rid-targeted fires
    fi.check_dispatch([8])                           # rid 7 absent: clean
    with pytest.raises(TransientDeviceError):
        fi.check_dispatch([7])                       # persistent until forgive
    fi.forgive(7)
    fi.check_dispatch([7])                           # quarantined: clean
    fi.step_begin()                                  # step 1: transient arms
    for _ in range(2):
        with pytest.raises(TransientDeviceError):
            fi.check_dispatch([1])
    fi.check_dispatch([1])                           # count=2 exhausted
    assert [f["site"] for f in fi.fired] == \
        ["alloc", "dispatch", "dispatch", "dispatch", "dispatch"]


def test_injector_nan_waits_for_target():
    fi = FaultInjector([FaultSpec("nan", step=0, rid=3)])
    fi.step_begin()
    assert fi.nan_rids([0, 1]) == set()              # victim absent: armed
    assert fi.nan_rids([1, 3]) == {3}                # fires
    assert fi.nan_rids([1, 3]) == set()              # count=1: cleared


def test_random_schedule_is_deterministic_and_the_references():
    kw = dict(p_dispatch=0.3, p_nan=0.2, p_alloc=0.2, rids=[1, 2, 3])
    a = random_schedule(5, 40, **kw)
    assert a == random_schedule(5, 40, **kw) and len(a) > 0
    assert a != random_schedule(6, 40, **kw)
    assert [vars(s) for s in a] == [vars(s)
                                    for s in j_random_schedule(5, 40, **kw)]


# ------------------------------------------------------- lifecycle control
@pytest.mark.parametrize("pool", POOLS)
def test_abort_releases_blocks_at_every_stage(small, pool):
    eng = _mk(small, kv_cache_dtype=pool)
    rng = np.random.default_rng(3)
    long = list(rng.integers(1, 200, 30))            # chunks over many steps
    r_chunk = eng.add(long, SamplingParams(max_tokens=4))
    r_decode = eng.add(list(rng.integers(1, 200, 6)),
                       SamplingParams(max_tokens=32))
    r_wait = eng.add(list(rng.integers(1, 200, 6)),
                     SamplingParams(max_tokens=8))
    assert eng.abort(r_wait)                         # still waiting
    eng.step()                                       # r_chunk now mid-prefill
    assert any(s.prefilling for s in eng.running.values())
    assert eng.abort(r_chunk)                        # mid-prefill chunk walk
    for _ in range(2):
        eng.step()
    assert eng.abort(r_decode)                       # decoding
    eng.run_until_done()
    reasons = {r.rid: r.finish_reason for r in eng.finished}
    assert reasons == {r_wait: "aborted", r_chunk: "aborted",
                       r_decode: "aborted"}
    audit = eng.alloc.audit()                        # raises on leak
    assert audit["live_blocks"] == 0 and audit["hash_entries"] == 0
    assert not eng.abort(r_decode)                   # already finished
    assert not eng.abort(999)                        # unknown
    eng.close()


@pytest.mark.parametrize("pool", POOLS)
def test_mid_prefill_finish_leaves_no_stale_prefix(small, pool):
    """Killing a request mid-prefill leaves no hash entries over blocks
    whose write never happened: the same prompt again gives a fresh
    engine's tokens, and the JAX engine's."""
    eng = _mk(small, kv_cache_dtype=pool, num_blocks=32)
    prompt = list(np.random.default_rng(9).integers(1, 200, 24))
    rid = eng.add(prompt, SamplingParams(max_tokens=3))
    eng.step()                                       # first chunk only
    assert any(s.prefilling for s in eng.running.values())
    assert eng.abort(rid)
    audit = eng.alloc.audit()
    assert audit["live_blocks"] == 0 and audit["hash_entries"] == 0
    rid2 = eng.add(prompt, SamplingParams(max_tokens=3))
    eng.run_until_done()
    out = {r.rid: r for r in eng.finished}[rid2]
    fresh = list(_drain(_mk(small, kv_cache_dtype=pool, num_blocks=32),
                        [prompt], max_tokens=3).values())[0]
    jfresh = list(_drain(_jmk(small, kv_cache_dtype=pool, num_blocks=32),
                         [prompt], max_tokens=3, SP=JSP).values())[0]
    assert list(out.output) == list(fresh.output) == list(jfresh.output)
    eng.close()


def test_deadline_total_and_ttft(small):
    eng = _mk(small)
    rng = np.random.default_rng(4)
    r_dead = eng.add(list(rng.integers(1, 200, 6)),
                     SamplingParams(max_tokens=100000, deadline_ms=200))
    r_ok = eng.add(list(rng.integers(1, 200, 6)),
                   SamplingParams(max_tokens=4, ttft_deadline_ms=1e7,
                                  deadline_ms=1e7))
    eng.run_until_done(max_steps=5000)
    reasons = {r.rid: r.finish_reason for r in eng.finished}
    assert reasons[r_dead] == "deadline"
    assert reasons[r_ok] == "length"                 # deadlines off => normal
    dead = [r for r in eng.finished if r.rid == r_dead][0]
    assert (dead.done_t - dead.arrival) * 1e3 >= 200  # kept partial output
    assert eng.metrics["deadline_expired"] == 1
    assert eng.alloc.audit()["live_blocks"] == 0
    eng.close()


def test_ttft_deadline_fires_before_first_token(small):
    eng = _mk(small)
    rid = eng.add(list(np.random.default_rng(5).integers(1, 200, 6)),
                  SamplingParams(max_tokens=4, ttft_deadline_ms=0.001))
    time.sleep(0.01)
    # the async engine's events lag step() by one step (detok worker)
    outs = eng.step() + eng.step()
    assert any(o.request_id == rid and o.finish_reason == "deadline"
               for o in outs)
    assert eng.alloc.audit()["live_blocks"] == 0
    eng.close()


# ------------------------------------------------------ dispatch recovery
@pytest.mark.parametrize("kw", MODES)
def test_transient_dispatch_retry_is_token_exact(small, kw):
    prompts = _prompts(4, seed=1)
    base = _drain(_mk(small, **kw), prompts)

    def specs(Spec):
        return [Spec("dispatch", step=1, count=1),
                Spec("dispatch", step=3, count=2)]
    eng = _mk(small, fault_injector=FaultInjector(specs(FaultSpec)), **kw)
    got = _drain(eng, prompts)
    assert {r: list(v.output) for r, v in got.items()} == \
        {r: list(v.output) for r, v in base.items()}
    assert eng.metrics["dispatch_retries"] >= 3
    assert eng.metrics["quarantined"] == 0
    _vs_jax(small, eng, got, prompts, specs(JFaultSpec), **kw)
    eng.close()


@pytest.mark.parametrize("kw", MODES)
def test_poisoned_request_is_bisected_and_quarantined(small, kw):
    prompts = _prompts(4, seed=1)
    base = _drain(_mk(small, **kw), prompts)
    eng = _mk(small, fault_injector=FaultInjector(
        [FaultSpec("dispatch", step=0, rid=2)]), **kw)
    got = _drain(eng, prompts)
    assert got[2].finish_reason == "error"
    assert all(list(got[r].output) == list(base[r].output)
               for r in got if r != 2)
    assert eng.metrics["quarantined"] == 1
    assert eng.alloc.audit()["live_blocks"] == 0
    assert eng.health()["probing_rids"] == 0         # probation lifted
    _vs_jax(small, eng, got, prompts, [JFaultSpec("dispatch", step=0, rid=2)],
            **kw)
    eng.close()


@pytest.mark.parametrize("kw", MODES)
def test_nan_row_guard_fails_only_poisoned_row(small, kw):
    prompts = _prompts(4, seed=1)
    base = _drain(_mk(small, **kw), prompts)
    eng = _mk(small, fault_injector=FaultInjector(
        [FaultSpec("nan", step=0, rid=1)]), **kw)
    got = _drain(eng, prompts)
    assert got[1].finish_reason == "error"
    assert all(list(got[r].output) == list(base[r].output)
               for r in got if r != 1)
    assert all(t >= 0 for r in got.values() for t in r.output)
    assert eng.alloc.audit()["live_blocks"] == 0
    _vs_jax(small, eng, got, prompts, [JFaultSpec("nan", step=0, rid=1)],
            **kw)
    eng.close()


def test_guards_off_matches_guards_on_when_healthy(small):
    prompts = _prompts(4, seed=2)
    on = _drain(_mk(small, enable_guards=True), prompts)
    off_eng = _mk(small, enable_guards=False)
    assert not off_eng.guards and "sampling_guard" not in off_eng.rt
    off = _drain(off_eng, prompts)
    assert {r: list(v.output) for r, v in on.items()} == \
        {r: list(v.output) for r, v in off.items()}


# ------------------------------------------------------------- shedding
def test_shed_policy_reject(small):
    eng = _mk(small, max_waiting=2, shed_policy="reject")
    eng.add([1, 2, 3])
    eng.add([4, 5, 6])
    with pytest.raises(EngineOverloadedError):
        eng.add([7, 8, 9])
    assert eng.metrics["shed"] == 1
    assert eng.health()["waiting"] == 2
    eng.close()


def test_shed_policy_oldest(small):
    eng = _mk(small, max_waiting=2, shed_policy="shed-oldest")
    oldest = eng.add([1, 2, 3])
    eng.add([4, 5, 6])
    newest = eng.add([7, 8, 9])
    outs = eng.step()                     # shed event surfaces next step
    shed = [o for o in outs if o.finish_reason == "shed"]
    assert [o.request_id for o in shed] == [oldest]
    eng.run_until_done()
    reasons = {r.rid: r.finish_reason for r in eng.finished}
    assert reasons[oldest] == "shed" and reasons[newest] == "length"
    assert eng.alloc.audit()["live_blocks"] == 0
    eng.close()


def test_bad_shed_policy_rejected(small):
    with pytest.raises(ValueError):
        _mk(small, shed_policy="coin-flip")


# ------------------------------------------------------------- watchdog
def test_stall_trips_straggler_watchdog(small):
    fi = FaultInjector([FaultSpec("stall", step=4, seconds=0.4)])
    eng = _mk(small, fault_injector=fi)
    _drain(eng, _prompts(2, seed=6), max_tokens=10)
    assert eng.metrics["slow_steps"] >= 1
    rep = eng.report()
    assert rep["slow_steps"] >= 1
    assert np.isfinite(rep["step_time_ema_ms"])
    h = eng.health()
    assert h["slow_steps"] >= 1 and np.isfinite(h["step_time_ema_ms"])
    eng.close()


# ------------------------------------------------------------ chaos suite
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("kw", MODES)
def test_chaos_schedule_drains_token_exact(small, kw, pool):
    """Seeded random fault soup (transient dispatches, NaN rows, alloc
    exhaustion): every request finishes, quarantined ones with "error",
    the rest token-exact against the fault-free run; and the whole run
    equal to the JAX engine's under the same schedule."""
    prompts = _prompts(4, seed=7)
    base = _drain(_mk(small, kv_cache_dtype=pool, **kw), prompts)
    sched = dict(p_dispatch=0.25, p_alloc=0.2, p_nan=0.15, rids=[0, 3])
    fi = FaultInjector(random_schedule(11, 25, **sched))
    eng = _mk(small, fault_injector=fi, kv_cache_dtype=pool, **kw)
    got = _drain(eng, prompts)
    assert len(got) == len(prompts)                  # everyone finished
    bad = {r for r, v in got.items() if v.finish_reason == "error"}
    if pool == "bf16":
        # int8: with f32 activations the reference's own recompute replay
        # re-quantizes a requeued sequence's blocks, so survivors may
        # drift from the fault-free run in both packages (ROADMAP C1);
        # the int8 run is held to the JAX engine's instead, below
        assert all(list(got[r].output) == list(base[r].output)
                   for r in got if r not in bad), (bad, kw, pool)
    assert len(fi.fired) > 0                         # the soup was real
    assert eng.alloc.audit()["live_blocks"] == 0
    assert eng.health()["probing_rids"] == 0
    _vs_jax(small, eng, got, prompts, j_random_schedule(11, 25, **sched),
            kv_cache_dtype=pool, **kw)
    eng.close()
