"""``repro_torch.obs`` on the CPU: the tracer, histogram, exposition, HTTP
and engine-telemetry cases of ``tests/test_obs.py``, run on the port's
copy of the observability package and on the port's engine (the async
pipelined default, with a detokenizer)."""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.obs import (Histogram, MetricsDict, MetricsRegistry,
                             SpanTracer, attribute_steps,
                             validate_chrome_trace)
from repro_torch.obs.http import start_obs_server
from repro_torch.runtime.fault import StragglerDetector
from repro_torch.serving import SamplingParams, ServingEngine


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


@pytest.fixture(scope="module")
def small():
    jcfg = j_get_reduced("qwen2-1.5b", num_layers=2)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return get_reduced("qwen2-1.5b", num_layers=2), params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def served(small):
    """One engine run shared by the derivation/attribution/export tests;
    a 16-token budget keeps prompts chunking beside decodes, so steps
    pipeline."""
    cfg, params = small
    eng = ServingEngine(cfg, params, device="cpu", max_slots=4,
                        num_blocks=128, max_blocks_per_seq=8,
                        prefill_bucket=16, max_num_batched_tokens=16,
                        detokenizer=lambda ids: "".join(
                            chr(97 + i % 26) for i in ids))
    rng = np.random.default_rng(0)
    sp = SamplingParams(max_tokens=4)
    for _ in range(6):
        eng.add(list(rng.integers(1, 200, int(rng.integers(3, 15)))), sp)
    eng.run_until_done()
    yield eng
    eng.close()


# ------------------------------------------------------------------ tracer
def test_span_nesting_records_depth():
    tr = SpanTracer()
    with tr.span("outer"):
        with tr.span("inner", cat="device"):
            pass
    inner, outer = tr.spans()          # completion order: inner exits first
    assert (inner.name, inner.depth) == ("inner", 1)
    assert (outer.name, outer.depth) == ("outer", 0)
    assert inner.cat == "device"
    assert outer.ts <= inner.ts
    assert inner.ts + inner.dur <= outer.ts + outer.dur


def test_ring_truncation_counts_dropped():
    tr = SpanTracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert [s.name for s in tr.spans()] == ["e6", "e7", "e8", "e9"]
    assert tr.dropped == 6
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_disabled_tracer_is_zero_work():
    tr = SpanTracer(enabled=False)
    assert tr.span("a") is tr.span("b")
    with tr.span("a", cat="device", args={"x": 1}) as sp:
        sp.set(y=2)
    tr.instant("mark")
    assert tr.spans() == [] and tr.dropped == 0
    tr.enable()
    with tr.span("now-recorded"):
        pass
    assert [s.name for s in tr.spans()] == ["now-recorded"]


def test_chrome_trace_schema_valid():
    tr = SpanTracer()
    with tr.span("step", cat="step", args={"k": 1}):
        tr.instant("mark", cat="request")
    doc = tr.to_chrome_trace()
    assert validate_chrome_trace(doc) == []
    phs = {e["name"]: e["ph"] for e in doc["traceEvents"]}
    assert phs == {"mark": "i", "step": "X"}
    assert validate_chrome_trace({"traceEvents": [{"ph": "X"}]})


def test_attribution_host_plus_device_is_step():
    tr = SpanTracer()
    for _ in range(3):
        with tr.span("engine.step", cat="step"):
            with tr.span("plan", cat="host"):
                pass
            with tr.span("dispatch:unified", cat="device"):
                pass
            with tr.span("readback", cat="device"):
                pass
    attr = attribute_steps(tr.spans(), window=2)
    assert attr["steps"] == 2.0
    assert attr["host_ms"] + attr["device_ms"] == \
        pytest.approx(attr["step_ms"])
    assert attr["host_frac"] + attr["device_frac"] == pytest.approx(1.0)
    empty = attribute_steps([])
    assert empty["steps"] == 0.0 and empty["host_ms"] != empty["host_ms"]


# ----------------------------------------------------------------- metrics
def test_histogram_bucket_edges_le_semantics():
    h = Histogram("h_ms", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 1.0, 1.001, 5.0, 99.0):
        h.observe(v)
    assert h.counts == [2, 2, 0, 1]
    assert h.cumulative() == [("1", 2), ("5", 4), ("10", 4), ("+Inf", 5)]
    assert h.count == 5 and h.sum == pytest.approx(106.501)
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(5.0, 1.0))


def test_histogram_percentile_matches_numpy():
    h = Histogram("h", buckets=(1e9,), sample_maxlen=64)
    xs = np.random.default_rng(0).uniform(0, 100, 50)
    for v in xs:
        h.observe(v)
    for p in (0, 50, 99, 100):
        assert h.percentile(p) == pytest.approx(np.percentile(xs, p))
    h.clear_samples()
    assert h.percentile(50) != h.percentile(50)   # NaN on empty window
    assert h.count == 50


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("repro_gen_tokens", help="tokens").inc(7)
    reg.gauge("repro_waiting").set(3)
    h = reg.histogram("repro_itl_ms", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(4.0)
    text = reg.to_prometheus()
    for line in ("# TYPE repro_gen_tokens counter",
                 "# HELP repro_gen_tokens tokens", "repro_gen_tokens 7",
                 "# TYPE repro_waiting gauge",
                 'repro_itl_ms_bucket{le="1"} 1',
                 'repro_itl_ms_bucket{le="10"} 2',
                 'repro_itl_ms_bucket{le="+Inf"} 2',
                 "repro_itl_ms_sum 4.5", "repro_itl_ms_count 2"):
        assert line in text
    with pytest.raises(ValueError):
        reg.counter("0bad name")


def test_registry_snapshot_json_and_type_guard():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.gauge("g").set(float("nan"))
    reg.histogram("h", buckets=(1.0,)).observe(2.0)
    snap = reg.snapshot()
    json.dumps(snap, allow_nan=False)
    assert snap["gauges"]["g"] is None
    assert snap["histograms"]["h"]["buckets"] == {"1": 0, "+Inf": 1}
    with pytest.raises(TypeError):
        reg.gauge("c")
    assert reg.counter("c").get() == 1.0


def test_metrics_dict_facade_backed_by_registry():
    reg = MetricsRegistry()
    m = MetricsDict(reg, initial={"gen_tokens": 0})
    m["gen_tokens"] += 2
    m.setdefault("preemptions", 0)
    m["preemptions"] += 1
    assert reg.get("repro_gen_tokens").get() == 2.0
    assert dict(m) == {"gen_tokens": 2.0, "preemptions": 1.0}
    with pytest.raises(KeyError):
        m["never_created"]


# -------------------------------------------------------------------- http
def test_http_metrics_health_trace_smoke():
    reg = MetricsRegistry()
    reg.counter("repro_gen_tokens").inc(5)
    tr = SpanTracer()
    tr.instant("mark")
    srv = start_obs_server(0, registry=reg, tracer=tr,
                           health_fn=lambda: {"waiting": 1.0,
                                              "max_waiting": float("inf")})
    port = srv.server_address[1]
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.read().decode()
        code, text = get("/metrics")
        assert code == 200 and "repro_gen_tokens 5" in text
        code, text = get("/health")
        assert json.loads(text) == {"waiting": 1.0, "max_waiting": None}
        code, text = get("/trace")
        assert validate_chrome_trace(json.loads(text)) == []
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        srv.shutdown()


# ------------------------------------------------------------------ engine
def test_engine_latency_histograms_match_lifecycle(served):
    eng = served
    fin = eng.finished
    assert fin and eng.async_step and eng.metrics["async_steps"] > 0
    want_ttft = sorted((r.first_token_t - r.arrival) * 1e3 for r in fin)
    assert sorted(eng._h_ttft.samples()) == pytest.approx(want_ttft)
    want_wait = sorted((r.admitted_t - r.arrival) * 1e3 for r in fin)
    assert sorted(eng._h_queue_wait.samples()) == pytest.approx(want_wait)
    assert all(w >= 0 for w in want_wait)
    rep = eng.report()
    assert rep["itl_p50_ms"] == pytest.approx(
        float(np.percentile(eng._h_itl.samples(), 50)))
    assert rep["ttft_p99_ms"] == pytest.approx(
        float(np.percentile(want_ttft, 99)))
    assert rep["queue_wait_p50_ms"] == pytest.approx(
        float(np.percentile(want_wait, 50)))


def test_engine_attribution_and_trace_export(served, tmp_path):
    eng = served
    attr = eng.attribution()
    assert attr["steps"] > 0
    assert attr["host_ms"] + attr["device_ms"] == \
        pytest.approx(attr["step_ms"])
    assert 0.0 <= attr["host_frac"] <= 1.0
    names = {s.name for s in eng.tracer.spans()}
    assert {"engine.step", "plan", "detokenize", "readback", "req.arrival",
            "req.admitted", "req.first_token", "req.finish",
            "dispatch:unified_chained"} <= names
    out = tmp_path / "trace.json"
    eng.tracer.save(str(out))
    doc = json.loads(out.read_text())
    assert validate_chrome_trace(doc) == []
    assert len(doc["traceEvents"]) == len(eng.tracer.spans())


def test_report_health_served_from_registry(served):
    eng = served
    rep, health = eng.report(), eng.health()
    for k in ("step_time_ema_ms", "slow_steps", "dispatch_retries",
              "quarantined", "shed", "aborted", "deadline_expired",
              "block_utilization"):
        assert rep[k] == health[k] or (rep[k] != rep[k]
                                       and health[k] != health[k])
    for k in ("waiting", "running", "free_blocks", "watermark_blocks",
              "probing_rids", "max_waiting"):
        assert k in health
    text = eng.obs.to_prometheus()
    assert f'repro_gen_tokens {eng.metrics["gen_tokens"]:g}' in text
    assert "repro_request_ttft_ms_bucket" in text
    json.dumps(eng.obs.snapshot(), allow_nan=False)


def test_telemetry_off_engine_still_serves(small):
    cfg, params = small
    eng = ServingEngine(cfg, params, device="cpu", max_slots=2,
                        num_blocks=64, max_blocks_per_seq=8,
                        prefill_bucket=16, enable_telemetry=False)
    eng.add([5, 9, 13, 2, 7], SamplingParams(max_tokens=3))
    rep = eng.run_until_done()
    assert len(eng.finished) == 1
    assert eng.tracer.spans() == []
    assert eng.attribution()["steps"] == 0.0
    assert rep["itl_p50_ms"] == rep["itl_p50_ms"]  # histograms still on
    assert eng.metrics["gen_tokens"] == 3
    eng.close()


def test_profile_labels_name_dispatches(small):
    """``profile_labels`` wraps each dispatch in a
    ``torch.profiler.record_function`` region."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = small
    eng = ServingEngine(cfg, params, device="cpu", max_slots=2,
                        num_blocks=64, max_blocks_per_seq=8,
                        profile_labels=True)
    eng.add([5, 9, 13, 2, 7], SamplingParams(max_tokens=3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_until_done()
    names = {e.key for e in prof.key_averages()}
    assert "unified_step_chained" in names or "unified_step" in names
    assert "megastep" in names
    eng.close()


def test_straggler_events_bounded():
    det = StragglerDetector(threshold=1.5, patience=10**9)
    det.observe(0, 1.0)
    for i in range(1, 1002):
        det.observe(i, 10.0)
    assert len(det.events) == 256
    assert det.events[-1]["step"] == 1001
