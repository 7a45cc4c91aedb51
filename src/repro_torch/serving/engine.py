"""Continuous-batching serving engine of the port.

A thin conductor over the host ``Scheduler`` (admission, slots, blocks,
preemption, the per-iteration token budget — ported near verbatim) and
the device ``ModelRunner``, with the JAX package's modes and defaults:

* ``enable_async_step=True`` (default; rides the unified step) pipelines
  the loop one step deep: an iteration plans and ENQUEUES its unified
  dispatch chained on the previous, still in-flight one — the decode feed
  tokens are gathered on the device from that dispatch's output buffer —
  and only then reads the previous step's tokens back, so the host work of
  a step (plan, absorb, detokenize on a background worker, bookkeeping)
  overlaps the device.  The scheduler plans speculatively and reconciles
  at readback; finish, abort or preemption during the flight discards the
  speculated token, which recompute replay regenerates token-exactly.
  Every other dispatch (megastep, CoW, chunk bursts) collects the flight
  first.  ``enable_async_step=False`` reads back every step: the
  pipeline's parity oracle.
* ``enable_unified_step=True`` (default; chunked mode with ``use_fused``)
  runs a mixed iteration — decodes interleaved with a prefill chunk — as
  ONE dispatch: the decode step, the chunk and every row's sampling.
  ``enable_unified_step=False`` keeps the two-call execute (decode
  dispatch, then chunk dispatches, then the first-token sample): the
  unified path's oracle.  ``use_fused=False`` decodes one token per
  dispatch (``decode`` then ``sample``) instead of the fused megastep.
* ``enable_chunked_prefill=False`` keeps the stop-the-world whole-prompt
  waves padded to a ``prefill_bucket`` multiple (the static
  ``flash_attention`` kernel), then megastep decode.

Either mode serves the bf16 or the int8 KV pool (``kv_cache_dtype``).
Robustness rides the loop as in the reference: a non-finite logit guard
(``enable_guards``), dispatch retries with backoff, quarantine bisection
of a poisoned batch, load shedding past ``max_waiting``, deadlines, and a
straggler watchdog; a ``FaultInjector`` drives each failure
deterministically.  Telemetry (``enable_telemetry``) records host-clock
spans per step, which ``attribution()`` splits into host and device
time; the metrics registry behind ``report()``/``health()`` (TTFT,
inter-token and queue-wait histograms, gauges) is always on.

The pre-``SamplingParams`` surface — ``Request`` and ``add_request`` —
is kept as a deprecation shim, as in the reference.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence as SeqT

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_cache import BlockAllocator
from repro_torch.core.sampling import fold_in, threefry_seed
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsDict, MetricsRegistry
from repro_torch.obs.trace import SpanTracer, attribute_steps
from repro_torch.runtime.fault import StragglerDetector
from repro_torch.serving.detok import DetokWorker
from repro_torch.serving.faults import (FaultInjector, PoisonedDispatchError,
                                        TransientDeviceError)
from repro_torch.serving.model_runner import ModelRunner, Readback
from repro_torch.serving.params import (FINISH_ABORT, FINISH_ERROR,
                                        FINISH_LENGTH, FINISH_SHED,
                                        FINISH_STOP, RequestOutput,
                                        SamplingParams)
from repro_torch.serving.scheduler import (PrefillChunk, RequestState,
                                           Scheduler, Sequence, StepPlan,
                                           UnifiedDispatch)


class EngineOverloadedError(RuntimeError):
    """``add`` refused a request: the waiting queue is at ``max_waiting``
    and the engine's shed policy is "reject"."""


@dataclass
class Request:
    """Deprecated pre-``SamplingParams`` request record (one-release shim).

    Use ``engine.add(prompt, SamplingParams(...))`` instead; this maps
    onto it via ``add_request`` and keeps filling ``output`` in place.
    """
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    arrival: float = 0.0
    output: List[int] = field(default_factory=list)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None


@dataclass
class _Flight:
    """One in-flight (enqueued, not yet read back) unified dispatch.

    ``out`` is its [max_slots + 1] token buffer on the device: the next
    dispatch gathers its feed tokens from it, so it is held here until
    collect; ``readback`` is its copy to pinned host memory, enqueued
    right behind the dispatch.  ``decode_rows`` / ``chunk_seq`` name the
    sequences whose sampled token the buffer carries; ``source_row`` maps
    ``id(Sequence)`` to its row (row ``max_slots`` is the chunk sample).
    Holding the Sequence objects lets collect detect finish, abort and
    preemption-and-readmission during the flight by identity."""
    out: torch.Tensor
    readback: Readback
    decode_rows: List[tuple] = field(default_factory=list)
    chunk_seq: Optional[Sequence] = None
    source_row: Dict[int, int] = field(default_factory=dict)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 num_blocks: int = 512, max_blocks_per_seq: int = 64,
                 prefill_bucket: int = 64, rt: Optional[dict] = None,
                 seed: int = 0, use_fused: bool = True,
                 max_horizon: int = 8, detokenizer=None,
                 kv_cache_dtype: str = "bf16",
                 max_num_batched_tokens: int = 256,
                 enable_chunked_prefill: bool = True,
                 enable_unified_step: bool = True,
                 enable_async_step: bool = True,
                 max_waiting: Optional[int] = None,
                 shed_policy: str = "reject",
                 enable_guards: bool = True,
                 fault_injector: Optional[FaultInjector] = None,
                 max_dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 enable_telemetry: bool = True,
                 trace_capacity: int = 65536,
                 profile_labels: bool = False, device="cuda"):
        if shed_policy not in ("reject", "shed-oldest"):
            raise ValueError(f"shed_policy {shed_policy!r}: expected "
                             "'reject' or 'shed-oldest'")
        dev = resolve_device(device)
        params = tree_to(params, dev)
        self.cfg = cfg
        self.max_slots = max_slots
        self.mb = max_blocks_per_seq
        self.prefill_bucket = prefill_bucket
        self.use_fused = use_fused
        self.max_horizon = max(1, max_horizon)
        self.detokenizer = detokenizer
        self.seed = seed
        # the registry is the single source of truth for report() and
        # health(); ``metrics`` is a dict-like facade over its counters.
        # Only the span tracer is gated by ``enable_telemetry``.
        self.obs = MetricsRegistry()
        self.tracer = SpanTracer(capacity=trace_capacity,
                                 enabled=enable_telemetry)
        self.metrics: Dict[str, float] = MetricsDict(self.obs, initial={
            "prompt_tokens": 0, "gen_tokens": 0, "preemptions": 0,
            "host_syncs": 0, "decode_dispatches": 0, "decode_steps": 0,
            "decode_time_s": 0.0, "truncated_prompts": 0,
            # dispatches after the first pure-decode one (its warm-up)
            "decode_warm_steps": 0, "decode_warm_time_s": 0.0,
            "timed_decode_dispatches": 0,
            "prefill_chunks": 0, "plan_steps": 0, "budget_tokens_used": 0,
            # device calls per engine iteration: work_steps counts the
            # iterations that dispatched at all
            "device_dispatches": 0, "work_steps": 0,
            "dispatch_retries": 0, "quarantined": 0, "shed": 0,
            "aborted": 0, "deadline_expired": 0, "slow_steps": 0,
            # iterations that enqueued their dispatch chained on an
            # in-flight one instead of blocking on it
            "async_steps": 0})
        self._h_queue_wait = self.obs.histogram(
            "repro_request_queue_wait_ms",
            help="arrival to first admission (slot assigned)")
        self._h_ttft = self.obs.histogram(
            "repro_request_ttft_ms",
            help="arrival to first sampled token")
        # a bounded percentile window (the buckets keep the full history)
        self._h_itl = self.obs.histogram(
            "repro_itl_ms", sample_maxlen=65536,
            help="inter-token latency (per-event gaps, TTFT excluded)")
        self._g_waiting = self.obs.gauge(
            "repro_waiting", help="requests queued for admission")
        self._g_running = self.obs.gauge(
            "repro_running", help="requests holding a decode slot")
        self._g_free_blocks = self.obs.gauge(
            "repro_free_blocks", help="free KV pool blocks")
        self._g_step_ema = self.obs.gauge(
            "repro_step_time_ema_ms",
            help="straggler watchdog's EMA of work-step wall time")
        # chunked prefill needs every layer's prefill state to live in the
        # paged pool; every config the port serves today does
        # (transformer._require_ported), the other families will not
        self.chunked = bool(enable_chunked_prefill) \
            and T.supports_chunked_prefill(cfg)
        alloc = BlockAllocator(
            num_blocks, cfg.paging.block_size,
            enable_prefix_reuse=cfg.paging.enable_prefix_reuse,
            watermark_frac=cfg.paging.watermark_frac)
        self.scheduler = Scheduler(alloc, max_slots=max_slots,
                                   max_blocks_per_seq=max_blocks_per_seq,
                                   metrics=self.metrics)
        self.max_num_batched_tokens = int(max_num_batched_tokens)
        if self.chunked and self.max_num_batched_tokens <= max_slots:
            raise ValueError(
                f"max_num_batched_tokens={max_num_batched_tokens} must "
                f"exceed max_slots={max_slots}: a step of all-decode slots "
                "would otherwise leave prefill no budget (starvation)")
        # the chunk's fixed token width: never longer than the budget, nor
        # than a sequence's KV capacity
        chunk_tokens = min(self.max_num_batched_tokens,
                           self.scheduler.cap_tokens) if self.chunked \
            else None
        self.unified = bool(enable_unified_step) and self.chunked \
            and use_fused
        self.async_step = bool(enable_async_step) and self.unified
        # guarded sampling: a row whose logits hold a non-finite value
        # samples -1 (one max-reduce and select per sampled batch)
        self.guards = bool(enable_guards)
        rt = dict(rt or {})
        if self.guards:
            rt["sampling_guard"] = True
        self.runner = ModelRunner(cfg, params, max_slots=max_slots,
                                  num_blocks=num_blocks,
                                  max_blocks_per_seq=max_blocks_per_seq,
                                  rt=rt, max_horizon=self.max_horizon,
                                  kv_cache_dtype=kv_cache_dtype,
                                  chunk_tokens=chunk_tokens,
                                  tracer=self.tracer,
                                  profile_labels=profile_labels)
        self.kv_cache_dtype = self.runner.kv_cache_dtype
        self._t0: Optional[float] = None
        self._next_rid = 0
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.shed_policy = shed_policy
        self.faults = fault_injector
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._straggler = StragglerDetector()
        # poisoned-dispatch bisection: rid groups awaiting probation, and
        # the group currently admitted in isolation (allowed_rids)
        self._suspects: deque = deque()
        self._probing: Optional[List[int]] = None
        # events produced outside step() (abort / shed), surfaced first by
        # the next step
        self._pending: List[RequestOutput] = []
        # the async pipeline: the un-collected dispatch, and the FIFO
        # worker every async-mode emission goes through
        self._flight: Optional[_Flight] = None
        self._detok: Optional[DetokWorker] = \
            DetokWorker(detokenizer, self.tracer) if self.async_step \
            else None

    # ---------------------------------------------------- facade views
    @property
    def alloc(self) -> BlockAllocator:
        return self.scheduler.alloc

    @property
    def waiting(self) -> List[RequestState]:
        return self.scheduler.waiting

    @property
    def running(self) -> Dict[int, Sequence]:
        return self.scheduler.running

    @property
    def finished(self) -> List[RequestState]:
        return self.scheduler.finished

    @property
    def state(self):
        return self.runner.state

    @property
    def rt(self) -> dict:
        return self.runner.rt

    # ------------------------------------------------------------ intake
    def _base_key(self, rid: int, sp: SamplingParams) -> np.ndarray:
        """Per-request stream root, the reference's: ``PRNGKey(seed)`` for
        an explicit seed, else ``fold_in(PRNGKey(engine seed), rid)``."""
        if sp.seed is not None:
            return threefry_seed(sp.seed)
        k = fold_in(threefry_seed(self.seed)[None], np.array([rid]))
        return k[0].numpy().astype(np.uint32)

    def add(self, prompt: SeqT[int],
            sampling_params: Optional[SamplingParams] = None,
            request_id: Optional[int] = None) -> int:
        """Queue a request (allowed while streaming); returns its id.

        With ``max_waiting`` set the waiting queue is bounded: a full
        queue either raises ``EngineOverloadedError`` (shed_policy
        "reject") or finishes the OLDEST waiting request with
        finish_reason "shed" to make room ("shed-oldest"; running
        requests are never shed)."""
        if self.max_waiting is not None \
                and len(self.scheduler.waiting) >= self.max_waiting:
            self.metrics["shed"] += 1
            if self.shed_policy == "reject":
                raise EngineOverloadedError(
                    f"waiting queue at max_waiting={self.max_waiting}")
            victim = self.scheduler.waiting[0]
            self.scheduler.abort(victim.rid, FINISH_SHED)
            self._emit(victim, self._pending)
        sp = sampling_params or SamplingParams()
        rid = self._next_rid if request_id is None else request_id
        self._next_rid = max(self._next_rid, rid) + 1
        rec = RequestState(rid=rid, prompt=list(prompt), sampling=sp,
                           base_key=self._base_key(rid, sp))
        self.scheduler.add(rec)
        self.tracer.instant("req.arrival", cat="request",
                            args={"rid": rid, "prompt_len": len(rec.prompt)})
        return rid

    def add_request(self, req: Request) -> None:
        """Deprecated: wrap a legacy ``Request``; its ``output`` list is
        shared with the engine so old call sites keep reading results."""
        warnings.warn(
            "ServingEngine.add_request(Request(...)) is deprecated; use "
            "engine.add(prompt, SamplingParams(...)) or serving.llm.LLM",
            DeprecationWarning, stacklevel=2)
        sp = SamplingParams(temperature=req.temperature,
                            max_tokens=req.max_new_tokens)
        rec = RequestState(rid=req.rid, prompt=req.prompt, sampling=sp,
                           output=req.output, shim=req,
                           base_key=self._base_key(req.rid, sp))
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.scheduler.add(rec)
        req.arrival = rec.arrival

    # ------------------------------------------------------------ lifecycle
    def abort(self, request_id: int) -> bool:
        """Cancel a request wherever it is; its blocks and slot are freed
        now and its finish event ("aborted", partial output kept) surfaces
        with the next ``step()``.  False if unknown or already finished."""
        req = self.scheduler.abort(request_id, FINISH_ABORT)
        if req is None:
            return False
        self.metrics["aborted"] += 1
        self.tracer.instant("req.abort", cat="request",
                            args={"rid": request_id})
        self._emit(req, self._pending)
        return True

    def _mark_admitted(self, reqs: SeqT[RequestState], now: float) -> None:
        """First admission: the queue-wait sample and a trace instant
        (re-admissions after preemption keep the first mark)."""
        for req in reqs:
            if req.admitted_t is None:
                req.admitted_t = now
                self._h_queue_wait.observe((now - req.arrival) * 1e3)
                self.tracer.instant("req.admitted", cat="request",
                                    args={"rid": req.rid})

    # ------------------------------------------------------------ outputs
    def _emit(self, req: RequestState, outs: List[RequestOutput]) -> None:
        new = list(req.output[req.emitted:])
        finished = req.finish_reason is not None
        if not new and not finished:
            return
        if finished:
            self.tracer.instant("req.finish", cat="request",
                                args={"rid": req.rid,
                                      "reason": req.finish_reason,
                                      "tokens": len(req.output)})
        if self._detok is not None:
            # async mode: every emission goes through the FIFO worker, so
            # per-request event order holds while detokenization overlaps
            # the in-flight dispatch; step() surfaces it a step later
            self._detok.submit(req, new, finished, req.finish_reason)
            req.emitted = len(req.output)
            return
        if req.shim is not None:     # legacy Request: mirror timestamps
            req.shim.first_token_t = req.first_token_t
            req.shim.done_t = req.done_t
        text = new_text = ""
        if self.detokenizer is not None:
            with self.tracer.span("detokenize", cat="host"):
                new_text = self.detokenizer(new) if new else ""
            req.text += new_text
            text = req.text
        outs.append(RequestOutput(
            request_id=req.rid, prompt_token_ids=req.prompt_token_ids,
            token_ids=list(req.output), new_token_ids=new,
            finished=finished, finish_reason=req.finish_reason,
            text=text, new_text=new_text))
        req.emitted = len(req.output)

    def _absorb(self, s: Sequence, toks, now: float,
                outs: List[RequestOutput]) -> None:
        """Fold sampled tokens into a sequence, honouring stop ids and
        max_tokens; a guarded -1 (non-finite logits) quarantines the
        request, keeping what it sampled before.  Finishing frees its KV
        blocks at once.  Emits the delta event."""
        req = s.req
        if toks:
            if req.last_event_t is not None:
                self._h_itl.observe((now - req.last_event_t) * 1e3)
            req.last_event_t = now
        for tok in toks:
            if int(tok) < 0:
                self.metrics["quarantined"] += 1
                self.tracer.instant("req.quarantine", cat="request",
                                    args={"rid": req.rid, "site": "nan_row"})
                if self.faults is not None:
                    self.faults.forgive(req.rid)
                self.scheduler.finish(s, FINISH_ERROR)
                break
            req.output.append(int(tok))
            s.last_token = int(tok)
            s.seq_len += 1
            self.metrics["gen_tokens"] += 1
            if req.first_token_t is None:
                req.first_token_t = now
                self._h_ttft.observe((now - req.arrival) * 1e3)
                self.tracer.instant("req.first_token", cat="request",
                                    args={"rid": req.rid})
            if int(tok) in req.sampling.stop:
                self.scheduler.finish(s, FINISH_STOP)
                break
            if req.tokens_remaining() <= 0:
                self.scheduler.finish(s, FINISH_LENGTH)
                break
        self._emit(req, outs)

    # ------------------------------------------------------------ recovery
    def _protected(self, rids: List[int], fn):
        """Run one dispatch under the transient-fault guard: the injector
        is consulted BEFORE anything is enqueued (so a retry is always
        safe), retries back off exponentially, and past
        ``max_dispatch_retries`` the failure becomes a
        ``PoisonedDispatchError`` carrying the batch's request ids."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.check_dispatch(rids)
                return fn()
            except TransientDeviceError as e:
                attempt += 1
                self.metrics["dispatch_retries"] += 1
                if attempt > self.max_dispatch_retries:
                    raise PoisonedDispatchError(rids, str(e)) from e
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _quarantine(self, rid: int, outs: List[RequestOutput]) -> None:
        self.metrics["quarantined"] += 1
        self.tracer.instant("req.quarantine", cat="request",
                            args={"rid": rid, "site": "dispatch"})
        if self.faults is not None:
            self.faults.forgive(rid)
        req = self.scheduler.abort(rid, FINISH_ERROR)
        if req is not None:
            self._emit(req, outs)

    def _advance_probe(self) -> None:
        """Pop the next suspect group into probation (the scheduler admits
        only its rids until it clears), or lift the allow-set once no
        suspects remain."""
        if self._probing is None and self._suspects:
            self._probing = list(self._suspects.popleft())
            self.scheduler.allowed_rids = set(self._probing)
        elif self._probing is None:
            self.scheduler.allowed_rids = None

    def _recover(self, e: PoisonedDispatchError,
                 outs: List[RequestOutput]) -> None:
        """Poisoned-dispatch recovery: every request of the failing batch
        is requeued recompute-style (survivors stay token-exact); a
        single-request batch has found its offender, which is quarantined
        with "error"; a larger batch is bisected into two probation
        groups the scheduler re-admits in isolation."""
        live = [rid for rid in e.rids
                if self.scheduler.preempt_request(rid) is not None]
        if len(live) == 1:
            self._quarantine(live[0], outs)
        elif len(live) > 1:
            mid = len(live) // 2
            self._suspects.append(live[:mid])
            self._suspects.append(live[mid:])
        self._probing = None
        self._advance_probe()

    # ------------------------------------------------------------ sampling
    def _sampling_rows(self, recs: List[Optional[RequestState]],
                       live: Optional[set] = None) -> Dict[str, np.ndarray]:
        """Per-request SamplingParams stacked into padded host rows.

        ``live``: rids whose sampled token this dispatch actually consumes
        (None: every non-pad row).  The nan fault site is consulted for
        live rows only, so a scheduled fault cannot burn itself on a
        sample nobody reads; a firing spec adds a NaN bias row
        (``"poison"``) to the chosen requests' logits on the device."""
        B = len(recs)
        arr = {"keys": np.zeros((B, 2), np.uint32),
               "counts": np.zeros((B,), np.int32),
               "temps": np.zeros((B,), np.float32),
               "top_ks": np.zeros((B,), np.int32),
               "top_ps": np.ones((B,), np.float32)}
        for i, r in enumerate(recs):
            if r is None:
                continue
            arr["keys"][i] = r.base_key
            arr["counts"][i] = len(r.output)
            arr["temps"][i] = r.sampling.temperature
            arr["top_ks"][i] = r.sampling.top_k
            arr["top_ps"][i] = r.sampling.top_p
        eligible = [r.rid for r in recs if r is not None
                    and (live is None or r.rid in live)]
        nan = self.faults.nan_rids(eligible) \
            if self.faults is not None else ()
        if nan:
            rows = [i for i, r in enumerate(recs)
                    if r is not None and r.rid in nan]
            if rows:
                p = np.zeros((B,), np.float32)
                p[rows] = np.nan
                arr["poison"] = p
        return arr

    def _slot_sampling(self, live: Optional[set] = None
                       ) -> Dict[str, np.ndarray]:
        recs: List[Optional[RequestState]] = [None] * self.max_slots
        for slot, s in self.scheduler.running.items():
            recs[slot] = s.req
        return self._sampling_rows(recs, live=live)

    # ------------------------------------------------------------ prefill
    def _run_prefill_oracle(self, seqs: List[Sequence],
                            outs: List[RequestOutput]) -> None:
        """Stop-the-world wave prefill (``enable_chunked_prefill=False``):
        the whole wave, padded to a ``prefill_bucket`` multiple, in one
        dispatch, then its first tokens sampled in one call."""
        b = self.prefill_bucket
        maxlen = max(s.seq_len for s in seqs)
        maxlen = min(((maxlen + b - 1) // b) * b, self.scheduler.cap_tokens)
        rids = [s.req.rid for s in seqs]
        logits = self._protected(rids,
                                 lambda: self.runner.prefill(seqs, maxlen))
        # register-on-write: the wave's device write is issued, so its
        # full prompt blocks become content-addressable
        for s in seqs:
            self.scheduler.register_written(s)
        self.metrics["prompt_tokens"] += sum(s.seq_len for s in seqs)
        nxt = self._protected(rids, lambda: self.runner.sample(
            logits, self._sampling_rows([s.req for s in seqs])))
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        for i, s in enumerate(seqs):
            self._absorb(s, [int(nxt[i])], now, outs)
        # leave the device tables consistent with the host bookkeeping
        self.runner.sync_tables(self.scheduler.running)

    def _run_prefill_chunks(self, chunks: List[PrefillChunk],
                            outs: List[RequestOutput]) -> None:
        """Chunks that ride no decode step: each runs alone, then the
        prompts completing here sample their first token in one call."""
        final: List[tuple] = []
        try:
            for c in chunks:
                logits = self._protected(
                    [c.seq.req.rid],
                    lambda c=c: self.runner.prefill_chunk(c.seq, c.start,
                                                          c.length))
                self.scheduler.complete_chunk(c)
                self.metrics["prefill_chunks"] += 1
                self.metrics["prompt_tokens"] += c.length
                if c.last:
                    final.append((c.seq, logits))
        except PoisonedDispatchError as e:
            # prompts that completed prefill this step but whose first
            # token was never sampled requeue with the failing dispatch
            raise PoisonedDispatchError(
                set(e.rids) | {s.req.rid for s, _ in final}) from e
        if not final:
            return
        nxt = self._protected(
            [s.req.rid for s, _ in final],
            lambda: self.runner.sample(
                torch.cat([lg for _, lg in final], 0),
                self._sampling_rows([s.req for s, _ in final])))
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        for i, (s, _) in enumerate(final):
            self._absorb(s, [int(nxt[i])], now, outs)

    # ------------------------------------------------------------ readback
    def _readback(self, rb: Readback) -> np.ndarray:
        """The host<->device sync boundary: wait for a dispatch's token
        copy (enqueued right behind the dispatch).  cat="device": the
        host is blocked on the stream; under the pipeline this is the
        device time the overlapped host work failed to hide."""
        with self.tracer.span("readback", cat="device"):
            return rb.wait()

    # ------------------------------------------------------------ decode
    def _record_decode_time(self, dt: float, steps: int) -> None:
        self.metrics["decode_time_s"] += dt
        self.metrics["timed_decode_dispatches"] += 1
        if self.metrics["timed_decode_dispatches"] > 1:
            self.metrics["decode_warm_time_s"] += dt
            self.metrics["decode_warm_steps"] += steps

    def _prepare_dispatch(self, horizon: int) -> StepPlan:
        """Whole-prompt mode's planning: horizon and block growth for all
        running (= all decodable) sequences, as one decode-only plan."""
        h = self.scheduler.plan_horizon(horizon)
        cow = self.scheduler.grow_for_horizon(h) if h else []
        return StepPlan(decode_slots=sorted(self.scheduler.decodable())
                        if h else [], horizon=h, cow_pairs=cow,
                        prefill=[], budget=0)

    def _dispatch_decode(self, plan: StepPlan,
                         outs: List[RequestOutput]) -> None:
        """A plan's decode half: the fused megastep over the planned
        horizon, or the per-token ``decode`` + ``sample`` oracle
        (``use_fused=False``).  Only the plan's slots are active
        (everything else gets seq_len 0, so the KV scatter drops it)."""
        if not plan.decode_slots:
            return
        t0 = time.perf_counter()
        if plan.cow_pairs:
            self.runner.copy_cow(plan.cow_pairs)
        self.runner.sync_tables({slot: self.scheduler.running[slot]
                                 for slot in plan.decode_slots})
        toks = np.zeros((self.max_slots,), np.int32)
        for slot in plan.decode_slots:
            toks[slot] = self.scheduler.running[slot].last_token
        rids = [self.scheduler.running[sl].req.rid
                for sl in plan.decode_slots]
        if self.use_fused:
            active = np.zeros((self.max_slots,), bool)
            active[plan.decode_slots] = True
            out_np = self._protected(rids, lambda: self.runner.megastep(
                toks, self._slot_sampling(live=set(rids)), active,
                plan.horizon))
            nxt_rows = {slot: out_np[:, slot].tolist()
                        for slot in plan.decode_slots}
        else:
            def _decode_and_sample():
                logits = self.runner.decode(toks)
                return self.runner.sample(
                    logits, self._slot_sampling(live=set(rids)))
            nxt = self._protected(rids, _decode_and_sample)
            nxt_rows = {slot: [int(nxt[slot])] for slot in plan.decode_slots}
        self.metrics["host_syncs"] += 1
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps"] += plan.horizon
        now = time.perf_counter()
        for slot in plan.decode_slots:
            self._absorb(self.scheduler.running[slot], nxt_rows[slot],
                         now, outs)
        self._record_decode_time(time.perf_counter() - t0, plan.horizon)

    def _dispatch_unified(self, plan: StepPlan,
                          outs: List[RequestOutput]) -> None:
        """A mixed plan (decodes at horizon <= 1 interleaved with prefill)
        as unified dispatches: the first fuses the decode step, the step's
        first chunk and all sampling; further chunks of an admission burst
        each dispatch alone.  Every dispatch is in flight before the step's
        one blocking point."""
        if plan.cow_pairs:
            self.runner.copy_cow(plan.cow_pairs)
        done: List[tuple] = []
        try:
            for d in plan.unified_dispatches():
                self.runner.sync_tables({slot: self.scheduler.running[slot]
                                         for slot in d.decode_slots})
                toks = np.zeros((self.max_slots,), np.int32)
                active = np.zeros((self.max_slots,), bool)
                recs: List[Optional[RequestState]] = [None] * self.max_slots
                rids = []
                for slot in d.decode_slots:
                    toks[slot] = self.scheduler.running[slot].last_token
                    active[slot] = True
                    recs[slot] = self.scheduler.running[slot].req
                    rids.append(recs[slot].rid)
                c = d.chunk
                recs.append(c.seq.req)          # row max_slots: the chunk
                live = set(rids) | ({c.seq.req.rid} if d.sample_chunk
                                    else set())
                out = self._protected(
                    rids + [c.seq.req.rid],
                    lambda: self.runner.unified_step(
                        toks, self._sampling_rows(recs, live=live), active,
                        c.seq.req.prompt, c.seq.block_ids, c.start,
                        c.length))
                done.append((d, Readback(out)))
                self.scheduler.complete_chunk(c)
                self.metrics["prefill_chunks"] += 1
                self.metrics["prompt_tokens"] += c.length
                if d.decode_slots:
                    self.metrics["decode_dispatches"] += 1
                    self.metrics["decode_steps"] += 1
        finally:
            # on a poisoned later dispatch this still runs before
            # recovery, so completed dispatches' tokens are banked
            if done:
                self.metrics["host_syncs"] += 1
                now = time.perf_counter()
                for d, rb in done:
                    out_np = self._readback(rb)
                    for slot in d.decode_slots:
                        self._absorb(self.scheduler.running[slot],
                                     [int(out_np[slot])], now, outs)
                    if d.sample_chunk:
                        self._absorb(d.chunk.seq,
                                     [int(out_np[self.max_slots])],
                                     now, outs)

    # ------------------------------------------------------------ pipeline
    def _enqueue_unified(self, d: UnifiedDispatch,
                         outs: List[RequestOutput]) -> _Flight:
        """Enqueue one unified dispatch WITHOUT reading it back, chained
        on the in-flight dispatch's output buffer.  A decode row whose
        feed token is still in flight is fed by a device-side gather;
        rows whose token the host already holds feed the host value.  The
        host bookkeeping (tables, PRNG counts, chunk completion, the
        speculative seq_len bumps) is what the synchronous engine would
        have done after absorbing the in-flight tokens."""
        sched = self.scheduler
        prev = self._flight
        # each slot's seq_len already counts its speculated token (the one
        # this dispatch feeds and whose KV it writes at seq_len - 1)
        self.runner.sync_tables({slot: sched.running[slot]
                                 for slot in d.decode_slots})
        toks = np.zeros((self.max_slots,), np.int32)
        chain_idx = np.zeros((self.max_slots,), np.int32)
        use_prev = np.zeros((self.max_slots,), bool)
        active = np.zeros((self.max_slots,), bool)
        recs: List[Optional[RequestState]] = [None] * self.max_slots
        rids = []
        for slot in d.decode_slots:
            s = sched.running[slot]
            active[slot] = True
            recs[slot] = s.req
            rids.append(s.req.rid)
            row = prev.source_row.get(id(s)) if prev is not None else None
            if row is None:
                toks[slot] = s.last_token     # host-known feed
            else:
                use_prev[slot] = True         # gather from in-flight buffer
                chain_idx[slot] = row
        c = d.chunk
        recs.append(c.seq.req)                # row max_slots: the chunk
        live = set(rids) | ({c.seq.req.rid} if d.sample_chunk else set())
        sp = self._sampling_rows(recs, live=live)
        for slot in d.decode_slots:
            # the stream position counts every token sampled so far,
            # including the in-flight one this dispatch feeds
            sp["counts"][slot] += sched.running[slot].speculated
        try:
            out = self._protected(
                rids + [c.seq.req.rid],
                lambda: self.runner.unified_step_chained(
                    prev.out if prev is not None else None,
                    chain_idx, use_prev, toks, sp, active,
                    c.seq.req.prompt, c.seq.block_ids, c.start, c.length))
        except PoisonedDispatchError:
            # bank the previous dispatch's (valid) tokens before recovery
            # requeues this batch, so the fold-and-replay stays exact
            self._collect_flight(outs)
            raise
        flight = _Flight(out=out, readback=Readback(out))
        sched.complete_chunk(c)
        self.metrics["prefill_chunks"] += 1
        self.metrics["prompt_tokens"] += c.length
        if d.decode_slots:
            self.metrics["decode_dispatches"] += 1
            self.metrics["decode_steps"] += 1
        # speculation bumps after the successful enqueue: every row whose
        # sample this dispatch's buffer carries
        for slot in d.decode_slots:
            s = sched.running[slot]
            sched.speculate(s)
            flight.decode_rows.append((slot, s))
            flight.source_row[id(s)] = slot
        if d.sample_chunk:
            sched.speculate(c.seq)
            flight.chunk_seq = c.seq
            flight.source_row[id(c.seq)] = self.max_slots
        return flight

    def _collect_flight(self, outs: List[RequestOutput]) -> None:
        """Read back the in-flight dispatch — the step's one blocking
        point, one step late — then reconcile and absorb its tokens.  A
        row whose Sequence finished, aborted, expired or was preempted
        during the flight is discarded with the dead record.  No-op with
        nothing in flight, so it doubles as the pipeline flush."""
        fl = self._flight
        if fl is None:
            return
        self._flight = None
        out_np = self._readback(fl.readback)
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        rows = list(fl.decode_rows)
        if fl.chunk_seq is not None:
            rows.append((self.max_slots, fl.chunk_seq))
        for row, s in rows:
            if s.req.finish_reason is not None \
                    or self.scheduler.running.get(s.slot) is not s:
                continue
            self.scheduler.reconcile(s)
            self._absorb(s, [int(out_np[row])], now, outs)

    def _prune_plan(self, plan: StepPlan) -> None:
        """Drop plan rows a pipeline flush invalidated: absorbing the
        in-flight tokens can finish a planned decode slot.  Chunks never
        die here (mid-prefill slots have no in-flight sample), and a freed
        slot's pending CoW copy lands in a block nothing reads before it
        is rewritten."""
        plan.decode_slots = [sl for sl in plan.decode_slots
                             if sl in self.scheduler.running]

    def _dispatch_fallback(self, plan: StepPlan,
                           outs: List[RequestOutput]) -> None:
        """The synchronous dispatch selection (also the async engine's
        fallback after a flush): unified one-dispatch mixed steps, else
        megastep + chunk walk (the two-call oracle when
        ``enable_unified_step=False``)."""
        if self.unified and plan.prefill and plan.horizon <= 1:
            self._dispatch_unified(plan, outs)
        else:
            self._dispatch_decode(plan, outs)
            if plan.prefill:
                self._run_prefill_chunks(plan.prefill, outs)

    # ------------------------------------------------------------ drive
    def step(self) -> List[RequestOutput]:
        """One engine iteration under the token budget; returns the
        ``RequestOutput`` deltas it produced.  Deadlines expire before
        planning; fault sites are consulted where the real failures would
        surface; a poisoned dispatch lands in recovery; the straggler
        watchdog observes every work step.  With ``enable_async_step`` the
        step is pipelined, so its events run one step behind the device
        and a step or two after the scheduler drains surfaces the tail
        (``stream`` / ``run_until_done`` / ``close`` handle that)."""
        with self.tracer.span("engine.step", cat="step"):
            if self._detok is not None:
                # what surfaces now was submitted before this step began
                n0 = self._detok.submitted
                tail = self._step_impl()
                outs = self._detok.collect_upto(n0) + tail
            else:
                outs = self._step_impl()
        self._update_gauges()
        return outs

    def _update_gauges(self) -> None:
        self._g_waiting.set(len(self.scheduler.waiting))
        self._g_running.set(len(self.scheduler.running))
        self._g_free_blocks.set(self.alloc.num_free)
        if self._straggler.ema is not None:
            self._g_step_ema.set(self._straggler.ema * 1e3)

    def _step_impl(self) -> List[RequestOutput]:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        outs: List[RequestOutput] = self._pending  # abort/shed events first
        self._pending = []
        alloc_blocked = False
        if self.faults is not None:
            self.faults.step_begin()
            alloc_blocked = self.faults.alloc_blocked()
        for req in self.scheduler.expire_deadlines():
            self.metrics["deadline_expired"] += 1
            self._emit(req, outs)
        self._advance_probe()
        d0 = self.runner.dispatches
        t_work = time.perf_counter()
        if self.faults is not None:
            stall = self.faults.stall_seconds()
            if stall:           # inside the timed window: the watchdog
                time.sleep(stall)  # must see the stall, like a real one
        try:
            for req in self.scheduler.finish_at_capacity():
                self._emit(req, outs)  # free slots/blocks before admission
            if not self.chunked:
                admitted = self.scheduler.try_admit(alloc_blocked)
                self._mark_admitted([s.req for s in admitted],
                                    time.perf_counter())
                if admitted:
                    self._run_prefill_oracle(admitted, outs)
                for req in self.scheduler.finish_at_capacity():
                    self._emit(req, outs)  # a fresh exactly-cap prefill
                if not self.scheduler.running:
                    return outs
                with self.tracer.span("plan", cat="host"):
                    plan = self._prepare_dispatch(
                        self.max_horizon if self.use_fused else 1)
                self._dispatch_decode(plan, outs)
                return outs
            with self.tracer.span("plan", cat="host"):
                plan = self.scheduler.plan_step(
                    self.max_num_batched_tokens,
                    max_horizon=self.max_horizon if self.use_fused else 1,
                    alloc_blocked=alloc_blocked)
            self._mark_admitted([c.seq.req for c in plan.prefill],
                                time.perf_counter())
            if self.async_step:
                ds = plan.unified_dispatches()
                if len(ds) == 1 and not plan.cow_pairs:
                    # the steady mixed state: enqueue this step's dispatch
                    # chained on the in-flight one, THEN read the previous
                    # step's tokens back while the new one runs
                    flight = self._enqueue_unified(ds[0], outs)
                    self._collect_flight(outs)
                    self._flight = flight
                    self.metrics["async_steps"] += 1
                else:
                    # leaving the pipelined regime: collect first (which
                    # may finish sequences the plan references), then the
                    # synchronous dispatch
                    if self._flight is not None:
                        self._collect_flight(outs)
                        self._prune_plan(plan)
                    self._dispatch_fallback(plan, outs)
            else:
                self._dispatch_fallback(plan, outs)
            if plan.used:
                self.metrics["plan_steps"] += 1
                self.metrics["budget_tokens_used"] += plan.used
            return outs
        except PoisonedDispatchError as e:
            self._recover(e, outs)
            return outs
        finally:
            used = self.runner.dispatches - d0
            if used:
                self.metrics["device_dispatches"] += used
                self.metrics["work_steps"] += 1
                # the first work step carries one-off set-up (kernel
                # loads, allocations): it would seed the EMA far too high
                if self.metrics["work_steps"] > 1:
                    verdict = self._straggler.observe(
                        int(self.metrics["work_steps"]),
                        time.perf_counter() - t_work)
                    if verdict != "ok":
                        self.metrics["slow_steps"] += 1
            # probation clears once every probed rid has left the waiting
            # queue through a clean dispatch
            if self._probing is not None:
                probe = set(self._probing)
                if not any(r.rid in probe for r in self.scheduler.waiting):
                    self._probing = None
                    self._advance_probe()

    def _work_pending(self) -> bool:
        """Drain condition: scheduler work, an un-collected dispatch, or
        detokenize-worker events not yet surfaced."""
        return self.scheduler.has_work() or self._flight is not None \
            or bool(self._detok is not None and self._detok.pending())

    def stream(self, max_steps: int = 100000) -> Iterator[RequestOutput]:
        """Yield ``RequestOutput`` deltas as steps complete; ``add`` may be
        called between events."""
        steps = 0
        while self._work_pending() and steps < max_steps:
            yield from self.step()
            steps += 1

    def run_until_done(self, max_steps: int = 10000) -> Dict[str, float]:
        steps = 0
        while self._work_pending() and steps < max_steps:
            self.step()
            steps += 1
        return self.report()

    # ------------------------------------------------------------ shutdown
    def close(self) -> List[RequestOutput]:
        """Read back any in-flight dispatch (banking its tokens), drain and
        join the detokenize worker, and return every event not yet
        surfaced through ``step()``.  Idempotent; ``with`` calls it."""
        outs: List[RequestOutput] = []
        try:
            self._collect_flight(outs)
        finally:
            if self._detok is not None:
                worker, self._detok = self._detok, None
                outs.extend(worker.close())
        if self._pending:
            outs = self._pending + outs
            self._pending = []
        return outs

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ telemetry
    def reset_dispatch_window(self) -> None:
        """Zero the dispatch counters so ``device_dispatches_per_step``
        covers only what follows."""
        self.metrics["device_dispatches"] = 0
        self.metrics["work_steps"] = 0

    def reset_itl_window(self) -> None:
        """Drop the inter-token-latency samples so ``report()``'s ITL
        percentiles cover only what follows (the histogram buckets keep
        the full history)."""
        self._h_itl.clear_samples()

    def attribution(self, window: int = 50) -> Dict[str, float]:
        """Host-vs-device wall time per work step over the last ``window``
        of them, from the span ring: ``device_ms`` is dispatch issue plus
        the readback wait, ``host_ms`` the rest of the step.  All-NaN
        (``steps == 0``) with telemetry off."""
        return attribute_steps(self.tracer.spans(), window=window)

    def _shared_snapshot(self) -> Dict[str, float]:
        """The fields ``report()`` and ``health()`` both expose."""
        m = self.metrics
        ema = self._straggler.ema
        return {
            "step_time_ema_ms": ema * 1e3 if ema is not None
            else float("nan"),
            "slow_steps": float(m["slow_steps"]),
            "dispatch_retries": float(m["dispatch_retries"]),
            "quarantined": float(m["quarantined"]),
            "shed": float(m["shed"]),
            "aborted": float(m["aborted"]),
            "deadline_expired": float(m["deadline_expired"]),
            "block_utilization": self.alloc.utilization(),
        }

    def health(self) -> Dict[str, float]:
        """O(1) liveness snapshot: queue depth, pool pressure and the
        robustness counters.  Never dispatches, never blocks."""
        return {
            "waiting": float(len(self.scheduler.waiting)),
            "running": float(len(self.scheduler.running)),
            "max_waiting": float(self.max_waiting)
            if self.max_waiting is not None else float("inf"),
            "free_blocks": float(self.alloc.num_free),
            "watermark_blocks": float(self.alloc.watermark),
            **self._shared_snapshot(),
            "probing_rids": float(len(self._probing or [])
                                  + sum(len(g) for g in self._suspects)),
        }

    def report(self) -> Dict[str, float]:
        t1 = time.perf_counter()
        wall = max(t1 - (self._t0 or t1), 1e-9)
        m = self.metrics
        fin = self.scheduler.finished
        n = len(fin)
        lat = float(np.mean([r.done_t - r.arrival for r in fin])) \
            if n else float("nan")
        ttft = float(np.mean([r.first_token_t - r.arrival for r in fin
                              if r.first_token_t is not None])) \
            if n else float("nan")
        d_steps = max(m["decode_steps"], 1)
        if m["decode_warm_steps"]:
            step_lat = m["decode_warm_time_s"] / m["decode_warm_steps"]
        else:
            step_lat = m["decode_time_s"] / d_steps
        plan_steps = m["plan_steps"]
        return {
            "latency_s": lat,
            "ttft_s": ttft,
            "ttft_p50_ms": self._h_ttft.percentile(50),
            "ttft_p99_ms": self._h_ttft.percentile(99),
            "itl_p50_ms": self._h_itl.percentile(50),
            "itl_p99_ms": self._h_itl.percentile(99),
            "queue_wait_p50_ms": self._h_queue_wait.percentile(50),
            "finished": float(n),
            "wall_s": wall,
            "throughput_req_s": n / wall,
            "throughput_tok_s": (m["prompt_tokens"] + m["gen_tokens"]) / wall,
            "generate_tok_s": m["gen_tokens"] / wall,
            "gen_tokens": m["gen_tokens"],
            "prompt_tokens": m["prompt_tokens"],
            "prefill_chunks": m["prefill_chunks"],
            "decode_steps": m["decode_steps"],
            "decode_dispatches": m["decode_dispatches"],
            "device_dispatches": m["device_dispatches"],
            "work_steps": m["work_steps"],
            "device_dispatches_per_step":
                m["device_dispatches"] / m["work_steps"]
                if m["work_steps"] else float("nan"),
            "budget_utilization":
                m["budget_tokens_used"]
                / (plan_steps * self.max_num_batched_tokens)
                if plan_steps else float("nan"),
            "preemptions": m["preemptions"],
            **self._shared_snapshot(),
            "blocks_reused": self.alloc.stats["reused"],
            "kv_pool_bytes": self.runner.kv_pool_bytes(),
            "kv_bytes_per_token": self.runner.kv_bytes_per_token(),
            "async_steps": m["async_steps"],
            "host_syncs": m["host_syncs"],
            "decode_step_latency_us": step_lat * 1e6,
            "syncs_per_decode_step": m["decode_dispatches"] / d_steps,
        }
