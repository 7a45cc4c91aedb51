"""Continuous-batching serving engine of the port (synchronous unified mode).

A thin conductor over the host ``Scheduler`` (admission, slots, blocks,
preemption, the per-iteration token budget — ported near verbatim) and
the device ``ModelRunner``.  Each iteration plans on the host, then
dispatches: a mixed plan (decodes interleaved with prefill chunks) runs
as unified dispatches — the first fuses the decode step, one prefill
chunk and every row's sampling, further chunks of an admission burst each
dispatch alone — and a pure-decode plan runs the fused decode megastep.
Tokens are read back once per iteration.

``enable_chunked_prefill=False`` keeps the JAX package's stop-the-world
behaviour, its parity oracle: admitted prompts prefill whole, in waves
padded to a ``prefill_bucket`` multiple (the static ``flash_attention``
kernel), then every running sequence decodes through the megastep.
Either mode serves the bf16 or the int8 KV pool (``kv_cache_dtype``).

Not ported yet, and refused with ``NotImplementedError``: the async
pipelined step (ROADMAP A6), the two-call and legacy per-token oracles,
fault injection, load shedding and telemetry (ROADMAP A10).
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence as SeqT

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_cache import BlockAllocator
from repro_torch.serving.model_runner import ModelRunner
from repro_torch.serving.params import (FINISH_ABORT, FINISH_ERROR,
                                        FINISH_LENGTH, FINISH_STOP,
                                        RequestOutput, SamplingParams)
from repro_torch.serving.scheduler import (PrefillChunk, RequestState,
                                           Scheduler, Sequence, StepPlan)

_MASK32 = 0xFFFFFFFF


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              f"({item})")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 num_blocks: int = 512, max_blocks_per_seq: int = 64,
                 prefill_bucket: int = 64, rt: Optional[dict] = None,
                 seed: int = 0,
                 use_fused: bool = True, max_horizon: int = 8,
                 detokenizer=None, kv_cache_dtype: str = "bf16",
                 max_num_batched_tokens: int = 256,
                 enable_chunked_prefill: bool = True,
                 enable_unified_step: bool = True,
                 enable_async_step: bool = False,
                 max_waiting: Optional[int] = None, fault_injector=None,
                 enable_telemetry: bool = False, device="cuda"):
        if enable_async_step:
            _refuse("the async pipelined step", "ROADMAP A6")
        if not (use_fused and enable_unified_step):
            _refuse("the two-call / legacy per-token oracles", "ROADMAP A5")
        if fault_injector is not None:
            _refuse("fault injection", "ROADMAP A5")
        if max_waiting is not None:
            _refuse("load shedding (max_waiting)", "ROADMAP A5")
        if enable_telemetry:
            _refuse("telemetry", "ROADMAP A10")
        dev = resolve_device(device)
        params = tree_to(params, dev)
        self.cfg = cfg
        self.max_slots = max_slots
        self.mb = max_blocks_per_seq
        self.prefill_bucket = prefill_bucket
        self.max_horizon = max(1, max_horizon)
        self.detokenizer = detokenizer
        self.seed = seed
        self.metrics: Dict[str, float] = {
            "prompt_tokens": 0, "gen_tokens": 0, "preemptions": 0,
            "host_syncs": 0, "decode_dispatches": 0, "decode_steps": 0,
            "truncated_prompts": 0, "prefill_chunks": 0, "plan_steps": 0,
            "budget_tokens_used": 0, "device_dispatches": 0,
            "work_steps": 0, "quarantined": 0, "aborted": 0,
            "deadline_expired": 0}
        alloc = BlockAllocator(
            num_blocks, cfg.paging.block_size,
            enable_prefix_reuse=cfg.paging.enable_prefix_reuse,
            watermark_frac=cfg.paging.watermark_frac)
        self.scheduler = Scheduler(alloc, max_slots=max_slots,
                                   max_blocks_per_seq=max_blocks_per_seq,
                                   metrics=self.metrics)
        # every config the port serves keeps its prefill state in the
        # paged pool (transformer._require_dense), so any of them may chunk
        self.chunked = bool(enable_chunked_prefill)
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
        # a row with non-finite logits samples -1 and is quarantined
        rt = dict(rt or {}, sampling_guard=True)
        self.runner = ModelRunner(cfg, params, max_slots=max_slots,
                                  num_blocks=num_blocks,
                                  max_blocks_per_seq=max_blocks_per_seq,
                                  rt=rt, max_horizon=self.max_horizon,
                                  kv_cache_dtype=kv_cache_dtype,
                                  chunk_tokens=chunk_tokens)
        self.kv_cache_dtype = self.runner.kv_cache_dtype
        self._t0: Optional[float] = None
        self._next_rid = 0
        self._pending: List[RequestOutput] = []

    # ---------------------------------------------------- facade views
    @property
    def alloc(self) -> BlockAllocator:
        return self.scheduler.alloc

    # ------------------------------------------------------------ intake
    def _base_key(self, rid: int, sp: SamplingParams) -> np.ndarray:
        """Per-request stream root: an explicit seed wins, else one derived
        from (engine seed, request id)."""
        if sp.seed is not None:
            return np.array([0x80000000 | ((sp.seed >> 32) & 0x7FFFFFFF),
                             sp.seed & _MASK32], np.uint32)
        return np.array([self.seed & 0x7FFFFFFF, rid & _MASK32], np.uint32)

    def add(self, prompt: SeqT[int],
            sampling_params: Optional[SamplingParams] = None,
            request_id: Optional[int] = None) -> int:
        """Queue a request (allowed while streaming); returns its id."""
        sp = sampling_params or SamplingParams()
        rid = self._next_rid if request_id is None else request_id
        self._next_rid = max(self._next_rid, rid) + 1
        self.scheduler.add(RequestState(rid=rid, prompt=list(prompt),
                                        sampling=sp,
                                        base_key=self._base_key(rid, sp)))
        return rid

    def abort(self, request_id: int) -> bool:
        """Cancel a request wherever it is; its blocks and slot are freed
        now and its finish event surfaces with the next ``step()``."""
        req = self.scheduler.abort(request_id, FINISH_ABORT)
        if req is None:
            return False
        self.metrics["aborted"] += 1
        self._emit(req, self._pending)
        return True

    # ------------------------------------------------------------ outputs
    def _emit(self, req: RequestState, outs: List[RequestOutput]) -> None:
        new = list(req.output[req.emitted:])
        finished = req.finish_reason is not None
        if not new and not finished:
            return
        text = new_text = ""
        if self.detokenizer is not None:
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
        request.  Finishing frees its KV blocks at once."""
        req = s.req
        for tok in toks:
            if int(tok) < 0:
                self.metrics["quarantined"] += 1
                self.scheduler.finish(s, FINISH_ERROR)
                break
            req.output.append(int(tok))
            s.last_token = int(tok)
            s.seq_len += 1
            self.metrics["gen_tokens"] += 1
            if req.first_token_t is None:
                req.first_token_t = now
            if int(tok) in req.sampling.stop:
                self.scheduler.finish(s, FINISH_STOP)
                break
            if req.tokens_remaining() <= 0:
                self.scheduler.finish(s, FINISH_LENGTH)
                break
        self._emit(req, outs)

    # ------------------------------------------------------------ sampling
    def _sampling_rows(self, recs: List[Optional[RequestState]]
                       ) -> Dict[str, np.ndarray]:
        """Per-request SamplingParams stacked into padded host rows."""
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
        return arr

    def _slot_sampling(self) -> Dict[str, np.ndarray]:
        recs: List[Optional[RequestState]] = [None] * self.max_slots
        for slot, s in self.scheduler.running.items():
            recs[slot] = s.req
        return self._sampling_rows(recs)

    def _readback(self, out: torch.Tensor) -> np.ndarray:
        """The host<->device sync boundary of a step."""
        return out.cpu().numpy()

    # ------------------------------------------------------------ dispatch
    def _run_prefill_oracle(self, seqs: List[Sequence],
                            outs: List[RequestOutput]) -> None:
        """Stop-the-world wave prefill (``enable_chunked_prefill=False``):
        the whole wave, padded to a ``prefill_bucket`` multiple, in one
        dispatch, then its first tokens sampled in one call."""
        b = self.prefill_bucket
        maxlen = max(s.seq_len for s in seqs)
        maxlen = min(((maxlen + b - 1) // b) * b, self.scheduler.cap_tokens)
        logits = self.runner.prefill(seqs, maxlen)
        # register-on-write: the wave's device write is issued, so its
        # full prompt blocks become content-addressable
        for s in seqs:
            self.scheduler.register_written(s)
        self.metrics["prompt_tokens"] += sum(s.seq_len for s in seqs)
        nxt = self.runner.sample(logits, self._sampling_rows(
            [s.req for s in seqs]))
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        for i, s in enumerate(seqs):
            self._absorb(s, [int(nxt[i])], now, outs)
        # leave the device tables consistent with the host bookkeeping
        self.runner.sync_tables(self.scheduler.running)

    def _prepare_dispatch(self, horizon: int) -> StepPlan:
        """Whole-prompt mode's planning: horizon and block growth for all
        running (= all decodable) sequences, as one decode-only plan."""
        h = self.scheduler.plan_horizon(horizon)
        cow = self.scheduler.grow_for_horizon(h) if h else []
        return StepPlan(decode_slots=sorted(self.scheduler.decodable())
                        if h else [], horizon=h, cow_pairs=cow,
                        prefill=[], budget=0)

    def _run_prefill_chunks(self, chunks: List[PrefillChunk],
                            outs: List[RequestOutput]) -> None:
        """Chunks that ride no decode step: each runs alone, then the
        prompts completing here sample their first token in one call."""
        final = []
        for c in chunks:
            logits = self.runner.prefill_chunk(c.seq, c.start, c.length)
            self.scheduler.complete_chunk(c)
            self.metrics["prefill_chunks"] += 1
            self.metrics["prompt_tokens"] += c.length
            if c.last:
                final.append((c.seq, logits))
        if not final:
            return
        nxt = self.runner.sample(
            torch.cat([lg for _, lg in final], 0),
            self._sampling_rows([s.req for s, _ in final]))
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        for i, (s, _) in enumerate(final):
            self._absorb(s, [int(nxt[i])], now, outs)

    def _dispatch_decode(self, plan: StepPlan,
                         outs: List[RequestOutput]) -> None:
        """A pure-decode plan: the fused megastep over the planned horizon.
        Only the plan's slots are active (everything else gets seq_len 0,
        so the decode KV scatter drops its writes)."""
        if not plan.decode_slots:
            return
        if plan.cow_pairs:
            self.runner.copy_cow(plan.cow_pairs)
        self.runner.sync_tables({slot: self.scheduler.running[slot]
                                 for slot in plan.decode_slots})
        toks = np.zeros((self.max_slots,), np.int32)
        active = np.zeros((self.max_slots,), bool)
        for slot in plan.decode_slots:
            toks[slot] = self.scheduler.running[slot].last_token
            active[slot] = True
        out_np = self.runner.megastep(toks, self._slot_sampling(), active,
                                      plan.horizon)
        self.metrics["host_syncs"] += 1
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps"] += plan.horizon
        now = time.perf_counter()
        for slot in plan.decode_slots:
            self._absorb(self.scheduler.running[slot],
                         out_np[:, slot].tolist(), now, outs)

    def _dispatch_unified(self, plan: StepPlan,
                          outs: List[RequestOutput]) -> None:
        """A mixed plan as unified dispatches; every dispatch is in flight
        before the step's one readback."""
        if plan.cow_pairs:
            self.runner.copy_cow(plan.cow_pairs)
        done = []
        for d in plan.unified_dispatches():
            self.runner.sync_tables({slot: self.scheduler.running[slot]
                                     for slot in d.decode_slots})
            toks = np.zeros((self.max_slots,), np.int32)
            active = np.zeros((self.max_slots,), bool)
            recs: List[Optional[RequestState]] = [None] * self.max_slots
            for slot in d.decode_slots:
                toks[slot] = self.scheduler.running[slot].last_token
                active[slot] = True
                recs[slot] = self.scheduler.running[slot].req
            c = d.chunk
            recs.append(c.seq.req)              # row max_slots: the chunk
            out = self.runner.unified_step(
                toks, self._sampling_rows(recs), active, c.seq.req.prompt,
                c.seq.block_ids, c.start, c.length)
            done.append((d, out))
            self.scheduler.complete_chunk(c)
            self.metrics["prefill_chunks"] += 1
            self.metrics["prompt_tokens"] += c.length
            if d.decode_slots:
                self.metrics["decode_dispatches"] += 1
                self.metrics["decode_steps"] += 1
        if not done:
            return
        self.metrics["host_syncs"] += 1
        now = time.perf_counter()
        for d, out in done:
            out_np = self._readback(out)
            for slot in d.decode_slots:
                self._absorb(self.scheduler.running[slot],
                             [int(out_np[slot])], now, outs)
            if d.sample_chunk:
                self._absorb(d.chunk.seq, [int(out_np[self.max_slots])],
                             now, outs)

    def _dispatch(self, plan: StepPlan, outs: List[RequestOutput]) -> None:
        """Unified one-dispatch mixed steps, else megastep + chunk walk."""
        if plan.prefill and plan.horizon <= 1:
            self._dispatch_unified(plan, outs)
        else:
            self._dispatch_decode(plan, outs)
            if plan.prefill:
                self._run_prefill_chunks(plan.prefill, outs)

    # ------------------------------------------------------------ drive
    def step(self) -> List[RequestOutput]:
        """One engine iteration under the token budget; returns the
        ``RequestOutput`` deltas it produced."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        outs, self._pending = self._pending, []
        for req in self.scheduler.expire_deadlines():
            self.metrics["deadline_expired"] += 1
            self._emit(req, outs)
        d0 = self.runner.dispatches
        try:
            for req in self.scheduler.finish_at_capacity():
                self._emit(req, outs)
            if not self.chunked:
                self._step_whole_prompt(outs)
                return outs
            plan = self.scheduler.plan_step(self.max_num_batched_tokens,
                                            max_horizon=self.max_horizon)
            self._dispatch(plan, outs)
            if plan.used:
                self.metrics["plan_steps"] += 1
                self.metrics["budget_tokens_used"] += plan.used
        finally:
            used = self.runner.dispatches - d0
            if used:
                self.metrics["device_dispatches"] += used
                self.metrics["work_steps"] += 1
        return outs

    def _step_whole_prompt(self, outs: List[RequestOutput]) -> None:
        """One iteration of the whole-prompt mode: admit and prefill a
        wave, then a decode megastep for every running sequence."""
        admitted = self.scheduler.try_admit()
        if admitted:
            self._run_prefill_oracle(admitted, outs)
        for req in self.scheduler.finish_at_capacity():
            self._emit(req, outs)          # a fresh exactly-cap prefill
        if self.scheduler.running:
            self._dispatch_decode(self._prepare_dispatch(self.max_horizon),
                                  outs)

    def stream(self, max_steps: int = 100000) -> Iterator[RequestOutput]:
        steps = 0
        while (self.scheduler.has_work() or self._pending) \
                and steps < max_steps:
            yield from self.step()
            steps += 1

    def run_until_done(self, max_steps: int = 10000) -> Dict[str, float]:
        steps = 0
        while (self.scheduler.has_work() or self._pending) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.report()

    def close(self) -> List[RequestOutput]:
        """Return the events not yet surfaced (the synchronous engine has
        no pipeline to flush)."""
        outs, self._pending = self._pending, []
        return outs

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def report(self) -> Dict[str, float]:
        t1 = time.perf_counter()
        wall = max(t1 - (self._t0 or t1), 1e-9)
        m = self.metrics
        fin = self.scheduler.finished
        return {
            "finished": float(len(fin)),
            "wall_s": wall,
            "throughput_tok_s": (m["prompt_tokens"] + m["gen_tokens"]) / wall,
            "generate_tok_s": m["gen_tokens"] / wall,
            "gen_tokens": m["gen_tokens"],
            "prompt_tokens": m["prompt_tokens"],
            "prefill_chunks": m["prefill_chunks"],
            "decode_steps": m["decode_steps"],
            "decode_dispatches": m["decode_dispatches"],
            "device_dispatches": m["device_dispatches"],
            "work_steps": m["work_steps"],
            "host_syncs": m["host_syncs"],
            "device_dispatches_per_step":
                m["device_dispatches"] / m["work_steps"]
                if m["work_steps"] else float("nan"),
            "preemptions": m["preemptions"],
            "blocks_reused": self.alloc.stats["reused"],
            "kv_pool_bytes": self.runner.kv_pool_bytes(),
        }
