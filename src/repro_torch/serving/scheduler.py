"""Host-side continuous-batching scheduler (no device, no tensors).

Owns everything the engine decides *about* — admission (watermark +
prompt clamping), slot assignment, block accounting against the
ref-counted ``BlockAllocator``, recompute-style preemption, capacity
force-finishing, and fused-horizon planning — and nothing the device
computes.  ``ModelRunner`` owns the other half.  The split makes every
scheduling policy unit-testable with a plain allocator and fake token
lists (``tests/test_scheduler.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.paged_cache import BlockAllocator
from repro_torch.serving.params import (FINISH_CAPACITY, FINISH_DEADLINE,
                                  SamplingParams)


@dataclass
class RequestState:
    """Internal per-request record (host bookkeeping, shared output list).

    ``prompt`` is the *recompute* prompt: preemption folds generated
    tokens into it so re-admission replays them through prefill.
    ``prompt_len0`` keeps the original prompt length for reporting.
    """
    rid: int
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival: float = 0.0
    output: List[int] = field(default_factory=list)
    first_token_t: Optional[float] = None
    admitted_t: Optional[float] = None    # first admission (queue-wait mark)
    done_t: Optional[float] = None
    finish_reason: Optional[str] = None
    emitted: int = 0               # tokens already surfaced via RequestOutput
    folded: int = 0                # output tokens already folded into prompt
    prompt_len0: int = 0
    base_key: Optional[np.ndarray] = None   # [2] uint32 PRNG stream root
    shim: Optional[object] = None  # legacy Request to mirror timestamps to
    text: str = ""                 # detokenized output accumulated so far
    last_event_t: Optional[float] = None  # previous token-bearing event (ITL)

    @property
    def prompt_token_ids(self) -> List[int]:
        return self.prompt[:self.prompt_len0 or len(self.prompt)]

    def tokens_remaining(self) -> int:
        return self.sampling.max_tokens - len(self.output)


@dataclass
class Sequence:
    """A running request bound to a decode slot + physical KV blocks.

    ``computed_len`` tracks how much of the prompt has been prefilled
    into the KV pool; while ``computed_len < len(req.prompt)`` the
    sequence is mid-prefill (chunked admission) and must not decode.
    Whole-prompt admission sets it to the full prompt length up front.
    """
    req: RequestState
    slot: int
    block_ids: List[int]
    seq_len: int                   # tokens in cache (incl. last fed)
    last_token: int
    computed_len: int = 0          # prompt tokens already in the KV pool
    hashed_blocks: int = 0         # full blocks already content-addressed
    # tokens sampled by an in-flight dispatch the host has not read back
    # yet (async pipelined engine; see Scheduler.speculate/reconcile).
    # Each one is counted into seq_len — the NEXT dispatch feeds it and
    # writes its KV — but not yet into req.output.
    speculated: int = 0

    @property
    def prefilling(self) -> bool:
        return self.computed_len < len(self.req.prompt)


@dataclass
class PrefillChunk:
    """One ``(sequence, chunk_start, chunk_len)`` prefill assignment."""
    seq: Sequence
    start: int                     # == seq.computed_len at planning time
    length: int

    @property
    def last(self) -> bool:
        return self.start + self.length >= len(self.seq.req.prompt)


@dataclass
class UnifiedDispatch:
    """One device dispatch of a unified-mode engine iteration.

    ``decode_slots`` are the rows whose decode sample the host absorbs
    (the unified executable always computes all ``max_slots`` rows; only
    these are live).  ``chunk`` is the dispatch's single prefill chunk.
    ``sample_chunk`` marks the chunk row (row ``max_slots`` of the
    output buffer) as carrying the prompt's first sampled token.
    """
    decode_slots: List[int]
    chunk: PrefillChunk
    sample_chunk: bool


@dataclass
class StepPlan:
    """One token-budget engine iteration, planned entirely on the host.

    ``decode_slots`` decode ``horizon`` tokens each (blocks already
    grown, ``cow_pairs`` pending on device); ``prefill`` chunks run
    after, newest admissions included.  ``used <= budget`` always.
    """
    decode_slots: List[int]
    horizon: int
    cow_pairs: List[tuple]
    prefill: List[PrefillChunk]
    budget: int

    @property
    def used(self) -> int:
        return (len(self.decode_slots) * self.horizon
                + sum(c.length for c in self.prefill))

    def unified_dispatches(self) -> List[UnifiedDispatch]:
        """The plan's unified-dispatch layout (deviceless, unit-testable).

        The FIRST dispatch fuses the step's decodes with the first
        prefill chunk (the single-dispatch steady state of a mixed
        workload: the planner emits at most one chunk per step while
        decodes are interleaving); any further chunks — bursts of fresh
        admissions — each get their own chunk-only dispatch, in plan
        order, with no decode rows.  Empty when the plan has no prefill
        (a pure-decode plan dispatches the fused megastep instead) or
        when the horizon exceeds 1 (never the case when prefill is
        pending — the planner pins it).
        """
        if not self.prefill or self.horizon > 1:
            return []
        return [UnifiedDispatch(
            decode_slots=list(self.decode_slots) if i == 0 else [],
            chunk=c, sample_chunk=c.last)
            for i, c in enumerate(self.prefill)]


class Scheduler:
    """Admission / preemption / horizon planning over a fixed slot set.

    Policies (unchanged from the monolithic engine):
    * prompts longer than the per-sequence KV capacity are clamped at
      admission (an exactly-cap prompt still prefills and yields one
      token before force-finishing), except on a ring stack, whose ring
      prefill keeps the last ring's worth of a longer prompt itself;
    * admission is watermark-gated on free blocks, FIFO over ``waiting``;
    * out-of-blocks preempts the *youngest* running sequence back to the
      queue head with its generated tokens folded into the prompt
      (recompute-style, like vLLM);
    * ``plan_horizon`` returns steps-until-boundary: the longest horizon
      every running sequence can decode without host intervention;
    * ``ring_only`` (a sliding-window stack): each sequence owns all
      ``max_blocks_per_seq`` blocks of its row from admission to finish,
      private (no prefix lookup, no registration), because its ring
      cache addresses the whole row and overwrites it as it wraps; it
      never grows, and never reaches a capacity boundary.
    """

    def __init__(self, alloc: BlockAllocator, *, max_slots: int,
                 max_blocks_per_seq: int, ring_only: bool = False,
                 metrics: Optional[Dict[str, float]] = None):
        self.alloc = alloc
        self.max_slots = max_slots
        self.mb = max_blocks_per_seq
        self.ring_only = ring_only
        self.metrics = metrics if metrics is not None else {
            "preemptions": 0, "truncated_prompts": 0}
        self.metrics.setdefault("preemptions_mid_prefill", 0)
        self.waiting: List[RequestState] = []
        self.running: Dict[int, Sequence] = {}
        self.finished: List[RequestState] = []
        self.free_slots = list(range(max_slots - 1, -1, -1))
        # hard per-sequence KV capacity: the block table is mb entries wide
        self.cap_tokens = self.mb * self.alloc.block_size
        # admission allow-set: None admits everyone (the normal state);
        # a set restricts admission to those rids — the engine's
        # poisoned-dispatch bisection probes suspects in isolation while
        # cleared requests keep flowing
        self.allowed_rids: Optional[Set[int]] = None

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ intake
    def add(self, req: RequestState) -> None:
        if not req.arrival:
            req.arrival = time.perf_counter()
        if not req.prompt_len0:
            req.prompt_len0 = len(req.prompt)
        self.waiting.append(req)

    # ------------------------------------------------------------ admission
    def _clamp_prompt(self, req: RequestState) -> None:
        """Prompts longer than the per-sequence KV capacity are clamped at
        admission instead of crashing the prefill scatter.  Requeued
        preempted sequences — whose prompt+output never exceeds cap — are
        never clamped and keep their full context.  A ring sequence can
        outgrow cap (its ring wraps), so neither its fresh prompt nor its
        replay is clamped: ring prefill keeps the last cap tokens itself.
        (The JAX scheduler clamps a fresh ring prompt to its head, and
        then answers a different prompt: ROADMAP C17.)"""
        if self.ring_only:
            return
        if len(req.prompt) > self.cap_tokens:
            req.prompt = req.prompt[:self.cap_tokens]
            # keep prompt_token_ids == the prompt actually served, so
            # a later preemption fold is never reported as prompt
            req.prompt_len0 = min(req.prompt_len0, self.cap_tokens)
            self.metrics["truncated_prompts"] += 1

    def _admissible_index(self) -> Optional[int]:
        """Index of the first waiting request the allow-set admits (FIFO
        among admissible; held-back requests are skipped, not overtaken
        — with no allow-set this is simply the queue head)."""
        if self.allowed_rids is None:
            return 0 if self.waiting else None
        for i, req in enumerate(self.waiting):
            if req.rid in self.allowed_rids:
                return i
        return None

    def try_admit(self, alloc_blocked: bool = False) -> List[Sequence]:
        """Whole-prompt admission (the stop-the-world parity oracle):
        admit FIFO while slots and (watermarked) blocks allow; returns
        the newly admitted sequences — the caller must prefill them.
        ``alloc_blocked`` simulates allocator exhaustion (fault
        injection): no admission this step.

        Blocks are content-addressed eagerly so requests admitted in the
        same wave share their common prefix.  Safe under faults: a
        reusing prompt always *rewrites* the shared block bit-identically
        rather than trusting its contents, and every failure path this
        engine has (abort, deadline, shed, poisoned-dispatch requeue)
        frees the blocks, which drops their hash entries at refcount 0 —
        no stale prefix-cache entry survives a failed wave."""
        admitted: List[Sequence] = []
        while self.free_slots and not alloc_blocked:
            idx = self._admissible_index()
            if idx is None:
                break
            req = self.waiting[idx]
            self._clamp_prompt(req)
            if self.ring_only:
                need = self.mb                   # the whole ring, private
            else:
                need = (len(req.prompt) + self.alloc.block_size - 1) \
                    // self.alloc.block_size + 1
            if not self.alloc.can_allocate(need):
                break
            self.waiting.pop(idx)
            if self.ring_only:
                block_ids = self.alloc.allocate_private(self.mb)
            else:
                block_ids, _reused = self.alloc.allocate_prompt(req.prompt)
            slot = self.free_slots.pop()
            seq = Sequence(req=req, slot=slot, block_ids=block_ids,
                           seq_len=len(req.prompt), last_token=req.prompt[-1],
                           computed_len=len(req.prompt),
                           hashed_blocks=len(req.prompt)
                           // self.alloc.block_size)
            self.running[slot] = seq
            admitted.append(seq)
        return admitted

    def register_written(self, s: Sequence) -> None:
        """Content-address any full prompt block not yet hashed (no-op
        after eager admission registration; kept as the engine's
        post-write invariant hook for the whole-prompt oracle — the
        chunked path's equivalent is ``complete_chunk``).  Ring blocks
        are private and never registered."""
        if self.ring_only:
            return
        bs = self.alloc.block_size
        full = min(s.computed_len, len(s.req.prompt)) // bs
        for i in range(s.hashed_blocks, full):
            self.alloc.register_full_block(s.block_ids[i],
                                           s.req.prompt[:(i + 1) * bs])
        s.hashed_blocks = max(s.hashed_blocks, full)

    # ------------------------------------------------------------ capacity
    def writes_left(self, s: Sequence) -> int:
        """Tokens the sequence can still decode before its block table is
        full (next write position is seq_len - 1)."""
        if self.ring_only:
            return 10 ** 9                        # ring slots wrap forever
        return self.cap_tokens - (s.seq_len - 1)

    def finish(self, s: Sequence, reason: str) -> RequestState:
        s.req.done_t = time.perf_counter()
        s.req.finish_reason = reason
        self.finished.append(s.req)
        self.alloc.free_sequence(s.block_ids)
        del self.running[s.slot]
        self.free_slots.append(s.slot)
        return s.req

    def finish_at_capacity(self) -> List[RequestState]:
        """Force-finish sequences whose next KV write would overflow the
        block table (output truncated, finish_reason "capacity")."""
        done = []
        for slot in list(self.running):
            s = self.running[slot]
            if self.writes_left(s) <= 0 and not s.speculated:
                # a speculated slot at the capacity wall still has its
                # last token in flight: finishing now would discard it
                # (the synchronous engine absorbs that token *before*
                # this check runs).  The slot is decode-ineligible
                # (``decodable`` filters it), its token lands at the
                # next reconcile, and THIS check force-finishes it one
                # step later — same final output, token kept.
                done.append(self.finish(s, FINISH_CAPACITY))
        return done

    # ------------------------------------------------------------ deadlines
    def _deadline_hit(self, req: RequestState, now: float) -> bool:
        sp = req.sampling
        elapsed_ms = (now - req.arrival) * 1e3
        if sp.deadline_ms is not None and elapsed_ms > sp.deadline_ms:
            return True
        return (sp.ttft_deadline_ms is not None
                and req.first_token_t is None
                and elapsed_ms > sp.ttft_deadline_ms)

    def expire_deadlines(self) -> List[RequestState]:
        """Finish every request past its deadline (finish_reason
        "deadline"), wherever it is in the lifecycle: still waiting
        (just dequeued — it holds nothing), mid-prefill-chunk or decoding
        (KV blocks and slot released this step).  Partial output is
        kept."""
        now = time.perf_counter()
        done: List[RequestState] = []
        for req in [r for r in self.waiting if self._deadline_hit(r, now)]:
            self.waiting.remove(req)
            req.done_t = now
            req.finish_reason = FINISH_DEADLINE
            self.finished.append(req)
            done.append(req)
        for slot in list(self.running):
            s = self.running[slot]
            if self._deadline_hit(s.req, now):
                done.append(self.finish(s, FINISH_DEADLINE))
        return done

    # ------------------------------------------------------------ abort
    def abort(self, rid: int, reason: str) -> Optional[RequestState]:
        """Cancel a request by id, wherever it is: waiting (dequeued),
        mid-prefill-chunk or decoding (blocks + slot freed the same
        step, including partially-grown chunk blocks — ``block_ids``
        always reflects every grow).  Returns the finished record, or
        None if the rid is unknown / already finished."""
        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                req.done_t = time.perf_counter()
                req.finish_reason = reason
                self.finished.append(req)
                return req
        for s in self.running.values():
            if s.req.rid == rid:
                return self.finish(s, reason)
        return None

    # ------------------------------------------------------------ preemption
    def _requeue(self, slot: int) -> RequestState:
        """Recompute-style requeue of a running sequence: free its KV
        blocks + slot, fold generated tokens into the prompt, and put it
        back at the queue head — re-admission replays everything through
        prefill (token-exact: the sampling stream position survives via
        ``counts``)."""
        s = self.running.pop(slot)
        self.alloc.free_sequence(s.block_ids)
        self.free_slots.append(slot)
        self.metrics["preemptions"] += 1
        if s.prefilling:
            # partially-computed prompt: blocks freed, and because the
            # Sequence record dies here, re-admission restarts the chunk
            # walk from computed_len = 0 (recompute-style, like decode)
            self.metrics["preemptions_mid_prefill"] += 1
        # recompute-style preemption: requeue with prompt+generated prefix.
        # ``folded`` tracks how much of ``output`` a previous preemption
        # already folded in, so a second preemption replaces that suffix
        # instead of appending the generated tokens twice.
        base = len(s.req.prompt) - s.req.folded
        s.req.prompt = list(s.req.prompt[:base]) + list(s.req.output)
        s.req.folded = len(s.req.output)
        self.waiting.insert(0, s.req)
        return s.req

    def preempt_youngest(self) -> RequestState:
        slot = max(self.running,
                   key=lambda sl: self.running[sl].req.arrival)
        return self._requeue(slot)

    def preempt_request(self, rid: int) -> Optional[RequestState]:
        """Targeted recompute-style requeue (the poisoned-dispatch
        recovery path): same machinery as ``preempt_youngest``, aimed at
        one request.  None if the rid is not currently running."""
        for slot, s in self.running.items():
            if s.req.rid == rid:
                return self._requeue(slot)
        return None

    # ------------------------------------------------------------ speculation
    def speculate(self, s: Sequence) -> None:
        """Mark one sampled-but-not-read-back token on ``s`` (async
        pipelined engine, at dispatch enqueue): the token is counted
        into ``seq_len`` immediately — the next dispatch feeds it and
        writes its KV at ``seq_len - 1``, so every planner position
        computation (block growth, writes_left, capacity) sees exactly
        the state the synchronous engine would after absorbing it —
        while ``speculated`` remembers it is not yet in ``req.output``
        (``decodable``/``plan_horizon`` subtract it from the tokens-
        remaining budget: plan as if no slot finishes)."""
        s.seq_len += 1
        s.speculated += 1

    def reconcile(self, s: Sequence) -> None:
        """Retire one speculated token at readback (just before the
        engine absorbs it): the absorb path re-increments ``seq_len``
        itself, so the speculative bump is unwound here and absorb stays
        the single source of truth for output/stop/finish bookkeeping.
        A sequence that finished, aborted, or was preempted mid-flight
        is never reconciled — its Sequence record (and the speculative
        bump with it) is already gone and the in-flight token is simply
        discarded."""
        s.seq_len -= 1
        s.speculated -= 1

    # ------------------------------------------------------------ horizon
    def decodable(self) -> Dict[int, Sequence]:
        """Running sequences whose prompt is fully in the KV pool — the
        only ones a decode dispatch may touch (mid-prefill sequences hold
        their slot and blocks but contribute no decode work).  Slots
        whose in-flight speculated token already exhausts their
        max_tokens budget or their block table sit out too: planning
        them would decode past the boundary the synchronous engine
        finishes at.  Both extra filters are scoped to speculated slots
        so non-speculating callers (the synchronous engine, the oracle
        path, standalone planner tests) see the historical behavior
        unchanged — there absorb and finish_at_capacity retire such
        slots before planning ever sees them."""
        return {sl: s for sl, s in self.running.items()
                if not s.prefilling
                and (not s.speculated
                     or (s.req.tokens_remaining() - s.speculated > 0
                         and self.writes_left(s) > 0))}

    def plan_horizon(self, max_horizon: int) -> int:
        """steps_until_boundary: the longest horizon every decodable
        sequence can decode without host intervention — bounded by tokens
        remaining (finish boundary, minus any in-flight speculated
        token) and by free KV blocks (allocation boundary).  Preempts
        the youngest *running* sequence (possibly a mid-prefill one) if
        even a single step cannot fit."""
        while True:
            dec = list(self.decodable().values())
            if not dec:
                return 0
            h = min(max_horizon,
                    min(min(s.req.tokens_remaining() - s.speculated,
                            self.writes_left(s))
                        for s in dec))
            h = max(1, h)
            if self.ring_only:
                return h
            while h >= 1:
                need = sum(
                    self.alloc.blocks_needed(s.block_ids, s.seq_len - 1, h)
                    for s in dec)
                if need <= self.alloc.num_free:
                    return h
                h -= 1                   # linear: blocks_needed is monotone
            self.preempt_youngest()

    def grow_for_horizon(self, h: int) -> List[tuple]:
        """Pre-allocate every KV block an ``h``-step horizon will touch
        (cannot raise: ``plan_horizon`` budgeted it). Returns the CoW
        (src, dst) block pairs the device must copy."""
        cow_pairs = []
        if self.ring_only:
            return cow_pairs                     # ring cache: fixed blocks
        for slot in sorted(self.decodable()):
            s = self.running[slot]
            pos = s.seq_len - 1                  # position the next write hits
            s.block_ids, cow = self.alloc.grow(s.block_ids, pos, h)
            if cow is not None:
                cow_pairs.append(cow)
        return cow_pairs

    # ------------------------------------------------------------ step plan
    def _pool_feasible(self, req: RequestState) -> bool:
        """Whether the (clamped) prompt could EVER fit this pool whole —
        the same bound whole-prompt admission enforces.  Infeasible
        prompts stay waiting without blocking anything else."""
        n = min(len(req.prompt), self.cap_tokens)
        return -(-n // self.alloc.block_size) + 1 \
            <= self.alloc.num_blocks - self.alloc.watermark

    def _chunk_fit(self, block_ids: List[int], start: int, want: int) -> int:
        """Largest chunk length <= ``want`` whose KV blocks fit the free
        pool right now (prefill chunks never CoW: a chunk's boundary block
        is either this sequence's private partial tail or a fresh block)."""
        bs = self.alloc.block_size
        slack = len(block_ids) * bs - start      # room in allocated blocks
        return min(want, max(0, slack) + self.alloc.num_free * bs)

    def _prefill_runnable(self, alloc_blocked: bool = False) -> bool:
        """Whether at least one prefill chunk could actually be scheduled
        THIS step — the only case worth pinning the decode horizon to 1
        for.  A mid-prefill sequence must have room for >= 1 token; a
        waiting prompt additionally needs a free slot, a pool it can
        ever fit, and watermarked headroom right now.  Anything else
        (full slots, zero headroom, forever-infeasible head, a blocked
        allocator) cannot progress regardless, so decodes keep the full
        fused horizon."""
        if alloc_blocked:
            return False
        for s in self.running.values():
            if s.prefilling and \
                    self._chunk_fit(s.block_ids, s.computed_len, 1) > 0:
                return True
        idx = self._admissible_index()
        return bool(idx is not None and self.free_slots
                    and self._pool_feasible(self.waiting[idx])
                    and self.alloc.num_free > self.alloc.watermark)

    def plan_step(self, max_num_batched_tokens: int,
                  max_horizon: int = 1,
                  alloc_blocked: bool = False) -> StepPlan:
        """Fill one token budget: running decodes first (decode-priority,
        so inter-token latency stays bounded), then prefill *chunks* of
        partially-admitted prompts, then fresh admissions into whatever
        budget remains.  Block allocation is incremental — each chunk
        grows only the blocks it will write — and decode blocks are
        reserved before any chunk's, so a prompt can never starve the
        decodes out of their next write.

        While prefill work is pending the decode horizon is pinned to 1
        (one decode token per sequence per iteration interleaved with
        chunks); with no prefill in flight the full fused horizon is
        planned, recovering the megastep steady state.

        ``alloc_blocked`` (fault injection: the allocator reports
        exhaustion) suppresses everything that would *take new blocks
        for new work* — chunk growth, fresh admission, and the
        deadlock-guard eviction — while already-running decodes keep
        their pre-budgeted growth and continue unharmed."""
        budget = max_num_batched_tokens
        h = self.plan_horizon(1 if self._prefill_runnable(alloc_blocked)
                              else min(max_horizon,
                                       max(1, budget
                                           // max(1, len(self.decodable())))))
        cow = self.grow_for_horizon(h) if h else []
        dec_slots = sorted(self.decodable()) if h else []
        if len(dec_slots) * h > budget:
            # degenerate budget <= decodable count (the engine forbids it,
            # but StepPlan's used <= budget contract holds standalone too):
            # the overflow slots simply sit this iteration out — their
            # pre-grown blocks stay owned and they decode next step
            dec_slots = dec_slots[:budget // h]
        rem = budget - len(dec_slots) * h
        if alloc_blocked:
            rem = 0                      # no chunk growth, no admission
        chunks: List[PrefillChunk] = []
        # continue partially-prefilled prompts first, oldest arrival first
        for s in sorted((s for s in self.running.values() if s.prefilling),
                        key=lambda s: (s.req.arrival, s.slot)):
            if rem <= 0:
                break
            want = min(rem, len(s.req.prompt) - s.computed_len)
            length = self._chunk_fit(s.block_ids, s.computed_len, want)
            if length <= 0:
                continue
            # content-addressed growth: full blocks this chunk will cover
            # may be shared with an identical live prefix (register-on-
            # write hashing makes continuation blocks discoverable)
            s.block_ids, _ = self.alloc.grow_prefill(
                s.block_ids, s.computed_len, length, s.req.prompt)
            chunks.append(PrefillChunk(seq=s, start=s.computed_len,
                                       length=length))
            rem -= length
        # fresh admissions: first chunk is watermark-gated like whole-
        # prompt admission; full blocks become content-addressed once the
        # chunk's device write is confirmed (``complete_chunk``), so
        # prefix reuse still applies to whatever the first chunk covers
        while rem > 0 and self.free_slots:
            idx = self._admissible_index()
            if idx is None:
                break
            req = self.waiting[idx]
            self._clamp_prompt(req)
            bs = self.alloc.block_size
            if not self._pool_feasible(req):
                # the whole prompt can never fit this pool: leave it
                # waiting (exactly like whole-prompt admission) instead
                # of parking a forever-stuck partial prefill on blocks
                break
            length = min(rem, len(req.prompt))
            headroom = (self.alloc.num_free - self.alloc.watermark) * bs
            length = min(length, max(0, headroom))
            if length <= 0:
                break
            self.waiting.pop(idx)
            block_ids, _ = self.alloc.allocate_prompt(req.prompt[:length])
            slot = self.free_slots.pop()
            seq = Sequence(req=req, slot=slot, block_ids=block_ids,
                           seq_len=0, last_token=req.prompt[-1],
                           computed_len=0,
                           hashed_blocks=length // self.alloc.block_size)
            self.running[slot] = seq
            chunks.append(PrefillChunk(seq=seq, start=0, length=length))
            rem -= length
        if not dec_slots and not chunks and not alloc_blocked \
                and len(self.running) > 1 \
                and any(s.prefilling for s in self.running.values()):
            # every runnable path is blocked on KV blocks held by newer
            # sequences: evict the youngest so the oldest makes progress
            # next iteration instead of deadlocking
            self.preempt_youngest()
        return StepPlan(decode_slots=dec_slots, horizon=h, cow_pairs=cow,
                        prefill=chunks, budget=budget)

    def complete_chunk(self, chunk: PrefillChunk) -> None:
        """Advance host bookkeeping after the device executed a chunk,
        and content-address the blocks the chunk just filled (register-
        on-write): every newly *full* block becomes discoverable for
        cross-request prefix reuse — ``allocate_prompt`` only hashes the
        first chunk's blocks, so without this a multi-chunk prompt's
        later blocks could never be shared."""
        s = chunk.seq
        s.computed_len = chunk.start + chunk.length
        s.seq_len = s.computed_len
        bs = self.alloc.block_size
        full = s.computed_len // bs
        # only blocks this chunk covered WHOLE are registered: a block
        # straddling the chunk start went through the int8 boundary
        # dequant-merge-requant, so its pool bytes differ from the fresh
        # full-block quantize a reusing sequence would rewrite it with —
        # sharing it would let that rewrite perturb this sequence's KV.
        # (bf16 merges are exact, but the rule stays uniform.)
        first = max(s.hashed_blocks, -(-chunk.start // bs))
        for i in range(first, full):
            self.alloc.register_full_block(s.block_ids[i],
                                           s.req.prompt[:(i + 1) * bs])
        s.hashed_blocks = max(s.hashed_blocks, full)
