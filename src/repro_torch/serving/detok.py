"""Bounded background detokenize / RequestOutput fan-out worker.

The async pipelined engine (``enable_async_step``) moves everything a
token event costs *after* the model math — incremental detokenization
and ``RequestOutput`` construction — off the hot loop onto this worker,
so it overlaps with the next step's in-flight device dispatch instead
of serializing behind the readback.

Determinism contract: jobs are processed strictly FIFO on ONE worker
thread, and ``collect_upto(n)`` returns *exactly* the outputs of the
first ``n`` submitted jobs (blocking until they are done — normally
they already are, having had a whole device step to complete).  The
engine snapshots at submit time everything a job needs (the new token
ids, finished flag, cumulative token list), so the worker never reads
engine-mutated state; the only fields the worker writes
(``req.text`` / the legacy shim timestamps) are never touched by the
engine thread while the worker owns emission.  Worker exceptions are
re-raised on the engine thread at the next collect, never swallowed.

The queue is bounded (``maxsize``): if detokenization ever falls a full
queue behind, ``submit`` blocks the engine — backpressure, not
unbounded memory growth.

The worker runs only on the host: it builds ``RequestOutput`` records
from snapshotted Python lists and makes no CUDA call, so nothing it does
touches the engine's stream.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.serving.params import RequestOutput


@dataclass
class _Job:
    """Everything one emission needs, snapshotted on the engine thread."""
    req: object                    # RequestState (worker writes .text only)
    new_token_ids: List[int]
    token_ids: List[int]           # cumulative output snapshot
    prompt_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str]


class DetokWorker:
    """Single-threaded FIFO detokenize + fan-out worker (see module doc)."""

    def __init__(self, detokenizer: Optional[Callable], tracer,
                 maxsize: int = 1024):
        self.detokenizer = detokenizer
        self.tracer = tracer
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._cv = threading.Condition()
        self._done: List[RequestOutput] = []   # processed, not yet collected
        self._submitted = 0
        self._processed = 0
        self._collected = 0
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-detok")
        self._thread.start()

    # ------------------------------------------------------------ engine side
    @property
    def submitted(self) -> int:
        return self._submitted

    def pending(self) -> int:
        """Jobs submitted but not yet collected (0 = fully drained)."""
        return self._submitted - self._collected

    def submit(self, req, new_token_ids: List[int], finished: bool,
               finish_reason: Optional[str]) -> None:
        if self._closed:
            raise RuntimeError("DetokWorker is closed")
        self._submitted += 1
        self._q.put(_Job(req=req, new_token_ids=list(new_token_ids),
                         token_ids=list(req.output),
                         prompt_token_ids=list(req.prompt_token_ids),
                         finished=finished, finish_reason=finish_reason))

    def collect_upto(self, n: int) -> List[RequestOutput]:
        """Outputs of the first ``n`` submitted jobs not yet collected
        (FIFO; blocks until the worker has processed through job ``n``)."""
        take = min(n, self._submitted) - self._collected
        if take <= 0:
            self._raise_if_failed()
            return []
        with self._cv:
            self._cv.wait_for(
                lambda: self._processed >= self._collected + take
                or self._exc is not None)
            self._raise_if_failed()
            outs = self._done[:take]
            del self._done[:take]
            self._collected += take
            return outs

    def collect_all(self) -> List[RequestOutput]:
        return self.collect_upto(self._submitted)

    def close(self) -> List[RequestOutput]:
        """Drain every outstanding job, stop the thread, and return the
        remaining outputs (engine shutdown: no event is ever dropped)."""
        if self._closed:
            return []
        self._closed = True
        try:
            outs = self.collect_all()
        finally:
            self._q.put(None)                  # sentinel: thread exits
            self._thread.join(timeout=10.0)
        return outs

    def _raise_if_failed(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            self._closed = True
            raise exc

    # ------------------------------------------------------------ worker side
    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                out = self._build(job)
            except BaseException as e:        # re-raised at next collect
                with self._cv:
                    self._exc = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._done.append(out)
                self._processed += 1
                self._cv.notify_all()

    def _build(self, job: _Job) -> RequestOutput:
        req = job.req
        text = new_text = ""
        if self.detokenizer is not None:
            with self.tracer.span("detokenize", cat="host",
                                  args={"tokens": len(job.new_token_ids)}):
                new_text = self.detokenizer(job.new_token_ids) \
                    if job.new_token_ids else ""
            req.text += new_text
            text = req.text
        if req.shim is not None:      # legacy Request: mirror timestamps
            req.shim.first_token_t = req.first_token_t
            req.shim.done_t = req.done_t
        return RequestOutput(
            request_id=req.rid, prompt_token_ids=job.prompt_token_ids,
            token_ids=job.token_ids, new_token_ids=job.new_token_ids,
            finished=job.finished, finish_reason=job.finish_reason,
            text=text, new_text=new_text)
