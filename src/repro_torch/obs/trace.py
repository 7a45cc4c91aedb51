"""Low-overhead span tracing for the serving hot loop.

The tracer answers the question the aggregate counters cannot: *where*
does a steady-state engine step spend its milliseconds?  Every section
of interest — plan, each device dispatch, the token-readback sync
boundary, detokenization — is wrapped in a :class:`SpanTracer.span`
context manager; completed spans land in a bounded ring buffer of
``(name, cat, ts_ns, dur_ns, depth, args)`` records and can be exported
as Chrome-trace-event JSON (``chrome://tracing`` / Perfetto's
``ui.perfetto.dev`` open it directly).

Hot-path contract:

* **no device imports** — this module must be loadable and zero-cost in
  processes that never touch a device, and nothing here may ever block
  on a device stream;
* **no host syncs** — span bodies only read ``time.perf_counter_ns``
  (one monotonic clock call on enter, one on exit) and append one
  record to a ``deque``; span ``args`` must be plain host values
  (ints / floats / strings), never device arrays;
* **zero work when disabled** — ``span()`` returns a preallocated
  no-op singleton and ``instant()`` returns immediately, so a
  telemetry-off engine traces nothing and allocates nothing per step.

``attribute_steps`` post-processes the ring into the per-step
host-vs-device wall-time split (``engine.attribution()``): device time
is the sum of ``cat="device"`` spans inside each step span — dispatch
issue plus the readback sync — and host time is the remainder (plan,
absorb, detokenize, bookkeeping).
"""
from __future__ import annotations

import json
from collections import deque
from time import perf_counter_ns
from typing import Dict, Iterable, List, Optional

__all__ = ["Span", "SpanTracer", "NULL_TRACER", "attribute_steps",
           "validate_chrome_trace"]


class Span:
    """One completed (or instant) trace event.

    ``ts`` / ``dur`` are integer nanoseconds from ``perf_counter_ns``
    (monotonic; comparable across spans of one process, not across
    processes).  ``dur is None`` marks an instant event (a point in
    time with no extent — request lifecycle marks use these).
    """
    __slots__ = ("name", "cat", "ts", "dur", "depth", "args")

    def __init__(self, name: str, cat: str, ts: int, dur: Optional[int],
                 depth: int, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.depth = depth
        self.args = args

    def __repr__(self) -> str:  # debugging aid only
        dur = "instant" if self.dur is None else f"{self.dur / 1e3:.1f}us"
        return f"Span({self.name!r}, cat={self.cat!r}, {dur}, " \
               f"depth={self.depth})"


class _SpanCtx:
    """Context manager for one open span (allocated per span when the
    tracer is enabled; the disabled path never reaches here)."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **kw) -> "_SpanCtx":
        """Attach args discovered mid-span (host values only)."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self

    def __enter__(self) -> "_SpanCtx":
        self._tracer._depth += 1
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = perf_counter_ns()
        tr = self._tracer
        tr._depth -= 1
        tr._total += 1
        tr._ring.append(Span(self.name, self.cat, self._t0, t1 - self._t0,
                             tr._depth, self.args))


class _NullSpanCtx:
    """The shared no-op span: what a disabled tracer hands out.  One
    instance for the whole process — entering it does nothing, so the
    disabled fast path costs one attribute check and zero allocations."""
    __slots__ = ()

    def set(self, **kw) -> "_NullSpanCtx":
        return self

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_CTX = _NullSpanCtx()


class SpanTracer:
    """Bounded-ring span recorder with Chrome-trace JSON export.

    capacity: ring size in completed spans/events; the oldest are
              dropped first (``dropped`` counts them), so a long-lived
              server holds the most recent window — exactly what
              steady-state attribution wants.
    enabled:  False hands out the no-op singleton (zero work, empty
              ring); flip with ``enable()`` / ``disable()`` at a step
              boundary (open spans of the old mode finish recording).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring: deque = deque(maxlen=self.capacity)
        self._depth = 0
        self._total = 0

    # ------------------------------------------------------------ record
    def span(self, name: str, cat: str = "host",
             args: Optional[dict] = None):
        """Open a nested span: ``with tracer.span("plan"): ...``."""
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, cat, args)

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict] = None) -> None:
        """Record a zero-duration lifecycle mark (e.g. ``req.arrival``)."""
        if not self.enabled:
            return
        self._total += 1
        self._ring.append(Span(name, cat, perf_counter_ns(), None,
                               self._depth, args))

    # ------------------------------------------------------------ control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop recorded spans (e.g. to scope attribution to a
        steady-state window); the dropped count resets too."""
        self._ring.clear()
        self._total = 0

    # ------------------------------------------------------------ read
    @property
    def dropped(self) -> int:
        """Events evicted by ring truncation since the last ``clear``."""
        return max(0, self._total - len(self._ring))

    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first (completion order)."""
        return list(self._ring)

    # ------------------------------------------------------------ export
    def to_chrome_trace(self, *, pid: int = 1, tid: int = 1) -> Dict:
        """The ring as a Chrome trace-event document (Perfetto-loadable).

        Complete spans become ``ph: "X"`` events with microsecond
        ``ts``/``dur``; instants become ``ph: "i"`` (thread scope).
        """
        events = []
        for s in self._ring:
            ev: Dict = {"name": s.name, "cat": s.cat, "pid": pid,
                        "tid": tid, "ts": s.ts / 1e3}
            if s.dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = s.dur / 1e3
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> None:
        """Write the Chrome trace JSON (open in Perfetto / about:tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


#: process-wide disabled tracer: the default for components (e.g.
#: ``ModelRunner``) that are constructed without an engine-owned tracer.
NULL_TRACER = SpanTracer(capacity=1, enabled=False)


def validate_chrome_trace(doc: Dict) -> List[str]:
    """Best-effort trace-event schema check; returns a list of problems
    (empty = valid).  Used by the obs tests and the CI artifact smoke."""
    problems: List[str] = []
    if not isinstance(doc.get("traceEvents"), list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "B", "E", "M", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: X event without numeric dur")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


def attribute_steps(spans: Iterable[Span], window: Optional[int] = None,
                    step_name: str = "engine.step",
                    device_cat: str = "device") -> Dict[str, float]:
    """Host-vs-device wall-time attribution over the last ``window``
    *work* steps (steps that issued at least one device-cat span).

    For each ``step_name`` span, device time is the sum of top-level
    ``device_cat`` spans it contains — dispatch issue plus the readback
    sync boundary — and host time is the remainder (plan, absorb,
    detokenize, scheduler bookkeeping).  Returns per-step means in
    milliseconds plus the host share; all-NaN when no step qualifies
    (e.g. the tracer was disabled).
    """
    spans = list(spans)
    steps = [s for s in spans if s.name == step_name and s.dur is not None]
    device = [s for s in spans if s.cat == device_cat and s.dur is not None]
    # guard against double counting if a device span ever nests inside
    # another (today they are siblings; keep the invariant cheap to hold)
    top = [d for d in device
           if not any(o is not d and o.ts <= d.ts
                      and d.ts + d.dur <= o.ts + o.dur for o in device)]
    rows: List[tuple] = []
    for st in steps:
        end = st.ts + st.dur
        dev = sum(d.dur for d in top if st.ts <= d.ts and d.ts + d.dur <= end)
        if dev > 0:                       # work steps only
            rows.append((st.dur, dev))
    if window is not None:
        rows = rows[-int(window):]
    if not rows:
        nan = float("nan")
        return {"steps": 0.0, "step_ms": nan, "host_ms": nan,
                "device_ms": nan, "host_frac": nan, "device_frac": nan}
    n = len(rows)
    step_ms = sum(r[0] for r in rows) / n / 1e6
    device_ms = sum(r[1] for r in rows) / n / 1e6
    host_ms = step_ms - device_ms
    return {"steps": float(n), "step_ms": step_ms, "host_ms": host_ms,
            "device_ms": device_ms, "host_frac": host_ms / step_ms,
            "device_frac": device_ms / step_ms}
