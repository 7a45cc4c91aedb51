"""Deterministic fault injection for the serving engine.

Serving fault tolerance is only trustworthy if every failure mode is a
*reproducible test*: a seeded schedule decides, per engine step and per
named site, whether a fault fires — so a chaos run can be replayed
token-for-token and compared against a fault-free run (the same
determinism contract the sampling streams already obey).

Four injection sites, consulted by the engine / scheduler at the exact
points the real failures would surface:

* ``dispatch`` — a device dispatch raises ``TransientDeviceError``
  *before* anything of it is enqueued (so the pools are never left
  half-written and a retry is always safe).  A spec with ``count=k`` models
  a transient error that clears after ``k`` attempts; a spec with
  ``rid=r`` models a *poisoned request*: every dispatch whose batch
  contains ``r`` fails until the engine quarantines it.
* ``nan`` — the sampler sees non-finite logits for the chosen request's
  row (injected as a NaN bias added to that row's logits on device, so
  the engine's non-finite guard is exercised end to end, not simulated).
* ``alloc`` — the block allocator reports exhaustion: admission and
  prefill-chunk growth see zero headroom for the scheduled steps.
* ``stall`` — the step stalls (host sleep) past the straggler
  watchdog's threshold.

Everything is host-side and O(1) per consultation; an engine built
without an injector (the default) never constructs one and pays a single
``is None`` check per site.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Set

import numpy as np

SITES = ("dispatch", "nan", "alloc", "stall")


class TransientDeviceError(RuntimeError):
    """An injected (or real) recoverable device/dispatch failure."""


class PoisonedDispatchError(RuntimeError):
    """A dispatch that kept failing after bounded retries.

    Carries the request ids that were in the failing batch so the
    engine's recovery path can requeue and bisect them.
    """

    def __init__(self, rids: Iterable[int], cause: Optional[str] = None):
        self.rids = sorted(set(rids))
        super().__init__(f"dispatch failed after retries (rids="
                         f"{self.rids}{': ' + cause if cause else ''})")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    site:  one of ``SITES``.
    step:  first engine step (0-based, counted by ``step_begin``) at
           which the spec is armed.
    count: how many consultations fire before the spec clears — the
           "transient" knob (``dispatch``/``alloc``/``stall``).  Ignored
           for rid-targeted ``dispatch`` specs, which are persistent
           until the engine quarantines the request.
    rid:   target request id.  For ``dispatch``: the poisoned request
           (any batch containing it fails).  For ``nan``: the row whose
           logits go non-finite (fires ``count`` times).
    seconds: stall duration for ``stall`` specs.
    """
    site: str
    step: int = 0
    count: int = 1
    rid: Optional[int] = None
    seconds: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")


def random_schedule(seed: int, steps: int, *,
                    p_dispatch: float = 0.0, p_nan: float = 0.0,
                    p_alloc: float = 0.0, rids: Sequence[int] = (),
                    ) -> List[FaultSpec]:
    """A seeded random chaos schedule over ``steps`` engine steps.

    Each step independently draws transient-dispatch / NaN-row /
    alloc-exhaustion events; NaN events target a random rid from
    ``rids``.  Same seed => same schedule => reproducible chaos runs.
    """
    rng = np.random.default_rng(seed)
    specs: List[FaultSpec] = []
    for s in range(steps):
        if p_dispatch and rng.random() < p_dispatch:
            specs.append(FaultSpec("dispatch", step=s,
                                   count=int(rng.integers(1, 3))))
        if p_nan and rids and rng.random() < p_nan:
            specs.append(FaultSpec("nan", step=s,
                                   rid=int(rng.choice(list(rids)))))
        if p_alloc and rng.random() < p_alloc:
            specs.append(FaultSpec("alloc", step=s,
                                   count=int(rng.integers(1, 3))))
    return specs


@dataclass
class _Armed:
    spec: FaultSpec
    remaining: int


class FaultInjector:
    """Schedule-driven injector the engine consults at named sites.

    Construct with explicit ``FaultSpec``s (or ``random_schedule``),
    attach via ``ServingEngine(..., fault_injector=...)``.  The engine
    calls ``step_begin`` once per iteration; site hooks then report
    whether the step's armed specs fire.  ``fired`` records every
    injection (site, step, rid) for test assertions.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = list(specs)
        self.step = -1
        self._armed: List[_Armed] = []
        self._pending = sorted(self.specs, key=lambda s: s.step)
        self.quarantined: Set[int] = set()
        self.fired: List[dict] = []

    def step_begin(self, step: Optional[int] = None) -> None:
        """Arm every spec whose step has arrived (engine calls once per
        iteration)."""
        self.step = self.step + 1 if step is None else step
        while self._pending and self._pending[0].step <= self.step:
            spec = self._pending.pop(0)
            self._armed.append(_Armed(spec, spec.count))

    def _fire(self, a: _Armed, **info) -> None:
        self.fired.append({"site": a.spec.site, "step": self.step, **info})
        a.remaining -= 1
        if a.remaining <= 0 and not (a.spec.site == "dispatch"
                                     and a.spec.rid is not None):
            self._armed.remove(a)

    def forgive(self, rid: int) -> None:
        """Clear rid-targeted specs for a quarantined request (the
        engine already failed it; keeping the spec armed would poison
        nothing but still be consulted)."""
        self.quarantined.add(rid)
        self._armed = [a for a in self._armed if a.spec.rid != rid]

    # ------------------------------------------------------------ sites
    def check_dispatch(self, rids: Iterable[int]) -> None:
        """Raise ``TransientDeviceError`` if an armed dispatch spec fires
        for this batch.  rid-targeted specs fire on any batch containing
        the poisoned rid and never clear on their own (persistent until
        ``forgive``); untargeted specs clear after ``count`` fires."""
        rids = set(rids)
        for a in list(self._armed):
            if a.spec.site != "dispatch":
                continue
            if a.spec.rid is not None:
                if a.spec.rid in rids:
                    self._fire(a, rid=a.spec.rid)
                    raise TransientDeviceError(
                        f"injected poisoned dispatch (rid {a.spec.rid})")
            else:
                self._fire(a)
                raise TransientDeviceError("injected transient device "
                                           "error")

    def nan_rids(self, rids: Optional[Iterable[int]] = None) -> Set[int]:
        """Request ids whose sampled-logit rows go non-finite this
        consultation (one dispatch's worth; each spec fires ``count``
        times).  ``rids`` — the batch being dispatched — keeps a spec
        armed until a dispatch actually contains its target, so a fault
        scheduled for a step where the victim sat waiting still lands."""
        present = None if rids is None else set(rids)
        out: Set[int] = set()
        for a in list(self._armed):
            if a.spec.site == "nan" and a.spec.rid is not None:
                if present is not None and a.spec.rid not in present:
                    continue
                out.add(a.spec.rid)
                self._fire(a, rid=a.spec.rid)
        return out

    def alloc_blocked(self) -> bool:
        """Whether the allocator should report exhaustion for this step's
        admission / chunk-growth decisions."""
        for a in list(self._armed):
            if a.spec.site == "alloc":
                self._fire(a)
                return True
        return False

    def stall_seconds(self) -> float:
        """Injected host stall (seconds) for this step, 0.0 if none."""
        total = 0.0
        for a in list(self._armed):
            if a.spec.site == "stall":
                self._fire(a)
                total += a.spec.seconds
        return total
