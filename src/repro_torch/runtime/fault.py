"""Straggler detection: an EMA step-time monitor.

The JAX package's ``runtime/fault.py`` also holds the checkpoint-restart
``Supervisor`` and ``elastic_remesh``; they belong to training and
parallelism, which the port has not reached (ROADMAP A12, A13).  The
serving engine uses the detector as its straggler watchdog.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional


@dataclass
class StragglerDetector:
    """EMA step-time monitor. A step slower than ``threshold``× the EMA is
    flagged; after ``patience`` consecutive flags the verdict is
    ``"reslot"`` (the caller evicts or reschedules the slow worker)."""
    threshold: float = 3.0
    patience: int = 3
    ema: Optional[float] = None
    alpha: float = 0.1
    _strikes: int = 0
    #: most recent straggler flags only — a long-lived serving engine
    #: observes every step forever, so an unbounded list is a slow leak
    events: Deque[Dict[str, float]] = field(
        default_factory=lambda: deque(maxlen=256))

    def observe(self, step: int, dt: float) -> str:
        if self.ema is None:
            self.ema = dt
            return "ok"
        verdict = "ok"
        if dt > self.threshold * self.ema:
            self._strikes += 1
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            verdict = "straggler" if self._strikes < self.patience \
                else "reslot"
            if verdict == "reslot":
                self._strikes = 0
        else:
            self._strikes = 0
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return verdict
