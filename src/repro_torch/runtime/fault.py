"""Fault tolerance: the EMA step-time straggler monitor (the serving
engine's watchdog) and the trainer's checkpoint-restart ``Supervisor``,
as in the JAX package's ``runtime/fault.py``.  The failure signals on one
host are injected (``launch/train.py --fail-at-step``, the tests).  Its
``elastic_remesh`` re-places a restored state on another device mesh,
which waits for the port's parallelism (ROADMAP A13).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

log = logging.getLogger("repro_torch.fault")


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


class PreemptionError(RuntimeError):
    """Raised by the (injected or real) failure signal mid-training."""


@dataclass
class Supervisor:
    """Checkpoint-restart training supervision.

    ``run`` drives ``step_fn`` for ``total_steps``; any exception triggers a
    restore from the latest checkpoint and a bounded number of retries —
    the node-failure story. State is (params, opt_state, data_state).
    """
    checkpointer: Any                      # Checkpointer
    save_every: int = 50
    max_restarts: int = 3
    straggler: StragglerDetector = field(default_factory=StragglerDetector)
    restarts: int = 0
    history: List[Dict[str, Any]] = field(default_factory=list)

    def run(self, *, total_steps: int, state: Dict[str, Any],
            step_fn: Callable[[int, Dict[str, Any]], Dict[str, Any]],
            restore_fn: Callable[[int], Dict[str, Any]],
            fail_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        step = int(state.get("step", 0))
        while step < total_steps:
            try:
                if fail_hook is not None:
                    fail_hook(step)
                t0 = time.perf_counter()
                state = step_fn(step, state)
                dt = time.perf_counter() - t0
                verdict = self.straggler.observe(step, dt)
                if verdict == "reslot":
                    log.warning("straggler at step %d (%.3fs vs ema %.3fs): "
                                "re-slotting", step, dt, self.straggler.ema)
                step += 1
                state["step"] = step
                if step % self.save_every == 0 or step == total_steps:
                    self.checkpointer.save(step, state["trees"],
                                           extra=state.get("extra", {}))
                    self.history.append({"event": "save", "step": step})
            except Exception as e:          # node failure / preemption
                self.restarts += 1
                self.history.append({"event": "restart", "step": step,
                                     "error": repr(e)})
                if self.restarts > self.max_restarts:
                    raise
                last = self.checkpointer.latest_step()
                log.warning("failure at step %d (%r); restoring step %s "
                            "(restart %d/%d)", step, e, last, self.restarts,
                            self.max_restarts)
                if last is None:
                    step = 0
                    continue
                state = restore_fn(last)
                step = int(state["step"])
        return state
