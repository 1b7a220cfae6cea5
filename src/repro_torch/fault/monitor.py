"""Fault-tolerance substrate: heartbeats, straggler detection, restart
(``src/repro/fault/monitor.py``, copied: pure Python).

Fail-stop model (DESIGN.md §6): every worker ticks a heartbeat; a missed
deadline marks the worker dead, the launcher exits non-zero and the
cluster scheduler relaunches from the latest checkpoint (tested by
killing a training loop mid-run and asserting bitwise-identical resume).

Straggler mitigation at the host level: per-step EWMA timing; steps
slower than ``threshold x`` EWMA raise a straggler event — the futurized
data pipeline absorbs producer stragglers via prefetch depth, and the
event lets the launcher trigger re-sharding away from a slow host.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["Heartbeat", "StepMonitor", "StragglerEvent"]


class Heartbeat:
    """Soft heartbeat: worker calls ``tick()``; ``check()`` (monitor side)
    returns False once the deadline is missed.

    The dead latch edge-triggers ``on_dead`` (once per death, not once per
    ``check``) and CLEARS when the worker resumes ticking: a flapping
    worker — dead, recovered, dead again — fires ``on_dead`` on every
    dead transition.  Without the reset the latch stuck forever after the
    first miss, so a recovered worker read alive from ``check()`` while a
    second death could never re-arm the callback."""

    def __init__(self, timeout_s: float = 60.0, on_dead: "Optional[Callable]" = None):
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self._dead = False

    def tick(self) -> None:
        with self._lock:
            self._last = time.monotonic()

    def force_expire(self) -> None:
        """Backdate the last tick past the deadline so the next ``check()``
        reads dead — the heartbeat-corruption hook of the fault injector
        (``fault.inject.FaultInjector.corrupt_heartbeat``).  A subsequent
        ``tick()`` recovers the worker exactly as a real flap would."""
        with self._lock:
            self._last = time.monotonic() - 2.0 * self.timeout_s

    def check(self) -> bool:
        with self._lock:
            alive = (time.monotonic() - self._last) < self.timeout_s
            fire = False
            if not alive and not self._dead:
                self._dead = True
                fire = bool(self.on_dead)
            elif alive and self._dead:
                # Recovery: the worker ticked again after missing its
                # deadline — clear the latch so the next miss re-fires.
                self._dead = False
        if fire:
            self.on_dead()
        return alive


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    ewma: float
    ratio: float


class StepMonitor:
    """EWMA step timing + straggler detection."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.5, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: "Optional[float]" = None
        self.count = 0
        self.events: "list[StragglerEvent]" = []

    def record(self, step: int, seconds: float) -> "Optional[StragglerEvent]":
        self.count += 1
        if self.ewma is None:
            self.ewma = seconds
            return None
        ev = None
        if self.count > self.warmup and seconds > self.threshold * self.ewma:
            ev = StragglerEvent(step, seconds, self.ewma, seconds / self.ewma)
            self.events.append(ev)
        # stragglers should not poison the baseline
        if ev is None:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return ev
