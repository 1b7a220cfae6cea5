"""Deterministic, seedable fault injection — the chaos layer
(``src/repro/fault/inject.py``, copied: pure Python and numpy; DESIGN.md
§16).

Recovery code that is only exercised by real failures is untested code.
This module turns every failure mode the runtime claims to survive into a
*scheduled, replayable event*: kill a worker at step k, drop or delay
parcels on a transport, stall a device lane so ``least_loaded`` must route
around it, corrupt a heartbeat so the monitor declares a death.  Every
probabilistic decision draws from one seeded ``numpy`` Generator, so a
(seed, schedule) pair names exactly one failure scenario — the property
tests in ``tests/test_torch_elastic_train.py`` and the train driver's
``--chaos`` flag replay the same scenarios bit-identically.

Hook points:

* ``set_fault_filter`` of a parcel port — consulted on every outbound
  parcel; drops fail the sender's future with ``ParcelDropped`` *before*
  the wire (later parcels on the channel are untouched, so channel FIFO
  holds), delays sleep on the sending thread (later parcels queue behind —
  FIFO again).  The port has no parcel port yet (ROADMAP.md Queue 1 item
  10): the rules talk to any object with ``set_fault_filter``.
* ``Scheduler.cordon`` — removes a device from placement without touching
  its in-flight work.
* ``Heartbeat.force_expire`` — backdates the last tick so the next
  ``check()`` fires ``on_dead``, exactly like a real missed deadline.
* ``Device.ops_queue`` — ``stall_lane`` occupies a device's lane.
* anything with ``kill()`` (the elastic trainer's workers) — hard worker
  death; the elastic trainer's ``kill_at_step`` arms the same death
  mid-step, inside the victim's own shard execution.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

__all__ = ["FaultInjector", "InjectedFault", "ParcelDropped"]


class ParcelDropped(RuntimeError):
    """A parcel discarded by fault injection before it reached the wire.

    Retry-safe by construction: the parcel was never sent, so nothing on
    the remote side half-ran and channel FIFO for later parcels is
    unaffected.  Callers (the elastic trainer) treat this as transient and
    re-send, unlike a worker death which forces a reshard."""


@dataclass
class InjectedFault:
    """One fault that actually fired (the injector's audit log entry)."""

    kind: str  # "drop" | "delay" | "kill" | "kill_at_step" | "stall" | "hb_expire" | "cordon" | "plan"
    target: str  # "L3", "cpu:0", "worker-2", ...
    action: Optional[str] = None  # parcel action, for drop/delay
    detail: Optional[float] = None  # seconds (delay/stall) or step (kills)


class _ParcelRule:
    """One drop/delay rule: match by action/locality, fire with seeded
    probability ``p``, at most ``count`` times."""

    __slots__ = ("kind", "actions", "localities", "p", "remaining", "seconds")

    def __init__(self, kind, actions, localities, p, count, seconds=0.0):
        self.kind = kind
        self.actions = None if actions is None else frozenset(actions)
        self.localities = None if localities is None else frozenset(localities)
        self.p = float(p)
        self.remaining = count  # None = unlimited
        self.seconds = float(seconds)

    def matches(self, locality_id: int, action: str) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.actions is not None and action not in self.actions:
            return False
        if self.localities is not None and locality_id not in self.localities:
            return False
        return True


class FaultInjector:
    """Seeded chaos source.  One instance = one deterministic scenario.

    All parcel-level decisions are made under one lock with one RNG in
    call order, so a single-threaded driver replays identically; the
    ``log`` records every fault that actually fired, in firing order.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.log: "list[InjectedFault]" = []
        self._lock = threading.Lock()
        self._rules: "dict[int, list[_ParcelRule]]" = {}  # id(port) -> rules

    # -- parcel faults -------------------------------------------------------

    def drop_parcels(
        self,
        port,
        *,
        actions: "list[str] | None" = None,
        localities: "list[int] | None" = None,
        p: float = 1.0,
        count: "int | None" = None,
    ) -> None:
        """Fail matching outbound parcels with ``ParcelDropped`` before the
        send.  Matching ``"ping"`` starves the port's heartbeat — that is
        the transport-level heartbeat-corruption vector."""
        self._add_rule(port, _ParcelRule("drop", actions, localities, p, count))

    def delay_parcels(
        self,
        port,
        *,
        seconds: float,
        actions: "list[str] | None" = None,
        localities: "list[int] | None" = None,
        p: float = 1.0,
        count: "int | None" = None,
    ) -> None:
        """Sleep ``seconds`` on the sender before matching parcels ship.
        Later parcels on the same channel queue behind the sleep, so
        ordering guarantees are preserved — delay slows, never reorders."""
        self._add_rule(port, _ParcelRule("delay", actions, localities, p, count, seconds))

    def clear_parcel_faults(self, port) -> None:
        self._rules.pop(id(port), None)
        port.set_fault_filter(None)

    def _add_rule(self, port, rule: _ParcelRule) -> None:
        rules = self._rules.setdefault(id(port), [])
        if not rules:
            port.set_fault_filter(self._make_filter(rules))
        rules.append(rule)

    def _make_filter(self, rules: "list[_ParcelRule]"):
        def _filter(locality_id: int, action: str):
            with self._lock:
                for r in rules:
                    if not r.matches(locality_id, action):
                        continue
                    if r.p < 1.0 and self.rng.random() >= r.p:
                        continue
                    if r.remaining is not None:
                        r.remaining -= 1
                    if r.kind == "drop":
                        self.log.append(InjectedFault("drop", f"L{locality_id}", action))
                        return (
                            "drop",
                            ParcelDropped(
                                f"parcel {action!r} to locality L{locality_id} "
                                "dropped by fault injection"
                            ),
                        )
                    self.log.append(
                        InjectedFault("delay", f"L{locality_id}", action, r.seconds)
                    )
                    return ("delay", r.seconds)
            return None

        return _filter

    # -- worker death --------------------------------------------------------

    def kill_worker(self, target: Any, locality_id: "int | None" = None) -> None:
        """Hard worker death, by transport kind:

        * ``LocalClusterParcelport`` + locality id: SIGKILL the worker
          process — the port's monitor thread declares the death.
        * ``LoopbackParcelport`` + locality id: flip the port's fail-fast
          gate (``port.kill``).
        * anything with a ``kill()`` method (elastic trainer workers):
          killed directly.
        """
        workers = getattr(target, "_workers", None)
        if workers is not None and locality_id is not None:  # cluster port
            w = workers.get(locality_id)
            if w is not None and w.proc.is_alive():
                w.proc.kill()
            self.log.append(InjectedFault("kill", f"L{locality_id}"))
            return
        if locality_id is not None and hasattr(target, "kill"):  # loopback port
            target.kill(locality_id)
            self.log.append(InjectedFault("kill", f"L{locality_id}"))
            return
        if hasattr(target, "kill"):
            target.kill()
            self.log.append(InjectedFault("kill", str(getattr(target, "wid", target))))
            return
        raise TypeError(f"don't know how to kill {target!r}")

    def kill_at_step(self, worker, step: int) -> None:
        """Arm a mid-step death: the worker dies inside its own shard
        execution at training step ``step`` (the elastic trainer's
        reshard-and-re-execute path is only reachable this way)."""
        worker.kill_at_step(int(step))
        self.log.append(
            InjectedFault("kill_at_step", str(getattr(worker, "wid", worker)), detail=float(step))
        )

    # -- device / scheduler faults -------------------------------------------

    def stall_lane(self, device, seconds: float):
        """Occupy a device's ops lane with a GIL-releasing sleep: the lane
        depth rises, ``least_loaded`` routes new work elsewhere, and work
        already queued behind the stall simply waits (a slow device, not a
        dead one).  Returns the stall's future."""
        self.log.append(InjectedFault("stall", device.key, detail=float(seconds)))
        return device.ops_queue.submit(lambda: time.sleep(seconds))

    def cordon_device(self, scheduler, device_key: str) -> None:
        """Remove a device from placement via the scheduler hook."""
        scheduler.cordon(device_key)
        self.log.append(InjectedFault("cordon", device_key))

    def uncordon_device(self, scheduler, device_key: str) -> None:
        scheduler.uncordon(device_key)

    # -- heartbeat corruption ------------------------------------------------

    def corrupt_heartbeat(self, heartbeat) -> None:
        """Backdate a heartbeat past its deadline: the next ``check()``
        fires ``on_dead`` exactly as a real missed deadline would; a
        subsequent ``tick()`` recovers the worker (flap)."""
        heartbeat.force_expire()
        self.log.append(InjectedFault("hb_expire", str(id(heartbeat))))

    # -- scenario planning ---------------------------------------------------

    def plan_kill(self, steps: int, victims: "list") -> "tuple[int, Any]":
        """Deterministically draw (kill_step, victim) from the seed — the
        train driver's ``--chaos N`` flag and the property tests share
        this, so one seed names one exact failure scenario.  The kill step
        lands strictly inside the run (never step 0)."""
        victims = list(victims)
        if not victims:
            raise ValueError("plan_kill needs at least one victim")
        k = int(self.rng.integers(1, max(2, int(steps))))
        v = victims[int(self.rng.integers(0, len(victims)))]
        self.log.append(
            InjectedFault("plan", str(getattr(v, "wid", v)), detail=float(k))
        )
        return k, v
