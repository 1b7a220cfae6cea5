"""Placement scheduler: which device runs a task (``src/repro/core/scheduler.py``).

The paper's "any user defined CUDA kernel can be launched on any GPU
device" needs a layer that *chooses* the device.  A ``Scheduler`` holds the
device fleet and a ``PlacementPolicy`` maps each task (its argument
buffers) to one device.

Policies
--------
``static``       pin everything to one device (HPXCL's hand placement).
``round_robin``  cycle through the fleet regardless of state.
``least_loaded`` the device whose lanes hold the smallest backlog plus
                 decayed recent busy time; ties rotate, so a blind signal
                 degrades to round-robin, never to a pile-up.
``affinity``     the device already holding the most argument bytes (AGAS
                 placement records); load breaks ties.
``percolation``  the device that minimises the bytes that would have to
                 move, a move across localities costing a multiple of a
                 local copy; load breaks ties.  Every device of this package
                 is local, so it scores like ``affinity`` with the bytes
                 summed.

The policy input is duck-typed: an argument counts toward affinity if it
is a ``Buffer`` (its AGAS record), a ``torch.Tensor`` (its card, see
``_arg_home``) or any object exposing ``device.key``/``nbytes``, so
policies are testable with fakes.

Rebalancing: ``submit`` parks a launch in a per-device pending deque in
front of the device lanes; one pump per device drains its own deque
head-first and, when it runs dry, steals from the tail of the deepest
sibling backlog (tail stealing keeps the victim's FIFO order).  A task is
worth stealing only if its argument bytes are at most
``REPRO_STEAL_MAX_BYTES`` (default 32 MiB).  A stolen launch re-binds to
the thief through ``Program.for_device``; its buffers percolate as in any
launch.  ``REPRO_STEAL=off`` (or ``steal=False``) keeps one-shot placement.

Memory-aware placement: a device whose AGAS resident bytes plus the task's
incoming bytes would exceed its threshold (``Device.memory_limit``, seeded
from ``REPRO_SPILL_BYTES``, or the scheduler's ``spill_bytes``) is vetoed
as a candidate; when every candidate is over, the pick goes through and the
least-recently-used buffers on it are spilled to host memory
(``Buffer.spill``; the next use refetches them).

Localities: a fleet may hold remote devices (``RemoteDevice`` proxies of
a parcel port).  Liveness is re-read on every decision (``alive()``): a
locality whose worker died takes no new placements until it recovers.
``percolation`` charges a move across a locality boundary
``cross_locality_cost`` times an intra-locality copy.  A steal across
localities takes only tasks whose argument bytes are at most
``REPRO_STEAL_MAX_BYTES`` over that penalty, and fetches the task's remote
buffers in one ``steal_fetch`` parcel before it runs.
"""
from __future__ import annotations

import os
import threading
import time as _time
from collections import deque
from dataclasses import replace as _dc_replace
from typing import Any, Callable, Sequence

import torch

__all__ = [
    "PlacementPolicy",
    "StaticPolicy",
    "RoundRobinPolicy",
    "LeastLoadedPolicy",
    "AffinityPolicy",
    "PercolationPolicy",
    "Scheduler",
    "get_scheduler",
    "set_scheduler",
    "make_policy",
    "locality_of_key",
    "POLICIES",
]


def locality_of_key(key: "str | None") -> int:
    """Locality id encoded in a device key (``L3/cpu:0`` -> 3; local
    keys -> 0)."""
    if key and key.startswith("L"):
        head, sep, _ = key.partition("/")
        if sep:
            try:
                return int(head[1:])
            except ValueError:
                return 0
    return 0


def _is_alive(device: Any) -> bool:
    alive = getattr(device, "alive", None)
    return True if alive is None else bool(alive())


def _arg_home(arg: Any) -> "tuple[str | None, int]":
    """(device_key, nbytes) of ``arg``'s resident storage, or (None, 0).

    Buffers resolve through their AGAS placement record (the handle may
    have been re-homed).  A ``torch.Tensor`` knows its card, not its
    logical device: it homes to the card's device while the card is not
    split, and to none of them while it is (every logical device of the
    card reads it in place, no copy).  Anything else exposing
    ``device.key`` and ``nbytes`` counts as a fake device's buffer."""
    nbytes = getattr(arg, "nbytes", None)
    if nbytes is None:
        return None, 0
    if hasattr(arg, "gid") and getattr(arg, "device", None) is not None:  # Buffer
        from repro_torch.core import agas

        try:
            return agas.registry.placement(arg.gid).device_key, int(nbytes)
        except KeyError:
            return getattr(arg.device, "key", None), int(nbytes)
    if isinstance(arg, torch.Tensor):
        from repro_torch.core.device import logical_keys

        keys = logical_keys(arg.device)
        return (keys[0], int(nbytes)) if len(keys) == 1 else (None, 0)
    key = getattr(getattr(arg, "device", None), "key", None)  # duck-typed fake
    return (key, int(nbytes)) if key is not None else (None, 0)


def _device_load(device):
    """Backlog snapshot for placement: ``device.load()`` when the device
    sums its lanes (a device busy on three lanes is three deep), else the
    bare ops queue (duck-typed fakes)."""
    ld = getattr(device, "load", None)
    if callable(ld):
        return ld()
    return device.ops_queue.load()


def _occupancy(device) -> float:
    """Backlog depth plus the decayed recent busy time
    (``QueueLoad.busy_ewma``): depth alone cannot tell a device that just
    finished a long task from one that sat idle."""
    l = _device_load(device)
    return l.depth + getattr(l, "busy_ewma", 0.0)


def _load_score(device) -> float:
    # Quantized to half-tau steps so near-equal devices compare equal and
    # the tie rotation sees the tie: scoring sub-half-tau history would
    # pile a whole submit burst onto whichever device was momentarily
    # idlest, and its raised history would move the next burst wholesale.
    return round(_occupancy(device) * 2.0) / 2.0


def _rotate_pick(policy, devices, scores):
    """Min-score pick with a rotating tie-break (per-policy counter), so
    ties do not all resolve to device 0."""
    lo = min(scores)
    tied = [i for i, s in enumerate(scores) if s == lo]
    with policy._lock:
        pick = tied[policy._rr % len(tied)]
        policy._rr += 1
    return devices[pick]


class PlacementPolicy:
    """Maps (args, devices) -> one device.  Stateless unless noted."""

    name = "base"

    def select(self, devices: Sequence, args: Sequence = (), program=None):
        raise NotImplementedError

    def select_batch(self, devices: Sequence, batch_args: "Sequence[Sequence]" = (),
                     program=None):
        """Place one micro-batch of requests as a unit: ``batch_args`` is
        one argument sequence a member.  The default scores every member's
        arguments as one set, so a batch goes where most of its bytes live
        and load policies see one decision, not N."""
        flat = [a for args in batch_args for a in args]
        return self.select(devices, args=flat, program=program)


class StaticPolicy(PlacementPolicy):
    """Everything on one device (HPXCL's hand placement, as a policy)."""

    name = "static"

    def __init__(self, index: int = 0):
        self.index = index

    def select(self, devices, args=(), program=None):
        return devices[self.index % len(devices)]


class RoundRobinPolicy(PlacementPolicy):
    """Cycle through the fleet; one counter under a lock."""

    name = "round_robin"

    def __init__(self):
        self._next = 0
        self._lock = threading.Lock()

    def select(self, devices, args=(), program=None):
        with self._lock:
            i = self._next
            self._next = i + 1
        return devices[i % len(devices)]


class LeastLoadedPolicy(PlacementPolicy):
    """Smallest occupancy wins (lane depth summed over the device's streams
    plus decayed busy time).  Ties are first narrowed to the tied devices
    holding the most argument bytes (placing elsewhere buys nothing and
    costs a copy), then rotate."""

    name = "least_loaded"

    def __init__(self):
        self._rr = 0
        self._lock = threading.Lock()

    def select(self, devices, args=(), program=None):
        scores = [_load_score(d) for d in devices]
        lo = min(scores)
        tied = [i for i, s in enumerate(scores) if s == lo]
        if len(tied) > 1 and args:
            bytes_at: "dict[str, int]" = {}
            for a in args:
                key, nb = _arg_home(a)
                if key is not None and nb:
                    bytes_at[key] = bytes_at.get(key, 0) + nb
            best = max((bytes_at.get(getattr(devices[i], "key", None), 0) for i in tied),
                       default=0)
            if best > 0:
                tied = [i for i in tied
                        if bytes_at.get(getattr(devices[i], "key", None), 0) == best]
        with self._lock:
            pick = tied[self._rr % len(tied)]
            self._rr += 1
        return devices[pick]


class AffinityPolicy(PlacementPolicy):
    """Most argument bytes already resident wins; among equally good hosts
    the least loaded, so a fleet with no resident data degrades to
    ``least_loaded``."""

    name = "affinity"

    def __init__(self):
        self._fallback = LeastLoadedPolicy()
        self._rr = 0
        self._lock = threading.Lock()

    def select(self, devices, args=(), program=None):
        resident: "dict[str, int]" = {}
        for a in args:
            key, nb = _arg_home(a)
            if key is not None and nb:
                resident[key] = resident.get(key, 0) + nb
        if not resident:
            return self._fallback.select(devices, args=args, program=program)
        scores = [(-resident.get(d.key, 0), _load_score(d)) for d in devices]
        return _rotate_pick(self, devices, scores)


class PercolationPolicy(PlacementPolicy):
    """Fewest bytes to move wins: each candidate is charged every
    argument's bytes that are not already there, ``cross_locality_cost``
    times over when the bytes live in another locality.  Ties break by
    load; with no resident argument bytes it degrades to ``least_loaded``."""

    name = "percolation"

    def __init__(self, cross_locality_cost: float = 8.0):
        self.cross_locality_cost = float(cross_locality_cost)
        self._fallback = LeastLoadedPolicy()
        self._rr = 0
        self._lock = threading.Lock()

    def select(self, devices, args=(), program=None):
        homes: "list[tuple[str, int, int]]" = []
        for a in args:
            key, nb = _arg_home(a)
            if key is not None and nb:
                homes.append((key, locality_of_key(key), nb))
        if not homes:
            return self._fallback.select(devices, args=args, program=program)

        def score(dev):
            dev_loc = locality_of_key(dev.key)
            cost = 0.0
            for key, loc, nb in homes:
                if key == dev.key:
                    continue
                cost += nb * (self.cross_locality_cost if loc != dev_loc else 1.0)
            return (cost, _load_score(dev))

        return _rotate_pick(self, devices, [score(d) for d in devices])


POLICIES: "dict[str, Callable[[], PlacementPolicy]]" = {
    "static": StaticPolicy,
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "affinity": AffinityPolicy,
    "percolation": PercolationPolicy,
}


def make_policy(policy: "str | PlacementPolicy") -> PlacementPolicy:
    if isinstance(policy, PlacementPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown placement policy {policy!r}; have {sorted(POLICIES)}") from None


class _LoadView:
    """Policy-facing device view charging the device for work this
    scheduler knows about but the lanes may not show yet: the steal pool's
    pending backlog and the decayed recent-placement count.  A launch that
    has reached a lane is in both its depth and the recency counter, so the
    two combine as ``max(depth + pending, recent)``, never a double
    charge.  Everything else forwards to the wrapped device."""

    __slots__ = ("_dev", "_pending", "_recent")

    def __init__(self, dev, pending: int = 0, recent: float = 0.0):
        self._dev = dev
        self._pending = pending
        self._recent = recent

    def load(self):
        l = _device_load(self._dev)
        extra = self._pending + max(0.0, self._recent - (l.depth + self._pending))
        if not extra:
            return l
        try:
            return _dc_replace(l, depth=l.depth + extra, submitted=l.submitted + extra)
        except TypeError:  # duck-typed fake load object
            return l

    def __getattr__(self, name):
        return getattr(self._dev, name)

    def __repr__(self) -> str:
        return f"_LoadView({self._dev!r}, +{self._pending}, ~{self._recent:.2f})"


def _unwrap(dev):
    return dev._dev if isinstance(dev, _LoadView) else dev


class _PendingLaunch:
    """One launch parked in the steal pool (``Scheduler.submit``)."""

    __slots__ = ("program", "args", "kernel", "grid", "block", "out", "sync",
                 "promise", "nbytes", "home_key", "stolen")

    def __init__(self, program, args, kernel, grid, block, out, sync, promise,
                 nbytes, home_key):
        self.program = program
        self.args = args
        self.kernel = kernel
        self.grid = grid
        self.block = block
        self.out = out
        self.sync = sync
        self.promise = promise
        self.nbytes = nbytes
        self.home_key = home_key
        self.stolen = False


class Scheduler:
    """Placement decisions over a device fleet.

    ``devices=None`` discovers the fleet lazily (``get_all_devices()``, so
    ``REPRO_LOGICAL_DEVICES`` applies) on first use.  ``select`` returns the
    chosen ``Device`` and logs the decision in per-device counters
    (``stats()``).  With stealing on (the default; ``REPRO_STEAL=off`` or
    ``steal=False`` turns it off) ``submit`` parks launches in per-device
    deques drained by one pump per device.  ``spill_bytes`` (else each
    device's ``memory_limit``) arms the memory veto and the LRU spill."""

    def __init__(self, devices: "Sequence | None" = None,
                 policy: "str | PlacementPolicy" = "least_loaded",
                 steal: "bool | None" = None,
                 spill_bytes: "int | None" = None,
                 steal_max_bytes: "int | None" = None):
        self.policy = make_policy(policy)
        self._devices: "list | None" = list(devices) if devices is not None else None
        self._placements: "dict[str, int]" = {}
        self._lock = threading.Lock()
        if steal is None:
            steal = os.environ.get("REPRO_STEAL", "auto").lower() != "off"
        self._steal = bool(steal)
        if steal_max_bytes is None:
            steal_max_bytes = int(os.environ.get("REPRO_STEAL_MAX_BYTES", str(32 << 20)))
        self._steal_max_bytes = int(steal_max_bytes)
        self._spill_bytes = spill_bytes  # None -> per-device memory_limit
        # Steal pool: device key -> deque of _PendingLaunch, and the keys
        # whose pump runs; one lock covers both.
        self._pump_lock = threading.Lock()
        self._pending: "dict[str, deque]" = {}
        self._pumping: "set[str]" = set()
        self._steals = 0
        self._cross_steals = 0
        self._cross_penalty = 8  # migration-cost multiple of a parcel-pair move
        # Cordoned devices take no new placements, unless that would
        # empty the fleet.
        self._cordoned: "set[str]" = set()
        # Decayed recent-placement counters (key -> (count, stamp)): a
        # launch placed a moment ago may not show in its lane yet.
        self._recent: "dict[str, tuple[float, float]]" = {}

    def devices(self) -> list:
        devs = self._devices
        if devs is None:
            from repro_torch.core.device import get_all_devices

            devs = self._devices = list(get_all_devices().get())
        if not devs:
            raise RuntimeError("Scheduler has no devices to place on")
        return devs

    def _live(self) -> list:
        devs = self.devices()
        live = [d for d in devs if _is_alive(d)]
        if not live:
            raise RuntimeError("Scheduler has no live devices: every device of the fleet is dead")
        if self._cordoned:
            open_devs = [d for d in live if d.key not in self._cordoned]
            if open_devs:  # an all-cordoned fleet waives the cordon
                return open_devs
        return live

    def cordon(self, device_key: str) -> None:
        """Exclude ``device_key`` from new placements (a drain); work in
        flight on it is untouched."""
        with self._lock:
            self._cordoned.add(device_key)

    def uncordon(self, device_key: str) -> None:
        with self._lock:
            self._cordoned.discard(device_key)

    def _decayed(self, key: str, now: float, add: float) -> None:
        """Fold ``add`` into ``key``'s decayed recent counter (caller holds
        ``_lock``)."""
        from repro_torch.core import executor

        count, stamp = self._recent.get(key, (0.0, now))
        self._recent[key] = (count * 2.0 ** (-(now - stamp) / executor._LOAD_HALFLIFE) + add, now)

    def _record(self, dev):
        now = _time.monotonic()
        with self._lock:
            self._placements[dev.key] = self._placements.get(dev.key, 0) + 1
            self._decayed(dev.key, now, 1.0)
        return dev

    def charge(self, dev, n: float = 1.0) -> None:
        """Add ``n`` units to ``dev``'s decayed recent-placement counter
        without logging a placement: the paged engine charges each decode
        step's rows, work that never passes a lane queue."""
        if n <= 0:
            return
        now = _time.monotonic()
        with self._lock:
            self._decayed(dev.key, now, float(n))

    def _recent_extras(self) -> "dict[str, float]":
        from repro_torch.core import executor

        now = _time.monotonic()
        out = {}
        with self._lock:
            for key, (count, stamp) in self._recent.items():
                c = count * 2.0 ** (-(now - stamp) / executor._LOAD_HALFLIFE)
                if c > 0.05:
                    out[key] = c
        return out

    def occupancy(self, dev, *, recent: bool = True) -> float:
        """Occupancy of one device as placement sees it: lane depth and
        decayed busy time, plus the steal pool's backlog and this
        scheduler's decayed recent placements unless ``recent=False`` (the
        structural probe of ``select_batch(prefer=...)``: a home's recent
        counter is mostly the caller's own charge)."""
        pending = 0
        if self._steal:
            with self._pump_lock:
                dq = self._pending.get(dev.key)
                pending = len(dq) if dq else 0
        extra = self._recent_extras().get(dev.key, 0.0) if recent else 0.0
        return _occupancy(_LoadView(dev, pending, extra))

    # -- memory-aware placement ------------------------------------------------

    def _limit_of(self, dev) -> int:
        if self._spill_bytes is not None:
            return int(self._spill_bytes)
        return int(getattr(dev, "memory_limit", 0) or 0)

    @staticmethod
    def _resident_of(dev) -> int:
        rb = getattr(dev, "resident_bytes", None)
        return int(rb()) if callable(rb) else 0

    def _fit_memory(self, devs: list, args: Sequence) -> list:
        """Drop candidates whose resident bytes plus the task's incoming
        (not already there) argument bytes exceed their threshold.  When
        nothing fits, the whole list comes back: the pick then spills."""
        limits = [self._limit_of(d) for d in devs]
        if not any(limits):
            return devs
        homes = [_arg_home(a) for a in args]
        fits = []
        for d, lim in zip(devs, limits):
            if not lim:
                fits.append(d)
                continue
            incoming = sum(nb for key, nb in homes if nb and key != d.key)
            if self._resident_of(d) + incoming <= lim:
                fits.append(d)
        return fits or devs

    def _maybe_spill(self, dev, args: Sequence) -> None:
        """After placing on ``dev``: if the task pushes it over its
        threshold, spill LRU buffers until the incoming bytes fit; the
        task's own arguments are never evicted."""
        lim = self._limit_of(dev)
        if not lim:
            return
        homes = [_arg_home(a) for a in args]
        incoming = sum(nb for key, nb in homes if nb and key != dev.key)
        need = self._resident_of(dev) + incoming - lim
        if need > 0:
            keep = {a.gid for a in args if hasattr(a, "gid")}
            self.spill_lru(dev, need, keep=keep)

    def spill_lru(self, dev, need_bytes: int, keep=()) -> list:
        """Submit spills of the least-recently-used buffers resident on
        ``dev`` until ``need_bytes`` are on their way to host memory;
        returns the spill futures (each True once its storage is
        released).  Buffers whose GID is in ``keep`` are never evicted, nor
        handles of another ``Device`` object under the same key (one of a
        runtime torn down by ``reset_runtime``, whose lanes are gone)."""
        from repro_torch.core import agas

        keep = set(keep)
        cands = []
        for gid in agas.registry.gids_on(dev.key, kind="buffer"):
            if gid in keep:
                continue
            try:
                b = agas.registry.resolve(gid)
            except KeyError:
                continue
            if callable(getattr(b, "spill", None)) and getattr(b, "device", None) is dev:
                cands.append(b)
        cands.sort(key=lambda b: getattr(b, "_last_use", 0.0))
        futs, freed = [], 0
        for b in cands:
            if freed >= need_bytes:
                break
            futs.append(b.spill())
            freed += b.nbytes
        return futs

    # -- placement ---------------------------------------------------------------

    def _views(self, devs: list) -> list:
        pending = {}
        if self._steal:
            with self._pump_lock:
                pending = {k: len(dq) for k, dq in self._pending.items() if dq}
        recent = self._recent_extras()
        if not pending and not recent:
            return devs
        out = []
        for d in devs:
            p = pending.get(d.key, 0)
            r = recent.get(d.key, 0.0)
            out.append(_LoadView(d, p, r) if (p or r) else d)
        return out

    def select(self, args: Sequence = (), program=None):
        cands = self._fit_memory(self._live(), args)
        dev = _unwrap(self.policy.select(self._views(cands), args=args, program=program))
        self._maybe_spill(dev, args)
        return self._record(dev)

    def select_batch(self, batch_args: "Sequence[Sequence]" = (), program=None,
                     prefer: "str | None" = None, prefer_slack: float = 16.0):
        """One placement decision for a micro-batch (every member's
        argument sequence), logged once in ``stats()``, with the same
        memory veto and load views as single launches.

        ``prefer`` is a sticky home (device key): under ``least_loaded`` a
        batch's own recent charge would make its home look busy and spray
        consecutive batches over the fleet.  So when the policy is
        ``least_loaded`` and the home is live, not vetoed and within
        ``prefer_slack`` queued submissions of the pick on structural
        occupancy (``occupancy(recent=False)``), the batch stays home.
        Other policies ignore the hint; ``stats()`` records the device
        actually chosen."""
        flat = [a for args in batch_args for a in args]
        live = self._live()
        if prefer is not None and self.policy.name == "least_loaded":
            # Every pick's structural occupancy is >= 0, so a home within
            # the slack of zero holds whatever the policy would choose.
            home = next((d for d in live if d.key == prefer), None)
            if (home is not None
                    and self.occupancy(home, recent=False) <= prefer_slack
                    and self._fit_memory([home], flat)):
                self._maybe_spill(home, flat)
                return self._record(home)
        cands = self._fit_memory(live, flat)
        dev = _unwrap(
            self.policy.select_batch(self._views(cands), batch_args=batch_args, program=program))
        if prefer is not None and dev.key != prefer and self.policy.name == "least_loaded":
            home = next((d for d in cands if d.key == prefer), None)
            if home is not None and (self.occupancy(home, recent=False)
                                     <= self.occupancy(dev, recent=False) + prefer_slack):
                dev = home
        self._maybe_spill(dev, flat)
        return self._record(dev)

    # -- steal pool ----------------------------------------------------------------

    @property
    def steals(self) -> bool:
        """True when launches route through the steal pool: stealing on and
        more than one device to balance across."""
        if not self._steal:
            return False
        try:
            return len(self.devices()) > 1
        except RuntimeError:
            return False

    def pending_depth(self, key: str) -> int:
        with self._pump_lock:
            dq = self._pending.get(key)
            return len(dq) if dq else 0

    def submit(self, program, args: Sequence = (), kernel: "str | None" = None, *,
               grid=None, block=None, out=None, sync: str = "ready"):
        """Schedule a launch through the steal pool: place it (``select``,
        the pending backlog folded into the load signal), park it on the
        chosen device's deque and return a future of the launch result.
        An idle sibling's pump may steal it off the tail; the result is the
        same either way."""
        from repro_torch.core.futures import Promise

        dev = self.select(args=args, program=program)
        nbytes = sum(_arg_home(a)[1] for a in args)
        promise = Promise(name=f"steal-pool:{kernel}")
        task = _PendingLaunch(program, args, kernel, grid, block, out, sync,
                              promise, nbytes, dev.key)
        with self._pump_lock:
            self._pending.setdefault(dev.key, deque()).append(task)
            backlog = len(self._pending[dev.key])
        self._ensure_pump(dev)
        if backlog > 1:
            # The owner is behind: wake every idle sibling so one can steal.
            for d in self._live():
                if d.key != dev.key:
                    self._ensure_pump(d)
        return promise.get_future()

    def _ensure_pump(self, dev) -> None:
        key = dev.key
        with self._pump_lock:
            if key in self._pumping:
                return
            self._pumping.add(key)
        from repro_torch.core.executor import get_runtime

        get_runtime().pool.submit(self._pump, dev)

    def _pump(self, dev) -> None:
        """One device's drain loop on the host pool: its own head first,
        then tail steals, then exit.  The pump blocks on each launch, so an
        idle pump is an idle device."""
        key = dev.key
        while True:
            with self._pump_lock:
                dq = self._pending.get(key)
                if dq:
                    task = dq.popleft()
                else:
                    task = self._steal_locked(dev)
                    if task is None:
                        self._pumping.discard(key)
                        return
            self._run_task(dev, task)

    def _steal_locked(self, thief) -> "_PendingLaunch | None":
        """Pop the tail of the deepest eligible sibling backlog (the caller
        holds ``_pump_lock``): a task is eligible when its argument bytes
        are at most ``REPRO_STEAL_MAX_BYTES``, divided by the
        cross-locality penalty when victim and thief live in different
        localities (a steal there costs a parcel pair per buffer)."""
        if not self._steal:
            return None
        thief_loc = locality_of_key(getattr(thief, "key", ""))
        for vkey, dq in sorted(self._pending.items(), key=lambda kv: -len(kv[1])):
            if vkey == thief.key or not dq:
                continue
            task = dq[-1]
            limit = self._steal_max_bytes
            cross = locality_of_key(vkey) != thief_loc
            if cross:
                limit //= self._cross_penalty
            if task.nbytes > limit:
                continue
            dq.pop()
            task.stolen = True
            self._steals += 1
            if cross:
                self._cross_steals += 1
            return task
        return None

    def _run_task(self, dev, task: "_PendingLaunch") -> None:
        try:
            args = task.args
            if task.stolen:
                args = self._prefetch_stolen_args(dev, args)
            prog = task.program
            if callable(getattr(prog, "for_device", None)):
                prog = prog.for_device(dev)  # re-bind: the thief's sibling program
            fut = prog.run(args, task.kernel, grid=task.grid, block=task.block,
                           out=task.out, sync=task.sync)
            task.promise.set_value(fut.get())
        except Exception as e:  # noqa: BLE001 - fails the caller's future
            try:
                task.promise.set_exception(e)
            except Exception:  # noqa: BLE001 - the consumer cancelled or raced
                pass

    def _prefetch_stolen_args(self, dev, args: Sequence) -> Sequence:
        """Batch-fetch remote argument buffers before a cross-locality
        stolen launch runs: one ``steal_fetch`` parcel a locality brings
        every array over (the shm lane carries large payloads) instead of
        one percolation round trip an argument inside ``run``.  Local
        buffers re-home through the launch's own percolation; any failure
        falls back to it too."""
        dev_loc = locality_of_key(getattr(dev, "key", ""))
        groups: "dict[tuple[int, int], tuple[Any, list[int]]]" = {}
        for i, a in enumerate(args):
            if not getattr(a, "is_remote_buffer", False):
                continue
            rdev = getattr(a, "device", None)
            port = getattr(rdev, "_port", None)
            loc = getattr(rdev, "locality_id", None)
            if port is None or loc is None or loc == dev_loc:
                continue
            groups.setdefault((id(port), loc), (port, []))[1].append(i)
        fetched = None
        for (_, loc), (port, idxs) in groups.items():
            if len(idxs) < 2:
                continue  # one buffer: plain percolation is one parcel anyway
            try:
                arrays = port.call(
                    loc, "steal_fetch", {"gids": [args[i].gid for i in idxs]}
                ).get()
            except Exception:  # noqa: BLE001 - fall back to percolation
                continue
            if fetched is None:
                fetched = list(args)
            for i, arr in zip(idxs, arrays):
                fetched[i] = arr
        return fetched if fetched is not None else args

    # -- introspection -------------------------------------------------------------

    def stats(self) -> "dict[str, int]":
        """Placement counts per device key (decision log, not queue state)."""
        with self._lock:
            return dict(self._placements)

    def steal_stats(self) -> dict:
        """Rebalancing counters: total steals, the cross-locality subset
        and the current pending backlog per device."""
        with self._pump_lock:
            return {
                "steals": self._steals,
                "cross_locality": self._cross_steals,
                "pending": {k: len(dq) for k, dq in self._pending.items() if dq},
            }

    def __repr__(self) -> str:
        n = len(self._devices) if self._devices is not None else "?"
        return f"Scheduler(policy={self.policy.name}, devices={n})"


_default: "Scheduler | None" = None
_default_lock = threading.Lock()


def get_scheduler() -> Scheduler:
    """Process-default scheduler (lazy fleet discovery, ``least_loaded``)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Scheduler()
    return _default


def set_scheduler(sched: "Scheduler | None") -> None:
    """Replace the process-default scheduler (None restores the lazy
    default)."""
    global _default
    with _default_lock:
        _default = sched


def _on_runtime_reset() -> None:
    """Drop the default scheduler with the runtime: it holds ``Device``
    handles whose lanes died (see ``executor.reset_runtime``)."""
    set_scheduler(None)
