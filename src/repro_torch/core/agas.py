"""AGAS analogue: a process-global registry of Global IDs (paper §3, §4).

Every runtime object (device, buffer, program) is registered under a GID;
client handles hold the GID and resolve through the registry, which makes
them location-transparent: moving the backing data to another device only
updates the placement record, never the handle.  A ``Device`` is local
to the process (``process_index`` 0); the devices of other processes are
reached through a parcel port's ``RemoteDevice`` proxies.

Locality-scoped GIDs (DESIGN.md §10): every process is one *locality*;
parcelport workers call ``set_locality_id`` at startup, and every GID they
mint carries their locality in its high bits (``locality_of`` recovers
it).  Cross-locality resolution happens through *proxy records*: when a
remote object's handle (e.g. ``RemoteBuffer``) arrives here, it registers
itself under the remote-minted GID via ``register_proxy`` — the same GID
then resolves on both sides of the wire, to the object on its owner and
to the proxy everywhere else.  A GID that is neither local nor proxied
raises a ``KeyError`` naming the owning locality.

Scheduler support (DESIGN.md §9): alongside the forward GID map the
registry maintains a *reverse* index ``device_key -> {GID}`` and a
per-device resident-bytes counter (fed by ``nbytes`` registration
metadata).  The ``affinity`` placement policy scores candidate devices
from these records in O(args) instead of scanning every registration —
the AGAS placement data is the percolation-avoidance signal.

Spill residency (DESIGN.md §14): a buffer evicted to host memory moves
its placement record to the pseudo-device ``HOST_KEY`` — the bytes leave
the device's resident total (placement veto sees the truth) and
``resident_bytes(HOST_KEY)`` reports the spilled pool.  The GID never
changes; refetch moves the record back.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "GID",
    "HOST_KEY",
    "Placement",
    "Registry",
    "registry",
    "set_locality_id",
    "get_locality_id",
    "locality_of",
]

GID = int

# Placement key for data spilled out of device memory into host RAM.  Not a
# schedulable device: policies never place work on it, but the reverse index
# and byte accounting treat it like any other location.
HOST_KEY = "host"

# Locality scoping: GID = (locality_id << _LOC_SHIFT) | sequence.  The
# parent process is locality 0 (seed-compatible: its GIDs are unchanged);
# parcelport workers are assigned unique nonzero ids before minting.
_LOC_SHIFT = 40
_locality_id = 0


def set_locality_id(locality_id: int) -> None:
    """Declare this process's locality (parcelport workers, at startup)."""
    global _locality_id
    _locality_id = int(locality_id)


def get_locality_id() -> int:
    return _locality_id


def locality_of(gid: GID) -> int:
    """The locality that minted ``gid``."""
    return gid >> _LOC_SHIFT


@dataclass(frozen=True)
class Placement:
    """Where an object's backing data lives."""

    device_key: str  # e.g. "cpu:0", "cuda:0"
    process_index: int = 0
    mesh_axes: "tuple[str, ...] | None" = None  # set for mesh-sharded objects
    spec: Any = None  # PartitionSpec for mesh-sharded objects

    @property
    def is_sharded(self) -> bool:
        return self.mesh_axes is not None


@dataclass
class _Record:
    obj: Any  # the object itself, or a weakref.ref to it (weak=True)
    placement: Placement
    kind: str = "object"
    meta: dict = field(default_factory=dict)
    weak: bool = False

    def target(self) -> Any:
        return self.obj() if self.weak else self.obj


class Registry:
    """GID -> (object, placement). Thread-safe; one per process.

    Registrations may carry ``nbytes=<int>`` metadata; the registry then
    keeps per-device resident-byte totals in sync across
    ``register`` / ``update_placement`` / ``unregister``.

    Finalizers of collected objects call ``retire``, never ``unregister``:
    a garbage collection can run at any allocation, also on a thread that
    holds this registry's lock, and a finalizer taking the lock there
    deadlocks the thread (and then every thread that asks the registry).
    ``retire`` only queues the GID; the next call that takes the lock
    drops it.
    """

    def __init__(self):
        self._counter = itertools.count(1)
        self._records: dict[GID, _Record] = {}
        self._by_device: dict[str, set[GID]] = {}
        self._bytes: dict[str, int] = {}
        self._lock = threading.Lock()
        self._retired: "deque[GID]" = deque()  # appended without the lock

    # -- index maintenance (call with lock held) ----------------------------

    def _drain_retired(self) -> None:
        while self._retired:
            gid = self._retired.popleft()
            rec = self._records.pop(gid, None)
            if rec is not None:
                self._index_remove(gid, rec)

    def _index_add(self, gid: GID, rec: _Record) -> None:
        key = rec.placement.device_key
        self._by_device.setdefault(key, set()).add(gid)
        nb = rec.meta.get("nbytes", 0)
        if nb:
            self._bytes[key] = self._bytes.get(key, 0) + nb

    def _index_remove(self, gid: GID, rec: _Record) -> None:
        key = rec.placement.device_key
        gids = self._by_device.get(key)
        if gids is not None:
            gids.discard(gid)
            if not gids:
                del self._by_device[key]
        nb = rec.meta.get("nbytes", 0)
        if nb:
            left = self._bytes.get(key, 0) - nb
            if left > 0:
                self._bytes[key] = left
            else:
                self._bytes.pop(key, None)

    # -- core surface -------------------------------------------------------

    def register(self, obj: Any, placement: Placement, kind: str = "object", **meta) -> GID:
        # The registry is an address book, not an owner: objects are held
        # weakly when possible so a dropped Buffer/Program can be GC'd and
        # its finalizer can retire this record (HPX AGAS ref-counts; here
        # the CPython GC plays that role).
        try:
            store, weak = weakref.ref(obj), True
        except TypeError:
            store, weak = obj, False
        gid = (_locality_id << _LOC_SHIFT) | next(self._counter)
        with self._lock:
            self._drain_retired()
            rec = self._records[gid] = _Record(store, placement, kind, dict(meta), weak)
            self._index_add(gid, rec)
        return gid

    def register_proxy(self, obj: Any, gid: GID, placement: Placement, kind: str = "proxy", **meta) -> bool:
        """Insert a record under a *foreign-minted* GID (cross-locality
        resolution: the remote object's local proxy answers for its GID).
        Returns False — and registers nothing — when the GID already
        resolves here (e.g. loopback transports, where the "remote" object
        lives in this very registry)."""
        try:
            store, weak = weakref.ref(obj), True
        except TypeError:
            store, weak = obj, False
        with self._lock:
            self._drain_retired()
            if gid in self._records:
                return False
            rec = self._records[gid] = _Record(store, placement, kind, dict(meta), weak)
            self._index_add(gid, rec)
        return True

    def _missing(self, gid: GID) -> KeyError:
        owner = locality_of(gid)
        if owner != _locality_id:
            return KeyError(
                f"GID {gid} is owned by locality L{owner} and has no proxy here; "
                "resolve it through a parcelport"
            )
        return KeyError(f"GID {gid} is not registered")

    def resolve(self, gid: GID) -> Any:
        with self._lock:
            self._drain_retired()
            rec = self._records.get(gid)
        if rec is None:
            raise self._missing(gid)
        obj = rec.target()
        if obj is None:
            raise KeyError(f"GID {gid} refers to a collected object")
        return obj

    def placement(self, gid: GID) -> Placement:
        with self._lock:
            self._drain_retired()
            rec = self._records.get(gid)
        if rec is None:
            raise self._missing(gid)
        return rec.placement

    def update_placement(self, gid: GID, placement: Placement) -> None:
        with self._lock:
            self._drain_retired()
            rec = self._records.get(gid)
            if rec is None:
                raise KeyError(f"GID {gid} is not registered")
            self._index_remove(gid, rec)
            rec.placement = placement
            self._index_add(gid, rec)

    def update_nbytes(self, gid: GID, nbytes: int) -> None:
        """Re-declare a registration's resident size (page pools and other
        growable objects whose footprint changes after registration).  The
        reverse-index byte totals move with it, so the scheduler's
        memory veto and spill accounting track the *current* footprint —
        a pool slab registers its slab bytes once, then a paged KV cache
        re-charges each sequence's pages as they are allocated/freed."""
        with self._lock:
            self._drain_retired()
            rec = self._records.get(gid)
            if rec is None:
                raise KeyError(f"GID {gid} is not registered")
            self._index_remove(gid, rec)
            rec.meta["nbytes"] = int(nbytes)
            self._index_add(gid, rec)

    def unregister(self, gid: GID) -> None:
        with self._lock:
            self._drain_retired()
            rec = self._records.pop(gid, None)
            if rec is not None:
                self._index_remove(gid, rec)

    def retire(self, gid: GID) -> None:
        """``unregister`` for finalizers: queued without taking the lock,
        dropped by the next call that takes it."""
        self._retired.append(gid)

    def by_kind(self, kind: str) -> "list[tuple[GID, Any]]":
        with self._lock:
            self._drain_retired()
            out = []
            for g, r in self._records.items():
                if r.kind != kind:
                    continue
                obj = r.target()
                if obj is not None:
                    out.append((g, obj))
            return out

    # -- scheduler queries (reverse index) ----------------------------------

    def gids_on(self, device_key: str, kind: "str | None" = None) -> "list[GID]":
        """GIDs whose placement is ``device_key`` (optionally one kind)."""
        with self._lock:
            self._drain_retired()
            gids = self._by_device.get(device_key)
            if not gids:
                return []
            if kind is None:
                return list(gids)
            return [g for g in gids if self._records[g].kind == kind]

    def resident_bytes(self, device_key: str) -> int:
        """Total registered bytes currently placed on ``device_key``."""
        with self._lock:
            self._drain_retired()
            return self._bytes.get(device_key, 0)

    def resident_bytes_by_device(self) -> "dict[str, int]":
        with self._lock:
            self._drain_retired()
            return dict(self._bytes)

    def spilled_bytes(self) -> int:
        """Total bytes currently evicted to host RAM (``HOST_KEY`` pool)."""
        return self.resident_bytes(HOST_KEY)

    def __len__(self) -> int:
        with self._lock:
            self._drain_retired()
            return len(self._records)


registry = Registry()
