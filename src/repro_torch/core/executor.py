"""Host-side execution resources: thread pools, static per-device queues,
and the lane-aware dispatcher behind streams.

HPXCL attaches every device operation to a lightweight user-level thread
under the *static* scheduling policy (one queue pinned per device — paper
§3/§4).  The PyTorch analogue: a ``WorkQueue`` is a single-thread FIFO
executor, used for a device's compile queue, plus a shared host pool for
continuations, I/O and ``async_`` tasks.

Lanes (DESIGN.md §11): a ``LaneDispatcher`` multiplexes N FIFO *lanes*
onto one shared worker pool — each lane is the ordering substrate of one
``repro_torch.core.stream.Stream`` (the ``cudaStream_t`` analogue).  At
most one task per lane runs at a time, so every lane preserves strict
submission order, while tasks on *different* lanes of the same device run
concurrently (transfer–compute overlap).

A lane may carry a ``torch.cuda.Stream`` (``Lane.cuda_stream``).  PyTorch's
current stream is thread-local, and lane tasks run on pool threads, so
each task of such a lane runs inside ``torch.cuda.stream(cuda_stream)``:
every copy and launch it enqueues lands on the lane's own CUDA stream
instead of the legacy default stream, and two lanes' device work can
overlap.

Ordering guarantees, stated once here because every layer above relies on
them:

* **Same-lane FIFO** — tasks submitted to one lane (one stream) execute
  strictly in submission order, never interleaved or reordered.
* **Cross-lane: none** — two lanes of the same dispatcher have NO implied
  ordering; synchronization between them is explicit (an ``Event``
  recorded in one stream and waited on in another — happens-before is
  then carried by the event's ``Future``).
* **Dispatcher barrier** — ``barrier()``/``drain()`` cover everything
  submitted to *any* lane before the call (``cudaDeviceSynchronize``).

Load accounting (DESIGN.md §9): every queue and lane counts submissions
and completions and tracks how long its worker has been busy, so a
placement policy (``least_loaded``) can read a real backlog signal off
``WorkQueue.load()`` / ``LaneDispatcher.load()`` (the per-lane depths are
summed — a device busy on three lanes reports a depth of three) instead
of guessing.  Counters are monotonically increasing; the snapshot is
advisory (reads are unsynchronized with the worker by design — scheduling
decisions tolerate a stale-by-one view).
"""
from __future__ import annotations

import atexit
import concurrent.futures as _cf
import os
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from collections import deque

from contextlib import contextmanager

import torch

from repro_torch.core.futures import Future

__all__ = [
    "QueueLoad",
    "WorkQueue",
    "Lane",
    "LaneDispatcher",
    "Runtime",
    "get_runtime",
    "reset_runtime",
    "coalesce",
    "flush_coalesced",
]


# ---------------------------------------------------------------------------
# submission coalescing (DESIGN.md §13)
#
# A queue hop costs two thread wakeups (worker kick + result wakeup); a
# batched enqueue pays them once for N tasks (the submit_many row in
# BENCH_overhead).  ``coalesce()`` makes that batching the *default* for
# any code that submits several tasks before blocking: inside the scope,
# ``submit``/``submit_many`` on any Lane or WorkQueue stage their items in
# a thread-local buffer instead of waking a worker, and the whole window
# flushes as ONE enqueue per touched queue.  The window adapts to the
# caller's natural batch boundary: it closes at scope exit, and *any*
# blocking operation — ``Future.get``/``exception``, ``drain``,
# ``barrier`` — flushes first, so a task whose result is awaited inside
# the scope can never deadlock behind its own staged submission.
#
# Load honesty (DESIGN.md §9): staged items bump their queue's submitted
# counter at STAGE time, so ``load().depth`` sees a coalesced batch the
# moment it is placed — coalescing must not blind the least_loaded signal.
# ---------------------------------------------------------------------------

_coalesce_tls = threading.local()

_COALESCE_ENABLED = os.environ.get("REPRO_COALESCE", "auto").lower() != "off"
# Safety valve: a pathologically large window degrades to eager flushes
# (bounded staging memory; the batch is already big enough to amortize).
_COALESCE_CAP = int(os.environ.get("REPRO_COALESCE_CAP", "256"))

# Load-signal decay (DESIGN.md §14): completed busy-time folds into an
# exponentially decayed accumulator so ``least_loaded`` scores *recent*
# occupancy instead of a lifetime total (which never forgets) or the
# instantaneous depth (which is stale by the time a batch lands).
# REPRO_LOAD_HALFLIFE is the half-life in seconds: work done one half-life
# ago counts half as much as work finishing now.
_LOAD_HALFLIFE = float(os.environ.get("REPRO_LOAD_HALFLIFE", "0.25") or 0.25)
_LN2 = 0.6931471805599453


def _fold_busy(decayed: float, stamp: float, duration: float, now: float) -> float:
    """Decay the busy accumulator to ``now`` and fold in a finished task."""
    return decayed * 2.0 ** (-(now - stamp) / _LOAD_HALFLIFE) + duration


def _busy_ewma(decayed: float, stamp: float, busy_for: float, now: float) -> float:
    """Utilization-like occupancy score from the decayed accumulator.

    Normalized by the decay time-constant tau = halflife/ln2: a worker that
    has been continuously busy scores ~1.0, an idle one decays toward 0.
    The currently-running task contributes its elapsed time (capped at tau)
    so long tasks register before they complete.
    """
    tau = _LOAD_HALFLIFE / _LN2
    return (decayed * 2.0 ** (-(now - stamp) / _LOAD_HALFLIFE) + min(busy_for, tau)) / tau


class _CoalesceScope:
    __slots__ = ("targets", "depth")

    def __init__(self):
        # id(queue) -> (queue, staged item list); insertion-ordered so
        # flush preserves cross-queue submission order.
        self.targets: "dict[int, tuple[Any, list]]" = {}
        self.depth = 1

    def stage(self, q, items: list) -> None:
        entry = self.targets.get(id(q))
        if entry is None:
            self.targets[id(q)] = (q, list(items))
        else:
            entry[1].extend(items)
            if len(entry[1]) >= _COALESCE_CAP:
                del self.targets[id(q)]
                q._flush_items(entry[1])

    def flush(self) -> None:
        targets, self.targets = self.targets, {}
        for q, items in targets.values():
            q._flush_items(items)


def _current_scope() -> "_CoalesceScope | None":
    return getattr(_coalesce_tls, "scope", None)


def flush_coalesced() -> None:
    """Flush this thread's staged submissions (if any) without closing the
    scope.  Called automatically by every blocking primitive; safe and
    near-free (one TLS read) when nothing is staged."""
    scope = getattr(_coalesce_tls, "scope", None)
    if scope is not None and scope.targets:
        scope.flush()


@contextmanager
def coalesce():
    """Batch every ``submit`` in this scope into one enqueue per queue.

    Same-queue FIFO order is exactly preserved (the staged batch occupies
    one queue slot and runs uninterleaved, the ``submit_many`` contract);
    results are identical to unscoped submission — only the number of
    worker wakeups changes.  Nesting is flattened into the outermost
    scope.  Blocking inside the scope (``Future.get``, ``drain``,
    ``barrier``) flushes staged work first, so awaiting a staged task's
    result is always safe.  ``REPRO_COALESCE=off`` disables staging
    (the scope becomes a no-op)."""
    if not _COALESCE_ENABLED:
        yield
        return
    scope = getattr(_coalesce_tls, "scope", None)
    if scope is not None:
        scope.depth += 1
        try:
            yield
        finally:
            scope.depth -= 1
        return
    scope = _coalesce_tls.scope = _CoalesceScope()
    try:
        yield
    finally:
        _coalesce_tls.scope = None
        scope.flush()


@dataclass(frozen=True)
class QueueLoad:
    """Snapshot of one queue's backlog (the ``least_loaded`` signal).

    ``depth`` counts submissions not yet completed (queued + running);
    ``inflight`` is 1 while the worker is inside a task; ``busy_for`` is
    how long the current task has been running (0.0 when idle) and
    ``busy_time`` the lifetime total of task execution seconds.
    ``busy_ewma`` is the exponentially-decayed recent occupancy normalized
    to ~[0, 1] per worker (DESIGN.md §14) — the half of the honest load
    signal that survives between depth samples.
    """

    depth: int
    inflight: int
    busy_for: float
    busy_time: float
    submitted: int
    completed: int
    busy_ewma: float = 0.0


class WorkQueue:
    """Single-worker FIFO queue — the 'static scheduling policy' of HPXCL.

    Submissions execute strictly in order; each returns a ``Future``.  This
    is the submission-ordering analogue of a CUDA stream (DESIGN.md §2).
    """

    def __init__(self, name: str):
        self.name = name
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._shutdown = threading.Event()
        # Load accounting: _submitted is bumped under _count_lock (many
        # submitter threads); _completed/_busy_* have a single writer (the
        # worker) and need no lock.
        self._count_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._busy_time = 0.0
        self._busy_since: "float | None" = None
        # Decayed occupancy (single writer: the worker thread).
        self._decayed_busy = 0.0
        self._decay_stamp = time.monotonic()
        self._thread = threading.Thread(target=self._loop, name=f"wq:{name}", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if type(item) is list:  # batched enqueue (submit_many)
                for sub in item:
                    self._run_one(sub)
            else:
                self._run_one(item)
            # Drop the reference while blocked in get(): a worker idling on
            # an empty queue must not pin its last result (the futures keep
            # results alive for their owners; the queue should not).
            del item

    def _run_one(self, item) -> None:
        fut, fn, args, kwargs = item
        self._busy_since = time.monotonic()
        try:
            if fut._cf.set_running_or_notify_cancel():
                try:
                    fut._cf.set_result(fn(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001
                    fut._cf.set_exception(e)
        finally:
            t0, self._busy_since = self._busy_since, None
            now = time.monotonic()
            self._busy_time += now - t0
            self._decayed_busy = _fold_busy(self._decayed_busy, self._decay_stamp, now - t0, now)
            self._decay_stamp = now
            self._completed += 1

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        if self._shutdown.is_set():
            raise RuntimeError(f"WorkQueue {self.name} is shut down")
        fut: Future = Future(name=f"{self.name}:{getattr(fn, '__name__', 'task')}")
        with self._count_lock:
            self._submitted += 1
        item = (fut, fn, args, kwargs)
        scope = _current_scope()
        if scope is not None:
            scope.stage(self, [item])
        else:
            self._q.put(item)
        return fut

    def _flush_items(self, items: list) -> None:
        """Enqueue staged items as one batch (counters already bumped at
        stage time — see ``coalesce``)."""
        if self._shutdown.is_set():
            err = RuntimeError(f"WorkQueue {self.name} shut down with staged submissions")
            for fut, _, _, _ in items:
                try:
                    fut._cf.set_exception(err)
                except Exception:  # noqa: BLE001 - already resolved/cancelled
                    pass
            return
        self._q.put(items if len(items) > 1 else items[0])

    def submit_many(self, calls) -> "list[Future]":
        """Batched enqueue: one queue hop for N calls (DESIGN.md §8).

        ``calls`` is an iterable of callables or ``(fn, args)`` /
        ``(fn, args, kwargs)`` tuples.  The batch occupies a single queue
        slot, so the per-submission put/wakeup cost is paid once; the
        calls still run strictly in the given order, uninterleaved with
        other submissions.  Returns one ``Future`` per call.
        """
        if self._shutdown.is_set():
            raise RuntimeError(f"WorkQueue {self.name} is shut down")
        batch = []
        futs: "list[Future]" = []
        for c in calls:
            if callable(c):
                fn, args, kwargs = c, (), {}
            else:
                fn = c[0]
                args = c[1] if len(c) > 1 else ()
                kwargs = c[2] if len(c) > 2 else {}
            fut: Future = Future(name=f"{self.name}:{getattr(fn, '__name__', 'task')}")
            futs.append(fut)
            batch.append((fut, fn, args, kwargs))
        if batch:
            with self._count_lock:
                self._submitted += len(batch)
            scope = _current_scope()
            if scope is not None:
                scope.stage(self, batch)
            else:
                self._q.put(batch)
        return futs

    def load(self) -> QueueLoad:
        """Advisory backlog snapshot (see module docstring)."""
        submitted, completed = self._submitted, self._completed
        since = self._busy_since
        now = time.monotonic()
        busy_for = (now - since) if since is not None else 0.0
        return QueueLoad(
            depth=max(0, submitted - completed),
            inflight=1 if since is not None else 0,
            busy_for=busy_for,
            busy_time=self._busy_time,
            submitted=submitted,
            completed=completed,
            busy_ewma=_busy_ewma(self._decayed_busy, self._decay_stamp, busy_for, now),
        )

    def drain(self) -> None:
        """Block until everything submitted so far has run."""
        self.submit(lambda: None).get()

    def shutdown(self) -> None:
        if not self._shutdown.is_set():
            self._shutdown.set()
            self._q.put(None)
            self._thread.join(timeout=5)


def _normalize_call(c) -> tuple:
    """(fn, args, kwargs) from a callable or (fn[, args[, kwargs]]) tuple."""
    if callable(c):
        return c, (), {}
    fn = c[0]
    args = c[1] if len(c) > 1 else ()
    kwargs = c[2] if len(c) > 2 else {}
    return fn, args, kwargs


class Lane:
    """One FIFO lane of a ``LaneDispatcher`` — a stream's ordering substrate.

    Duck-types ``WorkQueue`` (``submit`` / ``submit_many`` / ``load`` /
    ``drain`` / ``name``) so every layer written against per-device queues
    works unchanged against a lane.  At most one task of this lane runs at
    a time (same-lane FIFO); the running happens on the dispatcher's
    shared pool, so independent lanes execute concurrently.
    """

    def __init__(self, dispatcher: "LaneDispatcher", name: str):
        self.dispatcher = dispatcher
        self.name = name
        self._pending: deque = deque()
        self._lock = threading.Lock()  # guards _pending + the active handoff
        self._active = False
        self._submitted = 0
        # Single-writer counters (only one pool thread runs this lane at a
        # time — the _active handoff guarantees it): no lock needed.
        self._completed = 0
        self._busy_time = 0.0
        self._busy_since: "float | None" = None
        self._decayed_busy = 0.0
        self._decay_stamp = time.monotonic()
        # CUDA stream every task of this lane enqueues its device work on
        # (set by the owning Device; None for host-only lanes).
        self.cuda_stream: "torch.cuda.Stream | None" = None

    def _put(self, items: list) -> None:
        d = self.dispatcher
        if d._shutdown.is_set():
            raise RuntimeError(f"Lane {self.name} is shut down")
        scope = _current_scope()
        if scope is not None:
            # Stage for one flush per lane; submitted is bumped NOW so the
            # scheduler's depth signal sees the coalesced batch immediately.
            with self._lock:
                self._submitted += len(items)
            scope.stage(self, items)
            return
        with self._lock:
            self._submitted += len(items)
            self._pending.extend(items)
            kick = not self._active
            if kick:
                self._active = True
        if kick:
            d._pool.submit(self._run)

    def _flush_items(self, items: list) -> None:
        """Hand staged items to the lane as one batch (one pool kick at
        most; counters were bumped at stage time)."""
        d = self.dispatcher
        if d._shutdown.is_set():
            err = RuntimeError(f"Lane {self.name} shut down with staged submissions")
            for fut, _, _, _ in items:
                try:
                    fut._cf.set_exception(err)
                except Exception:  # noqa: BLE001 - already resolved/cancelled
                    pass
            return
        with self._lock:
            self._pending.extend(items)
            kick = not self._active
            if kick:
                self._active = True
        if kick:
            d._pool.submit(self._run)

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        fut: Future = Future(name=f"{self.name}:{getattr(fn, '__name__', 'task')}")
        self._put([(fut, fn, args, kwargs)])
        return fut

    def submit_many(self, calls) -> "list[Future]":
        """Batched enqueue: one handoff for N ordered calls (``WorkQueue``
        contract — the calls run in order, uninterleaved with later
        submissions to this lane)."""
        items = []
        futs: "list[Future]" = []
        for c in calls:
            fn, args, kwargs = _normalize_call(c)
            fut: Future = Future(name=f"{self.name}:{getattr(fn, '__name__', 'task')}")
            futs.append(fut)
            items.append((fut, fn, args, kwargs))
        if items:
            self._put(items)
        return futs

    def _run(self) -> None:
        """Drain the lane on a pool worker; exactly one runner at a time."""
        d = self.dispatcher
        d._note_lane_active(+1)
        try:
            while True:
                with self._lock:
                    if not self._pending:
                        self._active = False
                        return
                    item = self._pending.popleft()
                self._run_one(item)
        finally:
            d._note_lane_active(-1)

    def _run_one(self, item) -> None:
        fut, fn, args, kwargs = item
        self._busy_since = time.monotonic()
        try:
            if fut._cf.set_running_or_notify_cancel():
                try:
                    cs = self.cuda_stream
                    if cs is None:
                        fut._cf.set_result(fn(*args, **kwargs))
                    else:
                        with torch.cuda.stream(cs):
                            fut._cf.set_result(fn(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001
                    fut._cf.set_exception(e)
        finally:
            t0, self._busy_since = self._busy_since, None
            now = time.monotonic()
            self._busy_time += now - t0
            self._decayed_busy = _fold_busy(self._decayed_busy, self._decay_stamp, now - t0, now)
            self._decay_stamp = now
            self._completed += 1

    def load(self) -> QueueLoad:
        """Advisory backlog snapshot (same contract as ``WorkQueue.load``)."""
        submitted, completed = self._submitted, self._completed
        since = self._busy_since
        now = time.monotonic()
        busy_for = (now - since) if since is not None else 0.0
        return QueueLoad(
            depth=max(0, submitted - completed),
            inflight=1 if since is not None else 0,
            busy_for=busy_for,
            busy_time=self._busy_time,
            submitted=submitted,
            completed=completed,
            busy_ewma=_busy_ewma(self._decayed_busy, self._decay_stamp, busy_for, now),
        )

    def drain(self) -> None:
        """Block until everything submitted to THIS lane so far has run."""
        self.submit(lambda: None).get()

    def __repr__(self) -> str:
        return f"Lane({self.name}, depth={self.load().depth})"


class LaneDispatcher:
    """N FIFO lanes multiplexed onto one shared pool (DESIGN.md §11).

    The device-side half of the stream engine: each ``Stream`` owns one
    lane; the dispatcher hands runnable lanes to the pool and tracks how
    many lanes are executing at once (``high_water()`` — the observable
    proof that transfer–compute overlap actually happened).
    """

    def __init__(self, name: str, pool: "_cf.ThreadPoolExecutor"):
        self.name = name
        self._pool = pool
        self._lanes: "dict[str, Lane]" = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._active_lanes = 0
        self._high_water = 0

    def lane(self, name: str) -> Lane:
        """The lane called ``name`` (created on first use)."""
        with self._lock:
            ln = self._lanes.get(name)
            if ln is None:
                ln = self._lanes[name] = Lane(self, f"{self.name}/{name}")
            return ln

    def lanes(self) -> "list[Lane]":
        with self._lock:
            return list(self._lanes.values())

    # -- concurrency accounting (single counter, one lock) -------------------

    def _note_lane_active(self, delta: int) -> None:
        with self._lock:
            self._active_lanes += delta
            if self._active_lanes > self._high_water:
                self._high_water = self._active_lanes

    def high_water(self) -> int:
        """Max lanes ever observed running concurrently (>1 == overlap)."""
        with self._lock:
            return self._high_water

    def reset_high_water(self) -> None:
        with self._lock:
            self._high_water = self._active_lanes

    # -- aggregate signals ---------------------------------------------------

    def load(self) -> QueueLoad:
        """Whole-device backlog: per-lane depths summed (DESIGN.md §9 —
        the scheduler's load signal counts every lane, so a device busy on
        three streams is three deep, not one)."""
        depth = inflight = submitted = completed = 0
        busy_for = busy_time = busy_ewma = 0.0
        for ln in self.lanes():
            l = ln.load()
            depth += l.depth
            inflight += l.inflight
            busy_for = max(busy_for, l.busy_for)
            busy_time += l.busy_time
            submitted += l.submitted
            completed += l.completed
            busy_ewma += l.busy_ewma
        return QueueLoad(depth, inflight, busy_for, busy_time, submitted, completed, busy_ewma)

    # -- synchronization ------------------------------------------------------

    def barrier(self) -> Future:
        """Future resolving when everything submitted to ANY lane before
        this call has completed (async ``cudaDeviceSynchronize``).  Markers
        go to every lane in parallel — a barrier never serializes lanes."""
        from repro_torch.core.futures import when_all

        flush_coalesced()  # staged work counts as "submitted before the call"
        markers = [ln.submit(lambda: None) for ln in self.lanes()]
        flush_coalesced()  # the markers themselves must not linger staged
        return when_all(markers, name=f"barrier:{self.name}").then(
            lambda _: None, executor="inline"
        )

    def drain(self) -> None:
        """Blocking ``barrier()``."""
        self.barrier().get()

    def shutdown(self) -> None:
        self._shutdown.set()

    def __repr__(self) -> str:
        return f"LaneDispatcher({self.name}, {len(self._lanes)} lane(s))"


class Runtime:
    """Process-wide execution resources (HPX thread-manager analogue)."""

    def __init__(self, host_workers: Optional[int] = None):
        # generous: workers mostly *wait* (device readiness, queue results,
        # file I/O), so oversubscription is the deadlock-safe choice
        n = host_workers or max(32, 4 * (os.cpu_count() or 1))
        self.pool = _cf.ThreadPoolExecutor(max_workers=n, thread_name_prefix="repro-host")
        # Lanes get their own pool: a parked lane task (a launch waiting on
        # its build future, a graph segment on its producers) must never
        # starve host continuations of workers.  Same oversubscription
        # argument as the host pool — lane tasks mostly wait.
        self.lane_pool = _cf.ThreadPoolExecutor(max_workers=n, thread_name_prefix="repro-lane")
        self._queues: dict[str, WorkQueue] = {}
        self._dispatchers: "dict[str, LaneDispatcher]" = {}
        self._lock = threading.Lock()

    def queue(self, name: str) -> WorkQueue:
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = WorkQueue(name)
            return q

    def dispatcher(self, name: str) -> LaneDispatcher:
        """The lane dispatcher called ``name`` (one per device; created on
        first use) — the multi-stream twin of ``queue()``."""
        with self._lock:
            d = self._dispatchers.get(name)
            if d is None:
                d = self._dispatchers[name] = LaneDispatcher(name, self.lane_pool)
            return d

    def async_(self, fn: Callable, *args, **kwargs) -> Future:
        return Future.from_concurrent(self.pool.submit(fn, *args, **kwargs))

    def shutdown(self) -> None:
        with self._lock:
            queues, self._queues = list(self._queues.values()), {}
            dispatchers, self._dispatchers = list(self._dispatchers.values()), {}
        for d in dispatchers:
            d.shutdown()
        for q in queues:
            q.shutdown()
        self.pool.shutdown(wait=False)
        self.lane_pool.shutdown(wait=False)


_runtime: Optional[Runtime] = None
_runtime_lock = threading.Lock()
# Called by reset_runtime after the device and scheduler caches are
# dropped: a layer above the core that caches runtime objects registers
# its own reset here when it is imported (on_runtime_reset).
_reset_hooks: "list[Callable[[], None]]" = []


def on_runtime_reset(fn: "Callable[[], None]") -> "Callable[[], None]":
    """Register ``fn`` to run at every ``reset_runtime``; returns ``fn``."""
    _reset_hooks.append(fn)
    return fn


def get_runtime() -> Runtime:
    global _runtime
    if _runtime is None:
        with _runtime_lock:
            if _runtime is None:
                _runtime = Runtime()
                atexit.register(_runtime.shutdown)
    return _runtime


def reset_runtime() -> None:
    """Tear down and replace the global runtime (tests).

    Cached ``Device`` objects hold lanes and queues owned by the runtime
    being torn down; leaving them cached means the next ``submit`` hits a
    dead queue ("WorkQueue ... is shut down").  The device cache is
    therefore dropped with the runtime — the next discovery re-registers
    devices against the fresh runtime's queues.
    """
    flush_coalesced()  # staged submissions must not straddle the reset
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
        _runtime = None
    # Local imports: device and scheduler import this module at top level.
    from repro_torch.core import device as _device
    from repro_torch.core import scheduler as _scheduler

    _device._on_runtime_reset()
    _scheduler._on_runtime_reset()
    for hook in list(_reset_hooks):
        hook()
