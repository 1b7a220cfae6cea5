"""Continuous-batching request engine on the futurized runtime (DESIGN.md §12):
the port of ``src/repro/serving/engine.py``.

Callers submit *individual* requests; the card only stays busy when those
requests execute as batches.  ``RequestEngine`` is that multiplexing layer,
built on the runtime's own primitives (futures, streams, the placement
scheduler, graph replay):

* **Admission queue + backpressure.**  ``submit`` enqueues one request and
  returns a ``Future`` at once.  The queue is bounded: a full queue raises
  ``QueueFull`` at the call site.  A pending request can be ``cancel()``-ed
  through its future; cancelled entries are dropped at batch assembly.

* **Micro-batching.**  A batcher thread groups compatible requests (same
  kind, same pytree structure, same per-row leaf shapes and dtypes, equal
  broadcast (0-d) leaves) into micro-batches, bounded by ``max_batch`` rows
  and a ``max_delay_s`` deadline from the oldest member's arrival.  Batches
  are padded with zero rows up to *bucketed* row counts (powers of two up
  to ``max_batch``), so a handful of shapes serve every occupancy.

* **Placement.**  Each micro-batch is one decision of the placement
  scheduler (``Scheduler.select_batch``), sticky by route (``prefer``).

* **Execution.**  On a device the step runs as a captured ``TaskGraph``
  replayed with feeds on an engine-owned stream (``exe.replay(feeds=...,
  stream=s)``): on a card, one CUDA graph a (device, route, bucket).  A
  step that cannot be captured (a host sync such as ``.item()``, a
  data-dependent shape) falls back to a direct call on the same stream,
  with the same results.  Placement on another locality (apply parcels)
  and steps named by a registered kernel name wait for the parcel port
  (ROADMAP.md Queue 1 item 10) and are refused.

* **Per-request results.**  The batched output's leading axis is sliced
  back per member: every caller's future resolves with exactly its rows,
  as host values like ``Buffer.enqueue_read``'s (``np.ndarray``; a CPU
  tensor for bfloat16), equal to running that request alone through the
  same step when the step is row-independent.

* **Metrics.**  ``metrics()`` snapshots request counts, batch/row/padding
  totals, queue depth and high water, latency p50/p99 and requests/s.

Leaves may be numpy arrays or scalars (ml_dtypes bfloat16 included),
Python scalars, or torch tensors on any device (a CUDA tensor comes to the
host, as the reference pulls a device array with ``np.asarray``).  Batches
key by ``torch.dtype``.  The step receives a pytree of tensors on the
placed device: the row leaves concatenated (leading axis = bucket), the
broadcast leaves as 0-d tensors.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.buffer import _host_tensor, _to_host, _to_host_value, torch_dtype
from repro_torch.core.executor import coalesce
from repro_torch.core.futures import Future, Promise
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["RequestEngine", "QueueFull", "EngineClosed", "LanePolicy"]

_PARCELS = "ROADMAP.md Queue 1 item 10"


class QueueFull(RuntimeError):
    """Backpressure: the admission queue is at capacity — shed or retry."""


class EngineClosed(RuntimeError):
    """The engine no longer accepts (or will never run) this request."""


def _now() -> float:
    return time.monotonic()


@dataclass(frozen=True)
class LanePolicy:
    """Per-kind batching policy (prefill/decode disaggregation).

    *Prefill* is throughput-bound — batch as many prompt tokens as fit a
    budget, tolerate a longer assembly window — while *decode* is
    latency-bound — dispatch at a tight deadline, rows are cheap.  ``None``
    fields inherit the engine-wide default.  ``token_budget`` bounds a
    batch by ``rows × tokens_per_row``, so long prompts batch fewer rows
    and short ones more."""

    max_batch: "int | None" = None
    max_delay_s: "float | None" = None
    token_budget: "int | None" = None


# ---------------------------------------------------------------------------
# leaves: host tensors, dtypes, device placement
# ---------------------------------------------------------------------------


_TORCH_DTYPES: "dict[np.dtype, torch.dtype]" = {}


def _leaf_dtype(a) -> "torch.dtype":
    if isinstance(a, torch.Tensor):
        return a.dtype
    dt = np.asarray(a).dtype
    # Memoized: ``torch_dtype`` goes through torch, which lets the batcher
    # thread in mid-``submit`` (a burst of submits would then dispatch one
    # by one instead of batching).
    t = _TORCH_DTYPES.get(dt)
    if t is None:
        t = _TORCH_DTYPES[dt] = torch.bfloat16 if dt.name == "bfloat16" else torch_dtype(dt)
    return t


def _leaf_tensor(a) -> "torch.Tensor":
    """A leaf as a CPU tensor: a torch tensor comes to the host; a numpy
    array or scalar (ml_dtypes bfloat16 through its bits) or a Python
    scalar becomes one without a copy where numpy allows it."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return _host_tensor(arr.view(np.uint16)).view(torch.bfloat16)
    return _host_tensor(arr)


def _bcast_bytes(a) -> bytes:
    """The bits of a broadcast leaf: two requests share a batch only when
    theirs are equal (bfloat16 included, which numpy cannot hold)."""
    return _leaf_tensor(a).reshape(1).view(torch.uint8).numpy().tobytes()


def to_device(tree, device):
    """Every leaf of ``tree`` as a tensor on ``device`` (a ``Device``); a
    pinned host tensor goes up asynchronously on the current stream."""
    dev = device.torch_device

    def put(a):
        t = a if isinstance(a, torch.Tensor) else _leaf_tensor(a)
        return t.to(dev, non_blocking=t.device.type == "cpu" and t.is_pinned())

    return tree_map(put, tree)


def _host_copies(tree) -> "tuple[Any, torch.cuda.Event | None]":
    """Issue the D2H copy of every tensor leaf (pinned, on the current
    stream; a CPU leaf is cloned): (tree of host tensors, the CUDA event
    that ends the copies, or None)."""
    leaves, treedef = tree_flatten(tree)
    host, ev = [], None
    for a in leaves:
        if isinstance(a, torch.Tensor):
            if a.is_cuda and ev is None:
                ev = torch.cuda.Event()
            host.append(_to_host(a.detach()))
        else:
            host.append(a)
    if ev is not None:
        ev.record()
    return tree_unflatten(treedef, host), ev


def _host_value(a):
    """A result leaf as the engine hands it out: ``np.ndarray``, or a CPU
    tensor for bfloat16 (``Buffer.enqueue_read``'s rule)."""
    if isinstance(a, torch.Tensor):
        return _to_host_value(a.cpu())
    return np.asarray(a)


def _tokens_per_row(metas) -> int:
    """The token-budget denominator: the widest leading tail axis among
    the row leaves (1 when every row leaf is a bare vector)."""
    t = 1
    for m in metas:
        if m[0] == "row" and m[1]:
            t = max(t, int(m[1][0]))
    return t


class _Request:
    __slots__ = ("kind", "payload", "leaves", "treedef", "rows", "key",
                 "promise", "arrived")

    def __init__(self, kind, payload, leaves, treedef, rows, key, promise, arrived):
        self.kind = kind
        self.payload = payload
        self.leaves = leaves
        self.treedef = treedef
        self.rows = rows
        self.key = key
        self.promise = promise
        self.arrived = arrived

    @property
    def future(self) -> Future:
        return self.promise.get_future()


def _classify(kind: str, payload) -> "tuple[list, Any, int, tuple]":
    """(leaves, treedef, rows, batch key) of one request payload.

    Array leaves with ndim >= 1 are *row* leaves: they share a leading row
    axis (usually 1) that the engine concatenates over.  0-d and scalar
    leaves are *broadcast* leaves — shared by every row — and two requests
    only share a micro-batch when their broadcast values are bit-equal (the
    decode ``pos`` is the canonical example).
    """
    leaves, treedef = tree_flatten(payload)
    rows: "int | None" = None
    metas = []
    for a in leaves:
        if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1:
            lead = int(a.shape[0])
            if rows is None:
                rows = lead
            elif lead != rows:
                raise ValueError(
                    f"request row leaves disagree on the leading axis: {lead} vs {rows}"
                )
            metas.append(("row", tuple(int(d) for d in a.shape[1:]), _leaf_dtype(a)))
        else:
            metas.append(("bcast", _leaf_dtype(a), _bcast_bytes(a)))
    if rows is None:
        raise ValueError(
            "request payload has no array leaf with a leading row axis — "
            "the engine batches over axis 0"
        )
    if rows <= 0:
        raise ValueError("request payload has zero rows")
    return leaves, treedef, rows, (kind, treedef, tuple(metas))


class _GraphEntry:
    """One captured replay route: (device, route key, bucket) -> GraphExec."""

    __slots__ = ("exe", "wnodes", "lnode", "out_treedef", "n_out")

    def __init__(self, exe, wnodes, lnode, out_treedef, n_out):
        self.exe = exe
        self.wnodes = wnodes  # list of (leaf index, WriteNode)
        self.lnode = lnode
        self.out_treedef = out_treedef
        self.n_out = n_out


class RequestEngine:
    """Admission queue -> micro-batches -> scheduler-placed batched steps.

    Parameters
    ----------
    fn:
        The step, per request *kind*: a callable, or a ``{kind: callable}``
        dict serving several request kinds (e.g. ``{"decode": ...,
        "prefill": ...}``) from one queue.  A registered kernel name
        (``str``) is refused until the parcel port (ROADMAP.md Queue 1
        item 10).
    max_batch:
        Micro-batch row bound (also the largest padding bucket).
    max_delay_s:
        Deadline: a batch dispatches when full OR this long after its
        oldest member arrived — the latency/throughput knob.
    max_queue:
        Admission bound; ``submit`` beyond it raises ``QueueFull``.
    scheduler / cluster:
        Placement: explicit scheduler, else the process default.
        ``cluster`` (remote localities) is refused until item 10.
    graph:
        Replay batches as captured ``TaskGraph``s on an engine-owned
        stream (default).  ``False`` forces the direct call: the right
        choice when the step's inputs are large and change every call
        (a replay copies every feed into the graph's static inputs).
    lanes:
        Per-kind ``LanePolicy`` overrides, e.g. ``{"prefill":
        LanePolicy(token_budget=2048, max_delay_s=0.01), "decode":
        LanePolicy(max_delay_s=0.001)}``.  Kinds without an entry use the
        engine-wide bounds.
    """

    def __init__(
        self,
        fn: "Callable | str | dict",
        *,
        max_batch: int = 8,
        max_delay_s: float = 0.002,
        max_queue: int = 256,
        scheduler=None,
        cluster=None,
        graph: bool = True,
        buckets: "Sequence[int] | None" = None,
        lanes: "dict[str, LanePolicy] | None" = None,
        name: str = "engine",
    ):
        if not isinstance(fn, dict):
            fn = {fn if isinstance(fn, str) else "step": fn}
        for f in fn.values():
            if isinstance(f, str):
                raise NotImplementedError(
                    f"a step named by a registered kernel ({f!r}) resolves through the "
                    f"parcel port's kernel registry, not ported yet ({_PARCELS}); pass "
                    "the callable")
        if cluster is not None:
            raise NotImplementedError(
                f"an engine over a cluster needs the parcel port, not ported yet ({_PARCELS})")
        self._fns: "dict[str, Callable]" = dict(fn)
        self.name = name
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self._scheduler = scheduler
        self._graph_enabled = bool(graph)
        if buckets is None:
            b, buckets = 1, []
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        self._buckets = sorted(set(int(b) for b in buckets))
        if self._buckets[-1] != self.max_batch:
            raise ValueError("largest bucket must equal max_batch")
        self._lanes: "dict[str, LanePolicy]" = dict(lanes or {})
        for kind in self._lanes:
            if kind not in self._fns:
                raise KeyError(f"lane policy for unknown kind {kind!r}")

        self._cv = threading.Condition()
        self._queue: "deque[_Request]" = deque()
        self._closed = False
        self._inflight = 0

        # Execution routes, built lazily per (device, route key, bucket).
        self._route_lock = threading.Lock()
        self._graphs: "dict[tuple, _GraphEntry | None]" = {}  # None = don't graph
        self._streams: "dict[str, Any]" = {}

        # Sticky micro-batch homes: route key -> device key, the ``prefer``
        # hint of ``Scheduler.select_batch`` (see ``_place_batch``).
        self._sticky: "dict[tuple, str]" = {}

        # Metrics (one lock; hot counters only).
        self._m_lock = threading.Lock()
        self._started = _now()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._cancelled = 0
        self._batches = 0
        self._rows = 0
        self._padded_rows = 0
        self._queue_hwm = 0
        self._latencies: "deque[float]" = deque(maxlen=4096)
        self._queue_waits: "deque[float]" = deque(maxlen=4096)

        self._thread = threading.Thread(
            target=self._loop, name=f"engine:{name}", daemon=True
        )
        self._thread.start()

    # -- submission surface --------------------------------------------------

    def submit(self, payload, kind: "str | None" = None) -> Future:
        """Enqueue one request; future of its slice of the batched result
        (host leaves).  Raises ``QueueFull`` when the admission queue is at
        capacity and ``EngineClosed`` after ``close()``.  The future
        supports ``cancel()`` until its batch dispatches."""
        if kind is None:
            if len(self._fns) != 1:
                raise ValueError(f"engine serves kinds {sorted(self._fns)}; pass kind=")
            kind = next(iter(self._fns))
        elif kind not in self._fns:
            raise KeyError(f"engine {self.name!r} serves no kind {kind!r}")
        leaves, treedef, rows, key = _classify(kind, payload)
        if rows > self.max_batch:
            # An oversize request could never be taken into any group —
            # admitting it would wedge the queue behind it forever.
            raise ValueError(
                f"request has {rows} rows but max_batch is {self.max_batch}: "
                "split it, or raise max_batch"
            )
        promise: Promise = Promise(name=f"{self.name}:{kind}")
        req = _Request(kind, payload, leaves, treedef, rows, key, promise, _now())
        with self._cv:
            if self._closed:
                raise EngineClosed(f"engine {self.name!r} is closed")
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"engine {self.name!r} admission queue is full "
                    f"({self.max_queue} requests) — backpressure: shed or retry"
                )
            self._queue.append(req)
            depth = len(self._queue)
            self._cv.notify_all()
        with self._m_lock:
            self._submitted += 1
            if depth > self._queue_hwm:
                self._queue_hwm = depth
        return req.future

    def __enter__(self) -> "RequestEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, cancel_pending: bool = False) -> None:
        """Stop admitting; drain.  Queued requests still execute (their
        callers hold futures) unless ``cancel_pending`` fails them fast
        with ``EngineClosed``.  Blocks until in-flight batches resolve."""
        with self._cv:
            if self._closed:
                dropped = []
            else:
                self._closed = True
                dropped = list(self._queue) if cancel_pending else []
                if cancel_pending:
                    self._queue.clear()
            self._cv.notify_all()
        for req in dropped:
            req.promise.set_exception(
                EngineClosed(f"engine {self.name!r} closed before this request ran")
            )
        self._thread.join(timeout=60)
        with self._cv:
            while self._inflight:
                self._cv.wait(timeout=0.1)

    def drain(self) -> None:
        """Block until the queue is empty and no batch is in flight."""
        with self._cv:
            while self._queue or self._inflight:
                self._cv.wait(timeout=0.05)

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict:
        """Snapshot of serving counters and latency percentiles (seconds)."""
        with self._m_lock:
            lats = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            m = {
                "requests_submitted": self._submitted,
                "requests_completed": self._completed,
                "requests_failed": self._failed,
                "requests_cancelled": self._cancelled,
                "batches": self._batches,
                "rows": self._rows,
                "padded_rows": self._padded_rows,
                # Padded ÷ real rows: the cost of pow-2 bucketing.
                "padding_waste": (self._padded_rows / self._rows) if self._rows else 0.0,
                "queue_high_water": self._queue_hwm,
                "mean_batch_rows": (self._rows / self._batches) if self._batches else 0.0,
            }
        with self._cv:
            m["queue_depth"] = len(self._queue)
            m["inflight_batches"] = self._inflight
        # Fleet view: where batches landed and how busy the devices look to
        # the shared occupancy signal.
        try:
            sched = self._scheduler_for()
            m["placements"] = sched.stats()
            steal_stats = getattr(sched, "steal_stats", None)
            if callable(steal_stats):
                m["steals"] = steal_stats()["steals"]
            occupancy = {}
            for d in sched.devices():
                l = d.load()
                occupancy[d.key] = round(l.depth + getattr(l, "busy_ewma", 0.0), 4)
            m["fleet_occupancy"] = occupancy
        except Exception:  # noqa: BLE001 - metrics never fail the caller
            pass
        elapsed = max(_now() - self._started, 1e-9)
        m["elapsed_s"] = elapsed
        m["requests_per_s"] = m["requests_completed"] / elapsed
        if lats:
            m["latency_p50_s"] = lats[int(0.50 * (len(lats) - 1))]
            m["latency_p99_s"] = lats[int(0.99 * (len(lats) - 1))]
        if waits:
            m["queue_wait_p50_s"] = waits[int(0.50 * (len(waits) - 1))]
            m["queue_wait_p99_s"] = waits[int(0.99 * (len(waits) - 1))]
        return m

    # -- batcher -------------------------------------------------------------

    def _bucket(self, rows: int) -> int:
        for b in self._buckets:
            if rows <= b:
                return b
        return self._buckets[-1]

    def _lane_bounds(self, key) -> "tuple[int, float]":
        """(row cap, assembly deadline) for this batch key: the kind's
        ``LanePolicy`` when one was given — token budgets divide down to a
        row cap against the key's tokens-per-row — else the engine-wide
        bounds.  The cap never exceeds ``max_batch`` (the bucket roof)."""
        kind, _treedef, metas = key
        pol = self._lanes.get(kind)
        if pol is None:
            return self.max_batch, self.max_delay_s
        cap = pol.max_batch if pol.max_batch is not None else self.max_batch
        if pol.token_budget is not None:
            cap = min(cap, max(1, pol.token_budget // _tokens_per_row(metas)))
        delay = pol.max_delay_s if pol.max_delay_s is not None else self.max_delay_s
        return min(cap, self.max_batch), delay

    def _compatible_rows(self, key, cap: int) -> int:
        rows = 0
        for r in self._queue:
            if r.key == key:
                rows += r.rows
                if rows >= cap:
                    break
        return rows

    def _take_group(self, key, cap: int) -> "list[_Request]":
        """Pop the head-compatible requests (in order, skipping cancelled
        entries) up to ``cap`` rows; incompatible requests keep their
        queue position."""
        group: "list[_Request]" = []
        rows = 0
        kept: "deque[_Request]" = deque()
        cancelled = 0
        while self._queue:
            r = self._queue.popleft()
            if r.future.cancelled():
                cancelled += 1
                continue
            if r.key == key and rows + r.rows <= cap:
                group.append(r)
                rows += r.rows
            else:
                kept.append(r)
        self._queue.extend(kept)
        if cancelled:
            with self._m_lock:
                self._cancelled += cancelled
        return group

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return  # closed and drained
                head = self._queue[0]
                cap, delay = self._lane_bounds(head.key)
                # A request bigger than its lane's cap still fits max_batch
                # (submit checked); run it alone rather than wedging the queue.
                cap = max(cap, head.rows)
                deadline = head.arrived + delay
                while (
                    not self._closed
                    and self._compatible_rows(head.key, cap) < cap
                    and _now() < deadline
                ):
                    self._cv.wait(timeout=max(deadline - _now(), 0.0) or 0.0005)
                group = self._take_group(head.key, cap)
                if group:
                    self._inflight += 1
            if group:
                try:
                    # One dispatch makes several submissions (the stream
                    # lane's task, the pool join): coalesce them so each
                    # target queue sees ONE enqueue per micro-batch.
                    with coalesce():
                        self._dispatch(group)
                except BaseException as e:  # noqa: BLE001 - engine must not die
                    self._finish(group, None, e)

    # -- dispatch ------------------------------------------------------------

    def _scheduler_for(self):
        if self._scheduler is not None:
            return self._scheduler
        from repro_torch.core.scheduler import get_scheduler

        return get_scheduler()

    def _place_batch(self, sched, group: "list[_Request]"):
        """Place one micro-batch, sticky by route key.

        ``least_loaded`` alone sprays consecutive micro-batches of one
        request stream across the fleet: each batch's recent-placement
        charge makes its own home score busiest, so the next batch hops
        devices, churning per-device graph routes.  The route's last home
        goes in as ``select_batch``'s ``prefer`` hint, which holds unless
        the home is structurally busier than the policy's pick or the
        policy is not load-based.  There is no periodic re-ask: under a
        self-repelling policy it would always migrate the stream.  When the
        structural yield fires, the home follows the device the policy
        actually picked."""
        rkey = self._route_key(group[0].key)
        with self._route_lock:
            prefer = self._sticky.get(rkey)
        try:
            dev = sched.select_batch([r.leaves for r in group], prefer=prefer)
        except TypeError:  # duck-typed scheduler without the prefer hint
            dev = sched.select_batch([r.leaves for r in group])
        with self._route_lock:
            self._sticky[rkey] = dev.key
        return dev

    @staticmethod
    def _concat_rows(group: "list[_Request]", i: int, meta, pad: int, pin: bool = False):
        """One row leaf, concatenated over members into a fresh host tensor
        (pinned for a card) and zero-padded to the bucket (the single copy
        of the padding rule — direct batches and graph feeds both go
        through here).  Fresh, so a step that writes its batch in place
        never touches a caller's array."""
        arrs = [_leaf_tensor(r.leaves[i]) for r in group]
        total = sum(a.shape[0] for a in arrs)
        out = torch.empty((total + pad,) + meta[1], dtype=meta[2], pin_memory=pin)
        off = 0
        for a in arrs:
            out[off: off + a.shape[0]].copy_(a)
            off += a.shape[0]
        if pad:
            out[total:].zero_()
        return out

    @staticmethod
    def _bcast_leaf(group: "list[_Request]", i: int, pin: bool = False):
        """A broadcast leaf (equal across the group by key construction) as
        a fresh 0-d host tensor, pinned for a card."""
        t = _leaf_tensor(group[0].leaves[i])
        return torch.empty((), dtype=t.dtype, pin_memory=pin).copy_(t.reshape(()))

    def _stack(self, group: "list[_Request]", bucket: int, pin: bool = False):
        """Concatenate member leaves over axis 0 and pad to the bucket;
        broadcast leaves pass through from the first member.  Returns
        (pytree of host tensors, total rows)."""
        kind, treedef, metas = group[0].key
        total = sum(r.rows for r in group)
        pad = bucket - total
        out_leaves = []
        for i, meta in enumerate(metas):
            if meta[0] == "row":
                out_leaves.append(self._concat_rows(group, i, meta, pad, pin))
            else:
                out_leaves.append(self._bcast_leaf(group, i, pin))
        return tree_unflatten(treedef, out_leaves), total

    def _dispatch(self, group: "list[_Request]") -> None:
        kind = group[0].kind
        dispatched = _now()
        with self._m_lock:
            for r in group:
                self._queue_waits.append(dispatched - r.arrived)
        sched = self._scheduler_for()
        try:
            dev = self._place_batch(sched, group)
        except BaseException as e:  # noqa: BLE001 - dead fleet fails the batch
            self._finish(group, None, e)
            return
        rows = sum(r.rows for r in group)
        bucket = self._bucket(rows)
        # select_batch logged ONE placement unit, but this batch is `rows`
        # of work: charge the remainder so a 32-row decode burst weighs 32,
        # not 1, in least_loaded's recent-placement signal.
        charge = getattr(sched, "charge", None)
        if callable(charge) and rows > 1:
            charge(dev, rows - 1)

        from repro_torch.core.executor import get_runtime

        pool = get_runtime().pool
        if getattr(dev, "is_remote_proxy", False):
            # The reference ships such a batch as one apply_batched parcel
            # and joins its pre-sliced reply (_join_chunks).
            self._finish(group, None, NotImplementedError(
                f"engine placed a micro-batch on {dev.key}, a remote locality: batches "
                f"travel as apply_batched parcels, not ported yet ({_PARCELS})"), bucket)
            return

        pin = bool(getattr(dev, "is_cuda", False))
        entry = self._graph_route(dev, group[0].key, bucket) if self._graph_enabled else None
        if entry is not None:
            metas = group[0].key[2]
            pad = bucket - rows
            feeds = {}
            for i, w in entry.wnodes:
                if metas[i][0] == "row":
                    feeds[w] = self._concat_rows(group, i, metas[i], pad, pin)
                else:
                    # Broadcast leaves are write-fed 0-d buffers, NOT baked
                    # constants: one captured route serves every value (a
                    # decode `pos` must not capture per token).
                    feeds[w] = self._bcast_leaf(group, i, pin)
            fut = entry.exe.replay(feeds=feeds, stream=self._stream_for(dev))
            pool.submit(self._join_graph, fut, entry, group, bucket)
            return

        # Direct path: graph=False, or a step that cannot be captured.
        batch, _total = self._stack(group, bucket, pin)
        fn = self._fns[kind]

        def _run(batch=batch, dev=dev, fn=fn):
            return _host_copies(fn(to_device(batch, dev)))

        fut = self._stream_for(dev).lane.submit(_run)
        pool.submit(self._join_direct, fut, group, bucket)

    # -- execution routes ----------------------------------------------------

    def _stream_for(self, dev):
        """The engine's dedicated stream on ``dev`` (created on first use):
        micro-batch feeds and steps ride one lane, ordered among
        themselves, concurrent with the device's other streams."""
        with self._route_lock:
            s = self._streams.get(dev.key)
            if s is None:
                s = self._streams[dev.key] = dev.create_stream(f"engine.{self.name}")
            return s

    @staticmethod
    def _route_key(key) -> tuple:
        """Batch key with broadcast VALUES erased (dtype kept): the batch
        key gates which requests share a micro-batch (bit-equal broadcast
        leaves), but captured routes are value-independent — broadcast
        leaves are fed at replay, so a decode ``pos`` that increments
        every token reuses ONE route instead of capturing per value."""
        kind, treedef, metas = key
        return (kind, treedef, tuple(m if m[0] == "row" else ("bcast", m[1]) for m in metas))

    def _graph_route(self, dev, key, bucket) -> "_GraphEntry | None":
        """Captured-replay route for (device, route key, bucket), built
        once.  Returns None (and remembers the refusal) when the step
        cannot be captured (a host sync, a data-dependent shape, outputs
        that are not tensors): the direct path serves it."""
        cache_key = (dev.key, self._route_key(key), bucket)
        with self._route_lock:
            if cache_key in self._graphs:
                return self._graphs[cache_key]
        entry = None
        try:
            entry = self._build_graph(dev, key, bucket)
        except Exception:  # noqa: BLE001 - uncapturable step: direct path
            entry = None
        with self._route_lock:
            entry = self._graphs.setdefault(cache_key, entry)
        return entry

    def _build_graph(self, dev, key, bucket) -> _GraphEntry:
        from repro_torch.core.graph import TaskGraph
        from repro_torch.core.program import Program

        kind, treedef, metas = key
        fn = self._fns[kind]
        specs = [((bucket,) + m[1], m[2]) if m[0] == "row" else ((), m[1]) for m in metas]

        # The step's output structure, from one eager call on zero inputs
        # of the bucket's shapes on the engine's lane (a ctypes kernel has
        # no abstract evaluation).  A step that fails here fails the same
        # way on the direct path, which reports it.
        def probe():
            zeros = [torch.zeros(s, dtype=d, device=dev.torch_device) for s, d in specs]
            return tree_flatten(fn(tree_unflatten(treedef, zeros)))

        out_leaves, out_treedef = self._stream_for(dev).lane.submit(probe).get()
        if not all(isinstance(a, torch.Tensor) for a in out_leaves):
            raise TypeError("a captured step returns tensors only")
        out_meta = tuple(torch.empty(a.shape, dtype=a.dtype, device="meta") for a in out_leaves)

        def flat(*leaves):
            # Recording evaluates the launch on meta tensors: answer with
            # the probe's shapes; the step itself runs at warm-up, capture
            # and (CPU) every replay.
            if leaves and leaves[0].is_meta:
                return out_meta
            return tuple(tree_flatten(fn(tree_unflatten(treedef, list(leaves))))[0])

        prog = Program(dev, {kind: flat}, name=f"{self.name}:{kind}")
        g = TaskGraph(f"{self.name}:{kind}:b{bucket}")
        args, wnodes = [], []
        for i, (shape, dt) in enumerate(specs):
            # EVERY leaf is a write-fed buffer — row leaves bucket-shaped,
            # broadcast leaves 0-d — so one route serves every broadcast
            # value (fed per replay, never baked as a constant).
            buf = dev.create_buffer(shape, dt).get()
            wnodes.append((i, g.write(buf, None)))
            args.append(buf)
        lnode = g.run(prog, args, kind)
        exe = g.instantiate()
        return _GraphEntry(exe, wnodes, lnode, out_treedef, len(out_leaves))

    # -- joins (pool tasks: block on the batch future, slice, resolve) --------

    def _join_graph(self, fut, entry: _GraphEntry, group, bucket) -> None:
        try:
            res = fut.get()
            vals = res[entry.lnode]
            leaves = [vals] if entry.n_out == 1 else list(vals)
            out = tree_unflatten(entry.out_treedef, [_host_value(v) for v in leaves])
        except BaseException as e:  # noqa: BLE001 - errors fan to every member
            self._finish(group, None, e, bucket)
            return
        self._finish(group, out, None, bucket)

    def _join_direct(self, fut, group, bucket) -> None:
        try:
            host, ev = fut.get()
            if ev is not None:
                ev.synchronize()
            out = tree_map(_host_value, host)
        except BaseException as e:  # noqa: BLE001
            self._finish(group, None, e, bucket)
            return
        self._finish(group, out, None, bucket)

    def _finish(self, group, out, exc, bucket: "int | None" = None) -> None:
        done = _now()
        if exc is not None:
            for req in group:
                req.promise.set_exception(exc)
        else:
            off = 0
            for req in group:
                sl = tree_map(
                    lambda a, o=off, n=req.rows: a[o: o + n] if getattr(a, "ndim", 0) >= 1 else a,
                    out,
                )
                req.promise.set_value(sl)
                off += req.rows
        self._note_done(group, done, bucket, failed=exc is not None)

    def _note_done(self, group, done, bucket, failed: bool) -> None:
        rows = sum(r.rows for r in group)
        with self._m_lock:
            self._batches += 1
            self._rows += rows
            if bucket is not None:
                self._padded_rows += max(bucket - rows, 0)
            if failed:
                self._failed += len(group)
            else:
                self._completed += len(group)
                for r in group:
                    self._latencies.append(done - r.arrived)
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def __repr__(self) -> str:
        m = self.metrics()
        return (
            f"RequestEngine({self.name}: {m['requests_completed']}/{m['requests_submitted']} "
            f"served, {m['batches']} batches, depth={m['queue_depth']})"
        )
