"""Device memory buffer (paper §4, Fig. 2 ``buffer``).

A ``Buffer`` holds one contiguous tensor on its device.  Operations are
submitted to one of the owning device's streams (the default stream
unless ``stream=`` is given) and return futures — ``enqueue_write`` /
``enqueue_read`` are the ``cudaMemcpyAsync(H2D/D2H)`` analogues; ``copy_to``
moves a buffer between devices and updates the AGAS placement
(percolation).

Offsets are in *elements* (dtype-safe), applied on a flat view of the
buffer, matching HPXCL's (offset, size) windows.  Windows are validated
eagerly at enqueue time: an out-of-range (offset, count) raises
``ValueError`` before the op reaches a queue.

Cross-stream ordering: a tensor written on one CUDA stream and used on
another has no implied order.  Each buffer therefore keeps the CUDA event
of its last writer, and the events of the reads (copies, launches) made
since on each stream.  Every use on another stream first makes that
stream wait on the writer's event, and an in-place write also waits on
the reads of other streams, so work already dispatched sees the old
contents (on the device, the host never blocks).  ``record_stream`` keeps
the caching allocator from handing the memory out again while another
stream may still use it (``Buffer._use``).

Graph capture (``repro_torch.core.graph``): inside a ``capture()`` region
``enqueue_write`` and ``enqueue_read`` record full-buffer graph nodes and
return them instead of futures, and ``enqueue_read_sync`` is refused.  A
graph-internal buffer is invalidated by a replay: its reads raise until a
full-buffer write gives it storage again.

Spill and refetch: ``spill`` copies the contents to pinned host memory,
releases the device storage and moves the AGAS record to ``HOST_KEY``; the
next use (a read, a launch, ``array()``) copies them back on the caller's
stream and moves the record home.  A full overwrite of a spilled buffer
discards the host copy instead.  ``_last_use`` is the LRU signal the
scheduler's ``spill_lru`` evicts by.

Transfers: a write from a pinned CPU tensor is asynchronous
(``non_blocking=True`` on the caller's stream); a pageable source, such as
an ``np.ndarray``, makes the copy synchronous.  A read copies into pinned
host memory.  The futures of writes, reads and ``create_buffer_from``
resolve at the CUDA event recorded after the copy, never before: a pinned
source may be reused once its future is ready.
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core import agas
from repro_torch.core.futures import Future

__all__ = ["Buffer", "torch_dtype"]

# Guards the submit-once of Buffer.free across racing threads.
_free_lock = threading.Lock()


def torch_dtype(dtype) -> "torch.dtype":
    """A torch dtype from a torch or numpy dtype (or anything
    ``np.dtype`` accepts)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _check_window(size: int, offset: int, count: int, op: str) -> None:
    """Validate an (offset, count) element window against a buffer of
    ``size`` elements, raising ``ValueError`` on any out-of-range request.
    A slice copy would silently clamp a bad window, so the validation
    happens eagerly at enqueue time, before the op reaches a queue."""
    if offset < 0 or count < 0 or offset + count > size:
        raise ValueError(
            f"{op} window out of range: offset={offset}, count={count} on a "
            f"buffer of {size} element(s) — need 0 <= offset and "
            "offset + count <= size"
        )


def _host_tensor(data) -> "torch.Tensor":
    """``data`` as a tensor, without copying where numpy allows it."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _to_host_value(t: "torch.Tensor"):
    """numpy for every dtype numpy has; a CPU tensor for bfloat16."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _settle(lane_fut: Future, value=lambda r: None, name: str = "") -> Future:
    """Lazy future of ``value(result)`` for a lane task that returns
    ``(result, cuda_event | None)``: it resolves once the task has run AND
    its CUDA event has completed — never at mere submission."""

    def _resolve():
        res, ev = lane_fut.get()
        if ev is not None:
            ev.synchronize()
        return value(res)

    return Future(resolver=_resolve, name=name)


def _to_host(t: "torch.Tensor") -> "torch.Tensor":
    """A host copy of ``t``: into pinned memory, asynchronously on the
    current stream, for a CUDA tensor (the caller synchronises before the
    source may go)."""
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _current_event(t: "torch.Tensor") -> "torch.cuda.Event | None":
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class Buffer:
    """Memory allocated on a specific device; handle is location-transparent."""

    def __init__(self):  # use Device.create_buffer*, not this
        self.device = None
        self.shape: tuple = ()
        self.dtype: "torch.dtype | None" = None
        self._tensor: "torch.Tensor | None" = None
        # (event, stream) of the last write on a CUDA stream, the event of
        # the last read since then on each stream, and the stream the
        # current tensor was allocated on.
        self._last_write: "tuple | None" = None
        self._reads: "dict" = {}
        self._sync_lock = threading.Lock()
        self._alloc_stream = None
        self._freed: bool = False
        # True once a graph replay consumed the value (graph-internal
        # buffer): reads raise until the next full-buffer write.
        self._donated: bool = False
        self._free_future: "Future | None" = None
        self.gid: agas.GID = 0
        self._finalizer: "weakref.finalize | None" = None
        # Spill state: while evicted the contents live in _spilled_host
        # (pinned for a CUDA buffer) and the AGAS record sits on HOST_KEY.
        self._spilled_host: "torch.Tensor | None" = None
        self._spill_lock = threading.RLock()
        self._last_use: float = time.monotonic()

    def _register(self, device) -> None:
        """AGAS registration with resident-bytes accounting and a GC-safe
        finalizer that retires the record of a buffer never freed."""
        self.device = device
        self.gid = agas.registry.register(
            self, agas.Placement(device.key, 0), kind="buffer", nbytes=self.nbytes
        )
        self._finalizer = weakref.finalize(self, agas.registry.retire, self.gid)

    # -- allocation (runs on a device lane) ----------------------------------

    @staticmethod
    def _allocate(device, shape, dtype, fill) -> "Buffer":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dt = torch_dtype(dtype)
        if fill is None:
            t = torch.zeros(shape, dtype=dt, device=device.torch_device)
        else:
            t = torch.full(shape, fill, dtype=dt, device=device.torch_device)
        return Buffer._adopt(device, t)

    @staticmethod
    def _from_host(device, data) -> "tuple[Buffer, torch.cuda.Event | None]":
        """A new buffer holding ``data``, and the event ending its copy."""
        src = _host_tensor(data)
        t = torch.empty(src.shape, dtype=src.dtype, device=device.torch_device)
        t.copy_(src, non_blocking=src.device.type == "cpu" and src.is_pinned())
        b = Buffer._adopt(device, t)
        return b, b._last_write[0] if b._last_write else None

    @staticmethod
    def _adopt(device, t: "torch.Tensor") -> "Buffer":
        """A new buffer around ``t``, written by the current stream."""
        b = Buffer()
        b.shape, b.dtype = tuple(t.shape), t.dtype
        b._set_tensor(t)
        b._register(device)
        return b

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    # -- stream bookkeeping ----------------------------------------------------

    def _use(self, write: bool = False) -> "torch.Tensor":
        """The tensor, made safe to use on the CURRENT stream: the stream
        waits (on the device) for the last writer's event when that writer
        ran on another stream and, for an in-place ``write``, for the reads
        noted since on other streams; the allocator learns of the use."""
        self._last_use = time.monotonic()
        t = self._live()
        if t.is_cuda:
            cur = torch.cuda.current_stream(t.device)
            with self._sync_lock:
                waits = [self._last_write] if self._last_write is not None else []
                if write:
                    waits += [(ev, s) for s, ev in self._reads.items()]
            for ev, s in waits:
                if s != cur:
                    cur.wait_event(ev)
            if self._alloc_stream != cur:
                t.record_stream(cur)
        return t

    def _mark_read(self, ev: "torch.cuda.Event | None") -> None:
        """Note a read on the current stream that ends at ``ev``: the next
        in-place write on another stream waits for it."""
        t = self._tensor
        if ev is None or t is None or not t.is_cuda:
            return
        cur = torch.cuda.current_stream(t.device)
        with self._sync_lock:
            self._reads[cur] = ev  # a later read on one stream covers an earlier

    def _set_tensor(self, t: "torch.Tensor", ev=None) -> "torch.cuda.Event | None":
        """Rebind the buffer to ``t``, allocated and written on the current
        stream (up to ``ev`` if given); returns the writer event."""
        self._tensor = t
        self._donated = False
        self._last_use = time.monotonic()
        self._alloc_stream = torch.cuda.current_stream(t.device) if t.is_cuda else None
        self._discard_spill()
        return self._mark_written(ev)

    def _mark_written(self, ev=None) -> "torch.cuda.Event | None":
        """Note a write on the current stream that ends at ``ev`` (recorded
        now if not given); it supersedes every read noted before."""
        if ev is None:
            ev = _current_event(self._tensor)
        last = None if ev is None else (ev, torch.cuda.current_stream(self._tensor.device))
        with self._sync_lock:
            self._last_write, self._reads = last, {}
        return ev

    def _live(self) -> "torch.Tensor":
        if self._freed:
            raise RuntimeError(f"Buffer gid={self.gid} was freed; its storage is released.")
        if self._tensor is None and self._spilled_host is not None:
            t = self._refetch()
            if t is not None:
                return t
        if self._donated:
            raise RuntimeError(
                f"Buffer gid={self.gid} was donated to a graph replay; its contents are "
                "gone (graph-internal). Write to it before reading again.")
        return self._tensor

    def _invalidate(self) -> None:
        """Mark the value as consumed by a graph replay (graph-internal)."""
        self._discard_spill()  # a stale host copy must not resurrect the value
        self._tensor = None
        self._donated = True
        with self._sync_lock:
            self._last_write, self._reads = None, {}

    # -- async transfer surface ----------------------------------------------

    def enqueue_write(self, offset: int, data, count: "int | None" = None,
                      stream=None) -> Future:
        """Asynchronously copy host ``data`` (``np.ndarray`` or tensor) into
        the buffer at ``offset`` (elements, flat view).
        ``cudaMemcpyAsync(HostToDevice)`` analogue; ``stream`` scopes the
        ordering, ``None`` means the device's default stream.  Inside a
        ``capture()`` region the write is recorded (full-buffer only) and
        the graph node is returned instead of a future."""
        from repro_torch.core.graph import current_graph

        data_len = data.numel() if isinstance(data, torch.Tensor) else int(np.size(data))
        _check_window(
            self.size, offset, count if count is not None else data_len,
            "enqueue_write",
        )
        if count is not None and count > data_len:
            raise ValueError(
                f"enqueue_write count={count} exceeds the {data_len} element(s) "
                "of data supplied"
            )
        g = current_graph()
        if g is not None:
            return g.write(self, data, offset=offset, count=count)

        def _write():
            src = _host_tensor(data).reshape(-1)
            if count is not None:
                src = src[:count]
            if ((self._donated or self._spilled_host is not None)
                    and offset == 0 and src.numel() == self.size):
                # A full write gives a graph-internal buffer storage again,
                # and makes a spilled buffer's host copy dead.
                self._set_tensor(torch.empty(self.shape, dtype=self.dtype,
                                             device=self.device.torch_device))
            dst = self._use(write=True).view(-1)[offset: offset + src.numel()]
            pinned = src.device.type == "cpu" and src.is_pinned()
            dst.copy_(src, non_blocking=pinned and dst.is_cuda)
            return None, self._mark_written()

        q = self.device.ops_queue if stream is None else stream._lane_for(self.device)
        return _settle(q.submit(_write), name=f"write:gid{self.gid}")

    def enqueue_read(self, offset: int = 0, count: "int | None" = None,
                     stream=None) -> Future:
        """Asynchronously copy device data to the host; future of
        ``np.ndarray`` (a CPU tensor for bfloat16).
        ``cudaMemcpyAsync(DeviceToHost)`` into pinned memory; the future
        resolves at the event recorded after the copy.  Inside a
        ``capture()`` region the read is recorded as a fetch node
        (full-buffer only) and the node is returned."""
        from repro_torch.core.graph import current_graph

        n = self.size - offset if count is None else count
        _check_window(self.size, offset, n, "enqueue_read")
        g = current_graph()
        if g is not None:
            return g.read(self, offset=offset, count=count)
        full = offset == 0 and n == self.size

        def _read():
            src = self._use().reshape(-1)[offset: offset + n]
            if src.is_cuda:
                out = torch.empty(n, dtype=src.dtype, pin_memory=True)
                out.copy_(src, non_blocking=True)
            else:
                out = src.clone()
            if full:
                out = out.reshape(self.shape)
            ev = _current_event(src)
            self._mark_read(ev)
            return out, ev

        q = self.device.ops_queue if stream is None else stream._lane_for(self.device)
        return _settle(q.submit(_read), _to_host_value, name=f"read:gid{self.gid}")

    def enqueue_read_sync(self, offset: int = 0, count: "int | None" = None, stream=None):
        from repro_torch.core.graph import current_graph

        if current_graph() is not None:
            raise RuntimeError(
                "enqueue_read_sync inside a graph-capture region: the value "
                "does not exist until replay. Use enqueue_read() to record a "
                "fetch node and index the replay's GraphResult with it."
            )
        return self.enqueue_read(offset, count, stream=stream).get()

    def copy_to(self, target_device) -> Future:
        """Copy the contents to ``target_device``; future of the *new*
        Buffer, registered there (the percolation primitive).  Runs on this
        buffer's default stream, after the work already enqueued there."""

        def _copy():
            src = self._use()
            if target_device.torch_device == src.device:
                t = src.clone()
                self._mark_read(_current_event(src))
                return Buffer._adopt(target_device, t)
            t = src.to(target_device.torch_device, copy=True)
            for d in {src.device, t.device}:  # cross-device: finish the copy
                if d.type == "cuda":
                    torch.cuda.current_stream(d).synchronize()
            return Buffer._adopt(target_device, t)

        return self.device.ops_queue.submit(_copy)

    # -- lifetime --------------------------------------------------------------

    def free(self) -> Future:
        """Release device storage and retire the AGAS record (async;
        ``cudaFreeAsync`` analogue — future of None, idempotent).

        The release is gated on a barrier across ALL of the owning
        device's lanes, so work already enqueued on any stream runs
        against live storage first; the caching allocator's stream records
        keep the memory until the device work is done too."""

        def _release(_=None):
            self._freed = True
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
            agas.registry.unregister(self.gid)
            self._tensor = None
            self._spilled_host = None
            with self._sync_lock:
                self._last_write, self._reads = None, {}

        with _free_lock:
            if self._free_future is None:
                self._free_future = self.device._dispatcher.barrier().then(
                    _release, executor="inline"
                )
        return self._free_future

    def _rehome(self, device) -> None:
        """Point the handle at a new owning device (the GID is unchanged,
        only the AGAS placement record moves)."""
        if device is self.device:
            return
        self.device = device
        if self._freed:
            return
        with self._spill_lock:
            if self._spilled_host is not None:
                # The data lives in host memory, on neither device: the
                # record stays on HOST_KEY and follows the refetch.
                return
        agas.registry.update_placement(self.gid, agas.Placement(device.key, 0))

    # -- spill / refetch -------------------------------------------------------

    def spill(self) -> Future:
        """Evict the device storage to a pinned host copy; future of True
        when storage was released (False: nothing to spill, as when already
        spilled, freed or donated).  Runs on the default stream after the
        work enqueued there; the copy has ended before the storage goes, and
        the AGAS record moves to ``agas.HOST_KEY`` at once."""
        return self.device.ops_queue.submit(self._spill_now)

    def _spill_now(self) -> bool:
        with self._spill_lock:
            if (self._freed or self._donated or self._tensor is None
                    or self._spilled_host is not None):
                return False
            t = self._use()
            host = _to_host(t)
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
            self._spilled_host = host
            self._tensor = None
            with self._sync_lock:
                self._last_write, self._reads = None, {}
            agas.registry.update_placement(self.gid, agas.Placement(agas.HOST_KEY, 0))
            self.device._count("spills")
            return True

    def _refetch(self) -> "torch.Tensor | None":
        """Copy the host copy back on the current stream and move the AGAS
        record home; None if another thread discarded it first."""
        with self._spill_lock:
            host = self._spilled_host
            if host is None:
                return self._tensor  # lost the race to another refetcher
            pinned = host.device.type == "cpu" and host.is_pinned()
            t = host.to(self.device.torch_device, non_blocking=pinned, copy=True)
            self._set_tensor(t)
            self.device._count("refetches")
            return t

    def _discard_spill(self) -> None:
        """Drop the host copy (refetched, or dead after a full overwrite)
        and put the placement record back on the owning device."""
        if self._spilled_host is None:
            return
        with self._spill_lock:
            if self._spilled_host is None:
                return
            self._spilled_host = None
            if not self._freed:
                agas.registry.update_placement(self.gid, agas.Placement(self.device.key, 0))

    # -- kernel-facing view ---------------------------------------------------

    def array(self) -> "torch.Tensor":
        """Current device-resident tensor, ordered after its last writer on
        the caller's current stream.  Raises if the buffer was freed."""
        return self._use()

    def __repr__(self) -> str:
        return f"Buffer(gid={self.gid}, {self.dtype}{list(self.shape)} @ {self.device.key})"
