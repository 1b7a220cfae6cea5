"""Streams & events — intra-device concurrency on real CUDA streams.

A ``Stream`` is one ordered lane of work on one device, an ``Event`` a
recorded point in a stream that other streams and hosts can wait on.  Each
stream owns two things:

  * a host lane (``executor.Lane``): the FIFO of submitted tasks — writes,
    launches, reads, host callbacks — run one at a time on a pool thread;
  * on a CUDA device, a ``torch.cuda.Stream``: every task of the lane runs
    inside ``torch.cuda.stream(...)``, so the copies and kernels it
    enqueues land on that CUDA stream in lane order.

Concept mapping:

  * ``cudaStream_t``          -> ``Stream`` (lane + ``torch.cuda.Stream``)
  * ``cudaEvent_t``           -> ``Event`` (a ``torch.cuda.Event`` recorded
    by a lane task, plus a ``Future`` that resolves at its completion)
  * ``cudaStreamWaitEvent``   -> ``Stream.wait_event`` (host lane gate plus
    ``torch.cuda.Stream.wait_event`` on the device)
  * ``cudaStreamSynchronize`` -> ``Stream.synchronize``
  * default stream            -> ``Device.default_stream``
  * ``cudaGraphLaunch(exec, s)`` -> ``Stream.replay``

Ordering guarantees:

* **Same-stream FIFO** — operations submitted to one stream execute
  strictly in submission order, on the host lane and on the CUDA stream.
* **Cross-stream: explicit only** — ``e = s1.record()`` then
  ``s2.wait_event(e)`` establishes happens-before.  Buffers add one
  implicit edge of their own: a launch or copy that reads a buffer waits,
  on the device, for the event of the buffer's last writer (see
  ``Buffer._use``).
* **Events are one-shot** — re-recording returns a new event.

Deadlock rule (CUDA's): ``wait_event`` on an event that will only be
recorded by LATER work on the same stream deadlocks that stream —
record-then-wait, never wait-then-record.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.futures import Future

__all__ = ["Event", "Stream"]


def _record_now(cuda_stream) -> "torch.cuda.Event | None":
    """A timing-capable event recorded on ``cuda_stream`` (None on CPU)."""
    if cuda_stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(cuda_stream)
    return ev


class Event:
    """A recorded point in a stream (``cudaEvent_t`` analogue).

    ``future`` becomes READY when every operation submitted to the
    recording stream *before* ``record()`` has completed on the device.
    ``cuda_event()`` is the underlying ``torch.cuda.Event`` (None on a CPU
    device), available once the recording lane task has run.
    """

    __slots__ = ("stream", "name", "_marker", "_future", "_joins")

    def __init__(self, stream: "Stream", marker: Future, future: Future, name: str = "",
                 joins: bool = False):
        self.stream = stream
        self.name = name or f"event:{stream.name}"
        self._marker = marker  # lane task -> torch.cuda.Event | None
        self._future = future
        # True when the event also covers noted completions that the CUDA
        # event alone does not: waiters then wait on the host.
        self._joins = joins

    @property
    def future(self) -> Future:
        return self._future

    def cuda_event(self) -> "torch.cuda.Event | None":
        """The recorded CUDA event (blocks until the lane reached it)."""
        return self._marker.get()

    def query(self) -> bool:
        """Non-blocking: has the recorded point been reached?
        (``cudaEventQuery``)."""
        if not self._marker.done():
            return False
        if self._marker.exception() is not None:
            return True
        ev = self._marker.get()
        if ev is not None and not ev.query():
            return False
        return not self._joins or self._future.done()

    def wait(self, timeout: "float | None" = None) -> "Event":
        """Host-side block until the recorded point is reached
        (``cudaEventSynchronize``).  Raises if the stream work ahead of
        the record failed."""
        self._future.get(timeout)
        return self

    synchronize = wait

    def elapsed_ms(self, end: "Event") -> float:
        """Device time from this event to ``end`` (``cudaEventElapsedTime``);
        both must be complete."""
        a, b = self.cuda_event(), end.cuda_event()
        if a is None or b is None:
            raise RuntimeError("elapsed_ms needs events recorded on a CUDA stream")
        return a.elapsed_time(b)

    def __repr__(self) -> str:
        state = "ready" if self.query() else "pending"
        return f"Event({self.name}, {state})"


class Stream:
    """One ordered lane of work on one device (``cudaStream_t`` analogue).

    Construct via ``Device.create_stream()`` (or use
    ``Device.default_stream``); the stream forwards the device verbs with
    itself as the ordering scope:

        s1, s2 = dev.create_stream(), dev.create_stream()
        s1.enqueue_write(buf_a, 0, host_a)     # chain A ...
        la = s1.launch(prog, [buf_a], "k", out=[out_a])
        s2.enqueue_write(buf_b, 0, host_b)     # ... overlaps chain B
        lb = s2.launch(prog, [buf_b], "k", out=[out_b])
    """

    __slots__ = ("device", "lane", "cuda_stream", "name", "_events", "_lock", "_completions")

    def __init__(self, device, lane, name: str = "", cuda_stream=None):
        self.device = device
        self.lane = lane
        self.cuda_stream = cuda_stream
        lane.cuda_stream = cuda_stream
        self.name = name or getattr(lane, "name", "stream")
        self._events = 0
        self._lock = threading.Lock()
        # Completion futures of work that reaches this stream's lane only
        # later (a percolating launch joins its copies off-lane first):
        # record() folds them in so an event still means completion.
        self._completions: "list[Future]" = []

    # -- plumbing ------------------------------------------------------------

    def _lane_for(self, device):
        """This stream's lane, validated against the submitting device —
        an op scoped to a stream of the WRONG device would silently lose
        its ordering guarantee, so it is refused outright."""
        if device is not self.device and getattr(device, "key", None) != self.device.key:
            raise ValueError(
                f"stream {self.name!r} belongs to device {self.device.key}; "
                f"it cannot order work on device {getattr(device, 'key', device)!r} — "
                "create a stream on that device instead"
            )
        return self.lane

    # -- generic host-callback submission (cudaLaunchHostFunc) ----------------

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Run a host callable at this point in the stream (FIFO with the
        device ops already enqueued here)."""
        return self.lane.submit(fn, *args, **kwargs)

    # -- stream-scoped device verbs -------------------------------------------

    def enqueue_write(self, buf, offset: int, data, count: "int | None" = None) -> Future:
        """``buf.enqueue_write`` ordered by this stream."""
        return buf.enqueue_write(offset, data, count, stream=self)

    def enqueue_read(self, buf, offset: int = 0, count: "int | None" = None) -> Future:
        """``buf.enqueue_read`` ordered by this stream."""
        return buf.enqueue_read(offset, count, stream=self)

    def launch(
        self,
        program,
        args: "Sequence[Any]",
        kernel: str,
        grid=None,
        block=None,
        out=None,
        sync: str = "ready",
    ) -> Future:
        """``program.run`` ordered by this stream."""
        return program.run(args, kernel, grid=grid, block=block, out=out, sync=sync, stream=self)

    def replay(self, exe, feeds: "dict | None" = None, sync: str = "ready") -> Future:
        """Replay an instantiated single-segment ``GraphExec`` on THIS
        stream (``cudaGraphLaunch(exec, stream)``): staging, the graph and
        the commit run FIFO with this stream's other work.  Equivalent to
        ``exe.replay(feeds, sync, stream=self)``; the replay's future is
        noted as a stream completion, so a later ``record()`` covers it."""
        fut = exe.replay(feeds=feeds, sync=sync, stream=self)
        self._note_completion(fut)
        return fut

    # -- events ----------------------------------------------------------------

    def _note_completion(self, fut: Future) -> None:
        """Track a completion future that record() must cover."""
        with self._lock:
            # Drop already-completed entries: the list stays O(in-flight).
            self._completions = [f for f in self._completions if not f.done()]
            self._completions.append(fut)

    def record(self, name: str = "") -> Event:
        """Record an event at the current tail of this stream
        (``cudaEventRecord``).  A lane task records a ``torch.cuda.Event``
        on the CUDA stream after everything enqueued before it; the
        event's future resolves once that CUDA event has completed and
        every noted completion has resolved."""
        from repro_torch.core.futures import when_all

        self._events += 1
        cs = self.cuda_stream
        marker = self.lane.submit(_record_now, cs)

        def _settle() -> None:
            ev = marker.get()
            if ev is not None:
                ev.synchronize()

        done = Future(resolver=_settle, name=f"record:{self.name}")
        with self._lock:
            pending = list(self._completions)
            if pending:
                done = when_all([done, *pending], name=f"record:{self.name}").then(
                    lambda _: None, executor="inline"
                )
                # The event covers every completion noted so far, so it
                # REPLACES them.
                self._completions = [done]
        return Event(self, marker, done, name or f"{self.name}:e{self._events}",
                     joins=bool(pending))

    def wait_event(self, event: Event) -> Future:
        """Gate LATER work on this stream behind ``event``
        (``cudaStreamWaitEvent``): returns the future of the gate task.

        The gate task waits on the host only until the recording lane has
        reached the record point (and for noted completions); the device
        edge is ``cuda_stream.wait_event``, so the CUDA stream does not
        stall the host while the producer's kernels run."""
        if event.stream is self:
            # Same-stream FIFO already orders later work behind the
            # recorded point.
            return event.future
        cs = self.cuda_stream

        def _gate() -> None:
            # wait(), not get(): the gate orders, it does not re-raise —
            # a failure surfaces on the event's own future.
            event._marker.wait()
            ev = event._marker.get() if event._marker.exception() is None else None
            if ev is not None and cs is not None and not event._joins:
                cs.wait_event(ev)
            else:
                event.future.wait()

        return self.lane.submit(_gate)

    # -- synchronization --------------------------------------------------------

    def query(self) -> bool:
        """Non-blocking: is every operation submitted so far complete —
        including kernels still running on the CUDA stream?
        (``cudaStreamQuery``)."""
        if self.lane.load().depth != 0:
            return False
        with self._lock:
            if not all(f.done() for f in self._completions):
                return False
        return self.cuda_stream is None or self.cuda_stream.query()

    def synchronize(self) -> "Stream":
        """Block until everything submitted to this stream has COMPLETED
        (``cudaStreamSynchronize``)."""
        self.lane.drain()
        with self._lock:
            pending = list(self._completions)
        for f in pending:
            f.wait()
        if self.cuda_stream is not None:
            self.cuda_stream.synchronize()
        return self

    def load(self):
        """This lane's backlog snapshot (per-stream ``QueueLoad``)."""
        return self.lane.load()

    def __repr__(self) -> str:
        return f"Stream({self.name} @ {self.device.key}, depth={self.lane.load().depth})"
