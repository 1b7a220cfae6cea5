"""Futurization layer: HPX futures re-derived for PyTorch and CUDA (paper §3.1).

One future type spans
  * host tasks (functions running on the runtime's thread pools),
  * device values produced by asynchronous CUDA work (a tensor plus the
    ``torch.cuda.Event`` recorded after the work that produces it),
  * composites built with the combinators below.

API mirrors HPX:
  ``Future.get()``                <-> ``hpx::future<T>::get()``
  ``Future.then(fn)``             <-> ``hpx::future<T>::then``
  ``when_all(fs) / when_any(fs)`` <-> ``hpx::when_all / when_any``
  ``dataflow(fn, *args)``         <-> ``hpx::dataflow``
  ``async_(fn, *args)``           <-> ``hpx::async``
  ``wait_all(fs)``                <-> ``hpx::wait_all`` (Listing 2, l. 38)

Design notes
------------
A pending ``Future`` wraps a ``concurrent.futures.Future`` for its
thread-safe result/callback machinery, plus an optional *resolver*: a
one-shot blocking callable producing the value.  Resolvers make
device-value futures lazy — wrapping a CUDA tensor costs one object
allocation and **no** thread work unless/until a continuation is attached
(then the wait is moved to the completion pool) or ``.get()`` is called
(then the wait happens inline).

Two hot-path properties keep the layer at the paper's §5 "no additional
computational overhead" level (DESIGN.md §2, §8):

* **No-alloc ready futures.**  An already-completed ``Future`` stores its
  value (or exception) directly and never allocates the inner
  ``concurrent.futures.Future`` — which carries a ``threading.Condition``
  (a lock + waiter list) that is pure waste for a value that already
  exists.  ``then``/``when_all``/``when_any`` short-circuit completed
  inputs inline: no callback registration, no pool submission.

* **Lock-free resolver handoff.**  The one-shot resolver is claimed via
  ``list.pop()`` on a single-element cell — atomic under the GIL — so the
  race between ``.get()``, ``.then`` and combinators needs no per-future
  ``threading.Lock`` (one fewer allocation per future, no acquire/release
  on every state check).
"""
from __future__ import annotations

import concurrent.futures as _cf
from enum import Enum
from typing import Any, Callable, Generic, Iterable, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = [
    "Future",
    "FutureState",
    "Promise",
    "async_",
    "dataflow",
    "make_ready_future",
    "make_exceptional_future",
    "wait_all",
    "when_all",
    "when_any",
]

_UNSET = object()


class FutureState(Enum):
    PENDING = "pending"
    READY = "ready"
    FAILED = "failed"


def _default_pool():
    # Local import: executor imports futures for its return types.
    from repro_torch.core.executor import get_runtime

    return get_runtime().pool


class Future(Generic[T]):
    """Asynchronous value, composable into an execution DAG.

    Internal representation (one of three modes):
      * value mode:    ``_cf is None`` — completed; ``_value``/``_exc``
                       hold the outcome (the no-alloc ready fast path),
      * pending mode:  ``_cf`` is a live ``concurrent.futures.Future``,
      * resolver mode: pending mode plus ``_rcell = [resolver]``; the
                       resolver is claimed exactly once via the
                       GIL-atomic ``list.pop()``.
    """

    __slots__ = ("_cf", "_rcell", "_value", "_exc", "name")

    def __init__(
        self,
        inner: "_cf.Future | None" = None,
        resolver: "Callable[[], T] | None" = None,
        name: str = "",
    ):
        self._cf: "_cf.Future | None" = inner if inner is not None else _cf.Future()
        self._rcell: "list | None" = [resolver] if resolver is not None else None
        self._value = _UNSET
        self._exc: "BaseException | None" = None
        self.name = name

    # -- constructors ------------------------------------------------------

    @staticmethod
    def ready(value: T, name: str = "") -> "Future[T]":
        """Completed future holding ``value`` — allocates no inner future,
        no lock, no condition variable (hot-path constructor)."""
        f: "Future[T]" = Future.__new__(Future)
        f._cf = None
        f._rcell = None
        f._value = value
        f._exc = None
        f.name = name
        return f

    @staticmethod
    def failed(exc: BaseException, name: str = "") -> "Future[T]":
        f: "Future[T]" = Future.__new__(Future)
        f._cf = None
        f._rcell = None
        f._value = _UNSET
        f._exc = exc
        f.name = name
        return f

    @staticmethod
    def from_concurrent(f: "_cf.Future", name: str = "") -> "Future[T]":
        return Future(f, name=name)

    @staticmethod
    def from_tensor(x, event=None, name: str = "") -> "Future":
        """Wrap a tensor (or a list/tuple of them) produced by work already
        enqueued on a CUDA stream.

        The future becomes READY when ``event`` — by default one recorded
        now on the current stream of the tensor's device, i.e. after the
        producing work — has completed (``cudaEventSynchronize``).  It
        never waits for the whole device.  A CPU tensor is ready at once,
        still through the lazy resolver."""
        import torch

        if event is None:
            first = x[0] if isinstance(x, (list, tuple)) and x else x
            if isinstance(first, torch.Tensor) and first.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(first.device))

        def _resolve():
            if event is not None:
                event.synchronize()
            return x

        return Future(resolver=_resolve, name=name)

    # -- resolver plumbing -------------------------------------------------

    def _take_resolver(self):
        """Claim the one-shot resolver; GIL-atomic, at most one caller wins."""
        cell = self._rcell
        if cell is None:
            return None
        try:
            return cell.pop()
        except IndexError:  # another thread won the handoff
            return None

    def _has_resolver(self) -> bool:
        cell = self._rcell
        return bool(cell)

    def _run_resolver_inline(self, r) -> None:
        try:
            self._cf.set_result(r())
        except BaseException as e:  # noqa: BLE001 - futures carry any error
            try:
                self._cf.set_exception(e)
            except _cf.InvalidStateError:
                # cancel() raced the resolver: the consumer walked away, the
                # produced value (or its error) is discarded, never raised.
                if not self._cf.cancelled():
                    raise

    def _spawn_resolver(self) -> None:
        """Move a pending resolver onto the completion pool (if any)."""
        r = self._take_resolver()
        if r is not None:
            _default_pool().submit(self._run_resolver_inline, r)

    # -- core API ----------------------------------------------------------

    @property
    def state(self) -> FutureState:
        if self._cf is None:
            return FutureState.FAILED if self._exc is not None else FutureState.READY
        if self._has_resolver() or not self._cf.done():
            return FutureState.PENDING
        if self._cf.cancelled():
            return FutureState.FAILED
        return FutureState.FAILED if self._cf.exception() else FutureState.READY

    def done(self) -> bool:
        if self._cf is None:
            return True
        return not self._has_resolver() and self._cf.done()

    def is_ready(self) -> bool:
        return self.state is FutureState.READY

    def get(self, timeout: "float | None" = None) -> T:
        """Block until the value is available and return it (HPX ``get``)."""
        if self._cf is None:
            if self._exc is not None:
                raise self._exc
            return self._value
        if not self._cf.done():
            # About to block: flush this thread's coalesced submissions so a
            # staged task's result can always be awaited (executor.coalesce).
            from repro_torch.core.executor import flush_coalesced

            flush_coalesced()
        r = self._take_resolver()
        if r is not None:
            self._run_resolver_inline(r)
        return self._cf.result(timeout)

    def exception(self, timeout: "float | None" = None) -> "BaseException | None":
        if self._cf is None:
            return self._exc
        if not self._cf.done():
            from repro_torch.core.executor import flush_coalesced

            flush_coalesced()
        r = self._take_resolver()
        if r is not None:
            self._run_resolver_inline(r)
        try:
            return self._cf.exception(timeout)
        except _cf.CancelledError as e:  # a cancelled future *carries* it
            return e

    def wait(self, timeout: "float | None" = None) -> "Future[T]":
        try:
            self.get(timeout)
        except BaseException:  # noqa: BLE001 - wait() never raises
            pass
        return self

    def cancel(self) -> bool:
        """Best-effort cancellation of a still-pending future.

        Returns True when the future was cancelled before anything started
        producing its value; ``get()`` then raises ``CancelledError``.  A
        completed (or value-mode) future — and a task already running on a
        queue worker — cannot be cancelled and returns False.  Producers
        (``Promise.set_value``, the serving engine's batch resolution)
        tolerate a racing cancel: a result arriving after a successful
        cancel is discarded, never raised."""
        if self._cf is None:
            return False
        # Claiming the resolver keeps a lazy device-value future from
        # starting its blocking wait after the cancel.
        self._take_resolver()
        return self._cf.cancel()

    def cancelled(self) -> bool:
        return self._cf is not None and self._cf.cancelled()

    # -- completion (used by Promise / WorkQueue) --------------------------

    def _set_result(self, value) -> None:
        self._cf.set_result(value)

    def _set_exception(self, exc: BaseException) -> None:
        self._cf.set_exception(exc)

    # -- composition --------------------------------------------------------

    def then(
        self,
        fn: "Callable[[T], U]",
        *,
        executor=None,
        name: str = "",
    ) -> "Future[U]":
        """Continuation: run ``fn(value)`` once this future is READY.

        Failure propagates: if this future failed, ``fn`` is not called and
        the returned future carries the same exception.

        Launch policy: by default the continuation runs on the runtime host
        pool — never inline on a device work-queue worker, because a
        continuation that *blocks* on further queue submissions would then
        deadlock the queue (HPX avoids this by suspending its user-level
        threads; OS threads cannot suspend, so we hop).  If the parent is
        already done, run inline on the caller (cheap fast path: no
        callback registration, no pool hop, and the returned future is a
        no-alloc completed one).  Pass ``executor="inline"`` to force
        inline execution, or any object with ``submit`` to choose a pool.
        """
        # Fast path: parent complete -> run inline, return completed future.
        if self._cf is None or (not self._has_resolver() and self._cf.done()):
            if self._cf is not None and self._cf.cancelled():
                return Future.failed(_cf.CancelledError(), name=name or f"{self.name}.then")
            exc = self._exc if self._cf is None else self._cf.exception()
            if exc is not None:
                return Future.failed(exc, name=name or f"{self.name}.then")
            try:
                value = self._value if self._cf is None else self._cf.result()
                return Future.ready(fn(value), name=name or f"{self.name}.then")
            except BaseException as e:  # noqa: BLE001
                return Future.failed(e, name=name or f"{self.name}.then")

        out: Future[U] = Future(name=name or f"{self.name}.then")
        self._spawn_resolver()

        def _fire(parent: _cf.Future) -> None:
            exc = _cf.CancelledError() if parent.cancelled() else parent.exception()
            if exc is not None:
                out._cf.set_exception(exc)
                return

            def _run():
                try:
                    out._cf.set_result(fn(parent.result()))
                except BaseException as e:  # noqa: BLE001
                    out._cf.set_exception(e)

            if executor == "inline":
                _run()
            elif executor is None:
                _default_pool().submit(_run)
            else:
                executor.submit(_run)

        self._cf.add_done_callback(_fire)
        return out

    def __repr__(self) -> str:
        return f"Future({self.name or hex(id(self))}, {self.state.value})"


class Promise(Generic[T]):
    """Manually-resolved future source (``hpx::promise``).

    A promise whose future was ``cancel()``-ed discards late results
    instead of raising: the consumer walked away, the producer should not
    crash for it."""

    def __init__(self, name: str = ""):
        self._future: Future[T] = Future(name=name)

    def get_future(self) -> Future[T]:
        return self._future

    def set_value(self, value: T) -> None:
        try:
            self._future._set_result(value)
        except _cf.InvalidStateError:
            if not self._future._cf.cancelled():
                raise

    def set_exception(self, exc: BaseException) -> None:
        try:
            self._future._set_exception(exc)
        except _cf.InvalidStateError:
            if not self._future._cf.cancelled():
                raise


def forward_failure(src: Future, promise: Promise) -> None:
    """If ``src`` fails, fail ``promise``; on success, do nothing.

    Used by pipelined parcel dispatch: the reply promise is normally
    resolved by the port's listener thread, but when the *dispatch task*
    itself dies (lane shut down before it ran, send failed) nobody ever
    stages the parcel — this hook keeps the reply future from pending
    forever.  Races with a real resolution are benign: first writer wins,
    the late failure is dropped."""
    def _fail(exc: BaseException) -> None:
        try:
            promise.set_exception(exc)
        except _cf.InvalidStateError:
            pass
    if src._cf is None:
        if src._exc is not None:
            _fail(src._exc)
        return
    src._spawn_resolver()

    def _cb(parent: _cf.Future) -> None:
        exc = _cf.CancelledError() if parent.cancelled() else parent.exception()
        if exc is not None:
            _fail(exc)

    src._cf.add_done_callback(_cb)


def make_ready_future(value: T) -> Future[T]:
    return Future.ready(value)


def make_exceptional_future(exc: BaseException) -> Future[Any]:
    return Future.failed(exc)


def when_all(futures: "Iterable[Future]", name: str = "when_all") -> Future[list]:
    """Future of the list of values; fails with the first failure.

    Fast path: inputs that are already complete are collected inline —
    ``when_all`` over N ready futures performs zero pool submissions,
    zero callback registrations and zero lock operations, returning a
    no-alloc completed future (DESIGN.md §8).
    """
    futs = list(futures)
    n = len(futs)
    results: list = [None] * n

    # Inline sweep over already-complete inputs; collect the pending rest.
    pending: "list[tuple[int, Future]]" = []
    for i, f in enumerate(futs):
        if f.done():
            exc = f.exception()
            if exc is not None:
                return Future.failed(exc, name=name)
            results[i] = f.get()
        else:
            pending.append((i, f))

    if not pending:
        return Future.ready(results, name=name)

    out: Future[list] = Future(name=name)
    # Countdown via GIL-atomic list.pop(): each completing dependency takes
    # one token; whoever observes the empty list publishes the result (a
    # late double-publish is absorbed by the InvalidStateError guard).
    tokens = [None] * len(pending)

    def _make_cb(i: int):
        def _cb(parent: _cf.Future) -> None:
            exc = _cf.CancelledError() if parent.cancelled() else parent.exception()
            if exc is not None:
                # set_exception on an already-done future raises; guard.
                if not out._cf.done():
                    try:
                        out._cf.set_exception(exc)
                    except _cf.InvalidStateError:
                        pass
                return
            results[i] = parent.result()
            tokens.pop()
            if not tokens and not out._cf.done():
                try:
                    out._cf.set_result(results)
                except _cf.InvalidStateError:
                    pass

        return _cb

    for i, f in pending:
        f._spawn_resolver()
        f._cf.add_done_callback(_make_cb(i))
    return out


def when_any(futures: "Iterable[Future]", name: str = "when_any") -> Future[tuple]:
    """Future of ``(index, value)`` of the first future to become READY."""
    futs = list(futures)
    if not futs:
        raise ValueError("when_any of empty set")

    # Fast path: any input already complete wins without pool work.
    for i, f in enumerate(futs):
        if f.done():
            exc = f.exception()
            if exc is not None:
                return Future.failed(exc, name=name)
            return Future.ready((i, f.get()), name=name)

    out: Future[tuple] = Future(name=name)

    def _make_cb(i: int):
        def _cb(parent: _cf.Future) -> None:
            if out._cf.done():
                return
            try:
                exc = _cf.CancelledError() if parent.cancelled() else parent.exception()
                if exc is not None:
                    out._cf.set_exception(exc)
                else:
                    out._cf.set_result((i, parent.result()))
            except _cf.InvalidStateError:
                pass

        return _cb

    for i, f in enumerate(futs):
        f._spawn_resolver()
        f._cf.add_done_callback(_make_cb(i))
    return out


def wait_all(futures: "Iterable[Future]") -> None:
    """Blocking barrier (``hpx::wait_all`` — Listing 2, line 38)."""
    for f in list(futures):
        f.wait()


def async_(fn: Callable[..., T], *args, executor=None, name: str = "", **kwargs) -> Future[T]:
    """Run ``fn`` on the runtime host pool (``hpx::async``)."""
    pool = executor if executor is not None else _default_pool()
    return Future.from_concurrent(pool.submit(fn, *args, **kwargs), name=name or getattr(fn, "__name__", "async"))


def dataflow(fn: Callable[..., T], *args, executor=None, name: str = "", **kwargs) -> Future[T]:
    """Run ``fn`` when every future among ``args``/``kwargs`` is READY.

    Non-future arguments pass through unchanged (``hpx::dataflow``).  The
    body runs on the host pool so long chains never recurse on a completing
    thread (unless every dependency is already READY, in which case the
    ``when_all``/``then`` fast paths run the body inline).
    """
    dep_ixs = [i for i, a in enumerate(args) if isinstance(a, Future)]
    dep_keys = [k for k, v in kwargs.items() if isinstance(v, Future)]
    deps = [args[i] for i in dep_ixs] + [kwargs[k] for k in dep_keys]

    def _body(values: list) -> T:
        a = list(args)
        kw = dict(kwargs)
        for slot, v in zip(dep_ixs, values[: len(dep_ixs)]):
            a[slot] = v
        for key, v in zip(dep_keys, values[len(dep_ixs):]):
            kw[key] = v
        return fn(*a, **kw)

    pool = executor if executor is not None else _default_pool()
    return when_all(deps).then(_body, executor=pool, name=name or f"dataflow:{getattr(fn, '__name__', 'fn')}")
