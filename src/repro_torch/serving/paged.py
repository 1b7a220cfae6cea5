"""Paged KV cache + prefill/decode disaggregation on PyTorch over a fleet of
page pools (``src/repro/serving/paged.py``).

* ``PagePool`` — one per device: two slab ``Buffer``s (k and v) of shape
  ``(layers, num_pages, page_size, kv_heads, head_dim)`` plus a free list.
  Page 0 is *reserved* as the padding target: page-table slots past a
  sequence's tail hold it, and no live sequence ever owns it.  The slabs
  re-register under AGAS kind ``"pool"`` at 0 bytes (capacity is not
  pressure); every sequence is a ``SeqPages`` record of kind ``"buffer"``
  whose ``nbytes`` are its pages plus its resident state, so the
  scheduler's memory veto and ``spill_lru`` see sequences as residents.

* ``PagedKVCache`` — the sequence lifecycle (``new_seq`` / ``append`` /
  ``ensure_slot`` / ``note_decoded`` / ``free_seq``), ``table`` (page
  tables + lengths in the kernel's layout), ``defrag`` (compact a pool's
  live pages to the low slots) and ``migrate`` (a sequence's pages to
  another device's pool in one coalesced move).  ``SeqPages.spill`` copies
  a sequence's pages and resident state to pinned host memory and frees its
  pages; ``ensure_resident`` brings them back into freshly allocated pages.

* ``PagedServeEngine`` — a prefill lane (prompts batched by token budget,
  first token sampled on the host) that places each sequence with the
  scheduler (``sched.select``; a full pool spills its LRU sequences), and
  one decode lane *per device* stepping every resident sequence of that
  device in ONE step at mixed lengths: the page table, not the batch shape,
  encodes length.  A sequence whose pages cannot be made resident waits
  (a deferred step) until pages free up.  Every step charges the
  scheduler; every ``rebalance_every`` steps under page pressure the lane
  asks ``select_batch`` whether its sequences still belong here, and a
  different answer migrates the coldest one.  ``from_config(cfg)`` wires
  any ported family through ``repro_torch.models.model.paged_surface``.

* Streams.  The prefill lane runs on a CUDA stream of its own and each
  decode lane on one of its own.  Every device operation on a sequence's
  pages (a prefill's page write, a refetch, a decode step, a migration)
  records an event on the sequence (``SeqPages._ready``); a lane's stream
  waits on it before a step reads the pages, and whatever frees pages (a
  spill, a migration, ``defrag``) first waits for it on the host.  A decode
  step holds the locks of its sequences (taken in seq-id order) from
  ``ensure_resident`` to ``note_decoded``, so a racing spill waits for the
  step, and its event, before the pages are freed.

* Warm row counts, as the reference's: a decode lane pads a batch to the
  nearest row count it has already run (``warm_rows``: at most 2x the real
  rows, else the exact count, which becomes warm), duplicating the last
  row and discarding the pad rows' outputs; ``decode_shapes`` seeds the
  warm set.  On a CUDA device each lane holds ONE CUDA graph of
  ``decode_fn`` per warm count (``_StepGraphs``), captured against its
  pool's slabs by address: the first step at a count runs eagerly and is
  then captured, every later step at that count is one pinned H2D of
  tokens, lengths and tables into the count's static tensors, the per-row
  states stacked into a static state, and one graph launch.  ``defrag``,
  ``set_arrays``, ``write_pages`` and a refetch move pages *in place*, in
  the same slab tensors, so the graphs stay valid; a slab tensor rebound
  all the same drops that lane's graphs, which are then recaptured.

Sampling is host-side and bit-reproducible: token ``position`` of request
``request_id`` draws from ``np.random.default_rng([seed, request_id,
position])`` (greedy argmax when ``temperature <= 0``), so tokens do not
depend on batch composition or fleet size.

* Prefill on one locality, decode on another, as the reference does it:
  ``PagedKVCache.export_seq`` snapshots a sequence (its pages as ONE
  coalesced gather, its length and resident state) into host values,
  ``paged_worker_decode`` is the parcel ``invoke`` target that imports
  them into a cache of its own locality (``import_seq``: ONE coalesced
  scatter) and decodes there, with params re-derived from the config name
  and seed, so nothing but pages crosses the wire.  An engine serves the
  devices of one locality, as the reference's does, and refuses a fleet
  across localities.

* Spans.  While a ``torch.profiler`` session records, the engine keeps a
  span of each request's wait in the queue, of each prefill batch and each
  decode step, and of their parts (``SERVE_SPANS``, ``_Spans``), each a
  profiler range as well, on the clock the profiler stamps device
  operations on; ``metrics()["spans"]`` returns them.  Otherwise a span's
  site costs one flag check and stores nothing.

Env knobs, as the reference's: ``REPRO_PAGE_SIZE`` (tokens per page,
default 16), ``REPRO_PAGE_POOL_BYTES`` (pool bytes a device, default 32
MiB), ``REPRO_PREFILL_TOKEN_BUDGET`` (prefill lane batch bound, default
2048), ``REPRO_DECODE_DEADLINE_S`` (decode lane arrival wait, default 1 ms).
"""
from __future__ import annotations

import concurrent.futures as _cf
import contextlib
from collections import Counter
import itertools
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from repro_torch.core import agas
from repro_torch.core.buffer import _to_host, _to_host_value, torch_dtype
from repro_torch.core.executor import on_runtime_reset
from repro_torch.core.futures import Future, Promise
from repro_torch.kernels import tally_launches
from repro_torch.serving.engine import EngineClosed, LanePolicy, QueueFull

__all__ = [
    "PageSpec",
    "PagePool",
    "PagedKVCache",
    "PagedServeEngine",
    "SERVE_SPANS",
    "SamplingParams",
    "SeqPages",
    "OutOfPages",
    "paged_worker_decode",
    "paged_worker_reset",
    "paged_worker_stats",
    "sample_token",
    "warm_rows",
]

def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _now() -> float:
    return time.monotonic()


def _leaves(tree) -> "list":
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _to_device(arr: np.ndarray, device: "torch.device") -> "torch.Tensor":
    """One host array on ``device``: from pinned memory, asynchronously on
    the current stream, for a CUDA device (never a pageable copy)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _stack_extras(group, device: "torch.device"):
    """The group's ``extras`` stacked by key (the first request's keys) on
    ``device``, on the current stream; None without extras."""
    if group[0].extras is None:
        return None
    return {key: _to_device(np.stack([np.asarray(r.extras[key]) for r in group]), device)
            for key in group[0].extras}


def _pow2_pad_idx(idx: np.ndarray) -> np.ndarray:
    """Pad a page-index vector to the next power-of-two length by repeating
    its last entry (a duplicate writes the same page with the same value),
    so the page moves' index tensors take log2(max pages) distinct
    lengths."""
    n = idx.size
    want = 1
    while want < n:
        want *= 2
    if want == n:
        return idx
    return np.concatenate([idx, np.repeat(idx[-1:], want - n)])


def _sync_current(device: "torch.device") -> None:
    """Block until the current stream of ``device`` has done its work (a
    no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _record(device: "torch.device") -> "torch.cuda.Event | None":
    """An event at the tail of the current stream of ``device`` (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def warm_rows(rows: int, warm) -> int:
    """The row count a decode step of ``rows`` real rows runs at, given the
    ``warm`` counts already run (``src/repro/serving/paged.py:1338-1342``):
    the smallest warm count >= ``rows`` when it pads by no more than the
    real rows (at most 2x), else ``rows`` itself.  The caller adds the
    result to ``warm``."""
    cand = min((w for w in warm if w >= rows), default=None)
    return cand if cand is not None and cand - rows <= rows else rows


class OutOfPages(RuntimeError):
    """The pool has fewer free pages than the allocation needs."""


@dataclass(frozen=True)
class PageSpec:
    """Geometry of one KV page: ``page_size`` tokens × ``kv_heads`` ×
    ``head_dim`` per layer, k and v both.  Pass ``page_size=0`` to take
    ``REPRO_PAGE_SIZE`` (default 16).  ``dtype`` is a torch dtype (a numpy
    dtype is converted)."""

    layers: int
    page_size: int
    kv_heads: int
    head_dim: int
    dtype: Any = torch.float32

    def __post_init__(self):
        if not self.page_size:
            object.__setattr__(self, "page_size", _env_int("REPRO_PAGE_SIZE", 16))
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def page_bytes(self) -> int:
        """Bytes one page pins across both slabs (k + v, all layers)."""
        return (2 * self.layers * self.page_size * self.kv_heads * self.head_dim
                * self.dtype.itemsize)

    def pages_for(self, tokens: int) -> int:
        return max(0, -(-int(tokens) // self.page_size))


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    ``temperature <= 0`` means greedy argmax (the default, and the
    parity-oracle mode).  ``top_k``/``top_p`` filter the distribution
    after temperature scaling: keep the ``top_k`` highest-probability
    tokens (0 = unlimited), then the smallest prefix of the descending
    distribution whose cumulative probability reaches ``top_p``.
    ``seed`` keys the per-request PRNG stream."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def sample_token(logits, params: "SamplingParams | None",
                 request_id: int, position: int) -> int:
    """Sample ONE token from a ``(V,)`` logits row, bit-reproducibly.

    The PRNG is seeded ``[seed, request_id, position]`` — a pure
    function of the request's identity and the token's position, so the
    same request emits the same tokens whether it shared its decode
    batch with 0 or 63 neighbours and whether the fleet had 1 or 8
    devices.  Math is float64 on host: no accelerator, dtype or fusion
    variance can leak into the draw."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if params is None or params.temperature <= 0.0:
        return int(np.argmax(logits))
    x = logits / float(params.temperature)
    order = np.argsort(-x, kind="stable")  # stable: ties break by token id
    xs = x[order]
    keep = xs.size
    if params.top_k and params.top_k > 0:
        keep = min(keep, int(params.top_k))
    xs = xs[:keep]
    probs = np.exp(xs - xs.max())
    probs /= probs.sum()
    if params.top_p < 1.0:
        cum = np.cumsum(probs)
        # smallest prefix reaching top_p (always >= 1 token)
        cut = int(np.searchsorted(cum, params.top_p, side="left")) + 1
        probs = probs[:cut]
        probs /= probs.sum()
    rng = np.random.default_rng(
        [int(params.seed), int(request_id), int(position)])
    u = rng.random()
    idx = int(np.searchsorted(np.cumsum(probs), u, side="right"))
    idx = min(idx, probs.size - 1)
    return int(order[idx])


# The engine's spans, in the order its work runs: a request's wait in the
# queue; a prefill batch and its parts; a decode step and its parts.  Each
# is a torch.profiler range of its name as well (but ``serve.queue``, which
# opens on the submitting thread and closes on the prefill lane's).
SERVE_SPANS = ("serve.queue", "serve.prefill", "prefill.forward", "prefill.logits",
               "prefill.sample", "prefill.page_in", "serve.decode", "decode.locks",
               "decode.prepare", "decode.launch", "decode.logits", "decode.sample",
               "decode.capture")
_SPAN_CAP = 1 << 16
_NO_SPAN = contextlib.nullcontext()


def _recording() -> bool:
    """True while a ``torch.profiler`` session records, on any thread."""
    return _autograd_profiler._is_profiler_enabled


class _Spans:
    """The spans an engine keeps while a ``torch.profiler`` session records
    (``_recording``), each opened as a ``record_function`` range too.  A
    span is ``(name, start_ns, end_ns, span_id, parent_id, attrs)`` on
    ``time.time_ns()``, the clock Kineto stamps device operations on;
    ``parent_id`` is the span open on the same thread when it opened (None
    at the top).  The first ``cap`` spans since ``clear`` are kept and
    ``dropped`` counts the rest.  Not recording, ``span`` returns a context
    that stores nothing and gives None to ``as``."""

    def __init__(self, cap: int = _SPAN_CAP):
        self.cap = int(cap)
        self.dropped = 0
        self._kept: "list[tuple]" = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open = threading.local()

    def span(self, name: str):
        """A context timing ``name``; its ``attrs`` dict takes the span's
        attributes."""
        return _Span(self, name) if _recording() else _NO_SPAN

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """Keep a span timed elsewhere, with no parent."""
        self._keep((name, start_ns, end_ns, next(self._ids), None, attrs))

    def _stack(self) -> "list[int]":
        stack = getattr(self._open, "ids", None)
        if stack is None:
            stack = self._open.ids = []
        return stack

    def _keep(self, span: tuple) -> None:
        with self._lock:
            if len(self._kept) < self.cap:
                self._kept.append(span)
            else:
                self.dropped += 1

    def clear(self) -> None:
        with self._lock:
            self._kept = []
            self.dropped = 0

    def snapshot(self) -> "tuple[list[tuple], int]":
        """The spans kept, in the order they closed, and the count dropped."""
        with self._lock:
            return list(self._kept), self.dropped


class _Span:
    """One open span of a ``_Spans`` (see there)."""

    __slots__ = ("log", "name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, log: _Spans, name: str):
        self.log, self.name, self.attrs = log, name, {}

    def __enter__(self) -> "_Span":
        stack = self.log._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.log._ids)
        stack.append(self.id)
        self._range = record_function(self.name)
        self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self._range.__exit__(*exc)
        self.log._stack().pop()
        self.log._keep((self.name, self.start, end, self.id, self.parent, self.attrs))
        return False


# Consecutive empty decode steps (nothing fits in the pool) tolerated
# before the lane declares the working set unservable and fails the
# stalled batch.  At the 2ms stall backoff this is ~1s of zero progress.
_MAX_DECODE_STALLS = 500


class _CaptureGate:
    """Device work on a cache's pools holds the gate shared; a decode
    lane's step-graph capture holds it alone.  A capture records its
    stream's work into a graph, and device work of another thread during
    it can invalidate the capture: an allocation that has the caching
    allocator free cached device memory (its answer to a failed
    ``cudaMalloc``) synchronises the device.  Shared holds nest within a
    thread, and a waiting capture holds back new shared holders.  Lock
    order: sequence locks, then the gate, then pool locks; a capture holds
    no lock."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._waiting = 0
        self._capturing = False
        self._depth = threading.local()

    @contextlib.contextmanager
    def shared(self):
        d = getattr(self._depth, "n", 0)
        if d == 0:
            with self._cv:
                while self._capturing or self._waiting:
                    self._cv.wait()
                self._shared += 1
        self._depth.n = d + 1
        try:
            yield
        finally:
            self._depth.n = d
            if d == 0:
                with self._cv:
                    self._shared -= 1
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if getattr(self._depth, "n", 0):
            raise RuntimeError("a capture inside shared device work would wait for itself")
        with self._cv:
            self._waiting += 1
            while self._capturing or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._capturing = True
        try:
            yield
        finally:
            with self._cv:
                self._capturing = False
                self._cv.notify_all()


class PagePool:
    """One device's page pool: two slab Buffers + a free list.

    The free list and the slab bookkeeping change under ``lock``.  The
    slabs themselves are written in place on the device (the prefill
    lane's ``write_tokens``, a decode step's scatter, ``write_pages``,
    ``set_arrays``), always to pages one sequence owns: their tensors are
    never rebound, so a captured step graph stays valid.  ``spills`` and
    ``refetches`` count the sequences spilled from and refetched into this
    pool.  While an admission makes room here (``admit``), ``alloc`` from
    any other thread fails with ``OutOfPages``, so the pages a spill frees
    for the admission go to it."""

    def __init__(self, device, spec: PageSpec, num_pages: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is reserved)")
        self.device = device
        self.spec = spec
        self.num_pages = int(num_pages)
        shape = (spec.layers, self.num_pages, spec.page_size, spec.kv_heads, spec.head_dim)
        self.k_slab = device.create_buffer(shape, spec.dtype).get()
        self.v_slab = device.create_buffer(shape, spec.dtype).get()
        for b in (self.k_slab, self.v_slab):
            self._repin(b)
        self.lock = threading.RLock()
        self._free: "list[int]" = list(range(self.num_pages - 1, 0, -1))
        self.spills = 0
        self.refetches = 0
        # Threads making room here for an admission (ident -> count).
        self._admitters: Counter = Counter()

    @staticmethod
    def _repin(buf) -> None:
        """Move a slab's AGAS record to kind ``"pool"`` at 0 bytes: usage
        is accounted per sequence (``SeqPages``), capacity is not
        pressure, and ``spill_lru`` never evicts a slab."""
        agas.registry.unregister(buf.gid)
        if buf._finalizer is not None:
            buf._finalizer.detach()
        buf.gid = agas.registry.register(buf, agas.Placement(buf.device.key, 0), kind="pool",
                                         nbytes=0)
        buf._finalizer = weakref.finalize(buf, agas.registry.retire, buf.gid)

    # -- allocation ----------------------------------------------------------

    def alloc(self, n: int) -> "list[int]":
        with self.lock:
            me = threading.get_ident()
            if any(t != me for t in self._admitters):
                raise OutOfPages(f"{self.device.key}: an admission is making room here")
            if n > len(self._free):
                raise OutOfPages(
                    f"{self.device.key}: need {n} page(s), {len(self._free)} free "
                    f"of {self.num_pages - 1}"
                )
            return [self._free.pop() for _ in range(n)]

    def free(self, pages: "Sequence[int]") -> None:
        with self.lock:
            for p in pages:
                if not 0 < p < self.num_pages:
                    raise ValueError(f"page {p} is not an allocatable page of this pool")
                if p in self._free:
                    raise ValueError(f"double free of page {p} on {self.device.key}")
                self._free.append(p)

    @property
    def num_free(self) -> int:
        with self.lock:
            return len(self._free)

    @property
    def admitting(self) -> bool:
        with self.lock:
            return bool(self._admitters)

    def admit(self, n: int) -> None:
        """The calling thread starts (``n`` 1) or ends (``n`` -1) making
        room for an admission."""
        me = threading.get_ident()
        with self.lock:
            self._admitters[me] += n
            if self._admitters[me] <= 0:
                del self._admitters[me]

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.num_free

    # -- slab views ----------------------------------------------------------

    def arrays(self) -> "tuple[torch.Tensor, torch.Tensor]":
        """The (k, v) slabs, ordered after their last writer on the current
        stream."""
        with self.lock:
            return self.k_slab.array(), self.v_slab.array()

    def mark_written(self) -> None:
        """Note an in-place write of both slabs on the current stream."""
        with self.lock:
            self.k_slab._mark_written()
            self.v_slab._mark_written()

    def set_arrays(self, k, v) -> None:
        """Make ``k``/``v`` the slabs' contents: copied in place into the
        same slab tensors (a no-op for the slabs themselves), so no slab is
        rebound and no step graph goes stale."""
        with self.lock:
            ks, vs = self.arrays()
            for slab, x in ((ks, k), (vs, v)):
                if x.data_ptr() != slab.data_ptr():
                    slab.copy_(x)
            self.mark_written()

    def write_tokens(self, pages: "Sequence[int]", k, v) -> None:
        """Write T tokens of k/v ``(L, T, Kh, D)`` into ``pages`` (token t
        at slot t % P of page ``pages[t // P]``) with one index copy per
        slab on the slab's device, and zero the last page past token T."""
        ks, vs = self.arrays()
        L, N, P, Kh, D = ks.shape
        T = k.shape[1]
        pages = np.asarray(pages, np.int64)
        t = np.arange(T)
        tail = np.arange(T, len(pages) * P)
        idx = _to_device(np.concatenate([pages[t // P] * P + t % P, pages[tail // P] * P + tail % P]),
                         ks.device)
        for slab, x in ((ks, k), (vs, v)):
            flat = slab.view(L, N * P, Kh, D)
            flat.index_copy_(1, idx[:T], x.to(device=slab.device, dtype=slab.dtype))
            if len(tail):
                flat.index_fill_(1, idx[T:], 0)
        self.mark_written()

    def write_pages(self, pages: "Sequence[int]", k, v) -> None:
        """Scatter whole pages into the slabs in place: k/v are ``(n, L, P,
        Kh, D)`` host or device tensors, one row a page, copied on the
        current stream (asynchronously from pinned memory).  The index is
        padded to a power of two (``_pow2_pad_idx``), its extra entries
        rewriting the last page with the same row."""
        n = len(pages)
        if n == 0:
            return
        idx = _pow2_pad_idx(np.asarray(pages, np.int64))
        with self.lock:
            ks, vs = self.arrays()
            idx_d = _to_device(idx, ks.device)
            for slab, x in ((ks, k), (vs, v)):
                x = torch.as_tensor(x)
                pinned = x.device.type == "cpu" and x.is_pinned()
                rows = x.to(slab.device, dtype=slab.dtype, non_blocking=pinned).movedim(0, 1)
                if idx.size != n:
                    rows = torch.cat([rows, rows[:, -1:].expand(-1, idx.size - n, -1, -1, -1)], 1)
                slab.index_copy_(1, idx_d, rows)
            self.mark_written()

    def read_pages(self, pages: "Sequence[int]") -> "tuple[torch.Tensor, torch.Tensor]":
        """Gather whole pages out: ``(n, L, P, Kh, D)`` tensors on the
        pool's device, gathered on the current stream (the caller moves
        them and synchronises before the pages are freed).  The gather's
        index is padded to a power of two like ``write_pages``'s and the
        extra rows are sliced off."""
        n = len(pages)
        if n == 0:
            sh = (0, self.spec.layers, self.spec.page_size, self.spec.kv_heads, self.spec.head_dim)
            return (torch.empty(sh, dtype=self.spec.dtype, device=self.device.torch_device),
                    torch.empty(sh, dtype=self.spec.dtype, device=self.device.torch_device))
        idx = _pow2_pad_idx(np.asarray(pages, np.int64))
        with self.lock:
            ks, vs = self.arrays()
            idx_d = _to_device(idx, ks.device)
            return (ks.index_select(1, idx_d)[:, :n].movedim(1, 0),
                    vs.index_select(1, idx_d)[:, :n].movedim(1, 0))

    def __repr__(self) -> str:
        return (f"PagePool({self.device.key}: {self.used_pages}/"
                f"{self.num_pages - 1} pages used)")


class SeqPages:
    """One sequence's pages: the AGAS-visible unit of KV residency.

    Registered kind ``"buffer"`` with ``nbytes`` = pages × page bytes plus
    the resident state's bytes (re-declared on every change), exposing
    ``gid``/``device``/``nbytes``/``spill``/``_last_use`` as a ``Buffer``
    does, so affinity scoring, the memory veto and ``spill_lru`` see
    sequences as residents.  ``spill`` copies the pages and the state to
    pinned host memory and returns the pages to the pool (the record moves
    to ``agas.HOST_KEY``); ``ensure_resident`` allocates pages again (their
    numbers may differ) and writes the host copy back.  ``_ready`` is the
    event ending the last device work on the pages."""

    def __init__(self, pool: PagePool, seq_id: int, gate: _CaptureGate):
        self.pool = pool
        self.seq_id = seq_id
        self._gate = gate
        self.pages: "list[int]" = []
        self.length = 0
        # Resident state: a nested dict of device tensors (SSM state, conv
        # window) whose bytes fold into ``nbytes``; host tensors while
        # spilled.
        self.state: Any = None
        self._state_bytes = 0
        self._spilled: "tuple[torch.Tensor, torch.Tensor] | None" = None
        self._ready: "torch.cuda.Event | None" = None
        self._lock = threading.RLock()
        self._last_use = _now()
        self.gid = agas.registry.register(self, agas.Placement(pool.device.key, 0),
                                          kind="buffer", nbytes=0)
        self._finalizer = weakref.finalize(self, agas.registry.retire, self.gid)

    @property
    def device(self):
        return self.pool.device

    @property
    def nbytes(self) -> int:
        """Device-resident bytes: pages plus the resident state (a spilled
        sequence pins nothing)."""
        n = len(self.pages) * self.pool.spec.page_bytes
        if self._spilled is None:
            n += self._state_bytes
        return n

    @property
    def spilled(self) -> bool:
        return self._spilled is not None

    def set_state(self, state) -> None:
        """Attach/replace the sequence's resident state and re-declare its
        bytes through AGAS."""
        with self._lock:
            self.state = state
            self._state_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
            self._account()

    def _account(self) -> None:
        try:
            agas.registry.update_nbytes(self.gid, self.nbytes)
        except KeyError:  # freed under a racing finalizer
            pass

    def _mark_ready(self) -> None:
        """The pages' last device work ends at the current stream's tail."""
        self._ready = _record(self.pool.device.torch_device)

    def _wait_ready(self) -> None:
        """Order the current stream after the pages' last device work."""
        if self._ready is not None:
            torch.cuda.current_stream(self.pool.device.torch_device).wait_event(self._ready)

    def _sync_ready(self) -> None:
        """Block the host until the pages' last device work has ended."""
        if self._ready is not None:
            self._ready.synchronize()

    # -- spill / refetch ---------------------------------------------------------

    def spill(self) -> Future:
        """Evict to pinned host memory (future of True when pages were
        released): the page contents and the state copy out, the pages go
        back to the pool and the AGAS record moves to ``HOST_KEY``, as
        ``Buffer.spill``.  Waits for a decode step holding the sequence."""
        return self.pool.device.ops_queue.submit(self._spill_now)

    def _spill_now(self) -> bool:
        with self._lock, self._gate.shared():
            if self._spilled is not None or not self.pages:
                return False
            pool = self.pool
            self._sync_ready()
            k, v = pool.read_pages(self.pages)
            self._spilled = (_to_host(k), _to_host(v))
            if self.state is not None:
                self.state = _tree_map(_to_host, self.state)
            _sync_current(pool.device.torch_device)  # the copies have ended: the pages may go
            self._ready = None
            pool.free(self.pages)
            self.pages = []
            agas.registry.update_placement(self.gid, agas.Placement(agas.HOST_KEY, 0))
            self._account()
            with pool.lock:
                pool.spills += 1
            return True

    def ensure_resident(self) -> None:
        """Refetch after a spill, on the current stream: allocate pages
        (``OutOfPages`` leaves the sequence spilled), write the host copy
        into them in place and move the state back to the device."""
        with self._lock, self._gate.shared():
            if self._spilled is None:
                return
            k, v = self._spilled
            pool = self.pool
            pages = pool.alloc(len(k))
            pool.write_pages(pages, k, v)
            if self.state is not None:
                dev = pool.device.torch_device
                self.state = _tree_map(lambda t: t.to(dev, non_blocking=t.is_pinned()), self.state)
            self._mark_ready()
            self.pages = pages
            self._spilled = None
            agas.registry.update_placement(self.gid, agas.Placement(pool.device.key, 0))
            self._account()
            self._last_use = _now()
            with pool.lock:
                pool.refetches += 1

    def __repr__(self) -> str:
        where = "spilled" if self.spilled else self.pool.device.key
        return (f"SeqPages(#{self.seq_id}: {self.length} tok / "
                f"{len(self.pages)} pages @ {where})")


class PagedKVCache:
    """Paged KV allocator over a fleet: one ``PagePool`` per device plus
    the sequence lifecycle, pool compaction (``defrag``) and coalesced
    moves between devices (``migrate``).  ``devices=None`` takes every
    CUDA device (``REPRO_LOGICAL_DEVICES`` applies)."""

    def __init__(self, spec: PageSpec, devices: "Sequence | None" = None,
                 pool_pages: "int | None" = None,
                 pool_bytes: "int | None" = None):
        if devices is None:
            from repro_torch.core.device import get_all_devices

            devices = get_all_devices().get()
            if not devices:
                raise RuntimeError("PagedKVCache: no CUDA device; pass devices=[...] "
                                   "(a CPU device: get_all_devices(platform='cpu'))")
        if pool_pages is None:
            if pool_bytes is None:
                pool_bytes = _env_int("REPRO_PAGE_POOL_BYTES", 32 << 20)
            pool_pages = max(2, pool_bytes // spec.page_bytes)
        self.spec = spec
        self.pools: "dict[str, PagePool]" = {
            d.key: PagePool(d, spec, pool_pages) for d in devices
        }
        self._seq_lock = threading.Lock()
        self._next_seq = 0
        self._seqs: "dict[int, SeqPages]" = {}
        self.gate = _CaptureGate()

    def pool_of(self, device) -> PagePool:
        try:
            return self.pools[device.key]
        except KeyError:
            raise KeyError(f"no page pool on {device.key}") from None

    # -- sequence lifecycle --------------------------------------------------

    def new_seq(self, device) -> SeqPages:
        pool = self.pool_of(device)
        with self._seq_lock:
            sid = self._next_seq
            self._next_seq += 1
            seq = self._seqs[sid] = SeqPages(pool, sid, self.gate)
        return seq

    def append(self, seq: SeqPages, k, v) -> None:
        """Page ``T`` new tokens in: k/v are ``(L, T, Kh, D)`` tensors
        (ideally already on the pool's device: one index copy per slab).
        A partial tail page is zero-padded (masked by ``length`` at
        attention time)."""
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        with seq._lock, self.gate.shared():
            seq.ensure_resident()
            if seq.length % self.spec.page_size:
                raise ValueError(
                    "append must start on a page boundary (decode steps append "
                    "token-at-a-time inside decode_fn, not through append)"
                )
            pages = seq.pool.alloc(self.spec.pages_for(k.shape[1]))
            seq._wait_ready()
            seq.pool.write_tokens(pages, k, v)
            seq._mark_ready()
            seq.pages.extend(pages)
            seq.length += k.shape[1]
            seq._last_use = _now()
            seq._account()

    def ensure_slot(self, seq: SeqPages) -> None:
        """Grow the sequence by one page when the next decoded token has
        no slot (length sits on a page boundary)."""
        with seq._lock:
            if len(seq.pages) * self.spec.page_size < seq.length + 1:
                seq.pages.extend(seq.pool.alloc(1))
                seq._account()

    def note_decoded(self, seq: SeqPages) -> None:
        """One token was scattered into the sequence's tail slot by
        ``decode_fn``; the bookkeeping catches up here."""
        with seq._lock:
            seq.length += 1
            seq._last_use = _now()

    def free_seq(self, seq: SeqPages) -> None:
        with seq._lock:
            if seq.pages:
                seq._sync_ready()
                seq.pool.free(seq.pages)
            seq.pages = []
            seq._spilled = None
            seq._ready = None
            seq.state = None
            seq._state_bytes = 0
            seq.length = 0
            if seq._finalizer is not None:
                seq._finalizer.detach()
                seq._finalizer = None
            agas.registry.unregister(seq.gid)
        with self._seq_lock:
            self._seqs.pop(seq.seq_id, None)

    # -- layout for the kernel -----------------------------------------------

    def table(self, seqs: "Sequence[SeqPages]", max_pages: int):
        """(page_table (B, max_pages) int32, lengths (B,) int32) numpy
        arrays in the ``paged_attention`` layout: padding slots hold the
        reserved page 0."""
        B = len(seqs)
        tbl = np.zeros((B, max_pages), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, s in enumerate(seqs):
            n = len(s.pages)
            if n > max_pages:
                raise ValueError(
                    f"sequence #{s.seq_id} has {n} pages, table width is {max_pages}"
                )
            tbl[i, :n] = s.pages
            lens[i] = s.length
        return tbl, lens

    # -- maintenance ---------------------------------------------------------

    def defrag(self, device) -> int:
        """Compact a pool: live pages move to the lowest slots (stable
        order) in place, in the same slab tensors, sequence tables are
        rewritten and the free list becomes the contiguous tail.  Returns
        the number of pages that moved.

        Lock order: every holder's ``seq._lock`` first (in ``seq_id``
        order), then the capture gate, then the pool lock, the order spill,
        migrate, append and a decode step use.  If the holder set changed while the locks were
        taken, everything is released and the pass retries; after 8
        contended passes it returns 0 (defrag is maintenance).  The move
        waits for each holder's last device work and ends before the locks
        are released, so a page freed here is never written while the move
        still reads it."""
        pool = self.pool_of(device)
        for _ in range(8):
            with self._seq_lock:
                holders = sorted((s for s in self._seqs.values() if s.pool is pool),
                                 key=lambda s: s.seq_id)
            with contextlib.ExitStack() as stack:
                for s in holders:
                    stack.enter_context(s._lock)
                with self.gate.shared(), pool.lock:
                    with self._seq_lock:
                        current = [s for s in self._seqs.values() if s.pool is pool]
                    if any(s not in holders for s in current):
                        continue  # an unlocked holder raced in: retry
                    holders = [s for s in holders if s.pool is pool and s.pages]
                    live = sorted(p for s in holders for p in s.pages)
                    mapping = {old: new for new, old in enumerate(live, start=1)}
                    moves = [(old, new) for old, new in mapping.items() if old != new]
                    if moves:
                        for s in holders:
                            s._wait_ready()
                        old = _to_device(np.asarray([m[0] for m in moves], np.int64),
                                         pool.device.torch_device)
                        new = _to_device(np.asarray([m[1] for m in moves], np.int64),
                                         pool.device.torch_device)
                        ks, vs = pool.arrays()
                        for slab in (ks, vs):
                            slab.index_copy_(1, new, slab.index_select(1, old))
                        pool.mark_written()
                        _sync_current(pool.device.torch_device)
                        for s in holders:
                            s.pages = [mapping[p] for p in s.pages]
                            s._ready = None
                    pool._free = list(range(pool.num_pages - 1, len(live), -1))
                    return len(moves)
        return 0

    def migrate(self, seq: SeqPages, device) -> None:
        """Re-home a sequence: all its pages leave the source slabs as one
        gather and land in the target pool as one scatter (a device-to-
        device copy between two logical devices of one card), the state
        follows, and the AGAS record moves with them, so affinity scores
        the new home at once.  The source pages are freed once the copy has
        ended."""
        dst = self.pool_of(device)
        with seq._lock, self.gate.shared():
            if seq.pool is dst:
                return
            seq.ensure_resident()
            src = seq.pool
            seq._wait_ready()
            k, v = src.read_pages(seq.pages)
            pages = dst.alloc(len(seq.pages))
            dst.write_pages(pages, k, v)
            if seq.state is not None and dst.device.torch_device != src.device.torch_device:
                seq.state = _tree_map(lambda t: t.to(dst.device.torch_device), seq.state)
            _sync_current(src.device.torch_device)
            src.free(seq.pages)
            seq.pool = dst
            seq.pages = pages
            seq._ready = None
            agas.registry.update_placement(seq.gid, agas.Placement(device.key, 0))
            seq._account()
            seq._last_use = _now()

    # -- cross-locality shipping (prefill -> decode disaggregation) ----------

    def export_seq(self, seq: SeqPages) -> dict:
        """Ship-ready snapshot of one sequence: ``{"k", "v", "length",
        "state"}``.  The pages leave the slabs as ONE coalesced gather
        (``read_pages``, ordered after the sequence's last device work) and
        come to the host: f32 pages and state leaves as numpy arrays, as
        the reference's, bf16 ones as CPU bfloat16 tensors (the parcel
        codec's ``B`` tag carries them bit-exactly).  Over a parcel
        ``invoke`` the big arrays take the shm lane where there is room."""
        with seq._lock, self.gate.shared():
            seq.ensure_resident()
            dev = seq.pool.device.torch_device
            seq._wait_ready()
            k, v = seq.pool.read_pages(seq.pages)
            k, v = _to_host(k), _to_host(v)
            state = None if seq.state is None else _tree_map(_to_host, seq.state)
            _sync_current(dev)
            return {"k": _to_host_value(k), "v": _to_host_value(v), "length": int(seq.length),
                    "state": None if state is None else _tree_map(_to_host_value, state)}

    def import_seq(self, device, payload: dict) -> SeqPages:
        """Inverse of ``export_seq``, usually on another locality's cache:
        a new sequence on ``device``, its pages allocated and written as
        ONE coalesced scatter, its length set and its state re-attached
        (its bytes declared against THIS device); the sequence's event is
        recorded after the write, so a decode step's stream waits on it.
        Decode resumes from the shipped table as if the prompt had
        prefilled here."""
        seq = self.new_seq(device)
        k, v = torch.as_tensor(payload["k"]), torch.as_tensor(payload["v"])
        with seq._lock, self.gate.shared():
            pool = seq.pool
            dev = pool.device.torch_device
            pages = pool.alloc(len(k))
            pool.write_pages(pages, k, v)
            seq.pages = pages
            seq.length = int(payload["length"])
            if payload.get("state") is not None:
                seq.set_state(_tree_map(lambda a: torch.as_tensor(a).to(dev),
                                        payload["state"]))
            seq._mark_ready()
            seq._account()
            seq._last_use = _now()
        return seq

    def stats(self) -> dict:
        out = {}
        for key, pool in self.pools.items():
            with pool.lock:
                out[key] = {
                    "used_pages": pool.used_pages,
                    "free_pages": pool.num_free,
                    "resident_bytes": agas.registry.resident_bytes(key),
                    "spills": pool.spills,
                    "refetches": pool.refetches,
                }
        return out


class _PagedRequest:
    __slots__ = ("tokens", "max_new", "promise", "arrived", "queued_ns", "seq", "out",
                 "first_token_s", "handed_off", "rid", "sampling", "extras")

    def __init__(self, tokens, max_new, promise, arrived, rid=0, sampling=None, extras=None):
        self.tokens = tokens
        self.max_new = max_new
        self.promise = promise
        self.arrived = arrived
        self.queued_ns = time.time_ns()  # where its ``serve.queue`` span starts
        # ``rid`` keys the sampling PRNG stream, ``sampling`` is a
        # SamplingParams (None = greedy).
        self.rid = rid
        self.sampling = sampling
        # ``extras`` carries per-request modality inputs (whisper frames).
        self.extras = extras
        self.seq: "SeqPages | None" = None
        self.out: "list[int]" = []
        self.first_token_s: "float | None" = None
        # True once prefill is done with the request — settled or admitted
        # to the decode lane: a prefill-batch failure fails only the
        # requests prefill still owns.
        self.handed_off = False


class PagedServeEngine:
    """Prefill/decode-disaggregated serving over a ``PagedKVCache`` of one
    or more devices.

    ``submit(prompt, max_new_tokens)`` returns a future of the generated
    token ids (np.int32).  The prefill lane batches equal-length prompts
    by token budget and pages their KV into the pool of the device the
    scheduler picks; one decode lane a device steps every resident sequence
    of its pool in batches padded to warm row counts.  ``scheduler=None``
    places with a ``Scheduler`` over the cache's devices (``least_loaded``).
    Model contract ``"zoo"`` (the default, which ``from_config`` wires from
    the model zoo's paged surface):

    ``prefill_fn(tokens, extras)``
        ``(B, T)`` int32 device tensor, ``extras`` None or a dict of device
        tensors stacked by key from each request's ``submit(...,
        extras=...)`` (modality inputs: whisper frames) ``-> (k, v, state,
        last_logits)``
        with k/v ``(B, L, T', K, D)``, ``state`` a batch-leading nested
        dict of per-sequence residue or None, ``last_logits`` ``(B, V)``.
    ``decode_fn(k_pages, v_pages, state, tokens, positions, tables, lengths)``
        ``-> (k_pages, v_pages, state, logits)``: one ragged step over the
        pool's slabs (updated in place) and the batch's stacked state.
        On a CUDA device it is captured into a CUDA graph per warm row
        count, so it must not synchronise with the host.

    Model contract ``"legacy"``, two callables with no state and no
    sampling (``examples/torch_paged_serving.py``):

    ``prefill_fn(tokens)``
        ``(B, T)`` int32 device tensor ``-> (k, v, next)`` with k/v
        ``(B, L, T, K, D)`` and ``next`` ``(B,)`` integer tokens: the
        prompt's KV and its first token.
    ``decode_fn(k_pages, v_pages, tokens, positions, tables, lengths)``
        ``-> (k_pages, v_pages, next)``: one decode step over the pool's
        slabs, scattering each row's incoming token's k/v into its page and
        attending through the page table; ``next`` ``(B,)`` the tokens.  The
        engine expects the slabs back updated in place (the reference
        donates them): returning the same tensors costs nothing, and new
        tensors are copied into the pool's slabs (a ``copy_`` the step's
        CUDA graph captures).  As a zoo ``decode_fn`` it is captured into a
        CUDA graph per warm row count, so it must not synchronise with the
        host.

    ``decode_shapes`` seeds the decode lanes' warm row counts (see
    ``warm_rows``): a closed palette makes the set of captured step graphs
    deterministic, at the cost of padding off-palette batches.
    ``rebalance_every`` is the decode steps between a lane's rebalancing
    checks.
    """

    def __init__(self, kv: PagedKVCache, prefill_fn: Callable, decode_fn: Callable,
                 *, max_seq_len: int, scheduler=None,
                 prefill: "LanePolicy | None" = None,
                 decode: "LanePolicy | None" = None,
                 max_queue: int = 512, rebalance_every: int = 32,
                 decode_shapes: "Sequence[int] | None" = None,
                 contract: str = "zoo",
                 name: str = "paged"):
        if contract not in ("legacy", "zoo"):
            raise ValueError(f"contract must be 'legacy' or 'zoo', got {contract!r}")
        self.kv = kv
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.contract = contract
        # the decode lanes' step, in the zoo contract's form
        self._decode = decode_fn if contract == "zoo" else _legacy_decode(decode_fn)
        self.decode_shapes = (
            tuple(sorted({int(s) for s in decode_shapes if int(s) > 0}))
            if decode_shapes is not None else ())
        self.name = name
        if scheduler is None:
            from repro_torch.core.scheduler import Scheduler

            scheduler = Scheduler([p.device for p in kv.pools.values()], policy="least_loaded")
        from repro_torch.core.scheduler import locality_of_key

        fleet = scheduler.devices() if callable(getattr(scheduler, "devices", None)) else []
        if any(getattr(d, "is_remote_proxy", False) or locality_of_key(getattr(d, "key", None))
               for d in fleet):
            raise NotImplementedError(
                "PagedServeEngine: an engine serves the devices of one locality, as the "
                "reference's does; to decode on another locality, export_seq the prefilled "
                "sequence and invoke repro_torch.serving.paged:paged_worker_decode there over "
                "a parcel port")
        self.scheduler = scheduler
        # The device the prefill runs on (the first pool's), on a stream of
        # its own; each decode lane runs on a stream of its own too.
        self.device = next(iter(kv.pools.values())).device
        self._stream = torch.cuda.Stream(self.device.torch_device) if self.device.is_cuda else None
        self._next_rid = 0
        self.max_seq_len = int(max_seq_len)
        self.max_pages = kv.spec.pages_for(self.max_seq_len)
        self.max_queue = int(max_queue)
        self.rebalance_every = max(1, int(rebalance_every))
        self.prefill_policy = prefill if prefill is not None else LanePolicy(
            max_batch=8, max_delay_s=0.004,
            token_budget=_env_int("REPRO_PREFILL_TOKEN_BUDGET", 2048))
        self.decode_policy = decode if decode is not None else LanePolicy(
            max_batch=64,
            max_delay_s=float(os.environ.get("REPRO_DECODE_DEADLINE_S", 0.001)))

        self._cv = threading.Condition()
        self._queue: "list[_PagedRequest]" = []
        # Requests popped from the queue but not yet admitted/settled, so
        # drain() does not see an idle engine while a prefill is in flight.
        self._inflight = 0
        self._closed = False

        # One decode lane a device, created on first use.
        self._lane_lock = threading.Lock()
        self._lanes: "dict[str, _DecodeLane]" = {}

        # Metrics.
        self._m_lock = threading.Lock()
        self._spans = _Spans()
        self._batch_ids = itertools.count()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._prefill_batches = 0
        self._prefill_tokens = 0
        self._prefill_rows = 0
        self._decode_steps = 0
        self._decode_rows = 0
        self._decode_padded = 0
        self._decode_s = 0.0
        self._migrations = 0
        self._placed: Counter = Counter()  # sequences placed, by device key
        self._ttft: "list[float]" = []

        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name=f"paged:{name}:prefill", daemon=True)
        self._prefill_thread.start()

    # -- construction from the model zoo -------------------------------------

    @classmethod
    def from_config(cls, cfg, *, devices=None, params=None, seed: int = 0,
                    max_seq_len: "int | None" = None,
                    pool_pages: "int | None" = None,
                    pool_bytes: "int | None" = None, impl: str = "auto",
                    **kw) -> "PagedServeEngine":
        """Wire a ported family (``repro_torch.configs``) into a paged
        engine: one ``PageSpec`` from ``paged_spec``, the prefill and the
        decode step from ``paged_prefill``/``paged_decode_step`` with the
        params closed over.  ``params`` defaults to ``init`` drawn from a
        generator seeded with ``seed`` on the pool's device.  ``impl``
        goes to both: ``"ref"`` keeps attention (or the scan) on the plain
        path, prefill and decode."""
        from repro_torch.models.model import get_model, paged_surface

        spec_fn, prefill_fn, decode_fn = paged_surface(cfg)
        spec = spec_fn(cfg)
        kv = PagedKVCache(spec, devices=devices, pool_pages=pool_pages, pool_bytes=pool_bytes)
        if params is None:
            dev = next(iter(kv.pools.values())).device.torch_device
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            params = get_model(cfg).init(cfg, generator=gen, device=dev)
        if max_seq_len is None:
            max_seq_len = 16 * spec.page_size

        def pre(tokens, extras):
            return prefill_fn(cfg, params, tokens, extras, impl=impl)

        def dec(ks, vs, state, tokens, positions, tables, lengths):
            return decode_fn(cfg, params, ks, vs, state, tokens, positions, tables, lengths,
                             impl=impl)

        kw.setdefault("name", f"paged-{cfg.name}")
        return cls(kv, pre, dec, max_seq_len=int(max_seq_len), contract="zoo", **kw)

    def _on_stream(self):
        """The prefill lane's stream as the current stream."""
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               sampling: "SamplingParams | None" = None,
               request_id: "int | None" = None,
               extras: "dict | None" = None) -> Future:
        """Queue one request.  ``sampling`` selects the host-side sampler
        (None = greedy); ``request_id`` keys the sampling PRNG stream
        (default: submission order).  ``extras``: per-request modality
        inputs (whisper: ``{"frames": (S_enc, D)}``), host arrays, stacked
        by key over the prefill's group."""
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty prompt")
        total = tokens.size + int(max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({tokens.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})")
        promise: Promise = Promise(name=f"{self.name}:seq")
        with self._m_lock:
            rid = self._next_rid if request_id is None else int(request_id)
            self._next_rid += 1
        req = _PagedRequest(tokens, int(max_new_tokens), promise, _now(),
                            rid=rid, sampling=sampling, extras=extras)
        with self._cv:
            if self._closed:
                raise EngineClosed(f"engine {self.name!r} is closed")
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"engine {self.name!r} admission queue is full "
                    f"({self.max_queue}) — backpressure: shed or retry")
            self._queue.append(req)
            self._cv.notify_all()
        with self._m_lock:
            self._submitted += 1
        return promise.get_future()

    def reset_metrics(self) -> None:
        """Zero the counters, the TTFT list and the spans (resident pages
        are untouched), e.g. after a warm-up pass."""
        self._spans.clear()
        with self._m_lock:
            self._submitted = self._completed = self._failed = 0
            self._prefill_batches = self._prefill_tokens = self._prefill_rows = 0
            self._decode_steps = self._decode_rows = self._decode_padded = 0
            self._decode_s = 0.0
            self._migrations = 0
            self._placed.clear()
            for lane in self._lanes_now():
                lane.stats.clear()
                for c in lane.launches.values():
                    c.clear()
            for pool in self.kv.pools.values():
                with pool.lock:
                    pool.spills = pool.refetches = 0
            self._ttft.clear()

    def __enter__(self) -> "PagedServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._prefill_thread.join(timeout=60)
        for lane in self._lanes_now():
            lane.close()

    def drain(self) -> None:
        """Block until every submitted sequence has finished: nothing
        queued, nothing mid-prefill, nothing active on a decode lane."""
        while True:
            with self._cv:
                queued = len(self._queue) + self._inflight
            if not queued and not sum(lane.active_count() for lane in self._lanes_now()):
                return
            time.sleep(0.002)

    def _lanes_now(self) -> "list[_DecodeLane]":
        with self._lane_lock:
            return list(self._lanes.values())

    def _lane_for(self, device) -> "_DecodeLane":
        """``device``'s decode lane, started on first use."""
        with self._lane_lock:
            lane = self._lanes.get(device.key)
            if lane is None:
                lane = self._lanes[device.key] = _DecodeLane(self, device)
            return lane

    # -- prefill lane (throughput: token-budget batching) --------------------

    def _prefill_loop(self) -> None:
        pol = self.prefill_policy
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return
                head = self._queue[0]
                # `x if x is not None else d`, never `x or d`: an explicit
                # 0.0 deadline / 0 budget is a real policy (dispatch now).
                delay = pol.max_delay_s if pol.max_delay_s is not None else 0.004
                deadline = head.arrived + delay
                T = head.tokens.size
                budget = pol.token_budget if pol.token_budget is not None else 1 << 30
                budget_rows = max(1, budget // max(T, 1))
                cap = min(pol.max_batch if pol.max_batch is not None else 8, budget_rows)
                while (not self._closed and _now() < deadline
                       and sum(1 for r in self._queue if r.tokens.size == T) < cap):
                    self._cv.wait(timeout=max(deadline - _now(), 0.0005))
                group, kept = [], []
                for r in self._queue:
                    if r.tokens.size == T and len(group) < cap:
                        group.append(r)
                    else:
                        kept.append(r)
                self._queue[:] = kept
                self._inflight += len(group)
                taken = time.time_ns() if _recording() else None
            if taken is not None:
                for r in group:
                    self._spans.add("serve.queue", r.queued_ns, taken, rid=r.rid)
            if group:
                try:
                    self._run_prefill(group)
                except Exception as e:  # noqa: BLE001 - the lane must not die; the futures get it
                    for r in group:
                        if r.handed_off:
                            continue
                        self._finish(r, e)
                        self._prefill_done(r)

    def _run_prefill(self, group: "list[_PagedRequest]") -> None:
        dev = self.device.torch_device
        sched = self.scheduler
        spans = self._spans
        with spans.span("serve.prefill") as top, self._on_stream():
            if top is not None:
                top.attrs.update(batch=next(self._batch_ids), rows=len(group),
                                 tokens=int(group[0].tokens.size), rids=[r.rid for r in group])
            with self.kv.gate.shared():
                with spans.span("prefill.forward"):
                    tokens = _to_device(np.stack([r.tokens for r in group]), dev)  # equal T
                    if self.contract == "zoo":
                        k, v, state, logits = self.prefill_fn(tokens, _stack_extras(group, dev))
                    else:
                        k, v, nxt = self.prefill_fn(tokens)
                with spans.span("prefill.logits"):
                    if self.contract == "zoo":
                        logits = _host(logits)
                    else:
                        state, nxt = None, [int(t) for t in _host(nxt)]
            if self.contract == "zoo":
                # First token samples host-side at position 0 of each
                # request's own PRNG stream — batch composition cannot leak.
                with spans.span("prefill.sample"):
                    nxt = [sample_token(logits[i], r.sampling, r.rid, 0)
                           for i, r in enumerate(group)]
            done = _now()
            with self._m_lock:
                self._prefill_batches += 1
                self._prefill_tokens += tokens.numel()
                self._prefill_rows += len(group)
            need = self.kv.spec.pages_for(k.shape[2]) + 1
            with spans.span("prefill.page_in"):
                for i, req in enumerate(group):
                    pool = self._pool_with_room(sched.select(args=()), need)
                    try:
                        req.seq = self.kv.new_seq(pool.device)
                        # k[i]: (L, T', Kh, D) — the whole prompt pages in as one write.
                        self.kv.append(req.seq, k[i], v[i])
                    finally:
                        pool.admit(-1)
                    if state is not None:
                        req.seq.set_state(_tree_map(lambda t, i=i: t[i], state))
                    with self._m_lock:
                        self._placed[pool.device.key] += 1
                    req.out.append(nxt[i])
                    req.first_token_s = done - req.arrived
                    if req.max_new <= 1:
                        self._finish(req)
                    else:
                        self._lane_for(pool.device).admit(req)
                    self._prefill_done(req)

    def _pool_with_room(self, dev, need_pages: int) -> PagePool:
        """The chosen device's pool if it has room, else that pool after
        spilling its least-recently-used sequences, else the pool with the
        most free pages: admission fails only when no pool can hold the
        prompt.  The pool returned is held by ``PagePool.admit`` (the caller
        lets go once the sequence is paged in): its lane can neither refetch
        nor grow a sequence meanwhile, so it cannot take the pages a spill
        freed for the admission.

        ``spill_lru`` keeps every buffer of the device but the pool's own
        sequences, since no other buffer's bytes give the pool a page, and
        spilling repeats while the bytes a spill freed (a sequence's state
        among them) left the pool short of pages."""
        pool = self.kv.pools.get(dev.key)
        if pool is not None:
            pool.admit(+1)
            while pool.num_free < need_pages:
                with self.kv._seq_lock:
                    mine = {s.gid for s in self.kv._seqs.values() if s.pool is pool}
                keep = set(agas.registry.gids_on(dev.key, kind="buffer")) - mine
                need = (need_pages - pool.num_free) * self.kv.spec.page_bytes
                if not any([f.get() for f in self.scheduler.spill_lru(dev, need, keep=keep)]):
                    break  # nothing left to spill
            if pool.num_free >= need_pages:
                return pool
            pool.admit(-1)
        best = max(self.kv.pools.values(), key=lambda p: p.num_free)
        best.admit(+1)
        if best.num_free < need_pages:
            best.admit(-1)
            raise OutOfPages(f"no pool has {need_pages} free page(s); deepest is "
                             f"{best.device.key} with {best.num_free}")
        return best

    def _prefill_done(self, req: "_PagedRequest") -> None:
        """Prefill is done with this request (admitted or settled): mark it
        so a later batch failure cannot settle it twice, and release its
        in-flight slot for ``drain``."""
        req.handed_off = True
        with self._cv:
            self._inflight -= 1

    # -- completion ----------------------------------------------------------

    def _finish(self, req: "_PagedRequest", exc: "BaseException | None" = None) -> None:
        if req.seq is not None:
            self.kv.free_seq(req.seq)
            req.seq = None
        # An already-settled promise is absorbed, not raised: a lane thread
        # dying here would hang every other active sequence's future.
        if exc is not None:
            try:
                req.promise.set_exception(exc)
            except _cf.InvalidStateError:
                return
            with self._m_lock:
                self._failed += 1
            return
        try:
            req.promise.set_value(np.asarray(req.out, np.int32))
        except _cf.InvalidStateError:
            return
        with self._m_lock:
            self._completed += 1
            if req.first_token_s is not None:
                self._ttft.append(req.first_token_s)

    # -- metrics -------------------------------------------------------------

    @staticmethod
    def _pct(xs: "list[float]", q: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[int(q * (len(xs) - 1))]

    def metrics(self) -> dict:
        """Counters, TTFT percentiles and spans since the last
        ``reset_metrics``.  ``decode`` sums the lanes' graph counters
        (``decode_by_device`` has each lane's); ``kv`` has each pool's
        pages, spills and refetches; ``placed`` the sequences placed on
        each device and ``placements`` the scheduler's decisions; ``spans``
        the spans kept while a profiler recorded (``_Spans``; empty with
        none) and ``spans_dropped`` those past the buffer's bound."""
        lanes = self._lanes_now()
        with self._m_lock:
            rows = self._prefill_rows + self._decode_rows
            by_device = {lane.device.key: lane.graph_metrics() for lane in lanes}
            m = {
                "requests_submitted": self._submitted,
                "requests_completed": self._completed,
                "requests_failed": self._failed,
                "prefill_batches": self._prefill_batches,
                "prefill_tokens": self._prefill_tokens,
                "decode_steps": self._decode_steps,
                "decode_rows": self._decode_rows,
                "decode_s": self._decode_s,
                "rows": rows,
                "padded_rows": self._decode_padded,
                "padding_waste": (self._decode_padded / rows) if rows else 0.0,
                "ttft_p50_s": self._pct(self._ttft, 0.50),
                "ttft_p99_s": self._pct(self._ttft, 0.99),
                "migrations": self._migrations,
                "placed": dict(self._placed),
                "decode": _sum_lanes(by_device.values()),
                "decode_by_device": by_device,
            }
        m["spans"], m["spans_dropped"] = self._spans.snapshot()
        m["kv"] = self.kv.stats()
        m["spills"] = sum(p["spills"] for p in m["kv"].values())
        m["refetches"] = sum(p["refetches"] for p in m["kv"].values())
        m["placements"] = self.scheduler.stats()
        m["active_by_device"] = {lane.device.key: lane.active_count() for lane in lanes}
        m["active"] = sum(m["active_by_device"].values())
        return m

    def __repr__(self) -> str:
        return (f"PagedServeEngine({self.name}: {self._completed}/"
                f"{self._submitted} sequences)")


def _eager_step(decode_fn, pool: PagePool, W: int, tokens, lens, tbl, rows, spans: _Spans):
    """One eager step of ``decode_fn`` at ``W`` rows over ``pool``'s slabs
    on the current stream, its tokens, lengths and tables going to the
    device as one copy -> (host logits (W, V), stacked state or None)."""
    with spans.span("decode.launch") as sp:
        if sp is not None:
            sp.attrs["replayed"] = False
        step_in = _to_device(np.concatenate([tokens, lens, tbl.reshape(-1)]),
                             pool.device.torch_device)
        tok_d, lens_d, tbl_d = step_in[:W], step_in[W:2 * W], step_in[2 * W:].view(W, -1)
        state = None
        if rows[0] is not None:
            state = _tree_map(lambda *xs: torch.stack(xs), *rows)
        ks, vs = pool.arrays()
        _, _, state, logits = decode_fn(ks, vs, state, tok_d, lens_d, tbl_d, lens_d)
        pool.mark_written()
    with spans.span("decode.logits"):
        return _host(logits), state


def _host(out: "torch.Tensor") -> np.ndarray:
    """A step's output on the host: logits as f32, a legacy step's tokens
    as they are."""
    return (out.float() if out.is_floating_point() else out).cpu().numpy()


def _legacy_decode(decode_fn: Callable) -> Callable:
    """A legacy ``decode_fn`` as a zoo step: no state, its tokens in place
    of the logits, and slabs it returns as new tensors copied into the
    pool's (nothing to copy when it returns the ones it was given)."""

    def step(k_pages, v_pages, state, tokens, positions, tables, lengths):
        k2, v2, nxt = decode_fn(k_pages, v_pages, tokens, positions, tables, lengths)
        for pages, new in ((k_pages, k2), (v_pages, v2)):
            if new is not pages:
                pages.copy_(new)
        return k_pages, v_pages, None, nxt

    return step


_LANE_COUNTS = ("eager_steps", "replayed_steps", "graphs_captured", "capture_s", "stalls",
                "deferred_rows", "migrations_out")


def _sum_lanes(lanes) -> dict:
    """The decode counters of several lanes as one lane's: counts summed,
    warm counts united."""
    out = {"warm_counts": set(), **{k: 0 for k in _LANE_COUNTS},
           "captured_launches": Counter(), "replayed_launches": Counter()}
    for d in lanes:
        out["warm_counts"] |= set(d["warm_counts"])
        for k in _LANE_COUNTS:
            out[k] += d[k]
        for k in ("captured_launches", "replayed_launches"):
            out[k].update(d[k])
    out["warm_counts"] = sorted(out["warm_counts"])
    out["captured_launches"] = dict(out["captured_launches"])
    out["replayed_launches"] = dict(out["replayed_launches"])
    return out


class _DecodeLane:
    """One device's decode lane: continuous batched stepping at warm row
    counts, on a CUDA stream of its own.

    The lane thread owns the device's resident sequences.  Each iteration:
    fold in arrivals (deadline-bounded wait only when idle), take up to
    ``max_batch`` sequences (resident ones first), lock them in seq-id
    order, make spilled ones resident and grow tails by a page where
    needed (a sequence without pages waits for a later step), pad the
    batch to a warm row count (``warm_rows``; pad rows duplicate the last
    row — its scatter rewrites the same slot with the same value — and
    their outputs are discarded), wait on the sequences' events, run ONE
    step of ``decode_fn`` over the pool's slabs, sample on the host, record
    the step's event on each sequence, unlock, and retire finished
    sequences.  Mixed-length sequences share the step at their true
    lengths.  On a CUDA device the step at each warm count is a CUDA graph
    (``_StepGraphs``); on the CPU it runs eagerly, its tokens, lengths and
    tables going to the device as one copy a step."""

    def __init__(self, engine: PagedServeEngine, device):
        self.engine = engine
        self.device = device
        self.pool = engine.kv.pool_of(device)
        self._stream = torch.cuda.Stream(device.torch_device) if device.is_cuda else None
        self._steps = 0
        self._cv = threading.Condition()
        self._warm: "set[int]" = set(engine.decode_shapes)
        self._inbox: "list[_PagedRequest]" = []
        self._active: "list[_PagedRequest]" = []
        self._closed = False
        self._stalls = 0  # consecutive steps where nothing fit in the pool
        # Since the engine's last reset_metrics, under its _m_lock: the
        # _LANE_COUNTS (steps run eagerly and replayed, graphs captured and
        # the seconds captures took, deferred steps and rows, sequences
        # migrated away) and, by kernel package, the launches captured into
        # graphs and replayed from them.
        self.stats: Counter = Counter()
        self.launches = {"captured": Counter(), "replayed": Counter()}
        self._graphs = (_StepGraphs(engine._decode, engine.kv, self.pool, device, self._tally,
                                    engine._spans)
                        if device.is_cuda else None)
        self._thread = threading.Thread(
            target=self._loop, name=f"paged:{engine.name}:decode:{device.key}", daemon=True)
        self._thread.start()

    def _on_stream(self):
        """The lane's stream as the current stream."""
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    def admit(self, req: "_PagedRequest") -> None:
        with self._cv:
            self._inbox.append(req)
            self._cv.notify_all()

    def active_count(self) -> int:
        with self._cv:
            return len(self._inbox) + len(self._active)

    def graph_metrics(self) -> dict:
        """The decode counters (the caller holds the engine's _m_lock)."""
        return {"warm_counts": sorted(self._warm), **{k: self.stats[k] for k in _LANE_COUNTS},
                "captured_launches": dict(self.launches["captured"]),
                "replayed_launches": dict(self.launches["replayed"])}

    def _tally(self, counts: dict, launches: "tuple[str, dict] | None" = None) -> None:
        with self.engine._m_lock:
            self.stats.update(counts)
            if launches is not None:
                self.launches[launches[0]].update(launches[1])

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60)

    def _loop(self) -> None:
        eng = self.engine
        pol = eng.decode_policy
        while True:
            with self._cv:
                if not self._active and not self._inbox:
                    if self._closed:
                        return
                    self._cv.wait(timeout=0.05)
                    continue
                if not self._active and self._inbox:
                    # Idle lane: give the batch one deadline window to fill.
                    delay = pol.max_delay_s if pol.max_delay_s is not None else 0.001
                    deadline = _now() + delay
                    while not self._closed and _now() < deadline:
                        self._cv.wait(timeout=max(deadline - _now(), 0.0005))
                self._active.extend(self._inbox)
                self._inbox.clear()
                # Residents first (a stable sort keeps the round-robin
                # order): a spilled sequence rejoins once pages free up, and
                # ahead of resident work one unfittable sequence would stall
                # the lane.
                self._active.sort(key=lambda r: r.seq.spilled)
                cap = pol.max_batch if pol.max_batch is not None else 64
                batch = self._active[:cap]
            try:
                self._step(batch)
            except Exception as e:  # noqa: BLE001 - fail the batch (its futures get it), not the lane
                with self._cv:
                    for r in batch:
                        if r in self._active:
                            self._active.remove(r)
                for r in batch:
                    eng._finish(r, e)

    def _step(self, batch: "list[_PagedRequest]") -> None:
        """One decode step over ``batch``.  Every sequence's lock is held
        from ``ensure_resident`` to ``note_decoded`` (taken in seq-id
        order, as ``defrag`` takes them), so a racing spill or defrag can
        neither free nor renumber a page the step reads, and the step's
        event is recorded on each sequence before its lock goes.  A step
        graph the step left to capture is captured after the locks and the
        gate are released, holding the gate alone.  A step that ran carries
        its ``step``, real rows ``B``, row count ``W`` and the real rows'
        resident lengths ``lens`` on its ``serve.decode`` span; one that
        found no row ready, ``B`` 0."""
        spans = self.engine._spans
        t0 = _now()
        held = []
        with spans.span("serve.decode") as top, contextlib.ExitStack() as gate:
            try:
                with spans.span("decode.locks"):
                    for r in sorted(batch, key=lambda q: q.seq.seq_id):
                        r.seq._lock.acquire()
                        held.append(r.seq)
                    gate.enter_context(self.engine.kv.gate.shared())
                with spans.span("decode.prepare"):
                    prep = self._prepare(batch)
                if prep is None:
                    if top is not None:
                        top.attrs["B"] = 0
                    return
                ready, inputs = prep
                if top is not None:
                    top.attrs.update(step=self._steps, B=len(ready), W=inputs[0],
                                     lens=inputs[2][:len(ready)].tolist())
                with self._on_stream():
                    for r in ready:
                        r.seq._wait_ready()
                    run = self._graphs.step if self._graphs is not None else self._eager
                    logits, state = run(*inputs)
                    ev = _record(self.device.torch_device)
                for r in ready:
                    r.seq._ready = ev
                with spans.span("decode.sample"):
                    done = self._advance(ready, inputs[0], logits, state, t0)
            finally:
                gate.close()
                for s in held:
                    s._lock.release()
            if self._graphs is not None:
                with self._on_stream():
                    self._graphs.capture_pending()
            self._retire(done)
            charge = getattr(self.engine.scheduler, "charge", None)
            if callable(charge):
                # This step never passed a lane queue: the recency counter is
                # the only sign least_loaded has of its rows.
                charge(self.device, len(ready))
            self._steps += 1
            if self._steps % self.engine.rebalance_every == 0:
                self._maybe_rebalance([r for r in ready if r not in done])

    def _prepare(self, batch: "list[_PagedRequest]"):
        """Make spilled sequences resident and grow tails by a page where
        needed, and build the step's host inputs at a warm row count:
        ``(ready batch, (rows, tokens, lengths, tables, states))``.  A
        sequence without pages, or needing one while an admission makes
        room in the pool, waits for a later step (a deferred row); with
        none ready the lane sleeps briefly and returns None, and
        ``_MAX_DECODE_STALLS`` such steps in a row (not counting those an
        admission caused) fail the batch."""
        eng = self.engine
        kv = eng.kv
        ready = []
        with self._on_stream():
            for r in batch:
                try:
                    r.seq.ensure_resident()
                    kv.ensure_slot(r.seq)
                except OutOfPages:
                    continue
                ready.append(r)
        if len(ready) < len(batch):
            self._tally({"deferred_rows": len(batch) - len(ready)})
        if not ready:
            self._stalls += 0 if self.pool.admitting else 1
            self._tally({"stalls": 1})
            if self._stalls > _MAX_DECODE_STALLS:
                raise OutOfPages(
                    f"{self.device.key}: {len(batch)} sequence(s) stalled "
                    f"{self._stalls} consecutive steps waiting for pages — "
                    "the pool cannot hold this working set")
            time.sleep(0.002)  # wait for a finisher or a sibling to free pages
            return None
        self._stalls = 0
        B = len(ready)
        W = warm_rows(B, self._warm)
        self._warm.add(W)
        tbl, lens = kv.table([r.seq for r in ready], eng.max_pages)
        tokens = np.asarray([r.out[-1] for r in ready], np.int32)
        rows = [r.seq.state for r in ready]
        pad = W - B
        if pad:
            tbl = np.concatenate([tbl, np.repeat(tbl[-1:], pad, axis=0)])
            lens = np.concatenate([lens, np.repeat(lens[-1:], pad)])
            tokens = np.concatenate([tokens, np.repeat(tokens[-1:], pad)])
            rows = rows + [rows[-1]] * pad
        return ready, (W, tokens, lens, tbl, rows)

    def _eager(self, W: int, tokens, lens, tbl, rows):
        """One eager step of ``decode_fn`` at ``W`` rows on the current
        stream -> (host logits (W, V), stacked state or None)."""
        self._tally({"eager_steps": 1})
        return _eager_step(self.engine._decode, self.pool, W, tokens, lens, tbl, rows,
                           self.engine._spans)

    def _advance(self, batch: "list[_PagedRequest]", W: int, logits, state,
                 t0: float) -> "list[_PagedRequest]":
        """Sample each real row's token, hand back its state and count the
        step; returns the finished requests, which leave the active set
        here and are settled by ``_retire``."""
        eng = self.engine
        kv = eng.kv
        B = len(batch)
        done: "list[_PagedRequest]" = []
        for i, r in enumerate(batch):
            # Position = tokens already emitted (prefill's token was
            # position 0): identity-keyed, batch-independent.  A legacy
            # step's output is the token itself.
            nxt = (int(logits[i]) if eng.contract == "legacy"
                   else sample_token(logits[i], r.sampling, r.rid, len(r.out)))
            if state is not None:
                r.seq.set_state(_tree_map(lambda t, i=i: t[i], state))
            kv.note_decoded(r.seq)
            r.out.append(nxt)
            if len(r.out) >= r.max_new:
                done.append(r)
        step_s = _now() - t0
        with eng._m_lock:
            eng._decode_steps += 1
            eng._decode_rows += B
            eng._decode_padded += W - B
            eng._decode_s += step_s
        with self._cv:
            for r in done:
                self._active.remove(r)
            # Rotate survivors to the tail so an active set larger than
            # max_batch round-robins instead of starving the overflow.
            if len(self._active) > B - len(done):
                for r in batch:
                    if r in self._active:
                        self._active.remove(r)
                        self._active.append(r)
        return done

    def _retire(self, done: "list[_PagedRequest]") -> None:
        for r in done:
            self.engine._finish(r)

    def _maybe_rebalance(self, batch: "list[_PagedRequest]") -> None:
        """Ask the scheduler whether this lane's sequences still belong
        here: ``select_batch`` over their ``SeqPages`` keeps them home under
        affinity (their bytes are here) unless memory pressure vetoes the
        device; a different answer migrates the coldest sequence (one
        coalesced page move) to that device's lane.  Only under page
        pressure (under 20% of the pool free): otherwise a pure load policy
        scoring this lane's own charge would move sequences back and forth
        for no memory relief."""
        if not batch or self.pool.num_free * 5 >= self.pool.num_pages:
            return
        eng = self.engine
        try:
            dev = eng.scheduler.select_batch([[r.seq] for r in batch])
        except RuntimeError:  # advisory: never fail decode over a placement
            return
        if dev.key == self.device.key or dev.key not in eng.kv.pools:
            return
        victim = min(batch, key=lambda r: r.seq._last_use)
        try:
            with self._on_stream():
                eng.kv.migrate(victim.seq, dev)
        except OutOfPages:
            return
        with self._cv:
            self._active.remove(victim)
        with eng._m_lock:
            eng._migrations += 1
        self._tally({"migrations_out": 1})
        eng._lane_for(dev).admit(victim)


class _CountGraph:
    """One warm row count's step graph and its static tensors: a pinned
    staging tensor and its device twin (tokens, lengths, tables), the
    stacked state, the graph and its outputs, and the launches its capture
    recorded."""

    def __init__(self, W: int, max_pages: int, device: "torch.device"):
        self.W = W
        n = 2 * W + W * max_pages
        self.stage = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.stage_np = self.stage.numpy()
        self.static = torch.empty(n, dtype=torch.int32, device=device)
        self.tok, self.lens = self.static[:W], self.static[W:2 * W]
        self.tbl = self.static[2 * W:].view(W, max_pages)
        self.copied: "torch.cuda.Event | None" = None  # end of the last H2D from stage
        self.state = None
        self.graph: "torch.cuda.CUDAGraph | None" = None
        self.outs = None
        self.recorded: "dict[str, int]" = {}

    def load(self, tokens, lens, tbl, rows):
        """Stage this step's inputs into the static tensors on the current
        stream; returns the static state (None without one)."""
        if self.copied is not None:
            self.copied.synchronize()  # the last copy out of stage has ended
        W = self.W
        self.stage_np[:W] = tokens
        self.stage_np[W:2 * W] = lens
        self.stage_np[2 * W:] = tbl.reshape(-1)
        self.static.copy_(self.stage, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        if rows[0] is None:
            return None
        if self.state is None:
            self.state = _tree_map(lambda *xs: torch.stack(xs), *rows)
        else:
            _tree_map(lambda dst, *xs: torch.stack(xs, out=dst), self.state, *rows)
        return self.state


class _StepGraphs:
    """A decode lane's CUDA graphs (a ``_DecodeLane``'s, or a worker's at
    one row): one per warm row count, all in one memory pool, each captured
    against the pool's slabs by address.  ``decode_fn`` is the engine's
    seven-argument step, ``kv`` the cache whose gate a capture holds,
    ``pool`` the device's page pool, ``tally(counts, launches)`` the
    owner's counter and ``spans`` the owner's ``_Spans`` (a step's
    ``decode.launch`` and ``decode.logits``, a capture's ``decode.capture``).

    The first step at a count runs ``decode_fn`` eagerly on the count's
    static tensors and uses its result; after the step (``capture_pending``)
    it is captured on a side stream (capture executes nothing) joined to
    the lane's stream by events, in ``thread_local`` mode, holding the
    cache's gate alone (``_CaptureGate``): the prefill lane, the other
    lanes and page moves wait meanwhile.  Every later step at that count
    replays the graph on the lane's stream.  If a slab's tensor was rebound since the
    captures, every graph is dropped and recaptured: a stale graph never
    replays.  Outputs are read out of the graph's memory (logits to the
    host, the state cloned) before the next step.  The graphs of all counts
    share the pool; replays are serial on one stream and each one's
    outputs are consumed before the next, so no replay sees another's
    outputs overwritten."""

    def __init__(self, decode_fn: Callable, kv: PagedKVCache, pool: PagePool, device,
                 tally: Callable, spans: _Spans):
        self.decode_fn, self.kv, self.pool, self.tally = decode_fn, kv, pool, tally
        self.spans = spans
        self._dev = device.torch_device
        self._counts: "dict[int, _CountGraph]" = {}
        self._pool = None
        self._slabs: "tuple[int, int] | None" = None
        self._pending = None  # (count graph, slabs, state) to capture after the step
        # High priority: the port's other streams come from PyTorch's
        # normal-priority pool, so no other thread's work lands on it.
        self._cap = torch.cuda.Stream(self._dev, priority=-1)

    def step(self, W: int, tokens, lens, tbl, rows):
        """One step at ``W`` rows on the lane's stream -> (host logits
        (W, V), the stacked state cloned out of the graph, or None)."""
        with self.spans.span("decode.launch") as sp:
            ks, vs = self.pool.arrays()
            if self._slabs is not None and self._slabs != (ks.data_ptr(), vs.data_ptr()):
                self._counts, self._pool, self._slabs = {}, None, None  # stale: drop every graph
            c = self._counts.get(W)
            if c is None:
                c = self._counts[W] = _CountGraph(W, tbl.shape[1], self._dev)
            if sp is not None:
                sp.attrs["replayed"] = c.graph is not None
            state = c.load(tokens, lens, tbl, rows)
            if c.graph is None:
                self.tally({"eager_steps": 1})
                out = self.decode_fn(ks, vs, state, c.tok, c.lens, c.tbl, c.lens)
            else:
                c.graph.replay()
                self.tally({"replayed_steps": 1}, ("replayed", c.recorded))
                out = c.outs
            self.pool.mark_written()
        _, _, out_state, logits = out
        with self.spans.span("decode.logits"):
            host = _host(logits)
        if out_state is not None:
            out_state = _tree_map(lambda t: t.clone(), out_state)
        if c.graph is None:
            self._pending = (c, ks, vs, state)
        return host, out_state

    def capture_pending(self) -> None:
        """Capture the graph the last eager step left pending, on the
        current (the lane's) stream, holding the cache's gate alone."""
        if self._pending is None:
            return
        c, ks, vs, state = self._pending
        self._pending = None
        with self.spans.span("decode.capture") as sp, self.kv.gate.exclusive():
            if sp is not None:
                sp.attrs["W"] = c.W
            self._capture(c, ks, vs, state)

    def _capture(self, c: _CountGraph, ks, vs, state) -> None:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self._dev)
        self._cap.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._cap), tally_launches(self._cap) as recorded:
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = self.decode_fn(ks, vs, state, c.tok, c.lens, c.tbl, c.lens)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; the first error is the one to raise
                raise
            graph.capture_end()
        cur.wait_stream(self._cap)
        c.graph, c.outs, c.recorded = graph, out, dict(recorded)
        self._slabs = (ks.data_ptr(), vs.data_ptr())
        self.tally({"graphs_captured": 1, "capture_s": time.perf_counter() - t0},
                   ("captured", c.recorded))


# ---------------------------------------------------------------------------
# cross-locality disaggregation: parcel "invoke" actions
# ---------------------------------------------------------------------------
#
# Prefill on one locality, decode on another: the prefill side runs
# ``paged_prefill`` + ``PagedKVCache.append`` locally, then ships
# ``export_seq``'s payload (pages as ONE coalesced gather, plus length
# and resident state) as a parcel,
#
#     port.call(lid, "invoke", {
#         "fn": "repro_torch.serving.paged:paged_worker_decode",
#         "payload": {...}})
#
# where the big arrays take the shm lane.  The decode side re-derives the
# weights from the config name and seed (bit-identical params: nothing but
# pages crosses the wire), imports the sequence into its own pool and
# resumes decoding from the shipped table.  Sampling stays keyed by (seed,
# request_id, position), so the shipped continuation is the tokens a
# single-locality engine decodes.

_WORKER_LOCK = threading.Lock()
_WORKERS: "dict[str, _WorkerDecoder]" = {}


class _WorkerDecoder:
    """One locality's decode of shipped sequences for one ``name``: the
    config, seeded params, a single-device ``PagedKVCache`` and a one-row
    step of the family's ``paged_decode_step``.  On a CUDA device the step
    runs on a stream of its own and is a CUDA graph (a decode lane's
    ``_StepGraphs`` at one row: the first step eager, then captured, every
    later step replayed), launching the paged-attention kernel; on the CPU
    it runs eagerly.  ``lock`` serialises the decodes of one context."""

    def __init__(self, cfg, params, kv: PagedKVCache, device, decode_fn):
        def dec(ks, vs, state, tokens, positions, tables, lengths):
            return decode_fn(cfg, params, ks, vs, state, tokens, positions, tables, lengths)

        self.cfg = cfg
        self.kv = kv
        self.device = device
        self.pool = kv.pool_of(device)
        self.decode_fn = dec
        self.lock = threading.Lock()
        self.stats: Counter = Counter()
        self.launches = {"captured": Counter(), "replayed": Counter()}
        self.step_s: "list[float]" = []
        self.spans = _Spans(cap=0)  # profiler ranges only: nothing reads a worker's spans
        self._stream = torch.cuda.Stream(device.torch_device) if device.is_cuda else None
        self._graphs = (_StepGraphs(dec, kv, self.pool, device, self._tally, self.spans)
                        if device.is_cuda else None)

    def _tally(self, counts: dict, launches: "tuple[str, dict] | None" = None) -> None:
        self.stats.update(counts)
        if launches is not None:
            self.launches[launches[0]].update(launches[1])

    def step(self, seq: SeqPages, token: int, max_pages: int):
        """One decode step of ``seq`` -> its host logits (V,)."""
        kv = self.kv
        t0 = time.perf_counter()
        with seq._lock, kv.gate.shared():
            kv.ensure_slot(seq)
            tbl, lens = kv.table([seq], max_pages)
            tokens = np.asarray([token], np.int32)
            ctx = torch.cuda.stream(self._stream) if self._stream is not None \
                else contextlib.nullcontext()
            with ctx:
                seq._wait_ready()
                if self._graphs is not None:
                    logits, state = self._graphs.step(1, tokens, lens, tbl, [seq.state])
                else:
                    self._tally({"eager_steps": 1})
                    logits, state = _eager_step(self.decode_fn, self.pool, 1, tokens,
                                                lens, tbl, [seq.state], self.spans)
                seq._ready = _record(self.device.torch_device)
            if state is not None:
                seq.set_state(_tree_map(lambda t: t[0], state))
            kv.note_decoded(seq)
        if self._graphs is not None:
            with torch.cuda.stream(self._stream):
                self._graphs.capture_pending()
        self.step_s.append(time.perf_counter() - t0)
        return logits[0]


def _worker_ctx(payload: dict) -> _WorkerDecoder:
    """The decode-side context for one shipped-page stream, built once per
    ``name`` on this locality and cached: the registry's config (smoked
    unless ``smoke`` is false), params from the family's ``init`` drawn
    from a generator seeded with ``seed`` on the device, as
    ``PagedServeEngine.from_config(seed=...)`` draws them, and a cache of
    ``pool_pages`` pages on device ``device_index`` of the ``device``
    platform ("cuda" unless the payload asks for "cpu")."""
    name = payload["name"]
    with _WORKER_LOCK:
        ctx = _WORKERS.get(name)
        if ctx is not None:
            return ctx
        from repro_torch.configs import get_config, smoke
        from repro_torch.core.device import get_all_devices
        from repro_torch.models.model import get_model, paged_surface

        cfg = get_config(payload["config"])
        if payload.get("smoke", True):
            cfg = smoke(cfg)
        spec_fn, _, decode_fn = paged_surface(cfg)
        platform = payload.get("device", "cuda")
        devs = list(get_all_devices(platform=platform).get())
        if not devs:
            raise RuntimeError(f"paged_worker_decode: this locality has no {platform} device")
        dev = devs[int(payload.get("device_index", 0)) % len(devs)]
        gen = torch.Generator(device=dev.torch_device).manual_seed(int(payload.get("seed", 0)))
        params = get_model(cfg).init(cfg, generator=gen, device=dev.torch_device)
        kv = PagedKVCache(spec_fn(cfg), devices=[dev], pool_pages=payload.get("pool_pages"))
        ctx = _WORKERS[name] = _WorkerDecoder(cfg, params, kv, dev, decode_fn)
        return ctx


def paged_worker_decode(payload: dict) -> np.ndarray:
    """Parcel ``invoke`` target: resume decoding a shipped sequence.

    payload keys: ``name`` (worker cache key), ``config`` (registry
    name), ``smoke``, ``seed``, ``device_index``, ``pool_pages``,
    ``seq`` (an ``export_seq`` payload), ``first_token`` (the
    prefill-sampled token), ``max_new``, ``max_pages`` (table width: the
    prefill side's, so the attention geometry is identical),
    ``sampling`` (SamplingParams fields or None) and ``request_id``; and,
    the port's own, ``device`` (the platform, "cuda" unless it says
    "cpu").  Returns all generated tokens (np.int32), first token
    included."""
    ctx = _worker_ctx(payload)
    sp = payload.get("sampling")
    if sp is not None and not isinstance(sp, SamplingParams):
        sp = SamplingParams(**sp)
    rid = int(payload.get("request_id", 0))
    max_pages = int(payload["max_pages"])
    out = [int(payload["first_token"])]
    with ctx.lock:
        seq = ctx.kv.import_seq(ctx.device, payload["seq"])
        try:
            for _ in range(int(payload["max_new"]) - 1):
                logits = ctx.step(seq, out[-1], max_pages)
                out.append(sample_token(logits, sp, rid, len(out)))
        finally:
            ctx.kv.free_seq(seq)
    return np.asarray(out, np.int32)


def paged_worker_stats(payload=None) -> dict:
    """Per cached context (or the one ``payload`` names): the one-row step
    seconds, the steps run eagerly and replayed, the graphs captured and
    the kernel launches captured into and replayed from them."""
    name = (payload or {}).get("name")
    with _WORKER_LOCK:
        ctxs = {n: c for n, c in _WORKERS.items() if name is None or n == name}
    return {n: {"step_s": list(c.step_s), **{k: c.stats[k] for k in _LANE_COUNTS},
                "captured_launches": dict(c.launches["captured"]),
                "replayed_launches": dict(c.launches["replayed"])}
            for n, c in ctxs.items()}


def paged_worker_reset(payload=None) -> bool:
    """Drop cached worker contexts (``payload`` may name one)."""
    with _WORKER_LOCK:
        name = (payload or {}).get("name")
        if name is None:
            _WORKERS.clear()
        else:
            _WORKERS.pop(name, None)
    return True


@on_runtime_reset
def _on_runtime_reset() -> None:
    """The contexts' devices belong to the runtime torn down: drop them."""
    paged_worker_reset()
