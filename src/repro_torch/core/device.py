"""Logical device abstraction (paper §4, Fig. 2 ``device``).

A ``Device`` wraps one ``torch.device`` and exposes HPXCL's surface:

  * ``create_buffer``  — async allocation (``cudaMalloc`` analogue)
  * ``create_program`` — async program creation (NVRTC analogue: the
    program's CUDA libraries are compiled and loaded on the compile queue)
  * per-device work lanes: the default stream's lane (``ops_queue``:
    transfers and launch submission order) and the ``compile`` queue, kept
    apart so that building a kernel overlaps data transfers as in Listing 2
  * ``create_stream`` / ``default_stream`` — N ordered streams per device,
    each a host lane plus a ``torch.cuda.Stream``
  * ``synchronize``    — drain ALL the device's lanes and the compile
    queue, then every CUDA stream
  * ``capture``        — a graph-capture region (``repro_torch.core.graph``);
    ``_replay_lane(chain)`` is the lane of a captured plan's chain

``get_all_devices(major, minor)`` mirrors the paper's Listing 1: it returns
a *future* of the CUDA devices whose compute capability is at least
(major, minor).  Without a GPU it returns no devices; CPU devices appear
only when the caller asks for them (``platform="cpu"``).

Logical devices: ``REPRO_LOGICAL_DEVICES=N`` (default 1), read at each
discovery, splits every physical device into N ``Device``s, the port's
counterpart of the reference tests' ``--xla_force_host_platform_device_count``.
Logical device 0 of a card is the device discovery returns by default
(key ``cuda:0``, the card's default CUDA stream); logical device j > 0 has
the key ``cuda:0.j`` and its own ``torch.cuda.Stream`` as its default
stream.
Each has its own lanes, compile queue, AGAS records and memory limit, so a
scheduler places over them as over separate devices, while their kernels
share the card.

Scheduler surface: ``Device.load()`` and ``Device.resident_bytes()`` are
the signals the placement policies read, and ``Device.memory_limit`` (seeded
from ``REPRO_SPILL_BYTES``, 0 = unlimited) the threshold of the memory veto
and LRU spill.  ``get_all_localities()`` groups devices by owning process
(``hpx::find_all_localities``); ``get_all_localities(cluster=port)``
appends the remote localities a parcel port reaches.

Remote proxies (DESIGN.md §10): ``RemoteDevice``/``RemoteBuffer`` are the
parcel-backed twins of ``Device``/``Buffer`` — same async surface, but
``create_buffer`` / ``enqueue_write`` / ``enqueue_read`` / ``free`` (and
launches, through ``RemoteProgram``) travel as parcels to the owning
locality and resolve the caller's futures from reply parcels.  A proxy's
``ops_queue`` is a real local ``WorkQueue``: it orders parcel submission
per remote device and feeds the same ``load()`` signal the placement
policies read for local devices.  Each stream of a remote device is its
own ordered parcel channel.  Values bound for a remote device are staged
in host memory (``RemoteDevice.torch_device`` is the CPU).
"""
from __future__ import annotations

import os
import threading
import weakref

import numpy as np
import torch

from repro_torch.core import agas
from repro_torch.core.executor import LaneDispatcher, QueueLoad, WorkQueue, get_runtime
from repro_torch.core.futures import Future
from repro_torch.core.stream import Stream

__all__ = ["Device", "Locality", "RemoteDevice", "RemoteBuffer", "get_all_devices",
           "get_all_localities"]

# A CPU device has no compute capability; (1, 0) keeps the Listing-1
# filter meaningful for the CPU devices the tests ask for explicitly.
_CPU_CAPABILITY = (1, 0)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _default_memory_limit() -> int:
    """Per-device resident-bytes threshold for memory-aware placement.  0
    means unlimited: the veto and the LRU spill are off.  The environment
    seeds every device; the attribute is plain and per device."""
    return _env_int("REPRO_SPILL_BYTES", 0)


def _device_key(torch_device: "torch.device", logical: int = 0) -> str:
    base = f"{torch_device.type}:{torch_device.index or 0}"
    return base if logical == 0 else f"{base}.{logical}"


class Device:
    """Location-transparent handle to one accelerator (or, on request, the
    CPU); ``logical`` > 0 makes it logical device ``logical`` of that
    physical device."""

    def __init__(self, torch_device: "torch.device", logical: int = 0):
        self.torch_device = torch.device(torch_device)
        if self.torch_device.type == "cuda" and self.torch_device.index is None:
            self.torch_device = torch.device("cuda", 0)
        self.logical = int(logical)
        self.key = _device_key(self.torch_device, self.logical)
        rt = get_runtime()
        # Streams multiplex onto one lane dispatcher per device; compilation
        # keeps its own queue so building a kernel overlaps transfers.
        self._dispatcher: LaneDispatcher = rt.dispatcher(f"ops:{self.key}")
        self._streams: "list[Stream]" = []
        self._replay_streams: "dict[int, Stream]" = {}
        self._stream_lock = threading.Lock()
        # Logical device 0 keeps the card's default stream; every other
        # logical device of the card gets a stream of its own, so two
        # logical devices never serialise on one CUDA stream.
        default_cs = None
        if self.is_cuda:
            default_cs = (torch.cuda.default_stream(self.torch_device) if self.logical == 0
                          else torch.cuda.Stream(self.torch_device))
        self._default_stream = self._new_stream("default", default_cs)
        # The default stream's lane IS the ops queue.
        self.ops_queue = self._default_stream.lane
        self.compile_queue: WorkQueue = rt.queue(f"compile:{self.key}")
        # Memory-aware placement threshold; 0 = unlimited.
        self.memory_limit: int = _default_memory_limit()
        # Buffers spilled from this device and refetched to it.
        self.spills = 0
        self.refetches = 0
        self._count_lock = threading.Lock()
        self.gid: agas.GID = agas.registry.register(
            self, agas.Placement(self.key, 0), kind="device"
        )

    # -- identity ----------------------------------------------------------

    @property
    def platform(self) -> str:
        return self.torch_device.type

    @property
    def is_cuda(self) -> bool:
        return self.torch_device.type == "cuda"

    @property
    def process_index(self) -> int:
        return 0

    @property
    def is_local(self) -> bool:
        return True

    def capability(self) -> "tuple[int, int]":
        """The real compute capability — (9, 0) on an H100."""
        if self.is_cuda:
            return tuple(torch.cuda.get_device_capability(self.torch_device))
        return _CPU_CAPABILITY

    # -- streams ------------------------------------------------------------

    @property
    def default_stream(self) -> Stream:
        """Stream 0: the lane stream-less ops order through (``ops_queue``),
        on the device's default CUDA stream."""
        return self._default_stream

    def _new_stream(self, label: str, cuda_stream) -> Stream:
        with self._stream_lock:
            idx = len(self._streams)
            # Lane key is index-prefixed: dispatcher.lane() memoizes by
            # name, and two streams must NEVER share a lane.
            lane = self._dispatcher.lane(f"{idx}.{label}")
            s = Stream(self, lane, name=f"{self.key}/{label}", cuda_stream=cuda_stream)
            self._streams.append(s)
            return s

    def create_stream(self, name: "str | None" = None) -> Stream:
        """A new ordered stream on this device (``cudaStreamCreate``): a
        host lane plus, on CUDA, a fresh ``torch.cuda.Stream``.  Work on
        distinct streams runs concurrently; work within one is FIFO."""
        cs = torch.cuda.Stream(self.torch_device) if self.is_cuda else None
        label = name if name is not None else f"s{len(self._streams)}"
        return self._new_stream(label, cs)

    def streams(self) -> "list[Stream]":
        with self._stream_lock:
            return list(self._streams)

    def _replay_lane(self, chain: int):
        """Lane of captured-graph chain ``chain`` (DESIGN.md §11): chain 0
        rides the default stream; higher chains get dedicated, memoized
        replay streams, so the chains of any plan map to lanes without
        growing a lane per ``GraphExec``."""
        if chain == 0:
            return self.ops_queue
        with self._stream_lock:
            s = self._replay_streams.get(chain)
            if s is None:
                # 'replay.' keys cannot collide with _new_stream's
                # '{idx}.{label}' keys (idx is always an integer).
                lane = self._dispatcher.lane(f"replay.{chain}")
                cs = torch.cuda.Stream(self.torch_device) if self.is_cuda else None
                s = Stream(self, lane, name=f"{self.key}/replay{chain}", cuda_stream=cs)
                self._streams.append(s)
                self._replay_streams[chain] = s
        return s.lane

    # -- scheduler signals --------------------------------------------------

    def load(self) -> QueueLoad:
        """Whole-device backlog snapshot: per-lane depths summed."""
        return self._dispatcher.load()

    def resident_bytes(self) -> int:
        """AGAS-registered bytes currently placed here."""
        return agas.registry.resident_bytes(self.key)

    def _count(self, name: str) -> None:
        """Add one to the ``spills`` or ``refetches`` counter."""
        with self._count_lock:
            setattr(self, name, getattr(self, name) + 1)

    # -- factory surface (all async, returning futures) ---------------------

    def create_buffer(self, shape, dtype=np.float32, fill=None) -> "Future":
        """Allocate a device buffer (async; ``cudaMalloc`` analogue).
        ``shape`` is an int (1-D length in elements) or a tuple; ``dtype``
        a numpy or torch dtype."""
        from repro_torch.core.buffer import Buffer

        return self.ops_queue.submit(Buffer._allocate, self, shape, dtype, fill)

    def create_buffer_from(self, data) -> "Future":
        """Allocate + write in one async op (host ``np.ndarray`` or tensor);
        the future resolves once the copy has completed on the device."""
        from repro_torch.core.buffer import Buffer, _settle

        return _settle(self.ops_queue.submit(Buffer._from_host, self, data), lambda b: b,
                       name="create_buffer_from")

    def create_program(self, kernels, name: str = "program") -> "Future":
        """Create a program from ``{kernel_name: callable}`` (async)."""
        from repro_torch.core.program import Program

        return self.compile_queue.submit(lambda: Program(self, kernels, name=name))

    def create_program_with_file(self, path: str) -> "Future":
        """Load kernels from a python file defining ``KERNELS`` (percolation:
        source shipped to and built at the device — NVRTC analogue)."""
        from repro_torch.core.program import Program

        return self.compile_queue.submit(lambda: Program.from_file(self, path))

    # -- graph capture (CUDA Graphs) -----------------------------------------

    def capture(self, name: str = "captured"):
        """Begin a graph-capture region on this thread (DESIGN.md §8):

            with dev.capture("step") as g:
                buf.enqueue_write(0, host)
                prog.run([buf], "k", out=[out])
                r = out.enqueue_read()
            exe = g.instantiate()          # warm-up, then a CUDA graph a segment
            result = exe.replay().get()    # result[r] is the np.ndarray
        """
        from repro_torch.core.graph import capture as _capture

        return _capture(name)

    # -- synchronization ----------------------------------------------------

    def synchronize(self) -> None:
        """Drain every lane and the compile queue, then every CUDA stream
        of this device (``cudaDeviceSynchronize``)."""
        self._dispatcher.drain()
        self.compile_queue.drain()
        for s in self.streams():
            if s.cuda_stream is not None:
                s.cuda_stream.synchronize()

    def __repr__(self) -> str:
        return f"Device({self.key}, local, gid={self.gid})"


class Locality:
    """One process's worth of devices (the HPX *locality* analogue)."""

    def __init__(self, process_index: int, devices: "list[Device]"):
        self.process_index = process_index
        self.devices = list(devices)

    @property
    def is_local(self) -> bool:
        return self.process_index == 0

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __repr__(self) -> str:
        where = "local" if self.is_local else "remote"
        return f"Locality(process={self.process_index}, {where}, {len(self.devices)} device(s))"


# ---------------------------------------------------------------------------
# remote proxies (parcel-backed; DESIGN.md §10)
# ---------------------------------------------------------------------------


def _release_remote(port, locality_id: int, gid: int, proxied: bool) -> None:
    """GC finalizer for RemoteBuffer: retire the local proxy record (the
    resident-bytes accounting must not outlive the handle) and queue a
    best-effort free parcel.  A collection can run on a thread that holds
    the AGAS registry's lock or the port's: so the record is retired
    (queued, no lock) and the parcel only queued (``defer_free``)."""
    if proxied:
        agas.registry.retire(gid)
    try:
        port.defer_free(locality_id, gid)
    except Exception:  # noqa: BLE001
        pass


class RemoteDevice:
    """Parcel-backed handle to a device owned by another locality.

    Duck-types ``Device`` everywhere the runtime reads it: ``key``,
    ``ops_queue``/``compile_queue`` (real local queues — parcel submission
    order per remote device, and the scheduler's ``load()`` signal),
    ``load()``, ``resident_bytes()``, ``capability()``, plus ``alive()``
    (heartbeat-fed; a dead locality is excluded from placement).
    ``torch_device`` is the host, where values bound for this device are
    staged before they are shipped in a parcel.
    """

    is_remote_proxy = True
    is_cuda = False
    logical = 0

    def __init__(self, port, locality_id: int, remote_key: str, platform: str = "cpu",
                 capability: "tuple[int, int]" = (1, 0)):
        self._port = port
        self.locality_id = locality_id
        self.remote_key = remote_key
        self.key = f"L{locality_id}/{remote_key}"
        self._platform = platform
        self._capability = tuple(capability)
        self.torch_device = torch.device("cpu")  # staging anchor, not the executor
        rt = get_runtime()
        self.ops_queue: WorkQueue = rt.queue(f"parcel-ops:{self.key}")
        self.compile_queue: WorkQueue = rt.queue(f"parcel-compile:{self.key}")
        # Streams on a remote device are ordered parcel *channels*: each
        # stream gets its own submission queue, so parcels of one stream
        # stay strictly ordered while different streams' parcels may be
        # in flight concurrently.
        self._stream_lock = threading.Lock()
        self._streams: "list[Stream]" = [Stream(self, self.ops_queue, name=f"{self.key}/default")]
        self.memory_limit: int = _default_memory_limit()
        self.spills = 0
        self.refetches = 0
        self.gid: agas.GID = agas.registry.register(
            self, agas.Placement(self.key, locality_id), kind="device"
        )

    # -- identity ----------------------------------------------------------

    @property
    def platform(self) -> str:
        return self._platform

    @property
    def process_index(self) -> int:
        return self.locality_id

    @property
    def is_local(self) -> bool:
        return False

    def capability(self) -> "tuple[int, int]":
        return self._capability

    # -- streams (ordered parcel channels) -----------------------------------

    @property
    def default_stream(self) -> Stream:
        return self._streams[0]

    def create_stream(self, name: "str | None" = None) -> Stream:
        """A new ordered parcel channel to this remote device: stream verbs
        become parcels submitted through the channel's own queue, so each
        stream's parcels keep submission order while channels overlap."""
        rt = get_runtime()
        with self._stream_lock:
            idx = len(self._streams)
            label = name if name is not None else f"s{idx}"
            # Index-prefixed queue key: rt.queue() memoizes by name, and
            # two channels must never share a queue.
            chan = rt.queue(f"parcel-ops:{self.key}:{idx}.{label}")
            s = Stream(self, chan, name=f"{self.key}/{label}")
            self._streams.append(s)
            return s

    def streams(self) -> "list[Stream]":
        with self._stream_lock:
            return list(self._streams)

    def _replay_lane(self, chain: int):
        # A remote segment replays as ONE parcel; every chain rides the
        # default channel, so run_segment parcels keep their order.
        return self.ops_queue

    # -- scheduler signals ---------------------------------------------------

    def load(self) -> QueueLoad:
        """Backlog summed across every parcel channel of this device."""
        loads = [s.lane.load() for s in self.streams()]
        return QueueLoad(
            depth=sum(l.depth for l in loads),
            inflight=sum(l.inflight for l in loads),
            busy_for=max((l.busy_for for l in loads), default=0.0),
            busy_time=sum(l.busy_time for l in loads),
            submitted=sum(l.submitted for l in loads),
            completed=sum(l.completed for l in loads),
            busy_ewma=sum(l.busy_ewma for l in loads),
        )

    def resident_bytes(self) -> int:
        return agas.registry.resident_bytes(self.key)

    def alive(self) -> bool:
        """Heartbeat verdict for the owning locality (scheduler exclusion)."""
        return self._port.alive(self.locality_id)

    # -- parcel plumbing -----------------------------------------------------

    def _call(self, action: str, lane=None, **payload) -> "Future":
        """Send one action parcel, ordered through this device's default
        channel — or, when ``lane`` is given, through that stream's own
        parcel channel.

        On a non-pipelined port the channel worker blocks on each reply.
        On a pipelined port the channel task only *stages and flushes* the
        parcel — the reply resolves the returned future asynchronously, and
        the channel ships the next parcel at once (same-channel order still
        holds: staging order is wire order is the worker's execution
        order).  A drained lane then proves dispatch, not remote
        completion: completion fences go through ``synchronize()`` (a
        ``barrier`` parcel) or the returned future itself."""
        payload.setdefault("device", self.remote_key)
        port, loc = self._port, self.locality_id
        if not port.alive(loc):
            return Future.failed(RuntimeError(
                f"parcel {action!r} to locality L{loc} failed fast: the locality is dead "
                "(missed heartbeat or worker exit) and is excluded from placement"
            ))
        q = self.ops_queue if lane is None else lane
        if getattr(port, "pipelined", False):
            from repro_torch.core.futures import Promise, forward_failure

            promise: "Promise" = Promise(name=f"parcel:{action}:L{loc}")

            def _ship():
                port.stage(loc, action, payload, promise)
                port.flush(loc)

            forward_failure(q.submit(_ship), promise)
            return promise.get_future()
        return q.submit(lambda: port.call_sync(loc, action, payload))

    # -- factory surface -----------------------------------------------------

    def create_buffer(self, shape, dtype=np.float32, fill=None) -> "Future":
        """Allocate a buffer on the remote locality (async; the
        ``create_buffer`` action parcel)."""
        from repro_torch.core.parcel import wire_dtype

        shape_p = list(shape) if isinstance(shape, (tuple, list)) else int(shape)
        fut = self._call("create_buffer", shape=shape_p, dtype=wire_dtype(dtype), fill=fill)
        return fut.then(lambda rep: RemoteBuffer(self, rep["gid"], rep["shape"], rep["dtype"]),
                        executor="inline")

    def create_buffer_from(self, data) -> "Future":
        fut = self._call("create_buffer_from", data=_host_payload(data))
        return fut.then(lambda rep: RemoteBuffer(self, rep["gid"], rep["shape"], rep["dtype"]),
                        executor="inline")

    def create_program(self, kernels, name: str = "program") -> "Future":
        """Create a program on the remote locality.  ``kernels`` are
        *names* (str or list of str) resolved by the remote's kernel
        registry, or a ``{name: callable}`` dict whose callables stay
        local as shape-inference shadows (percolation by reference)."""
        from repro_torch.core.program import RemoteProgram

        return self.compile_queue.submit(lambda: RemoteProgram(self, kernels, name=name))

    # -- graph capture -------------------------------------------------------

    def capture(self, name: str = "captured"):
        from repro_torch.core.graph import capture as _capture

        return _capture(name)

    # -- synchronization -----------------------------------------------------

    def synchronize(self) -> None:
        """Drain EVERY parcel channel of this device plus the compile
        queue; on a pipelined port a ``barrier`` parcel (executed on the
        worker's action pool after everything shipped before it) closes
        the gap to remote completion."""
        for s in self.streams():
            s.lane.drain()
        self.compile_queue.drain()
        if getattr(self._port, "pipelined", False) and self._port.alive(self.locality_id):
            self._call("barrier").get()

    def __repr__(self) -> str:
        state = "alive" if self.alive() else "DEAD"
        return f"RemoteDevice({self.key}, {state}, gid={self.gid})"


def _host_payload(data):
    """``data`` as a parcel payload: a tensor on the host (``np.ndarray``,
    or a CPU tensor for bfloat16), anything else through ``np.asarray``."""
    if isinstance(data, torch.Tensor):
        from repro_torch.core.parcel import host_value

        return host_value(data)
    return np.asarray(data)


class RemoteBuffer:
    """Location-transparent handle to a buffer owned by another locality.

    The remote-minted GID is proxied into the local AGAS registry (with
    ``nbytes``), so placement policies score remote-resident bytes exactly
    like local ones.  Transfers are parcels: ``enqueue_write`` ships host
    data out, ``enqueue_read`` brings it back, ``copy_to`` chains the two.
    ``dtype`` is a torch dtype, as a ``Buffer``'s.
    """

    is_remote_proxy = True
    is_remote_buffer = True

    def __init__(self, device: RemoteDevice, gid: int, shape, dtype):
        from repro_torch.core.parcel import torch_dtype_of

        self.device = device
        self.gid = gid
        self.shape = tuple(shape)
        self.dtype = dtype if isinstance(dtype, torch.dtype) else torch_dtype_of(
            dtype if isinstance(dtype, str) else np.dtype(dtype).str)
        self._freed = False
        self._free_future: "Future | None" = None
        self._proxied = agas.registry.register_proxy(
            self, gid, agas.Placement(device.key, device.locality_id),
            kind="buffer", nbytes=self.nbytes,
        )
        self._finalizer = weakref.finalize(
            self, _release_remote, device._port, device.locality_id, gid, self._proxied
        )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    # -- async transfer surface ----------------------------------------------

    def enqueue_write(self, offset: int, data, count: "int | None" = None,
                      stream=None) -> "Future":
        from repro_torch.core.graph import current_graph

        if current_graph() is not None:
            raise NotImplementedError(
                "graph capture writes to local buffers only; stage remote "
                "transfers outside the capture region (remote buffers may be "
                "read as extern inputs)"
            )
        lane = None if stream is None else stream._lane_for(self.device)
        fut = self.device._call("enqueue_write", lane=lane, gid=self.gid, offset=offset,
                                data=_host_payload(data), count=count)
        if stream is not None:
            # Pipelined ports resolve the reply AFTER the lane task ends —
            # note it so record()/synchronize() mean remote completion.
            stream._note_completion(fut)
        return fut

    def enqueue_read(self, offset: int = 0, count: "int | None" = None,
                     stream=None) -> "Future":
        from repro_torch.core.graph import current_graph

        g = current_graph()
        if g is not None:
            return g.read(self, offset=offset, count=count)
        lane = None if stream is None else stream._lane_for(self.device)
        fut = self.device._call("enqueue_read", lane=lane, gid=self.gid,
                                offset=offset, count=count)
        if stream is not None:
            stream._note_completion(fut)
        return fut

    def enqueue_read_sync(self, offset: int = 0, count: "int | None" = None, stream=None):
        from repro_torch.core.graph import current_graph

        if current_graph() is not None:
            raise RuntimeError(
                "enqueue_read_sync inside a graph-capture region: the value "
                "does not exist until replay. Use enqueue_read()."
            )
        return self.enqueue_read(offset, count, stream=stream).get()

    def _read_now(self):
        """Synchronous read bypassing the proxy queue — for callers already
        running ON this device's ops queue (graph extern reads), where an
        ``enqueue_read`` would deadlock behind the calling task."""
        return self.device._port.call_sync(
            self.device.locality_id,
            "enqueue_read",
            {"device": self.device.remote_key, "gid": self.gid, "offset": 0, "count": None},
        )

    def copy_to(self, target_device) -> "Future":
        """Percolation across localities: one read parcel here, one write
        on the target — future of the *new* buffer on ``target_device``."""
        if target_device is self.device:
            return Future.ready(self)
        pool = get_runtime().pool
        return self.enqueue_read().then(
            lambda host: target_device.create_buffer_from(host).get(),
            executor=pool,
            name=f"copy:gid{self.gid}",
        )

    # -- lifetime --------------------------------------------------------------

    def free(self) -> "Future":
        """Release the remote storage (idempotent; future of None).

        The free parcel is gated on a barrier across ALL of the device's
        parcel channels: channels are mutually unordered, so a free sent
        straight down the default channel could execute on the owning
        locality before writes/launches still in flight on a stream
        channel (the same all-lanes rule as the local ``Buffer.free``)."""
        if self._free_future is None:
            self._freed = True
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
            if self._proxied:
                agas.registry.unregister(self.gid)
            dev = self.device
            others = [s.lane for s in dev.streams() if s.lane is not dev.ops_queue]
            if not others:
                self._free_future = dev._call("free", gid=self.gid)
            else:
                from repro_torch.core.futures import when_all

                barrier = when_all([ch.submit(lambda: None) for ch in others])
                self._free_future = barrier.then(
                    lambda _: dev._call("free", gid=self.gid).get(),
                    executor=get_runtime().pool,
                    name=f"free:gid{self.gid}",
                )
        return self._free_future

    # -- kernel-facing view ----------------------------------------------------

    def array(self):
        raise RuntimeError(
            f"RemoteBuffer gid={self.gid} lives on locality "
            f"L{self.device.locality_id}; its value is not addressable here — "
            "use enqueue_read() (or launch through a RemoteProgram on that locality)"
        )

    def __repr__(self) -> str:
        return f"RemoteBuffer(gid={self.gid}, {self.dtype}{list(self.shape)} @ {self.device.key})"


_device_cache: "dict[str, Device]" = {}
_cache_lock = threading.Lock()


def _wrap(torch_device: "torch.device", logical: int = 0) -> Device:
    key = _device_key(torch_device, logical)
    with _cache_lock:
        dev = _device_cache.get(key)
        if dev is None:
            dev = _device_cache[key] = Device(torch_device, logical)
        return dev


def logical_keys(torch_device: "torch.device") -> "list[str]":
    """Keys of the discovered logical devices of ``torch_device``'s card
    (one while the card is not split)."""
    base = _device_key(torch.device(torch_device))
    with _cache_lock:
        keys = [k for k in _device_cache if k == base or k.startswith(base + ".")]
    return keys or [base]


def _on_runtime_reset() -> None:
    """Drop cached devices whose queues died with the old runtime."""
    with _cache_lock:
        devices = list(_device_cache.values())
        _device_cache.clear()
    for dev in devices:
        agas.registry.unregister(dev.gid)


def get_all_devices(major: int = 0, minor: int = 0, platform: str = "cuda") -> "Future[list[Device]]":
    """Discover every device of ``platform`` with capability >= (major,
    minor). Returns a *future* of the list — call ``.get()`` (Listing 1).

    ``platform="cuda"`` (the default) lists the CUDA devices, and none
    when CUDA is unavailable; it never substitutes the CPU.
    ``platform="cpu"`` returns the one CPU device.  Under
    ``REPRO_LOGICAL_DEVICES=N`` each physical device is listed as N
    logical devices, its logical device 0 first."""
    if platform not in ("cuda", "cpu"):
        return Future.failed(ValueError(f"unknown platform {platform!r}; use 'cuda' or 'cpu'"))

    def _discover() -> "list[Device]":
        if platform == "cpu":
            found = [torch.device("cpu")]
        elif torch.cuda.is_available():
            found = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            found = []
        n = max(1, _env_int("REPRO_LOGICAL_DEVICES", 1))
        devs = [_wrap(d, j) for d in found for j in range(n)]
        return [d for d in devs if d.capability() >= (major, minor)]

    return get_runtime().async_(_discover)


def get_all_localities(major: int = 0, minor: int = 0, platform: str = "cuda",
                       cluster=None) -> "Future[list[Locality]]":
    """Group capability-filtered devices by owning process
    (``hpx::find_all_localities``); future of the list, this process's
    locality first.  With ``cluster`` (a parcel port), the port's remote
    localities are appended — the cluster-wide discovery surface."""

    def _group() -> "list[Locality]":
        devs = get_all_devices(major, minor, platform).get()
        locs = [Locality(0, devs)] if devs else []
        if cluster is not None:
            for loc in cluster.localities():
                rdevs = [d for d in loc if d.capability() >= (major, minor)]
                if rdevs:
                    locs.append(Locality(loc.process_index, rdevs))
        return locs

    return get_runtime().async_(_group)
