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
(``hpx::find_all_localities``); every device of this package is local.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch.core import agas
from repro_torch.core.executor import LaneDispatcher, QueueLoad, WorkQueue, get_runtime
from repro_torch.core.futures import Future
from repro_torch.core.stream import Stream

__all__ = ["Device", "Locality", "get_all_devices", "get_all_localities"]

# A CPU device has no compute capability; (1, 0) keeps the Listing-1
# filter meaningful for the CPU devices the tests ask for explicitly.
_CPU_CAPABILITY = (1, 0)

_ITEM10 = "ROADMAP.md Queue 1 item 10"


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
        return f"Locality(process={self.process_index}, local, {len(self.devices)} device(s))"


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
    (``hpx::find_all_localities``); future of the list.  Every device of
    this package is local, so the list holds one locality.  ``cluster``
    (remote localities over parcels) is refused until the parcelport is
    ported."""
    if cluster is not None:
        return Future.failed(NotImplementedError(
            f"localities across a cluster need the parcelport, not ported yet ({_ITEM10})"))

    def _group() -> "list[Locality]":
        devs = get_all_devices(major, minor, platform).get()
        return [Locality(0, devs)] if devs else []

    return get_runtime().async_(_group)
