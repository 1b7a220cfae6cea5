"""Parcel transport & remote actions — the HPX parcelport on PyTorch
(``src/repro/core/parcel.py``, DESIGN.md §10).

HPX moves work between localities as *parcels*: a serialized action (the
function to run), its arguments, and a continuation that resolves the
caller's future when the reply arrives.  This module is that layer for
the port, closing the paper's "any (local or remote) GPU device" claim:
every runtime verb — ``create_buffer``, ``enqueue_write``, ``launch`` (by
registered-kernel name), ``enqueue_read``, ``free`` — has a parcel
encoding, and reply parcels resolve the sender's ``Future``s.

Three pieces:

* **Codec** — ``dumps``/``loads``: the reference's self-describing binary
  format, byte for byte, for every value it encodes (None/bool/int/float/
  complex/str/bytes, lists, tuples, dicts, numpy arrays and scalars,
  exceptions).  A ``torch.Tensor`` of a dtype numpy has is encoded as its
  numpy array under the same ``a``/``A`` tags (a CUDA tensor is copied to
  the host first, after its device has been synchronised), so it decodes
  as a numpy array.  ``torch.bfloat16`` has no numpy dtype: it travels
  under its own tag ``B`` as its ``uint16`` bits and decodes to a CPU
  bfloat16 tensor.  Deliberately *not* pickle: the wire admits no code.

* **Transports** — ``LoopbackParcelport`` runs N simulated localities in
  this process (every request still round-trips the codec);
  ``LocalClusterParcelport`` spawns N worker *processes*, each owning a
  real remote locality: its own CUDA context on the card, its own
  ``Runtime`` and lanes, its own AGAS registry minting locality-scoped
  GIDs.  Both take ``platform`` ("cuda" unless the caller asks for "cpu"),
  which each locality's ``discover`` lists; a locality that finds no
  device of that platform fails its start, it never takes the CPU instead.

* **Actions** — ``ActionServer`` executes decoded parcels against the
  owning process's devices through the ordinary ``Device``/``Buffer``/
  ``Program`` API.  Arrays that arrive go onto the device in one H2D copy
  on the device's lane; results leave as host arrays once their work has
  completed.  Kernels percolate *by name*: ``register_kernel`` entries,
  the ``repro_torch.kernels`` registry (on a CUDA device the name
  ``stencil`` reaches the op that launches the hand-written kernel), or
  an importable ``"module:attr"``.

Ordering guarantees (the contract the stream engine extends across
localities):

* **Parcel-channel FIFO** — parcels submitted through one channel (one
  ``RemoteDevice`` stream, including its default ``ops_queue`` channel)
  execute on the owning locality strictly in submission order.  On a
  pipelined ``LocalClusterParcelport`` (the default) the channel *stages*
  each parcel and ships the backlog in one hop (``flush``); the worker
  executes actions on a single pool thread in arrival order.  Large array
  payloads (>= ``REPRO_PARCEL_SHM_MIN`` bytes) cross through POSIX shared
  memory when ``REPRO_PARCEL_SHM`` permits; the blob then carries only
  the segment name, dtype and shape.  A segment is made only when
  ``/dev/shm`` has room for it: a write past its free space would kill
  the sender with SIGBUS, so such an array is written inline instead
  (``lane_counts()["shm_refused"]`` counts them).
* **Cross-channel: none** — synchronization between channels is explicit
  (an ``Event`` recorded on one stream, waited on by the other).
* **Replies resolve futures exactly once** — a dead locality fails its
  pending parcels fast instead of leaving futures forever pending.

Fault model: each cluster worker is watched by a ``fault.monitor.
Heartbeat``; replies tick it, a monitor thread pings it, and a missed
deadline (or a dead process) marks the locality dead — its queued parcels
fail fast and the scheduler excludes its devices (``RemoteDevice.alive``).
The worker answers pings on its receive loop while its pool thread runs
actions, so a long action (a capture, a training shard) does not look
like a death.
"""
from __future__ import annotations

import collections
import importlib
import itertools
import os
import queue as _queue
import struct
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "Parcel",
    "Parcelport",
    "LoopbackParcelport",
    "LocalClusterParcelport",
    "ActionServer",
    "RemoteError",
    "dumps",
    "loads",
    "encode_parcel",
    "decode_parcel",
    "register_kernel",
    "resolve_kernel",
    "lane_counts",
    "reset_lane_counts",
]


class RemoteError(RuntimeError):
    """A failure that crossed a locality boundary and could not be
    reconstructed as its original exception type."""


# ---------------------------------------------------------------------------
# codec: payload values <-> bytes (no pickle, no code on the wire)
# ---------------------------------------------------------------------------

_Q = struct.Struct("<Q")
_q = struct.Struct("<q")
_d = struct.Struct("<d")

# -- shared-memory array lane (same-host localities) -------------------------
#
# Array payloads at/above _SHM_MIN bytes travel OUT-OF-BAND through a
# POSIX shared-memory segment: the wire carries only a control header
# (segment name + dtype + shape).  Protocol: the SENDER creates and fills
# the segment and unregisters it from its own resource_tracker (the tracker
# would otherwise unlink it at sender exit, racing the receiver); the
# RECEIVER copies the payload out and unlinks.  Each side remembers the
# names it created in a ``_ShmTracker`` whose ``purge()`` unlinks whatever
# a dead receiver left behind.  ``REPRO_PARCEL_SHM=off`` forces everything
# inline; ``REPRO_PARCEL_SHM_MIN`` tunes the threshold (bytes).

_SHM_MODE = os.environ.get("REPRO_PARCEL_SHM", "auto").lower()
_SHM_MIN = int(os.environ.get("REPRO_PARCEL_SHM_MIN", str(512 << 10)))
_SHM_DIR = "/dev/shm"
_shm_state: "dict[str, Any]" = {"ok": None}

# Arrays encoded by this process, by lane: "shm" (out of band), "inline"
# (on the wire), and "shm_refused" (at or above the threshold with a lane
# open, but written inline because /dev/shm had no room for them).
_LANE_KEYS = ("shm_arrays", "shm_bytes", "inline_arrays", "inline_bytes", "shm_refused",
              "shm_refused_bytes")
_lanes = dict.fromkeys(_LANE_KEYS, 0)
_lanes_lock = threading.Lock()


def lane_counts(_payload=None) -> "dict[str, int]":
    """Arrays (and their bytes) this process encoded, by lane.  (The
    ignored argument lets a parcel ``invoke`` read a worker's counts.)"""
    with _lanes_lock:
        return dict(_lanes)


def reset_lane_counts(_payload=None) -> None:
    with _lanes_lock:
        for k in _LANE_KEYS:
            _lanes[k] = 0


def _count_lane(lane: str, nbytes: int) -> None:
    with _lanes_lock:
        _lanes[lane + "_arrays" if lane != "shm_refused" else lane] += 1
        _lanes[lane + "_bytes"] += nbytes


def _shm_untrack(seg) -> None:
    """Drop a segment from THIS process's resource_tracker ledger (the
    other side of the transfer owns the unlink)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:  # noqa: BLE001 - tracker bookkeeping is best-effort
        pass


def shm_available() -> bool:
    """Can this process create shared-memory segments (and is the lane
    enabled)?  Probed once; ``REPRO_PARCEL_SHM=off`` always answers False."""
    if _SHM_MODE == "off":
        return False
    if _shm_state["ok"] is None:
        try:
            from multiprocessing import shared_memory

            seg = shared_memory.SharedMemory(create=True, size=16)
            seg.close()
            seg.unlink()
            _shm_state["ok"] = True
        except Exception:  # noqa: BLE001 - no /dev/shm, sandboxed, etc.
            _shm_state["ok"] = False
    return bool(_shm_state["ok"])


def _shm_room(nbytes: int) -> bool:
    """Does ``/dev/shm`` have ``nbytes`` free?  A segment is sparse until it
    is written: filling one past the free space raises SIGBUS in the writer,
    so the lane is only taken when the payload fits.  Without a ``/dev/shm``
    to ask, the answer is yes (the segment's creation then decides)."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return True
    return nbytes <= st.f_bavail * st.f_frsize


def _shm_export(arr: np.ndarray) -> "str | None":
    """Copy ``arr`` into a fresh segment; returns its name (or None to
    fall back to inline encoding)."""
    if not _shm_room(arr.nbytes):
        _count_lane("shm_refused", arr.nbytes)
        return None
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    except Exception:  # noqa: BLE001 - creation failed: inline fallback
        return None
    try:
        dst = np.frombuffer(seg.buf, dtype=arr.dtype, count=arr.size).reshape(arr.shape)
        np.copyto(dst, arr)
        del dst
        name = seg.name
        _shm_untrack(seg)
        seg.close()
        return name
    except Exception:  # noqa: BLE001
        try:
            seg.close()
            seg.unlink()
        except Exception:  # noqa: BLE001
            pass
        return None


def _shm_import(name: str, descr: str, shape) -> np.ndarray:
    """Receiver half: attach, copy out, unlink (consuming the segment)."""
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        raise RemoteError(
            f"shared-memory parcel segment {name!r} vanished before it was "
            "consumed (sender torn down mid-flight?)"
        ) from None
    try:
        dt = np.dtype(descr)
        count = 1
        for d in shape:
            count *= int(d)
        arr = np.frombuffer(seg.buf, dtype=dt, count=count).reshape(shape).copy()
    finally:
        try:
            seg.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            seg.unlink()  # also unregisters from this process's tracker
        except FileNotFoundError:
            pass
    return arr


class _ShmTracker:
    """Names of segments this process created that are still (possibly)
    unconsumed.  ``sweep`` drops names the receiver has already unlinked;
    ``purge`` unlinks the rest (receiver died / port shut down)."""

    __slots__ = ("names", "lock")

    def __init__(self):
        self.names: "list[str]" = []
        self.lock = threading.Lock()

    def add(self, names) -> None:
        with self.lock:
            self.names.extend(names)
            if len(self.names) > 64:
                self._sweep_locked()

    def sweep(self) -> None:
        with self.lock:
            self._sweep_locked()

    def _sweep_locked(self) -> None:
        from multiprocessing import shared_memory

        keep = []
        for nm in self.names:
            try:
                seg = shared_memory.SharedMemory(name=nm)
            except Exception:  # noqa: BLE001 - gone: consumed by the receiver
                continue
            _shm_untrack(seg)
            seg.close()
            keep.append(nm)
        self.names = keep

    def purge(self) -> None:
        """Unlink every still-existing tracked segment (terminal cleanup)."""
        from multiprocessing import shared_memory

        with self.lock:
            names, self.names = self.names, []
        for nm in names:
            try:
                seg = shared_memory.SharedMemory(name=nm)
            except Exception:  # noqa: BLE001 - already consumed
                continue
            try:
                seg.close()
                seg.unlink()
            except Exception:  # noqa: BLE001
                pass


def _put_len(out: bytearray, n: int) -> None:
    out += _Q.pack(n)


def _put_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _put_len(out, len(b))
    out += b


def host_value(t: "torch.Tensor"):
    """``t`` on the host: a numpy array for every dtype numpy has, a CPU
    tensor for bfloat16.  A CUDA tensor's device is synchronised first,
    then it is copied (explicitly: numpy cannot read device memory)."""
    t = t.detach()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
        t = t.cpu()
    t = t.resolve_conj().resolve_neg()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _enc(obj: Any, out: bytearray, sink: "list | None" = None) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif type(obj) is int:
        if -(2**63) <= obj < 2**63:
            out += b"i"
            out += _q.pack(obj)
        else:  # arbitrary precision via decimal string
            out += b"I"
            _put_str(out, str(obj))
    elif type(obj) is float:
        out += b"f"
        out += _d.pack(obj)
    elif type(obj) is complex:
        out += b"c"
        out += _d.pack(obj.real) + _d.pack(obj.imag)
    elif type(obj) is str:
        out += b"s"
        _put_str(out, obj)
    elif type(obj) is bytes:
        out += b"b"
        _put_len(out, len(obj))
        out += obj
    elif isinstance(obj, np.generic):  # numpy scalar: dtype-preserving
        out += b"y"
        _put_str(out, obj.dtype.str)
        raw = obj.tobytes()
        _put_len(out, len(raw))
        out += raw
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object-dtype arrays are not parcel-encodable")
        arr = np.ascontiguousarray(obj)
        if sink is not None and arr.nbytes >= _SHM_MIN:
            # Out-of-band lane: payload bytes via shared memory, only the
            # control header on the wire (falls back inline on failure).
            name = _shm_export(arr)
            if name is not None:
                _count_lane("shm", arr.nbytes)
                sink.append(name)
                out += b"A"
                _put_str(out, name)
                _put_str(out, arr.dtype.str)
                _enc(tuple(int(d) for d in obj.shape), out)
                return
        _count_lane("inline", arr.nbytes)
        out += b"a"
        _put_str(out, arr.dtype.str)
        # shape from the ORIGINAL: ascontiguousarray promotes 0-d to (1,)
        # (same bytes, wrong rank) — a 0-d array must round-trip as 0-d.
        _enc(tuple(int(d) for d in obj.shape), out)
        raw = arr.tobytes()
        _put_len(out, len(raw))
        out += raw
    elif isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            # No numpy dtype: the uint16 bits, inline, under their own tag.
            t = host_value(obj).contiguous()
            raw = t.view(torch.int16).numpy().tobytes()
            _count_lane("inline", len(raw))
            out += b"B"
            _enc(tuple(int(d) for d in obj.shape), out)
            _put_len(out, len(raw))
            out += raw
            return
        try:
            arr = host_value(obj)
        except TypeError:  # a dtype numpy lacks (float8, ...)
            raise ValueError(f"a {obj.dtype} tensor is not parcel-encodable") from None
        _enc(arr, out, sink)
    elif isinstance(obj, (list, tuple)):
        out += b"l" if type(obj) is list else b"t"
        _put_len(out, len(obj))
        for v in obj:
            _enc(v, out, sink)
    elif isinstance(obj, dict):
        out += b"d"
        _put_len(out, len(obj))
        for k, v in obj.items():
            _enc(k, out, sink)
            _enc(v, out, sink)
    elif isinstance(obj, BaseException):
        out += b"e"
        cls = type(obj)
        _put_str(out, cls.__module__ or "builtins")
        _put_str(out, cls.__qualname__)
        args = []
        for a in obj.args:  # best effort: unencodable args degrade to repr
            try:
                probe = bytearray()
                _enc(a, probe)
                args.append(a)
            except (ValueError, TypeError):
                args.append(repr(a))
        _enc(args, out)  # exception args stay inline: no shm for error paths
        _put_str(out, str(obj))
    else:
        # Last chance: things that quack like arrays (memoryview, ...).
        try:
            arr = np.asarray(obj)
        except Exception:  # noqa: BLE001
            raise ValueError(f"{type(obj).__name__} is not parcel-encodable") from None
        if arr.dtype.hasobject:
            raise ValueError(f"{type(obj).__name__} is not parcel-encodable")
        _enc(arr, out, sink)


def dumps(obj: Any, shm_sink: "list | None" = None) -> bytes:
    """Serialize a payload value to bytes (see module docstring).

    ``shm_sink``: a list enables the shared-memory lane — arrays of at
    least ``REPRO_PARCEL_SHM_MIN`` bytes travel out-of-band and the names
    of the segments created are appended to the list (the caller tracks
    them for crash cleanup; the receiver unlinks on decode)."""
    out = bytearray()
    _enc(obj, out, shm_sink)
    return bytes(out)


def _get_len(buf: bytes, pos: int) -> "tuple[int, int]":
    return _Q.unpack_from(buf, pos)[0], pos + 8


def _get_str(buf: bytes, pos: int) -> "tuple[str, int]":
    n, pos = _get_len(buf, pos)
    return buf[pos : pos + n].decode("utf-8"), pos + n


def _rebuild_exception(module: str, qualname: str, args: list, text: str) -> BaseException:
    try:
        cls: Any = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls(*args)
    except Exception:  # noqa: BLE001 - fall through to the generic carrier
        pass
    return RemoteError(f"{qualname}: {text}")


def _dec(buf: bytes, pos: int) -> "tuple[Any, int]":
    tag = buf[pos : pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        return _q.unpack_from(buf, pos)[0], pos + 8
    if tag == b"I":
        s, pos = _get_str(buf, pos)
        return int(s), pos
    if tag == b"f":
        return _d.unpack_from(buf, pos)[0], pos + 8
    if tag == b"c":
        re = _d.unpack_from(buf, pos)[0]
        im = _d.unpack_from(buf, pos + 8)[0]
        return complex(re, im), pos + 16
    if tag == b"s":
        return _get_str(buf, pos)
    if tag == b"b":
        n, pos = _get_len(buf, pos)
        return buf[pos : pos + n], pos + n
    if tag == b"y":
        descr, pos = _get_str(buf, pos)
        n, pos = _get_len(buf, pos)
        return np.frombuffer(buf[pos : pos + n], dtype=np.dtype(descr))[0], pos + n
    if tag == b"a":
        descr, pos = _get_str(buf, pos)
        shape, pos = _dec(buf, pos)
        n, pos = _get_len(buf, pos)
        arr = np.frombuffer(buf[pos : pos + n], dtype=np.dtype(descr)).reshape(shape)
        return arr.copy(), pos + n  # writable, detached from the wire buffer
    if tag == b"A":  # out-of-band array: payload in a shared-memory segment
        name, pos = _get_str(buf, pos)
        descr, pos = _get_str(buf, pos)
        shape, pos = _dec(buf, pos)
        return _shm_import(name, descr, shape), pos
    if tag == b"B":  # bfloat16 tensor: its uint16 bits
        shape, pos = _dec(buf, pos)
        n, pos = _get_len(buf, pos)
        bits = np.frombuffer(buf[pos : pos + n], dtype="<i2").copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape), pos + n
    if tag in (b"l", b"t"):
        n, pos = _get_len(buf, pos)
        items = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            items.append(v)
        return (items if tag == b"l" else tuple(items)), pos
    if tag == b"d":
        n, pos = _get_len(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    if tag == b"e":
        module, pos = _get_str(buf, pos)
        qualname, pos = _get_str(buf, pos)
        args, pos = _dec(buf, pos)
        text, pos = _get_str(buf, pos)
        return _rebuild_exception(module, qualname, list(args), text), pos
    raise ValueError(f"corrupt parcel: unknown tag {tag!r} at offset {pos - 1}")


def loads(buf: bytes) -> Any:
    """Inverse of ``dumps``."""
    obj, pos = _dec(buf, 0)
    if pos != len(buf):
        raise ValueError(f"corrupt parcel: {len(buf) - pos} trailing byte(s)")
    return obj


# -- dtypes on the wire -------------------------------------------------------


def wire_dtype(dtype) -> str:
    """A dtype's wire name: numpy's ``dtype.str`` (the reference's), or
    ``"bfloat16"``, which numpy lacks."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty(0, dtype=dtype).numpy().dtype.str
    return np.dtype(dtype).str


def torch_dtype_of(name: str) -> "torch.dtype":
    """Inverse of ``wire_dtype``."""
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


# ---------------------------------------------------------------------------
# the parcel itself
# ---------------------------------------------------------------------------


@dataclass
class Parcel:
    """One serialized action (or its reply) in flight between localities.

    ``pid`` matches a reply to its request; ``locality`` is the
    destination (requests) / origin (replies); replies carry
    ``action="reply"`` with ``payload={"value": ...}`` on success or
    ``payload={"error": exception}`` and ``ok=False`` on failure.
    """

    action: str
    payload: dict = field(default_factory=dict)
    pid: int = 0
    locality: int = 0
    ok: bool = True


def encode_parcel(p: Parcel, shm_sink: "list | None" = None) -> bytes:
    return dumps((p.action, p.payload, p.pid, p.locality, p.ok), shm_sink=shm_sink)


def decode_parcel(buf: bytes) -> Parcel:
    action, payload, pid, locality, ok = loads(buf)
    return Parcel(action, payload, pid, locality, ok)


# ---------------------------------------------------------------------------
# kernel registry: remote launches reference kernels BY NAME
# ---------------------------------------------------------------------------

_extra_kernels: "dict[str, Callable]" = {}


def register_kernel(name: str, fn: Callable) -> None:
    """Register ``fn`` under ``name`` for launch-by-name parcels.

    In-process registration only: a ``LocalClusterParcelport`` worker is a
    separate process and resolves names through its *own* registry — ship
    kernels to a cluster via ``repro_torch.kernels`` packages or an
    importable ``"module:attr"`` reference instead.
    """
    _extra_kernels[name] = fn


def resolve_kernel(name: str) -> Callable:
    """Kernel callable for a parcel's kernel-name reference: the
    ``register_kernel`` entries, then ``repro_torch.kernels.all_kernels()``,
    then an importable ``"module:attr"``."""
    fn = _extra_kernels.get(name)
    if fn is not None:
        return fn
    from repro_torch.kernels import all_kernels

    fn = all_kernels().get(name)
    if fn is not None:
        return fn
    if ":" in name:
        mod, _, attr = name.partition(":")
        try:
            target: Any = importlib.import_module(mod)
            for part in attr.split("."):
                target = getattr(target, part)
            if callable(target):
                return target
        except Exception:  # noqa: BLE001 - fall through to the KeyError
            pass
    from repro_torch.core import agas

    raise KeyError(
        f"kernel {name!r} is not resolvable on locality L{agas.get_locality_id()}: "
        "register it with repro_torch.core.parcel.register_kernel, add it to a "
        "repro_torch.kernels package, or reference it as an importable 'module:attr'"
    )


def _bind_geometry(fn: Callable, grid, block) -> Callable:
    """Geometry-kwarg binding for registry kernels (``Program._bind`` twin
    for kernels launched outside a ``Program``)."""
    import inspect

    params = inspect.signature(fn).parameters
    kwargs = {}
    if "grid" in params:
        kwargs["grid"] = tuple(grid) if grid is not None else None
    if "block" in params:
        kwargs["block"] = tuple(block) if block is not None else None
    if not kwargs:
        return fn
    return lambda *args: fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# action server: decoded parcels -> the ordinary local runtime API
# ---------------------------------------------------------------------------


def _on_device(x, device: "torch.device"):
    """A host value that arrived in a parcel, on ``device`` (one H2D copy);
    anything that is not an array passes through."""
    if isinstance(x, np.ndarray):
        if not x.flags.writeable or not x.flags.c_contiguous:
            x = np.array(x, order="C")
        return torch.from_numpy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def _host_tree(tree):
    """Every tensor leaf of ``tree`` on the host (``host_value``)."""
    from repro_torch.pytree import tree_map

    return tree_map(lambda a: host_value(a) if isinstance(a, torch.Tensor) else a, tree)


def _sync_current(device) -> None:
    """Wait for the work enqueued on the current stream of ``device``."""
    if device.is_cuda:
        torch.cuda.current_stream(device.torch_device).synchronize()


class ActionServer:
    """Executes parcels against this process's devices of ``platform``.

    One per locality.  Objects created by parcels (buffers, programs) are
    held strongly in an object table keyed by their AGAS GID — the remote
    holder owns them; the table is their anchor until a ``free`` parcel
    (or server shutdown) releases them.
    """

    def __init__(self, locality_id: int, platform: str = "cuda"):
        self.locality_id = locality_id
        self.platform = platform
        self._objects: "dict[int, Any]" = {}
        # key -> Device memo: discovery is a pool hop + device walk; the
        # transport hot path must not pay it per parcel.
        self._devices: "dict[str | None, Any]" = {}

    # -- helpers ------------------------------------------------------------

    def _device(self, key: "str | None"):
        dev = self._devices.get(key)
        if dev is not None:
            return dev
        from repro_torch.core.device import get_all_devices

        devices = get_all_devices(platform=self.platform).get()
        if key is None:
            if not devices:
                raise KeyError(f"locality L{self.locality_id} has no {self.platform} device")
            dev = devices[0]
        else:
            dev = next((d for d in devices if d.key == key), None)
            if dev is None:
                raise KeyError(f"locality L{self.locality_id} has no device {key!r}")
        self._devices[key] = dev
        return dev

    def _buffer(self, gid: int):
        buf = self._objects.get(gid)
        if buf is None:
            raise KeyError(
                f"GID {gid} is not a live parcel-created buffer on locality "
                f"L{self.locality_id} (freed, or never created here)"
            )
        return buf

    def _program(self, gid: int):
        prog = self._objects.get(gid)
        if prog is None:
            raise KeyError(f"GID {gid} is not a live parcel-created program on L{self.locality_id}")
        return prog

    def _resolve_args(self, descs):
        out = []
        for tag, v in descs:
            out.append(self._buffer(v) if tag == "gid" else v)
        return out

    # -- dispatch -----------------------------------------------------------

    def handle(self, action: str, payload: dict) -> Any:
        fn = getattr(self, f"_do_{action}", None)
        if fn is None:
            raise KeyError(f"unknown parcel action {action!r}")
        return fn(payload)

    # -- actions ------------------------------------------------------------

    def _do_ping(self, payload: dict) -> str:
        return "pong"

    def _do_barrier(self, payload: dict) -> None:
        # Completion fence for pipelined channels: unlike "ping" (answered
        # inline by the worker's receive loop), "barrier" rides the worker's
        # single-threaded action pool, so its reply proves every parcel
        # staged before it has fully executed.
        return None

    def _do_discover(self, payload: dict) -> list:
        from repro_torch.core.device import get_all_devices

        self.platform = payload.get("platform", self.platform)
        devices = get_all_devices(platform=self.platform).get()
        if not devices:
            raise RuntimeError(
                f"locality L{self.locality_id} found no {self.platform} device "
                f"(torch.cuda.is_available() is {torch.cuda.is_available()})")
        return [
            {"key": d.key, "platform": d.platform, "capability": list(d.capability())}
            for d in devices
        ]

    def _buffer_reply(self, buf) -> dict:
        self._objects[buf.gid] = buf
        return {"gid": buf.gid, "shape": list(buf.shape), "dtype": wire_dtype(buf.dtype)}

    def _do_create_buffer(self, payload: dict) -> dict:
        dev = self._device(payload.get("device"))
        shape = payload["shape"]
        shape = tuple(shape) if isinstance(shape, (list, tuple)) else int(shape)
        buf = dev.create_buffer(shape, torch_dtype_of(payload["dtype"]), payload.get("fill")).get()
        return self._buffer_reply(buf)

    def _do_create_buffer_from(self, payload: dict) -> dict:
        dev = self._device(payload.get("device"))
        return self._buffer_reply(dev.create_buffer_from(payload["data"]).get())

    def _do_enqueue_write(self, payload: dict) -> None:
        buf = self._buffer(payload["gid"])
        buf.enqueue_write(payload.get("offset", 0), payload["data"], payload.get("count")).get()
        return None

    def _do_enqueue_read(self, payload: dict):
        buf = self._buffer(payload["gid"])
        return buf.enqueue_read(payload.get("offset", 0), payload.get("count")).get()

    def _do_steal_fetch(self, payload: dict) -> list:
        """Batched re-home read for work stealing: one parcel returns the
        full contents of every requested buffer.  Reads are submitted to
        the owning lanes first and gathered after, overlapping the D2H
        copies; large replies ride the shm lane like any other array."""
        futs = [self._buffer(gid).enqueue_read() for gid in payload["gids"]]
        return [f.get() for f in futs]

    def _do_free(self, payload: dict) -> None:
        obj = self._objects.pop(payload["gid"], None)
        free = getattr(obj, "free", None)
        if free is not None:
            free().get()
        return None

    def _do_create_program(self, payload: dict) -> dict:
        from repro_torch.core.program import Program

        dev = self._device(payload.get("device"))
        kernels = {name: resolve_kernel(name) for name in payload["kernels"]}
        prog = Program(dev, kernels, name=payload.get("name", "program"))
        self._objects[prog.gid] = prog
        return {"gid": prog.gid}

    def _do_build(self, payload: dict) -> None:
        prog = self._program(payload["program"])
        specs = [torch.empty(tuple(s), dtype=torch_dtype_of(d), device="meta")
                 for s, d in payload.get("specs", [])]
        prog.build(
            payload["kernel"], *specs, grid=payload.get("grid"), block=payload.get("block")
        ).get()
        return None

    def _do_launch(self, payload: dict) -> "list | None":
        prog = self._program(payload["program"])
        td = prog.device.torch_device
        args = [a.to(td) if isinstance(a, torch.Tensor) else a  # a bfloat16 value
                for a in self._resolve_args(payload["args"])]
        out_gids = payload.get("out")
        out = [self._buffer(g) for g in out_gids] if out_gids is not None else None
        fut = prog.run(
            args, payload["kernel"], grid=payload.get("grid"), block=payload.get("block"), out=out
        )
        res = fut.get()  # resolved once the launch's work has completed
        if out is not None:
            return None  # results live in the remote buffers; nothing to ship
        res_list = list(res) if isinstance(res, (tuple, list)) else [res]
        return [host_value(r) if isinstance(r, torch.Tensor) else r for r in res_list]

    def _do_apply(self, payload: dict) -> Any:
        """Run a registry kernel over a pytree batch on this locality's
        device lane (the serving fan-out action)."""
        from repro_torch.pytree import tree_map

        dev = self._device(payload.get("device"))
        fn = resolve_kernel(payload["kernel"])
        batch = payload["batch"]

        def _run():
            out = fn(tree_map(lambda a: _on_device(a, dev.torch_device), batch))
            _sync_current(dev)
            return _host_tree(out)

        return dev.ops_queue.submit(_run).get()

    def _do_apply_batched(self, payload: dict) -> list:
        """Run a registry kernel ONCE over a stacked micro-batch assembled
        from many requests, and reply with one result chunk per request
        (the serving engine's cross-locality action).

        ``batch`` is the padded, bucket-shaped pytree (all leaves share a
        leading row axis); ``rows`` lists each member request's row count
        in order.  The reply ships only the real rows back."""
        from repro_torch.pytree import tree_map

        dev = self._device(payload.get("device"))
        fn = resolve_kernel(payload["kernel"])
        batch = payload["batch"]
        rows = [int(r) for r in payload["rows"]]

        def _run():
            out = fn(tree_map(lambda a: _on_device(a, dev.torch_device), batch))
            _sync_current(dev)
            out = _host_tree(out)
            chunks, off = [], 0
            for r in rows:
                chunks.append(tree_map(
                    # 0-d output leaves are shared, not row-sliced (the
                    # engine's local slice rule)
                    lambda a, o=off, n=r: a[o : o + n] if getattr(a, "ndim", 0) >= 1 else a,
                    out,
                ))
                off += r
            return chunks

        return dev.ops_queue.submit(_run).get()

    def _do_invoke(self, payload: dict) -> Any:
        """Named-function RPC: resolve ``fn`` exactly like a kernel
        reference and call it with the decoded payload value directly, so
        the payload may mix arrays with plain scalars and strings (the
        elastic trainer's shard-step action ships params + tokens + config
        knobs in one dict)."""
        fn = resolve_kernel(payload["fn"])
        return fn(payload.get("payload"))

    def _do_run_segment(self, payload: dict) -> list:
        """Execute one graph segment's plan: its launches by kernel name,
        eagerly and in order, on this locality's device, over an SSA
        environment seeded with the shipped inputs (the remote half of a
        graph replay across localities)."""
        dev = self._device(payload.get("device"))
        nodes = payload["nodes"]
        in_syms = payload["in_syms"]
        out_syms = payload["out_syms"]
        inputs = payload["inputs"]

        def _exec():
            td = dev.torch_device
            env = {s: _on_device(x, td) for s, x in zip(in_syms, inputs)}
            for node in nodes:
                pgid = node.get("program")
                if pgid is not None:
                    fn = self._program(pgid)._bind(node["kernel"], node.get("grid"), node.get("block"))
                else:
                    fn = _bind_geometry(resolve_kernel(node["kernel"]), node.get("grid"), node.get("block"))
                vals = [env[v] if tag == "sym" else _on_device(v, td) for tag, v in node["args"]]
                res = fn(*vals)
                res_list = list(res) if isinstance(res, (tuple, list)) else [res]
                for s, v in zip(node["res"], res_list):
                    env[s] = v
            _sync_current(dev)
            return [host_value(env[s]) for s in out_syms]

        return dev.ops_queue.submit(_exec).get()

    def shutdown(self) -> None:
        objects, self._objects = list(self._objects.values()), {}
        for obj in objects:
            free = getattr(obj, "free", None)
            if free is not None:
                try:
                    free()
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

# Locality ids are unique across every port this process ever creates, so
# two ports' workers can never mint colliding proxy GIDs in our registry.
_locality_counter = itertools.count(1)
_live_ports: "weakref.WeakSet" = weakref.WeakSet()


def _next_locality_id() -> int:
    return next(_locality_counter)


def _shutdown_all_ports() -> None:
    """Drain and stop every live parcelport (called by ``reset_runtime``:
    worker processes must never outlive the runtime that owns their proxy
    queues)."""
    for port in list(_live_ports):
        try:
            port.shutdown()
        except Exception:  # noqa: BLE001 - reset must not fail on teardown
            pass


class Parcelport:
    """Transport interface: named-action requests to remote localities.

    Concrete transports implement ``_send`` (async request, future of the
    reply's value), ``alive`` and ``shutdown``; discovery results are
    exposed as ``localities()`` — a list of ``Locality`` groups whose
    devices are ``RemoteDevice`` proxies routing through this port.
    ``call`` first sends the ``free`` parcels that collected proxies left
    (a finalizer only queues them: it may run on a thread that holds this
    port's locks or the AGAS registry's).
    """

    in_process = False

    def __init__(self, platform: str = "cuda"):
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"unknown platform {platform!r}; use 'cuda' or 'cpu'")
        self.platform = platform
        self._localities: "list" = []
        self._schedulers: dict = {}
        self._shut = False
        self._fault_filter: "Callable | None" = None
        self._frees: "collections.deque" = collections.deque()
        _live_ports.add(self)

    # -- fault injection ------------------------------------------------------

    def set_fault_filter(self, fn: "Callable | None") -> None:
        """Install (or clear, with ``None``) a chaos hook consulted on every
        outbound parcel: ``fn(locality_id, action) -> None`` passes the
        parcel through, ``("drop", exc)`` fails it with ``exc`` without
        sending, ``("delay", seconds)`` sleeps on the sender before the
        send — FIFO-preserving, because later parcels on the same channel
        queue behind the delay.  Installed by ``repro_torch.fault.inject``."""
        self._fault_filter = fn

    def _fault_verdict(self, locality_id: int, action: str):
        """None to proceed, or the exception an injected drop fails with.
        Injected delays are served here (on the sending thread)."""
        fn = self._fault_filter
        if fn is None:
            return None
        verdict = fn(locality_id, action)
        if verdict is None:
            return None
        if verdict[0] == "delay":
            time.sleep(float(verdict[1]))
            return None
        return verdict[1]  # ("drop", exc)

    # -- transport surface ----------------------------------------------------

    def defer_free(self, locality_id: int, gid: int) -> None:
        """Queue a best-effort ``free`` parcel (finalizers): no lock is
        taken; the next ``call`` sends it."""
        self._frees.append((locality_id, gid))

    def _send_frees(self) -> None:
        while True:
            try:
                lid, gid = self._frees.popleft()
            except IndexError:
                return
            try:
                self._send(lid, "free", {"gid": gid})
            except Exception:  # noqa: BLE001 - best-effort
                pass

    def call(self, locality_id: int, action: str, payload: dict):
        if self._frees:
            self._send_frees()
        return self._send(locality_id, action, payload)

    def _send(self, locality_id: int, action: str, payload: dict):
        raise NotImplementedError

    def call_sync(self, locality_id: int, action: str, payload: dict):
        return self.call(locality_id, action, payload).get()

    def alive(self, locality_id: int) -> bool:
        return not self._shut

    def shutdown(self) -> None:
        self._shut = True

    # -- discovery / placement ----------------------------------------------

    def localities(self) -> list:
        """Remote localities reachable through this port (HPX
        ``find_all_localities``, minus the caller's own)."""
        return list(self._localities)

    def devices(self) -> list:
        return [d for loc in self._localities for d in loc]

    def scheduler(self, policy: "str | Any" = "percolation", include_local: bool = True):
        """A ``Scheduler`` over the cluster-wide ``localities × devices``
        grid (this process's devices of the port's platform + every remote
        device), cached per policy."""
        from repro_torch.core.scheduler import Scheduler

        key = (policy if isinstance(policy, str) else id(policy), include_local)
        sched = self._schedulers.get(key)
        if sched is None:
            fleet = []
            if include_local:
                from repro_torch.core.device import get_all_devices

                fleet.extend(get_all_devices(platform=self.platform).get())
            fleet.extend(self.devices())
            sched = self._schedulers[key] = Scheduler(fleet, policy=policy)
        return sched

    def _wrap_discovery(self, locality_id: int, descriptors: list) -> None:
        from repro_torch.core.device import Locality, RemoteDevice

        devs = [
            RemoteDevice(
                self,
                locality_id,
                d["key"],
                platform=d.get("platform", "cpu"),
                capability=tuple(d.get("capability", (1, 0))),
            )
            for d in descriptors
        ]
        self._localities.append(Locality(locality_id, devs))

    def _retire_proxies(self) -> None:
        from repro_torch.core import agas

        for loc in self._localities:
            for dev in loc:
                agas.registry.unregister(dev.gid)
        self._localities = []
        self._schedulers = {}


class LoopbackParcelport(Parcelport):
    """In-process transport: N simulated remote localities, zero deps.

    Every request is *really* encoded and decoded (both ways), and every
    locality executes on its own serial queue — so the full parcel path
    (codec, action dispatch, reply resolution, proxy objects) is exercised
    without any process machinery.  Simulated localities share this
    process's devices and AGAS registry; placement records of objects they
    create therefore keep local device keys (the one observable difference
    from a real cluster).
    """

    in_process = True

    def __init__(self, n_localities: int = 1, platform: str = "cuda"):
        super().__init__(platform)
        from repro_torch.core.executor import get_runtime

        rt = get_runtime()
        self._servers: "dict[int, ActionServer]" = {}
        self._queues: dict = {}
        self._pid = itertools.count(1)
        self._dead: "set[int]" = set()
        for _ in range(n_localities):
            lid = _next_locality_id()
            self._servers[lid] = ActionServer(lid, platform)
            self._queues[lid] = rt.queue(f"parcelport:loopback:L{lid}")
            self._wrap_discovery(lid, self._servers[lid].handle("discover", {"platform": platform}))
            # The simulated locality shares this process's devices: values
            # bound for it are staged on the device it serves from.
            for dev in self._localities[-1]:
                dev.torch_device = self._servers[lid]._device(dev.remote_key).torch_device

    def _send(self, locality_id: int, action: str, payload: dict):
        from repro_torch.core.futures import Future

        if self._shut:
            return Future.failed(RuntimeError(f"parcelport is shut down; parcel {action!r} dropped"))
        server = self._servers.get(locality_id)
        if server is None:
            return Future.failed(KeyError(f"no locality L{locality_id} on this parcelport"))
        if locality_id in self._dead:
            return Future.failed(RuntimeError(
                f"parcel {action!r} to locality L{locality_id} failed fast: "
                "locality killed (fault injection); it is excluded from placement"))
        exc = self._fault_verdict(locality_id, action)
        if exc is not None:
            return Future.failed(exc)
        blob = encode_parcel(Parcel(action, payload, next(self._pid), locality_id))

        def _serve():
            req = decode_parcel(blob)
            try:
                rep = Parcel("reply", {"value": server.handle(req.action, req.payload)}, req.pid, locality_id)
            except BaseException as e:  # noqa: BLE001 - errors travel as parcels
                rep = Parcel("reply", {"error": e}, req.pid, locality_id, ok=False)
            rep = decode_parcel(encode_parcel(rep))  # the reply round-trips too
            if not rep.ok:
                raise rep.payload["error"]
            return rep.payload.get("value")

        return self._queues[locality_id].submit(_serve)

    def alive(self, locality_id: int) -> bool:
        return (
            not self._shut
            and locality_id in self._servers
            and locality_id not in self._dead
        )

    def kill(self, locality_id: int) -> None:
        """Simulate worker death on an in-process fleet: subsequent parcels
        fail fast and ``alive()`` reads False until ``revive``."""
        self._dead.add(locality_id)

    def revive(self, locality_id: int) -> None:
        """Re-admit a killed locality (the recovered-worker path)."""
        self._dead.discard(locality_id)

    def shutdown(self) -> None:
        if self._shut:
            return
        self._frees.clear()  # the servers free everything they hold
        self._shut = True
        for server in self._servers.values():
            server.shutdown()
        self._retire_proxies()


# -- cluster transport -------------------------------------------------------


def _cluster_worker_main(locality_id: int, rx, tx, shm_replies: bool = True,
                         platform: str = "cuda") -> None:
    """Entry point of one spawned worker process: one remote locality.

    Owns its own runtime, lanes and AGAS registry (GIDs minted under
    ``locality_id``) and, on ``platform="cuda"``, its own CUDA context.
    The receive loop answers pings inline (process liveness, not business
    progress) and runs every other action on a single-thread executor,
    preserving arrival order while keeping the heartbeat responsive during
    long actions.  A ``multi`` parcel (coalesced channel flush) is
    unpacked here and its sub-parcels submitted in order.  Reply arrays
    ride the shared-memory lane when available (``shm_replies`` mirrors
    the parent port's setting).

    ``rx``/``tx`` are raw ``multiprocessing`` pipe connections carrying
    already-encoded parcel blobs.  An empty message is the hard-stop
    sentinel; a closed pipe (parent gone) ends the loop.
    """
    import concurrent.futures as _cf

    from repro_torch.core import agas

    txlock = threading.Lock()  # replies come from the pool AND the rx loop

    def _send(blob: bytes) -> None:
        with txlock:
            tx.send_bytes(blob)

    agas.set_locality_id(locality_id)
    try:
        server = ActionServer(locality_id, platform)
        hello = Parcel("hello", {"devices": server.handle("discover", {"platform": platform}),
                                 "os_pid": os.getpid()}, 0, locality_id)
        _send(encode_parcel(hello))
    except BaseException as e:  # noqa: BLE001 - surface startup failure to parent
        _send(encode_parcel(Parcel("hello", {"error": e}, 0, locality_id, ok=False)))
        return

    pool = _cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"parcel-L{locality_id}")
    use_shm = bool(shm_replies) and shm_available()
    tracker = _ShmTracker() if use_shm else None

    def _reply(pid: int, value=None, error=None) -> None:
        if error is None:
            rep = Parcel("reply", {"value": value}, pid, locality_id)
        else:
            rep = Parcel("reply", {"error": error}, pid, locality_id, ok=False)
        sink: "list | None" = [] if use_shm else None
        try:
            blob = encode_parcel(rep, shm_sink=sink)
        except Exception as e:  # noqa: BLE001 - unencodable reply value
            blob = encode_parcel(
                Parcel("reply", {"error": RemoteError(f"unencodable reply: {e}")}, pid, locality_id, ok=False)
            )
        if sink:
            tracker.add(sink)
        try:
            _send(blob)
        except (BrokenPipeError, OSError):  # parent gone: nothing to reply to
            pass

    def _work(req: Parcel) -> None:
        try:
            _reply(req.pid, value=server.handle(req.action, req.payload))
        except BaseException as e:  # noqa: BLE001 - errors travel as parcels
            _reply(req.pid, error=e)

    def _work_blob(blob: bytes) -> None:
        try:
            req = decode_parcel(blob)
        except BaseException:  # noqa: BLE001 - no pid to reply to
            return
        _work(req)

    req: "Parcel | None" = None
    while True:
        try:
            blob = rx.recv_bytes()
        except (EOFError, OSError):  # parent closed its end / died
            req = None
            break
        if not blob:  # empty message: hard-stop sentinel
            req = None
            break
        try:
            req = decode_parcel(blob)
        except BaseException:  # noqa: BLE001 - undecodable: no pid to reply to
            continue
        if req.action == "shutdown":
            break
        if req.action == "ping":
            _reply(req.pid, value="pong")  # answered inline: liveness signal
            continue
        if req.action == "multi":
            # One coalesced channel flush: sub-parcels keep their staging
            # order (the pool is single-threaded), each replying alone.
            # Sub-decode runs ON the pool: a shared-memory import must not
            # stall the receive loop (heartbeat stays responsive).
            for sub in req.payload["parcels"]:
                pool.submit(_work_blob, sub)
            continue
        pool.submit(_work, req)
    # Orderly drain before the shutdown reply: queued work finishes (and
    # its reply segments get consumed or tracked), THEN still-unconsumed
    # reply segments are unlinked so nothing outlives the worker.
    pool.shutdown(wait=True)
    if req is not None and req.action == "shutdown":
        _reply(req.pid, value=None)
    server.shutdown()
    if tracker is not None:
        tracker.purge()


class _ClusterWorker:
    __slots__ = ("locality_id", "proc", "tx", "rx", "txlock", "heartbeat", "pending", "lock",
                 "dead", "death_reason", "sendbuf", "sendlock", "shm_names", "os_pid")

    def __init__(self, locality_id, proc, tx, rx, heartbeat):
        self.locality_id = locality_id
        self.proc = proc
        self.tx = tx  # parent -> worker pipe connection (blobs out)
        self.rx = rx  # worker -> parent pipe connection (replies in)
        self.txlock = threading.Lock()
        self.heartbeat = heartbeat
        self.pending: "dict[int, tuple[str, Any]]" = {}
        self.lock = threading.Lock()
        self.dead = False
        self.death_reason = ""
        self.sendbuf: "list[tuple[int, bytes]]" = []  # staged, awaiting flush
        self.sendlock = threading.Lock()
        self.shm_names = _ShmTracker()  # segments sent, maybe unconsumed
        self.os_pid = None


class LocalClusterParcelport(Parcelport):
    """N worker processes, each a real remote locality (own interpreter,
    own CUDA context on ``platform="cuda"``, own ``Runtime`` and lanes, own
    AGAS registry).

    Transport is a pair of one-way ``multiprocessing`` pipes per worker
    carrying already-encoded parcel blobs (large arrays side-step the pipe
    through the shared-memory lane).  Workers start via *spawn* (never
    fork: the parent's CUDA context and threads must not be duplicated
    into a child).  A per-worker ``fault.monitor.Heartbeat`` is ticked by
    every reply; a monitor thread pings each worker and checks deadlines —
    a dead worker fails its pending parcels fast and its devices report
    ``alive() == False`` so the scheduler stops placing there.  A worker
    that finds no device of ``platform`` fails its hello, and the
    constructor raises.
    """

    def __init__(
        self,
        n_workers: int = 2,
        heartbeat_timeout: float = 30.0,
        startup_timeout: float = 180.0,
        name: str = "cluster",
        shm: "bool | None" = None,
        pipeline: "bool | None" = None,
        platform: str = "cuda",
    ):
        super().__init__(platform)
        import multiprocessing as mp

        from repro_torch.fault.monitor import Heartbeat

        self.name = name
        self.heartbeat_timeout = float(heartbeat_timeout)
        # Shared-memory array lane: on when the host supports it (None =
        # auto-probe; REPRO_PARCEL_SHM=off wins over an explicit True).
        self._shm_ok = shm_available() if shm is None else (bool(shm) and shm_available())
        # Pipelined channels: senders stage + flush without blocking on
        # replies (arrival order at the worker preserves channel FIFO).
        if pipeline is None:
            pipeline = os.environ.get("REPRO_PARCEL_PIPELINE", "auto").lower() != "off"
        self.pipelined = bool(pipeline)
        ctx = mp.get_context("spawn")
        self._workers: "dict[int, _ClusterWorker]" = {}
        self._pid = itertools.count(1)
        self._stop = threading.Event()
        self._threads: "list[threading.Thread]" = []
        for _ in range(n_workers):
            lid = _next_locality_id()
            c2w_rx, c2w_tx = ctx.Pipe(duplex=False)  # parent -> worker
            w2p_rx, w2p_tx = ctx.Pipe(duplex=False)  # worker -> parent
            proc = ctx.Process(
                target=_cluster_worker_main,
                args=(lid, c2w_rx, w2p_tx, self._shm_ok, platform),
                daemon=True,
                name=f"parcel-worker-L{lid}",
            )
            proc.start()
            # Close the child's ends here so EOF propagates when a side dies.
            c2w_rx.close()
            w2p_tx.close()
            hb = Heartbeat(timeout_s=self.heartbeat_timeout)
            hb.on_dead = self._make_on_dead(lid)
            self._workers[lid] = _ClusterWorker(lid, proc, c2w_tx, w2p_rx, hb)
        try:
            for w in self._workers.values():
                deadline = time.monotonic() + startup_timeout
                while True:  # poll so a worker that dies during startup fails fast
                    try:
                        if w.rx.poll(0.5):
                            hello = decode_parcel(w.rx.recv_bytes())
                            break
                        raise _queue.Empty
                    except (_queue.Empty, EOFError):
                        if not w.proc.is_alive():
                            raise RuntimeError(
                                f"worker L{w.locality_id} died during startup "
                                f"(exit code {w.proc.exitcode})"
                            ) from None
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"worker L{w.locality_id} sent no hello within {startup_timeout}s"
                            ) from None
                if not hello.ok or "error" in hello.payload:
                    raise RuntimeError(
                        f"worker L{w.locality_id} failed to start: {hello.payload.get('error')}"
                    )
                w.os_pid = hello.payload.get("os_pid")
                self._wrap_discovery(w.locality_id, hello.payload["devices"])
                w.heartbeat.tick()
        except BaseException:
            self.shutdown()
            raise
        for w in self._workers.values():
            t = threading.Thread(target=self._listen, args=(w,), daemon=True, name=f"parcel-rx-L{w.locality_id}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._monitor, daemon=True, name=f"parcel-hb:{name}")
        t.start()
        self._threads.append(t)

    # -- liveness ------------------------------------------------------------

    def _make_on_dead(self, locality_id: int):
        return lambda: self._mark_dead(locality_id, f"missed its heartbeat deadline ({self.heartbeat_timeout}s)")

    def _mark_dead(self, locality_id: int, reason: str) -> None:
        w = self._workers.get(locality_id)
        if w is None:
            return
        with w.lock:
            if w.dead:
                return
            w.dead = True
            w.death_reason = f"locality L{locality_id} {reason}"
            pending, w.pending = dict(w.pending), {}
        # Queued parcels fail fast, each naming its action and the cause.
        for action, promise in pending.values():
            promise.set_exception(
                RuntimeError(
                    f"parcel {action!r} to locality L{locality_id} failed: {w.death_reason}; "
                    "the locality is excluded from placement"
                )
            )
        # A dead worker will never consume its in-flight shm segments.
        w.shm_names.purge()

    def _mark_recovered(self, w: "_ClusterWorker") -> None:
        """Re-admit a heartbeat-flapped locality: the dead latch cleared
        (the worker ticked again), so lift the fail-fast gate too —
        ``alive()`` turns true and the scheduler re-includes the locality
        on its next decision.  Process-exit deaths never reach here."""
        with w.lock:
            if not w.dead:
                return
            w.dead = False
            w.death_reason = ""

    def alive(self, locality_id: int) -> bool:
        w = self._workers.get(locality_id)
        return w is not None and not w.dead and not self._shut

    def process(self, locality_id: int):
        """The ``multiprocessing.Process`` of a worker (None if unknown)."""
        w = self._workers.get(locality_id)
        return None if w is None else w.proc

    # -- wire threads --------------------------------------------------------

    def _listen(self, w: _ClusterWorker) -> None:
        while not self._stop.is_set():
            try:
                if not w.rx.poll(0.25):
                    if w.dead and not w.proc.is_alive():
                        # Process gone: no more replies, ever.  A worker
                        # that is merely heartbeat-dead keeps its listener
                        # — a late reply is the recovery signal.
                        return
                    continue
                blob = w.rx.recv_bytes()
            except (EOFError, OSError):
                return
            w.heartbeat.tick()  # any reply is proof of life
            rep = decode_parcel(blob)
            with w.lock:
                entry = w.pending.pop(rep.pid, None)
            if entry is None:
                continue
            _, promise = entry
            if rep.ok:
                promise.set_value(rep.payload.get("value"))
            else:
                promise.set_exception(rep.payload["error"])

    def _probe(self, w: "_ClusterWorker") -> None:
        """Recovery ping that bypasses the dead-worker fail-fast gate: no
        pending entry is registered (the reply's heartbeat tick IS the
        signal; the unmatched pid is dropped by ``_listen``)."""
        try:
            blob = encode_parcel(Parcel("ping", {}, next(self._pid), w.locality_id))
            with w.txlock:
                w.tx.send_bytes(blob)
        except Exception:  # noqa: BLE001 - pipe gone; the exit path handles it
            pass

    def _monitor(self) -> None:
        interval = min(2.0, max(0.05, self.heartbeat_timeout / 4.0))
        while not self._stop.wait(interval):
            if self._frees:
                self._send_frees()
            for w in list(self._workers.values()):
                if w.dead:
                    if not w.proc.is_alive():
                        continue  # permanent: the process exited
                    # Heartbeat deaths are a latch on a LIVE process: probe
                    # past the fail-fast gate; once a reply ticks the
                    # heartbeat, check() clears the latch.
                    self._probe(w)
                    if w.heartbeat.check():
                        self._mark_recovered(w)
                    continue
                if not w.proc.is_alive():
                    self._mark_dead(
                        w.locality_id, f"worker process exited with code {w.proc.exitcode}"
                    )
                    continue
                try:
                    self._send(w.locality_id, "ping", {})  # reply ticks the heartbeat
                except Exception:  # noqa: BLE001
                    pass
                w.heartbeat.check()  # fires on_dead on a missed deadline

    # -- transport -----------------------------------------------------------

    def _send(self, locality_id: int, action: str, payload: dict):
        from repro_torch.core.futures import Future, Promise

        if self._shut:
            return Future.failed(RuntimeError(f"parcelport {self.name!r} is shut down; parcel {action!r} dropped"))
        w = self._workers.get(locality_id)
        if w is None:
            return Future.failed(KeyError(f"no locality L{locality_id} on parcelport {self.name!r}"))
        exc = self._fault_verdict(locality_id, action)
        if exc is not None:
            return Future.failed(exc)
        pid = next(self._pid)
        promise: Promise = Promise(name=f"parcel:{action}:L{locality_id}")
        with w.lock:
            if w.dead:
                return Future.failed(
                    RuntimeError(f"parcel {action!r} to locality L{locality_id} failed fast: {w.death_reason}")
                )
            w.pending[pid] = (action, promise)
        sink: "list | None" = [] if self._shm_ok else None
        try:
            blob = encode_parcel(Parcel(action, payload, pid, locality_id), shm_sink=sink)
            if sink:
                w.shm_names.add(sink)
            with w.txlock:
                w.tx.send_bytes(blob)
        except BaseException as e:  # noqa: BLE001 - pipe torn down under us
            with w.lock:
                w.pending.pop(pid, None)
            return Future.failed(RuntimeError(f"parcel {action!r} to L{locality_id} could not be sent: {e}"))
        return promise.get_future()

    def stage(self, locality_id: int, action: str, payload: dict, promise) -> None:
        """Pipelined half-send: encode NOW (shared-memory exports included),
        register the reply promise, and buffer the parcel for the next
        ``flush``.  A staged parcel never blocks its channel on the reply —
        channel FIFO holds end-to-end because staging order is flush order
        is worker arrival order."""
        if self._shut:
            promise.set_exception(
                RuntimeError(f"parcelport {self.name!r} is shut down; parcel {action!r} dropped"))
            return
        w = self._workers.get(locality_id)
        if w is None:
            promise.set_exception(KeyError(f"no locality L{locality_id} on parcelport {self.name!r}"))
            return
        exc = self._fault_verdict(locality_id, action)
        if exc is not None:
            promise.set_exception(exc)
            return
        pid = next(self._pid)
        with w.lock:
            if w.dead:
                promise.set_exception(
                    RuntimeError(f"parcel {action!r} to locality L{locality_id} failed fast: {w.death_reason}"))
                return
            w.pending[pid] = (action, promise)
        sink: "list | None" = [] if self._shm_ok else None
        try:
            blob = encode_parcel(Parcel(action, payload, pid, locality_id), shm_sink=sink)
        except BaseException as e:  # noqa: BLE001 - unencodable payload
            with w.lock:
                w.pending.pop(pid, None)
            promise.set_exception(e)
            return
        if sink:
            w.shm_names.add(sink)
        with w.sendlock:
            w.sendbuf.append((pid, blob))

    def flush(self, locality_id: int) -> None:
        """Ship every parcel staged since the last flush as ONE hop: a
        single parcel goes as itself, several go as one ``multi`` parcel
        the worker unpacks in staging order (parcel coalescing)."""
        w = self._workers.get(locality_id)
        if w is None:
            return
        with w.sendlock:
            if not w.sendbuf:
                return  # an earlier flush already took them
            batch, w.sendbuf = w.sendbuf, []
        try:
            if len(batch) == 1:
                blob = batch[0][1]
            else:
                blob = encode_parcel(
                    Parcel("multi", {"parcels": [b for _, b in batch]}, 0, locality_id))
            with w.txlock:
                w.tx.send_bytes(blob)
        except BaseException as e:  # noqa: BLE001 - pipe torn down under us
            entries = []
            with w.lock:
                for pid, _ in batch:
                    entries.append(w.pending.pop(pid, None))
            for entry in entries:
                if entry is not None:
                    entry[1].set_exception(
                        RuntimeError(f"parcel {entry[0]!r} to L{locality_id} could not be sent: {e}"))

    # -- teardown ------------------------------------------------------------

    def shutdown(self) -> None:
        if self._shut:
            return
        if self._frees:
            self._send_frees()
        self._shut = True
        self._stop.set()
        for w in self._workers.values():
            if w.proc.is_alive():
                try:
                    with w.txlock:
                        w.tx.send_bytes(
                            encode_parcel(Parcel("shutdown", {}, next(self._pid), w.locality_id)))
                except Exception:  # noqa: BLE001
                    pass
        for w in self._workers.values():
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2)
            self._mark_dead(w.locality_id, "parcelport shut down")
            for conn in (w.tx, w.rx):
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
            # Worker has exited (joined above): anything it never consumed
            # is ours to unlink; racing its decoder is no longer possible.
            w.shm_names.purge()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        self._retire_proxies()
