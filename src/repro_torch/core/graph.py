"""Task-graph capture and replay on CUDA Graphs (``src/repro/core/graph.py``,
DESIGN.md §8).

The futurization layer pays a small constant cost per operation: a
``Future``, a lane hop, a launch issued from Python.  This module drives
the per-graph cost toward zero as CUDA Graphs do: record the DAG once,
then replay it with one submission.

  * ``capture()`` (stream-capture style) or an explicit ``TaskGraph``
    builder records ``Buffer`` transfers and ``Program.run`` launches as a
    symbolic SSA DAG.  Nothing executes during capture: result shapes come
    from the kernel's plain version run on ``meta`` tensors.
  * ``instantiate()`` plans the DAG as the reference does: every launch
    joins an SSA chain (the chain of its first same-device producer, or a
    new one), a segment is a maximal run of launches on one (device,
    chain), every cross-device SSA edge becomes a *transfer step*, and a
    value crossing from one chain's lane to another's an *event edge*.
    Then, on a CUDA device, each segment is run once eagerly on a side
    stream on throwaway inputs (the warm-up: libraries loaded, cuBLAS
    handles made, nothing committed) and captured into a
    ``torch.cuda.CUDAGraph`` of its own.  A segment's graph reads static
    input tensors: the graph output of a same-device producer segment in
    place, and a fresh tensor for anything else (a write, an extern, a
    transfer slot), which every replay fills.
  * ``replay()`` resolves **one** ``Future``.  A plan of one segment on
    one device takes one task on its lane: copy the feeds and the live
    value of every extern into the static inputs, launch the graph,
    commit.  Any other plan fans out (DESIGN.md §9, §11): extern reads on
    their owners' lanes, write payloads staged on their devices' lanes,
    then every segment, in capture order from the calling thread, on its
    chain's lane.  A segment's lane task waits on the host only until its
    producers are *issued*; its stream waits on their CUDA events (the
    event edges), runs its transfer steps (a copy into the static input,
    on this stream) and replays its graph.  A join on the host pool
    commits the buffers once every segment is issued (``sync="dispatch"``)
    or its work has ended (``sync="ready"``).

Executor per segment (``REPRO_SEGMENT_COMPILE=fused|staged|auto``, read
once an instantiate): ``fused`` is the segment's CUDA graph, ``staged``
its launches run eagerly on its lane.  ``auto`` times both once on zero
inputs for a segment of two or more launches and keeps the faster (ties,
a failed trial and inputs above ``_CAL_MAX_BYTES`` keep ``fused``); a
segment of one launch stays ``fused``.  A CPU device has no CUDA graph:
its segments replay ``staged`` with the same bookkeeping.  A capture that
fails raises; it never falls back to eager.

Correspondence: capture <-> ``cudaStreamBeginCapture``; ``GraphExec`` <->
``cudaGraphExec_t``; ``replay`` <-> ``cudaGraphLaunch``; feeds copied into
the static inputs <-> ``cudaGraphExecKernelNodeSetParams``; chain -> lane
and its CUDA stream <-> ``cudaGraph`` node-to-stream assignment; event
edge <-> ``cudaEventRecord`` at the producer's tail and
``cudaStreamWaitEvent`` on the consumer's stream.

Ordering: replays of one ``GraphExec`` serialise.  The fan-out holds a
lock from submission to its join, every stream of a replay first waits on
the previous replay's end event (so no replay overwrites graph memory or a
transfer slot that the previous one still reads), and the default lane of
every device the plan touches is fenced until the join has committed, so
eager work submitted after ``replay()`` returns sees the committed
buffers.  A buffer whose final value materialised on another device is
re-homed there; an extern that moved or was spilled since instantiate is
brought back to its planned device before a segment reads it.

Ownership rule (CUDA Graphs'): a buffer whose final value is consumed by a
later in-graph launch and does not survive the plan is *graph-internal* —
after ``replay()`` it is invalidated and reads raise until it is written
again.  Extern inputs are read, never consumed, so a ``GraphExec`` can be
replayed any number of times.  Values the graph hands out (a kept
buffer's value, an out-less launch's result) are copies out of the
graph's memory: a later replay does not change them.

Not ported, and refused: remote buffers and remote segments (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.buffer import Buffer, _host_tensor, _settle, _to_host, _to_host_value
from repro_torch.core.executor import get_runtime
from repro_torch.core.futures import Future
from repro_torch.kernels import tally_launches

__all__ = ["TaskGraph", "GraphExec", "GraphResult", "LaunchNode", "ReadNode", "WriteNode",
           "capture", "current_graph"]

_PARCELS = "ROADMAP.md Queue 1 item 10"

_tls = threading.local()


def current_graph() -> "TaskGraph | None":
    """The graph currently recording on this thread (or None)."""
    return getattr(_tls, "graph", None)


@contextmanager
def capture(name: str = "captured"):
    """Record all ``Program.run`` / ``Buffer.enqueue_write`` /
    ``Buffer.enqueue_read`` calls on this thread into a ``TaskGraph``
    (``cudaStreamBeginCapture`` analogue).  Nothing executes until
    ``instantiate().replay()``."""
    g = TaskGraph(name)
    prev = current_graph()
    _tls.graph = g
    try:
        yield g
    finally:
        _tls.graph = prev


# ---------------------------------------------------------------------------
# symbolic nodes (returned as handles from capture-mode calls)
# ---------------------------------------------------------------------------


class _Spec(NamedTuple):
    shape: tuple
    dtype: "torch.dtype"


class _SymRef:
    """Reference to an SSA value inside the graph."""

    __slots__ = ("sym",)

    def __init__(self, sym: int):
        self.sym = sym


class WriteNode:
    """Recorded full-buffer H2D write; handle usable as a replay-feed key."""

    __slots__ = ("buf", "data", "sym")

    def __init__(self, buf: Buffer, data, sym: int):
        self.buf, self.data, self.sym = buf, data, sym


class LaunchNode:
    """Recorded kernel launch."""

    __slots__ = ("program", "kernel", "arg_refs", "out_bufs", "res_syms", "bound", "device",
                 "grid", "block")

    def __init__(self, program, kernel, arg_refs, out_bufs, res_syms, bound, device,
                 grid=None, block=None):
        self.program = program
        self.kernel = kernel
        self.arg_refs = arg_refs  # list of _SymRef | constant
        self.out_bufs = out_bufs  # list[Buffer] | None
        self.res_syms = res_syms  # list[int], one per kernel result
        self.bound = bound  # geometry-bound callable
        self.device = device
        self.grid = grid
        self.block = block


class ReadNode:
    """Recorded full-buffer D2H read; handle indexes the GraphResult."""

    __slots__ = ("buf", "sym")

    def __init__(self, buf: Buffer, sym: int):
        self.buf, self.sym = buf, sym


class GraphResult:
    """Value of a completed replay: fetched reads (``np.ndarray``; a CPU
    tensor for bfloat16) and out-less launch results (tensors on the
    device), indexed by their capture handle."""

    def __init__(self, fetches: dict, reads: list):
        self._fetches = fetches
        self.reads = reads  # read values in capture order

    def __getitem__(self, node):
        return self._fetches[node]

    def __repr__(self) -> str:
        return f"GraphResult({len(self._fetches)} fetches)"


def _meta(a):
    return a.to("meta") if isinstance(a, torch.Tensor) else a


def _results(res) -> list:
    return list(res) if isinstance(res, (tuple, list)) else [res]


# ---------------------------------------------------------------------------
# the graph builder
# ---------------------------------------------------------------------------


class TaskGraph:
    """Symbolic DAG of transfers and launches (build explicitly or via
    ``capture()``); compile with ``instantiate()``."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self._nodes: list = []
        self._next_sym = 0
        self._cur: "dict[int, int]" = {}  # id(buffer) -> current sym
        self._buffers: "dict[int, Buffer]" = {}  # id(buffer) -> buffer (keepalive)
        self._sym_spec: "dict[int, _Spec]" = {}
        self._extern: "dict[int, Buffer]" = {}  # sym -> source buffer
        self._frozen = False

    # -- recording surface -------------------------------------------------

    def _new_sym(self, shape, dtype) -> int:
        s = self._next_sym
        self._next_sym += 1
        self._sym_spec[s] = _Spec(tuple(shape), dtype)
        return s

    def _check_mutable(self) -> None:
        if self._frozen:
            raise RuntimeError(f"TaskGraph '{self.name}' is frozen (already instantiated)")

    def _sym_of(self, buf: Buffer) -> _SymRef:
        """Current SSA value of a buffer; first touch binds an extern input
        (read live from the buffer at every replay)."""
        if getattr(buf, "is_remote_buffer", False):
            raise NotImplementedError(
                f"graph capture reads local buffers only; remote buffers come with the "
                f"parcel port ({_PARCELS})")
        s = self._cur.get(id(buf))
        if s is None:
            s = self._new_sym(buf.shape, buf.dtype)
            self._cur[id(buf)] = s
            self._buffers[id(buf)] = buf
            self._extern[s] = buf
        return _SymRef(s)

    def write(self, buf: Buffer, data=None, offset: int = 0, count: "int | None" = None) -> WriteNode:
        """Record a full-buffer H2D write.  ``data`` is the default payload;
        override per replay with ``replay(feeds={node_or_buffer: new_data})``."""
        self._check_mutable()
        if getattr(buf, "is_remote_buffer", False):
            raise NotImplementedError(
                "graph capture writes to local buffers only; stage remote "
                f"transfers outside the capture region ({_PARCELS})"
            )
        if offset != 0 or (count is not None and count != buf.size):
            raise NotImplementedError(
                "graph capture supports full-buffer writes only (offset=0); "
                "stage partial updates outside the capture region"
            )
        sym = self._new_sym(buf.shape, buf.dtype)
        self._cur[id(buf)] = sym
        self._buffers[id(buf)] = buf
        node = WriteNode(buf, data, sym)
        self._nodes.append(node)
        return node

    def run(
        self,
        program,
        args: "Sequence[Buffer | Any]",
        name: str,
        grid=None,
        block=None,
        out: "Sequence[Buffer] | None" = None,
    ) -> LaunchNode:
        """Record a kernel launch (``Program.run`` analogue).  Non-buffer
        arguments are captured as constants.  The result shapes come from
        the bound callable run on ``meta`` tensors (a kernel op takes its
        plain version there), so nothing runs on the device."""
        self._check_mutable()
        if name not in program._kernels:
            raise KeyError(f"no kernel '{name}' in {program.name}")
        if out is not None and any(getattr(b, "is_remote_buffer", False) for b in out):
            raise NotImplementedError(
                f"captured graphs write results to local buffers only ({_PARCELS})")
        bound = program._bind(name, grid, block)
        arg_refs: list = []
        shape_args: list = []
        for a in args:
            if isinstance(a, Buffer):
                ref = self._sym_of(a)
                arg_refs.append(ref)
                spec = self._sym_spec[ref.sym]
                shape_args.append(torch.empty(spec.shape, dtype=spec.dtype, device="meta"))
            else:
                arg_refs.append(a)
                shape_args.append(_meta(a))
        try:
            res_list = _results(bound(*shape_args))
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
            raise TypeError(
                f"kernel '{name}': cannot record it without running it — its plain version "
                f"does not run on meta tensors ({e})") from e
        if out is not None and len(res_list) != len(out):
            raise ValueError(
                f"kernel '{name}' returns {len(res_list)} arrays for {len(out)} out buffers"
            )
        res_syms = [self._new_sym(r.shape, r.dtype) for r in res_list]
        if out is not None:
            for b, s in zip(out, res_syms):
                self._cur[id(b)] = s
                self._buffers[id(b)] = b
        node = LaunchNode(program, name, arg_refs, list(out) if out is not None else None,
                          res_syms, bound, program.device, grid=grid, block=block)
        self._nodes.append(node)
        return node

    def read(self, buf: Buffer, offset: int = 0, count: "int | None" = None) -> ReadNode:
        """Record a full-buffer D2H fetch; the handle indexes the replay's
        ``GraphResult`` (value is an ``np.ndarray``, as in eager reads)."""
        self._check_mutable()
        if offset != 0 or (count is not None and count != buf.size):
            raise NotImplementedError(
                "graph capture supports full-buffer reads only (offset=0)"
            )
        node = ReadNode(buf, self._sym_of(buf).sym)
        self._nodes.append(node)
        return node

    # -- instantiate ---------------------------------------------------------

    def instantiate(self, donate: bool = True) -> "GraphExec":
        """Plan, warm up, capture and freeze the graph into a replayable
        executable (``cudaGraphInstantiate`` analogue).  ``donate=False``
        keeps the payload of write-fed buffers after replay (values
        consumed inside the graph still invalidate their buffers)."""
        self._check_mutable()
        self._frozen = True
        return GraphExec(self, donate=donate)


# ---------------------------------------------------------------------------
# instantiated executable
# ---------------------------------------------------------------------------


class _Segment:
    __slots__ = ("device", "nodes", "chain", "queue", "in_syms", "out_syms", "donated_ixs",
                 "transfer_ixs", "exec_mode", "graph", "static_in", "outs", "recorded", "replays")

    def __init__(self, device, nodes, chain: int = 0):
        self.device = device
        self.nodes = nodes
        self.chain = chain  # SSA chain id on this device -> stream lane
        self.queue = None  # lane resolved at instantiate (_replay_lane)
        self.in_syms: "list[int]" = []
        self.out_syms: "list[int]" = []
        self.donated_ixs: "tuple[int, ...]" = ()
        self.transfer_ixs: "tuple[int, ...]" = ()  # input slots fed cross-device
        self.exec_mode = "fused"  # fused | staged
        # The segment's CUDA graph (fused on a card): its static inputs
        # (sym -> tensor the graph reads), its outputs in the graph's
        # memory, the kernel launches its capture recorded, its replays.
        self.graph: "torch.cuda.CUDAGraph | None" = None
        self.static_in: "dict[int, torch.Tensor]" = {}
        self.outs: "dict[int, torch.Tensor]" = {}
        self.recorded: "dict[str, int]" = {}
        self.replays = 0


class _FastPlan:
    """Pre-bound replay record: the staging order, commit decisions and
    fetch layout that replay would otherwise derive per call, resolved once
    at instantiate."""

    __slots__ = ("externs", "extern_bufs", "writes", "commit_sets", "commit_invs",
                 "fetch_plan", "commit_syms")

    def __init__(self, *, externs, writes, commit_sets, commit_invs, fetch_plan):
        self.externs = externs  # ((sym, Buffer), ...)
        self.extern_bufs = tuple(b for _, b in externs)
        self.writes = writes
        self.commit_sets = commit_sets  # ((Buffer, sym, planned producer device), ...)
        self.commit_invs = commit_invs  # buffers whose final value did not survive
        self.fetch_plan = fetch_plan  # ("read", node, sym) | ("launch", node, res_syms)
        # Every sym the commit reads.
        self.commit_syms = {s for _, s, _ in commit_sets}
        for kind, _, syms in fetch_plan:
            self.commit_syms.update([syms] if kind == "read" else syms)


class _Val(NamedTuple):
    """A value of one replay: its tensor, the CUDA stream its work ran on
    and the event ending that work (both None on the CPU), and whether the
    replay owns the tensor (fresh memory) or not (graph memory, a caller's
    tensor, a buffer's)."""

    tensor: "torch.Tensor"
    stream: "torch.cuda.Stream | None"
    event: "torch.cuda.Event | None"
    owned: bool


def _current_stream(device) -> "torch.cuda.Stream | None":
    return torch.cuda.current_stream(device.torch_device) if device.is_cuda else None


def _record(stream) -> "torch.cuda.Event | None":
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _resolve(dep) -> _Val:
    """A fan-out dependency ``(future, key)``: the future's value, or its
    entry ``key``."""
    fut, key = dep
    r = fut.get()
    return r if key is None else r[key]


class GraphExec:
    """A frozen, planned and (on CUDA) captured task graph
    (``cudaGraphExec_t``)."""

    def __init__(self, graph: TaskGraph, donate: bool = True):
        self.graph = graph
        self._donate = donate
        self._writes: "list[WriteNode]" = [n for n in graph._nodes if isinstance(n, WriteNode)]
        self._reads: "list[ReadNode]" = [n for n in graph._nodes if isinstance(n, ReadNode)]
        self._route_dev = self._route_device()
        self._queue = self._route_dev.ops_queue
        self._build_plan()
        # Placement spans segments AND plan inputs: a graph whose input
        # buffer lives on another device fans out even with one segment.
        placements = {s.device.key for s in self._segments}
        placements.update(b.device.key for b in graph._extern.values())
        placements.update(n.buf.device.key for n in self._writes)
        self._multi_device = len(placements) > 1
        self._fast = self._build_fast_plan()
        self._compile_segments()
        # Replays serialize.  The single-lane path holds the lock while
        # submitting; a replay on another lane parks on the previous one
        # (host) and its stream waits on the previous one's end (device).
        # The fan-out holds it until its join has committed.
        self._replay_lock = threading.Lock()
        self._last_replay: "Future | None" = None  # the last single-lane replay
        self._last_replay_queue = self._queue
        self._last_event: "torch.cuda.Event | None" = None  # the last replay's end
        # The fan-out's join: a stream that waits on every segment's end
        # and records the replay's end event there.
        devices = [s.device for s in self._segments] + [b.device for b in graph._buffers.values()]
        cards = [d for d in devices if d.is_cuda]
        self._join_stream = torch.cuda.Stream(cards[0].torch_device) if cards else None

    # -- planning ----------------------------------------------------------

    def _route_device(self):
        """The route device (the first launch's, else the first buffer's);
        a plan with a remote piece is refused."""
        g = self.graph
        devices = [n.device for n in g._nodes if isinstance(n, LaunchNode)]
        devices += [b.device for b in g._buffers.values()]
        if not devices:
            raise ValueError(f"TaskGraph '{g.name}' is empty")
        if any(getattr(d, "is_remote_proxy", False) for d in devices):
            raise NotImplementedError(f"remote graph segments are not ported yet ({_PARCELS})")
        return devices[0]

    def _build_plan(self) -> None:
        g = self.graph
        nodes = g._nodes

        # Stream assignment (DESIGN.md §11): every launch joins an SSA
        # *chain* — the chain of its first same-device producer, or a new
        # chain on its device when it has none (an independent head).
        producer_launch: "dict[int, LaunchNode]" = {}  # sym -> producing launch
        chain_counters: "dict[str, int]" = {}  # device.key -> next chain id
        chain_of: "dict[int, int]" = {}  # id(LaunchNode) -> chain
        for n in nodes:
            if not isinstance(n, LaunchNode):
                continue
            chain = None
            for a in n.arg_refs:
                if isinstance(a, _SymRef):
                    p = producer_launch.get(a.sym)
                    if p is not None and p.device.key == n.device.key:
                        chain = chain_of[id(p)]
                        break
            if chain is None:
                chain = chain_counters.get(n.device.key, 0)
                chain_counters[n.device.key] = chain + 1
            chain_of[id(n)] = chain
            for s in n.res_syms:
                producer_launch[s] = n

        # Segment = maximal run of launches on one (device, chain), i.e. on
        # one stream.
        self._segments: "list[_Segment]" = []
        for n in nodes:
            if not isinstance(n, LaunchNode):
                continue
            last = self._segments[-1] if self._segments else None
            if last is not None and last.device is n.device and last.chain == chain_of[id(n)]:
                last.nodes.append(n)
            else:
                self._segments.append(_Segment(n.device, [n], chain=chain_of[id(n)]))

        # Liveness: which segment consumes each sym, and what must survive.
        launch_use_segs: "dict[int, list[int]]" = {}
        for si, seg in enumerate(self._segments):
            for n in seg.nodes:
                for a in n.arg_refs:
                    if isinstance(a, _SymRef):
                        launch_use_segs.setdefault(a.sym, []).append(si)

        fetched: "set[int]" = {r.sym for r in self._reads}
        for n in nodes:
            if isinstance(n, LaunchNode) and n.out_bufs is None:
                fetched.update(n.res_syms)  # out-less launch: results fetched

        final_sym: "dict[int, int]" = dict(g._cur)  # id(buffer) -> final sym
        # Keep set: fetched values + terminal buffer values (final value
        # with no in-graph launch consumer).  A buffer whose final value IS
        # consumed in-graph is graph-internal.
        keep: "set[int]" = set(fetched)
        for s in final_sym.values():
            if not launch_use_segs.get(s):
                keep.add(s)
        self._keep = keep
        self._final_sym = final_sym
        # Fan-out when the plan has more than one segment: two segments
        # that both consume a sym may run concurrently, so "last consumer
        # donates" only holds when a sym's consumers all sit in one segment.
        self._fanout = len(self._segments) > 1

        # Per-segment interface: inputs (consumed, produced earlier) and
        # outputs (produced here, needed later or kept); write-fed inputs
        # the graph consumes and nothing keeps are *donated* to it.
        for si, seg in enumerate(self._segments):
            in_syms: "list[int]" = []
            seen: "set[int]" = set()
            local_produced: "set[int]" = set()
            for n in seg.nodes:
                for a in n.arg_refs:
                    if isinstance(a, _SymRef) and a.sym not in local_produced and a.sym not in seen:
                        seen.add(a.sym)
                        in_syms.append(a.sym)
                local_produced.update(n.res_syms)
            seg.in_syms = in_syms
            seg.out_syms = [
                s for n in seg.nodes for s in n.res_syms
                if s in keep or any(u > si for u in launch_use_segs.get(s, ()))
            ]
            if self._donate:
                donated = []
                for pos, s in enumerate(in_syms):
                    if s in g._extern:
                        continue  # replay re-reads extern buffers: never donate
                    if not g._sym_spec[s].shape:
                        continue  # 0-d values are never donated (as the reference)
                    if s in keep:
                        continue
                    if any(u > si for u in launch_use_segs.get(s, ())):
                        continue
                    if self._fanout and set(launch_use_segs.get(s, ())) != {si}:
                        continue  # a concurrent sibling segment also reads it
                    donated.append(pos)
                seg.donated_ixs = tuple(donated)
        self._donated_syms = {
            seg.in_syms[pos] for seg in self._segments for pos in seg.donated_ixs
        }

        # Cross-device edges -> explicit transfer steps (frozen percolation).
        # _prod_dev maps each sym to the device its value materializes on:
        # externs and writes on their buffer's device, launch results on
        # their segment's.  A segment input produced elsewhere gets a
        # transfer slot, copied onto the consuming segment's device on its
        # stream at replay.  _prod_dev also drives the commit-time re-home
        # of out buffers written on a foreign device.
        prod_dev: "dict[int, Any]" = {}
        for s, buf in g._extern.items():
            prod_dev[s] = buf.device
        for n in self._writes:
            prod_dev[n.sym] = n.buf.device
        for seg in self._segments:
            for n in seg.nodes:
                for s in n.res_syms:
                    prod_dev[s] = seg.device
        self._prod_dev = prod_dev
        self._transfers: "list[tuple[int, str, str]]" = []  # (sym, src key, dst key)
        for seg in self._segments:
            slots = []
            for pos, s in enumerate(seg.in_syms):
                src = prod_dev.get(s)
                if src is not None and src.key != seg.device.key:
                    slots.append(pos)
                    self._transfers.append((s, src.key, seg.device.key))
            seg.transfer_ixs = tuple(slots)

        # Stream lanes + event edges (DESIGN.md §11): each chain's lane on
        # its device; a sym produced by one segment and consumed by a
        # segment on another lane is an *event edge*, recorded at the
        # producer's tail and waited on by the consumer's stream.
        self._sym_seg: "dict[int, int]" = {}
        for si, seg in enumerate(self._segments):
            seg.queue = seg.device._replay_lane(seg.chain)
            for n in seg.nodes:
                for s in n.res_syms:
                    self._sym_seg[s] = si
        self._event_edges: "list[tuple[int, int, int]]" = []  # (producer, consumer, sym)
        for si, seg in enumerate(self._segments):
            for s in seg.in_syms:
                pi = self._sym_seg.get(s)
                if pi is not None and pi != si and self._segments[pi].queue is not seg.queue:
                    self._event_edges.append((pi, si, s))

    def _build_fast_plan(self) -> _FastPlan:
        """Freeze the commit decisions (set / invalidate per buffer, the
        device a set buffer is re-homed to) and the fetch layout into flat
        tuples."""
        g = self.graph
        env_syms = set(g._extern) | {n.sym for n in self._writes}
        for seg in self._segments:
            env_syms.update(seg.out_syms)
        commit_sets: list = []
        commit_invs: list = []
        for bid, s in self._final_sym.items():
            buf = g._buffers[bid]
            if s in g._extern:
                continue
            if s in env_syms and s not in self._donated_syms:
                commit_sets.append((buf, s, self._prod_dev.get(s)))
            else:
                commit_invs.append(buf)
        fetch_plan: list = []
        for n in g._nodes:
            if isinstance(n, ReadNode):
                fetch_plan.append(("read", n, n.sym))
            elif isinstance(n, LaunchNode) and n.out_bufs is None:
                fetch_plan.append(("launch", n, tuple(n.res_syms)))
        return _FastPlan(externs=tuple(g._extern.items()), writes=tuple(self._writes),
                         commit_sets=tuple(commit_sets), commit_invs=tuple(commit_invs),
                         fetch_plan=tuple(fetch_plan))

    # -- executors -----------------------------------------------------------

    @property
    def recorded_launches(self) -> "dict[str, int]":
        """Kernel launches the segments' CUDA graphs hold, by kernel
        package: what one replay of every graph runs on the device."""
        out: "dict[str, int]" = {}
        for seg in self._segments:
            for k, v in seg.recorded.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def graph_replays(self) -> int:
        """CUDA graph launches made by replays, summed over the segments."""
        return sum(seg.replays for seg in self._segments)

    def replayed_launches(self) -> "dict[str, int]":
        """Kernel launches the replays ran on the device through CUDA
        graphs (no wrapper counted them): each graph's recorded launches
        times its replays."""
        out: "dict[str, int]" = {}
        for seg in self._segments:
            for k, v in seg.recorded.items():
                out[k] = out.get(k, 0) + v * seg.replays
        return out

    @property
    def cuda_graphs(self) -> int:
        """Segments replayed through a CUDA graph of their own."""
        return sum(seg.graph is not None for seg in self._segments)

    def _run_segment(self, seg: _Segment, env: dict) -> None:
        """The segment's launches, eagerly, on the current stream; ``env``
        holds its inputs, its results are added."""
        for n in seg.nodes:
            vals = [env[a.sym] if isinstance(a, _SymRef) else a for a in n.arg_refs]
            for s, v in zip(n.res_syms, _results(n.bound(*vals))):
                env[s] = v

    def _replay_graph(self, seg: _Segment, env: dict) -> None:
        """Copy the segment's inputs into its static inputs (a transfer
        slot's copy is this one), launch its graph on the current stream;
        its outputs are the graph's own tensors."""
        for s, t in seg.static_in.items():
            if env[s] is not t:
                t.copy_(env[s], non_blocking=True)
        seg.graph.replay()
        env.update(seg.outs)

    def _zeros(self, syms, device) -> dict:
        spec = self.graph._sym_spec
        return {s: torch.zeros(spec[s].shape, dtype=spec[s].dtype, device=device.torch_device)
                for s in syms}

    def _compile_segments(self) -> None:
        """Build every kernel; on CUDA warm up, capture and choose each
        segment's executor (``REPRO_SEGMENT_COMPILE``, read once here)."""
        for seg in self._segments:
            for n in seg.nodes:  # nvcc / load, on the compile queue
                n.program.build(n.kernel, grid=n.grid, block=n.block).get()
        mode_env = os.environ.get("REPRO_SEGMENT_COMPILE", "auto").lower()
        streams: dict = {}  # card -> (warm-up stream, capture stream), shared by its segments
        for seg in self._segments:
            if not seg.device.is_cuda or mode_env == "staged":
                seg.exec_mode = "staged"
                continue
            dev = seg.device.torch_device
            if dev not in streams:
                # High priority for the capture: PyTorch hands out pooled
                # streams round-robin, and the port's other streams come
                # from the normal-priority pool, so no other thread's work
                # can land on a stream being captured.
                streams[dev] = torch.cuda.Stream(dev), torch.cuda.Stream(dev, priority=-1)
            self._capture(seg, *streams[dev])
            if mode_env == "auto" and len(seg.nodes) > 1 and self._calibrate(seg) == "staged":
                seg.exec_mode = "staged"
                seg.graph, seg.static_in, seg.outs, seg.recorded = None, {}, {}, {}

    def _capture(self, seg: _Segment, side, cap) -> None:
        """Warm the segment up on the ``side`` stream, then capture it into
        its own CUDA graph on the private stream ``cap`` of its card.
        Segments are captured one after another, on the instantiating
        thread."""
        dev = seg.device.torch_device
        caller = torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):  # warm-up: throwaway inputs, nothing committed
            self._run_segment(seg, self._zeros(seg.in_syms, seg.device))
        side.synchronize()
        transfers = {seg.in_syms[pos] for pos in seg.transfer_ixs}
        static_in: "dict[int, torch.Tensor]" = {}
        for s in seg.in_syms:
            pi = self._sym_seg.get(s)
            prod = self._segments[pi] if pi is not None else None
            if prod is not None and prod.graph is not None and s not in transfers:
                static_in[s] = prod.outs[s]  # read in place: the event edge orders it
            else:
                static_in.update(self._zeros([s], seg.device))  # outside the graph's pool
        cap.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        env = dict(static_in)
        with torch.cuda.device(dev), torch.cuda.stream(cap), tally_launches() as recorded:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._run_segment(seg, env)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; the first error is the one to raise
                raise
            graph.capture_end()
        seg.graph, seg.static_in = graph, static_in
        seg.outs = {s: env[s] for s in seg.out_syms}
        seg.recorded = dict(recorded)

    def _calibrate(self, seg: _Segment) -> str:
        """Time the segment's two executors on throwaway zero inputs and
        return the winner's mode.  Fresh inputs per trial, built and synced
        before the clock starts; min-of-N; ties go to fused.  Any trial
        failure, and inputs above ``_CAL_MAX_BYTES``, keep fused."""
        spec = self.graph._sym_spec
        if sum(int(np.prod(spec[s].shape)) * spec[s].dtype.itemsize
               for s in seg.in_syms) > _CAL_MAX_BYTES:
            return "fused"
        stream = torch.cuda.current_stream(seg.device.torch_device)

        def timed(fn):
            env = self._zeros(seg.in_syms, seg.device)
            stream.synchronize()
            t0 = time.perf_counter()
            fn(seg, env)
            stream.synchronize()
            return time.perf_counter() - t0

        try:
            timed(self._replay_graph), timed(self._run_segment)  # warm-up
            tf, ts = [], []
            for _ in range(_CAL_TRIALS):  # interleaved: drift hits both sides
                tf.append(timed(self._replay_graph))
                ts.append(timed(self._run_segment))
            if min(ts) * _CAL_FUSED_EDGE < min(tf):
                return "staged"
        except (RuntimeError, ValueError, TypeError):  # calibration must never break instantiate
            pass
        return "fused"

    # -- replay ------------------------------------------------------------

    def _stage_write(self, n: WriteNode, feeds, dst: "torch.Tensor | None"):
        """Resolve one write node's payload -> (tensor on its planned
        device, owned?).  With ``dst`` (a static input) the payload is
        copied into it; otherwise a conforming device tensor is used by
        reference (not owned) and anything else is copied into a fresh one
        (owned)."""
        data = n.data
        if feeds is not None:
            data = feeds.get(n, feeds.get(n.buf, data))
        if data is None:
            raise ValueError(
                f"write node for buffer gid={n.buf.gid} has no payload: "
                "record one at capture or pass feeds={node: data}"
            )
        dev = self._prod_dev[n.sym].torch_device
        src = _host_tensor(data)
        if tuple(src.shape) != n.buf.shape or src.dtype != n.buf.dtype:
            src = src.reshape(n.buf.shape).to(n.buf.dtype)
        if dst is None and src.device == dev and (dev.type == "cuda" or isinstance(data, torch.Tensor)):
            return src, False
        out = dst if dst is not None else torch.empty(n.buf.shape, dtype=n.buf.dtype, device=dev)
        pinned = src.device.type == "cpu" and src.is_pinned()
        out.copy_(src, non_blocking=pinned and out.is_cuda)
        return out, dst is None

    def _execute(self, feeds, block: bool, gate: "Future | None"):
        """One lane task of a single-segment, single-device plan: stage the
        inputs, run the executor, commit."""
        if gate is not None:
            gate.wait()  # the previous replay went down another lane
        stream = _current_stream(self._route_dev)
        if self._last_event is not None and stream is not None:
            stream.wait_event(self._last_event)
        p = self._fast
        seg = self._segments[0] if self._segments else None
        fused = seg is not None and seg.graph is not None
        statics = seg.static_in if fused else {}
        env: "dict[int, Any]" = {}
        owned: "set[int]" = set()
        for s, buf in p.externs:
            env[s] = buf._use()
        for n in p.writes:
            env[n.sym], fresh = self._stage_write(n, feeds, statics.get(n.sym))
            if fresh:
                owned.add(n.sym)
        if fused:
            self._replay_graph(seg, env)
            seg.replays += 1
        elif seg is not None:
            self._run_segment(seg, env)
            owned.update(s for n in seg.nodes for s in n.res_syms)
        if stream is not None and p.externs:
            ran = _record(stream)
            for buf in p.extern_bufs:  # a later in-place write elsewhere waits for this read
                buf._mark_read(ran)
        res, _, pinned = self._commit({s: _Val(env[s], stream, None, s in owned)
                                       for s in p.commit_syms})
        ev = _record(stream)
        self._last_event = ev
        if ev is not None and pinned and not block:
            ev.synchronize()  # host arrays must be filled when the future resolves
        return res, ev

    def _commit(self, env: "dict[int, _Val]"):
        """Commit buffer states (CUDA Graphs ownership rule), re-home a
        buffer whose final value materialized on another device, and
        gather the fetches.  Work on a value (a copy out of memory the
        replay does not own, a D2H read) is issued on the stream that made
        it.  Returns (result, the streams worked on, whether a fetch is a
        pending D2H copy)."""
        p = self._fast
        given: "dict[int, torch.Tensor]" = {}
        streams: "dict[int, torch.cuda.Stream]" = {}

        def on(v: _Val):
            if v.stream is not None:
                streams[id(v.stream)] = v.stream
            return torch.cuda.stream(v.stream)

        def handed(s):
            t = given.get(s)
            if t is None:
                v = env[s]
                if v.owned:
                    t = v.tensor
                else:
                    with on(v):
                        t = v.tensor.clone()
                given[s] = t
            return t

        for buf, s, prod in p.commit_sets:
            t = handed(s)
            with on(env[s]):
                buf._set_tensor(t)
            if prod is not None and prod is not buf.device:
                buf._rehome(prod)
        for buf in p.commit_invs:
            buf._invalidate()
        fetches: dict = {}
        reads: list = []
        pinned = False
        for kind, node, syms in p.fetch_plan:
            if kind == "read":
                v = env[syms]
                with on(v):
                    host = _to_host(v.tensor)
                pinned = pinned or v.tensor.is_cuda
                val = _to_host_value(host)
                fetches[node] = val
                reads.append(val)
            else:
                vals = [handed(s) for s in syms]
                fetches[node] = vals[0] if len(vals) == 1 else vals
        return GraphResult(fetches, reads), list(streams.values()), pinned

    # -- fan-out -------------------------------------------------------------

    def _read_extern(self, s: int, buf: Buffer) -> _Val:
        """Task on the extern's owning lane (after the eager work there):
        its live value on its planned device.  A spilled buffer is
        refetched (``_use``); one that moved since instantiate is copied
        back."""
        t = buf._use()
        planned = self._prod_dev[s]
        moved = buf.device.key != planned.key
        if moved:
            t = t.to(planned.torch_device, copy=True)
        stream = _current_stream(buf.device)
        return _Val(t, stream, _record(stream), moved)

    def _stage_writes(self, device, nodes, feeds) -> "dict[int, _Val]":
        """Task on a device's default lane: the payloads of its writes."""
        staged = {n.sym: self._stage_write(n, feeds, None) for n in nodes}
        stream = _current_stream(device)
        ev = _record(stream)
        return {s: _Val(t, stream, ev, owned) for s, (t, owned) in staged.items()}

    def _run_lane_segment(self, seg: _Segment, deps: list, gate, ends: list, si: int):
        """Task on the segment's lane: wait (host) until its producers are
        issued, make its stream wait on their events and on the previous
        replay's end, run its transfer steps and its executor, record its
        end event."""
        vals = [_resolve(d) for d in deps]
        stream = _current_stream(seg.device)
        if stream is not None and gate is not None:
            stream.wait_event(gate)
        for v in vals:
            if v.event is None or v.stream == stream:
                continue
            if stream is None:
                v.event.synchronize()  # a card's value read on the CPU
            else:
                stream.wait_event(v.event)
                v.tensor.record_stream(stream)
        env = {s: v.tensor for s, v in zip(seg.in_syms, vals)}
        if seg.graph is not None:
            self._replay_graph(seg, env)
            seg.replays += 1
        else:
            for pos in seg.transfer_ixs:
                s = seg.in_syms[pos]
                env[s] = env[s].to(seg.device.torch_device, copy=True)
            self._run_segment(seg, env)
        ends[si] = end = _record(stream)
        return {s: _Val(env[s], stream, end, seg.graph is None) for s in seg.out_syms}

    def _replay_fanout(self, feeds, block: bool, lane=None) -> "Future[GraphResult]":
        """Everything lane-bound is submitted synchronously, in capture
        order, from the calling thread: extern reads on their owning lanes,
        write staging on their devices' default lanes, then one task per
        segment on its chain's lane (or ``lane``, for a single segment).
        So eager work submitted after ``replay()`` returns runs after the
        replay's work on that lane.  A join on the host pool commits and
        resolves the single returned future; fences park the default lane
        of every device involved until then."""
        g = self.graph
        self._replay_lock.acquire()  # released by the join
        try:
            if self._last_replay is not None:
                self._last_replay.wait()  # a single-lane replay: its commit comes first
                self._last_replay = None
            gate = self._last_event
            vals: dict = {}  # sym -> (future, key)
            futs: "list[Future]" = []
            for s, buf in g._extern.items():
                f = buf.device.ops_queue.submit(self._read_extern, s, buf)
                futs.append(f)
                vals[s] = (f, None)
            by_dev: dict = {}
            for n in self._writes:
                d = self._prod_dev[n.sym]
                by_dev.setdefault(d.key, (d, []))[1].append(n)
            for d, nodes in by_dev.values():
                f = d.ops_queue.submit(self._stage_writes, d, nodes, feeds)
                futs.append(f)
                for n in nodes:
                    vals[n.sym] = (f, n.sym)
            ends: list = [None] * len(self._segments)
            for si, seg in enumerate(self._segments):
                q = seg.queue if lane is None else lane
                f = q.submit(self._run_lane_segment, seg, [vals[s] for s in seg.in_syms],
                             gate, ends, si)
                futs.append(f)
                for s in seg.out_syms:
                    vals[s] = (f, s)
        except BaseException:
            self._replay_lock.release()
            raise

        def _join() -> GraphResult:
            try:
                for f in futs:
                    f.wait()  # nothing of this replay runs past the lock
                for f in futs:
                    f.get()  # the first failure propagates
                res, streams, pinned = self._commit({s: _resolve(vals[s])
                                                     for s in self._fast.commit_syms})
                js = self._join_stream
                if js is not None:
                    for ev in [e for e in ends if e is not None] + [_record(s) for s in streams]:
                        js.wait_event(ev)
                    end = self._last_event = _record(js)
                    with torch.cuda.stream(js):
                        # a later in-place write waits for the reads
                        for buf in self._fast.extern_bufs:
                            buf._mark_read(end)
                    if block or pinned:
                        end.synchronize()
                return res
            finally:
                self._replay_lock.release()

        out: "Future[GraphResult]" = Future.from_concurrent(get_runtime().pool.submit(_join),
                                                             name=f"replay:{g.name}")
        fenced: "set[str]" = set()
        for dev in [seg.device for seg in self._segments] + [b.device for b in g._buffers.values()]:
            if dev.key not in fenced:
                fenced.add(dev.key)
                dev.ops_queue.submit(out.wait)
        return out

    def replay(self, feeds: "dict | None" = None, sync: str = "ready",
               stream=None) -> "Future[GraphResult]":
        """Execute the whole graph and resolve **one** ``Future``
        (``cudaGraphLaunch`` analogue).

        A single-segment plan on one device takes one task on the route
        device's default lane (or on ``stream``'s): stage feeds and externs
        into the static inputs, launch the graph, commit.  Any other plan
        fans out, each segment on its chain's lane (see the module
        docstring), joined through the one future.

        ``feeds`` overrides recorded write payloads, keyed by the
        ``WriteNode`` handle or by the target ``Buffer``.  ``sync="ready"``
        resolves at device completion of the replay; ``sync="dispatch"``
        once its work is enqueued (reads still wait for their copies).

        ``stream`` replays a single-segment graph on a caller-chosen stream
        of the route device (``cudaGraphLaunch(exec, stream)``).  A fan-out
        plan fixed its lanes at instantiate and refuses the override."""
        block = sync == "ready"
        if stream is not None and self._fanout:
            raise ValueError(
                f"GraphExec '{self.graph.name}' is a fan-out plan ({len(self._segments)} "
                "segments): its lanes were resolved at instantiate (one stream per "
                "chain) and cannot be overridden per replay — stream= applies to "
                "single-segment graphs only"
            )
        queue = self._queue if stream is None else stream._lane_for(self._route_dev)
        if self._multi_device or any(b.device is not self._route_dev
                                     for b in self._fast.extern_bufs):
            # Several devices, or an extern moved off the route device: its
            # read must run on its owner's lane.
            return self._replay_fanout(feeds, block, None if stream is None else queue)
        if self._fanout:
            return self._replay_fanout(feeds, block)
        with self._replay_lock:
            prev = self._last_replay
            gate = prev if self._last_replay_queue is not queue else None
            launched = queue.submit(self._execute, feeds, block, gate)
            self._last_replay = launched
            self._last_replay_queue = queue
        if block:
            return _settle(launched, lambda r: r, name=f"replay:{self.graph.name}")
        return launched.then(lambda r: r[0], executor="inline",
                             name=f"replay:{self.graph.name}")

    __call__ = replay

    def __repr__(self) -> str:
        nseg = len(self._segments)
        nk = sum(len(s.nodes) for s in self._segments)
        nlanes = len({id(s.queue) for s in self._segments})
        mode = "fan-out" if self._fanout else "multi-device" if self._multi_device else "pre-bound"
        ng = self.cuda_graphs
        where = "no CUDA graph" if ng == 0 else f"{ng} CUDA graph(s)"
        comp = "+".join(sorted({s.exec_mode for s in self._segments})) or "empty"
        per = ",".join(s.exec_mode for s in self._segments)
        return (
            f"GraphExec({self.graph.name}: {nk} launches -> {nseg} segment(s) "
            f"on {nlanes} stream(s), {len(self._transfers)} transfer(s), "
            f"{len(self._event_edges)} event edge(s), {mode}, {where}, compile={comp} [{per}])"
        )


_CAL_TRIALS = 3
_CAL_MAX_BYTES = 256 << 20  # segments above this skip trials (alloc churn)
_CAL_FUSED_EDGE = 1.05  # prefer fused within 5%
