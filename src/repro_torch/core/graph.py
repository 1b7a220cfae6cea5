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
  * ``instantiate()`` plans the DAG as the reference does (SSA chains,
    segments, the keep set, event edges), then, on a CUDA device, runs
    every segment once eagerly on a side stream on throwaway inputs (the
    warm-up: libraries loaded, cuBLAS handles made, nothing committed) and
    captures the WHOLE plan into one ``torch.cuda.CUDAGraph``.  Independent
    chains become branches of that graph, forked from and joined to the
    capture stream by events.  Every write and every extern input gets a
    static input tensor.
  * ``replay()`` copies the feeds and the live value of every extern
    buffer into the static inputs on the replay stream, launches the graph
    once, commits the buffers and resolves **one** ``Future``.

Per-plan executor (``REPRO_SEGMENT_COMPILE=fused|staged|auto``): ``fused``
is the CUDA graph, ``staged`` the plan's launches run eagerly in capture
order on the replay lane.  ``auto`` times both once at instantiate on zero
inputs and keeps the faster (ties, and any failed trial, keep ``fused``).
The segments of a plan share one graph, so they share the choice; every
segment's ``exec_mode`` shows it, and so does ``repr``.  A CPU device has
no CUDA graph: its plans replay ``staged`` with the same bookkeeping.  A
capture that fails raises; it never falls back to eager.

Correspondence: capture <-> ``cudaStreamBeginCapture``; ``GraphExec`` <->
``cudaGraphExec_t``; ``replay`` <-> ``cudaGraphLaunch``; feeds copied into
the static inputs <-> ``cudaGraphExecKernelNodeSetParams``; chain ->
branch of the graph <-> ``cudaGraph`` node-to-stream assignment.

Ownership rule (CUDA Graphs'): a buffer whose final value is consumed by a
later in-graph launch and does not survive the plan is *graph-internal* —
after ``replay()`` it is invalidated and reads raise until it is written
again.  Extern inputs are read, never consumed, so a ``GraphExec`` can be
replayed any number of times.  Values the graph hands out (a kept
buffer's value, an out-less launch's result) are copies out of the
graph's memory: a later replay does not change them.

Not ported, and refused: plans over several devices and cross-device
transfer steps (ROADMAP.md Queue 1 item 6b), remote buffers and remote
segments (Queue 1 item 10).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.buffer import Buffer, _host_tensor, _settle, _to_host_value
from repro_torch.core.futures import Future
from repro_torch.kernels import tally_launches

__all__ = ["TaskGraph", "GraphExec", "GraphResult", "LaunchNode", "ReadNode", "WriteNode",
           "capture", "current_graph"]

_MULTI_DEVICE = "ROADMAP.md Queue 1 item 6b"
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
                 "exec_mode")

    def __init__(self, device, nodes, chain: int = 0):
        self.device = device
        self.nodes = nodes
        self.chain = chain  # SSA chain id on this device -> stream lane / graph branch
        self.queue = None  # lane resolved at instantiate (_replay_lane)
        self.in_syms: "list[int]" = []
        self.out_syms: "list[int]" = []
        self.donated_ixs: "tuple[int, ...]" = ()
        self.exec_mode = "fused"  # fused | staged


class _FastPlan:
    """Pre-bound replay record: the staging order, commit decisions and
    fetch layout that replay would otherwise derive per call, resolved once
    at instantiate."""

    __slots__ = ("externs", "writes", "commit_sets", "commit_invs", "keep_externs",
                 "fetch_plan")

    def __init__(self, *, externs, writes, commit_sets, commit_invs, keep_externs, fetch_plan):
        self.externs = externs  # ((sym, Buffer), ...)
        self.writes = writes
        self.commit_sets = commit_sets  # ((Buffer, sym), ...)
        self.commit_invs = commit_invs  # buffers whose final value did not survive
        self.keep_externs = keep_externs
        self.fetch_plan = fetch_plan  # ("read", node, sym) | ("launch", node, res_syms)


class _CudaPlan:
    """The captured graph: its static inputs (plan inputs consumed by a
    launch) and its outputs in the graph's memory."""

    __slots__ = ("graph", "static_in", "outs")

    def __init__(self, graph, static_in, outs):
        self.graph = graph
        self.static_in = static_in  # sym -> tensor (written at every replay)
        self.outs = outs  # sym -> tensor in the graph's memory


class GraphExec:
    """A frozen, planned and (on CUDA) captured task graph
    (``cudaGraphExec_t``)."""

    def __init__(self, graph: TaskGraph, donate: bool = True):
        self.graph = graph
        self._donate = donate
        self._writes: "list[WriteNode]" = [n for n in graph._nodes if isinstance(n, WriteNode)]
        self._reads: "list[ReadNode]" = [n for n in graph._nodes if isinstance(n, ReadNode)]
        self._route_dev = self._single_device()
        self._queue = self._route_dev.ops_queue
        self._build_plan()
        self._fast = self._build_fast_plan()
        self._cuda: "_CudaPlan | None" = None
        # Kernel launches the captured graph holds, by kernel package (what
        # every replay runs on the device), and the replays made of it.
        self.recorded_launches: "dict[str, int]" = {}
        self.graph_replays = 0
        self._compile_segments()
        # Replays serialize: a replay's staging into the static inputs must
        # follow the previous replay's commit.  The lock is held while
        # submitting; a replay on another lane parks on the previous one
        # (host) and its stream waits on the previous one's end (device).
        self._replay_lock = threading.Lock()
        self._last_replay: "Future | None" = None
        self._last_replay_queue = self._queue
        self._last_event: "torch.cuda.Event | None" = None

    # -- planning ----------------------------------------------------------

    def _single_device(self):
        """The one device of the plan; a plan over several devices, or
        with a remote piece, is refused."""
        g = self.graph
        devices = [n.device for n in g._nodes if isinstance(n, LaunchNode)]
        devices += [b.device for b in g._buffers.values()]
        if not devices:
            raise ValueError(f"TaskGraph '{g.name}' is empty")
        if any(getattr(d, "is_remote_proxy", False) for d in devices):
            raise NotImplementedError(f"remote graph segments are not ported yet ({_PARCELS})")
        keys = sorted({d.key for d in devices})
        if len(keys) > 1:
            raise NotImplementedError(
                f"TaskGraph '{g.name}' spans devices {keys}: multi-device plans and their "
                f"transfer steps are not ported yet ({_MULTI_DEVICE}); capture one device's work")
        return devices[0]

    def _build_plan(self) -> None:
        g = self.graph
        nodes = g._nodes

        # Stream assignment (DESIGN.md §11): every launch joins an SSA
        # *chain* — the chain of its first producer, or a new chain when it
        # has none (an independent head).
        producer_launch: "dict[int, LaunchNode]" = {}  # sym -> producing launch
        chain_of: "dict[int, int]" = {}  # id(LaunchNode) -> chain
        next_chain = 0
        for n in nodes:
            if not isinstance(n, LaunchNode):
                continue
            chain = None
            for a in n.arg_refs:
                if isinstance(a, _SymRef):
                    p = producer_launch.get(a.sym)
                    if p is not None:
                        chain = chain_of[id(p)]
                        break
            if chain is None:
                chain, next_chain = next_chain, next_chain + 1
            chain_of[id(n)] = chain
            for s in n.res_syms:
                producer_launch[s] = n

        # Segment = maximal run of launches on one chain.
        self._segments: "list[_Segment]" = []
        for n in nodes:
            if not isinstance(n, LaunchNode):
                continue
            last = self._segments[-1] if self._segments else None
            if last is not None and last.chain == chain_of[id(n)]:
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
                        continue  # a sibling segment also reads it
                    donated.append(pos)
                seg.donated_ixs = tuple(donated)
        self._donated_syms = {
            seg.in_syms[pos] for seg in self._segments for pos in seg.donated_ixs
        }

        # Stream lanes + event edges (DESIGN.md §11): each chain's lane on
        # the device; a sym produced by one segment and consumed by a
        # segment of another chain is an *event edge*, recorded at the
        # producer's tail and waited on by the consumer's stream (in the
        # captured graph: an edge between two branches).
        sym_seg: "dict[int, int]" = {}
        for si, seg in enumerate(self._segments):
            seg.queue = seg.device._replay_lane(seg.chain)
            for n in seg.nodes:
                for s in n.res_syms:
                    sym_seg[s] = si
        self._event_edges: "list[tuple[int, int, int]]" = []  # (producer, consumer, sym)
        for si, seg in enumerate(self._segments):
            for s in seg.in_syms:
                pi = sym_seg.get(s)
                if pi is not None and pi != si and self._segments[pi].queue is not seg.queue:
                    self._event_edges.append((pi, si, s))

    def _build_fast_plan(self) -> _FastPlan:
        """Freeze the commit decisions (set / invalidate / keep per buffer)
        and the fetch layout into flat tuples."""
        g = self.graph
        env_syms = set(g._extern) | {n.sym for n in self._writes}
        for seg in self._segments:
            env_syms.update(seg.out_syms)
        commit_sets: list = []
        commit_invs: list = []
        keep_externs: list = []
        for bid, s in self._final_sym.items():
            buf = g._buffers[bid]
            if s in g._extern:
                if s in self._keep:
                    keep_externs.append(s)
                continue
            if s in env_syms and s not in self._donated_syms:
                commit_sets.append((buf, s))
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
                         keep_externs=tuple(keep_externs), fetch_plan=tuple(fetch_plan))

    # -- executors -----------------------------------------------------------

    def _launch_inputs(self) -> "list[int]":
        """Plan inputs a launch consumes (externs and writes), in first-use
        order: the static inputs of the captured graph."""
        produced = {s for seg in self._segments for n in seg.nodes for s in n.res_syms}
        out: "list[int]" = []
        for seg in self._segments:
            for s in seg.in_syms:
                if s not in produced and s not in out:
                    out.append(s)
        return out

    def _out_syms(self) -> "list[int]":
        return [s for seg in self._segments for s in seg.out_syms]

    def _run_segment(self, seg: _Segment, env: dict) -> None:
        for n in seg.nodes:
            vals = [env[a.sym] if isinstance(a, _SymRef) else a for a in n.arg_refs]
            for s, v in zip(n.res_syms, _results(n.bound(*vals))):
                env[s] = v

    def _staged(self, env: dict) -> dict:
        """The plan's launches, eagerly, in capture order on the current
        stream; ``env`` holds the plan inputs, the outputs are added."""
        for seg in self._segments:
            self._run_segment(seg, env)
        return env

    def _fused(self, env: dict) -> dict:
        """Copy the plan inputs into the static inputs, launch the graph;
        the outputs are the graph's own tensors."""
        cp = self._cuda
        for s, t in cp.static_in.items():
            if env[s] is not t:
                t.copy_(env[s], non_blocking=True)
        cp.graph.replay()
        self.graph_replays += 1
        env.update(cp.outs)
        return env

    def _zeros(self, syms) -> dict:
        dev = self._route_dev.torch_device
        return {s: torch.zeros(self.graph._sym_spec[s].shape, dtype=self.graph._sym_spec[s].dtype,
                               device=dev) for s in syms}

    def _compile_segments(self) -> None:
        """Build every kernel; on CUDA warm up, capture, and choose the
        executor (``REPRO_SEGMENT_COMPILE``)."""
        for seg in self._segments:
            for n in seg.nodes:  # nvcc / load, on the compile queue
                n.program.build(n.kernel, grid=n.grid, block=n.block).get()
        if not self._segments:
            return
        if not self._route_dev.is_cuda:
            for seg in self._segments:
                seg.exec_mode = "staged"
            return
        self._capture()
        mode_env = os.environ.get("REPRO_SEGMENT_COMPILE", "auto").lower()
        if mode_env == "fused" or all(len(seg.nodes) < 2 for seg in self._segments):
            return
        mode = "staged" if mode_env == "staged" else _calibrate(self)
        for seg in self._segments:
            seg.exec_mode = mode

    def _capture(self) -> None:
        """Warm up on a side stream, then capture the whole plan into one
        CUDA graph on private streams: chain 0 on the capture stream, each
        other chain on a branch forked from it by an event and joined back
        at the end; event edges become waits between branches."""
        dev = self._route_dev.torch_device
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):  # warm-up: throwaway inputs, nothing committed
            for seg in self._segments:
                self._run_segment(seg, self._zeros(seg.in_syms))
        side.synchronize()
        static_in = self._zeros(self._launch_inputs())  # outside the graph's pool
        chains = sorted({seg.chain for seg in self._segments})
        # High priority: PyTorch hands out pooled streams round-robin, and
        # the port's other streams come from the normal-priority pool, so
        # no other thread's work can land on a stream being captured.
        streams = {c: torch.cuda.Stream(dev, priority=-1) for c in chains}
        cap = streams[chains[0]]
        cap.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        env = dict(static_in)
        with torch.cuda.stream(cap), tally_launches() as recorded:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fork = torch.cuda.Event()
                fork.record(cap)
                for c in chains[1:]:
                    streams[c].wait_event(fork)
                ends: "dict[int, torch.cuda.Event]" = {}
                for si, seg in enumerate(self._segments):
                    st = streams[seg.chain]
                    for pi, ci, _ in self._event_edges:
                        if ci == si:
                            st.wait_event(ends[pi])
                    with torch.cuda.stream(st):
                        self._run_segment(seg, env)
                    ends[si] = torch.cuda.Event()
                    ends[si].record(st)
                for c in chains[1:]:
                    cap.wait_stream(streams[c])
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; the first error is the one to raise
                raise
            graph.capture_end()
        self.recorded_launches = dict(recorded)
        self._cuda = _CudaPlan(graph, static_in, {s: env[s] for s in self._out_syms()})

    # -- replay ------------------------------------------------------------

    def _stage_write(self, n: WriteNode, feeds, dst: "torch.Tensor | None"):
        """Resolve one write node's payload -> (device tensor, owned?).
        With ``dst`` (a static input) the payload is copied into it;
        otherwise a conforming device tensor is used by reference (not
        owned) and anything else is copied into a fresh one (owned)."""
        data = n.data
        if feeds is not None:
            data = feeds.get(n, feeds.get(n.buf, data))
        if data is None:
            raise ValueError(
                f"write node for buffer gid={n.buf.gid} has no payload: "
                "record one at capture or pass feeds={node: data}"
            )
        dev = self._route_dev.torch_device
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
        """One lane task: stage the inputs, run the executor, commit."""
        if gate is not None:
            gate.wait()  # the previous replay went down another lane
        fused = self._cuda is not None and self._segments[0].exec_mode == "fused"
        if self._last_event is not None and self._route_dev.is_cuda:
            torch.cuda.current_stream(self._route_dev.torch_device).wait_event(self._last_event)
        p = self._fast
        statics = self._cuda.static_in if fused else {}
        env: "dict[int, Any]" = {}
        owned: "set[int]" = set()
        for s, buf in p.externs:
            env[s] = buf._use()
        for n in p.writes:
            env[n.sym], fresh = self._stage_write(n, feeds, statics.get(n.sym))
            if fresh:
                owned.add(n.sym)
        if fused:
            self._fused(env)
        else:
            self._staged(env)
            owned.update(s for seg in self._segments for n in seg.nodes for s in n.res_syms)
        if self._route_dev.is_cuda and p.externs:
            ran = torch.cuda.Event()
            ran.record(torch.cuda.current_stream(self._route_dev.torch_device))
            for _, buf in p.externs:  # a later in-place write elsewhere waits for this read
                buf._mark_read(ran)
        return self._commit(env, owned, block)

    def _commit(self, env: dict, owned: "set[int]", block: bool):
        """Commit buffer states (CUDA Graphs ownership rule) and gather the
        fetches; a device value handed out that this replay does not own
        (the graph's memory, a caller's tensor) is copied first."""
        p = self._fast
        given: "dict[int, Any]" = {}

        def handed(s):
            v = given.get(s)
            if v is None:
                v = given[s] = env[s] if s in owned else env[s].clone()
            return v

        for buf, s in p.commit_sets:
            buf._set_tensor(handed(s))
        for buf in p.commit_invs:
            buf._invalidate()
        fetches: dict = {}
        reads: list = []
        pinned = []
        for kind, node, syms in p.fetch_plan:
            if kind == "read":
                t = env[syms]
                if t.is_cuda:
                    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    pinned.append(host)
                else:
                    host = t.clone()
                val = _to_host_value(host)
                fetches[node] = val
                reads.append(val)
            else:
                vals = [handed(s) for s in syms]
                fetches[node] = vals[0] if len(vals) == 1 else vals
        ev = None
        if self._route_dev.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._route_dev.torch_device))
            self._last_event = ev
            if pinned and not block:
                ev.synchronize()  # host arrays must be filled when the future resolves
        return GraphResult(fetches, reads), ev

    def replay(self, feeds: "dict | None" = None, sync: str = "ready",
               stream=None) -> "Future[GraphResult]":
        """Execute the whole graph and resolve **one** ``Future``
        (``cudaGraphLaunch`` analogue).  One task on the route device's
        default lane (or on ``stream``'s): stage feeds and externs into
        the static inputs, launch the graph, commit.

        ``feeds`` overrides recorded write payloads, keyed by the
        ``WriteNode`` handle or by the target ``Buffer``.  ``sync="ready"``
        resolves at device completion of the replay; ``sync="dispatch"``
        once its work is enqueued (reads still wait for their copies).

        ``stream`` replays a single-segment graph on a caller-chosen stream
        of the route device (``cudaGraphLaunch(exec, stream)``).  A fan-out
        plan fixed its chains at instantiate and refuses the override."""
        block = sync == "ready"
        if stream is not None and self._fanout:
            raise ValueError(
                f"GraphExec '{self.graph.name}' is a fan-out plan ({len(self._segments)} "
                "segments): its lanes were resolved at instantiate (one branch per "
                "chain) and cannot be overridden per replay — stream= applies to "
                "single-segment graphs only"
            )
        queue = self._queue if stream is None else stream._lane_for(self._route_dev)
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
        ne = len(self._event_edges)
        mode = "fan-out" if self._fanout else "pre-bound"
        comp = "+".join(sorted({s.exec_mode for s in self._segments})) or "empty"
        where = "one CUDA graph" if self._cuda is not None else "no CUDA graph"
        return (
            f"GraphExec({self.graph.name}: {nk} launches -> {nseg} segment(s) "
            f"on {nlanes} stream(s), {ne} event edge(s), {mode}, {where}, compile={comp})"
        )


_CAL_TRIALS = 3
_CAL_MAX_BYTES = 256 << 20  # plans above this skip trials (alloc churn)
_CAL_FUSED_EDGE = 1.05  # prefer fused within 5%


def _calibrate(exe: GraphExec) -> str:
    """Time both executors on throwaway zero inputs and return the
    winner's mode.  Fresh inputs per trial, built and synced before the
    clock starts; min-of-N; ties go to fused.  Any trial failure keeps
    fused."""
    syms = exe._launch_inputs()
    spec = exe.graph._sym_spec
    if sum(int(np.prod(spec[s].shape)) * spec[s].dtype.itemsize for s in syms) > _CAL_MAX_BYTES:
        return "fused"
    stream = torch.cuda.current_stream(exe._route_dev.torch_device)

    def timed(fn):
        env = exe._zeros(syms)
        stream.synchronize()
        t0 = time.perf_counter()
        fn(env)
        stream.synchronize()
        return time.perf_counter() - t0

    try:
        timed(exe._fused), timed(exe._staged)  # warm-up
        tf, ts = [], []
        for _ in range(_CAL_TRIALS):  # interleaved: drift hits both sides
            tf.append(timed(exe._fused))
            ts.append(timed(exe._staged))
        if min(ts) * _CAL_FUSED_EDGE < min(tf):
            return "staged"
    except (RuntimeError, ValueError, TypeError):  # calibration must never break instantiate
        pass
    return "fused"
