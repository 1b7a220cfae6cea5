"""Program: device code built at run time (paper §4, Fig. 2 ``program``).

A program is a named set of kernels — Python callables on tensors, as the
``KERNELS`` registries of ``repro_torch.kernels.*.ops`` define them.  A
callable that is backed by hand-written CUDA names its library in a
``cuda_library`` attribute.  ``build`` is the NVRTC analogue: on the
device's *compile* queue it binds the kernel to its launch geometry and
makes sure its CUDA library is compiled (``nvcc``) and loaded, so building
overlaps data transfers exactly as in Listing 2 (copies and ``prog.build``
futures run concurrently, joined by ``wait_all``).

Launch semantics keep HPXCL's user-visible tuning knobs: ``grid`` and
``block`` (``Dim3``) are forwarded to kernels that accept them, and the
hand-written kernels launch with exactly that CUDA geometry.

A launch runs on a stream's lane, inside that stream's CUDA stream.  The
kernel wrapper allocates a fresh output tensor, and each ``out`` buffer is
rebound to it.  So a launch whose ``out`` is its own input (the stencil
of fig 3) never races on the input it still reads.

Graph capture: inside a ``capture()`` region ``run`` records a launch node
instead (``repro_torch.core.graph``).

Percolation: ``run`` executes where the program's device is; argument
buffers living on other devices are first copied there (futures, never
blocking the caller), and a host ``np.ndarray`` argument is copied to the
device at launch.

Any kernel on any (local or remote) device: ``run_on_any`` lets a
placement scheduler (``repro_torch.core.scheduler``) pick the device and
launches through the program's sibling there (``for_device``: one program
object, and one build cache, a device key; siblings on logical devices of
one card share the loaded CUDA library; a sibling on a remote locality is
a ``RemoteProgram``).  ``cluster`` (a parcel port) widens the fleet to
every locality the port reaches.

Remote programs (DESIGN.md §10): ``RemoteProgram`` is the proxy of a
program owned by another locality.  Its kernels travel by name; a launch
is one ``launch`` parcel whose buffer arguments on that locality go as GID
references and everything else as host values.
"""
from __future__ import annotations

import importlib.util
import inspect
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.buffer import Buffer, _current_event, _host_tensor, _settle
from repro_torch.core.futures import Future, dataflow

__all__ = ["Dim3", "Program", "RemoteProgram"]


def _is_remote_buffer(a: Any) -> bool:
    return getattr(a, "is_remote_buffer", False)


@dataclass
class Dim3:
    """CUDA-style launch geometry, kept user-visible (paper's philosophy)."""

    x: int = 1
    y: int = 1
    z: int = 1

    def as_tuple(self) -> "tuple[int, int, int]":
        return (self.x, self.y, self.z)


def _normalize_dim(d) -> "tuple[int, ...] | None":
    if d is None:
        return None
    if isinstance(d, Dim3):
        return d.as_tuple()
    if isinstance(d, int):
        return (d, 1, 1)
    return tuple(d)


class Program:
    """A named set of kernels built on demand for one device."""

    def __init__(self, device, kernels, name: str = "program"):
        from repro_torch.core import agas

        if callable(kernels) and not isinstance(kernels, dict):
            kernels = {getattr(kernels, "__name__", "kernel"): kernels}
        self.device = device
        self.name = name
        self._kernels: "dict[str, Callable]" = dict(kernels)
        self._build_futures: "dict[tuple, Future]" = {}
        # Hot-path caches: geometry-kwarg names per kernel (inspect.signature
        # once, not per launch) and bound callables per (name, grid, block).
        self._geo_params: "dict[str, tuple[bool, bool]]" = {}
        self._bound_cache: "dict[tuple, Callable]" = {}
        self._siblings: "dict[str, Program]" = {}
        self.gid = agas.registry.register(self, agas.Placement(device.key, 0), kind="program")
        self._finalizer = weakref.finalize(self, agas.registry.retire, self.gid)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_file(device, path: str) -> "Program":
        """Load kernels from a python source file defining ``KERNELS``.

        This is the percolation path for *code*: source is loaded and
        built at the device that will execute it
        (``create_program_with_file("kernel.cu")`` analogue).
        """
        spec = importlib.util.spec_from_file_location(f"repro_torch_kernel_{abs(hash(path))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        kernels = getattr(mod, "KERNELS", None)
        if kernels is None:
            raise ValueError(f"{path} does not define KERNELS = {{name: callable}}")
        return Program(device, kernels, name=path)

    def kernel_names(self) -> "list[str]":
        return sorted(self._kernels)

    def for_device(self, device) -> "Program":
        """This program's sibling on ``device`` (cached; ``self`` at home).
        Siblings share the kernel callables but keep their own build
        caches, built on their own device's compile queue."""
        if device is self.device or device.key == self.device.key:
            return self
        sib = self._siblings.get(device.key)
        if sib is None:
            cls = RemoteProgram if getattr(device, "is_remote_proxy", False) else Program
            sib = cls(device, self._kernels, name=f"{self.name}@{device.key}")
            sib = self._siblings.setdefault(device.key, sib)  # a racing creator loses
        return sib

    # -- build (the NVRTC analogue) --------------------------------------------

    def _geometry_of(self, name: str) -> "tuple[bool, bool]":
        """(accepts_grid, accepts_block) — computed once per kernel."""
        geo = self._geo_params.get(name)
        if geo is None:
            params = inspect.signature(self._kernels[name]).parameters
            geo = self._geo_params[name] = ("grid" in params, "block" in params)
        return geo

    def _bind(self, name: str, grid, block) -> Callable:
        """Bound callable for (kernel, normalized grid/block), cached."""
        grid_n, block_n = _normalize_dim(grid), _normalize_dim(block)
        bkey = (name, grid_n, block_n)
        bound = self._bound_cache.get(bkey)
        if bound is not None:
            return bound
        fn = self._kernels[name]
        has_grid, has_block = self._geometry_of(name)
        kwargs = {}
        if has_grid:
            kwargs["grid"] = grid_n
        if has_block:
            kwargs["block"] = block_n
        if kwargs:
            bound = lambda *args: fn(*args, **kwargs)  # noqa: E731
            bound.__name__ = name
        else:
            bound = fn
        self._bound_cache[bkey] = bound
        return bound

    def _compile(self, name: str, grid, block) -> Callable:
        bound = self._bind(name, grid, block)
        lib = getattr(self._kernels[name], "cuda_library", None)
        if lib is not None and self.device.is_cuda:
            from repro_torch.kernels import _build

            _build.load(lib)
        return bound

    def build(self, name: str, *specs, grid=None, block=None) -> Future:
        """Build kernel ``name`` asynchronously on the compile queue; future
        of the bound callable, cached per (kernel, shapes, grid, block).
        ``specs`` (tensors or anything with ``shape``/``dtype``) only key
        the cache: the CUDA libraries are not specialized per shape."""
        if name not in self._kernels:
            return Future.failed(KeyError(f"no kernel '{name}' in {self.name}"))
        sig = tuple((tuple(s.shape), s.dtype) for s in specs)
        key = (name, sig, _normalize_dim(grid), _normalize_dim(block))
        fut = self._build_futures.get(key)
        if fut is None:
            fut = self._build_futures.setdefault(
                key, self.device.compile_queue.submit(self._compile, name, grid, block)
            )
        return fut

    # -- launch -----------------------------------------------------------------

    def run(
        self,
        args: "Sequence[Buffer | Any]",
        name: str,
        grid=None,
        block=None,
        out: "Sequence[Buffer] | None" = None,
        sync: str = "ready",
        stream=None,
    ):
        """Launch kernel ``name`` with buffer/tensor ``args`` (async).

        ``out``: buffers rebound to the kernel's results — the future
        resolves to them.  Without ``out`` the future resolves to the raw
        result tensors.  ``sync="ready"`` resolves at device completion
        (the CUDA event recorded after the launch); ``sync="dispatch"``
        resolves once the launch is enqueued on the CUDA stream.
        ``stream`` scopes the submission order; ``None`` means the
        device's default stream.

        Inside a ``repro_torch.core.graph.capture()`` region the launch is
        *recorded*, not executed: the return value is then the graph node,
        and execution happens at ``replay()`` (capture ignores ``stream``:
        ``instantiate`` assigns each chain its lane itself).
        """
        from repro_torch.core.graph import current_graph

        g = current_graph()
        if g is not None:
            return g.run(self, args, name, grid=grid, block=block, out=out)
        home = self.device
        queue = home.ops_queue if stream is None else stream._lane_for(home)

        # Percolation: move foreign buffers to the program's device first.
        # A RemoteBuffer is always foreign to a local program: its move is
        # an explicit cross-locality transfer (a read parcel, then a copy).
        moved: "dict[int, Future] | None" = None
        for i, a in enumerate(args):
            if (isinstance(a, Buffer) and a.device is not home) or _is_remote_buffer(a):
                if moved is None:
                    moved = {}
                moved[i] = a.copy_to(home)

        build_fut = self.build(name, grid=grid, block=block)

        def _launch(compiled, *resolved_args):
            arg_list = list(args)
            if moved:
                for i, b in zip(moved.keys(), resolved_args):
                    arg_list[i] = b
            vals = [a._use() if isinstance(a, Buffer)
                    else _host_tensor(a).to(home.torch_device) if isinstance(a, np.ndarray)
                    else a for a in arg_list]
            res = compiled(*vals)
            res_list = list(res) if isinstance(res, (tuple, list)) else [res]
            ev = next((e for e in map(_current_event, res_list) if e is not None), None)
            for a in arg_list:
                if isinstance(a, Buffer):
                    a._mark_read(ev)
            if out is None:
                return res, ev
            if len(res_list) != len(out):
                raise ValueError(
                    f"kernel '{name}' returned {len(res_list)} tensors for {len(out)} out buffers"
                )
            for b, v in zip(out, res_list):
                b._set_tensor(v, ev)
                b._rehome(home)
            return list(out), ev

        # Order: (copies, build) -> lane launch.  Non-percolating launches
        # enqueue on the lane *now* (an unbuilt kernel parks the lane worker
        # on its build future; the compile queue never depends on a lane,
        # so this cannot deadlock).  Percolating launches must not block
        # the lane (the copy lands on the default lane), so they join via
        # dataflow off-lane.
        if moved is None:
            if build_fut.done():
                launched = queue.submit(_launch, build_fut.get())
            else:
                launched = queue.submit(lambda: _launch(build_fut.get()))
        else:

            def _enqueue(compiled, *resolved):
                return queue.submit(_launch, compiled, *resolved).get()

            launched = dataflow(_enqueue, build_fut, *moved.values(), name=f"run:{name}")

        if sync == "dispatch":
            fut = launched.then(lambda r: r[0], executor="inline", name=f"dispatched:{name}")
        else:
            fut = _settle(launched, lambda r: r, name=f"done:{name}")
        if stream is not None and moved is not None:
            # The launch reaches the lane only after its copies: make
            # stream events recorded before then cover it.
            stream._note_completion(fut)
        return fut

    def launch(
        self,
        args: "Sequence[Buffer | Any]",
        name: str,
        grid=None,
        block=None,
        out: "Sequence[Buffer] | None" = None,
        sync: str = "ready",
        stream=None,
    ):
        """``run`` under its CUDA name — ``prog.launch([...], "k",
        stream=s)`` submits the kernel on stream ``s`` (``<<<grid, block,
        0, stream>>>``).  Identical semantics to ``run``."""
        return self.run(args, name, grid=grid, block=block, out=out, sync=sync, stream=stream)

    def run_on_any(
        self,
        args: "Sequence[Buffer | Any]",
        name: str,
        grid=None,
        block=None,
        out: "Sequence[Buffer] | None" = None,
        sync: str = "ready",
        scheduler=None,
        cluster=None,
    ):
        """Launch kernel ``name`` on whatever device the placement policy
        picks: the paper's "any kernel on any device".

        The scheduler (default: the process scheduler, ``least_loaded``)
        chooses from its fleet; the launch runs through the sibling program
        there, foreign argument buffers percolate over and ``out`` buffers
        are re-homed to the chosen device.  With stealing on and more than
        one device, the launch parks in the scheduler's steal pool, where an
        idle sibling may take it (never under graph capture: a recorded node
        binds its device at capture time).  Otherwise as ``run``.

        ``cluster`` (a parcel port) widens the fleet to every locality the
        port reaches — ``hpx::async(locality, action)`` as a placement
        decision: the policy scores the localities x devices grid
        (``percolation`` by default), and a remote pick routes the launch
        through a ``RemoteProgram`` sibling as parcels."""
        from repro_torch.core.graph import current_graph
        from repro_torch.core.scheduler import get_scheduler

        if scheduler is not None:
            sched = scheduler
        elif cluster is not None:
            sched = cluster.scheduler()
        else:
            sched = get_scheduler()
        if current_graph() is None and getattr(sched, "steals", False):
            return sched.submit(self, args, name, grid=grid, block=block, out=out, sync=sync)
        dev = sched.select(args=args, program=self)
        return self.for_device(dev).run(args, name, grid=grid, block=block, out=out, sync=sync)


def _release_remote_program(port, locality_id: int, gid_future: "Future") -> None:
    """GC finalizer for RemoteProgram: a best-effort free parcel, queued
    (``defer_free``: a collection may run on a thread holding the port's
    locks), so the worker's object table does not grow without bound.
    Skips when the create reply never arrived."""
    try:
        if gid_future.done() and gid_future.exception() is None:
            port.defer_free(locality_id, gid_future.get())
    except Exception:  # noqa: BLE001 - teardown is best-effort
        pass


class RemoteProgram(Program):
    """Proxy for a program owned by a remote locality (DESIGN.md §10).

    Kernels percolate **by name**: construction sends a ``create_program``
    parcel listing kernel names, which the owning locality resolves
    through its own registry and builds there (the NVRTC-at-the-device
    analogue, across a process boundary).  The callables kept here are
    *shadows* — used only for shape inference (graph capture runs them on
    ``meta`` tensors) and geometry binding; they never execute locally
    through this class.

    ``run`` turns into a ``launch`` parcel: buffer arguments on the target
    locality travel as GID references (zero copy), everything else is read
    back to the host and shipped inline; ``out`` buffers on the target
    locality keep results remote, local ``out`` buffers receive the reply
    arrays.  The reply parcel resolves the returned future — completion on
    the remote device, i.e. ``sync="ready"`` semantics.
    """

    def __init__(self, device, kernels, name: str = "program"):
        from repro_torch.core.parcel import resolve_kernel

        if isinstance(kernels, str):
            kernels = [kernels]
        if callable(kernels) and not isinstance(kernels, dict):
            kernels = {getattr(kernels, "__name__", "kernel"): kernels}
        elif not isinstance(kernels, dict):
            kernels = {n: resolve_kernel(n) for n in kernels}
        super().__init__(device, kernels, name=name)
        self._remote_gid_f: Future = device._call(
            "create_program", kernels=list(self._kernels), name=name
        ).then(lambda rep: rep["gid"], executor="inline")
        # The owning locality holds its Program strongly in the action
        # server's object table; retire it when this proxy is collected.
        self._remote_finalizer = weakref.finalize(
            self, _release_remote_program, device._port, device.locality_id, self._remote_gid_f
        )

    def remote_gid(self) -> int:
        """GID of the program object on the owning locality (blocks on the
        create reply the first time)."""
        return self._remote_gid_f.get()

    def build(self, name: str, *specs, grid=None, block=None) -> Future:
        """Remote build (async): ships shape/dtype specs, the owning
        locality builds and caches the kernel there."""
        from repro_torch.core.parcel import wire_dtype

        if name not in self._kernels:
            return Future.failed(KeyError(f"no kernel '{name}' in {self.name}"))
        spec_p = [(tuple(s.shape), wire_dtype(s.dtype)) for s in specs]
        dev = self.device
        port, loc = dev._port, dev.locality_id
        gid_f = self._remote_gid_f
        grid_n, block_n = _normalize_dim(grid), _normalize_dim(block)

        def _send():
            return port.call_sync(loc, "build", {
                "device": dev.remote_key, "program": gid_f.get(), "kernel": name,
                "specs": spec_p, "grid": grid_n, "block": block_n,
            })

        return dev.compile_queue.submit(_send)

    def run(
        self,
        args: "Sequence[Buffer | Any]",
        name: str,
        grid=None,
        block=None,
        out: "Sequence[Buffer] | None" = None,
        sync: str = "ready",
        stream=None,
    ):
        from repro_torch.core.executor import get_runtime
        from repro_torch.core.graph import current_graph
        from repro_torch.core.parcel import host_value

        g = current_graph()
        if g is not None:
            return g.run(self, args, name, grid=grid, block=block, out=out)
        if name not in self._kernels:
            return Future.failed(KeyError(f"no kernel '{name}' in {self.name}"))

        dev = self.device
        port, loc = dev._port, dev.locality_id
        # Stream-scoped remote launch: the parcel rides that stream's
        # ordered channel instead of the default one.
        lane = dev.ops_queue if stream is None else stream._lane_for(dev)

        # Argument descriptors: locality-resident buffers go as GID refs;
        # everything else materializes on the host and ships inline.
        descs: "list" = [None] * len(args)
        fetch_ix: "list[int]" = []
        fetch_futs: "list[Future]" = []
        for i, a in enumerate(args):
            if _is_remote_buffer(a) and a.device.locality_id == loc:
                descs[i] = ("gid", a.gid)
            elif isinstance(a, Buffer) or _is_remote_buffer(a):
                fetch_ix.append(i)
                fetch_futs.append(a.enqueue_read())
            elif isinstance(a, torch.Tensor):
                descs[i] = ("val", host_value(a))
            else:
                descs[i] = ("val", a)

        if out is None:
            out_gids, mode = None, "none"
        elif all(_is_remote_buffer(b) and b.device.locality_id == loc for b in out):
            out_gids, mode = [b.gid for b in out], "remote"
        elif all(isinstance(b, Buffer) for b in out):
            out_gids, mode = None, "local"
        else:
            raise ValueError(
                "out buffers of a remote launch must either all live on the "
                "target locality (results stay remote) or all be local "
                "buffers (results ship back)"
            )

        grid_n, block_n = _normalize_dim(grid), _normalize_dim(block)
        gid_f = self._remote_gid_f

        def _land(b, v):
            b._set_tensor(_host_tensor(v).to(b.device.torch_device))

        def _post(rep):
            if mode == "remote":
                return list(out)
            if mode == "local":
                for b, v in zip(out, rep):
                    b.device.ops_queue.submit(_land, b, v).get()
                return list(out)
            return rep

        def _payload(vals):
            for i, v in zip(fetch_ix, vals):
                descs[i] = ("val", v)
            return {
                "device": dev.remote_key, "program": gid_f.get(), "kernel": name,
                "args": descs, "out": out_gids, "grid": grid_n, "block": block_n,
            }

        pool = get_runtime().pool
        # Pipelined port: the channel task stages+flushes the launch parcel
        # and releases the lane at once — the reply resolves the result
        # future asynchronously, so back-to-back remote launches overlap on
        # the wire instead of serializing on round trips.
        if getattr(port, "pipelined", False):
            from repro_torch.core.futures import Promise, forward_failure

            inner: "Promise" = Promise(name=f"parcel:launch:L{loc}")

            def _ship(*vals):
                port.stage(loc, "launch", _payload(vals), inner)
                port.flush(loc)

            if not fetch_futs:
                forward_failure(lane.submit(_ship), inner)
            else:
                forward_failure(dataflow(
                    lambda *vals: lane.submit(lambda: _ship(*vals)).get(),
                    *fetch_futs,
                    executor=pool,
                    name=f"remote-run:{name}",
                ), inner)
            # "local" mode copies onto local devices — post-process on the
            # host pool, never inline on the port's reply-listener thread.
            result = inner.get_future().then(
                _post,
                executor="inline" if mode != "local" else pool,
                name=f"remote-run:{name}",
            )
            if stream is not None:
                stream._note_completion(result)
            return result

        def _send(*vals):
            return _post(port.call_sync(loc, "launch", _payload(vals)))

        # Ordering: the launch parcel goes through the remote device's ops
        # queue, after any previously submitted writes there.  Pending host
        # fetches join off-queue first (a queue worker must not wait on its
        # own queue).
        if not fetch_futs:
            result = lane.submit(_send)
        else:
            result = dataflow(
                lambda *vals: lane.submit(lambda: _send(*vals)).get(),
                *fetch_futs,
                executor=pool,
                name=f"remote-run:{name}",
            )
        if stream is not None:
            stream._note_completion(result)
        return result
