"""Roofline inputs from the op table of one device's step: the port's
counterpart of ``src/repro/analysis/hlo_analysis.py``.

The reference reads a partitioned HLO module, which is already one
device's program.  Eager PyTorch has no HLO: ``record`` runs the step
once (on fake tensors, under a fake world, or on real ones) inside a
``TorchDispatchMode`` and writes down every aten op it runs on plain
local tensors, one row an op:

  * a ``DTensor`` op is not recorded at the global level: ``DTensor``
    dispatches it again on each local shard, and that op is the row, so
    each op counts once, at the local shard's shape (per device, as the
    reference's partitioned HLO);
  * the work ``DTensor`` does to plan a dispatch (sharding propagation on
    global-shape stand-ins, shard-offset arithmetic) is not the step's and
    is left out: inside a ``DTensor`` dispatch, a factory op and every op
    fed by one is the planner's;
  * collectives are the ``_c10d_functional`` ops (all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single) and
    ``DTensor``'s ``shard_dim_alltoall``; a row
    keeps the kind, in the reference's names, and the group's size;
    ``wait_tensor`` and the shape queries (``prim.device``, ``sym_size``,
    ...) are no computation and get no row;
  * Python loops unroll, so every execution of a layer, a query block or a
    microbatch is its own row: there is no ``execution_multipliers``.

A row is JSON: ``op`` (``"aten.mm.default"``), ``args``/``kwargs`` with
each tensor as ``{"t": dtype, "s": shape}`` (the reference's dtype names),
``out`` the outputs so, and the flags ``view`` (the output aliases an
input), ``u`` (the bytes an in-place slice update writes), ``coll`` and
``n`` (collective kind and group size).

``analyze(table)`` is a pure function of the rows and returns the
reference's keys:

  * FLOPs from ``torch.utils.flop_counter``'s per-op formulas (matmuls,
    convolutions, attention), on the rows' shapes;
  * collective wire bytes a device with the reference's ring factors:
    all-reduce 2 b (n-1)/n, all-gather b (n-1)/n, reduce-scatter
    b n (n-1)/n, all-to-all b (n-1)/n, permute b (b the result's bytes);
  * HBM bytes by the port's own eager model, since eager PyTorch on the
    card fuses nothing: a view costs nothing, an allocation (``empty*``)
    nothing, an in-place update of a slice (``copy_`` into a view,
    ``index_put_``, ``index_copy_``, ``scatter_``) twice the update (the
    reference's dynamic-update-slice charge), every other op reads its
    operands and writes its result.  Dtypes are the ones that run: the
    reference's halving of "semantically bf16" CPU collectives and dots has
    no counterpart.

``Recorder`` also follows the storage the step allocates (by storage, so
a view is not counted twice; autograd's saved tensors count as the
activations they are) and keeps its peak, ``peak_bytes``.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

__all__ = ["Recorder", "analyze", "record", "tensor_bytes"]

# the reference's dtype-byte table (hlo_analysis._DTYPE_BYTES), copied
_DTYPE_BYTES = {
    "pred": 1,
    "s2": 1, "s4": 1, "s8": 1, "u2": 1, "u4": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1, "f8e5m2fnuz": 1,
    "token": 0, "opaque": 0,
}

_TORCH_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

# collective op name -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

# no computation: shape and device queries, a collective's wait
_NO_ROW = {
    "prim.device.default", "prim.layout.default", "aten.size.default", "aten.stride.default",
    "aten.dim.default", "aten.numel.default", "aten.sym_size.default", "aten.sym_size.int",
    "aten.sym_stride.default", "aten.sym_stride.int", "aten.sym_numel.default",
    "aten.sym_storage_offset.default", "aten.storage_offset.default",
    "aten.is_contiguous.default", "aten.is_contiguous.memory_format",
    "aten.sym_is_contiguous.default", "aten.is_strides_like_format.default",
    "aten.is_non_overlapping_and_dense.default",
    "_c10d_functional.wait_tensor.default",
}

# views the schema does not mark as aliasing
_VIEWS = {"aten._unsafe_view.default", "aten.lift_fresh.default"}

# allocations: no traffic
_ALLOC = {"aten.empty.memory_format", "aten.empty_strided.default", "aten.empty_like.default",
          "aten.new_empty.default", "aten.new_empty_strided.default"}

# in-place slice updates: (the source argument's name, its position)
_UPDATES = {
    "aten.copy_.default": ("src", 1),
    "aten.index_put_.default": ("values", 2),
    "aten._index_put_impl_.default": ("values", 2),
    "aten.index_copy_.default": ("source", 3),
    "aten.scatter_.src": ("src", 3),
    "aten.scatter_.value": (None, None),
    "aten.scatter_add_.default": ("src", 3),
}


def _dtype_name(dtype) -> str:
    return _TORCH_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def tensor_bytes(desc) -> int:
    """Bytes of a row's tensor ``{"t": dtype, "s": shape}``."""
    n = 1
    for d in desc["s"]:
        n *= d
    return n * _DTYPE_BYTES.get(desc["t"], 4)


def _encode(x):
    """A JSON-able stand-in for an op argument."""
    if isinstance(x, torch.Tensor):
        return {"t": _dtype_name(x.dtype), "s": [int(d) for d in x.shape]}
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _encode(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (torch.SymInt, torch.SymFloat, torch.SymBool)):
        return int(x) if isinstance(x, torch.SymInt) else float(x)
    return str(x)


def _is_desc(x) -> bool:
    return isinstance(x, dict) and "t" in x and "s" in x


def _descs(tree) -> list:
    if _is_desc(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [d for v in tree for d in _descs(v)]
    if isinstance(tree, dict):
        return [d for v in tree.values() for d in _descs(v)]
    return []


def _group_size(func, args, kwargs) -> int:
    names = [a.name for a in func._schema.arguments]
    for key in ("group_size", "group_name"):
        if key in kwargs:
            v = kwargs[key]
        elif key in names and names.index(key) < len(args):
            v = args[names.index(key)]
        else:
            continue
        if key == "group_size":
            return int(v)
        from torch.distributed.distributed_c10d import _resolve_process_group

        return int(_resolve_process_group(v).size())
    return 1


_KIND_CACHE: dict = {}


def _kind(func) -> tuple:
    """(row name, is a view, is in place, collective kind or None), cached."""
    k = _KIND_CACHE.get(func)
    if k is None:
        name = str(func)
        schema = func._schema
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        view = (name in _VIEWS or torch.Tag.inplace_view in func.tags
                or (not inplace and bool(getattr(func, "is_view", False))))
        coll = (_COLLECTIVES.get(func._schema.name.split("::")[-1])
                if func.namespace in _COLLECTIVE_NAMESPACES else None)
        k = _KIND_CACHE[func] = (name, view, inplace, coll)
    return k


def _has_dtensor(leaves) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(a, DTensor) for a in leaves)


class Recorder(TorchDispatchMode):
    """Records the op table of what runs inside it (``table``) and the peak
    of the storage its ops allocate (``peak_bytes``).

    Under a ``FakeTensorMode`` (the one active at entry) the step's
    tensors are that mode's fakes; an op none of whose inputs is one
    (``DTensor``'s planner working on host tensors, or on the global-shape
    stand-ins of its own fake mode) is not the step's and gets no row, nor
    does a factory whose output is not one.  Without a fake mode every op
    on plain tensors is the step's."""

    def __init__(self):
        super().__init__()
        self.table: "list[dict]" = []
        self.peak_bytes = 0
        self._fake = None
        self._reenter = False  # the next DTensor op is the one being dispatched
        self._live: dict = {}  # storage address -> (weak ref, bytes)
        self._live_bytes = 0  # bytes of _live, some perhaps freed since

    def __enter__(self):
        if self._fake is None:  # the outermost entry (a DTensor dispatch enters again)
            from torch._guards import detect_fake_mode

            self._fake = detect_fake_mode()
        return super().__enter__()

    def _mine(self, t) -> bool:
        return self._fake is None or getattr(t, "fake_mode", None) is self._fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        if _has_dtensor(leaves):
            if self._reenter:  # DTensor dispatches it, with this mode back on
                self._reenter = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        name, view, inplace, coll = _kind(func)
        if name in _NO_ROW:
            return out
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not (any(self._mine(a) for a in leaves) if leaves
                else outs and all(self._mine(o) for o in outs)):
            return out
        row = {"op": name, "args": _encode(args), "out": [_encode(o) for o in outs]}
        if kwargs:
            row["kwargs"] = _encode(kwargs)
        if view:
            row["view"] = True
        if name in _UPDATES:
            row["u"] = self._update_bytes(name, args, kwargs)
        if coll is not None:
            row["coll"], row["n"] = coll, _group_size(func, args, kwargs)
        self.table.append(row)
        if not (view or inplace):
            for o in outs:
                self._allocated(o)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """Let ``DTensor`` dispatch ``func`` with this mode on, so its local
        ops are recorded.  The fake mode is off meanwhile: ``DTensor``'s
        planner reads shard offsets off small host tensors (a fake one
        cannot be read); the local shards are fake tensors and dispatch to
        their own mode."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        self._reenter = True
        try:
            with unset_fake_temporarily(), self:
                return func(*args, **kwargs)
        finally:
            self._reenter = False

    @staticmethod
    def _update_bytes(name, args, kwargs) -> int:
        """Bytes an in-place slice update writes: the destination view's
        for ``copy_``, else the source's elements (the index's, for a
        scalar scatter) at the destination's dtype."""
        dst = args[0]
        if name == "aten.copy_.default":
            return int(dst.numel()) * dst.element_size()
        key, pos = _UPDATES[name]
        src = kwargs.get(key) if key is not None else None
        if src is None and pos is not None and len(args) > pos:
            src = args[pos]
        if not isinstance(src, torch.Tensor):
            src = args[2]  # the index
        return int(src.numel()) * dst.element_size()

    def _allocated(self, t) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        old = self._live.get(ref.cdata)
        if old is not None and not old[0].expired():
            return
        if old is not None:
            self._live_bytes -= old[1]
        n = int(st.nbytes())
        self._live[ref.cdata] = (ref, n)
        self._live_bytes += n
        if self._live_bytes > self.peak_bytes:  # sweep the freed, then compare
            for key in [k for k, (r, _) in self._live.items() if r.expired()]:
                self._live_bytes -= self._live.pop(key)[1]
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)


def record(fn, *args, **kw) -> "list[dict]":
    """The op table of ``fn(*args, **kw)`` (see the module docstring)."""
    with Recorder() as r:
        fn(*args, **kw)
    return r.table


_PACKETS: dict = {}


def _flops(row) -> float:
    from torch.utils.flop_counter import flop_registry

    name = row["op"]
    if name not in _PACKETS:
        ns, op = name.split(".")[:2]
        packet = getattr(getattr(torch.ops, ns, None), op, None)
        _PACKETS[name] = flop_registry.get(packet) if packet is not None else None
    formula = _PACKETS[name]
    if formula is None:
        return 0.0

    def size(x):
        if _is_desc(x):
            return torch.Size(x["s"])
        if isinstance(x, list):
            return [size(v) for v in x]
        return x

    outs = [torch.Size(o["s"]) for o in row["out"]]
    out = outs[0] if len(outs) == 1 else tuple(outs)
    return float(formula(*size(row["args"]), out_val=out, **size(row.get("kwargs", {}))))


def _wire_bytes(row) -> float:
    """Per-device wire bytes of a collective row (ring estimates, the
    reference's factors)."""
    n = row["n"]
    if n <= 1:
        return 0.0
    rb = float(sum(tensor_bytes(o) for o in row["out"]))
    frac = (n - 1) / n
    kind = row["coll"]
    if kind == "all-reduce":
        return 2.0 * rb * frac
    if kind in ("all-gather", "all-to-all"):
        return rb * frac
    if kind == "reduce-scatter":
        return rb * n * frac  # operand = n x result
    if kind == "collective-permute":
        return rb
    return 0.0


def _hbm_bytes(row) -> float:
    if row.get("view") or row["op"] in _ALLOC:
        return 0.0
    if "u" in row:
        return 2.0 * row["u"]
    return float(sum(tensor_bytes(d) for d in _descs(row["args"]) + _descs(row.get("kwargs", {}))
                     + row["out"]))


def analyze(table: "list[dict]", detail: bool = False) -> dict:
    """FLOPs, HBM bytes and collective traffic of one device's step, from
    its op table; the reference's keys."""
    flops = hbm = coll_bytes = 0.0
    by_kind: "dict[str, float]" = {}
    counts: "dict[str, int]" = {}
    by_op: "dict[str, float]" = {}
    for row in table:
        flops += _flops(row)
        b = _hbm_bytes(row)
        hbm += b
        if detail:
            by_op[row["op"]] = by_op.get(row["op"], 0.0) + b
        kind = row.get("coll")
        if kind is not None:
            wb = _wire_bytes(row)
            coll_bytes += wb
            by_kind[kind] = by_kind.get(kind, 0.0) + wb
            counts[kind] = counts.get(kind, 0) + 1
    out = {
        "flops": flops,
        "hbm_bytes": hbm,
        "collective_wire_bytes": coll_bytes,
        "collective_by_kind": by_kind,
        "collective_counts": counts,
        "num_computations": len(table),
    }
    if detail:
        out["bytes_by_op"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    return out
