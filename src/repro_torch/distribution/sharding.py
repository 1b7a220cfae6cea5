"""Logical-axis sharding: MaxText-style rules mapping logical tensor axes
("batch", "seq", "embed", "heads", "mlp", "experts", ...) to mesh axes
(``src/repro/distribution/sharding.py`` on ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``).

Model code annotates activations with ``constrain(x, "batch", "seq",
"embed")``; the distribution layer activates a rule set and a mesh with
``axis_rules``.  Outside any rule context the annotations are no-ops, so
the same model runs unsharded on one device.

* ``spec_for`` translates logical names to a ``PartitionSpec``: a tuple
  with one entry a tensor dim (a mesh-axis name, a tuple of names, or
  ``None``; trailing ``None``s trimmed), the reference's ``P(...)`` entry
  for entry.
* ``sharding_for`` puts a spec on a mesh as a ``NamedSharding``: the mesh,
  the spec and one ``Placement`` a mesh dim, ``Shard(d)`` where dim ``d``
  names that mesh axis (a tuple such as ``("pod", "data")`` shards one dim
  over both, the first axis outermost, as JAX orders them), else
  ``Replicate()``.  A mesh dim of one rank holds whole tensors, so it
  takes ``Replicate()`` whatever the spec (the same data; ``DTensor``
  plans its redistributions far faster without such shards).
  ``NamedSharding.distribute`` places a tensor there.
* ``tree_sharding`` maps a pytree of logical-name tuples to shardings.
* ``constrain`` redistributes a ``DTensor`` to the spec's placements under
  a mesh, which leaves its value unchanged; a plain tensor passes as is.
* ``on_local_shards`` runs a function that cannot take ``DTensor``s (a
  hand-written kernel, a convolution ``DTensor`` shards wrongly), or whose
  ``DTensor`` plan would gather what each rank can compute from its own
  rows, on each rank's local shards, along the dims the function treats
  independently.
* ``place_like`` lays a plain tensor (an index range) over the mesh of a
  ``DTensor`` by logical names, each rank slicing its own shard.
* ``per_rank`` lays a plain tensor of one block a rank (each rank's head
  indices, its vocab range) over chosen mesh dims, each rank keeping its
  own block.
* ``make_groups``, ``to_groups``, ``from_groups`` and ``once_a_group``: a
  group layout, work split over g groups of the m ranks of some mesh dims,
  the ranks of a group computing the same (heads that the m ranks do not
  divide, as the reference's GSPMD runs them); a tensor enters it from its
  plain layout and leaves it into that layout, and every gradient inside
  it is its group's whole part, so none is counted twice.

A ``mesh`` is a ``DeviceMesh`` (``launch.mesh``); ``spec_for`` also takes
anything with ``axis_names`` and ``devices.shape``, as the reference's
tests pass a stand-in of the production mesh.
"""
from __future__ import annotations

import functools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

__all__ = [
    "NamedSharding",
    "PartitionSpec",
    "RULE_SETS",
    "axis_rules",
    "constrain",
    "current_mesh",
    "current_rules",
    "from_groups",
    "make_groups",
    "make_rules",
    "once_a_group",
    "on_local_shards",
    "per_rank",
    "place_like",
    "reduce_grad_once",
    "sharding_for",
    "spec_for",
    "split_last_dim",
    "to_groups",
    "tree_sharding",
]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh-axis name, a tuple of names, or None
    (replicated along that dim).  A tuple of one name is that name, as in
    JAX's ``PartitionSpec``: ``PartitionSpec(("data",), None, "model")``
    is the tuple ``("data", None, "model")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _get() -> "tuple[Optional[dict], Any]":
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


@contextmanager
def axis_rules(rules: "dict[str, Any]", mesh=None):
    """Activate logical->mesh rules (and optionally a mesh) for this thread."""
    old = _get()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old


def current_rules() -> "Optional[dict]":
    return _get()[0]


def current_mesh():
    return _get()[1]


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_sizes(mesh) -> dict:
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", None)
    if shape is None or callable(shape):
        shape = mesh.devices.shape
    return dict(zip(_axis_names(mesh), tuple(shape)))


def spec_for(
    names: "Sequence[Optional[str]]",
    rules: "dict | None" = None,
    shape: "Sequence[int] | None" = None,
    mesh=None,
) -> PartitionSpec:
    """Translate logical axis names to a ``PartitionSpec`` under ``rules``.

    A rule value may be a mesh-axis name, a tuple of mesh axes, or None.
    Unknown logical names map to None (replicated along that dim).

    With ``shape`` and ``mesh``, rules that do not divide the dimension
    evenly are dropped, as are rules reusing a mesh axis already consumed
    by an earlier dim.
    """
    if rules is None:
        rules = current_rules() or {}
    sizes = _axis_sizes(mesh)
    parts = []
    used: set = set()
    for i, n in enumerate(names):
        r = rules.get(n) if n is not None else None
        if r is not None:
            axes = (r,) if isinstance(r, str) else tuple(r)
            if any(a in used for a in axes):
                r = None
            elif shape is not None and sizes:
                total = 1
                for a in axes:
                    total *= sizes.get(a, 1)
                if shape[i] % total != 0:
                    r = None
            if r is not None:
                used.update(axes)
        parts.append(r)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


@dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh: ``placements`` has one ``Placement`` a mesh
    dim, in the mesh's order."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple

    def distribute(self, x, *, src_data_rank: "int | None" = 0):
        """``x`` (a tensor on the mesh's device type) as a ``DTensor`` with
        these placements: rank ``src_data_rank``'s value scattered, or with
        ``None`` each rank's own ``x`` sliced without communication (every
        rank must hold the same value).  A ``DTensor`` is redistributed."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements, src_data_rank=src_data_rank)


def placements_for(mesh, spec: "Sequence") -> tuple:
    """One ``Placement`` a mesh dim for ``spec``: ``Shard(d)`` where entry
    ``d`` names the mesh axis (alone or in a tuple) and the axis has more
    than one rank, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    sizes = _axis_sizes(mesh)
    for axis in _axis_names(mesh):
        dim = next((d for d, r in enumerate(spec)
                    if r == axis or (isinstance(r, tuple) and axis in r)), None)
        out.append(Replicate() if dim is None or sizes[axis] == 1 else Shard(dim))
    return tuple(out)


def sharding_for(mesh, names: "Sequence[Optional[str]]", rules: dict,
                 shape: "Sequence[int] | None" = None) -> NamedSharding:
    spec = spec_for(names, rules, shape=shape, mesh=mesh)
    return NamedSharding(mesh, spec, placements_for(mesh, spec))


def constrain(x, *names: "Optional[str]"):
    """Annotate ``x`` with the sharding implied by logical ``names``: under
    a mesh a ``DTensor`` is redistributed to it (its value unchanged);
    outside rules, without a mesh, or for a plain tensor, ``x`` itself."""
    rules, mesh = _get()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return sharding_for(mesh, names, rules, shape=tuple(x.shape)).distribute(x)


def place_like(x, like, *names: "Optional[str]"):
    """``x``, a plain tensor every rank holds whole, as a ``DTensor`` on
    ``like``'s mesh placed by logical ``names`` under the current rules,
    each rank slicing its own shard (no communication); ``x`` itself when
    ``like`` is not a ``DTensor`` or no rules are active."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    if rules is None or not isinstance(like, DTensor):
        return x
    return sharding_for(like.device_mesh, names, rules, shape=tuple(x.shape)).distribute(
        x, src_data_rank=None)


def per_rank(x, mesh, mesh_dims: "Sequence[int]"):
    """``x``, a plain tensor every rank holds whole whose dim 0 is one equal
    block a rank of ``mesh_dims`` (the ranks in mesh order, the first dim
    outermost), as a ``DTensor`` on ``mesh`` sharded so on dim 0 over
    those dims and replicated over the others: each rank keeps its own
    block, with no communication."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(0) if i in mesh_dims else Replicate() for i in range(mesh.ndim)]
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def on_local_shards(fn, inputs: "Sequence", shard_dims: dict, *, partial_grads: bool = False):
    """``fn(*inputs)``, and where an input is a ``DTensor``, on each rank's
    local shards.

    ``shard_dims`` names the axes ``fn`` treats independently (batch rows,
    heads, channels): ``{axis: (the axis's dim in each input, in each
    output)}``, None where a tensor lacks it.  A mesh dim along which an
    input is sharded evenly on its dim of one such axis, and every other
    input that has the axis is so sharded or replicated, stays sharded: a
    replicated one is sliced (no communication), and an input that lacks
    the axis is gathered (redistributed replicated) along it, as is every
    input along every other mesh dim.
    An input replicated along a sharded mesh dim adds up its gradient over
    it, since each rank's shard of the work contributes a part.  The
    outputs come back as ``DTensor``s sharded the same way (a tensor or a
    tuple of tensors, as ``fn`` returns); an output whose dim is ``"sum"``
    (``"max"``) for an axis holds each rank's part of a sum (a maximum)
    over that axis (it lacks the axis: a product contracted over it, a
    combine or a reduction over it) and comes back ``Partial`` along the
    mesh dims that shard it.  With ``partial_grads`` an input already laid
    out as ``fn`` takes it keeps its gradient's parts ``Partial``, for
    ``reduce_grad_once`` to add to other parts before one reduction
    (``layers.projections`` pairs them); otherwise each call reduces its
    own."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(x, DTensor) for x in inputs):
        return fn(*inputs)
    mesh = next(x.device_mesh for x in inputs if isinstance(x, DTensor))
    rep = [Replicate()] * mesh.ndim
    xs = [x if isinstance(x, DTensor) else DTensor.from_local(x, mesh, rep, run_check=False)
          for x in inputs]
    # the independent axis each mesh dim shards, or None: gathered
    picks = [next((axis for axis, (din, _) in shard_dims.items()
                   if any(d is not None and x.placements[i] == Shard(d) for x, d in zip(xs, din))
                   and all(d is None or x.placements[i] in (Shard(d), Replicate())
                           for x, d in zip(xs, din))),
                  None)
             for i in range(mesh.ndim)]
    for axis in set(picks) - {None}:  # uneven shards are gathered
        n = 1
        for i, p in enumerate(picks):
            n *= mesh.size(i) if p == axis else 1
        if any(d is not None and x.shape[d] % n for x, d in zip(xs, shard_dims[axis][0])):
            picks = [None if p == axis else p for p in picks]

    def placements(k: int, which: int):
        out = []
        for p in picks:
            d = shard_dims[p][which][k] if p is not None else None
            out.append(Replicate() if d is None else Partial(d) if d in ("sum", "max")
                       else Shard(d))
        return out

    local = []
    for j, x in enumerate(xs):
        pl = placements(j, 0)
        grad = [Partial() if p is not None and isinstance(q, Replicate) else q
                for p, q in zip(picks, pl)]
        if not (partial_grads and list(x.placements) == pl):
            x = x.redistribute(mesh, pl)
        local.append(x.to_local(grad_placements=grad))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(DTensor.from_local(o, mesh, placements(k, 1), run_check=False)
                for k, o in enumerate(outs))
    return res if isinstance(out, tuple) else res[0]


def split_last_dim(t, at: int):
    """``t``'s last dim, of n entries sharded evenly over one mesh dim of m
    ranks (rank q the entries [q n / m, (q + 1) n / m)), cut at ``at`` into
    two parts, each sharded evenly over the same ranks (m dividing ``at``
    and n - ``at``), by one all-to-all that sends each entry to its new
    rank: the reference's GSPMD moves them by collective permutes.  Returns
    the two parts as ``DTensor``s; None where ``t`` is not so sharded.  No
    gradient (a decode step)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard

    last = t.ndim - 1
    if not isinstance(t, DTensor) or t.requires_grad:
        return None
    mesh = t.device_mesh
    dims = [i for i, q in enumerate(t.placements) if q.is_shard(last) and mesh.size(i) > 1]
    n = t.shape[last]
    if len(dims) != 1 or any(q.is_partial() for q in t.placements):
        return None
    i = dims[0]
    m = mesh.size(i)
    if n % m or at % m or (n - at) % m:
        return None
    r, a, b = mesh.get_local_rank(i), at // m, (n - at) // m
    local = t.to_local()
    send_idx, send_sizes, recv_sizes, pos = _split_plan(n, at, m, r, local.device)
    buf = local.index_select(last, send_idx).movedim(last, 0).contiguous()
    out = funcol.all_to_all_single(buf, recv_sizes, send_sizes, (mesh, i))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    out = out.movedim(0, last).index_select(last, pos)
    parts = []
    for lo, size, width in ((0, a, at), (a, b, n - at)):
        shape = (*t.shape[:-1], width)
        parts.append(DTensor.from_local(out.narrow(last, lo, size).contiguous(), mesh,
                                        t.placements, run_check=False, shape=shape,
                                        stride=_contiguous(shape)))
    return tuple(parts)


_split_plans: dict = {}


def _split_plan(n: int, at: int, m: int, r: int, device):
    """``split_last_dim``'s plan for rank r, made once a (n, at, m, r) and
    device: the local entries it sends, in order, and where each of its
    entries after the cut lies among those it receives (index tensors,
    made outside any fake-tensor mode so that a traced step reads them
    too), and the counts it sends to and receives from each rank."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    key = (n, at, m, r, str(device))
    if key not in _split_plans:
        c, a, b = n // m, at // m, (n - at) // m

        def owned(j):  # rank j's entries after the cut, in order
            return list(range(j * a, (j + 1) * a)) + list(range(at + j * b, at + (j + 1) * b))

        send = [[e - r * c for e in owned(j) if r * c <= e < (r + 1) * c] for j in range(m)]
        recv = [[e for e in owned(r) if q * c <= e < (q + 1) * c] for q in range(m)]
        where = {e: k for k, e in enumerate(sum(recv, []))}
        with unset_fake_temporarily():
            _split_plans[key] = (
                torch.tensor(sum(send, []), dtype=torch.int64, device=device),
                [len(x) for x in send], [len(x) for x in recv],
                torch.tensor([where[e] for e in owned(r)], dtype=torch.int64, device=device))
    return _split_plans[key]


class _ReduceGradOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(g, DTensor) and any(q.is_partial() for q in g.placements):
            g = g.redistribute(g.device_mesh, [Replicate() if q.is_partial() else q
                                               for q in g.placements])
        return g


def reduce_grad_once(t):
    """``t`` as the input of several projections (q, k and v; an MLP's gate
    and up; the cross K/V of every decoder layer) that leave their
    gradients' parts ``Partial`` (``on_local_shards(partial_grads=True)``,
    through ``layers.projections``): the parts, each rank's share of a sum
    where the weights shard their columns, are added while still partial
    and reduced once, in the gradient's dtype, as the reference's XLA sums
    them before its one all-reduce.  ``t`` itself outside a mesh."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(t, DTensor) and t.requires_grad):
        return t
    return _ReduceGradOnce.apply(t)


# ---------------------------------------------------------------------------
# group layouts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Groups:
    """A dim of ``cols`` entries in a group layout over the mesh dims
    ``dims`` (m ranks in mesh order, g groups of ``per`` = m / g
    consecutive ranks): in it each rank holds the entries its group reads,
    the same number for every rank, so the dim has m times that many,
    sharded over ``dims``.
    ``take``, ``first`` and ``block`` hold one block a rank (``per_rank``):
    the entries the rank's group reads (each once), 1.0 on the first rank
    of each group (0.0 on the others), and the rank's own 1/m of the
    entries (None where ``cols`` is no multiple of m, or where a rank's own
    entries are not all read by its group and by no other).  ``own``: where
    ``block`` is, the positions of those entries among the group's; ``sel``
    (plain, whole on every rank): a position in the whole layout holding
    each entry.  ``split``: with one group dim, the mesh over the same
    ranks with that dim split in two, (g groups, per members), so that a
    collective can run over the ranks of one group (its members dim) or
    over one rank of each group (its groups dim), which a ``DTensor`` of
    ``mesh`` cannot name; ``within``: each group reads its own ranks'
    entries, in rank order (the layout of a dim sharded evenly over the
    group dims is a gather over each group's ranks); ``across``: the
    groups read the entries in order, each once (a gather over one rank of
    each group makes them whole)."""

    dims: tuple
    per: int
    cols: int
    take: Any
    first: Any
    block: Any
    own: Any
    sel: Any
    split: Any = None
    within: bool = False
    across: bool = False


def make_groups(mesh, dims: "Sequence[int]", g: int, reads: "Sequence[Sequence[int]]",
                cols: int, device) -> Groups:
    """The group layout of ``cols`` entries over ``mesh``'s ``dims`` in g
    groups, group j reading the entries ``reads[j]`` (tuples of one length,
    no entry twice; every entry read by some group)."""
    m = 1
    for i in dims:
        m *= mesh.size(i)
    reads = tuple(map(tuple, reads))
    take, first, block, own, sel = _group_plan(m, g, reads, cols)
    n = len(reads[0])
    within = block is not None and all(r == tuple(range(j * n, (j + 1) * n))
                                       for j, r in enumerate(reads))
    across = sum(reads, ()) == tuple(range(cols))
    split = _split_mesh(mesh, dims[0], g) if len(dims) == 1 and (within or across) else None

    def placed(rows, dtype=torch.int64):
        return per_rank(torch.tensor(rows, dtype=dtype, device=device), mesh, dims)

    return Groups(dims=tuple(dims), per=m // g, cols=cols, take=placed(take),
                  first=placed(first, torch.float32),
                  block=placed(block) if block is not None else None,
                  own=placed(own) if own is not None else None,
                  sel=torch.tensor(sel, dtype=torch.int64, device=device), split=split,
                  within=within and split is not None, across=across and split is not None)


def _split_mesh(mesh, dim: int, g: int):
    """``mesh`` over the same ranks with dim ``dim`` split into (g, m / g):
    its dim ``dim`` runs over one rank of each group, its dim ``dim + 1``
    over the ranks of one group (``Groups.split``).  Made once a mesh
    and world (a mesh of the same ranks may outlive its world, and be
    handed out again in the next)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    world = torch.distributed.distributed_c10d._get_default_group()
    made = mesh.__dict__.setdefault("_split_meshes", {})
    if made.get((dim, g), (None,))[0] is not world:
        with unset_fake_temporarily():  # made while a step is traced on fake tensors
            ranks = torch.tensor(mesh.mesh.tolist(), dtype=torch.int64)
            shape = list(ranks.shape)
            shape[dim:dim + 1] = [g, shape[dim] // g]
            made[dim, g] = (world, DeviceMesh(
                mesh.device_type, ranks.reshape(shape),
                mesh_dim_names=tuple(f"split{i}" for i in range(len(shape)))))
    return made[dim, g][1]


def _gather_local(local, dim: int, mesh, mesh_dim: int):
    """``local`` gathered along ``dim`` over the ranks of ``mesh``'s dim
    ``mesh_dim``, in rank order."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor  # torch 2.11
    out = gather(local.contiguous(), dim, (mesh, mesh_dim))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


def _only_group_dim_shards(t, dim: int, groups: Groups) -> bool:
    """Whether ``t``'s dim ``dim`` is sharded evenly over the one group dim
    and by no other mesh dim (nor is ``t`` partial)."""
    from torch.distributed.tensor import Shard

    i = groups.dims[0]
    return (t.placements[i] == Shard(dim) and t.shape[dim] % t.device_mesh.size(i) == 0
            and not any(q.is_partial() or (j != i and q == Shard(dim))
                        for j, q in enumerate(t.placements)))


@functools.lru_cache(maxsize=64)
def _group_plan(m: int, g: int, reads: tuple, cols: int):
    """``make_groups``' indices as flat lists, one block a rank (``sel``
    whole)."""
    per, n = m // g, len(reads[0])
    readers: dict = {}
    for j, r in enumerate(reads):
        for e in r:
            readers.setdefault(e, set()).add(j)
    pos = [{e: i for i, e in enumerate(r)} for r in reads]  # an entry's place in a group's
    block = own = None
    if cols % m == 0:
        c = cols // m
        if all(readers.get(e) == {p // per} for p in range(m) for e in range(p * c, (p + 1) * c)):
            block = list(range(cols))
            own = [pos[p // per][e] for p in range(m) for e in range(p * c, (p + 1) * c)]
    where: dict = {}
    for p in range(m):
        for i, e in enumerate(reads[p // per]):
            where.setdefault(e, p * n + i)
    return ([e for p in range(m) for e in reads[p // per]],
            [1.0 if p % per == 0 else 0.0 for p in range(m)], block, own,
            [where[e] for e in range(cols)])


def _contiguous(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


@dataclass(frozen=True)
class _Like:
    """What a group function's backward needs of a ``DTensor`` input, so
    that it does not keep the tensor alive (a checkpointed layer frees it)."""

    shape: tuple
    placements: tuple
    mesh: Any
    dtype: Any
    device: Any

    @staticmethod
    def of(t) -> "_Like":
        return _Like(tuple(t.shape), tuple(t.placements), t.device_mesh, t.dtype, t.device)


def _from_local(local, like: _Like, dim: int, size: int, placements):
    """``local`` as a ``DTensor`` of ``like``'s shape but ``size`` along
    ``dim``."""
    from torch.distributed.tensor import DTensor

    shape = list(like.shape)
    shape[dim] = size
    return DTensor.from_local(local, like.mesh, placements, run_check=False,
                              shape=tuple(shape), stride=_contiguous(shape))


def _with(t, dims, placement) -> list:
    return [placement if i in dims else q for i, q in enumerate(t.placements)]


class _ToGroups(torch.autograd.Function):
    """``to_groups``: forward the entries of each rank's group out of ``t``
    gathered over the group dims (over the group's ranks alone where they
    hold them, ``Groups.within``); backward each rank's group's whole
    gradient, its own entries taken (``Groups.block``), or else the first
    rank's of each group summed over the ranks."""

    @staticmethod
    def forward(ctx, t, dim, groups):
        from torch.distributed.tensor import Replicate, Shard

        like = ctx.like = _Like.of(t)
        ctx.dim, ctx.groups = dim, groups
        take = groups.take.to_local()
        if groups.within and _only_group_dim_shards(t, dim, groups):
            # each group's entries are its ranks' shards: gathered over them alone
            loc = _gather_local(t.to_local(), dim, groups.split, groups.dims[0] + 1)
            shape = list(loc.shape)
            shape[dim] = groups.cols
            ctx.full_shape = torch.Size(shape)
        else:
            full = t.redistribute(t.device_mesh, _with(t, groups.dims, Replicate())).to_local()
            ctx.full_shape = full.shape
            loc = full.index_select(dim, take)
        m = groups.take.shape[0] // take.shape[0]
        return _from_local(loc.contiguous(), like, dim, m * take.shape[0],
                           _with(t, groups.dims, Shard(dim)))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Shard

        t, dim, groups = ctx.like, ctx.dim, ctx.groups
        g = g.redistribute(g.device_mesh, _with(t, groups.dims, Shard(dim))).to_local()
        full = g.new_zeros(ctx.full_shape).index_add_(dim, groups.take.to_local(), g)
        if groups.block is not None and all(t.placements[i] == Shard(dim) for i in groups.dims):
            own = full.index_select(dim, groups.block.to_local())
            return _from_local(own, t, dim, t.shape[dim], t.placements), None, None
        mask = groups.first.to_local().reshape([1] * full.ndim)
        part = _from_local(full * mask, t, dim, t.shape[dim], _with(t, groups.dims, Partial()))
        return part.redistribute(t.mesh, t.placements), None, None


def to_groups(t, dim: int, groups: Groups):
    """``t`` (a ``DTensor`` whose dim ``dim`` holds ``groups.cols`` entries,
    sharded over the group dims or whole there) in the group layout: each
    rank the entries its group reads (gathered over the group's ranks, or
    all of them gathered first).  Its backward takes each group's whole
    gradient on each of its ranks, as the group layout's computations leave
    it."""
    return _ToGroups.apply(t, dim, groups)


class _FromGroups(torch.autograd.Function):
    """``from_groups``: forward each rank's own entries (``Groups.own``),
    or the entries whole on every rank; backward the gradient gathered and
    each rank's group's entries taken (over the group's ranks alone where
    they hold them, ``Groups.within``)."""

    @staticmethod
    def forward(ctx, t, dim, groups, whole):
        from torch.distributed.tensor import Replicate, Shard

        like = ctx.like = _Like.of(t)
        ctx.dim, ctx.groups = dim, groups
        whole_pl = _with(t, groups.dims, Replicate())
        if groups.own is not None:
            own = t.to_local().index_select(dim, groups.own.to_local())
            out = _from_local(own, like, dim, groups.cols, _with(t, groups.dims, Shard(dim)))
            return out.redistribute(like.mesh, whole_pl) if whole else out
        if groups.across and _only_group_dim_shards(t, dim, groups):
            # the groups' entries in order: gathered over one rank of each group
            full = _gather_local(t.to_local(), dim, groups.split, groups.dims[0])
            return _from_local(full, like, dim, groups.cols, whole_pl)
        full = t.redistribute(like.mesh, whole_pl).to_local()
        return _from_local(full.index_select(dim, groups.sel), like, dim, groups.cols, whole_pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard

        t, dim, groups = ctx.like, ctx.dim, ctx.groups
        if groups.within and _only_group_dim_shards(g, dim, groups):
            loc = _gather_local(g.to_local(), dim, groups.split, groups.dims[0] + 1)
        else:
            full = g.redistribute(g.device_mesh, _with(g, groups.dims, Replicate())).to_local()
            loc = full.index_select(dim, groups.take.to_local())
        return (_from_local(loc, t, dim, t.shape[dim], _with(t, groups.dims, Shard(dim))),
                None, None, None)


def from_groups(t, dim: int, groups: Groups, *, whole: bool = False):
    """``t``, in the group layout along ``dim``, in its plain layout: each
    rank its own 1/m of the entries (``Groups.own``, sharded over the group
    dims: no communication), or with ``whole`` every entry on every rank
    (gathered).  Its backward hands each group's ranks the whole gradient
    of the group's entries."""
    if groups.own is None and not whole:
        raise ValueError("from_groups: the ranks' own entries do not lie in their groups")
    return _FromGroups.apply(t, dim, groups, whole)


class _OnceAGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.groups.per, None


def once_a_group(t, groups: Groups):
    """``t`` (whole over the group dims) as an input of a computation in
    the group layout (through a function that runs on local shards): its
    gradient there is a sum over the ranks (taken, or still a ``Partial``)
    of each rank's group's whole part, so each group's m / g times; this
    divides it by m / g."""
    return _OnceAGroup.apply(t, groups)


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(n, (str, type(None))) for n in x)


@dataclass(frozen=True)
class _Names:
    """A tuple of logical names as one pytree leaf."""

    names: tuple


def _map_names(fn, tree):
    if _is_names(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_names(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_names(fn, v) for v in tree]
    raise TypeError(f"tree_sharding: {type(tree).__name__} is not a tuple of logical names")


def tree_sharding(mesh, logical_tree, rules: dict, shape_tree=None):
    """Map a pytree of logical-name tuples to ``NamedSharding``s.

    ``shape_tree``: a matching pytree of tensors (or anything with
    ``.shape``) enabling divisibility-aware rule resolution."""
    from repro_torch.pytree import tree_flatten, tree_unflatten

    if shape_tree is None:
        return _map_names(lambda n: sharding_for(mesh, n, rules), logical_tree)
    flat_names = [n.names for n in tree_flatten(_map_names(_Names, logical_tree))[0]]
    flat_shapes, tdef = tree_flatten(shape_tree)
    if len(flat_names) != len(flat_shapes):
        raise ValueError(f"tree_sharding: {len(flat_names)} name tuples, "
                         f"{len(flat_shapes)} leaves")
    return tree_unflatten(tdef, [sharding_for(mesh, n, rules, shape=tuple(s.shape))
                                 for n, s in zip(flat_names, flat_shapes)])


# ---------------------------------------------------------------------------
# Rule sets. Mesh axes: ("pod", "data", "model") or ("data", "model").
# "pod" composes with "data" for batch/FSDP sharding.
# ---------------------------------------------------------------------------

def _dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def make_rules(kind: str, *, multi_pod: bool = False, fsdp: bool = True) -> "dict[str, Any]":
    """Build the logical->mesh rule set for a shape kind.

    kind="train":  batch over (pod,)data; TP over model for heads/mlp/experts;
                   FSDP: the non-TP param dim shards over (pod,)data.
    kind="prefill"/"decode": batch over (pod,)data, TP over model; params
                   replicated over data (weight-stationary serving) unless
                   fsdp=True is forced.
    """
    dp = _dp(multi_pod)
    rules: "dict[str, Any]" = {
        # activations
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "exp_groups": dp,  # grouped MoE dispatch: groups follow the data axis
        "vocab": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "frames": None,
        # params (TP dim = model; FSDP dim = data)
        "p_embed": dp if (fsdp and kind == "train") else None,
        "p_vocab": "model",
        "p_heads": "model",
        "p_kv_heads": "model",
        "p_mlp": "model",
        "p_experts": "model",
        "p_expert_mlp": None,
        "p_ssm_inner": "model",
        "p_ssm_heads": "model",
        "p_none": None,
        "layers": None,
    }
    if kind != "train":
        # serving: keep params TP-sharded; no FSDP gather in the hot loop
        rules["p_embed"] = None
    return rules


RULE_SETS = {"train": make_rules, "prefill": make_rules, "decode": make_rules}
