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
  hand-written kernel, a convolution ``DTensor`` shards wrongly) on each
  rank's local shards, along the dims the function treats independently.

A ``mesh`` is a ``DeviceMesh`` (``launch.mesh``); ``spec_for`` also takes
anything with ``axis_names`` and ``devices.shape``, as the reference's
tests pass a stand-in of the production mesh.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional, Sequence

__all__ = [
    "NamedSharding",
    "PartitionSpec",
    "RULE_SETS",
    "axis_rules",
    "constrain",
    "current_mesh",
    "current_rules",
    "make_rules",
    "on_local_shards",
    "sharding_for",
    "spec_for",
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


def on_local_shards(fn, inputs: "Sequence", shard_dims: dict):
    """``fn(*inputs)``, and where an input is a ``DTensor``, on each rank's
    local shards.

    ``shard_dims`` names the axes ``fn`` treats independently (batch rows,
    heads, channels): ``{axis: (the axis's dim in each input, in each
    output)}``, None where a tensor lacks it.  A mesh dim along which every
    input is sharded evenly on its dim of one such axis, or replicated where
    it lacks the axis, stays sharded; the inputs are gathered (redistributed
    replicated) along every other mesh dim.  An input replicated along a
    sharded mesh dim adds up its gradient over it, since each rank's shard
    of the work contributes a part.  The outputs come back as ``DTensor``s
    sharded the same way (a tensor or a tuple of tensors, as ``fn``
    returns)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(x, DTensor) for x in inputs):
        return fn(*inputs)
    mesh = next(x.device_mesh for x in inputs if isinstance(x, DTensor))
    rep = [Replicate()] * mesh.ndim
    xs = [x if isinstance(x, DTensor) else DTensor.from_local(x, mesh, rep, run_check=False)
          for x in inputs]
    # the independent axis each mesh dim shards, or None: gathered
    picks = [next((axis for axis, (din, _) in shard_dims.items()
                   if all(isinstance(x.placements[i], Replicate) if d is None
                          else x.placements[i] == Shard(d) for x, d in zip(xs, din))), None)
             for i in range(mesh.ndim)]
    for axis in set(picks) - {None}:  # uneven shards are gathered
        n = 1
        for i, p in enumerate(picks):
            n *= mesh.size(i) if p == axis else 1
        if any(d is not None and x.shape[d] % n for x, d in zip(xs, shard_dims[axis][0])):
            picks = [None if p == axis else p for p in picks]

    def placements(k: int, which: int):
        return [Shard(shard_dims[p][which][k]) if p is not None
                and shard_dims[p][which][k] is not None else Replicate() for p in picks]

    local = []
    for j, x in enumerate(xs):
        pl = placements(j, 0)
        grad = [Partial() if p is not None and isinstance(q, Replicate) else q
                for p, q in zip(picks, pl)]
        local.append(x.redistribute(mesh, pl).to_local(grad_placements=grad))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(DTensor.from_local(o, mesh, placements(k, 1), run_check=False)
                for k, o in enumerate(outs))
    return res if isinstance(out, tuple) else res[0]


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
