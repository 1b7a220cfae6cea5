"""The port's logical-axis sharding (``repro_torch.distribution.sharding``)
held against the JAX package's on the CPU, with no process group.

* ``spec_for`` on every case of ``tests/test_sharding.py`` (divisibility,
  axis reuse, trailing ``None``s) equals the reference's ``P(...)``, entry
  for entry.
* For every (config, cell) ``test_plans_materialize_for_all_cells`` covers:
  the port's plan rules are the reference's, every family's
  ``param_specs`` names the reference's, and ``spec_for`` of every param
  and every batch input under the cell's rules on the production mesh's
  shape (16 x 16; 2 x 16 x 16 multi-pod) equals the reference's.
* ``sharding_for`` puts a spec on a mesh as one placement a mesh dim;
  ``constrain`` is a no-op outside rules and for a plain tensor;
  ``input_specs`` gives meta tensors of the reference's shapes and dtypes.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import cells, get_config as jax_get_config, get_shape as jax_get_shape
from repro.distribution.recipes import plan_for as jax_plan_for
from repro.distribution.sharding import spec_for as jax_spec_for
from repro.models.model import get_model as jax_get_model, input_specs as jax_input_specs
from repro_torch.configs import get_config, get_shape
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import (PartitionSpec, axis_rules, constrain,
                                               current_mesh, sharding_for, spec_for,
                                               tree_sharding)
from repro_torch.models import batch_logical_specs, get_model, input_specs


class FakeMesh:
    axis_names = ("data", "model")

    class devices:  # noqa: D106 - just needs .shape
        shape = (16, 16)


class FakePodMesh:
    axis_names = ("pod", "data", "model")

    class devices:  # noqa: D106
        shape = (2, 16, 16)


class FakeDeviceMesh:
    """What ``placements_for`` reads of a ``DeviceMesh``."""

    mesh_dim_names = ("data", "model")
    shape = (2, 2)


MESH = FakeMesh()
RULES = {"batch": ("data",), "heads": "model", "mlp": "model", "seq": None}

CASES = [
    (("batch", "seq", "heads"), RULES, None, None),
    (("batch", "seq"), RULES, None, None),
    (("batch", "heads"), RULES, (32, 36), MESH),
    (("batch", "heads"), RULES, (32, 32), MESH),
    (("a", "b"), {"a": "model", "b": "model"}, (16, 16), MESH),
    (("batch",), RULES, (1,), MESH),
]


def _same(port_spec, jax_spec) -> bool:
    return isinstance(port_spec, PartitionSpec) and tuple(port_spec) == tuple(jax_spec)


@pytest.mark.parametrize("names,rules,shape,mesh", CASES)
def test_torch_spec_for_matches_jax_cases(names, rules, shape, mesh):
    got = spec_for(names, rules, shape=shape, mesh=mesh)
    want = jax_spec_for(names, rules, shape=shape, mesh=mesh)
    assert _same(got, want), (got, want)


def test_torch_spec_for_reference_values():
    """The reference test's expected values, literally."""
    assert spec_for(("batch", "seq", "heads"), RULES) == PartitionSpec(("data",), None, "model")
    assert spec_for(("batch", "seq"), RULES) == PartitionSpec(("data",))
    assert spec_for(("batch", "heads"), RULES, shape=(32, 36), mesh=MESH) == PartitionSpec(
        ("data",))
    assert spec_for(("batch", "heads"), RULES, shape=(32, 32), mesh=MESH) == PartitionSpec(
        ("data",), "model")
    assert spec_for(("a", "b"), {"a": "model", "b": "model"}, shape=(16, 16),
                    mesh=MESH) == PartitionSpec("model")
    assert spec_for(("batch",), RULES, shape=(1,), mesh=MESH) == PartitionSpec()
    # a one-name tuple is the name, as JAX normalises it
    assert tuple(PartitionSpec(("data",), None, ("pod", "data"))) == tuple(
        P(("data",), None, ("pod", "data"))) == ("data", None, ("pod", "data"))


def _walk(names, shapes, out, path=()):
    """(path, names, shape) for every leaf of a names tree beside its
    shapes tree (port ``param_shapes``)."""
    if isinstance(names, dict):
        assert set(names) == set(shapes), path
        for k in sorted(names):
            _walk(names[k], shapes[k], out, path + (k,))
    elif isinstance(names, list):
        assert len(names) == len(shapes), path
        for i, (n, s) in enumerate(zip(names, shapes)):
            _walk(n, s, out, path + (i,))
    else:
        assert len(names) == len(shapes), (path, names, shapes)
        out.append((path, tuple(names), tuple(shapes)))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", cells())
def test_torch_cell_specs_match_jax(arch, shape, multi_pod):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sc = get_shape(shape)
    plan, jplan = plan_for(cfg, sc, multi_pod=multi_pod), jax_plan_for(
        jcfg, jax_get_shape(shape), multi_pod=multi_pod)
    assert plan.rules == jplan.rules
    # the reference test's assertions, on the port's plan
    assert plan.rules["batch"] is None or plan.rules["batch"] == (
        ("pod", "data") if multi_pod else ("data",))
    if shape.startswith("long"):
        assert plan.rules["batch"] is None

    m = get_model(cfg)
    names = m.param_specs(cfg)
    assert names == jax_get_model(jcfg).param_specs(jcfg)
    mesh = FakePodMesh() if multi_pod else MESH
    leaves = _walk(names, m.param_shapes(cfg), [])
    assert leaves
    for path, n, s in leaves:
        got = spec_for(n, plan.rules, shape=s, mesh=mesh)
        want = jax_spec_for(n, jplan.rules, shape=s, mesh=mesh)
        assert _same(got, want), (path, got, want)
    blog = batch_logical_specs(cfg, sc)
    for k, meta in input_specs(cfg, sc).items():
        got = spec_for(blog[k], plan.rules, shape=tuple(meta.shape), mesh=mesh)
        want = jax_spec_for(blog[k], jplan.rules, shape=tuple(meta.shape), mesh=mesh)
        assert _same(got, want), (k, got, want)


@pytest.mark.parametrize("arch,shape", [c for c in cells() if c[0] in ("olmo-1b", "whisper-tiny",
                                                                         "qwen2-vl-72b")])
def test_torch_input_specs_match_jax(arch, shape):
    got = input_specs(get_config(arch), get_shape(shape))
    want = jax_input_specs(jax_get_config(arch), jax_get_shape(shape))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).split(".")[-1] == str(np.dtype(want[k].dtype)), (k, t.dtype)


def test_torch_sharding_for_places_one_placement_a_mesh_dim():
    mesh = FakeDeviceMesh()
    rules = {"batch": ("data",), "heads": "model", "both": ("data", "model")}
    sh = sharding_for(mesh, ("batch", "seq", "heads"), rules, shape=(4, 8, 6))
    assert sh.spec == ("data", None, "model")
    assert sh.placements == (Shard(0), Shard(2)) and sh.mesh is mesh
    # a rule that does not divide the dim is dropped: replicated there
    assert sharding_for(mesh, ("batch", "heads"), rules, shape=(3, 6)).placements == (
        Replicate(), Shard(1))
    # one dim over both mesh axes
    assert sharding_for(mesh, (None, "both"), rules, shape=(2, 8)).placements == (
        Shard(1), Shard(1))
    tree = tree_sharding(mesh, {"w": ("batch", "heads"), "n": [("heads",)]}, rules,
                         {"w": torch.empty(4, 6), "n": [torch.empty(5)]})
    assert tree["w"].placements == (Shard(0), Shard(1))
    assert tree["n"][0].placements == (Replicate(), Replicate())  # 5 % 2: replicated
    assert tree_sharding(mesh, {"n": [("heads",)]}, rules)["n"][0].placements == (
        Replicate(), Shard(0))
    # a mesh dim of one rank holds whole tensors: replicated whatever the spec
    one = type("OneByTwo", (), {"mesh_dim_names": ("data", "model"), "shape": (1, 2)})()
    sh = sharding_for(one, ("batch", "seq", "heads"), rules, shape=(4, 8, 6))
    assert sh.spec == ("data", None, "model") and sh.placements == (Replicate(), Shard(2))


def test_torch_constrain_is_a_noop_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "batch", "heads") is x  # no rules
    with axis_rules({"batch": ("data",)}):
        assert constrain(x, "batch", "heads") is x and current_mesh() is None
    with axis_rules({"batch": ("data",)}, FakeDeviceMesh()) as _:
        assert constrain(x, "batch", None) is x  # a plain tensor passes as is
        assert isinstance(current_mesh(), FakeDeviceMesh)
    assert current_mesh() is None
    assert jax.tree.leaves([]) == []  # the reference imports cleanly beside the port
