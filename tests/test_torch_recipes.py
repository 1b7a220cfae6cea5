"""The port's distribution recipes and logical-axis rules
(``repro_torch.distribution``) and the config helpers ``get_shape``/
``cells`` and ``batch_logical_specs``, held equal to the JAX package's for
every (arch, shape) cell, plus the port of ``tests/test_sharding.py``'s
``test_plans_materialize_for_all_cells``.  ``axis_rules`` activates a
mesh beside the rules, thread-locally (``tests/test_torch_sharding.py``
holds the mesh half).
"""
import dataclasses

import pytest

import repro.configs as jcfg
from repro.distribution.recipes import MODEL_AXIS as JAX_MODEL_AXIS
from repro.distribution.recipes import plan_for as jax_plan_for
from repro.distribution.sharding import RULE_SETS as JAX_RULE_SETS
from repro.distribution.sharding import make_rules as jax_make_rules
from repro.models.model import batch_logical_specs as jax_batch_logical_specs
from repro_torch.configs import cells, get_config, get_shape
from repro_torch.distribution.recipes import MODEL_AXIS, plan_for
from repro_torch.distribution.sharding import (RULE_SETS, axis_rules, current_mesh,
                                               current_rules, make_rules)
from repro_torch.models import batch_logical_specs


def test_torch_cells_and_shapes_equal_reference():
    assert cells() == jcfg.cells()
    for name in jcfg.SHAPES:
        assert dataclasses.asdict(get_shape(name)) == dataclasses.asdict(jcfg.get_shape(name))
    with pytest.raises(KeyError):
        get_shape("train_1m")


@pytest.mark.parametrize("arch,shape", jcfg.cells())
def test_torch_plan_for_equals_reference(arch, shape):
    for multi_pod in (False, True):
        got = plan_for(get_config(arch), get_shape(shape), multi_pod=multi_pod)
        want = jax_plan_for(jcfg.get_config(arch), jcfg.get_shape(shape), multi_pod=multi_pod)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert batch_logical_specs(get_config(arch), get_shape(shape)) == jax_batch_logical_specs(
        jcfg.get_config(arch), jcfg.get_shape(shape))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_torch_make_rules_equals_reference(kind):
    assert MODEL_AXIS == JAX_MODEL_AXIS
    assert sorted(RULE_SETS) == sorted(JAX_RULE_SETS)
    for multi_pod in (False, True):
        for fsdp in (False, True):
            assert make_rules(kind, multi_pod=multi_pod, fsdp=fsdp) == jax_make_rules(
                kind, multi_pod=multi_pod, fsdp=fsdp)
    assert RULE_SETS[kind](kind) == JAX_RULE_SETS[kind](kind)


@pytest.mark.parametrize("arch,shape", cells())
def test_torch_plans_materialize_for_all_cells(arch, shape):
    cfg = get_config(arch)
    plan = plan_for(cfg, get_shape(shape))
    assert plan.rules["batch"] is None or plan.rules["batch"] == ("data",)
    if cfg.moe is not None:
        if cfg.moe.strategy == "ep":
            assert plan.rules["p_experts"] == "model"
        else:
            assert plan.rules["p_expert_mlp"] == "model"
    if shape.startswith("long"):
        assert plan.rules["batch"] is None  # batch=1 cannot shard


def test_torch_axis_rules_is_thread_local_and_refuses_a_mesh():
    import threading

    rules = make_rules("train")
    assert current_rules() is None and current_mesh() is None
    seen = []
    with axis_rules(rules):
        assert current_rules() is rules
        t = threading.Thread(target=lambda: seen.append(current_rules()))
        t.start()
        t.join()
        with axis_rules({"batch": None}):
            assert current_rules() == {"batch": None}
        assert current_rules() is rules
    assert current_rules() is None and seen == [None]
    # a mesh activates beside the rules, for this thread only
    mesh, seen = object(), []
    with axis_rules(rules, mesh=mesh):
        assert current_mesh() is mesh and current_rules() is rules
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join()
    assert current_mesh() is None and seen == [None]
