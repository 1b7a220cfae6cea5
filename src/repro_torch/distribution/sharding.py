"""Logical-axis rules, MaxText-style: a rule set maps logical tensor axes
("batch", "seq", "embed", "heads", "mlp", "experts", ...) to mesh axes
(``src/repro/distribution/sharding.py``, its rules half).

``make_rules``/``RULE_SETS`` build the reference's rule sets, and
``axis_rules`` activates a set for the calling thread, read back by
``current_rules``.  The mesh half (``spec_for``, ``sharding_for``,
``tree_sharding``, ``constrain``) comes with ROADMAP item 11: until then
no mesh can be activated, and ``axis_rules`` with one raises
``NotImplementedError``.  Outside a mesh the rules annotate nothing, as in
the reference, so the same model runs unsharded on one device.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Optional

__all__ = ["RULE_SETS", "axis_rules", "current_mesh", "current_rules", "make_rules"]

_state = threading.local()


def _get() -> "tuple[Optional[dict], Any]":
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


@contextmanager
def axis_rules(rules: "dict[str, Any]", mesh=None):
    """Activate logical->mesh rules for this thread.  A ``mesh`` raises
    ``NotImplementedError``: meshes come with ROADMAP item 11."""
    if mesh is not None:
        raise NotImplementedError("axis_rules: a device mesh (DeviceMesh/DTensor sharding) "
                                  "comes with ROADMAP item 11; the port runs on one device")
    old = _get()
    _state.rules, _state.mesh = rules, None
    try:
        yield
    finally:
        _state.rules, _state.mesh = old


def current_rules() -> "Optional[dict]":
    return _get()[0]


def current_mesh():
    """Always None until meshes come (ROADMAP item 11)."""
    return _get()[1]


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
