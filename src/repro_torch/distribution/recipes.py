"""Per-(arch x shape) distribution recipes (``src/repro/distribution/
recipes.py``, copied: pure Python).

A ``CellPlan`` fixes everything the launcher needs: logical->mesh rules,
remat policy, attention q-block, microbatch count, cache dtype.  On one
device only the remat policy, the q-block, the microbatch count and the
compute dtype act; the rules act under a mesh (``launch.train``'s
``mesh=``, ``distribution.sharding``).

Decode KV-cache strategy (the reference's, for a mesh):
  * kv_heads divides the model axis -> shard cache on kv_heads;
  * otherwise shard cache on *seq* over model (flash-decoding style).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distribution.sharding import make_rules

MODEL_AXIS = 16


@dataclass(frozen=True)
class CellPlan:
    arch: str
    shape: str
    kind: str
    rules: dict
    remat: str = "none"
    q_block: Optional[int] = 512
    num_microbatches: int = 1
    cache_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moe_groups: Optional[int] = None  # None = keep the config's value


def _moe_overrides(cfg: ArchConfig) -> dict:
    if cfg.moe is None:
        return {}
    if cfg.moe.strategy == "ep":
        return {
            "experts": "model",
            "expert_mlp": None,
            "p_experts": "model",
            "p_expert_mlp": None,
        }
    return {  # TP-MoE: slice every expert's d_ff; tokens never move
        "experts": None,
        "expert_mlp": "model",
        "p_experts": None,
        "p_expert_mlp": "model",
    }


def plan_for(cfg: ArchConfig, shape: ShapeConfig, *, multi_pod: bool = False) -> CellPlan:
    kind = shape.kind
    rules = make_rules(kind, multi_pod=multi_pod)
    rules.update(_moe_overrides(cfg))

    n_params = cfg.param_count()

    if kind == "train":
        # full remat everywhere: without it the q-block attention scan saves
        # the (B,H,S,S) softmax weights for backward (probe: 107 GB/dev on
        # olmo-1b) — recompute is the production policy at these sizes.
        remat = "full" if n_params > 5e8 else "dots"
        micro = 4 if n_params > 3e10 else (2 if n_params > 5e9 else 1)
        q_block = 512 if shape.seq_len > 2048 else None
    else:
        remat = "none"
        micro = 1
        q_block = 512 if (kind == "prefill" and shape.seq_len > 2048) else None

    if kind == "decode":
        if cfg.num_kv_heads and cfg.num_kv_heads % MODEL_AXIS == 0:
            rules["seq"] = None  # cache shards on kv_heads
        else:
            # flash-decoding: shard cache seq over model; kv_heads replicate
            rules["kv_heads"] = None
            rules["seq"] = "model"
        if shape.global_batch == 1:
            # long_500k: nothing to shard over data from the batch; put the
            # cache seq dim over (data, model) so the 524k KV/state fits
            rules["seq"] = ("data", "model")
            rules["batch"] = None

    # prefill activations: shard seq over data? keep batch over data (>=16)
    return CellPlan(
        arch=cfg.name,
        shape=shape.name,
        kind=kind,
        rules=rules,
        remat=remat,
        q_block=q_block,
        num_microbatches=micro,
    )
