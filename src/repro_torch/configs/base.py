"""Architecture / shape configuration schema.

The port's own copy of ``src/repro/configs/base.py`` (which imports no
JAX; the port imports nothing of ``repro``).  Every architecture is
described by an ``ArchConfig``; the four input shapes live in ``SHAPES``.
``smoke()`` derives the reduced config used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional

__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SSMConfig",
    "EncDecConfig",
    "ShapeConfig",
    "SHAPES",
    "smoke",
]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # "ep": experts sharded over the model axis, all-to-all dispatch.
    # "tp": every chip holds a d_ff slice of all experts, no token motion
    #        (used when num_experts does not divide the model axis).
    strategy: str = "ep"
    router_jitter: float = 0.0
    renormalize: bool = True
    # dispatch groups (GShard-style): tokens are dispatched within groups
    # whose dim shards over the data axis, so the scatter/gather never
    # crosses data shards. 1 = single global group (paper-era baseline).
    dispatch_groups: int = 1


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    encoder_seq: int  # frames after the conv frontend STUB (whisper: 1500)
    max_target_positions: int = 448


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # block structure
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nobias | nonparam_layernorm
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu_mlp
    attn_qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False

    # positions
    rope_type: str = "rope"  # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0
    mrope_sections: "tuple[int, ...]" = ()  # M-RoPE (t, h, w) head_dim split

    # attention variants
    sliding_window: Optional[int] = None  # tokens; None = full
    global_attn_layers: "tuple[int, ...]" = ()  # hybrid: full-attn exceptions
    kv_share_group: int = 1  # hymba cross-layer KV sharing group size
    attn_logit_softcap: Optional[float] = None

    # substructures
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None

    # hybrid (hymba): parallel attention + SSM heads in one block
    hybrid_attn_ssm: bool = False
    meta_tokens: int = 0

    # vlm stub
    vision_stub: bool = False
    num_patches: int = 0  # patch embeddings supplied by input_specs

    # bookkeeping
    max_seq: int = 1 << 19
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 524k-token decode cell?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        attn = 0
        if not self.attn_free:
            q = d * self.num_heads * self.hd
            kv = 2 * d * self.num_kv_heads * self.hd
            o = self.num_heads * self.hd * d
            attn = q + kv + o
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.moe is not None:
            e = self.moe
            per = 3 * d * e.d_ff_expert
            mlp = (e.num_experts + e.num_shared_experts) * per + d * e.num_experts
        ssm = 0
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            s = self.ssm
            di = s.d_inner(d)
            # in_proj (z,x,B,C,dt) + conv + out_proj (mamba2 layout)
            conv_dim = di + 2 * s.n_groups * s.d_state
            ssm = d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d)) + conv_dim * s.d_conv + di * d
            if self.family == "ssm":
                attn = 0
                mlp = 0  # mamba2 blocks have no separate MLP
        layers = self.num_layers * (attn + mlp + ssm)
        if self.encdec is not None:
            # encoder adds its own stack; decoder adds cross-attention
            enc = self.encdec.encoder_layers * (attn + mlp)
            cross = self.num_layers * attn
            layers += enc + cross
        return int(total + layers)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d = self.d_model
        per = 3 * d * e.d_ff_expert
        dense_like = self.param_count() - self.num_layers * (e.num_experts + e.num_shared_experts) * per
        return int(dense_like + self.num_layers * (e.top_k + e.num_shared_experts) * per)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: "dict[str, ShapeConfig]" = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        max_seq=128,
        num_patches=4 if cfg.vision_stub else 0,
        meta_tokens=4 if cfg.meta_tokens else 0,
        sliding_window=16 if cfg.sliding_window else None,
        global_attn_layers=(0,) if cfg.global_attn_layers else (),
        kv_share_group=cfg.kv_share_group,
    )
    if cfg.mrope_sections:
        kw["mrope_sections"] = (4, 2, 2)
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe,
            num_experts=min(8, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=32,
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.encdec is not None:
        kw["encdec"] = replace(cfg.encdec, encoder_layers=2, encoder_seq=24, max_target_positions=64)
    return replace(cfg, name=cfg.name + "-smoke", **kw)
