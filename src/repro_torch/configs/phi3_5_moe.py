"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), 16 experts top-2, d_ff=6400/expert,
vocab=32064. RMSNorm-style (uses LayerNorm in HF config; we follow the MoE
reference layout), SwiGLU experts, RoPE. 16 experts divide the 16-way model
axis exactly -> true expert parallelism (all-to-all dispatch).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,  # per expert
    vocab_size=32064,
    norm_type="layernorm_nobias",
    norm_eps=1e-5,
    mlp_type="swiglu",
    rope_type="rope",
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=6400,
        num_shared_experts=0,
        strategy="ep",
    ),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
