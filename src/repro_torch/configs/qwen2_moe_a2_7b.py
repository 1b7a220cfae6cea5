"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads (MHA kv=16), 60 routed experts top-4 +
shared expert (4x expert width, sigmoid-gated), d_ff=1408/expert,
vocab=151936. RMSNorm, SwiGLU, RoPE, QKV bias (Qwen1.5 lineage).

60 experts do NOT divide the 16-way model axis -> TP-MoE strategy: every
chip holds a d_ff slice of all experts; tokens never move (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,  # per expert
    vocab_size=151936,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_type="swiglu",
    attn_qkv_bias=True,
    rope_type="rope",
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared_experts=4,  # shared expert = 4x1408 = 5632 wide
        strategy="tp",
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
