"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L, d_model=2048, 32 heads (MHA kv=32), d_ff=5632, vocab=100352.
LayerNorm, SwiGLU, partial rotary (25% of head_dim), QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="swiglu",
    attn_qkv_bias=True,
    rope_type="rope",
    rope_theta=10_000.0,
    partial_rotary=0.25,
    source="hf:stabilityai/stablelm-2-1_6b",
)
