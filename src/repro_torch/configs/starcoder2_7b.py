"""StarCoder2-7B [arXiv:2402.19173; hf].

32L, d_model=4608, 36 heads (GQA kv=4), d_ff=18432, vocab=49152.
Parametric LayerNorm with bias, plain GELU MLP (c_fc/c_proj), RoPE,
attention + MLP biases.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="gelu_mlp",
    attn_qkv_bias=True,
    attn_out_bias=True,
    mlp_bias=True,
    rope_type="rope",
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173",
)
