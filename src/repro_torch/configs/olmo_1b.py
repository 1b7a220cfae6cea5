"""OLMo-1B [arXiv:2402.00838; hf].

16L, d_model=2048, 16 heads (MHA), d_ff=8192, vocab=50304.
Non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_layernorm",
    norm_eps=1e-5,
    mlp_type="swiglu",
    rope_type="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
