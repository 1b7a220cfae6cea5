"""DeepSeek-67B [arXiv:2401.02954; hf] — llama-architecture dense LM.

95L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=102400.
RMSNorm, SwiGLU, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_type="swiglu",
    rope_type="rope",
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
)
