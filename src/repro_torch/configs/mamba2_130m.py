"""Mamba2-130M [arXiv:2405.21060; unverified] — SSD (state-space duality).

24L, d_model=768, attention-free, ssm_state=128, expand=2 (d_inner=1536),
64-dim SSM heads (24 heads), vocab=50280. RMSNorm, tied embeddings.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    rope_type="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)
