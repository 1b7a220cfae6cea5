"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid-head architecture.

32L, d_model=1600, 25 heads (GQA kv=5, head_dim=64), d_ff=5504,
ssm_state=16, vocab=32001. Every block runs attention heads and Mamba
(SSM) heads IN PARALLEL on the same input; outputs are fused (mean of the
per-path normalized outputs). Sliding-window attention (1024) everywhere
except 3 global layers (first / middle / last); consecutive layers share
KV (cross-layer KV sharing, group=2); 128 learned meta tokens prefix the
sequence. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_type="swiglu",
    rope_type="rope",
    rope_theta=10_000.0,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    kv_share_group=2,
    meta_tokens=128,
    hybrid_attn_ssm=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2411.13676",
)
