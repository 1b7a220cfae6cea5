"""Qwen2-VL-72B language backbone [arXiv:2409.12191; hf].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
M-RoPE (multimodal 3D rotary, sections t/h/w), dynamic-resolution vision
frontend is a STUB: ``input_specs()`` supplies precomputed patch embeddings
merged at image-pad positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_type="swiglu",
    attn_qkv_bias=True,  # Qwen2 uses QKV bias
    rope_type="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t,h,w split of head_dim/2
    vision_stub=True,
    num_patches=256,
    source="arXiv:2409.12191",
)
