"""Whisper-tiny [arXiv:2212.04356; unverified] — encoder-decoder audio model.

4L encoder + 4L decoder, d_model=384, 6 heads (MHA), d_ff=1536,
vocab=51865. LayerNorm(+bias), GELU MLP, learned positions (decoder),
conv frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings (batch, 1500, 384) for the encoder.

decode_32k note (DESIGN.md §4): the real model caps decoder positions at
448; the 32k-KV decode cell exercises the runtime/sharding structurally
with positions taken from config.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_type="gelu_mlp",
    attn_qkv_bias=True,
    attn_out_bias=True,
    mlp_bias=True,
    rope_type="learned",
    encdec=EncDecConfig(encoder_layers=4, encoder_seq=1500, max_target_positions=448),
    source="arXiv:2212.04356",
)
