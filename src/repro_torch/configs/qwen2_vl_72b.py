"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the assignment: the vision frontend is a stub —
input_specs supplies precomputed patch/text embeddings plus (3, B, S)
M-RoPE position streams (temporal, height, width).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
    act="silu", gated_mlp=True, qkv_bias=True, embeds_input=True,
    mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, mrope_sections=(4, 2, 2), attn_block_q=16,
        attn_block_k=16, loss_chunk=16,
    )
