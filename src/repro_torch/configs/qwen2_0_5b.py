"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA with QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    act="silu", gated_mlp=True, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    tp_preference=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
