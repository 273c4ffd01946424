"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    act="silu", gated_mlp=True, rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
