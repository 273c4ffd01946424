"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000 — llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense", num_layers=48, d_model=4096,
    num_heads=32, num_kv_heads=4, d_ff=11008, vocab_size=64000,
    act="silu", gated_mlp=True, rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
