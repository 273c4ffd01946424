"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    act="silu", gated_mlp=True, rope_theta=10_000.0,
    moe=MoeConfig(num_experts=64, top_k=8),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
        vocab_size=256, moe=MoeConfig(num_experts=8, top_k=2),
        attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
