"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    act="silu", gated_mlp=True, rope_theta=10_000.0,
    moe=MoeConfig(num_experts=32, top_k=8),
    pad_vocab_to=256,
    tp_preference=8,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=32,
        vocab_size=256, moe=MoeConfig(num_experts=8, top_k=2),
        attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
