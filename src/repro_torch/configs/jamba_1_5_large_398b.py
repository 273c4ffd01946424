"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf].

Deviation note (DESIGN.md §4): Jamba publishes Mamba-1 mixers; this repo
uses Mamba-2 (SSD) blocks as its SSM substrate for all SSM-bearing archs
— same O(1)-state streaming role, kernel shared with mamba2-1.3b.
Sub-quadratic: the 1-in-8 attention layers hold the only KV cache, so
long_500k decode is runnable (sharded 9-layer 500k cache).
"""
from .base import ModelConfig, MoeConfig, SsmConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
    d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
    vocab_size=65536, act="silu", gated_mlp=True,
    moe=MoeConfig(num_experts=16, top_k=2, moe_period=2),
    ssm=SsmConfig(state_dim=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=64),
    attn_period=8, sub_quadratic=True, rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, moe=MoeConfig(num_experts=4, top_k=2, moe_period=2),
        ssm=SsmConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk=8),
        attn_period=8, attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
