"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU ungated MLP [arXiv:2402.16819; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=24576, vocab_size=256000,
    act="squared_relu", gated_mlp=False, rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, attn_block_q=16, attn_block_k=16, loss_chunk=16,
    )
