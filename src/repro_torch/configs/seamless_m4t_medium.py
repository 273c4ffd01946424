"""seamless-m4t-medium [audio]: enc-dec 12+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

Modality frontend is a stub per the assignment: input_specs provides
precomputed frame embeddings (B, T, d_model).  Enc-dec shape mapping
(DESIGN.md §4): train_4k = enc 4096 frames + dec 1024 targets;
prefill_32k = enc 32768 frames; decode_32k = one decoder token against a
32k cross memory + 32k self cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
    vocab_size=256206, enc_layers=12, dec_layers=12,
    act="gelu", gated_mlp=False, embeds_input=True, rope_theta=10_000.0,
)

#: decoder target length for train_4k (enc frames = shape seq_len)
DEC_TRAIN_FRAC = 4


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        enc_layers=2, dec_layers=2, num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, attn_block_q=16,
        attn_block_k=16, loss_chunk=16,
    )
