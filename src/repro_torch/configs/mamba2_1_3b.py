"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].

The arch with the strongest affinity to the paper (DESIGN.md §4): the
whole sequence mixer is a streaming line buffer (conv window + SSD
state).  Sub-quadratic → long_500k decode runs.
"""
from .base import ModelConfig, SsmConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm=SsmConfig(state_dim=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=64),
    sub_quadratic=True,
    pad_vocab_to=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=64,
        ssm=SsmConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk=8),
        vocab_size=256, loss_chunk=16,
    )
