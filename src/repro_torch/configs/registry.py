"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

import importlib

ARCHS = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-0.5b": "qwen2_0_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-9b": "yi_9b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-1.3b": "mamba2_1_3b",
}


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.smoke_config() if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
