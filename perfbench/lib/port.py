"""What the benchmark takes from the program: its model configuration,
built from a configuration file's keys, and the program's own counters."""
from __future__ import annotations

import dataclasses


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: every key that
    names a field of it, ``moe`` and ``ssm`` as its nested configs."""
    from repro_torch.configs.base import ModelConfig, MoeConfig, SsmConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if cfg.get("moe"):
        kw["moe"] = MoeConfig(**cfg["moe"])
    if cfg.get("ssm"):
        kw["ssm"] = SsmConfig(**cfg["ssm"])
    return ModelConfig(**kw)


def kernel_calls() -> dict:
    """The program's count of calls of each hand-written kernel so far."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ms

    return {"attn_fwd": fa.launches, "attn_bwd": fa.bwd_launches,
            "ssd_fwd": ms.launches, "ssd_bwd": ms.bwd_launches}
