"""Step functions shared by the server (and, once ported, the trainer).

Model-family dispatch (decoder-only LM vs encoder–decoder) happens here,
so the launchers stay family-agnostic:

  ``prefill_step(params, batch)             -> (logits, caches)``
  ``decode_step(params, cache, token, pos)  -> (logits, cache)``

The train step comes with training (ROADMAP §A item 4).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


def model_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.family == "encdec":
        return encdec.init_params(gen, cfg)
    return lm.init_params(gen, cfg)


def model_prefill(params: dict, cfg: ModelConfig, batch: dict):
    if cfg.family == "encdec":
        return encdec.encdec_prefill(params, cfg, batch)
    return lm.lm_prefill(params, cfg, batch)


def model_decode(params: dict, cfg: ModelConfig, cache, token, pos: int):
    if cfg.family == "encdec":
        return encdec.encdec_decode(params, cfg, cache, token, pos)
    return lm.lm_decode(params, cfg, cache, token, pos)


def model_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device=None):
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, mem_len=max_len,
                                 max_len=max_len, device=device)
    return lm.init_cache(cfg, batch, max_len, device=device)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return model_prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, token, pos):
        return model_decode(params, cfg, cache, token, pos)

    return decode_step
