"""Step functions shared by the trainer and the server.

Model-family dispatch (decoder-only LM vs encoder–decoder) happens here,
so the launchers stay family-agnostic:

  ``train_step(params, opt_state, batch)   -> (params, opt_state, metrics)``
  ``prefill_step(params, batch)             -> (logits, caches)``
  ``decode_step(params, cache, token, pos)  -> (logits, cache)``

The train step is the reference's: loss, its gradient, gradient
accumulation over microbatches, then the AdamW update.  It trains every
family: dense (dense, vlm, audio), MoE, SSM (the SSD's gradient through
its backward kernel), the hybrid (Jamba's superblock of all three) and
the encoder–decoder (``encdec.encdec_loss``), with ``mlp_impl`` dense or
streamed (the fused MLP's gradient through its backward kernel).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# family dispatch
# ---------------------------------------------------------------------------

def model_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.family == "encdec":
        return encdec.encdec_loss(params, cfg, batch)
    return lm.lm_loss(params, cfg, batch)


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


# ---------------------------------------------------------------------------
# gradient accumulation helpers
# ---------------------------------------------------------------------------

#: batch leaves whose microbatch split axis is not 0
_SPLIT_AXIS = {"mrope_positions": 1}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches of ``batch`` (views): each leaf cut into
    ``accum`` equal parts along its batch axis (``_SPLIT_AXIS``; 0
    otherwise), in order."""
    def parts(name, x):
        ax = _SPLIT_AXIS.get(name, 0)
        b = x.shape[ax]
        if b % accum:
            raise ValueError(f"{name}: batch {b} does not split into "
                             f"{accum} microbatches")
        return torch.chunk(x, accum, dim=ax)

    split = {name: parts(name, x) for name, x in batch.items()}
    return [{name: split[name][i] for name in batch} for i in range(accum)]


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, grads): the loss of ``batch`` and its gradient for every
    parameter leaf, in the leaf's dtype."""
    with torch.enable_grad():
        live = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        loss = model_loss(live, cfg, batch)
        leaves = adamw.tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves)
    flat = iter(grads)
    return loss.detach(), _rebuild(live, flat)


def _rebuild(tree, flat):
    """``tree``'s structure filled from ``flat`` in sorted key order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat) for k in sorted(tree)}
    return next(flat)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    grad_accum: int = 1,
) -> Callable:
    """Forward + backward + AdamW update, optionally microbatched: with
    ``grad_accum`` > 1 the batch is cut into that many microbatches whose
    gradients are summed in f32 and divided by ``grad_accum`` (the loss
    too), as the reference's ``lax.scan`` over microbatches does.  The
    returned step leaves its arguments unchanged (``adamw.apply`` is
    functional)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = _value_and_grad(cfg, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for mb in _split_microbatches(batch, grad_accum):
                l, g = _value_and_grad(cfg, params, mb)
                loss = loss.to(l.device) + l
                adamw.tree_map(lambda a, b: a.add_(b.to(torch.float32)),
                               grads, g)
                del g
            loss = loss / grad_accum
            grads = adamw.tree_map(lambda g: g / grad_accum, grads)

        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return model_prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, token, pos):
        return model_decode(params, cfg, cache, token, pos)

    return decode_step
