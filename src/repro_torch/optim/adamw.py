"""AdamW with global-norm clipping and a warmup + cosine schedule, in
PyTorch: the port of the reference's ``optim/adamw.py``.

The state is a tree congruent with the parameters (nested dicts of
tensors).  Moments are f32; with ``quantize_moments`` the second moment
is stored as int8 with one f32 absmax scale per leaf.  Every update is
computed in f32 and cast back to the parameter's dtype (round to nearest
even, as the reference's ``astype``); ``torch.round`` rounds half to
even, as ``jnp.round`` does.

:func:`apply` is functional, like the reference's: it returns new
parameters and a new state and leaves its arguments as they were (the
train step may then be run twice from one state).  Leaves are walked in
sorted key order — the reference's tree order — so the global norm sums
its per-leaf terms in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    mu: dict                     # first moment, f32
    nu: dict                     # second moment, f32 or int8-quantized
    nu_scale: Optional[dict]     # per-leaf f32 scales when quantized


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    quantize_moments: bool = False


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac`` · lr (f32)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


# -- int8 moment quantization (per-leaf absmax) ------------------------------


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a tensor divisor: on CUDA a Python one is multiplied by its reciprocal
    scale = torch.clamp(x.abs().max(), min=1e-12) / x.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init(params: dict, cfg: AdamWConfig) -> AdamWState:
    """Zero moments beside ``params``, on their devices."""
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    if cfg.quantize_moments:
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.int8), params)
        scale = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                               device=p.device), params)
    else:
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        scale = None
    first = tree_leaves(params)[0]
    return AdamWState(torch.zeros((), dtype=torch.int32,
                                  device=first.device), mu, nu, scale)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order) of Σ x² in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def apply(
    params: dict,
    grads: dict,
    state: AdamWState,
    cfg: AdamWConfig,
) -> tuple[dict, AdamWState, dict]:
    """Returns (new_params, new_state, metrics ``{"grad_norm", "lr"}``)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)

    def upd(p, g, m, v, vs):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v_f = _dequant(v, vs) if cfg.quantize_moments else v
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        upd_ = (m / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        upd_ = upd_ + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * upd_).to(p.dtype)
        if cfg.quantize_moments:
            vq, vs_new = _quant(v_f)
            return new_p, m, vq, vs_new
        return new_p, m, v_f, None

    scales = state.nu_scale if cfg.quantize_moments else \
        tree_map(lambda p: None, params)
    out = tree_map(upd, params, grads, state.mu, state.nu, scales)

    new_p, new_m, new_v = _pick(out, 0), _pick(out, 1), _pick(out, 2)
    new_vs = _pick(out, 3) if cfg.quantize_moments else None
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step, new_m, new_v, new_vs), metrics


def _pick(tree, i: int):
    """Element ``i`` of the tuples at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
