"""AdamW as the configuration's optimizer states it, in plain float32:
the gradient clipped to a global norm, a linear warm-up and then a cosine
decay of the learning rate to ``min_lr_frac`` of it over ``total_steps``,
moments in float32, decoupled weight decay on every leaf, and each new
parameter stored in its leaf's storage type (round to nearest even)."""
from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, step: int) -> float:
    """The rate of step ``step`` (1 for the first)."""
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"]
    return opt["lr"] * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """The optimizer over a flat list of float32 leaves, each with the
    storage type its values are rounded to after an update."""

    def __init__(self, opt: dict, leaves: list, storage: list):
        self.opt = opt
        self.storage = storage
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    def clipped(self, grads: list) -> list:
        """The gradients as the update takes them, clipped to the global
        norm ``grad_clip``."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.clamp(self.opt["grad_clip"] / (norm + 1e-9), max=1.0)
        return [g * clip for g in grads]

    @torch.no_grad()
    def step(self, leaves: list, grads: list) -> list:
        """Update ``leaves`` in place from ``grads``; returns the clipped
        gradients."""
        o = self.opt
        self.t += 1
        lr = learning_rate(o, self.t)
        c1, c2 = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        gs = self.clipped(grads)
        for p, g, m, v, dt in zip(leaves, gs, self.m, self.v, self.storage):
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
            new = p - lr * (upd + o["weight_decay"] * p)
            p.copy_(new.to(dt).float())
        return gs
