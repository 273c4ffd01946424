"""Gradient compression for a slow cross-pod axis, in PyTorch: the port
of the reference's ``optim/compress.py``.

int8 absmax quantization with *error feedback*: the quantization residual
is carried to the next step, so compression error accumulates to zero
instead of biasing the update.  The functions on one tensor are ported
bit for bit (``torch.round`` rounds half to even, as ``jnp.round``);
:func:`compressed_psum_pod`, the cross-pod sum itself, needs a device
mesh and waits for distributed training (``ROADMAP.md`` §A item 6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .adamw import tree_map


class ErrorFeedbackState(NamedTuple):
    err: dict     # tree congruent with grads, f32 residuals


def init_error_feedback(grads_template: dict) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_template))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a tensor divisor: on CUDA a Python one is multiplied by its reciprocal
    scale = torch.clamp(x.abs().max(), min=1e-12) / x.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(
    g: torch.Tensor, err: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q, scale, new_err)."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_psum_pod(grads: dict, err_state: ErrorFeedbackState,
                        mesh=None):
    """The int8 all-reduce over the ``pod`` axis of a device mesh."""
    raise NotImplementedError(
        "compressed_psum_pod needs a device mesh with a 'pod' axis: it "
        "comes with distributed training (ROADMAP.md §A item 6)")
