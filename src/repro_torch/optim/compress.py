"""Gradient compression for a slow cross-pod axis, in PyTorch: the port
of the reference's ``optim/compress.py``.

int8 absmax quantization with *error feedback*: the quantization residual
is carried to the next step, so compression error accumulates to zero
instead of biasing the update.  The functions on one tensor are ported
bit for bit (``torch.round`` rounds half to even, as ``jnp.round``).
:func:`compressed_psum_pod`, the cross-pod mean, runs over the ``pod``
axis of a device mesh (``launch.mesh``): each pod has reduced its own
portion in full precision; across pods only int8 moves, with one f32
scale a leaf.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .adamw import _pick, tree_map


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
                        mesh) -> tuple[dict, ErrorFeedbackState]:
    """The mean of ``grads`` over the ``pod`` axis of ``mesh`` with an int8
    payload → (mean, new error state); every rank of the mesh calls it.

    Each leaf (a DTensor is taken whole, as the reference's replicated
    ``shard_map`` input) is compressed with its error feedback; the int8
    values are summed as int32 and the scales in f32 over the pod group
    (``mesh.get_group("pod")``), and the mean is the reference's
    ``summed · (scale_sum / npod) / npod`` — the mean scale stands for
    every pod's, which absmax scales of i.i.d. shards nearly are — in the
    leaf's dtype."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if "pod" not in mesh.axis_names:
        raise ValueError(f"compressed_psum_pod needs a pod axis; {mesh!r} "
                         "has none")
    group = mesh.get_group("pod")
    npod = torch.tensor(float(mesh.shape["pod"]))

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def one(g, err):
        g, err = whole(g), whole(err)
        q, scale, new_err = compress_with_feedback(g, err)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        n = npod.to(g.device)
        out = summed.to(torch.float32) * (scale_sum / n) / n
        return out.to(g.dtype), new_err

    pairs = tree_map(one, grads, err_state.err)
    return _pick(pairs, 0), ErrorFeedbackState(_pick(pairs, 1))

