"""Weight-only int8 post-training quantization, in PyTorch: the port of
the reference's ``quant/ptq.py``.

Every ≥2-D floating weight is stored as int8 with a per-output-channel
f32 scale (absmax over the contraction axis, −2), halving the weight
bytes a decode step must stream.  Activations stay in the parameter
dtype.  The arithmetic is the reference's, bit for bit: the absmax and
the division by the scale in f32, ``torch.round`` rounding half to even
as ``jnp.round`` does.

The rule is the reference's, quirks included: a parameter tree stores its
layers stacked, so the per-layer norms and biases (``ln1``, ``ln2``,
``bq``, …: (layers, D)) are 2-D and quantized, one scale per column
across the layer axis; the embedding (V, D) takes one scale per model
dimension, over the vocabulary; and the leaves the model keeps in f32
(``router``, ``a_log``, ``dt_bias``, ``skip_d``) come back from
:func:`dequantize_params` in the dtype asked for.

The reference dequantizes inside ``jit``, where XLA fuses the convert
into the consumer.  The port runs eagerly: :func:`dequantize_params`
writes a transient copy of the weights in the dtype asked for.  On a
mesh the serve steps dequantize one superblock at a time: its ``q`` and
``scale`` gathered along the data axes in one buffer, then dequantized
before any layer reads them (``tp.gather_data``).

Usage::

    qparams = quantize_params(params)                  # tree of QTensor
    params_hat = dequantize_params(qparams, cfg.param_dtype)
    logits, cache = lm.lm_decode(params_hat, cfg, ...)

``ServeEngine(..., int8_weights=True)`` wires this in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten_with_path, tree_map


class QTensor(NamedTuple):
    """int8 weight + per-output-channel scale (last axis = out channels)."""

    q: torch.Tensor          # int8, same shape as the original
    scale: torch.Tensor      # f32, shape = (..., 1, out) broadcastable

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return torch.int8


def _quantize_matrix(x):
    """(int8 q, f32 scale) of ``x``, the scale over its axis −2."""
    xf = x.to(torch.float32)
    # per-output-channel absmax over the contraction axis (-2)
    amax = xf.abs().amax(dim=-2, keepdim=True)
    # divide by a tensor: a CUDA tensor divided by a Python number is
    # multiplied by the number's reciprocal instead, which rounds
    # otherwise than the reference's (and the CPU's) division
    scale = torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_leaf(x):
    # quantize matrices only; keep vectors/scalars (norms, biases) exact
    if not isinstance(x, torch.Tensor) or x.ndim < 2 or \
            not x.is_floating_point():
        return x
    if x.ndim == 2:
        return QTensor(*_quantize_matrix(x))
    # a stacked leaf one layer at a time: the scale is taken over axis −2
    # alone, so the bits are the whole leaf's, and the f32 temporaries
    # are a layer's (nemotron-4-15b's (32, 6144, 24576) ``wu`` would take
    # 19 GB for each)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-2], 1, x.shape[-1]),
                        dtype=torch.float32, device=x.device)
    for i, layer in enumerate(x):
        q[i], scale[i] = _quantize_matrix(layer)
    return QTensor(q, scale)


def _dequantize_leaf(x, dtype):
    if isinstance(x, QTensor):
        # int8 × f32 promotes to f32 inside the one kernel: the bits of
        # ``q.to(float32) * scale`` without writing the f32 copy of q
        return (x.q * x.scale).to(dtype)
    return x


def quantize_params(params: Any) -> Any:
    """Every ≥2-D floating leaf becomes a :class:`QTensor`, on the leaf's
    device."""
    return tree_map(_quantize_leaf, params)


def dequantize_params(qparams: Any, dtype=torch.bfloat16) -> Any:
    """Inverse map: each :class:`QTensor` becomes ``q · scale`` (in f32)
    cast to ``dtype``; every other leaf is returned as it is."""
    return tree_map(lambda x: _dequantize_leaf(x, dtype), qparams)


def quantized_param_shardings(p_shard: Any, params_shape: Any) -> Any:
    """Shardings for the quantized tree (``distributed.sharding``): at a
    ≥2-D floating leaf a :class:`QTensor` of two — ``q`` takes the weight's
    sharding, the (…, 1, out) ``scale`` the same spec with the
    contraction axis (−2) replicated and the weight's column order
    (``NamedSharding.parts``), so that each column keeps its scale; every
    other leaf keeps its own."""

    def one(sh, leaf):
        if leaf.ndim < 2 or not leaf.dtype.is_floating_point:
            return sh
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        spec[-2] = None
        return QTensor(sh, dataclasses.replace(sh, spec=tuple(spec)))

    return tree_map(one, p_shard, params_shape)


def quantization_error(params: Any, qparams: Any) -> dict:
    """Max relative weight error per ≥2-D leaf (diagnostics), keyed by the
    reference's ``keystr`` paths."""
    out = {}
    deq = dict(tree_flatten_with_path(
        dequantize_params(qparams, torch.float32)))
    for path, p in tree_flatten_with_path(params):
        if p.ndim >= 2:
            pf = p.to(torch.float32)
            denom = torch.clamp(pf.abs().max(), min=1e-12)
            out[path] = float((pf - deq[path]).abs().max() / denom)
    return out
