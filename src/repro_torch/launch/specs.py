"""Input specs as ``meta`` tensors for every (architecture × shape) cell,
in PyTorch: the port of the reference's ``launch/specs.py``.

Each spec has the shape and dtype of the reference's
``ShapeDtypeStruct`` and takes no memory: the sharding rules and a
checkpoint's restore template take them.  The same specs shape the real
batches of ``repro_torch.data.pipeline``.

Shape semantics:
  train_4k     — train_step on (global_batch, seq_len)
  prefill_32k  — prefill_step on (global_batch, seq_len)
  decode_32k   — decode_step: ONE new token against a seq_len KV cache
  long_500k    — decode_step at 524,288 (sub-quadratic archs only)

Encoder–decoder mapping: train = enc seq_len frames + seq_len/4 decoder
targets; prefill = encode seq_len frames + first token; decode = one
decoder token against a seq_len cross memory + seq_len self cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from . import steps

#: decoder targets per encoder frame (seamless: text tokens much shorter
#: than audio frames)
ENCDEC_DEC_FRAC = 4


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``model_init`` draws on
    its generator's device, so with this one it makes meta tensors."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(shape) -> torch.Tensor:
    return _spec(shape, torch.int32)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch tree for ``train_step`` (tokens or stub embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        s_dec = max(s // ENCDEC_DEC_FRAC, 16)
        return {
            "frames": _spec((b, s, cfg.d_model), cfg.param_dtype),
            "tokens": _i32((b, s_dec)),
            "labels": _i32((b, s_dec)),
        }
    out: dict = {"labels": _i32((b, s))}
    if cfg.embeds_input:
        out["embeds"] = _spec((b, s, cfg.d_model), cfg.param_dtype)
        if cfg.mrope_sections:
            out["mrope_positions"] = _i32((3, b, s))
    else:
        out["tokens"] = _i32((b, s))
    return out


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _spec((b, s, cfg.d_model), cfg.param_dtype)}
    out: dict = {}
    if cfg.embeds_input:
        out["embeds"] = _spec((b, s, cfg.d_model), cfg.param_dtype)
        if cfg.mrope_sections:
            out["mrope_positions"] = _i32((3, b, s))
    else:
        out["tokens"] = _i32((b, s))
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{"cache", "token", "pos"} — one-token step against a seq_len cache."""
    b, s = shape.global_batch, shape.seq_len
    cache = steps.model_init_cache(cfg, b, s, device="meta")
    if cfg.embeds_input and cfg.family != "encdec":
        token = _spec((b, 1, cfg.d_model), cfg.param_dtype)
    else:
        token = _i32((b,))
    return {"cache": cache, "token": token, "pos": _i32(())}


def params_specs(cfg: ModelConfig) -> dict:
    """The params tree as meta tensors (the init on the meta device: no
    memory, no random draw)."""
    return steps.model_init(MetaGenerator(), cfg)
