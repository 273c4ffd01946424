"""Config system: model architecture + workload shape + runtime knobs.

The port's own copy of the reference's ``configs/base.py``: the same
dataclasses and numbers, with ``param_dtype`` a ``torch.dtype`` and the
``"cuda"`` attention (the default) in place of ``"pallas"``.

Every assigned architecture gets a ``configs/<id>.py`` exposing
``CONFIG`` (a :class:`ModelConfig` with the exact published numbers) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).

Workload shapes (assignment):
  train_4k      seq 4,096  global_batch 256   (train_step)
  prefill_32k   seq 32,768 global_batch 32    (serve: prefill)
  decode_32k    seq 32,768 global_batch 128   (serve: one decode step)
  long_500k     seq 524,288 global_batch 1    (decode; sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Literal, Optional

import torch


#: ``ModelConfig.dtype`` names → the torch dtype of the parameters
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclass(frozen=True)
class MoeConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # every n-th layer is MoE (1 = all layers, 2 = alternate — Jamba)
    moe_period: int = 1


@dataclass(frozen=True)
class SsmConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    conv_kernel: int = 4          # depthwise causal conv width
    chunk: int = 64               # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        # conv runs over (x, B, C) channels
        return self.d_inner(d_model) + 2 * self.state_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 → d_model // num_heads
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- modality / structure extras ---
    moe: Optional[MoeConfig] = None
    ssm: Optional[SsmConfig] = None
    attn_period: int = 0                   # hybrid: 1 attn per N layers (Jamba: 8)
    enc_layers: int = 0                    # encdec: encoder depth
    dec_layers: int = 0                    # encdec: decoder depth
    mrope_sections: tuple[int, ...] = ()   # M-RoPE (t,h,w) half-dim split
    embeds_input: bool = False             # frontend stub: inputs are embeddings
    # --- applicability (DESIGN.md §4) ---
    sub_quadratic: bool = False            # can run long_500k
    # --- runtime knobs ---
    remat: bool = True
    # "cuda" (the hand-written flash-attention kernel; its plain version
    # on a CPU tensor) is the counterpart of the reference's "pallas"
    attn_impl: Literal["blockwise", "reference", "cuda"] = "cuda"
    mlp_impl: Literal["dense", "streamed"] = "dense"
    loss_chunk: int = 512                  # CE computed in seq chunks
    attn_block_q: int = 512
    attn_block_k: int = 512
    # streaming backward (MING C1 at train time): recompute attention
    # score blocks / CE logit chunks in the VJP instead of stashing the
    # O(S²) / O(S·V) intermediates.  False = default scan VJP, kept for
    # the §Perf before/after measurement.
    attn_streaming_bwd: bool = True
    loss_streaming_bwd: bool = True
    # pad embed/lm_head vocab rows to a multiple (0 = off).  Unpadded
    # vocabs (50280, 49155, 256206…) cannot vocab-shard over a model=16
    # axis — padding to 256·k restores the sharding (§Perf optimization;
    # padded logit columns are masked to -inf in the loss/serve paths).
    pad_vocab_to: int = 0
    # preferred tensor-parallel width (0 = the mesh default).  Small
    # models with odd head counts (qwen2-0.5b: 14H) waste a 16-wide model
    # axis — the launcher reshapes the SAME chip count to (data·16/tp, tp)
    # (§Perf optimization A2).
    tp_preference: int = 0

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab_size
        m = self.pad_vocab_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:        # attention-free (pure SSM)
            return 0
        return self.d_model // self.num_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules (recorded, not silently dropped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "full-attention arch: 524k dense KV with O(L^2) history is the "
            "edge-infeasible case the paper targets — skipped per DESIGN.md §4"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Parameter counting (for MODEL_FLOPS = 6·N·D roofline term)
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.gated_mlp else 2
    return mult * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig, active: bool) -> int:
    assert cfg.moe is not None
    e = cfg.moe.top_k if active else cfg.moe.num_experts
    mult = 3 if cfg.gated_mlp else 2
    return cfg.d_model * cfg.moe.num_experts + e * mult * cfg.d_model * cfg.d_ff


def _mamba_params(cfg: ModelConfig) -> int:
    assert cfg.ssm is not None
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.num_heads(d)
    in_p = d * (2 * di + 2 * s.state_dim + h)
    conv = s.conv_kernel * s.conv_dim(d)
    out_p = di * d
    return in_p + conv + out_p + 3 * h + di


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active) parameter count, embeddings included."""
    d = cfg.d_model
    # stub-frontend archs have no token embedding — except enc-dec, whose
    # *decoder* still embeds target tokens (only encoder frames are stubbed)
    no_embed = cfg.embeds_input and cfg.family != "encdec"
    v = cfg.padded_vocab
    embed = 0 if no_embed else v * d
    head = 0 if cfg.tie_embeddings else v * d
    norms = 0

    def dense_block() -> int:
        return _attn_params(cfg) + _mlp_params(cfg) + 2 * d

    def moe_block() -> int:
        return _attn_params(cfg) + _moe_params(cfg, active_only) + 2 * d

    def mamba_block() -> int:
        return _mamba_params(cfg) + d

    if cfg.family in ("dense", "vlm", "audio"):
        body = cfg.num_layers * dense_block()
    elif cfg.family == "moe":
        body = cfg.num_layers * moe_block()
    elif cfg.family == "ssm":
        body = cfg.num_layers * mamba_block()
    elif cfg.family == "hybrid":
        assert cfg.attn_period > 0 and cfg.moe is not None
        n_attn = cfg.num_layers // cfg.attn_period
        n_mamba = cfg.num_layers - n_attn
        n_moe = cfg.num_layers // cfg.moe.moe_period
        n_dense_mlp = cfg.num_layers - n_moe
        ffn = n_moe * _moe_params(cfg, active_only) + n_dense_mlp * _mlp_params(cfg)
        attn = n_attn * _attn_params(cfg)
        mamba = n_mamba * _mamba_params(cfg)
        body = ffn + attn + mamba + 2 * cfg.num_layers * d
    elif cfg.family == "encdec":
        enc = cfg.enc_layers * dense_block()
        # decoder: self-attn + cross-attn + mlp
        dec = cfg.dec_layers * (2 * _attn_params(cfg) + _mlp_params(cfg) + 3 * d)
        body = enc + dec + d  # two final norms (enc + dec); second added below
    else:  # pragma: no cover
        raise ValueError(cfg.family)
    return embed + head + body + norms + d  # final norm


def model_flops_per_token(cfg: ModelConfig, training: bool) -> float:
    """MODEL_FLOPS/token = 6·N (train) or 2·N (inference), N = active params."""
    n = count_params(cfg, active_only=cfg.moe is not None)
    return (6.0 if training else 2.0) * n
