"""Decoder-only LM of the dense and SSM families, in PyTorch: the
serving half.

Parameters keep the reference's *stacked* layout — ``{"blocks": {"b0":
{...}}, "final_norm", "embed", "lm_head"?}`` with a leading layer axis
on every block leaf — so one NumPy tree carries across with
:func:`lm_params_from_numpy`.  Where the reference scans over that axis
(``lax.scan``) the port runs a Python loop over it.

Entry points:
  ``lm_prefill``   — full-sequence forward, returns last-token logits +
                     the KV caches for decode
  ``lm_decode``    — one-token step against the bounded caches (updated
                     in place)
  ``init_cache``   — zeroed caches shaped as the decode step wants them

A layer's mixer is attention (dense, vlm, audio) or a Mamba-2 block
(ssm); its cache is ``{"k", "v"}`` or ``{"conv", "ssm"}``.  The MoE and
hybrid families, and the training loss, come with later slices of the
port (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_tensor
from . import layers as L
from . import mamba2 as M


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "mamba"
    ffn: Optional[str]    # "mlp" | None


def superblock_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [LayerSpec("attn", "mlp")]
    if cfg.family == "ssm":
        return [LayerSpec("mamba", None)]
    if cfg.family == "moe":
        raise NotImplementedError(
            "the moe family is not ported yet (ROADMAP §A item 1)")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "the hybrid family is not ported yet (ROADMAP §A item 2)")
    raise ValueError(cfg.family)


def num_superblocks(cfg: ModelConfig) -> int:
    pat = superblock_pattern(cfg)
    if cfg.num_layers % len(pat):
        raise ValueError(
            f"{cfg.num_layers} layers do not repeat a {len(pat)}-layer "
            "pattern")
    return cfg.num_layers // len(pat)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_blocks(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                 n: int) -> dict:
    """``n`` stacked layers of one pattern position."""
    d, dt = cfg.d_model, cfg.param_dtype
    p = {"ln1": torch.ones((n, d), dtype=dt, device=gen.device)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg, stack=n)
    else:
        p["mamba"] = M.init_mamba(gen, cfg, stack=n)
    if spec.ffn is not None:
        p["ln2"] = torch.ones((n, d), dtype=dt, device=gen.device)
        p["mlp"] = L.init_mlp(gen, cfg, stack=n)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the
    reference's layout and scales (another generator, so other values)."""
    pat = superblock_pattern(cfg)
    nsb = num_superblocks(cfg)
    d, v, dt = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
    params = {
        "blocks": {f"b{i}": _init_blocks(gen, cfg, spec, nsb)
                   for i, spec in enumerate(pat)},
        "final_norm": torch.ones((d,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, v), dt)
    if not cfg.embeds_input:
        params["embed"] = L.dense_init(gen, (v, d), dt, scale=0.02)
    return params


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device=None) -> dict:
    """Carry a nested dict of NumPy arrays (the reference's parameters, in
    its layout) onto ``device``.  NumPy has no bfloat16: floating arrays
    arrive as f32.  The rule: a floating leaf is cast to
    ``cfg.param_dtype`` (rounding to nearest even) unless its name is one
    the reference stores in f32 whatever the config says
    (``mamba2.F32_LEAVES``: ``a_log``, ``dt_bias``, ``skip_d``), which
    stays f32.  ``device=None`` means the CUDA card (and raises without
    one)."""
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, Mapping):
            return {k: conv(v, k) for k, v in node.items()}
        t = to_tensor(np.array(node), dev)   # a copy: the source may be read-only
        if not t.is_floating_point():
            return t
        return t.float() if name in M.F32_LEAVES else t.to(cfg.param_dtype)

    return conv(tree)


def _head_matrix(params: dict) -> torch.Tensor:
    """(D, V) output projection — the transposed embedding when tied."""
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _ffn(p, cfg, spec: LayerSpec, h):
    if spec.ffn is None:
        return h
    return h + L.mlp_layer(p["mlp"], cfg, L.rmsnorm(h, p["ln2"], cfg.norm_eps))


def _apply_block(p, cfg, spec: LayerSpec, h, positions, mrope_positions,
                 collect_cache):
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        a, (k, v) = L.attention_layer(
            p["attn"], cfg, x, positions, causal=True,
            mrope_positions=mrope_positions,
        )
        cache = {"k": k, "v": v} if collect_cache else None
    elif collect_cache:
        # the conv line buffer (taken before the conv) and the final state
        a, cache = M.mamba_layer(p["mamba"], cfg, x, return_state=True)
    else:
        a, cache = M.mamba_layer(p["mamba"], cfg, x), None
    return _ffn(p, cfg, spec, h + a), cache


def _apply_block_decode(p, cfg, spec: LayerSpec, h, pos: int, cache: dict):
    """One layer of a decode step; ``cache`` (views of the stacked cache)
    is updated in place."""
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        a, _, _ = L.attention_decode(p["attn"], cfg, x, pos, cache["k"],
                                     cache["v"])
    else:
        a, conv, ssm = M.mamba_decode(p["mamba"], cfg, x, cache["conv"],
                                      cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
    return _ffn(p, cfg, spec, h + a)


# ---------------------------------------------------------------------------
# backbone (a loop over superblocks)
# ---------------------------------------------------------------------------


def backbone(params: dict, cfg: ModelConfig, h: torch.Tensor,
             positions: torch.Tensor, mrope_positions=None,
             collect_cache: bool = False):
    pat = superblock_pattern(cfg)
    per_layer = []
    for li in range(num_superblocks(cfg)):
        block_p = _layer(params["blocks"], li)
        caches = {}
        for i, spec in enumerate(pat):
            h, c = _apply_block(block_p[f"b{i}"], cfg, spec, h, positions,
                                mrope_positions, collect_cache)
            caches[f"b{i}"] = c
        per_layer.append(caches)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return h, None
    stacked = {name: {leaf: torch.stack([c[name][leaf] for c in per_layer])
                      for leaf in first}
               for name, first in per_layer[0].items()}
    return h, stacked


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _embed_in(params: dict, cfg: ModelConfig, tokens_or_embeds):
    if cfg.embeds_input:
        return tokens_or_embeds.to(cfg.param_dtype)
    return params["embed"][tokens_or_embeds.long()]


def lm_prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Returns (last-token logits (B, V) f32, caches) — serving prefill.
    Caches are stacked per pattern position: ``{"b0": {"k", "v": (layers,
    B, Hkv, S, hd)}}`` for attention, ``{"b0": {"conv": (layers, B, K-1,
    conv_dim), "ssm": (layers, B, H, P, N) f32}}`` for a Mamba block."""
    x = batch["embeds"] if cfg.embeds_input else batch["tokens"]
    h = _embed_in(params, cfg, x)
    bsz, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(bsz, s)
    h, caches = backbone(
        params, cfg, h, positions,
        mrope_positions=batch.get("mrope_positions"), collect_cache=True,
    )
    logits = (h[:, -1] @ _head_matrix(params)).float()
    return logits[..., : cfg.vocab_size], caches


def lm_decode(params: dict, cfg: ModelConfig, cache: dict,
              token: torch.Tensor, pos: int):
    """One decode step at absolute position ``pos`` for ``token`` (B,)
    (or (B, 1, D) embeds).  Returns (logits (B, V) f32, cache): the cache
    is the one passed in, **updated in place**."""
    pat = superblock_pattern(cfg)
    if cfg.embeds_input:
        h = token.to(cfg.param_dtype)
        if h.ndim == 2:
            h = h[:, None, :]
    else:
        h = params["embed"][token.long()][:, None, :]          # (B, 1, D)
    for li in range(num_superblocks(cfg)):
        block_p = _layer(params["blocks"], li)
        for i, spec in enumerate(pat):
            h = _apply_block_decode(block_p[f"b{i}"], cfg, spec, h, pos,
                                    _layer(cache[f"b{i}"], li))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, 0] @ _head_matrix(params)).float()
    return logits[..., : cfg.vocab_size], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches shaped as ``lm_decode`` wants them, on ``device``
    (None: the card): per attention block k and v (layers, B, Hkv,
    max_len, hd) in ``param_dtype``; per Mamba block the conv line buffer
    (layers, B, K-1, conv_dim) in ``param_dtype`` and the SSD state
    (layers, B, H, P, N) in f32 — the reference's layout and types."""
    dev = resolve_device(device)
    pat = superblock_pattern(cfg)
    nsb = num_superblocks(cfg)
    dt = cfg.param_dtype
    out = {}
    for i, spec in enumerate(pat):
        if spec.mixer == "attn":
            shape = (nsb, batch, cfg.num_kv_heads, max_len,
                     cfg.resolved_head_dim)
            out[f"b{i}"] = {kv: torch.zeros(shape, dtype=dt, device=dev)
                            for kv in ("k", "v")}
        else:
            s, d = cfg.ssm, cfg.d_model
            out[f"b{i}"] = {
                "conv": torch.zeros((nsb, batch, s.conv_kernel - 1,
                                     s.conv_dim(d)), dtype=dt, device=dev),
                "ssm": torch.zeros((nsb, batch, s.num_heads(d), s.head_dim,
                                    s.state_dim), dtype=torch.float32,
                                   device=dev),
            }
    return out
