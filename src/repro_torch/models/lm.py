"""Decoder-only LM of the dense family, in PyTorch: the serving half.

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

The MoE, SSM and hybrid families, and the training loss, come with later
slices of the port (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_tensor
from . import layers as L


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn"
    ffn: Optional[str]    # "mlp"


def superblock_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [LayerSpec("attn", "mlp")]
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP §A item 2: "
            "the MoE, SSM and hybrid families)")
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


def _init_blocks(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    ones = torch.ones((n, d), dtype=dt, device=gen.device)
    return {"ln1": ones, "attn": L.init_attention(gen, cfg, stack=n),
            "ln2": ones.clone(), "mlp": L.init_mlp(gen, cfg, stack=n)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the
    reference's layout and scales (another generator, so other values)."""
    pat = superblock_pattern(cfg)
    nsb = num_superblocks(cfg)
    d, v, dt = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
    params = {
        "blocks": {f"b{i}": _init_blocks(gen, cfg, nsb)
                   for i in range(len(pat))},
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
    arrive as f32 and are cast to ``cfg.param_dtype``, which rounds to
    nearest even.  ``device=None`` means the CUDA card (and raises
    without one)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        t = to_tensor(np.array(node), dev)   # a copy: the source may be read-only
        return t.to(cfg.param_dtype) if t.is_floating_point() else t

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


def _apply_block(p, cfg, h, positions, mrope_positions, collect_cache):
    a, (k, v) = L.attention_layer(
        p["attn"], cfg, L.rmsnorm(h, p["ln1"], cfg.norm_eps), positions,
        causal=True, mrope_positions=mrope_positions,
    )
    cache = {"k": k, "v": v} if collect_cache else None
    h = h + a
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp_layer(p["mlp"], cfg, x), cache


def _apply_block_decode(p, cfg, h, pos: int, cache: dict):
    a, k_new, v_new = L.attention_decode(
        p["attn"], cfg, L.rmsnorm(h, p["ln1"], cfg.norm_eps), pos,
        cache["k"], cache["v"],
    )
    h = h + a
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp_layer(p["mlp"], cfg, x), {"k": k_new, "v": v_new}


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
        for i in range(len(pat)):
            h, c = _apply_block(block_p[f"b{i}"], cfg, h, positions,
                                mrope_positions, collect_cache)
            caches[f"b{i}"] = c
        per_layer.append(caches)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return h, None
    stacked = {name: {kv: torch.stack([c[name][kv] for c in per_layer])
                      for kv in ("k", "v")}
               for name in per_layer[0]}
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
    Caches are stacked ``{"b0": {"k", "v": (layers, B, Hkv, S, hd)}}``."""
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
        for i in range(len(pat)):
            h, _ = _apply_block_decode(block_p[f"b{i}"], cfg, h, pos,
                                       _layer(cache[f"b{i}"], li))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, 0] @ _head_matrix(params)).float()
    return logits[..., : cfg.vocab_size], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches shaped as ``lm_decode`` wants them: (layers, B, Hkv,
    max_len, hd) per attention block, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    pat = superblock_pattern(cfg)
    nsb = num_superblocks(cfg)
    shape = (nsb, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return {f"b{i}": {kv: torch.zeros(shape, dtype=cfg.param_dtype,
                                      device=dev) for kv in ("k", "v")}
            for i, _ in enumerate(pat)}
