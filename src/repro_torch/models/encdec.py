"""Encoder–decoder backbone (seamless-m4t style; frontend stubbed), in
PyTorch: ``src/repro/models/encdec.py``, serving and training.

The speech/text frontend is a stub: callers hand in precomputed frame
embeddings (B, T, D).  The backbone is real: a bidirectional encoder
stack — each layer's attention one non-causal launch of the hand-written
flash-attention kernel (``L.attention_layer(causal=False)``) — and a
causal decoder stack with cross-attention over the encoder memory.  The
memory's keys and values are computed once at prefill, per decoder
layer, and read by every decode step.

Parameters keep the reference's stacked layout, ``{"encoder": {"blocks",
"final_norm"}, "decoder": {"blocks", "final_norm"}, "embed",
"lm_head"}`` with the unpadded ``vocab_size``, so one NumPy tree carries
across with :func:`repro_torch.models.lm.lm_params_from_numpy`.  Where
the reference scans over the layer axis the port runs a Python loop.

Entry points:
  ``encdec_loss``     — training: ``encode``, the teacher-forced
                        ``decode_train`` (causal self-attention, then
                        non-causal cross-attention over the memory through
                        ``attention_layer(kv_override=...)``, then the
                        MLP, per decoder layer) and the streaming chunked
                        cross-entropy over ``lm_head``; under autograd
                        with ``cfg.remat`` every encoder and decoder layer
                        is recomputed in the backward, as the reference's
                        ``jax.checkpoint`` per layer
  ``encdec_prefill``  — encode, the cross K/V per decoder layer, and the
                        first decode step (BOS = 0 at position 0) from a
                        1-long self cache; returns (logits, cache)
  ``encdec_decode``   — one decoder step; the self cache is updated in
                        place
  ``init_cache``      — zeroed caches ``{"ck", "cv", "k", "v"}``
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.ctx import shard_activation
from . import layers as L
from .lm import (_EmbedRows, _layer, _unbind_layers, chunked_ce_loss,
                 embed_tokens, head_logits)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the
    reference's layout and scales (another generator, so other values)."""
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    ne, nd = cfg.enc_layers, cfg.dec_layers

    def ones(n):
        return torch.ones((n, d), dtype=dt, device=gen.device)

    enc = {"ln1": ones(ne), "attn": L.init_attention(gen, cfg, stack=ne),
           "ln2": ones(ne), "mlp": L.init_mlp(gen, cfg, stack=ne)}
    dec = {"ln1": ones(nd),
           "self_attn": L.init_attention(gen, cfg, stack=nd),
           "ln_x": ones(nd),
           "cross_attn": L.init_attention(gen, cfg, cross=True, stack=nd),
           "ln2": ones(nd), "mlp": L.init_mlp(gen, cfg, stack=nd)}
    final = torch.ones((d,), dtype=dt, device=gen.device)
    return {
        "encoder": {"blocks": enc, "final_norm": final},
        "decoder": {"blocks": dec, "final_norm": final.clone()},
        "embed": L.dense_init(gen, (v, d), dt, scale=0.02),
        "lm_head": L.dense_init(gen, (d, v), dt),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _run_layers(blocks: dict, path: tuple, n: int, cfg: ModelConfig,
                body, h: torch.Tensor) -> torch.Tensor:
    """``h = body(p, h)`` for each of the ``n`` stacked layers of
    ``blocks`` (the params' subtree at ``path``) in turn.  Under autograd
    each layer's parameters come from one ``torch.unbind`` of the stacked
    leaves (``lm._unbind_layers``), and with ``cfg.remat`` each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped and recomputed in the backward, as the
    reference's ``jax.checkpoint(body)`` does per layer.  Where a mesh
    train step holds the leaves in blocks along the data axes, a layer's
    leaves are gathered inside that function (``tp.gather_data``): the
    recompute gathers them again, and a rank holds one layer's at a
    time."""
    def run(p, hh):
        return body(tp.gather_data(p, path, layer=True), hh)

    if not torch.is_grad_enabled():
        for li in range(n):
            h = run(_layer(blocks, li), h)
        return h
    for p in _unbind_layers(blocks, n):
        if cfg.remat:
            h = torch.utils.checkpoint.checkpoint(run, p, h,
                                                  use_reentrant=False)
        else:
            h = run(p, h)
    return h


def _positions(h: torch.Tensor) -> torch.Tensor:
    bsz, s = h.shape[0], h.shape[1]
    return torch.arange(s, dtype=torch.int32, device=h.device).expand(bsz, s)


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings → encoder memory (B, T, D)."""
    h = shard_activation(frames.to(cfg.param_dtype), "hidden")
    positions = _positions(h)

    def body(p, hh):
        a, _ = L.attention_layer(p["attn"], cfg,
                                 L.rmsnorm(hh, p["ln1"], cfg.norm_eps),
                                 positions, causal=False)
        hh = hh + a
        hh = hh + L.mlp_layer(p["mlp"], cfg,
                              L.rmsnorm(hh, p["ln2"], cfg.norm_eps))
        return shard_activation(hh, "hidden")

    h = _run_layers(params["encoder"]["blocks"], ("encoder", "blocks"),
                    cfg.enc_layers, cfg, body, h)
    return L.rmsnorm(h, tp.gather_data(params["encoder"]["final_norm"],
                                       ("encoder", "final_norm")),
                     cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _cross_kv(p: dict, cfg: ModelConfig, memory: torch.Tensor):
    """One decoder layer's cross-attention keys and values of the memory,
    (B, Hkv, T, hd) each — no RoPE; by ``layers.head_case``: this rank's
    kv heads under ``HEADS``, every kv head under ``QUERY`` (from the
    whole ``wk`` / ``wv``, entered: ``layers.attention_leaves``; the
    layer then reads those its query heads read) and ``WHOLE``."""
    hd = cfg.resolved_head_dim
    p, _, _ = L.attention_leaves(p, cfg)
    k = memory @ p["wk"]
    v = memory @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    b, t = memory.shape[:2]
    k = k.reshape(b, t, -1, hd).transpose(1, 2)
    v = v.reshape(b, t, -1, hd).transpose(1, 2)
    return k, v


def decode_train(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward: (B, S) tokens over the encoder
    ``memory`` (B, T, D) → hidden (B, S, D) after the final norm.  Per
    layer: causal self-attention with RoPE, non-causal cross-attention
    over the memory's keys and values (``_cross_kv``, no RoPE) through
    ``attention_layer(kv_override=...)``, then the MLP.  The embedding's
    gradient sums repeated tokens in f32 (``lm._EmbedRows``), through the
    vocabulary-parallel rows where the table is split
    (``lm.embed_tokens``)."""
    embed = tp.gather_data(params["embed"], ("embed",))
    h = shard_activation(embed_tokens(embed, cfg, tokens.long(),
                                      _EmbedRows.apply), "hidden")
    positions = _positions(h)
    # where the query heads split (``HEADS`` or ``QUERY``) a rank's
    # cross-attention reads only its heads' share of each layer's cross
    # keys and values: the memory's gradient from them, a partial, is
    # summed over ``model`` once for all the layers
    memory = tp.enter(memory, L.head_case(cfg)[1])

    def body(p, hh):
        a, _ = L.attention_layer(p["self_attn"], cfg,
                                 L.rmsnorm(hh, p["ln1"], cfg.norm_eps),
                                 positions, causal=True)
        hh = hh + a
        ck, cv = _cross_kv(p["cross_attn"], cfg, memory)
        c, _ = L.attention_layer(p["cross_attn"], cfg,
                                 L.rmsnorm(hh, p["ln_x"], cfg.norm_eps),
                                 positions, causal=False,
                                 kv_override=(ck, cv))
        hh = hh + c
        hh = hh + L.mlp_layer(p["mlp"], cfg,
                              L.rmsnorm(hh, p["ln2"], cfg.norm_eps))
        return shard_activation(hh, "hidden")

    h = _run_layers(params["decoder"]["blocks"], ("decoder", "blocks"),
                    cfg.dec_layers, cfg, body, h)
    return L.rmsnorm(h, tp.gather_data(params["decoder"]["final_norm"],
                                       ("decoder", "final_norm")),
                     cfg.norm_eps)


def encdec_loss(params: dict, cfg: ModelConfig,
                batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch`` ``{"frames" (B, T, D), "tokens",
    "labels" (B, S)}`` (f32 scalar): encode, decode teacher-forced, and
    the streaming chunked CE over ``lm_head`` in chunks of
    ``cfg.loss_chunk`` (vocabulary-parallel where a ``ModelSplit`` that
    the vocabulary divides is installed)."""
    memory = encode(params, cfg, batch["frames"])
    h = decode_train(params, cfg, memory, batch["tokens"])
    return chunked_ce_loss(h, tp.gather_data(params["lm_head"], ("lm_head",)),
                           batch["labels"], cfg.loss_chunk,
                           streaming_bwd=cfg.loss_streaming_bwd,
                           split=tp.split_along(tp.vocab_rows(cfg)))


def encdec_prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Encode ``batch["frames"]``, cache the cross K/V of every decoder
    layer, and take the first decode step (BOS token 0 at position 0)
    against a 1-long self cache → (logits (B, V) f32, cache).  Under a
    mesh serve step each decoder layer's ``cross_attn`` leaves are
    gathered along the data axes for its keys and values
    (``tp.gather_data``) and freed before the next layer's; the stacked
    ``ck`` / ``cv`` are copies, no view of them."""
    memory = encode(params, cfg, batch["frames"])
    blocks = params["decoder"]["blocks"]
    path = ("decoder", "blocks", "cross_attn")
    kvs = [_cross_kv(tp.gather_data(_layer(blocks, li)["cross_attn"], path,
                                    layer=True), cfg, memory)
           for li in range(cfg.dec_layers)]
    bsz = memory.shape[0]
    shape = (cfg.dec_layers, *kvs[0][0].shape[:2], 1, cfg.resolved_head_dim)
    cache = {
        "ck": torch.stack([k for k, _ in kvs]),
        "cv": torch.stack([v for _, v in kvs]),
        # two tensors: decode writes each in place
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=memory.device),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=memory.device),
    }
    bos = torch.zeros((bsz,), dtype=torch.int32, device=memory.device)
    return encdec_decode(params, cfg, cache, bos, 0)


def encdec_decode(params: dict, cfg: ModelConfig, cache: dict,
                  token: torch.Tensor, pos: int):
    """One decoder step for ``token`` (B,) at position ``pos`` against
    ``cache`` ``{"ck", "cv": (Ld, B, Hkv, T, hd), "k", "v": (Ld, B, Hkv,
    S, hd)}`` → (logits (B, V) f32, cache): the self cache is the one
    passed in, **updated in place**.  Under a mesh serve step the
    embedding, each decoder layer's leaves, the final norm and
    ``lm_head`` are gathered along the data axes where they are read
    (``tp.gather_data``)."""
    h = embed_tokens(tp.gather_data(params["embed"], ("embed",)), cfg,
                     token.long())[:, None, :]
    h = shard_activation(h, "hidden")                          # (B, 1, D)
    blocks = params["decoder"]["blocks"]
    for li in range(cfg.dec_layers):
        h = _decoder_layer_decode(_layer(blocks, li), cfg, h, pos,
                                  _layer(cache, li))
    h = L.rmsnorm(h, tp.gather_data(params["decoder"]["final_norm"],
                                    ("decoder", "final_norm")), cfg.norm_eps)
    return head_logits(h[:, 0], tp.gather_data(params["lm_head"],
                                               ("lm_head",)), cfg), cache


def _decoder_layer_decode(p: dict, cfg: ModelConfig, h: torch.Tensor,
                          pos: int, cache: dict) -> torch.Tensor:
    """One decoder layer of a decode step against its views of the cache,
    its leaves gathered along the data axes here (``tp.gather_data``), so
    that they are freed when it returns.  The cross-attention reads the
    memory's keys and values from the cache, so its kv projections are
    neither gathered nor read, as the reference's jitted decode drops the
    params it never reads."""
    p = dict(p, cross_attn={k: t for k, t in p["cross_attn"].items()
                            if k not in ("wk", "wv", "bk", "bv")})
    p = tp.gather_data(p, ("decoder", "blocks"), layer=True)
    a, _, _ = L.attention_decode(
        p["self_attn"], cfg, L.rmsnorm(h, p["ln1"], cfg.norm_eps), pos,
        cache["k"], cache["v"])
    h = h + a
    c, _, _ = L.attention_decode(
        p["cross_attn"], cfg, L.rmsnorm(h, p["ln_x"], cfg.norm_eps), pos,
        cache["ck"], cache["cv"], cross=True)
    h = h + c
    return h + L.mlp_layer(p["mlp"], cfg,
                           L.rmsnorm(h, p["ln2"], cfg.norm_eps))


def init_cache(cfg: ModelConfig, batch: int, mem_len: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches on ``device`` (None: the card): the cross K/V ``ck``,
    ``cv`` (Ld, B, Hkv, mem_len, hd) and the self K/V ``k``, ``v`` (Ld,
    B, Hkv, max_len, hd), all in ``param_dtype``."""
    dev = resolve_device(device)
    hd, dt = cfg.resolved_head_dim, cfg.param_dtype
    lead = (cfg.dec_layers, batch, cfg.num_kv_heads)
    return {
        "ck": torch.zeros(lead + (mem_len, hd), dtype=dt, device=dev),
        "cv": torch.zeros(lead + (mem_len, hd), dtype=dt, device=dev),
        "k": torch.zeros(lead + (max_len, hd), dtype=dt, device=dev),
        "v": torch.zeros(lead + (max_len, hd), dtype=dt, device=dev),
    }
