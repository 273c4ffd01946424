"""Decoder-only LM of the dense, MoE, SSM and hybrid families, in
PyTorch: serving and the training loss.

Parameters keep the reference's *stacked* layout — ``{"blocks": {"b0":
{...}}, "final_norm", "embed", "lm_head"?}`` with a leading layer axis
on every block leaf — so one NumPy tree carries across with
:func:`lm_params_from_numpy`.  Where the reference scans over that axis
(``lax.scan``) the port runs a Python loop over it.

Entry points:
  ``lm_loss``      — training forward + the streaming chunked
                     cross-entropy (its backward recomputes each chunk's
                     logits; with ``cfg.remat`` each superblock is
                     recomputed in the backward, as the reference's
                     ``jax.checkpoint``)
  ``lm_prefill``   — full-sequence forward, returns last-token logits +
                     the KV caches for decode
  ``lm_decode``    — one-token step against the bounded caches (updated
                     in place)
  ``init_cache``   — zeroed caches shaped as the decode step wants them

A layer's mixer is attention (dense, vlm, audio, moe) or a Mamba-2
block (ssm); the hybrid family (Jamba) mixes both in one superblock.
Its cache is ``{"k", "v"}`` or ``{"conv", "ssm"}``, so a hybrid cache
holds both kinds of leaf under one tree.  A layer's FFN is the MLP, the
MoE layer (``models/moe.py``) or none.  The train step of
``launch/steps.py`` takes ``lm_loss`` for every family but the
encoder–decoder: dense (dense, vlm, audio), MoE (the gates' gradient
through the f32 router), SSM (the SSD's through its backward kernel) and
the hybrid, which mixes them.  Its mesh step and the mesh serve steps
run the same code on the rank's shards: the layers split along the
installed ``ModelSplit`` (``distributed/tp.py``), the chunked CE over
this rank's vocabulary columns, and the leaves gathered along the data
axes where they are used (``tp.gather_data``: a superblock's when it
runs — in training inside its checkpointed function — and the
embedding, the final norm and the head each where it is read), so that a
rank holds one superblock's gathered leaves at a time, as the
reference's ``lax.scan`` over superblocks does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_tensor
from repro_torch.distributed import tp
from repro_torch.distributed.ctx import shard_activation
from . import layers as L
from . import mamba2 as M
from . import moe as MOE

#: parameters the reference keeps in f32 whatever ``param_dtype`` is: the
#: Mamba-2 leaves and the MoE router (``src/repro/models/moe.py:31``)
F32_LEAVES = M.F32_LEAVES + ("router",)


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "mamba"
    ffn: Optional[str]    # "mlp" | "moe" | None


def superblock_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [LayerSpec("attn", "mlp")]
    if cfg.family == "moe":
        return [LayerSpec("attn", "moe")]
    if cfg.family == "ssm":
        return [LayerSpec("mamba", None)]
    if cfg.family == "hybrid":
        if cfg.attn_period <= 0 or cfg.moe is None:
            raise ValueError(
                f"{cfg.name}: a hybrid needs attn_period > 0 and cfg.moe")
        pat = []
        for i in range(cfg.attn_period):
            mixer = "attn" if i == cfg.attn_period // 2 else "mamba"
            is_moe = (i % cfg.moe.moe_period) == (cfg.moe.moe_period - 1)
            pat.append(LayerSpec(mixer, "moe" if is_moe else "mlp"))
        return pat
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
        if spec.ffn == "mlp":
            p["mlp"] = L.init_mlp(gen, cfg, stack=n)
        else:
            p["moe"] = MOE.init_moe(gen, cfg, stack=n)
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
    (``F32_LEAVES``: ``a_log``, ``dt_bias``, ``skip_d``, ``router``),
    which stays f32.  ``device=None`` means the CUDA card (and raises
    without one)."""
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, Mapping):
            return {k: conv(v, k) for k, v in node.items()}
        t = to_tensor(np.array(node), dev)   # a copy: the source may be read-only
        if not t.is_floating_point():
            return t
        return t.float() if name in F32_LEAVES else t.to(cfg.param_dtype)

    return conv(tree)


def _head_matrix(params: dict) -> torch.Tensor:
    """(D, V) output projection — the transposed embedding when tied —
    gathered along the data axes where a mesh train step holds it in
    blocks (``tp.gather_data``)."""
    if "lm_head" in params:
        return tp.gather_data(params["lm_head"], ("lm_head",))
    return tp.gather_data(params["embed"], ("embed",)).T


def embed_tokens(table: torch.Tensor, cfg: ModelConfig, ids: torch.Tensor,
                 lookup=lambda table, ids: table[ids]) -> torch.Tensor:
    """Rows ``ids`` of the embedding ``table`` through ``lookup``; with a
    ``ModelSplit`` installed that the vocabulary divides, the table holds
    this rank's vocabulary shard and the rows are vocabulary-parallel
    (``tp.vocab_embed``: zeros outside the shard, summed over ``model``;
    the table's gradient is this rank's rows, through ``lookup``'s)."""
    split = tp.split_along(tp.vocab_rows(cfg))
    if split is None:
        return lookup(table, ids)
    return tp.vocab_embed(table, ids, split, lookup)


def head_logits(h: torch.Tensor, head: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """(B, V) f32 logits of ``h`` (B, D) through ``head`` (D, V) — with a
    ``ModelSplit`` installed that the vocabulary divides, this rank's
    vocabulary shard of it, and the logits gathered over ``model`` — cut
    to ``cfg.vocab_size``."""
    logits = shard_activation((h @ head).float(), "logits")
    logits = tp.gather(logits, -1, tp.split_along(tp.vocab_rows(cfg)))
    return logits[..., : cfg.vocab_size]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies).  A ``NamedTuple``
    leaf (an int8 ``QTensor``) is indexed field by field; a field of
    extent 1 along the layer axis — the scale of a (layers, D) leaf,
    taken over the layers — is every layer's."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(t[i if t.shape[0] > 1 else 0] for t in tree))
    return tree[i]


def _unbind_layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as views by ``torch.unbind``:
    under autograd their gradients are stacked back in one op (indexing
    each layer would add a zero-filled full-size gradient per layer)."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _ffn(p, cfg, spec: LayerSpec, h):
    if spec.ffn is None:
        return h
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    if spec.ffn == "mlp":
        return h + L.mlp_layer(p["mlp"], cfg, x)
    return h + MOE.moe_layer(p["moe"], cfg, x)


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
    return shard_activation(_ffn(p, cfg, spec, h + a), "hidden"), cache


def _apply_block_decode(p, cfg, spec: LayerSpec, h, pos: int, cache: dict):
    """One layer of a decode step; ``cache`` (views of the stacked cache)
    is updated in place."""
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        a, _, _ = L.attention_decode(p["attn"], cfg, x, pos, cache["k"],
                                     cache["v"])
    else:
        # a rank of a head split updates its own conv columns and heads;
        # where the mixer computes every column instead, the cache leaves
        # the rules put on ``model`` are gathered and each rank writes its
        # block back
        s, d = cfg.ssm, cfg.d_model
        on_conv = on_ssm = None
        if tp.mixer_split(cfg) is None:
            on_conv = tp.split_along(s.conv_dim(d))
            on_ssm = tp.split_along(s.num_heads(d))
        a, conv, ssm = M.mamba_decode(
            p["mamba"], cfg, x, tp.gather(cache["conv"], -1, on_conv),
            tp.gather(cache["ssm"], 1, on_ssm))
        cache["conv"].copy_(tp.own_block(conv, -1, on_conv))
        cache["ssm"].copy_(tp.own_block(ssm, 1, on_ssm))
    return _ffn(p, cfg, spec, h + a)


# ---------------------------------------------------------------------------
# backbone (a loop over superblocks)
# ---------------------------------------------------------------------------


def _superblock(block_p, cfg, pat, h, positions, mrope_positions,
                collect_cache):
    caches = {}
    for i, spec in enumerate(pat):
        h, c = _apply_block(block_p[f"b{i}"], cfg, spec, h, positions,
                            mrope_positions, collect_cache)
        caches[f"b{i}"] = c
    return h, caches


def backbone(params: dict, cfg: ModelConfig, h: torch.Tensor,
             positions: torch.Tensor, mrope_positions=None,
             collect_cache: bool = False):
    """The superblocks in turn, then the final norm.  Under autograd
    (grad enabled) each superblock's parameters come from one
    ``torch.unbind`` of the stacked leaves, and with ``cfg.remat`` each
    superblock runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped and recomputed in the backward, as the
    reference's ``jax.checkpoint(body)`` does.

    Where a mesh step holds the leaves in blocks along the data axes, a
    superblock's leaves are gathered when it runs (``tp.gather_data``)
    and freed when it returns, so a rank holds one superblock's at a
    time: in a prefill the caches it collects are stacked copies, no
    view of a gathered leaf; in training the gather is inside the
    checkpointed function, whose recompute gathers them again, so no
    gathered leaf is saved.  Without ``cfg.remat`` autograd keeps every
    superblock's gathered leaves for the backward."""
    pat = superblock_pattern(cfg)
    nsb = num_superblocks(cfg)
    grad = torch.is_grad_enabled()
    layers = _unbind_layers(params["blocks"], nsb) if grad else None
    remat = grad and cfg.remat and not collect_cache

    def run(bp, hh, collect):
        return _superblock(tp.gather_data(bp, ("blocks",), layer=True), cfg,
                           pat, hh, positions, mrope_positions, collect)

    per_layer = []
    for li in range(nsb):
        block_p = layers[li] if grad else _layer(params["blocks"], li)
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                lambda bp, hh: run(bp, hh, False)[0], block_p, h,
                use_reentrant=False)
            continue
        h, caches = run(block_p, h, collect_cache)
        per_layer.append(caches)
    h = L.rmsnorm(h, tp.gather_data(params["final_norm"], ("final_norm",)),
                  cfg.norm_eps)
    if not collect_cache:
        return h, None
    stacked = {name: {leaf: torch.stack([c[name][leaf] for c in per_layer])
                      for leaf in first}
               for name, first in per_layer[0].items()}
    return h, stacked


# ---------------------------------------------------------------------------
# the streaming chunked cross-entropy
# ---------------------------------------------------------------------------


def _chunk_logits(h, lm_head, t, chunk, valid_vocab, first):
    """(hs, logits (B, c, v) f32) of chunk ``t``: ``lm_head`` holds the
    vocabulary's columns ``[first, first + v)``; those at or past
    ``valid_vocab`` (padding) are set to -1e30 and never win the
    softmax."""
    hs = h[:, t * chunk:(t + 1) * chunk]
    logits = shard_activation((hs @ lm_head).float(), "logits")  # (B, c, v)
    if valid_vocab is not None and valid_vocab < first + logits.shape[-1]:
        logits[..., max(valid_vocab - first, 0):] = L.NEG_INF
    return hs, logits


def _chunk_labels(labels, t, chunk, first, v):
    """(this rank's column of each label of chunk ``t``, clamped into
    ``[0, v)``; whether the label lies in this rank's columns)."""
    local = labels[:, t * chunk:(t + 1) * chunk].long() - first
    inside = (local >= 0) & (local < v)
    return local.clamp(0, v - 1), inside


def _first_column(lm_head, split) -> int:
    return 0 if split is None else split.index * lm_head.shape[-1]


def _ce_chunk_terms(h, lm_head, labels, t, chunk, valid_vocab=None,
                    split=None):
    """(Σ(logz − gold), logz (B, c)) for chunk ``t``.  With a ``split``
    ``lm_head`` holds this rank's block of the vocabulary's columns: the
    softmax's max and sum are taken over the group (``tp.max_over``,
    ``tp.sum_partial``) and the gold logit comes from the rank that holds
    it; with none every collective is the identity and the same
    arithmetic runs on the whole vocabulary."""
    first = _first_column(lm_head, split)
    _, logits = _chunk_logits(h, lm_head, t, chunk, valid_vocab, first)
    v = logits.shape[-1]
    m = tp.max_over(logits.detach().amax(dim=-1), split)
    logz = m + torch.log(tp.sum_partial(
        torch.exp(logits - m[..., None]).sum(dim=-1), split))
    col, inside = _chunk_labels(labels, t, chunk, first, v)
    gold = logits.gather(-1, col[..., None])[..., 0]
    gold = tp.sum_partial(torch.where(inside, gold, 0.0), split)
    return (logz - gold).sum(), logz


def _chunked_ce_scan(h, lm_head, labels, chunk, valid_vocab=None,
                     split=None):
    """(mean CE over all (B, S) positions, summed chunk by chunk in f32;
    logz (B, S) f32)."""
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    logz = []
    for t in range(h.shape[1] // chunk):
        term, lz = _ce_chunk_terms(h, lm_head, labels, t, chunk, valid_vocab,
                                   split)
        total = total + term
        logz.append(lz)
    return total / (h.shape[0] * h.shape[1]), torch.cat(logz, dim=1)


class _ChunkedCE(torch.autograd.Function):
    """Chunked CE with a *streaming backward*: plain autograd through the
    chunk loop would keep every (B, c, V) logits chunk — the whole
    (B, S, V) tensor — for the backward.  This saves only (h, lm_head,
    labels) and the (B, S) log-partition, and recomputes each chunk's
    logits, emitting dh and a running f32 dW (the reference's
    ``jax.custom_vjp``, ``lm.py:283-326``).  The chunk's softmax and its
    one-hot correction are made in place in the logits buffer: no (B, c,
    V) one-hot is built.  Vocabulary-parallel (``split``): dW is this
    rank's columns' and dh a partial, which ``tp.enter`` in front of the
    head sums; the backward runs no collective."""

    @staticmethod
    def forward(ctx, h, lm_head, labels, chunk, valid_vocab, split):
        loss, logz = _chunked_ce_scan(h, lm_head, labels, chunk, valid_vocab,
                                      split)
        ctx.save_for_backward(h, lm_head, labels, logz)
        ctx.args = (chunk, valid_vocab, split)
        return loss

    @staticmethod
    def backward(ctx, ct):
        h, lm_head, labels, logz = ctx.saved_tensors
        chunk, valid_vocab, split = ctx.args
        b, s, d = h.shape
        v = lm_head.shape[1]
        first = _first_column(lm_head, split)
        scale = ct / (b * s)                    # dloss/dlogit pre-softmax
        w32 = lm_head.float()
        dh = torch.empty_like(h)
        dw = torch.zeros((d, v), dtype=torch.float32, device=h.device)
        rows = torch.arange(b * chunk, device=h.device)
        for t in range(s // chunk):
            hs, logits = _chunk_logits(h, lm_head, t, chunk, valid_vocab,
                                       first)
            col, inside = _chunk_labels(labels, t, chunk, first, v)
            lz = logz[:, t * chunk:(t + 1) * chunk]
            p = logits.sub_(lz[..., None]).exp_()        # softmax (B, c, v)
            p.view(-1, v)[rows, col.reshape(-1)] -= inside.reshape(-1).float()
            dlogits = p.mul_(scale)
            dh[:, t * chunk:(t + 1) * chunk] = (dlogits @ w32.T).to(h.dtype)
            dw += hs.reshape(-1, d).float().T @ dlogits.view(-1, v)
        return dh, dw.to(lm_head.dtype), None, None, None, None


def chunked_ce_loss(
    h: torch.Tensor,            # (B, S, D)
    lm_head: torch.Tensor,      # (D, V), or this rank's (D, V/tp)
    labels: torch.Tensor,       # (B, S) int
    chunk: int,
    streaming_bwd: bool = True,
    valid_vocab: int | None = None,
    split=None,
) -> torch.Tensor:
    """Cross-entropy streamed over sequence chunks: the (B, S, V) logits
    tensor is never materialised, in the backward either
    (``streaming_bwd``; ``False`` is plain autograd through the chunk
    loop, kept for the before/after measurement).  Each chunk's three
    products are ``torch.matmul``, as the reference leaves them to XLA.

    ``split`` (a ``ctx.ModelSplit``, the vocabulary's; ``None``: the
    whole vocabulary): ``lm_head`` holds this rank's block of columns,
    ``valid_vocab`` still counts global columns, and ``h`` enters the
    head through ``tp.enter``, which sums the ranks' partial dh."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: chunk {chunk} does not divide "
                         f"the sequence {s}")
    h = tp.enter(h, split)
    if streaming_bwd:
        return _ChunkedCE.apply(h, lm_head, labels, chunk, valid_vocab, split)
    return _chunked_ce_scan(h, lm_head, labels, chunk, valid_vocab, split)[0]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


class _EmbedRows(torch.autograd.Function):
    """``table[idx]``, whose gradient is summed over repeated indices in
    f32 and cast once to the table's dtype (``index_put_`` with
    ``accumulate``; on the card a sort-based, deterministic sum).  The
    reference adds the repeats in the parameter dtype, so in bf16 the
    port's embedding gradient is the more exact of the two."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table = (table.shape, table.dtype)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.zeros(shape, dtype=torch.float32, device=g.device)
        acc.index_put_((idx.reshape(-1),), g.reshape(-1, shape[-1]).float(),
                       accumulate=True)
        return acc.to(dtype), None


def _embed_in(params: dict, cfg: ModelConfig, tokens_or_embeds):
    if cfg.embeds_input:
        h = tokens_or_embeds.to(cfg.param_dtype)
    else:
        h = embed_tokens(tp.gather_data(params["embed"], ("embed",)), cfg,
                         tokens_or_embeds.long(), _EmbedRows.apply)
    return shard_activation(h, "hidden")


def lm_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch``: ``{"tokens" | "embeds", "labels",
    optional "mrope_positions"}`` (f32 scalar)."""
    x = batch["embeds"] if cfg.embeds_input else batch["tokens"]
    h = _embed_in(params, cfg, x)
    bsz, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(bsz, s)
    h, _ = backbone(params, cfg, h, positions,
                    mrope_positions=batch.get("mrope_positions"))
    return chunked_ce_loss(h, _head_matrix(params), batch["labels"],
                           cfg.loss_chunk,
                           streaming_bwd=cfg.loss_streaming_bwd,
                           valid_vocab=cfg.vocab_size
                           if cfg.padded_vocab != cfg.vocab_size else None,
                           split=tp.split_along(tp.vocab_rows(cfg)))


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
    return head_logits(h[:, -1], _head_matrix(params), cfg), caches


def lm_decode(params: dict, cfg: ModelConfig, cache: dict,
              token: torch.Tensor, pos: int):
    """One decode step at absolute position ``pos`` for ``token`` (B,)
    (or (B, 1, D) embeds).  Returns (logits (B, V) f32, cache): the cache
    is the one passed in, **updated in place**.  Under a mesh serve step
    the embedding, each superblock's leaves, the final norm and the head
    are gathered along the data axes where they are read
    (``tp.gather_data``), every superblock on every token, as the
    reference's jitted decode does."""
    pat = superblock_pattern(cfg)
    if cfg.embeds_input:
        h = token.to(cfg.param_dtype)
        if h.ndim == 2:
            h = h[:, None, :]
    else:
        h = embed_tokens(tp.gather_data(params["embed"], ("embed",)), cfg,
                         token.long())[:, None, :]
    h = shard_activation(h, "hidden")                           # (B, 1, D)
    for li in range(num_superblocks(cfg)):
        h = _superblock_decode(_layer(params["blocks"], li), cfg, pat, h,
                               pos, _layer(cache, li))
    h = L.rmsnorm(h, tp.gather_data(params["final_norm"], ("final_norm",)),
                  cfg.norm_eps)
    return head_logits(h[:, 0], _head_matrix(params), cfg), cache


def _superblock_decode(block_p, cfg, pat, h, pos: int, cache: dict):
    """One superblock of a decode step, its leaves gathered along the data
    axes here (``tp.gather_data``), so that they are freed when it
    returns, before the next superblock's are gathered."""
    block_p = tp.gather_data(block_p, ("blocks",), layer=True)
    for i, spec in enumerate(pat):
        h = _apply_block_decode(block_p[f"b{i}"], cfg, spec, h, pos,
                                cache[f"b{i}"])
    return h


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
