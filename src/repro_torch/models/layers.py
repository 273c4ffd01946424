"""Transformer building blocks of the LM families, in PyTorch.

Attention has three interchangeable implementations (``ATTN_IMPLS``):

* ``cuda`` — the hand-written flash-attention kernels
  (``repro_torch.kernels.flash_attention`` through ``ops.flash_attention``;
  their plain versions on a CPU tensor).  The default: the prefill path
  and the train path, whose gradient is the hand-written backward kernel.
* ``blockwise`` — KV tiles stream through a Python loop with running
  (m, l, acc) state: flash attention written as PyTorch ops.  Its
  gradient is the reference's *streaming backward* (a
  ``torch.autograd.Function`` that recomputes each score block from the
  saved log-sum-exp), or with ``streaming_bwd=False`` plain autograd
  through the loop, which keeps every score block.
* ``reference`` — dense softmax (oracle; small shapes only).

Decode (Sq == 1) always uses the bounded-KV-cache path: one new token
against a position-masked cache, plain PyTorch, like every projection
(``@``) — the reference computes them outside any kernel too.

The MLP is ``"dense"`` (three ``@`` products, the default) or
``"streamed"``: the hand-written fused-MLP kernel (``ops.fused_mlp``),
which never writes the ``(tokens, d_ff)`` hidden out, in prefill and
decode alike.

Shapes, layouts and the places where bf16 rounds follow the reference's
``models/layers.py``: RMSNorm normalises in f32, casts, then multiplies
by the weight in the activation dtype; RoPE computes in f32 and casts
back; q is scaled in its own dtype before attention.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx, tp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import scale_in_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None,
               *, stack: int | None = None) -> torch.Tensor:
    """Normal weights ``× 1/sqrt(fan_in)`` (``fan_in = shape[0]``) drawn in
    f32 on the generator's device, then cast.  ``stack`` prepends a
    layer axis of that length (the stacked layout of ``lm.init_params``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    full = tuple(shape) if stack is None else (stack, *shape)
    w = torch.randn(full, generator=gen, device=gen.device,
                    dtype=torch.float32)
    # scaled in place: one f32 copy of the leaf at a time (nemotron-4-15b's
    # stacked ``wu`` is 19 GB in f32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(
    positions: torch.Tensor,  # (B, S) int
    head_dim: int,
    theta: float,
    mrope_sections: tuple[int, ...] = (),
    mrope_positions: torch.Tensor | None = None,   # (3, B, S) for M-RoPE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns cos/sin of shape (B, S, head_dim/2), f32.

    M-RoPE (Qwen2-VL, arXiv:2409.12191): the head_dim/2 frequency slots
    are split into (t, h, w) sections; each section rotates by its own
    position stream.  Text-only tokens pass identical streams.
    """
    inv = _rope_inv_freq(head_dim, theta, positions.device)   # (hd/2,)
    if mrope_sections:
        if mrope_positions is None:
            raise ValueError("M-RoPE needs mrope_positions (3, B, S)")
        if sum(mrope_sections) != head_dim // 2:
            raise ValueError(
                f"M-RoPE sections {mrope_sections} do not cover "
                f"head_dim/2 = {head_dim // 2}")
        pieces = []
        off = 0
        for axis, sec in enumerate(mrope_sections):
            p = mrope_positions[axis].float()                 # (B, S)
            pieces.append(p[..., None] * inv[off: off + sec][None, None])
            off += sec
        ang = torch.cat(pieces, dim=-1)                       # (B, S, hd/2)
    else:
        ang = positions.float()[..., None] * inv[None, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, hd); cos/sin: (B, S, hd/2). Rotate-half convention."""
    half = x.shape[-1] // 2
    c = cos[:, None].float()
    s = sin[:, None].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention implementations
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    return ref.attention(q, k, v, causal=causal, q_offset=q_offset)


def _divisor_block(size: int, target: int) -> int:
    b = max(min(target, size), 1)
    while size % b:
        b -= 1
    return b


def _flash_forward_blocks(qb, kb, vb, *, causal, q_offset, block_q, block_k):
    """qb (B,Hkv,g,nq,bq,D) pre-scaled; kb/vb (B,Hkv,nk,bk,D).  Returns
    (out (B,Hkv,g,nq,bq,D) f32, lse (B,Hkv,g,nq,bq) f32): per query
    block, a loop over the key blocks carrying (m, l, acc)."""
    b, hkv, g, nq, bq, d = qb.shape
    nk = kb.shape[2]
    dev = qb.device
    outs, lses = [], []
    for qi in range(nq):
        qc = qb[:, :, :, qi].float()                          # (B,Hkv,g,bq,D)
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, block_q), device=dev)
        acc = torch.zeros((b, hkv, g, block_q, d), device=dev)
        for ki in range(nk):
            kc = kb[:, :, ki].float()                         # (B,Hkv,bk,D)
            vc = vb[:, :, ki].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            if causal:
                vis = fa.causal_mask(block_q, block_k,
                                     qi * block_q + q_offset - ki * block_k,
                                     dev)
                s = torch.where(vis, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])               # masked → 0
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vc)
            m = m_new
        safe_l = torch.where(l > 0, l, 1.0)
        outs.append(acc / safe_l[..., None])
        lses.append(m + torch.log(safe_l))
    return torch.stack(outs, dim=3), torch.stack(lses, dim=3)


def _blocks(q, k, v, block_q, block_k):
    """q pre-scaled in its dtype and q/k/v cut into blocks: (qb
    (B,Hkv,g,nq,bq,D), kb, vb (B,Hkv,nk,bk,D))."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    qb = scale_in_dtype(q, d ** -0.5).reshape(b, hkv, g, sq // block_q,
                                              block_q, d)
    kb = k.reshape(b, hkv, sk // block_k, block_k, d)
    vb = v.reshape(b, hkv, sk // block_k, block_k, d)
    return qb, kb, vb


def _blockwise_attention_fwd(q, k, v, causal, q_offset, block_q, block_k):
    """(out in q's dtype, lse (B,Hkv,g,nq,bq) f32)."""
    qb, kb, vb = _blocks(q, k, v, block_q, block_k)
    o, lse = _flash_forward_blocks(qb, kb, vb, causal=causal,
                                   q_offset=q_offset, block_q=block_q,
                                   block_k=block_k)
    return o.reshape(q.shape).to(q.dtype), lse


class _BlockwiseAttention(torch.autograd.Function):
    """Flash attention with a *streaming backward*: plain autograd through
    the block loop would keep every (bq, bk) score block — the whole
    O(Sq·Sk) matrix — for the backward; this saves only (q, k, v, out,
    lse) and recomputes score blocks on the fly, as the reference's
    ``jax.custom_vjp`` does — through the kernel's plain backward body,
    ``flash_attention.streaming_attention_bwd``, with this forward's
    convention for a row that sees no key (the mean of v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_q, block_k):
        out, lse = _blockwise_attention_fwd(q, k, v, causal, q_offset,
                                            block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, block_q, block_k = ctx.args
        b, hq, sq, d = q.shape
        _, hkv, sk, _ = k.shape
        dq, dk, dv = fa.streaming_attention_bwd(
            scale_in_dtype(q, d ** -0.5).reshape(b * hq, sq, d),
            k.reshape(b * hkv, sk, d), v.reshape(b * hkv, sk, d),
            out.reshape(b * hq, sq, d), lse.reshape(b * hq, sq),
            dout.reshape(b * hq, sq, d), heads_q=hq, heads_kv=hkv,
            causal=causal, q_offset=q_offset, scale=d ** -0.5,
            block_q=block_q, block_k=block_k, unseen_rows="mean")
        return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape),
                None, None, None, None)


def blockwise_attention(
    q: torch.Tensor,      # (B, Hq, Sq, D)
    k: torch.Tensor,      # (B, Hkv, Sk, D)
    v: torch.Tensor,      # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 512,
    streaming_bwd: bool = True,
) -> torch.Tensor:
    """Streaming flash attention as PyTorch ops.  Blocks shrink to the
    largest divisor of the length, so odd serving lengths run.

    ``streaming_bwd=False`` takes plain autograd through the loop (which
    keeps every score block for the backward) — kept selectable, as the
    reference keeps it, for the before/after measurement."""
    block_q = _divisor_block(q.shape[2], block_q)
    block_k = _divisor_block(k.shape[2], block_k)
    if streaming_bwd:
        return _BlockwiseAttention.apply(q, k, v, causal, q_offset, block_q,
                                         block_k)
    return _blockwise_attention_fwd(q, k, v, causal, q_offset, block_q,
                                    block_k)[0]


def decode_attention(
    q: torch.Tensor,        # (B, Hq, 1, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    length: int,            # number of valid cache positions
) -> torch.Tensor:
    """One-token attention against a bounded, position-masked KV cache."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = scale_in_dtype(q.reshape(b, hkv, g, d), d ** -0.5).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    valid = torch.arange(s, device=q.device) < length
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                   block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """The flash-attention kernel, differentiable through its backward
    kernel (``ops.flash_attention``).  Blocks are clamped to the lengths
    and must divide them, as the TPU path demands (they only gate the
    call: the kernel tiles by itself)."""
    return ops.flash_attention(
        q, k, v, causal=causal, q_offset=q_offset,
        block_q=min(block_q, q.shape[2]), block_k=min(block_k, k.shape[2]),
    )


ATTN_IMPLS = {
    "blockwise": blockwise_attention,
    "reference": lambda q, k, v, causal=True, q_offset=0, **_: attention_reference(
        q, k, v, causal=causal, q_offset=q_offset
    ),
    "cuda": attention_cuda,
}


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + impl dispatch + cache)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False, *, stack: int | None = None) -> dict:
    """The projections of self- or (``cross``) cross-attention: the same
    leaves either way, as in the reference."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = cfg.param_dtype
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), dt, stack=stack),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), dt, stack=stack),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), dt, stack=stack),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), dt, stack=stack),
    }
    if cfg.qkv_bias:
        lead = () if stack is None else (stack,)
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(lead + (width * hd,), dtype=dt,
                                  device=gen.device)
    return p


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, n·hd) → (B, n, S, hd): the heads this rank computes."""
    b, s, width = x.shape
    return x.reshape(b, s, width // hd, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


#: the three ways a rank computes the attention along an installed
#: ``ModelSplit`` (:func:`head_case`), as the rules place its leaves
#: (``sharding.make_param_shardings``' ``q_ok`` and ``kv_ok``):
#:
#: * ``HEADS`` — both the query and the kv heads divide it: the rank's
#:   H/tp query and Hkv/tp kv heads, on its shards, the GQA ratio kept;
#: * ``QUERY`` — only the query heads divide it: the rank's H/tp query
#:   heads on its ``wq`` / ``bq`` / ``wo`` shards, against the kv heads
#:   those read, projected from the whole ``wk`` / ``wv`` / ``bk`` /
#:   ``bv`` (``tp.kv_heads_read``);
#: * ``WHOLE`` — neither: every leaf whole, as the rules replicate them,
#:   and every head on every rank (as with no split installed).
HEADS, QUERY, WHOLE = "heads", "query", "whole"


def head_case(cfg: ModelConfig) -> tuple:
    """(case, split): ``HEADS`` or ``QUERY`` with the installed
    ``ModelSplit`` — there the rank computes its query heads, and the
    gradient of what enters their projections is a partial — or
    ``(WHOLE, None)``.  Where the kv heads divide the split the query
    heads do too (Hkv divides H)."""
    q = tp.split_along(cfg.num_heads)
    if q is None:
        return WHOLE, None
    return (HEADS if tp.split_along(cfg.num_kv_heads) else QUERY), q


def attention_leaves(p: dict, cfg: ModelConfig):
    """(leaves, case, split): the attention leaves as this rank computes
    with them, by :func:`head_case`.  ``HEADS``: the rank's shards as
    they are.  ``QUERY``: ``wq``, ``bq`` and ``wo`` the rank's shards;
    ``wk``, ``wv``, ``bk`` and ``bv`` whole, entered through
    ``tp.enter`` — the rank's heads give only its share of their
    gradient, summed over ``model`` there.  ``WHOLE``: every leaf whole,
    as the rules replicate them.  No leaf is gathered along ``model``.
    ``split``: the installed split over which the ``wo`` product is
    summed, ``None`` for ``WHOLE``."""
    case, split = head_case(cfg)
    if case == QUERY:
        p = {name: tp.enter(t, split) if name in ("wk", "wv", "bk", "bv")
             else t for name, t in p.items()}
    return p, case, split


def _kv_read(k, v, cfg: ModelConfig, case: str, split):
    """(k, v) as the rank's query heads read them: under ``QUERY`` the
    kv heads they read (``tp.kv_heads_read``), else as given."""
    if case != QUERY:
        return k, v
    return tuple(tp.kv_heads_read(t, cfg.num_heads, cfg.num_kv_heads, split)
                 for t in (k, v))


def attention_layer(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, S, D)
    positions: torch.Tensor,         # (B, S) int
    *,
    causal: bool = True,
    mrope_positions: torch.Tensor | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output, (k, v)) — k/v in (B, Hkv, S, hd) layout for caching.
    With ``kv_override=(k, v)`` (each (B, Hkv, T, hd): the encoder
    memory's keys and values, as the encoder–decoder's teacher-forced
    cross-attention hands them in) the layer projects only the query,
    applies no RoPE to it (the positions are unrelated to the memory's)
    and returns the given (k, v).

    Along a ``model`` split the layer computes by :func:`head_case`.
    ``HEADS``: this rank's query and kv heads, and (k, v) hold its kv
    heads.  ``QUERY``: this rank's query heads against the kv heads they
    read (``tp.kv_heads_read``) of keys and values projected whole, and
    (k, v) hold every kv head.  In both ``x`` enters the projections
    through ``tp.enter`` (its gradient from this rank's heads is a
    partial, summed over ``model``) and the ``wo`` product is summed over
    ``model``.  ``WHOLE``: every head, as on one device.  With
    ``kv_override`` the given keys and values are those (k, v) would be,
    from a source that entered the same way (``encdec.decode_train``'s
    memory)."""
    hd = cfg.resolved_head_dim
    p, case, split = attention_leaves(p, cfg)
    x = tp.enter(x, split)
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, hd)
    if kv_override is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = _split_heads(k, hd)
        v = _split_heads(v, hd)
        cos, sin = rope_cos_sin(
            positions, hd, cfg.rope_theta,
            mrope_sections=cfg.mrope_sections,
            mrope_positions=mrope_positions,
        )
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv_override
    k_read, v_read = _kv_read(k, v, cfg, case, split)

    if cfg.attn_impl == "blockwise":
        out = blockwise_attention(
            q, k_read, v_read, causal=causal, q_offset=0,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
            streaming_bwd=cfg.attn_streaming_bwd,
        )
    else:
        impl = ATTN_IMPLS[cfg.attn_impl]
        out = impl(q, k_read, v_read, causal=causal, q_offset=0,
                   block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    return tp.sum_partial(_merge_heads(out) @ p["wo"], split), (k, v)


def _decode_attention_blocks(q, k_cache, v_cache, length: int,
                             split) -> torch.Tensor:
    """:func:`decode_attention` over caches whose positions lie in blocks
    along ``model``: this rank holds positions ``[index·s, (index+1)·s)``
    (``k_cache`` (B, Hkv, s, D)), attends over those below ``length``,
    and the (max, sum, out) triples are combined across the group."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = scale_in_dtype(q.reshape(b, hkv, g, d), d ** -0.5).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    valid = split.index * s + torch.arange(s, device=q.device) < length
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    out = tp.combine_softmax(m, p.sum(dim=-1), o, split)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def attention_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, 1, D)
    pos: int,                        # absolute position of the token
    k_cache: torch.Tensor,           # (B, Hkv, S, hd)
    v_cache: torch.Tensor,
    *,
    cross: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; returns (out, k_cache, v_cache).  The new key and
    value are written into the caches **in place** (the reference donates
    its caches to the step, which has the same effect).  With ``cross``
    the caches are the fixed encoder memory's keys and values: the query
    attends to all of them, with no RoPE and no cache write.

    Along a ``model`` split the layer computes by :func:`head_case`.
    ``HEADS``: the caches hold this rank's kv heads and it attends with
    its query heads.  Otherwise the caches hold every kv head, and where
    their positions lie in blocks along ``model`` (``ModelSplit.kv_seq``:
    the kv heads do not divide it) the rank that holds position ``pos``
    writes the new key and value, and the softmax is taken in blocks
    (:func:`_decode_attention_blocks`) for every query head: ``QUERY``
    gathers its heads' queries along ``model`` first — one (B, H, 1, hd)
    a layer — and keeps its own heads of the result for its ``wo``
    shard.  Where the caches are whole along ``model``, ``QUERY`` attends
    with its query heads to the kv heads they read
    (``tp.kv_heads_read``).  ``WHOLE`` computes every head."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    p, case, split = attention_leaves(p, cfg)
    seq = ctx.model_split()
    seq = seq if seq is not None and seq.kv_seq and case != HEADS else None
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, hd)

    def attend(length):
        if seq is None:
            k_read, v_read = _kv_read(k_cache, v_cache, cfg, case, split)
            return decode_attention(q, k_read, v_read, length)
        if case == WHOLE:
            return _decode_attention_blocks(q, k_cache, v_cache, length, seq)
        every = _decode_attention_blocks(tp.gather(q, 1, split), k_cache,
                                         v_cache, length, seq)
        return tp.own_block(every, 1, split)

    if cross:
        width = k_cache.shape[2] * (1 if seq is None else seq.count)
        out = attend(width)
        return tp.sum_partial(_merge_heads(out) @ p["wo"], split), \
            k_cache, v_cache

    pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(pos_arr, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)

    k_new = x @ p["wk"]
    v_new = x @ p["wv"]
    if "bk" in p:
        k_new, v_new = k_new + p["bk"], v_new + p["bv"]
    k_new = apply_rope(_split_heads(k_new, hd), cos, sin)
    v_new = _split_heads(v_new, hd)
    owner, at = (0, pos) if seq is None else divmod(pos, k_cache.shape[2])
    if seq is None or owner == seq.index:
        k_cache[:, :, at: at + 1] = k_new
        v_cache[:, :, at: at + 1] = v_new
    out = attend(pos + 1)
    return tp.sum_partial(_merge_heads(out) @ p["wo"], split), k_cache, \
        v_cache


# ---------------------------------------------------------------------------
# MLP (dense and streamed)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, *,
             stack: int | None = None) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    p = {
        "wu": dense_init(gen, (d, f), dt, stack=stack),
        "wd": dense_init(gen, (f, d), dt, stack=stack),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, (d, f), dt, stack=stack)
    return p


def mlp_layer(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP, dense or streamed.  With a ``ModelSplit`` installed that
    ``d_ff`` divides, the leaves hold this rank's ``d_ff`` columns (and
    ``wd`` its rows), ``x`` enters them through ``tp.enter`` and the
    ``wd`` product is summed over ``model``."""
    split = tp.split_along(cfg.d_ff)
    x = tp.enter(x, split)
    if cfg.mlp_impl == "streamed":
        return tp.sum_partial(_mlp_streamed(p, cfg, x), split)
    up = x @ p["wu"]
    if cfg.gated_mlp:
        h = ref._act(cfg.act, x @ p["wg"]) * up
    else:
        h = ref._act(cfg.act, up)
    return tp.sum_partial(h @ p["wd"], split)


def _mlp_streamed(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  block_f: int = 2048) -> torch.Tensor:
    """The hidden streamed in ``d_ff`` tiles so that the ``(tokens,
    d_ff)`` activation never exists whole: one call of the fused-MLP
    kernel (``ops.fused_mlp``; its plain version on a CPU tensor), and
    under autograd one call of its backward kernel, which recomputes the
    hidden.

    As in the reference, ``block_f`` is clamped to ``d_ff`` (the rank's
    shard of it, under a ``model`` split) and must
    divide it (ValueError naming ``block_f`` otherwise); the kernel tiles
    by itself.  Rounding, in bf16: the kernel feeds the hidden to the
    down product as a bf16 high part plus a bf16 low part (16 significant
    bits; the Pallas kernel keeps f32), and keeps the up and gate
    products and the sum over tiles in f32, where the reference's
    graph-level loop (``src/repro/models/layers.py:536-554``) rounds the
    products, the hidden and each tile's down product to bf16 — so the
    streamed kernel is the more exact of the two; in f32 every route
    keeps f32."""
    bf = min(block_f, p["wu"].shape[-1])
    return ops.fused_mlp(x, p["wg"] if cfg.gated_mlp else None, p["wu"],
                         p["wd"], act=cfg.act, block_f=bf)
