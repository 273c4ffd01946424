"""Transformer building blocks of the dense family, in PyTorch.

Attention has three interchangeable implementations (``ATTN_IMPLS``):

* ``cuda`` — the hand-written flash-attention kernel
  (``repro_torch.kernels.flash_attention`` through ``ops.flash_attention``;
  its plain version on a CPU tensor).  The default, and the prefill path.
* ``blockwise`` — KV tiles stream through a Python loop with running
  (m, l, acc) state: flash attention written as PyTorch ops, forward
  only (its streaming backward comes with training).
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
    return (w * scale).to(dtype)


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
    out (B,Hkv,g,nq,bq,D) f32: per query block, a loop over the key
    blocks carrying (m, l, acc)."""
    b, hkv, g, nq, bq, d = qb.shape
    nk = kb.shape[2]
    dev = qb.device
    outs = []
    for qi in range(nq):
        qc = qb[:, :, :, qi].float()                          # (B,Hkv,g,bq,D)
        qpos = qi * block_q + torch.arange(block_q, device=dev) + q_offset
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, block_q), device=dev)
        acc = torch.zeros((b, hkv, g, block_q, d), device=dev)
        for ki in range(nk):
            kc = kb[:, :, ki].float()                         # (B,Hkv,bk,D)
            vc = vb[:, :, ki].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            if causal:
                kpos = ki * block_k + torch.arange(block_k, device=dev)
                bias = torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                   NEG_INF)                   # (bq, bk)
                s = s + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])               # masked → 0
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vc)
            m = m_new
        safe_l = torch.where(l > 0, l, 1.0)
        outs.append(acc / safe_l[..., None])
    return torch.stack(outs, dim=3)


def blockwise_attention(
    q: torch.Tensor,      # (B, Hq, Sq, D)
    k: torch.Tensor,      # (B, Hkv, Sk, D)
    v: torch.Tensor,      # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Streaming flash attention as PyTorch ops (forward only).  Blocks
    shrink to the largest divisor of the length, so odd serving lengths
    run."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    block_q = _divisor_block(sq, block_q)
    block_k = _divisor_block(sk, block_k)
    g = hq // hkv
    nq, nk = sq // block_q, sk // block_k
    qb = scale_in_dtype(q, d ** -0.5).reshape(b, hkv, g, nq, block_q, d)
    kb = k.reshape(b, hkv, nk, block_k, d)
    vb = v.reshape(b, hkv, nk, block_k, d)
    o = _flash_forward_blocks(qb, kb, vb, causal=causal, q_offset=q_offset,
                              block_q=block_q, block_k=block_k)
    return o.reshape(b, hq, sq, d).to(q.dtype)


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
    """The flash-attention kernel.  Blocks are clamped to the lengths and
    must divide them, as the TPU path demands (they only gate the call:
    the kernel tiles by itself)."""
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


def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   stack: int | None = None) -> dict:
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


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def attention_layer(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, S, D)
    positions: torch.Tensor,         # (B, S) int
    *,
    causal: bool = True,
    mrope_positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output, (k, v)) — k/v in (B, Hkv, S, hd) layout for caching.
    (Cross-attention comes with the encoder–decoder family.)"""
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, cfg.num_heads, hd)
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = _split_heads(k, cfg.num_kv_heads, hd)
    v = _split_heads(v, cfg.num_kv_heads, hd)
    cos, sin = rope_cos_sin(
        positions, hd, cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
        mrope_positions=mrope_positions,
    )
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    impl = ATTN_IMPLS[cfg.attn_impl]
    out = impl(q, k, v, causal=causal, q_offset=0,
               block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    return _merge_heads(out) @ p["wo"], (k, v)


def attention_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, 1, D)
    pos: int,                        # absolute position of the token
    k_cache: torch.Tensor,           # (B, Hkv, S, hd)
    v_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; returns (out, k_cache, v_cache).  The new key and
    value are written into the caches **in place** (the reference donates
    its caches to the step, which has the same effect)."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, cfg.num_heads, hd)

    pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(pos_arr, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)

    k_new = x @ p["wk"]
    v_new = x @ p["wv"]
    if "bk" in p:
        k_new, v_new = k_new + p["bk"], v_new + p["bv"]
    k_new = apply_rope(_split_heads(k_new, cfg.num_kv_heads, hd), cos, sin)
    v_new = _split_heads(v_new, cfg.num_kv_heads, hd)
    k_cache[:, :, pos: pos + 1] = k_new
    v_cache[:, :, pos: pos + 1] = v_new
    out = decode_attention(q, k_cache, v_cache, pos + 1)
    return _merge_heads(out) @ p["wo"], k_cache, v_cache


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
    if cfg.mlp_impl == "streamed":
        return _mlp_streamed(p, cfg, x)
    up = x @ p["wu"]
    if cfg.gated_mlp:
        h = ref._act(cfg.act, x @ p["wg"]) * up
    else:
        h = ref._act(cfg.act, up)
    return h @ p["wd"]


def _mlp_streamed(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  block_f: int = 2048) -> torch.Tensor:
    """The hidden streamed in ``d_ff`` tiles so that the ``(tokens,
    d_ff)`` activation never exists whole: one call of the fused-MLP
    kernel (``ops.fused_mlp``; its plain version on a CPU tensor).

    As in the reference, ``block_f`` is clamped to ``d_ff`` and must
    divide it (ValueError naming ``block_f`` otherwise); the kernel tiles
    by itself.  One difference of rounding: the kernel keeps the hidden
    and the sum over tiles in f32, where the reference's graph-level loop
    (``src/repro/models/layers.py:536-554``) rounds each tile's products
    to the activation dtype — equal in f32, slightly more exact in bf16."""
    bf = min(block_f, cfg.d_ff)
    return ops.fused_mlp(x, p["wg"] if cfg.gated_mlp else None, p["wu"],
                         p["wd"], act=cfg.act, block_f=bf)
