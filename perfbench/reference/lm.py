"""The plain reference of the decoder-only language models the benchmark
runs: the equations of the configuration as it is run, written in plain
PyTorch and computed in float32 (TF32 off), with no kernel, cache or
batching of the program's.

It imports nothing of the program.  It reads the parameter tree that the
benchmark draws (``perfbench.lib.weights``), in the port's layout: stacked
leaves with a leading layer axis under ``blocks/b0``, then ``final_norm``,
``embed`` (padded vocabulary, D) and, unless the configuration ties the
head to the embedding (``tie_embeddings``: the head is ``embedᵀ``),
``lm_head`` (D, padded vocabulary).

What a layer computes, by the configuration's ``family``:

* ``moe``: pre-norm attention (GQA; RoPE by rotating halves, angles
  ``pos / theta^(2i/hd)``; causal softmax with scale ``hd^-0.5``), then a
  pre-norm mixture of experts: f32 router logits, the k largest (ties: the
  lower index), softmax over those k, a choice kept while the number of
  earlier choices of its expert in (token, choice) order is under the
  capacity ``max(8, ceil8(ceil(N·k·capacity_factor / E)))`` of the N
  tokens of the call, SiLU-gated expert MLPs, the kept choices summed by
  their weights;
* ``ssm``: pre-norm Mamba-2 mixer (arXiv:2405.21060, one group of B and
  C): ``z | xBC | dt`` from ``in_proj``, a causal depthwise conv of width
  K without bias then SiLU, ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(a_log)``, the SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t
  x_t B_tᵀ``, ``y_t = h_t C_t + D x_t``, the gate ``y · silu(z)`` before
  an RMSNorm over the inner width, and ``out_proj``.

RMSNorm is ``x / sqrt(mean(x²) + eps) · w``.  The head's logits past
``vocab_size`` (padding) are cut off.  The training loss is the mean
next-token cross-entropy over every position.

``Numerics`` names the rounding applied to both operands of every
product: none for the reference; float8 e4m3 with one scale per tensor
for the control, which stands in the program's place to show that the
comparison fails a precision below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

#: query rows a block of the attention's score matrix holds
ATTN_BLOCK = 1024
#: positions a chunk of the SSD's matrix form holds (the result does not
#: depend on it)
SSD_CHUNK = 64


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    absolute maximum onto 448), back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # straight through: the rounding passes the gradient unchanged
    return x + (q - x).detach()


@dataclass(frozen=True)
class Numerics:
    """How the operands of every product are rounded: ``"f32"`` (not at
    all) or ``"fp8"`` (float8 e4m3, a scale per tensor)."""

    name: str = "f32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.name == "fp8" else x


F32 = Numerics("f32")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def _mm(nm: Numerics, a, b):
    return nm.q(a) @ nm.q(b)


def _rope(x, theta):
    """x (B, H, S, hd): rotate halves by angles ``pos / theta^(2i/hd)``."""
    s, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, cfg, x, nm: Numerics):
    """Causal GQA attention of x (B, S, D) → (B, S, D)."""
    b, s, _ = x.shape
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["head_dim"]
    q = _mm(nm, x, p["wq"]).view(b, s, h, hd).transpose(1, 2)
    k = _mm(nm, x, p["wk"]).view(b, s, hkv, hd).transpose(1, 2)
    v = _mm(nm, x, p["wv"]).view(b, s, hkv, hd).transpose(1, 2)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    kq = k.repeat_interleave(h // hkv, dim=1)
    vq = v.repeat_interleave(h // hkv, dim=1)
    outs = []
    for r0 in range(0, s, ATTN_BLOCK):
        qs = q[:, :, r0:r0 + ATTN_BLOCK]
        cols = r0 + qs.shape[2]
        sc = _mm(nm, qs, kq[:, :, :cols].transpose(-1, -2)) * hd ** -0.5
        rows = torch.arange(r0, cols, device=x.device)[:, None]
        seen = torch.arange(cols, device=x.device)[None, :] <= rows
        sc = sc.masked_fill(~seen, float("-inf"))
        outs.append(_mm(nm, torch.softmax(sc, dim=-1), vq[:, :, :cols]))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * hd)
    return _mm(nm, out, p["wo"])


def capacity(tokens: int, moe: dict) -> int:
    """Slots per expert for a call of ``tokens`` tokens."""
    c = math.ceil(tokens * moe["top_k"] * moe["capacity_factor"]
                  / moe["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p, cfg, x, nm: Numerics):
    """The mixture of experts of x (B, S, D), its capacity that of the
    B·S tokens of the call."""
    m = cfg["moe"]
    e, k = m["num_experts"], m["top_k"]
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    logits = _mm(nm, xf, p["router"])
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1).reshape(-1)     # (N·k,)
    choice = idx[:, :k].reshape(-1)                            # (N·k,)
    onehot = F.one_hot(choice, e)
    earlier = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, choice[:, None])[:, 0]
    keep = earlier < capacity(n, m)
    y = torch.zeros_like(xf)
    act = _act(cfg["act"])
    for ex in range(e):
        pair = torch.nonzero(keep & (choice == ex))[:, 0]
        if pair.numel() == 0:
            continue
        tok = pair // k
        xe = xf[tok]
        hid = act(_mm(nm, xe, p["wg"][ex])) * _mm(nm, xe, p["wu"][ex])
        out = _mm(nm, hid, p["wd"][ex]) * gates[pair][:, None]
        y = y.index_add(0, tok, out)
    return y.view(b, s, d)


def _act(name: str) -> Callable:
    if name == "silu":
        return F.silu
    raise ValueError(f"activation {name!r}")


def _segsum(a):
    """a (..., T) → (..., T, T): Σ a[j+1..i] below the diagonal, -inf
    above it."""
    t = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~low, float("-inf"))


def ssd(x, dt, a, bm, cm, nm: Numerics):
    """The SSD recurrence in its chunked matrix form (Mamba-2's
    ``ssd_minimal``): x (B, L, H, P), dt (B, L, H), a (H,), bm and cm (B,
    L, N) → y (B, L, H, P)."""
    bsz, l, h, pd = x.shape
    q = min(SSD_CHUNK, l)
    pad = -l % q
    if pad:        # zero steps at the end: dt 0 leaves the state alone
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    c = (l + pad) // q
    xd = nm.q(x * dt[..., None]).view(bsz, c, q, h, pd)
    bm, cm = nm.q(bm).view(bsz, c, q, -1), nm.q(cm).view(bsz, c, q, -1)
    ad = (dt * a).view(bsz, c, q, h).permute(0, 3, 1, 2)      # (B, H, c, q)
    cum = torch.cumsum(ad, dim=-1)
    decay = torch.exp(_segsum(ad))                            # (B,H,c,q,q)
    cb = torch.einsum("bcln,bcsn->bcls", cm, bm)
    y = torch.einsum("bcls,bhcls,bcshp->bclhp", cb, decay, xd)
    to_end = torch.exp(cum[..., -1:] - cum)                   # (B,H,c,q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bm, to_end, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))  # (B,H,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", cm, states[:, :-1],
                         torch.exp(cum))
    return y.reshape(bsz, c * q, h, pd)[:, :l]


def mamba(p, cfg, x, nm: Numerics):
    """The Mamba-2 mixer of x (B, L, D) → (B, L, D)."""
    s = cfg["ssm"]
    b, l, d = x.shape
    di = s["expand"] * d
    n, pd, kw = s["state_dim"], s["head_dim"], s["conv_kernel"]
    h = di // pd
    zxbcdt = _mm(nm, x, p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, h], dim=-1)
    padded = F.pad(xbc, (0, 0, kw - 1, 0))
    xbc = F.silu(sum(padded[:, i:i + l] * p["conv_w"][i] for i in range(kw)))
    xs, bm, cm = xbc.split([di, n, n], dim=-1)
    xs = xs.reshape(b, l, h, pd)
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(xs, dt, -torch.exp(p["a_log"]), bm, cm, nm)
    y = (y + xs * p["skip_d"][:, None]).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg["norm_eps"])
    return _mm(nm, y, p["out_proj"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def layer_count(params) -> int:
    return params["blocks"]["b0"]["ln1"].shape[0]


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def block(p, cfg, h, nm: Numerics):
    """One layer on the residual stream h."""
    x = rmsnorm(h, p["ln1"], cfg["norm_eps"])
    if cfg["family"] == "ssm":
        return h + mamba(p["mamba"], cfg, x, nm)
    h = h + attention(p["attn"], cfg, x, nm)
    x = rmsnorm(h, p["ln2"], cfg["norm_eps"])
    return h + moe(p["moe"], cfg, x, nm)


def forward(params, cfg, tokens, nm: Numerics = F32):
    """The final-norm hidden states (B, S, D) of ``tokens`` (B, S), each
    layer recomputed in the backward."""
    h = params["embed"][tokens.long()]
    for i in range(layer_count(params)):
        p = _layer(params["blocks"]["b0"], i)
        h = torch.utils.checkpoint.checkpoint(
            lambda pp, hh: block(pp, cfg, hh, nm), p, h, use_reentrant=False)
    return rmsnorm(h, params["final_norm"], cfg["norm_eps"])


def head(params) -> torch.Tensor:
    """The (D, padded vocabulary) head: ``lm_head``, or ``embedᵀ`` where
    the configuration ties them."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def logits_of(params, cfg, h, nm: Numerics = F32):
    """Logits of hidden states h (..., D) over the vocabulary (padding
    cut off)."""
    return _mm(nm, h, head(params))[..., :cfg["vocab_size"]]


def loss(params, cfg, tokens, labels, nm: Numerics = F32):
    """Mean next-token cross-entropy over every position (B, S), the
    logits taken a block of positions at a time."""
    h = forward(params, cfg, tokens, nm)
    b, s, d = h.shape
    flat, gold = h.reshape(b * s, d), labels.reshape(-1).long()
    total = h.new_zeros(())
    for r0 in range(0, b * s, 4096):
        lg = torch.utils.checkpoint.checkpoint(
            lambda hh: logits_of(params, cfg, hh, nm), flat[r0:r0 + 4096],
            use_reentrant=False)
        total = total + F.cross_entropy(lg, gold[r0:r0 + 4096],
                                        reduction="sum")
    return total / (b * s)
