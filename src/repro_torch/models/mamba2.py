"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), in
PyTorch: the counterpart of ``src/repro/models/mamba2.py``.

Both halves of the sequence mixer are streaming structures: the
depthwise causal conv keeps a ``K-1``-row line buffer over time, and the
SSD state ``(H, P, N)`` is an O(1)-per-step carry.  Decode carries
exactly (conv window, SSM state).

Prefill runs the chunked SSD scan through the hand-written SSD kernel
(``ops.mamba2_ssd``; its plain version, ``ref.ssd_chunked``, on a CPU
tensor) — where the reference calls ``ref.ssd_chunked`` directly, "the
algorithm the Pallas kernel implements".  Decode takes the O(1)
recurrent step ``ref.ssd_decode_step`` in plain PyTorch, as the
reference does.  Shapes, the f32 leaves (``F32_LEAVES``) and the places
where bf16 rounds follow the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from .layers import dense_init, rmsnorm

#: parameters the reference keeps in f32 whatever ``param_dtype`` is
#: (``src/repro/models/mamba2.py:37-39``)
F32_LEAVES = ("a_log", "dt_bias", "skip_d")


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *,
               stack: int | None = None) -> dict:
    """The reference's layout and scales (``A = -exp(a_log) = -1``, zero
    ``dt_bias``, unit ``skip_d``), drawn from ``gen``; ``stack``
    prepends a layer axis."""
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name}: a Mamba block needs cfg.ssm")
    d, dt_ = cfg.d_model, cfg.param_dtype
    di, h, cd = s.d_inner(d), s.num_heads(d), s.conv_dim(d)
    lead = () if stack is None else (stack,)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * s.state_dim + h), dt_,
                              stack=stack),
        "conv_w": dense_init(gen, (s.conv_kernel, cd), dt_, scale=0.5,
                             stack=stack),
        "a_log": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "skip_d": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones(lead + (di,), dtype=dt_, device=dev),
        "out_proj": dense_init(gen, (di, d), dt_, stack=stack),
    }


def pick_chunk(l: int, target: int) -> int:
    """Largest divisor of ``l`` that is ≤ ``target`` (SSD needs chunk | L)."""
    c = max(min(target, l), 1)
    while l % c:
        c -= 1
    return c


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, L, C), w (K, C): left-padded causal depthwise conv — K-1 rows
    of history, summed tap by tap in f32 and rounded once."""
    k = w.shape[0]
    l = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i: i + l].float() * w[i].float()
    return out.to(x.dtype)


def _conv_decode_step(x_t: torch.Tensor, conv_cache: torch.Tensor,
                      w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, C), conv_cache (B, K-1, C), w (K, C) → (output (B, C), the
    next line buffer)."""
    window = torch.cat([conv_cache, x_t[:, None]], dim=1)       # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return out.to(x_t.dtype), window[:, 1:]


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    n = s.state_dim
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    if dt.shape[-1] != s.num_heads(cfg.d_model):
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, want "
                         f"{s.num_heads(cfg.d_model)}")
    return z, xbc, dt


def _gate_out(p: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm and the output projection (``y`` already carries the
    skip term and the model's width)."""
    y = y.to(dtype)
    y = rmsnorm(y * F.silu(z.float()).to(dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_layer(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence forward (B, L, D) → (B, L, D).  With
    ``return_state`` also the decode caches ``{"conv": the last K-1 rows
    of the conv input (B, K-1, conv_dim), "ssm": the final SSD state (B, H,
    P, N) f32}`` — the reference's ``lm._mamba_forward`` — so prefill and
    the plain layer are one code path."""
    s = cfg.ssm
    b, l, d = x.shape
    di, h, n = s.d_inner(d), s.num_heads(d), s.state_dim

    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    conv_cache = xbc[:, -(s.conv_kernel - 1):, :]   # before the conv
    xbc = F.silu(_causal_depthwise_conv(xbc, p["conv_w"]))
    xs = xbc[..., :di].reshape(b, l, h, s.head_dim)
    b_mat = xbc[..., di: di + n]
    c_mat = xbc[..., di + n:]
    dtf = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ops.mamba2_ssd(xs, dtf, a, b_mat, c_mat,
                                  chunk=pick_chunk(l, s.chunk))
    y = y + xs.float() * p["skip_d"][None, None, :, None]
    out = _gate_out(p, cfg, y.reshape(b, l, di), z, x.dtype)
    if not return_state:
        return out
    return out, {"conv": conv_cache, "ssm": ssm_state}


def mamba_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,              # (B, 1, D)
    conv_cache: torch.Tensor,     # (B, K-1, conv_dim)
    ssm_state: torch.Tensor,      # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(1) recurrent step → (out (B, 1, D), new conv cache, new SSM
    state); the caches passed in are not modified."""
    s = cfg.ssm
    b = x.shape[0]
    d = cfg.d_model
    di, h, n = s.d_inner(d), s.num_heads(d), s.state_dim

    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    xbc, conv_cache = _conv_decode_step(xbc, conv_cache, p["conv_w"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, h, s.head_dim)
    b_t = xbc[..., di: di + n]
    c_t = xbc[..., di + n:]
    dtf = F.softplus(dt.float() + p["dt_bias"])                 # (B, H)
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ref.ssd_decode_step(ssm_state, xs, dtf, a, b_t, c_t)
    y = y + xs.float() * p["skip_d"][None, :, None]
    out = _gate_out(p, cfg, y.reshape(b, di), z, x.dtype)
    return out[:, None], conv_cache, ssm_state
