"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), in
PyTorch: the counterpart of ``src/repro/models/mamba2.py``.

Both halves of the sequence mixer are streaming structures: the
depthwise causal conv keeps a ``K-1``-row line buffer over time, and the
SSD state ``(H, P, N)`` is an O(1)-per-step carry.  Decode carries
exactly (conv window, SSM state).

Prefill runs the chunked SSD scan through the hand-written SSD kernel
(``ops.mamba2_ssd``; its plain version, ``ref.ssd_chunked``, on a CPU
tensor) — where the reference calls ``ref.ssd_chunked`` directly, "the
algorithm the Pallas kernel implements".  Training runs the same layer
under autograd: the scan's forward is that kernel, saving the state
entering each of its tiles, and its gradient the hand-written backward
kernel (``mamba2_ssd.SsdScan``: B4 and B4′ on the card, autograd through
``ref.ssd_chunked`` on the CPU, the reference's own gradient); the
depthwise conv's f32 tap loop, SiLU, softplus, the gated RMSNorm and the
f32 leaves differentiate through autograd as they are.  Decode takes the
O(1) recurrent step ``ref.ssd_decode_step`` in plain PyTorch, as the
reference does.  Shapes, the f32 leaves (``F32_LEAVES``) and the places
where bf16 rounds follow the reference.

Under a ``ModelSplit`` that divides the heads and the state
(:func:`mixer_leaves`) a rank computes its own heads, as the reference's
GSPMD computes a rank's columns: ``in_proj`` on its columns (each part
of ``z | x | B | C | dt`` cut into ``model`` blocks, which
``distributed/sharding.py`` lays out side by side), the depthwise conv on
its ``x | B | C`` columns, ``B`` and ``C`` — every head's — gathered
(``tp.gather_shared``: their gradient summed over the ranks), the SSD
kernel on H/count heads with its block of ``dt``, ``a`` and ``skip_d``,
the gated norm with its statistic summed over ``model``
(``tp.sum_shared``) and ``out_proj``'s rows as a partial, summed.  Its
caches are its own conv columns and SSM heads.  Elsewhere the leaves are
gathered along ``model`` (:func:`_whole_leaves`) and every rank computes
every column.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.kernels import ops, ref
from .layers import dense_init

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


def _local_widths(cfg: ModelConfig, split) -> tuple:
    """(d_inner, N, H) as this rank computes them: the whole with no
    split, else each over the split's count."""
    s, d = cfg.ssm, cfg.d_model
    c = 1 if split is None else split.count
    return s.d_inner(d) // c, s.state_dim // c, s.num_heads(d) // c


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor, split=None):
    """``z``, ``x | B | C`` and ``dt`` of this rank's ``in_proj``
    columns."""
    di, n, h = _local_widths(cfg, split)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, want "
                         f"{h}")
    return z, xbc, dt


def _whole_leaves(p: dict, cfg: ModelConfig) -> dict:
    """The mixer's leaves, gathered along ``model`` where the rules put
    them there — the fallback where ``model`` does not divide the heads
    or the state, so that every rank computes every column: a contiguous
    cut of ``in_proj``'s ``z | x | B | C | dt`` columns is not a set of
    heads, and the rules cut these leaves as they lie there."""
    s, d = cfg.ssm, cfg.d_model
    di = s.d_inner(d)
    width = 2 * di + 2 * s.state_dim + s.num_heads(d)
    return dict(p,
                in_proj=tp.gather(p["in_proj"], -1, tp.split_along(width)),
                conv_w=tp.gather(p["conv_w"], -1,
                                 tp.split_along(s.conv_dim(d))),
                out_proj=tp.gather(p["out_proj"], -2, tp.split_along(di)))


def mixer_leaves(p: dict, cfg: ModelConfig):
    """(leaves, split): the mixer's leaves as this rank computes with
    them.  Where the installed ``ModelSplit`` divides the heads and the
    state (``tp.mixer_split``), the rank's shards of ``in_proj``,
    ``conv_w`` and ``out_proj`` as they are, its block of the replicated
    per-head leaves and of ``norm_w`` (each entering through
    ``tp.enter``, so that its gradient is summed over ``model``), and the
    split; otherwise :func:`_whole_leaves` and ``None``."""
    split = tp.mixer_split(cfg)
    if split is None:
        return _whole_leaves(p, cfg), None
    own = {name: tp.own_block(tp.enter(p[name], split), -1, split)
           for name in ("a_log", "dt_bias", "skip_d", "norm_w")}
    return dict(p, **own), split


def _b_and_c(xbc: torch.Tensor, di: int, split):
    """``B`` and ``C`` over the whole state from this rank's ``x | B |
    C`` columns (``di`` of ``x``): under a split this rank's blocks of
    both, gathered in one collective (``tp.gather_shared``)."""
    if split is None:
        n = (xbc.shape[-1] - di) // 2
        return xbc[..., di: di + n], xbc[..., di + n:]
    bc = tp.gather_shared(xbc[..., di:], -1, split)
    bc = bc.unflatten(-1, (split.count, 2, -1))
    return bc[..., 0, :].flatten(-2), bc[..., 1, :].flatten(-2)


def _gated_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float, split,
                   width: int) -> torch.Tensor:
    """``layers.rmsnorm`` over ``width`` columns of which ``x`` holds this
    rank's: each rank's mean of squares weighted by its share of the
    columns and summed over the group in f32 (``tp.sum_shared``: each
    rank's output depends on every column, so the gradient is summed
    too); op for op ``rmsnorm`` with no split or one rank."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if split is not None:
        var = tp.sum_shared(var * (x.shape[-1] / width), split)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _gate_out(p: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype, split=None) -> torch.Tensor:
    """Gated RMSNorm and the output projection (``y`` already carries the
    skip term and this rank's ``d_inner`` columns), summed over the
    split."""
    y = y.to(dtype)
    y = _gated_rmsnorm(y * F.silu(z.float()).to(dtype), p["norm_w"],
                       cfg.norm_eps, split, cfg.ssm.d_inner(cfg.d_model))
    return tp.sum_partial(y @ p["out_proj"], split)


def mamba_layer(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence forward (B, L, D) → (B, L, D).  With
    ``return_state`` also the decode caches ``{"conv": the last K-1 rows
    of the conv input (B, K-1, conv_dim), "ssm": the final SSD state (B, H,
    P, N) f32}`` — the reference's ``lm._mamba_forward`` — so prefill and
    the plain layer are one code path.  Under a ``ModelSplit`` the layer
    computes this rank's heads (:func:`mixer_leaves`) and the caches hold
    its conv columns and heads; where it does not divide the heads and
    the state, the leaves are gathered whole and the caches hold every
    column."""
    p, split = mixer_leaves(p, cfg)
    s = cfg.ssm
    b, l, _ = x.shape
    di, _, h = _local_widths(cfg, split)

    x = tp.enter(x, split)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"], split)
    # before the conv; a copy, so that the cache does not hold the whole
    # (B, L, conv_dim) projection it is a view of
    conv_cache = xbc[:, -(s.conv_kernel - 1):, :].clone()
    xbc = F.silu(_causal_depthwise_conv(xbc, p["conv_w"]))
    xs = xbc[..., :di].reshape(b, l, h, s.head_dim)
    b_mat, c_mat = _b_and_c(xbc, di, split)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ops.mamba2_ssd(xs, dtf, a, b_mat, c_mat,
                                  chunk=pick_chunk(l, s.chunk))
    y = y + xs.float() * p["skip_d"][None, None, :, None]
    out = _gate_out(p, cfg, y.reshape(b, l, di), z, x.dtype, split)
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
    state); the caches passed in are not modified.  Under a
    ``ModelSplit`` the step computes this rank's heads
    (:func:`mixer_leaves`) on caches of its own conv columns and heads;
    where it does not divide the heads and the state, the leaves are
    gathered whole and the caches hold every column."""
    p, split = mixer_leaves(p, cfg)
    s = cfg.ssm
    b = x.shape[0]
    di, _, h = _local_widths(cfg, split)

    x = tp.enter(x[:, 0], split)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"], split)
    xbc, conv_cache = _conv_decode_step(xbc, conv_cache, p["conv_w"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, h, s.head_dim)
    b_t, c_t = _b_and_c(xbc, di, split)
    dtf = F.softplus(dt.float() + p["dt_bias"])                 # (B, H)
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ref.ssd_decode_step(ssm_state, xs, dtf, a, b_t, c_t)
    y = y + xs.float() * p["skip_d"][None, :, None]
    out = _gate_out(p, cfg, y.reshape(b, di), z, x.dtype, split)
    return out[:, None], conv_cache, ssm_state
