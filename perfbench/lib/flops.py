"""Model FLOPs for ``mfu`` and each hand-written kernel's work for its
roofline, from a configuration file and a unit's shape alone.

Model FLOPs of a unit (``mfu`` = their sum over the traced window / (the
window's seconds × 989 TFLOP/s, the bf16 data-sheet peak of an H100 SXM
at 700 W)):

* 2 FLOPs per multiply-add of every weight a token passes through: the
  attention's projections, the router and the ``top_k`` experts a token
  is routed to, the Mamba-2 projections and its depthwise conv; the head
  for every position in training, for the last position of a row in a
  prefill (the only logits a prefill makes); the embedding is a lookup
  and not counted;
* causal attention: the score and value products, 2 · 2 · head_dim FLOPs
  a head and visible (query, key) pair;
* the SSD's state products: 2 · 2 · P · N FLOPs a head and position (the
  state's update and its read-out), the recurrence's own work, which no
  tile changes;
* training counts each 3 times (the forward, then the backward's two
  products for every one of the forward's); remat's recompute is not
  counted, nor any work a kernel's tiles, the routing's drops or saved
  intermediates add or save.
"""
from __future__ import annotations

import torch

from . import work as W

BF16 = torch.bfloat16


def _weights_per_token(cfg: dict) -> int:
    """Multiply-adds of the weights one token passes through in one layer
    (the head apart)."""
    d = cfg["d_model"]
    if cfg["family"] == "moe":
        h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        m = cfg["moe"]
        attn = d * (h + 2 * hkv) * hd + h * hd * d
        experts = m["top_k"] * 3 * d * cfg["d_ff"]
        return attn + d * m["num_experts"] + experts
    if cfg["family"] == "ssm":
        s = cfg["ssm"]
        di = s["expand"] * d
        h = di // s["head_dim"]
        conv = di + 2 * s["state_dim"]
        return d * (di + conv + h) + s["conv_kernel"] * conv + di * d
    raise ValueError(f"family {cfg['family']!r}")


def _mixer_flops(cfg: dict, rows: int, seq: int) -> int:
    """The attention's products or the SSD's state products of one
    forward over (rows, seq)."""
    if cfg["family"] == "moe":
        pairs = W.visible_pairs(seq, seq, True, 0)
        return 4 * cfg["head_dim"] * cfg["num_heads"] * pairs * rows
    s = cfg["ssm"]
    h = s["expand"] * cfg["d_model"] // s["head_dim"]
    return 4 * s["head_dim"] * s["state_dim"] * h * rows * seq


def model_flops(cfg: dict, kind: str, rows: int, seq: int) -> float:
    """Model FLOPs of one train step (``kind`` ``train``) or one prefill
    of ``rows`` prompts of ``seq`` tokens."""
    layers = cfg["num_layers"]
    body = (2 * _weights_per_token(cfg) * rows * seq
            + _mixer_flops(cfg, rows, seq)) * layers
    head = 2 * cfg["d_model"] * cfg["vocab_size"]
    if kind == "train":
        return 3.0 * (body + head * rows * seq)
    return float(body + head * rows)


def kernel_work(cfg: dict, kernel: str, rows: int, seq: int) -> W.Work:
    """The work of one call of a hand-written kernel on ``rows`` rows of
    ``seq`` positions in the configuration's storage type."""
    if kernel in ("attn_fwd", "attn_bwd"):
        args = (rows, cfg["num_heads"], cfg["num_kv_heads"], seq, seq,
                cfg["head_dim"], True, 0, BF16)
        return (W.attention_work(*args) if kernel == "attn_fwd"
                else W.attention_bwd_work(*args))
    if kernel in ("ssd_fwd", "ssd_bwd"):
        s = cfg["ssm"]
        h = s["expand"] * cfg["d_model"] // s["head_dim"]
        args = (rows, seq, h, s["head_dim"], s["state_dim"], BF16)
        return (W.ssd_work(*args) if kernel == "ssd_fwd"
                else W.ssd_bwd_work(*args, state_grad=False))
    raise ValueError(f"kernel {kernel!r}")


def roofline(summary, cfg: dict, kernel: str, kind: str):
    """(share of the roofline in %, what bounds it) of ``kernel``'s calls
    in the traced ``kind`` units: the least time their work needs (each
    call's bound, summed) over the kernel's device time; None where the
    window has no such call."""
    units = [u for u in summary.units if u.kind == kind]
    calls = [(u.calls.get(kernel, 0), u) for u in units]
    if not units or not any(n for n, _ in calls):
        return None
    bound, total = 0.0, None
    for n, u in calls:
        if n:
            w = kernel_work(cfg, kernel, u.call_rows, u.seq)
            bound += n * w.bound_s()
            total = w.scale(n) if total is None else total + w.scale(n)
    spent = summary.class_s(kernel)
    if spent <= 0:
        return None
    return 100.0 * bound / spent, total.bound_by()


def mfu(summary, cfg: dict, kind: str):
    """The traced window's model FLOPs over its seconds at the bf16 peak,
    in %; None where it holds no ``kind`` unit."""
    units = [u for u in summary.units if u.kind == kind]
    if not units:
        return None
    flops = sum(model_flops(cfg, kind, u.rows, u.seq) for u in units)
    return 100.0 * flops / (summary.window_s * W.TENSOR_CORE_BF16_OPS_PER_S)
