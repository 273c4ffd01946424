"""Mixture-of-Experts layer in PyTorch: top-k routing with
capacity-bounded scatter dispatch — the counterpart of
``src/repro/models/moe.py`` (GShard-style, no (tokens × E × C) dispatch
tensor).

The router runs in f32 (``router`` is stored in f32 whatever
``param_dtype`` is: ``lm.F32_LEAVES``).  What must equal the reference
bit for bit is the routing (:func:`route`):

* top-k breaks ties as ``lax.top_k`` does, the lower expert index first,
  and orders the k choices by falling logit.  ``torch.topk`` promises no
  order among ties, so the choices are the first k of a *stable*
  descending sort;
* the position of a ``(token, choice)`` in its expert's capacity buffer
  is the exclusive running count of earlier choices of that expert over
  the flattened ``(token, choice)`` order; a choice at or past the
  capacity is dropped (its contribution is 0; its slot reads
  ``cap - 1``, as in the reference).

Dispatch writes each kept choice's row to its unique ``(expert, pos)``
slot, one ``(N, D)`` scatter per choice; dropped choices go to a spare
row past the buffer that is never read, so no host synchronisation and
no accumulating scatter is needed.  The experts are three batched
products over E (``torch.bmm`` in ``param_dtype``; the reference's
``jnp.einsum``, outside any kernel), and the combine accumulates in f32
in the order ``kk = 0..k-1`` before casting back to ``x.dtype``.

On a data-parallel mesh each rank holds only its own rows of the batch
(``distributed.ctx.row_split``), where the reference's capacity and
positions are reckoned over the whole batch.  So the capacity comes from
the global token count, and each rank's positions are offset by the
choices of every expert on the ranks before it, in row order: one
all-gather of the per-expert counts (int32) over the data-parallel
group, then on every rank the same exclusive running sum over the
ranks.  A rank then keeps and drops exactly the pairs the reference
drops on the global batch.

Under autograd (training) the layer differentiates as it stands, to the
gradient the reference's ``jax.grad`` gives: the gates' cotangent flows
through ``softmax(vals[:, :k])`` and the stable sort's backward (a
scatter to the chosen experts' columns) into the f32 logits and so the
router; the positions and ``keep`` are integers and pass nothing.  A
dropped choice is weighted 0 in the combine, so its gate gets a zero
cotangent (the softmax still couples it to the kept gates of its token,
as in the reference).  The dispatch ``buf[dest] = xf`` passes each kept
row its slot's gradient (a gather; the spare row is never read, so a
dropped choice passes 0), and each combine gather accumulates its
weighted cotangent into its slot.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx, tp
from repro_torch.kernels import ref
from .layers import dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, *,
             stack: int | None = None) -> dict:
    """``router`` (D, E) in f32, ``wu`` / ``wg`` (E, D, F) and ``wd``
    (E, F, D) in ``param_dtype`` — the reference's layout and scales,
    drawn from ``gen``; ``stack`` prepends a layer axis."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: an MoE layer needs cfg.moe")
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    e = cfg.moe.num_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, stack=stack),
        "wu": dense_init(gen, (e, d, f), dt, scale=1.0 / math.sqrt(d),
                         stack=stack),
        "wd": dense_init(gen, (e, f, d), dt, scale=1.0 / math.sqrt(f),
                         stack=stack),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, (e, d, f), dt, scale=1.0 / math.sqrt(d),
                             stack=stack)
    return p


def expert_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``ceil(N·k·capacity_factor / E)`` padded to a
    multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(num_tokens * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(8, ((c + 7) // 8) * 8)


def global_tokens(n: int) -> int:
    """Tokens of the whole batch when this rank holds ``n`` of them
    (``n`` itself unless the rows are split across ranks)."""
    split = ctx.row_split()
    return n if split is None else n * split.count


def _earlier_ranks(onehot: torch.Tensor):
    """(E, 1) int32: the choices of each expert on the data-parallel
    ranks that hold earlier rows of the batch; ``None`` when the rows are
    not split.  Every rank runs the same ops, as the reference's one
    ``cumsum`` over the global tokens gives every device one program:
    the ranks' counts gathered into (R, E), their exclusive running sum
    over the ranks, and this rank's row of it."""
    split = ctx.row_split()
    if split is None or split.count == 1:
        return None
    counts = onehot.sum(dim=1, dtype=torch.int32)              # (E,)
    every = counts.new_empty((split.count, counts.shape[0]))   # (R, E)
    dist.all_gather_into_tensor(every.view(-1), counts, group=split.group)
    earlier = torch.cumsum(every, dim=0, dtype=torch.int32) - every
    return earlier[split.index][:, None]


def route(p: dict, cfg: ModelConfig, xf: torch.Tensor):
    """The routing of ``xf`` (N, D) → ``(gate_w (N, k) f32, gate_i (N, k),
    pos (N, k), keep (N, k) bool)``: the k experts of each token by
    falling router logit (ties: the lower index), their softmax weights,
    each choice's slot in its expert's buffer, and whether the slot lies
    inside the capacity — over the whole batch where the rows are split
    across ranks (:func:`global_tokens`)."""
    m = cfg.moe
    n = xf.shape[0]
    e, k = m.num_experts, m.top_k
    # f32 logits whatever the router's dtype (the reference's ``@``
    # promotes a bf16 router, as int8 weights dequantize it, to f32)
    logits = xf.float() @ p["router"].float()                  # (N, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_w = torch.softmax(vals[:, :k], dim=-1)
    gate_i = idx[:, :k]
    flat_i = gate_i.reshape(-1)                                # (N*k,)
    # the one-hot laid out (E, N*k), so that the running count is a scan
    # along the last axis (PyTorch's scan along a long leading axis takes
    # milliseconds on the card), and made by a scatter (F.one_hot checks
    # its range on the host: a synchronisation per layer)
    onehot = torch.zeros((e, n * k), dtype=torch.int32, device=xf.device)
    onehot.scatter_(0, flat_i[None], 1)                        # (E, N*k)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    earlier = _earlier_ranks(onehot)
    if earlier is not None:
        before = before + earlier
    pos = before.gather(0, flat_i[None])[0].reshape(n, k)      # exclusive
    keep = pos < expert_capacity(global_tokens(n), cfg)
    return gate_w, gate_i, pos, keep


def moe_layer(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): route, dispatch into (E, cap, D), the
    expert MLPs, combine.  In decode N = B, so the capacity is that of B
    tokens, as in the reference.

    With a ``ModelSplit`` installed that E divides, the expert leaves hold
    this rank's E/tp experts: routing is computed whole on every rank,
    the rank dispatches and combines only the choices of its experts, and
    the partial combine is summed over ``model`` in f32.  Under autograd
    a rank weights only its own choices, so the gradient reaching the
    gates — and through them the router and ``x`` — is a partial, though
    the router is replicated: ``x`` and the router leaf enter the layer
    through ``tp.enter``, which sums each of their gradients over
    ``model`` once."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    k = m.top_k
    split = tp.split_along(m.num_experts)
    x = tp.enter(x, split)
    p = dict(p, router=tp.enter(p["router"], split))
    e = p["wu"].shape[0]                                       # this rank's
    first = 0 if split is None else split.index * e
    cap = expert_capacity(global_tokens(n), cfg)

    xf = x.reshape(n, d)
    gate_w, gate_i, pos, keep = route(p, cfg, xf)
    mine = keep & (gate_i >= first) & (gate_i < first + e)
    safe_pos = torch.where(keep, pos, cap - 1)
    slot = (gate_i - first).clamp(0, e - 1) * cap + safe_pos   # (N, k)

    # dispatch: one (N, D) scatter per choice; a dropped choice (or one of
    # another rank's experts) lands on the spare row e·cap, which no
    # expert reads
    buf = x.new_zeros((e * cap + 1, d))
    spare = torch.full_like(slot, e * cap)
    dest = torch.where(mine, slot, spare)
    for kk in range(k):
        buf[dest[:, kk]] = xf
    experts_in = buf[: e * cap].view(e, cap, d)

    # expert MLPs, batched over E
    up = torch.bmm(experts_in, p["wu"])
    if cfg.gated_mlp:
        h = ref._act(cfg.act, torch.bmm(experts_in, p["wg"])) * up
    else:
        h = ref._act(cfg.act, up)
    out_buf = torch.bmm(h, p["wd"]).reshape(e * cap, d)        # (E·C, D)

    # combine: one (N, D) gather per choice, f32 accumulator
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for kk in range(k):
        picked = out_buf[slot[:, kk]]
        w = torch.where(mine[:, kk], gate_w[:, kk], 0.0)
        y = y + picked.float() * w[:, None]
    return tp.sum_partial(y, split).reshape(b, s, d).to(x.dtype)
