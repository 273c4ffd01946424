"""The weights of a configuration, drawn from the run's seed on the device,
or from the configuration's own ``weights_seed`` where it has one.

One tree in the port's parameter layout serves both sides: the program
takes it as it is (its leaves in the configuration's storage types), the
reference takes the same values in float32.  Drawing twice from one seed
on one device gives the same values, so the reference draws its copy
after the program's state is freed.

A configuration whose routing follows its weights (a mixture of experts:
which experts the frequent tokens pick, and so how many choices the
capacity drops) states ``weights_seed``: then every seed runs the same
weights, and the run's seed draws only its batches.

The draw is a few large calls: one ``randn`` per storage type for every
normal leaf, scaled leaf by leaf in place, and one ``rand`` for the
Mamba-2 leaves that Mamba-2 draws uniformly (``A`` in [1, 16], ``dt`` in
[0.001, 0.1] on a log scale, stored as ``a_log`` and the inverse softplus
``dt_bias``).
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def padded_vocab(cfg: dict) -> int:
    m = cfg.get("pad_vocab_to", 0)
    v = cfg["vocab_size"]
    return -(-v // m) * m if m else v


def layout(cfg: dict) -> list:
    """``[(path, shape, storage dtype name, init)]`` of every leaf; init is
    ``("normal", scale)``, ``("ones",)``, ``("a_log",)`` or
    ``("dt_bias",)``."""
    n, d = cfg["num_layers"], cfg["d_model"]
    dt = cfg["dtype"]
    f32 = set(cfg.get("f32_leaves", ()))

    def kind(name):
        return "float32" if name in f32 else dt

    out = []

    def leaf(path, shape, init):
        out.append((path, tuple(shape), kind(path[-1]), init))

    blk = ("blocks", "b0")
    leaf(blk + ("ln1",), (n, d), ("ones",))
    if cfg["family"] == "moe":
        h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        e, f = cfg["moe"]["num_experts"], cfg["d_ff"]
        a = blk + ("attn",)
        leaf(a + ("wq",), (n, d, h * hd), ("normal", d ** -0.5))
        leaf(a + ("wk",), (n, d, hkv * hd), ("normal", d ** -0.5))
        leaf(a + ("wv",), (n, d, hkv * hd), ("normal", d ** -0.5))
        leaf(a + ("wo",), (n, h * hd, d), ("normal", (h * hd) ** -0.5))
        leaf(blk + ("ln2",), (n, d), ("ones",))
        m = blk + ("moe",)
        leaf(m + ("router",), (n, d, e), ("normal", d ** -0.5))
        leaf(m + ("wu",), (n, e, d, f), ("normal", d ** -0.5))
        leaf(m + ("wg",), (n, e, d, f), ("normal", d ** -0.5))
        leaf(m + ("wd",), (n, e, f, d), ("normal", f ** -0.5))
    elif cfg["family"] == "ssm":
        s = cfg["ssm"]
        di = s["expand"] * d
        h = di // s["head_dim"]
        conv = di + 2 * s["state_dim"]
        m = blk + ("mamba",)
        leaf(m + ("in_proj",), (n, d, di + conv + h), ("normal", d ** -0.5))
        leaf(m + ("conv_w",), (n, s["conv_kernel"], conv), ("normal", 0.5))
        leaf(m + ("a_log",), (n, h), ("a_log",))
        leaf(m + ("dt_bias",), (n, h), ("dt_bias",))
        leaf(m + ("skip_d",), (n, h), ("ones",))
        leaf(m + ("norm_w",), (n, di), ("ones",))
        leaf(m + ("out_proj",), (n, di, d), ("normal", di ** -0.5))
    else:
        raise ValueError(f"family {cfg['family']!r} has no layout")
    v = padded_vocab(cfg)
    leaf(("final_norm",), (d,), ("ones",))
    if not cfg.get("tie_embeddings"):
        leaf(("lm_head",), (d, v), ("normal", d ** -0.5))
    leaf(("embed",), (v, d), ("normal", 0.02))
    return out


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def draw(cfg: dict, seed: int, device, *, as_float32: bool = False) -> dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` (or from
    ``cfg["weights_seed"]``) on ``device``: leaves in their storage types,
    or with ``as_float32`` the same values in float32 (the reference's
    copy)."""
    device = torch.device(device)
    seed = cfg.get("weights_seed", seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = layout(cfg)
    tree: dict = {}
    normal = [x for x in leaves if x[3][0] == "normal"]
    for dtype in sorted({x[2] for x in normal}):
        group = [x for x in normal if x[2] == dtype]
        flat = torch.randn(sum(math.prod(x[1]) for x in group),
                           generator=gen, device=device,
                           dtype=_DTYPES[dtype])
        at = 0
        for path, shape, _, init in group:
            size = math.prod(shape)
            _put(tree, path, flat[at:at + size].view(shape).mul_(init[1]))
            at += size
    uniform = [x for x in leaves if x[3][0] in ("a_log", "dt_bias")]
    if uniform:
        u = torch.rand(sum(math.prod(x[1]) for x in uniform), generator=gen,
                       device=device, dtype=torch.float32)
        at = 0
        for path, shape, dtype, init in uniform:
            size = math.prod(shape)
            r = u[at:at + size].view(shape)
            at += size
            if init[0] == "a_log":
                val = torch.log(1.0 + 15.0 * r)
            else:
                lo, hi = math.log(1e-3), math.log(1e-1)
                dtv = torch.exp(lo + (hi - lo) * r)
                val = dtv + torch.log(-torch.expm1(-dtv))
            _put(tree, path, val.to(_DTYPES[dtype]))
    for path, shape, dtype, init in leaves:
        if init[0] == "ones":
            _put(tree, path, torch.ones(shape, dtype=_DTYPES[dtype],
                                        device=device))
    if as_float32:
        tree = _map(lambda t: t.float(), tree)
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves_with_path(tree: dict, prefix=()):
    """``[(path, tensor)]`` in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves_with_path(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out
