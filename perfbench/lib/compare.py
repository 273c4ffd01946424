"""The numbers that decide ``correct``, each against its limit.

A training cell compares, against the reference's first steps from the
same weights and batches:

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer took it
  (clipped; the program's read from its first moment, ``mu / (1 - b1)``),
  by the worst leaf: the gap between the two norms over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of each leaf's change over the checked
  steps, leaves whose reference gradient is under a thousandth of the
  median leaf's left out (Adam moves them by round-off alone).

A leaf is a layer's slice of a stacked leaf, or a leaf that has no layer
axis.
"""
from __future__ import annotations

import math
import statistics


def leaf_norms(items) -> dict:
    """{leaf: norm} of ``[(path, tensor)]``: a tensor under ``blocks``
    holds one leaf a layer (its leading axis)."""
    out = {}
    for path, t in items:
        name = "/".join(path)
        t = t.detach().float()
        if path[0] == "blocks":
            for i, n in enumerate(t.flatten(1).norm(dim=1).tolist()):
                out[f"{name}[{i}]"] = n
        else:
            out[name] = t.norm().item()
    return out


def worst_norm_gap(got: dict, ref: dict, skip=()) -> tuple:
    """(the worst leaf's gap, its name): |‖got‖ - ‖ref‖| over the larger
    of ‖ref‖ and the median leaf's ‖ref‖."""
    med = statistics.median(ref.values())
    worst, where = 0.0, None
    for name, r in ref.items():
        if name in skip:
            continue
        g = got.get(name, float("nan"))
        scale = max(r, med)
        if not math.isfinite(g):
            gap = math.inf
        elif scale > 0:
            gap = abs(g - r) / scale
        else:
            gap = 0.0 if g == 0 else math.inf
        if not gap <= worst:
            worst, where = gap, name
    return worst, where


def quiet_leaves(grad: dict) -> set:
    """Leaves whose reference gradient is under a thousandth of the
    median leaf's."""
    med = statistics.median(grad.values())
    return {n for n, g in grad.items() if g < 1e-3 * med}


def train_numbers(got: dict, ref: dict) -> dict:
    """``got`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    loss = max((abs(g - r) / abs(r) if math.isfinite(g) else math.inf)
               for g, r in zip(got["losses"], ref["losses"]))
    if len(got["losses"]) != len(ref["losses"]):
        loss = math.inf
    grad, gw = worst_norm_gap(got["grad"], ref["grad"])
    quiet = quiet_leaves(ref["grad"])
    change, cw = worst_norm_gap(got["change"], ref["change"], skip=quiet)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "_where": {"grad_gap": gw, "change_gap": cw,
                       "quiet_leaves": sorted(quiet)}}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number present, finite and at most its
    limit; ``checks`` {name: {"value", "limit"}} in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits["limits"].items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
