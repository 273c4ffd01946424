"""Portable JSON "model cards": a self-contained graph interchange format.

A model card is a JSON document that round-trips any *pre-pass* builder
graph — inputs, a flat layer list (conv2d / pools / dense / relu /
activation / add / transpose / flatten / bare constants), outputs, and
optionally the weights (base64 raw bytes) — with **node-for-node
fidelity**: ``import_card(export_card(g))`` rebuilds a DFG that compares
dataclass-equal to ``g`` (``tests/test_modelcard.py`` pins this as a
property over random builder graphs).

The guarantee is enforced, not hoped for: :func:`export_card` re-imports
its own output in memory and diffs the reconstruction against the
source graph before returning, so a graph the schema cannot express
fails loudly at export time (fused epilogues, exotic maps) instead of
producing a lossy card.

Cards are the zoo's storage format (``repro_torch.frontends.zoo``), the CLI's
``python -m repro_torch compile model.json`` input, and the stable on-disk
form for shipping models between machines without pickling IR
internals.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.analysis import KernelClass, classify_kernel, reorder_spec
from repro_torch.core.ir import DFG, GenericOp, PayloadKind

from .base import ImportedModel

FORMAT = "ming-modelcard"
SCHEMA_VERSION = 1

#: ops a v1 card can express (the error message vocabulary)
CARD_OPS = (
    "conv2d", "max_pool", "avg_pool", "dense", "relu", "activation",
    "add", "transpose", "flatten", "constant",
)


class ModelCardError(ValueError):
    """The card is malformed, or the graph is not expressible as one."""


def _fail(msg: str) -> None:
    raise ModelCardError(msg)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# Export: DFG -> card dict
# ---------------------------------------------------------------------------


def _node_record(dfg: DFG, op: GenericOp) -> dict:
    """One layer record for ``op`` — or a loud error naming what the
    schema cannot express."""
    if op.epilogue:
        _fail(
            f"{dfg.name}/{op.name}: fused epilogues are not expressible in "
            "a model card — export the pre-pass graph"
        )
    spec = reorder_spec(op)
    if spec is not None:
        kind, arg = spec
        if kind == "transpose":
            return {"op": "transpose", "name": op.name,
                    "input": op.inputs[0], "perm": list(arg),
                    "out": op.output}
        return {"op": "flatten", "name": op.name, "input": op.inputs[0],
                "order": list(arg), "out": op.output}
    info = classify_kernel(op)
    if info.kernel_class == KernelClass.SLIDING_WINDOW:
        if op.payload == PayloadKind.MAC and op.n_dims == 7:
            _require(info.dilation == 1,
                     f"{op.name}: dilated convs are not expressible (v1)")
            stream = [i for i in op.inputs if not dfg.values[i].is_constant]
            const = [i for i in op.inputs if dfg.values[i].is_constant]
            _require(len(stream) == 1 and len(const) == 1,
                     f"{op.name}: conv needs 1 stream + 1 const input")
            kh, kw = op.dim_sizes[4], op.dim_sizes[5]
            _require(kh == kw, f"{op.name}: non-square kernel {kh}x{kw}")
            rec = {"op": "conv2d", "name": op.name, "input": stream[0],
                   "filters": op.dim_sizes[3], "kernel": kh,
                   "stride": info.stride, "weight": const[0],
                   "out": op.output}
            # VALID convs: the output extent is the tell (SAME is always
            # ceil(h/s)); the key is omitted for SAME so older cards
            # stay byte-identical
            h_in = dfg.values[stream[0]].shape[1]
            if op.dim_sizes[1] != -(-h_in // info.stride):
                rec["padding"] = "VALID"
            return rec
        if op.payload in (PayloadKind.MAX, PayloadKind.AVG) and op.n_dims == 6:
            kh, kw = op.dim_sizes[4], op.dim_sizes[5]
            _require(kh == kw, f"{op.name}: non-square pool {kh}x{kw}")
            name = "max_pool" if op.payload == PayloadKind.MAX else "avg_pool"
            return {"op": name, "name": op.name, "input": op.inputs[0],
                    "window": kh, "stride": info.stride, "out": op.output}
        _fail(f"{op.name}: unsupported sliding-window shape")
    if info.kernel_class == KernelClass.REGULAR_REDUCTION:
        _require(
            op.payload == PayloadKind.MAC and op.n_dims == 3
            and len(op.inputs) == 2
            and dfg.values[op.inputs[1]].is_constant,
            f"{op.name}: only dense (matmul with constant rhs) reductions "
            "are expressible",
        )
        return {"op": "dense", "name": op.name, "input": op.inputs[0],
                "units": op.dim_sizes[1], "weight": op.inputs[1],
                "out": op.output}
    # PURE_PARALLEL with identity maps — or the per-channel broadcast
    # bias add (ident, last-dim, ident), whose rank-1 constant operand
    # re-derives the broadcast on import (builder ``add``)
    if not all(m.is_identity() for m in op.indexing_maps):
        is_bias = (
            len(op.inputs) == 2
            and op.payload == PayloadKind.ADD
            and op.indexing_maps[0].is_identity()
            and op.indexing_maps[2].is_identity()
            and len(op.indexing_maps[1].results) == 1
            and op.indexing_maps[1].results[0].is_single_dim()
            and op.indexing_maps[1].results[0].terms[0] == (op.n_dims - 1, 1)
            and dfg.values[op.inputs[1]].is_constant
        )
        _require(is_bias, f"{op.name}: non-identity elementwise maps")
        return {"op": "add", "name": op.name, "a": op.inputs[0],
                "b": op.inputs[1], "out": op.output}
    if len(op.inputs) == 1:
        if op.payload == PayloadKind.RELU:
            return {"op": "relu", "name": op.name, "input": op.inputs[0],
                    "out": op.output}
        _require(op.payload != PayloadKind.IDENTITY,
                 f"{op.name}: bare identity wires are not expressible — "
                 "canonicalize first")
        return {"op": "activation", "kind": op.payload.value,
                "name": op.name, "input": op.inputs[0], "out": op.output}
    if len(op.inputs) == 2 and op.payload == PayloadKind.ADD:
        return {"op": "add", "name": op.name, "a": op.inputs[0],
                "b": op.inputs[1], "out": op.output}
    _fail(f"{op.name}: {len(op.inputs)}-ary {op.payload.value} is not "
          "expressible in a model card")


def export_card(
    graph,
    *,
    params: Optional[Mapping[str, np.ndarray]] = None,
) -> dict:
    """Serialize a builder graph (DFG, or anything with ``.build()``)
    into a card dict.  ``params`` optionally embeds weights (base64) for
    the graph's constant values.

    The export is *verified*: the card is re-imported in memory and the
    reconstruction compared node-for-node against the source before the
    dict is returned.
    """
    dfg = graph.build() if hasattr(graph, "build") else graph
    if not isinstance(dfg, DFG):
        raise TypeError(
            f"export_card needs a DFG or a builder with .build(), got "
            f"{type(graph).__name__}"
        )
    layers: list[dict] = []
    # constants created implicitly by conv/dense records
    created = set()
    for op in dfg.nodes:
        rec = _node_record(dfg, op)
        if rec["op"] in ("conv2d", "dense"):
            created.add(rec["weight"])
        # any other constant operand needs an explicit record first
        for v in op.inputs:
            if dfg.values[v].is_constant and v not in created:
                cv = dfg.values[v]
                layers.append({"op": "constant", "name": v,
                               "shape": list(cv.shape),
                               "elem_bits": cv.elem_bits})
                created.add(v)
        layers.append(rec)
    card = {
        "format": FORMAT,
        "version": SCHEMA_VERSION,
        "name": dfg.name,
        "inputs": [
            {"name": n, "shape": list(dfg.values[n].shape),
             "elem_bits": dfg.values[n].elem_bits}
            for n in dfg.graph_inputs
        ],
        "layers": layers,
        "outputs": list(dfg.graph_outputs),
    }
    if params:
        consts = {n for n, v in dfg.values.items() if v.is_constant}
        blob = {}
        for name, arr in params.items():
            _require(name in consts,
                     f"params[{name!r}] is not a constant of {dfg.name} "
                     f"(constants: {sorted(consts)})")
            a = np.asarray(arr)
            _require(tuple(a.shape) == dfg.values[name].shape,
                     f"params[{name!r}] shape {tuple(a.shape)} != value "
                     f"shape {dfg.values[name].shape}")
            blob[name] = {
                "dtype": str(a.dtype),
                "shape": list(a.shape),
                "data": base64.b64encode(np.ascontiguousarray(a).tobytes())
                        .decode("ascii"),
            }
        card["params"] = blob
    # the fidelity gate: what we wrote must rebuild the graph exactly
    rebuilt = _build_dfg(card)
    if rebuilt != dfg:
        _fail(
            f"{dfg.name}: card round-trip diverged from the source graph — "
            "the graph uses structure the v1 schema cannot express"
        )
    return card


# ---------------------------------------------------------------------------
# Import: card dict (or path) -> ImportedModel
# ---------------------------------------------------------------------------


def _validated(card: dict) -> dict:
    _require(isinstance(card, dict), "card must be a JSON object")
    _require(card.get("format") == FORMAT,
             f"not a {FORMAT} document (format={card.get('format')!r})")
    _require(card.get("version") == SCHEMA_VERSION,
             f"unsupported card version {card.get('version')!r} "
             f"(this reader speaks v{SCHEMA_VERSION})")
    _require(isinstance(card.get("name"), str) and card["name"],
             "card needs a non-empty string 'name'")
    _require(isinstance(card.get("inputs"), list) and card["inputs"],
             "card needs a non-empty 'inputs' list")
    _require(isinstance(card.get("layers"), list) and card["layers"],
             "card needs a non-empty 'layers' list")
    _require(isinstance(card.get("outputs"), list) and card["outputs"],
             "card needs a non-empty 'outputs' list")
    for i, rec in enumerate(card["layers"]):
        _require(isinstance(rec, dict) and "op" in rec,
                 f"layers[{i}] is not an op record")
        _require(rec["op"] in CARD_OPS,
                 f"layers[{i}]: unknown op {rec['op']!r} — "
                 f"one of {CARD_OPS}")
    return card


def _build_dfg(card: dict) -> DFG:
    from repro_torch.api.builder import FrontendError, Graph

    refs: dict[str, object] = {}

    def ref(rec: dict, key: str):
        name = rec.get(key)
        _require(isinstance(name, str) and name in refs,
                 f"{rec.get('name', rec['op'])}: {key}={name!r} does not "
                 "name an earlier value of the card")
        return refs[name]

    g = Graph(card["name"])
    try:
        for inp in card["inputs"]:
            refs[inp["name"]] = g.input(
                inp["shape"], name=inp["name"],
                elem_bits=inp.get("elem_bits", 8),
            )
        for rec in card["layers"]:
            op = rec["op"]
            if op == "constant":
                refs[rec["name"]] = g.constant(
                    rec["shape"], name=rec["name"],
                    elem_bits=rec.get("elem_bits", 8),
                )
            elif op == "conv2d":
                refs[rec["out"]] = g.conv2d(
                    ref(rec, "input"), rec["filters"],
                    kernel=rec.get("kernel", 3), stride=rec.get("stride", 1),
                    padding=rec.get("padding", "SAME"),
                    name=rec["name"], weight=rec["weight"], out=rec["out"],
                )
            elif op in ("max_pool", "avg_pool"):
                method = g.max_pool if op == "max_pool" else g.avg_pool
                refs[rec["out"]] = method(
                    ref(rec, "input"), rec.get("window", 2),
                    rec.get("stride"), name=rec["name"], out=rec["out"],
                )
            elif op == "dense":
                refs[rec["out"]] = g.dense(
                    ref(rec, "input"), rec["units"], name=rec["name"],
                    weight=rec["weight"], out=rec["out"],
                )
            elif op == "relu":
                refs[rec["out"]] = g.relu(
                    ref(rec, "input"), name=rec["name"], out=rec["out"],
                )
            elif op == "activation":
                try:
                    kind = PayloadKind(rec.get("kind"))
                except ValueError:
                    _fail(f"{rec['name']}: unknown activation kind "
                          f"{rec.get('kind')!r}")
                refs[rec["out"]] = g.activation(
                    ref(rec, "input"), kind, kind.value,
                    name=rec["name"], out=rec["out"],
                )
            elif op == "add":
                refs[rec["out"]] = g.add(
                    ref(rec, "a"), ref(rec, "b"),
                    name=rec["name"], out=rec["out"],
                )
            elif op == "transpose":
                refs[rec["out"]] = g.transpose(
                    ref(rec, "input"), rec["perm"],
                    name=rec["name"], out=rec["out"],
                )
            elif op == "flatten":
                refs[rec["out"]] = g.flatten(
                    ref(rec, "input"), order=rec.get("order"),
                    name=rec["name"], out=rec["out"],
                )
        for out in card["outputs"]:
            _require(out in refs,
                     f"output {out!r} does not name a value of the card")
            g.output(refs[out])
        return g.build()
    except FrontendError as e:
        raise ModelCardError(f"{card['name']}: {e}") from e
    except KeyError as e:
        raise ModelCardError(
            f"{card['name']}: layer record missing field {e}"
        ) from e


_DTYPES = {"int8", "uint8", "int16", "int32", "int64", "float32", "float64"}


def _decode_params(card: dict, dfg: DFG) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for name, blob in (card.get("params") or {}).items():
        _require(name in dfg.values and dfg.values[name].is_constant,
                 f"params[{name!r}] is not a constant of the card's graph")
        _require(isinstance(blob, dict) and {"dtype", "shape", "data"}
                 <= set(blob), f"params[{name!r}]: need dtype/shape/data")
        _require(blob["dtype"] in _DTYPES,
                 f"params[{name!r}]: unsupported dtype {blob['dtype']!r}")
        raw = base64.b64decode(blob["data"])
        arr = np.frombuffer(raw, dtype=np.dtype(blob["dtype"]))
        shape = tuple(int(s) for s in blob["shape"])
        _require(arr.size == int(np.prod(shape)) if shape else arr.size == 1,
                 f"params[{name!r}]: data length does not match shape "
                 f"{shape}")
        _require(shape == dfg.values[name].shape,
                 f"params[{name!r}]: shape {shape} != value shape "
                 f"{dfg.values[name].shape}")
        out[name] = arr.reshape(shape)
    return out


def import_card(card) -> ImportedModel:
    """Load a model card — a dict, a JSON string, or a path to a
    ``.json`` file — into an :class:`ImportedModel`."""
    if isinstance(card, (str, os.PathLike)):
        looks_inline = isinstance(card, str) and card.lstrip().startswith("{")
        if looks_inline and not os.path.exists(card):
            text = card  # a JSON document passed inline
            source = "inline card"
        else:
            # a path — let open() raise the natural FileNotFoundError
            # for typos instead of mis-reporting them as invalid JSON
            with open(card) as f:
                text = f.read()
            source = os.fspath(card)
        try:
            card = json.loads(text)
        except json.JSONDecodeError as e:
            _fail(f"{source}: not valid JSON: {e}")
    card = _validated(card)
    dfg = _build_dfg(card)
    params = _decode_params(card, dfg)
    return ImportedModel(card["name"], dfg, params, source="card")
