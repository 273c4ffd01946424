"""ONNX importer: trained NCHW models onto the NHWC builder frontend.

Dependency-optional by construction: when the ``onnx`` package is
installed it does the parsing (``onnx.load`` + ``numpy_helper``);
otherwise a minimal vendored **protobuf wire-format decoder** reads the
node / initializer / value-info subset this importer needs directly
from the ``.onnx`` bytes — the container ships no ONNX, and a model zoo
frontend that silently required one would never run in CI.

Supported operator subset (everything the builder can express):
``Conv`` (groups=1, dilation 1, any uniform stride, SAME_UPPER / VALID
/ equivalent explicit pads), ``BatchNormalization`` (inference form,
folded into the producing Conv's weights and bias at import),
``GlobalAveragePool`` (square maps, via the AVG epilogue's DIV exit
path), ``Relu``, ``MaxPool`` / ``AveragePool`` (square VALID windows),
``Gemm`` (α=1, transA=0, β∈{0,1}), ``Add``, ``Flatten`` (axis=1).
Anything else raises :class:`OnnxImportError` naming the node and the
constraint.  Per-channel biases (Conv B, Gemm C) import as rank-1
broadcast epilogue operands — C resident elements, not the H·W·C
materialization a full-tensor constant would cost the resource model.

Padding convention: the streaming frame splits a SAME deficit
*end-heavy* (``begin = total // 2``), which is exactly ONNX
``SAME_UPPER`` — including the asymmetric split of even kernels.
``SAME_LOWER`` is only accepted where its begin-heavy split coincides
(symmetric totals); an asymmetric SAME_LOWER conv is *rejected*, never
silently mis-executed with the mirrored frame.

Layout: ONNX is NCHW, the streaming kernels are NHWC.  Every
layout-sensitive op is imported *faithfully* inside an explicit
transpose sandwich (NCHW→NHWC → op → NHWC→NCHW) so each imported value
keeps its ONNX shape; the layout-canonicalization pass
(``repro_torch.passes.layout``) then cancels the interior pairs and folds the
final NHWC→NCHW transpose into the classifier head's flatten, leaving
only the graph-boundary transposes the external NCHW contract requires
(for a classifier, exactly one: the input bridge; a model with a
rank-4 NCHW output also keeps the output-side bridge).  Imported weights are re-laid out at import time
(OIHW→HWIO for convs, ``transB`` for Gemm) and returned as
``ImportedModel.params`` keyed by the DFG's constant value names —
``CompiledArtifact.run(params=...)`` executes the trained network.

Resource modeling note: streams are costed at the paper's int8 PTQ
width (``elem_bits=8``) regardless of the ONNX tensor dtype; numerics
at run time follow the imported arrays' dtype.
"""
from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass, field

import numpy as np

from .base import ImportedModel

NCHW2NHWC = (0, 2, 3, 1)
NHWC2NCHW = (0, 3, 1, 2)

SUPPORTED_OPS = ("Conv", "BatchNormalization", "GlobalAveragePool", "Relu",
                 "MaxPool", "AveragePool", "Gemm", "Add", "Flatten")


class OnnxImportError(ValueError):
    """The model is malformed or uses something outside the subset."""


def _fail(msg: str) -> None:
    raise OnnxImportError(msg)


# ---------------------------------------------------------------------------
# Normalized model (produced by both parsing paths)
# ---------------------------------------------------------------------------


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    name: str
    inputs: list[tuple[str, tuple[int, ...]]]   # non-initializer inputs
    outputs: list[str]
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Vendored protobuf wire decoder (the no-`onnx` path)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(buf):
            _fail("truncated varint in protobuf stream")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            _fail("varint overflow in protobuf stream")


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield ``(field_number, wire_type, value)`` triples; length-
    delimited values are bytes, varints ints, fixed32/64 raw ints."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            if i + 8 > n:
                _fail("truncated fixed64")
            v = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            if i + ln > n:
                _fail("truncated length-delimited field")
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            if i + 4 > n:
                _fail("truncated fixed32")
            v = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            _fail(f"unsupported protobuf wire type {wt}")
        yield fno, wt, v


def _collect(buf: bytes) -> dict[int, list[tuple[int, object]]]:
    out: dict[int, list[tuple[int, object]]] = {}
    for fno, wt, v in _fields(buf):
        out.setdefault(fno, []).append((wt, v))
    return out


def _ints(entries: list[tuple[int, object]]) -> list[int]:
    """A repeated int64 field: scalar entries or packed blocks."""
    vals: list[int] = []
    for wt, v in entries:
        if wt == 0:
            vals.append(_signed64(v))
        elif wt == 2:
            i = 0
            while i < len(v):
                x, i = _varint(v, i)
                vals.append(_signed64(x))
        else:
            _fail("unexpected wire type for repeated int field")
    return vals


def _one_int(fields: dict, fno: int, default: int = 0) -> int:
    entries = fields.get(fno)
    if not entries:
        return default
    return _ints(entries)[-1]


def _one_bytes(fields: dict, fno: int, default: bytes = b"") -> bytes:
    entries = fields.get(fno)
    if not entries:
        return default
    wt, v = entries[-1]
    if wt != 2:
        _fail(f"field {fno}: expected length-delimited, got wire type {wt}")
    return v


def _one_str(fields: dict, fno: int, default: str = "") -> str:
    b = _one_bytes(fields, fno, default.encode())
    return b.decode("utf-8", "replace")


def _one_float(fields: dict, fno: int, default: float = 0.0) -> float:
    entries = fields.get(fno)
    if not entries:
        return default
    wt, v = entries[-1]
    if wt != 5:
        _fail(f"field {fno}: expected fixed32 float, got wire type {wt}")
    return struct.unpack("<f", int(v).to_bytes(4, "little"))[0]


#: TensorProto.DataType → numpy (the subset a CNN checkpoint uses)
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 11: np.float64}


def _tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = _collect(buf)
    dims = tuple(_ints(f.get(1, [])))
    dtype_code = _one_int(f, 2, 1)
    name = _one_str(f, 8)
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        _fail(f"initializer {name!r}: unsupported data_type {dtype_code}")
    raw = _one_bytes(f, 9)
    if raw:
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
    elif np_dtype is np.float32 and 4 in f:
        vals = []
        for wt, v in f[4]:
            if wt == 2:
                vals.extend(np.frombuffer(v, dtype="<f4").tolist())
            elif wt == 5:
                vals.append(struct.unpack(
                    "<f", int(v).to_bytes(4, "little"))[0])
        arr = np.asarray(vals, dtype=np.float32)
    elif 7 in f:
        arr = np.asarray(_ints(f[7]), dtype=np.int64)
    elif 5 in f:
        arr = np.asarray(_ints(f[5]), dtype=np.int32).astype(np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    want = int(np.prod(dims)) if dims else 1
    if arr.size != want:
        _fail(f"initializer {name!r}: {arr.size} elements for dims {dims}")
    return name, arr.reshape(dims).astype(np_dtype, copy=False)


def _value_info(buf: bytes) -> tuple[str, tuple[int, ...]]:
    f = _collect(buf)
    name = _one_str(f, 1)
    tensor_type = _collect(_one_bytes(_collect(_one_bytes(f, 2)), 1))
    shape_msg = _one_bytes(tensor_type, 2)
    dims: list[int] = []
    for wt, v in _collect(shape_msg).get(1, []):
        if wt != 2:
            continue
        d = _collect(v)  # type: ignore[arg-type]
        if 2 in d and 1 not in d:
            _fail(f"graph input {name!r}: symbolic dimension "
                  f"{_one_str(d, 2)!r} — static shapes required")
        dims.append(_one_int(d, 1))
    return name, tuple(dims)


def _value_name(buf: bytes) -> str:
    """Just a ValueInfoProto's name — graph *outputs* only need names,
    and parsing their (possibly symbolic, shape-inferred) type info
    would reject models the `onnx`-package path accepts."""
    return _one_str(_collect(buf), 1)


def _attribute(buf: bytes) -> tuple[str, object]:
    f = _collect(buf)
    name = _one_str(f, 1)
    if 8 in f:                    # ints
        return name, _ints(f[8])
    if 3 in f:                    # i
        return name, _one_int(f, 3)
    if 2 in f:                    # f
        return name, _one_float(f, 2)
    if 4 in f:                    # s
        return name, _one_bytes(f, 4).decode("utf-8", "replace")
    if 5 in f:                    # t (tensor)
        return name, _tensor(_one_bytes(f, 5))[1]
    return name, None


def _node(buf: bytes) -> OnnxNode:
    f = _collect(buf)
    return OnnxNode(
        op_type=_one_str(f, 4),
        name=_one_str(f, 3),
        inputs=[v.decode("utf-8", "replace")
                for wt, v in f.get(1, []) if wt == 2],
        outputs=[v.decode("utf-8", "replace")
                 for wt, v in f.get(2, []) if wt == 2],
        attrs=dict(_attribute(v) for wt, v in f.get(5, []) if wt == 2),
    )


def decode_wire(data: bytes) -> OnnxGraph:
    """Parse ModelProto bytes with the vendored decoder."""
    model = _collect(data)
    graph_buf = _one_bytes(model, 7)
    if not graph_buf:
        _fail("no GraphProto in the model (is this an .onnx file?)")
    g = _collect(graph_buf)
    inits = dict(_tensor(v) for wt, v in g.get(5, []) if wt == 2)
    inputs = [_value_info(v) for wt, v in g.get(11, []) if wt == 2]
    outputs = [_value_name(v) for wt, v in g.get(12, []) if wt == 2]
    nodes = [_node(v) for wt, v in g.get(1, []) if wt == 2]
    return OnnxGraph(
        name=_one_str(g, 2, "onnx_model"),
        inputs=[(n, s) for n, s in inputs if n not in inits],
        outputs=outputs,
        nodes=nodes,
        initializers=inits,
    )


# ---------------------------------------------------------------------------
# `onnx` package path (used when installed)
# ---------------------------------------------------------------------------


def _decode_with_onnx_pkg(data: bytes) -> OnnxGraph:  # pragma: no cover
    import onnx
    from onnx import numpy_helper

    model = onnx.load_model_from_string(data)
    g = model.graph
    inits = {t.name: numpy_helper.to_array(t) for t in g.initializer}
    inputs = []
    for vi in g.input:
        if vi.name in inits:
            continue
        dims = []
        for d in vi.type.tensor_type.shape.dim:
            if d.dim_param:
                _fail(f"graph input {vi.name!r}: symbolic dimension "
                      f"{d.dim_param!r} — static shapes required")
            dims.append(d.dim_value)
        inputs.append((vi.name, tuple(dims)))
    nodes = []
    for n in g.node:
        attrs: dict[str, object] = {}
        for a in n.attribute:
            if a.type == onnx.AttributeProto.INT:
                attrs[a.name] = a.i
            elif a.type == onnx.AttributeProto.INTS:
                attrs[a.name] = list(a.ints)
            elif a.type == onnx.AttributeProto.FLOAT:
                attrs[a.name] = a.f
            elif a.type == onnx.AttributeProto.STRING:
                attrs[a.name] = a.s.decode("utf-8", "replace")
            elif a.type == onnx.AttributeProto.TENSOR:
                attrs[a.name] = numpy_helper.to_array(a.t)
        nodes.append(OnnxNode(n.op_type, n.name, list(n.input),
                              list(n.output), attrs))
    return OnnxGraph(g.name or "onnx_model", inputs,
                     [o.name for o in g.output], nodes, inits)


# ---------------------------------------------------------------------------
# Mapping onto the builder
# ---------------------------------------------------------------------------


class _Names:
    """ONNX value names → unique IR-safe identifiers."""

    def __init__(self) -> None:
        self.used: set[str] = set()

    def __call__(self, onnx_name: str, fallback: str = "v") -> str:
        base = re.sub(r"[^0-9A-Za-z_]", "_", onnx_name) or fallback
        if base[0].isdigit():
            base = f"v_{base}"
        name = base
        i = 1
        while name in self.used:
            name = f"{base}_{i}"
            i += 1
        self.used.add(name)
        return name


def _square(node: OnnxNode, vals: list[int], what: str) -> int:
    if len(vals) != 2 or vals[0] != vals[1]:
        _fail(f"{node.op_type} {node.name!r}: non-square {what} {vals}")
    return vals[0]


def _uniform_stride(node: OnnxNode, default: int = 1) -> int:
    strides = node.attrs.get("strides")
    if strides is None:
        return default
    if len(set(strides)) != 1:
        _fail(f"{node.op_type} {node.name!r}: non-uniform strides {strides}")
    return int(strides[0])


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """End-heavy (begin, end) SAME split for extent ``n`` — the ONNX
    SAME_UPPER convention, and the split the builder/streaming frame
    applies for ``padding="SAME"``."""
    out = -(-n // s)
    total = max(0, s * (out - 1) + k - n)
    return total // 2, total - total // 2


def _resolve_conv_padding(node: OnnxNode, kernel: int, stride: int,
                          h_in: int, w_in: int) -> str:
    """Map (auto_pad, pads, kernel, stride, input extents) onto the
    builder's ``"SAME"`` / ``"VALID"`` vocabulary, or reject by name.

    The streaming frame splits a SAME deficit end-heavy — exactly ONNX
    SAME_UPPER, *including* the asymmetric split of even kernels.
    SAME_LOWER pads begin-heavy, so it is only accepted where the two
    splits coincide (symmetric totals); anything else is rejected
    rather than silently executed with a mirrored window.  Explicit
    pads are accepted when they are all-zero (VALID) or equal the
    SAME_UPPER frame for the actual input extents.
    """
    auto = node.attrs.get("auto_pad", "NOTSET") or "NOTSET"
    pads = [int(p) for p in (node.attrs.get("pads") or [])]
    if auto not in ("NOTSET", "VALID", "SAME_UPPER", "SAME_LOWER"):
        _fail(f"Conv {node.name!r}: unknown auto_pad {auto!r}")
    if auto != "NOTSET" and any(pads):
        _fail(f"Conv {node.name!r}: auto_pad={auto!r} with explicit "
              f"pads={pads} — the ONNX spec forbids setting both")
    if auto == "VALID":
        return "VALID"
    same_h = _same_pads(h_in, kernel, stride)
    same_w = _same_pads(w_in, kernel, stride)
    if auto == "SAME_UPPER":
        return "SAME"
    if auto == "SAME_LOWER":
        if same_h[0] != same_h[1] or same_w[0] != same_w[1]:
            _fail(f"Conv {node.name!r}: auto_pad=SAME_LOWER needs a "
                  f"begin-heavy pad split, but kernel {kernel} stride "
                  f"{stride} on a {h_in}x{w_in} input pads asymmetrically "
                  f"(H {same_h}, W {same_w}) — the streaming frame is "
                  "end-heavy (SAME_UPPER); rejecting rather than "
                  "mis-placing the window")
        return "SAME"
    if not pads:
        return "VALID"
    if len(pads) != 4:
        _fail(f"Conv {node.name!r}: pads {pads} must have 4 entries "
              "(top, left, bottom, right)")
    if not any(pads):
        return "VALID"
    want = [same_h[0], same_w[0], same_h[1], same_w[1]]
    if pads == want:
        return "SAME"
    _fail(f"Conv {node.name!r}: explicit pads {pads} are neither zero "
          f"(VALID) nor the SAME_UPPER frame {want} for kernel {kernel} "
          f"stride {stride} on a {h_in}x{w_in} input — arbitrary padding "
          "does not map onto the streaming conv")
    raise AssertionError("unreachable")


def _check_no_padding(node: OnnxNode) -> None:
    auto = node.attrs.get("auto_pad", "NOTSET") or "NOTSET"
    pads = node.attrs.get("pads")
    if auto == "VALID" or auto == "NOTSET":
        if pads and any(pads):
            _fail(f"{node.op_type} {node.name!r}: padded pooling is not "
                  f"supported (pads={pads})")
        return
    _fail(f"{node.op_type} {node.name!r}: auto_pad={auto!r} pooling is "
          "not supported")


def _bn_cast_back(arr: np.ndarray, dtype: np.dtype, node: OnnxNode,
                  what: str) -> np.ndarray:
    """Return the float64 fold result ``arr`` in the Conv's parameter
    dtype.  Float dtypes just cast; integer (PTQ) dtypes require the
    fold to be *exactly* representable — anything fractional or out of
    range would need a requantization step this importer does not
    perform, so it is rejected by name instead of silently rounded."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return np.ascontiguousarray(arr.astype(dtype))
    r = np.rint(arr)
    info = np.iinfo(dtype)
    if (not np.array_equal(r, arr) or arr.min() < info.min
            or arr.max() > info.max):
        _fail(f"BatchNormalization {node.name!r}: folded {what} is not "
              f"exactly representable in the Conv's {dtype.name} "
              "parameters — integer (PTQ) batch-norm folding needs "
              "requantization, which is out of scope")
    return np.ascontiguousarray(r.astype(dtype))


def _fold_batchnorm(og: OnnxGraph) -> None:
    """Fold every inference-mode BatchNormalization into the Conv that
    feeds it, in place:  with ``s = scale / sqrt(var + eps)``,

        W'[o, :, :, :] = W[o, :, :, :] * s[o]
        b'             = (b - mean) * s + B

    so ``BN(conv(x, W) + b) == conv(x, W') + b'`` exactly.  The BN node
    disappears and the Conv keeps (or gains) a bias input.  A BN that
    cannot fold — not fed by a Conv, Conv output shared or a graph
    output, training-mode outputs, non-initializer statistics — raises
    :class:`OnnxImportError` naming the obstacle.
    """
    consumers: dict[str, int] = {}
    for n in og.nodes:
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1
    conv_of = {n.outputs[0]: n for n in og.nodes
               if n.op_type == "Conv" and n.outputs}
    kept: list[OnnxNode] = []
    fresh = 0
    for node in og.nodes:
        if node.op_type != "BatchNormalization":
            kept.append(node)
            continue
        if len(node.outputs) != 1:
            _fail(f"BatchNormalization {node.name!r}: training-mode "
                  f"outputs {node.outputs[1:]} are unsupported")
        if node.attrs.get("training_mode", 0):
            _fail(f"BatchNormalization {node.name!r}: training_mode=1 "
                  "is unsupported")
        if node.attrs.get("spatial", 1) != 1:
            _fail(f"BatchNormalization {node.name!r}: spatial=0 (per-"
                  "element statistics) is unsupported")
        if len(node.inputs) != 5:
            _fail(f"BatchNormalization {node.name!r}: expected X, scale, "
                  "B, mean, var")
        conv = conv_of.get(node.inputs[0])
        if conv is None:
            _fail(f"BatchNormalization {node.name!r}: only folds into an "
                  f"immediately preceding Conv, but {node.inputs[0]!r} is "
                  "not a Conv output")
        if consumers.get(conv.outputs[0], 0) != 1 \
                or conv.outputs[0] in og.outputs:
            _fail(f"BatchNormalization {node.name!r}: Conv output "
                  f"{conv.outputs[0]!r} has other consumers or is a graph "
                  "output — cannot fold")
        stats = []
        for vn in node.inputs[1:]:
            arr = og.initializers.get(vn)
            if arr is None:
                _fail(f"BatchNormalization {node.name!r}: {vn!r} must be "
                      "an initializer")
            stats.append(np.asarray(arr, dtype=np.float64).reshape(-1))
        scale, shift, mean, var = stats
        w = og.initializers.get(conv.inputs[1])
        if w is None or w.ndim != 4:
            _fail(f"BatchNormalization {node.name!r}: Conv weight "
                  f"{conv.inputs[1]!r} must be a rank-4 initializer")
        cout = int(w.shape[0])
        if any(p.shape[0] != cout for p in stats):
            _fail(f"BatchNormalization {node.name!r}: statistics arity "
                  f"{[p.shape[0] for p in stats]} != Conv channels {cout}")
        eps = float(node.attrs.get("epsilon", 1e-5))
        s = scale / np.sqrt(var + eps)
        w_f = np.asarray(w, dtype=np.float64) * s[:, None, None, None]
        if len(conv.inputs) == 3:
            b_arr = og.initializers.get(conv.inputs[2])
            if b_arr is None:
                _fail(f"BatchNormalization {node.name!r}: Conv bias "
                      f"{conv.inputs[2]!r} must be an initializer")
            b0 = np.asarray(b_arr, dtype=np.float64).reshape(-1)
        else:
            b0 = np.zeros(cout, dtype=np.float64)
        b_f = (b0 - mean) * s + shift
        bias_dtype = (np.dtype(np.int32)
                      if np.issubdtype(w.dtype, np.integer) else w.dtype)
        fresh += 1
        wn = f"{conv.inputs[1]}.bnfold{fresh}"
        bn = f"{node.inputs[2]}.bnfold{fresh}"
        og.initializers[wn] = _bn_cast_back(w_f, w.dtype, node, "weight")
        og.initializers[bn] = _bn_cast_back(b_f, bias_dtype, node, "bias")
        conv.inputs = [conv.inputs[0], wn, bn]
        conv.outputs = [node.outputs[0]]
    og.nodes = kept


def _to_builder(og: OnnxGraph, model_name: str) -> ImportedModel:
    from repro_torch.api.builder import FrontendError, Graph, TensorRef

    g = Graph(model_name)
    names = _Names()
    refs: dict[str, TensorRef] = {}
    params: dict[str, np.ndarray] = {}

    def ref(node: OnnxNode, vname: str) -> TensorRef:
        if vname not in refs:
            _fail(f"{node.op_type} {node.name!r}: input {vname!r} is "
                  "neither a graph input, an initializer-backed constant, "
                  "nor an earlier node's output")
        return refs[vname]

    def bind_const(onnx_name: str, arr: np.ndarray) -> TensorRef:
        nm = names(onnx_name, "k")
        c = g.constant(arr.shape, name=nm)
        params[nm] = np.ascontiguousarray(arr)
        return c

    def weight_name(onnx_name: str) -> str:
        return names(onnx_name, "w")

    def handle_conv(node: OnnxNode) -> None:
        if len(node.inputs) not in (2, 3):
            _fail(f"Conv {node.name!r}: expected X, W[, B]")
        xn, wn = node.inputs[:2]
        w = og.initializers.get(wn)
        if w is None:
            _fail(f"Conv {node.name!r}: weight {wn!r} must be an "
                  "initializer")
        if w.ndim != 4:
            _fail(f"Conv {node.name!r}: weight rank {w.ndim} != 4")
        if node.attrs.get("group", 1) != 1:
            _fail(f"Conv {node.name!r}: grouped convs are unsupported "
                  f"(group={node.attrs['group']})")
        dil = node.attrs.get("dilations")
        if dil and any(d != 1 for d in dil):
            _fail(f"Conv {node.name!r}: dilations {dil} are unsupported")
        kernel = _square(node, list(w.shape[2:]), "kernel")
        ks = node.attrs.get("kernel_shape")
        if ks and list(ks) != [kernel, kernel]:
            _fail(f"Conv {node.name!r}: kernel_shape {ks} != weight "
                  f"kernel {kernel}")
        stride = _uniform_stride(node)
        x = ref(node, xn)
        if x.rank != 4:
            _fail(f"Conv {node.name!r}: input rank {x.rank} != 4 (NCHW)")
        padding = _resolve_conv_padding(node, kernel, stride,
                                        int(x.shape[2]), int(x.shape[3]))
        h = g.transpose(x, NCHW2NHWC)
        wname = weight_name(wn)
        h = g.conv2d(h, int(w.shape[0]), kernel=kernel, stride=stride,
                     padding=padding, weight=wname)
        params[wname] = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
        if len(node.inputs) == 3:
            b = og.initializers.get(node.inputs[2])
            if b is None:
                _fail(f"Conv {node.name!r}: bias {node.inputs[2]!r} must "
                      "be an initializer")
            if b.size != int(w.shape[0]):
                _fail(f"Conv {node.name!r}: bias has {b.size} elements, "
                      f"expected {int(w.shape[0])}")
            # rank-1 (C,) constant: the builder routes this through the
            # broadcast add, so it fuses as a C-element epilogue operand
            # instead of a materialized H*W*C tensor
            h = g.add(h, bind_const(node.inputs[2], b.reshape(-1)))
        refs[node.outputs[0]] = g.transpose(h, NHWC2NCHW)

    def handle_pool(node: OnnxNode) -> None:
        ks = node.attrs.get("kernel_shape")
        if not ks:
            _fail(f"{node.op_type} {node.name!r}: missing required "
                  "attribute 'kernel_shape'")
        window = _square(node, list(ks), "kernel_shape")
        stride = _uniform_stride(node, default=1)
        _check_no_padding(node)
        if node.attrs.get("ceil_mode", 0):
            _fail(f"{node.op_type} {node.name!r}: ceil_mode pooling is "
                  "unsupported")
        x = ref(node, node.inputs[0])
        if x.rank != 4:
            _fail(f"{node.op_type} {node.name!r}: input rank {x.rank} != 4")
        h = g.transpose(x, NCHW2NHWC)
        pool = g.max_pool if node.op_type == "MaxPool" else g.avg_pool
        h = pool(h, window, stride)
        refs[node.outputs[0]] = g.transpose(h, NHWC2NCHW)

    def handle_gemm(node: OnnxNode) -> None:
        if len(node.inputs) not in (2, 3):
            _fail(f"Gemm {node.name!r}: expected A, B[, C]")
        alpha = node.attrs.get("alpha", 1.0)
        beta = node.attrs.get("beta", 1.0)
        if abs(float(alpha) - 1.0) > 1e-6 or node.attrs.get("transA", 0):
            _fail(f"Gemm {node.name!r}: alpha={alpha} transA="
                  f"{node.attrs.get('transA', 0)} — only alpha=1, "
                  "transA=0 are supported")
        b = og.initializers.get(node.inputs[1])
        if b is None or b.ndim != 2:
            _fail(f"Gemm {node.name!r}: B must be a rank-2 initializer")
        w = b.T if node.attrs.get("transB", 0) else b
        x = ref(node, node.inputs[0])
        if x.rank != 2:
            _fail(f"Gemm {node.name!r}: input rank {x.rank} != 2 — "
                  "Flatten before the classifier head")
        wname = weight_name(node.inputs[1])
        h = g.dense(x, int(w.shape[1]), weight=wname)
        params[wname] = np.ascontiguousarray(w)
        if len(node.inputs) == 3 and abs(float(beta)) > 1e-6:
            if abs(float(beta) - 1.0) > 1e-6:
                _fail(f"Gemm {node.name!r}: beta={beta} — only 0 or 1")
            c = og.initializers.get(node.inputs[2])
            if c is None:
                _fail(f"Gemm {node.name!r}: C must be an initializer")
            if c.size != int(w.shape[1]):
                _fail(f"Gemm {node.name!r}: C has {c.size} elements — "
                      f"only a per-unit bias of {int(w.shape[1])} is "
                      "supported")
            h = g.add(h, bind_const(node.inputs[2], c.reshape(-1)))
        refs[node.outputs[0]] = h

    def handle_add(node: OnnxNode) -> None:
        a, b = node.inputs
        if a in og.initializers and b in og.initializers:
            _fail(f"Add {node.name!r}: constant-folding two initializers "
                  "is out of scope")
        if b in og.initializers or a in og.initializers:
            act, kn = (a, b) if b in og.initializers else (b, a)
            x = ref(node, act)
            arr = np.broadcast_to(og.initializers[kn], x.shape)
            refs[node.outputs[0]] = g.add(x, bind_const(kn, arr))
            return
        refs[node.outputs[0]] = g.add(ref(node, a), ref(node, b))

    def handle_global_pool(node: OnnxNode) -> None:
        x = ref(node, node.inputs[0])
        if x.rank != 4:
            _fail(f"GlobalAveragePool {node.name!r}: input rank "
                  f"{x.rank} != 4")
        hh, ww = int(x.shape[2]), int(x.shape[3])
        if hh != ww:
            _fail(f"GlobalAveragePool {node.name!r}: non-square map "
                  f"{hh}x{ww} — the square AVG window cannot cover it")
        h = g.transpose(x, NCHW2NHWC)
        h = g.avg_pool(h, hh, hh)
        refs[node.outputs[0]] = g.transpose(h, NHWC2NCHW)

    def handle_flatten(node: OnnxNode) -> None:
        if node.attrs.get("axis", 1) != 1:
            _fail(f"Flatten {node.name!r}: only axis=1 is supported "
                  f"(axis={node.attrs.get('axis')})")
        x = ref(node, node.inputs[0])
        if x.rank == 2:
            refs[node.outputs[0]] = x  # already flat — a pure alias
            return
        refs[node.outputs[0]] = g.flatten(x)

    handlers = {
        "Conv": handle_conv,
        "Relu": lambda n: refs.__setitem__(
            n.outputs[0], g.relu(ref(n, n.inputs[0]))
        ),
        "MaxPool": handle_pool,
        "AveragePool": handle_pool,
        "GlobalAveragePool": handle_global_pool,
        "Gemm": handle_gemm,
        "Add": handle_add,
        "Flatten": handle_flatten,
    }

    try:
        for vname, shape in og.inputs:
            if not shape or any(int(s) <= 0 for s in shape):
                _fail(f"graph input {vname!r}: non-static shape {shape}")
            refs[vname] = g.input(shape, name=names(vname, "x"))
        for node in og.nodes:
            handler = handlers.get(node.op_type)
            if handler is None:
                _fail(
                    f"unsupported op {node.op_type!r} (node {node.name!r}) "
                    f"— this importer speaks {SUPPORTED_OPS}"
                )
            handler(node)
        if not og.outputs:
            _fail("model has no graph outputs")
        for o in og.outputs:
            if o not in refs:
                _fail(f"graph output {o!r} is not produced by any node")
            g.output(refs[o])
        dfg = g.build()
    except FrontendError as e:
        raise OnnxImportError(f"{model_name}: {e}") from e
    except ValueError as e:
        if isinstance(e, OnnxImportError):
            raise
        raise OnnxImportError(f"{model_name}: {e}") from e
    return ImportedModel(model_name, dfg, params, source="onnx")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def have_onnx_package() -> bool:
    try:  # pragma: no cover - depends on the environment
        import onnx  # noqa: F401

        return True
    except ImportError:
        return False


def load_onnx(source, *, name: str | None = None) -> ImportedModel:
    """Import an ONNX model — a path to a ``.onnx`` file or raw model
    bytes — into an :class:`ImportedModel`."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
        default_name = "onnx_model"
    else:
        with open(source, "rb") as f:
            data = f.read()
        default_name = os.path.splitext(os.path.basename(source))[0]
    try:
        og = (
            _decode_with_onnx_pkg(data) if have_onnx_package()
            else decode_wire(data)
        )
    except OnnxImportError as e:
        # decode runs before the graph name exists — name the error
        # after the file (or the caller-supplied name) so a truncated /
        # corrupt protobuf points at its source
        raise OnnxImportError(f"{name or default_name}: {e}") from e
    model_name = name or re.sub(r"[^0-9A-Za-z_]", "_",
                                og.name if og.name != "onnx_model"
                                else default_name) or "onnx_model"
    try:
        _fold_batchnorm(og)
    except OnnxImportError as e:
        raise OnnxImportError(f"{model_name}: {e}") from e
    return _to_builder(og, model_name)
