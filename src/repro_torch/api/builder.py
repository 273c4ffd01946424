"""Declarative layer-builder frontend: the one place CNN graphs are made.

Before this module every graph in the suite was hand-assembled
value-by-value (``Value`` + ``make_conv2d_op`` + manual shape
bookkeeping).  The builder replaces that with two combinator levels:

* :class:`Graph` — an imperative builder with one method per layer kind
  (``conv2d`` / ``relu`` / ``max_pool`` / ``avg_pool`` / ``dense`` /
  ``add`` / …).  Every method infers the output shape from its inputs,
  validates ranks/extents/channel counts, and registers the values and
  the :class:`~repro_torch.core.ir.GenericOp` in the underlying DFG.  Errors
  are :class:`FrontendError`\\ s that name the layer and say exactly
  which shape constraint broke.

* :class:`Sequential` — a declarative layer list (:class:`Conv2D`,
  :class:`ReLU`, :class:`MaxPool`, :class:`AvgPool`, :class:`Dense`,
  :class:`Residual`, …) compiled through a :class:`Graph`.  ``Residual``
  runs its body layers and adds the skip back in (the diamond the
  FIFO-depth sizing of Sec. IV-C exists for).

Naming is deterministic and matches the historical ``cnn_graphs``
convention (``conv{i}``/``w{i}``/``conv{i}_out``…) so the legacy
constructors are now thin wrappers over this module and the two
spellings produce *node-for-node identical* DFGs
(``tests/test_frontend.py`` pins that).  Every layer accepts
``name=``/``out=``/``weight=`` overrides for graphs whose historical
names predate the scheme (``feed_forward``'s ``h``/``y``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

from repro_torch.core.ir import (
    DFG,
    PayloadKind,
    Value,
    make_broadcast_binary_op,
    make_conv2d_op,
    make_elementwise_op,
    make_flatten_op,
    make_matmul_op,
    make_pool2d_op,
    make_transpose_op,
)


class FrontendError(ValueError):
    """A layer's shape/validity constraint failed at build time."""


@dataclass(frozen=True)
class TensorRef:
    """A symbolic tensor flowing through the builder (name + shape)."""

    name: str
    shape: tuple[int, ...]
    elem_bits: int = 8

    @property
    def rank(self) -> int:
        return len(self.shape)


def _fail(layer: str, msg: str) -> None:
    raise FrontendError(f"{layer}: {msg}")


class Graph:
    """Imperative graph builder over the GenericOp DFG.

    >>> g = Graph("net")
    >>> x = g.input((1, 32, 32, 3))
    >>> y = g.relu(g.conv2d(x, 16))
    >>> g.output(y)
    >>> dfg = g.build()
    """

    def __init__(self, name: str, *, elem_bits: int = 8) -> None:
        self.dfg = DFG(name)
        self.elem_bits = elem_bits
        self._counters: dict[str, int] = {}
        self._n_weights = 0

    # -- naming --------------------------------------------------------------

    def _next(self, kind: str, name: Optional[str]) -> str:
        """Per-kind node counter (``conv0``, ``relu1``, …); explicit
        names still advance the counter so later layers stay aligned
        with the legacy numbering."""
        i = self._counters.get(kind, 0)
        self._counters[kind] = i + 1
        return name if name is not None else f"{kind}{i}"

    def _next_weight(self, name: Optional[str]) -> str:
        i = self._n_weights
        self._n_weights += 1
        return name if name is not None else f"w{i}"

    def _ref(self, value_name: str) -> TensorRef:
        v = self.dfg.values[value_name]
        return TensorRef(v.name, v.shape, v.elem_bits)

    def _check(self, layer: str, x) -> TensorRef:
        if not isinstance(x, TensorRef):
            _fail(layer, f"expected a TensorRef input, got {type(x).__name__}")
        if x.name not in self.dfg.values:
            _fail(layer, f"input {x.name!r} is not a value of graph "
                         f"{self.dfg.name!r}")
        return x

    # -- graph boundary ------------------------------------------------------

    def input(self, shape: Sequence[int], name: str = "x",
              elem_bits: Optional[int] = None) -> TensorRef:
        if not shape or any(int(s) <= 0 for s in shape):
            _fail(f"input {name!r}", f"shape {tuple(shape)} must be "
                                     "non-empty with positive extents")
        bits = elem_bits if elem_bits is not None else self.elem_bits
        self.dfg.add_value(Value(name, tuple(int(s) for s in shape), bits))
        self.dfg.graph_inputs.append(name)
        return self._ref(name)

    def constant(self, shape: Sequence[int], name: Optional[str] = None,
                 elem_bits: Optional[int] = None) -> TensorRef:
        """An on-chip constant (weights/bias) — never streamed."""
        bits = elem_bits if elem_bits is not None else self.elem_bits
        vname = self._next_weight(name)
        self.dfg.add_value(
            Value(vname, tuple(int(s) for s in shape), bits, is_constant=True)
        )
        return self._ref(vname)

    def output(self, x: TensorRef) -> TensorRef:
        self._check("output", x)
        if x.name not in self.dfg.graph_outputs:
            self.dfg.graph_outputs.append(x.name)
        return x

    # -- layers --------------------------------------------------------------

    def conv2d(self, x: TensorRef, filters: int, kernel: int = 3,
               stride: int = 1, *, padding: str = "SAME",
               name: Optional[str] = None,
               weight: Optional[str] = None,
               out: Optional[str] = None) -> TensorRef:
        """NHWC conv2d.  ``padding="SAME"`` (output spatial extent
        ``ceil(h/s)``, deficit zero-padded end-heavy — ONNX SAME_UPPER)
        or ``"VALID"`` (no padding, ``(h - k)//s + 1``)."""
        nm = self._next("conv", name)
        self._check(nm, x)
        if x.rank != 4:
            _fail(nm, f"conv2d needs a rank-4 NHWC input, got rank "
                      f"{x.rank} (shape {x.shape})")
        if filters < 1 or kernel < 1 or stride < 1:
            _fail(nm, f"filters/kernel/stride must be >= 1, got "
                      f"({filters}, {kernel}, {stride})")
        if padding not in ("SAME", "VALID"):
            _fail(nm, f'padding must be "SAME" or "VALID", got {padding!r}')
        n, h, w, c_in = x.shape
        if padding == "VALID":
            if kernel > h or kernel > w:
                _fail(nm, f"VALID conv kernel {kernel} exceeds the spatial "
                          f"extents {h}x{w}")
            h_out = (h - kernel) // stride + 1
            w_out = (w - kernel) // stride + 1
        else:
            h_out = -(-h // stride)
            w_out = -(-w // stride)
        wref = self.constant((kernel, kernel, c_in, filters), weight,
                             elem_bits=x.elem_bits)
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(
            Value(oname, (n, h_out, w_out, filters), x.elem_bits)
        )
        self.dfg.add_node(
            make_conv2d_op(
                nm, x.name, wref.name, oname,
                n=n, h_out=h_out, w_out=w_out, c_out=filters,
                kh=kernel, kw=kernel, c_in=c_in, stride=stride,
                elem_bits=x.elem_bits,
            )
        )
        return self._ref(oname)

    def activation(self, x: TensorRef, kind: PayloadKind, prefix: str, *,
                   name: Optional[str] = None,
                   out: Optional[str] = None) -> TensorRef:
        nm = self._next(prefix, name)
        self._check(nm, x)
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(Value(oname, x.shape, x.elem_bits))
        self.dfg.add_node(
            make_elementwise_op(nm, [x.name], oname, x.shape, kind,
                                elem_bits=x.elem_bits)
        )
        return self._ref(oname)

    def relu(self, x: TensorRef, *, name: Optional[str] = None,
             out: Optional[str] = None) -> TensorRef:
        return self.activation(x, PayloadKind.RELU, "relu", name=name, out=out)

    def _pool(self, x: TensorRef, window: int, stride: Optional[int],
              payload: PayloadKind, *, name: Optional[str],
              out: Optional[str]) -> TensorRef:
        nm = self._next("pool", name)
        self._check(nm, x)
        if x.rank != 4:
            _fail(nm, f"pool needs a rank-4 NHWC input, got rank {x.rank} "
                      f"(shape {x.shape})")
        stride = window if stride is None else stride
        n, h, w, c = x.shape
        if window < 1 or stride < 1:
            _fail(nm, f"window/stride must be >= 1, got ({window}, {stride})")
        if window > h or window > w:
            _fail(nm, f"pool window {window} exceeds the spatial extents "
                      f"{h}x{w}")
        if (h - window) % stride or (w - window) % stride:
            _fail(nm, f"illegal pool window: {window}x{window}/stride "
                      f"{stride} does not tile the {h}x{w} input exactly "
                      "(VALID pooling needs (extent - window) % stride == 0)")
        h_out = (h - window) // stride + 1
        w_out = (w - window) // stride + 1
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(Value(oname, (n, h_out, w_out, c), x.elem_bits))
        self.dfg.add_node(
            make_pool2d_op(
                nm, x.name, oname,
                n=n, h_out=h_out, w_out=w_out, c=c, kh=window, kw=window,
                stride=stride, payload=payload, elem_bits=x.elem_bits,
            )
        )
        return self._ref(oname)

    def max_pool(self, x: TensorRef, window: int = 2,
                 stride: Optional[int] = None, *,
                 name: Optional[str] = None,
                 out: Optional[str] = None) -> TensorRef:
        return self._pool(x, window, stride, PayloadKind.MAX,
                          name=name, out=out)

    def avg_pool(self, x: TensorRef, window: int = 2,
                 stride: Optional[int] = None, *,
                 name: Optional[str] = None,
                 out: Optional[str] = None) -> TensorRef:
        """Average pool — ADD accumulation plus the DIV exit path (see
        ``repro_torch.kernels.ref.pool_reduce``)."""
        return self._pool(x, window, stride, PayloadKind.AVG,
                          name=name, out=out)

    def transpose(self, x: TensorRef, perm: Sequence[int], *,
                  name: Optional[str] = None,
                  out: Optional[str] = None) -> TensorRef:
        """Axis permutation (the NCHW↔NHWC bridge the ONNX importer
        inserts; ``repro_torch.passes.layout`` cancels interior pairs)."""
        nm = self._next("transpose", name)
        self._check(nm, x)
        p = tuple(int(i) for i in perm)
        if sorted(p) != list(range(x.rank)):
            _fail(nm, f"perm {p} is not a permutation of the input's "
                      f"{x.rank} axes (shape {x.shape})")
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(
            Value(oname, tuple(x.shape[i] for i in p), x.elem_bits)
        )
        self.dfg.add_node(
            make_transpose_op(nm, x.name, oname, in_shape=x.shape, perm=p,
                              elem_bits=x.elem_bits)
        )
        return self._ref(oname)

    def flatten(self, x: TensorRef, *, order: Optional[Sequence[int]] = None,
                name: Optional[str] = None,
                out: Optional[str] = None) -> TensorRef:
        """Collapse every non-batch axis into one feature axis.

        ``order`` linearizes the non-batch axes in that sequence
        (default ascending — row-major over the producer's layout);
        the classifier heads of imported models flatten through this
        before their first ``dense``."""
        nm = self._next("flatten", name)
        self._check(nm, x)
        if x.rank < 2:
            _fail(nm, f"flatten needs a rank >= 2 input, got rank {x.rank} "
                      f"(shape {x.shape})")
        o = tuple(int(i) for i in order) if order is not None else None
        if o is not None and sorted(o) != list(range(1, x.rank)):
            _fail(nm, f"order {o} is not a permutation of the non-batch "
                      f"axes 1..{x.rank - 1}")
        feat = 1
        for s in x.shape[1:]:
            feat *= s
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(Value(oname, (x.shape[0], feat), x.elem_bits))
        self.dfg.add_node(
            make_flatten_op(nm, x.name, oname, in_shape=x.shape, order=o,
                            elem_bits=x.elem_bits)
        )
        return self._ref(oname)

    def dense(self, x: TensorRef, units: int, *,
              name: Optional[str] = None, weight: Optional[str] = None,
              out: Optional[str] = None) -> TensorRef:
        nm = self._next("linear", name)
        self._check(nm, x)
        if x.rank != 2:
            _fail(nm, f"dense needs a rank-2 (batch, features) input, got "
                      f"rank {x.rank} (shape {x.shape})")
        if units < 1:
            _fail(nm, f"units must be >= 1, got {units}")
        batch, d_in = x.shape
        wref = self.constant((d_in, units), weight, elem_bits=x.elem_bits)
        oname = out if out is not None else f"{nm}_out"
        self.dfg.add_value(Value(oname, (batch, units), x.elem_bits))
        self.dfg.add_node(
            make_matmul_op(nm, x.name, wref.name, oname,
                           m=batch, k=d_in, n_out=units,
                           elem_bits=x.elem_bits)
        )
        return self._ref(oname)

    def add(self, a: TensorRef, b: TensorRef, *,
            name: Optional[str] = None,
            out: Optional[str] = None) -> TensorRef:
        nm = self._next("add", name)
        self._check(nm, a)
        self._check(nm, b)
        oname = out if out is not None else f"{nm}_out"
        if a.shape != b.shape:
            # per-channel bias: a rank-1 *constant* matching the last
            # axis broadcasts through the indexing maps (C elements of
            # const buffer, not H*W*C)
            if (
                b.rank == 1
                and b.shape[0] == a.shape[-1]
                and self.dfg.values[b.name].is_constant
            ):
                self.dfg.add_value(Value(oname, a.shape, a.elem_bits))
                self.dfg.add_node(
                    make_broadcast_binary_op(
                        nm, a.name, b.name, oname, a.shape,
                        PayloadKind.ADD, elem_bits=a.elem_bits,
                    )
                )
                return self._ref(oname)
            _fail(nm, f"operand shapes differ: {a.shape} vs {b.shape} "
                      "(residual adds need identical shapes — check the "
                      "body's channel count and pooling; a per-channel "
                      "bias must be a rank-1 constant matching the last "
                      "axis)")
        self.dfg.add_value(Value(oname, a.shape, a.elem_bits))
        self.dfg.add_node(
            make_elementwise_op(nm, [a.name, b.name], oname, a.shape,
                                PayloadKind.ADD, elem_bits=a.elem_bits)
        )
        return self._ref(oname)

    # -- finalize ------------------------------------------------------------

    def build(self) -> DFG:
        if not self.dfg.graph_outputs:
            _fail(self.dfg.name, "graph has no outputs — call output(...)")
        return self.dfg


# ---------------------------------------------------------------------------
# Declarative layer specs (the Sequential combinator level)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Conv2D:
    filters: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    name: Optional[str] = None
    weight: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.conv2d(x, self.filters, self.kernel, self.stride,
                        padding=self.padding, name=self.name,
                        weight=self.weight, out=self.out)


@dataclass(frozen=True)
class ReLU:
    name: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.relu(x, name=self.name, out=self.out)


@dataclass(frozen=True)
class Activation:
    kind: PayloadKind
    name: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        prefix = self.kind.value
        return g.activation(x, self.kind, prefix, name=self.name,
                            out=self.out)


@dataclass(frozen=True)
class MaxPool:
    window: int = 2
    stride: Optional[int] = None
    name: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.max_pool(x, self.window, self.stride, name=self.name,
                          out=self.out)


@dataclass(frozen=True)
class AvgPool:
    window: int = 2
    stride: Optional[int] = None
    name: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.avg_pool(x, self.window, self.stride, name=self.name,
                          out=self.out)


@dataclass(frozen=True)
class Dense:
    units: int
    name: Optional[str] = None
    weight: Optional[str] = None
    out: Optional[str] = None

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.dense(x, self.units, name=self.name, weight=self.weight,
                       out=self.out)


@dataclass(frozen=True)
class Transpose:
    perm: tuple
    name: Optional[str] = None
    out: Optional[str] = None

    def __init__(self, perm: Sequence[int], name: Optional[str] = None,
                 out: Optional[str] = None) -> None:
        object.__setattr__(self, "perm", tuple(perm))
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "out", out)

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.transpose(x, self.perm, name=self.name, out=self.out)


@dataclass(frozen=True)
class Flatten:
    order: Optional[tuple] = None
    name: Optional[str] = None
    out: Optional[str] = None

    def __init__(self, order: Optional[Sequence[int]] = None,
                 name: Optional[str] = None,
                 out: Optional[str] = None) -> None:
        object.__setattr__(self, "order",
                           tuple(order) if order is not None else None)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "out", out)

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        return g.flatten(x, order=self.order, name=self.name, out=self.out)


@dataclass(frozen=True)
class Residual:
    """``y = add(body(x), x)`` — the skip connection combinator."""

    body: tuple = ()
    name: Optional[str] = None
    out: Optional[str] = None

    def __init__(self, body: Sequence, name: Optional[str] = None,
                 out: Optional[str] = None) -> None:
        object.__setattr__(self, "body", tuple(body))
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "out", out)

    def apply(self, g: Graph, x: TensorRef) -> TensorRef:
        if not self.body:
            raise FrontendError(
                f"{g.dfg.name}: Residual needs at least one body layer "
                "(an empty body would silently compute x + x)"
            )
        cur = x
        for layer in self.body:
            cur = _apply_layer(g, layer, cur)
        return g.add(cur, x, name=self.name, out=self.out)


Layer = Union[Conv2D, ReLU, Activation, MaxPool, AvgPool, Dense, Residual,
              Transpose, Flatten]


def _apply_layer(g: Graph, layer, x: TensorRef) -> TensorRef:
    apply = getattr(layer, "apply", None)
    if apply is None:
        raise FrontendError(
            f"{g.dfg.name}: {layer!r} is not a layer (needs an "
            "apply(graph, x) method)"
        )
    return apply(g, x)


class Sequential:
    """A declarative chain of layers over one graph input.

    >>> net = Sequential(
    ...     [Conv2D(16), ReLU(), MaxPool(2)],
    ...     input_shape=(1, 32, 32, 3), name="conv_pool_32",
    ... )
    >>> dfg = net.build()

    ``build()`` is deterministic and cheap; repeated calls return fresh,
    structurally identical DFGs.
    """

    def __init__(self, layers: Sequence, *, input_shape: Sequence[int],
                 name: str = "model", input_name: str = "x",
                 elem_bits: int = 8) -> None:
        if not layers:
            raise FrontendError(f"{name}: Sequential needs at least one layer")
        self.layers = tuple(layers)
        self.input_shape = tuple(int(s) for s in input_shape)
        self.name = name
        self.input_name = input_name
        self.elem_bits = elem_bits

    def build(self) -> DFG:
        g = Graph(self.name, elem_bits=self.elem_bits)
        cur = g.input(self.input_shape, name=self.input_name)
        for layer in self.layers:
            cur = _apply_layer(g, layer, cur)
        g.output(cur)
        return g.build()
