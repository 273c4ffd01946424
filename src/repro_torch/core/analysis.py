"""MING kernel analysis (paper Sec. IV-A).

Faithful re-implementations of the paper's two structural analyses over
``linalg.generic``-like ops:

* **Algorithm 1 — sliding-window detection.**  A kernel is sliding-window
  iff some input indexing-map result can be written ``E = s*i_p + δ*i_r``
  with ``i_p`` parallel and ``i_r`` reduction; the coefficients are the
  stride ``s`` and dilation ``δ``.

* **Algorithm 2 — iterator classification** into the four sets that drive
  stream / line-buffer construction (Sec. IV-B):
  𝒫 parallel dims (output-stream shape), ℛ reduction dims (input-stream
  shape), 𝒪 original input dims (line-buffer axes), 𝒲 window dims
  (compute-window extent).

Both run in ``O(Σ|E|)`` over the inspected affine maps, matching the
paper's complexity claim.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from .ir import AffineExpr, GenericOp, IteratorType


class KernelClass(str, enum.Enum):
    PURE_PARALLEL = "pure_parallel"
    REGULAR_REDUCTION = "regular_reduction"
    SLIDING_WINDOW = "sliding_window"


@dataclass(frozen=True)
class SlidingWindowInfo:
    is_sliding_window: bool
    stride: int
    dilation: int


def detect_sliding_window(op: GenericOp) -> SlidingWindowInfo:
    """Paper Algorithm 1.

    Walk every result expression of every *input* indexing map; try to
    rewrite it as ``A + B`` where each term is ``iterator * const``.  If one
    iterator is parallel and the other reduction, the op slides: the
    parallel coefficient is the stride, the reduction coefficient the
    dilation.
    """
    # line 1: if all iterators are parallel -> (false, 0, 0)
    if all(t == IteratorType.PARALLEL for t in op.iterator_types):
        return SlidingWindowInfo(False, 0, 0)
    # lines 2-11: scan input maps
    for m in op.input_maps:
        for expr in m.results:
            # try to rewrite E as A + B with A=(i_a * c_a), B=(i_b * c_b)
            if len(expr.terms) != 2 or expr.const != 0:
                continue
            (i_a, c_a), (i_b, c_b) = expr.terms
            a_par = op.is_parallel_dim(i_a)
            b_par = op.is_parallel_dim(i_b)
            # line 6: one parallel, the other reduction
            if a_par != b_par:
                if a_par:
                    stride, dilation = c_a, c_b
                else:
                    stride, dilation = c_b, c_a
                if stride > 0 and dilation > 0:
                    return SlidingWindowInfo(True, stride, dilation)
    return SlidingWindowInfo(False, 0, 0)


@dataclass(frozen=True)
class IteratorClasses:
    """The four sets of paper Algorithm 2 (dims are loop-dim indices)."""

    parallel: tuple[int, ...]        # 𝒫 — define output-stream shape
    reduction: tuple[int, ...]       # ℛ — define input-stream shape
    original_input: tuple[AffineExpr, ...]  # 𝒪 — composite exprs -> line buffer
    window: tuple[int, ...]          # 𝒲 — compute-window extent


def classify_iterators(op: GenericOp) -> IteratorClasses:
    """Paper Algorithm 2 (verbatim structure).

    Input-map results that are single dims go to 𝒫 (parallel) or ℛ
    (reduction); composite results go to 𝒪.  Output-map results that are
    parallel but *not* already in 𝒫 are the window dims 𝒲.
    """
    P: list[int] = []
    R: list[int] = []
    O: list[AffineExpr] = []
    W: list[int] = []
    for m in op.input_maps:                       # line 2
        for expr in m.results:                    # line 3
            if expr.is_single_dim():              # line 4 IS_SINGLE_DIM
                (d, _), = expr.terms
                if op.is_parallel_dim(d):         # line 5
                    if d not in P:
                        P.append(d)
                else:                             # line 6
                    if d not in R:
                        R.append(d)
            else:                                 # line 8-9
                if expr not in O:
                    O.append(expr)
    for expr in op.output_map.results:            # line 13
        if expr.is_single_dim():
            (d, _), = expr.terms
            if op.is_parallel_dim(d) and d not in P:   # line 14
                W.append(d)
    return IteratorClasses(tuple(P), tuple(R), tuple(O), tuple(W))


@dataclass(frozen=True)
class KernelInfo:
    """Joint result of Alg. 1 + Alg. 2 plus the final classification
    (Sec. IV-A: pure parallel / regular reduction / sliding window)."""

    kernel_class: KernelClass
    stride: int
    dilation: int
    classes: IteratorClasses

    @property
    def window_extents_known(self) -> bool:
        return self.kernel_class == KernelClass.SLIDING_WINDOW


def einsum_spec(op: GenericOp) -> str:
    """``jnp.einsum`` subscript string for a regular reduction whose map
    results are all single dims (matmul and friends) — shared by the DFG
    interpreter and the per-group Pallas lowering so both execute the
    same contraction the maps describe."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    subs = []
    for m in op.indexing_maps:
        if not all(e.is_single_dim() for e in m.results):
            raise NotImplementedError(f"{op.name}: composite map in einsum path")
        subs.append("".join(letters[e.terms[0][0]] for e in m.results))
    return ",".join(subs[:-1]) + "->" + subs[-1]


def reorder_spec(
    op: GenericOp,
) -> tuple[str, tuple[int, ...]] | None:
    """Recognize pure data-movement ops from their maps alone.

    Returns ``("transpose", perm)`` for an axis permutation
    (:func:`repro_torch.core.ir.make_transpose_op`), ``("flatten", order)``
    for a mixed-radix linearization
    (:func:`repro_torch.core.ir.make_flatten_op` — ``order`` is the
    linearization order of the non-batch axes), or ``None`` for
    anything else.  Shared by the interpreter, the Pallas lowering, and
    the layout pass so all three agree on what a reorder op *is*
    without a payload flag.
    """
    from .ir import PayloadKind  # local: avoid widening module surface

    if (
        op.payload != PayloadKind.IDENTITY
        or len(op.inputs) != 1
        or any(t != IteratorType.PARALLEL for t in op.iterator_types)
    ):
        return None
    imap, omap = op.indexing_maps
    n = op.n_dims
    # transpose: identity output map, permuted single-dim input map
    if omap.is_identity() and all(e.is_single_dim() for e in imap.results):
        dims = tuple(e.terms[0][0] for e in imap.results)
        if len(imap.results) == n and sorted(dims) == list(range(n)):
            if imap.is_identity():
                return None  # plain wire, canonicalize's business
            # input axis k is mapped by loop dim dims[k]; the output
            # axis order is the inverse permutation
            perm = [0] * n
            for k, d in enumerate(dims):
                perm[d] = k
            return ("transpose", tuple(perm))
    # flatten: identity input map, (d0, Σ stride_ax·d_ax) output map
    if (
        imap.is_identity()
        and len(omap.results) == 2
        and omap.results[0] == AffineExpr.dim(0)
        and omap.results[1].const == 0
    ):
        terms = dict(omap.results[1].terms)
        if set(terms) != set(range(1, n)) or any(c < 1 for c in terms.values()):
            return None
        # recover the linearization order greedily from the innermost
        # stride outwards.  Extent-1 axes tie on stride with their
        # neighbour (they don't advance it), so they must be consumed
        # first at each stride level — any order among equal-stride
        # extent-1 axes yields the identical output map.
        remaining = dict(terms)
        rev: list[int] = []
        stride = 1
        while remaining:
            cands = [ax for ax, c in remaining.items() if c == stride]
            ones = sorted(ax for ax in cands if op.dim_extent(ax) == 1)
            if ones:
                ax = ones[0]
            elif len(cands) == 1:
                ax = cands[0]
            else:
                return None  # not a mixed-radix linearization
            rev.append(ax)
            del remaining[ax]
            stride *= op.dim_extent(ax)
        return ("flatten", tuple(reversed(rev)))
    return None


def classify_kernel(op: GenericOp) -> KernelInfo:
    sw = detect_sliding_window(op)
    classes = classify_iterators(op)
    if sw.is_sliding_window:
        kc = KernelClass.SLIDING_WINDOW
    elif any(t == IteratorType.REDUCTION for t in op.iterator_types):
        kc = KernelClass.REGULAR_REDUCTION
    else:
        kc = KernelClass.PURE_PARALLEL
    return KernelInfo(kc, sw.stride, sw.dilation, classes)


# ---------------------------------------------------------------------------
# Derived geometry used by the streaming transform (Sec. IV-B)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WindowGeometry:
    """Geometry of a sliding-window kernel extracted from the maps.

    For a 2-D conv with input N×N and kernel K×K the paper's line buffer
    is ``(K-1) × N`` plus a ``K × K`` window buffer; this struct is the
    n-dimensional generalization the transform consumes.
    """

    window_dims: tuple[int, ...]          # 𝒲 (spatial output dims)
    window_extents: tuple[int, ...]       # trip counts of reduction dims
    #  paired with each window dim
    input_extents: tuple[int, ...]        # full extents of the 𝒪 exprs
    stride: int
    dilation: int


def conv_spatial_pads(
    op: GenericOp, input_shape: tuple[int, ...]
) -> tuple[tuple[int, int], ...]:
    """Explicit ``(begin, end)`` zero-padding per physical input axis.

    The affine maps fully determine how much input a sliding-window op
    *reads*: along a windowed axis the accesses span
    ``s*(P-1) + δ*(R-1) + 1`` elements.  Whatever that exceeds the
    producer's actual extent must be zero-padding, split end-heavy
    (``begin = total // 2``) — the XLA SAME / ONNX SAME_UPPER
    convention, and for odd kernels at stride 1 exactly the symmetric
    ``(k-1)//2`` frame the original stride-1 path used.  A VALID window
    (maps read no more than the input provides) yields ``(0, 0)``
    everywhere, so the same helper serves both conventions; pool ops
    (always VALID here) get all-zero pads too.
    """
    info = classify_kernel(op)
    if info.kernel_class != KernelClass.SLIDING_WINDOW:
        raise ValueError(f"{op.name} is not sliding-window")
    imap = op.input_maps[0]
    pads: list[tuple[int, int]] = []
    for ax, expr in enumerate(imap.results):
        par = red = None
        if not expr.is_single_dim() and expr.const == 0:
            for d, c in expr.terms:
                if op.is_parallel_dim(d):
                    par = (d, c)
                else:
                    red = (d, c)
        if par is None or red is None:
            pads.append((0, 0))
            continue
        needed = (
            par[1] * (op.dim_extent(par[0]) - 1)
            + red[1] * (op.dim_extent(red[0]) - 1)
            + 1
        )
        total = max(0, needed - input_shape[ax])
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def window_geometry(op: GenericOp, info: KernelInfo | None = None) -> WindowGeometry:
    info = info or classify_kernel(op)
    if info.kernel_class != KernelClass.SLIDING_WINDOW:
        raise ValueError(f"{op.name} is not sliding-window")
    window_dims = info.classes.window
    # each composite expr in 𝒪 is s*i_p + δ*i_r: recover the reduction
    # extent paired with each window (parallel) dim, and the *original*
    # input extent s*(P-1) + δ*(R-1) + 1 along that axis.
    win_extents: dict[int, int] = {}
    in_extents: dict[int, int] = {}
    for expr in info.classes.original_input:
        par_dim = red_dim = None
        for d, c in expr.terms:
            if op.is_parallel_dim(d):
                par_dim = (d, c)
            else:
                red_dim = (d, c)
        if par_dim is None or red_dim is None:
            continue
        (pd, s), (rd, dil) = par_dim, red_dim
        win_extents[pd] = op.dim_extent(rd)
        in_extents[pd] = s * (op.dim_extent(pd) - 1) + dil * (op.dim_extent(rd) - 1) + 1
    return WindowGeometry(
        window_dims=window_dims,
        window_extents=tuple(win_extents.get(d, 1) for d in window_dims),
        input_extents=tuple(in_extents.get(d, 1) for d in window_dims),
        stride=info.stride,
        dilation=info.dilation,
    )
