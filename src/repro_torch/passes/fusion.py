"""Operator fusion: fold elementwise consumers into producer payloads.

Two passes share one legality core:

* :class:`ElementwiseChainFusion` — chains of pure-parallel elementwise
  ops (ReLU / add / mul / …) collapse into a single node carrying the
  rest of the chain as :class:`~repro_torch.core.ir.FusedEpilogue` entries.
* :class:`ConvActivationFusion` — a trailing activation (or constant
  bias/scale) folds into the MAC node (conv / matmul) that feeds it, the
  classic epilogue fusion.

Either way the fused consumer's process function and its FIFO disappear
from the streaming plan: one fewer dataflow node, one fewer stream edge,
one fewer BRAM-bound FIFO — the footprint reduction the pass pipeline
exists to deliver.

Legality (checked per candidate pair producer P → consumer C):

  F1. C is pure-parallel with identity indexing maps (true elementwise);
  F2. C reads exactly one non-constant value, exactly once: P's output;
  F3. P's output has no other consumer and is not a graph output;
  F4. C's iteration space equals the shape of P's output value;
  F5. C's payload is a supported epilogue kind (unary: relu,
      squared_relu, identity, exp; binary with a constant operand:
      add, mul, max).
"""
from __future__ import annotations

from repro_torch.core.analysis import KernelClass, classify_kernel
from repro_torch.core.ir import DFG, FusedEpilogue, GenericOp, PayloadKind

from .base import Pass

FUSIBLE_UNARY = {
    PayloadKind.RELU,
    PayloadKind.SQUARED_RELU,
    PayloadKind.IDENTITY,
    PayloadKind.EXP,
}
FUSIBLE_BINARY = {PayloadKind.ADD, PayloadKind.MUL, PayloadKind.MAX}


def _epilogue_operand(dfg: DFG, op: GenericOp) -> tuple[bool, str | None]:
    """(is_fusible_payload, constant_operand_name) for consumer ``op``."""
    const_inputs = [i for i in op.inputs if dfg.values[i].is_constant]
    stream_inputs = [i for i in op.inputs if not dfg.values[i].is_constant]
    if op.payload in FUSIBLE_UNARY:
        return (len(stream_inputs) == 1 and not const_inputs, None)
    if op.payload in FUSIBLE_BINARY:
        if len(stream_inputs) == 1 and len(const_inputs) == 1:
            return True, const_inputs[0]
    return False, None


def _identity_or_broadcast_const(dfg: DFG, op: GenericOp) -> bool:
    """F1's map condition: the output map and every *streamed* operand
    map must be the identity; a constant operand may instead broadcast
    along the last axis (a single ``d_{n-1}`` result — the per-channel
    bias of ``make_broadcast_binary_op``).  The flat output index is
    channel-fastest, so the epilogue reads such an operand at
    ``o % len`` — still one element per output point."""
    if not op.output_map.is_identity():
        return False
    for i, name in enumerate(op.inputs):
        m = op.input_maps[i]
        if m.is_identity():
            continue
        if not dfg.values[name].is_constant:
            return False
        if len(m.results) != 1:
            return False
        e = m.results[0]
        if not (e.is_single_dim() and e.terms[0] == (op.n_dims - 1, 1)):
            return False
    return True


def can_fuse(dfg: DFG, producer: GenericOp, consumer: GenericOp) -> bool:
    """All of F1-F5, for ``producer → consumer``."""
    info = classify_kernel(consumer)
    if info.kernel_class != KernelClass.PURE_PARALLEL:          # F1
        return False
    if not _identity_or_broadcast_const(dfg, consumer):          # F1
        return False
    out = producer.output
    if consumer.inputs.count(out) != 1:                          # F2
        return False
    stream_inputs = [i for i in consumer.inputs if not dfg.values[i].is_constant]
    if stream_inputs != [out]:                                   # F2
        return False
    if out in dfg.graph_outputs or len(dfg.consumers_of(out)) != 1:  # F3
        return False
    if consumer.dim_sizes != dfg.values[out].shape:              # F4
        return False
    fusible, _ = _epilogue_operand(dfg, consumer)                # F5
    return fusible


def fuse(dfg: DFG, producer: GenericOp, consumer: GenericOp) -> None:
    """Fold ``consumer`` into ``producer.epilogue`` (caller checked
    :func:`can_fuse`).  The intermediate value disappears."""
    _, operand = _epilogue_operand(dfg, consumer)
    old_out = producer.output
    dfg.remove_node(consumer.name)
    producer.epilogue = producer.epilogue + (
        FusedEpilogue(consumer.payload, operand),
    ) + consumer.epilogue
    producer.output = consumer.output
    if old_out not in dfg.referenced_values():
        del dfg.values[old_out]


class _FusionBase(Pass):
    """Fixpoint driver; subclasses pick which producers qualify."""

    def producer_ok(self, dfg: DFG, producer: GenericOp) -> bool:
        raise NotImplementedError

    def run_on(self, dfg: DFG) -> dict[str, int]:
        fused = 0
        changed = True
        while changed:
            changed = False
            for consumer in list(dfg.nodes):
                # locate the single stream producer, if any
                producers = [
                    p for i in consumer.inputs
                    if not dfg.values[i].is_constant
                    and (p := dfg.producer_of(i)) is not None
                ]
                if len(producers) != 1:
                    continue
                producer = producers[0]
                if not self.producer_ok(dfg, producer):
                    continue
                if can_fuse(dfg, producer, consumer):
                    fuse(dfg, producer, consumer)
                    fused += 1
                    changed = True
        return {"ops_fused": fused, "streams_eliminated": fused}


class ElementwiseChainFusion(_FusionBase):
    """ReLU/add/mul chains collapse into their elementwise producer."""

    name = "elementwise-chain-fusion"

    def producer_ok(self, dfg: DFG, producer: GenericOp) -> bool:
        return classify_kernel(producer).kernel_class == KernelClass.PURE_PARALLEL


class ConvActivationFusion(_FusionBase):
    """Trailing activation folds into the MAC node (conv / matmul)."""

    name = "conv-activation-fusion"

    def producer_ok(self, dfg: DFG, producer: GenericOp) -> bool:
        if producer.payload != PayloadKind.MAC:
            return False
        return classify_kernel(producer).kernel_class in (
            KernelClass.SLIDING_WINDOW,
            KernelClass.REGULAR_REDUCTION,
        )


# ---------------------------------------------------------------------------
# conv + pool fusion: a non-overlapping pool consumer folds into the
# producing conv's epilogue as a windowed FusedEpilogue
# ---------------------------------------------------------------------------


def pool_window_factors(dfg: DFG, pool: GenericOp) -> tuple[int, ...] | None:
    """Per-output-axis pool factors for a *fusible* pool op, else None.

    Legality (beyond what :func:`can_fuse_pool` checks on the producer
    side): the op is a single-input sliding-window MAX or AVG reduction
    whose stride equals every window extent (non-overlapping — "stride
    aligned"), and whose input extents divide exactly.
    """
    if pool.payload not in (PayloadKind.MAX, PayloadKind.AVG):
        return None
    if len(pool.inputs) != 1:
        return None
    info = classify_kernel(pool)
    if info.kernel_class != KernelClass.SLIDING_WINDOW:
        return None
    out_results = list(pool.output_map.results)
    if not all(e.is_single_dim() for e in out_results):
        return None
    axis_of = {e.terms[0][0]: i for i, e in enumerate(out_results)}
    factors = [1] * len(out_results)
    for expr in info.classes.original_input:
        par = red = None
        for d, c in expr.terms:
            if pool.is_parallel_dim(d):
                par = (d, c)
            else:
                red = (d, c)
        if par is None or red is None:
            return None
        (pd, stride), (rd, dil) = par, red
        k = pool.dim_extent(rd)
        if dil != 1 or stride != k or pd not in axis_of:   # overlapping
            return None
        factors[axis_of[pd]] = k
    if all(f == 1 for f in factors):
        return None
    return tuple(factors)


def can_fuse_pool(dfg: DFG, producer: GenericOp, pool: GenericOp) -> bool:
    """Legality for ``producer → pool`` window fusion: the producer is a
    MAC sliding-window node (conv) whose output feeds *only* this
    stride-aligned pool, and the pooled axes divide exactly."""
    if producer.payload != PayloadKind.MAC:
        return False
    if classify_kernel(producer).kernel_class != KernelClass.SLIDING_WINDOW:
        return False
    out = producer.output
    if pool.inputs != (out,):
        return False
    if out in dfg.graph_outputs or len(dfg.consumers_of(out)) != 1:
        return False
    factors = pool_window_factors(dfg, pool)
    if factors is None:
        return False
    shape = dfg.values[out].shape
    if len(shape) != len(factors):
        return False
    return all(s % f == 0 for s, f in zip(shape, factors))


def fuse_pool(dfg: DFG, producer: GenericOp, pool: GenericOp) -> None:
    """Fold ``pool`` into ``producer.epilogue`` as a windowed entry
    (caller checked :func:`can_fuse_pool`)."""
    factors = pool_window_factors(dfg, pool)
    assert factors is not None
    old_out = producer.output
    dfg.remove_node(pool.name)
    producer.epilogue = producer.epilogue + (
        FusedEpilogue(pool.payload, None, window=factors),
    ) + pool.epilogue
    producer.output = pool.output
    if old_out not in dfg.referenced_values():
        del dfg.values[old_out]


class ConvPoolFusion(Pass):
    """A 2×2 (or any non-overlapping) max or average pool folds into the
    producing conv's epilogue: one fewer process, one fewer BRAM-bound
    FIFO, and the group's output stream shrinks by the pool factor.
    Average pools additionally carry the DIV exit path (one divide per
    pooled output point, charged by the resource model)."""

    name = "conv-pool-fusion"

    def run_on(self, dfg: DFG) -> dict[str, int]:
        fused = 0
        changed = True
        while changed:
            changed = False
            for pool in list(dfg.nodes):
                if pool_window_factors(dfg, pool) is None:
                    continue
                producer = dfg.producer_of(pool.inputs[0])
                if producer is None:
                    continue
                if can_fuse_pool(dfg, producer, pool):
                    fuse_pool(dfg, producer, pool)
                    fused += 1
                    changed = True
        return {"pools_fused": fused, "streams_eliminated": fused}
