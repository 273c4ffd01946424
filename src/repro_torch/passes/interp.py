"""Reference DFG interpreter — the semantic oracle for pass testing.

Executes a :class:`~repro_torch.core.ir.DFG` numerically (dense PyTorch
math, no tiling, no streams, no hand-written kernel) so tests can assert
that a rewritten graph computes *exactly* what the original did: fusion
(elementwise, conv+activation, conv+pool), CSE, DCE, canonicalization,
and the layer-group partitioner are all checked against this executor,
which in turn leans on ``repro_torch.kernels.ref`` for the
conv/pool/elementwise primitives — the same primitives
``repro_torch.kernels.ops.lower_group`` lowers groups with, so the
interpreter, the device path, and the HLS emitter all share one
semantic definition.

Supported node shapes (everything ``cnn_graphs`` builds):

* pure-parallel elementwise ops (identity maps) for every PayloadKind;
* regular reductions whose map results are all single dims (matmul and
  friends), contracted from the indexing maps;
* NHWC sliding-window MAC (conv2d) via ``ref.conv2d``;
* NHWC sliding-window MAX / AVG pools via ``ref.maxpool2d`` /
  ``ref.avgpool2d`` (VALID padding);
* fused epilogues, including windowed pooling entries.

Integer graphs execute in int32 (the paper's int8 PTQ regime accumulates
in int32, wrapping mod 2³²); float graphs in float32.  Values carry
their compiled per-sample shapes (no batch axis here).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.analysis import (
    KernelClass,
    classify_kernel,
    conv_spatial_pads,
    einsum_spec,
    reorder_spec,
    window_geometry,
)
from repro_torch.core.ir import DFG, GenericOp, PayloadKind
from repro_torch.device import env_to_device, resolve_device
from repro_torch.kernels import ref


def _apply_epilogue(op: GenericOp, out, env: Mapping[str, torch.Tensor]):
    return ref.apply_epilogue(out, op.epilogue, env)


def _einsum_from_maps(op: GenericOp, operands):
    """Regular reduction with single-dim map results.  Floats go to
    ``torch.einsum``; integers are a broadcast multiply + int32 ``sum``
    over the contracted letters (exact mod 2³², and integer ``einsum``
    does not exist on CUDA)."""
    spec = einsum_spec(op)
    if not any(ref.is_integer(t) for t in operands):
        return torch.einsum(spec, *operands)
    ins, out = spec.split("->")
    subs = ins.split(",")
    letters = sorted(set("".join(subs)))
    prod = None
    for sub, t in zip(subs, operands):
        t = t.to(torch.int32)
        # align this operand's axes to the sorted letter order
        t = t.permute([sub.index(c) for c in sorted(sub)])
        shape = [t.shape[sorted(sub).index(c)] if c in sub else 1
                 for c in letters]
        t = t.reshape(shape)
        prod = t if prod is None else prod * t
    contracted = [i for i, c in enumerate(letters) if c not in out]
    if contracted:
        prod = prod.sum(dim=contracted, dtype=torch.int32)
    kept = [c for c in letters if c in out]
    return prod.permute([kept.index(c) for c in out])


def _conv2d(op: GenericOp, dfg: DFG, env: Mapping[str, torch.Tensor]):
    info = classify_kernel(op)
    if op.n_dims != 7 or len(op.inputs) != 2 or info.dilation != 1:
        raise NotImplementedError(f"{op.name}: unsupported sliding-window shape")
    stream = [i for i in op.inputs if not dfg.values[i].is_constant]
    const = [i for i in op.inputs if dfg.values[i].is_constant]
    if len(stream) != 1 or len(const) != 1:
        raise NotImplementedError(f"{op.name}: conv needs 1 stream + 1 const input")
    x = env[stream[0]]
    pads = conv_spatial_pads(op, tuple(x.shape))
    return ref.conv2d(x, env[const[0]], stride=info.stride,
                      padding=(pads[1], pads[2]))


def _pool2d(op: GenericOp, env: Mapping[str, torch.Tensor]):
    info = classify_kernel(op)
    geo = window_geometry(op, info)
    if op.n_dims != 6 or len(geo.window_extents) != 2 or info.dilation != 1:
        raise NotImplementedError(f"{op.name}: unsupported pool shape")
    kh, kw = geo.window_extents
    pool = ref.maxpool2d if op.payload == PayloadKind.MAX else ref.avgpool2d
    return pool(env[op.inputs[0]], kh, kw, info.stride)


def execute_reorder(op: GenericOp, x: torch.Tensor) -> torch.Tensor:
    """Transpose / flatten data-movement ops on a per-sample value (the
    device lowering has the batched twin,
    ``ops.execute_reorder_batched``)."""
    spec = reorder_spec(op)
    assert spec is not None, op.name
    kind, arg = spec
    if kind == "transpose":
        return x.permute(arg)
    # flatten: bring the non-batch axes into linearization order, then
    # collapse them row-major
    return x.permute((0,) + tuple(arg)).reshape(x.shape[0], -1)


def execute_node(op: GenericOp, dfg: DFG, env: Mapping[str, torch.Tensor]):
    info = classify_kernel(op)
    if info.kernel_class == KernelClass.PURE_PARALLEL:
        if reorder_spec(op) is not None:
            return _apply_epilogue(op, execute_reorder(op, env[op.inputs[0]]),
                                   env)
        args = [env[i] for i in op.inputs]
        if len(args) == 1:
            out = ref.unary(op.payload, args[0])
        elif len(args) == 2:
            out = ref.binary(op.payload, args[0], args[1])
        else:
            raise NotImplementedError(f"{op.name}: {len(args)}-ary elementwise")
    elif info.kernel_class == KernelClass.REGULAR_REDUCTION:
        if op.payload != PayloadKind.MAC:
            raise NotImplementedError(f"{op.name}: non-MAC reduction")
        out = _einsum_from_maps(op, [env[i] for i in op.inputs])
    else:  # SLIDING_WINDOW
        if op.payload == PayloadKind.MAC:
            out = _conv2d(op, dfg, env)
        elif (
            op.payload in (PayloadKind.MAX, PayloadKind.AVG)
            and len(op.inputs) == 1
        ):
            out = _pool2d(op, env)
        else:
            raise NotImplementedError(f"{op.name}: unsupported sliding window")
    return _apply_epilogue(op, out, env)


def execute_dfg(
    dfg: DFG, env: Mapping, *, device=None
) -> dict[str, torch.Tensor]:
    """Run the graph; ``env`` must bind every graph input and constant
    (NumPy arrays or tensors — moved to ``device`` here; ``None`` → the
    CUDA card).  Returns the full value environment (inputs + all
    produced values), so layer groups can be chained by feeding one
    group's result env into the next — exactly what the host schedule
    does via DRAM."""
    out_env = env_to_device(env, resolve_device(device))
    for op in dfg.topo_order():
        out_env[op.output] = execute_node(op, dfg, out_env)
    return out_env


def graph_outputs(
    dfg: DFG, env: Mapping, *, device=None
) -> dict[str, torch.Tensor]:
    full = execute_dfg(dfg, env, device=device)
    return {v: full[v] for v in dfg.graph_outputs}


def random_env(dfg: DFG, seed: int = 0, *, device=None) -> dict[str, torch.Tensor]:
    """Small-integer int32 bindings (uniform in [-4, 4]) for every graph
    input and constant — integer math keeps fused-vs-unfused comparisons
    exact.  Drawn on the host from a seeded ``torch.Generator`` (so the
    values do not depend on the device) and moved to ``device``.  The
    values differ from the reference package's for the same seed (a
    different generator); tests hand both packages one NumPy env."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    env: dict[str, torch.Tensor] = {}
    names = list(dfg.graph_inputs) + [
        v for v, val in dfg.values.items() if val.is_constant
    ]
    for name in names:
        env[name] = torch.randint(
            -4, 5, tuple(dfg.values[name].shape), generator=gen,
            dtype=torch.int32,
        ).to(dev)
    return env
