"""MING core: the paper's contribution as a composable library.

Pipeline (paper Fig. 4):
  DFG of GenericOps → analysis (Alg. 1+2) → streaming transform (streams +
  line buffers) → ILP DSE (Eq. 1) → backends (Vitis-style C++ emission /
  shared-memory tile planning for the CUDA kernels).
"""
from .analysis import (
    IteratorClasses,
    KernelClass,
    KernelInfo,
    SlidingWindowInfo,
    classify_iterators,
    classify_kernel,
    detect_sliding_window,
    window_geometry,
)
from .compile_driver import (
    KV260,
    TARGETS,
    ZU3EG,
    CompiledDesign,
    CompileOptions,
    GroupSchedule,
    Target,
    compile_design,
)
from .dse import (
    DseResult,
    divisors,
    plan_conv_rows,
    solve_ilp,
    solve_materialized,
)
from .ir import (
    DFG,
    AffineExpr,
    AffineMap,
    FusedEpilogue,
    GenericOp,
    IteratorType,
    PayloadKind,
    Value,
    make_conv2d_op,
    make_elementwise_op,
    make_matmul_op,
    make_pool2d_op,
)
from .resource_model import (
    ExecMode,
    FpgaResourceModel,
    GraphEstimate,
    KV260_BRAM18K,
    KV260_DSP,
    H100,
    HopperSpec,
)
from .streaming import FusionRegion, NodePlan, StreamEdge, StreamingPlan, plan_streams

#: pass-pipeline API re-exported lazily (PEP 562) — ``repro_torch.passes``
#: imports ``repro_torch.core`` submodules, so an eager import here would cycle.
_PASSES_EXPORTS = (
    "Pass",
    "PassManager",
    "PassStats",
    "PipelineResult",
    "Canonicalize",
    "CommonSubexprElimination",
    "DeadCodeElimination",
    "ElementwiseChainFusion",
    "ConvActivationFusion",
    "ConvPoolFusion",
    "LayerGroup",
    "PartitionError",
    "PartitionPlan",
    "SpillBuffer",
    "partition_layer_groups",
    "VerificationError",
    "verify_dfg",
    "default_pipeline",
    "run_default_pipeline",
)


def __getattr__(name: str):
    if name in _PASSES_EXPORTS:
        from repro_torch import passes as _passes

        return getattr(_passes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [k for k in dir() if not k.startswith("_")] + list(_PASSES_EXPORTS)
