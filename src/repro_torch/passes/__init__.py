"""MING pass pipeline: verified, statistics-reporting DFG rewrites.

The compiler-infrastructure layer between the frontends
(``repro_torch.core.cnn_graphs``) and the unified compile driver
(``repro_torch.core.compile_driver``, paper Fig. 4 extended):

    cnn_graphs → [canonicalize → dce → cse → fusion → dce] → compile_design
                                                               │
                     ┌─────────────────────────────────────────┘
                     ▼
            whole-graph streaming + ILP
                     │ (over budget resident?)
                     └→ cost-aware layer-group partition
                        (streamed weight tiles priced against
                         overlapped spill boundaries, any slice)
                              │
                              ▼
                     CompiledDesign — consumed by emit_hls.emit_design
                     and kernels/ops.run_compiled alike

``run_default_pipeline`` applies the standard rewrite pipeline;
``partition_layer_groups`` builds the group schedule for graphs whose
whole-graph plan exceeds the FPGA budgets.  See DESIGN.md §1 and §3.
"""
from .base import Pass, PassManager, PassStats, PipelineResult
from .canonicalize import Canonicalize
from .cse import CommonSubexprElimination
from .dce import DeadCodeElimination
from .fusion import (
    ConvActivationFusion,
    ConvPoolFusion,
    ElementwiseChainFusion,
    can_fuse,
    can_fuse_pool,
    fuse,
    fuse_pool,
)
from .layout import LayoutCanonicalize
from .partition import (
    LayerGroup,
    PartitionError,
    PartitionPlan,
    SpillBuffer,
    partition_layer_groups,
)
from .verifier import VerificationError, verify_dfg
from repro_torch.core.resource_model import DRAM_BYTES_PER_CYCLE


#: registered rewrites, keyed by their Pass.name — the vocabulary
#: ``repro_torch.core.CompileOptions.passes`` selects pipelines from
PASS_REGISTRY: dict[str, type[Pass]] = {
    cls.name: cls
    for cls in (
        Canonicalize,
        DeadCodeElimination,
        CommonSubexprElimination,
        LayoutCanonicalize,
        ElementwiseChainFusion,
        ConvActivationFusion,
        ConvPoolFusion,
    )
}


def validate_pass_names(names) -> None:
    """Reject unknown registry names — the one error message both
    ``CompileOptions`` (at construction) and :func:`pipeline_from_names`
    (at instantiation) raise."""
    unknown = [n for n in names if n not in PASS_REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown pass name(s) {unknown} — available: "
            f"{sorted(PASS_REGISTRY)}"
        )


def pipeline_from_names(names) -> list[Pass]:
    """Instantiate a pipeline from registry names, in the given order."""
    validate_pass_names(names)
    return [PASS_REGISTRY[n]() for n in names]


def default_pipeline() -> list[Pass]:
    """Canonicalize, strip dead code, dedup, cancel layout transposes
    (before fusion, so imported NCHW graphs fuse like native ones),
    fuse, clean up, re-canonicalize."""
    return [
        Canonicalize(),
        DeadCodeElimination(),
        CommonSubexprElimination(),
        LayoutCanonicalize(),
        ElementwiseChainFusion(),
        ConvActivationFusion(),
        ConvPoolFusion(),
        DeadCodeElimination(),
        Canonicalize(),
    ]


def run_default_pipeline(dfg, *, verify: bool = True) -> PipelineResult:
    """Clone ``dfg`` and run the default pipeline over the clone."""
    return PassManager(default_pipeline(), verify=verify).run(dfg)


__all__ = [
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
    "LayoutCanonicalize",
    "can_fuse",
    "can_fuse_pool",
    "fuse",
    "fuse_pool",
    "DRAM_BYTES_PER_CYCLE",
    "PASS_REGISTRY",
    "pipeline_from_names",
    "validate_pass_names",
    "LayerGroup",
    "PartitionError",
    "PartitionPlan",
    "SpillBuffer",
    "partition_layer_groups",
    "VerificationError",
    "verify_dfg",
    "default_pipeline",
    "run_default_pipeline",
]
