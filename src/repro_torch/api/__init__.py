"""The public API — one front door for the whole reproduction.

Three pieces:

* the **layer-builder frontend** (:mod:`repro_torch.api.builder`):
  :class:`Sequential` / :class:`Graph` combinators with automatic shape
  inference and validating errors, replacing hand-assembled DFGs;
* :class:`CompileOptions` (re-exported from
  :mod:`repro_torch.core.compile_driver`): every compile knob in one frozen,
  validated bundle;
* :class:`CompiledArtifact` (:mod:`repro_torch.api.artifact`): the handle a
  compile returns — ``emit_hls`` / ``run`` / ``report`` / ``save`` /
  ``load``.

Typical session::

    from repro_torch.api import Sequential, Conv2D, ReLU, MaxPool, \
        CompileOptions, compile_graph

    net = Sequential([Conv2D(16), ReLU(), MaxPool(2)],
                     input_shape=(1, 32, 32, 3), name="demo")
    art = compile_graph(net, CompileOptions(target="kv260"))
    print(art.report())
    art.emit_hls("out/")
    y = art.run(x)

Everything here is also re-exported at the package top level
(``import repro_torch; repro_torch.compile_graph(...)``).
``y = art.run(x)`` executes on the CUDA card; pass ``device="cpu"`` to
run the plain PyTorch versions on the host.
"""
from repro_torch.core.compile_driver import (
    KV260,
    TARGETS,
    ZU3EG,
    CompiledDesign,
    CompileOptions,
    Target,
    compile_design,
)

from repro_torch.analyze import (
    Diagnostic,
    LintError,
    Severity,
    analyze_design,
    diagnostics_to_json,
)
from repro_torch.instrument import Tracer, use_tracer, validate_chrome_trace

from .artifact import (
    CompiledArtifact,
    GroupReport,
    Report,
    TransitionReport,
    compile_graph,
    params_from_numpy,
)
from .builder import (
    Activation,
    AvgPool,
    Conv2D,
    Dense,
    Flatten,
    FrontendError,
    Graph,
    MaxPool,
    ReLU,
    Residual,
    Sequential,
    TensorRef,
    Transpose,
)


def suite() -> dict:
    """The named graphs the CLI / benchmarks can compile out of the box:
    the paper suite, the fusion and weight-streaming showcases, and the
    model zoo (``repro_torch.frontends.zoo``) — every one built through the
    declarative frontend, every one a per-target row in
    ``BENCH_smoke.json``."""
    from repro_torch.core import cnn_graphs
    from repro_torch.frontends import zoo

    out = dict(cnn_graphs.PAPER_SUITE)
    out["conv_pool_32"] = lambda: cnn_graphs.conv_pool(32)
    out["conv_avgpool_32"] = lambda: cnn_graphs.conv_avgpool(32)
    out["fat_conv_16"] = cnn_graphs.fat_conv
    out["fat_cascade_16"] = cnn_graphs.fat_cascade
    out.update(zoo.ZOO)
    return out


__all__ = [
    "KV260",
    "TARGETS",
    "ZU3EG",
    "CompiledDesign",
    "CompileOptions",
    "Target",
    "compile_design",
    "CompiledArtifact",
    "Diagnostic",
    "GroupReport",
    "LintError",
    "Report",
    "Severity",
    "Tracer",
    "TransitionReport",
    "analyze_design",
    "compile_graph",
    "diagnostics_to_json",
    "params_from_numpy",
    "use_tracer",
    "validate_chrome_trace",
    "Activation",
    "AvgPool",
    "Conv2D",
    "Dense",
    "Flatten",
    "FrontendError",
    "Graph",
    "MaxPool",
    "ReLU",
    "Residual",
    "Sequential",
    "TensorRef",
    "Transpose",
    "suite",
]
