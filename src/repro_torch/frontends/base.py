"""Shared frontend types: what every importer hands the compiler.

An importer (ONNX reader, model-card loader) produces an
:class:`ImportedModel`: the builder-built DFG plus the imported weights,
keyed by the DFG's *constant value names* so they thread straight into
``CompiledArtifact.run(params=model.params)`` — the one contract that
lets ``python -m repro_torch compile model.onnx --run`` execute imported
networks with their trained weights instead of the smoke-run random
init.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.ir import DFG


@dataclass
class ImportedModel:
    """A model pulled in from an external description.

    ``params`` binds the DFG's constant values (weights, biases) to the
    imported arrays; it may be empty (a weightless model card) — the
    run path then falls back to the deterministic random init exactly
    like a native builder graph.
    """

    name: str
    dfg: DFG
    params: dict[str, np.ndarray] = field(default_factory=dict)
    #: which importer produced this ("card" | "onnx")
    source: str = "card"

    def missing_params(self) -> list[str]:
        """Constant values the import did *not* bind (run() randomizes
        these) — surfaced by the CLI so a weightless run is explicit."""
        consts = {
            n for n, v in self.dfg.values.items() if v.is_constant
        }
        return sorted(consts - set(self.params))
