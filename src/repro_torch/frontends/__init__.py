"""Model importers: external descriptions → builder graphs.

Three pieces:

* the **ONNX reader** (:mod:`repro_torch.frontends.onnx_reader`) — trained
  NCHW models onto the NHWC builder, transposes canonicalized away by
  ``repro_torch.passes.layout``, weights threaded into
  ``CompiledArtifact.run``.  Uses the ``onnx`` package when installed,
  a vendored protobuf-wire decoder otherwise;
* the **model-card format** (:mod:`repro_torch.frontends.modelcard`) — a
  self-contained JSON interchange that round-trips any builder graph
  node-for-node (``export_card`` / ``import_card``), optionally with
  embedded weights;
* the **zoo** (:mod:`repro_torch.frontends.zoo`) — LeNet-5, a tiny-VGG
  cascade, a residual edge model and a strided ResNet-style trunk,
  registered in the benchmark suite with per-target BENCH rows.

One dispatching entry point::

    from repro_torch.frontends import import_model
    model = import_model("lenet5.onnx")        # or a .json model card
    art = repro_torch.compile_graph(model.dfg)
    y = art.run(x, params=model.params)       # on the CUDA card

— which is exactly what ``python -m repro_torch compile <file> --run``
does.  Imported weights stay NumPy until ``run`` moves them to its
device.
"""
from __future__ import annotations

import os

from .base import ImportedModel
from .modelcard import ModelCardError, export_card, import_card
from .onnx_reader import OnnxImportError, load_onnx
from .zoo import ZOO


def import_model(path: str) -> ImportedModel:
    """Import a model file by extension: ``.onnx`` → the ONNX reader,
    ``.json`` → the model-card loader."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".onnx":
        return load_onnx(path)
    if ext == ".json":
        return import_card(path)
    raise ValueError(
        f"cannot import {path!r}: unknown model extension {ext!r} "
        "(.onnx and .json model cards are supported)"
    )


__all__ = [
    "ImportedModel",
    "ModelCardError",
    "OnnxImportError",
    "ZOO",
    "export_card",
    "import_card",
    "import_model",
    "load_onnx",
]
