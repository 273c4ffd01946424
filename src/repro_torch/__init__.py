"""MING reproduction on PyTorch and CUDA — top-level package.

The public surface lives in :mod:`repro_torch.api` (layer-builder frontend,
``CompileOptions``, ``CompiledArtifact``) and is re-exported here
lazily, so ``import repro_torch`` stays free of heavy imports (torch
loads only when a kernel path actually runs)::

    import repro_torch

    net = repro_torch.Sequential([repro_torch.Conv2D(16), repro_torch.ReLU()],
                           input_shape=(1, 32, 32, 3), name="demo")
    art = repro_torch.compile_graph(net, repro_torch.CompileOptions(target="kv260"))

Subsystems keep their own namespaces: ``repro_torch.core`` (IR, analysis,
streaming, DSE, resource model, emit), ``repro_torch.passes`` (rewrites +
partitioner), ``repro_torch.kernels`` (CUDA kernels, their plain versions, the
group lowering), and the LM stack: ``repro_torch.configs``,
``repro_torch.models`` (layers, Mamba-2, the dense and SSM LM) and
``repro_torch.launch`` (serve steps, the LM server).
``lm_params_from_numpy`` carries the reference's LM parameters across, as
``params_from_numpy`` does a compiled design's env.
"""
from __future__ import annotations

def _api():
    import importlib

    return importlib.import_module("repro_torch.api")


def __getattr__(name: str):
    # forward the public surface lazily (PEP 562); repro_torch.api.__all__ is
    # the single source of truth, so new api exports appear here too
    if name == "api":
        return _api()
    if name == "lm_params_from_numpy":
        from repro_torch.models.lm import lm_params_from_numpy

        return lm_params_from_numpy
    api = _api()
    if name in api.__all__:
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_api().__all__)
                  | {"api", "lm_params_from_numpy"})
