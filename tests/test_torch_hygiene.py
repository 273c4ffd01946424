"""The port stands alone: no import of ``jax``, of ``ml_dtypes``, of the
reference package or of the reference's ``benchmarks`` anywhere in
``src/repro_torch``, ``chip_smoke.py`` or ``examples/*_torch.py``; no silent
CPU path when the card is missing; the conv wrapper on a CPU tensor
never touches the CUDA toolchain; no TPU constant in the port."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import PORT_ROOT, REF_ROOT, REPO, compiled_pair

#: the port's package, its card script and its examples
EXAMPLES = ["examples/quickstart_torch.py", "examples/serve_batched_torch.py",
            "examples/train_lm_torch.py",
            "examples/elastic_resilience_torch.py"]
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in pathlib.Path(PORT_ROOT).rglob("*.py")
) + ["chip_smoke.py"] + EXAMPLES

#: modules carried over from the reference with imports rewritten and
#: nothing else that executes (comments and docstrings may differ)
COPIED = [
    "core/ir.py", "core/analysis.py", "core/streaming.py",
    "core/emit_hls.py", "core/compile_driver.py", "core/cnn_graphs.py",
    "passes/base.py", "passes/verifier.py", "passes/dce.py",
    "passes/canonicalize.py", "passes/cse.py", "passes/fusion.py",
    "passes/layout.py", "passes/partition.py", "passes/__init__.py",
    "analyze/__init__.py", "analyze/diagnostics.py", "analyze/engine.py",
    "analyze/hazards.py", "analyze/hygiene.py", "analyze/ranges.py",
    "analyze/stream_skew.py", "instrument/tracer.py",
    "instrument/metrics.py", "instrument/snapshot.py",
    "instrument/provenance.py", "api/builder.py", "serve/cache.py",
    "serve/loadgen.py", "configs/__init__.py", "configs/registry.py",
    "configs/llama3_2_1b.py", "configs/qwen2_0_5b.py",
    "configs/nemotron_4_15b.py", "configs/yi_9b.py",
    "configs/seamless_m4t_medium.py", "configs/jamba_1_5_large_398b.py",
    "configs/qwen2_vl_72b.py", "configs/olmoe_1b_7b.py",
    "configs/granite_moe_1b_a400m.py", "configs/mamba2_1_3b.py",
    "frontends/base.py", "frontends/modelcard.py",
    "frontends/onnx_reader.py", "frontends/zoo.py", "frontends/__init__.py",
    "instrument/__init__.py", "runtime/__init__.py",
    "runtime/resilience.py", "quant/__init__.py", "checkpoint/__init__.py",
]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_no_reference_import(rel):
    tree = ast.parse(pathlib.Path(REPO, rel).read_text())
    for mod in _imports(tree):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax",
                           "benchmarks", "ml_dtypes"), f"{rel} imports {mod}"


def _code_dump(path, rename: bool) -> str:
    """AST of a module with docstrings dropped (and, for the reference,
    ``repro`` → ``repro_torch`` in imports and string constants)."""
    text = pathlib.Path(path).read_text()
    if rename:
        text = re.sub(r"(?<![\w-])repro(?=\.|\s+import)", "repro_torch", text)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0].value.value = ""
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_executes_the_same_code(rel):
    assert _code_dump(os.path.join(PORT_ROOT, rel), False) == _code_dump(
        os.path.join(REF_ROOT, rel), True)


@pytest.mark.parametrize("rel", [f for f in PORT_FILES if f != "chip_smoke.py"])
def test_no_tpu_constants(rel):
    text = pathlib.Path(REPO, rel).read_text()
    for needle in ("197e12", "819e9", "16 * 1024 * 1024", "mxu_dim",
                   "vmem_bytes", "TpuSpec", "TPU_V5E", "pallas_call"):
        assert needle not in text, f"{rel} still carries {needle!r}"


def test_import_touches_no_toolchain():
    """Importing every module of the port needs neither triton, nvcc nor
    a card, and pulls in neither jax nor the reference package."""
    code = (
        "import sys, importlib, pkgutil, repro_torch, repro_torch.api\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'triton', 'benchmarks')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


class TestNoSilentCpu:
    """``device=None`` means the card; without one, every executing entry
    point raises instead of carrying on on the CPU."""

    def test_artifact_run_raises(self):
        _no_card()
        _, art = compiled_pair("conv_relu_32", "kv260")
        with pytest.raises(RuntimeError, match="cuda"):
            art.run()

    def test_run_compiled_raises(self):
        _no_card()
        from repro_torch.kernels import ops

        _, art = compiled_pair("conv_relu_32", "kv260")
        with pytest.raises(RuntimeError, match="cuda"):
            ops.run_compiled(art.design, {})
        with pytest.raises(RuntimeError, match="cuda"):
            ops.run_compiled_batched(art.design, {}, 2)

    def test_interp_raises(self):
        _no_card()
        from repro_torch.passes import interp

        _, art = compiled_pair("conv_relu_32", "kv260")
        with pytest.raises(RuntimeError, match="cuda"):
            interp.random_env(art.source)
        with pytest.raises(RuntimeError, match="cuda"):
            interp.execute_dfg(art.source, {})

    def test_serve_engine_raises_at_start(self):
        _no_card()
        from repro_torch.serve import ServeEngine

        _, art = compiled_pair("conv_relu_32", "kv260")
        eng = ServeEngine(art)
        with pytest.raises(RuntimeError, match="cuda"):
            eng.start()
        assert eng._worker is None

    def test_params_from_numpy_raises(self):
        _no_card()
        from repro_torch.api import params_from_numpy

        with pytest.raises(RuntimeError, match="cuda"):
            params_from_numpy({"w": np.zeros(3, np.int32)})

    def test_chip_smoke_fails_without_a_card(self):
        _no_card()
        r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_cpu_conv_never_builds_or_loads_the_library(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d_stream as cs

    def boom(*a, **k):
        raise AssertionError("the CPU path reached for the CUDA library")

    monkeypatch.setattr(cs.LIBRARY, "load", boom)
    monkeypatch.setattr(cs.LIBRARY, "build", boom)
    monkeypatch.setattr(build, "build_libraries", boom)
    monkeypatch.setattr(build.subprocess, "Popen", boom)
    before = (cs.launches, cs.plain_cuda_calls)
    x = torch.arange(2 * 6 * 6 * 3, dtype=torch.int32).reshape(2, 6, 6, 3)
    w = torch.ones(3, 3, 3, 4, dtype=torch.int32)
    out = cs.conv2d_stream(x, w, pads=((1, 1), (1, 1)), epilogue="relu")
    assert out.shape == (2, 6, 6, 4) and out.dtype == torch.int32
    assert (cs.launches, cs.plain_cuda_calls) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels import conv2d_stream as cs

    x = torch.zeros(1, 6, 6, 3, dtype=torch.int32)
    w = torch.zeros(3, 3, 3, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="dilation"):
        cs.conv2d_stream(x, w, dilation=2)
    with pytest.raises(TypeError):
        cs.conv2d_stream(x, w.to(torch.int8))
    with pytest.raises(TypeError):
        cs.conv2d_stream(x.double(), w.double())
    with pytest.raises(ValueError, match="Cin"):
        cs.conv2d_stream(x, torch.zeros(3, 3, 2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="epilogue"):
        cs.conv2d_stream(x, w, epilogue="gelu")
    with pytest.raises(ValueError, match="empty output"):
        cs.conv2d_stream(x, torch.zeros(7, 7, 3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows_per_block"):
        cs.conv2d_stream(x, w, rows_per_block=0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (the full sweep is
    ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import conv2d_stream as cs

    g = torch.Generator().manual_seed(0)
    x = torch.randint(-4, 5, (2, 9, 11, 5), generator=g, dtype=torch.int32).cuda()
    w = torch.randint(-4, 5, (3, 3, 5, 7), generator=g, dtype=torch.int32).cuda()
    pads = ((1, 1), (1, 1))
    got = cs.conv2d_stream(x, w, pads=pads, epilogue="relu")
    assert torch.equal(got, cs.conv2d_stream_plain(x, w, 1, pads, "relu"))
