"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see the
single real CPU device; multi-device tests spawn subprocesses that set
their own --xla_force_host_platform_device_count."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (skipped where torch.cuda.is_available() "
        "is False)",
    )


def pytest_addoption(parser):
    parser.addoption(
        "--update-golden", action="store_true", default=False,
        help="rewrite tests/golden/ from the current emission instead of "
             "diffing against it (one-command golden refresh)",
    )


@pytest.fixture(scope="session")
def golden_check(request):
    """Compare emitted text against ``tests/golden/<name>``; with
    ``pytest --update-golden`` the golden file is (re)written instead."""
    update = request.config.getoption("--update-golden")

    def check(name: str, content: str):
        path = os.path.join(GOLDEN_DIR, name)
        if update:
            with open(path, "w") as f:
                f.write(content)
            return
        assert os.path.exists(path), (
            f"missing golden {name} — run `pytest --update-golden` to "
            "create it"
        )
        with open(path) as f:
            expected = f.read()
        assert content == expected, (
            f"{name} drifted from golden — if intentional, refresh with "
            "`pytest --update-golden`"
        )

    return check


def run_subprocess(code: str, *, devices: int = 0, env: dict | None = None,
                   timeout: int = 600) -> subprocess.CompletedProcess:
    """Run python code in a subprocess with its own device count."""
    e = dict(os.environ)
    e["PYTHONPATH"] = SRC + os.pathsep + e.get("PYTHONPATH", "")
    if devices:
        e["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=e, timeout=timeout,
    )


@pytest.fixture(scope="session")
def subproc():
    return run_subprocess


@pytest.fixture(scope="session")
def deep224_fused():
    """deep_cascade(224) through the default pass pipeline — shared
    across test modules (the pipeline + per-group ILP solves are the
    priciest model-side fixtures in the suite)."""
    from repro.core import cnn_graphs
    from repro.passes import run_default_pipeline

    return run_default_pipeline(cnn_graphs.deep_cascade(224)).dfg


@pytest.fixture(scope="session")
def deep224_partition(deep224_fused):
    """Cycle-balanced partition of deep_cascade(224) (CompiledDesign)."""
    from repro.passes import partition_layer_groups

    return partition_layer_groups(deep224_fused)
