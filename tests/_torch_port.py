"""Shared helpers of the ``tests/test_torch_*.py`` files: the port
(``repro_torch``) held against the reference package (``repro``) on the
CPU, on inputs made with NumPy and handed to both."""
import functools
import os

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(REPO, "src", "repro_torch")
REF_ROOT = os.path.join(REPO, "src", "repro")

TARGETS = ("kv260", "zu3eg")


@functools.lru_cache(maxsize=None)
def compiled_pair(name: str, target: str):
    """(reference artifact, port artifact) of suite graph ``name``."""
    import repro.api as japi
    import repro_torch.api as tapi

    return (
        japi.compile_graph(japi.suite()[name](), target=target),
        tapi.compile_graph(tapi.suite()[name](), target=target),
    )


def int_env(src, seed: int, lo: int = -4, hi: int = 5, dtype=np.int32):
    """(inputs, params) of small integers for a compiled source graph."""
    rng = np.random.default_rng(seed)
    inputs = {k: rng.integers(lo, hi, size=src.values[k].shape).astype(dtype)
              for k in src.graph_inputs}
    params = {n: rng.integers(lo, hi, size=v.shape).astype(dtype)
              for n, v in src.values.items() if v.is_constant}
    return inputs, params


def strip_telemetry(report) -> str:
    return str(report).split("\ntelemetry:")[0]
