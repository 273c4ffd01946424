"""The device rule of the package, in one place.

Every entry point that executes (``CompiledArtifact.run``,
``ops.run_compiled`` / ``run_compiled_batched``, ``ServeEngine``,
``interp.execute_dfg`` / ``random_env``) takes ``device=None``, and
``None`` means the CUDA card.  With no card present that raises — it
never carries on on the CPU.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``torch.device("cuda")``; anything else →
    ``torch.device(device)``.  A CUDA device that is not there raises
    :class:`RuntimeError` instead of falling back to the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch executes on a CUDA device by default and "
            "torch.cuda.is_available() is False — pass device='cpu' to "
            "run the plain PyTorch versions on the host"
        )
    if dev.type == "cuda" and dev.index is None:
        # name the card: per-thread device selection wants an index
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: NumPy dtypes without a 32-bit-or-narrower twin are narrowed at the
#: boundary, the way the reference package's arrays are (no 64-bit types)
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.int32,
           np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int32,
           np.dtype(np.float64): np.float32}


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """Move one env entry (NumPy array, scalar, nested list or tensor)
    onto ``device``, dtype kept (64-bit types narrow to 32 bits)."""
    if isinstance(value, torch.Tensor):
        t = value
        if t.dtype == torch.int64:
            t = t.to(torch.int32)
        elif t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(device)
    arr = np.asarray(value)
    narrow = _NARROW.get(arr.dtype)
    if narrow is not None:
        arr = arr.astype(narrow)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def env_to_device(env, device: torch.device) -> dict:
    """:func:`to_tensor` over a ``{name: array}`` mapping."""
    return {k: to_tensor(v, device) for k, v in env.items()}
