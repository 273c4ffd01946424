"""Build and load the hand-written CUDA kernels of this package.

Each kernel is one source, ``csrc/<name>.cu``, with a plain C interface;
the sources share the headers ``csrc/*.cuh``.
``nvcc`` compiles it for ``sm_90a`` into ``lib<name>.so`` under
``build/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``) at
first use — a few seconds, since no source includes PyTorch's headers —
and ``ctypes`` loads it.  :func:`build_libraries` starts one ``nvcc`` per
source, all at once, and waits for them together.

Nothing here runs at import: a module that holds a kernel creates its
:class:`CudaLibrary` and builds it only when a CUDA tensor reaches the
wrapper.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time
from typing import Callable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


class CudaLibrary:
    """``csrc/<name>.cu`` → ``build/lib<name>.so`` → one ``ctypes`` handle
    per process.  ``declare`` sets ``argtypes``/``restype`` of the C
    functions on a freshly loaded handle.  ``source`` and ``flags`` build
    a variant of another kernel's source under a name of its own (extra
    ``nvcc`` flags such as ``-D`` macros)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 *, source: pathlib.Path | None = None,
                 flags: tuple[str, ...] = ()):
        self.name = name
        self.source = source if source is not None else CSRC / f"{name}.cu"
        self.flags = tuple(flags)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib = None
        #: seconds the last ``nvcc`` run for this library took (None
        #: until one ran in this process)
        self.build_seconds: float | None = None
        #: what ``nvcc`` printed in that run (with ``verbose``, ptxas'
        #: registers, shared memory and spills per kernel)
        self.build_log: str | None = None

    @property
    def path(self) -> pathlib.Path:
        return build_dir() / f"lib{self.name}.so"

    def build(self, *, verbose: bool = False) -> pathlib.Path:
        """Compile the source (always; :meth:`load` builds only when
        :meth:`stale`).  Raises when
        ``nvcc`` fails."""
        build_libraries([self], verbose=verbose)
        return self.path

    def stale(self) -> bool:
        """True when the library is missing or older than its source or
        than any shared header ``csrc/*.cuh`` (a header edit must not load
        a library built from the old one)."""
        so = self.path
        if not so.exists():
            return True
        built = so.stat().st_mtime
        inputs = [self.source, *self.source.parent.glob("*.cuh")]
        return any(p.stat().st_mtime > built for p in inputs)

    def load(self) -> ctypes.CDLL:
        """The ``ctypes`` handle, built on first use.  Created under a lock:
        the serve worker thread and the main thread may race here."""
        with self._lock:
            if self._lib is None:
                if self.stale():
                    build_libraries([self])
                lib = ctypes.CDLL(str(self.path))
                self._declare(lib)
                self._lib = lib
            return self._lib


def build_libraries(libs, *, verbose: bool = False) -> None:
    """Run one ``nvcc`` per library, all started together, and wait for
    every one.  Each output lands under a temporary name and is renamed
    into place, so a concurrent process never loads half a file.  Raises
    :class:`RuntimeError` naming every build that failed."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    running = []
    for lib in libs:
        tmp = out_dir / f".lib{lib.name}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, *lib.flags]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((lib, cmd, tmp, proc, time.perf_counter()))
    failed = []
    for lib, cmd, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        lib.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stdout}\n{stderr}")
            continue
        lib.build_log = stdout + stderr
        os.replace(tmp, lib.path)
    if failed:
        raise RuntimeError("\n".join(failed))


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise if any operand is a DTensor: a kernel takes plain tensors
    (a sharded step computes on local ones), and a wrapper never takes
    its plain version for one."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{kernel}: a DTensor operand — the kernels take "
                        "plain tensors (gather or take the local shard)")
