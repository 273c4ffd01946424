"""Build and load the hand-written CUDA kernels of this package.

Each kernel is one source, ``csrc/<name>.cu``, with a plain C interface.
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
    functions on a freshly loaded handle."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._declare = declare
        self._lock = threading.Lock()
        self._lib = None
        #: seconds the last ``nvcc`` run for this library took (None
        #: until one ran in this process)
        self.build_seconds: float | None = None

    @property
    def path(self) -> pathlib.Path:
        return build_dir() / f"lib{self.name}.so"

    def build(self, *, verbose: bool = False) -> pathlib.Path:
        """Compile the source (always; :meth:`load` builds only when the
        library is missing or older than its source).  Raises when
        ``nvcc`` fails."""
        build_libraries([self], verbose=verbose)
        return self.path

    def load(self) -> ctypes.CDLL:
        """The ``ctypes`` handle, built on first use.  Created under a lock:
        the serve worker thread and the main thread may race here."""
        with self._lock:
            if self._lib is None:
                so = self.path
                if (not so.exists()
                        or so.stat().st_mtime < self.source.stat().st_mtime):
                    build_libraries([self])
                lib = ctypes.CDLL(str(so))
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
        cmd = [nvcc(), *NVCC_FLAGS]
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
        if verbose:
            print(stderr)
        os.replace(tmp, lib.path)
    if failed:
        raise RuntimeError("\n".join(failed))
