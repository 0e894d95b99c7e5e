"""Builds the package's CUDA kernels and binds them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

The first kernel that is used builds every missing library at once, one
``nvcc`` process per source, all started together. A library's file name
carries a hash of its source, the shared headers and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is. The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>.log``.

C entry points take device pointers and the CUDA stream as ``c_void_p``,
sizes as ``c_int``, launch on the stream they are given, never synchronise,
allocate nothing, and return ``cudaGetLastError()``; :meth:`CudaKernel.launch`
raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_build_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every kernel library that is missing; returns the seconds
    spent. All ``nvcc`` processes run at once."""
    with _build_lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in sources():
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log_path = BUILD_DIR / f"{name}.log"
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out, log_path))
        failed = []
        for name, proc, tmp, out, log_path in jobs:
            if proc.wait() != 0:
                failed.append(f"{name}:\n{log_path.read_text()[-4000:]}")
            else:
                os.replace(tmp, out)      # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``csrc/<name>.cu``."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


class CudaKernel:
    """One ``csrc/<name>.cu`` library: built at first use, bound with ctypes,
    with a count of the launches made through :meth:`launch`."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name = name
        self.launches = 0
        self._signatures = signatures
        self._lib = None

    def _load(self):
        path = _lib_path(self.name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in self._signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        return lib

    def launch(self, symbol: str, *args, count: bool = True) -> None:
        """Call ``symbol``; raise if the launch was refused or failed.
        ``count=False``: one part of a launch made of several calls, whose
        caller counts it once."""
        if self._lib is None:
            self._lib = self._load()
        rc = getattr(self._lib, symbol)(*args)
        if rc != 0:
            msg = self._lib.error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{symbol}: CUDA error {rc}: {msg}")
        self.launches += count


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
