"""The port's native host library: ctypes bindings of
``tpugan_tpu_torch/native/tpugan_native.cpp``, the twin of
``tpugan_tpu/data/native.py``, with the same ``fps``, ``knn_patch``,
``radius_count`` and ``voxel_downsample``.

At first use the source is compiled with the host compiler (``$CXX``, else
``g++``) and the JAX library's flags (``native/Makefile``)::

    $CXX -O3 -std=c++17 -fPIC -shared -march=native \\
         -o tpugan_tpu_torch/_build/libtpugan_native-<hash>.so tpugan_native.cpp

The file name carries a hash of the source, the compiler, the flags and the
host CPU's model and feature flags, so a changed source is rebuilt and code
built with ``-march=native`` on one machine is never loaded on another. The
compiler writes a temporary file that ``os.replace`` moves into place, under
a file lock, so processes that start together build once. There is no
fallback: a failed build raises with the compiler's last lines.

Every entry point counts its calls in :data:`CALLS` (as
``CudaKernel.launches`` counts launches). ctypes releases the GIL for the
call, so threads sample in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tpugan_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native")

CALLS: Dict[str, int] = {"fps": 0, "knn_patch": 0, "radius_count": 0,
                         "voxel_downsample": 0}

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


@functools.lru_cache(maxsize=None)
def host_cpu() -> str:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break                        # the first processor only
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    model = fields.get("model name") or platform.processor() or ""
    return f"{platform.machine()} {model} {fields.get('flags', '')}".strip()


def library_path(source: Optional[bytes] = None, cxx: Optional[str] = None,
                 build_dir: Optional[Path] = None) -> Path:
    """Where the library built from ``source`` (default: the checkout's)
    by ``cxx`` (default: :func:`compiler`) for this host lies."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes() if source is None else source)
    for part in (cxx or compiler(), " ".join(CXXFLAGS), host_cpu()):
        h.update(b"\0" + part.encode())
    return Path(build_dir or BUILD_DIR) / f"libtpugan_native-{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library for this host unless it is built; its path.
    Raises RuntimeError when the compiler is missing or fails."""
    import fcntl

    out = library_path(build_dir=build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                         # another process built it
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native library: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-20:])
            raise RuntimeError(f"native library: {' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{tail}")
        os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64, f32 = ctypes.c_int64, ctypes.c_float
            lib.tpugan_fps.argtypes = [f32p, i64, i64, i64, i64p]
            lib.tpugan_fps.restype = None
            lib.tpugan_knn_patch.argtypes = [f32p, i64, i64, i64, i64p]
            lib.tpugan_knn_patch.restype = None
            lib.tpugan_radius_count.argtypes = [f32p, i64, f32, i32p]
            lib.tpugan_radius_count.restype = None
            lib.tpugan_voxel_downsample.argtypes = [f32p, i64, f32, f32p]
            lib.tpugan_voxel_downsample.restype = i64
            _LIB = lib
        return _LIB


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def _points(pts: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"native: points of shape {pts.shape}, want [n, 3]")
    return pts


def fps(pts: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    """Greedy farthest point sampling from ``start``: indices [k] int64."""
    pts = _points(pts)
    if not (0 < k <= pts.shape[0] and 0 <= start < pts.shape[0]):
        raise ValueError(f"native.fps: k {k}, start {start} of {pts.shape[0]}")
    out = np.empty(k, np.int64)
    _lib().tpugan_fps(pts, pts.shape[0], k, start, out)
    _count("fps")
    return out


def knn_patch(pts: np.ndarray, seed: int, k: int) -> np.ndarray:
    """The min(k, n) points nearest to point ``seed``, ascending by f32
    squared distance (ties by index): indices int64."""
    pts = _points(pts)
    if not 0 <= seed < pts.shape[0]:
        raise ValueError(f"native.knn_patch: seed {seed} of {pts.shape[0]}")
    k = min(k, pts.shape[0])
    out = np.empty(k, np.int64)
    _lib().tpugan_knn_patch(pts, pts.shape[0], seed, k, out)
    _count("knn_patch")
    return out


def radius_count(pts: np.ndarray, radius: float) -> np.ndarray:
    """Each point's neighbours within ``radius``, itself included: [n]
    int32."""
    pts = _points(pts)
    out = np.empty(pts.shape[0], np.int32)
    _lib().tpugan_radius_count(pts, pts.shape[0], radius, out)
    _count("radius_count")
    return out


def voxel_downsample(pts: np.ndarray, voxel: float) -> np.ndarray:
    """One centroid per occupied voxel of edge ``voxel`` (anchored at the
    cloud's minimum): [m, 3] f32 in the library's order."""
    pts = _points(pts)
    out = np.empty((pts.shape[0], 3), np.float32)
    m = _lib().tpugan_voxel_downsample(pts, pts.shape[0], voxel, out)
    _count("voxel_downsample")
    return out[:m].copy()
