"""Minimal pure-Python BGEO (Houdini geo) particle I/O (the port's copy of
``tpugan_tpu/data/bgeo.py``; the writer's bytes equal the JAX package's).

Replaces partio (C++) for the reference's .bgeo export/import paths
(physics_data_helper.py:28-91, analysis_helper.py:73-99). Implements the
classic uncompressed BGEOV5 format with position + optional vector
attributes — enough to interoperate with partio/SPlisHSPlasH particle
dumps, which use exactly this subset.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"BgeoV"
_VERSION = 5


def write_bgeo(path: str, pos: np.ndarray,
               vel: Optional[np.ndarray] = None) -> None:
    """Write particles as uncompressed BGEO v5 (big-endian, like partio)."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    npts = pos.shape[0]
    attribs = []
    if vel is not None:
        vel = np.asarray(vel, np.float32).reshape(-1, 3)
        assert vel.shape[0] == npts
        attribs.append(("v", vel))

    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack(">iiiii", _VERSION, npts, 0, 0, 0))
        # nPointAttrib nVertexAttrib nPrimAttrib nAttrib
        fh.write(struct.pack(">iiii", len(attribs), 0, 0, 0))
        for name, _ in attribs:
            fh.write(struct.pack(">h", len(name)))
            fh.write(name.encode())
            # size=3, type=0 (float), defaults
            fh.write(struct.pack(">ii", 3, 0))
            fh.write(struct.pack(">fff", 0.0, 0.0, 0.0))
        # point data: x y z w + attributes
        w = np.ones((npts, 1), np.float32)
        row = [pos, w] + [a for _, a in attribs]
        data = np.concatenate(row, axis=1).astype(">f4")
        fh.write(data.tobytes())
        # end: no prims
        fh.write(b"\x00\xff")


def read_bgeo(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read an uncompressed BGEO v5 file -> (pos [N,3], {attr: [N,k]})."""
    with open(path, "rb") as fh:
        magic = fh.read(5)
        if magic != _MAGIC:
            raise ValueError(f"not a BGEOV5 file: {path} (magic {magic!r})")
        version, npts, nprims, npg, nprg = struct.unpack(">iiiii", fh.read(20))
        npa, nva, npra, na = struct.unpack(">iiii", fh.read(16))
        attribs = []
        for _ in range(npa):
            (nlen,) = struct.unpack(">h", fh.read(2))
            name = fh.read(nlen).decode()
            size, typ = struct.unpack(">ii", fh.read(8))
            fh.read(4 * size)  # defaults
            attribs.append((name, size))
        row_width = 4 + sum(s for _, s in attribs)
        data = np.frombuffer(
            fh.read(4 * row_width * npts), dtype=">f4"
        ).reshape(npts, row_width).astype(np.float32)
    pos = data[:, :3]
    out: Dict[str, np.ndarray] = {}
    col = 4
    for name, size in attribs:
        out[name] = data[:, col:col + size]
        col += size
    return pos, out


def write_bgeo_from_numpy(path: str, pos: np.ndarray,
                          vel: Optional[np.ndarray] = None) -> None:
    """Name-parity alias for the reference API
    (analysis_helper.py:73-84)."""
    write_bgeo(path, pos, vel)


def numpy_from_bgeo(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Name-parity alias (physics_data_helper.py:28-68): returns
    (pos, vel-or-None)."""
    pos, attrs = read_bgeo(path)
    return pos, attrs.get("v")
