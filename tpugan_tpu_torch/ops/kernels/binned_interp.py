"""Exact all-in-radius SPH interpolation over a uniform cell grid: the CUDA
kernel ``csrc/binned_interp.cu`` and its plain PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/binned_interp_kernel.py :
binned_interp_pallas``: the same contract as the dense kernel
(``ops/kernels/interp.py``), the sum over every candidate within the
cutoff, computed only over the candidates of the 27 cells around each
query. The grid is built here in plain PyTorch on the tensors' device
(:func:`build_grid`: cell keys, a stable sort, per-cell ranges), as the JAX
package leaves its Morton sort to XLA. The plain version walks the same
grid, so the CPU tests exercise the grid and the walk, not only the dense
formula. The kernel's source note says what bounds it on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of
from tpugan_tpu_torch.ops.kernels.interp import (KINDS, MAX_C,
                                                 kernel_constants, sph_weight,
                                                 sq_dist)

FLOAT = ctypes.c_float
KERNEL = CudaKernel("binned_interp", {
    "binned_interp_f32": [VOIDP] * 7 + [INT] * 6 + [FLOAT] * 7 + [INT, VOIDP]})

# A cell side of at least the cutoff keeps every in-radius candidate inside
# the 27 cells; the margin covers the f32 rounding of the cell coordinates.
CELL_MARGIN = 1.001
MAX_CELLS = 1 << 22       # cells of the whole grid (all batch rows)
_PLAIN_PAIRS = 1 << 22    # (query, candidate) slots per plain-version block


@dataclasses.dataclass
class CellGrid:
    """The candidates sorted by (batch row, cell), and each cell's range.

    ``pts`` [B*M, 4] (x, y, z, bias) and ``values`` [B*M, C] in that order,
    the candidates left out of the grid (bias >= cutoff^2) at the end;
    ``offsets`` [B * cells + 1] int32, cell ``(b, z, y, x)`` holding rows
    ``offsets[i]:offsets[i + 1]`` with ``i = b * cells + (z*ny + y)*nx + x``.
    """
    lo: Tuple[float, float, float]
    inv_side: float            # f32 value, as the kernel receives it
    dims: Tuple[int, int, int]  # (nx, ny, nz)
    pts: torch.Tensor
    values: torch.Tensor
    offsets: torch.Tensor

    @property
    def cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def _cell_coords(p: torch.Tensor, grid: CellGrid, lo_clamp: int
                 ) -> torch.Tensor:
    """Integer cell coordinates [..., 3] of points [..., 3], clamped to
    [lo_clamp, n - 1 - lo_clamp] per axis (the kernel's ``cell_coord``:
    lo_clamp -2 for queries, 0 for candidates)."""
    lo = torch.tensor(grid.lo, dtype=torch.float32, device=p.device)
    inv = torch.tensor(grid.inv_side, dtype=torch.float32, device=p.device)
    f = torch.floor((p - lo) * inv)
    hi = torch.tensor(grid.dims, dtype=torch.float32, device=p.device) - 1.0
    return torch.minimum(torch.clamp_min(f, lo_clamp), hi - lo_clamp).long()


def build_grid(cand: torch.Tensor, values: torch.Tensor, bias: torch.Tensor,
               cutoff: float) -> CellGrid:
    """Sort the candidates into cells of side >= ``cutoff`` (see
    :class:`CellGrid`). The cell count is clamped to ``MAX_CELLS`` by
    enlarging the cells, which keeps the sum exact. One small device-to-host
    copy (the bounding box)."""
    b, m, _ = cand.shape
    keep = bias < float(cutoff) ** 2
    flat = cand.reshape(b * m, 3)
    kept = flat[keep.reshape(-1)]
    if kept.shape[0]:
        box = torch.stack([kept.min(0).values, kept.max(0).values]).cpu()
    else:
        box = torch.zeros((2, 3))
    lo = tuple(float(v) for v in box[0])
    ext = [float(box[1, a] - box[0, a]) for a in range(3)]
    side = float(cutoff) * CELL_MARGIN
    while True:
        dims = tuple(int(e / side) + 1 for e in ext)
        if b * math.prod(dims) <= MAX_CELLS:
            break
        side *= 1.25
    # the f32 value of 1 / side is what both the keys and the kernel use
    inv_side = float(torch.tensor(1.0 / side, dtype=torch.float32))
    grid = CellGrid(lo, inv_side, dims, None, None, None)
    nx, ny, nz = dims
    c = _cell_coords(flat, grid, 0)
    row = torch.arange(b, device=cand.device).repeat_interleave(m)
    key = row * grid.cells + (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    key = torch.where(keep.reshape(-1), key, b * grid.cells)
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=b * grid.cells + 1)
    offsets = torch.zeros(b * grid.cells + 1, dtype=torch.int64,
                          device=cand.device)
    offsets[1:] = torch.cumsum(counts[:b * grid.cells], 0)
    grid.pts = torch.cat([flat, bias.reshape(b * m, 1)], -1)[order].contiguous()
    grid.values = values.reshape(b * m, -1)[order].contiguous()
    grid.offsets = offsets.to(torch.int32)
    return grid


def _row_ranges(query: torch.Tensor, grid: CellGrid):
    """For each of the 9 (dy, dz) rows around each query's cell: the
    [start, end) range of sorted candidates the cells x-1..x+1 of that row
    hold (empty outside the grid). Yields (start, end), each [B*Nq]."""
    b, nq, _ = query.shape
    nx, ny, nz = grid.dims
    qc = _cell_coords(query.reshape(b * nq, 3), grid, -2)
    base = torch.arange(b, device=query.device).repeat_interleave(nq) * grid.cells
    off = grid.offsets.long()
    x0 = torch.clamp_min(qc[:, 0] - 1, 0)
    x1 = torch.clamp_max(qc[:, 0] + 1, nx - 1)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            z, y = qc[:, 2] + dz, qc[:, 1] + dy
            ok = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x0 <= x1)
            row = torch.where(ok, base + (z * ny + y) * nx, 0)
            start = torch.where(ok, off[row + torch.where(ok, x0, 0)], 0)
            end = torch.where(ok, off[row + torch.where(ok, x1, 0) + 1], 0)
            yield start, end


def _walk(query: torch.Tensor, grid: CellGrid):
    """The 27-cell walk in plain PyTorch: per (dy, dz) row of cells, each
    query's candidate range padded to the longest one, in blocks of query
    rows. Yields (rows: slice of the B*Nq queries, idx [rows, width] sorted
    candidate rows, live [rows, width] inside the range, d2 [rows, width])."""
    b, nq, _ = query.shape
    q = query.reshape(b * nq, 3)
    for start, end in _row_ranges(query, grid):
        width = int((end - start).max()) if start.numel() else 0
        if width == 0:
            continue
        rows = max(1, _PLAIN_PAIRS // width)
        span = torch.arange(width, device=query.device)
        for s in range(0, b * nq, rows):
            idx = start[s:s + rows, None] + span
            live = idx < end[s:s + rows, None]
            idx = torch.where(live, idx, 0)
            p = grid.pts[idx]                              # [rows, width, 4]
            d2 = sq_dist(q[s:s + rows, None, :] - p[..., :3], p[..., 3])
            yield slice(s, s + rows), idx, live, d2


def pair_counts(query: torch.Tensor, grid: CellGrid, cutoff: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, [B*Nq] int64 each: (walked, in_radius). ``walked`` counts
    the candidates its 27 cells hold, the pairs the kernel and the plain
    version evaluate; ``in_radius`` those within ``cutoff``, the pairs with
    a weight, which the function itself needs."""
    n = query.shape[0] * query.shape[1]
    walked = torch.zeros(n, dtype=torch.int64, device=query.device)
    in_radius = torch.zeros_like(walked)
    for start, end in _row_ranges(query, grid):
        walked += end - start
    for rows, _, live, d2 in _walk(query, grid):
        in_radius[rows] += (live & (d2 < float(cutoff) ** 2)).sum(-1)
    return walked, in_radius


def binned_interp_plain(query: torch.Tensor, grid: CellGrid, cutoff: float,
                        kind: str = "bicubic"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch over the same grid
    (:func:`_walk`)."""
    b, nq, _ = query.shape
    c = grid.values.shape[-1]
    num = torch.zeros((b * nq, c), dtype=torch.float32, device=query.device)
    den = torch.zeros(b * nq, dtype=torch.float32, device=query.device)
    for rows, idx, live, d2 in _walk(query, grid):
        w = torch.where(live, sph_weight(d2, cutoff, kind), 0.0)
        den[rows] += w.sum(-1)
        num[rows] += (w[..., None] * grid.values[idx]).sum(1)
    den = den + 1e-6
    return (num / den[:, None]).reshape(b, nq, c), den.reshape(b, nq)


def binned_interp(query: torch.Tensor, cand: torch.Tensor,
                  values: torch.Tensor, cutoff: float, bias: torch.Tensor,
                  kind: str = "bicubic") -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Nq, C], den [B, Nq]): out = sum_c w values / den,
    den = sum_c w + 1e-6, over every candidate within ``cutoff``, exact (the
    dense kernel's function; no candidate cap, no block budget).

    query [B, Nq, 3], cand [B, M, 3], values [B, M, C], bias [B, M] (0
    valid, 1e10 invalid), all f32. The grid is built on the tensors' device;
    a CPU tensor then takes :func:`binned_interp_plain`, a CUDA tensor
    launches the kernel or raises.
    """
    b, nq, d = query.shape
    m, c = cand.shape[1], values.shape[-1]
    if (d != 3 or cand.shape != (b, m, 3) or values.shape != (b, m, c)
            or bias.shape != (b, m)):
        raise ValueError(f"binned_interp: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(values.shape)}, "
                         f"{tuple(bias.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if m < 1 or not cutoff > 0:
        raise ValueError(f"binned_interp: M={m}, cutoff={cutoff}")
    if query.device.type != "cpu":
        if not query.is_cuda or any(t.device != query.device
                                    for t in (cand, values, bias)):
            raise ValueError("binned_interp: tensors on more than one device")
        if {query.dtype, cand.dtype, values.dtype, bias.dtype} != {torch.float32}:
            raise TypeError("binned_interp kernel takes float32 tensors")
        if not 1 <= c <= MAX_C:
            raise ValueError(f"binned_interp kernel takes 1 <= C <= {MAX_C}; "
                             f"got {c}")
    grid = build_grid(cand, values, bias, cutoff)
    if query.device.type == "cpu":
        return binned_interp_plain(query, grid, cutoff, kind)
    return binned_interp_launch(query, grid, cutoff, kind)


def query_order(query: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """The queries' rows [B*Nq] int32 sorted by (batch row, cell)."""
    b, nq, _ = query.shape
    nx, ny, _ = grid.dims
    qc = _cell_coords(query.reshape(b * nq, 3), grid, 0)
    key = (torch.arange(b, device=query.device).repeat_interleave(nq)
           * grid.cells + (qc[:, 2] * ny + qc[:, 1]) * nx + qc[:, 0])
    return torch.argsort(key).to(torch.int32)


def binned_interp_launch(query: torch.Tensor, grid: CellGrid, cutoff: float,
                         kind: str = "bicubic"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel over a grid built by :func:`build_grid` (CUDA
    tensors; :func:`binned_interp` checks them)."""
    if not (query.is_cuda and grid.pts.device == query.device):
        raise ValueError(f"binned_interp kernel: tensors on {query.device}, "
                         f"{grid.pts.device}")
    b, nq, _ = query.shape
    c = grid.values.shape[-1]
    query = query.contiguous()
    out = torch.empty((b, nq, c), dtype=torch.float32, device=query.device)
    den = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    if b * nq == 0:
        return out, den
    order = query_order(query, grid)
    inv_c2, k1, k2 = kernel_constants(cutoff, kind)
    nx, ny, nz = grid.dims
    KERNEL.launch("binned_interp_f32", ptr(query), ptr(grid.pts),
                  ptr(grid.values), ptr(grid.offsets), ptr(order), ptr(out),
                  ptr(den), b, nq, c, nx, ny, nz,
                  *(FLOAT(v) for v in grid.lo), FLOAT(grid.inv_side),
                  FLOAT(inv_c2), FLOAT(k1), FLOAT(k2), KINDS[kind],
                  stream_of(query))
    return out, den
