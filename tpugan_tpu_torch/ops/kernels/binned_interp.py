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
formula. The kernel's source note says what bounds it on the card and
how it is laid out; :func:`binned_plan` mirrors its tiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of
from tpugan_tpu_torch.ops.kernels.interp import (KINDS, MAX_C, d2_threshold,
                                                 kernel_constants, sph_weight,
                                                 sq_dist)

FLOAT = ctypes.c_float
# KERNEL counts the calls (one each: tiles and the walk); KEYS the queries'
# cell keys that each call computes first, before the wrapper sorts them
KERNEL = CudaKernel("binned_interp", {
    "binned_interp_f32": [VOIDP] * 10 + [INT] * 7 + [FLOAT] * 4 + [INT, VOIDP]})
KEYS = CudaKernel("binned_interp", {
    "binned_keys": [VOIDP] * 3 + [INT] * 5 + [FLOAT] * 4 + [INT, VOIDP]})

# A cell side of at least the cutoff keeps every in-radius candidate inside
# the 27 cells; the margin covers the f32 rounding of the cell coordinates.
CELL_MARGIN = 1.001
MAX_CELLS = 1 << 22       # cells of the whole grid (all batch rows)
_PLAIN_PAIRS = 1 << 22    # (query, candidate) slots per plain-version block
# The kernel's layout (csrc/binned_interp.cu): a tile holds at most WARP
# queries of one cell and runs on one warp; blocks of WARPS warps; a warp
# keeps candidates in a ring of CH (float4 rows and 1 or 4 values each) and
# walks them GROUP at a time, each lane testing its share of a chunk before
# it sums their weights.
WARP, WARPS, CH, GROUP = 32, 4, 64, 32
SMEM_LIMIT = 232_448      # shared memory a block may hold on the H100


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
    qc = _cell_coords(query.reshape(b * nq, 3), grid, -2)
    rows = torch.arange(b, device=query.device).repeat_interleave(nq)
    yield from _cell_ranges(rows, qc, grid)


def _cell_ranges(rows: torch.Tensor, qc: torch.Tensor, grid: CellGrid):
    """The 9 rows' [start, end) around cells qc [n, 3] (clamped to [-2,
    n + 1]) of batch rows ``rows`` [n]."""
    nx, ny, nz = grid.dims
    base = rows * grid.cells
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
    the candidates its 27 cells hold, the pairs the plain version evaluates
    (the kernel tests those :func:`tested_pairs` counts); ``in_radius``
    those within ``cutoff``, the pairs with a weight, which the function
    itself needs."""
    n = query.shape[0] * query.shape[1]
    walked = torch.zeros(n, dtype=torch.int64, device=query.device)
    in_radius = torch.zeros_like(walked)
    for start, end in _row_ranges(query, grid):
        walked += end - start
    for rows, _, live, d2 in _walk(query, grid):
        in_radius[rows] += (live & (d2 < float(cutoff) ** 2)).sum(-1)
    return walked, in_radius


def tested_pairs(query: torch.Tensor, grid: CellGrid, cutoff: float
                 ) -> torch.Tensor:
    """Per query, [B*Nq] int64: the candidates the kernel tests for it,
    those of its tile's 27 cells within ``d2_threshold`` of the box of the
    tile's queries (:func:`binned_plan`; the box test of ``walk_tile``)."""
    b, nq, _ = query.shape
    bits = sub_bits(b, grid.dims)
    keys, order = torch.sort(query_keys(query, grid, bits), stable=True)
    tiles = binned_plan(keys, bits)
    n_t = tiles.shape[0]
    tile_of = torch.repeat_interleave(torch.arange(n_t, device=query.device),
                                      tiles[:, 2])
    q = query.reshape(b * nq, 3)[order]
    idx = tile_of[:, None].expand(-1, 3)
    lo = torch.full((n_t, 3), math.inf, device=q.device).scatter_reduce(
        0, idx, q, "amin")
    hi = torch.full((n_t, 3), -math.inf, device=q.device).scatter_reduce(
        0, idx, q, "amax")
    t_b, cx, cy, cz = decode_key(tiles[:, 0], grid.dims)
    d2_max = d2_threshold(cutoff)
    kept = torch.zeros(n_t, dtype=torch.int64, device=q.device)
    for start, end in _cell_ranges(t_b, torch.stack([cx, cy, cz], 1), grid):
        n = end - start
        tile = torch.repeat_interleave(torch.arange(n_t, device=q.device), n)
        first = torch.repeat_interleave(start - torch.cumsum(n, 0) + n, n)
        p = grid.pts[first + torch.arange(tile.numel(), device=q.device)]
        t = torch.clamp_min(torch.maximum(lo[tile] - p[:, :3],
                                          p[:, :3] - hi[tile]), 0.0)
        keep = ~(sq_dist(t, p[:, 3]) > d2_max)
        kept.scatter_add_(0, tile, keep.long())
    out = torch.empty(b * nq, dtype=torch.int64, device=q.device)
    out[order] = kept[tile_of]
    return out


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


def sub_bits(b: int, dims: Tuple[int, int, int]) -> int:
    """Bits of a query's place inside its cell in its key: 6 (quarters of
    the cell along x, y, z), else 3 (halves), else 0, the most that keep
    every key under 2^31."""
    nx, ny, nz = dims
    cells = b * (nx + 4) * (ny + 4) * (nz + 4)
    for bits in (6, 3, 0):
        if cells << bits < 2 ** 31:
            return bits
    raise ValueError(f"binned_interp kernel: {b} rows of {dims} cells "
                     "overflow its int32 cell keys")


def query_keys(query: torch.Tensor, grid: CellGrid, bits: int
               ) -> torch.Tensor:
    """Each query's key as the kernel forms it (``query_keys`` in
    csrc/binned_interp.cu), [B*Nq] int64: (cell << bits) | sub, the cell key
    ((b (nz + 4) + cz + 2) (ny + 4) + cy + 2) (nx + 4) + cx + 2 of its cell
    clamped to [-2, n + 1] as the walk clamps it, and sub the top ``bits``
    of the Morton code (x1 y1 z1 x0 y0 z0) of the quarters of the cell its
    position falls in."""
    b, nq, _ = query.shape
    nx, ny, nz = grid.dims
    p = query.reshape(b * nq, 3)
    lo = torch.tensor(grid.lo, dtype=torch.float32, device=p.device)
    inv = torch.tensor(grid.inv_side, dtype=torch.float32, device=p.device)
    f = (p - lo) * inv
    qc = _cell_coords(p, grid, -2) + 2
    quarter = torch.clamp_max(((f - torch.floor(f)) * 4).long(), 3) & 3
    sub = ((quarter >> 1) * torch.tensor([32, 16, 8], device=p.device)
           + (quarter & 1) * torch.tensor([4, 2, 1], device=p.device)).sum(-1)
    row = torch.arange(b, device=query.device).repeat_interleave(nq)
    cell = ((row * (nz + 4) + qc[:, 2]) * (ny + 4) + qc[:, 1]) * (nx + 4) \
        + qc[:, 0]
    return (cell << bits) | (sub >> (6 - bits))


def decode_key(key: torch.Tensor, dims: Tuple[int, int, int]):
    """(b, cx, cy, cz) of cell keys (a tile's key; a query's key shifted
    right by its bits), as the kernel decodes a tile's key."""
    nx, ny, nz = dims
    cx, key = key % (nx + 4) - 2, key // (nx + 4)
    cy, key = key % (ny + 4) - 2, key // (ny + 4)
    return key // (nz + 4), cx, cy, key % (nz + 4) - 2


def tile_lanes(count: torch.Tensor) -> torch.Tensor:
    """Lanes a query of a tile of ``count`` (1..WARP) queries takes:
    WARP / next_pow2(count)."""
    g = torch.ones_like(count)
    while bool((g < count).any()):
        g = torch.where(g < count, 2 * g, g)
    return WARP // g


def binned_plan(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel's tiles (``make_tiles`` in csrc/binned_interp.cu) over
    the queries' keys in sorted order (:func:`query_keys` with ``bits``):
    [T, 4] int64 rows (cell key, first sorted position, queries n, lanes a
    query). A tile starts at every position that begins a cell or an
    aligned block of WARP positions and runs to the next such position, so
    it holds 1..WARP queries of one cell, neighbours within it (the keys'
    low bits), and only occupied cells make tiles. Its n queries take WARP
    / next_pow2(n) lanes each: one lane a query in a full tile (dense
    cells), up to 32 lanes for a lone query (sparse cells). The kernel
    makes the same tiles in another order."""
    n = keys.numel()
    cell = keys >> bits
    pos = torch.arange(n, device=keys.device)
    start = pos % WARP == 0
    start[1:] |= cell[1:] != cell[:-1]
    first = pos[start]
    count = torch.diff(first, append=torch.tensor([n], device=keys.device))
    return torch.stack([cell[first], first, count, tile_lanes(count)], 1)


def smem_bytes(c: int) -> int:
    """Static shared memory of a block of the walk for C values: WARPS
    warps' CH kept rows (16 bytes) with NV values each (1 for C = 1, else 4
    a pass), each lane's GROUP d2 of a chunk, and the tile's WARP x (NV + 1)
    sums."""
    nv = 1 if c == 1 else 4
    return WARPS * (CH * 16 + CH * nv * 4 + GROUP * WARP * 4
                    + WARP * (nv + 1) * 4)


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
    nx, ny, nz = grid.dims
    bits = sub_bits(b, grid.dims)
    inv_c2, k1, k2 = kernel_constants(cutoff, kind)
    stream = stream_of(query)
    keys = torch.empty(b * nq, dtype=torch.int32, device=query.device)
    ctr = torch.empty(2, dtype=torch.int32, device=query.device)
    KEYS.launch("binned_keys", ptr(query), ptr(keys), ptr(ctr), b, nq, nx, ny,
                nz, *(FLOAT(v) for v in grid.lo), FLOAT(grid.inv_side), bits,
                stream)
    keys, order = torch.sort(keys, stable=True)
    tiles = torch.empty((b * nq, 4), dtype=torch.int32, device=query.device)
    KERNEL.launch("binned_interp_f32", ptr(query), ptr(grid.pts),
                  ptr(grid.values), ptr(grid.offsets), ptr(order), ptr(keys),
                  ptr(tiles), ptr(ctr), ptr(out), ptr(den), b, nq, c, nx, ny,
                  nz, bits, FLOAT(_d2_max(float(cutoff))), FLOAT(inv_c2),
                  FLOAT(k1), FLOAT(k2), KINDS[kind], stream)
    return out, den


@functools.lru_cache(maxsize=16)
def _d2_max(cutoff: float) -> float:
    return d2_threshold(cutoff)
