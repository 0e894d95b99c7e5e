"""The cell-grid interp kernel's scheme (``csrc/binned_interp.cu``) emulated
on the CPU: no test here needs a card.

* ``binned_plan`` (the kernel's ``make_tiles``) covers every query once,
  with tiles of one walk cell inside one aligned block of 32 sorted
  positions, and launches no empty cell.
* Each tile keeps, of its window (the 9 CSR ranges of its decoded key),
  the candidates within d2_threshold of the box of its queries; that holds
  every candidate within the cutoff of each of its queries, against a
  brute-force scan over sentinel queries and masked candidates.
* The window's staging order (lane l taking rows nb l, nb l + 1, ...)
  visits every row once. A query split over L lanes counts each kept
  candidate once (lane l takes the chunk positions l, l + L, ...), and the
  lanes' sums added by the shuffle butterfly match
  ``binned_interp_plain``; one lane a query sums the kept candidates equal
  bit for bit to a walk of the whole window, in the same order, that also
  adds the zero weights beyond the cutoff.
* Shared memory fits, and every kind weighs a pair beyond
  ``d2_threshold`` +0 exactly (what makes the skip exact).
"""

import numpy as np
import pytest
import torch

from tpugan_tpu_torch.ops.kernels import binned_interp as BI
from tpugan_tpu_torch.ops.kernels import interp as I

# (seed, B, Nq, M, C, spread of the points, cutoff, queries: drawn apart,
# the candidates themselves, or the candidates moved by 0.005): dense cells
# (many queries a cell: the frame), sparse (about one: the grid call), a
# cutoff below the spacing, and value widths over one float4
CASES = {
    "dense": (0, 2, 600, 500, 1, 0.05, 0.12, "apart"),
    "sparse": (1, 2, 300, 800, 3, 0.5, 0.05, "apart"),
    "self": (2, 1, 900, 900, 2, 0.05, 0.1, "self"),
    "tiny_cutoff": (3, 1, 200, 400, 5, 0.2, 0.01, "near"),
    "wide_values": (4, 2, 250, 300, 8, 0.2, 0.2, "apart"),
}
KIND = {"dense": "spline1", "sparse": "bicubic", "self": "spline1",
        "tiny_cutoff": "exponential", "wide_values": "linear"}


def _case(name):
    seed, b, nq, m, c, spread, cutoff, queries = CASES[name]
    g = np.random.default_rng(seed)
    cand = (g.standard_normal((b, m, 3)) * spread).astype(np.float32)
    q = (g.standard_normal((b, nq, 3)) * spread).astype(np.float32)
    if queries == "self":
        q = cand[:, :nq].copy()
    elif queries == "near":
        q = cand[:, :nq] + (0.005 * q / spread).astype(np.float32)
    q[:, :3] = 999.0                                   # sentinel queries
    v = g.standard_normal((b, m, c)).astype(np.float32)
    bias = np.zeros((b, m), np.float32)
    bias[:, ::5] = 1e10                                # masked candidates
    t = torch.from_numpy
    return t(q), t(cand), t(v), t(bias), cutoff, KIND[name]


def _tiles(q, grid):
    bits = BI.sub_bits(q.shape[0], grid.dims)
    keys, order = torch.sort(BI.query_keys(q, grid, bits), stable=True)
    return keys >> bits, order, BI.binned_plan(keys, bits)


def _ranges(key, grid):
    """The 9 (z, y) rows' [start, end) of a tile's walk cell, as walk_tile
    decodes the key."""
    b, cx, cy, cz = (int(x) for x in BI.decode_key(torch.tensor(key),
                                                   grid.dims))
    nx, ny, nz = grid.dims
    off = grid.offsets.long()
    x0, x1 = max(cx - 1, 0), min(cx + 1, nx - 1)
    out = []
    if x0 > x1:
        return out
    for z in range(max(cz - 1, 0), min(cz + 1, nz - 1) + 1):
        for y in range(max(cy - 1, 0), min(cy + 1, ny - 1) + 1):
            row = b * grid.cells + (z * ny + y) * nx
            out.append((int(off[row + x0]), int(off[row + x1 + 1])))
    return out


def _box_d2(box, pts):
    """The box's d2 to each row, in f32 as walk_tile forms it."""
    lo, hi = box
    t = np.maximum(np.maximum((lo[None] - pts[:, :3]).astype(np.float32),
                              (pts[:, :3] - hi[None]).astype(np.float32)),
                   np.float32(0))
    s = (t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]).astype(np.float32)
    s = (s + t[:, 2] * t[:, 2]).astype(np.float32)
    return (s + pts[:, 3]).astype(np.float32)


def _window(ranges):
    """The tile's window rows in the kernel's staging order: the ranges one
    after another (W rows), lane l taking positions nb l, nb l + 1, ...
    (nb = ceil(W / 32)), batch by batch, each batch in lane order."""
    rows = [r for s, e in ranges for r in range(s, e)]
    nb = -(-len(rows) // 32)
    return [rows[nb * lane + bt] for bt in range(nb) for lane in range(32)
            if nb * lane + bt < len(rows)]


def _chunks(ranges, grid, box, d2_max):
    """The kept rows in the kernel's order, in the chunks of GROUP it walks:
    the window's rows within d2_max of the box kept (a ring); each GROUP
    kept rows walked, the rest last."""
    pts = grid.pts.numpy()
    rows = np.asarray(_window(ranges), dtype=np.int64)
    kept = rows[~(_box_d2(box, pts[rows]) > d2_max)].tolist() if len(rows) \
        else []
    return [kept[i:i + BI.GROUP] for i in range(0, len(kept), BI.GROUP)]


def _tile_box(qf, order, first, count):
    qs = qf[order[first:first + count].numpy()]
    return qs.min(0), qs.max(0)


def _lane_positions(chunks, lanes, sub):
    """Rows lane ``sub`` of ``lanes`` walks, in its order: each chunk's
    positions sub, sub + lanes, ... (GROUP is a multiple of lanes, so these
    are the kept rows at sub mod lanes)."""
    return [r for chunk in chunks for r in chunk[sub::lanes]]


def _d2(q, pts):
    """sph_d2 in f32, each operation rounded on its own."""
    d = (q[None, :] - pts[:, :3]).astype(np.float32)
    s = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32)
    s = (s + d[:, 2] * d[:, 2]).astype(np.float32)
    return (s + pts[:, 3]).astype(np.float32)


def _lane_sum(q, rows, grid, cutoff, kind, d2_max, skip=True):
    """(num [C], den) of one lane: den += w, num = fma(w, v, num) in
    order, f32, skipping pairs beyond d2_max (``skip``)."""
    pts, vals = grid.pts.numpy(), grid.values.numpy()
    c = vals.shape[1]
    num, den = np.zeros(c, np.float32), np.float32(0)
    if not rows:
        return num, den
    rows = np.asarray(rows)
    d2 = _d2(q, pts[rows])
    w = I.sph_weight(torch.from_numpy(d2), cutoff, kind).numpy()
    keep = ~(d2 > d2_max) if skip else np.ones(len(rows), bool)
    for wi, r in zip(w[keep], rows[keep]):
        den = np.float32(den + wi)
        num = (np.float64(wi) * vals[r].astype(np.float64)
               + num.astype(np.float64)).astype(np.float32)
    return num, den


def _emulate(q, grid, cutoff, kind, force_lanes=None):
    """(out [B, Nq, C], den [B, Nq], split [B, Nq]) as the kernel forms
    them: per tile, per query, L lane sums added by the butterfly (lane l +=
    lane l ^ o, o = L/2 .. 1), then + 1e-6 and the division; split marks
    the queries of tiles with L > 1. ``force_lanes``: those tiles alone,
    at that L."""
    b, nq, _ = q.shape
    c = grid.values.shape[1]
    keys, order, tiles = _tiles(q, grid)
    d2_max = np.float32(I.d2_threshold(cutoff))
    qf = q.reshape(-1, 3).numpy()
    out = np.zeros((b * nq, c), np.float32)
    den_out = np.zeros(b * nq, np.float32)
    split = np.zeros(b * nq, bool)
    for key, first, count, lanes in tiles.tolist():
        if lanes > 1:
            split[order[first:first + count].numpy()] = True
        elif force_lanes:
            continue
        lanes = force_lanes or lanes
        chunks = _chunks(_ranges(key, grid), grid,
                         _tile_box(qf, order, first, count), d2_max)
        for slot in range(count):
            gq = int(order[first + slot])
            part = [_lane_sum(qf[gq], _lane_positions(chunks, lanes, s), grid,
                              cutoff, kind, d2_max) for s in range(lanes)]
            o = lanes // 2
            while o:
                part = [(part[l][0] + part[l ^ o][0],
                         np.float32(part[l][1] + part[l ^ o][1]))
                        for l in range(lanes)]
                o //= 2
            num, den = part[0]
            den = np.float32(den + np.float32(1e-6))
            out[gq] = num / den
            den_out[gq] = den
    return out.reshape(b, nq, c), den_out.reshape(b, nq), split.reshape(b, nq)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_covers_every_query_once(name):
    q, cand, v, bias, cutoff, _ = _case(name)
    grid = BI.build_grid(cand, v, bias, cutoff)
    keys, order, tiles = _tiles(q, grid)
    key, first, count, lanes = tiles.T
    n = keys.numel()
    covered = torch.zeros(n, dtype=torch.int64)
    for f, k in zip(first.tolist(), count.tolist()):
        covered[f:f + k] += 1
    assert bool((covered == 1).all())
    assert sorted(order.tolist()) == list(range(n))
    assert bool((count >= 1).all()) and bool((count <= BI.WARP).all())
    # one walk cell a tile, inside one aligned block of WARP positions
    for k, f, c in zip(key.tolist(), first.tolist(), count.tolist()):
        assert bool((keys[f:f + c] == k).all())
        assert f // BI.WARP == (f + c - 1) // BI.WARP
    # a power-of-two share of the warp for each query, all lanes used
    # at most twice over
    g = BI.WARP // lanes
    assert bool((g >= count).all()) and bool((g < 2 * count).all())
    assert bool(((g & (g - 1)) == 0).all())
    # occupied cells only, each split only where an aligned block ends
    cells = torch.unique_consecutive(keys).numel()
    blocks = -(-n // BI.WARP)
    assert cells <= tiles.shape[0] <= cells + blocks


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_holds_every_in_radius_candidate(name):
    q, cand, v, bias, cutoff, _ = _case(name)
    grid = BI.build_grid(cand, v, bias, cutoff)
    keys, order, tiles = _tiles(q, grid)
    pts = grid.pts.numpy()
    qf = q.reshape(-1, 3).numpy()
    d2_max = np.float32(I.d2_threshold(cutoff))
    b_of = np.repeat(np.arange(q.shape[0]), q.shape[1])
    # the grid's rows: cell rows in (batch, cell) order, then the candidates
    # left out (bias >= cutoff^2) after offsets[-1]
    offs = grid.offsets.numpy()
    in_grid = np.arange(int(offs[-1]))
    sorted_b = np.searchsorted(offs[1:], in_grid, side="right") // grid.cells
    cf = cand.numpy()
    bf = bias.numpy()
    near_total = 0
    culled = 0
    tested = BI.tested_pairs(q, grid, cutoff)
    walked, in_radius = BI.pair_counts(q, grid, cutoff)
    assert bool((in_radius <= tested).all()) and bool((tested <= walked).all())
    for key, first, count, _ in tiles.tolist():
        window = set()
        for s, e in _ranges(key, grid):
            window.update(range(s, e))
        chunks = _chunks(_ranges(key, grid), grid,
                         _tile_box(qf, order, first, count), d2_max)
        kept = set(r for chunk in chunks for r in chunk)
        assert kept <= window
        assert sum(len(c) for c in chunks) == len(kept)
        assert all(len(c) == BI.GROUP for c in chunks[:-1])
        culled += len(window) - len(kept)
        for slot in range(count):
            gq = int(order[first + slot])
            assert int(tested[gq]) == len(kept)
            same_b = in_grid[sorted_b == b_of[gq]]
            d2 = _d2(qf[gq], pts[same_b])
            near = set(same_b[~(d2 > d2_max)].tolist())
            # the brute force over the unsorted candidates finds no more
            raw = np.concatenate([cf[b_of[gq]], bf[b_of[gq]][:, None]], 1)
            assert int((~(_d2(qf[gq], raw) > d2_max)).sum()) == len(near)
            near_total += len(near)
            assert near <= kept, (gq, sorted(near - kept)[:5])
            if qf[gq, 0] == 999.0:
                assert not near
    assert near_total > 0 and culled > 0


@pytest.mark.parametrize("lengths", [(0, 5, 130), (128, 256, 1), (300,),
                                     (31, 0, 33), (1,)])
def test_window_order_visits_every_row_once(lengths):
    ranges, s = [], 7
    for n in lengths:
        ranges.append((s, s + n))
        s += n + 3
    order = _window(ranges)
    assert sorted(order) == [r for a, e in ranges for r in range(a, e)]
    # each batch of 32 spans the window: its rows nb apart
    nb = -(-len(order) // 32)
    rows = [r for a, e in ranges for r in range(a, e)]
    batch = rows[::nb][:32]
    assert order[:len(batch)] == batch


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("lengths", [(0, 5, 130), (128, 256, 1), (300,)])
def test_split_query_counts_each_candidate_once(lanes, lengths):
    """Ranges of those lengths, every other row culled (the box test's
    outcome), walked by the kernel's chunks of GROUP kept rows."""
    ranges, s = [], 7
    for n in lengths:
        ranges.append((s, s + n))
        s += n + 3
    kept = [r for a, e in ranges for r in range(a, e) if r % 2]
    chunks = [kept[i:i + BI.GROUP] for i in range(0, len(kept), BI.GROUP)]
    walked = [p for sub in range(lanes)
              for p in _lane_positions(chunks, lanes, sub)]
    want = [p for a, e in ranges for p in range(a, e) if p % 2]
    assert sorted(walked) == want
    # every lane tests GROUP / lanes positions of a chunk, so the warp
    # walks each chunk in the same number of steps; a lane's rows are the
    # kept rows at its residue
    assert BI.GROUP % lanes == 0
    for sub in range(lanes):
        assert _lane_positions(chunks, lanes, sub) == kept[sub::lanes]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_sums_match_plain(name):
    """The emulated kernel against binned_interp_plain: f32 sums over the
    same candidates in another order (1e-5 of the values' scale; den
    1e-5 relative), and the plan's lanes against one lane a query."""
    q, cand, v, bias, cutoff, kind = _case(name)
    grid = BI.build_grid(cand, v, bias, cutoff)
    out, den, split = _emulate(q, grid, cutoff, kind)
    po, pd = BI.binned_interp_plain(q, grid, cutoff, kind)
    scale = float(v.abs().max())
    np.testing.assert_allclose(out, po.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(den, pd.numpy(), rtol=1e-5, atol=1e-6)
    o1, d1, _ = _emulate(q, grid, cutoff, kind, force_lanes=1)
    np.testing.assert_allclose(out[split], o1[split], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(den[split], d1[split], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["dense", "self"])
def test_one_lane_walk_equals_the_full_window_walk(name):
    """One lane a query, skipping the rows the box drops and the pairs
    beyond d2_threshold, gives the bits of the walk that weighs every pair
    of the 27 cells in the same order (the first 40 such queries)."""
    q, cand, v, bias, cutoff, kind = _case(name)
    grid = BI.build_grid(cand, v, bias, cutoff)
    keys, order, tiles = _tiles(q, grid)
    d2_max = np.float32(I.d2_threshold(cutoff))
    qf = q.reshape(-1, 3).numpy()
    checked = 0
    for key, first, count, lanes in tiles.tolist():
        if lanes != 1:
            continue
        ranges = _ranges(key, grid)
        rows = _lane_positions(_chunks(ranges, grid, _tile_box(
            qf, order, first, count), d2_max), 1, 0)
        every = _window(ranges)
        for slot in range(min(count, 40 - checked)):
            gq = int(order[first + slot])
            got = _lane_sum(qf[gq], rows, grid, cutoff, kind, d2_max)
            full = _lane_sum(qf[gq], every, grid, cutoff, kind, d2_max,
                             skip=False)
            assert got[1].tobytes() == full[1].tobytes()
            assert got[0].tobytes() == full[0].tobytes()
            checked += 1
    assert checked >= BI.WARP


@pytest.mark.parametrize("c", range(1, BI.MAX_C + 1))
def test_shared_memory_fits(c):
    # a block's warps' chunks, and enough blocks an SM to fill it
    assert BI.smem_bytes(c) <= BI.SMEM_LIMIT
    assert 4 * BI.smem_bytes(c) <= BI.SMEM_LIMIT
    assert BI.CH % BI.WARP == 0 and BI.WARPS * BI.WARP <= 1024


@pytest.mark.parametrize("kind", sorted(I.KINDS))
def test_weight_is_plus_zero_beyond_threshold(kind):
    cutoff = 0.05
    t = np.float32(I.d2_threshold(cutoff))
    above = [np.nextafter(t, np.float32(np.inf)), t * np.float32(1.5),
             np.float32(4 * cutoff ** 2), np.float32(1e10)]
    w = I.sph_weight(torch.tensor(np.array(above, np.float32)), cutoff,
                     kind).numpy()
    assert (w == 0).all() and not np.signbit(w).any()
    inside = I.sph_weight(torch.tensor([t, np.float32(0)]), cutoff,
                          kind).numpy()
    assert (inside >= 0).all() and inside[1] > 0


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_query_keys_decode_to_clamped_cells(name):
    q, cand, v, bias, cutoff, _ = _case(name)
    grid = BI.build_grid(cand, v, bias, cutoff)
    bits = BI.sub_bits(q.shape[0], grid.dims)
    keys = BI.query_keys(q, grid, bits)
    b, cx, cy, cz = BI.decode_key(keys >> bits, grid.dims)
    cells = BI._cell_coords(q.reshape(-1, 3), grid, -2)
    assert torch.equal(torch.stack([cx, cy, cz], 1), cells)
    assert torch.equal(b, torch.arange(q.shape[0]).repeat_interleave(
        q.shape[1]))
    assert int(cells.min()) >= -2
    assert bool((cells <= torch.tensor(grid.dims) + 1).all())
    # the low bits: the Morton code of the quarters within the cell
    assert bits == 6
    f = (q.reshape(-1, 3) - torch.tensor(grid.lo)) * grid.inv_side
    quarter = torch.clamp_max(((f - torch.floor(f)) * 4).long(), 3)
    sub = keys & 63
    for axis, shift in ((0, 2), (1, 1), (2, 0)):
        got = ((sub >> (shift + 3)) & 1) * 2 + ((sub >> shift) & 1)
        assert torch.equal(got, quarter[:, axis])


@pytest.mark.parametrize("b,dims,want", [(1, (17, 17, 19), 6),
                                         (4, (400, 400, 100), 3),
                                         (1000, (80, 80, 80), 0)])
def test_sub_bits_keep_keys_in_int32(b, dims, want):
    bits = BI.sub_bits(b, dims)
    assert bits == want
    cells = b * (dims[0] + 4) * (dims[1] + 4) * (dims[2] + 4)
    assert (cells << bits) < 2 ** 31
