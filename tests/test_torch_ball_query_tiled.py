"""The ball query on shared-memory candidate tiles (``csrc/ball_query.cu``):
a numpy emulation of its scan and the launch shape around it.

* The emulation: blocks of 8 queries, candidate tiles of 1,024 points
  staged as (x, y, z, |c|^2) with |c|^2 = +inf for a masked candidate and
  the rows past Nc; a warp per query scanning a tile in trips of 4 chunks
  of 32 candidates, one ballot a chunk, hits placed by the popcount of the
  lanes below, count < ns tested once a trip; the block leaving the tile
  loop when every ball of its queries is full; missing slots padded with
  the first hit (0 for an empty ball). In f32 with each sum taken as
  (x + y) + z, it equals ``ball_query_plain`` and the Pallas kernel
  ``ball_query_pallas`` (interpret mode) index for index on empty balls,
  masked candidates, nsample > Nc, a ball that fills in the last tile,
  Nc off the tile and just past a multiple of it, and the block exit skips
  the tiles it should.
* The grid and tile of each ``chip_smoke.BALL_SHAPES`` stage.

On the card ``tests/test_torch_port.py`` (marked gpu) runs the kernel on
ragged last tiles against its plain version.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.ball_query_kernel import ball_query_pallas
from tpugan_tpu_torch.ops.kernels import ball_query as BQ

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import BALL_SHAPES  # noqa: E402

F = np.float32
UNROLL = 4


def dot3(a, b):
    """(x + y) + z of the products, each operation rounded to f32."""
    return ((a[..., 0] * b[..., 0]).astype(F) + (a[..., 1] * b[..., 1]).astype(F)
            ).astype(F) + (a[..., 2] * b[..., 2]).astype(F)


def emulate(q, c, bias, radius, ns):
    """(idx [B, Nq, ns], tiles the block loop staged per block) of the
    kernel's scan."""
    b, nq, _ = q.shape
    nc = c.shape[1]
    r2 = F(BQ.radius_sq(radius))
    tile, warps = BQ.TILE, BQ.WARPS
    out = np.zeros((b, nq, ns), np.int64)
    staged = []
    with np.errstate(invalid="ignore", over="ignore"):
        for bi in range(b):
            for q0 in range(0, nq, warps):
                rows = list(range(q0, min(q0 + warps, nq)))
                qs = q[bi, rows]
                q2 = dot3(qs, qs)
                count = [0] * len(rows)
                first = [-1] * len(rows)
                tiles = 0
                for t0 in range(0, nc, tile):
                    tiles += 1
                    pts = np.zeros((tile, 3), F)
                    c2 = np.full(tile, np.inf, F)
                    n = min(tile, nc - t0)
                    pts[:n] = c[bi, t0:t0 + n]
                    ok = bias[bi, t0:t0 + n] < 1
                    c2[:n] = np.where(ok, dot3(pts[:n], pts[:n]), np.inf)
                    for w in range(len(rows)):
                        for c0 in range(0, n, 32 * UNROLL):   # trips
                            if count[w] >= ns:
                                break
                            for j in range(UNROLL):
                                lo = c0 + 32 * j
                                d2 = ((q2[w] + c2[lo:lo + 32]).astype(F)
                                      - (F(2) * dot3(qs[w], pts[lo:lo + 32])).astype(F)
                                      ).astype(F)
                                hits = np.flatnonzero(d2 < r2)
                                if hits.size == 0:
                                    continue
                                if count[w] == 0:
                                    first[w] = t0 + lo + hits[0]
                                for s, h in enumerate(hits, count[w]):
                                    if s < ns:
                                        out[bi, rows[w], s] = t0 + lo + h
                                count[w] += hits.size
                    if all(x >= ns for x in count):
                        break          # __syncthreads_or: every ball full
                staged.append(tiles)
                for w, row in enumerate(rows):
                    out[bi, row, min(count[w], ns):] = max(first[w], 0)
    return out, staged


def _case(case):
    g = np.random.default_rng(11)
    t = lambda *s, sc=0.5: (g.standard_normal(s) * sc).astype(F)
    if case == "mixed":       # empty balls and masked candidates
        q, c = t(2, 37, 3), t(2, 700, 3)
        q[0, :5] = 50.0
        bias = np.zeros((2, 700), F)
        bias[:, ::3] = 2.0
        bias[1, :40] = 1.0    # exactly 1: masked
        return q, c, bias, 0.3, 16
    if case == "ns_over_nc":  # nsample past Nc
        return t(1, 20, 3), t(1, 45, 3), np.zeros((1, 45), F), 0.9, 64
    if case == "last_tile":   # the hits lie in the last, ragged tile only
        c = t(1, 1100, 3) + F(30.0)
        c[:, -37:] = t(1, 37, 3, sc=0.02)
        return t(1, 19, 3, sc=0.02), c, np.zeros((1, 1100), F), 0.3, 8
    if case == "off_tile":    # Nc off every tile size, balls fill early
        return t(2, 24, 3), t(2, 1301, 3), np.zeros((2, 1301), F), 0.8, 8
    if case == "all_full":    # every ball fills in the first tile: the exit
        c = t(1, 3000, 3, sc=0.05)
        return c[:, :16].copy(), c, np.zeros((1, 3000), F), 0.4, 8
    if case.startswith("ragged_"):  # hits only at the end of Nc points
        nc = int(case[7:])
        c = t(1, nc, 3) + F(30.0)
        c[:, -3:] = t(1, 3, 3, sc=0.02)
        return t(1, 11, 3, sc=0.02), c, np.zeros((1, nc), F), 0.3, 4
    raise ValueError(case)


def _clear_radius(q, c, r0):
    """A radius whose square no pair's float64 distance sits within 1e-5
    of (the JAX side sums in another order)."""
    d2 = ((q[:, :, None].astype(np.float64) - c[:, None].astype(np.float64)) ** 2
          ).sum(-1)
    for r in r0 * (1.0 + 0.0137 * np.arange(50)):
        if np.abs(d2 - float(F(r) ** 2)).min() >= 1e-5:
            return float(r)
    raise AssertionError("no clear radius")


# Nc just below, at and just past multiples of the tile: the last tile
# holds 1,023, 1,024, 1 or 3 candidates
RAGGED = ["ragged_1023", "ragged_1024", "ragged_1025", "ragged_2049",
          "ragged_3075"]
CASES = ["mixed", "ns_over_nc", "last_tile", "off_tile", "all_full", *RAGGED]


@pytest.mark.parametrize("case", CASES)
def test_emulated_tiled_scan_equals_plain(case):
    q, c, bias, r, ns = _case(case)
    got, staged = emulate(q, c, bias, r, ns)
    T = torch.from_numpy
    want = BQ.ball_query_plain(T(q), T(c), r, ns, T(bias)).numpy()
    np.testing.assert_array_equal(got, want)
    tiles = -(-c.shape[1] // BQ.TILE)
    if case == "all_full":    # every block leaves after its first tile
        assert staged == [1] * len(staged) and tiles > 1
    if case == "last_tile" or case in RAGGED:
        # no ball fills before the last tile: every block stages every tile
        assert staged == [tiles] * len(staged)
    if case in RAGGED:        # the 3 hits (across two tiles where the last
        # holds 1), then the first hit repeated
        nc = c.shape[1]
        assert (got[..., :3] == np.arange(nc - 3, nc)).all()
        assert (got[..., 3] == nc - 3).all()
    if case == "mixed":       # empty balls pad with 0
        assert (got[0, :5] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_emulated_tiled_scan_equals_pallas(case):
    q, c, bias, r, ns = _case(case)
    r = _clear_radius(q, c, r)
    got, _ = emulate(q, c, bias, r, ns)
    want = np.asarray(ball_query_pallas(jnp.asarray(q), jnp.asarray(c), r, ns,
                                        jnp.asarray(bias)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stage,b,nq,nc,r,ns,per", BALL_SHAPES)
def test_train_stages_grid_and_tile(stage, b, nq, nc, r, ns, per):
    assert BQ.blocks(b, nq) * BQ.WARPS >= b * nq
    assert BQ.blocks(b, nq) >= 64 and BQ.TILE == 4 * 32 * BQ.WARPS
    assert BQ.TILE % (32 * UNROLL) == 0
