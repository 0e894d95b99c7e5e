"""The port's cell-grid interpolation (``ops/kernels/binned_interp.py``)
against the JAX package's ``binned_interp_pallas`` (on the CPU its XLA walk
of the selected blocks, ``_binned_xla``, or the dense fallback on block
overflow) and against the port's dense ``interp_plain``, on the same numpy
inputs. On the CPU the port's wrapper runs its plain version, which walks
the same cell grid as the kernel. Tolerances: f32 sums over the same
candidates in another order, ``den`` to 1e-5 relative and ``out`` to 1e-5
of the values' scale.
"""

import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.binned_interp_kernel import binned_interp_pallas
from tpugan_tpu_torch.ops.interpolate import cubic_interpolation_dense
from tpugan_tpu_torch.ops.kernels import binned_interp as BI
from tpugan_tpu_torch.ops.kernels.interp import interp_plain

T = torch.from_numpy


def _inputs(rng, b, nq, m, c, scale=0.2, masked=3):
    q = (rng.standard_normal((b, nq, 3)) * scale).astype(np.float32)
    cand = (rng.standard_normal((b, m, 3)) * scale).astype(np.float32)
    vals = rng.standard_normal((b, m, c)).astype(np.float32)
    bias = np.zeros((b, m), np.float32)
    if masked:
        bias[:, ::masked] = 1e10
    return q, cand, vals, bias


def _close(got, want, vals):
    (o, d), (wo, wd) = got, want
    np.testing.assert_allclose(np.asarray(d), np.asarray(wd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(o), np.asarray(wo), rtol=0,
                               atol=1e-5 * float(np.abs(vals).max()))


@pytest.mark.parametrize("kind", ["bicubic", "spline1"])
@pytest.mark.parametrize("cutoff", [
    0.16,    # a few candidates in radius
    0.6,     # cells that hold many points (about half the cloud in radius)
    0.01,    # below the spacing: most queries see no candidate
])
def test_binned_matches_jax_and_dense(rng, kind, cutoff):
    """A batch of 2, masked candidates (every third), sentinel queries."""
    q, cand, vals, bias = _inputs(rng, 2, 300, 700, 3)
    q[:, :5] = 999.0
    got = BI.binned_interp(T(q), T(cand), T(vals), cutoff, T(bias), kind)
    want = binned_interp_pallas(q, cand, vals, cutoff, bias, kind=kind,
                                max_blocks=8)
    _close([t.numpy() for t in got], want, vals)
    _close([t.numpy() for t in got],
           interp_plain(T(q), T(cand), T(vals), cutoff, T(bias), kind), vals)


def test_binned_matches_jax_overflow_case(rng):
    """One block allowed per tile: the JAX function takes its dense
    fallback; the cell grid has no budget and is exact as it is."""
    q, cand, vals, bias = _inputs(rng, 1, 256, 512, 2, masked=0)
    got = BI.binned_interp(T(q), T(cand), T(vals), 0.5, T(bias), "bicubic")
    want = binned_interp_pallas(q, cand, vals, 0.5, bias, blk=128,
                                max_blocks=1)
    _close([t.numpy() for t in got], want, vals)


def test_grid_puts_every_candidate_in_one_cell(rng):
    """Each valid candidate sits exactly once in the sorted order, inside
    the range of the cell its coordinates fall in; masked ones sit after
    every cell's range. Also with the cell count clamped (a cutoff far
    below the spacing enlarges the cells)."""
    q, cand, vals, bias = _inputs(rng, 2, 10, 500, 2)
    for cutoff in (0.07, 1e-5):
        grid = BI.build_grid(T(cand), T(vals), T(bias), cutoff)
        assert 2 * grid.cells <= BI.MAX_CELLS
        off = grid.offsets.long()
        assert int(off[0]) == 0 and bool((off[1:] >= off[:-1]).all())
        assert int(off[-1]) == int((bias < cutoff ** 2).sum())
        # the sorted rows are a permutation of the candidates
        flat = np.concatenate([cand.reshape(-1, 3), bias.reshape(-1, 1)], 1)
        assert sorted(map(tuple, grid.pts.numpy())) == sorted(map(tuple, flat))
        cells = BI._cell_coords(grid.pts[:int(off[-1]), :3], grid, 0)
        nx, ny, _ = grid.dims
        lin = (cells[:, 2] * ny + cells[:, 1]) * nx + cells[:, 0]
        row = torch.searchsorted(off[1:], torch.arange(int(off[-1])),
                                 right=True)
        b_of_row = row // grid.cells
        assert torch.equal(row % grid.cells, lin)
        # batch rows in order: the first half of the kept rows is batch 0
        assert torch.equal(b_of_row, torch.sort(b_of_row).values)
        assert grid.values.shape == (1000, 2)


def test_grid_walk_covers_every_in_radius_pair(rng):
    """The pairs the 27 cells hold include every pair within the cutoff,
    and the walk counts exactly those in radius."""
    q, cand, vals, bias = _inputs(rng, 1, 400, 900, 1, masked=0)
    cutoff = 0.1
    grid = BI.build_grid(T(cand), T(vals), T(bias), cutoff)
    walked, in_radius = (t.numpy() for t in BI.pair_counts(T(q), grid, cutoff))
    d2 = ((q[0, :, None] - cand[0, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(in_radius, (d2 < cutoff ** 2).sum(-1))
    assert (walked >= in_radius).all()
    assert walked.sum() < 900 * 400 / 4    # and prunes most of the rest


def test_dense_interpolation_binned_switch(rng):
    q, cand, vals, _ = _inputs(rng, 1, 200, 600, 3)
    valid = rng.random((1, 600)) > 0.2
    a = cubic_interpolation_dense(T(q), T(vals), T(cand), 0.2, T(valid),
                                  binned=True)
    b = cubic_interpolation_dense(T(q), T(vals), T(cand), 0.2, T(valid))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-5 * float(np.abs(vals).max()))
