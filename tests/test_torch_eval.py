"""The port's evaluation metrics against the JAX package's on the same
numpy inputs: Gaussian MMD, the capped interpolation, the auction
assignment and its EMD, ``position_metrics`` and ``cycle_consistency``, the
particle densities (exact and capped) and the free-surface counts.

Tolerances, with their reasons:
- f32 sums in another order: 1e-5 relative, or 1e-5 of the scale of the
  terms where a difference of near-equal numbers is taken (the MMD, the
  interpolated field, the Chamfer of near-identical clouds);
- the auction: both sides are eps-optimal assignments, so each one's total
  squared-distance cost lies within n * eps of the optimum (the auction's
  guarantee; scipy's Hungarian solver gives the optimum). Bids that tie to
  f32 noise may go another way on the two sides, so the assignments, and
  the mean distances under them, are not compared one for one: the EMD
  values agree to 5e-2 relative, which holds the clouds' scale and the
  matching's quality, not its tie-breaking.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import tpugan_tpu.eval.analysis as jan
import tpugan_tpu_torch.eval.analysis as tan
from tpugan_tpu.data import sampling as jsampling
from tpugan_tpu.ops import interpolate as jinterp
from tpugan_tpu.ops import metrics as jmet
from tpugan_tpu_torch.data import sampling as tsampling
from tpugan_tpu_torch.ops import interpolate as tinterp
from tpugan_tpu_torch.ops import metrics as tmet

T = torch.from_numpy
J = jnp.asarray


def _cloud(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_gaussian_mmd_matches_jax(rng):
    """Query rows in several blocks (2,500 > the 2,048-row block)."""
    x, y = _cloud(rng, 2, 2500, 3), _cloud(rng, 2, 900, 3) + 0.05
    for blur in (0.01, 0.05):
        got = tmet.gaussian_mmd(T(x), T(y), blur).numpy()
        want = np.asarray(jmet.gaussian_mmd(J(x), J(y), blur))
        # 0.5 (kxx + kyy) - kxy: a difference of means of order 1e-2
        scale = float(np.asarray(jmet.gaussian_mmd(J(x), J(x + 10), blur)).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_capped_cubic_interpolation_matches_jax(rng):
    """k = 32 radius kNN; masked candidates; queries with no neighbour in
    range get 0; the unbatched form."""
    q, p = _cloud(rng, 2, 300, 3), _cloud(rng, 2, 800, 3)
    f = rng.standard_normal((2, 800, 3)).astype(np.float32)
    valid = rng.random((2, 800)) > 0.2
    q[:, :3] = 5.0
    for cutoff in (0.05, 0.16):
        got = tinterp.cubic_interpolation(T(q), T(f), T(p), cutoff,
                                          pos_valid=T(valid)).numpy()
        want = np.asarray(jinterp.cubic_interpolation(
            J(q), J(f), J(p), cutoff, pos_valid=J(valid)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert not got[:, :3].any()
    got = tinterp.cubic_interpolation(T(q[0]), T(f[0]), T(p[0]), 0.16).numpy()
    want = np.asarray(jinterp.cubic_interpolation(J(q[0]), J(f[0]), J(p[0]),
                                                  0.16))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _cost(x, y, assign):
    return float(((x - y[assign]) ** 2).sum())


@pytest.mark.parametrize("phases,eps,iters", [(3, 0.01, 200), (1, 0.05, 2000)])
def test_auction_matches_jax_and_scipy(rng, phases, eps, iters):
    """2 x 256 points: both sides return permutations whose squared-distance
    costs lie within n * eps of scipy's optimum (eps scaling with the
    Hungarian tail repair; and one phase, converged within its cap)."""
    x, y = _cloud(rng, 2, 256, 3), _cloud(rng, 2, 256, 3)
    got = tmet.auction_assignment(T(x), T(y), eps=eps, iters=iters,
                                  phases=phases).numpy()
    want = np.asarray(jmet.auction_assignment(J(x), J(y), eps=eps, iters=iters,
                                              phases=phases))
    n = x.shape[1]
    for bi in range(2):
        r, c = linear_sum_assignment(((x[bi, :, None] - y[bi, None]) ** 2).sum(-1))
        opt = _cost(x[bi], y[bi], c[np.argsort(r)])
        for a in (got[bi], want[bi]):
            assert sorted(a) == list(range(n))
            assert _cost(x[bi], y[bi], a) <= opt + n * eps
    assert got.dtype == np.int64


def test_auction_repair_fills_the_tail(rng):
    """A cap too small to converge: the repair still returns a permutation
    (on both sides), and duplicate claims handed to it are demoted."""
    x, y = _cloud(rng, 1, 300, 3), _cloud(rng, 1, 300, 3)
    got = tmet.auction_assignment(T(x), T(y), eps=1e-4, iters=2,
                                  phases=3).numpy()
    want = np.asarray(jmet.auction_assignment(J(x), J(y), eps=1e-4, iters=2,
                                              phases=3))
    assert sorted(got[0]) == sorted(want[0]) == list(range(300))
    dup = np.arange(300)[None].copy()
    dup[0, 1] = 0
    dup[0, 7] = -1
    fixed = tmet._repair_assignment_tail(T(x), T(y), T(dup)).numpy()
    assert sorted(fixed[0]) == list(range(300))
    np.testing.assert_array_equal(
        fixed, np.asarray(jmet._repair_assignment_tail(J(x), J(y), J(dup))))


def test_auction_counts_its_rounds(rng):
    """A cloud matched to itself takes one round (each bidder's best object
    is its own point, no two alike); a one-phase auction stops at its
    budget of ``iters`` rounds."""
    x = _cloud(rng, 1, 128, 3)
    tmet.auction_rounds = 0
    got = tmet.auction_assignment(T(x), T(x), eps=0.01, iters=50)
    assert tmet.auction_rounds == 1
    np.testing.assert_array_equal(got.numpy()[0], np.arange(128))
    tmet.auction_rounds = 0
    tmet.auction_assignment(T(x), T(_cloud(rng, 1, 128, 3)), eps=1e-6, iters=3)
    assert 1 <= tmet.auction_rounds <= 3


def test_emd_loss_matches_jax(rng):
    """A permuted copy plus noise: EMD within the auction's tolerance, and
    the gradient reaches the prediction."""
    x = _cloud(rng, 2, 256, 3)
    y = x[:, rng.permutation(256)] + _cloud(rng, 2, 256, 3, scale=0.01)
    p = T(x).requires_grad_()
    got = tmet.emd_loss(p, T(y), eps=0.01, iters=200, phases=3)
    want = np.asarray(jmet.emd_loss(J(x), J(y), eps=0.01, iters=200,
                                    phases=3))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-2)
    # the loss is the distance sum under the (deterministic) auction
    # assignment, whose squared cost lies within n * eps of scipy's optimum
    assign = tmet.auction_assignment(T(x), T(y), eps=0.01, iters=200,
                                     phases=3).numpy()
    for bi in range(2):
        d = np.sqrt(((x[bi] - y[bi][assign[bi]]) ** 2).sum(-1))
        np.testing.assert_allclose(float(got[bi].detach()), d.sum(), rtol=1e-5)
        r, c = linear_sum_assignment(((x[bi, :, None] - y[bi, None]) ** 2).sum(-1))
        assert (_cost(x[bi], y[bi], assign[bi])
                <= _cost(x[bi], y[bi], c[np.argsort(r)]) + 256 * 0.01)
    got.sum().backward()
    assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0


def test_position_metrics_masked_prediction_matches_jax(rng):
    """A prediction padded to a bucket with the 999 sentinel and a mask,
    against a ground truth of another size."""
    gt = _cloud(rng, 700, 3)
    pred = gt[:500] + _cloud(rng, 500, 3, scale=0.01)
    padded, valid = tsampling.pad_with_appropriate_size(pred, bucket=256)
    assert padded.shape == (512, 3) and valid.sum() == 500
    kw = dict(emd_iters=300, emd_eps=0.01)
    cd, emd, mmd = tan.position_metrics(T(padded[None]), T(gt[None]),
                                        pred_valid=T(valid[None]), **kw)
    jcd, jemd, jmmd = jan.position_metrics(J(padded[None]), J(gt[None]),
                                           pred_valid=J(valid[None]), **kw)
    np.testing.assert_allclose(cd, jcd, rtol=1e-5)
    np.testing.assert_allclose(emd, jemd, rtol=5e-2)
    np.testing.assert_allclose(mmd, jmmd, rtol=0, atol=1e-6)


def _fixed_sr_apply(module):
    """A deterministic stand-in for the generator, written once per
    framework: r = 4 copies of each input point moved by fixed offsets
    scaled by the feature's velocity channels."""
    offsets = (np.random.default_rng(5).standard_normal((4, 3)) * 0.02
               ).astype(np.float32)

    def apply(feature, pos):
        b, n, _ = pos.shape
        if module == "torch":
            scale = 1.0 + feature[..., 3:].abs().sum(-1, keepdim=True)
            out = pos[:, :, None] + T(offsets) * scale[:, :, None]
            return out.reshape(b, n * 4, 3)
        scale = 1.0 + jnp.abs(feature[..., 3:]).sum(-1, keepdims=True)
        out = pos[:, :, None] + J(offsets) * scale[:, :, None]
        return out.reshape(b, n * 4, 3)
    return apply


def test_cycle_consistency_matches_jax(rng):
    low = _cloud(rng, 2, 1, 128, 3)
    vel = _cloud(rng, 2, 1, 128, 3, scale=1.0)
    high = _cloud(rng, 1, 1024, 3)
    adv = _cloud(rng, 1, 1024, 3, scale=0.01)
    args = lambda conv: (conv(low[0]), conv(low[1]), conv(adv), conv(high))
    kw = dict(cutoff=0.1, use_vel=True, emd_iters=200, emd_eps=0.01)
    got = tan.cycle_consistency(_fixed_sr_apply("torch"), *args(T),
                                lowres_vel_left=T(vel[0]),
                                lowres_vel_right=T(vel[1]), **kw)
    want = jan.cycle_consistency(_fixed_sr_apply("jax"), *args(J),
                                 lowres_vel_left=J(vel[0]),
                                 lowres_vel_right=J(vel[1]), **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)


def _density_tol(query, cand, cutoff, exact):
    """Exact form: f32 sums, 1e-5 relative. Capped form: its distances are
    the kNN's |q|^2 + |c|^2 - 2 q.c, rounded in another order on the two
    sides (about 2.4e-7 of max |p|^2 apart), and the spline's slope in d2
    reaches 6 / cutoff^2; so up to that much per in-radius neighbour."""
    if exact:
        return dict(rtol=1e-5, atol=1e-6)
    d2 = ((query[:, None] - cand[None]) ** 2).sum(-1)
    n_max = int((d2 < cutoff ** 2).sum(-1).max())
    per = 6.0 / cutoff ** 2 * 2.4e-7 * float((cand ** 2).sum(-1).max())
    return dict(rtol=0, atol=n_max * per)


@pytest.mark.parametrize("dense", [True, False])
def test_particle_densities_match_jax(rng, dense):
    """Exact (the cell-grid kernel's plain version against the JAX binned
    or chunked dense kernel) and capped (k = 64 radius kNN) densities of a
    cloud, and of the cloud sampled on a grid. At this density no particle
    has 64 neighbours in radius, so the two forms also agree."""
    pos = ((rng.random((1500, 3)) - 0.5) * 0.5).astype(np.float32)
    g = np.linspace(-0.25, 0.25, 8, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    for cutoff in (0.05, 0.08):
        got = tan.get_particle_density(pos, cutoff, dense=dense, device="cpu")
        want = np.asarray(jan.get_particle_density(pos, cutoff, dense=dense))
        assert got.shape == (1500, 1)
        np.testing.assert_allclose(got, want,
                                   **_density_tol(pos, pos, cutoff, dense))
        got_g = tan.particle_dns2grid_dns(grid, pos, cutoff, dense=dense,
                                          device="cpu")
        want_g = np.asarray(jan.particle_dns2grid_dns(grid, pos, cutoff,
                                                      dense=dense))
        np.testing.assert_allclose(got_g, want_g,
                                   **_density_tol(grid, pos, cutoff, dense))
    other = tan.get_particle_density(pos, 0.08, dense=not dense, device="cpu")
    np.testing.assert_allclose(other, got,
                               **_density_tol(pos, pos, 0.08, False))


def test_density_defaults_to_the_card():
    pos = np.zeros((10, 3), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tan.get_particle_density(pos, 0.05)


def test_free_surface_counts_match_jax(rng):
    gt = (rng.random((3000, 3)) * 0.4).astype(np.float32)
    pred = gt[:2500] + _cloud(rng, 2500, 3, scale=0.005)
    assert (tan.free_surface_particle_counts(pred, gt)
            == jan.free_surface_particle_counts(pred, gt))
    assert (tan.free_surface_particle_count_diff(pred, gt, 0.03)
            == jan.free_surface_particle_count_diff(pred, gt, 0.03))
    np.testing.assert_array_equal(
        tsampling.get_free_surface_particles(gt, 0.025),
        jsampling.get_free_surface_particles(gt, 0.025))


def test_host_helpers_match_jax(rng):
    y = rng.standard_normal(12)
    np.testing.assert_array_equal(tan.get_1st_derivative(y, 1),
                                  jan.get_1st_derivative(y, 1))
    np.testing.assert_array_equal(tan.get_2nd_derivative(y, 2),
                                  jan.get_2nd_derivative(y, 2))
    field = rng.standard_normal(64)
    grid = np.zeros((4, 4, 4))
    for a, b in zip(tan.eval_spatial_grid_gradient(field, grid),
                    jan.eval_spatial_grid_gradient(field, grid)):
        np.testing.assert_array_equal(a, b)
    pcd, ref = _cloud(rng, 50, 3), _cloud(rng, 30, 3)
    for a, b in zip(tan.nearest_set(pcd, ref), jan.nearest_set(pcd, ref)):
        np.testing.assert_array_equal(a, b)
