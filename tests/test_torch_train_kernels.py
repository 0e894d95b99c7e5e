"""Parity of the train step's kernel functions in the PyTorch port with the
JAX package: FPS, ball query, the pooled MLP (forward, moments, backward,
affine form) and the dense SPH interpolation.

The same numpy inputs go through the JAX function (the XLA path, and the
Pallas kernel in interpret mode as tests/test_pallas_kernels.py runs it)
and the port's counterpart on the CPU, which is the kernel's plain PyTorch
version. The CUDA kernels are held against these plain versions on the
card (tests/test_torch_port.py, marked gpu, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops import interpolate as jax_interp
from tpugan_tpu.ops import neighbors as jax_nb
from tpugan_tpu.ops.interpolate import cubic_interpolation_dense as jax_dense
from tpugan_tpu.ops.neighbors import ball_query as jax_ball_query
from tpugan_tpu.ops.neighbors import fps as jax_fps
from tpugan_tpu.ops.pallas.ball_query_kernel import ball_query_pallas
from tpugan_tpu.ops.pallas.fps_kernel import fps_pallas
from tpugan_tpu.ops.pallas.interp_kernel import kernel_interp_pallas
from tpugan_tpu.ops.pallas.pooled_mlp_kernel import (pooled_mlp_affine as
                                                     jax_affine)
from tpugan_tpu.ops.pallas.pooled_mlp_kernel import (pooled_mlp_bn_train as
                                                     jax_bn_train)
from tpugan_tpu_torch.ops import neighbors as port_nb
from tpugan_tpu_torch.ops.interpolate import cubic_interpolation_dense
from tpugan_tpu_torch.ops.kernels.interp import interp_kernel, sph_weight
from tpugan_tpu_torch.ops.kernels.pooled_mlp import (pooled_mlp_affine,
                                                     pooled_mlp_bn_train)
from tpugan_tpu_torch.ops.neighbors import ball_query, fps

T = torch.from_numpy


# ---------------------------------------------------------------- FPS

@pytest.mark.parametrize("masked", [False, True])
def test_fps_matches_jax_indices(rng, masked):
    # indices must agree exactly: both sides use the direct difference
    b, n, m = 3, 257, 40
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    valid = np.ones((b, n), bool)
    if masked:
        valid[:, ::3] = False
        valid[1, :10] = False          # row 1's start (index 0) is invalid
        pos[~valid] = 999.0            # sentinel dummies, far from the cloud
    v = valid if masked else None
    got = fps(T(pos), m, valid=T(valid) if masked else None).numpy()
    ref = np.asarray(jax_fps(jnp.asarray(pos), m,
                             valid=jnp.asarray(v) if masked else None))
    np.testing.assert_array_equal(got, ref)
    if masked:
        assert valid[np.arange(b)[:, None], got].all()
        assert got[1, 0] == 10          # moved to the first valid point


def test_fps_matches_pallas_with_random_starts(rng):
    b, n, m = 4, 300, 64
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    start = rng.integers(0, n, b)
    pen = np.zeros((b, n), np.float32)
    pen[2, 100:] = -1e10
    ref = np.asarray(fps_pallas(jnp.asarray(pos), m, jnp.asarray(pen),
                                jnp.asarray(start, jnp.int32)))
    from tpugan_tpu_torch.ops.kernels.fps import fps_kernel
    got = fps_kernel(T(pos), m, T(pen), T(start)).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- ball query

def _radius_clear_of_pairs(q, c, r0, gap=1e-5):
    """A radius near r0 whose r^2 lies at least ``gap`` from every pair's
    exact squared distance, so f32 rounding cannot flip a membership."""
    d2 = np.sum((q[:, :, None].astype(np.float64)
                 - c[:, None].astype(np.float64)) ** 2, -1)
    for r in r0 * (1.0 + 0.0137 * np.arange(50)):
        r2 = float(np.float32(r) ** 2)
        if np.abs(d2 - r2).min() >= gap:
            return float(r)
    raise AssertionError("no clear radius")


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_matches_jax_indices(rng, masked):
    b, nq, nc, ns = 2, 60, 400, 16
    q = (rng.standard_normal((b, nq, 3)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((b, nc, 3)) * 0.5).astype(np.float32)
    q[0, :4] = 50.0                                      # empty balls
    valid = rng.random((b, nc)) > 0.3 if masked else np.ones((b, nc), bool)
    r = _radius_clear_of_pairs(q, c, 0.3)
    got = ball_query(T(q), T(c), r, ns,
                     c_valid=T(valid) if masked else None).numpy()
    ref = np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), r, ns,
                                    c_valid=jnp.asarray(valid) if masked
                                    else None))
    bias = np.where(valid, 0.0, 2.0).astype(np.float32)
    ref_p = np.asarray(ball_query_pallas(jnp.asarray(q), jnp.asarray(c), r, ns,
                                         jnp.asarray(bias)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_p)
    assert (got[0, :4] == 0).all()                       # empty -> index 0
    # every index is a valid candidate, or the 0 of an empty ball
    assert (valid[np.arange(b)[:, None, None], got] | (got == 0)).all()


# ---------------------------------------------------------------- pooled MLP

def _pooled_inputs(rng, c0=6, hs=(8, 16), b=2, m=4, ns=8, ties=True):
    tbl = rng.standard_normal((b, m, ns, c0)).astype(np.float32)
    if ties:   # repeated neighbours, as a ball query pads: exact max ties
        tbl[:, :, 1] = tbl[:, :, 0]
        tbl[:, :, 5] = tbl[:, :, 0]
    cs = (c0,) + tuple(hs)
    ws = [(rng.standard_normal((cs[i], cs[i + 1])) / np.sqrt(cs[i]))
          .astype(np.float32) for i in range(len(hs))]
    gam = [(1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32) for h in hs]
    bet = [(0.2 * rng.standard_normal(h)).astype(np.float32) for h in hs]
    g = rng.standard_normal((b, m, hs[-1])).astype(np.float32)
    return tbl, ws, gam, bet, g


@pytest.mark.parametrize("slope", [0.0, 0.01])
def test_pooled_mlp_bn_train_matches_jax(rng, slope):
    """Forward, moments and all four gradients against the Pallas kernel
    (interpret mode) and its custom VJP. Tolerance 2e-5 relative to each
    tensor's scale: f32 summation order (matmuls, moment sums)."""
    tbl, ws, gam, bet, g = _pooled_inputs(rng)

    def jfn(t, w, ga, be):
        p, mu, var = jax_bn_train(t, w, ga, be, slope=slope)
        return p, (mu, var)

    args = (jnp.asarray(tbl), [jnp.asarray(w) for w in ws],
            [jnp.asarray(x) for x in gam], [jnp.asarray(x) for x in bet])
    p_j, (mu_j, var_j) = jfn(*args)
    _, vjp = jax.vjp(lambda *a: jfn(*a)[0], *args)
    dt_j, dw_j, dg_j, db_j = vjp(jnp.asarray(g))

    t = T(tbl).requires_grad_()
    w_t = [T(w).requires_grad_() for w in ws]
    g_t = [T(x).requires_grad_() for x in gam]
    b_t = [T(x).requires_grad_() for x in bet]
    p_t, mu_t, var_t = pooled_mlp_bn_train(t, w_t, g_t, b_t, slope)
    assert not any(x.requires_grad for x in mu_t + var_t)
    (p_t * T(g)).sum().backward()

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))

    close(p_t, p_j)
    for a, b in zip(mu_t + var_t, list(mu_j) + list(var_j)):
        close(a, b)
    close(t.grad, dt_j)
    for a, b in zip([x.grad for x in w_t + g_t + b_t],
                    list(dw_j) + list(dg_j) + list(db_j)):
        close(a, b)


def test_pooled_mlp_affine_matches_jax(rng):
    tbl, ws, a_s, b_s, _ = _pooled_inputs(rng, c0=7, hs=(16, 24), ns=16)
    ref = jax_affine(jnp.asarray(tbl), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(x) for x in a_s],
                     [jnp.asarray(x) for x in b_s], slope=0.2)
    with torch.no_grad():
        got = pooled_mlp_affine(T(tbl), [T(w) for w in ws],
                                [T(x) for x in a_s], [T(x) for x in b_s], 0.2)
    # f32 summation order of the matmuls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(ref)).max())


def test_pooled_mlp_affine_refuses_gradients(rng):
    """The affine form's gradients (``_bwd_pallas_affine``'s counterpart)
    with respect to the table, the weights and the affines, over exact max
    ties, against ``jax.vjp`` of the JAX package's op, to the f32
    summation order."""
    tbl, ws, a_s, b_s, g = _pooled_inputs(rng)
    leaves = [T(x).requires_grad_() for x in [tbl, *ws, *a_s, *b_s]]
    out = pooled_mlp_affine(leaves[0], leaves[1:3], leaves[3:5], leaves[5:7])
    got = torch.autograd.grad(out, leaves, T(g))
    J = lambda xs: [jnp.asarray(x) for x in xs]
    _, vjp = jax.vjp(lambda t, w, a, bb: jax_affine(t, w, a, bb, 0.0),
                     jnp.asarray(tbl), J(ws), J(a_s), J(b_s))
    dt, dws, das, dbs = vjp(jnp.asarray(g))
    for x, y in zip(got, [dt, *dws, *das, *dbs]):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(y).max()))


# ---------------------------------------------------------------- interp

@pytest.mark.parametrize("kind", ["bicubic", "spline1", "linear",
                                  "exponential"])
def test_interp_matches_pallas(rng, kind):
    """out and den against kernel_interp_pallas: masked candidates and
    isolated 999-sentinel queries (den = 1e-6, out = 0). Tolerance 1e-5
    of the value scale: f32 summation order."""
    b, nq, m, cutoff = 2, 70, 150, 0.5
    q = (rng.standard_normal((b, nq, 3)) * 0.4).astype(np.float32)
    q[:, :5] = 999.0
    c = (rng.standard_normal((b, m, 3)) * 0.4).astype(np.float32)
    v = rng.standard_normal((b, m, 3)).astype(np.float32)
    bias = np.where(rng.random((b, m)) < 0.2, 1e10, 0.0).astype(np.float32)
    out_j, den_j = kernel_interp_pallas(jnp.asarray(q), jnp.asarray(c),
                                        jnp.asarray(v), cutoff,
                                        jnp.asarray(bias), kind=kind)
    out_t, den_t = interp_kernel(T(q), T(c), T(v), cutoff, T(bias), kind)
    den_j = np.asarray(den_j)
    np.testing.assert_allclose(den_t.numpy(), den_j, rtol=1e-5,
                               atol=1e-5 * np.abs(den_j).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5 * np.abs(v).max())
    assert np.allclose(den_t.numpy()[:, :5], 1e-6)
    assert (out_t.numpy()[:, :5] == 0).all()


def test_cubic_interpolation_dense_matches_jax(rng):
    b, nq, m, cutoff = 2, 80, 200, 0.5
    q = (rng.standard_normal((b, nq, 3)) * 0.4).astype(np.float32)
    q[1, :3] = 999.0
    c = (rng.standard_normal((b, m, 3)) * 0.4).astype(np.float32)
    field = rng.standard_normal((b, m, 3)).astype(np.float32)
    valid = rng.random((b, m)) > 0.1
    ref = jax_dense(jnp.asarray(q), jnp.asarray(field), jnp.asarray(c), cutoff,
                    pos_valid=jnp.asarray(valid))
    got = cubic_interpolation_dense(T(q), T(field), T(c), cutoff,
                                    pos_valid=T(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(field).max())


@pytest.mark.parametrize("name", ["bicubic_kernel", "linear_kernel",
                                  "exponential_kernel"])
def test_sph_kernels_match_jax(name):
    """The interp kernel's weight of a squared distance against the JAX
    package's SPH function of the distance, within the cutoff (the kernels
    weigh nothing beyond it; the JAX Gaussian has no cutoff of its own)."""
    cutoff = 0.16
    r = np.linspace(0.0, 0.2, 101).astype(np.float32)
    kind = name.split("_")[0]
    got = sph_weight(T(r * r), cutoff, kind).numpy()
    want = np.asarray(getattr(jax_interp, name)(jnp.asarray(r), cutoff))
    inside = r <= cutoff
    # f32 powers of q from r^2 in another order
    np.testing.assert_allclose(got[inside], want[inside], rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert (got[~inside] == 0).all()


# ---------------------------------------------------------------- radius ops

@pytest.mark.parametrize("include_self", [True, False])
def test_radius_count_and_mask_knn_match_jax(rng, include_self):
    """Radius counts (capped, masked) and radius-masked kNN against the JAX
    functions, on a radius clear of every pair's distance."""
    q = (rng.standard_normal((2, 50, 3)) * 0.3).astype(np.float32)
    c = np.concatenate([q, (rng.standard_normal((2, 70, 3)) * 0.3)
                        .astype(np.float32)], 1)
    valid = rng.random((2, 120)) > 0.2
    r = _radius_clear_of_pairs(q, c[:, 50:], 0.15)
    got = port_nb.radius_count(T(q), T(c), r, cap=6, c_valid=T(valid),
                               include_self=include_self).numpy()
    want = np.asarray(jax_nb.radius_count(jnp.asarray(q), jnp.asarray(c), r,
                                          cap=6, c_valid=jnp.asarray(valid),
                                          include_self=include_self))
    np.testing.assert_array_equal(got, want)
    d2, idx, inr = port_nb.radius_mask_knn(T(q), T(c), k=8, radius=r,
                                           c_valid=T(valid))
    d2_j, idx_j, inr_j = jax_nb.radius_mask_knn(jnp.asarray(q), jnp.asarray(c),
                                                k=8, radius=r,
                                                c_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(inr.numpy(), np.asarray(inr_j))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), rtol=0, atol=1e-6)
