"""Parity of the PyTorch port's kernel functions with the JAX package.

The same numpy inputs go through the JAX function (the Pallas kernel in
interpret mode, as tests/test_pallas_kernels.py runs it, and the XLA path)
and the port's counterpart on the CPU, which is the kernel's plain PyTorch
version. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_port.py, marked gpu, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.metrics import chamfer as jax_chamfer
from tpugan_tpu.ops.neighbors import knn as jax_knn
from tpugan_tpu.ops.pallas.edgeconv_kernel import edgeconv_fused as jax_edgeconv
from tpugan_tpu.ops.pallas.knn_kernel import knn_pallas
from tpugan_tpu.ops.pallas.nn1_kernel import nn1_pallas
from tpugan_tpu_torch.ops.kernels.edgeconv import edgeconv_fused
from tpugan_tpu_torch.ops.metrics import chamfer, nearest_neighbor
from tpugan_tpu_torch.ops.neighbors import knn

T = torch.from_numpy


def _assert_same_neighbors(q, c, idx_a, idx_b, tol):
    """Index lists may differ only between candidates whose exact distances
    to the query tie within ``tol`` (f32 noise of the distance formula)."""
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    b, r, s = np.nonzero(idx_a != idx_b)
    exact = lambda idx: np.sum((q[b, r].astype(np.float64)
                                - c[b, idx[b, r, s]].astype(np.float64)) ** 2, -1)
    gap = np.abs(exact(idx_a) - exact(idx_b))
    assert gap.size == 0 or gap.max() <= tol, (gap.max(), gap.size)


@pytest.mark.parametrize("d,k", [(3, 20), (32, 20), (64, 12), (64, 4)])
def test_knn_matches_jax_with_mask(rng, d, k):
    # the serving path's widths and k; a masked tail of candidates
    q = rng.standard_normal((2, 200, d)).astype(np.float32)
    c = rng.standard_normal((2, 300, d)).astype(np.float32)
    valid = np.ones((2, 300), bool)
    valid[:, 250:] = False
    valid[1, :40] = False
    # tolerance: f32 rounding of |q|^2 + |c|^2 - 2 q.c at these magnitudes
    tol = 1e-5 * float(np.max(np.sum(q ** 2, -1)) + np.max(np.sum(c ** 2, -1)))

    d2_t, idx_t = knn(T(q), T(c), k=k, c_valid=T(valid))
    d2_x, idx_x = jax_knn(jnp.asarray(q), jnp.asarray(c), k=k,
                          c_valid=jnp.asarray(valid))
    bias = jnp.where(jnp.asarray(valid), 0.0, 1e10)
    d2_p, idx_p = knn_pallas(jnp.asarray(q), jnp.asarray(c), bias, k)

    assert idx_t.dtype == torch.int64 and d2_t.dtype == torch.float32
    assert np.all(valid[np.arange(2)[:, None, None], idx_t.numpy()])
    for d2_j, idx_j in ((d2_x, idx_x), (d2_p, idx_p)):
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=0,
                                   atol=tol)
        _assert_same_neighbors(q, c, idx_t.numpy(), idx_j, tol)


def test_knn_more_neighbors_than_candidates(rng):
    # k > Nc: BIG distances repeating the last index, as the XLA path pads
    q = rng.standard_normal((1, 10, 3)).astype(np.float32)
    c = rng.standard_normal((1, 5, 3)).astype(np.float32)
    d2_t, idx_t = knn(T(q), T(c), k=8)
    d2_x, idx_x = jax_knn(jnp.asarray(q), jnp.asarray(c), k=8)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_x))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_x), rtol=1e-6,
                               atol=1e-6)
    assert np.all(d2_t.numpy()[..., 5:] == 1e10)


def test_knn_ties_follow_index_order():
    # grid coordinates make every distance exact in f32: many exact ties,
    # which must come out in candidate-index order, as a stable argsort
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
    pts = np.concatenate([g.reshape(-1, 3)] * 2)[None].astype(np.float32)
    d2_t, idx_t = knn(T(pts), k=12)
    exact = np.sum((pts[0][:, None] - pts[0][None]) ** 2, -1)
    order = np.argsort(exact, axis=1, kind="stable")[:, :12]
    np.testing.assert_array_equal(idx_t.numpy()[0], order)
    _, idx_p = knn_pallas(jnp.asarray(pts), jnp.asarray(pts),
                          jnp.zeros(pts.shape[:2]), 12)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))


# the serving path's EdgeConv configurations: (C, H, O or None for no MLP, K)
_EDGECONV = {
    "extractor": (6, 64, 128, 20, "max"),
    "idgcn": (32, 16, 32, 20, "max"),
    "idgcn_dilated": (32, 16, 32, 10, "max"),
    "upsampler": (64, 128, 256, 12, "max"),
    "mask_sum": (64, 128, None, 8, "sum"),
    "min": (16, 8, 8, 6, "min"),
    "mean_no_mlp": (16, 8, None, 6, "mean"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(_EDGECONV))
def test_edgeconv_matches_jax(rng, config, dtype):
    c, h, o, k, agg = _EDGECONV[config]
    n = 64
    nbr = rng.standard_normal((1, k, n, c)).astype(np.float32)
    ctr = rng.standard_normal((1, n, c)).astype(np.float32)
    w = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
    wn, we = w(c, h), w(c, h)
    w1, w2 = (w(h, h), w(h, o)) if o is not None else (None, None)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    out_t = edgeconv_fused(*[None if a is None else T(a)
                             for a in (nbr, ctr, wn, we, w1, w2)],
                           aggregate=agg, compute_dtype=tdt)
    out_j = jax_edgeconv(jnp.asarray(nbr, jdt), jnp.asarray(ctr, jdt), wn, we,
                         w1, w2, aggregate=agg, compute_dtype=jdt)
    assert out_t.dtype == tdt and tuple(out_t.shape) == out_j.shape
    ref = np.asarray(out_j.astype(jnp.float32))
    scale = float(np.abs(ref).max())
    # f32: summation order only. bf16: both round every layer to bf16 at
    # the same places; an f32 sum that lands on the other side of a bf16
    # rounding boundary moves one value by one bf16 ulp (2^-8 relative),
    # which the next layers carry.
    tol = 1e-5 * scale if dtype == "float32" else 2e-2 * scale
    np.testing.assert_allclose(out_t.float().numpy(), ref, rtol=0, atol=tol)


def test_nn1_and_chamfer_match_jax(rng):
    a = (rng.standard_normal((2, 300, 3)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((2, 260, 3)) * 0.3).astype(np.float32)
    a_valid = rng.random((2, 300)) > 0.2
    b_valid = rng.random((2, 260)) > 0.2
    tol = 1e-6   # f32 rounding of distances between points of norm ~1

    d2_t, idx_t = nearest_neighbor(T(a), T(b), c_valid=T(b_valid))
    bias = jnp.where(jnp.asarray(b_valid), 0.0, 1e10)
    d2_p, idx_p = nn1_pallas(jnp.asarray(a), jnp.asarray(b), bias)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=0, atol=tol)
    _assert_same_neighbors(a, b, idx_t.numpy()[..., None],
                           np.asarray(idx_p)[..., None], tol)
    assert np.all(b_valid[np.arange(2)[:, None], idx_t.numpy()])

    cd_t = chamfer(T(a), T(b), a_valid=T(a_valid), b_valid=T(b_valid))
    cd_j = jax_chamfer(jnp.asarray(a), jnp.asarray(b),
                       a_valid=jnp.asarray(a_valid),
                       b_valid=jnp.asarray(b_valid))
    # per-cloud sums of ~500 squared distances
    np.testing.assert_allclose(cd_t.numpy(), np.asarray(cd_j), rtol=1e-5)
    one_way = chamfer(T(a), T(b), bidirectional=False)
    np.testing.assert_allclose(
        one_way.numpy(),
        np.asarray(jax_chamfer(jnp.asarray(a), jnp.asarray(b),
                               bidirectional=False)), rtol=1e-5)
