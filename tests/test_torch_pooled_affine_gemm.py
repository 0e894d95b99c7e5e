"""The pooled MLP's affine form on the batch-norm form's GEMM passes
(``csrc/pooled_mlp.cu``), emulated on the CPU: no test here needs a card.

* ``launch_plan(..., affine=True)`` takes the affine form at
  ``chip_smoke.AFFINE_SHAPES`` and at the shapes a norm-free SetConv takes
  in either critic: the same passes as the batch-norm form, each within
  the card's shared memory and no larger than the batch-norm form's (its
  dz operand reads no z).
* The passes as the kernels run them: the forward pools from each
  neighbourhood's extremes of the top z, and the backward is the
  batch-norm backward (top_kernel's tie count through act(fmaf(z, a, b)),
  then per layer dW = x^T dz, dx = dz W^T, and S1 / S2 from dpre and
  (z - mu) ivar) with mu = 0, ivar = 1 and dz = a dpre. That equals
  ``pooled_mlp_affine_backward_plain`` and the JAX package's
  ``_bwd_pallas_affine`` in interpret mode, on tables with exact max ties
  and affines of both signs and zero; with the moments and the correction
  it is the batch-norm form's ``pooled_mlp_bn_backward_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpugan_tpu.ops.pallas.pooled_mlp_kernel import (_bwd_pallas_affine,
                                                     pooled_mlp_affine)
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

T = torch.from_numpy

# (B, M, ns, C0), widths, slope: a norm-free SetConv at each critic stage's
# table and widths (the spatial critic's four, the temporal critic's sa1 /
# sa2 over 3 frames and its pooling), and AFFINE_SHAPES
NORM_FREE = [((4, 1024, 32, 6), (64, 128), 0.01),
             ((4, 512, 32, 131), (128, 128), 0.01),
             ((4, 128, 16, 131), (128, 256), 0.01),
             ((4, 1, 128, 259), (256, 256), 0.0),
             ((12, 1024, 32, 6), (64, 128), 0.01),
             ((12, 256, 32, 131), (128, 256), 0.01),
             ((4, 1, 256, 259), (256, 256), 0.01)]
AFFINE = [(shape, widths, slope)
          for _, shape, widths, slope in chip_smoke.AFFINE_SHAPES]


@pytest.mark.parametrize("shape,widths,slope", AFFINE + NORM_FREE)
def test_launch_plan_takes_the_affine_form(shape, widths, slope):
    plan = P.launch_plan(shape, widths, slope, affine=True)
    bn = P.launch_plan(shape, widths, slope)
    key = lambda p: (p["kernel"], p["pass_"], p["layer"], p["grid"])
    assert [key(p) for p in plan["passes"]] == [key(p) for p in bn["passes"]]
    for p, q in zip(plan["passes"], bn["passes"]):
        assert p["smem"] <= q["smem"] <= P.SMEM_LIMIT
    for k in ("rows", "tile_rows", "split_rows", "part_floats", "ext_floats",
              "dw_part_floats"):
        assert plan[k] == bn[k]
    assert plan["tile_rows"] % shape[2] == 0


def test_launch_plan_refuses_a_negative_slope_in_the_affine_form():
    with pytest.raises(ValueError, match="slope"):
        P.launch_plan((2, 4, 8, 6), (16,), -0.2, affine=True)


def _fma(x, a, b):
    """fmaf in f32: the f32 product is exact in f64."""
    return (x.double() * a.double() + b.double()).float()


def _forward(table, ws, a_s, b_s, slope):
    """(pooled, zs) as the affine forward forms them: each layer's z once
    (input act(fmaf(z, a, b)) of the layer below), pooled from the top z's
    neighbourhood extremes."""
    b, m, ns, c0 = table.shape
    x, zs = table.reshape(-1, c0), []
    for l, w in enumerate(ws):
        if l:
            x = P.act(_fma(zs[-1], a_s[l - 1], b_s[l - 1]), slope)
        zs.append(x @ w)
    z = zs[-1].reshape(b, m, ns, -1)
    a, bb = a_s[-1], b_s[-1]
    ext = torch.where(a >= 0, z.amax(2), z.amin(2))
    return P.act(_fma(ext, a, bb), slope), zs


def _backward(table, ws, zs, a_s, b_s, pooled, g, slope, mus, ivars,
              correct):
    """(dtable, dws, S2s, S1s) of the batch-norm backward's passes on the
    given moments; ``correct`` False: dz = a dpre (the affine form)."""
    b, m, ns, c0 = table.shape
    rows = table.shape[0] * m * ns
    n = len(ws)
    s1s, s2s, dws = [None] * n, [None] * n, [None] * n

    def sums(q, dpre):
        zhat = (zs[q] - mus[q]) * ivars[q]
        s1s[q] = dpre.sum(0)
        s2s[q] = (dpre * zhat).sum(0)

    # top_kernel: the ties through the expression that formed pooled
    pre = _fma(zs[-1], a_s[-1], b_s[-1]).reshape(b, m, ns, -1)
    tie = P.act(pre, slope) == pooled[:, :, None]
    share = g / tie.sum(2)
    dpre = torch.where(tie, share[:, :, None] * P._act_grad(pre, slope), 0.0)
    dpre = dpre.reshape(rows, -1)
    sums(n - 1, dpre)
    for q in range(n - 1, -1, -1):
        dz = a_s[q] * dpre
        if correct:
            zhat = (zs[q] - mus[q]) * ivars[q]
            dz = a_s[q] * (dpre - s1s[q] / rows - zhat * (s2s[q] / rows))
        x = (table.reshape(rows, c0) if q == 0 else
             P.act(_fma(zs[q - 1], a_s[q - 1], b_s[q - 1]), slope))
        dws[q] = x.t() @ dz
        dx = dz @ ws[q].t()
        if q == 0:
            return dx.reshape(table.shape), dws, s2s, s1s
        pre = _fma(zs[q - 1], a_s[q - 1], b_s[q - 1])
        dpre = dx * P._act_grad(pre, slope)
        sums(q - 1, dpre)


def _inputs(rng, b, m, ns, dims, mixed):
    f = lambda *s, sc=1.0, at=0.0: (rng.standard_normal(s) * sc + at
                                    ).astype(np.float32)
    tbl = f(b, m, ns, dims[0])
    tbl[:, :, 1] = tbl[:, :, 0]                      # exact max ties
    ws = [f(dims[i], dims[i + 1], sc=dims[i] ** -0.5)
          for i in range(len(dims) - 1)]
    a_s = [f(d, sc=0.2, at=1.0) for d in dims[1:]]
    if mixed:   # an eval-mode batch norm's a = gamma / sigma of any sign
        for a in a_s:
            a[::3] *= -1
            a[1::5] = 0.0
    b_s = [f(d, sc=0.1) for d in dims[1:]]
    return tbl, ws, a_s, b_s, f


CASES = [(2, 8, 16, (7, 16, 24), 0.2, False),
         (2, 8, 16, (7, 16, 24), 0.2, True),
         (2, 4, 32, (6, 64, 128), 0.01, True),
         (1, 1, 64, (5, 8), 0.0, False)]


@pytest.mark.parametrize("b,m,ns,dims,slope,mixed", CASES)
def test_affine_backward_on_the_batch_norm_passes(rng, b, m, ns, dims, slope,
                                                  mixed):
    """Against the plain backward and the Pallas backward: f32 to 2e-4, the
    JAX package's own limit between its Pallas and reference backwards."""
    tbl, ws, a_s, b_s, f = _inputs(rng, b, m, ns, dims, mixed)
    Tt = lambda xs: [T(x) for x in xs]
    pooled, zs = _forward(T(tbl), Tt(ws), Tt(a_s), Tt(b_s), slope)
    plain = P.pooled_mlp_affine_plain(T(tbl), Tt(ws), Tt(a_s), Tt(b_s), slope)
    np.testing.assert_allclose(pooled.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    g = f(*pooled.shape)
    zeros = [torch.zeros(d) for d in dims[1:]]
    ones = [torch.ones(d) for d in dims[1:]]
    got = _backward(T(tbl), Tt(ws), zs, Tt(a_s), Tt(b_s), pooled, T(g), slope,
                    zeros, ones, correct=False)
    want = P.pooled_mlp_affine_backward_plain(T(tbl), Tt(ws), Tt(a_s),
                                              Tt(b_s), plain, T(g), slope)
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)
    jp = pooled_mlp_affine(jnp.asarray(tbl), J(ws), J(a_s), J(b_s), slope)
    pallas = _bwd_pallas_affine(jnp.asarray(tbl), J(ws), J(a_s), J(b_s),
                                slope, jp, jnp.asarray(g))
    assert pallas is not None                        # the Pallas passes ran
    flat = lambda grads: [grads[0]] + [x for grp in grads[1:] for x in grp]
    for ref in (want, pallas):
        for i, (x, y) in enumerate(zip(flat(got), flat(ref))):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                       atol=2e-4, err_msg=f"gradient {i}")


def test_passes_with_the_moments_are_the_batch_norm_backward(rng):
    """The same emulated passes, given the batch moments and the
    correction, give pooled_mlp_bn_backward_plain: the affine form is that
    backward with the correction switched off."""
    tbl, ws, gs, bts, f = _inputs(rng, 2, 8, 16, (7, 16, 24), False)
    Tt = lambda xs: [T(x) for x in xs]
    pooled, mus, _, ivars, a_s, b_s = P.pooled_mlp_bn_forward_plain(
        T(tbl), Tt(ws), Tt(gs), Tt(bts), 0.2)
    g = T(f(*pooled.shape))
    want = P.pooled_mlp_bn_backward_plain(T(tbl), Tt(ws), a_s, b_s, mus,
                                          ivars, pooled, g, 0.2)
    mine, zs = _forward(T(tbl), Tt(ws), a_s, b_s, 0.2)
    got = _backward(T(tbl), Tt(ws), zs, a_s, b_s, mine, g, 0.2, mus, ivars,
                    correct=True)
    flat = lambda grads: [grads[0]] + [x for grp in grads[1:] for x in grp]
    for i, (x, y) in enumerate(zip(flat(got), flat(want))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()),
                                   err_msg=f"gradient {i}")
