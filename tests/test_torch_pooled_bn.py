"""The pooled-MLP batch-norm train op of the PyTorch port at the spatial
critic's four stage widths, against the JAX package; the max-from-extremes
identity its kernels pool by; and the kernels' launch plan.

The JAX function runs its Pallas kernel in interpret mode, as
tests/test_torch_train_kernels.py runs it; the port's counterpart on the
CPU is the kernels' plain version. The CUDA kernels are held against the
plain version on the card (tests/test_torch_port.py, marked gpu, and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.pooled_mlp_kernel import (pooled_mlp_bn_train as
                                                     jax_bn_train)
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

T = torch.from_numpy

# (stage, (B, M, ns, C0), widths, slope): the spatial critic's stages with
# its channel widths and neighbourhood sizes, B and M cut down
STAGES = [
    ("sa_0", (2, 2, 32, 6), (64, 128), 0.01),
    ("sa_1", (2, 2, 32, 131), (128, 128), 0.01),
    ("sa_2", (2, 2, 16, 131), (128, 256), 0.01),
    ("sa_pooling", (2, 1, 128, 259), (256, 256), 0.0),
]
# the same stages at the critic's full table sizes, for the launch plan
FULL = [((4, 1024, 32, 6), (64, 128), 0.01),
        ((4, 512, 32, 131), (128, 128), 0.01),
        ((4, 128, 16, 131), (128, 256), 0.01),
        ((4, 1, 128, 259), (256, 256), 0.0)]


def _gammas(rng, widths, mode):
    """Per-layer gammas: around 1 ("positive"), around -1 ("negative"), all
    0 ("zero"), or of both signs with zeros ("mixed"), as trained critics
    may hold them."""
    out = []
    for h in widths:
        g = (1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32)
        if mode == "negative":
            g = -g
        elif mode == "zero":
            g = np.zeros(h, np.float32)
        elif mode == "mixed":
            g[::3] *= -1
            g[1::5] = 0.0
        out.append(g)
    return out


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("mode", ["positive", "negative", "zero", "mixed"])
@pytest.mark.parametrize("slope", [0.0, 0.01])
def test_max_from_extremes_is_exact(rng, slope, mode):
    """max over ns of act(z a + b) equals act(max z a + b) for a >= 0 and
    act(min z a + b) for a < 0, bit for bit, over exact ties (repeated
    rows) and a = 0; the plain forward pools this way."""
    b, m, ns, h = 3, 16, 32, 96
    z = rng.standard_normal((b, m, ns, h)).astype(np.float32)
    z[:, :, 5] = z[:, :, 0]
    z[:, :, 9] = z[:, :, 0]
    z[:, ::4, :] = z[:, ::4, :1]           # whole neighbourhoods of ties
    a = _gammas(rng, [h], mode)[0] * 3.0
    bias = (0.3 * rng.standard_normal(h)).astype(np.float32)
    zt, at, bt = T(z), T(a), T(bias)
    direct = P.act(zt * at + bt, slope).amax(dim=2)
    got = P.pool_from_extremes(zt.amax(dim=2), zt.amin(dim=2), at, bt, slope)
    assert torch.equal(got, direct)


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("stage,shape,widths,slope", STAGES,
                         ids=[s[0] for s in STAGES])
def test_pooled_mlp_bn_train_matches_jax_at_stage_widths(rng, stage, shape,
                                                         widths, slope):
    """Pooled output, moments and the gradients of the table, weights,
    gammas and betas against the Pallas kernel (interpret mode) and its
    custom VJP, with gammas of both signs and zero. Tolerance 2e-5 of each
    tensor's scale: f32 summation order (matmuls, moment sums)."""
    b, m, ns, c0 = shape
    tbl = rng.standard_normal(shape).astype(np.float32)
    tbl[:, :, 1] = tbl[:, :, 0]            # a ball query's repeated first hit
    tbl[:, :, -1] = tbl[:, :, 0]
    cs = (c0,) + widths
    ws = [(rng.standard_normal((cs[i], cs[i + 1])) / np.sqrt(cs[i]))
          .astype(np.float32) for i in range(len(widths))]
    gam = _gammas(rng, widths, "mixed")
    bet = [(0.2 * rng.standard_normal(h)).astype(np.float32) for h in widths]
    g = rng.standard_normal((b, m, widths[-1])).astype(np.float32)

    J = lambda xs: [jnp.asarray(x) for x in xs]
    args = (jnp.asarray(tbl), J(ws), J(gam), J(bet))
    p_j, mu_j, var_j = jax_bn_train(*args, slope=slope)
    _, vjp = jax.vjp(lambda *a: jax_bn_train(*a, slope=slope)[0], *args)
    dt_j, dw_j, dg_j, db_j = vjp(jnp.asarray(g))

    leaves = [T(x).requires_grad_() for x in [tbl, *ws, *gam, *bet]]
    nl = len(widths)
    p_t, mu_t, var_t = P.pooled_mlp_bn_train(
        leaves[0], leaves[1:1 + nl], leaves[1 + nl:1 + 2 * nl],
        leaves[1 + 2 * nl:], slope)
    (p_t * T(g)).sum().backward()

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))

    close(p_t, p_j)
    for x, y in zip(mu_t + var_t, list(mu_j) + list(var_j)):
        close(x, y)
    for x, y in zip([v.grad for v in leaves],
                    [dt_j, *dw_j, *dg_j, *db_j]):
        close(x, y)


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("shape,widths,slope", FULL,
                         ids=[s[0] for s in STAGES])
def test_launch_plan_fits_the_card(shape, widths, slope):
    """Every pass at the critic's table sizes: shared memory per block
    within the H100's 232,448 bytes, forward row tiles of whole
    neighbourhoods, dW splits that cover every row once."""
    plan = P.launch_plan(shape, widths, slope)
    b, m, ns, c0 = shape
    assert plan["rows"] == b * m * ns
    assert all(p["smem"] <= P.SMEM_LIMIT for p in plan["passes"])
    assert plan["tile_rows"] % ns == 0 and plan["tile_rows"] <= P.ROW_TILE
    kernels = [(p["kernel"], p["pass_"], p["layer"]) for p in plan["passes"]]
    n = len(widths)
    assert kernels[:n] == [("rows_gemm", "forward", l) for l in range(n)]
    assert kernels[n] == ("top_kernel", "backward", n - 1)
    for q, r in enumerate(plan["split_rows"]):
        assert r % P.BK == 0
        dw = next(p for p in plan["passes"]
                  if p["kernel"] == "dw_gemm" and p["layer"] == q)
        assert (dw["grid"][2] - 1) * r < plan["rows"] <= dw["grid"][2] * r
        assert dw["grid"][2] * (c0, *widths)[q] * widths[q] <= \
            plan["dw_part_floats"]


@pytest.mark.parametrize("ns", [1, 5, 16, 48, 128, 200, 300])
def test_launch_plan_tiles_hold_whole_neighbourhoods(ns):
    plan = P.launch_plan((2, 3, ns, 9), (40, 256), 0.2)
    tile = plan["tile_rows"]
    assert tile % ns == 0 and tile // ns <= P.MAX_NBHD
    assert tile <= max(P.ROW_TILE, ns)
    assert all(p["smem"] <= P.SMEM_LIMIT for p in plan["passes"])


@pytest.mark.parametrize("widths,slope,match", [
    ((64, 257), 0.01, "widths <= 256"),
    ((8, 8, 8, 8, 8), 0.01, "at most 4"),
    ((64, 128), -0.01, "slope"),
])
def test_launch_plan_refuses_what_the_kernels_do_not_take(widths, slope,
                                                          match):
    with pytest.raises(ValueError, match=match):
        P.launch_plan((4, 8, 32, 6), widths, slope)


def test_negative_slope_is_refused_on_the_cpu_too(rng):
    t = lambda *s: T(rng.standard_normal(s).astype(np.float32))
    with pytest.raises(ValueError, match="slope"):
        P.pooled_mlp_bn_train(t(1, 2, 4, 6), [t(6, 8)], [t(8)], [t(8)], -0.1)
