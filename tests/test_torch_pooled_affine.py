"""The pooled MLP's affine form with its backward (a norm-free SetConv
trained fused) in the PyTorch port against the JAX package.

* ``pooled_mlp_affine_backward_plain`` (the affine backward kernel's
  formulas, its oracle on the card) against the Pallas backward
  ``_bwd_pallas_affine`` run in interpret mode and against
  ``jax.vjp(_ref_affine)``, on the shapes of
  ``tests/test_pooled_mlp_fused.py`` (a three-layer leaky stack, and a
  group_all table whose ns is tiled, so the tie count spans tiles).
* ``SetConv(bn=False)`` trained through the fused op (``fused_train``;
  the JAX side's ``fused=True``): output and gradients against the JAX
  SetConv's, with and without a spectral norm, and pooling the whole cloud.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.nn.setconv import SetConv as JaxSetConv
from tpugan_tpu.ops.pallas.pooled_mlp_kernel import (_bwd_pallas_affine,
                                                     _ref_affine,
                                                     pooled_mlp_affine)
from tpugan_tpu_torch.checkpoint import _tree_to_torch, state_dict_from_flax
from tpugan_tpu_torch.nn.setconv import SetConv
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P


@pytest.mark.parametrize("b,m,ns,dims,slope", [(2, 8, 16, (7, 16, 24), 0.2),
                                               (1, 1, 1024, (5, 8), 0.0)])
def test_affine_backward_matches_pallas_and_vjp(rng, b, m, ns, dims, slope):
    """f32 to 2e-4, the JAX package's own limit between these two."""
    f = lambda *s, sc=1.0, at=0.0: (rng.standard_normal(s) * sc + at
                                    ).astype(np.float32)
    tbl = f(b, m, ns, dims[0])
    tbl[:, :, 1] = tbl[:, :, 0]                     # exact max ties
    ws = [f(dims[i], dims[i + 1], sc=0.4) for i in range(len(dims) - 1)]
    a_s = [f(d, sc=0.2, at=1.0) for d in dims[1:]]
    b_s = [f(d, sc=0.1) for d in dims[1:]]
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)
    pooled = pooled_mlp_affine(jnp.asarray(tbl), J(ws), J(a_s), J(b_s), slope)
    g = f(*pooled.shape)
    pallas = _bwd_pallas_affine(jnp.asarray(tbl), J(ws), J(a_s), J(b_s),
                                slope, pooled, jnp.asarray(g))
    assert pallas is not None                       # the Pallas passes ran
    _, vjp = jax.vjp(lambda t, w, a, bb: _ref_affine(t, w, a, bb, slope),
                     jnp.asarray(tbl), J(ws), J(a_s), J(b_s))
    ref = vjp(jnp.asarray(g))

    T = lambda xs: [torch.from_numpy(x) for x in xs]
    got_pooled = P.pooled_mlp_affine_plain(torch.from_numpy(tbl), T(ws),
                                           T(a_s), T(b_s), slope)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled),
                               rtol=2e-5, atol=2e-5)
    got = P.pooled_mlp_affine_backward_plain(
        torch.from_numpy(tbl), T(ws), T(a_s), T(b_s), got_pooled,
        torch.from_numpy(g), slope)
    flat = lambda grads: [grads[0]] + [x for grp in grads[1:] for x in grp]
    for want in (pallas, ref):
        for i, (x, y) in enumerate(zip(flat(got), flat(want))):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                       atol=2e-4, err_msg=f"gradient {i}")


def test_affine_function_matches_autograd_of_plain(rng):
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32))
    leaves = [t(2, 8, 16, 7), t(7, 16, sc=.4), t(16, 24, sc=.4),
              1 + t(16, sc=.2), 1 + t(24, sc=.2), t(16, sc=.1), t(24, sc=.1)]
    leaves[0][:, :, 1] = leaves[0][:, :, 0]
    leaves = [x.requires_grad_() for x in leaves]
    g = t(2, 8, 24)
    got = torch.autograd.grad(P.pooled_mlp_affine(
        leaves[0], leaves[1:3], leaves[3:5], leaves[5:7], 0.2), leaves, g)
    want = torch.autograd.grad(P.pooled_mlp_affine_plain(
        leaves[0], leaves[1:3], leaves[3:5], leaves[5:7], 0.2), leaves, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sn,npoint", [(False, 64), (True, 64), (False, None)])
def test_setconv_bn_false_trained_fused_matches_jax(rng, sn, npoint):
    """Output to 2e-5 and gradients of sum(y^2) (parameters and the input
    features) to 1e-4 of each tensor's scale plus 1e-4 relative: f32 sums
    in another order."""
    xyz = (rng.standard_normal((2, 256, 3)) * 0.3).astype(np.float32)
    feat = rng.standard_normal((2, 256, 16)).astype(np.float32)
    kw = dict(radius=0.4, nsample=32) if npoint else {}
    jm = JaxSetConv.ssg([32, 64], npoint=npoint, spectral_norm=sn, bn=False,
                        fused=True, **kw)
    v = jm.init(jax.random.PRNGKey(0), xyz, feat, train=False)

    def loss(p, f):
        (_, y), _ = jm.apply({**v, "params": p}, xyz, f, train=True,
                             mutable=["batch_stats"])
        return jnp.sum(y * y), y

    (_, y_j), (gp, gf) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(v["params"],
                                                          jnp.asarray(feat))
    tm = SetConv(16, [32, 64], npoint=npoint, spectral_norm=sn, bn=False,
                 fused_train=True, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_flax(v, tm))
    f_t = torch.from_numpy(feat).requires_grad_()
    _, y_t = tm(torch.from_numpy(xyz), f_t, train=True)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=2e-5, atol=2e-5)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((y_t * y_t).sum(), [f_t, *named.values()])
    want = _tree_to_torch(gp, "params")
    assert set(want) == set(named)
    pairs = [("features", grads[0], np.asarray(gf))] + [
        (k, g, want[k].numpy()) for k, g in zip(named, grads[1:])]
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
