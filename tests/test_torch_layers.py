"""The port's BatchNorm, SpectralNorm, ConvLayer and SharedMLP against the
flax modules of the JAX package, in train and eval mode: outputs, parameter
gradients and the state each call moves (BatchNorm running moments,
spectral-norm u and sigma). Weights are carried over from flax with the
checkpoint bridge (``state_dict_from_flax``).
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.nn import layers as jl
from tpugan_tpu_torch.checkpoint import _tree_to_torch, state_dict_from_flax
from tpugan_tpu_torch.nn import layers as tl

T = torch.from_numpy
ACTS = {"lrelu001": (jl.leaky_relu_001, tl.leaky_relu_001),
        "relu": (fnn.relu, tl.relu)}


def carry(module, variables):
    """Load flax variables into a port module (every leaf accounted for)."""
    module.load_state_dict(state_dict_from_flax(
        flax.core.unfreeze(variables), module))
    return module


def assert_state(module, batch_stats, tol):
    """The port module's buffers equal flax's updated batch_stats."""
    want = _tree_to_torch(flax.core.unfreeze(batch_stats), "batch_stats")
    got = dict(module.named_buffers())
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def assert_grads(module, flax_grads, tol):
    want = _tree_to_torch(flax.core.unfreeze(flax_grads), "params")
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(want) == set(got)
    for k, v in want.items():
        scale = max(1.0, float(v.abs().max()))
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=tol * scale, err_msg=k)


def run_both(fmod, tmod_fn, x, train, fwd_kw=None, tfwd=None, seed=0,
             backward=True):
    """Init flax, carry into the port, run both with grads of sum(out * g)
    (the port's only when ``backward``); returns (flax out, flax new
    batch_stats, flax grads, port module, port out)."""
    fwd_kw = fwd_kw or {}
    variables = fmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False,
                          **fwd_kw)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out_shape = jax.eval_shape(lambda p: fmod.apply(
        {"params": p, "batch_stats": stats}, jnp.asarray(x), train=False,
        **fwd_kw), params).shape
    g = np.random.default_rng(seed + 1).standard_normal(out_shape).astype(
        np.float32)

    def loss(p):
        out, upd = fmod.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), train=train,
                              mutable=["batch_stats"], **fwd_kw)
        return jnp.sum(out * g), (out, upd.get("batch_stats", stats))

    (_, (out_j, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    tmod = carry(tmod_fn(), variables)
    with torch.set_grad_enabled(backward):
        out_t = (tfwd or (lambda m, xx: m(xx, train)))(tmod, T(x))
    if backward:
        (out_t * T(g)).sum().backward()
    return np.asarray(out_j), new_stats, grads, tmod, out_t


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(rng, train):
    x = (rng.standard_normal((3, 7, 5)) * 2 + 1).astype(np.float32)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.BatchNorm(use_running_average=not train,
                                 axis_name=None)(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.BatchNorm_0 = tl.BatchNorm(5, device="cpu")

        def forward(self, x, train):
            return self.BatchNorm_0(x, train)

    out_j, stats, grads, tm, out_t = run_both(Wrap(), Port, x, train)
    # f32 moment sums in another order
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=2e-5)
    assert_state(tm, stats, 1e-6)
    assert_grads(tm, grads, 2e-5)


@pytest.mark.parametrize("train", [True, False])
def test_spectral_norm_matches_flax(rng, train):
    """One power step from the stored u on every call; u and sigma stored
    only in training; the gradient flows through sigma."""
    x = rng.standard_normal((4, 6)).astype(np.float32)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.SpectralNorm(fnn.Dense(9))(x, update_stats=train)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(6, 9)
            self.SpectralNorm_0 = tl.SpectralNorm(9, torch.Generator(), "cpu")

        def forward(self, x, train):
            w = self.SpectralNorm_0(self.Dense_0.weight, update_stats=train)
            return torch.nn.functional.linear(x, w, self.Dense_0.bias)

    out_j, stats, grads, tm, out_t = run_both(Wrap(), Port, x, train)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=1e-5)
    assert_state(tm, stats, 1e-6)
    assert_grads(tm, grads, 1e-5)


@pytest.mark.parametrize("norm,sn,bias", [("batch", True, None),
                                          ("none", False, None),
                                          ("none", True, True)])
@pytest.mark.parametrize("train", [True, False])
def test_conv_layer_matches_flax(rng, norm, sn, bias, train):
    x = rng.standard_normal((2, 5, 3, 7)).astype(np.float32)
    fm = jl.ConvLayer(11, act=jl.leaky_relu_001, norm=norm, spectral_norm=sn,
                      use_bias=bias)
    out_j, stats, grads, tm, out_t = run_both(
        fm, lambda: tl.ConvLayer(7, 11, act=tl.leaky_relu_001, norm=norm,
                                 spectral_norm=sn, use_bias=bias,
                                 device="cpu"), x, train)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=2e-5)
    assert_state(tm, stats, 1e-6)
    assert_grads(tm, grads, 2e-5)


@pytest.mark.parametrize("act", ["lrelu001", "relu"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_shared_mlp_pooled_matches_flax(rng, act, fused, train):
    """Both SharedMLP paths on a grouped table with exact max ties: the
    fused pooled path (the pooled-MLP kernel's plain version against the
    Pallas kernel in interpret mode) and the plain stack (unpooled). The
    fused eval path is forward only in the port (no affine backward)."""
    x = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    x[:, :, 3] = x[:, :, 0]
    fa, ta = ACTS[act]
    fm = jl.SharedMLP([8, 16], act=fa, norm="batch", spectral_norm=True,
                      use_bias=False)

    def tfwd(m, xx):
        return m.pooled(xx, train) if fused else m(xx, train)

    out_j, stats, grads, tm, out_t = run_both(
        fm, lambda: tl.SharedMLP(6, [8, 16], act=ta, norm="batch",
                                 spectral_norm=True, use_bias=False,
                                 device="cpu"),
        x, train, fwd_kw={"fused_pool": fused}, tfwd=tfwd,
        backward=train or not fused)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=2e-5)
    assert_state(tm, stats, 2e-6)
    if train or not fused:
        assert_grads(tm, grads, 5e-5)


def test_shared_mlp_pooled_eval_is_forward_only(rng):
    """The eval-mode pooled stack is differentiable through the affine
    form's backward: its gradient with respect to the input equals autograd
    through the plain eval stack and ``amax``. A biased batch-norm stack is
    refused."""
    m = tl.SharedMLP(6, [8], act=tl.relu, norm="batch", spectral_norm=True,
                     use_bias=False, device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, 2, 4, 6)).astype(np.float32))
    x.requires_grad_()
    out = m.pooled(x, train=False)
    assert out.shape == (1, 2, 8)
    got, = torch.autograd.grad(out.sum(), x)
    want, = torch.autograd.grad(m(x, train=False).amax(dim=2).sum(), x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    biased = tl.SharedMLP(6, [8], act=tl.relu, norm="batch", device="cpu")
    with pytest.raises(ValueError, match="bias-free"):
        biased.pooled(x, train=True)
