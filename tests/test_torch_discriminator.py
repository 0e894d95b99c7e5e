"""The port's SetConv, FlowEmbedding / FlowModule and the fluid critics
against the JAX package's flax modules, with the weights carried across by
the checkpoint bridge, in train and eval mode: outputs, gradients for the
parameters and the input points (the generator's path), and the state each
call moves (BatchNorm running moments, spectral-norm u and sigma).

Dropout is off on both sides: flax's ``Dropout.__call__`` is patched to
the identity and the port gets all-ones dropout multipliers. Tolerances cover f32
summation order through a few BatchNorm-normalised layers.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.models.discriminator import FluidSpatialDis as JSpatial
from tpugan_tpu.models.discriminator import FluidTempoDis as JTempo
from tpugan_tpu.nn.flow import FlowModule as JFlow
from tpugan_tpu.nn.layers import leaky_relu_001 as j_lrelu
from tpugan_tpu.nn.setconv import SetConv as JSetConv
from tpugan_tpu_torch.checkpoint import _tree_to_torch, state_dict_from_flax
from tpugan_tpu_torch.models.discriminator import FluidSpatialDis, FluidTempoDis
from tpugan_tpu_torch.nn.flow import FlowModule
from tpugan_tpu_torch.nn.layers import leaky_relu_001
from tpugan_tpu_torch.nn.setconv import SetConv

T = torch.from_numpy


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def compare(fmod, variables, jcall, tmod, tcall, inputs, train, tol=1e-4,
            grad_norm_tol=None):
    """Run flax ``jcall(variables, *inputs)`` and the port's
    ``tcall(tmod, *inputs)`` (the inputs: float numpy arrays that take a
    gradient, or anything else), with grads of sum(out * g) for the
    parameters and the float inputs; compare all, and the moved state.
    Gradients are held elementwise to ``tol`` of their scale, or with
    ``grad_norm_tol`` to that share of each gradient's norm (plus 1e-3 of
    the largest gradient RMS per element: a gradient that is zero in exact
    arithmetic, a Dense bias under a batch norm, is f32 noise)."""
    tmod.load_state_dict(state_dict_from_flax(flax.core.unfreeze(variables),
                                              tmod))
    params, stats = variables["params"], variables.get("batch_stats", {})
    diff = [i for i, x in enumerate(inputs)
            if isinstance(x, np.ndarray) and x.dtype == np.float32]

    def jfn(p, *xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        full = [jnp.asarray(x) if isinstance(x, np.ndarray) else x
                for x in full]
        out, upd = jcall({"params": p, "batch_stats": stats}, *full,
                         mutable=["batch_stats"])
        return out, upd["batch_stats"]

    xs = [jnp.asarray(inputs[i]) for i in diff]
    shape = jax.eval_shape(jfn, params, *xs)[0].shape
    g = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    grads = None
    if train:
        (_, (out_j, new_stats)), grads = jax.jit(jax.value_and_grad(
            lambda *a: (lambda o: (jnp.sum(o[0] * g), o))(jfn(*a)),
            argnums=tuple(range(len(diff) + 1)), has_aux=True))(params, *xs)
    else:
        out_j, new_stats = jax.jit(jfn)(params, *xs)

    t_in = [T(x).requires_grad_(train) if i in diff
            else (T(x) if isinstance(x, np.ndarray) else x)
            for i, x in enumerate(inputs)]
    with torch.set_grad_enabled(train):
        out_t = tcall(tmod, *t_in)
    _close(out_t.detach(), out_j, tol, "output")
    want = _tree_to_torch(flax.core.unfreeze(new_stats), "batch_stats")
    bufs = dict(tmod.named_buffers())
    assert set(want) == set(bufs)
    for k, v in want.items():
        _close(bufs[k], v, tol, k)
    if train:
        (out_t * T(g)).sum().backward()
        want = _tree_to_torch(flax.core.unfreeze(grads[0]), "params")
        pairs = [(f"d{k}", p.grad, want[k]) for k, p in tmod.named_parameters()]
        pairs += [(f"d input {i}", t_in[i].grad, T(np.array(gj)))
                  for i, gj in zip(diff, grads[1:])]
        if grad_norm_tol is None:
            for name, got, w in pairs:
                _close(got, w, tol, name)
            return
        r = max(float(w.norm()) / w.numel() ** 0.5 for _, _, w in pairs)
        for name, got, w in pairs:
            err = float((got - w).norm())
            assert err <= (grad_norm_tol * float(w.norm())
                           + 1e-3 * w.numel() ** 0.5 * r), (name, err)


def _features(result):
    """(new_xyz, features), state -> features, state."""
    (_, feats), state = result
    return feats, state


def _cloud(rng, b, n, scale=0.3):
    return (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("fused_train", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_setconv_matches_flax(rng, train, fused_train):
    """A masked first stage: FPS over valid points, ball query, the shared
    MLP (fused pooled-MLP kernel or plain stack + amax), max-pool."""
    b, n = 2, 96
    xyz = _cloud(rng, b, n)
    valid = rng.random((b, n)) > 0.2
    xyz[~valid] = 999.0
    fm = JSetConv.ssg([16, 32], npoint=24, radius=0.3, nsample=16,
                      mask_dummy=True, act=j_lrelu, fused_train=fused_train)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                        jnp.asarray(xyz), jnp.asarray(valid), False)
    tm = SetConv(3, [16, 32], npoint=24, radius=0.3, nsample=16,
                 mask_dummy=True, act=leaky_relu_001, fused_train=fused_train,
                 device="cpu")
    compare(fm, variables,
            lambda v, x, f, va, **k: _features(fm.apply(v, x, f, va, train,
                                                        **k)),
            tm, lambda m, x, f, va: m(x, f, va, train)[1],
            [xyz, xyz.copy(), valid], train)


@pytest.mark.parametrize("train", [True, False])
def test_flow_module_matches_flax(rng, train):
    b, n, c = 2, 40, 8
    pos = [_cloud(rng, b, n) for _ in range(3)]
    feat = [rng.standard_normal((b, n, c)).astype(np.float32) for _ in range(3)]
    fm = JFlow(c, 16, 16, 3, spectral_norm=True)
    variables = fm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feat],
                        [jnp.asarray(p) for p in pos], 0.0, False)
    tm = FlowModule(c, 16, 16, 3, spectral_norm=True, device="cpu")
    compare(fm, variables,
            lambda v, *xs, **k: fm.apply(v, list(xs[3:]), list(xs[:3]), 0.0,
                                         train, **k),
            tm, lambda m, *xs: m(list(xs[3:]), list(xs[:3]), 0.0, train),
            pos + feat, train)


@pytest.mark.parametrize("train", [True, False])
def test_fluid_spatial_dis_matches_flax(rng, no_dropout, train):
    """Every stage on the fused path in training (the pooled-MLP kernel's
    plain version against the Pallas kernel in interpret mode). Tolerance
    5e-4 of the scale: at these shapes the JAX package's own fused and XLA
    paths differ by 2.4e-4 (the head's batch norm over 4 items amplifies
    f32 summation order)."""
    b, n = 4, 128
    pos = _cloud(rng, b, n)
    valid = rng.random((b, n)) > 0.15
    pos[~valid] = 999.0
    fm = JSpatial()
    variables = fm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(pos), jnp.asarray(valid), False)
    tm = FluidSpatialDis(device="cpu")
    keep = [torch.ones(b, 256)]
    compare(fm, variables,
            lambda v, p, va, **k: fm.apply(v, p, va, train,
                                           rngs={"dropout": jax.random.PRNGKey(2)},
                                           **k),
            tm, lambda m, p, va: m(p, va, train, keep=keep),
            [pos, valid], train, tol=5e-4)


@pytest.mark.parametrize("train", [True, False])
def test_fluid_tempo_dis_matches_flax(rng, no_dropout, train):
    """Three frames with advection features and masks: stacked FPS, per-frame
    sa1 / sa2 (each advancing its spectral norms once per frame), flow
    mixing, pooling, head. Outputs and state to 2e-4 of their scale;
    gradients to 5e-2 of their norm: at these shapes a leaky-ReLU
    pre-activation within f32 noise of 0 takes the other slope, and JAX's
    own gradients move by 1-5 % (largest element) when the input features
    change by 1e-6 of their value."""
    b, n = 4, 96
    pos = [_cloud(rng, b, n) for _ in range(3)]
    feat = [(rng.standard_normal((b, n, 3)) * 0.01).astype(np.float32)
            for _ in range(3)]
    valid = [rng.random((b, n)) > 0.1 for _ in range(3)]
    fm = JTempo(3)
    variables = fm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        [jnp.asarray(p) for p in pos], 0.1,
                        [jnp.asarray(f) for f in feat],
                        [jnp.asarray(v) for v in valid], False)
    tm = FluidTempoDis(3, device="cpu")
    keep = [torch.ones(b, 256)]
    compare(fm, variables,
            lambda v, *xs, **k: fm.apply(
                v, list(xs[:3]), 0.1, list(xs[3:6]), list(xs[6:]), train,
                rngs={"dropout": jax.random.PRNGKey(2)}, **k),
            tm, lambda m, *xs: m(list(xs[:3]), 0.1, list(xs[3:6]),
                                 list(xs[6:]), train, keep=keep),
            pos + feat + valid, train, tol=2e-4, grad_norm_tol=5e-2)
