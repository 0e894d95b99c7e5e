"""Parity of the PyTorch port's layers and mask ring with the JAX package.

flax modules are initialised from a PRNG key; their parameter trees go into
the port's modules through the checkpoint bridge (the torch modules carry
the flax scope names), and the same numpy inputs go through both. The port
runs on the CPU, through the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.models.generator import RolloutMaskState as JaxRing
from tpugan_tpu.models.generator import expand_pos_with_masking as jax_expand
from tpugan_tpu.models.generator import rollout_mask_update as jax_ring_update
from tpugan_tpu.nn.edgeconv import EdgeConv as JaxEdgeConv
from tpugan_tpu.nn.edgeconv import IDGCNLayer as JaxIDGCN
from tpugan_tpu.nn.layers import SharedMLP as JaxSharedMLP
from tpugan_tpu_torch.checkpoint import srnet_params_from_flax
from tpugan_tpu_torch.models.generator import (RolloutMaskState,
                                               expand_pos_with_masking,
                                               rollout_mask_update)
from tpugan_tpu_torch.nn.edgeconv import EdgeConv, IDGCNLayer
from tpugan_tpu_torch.nn.layers import SharedMLP

T = torch.from_numpy
# f32 forwards of a few bias-free layers: summation order only
TOL = 1e-5


def _load(module, flax_params):
    module.load_state_dict(srnet_params_from_flax(flax_params, module))
    return module


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_shared_mlp_matches_flax(rng, dtype):
    x = rng.standard_normal((1, 50, 24)).astype(np.float32)
    jdt = None if dtype is None else getattr(jnp, dtype)
    tdt = None if dtype is None else getattr(torch, dtype)
    jm = JaxSharedMLP([16, 8], dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), x, train=False)["params"]
    out_j = jm.apply({"params": params}, x, train=False)
    out_t = _load(SharedMLP(24, [16, 8], dtype=tdt, device="cpu"), params)(T(x))
    assert str(out_t.dtype).split(".")[1] == str(out_j.dtype)
    # bf16: one bf16 ulp of the output (2^-8 relative)
    tol = TOL if dtype is None else 1e-2 * float(jnp.abs(out_j).max())
    np.testing.assert_allclose(out_t.float().detach().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("variant", ["pos_graph_mlp", "feature_graph_sum",
                                     "dilated"])
def test_edgeconv_module_matches_flax(rng, variant):
    n = 128
    feat = rng.standard_normal((1, n, 6)).astype(np.float32)
    pos = (rng.standard_normal((1, n, 3)) * 0.3).astype(np.float32)
    kw = {"pos_graph_mlp": dict(k=20),
          "feature_graph_sum": dict(k=8, aggregate="sum", mlp_layer=False),
          "dilated": dict(k=12, dilation=2)}[variant]
    graph_pos = pos if variant == "pos_graph_mlp" else None
    jm = JaxEdgeConv(32, **kw)
    params = jm.init(jax.random.PRNGKey(1), feat, pos=graph_pos,
                     train=False)["params"]
    out_j = np.asarray(jm.apply({"params": params}, feat, pos=graph_pos,
                                train=False))
    tm = _load(EdgeConv(6, 32, device="cpu", **kw), params)
    out_t = tm(T(feat), pos=None if graph_pos is None else T(graph_pos))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=TOL * float(np.abs(out_j).max()))


def test_idgcn_layer_matches_flax(rng):
    feat = rng.standard_normal((1, 160, 32)).astype(np.float32)
    jm = JaxIDGCN(32)
    params = jm.init(jax.random.PRNGKey(2), feat, train=False)["params"]
    out_j = np.asarray(jm.apply({"params": params}, feat, train=False))
    out_t = _load(IDGCNLayer(32, 32, device="cpu"), params)(T(feat))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=TOL * float(np.abs(out_j).max()))


def test_edgeconv_refuses_max_without_mlp():
    with pytest.raises(ValueError):
        EdgeConv(8, 16, mlp_layer=False, aggregate="max", device="cpu")


def test_expand_pos_with_masking_matches_jax(rng):
    pos = rng.standard_normal((2, 30, 3)).astype(np.float32)
    edge = rng.standard_normal((2, 30, 12)).astype(np.float32)
    mask = rng.random((2, 30)).astype(np.float32) * 0.03   # around epsilon
    outs_t = expand_pos_with_masking(T(pos), T(edge), T(mask), 4)
    outs_j = jax_expand(pos, edge, mask, 4)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("track_valid", [False, True])
def test_rollout_mask_update_matches_jax(rng, track_valid):
    # the port always keeps the validity ring; with every row real it must
    # equal the JAX ring without one, bit for bit
    ring_t = RolloutMaskState.create(1, 12, history=3, device="cpu")
    ring_j = JaxRing.create(1, 12, history=3, track_valid=track_valid)
    for f in range(7):
        # mask values on both sides of the 0.6 clamp, some exactly on it
        mask = rng.choice([0.1, 0.59, 0.6, 0.61, 0.9], (1, 12)).astype(np.float32)
        valid = np.arange(12)[None] < 8 + f % 3 if track_valid else None
        mean_t, ring_t = rollout_mask_update(
            ring_t, T(mask), None if valid is None else T(valid))
        mean_j, ring_j = jax_ring_update(ring_j, jnp.asarray(mask), valid)
        np.testing.assert_array_equal(mean_t.numpy(), np.asarray(mean_j))
        assert ring_t.ptr == int(ring_j.ptr)


def test_gather_and_group_match_jax(rng):
    from tpugan_tpu.ops.neighbors import gather as jax_gather
    from tpugan_tpu.ops.neighbors import group as jax_group
    from tpugan_tpu_torch.ops.neighbors import gather, group

    pts = rng.standard_normal((2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 30, 7))
    np.testing.assert_array_equal(
        gather(T(pts), T(idx[:, :, 0])).numpy(),
        np.asarray(jax_gather(pts, idx[:, :, 0])))
    np.testing.assert_array_equal(group(T(pts), T(idx)).numpy(),
                                  np.asarray(jax_group(pts, idx)))
