"""The fused EdgeConv backward of the PyTorch port against the JAX package's.

* ``edgeconv_backward_plain`` (the backward kernel's formulas, its oracle
  on the card) against the Pallas backward ``_bwd_pallas`` run in interpret
  mode, with N a multiple of 8 so the Pallas body runs and not its XLA
  fallback: the four aggregates with the MLP, sum and max without it, f32
  and bf16, and a table whose duplicated planes tie exactly at the max.
* The port's autograd Function (``edgeconv_fused``) on the CPU against
  autograd through the plain forward.
* ``SRNet(train=True, fused_train=True)`` parameter gradients against the
  JAX SRNet's with ``_TRAIN_FUSED`` patched on, the JAX graphs replayed
  into the port (``test_torch_srnet.GraphReplay``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpugan_tpu.nn.edgeconv as jax_edgeconv_mod
import tpugan_tpu.ops.neighbors as jax_neighbors
from test_torch_srnet import GraphReplay
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu.ops.pallas.edgeconv_kernel import _bwd_pallas
from tpugan_tpu_torch.checkpoint import _tree_to_torch, srnet_params_from_flax
from tpugan_tpu_torch.models.generator import SRNet
from tpugan_tpu_torch.ops.kernels import edgeconv as E

# (aggregate, mlp, dtype, exact ties)
CASES = [("max", True, "f32", False), ("min", True, "f32", False),
         ("sum", True, "f32", False), ("mean", True, "f32", False),
         ("sum", False, "f32", False), ("max", False, "f32", False),
         ("max", True, "bf16", False), ("max", True, "f32", True)]


def _inputs(rng, b, k, n, c, h, o, mlp):
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return (f(b, k, n, c), f(b, n, c), f(c, h, sc=.3), f(c, h, sc=.3),
            f(h, h, sc=.3) if mlp else None, f(h, o, sc=.3) if mlp else None,
            f(b, n, o if mlp else h))


@pytest.mark.parametrize("agg,mlp,kind,ties", CASES)
def test_plain_backward_matches_pallas(rng, agg, mlp, kind, ties):
    """f32 to the 3e-5 of tests/test_pallas_kernels.py (summation order);
    bf16 to 2e-2 of each gradient's scale: the two sides round the same
    values but sum in another order, and a one-ulp flip of a bf16
    cotangent (2^-8 of it) moves the sums it enters."""
    b, k, n, c, h, o = 2, 6, 32, 16, 8, 24
    nbr, ctr, wn, we, w1, w2, g = _inputs(rng, b, k, n, c, h, o, mlp)
    if ties:
        nbr[:, 1], nbr[:, 3] = nbr[:, 0], nbr[:, 2]
    jdt, tdt = ((jnp.float32, torch.float32) if kind == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    want = _bwd_pallas(J(nbr).astype(jdt), J(ctr).astype(jdt), J(wn), J(we),
                       J(w1), J(w2), J(g), aggregate=agg, cdt=jdt)
    assert want is not None                      # the Pallas body ran
    got = E.edgeconv_backward_plain(T(nbr).to(tdt), T(ctr).to(tdt), T(wn),
                                    T(we), T(w1), T(w2), T(g), agg, tdt)
    for i, (a, w) in enumerate(zip(got, want)):
        if w is None:
            assert a is None
            continue
        w = np.asarray(w.astype(jnp.float32))
        a = a.float().numpy()
        if kind == "f32":
            np.testing.assert_allclose(a, w, rtol=3e-5, atol=3e-5,
                                       err_msg=f"gradient {i}")
        else:
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=2e-2 * np.abs(w).max(),
                                       err_msg=f"gradient {i}")
    if ties:
        # the tied planes split every cotangent they share evenly
        np.testing.assert_array_equal(got[0][:, 0].numpy(), got[0][:, 1].numpy())
        assert float(got[0][:, 0].abs().max()) > 0


@pytest.mark.parametrize("agg,mlp", [("max", True), ("min", True),
                                     ("sum", False), ("mean", True)])
def test_function_matches_autograd_of_plain_forward(rng, agg, mlp):
    """On the CPU the Function's backward is the plain backward: in f32 it
    equals autograd through the plain forward (the same products)."""
    nbr, ctr, wn, we, w1, w2, g = _inputs(rng, 2, 5, 16, 6, 8, 12, mlp)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (nbr, ctr, wn, we) + ((w1, w2) if mlp else ())]
    args = leaves + ([] if mlp else [None, None])
    got = torch.autograd.grad(E.edgeconv_fused(*args, aggregate=agg), leaves,
                              torch.from_numpy(g))
    want = torch.autograd.grad(E.edgeconv_plain(*args, aggregate=agg), leaves,
                               torch.from_numpy(g))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def test_srnet_fused_train_gradients_match_jax(rng, monkeypatch):
    """Every generator EdgeConv through the fused kernels and their
    backward on both sides; the loss reaches the offset and the mask heads.
    Gradients to 1e-4 of each tensor's largest value plus 1e-4 relative
    (f32 summation order through 9 EdgeConvs and the heads)."""
    monkeypatch.setattr(jax_edgeconv_mod, "_TRAIN_FUSED", True)
    r, n = 4, 256
    pos = (rng.standard_normal((1, n, 3)) * 0.3).astype(np.float32)
    vel = (rng.standard_normal((1, n, 3)) * 0.025).astype(np.float32)
    feat = np.concatenate([pos, vel], -1)
    w_exp = rng.standard_normal((1, n * r, 3)).astype(np.float32)
    w_mask = rng.standard_normal((1, n)).astype(np.float32)
    jm = JaxSRNet(in_feats=6, node_emb_dim=32, upsample_ratio=r)
    params = jax.jit(lambda key: jm.init(key, feat, pos, False))(
        jax.random.PRNGKey(0))["params"]

    replay = GraphReplay(monkeypatch)
    orig = jax_neighbors.graph_knn
    traced = []

    def recording(x, k, c_valid=None):
        d2, idx = orig(x, k, c_valid)
        traced.append(idx)
        return d2, idx

    monkeypatch.setattr(jax_neighbors, "graph_knn", recording)
    monkeypatch.setattr(jax_edgeconv_mod, "graph_knn", recording)

    def loss(p):
        traced.clear()
        expanded, mask, _, _ = jm.apply({"params": p}, feat, pos, True)
        return (jnp.sum(expanded * w_exp) + jnp.sum(mask * w_mask),
                list(traced))

    (_, lists), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    replay.lists = [np.asarray(idx) for idx in lists]
    assert len(replay.lists) == 7

    tm = SRNet(in_feats=6, node_emb_dim=32, upsample_ratio=r, fused_train=True,
               device="cpu")
    tm.load_state_dict(srnet_params_from_flax(params, tm))
    replay.replay()
    expanded, mask, _, _ = tm(torch.from_numpy(feat), torch.from_numpy(pos),
                              train=True)
    assert not replay.lists
    t_loss = ((expanded * torch.from_numpy(w_exp)).sum()
              + (mask * torch.from_numpy(w_mask)).sum())
    named = dict(tm.named_parameters())
    got = dict(zip(named, torch.autograd.grad(t_loss, list(named.values()))))
    want = _tree_to_torch(jgrads, "params")
    assert set(got) == set(want)
    for key, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
