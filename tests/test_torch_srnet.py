"""Parity of the port's SRNet forward with the JAX package's, f32.

The JAX model is initialised from a PRNG key (or loaded from the trained
checkpoint); its parameter tree goes into the port's SRNet through the
checkpoint bridge, and the same numpy frame goes through both.

Feature-space kNN graphs order neighbours whose distances tie to f32 noise
differently in the two frameworks, and under the IDGCN's ::2 dilation one
such swap changes a point's features and then its neighbours'. So the
dynamic forwards are compared with the JAX graphs replayed into the port:
each replayed list is first held against the port's own kNN of its own
features, which may differ from it only between candidates whose exact
distances tie within f32 noise; with equal graphs the outputs must then
agree to f32 noise.
"""

import os

import jax
import numpy as np
import pytest
import torch

import tpugan_tpu.nn.edgeconv as jax_edgeconv_mod
import tpugan_tpu.ops.neighbors as jax_neighbors
import tpugan_tpu_torch.models.generator as torch_generator
import tpugan_tpu_torch.nn.edgeconv as torch_edgeconv_mod
from flax import serialization
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu_torch.checkpoint import load_srnet, srnet_params_from_flax
from tpugan_tpu_torch.models.generator import SRNet
from tpugan_tpu_torch.ops.neighbors import graph_knn

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "fluid_vel_20k.ckpt")


class GraphReplay:
    """Records the JAX forward's graph kNN lists and replays them, in
    order, into the port's forward after checking them (module docstring).
    """

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.lists = []

    def jax_forward(self, model, variables, feat, pos):
        """Jitted JAX forward that also returns the graphs it built."""
        orig = jax_neighbors.graph_knn
        traced = []

        def recording(x, k, c_valid=None):
            d2, idx = orig(x, k, c_valid)
            traced.append(idx)
            return d2, idx

        self.mp.setattr(jax_neighbors, "graph_knn", recording)
        self.mp.setattr(jax_edgeconv_mod, "graph_knn", recording)

        def fwd(v, f, p):
            traced.clear()
            return model.apply(v, f, p, False), list(traced)

        out, lists = jax.jit(fwd)(variables, feat, pos)
        self.lists = [np.asarray(idx) for idx in lists]
        return out

    def replay(self):
        def replaying(x, k, c_valid=None):
            d2, own = graph_knn(x, k, c_valid)
            rec = self.lists.pop(0)
            assert rec.shape == tuple(own.shape)
            xf = x.detach().float().numpy().astype(np.float64)
            b, r, s = np.nonzero(rec != own.numpy())
            exact = lambda idx: np.sum((xf[b, r] - xf[b, idx[b, r, s]]) ** 2, -1)
            # f32 noise of |q|^2 + |c|^2 - 2 q.c at these feature norms
            tol = 1e-5 * 2 * float(np.max(np.sum(xf ** 2, -1)))
            gap = np.abs(exact(rec) - exact(own.numpy()))
            assert gap.size == 0 or gap.max() <= tol, (gap.max(), tol)
            return d2, torch.from_numpy(rec.astype(np.int64))

        self.mp.setattr(torch_edgeconv_mod, "graph_knn", replaying)
        self.mp.setattr(torch_generator, "graph_knn", replaying)


def assert_forward_close(jax_out, torch_out, epsilon, r):
    """(expanded, mask, padded, valid) of the two forwards: raw masks and
    positions to f32 noise; keep decisions equal except where the raw mask
    lies within 1e-4 of epsilon."""
    e_j, m_j, p_j, v_j = (np.asarray(a) for a in jax_out)
    e_t, m_t, p_t, v_t = (a.numpy() for a in torch_out)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-4)
    near = np.repeat(np.abs(m_j - epsilon) < 1e-4, r, axis=1)
    assert np.all((v_t == v_j) | near)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-4)
    same = v_t == v_j
    np.testing.assert_allclose(p_t[same], p_j[same], rtol=0, atol=1e-4)


def _frame(rng, n, in_feats):
    pos = (rng.standard_normal((1, n, 3)) * 0.3).astype(np.float32)
    if in_feats == 3:
        return pos, pos
    vel = (rng.standard_normal((1, n, 3)) * 0.025).astype(np.float32)
    return np.concatenate([pos, vel], -1), pos


@pytest.mark.parametrize("graph_mode,in_feats", [("dynamic", 3),
                                                 ("static", 6)])
def test_srnet_matches_jax(rng, monkeypatch, graph_mode, in_feats):
    r = 4
    feat, pos = _frame(rng, 256, in_feats)
    jm = JaxSRNet(in_feats=in_feats, node_emb_dim=32, upsample_ratio=r,
                  graph_mode=graph_mode)
    variables = jax.jit(lambda key: jm.init(key, feat, pos, False))(
        jax.random.PRNGKey(0))
    replay = GraphReplay(monkeypatch)
    out_j = replay.jax_forward(jm, variables, feat, pos)
    assert len(replay.lists) == (7 if graph_mode == "dynamic" else 1)

    tm = SRNet(in_feats=in_feats, node_emb_dim=32, upsample_ratio=r,
               graph_mode=graph_mode, device="cpu")
    tm.load_state_dict(srnet_params_from_flax(variables["params"], tm))
    replay.replay()
    out_t = tm(torch.from_numpy(feat), torch.from_numpy(pos))
    assert not replay.lists
    assert_forward_close(out_j, out_t, tm.epsilon, r)


def test_trained_checkpoint_dynamic_matches_jax(monkeypatch):
    # the serving configuration (in_feats 6, emb 128, r 8, depth 3) with its
    # trained weights, on the bench's frame cut to 1,024 points
    pos = (np.random.default_rng(0).standard_normal((1, 10240, 3))
           .astype(np.float32) * 0.3)[:, :1024]
    feat = np.concatenate([pos, np.zeros_like(pos)], -1)
    with open(CKPT, "rb") as fh:
        params = serialization.msgpack_restore(fh.read())["sr_net"]["params"]
    jm = JaxSRNet(in_feats=6, node_emb_dim=128, upsample_ratio=8)
    replay = GraphReplay(monkeypatch)
    out_j = replay.jax_forward(jm, {"params": params}, feat, pos)
    tm = load_srnet(CKPT, device="cpu")
    replay.replay()
    out_t = tm(torch.from_numpy(feat), torch.from_numpy(pos))
    assert_forward_close(out_j, out_t, tm.epsilon, 8)


# The position-only model's bf16 static forward against JAX's: both round
# every EdgeConv layer to bf16 (the port through its kernel's plain version
# on the CPU, JAX through its own), each summing in its own order, so a
# value may round to the neighbouring bf16 and the flip carries forward
# through the IDGCN and the heads. At these widths the masks read 1.1e-3
# apart and the positions 3.7e-3 (a cloud of scale 0.3); the limits lie
# about 10x and 5x above, and keep decisions may differ only where JAX's
# raw mask lies within BF16_MASK_ATOL of epsilon.
BF16_MASK_ATOL = 1e-2
BF16_POS_ATOL = 2e-2


def test_position_only_bf16_static_matches_jax(rng, monkeypatch):
    import jax.numpy as jnp

    r = 4
    feat, pos = _frame(rng, 256, 3)
    jm = JaxSRNet(in_feats=3, node_emb_dim=32, upsample_ratio=r,
                  graph_mode="static", compute_dtype=jnp.bfloat16)
    variables = jax.jit(lambda key: jm.init(key, feat, pos, False))(
        jax.random.PRNGKey(1))
    replay = GraphReplay(monkeypatch)
    out_j = replay.jax_forward(jm, variables, feat, pos)
    assert len(replay.lists) == 1
    tm = SRNet(in_feats=3, node_emb_dim=32, upsample_ratio=r,
               graph_mode="static", compute_dtype=torch.bfloat16,
               device="cpu")
    tm.load_state_dict(srnet_params_from_flax(variables["params"], tm))
    replay.replay()
    with torch.no_grad():
        out_t = tm(torch.from_numpy(feat), torch.from_numpy(pos))
    assert not replay.lists
    e_j, m_j, p_j, v_j = (np.asarray(a) for a in out_j)
    e_t, m_t, p_t, v_t = (a.numpy() for a in out_t)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=BF16_MASK_ATOL)
    near = np.repeat(np.abs(m_j - tm.epsilon) < BF16_MASK_ATOL, r, axis=1)
    assert np.all((v_t == v_j) | near)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=BF16_POS_ATOL)
    same = v_t == v_j
    np.testing.assert_allclose(p_t[same], p_j[same], rtol=0,
                               atol=BF16_POS_ATOL)
