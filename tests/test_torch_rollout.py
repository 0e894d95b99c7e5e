"""The port's serving rollout against the JAX package's, and its padding
and ring properties.

Both rollouts pad frames to a bucket (JAX to a multiple of 256 points, the
port to a multiple of 128) and must give the same real outputs: padding is
transparent. The parity run uses the static graph (one kNN on positions),
so no feature-space near-tie can reorder neighbours between the two.
"""

import jax
import numpy as np
import pytest
import torch

import tpugan_tpu_torch.eval.rollout as rollout_mod
from tpugan_tpu.eval.rollout import rollout_sequence as jax_rollout
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu_torch.checkpoint import srnet_params_from_flax
from tpugan_tpu_torch.eval.rollout import (rollout_sequence,
                                           rollout_sequence_device)
from tpugan_tpu_torch.models.generator import SRNet


def _models(graph_mode, in_feats=6, r=4, n=100):
    jm = JaxSRNet(in_feats=in_feats, node_emb_dim=32, upsample_ratio=r,
                  graph_mode=graph_mode)
    x = np.zeros((1, n, in_feats), np.float32)
    params = jax.jit(lambda k: jm.init(k, x, x[..., :3], False))(
        jax.random.PRNGKey(3))["params"]
    tm = SRNet(in_feats=in_feats, node_emb_dim=32, upsample_ratio=r,
               graph_mode=graph_mode, device="cpu")
    tm.load_state_dict(srnet_params_from_flax(params, tm))
    return jm, {"params": params}, tm


def _frames(rng, counts):
    return [((rng.standard_normal((c, 3)) * 0.3).astype(np.float32),
             rng.standard_normal((c, 3)).astype(np.float32))
            for c in counts]


def test_rollout_matches_jax_with_a_ragged_frame(rng):
    jm, variables, tm = _models("static")
    frames = _frames(rng, [100, 100, 87, 100])     # 87: ragged, same bucket
    outs_j = jax_rollout(jm, variables, frames, use_vel=True, history=3)
    outs_t = rollout_sequence(tm, frames, use_vel=True, history=3)
    assert len(outs_t) == len(outs_j) == 4
    for (pos, _), a, b in zip(frames, outs_t, outs_j):
        assert a.shape == b.shape
        assert pos.shape[0] <= a.shape[0] <= 4 * pos.shape[0]
        # f32 noise of the forward, on positions of norm ~1
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_rollout_padding_is_transparent(rng, monkeypatch):
    # dynamic graphs: sentinel rows must never become real points' neighbours
    _, _, tm = _models("dynamic", in_feats=3)
    frames = [(p, None) for p, _ in _frames(rng, [90, 90, 90])]
    padded = rollout_sequence(tm, frames)                  # bucket 128
    monkeypatch.setattr(rollout_mod, "ALIGN", 1)           # bucket 90
    exact = rollout_sequence(tm, frames)
    for a, b in zip(exact, padded):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_rollout_device_matches_host_loop(rng):
    _, _, tm = _models("dynamic")
    frames = _frames(rng, [70] * 5)
    host = rollout_sequence(tm, frames, use_vel=True, history=3)
    dev = rollout_sequence_device(tm, np.stack([p for p, _ in frames]),
                                  np.stack([v for _, v in frames]),
                                  use_vel=True, history=3, chunk=2)
    assert len(dev) == len(host) == 5
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a, b)


def test_rollout_refuses_frames_it_cannot_pad(rng):
    _, _, tm = _models("static")
    small = _frames(rng, [20])
    with pytest.raises(ValueError, match="max graph k"):
        rollout_sequence(tm, small, use_vel=True)
    with pytest.raises(ValueError, match="exceeds the rollout bucket"):
        rollout_sequence(tm, _frames(rng, [128, 129]), use_vel=True)
