"""The action workload in the PyTorch port against the JAX package, on the
CPU, with the same numpy inputs and the JAX weights carried across by the
checkpoint bridge:

* NoMaskSRNet on the committed action checkpoint, 128-point frames of a
  synthetic clip, with the JAX graphs replayed (``test_torch_srnet``'s
  rule), positions to 1e-4;
* ActionTempoDis (the checkpoint's critic) and ActionCls logits at eval
  (JAX through its Pallas pooled-MLP kernel in interpret mode) and in
  training with the same dropout masks, to 1e-4 of max(1, |ref|);
* the transferred classifier weights bit for bit; the plain affine pooled
  MLP at the 512-wide pooling stage against the JAX kernel in interpret
  mode;
* the clip loader, the synthetic files and the action metrics.
"""

import filecmp
import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_srnet import GraphReplay
from torch_host_sampling import MODES, host_sampling
from tpugan_tpu.data.msr import MSRAction3DDataset as JDataset
from tpugan_tpu.data.msr import action_batch_iterator as j_batches
from tpugan_tpu.data.synthetic import make_synthetic_action_dataset as j_synth
from tpugan_tpu.eval import analysis as j_analysis
from tpugan_tpu.models import NoMaskSRNet as JNoMask
from tpugan_tpu.models.discriminator import ActionCls as JCls
from tpugan_tpu.models.discriminator import ActionTempoDis as JTempo
from tpugan_tpu.models.discriminator import \
    transfer_feature_extractor as j_transfer
from tpugan_tpu.ops.pallas.pooled_mlp_kernel import \
    pooled_mlp_affine as j_pooled_affine
from tpugan_tpu_torch.checkpoint import (load_action_tempo_dis,
                                         load_nomask_srnet,
                                         state_dict_from_flax)
from tpugan_tpu_torch.data.msr import MSRAction3DDataset, action_batch_iterator
from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset
from tpugan_tpu_torch.eval import analysis
from tpugan_tpu_torch.models.discriminator import (ActionCls,
                                                   transfer_feature_extractor)
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "action_tempo_20k.ckpt")
B, N, CUTOFF = 4, 512, 2.0


@pytest.fixture(scope="module")
def ckpt_tree():
    with open(CKPT, "rb") as fh:
        return serialization.msgpack_restore(fh.read())


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A small synthetic MSR-schema set written by the port (5 videos: 3
    train, 2 test)."""
    return make_synthetic_action_dataset(
        str(tmp_path_factory.mktemp("msr")), num_videos=5, frames=6,
        points=700, seed=2)


@pytest.fixture(scope="module")
def clips():
    """Three frames of B clips of N points, centred as the test split
    centres them (depth units / 300)."""
    rng = np.random.default_rng(5)
    body = rng.standard_normal((B, N, 3)) * np.array([0.2, 0.4, 0.13])
    return [(body + rng.standard_normal((B, N, 3)) * 0.01 * f
             ).astype(np.float32) for f in range(3)]


def test_synthetic_action_files_equal_jax(synth, tmp_path):
    j_synth(str(tmp_path), num_videos=5, frames=6, points=700, seed=2)
    names = sorted(os.listdir(synth))
    assert names == sorted(os.listdir(tmp_path)) and len(names) == 5
    for name in names:
        assert filecmp.cmp(os.path.join(synth, name),
                           os.path.join(str(tmp_path), name), shallow=False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("train", [True, False])
def test_loader_clips_and_batches_equal_jax(synth, monkeypatch, train, mode):
    """Items (with the FPS downsample) and a threaded batch, bit for bit;
    like against like: the port's plain FPS against the JAX package's numpy
    FPS, the port's library against the JAX package's."""
    host_sampling(monkeypatch, mode)
    kw = dict(frames_per_clip=3, num_points=256, train=train, seed=4)
    ours, theirs = MSRAction3DDataset(synth, **kw), JDataset(synth, **kw)
    assert (len(ours), ours.num_classes) == (len(theirs), theirs.num_classes)
    assert len(ours) > 0
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a = next(action_batch_iterator(ours, 2, seed=3))
    b = next(j_batches(theirs, 2, seed=3))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("graph_mode,graphs", [("dynamic", 5),
                                               ("static", 1)])
def test_nomask_srnet_checkpoint_matches_jax(ckpt_tree, synth, monkeypatch,
                                             graph_mode, graphs):
    """Three 128-point frames of a test clip as one batch through the
    trained generator (width 128, r 16, depth 3)."""
    item = MSRAction3DDataset(synth, frames_per_clip=3, num_points=2048,
                              train=False)[0]
    low = item["lowres_pos"]                                  # [3, 128, 3]
    jm = JNoMask(in_feats=3, node_emb_dim=128, upsample_ratio=16,
                 graph_mode=graph_mode)
    replay = GraphReplay(monkeypatch)
    out_j, edge_j = replay.jax_forward(
        jm, {"params": ckpt_tree["sr_net"]["params"]}, low, low)
    assert len(replay.lists) == graphs
    tm = load_nomask_srnet(CKPT, device="cpu", graph_mode=graph_mode)
    assert (tm.in_feats, tm.upsample_ratio) == (3, 16)
    replay.replay()
    out_t, edge_t = tm(torch.from_numpy(low), torch.from_numpy(low))
    assert not replay.lists
    assert out_t.shape == (3, 128 * 16, 3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(edge_t.numpy(), np.asarray(edge_j), rtol=0,
                               atol=1e-4)


def _masks(seed):
    """Dropout multipliers of the action heads' two layers (p 0.3, 0.1), by
    width: 0 or 1 / keep, as flax scales."""
    rng = np.random.default_rng(seed)
    return {w: np.where(rng.random((B, w)) < 1 - p, 1 / (1 - p), 0.0
                        ).astype(np.float32)
            for w, p in ((256, 0.3), (64, 0.1))}


def _jax_logits(module, variables, clips, train, masks, monkeypatch):
    """The flax module's output; in training with flax's Dropout replaced
    by the given multipliers, and the batch statistics mutable."""
    def dropout(self, x, deterministic=None, rng=None):
        if fnn.merge_param("deterministic", self.deterministic,
                           deterministic):
            return x
        return x * jnp.asarray(masks[x.shape[-1]])

    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    pos = [jnp.asarray(c) for c in clips]
    if not train:
        return np.asarray(jax.jit(
            lambda v: module.apply(v, pos, CUTOFF, train=False))(variables))
    out, _ = jax.jit(lambda v: module.apply(
        v, pos, CUTOFF, train=True, mutable=["batch_stats"]))(variables)
    return np.asarray(out)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def cls_variables(clips):
    jm = JCls(3, num_classes=20)
    return jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                     [jnp.asarray(c) for c in clips], CUTOFF,
                                     False))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("train", [False, True])
def test_action_tempo_dis_logits_match_jax(ckpt_tree, clips, monkeypatch,
                                           train):
    """The checkpoint's temporal critic (spectral norms and batch norms
    with their trained state)."""
    masks = _masks(1)
    want = _jax_logits(JTempo(3), ckpt_tree["tempo_dis"], clips, train,
                       masks, monkeypatch)
    tm = load_action_tempo_dis(CKPT, device="cpu")
    keep = [torch.from_numpy(masks[w]) for w in (256, 64)]
    with torch.no_grad():
        got = tm([torch.from_numpy(c) for c in clips], CUTOFF, train=train,
                 keep=keep)
    assert got.shape == (B, 1)
    _close(got.numpy(), want)


@pytest.mark.parametrize("train", [False, True])
def test_action_cls_logits_match_jax(cls_variables, clips, monkeypatch,
                                     train):
    masks = _masks(2)
    want = _jax_logits(JCls(3, num_classes=20), cls_variables, clips, train,
                       masks, monkeypatch)
    tm = ActionCls(3, device="cpu")
    tm.load_state_dict(state_dict_from_flax(
        flax.core.unfreeze(cls_variables), tm))
    keep = [torch.from_numpy(masks[w]) for w in (256, 64)]
    with torch.no_grad():
        got = tm([torch.from_numpy(c) for c in clips], CUTOFF, train=train,
                 keep=keep)
    assert got.shape == (B, 20)
    _close(got.numpy(), want)
    if not train:
        probs = tm.infer([torch.from_numpy(c) for c in clips], CUTOFF)
        np.testing.assert_allclose(probs.numpy(),
                                   np.asarray(jax.nn.softmax(want)), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("form", ["modules", "state_dicts"])
def test_transfer_matches_jax_bit_for_bit(ckpt_tree, cls_variables, form):
    want = state_dict_from_flax(flax.core.unfreeze(j_transfer(
        cls_variables, ckpt_tree["tempo_dis"])))
    cls = ActionCls(3, device="cpu")
    cls.load_state_dict(state_dict_from_flax(
        flax.core.unfreeze(cls_variables), cls))
    before = {k: v.clone() for k, v in cls.state_dict().items()}
    dis = load_action_tempo_dis(CKPT, device="cpu")
    if form == "modules":
        got = transfer_feature_extractor(cls, dis).state_dict()
    else:
        got = transfer_feature_extractor(cls.state_dict(), dis.state_dict())
        assert all(torch.equal(v, before[k])
                   for k, v in cls.state_dict().items())
    assert set(got) == set(want)
    moved = [k for k in got if not torch.equal(got[k], before[k])]
    assert moved and all(k.startswith(("tower.sa1.", "tower.sa2.",
                                       "tower.flow_module.")) for k in moved)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_plain_affine_at_the_512_wide_pooling_matches_jax_kernel():
    """The classifier's pooling stage: [B, 1, 256, 259], 512 -> 512, ReLU,
    folded batch norms of both signs; 2e-5 as the other affine rows."""
    rng = np.random.default_rng(3)
    f = lambda *s, sc=1.0, at=0.0: (rng.standard_normal(s) * sc + at
                                    ).astype(np.float32)
    tbl = f(2, 1, 256, 259)
    tbl[:, :, 1] = tbl[:, :, 0]
    ws = [f(259, 512, sc=259 ** -0.5), f(512, 512, sc=512 ** -0.5)]
    a_s = [f(512, sc=0.2, at=1.0), f(512, sc=0.2, at=1.0)]
    a_s[1][::3] *= -1
    b_s = [f(512, sc=0.1), f(512, sc=0.1)]
    want = j_pooled_affine(jnp.asarray(tbl), [jnp.asarray(w) for w in ws],
                           [jnp.asarray(a) for a in a_s],
                           [jnp.asarray(b) for b in b_s], 0.0)
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    got = P.pooled_mlp_affine_plain(torch.from_numpy(tbl), T(ws), T(a_s),
                                    T(b_s), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert P.forward_plan(tbl.shape, (512, 512), 0.0, affine=True)
    for call in (lambda: P.forward_plan(tbl.shape, (512, 512), 0.0),
                 lambda: P.launch_plan(tbl.shape, (512, 512), 0.0,
                                       affine=True)):
        with pytest.raises(ValueError, match="widths <= 256"):
            call()


def test_action_metrics_match_jax():
    """pc_normalize and the clip preparation bit for bit; the protocol's
    Chamfer / 2,048 to f32 noise; the auction EMDs to 5 % (the two
    frameworks' auctions settle bids that tie to f32 noise differently)."""
    rng = np.random.default_rng(6)
    frames = [rng.standard_normal((n, 3)).astype(np.float32) * 0.3
              for n in (1500, 2600)]
    np.testing.assert_array_equal(analysis.pc_normalize(frames[0]),
                                  j_analysis.pc_normalize(frames[0]))
    ours = analysis.pad_clip_with_appropriate_size(
        frames, num_points=512, rng=np.random.default_rng(1))
    theirs = j_analysis.pad_clip_with_appropriate_size(
        frames, num_points=512, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ours, theirs)
    pred = ours[0] + rng.standard_normal(ours[0].shape).astype(np.float32) * 0.02
    cd, emd = analysis.action_position_metrics(
        torch.from_numpy(pred), torch.from_numpy(ours[1]), emd_iters=200)
    cd_j, emd_j = j_analysis.action_position_metrics(
        jnp.asarray(pred), jnp.asarray(ours[1]), emd_iters=200)
    np.testing.assert_allclose(cd, cd_j, rtol=1e-5)
    np.testing.assert_allclose(emd, emd_j, rtol=5e-2)
