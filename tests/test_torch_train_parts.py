"""The train step's parts in the PyTorch port against the JAX package: the
geometric and LSGAN losses (values and the gradient through the Chamfer
nearest neighbour), Adam with the staircase schedule against optax, the
trainer-state bridge on the committed ``fluid_vel_20k.ckpt``, and the
synthetic fluid data with its dataset and batch iterator.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tpugan_tpu.data.fluid import SiamFluidDataset as JDataset
from tpugan_tpu.data.fluid import fluid_batch_iterator as j_batches
from tpugan_tpu.data.synthetic import make_synthetic_fluid_dataset as j_make
from tpugan_tpu.losses import gan as jgan
from tpugan_tpu.losses import geometry as jgeo
from tpugan_tpu.train.state import make_optimizer
from tpugan_tpu_torch.checkpoint import (_tree_to_torch, adam_from_flax,
                                         load_trainer_state)
from tpugan_tpu_torch.data.fluid import SiamFluidDataset, fluid_batch_iterator
from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
from tpugan_tpu_torch.losses import gan as tgan
from tpugan_tpu_torch.losses import geometry as tgeo
from tpugan_tpu_torch.train.state import Adam

T = torch.from_numpy
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "fluid_vel_20k.ckpt")


# ---------------------------------------------------------------- losses

def _clouds(rng, b=2, n=40, r=8):
    gt = (rng.standard_normal((b, n * r, 3)) * 0.1).astype(np.float32)
    pred = gt + (rng.standard_normal(gt.shape) * 0.01).astype(np.float32)
    inp = gt[:, ::r] + (rng.standard_normal((b, n, 3)) * 0.005).astype(np.float32)
    mask = rng.random((b, n)).astype(np.float32)
    return gt, pred, inp, mask


@pytest.mark.parametrize("n_iter", [5, 20])
def test_sr_loss_and_gradient_match_jax(rng, n_iter):
    """Chamfer + masking loss (pinned to 1 for n_iter <= 10) and its
    gradient for the predicted points and the mask: f32 sums in another
    order, 1e-5 relative."""
    gt, pred, inp, mask = _clouds(rng)
    valid = rng.random(pred.shape[:2]) > 0.1

    def jfn(p, m):
        return jgeo.tpugan_sr_loss(100.0, jnp.asarray(gt), p, jnp.asarray(inp),
                                   m, 0.025, n_iter,
                                   pred_valid=jnp.asarray(valid))

    (l_j, cd_j, ml_j), vjp = jax.vjp(jfn, jnp.asarray(pred), jnp.asarray(mask))
    gp_j, gm_j = vjp((jnp.ones(()), jnp.zeros(()), jnp.zeros(())))
    p_t, m_t = T(pred).requires_grad_(), T(mask).requires_grad_()
    l_t, cd_t, ml_t = tgeo.tpugan_sr_loss(100.0, T(gt), p_t, T(inp), m_t,
                                          0.025, n_iter, pred_valid=T(valid))
    l_t.backward()
    for a, b in ((l_t, l_j), (cd_t, cd_j), (ml_t, ml_j)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(gp_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gp_j)).max())
    g_m = m_t.grad if m_t.grad is not None else torch.zeros_like(m_t)
    np.testing.assert_allclose(g_m.numpy(), np.asarray(gm_j), rtol=0, atol=1e-7)


def test_chamfer_and_masking_losses_match_jax(rng):
    gt, pred, inp, mask = _clouds(rng)
    gt_valid = rng.random(gt.shape[:2]) > 0.2
    np.testing.assert_allclose(
        float(tgeo.chamfer_distance_loss(T(gt), T(pred), T(gt_valid))),
        float(jgeo.chamfer_distance_loss(jnp.asarray(gt), jnp.asarray(pred),
                                         jnp.asarray(gt_valid))), rtol=1e-5)
    np.testing.assert_allclose(
        float(tgeo.masking_loss(T(gt), T(inp), T(mask), 0.025, T(gt_valid))),
        float(jgeo.masking_loss(jnp.asarray(gt), jnp.asarray(inp),
                                jnp.asarray(mask), 0.025,
                                jnp.asarray(gt_valid))), rtol=1e-6)


def test_lsgan_losses_match_jax(rng):
    true, fake = (rng.standard_normal((4, 1)).astype(np.float32)
                  for _ in range(2))
    np.testing.assert_allclose(
        float(tgan.lsgan_generator_loss(T(fake), 0.9)),
        float(jgan.lsgan_generator_loss(jnp.asarray(fake), 0.9)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tgan.lsgan_discriminator_loss(T(true), T(fake), 1.1, 0.1)),
        float(jgan.lsgan_discriminator_loss(jnp.asarray(true), jnp.asarray(fake),
                                            1.1, 0.1)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        valid, invalid = tgan.lsgan_labels(gen)
        assert (0.8 <= valid <= 1.2 and 0.0 <= invalid <= 0.2) or (
            0.8 <= invalid <= 1.2 and 0.0 <= valid <= 0.2)


# ---------------------------------------------------------------- Adam

def test_adam_with_schedule_matches_optax(rng):
    """Three updates with decay every 2 steps, so the third crosses a decay
    boundary; a parameter without a gradient takes a zero one, as optax
    sees it. f32 arithmetic in another order: 1e-6 of the parameters."""
    shapes = {"a": (3, 4), "b": (5,), "unused": (2,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = make_optimizer(1e-2, 2, 0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in params.items()}
    opt = Adam(tp, 1e-2, 2, 0.5)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g["unused"] = np.zeros(shapes["unused"], np.float32)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: T(v) for k, v in g.items() if k != "unused"})
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == int(js[0].count) == 3
    assert opt.sched_count == int(js[1].count) == 3
    for k in shapes:
        np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(js[0].mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------- bridge

@pytest.fixture(scope="module")
def ckpt_tree():
    with open(CKPT, "rb") as fh:
        return serialization.msgpack_restore(fh.read())


def test_trainer_state_bridge_carries_every_leaf(ckpt_tree):
    state = load_trainer_state(CKPT, device="cpu")
    assert state.n_iter == int(ckpt_tree["n_iter"]) == 20000
    for name, net in (("sr", "sr_net"), ("tempo", "tempo_dis"),
                      ("spatial", "spatial_dis")):
        ns = getattr(state, name)
        want = {}
        for col in ("params", "batch_stats"):
            want.update(_tree_to_torch(ckpt_tree[net].get(col, {}), col))
        sd = ns.module.state_dict()
        assert set(sd) == set(want), net
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
        adam = ckpt_tree[f"{name}_optim"]["0"]
        assert ns.opt.count == int(adam["count"])
        assert ns.opt.sched_count == int(ckpt_tree[f"{name}_optim"]["1"]["count"])
        for m in ("mu", "nu"):
            moments = _tree_to_torch(adam[m], "params")
            assert set(moments) == set(ns.opt.params)
            for k, v in moments.items():
                assert torch.equal(getattr(ns.opt, m)[k], v), (name, m, k)
    # the generator's resumed learning rate: 3e-4 * 0.7^2 at 20,000 steps
    assert state.sr.opt.learning_rate() == pytest.approx(3e-4 * 0.49)


def test_trainer_state_bridge_fails_loudly(ckpt_tree):
    state = load_trainer_state(CKPT, device="cpu")
    extra = copy.deepcopy(ckpt_tree["spatial_optim"])
    extra["0"]["mu"]["sa_0"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        adam_from_flax(extra, state.spatial)
    missing = copy.deepcopy(ckpt_tree["spatial_optim"])
    del missing["0"]["nu"]["fc"]
    with pytest.raises(ValueError, match="unfilled"):
        adam_from_flax(missing, state.spatial)


# ---------------------------------------------------------------- data

def test_synthetic_data_and_batches_match_jax(tmp_path):
    """The synthetic sequences byte for byte, then dataset items and
    batches: the same patches (the kd-tree patch of each item; points in
    the same order unless distances tie)."""
    kw = dict(case_num=2, case_steps=5, num_particles=600, seed=1)
    j_root = j_make(str(tmp_path / "jax"), **kw)
    t_root = make_synthetic_fluid_dataset(str(tmp_path / "port"), **kw)
    for case in ("case1", "case2"):
        for t in range(5):
            with np.load(os.path.join(j_root, case, f"data_{t}.npz")) as a, \
                    np.load(os.path.join(t_root, case, f"data_{t}.npz")) as b:
                for k in ("pos", "vel"):
                    assert a[k].tobytes() == b[k].tobytes(), (case, t, k)
    dkw = dict(case_num=2, case_steps=5, sample_num=256)
    jd = JDataset(j_root, emit_lowres=False, **dkw)
    td = SiamFluidDataset(t_root, **dkw)
    assert len(jd) == len(td) == 6
    jb, tb = next(j_batches(jd, 2, seed=3)), next(fluid_batch_iterator(td, 2, seed=3))
    assert set(jb) == set(tb) == {"highres_pos", "highres_vel", "h"}
    for k in jb:
        assert jb[k].shape == tb[k].shape and jb[k].dtype == tb[k].dtype, k
    order = lambda a: np.sort(a.reshape(-1, a.shape[-1]).view(
        [("", a.dtype)] * a.shape[-1]), axis=0)
    for k in ("highres_pos", "highres_vel"):
        for f in range(3):
            for i in range(2):
                np.testing.assert_array_equal(order(tb[k][f, i]),
                                              order(jb[k][f, i]))
    np.testing.assert_array_equal(tb["h"], jb["h"])
