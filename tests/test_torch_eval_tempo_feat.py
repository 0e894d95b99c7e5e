"""The feature-transfer evaluation in the PyTorch port against the JAX
package, on the CPU:

* one head step of ``cli/eval_tempo_feat.py``: ActionCls with its tower
  transferred from the action checkpoint's temporal critic and frozen (an
  optax ``multi_transform`` of Adam and ``set_to_zero`` on the JAX side,
  ``requires_grad=False`` and no Adam slot on the port's), the same
  initial weights carried across, the same dropout multipliers; the loss,
  every running moment (frozen layers' included), the frozen weights
  unchanged and the trainable weights' changes by norm;
* the CLI twin for one epoch on its synthetic set, on the CPU;
* the action demo twin on the CPU, writing its npz.

Both Adam states start from count 100 with mu = 0 and nu = 1, as in
``tests/test_torch_train_step.py``: from a fresh state Adam's first update
is about lr * sign(g), and the sign of a gradient that is zero in exact
arithmetic (a Dense bias under the head's batch norm) is f32 noise.
"""

import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from tpugan_tpu.models.discriminator import ActionCls as JCls
from tpugan_tpu.models.discriminator import \
    transfer_feature_extractor as j_transfer
from tpugan_tpu_torch.checkpoint import _tree_to_torch, state_dict_from_flax
from tpugan_tpu_torch.cli import action_demo, eval_tempo_feat
from tpugan_tpu_torch.models.discriminator import TRANSFERRED, ActionCls
from tpugan_tpu_torch.train.state import Adam

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "action_tempo_20k.ckpt")
B, N, CUTOFF, LR = 4, 512, 2.0, 1e-3
TOL = 2e-2


def _warm(state):
    """Every Adam slot of an optax state at count 100, mu 0, nu 1."""
    def f(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(count=jnp.asarray(100, s.count.dtype),
                              mu=jax.tree_util.tree_map(jnp.zeros_like, s.mu),
                              nu=jax.tree_util.tree_map(jnp.ones_like, s.nu))
        return s
    return jax.tree_util.tree_map(
        f, state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))


def test_head_step_matches_jax(monkeypatch):
    rng = np.random.default_rng(9)
    body = rng.standard_normal((B, N, 3)) * np.array([0.2, 0.4, 0.13])
    pos = np.stack([body + rng.standard_normal((B, N, 3)) * 0.01 * f
                    for f in range(3)]).astype(np.float32)     # [3, B, N, 3]
    labels = np.array([0, 1, 2, 1], np.int32)
    masks = {w: np.where(rng.random((B, w)) < 1 - p, 1 / (1 - p), 0.0
                         ).astype(np.float32)
             for w, p in ((256, 0.3), (64, 0.1))}

    def dropout(self, x, deterministic=None, rng=None):
        if fnn.merge_param("deterministic", self.deterministic,
                           deterministic):
            return x
        return x * jnp.asarray(masks[x.shape[-1]])

    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)

    # the JAX CLI's step (tpugan_tpu/cli/eval_tempo_feat.py)
    jm = JCls(3, num_classes=20)
    frames = [jnp.asarray(p) for p in pos]
    variables = jax.jit(lambda k: jm.init({"params": k, "dropout": k}, frames,
                                          CUTOFF, False))(jax.random.PRNGKey(0))
    with open(CKPT, "rb") as fh:
        dis = serialization.msgpack_restore(fh.read())["tempo_dis"]
    variables = flax.core.unfreeze(j_transfer(variables, dis))
    params, stats = variables["params"], variables["batch_stats"]
    frozen = lambda path: path[0] == "tower" and path[1] in (
        "sa1", "sa2", "flow_module")
    mask = unflatten_dict({k: "frozen" if frozen(k) else "trainable"
                           for k in flatten_dict(params)})
    tx = optax.multi_transform({"trainable": optax.adam(LR),
                                "frozen": optax.set_to_zero()}, mask)

    def loss_fn(p):
        logits, upd = jm.apply({"params": p, "batch_stats": stats}, frames,
                               CUTOFF, True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                            axis=1))
        return nll, upd["batch_stats"]

    @jax.jit
    def step(p, opt_state):
        (nll, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, _ = tx.update(g, opt_state, p)
        return optax.apply_updates(p, upd), bs, nll

    new_params, new_stats, nll_j = step(params, _warm(tx.init(params)))

    # the port's, from the same transferred weights
    cls = ActionCls(3, device="cpu")
    cls.load_state_dict(state_dict_from_flax(variables, cls))
    trainable = {}
    for name, p in cls.named_parameters():
        p.requires_grad_(not name.startswith(TRANSFERRED))
        if p.requires_grad:
            trainable[name] = p
    adam = Adam(trainable, LR, decay_steps=1, decay_rate=1.0)
    adam.count = 100
    adam.nu = {k: torch.ones_like(v) for k, v in adam.nu.items()}
    before = {k: v.clone() for k, v in cls.state_dict().items()}
    nll_t, _ = eval_tempo_feat.train_step(
        cls, adam, torch.from_numpy(pos), torch.from_numpy(labels).long(),
        CUTOFF, keep=[torch.from_numpy(masks[w]) for w in (256, 64)])

    np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=1e-4)
    sd = cls.state_dict()
    want_p = _tree_to_torch(flax.core.unfreeze(new_params), "params")
    old_p = _tree_to_torch(params, "params")
    want_s = _tree_to_torch(flax.core.unfreeze(new_stats), "batch_stats")
    assert set(want_p) | set(want_s) == set(sd)
    for k, v in want_s.items():
        scale = max(1.0, float(v.abs().max()))
        torch.testing.assert_close(sd[k], v, rtol=0, atol=1e-4 * scale,
                                   msg=k)
        if k.startswith(TRANSFERRED):
            assert not torch.equal(sd[k], before[k]), f"{k} did not move"
    changes = []
    for k, v in want_p.items():
        if k.startswith(TRANSFERRED):
            assert torch.equal(sd[k], before[k]) and torch.equal(v, old_p[k])
        else:
            changes.append((k, sd[k] - before[k], v - old_p[k]))
    assert changes and not set(trainable) ^ {k for k, _, _ in changes}
    r = max(float(w.norm()) / w.numel() ** 0.5 for _, _, w in changes)
    for name, got, want in changes:
        err = float((got - want).norm())
        assert err <= TOL * float(want.norm()) + 1e-3 * want.numel() ** 0.5 * r, (
            name, err, float(want.norm()))


def test_cli_twin_one_epoch_on_cpu(tmp_path, capsys):
    res = eval_tempo_feat.main([
        "--synthetic", "--ckpt_path", CKPT, "--epochs", "1", "--num_points",
        "512", "--batch_size", "4", "--synthetic_frames", "4", "--log_dir",
        str(tmp_path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "10 train clips / 6 test clips, 20 classes"
    assert lines[1] == f"initialized feature extractor from {CKPT}"
    assert lines[2].startswith("Total parameters: ")
    assert lines[3].startswith("epoch 0: loss ")
    assert lines[-1] == f"Best video accuracy: {res['best_video_acc']:.3f}"
    assert len(res["train_step_s"]) == 2 and len(res["infer_batch_s"]) == 1
    assert np.isfinite(res["epochs"][0]["nll"])
    assert os.path.exists(tmp_path / "metrics.jsonl")


def test_action_demo_twin_on_cpu(tmp_path, capsys):
    out = tmp_path / "clip.npz"
    res = action_demo.main([
        "--ckpt", CKPT, "--frames_per_clip", "3", "--eval_metrics",
        "--emd_iters", "20", "--synthetic_dir", str(tmp_path / "msr"),
        "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"wrote (3, 2048, 3) upsampled clip to {out}")
    assert lines[1].startswith("action eval protocol: CD/2048 = ")
    saved = np.load(out)
    assert saved["pred"].shape == (3, 2048, 3)
    assert np.isfinite(saved["pred"]).all()
    assert int(saved["label"]) == res["label"]
    assert res["frames"] == 3 and np.isfinite([res["cd"], res["emd"]]).all()
