"""The action GAN's training in the PyTorch port against the JAX package, on
the CPU at ``TINY_ACTION`` with 4 clips (of 3 frames, 128 high-res points, 8
inputs, r 16, width 32; at 2 clips the critics' heads batch-normalise over
two items, and their gradients to the generator move past the step's
tolerances under f32 noise):

* ``ActionSpatialDis`` scores and batch-statistic updates, the port's
  weights carried to flax, at eval and in training (dropout replaced by the same
  multipliers on both sides);
* one action step over an odd and an even iteration against
  ``make_action_gan_step`` with device sampling, the port's draws rebuilt
  from the JAX step's ``jax.random.split(key, 13)``; both sides start each
  iteration from the same state (the JAX state carried into the port by
  the trainer-state bridge), dropout off on both (flax's
  ``Dropout.__call__`` patched to the identity, all-ones multipliers), Adam
  from count 100 with mu 0 and nu 1 (``tests/test_torch_train_step.py``
  says why); the five metrics to 3e-2, each net's update by norm
  (``assert_net_close``, its tolerances);
* the trainer-state bridge both ways, every leaf equal;
* the ``train_action`` twin for 3 iterations of synthetic data, resumed
  from a JAX-written checkpoint, with the test split and a checkpoint read
  back by the JAX package; ``--fast_d`` for 2 iterations and
  ``--data_parallel`` refused without a torchrun process group;
* NoMaskSRNet's fused-EdgeConv training path against the grouped one;
  Adam's schedule against optax's, constant below 10 iterations.

One JAX step is compiled for the module (the ``jax_run`` fixture), from the
port's initial weights carried over in the checkpoint payload (no JAX init
is compiled).
"""

import dataclasses
import json
import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_step import assert_net_close
from test_train_step import TINY_ACTION
from tpugan_tpu.config import ActionTrainConfig as JActionTrainConfig
from tpugan_tpu.config import PRESETS as J_PRESETS
from tpugan_tpu.config import replace
from tpugan_tpu.losses.gan import lsgan_labels
from tpugan_tpu.models.discriminator import ActionSpatialDis as JSpatial
from tpugan_tpu.train import make_action_gan_step
from tpugan_tpu.train.state import GanTrainState, NetState
from tpugan_tpu.train.step import _make_optimizers, build_action_models
from tpugan_tpu.train.checkpoint import load_checkpoint
from tpugan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tpugan_tpu_torch.checkpoint import (_tree_to_torch,
                                         load_action_trainer_state,
                                         state_dict_from_flax)
from tpugan_tpu_torch.cli import train_action as cli
from tpugan_tpu_torch.config import PRESETS, ActionTrainConfig
from tpugan_tpu_torch.data import sampling
from tpugan_tpu_torch.models.discriminator import ActionSpatialDis
from tpugan_tpu_torch.models.generator import NoMaskSRNet
from tpugan_tpu_torch.train.checkpoint import (flax_variables,
                                               save_checkpoint,
                                               trainer_payload)
from tpugan_tpu_torch.train.state import init_action_state
from tpugan_tpu_torch.train.step import ActionGanStep, ActionStepDraws

CFG = replace(TINY_ACTION, batch_size=4, device_sampling=True)
START_ITER = 100
NETS = ("sr", "tempo", "spatial")
FLAX_NAMES = ("sr_net", "tempo_dis", "spatial_dis")


def port_config(cfg):
    names = {f.name for f in dataclasses.fields(ActionTrainConfig)}
    return ActionTrainConfig(**{k: getattr(cfg, k) for k in names})


def draws_from_key(key, cfg, m):
    """The port's draws of one JAX action-step key (``make_action_gan_step``'s
    key schedule), dropout off."""
    f, b = cfg.frames_per_clip, cfg.batch_size
    nr = cfg.lowres_size * cfg.upsample_ratio

    @jax.jit
    def arrays(key):
        keys = jax.random.split(key, 13)
        perm_keys = jax.random.split(keys[1], f + 1)
        target = lambda k: jax.random.uniform(k, (), minval=0.8, maxval=1.2)
        return dict(
            labels=jnp.stack(lsgan_labels(keys[0])),
            perms=jnp.stack([jax.random.permutation(perm_keys[i], nr)
                             for i in range(f)]),
            sp_perm=jax.random.permutation(perm_keys[f], nr),
            sp_target=target(keys[3]), tp_target=target(keys[5]),
            sp_perm_d=jax.random.permutation(keys[8], nr),
            fps_start=jax.random.randint(keys[12], (f * b,), 0, m,
                                         dtype=jnp.int32))

    got = {k: np.array(v) for k, v in arrays(key).items()}
    t = lambda k: torch.from_numpy(got[k]).long()
    return ActionStepDraws(
        labels=tuple(float(x) for x in got["labels"]), perms=t("perms"),
        sp_perm=t("sp_perm"), sp_target=float(got["sp_target"]),
        tp_target=float(got["tp_target"]), sp_perm_d=t("sp_perm_d"),
        fps_start=t("fps_start"),
        keep={c: [torch.ones(b, w) for w in (256, 64)]
              for c in ActionStepDraws.CALLS})


def _params(jnet):
    return _tree_to_torch(flax.core.unfreeze(jnet.params), "params")


def jax_state(payload):
    """A JAX trainer state (``tpugan_tpu.train.state.GanTrainState``) of a
    checkpoint payload in the JAX schema (``trainer_payload``'s): the
    optax states as ``optax.adam`` keeps them."""
    def net(name, flax_name):
        opt = payload[f"{name}_optim"]
        tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
        return NetState(
            params=tree(payload[flax_name]["params"]),
            batch_stats=tree(payload[flax_name]["batch_stats"]),
            opt_state=(optax.ScaleByAdamState(
                count=jnp.asarray(opt["0"]["count"]), mu=tree(opt["0"]["mu"]),
                nu=tree(opt["0"]["nu"])),
                optax.ScaleByScheduleState(count=jnp.asarray(opt["1"]["count"]))))

    return GanTrainState(n_iter=jnp.asarray(payload["n_iter"]),
                         **{n: net(n, f) for n, f in zip(NETS, FLAX_NAMES)})


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer at CFG over an odd and an even iteration, from the
    port's fresh trainer (seed 0) with Adam at count START_ITER, mu 0 and
    nu 1, carried into JAX by the port's checkpoint payload: for each
    iteration the checkpoint (the JAX package's writer) of the state it
    started from, its key, the state's params before and the JAX state and
    metrics after; dropout off. Also the batch."""
    state = init_action_state(port_config(CFG), 0, "cpu")
    state.n_iter = START_ITER
    for net in (state.sr, state.tempo, state.spatial):
        net.opt.count = net.opt.sched_count = START_ITER
        net.opt.nu = {k: torch.ones_like(v) for k, v in net.opt.nu.items()}
    jstate = jax_state(trainer_payload(state))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        step = make_action_gan_step(build_action_models(CFG),
                                    _make_optimizers(CFG), CFG)
        f, b = CFG.frames_per_clip, CFG.batch_size
        m = CFG.num_points
        rng = np.random.default_rng(7)
        batch = (rng.standard_normal((f, b, m, 3)) * 0.3).astype(np.float32)
        root = tmp_path_factory.mktemp("action_states")
        out = []
        for key in jax.random.split(jax.random.PRNGKey(11), 2):
            path = str(root / f"state_{int(jstate.n_iter)}.ckpt")
            jax_save_checkpoint(jstate, path)
            before = {n: _params(getattr(jstate, n)) for n in NETS}
            jstate, jm = step(jstate, {"highres_pos": jnp.asarray(batch)}, key)
            out.append(dict(path=path, key=key, before=before,
                            after=jax.device_get(jstate),
                            metrics={k: float(v) for k, v in jm.items()}))
    finally:
        mp.undo()
    return dict(batch=batch, iterations=out)


@pytest.mark.parametrize("iteration", ["odd", "even"])
def test_action_gan_step_matches_jax(jax_run, iteration):
    it = jax_run["iterations"][["odd", "even"].index(iteration)]
    pcfg = port_config(CFG)
    state = load_action_trainer_state(it["path"], pcfg, device="cpu")
    before = {n: ({k: p.detach().clone() for k, p in
                   getattr(state, n).module.named_parameters()}, it["before"][n])
              for n in NETS}
    batch = {"highres_pos": torch.from_numpy(jax_run["batch"])}
    got = ActionGanStep(pcfg)(state, batch,
                              draws_from_key(it["key"], CFG, CFG.num_points))
    assert set(got) == set(it["metrics"])
    assert (got["tempo_D_loss"] != 0.0) == (iteration == "even")
    for k, v in it["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=3e-2, atol=1e-5, err_msg=k)
    assert state.n_iter == int(it["after"].n_iter)
    for n in NETS:
        assert_net_close(getattr(state, n), getattr(it["after"], n), before[n],
                         n)


def _masks(seed, b):
    rng = np.random.default_rng(seed)
    return {w: np.where(rng.random((b, w)) < 1 - p, 1 / (1 - p), 0.0
                        ).astype(np.float32)
            for w, p in ((256, 0.3), (64, 0.1))}


@pytest.mark.parametrize("train", [False, True])
def test_action_spatial_dis_matches_jax(monkeypatch, train):
    """The port's weights carried to flax (the checkpoint writer's
    ``flax_variables``): scores to 1e-4 of max(1, |ref|), and in training
    every batch statistic and spectral-norm vector to 1e-4 of its
    tensor's largest value (at least 1); 4 clips of 256 points."""
    rng = np.random.default_rng(3)
    b, n = 4, 256
    pos = (rng.standard_normal((b, n, 3)) * np.array([0.2, 0.4, 0.13])
           ).astype(np.float32)
    masks = _masks(4, b)

    def dropout(self, x, deterministic=None, rng=None):
        if fnn.merge_param("deterministic", self.deterministic, deterministic):
            return x
        return x * jnp.asarray(masks[x.shape[-1]])

    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    jm = JSpatial()
    tm = ActionSpatialDis(generator=torch.Generator().manual_seed(5),
                          device="cpu")
    variables = flax_variables(tm)
    if train:
        want, new = jax.jit(lambda v: jm.apply(
            v, jnp.asarray(pos), None, True, mutable=["batch_stats"]))(variables)
    else:
        want = jax.jit(lambda v: jm.apply(v, jnp.asarray(pos), None, False))(
            variables)
    keep = [torch.from_numpy(masks[w]) for w in (256, 64)]
    with torch.no_grad():
        got = tm(torch.from_numpy(pos), None, train=train, keep=keep)
    want = np.asarray(want)
    assert got.shape == (b, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    if train:
        stats = _tree_to_torch(flax.core.unfreeze(new["batch_stats"]),
                               "batch_stats")
        sd = tm.state_dict()
        assert stats and set(stats) <= set(sd)
        for k, v in stats.items():
            np.testing.assert_allclose(
                sd[k].numpy(), v.numpy(), rtol=0,
                atol=1e-4 * max(1.0, float(v.abs().max())), err_msg=k)


def _assert_state_equal(state, jstate):
    """Every parameter, batch statistic, Adam moment and count of a port
    trainer state equal to a JAX one's."""
    assert state.n_iter == int(jstate.n_iter)
    for name in NETS:
        net, jnet = getattr(state, name), getattr(jstate, name)
        sd = net.module.state_dict()
        want = {**_params(jnet),
                **_tree_to_torch(flax.core.unfreeze(jnet.batch_stats),
                                 "batch_stats")}
        assert set(want) == set(sd), name
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
        adam, sched = jnet.opt_state
        assert (net.opt.count, net.opt.sched_count) == (int(adam.count),
                                                        int(sched.count))
        for moments, tree in ((net.opt.mu, adam.mu), (net.opt.nu, adam.nu)):
            tree = _tree_to_torch(flax.core.unfreeze(tree), "params")
            assert set(tree) == set(moments), name
            for k, v in tree.items():
                np.testing.assert_array_equal(moments[k].numpy(), v.numpy(),
                                              err_msg=k)


def test_trainer_state_written_by_jax_is_read_by_port(jax_run):
    it = jax_run["iterations"][1]
    state = load_action_trainer_state(it["path"], port_config(CFG),
                                      device="cpu")
    _assert_state_equal(state, jax_run["iterations"][0]["after"])
    assert state.tempo.opt.lr == pytest.approx(CFG.dis_lr_factor * CFG.lr)
    assert state.sr.opt.decay_steps == CFG.lr_decay_steps


def test_trainer_state_written_by_port_is_read_by_jax(jax_run, tmp_path):
    """The port's writer on the state after the odd iteration (in the
    port), read by the JAX package's load_checkpoint into
    init_action_state's template; and max_keep pruning of the manifest."""
    it = jax_run["iterations"][1]
    state = load_action_trainer_state(it["path"], port_config(CFG),
                                      device="cpu")
    ckpt = tmp_path / "model_ckpt"
    for i in range(3):
        save_checkpoint(state, str(ckpt / f"tpugan_checkpoint{i}.ckpt"),
                        max_keep=2)
    assert sorted(os.listdir(ckpt)) == ["latest_checkpoint.txt",
                                        "tpugan_checkpoint1.ckpt",
                                        "tpugan_checkpoint2.ckpt"]
    template = jax_run["iterations"][0]["after"]
    _assert_state_equal(state, load_checkpoint(str(ckpt), template))


def test_config_and_preset_match_jax():
    ours, theirs = ActionTrainConfig(), JActionTrainConfig()
    for f in dataclasses.fields(ActionTrainConfig):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.lowres_size == theirs.lowres_size == 128
    for iters in (100000, 20004):
        assert (ActionTrainConfig(iters=iters).lr_decay_steps
                == JActionTrainConfig(iters=iters).lr_decay_steps)
    assert PRESETS["train_action"] == J_PRESETS["train_action"]


TINY_CLI = ["--synthetic", "--synthetic_videos", "6", "--synthetic_frames",
            "6", "--num_points", str(CFG.num_points), "--batch_size",
            str(CFG.batch_size), "--node_embedding", str(CFG.node_embedding),
            "--device", "cpu"]


def test_cli_resumes_jax_state_and_writes_checkpoints(jax_run, tmp_path,
                                                      monkeypatch):
    """3 iterations (101-103) with device sampling, the test split and its
    sample renders at 101 and 103 (the renderer saves the clouds instead,
    at a tenth of the time), resumed from the JAX state at 100; the last
    checkpoint read by the JAX package equal to the state returned."""
    monkeypatch.setattr(sampling, "dump_pointcloud_visualization",
                        lambda pos, name: np.save(name + ".npy", pos))
    log = str(tmp_path / "run")
    out = cli.main(TINY_CLI + [
        "--device_sampling", "--dump_visualization", "--exact_graph",
        "--resume", "--path_to_resume", jax_run["iterations"][0]["path"],
        "--iters", str(START_ITER + 3), "--ckpt_every", "2", "--log_dir", log])
    assert out["n_iter"] == START_ITER + 3
    assert set(out["metrics"]) == {"tempo_G_loss", "tempo_D_loss",
                                   "Chamfer_distance_no_norm",
                                   "spatial_G_loss", "spatial_D_loss"}
    assert len(out["test_chamfer"]) == 2
    assert all(np.isfinite(v) for v in out["test_chamfer"])
    with open(os.path.join(log, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    steps = [r for r in rows if "tempo_G_loss" in r]
    assert [r["step"] for r in steps] == [101, 102, 103]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    assert [r["tempo_D_loss"] != 0 for r in steps] == [False, True, False]
    samples = os.listdir(os.path.join(log, "samples"))
    assert len(samples) == 2 * 4 * 3
    ckpt = os.path.join(log, "model_ckpt")
    with open(os.path.join(ckpt, "latest_checkpoint.txt")) as fh:
        assert fh.read().split() == ["tpugan_checkpoint103.ckpt",
                                     "tpugan_checkpoint101.ckpt"]
    template = jax_run["iterations"][0]["after"]
    _assert_state_equal(out["state"], load_checkpoint(ckpt, template))
    assert out["state"].sr.opt.decay_steps == (START_ITER + 3) // 10


@pytest.mark.parametrize("flag", ["--fast_d", "--data_parallel"])
def test_cli_refuses_unported_flags(tmp_path, flag):
    """``--data_parallel`` without a torchrun process group is refused
    (tests/test_torch_data_parallel.py runs the data-parallel steps on two
    ranks); ``--fast_d`` trains 2 iterations through the stacked critics
    and writes its checkpoint."""
    if flag != "--fast_d":
        with pytest.raises(ValueError, match=flag):
            cli.main(TINY_CLI + [flag, "--iters", "1", "--log_dir",
                                 str(tmp_path)])
        return
    log = str(tmp_path / "run")
    out = cli.main(TINY_CLI + [flag, "--device_sampling", "--iters", "2",
                               "--log_dir", log])
    assert out["n_iter"] == 2
    with open(os.path.join(log, "metrics.jsonl")) as fh:
        steps = [r for r in map(json.loads, fh) if "tempo_G_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    assert [r["tempo_D_loss"] != 0 and r["spatial_D_loss"] != 0
            for r in steps] == [False, True]
    back = load_action_trainer_state(out["checkpoint"],
                                     port_config(replace(CFG, iters=2)),
                                     device="cpu")
    assert back.n_iter == 2


def test_nomask_fused_training_matches_grouped():
    """The fused EdgeConv path's gradients (on the CPU, the kernels' plain
    versions and the backward's) equal the grouped formulation's to f32
    noise, every parameter by norm."""
    gen = torch.Generator().manual_seed(0)
    low = torch.randn(6, 16, 3, generator=gen) * 0.3
    target = torch.randn(6, 256, 3, generator=gen)
    grads = {}
    for fused in (False, True):
        net = NoMaskSRNet(3, node_emb_dim=32, upsample_ratio=16,
                          fused_train=fused,
                          generator=torch.Generator().manual_seed(2),
                          device="cpu")
        out, _ = net(low, low, train=True)
        loss = ((out - target) ** 2).mean()
        grads[fused] = dict(zip(
            [k for k, _ in net.named_parameters()],
            torch.autograd.grad(loss, list(net.parameters()))))
    for k, want in grads[False].items():
        err = float((grads[True][k] - want).norm())
        assert err <= 1e-4 * float(want.norm()) + 1e-8, k


@pytest.mark.parametrize("decay_steps,rate", [(0, 0.72), (10, 0.72), (10, 0.0)])
def test_adam_schedule_matches_optax(decay_steps, rate):
    """The staircase schedule at the counts a short run reaches, as
    ``optax.exponential_decay`` gives it: constant where the run is shorter
    than 10 iterations (``iters // 10`` decay steps is 0) or the rate is 0."""
    from tpugan_tpu_torch.train.state import Adam

    opt = Adam({"w": torch.nn.Parameter(torch.zeros(1))}, 3e-4, decay_steps,
               rate)
    want = optax.exponential_decay(3e-4, decay_steps, rate, staircase=True)
    for count in (0, 5, 10, 25):
        opt.sched_count = count
        assert opt.learning_rate() == pytest.approx(float(want(count)),
                                                    rel=1e-6)
