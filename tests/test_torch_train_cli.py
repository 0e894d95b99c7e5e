"""The train CLI twin (``tpugan_tpu_torch/cli/train_fluid.py``) and the
port's checkpoint writer.

* A trainer state written by the port is read by the JAX package's
  ``load_checkpoint`` into ``init_fluid_state``'s template, every array
  equal; the manifest keeps the newest ``max_keep`` files, newest first.
* The CLI for 2 iterations at a tiny size on the CPU: ``train_vel`` with
  device sampling and the fused switch, resumed for 2 more with ``--interp
  capped``; ``train_novel`` with the loader's lowres inputs and
  ``--freeze_D``; finite metrics, manifest rotation, ``--resume``
  continuing at ``n_iter``, ``--profile``, ``--fast_d`` for 2 iterations,
  and ``--data_parallel`` raising without a torchrun process group.
  The adversarial gate is held open (a trainer from random weights does not
  pass the masking-loss gate in a few steps), so the critics' paths run.
"""

import functools
import json
import os

import flax
import jax
import numpy as np
import pytest
import torch

import tpugan_tpu_torch.train.step as step_mod
from test_train_step import TINY_FLUID
from tpugan_tpu.config import replace
from tpugan_tpu.train import init_fluid_state as jax_init_fluid_state
from tpugan_tpu.train.checkpoint import load_checkpoint
from tpugan_tpu_torch.checkpoint import _tree_to_torch, load_trainer_state
from tpugan_tpu_torch.cli import train_fluid as cli
from tpugan_tpu_torch.train.checkpoint import save_checkpoint
from tpugan_tpu_torch.train.state import init_fluid_state
from tpugan_tpu_torch.train.step import FluidTrainConfig

TINY = ["--synthetic", "--synthetic_particles", "2000", "--patch_size", "256",
        "--batch_size", "2", "--node_embedding", "32", "--device", "cpu"]


def _port_state(seed=3):
    cfg = FluidTrainConfig(batch_size=2, patch_size=128, node_embedding=32)
    state = init_fluid_state(cfg, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    state.n_iter = 7
    for net in (state.sr, state.tempo, state.spatial):
        net.opt.count, net.opt.sched_count = 7, 7
        for moments in (net.opt.mu, net.opt.nu):
            for k, v in moments.items():
                moments[k] = torch.rand(v.shape, generator=gen)
    return cfg, state


def test_checkpoint_written_by_port_is_read_by_jax(tmp_path):
    cfg, state = _port_state()
    path = str(tmp_path / "ckpt" / "tpugan_checkpoint7.ckpt")
    save_checkpoint(state, path)
    jcfg = replace(TINY_FLUID, use_vel=True, in_node_feats=6)
    _, _, template = jax_init_fluid_state(jcfg, jax.random.PRNGKey(0))
    got = load_checkpoint(os.path.dirname(path), template)
    assert int(got.n_iter) == 7
    for name in ("sr", "tempo", "spatial"):
        net, jnet = getattr(state, name), getattr(got, name)
        sd = net.module.state_dict()
        want = {**_tree_to_torch(flax.core.unfreeze(jnet.params), "params"),
                **_tree_to_torch(flax.core.unfreeze(jnet.batch_stats),
                                 "batch_stats")}
        assert set(want) == set(sd), name
        for k, v in want.items():
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
        adam, sched = jnet.opt_state
        assert int(adam.count) == int(sched.count) == 7
        for moments, tree in ((net.opt.mu, adam.mu), (net.opt.nu, adam.nu)):
            tree = _tree_to_torch(flax.core.unfreeze(tree), "params")
            assert set(tree) == set(moments)
            for k, v in tree.items():
                np.testing.assert_array_equal(v.numpy(), moments[k].numpy())


def test_manifest_keeps_the_newest(tmp_path):
    _, state = _port_state()
    for n in (1, 2, 3):
        state.n_iter = n
        save_checkpoint(state, str(tmp_path / f"tpugan_checkpoint{n}.ckpt"),
                        is_best=n == 2, max_keep=2)
    with open(tmp_path / "latest_checkpoint.txt") as fh:
        assert fh.read().split() == ["tpugan_checkpoint3.ckpt",
                                     "tpugan_checkpoint2.ckpt"]
    assert sorted(os.listdir(tmp_path)) == [
        "best_model.ckpt", "latest_checkpoint.txt", "tpugan_checkpoint2.ckpt",
        "tpugan_checkpoint3.ckpt"]
    assert load_trainer_state(str(tmp_path), device="cpu").n_iter == 3
    assert load_trainer_state(str(tmp_path / "best_model.ckpt"),
                              device="cpu").n_iter == 2


@pytest.fixture
def gate_open(monkeypatch):
    monkeypatch.setattr(step_mod, "FluidTrainConfig",
                        functools.partial(FluidTrainConfig, ml_gate=1e9))


def _run(argv, log_dir, hook=None):
    out = cli.main(argv + TINY + ["--log_dir", str(log_dir)], hook=hook)
    rows = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
    for row in rows:
        assert all(np.isfinite(v) for v in row.values()), row
    return out, rows


def test_cli_train_vel_fused_resume_capped(tmp_path, gate_open, monkeypatch):
    monkeypatch.setenv(cli.FUSED_SWITCH, "1")
    out, rows = _run(["--preset", "train_vel", "--device_sampling", "--iters",
                      "2", "--ckpt_every", "1", "--ckpt_keep", "1"], tmp_path)
    sr = out["state"].sr.module
    assert sr.in_feats == 6 and sr.feature_extractor.EdgeConv_0.fused_train
    assert out["n_iter"] == 2 and out["metrics"]["gate"]
    assert [r["step"] for r in rows if "masking_loss" in r] == [1, 2]
    assert len(out["test_chamfer"]) == 2
    ckpt = tmp_path / "model_ckpt"
    assert sorted(os.listdir(ckpt)) == ["latest_checkpoint.txt",
                                        "tpugan_checkpoint2.ckpt"]
    assert os.path.exists(tmp_path / "samples" / "pred_iter2.npy")

    steps = []
    hook = lambda event, n, metrics: steps.append(n) if event == "start" else None
    # train_vel's flags without its sample dumps (PNG renders are slow)
    out, rows = _run(["--use_vel", "--in_node_feats", "6", "--device_sampling",
                      "--iters", "4", "--ckpt_every", "10", "--resume",
                      "--interp", "capped"], tmp_path, hook)
    assert steps == [3, 4] and out["n_iter"] == 4
    assert load_trainer_state(str(ckpt), device="cpu").n_iter == 4


def test_cli_train_novel_freeze_d(tmp_path, gate_open):
    out, rows = _run(["--preset", "train_novel", "--freeze_D", "--iters", "2",
                      "--ckpt_every", "5"], tmp_path)
    sr = out["state"].sr.module
    assert sr.in_feats == 3 and not sr.feature_extractor.EdgeConv_0.fused_train
    losses = [r for r in rows if "masking_loss" in r]
    assert [r["step"] for r in losses] == [1, 2]
    assert all(r["tempo_G_loss"] != 0 for r in losses)
    assert all(r["tempo_D_loss"] == 0 == r["spatial_D_loss"] for r in losses)


def test_cli_profile(tmp_path):
    out, _ = _run(["--iters", "16", "--ckpt_every", "100", "--profile",
                   "--exact_graph"], tmp_path)
    assert out["n_iter"] == 16
    assert os.listdir(tmp_path / "profile") == ["steps_10_15.json"]


@pytest.mark.parametrize("flag", ["--data_parallel", "--fast_d"])
def test_cli_refuses_unported_flags(tmp_path, gate_open, flag):
    """``--data_parallel`` without a torchrun process group is refused
    (tests/test_torch_data_parallel.py runs the data-parallel steps on two
    ranks); ``--fast_d`` trains 2 iterations through the stacked critics
    and writes its checkpoint."""
    if flag != "--fast_d":
        with pytest.raises(ValueError, match=flag):
            cli.main([flag, "--log_dir", str(tmp_path)] + TINY)
        return
    # train_vel's flags without its sample dumps (PNG renders are slow),
    # at 128-point patches
    tiny = [v if v != "256" else "128" for v in TINY]
    out = cli.main(["--use_vel", "--in_node_feats", "6", "--device_sampling",
                    flag, "--iters", "2", "--ckpt_every", "5", "--log_dir",
                    str(tmp_path)] + tiny)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert all(np.isfinite(v) for row in rows for v in row.values())
    assert out["n_iter"] == 2 and out["metrics"]["gate"]
    steps = [r for r in rows if "masking_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert [r["tempo_D_loss"] != 0 and r["spatial_D_loss"] != 0
            for r in steps] == [False, True]
    back = load_trainer_state(out["checkpoint"], device="cpu")
    assert back.n_iter == 2
