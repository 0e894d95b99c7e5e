"""The port's rollout CLI (``tpugan_tpu_torch/cli/rollout.py``) against the
JAX package's (``tpugan_tpu/cli/rollout.py``), both run in this process on
the same synthetic frames and the committed checkpoint.

Both run the static graph (one kNN on positions), so no feature-space
near-tie can reorder neighbours between the two, f32, at 256 particles and
3 frames. The JAX CLI runs once for the module, with its compile-cache
switch turned off (it would move the cache directory the test
configuration set).
"""

import os
import sys

import numpy as np
import pytest

import tpugan_tpu.cli.rollout as jax_rollout_cli
from tpugan_tpu_torch.cli import rollout as rollout_cli
from tpugan_tpu_torch.data.bgeo import read_bgeo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")
FRAMES = 3
ARGS = ["--ckpt", CKPT, "--use_vel", "--in_node_feats", "6",
        "--graph_mode", "static", "--synthetic", "--synthetic_particles",
        "256", "--num_frames", str(FRAMES)]


def _preds(out_dir):
    return [np.load(os.path.join(out_dir, f"pred_{i}.npy"))
            for i in range(FRAMES)]


@pytest.fixture(scope="module")
def jax_preds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_rollout"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rollout_cli, "_enable_compile_cache", lambda: None)
        mp.setattr(sys, "argv", ["rollout"] + ARGS + ["--out_dir", out])
        jax_rollout_cli.main()
    return _preds(out)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """(result, out_dir) of the port's CLI on the device path, with bgeo."""
    out = str(tmp_path_factory.mktemp("port_rollout"))
    result = rollout_cli.main(ARGS + ["--out_dir", out, "--export_bgeo",
                                      "--device", "cpu"])
    return result, out


def test_rollout_cli_matches_jax(jax_preds, port_run):
    result, out = port_run
    assert result["frames"] == FRAMES and result["device"] == "cpu"
    for a, b in zip(_preds(out), jax_preds):
        assert a.shape == b.shape
        assert 256 <= a.shape[0] <= 8 * 256
        # f32 noise of the forward, as tests/test_torch_rollout.py holds it
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_rollout_cli_host_pipeline_matches_device_path(port_run, tmp_path):
    _, out = port_run
    rollout_cli.main(ARGS + ["--out_dir", str(tmp_path), "--host_pipeline",
                             "--device", "cpu"])
    for a, b in zip(_preds(str(tmp_path)), _preds(out)):
        np.testing.assert_array_equal(a, b)


def test_rollout_cli_bgeo_reads_back(port_run):
    _, out = port_run
    for i, pred in enumerate(_preds(out)):
        pos, attrs = read_bgeo(os.path.join(out, f"pred_{i}.bgeo"))
        np.testing.assert_array_equal(pos, pred)
        assert attrs == {}


@pytest.mark.parametrize("flags", [["--shard_points"],
                                   ["--mesh_devices", "2"]])
def test_rollout_cli_refuses_point_sharding(flags, tmp_path):
    """Point sharding runs over the ranks of a torchrun launch: without a
    process group ``--shard_points`` is refused, and ``--mesh_devices``
    without ``--shard_points`` too (tests/test_torch_sharded_serving.py
    runs it under torchrun)."""
    why = ("launch with torchrun" if "--shard_points" in flags
           else "needs --shard_points")
    with pytest.raises(SystemExit, match=why):
        rollout_cli.main(ARGS + flags + ["--out_dir", str(tmp_path),
                                         "--device", "cpu"])


def test_rollout_cli_refuses_flags_the_checkpoint_disagrees_with(tmp_path):
    args = [a if a != "6" else "3" for a in ARGS]    # --in_node_feats 3
    with pytest.raises(ValueError, match="the flags say"):
        rollout_cli.main(args + ["--out_dir", str(tmp_path), "--device",
                                 "cpu"])


def test_rollout_cli_frames_in_digit_order(tmp_path):
    for i in (10, 2, 1, 0):
        np.savez(tmp_path / f"data_{i}.npz",
                 pos=np.full((4, 3), i, np.float32))
    opt = rollout_cli.parser().parse_args(["--data_dir", str(tmp_path),
                                           "--num_frames", "3"])
    frames = rollout_cli.load_frames(opt)
    assert [int(p[0, 0]) for p, _ in frames] == [0, 1, 2]
    assert all(v is None for _, v in frames)


@pytest.mark.parametrize("approx_graph,before", [(True, False), (False, True)])
def test_rollout_cli_approx_graph_holds_for_the_run(approx_graph, before,
                                                    monkeypatch, tmp_path):
    """The graph kNN runs approximate exactly when ``--approx_graph`` is
    given, whatever the switch was before; the switch is restored after."""
    from tpugan_tpu_torch.ops import neighbors

    seen, knn = [], neighbors.knn

    def spy(*args, **kw):
        if "approx" in kw:                  # graph_knn passes the switch
            seen.append(kw["approx"])
        return knn(*args, **kw)

    monkeypatch.setattr(neighbors, "knn", spy)
    monkeypatch.setattr(neighbors, "APPROX_GRAPH_KNN", before)
    flag = ["--approx_graph"] if approx_graph else []
    rollout_cli.main(ARGS + flag + ["--out_dir", str(tmp_path), "--device",
                                    "cpu"])
    assert len(seen) == FRAMES and set(seen) == {approx_graph}
    assert neighbors.APPROX_GRAPH_KNN is before
