"""The port's fluid serving and data surfaces against the JAX package's on
the CPU: the bgeo writer and reader, the one-phase auction of a batch
(bench_metrics' EMD) against per-item calls, the ``bench_metrics`` twin,
the fluid demo twin against ``examples/fluid_demo.py``, the
data-generation copy, the ``sim_fluid_sequence`` twin, and the recipe
scripts.

The demo runs on two frames of 1,024 particles (128 low-res inputs) given
through ``--data_dir``. On the JAX side ``position_metrics`` is replaced by
its Chamfer term, the one number the script keeps: the auction EMD's
compile would take about 20 s of the CPU. The port's demo computes that
Chamfer alone.
"""

import filecmp
import importlib.util
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpugan_tpu.cli.sim_fluid_sequence as jax_sim_cli
import tpugan_tpu.datagen as jax_datagen
import tpugan_tpu.eval.analysis as jax_analysis
from tpugan_tpu.data import bgeo as jax_bgeo
from tpugan_tpu.ops import metrics as jmet
from tpugan_tpu_torch import datagen as port_datagen
from tpugan_tpu_torch.cli import bench_metrics, fluid_demo
from tpugan_tpu_torch.cli import sim_fluid_sequence as port_sim_cli
from tpugan_tpu_torch.config import PRESETS
from tpugan_tpu_torch.data import bgeo as port_bgeo
from tpugan_tpu_torch.data.synthetic import synthetic_fluid_sequence
from tpugan_tpu_torch.datagen import mesh as port_mesh
from tpugan_tpu_torch.ops import metrics as tmet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")


def _cloud(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])


def _trees_equal(a, b):
    """Same file names under a and b; npz by content (their zip entries
    carry a time stamp), every other file byte for byte."""
    names = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs)
    assert names(a) == names(b) and names(a)
    for rel in names(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            _npz_equal(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel


# ------------------------------------------------------------------ bgeo

@pytest.mark.parametrize("with_vel", [False, True])
def test_bgeo_writer_bytes_equal_jax(rng, tmp_path, with_vel):
    pos = _cloud(rng, 300, 3)
    vel = _cloud(rng, 300, 3) if with_vel else None
    port_bgeo.write_bgeo(str(tmp_path / "port.bgeo"), pos, vel)
    jax_bgeo.write_bgeo(str(tmp_path / "jax.bgeo"), pos, vel)
    assert ((tmp_path / "port.bgeo").read_bytes()
            == (tmp_path / "jax.bgeo").read_bytes())
    got_pos, got_vel = port_bgeo.numpy_from_bgeo(str(tmp_path / "jax.bgeo"))
    np.testing.assert_array_equal(got_pos, pos)
    if with_vel:
        np.testing.assert_array_equal(got_vel, vel)
    else:
        assert got_vel is None


# --------------------------------------------------------------- auction

def _is_permutation(a):
    return all(sorted(row) == list(range(a.shape[1])) for row in a)


def test_one_phase_auction_of_a_batch_equals_per_item_calls(rng):
    """At one phase (bench_metrics' EMD) the items of a batch bid, win and
    fall back to their nearest target independently: the batch's assignment
    equals the per-item calls, which is what the JAX package's per-item
    split of clouds of 32,768 points or more computes. Five rounds leave
    bidders to the nearest-target fallback, so it takes part."""
    x = np.stack([_cloud(rng, 256, 3, scale=0.1), _cloud(rng, 256, 3)])
    y = np.stack([_cloud(rng, 256, 3, scale=0.1), _cloud(rng, 256, 3)])
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    joint = tmet.auction_assignment(x, y, eps=1e-3, iters=5)
    each = torch.cat([tmet.auction_assignment(x[i:i + 1], y[i:i + 1],
                                              eps=1e-3, iters=5)
                      for i in range(2)])
    assert torch.equal(joint, each)
    assert not any(_is_permutation(row[None].numpy()) for row in joint)


# ---------------------------------------------------------- bench_metrics

def test_bench_metrics_twin_prints_the_jax_metric_lines(capsys):
    lines = bench_metrics.main(["--batch", "2", "--points", "512",
                                "--emd_points", "256", "--emd_iters", "10",
                                "--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [l["metric"] for l in lines] == ["chamfer_8x79872_ms",
                                            "emd_2x256_iters10_ms"]
    assert all(l["device"] == "cpu" and l["value"] > 0 for l in lines)


# ------------------------------------------------------------- fluid demo

def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_fluid_demo", os.path.join(ROOT, "examples", "fluid_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fluid_demo_twin_matches_the_jax_demo(tmp_path, monkeypatch, capsys):
    data = tmp_path / "case"
    data.mkdir()
    for t, (pos, vel) in enumerate(synthetic_fluid_sequence(
            seed=7, num_particles=1024, num_frames=2)):
        np.savez(data / f"data_{t}.npz", pos=pos, vel=vel)
    args = ["--ckpt", CKPT, "--use_vel", "--num_frames", "2",
            "--data_dir", str(data)]

    jax_cds = []

    def chamfer_term(pred, gt, **_):
        pred, gt = jnp.asarray(pred), jnp.asarray(gt)
        jax_cds.append(float(jnp.mean(jmet.chamfer(pred, gt)) / gt.shape[1]))
        return jax_cds[-1], 0.0, 0.0

    monkeypatch.setattr(jax_analysis, "position_metrics", chamfer_term)
    monkeypatch.setattr(sys, "argv", ["fluid_demo.py"] + args
                        + ["--out_dir", str(tmp_path / "jax")])
    _jax_demo().main()
    result = fluid_demo.main(args + ["--out_dir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert result["frames"] == 2 and len(jax_cds) == 2
    np.testing.assert_allclose(result["chamfers"], jax_cds, rtol=1e-4)
    printed = re.findall(r"mean normalized Chamfer vs ground truth: (\S+)",
                         out)
    assert printed[1] == f"{result['chamfer_mean']:.6f}"
    for i in range(2):
        a = np.load(tmp_path / "port" / f"pred_{i}.npy")
        b = np.load(tmp_path / "jax" / f"pred_{i}.npy")
        assert a.shape == b.shape and 128 <= a.shape[0] <= 1024


# ---------------------------------------------------------------- datagen

@pytest.mark.parametrize("shapes", ["parametric", "obj"])
def test_create_fluid_scene_writes_the_jax_files(tmp_path, shapes):
    obj_dir = None
    if shapes == "obj":
        obj_dir = tmp_path / "objs"
        obj_dir.mkdir()
        port_mesh.make_icosphere_obj(str(obj_dir / "ball.obj"), radius=0.3)
        port_mesh.make_box_obj(str(obj_dir / "box.obj"), (0.4, 0.3, 0.5))
    out = {}
    for name, pkg in (("port", port_datagen), ("jax", jax_datagen)):
        root = tmp_path / name
        root.mkdir()
        out[name] = pkg.create_fluid_scene(
            str(root / "scene"), seed=11, particle_radius=0.05,
            coarse_ratio=0.5, obj_dir=obj_dir and str(obj_dir))
    assert out["port"] == out["jax"]
    _trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def _fake_solver_output(sim_dir, rng, frames=3):
    os.makedirs(sim_dir)
    for t in range(frames):
        port_bgeo.write_bgeo(os.path.join(sim_dir,
                                          f"ParticleData_Fluid_{t}.bgeo"),
                             _cloud(rng, 200, 3), _cloud(rng, 200, 3))


def test_process_case_writes_the_jax_npz(rng, tmp_path):
    sim = str(tmp_path / "sim")
    _fake_solver_output(sim, rng)
    assert port_datagen.process_case(sim, str(tmp_path / "port")) == 3
    assert jax_datagen.process_case(sim, str(tmp_path / "jax")) == 3
    _trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_sim_fluid_sequence_synthetic_matches_jax(tmp_path, monkeypatch):
    args = ["--synthetic", "--train_seeds", "2", "--test_seeds", "2",
            "--num_frames", "3", "--num_particles", "512"]
    port_sim_cli.main(args + ["--out_root", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["sim_fluid_sequence"] + args
                        + ["--out_root", str(tmp_path / "jax")])
    jax_sim_cli.main()
    _trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 2          # train, test


def test_sim_fluid_sequence_solver_path_matches_jax(tmp_path, monkeypatch):
    """The solver path with the external binary replaced by a stand-in
    that writes three bgeo frames from the scene's first fluid block:
    scenes, conversion and layout equal the JAX CLI's."""
    def fake_run_simulator(scene_dir, output_dir=None):
        with open(os.path.join(scene_dir, "scene.json")) as fh:
            block = json.load(fh)["FluidModels"][0]["particleFile"]
        pos, vel = port_bgeo.numpy_from_bgeo(os.path.join(scene_dir, block))
        out = os.path.join(scene_dir, "sim_output")
        os.makedirs(out)
        for t in range(3):
            port_bgeo.write_bgeo(os.path.join(
                out, f"ParticleData_Fluid_{t}.bgeo"), pos + 0.01 * t * vel,
                vel)

    args = ["--train_seeds", "1", "--test_seeds", "1",
            "--particle_radius", "0.05"]
    monkeypatch.setattr(port_datagen, "run_simulator", fake_run_simulator)
    monkeypatch.setattr(jax_datagen, "run_simulator", fake_run_simulator)
    port_sim_cli.main(args + ["--out_root", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["sim_fluid_sequence"] + args
                        + ["--out_root", str(tmp_path / "jax")])
    jax_sim_cli.main()
    _trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.exists(tmp_path / "port" / "train_data_0.05_fine" /
                          "case1" / "data_2.npz")


def test_run_simulator_refuses_without_the_solver(tmp_path, monkeypatch):
    from tpugan_tpu_torch.datagen import splishsplash_config as ss_cfg

    monkeypatch.setattr(ss_cfg, "SIMULATOR_BIN", str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="SPlisHSPlasH"):
        port_datagen.run_simulator(str(tmp_path))


# ---------------------------------------------------------------- recipes

@pytest.mark.parametrize("script", ["train_vel", "train_novel", "train_dir",
                                    "eval_dis"])
def test_recipe_scripts_run_the_port_cli_with_the_jax_preset(script):
    def exec_line(path):
        with open(path) as fh:
            line = [l for l in fh if l.startswith("exec ")][0]
        return re.match(r"exec python -m (\S+)\.cli\.(\w+) --preset (\w+) "
                        r'"\$@"$', line.strip()).groups()
    pkg, cli, preset = exec_line(os.path.join(ROOT, "scripts",
                                              f"{script}_torch.sh"))
    assert pkg == "tpugan_tpu_torch"
    assert exec_line(os.path.join(ROOT, "scripts", f"{script}.sh")) == (
        "tpugan_tpu", cli, preset)
    assert preset in PRESETS[cli]
    assert os.access(os.path.join(ROOT, "scripts", f"{script}_torch.sh"),
                     os.X_OK)
