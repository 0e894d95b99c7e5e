"""The port's eval CLI (``tpugan_tpu_torch/cli/eval_fluid.py``) against the
JAX package's, and the data path it reads: the host sampling copy
(``data/sampling.py``) and ``SiamFluidDataset(emit_lowres=True)``.

Both packages take their native C++ patch search and FPS (the port its own
twin of the JAX package's library). The item and CLI comparisons run like
against like, as two cases each (``torch_host_sampling``): the port's plain
versions against the JAX package's numpy / scipy path, and the port's
library against the JAX package's; a separate test holds the port's FPS
against the JAX FPS as it runs here (native when built).

CLI tolerances: the two SRNet forwards agree to f32 noise (about 1e-6 of
the cloud's scale), which moves a Chamfer of nearest distances about 1e-2
of the scale by up to about 3e-4 relative: 1e-3. The MMD to 1e-4 relative.
The EMDs are two eps-optimal auction assignments whose near-tie bids may
resolve differently: 5e-2 relative (see tests/test_torch_eval.py). Counts
(points kept, free-surface particles) are equal.
"""

import json
import os

import numpy as np
import pytest

import tpugan_tpu.cli.eval_fluid as jax_cli
from torch_host_sampling import MODES, host_sampling
from tpugan_tpu.data import sampling as jsampling
from tpugan_tpu.data.fluid import SiamFluidDataset as JDataset
from tpugan_tpu_torch.checkpoint import load_srnet
from tpugan_tpu_torch.cli import eval_fluid as port_cli
from tpugan_tpu_torch.data import sampling as tsampling
from tpugan_tpu_torch.data.fluid import SiamFluidDataset
from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
from tpugan_tpu_torch.ops import neighbors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")


@pytest.fixture(params=MODES)
def sampling_mode(request, monkeypatch):
    host_sampling(monkeypatch, request.param)
    return request.param


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    # the CLIs' own synthetic data: seed 0 + 100, one case, 12,000 particles
    return make_synthetic_fluid_dataset(
        str(tmp_path_factory.mktemp("eval_data")), case_num=1, case_steps=4,
        num_particles=12000, seed=100)


def test_fps_matches_jax_as_built(rng):
    """The port's FPS (its native library) against the JAX package's FPS
    as it runs here (its native library when built): the same indices from
    the same start."""
    pts = rng.standard_normal((3000, 3)).astype(np.float32)
    for start in (0, 1234):
        got, _ = tsampling.farthest_point_sampling(pts, 200, initial_idx=start)
        want, _ = jsampling.farthest_point_sampling(pts, 200, initial_idx=start)
        np.testing.assert_array_equal(got, want)


def test_sample_patch_with_fps_matches_jax(rng, sampling_mode):
    pos = rng.standard_normal((5000, 3)).astype(np.float32)
    for sample_num, fps in ((1024, True), (None, True), (6000, False)):
        got = tsampling.sample_patch_with_fps(
            pos, sample_num, 0.125, rng=np.random.default_rng(7), fps=fps)
        want = jsampling.sample_patch_with_fps(
            pos, sample_num, 0.125, rng=np.random.default_rng(7), fps=fps)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        for k in ("patch_pos", "ds_pos"):
            np.testing.assert_array_equal(got[0][k], want[0][k])


def test_dataset_lowres_items_match_jax(data_root, sampling_mode):
    """emit_lowres items, one after another from one seeded stream: the
    same keys, shapes and values (jitter 0.003 draws its noise too)."""
    kw = dict(sample_num=1024, fps_ratio=0.125, jitter=0.003, seed=3)
    td = SiamFluidDataset(data_root, 1, 4, emit_lowres=True, **kw)
    jd = JDataset(data_root, 1, 4, emit_lowres=True, **kw)
    for i in range(len(td)):
        got, want = td[i], jd[i]
        assert set(got) == set(want) == {"highres_pos", "highres_vel", "h",
                                         "lowres_pos", "lowres_vel"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        assert got["lowres_pos"].shape == (3, 128, 3)
    # the train step's items carry no low-res keys (the default)
    assert "lowres_pos" not in SiamFluidDataset(data_root, 1, 4,
                                                sample_num=1024)[0]


def _jax_cli(argv, monkeypatch, capsys):
    monkeypatch.setattr(jax_cli, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr("sys.argv", ["eval_fluid", *argv])
    jax_cli.main()
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    return json.loads(lines[-1])


def test_eval_cli_matches_jax(data_root, monkeypatch, capsys,
                              sampling_mode):
    """The trained checkpoint on 1,024-point patches (128 inputs), one
    sample, 50 auction rounds per phase."""
    argv = ["--ckpt", CKPT, "--in_node_feats", "6", "--use_vel",
            "--patch_size", "1024", "--num_samples", "1", "--emd_iters", "50",
            "--sequence_length", "4", "--dataset_path", data_root]
    want = _jax_cli(argv, monkeypatch, capsys)
    got = port_cli.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert set(got) == set(want)
    assert got["serving_mode"] == want["serving_mode"]
    for k in ("samples", "pred_point_count", "gt_point_count", "keep_rate",
              "free_surface_count_diff", "free_surface_pred_count",
              "free_surface_gt_count"):
        assert got[k] == want[k], k
    for k, rtol in (("chamfer_norm", 1e-3), ("cycle_chamfer", 1e-3),
                    ("mmd", 1e-4), ("emd", 5e-2), ("cycle_emd", 5e-2)):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_eval_cli_serving_mode_agreement_and_refusals(data_root, tmp_path):
    """bf16 static with the exact twin (the JAX CLI's agreement keys), a
    checkpoint directory with a manifest, and --approx_graph: accepted,
    reported, and the graph-kNN switch back off after main returns."""
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    os.symlink(CKPT, ckpt_dir / "model_20000.ckpt")
    (ckpt_dir / "latest_checkpoint.txt").write_text("model_20000.ckpt\n")
    argv = ["--ckpt", str(ckpt_dir), "--in_node_feats", "6", "--use_vel",
            "--patch_size", "1024", "--num_samples", "1", "--emd_iters", "20",
            "--sequence_length", "4", "--dataset_path", data_root,
            "--device", "cpu", "--compute_dtype", "bf16",
            "--graph_mode", "static", "--agreement_vs_exact"]
    got = port_cli.main(argv)
    assert got["serving_mode"] == {"compute_dtype": "bf16",
                                   "graph_mode": "static",
                                   "approx_graph": False}
    assert 0.9 <= got["keep_mask_agreement_vs_exact"] <= 1.0
    assert 0.0 <= got["chamfer_norm_vs_exact"] < 5e-3
    assert all(np.isfinite(v) for k, v in got.items() if k != "serving_mode")
    approx = port_cli.main(argv + ["--approx_graph"])
    assert approx["serving_mode"]["approx_graph"] is True
    assert neighbors.APPROX_GRAPH_KNN is False
    # 128 inputs: no graph reaches the approximate kernel, so the result
    # is the exact one
    assert {k: v for k, v in approx.items() if k != "serving_mode"} == {
        k: v for k, v in got.items() if k != "serving_mode"}
    with pytest.raises(ValueError, match="flags say"):
        port_cli.main(argv[:4] + ["--node_embedding", "64"] + argv[4:])
    m = load_srnet(ckpt_dir, device="cpu")
    assert m.in_feats == 6 and m.upsample_ratio == 8
