"""Boundaries of the PyTorch port: it imports no JAX, its entry points need
the CUDA card unless the caller names the CPU, and its kernels match their
plain versions on the card (tests marked ``gpu``, skipped without a card;
``python3 chip_smoke.py`` runs the same comparisons at the serving shapes).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpugan_tpu_torch
from tpugan_tpu_torch import PAD_SENTINEL
from tpugan_tpu_torch.checkpoint import load_action_trainer_state, load_srnet
from tpugan_tpu_torch.cli import bench_metrics, fluid_demo
from tpugan_tpu_torch.cli import rollout as rollout_cli
from tpugan_tpu_torch.config import ActionTrainConfig
from tpugan_tpu_torch.models.discriminator import ActionCls, ActionSpatialDis
from tpugan_tpu_torch.models.generator import (NoMaskSRNet, RolloutMaskState,
                                               SRNet)
from tpugan_tpu_torch.ops.kernels import (ball_query, binned_interp, edgeconv,
                                          fps, interp, knn, nn1, pooled_mlp)
from tpugan_tpu_torch.train.state import init_action_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")
ACTION_CKPT = os.path.join(ROOT, "checkpoints", "action_tempo_20k.ckpt")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpugan_tpu_torch\n"
        "for m in pkgutil.walk_packages(tpugan_tpu_torch.__path__, "
        "'tpugan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('train.step', 'train.state', 'models.discriminator', "
        "'nn.setconv', 'nn.flow', 'ops.interpolate', 'losses.geometry', "
        "'data.fluid', 'ops.kernels.pooled_mlp', 'data.sampling', "
        "'eval.analysis', 'cli.eval_fluid', 'ops.kernels.binned_interp', "
        "'ops.metrics', 'cli.train_fluid', 'train.checkpoint', "
        "'utils.logging', 'config', 'data.prefetch', 'data.msr', "
        "'data.native', "
        "'cli.action_demo', 'cli.eval_tempo_feat', 'cli.train_action', "
        "'data.bgeo', 'datagen', 'datagen.mesh', 'datagen.scene_gen', "
        "'datagen.process', 'datagen.splishsplash_config', 'cli.rollout', "
        "'cli.bench_metrics', 'cli.fluid_demo', 'cli.sim_fluid_sequence', "
        "'parallel', 'parallel.mesh', 'parallel.sharded_ops', "
        "'parallel.sharded_serving'):\n"
        "    assert 'tpugan_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpugan_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tpugan_tpu_torch.default_device,
                 lambda: SRNet(in_feats=6),
                 lambda: load_srnet(CKPT),
                 lambda: RolloutMaskState.create(1, 64),
                 lambda: NoMaskSRNet(in_feats=3),
                 lambda: ActionCls(3),
                 lambda: ActionSpatialDis(),
                 lambda: init_action_state(ActionTrainConfig()),
                 lambda: load_action_trainer_state(ACTION_CKPT),
                 lambda: rollout_cli.main(["--ckpt", CKPT]),
                 lambda: bench_metrics.main([]),
                 lambda: fluid_demo.main(["--ckpt", CKPT])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("wrapper", ["knn", "knn_approx", "nn1", "edgeconv",
                                     "edgeconv_tc",
                                     "edgeconv_f32t", "edgeconv_bwd",
                                     "edgeconv_bwd_tiled",
                                     "edgeconv_bwd_tiled_ec0",
                                     "edgeconv_bwd_tiled_idgcn",
                                     "edgeconv_bwd_tiled_sum",
                                     "fps", "ball_query", "interp",
                                     "pooled_mlp", "pooled_mlp_affine",
                                     "binned_interp"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(wrapper):
    # a tensor on neither the CPU nor a CUDA card is refused, not computed
    t = lambda *s: torch.zeros(s, device="meta")
    calls = {
        "knn": lambda: knn.knn_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8), 4),
        "knn_approx": lambda: knn.knn_approx_kernel(t(1, 8, 3), t(1, 4096, 3),
                                                    t(1, 4096), 4),
        "nn1": lambda: nn1.nn1_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8)),
        "edgeconv": lambda: edgeconv.edgeconv_fused(
            t(1, 4, 8, 6), t(1, 8, 6), t(6, 8), t(6, 8), t(8, 8), t(8, 16)),
        "edgeconv_tc": lambda: edgeconv.edgeconv_fused(
            t(1, 4, 8, 64).bfloat16(), t(1, 8, 64).bfloat16(), t(64, 128),
            t(64, 128), t(128, 128), t(128, 256),
            compute_dtype=torch.bfloat16),
        "edgeconv_f32t": lambda: edgeconv.edgeconv_fused(
            t(1, 4, 8, 64), t(1, 8, 64), t(64, 128), t(64, 128), t(128, 128),
            t(128, 256)),
        "edgeconv_bwd": lambda: edgeconv.edgeconv_backward(
            t(1, 4, 8, 6), t(1, 8, 6), t(6, 8), t(6, 8), t(8, 8), t(8, 16),
            t(1, 8, 16)),
        "edgeconv_bwd_tiled": lambda: edgeconv.edgeconv_backward(
            t(1, 4, 8, 64), t(1, 8, 64), t(64, 128), t(64, 128),
            t(128, 128), t(128, 256), t(1, 8, 256)),
        "edgeconv_bwd_tiled_ec0": lambda: edgeconv.edgeconv_backward(
            t(1, 4, 8, 6), t(1, 8, 6), t(6, 64), t(6, 64), t(64, 64),
            t(64, 128), t(1, 8, 128)),
        "edgeconv_bwd_tiled_idgcn": lambda: edgeconv.edgeconv_backward(
            t(1, 4, 8, 32), t(1, 8, 32), t(32, 16), t(32, 16), t(16, 16),
            t(16, 32), t(1, 8, 32)),
        "edgeconv_bwd_tiled_sum": lambda: edgeconv.edgeconv_backward(
            t(1, 4, 8, 64), t(1, 8, 64), t(64, 128), t(64, 128), None, None,
            t(1, 8, 128), "sum"),
        "fps": lambda: fps.fps_kernel(t(1, 8, 3), 4, t(1, 8),
                                      torch.zeros(1, dtype=torch.int64,
                                                  device="meta")),
        "ball_query": lambda: ball_query.ball_query_kernel(
            t(1, 8, 3), t(1, 8, 3), 0.1, 4, t(1, 8)),
        "interp": lambda: interp.interp_kernel(t(1, 8, 3), t(1, 8, 3),
                                               t(1, 8, 3), 0.1, t(1, 8)),
        "pooled_mlp": lambda: pooled_mlp.pooled_mlp_bn_train(
            t(1, 2, 4, 6), [t(6, 8)], [t(8)], [t(8)]),
        "pooled_mlp_affine": lambda: pooled_mlp.pooled_mlp_affine(
            t(1, 2, 4, 6), [t(6, 8)], [t(8)], [t(8)]),
        "binned_interp": lambda: binned_interp.binned_interp(
            t(1, 8, 3), t(1, 8, 3), t(1, 8, 3), 0.1, t(1, 8)),
    }
    with pytest.raises(ValueError, match="tensors on"):
        calls[wrapper]()
    assert all(k.launches == 0 for k in (knn.KERNEL, knn.APPROX, nn1.KERNEL,
                                         fps.KERNEL,
                                         edgeconv.KERNEL, edgeconv.BWD,
                                         ball_query.KERNEL, interp.KERNEL,
                                         pooled_mlp.FWD, pooled_mlp.BWD,
                                         pooled_mlp.AFFINE_BWD,
                                         binned_interp.KERNEL))
    assert edgeconv.TC_LAUNCHES == 0
    assert edgeconv.F32_TILED_LAUNCHES == 0
    assert edgeconv.F32_TILED_BWD_LAUNCHES == 0


# (mlp, C, H, O) of the classes the bf16 tensor-core kernel takes, and
# those the f32 register-tiled kernel takes (the same and the action
# generator's EdgeConv_0, which no path runs in bf16)
TC = [(True, 64, 128, 256), (False, 64, 128, 128), (True, 6, 64, 128),
      (True, 32, 16, 32)]
F32_TILED = TC + [(True, 3, 64, 128)]


@pytest.mark.parametrize("dtype,mlp,widths,tc,f32t", [
    (torch.bfloat16, True, (64, 128, 256), True, False),
    (torch.float32, True, (64, 128, 256), False, True),
    (torch.bfloat16, True, (64, 128, 128), False, False),
    (torch.bfloat16, False, (64, 128, 128), True, False),
    (torch.bfloat16, False, (64, 128, 256), False, False),
    (torch.bfloat16, True, (6, 64, 128), True, False),
    (torch.bfloat16, True, (32, 16, 32), True, False),
    (torch.bfloat16, True, (32, 128, 256), False, False),
    (torch.float16, True, (64, 128, 256), False, False),
    (torch.float32, False, (64, 128, 128), False, True),
    (torch.float32, True, (6, 64, 128), False, True),
    (torch.float32, True, (3, 64, 128), False, True),
    (torch.bfloat16, True, (3, 64, 128), False, False),
    (torch.float32, False, (3, 64, 128), False, False),
    (torch.float32, True, (32, 16, 32), False, True),
    (torch.float32, False, (64, 128, 256), False, False),
    (torch.float32, True, (32, 128, 256), False, False),
    (torch.float32, True, (10, 24, 40), False, False),
    (torch.float32, True, (12, 8, 8), False, False),
    (torch.bfloat16, False, (32, 16, 32), False, False),
    (torch.bfloat16, True, (6, 64, 256), False, False),
])
def test_edgeconv_dispatch_takes_tensor_cores_only_at_its_class(dtype, mlp,
                                                                 widths, tc,
                                                                 f32t):
    """Only the bf16 forward at a class of ``TC`` routes to the tensor-core
    kernel, and only the f32 forward at a class of ``F32_TILED`` to the f32
    register-tiled kernel; another dtype, width or SharedMLP setting takes
    the general kernel."""
    assert edgeconv.takes_tensor_cores(dtype, mlp, *widths) is tc
    assert edgeconv.takes_f32_tiled(dtype, mlp, *widths) is f32t
    assert edgeconv.F32_TILED_CLASSES == frozenset(F32_TILED)
    assert edgeconv.TC_CLASSES == frozenset(TC)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    src = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def gen():
    # a local generator: on the card this file runs with --noconftest, since
    # the repository's conftest configures JAX, which the port does not need
    return np.random.default_rng(0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _grid(n):
    """n^3 integer grid points, each twice (exact f32 distances, exact ties)."""
    g = np.stack(np.meshgrid(*[np.arange(float(n))] * 3, indexing="ij"), -1)
    return np.concatenate([g.reshape(-1, 3)] * 2).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("d,k,nq,nc,kind", [
    pytest.param(3, 20, 300, 1000, "random", id="3-20-1000"),
    pytest.param(32, 12, 300, 333, "random", id="32-12-333"),
    pytest.param(64, 4, 300, 2048, "random", id="64-4-2048"),
    pytest.param(6, 1, 300, 7, "random", id="6-1-7"),
    pytest.param(3, 32, 300, 256, "random", id="3-32-256"),
    pytest.param(3, 64, 300, 1000, "random", id="3-64-1000"),
    pytest.param(3, 50, 300, 777, "random", id="3-50-777"),
    # exact ties: the duplicated 4^3 grid of test_knn_ties_follow_index_order
    # (one tile), and a duplicated 6^3 grid whose twins lie in other tiles
    pytest.param(3, 12, 128, 128, "grid", id="ties-grid4-k12"),
    pytest.param(3, 64, 432, 432, "grid", id="ties-grid6-k64"),
    # Nq and Nc off the 32-query block and the 128-candidate tile
    pytest.param(3, 1, 1, 1, "random", id="nq1-nc1"),
    pytest.param(16, 32, 33, 129, "random", id="nq33-nc129"),
    pytest.param(64, 32, 129, 33, "random", id="nq129-nc33"),
    pytest.param(32, 20, 10239, 10239, "random", id="nq10239-nc10239"),
    # k = Nc
    pytest.param(3, 33, 40, 33, "random", id="k-eq-nc33"),
    pytest.param(8, 32, 70, 32, "random", id="k-eq-nc32"),
    # a row with fewer valid candidates than k
    pytest.param(3, 20, 300, 500, "short", id="short-row"),
])
def test_knn_kernel_matches_plain_on_card(card, gen, d, k, nq, nc, kind):
    """Distances to the f32 rounding of |q|^2 + |c|^2 - 2 q.c; an index may
    differ from the plain version's only where the two candidates' exact
    distances tie within twice that; exact inputs (grid points, 1e10-biased
    candidates) give the plain version's output bit for bit."""
    if kind == "grid":
        pts = _grid(6 if nq > 128 else 4)
        q = c = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
        bias = torch.zeros(2, nc)
    else:
        q = torch.from_numpy(gen.standard_normal((2, nq, d)).astype(np.float32))
        c = torch.from_numpy(gen.standard_normal((2, nc, d)).astype(np.float32))
        bias = torch.where(torch.rand(2, nc, generator=torch.Generator().manual_seed(0))
                           < 0.1, 1e10, 0.0)
    if kind == "short":   # row 0: 5 valid candidates, the rest 1e10-biased
        valid = np.sort(gen.choice(nc, 5, replace=False))
        bias[0] = 1e10
        bias[0, valid] = 0.0
    d2k, ik = knn.knn_kernel(q.to(card), c.to(card), bias.to(card), k)
    torch.cuda.synchronize()
    d2k, ik = d2k.cpu(), ik.cpu()
    d2p, ip = knn.knn_plain(q, c, bias, k)
    if kind == "grid":
        torch.testing.assert_close(d2k, d2p, rtol=0, atol=0)
        assert torch.equal(ik, ip)
        return
    # f32 rounding of |q|^2 + |c|^2 - 2 q.c
    tol = 1e-5 * float((q * q).sum(-1).max() + (c * c).sum(-1).max())
    torch.testing.assert_close(d2k, d2p, rtol=0, atol=tol)
    assert float((ik == ip).float().mean()) > 0.99
    bi, qi, _ = torch.nonzero(ik != ip, as_tuple=True)
    exact = lambda i: (((q[bi, qi].double() - c[bi, i].double()) ** 2).sum(-1)
                       + bias[bi, i].double())
    gaps = (exact(ik[ik != ip]) - exact(ip[ik != ip])).abs()
    assert gaps.numel() == 0 or float(gaps.max()) <= 2 * tol
    if kind == "short":   # the valid ones, then the invalid in index order
        assert torch.equal(ik[0], ip[0])
        invalid = np.setdiff1d(np.arange(nc), valid)[:k - 5]
        assert (ik[0, :, 5:].numpy() == invalid).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d,k,nq,nc,kind", [
    # the approximate serving shapes: the f32 dynamic forward's five graph
    # shapes (the bf16 static graph is the first) at 10,240 points, the
    # rollout's padded frame (112 rows at the 999 sentinel, bias 0, as the
    # rollout pads it)
    pytest.param(3, 20, 10240, 10240, "random", id="serving-3-20"),
    pytest.param(32, 20, 10240, 10240, "random", id="serving-32-20"),
    pytest.param(64, 12, 10240, 10240, "random", id="serving-64-12"),
    pytest.param(64, 4, 10240, 10240, "random", id="serving-64-4"),
    pytest.param(64, 8, 10240, 10240, "random", id="serving-64-8"),
    pytest.param(3, 20, 10112, 10112, "sentinel", id="rollout-3-20-pad112"),
    # Nq off the 32-query block, D off the float4 chunk, the 24,576 cap
    pytest.param(6, 12, 1000, 4096, "random", id="nq1000-d6-k12"),
    pytest.param(16, 3, 33, 24576, "random", id="nq33-nc24576-k3"),
    # exact ties: the duplicated 16^3 grid, bit for bit
    pytest.param(3, 20, 8192, 8192, "grid", id="grid16-k20"),
])
def test_knn_approx_kernel_matches_plain_on_card(card, gen, d, k, nq, nc, kind):
    """The approximate kernel against its plain version (the tolerance of
    ``knn.approx_agreement`` over the real rows); bit for bit on exact
    inputs and on the sentinel rows, which tie at d2 = 0."""
    if kind == "grid":
        q = c = torch.from_numpy(_grid(16)[None])
    else:
        c = torch.from_numpy(gen.standard_normal((2, nc, d)).astype(np.float32))
        if kind == "sentinel":
            c[:, nc - 112:] = PAD_SENTINEL
        q = c[:, :nq].contiguous()
    bias = torch.zeros(c.shape[:2])
    before = knn.APPROX.launches, knn.KERNEL.launches
    got = knn.knn_approx_kernel(q.to(card), c.to(card), bias.to(card), k)
    torch.cuda.synchronize()
    assert (knn.APPROX.launches, knn.KERNEL.launches) == (before[0] + 1,
                                                          before[1])
    want = knn.knn_approx_plain(q, c, bias, k)
    if kind == "grid":
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        return
    if kind == "sentinel":
        real = nc - 112
        assert torch.equal(got[0][:, real:].cpu(), want[0][:, real:])
        assert torch.equal(got[1][:, real:].cpu(), want[1][:, real:])
        assert int(got[1][:, :real].max()) < real
        got = got[0][:, :real], got[1][:, :real]
        want = want[0][:, :real], want[1][:, :real]
        q, c, bias = q[:, :real], c[:, :real], bias[:, :real]
    a = knn.approx_agreement(got, want, (q, c, bias))
    assert a["d2_excess"] <= 0 and a["d2_unexplained"] == 0, a
    assert a["rows_unexplained"] == 0 and a["rows"] <= 0.02 * a["queries"], a


def _edgeconv_cases():
    """(c, h, o, k, agg, b, n, kind): the general kernel's five classes,
    then the tensor-core and f32 register-tiled class (64, 128, 256) at K
    1, 4, 12 and 20 with every aggregate, ragged N (77 and 9,992, off the
    tiles), one whole 10,240-point frame, the fused train step's 12 x
    1,152 rows, exact inputs with tied planes, and inputs that start 2 or
    4 bytes into their storage (not 16-byte aligned)."""
    cases = [pytest.param(*c, 2, 77, "random", id="-".join(map(str, c)))
             for c in [(6, 64, 128, 20, "max"), (32, 16, 32, 10, "max"),
                       (64, 128, None, 8, "sum"), (10, 24, 40, 5, "mean"),
                       (12, 8, 8, 3, "min")]]
    cases += [pytest.param(64, 128, 256, k, agg, 2, n, "random",
                           id=f"tc-k{k}-{agg}-n{n}")
              for k in (1, 4, 12, 20) for agg in ("max", "min", "sum", "mean")
              for n in (77, 9992)]
    cases.append(pytest.param(64, 128, 256, 12, "max", 1, 10240, "random",
                              id="tc-k12-max-1x10240"))
    # the fused train step's rows: 12 frames of 1,152 points
    cases.append(pytest.param(64, 128, 256, 12, "max", 12, 1152, "random",
                              id="tc-k12-max-12x1152"))
    cases += [pytest.param(64, 128, 256, 12, agg, 2, 9992, "exact",
                           id=f"tc-exact-k12-{agg}")
              for agg in ("max", "min", "sum", "mean")]
    cases.append(pytest.param(64, 128, 256, 4, "max", 2, 77, "offset",
                              id="tc-k4-max-n77-offset"))
    # the other classes of the f32 register-tiled kernel, each with the
    # aggregate the serving forward gives it (the action generator's
    # EdgeConv_0, C = 3, also at its own frames: 1 and 12 of 128 points)
    for c, h, o, agg in [(64, 128, None, "sum"), (6, 64, 128, "max"),
                         (32, 16, 32, "max"), (3, 64, 128, "max")]:
        name = f"f32t-{c}-{h}-{o}"
        cases += [pytest.param(c, h, o, k, agg, 2, n, "random",
                               id=f"{name}-k{k}-n{n}")
                  for k in (1, 4, 12, 20) for n in (77, 9992)]
        cases += [pytest.param(c, h, o, 20, agg, 1, 10240, "random",
                               id=f"{name}-k20-1x10240"),
                  pytest.param(c, h, o, 12, agg, 12, 1152, "random",
                               id=f"{name}-k12-12x1152"),
                  pytest.param(c, h, o, 4, agg, 2, 77, "offset",
                               id=f"{name}-k4-n77-offset")]
        cases += [pytest.param(c, h, o, 12, a, 2, 9992, "exact",
                               id=f"{name}-exact-k12-{a}")
                  for a in ("max", "min", "sum", "mean")]
    cases += [pytest.param(3, 64, 128, 20, agg, b, 128, "random",
                           id=f"f32t-3-64-128-k20-{agg}-{b}x128")
              for agg in ("max", "min", "sum", "mean") for b in (1, 12)]
    # the tensor-core kernel's narrow classes (bf16; in f32 the same rows
    # run the register-tiled kernel): every aggregate at ragged N with each
    # K the serving forward gives the class, a repeat bit for bit
    for c, h, o, ks in [(6, 64, 128, (20,)), (32, 16, 32, (20, 10)),
                        (64, 128, None, (8,))]:
        name = f"tc-{c}-{h}-{o}"
        cases += [pytest.param(c, h, o, k, agg, 2, n, "random",
                               id=f"{name}-k{k}-{agg}-n{n}")
                  for k in ks for agg in ("max", "min", "sum", "mean")
                  for n in (77, 9992)]
        cases.append(pytest.param(c, h, o, ks[0], "max", 2, 77, "repeat",
                                  id=f"{name}-k{ks[0]}-max-n77-repeat"))
    return cases


def _exact_edgeconv_inputs(gen, b, k, n, c, h, o):
    """ctr = 0 and sparse {0, 1} neighbours and weights: leaky ReLU is the
    identity and every product and sum is an integer below 2^24, exact in
    f32 in any order, so the kernels and the plain version round the same
    values. Planes 1 and 3 repeat planes 0 and 2 (max and min tie)."""
    bits = lambda p, *s: torch.from_numpy(
        (gen.random(s) < p).astype(np.float32))
    nbr = bits(0.5, b, k, n, c)
    nbr[:, 1], nbr[:, 3] = nbr[:, 0], nbr[:, 2]
    return [nbr, torch.zeros(b, n, c), bits(0.03, c, h), bits(0.03, c, h),
            bits(0.03, h, h) if o else None, bits(0.03, h, o) if o else None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,o,k,agg,b,n,kind", _edgeconv_cases())
def test_edgeconv_kernel_matches_plain_on_card(card, gen, dtype, c, h, o, k,
                                               agg, b, n, kind):
    """The bf16 forward at a class of TC launches the tensor-core kernel
    (one count of TC_LAUNCHES), the f32 forward at a class of F32_TILED
    the f32 register-tiled kernel (one count of F32_TILED_LAUNCHES), every
    other forward the general kernel (none of either); exact inputs give
    the plain version bit for bit, and a second call the first's bits."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    if kind == "exact":
        args = _exact_edgeconv_inputs(gen, b, k, n, c, h, o)
        args[:2] = [a.to(dtype) for a in args[:2]]
    else:
        args = [t(b, k, n, c).to(dtype), t(b, n, c).to(dtype), t(c, h),
                t(c, h), t(h, h) if o else None, t(h, o) if o else None]
    on_card = [a.to(card) if a is not None else None for a in args]
    if kind == "offset":    # each a view one element into a fresh buffer
        on_card = [torch.empty(a.numel() + 1, dtype=dtype, device=card)[1:]
                   .view(a.shape).copy_(a) if a is not None else None
                   for a in on_card]
    before, before_f32t = edgeconv.TC_LAUNCHES, edgeconv.F32_TILED_LAUNCHES
    out_k = edgeconv.edgeconv_fused(*on_card, aggregate=agg,
                                    compute_dtype=dtype)
    cls = (o is not None, c, h, o or h)
    tc = dtype == torch.bfloat16 and cls in TC
    f32t = dtype == torch.float32 and cls in F32_TILED
    assert edgeconv.TC_LAUNCHES == before + int(tc)
    assert edgeconv.F32_TILED_LAUNCHES == before_f32t + int(f32t)
    if kind == "repeat":
        again = edgeconv.edgeconv_fused(*on_card, aggregate=agg,
                                        compute_dtype=dtype)
        assert torch.equal(again, out_k)
    out_p = edgeconv.edgeconv_plain(*args, aggregate=agg, compute_dtype=dtype)
    if kind == "exact":
        assert torch.equal(out_k.cpu(), out_p)
        return
    scale = float(out_p.float().abs().max())
    # f32: summation order; bf16: a one-ulp rounding flip carried forward
    tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
    torch.testing.assert_close(out_k.cpu().float(), out_p.float(), rtol=0,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,o,k,agg,ties", [(6, 64, 128, 20, "max", False),
                                              (32, 16, 32, 10, "max", True),
                                              (64, 128, None, 8, "sum", False),
                                              (10, 24, 40, 5, "mean", False),
                                              (12, 8, 8, 3, "min", True),
                                              (300, 8, 8, 3, "max", False)])
def test_edgeconv_backward_kernel_matches_plain_on_card(card, gen, dtype, c, h,
                                                        o, k, agg, ties):
    """Every gradient to 1e-3 (f32) or 2e-2 (bf16) of its norm: both sides
    round the same values but sum in another order, so a plane whose
    output lies within rounding of the max can take another (point,
    column)'s cotangent. Duplicated planes (ties) split it exactly. C = 300
    takes two column chunks of the input gradients."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    nbr = t(2, k, 77, c)
    if ties:
        nbr[:, 1] = nbr[:, 0]
    args = [nbr.to(dtype), t(2, 77, c).to(dtype), t(c, h) / c ** 0.5,
            t(c, h) / c ** 0.5, t(h, h) / h ** 0.5 if o else None,
            t(h, o) / h ** 0.5 if o else None, t(2, 77, o or h).to(dtype)]
    before = edgeconv.BWD.launches
    got = edgeconv.edgeconv_backward(
        *[a.to(card) if a is not None else None for a in args], agg, dtype)
    assert edgeconv.BWD.launches == before + 1
    want = edgeconv.edgeconv_backward_plain(*args, agg, dtype)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        if w is None:
            assert a is None
            continue
        a, w = a.cpu().float(), w.float()
        assert float((a - w).norm()) <= tol * float(w.norm())
    if ties:
        assert torch.equal(got[0][:, 0], got[0][:, 1])


def _tiled_bwd_args(gen, k, n, ties, dtype=torch.float32,
                    cls=(True, 64, 128, 256)):
    """Inputs of the backward at the class cls = (mlp, C, H, O) (by default
    (64, 128, 256)), B = 2."""
    mlp, c, h, o = cls
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    nbr = t(2, k, n, c)
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    return [nbr.to(dtype), t(2, n, c).to(dtype), t(c, h) / c ** 0.5,
            t(c, h) / c ** 0.5, t(h, h) / h ** 0.5 if mlp else None,
            t(h, o) / h ** 0.5 if mlp else None, t(2, n, o).to(dtype)]


# the classes the redesign added (EdgeConv_0, the IDGCN, the mask head's
# sum, the action generator's EdgeConv_0) with the K of each at the fused
# train step
NEW_BWD_CLASSES = [((True, 6, 64, 128), 20), ((True, 32, 16, 32), 20),
                   ((True, 32, 16, 32), 10), ((False, 64, 128, 128), 8),
                   ((True, 3, 64, 128), 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,agg,ties", [(12, "max", True), (4, "max", False),
                                        (8, "sum", False), (12, "min", False),
                                        (6, "mean", False)])
def test_edgeconv_tiled_backward_matches_plain_on_card(card, gen, k, agg, ties):
    """The f32 backward on GEMM tiles at (64, 128, 256), N = 77 (off the
    128-row tile): every gradient to 1e-3 of its norm, as the general
    kernel's test; duplicated planes split their cotangent exactly; each
    call counts once in BWD and once in F32_TILED_BWD_LAUNCHES."""
    args = _tiled_bwd_args(gen, k, 77, ties)
    before = edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES
    got = edgeconv.edgeconv_backward(*[a.to(card) for a in args], agg)
    assert (edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = edgeconv.edgeconv_backward_plain(*args, agg)
    for a, w in zip(got, want):
        a = a.cpu()
        assert a.dtype == w.dtype and a.shape == w.shape
        assert float((a - w).norm()) <= 1e-3 * float(w.norm())
    if ties:
        assert torch.equal(got[0][:, 1], got[0][:, 0])
        assert torch.equal(got[0][:, 5], got[0][:, 3])


@pytest.mark.gpu
@pytest.mark.parametrize("cls,k", NEW_BWD_CLASSES)
@pytest.mark.parametrize("agg,ties", [("max", False), ("max", True),
                                      ("min", False), ("sum", False),
                                      ("mean", False)])
def test_edgeconv_redesigned_backward_matches_plain_on_card(card, gen, cls, k,
                                                            agg, ties):
    """The f32 backward at EdgeConv_0's, the IDGCN's and the mask head's sum
    class (on GEMM tiles, or one plane-row a thread at the IDGCN), N = 77
    (off every tile): every gradient to 1e-3 of its norm; duplicated planes
    split their cotangent exactly; each call counts once in BWD and once in
    F32_TILED_BWD_LAUNCHES; a second call gives the first's bits."""
    args = _tiled_bwd_args(gen, k, 77, ties, cls=cls)
    on_card = [a.to(card) if a is not None else None for a in args]
    before = edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES
    got = edgeconv.edgeconv_backward(*on_card, agg)
    assert (edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = edgeconv.edgeconv_backward_plain(*args, agg)
    for a, w in zip(got, want):
        if w is None:
            assert a is None
            continue
        a = a.cpu()
        assert a.dtype == w.dtype and a.shape == w.shape
        assert float((a - w).norm()) <= 1e-3 * float(w.norm())
    if ties:
        assert torch.equal(got[0][:, 1], got[0][:, 0])
        assert torch.equal(got[0][:, 5], got[0][:, 3])
    for a, b in zip(got, edgeconv.edgeconv_backward(*on_card, agg)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cls,k", NEW_BWD_CLASSES)
def test_edgeconv_bf16_backward_at_new_class_takes_general_kernel(card, gen,
                                                                  cls, k):
    """The bf16 backward at each added class stays on the general kernel."""
    args = _tiled_bwd_args(gen, k, 77, False, torch.bfloat16, cls)
    before = edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES
    got = edgeconv.edgeconv_backward(
        *[a.to(card) if a is not None else None for a in args], "max",
        torch.bfloat16)
    assert (edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES) == (
        before[0] + 1, before[1])
    want = edgeconv.edgeconv_backward_plain(*args, "max", torch.bfloat16)
    for a, w in zip(got, want):
        if w is not None:
            a, w = a.cpu().float(), w.float()
            assert float((a - w).norm()) <= 2e-2 * float(w.norm())


@pytest.mark.gpu
def test_edgeconv_tiled_backward_repeats_bit_for_bit_on_card(card, gen):
    """Sums over rows have a fixed order (no float atomics): two calls give
    the same gradients, bit for bit."""
    args = [a.to(card) for a in _tiled_bwd_args(gen, 12, 77, False)]
    first = edgeconv.edgeconv_backward(*args, "max")
    for a, b in zip(first, edgeconv.edgeconv_backward(*args, "max")):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_edgeconv_bf16_backward_at_tiled_class_takes_general_kernel(card, gen):
    """The bf16 backward at (64, 128, 256) stays on the general kernel."""
    args = _tiled_bwd_args(gen, 4, 77, False, torch.bfloat16)
    before = edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES
    got = edgeconv.edgeconv_backward(*[a.to(card) for a in args], "max",
                                     torch.bfloat16)
    assert (edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES) == (
        before[0] + 1, before[1])
    want = edgeconv.edgeconv_backward_plain(*args, "max", torch.bfloat16)
    for a, w in zip(got, want):
        a, w = a.cpu().float(), w.float()
        assert float((a - w).norm()) <= 2e-2 * float(w.norm())


@pytest.mark.gpu
def test_nn1_kernel_matches_plain_on_card(card, gen):
    q = torch.from_numpy(gen.standard_normal((2, 5000, 3)).astype(np.float32))
    c = torch.from_numpy(gen.standard_normal((2, 3001, 3)).astype(np.float32))
    bias = torch.zeros(2, 3001)
    bias[:, -100:] = 1e10
    d2k, ik = nn1.nn1_kernel(q.to(card), c.to(card), bias.to(card))
    d2p, ip = nn1.nn1_plain(q, c, bias)
    torch.testing.assert_close(d2k.cpu(), d2p, rtol=0, atol=1e-4)
    assert int(ik.max()) < 2901
    assert float((ik.cpu() == ip).float().mean()) > 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", [(2, 300, 50), (3, 2000, 256)])
def test_fps_kernel_matches_plain_on_card(card, gen, b, n, m):
    pos = torch.from_numpy(gen.standard_normal((b, n, 3)).astype(np.float32))
    pen = torch.zeros(b, n)
    pen[0, ::7] = -1e10
    start = torch.arange(b) * 5
    ik = fps.fps_kernel(pos.to(card), m, pen.to(card), start.to(card))
    assert torch.equal(ik.cpu(), fps.fps_plain(pos, m, pen, start))


@pytest.mark.gpu
def test_ball_query_kernel_matches_plain_on_card(card, gen):
    q = torch.from_numpy(gen.standard_normal((2, 100, 3)).astype(np.float32))
    c = torch.from_numpy(gen.standard_normal((2, 700, 3)).astype(np.float32))
    bias = torch.zeros(2, 700)
    bias[:, ::5] = 2.0
    ik = ball_query.ball_query_kernel(q.to(card), c.to(card), 0.4, 32,
                                      bias.to(card))
    assert torch.equal(ik.cpu(), ball_query.ball_query_plain(q, c, 0.4, 32, bias))


# The action GAN step's shapes (B = 4 clips of 3 frames, 2,048 high-res
# points, 128 inputs; chip_smoke.py's action-train kernel rows)
@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_edgeconv_tiled_backward_at_action_class_on_card(card, gen, ties):
    """EdgeConv_0 of the action generator under the fused switch, (mlp, C,
    H, O) = (True, 3, 64, 128), 12 frames of 128 points, k = 20: a class
    of F32_TILED_BWD_CLASSES, so the redesigned f32 backward (one BWD
    launch, one redesigned); every gradient to 1e-3 of its norm, as the
    general kernel's test; duplicated planes split their cotangent
    exactly; a second call gives the first's bits."""
    assert edgeconv.takes_f32_tiled_bwd(torch.float32, True, 3, 64, 128)
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    nbr = t(12, 20, 128, 3) * 0.2
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    args = [nbr, t(12, 128, 3) * 0.2, t(3, 64) / 3 ** 0.5, t(3, 64) / 3 ** 0.5,
            t(64, 64) / 8.0, t(64, 128) / 8.0, t(12, 128, 128)]
    before = edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES
    got = edgeconv.edgeconv_backward(*[a.to(card) for a in args], "max")
    assert (edgeconv.BWD.launches, edgeconv.F32_TILED_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    again = edgeconv.edgeconv_backward(*[a.to(card) for a in args], "max")
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = edgeconv.edgeconv_backward_plain(*args, "max")
    for a, w in zip(got, want):
        a = a.cpu()
        assert a.dtype == w.dtype and a.shape == w.shape
        assert float((a - w).norm()) <= 1e-3 * float(w.norm())
    if ties:
        assert torch.equal(got[0][:, 1], got[0][:, 0])
        assert torch.equal(got[0][:, 5], got[0][:, 3])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", [(12, 2048, 128), (4, 2048, 512),
                                   (12, 2048, 512)])
def test_fps_kernel_at_action_train_shapes_on_card(card, gen, b, n, m):
    """Device sampling's 12 frames 2,048 -> 128, the spatial critic's 4
    clips 2,048 -> 512 and the temporal critic's 12 frames: index for
    index, from random starts."""
    pos = torch.from_numpy((gen.standard_normal((b, n, 3)) * 0.2)
                           .astype(np.float32))
    pen = torch.zeros(b, n)
    start = torch.from_numpy(gen.integers(0, n, b))
    ik = fps.fps_kernel(pos.to(card), m, pen.to(card), start.to(card))
    assert torch.equal(ik.cpu(), fps.fps_plain(pos, m, pen, start))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc,radius", [(512, 2048, 0.3), (256, 512, 0.6),
                                          (128, 256, 1.0)])
def test_ball_query_kernel_at_action_spatial_stages_on_card(card, gen, nq, nc,
                                                            radius):
    """The action spatial critic's three stages (4 clips, nsample 32), the
    queries a subset of the candidates: bit for bit."""
    c = torch.from_numpy((gen.standard_normal((4, nc, 3)) * 0.2)
                         .astype(np.float32))
    q = c[:, :nq].contiguous()
    bias = torch.zeros(4, nc)
    ik = ball_query.ball_query_kernel(q.to(card), c.to(card), radius, 32,
                                      bias.to(card))
    assert torch.equal(ik.cpu(), ball_query.ball_query_plain(q, c, radius, 32,
                                                             bias))


@pytest.mark.gpu
def test_nn1_kernel_at_action_chamfer_on_card(card, gen):
    """The action step's Chamfer, 4 clips of 2,048 predicted points against
    2,048 ground-truth points (both directions run this shape)."""
    q = torch.from_numpy((gen.standard_normal((4, 2048, 3)) * 0.2)
                         .astype(np.float32))
    c = torch.from_numpy((gen.standard_normal((4, 2048, 3)) * 0.2)
                         .astype(np.float32))
    bias = torch.zeros(4, 2048)
    d2k, ik = nn1.nn1_kernel(q.to(card), c.to(card), bias.to(card))
    _assert_nn1_like_plain(q, c, bias, d2k.cpu(), ik.cpu(), False)


def _approx_case(gen, case):
    """(query, cand, bias, k, exact) for the approximate kernel's forced-plan
    tests: ``exact`` where the contract's arithmetic is exact (integer grid
    points; sentinel rows tie at d2 = 0), so that every plan must equal the
    plain version bit for bit."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    if case == "grid":          # one row, self graph, duplicated 16^3 grid
        g = torch.from_numpy(_grid(16)[None])
        return g, g, torch.zeros(1, g.shape[1]), 20, True
    if case == "sentinel":      # two rows of a padded frame, self graph
        c = t(2, 4224, 3) * 0.3
        c[:, -112:] = PAD_SENTINEL
        return c, c, torch.zeros(2, 4224), 20, False
    if case == "cross":         # queries off the 16-row tile, a masked tail
        bias = torch.zeros(2, 4096)
        bias[:, -300:] = 1e10
        return t(2, 1001, 32), t(2, 4096, 32), bias, 12, False
    if case == "wide":          # D = 64, k = 4 (kp = 2), Nq one short of 80
        c = t(1, 4096, 64)
        return c[:, :79].contiguous(), c, torch.zeros(1, 4096), 4, False
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("wq", sorted(knn.APPROX_BLOCKS_PER_SM))
@pytest.mark.parametrize("case", ["grid", "sentinel", "cross", "wide"])
def test_knn_approx_kernel_plans_match_plain_on_card(card, gen, case, wq):
    """The approximate kernel under each query tile (WQ = 2, 5) against
    its plain version: bit for bit on exact inputs and on sentinel rows,
    else within ``knn.approx_agreement``; two launches bit for bit."""
    q, c, bias, k, exact = _approx_case(gen, case)
    plan = knn.ApproxPlan(wq)
    args = [x.to(card) for x in (q, c, bias)]
    if q is c:
        args[1] = args[0]            # a self graph: one tensor, as callers pass
    before = knn.APPROX.launches
    got = [x.cpu() for x in knn._launch_approx(*args, k, plan)]
    again = [x.cpu() for x in knn._launch_approx(*args, k, plan)]
    assert knn.APPROX.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = knn.knn_approx_plain(q, c, bias, k)
    if exact:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    real = q.shape[1] - (112 if case == "sentinel" else 0)
    if case == "sentinel":
        assert torch.equal(got[0][:, real:], want[0][:, real:])
        assert torch.equal(got[1][:, real:], want[1][:, real:])
    a = knn.approx_agreement((got[0][:, :real], got[1][:, :real]),
                             (want[0][:, :real], want[1][:, :real]),
                             (q[:, :real], c[:, :real] if case == "sentinel" else c,
                              bias[:, :real] if case == "sentinel" else bias))
    assert a["d2_excess"] <= 0 and a["d2_unexplained"] == 0, a
    assert a["rows_unexplained"] == 0 and a["rows"] <= 0.02 * a["queries"], a


def _ball_case(gen, case):
    """(query, cand, radius, nsample, bias) for the ball query's tile tests."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    if case == "mixed":         # empty balls, masked candidates, full balls
        q, c = t(3, 300, 3) * 0.5, t(3, 2900, 3) * 0.5
        q[0, :7] = 50.0
        bias = torch.zeros(3, 2900)
        bias[:, ::4] = 2.0
        return q, c, 0.2, 32, bias
    if case == "ns_over_nc":    # nsample past Nc: every slot past the hits pads
        return t(2, 70, 3) * 0.3, t(2, 40, 3) * 0.3, 0.5, 64, torch.zeros(2, 40)
    if case.startswith("last_tile_"):  # the only hits end Nc's last tile
        nc = int(case[10:])
        c = t(2, nc, 3) + 20.0
        c[:, -37:] = 0.02 * t(2, 37, 3)
        q = 0.02 * t(2, 90, 3)
        return q, c, 0.3, 16, torch.zeros(2, nc)
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "mixed", "ns_over_nc", "last_tile_1024", "last_tile_1025",
    "last_tile_2049", "last_tile_2500", "last_tile_3075"])
def test_ball_query_kernel_tiles_match_plain_on_card(card, gen, case):
    """Candidate tiles of 1,024 with a last tile of 1,024, 1, 452 or 3
    candidates, index for index against the plain version; two launches
    bit for bit."""
    q, c, r, ns, bias = _ball_case(gen, case)
    args = [x.to(card) for x in (q, c)]
    before = ball_query.KERNEL.launches
    got = ball_query.ball_query_kernel(*args, r, ns, bias.to(card)).cpu()
    again = ball_query.ball_query_kernel(*args, r, ns, bias.to(card)).cpu()
    assert ball_query.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, ball_query.ball_query_plain(q, c, r, ns, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(interp.KINDS))
def test_interp_kernel_matches_plain_on_card(card, gen, kind):
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    q, c, v = t(2, 300, 3) * 0.2, t(2, 500, 3) * 0.2, t(2, 500, 3)
    q[:, :4] = 999.0
    bias = torch.zeros(2, 500)
    bias[:, ::3] = 1e10
    ok, dk = interp.interp_kernel(q.to(card), c.to(card), v.to(card), 0.16,
                                  bias.to(card), kind)
    op, dp = interp.interp_plain(q, c, v, 0.16, bias, kind)
    # f32 sums over the candidates in another order
    torch.testing.assert_close(ok.cpu(), op, rtol=0, atol=1e-5)
    torch.testing.assert_close(dk.cpu(), dp, rtol=1e-5, atol=1e-6)


def _nn1_plans(b, nq, m):
    """The wrapper's plan on an H100's 132 SMs and three others, forced
    through the wrapper's launch: splits of 32 candidates in blocks of 32
    threads, the whole row in one split in blocks of 256, and three splits
    in blocks of 64."""
    chunk = nn1.CHUNK
    one = chunk * -(-m // chunk)
    third = chunk * -(-m // (3 * chunk))
    return [nn1.nn1_plan(b, nq, m, 132),
            nn1.Nn1Plan(32, -(-m // chunk), chunk),
            nn1.Nn1Plan(256, 1, one),
            nn1.Nn1Plan(64, -(-m // third), third)]


def _nn1_case(gen, case):
    """(query, cand, bias, exact): ``exact`` where every distance is exact
    in f32 (lattice points at multiples of 0.25), so that the kernel must
    equal the plain version bit for bit, ties included."""
    t = lambda *s: torch.from_numpy((gen.standard_normal(s) * 0.3)
                                    .astype(np.float32))
    if case == "ties":
        g = torch.from_numpy(0.25 * _grid(6))[None]        # each point twice
        return g.flip(1).clone(), g.clone(), torch.zeros(1, g.shape[1]), True
    if case == "masked":
        bias = torch.zeros(2, 1500)
        bias[:, -300:] = 1e10
        bias[1] = 1e10                                     # a row all masked
        return t(2, 700, 3), t(2, 1500, 3), bias, False
    if case == "sentinel":
        q = t(2, 600, 3)
        q[:, -100:] = PAD_SENTINEL
        return q, t(2, 900, 3), torch.zeros(2, 900), False
    if case == "n1":
        return t(3, 1, 3), t(3, 777, 3), torch.zeros(3, 777), False
    if case == "m1":
        return t(2, 300, 3), t(2, 1, 3), torch.zeros(2, 1), False
    raise ValueError(case)


def _assert_nn1_like_plain(q, c, bias, d2k, ik, exact):
    """As chip_smoke.check_nn1: live rows' distances within tol and index
    differences only at exact-distance gaps of at most 2 tol; sentinel rows
    to 1e-5 of their distance; no index into a masked candidate of a row
    that has a valid one."""
    d2p, ip = nn1.nn1_plain(q, c, bias)
    if exact:
        assert torch.equal(d2k, d2p) and torch.equal(ik, ip)
        return
    live = q.abs().amax(-1) < PAD_SENTINEL
    tol = 1e-5 * 2 * max(float((q[live] ** 2).sum(-1).max()),
                         float((c * c).sum(-1).max()))
    assert float((d2k - d2p)[live].abs().max()) <= tol
    if (~live).any():
        rel = ((d2k - d2p)[~live].abs() / d2p[~live]).max()
        assert float(rel) <= 1e-5
    rows = torch.arange(q.shape[0])[:, None]
    exact_d = lambda i: ((q.double() - c.double()[rows, i]) ** 2).sum(-1)
    gap = (exact_d(ik) - exact_d(ip)).abs()[live & (ik != ip)]
    assert gap.numel() == 0 or float(gap.max()) <= 2 * tol
    has_valid = (bias == 0).any(-1, keepdim=True)
    assert bool(((bias[rows, ik] == 0) | ~has_valid).all())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", range(4))
@pytest.mark.parametrize("case", ["ties", "masked", "sentinel", "n1", "m1"])
def test_nn1_kernel_plans_match_plain_on_card(card, gen, case, variant):
    q, c, bias, exact = _nn1_case(gen, case)
    plan = _nn1_plans(q.shape[0], q.shape[1], c.shape[1])[variant]
    assert plan.admits(q.shape[1], c.shape[1])
    before = nn1.KERNEL.launches
    d2k, ik = nn1._launch(q.to(card), c.to(card), bias.to(card), plan)
    assert nn1.KERNEL.launches == before + 1
    _assert_nn1_like_plain(q, c, bias, d2k.cpu(), ik.cpu(), exact)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", range(4))
def test_nn1_kernel_nan_query_matches_plain_on_card(card, gen, variant):
    """A query with a NaN coordinate (a diverged generator's output) gets
    d2 NaN and index 0, as from the plain version, under every plan; every
    index stays in [0, M) and the other rows are unchanged."""
    clean, c, bias, _ = _nn1_case(gen, "masked")
    q = clean.clone()
    nan = torch.zeros(q.shape[:2], dtype=torch.bool)
    nan[0, 5], nan[1, 600:603] = True, True
    q[0, 5, 2] = float("nan")
    q[1, 600:603] = float("nan")
    plan = _nn1_plans(q.shape[0], q.shape[1], c.shape[1])[variant]
    d2k, ik = (t.cpu() for t in nn1._launch(q.to(card), c.to(card),
                                            bias.to(card), plan))
    d2p, ip = nn1.nn1_plain(q, c, bias)
    assert bool(torch.isnan(d2k[nan]).all()) and bool(torch.isnan(d2p[nan]).all())
    assert torch.equal(ik[nan], ip[nan]) and bool((ik[nan] == 0).all())
    assert int(ik.min()) >= 0 and int(ik.max()) < c.shape[1]
    d2c, ic = (t.cpu() for t in nn1._launch(clean.to(card), c.to(card),
                                            bias.to(card), plan))
    _assert_nn1_like_plain(clean, c, bias, d2c, ic, False)
    assert torch.equal(d2k[~nan], d2c[~nan]) and torch.equal(ik[~nan], ic[~nan])


@pytest.mark.gpu
def test_nn1_kernel_repeats_bit_for_bit_and_refuses_bad_plans_on_card(card, gen):
    q, c, bias, _ = _nn1_case(gen, "masked")
    args = (q.to(card), c.to(card), bias.to(card))
    first, second = nn1.nn1_kernel(*args), nn1.nn1_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    with pytest.raises(ValueError, match="does not cover"):
        nn1._launch(*args, nn1.Nn1Plan(128, 1, 32))


def _interp_plans(b, nq, m, c):
    """The wrapper's plan and three others, forced through the wrapper's
    launch: splits of 32 candidates in blocks of 32 threads, the whole row
    in one split in blocks of 256, three splits in blocks of 64."""
    third = -(-m // 3)
    return [interp.interp_plan(b, nq, m, c),
            interp.InterpPlan(32, -(-m // 32), 32),
            interp.InterpPlan(256, 1, m),
            interp.InterpPlan(64, -(-m // third), third)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", range(4))
@pytest.mark.parametrize("spread", ["skip_heavy", "skip_free"])
@pytest.mark.parametrize("kind", sorted(interp.KINDS))
def test_interp_kernel_plans_match_plain_on_card(card, gen, kind, spread,
                                                 variant):
    """Every kind under each plan, on a cloud where most pairs lie beyond
    the cutoff (most candidates skipped by every lane) and on one where
    every valid pair lies within it (nothing skipped); masked candidates
    and sentinel queries in both. Tolerances as in
    test_interp_kernel_matches_plain_on_card."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    scale, cutoff = (1.0, 0.16) if spread == "skip_heavy" else (0.02, 0.5)
    q, c, v = t(2, 700, 3) * scale, t(2, 1100, 3) * scale, t(2, 1100, 5)
    q[:, -7:] = PAD_SENTINEL
    bias = torch.zeros(2, 1100)
    bias[:, ::9] = 1e10
    plan = _interp_plans(2, 700, 1100, 5)[variant]
    assert plan.admits(700, 1100, 5)
    ok, dk = interp._launch(q.to(card), c.to(card), v.to(card), cutoff,
                            bias.to(card), kind, plan)
    op, dp = interp.interp_plain(q, c, v, cutoff, bias, kind)
    torch.testing.assert_close(ok.cpu(), op, rtol=0, atol=1e-5)
    torch.testing.assert_close(dk.cpu(), dp, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_interp_kernel_repeats_bit_for_bit_on_card(card, gen):
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    args = (t(3, 2000, 3).to(card) * 0.3, t(3, 2500, 3).to(card) * 0.3,
            t(3, 2500, 3).to(card), 0.16, torch.zeros(3, 2500, device=card))
    first, second = interp.interp_kernel(*args), interp.interp_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _pooled_bn_case(gen):
    """A small batch-norm stack with exact max ties and gammas of both signs
    and zero, as a trained critic may hold them: every third gamma negated,
    channel 0's set to 0."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    tab = t(2, 64, 16, 6)
    tab[:, :, 1] = tab[:, :, 0]                 # exact max ties
    ws = [t(6, 32) / 6 ** 0.5, t(32, 64) / 32 ** 0.5]
    gs, bs = [1 + 0.1 * t(32), 1 + 0.1 * t(64)], [0.1 * t(32), 0.1 * t(64)]
    for gamma in gs:
        gamma[::3] *= -1
        gamma[0] = 0.0
    return tab, ws, gs, bs, t(2, 64, 64)


def _run_pooled_bn(dev, tab, ws, gs, bs, g, **kw):
    leaves = [x.to(dev).requires_grad_() for x in [tab, *ws, *gs, *bs]]
    p, mus, vs = pooled_mlp.pooled_mlp_bn_train(
        leaves[0], leaves[1:3], leaves[3:5], leaves[5:7], 0.01, **kw)
    (p * g.to(dev)).sum().backward()
    return [p, *mus, *vs] + [x.grad for x in leaves]


@pytest.mark.gpu
def test_pooled_mlp_kernels_match_plain_on_card(card, gen):
    case = _pooled_bn_case(gen)
    for a, b in zip(_run_pooled_bn(card, *case), _run_pooled_bn("cpu", *case)):
        # f32 sums in another order; BN backward cancels, hence the scale
        b = b.detach()
        torch.testing.assert_close(a.detach().cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.gpu
def test_pooled_mlp_stages_without_a_cross_rank_sum_are_one_call_on_card(
        card, gen):
    """The kernel's stages (each layer's moment sums through ``reduce``)
    with the identity at world 1 equal the one-call kernel bit for bit,
    each counting one forward and one backward launch; with two ranks
    holding the same rows (t + t, world 2) they equal it to f32 rounding."""
    case = _pooled_bn_case(gen)
    one = _run_pooled_bn(card, *case)
    before = (pooled_mlp.FWD.launches, pooled_mlp.BWD.launches)
    staged = _run_pooled_bn(card, *case, reduce=lambda t: t, world=1)
    assert (pooled_mlp.FWD.launches,
            pooled_mlp.BWD.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(one, staged):
        assert torch.equal(a, b)
    for a, b in zip(one, _run_pooled_bn(card, *case, reduce=lambda t: t + t,
                                        world=2)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_pooled_mlp_kernels_repeat_bit_for_bit_on_card(card, gen):
    """Sums over rows have a fixed order (no float atomics): two calls give
    the same pooled output, moments and gradients, bit for bit."""
    case = _pooled_bn_case(gen)
    first = _run_pooled_bn(card, *case)
    for a, b in zip(first, _run_pooled_bn(card, *case)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,cutoff,c", [("bicubic", 0.16, 3),
                                           ("spline1", 0.05, 1),
                                           ("linear", 0.6, 8),
                                           ("exponential", 0.01, 2)])
def test_binned_interp_kernel_matches_plain_on_card(card, gen, kind, cutoff, c):
    """Masked candidates, sentinel queries far outside the grid, cells that
    hold many points (0.6) and a cutoff below the spacing (0.01)."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    q, cand, v = t(2, 300, 3) * 0.2, t(2, 500, 3) * 0.2, t(2, 500, c)
    q[:, :4] = 999.0
    bias = torch.zeros(2, 500)
    bias[:, ::3] = 1e10
    before = binned_interp.KERNEL.launches
    ok, dk = binned_interp.binned_interp(q.to(card), cand.to(card), v.to(card),
                                         cutoff, bias.to(card), kind)
    assert binned_interp.KERNEL.launches == before + 1
    grid = binned_interp.build_grid(cand, v, bias, cutoff)
    op, dp = binned_interp.binned_interp_plain(q, grid, cutoff, kind)
    od, dd = interp.interp_plain(q, cand, v, cutoff, bias, kind)
    # f32 sums over the same candidates in another order
    for o, d in ((op, dp), (od, dd)):
        torch.testing.assert_close(ok.cpu(), o, rtol=0,
                                   atol=1e-5 * float(v.abs().max()))
        torch.testing.assert_close(dk.cpu(), d, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,cutoff,c", [("bicubic", 0.16, 3),
                                           ("spline1", 0.05, 1),
                                           ("linear", 0.6, 8)])
def test_binned_interp_kernel_repeats_on_card(card, gen, kind, cutoff, c):
    """Ten calls on the inputs of the test above, each after a NaN-filled
    allocation is freed (an output the kernel did not write would show):
    every call equal bit for bit and within its limits."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    q, cand, v = t(2, 300, 3) * 0.2, t(2, 500, 3) * 0.2, t(2, 500, c)
    q[:, :4] = 999.0
    bias = torch.zeros(2, 500)
    bias[:, ::3] = 1e10
    grid = binned_interp.build_grid(cand, v, bias, cutoff)
    op, dp = binned_interp.binned_interp_plain(q, grid, cutoff, kind)
    first = None
    for _ in range(10):
        junk = torch.full((1 << 20,), float("nan"), device=card)
        del junk
        got = [x.cpu() for x in binned_interp.binned_interp(
            q.to(card), cand.to(card), v.to(card), cutoff, bias.to(card),
            kind)]
        first = first or got
        assert all(torch.equal(a, b) for a, b in zip(got, first))
        torch.testing.assert_close(got[0], op, rtol=0,
                                   atol=1e-5 * float(v.abs().max()))
        torch.testing.assert_close(got[1], dp, rtol=1e-5, atol=1e-6)


def _binned_case(gen, case, c=3):
    """(query, cand, values, bias, cutoff) at an occupancy: "dense" (the
    frame: the queries are the candidates, about 60 a cell), "sparse" (the
    grid call: about one query a cell), "mixed" (both in one call, two
    batch rows), "sentinel" (every query at 999)."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    if case == "dense":
        cand = t(1, 6000, 3) * 0.08
        return cand.clone(), cand, t(1, 6000, c), torch.zeros(1, 6000), 0.05
    if case == "sparse":
        cand = t(1, 4000, 3) * 0.3
        q = torch.rand(1, 3000, 3) * 1.2 - 0.6
        return q, cand, t(1, 4000, c), torch.zeros(1, 4000), 0.03
    if case == "mixed":
        cand = t(2, 3000, 3) * 0.15
        q = torch.cat([cand[:, :1500], torch.rand(2, 800, 3) - 0.5], 1)
        bias = torch.zeros(2, 3000)
        bias[:, ::7] = 1e10
        q[:, :5] = 999.0
        return q, cand, t(2, 3000, c), bias, 0.06
    cand = t(1, 500, 3) * 0.2
    return (torch.full((1, 70, 3), 999.0), cand, t(1, 500, c),
            torch.zeros(1, 500), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "sparse", "mixed", "sentinel"])
@pytest.mark.parametrize("kind,c", [("spline1", 1), ("bicubic", 5)])
def test_binned_interp_tiles_match_plain_on_card(card, gen, case, kind, c):
    """Every occupancy's tiles (one lane a query, split queries), one
    launch a call, two calls bit for bit."""
    q, cand, v, bias, cutoff = _binned_case(gen, case, c)
    args = (q.to(card), cand.to(card), v.to(card), cutoff, bias.to(card),
            kind)
    before = binned_interp.KERNEL.launches
    ok, dk = binned_interp.binned_interp(*args)
    assert binned_interp.KERNEL.launches == before + 1
    again = binned_interp.binned_interp(*args)
    assert torch.equal(ok, again[0]) and torch.equal(dk, again[1])
    grid = binned_interp.build_grid(cand, v, bias, cutoff)
    op, dp = binned_interp.binned_interp_plain(q, grid, cutoff, kind)
    # f32 sums over the same candidates in another order
    torch.testing.assert_close(ok.cpu(), op, rtol=0,
                               atol=1e-5 * float(v.abs().max()))
    torch.testing.assert_close(dk.cpu(), dp, rtol=1e-5, atol=1e-6)
    if case == "sentinel":
        assert bool((dk == 1e-6).all()) and bool((ok == 0).all())


def _affine_case(gen, shape, dims, mixed):
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    tab = t(*shape)
    tab[:, :, 1] = tab[:, :, 0]                 # exact max ties
    cs = (shape[-1],) + dims
    ws = [t(cs[i], cs[i + 1]) / cs[i] ** 0.5 for i in range(len(dims))]
    a_s, b_s = [1 + 0.1 * t(d) for d in dims], [0.1 * t(d) for d in dims]
    if mixed:   # an eval-mode batch norm's a = gamma / sigma of any sign
        for a in a_s:
            a[::3] *= -1
            a[1::5] = 0.0
    return tab, ws, a_s, b_s, t(shape[0], shape[1], dims[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dims,slope,mixed", [
    ((2, 64, 16, 6), (32, 64), 0.01, True),
    ((2, 1, 300, 19), (8,), 0.0, False),
    ((1, 40, 32, 6), (64, 128, 96), 0.2, True)])
def test_pooled_mlp_affine_forward_matches_plain_on_card(card, gen, shape,
                                                         dims, slope, mixed):
    """Without autograd (no z kept) and with it, one count on FWD and on
    AFFINE_FWD a call, two calls bit for bit."""
    tab, ws, a_s, b_s, _ = _affine_case(gen, shape, dims, mixed)
    want = pooled_mlp.pooled_mlp_affine_plain(tab, ws, a_s, b_s, slope)
    dev = [x.to(card) for x in (tab, *ws, *a_s, *b_s)]
    nl = len(dims)
    run = lambda xs: pooled_mlp.pooled_mlp_affine(
        xs[0], xs[1:1 + nl], xs[1 + nl:1 + 2 * nl], xs[1 + 2 * nl:], slope)
    before = (pooled_mlp.FWD.launches, pooled_mlp.AFFINE_FWD.launches)
    with torch.no_grad():
        got, again = run(dev), run(dev)
    assert (pooled_mlp.FWD.launches,
            pooled_mlp.AFFINE_FWD.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    kept = run([x.clone().requires_grad_() for x in dev])
    assert torch.equal(got, kept.detach())
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dims", [
    ((2, 1, 256, 259), (512, 512)),     # ActionCls's SA pooling
    ((2, 1, 256, 259), (256, 512)),     # ActionTempoDis's
    ((2, 64, 64, 6), (64, 64, 128)),    # the action towers' sa1 (ns 64)
    ((1, 3, 100, 40), (384, 300))])     # ragged row and column tiles
def test_pooled_mlp_affine_forward_up_to_512_wide_on_card(card, gen, shape,
                                                          dims):
    """Without autograd the affine forward takes layers up to
    MAX_AFFINE_FWD_WIDTH wide, folded affines of both signs, two calls bit
    for bit; a gradient through a layer wider than MAX_WIDTH (the
    backward's tie pass) and the batch-norm form that wide are refused."""
    tab, ws, a_s, b_s, _ = _affine_case(gen, shape, dims, True)
    want = pooled_mlp.pooled_mlp_affine_plain(tab, ws, a_s, b_s, 0.0)
    tab, *rest = [x.to(card) for x in (tab, *ws, *a_s, *b_s)]
    nl = len(dims)
    ws, a_s, b_s = rest[:nl], rest[nl:2 * nl], rest[2 * nl:]
    before = pooled_mlp.AFFINE_FWD.launches
    with torch.no_grad():
        got = pooled_mlp.pooled_mlp_affine(tab, ws, a_s, b_s, 0.0)
        again = pooled_mlp.pooled_mlp_affine(tab, ws, a_s, b_s, 0.0)
    assert pooled_mlp.AFFINE_FWD.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    if max(dims) > pooled_mlp.MAX_WIDTH:
        with pytest.raises(ValueError, match="widths <= 256"):
            pooled_mlp.pooled_mlp_affine(
                tab, [w.clone().requires_grad_() for w in ws], a_s, b_s, 0.0)
        with pytest.raises(ValueError, match="widths <= 256"):
            pooled_mlp.pooled_mlp_bn_train(tab, ws, a_s, b_s, 0.0)


@pytest.mark.gpu
def test_pooled_mlp_affine_backward_mixed_signs_repeats_on_card(card, gen):
    """Affines of both signs and zero (the max from the min of z), against
    the CPU to f32 summation order; one count on AFFINE_BWD a backward, two
    backwards bit for bit."""
    tab, ws, a_s, b_s, g = _affine_case(gen, (2, 64, 16, 6), (32, 64), True)

    def run(dev):
        leaves = [x.to(dev).requires_grad_() for x in [tab, *ws, *a_s, *b_s]]
        p = pooled_mlp.pooled_mlp_affine(leaves[0], leaves[1:3], leaves[3:5],
                                         leaves[5:7], 0.01)
        return [p, *torch.autograd.grad(p, leaves, g.to(dev))]

    before = pooled_mlp.AFFINE_BWD.launches
    first = run(card)
    assert pooled_mlp.AFFINE_BWD.launches == before + 1
    for a, b in zip(first, run(card)):
        assert torch.equal(a, b)
    for a, b in zip(first, run("cpu")):
        b = b.detach()
        torch.testing.assert_close(a.detach().cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dims,slope", [((2, 64, 16, 6), (32, 64), 0.01),
                                              ((2, 1, 300, 19), (8,), 0.0)])
def test_pooled_mlp_affine_backward_matches_plain_on_card(card, gen, shape,
                                                          dims, slope):
    """Table, weights and affines through autograd on the card against the
    CPU (plain versions); f32 sums in another order, hence the scale."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    tab = t(*shape)
    tab[:, :, 1] = tab[:, :, 0]                 # exact max ties
    cs = (shape[-1],) + dims
    ws = [t(cs[i], cs[i + 1]) / cs[i] ** 0.5 for i in range(len(dims))]
    a_s, b_s = [1 + 0.1 * t(d) for d in dims], [0.1 * t(d) for d in dims]
    g = t(shape[0], shape[1], dims[-1])

    def run(dev):
        leaves = [x.to(dev).requires_grad_() for x in [tab, *ws, *a_s, *b_s]]
        nl = len(dims)
        p = pooled_mlp.pooled_mlp_affine(leaves[0], leaves[1:1 + nl],
                                         leaves[1 + nl:1 + 2 * nl],
                                         leaves[1 + 2 * nl:], slope)
        (p * g.to(dev)).sum().backward()
        return [p] + [x.grad for x in leaves]

    before = pooled_mlp.AFFINE_BWD.launches
    got = run(card)
    assert pooled_mlp.AFFINE_BWD.launches == before + 1
    for a, b in zip(got, run("cpu")):
        b = b.detach()
        torch.testing.assert_close(a.detach().cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
