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
from tpugan_tpu_torch.checkpoint import load_srnet
from tpugan_tpu_torch.models.generator import RolloutMaskState, SRNet
from tpugan_tpu_torch.ops.kernels import (ball_query, binned_interp, edgeconv,
                                          fps, interp, knn, nn1, pooled_mlp)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")


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
        "'ops.metrics'):\n"
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
                 lambda: RolloutMaskState.create(1, 64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("wrapper", ["knn", "nn1", "edgeconv", "fps",
                                     "ball_query", "interp", "pooled_mlp",
                                     "binned_interp"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(wrapper):
    # a tensor on neither the CPU nor a CUDA card is refused, not computed
    t = lambda *s: torch.zeros(s, device="meta")
    calls = {
        "knn": lambda: knn.knn_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8), 4),
        "nn1": lambda: nn1.nn1_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8)),
        "edgeconv": lambda: edgeconv.edgeconv_fused(
            t(1, 4, 8, 6), t(1, 8, 6), t(6, 8), t(6, 8), t(8, 8), t(8, 16)),
        "fps": lambda: fps.fps_kernel(t(1, 8, 3), 4, t(1, 8),
                                      torch.zeros(1, dtype=torch.int64,
                                                  device="meta")),
        "ball_query": lambda: ball_query.ball_query_kernel(
            t(1, 8, 3), t(1, 8, 3), 0.1, 4, t(1, 8)),
        "interp": lambda: interp.interp_kernel(t(1, 8, 3), t(1, 8, 3),
                                               t(1, 8, 3), 0.1, t(1, 8)),
        "pooled_mlp": lambda: pooled_mlp.pooled_mlp_bn_train(
            t(1, 2, 4, 6), [t(6, 8)], [t(8)], [t(8)]),
        "binned_interp": lambda: binned_interp.binned_interp(
            t(1, 8, 3), t(1, 8, 3), t(1, 8, 3), 0.1, t(1, 8)),
    }
    with pytest.raises(ValueError, match="tensors on"):
        calls[wrapper]()
    assert all(k.launches == 0 for k in (knn.KERNEL, nn1.KERNEL, fps.KERNEL,
                                         ball_query.KERNEL, interp.KERNEL,
                                         pooled_mlp.FWD, pooled_mlp.BWD,
                                         binned_interp.KERNEL))


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


@pytest.mark.gpu
@pytest.mark.parametrize("d,k,nc", [(3, 20, 1000), (32, 12, 333),
                                    (64, 4, 2048), (6, 1, 7), (3, 32, 256),
                                    (3, 64, 1000), (3, 50, 777)])
def test_knn_kernel_matches_plain_on_card(card, gen, d, k, nc):
    q = torch.from_numpy(gen.standard_normal((2, 300, d)).astype(np.float32))
    c = torch.from_numpy(gen.standard_normal((2, nc, d)).astype(np.float32))
    bias = torch.where(torch.rand(2, nc, generator=torch.Generator().manual_seed(0))
                       < 0.1, 1e10, 0.0)
    d2k, ik = knn.knn_kernel(q.to(card), c.to(card), bias.to(card), k)
    d2p, ip = knn.knn_plain(q, c, bias, k)
    # f32 rounding of |q|^2 + |c|^2 - 2 q.c
    tol = 1e-5 * float((q * q).sum(-1).max() + (c * c).sum(-1).max())
    torch.testing.assert_close(d2k.cpu(), d2p, rtol=0, atol=tol)
    assert float((ik.cpu() == ip).float().mean()) > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,o,k,agg", [(6, 64, 128, 20, "max"),
                                         (32, 16, 32, 10, "max"),
                                         (64, 128, None, 8, "sum"),
                                         (10, 24, 40, 5, "mean"),
                                         (12, 8, 8, 3, "min")])
def test_edgeconv_kernel_matches_plain_on_card(card, gen, dtype, c, h, o, k,
                                               agg):
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    args = [t(2, k, 77, c).to(dtype), t(2, 77, c).to(dtype), t(c, h), t(c, h),
            t(h, h) if o else None, t(h, o) if o else None]
    out_k = edgeconv.edgeconv_fused(*[a.to(card) if a is not None else None
                                      for a in args], aggregate=agg,
                                    compute_dtype=dtype)
    out_p = edgeconv.edgeconv_plain(*args, aggregate=agg, compute_dtype=dtype)
    scale = float(out_p.float().abs().max())
    # f32: summation order; bf16: a one-ulp rounding flip carried forward
    tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
    torch.testing.assert_close(out_k.cpu().float(), out_p.float(), rtol=0,
                               atol=tol)


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


@pytest.mark.gpu
def test_pooled_mlp_kernels_match_plain_on_card(card, gen):
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    tab = t(2, 64, 16, 6)
    tab[:, :, 1] = tab[:, :, 0]                 # exact max ties
    ws = [t(6, 32) / 6 ** 0.5, t(32, 64) / 32 ** 0.5]
    gs, bs = [1 + 0.1 * t(32), 1 + 0.1 * t(64)], [0.1 * t(32), 0.1 * t(64)]
    g = t(2, 64, 64)

    def run(dev):
        leaves = [x.to(dev).requires_grad_() for x in [tab, *ws, *gs, *bs]]
        p, mus, vs = pooled_mlp.pooled_mlp_bn_train(
            leaves[0], leaves[1:3], leaves[3:5], leaves[5:7], 0.01)
        (p * g.to(dev)).sum().backward()
        return [p, *mus, *vs] + [x.grad for x in leaves]

    for a, b in zip(run(card), run("cpu")):
        # f32 sums in another order; BN backward cancels, hence the scale
        b = b.detach()
        torch.testing.assert_close(a.detach().cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


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
