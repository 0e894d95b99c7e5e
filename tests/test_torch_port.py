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
from tpugan_tpu_torch.ops.kernels import edgeconv, knn, nn1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import tpugan_tpu_torch, tpugan_tpu_torch.checkpoint\n"
        "import tpugan_tpu_torch.eval.rollout, tpugan_tpu_torch.ops.metrics\n"
        "import chip_smoke\n"
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


@pytest.mark.parametrize("wrapper", ["knn", "nn1", "edgeconv"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(wrapper):
    # a tensor on neither the CPU nor a CUDA card is refused, not computed
    t = lambda *s: torch.zeros(s, device="meta")
    with pytest.raises(ValueError, match="tensors on"):
        if wrapper == "knn":
            knn.knn_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8), 4)
        elif wrapper == "nn1":
            nn1.nn1_kernel(t(1, 8, 3), t(1, 8, 3), t(1, 8))
        else:
            edgeconv.edgeconv_fused(t(1, 4, 8, 6), t(1, 8, 6), t(6, 8),
                                    t(6, 8), t(8, 8), t(8, 16))
    assert knn.KERNEL.launches == nn1.KERNEL.launches == 0


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
                                    (64, 4, 2048), (6, 1, 7)])
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
