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
        "'ops.metrics', 'cli.train_fluid', 'train.checkpoint', "
        "'utils.logging', 'config', 'data.prefetch'):\n"
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


@pytest.mark.parametrize("wrapper", ["knn", "knn_approx", "nn1", "edgeconv",
                                     "edgeconv_tc",
                                     "edgeconv_f32t", "edgeconv_bwd",
                                     "edgeconv_bwd_tiled",
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


# (mlp, C, H, O) of the classes the f32 register-tiled kernel takes
F32_TILED = [(True, 64, 128, 256), (False, 64, 128, 128), (True, 6, 64, 128),
             (True, 32, 16, 32)]


@pytest.mark.parametrize("dtype,mlp,widths,tc,f32t", [
    (torch.bfloat16, True, (64, 128, 256), True, False),
    (torch.float32, True, (64, 128, 256), False, True),
    (torch.bfloat16, True, (64, 128, 128), False, False),
    (torch.bfloat16, False, (64, 128, 128), False, False),
    (torch.bfloat16, False, (64, 128, 256), False, False),
    (torch.bfloat16, True, (6, 64, 128), False, False),
    (torch.bfloat16, True, (32, 16, 32), False, False),
    (torch.bfloat16, True, (32, 128, 256), False, False),
    (torch.float16, True, (64, 128, 256), False, False),
    (torch.float32, False, (64, 128, 128), False, True),
    (torch.float32, True, (6, 64, 128), False, True),
    (torch.float32, True, (32, 16, 32), False, True),
    (torch.float32, False, (64, 128, 256), False, False),
    (torch.float32, True, (32, 128, 256), False, False),
    (torch.float32, True, (10, 24, 40), False, False),
    (torch.float32, True, (12, 8, 8), False, False),
])
def test_edgeconv_dispatch_takes_tensor_cores_only_at_its_class(dtype, mlp,
                                                                 widths, tc,
                                                                 f32t):
    """Only the bf16 forward with the SharedMLP at (C, H, O) = (64, 128,
    256) routes to the tensor-core kernel, and only the f32 forward at a
    class of ``F32_TILED`` to the f32 register-tiled kernel; another dtype,
    width or SharedMLP setting takes the general kernel."""
    assert edgeconv.takes_tensor_cores(dtype, mlp, *widths) is tc
    assert edgeconv.takes_f32_tiled(dtype, mlp, *widths) is f32t
    assert edgeconv.F32_TILED_CLASSES == frozenset(F32_TILED)


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
    # aggregate the serving forward gives it
    for c, h, o, agg in [(64, 128, None, "sum"), (6, 64, 128, "max"),
                         (32, 16, 32, "max")]:
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
    """The bf16 forward at (64, 128, 256) with the SharedMLP launches the
    tensor-core kernel (one count of TC_LAUNCHES), the f32 forward at a
    class of F32_TILED the f32 register-tiled kernel (one count of
    F32_TILED_LAUNCHES), every other forward the general kernel (none of
    either); exact inputs give the plain version bit for bit."""
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
    tc = dtype == torch.bfloat16 and (c, h, o) == (64, 128, 256)
    f32t = dtype == torch.float32 and (o is not None, c, h, o or h) in F32_TILED
    assert edgeconv.TC_LAUNCHES == before + int(tc)
    assert edgeconv.F32_TILED_LAUNCHES == before_f32t + int(f32t)
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


def _tiled_bwd_args(gen, k, n, ties, dtype=torch.float32):
    """Inputs of the backward at (C, H, O) = (64, 128, 256), B = 2."""
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    nbr = t(2, k, n, 64)
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    return [nbr.to(dtype), t(2, n, 64).to(dtype), t(64, 128) / 8.0,
            t(64, 128) / 8.0, t(128, 128) / 128 ** 0.5,
            t(128, 256) / 128 ** 0.5, t(2, n, 256).to(dtype)]


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


def _run_pooled_bn(dev, tab, ws, gs, bs, g):
    leaves = [x.to(dev).requires_grad_() for x in [tab, *ws, *gs, *bs]]
    p, mus, vs = pooled_mlp.pooled_mlp_bn_train(
        leaves[0], leaves[1:3], leaves[3:5], leaves[5:7], 0.01)
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
