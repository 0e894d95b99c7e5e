#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port, ``tpugan_tpu_torch``.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py                 # the whole run, about a minute
    python3 chip_smoke.py --profile DIR   # also profiles one forward of each
                                          # serving mode, tables into DIR

Phases, one JSON line each (``phase`` names it):
  device   nvidia-smi name and power limit, torch and CUDA versions, the
           kernels' build time and their ptxas register / spill report;
  kernel   each CUDA kernel against its plain PyTorch version on the card,
           at every shape the serving path gives it: the error against the
           stated tolerance, CUDA-event medians of the kernel, the plain
           version and a PyTorch yardstick the port never calls, the bound;
  serving  with the launch counts reset: the trained checkpoint through the
           port's loader, the f32 dynamic and the bf16 static forward of a
           10,240-point frame, the Chamfer gate between them, the launches
           of each;
  rollout  a 25-frame rollout of about 10,000-point frames (counts read
           after it);
  timing   the card's forward against the CPU's (plain versions) at 2,048
           points, and ms per frame of both serving forwards;
  profile  with --profile only: device time by kernel and idle share of one
           forward of each serving mode.
Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before the ok line. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")
N_POINTS = 10240          # serving frame (the JAX bench's frame)
ROLLOUT_FRAMES = 25
ROLLOUT_POINTS = 10000    # not a multiple of the rollout's ALIGN
GATE = 5e-3               # normalised Chamfer gate, as in bench.py

# H100 SXM published peaks (dense): HBM bytes/s and the rates by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}

REPS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, reps=REPS, warmup=2) -> float:
    """Median over ``reps`` runs of CUDA-event time, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, kind: str):
    """(least time in ms, "bytes" or "operations") on the published peaks."""
    t_ops = flops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(name: str) -> dict:
    from tpugan_tpu_torch import _build

    text = _build.ptxas_report(name)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return {"functions": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


# ---------------------------------------------------------------- phase 2

KNN_SHAPES = [   # (D, k, graphs of this shape per f32 dynamic forward)
    (3, 20, 1),    # EdgeConv_0 on pos
    (32, 20, 2),   # one per IDGCN layer, on the bottleneck
    (64, 12, 2),   # upsampler and mask head, first EdgeConv
    (64, 4, 1),    # upsampler, second EdgeConv
    (64, 8, 1),    # mask head, second EdgeConv
]

EDGECONV_SHAPES = [  # (name, C, H, O, K, aggregate, mlp, launches per forward)
    ("EdgeConv_0", 6, 64, 128, 20, "max", True, 1),
    ("IDGCN d=1", 32, 16, 32, 20, "max", True, 2),
    ("IDGCN d=2", 32, 16, 32, 10, "max", True, 2),
    ("up/mask k=12", 64, 128, 256, 12, "max", True, 2),
    ("up k=4", 64, 128, 256, 4, "max", True, 1),
    ("mask k=8 sum", 64, 128, 128, 8, "sum", False, 1),
]


def exact_sqdist(q, c, qi, ci):
    """float64 |q_i - c_j|^2 for index arrays (numpy)."""
    return np.sum((q[qi].astype(np.float64) - c[ci].astype(np.float64)) ** 2, -1)


def check_knn(torch, dev, rng):
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows = []
    for d, k, per_fwd in KNN_SHAPES:
        scale = 0.3 if d == 3 else 1.0
        q_np = (rng.standard_normal((N_POINTS, d)) * scale).astype(np.float32)
        q = torch.from_numpy(q_np)[None].to(dev)
        bias = torch.zeros((1, N_POINTS), device=dev)
        d2k, ik = K.knn_kernel(q, q, bias, k)
        d2p, ip = K.knn_plain(q, q, bias, k)
        torch.cuda.synchronize()
        # error scale of max(|q|^2 + |c|^2 - 2 q.c, 0) in f32
        tol = 1e-5 * 2 * float((q * q).sum(-1).max())
        err = float((d2k - d2p).abs().max())
        ik_np, ip_np = ik[0].cpu().numpy(), ip[0].cpu().numpy()
        diff = np.nonzero(ik_np != ip_np)
        rows_i = diff[0]
        # an index may differ only where the two candidates tie within tol
        gap = np.abs(exact_sqdist(q_np, q_np, rows_i, ik_np[diff])
                     - exact_sqdist(q_np, q_np, rows_i, ip_np[diff]))
        ok = err <= tol and (gap.size == 0 or float(gap.max()) <= 2 * tol)
        if not ok:
            raise AssertionError(f"knn D={d} k={k}: err {err} tol {tol}, "
                                 f"index gaps up to {gap.max() if gap.size else 0}")
        ms = time_ms(lambda: K.knn_kernel(q, q, bias, k), torch)
        plain_ms = time_ms(lambda: K.knn_plain(q, q, bias, k), torch)
        lib_ms = time_ms(lambda: torch.topk(torch.cdist(q, q), k, largest=False),
                         torch)
        flops = N_POINTS * N_POINTS * (2 * d + 3)
        nbytes = 4 * (2 * N_POINTS * d + N_POINTS) + N_POINTS * k * 12
        b_ms, b_by = bound(flops, nbytes, "f32")
        rows.append(dict(D=d, k=k, per_forward=per_fwd, max_abs_err=err,
                         tol=tol, index_mismatch=int(rows_i.size), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        emit({"phase": "kernel", "kernel": "knn", **rows[-1]})
    return rows


def check_edgeconv(torch, dev, rng):
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    rows = []
    for name, c, h, o, k, agg, mlp, per_fwd in EDGECONV_SHAPES:
        for cdt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            t = lambda *s: torch.from_numpy(
                rng.standard_normal(s).astype(np.float32)).to(dev)
            nbr = t(1, k, N_POINTS, c)
            ctr = t(1, N_POINTS, c)
            wn, we = t(c, h) / np.sqrt(c), t(c, h) / np.sqrt(c)
            w1 = t(h, h) / np.sqrt(h) if mlp else None
            w2 = t(h, o) / np.sqrt(h) if mlp else None
            args = (nbr.to(cdt), ctr.to(cdt), wn, we, w1, w2, agg, cdt)
            out_k = E.edgeconv_fused(*args).float()
            out_p = E.edgeconv_plain(*args).float()
            torch.cuda.synchronize()
            scale = float(out_p.abs().max())
            # f32: summation order only; bf16: a 1-ulp rounding flip of one
            # layer's value may carry through the next layers
            tol = (1e-4 if kind == "f32" else 3e-2) * scale
            err = float((out_k - out_p).abs().max())
            if not (err <= tol and bool(torch.isfinite(out_k).all())):
                raise AssertionError(f"edgeconv {name} {kind}: err {err} tol {tol}")
            ms = time_ms(lambda: E.edgeconv_fused(*args), torch)
            plain_ms = time_ms(lambda: E.edgeconv_plain(*args), torch)
            esz = 4 if kind == "f32" else 2
            flops = 2 * N_POINTS * k * (2 * c * h + ((h * h + h * o) if mlp else 0))
            nbytes = esz * (k * N_POINTS * c + N_POINTS * c + 2 * c * h
                            + ((h * h + h * o) if mlp else 0) + N_POINTS * o)
            b_ms, b_by = bound(flops, nbytes, kind)
            rows.append(dict(config=name, dtype=kind, C=c, H=h, O=o, K=k,
                             aggregate=agg, per_forward=per_fwd,
                             max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by))
            emit({"phase": "kernel", "kernel": "edgeconv", **rows[-1]})
    return rows


def check_nn1(torch, dev, rng):
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    m = N_POINTS * 8
    q_np = (rng.standard_normal((m, 3)) * 0.3).astype(np.float32)
    c_np = (rng.standard_normal((m, 3)) * 0.3).astype(np.float32)
    q = torch.from_numpy(q_np)[None].to(dev)
    c = torch.from_numpy(c_np)[None].to(dev)
    bias = torch.zeros((1, m), device=dev)
    bias[:, -4096:] = 1e10                              # a masked tail
    d2k, ik = N1.nn1_kernel(q, c, bias)
    d2p, ip = N1.nn1_plain(q, c, bias)
    torch.cuda.synchronize()
    tol = 1e-5 * 2 * float(max((q * q).sum(-1).max(), (c * c).sum(-1).max()))
    err = float((d2k - d2p).abs().max())
    ik_np, ip_np = ik[0].cpu().numpy(), ip[0].cpu().numpy()
    rows_i = np.nonzero(ik_np != ip_np)[0]
    gap = np.abs(exact_sqdist(q_np, c_np, rows_i, ik_np[rows_i])
                 - exact_sqdist(q_np, c_np, rows_i, ip_np[rows_i]))
    if not (err <= tol and (gap.size == 0 or gap.max() <= 2 * tol)
            and int(ik_np.max()) < m - 4096):
        raise AssertionError(f"nn1: err {err} tol {tol}")
    ms = time_ms(lambda: N1.nn1_kernel(q, c, bias), torch)
    plain_ms = time_ms(lambda: N1.nn1_plain(q, c, bias), torch)

    def yardstick():
        for s in range(0, m, 8192):
            torch.cdist(q[:, s:s + 8192], c).min(-1)

    lib_ms = time_ms(yardstick, torch)
    b_ms, b_by = bound(m * m * 9.0, 4 * (3 * m + 3 * m + m) + 12 * m, "f32")
    row = dict(Nq=m, M=m, masked=4096, per_gate=2, max_abs_err=err, tol=tol,
               index_mismatch=int(rows_i.size), ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernel", "kernel": "nn1", **row})
    return [row]


# ---------------------------------------------------------- phases 3 and 4

def counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def delta(before, after) -> dict:
    return {n: after[n] - before[n] for n in after}


def expect(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def serving(torch, dev, kernels):
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.ops.metrics import chamfer

    f32 = load_srnet(CHECKPOINT, device=dev)
    bf16 = load_srnet(CHECKPOINT, device=dev, compute_dtype=torch.bfloat16,
                      graph_mode="static")
    r = f32.upsample_ratio
    rng = np.random.default_rng(0)
    pos_np = rng.standard_normal((1, N_POINTS, 3)).astype(np.float32) * 0.3
    pos = torch.from_numpy(pos_np).to(dev)
    feat = torch.cat([pos, torch.zeros_like(pos)], -1)    # zero velocity

    c0 = counts(kernels)
    exp_f32, mask_f32, _, valid_f32 = f32(feat, pos)
    torch.cuda.synchronize()
    c1 = counts(kernels)
    expect(delta(c0, c1), {"knn": 7, "edgeconv": 9, "nn1": 0},
           "f32 dynamic forward")
    exp_bf16, _, _, valid_bf16 = bf16(feat, pos)
    torch.cuda.synchronize()
    c2 = counts(kernels)
    expect(delta(c1, c2), {"knn": 1, "edgeconv": 9, "nn1": 0},
           "bf16 static forward")
    scale = float((pos ** 2).sum(-1).mean())
    cd = float(chamfer(exp_f32, exp_bf16).mean())
    cd_norm = cd / (exp_f32.shape[1] * scale)
    torch.cuda.synchronize()
    expect(delta(c2, counts(kernels)), {"knn": 0, "edgeconv": 0, "nn1": 2},
           "Chamfer gate")
    for name, out, valid in (("f32", exp_f32, valid_f32),
                             ("bf16", exp_bf16, valid_bf16)):
        n_valid = int(valid.sum())
        if (tuple(out.shape) != (1, N_POINTS * r, 3)
                or not bool(torch.isfinite(out).all())
                or not N_POINTS <= n_valid <= N_POINTS * r):
            raise AssertionError(f"{name} forward: shape {tuple(out.shape)}, "
                                 f"valid {n_valid}")
    if not cd_norm < GATE:
        raise AssertionError(f"Chamfer gate failed: {cd_norm} >= {GATE}")

    emit({"phase": "serving", "checkpoint": os.path.relpath(CHECKPOINT, ROOT),
          "points": N_POINTS, "ratio": r,
          "f32_dynamic_valid": int(valid_f32.sum()),
          "bf16_static_valid": int(valid_bf16.sum()),
          "chamfer_norm": cd_norm, "gate": GATE,
          "launches": {"f32_dynamic": delta(c0, c1), "bf16_static": delta(c1, c2),
                       "gate": {"nn1": 2}}})
    return (f32, bf16), (feat, pos, pos_np)


class GraphReplay:
    """Runs the card's forward recording every kNN graph it builds, then
    the CPU's forward with those graphs replayed in order. Each replayed
    list is first held against the CPU's own kNN of its own features: they
    may differ only between candidates whose exact distances tie within f32
    noise (the two devices round |q|^2 + |c|^2 - 2 q.c differently, and
    under the IDGCN's ::2 dilation one such swap changes a point's features
    and then its neighbours'). With equal graphs the outputs must agree to
    f32 noise."""

    def __init__(self, torch):
        import tpugan_tpu_torch.models.generator as generator
        import tpugan_tpu_torch.nn.edgeconv as edgeconv

        self.torch, self.modules = torch, (generator, edgeconv)
        self.own = generator.graph_knn
        self.lists, self.swaps = [], 0

    def _run(self, fn, model, *args):
        for m in self.modules:
            m.graph_knn = fn
        try:
            return model(*args)
        finally:
            for m in self.modules:
                m.graph_knn = self.own

    def record(self, model, *args):
        def recording(x, k, c_valid=None):
            d2, idx = self.own(x, k, c_valid)
            self.lists.append(idx.cpu())
            return d2, idx
        return self._run(recording, model, *args)

    def replay(self, model, *args):
        def replaying(x, k, c_valid=None):
            d2, own = self.own(x, k, c_valid)
            rec = self.lists.pop(0)
            xf = x.double()
            b, r, s = (rec != own).nonzero(as_tuple=True)
            exact = lambda idx: ((xf[b, r] - xf[b, idx[b, r, s]]) ** 2).sum(-1)
            tol = 1e-5 * 2 * float((xf * xf).sum(-1).max())
            gap = (exact(rec) - exact(own)).abs()
            if gap.numel() and float(gap.max()) > tol:
                raise AssertionError(f"kNN differs beyond f32 noise: {gap.max()}")
            self.swaps += int(gap.numel())
            return d2, rec
        return self._run(replaying, model, *args)


def cpu_reference(torch, dev, pos_np, points=2048):
    """The card's forward (kernels) against the CPU's (plain versions) on
    the first ``points`` points of the frame, f32, both graph modes, with
    the card's graphs replayed on the CPU (see GraphReplay). Keep masks may
    differ only where the raw mask lies within 1e-4 of epsilon."""
    from tpugan_tpu_torch.checkpoint import load_srnet

    small = torch.from_numpy(pos_np[:, :points])
    small_feat = torch.cat([small, torch.zeros_like(small)], -1)
    out = {"cpu_check_points": points}
    for mode in ("dynamic", "static"):
        gpu = load_srnet(CHECKPOINT, device=dev, graph_mode=mode)
        cpu = load_srnet(CHECKPOINT, device="cpu", graph_mode=mode)
        replay = GraphReplay(torch)
        e_gpu, m_gpu, _, v_gpu = replay.record(gpu, small_feat.to(dev),
                                               small.to(dev))
        e_cpu, m_cpu, _, v_cpu = replay.replay(cpu, small_feat, small)
        e_gpu, m_gpu, v_gpu = e_gpu.cpu(), m_gpu.cpu(), v_gpu.cpu()
        flipped = v_gpu != v_cpu
        near = ((m_cpu - gpu.epsilon).abs() < 1e-4).repeat_interleave(
            gpu.upsample_ratio, 1)
        out[f"{mode}_mask_err"] = float((m_gpu - m_cpu).abs().max())
        out[f"{mode}_position_err"] = float((e_gpu - e_cpu).abs().max())
        out[f"{mode}_knn_tie_swaps"] = replay.swaps
        out[f"{mode}_keep_flips"] = int(flipped.sum())
        if not (bool(near[flipped].all()) and out[f"{mode}_mask_err"] < 1e-4
                and out[f"{mode}_position_err"] < 1e-4):
            raise AssertionError(f"{mode} card vs CPU: {out}")
    return out


def profile(torch, name, model, feat, pos, out_dir):
    """torch.profiler table of one forward (device time by kernel, and the
    device's busy share of the forward's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    os.makedirs(out_dir, exist_ok=True)
    model(feat, pos)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        model(feat, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: a host op's self device time is the time of the
    # kernels it launched, which have rows of their own
    table = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda x: -x[1])
    kernels_ms = sum(t for _, t, _ in table)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as fh:
        fh.write(p.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=60))
    emit({"phase": "profile", "forward": name, "wall_ms": wall_ms,
          "device_kernel_ms": kernels_ms,
          "device_idle_share": 1.0 - kernels_ms / wall_ms,
          "top": [(n[:60], round(t, 4), c) for n, t, c in table[:12]]})


def rollout(torch, model, kernels):
    """25 frames chained as the JAX bench chains them (frame t+1 is the
    first 10,000 expanded points of frame t's forward, times 0.999), with
    zero velocity; frame t keeps 10,000 - 8 * (t % 4) of them, so the
    frames are ragged within one bucket. Then ``rollout_sequence`` over the
    sequence."""
    from tpugan_tpu_torch.eval.rollout import rollout_sequence

    dev = next(model.parameters()).device
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.standard_normal((1, ROLLOUT_POINTS, 3))
                           .astype(np.float32) * 0.3).to(dev)
    frames = []
    for t in range(ROLLOUT_FRAMES):
        n = ROLLOUT_POINTS - 8 * (t % 4)
        frames.append((pos[0, :n].cpu().numpy(), None))
        expanded = model(torch.cat([pos, torch.zeros_like(pos)], -1), pos)[0]
        pos = expanded[:, :ROLLOUT_POINTS] * 0.999
    c0 = counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = rollout_sequence(model, frames, use_vel=True)
    wall = time.perf_counter() - t0
    got = delta(c0, counts(kernels))
    expect(got, {"knn": ROLLOUT_FRAMES, "edgeconv": 9 * ROLLOUT_FRAMES, "nn1": 0},
           "rollout")
    if len(outs) != ROLLOUT_FRAMES:
        raise AssertionError(f"rollout returned {len(outs)} frames")
    sizes = []
    for (p, _), o in zip(frames, outs):
        n = p.shape[0]
        if not (np.isfinite(o).all() and n <= o.shape[0] <= n * model.upsample_ratio
                and np.abs(o).max() < 100):
            raise AssertionError(f"rollout frame of {n}: {o.shape[0]} points")
        sizes.append(int(o.shape[0]))
    emit({"phase": "rollout", "frames": ROLLOUT_FRAMES,
          "points": [int(f[0].shape[0]) for f in frames[:4]],
          "output_points_first_last": [sizes[0], sizes[-1]],
          "launches": got, "wall_ms_per_frame": wall * 1e3 / ROLLOUT_FRAMES})


def kernel_line(knn_rows, ec_rows, nn1_rows, launches):
    """One entry per kernel: times are sums over the shapes of one f32
    dynamic forward (knn, edgeconv) or one gate (nn1), weighted by how
    often each shape runs there."""
    def total(rows, key, weight):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r[weight] for r in rows)

    ec_f32 = [r for r in ec_rows if r["dtype"] == "f32"]
    entries = []
    for name, source, replaces, rows, weight, per in (
            ("knn", "tpugan_tpu_torch/csrc/knn.cu",
             "tpugan_tpu/ops/pallas/knn_kernel.py:350", knn_rows,
             "per_forward", "one f32 dynamic forward (7 graphs)"),
            ("edgeconv", "tpugan_tpu_torch/csrc/edgeconv.cu",
             "tpugan_tpu/ops/pallas/edgeconv_kernel.py:358", ec_f32,
             "per_forward", "one f32 dynamic forward (9 EdgeConvs)"),
            ("nn1", "tpugan_tpu_torch/csrc/nn1.cu",
             "tpugan_tpu/ops/pallas/nn1_kernel.py:123", nn1_rows,
             "per_gate", "one Chamfer gate (2 directions)")):
        b_ms = total(rows, "bound_ms", weight)
        by = {r["bound_by"] for r in rows}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total(rows, "ms", weight),
            "plain_ms": total(rows, "plain_ms", weight),
            "bound_ms": b_ms,
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": total(rows, "library_ms", weight),
            "times_are": per})
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one forward of each serving mode "
                         "into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build
    from tpugan_tpu_torch.ops.kernels import edgeconv, knn, nn1

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    build_s = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {n: ptxas_summary(n) for n in _build.sources()}})

    kernels = {"knn": knn.KERNEL, "edgeconv": edgeconv.KERNEL, "nn1": nn1.KERNEL}
    rng = np.random.default_rng(0)
    knn_rows = check_knn(torch, dev, rng)
    ec_rows = check_edgeconv(torch, dev, rng)
    nn1_rows = check_nn1(torch, dev, rng)

    # the serving path: counts start at 0 here and are read after the rollout
    for k in kernels.values():
        k.launches = 0
    (f32, bf16), (feat, pos, pos_np) = serving(torch, dev, kernels)
    rollout(torch, bf16, kernels)
    launches = counts(kernels)

    # checks and timings past the counted run
    result = cpu_reference(torch, dev, pos_np)
    result["f32_dynamic_ms_per_frame"] = time_ms(lambda: f32(feat, pos), torch)
    result["bf16_static_ms_per_frame"] = time_ms(lambda: bf16(feat, pos), torch)
    emit({"phase": "timing", **result})
    if args.profile:
        profile(torch, "f32_dynamic", f32, feat, pos, args.profile)
        profile(torch, "bf16_static", bf16, feat, pos, args.profile)

    emit(kernel_line(knn_rows, ec_rows, nn1_rows, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
