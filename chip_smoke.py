#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port, ``tpugan_tpu_torch``.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py                 # the whole run, a few minutes
    python3 chip_smoke.py --profile DIR   # also profiles one forward of each
                                          # serving mode and writes the
                                          # tables (and the train step's)
                                          # into DIR

Phases, one JSON line each (``phase`` names it):
  device   nvidia-smi name and power limit, torch and CUDA versions, the
           kernels' build time and their ptxas register / spill report
           (and the tensor-core and the f32 register-tiled EdgeConv
           kernels' alone, the latter must not spill; the approximate kNN
           kernel's; the pooled MLP's batch-norm kernels, rows_gemm,
           dw_gemm and top_kernel, and every instance of the FPS kernel's
           fps_warp and fps_cluster, which must not spill);
  kernel   each CUDA kernel of the serving path against its plain PyTorch
           version on the card, at every shape the serving path and the
           train step give it: the error against the stated tolerance,
           CUDA-event medians of the kernel, the plain version and a
           PyTorch yardstick the port never calls, the bound; kNN also on
           exact ties at serving width (duplicated grid points), equal to
           the plain version; each EdgeConv row names its variant (the
           bf16 (64, 128, 256) class runs the tensor-core kernel, "tc",
           the f32 classes of F32_TILED_CLASSES the f32 register-tiled
           one, "f32t", the rest the general one, "simt") and adds the
           device time of the wrapper's launches (torch.profiler), and the
           tc class and every f32t class on exact inputs at serving width
           equal the plain version bit for bit;
  kernel   (approx) the approximate bf16 kNN kernel against its plain
           version at the six approximate serving shapes (the f32 dynamic
           forward's five graph shapes at 10,240 points, the first also the
           bf16 static graph's; the rollout's 10,112-row frame, its last
           112 rows at the 999 sentinel with no invalid bias, as the
           rollout pads it), with the share of queries whose neighbour set
           differs from the exact kernel's, the times of the exact kernel,
           the plain version and the yardstick; the duplicated grid (bit
           for bit) and a query whose lane column holds more of its
           neighbours than the mode keeps (the same neighbour dropped);
  serving  with the launch counts reset: the trained checkpoint through the
           port's loader, the f32 dynamic and the bf16 static forward of a
           10,240-point frame, the Chamfer gate between them, the launches
           of each (the bf16 static forward's 9 EdgeConvs include 3
           tensor-core launches and no f32t one, the f32 dynamic's 9 f32t
           launches and no tensor-core one);
  rollout  a 25-frame rollout of about 10,000-point frames (counts read
           after it; 3 tensor-core EdgeConv launches a frame, no f32t one);
  timing   the card's forward against the CPU's (plain versions) at 2,048
           points, and ms per frame of both serving forwards;
  serving_approx with the launch counts reset: the exact f32 dynamic
           forward, then with the approximate graph kNN switched on the f32
           dynamic (7 approximate launches) and the bf16 static forward (1),
           each with the normalised Chamfer against the exact one under
           GATE, the keep-mask agreement and ms per frame; then the rollout
           above with the switch on (1 approximate launch a frame); counts
           read after it;
  profile  with --profile only: device time by kernel and idle share of one
           forward of each serving mode;
  kernel   (train) the train step's kernels (fps, ball_query, the pooled
           MLP forward and backward, interp) against their plain versions
           at every shape one train step gives them (FPS index for index,
           each row with its launch plan (variant, cluster size, threads,
           points a thread), its device time and its device microseconds a
           round, also on rows of exact ties and rows that run out of valid
           points, then the round's fixed cost, "fps_floor": one point a
           thread, 1,024 rounds, on one warp and on clusters of 1 to 16
           blocks; the pooled MLP also
           with gammas of both signs and zero, and with the device time of
           each of its kernels); the EdgeConv backward
           at each shape class of the fused train step (12 frames of 1,152
           points; f32, one bf16 case, one with exact ties between
           duplicated planes), each row with the path it takes ("tiled":
           the f32 (64, 128, 256) class on GEMM tiles, two calls equal bit
           for bit; "general" the rest) and the device time of each of its
           kernels; and the pooled MLP's affine backward at the
           spatial critic's sa_0 and a group_all shape;
  train    with the launch counts reset: the trainer state of
           checkpoints/fluid_vel_20k.ckpt resumed for 4 full-width
           train_vel steps (B=4, 9,216-point patches, device sampling,
           dense interp) on the port's synthetic fluid data; losses, the
           adversarial gate, the critics' updates and state, the launches
           of each step against the counts the step's code implies, ms per
           step by CUDA events, the peak device memory from resuming the
           state on; then a profile of 2 more steps;
  train_cpu one small step (B=2, 1,024-point patches) from the same state
           and draws on the card and on the CPU (plain versions);
  train_fused with the launch counts reset: the train CLI twin
           (cli/train_fluid.main, called as a function) with
           TPUGAN_FUSED_EDGECONV_TRAIN=1, --preset train_vel
           --device_sampling --synthetic, resumed from the checkpoint for
           iterations 20001-20004 (log dir runs/chip_smoke_train_fluid/):
           each step's launches against STEP_ALWAYS + STEP_FUSED (9 fused
           EdgeConv forwards and 9 backwards, STEP_TILED_BWD = 3 of those
           on GEMM tiles, none between steps) and the gate's and critics'
           counts, the checkpoint iterations' test split and sample dump
           against CKPT_EVAL, the last checkpoint read back equal to the
           state in memory; then one step with the switch off and on from
           the same state and draws (graphs replayed), the generator's
           gradients against FUSED_GRAD_TOL, ms per step of both, G only
           and G+D, and a profile of 2 more fused steps;
  kernel   (eval) kNN at k = 32 over [1, 9,216] x [1, 9,216] (the capped
           interpolation) and k = 64 over [1, 9,216]^2 (the capped
           density), nn1 at the eval Chamfers' shapes (sentinel-padded
           queries, a masked candidate tail), each against its plain
           version (run with the kernel checks above);
  eval     with the launch counts reset: the port's eval CLI, called as a
           function, on the trained checkpoint at 9,216-point patches with
           its default 2,000 auction rounds, 2 samples f32 dynamic and 1
           bf16 static with the exact twin, on synthetic data under
           runs/eval_fluid_synth/; every metric finite, each EMD a full
           permutation, each sample's launches equal to EVAL_SAMPLE /
           EVAL_SAMPLE_AGREEMENT; seconds per sample, seconds and rounds
           of each auction;
  eval_approx with the launch counts reset: one eval CLI sample with
           --approx_graph --agreement_vs_exact at --patch_size 32768 (4,096
           inputs, the first size whose graphs reach the approximate
           kernel) on a 40,000-particle synthetic dataset under
           runs/eval_fluid_synth_approx/, --emd_iters cut to
           EVAL_APPROX_EMD_ITERS; launches against EVAL_APPROX_SAMPLE,
           every metric finite, the Chamfer against the exact twin under
           GATE, the switch off again after the call;
  density  with the launch counts reset: the trained SRNet on a whole
           12,000-particle frame (96,000 slots), the exact density of its
           kept points and of a 32^3 grid over it (the cell-grid kernel,
           cutoff 0.05), the capped k = 64 density of a 9,216-point ground
           truth (against the kNN's plain version); launches against
           DENSITY_LAUNCHES; then the binned kernel against its plain
           version and the dense interp kernel at both shapes, with the
           pairs within the cutoff (the bound's work) and those its 27
           cells hold (the walk's), its time, its bound and the dense
           kernel's time;
  eval_cpu position_metrics, cycle_consistency and the exact density on
           fixed small clouds, on the card and on the CPU.
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
ROLLOUT_BUCKET = 10112    # the frames' rows (rounded up to ALIGN = 128)
GATE = 5e-3               # normalised Chamfer gate, as in bench.py

# H100 SXM published peaks (dense): HBM bytes/s and the rates by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}

REPS = 10

DATA_DIR = os.path.join(ROOT, "runs", "chip_smoke_fluid")   # gitignored
TRAIN_STEPS = 4

# Launches per train step, read off tpugan_tpu_torch/train/step.py (the
# wrappers count one per call):
#   every step: device sampling's FPS; the generator's 7 kNN graphs (one
#     [3B] batch); the Chamfer's 2 nn1 and the masking target's 1;
#   gate open: the spatial critic's 3 FPS, 3 ball queries and 4 pooled-MLP
#     forwards (one per SetConv) and their 4 backwards (the gradient to the
#     generator); the dense interp; the temporal critic's 2 stacked FPS,
#     6 ball queries (sa1 and sa2 per frame) and 3 flow kNN;
#   critic update (even iteration, gate open): the temporal critic twice
#     (fake, real) and the spatial critic twice, with their backwards.
STEP_ALWAYS = {"fps": 1, "knn": 7, "nn1": 3}
STEP_GATE = {"fps": 5, "ball_query": 9, "pooled_mlp_fwd": 4,
             "pooled_mlp_bwd": 4, "interp": 1, "knn": 3}
STEP_CRITICS = {"fps": 10, "ball_query": 18, "pooled_mlp_fwd": 8,
                "pooled_mlp_bwd": 8, "knn": 6}


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


def device_ms(fn, torch, reps=REPS, by_kernel=False, tries=3):
    """Device time of the kernels ``fn`` launches, per call (torch.profiler,
    after a warm-up): what the card spends, without the host's launch
    overhead that ``time_ms`` includes where the host is the slower side.
    ``by_kernel``: also the time per call of each kernel, by name (the
    demangled name up to its argument list). A profile that lost kernel
    records (a kernel counted other than a multiple of ``reps`` times, or
    none at all, as happens now and then on the card) is taken again, up
    to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events and all(e.count % reps == 0 for e in events):
            break
    names = {}
    for e in events:
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(", 1)[0] or name
        names[name] = names.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    total = sum(names.values())
    return (total, names) if by_kernel else total


def bound(flops: float, nbytes: float, kind: str):
    """(least time in ms, "bytes" or "operations") on the published peaks."""
    t_ops = flops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(name: str, function: str = "") -> dict:
    """Registers and spills of ``csrc/<name>.cu``'s kernels (only those whose
    mangled name holds ``function``, when given)."""
    from tpugan_tpu_torch import _build

    text = _build.ptxas_report(name)
    if function:
        parts = text.split("Compiling entry function")
        text = "".join(p for p in parts[1:] if function in p.split("\n", 1)[0])
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return {"functions": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


# ---------------------------------------------------------------- phase 2

# (path, B, Nq, Nc, D, k, self graph, launches per serving forward, per
# G+D train step, per eval sample, per density phase)
KNN_SHAPES = [
    # the f32 dynamic serving forward of one 10,240-point frame
    ("serving", 1, N_POINTS, N_POINTS, 3, 20, True, 1, 0, 0, 0),  # EdgeConv_0
    ("serving", 1, N_POINTS, N_POINTS, 32, 20, True, 2, 0, 0, 0),  # IDGCN
    ("serving", 1, N_POINTS, N_POINTS, 64, 12, True, 2, 0, 0, 0),  # up / mask
    ("serving", 1, N_POINTS, N_POINTS, 64, 4, True, 1, 0, 0, 0),   # upsampler
    ("serving", 1, N_POINTS, N_POINTS, 64, 8, True, 1, 0, 0, 0),   # mask head
    # the train step: the generator's graphs over its [3B] = 12 rows of
    # 1,152 inputs, and the temporal critic's flow embeddings (k = 32 from
    # one frame's 256 sa2 centres to the next frame's; 3 per critic call)
    ("train", 12, 1152, 1152, 3, 20, True, 0, 1, 0, 0),
    ("train", 12, 1152, 1152, 32, 20, True, 0, 2, 0, 0),
    ("train", 12, 1152, 1152, 64, 12, True, 0, 2, 0, 0),
    ("train", 12, 1152, 1152, 64, 4, True, 0, 1, 0, 0),
    ("train", 12, 1152, 1152, 64, 8, True, 0, 1, 0, 0),
    ("train", 4, 256, 256, 3, 32, False, 0, 9, 0, 0),
    # eval: the capped interpolation's k = 32 radius kNN from the 9,216
    # predicted points to the 9,216-point ground truth; the capped
    # density's k = 64 over a 9,216-point patch
    ("eval", 1, 9216, 9216, 3, 32, False, 0, 0, 1, 0),
    ("density", 1, 9216, 9216, 3, 64, True, 0, 0, 0, 1),
]

EDGECONV_SHAPES = [  # (name, C, H, O, K, aggregate, mlp, launches per forward)
    ("EdgeConv_0", 6, 64, 128, 20, "max", True, 1),
    ("IDGCN d=1", 32, 16, 32, 20, "max", True, 2),
    ("IDGCN d=2", 32, 16, 32, 10, "max", True, 2),
    ("up/mask k=12", 64, 128, 256, 12, "max", True, 2),
    ("up k=4", 64, 128, 256, 4, "max", True, 1),
    ("mask k=8 sum", 64, 128, 128, 8, "sum", False, 1),
]
# bf16 static forward launches of the tensor-core EdgeConv kernel: the
# (64, 128, 256) SharedMLP class, "up/mask k=12" twice and "up k=4" once
TC_PER_BF16_FORWARD = 3
# f32 dynamic forward launches of the f32 register-tiled EdgeConv kernel:
# every shape class above
F32T_PER_F32_FORWARD = 9


def exact_sqdist(q, c, bi, qi, ci):
    """float64 |q[b, i] - c[b, j]|^2 for index arrays (numpy)."""
    return np.sum((q[bi, qi].astype(np.float64)
                   - c[bi, ci].astype(np.float64)) ** 2, -1)


def index_gaps(q_np, c_np, ik, ip):
    """(mismatches, largest exact-distance gap between the two sides'
    choices where their indices differ) of [B, Nq(, k)] index tensors."""
    ik_np, ip_np = ik.cpu().numpy(), ip.cpu().numpy()
    diff = np.nonzero(ik_np != ip_np)
    gap = np.abs(exact_sqdist(q_np, c_np, diff[0], diff[1], ik_np[diff])
                 - exact_sqdist(q_np, c_np, diff[0], diff[1], ip_np[diff]))
    return int(gap.size), float(gap.max()) if gap.size else 0.0


def tie_grid(torch, dev):
    """[1, 10,240, 3]: a 16 x 16 x 20 integer grid, every point twice, so
    every distance is exact in f32 and each neighbour has a twin."""
    g = np.stack(np.meshgrid(np.arange(16.0), np.arange(16.0), np.arange(20.0),
                             indexing="ij"), -1).reshape(-1, 3)
    return torch.from_numpy(np.concatenate([g, g])[None].astype(np.float32)).to(dev)


def check_knn(torch, dev, rng):
    """Every kNN graph shape of the serving forward and of the train step
    (the step's graphs are rows of one launch each). Distances to 1e-5 of
    2 max |q|^2 (the f32 error of max(|q|^2 + |c|^2 - 2 q.c, 0)); an index
    may differ only where the two candidates' exact distances tie within
    twice that."""
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows = []
    for (path, b, nq, nc, d, k, own, per_fwd, per_step, per_sample,
         per_density) in KNN_SHAPES:
        scale = 0.3 if d == 3 else 1.0
        q_np = (rng.standard_normal((b, nq, d)) * scale).astype(np.float32)
        c_np = q_np if own else (rng.standard_normal((b, nc, d)) * scale
                                 ).astype(np.float32)
        q, c = torch.from_numpy(q_np).to(dev), torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((b, nc), device=dev)
        d2k, ik = K.knn_kernel(q, c, bias, k)
        d2p, ip = K.knn_plain(q, c, bias, k)
        torch.cuda.synchronize()
        tol = 1e-5 * 2 * float(max((q * q).sum(-1).max(), (c * c).sum(-1).max()))
        err = float((d2k - d2p).abs().max())
        bad, gap = index_gaps(q_np, c_np, ik, ip)
        if not (err <= tol and gap <= 2 * tol):
            raise AssertionError(f"knn {path} B={b} N={nq} D={d} k={k}: err "
                                 f"{err} tol {tol}, index gaps up to {gap}")
        ms = time_ms(lambda: K.knn_kernel(q, c, bias, k), torch)
        plain_ms = time_ms(lambda: K.knn_plain(q, c, bias, k), torch)
        lib_ms = time_ms(lambda: torch.topk(torch.cdist(q, c), k, largest=False),
                         torch)
        flops = b * nq * nc * (2 * d + 3)
        nbytes = 4 * b * (nq * d + nc * d + nc) + b * nq * k * 12
        b_ms, b_by = bound(flops, nbytes, "f32")
        rows.append(dict(path=path, B=b, Nq=nq, Nc=nc, D=d, k=k,
                         per_forward=per_fwd, per_step=per_step,
                         per_sample=per_sample, per_density=per_density,
                         max_abs_err=err, tol=tol, index_mismatch=bad,
                         max_tie_gap=gap, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "knn", **rows[-1]})

    # exact ties at serving width: 5,120 integer grid points, each twice, so
    # every distance is exact in f32 and each neighbour has a twin; the
    # kernel must give the plain version's (stable argsort's) lists exactly
    pts = tie_grid(torch, dev)
    bias = torch.zeros((1, N_POINTS), device=dev)
    d2k, ik = K.knn_kernel(pts, pts, bias, 20)
    d2p, ip = K.knn_plain(pts, pts, bias, 20)
    torch.cuda.synchronize()
    bad = int((ik != ip).sum())
    emit({"phase": "kernel", "kernel": "knn", "case": "exact ties", "B": 1,
          "Nq": N_POINTS, "Nc": N_POINTS, "D": 3, "k": 20,
          "max_abs_err": float((d2k - d2p).abs().max()), "index_mismatch": bad})
    if bad or not torch.equal(d2k, d2p):
        raise AssertionError(f"knn exact ties: {bad} indices differ from the "
                             "plain version's")
    return rows


# (graph, Nq = Nc, D, k, sentinel rows, launches per f32 dynamic forward,
# per bf16 static forward, per rollout frame) of the approximate kernel
# with the switch on. The rollout's graphs carry no valid mask: its padding
# rows sit at the 999 sentinel with bias 0, as real candidates far away.
APPROX_SHAPES = [
    ("EdgeConv_0 / static graph", N_POINTS, 3, 20, 0, 1, 1, 0),
    ("IDGCN", N_POINTS, 32, 20, 0, 2, 0, 0),
    ("up/mask k=12", N_POINTS, 64, 12, 0, 2, 0, 0),
    ("up k=4", N_POINTS, 64, 4, 0, 1, 0, 0),
    ("mask k=8", N_POINTS, 64, 8, 0, 1, 0, 0),
    ("rollout frame", ROLLOUT_BUCKET, 3, 20, ROLLOUT_BUCKET - ROLLOUT_POINTS,
     0, 0, 1),
]


def _set_overlap(a, b):
    """(share of rows whose index sets differ, mean share of b's entries
    missing from a's row) of [B, Nq, k] index tensors."""
    hit = (a[..., :, None] == b[..., None, :]).any(-2)   # b's entries in a
    return (float((~hit.all(-1)).float().mean()),
            float((~hit).float().mean()))


def check_knn_approx(torch, dev, rng):
    """The approximate kNN kernel at every approximate serving shape against
    its plain version (``knn.approx_agreement`` over the real rows: d2
    within half a bf16 ulp plus 1e-5 of 2 max |q|^2 of the float64 value,
    differing lists only where a distance rounds to bf16 within that of a
    boundary, at most 2% of the queries; the sentinel rows bit for bit),
    with its recall against the exact kernel; then the grid (bit for bit)
    and the dropped-neighbour case."""
    from tpugan_tpu_torch import PAD_SENTINEL
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows = []
    for (graph, n, d, k, pad, per_fwd, per_static,
         per_frame) in APPROX_SHAPES:
        scale = 0.3 if d == 3 else 1.0
        c_np = (rng.standard_normal((1, n, d)) * scale).astype(np.float32)
        c_np[:, n - pad:] = PAD_SENTINEL
        c = torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((1, n), device=dev)
        got = K.knn_approx_kernel(c, c, bias, k)
        want = K.knn_approx_plain(c, c, bias, k)
        exact = K.knn_kernel(c, c, bias, k)
        torch.cuda.synchronize()
        # the real rows pick real neighbours only, so their tolerance takes
        # the real points' norms; the sentinel rows tie at d2 = 0 exactly
        real = n - pad
        if pad and not (int(got[1][:, :real].max()) < real
                        and torch.equal(got[0][:, real:], want[0][:, real:])
                        and torch.equal(got[1][:, real:], want[1][:, real:])):
            raise AssertionError(f"knn approx {graph}: the sentinel rows")
        agree = K.approx_agreement(
            (got[0][:, :real], got[1][:, :real]),
            (want[0][:, :real], want[1][:, :real]),
            (c[:, :real], c[:, :real], bias[:, :real]))
        if not (agree["d2_excess"] <= 0 and agree["d2_unexplained"] == 0
                and agree["rows_unexplained"] == 0
                and agree["rows"] <= 0.02 * agree["queries"]):
            raise AssertionError(f"knn approx {graph} D={d} k={k}: {agree}")
        differ, missing = _set_overlap(got[1][:, :real], exact[1][:, :real])
        # queries whose exact top-k holds more than kp members of one lane
        # column: the mode's own losses, before any bf16 rank flip
        per_col = torch.zeros((1, real, K.LANES), device=dev).scatter_add_(
            -1, exact[1][:, :real] % K.LANES,
            torch.ones_like(exact[0][:, :real]))
        crowded = float((per_col.amax(-1) > K.chunk_kp_approx(k)).float().mean())
        ms = time_ms(lambda: K.knn_approx_kernel(c, c, bias, k), torch)
        exact_ms = time_ms(lambda: K.knn_kernel(c, c, bias, k), torch)
        plain_ms = time_ms(lambda: K.knn_approx_plain(c, c, bias, k), torch)
        lib_ms = time_ms(lambda: torch.topk(torch.cdist(c, c), k, largest=False),
                         torch)
        # the cross term's 2 D products a pair are of bf16 operands (the
        # tensor cores' type), the norms' sum and clamp 3 f32 operations
        t_ops = (2 * d * n * n / PEAK_OPS["bf16"]
                 + 3 * n * n / PEAK_OPS["f32"]) * 1e3
        t_bytes = (4 * (2 * n * d + n) + n * k * 12) / PEAK_BYTES * 1e3
        b_ms, b_by = max((t_ops, "operations"), (t_bytes, "bytes"))
        rows.append(dict(graph=graph, B=1, Nq=n, Nc=n, D=d, k=k,
                         kp=K.chunk_kp_approx(k), sentinel_rows=pad,
                         per_forward=per_fwd, per_static=per_static,
                         per_frame=per_frame,
                         max_abs_err=float((got[0] - want[0]).abs().max()),
                         index_mismatch=int((got[1] != want[1]).sum()),
                         **agree, rows_set_differs_vs_exact=differ,
                         neighbours_missing_vs_exact=missing,
                         rows_column_crowded=crowded, ms=ms,
                         exact_ms=exact_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "knn_approx", **rows[-1]})

    # exact inputs: the duplicated grid of check_knn, bit for bit
    pts = tie_grid(torch, dev)
    bias = torch.zeros((1, N_POINTS), device=dev)
    got = K.knn_approx_kernel(pts, pts, bias, 20)
    want = K.knn_approx_plain(pts, pts, bias, 20)
    torch.cuda.synchronize()
    bad = int((got[1] != want[1]).sum())
    emit({"phase": "kernel", "kernel": "knn_approx", "case": "exact ties",
          "Nq": N_POINTS, "Nc": N_POINTS, "D": 3, "k": 20,
          "max_abs_err": float((got[0] - want[0]).abs().max()),
          "index_mismatch": bad})
    if bad or not torch.equal(got[0], want[0]):
        raise AssertionError(f"knn approx exact ties: {bad} indices differ")

    # a query at the origin whose 4 nearest candidates are 5, 133 and 261
    # (lane column 5) and 7, the rest 2-3 away: k = 4 keeps 2 keys a column,
    # so 261 is dropped on both sides; the exact kernel keeps it
    drng = np.random.default_rng(3)
    dirs = drng.standard_normal((4096, 3))
    cand = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * drng.uniform(
        2.0, 3.0, (4096, 1))
    for i, r in ((5, 0.125), (133, 0.25), (261, 0.375), (7, 0.5)):
        cand[i] = (r, 0.0, 0.0)
    c = torch.from_numpy(cand[None].astype(np.float32)).to(dev)
    q = torch.zeros((1, 1, 3), device=dev)
    bias = torch.zeros((1, 4096), device=dev)
    got = K.knn_approx_kernel(q, c, bias, 4)
    want = K.knn_approx_plain(q, c, bias, 4)
    exact = K.knn_kernel(q, c, bias, 4)
    torch.cuda.synchronize()
    emit({"phase": "kernel", "kernel": "knn_approx", "case": "dropped neighbour",
          "approx_idx": got[1][0, 0].tolist(), "plain_idx": want[1][0, 0].tolist(),
          "exact_idx": exact[1][0, 0].tolist()})
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[1][0, 0].tolist()[:3] == [5, 133, 7]
            and exact[1][0, 0].tolist() == [5, 133, 261, 7]):
        raise AssertionError("knn approx dropped-neighbour case")
    return rows


def check_edgeconv(torch, dev, rng):
    """Each EdgeConv shape class of the serving forward in f32 and bf16; the
    bf16 (64, 128, 256) SharedMLP class must launch the tensor-core kernel
    (variant "tc") once, an f32 class of ``F32_TILED_CLASSES`` the f32
    register-tiled kernel ("f32t") once, every other row the general
    kernel ("simt"). Then exact inputs at those classes and serving width,
    bit for bit."""
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
            variant = ("tc" if E.takes_tensor_cores(cdt, mlp, c, h, o) else
                       "f32t" if E.takes_f32_tiled(cdt, mlp, c, h, o) else
                       "simt")
            tc0, f0 = E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
            out_k = E.edgeconv_fused(*args).float()
            got = (E.TC_LAUNCHES - tc0, E.F32_TILED_LAUNCHES - f0)
            if got != (int(variant == "tc"), int(variant == "f32t")):
                raise AssertionError(f"edgeconv {name} {kind}: (tensor-core, "
                                     f"f32t) launches {got}, variant {variant}")
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
            dev_ms = device_ms(lambda: E.edgeconv_fused(*args), torch)
            plain_ms = time_ms(lambda: E.edgeconv_plain(*args), torch)
            esz = 4 if kind == "f32" else 2
            flops = 2 * N_POINTS * k * (2 * c * h + ((h * h + h * o) if mlp else 0))
            nbytes = esz * (k * N_POINTS * c + N_POINTS * c + 2 * c * h
                            + ((h * h + h * o) if mlp else 0) + N_POINTS * o)
            b_ms, b_by = bound(flops, nbytes, kind)
            rows.append(dict(config=name, dtype=kind, variant=variant, C=c,
                             H=h, O=o, K=k, aggregate=agg, per_forward=per_fwd,
                             max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by))
            emit({"phase": "kernel", "kernel": "edgeconv", **rows[-1]})
    check_edgeconv_exact(torch, dev)
    return rows


def check_edgeconv_exact(torch, dev, k=12):
    """The tensor-core class (bf16) and each class of the f32 register-tiled
    kernel (f32) at serving width on exact inputs: ctr = 0 and sparse
    {0, 1} neighbours and weights, so leaky ReLU is the identity and every
    product and sum is an integer, exact in f32 in any order; planes 1 and
    3 repeat planes 0 and 2 (max and min tie). Every aggregate must equal
    the plain version bit for bit and launch its kernel once. Its own
    generator keeps the other checks' data as it was."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    gen = np.random.default_rng(8)
    bits = lambda p, *s: torch.from_numpy(
        (gen.random(s) < p).astype(np.float32)).to(dev)
    classes = [("tc", torch.bfloat16, (True, *E.TC_WIDTHS))]
    classes += [("f32t", torch.float32, cls)
                for cls in sorted(E.F32_TILED_CLASSES, reverse=True)]
    for variant, cdt, (mlp, c, h, o) in classes:
        nbr = bits(0.5, 1, k, N_POINTS, c)
        nbr[:, 1], nbr[:, 3] = nbr[:, 0], nbr[:, 2]
        args = (nbr.to(cdt), torch.zeros(1, N_POINTS, c, device=dev).to(cdt),
                bits(0.03, c, h), bits(0.03, c, h),
                bits(0.03, h, h) if mlp else None,
                bits(0.03, h, o) if mlp else None)
        for agg in E.AGGREGATES:
            counter = "TC_LAUNCHES" if variant == "tc" else "F32_TILED_LAUNCHES"
            n0 = getattr(E, counter)
            out_k = E.edgeconv_fused(*args, agg, cdt)
            out_p = E.edgeconv_plain(*args, agg, cdt)
            torch.cuda.synchronize()
            launched = getattr(E, counter) - n0
            bad = int((out_k != out_p).sum())
            emit({"phase": "kernel", "kernel": "edgeconv", "case": "exact",
                  "variant": variant, "dtype": str(cdt).split(".")[-1],
                  "C": c, "H": h, "O": o, "mlp": mlp, "K": k, "N": N_POINTS,
                  "aggregate": agg, "launches": launched,
                  "max_abs_err": float((out_k.float() - out_p.float()).abs().max()),
                  "mismatches": bad, "output_max": float(out_p.float().max())})
            if bad or launched != 1:
                raise AssertionError(f"edgeconv exact {variant} ({c}, {h}, {o}) "
                                     f"{agg}: {bad} outputs differ from the "
                                     f"plain version's, {launched} launches")


# (path, B, Nq, M, masked candidate tail, sentinel query tail, launches per
# Chamfer gate, per train step, per eval sample)
NN1_SHAPES = [
    # the serving gate: both directions between two 81,920-point outputs
    ("serving", 1, N_POINTS * 8, N_POINTS * 8, 4096, 0, 2, 0, 0),
    # the train step: its Chamfer (both directions between the centre
    # frame's ground truth and prediction; the step passes no masks) and
    # the masking target (inputs to their nearest ground-truth point)
    ("train", 4, 9216, 9216, 0, 0, 0, 2, 0),
    ("train", 4, 1152, 9216, 0, 0, 0, 1, 0),
    # eval: position_metrics' Chamfer between the kept prediction, padded
    # to a 1,024 bucket with 999-sentinel rows and a mask, and the 9,216
    # ground-truth points (both directions); cycle_consistency's between
    # two 9,216-point predictions (both directions, no masks)
    ("eval", 1, 9216, 9216, 0, 1024, 0, 0, 1),
    ("eval", 1, 9216, 9216, 1024, 0, 0, 0, 1),
    ("eval", 1, 9216, 9216, 0, 0, 0, 0, 2),
]


def check_nn1(torch, dev, rng):
    """Distances and the tie rule as in :func:`check_knn` over the live
    queries; no index may point into a masked tail. Sentinel queries (the
    999 rows of a padded prediction) are held to 1e-5 of their distance."""
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    rows = []
    for (path, b, nq, m, masked, q_tail, per_gate, per_step,
         per_sample) in NN1_SHAPES:
        q_np = (rng.standard_normal((b, nq, 3)) * 0.3).astype(np.float32)
        c_np = (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32)
        live = nq - q_tail
        q_np[:, live:] = 999.0
        q, c = torch.from_numpy(q_np).to(dev), torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((b, m), device=dev)
        if masked:
            bias[:, -masked:] = 1e10
        d2k, ik = N1.nn1_kernel(q, c, bias)
        d2p, ip = N1.nn1_plain(q, c, bias)
        torch.cuda.synchronize()
        tol = 1e-5 * 2 * float(max((q[:, :live] ** 2).sum(-1).max(),
                                   (c * c).sum(-1).max()))
        err = float((d2k - d2p)[:, :live].abs().max())
        bad, gap = index_gaps(q_np[:, :live], c_np, ik[:, :live], ip[:, :live])
        tail_rel = (float(((d2k - d2p)[:, live:].abs() / d2p[:, live:]).max())
                    if q_tail else 0.0)
        if not (err <= tol and gap <= 2 * tol and tail_rel <= 1e-5
                and int(ik.max()) < m - masked):
            raise AssertionError(f"nn1 {path} B={b} Nq={nq} M={m}: err {err} "
                                 f"tol {tol}, index gaps up to {gap}, "
                                 f"sentinel rows {tail_rel}")
        ms = time_ms(lambda: N1.nn1_kernel(q, c, bias), torch)
        plain_ms = time_ms(lambda: N1.nn1_plain(q, c, bias), torch)

        def yardstick():
            for s in range(0, nq, 8192):
                torch.cdist(q[:, s:s + 8192], c).min(-1)

        lib_ms = time_ms(yardstick, torch)
        b_ms, b_by = bound(9.0 * b * nq * m,
                           4 * b * (3 * nq + 3 * m + m) + 12 * b * nq, "f32")
        rows.append(dict(path=path, B=b, Nq=nq, M=m, masked=masked,
                         sentinel_queries=q_tail, per_gate=per_gate,
                         per_step=per_step, per_sample=per_sample,
                         max_abs_err=err, tol=tol, index_mismatch=bad,
                         max_tie_gap=gap, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "nn1", **rows[-1]})
    return rows


# ---------------------------------------------------------- phases 3 and 4

def counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def delta(before, after) -> dict:
    return {n: after[n] - before[n] for n in after}


def expect(got: dict, want: dict, what: str) -> None:
    """``got`` must hold ``want``'s counts and 0 for every other kernel."""
    full = {n: want.get(n, 0) for n in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, expected {full}")


def serving(torch, dev, kernels):
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.ops.metrics import chamfer

    f32 = load_srnet(CHECKPOINT, device=dev)
    bf16 = load_srnet(CHECKPOINT, device=dev, compute_dtype=torch.bfloat16,
                      graph_mode="static")
    r = f32.upsample_ratio
    rng = np.random.default_rng(0)
    pos_np = rng.standard_normal((1, N_POINTS, 3)).astype(np.float32) * 0.3
    pos = torch.from_numpy(pos_np).to(dev)
    feat = torch.cat([pos, torch.zeros_like(pos)], -1)    # zero velocity

    c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    exp_f32, mask_f32, _, valid_f32 = f32(feat, pos)
    torch.cuda.synchronize()
    c1, tc1, ft1 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    expect(delta(c0, c1), {"knn": 7, "edgeconv": 9, "nn1": 0},
           "f32 dynamic forward")
    exp_bf16, _, _, valid_bf16 = bf16(feat, pos)
    torch.cuda.synchronize()
    c2, tc2, ft2 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    expect(delta(c1, c2), {"knn": 1, "edgeconv": 9, "nn1": 0},
           "bf16 static forward")
    # of the EdgeConv launches, those of the tensor-core kernel
    if (tc1 - tc0, tc2 - tc1) != (0, TC_PER_BF16_FORWARD):
        raise AssertionError(f"tensor-core EdgeConv launches: f32 dynamic "
                             f"{tc1 - tc0}, bf16 static {tc2 - tc1}; expected "
                             f"0 and {TC_PER_BF16_FORWARD}")
    # and those of the f32 register-tiled kernel
    if (ft1 - ft0, ft2 - ft1) != (F32T_PER_F32_FORWARD, 0):
        raise AssertionError(f"f32t EdgeConv launches: f32 dynamic "
                             f"{ft1 - ft0}, bf16 static {ft2 - ft1}; expected "
                             f"{F32T_PER_F32_FORWARD} and 0")
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
                       "gate": {"nn1": 2}},
          "tc_launches": {"f32_dynamic": tc1 - tc0, "bf16_static": tc2 - tc1},
          "f32t_launches": {"f32_dynamic": ft1 - ft0,
                            "bf16_static": ft2 - ft1}})
    return (f32, bf16), (feat, pos, pos_np)


class GraphReplay:
    """Runs one forward (or step) recording every kNN graph it builds, then
    another (the CPU's, or the card's other path) with those graphs
    replayed in order. Each replayed list is first held against the second
    run's own kNN of its own features: they may differ only between
    candidates whose exact distances tie within f32 noise (the two runs
    round |q|^2 + |c|^2 - 2 q.c, or their features, differently, and under
    the IDGCN's ::2 dilation one such swap changes a point's features and
    then its neighbours'). With equal graphs the outputs must agree to f32
    noise."""

    def __init__(self, torch):
        import tpugan_tpu_torch.models.generator as generator
        import tpugan_tpu_torch.nn.edgeconv as edgeconv

        self.torch, self.modules = torch, (generator, edgeconv)
        self.own = generator.graph_knn
        self.lists, self.swaps = [], 0

    def _run(self, knn_fn, call, *args):
        for m in self.modules:
            m.graph_knn = knn_fn
        try:
            return call(*args)
        finally:
            for m in self.modules:
                m.graph_knn = self.own

    def record(self, call, *args):
        """``call(*args)`` (a forward or a train step), recording."""
        def recording(x, k, c_valid=None):
            d2, idx = self.own(x, k, c_valid)
            self.lists.append(idx.cpu())
            return d2, idx
        return self._run(recording, call, *args)

    def replay(self, call, *args):
        def replaying(x, k, c_valid=None):
            d2, own = self.own(x, k, c_valid)
            rec = self.lists.pop(0).to(own.device)
            xf = x.detach().double()
            b, r, s = (rec != own).nonzero(as_tuple=True)
            exact = lambda idx: ((xf[b, r] - xf[b, idx[b, r, s]]) ** 2).sum(-1)
            tol = 1e-5 * 2 * float((xf * xf).sum(-1).max())
            gap = (exact(rec) - exact(own)).abs()
            if gap.numel() and float(gap.max()) > tol:
                raise AssertionError(f"kNN differs beyond f32 noise: {gap.max()}")
            self.swaps += int(gap.numel())
            return d2, rec
        return self._run(replaying, call, *args)


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


def rollout_frames(torch, model):
    """25 frames chained as the JAX bench chains them (frame t+1 is the
    first 10,000 expanded points of frame t's forward, times 0.999), with
    zero velocity; frame t keeps 10,000 - 8 * (t % 4) of them, so the
    frames are ragged within one bucket."""
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
    return frames


def rollout(torch, model, kernels, approx=False):
    """``rollout_sequence`` over ``rollout_frames``, with the approximate
    graph kNN on when ``approx`` (one approximate launch a frame)."""
    from tpugan_tpu_torch.eval.rollout import rollout_sequence
    from tpugan_tpu_torch.ops import neighbors
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    frames = rollout_frames(torch, model)
    c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    neighbors.set_approx_graph_knn(approx)
    try:
        outs = rollout_sequence(model, frames, use_vel=True)
    finally:
        neighbors.set_approx_graph_knn(False)
    wall = time.perf_counter() - t0
    got = delta(c0, counts(kernels))
    want = {"knn_approx" if approx else "knn": ROLLOUT_FRAMES,
            "edgeconv": 9 * ROLLOUT_FRAMES}
    expect(got, want, "rollout" + (" (approximate graphs)" if approx else ""))
    tc, ft = E.TC_LAUNCHES - tc0, E.F32_TILED_LAUNCHES - ft0
    if (tc, ft) != (TC_PER_BF16_FORWARD * ROLLOUT_FRAMES, 0):
        raise AssertionError(f"rollout: {tc} tensor-core and {ft} f32t EdgeConv "
                             f"launches, expected "
                             f"{TC_PER_BF16_FORWARD * ROLLOUT_FRAMES} and 0")
    if len(outs) != ROLLOUT_FRAMES:
        raise AssertionError(f"rollout returned {len(outs)} frames")
    sizes = []
    for (p, _), o in zip(frames, outs):
        n = p.shape[0]
        if not (np.isfinite(o).all() and n <= o.shape[0] <= n * model.upsample_ratio
                and np.abs(o).max() < 100):
            raise AssertionError(f"rollout frame of {n}: {o.shape[0]} points")
        sizes.append(int(o.shape[0]))
    emit({"phase": "rollout", "approx_graph": approx, "frames": ROLLOUT_FRAMES,
          "points": [int(f[0].shape[0]) for f in frames[:4]],
          "output_points_first_last": [sizes[0], sizes[-1]],
          "launches": got, "tc_launches": tc, "f32t_launches": ft,
          "wall_ms_per_frame": wall * 1e3 / ROLLOUT_FRAMES})


def serving_approx(torch, models, feat, pos, kernels):
    """With the counts reset by the caller: the exact f32 dynamic forward,
    then the f32 dynamic and the bf16 static forward with the approximate
    graph kNN on, each against the exact one (normalised Chamfer under
    GATE, keep-mask agreement). Returns the phase's line (ms per frame are
    added past the counted run, by ``approx_ms``)."""
    from tpugan_tpu_torch.ops import neighbors
    from tpugan_tpu_torch.ops.metrics import chamfer

    f32, bf16 = models
    c0 = counts(kernels)
    exp_e, _, _, valid_e = f32(feat, pos)
    torch.cuda.synchronize()
    expect(delta(c0, counts(kernels)), {"knn": 7, "edgeconv": 9},
           "exact f32 dynamic forward")
    scale = float((pos ** 2).sum(-1).mean())
    out = {"phase": "serving_approx", "points": N_POINTS, "gate": GATE}
    for name, model, want in (
            ("f32_dynamic", f32, {"knn_approx": 7, "edgeconv": 9}),
            ("bf16_static", bf16, {"knn_approx": 1, "edgeconv": 9})):
        c0 = counts(kernels)
        neighbors.set_approx_graph_knn(True)
        try:
            exp_a, _, _, valid_a = model(feat, pos)
        finally:
            neighbors.set_approx_graph_knn(False)
        torch.cuda.synchronize()
        got = delta(c0, counts(kernels))
        expect(got, want, f"approximate {name} forward")
        cd = float(chamfer(exp_e, exp_a).mean()) / (exp_e.shape[1] * scale)
        out[name] = {"launches": got, "chamfer_norm_vs_exact": cd,
                     "keep_mask_agreement_vs_exact":
                         float((valid_a == valid_e).float().mean()),
                     "valid": int(valid_a.sum())}
        if not (cd < GATE and bool(torch.isfinite(exp_a).all())):
            raise AssertionError(f"approximate {name}: {out[name]}")
    return out


def approx_ms(torch, model, feat, pos) -> float:
    """ms per frame of a forward with the approximate graph kNN on."""
    from tpugan_tpu_torch.ops import neighbors

    neighbors.set_approx_graph_knn(True)
    try:
        return time_ms(lambda: model(feat, pos), torch)
    finally:
        neighbors.set_approx_graph_knn(False)


# ------------------------------------------------- train-step kernel checks

FPS_SHAPES = [   # (stage, rows, N, m, masked, launches per G+D step)
    ("device sampling", 4, 9216, 1152, False, 1),
    ("spatial sa_0", 4, 9216, 1024, True, 3),
    ("spatial sa_1", 4, 1024, 512, False, 3),
    ("spatial sa_2", 4, 512, 128, False, 3),
    ("tempo sa1 (3 frames stacked)", 12, 9216, 1024, True, 3),
    ("tempo sa2 (3 frames stacked)", 12, 1024, 256, False, 3),
]

BALL_SHAPES = [  # (stage, B, Nq, Nc, radius, nsample, launches per G+D step)
    ("spatial sa_0", 4, 1024, 9216, 0.15, 32, 3),
    ("spatial sa_1", 4, 512, 1024, 0.30, 32, 3),
    ("spatial sa_2", 4, 128, 512, 0.60, 16, 3),
    ("tempo sa1 (per frame)", 4, 1024, 9216, 0.10, 32, 9),
    ("tempo sa2 (per frame)", 4, 256, 1024, 0.20, 32, 9),
]

POOLED_SHAPES = [  # (stage, (B, M, ns, C0), widths, slope, per G+D step,
    #                  gammas: "positive" around 1, "mixed" of both signs and 0)
    ("spatial sa_0", (4, 1024, 32, 6), (64, 128), 0.01, 3, "positive"),
    ("spatial sa_1", (4, 512, 32, 131), (128, 128), 0.01, 3, "positive"),
    ("spatial sa_2", (4, 128, 16, 131), (128, 256), 0.01, 3, "positive"),
    ("spatial sa_pooling", (4, 1, 128, 259), (256, 256), 0.0, 3, "positive"),
    # a trained critic may hold gammas <= 0: the max then comes from the
    # min of z (the kernels pool from each neighbourhood's extremes)
    ("spatial sa_1 mixed-sign gamma", (4, 512, 32, 131), (128, 128), 0.01, 0,
     "mixed"),
]


def _cloud(torch, dev, rng, *shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


# Rows on which the selections tie or run out of valid points, at the
# variants' widths (none runs in the train step): (stage, rows, N, m,
# points: "lattice" at multiples of 0.25, exact distances and ties; or the
# count of valid points, the rest at -1e10 and far away)
FPS_EDGE_SHAPES = [
    ("ties: lattice, cluster", 4, 9216, 1024, "lattice"),
    ("ties: lattice, one block", 12, 1024, 256, "lattice"),
    ("ties: lattice, one warp", 4, 512, 128, "lattice"),
    ("exhausted: 700 valid, cluster", 4, 9216, 1024, 700),
    ("exhausted: 100 valid, one block", 4, 1024, 256, 100),
    ("exhausted: 60 valid, one warp", 4, 512, 128, 60),
]
# The round's fixed cost: rows of one point a thread, FPS_FLOOR_ROUNDS
# rounds, on one warp and on clusters of each size of 128-thread blocks.
FPS_FLOOR_ROUNDS = 1024
FPS_FLOOR_CLUSTERS = (1, 2, 4, 8, 16)


def _fps_case(torch, dev, rng, b, n, masked):
    """(pos, penalty, start) of an FPS stage: a cloud, with a hard-masked
    tail as the critics see (``masked`` True), the lattice (``masked``
    "lattice") or all but ``masked`` points invalid (an int)."""
    pos = _cloud(torch, dev, rng, b, n, 3)
    pen = torch.zeros((b, n), device=dev)
    n_valid = n - n // 8 if masked is True else n
    if masked == "lattice":
        pos = torch.from_numpy(rng.integers(-16, 17, (b, n, 3))
                               .astype(np.float32) * 0.25).to(dev)
    elif masked is True:
        pen[:, n_valid:] = -1e10
        pos[:, n_valid:] = 999.0
    elif masked:
        n_valid = masked
        pen[:, n_valid:] = -1e10
        pos[:, n_valid:] *= 1000.0
    start = torch.from_numpy(rng.integers(0, n_valid, b)).to(dev)
    return pos, pen, start


def _fps_row(torch, F, stage, b, n, m, pos, pen, start, plan=None, plain=True):
    """The kernel against the plain version (index for index), its times
    and its bound; ``plan`` a launch other than the wrapper's own."""
    ik = F.fps_kernel(pos, m, pen, start, plan)
    ip = F.fps_plain(pos, m, pen, start)
    torch.cuda.synchronize()
    bad = int((ik != ip).sum())
    if bad:
        raise AssertionError(f"fps {stage}: {bad} indices differ")
    run = lambda: F.fps_kernel(pos, m, pen, start, plan)
    ms = time_ms(run, torch)
    dev_ms = device_ms(run, torch)
    plain_ms = (time_ms(lambda: F.fps_plain(pos, m, pen, start), torch,
                        reps=3, warmup=1) if plain else None)
    b_ms, b_by = bound(8.0 * b * m * n, 4 * b * n * 4 + 8 * b * (m + 1), "f32")
    plan = plan or F.fps_plan(n)
    return dict(stage=stage, rows=b, N=n, m=m, variant=plan.variant,
                cluster=plan.cluster, threads=plan.threads, ppt=plan.ppt,
                max_abs_err=0.0, index_mismatch=bad, ms=ms, device_ms=dev_ms,
                us_per_round=dev_ms * 1e3 / max(m - 1, 1), plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_fps(torch, dev, rng):
    """The train step's FPS stages (each weighted by its launches per G+D
    step), then the tie and exhaustion rows (weight 0), each the kernel
    against the plain version; then the round's fixed cost (``fps_floor``
    rows, not in the returned list)."""
    from tpugan_tpu_torch.ops.kernels import fps as F

    rows = []
    for stage, b, n, m, masked, per in FPS_SHAPES:
        pos, pen, start = _fps_case(torch, dev, rng, b, n, masked)
        rows.append(dict(_fps_row(torch, F, stage, b, n, m, pos, pen, start),
                         per_step=per))
        emit({"phase": "kernel", "kernel": "fps", **rows[-1]})
    for stage, b, n, m, points in FPS_EDGE_SHAPES:
        pos, pen, start = _fps_case(torch, dev, rng, b, n, points)
        rows.append(dict(_fps_row(torch, F, stage, b, n, m, pos, pen, start),
                         per_step=0))
        emit({"phase": "kernel", "kernel": "fps", **rows[-1]})
    plans = [("warp", F.FpsPlan("warp", 1, 32, 1))] + [
        (f"cluster {c}", F.FpsPlan("cluster", c, 128, 1))
        for c in FPS_FLOOR_CLUSTERS]
    for name, plan in plans:
        n = plan.cluster * plan.slice
        pos, pen, start = _fps_case(torch, dev, rng, 4, n, False)
        row = _fps_row(torch, F, f"floor: {name}", 4, n, FPS_FLOOR_ROUNDS,
                       pos, pen, start, plan, plain=False)
        emit({"phase": "kernel", "kernel": "fps_floor", **row})
    return rows


def check_ball_query(torch, dev, rng):
    from tpugan_tpu_torch.ops.kernels import ball_query as BQ

    rows = []
    for stage, b, nq, nc, r, ns, per in BALL_SHAPES:
        cand = _cloud(torch, dev, rng, b, nc, 3)
        query = cand[:, torch.randperm(nc, device=dev)[:nq]]
        bias = torch.zeros((b, nc), device=dev)
        bias[:, ::9] = 2.0                           # masked candidates
        ik = BQ.ball_query_kernel(query, cand, r, ns, bias)
        ip = BQ.ball_query_plain(query, cand, r, ns, bias)
        torch.cuda.synchronize()
        # both evaluate the same f32 expression in the same order: equal
        bad = int((ik != ip).sum())
        if bad:
            raise AssertionError(f"ball_query {stage}: {bad} indices differ")
        ms = time_ms(lambda: BQ.ball_query_kernel(query, cand, r, ns, bias),
                     torch)
        plain_ms = time_ms(lambda: BQ.ball_query_plain(query, cand, r, ns,
                                                       bias), torch)
        # the scan ends at the nsample-th hit: count the candidates this
        # data needs (a full ball's indices rise strictly to the last slot)
        full = ik[..., -1] > ik[..., -2]
        scanned = float(torch.where(full, ik[..., -1] + 1, nc).sum())
        b_ms, b_by = bound(8.0 * scanned,
                           4 * (b * nq * 3 + b * nc * 4) + 8 * b * nq * ns,
                           "f32")
        rows.append(dict(stage=stage, B=b, Nq=nq, Nc=nc, radius=r, nsample=ns,
                         per_step=per, full_balls=float(full.float().mean()),
                         max_abs_err=0.0, index_mismatch=bad, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by))
        emit({"phase": "kernel", "kernel": "ball_query", **rows[-1]})
    return rows


def check_pooled_mlp(torch, dev, rng):
    """Forward (pooled, moments) and backward (dtable, dW, dgamma, dbeta)
    against the plain versions, on tables with exact max ties (the ball
    query's repeated first hit), at each stage and once with gammas of both
    signs and zero. Forward to 1e-5 of each tensor's scale
    (f32 sums in another order). Backward: each gradient to 1e-2 of its
    norm, and at most 1e-3 of dtable's elements off by more than 1e-3 of
    its scale. The two sides sum the layers in another order, so where two
    rows' values lie within f32 rounding of each other the max-pool can
    send a cotangent to another row, and a leaky-ReLU pre-activation
    within f32 noise of 0 can take the other slope: a few rows of dtable
    move by order 1, which a norm over millions of entries hides and an
    elementwise bound does not."""
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    fwd_rows, bwd_rows = [], []
    for stage, shape, widths, slope, per, gammas in POOLED_SHAPES:
        b, m, ns, c0 = shape
        tab = _cloud(torch, dev, rng, *shape, scale=1.0)
        tab[:, :, 1] = tab[:, :, 0]
        tab[:, :, -1] = tab[:, :, 0]
        cs = (c0,) + widths
        ws = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
              for i in range(len(widths))]
        gs = [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        if gammas == "mixed":
            for gamma in gs:
                gamma[::3] *= -1
                gamma[1::5] = 0.0
        bs = [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        g = _cloud(torch, dev, rng, b, m, widths[-1], scale=1.0)
        leaves = [x.clone().requires_grad_() for x in [tab, *ws, *gs, *bs]]
        nl = len(widths)
        pooled, mus, vars_ = P.pooled_mlp_bn_train(
            leaves[0], leaves[1:1 + nl], leaves[1 + nl:1 + 2 * nl],
            leaves[1 + 2 * nl:], slope)
        grads = torch.autograd.grad(pooled, leaves, g, retain_graph=True)
        fp = P.pooled_mlp_bn_forward_plain(tab, ws, gs, bs, slope)
        gp = P.pooled_mlp_bn_backward_plain(tab, ws, fp[4], fp[5], fp[1],
                                            fp[3], fp[0], g, slope)
        torch.cuda.synchronize()
        f_err = 0.0
        for got, want in zip([pooled, *mus, *vars_], [fp[0], *fp[1], *fp[2]]):
            e = float((got.detach() - want).abs().max())
            f_err = max(f_err, e)
            if e > 1e-5 * max(1.0, float(want.abs().max())):
                raise AssertionError(f"pooled_mlp {stage} forward: err {e}")
        b_err, b_rel = 0.0, 0.0
        names = ["dtable"] + [f"{n}{i}" for n in ("dW", "dgamma", "dbeta")
                              for i in range(nl)]
        for name, got, want in zip(names, grads,
                                   [gp[0], *gp[1], *gp[2], *gp[3]]):
            diff = (got - want).abs()
            b_err = max(b_err, float(diff.max()))
            rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
            b_rel = max(b_rel, rel)
            off = float((diff > 1e-3 * want.abs().max()).float().mean())
            if rel > 1e-2 or (name == "dtable" and off > 1e-3):
                raise AssertionError(f"pooled_mlp {stage} backward {name}: "
                                     f"norm rel {rel}, share off {off}")
            if name == "dtable":
                dtable_off = off
        with torch.no_grad():
            fwd = lambda: P.pooled_mlp_bn_train(tab, ws, gs, bs, slope)
            ms = time_ms(fwd, torch)
            dev_ms, fwd_kernels = device_ms(fwd, torch, by_kernel=True)
            plain_ms = time_ms(lambda: P.pooled_mlp_bn_forward_plain(
                tab, ws, gs, bs, slope), torch)
            bwd_plain_ms = time_ms(lambda: P.pooled_mlp_bn_backward_plain(
                tab, ws, fp[4], fp[5], fp[1], fp[3], fp[0], g, slope), torch)
        bwd = lambda: torch.autograd.grad(pooled, leaves, g, retain_graph=True)
        bwd_ms = time_ms(bwd, torch)
        bwd_dev_ms, bwd_kernels = device_ms(bwd, torch, by_kernel=True)
        rows_n = b * m * ns
        mac = sum(cs[i] * cs[i + 1] for i in range(nl))
        nw = sum(w.numel() for w in ws) + 2 * sum(widths)
        f_bound = bound(2.0 * rows_n * mac,
                        4 * (rows_n * c0 + nw + b * m * widths[-1]), "f32")
        # the backward recomputes the activations (2) and forms dX, dW (4)
        b_bound = bound(6.0 * rows_n * mac,
                        4 * (2 * rows_n * c0 + 2 * nw + 2 * b * m * widths[-1]),
                        "f32")
        common = dict(stage=stage, table=list(shape), widths=list(widths),
                      slope=slope, gammas=gammas, per_step=per)
        fwd_rows.append(dict(**common, max_abs_err=f_err, ms=ms,
                             device_ms=dev_ms, device_ms_by_kernel=fwd_kernels,
                             plain_ms=plain_ms,
                             library_ms=None, bound_ms=f_bound[0],
                             bound_by=f_bound[1]))
        bwd_rows.append(dict(**common, max_abs_err=b_err, max_norm_rel_err=b_rel,
                             dtable_share_off=dtable_off, ms=bwd_ms,
                             device_ms=bwd_dev_ms,
                             device_ms_by_kernel=bwd_kernels,
                             plain_ms=bwd_plain_ms,
                             library_ms=None, bound_ms=b_bound[0],
                             bound_by=b_bound[1]))
        emit({"phase": "kernel", "kernel": "pooled_mlp_fwd", **fwd_rows[-1]})
        emit({"phase": "kernel", "kernel": "pooled_mlp_bwd", **bwd_rows[-1]})
        if stage == "spatial sa_0":
            # the eval-mode form (pooled_mlp_affine) through the same launch
            with torch.no_grad():
                aff = P.pooled_mlp_affine(tab, ws, fp[4], fp[5], slope)
                affp = P.pooled_mlp_affine_plain(tab, ws, fp[4], fp[5], slope)
            e = float((aff - affp).abs().max())
            if e > 1e-5 * float(affp.abs().max()):
                raise AssertionError(f"pooled_mlp_affine: err {e}")
            with torch.no_grad():
                aff_ms = time_ms(lambda: P.pooled_mlp_affine(
                    tab, ws, fp[4], fp[5], slope), torch)
                affp_ms = time_ms(lambda: P.pooled_mlp_affine_plain(
                    tab, ws, fp[4], fp[5], slope), torch)
            emit({"phase": "kernel", "kernel": "pooled_mlp_affine",
                  **common, "max_abs_err": e, "ms": aff_ms,
                  "plain_ms": affp_ms, "library_ms": None,
                  "bound_ms": f_bound[0], "bound_by": f_bound[1]})
    return fwd_rows, bwd_rows


# The EdgeConv backward at each shape class of the fused train step: the
# generator's [3B] = 12 frames of 1,152 points. (name, C, H, O, K,
# aggregate, mlp, dtype, exact ties, launches per fused train step)
EDGECONV_BWD_SHAPES = [
    ("extractor EdgeConv_0", 6, 64, 128, 20, "max", True, "f32", False, 1),
    ("IDGCN d=1", 32, 16, 32, 20, "max", True, "f32", False, 2),
    ("IDGCN d=2", 32, 16, 32, 10, "max", True, "f32", False, 2),
    ("upsampler/mask k=12", 64, 128, 256, 12, "max", True, "f32", False, 2),
    ("upsampler k=4", 64, 128, 256, 4, "max", True, "f32", False, 1),
    ("mask k=8 sum", 64, 128, 128, 8, "sum", False, "f32", False, 1),
    ("IDGCN d=1 bf16", 32, 16, 32, 20, "max", True, "bf16", False, 0),
    ("upsampler k=12 exact ties", 64, 128, 256, 12, "max", True, "f32", True, 0),
]
TRAIN_ROWS, TRAIN_POINTS = 12, 1152
# Each gradient to this share of its norm, and at most SHARE_OFF of gnbr's
# elements off by more than NORM_TOL of its scale. Both sides round the
# same values but sum in another order, so where two planes' outputs lie
# within f32 rounding of each other the max can send a (point, column)'s
# cotangent to the other plane, and a leaky-ReLU pre-activation within f32
# noise of 0 can take the other slope: a few elements of gnbr move by order
# 1. bf16: a rounding flip of one cotangent carries through the layers.
EC_BWD_TOL = {"f32": (1e-3, 1e-3), "bf16": (2e-2, 1e-2)}   # (norm, share off)


def _grad_errors(got, want, tol, share_tol, what):
    """(max abs err, max norm-relative err, share of the first tensor's
    elements off by more than tol of its scale); raises past the limits."""
    err, rel, share = 0.0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, float(diff.max()))
        r = float((a - b).norm() / b.norm().clamp_min(1e-30))
        rel = max(rel, r)
        if i == 0:
            share = float((diff > tol * b.abs().max()).float().mean())
        if r > tol or share > share_tol:
            raise AssertionError(f"{what} gradient {i}: norm rel {r}, "
                                 f"share off {share}")
    return err, rel, share


def check_edgeconv_bwd(torch, dev, rng):
    """The backward kernel against its plain version (the kernel's rounding
    points, max ties recomputed) at the fused train step's shapes; in the
    exact-tie case, planes 1 and 5 repeat planes 0 and 3, so a max shared by
    two planes must split its cotangent evenly between them. Each row names
    its path ("tiled": the f32 class of F32_TILED_BWD_CLASSES on GEMM
    tiles, one launch of it a call and a second call equal bit for bit;
    "general": the general kernel, none) and the device time of each of its
    kernels."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    rows = []
    b, n = TRAIN_ROWS, TRAIN_POINTS
    for name, c, h, o, k, agg, mlp, kind, ties, per in EDGECONV_BWD_SHAPES:
        cdt = torch.float32 if kind == "f32" else torch.bfloat16
        t = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        nbr, ctr = t(b, k, n, c), t(b, n, c)
        if ties:
            nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
        wn, we = t(c, h) / np.sqrt(c), t(c, h) / np.sqrt(c)
        w1 = t(h, h) / np.sqrt(h) if mlp else None
        w2 = t(h, o) / np.sqrt(h) if mlp else None
        g = t(b, n, o if mlp else h).to(cdt)
        args = (nbr.to(cdt), ctr.to(cdt), wn, we, w1, w2, g, agg, cdt)
        tiled = E.takes_f32_tiled_bwd(cdt, mlp, c, h, o)
        f0 = E.F32_TILED_BWD_LAUNCHES
        got = E.edgeconv_backward(*args)
        if E.F32_TILED_BWD_LAUNCHES - f0 != int(tiled):
            raise AssertionError(f"edgeconv_bwd {name}: tiled launches "
                                 f"{E.F32_TILED_BWD_LAUNCHES - f0}")
        want = E.edgeconv_backward_plain(*args)
        torch.cuda.synchronize()
        tol, share_tol = EC_BWD_TOL[kind]
        err, rel, share = _grad_errors(got, want, tol, share_tol,
                                       f"edgeconv_bwd {name}")
        split = None
        if ties:
            # the duplicated planes' gradients are equal, both sides
            split = float(max((got[0][:, 1] - got[0][:, 0]).abs().max(),
                              (got[0][:, 5] - got[0][:, 3]).abs().max()))
            if split != 0.0:
                raise AssertionError(f"edgeconv_bwd ties: planes differ {split}")
        repeat = None
        if tiled:
            repeat = all(torch.equal(a, b) for a, b in
                         zip(got, E.edgeconv_backward(*args)) if a is not None)
            if not repeat:
                raise AssertionError(f"edgeconv_bwd {name}: two calls differ")
        ms = time_ms(lambda: E.edgeconv_backward(*args), torch)
        dev_ms, by_kernel = device_ms(lambda: E.edgeconv_backward(*args),
                                      torch, by_kernel=True)
        plain_ms = time_ms(lambda: E.edgeconv_backward_plain(*args), torch)
        esz = 4 if kind == "f32" else 2
        # the function recomputes the forward and forms two products per
        # layer (the inputs' and the weights' gradients): 3x the forward
        mac = 2 * c * h + ((h * h + h * o) if mlp else 0)
        flops = 3 * 2 * b * k * n * mac
        nbytes = (esz * (2 * b * k * n * c + 2 * b * n * c + b * n * (o if mlp else h))
                  + 4 * 2 * mac)
        b_ms, b_by = bound(flops, nbytes, kind)
        rows.append(dict(config=name, dtype=kind, B=b, N=n, C=c, H=h, O=o,
                         K=k, aggregate=agg, exact_ties=ties, per_step=per,
                         path="tiled" if tiled else "general",
                         max_abs_err=err, max_norm_rel_err=rel,
                         gnbr_share_off=share, tie_split_err=split, tol=tol,
                         repeat_bit_equal=repeat, ms=ms, device_ms=dev_ms,
                         device_ms_by_kernel=by_kernel, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "edgeconv_bwd", **rows[-1]})
    return rows


AFFINE_SHAPES = [  # (stage, (B, M, ns, C0), widths, slope)
    ("spatial sa_0", (4, 1024, 32, 6), (64, 128), 0.01),
    ("group_all (sa_pooling)", (4, 1, 128, 259), (256, 256), 0.0),
]


def check_pooled_affine_bwd(torch, dev, rng):
    """The affine form's backward (a norm-free SetConv trained fused)
    against its plain version, on tables with exact max ties; limits as
    for the batch-norm backward (check_pooled_mlp)."""
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    rows = []
    for stage, shape, widths, slope in AFFINE_SHAPES:
        b, m, ns, c0 = shape
        tab = _cloud(torch, dev, rng, *shape, scale=1.0)
        tab[:, :, 1] = tab[:, :, 0]
        cs = (c0,) + widths
        nl = len(widths)
        ws = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
              for i in range(nl)]
        a_s = [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        b_s = [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        g = _cloud(torch, dev, rng, b, m, widths[-1], scale=1.0)
        leaves = [x.clone().requires_grad_() for x in [tab, *ws, *a_s, *b_s]]
        pooled = P.pooled_mlp_affine(leaves[0], leaves[1:1 + nl],
                                     leaves[1 + nl:1 + 2 * nl],
                                     leaves[1 + 2 * nl:], slope)
        got = torch.autograd.grad(pooled, leaves, g, retain_graph=True)
        pp = P.pooled_mlp_affine_plain(tab, ws, a_s, b_s, slope)
        want = P.pooled_mlp_affine_backward_plain(tab, ws, a_s, b_s, pp, g,
                                                  slope)
        torch.cuda.synchronize()
        f_err = float((pooled.detach() - pp).abs().max())
        if f_err > 1e-5 * max(1.0, float(pp.abs().max())):
            raise AssertionError(f"pooled_mlp_affine {stage} forward: {f_err}")
        err, rel, share = _grad_errors(
            got, [want[0], *want[1], *want[2], *want[3]], 1e-2, 1e-3,
            f"pooled_mlp_affine_bwd {stage}")
        ms = time_ms(lambda: torch.autograd.grad(pooled, leaves, g,
                                                 retain_graph=True), torch)
        with torch.no_grad():
            plain_ms = time_ms(lambda: P.pooled_mlp_affine_backward_plain(
                tab, ws, a_s, b_s, pp, g, slope), torch)
        rows_n = b * m * ns
        mac = sum(cs[i] * cs[i + 1] for i in range(nl))
        nw = sum(w.numel() for w in ws) + 2 * sum(widths)
        # recompute the activations (2), form dX and dW (4), as the
        # batch-norm backward's bound counts
        b_ms, b_by = bound(6.0 * rows_n * mac,
                           4 * (2 * rows_n * c0 + 2 * nw + 2 * b * m * widths[-1]),
                           "f32")
        rows.append(dict(stage=stage, table=list(shape), widths=list(widths),
                         slope=slope, per_check=1, max_abs_err=err,
                         max_norm_rel_err=rel, dtable_share_off=share, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by))
        emit({"phase": "kernel", "kernel": "pooled_mlp_affine_bwd", **rows[-1]})
    return rows


def check_interp(torch, dev, rng, b=12, n=9216):
    """The velocity transfer's shape: the three predicted frames (with
    999-sentinel rows) against the ground truth, bicubic, cutoff 1.6 R.
    out to 1e-5 of the values' scale, den to 1e-5 relative (f32 sums)."""
    from tpugan_tpu_torch.ops.kernels import interp as I

    c, cutoff = 3, 0.16
    cand = _cloud(torch, dev, rng, b, n, 3)
    query = cand + _cloud(torch, dev, rng, b, n, 3, scale=0.01)
    query[:, -n // 10:] = 999.0
    vals = _cloud(torch, dev, rng, b, n, c, scale=0.025)
    bias = torch.zeros((b, n), device=dev)
    ok, dk = I.interp_kernel(query, cand, vals, cutoff, bias, "bicubic")
    op, dp = I.interp_plain(query, cand, vals, cutoff, bias, "bicubic")
    torch.cuda.synchronize()
    err = float((ok - op).abs().max())
    den_rel = float(((dk - dp).abs() / dp.abs()).max())
    if not (err <= 1e-5 * float(vals.abs().max()) and den_rel <= 1e-5
            and bool(torch.isfinite(ok).all())):
        raise AssertionError(f"interp: err {err}, den rel {den_rel}")
    ms = time_ms(lambda: I.interp_kernel(query, cand, vals, cutoff, bias),
                 torch)
    plain_ms = time_ms(lambda: I.interp_plain(query, cand, vals, cutoff, bias),
                       torch, reps=3, warmup=1)
    b_ms, b_by = bound(20.0 * b * n * n,
                       4 * (b * n * 3 + b * n * (3 + c + 1) + b * n * (c + 1)),
                       "f32")
    row = dict(B=b, Nq=n, M=n, C=c, cutoff=cutoff, per_step=1,
               max_abs_err=err, den_max_rel_err=den_rel, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    emit({"phase": "kernel", "kernel": "interp", **row})
    return [row]


# ---------------------------------------------------------- train phases

def fluid_batches(torch, dev, patch, batch_size, count):
    """``count`` batches of the port's synthetic fluid data (the JAX CLI's
    --synthetic defaults: seed 1, 2 cases, 8 steps, 12,000 particles)."""
    from tpugan_tpu_torch.data.fluid import (SiamFluidDataset,
                                             fluid_batch_iterator)
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset

    root = make_synthetic_fluid_dataset(DATA_DIR, case_num=2, case_steps=8,
                                        num_particles=12000, seed=1)
    it = fluid_batch_iterator(SiamFluidDataset(root, 2, 8, sample_num=patch),
                              batch_size, seed=1)
    out = []
    for _ in range(count):
        batch = next(it)
        out.append({k: torch.from_numpy(batch[k]).to(dev)
                    for k in ("highres_pos", "highres_vel")})
    return out


def _critic_state(state):
    """(params, BatchNorm running moments, spectral-norm u) of both critics."""
    snap = {}
    for name in ("tempo", "spatial"):
        for k, t in getattr(state, name).module.state_dict().items():
            kind = ("u" if k.endswith(".u") else
                    "bn" if k.endswith((".mean", ".var")) else
                    "param" if not k.endswith(".sigma") else None)
            if kind:
                snap[(name, kind, k)] = t.detach().clone()
    return snap


def _moved(before, after, name, kind):
    return any(bool((before[key] != after[key]).any())
               for key in before if key[0] == name and key[1] == kind)


def train(torch, dev, kernels, profile_dir=None, cfg=None):
    """Resume the trainer state and run TRAIN_STEPS steps at full width
    (``cfg`` None: the train_vel defaults, device sampling); the launch
    counts are reset just before and read just after."""
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig

    cfg = cfg or FluidTrainConfig()
    batches = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size,
                            TRAIN_STEPS + 2)
    state = load_trainer_state(CHECKPOINT, cfg, device=dev)
    n0 = state.n_iter
    step = FluidGanStep(cfg, generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()

    for k in kernels.values():
        k.launches = 0
    steps = []
    for i in range(TRAIN_STEPS):
        before = _critic_state(state)
        c0 = counts(kernels)
        ev = {n: torch.cuda.Event(enable_timing=True)
              for n in ("start", "generator", "critics")}
        ev["start"].record()
        t0 = time.perf_counter()
        metrics = step(state, batches[i], mark=lambda n: ev[n].record())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = delta(c0, counts(kernels))
        d_update = metrics["gate"] and state.n_iter % 2 == 0
        want = dict(STEP_ALWAYS)
        for extra in ([STEP_GATE] if metrics["gate"] else []) + (
                [STEP_CRITICS] if d_update else []):
            for n, v in extra.items():
                want[n] = want.get(n, 0) + v
        expect(got, want, f"train step {state.n_iter}")
        after = _critic_state(state)
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"step {state.n_iter}: {name} = {v}")
        moved = {f"{name}_{kind}": _moved(before, after, name, kind)
                 for name in ("tempo", "spatial")
                 for kind in ("param", "bn", "u")}
        if any(moved[f"{n}_param"] != d_update for n in ("tempo", "spatial")):
            raise AssertionError(f"step {state.n_iter}: critic params moved "
                                 f"{moved}, critic update {d_update}")
        if metrics["gate"] and not all(moved[f"{n}_{k}"] for n in
                                       ("tempo", "spatial") for k in ("bn", "u")):
            raise AssertionError(f"step {state.n_iter}: critic state {moved}")
        steps.append(dict(iteration=state.n_iter, **metrics,
                          critic_update=d_update, launches=got,
                          ms=ev["start"].elapsed_time(ev["critics"]),
                          generator_ms=ev["start"].elapsed_time(ev["generator"]),
                          critics_ms=ev["generator"].elapsed_time(ev["critics"]),
                          wall_ms=wall, moved=moved))
        emit({"phase": "train", **steps[-1]})
    launches = counts(kernels)
    if not any(s["critic_update"] for s in steps):
        raise AssertionError("the adversarial gate never opened on an even "
                             "step: the critics' path did not run")
    emit({"phase": "train", "resumed_from": os.path.relpath(CHECKPOINT, ROOT),
          "first_iteration": n0 + 1, "steps": TRAIN_STEPS,
          "batch": cfg.batch_size, "patch": cfg.patch_size,
          "gate_open": sum(s["gate"] for s in steps),
          "critic_updates": sum(s["critic_update"] for s in steps),
          "launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    train_profile(torch, step, state, batches[TRAIN_STEPS:], profile_dir)
    return launches, steps


def train_profile(torch, step, state, batches, out_dir, of="train"):
    """torch.profiler over two more steps (one odd, one even): device time
    by kernel and the device's idle share of the steps' wall time; ``of``
    names the path in the output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for batch in batches:
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda x: -x[1])
    kernels_ms = sum(t for _, t, _ in table)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{of}_step.txt"), "w") as fh:
            fh.write(p.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=80))
    emit({"phase": "profile", "of": of, "train_steps": len(batches),
          "wall_ms": wall_ms, "device_kernel_ms": kernels_ms,
          "device_idle_share": 1.0 - kernels_ms / wall_ms,
          "top": [(n[:60], round(t, 4), c) for n, t, c in table[:20]]})


def _bias_under_bn(module, key):
    """A Dense bias that a batch norm follows (the critics' heads): its
    gradient is zero in exact arithmetic, so it is f32 noise on both sides,
    and the resumed Adam state (whose nu holds 20,000 steps of that noise)
    turns the noise into steps of the learning rate's size."""
    prefix, _, leaf = key.rpartition(".")
    head, _, dense = prefix.rpartition(".")
    if leaf != "bias" or not dense.startswith("Dense_"):
        return False
    bn = (head + "." if head else "") + "BatchNorm_" + dense.split("_")[1]
    return bn in dict(module.named_modules())


CARD_CPU_LOSS_TOL = 5e-3
CARD_CPU_CHANGE_TOL = {"sr": 0.02, "tempo": 0.1, "spatial": 0.1}
BIAS_GRAD_TOL = 1e-3


def _change_over_limit(module, before, got_params, want_params, tol):
    """(largest err / limit, its parameter) of each parameter's change in
    ``got_params`` against ``want_params`` from ``before``: the limit is
    ``tol`` of the wanted change's norm plus 1e-3 of the largest RMS change
    per element. Dense biases under a batch norm are checked apart
    (:func:`_bias_grads_over_limit`)."""
    changes = [(k, got_params[k].detach().cpu() - before[k],
                want_params[k].detach().cpu() - before[k])
               for k in want_params if not _bias_under_bn(module, k)]
    r = max(float(w.norm()) / w.numel() ** 0.5 for _, _, w in changes)
    worst, worst_k = 0.0, None
    for k, got, want in changes:
        err = float((got - want).norm())
        lim = tol * float(want.norm()) + 1e-3 * want.numel() ** 0.5 * r
        if err / lim > worst:
            worst, worst_k = err / lim, k
    return worst, worst_k


def _bias_grads_over_limit(net, mu_before):
    """Largest max |g| of a Dense bias under a batch norm over
    ``BIAS_GRAD_TOL`` max |g| of that Dense's weight, the step's gradients
    recovered from Adam's first moment, g = (mu - b1 mu_before) / (1 - b1).
    The batch norm makes such a bias's gradient zero in exact arithmetic,
    so it is f32 noise; the resumed Adam state turns noise into steps of
    the learning rate's size, which no comparison of the changes between
    two devices can hold."""
    opt, worst = net.opt, 0.0
    g = lambda k: (opt.mu[k] - opt.b1 * mu_before[k]) / (1.0 - opt.b1)
    for k in opt.params:
        if _bias_under_bn(net.module, k):
            w = k[:-len("bias")] + "weight"
            worst = max(worst, float(g(k).abs().max())
                        / (BIAS_GRAD_TOL * float(g(w).abs().max())))
    return worst


def train_card_vs_cpu(torch, dev, patch=1024):
    """One small step (B=2, 1,024-point patches; iteration 20,002 with the
    gate held open, so both critics update) from the same checkpoint state
    and the same draws on the card and on the CPU, with the card's generator
    graphs replayed on the CPU (GraphReplay). Losses to CARD_CPU_LOSS_TOL
    relative, each parameter's change to CARD_CPU_CHANGE_TOL of its norm
    (a few times the error measured on the H100: at B=2 the critics' heads
    normalise over 2 items and amplify f32 noise, see
    tests/test_torch_train_step.py), and the gradients of Dense biases
    under a batch norm to zero on both sides. Then the card's step with
    the gate shut (no adversarial loss reaches the generator) must fail
    the generator's comparison: the check sees a lost adversarial path."""
    import dataclasses

    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.models.discriminator import dropout_widths
    from tpugan_tpu_torch.train.step import (FluidGanStep, FluidTrainConfig,
                                             StepDraws)

    # the gate held open: this phase checks the wiring of every kernel
    cfg = FluidTrainConfig(batch_size=2, patch_size=patch, ml_gate=1e9)
    shut = dataclasses.replace(cfg, ml_gate=0.0)      # ml >= 0: never open
    batch = fluid_batches(torch, "cpu", cfg.patch_size, cfg.batch_size, 1)[0]
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    states = {d: load_trainer_state(CHECKPOINT, cfg, device=d)
              for d in (dev, "cpu")}
    states["no_adv"] = load_trainer_state(CHECKPOINT, cfg, device=dev)
    nets = ("sr", "tempo", "spatial")
    for s in states.values():
        s.n_iter += 1                                   # the step is even
    before = {n: {k: v.detach().clone() for k, v in
                  getattr(states["cpu"], n).module.named_parameters()}
              for n in nets}
    mu_before = {d: {n: {k: v.clone() for k, v in
                         getattr(states[d], n).opt.mu.items()} for n in nets}
                 for d in (dev, "cpu")}
    draws = StepDraws.draw(torch.Generator().manual_seed(2), cfg,
                           cfg.patch_size,
                           dropout_widths(states["cpu"].spatial.module))
    step = FluidGanStep(cfg)
    replay = GraphReplay(torch)
    t0 = time.perf_counter()
    m_card = replay.record(step, states[dev], card_batch, draws)
    t1 = time.perf_counter()
    m_cpu = replay.replay(step, states["cpu"], batch, draws)
    t2 = time.perf_counter()
    m_shut = FluidGanStep(shut)(states["no_adv"], card_batch, draws)
    if not (m_card["gate"] and m_cpu["gate"]) or m_shut["gate"]:
        raise AssertionError(f"card vs CPU: gate {m_card['gate']}, "
                             f"{m_cpu['gate']}, shut {m_shut['gate']}")
    out = {"phase": "train_cpu", "batch": 2, "patch": patch,
           "iteration": states["cpu"].n_iter, "knn_tie_swaps": replay.swaps,
           "card_s": t1 - t0, "cpu_s": t2 - t1, "loss_rel_err": {},
           "change_tol": CARD_CPU_CHANGE_TOL, "change_err_over_limit": {},
           "bias_grad_over_limit": {}}
    for k, v in m_cpu.items():
        if k == "gate":
            continue
        rel = abs(m_card[k] - v) / max(abs(v), 1e-5)
        out["loss_rel_err"][k] = rel
        if rel > CARD_CPU_LOSS_TOL:
            raise AssertionError(f"card vs CPU {k}: {m_card[k]} vs {v}")
    for n in nets:
        module = getattr(states["cpu"], n).module
        cpu = dict(module.named_parameters())
        card = dict(getattr(states[dev], n).module.named_parameters())
        worst, k = _change_over_limit(module, before[n], card, cpu,
                                      CARD_CPU_CHANGE_TOL[n])
        out["change_err_over_limit"][n] = worst
        if worst > 1.0:
            raise AssertionError(f"card vs CPU {n} {k}: change err "
                                 f"{worst} of the limit")
        bias = max(_bias_grads_over_limit(getattr(states[d], n),
                                          mu_before[d][n]) for d in (dev, "cpu"))
        out["bias_grad_over_limit"][n] = bias
        if bias > 1.0:
            raise AssertionError(f"card vs CPU {n}: a Dense bias under a "
                                 f"batch norm has a gradient ({bias})")
    sr_cpu = dict(states["cpu"].sr.module.named_parameters())
    lost, _ = _change_over_limit(
        states["cpu"].sr.module, before["sr"],
        dict(states["no_adv"].sr.module.named_parameters()), sr_cpu,
        CARD_CPU_CHANGE_TOL["sr"])
    out["no_adversarial_sr_change_over_limit"] = lost
    emit(out)
    if lost <= 1.0:
        raise AssertionError("card vs CPU: the generator's change without "
                             f"its adversarial losses passes the check ({lost})")


# ------------------------------------------------------ fused-train phase

FUSED_DIR = os.path.join(ROOT, "runs", "chip_smoke_train_fluid")   # gitignored
FUSED_ITERS = 20004
# Launches per fused train step on top of STEP_ALWAYS (and STEP_GATE,
# STEP_CRITICS): the generator's 9 EdgeConvs through the fused forward and
# its backward kernel (tpugan_tpu_torch/nn/edgeconv.py with fused_train).
STEP_FUSED = {"edgeconv": 9, "edgeconv_bwd": 9}
# Of those backwards, the f32 (64, 128, 256) class's on GEMM tiles
# (edgeconv.F32_TILED_BWD_LAUNCHES): the upsampler's k=12 and k=4 and the
# mask head's k=12 EdgeConvs.
STEP_TILED_BWD = 3
# After a checkpoint iteration (20001 and 20004 at the train_vel preset's
# --ckpt_every 10000, cli/train_fluid.py): the test split's 4 batches, one
# serving forward each (7 kNN, 9 EdgeConv) and its Chamfer (2 nn1), and
# the sample dump's serving forward.
CKPT_EVAL = {"knn": 5 * 7, "edgeconv": 5 * 9, "nn1": 4 * 2}
# Limit of the generator's gradients with the switch on against off (each
# parameter's step gradient, recovered from Adam's first moment, by norm,
# from one state and one set of draws, with the graphs replayed): the two
# paths sum in another order in f32. About 9x the error measured on an
# NVIDIA H100 80GB HBM3 at 700 W (5.6e-7, PERF.md section 6), so a fused
# backward off by 1e-5 in any parameter fails; the changes are only
# reported, since with the resumed moments one step's gradient is a tenth
# of the new mu.
FUSED_GRAD_TOL = 5e-6
FUSED_LOSS_TOL = 5e-3
# The control's loss: this share of each EdgeConv's neighbour-table
# gradient dropped (a fault in the gather's backward) must fail the check.
LOSSY_NBR_GRAD = 0.05


def _grads_rel_err(net_a, net_b, mu_before):
    """(largest ||g_a - g_b|| / ||g_b||, its parameter) over the step
    gradients of two nets that stepped from the same Adam state, each
    recovered as g = (mu - b1 mu_before) / (1 - b1)."""
    b1, worst, worst_k = net_b.opt.b1, 0.0, None
    for k, before in mu_before.items():
        ga = (net_a.opt.mu[k] - b1 * before) / (1.0 - b1)
        gb = (net_b.opt.mu[k] - b1 * before) / (1.0 - b1)
        err = float((ga - gb).norm()) / max(float(gb.norm()), 1e-30)
        if err > worst:
            worst, worst_k = err, k
    return worst, worst_k


def _changes_rel_err(module_a, module_b, before):
    """Largest ||change_a - change_b|| / ||change_b|| of each parameter
    from ``before``."""
    pa, pb = dict(module_a.named_parameters()), dict(module_b.named_parameters())
    return max(float((pa[k].detach().cpu() - pb[k].detach().cpu()).norm())
               / max(float((pb[k].detach().cpu() - v).norm()), 1e-30)
               for k, v in before.items())


def _state_equal(a, b):
    """(name of the first tensor that differs, or None) between two trainer
    states: every parameter, buffer, Adam moment and count."""
    if a.n_iter != b.n_iter:
        return "n_iter"
    for name in ("sr", "tempo", "spatial"):
        na, nb = getattr(a, name), getattr(b, name)
        sa, sb = na.module.state_dict(), nb.module.state_dict()
        for k in sa:
            if not bool((sa[k] == sb[k]).all()):
                return f"{name} {k}"
        if (na.opt.count, na.opt.sched_count) != (nb.opt.count, nb.opt.sched_count):
            return f"{name} adam counts"
        for moments in ("mu", "nu"):
            ma, mb = getattr(na.opt, moments), getattr(nb.opt, moments)
            for k in ma:
                if not bool((ma[k] == mb[k]).all()):
                    return f"{name} adam {moments} {k}"
    return None


def fused_train(torch, dev, kernels):
    """The train CLI twin called as a function, resumed from the trained
    checkpoint for iterations 20001-20004 at the train_vel preset with
    device sampling on its synthetic data, with TPUGAN_FUSED_EDGECONV_TRAIN=1:
    every generator EdgeConv trains through the fused forward and backward
    kernels. Counts reset just before; each step's launches against the
    counts the code implies, the windows between steps against CKPT_EVAL
    after checkpoint iterations (0 else); the last checkpoint read back
    equal to the state in memory. The counts hold "edgeconv_bwd_tiled",
    the backwards on GEMM tiles (STEP_TILED_BWD a step, 0 between)."""
    import shutil

    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.cli import train_fluid as cli
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.train.step import FluidTrainConfig

    shutil.rmtree(FUSED_DIR, ignore_errors=True)
    argv = ["--preset", "train_vel", "--device_sampling", "--synthetic",
            "--resume", "--path_to_resume", CHECKPOINT, "--iters",
            str(FUSED_ITERS), "--log_dir", FUSED_DIR]
    marks = []
    tally = lambda: {**counts(kernels),
                     "edgeconv_bwd_tiled": E.F32_TILED_BWD_LAUNCHES}

    def hook(event, n_iter, metrics):
        if event in ("start", "end"):
            torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((event, n_iter, tally(), ev, metrics,
                      time.perf_counter()))

    for k in kernels.values():
        k.launches = 0
    E.F32_TILED_BWD_LAUNCHES = 0
    os.environ[cli.FUSED_SWITCH] = "1"
    t0 = time.perf_counter()
    try:
        out = cli.main(argv, hook=hook)
    finally:
        del os.environ[cli.FUSED_SWITCH]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = tally()
    for k in kernels.values():
        k.launches = 0

    ckpt_iter = lambda n: (n - 1) % 10000 == 0 or n >= FUSED_ITERS
    steps, prev_counts, prev_iter = [], {n: 0 for n in launches}, None
    by = {}
    for event, n_iter, c, ev, metrics, wall in marks:
        by.setdefault(n_iter, {})[event] = (c, ev, metrics, wall)
    for n_iter in sorted(by):
        m = by[n_iter]
        between = delta(prev_counts, m["start"][0])
        expect(between, CKPT_EVAL if prev_iter and ckpt_iter(prev_iter) else {},
               f"fused CLI before iteration {n_iter}")
        metrics = m["end"][2]
        d_update = metrics["gate"] and n_iter % 2 == 0
        want = dict(STEP_ALWAYS, edgeconv_bwd_tiled=STEP_TILED_BWD)
        for extra in [STEP_FUSED] + ([STEP_GATE] if metrics["gate"] else []) + (
                [STEP_CRITICS] if d_update else []):
            for name, v in extra.items():
                want[name] = want.get(name, 0) + v
        got = delta(m["start"][0], m["end"][0])
        expect(got, want, f"fused train step {n_iter}")
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"fused step {n_iter}: {name} = {v}")
        start, gen, crit = m["start"][1], m["generator"][1], m["critics"][1]
        steps.append(dict(iteration=n_iter, **metrics, critic_update=d_update,
                          launches=got,
                          f32_tiled_bwd_launches=got["edgeconv_bwd_tiled"],
                          ms=start.elapsed_time(crit),
                          generator_ms=start.elapsed_time(gen),
                          critics_ms=gen.elapsed_time(crit),
                          wall_ms=(m["end"][3] - m["start"][3]) * 1e3))
        emit({"phase": "train_fused", **steps[-1]})
        prev_counts, prev_iter = m["end"][0], n_iter
    expect(delta(prev_counts, launches), CKPT_EVAL, "fused CLI after the last step")
    if len(steps) != FUSED_ITERS - 20000 or not any(s["critic_update"]
                                                     for s in steps):
        raise AssertionError(f"fused CLI ran {len(steps)} steps, critic "
                             f"updates {[s['critic_update'] for s in steps]}")
    back = load_trainer_state(out["checkpoint"], FluidTrainConfig(), dev)
    differs = _state_equal(out["state"], back)
    if differs is not None:
        raise AssertionError(f"checkpoint read back differs: {differs}")
    test_cd = out["test_chamfer"]
    if len(test_cd) != 2 or not all(np.isfinite(test_cd)):
        raise AssertionError(f"test Chamfer {test_cd}")
    emit({"phase": "train_fused", "resumed_from": os.path.relpath(CHECKPOINT, ROOT),
          "checkpoint": os.path.relpath(out["checkpoint"], ROOT),
          "checkpoint_read_back_equal": True, "test_chamfer": test_cd,
          "steps": len(steps), "cli_s": total_s, "launches": launches})
    return launches


def fused_vs_grouped(torch, dev, profile_dir=None):
    """One step from the trained state with the same draws, the switch off
    (grouped formulation) and on (fused kernels), the graphs of the first
    replayed into the second: the losses to FUSED_LOSS_TOL relative, each
    generator parameter's step gradient to FUSED_GRAD_TOL of its norm (the
    largest relative error of the changes is reported beside it). A control
    step with the switch on and LOSSY_NBR_GRAD of every EdgeConv's
    neighbour-table gradient dropped must fail that check. Then the ms per
    step of both, G only (odd iterations) and G+D (even), and a profile of
    two more fused steps. The gate is held open, so the adversarial losses
    reach the generator through the fused backward in every step."""
    import tpugan_tpu_torch.ops.kernels.edgeconv as ek
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.models.discriminator import dropout_widths
    from tpugan_tpu_torch.train.step import (FluidGanStep, FluidTrainConfig,
                                             StepDraws)

    cfg = FluidTrainConfig(ml_gate=1e9)
    steps = 4
    batches = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size, steps)
    states = {on: load_trainer_state(CHECKPOINT, cfg, dev, fused_train=on)
              for on in (False, True)}
    control = load_trainer_state(CHECKPOINT, cfg, dev, fused_train=True)
    before = {k: v.detach().cpu().clone()
              for k, v in states[False].sr.module.named_parameters()}
    mu_before = {k: v.clone() for k, v in states[False].sr.opt.mu.items()}
    widths = dropout_widths(states[False].spatial.module)
    draws = [StepDraws.draw(torch.Generator().manual_seed(3 + i), cfg,
                            cfg.patch_size, widths) for i in range(steps)]
    step = FluidGanStep(cfg)
    replay = GraphReplay(torch)
    m_off = replay.record(step, states[False], batches[0], draws[0])
    graphs = list(replay.lists)
    m_on = replay.replay(step, states[True], batches[0], draws[0])
    own_bwd = ek.edgeconv_backward

    def lossy_bwd(*args, **kw):
        gnbr, *rest = own_bwd(*args, **kw)
        return ((1.0 - LOSSY_NBR_GRAD) * gnbr, *rest)

    replay.lists, ek.edgeconv_backward = graphs, lossy_bwd
    try:
        replay.replay(step, control, batches[0], draws[0])
    finally:
        ek.edgeconv_backward = own_bwd
    lossy, _ = _grads_rel_err(control.sr, states[False].sr, mu_before)
    del control
    loss_rel = {k: abs(m_on[k] - v) / max(abs(v), 1e-5)
                for k, v in m_off.items() if k != "gate"}
    worst, worst_k = _grads_rel_err(states[True].sr, states[False].sr,
                                    mu_before)
    out = {"phase": "train_fused_vs_grouped", "iteration": states[True].n_iter,
           "gate": [m_off["gate"], m_on["gate"]], "knn_tie_swaps": replay.swaps,
           "loss_rel_err": loss_rel, "grad_tol": FUSED_GRAD_TOL,
           "sr_grad_rel_err": worst, "worst_parameter": worst_k,
           "sr_change_rel_err": _changes_rel_err(
               states[True].sr.module, states[False].sr.module, before),
           "lossy_nbr_grad": LOSSY_NBR_GRAD, "lossy_sr_grad_rel_err": lossy}
    if (m_off["gate"] != m_on["gate"] or worst > FUSED_GRAD_TOL
            or lossy <= FUSED_GRAD_TOL
            or max(loss_rel.values()) > FUSED_LOSS_TOL):
        emit(out)
        raise AssertionError(f"fused vs grouped step: {out}")
    # ms per step of both paths from here on, in turns
    ms = {False: [], True: []}
    for i in range(1, steps):
        for on in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(states[on], batches[i], draws[i])
            end.record()
            end.synchronize()
            ms[on].append((states[on].n_iter, start.elapsed_time(end)))
    for on, name in ((False, "grouped"), (True, "fused")):
        out[f"{name}_ms"] = {"g_only": [t for n, t in ms[on] if n % 2],
                             "g_and_d": [t for n, t in ms[on] if n % 2 == 0]}
    emit(out)
    train_profile(torch, step, states[True], batches[2:], profile_dir,
                  of="train_fused")
    return out


# ---------------------------------------------------------- eval phases

EVAL_SAMPLES = 2
# Launches per eval sample, read off tpugan_tpu_torch/cli/eval_fluid.py and
# eval/analysis.py (the wrappers count one per call):
#   f32 dynamic: 3 SRNet forwards of 1,152 inputs (the centre frame for
#     position_metrics, the left and the right frame in cycle_consistency),
#     7 kNN graphs and 9 EdgeConvs each; the capped interpolation's k = 32
#     radius kNN; the Chamfers' 2 nn1 in position_metrics and 2 in
#     cycle_consistency (the eps-scaled auctions end in the Hungarian
#     repair, so no nearest-target nn1);
#   bf16 static with --agreement_vs_exact: the bf16 static forward (1
#     graph) and its exact f32 dynamic twin (7), the Chamfer between them
#     (2 nn1), then as above with bf16 static forwards (1 graph each).
EVAL_SAMPLE = {"knn": 3 * 7 + 1, "edgeconv": 3 * 9, "nn1": 2 + 2}
EVAL_SAMPLE_AGREEMENT = {"knn": 1 + 7 + 2 * 1 + 1, "edgeconv": 4 * 9,
                         "nn1": 2 + 2 + 2}
# The density phase: one f32 dynamic forward of a whole 12,000-particle
# frame (7 graphs, 9 EdgeConvs), the exact densities of its kept points and
# of a grid over it (the cell-grid kernel, one launch each) and the capped
# density of a 9,216-point ground-truth patch (one k = 64 radius kNN).
DENSITY_LAUNCHES = {"knn": 7 + 1, "edgeconv": 9, "binned_interp": 2}
DENSITY_CUTOFF = 0.05      # 2 x the reference's particle radius
DENSITY_GRID = 32          # grid points per axis
# card vs CPU: the nn1 kernel and the plain version round |q|^2 + |c|^2 -
# 2 q.c in another order (about 2.4e-7 of max |p|^2 per distance), which a
# Chamfer of near-identical clouds sums over every point; the auctions are
# two eps-optimal assignments (near-tie bids may go another way): 5e-2
# relative on the EMD; the MMD's exp(-|d|^2 / 2 blur^2) turns the same
# distance rounding into 1e-3 relative at most; densities are f32 sums in
# another order, 1e-5 relative.
EMD_RTOL = 5e-2
MMD_RTOL = 1e-3


def eval_phase(torch, kernels):
    """The port's eval CLI, called as a function, on the trained checkpoint
    at the train_vel width (9,216-point patches, 1,152 inputs) with its
    default 2,000 auction rounds: EVAL_SAMPLES samples f32 dynamic, then one
    bf16 static with the exact twin. Counts are reset before each run and
    read after each sample. Returns the launches of both runs."""
    import warnings

    import tpugan_tpu_torch.eval.analysis as analysis
    import tpugan_tpu_torch.ops.metrics as metrics
    from tpugan_tpu_torch.cli import eval_fluid

    base = ["--ckpt", CHECKPOINT, "--in_node_feats", "6", "--use_vel",
            "--patch_size", "9216"]
    total = {n: 0 for n in kernels}
    # seconds (host clock around a synchronised call) and rounds of each
    # auction (position EMD, cycle EMD)
    auction, emd_s, emd_rounds = analysis.auction_assignment, [], []

    def timed_auction(*args, **kw):
        torch.cuda.synchronize()
        metrics.auction_rounds = 0
        t0 = time.perf_counter()
        out = auction(*args, **kw)
        torch.cuda.synchronize()
        emd_s.append(time.perf_counter() - t0)
        emd_rounds.append(metrics.auction_rounds)
        return out

    for mode, extra, per in (
            ("f32 dynamic", ["--num_samples", str(EVAL_SAMPLES)], EVAL_SAMPLE),
            ("bf16 static + exact", ["--num_samples", "1", "--compute_dtype",
                                     "bf16", "--graph_mode", "static",
                                     "--agreement_vs_exact"],
             EVAL_SAMPLE_AGREEMENT)):
        marks = []

        def mark(_=None):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), counts(kernels)))

        for k in kernels.values():
            k.launches = 0
        emd_s.clear()
        emd_rounds.clear()
        mark()
        analysis.auction_assignment = timed_auction
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = eval_fluid.evaluate(eval_fluid.parser().parse_args(
                    base + extra), on_sample=mark)
        finally:
            analysis.auction_assignment = auction
        # marks: before the call, setup done (-1), after each sample
        expect(delta(marks[0][1], marks[1][1]), {}, f"eval {mode} setup")
        per_sample = [delta(a[1], b[1]) for a, b in zip(marks[1:], marks[2:])]
        seconds = [b[0] - a[0] for a, b in zip(marks[1:], marks[2:])]
        emit({"phase": "eval", "mode": mode, "result": out,
              "setup_s": marks[1][0] - marks[0][0],
              "seconds_per_sample": seconds, "emd_seconds": list(emd_s),
              "emd_rounds": list(emd_rounds),
              "launches_per_sample": per_sample})
        dup = [str(w.message) for w in caught
               if "duplicate assignments" in str(w.message)]
        if dup:
            raise AssertionError(f"eval {mode}: the EMD assignment is not a "
                                 f"permutation: {dup}")
        bad = {k: v for k, v in out.items()
               if k != "serving_mode" and not np.isfinite(v)}
        if bad or out["samples"] != len(per_sample):
            raise AssertionError(f"eval {mode}: {bad or out['samples']}")
        for i, got in enumerate(per_sample):
            expect(got, per, f"eval {mode} sample {i}")
        for n, v in counts(kernels).items():
            total[n] += v
    return total


# The eval CLI with --approx_graph at --patch_size 32768 (4,096 inputs, the
# first size whose graphs reach the approximate kernel), on a synthetic
# dataset of 40,000 particles (the CLI's own has 12,000), 4 frames, 1
# sample, the auction cut from 2,000 rounds a phase to 100 (a 32,768-point
# EMD at the default would take minutes). Launches per sample, read off
# cli/eval_fluid.py and eval/analysis.py: the approximate f32 dynamic
# forward (7 graphs, all approximate), the exact twin (7 exact), their
# Chamfer (2 nn1); position_metrics' Chamfer (2 nn1) and the capped
# interpolation's radius kNN (exact); cycle_consistency's 2 approximate
# forwards and its Chamfer (2 nn1).
EVAL_APPROX_DIR = os.path.join(ROOT, "runs", "eval_fluid_synth_approx")
EVAL_APPROX_PARTICLES = 40000
EVAL_APPROX_EMD_ITERS = 100
EVAL_APPROX_SAMPLE = {"knn": 7 + 1, "knn_approx": 3 * 7,
                      "edgeconv": 4 * 9, "nn1": 2 + 2 + 2}


def eval_approx(torch, kernels):
    """One eval CLI sample with --approx_graph --agreement_vs_exact (counts
    reset here, read after the sample); returns the launches."""
    from tpugan_tpu_torch.cli import eval_fluid
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
    from tpugan_tpu_torch.ops import neighbors

    t0 = time.perf_counter()
    make_synthetic_fluid_dataset(EVAL_APPROX_DIR, case_num=1, case_steps=4,
                                 num_particles=EVAL_APPROX_PARTICLES, seed=100)
    data_s = time.perf_counter() - t0
    argv = ["--ckpt", CHECKPOINT, "--in_node_feats", "6", "--use_vel",
            "--patch_size", "32768", "--num_samples", "1",
            "--sequence_length", "4", "--dataset_path", EVAL_APPROX_DIR,
            "--emd_iters", str(EVAL_APPROX_EMD_ITERS), "--approx_graph",
            "--agreement_vs_exact"]
    marks = []

    def mark(_=None):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), counts(kernels)))

    for k in kernels.values():
        k.launches = 0
    mark()
    out = eval_fluid.evaluate(eval_fluid.parser().parse_args(argv),
                              on_sample=mark)
    launches = counts(kernels)
    expect(delta(marks[0][1], marks[1][1]), {}, "eval approx setup")
    expect(delta(marks[1][1], marks[2][1]), EVAL_APPROX_SAMPLE,
           "eval approx sample")
    emit({"phase": "eval_approx", "argv": argv, "result": out,
          "data_s": data_s, "setup_s": marks[1][0] - marks[0][0],
          "sample_s": marks[2][0] - marks[1][0],
          "launches": delta(marks[1][1], marks[2][1])})
    bad = {k: v for k, v in out.items()
           if k != "serving_mode" and not np.isfinite(v)}
    if (bad or out["samples"] != 1 or not out["serving_mode"]["approx_graph"]
            or not out["chamfer_norm_vs_exact"] < GATE
            or neighbors.APPROX_GRAPH_KNN):
        raise AssertionError(f"eval approx: {out}")
    return launches


def density_phase(torch, dev, kernels):
    """With the counts reset: the trained SRNet (f32 dynamic) on a whole
    12,000-particle synthetic frame with its velocities (96,000 slots), the
    exact density of its kept points and of a DENSITY_GRID^3 grid over its
    bounding box (cell-grid kernel), and the capped k = 64 density of an
    eval sample's 9,216-point ground truth; then each kernel of the phase
    against its plain version on the same inputs. Returns (launches, the
    binned kernel's rows)."""
    from tpugan_tpu_torch import DT
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.cli.eval_fluid import SYNTH_DIR
    from tpugan_tpu_torch.data.fluid import SiamFluidDataset
    from tpugan_tpu_torch.data.sampling import normalize_point_cloud
    from tpugan_tpu_torch.eval.analysis import (get_particle_density,
                                                particle_dns2grid_dns)
    from tpugan_tpu_torch.ops.kernels import binned_interp as BI
    from tpugan_tpu_torch.ops.kernels import interp as I

    with np.load(os.path.join(SYNTH_DIR, "case1", "data_1.npz")) as z:
        frame, vel = normalize_point_cloud(z["pos"].astype(np.float32))[0], \
            z["vel"].astype(np.float32)
    gt = SiamFluidDataset(SYNTH_DIR, 1, 8, sample_num=9216,
                          seed=0)[0]["highres_pos"][1]
    model = load_srnet(CHECKPOINT, device=dev)
    pos = torch.from_numpy(frame)[None].to(dev)
    feat = torch.cat([pos, torch.from_numpy(vel)[None].to(dev) * DT], -1)
    cutoff = DENSITY_CUTOFF
    torch.cuda.synchronize()

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, padded, valid = model(feat, pos)
    pred = padded[0][valid[0]].cpu().numpy()
    dns = get_particle_density(pred, cutoff, device=dev)
    lo, hi = pred.min(0), pred.max(0)
    axes = [np.linspace(lo[a], hi[a], DENSITY_GRID, dtype=np.float32)
            for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    gdns = particle_dns2grid_dns(grid, pred, cutoff, device=dev)
    capped = get_particle_density(gt, cutoff, dense=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    expect(launches, DENSITY_LAUNCHES, "density phase")
    # a particle's own weight is 1: exactly in the exact form (direct
    # differences), and to within the spline's slope times the kNN's
    # rounding of a zero distance (2.4e-7 of |p|^2) in the capped form
    own_capped = 1.0 - 6.0 * 2.4e-7 * float((gt ** 2).sum(-1).max()) / cutoff ** 2
    if not (dns.shape == (pred.shape[0], 1) and gdns.shape == (len(grid), 1)
            and capped.shape == (gt.shape[0], 1)
            and all(np.isfinite(a).all() for a in (dns, gdns, capped))
            and dns.min() >= 1.0 - 1e-5 and capped.min() >= own_capped):
        raise AssertionError(
            f"density phase: densities not finite or below a particle's own "
            f"weight: {dns.min()}, {capped.min()} (limit {own_capped})")

    # the capped form against the kNN's plain version (on the CPU): their
    # d2 = |q|^2 + |c|^2 - 2 q.c round in another order (2.4e-7 of max
    # |p|^2), which the spline's slope in d2 (at most 6 / cutoff^2) carries
    # into each in-radius neighbour's weight
    plain_capped = get_particle_density(gt, cutoff, dense=False, device="cpu")
    gq = torch.from_numpy(gt).to(dev)
    n_max = int((torch.cdist(gq, gq) < cutoff).sum(-1).max())
    cap_tol = n_max * 6.0 / cutoff ** 2 * 2.4e-7 * float((gt ** 2).sum(-1).max())
    cap_err = float(np.abs(capped - plain_capped).max())
    summary = {"phase": "density", "slots": int(padded.shape[1]),
               "kept": int(pred.shape[0]), "grid_points": int(len(grid)),
               "cutoff": cutoff, "wall_s": wall, "launches": launches,
               "density_mean": float(dns.mean()),
               "grid_density_max": float(gdns.max()),
               "capped_patch_points": int(gt.shape[0]),
               "capped_in_radius_max": n_max, "capped_max_abs_err": cap_err,
               "capped_tol": cap_tol}
    if cap_err > cap_tol:
        emit(summary)
        raise AssertionError(f"capped density vs plain: {cap_err} > {cap_tol}")

    rows = []
    rng = np.random.default_rng(4)
    cand = torch.from_numpy(pred)[None].to(dev)
    bias = torch.zeros(cand.shape[:2], device=dev)
    # the density calls pass zero values (C = 1); a random field makes the
    # kernel's numerator checkable at the same shapes
    vals = torch.from_numpy(rng.standard_normal((1, pred.shape[0], 1))
                            .astype(np.float32)).to(dev)
    for name, q_np in (("frame", pred), ("grid", grid)):
        q = torch.from_numpy(q_np)[None].to(dev)
        cells = BI.build_grid(cand, vals, bias, cutoff)
        ok, dk = BI.binned_interp_launch(q, cells, cutoff, "spline1")
        op, dp = BI.binned_interp_plain(q, cells, cutoff, "spline1")
        od, dd = I.interp_kernel(q, cand, vals, cutoff, bias, "spline1")
        torch.cuda.synchronize()
        scale = float(vals.abs().max())
        err = max(float((ok - op).abs().max()), float((ok - od).abs().max()))
        den_rel = max(float(((dk - dp).abs() / dp).max()),
                      float(((dk - dd).abs() / dd).max()))
        walked, pairs = (t.float() for t in BI.pair_counts(q, cells, cutoff))
        ms = time_ms(lambda: BI.binned_interp_launch(q, cells, cutoff,
                                                     "spline1"), torch)
        grid_ms = time_ms(lambda: BI.build_grid(cand, vals, bias, cutoff),
                          torch)
        plain_ms = time_ms(lambda: BI.binned_interp_plain(q, cells, cutoff,
                                                          "spline1"),
                           torch, reps=3, warmup=1)
        dense_ms = time_ms(lambda: I.interp_kernel(q, cand, vals, cutoff,
                                                   bias, "spline1"),
                           torch, reps=3, warmup=1)
        nq, m = q.shape[1], cand.shape[1]
        # the function's work: about 20 f32 operations and a square root
        # per pair within the cutoff, and one FMA per value channel; the
        # walked pairs (the 27 cells') are the design's overhead
        b_ms, b_by = bound(22.0 * float(pairs.sum()),
                           4 * (3 * nq + 4 * m + m + 2 * nq), "f32")
        rows.append(dict(call=name, Nq=nq, M=m, C=1, cutoff=cutoff,
                         grid_dims=list(cells.dims), per_density=1,
                         in_radius_mean=float(pairs.mean()),
                         in_radius_max=int(pairs.max()),
                         walked_mean=float(walked.mean()),
                         walked_max=int(walked.max()),
                         max_abs_err=err, den_max_rel_err=den_rel, ms=ms,
                         grid_build_ms=grid_ms, plain_ms=plain_ms,
                         dense_kernel_ms=dense_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "binned_interp", **rows[-1]})
        if not (err <= 1e-5 * scale and den_rel <= 1e-5
                and bool(torch.isfinite(ok).all())):
            raise AssertionError(f"binned_interp {name}: err {err}, den rel "
                                 f"{den_rel}")
    emit(summary)
    return launches, rows


def eval_card_vs_cpu(torch, dev):
    """position_metrics (a masked, padded prediction), cycle_consistency
    (a fixed stand-in for the generator) and the exact density on fixed
    small clouds from a seed, on the card and on the CPU."""
    from tpugan_tpu_torch.data.sampling import pad_with_appropriate_size
    from tpugan_tpu_torch.eval.analysis import (cycle_consistency,
                                                get_particle_density,
                                                position_metrics)

    rng = np.random.default_rng(3)
    cloud = lambda *s, scale=0.3: (rng.standard_normal(s) * scale
                                   ).astype(np.float32)
    gt = cloud(1, 2048, 3)
    pred, valid = pad_with_appropriate_size(gt[0, :1800] + cloud(1800, 3,
                                                                 scale=0.01))
    low, vel = cloud(2, 1, 256, 3), cloud(2, 1, 256, 3, scale=1.0)
    high, adv = cloud(1, 2048, 3), cloud(1, 2048, 3, scale=0.01)
    offsets = cloud(4, 3, scale=0.02)
    dens_pts = (rng.random((6000, 3)) * 0.4).astype(np.float32)

    def run(d):
        t = lambda a: torch.from_numpy(a).to(d)

        def sr_apply(feature, p):
            scale = 1.0 + feature[..., 3:].abs().sum(-1, keepdim=True)
            out = p[:, :, None] + t(offsets) * scale[:, :, None]
            return out.reshape(p.shape[0], -1, 3)

        kw = dict(emd_iters=300, emd_eps=0.01)
        pm = position_metrics(t(pred[None]), t(gt), pred_valid=t(valid[None]),
                              **kw)
        cc = cycle_consistency(sr_apply, t(low[0]), t(low[1]), t(adv), t(high),
                               cutoff=0.1, use_vel=True,
                               lowres_vel_left=t(vel[0]),
                               lowres_vel_right=t(vel[1]), **kw)
        return pm, cc, get_particle_density(dens_pts, 0.05, dense=True,
                                            device=d)

    (pm_g, cc_g, dn_g), (pm_c, cc_c, dn_c) = run(dev), run("cpu")

    def cd_tol(n_terms, n_div, r2max):
        # each nearest distance rounds to within 2.4e-7 of max |p|^2
        return n_terms * 2.4e-7 * float(r2max) / n_div

    out = {"phase": "eval_cpu",
           "position": {"card": pm_g, "cpu": pm_c},
           "cycle": {"card": cc_g, "cpu": cc_c},
           "density_max_rel_err": float(np.max(np.abs(dn_g - dn_c) / dn_c))}
    emit(out)
    checks = [
        abs(pm_g[0] - pm_c[0]) <= cd_tol(1800 + 2048, 2048,
                                         (gt ** 2).sum(-1).max()),
        # the stand-in and the advection move points by under 0.2
        abs(cc_g[0] - cc_c[0]) <= cd_tol(2 * 1024, 1024,
                                         3 * (np.abs(low).max() + 0.2) ** 2),
        abs(pm_g[1] - pm_c[1]) <= EMD_RTOL * abs(pm_c[1]),
        abs(cc_g[1] - cc_c[1]) <= EMD_RTOL * abs(cc_c[1]),
        abs(pm_g[2] - pm_c[2]) <= MMD_RTOL * abs(pm_c[2]) + 1e-7,
        abs(cc_g[2] - cc_c[2]) <= MMD_RTOL * abs(cc_c[2]) + 1e-7,
        out["density_max_rel_err"] <= 1e-5]
    if not all(checks):
        raise AssertionError(f"eval card vs CPU: checks {checks}")


def kernel_line(groups):
    """One entry per kernel. ``groups``: (name, source, replaces, rows,
    weight keys, what the times sum over, launches by path); times are sums
    over the shapes, each weighted by the sum of its weight keys (how often
    it runs in the unit the times are given for); launches are those of
    every counted path."""
    def total(rows, key, weights):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * sum(r.get(w, 0) for w in weights) for r in rows)

    entries = []
    for name, source, replaces, rows, weights, per, by_path in groups:
        by = {r["bound_by"] for r in rows}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total(rows, "ms", weights),
            "plain_ms": total(rows, "plain_ms", weights),
            "bound_ms": total(rows, "bound_ms", weights),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": total(rows, "library_ms", weights),
            "times_are": per, "launches_by_path": by_path})
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one forward of each serving mode, and "
                         "write the profile tables into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build
    from tpugan_tpu_torch.ops.kernels import (ball_query, binned_interp,
                                              edgeconv, fps, interp, knn, nn1,
                                              pooled_mlp)

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    build_s = _build.build_all()
    f32t_ptxas = ptxas_summary("edgeconv", "edgeconv_f32t_kernel")
    # the f32 EdgeConv backward on GEMM tiles (csrc/edgeconv.cu : bwdt)
    bwdt_ptxas = {f: ptxas_summary("edgeconv", f)
                  for f in ("bwd_rows", "dw_gemm", "bwd_ties", "bwd_gctr")}
    # the pooled-MLP batch-norm form's GEMM blocks
    pmlp_ptxas = {f: ptxas_summary("pooled_mlp", f)
                  for f in ("rows_gemm", "dw_gemm", "top_kernel")}
    # the FPS kernel's two variants, every points-per-thread instance
    fps_ptxas = {f: ptxas_summary("fps", f) for f in ("fps_warp", "fps_cluster")}
    for name, rep in [("edgeconv_f32t_kernel", f32t_ptxas),
                      *bwdt_ptxas.items(), *pmlp_ptxas.items(),
                      *fps_ptxas.items()]:
        if rep["functions"] == 0 or rep["spill_store_bytes"]:
            raise AssertionError(f"{name} ptxas: {rep}")
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {n: ptxas_summary(n) for n in _build.sources()},
          "ptxas_edgeconv_tc": ptxas_summary("edgeconv", "edgeconv_tc_kernel"),
          "ptxas_edgeconv_f32t": f32t_ptxas,
          "ptxas_edgeconv_bwd_tiled": bwdt_ptxas,
          "ptxas_pooled_mlp": pmlp_ptxas,
          "ptxas_fps": fps_ptxas,
          "ptxas_knn_approx": ptxas_summary("knn", "knn_approx_kernel")})

    kernels = {"knn": knn.KERNEL, "edgeconv": edgeconv.KERNEL,
               "edgeconv_bwd": edgeconv.BWD, "nn1": nn1.KERNEL,
               "fps": fps.KERNEL, "ball_query": ball_query.KERNEL,
               "pooled_mlp_fwd": pooled_mlp.FWD, "pooled_mlp_bwd": pooled_mlp.BWD,
               "pooled_mlp_affine_bwd": pooled_mlp.AFFINE_BWD,
               "interp": interp.KERNEL, "binned_interp": binned_interp.KERNEL,
               "knn_approx": knn.APPROX}
    rng = np.random.default_rng(0)
    knn_rows = check_knn(torch, dev, rng)
    approx_rows = check_knn_approx(torch, dev, rng)
    ec_rows = check_edgeconv(torch, dev, rng)
    nn1_rows = check_nn1(torch, dev, rng)
    fps_rows = check_fps(torch, dev, rng)
    bq_rows = check_ball_query(torch, dev, rng)
    pf_rows, pb_rows = check_pooled_mlp(torch, dev, rng)
    ip_rows = check_interp(torch, dev, rng)
    eb_rows = check_edgeconv_bwd(torch, dev, rng)
    ab_rows = check_pooled_affine_bwd(torch, dev, rng)

    # the serving path: counts start at 0 here and are read after the rollout
    for k in kernels.values():
        k.launches = 0
    edgeconv.TC_LAUNCHES = edgeconv.F32_TILED_LAUNCHES = 0
    (f32, bf16), (feat, pos, pos_np) = serving(torch, dev, kernels)
    rollout(torch, bf16, kernels)
    serving_launches = counts(kernels)
    serving_variants = {"tc": edgeconv.TC_LAUNCHES,
                        "f32t": edgeconv.F32_TILED_LAUNCHES}

    # checks and timings past the counted run
    result = cpu_reference(torch, dev, pos_np)
    result["f32_dynamic_ms_per_frame"] = time_ms(lambda: f32(feat, pos), torch)
    result["bf16_static_ms_per_frame"] = time_ms(lambda: bf16(feat, pos), torch)
    emit({"phase": "timing", **result})
    if args.profile:
        profile(torch, "f32_dynamic", f32, feat, pos, args.profile)
        profile(torch, "bf16_static", bf16, feat, pos, args.profile)

    # the approximate serving path: counts start at 0 here and are read
    # after its rollout
    for k in kernels.values():
        k.launches = 0
    approx_line = serving_approx(torch, (f32, bf16), feat, pos, kernels)
    rollout(torch, bf16, kernels, approx=True)
    serving_approx_launches = counts(kernels)
    for name, model in (("f32_dynamic", f32), ("bf16_static", bf16)):
        approx_line[name]["ms_per_frame"] = approx_ms(torch, model, feat, pos)
    emit(approx_line)
    del f32, bf16

    # the train path: counts reset to 0 inside, read after its 4 steps; its
    # peak memory from here (resuming the trainer state included)
    torch.cuda.reset_peak_memory_stats()
    train_launches, _ = train(torch, dev, kernels, args.profile)
    train_card_vs_cpu(torch, dev)

    # the fused-train path: the CLI twin with the switch on (counts reset
    # inside, read after each step and after the CLI returns)
    fused_launches = fused_train(torch, dev, kernels)
    fused_vs_grouped(torch, dev, args.profile)

    # the eval path (counts reset inside, read after each sample), then the
    # densities (reset inside, read before the kernel comparisons)
    eval_launches = eval_phase(torch, kernels)
    eval_approx_launches = eval_approx(torch, kernels)
    density_launches, bi_rows = density_phase(torch, dev, kernels)
    eval_card_vs_cpu(torch, dev)

    by_path = {n: {"serving": serving_launches[n], "train": train_launches[n],
                   "train_fused": fused_launches[n], "eval": eval_launches[n],
                   "density": density_launches[n],
                   "serving_approx": serving_approx_launches[n],
                   "eval_approx": eval_approx_launches[n]}
               for n in kernels}
    ec_f32 = [r for r in ec_rows if r["dtype"] == "f32"]
    pallas = "tpugan_tpu/ops/pallas/"
    step = ("per_step",), "one G+D train step"
    line = kernel_line([
        ("knn", "tpugan_tpu_torch/csrc/knn.cu", pallas + "knn_kernel.py:351",
         knn_rows, ("per_forward", "per_step", "per_sample", "per_density"),
         "one f32 dynamic forward (7 graphs) plus one G+D train step "
         "(7 generator graphs, 9 flow embeddings) plus the eval sample's "
         "capped interpolation plus the capped density", by_path["knn"]),
        ("knn_approx", "tpugan_tpu_torch/csrc/knn.cu",
         pallas + "knn_kernel.py:351 (approx=True)", approx_rows,
         ("per_forward", "per_static", "per_frame"),
         "one f32 dynamic forward (7 graphs) plus one bf16 static forward "
         "(1) plus one rollout frame (1), with the approximate graph kNN on",
         by_path["knn_approx"]),
        ("edgeconv", "tpugan_tpu_torch/csrc/edgeconv.cu",
         pallas + "edgeconv_kernel.py:358", ec_f32, ("per_forward",),
         "one f32 dynamic forward (9 EdgeConvs)", by_path["edgeconv"]),
        ("edgeconv_bwd", "tpugan_tpu_torch/csrc/edgeconv.cu",
         pallas + "edgeconv_kernel.py:277", eb_rows, ("per_step",),
         "one fused train step (9 EdgeConv backwards, f32)",
         by_path["edgeconv_bwd"]),
        ("nn1", "tpugan_tpu_torch/csrc/nn1.cu", pallas + "nn1_kernel.py:124",
         nn1_rows, ("per_gate", "per_step", "per_sample"),
         "one Chamfer gate (2 directions) plus one train step (Chamfer, "
         "masking target) plus one eval sample (4 directions)",
         by_path["nn1"]),
        ("fps", "tpugan_tpu_torch/csrc/fps.cu", pallas + "fps_kernel.py:152",
         fps_rows, *step, by_path["fps"]),
        ("ball_query", "tpugan_tpu_torch/csrc/ball_query.cu",
         pallas + "ball_query_kernel.py:57", bq_rows, *step,
         by_path["ball_query"]),
        ("pooled_mlp_fwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:624", pf_rows, *step,
         by_path["pooled_mlp_fwd"]),
        ("pooled_mlp_bwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:519", pb_rows, *step,
         by_path["pooled_mlp_bwd"]),
        ("pooled_mlp_affine_bwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:499", ab_rows, ("per_check",),
         "one call at each of sa_0 and group_all (no main path runs it)",
         by_path["pooled_mlp_affine_bwd"]),
        ("interp", "tpugan_tpu_torch/csrc/interp.cu",
         pallas + "interp_kernel.py:89", ip_rows, *step, by_path["interp"]),
        ("binned_interp", "tpugan_tpu_torch/csrc/binned_interp.cu",
         pallas + "binned_interp_kernel.py:333", bi_rows, ("per_density",),
         "one density phase (the frame's and the grid's exact densities)",
         by_path["binned_interp"]),
    ])
    # the pooled-MLP and FPS rows' device time (torch.profiler) per G+D
    # step, the EdgeConv backward's per fused step, and its launches on
    # GEMM tiles
    device_rows = {"pooled_mlp_fwd": pf_rows, "pooled_mlp_bwd": pb_rows,
                   "edgeconv_bwd": eb_rows, "fps": fps_rows}
    for entry in line["kernels"]:
        if entry["name"] in device_rows:
            entry["device_ms"] = sum(r["device_ms"] * r["per_step"]
                                     for r in device_rows[entry["name"]])
        if entry["name"] == "edgeconv_bwd":
            entry["train_fused_tiled_launches"] = fused_launches[
                "edgeconv_bwd_tiled"]
    # the EdgeConv forward's times per bf16 static forward beside the f32's
    ec_bf16 = [r for r in ec_rows if r["dtype"] == "bf16"]
    ec_entry = next(e for e in line["kernels"] if e["name"] == "edgeconv")
    ec_entry["bf16_static"] = {
        key: sum(r[key] * r["per_forward"] for r in ec_bf16)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ec_entry["bf16_static"]["times_are"] = (
        "one bf16 static forward (9 EdgeConvs, 3 on the tensor-core kernel)")
    # of the serving path's EdgeConv launches, those of each kernel variant
    ec_entry["serving_launches_by_variant"] = {
        **serving_variants,
        "simt": by_path["edgeconv"]["serving"] - sum(serving_variants.values())}
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
