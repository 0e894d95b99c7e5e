#!/usr/bin/env python3
"""Per-shape times of two checkouts' kNN (exact or approximate),
fused-EdgeConv forward or backward, pooled-MLP, FPS, ball query, nn1 or
dense interp kernels (``tpugan_tpu_torch``) on one CUDA card.

    python3 tools/compare_knn_torch.py --base DIR [--head DIR]
                                       [--check knn|knn_approx|edgeconv|
                                                edgeconv_bwd|pooled_mlp|fps|
                                                ball_query|nn1|interp|
                                                binned_interp]
                                       [--out FILE]

Runs ``chip_smoke.check_knn`` (or ``check_edgeconv``, or
``check_pooled_mlp`` and ``check_pooled_affine_bwd``) of each checkout in a
process of its own, in the order base, head, head, base, so that both see
the same card and a drift of its clocks falls on both. Each process builds
its checkout's kernels, checks the kernel against the plain version at every
row of the check (``KNN_SHAPES``, ``EDGECONV_SHAPES`` in f32 and bf16, or
``POOLED_SHAPES`` forward and backward and the affine form's rows) and
times the kernel, the plain version and, for kNN, ``cdist`` + ``topk``
(CUDA-event medians); for EdgeConv and the pooled MLP also the device time
of the wrapper's launches (torch.profiler; None for a checkout that does
not report it). For the exact kNN each process also prints, on inputs of
the tool's own seed (the same in both checkouts), a digest of the
distances and indices at every ``KNN_SHAPES`` row, and the tool prints
which digests agree. For the pooled MLP each process then runs
``chip_smoke.train`` (the train_vel step resumed from the checkpoint, 4
steps) and reports the G+D and G-only steps' ms (CUDA events) and wall ms,
and the peak device memory of the process; then the affine form's device
time at ``AFFINE_SHAPES`` (forward and backward, the same inputs in both
checkouts). Prints one JSON line per shape
with both checkouts' times (the mean of their two runs), then one line with
the sums weighted by the launches of each unit of work: for kNN one f32
dynamic serving forward, one G+D train step, one eval sample and one
density phase; for EdgeConv one f32 dynamic and one bf16 static serving
forward; for the pooled MLP the forward and the backward of one G+D step.

``--check edgeconv`` also prints, on inputs of the tool's own seed, each
``EDGECONV_SHAPES`` row's device time and output digest in f32 and bf16
and their device-time sums per f32 dynamic and per bf16 static forward;
then per checkout ``chip_smoke.serving``'s gate, ms per frame of both
serving modes (CUDA events, autograd off), three profiles of one forward
of each mode (``chip_smoke.profile``: wall ms, kernel ms, idle share) and
``chip_smoke.serving_approx``'s line (``chamfer_norm_vs_exact``).

``--check edgeconv_bwd`` runs ``chip_smoke.check_edgeconv_bwd`` (every
``EDGECONV_BWD_SHAPES`` row: ms, device ms, plain ms, the row's path),
sums them per fused train step, then ``chip_smoke.fused_vs_grouped`` (one
train step with the fused-EdgeConv switch off and on: ms a step of both,
G only and G+D, and the process's peak device memory). For
``edgeconv_bwd`` and ``pooled_mlp`` each process also prints a digest
(SHA-256) of the kernels' outputs on the same seeded inputs at every row
(the EdgeConv backward's gradients, with their device time; the pooled
MLP's outputs and gradients, both forms), and the tool prints which rows
give the same digest in both checkouts (a change that leaves a kernel's
results as they were shows equal digests) and, for the EdgeConv backward,
each row's device time in both.

``--check fps`` runs ``chip_smoke.check_fps`` (every ``FPS_SHAPES`` stage,
weighted by its launches per G+D step: ms, device ms, plain ms), then on
inputs of its own seed, the same in both checkouts, each stage's and each
tie and exhaustion row's device time and a digest of its indices, then
``chip_smoke.train`` as for the pooled MLP (the G+D and G-only steps' ms
and the peak device memory). The tool prints each row's device time in both
checkouts and their sum per G+D step, and which digests agree.

``--check nn1`` runs ``chip_smoke.check_nn1`` (every ``NN1_SHAPES`` row,
weighted by its launches per Chamfer gate, train step and eval sample: ms,
device ms, plain ms, ``cdist`` + ``min``), then on inputs of the tool's own
seed, the same in both checkouts, each row's device time and digests of its
distances and indices, then ``chip_smoke.serving`` (the serving gate's
``chamfer_norm``, with digests of the gate's two nn1 calls' distances and
indices) and ``chip_smoke.train``. ``--check interp`` runs
``chip_smoke.check_interp``, then the device time and output digest of the
random-order row on the tool's own inputs and of the train step's own call
(``chip_smoke.train_interp_case``, made once by the head checkout and read
by both from ``runs/compare_interp_train.pt``), each with its error against
the plain version, then ``chip_smoke.train``. Both print each digest row's
device time in both checkouts and their sum per unit of work (nn1: one gate
+ train step + eval sample; interp: one G+D step).

``--check knn_approx`` runs ``chip_smoke.check_knn_approx`` (every
``APPROX_SHAPES`` row: ms, plain ms, ``cdist`` + ``topk``; a head that
reports them adds the device ms and the plan), then on inputs of the
tool's own seed, the same in both checkouts, each row's device time, the
exact kernel's device time on the same inputs and a digest of the result
(d2 and idx, which carry the keys); each checkout saves its results, and
where the digests differ the tool holds head against base by
``knn.approx_agreement`` (the digests may differ only where it explains
it); then ``chip_smoke.serving_approx`` and ``chip_smoke.approx_ms`` (the
gate and ms per frame, f32 dynamic and bf16 static, with the approximate
graph kNN on). ``--check ball_query`` runs ``chip_smoke.check_ball_query``
(every ``BALL_SHAPES`` row: ms, plain ms), then on the tool's own inputs
each stage's device time and index digest (which must be equal), then
``chip_smoke.train``. Both print each digest row's device time in both
checkouts and their sum per unit of work (knn_approx: one f32 dynamic +
bf16 static forward + rollout frame; ball_query: one G+D step).

``--check binned_interp`` runs the head's ``chip_smoke.check_binned_interp``
against each checkout's kernel (the function uses only what both
checkouts' ``binned_interp`` modules have) on the density phase's two
calls, made once by the head (``chip_smoke.binned_case``: the trained
SRNet's kept points on a synthetic 12,000-particle frame, and the 32^3 grid
over them) into ``runs/compare_binned_case.pt``: each call's ms, device ms
(by kernel), plain ms, walked and in-radius pairs, the head's tiles, and a
digest of (out, den). It prints each call's device time in both checkouts,
their sums per density phase (the two calls), and which digests agree.
Last comes the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
import chip_smoke
from tpugan_tpu_torch import _build
_build.build_all()
print(json.dumps({{"ptxas": chip_smoke.ptxas_summary({source!r})}}), flush=True)
dev, rng = torch.device("cuda", 0), np.random.default_rng(0)
chip_smoke.check_{kernel}(torch, dev, rng)
"""

# a digest of the outputs of each row on inputs drawn from one seed
DIGEST = """
import hashlib
def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
g = np.random.default_rng(7)
t = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32)).to(dev)
"""

EDGECONV_BWD_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import edgeconv as E
b, n = chip_smoke.TRAIN_ROWS, chip_smoke.TRAIN_POINTS
for name, c, h, o, k, agg, mlp, kind, ties, per in chip_smoke.EDGECONV_BWD_SHAPES:
    cdt = torch.float32 if kind == "f32" else torch.bfloat16
    args = (t(b, k, n, c).to(cdt), t(b, n, c).to(cdt), t(c, h) / c ** .5,
            t(c, h) / c ** .5, t(h, h) / h ** .5 if mlp else None,
            t(h, o) / h ** .5 if mlp else None, t(b, n, o if mlp else h).to(cdt),
            agg, cdt)
    sha = digest(E.edgeconv_backward(*args))
    dev_ms = chip_smoke.device_ms(lambda: E.edgeconv_backward(*args), torch)
    print(json.dumps({{"digest": [name, kind], "sha": sha,
                      "device_ms": dev_ms}}), flush=True)
torch.cuda.reset_peak_memory_stats()
step = chip_smoke.fused_vs_grouped(torch, dev)
print(json.dumps({{"fused_step": {{k: step[k] for k in ("fused_ms", "grouped_ms")}},
                  "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}),
      flush=True)
"""

POOLED_DIGEST = DIGEST + """
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P
for stage, shape, widths, slope, per, gammas in chip_smoke.POOLED_SHAPES:
    cs = (shape[-1],) + tuple(widths)
    nl = len(widths)
    leaves = [x.requires_grad_() for x in
              [t(*shape)] + [t(cs[i], cs[i + 1]) / cs[i] ** .5 for i in range(nl)]
              + [1 + 0.1 * t(w) for w in widths] + [0.1 * t(w) for w in widths]]
    pooled, mus, vars_ = P.pooled_mlp_bn_train(
        leaves[0], leaves[1:1 + nl], leaves[1 + nl:1 + 2 * nl],
        leaves[1 + 2 * nl:], slope)
    grads = torch.autograd.grad(pooled, leaves, t(*pooled.shape))
    print(json.dumps({{"digest": [stage, "bn_train"],
                      "sha": digest([pooled, *mus, *vars_, *grads])}}), flush=True)
for stage, shape, widths, slope in chip_smoke.AFFINE_SHAPES:
    cs = (shape[-1],) + tuple(widths)
    nl = len(widths)
    leaves = [x.requires_grad_() for x in
              [t(*shape)] + [t(cs[i], cs[i + 1]) / cs[i] ** .5 for i in range(nl)]
              + [1 + 0.1 * t(w) for w in widths] + [0.1 * t(w) for w in widths]]
    out = P.pooled_mlp_affine(leaves[0], leaves[1:1 + nl],
                              leaves[1 + nl:1 + 2 * nl], leaves[1 + 2 * nl:], slope)
    grads = torch.autograd.grad(out, leaves, t(*out.shape))
    print(json.dumps({{"digest": [stage, "affine"],
                      "sha": digest([out, *grads])}}), flush=True)
"""

# chip_smoke.train (4 resumed train_vel steps) with the launch counters of
# every kernel
TRAIN_CHILD = """
from tpugan_tpu_torch.ops.kernels import (ball_query, binned_interp, edgeconv,
                                          fps, interp, knn, nn1, pooled_mlp)
kernels = {{"knn": knn.KERNEL, "edgeconv": edgeconv.KERNEL,
           "edgeconv_bwd": edgeconv.BWD, "nn1": nn1.KERNEL, "fps": fps.KERNEL,
           "ball_query": ball_query.KERNEL, "pooled_mlp_fwd": pooled_mlp.FWD,
           "pooled_mlp_bwd": pooled_mlp.BWD,
           "pooled_mlp_affine_bwd": pooled_mlp.AFFINE_BWD,
           "interp": interp.KERNEL, "binned_interp": binned_interp.KERNEL,
           "knn_approx": knn.APPROX}}
chip_smoke.train(torch, dev, kernels)
"""

# the pooled MLP: its affine form's backward rows, then the train step
POOLED_CHILD = """
chip_smoke.check_pooled_affine_bwd(torch, dev, rng)
""" + TRAIN_CHILD + """
# the affine form's device time (torch.profiler), the same inputs in both
# checkouts: its CUDA-event rows above carry the host's time too
g = np.random.default_rng(1)
for stage, shape, widths, slope in chip_smoke.AFFINE_SHAPES:
    t = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32)).to(dev)
    cs = (shape[-1],) + tuple(widths)
    ws = [t(cs[i], cs[i + 1]) / cs[i] ** 0.5 for i in range(len(widths))]
    a_s = [1 + 0.1 * t(h) for h in widths]
    b_s = [0.1 * t(h) for h in widths]
    leaves = [x.requires_grad_() for x in [t(*shape), *ws, *a_s, *b_s]]
    nl = len(widths)
    args = (leaves[0], leaves[1:1 + nl], leaves[1 + nl:1 + 2 * nl],
            leaves[1 + 2 * nl:], slope)
    with torch.no_grad():
        fwd = chip_smoke.device_ms(lambda: pooled_mlp.pooled_mlp_affine(*args), torch)
    out = pooled_mlp.pooled_mlp_affine(*args)
    cot = t(*out.shape)
    bwd = chip_smoke.device_ms(lambda: torch.autograd.grad(
        out, leaves, cot, retain_graph=True), torch)
    print(json.dumps({{"affine_device": stage, "fwd_device_ms": fwd,
                      "bwd_device_ms": bwd}}), flush=True)
"""


# FPS: each stage of the train step (weighted by its launches per G+D step)
# and this checkout's rows of exact ties and of exhausted valid points
# (chip_smoke.FPS_EDGE_SHAPES, weight 0), on inputs drawn here, the same in
# both checkouts: device time and indices' digest
FPS_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import fps as F
cases = list(chip_smoke.FPS_SHAPES) + [(*e, 0) for e in {edge!r}]
for stage, b, n, m, masked, per in cases:
    pos, pen, n_valid = 0.3 * t(b, n, 3), torch.zeros(b, n, device=dev), n
    if masked == "lattice":
        pos = torch.from_numpy(0.25 * g.integers(-16, 17, (b, n, 3))
                               .astype(np.float32)).to(dev)
    elif masked is True:
        n_valid = n - n // 8
        pen[:, n_valid:], pos[:, n_valid:] = -1e10, 999.0
    elif masked:
        n_valid = masked
        pen[:, n_valid:] = -1e10
        pos[:, n_valid:] *= 1000.0
    start = torch.from_numpy(g.integers(0, n_valid, b)).to(dev)
    run = lambda: F.fps_kernel(pos, m, pen, start)
    print(json.dumps({{"digest": [stage], "sha": digest([run()]),
                      "device_ms": chip_smoke.device_ms(run, torch),
                      "per_step": per}}), flush=True)
"""


# nn1: each NN1_SHAPES row (head's list) on inputs drawn here, the same in
# both checkouts: device time and digests of distances and indices; then the
# serving gate, its two nn1 calls' digests recorded
NN1_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import nn1 as N1
for path, b, nq, m, masked, q_tail, per_gate, per_step, per_sample in {shapes!r}:
    q, c = 0.3 * t(b, nq, 3), 0.3 * t(b, m, 3)
    q[:, nq - q_tail:] = 999.0
    bias = torch.zeros(b, m, device=dev)
    if masked:
        bias[:, -masked:] = 1e10
    run = lambda: N1.nn1_kernel(q, c, bias)
    d2, idx = run()
    name = f"{{path}} {{b}}x{{nq}}x{{m}} masked {{masked}} sentinel {{q_tail}}"
    print(json.dumps({{"digest": [name, "d2"], "sha": digest([d2])}}), flush=True)
    print(json.dumps({{"digest": [name, "idx"], "sha": digest([idx]),
                      "device_ms": chip_smoke.device_ms(run, torch),
                      "per_step": per_gate + per_step + per_sample}}), flush=True)
import tpugan_tpu_torch.ops.metrics as metrics
own, gate = metrics.nn1_kernel, []
def recording(*a, **kw):
    out = own(*a, **kw)
    gate.append(out)
    return out
metrics.nn1_kernel = recording
(f32, bf16), _ = chip_smoke.serving(torch, dev, {{"nn1": N1.KERNEL}})
metrics.nn1_kernel = own
for i, (d2, idx) in enumerate(gate):
    print(json.dumps({{"digest": [f"serving gate call {{i}}", "d2"], "sha": digest([d2])}}))
    print(json.dumps({{"digest": [f"serving gate call {{i}}", "idx"], "sha": digest([idx])}}))
del f32, bf16
"""

# the dense interp: the random-order row on inputs drawn here and the train
# step's own call from the head's file, the same in both checkouts
INTERP_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import interp as I
cand = 0.3 * t(12, 9216, 3)
query = cand + 0.01 * t(12, 9216, 3)
query[:, -9216 // 10:] = 999.0
cases = [("random", query, cand, 0.025 * t(12, 9216, 3),
          torch.zeros(12, 9216, device=dev), 0.16, "bicubic", 0),
         ("train", *[x.to(dev) if torch.is_tensor(x) else x
                     for x in torch.load({case!r})], 1)]
for layout, q, c, v, bias, cutoff, kind, per in cases:
    run = lambda: I.interp_kernel(q, c, v, cutoff, bias, kind)
    out, den = run()
    op, dp = I.interp_plain(q, c, v, cutoff, bias, kind)
    print(json.dumps({{"digest": [layout], "sha": digest([out, den]),
                      "device_ms": chip_smoke.device_ms(run, torch),
                      "max_abs_err": float((out - op).abs().max()),
                      "tol": 1e-5 * float(v.abs().max()),
                      "den_max_rel_err": float(((den - dp).abs() / dp.abs()).max()),
                      "per_step": per}}), flush=True)
"""

# the approximate kNN: each APPROX_SHAPES row on inputs drawn here, the same
# in both checkouts: device time of it and of the exact kernel, a digest of
# its result, the results saved for the agreement check; then the
# approximate serving frames
KNN_APPROX_CHILD = DIGEST + """
from tpugan_tpu_torch import PAD_SENTINEL
from tpugan_tpu_torch.ops.kernels import edgeconv, knn as K, nn1
saved = []
for graph, n, d, k, pad, per_fwd, per_static, per_frame in chip_smoke.APPROX_SHAPES:
    c = t(1, n, d) * (0.3 if d == 3 else 1.0)
    c[:, n - pad:] = PAD_SENTINEL
    bias = torch.zeros(1, n, device=dev)
    run = lambda: K.knn_approx_kernel(c, c, bias, k)
    d2, idx = run()
    name = f"{{graph}} D={{d}} k={{k}}"
    print(json.dumps({{"digest": [name], "sha": digest([d2, idx]),
                      "device_ms": chip_smoke.device_ms(run, torch),
                      "exact_device_ms": chip_smoke.device_ms(
                          lambda: K.knn_kernel(c, c, bias, k), torch),
                      "per_step": per_fwd + per_static + per_frame}}), flush=True)
    saved.append((name, c.cpu(), bias.cpu(), d2.cpu(), idx.cpu(), pad))
torch.save(saved, {saved!r})
kernels = {{"knn": K.KERNEL, "edgeconv": edgeconv.KERNEL, "nn1": nn1.KERNEL,
           "knn_approx": K.APPROX}}
(f32, bf16), (feat, pos, _) = chip_smoke.serving(torch, dev, kernels)
line = chip_smoke.serving_approx(torch, (f32, bf16), feat, pos, kernels)
for name, model in (("f32_dynamic", f32), ("bf16_static", bf16)):
    line[name]["ms_per_frame"] = chip_smoke.approx_ms(torch, model, feat, pos)
print(json.dumps({{"serving_approx": {{m: line[m] for m in ("f32_dynamic", "bf16_static")}}}}),
      flush=True)
"""

# the fused-EdgeConv forward: each EDGECONV_SHAPES row in f32 and bf16 on
# inputs drawn here, the same in both checkouts: device time and a digest of
# the output; then the serving frames (the gate, ms per frame of each mode
# with autograd off, PROFILES profiles of one forward of each mode) and the
# approximate serving line (its chamfer_norm_vs_exact)
PROFILES = 3
EDGECONV_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import edgeconv as E, knn as K, nn1
n = chip_smoke.N_POINTS
for name, c, h, o, k, agg, mlp, per in chip_smoke.EDGECONV_SHAPES:
    for cdt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args = (t(1, k, n, c).to(cdt), t(1, n, c).to(cdt), t(c, h) / c ** .5,
                t(c, h) / c ** .5, t(h, h) / h ** .5 if mlp else None,
                t(h, o) / h ** .5 if mlp else None, agg, cdt)
        run = lambda: E.edgeconv_fused(*args)
        print(json.dumps({{"digest": [name, kind], "sha": digest([run()]),
                          "device_ms": chip_smoke.device_ms(run, torch),
                          "dtype": kind, "per_forward": per}}), flush=True)
kernels = {{"knn": K.KERNEL, "edgeconv": E.KERNEL, "nn1": nn1.KERNEL,
           "knn_approx": K.APPROX}}
(f32, bf16), (feat, pos, _) = chip_smoke.serving(torch, dev, kernels)
frames = {{}}
with torch.no_grad():
    for mode, model in (("f32_dynamic", f32), ("bf16_static", bf16)):
        frames[mode] = chip_smoke.time_ms(lambda: model(feat, pos), torch)
print(json.dumps({{"serving_frames": frames}}), flush=True)
for _ in range({profiles}):
    for mode, model in (("f32_dynamic", f32), ("bf16_static", bf16)):
        chip_smoke.profile(torch, mode, model, feat, pos,
                           os.path.join({root!r}, "runs", "compare_profile"))
line = chip_smoke.serving_approx(torch, (f32, bf16), feat, pos, kernels)
print(json.dumps({{"serving_approx": {{m: line[m] for m in ("f32_dynamic", "bf16_static")}}}}),
      flush=True)
"""

# the exact kNN: each KNN_SHAPES row on inputs drawn here, the same in both
# checkouts: a digest of its distances and indices
KNN_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import knn as K
for path, b, nq, nc, d, k, self_graph, *_ in chip_smoke.KNN_SHAPES:
    c = t(b, nc, d)
    q = c[:, :nq] if self_graph else t(b, nq, d)
    bias = torch.zeros(b, nc, device=dev)
    print(json.dumps({{"digest": [f"{{path}} {{b}}x{{nq}}x{{nc}} D={{d}} k={{k}}"],
                      "sha": digest(K.knn_kernel(q, c, bias, k))}}), flush=True)
"""

# the ball query: each BALL_SHAPES stage on inputs drawn here, the same in
# both checkouts: device time and index digest
BALL_CHILD = DIGEST + """
from tpugan_tpu_torch.ops.kernels import ball_query as BQ
for stage, b, nq, nc, r, ns, per in chip_smoke.BALL_SHAPES:
    cand = 0.3 * t(b, nc, 3)
    query = cand[:, torch.from_numpy(g.permutation(nc)[:nq]).to(dev)]
    bias = torch.zeros(b, nc, device=dev)
    bias[:, ::9] = 2.0
    run = lambda: BQ.ball_query_kernel(query, cand, r, ns, bias)
    print(json.dumps({{"digest": [stage], "sha": digest([run()]),
                      "device_ms": chip_smoke.device_ms(run, torch),
                      "per_step": per}}), flush=True)
"""

# the cell-grid interp: the head's check on this checkout's kernel, on the
# density phase's two calls that the head saved
BINNED_CHILD = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
import torch
from tpugan_tpu_torch import _build
_build.build_all()
spec = importlib.util.spec_from_file_location("head_smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps({{"ptxas": smoke.ptxas_summary("binned_interp")}}), flush=True)
pred, grid = torch.load({case!r})
for row in smoke.check_binned_interp(torch, torch.device("cuda", 0),
                                     pred.numpy(), grid.numpy()):
    print(json.dumps({{"digest": [row["call"]], "sha": row["sha"],
                      "device_ms": row["device_ms"],
                      "per_step": row["per_density"]}}), flush=True)
"""

BINNED_CASE = """
import sys
sys.path.insert(0, {root!r})
import os, torch
import chip_smoke
pred, grid = chip_smoke.binned_case(torch, torch.device("cuda", 0),
                                    os.path.join({root!r}, "runs",
                                                 "compare_binned_synth"))
torch.save([torch.from_numpy(pred), torch.from_numpy(grid)], {path!r})
"""

# the train step's dense interp call, written once by the head checkout
INTERP_CASE = """
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
torch.save([x.cpu() if torch.is_tensor(x) else x for x in
            chip_smoke.train_interp_case(torch, torch.device("cuda", 0))], {path!r})
"""


def _edgeconv_weights(row):
    """Launches of the row's shape per f32 dynamic and per bf16 static
    forward (each serving mode runs every shape class in its own dtype)."""
    per = row["per_forward"]
    return {"per_f32_dynamic_forward": per if row["dtype"] == "f32" else 0,
            "per_bf16_static_forward": per if row["dtype"] == "bf16" else 0}


def _pooled_weights(row):
    """Launches of the row's shape per G+D step, forward and backward (the
    affine form's rows: no path of the step runs them)."""
    per = row.get("per_step", 0)
    return {"forward_per_step": per if row["kernel"] == "pooled_mlp_fwd" else 0,
            "backward_per_step": per if row["kernel"] == "pooled_mlp_bwd" else 0}


# per check: the row's key fields, its launches per unit of work, the
# columns it reports, the kernel names of its rows
CHECKS = {
    "knn": (("path", "B", "Nq", "Nc", "D", "k"),
            lambda row: {p: row[p] for p in ("per_forward", "per_step",
                                             "per_sample", "per_density")},
            ("ms", "plain_ms", "library_ms"), ("knn",)),
    "edgeconv": (("config", "dtype"), _edgeconv_weights,
                 ("ms", "device_ms", "plain_ms"), ("edgeconv",)),
    "edgeconv_bwd": (("config", "dtype"),
                     lambda row: {"per_fused_step": row["per_step"]},
                     ("ms", "device_ms", "plain_ms"), ("edgeconv_bwd",)),
    "pooled_mlp": (("kernel", "stage"), _pooled_weights,
                   ("ms", "device_ms", "plain_ms"),
                   ("pooled_mlp_fwd", "pooled_mlp_bwd", "pooled_mlp_affine",
                    "pooled_mlp_affine_bwd")),
    "fps": (("stage",), lambda row: {"per_step": row["per_step"]},
            ("ms", "device_ms", "plain_ms"), ("fps",)),
    "nn1": (("path", "B", "Nq", "M", "masked", "sentinel_queries"),
            lambda row: {p: row[p] for p in ("per_gate", "per_step",
                                             "per_sample")},
            ("ms", "device_ms", "plain_ms", "library_ms"), ("nn1",)),
    "interp": (("layout", "B", "Nq", "M", "C"),
               lambda row: {"per_step": row["per_step"]},
               ("ms", "device_ms", "plain_ms"), ("interp",)),
    "knn_approx": (("graph", "D", "k"),
                   lambda row: {"per_frame_unit": row["per_forward"]
                                + row["per_static"] + row["per_frame"]},
                   ("ms", "device_ms", "exact_ms", "plain_ms", "library_ms"),
                   ("knn_approx",)),
    "ball_query": (("stage",), lambda row: {"per_step": row["per_step"]},
                   ("ms", "device_ms", "plain_ms"), ("ball_query",)),
    "binned_interp": (("call",),
                      lambda row: {"per_density": row["per_density"]},
                      ("ms", "device_ms", "plain_ms"), ("binned_interp",)),
}
# a key field a checkout's rows may lack (the dense interp's rows before
# the train step's own call was added: the random-order row)
KEY_DEFAULTS = {"layout": "random"}


def _train_summary(lines):
    """The train phase's G+D and G-only steps (mean ms and wall ms) and the
    process's peak device memory."""
    steps = [o for o in lines if "iteration" in o]
    out = {}
    for name, want in (("gd", True), ("g_only", False)):
        sel = [o for o in steps if o["critic_update"] == want]
        out[f"{name}_steps"] = len(sel)
        for col in ("ms", "wall_ms"):
            out[f"{name}_{col}"] = (sum(o[col] for o in sel) / len(sel)
                                    if sel else None)
    out["peak_memory_gib"] = next(o["peak_memory_gib"] for o in lines
                                  if "peak_memory_gib" in o)
    return out


# the source whose ptxas report a check prints
SOURCES = {"knn_approx": "knn", "edgeconv_bwd": "edgeconv"}


def _saved(root: str) -> str:
    """Where a checkout's approximate-kNN results go (gitignored)."""
    return os.path.join(root, "runs", "compare_knn_approx.pt")


def run(root: str, kernel: str, case: str = "", smoke: str = "") -> dict:
    code = CHILD.format(root=root, kernel=kernel,
                        source=SOURCES.get(kernel, kernel))
    if kernel == "binned_interp":
        code = BINNED_CHILD.format(root=root, smoke=smoke, case=case)
    elif kernel == "pooled_mlp":
        code += POOLED_CHILD.format() + POOLED_DIGEST.format()
    elif kernel == "edgeconv_bwd":
        code += EDGECONV_BWD_CHILD.format()
    elif kernel == "fps":
        code += (FPS_CHILD.format(edge=chip_smoke.FPS_EDGE_SHAPES)
                 + TRAIN_CHILD.format())
    elif kernel == "nn1":
        code += (NN1_CHILD.format(shapes=chip_smoke.NN1_SHAPES)
                 + TRAIN_CHILD.format())
    elif kernel == "interp":
        code += INTERP_CHILD.format(case=case) + TRAIN_CHILD.format()
    elif kernel == "knn":
        code += KNN_CHILD.format()
    elif kernel == "knn_approx":
        os.makedirs(os.path.dirname(_saved(root)), exist_ok=True)
        code += KNN_APPROX_CHILD.format(saved=_saved(root))
    elif kernel == "ball_query":
        code += BALL_CHILD.format() + TRAIN_CHILD.format()
    elif kernel == "edgeconv":
        code += "import os\n" + EDGECONV_CHILD.format(profiles=PROFILES,
                                                       root=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: check_{kernel} failed\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    key, names = CHECKS[kernel][0], CHECKS[kernel][3]
    rows, ptxas, train, affine, digests, step = {}, None, [], [], {}, None
    device, per_step, errors, gate, exact, approx = {}, {}, {}, None, {}, None
    frames, profiles, weights = None, [], {}
    for line in out.stdout.splitlines():
        obj = json.loads(line)
        if "ptxas" in obj:
            ptxas = obj["ptxas"]
        elif "digest" in obj:
            name = " / ".join(obj["digest"])
            digests[name] = obj["sha"]
            if "device_ms" in obj:
                device[name] = obj["device_ms"]
            if "exact_device_ms" in obj:
                exact[name] = obj["exact_device_ms"]
            if "per_step" in obj:
                per_step[name] = obj["per_step"]
            if "per_forward" in obj:
                weights[name] = (obj["dtype"], obj["per_forward"])
            if "max_abs_err" in obj:
                errors[name] = {k: obj[k] for k in ("max_abs_err", "tol",
                                                    "den_max_rel_err")}
        elif "serving_approx" in obj:
            approx = obj["serving_approx"]
        elif "serving_frames" in obj:
            frames = obj["serving_frames"]
        elif obj.get("phase") == "profile":
            profiles.append(obj)
        elif obj.get("phase") == "serving":
            gate = obj["chamfer_norm"]
        elif "fused_step" in obj:
            step = obj
        elif "affine_device" in obj:
            affine.append(obj)
        elif obj.get("phase") == "train":
            train.append(obj)
        elif (obj.get("kernel") in names and "case" not in obj
              and all(k in obj or k in KEY_DEFAULTS for k in key)):
            rows[tuple(obj.get(k, KEY_DEFAULTS.get(k)) for k in key)] = obj
    return {"ptxas": ptxas, "rows": rows,
            "train": _train_summary(train) if train else None,
            "affine_device": affine, "digests": digests, "fused_step": step,
            "device_ms": device, "per_step": per_step, "errors": errors,
            "gate_chamfer_norm": gate, "exact_device_ms": exact,
            "serving_approx": approx, "serving_frames": frames,
            "profiles": profiles, "weights": weights}


def _agreement(head: str, base: str) -> dict:
    """Per approximate row whose results differ between the checkouts'
    saved files: ``knn.approx_agreement`` of head against base over the
    real (not sentinel) rows, and whether it explains the difference."""
    import torch

    from tpugan_tpu_torch.ops.kernels import knn as K

    out = {}
    for (name, c, bias, d2h, ih, pad), (_, cb, _, d2b, ib, _) in zip(
            torch.load(_saved(head)), torch.load(_saved(base))):
        if not torch.equal(c, cb):
            raise AssertionError(f"{name}: the checkouts drew other inputs")
        if torch.equal(d2h, d2b) and torch.equal(ih, ib):
            out[name] = {"equal": True}
            continue
        real = c.shape[1] - pad
        a = K.approx_agreement((d2h[:, :real], ih[:, :real]),
                               (d2b[:, :real], ib[:, :real]),
                               (c[:, :real], c[:, :real], bias[:, :real]))
        out[name] = {"equal": False, **a,
                     "sentinel_rows_equal": bool(
                         torch.equal(d2h[:, real:], d2b[:, real:])
                         and torch.equal(ih[:, real:], ib[:, real:])),
                     "explained": a["d2_excess"] <= 0
                     and a["d2_unexplained"] == 0
                     and a["rows_unexplained"] == 0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="checkout to compare with")
    ap.add_argument("--head", default=".", help="checkout under test")
    ap.add_argument("--check", choices=sorted(CHECKS), default="knn",
                    help="the kernel whose per-shape rows are compared")
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    args = ap.parse_args(argv)
    key, weights, cols, _ = CHECKS[args.check]
    roots = {"base": os.path.abspath(args.base), "head": os.path.abspath(args.head)}
    case = ""
    if args.check in ("interp", "binned_interp"):   # made by the head
        made = {"interp": ("compare_interp_train.pt", INTERP_CASE),
                "binned_interp": ("compare_binned_case.pt", BINNED_CASE)}
        name, script = made[args.check]
        case = os.path.join(roots["head"], "runs", name)
        os.makedirs(os.path.dirname(case), exist_ok=True)
        subprocess.run([sys.executable, "-c", script.format(
            root=roots["head"], path=case)], cwd=roots["head"], check=True)
    smoke = os.path.join(roots["head"], "chip_smoke.py")
    runs = [(name, run(roots[name], args.check, case, smoke))
            for name in ("base", "head", "head", "base")]
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"checkout": n, **r, "rows": list(r["rows"].values())}
                       for n, r in runs], f)
    for name in ("base", "head"):
        print(json.dumps({"checkout": name, "root": roots[name],
                          "ptxas": next(r["ptxas"] for n, r in runs if n == name)}))
    summed = [c for c in cols if c != "plain_ms"]
    sums = {f"{name}_{col}": {} for name in ("base", "head") for col in summed}
    bounds = {}
    for k, first in runs[0][1]["rows"].items():
        line = dict(zip(key, k))
        per = weights(first)
        line.update(per)
        line["bound_ms"] = first["bound_ms"]
        for name in ("base", "head"):
            got = [r["rows"][k] for n, r in runs if n == name]
            if args.check == "edgeconv":   # rows before the tc kernel: simt
                line[f"{name}_variant"] = got[0].get("variant", "simt")
            if args.check == "edgeconv_bwd":   # rows before the tiled path
                line[f"{name}_path"] = got[0].get("path", "general")
            for col in cols:   # a column the checkout does not report: None
                vals = [g.get(col) for g in got]
                line[f"{name}_{col}"] = (None if None in vals
                                         else sum(vals) / len(vals))
            line[f"{name}_max_abs_err"] = max(g["max_abs_err"] for g in got)
            for col in summed:
                acc = sums[f"{name}_{col}"]
                for p, n_launch in per.items():
                    if not n_launch:   # the row runs no time in this unit
                        continue
                    v = line[f"{name}_{col}"]
                    acc[p] = (None if v is None or acc.get(p, 0.0) is None
                              else acc.get(p, 0.0) + v * n_launch)
        for p, n_launch in per.items():
            bounds[p] = bounds.get(p, 0.0) + first["bound_ms"] * n_launch
        print(json.dumps(line))
    print(json.dumps({"sums": sums, "bound_ms": bounds}))
    if args.check in ("pooled_mlp", "fps", "nn1", "interp", "ball_query"):
        print(json.dumps({"train": [dict(checkout=n, **r["train"])
                                    for n, r in runs]}))
    if args.check == "pooled_mlp":
        print(json.dumps({"affine_device": [dict(checkout=n, rows=r["affine_device"])
                                            for n, r in runs]}))
    if args.check == "nn1":   # every run's serving gate
        print(json.dumps({"gate_chamfer_norm": [
            dict(checkout=n, chamfer_norm=r["gate_chamfer_norm"])
            for n, r in runs]}))
    if args.check == "interp":   # every run's error against the plain version
        print(json.dumps({"errors": [dict(checkout=n, **r["errors"])
                                     for n, r in runs]}))
    if args.check == "knn_approx":   # every run's approximate serving frames
        print(json.dumps({"serving_approx": [
            dict(checkout=n, **r["serving_approx"]) for n, r in runs]}))
        exact = {}
        for n, r in runs:
            for row, ms in r["exact_device_ms"].items():
                exact.setdefault(row, {}).setdefault(n, []).append(ms)
        print(json.dumps({"exact_device_ms": {
            row: {n: sum(v) / len(v) for n, v in d.items()}
            for row, d in exact.items()}}))
    if args.check in ("edgeconv_bwd", "fps", "nn1", "interp", "knn_approx",
                      "ball_query", "edgeconv", "binned_interp"):
        # each row's device time on the digest's inputs (torch.profiler;
        # the mean of a checkout's two runs)
        dev = {}
        for n, r in runs:
            for row, ms in r["device_ms"].items():
                dev.setdefault(row, {}).setdefault(n, []).append(ms)
        mean = {row: {n: sum(v) / len(v) for n, v in d.items()}
                for row, d in dev.items()}
        # (a row one checkout lacks, such as a case the head added: None)
        print(json.dumps({"device_ms": {
            row: {**d, "head_over_base": d["head"] / d["base"]
                  if "head" in d and "base" in d else None}
            for row, d in mean.items()}}))
    if args.check in ("fps", "nn1", "interp", "knn_approx", "ball_query",
                      "binned_interp"):
        # the digest rows' device time per unit of work (FPS, the ball query
        # and the dense interp: one G+D step; nn1: one gate + train step +
        # eval sample; knn_approx: one f32 dynamic + bf16 static forward +
        # rollout frame; binned_interp: one density phase)
        weight = runs[0][1]["per_step"]
        print(json.dumps({"device_ms_per_step": {
            n: sum(mean[row][n] * w for row, w in weight.items())
            for n in ("base", "head")}}))
    if args.check == "edgeconv":
        # the digest rows' device time per f32 dynamic and per bf16 static
        # forward; every run's gate, serving frames (ms, CUDA events) and
        # profiles (wall, kernels, idle share), and the approximate serving
        # line (chamfer_norm_vs_exact, keep-mask agreement)
        weight = runs[0][1]["weights"]
        print(json.dumps({"device_ms_per_forward": {
            n: {kind: sum(mean[row][n] * w for row, (k2, w) in weight.items()
                          if k2 == kind) for kind in ("f32", "bf16")}
            for n in ("base", "head")}}))
        for n, r in runs:
            print(json.dumps({"checkout": n, "gate_chamfer_norm":
                              r["gate_chamfer_norm"],
                              "serving_frames": r["serving_frames"],
                              "profiles": [{k: p[k] for k in (
                                  "forward", "wall_ms", "device_kernel_ms",
                                  "device_idle_share")} for p in r["profiles"]],
                              "serving_approx": r["serving_approx"]}))
    if args.check == "edgeconv_bwd":   # every run's fused and grouped step
        print(json.dumps({"fused_step": [dict(checkout=n, **r["fused_step"])
                                         for n, r in runs]}))
    if args.check == "knn_approx":   # where the digests differ: agreement
        print(json.dumps({"agreement_head_vs_base": _agreement(
            roots["head"], roots["base"])}))
    if args.check in ("knn", "edgeconv_bwd", "pooled_mlp", "fps", "nn1",
                      "interp", "knn_approx", "ball_query", "edgeconv",
                      "binned_interp"):
        # each row's digest per checkout; a checkout's two runs must agree
        shas = {}
        for n, r in runs:
            for row, sha in r["digests"].items():
                shas.setdefault(row, {}).setdefault(n, set()).add(sha)
        print(json.dumps({"digests": {
            row: {"base": sorted(d.get("base", ())), "head": sorted(d.get("head", ())),
                  "equal": d.get("base") == d.get("head") and len(d["base"]) == 1}
            for row, d in shas.items()}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
