#!/usr/bin/env python3
"""Per-shape times of two checkouts' kNN, fused-EdgeConv forward or
backward, pooled-MLP or FPS kernels (``tpugan_tpu_torch``) on one CUDA card.

    python3 tools/compare_knn_torch.py --base DIR [--head DIR]
                                       [--check knn|edgeconv|edgeconv_bwd|
                                                pooled_mlp|fps]
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
not report it). For the pooled MLP each process then runs
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
}


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


def run(root: str, kernel: str) -> dict:
    code = CHILD.format(root=root, kernel=kernel,
                        source=kernel.replace("_bwd", ""))
    if kernel == "pooled_mlp":
        code += POOLED_CHILD.format() + POOLED_DIGEST.format()
    elif kernel == "edgeconv_bwd":
        code += EDGECONV_BWD_CHILD.format()
    elif kernel == "fps":
        code += (FPS_CHILD.format(edge=chip_smoke.FPS_EDGE_SHAPES)
                 + TRAIN_CHILD.format())
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: check_{kernel} failed\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    key, names = CHECKS[kernel][0], CHECKS[kernel][3]
    rows, ptxas, train, affine, digests, step = {}, None, [], [], {}, None
    device, per_step = {}, {}
    for line in out.stdout.splitlines():
        obj = json.loads(line)
        if "ptxas" in obj:
            ptxas = obj["ptxas"]
        elif "digest" in obj:
            name = " / ".join(obj["digest"])
            digests[name] = obj["sha"]
            if "device_ms" in obj:
                device[name] = obj["device_ms"]
            if "per_step" in obj:
                per_step[name] = obj["per_step"]
        elif "fused_step" in obj:
            step = obj
        elif "affine_device" in obj:
            affine.append(obj)
        elif obj.get("phase") == "train":
            train.append(obj)
        elif (obj.get("kernel") in names and "case" not in obj
              and all(k in obj for k in key)):
            rows[tuple(obj[k] for k in key)] = obj
    return {"ptxas": ptxas, "rows": rows,
            "train": _train_summary(train) if train else None,
            "affine_device": affine, "digests": digests, "fused_step": step,
            "device_ms": device, "per_step": per_step}


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
    runs = [(name, run(roots[name], args.check))
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
    if args.check in ("pooled_mlp", "fps"):   # every run's train step
        print(json.dumps({"train": [dict(checkout=n, **r["train"])
                                    for n, r in runs]}))
    if args.check == "pooled_mlp":
        print(json.dumps({"affine_device": [dict(checkout=n, rows=r["affine_device"])
                                            for n, r in runs]}))
    if args.check in ("edgeconv_bwd", "fps"):
        # each row's device time on the digest's inputs (torch.profiler;
        # the mean of a checkout's two runs)
        dev = {}
        for n, r in runs:
            for row, ms in r["device_ms"].items():
                dev.setdefault(row, {}).setdefault(n, []).append(ms)
        mean = {row: {n: sum(v) / len(v) for n, v in d.items()}
                for row, d in dev.items()}
        print(json.dumps({"device_ms": {
            row: {**d, "head_over_base": d["head"] / d["base"]}
            for row, d in mean.items()}}))
    if args.check == "fps":   # the digest rows' device time per G+D step
        weight = runs[0][1]["per_step"]
        print(json.dumps({"device_ms_per_step": {
            n: sum(mean[row][n] * w for row, w in weight.items())
            for n in ("base", "head")}}))
    if args.check == "edgeconv_bwd":   # every run's fused and grouped step
        print(json.dumps({"fused_step": [dict(checkout=n, **r["fused_step"])
                                         for n, r in runs]}))
    if args.check in ("edgeconv_bwd", "pooled_mlp", "fps"):
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
