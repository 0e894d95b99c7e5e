#!/usr/bin/env python3
"""Per-shape times of two checkouts' kNN or fused-EdgeConv forward kernels
(``tpugan_tpu_torch``) on one CUDA card.

    python3 tools/compare_knn_torch.py --base DIR [--head DIR]
                                       [--check knn|edgeconv] [--out FILE]

Runs ``chip_smoke.check_knn`` (or ``check_edgeconv``) of each checkout in a
process of its own, in the order base, head, head, base, so that both see
the same card and a drift of its clocks falls on both. Each process builds
its checkout's kernels, checks the kernel against the plain version at every
row of the check (``KNN_SHAPES``, or ``EDGECONV_SHAPES`` in f32 and bf16)
and times the kernel, the plain version and, for kNN, ``cdist`` + ``topk``
(CUDA-event medians); for EdgeConv also the device time of the wrapper's
launches (torch.profiler; None for a checkout that does not report it). Prints one JSON line per shape with both checkouts'
times (the mean of their two runs), then one line with the sums weighted by
the launches of each unit of work: for kNN one f32 dynamic serving forward,
one G+D train step, one eval sample and one density phase; for EdgeConv one
f32 dynamic and one bf16 static serving forward. Last comes the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
import chip_smoke
from tpugan_tpu_torch import _build
_build.build_all()
print(json.dumps({{"ptxas": chip_smoke.ptxas_summary({kernel!r})}}), flush=True)
chip_smoke.check_{kernel}(torch, torch.device("cuda", 0), np.random.default_rng(0))
"""


def _edgeconv_weights(row):
    """Launches of the row's shape per f32 dynamic and per bf16 static
    forward (each serving mode runs every shape class in its own dtype)."""
    per = row["per_forward"]
    return {"per_f32_dynamic_forward": per if row["dtype"] == "f32" else 0,
            "per_bf16_static_forward": per if row["dtype"] == "bf16" else 0}


# per check: the row's key fields, its launches per unit of work, the
# columns it reports
CHECKS = {
    "knn": (("path", "B", "Nq", "Nc", "D", "k"),
            lambda row: {p: row[p] for p in ("per_forward", "per_step",
                                             "per_sample", "per_density")},
            ("ms", "plain_ms", "library_ms")),
    "edgeconv": (("config", "dtype"), _edgeconv_weights,
                 ("ms", "device_ms", "plain_ms")),
}


def run(root: str, kernel: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=root, kernel=kernel)],
        cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: check_{kernel} failed\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    key = CHECKS[kernel][0]
    rows, ptxas = {}, None
    for line in out.stdout.splitlines():
        obj = json.loads(line)
        if "ptxas" in obj:
            ptxas = obj["ptxas"]
        elif (obj.get("kernel") == kernel and "case" not in obj
              and all(k in obj for k in key)):
            rows[tuple(obj[k] for k in key)] = obj
    return {"ptxas": ptxas, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="checkout to compare with")
    ap.add_argument("--head", default=".", help="checkout under test")
    ap.add_argument("--check", choices=sorted(CHECKS), default="knn",
                    help="the kernel whose per-shape rows are compared")
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    args = ap.parse_args(argv)
    key, weights, cols = CHECKS[args.check]
    roots = {"base": os.path.abspath(args.base), "head": os.path.abspath(args.head)}
    runs = [(name, run(roots[name], args.check))
            for name in ("base", "head", "head", "base")]
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"checkout": n, "ptxas": r["ptxas"],
                        "rows": list(r["rows"].values())} for n, r in runs], f)
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
            for col in cols:   # a column the checkout does not report: None
                vals = [g.get(col) for g in got]
                line[f"{name}_{col}"] = (None if None in vals
                                         else sum(vals) / len(vals))
            line[f"{name}_max_abs_err"] = max(g["max_abs_err"] for g in got)
            for col in summed:
                acc = sums[f"{name}_{col}"]
                for p, n_launch in per.items():
                    v = line[f"{name}_{col}"]
                    acc[p] = (None if v is None or acc.get(p, 0.0) is None
                              else acc.get(p, 0.0) + v * n_launch)
        for p, n_launch in per.items():
            bounds[p] = bounds.get(p, 0.0) + first["bound_ms"] * n_launch
        print(json.dumps(line))
    print(json.dumps({"sums": sums, "bound_ms": bounds}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
