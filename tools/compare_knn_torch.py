#!/usr/bin/env python3
"""Per-shape times of two checkouts' kNN kernels (``tpugan_tpu_torch``) on
one CUDA card.

    python3 tools/compare_knn_torch.py --base DIR [--head DIR] [--out FILE]

Runs ``chip_smoke.check_knn`` of each checkout in a process of its own, in
the order base, head, head, base, so that both see the same card and a drift
of its clocks falls on both. Each process builds its checkout's kernels,
checks its kNN kernel against the plain version at every ``KNN_SHAPES`` row
and times the kernel, the plain version and ``cdist`` + ``topk`` (CUDA-event
medians). Prints one JSON line per shape with both checkouts' times (the
mean of their two runs), then one line with the sums weighted by the
launches of one f32 dynamic serving forward, one G+D train step, one eval
sample and one density phase, and last the card's name and power limit.
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
print(json.dumps({{"ptxas": chip_smoke.ptxas_summary("knn")}}), flush=True)
chip_smoke.check_knn(torch, torch.device("cuda", 0), np.random.default_rng(0))
"""

KEY = ("path", "B", "Nq", "Nc", "D", "k")
PER = ("per_forward", "per_step", "per_sample", "per_density")


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=root)],
                         cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: check_knn failed\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    rows, ptxas = {}, None
    for line in out.stdout.splitlines():
        obj = json.loads(line)
        if "ptxas" in obj:
            ptxas = obj["ptxas"]
        elif obj.get("kernel") == "knn" and "path" in obj:
            rows[tuple(obj[k] for k in KEY)] = obj
    return {"ptxas": ptxas, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="checkout to compare with")
    ap.add_argument("--head", default=".", help="checkout under test")
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    args = ap.parse_args(argv)
    roots = {"base": os.path.abspath(args.base), "head": os.path.abspath(args.head)}
    runs = [(name, run(roots[name])) for name in ("base", "head", "head", "base")]
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"checkout": n, "ptxas": r["ptxas"],
                        "rows": list(r["rows"].values())} for n, r in runs], f)
    for name in ("base", "head"):
        print(json.dumps({"checkout": name, "root": roots[name],
                          "ptxas": next(r["ptxas"] for n, r in runs if n == name)}))
    sums = {f"{name}_{col}": {p: 0.0 for p in PER}
            for name in ("base", "head") for col in ("ms", "library_ms")}
    for key, first in runs[0][1]["rows"].items():
        line = dict(zip(KEY, key))
        line.update({p: first[p] for p in PER})
        line["bound_ms"] = first["bound_ms"]
        for name in ("base", "head"):
            got = [r["rows"][key] for n, r in runs if n == name]
            for col in ("ms", "plain_ms", "library_ms"):
                line[f"{name}_{col}"] = sum(g[col] for g in got) / len(got)
            line[f"{name}_max_abs_err"] = max(g["max_abs_err"] for g in got)
            for col in ("ms", "library_ms"):
                for p in PER:
                    sums[f"{name}_{col}"][p] += line[f"{name}_{col}"] * first[p]
        print(json.dumps(line))
    print(json.dumps({"sums": sums}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
