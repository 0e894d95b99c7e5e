#!/usr/bin/env python3
"""The one-rank fluid train step of two checkouts on one CUDA card: the
first step's losses bit for bit and every step's launches.

    python3 tools/compare_train_steps_torch.py --base runs/parent

Runs ``chip_smoke.train`` (the train_vel trainer resumed from
``checkpoints/fluid_vel_20k.ckpt``, 4 full-width steps from the same draws
and batches) in a process of its own in each checkout, in the order base,
head, head, base. Every run's first step starts from the same state, so
its losses repeat bit for bit within a checkout; later steps differ from
run to run (the plain versions' atomic scatter-adds), and are compared by
their launches only. Prints one JSON line per run (its steps' losses,
launches and ms), then one with the verdict: the first step's losses
equal in every run and the launches of every step equal, then the card's
name and power limit. Exits 1 when either differs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as C; "
        "C.train(torch, torch.device('cuda', 0), C._kernels())")
LOSSES = ("tempo_G_loss", "tempo_D_loss", "Chamfer_distance_no_norm",
          "masking_loss", "spatial_G_loss", "spatial_D_loss", "gate")


def run(checkout: str) -> list:
    out = subprocess.run([sys.executable, "-c", CODE], cwd=checkout,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise SystemExit(f"{checkout}: exit {out.returncode}\n"
                         f"{out.stderr[-4000:]}")
    steps = []
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if obj.get("phase") == "train" and "iteration" in obj:
                steps.append(obj)
    return steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="the other checkout (unpacked with git archive)")
    args = ap.parse_args()
    order = [("base", args.base), ("head", ROOT), ("head", ROOT),
             ("base", args.base)]
    runs = []
    for name, path in order:
        steps = run(os.path.abspath(path))
        runs.append(steps)
        print(json.dumps({"checkout": name, "steps": [
            {"iteration": s["iteration"], "launches": s["launches"],
             "ms": s["ms"], **{k: s[k] for k in LOSSES if k in s}}
            for s in steps]}), flush=True)
    first = [{k: s[0][k] for k in LOSSES if k in s[0]} for s in runs]
    same_first = all(f == first[0] for f in first)
    same_launches = all([s["launches"] for s in r] ==
                        [s["launches"] for s in runs[0]] for r in runs)
    print(json.dumps({"first_step_losses_equal": same_first,
                      "launches_equal_every_step": same_launches,
                      "first_step": first[0]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0 if same_first and same_launches else 1


if __name__ == "__main__":
    sys.exit(main())
