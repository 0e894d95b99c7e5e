#!/usr/bin/env python3
"""Device time of the FPS kernel (``csrc/fps.cu``) under every launch shape
it takes, at each of the train step's FPS stages, on one CUDA card.

    python3 tools/fps_plan_sweep_torch.py [--out FILE]

For each stage of ``chip_smoke.FPS_SHAPES`` (the same seeded inputs as
``chip_smoke.check_fps``) it runs the wrapper's own plan
(``ops/kernels/fps.py : fps_plan``), one warp a row where the row fits, and
clusters of 1, 2, 4, 8 and 16 blocks of 32 to 256 threads, each with the
least points a thread that covers the row; every launch must give the plain
version's indices. Prints one JSON line per (stage, shape) with the device
time (torch.profiler) and microseconds a round, then per stage the fastest
shape beside the plan's, then the card's name and power limit. This is the
measurement ``fps_plan``'s choices rest on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 16)
THREADS = (32, 64, 96, 128, 192, 256)


def shapes(F, n):
    """Every launch fps.cu takes for rows of n points, with the least
    points a thread, leaving out clusters of wholly empty blocks."""
    out = [F.FpsPlan("warp", 1, 32, -(-n // 32))] if n <= F.WARP_POINTS else []
    for c in CLUSTERS:
        for t in THREADS:
            plan = F.FpsPlan("cluster", c, t, -(-n // (c * t)))
            if plan.admits(n) and (c - 1) * plan.slice < n:
                out.append(plan)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every row here (JSON)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fps_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build
    from tpugan_tpu_torch.ops.kernels import fps as F

    _build.build_all()
    dev, rng = torch.device("cuda", 0), np.random.default_rng(0)
    rows, best = [], []
    for stage, b, n, m, masked, per in chip_smoke.FPS_SHAPES:
        pos, pen, start = chip_smoke._fps_case(torch, dev, rng, b, n, masked)
        want = F.fps_plain(pos, m, pen, start)
        mine = F.fps_plan(n)
        stage_rows = []
        for plan in shapes(F, n):
            run = lambda: F.fps_kernel(pos, m, pen, start, plan)
            bad = int((run() != want).sum())
            if bad:
                raise AssertionError(f"fps {stage} {plan}: {bad} indices differ")
            # a profile that lost every kernel record reads 0: not measured
            ms = (chip_smoke.device_ms(run, torch)
                  or chip_smoke.device_ms(run, torch) or None)
            stage_rows.append(dict(stage=stage, rows=b, N=n, m=m, per_step=per,
                                   variant=plan.variant, cluster=plan.cluster,
                                   threads=plan.threads, ppt=plan.ppt,
                                   device_ms=ms,
                                   us_per_round=ms and ms * 1e3 / (m - 1),
                                   is_plan=plan == mine))
            print(json.dumps(stage_rows[-1]), flush=True)
        fastest = min((r for r in stage_rows if r["device_ms"]),
                      key=lambda r: r["device_ms"])
        planned = next(r for r in stage_rows if r["is_plan"])
        best.append({"stage": stage, "fastest": fastest, "plan": planned})
        rows += stage_rows
    for line in best:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
