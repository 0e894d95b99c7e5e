#!/usr/bin/env python3
"""Device time of the approximate kNN kernel (``csrc/knn.cu : approx``)
under every launch shape it is built for, at the shapes the main paths give
it, and the cost of its final selection, on one CUDA card.

    python3 tools/knn_approx_sweep_torch.py [--out FILE] [--repeats N]

First, per instance of the kernel, the count of its SASS conversion and
tensor-core instructions (``cuobjdump -sass`` of the built library):
packed ``F2FP`` rounds two distances, a scalar ``F2F`` would round one on
the conversion pipe. Then the plans: each row of
``chip_smoke.APPROX_SHAPES`` (seeded clouds as in
``chip_smoke.check_knn_approx``) and the eval sample's 4,096-point graphs
at D = 3, 32 and 64, under every ``ApproxPlan`` (WQ = 2, 5), each launch
held against ``knn_approx_plain`` by ``knn.approx_agreement``. One JSON
line per (shape, plan): the device time by kernel (torch.profiler), the
blocks, waves and model cost, whether it is the wrapper's choice; then per
shape the fastest beside the wrapper's. This is the measurement
``knn_approx_plan`` rests on.

Then the selection: at a 10,240-point graph with D and the plan held fixed,
the main kernel's device time as k varies within one kp (k rounds of the
final selection, the same lists), over ``--repeats`` rounds of every k in
turn. One line per (D, kp) with the least-squares slope (us a selection
round) over all readings and the slope of each round alone, and the
selection's share of the kernel at the path's k. Last, the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

EVAL_APPROX_GRAPHS = [("eval 4,096", 4096, 3, 20, 0),
                      ("eval 4,096", 4096, 32, 20, 0),
                      ("eval 4,096", 4096, 64, 12, 0)]


def _summary(rows, key):
    timed = [r for r in rows if r["device_ms"]]
    return {**key, "fastest": min(timed, key=lambda r: r["device_ms"]),
            "plan": next(r for r in rows if r["is_plan"])}


def _time(torch, run):
    """Device ms of run() in total and by kernel; a profile that lost every
    kernel record reads 0 and is taken once more (None: not measured)."""
    total, by = chip_smoke.device_ms(run, torch, by_kernel=True)
    if not total:
        total, by = chip_smoke.device_ms(run, torch, by_kernel=True)
    return total or None, by


def sweep_approx(torch, dev, rng, sms):
    from tpugan_tpu_torch import PAD_SENTINEL
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows, best = [], []
    shapes = [(g, n, d, k, pad) for g, n, d, k, pad, *_ in chip_smoke.APPROX_SHAPES]
    for graph, n, d, k, pad in shapes + EVAL_APPROX_GRAPHS:
        scale = 0.3 if d == 3 else 1.0
        c_np = (rng.standard_normal((1, n, d)) * scale).astype(np.float32)
        c_np[:, n - pad:] = PAD_SENTINEL
        c = torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((1, n), device=dev)
        want = K.knn_approx_plain(c, c, bias, k)
        real = n - pad
        mine = K.knn_approx_plan(1, n, n, d, k, sms)
        plans = [K.ApproxPlan(wq) for wq in sorted(K.APPROX_BLOCKS_PER_SM)]
        key = dict(kernel="knn_approx", graph=graph, Nq=n, D=d, k=k)
        shape_rows = []
        for plan in plans:
            run = lambda: K._launch_approx(c, c, bias, k, plan)
            got = run()
            torch.cuda.synchronize()
            agree = K.approx_agreement(
                (got[0][:, :real], got[1][:, :real]),
                (want[0][:, :real], want[1][:, :real]),
                (c[:, :real], c[:, :real], bias[:, :real]))
            if not (agree["d2_excess"] <= 0 and agree["d2_unexplained"] == 0
                    and agree["rows_unexplained"] == 0
                    and agree["rows"] <= 0.02 * agree["queries"]):
                raise AssertionError(f"knn approx {graph} D={d} {plan}: {agree}")
            ms, by = _time(torch, run)
            shape_rows.append(dict(
                key, wq=plan.wq, queries=plan.queries,
                threads=plan.threads, blocks=plan.blocks(1, n),
                blocks_per_sm=plan.per_sm, waves=plan.waves(1, n, sms),
                model_cost=K._approx_cost(plan, 1, n, sms), device_ms=ms,
                device_ms_by_kernel=by, rows_differ=agree["rows"],
                is_plan=plan == mine))
            print(json.dumps(shape_rows[-1]), flush=True)
        rows += shape_rows
        best.append(_summary(shape_rows, key))
    return rows, best


# (D, the path's k at that D, the k of one kp bucket): the selection's k
# rounds vary, the lists and the product do not
SELECTION = [(3, 20, (16, 20, 24, 28, 32)), (32, 20, (16, 20, 24, 28, 32)),
             (64, 12, (4, 6, 8, 10, 12, 14))]
SELECTION_N = 10240


def _slope(ks, ms):
    """Least-squares slope of ms over k (readings the profiler lost, NaN,
    left out)."""
    k, m = np.asarray(ks, float), np.asarray(ms, float)
    k, m = k[np.isfinite(m)], m[np.isfinite(m)]
    return float(((k - k.mean()) * (m - m.mean())).sum() / ((k - k.mean()) ** 2).sum())


def sweep_selection(torch, dev, rng, sms, repeats):
    from tpugan_tpu_torch.ops.kernels import knn as K

    n, out = SELECTION_N, []
    for d, k_path, ks in SELECTION:
        c = torch.from_numpy((rng.standard_normal((1, n, d))
                              * (0.3 if d == 3 else 1.0)).astype(np.float32)).to(dev)
        bias = torch.zeros((1, n), device=dev)
        plan = K.knn_approx_plan(1, n, n, d, k_path, sms)
        assert all(K.chunk_kp_approx(k) == K.chunk_kp_approx(k_path) for k in ks)
        reads = {k: [] for k in ks}
        for _ in range(repeats):
            for k in ks:        # every k in turn, each round
                _, by = _time(torch, lambda: K._launch_approx(c, c, bias, k, plan))
                ms = sum(v for name, v in by.items() if "approx_kernel" in name)
                reads[k].append(ms or float("nan"))
        per_round = [_slope(ks, [reads[k][r] for k in ks]) * 1e3
                     for r in range(repeats)]
        slope = _slope([k for k in ks for _ in range(repeats)],
                       [v for k in ks for v in reads[k]]) * 1e3
        at_path = float(np.nanmean(reads[k_path])) if k_path in reads else None
        out.append(dict(kernel="knn_approx", selection=True, Nq=n, D=d,
                        kp=K.chunk_kp_approx(k_path), wq=plan.wq, k=list(ks),
                        kernel_ms_mean=[float(np.nanmean(reads[k])) for k in ks],
                        kernel_ms_min=[float(np.nanmin(reads[k])) for k in ks],
                        kernel_ms_max=[float(np.nanmax(reads[k])) for k in ks],
                        us_a_round=slope, us_a_round_each_repeat=per_round,
                        path_k=k_path, path_kernel_ms=at_path,
                        path_selection_share=(slope * k_path / 1e3 / at_path
                                              if at_path else None)))
        print(json.dumps(out[-1]), flush=True)
    return out


def sass_counts(lib: str) -> list:
    """Per approx_kernel instance in ``lib``: its F2F, F2FP and HMMA
    instruction counts."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True).stdout
    rows = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "approx_kernel" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", fn)
        rows.append({"sass": name, **{op: ops.count(op)
                                      for op in ("F2F", "F2FP", "HMMA")}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every row here (JSON)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="rounds of every k in the selection measurement")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("knn_approx_sweep: no CUDA device", file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build

    _build.build_all()
    for row in sass_counts(str(_build._lib_path("knn"))):
        print(json.dumps(row), flush=True)
    dev, rng = torch.device("cuda", 0), np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, best = sweep_approx(torch, dev, rng, sms)
    for s in best:
        print(json.dumps({"best": s}), flush=True)
    rows += sweep_selection(torch, dev, rng, sms, args.repeats)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
