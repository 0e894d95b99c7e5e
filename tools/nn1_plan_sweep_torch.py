#!/usr/bin/env python3
"""Device time of the nn1 and the dense interp kernels (``csrc/nn1.cu``,
``csrc/interp.cu``) under a range of launch shapes, at the shapes the main
paths give them, on one CUDA card.

    python3 tools/nn1_plan_sweep_torch.py [--out FILE]

For each shape of ``chip_smoke.NN1_SHAPES`` (seeded clouds as in
``chip_smoke.check_nn1``, no masks) it runs the wrapper's own plan
(``ops/kernels/nn1.py : nn1_plan``), the simple rule of :func:`simple_rule`
and every plan of 64, 128 or 256 threads a block and 1 to 64 candidate
splits, each with the cost ``nn1_plan``'s model gives it; for the dense
interp the random-order row of ``chip_smoke.check_interp`` and the train
step's own call (``chip_smoke.train_interp_case``) under 64 to 256 threads
and 1 to 64 splits. Every launch is held against the plain version with
``chip_smoke``'s tolerances. Prints one JSON line per (shape, plan) with
the device time (torch.profiler), then per shape the fastest plan beside
the wrapper's and the simple rule's, then the card's name and power limit.
This is the measurement the two plans' constants rest on.
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

NN1_SPLITS = (1, 2, 4, 6, 8, 9, 10, 11, 12, 13, 14, 16, 18, 20, 24, 28, 32,
              36, 48, 64)
INTERP_SPLITS = (1, 2, 3, 5, 8, 12, 18, 24, 36, 48, 64)
THREADS = (64, 128, 256)


def _with_splits(make, m, splits, align):
    """make(splits, span) with ``splits`` ranges of ``align``-aligned spans,
    or None where that leaves a split empty."""
    span = align * -(-m // (splits * align))
    if (splits - 1) * span >= m:
        return None
    return make(splits, span)


def simple_rule(b, nq, m, sms):
    """The plan ``nn1_plan``'s model is held against: its block width, and
    the fewest candidate splits (spans of whole chunks) that give every SM
    two blocks."""
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    threads = N1.nn1_plan(b, nq, m, sms).threads
    want = -(-2 * sms // (b * -(-nq // (threads * N1.QPT))))
    span = N1.CHUNK * -(-m // (want * N1.CHUNK))
    return N1.Nn1Plan(threads, -(-m // span), span)


def _sweep(torch, name, key, run, check, plans, mine, model=None, rule=None):
    """Device ms of ``run(plan)`` for each plan; ``check(outputs)`` raises
    on a wrong result; ``model(plan)``, where given, the plan's modelled
    cost; ``rule``, where given, a plan to summarise beside ``mine``.
    Returns the rows and the shape's summary."""
    rows = []
    for plan in dict.fromkeys(plans + [mine] + ([rule] if rule else [])):
        check(run(plan))
        # a profile that lost every kernel record reads 0: not measured
        ms = (chip_smoke.device_ms(lambda: run(plan), torch)
              or chip_smoke.device_ms(lambda: run(plan), torch) or None)
        rows.append(dict(kernel=name, **key, threads=plan.threads,
                         splits=plan.splits, span=plan.span,
                         device_ms=ms, is_plan=plan == mine,
                         is_rule=plan == rule,
                         model_cost=model(plan) if model else None))
        print(json.dumps(rows[-1]), flush=True)
    fastest = min((r for r in rows if r["device_ms"]),
                  key=lambda r: r["device_ms"])
    planned = next(r for r in rows if r["is_plan"])
    summary = {"kernel": name, **key, "fastest": fastest, "plan": planned}
    if rule:
        summary["rule"] = next(r for r in rows if r["is_rule"])
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every row here (JSON)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nn1_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build
    from tpugan_tpu_torch.ops.kernels import interp as I
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    _build.build_all()
    dev, rng = torch.device("cuda", 0), np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, best = [], []
    for b, nq, m in dict.fromkeys((r[1], r[2], r[3])
                                  for r in chip_smoke.NN1_SHAPES):
        q_np = (rng.standard_normal((b, nq, 3)) * 0.3).astype(np.float32)
        c_np = (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32)
        q, c = torch.from_numpy(q_np).to(dev), torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((b, m), device=dev)
        d2p, ip = N1.nn1_plain(q, c, bias)
        tol = 1e-5 * 2 * float(max((q * q).sum(-1).max(), (c * c).sum(-1).max()))

        def check(out):
            _, gap = chip_smoke.index_gaps(q_np, c_np, out[1], ip)
            if float((out[0] - d2p).abs().max()) > tol or gap > 2 * tol:
                raise AssertionError(f"nn1 B={b} Nq={nq} M={m}: off the plain")

        plans = [p for t in THREADS for s in NN1_SPLITS
                 if (p := _with_splits(lambda s, span: N1.Nn1Plan(t, s, span),
                                       m, s, N1.CHUNK))]
        model = lambda p: N1._plan_cost(b, p.q_blocks(nq), p.threads, p.span,
                                        p.splits, sms)
        r, summary = _sweep(torch, "nn1", dict(B=b, Nq=nq, M=m),
                            lambda plan: N1._launch(q, c, bias, plan),
                            check, plans, N1.nn1_plan(b, nq, m, sms), model,
                            simple_rule(b, nq, m, sms))
        rows += r
        best.append(summary)

    cand = chip_smoke._cloud(torch, dev, rng, 12, 9216, 3)
    query = cand + chip_smoke._cloud(torch, dev, rng, 12, 9216, 3, scale=0.01)
    query[:, -9216 // 10:] = 999.0
    vals = chip_smoke._cloud(torch, dev, rng, 12, 9216, 3, scale=0.025)
    cases = [("random", query, cand, vals, torch.zeros((12, 9216), device=dev),
              0.16, "bicubic"),
             ("train", *chip_smoke.train_interp_case(torch, dev))]
    for layout, query, cand, vals, bias, cutoff, kind in cases:
        b, nq, m, c = query.shape[0], query.shape[1], cand.shape[1], vals.shape[-1]
        op, dp = I.interp_plain(query, cand, vals, cutoff, bias, kind)

        def check(out):
            if not (float((out[0] - op).abs().max()) <= 1e-5 * float(vals.abs().max())
                    and float(((out[1] - dp).abs() / dp.abs()).max()) <= 1e-5):
                raise AssertionError(f"interp {layout}: off the plain")

        plans = [p for t in THREADS for s in INTERP_SPLITS
                 if (p := _with_splits(lambda s, span: I.InterpPlan(t, s, span),
                                       m, s, 32))]
        r, summary = _sweep(
            torch, "interp", dict(layout=layout, B=b, Nq=nq, M=m, C=c),
            lambda plan: I._launch(query, cand, vals, cutoff, bias, kind, plan),
            check, plans, I.interp_plan(b, nq, m, c))
        rows += r
        best.append(summary)
    for line in best:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
