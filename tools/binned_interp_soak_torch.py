#!/usr/bin/env python3
"""Soak the cell-grid interp kernel (``csrc/binned_interp.cu``) on the
inputs of ``tests/test_torch_port.py :
test_binned_interp_kernel_matches_plain_on_card`` and report every call
that misses its plain version.

    python3 tools/binned_interp_soak_torch.py [--calls 20000] [--sanitize]

Each case is built as the test builds it (a fresh ``default_rng(0)``: B = 2,
300 queries, 500 candidates, four queries at the 999 sentinel, every third
candidate masked). During the soak the wrapper's ``torch.empty`` fills
every buffer it hands out with junk (NaN for floats, all bits set for
integers): the kernel's outputs and scratch (out, den, keys, counters,
tiles; ``POISONED_BUFFERS`` a call, checked). PyTorch's caching allocator
would otherwise give each call the blocks the previous call freed, still
holding that call's right answers, and a word the kernel did not write
would read as right. Every call is held against the cell-grid plain
version and the dense plain version by the test's limits, and bit for bit
against the case's first call. The first case (bicubic, cutoff
0.16, C = 3) takes ``--calls`` calls, the others a tenth of that each.
``--sanitize`` also runs a short soak of the first case under
``compute-sanitizer --tool racecheck`` and ``--tool initcheck`` where the
CUDA toolkit has the tool, and reports what it printed. Prints one JSON
line per case and one for each sanitizer run; exits 1 if any call missed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = [("bicubic", 0.16, 3), ("spline1", 0.05, 1), ("linear", 0.6, 8),
         ("exponential", 0.01, 2)]
# torch.empty calls of one binned_interp_launch: out, den, keys, ctr, tiles
POISONED_BUFFERS = 5


class Poisoned:
    """``torch`` as a module sees it, except that ``empty`` fills each
    tensor it makes with junk: NaN for floats, all bits set for integers
    (an index of -1, and a NaN if read as a float)."""

    def __init__(self, torch):
        self._torch, self.buffers = torch, 0

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def empty(self, *args, **kw):
        t = self._torch.empty(*args, **kw)
        self.buffers += 1
        return t.fill_(float("nan") if t.is_floating_point() else -1)


def case_inputs(torch, c):
    """The test's inputs (its generator, its draws in its order)."""
    gen = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    q, cand, v = t(2, 300, 3) * 0.2, t(2, 500, 3) * 0.2, t(2, 500, c)
    q[:, :4] = 999.0
    bias = torch.zeros(2, 500)
    bias[:, ::3] = 1e10
    return q, cand, v, bias


def soak(torch, dev, kind, cutoff, c, calls):
    from tpugan_tpu_torch.ops.kernels import binned_interp as BI
    from tpugan_tpu_torch.ops.kernels import interp as IP

    q, cand, v, bias = case_inputs(torch, c)
    grid = BI.build_grid(cand, v, bias, cutoff)
    refs = [BI.binned_interp_plain(q, grid, cutoff, kind),
            IP.interp_plain(q, cand, v, cutoff, bias, kind)]
    atol_o = 1e-5 * float(v.abs().max())
    args = (q.to(dev), cand.to(dev), v.to(dev), cutoff, bias.to(dev), kind)
    first, misses, differ = None, [], 0
    worst = [0.0, 0.0]
    poisoned = Poisoned(torch)
    BI.torch = poisoned
    try:
        for i in range(calls):
            got = [x.cpu() for x in BI.binned_interp(*args)]
            if first is None:
                first = got
            elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                differ += 1
            for op, dp in refs:
                eo = float((got[0] - op).abs().max())
                ed = float(((got[1] - dp).abs() - 1e-5 * dp.abs()).max())
                worst = [max(worst[0], eo), max(worst[1], ed)]
                if not (eo <= atol_o and ed <= 1e-6):
                    bad = ((got[0] - op).abs() > atol_o).sum().item()
                    misses.append({"call": i, "out_err": eo,
                                   "den_err_over_rtol": ed,
                                   "outputs_off": bad})
    finally:
        BI.torch = torch
    return {"case": f"{kind}-{cutoff}-{c}", "calls": calls,
            "poisoned_buffers_per_call": poisoned.buffers / calls,
            "misses": len(misses), "first_misses": misses[:5],
            "calls_not_bit_equal_to_the_first": differ,
            "max_out_err": worst[0], "out_tol": atol_o,
            "max_den_err_over_rtol": worst[1], "den_atol": 1e-6}


def sanitize(calls):
    """This script's first case for ``calls`` calls under each tool."""
    exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    out = []
    for tool in ("racecheck", "initcheck"):
        if not os.path.exists(exe):
            out.append({"sanitizer": tool, "available": False, "path": exe})
            continue
        cmd = [exe, "--tool", tool, "--error-exitcode", "9", sys.executable,
               os.path.abspath(__file__), "--calls", str(calls), "--first_only"]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            rc, text = run.returncode, run.stdout + run.stderr
        except subprocess.TimeoutExpired as e:
            rc, text = "timeout", str(e.stdout or "") + str(e.stderr or "")
        out.append({"sanitizer": tool, "available": True, "rc": rc,
                    "tail": text.strip().splitlines()[-12:]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--first_only", action="store_true",
                    help="the first case alone (the sanitizer runs)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("binned_interp_soak: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    missed = 0
    cases = CASES[:1] if args.first_only else CASES
    for i, (kind, cutoff, c) in enumerate(cases):
        row = soak(torch, dev, kind, cutoff, c,
                   args.calls if i == 0 else max(1, args.calls // 10))
        missed += row["misses"] + row["calls_not_bit_equal_to_the_first"]
        missed += row["poisoned_buffers_per_call"] != POISONED_BUFFERS
        print(json.dumps(row), flush=True)
    if args.sanitize:
        for row in sanitize(max(1, args.calls // 200)):
            print(json.dumps(row), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
