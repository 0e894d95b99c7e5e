#!/usr/bin/env python3
"""Wall ms per frame of the port's exact rollout at two frame alignments
(``tpugan_tpu_torch.eval.rollout.ALIGN``) on one CUDA card.

    python3 tools/compare_rollout_align_torch.py

Loads the bf16 static SRNet of ``checkpoints/fluid_vel_20k.ckpt``, builds
``chip_smoke.rollout_frames`` (25 frames of 10,000 - 8 (t mod 4) points)
and runs ``rollout_sequence`` over them with ``ALIGN`` set to 32 (its value
before the approximate kNN) and 128 in turn, in the order 32, 128, 128,
32, five times, after one warm-up rollout at each. The graph kNN stays
exact. Prints one JSON line per alignment (the padded rows, the real
outputs' largest difference from the first alignment's, each run's wall
ms per frame on the host clock and their median), then the card's name
and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIGNS = (32, 128)
REPS = 5


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    import tpugan_tpu_torch.eval.rollout as rollout_mod
    from tpugan_tpu_torch.checkpoint import load_srnet

    if not torch.cuda.is_available():
        print("compare_rollout_align_torch: no CUDA device", file=sys.stderr)
        return 2
    model = load_srnet(chip_smoke.CHECKPOINT, device=torch.device("cuda", 0),
                       compute_dtype=torch.bfloat16, graph_mode="static")
    frames = chip_smoke.rollout_frames(torch, model)

    def run(align):
        rollout_mod.ALIGN = align
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = rollout_mod.rollout_sequence(model, frames, use_vel=True)
        return outs, (time.perf_counter() - t0) * 1e3 / len(frames)

    a, b = ALIGNS
    outs = {al: run(al)[0] for al in (a, b)}        # warm-up
    walls = {a: [], b: []}
    for _ in range(REPS):
        for al in (a, b, b, a):
            walls[al].append(run(al)[1])
    for al in (a, b):
        diff = max(float(np.abs(x - y).max()) if x.shape == y.shape
                   else float("inf") for x, y in zip(outs[a], outs[al]))
        print(json.dumps({"align": al,
                          "rows": -(-frames[0][0].shape[0] // al) * al,
                          "max_abs_diff_vs_first": diff,
                          "wall_ms_per_frame": walls[al],
                          "median": statistics.median(walls[al])}),
              flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
