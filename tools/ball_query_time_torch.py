#!/usr/bin/env python3
"""Device time of one checkout's ball query kernel (``csrc/ball_query.cu``)
at every ``chip_smoke.BALL_SHAPES`` stage, on one CUDA card.

    python3 tools/ball_query_time_torch.py [CHECKOUT]

CHECKOUT is a directory holding ``chip_smoke.py`` and ``tpugan_tpu_torch/``
(default: this repository); its kernel is built there. The inputs are
seeded as in ``tools/compare_knn_torch.py --check ball_query`` (a cloud of
0.3-scaled normals, queries drawn from it, every ninth candidate masked),
the same in every checkout. Each stage's result must equal
``ball_query_plain`` index for index; its time is the median of 7
torch.profiler readings of 10 launches. Prints one JSON line: each stage's
device ms and their sum per G+D step. Run checkouts in turns, each in its
own process, to compare two versions of the kernel on one card.
"""

import json
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ball_query_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from tpugan_tpu_torch.ops.kernels import ball_query as BQ

    torch.manual_seed(0)
    dev, rng = torch.device("cuda", 0), np.random.default_rng(0)
    rows, step = {}, 0.0
    for stage, b, nq, nc, r, ns, per in chip_smoke.BALL_SHAPES:
        cand = chip_smoke._cloud(torch, dev, rng, b, nc, 3)
        query = cand[:, torch.randperm(nc, device=dev)[:nq]]
        bias = torch.zeros((b, nc), device=dev)
        bias[:, ::9] = 2.0
        run = lambda: BQ.ball_query_kernel(query, cand, r, ns, bias)
        if not torch.equal(run(), BQ.ball_query_plain(query, cand, r, ns, bias)):
            raise AssertionError(f"ball_query {stage}: off the plain version")
        rows[stage] = sorted(chip_smoke.device_ms(run, torch) for _ in range(7))[3]
        step += per * rows[stage]
    print(json.dumps({"checkout": root, "per_step": step, **rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
