"""Convert solver partio output to training npz frames.

Equivalent of reference fluid_data_generation/process_training_data.py:6-95
and physics_data_helper.py:8-91: each case's ``ParticleData_Fluid_{t}.bgeo``
frames become ``case{i}/data_{t}.npz`` with pos [N,3] f32 and vel [N,3] f32.
Uses the in-tree pure-Python bgeo reader instead of partio.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from tpugan_tpu_torch.data.bgeo import numpy_from_bgeo


def _frame_files(sim_dir: str) -> List[str]:
    pat = re.compile(r"(\d+)\.bgeo$")
    files = [f for f in os.listdir(sim_dir) if f.endswith(".bgeo")]
    return sorted(files, key=lambda f: int(pat.search(f).group(1)))


def process_case(
    sim_dir: str,
    out_case_dir: str,
    case_prefix: str = "data",
    max_frames: Optional[int] = None,
) -> int:
    """Convert one simulated case; returns the number of frames written."""
    os.makedirs(out_case_dir, exist_ok=True)
    files = _frame_files(sim_dir)
    if max_frames:
        files = files[:max_frames]
    for t, fname in enumerate(files):
        pos, vel = numpy_from_bgeo(os.path.join(sim_dir, fname))
        if vel is None:
            vel = np.zeros_like(pos)
        np.savez(
            os.path.join(out_case_dir, f"{case_prefix}_{t}.npz"),
            pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        )
    return len(files)


def process_dataset(
    sim_root: str,
    out_root: str,
    case_to_start: int = 1,
    case_prefix: str = "data",
) -> int:
    """Convert every ``case*/sim_output``-style directory under sim_root."""
    os.makedirs(out_root, exist_ok=True)
    cases = sorted(d for d in os.listdir(sim_root)
                   if os.path.isdir(os.path.join(sim_root, d)))
    n = 0
    for i, case in enumerate(cases):
        sim_dir = os.path.join(sim_root, case)
        inner = os.path.join(sim_dir, "sim_output")
        if os.path.isdir(inner):
            sim_dir = inner
        n += process_case(
            sim_dir,
            os.path.join(out_root, f"case{i + case_to_start}"),
            case_prefix=case_prefix,
        )
    return n
