"""The fluid three-frame dataset and batch iterator
(``tpugan_tpu/data/fluid.py`` with ``emit_lowres=False``: the train step
samples the low-res inputs on the card).

An item loads three consecutive frames, shifts all by the centre frame's
centroid, cuts one kd-tree patch of ``sample_num`` points around a random
seed on the centre frame and takes the same particles from the side frames
(particle identity is shared): ``highres_pos`` / ``highres_vel``
[3, sample_num, 3] and ``h``. A batch stacks items frame-major,
[3, B, sample_num, 3].
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def normalize_point_cloud(pos: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """Centroid shift; the furthest-distance scale is pinned to 1, as in
    the reference."""
    centroid = np.mean(pos, axis=0, keepdims=True)
    furthest_distance = np.float32(1.0)
    return (pos - centroid) / furthest_distance, centroid, furthest_distance


def sample_patch(input_pos: np.ndarray, sample_num: Optional[int],
                 rng: np.random.Generator) -> np.ndarray:
    """Indices of the kd-tree patch of ``sample_num`` nearest points around
    a random seed point (``sample_patch_with_fps(fps=False)``)."""
    total = input_pos.shape[0]
    if sample_num is None:
        patch_num = 9216 if total > 10000 else (total // 1024) * 1024
    else:
        patch_num = sample_num if total > sample_num else 4096
    patch_num = min(patch_num, total)
    seed = int(rng.integers(total))
    _, patch_idx = cKDTree(input_pos).query(input_pos[seed], patch_num)
    return patch_idx


class SiamFluidDataset:
    """Items of three consecutive frames (``case{i}/{prefix}_{t}.npz``)."""

    def __init__(self, dataset_path: str, case_num: int, case_steps: int,
                 case_prefix: str = "data", case_to_start: int = 1,
                 sample_num: int = 9216, seed: int = 0):
        self.dataset_path = dataset_path
        self.case_num, self.case_steps = case_num, case_steps
        self.case_prefix, self.case_to_start = case_prefix, case_to_start
        self.sample_num = sample_num
        self.rng = np.random.default_rng(seed)
        self.cache: Dict[str, dict] = {}

    def __len__(self) -> int:
        return self.case_num * (self.case_steps - 2)

    def _load(self, key: str) -> dict:
        if key not in self.cache:
            with np.load(os.path.join(self.dataset_path, key)) as z:
                self.cache[key] = {"pos": z["pos"], "vel": z["vel"]}
        return self.cache[key]

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or self.rng
        # the reference's indexing, kept as it is
        case = idx // self.case_steps + self.case_to_start
        step = idx % (self.case_steps - 2)
        frames = [self._load(f"case{case}/{self.case_prefix}_{step + d}.npz")
                  for d in range(3)]
        pos_c, m, h = normalize_point_cloud(frames[1]["pos"].astype(np.float32))
        pos = [(frames[0]["pos"].astype(np.float32) - m) / h, pos_c,
               (frames[2]["pos"].astype(np.float32) - m) / h]
        vel = [f["vel"].astype(np.float32) / h for f in frames]
        patch_idx = sample_patch(pos[1], self.sample_num, rng)
        return {"highres_pos": np.stack([p[patch_idx] for p in pos]),
                "highres_vel": np.stack([v[patch_idx] for v in vel]),
                "h": np.float32(h)}


def fluid_batch_iterator(dataset: SiamFluidDataset, batch_size: int,
                         seed: int = 0, shuffle: bool = True
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled batches, frame-major [3, B, N, 3] (and h [B]);
    partial batches are dropped. Each item draws from its own child seed,
    as the JAX package's iterator does."""
    rng = np.random.default_rng(seed)
    seed_seq = np.random.SeedSequence(seed + 1)
    n = len(dataset)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            child_seeds = seed_seq.spawn(batch_size)
            items = [dataset.__getitem__(int(i), rng=np.random.default_rng(s))
                     for i, s in zip(order[start:start + batch_size],
                                     child_seeds)]
            yield {k: np.stack([x[k] for x in items], axis=0 if k == "h" else 1)
                   for k in items[0]}
