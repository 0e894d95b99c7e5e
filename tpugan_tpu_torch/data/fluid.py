"""The fluid three-frame dataset and batch iterator
(``tpugan_tpu/data/fluid.py``).

An item loads three consecutive frames, shifts all by the centre frame's
centroid, cuts the patch of the ``sample_num`` points nearest to a random
seed on the centre frame (the native library's search) and takes the same
particles from the side frames (particle identity is shared):
``highres_pos`` / ``highres_vel`` [3, sample_num, 3] and ``h``. With
``emit_lowres`` the item also carries the patch's FPS downsample
(``fps_ratio`` of it, the same indices in all three frames, FPS in the
native library), its positions jittered by ``jitter``: ``lowres_pos`` /
``lowres_vel`` [3, n, 3], as the eval path and the train CLI without
``--device_sampling`` read them. With ``--device_sampling`` the train step
samples its low-res inputs on the card and keeps ``emit_lowres=False``
(the default here; the JAX package's default is True). A batch stacks
items frame-major, [3, B, sample_num, 3].
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from tpugan_tpu_torch.data.sampling import (normalize_point_cloud,
                                            sample_patch_with_fps)


class SiamFluidDataset:
    """Items of three consecutive frames (``case{i}/{prefix}_{t}.npz``)."""

    def __init__(self, dataset_path: str, case_num: int, case_steps: int,
                 case_prefix: str = "data", case_to_start: int = 1,
                 sample_num: int = 9216, fps_ratio: float = 0.125,
                 jitter: float = 0.003, seed: int = 0,
                 emit_lowres: bool = False):
        self.dataset_path = dataset_path
        self.case_num, self.case_steps = case_num, case_steps
        self.case_prefix, self.case_to_start = case_prefix, case_to_start
        self.sample_num = sample_num
        self.fps_ratio, self.jitter = fps_ratio, jitter
        self.emit_lowres = emit_lowres
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
        _, patch_idx, fps_idx = sample_patch_with_fps(
            pos[1], sample_num=self.sample_num, fps_ratio=self.fps_ratio,
            rng=rng, fps=self.emit_lowres)
        item = {"highres_pos": np.stack([p[patch_idx] for p in pos]),
                "highres_vel": np.stack([v[patch_idx] for v in vel]),
                "h": np.float32(h)}
        if self.emit_lowres:
            lowres_pos = item["highres_pos"][:, fps_idx]          # [3, n, 3]
            lowres_pos = lowres_pos + rng.standard_normal(
                lowres_pos.shape).astype(np.float32) * self.jitter
            item["lowres_pos"] = lowres_pos.astype(np.float32)
            item["lowres_vel"] = item["highres_vel"][:, fps_idx]
        return item


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
